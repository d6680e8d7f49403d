"""Decoder-only LM of the dense family (``attn_mlp`` layers).

The JAX package stacks the layers' parameters ([L, ...] leaves) and runs
them under ``lax.scan``; here the layers are an ``nn.ModuleList`` walked by
a loop, and ``convert.lm_params_from_numpy`` maps the stacked leaves onto
it. The decode cache is a list with one dict per layer.

  init_params(cfg, seed, device)              -> model (nn.Module)
  forward(cfg, model, tokens)                 -> hidden
  logits_head(cfg, model, hidden)             -> [B, S, V]
  init_cache(cfg, batch, max_len, device)     -> cache
  decode_step(cfg, model, tokens, pos, cache) -> (logits [B, 1, V], cache)
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def _init_layer(cfg: ModelConfig, gen: torch.Generator) -> nn.Module:
    """One ``attn_mlp`` layer: pre-norm attention, then pre-norm MLP."""
    p = nn.Module()
    p.norm1 = L.init_norm(cfg, device=gen.device)
    p.attn = L.init_attention(cfg, gen)
    p.norm2 = L.init_norm(cfg, device=gen.device)
    p.mlp = L.init_mlp(cfg, gen)
    return p


def init_params(cfg: ModelConfig, seed: int, device) -> nn.Module:
    gen = torch.Generator(device=device).manual_seed(seed)
    pdt = L._pdtype(cfg)
    model = nn.Module()
    model.embed = L.dense_init(gen, (cfg.vocab, cfg.d_model), pdt, scale=0.02)
    model.final_norm = L.init_norm(cfg, device=gen.device)
    if not cfg.tie_embeddings:
        model.lm_head = L.dense_init(gen, (cfg.d_model, cfg.vocab), pdt)
    model.layers = nn.ModuleList(_init_layer(cfg, gen) for _ in range(cfg.n_layers))
    return model


def _layer_apply(cfg: ModelConfig, p: nn.Module, x, *, positions, cache):
    a, new_cache = L.attention_apply(cfg, p.attn, L.norm_apply(cfg, p.norm1, x),
                                     positions=positions, cache=cache)
    x = x + a
    x = x + L.mlp_apply(cfg, p.mlp, L.norm_apply(cfg, p.norm2, x))
    return x, new_cache


def embed_tokens(cfg: ModelConfig, model: nn.Module, tokens):
    return model.embed[tokens.long()].to(L._dtype(cfg))


def backbone(cfg: ModelConfig, model: nn.Module, x, *, positions, cache=None):
    """Run all layers. cache: None (prefill) or a list of per-layer caches.
    Returns (hidden, new_cache)."""
    new_cache = None if cache is None else []
    for i, layer in enumerate(model.layers):
        x, c = _layer_apply(cfg, layer, x, positions=positions,
                            cache=None if cache is None else cache[i])
        if cache is not None:
            new_cache.append(c)
    return L.norm_apply(cfg, model.final_norm, x), new_cache


def logits_head(cfg: ModelConfig, model: nn.Module, hidden):
    dt = L._dtype(cfg)
    if cfg.tie_embeddings:
        return hidden @ model.embed.to(dt).T
    return hidden @ model.lm_head.to(dt)


def forward(cfg: ModelConfig, model: nn.Module, tokens):
    """Prefill forward over [B, S] tokens -> hidden [B, S, d]."""
    x = embed_tokens(cfg, model, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    return backbone(cfg, model, x, positions=positions)[0]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    if cfg.kv_quant:
        raise NotImplementedError("the int8 kv_quant cache is not ported yet")
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return [{"k": torch.zeros(shape, dtype=L._dtype(cfg), device=device),
             "v": torch.zeros(shape, dtype=L._dtype(cfg), device=device),
             "len": torch.zeros(batch, dtype=torch.long, device=device)}
            for _ in range(cfg.n_layers)]


def decode_step(cfg: ModelConfig, model: nn.Module, tokens, pos, cache):
    """One decode step. tokens [B, 1]; pos the current position, a scalar
    shared by the batch or i64[B], one per row. Each row writes at its
    cache ``len``. Returns (logits [B, 1, V], new_cache)."""
    x = embed_tokens(cfg, model, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    hidden, new_cache = backbone(cfg, model, x, positions=positions, cache=cache)
    return logits_head(cfg, model, hidden), new_cache
