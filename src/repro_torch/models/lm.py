"""Decoder-only LM of the dense, ssm and hybrid families.

Layer kinds: ``attn_mlp`` (dense: pre-norm attention, then pre-norm MLP),
``ssm`` (mamba2: one pre-norm SSM block) and ``hybrid`` (hymba: attention
and the SSM block side by side on one normed input, averaged, then the
MLP). The JAX package stacks the layers' parameters ([L, ...] leaves) and
runs them under ``lax.scan``; here the layers are an ``nn.ModuleList``
walked by a loop, and ``convert.lm_params_from_numpy`` maps the stacked
leaves onto it. The decode cache is a list with one dict per layer, nested
as the reference's: ``{"attn": {k, v, len}}``, ``{"ssm": {conv_x, conv_bc,
h}}`` or both.

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
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

_KINDS = {"dense": "attn_mlp", "ssm": "ssm", "hybrid": "hybrid"}
FAMILIES = tuple(_KINDS)
#: the cache parts of a layer of each kind
LAYER_PARTS = {"attn_mlp": ("attn",), "ssm": ("ssm",), "hybrid": ("attn", "ssm")}


def _layer_kind(cfg: ModelConfig) -> str:
    return _KINDS[cfg.family]


def _init_layer(cfg: ModelConfig, gen: torch.Generator, kind: str) -> nn.Module:
    p = nn.Module()
    p.norm1 = L.init_norm(cfg, device=gen.device)
    if kind in ("attn_mlp", "hybrid"):
        p.attn = L.init_attention(cfg, gen)
    if kind in ("ssm", "hybrid"):
        p.ssm = SSM.init_ssm(cfg, gen)
    if kind in ("attn_mlp", "hybrid"):
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
    kind = _layer_kind(cfg)
    model.layers = nn.ModuleList(_init_layer(cfg, gen, kind) for _ in range(cfg.n_layers))
    return model


def _layer_apply(cfg: ModelConfig, p: nn.Module, x, *, kind, positions, cache):
    """One layer; cache None (prefill) or the layer's nested cache."""
    sub = (lambda name: None) if cache is None else cache.get
    new_cache = {}
    xin = L.norm_apply(cfg, p.norm1, x)
    if kind == "ssm":
        h, new_cache["ssm"] = SSM.ssm_apply(cfg, p.ssm, xin, cache=sub("ssm"))
        x = x + h
    else:
        a, new_cache["attn"] = L.attention_apply(cfg, p.attn, xin, positions=positions,
                                                 cache=sub("attn"))
        if kind == "hybrid":  # hymba: parallel attention and SSM heads, averaged
            s, new_cache["ssm"] = SSM.ssm_apply(cfg, p.ssm, xin, cache=sub("ssm"))
            a = 0.5 * (a + s)
        x = x + a
        x = x + L.mlp_apply(cfg, p.mlp, L.norm_apply(cfg, p.norm2, x))
    return x, (None if cache is None else new_cache)


def embed_tokens(cfg: ModelConfig, model: nn.Module, tokens):
    return model.embed[tokens.long()].to(L._dtype(cfg))


def backbone(cfg: ModelConfig, model: nn.Module, x, *, positions, cache=None):
    """Run all layers. cache: None (prefill) or a list of per-layer caches.
    positions: a tensor, or for a prefill the host integer p0 of contiguous
    positions (``layers.attention_apply``). Returns (hidden, new_cache)."""
    kind = _layer_kind(cfg)
    new_cache = None if cache is None else []
    for i, layer in enumerate(model.layers):
        x, c = _layer_apply(cfg, layer, x, kind=kind, positions=positions,
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
    return backbone(cfg, model, x, positions=0)[0]  # p0: positions 0..S-1


def _attn_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    if cfg.kv_quant:
        raise NotImplementedError("the int8 kv_quant cache is not ported yet "
                                  "(ROADMAP queue A, A10)")
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=L._dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=L._dtype(cfg), device=device),
            "len": torch.zeros(batch, dtype=torch.long, device=device)}


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, device):
    make = {"attn": lambda: _attn_cache(cfg, batch, max_len, device),
            "ssm": lambda: SSM.init_ssm_cache(cfg, batch, device)}
    return {part: make[part]() for part in LAYER_PARTS[kind]}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    kind = _layer_kind(cfg)
    return [_layer_cache(cfg, kind, batch, max_len, device) for _ in range(cfg.n_layers)]


def decode_step(cfg: ModelConfig, model: nn.Module, tokens, pos, cache):
    """One decode step. tokens [B, 1]; pos the current position, a scalar
    shared by the batch or i64[B], one per row. Each row's attention writes
    at its cache ``len``; the SSM state advances one step. Returns (logits
    [B, 1, V], new_cache); the input cache is left as it was."""
    x = embed_tokens(cfg, model, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    hidden, new_cache = backbone(cfg, model, x, positions=positions, cache=cache)
    return logits_head(cfg, model, hidden), new_cache
