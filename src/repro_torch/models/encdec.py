"""Whisper-style encoder-decoder backbone. The audio frontend is a stub:
the caller supplies frame embeddings [B, enc_len, d] (the conv and mel
stack is out of scope, as in the JAX package).

Encoder: non-causal self-attention and a GELU MLP, sinusoidal positions,
pre-norm LayerNorm. Decoder: causal self-attention, cross attention to the
encoder output, a GELU MLP and learned positions. Logits tie to the token
embedding. The decode cache is a list with one ``{k, v, len}`` a decoder
layer (the self-attention's); cross attention projects ``enc_out`` anew
at every step, as the reference does. Where a gradient is taken, every
encoder and decoder layer runs under ``layers.remat`` (``cfg.remat``), as
the reference checkpoints both scans.

  init_params(cfg, seed, device)                  -> model (nn.Module)
  encode(cfg, model, frame_embeds)                -> enc_out [B, enc_len, d]
  decode(cfg, model, tokens, enc_out, cache, pos0) -> (hidden, new_cache)
  logits_head(cfg, model, hidden)                 -> [B, S, V]
  init_cache(cfg, batch, max_len, device)         -> cache
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

#: learned decoder positions, sized as the reference's for the largest
#: assigned decode context
DEC_POSITIONS = 32768


def _init_enc_layer(cfg: ModelConfig, gen: torch.Generator) -> nn.Module:
    p = nn.Module()
    p.norm1 = L.init_norm(cfg, device=gen.device)
    p.attn = L.init_attention(cfg, gen)
    p.norm2 = L.init_norm(cfg, device=gen.device)
    p.mlp = L.init_mlp(cfg, gen)
    return p


def _init_dec_layer(cfg: ModelConfig, gen: torch.Generator) -> nn.Module:
    p = nn.Module()
    p.norm1 = L.init_norm(cfg, device=gen.device)
    p.self_attn = L.init_attention(cfg, gen)
    p.norm2 = L.init_norm(cfg, device=gen.device)
    p.cross_attn = L.init_attention(cfg, gen, cross=True)
    p.norm3 = L.init_norm(cfg, device=gen.device)
    p.mlp = L.init_mlp(cfg, gen)
    return p


def init_params(cfg: ModelConfig, seed: int, device) -> nn.Module:
    gen = torch.Generator(device=device).manual_seed(seed)
    pdt = L._pdtype(cfg)
    model = nn.Module()
    model.embed = L.dense_init(gen, (cfg.vocab, cfg.d_model), pdt, scale=0.02)
    model.dec_pos = L.dense_init(gen, (DEC_POSITIONS, cfg.d_model), pdt, scale=0.02)
    model.enc_norm = L.init_norm(cfg, device=gen.device)
    model.dec_norm = L.init_norm(cfg, device=gen.device)
    model.enc_layers = nn.ModuleList(_init_enc_layer(cfg, gen) for _ in range(cfg.n_enc_layers))
    model.dec_layers = nn.ModuleList(_init_dec_layer(cfg, gen) for _ in range(cfg.n_layers))
    return model


def encode(cfg: ModelConfig, model: nn.Module, frame_embeds):
    """frame_embeds [B, enc_len, d] (the stub frontend's output)."""
    S, d = frame_embeds.shape[1:]
    x = frame_embeds.to(L._dtype(cfg))
    x = x + L.sincos_positions(d, S, x.device)[None].to(x.dtype)
    for p in model.enc_layers:
        x = L.remat(cfg, _enc_layer, cfg, p, x)
    return L.norm_apply(cfg, model.enc_norm, x)


def _enc_layer(cfg: ModelConfig, p: nn.Module, x):
    a, _ = L.attention_apply(cfg, p.attn, L.norm_apply(cfg, p.norm1, x), positions=0,
                             causal=False)
    x = x + a
    return x + L.mlp_apply(cfg, p.mlp, L.norm_apply(cfg, p.norm2, x))


def _dec_layer(cfg: ModelConfig, p: nn.Module, x, enc_out, positions, cache):
    a, c = L.attention_apply(cfg, p.self_attn, L.norm_apply(cfg, p.norm1, x),
                             positions=positions, causal=True, cache=cache)
    x = x + a
    # non-causal with no window: the cross block's mask reads no position
    ca, _ = L.attention_apply(cfg, p.cross_attn, L.norm_apply(cfg, p.norm2, x),
                              positions=0, causal=False, kv_x=enc_out, kv_positions=0)
    x = x + ca
    return x + L.mlp_apply(cfg, p.mlp, L.norm_apply(cfg, p.norm3, x)), c


def decode(cfg: ModelConfig, model: nn.Module, tokens, enc_out, *, cache=None, pos0=None):
    """tokens [B, S]; enc_out [B, enc_len, d]. pos0: the first position,
    None for 0 (a prefill), or a scalar or i64[B] with a cache. Returns
    (hidden, new_cache)."""
    S = tokens.shape[1]
    dt = L._dtype(cfg)
    x = model.embed[tokens.long()].to(dt)
    if pos0 is None:
        positions = 0  # the host p0 of a prefill
        pos_idx = torch.arange(S, device=x.device)[None]
    else:
        pos0 = torch.as_tensor(pos0, device=x.device)
        positions = (pos0[:, None] if pos0.dim() else pos0) + torch.arange(S, device=x.device)
        pos_idx = positions if positions.dim() == 2 else positions[None]
    x = x + model.dec_pos[pos_idx].to(dt)
    new_cache = None if cache is None else []
    for i, p in enumerate(model.dec_layers):
        if cache is None:
            x, _ = L.remat(cfg, _dec_layer, cfg, p, x, enc_out, positions, None)
        else:
            x, c = _dec_layer(cfg, p, x, enc_out, positions, cache[i])
            new_cache.append(c)
    return L.norm_apply(cfg, model.dec_norm, x), new_cache


def logits_head(cfg: ModelConfig, model: nn.Module, hidden):
    return hidden @ model.embed.to(L._dtype(cfg)).T


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return [{"k": torch.zeros(shape, dtype=L._dtype(cfg), device=device),
             "v": torch.zeros(shape, dtype=L._dtype(cfg), device=device),
             "len": torch.zeros(batch, dtype=torch.long, device=device)}
            for _ in range(cfg.n_layers)]
