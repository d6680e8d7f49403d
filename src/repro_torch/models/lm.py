"""Decoder-only LM of the dense, moe, vlm, ssm and hybrid families.

Layer kinds: ``attn_mlp`` (dense and vlm: pre-norm attention, then
pre-norm MLP), ``attn_moe`` (moe: the MLP replaced by ``moe.moe_apply``),
``ssm`` (mamba2: one pre-norm SSM block) and ``hybrid`` (hymba: attention
and the SSM block side by side on one normed input, averaged, then the
MLP). The moe family starts with ``first_k_dense`` ``attn_mlp`` layers
(``model.prefix_layers``); the vlm family projects stub patch embeddings
into the first positions of the sequence (``patch_proj``). The JAX package
stacks the layers' parameters ([L, ...] leaves) and runs them under
``lax.scan``; here the layers are an ``nn.ModuleList`` walked by a loop,
and ``convert.lm_params_from_numpy`` maps the stacked leaves onto it. The
decode cache is a list with one dict per layer, the prefix layers first,
nested as the reference's: ``{"attn": {k, v, len}}`` (or ``{k_q, k_s,
v_q, v_s, len}`` with ``kv_quant``), ``{"ssm": {conv_x, conv_bc, h}}`` or
both.

RNG: the ppot router's key of main layer i is ``split(rng, n)[i]`` with
``scan_layers`` and ``fold_in(rng, i)`` without, as the reference derives
it; with ``rng=None`` every layer gets the zero key, ``PRNGKey(0)``.

Remat: where a gradient is taken, each main layer runs under
``layers.remat`` (``cfg.remat``) when ``scan_layers`` is set, as the
reference checkpoints its scan body; the prefix layers and an unscanned
stack keep their activations, as there.

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
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.utils import prng

#: family -> (prefix layer kind, main layer kind)
_KINDS = {"dense": ("attn_mlp", "attn_mlp"), "moe": ("attn_mlp", "attn_moe"),
          "vlm": ("attn_mlp", "attn_mlp"), "ssm": ("ssm", "ssm"),
          "hybrid": ("hybrid", "hybrid")}
FAMILIES = tuple(_KINDS)
#: the cache parts of a layer of each kind
LAYER_PARTS = {"attn_mlp": ("attn",), "attn_moe": ("attn",), "ssm": ("ssm",),
               "hybrid": ("attn", "ssm")}


def layer_kinds(cfg: ModelConfig) -> tuple[str, str, int]:
    """(prefix kind, main kind, number of prefix layers)."""
    prefix, main = _KINDS[cfg.family]
    return prefix, main, cfg.first_k_dense if cfg.family == "moe" else 0


def _init_layer(cfg: ModelConfig, gen: torch.Generator, kind: str) -> nn.Module:
    p = nn.Module()
    p.norm1 = L.init_norm(cfg, device=gen.device)
    if kind in ("attn_mlp", "attn_moe", "hybrid"):
        p.attn = L.init_attention(cfg, gen)
    if kind in ("ssm", "hybrid"):
        p.ssm = SSM.init_ssm(cfg, gen)
    if kind in ("attn_mlp", "hybrid"):
        p.norm2 = L.init_norm(cfg, device=gen.device)
        p.mlp = L.init_mlp(cfg, gen)
    if kind == "attn_moe":
        p.norm2 = L.init_norm(cfg, device=gen.device)
        p.moe = MOE.init_moe(cfg, gen)
    return p


def init_params(cfg: ModelConfig, seed: int, device) -> nn.Module:
    gen = torch.Generator(device=device).manual_seed(seed)
    pdt = L._pdtype(cfg)
    model = nn.Module()
    model.embed = L.dense_init(gen, (cfg.vocab, cfg.d_model), pdt, scale=0.02)
    model.final_norm = L.init_norm(cfg, device=gen.device)
    if not cfg.tie_embeddings:
        model.lm_head = L.dense_init(gen, (cfg.d_model, cfg.vocab), pdt)
    if cfg.family == "vlm":
        model.patch_proj = L.dense_init(gen, (cfg.d_model, cfg.d_model), pdt)
    prefix, main, n_prefix = layer_kinds(cfg)
    if n_prefix:
        model.prefix_layers = nn.ModuleList(_init_layer(cfg, gen, prefix)
                                            for _ in range(n_prefix))
    model.layers = nn.ModuleList(_init_layer(cfg, gen, main)
                                 for _ in range(cfg.n_layers - n_prefix))
    return model


def _layer_apply(cfg: ModelConfig, p: nn.Module, x, *, kind, positions, cache, rng=None,
                 per_row: bool = False):
    """One layer; cache None (prefill) or the layer's nested cache. Returns
    (x, aux, new_cache)."""
    sub = (lambda name: None) if cache is None else cache.get
    new_cache = {}
    aux = None
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
        h = L.norm_apply(cfg, p.norm2, x)
        if kind == "attn_moe":
            m, aux = MOE.moe_apply(cfg, p.moe, h, rng=rng, per_row=per_row)
            x = x + m
        else:
            x = x + L.mlp_apply(cfg, p.mlp, h)
    return x, aux, (None if cache is None else new_cache)


def _layer_train(cfg, layer, x, kind, positions, rng, per_row):
    """``_layer_apply`` with no cache and positional arguments (the remat
    wrapper's form)."""
    x, aux, _ = _layer_apply(cfg, layer, x, kind=kind, positions=positions, cache=None,
                             rng=rng, per_row=per_row)
    return x, aux, None


def embed_tokens(cfg: ModelConfig, model: nn.Module, tokens, patch_embeds=None):
    """Token embeddings; for the vlm family the first n_patches positions
    carry the projected stub patch embeddings [B, n_patches, d]."""
    dt = L._dtype(cfg)
    x = model.embed[tokens.long()].to(dt)
    if cfg.family == "vlm" and patch_embeds is not None:
        pe = patch_embeds.to(dt) @ model.patch_proj.to(dt)
        x = torch.cat([pe, x[:, pe.shape[1]:, :]], dim=1)
    return x


def layer_keys(cfg: ModelConfig, rng, n_main: int) -> list:
    """The ppot router's host key of each main layer (module docstring)."""
    if rng is None:
        return [(0, 0)] * n_main
    if cfg.scan_layers:
        return prng.split(rng, n_main)
    return [prng.fold_in(rng, i) for i in range(n_main)]


def backbone(cfg: ModelConfig, model: nn.Module, x, *, positions, rng=None, cache=None,
             per_row: bool = False):
    """Run all layers. cache: None (prefill) or a list of per-layer caches,
    the prefix layers first. positions: a tensor, or for a prefill the host
    integer p0 of contiguous positions (``layers.attention_apply``).
    per_row: route each batch row alone in the MoE layers. Returns (hidden,
    aux summed over the layers (f32), new_cache)."""
    prefix, main, n_prefix = layer_kinds(cfg)
    layers = [(prefix, lay, rng) for lay in (model.prefix_layers if n_prefix else ())]
    keys = layer_keys(cfg, rng, len(model.layers))
    layers += [(main, lay, key) for lay, key in zip(model.layers, keys)]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = None if cache is None else []
    for i, (kind, layer, key) in enumerate(layers):
        if cache is None and cfg.scan_layers and i >= n_prefix:
            x, aux, c = L.remat(cfg, _layer_train, cfg, layer, x, kind, positions, key, per_row)
        else:
            x, aux, c = _layer_apply(cfg, layer, x, kind=kind, positions=positions,
                                     cache=None if cache is None else cache[i], rng=key,
                                     per_row=per_row)
        if aux is not None:
            aux_total = aux_total + aux
        if cache is not None:
            new_cache.append(c)
    return L.norm_apply(cfg, model.final_norm, x), aux_total, new_cache


def logits_head(cfg: ModelConfig, model: nn.Module, hidden):
    dt = L._dtype(cfg)
    if cfg.tie_embeddings:
        return hidden @ model.embed.to(dt).T
    return hidden @ model.lm_head.to(dt)


def forward(cfg: ModelConfig, model: nn.Module, tokens, *, patch_embeds=None, rng=None,
            with_aux: bool = False):
    """Training / prefill forward over [B, S] tokens -> hidden [B, S, d], or
    (hidden, aux) with ``with_aux`` (the MoE layers' load-balance loss
    summed over the layers, f32)."""
    x = embed_tokens(cfg, model, tokens, patch_embeds)
    hidden, aux, _ = backbone(cfg, model, x, positions=0, rng=rng)  # p0: positions 0..S-1
    return (hidden, aux) if with_aux else hidden


def _attn_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    length = torch.zeros(batch, dtype=torch.long, device=device)
    if cfg.kv_quant:
        z = lambda: torch.zeros(shape, dtype=torch.int8, device=device)  # noqa: E731
        o = lambda: torch.ones(shape[:3], dtype=torch.bfloat16, device=device)  # noqa: E731
        return {"k_q": z(), "k_s": o(), "v_q": z(), "v_s": o(), "len": length}
    return {"k": torch.zeros(shape, dtype=L._dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=L._dtype(cfg), device=device), "len": length}


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, device):
    make = {"attn": lambda: _attn_cache(cfg, batch, max_len, device),
            "ssm": lambda: SSM.init_ssm_cache(cfg, batch, device)}
    return {part: make[part]() for part in LAYER_PARTS[kind]}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    prefix, main, n_prefix = layer_kinds(cfg)
    return [_layer_cache(cfg, prefix if i < n_prefix else main, batch, max_len, device)
            for i in range(cfg.n_layers)]


def decode_step(cfg: ModelConfig, model: nn.Module, tokens, pos, cache, *, rng=None,
                per_row: bool = False):
    """One decode step. tokens [B, 1]; pos the current position, a scalar
    shared by the batch or i64[B], one per row. Each row's attention writes
    at its cache ``len``; the SSM state advances one step. per_row: route
    each row alone in the MoE layers. Returns (logits [B, 1, V],
    new_cache); the input cache is left as it was."""
    x = embed_tokens(cfg, model, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    hidden, _, new_cache = backbone(cfg, model, x, positions=positions, rng=rng, cache=cache,
                                    per_row=per_row)
    return logits_head(cfg, model, hidden), new_cache
