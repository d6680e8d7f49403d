"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block.

A port of the JAX package's ``models/ssm.py``: the chunked SSD scan for
prefill (intra-chunk quadratic form, then the inter-chunk state carry,
which ``lax.scan`` did and a loop over chunks does here) and an O(1)-state
recurrence for decode.

Projections are separate (z, x, B, C, dt), as in the reference:

  z,x : d -> d_inner          dt : d -> H          B,C : d -> N
  conv: depthwise width-4 causal over x channels (and over [B, C])
  SSD : h_t = a_t h_{t-1} + dt_t B_t (x) x_t ;  y_t = C_t h_t + D x_t
  out : RMSNorm(y * silu(z)) @ out_proj

The prefill scan goes through ``ssd_prefill``, which calls
``kernels/ssd_scan/ops.ssd`` (K5): its wrapper launches the kernel on CUDA
tensors and runs the plain chunked math (``ssd_chunked``'s) on CPU ones.
The reference's model path always calls its own ``ssd_chunked``; its
``kernels/ssd_scan/ops.ssd`` promises the same contract (``ops.py:9-11``)
and its tests hold the two together, so the port drives the kernel from
the model.

A cache (decode) takes one token at a time; several tokens into a cache
(prefill into a cache) raise. Nothing is written in place: a decode
returns a new cache and leaves its input as it was.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DTYPES, _dtype, _param, _pdtype, dense_init


def init_ssm(cfg: ModelConfig, gen: torch.Generator) -> nn.Module:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    pdt, dev = _pdtype(cfg), gen.device
    p = nn.Module()
    p.z_proj = dense_init(gen, (d, di), pdt)
    p.x_proj = dense_init(gen, (d, di), pdt)
    p.b_proj = dense_init(gen, (d, N), pdt)
    p.c_proj = dense_init(gen, (d, N), pdt)
    p.dt_proj = dense_init(gen, (d, H), pdt)
    p.conv_wx = dense_init(gen, (cfg.d_conv, di), pdt, scale=0.5)
    p.conv_bx = _param(torch.zeros(di, dtype=pdt, device=dev))
    p.conv_wbc = dense_init(gen, (cfg.d_conv, 2 * N), pdt, scale=0.5)
    p.conv_bbc = _param(torch.zeros(2 * N, dtype=pdt, device=dev))
    p.A_log = _param(torch.zeros(H, dtype=torch.float32, device=dev))  # A = -exp(A_log)
    p.D = _param(torch.ones(H, dtype=torch.float32, device=dev))
    p.dt_bias = _param(torch.zeros(H, dtype=torch.float32, device=dev))
    p.norm_scale = _param(torch.ones(di, dtype=pdt, device=dev))
    p.out_proj = dense_init(gen, (di, d), pdt)
    return p


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x [B, S, C]; w [K, C]; state: the last K-1
    inputs ([B, K-1, C]) for decode. Returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[0], K - 1, x.shape[2], dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, C]
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return y + b, xp[:, -(K - 1):, :]


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan (the plain path).

    x [B, S, H, P]; dt [B, S, H] positive steps; A [H] negative decay rates;
    Bm, Cm [B, S, N] shared across heads. The chunk length is ``chunk``, or
    gcd(S, chunk) where that does not divide S. Returns (y [B, S, H, P],
    final state [B, H, N, P]), f32. The math is the kernel's plain version
    in the model layout (``kernels/ssd_scan/ref.ssd_chunked_heads``)."""
    return ssd_ref.ssd_chunked_heads(x, dt, A, Bm, Cm,
                                     chunk=ssd_ops.pick_chunk(x.shape[1], chunk))


def ssd_prefill(cfg: ModelConfig, x, dt, A, Bm, Cm):
    """The prefill scan, (y [B, S, H, P], h [B, H, N, P]) in f32: ``ops.ssd``,
    whose wrapper launches the kernel on CUDA tensors and runs its plain
    version on CPU ones; ``ssd_chunked`` inside ``api.plain_paths()``.

    Gradients: the plain chunked scan is differentiable (the reference
    trains through ``ssd_chunked``'s autodiff); the kernel (K5) has no
    backward, so a gradient wanted through it on the card raises (ROADMAP
    A9b)."""
    if L.PLAIN_PATHS:
        return ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk)
    if x.is_cuda and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        raise NotImplementedError(
            "no gradient through the SSD scan kernel (K5) on the card: SSM and hybrid "
            "training on the card wait for its backward (ROADMAP A9b); inside "
            "api.plain_paths() the plain ssd_chunked is differentiable")
    return ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)


def ssd_decode_step(x, dt, A, Bm, Cm, h):
    """One-token recurrence. x [B, 1, H, P], dt [B, 1, H], Bm/Cm [B, 1, N],
    h [B, H, N, P] -> (y [B, 1, H, P], h')."""
    a = torch.exp(dt[:, 0, :] * A)  # [B, H]
    upd = torch.einsum("bn,bh,bhp->bhnp", Bm[:, 0], dt[:, 0], x[:, 0].float())
    h_new = h * a[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0], h_new)
    return y[:, None], h_new


def ssm_apply(cfg: ModelConfig, p: nn.Module, x, *, cache=None):
    """x [B, S, d] -> (out [B, S, d], new_cache). cache: dict(conv_x,
    conv_bc, h) and S == 1 (decode), or None (prefill)."""
    B, S, _ = x.shape
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim
    dt_ = _dtype(cfg)
    if cache is not None and S != 1:
        raise NotImplementedError("prefill into an SSM cache is not ported (ROADMAP A, "
                                  "prefill into a cache): the engine replays prompts one "
                                  "token at a time")

    z = x @ p.z_proj.to(dt_)
    xs = x @ p.x_proj.to(dt_)
    bcs = torch.cat([x @ p.b_proj.to(dt_), x @ p.c_proj.to(dt_)], dim=-1)
    dtr = x @ p.dt_proj.to(dt_)

    cx = None if cache is None else cache["conv_x"]
    cbc = None if cache is None else cache["conv_bc"]
    xs, new_cx = _causal_conv(xs, p.conv_wx.to(dt_), p.conv_bx.to(dt_), cx)
    bcs, new_cbc = _causal_conv(bcs, p.conv_wbc.to(dt_), p.conv_bbc.to(dt_), cbc)
    xs = F.silu(xs)
    bcs = F.silu(bcs)
    Bm, Cm = bcs[..., :N].float(), bcs[..., N:].float()

    xh = xs.reshape(B, S, H, Pd)
    dtv = F.softplus(dtr.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    if cache is not None:
        y, h_new = ssd_decode_step(xh, dtv, A, Bm, Cm, cache["h"])
    else:
        y, h_new = ssd_prefill(cfg, xh, dtv, A, Bm, Cm)
    y = y + p.D[None, None, :, None] * xh.float()
    y = y.reshape(B, S, di)

    # gated RMSNorm (mamba2's norm before out_proj)
    g = y * F.silu(z.float())
    ms = g.square().mean(-1, keepdim=True)
    g = g * torch.rsqrt(ms + cfg.norm_eps) * p.norm_scale.float()
    out = g.to(dt_) @ p.out_proj.to(dt_)

    new_cache = (None if cache is None else
                 {"conv_x": new_cx, "conv_bc": new_cbc, "h": h_new})
    return out, new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, device):
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim
    dt = DTYPES[cfg.dtype]
    return {
        "conv_x": torch.zeros(batch, cfg.d_conv - 1, di, dtype=dt, device=device),
        "conv_bc": torch.zeros(batch, cfg.d_conv - 1, 2 * N, dtype=dt, device=device),
        "h": torch.zeros(batch, H, N, Pd, dtype=torch.float32, device=device),
    }
