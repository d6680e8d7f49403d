"""Model building blocks: norms, rope, sinusoidal positions, attention
(self, cross, with a bf16 or int8 decode cache) and the MLP.

Each block has an ``init_*`` that returns an ``nn.Module`` holding its
parameters (random, from an explicit ``torch.Generator``) and an
``*_apply`` that is a plain function on tensors. Weights keep the JAX
package's layout (``x @ w`` with ``w`` [d_in, d_out]), so a JAX parameter
tree carries across leaf for leaf (``convert.lm_params_from_numpy``).

Parameters are made with ``requires_grad=False`` (serving);
``api.trainable`` turns them on for training. The chunked attention's
gradient is the reference's custom VJP (``flash_attention_xla``): the
forward keeps only its output and each row's log-sum-exp, and the backward
recomputes the probabilities block by block (``FlashAttention``: the
kernels K4 and K4b on the card, the plain pair on the CPU).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _save_dots(ctx, op, *args, **kwargs):
    """remat "dots": keep the outputs of matrix products with no batch
    dimension (``x @ w``, ``aten.mm``), recompute everything else
    (``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``)."""
    del ctx, args, kwargs
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under the layer remat policy ``cfg.remat`` where a
    gradient is being taken: "none" keeps every activation, "full" keeps
    only the inputs and recomputes the layer in the backward, "dots" keeps
    the matrix products' outputs too (``torch.utils.checkpoint``, not
    reentrant). The gradients are the same under all three."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _save_dots))
    if cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r} not in (none, full, dots)")
    return checkpoint(fn, *args, use_reentrant=False)


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return _param((x * scale).to(dtype))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, d: int | None = None, device=None) -> nn.Module:
    d = d or cfg.d_model
    p = nn.Module()
    p.scale = _param(torch.ones(d, dtype=_pdtype(cfg), device=device))
    if cfg.norm == "layernorm":
        p.bias = _param(torch.zeros(d, dtype=_pdtype(cfg), device=device))
    return p


def norm_apply(cfg: ModelConfig, p: nn.Module, x):
    """Norm with f32 statistics but elementwise math in the input dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        inv = torch.rsqrt(var + cfg.norm_eps)
        y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        return y * p.scale.to(x.dtype) + p.bias.to(x.dtype)
    ms = xf.square().mean(-1, keepdim=True)
    inv = torch.rsqrt(ms + cfg.norm_eps)
    return x * inv.to(x.dtype) * p.scale.to(x.dtype)


def rms_head_norm(x, scale, eps):
    """Per-head RMSNorm over the head dim (qwen3 qk_norm)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(cfg: ModelConfig, rot_dim: int, device=None):
    ar = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (cfg.rope_theta ** (ar / rot_dim))  # [rot_dim/2]


def apply_rope(cfg: ModelConfig, x, positions):
    """x: [..., S, H, D]; positions: [..., S] (broadcastable). neox
    rotate-half over the first ``rope_frac`` of the head dim (chatglm: 0.5,
    2d-RoPE's rotary half); sin/cos in f32, cast back to x's dtype."""
    if cfg.rope == "none":
        return x
    D = x.shape[-1]
    rot = int(D * cfg.rope_frac)
    rot -= rot % 2
    inv = rope_freqs(cfg, rot, x.device)
    ang = positions[..., :, None].float() * inv  # [..., S, rot/2]
    sin = torch.sin(ang)[..., :, None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., : rot // 2], x_rot[..., rot // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), x_pass], dim=-1)


def sincos_positions(d: int, length: int, device=None):
    """Whisper-style fixed sinusoidal table [length, d], f32."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    expo = 2 * dim / torch.full_like(dim, d)  # a true division on the card too
    ang = pos / torch.pow(torch.full_like(dim, 10000.0), expo)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, causal / sliding-window / cross, chunked online softmax)
# ---------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, gen: torch.Generator, cross: bool = False) -> nn.Module:
    """A cross-attention block has the same leaves (its k, v project the
    encoder's output)."""
    del cross
    d, dq, dkv, pdt = cfg.d_model, cfg.d_qkv, cfg.d_kv, _pdtype(cfg)
    p = nn.Module()
    p.wq = dense_init(gen, (d, dq), pdt)
    p.wk = dense_init(gen, (d, dkv), pdt)
    p.wv = dense_init(gen, (d, dkv), pdt)
    p.wo = dense_init(gen, (dq, d), pdt, scale=1.0 / math.sqrt(dq))
    if cfg.qk_norm:
        p.q_norm = _param(torch.ones(cfg.d_head, dtype=pdt, device=gen.device))
        p.k_norm = _param(torch.ones(cfg.d_head, dtype=pdt, device=gen.device))
    return p


def _repeat_kv(k, n_rep: int):
    """[B, S, Hkv, D] -> [B, S, Hkv * n_rep, D]; q head h reads kv head
    h // n_rep."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _attn_ok(q_pos, k_pos, causal: bool, window: int):
    """bool [..., Sq, Sk]: which (query, key) pairs may attend."""
    dif = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(dif.shape, dtype=torch.bool, device=dif.device)
    if causal:
        ok &= dif >= 0
    if window > 0:
        ok &= dif < window
    return ok


def _attn_scores_mask(q_pos, k_pos, causal: bool, window: int):
    """[..., Sq, Sk] additive f32 mask."""
    ok = _attn_ok(q_pos, k_pos, causal, window)
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill(~ok, float("-inf"))


def _pick_chunk(S1, S2, pref):
    C = min(pref, S1, S2)
    if S1 % C or S2 % C:
        C = min(math.gcd(S1, S2), pref)
    return C


def flash_attention_plain(q, k, v, *, q_offset: int = 0, causal: bool = True,
                          window: int = 0, chunk: int = 512, return_lse: bool = False):
    """The chunked plain path: the forward of the JAX package's
    ``flash_attention_xla`` (``_flash_fwd_impl``: online softmax over [C, C]
    blocks, f32 accumulators) at query positions ``q_offset + arange(Sq)``
    and key positions ``arange(Sk)``. q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv,
    D], kv heads repeated to q's. The q blocks are independent, so they run
    together and the kv blocks in order. With ``return_lse`` also each row's
    log-sum-exp ``m + log(max(l, 1e-30))``, f32 [B, Hq, Sq]."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k = _repeat_kv(k, H // k.shape[2])
    v = _repeat_kv(v, H // v.shape[2])
    scale = 1.0 / math.sqrt(D)
    C = _pick_chunk(Sq, Sk, chunk)
    nq, nk = Sq // C, Sk // C

    qc = q.reshape(B, nq, C, H, D).permute(1, 0, 3, 2, 4).float()  # [nq,B,H,C,D]
    kc = k.reshape(B, nk, C, H, D).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, nk, C, H, D).permute(1, 0, 3, 2, 4)
    qp = (q_offset + torch.arange(Sq, device=q.device)).reshape(nq, C)
    kp = torch.arange(Sk, device=q.device).reshape(nk, C)

    acc = torch.zeros(nq, B, H, C, D, dtype=torch.float32, device=q.device)
    m = torch.full((nq, B, H, C), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros(nq, B, H, C, dtype=torch.float32, device=q.device)
    for j in range(nk):
        s = torch.einsum("nbhqd,bhkd->nbhqk", qc, kc[j].float()) * scale
        s = s + _attn_scores_mask(qp, kp[j], causal, window)[:, None, None]
        m_new = torch.maximum(m, s.amax(-1)).clamp_min(-1e30)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "nbhqk,bhkd->nbhqd", p.to(v.dtype).float(), vc[j].float())
        m = m_new
    o = (acc / l[..., None].clamp_min(1e-30)).to(q.dtype)
    o = o.permute(1, 0, 3, 2, 4).reshape(B, Sq, H, D)
    if not return_lse:
        return o
    lse = m + torch.log(l.clamp_min(1e-30))  # [nq, B, H, C]
    return o, lse.permute(1, 2, 0, 3).reshape(B, H, Sq)


def flash_attention_plain_bwd(q, k, v, o, dout, lse, *, q_offset: int = 0,
                              causal: bool = True, window: int = 0, chunk: int = 512):
    """The chunked plain backward: the JAX package's ``_flash_bwd`` on [C, C]
    blocks, f32 throughout (p = exp(s - lse) recomputed, delta = rowsum(dout
    o), ds = p (dp - delta) / sqrt(D)). q, o, dout: [B, Sq, Hq, D]; k, v:
    [B, Sk, Hkv, D]; lse f32 [B, Hq, Sq]. Returns (dq, dk, dv) in the
    inputs' dtypes, dk and dv summed over each kv head's group of q heads
    (the reference repeats kv heads outside its VJP, so its broadcast sums
    them). The q blocks run together, the kv blocks in order."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    kr, vr = _repeat_kv(k, g), _repeat_kv(v, g)
    scale = 1.0 / math.sqrt(D)
    C = _pick_chunk(Sq, Sk, chunk)
    nq, nk = Sq // C, Sk // C

    def blocks(t, n):  # [B, S, H, D] -> [n, B, H, C, D], f32
        return t.reshape(B, n, C, H, D).permute(1, 0, 3, 2, 4).float()

    qc, doc, kc, vc = blocks(q, nq), blocks(dout, nq), blocks(kr, nk), blocks(vr, nk)
    lsec = lse.reshape(B, H, nq, C).permute(2, 0, 1, 3)  # [nq, B, H, C]
    delta = (dout.float() * o.float()).sum(-1)  # [B, Sq, H]
    deltac = delta.reshape(B, nq, C, H).permute(1, 0, 3, 2)
    qp = (q_offset + torch.arange(Sq, device=q.device)).reshape(nq, C)
    kp = torch.arange(Sk, device=q.device).reshape(nk, C)

    dq = torch.zeros(nq, B, H, C, D, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j in range(nk):
        s = torch.einsum("nbhqd,bhkd->nbhqk", qc, kc[j]) * scale
        s = s + _attn_scores_mask(qp, kp[j], causal, window)[:, None, None]
        p = torch.exp(s - lsec[..., None])
        dvs.append(torch.einsum("nbhqk,nbhqd->bhkd", p, doc))
        dp = torch.einsum("nbhqd,bhkd->nbhqk", doc, vc[j])
        ds = p * (dp - deltac[..., None]) * scale
        dks.append(torch.einsum("nbhqk,nbhqd->bhkd", ds, qc))
        dq += torch.einsum("nbhqk,bhkd->nbhqd", ds, kc[j])

    def heads(t):  # [B, H, S, D] -> [B, S, Hkv, D], the group summed
        return t.permute(0, 2, 1, 3).reshape(B, -1, Hkv, g, D).sum(3)

    dq = dq.permute(1, 0, 3, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    dk = heads(torch.cat(dks, dim=2)).to(k.dtype)
    dv = heads(torch.cat(dvs, dim=2)).to(v.dtype)
    return dq, dk, dv


# True inside ``api.plain_paths()``: CUDA tensors take the plain chunked
# paths (attention and the SSD scan) instead of the kernels
PLAIN_PATHS = False


class FlashAttention(torch.autograd.Function):
    """The chunked attention with the reference's flash-style VJP
    (``flash_attention_xla``): the forward saves (q, k, v, o, lse), the
    backward recomputes the probabilities. On the card (outside
    ``api.plain_paths()``) the forward is K4 with its lse and the backward
    K4b, and a kernel that fails raises; otherwise the plain pair
    (``flash_attention_plain`` with its lse, ``flash_attention_plain_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, causal: bool, window: int, chunk: int):
        kernels = q.is_cuda and not PLAIN_PATHS
        if kernels:
            o, lse = fa_ops.flash_attention(q, k, v, q_offset=q_offset, causal=causal,
                                            window=window, return_lse=True)
        else:
            o, lse = flash_attention_plain(q, k, v, q_offset=q_offset, causal=causal,
                                           window=window, chunk=chunk, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (kernels, q_offset, causal, window, chunk)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        kernels, q_offset, causal, window, chunk = ctx.opts
        if kernels:
            dq, dk, dv = fa_ops.flash_attention_bwd(q, k, v, o, dout.contiguous(), lse,
                                                    q_offset=q_offset, causal=causal,
                                                    window=window)
        else:
            dq, dk, dv = flash_attention_plain_bwd(q, k, v, o, dout, lse, q_offset=q_offset,
                                                   causal=causal, window=window, chunk=chunk)
        return dq, dk, dv, None, None, None, None


def chunked_attention(cfg: ModelConfig, q, k, v, *, q_offset: int = 0,
                      causal: bool = True, window: int = 0):
    """Memory-bounded attention. q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D].
    CUDA tensors go through the flash-attention kernel (the counterpart of
    the JAX package's ``use_pallas=True``), CPU tensors, and CUDA ones
    inside ``api.plain_paths()``, through the chunked plain path (its
    ``use_pallas=False``). Where a gradient is wanted (grad mode on and an
    input requiring one) it goes through ``FlashAttention``; under
    ``torch.no_grad`` (prefill, decode, the engine) the forward alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_offset, causal, window, cfg.attn_chunk)
    if q.is_cuda and not PLAIN_PATHS:
        return fa_ops.flash_attention(q, k, v, q_offset=q_offset, causal=causal,
                                      window=window)
    return flash_attention_plain(q, k, v, q_offset=q_offset, causal=causal,
                                 window=window, chunk=cfg.attn_chunk)


def plain_attention(q, k, v, *, q_pos, k_pos, causal, window):
    D = q.shape[-1]
    Hq, Hkv = q.shape[2], k.shape[2]
    k = _repeat_kv(k, Hq // Hkv)
    v = _repeat_kv(v, Hq // Hkv)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / math.sqrt(D) + _attn_scores_mask(q_pos, k_pos, causal, window)[None, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _kv_quantize(x):
    """[B, S, H, D] -> (int8 values, per-(B, S, H) bf16 scales): the scale
    amax / 127 in f32 divides the values, rounded half to even, and is
    kept in bf16."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _cache_write(a, rows, cols, new):
    """A copy of cache leaf ``a`` with ``new`` written at (rows, cols)."""
    out = a.clone()
    out[rows, cols] = new.to(a.dtype)
    return out


def attention_apply(cfg: ModelConfig, p: nn.Module, x, *, positions,
                    causal: bool = True, window: int | None = None, kv_x=None,
                    kv_positions=None, cache=None):
    """Attention block: qkv proj -> (qk_norm) -> rope -> attention -> out.

    positions: [S] shared by the batch, or [B, S] per row (decode with a
    cache), or the host integer ``p0`` of contiguous positions ``p0 +
    arange(S)``. The chunked path (S or Skv >= 2048) needs them
    contiguous where its mask reads them (causal or windowed; its mask
    depends only on ``qpos - kpos``, so it runs at ``q_offset`` 0), and a
    tensor cannot be checked for that without reading it back from the
    device, so there it takes only ``p0`` and raises on a tensor.

    kv_x: cross attention, keys and values projected from ``kv_x`` [B, Skv,
    d] at ``kv_positions`` (default: ``positions``), with no rope.

    cache: optional dict(k=[B, Smax, Hkv, D], v=..., len=i64[B]), or with
    ``cfg.kv_quant`` dict(k_q, v_q int8 [B, Smax, Hkv, D], k_s, v_s bf16
    [B, Smax, Hkv], len). Each row writes its new k/v at its own ``len``
    (clamped so the S new positions fit) and attends over keys ``kpos <
    len + S`` with ``kpos <=`` its position. Returns (out, new_cache); the
    cache is not written in place.
    """
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    window = (cfg.attn_window if window is None else window) or 0
    dt = _dtype(cfg)
    kv_src = x if kv_x is None else kv_x
    Skv = kv_src.shape[1]
    chunked = cache is None and (S >= 2048 or Skv >= 2048)
    if isinstance(positions, int):
        positions = positions + torch.arange(S, device=x.device)
    elif chunked and (causal or window):
        raise ValueError(f"the chunked attention path (S={S}, Skv={Skv} >= 2048) needs "
                         f"contiguous positions: pass their first one as the host integer p0")
    kv_pos = positions if kv_positions is None else kv_positions
    if isinstance(kv_pos, int):
        kv_pos = kv_pos + torch.arange(Skv, device=x.device)

    q = (x @ p.wq.to(dt)).reshape(B, S, H, D)
    k = (kv_src @ p.wk.to(dt)).reshape(B, Skv, Hkv, D)
    v = (kv_src @ p.wv.to(dt)).reshape(B, Skv, Hkv, D)
    if cfg.qk_norm:
        q = rms_head_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_head_norm(k, p.k_norm, cfg.norm_eps)
    if kv_x is None:  # self-attention: rope on q and k
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, kv_pos)

    new_cache = None
    if cache is not None:
        idx = cache["len"]
        Smax = cache["k_q" if cfg.kv_quant else "k"].shape[1]
        rows = torch.arange(B, device=x.device)[:, None]
        cols = idx.clamp(0, Smax - S)[:, None] + torch.arange(S, device=x.device)
        if cfg.kv_quant:
            # int8 cache: per-(position, head) scales, half the bytes of bf16
            (kq, ks), (vq, vs) = _kv_quantize(k), _kv_quantize(v)
            new_cache = {"k_q": _cache_write(cache["k_q"], rows, cols, kq),
                         "k_s": _cache_write(cache["k_s"], rows, cols, ks),
                         "v_q": _cache_write(cache["v_q"], rows, cols, vq),
                         "v_s": _cache_write(cache["v_s"], rows, cols, vs), "len": idx + S}
            ck = (new_cache["k_q"].float() * new_cache["k_s"][..., None].float()).to(dt)
            cv = (new_cache["v_q"].float() * new_cache["v_s"][..., None].float()).to(dt)
        else:
            ck = _cache_write(cache["k"], rows, cols, k)
            cv = _cache_write(cache["v"], rows, cols, v)
            new_cache = {"k": ck, "v": cv, "len": idx + S}
        kpos = torch.arange(Smax, device=x.device)
        qpos = positions if positions.dim() == 2 else positions[None]  # [B|1, S]
        ok = _attn_ok(qpos, kpos, True, window)
        ok = ok & (kpos[None, :] < (idx + S)[:, None])[:, None, :]
        kk = _repeat_kv(ck.to(dt), H // Hkv)
        vv = _repeat_kv(cv.to(dt), H // Hkv)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) / math.sqrt(D)
        s = s.masked_fill(~ok[:, None], float("-inf"))
        prob = torch.softmax(s, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", prob, vv)
    elif chunked:
        out = chunked_attention(cfg, q, k, v, causal=causal, window=window)
    else:
        out = plain_attention(q, k, v, q_pos=positions, k_pos=kv_pos, causal=causal,
                              window=window)

    out = out.reshape(B, S, H * D) @ p.wo.to(dt)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: int | None = None) -> nn.Module:
    d_ff = d_ff or cfg.d_ff
    d, pdt = cfg.d_model, _pdtype(cfg)
    p = nn.Module()
    if cfg.act == "swiglu":
        p.wg = dense_init(gen, (d, d_ff), pdt)
    p.wu = dense_init(gen, (d, d_ff), pdt)
    p.wd = dense_init(gen, (d_ff, d), pdt)
    return p


def mlp_apply(cfg: ModelConfig, p: nn.Module, x):
    dt = _dtype(cfg)
    if cfg.act == "swiglu":
        g = F.silu(x @ p.wg.to(dt))
        u = x @ p.wu.to(dt)
        return (g * u) @ p.wd.to(dt)
    return F.gelu(x @ p.wu.to(dt), approximate="tanh") @ p.wd.to(dt)
