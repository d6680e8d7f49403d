"""The plain version of the flash-attention kernel: the score matrix
materialised, with the kernel's arithmetic (the TPU kernel's, in
``src/repro/kernels/flash_attention/kernel.py``).

The f32 product of q and k is scaled by ``1/sqrt(D)``, masked by position
(``qpos = q_offset + row``, ``kpos = col``), ``p = exp(s - rowmax)`` is
zeroed where masked and cast to v's dtype before the PV product, and the
f32 result is divided by the row sum where it is positive, else by 1, so a
row with no valid key is 0.
"""
from __future__ import annotations

import math

import torch


def valid_mask(Sq: int, Sk: int, *, causal: bool, window: int, q_offset: int,
               device=None) -> torch.Tensor:
    """bool[Sq, Sk]: which (query, key) pairs may attend."""
    qp = q_offset + torch.arange(Sq, device=device)
    kp = torch.arange(Sk, device=device)
    dif = qp[:, None] - kp[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        ok &= dif >= 0
    if window > 0:
        ok &= dif < window
    return ok


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0, return_lse: bool = False):
    """q [BH, Sq, D]; k, v [BH / g, Sk, D] (q row bh reads kv row bh // g).
    Returns [BH, Sq, D] in q's dtype, and with ``return_lse`` each row's
    log-sum-exp of its scaled scores, f32 [BH, Sq] (-1e30 for a row with no
    valid key, as the JAX package's ``_flash_fwd_impl`` gives it)."""
    g = q.shape[0] // k.shape[0]
    k = k.repeat_interleave(g, dim=0)
    v = v.repeat_interleave(g, dim=0)
    scale = 1.0 / math.sqrt(q.shape[-1])
    ok = valid_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                    q_offset=q_offset, device=q.device)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    s = torch.where(ok, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (acc / torch.where(l > 0, l, 1.0)).to(q.dtype)
    if not return_lse:
        return o
    lse = m[..., 0].clamp_min(-1e30) + torch.log(l[..., 0].clamp_min(1e-30))
    return o, lse


def attention_bwd_ref(q, k, v, o, dout, lse, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0):
    """The plain version of the backward kernel (K4b), the scores
    materialised: q, o, dout [BH, Sq, D]; k, v [BH / g, Sk, D]; lse f32
    [BH, Sq] -> (dq, dk, dv) in the inputs' dtype. The kernel's arithmetic:
    S in f32, P = exp(S scale - lse) where the pair is valid, else 0, delta
    = rowsum(dout o) in f32, dS = P (dP - delta) scale; P and dS rounded to
    the inputs' dtype before their products; dk and dv summed over the q
    rows of each kv row's group."""
    BH, Sq, D = q.shape
    BHk, Sk = k.shape[:2]
    g = BH // BHk
    kr = k.repeat_interleave(g, dim=0).float()
    vr = v.repeat_interleave(g, dim=0).float()
    scale = 1.0 / math.sqrt(D)
    ok = valid_mask(Sq, Sk, causal=causal, window=window, q_offset=q_offset, device=q.device)
    qf, dof = q.float(), dout.float()
    s = torch.matmul(qf, kr.transpose(1, 2)) * scale
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1)
    dp = torch.matmul(dof, vr.transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    pd, dsd = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.matmul(pd.transpose(1, 2), dof).view(BHk, g, Sk, D).sum(1)
    dk = torch.matmul(dsd.transpose(1, 2), qf).view(BHk, g, Sk, D).sum(1)
    dq = torch.matmul(dsd, kr)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bh(t):
    """[B, S, H, D] -> [B * H, S, D]."""
    B, S, H, D = t.shape
    return t.transpose(1, 2).reshape(B * H, S, D)


def _bshd(t, B: int):
    """[B * H, S, D] -> [B, S, H, D]."""
    BH, S, D = t.shape
    return t.reshape(B, BH // B, S, D).transpose(1, 2)


def attention_heads_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, return_lse: bool = False):
    """``attention_ref`` in the model's layout: q [B, Sq, Hq, D]; k, v [B,
    Sk, Hkv, D] (q head h reads kv head h // (Hq / Hkv)) -> [B, Sq, Hq, D]
    in q's dtype, and with ``return_lse`` the lse f32 [B, Hq, Sq]."""
    B, Sq, H, _ = q.shape
    out = attention_ref(_bh(q), _bh(k), _bh(v), causal=causal, window=window,
                        q_offset=q_offset, return_lse=return_lse)
    if not return_lse:
        return _bshd(out, B)
    return _bshd(out[0], B), out[1].reshape(B, H, Sq)


def attention_bwd_heads_ref(q, k, v, o, dout, lse, *, causal: bool = True, window: int = 0,
                            q_offset: int = 0):
    """``attention_bwd_ref`` in the model's layout: q, o, dout [B, Sq, Hq,
    D]; k, v [B, Sk, Hkv, D]; lse [B, Hq, Sq] -> (dq, dk, dv) as [B, S, H,
    D] (contiguous)."""
    B, Sq, H, _ = q.shape
    dq, dk, dv = attention_bwd_ref(_bh(q), _bh(k), _bh(v), _bh(o), _bh(dout),
                                   lse.reshape(B * H, Sq), causal=causal, window=window,
                                   q_offset=q_offset)
    return tuple(_bshd(t, B).contiguous() for t in (dq, dk, dv))


def tile_plan(Sq: int, Sk: int, BQ: int, BK: int, *, causal: bool, window: int,
              q_offset: int) -> list[list[tuple[int, bool]]]:
    """The rule the kernel walks by (``csrc/flash_attention.cu``:
    ``kv_tiles``, ``needs_mask``): for each q tile of BQ rows, the kv tiles
    of BK keys it visits, in order, each as (tile index, needs a mask).

    A q tile visits the kv tiles that can hold a valid key for one of its
    query positions [qlo, qhi] (``qlo = q_offset + q0``, ``qhi`` its last
    row below Sq): up to the causal diagonal, from the window's first key.
    A visited tile needs the position test only if it holds an invalid pair
    for one of those positions: it reaches past Sk (the ragged last tile),
    past the diagonal of the first row (causal), or behind the window of
    the last row. Every other tile is wholly valid and takes no test."""
    plan = []
    for q0 in range(0, Sq, BQ):
        qlo, qhi = q_offset + q0, q_offset + min(q0 + BQ, Sq) - 1
        kend = min(Sk, qhi + 1) if causal else Sk
        kbeg = max(0, qlo - window + 1) if window > 0 else 0
        t0 = kbeg // BK
        t1 = t0 if kend <= kbeg else -(-kend // BK)
        plan.append([(kt, kt * BK + BK > Sk
                      or (causal and kt * BK + BK - 1 > qlo)
                      or (window > 0 and qhi - kt * BK >= window))
                     for kt in range(t0, t1)])
    return plan


def row_relative_error(got, want) -> torch.Tensor:
    """f32[..., Sq]: each output row's largest abs error over the largest
    abs value of that row of ``want``; 0 where both rows are all zero (a
    row with no valid key), inf where only ``want``'s is.

    An elementwise ``atol`` is blind to the late rows of a long causal
    sequence, whose outputs average thousands of keys and shrink towards
    0; this scale follows each row."""
    err = (got.float() - want.float()).abs().amax(dim=-1)
    scale = want.float().abs().amax(dim=-1)
    return torch.where(scale > 0, err / scale.clamp_min(1e-30),
                       torch.where(err > 0, torch.inf, 0.0))
