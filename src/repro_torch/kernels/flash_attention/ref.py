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
                  q_offset: int = 0):
    """q [BH, Sq, D]; k, v [BH / g, Sk, D] (q row bh reads kv row bh // g).
    Returns [BH, Sq, D] in q's dtype."""
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
    return (acc / torch.where(l > 0, l, 1.0)).to(q.dtype)


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
