"""Plain PyTorch versions of the PPoT dispatch kernels.

Semantics (paper Fig. 5, batched): for each job b

  j1 = min(#{i : cdf[i] <= u1[b]}, n - 1)   (inverse-CDF proportional draw)
  j2 = min(#{i : cdf[i] <= u2[b]}, n - 1)
  out[b] = j1 if q[j1] <= q[j2] else j2     (SQ(2), queue lengths as ints)

or, with a Walker alias table, ``j = v < prob[bin] ? bin : alias[bin]`` for
``bin = min(int(u * n), n - 1)``. The fused forms also return
``q_after = q + histogram(workers)``. ``alias_pairing_ref`` is the plain
small/large pairing loop of the alias-table build.

These are the CPU path of every wrapper in ``kernel.py`` and the versions
each CUDA kernel is held against on the card. They run on whatever device
their inputs live on (the pairing loop always walks on the host).
"""
from __future__ import annotations

import numpy as np
import torch


def make_cdf(mu_hat: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of μ̂ normalised to end at exactly 1; all-zero
    μ̂ (a dead cluster) degenerates to the uniform CDF."""
    w = torch.where(mu_hat.sum() > 0, mu_hat, torch.ones_like(mu_hat))
    c = torch.cumsum(w, 0)
    return c / c[-1]


def cdf_probe(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    n = cdf.shape[0]
    j = (cdf[None, :] <= u[:, None]).sum(1)
    return j.clamp(max=n - 1).to(torch.int32)


def alias_probe(prob, alias, u, v):
    n = prob.shape[0]
    b = (u * n).to(torch.int32).clamp(max=n - 1)
    bl = b.long()
    return torch.where(v < prob[bl], b, alias[bl]).to(torch.int32)


def _sq2(q, j1, j2):
    return torch.where(q[j1.long()] <= q[j2.long()], j1, j2)


def fold_back(q: torch.Tensor, workers: torch.Tensor) -> torch.Tensor:
    return q + torch.zeros_like(q).index_add_(
        0, workers.long(), torch.ones_like(workers, dtype=q.dtype))


def ppot_dispatch_ref(cdf, q, u1, u2) -> torch.Tensor:
    """cdf f32[n], q i32[n], u1/u2 f32[B] -> i32[B] chosen workers."""
    return _sq2(q, cdf_probe(cdf, u1), cdf_probe(cdf, u2))


def ppot_dispatch_alias_ref(prob, alias, q, u1, v1, u2, v2) -> torch.Tensor:
    """prob f32[n], alias i32[n], q i32[n], u/v f32[B] -> i32[B]."""
    return _sq2(q, alias_probe(prob, alias, u1, v1),
                alias_probe(prob, alias, u2, v2))


def ppot_dispatch_fused_ref(cdf, q, u1, u2):
    """-> (workers i32[B], q_after i32[n])."""
    w = ppot_dispatch_ref(cdf, q, u1, u2)
    return w, fold_back(q, w)


def ppot_dispatch_fused_alias_ref(prob, alias, q, u1, v1, u2, v2):
    """-> (workers i32[B], q_after i32[n])."""
    w = ppot_dispatch_alias_ref(prob, alias, q, u1, v1, u2, v2)
    return w, fold_back(q, w)


def alias_pairing_ref(p: torch.Tensor, stack: torch.Tensor, ns0: torch.Tensor):
    """Vose/Walker small/large pairing, one bin finalised per step.

    ``p`` f32[n] are the scaled weights (mean 1), ``stack`` i32[n] holds the
    smalls (p < 1) in index order at [0, ns0) and the larges in index order
    at [ns0, n). Returns (prob f32[n], alias i32[n]). The arithmetic is f32
    step for step (numpy float32 scalars), so the loop is exact against the
    reference's ``fori_loop`` on the same ``p``.
    """
    dev = p.device
    n = p.shape[0]
    p = p.detach().cpu().numpy().astype(np.float32)
    st = stack.detach().cpu().numpy().astype(np.int64)
    ns = int(ns0)
    nl = n - ns
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    one = np.float32(1.0)
    # each step finalises one small; once either stack is empty the rest
    # keep prob 1 and alias themselves, which the init already holds
    while ns > 0 and nl > 0:
        s, l = st[ns - 1], st[n - nl]
        prob[s] = p[s]
        alias[s] = l
        pl = p[l] - (one - p[s])  # large's residual mass
        p[l] = pl
        if pl < one:
            st[ns - 1] = l  # residual large takes the vacated small slot
            nl -= 1
        else:
            ns -= 1
    return (torch.from_numpy(prob).to(dev),
            torch.from_numpy(alias).to(dev))
