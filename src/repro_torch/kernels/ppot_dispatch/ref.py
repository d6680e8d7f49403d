"""Plain PyTorch versions of the PPoT dispatch kernels.

Semantics (paper Fig. 5, batched): for each job b

  j1 = min(#{i : cdf[i] <= u1[b]}, n - 1)   (inverse-CDF proportional draw)
  j2 = min(#{i : cdf[i] <= u2[b]}, n - 1)
  out[b] = j1 if q[j1] <= q[j2] else j2     (SQ(2), queue lengths as ints)

or, with a Walker alias table, ``j = v < prob[bin] ? bin : alias[bin]`` for
``bin = min(int(u * n), n - 1)``. The fused forms also return
``q_after = q + histogram(workers)``; the keyed alias form draws its own
uniforms (``prng.uniform_quad`` of the route key) and folds only the
active slots. ``alias_table_ref`` is the
alias-table build after the scaling: the stack order, the plain
small/large pairing loop (``alias_pairing_ref``) and the mask pass.

These are the CPU path of every wrapper in ``kernel.py`` and the versions
each CUDA kernel is held against on the card. They run on whatever device
their inputs live on (the pairing loop always walks on the host).
``alias_sweep_ref`` mirrors the CUDA kernel's restructured walk in numpy,
for the tests that show the restructuring exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import prng


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


def ppot_dispatch_fused_alias_keyed_ref(prob, alias, q, key, B: int, active=None):
    """``ppot_dispatch_fused_alias_ref`` on ``prng.uniform_quad(key, B)``'s
    uniforms, folding only the active slots (bool[B] or None) -> (workers
    i32[B], -1 at an inactive slot; q_after i32[n])."""
    u1, u2, v1, v2 = prng.uniform_quad(key, B, q.device)
    w = ppot_dispatch_alias_ref(prob, alias, q, u1, v1, u2, v2)
    if active is None:
        return w, fold_back(q, w)
    n = q.shape[0]
    idx = torch.where(active, w.long(), n)  # inactive slots land in bin n, cut off
    counts = torch.zeros(n + 1, dtype=q.dtype, device=q.device).index_add_(
        0, idx, torch.ones_like(idx, dtype=q.dtype))[:n]
    return torch.where(active, w, -1), q + counts


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


def stack_order(p: torch.Tensor):
    """The reference's packed stacks: (stack i32[n] with the smalls, p < 1,
    in index order at [0, ns0) and the larges in index order after them,
    ns0 i32[1]). NaN counts as large."""
    n = p.shape[0]
    idx = torch.arange(n, device=p.device)
    small = p < 1.0
    stack = idx[torch.argsort(torch.where(small, idx, n + idx))].to(torch.int32)
    return stack, small.sum(dtype=torch.int32).reshape(1)


def alias_table_ref(p: torch.Tensor, active: torch.Tensor | None = None):
    """p f32[n] scaled weights (mean 1), active bool[n] or None ->
    (prob f32[n], alias i32[n]): the stack walk, then the hard mask
    guarantee (inactive bins accept nothing and every alias edge lands on
    an active worker; all inactive gives prob 1 and alias 0 everywhere)."""
    prob, alias = alias_pairing_ref(p, *stack_order(p))
    return (prob, alias) if active is None else mask_pass(prob, alias, active)


def mask_pass(prob: torch.Tensor, alias: torch.Tensor, active: torch.Tensor):
    """The reference's mask pass over a walked table, independent of the
    walk's float drift."""
    prob = torch.where(active.any(), torch.where(active, prob, 0.0),
                       torch.ones_like(prob))
    first_active = active.to(torch.int32).argmax().to(torch.int32)
    return prob, torch.where(active[alias.long()], alias, first_active)


MASKS = ("none", "tenth_off", "single_on", "all_off")


def make_mask(kind: str, n: int, rng) -> np.ndarray | None:
    """A worker mask for holding the kernels against their plain versions:
    None, a tenth of the workers (at least one) off, a single worker on, or
    all off. ``rng`` is a ``numpy.random.RandomState``."""
    if kind == "none":
        return None
    m = np.full(n, kind == "tenth_off")
    if kind == "tenth_off":
        m[rng.choice(n, max(n // 10, 1), replace=False)] = False
    elif kind == "single_on":
        m[rng.randint(n)] = True
    return m


def alias_sweep_ref(p: torch.Tensor):
    """The CUDA kernel's walk and rebuild, in numpy f32.

    The walk takes the smalls (descending index) and the larges (ascending
    index) each as a fixed sequence, one step per small finalised: the
    small is the last residual if the step before dropped its large below 1
    (in the stack walk that residual took the vacated top slot), else the
    next small; the large is the next one after a drop. A step records only
    its residual r. The table is rebuilt from the residuals alone: step t
    dropped iff r[t] < 1, so counts of drops say which small and which
    large each step took. The same f32 operations in the same order as
    ``alias_pairing_ref``, so the result is bit-identical."""
    dev = p.device
    p = p.detach().cpu().numpy().astype(np.float32)
    n = p.shape[0]
    small = p < 1.0
    smalls, larges = np.nonzero(small)[0][::-1], np.nonzero(~small)[0]
    ns0, nl0 = len(smalls), len(larges)
    one = np.float32(1.0)
    log = []  # the residual after each step
    ns, nl, i_s, j, pend = ns0, nl0, 0, 0, False
    pl = p[larges[0]] if nl0 else one
    while ns > 0 and nl > 0:
        d = one - log[-1] if pend else one - p[smalls[i_s]]
        r = pl - d
        log.append(r)
        if not pend:
            i_s += 1
        drop = bool(r < one)
        if drop:
            j += 1
            nl -= 1
            pl = p[larges[j]] if j < nl0 else one
        else:
            ns -= 1
            pl = r
        pend = drop
    dropped = np.array([bool(r < one) for r in log], bool)
    drops = np.concatenate([[0], np.cumsum(dropped)])  # drops before each step
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    for t, r in enumerate(log):
        if t > 0 and dropped[t - 1]:  # the residual of large drops[t] - 1
            b, pr = larges[drops[t] - 1], log[t - 1]
        else:
            b = smalls[t - (drops[t - 1] if t > 0 else 0)]
            pr = p[b]
        prob[b] = pr
        alias[b] = larges[drops[t]]
    return torch.from_numpy(prob).to(dev), torch.from_numpy(alias).to(dev)
