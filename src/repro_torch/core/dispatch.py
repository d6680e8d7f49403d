"""Batched dispatch engine, PPoT-SQ(2) path.

One engine call places a batch of B tasks against a queue snapshot and
returns ``(workers[B], q_after[n])``: every probe is drawn up front from a
counter-hash stream that never depends on the queue, every task selects
against the same snapshot (SQ(2): the shorter of two μ̂-proportional
probes), and the batch's own placements fold back into the view.

Probe draws are inverse-CDF (``#{cdf <= u}``) or, given an amortised
``AliasTable`` built once per μ̂ refresh, Walker alias draws (two gathers
and a compare). ``fold_chunks=C`` re-snapshots the queue between C
sub-chunks; ``C = B`` is per-task sequential placement, kept as the oracle
``dispatch_sequential``. ``mask`` (bool[n]) restricts every draw to active
workers.

Kernels: every C = 1 batch goes through a kernel wrapper, which launches
the kernel on CUDA tensors and runs its plain version only on CPU tensors.
A batch with an alias table runs the fused alias kernel (a masked table
gives inactive workers no mass, so the kernel serves masked batches too);
a CDF batch runs the fused CDF kernel or, under a slot or membership mask,
the select kernel. Inactive slots are folded out here. The alias table's
pairing walk is a single-block kernel, so a table build costs a few
launches, not one per bin. C > 1 chunks select with tensor ops, as the
reference's chunk scan does.

Only PPoT-SQ(2) is ported; the engine raises for the other policies.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import policies as pol
from repro_torch.kernels.ppot_dispatch import kernel, ref
from repro_torch.utils import prng


class DispatchResult(NamedTuple):
    workers: torch.Tensor  # i32[B] chosen worker per task; -1 at inactive slots
    q_after: torch.Tensor  # i32[n] queue view with the batch folded back


class AliasTable(NamedTuple):
    """Walker alias table: a draw (u, v) lands in bin ``i = int(u * n)`` and
    resolves to ``i`` if ``v < prob[i]`` else ``alias[i]``."""

    prob: torch.Tensor  # f32[n] acceptance threshold per bin
    alias: torch.Tensor  # i32[n] overflow partner per bin


def build_alias_table(mu_hat: torch.Tensor,
                      active: torch.Tensor | None = None) -> AliasTable:
    """Vose/Walker alias table of μ̂ (all-zero μ̂ -> uniform).

    ``active`` (bool[n]) gives inactive workers exactly zero mass: their
    threshold is 0 and their alias an active worker; if every active worker
    has μ̂ = 0 the mass is uniform over the active set. The scaling, the
    stack order and the mask post-pass are tensor ops; the pairing walk is
    ``kernel.alias_pairing``.
    """
    n = mu_hat.shape[0]
    if active is None:
        w = torch.where(mu_hat.sum() > 0, mu_hat, torch.ones_like(mu_hat))
    else:
        masked = torch.where(active, mu_hat, 0.0)
        fallback = torch.where(active.any(), active.to(mu_hat.dtype),
                               torch.ones_like(mu_hat))
        w = torch.where(masked.sum() > 0, masked, fallback)
    s = w.sum()
    p = (w * (torch.full_like(s, n) / s)).to(torch.float32)  # mean 1
    idx = torch.arange(n, device=mu_hat.device)
    small = p < 1.0
    stack = idx[torch.argsort(torch.where(small, idx, n + idx))].to(torch.int32)
    ns0 = small.sum(dtype=torch.int32).reshape(1)
    prob, alias = kernel.alias_pairing(p, stack, ns0)
    if active is not None:
        # hard mask guarantee, whatever the pairing's float drift
        any_active = active.any()
        prob = torch.where(any_active, torch.where(active, prob, 0.0),
                           torch.ones_like(prob))
        first_active = active.to(torch.int32).argmax().to(torch.int32)
        alias = torch.where(active[alias.long()], alias, first_active)
    return AliasTable(prob=prob, alias=alias)


def alias_sample(table: AliasTable, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return ref.alias_probe(table.prob, table.alias, u, v)


def inverse_cdf_sample(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """j[b] = #{i : cdf[i] <= u[b]} clipped to n - 1, the kernels' probe."""
    return ref.cdf_probe(cdf, u)


def masked_cdf(mu: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``make_cdf`` with inactive workers' mass exactly zero; all-active-zero
    falls back to uniform over the active set."""
    w = torch.where(mask, mu, 0.0)
    fallback = torch.where(mask.any(), mask.to(mu.dtype), torch.ones_like(mu))
    w = torch.where(w.sum() > 0, w, fallback)
    c = torch.cumsum(w, 0)
    return c / c[-1]


def active_choice(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Uniform draw over the ACTIVE workers: u in [0, 1) indexes the active
    workers in index order (all-inactive: uniform over everything)."""
    n = mask.shape[0]
    idx = torch.arange(n, device=mask.device)
    order = torch.argsort(torch.where(mask, idx, n + idx)).to(torch.int32)
    n_act = mask.sum(dtype=torch.int32)
    n_eff = n_act.clamp(min=1)
    j = torch.minimum((u * n_eff).to(torch.int32), n_eff - 1)
    return torch.where(n_act > 0, order[j.long()], (u * n).to(torch.int32))


def fold_counts(q: torch.Tensor, workers: torch.Tensor,
                active: torch.Tensor | None) -> torch.Tensor:
    """Per-worker placement counts; inactive slots land in a sentinel bin n
    that is cut off. An index_add_ of ints is exact in any order and, unlike
    a CUDA bincount, needs no host synchronisation for its length."""
    n = q.shape[0]
    w = workers.long() if active is None else torch.where(active, workers.long(), n)
    ones = torch.ones(w.shape, dtype=q.dtype, device=q.device)
    return torch.zeros(n + 1, dtype=q.dtype, device=q.device).index_add_(0, w, ones)[:n]


def within_batch_rank(workers: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """rank[b] = #{a < b : active[a] and workers[a] == workers[b]}.

    A stable sort groups equal workers in batch order; the rank is the
    exclusive running count of active slots since the group began."""
    order = torch.argsort(workers, stable=True)
    sa = active[order].to(torch.int32)
    sw = workers[order]
    ex = torch.cumsum(sa, 0).to(torch.int32) - sa
    start = torch.ones_like(sw, dtype=torch.bool)
    start[1:] = sw[1:] != sw[:-1]
    base = torch.cummax(torch.where(start, ex, 0), 0).values
    return torch.empty_like(ex).scatter_(0, order, ex - base)


def _chunking(B: int, fold_chunks: int) -> tuple[int, int]:
    """(chunks, padded_B): B is padded up to a multiple of C with inactive
    slots that are sliced off."""
    C = max(min(int(fold_chunks), B), 1)
    return C, -(-B // C) * C


def _draws(key, B: int, mu_hat, table: AliasTable | None,
           mask: torch.Tensor | None) -> dict:
    """PPoT-SQ(2)'s uniforms for B tasks: the alias (u, v) stream with a
    table, else the inverse-CDF u stream and the (masked) CDF."""
    dev = mu_hat.device
    if table is not None:
        return dict(zip(("u1", "u2", "v1", "v2"), prng.uniform_quad(key, B, dev)))
    cdf = ref.make_cdf(mu_hat) if mask is None else masked_cdf(mu_hat, mask)
    u1, u2 = prng.uniform_pair(key, B, dev)
    return dict(cdf=cdf, u1=u1, u2=u2)


def _probes(d: dict, table: AliasTable | None):
    """The two probed workers of every task, from ``_draws``' uniforms."""
    if table is not None:
        return alias_sample(table, d["u1"], d["v1"]), alias_sample(table, d["u2"], d["v2"])
    return inverse_cdf_sample(d["cdf"], d["u1"]), inverse_cdf_sample(d["cdf"], d["u2"])


def _select(q_view, j1, j2):
    return torch.where(q_view[j1.long()] <= q_view[j2.long()], j1, j2)


def dispatch(
    policy: str,
    key: prng.Key,
    q: torch.Tensor,  # i32[n] queue snapshot
    mu_hat: torch.Tensor,  # f32[n] learner estimates
    mu_true: torch.Tensor,  # f32[n] ground truth (read by no ported policy)
    cfg: pol.PolicyConfig,
    B: int,
    *,
    active: torch.Tensor | None = None,  # bool[B]; inactive slots place nothing
    fold_chunks: int = 1,
    table: AliasTable | None = None,  # alias table built from THIS mu_hat
    mask: torch.Tensor | None = None,  # bool[n] membership
) -> DispatchResult:
    """Place ``B`` tasks in one engine call; see the module docstring."""
    del mu_true, cfg
    if policy != pol.PPOT_SQ2:
        raise NotImplementedError(f"policy {policy!r} is not ported yet")
    C, Bp = _chunking(B, fold_chunks)
    if C == 1:
        return _dispatch_batch(key, B, q, mu_hat, active, table, mask)
    act = active
    if Bp != B:
        pad = torch.zeros(Bp - B, dtype=torch.bool, device=q.device)
        head = torch.ones(B, dtype=torch.bool, device=q.device) if act is None else act
        act = torch.cat([head, pad])
    j1, j2 = (j.view(C, -1) for j in _probes(_draws(key, Bp, mu_hat, table, mask), table))
    acts = (torch.ones(Bp, dtype=torch.bool, device=q.device)
            if act is None else act).view(C, -1)
    qv, ws = q, []
    for c in range(C):  # re-snapshot the queue after every chunk
        w = _select(qv, j1[c], j2[c])
        qv = qv + fold_counts(qv, w, acts[c])
        ws.append(w)
    workers = torch.cat(ws)[:B].to(torch.int32)
    return _fold(q, workers, None if act is None else act[:B])


def _dispatch_batch(key, B: int, q, mu_hat, active, table, mask) -> DispatchResult:
    """C = 1: one snapshot for the whole batch, through the kernel wrappers."""
    d = _draws(key, B, mu_hat, table, mask)
    if table is not None:
        workers, q_after = kernel.ppot_dispatch_fused_alias(
            table.prob, table.alias, q, d["u1"], d["v1"], d["u2"], d["v2"])
    elif active is None and mask is None:
        workers, q_after = kernel.ppot_dispatch_fused(d["cdf"], q, d["u1"], d["u2"])
    else:
        return _fold(q, kernel.ppot_dispatch(d["cdf"], q, d["u1"], d["u2"]), active)
    if active is not None:  # the kernel folded every slot: refold the active ones
        return _fold(q, workers, active)
    return DispatchResult(workers=workers, q_after=q_after)


def _fold(q, workers, act) -> DispatchResult:
    """The batch's placements folded into q; inactive slots place nothing
    and report worker -1."""
    q_after = q + fold_counts(q, workers, act)
    if act is not None:
        workers = torch.where(act, workers, -1)
    return DispatchResult(workers=workers, q_after=q_after)


def dispatch_sequential(policy: str, key, q, mu_hat, mu_true, cfg, B: int, *,
                        active=None, table: AliasTable | None = None,
                        mask: torch.Tensor | None = None) -> DispatchResult:
    """Oracle: the same probe stream, folded back after every task."""
    return dispatch(policy, key, q, mu_hat, mu_true, cfg, B, active=active,
                    fold_chunks=B, table=table, mask=mask)
