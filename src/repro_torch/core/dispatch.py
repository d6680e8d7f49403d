"""Batched dispatch engine: every policy of ``core/policies.py`` places a
batch here.

One engine call places a batch of B tasks against a queue snapshot and
returns ``(workers[B], q_after[n])``. Every random quantity is drawn up
front and never depends on the queue (``_draws``): threefry ``randint`` /
``uniform`` for the uniform and η draws, inverse-CDF (``#{cdf <= u}``)
for the μ̂- (Halo: μ-) proportional ones, or, given an amortised
``AliasTable`` built once per μ̂ refresh, Walker alias draws for the
policies in ``ALIAS_POLICIES``. PPoT's probe uniforms come from the
counter-hash stream. Every task then selects against the same snapshot
(``_select``: SQ(2), LL(2), η-greedy, or the probe itself), and the
batch's own placements fold back into the view. Sparrow water-fills its
d·B probes instead (``sparrow_select``). ``fold_chunks=C`` re-snapshots
the queue between C sub-chunks; ``C = B`` is per-task sequential placement,
kept as the oracle ``dispatch_sequential``. ``mask`` (bool[n]) restricts
every draw to active workers, and ``forced`` (i32[B]) pins slots to given
workers (the chain simulator's placement-constrained tasks). ``place`` is
the engine after its draws, for callers that hold the draws already.

Kernels: every C = 1 PPoT-SQ(2) batch goes through a kernel wrapper,
which launches the kernel on CUDA tensors and runs its plain version only
on CPU tensors.
A batch with an alias table is one launch of the keyed alias kernel (K1):
it draws the probe uniforms from the key itself, selects, and folds the
active slots into the view (a masked table gives inactive workers no mass,
so it serves masked batches too); only pinned slots are refolded here. A
CDF batch runs the fused CDF kernel or, under a slot or membership mask,
the select kernel, whose inactive slots are folded out here. A table build is
the scaling as tensor ops, then one single-block kernel for the stack
order, the pairing walk and the mask pass. C > 1 chunks select with tensor
ops, as the reference's chunk scan does, and so do the other policies,
whose draws, selections and water-filling are plain tensor ops in the
reference too. Nothing here reads a device value on the host, so a turn
that dispatches can be captured as a CUDA graph.
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


#: Policies whose μ̂-proportional probes can draw through an ``AliasTable``
#: (Halo samples from μ_true, never from the table's μ̂).
ALIAS_POLICIES = (pol.PSS, pol.PPOT_SQ2, pol.PPOT_LL2, pol.BANDIT)


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
    has μ̂ = 0 the mass is uniform over the active set. The scaling
    (``scaled_weights``) is tensor ops, so its sum order is torch's; the
    stack order, the pairing walk and the mask pass are
    ``kernel.alias_table``.
    """
    return AliasTable(*kernel.alias_table(scaled_weights(mu_hat, active), active))


def scaled_weights(mu_hat: torch.Tensor,
                   active: torch.Tensor | None = None) -> torch.Tensor:
    """The alias table's weights p (f32[n], mean 1): μ̂ (masked), or uniform
    where it has no mass, times n over its sum."""
    n = mu_hat.shape[0]
    if active is None:
        w = torch.where(mu_hat.sum() > 0, mu_hat, torch.ones_like(mu_hat))
    else:
        masked = torch.where(active, mu_hat, 0.0)
        fallback = torch.where(active.any(), active.to(mu_hat.dtype),
                               torch.ones_like(mu_hat))
        w = torch.where(masked.sum() > 0, masked, fallback)
    s = w.sum()
    return (w * (torch.full_like(s, n) / s)).to(torch.float32)


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


def within_batch_rank_ref(workers: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """O(B²) all-pairs form of ``within_batch_rank`` (tests only)."""
    B = workers.shape[0]
    idx = torch.arange(B, device=workers.device)
    before = idx[None, :] < idx[:, None]
    same = (workers[None, :] == workers[:, None]) & active[None, :] & before
    return same.sum(1, dtype=torch.int32)


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


def _draws(policy: str, key, B: int, n: int, cfg: pol.PolicyConfig, mu_hat, mu_true,
           *, need_j: bool = True, table: AliasTable | None = None,
           mask: torch.Tensor | None = None) -> dict:
    """Every random quantity the policy needs for B tasks, each [B] with the
    batch axis leading (so the chunked path re-chunks it without drawing
    again). The key use is the reference's, draw for draw.

    A ``table`` is used only by ``ALIAS_POLICIES`` and ignored by the
    others; it must already carry ``mask``. Under ``mask`` uniform draws map
    through the active workers (``active_choice``) and proportional draws
    sample a masked CDF. Without ``need_j``, PPoT-SQ(2) keeps the CDF and
    its counter-hash pair (u1, u2) for the CDF kernels; an alias batch
    draws nothing here, as K1 draws ``prng.uniform_quad(key, B)`` itself
    (``_dispatch_batch``)."""
    dev = mu_hat.device
    d: dict[str, torch.Tensor] = {}
    if table is not None and policy not in ALIAS_POLICIES:
        table = None

    def cdf_of(mu):
        return ref.make_cdf(mu) if mask is None else masked_cdf(mu, mask)

    def uni_workers(k, shape):
        if mask is None:
            return prng.randint(k, shape, 0, n, dev)
        return active_choice(mask, prng.uniform(k, shape, dev))

    def one_probe(k, mu):  # PSS and Halo: one proportional probe, threefry u
        if table is not None:
            u, _, v, _ = prng.uniform_quad(k, B, dev)
            return alias_sample(table, u, v)
        return inverse_cdf_sample(cdf_of(mu), prng.uniform(k, B, dev))

    def two_probes(k):  # the PPoT pair, counter-hash u
        if table is not None:
            u1, u2, v1, v2 = prng.uniform_quad(k, B, dev)
            return alias_sample(table, u1, v1), alias_sample(table, u2, v2)
        cdf = cdf_of(mu_hat)
        u1, u2 = prng.uniform_pair(k, B, dev)
        return inverse_cdf_sample(cdf, u1), inverse_cdf_sample(cdf, u2)

    if policy == pol.UNIFORM:
        d["j_uni"] = uni_workers(key, (B,))
    elif policy == pol.POT:
        d["j1"], d["j2"] = uni_workers(key, (2, B))
    elif policy == pol.PSS:
        d["j1"] = one_probe(key, mu_hat)
    elif policy == pol.HALO:
        d["j1"] = one_probe(key, mu_true)
    elif policy == pol.PPOT_SQ2 and not need_j:
        d["cdf"] = cdf_of(mu_hat)
        d["u1"], d["u2"] = prng.uniform_pair(key, B, dev)
    elif policy in (pol.PPOT_SQ2, pol.PPOT_LL2):
        d["j1"], d["j2"] = two_probes(key)
    elif policy == pol.BANDIT:
        k1, k3, k4 = prng.split(key, 3)
        d["j1"], d["j2"] = two_probes(k1)
        d["explore"] = prng.uniform(k3, B, dev) < pol.eta_f32(cfg)
        d["j_uni"] = uni_workers(k4, (B,))
    elif policy == pol.SPARROW:
        d["probes"] = uni_workers(key, (max(int(cfg.sparrow_d) * B, B),))
    else:
        raise ValueError(f"unknown policy {policy!r}; choose from {pol.ALL_POLICIES}")
    return d


def _shorter(q_view, j1, j2):
    return torch.where(q_view[j1.long()] <= q_view[j2.long()], j1, j2)


def _select(policy: str, q_view, d: dict, mu_hat) -> torch.Tensor:
    """One worker per task of the (sub-)batch against ``q_view``."""
    if policy == pol.UNIFORM:
        return d["j_uni"]
    if policy in (pol.PSS, pol.HALO):
        return d["j1"]
    if policy in (pol.POT, pol.PPOT_SQ2):
        return _shorter(q_view, d["j1"], d["j2"])
    if policy == pol.PPOT_LL2:
        j1, j2 = d["j1"].long(), d["j2"].long()
        return torch.where(pol.ll2_wait(q_view, mu_hat, j1)
                           <= pol.ll2_wait(q_view, mu_hat, j2), d["j1"], d["j2"])
    if policy == pol.BANDIT:
        return torch.where(d["explore"], d["j_uni"], _shorter(q_view, d["j1"], d["j2"]))
    raise ValueError(f"no snapshot selection for policy {policy!r}")


#: A load above any queue: unprobed workers, and Sparrow's padding slots.
_INF = 2**30


def repeat_to(values: torch.Tensor, repeats: torch.Tensor, total: int) -> torch.Tensor:
    """``jnp.repeat(values, repeats, total_repeat_length=total)``: each value
    ``repeats`` times; slots past the repeats' sum take the LAST value
    (even one repeated 0 times), and a sum above ``total`` is cut. Slot i
    takes value ``min(#{k : cumsum(repeats)[k] <= i}, len - 1)``."""
    ends = torch.cumsum(repeats, 0, dtype=torch.int64)
    i = torch.arange(total, dtype=torch.int64, device=values.device)
    return values[torch.searchsorted(ends, i, right=True).clamp(max=values.shape[0] - 1)]


def _lexsort2(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((minor, major))``: order by major, ties by minor, ties
    of both by index (two stable sorts)."""
    by_minor = torch.sort(minor, stable=True).indices
    return by_minor[torch.sort(major[by_minor], stable=True).indices]


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, as a gather: indexing with a 0-d tensor
    would read it on the host."""
    return x.gather(0, i.reshape(1).long()).reshape(())


def sparrow_select(q_view: torch.Tensor, probes: torch.Tensor, B: int,
                   m: torch.Tensor | None = None) -> torch.Tensor:
    """Sparrow batch sampling with late binding, in closed form.

    The semantics is the greedy loop: ``m`` times, place a task on the
    least-loaded probed worker (ties to the earliest probe position) and
    fold it back. Greedy water-fills: the probed workers sorted by (load,
    first probe) join the fill while levelling the earlier ones up to their
    load fits in m (k* of them, at level λ0); the rest of m splits into
    full rounds and a remainder to the earliest-probed participants; the
    placements sorted by (load at placement, first probe) are the greedy
    order, slot for slot. ``m`` (i32 0-d tensor, at most B) stays on the
    device; slots from m on are padding. Returns i32[B]."""
    n, P = q_view.shape[0], probes.shape[0]
    dev = q_view.device
    i32 = torch.int32
    if m is None:
        m = torch.full((), B, dtype=i32, device=dev)
    fp = torch.full((n,), P, dtype=i32, device=dev).scatter_reduce(
        0, probes.long(), torch.arange(P, dtype=i32, device=dev), "amin")
    loads = torch.where(fp < P, q_view.to(i32), _INF)
    order = _lexsort2(fp, loads)
    s, ws, fps = loads[order], order.to(i32), fp[order]
    s_fin = torch.where(s < _INF, s, 0)
    Sx = torch.cat([s_fin.new_zeros(1), torch.cumsum(s_fin, 0, dtype=i32)])
    k_idx = torch.arange(1, n, dtype=i32, device=dev)
    joins = (s[1:] < _INF) & (k_idx * s_fin[1:] - Sx[1:n] <= m)
    k_star = 1 + joins.sum(dtype=i32)
    lam0 = _at(s_fin, k_star - 1)
    spent = k_star * lam0 - _at(Sx, k_star)
    full = torch.div(m - spent, k_star, rounding_mode="floor")
    rem = (m - spent) - full * k_star
    part = torch.arange(n, device=dev) < k_star
    fp_rank = torch.argsort(torch.argsort(torch.where(part, fps, _INF), stable=True),
                            stable=True)
    alloc = torch.where(part, (lam0 - s_fin) + full + (fp_rank < rem).to(i32), 0).to(i32)
    astart = torch.cumsum(alloc, 0, dtype=i32) - alloc
    wexp, sexp, fpexp, stexp = (repeat_to(a, alloc, B) for a in (ws, s_fin, fps, astart))
    slot = torch.arange(B, dtype=i32, device=dev)
    v = torch.where(slot < m, sexp + (slot - stexp), _INF)  # load at placement
    return wexp[_lexsort2(fpexp, v)]


def dispatch(
    policy: str,
    key: prng.Key,
    q: torch.Tensor,  # i32[n] queue snapshot
    mu_hat: torch.Tensor,  # f32[n] learner estimates
    mu_true: torch.Tensor,  # f32[n] ground truth (only Halo reads it)
    cfg: pol.PolicyConfig,
    B: int,
    *,
    active: torch.Tensor | None = None,  # bool[B]; inactive slots place nothing
    forced: torch.Tensor | None = None,  # i32[B]; >= 0 pins the slot to that worker
    fold_chunks: int = 1,
    table: AliasTable | None = None,  # alias table built from THIS mu_hat
    mask: torch.Tensor | None = None,  # bool[n] membership
) -> DispatchResult:
    """Place ``B`` tasks in one engine call; see the module docstring.
    Sparrow ignores ``fold_chunks`` (water-filling already folds every
    placement back) and ``table``. ``forced`` pins are the caller's
    contract (pin to active workers); see ``place``."""
    n = q.shape[0]
    if policy == pol.SPARROW:
        d = _draws(policy, key, B, n, cfg, mu_hat, mu_true, mask=mask)
        return place(policy, d, q, mu_hat, B, active=active, forced=forced)
    C, Bp = _chunking(B, fold_chunks)
    if C == 1 and policy == pol.PPOT_SQ2:
        return _dispatch_batch(key, B, q, mu_hat, active, forced, table, mask, cfg)
    d = _draws(policy, key, Bp, n, cfg, mu_hat, mu_true, table=table, mask=mask)
    return place(policy, d, q, mu_hat, B, active=active, forced=forced,
                 fold_chunks=fold_chunks)


def place(policy: str, d: dict, q: torch.Tensor, mu_hat: torch.Tensor, B: int, *,
          active: torch.Tensor | None = None, forced: torch.Tensor | None = None,
          fold_chunks: int = 1) -> DispatchResult:
    """The engine after its draws: ``d`` as ``_draws`` makes it for the
    padded batch (probes, or j1/j2/j_uni/explore), selected with tensor ops.

    A slot whose ``forced`` entry is >= 0 takes that worker instead of its
    selection, and the pin folds back into the view that later chunks see
    like any other placement. Sparrow folds the active pins into the fill's
    snapshot first and water-fills the other active slots around them."""
    dev = q.device
    if policy == pol.SPARROW:
        act = torch.ones(B, dtype=torch.bool, device=dev) if active is None else active
        pin = torch.zeros_like(act) if forced is None else (forced >= 0) & act
        q_fill = q if forced is None else q + fold_counts(q, forced.clamp(min=0), pin)
        unpinned = act & ~pin
        seq = sparrow_select(q_fill, d["probes"], B, unpinned.sum(dtype=torch.int32))
        slot_rank = torch.cumsum(unpinned.to(torch.int32), 0, dtype=torch.int32) - 1
        workers = seq[slot_rank.clamp(0, B - 1).long()]
        if forced is not None:
            workers = torch.where(pin, forced, workers)
        return _fold(q, workers, act)
    C, Bp = _chunking(B, fold_chunks)
    act, pins = active, forced
    if Bp != B:
        pad = torch.zeros(Bp - B, dtype=torch.bool, device=dev)
        head = torch.ones(B, dtype=torch.bool, device=dev) if act is None else act
        act = torch.cat([head, pad])
        if pins is not None:
            pins = torch.cat([pins, pins.new_full((Bp - B,), -1)])
    if C == 1:
        workers = _select(policy, q, d, mu_hat)
        if pins is not None:
            workers = torch.where(pins >= 0, pins, workers)
        return _fold(q, workers, act)
    chunks = {name: v.view(C, -1) for name, v in d.items()}
    acts = (torch.ones(Bp, dtype=torch.bool, device=dev) if act is None else act).view(C, -1)
    pin_chunks = None if pins is None else pins.view(C, -1)
    qv, ws = q, []
    for c in range(C):  # re-snapshot the queue after every chunk
        w = _select(policy, qv, {name: v[c] for name, v in chunks.items()}, mu_hat)
        if pin_chunks is not None:
            w = torch.where(pin_chunks[c] >= 0, pin_chunks[c], w)
        qv = qv + fold_counts(qv, w, acts[c])
        ws.append(w)
    workers = torch.cat(ws)[:B].to(torch.int32)
    return _fold(q, workers, None if act is None else act[:B])


def _dispatch_batch(key, B: int, q, mu_hat, active, forced, table, mask,
                    cfg) -> DispatchResult:
    """PPoT-SQ(2) at C = 1: one snapshot for the whole batch, through the
    kernel wrappers. With a table, K1 draws its uniforms from ``key`` and
    folds the active slots. Pinned slots take their pins after the
    selection, so a batch with pins, or a CDF kernel's batch under a slot
    or membership mask, is folded here."""
    if table is not None:
        workers, q_after = kernel.ppot_dispatch_fused_alias_keyed(
            table.prob, table.alias, q, key, B, active)
        if forced is None:
            return DispatchResult(workers=workers, q_after=q_after)
        return _fold(q, torch.where(forced >= 0, forced, workers), active)
    d = _draws(pol.PPOT_SQ2, key, B, q.shape[0], cfg, mu_hat, mu_hat, need_j=False,
               mask=mask)
    if active is None and mask is None and forced is None:
        return DispatchResult(*kernel.ppot_dispatch_fused(d["cdf"], q, d["u1"], d["u2"]))
    workers = kernel.ppot_dispatch(d["cdf"], q, d["u1"], d["u2"])
    if forced is not None:
        workers = torch.where(forced >= 0, forced, workers)
    return _fold(q, workers, active)


def _fold(q, workers, act) -> DispatchResult:
    """The batch's placements folded into q; inactive slots place nothing
    and report worker -1."""
    workers = workers.to(torch.int32)
    q_after = q + fold_counts(q, workers, act)
    if act is not None:
        workers = torch.where(act, workers, -1)
    return DispatchResult(workers=workers, q_after=q_after)


def dispatch_sequential(policy: str, key, q, mu_hat, mu_true, cfg, B: int, *,
                        active=None, forced=None, table: AliasTable | None = None,
                        mask: torch.Tensor | None = None) -> DispatchResult:
    """Oracle: the same draws, folded back after every task."""
    return dispatch(policy, key, q, mu_hat, mu_true, cfg, B, active=active,
                    forced=forced, fold_chunks=B, table=table, mask=mask)
