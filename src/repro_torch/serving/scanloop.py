"""The one-program serving loop: the closed-loop serving simulation with
every turn on the device.

``run_simulation`` (``serving/router.py``) moves each arrival batch as
arrays, but its loop is Python: every turn pays some 215 kernel launches,
a host-side pass over the pending completions and a device-to-host copy.
This module keeps everything that loop keeps in Python state in device
tensors of fixed size, the carry:

  * the router state (queue view, learner rings, λ̂ EMA, key, fake-job
    clock), in the device forms of ``core.scheduler.serve_step_device``;
  * the in-flight completions: ``pend_cap`` slots of done and start time
    (f64), replica, insertion sequence and validity. Each turn flushes the
    ``comp_cap`` oldest due completions in (done time, insertion) order,
    the host loop's stable sort;
  * the replica pool (``free_at`` per replica, f64). The turn's submission
    chain is one launch of the pool-chain kernel (``pool_turn``), which
    assembles the turn's submissions and runs ``SimulatedPool.submit``'s
    recurrence ``start = max(arrival, free_at); done = start + cost/μ``
    step for step (the host side pairs with ``SequentialPool`` for exact
    parity); ``chain_max`` keeps the most submissions one replica took in
    a turn (``info["longest_chain"]``).

A turn reads its row of the workload (arrival times, costs, speeds, and
with churn the membership columns) from a chunk of rows on the device and
writes its row of results (responses f64[k], the μ̂ sample f32[n]). On
CUDA the turn is captured once as a ``torch.cuda.CUDAGraph`` and replayed
once per turn; on the CPU the same step runs eagerly. A chunk is one
host-to-device copy of its rows, one replay per turn and one copy back;
the carry stays on the device across chunks, so a chunked run is the
composition of its turns, bit-equal to an unchunked one.

The turn places with the router's policy, any of ``core.policies``; the
configuration (and so the captured graph) is one per policy, as the
reference compiles one program per policy.

With fault columns (crash instants, blackout instants and durations a
turn) or a ``serving.recovery.RecoveryConfig`` the faulty turn runs
instead (``_turn_faulty``, the reference's ``_build_scan_faulty``): the
carry gains each in-flight copy's task, arrival, cost, deadline, attempt
and flags, the response min-fold over the tasks, the ledger's counters
and the turn count, and the turn walks ``run_workload_recovery``'s steps
in its order (stall, kill, timeout, flush, drain, membership, ghost sweep,
retry selection, one widened serve, speculation, deadlines, the chain
with its tail of retries and speculative copies in one ``pool_turn``
launch, the append). It is captured in a graph of its own; an inert
configuration is the plain turn's arithmetic. Its responses are the
min-fold, closed on the final carry with the host loop's epilogue.

The numpy side of the workload is drawn up front with the same
``RandomState`` call sequence as ``run_simulation``; the key stream and
the f32 math are the host loop's (``serve_step_device`` shares them with
``serve_step``), so routing is bit-identical to a ``RosellaRouter`` in its
deterministic ``async_mu=False`` mode. Event times are f64 and cross to
f32 where the host loop crosses into ``serve_turn``.

Parity (tests/test_torch_scanloop.py, tests/test_torch_faults.py):
  * against the port's host loop with ``SequentialPool`` and
    ``async_mu=False``: equal float for float on both probe streams
    (responses, μ̂ trace, ``free_at``, queue view, learner, key);
  * against the reference ``run_simulation_scan``: responses equal, μ̂
    within the learner's stated ulps, as the host loop against the
    reference's;
  * the faulty turn against the port's host recovery loop: equal float
    for float, ledger included; against the reference's faulty scan as
    the plain turn against its scan;
  * with ``SimulatedPool`` (closed-form chains, ~1e-12 apart) or once the
    capacities overflow: statistical.

Capacity overflows (more due completions in a turn than ``comp_cap``, more
in-flight work than ``pend_cap``) are counted on the device and read once
at the end; they void exactness (the host loop pre-folds overflow
instead), and ``strict_overflow`` turns them into an error.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import time
import typing

import numpy as np
import torch

from repro_torch.core import dispatch as dsp
from repro_torch.core import estimator as est
from repro_torch.core import learner as lrn
from repro_torch.core import scheduler as rs
from repro_torch.dist import straggler as strg
from repro_torch.kernels.pool_chain import kernel as pool_kernel
from repro_torch.serving import recovery as rcv
from repro_torch.serving import router as rt
from repro_torch.utils import prng

#: In-flight completion capacity of the carry (see the reference's
#: ``PEND_CAP``): 1024 clears the Fig-8/Fig-11 workloads with ~2x headroom;
#: the flush sorts it every turn.
PEND_CAP = 1024
#: Target xs footprint of one chunk when ``chunk_turns`` is auto-sized.
CHUNK_MAX_BYTES = 64 << 20
#: Turns run on a side stream before the capture (each on a zero carry).
WARMUP_TURNS = 2
_INT32_MAX = 2**31 - 1
_LEARNER = tuple(f.name for f in dataclasses.fields(lrn.LearnerState))
#: the in-flight columns of the faulty turn's carry, in its compaction order
_PEND = ("p_done", "p_start", "p_rep", "p_seq", "p_valid", "p_task", "p_arrv", "p_cost",
         "p_dead", "p_att", "p_dup", "p_learn", "p_to", "p_retry")


def _precompute_workload(arrival_rate, horizon, request_cost, speed_schedule,
                         seed, arrival_batch, speeds0):
    """Replay ``run_simulation``'s numpy RandomState call sequence up
    front: per turn, arrival gaps then request costs — identical draws,
    identical workload."""
    rng = np.random.RandomState(seed)
    t = 0.0
    sched_i = 0
    speeds = np.asarray(speeds0, float).copy()
    times_l, costs_l, speeds_l = [], [], []
    while t < horizon:
        gaps = rng.exponential(1.0 / arrival_rate, size=arrival_batch)
        times = t + np.cumsum(gaps)
        t = float(times[-1])
        if speed_schedule is not None:
            while sched_i < len(speed_schedule) and speed_schedule[sched_i][0] <= t:
                speeds = np.asarray(speed_schedule[sched_i][1], float).copy()
                sched_i += 1
        times_l.append(times)
        costs_l.append(request_cost * rng.exponential(1.0, size=arrival_batch))
        speeds_l.append(speeds.copy())
    if not times_l:
        return None
    return (np.stack(times_l), np.stack(costs_l), np.stack(speeds_l))


def auto_chunk_turns(T, k, n, *, churn=False, burst_cap=0, faulty=False,
                     pend_cap=PEND_CAP, max_bytes=None) -> int:
    """Chunk length (turns) for the chunked driver: the most turns whose xs
    rows (``8·(2k + n)`` bytes a turn, plus ``2n + 4·burst_cap`` with
    membership columns and ``24n`` with fault columns) fit ``max_bytes``
    (default ``CHUNK_MAX_BYTES``), floored at ``max(64, pend_cap // k)``
    turns and clamped to ``[1, T]``."""
    per_turn = 8 * (2 * k + n)
    if churn:
        per_turn += 2 * n + 4 * burst_cap
    if faulty:
        per_turn += 3 * 8 * n
    if max_bytes is None:
        max_bytes = CHUNK_MAX_BYTES
    cap = int(max_bytes) // max(per_turn, 1)
    floor = max(64, pend_cap // max(k, 1))
    return max(1, min(int(T), max(cap, floor))) if T > 0 else 1


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """What one captured turn is specialised to."""

    n: int
    k: int
    comp_cap: int
    pend_cap: int
    policy: str
    max_fake: int
    use_alias: bool
    fake_cost: float
    churn: bool
    burst_cap: int
    burst_cost: float
    lcfg: lrn.LearnerConfig
    #: the resolved ``serving.recovery.RecoveryConfig`` of the faulty turn
    #: (fault columns, copy lifecycle, ledger); None is the plain turn
    recovery: rcv.RecoveryConfig | None = None
    task_cap: int = 0  # faulty: the tasks the response min-fold holds


def _lexsort(keys):
    """``jnp.lexsort(keys)``: the last key primary, ties in the order of
    the keys before it and then by index, as stable sorts least
    significant key first."""
    order = torch.sort(keys[0], stable=True).indices
    for key in keys[1:]:
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def _turn(cfg: ScanConfig, c: dict, x: dict):
    """One serving turn on the carry ``c`` and the workload row ``x``, as
    the reference's scan body. Returns (new carry, resp f64[k], μ̂ sample
    f32[n]). The pool chain writes the carry's ``free_at`` and
    ``chain_max`` in place; the new carry holds everything else, and
    nothing else of the inputs is written."""
    times64, costs64, speeds64 = x["times"], x["costs"], x["speeds"]
    dev = times64.device
    P, C, k, mf = cfg.pend_cap, cfg.comp_cap, cfg.k, cfg.max_fake
    t64 = times64[-1]
    t32 = t64.float()
    p_done, p_start, p_rep, p_seq, p_valid = (
        c["p_done"], c["p_start"], c["p_rep"], c["p_seq"], c["p_valid"])

    # -- flush the due completions, oldest done first, ties in insertion
    #    order
    due = p_valid & (p_done <= t64)
    n_due = due.sum(dtype=torch.int32)
    sel = _lexsort((p_seq, torch.where(due, p_done, float("inf"))))[:C]
    rank_ok = torch.arange(C, device=dev) < n_due
    comp_w = torch.where(rank_ok, p_rep[sel], -1)
    comp_t = torch.where(rank_ok, (p_done[sel] - p_start[sel]).float(), 0.0)
    comp_now64 = torch.where(rank_ok, p_done[sel], float("-inf")).max()
    comp_now32 = torch.where(n_due > 0, comp_now64, t64).float()
    p_valid = p_valid & ~torch.zeros_like(p_valid).scatter(0, sel, rank_ok)
    over_flush = c["over_flush"] + (n_due - C).clamp(min=0)

    learner = lrn.LearnerState(**{f: c[f] for f in _LEARNER})
    if cfg.churn:
        active_t, burst_t = x["active"], x["burst"]
        # rejoining workers cold-start before this turn's fold; with no
        # rejoin the reset is the identity, so it needs no select
        learner = lrn.reset_workers(learner, x["rejoin"], t32, active_t)
    else:
        active_t, burst_t = None, torch.empty(0, dtype=torch.int32, device=dev)
    mu_tr = learner.mu_hat  # the μ̂ entering this turn, as run_simulation samples it

    arr = est.EmaArrivalState(c["arr_last"], c["arr_gap"], c["arr_count"])
    fake_js, workers, q_view, learner, arr, key = rs.serve_step_device(
        c["q_view"], learner, arr, cfg.lcfg, c["key"], comp_w, comp_t,
        (t32, c["last_fake"], comp_now32), k, cfg.policy, mf, cfg.use_alias, active_t)

    # -- the replica pool: fakes, probe bursts, then the arrival batch, in
    #    the host's submit order, assembled and chained in one launch that
    #    updates the carry's clocks in place; inactive fakes and burst pads
    #    reach no replica's clock
    sub_start, sub_done, sub_w, act, _, resp = pool_kernel.pool_turn(
        c["free_at"], speeds64, fake_js, burst_t, workers, times64, costs64,
        cfg.fake_cost, cfg.burst_cost, free_out=c["free_at"], chain_max=c["chain_max"])

    # -- append the new in-flight work: compact the survivors to the front
    #    in insertion order, then write the active submissions behind them;
    #    a write past pend_cap lands in a scratch slot that is cut off
    pkey = torch.where(p_valid, p_seq, _INT32_MAX)
    perm = torch.sort(pkey, stable=True).indices
    p_done, p_start, p_rep, p_seq, p_valid = (
        a[perm] for a in (p_done, p_start, p_rep, p_seq, p_valid))
    nv = p_valid.sum(dtype=torch.int32)
    pos = torch.cumsum(act, 0, dtype=torch.int32) - 1
    slot = torch.where(act, nv + pos, P)
    put = slot.clamp(max=P).long()

    def append(a, v):
        ext = torch.cat([a, a.new_zeros(1)])
        ext.index_put_((put,), v.to(a.dtype))
        return ext[:P]

    new = dict(
        q_view=q_view, arr_last=arr.last_time, arr_gap=arr.mean_gap,
        arr_count=arr.count, key=key, last_fake=t32,
        p_done=append(p_done, sub_done), p_start=append(p_start, sub_start),
        p_rep=append(p_rep, sub_w), p_seq=append(p_seq, c["seq_ctr"] + pos),
        p_valid=append(p_valid, torch.ones_like(act)),
        seq_ctr=c["seq_ctr"] + act.sum(dtype=torch.int32),
        over_flush=over_flush,
        over_pend=c["over_pend"] + (act & (slot >= P)).sum(dtype=torch.int32),
        **{f: getattr(learner, f) for f in _LEARNER})
    return new, resp, mu_tr




class _Copies(typing.NamedTuple):
    """A group of copies the faulty turn launches after the batch (retries
    or speculative copies): replica (-1: none placed), cost, gate, task,
    original arrival, attempt, and whether they are duplicates."""
    w: torch.Tensor
    cost: torch.Tensor
    gate: torch.Tensor
    task: torch.Tensor
    arrv: torch.Tensor
    att: torch.Tensor
    dup: bool


def _turn_faulty(cfg: ScanConfig, c: dict, x: dict):
    """The failure-semantics turn (the reference's ``_build_scan_faulty``
    body): ``serving.recovery.run_workload_recovery``'s fourteen steps in
    its order, on the carry's copy-lifecycle columns and the row's fault
    columns (kill, stall, stall_dur; +inf no event). Every f64 expression
    keeps the host loop's operand order. Retries, timeouts and
    speculation are Python branches on the configuration, so an inert one
    runs the plain turn's arithmetic. Returns (new carry, μ̂ sample
    f32[n]); the chain writes ``free_at`` and ``chain_max`` in place and
    the fold writes ``resp``, the response min-fold, in place."""
    rc = cfg.recovery
    retry_cap, spec_cap = int(rc.retry_cap), int(rc.spec_cap)
    retry_on, timeout_on = retry_cap > 0, bool(np.isfinite(rc.timeout_mult))
    mult, budget = float(rc.timeout_mult), int(rc.retry_budget)
    mu_floor, n_lut = float(rc.mu_floor), c["lut"].shape[0]
    times64, costs64, speeds64 = x["times"], x["costs"], x["speeds"]
    kill_t, stall_t, stall_d = x["kill"], x["stall"], x["stall_dur"]
    dev = times64.device
    P, C, k, mf, n = cfg.pend_cap, cfg.comp_cap, cfg.k, cfg.max_fake, cfg.n
    i32, f64, inf = torch.int32, torch.float64, float("inf")
    t64 = times64[-1]
    t32 = t64.float()
    (p_done, p_start, p_rep, p_seq, p_valid, p_task, p_arrv, p_cost, p_dead, p_att,
     p_dup, p_learn, p_to, p_retry) = (c[f] for f in _PEND)
    resp = c["resp"]
    rep = p_rep.long()
    is_real = p_task >= 0
    n_pad = resp.shape[0] - 1  # the min-fold's padding slot
    drain = torch.zeros(n, dtype=i32, device=dev)
    d = {}  # counter deltas (i64), added to ctr at the end

    # -- (2) blackout stall: copies past the stall instant take the outage
    #    on their clock and go dirty; the replica's clock shifts with them
    aff = p_valid & torch.isfinite(p_done) & (p_done > stall_t[rep])
    p_done = torch.where(aff, p_done + stall_d[rep], p_done)
    p_learn = p_learn & ~aff
    d["stalled"] = (aff & is_real).sum()
    free_at = c["free_at"]
    free_at = torch.where(free_at > stall_t, free_at + stall_d, free_at)

    # -- (3) crash kill: copies finishing after the crash are dropped;
    #    retryable real copies park as ghosts (done = +inf)
    killed = p_valid & torch.isfinite(p_done) & (p_done > kill_t[rep])
    drain.index_add_(0, rep, killed.to(i32))
    if retry_on:
        ghost = killed & is_real & ~p_dup & (p_att < budget)
    else:
        ghost = torch.zeros_like(killed)
    d["kill_real"] = (killed & is_real).sum()
    d["kill_fake"] = (killed & ~is_real).sum()
    p_learn = p_learn & ~killed
    p_done = torch.where(ghost, inf, p_done)
    p_retry = p_retry | ghost
    p_valid = p_valid & ~(killed & ~ghost)
    free_at = torch.where(free_at > kill_t, kill_t, free_at)

    # -- (4) timeout: past-deadline copies go dirty; retryable ones queue a
    #    re-dispatch
    if timeout_on:
        newly = p_valid & is_real & torch.isfinite(p_done) & (t64 > p_dead) & ~p_to
        p_to = p_to | newly
        p_learn = p_learn & ~newly
        if retry_on:
            p_retry = p_retry | (newly & ~p_dup & (p_att < budget))
        d["timeout"] = newly.sum()

    # -- (5) flush: clean completions feed the learner (oldest done first,
    #    ties in insertion order), dirty ones only drain the queue view;
    #    every real completion min-folds its task's response
    due = p_valid & (p_done <= t64)
    clean = due & p_learn
    n_clean = clean.sum(dtype=i32)
    sel = _lexsort((p_seq, torch.where(clean, p_done, inf)))[:C]
    rank_ok = torch.arange(C, device=dev) < n_clean
    comp_w = torch.where(rank_ok, p_rep[sel], -1)
    comp_t = torch.where(rank_ok, (p_done[sel] - p_start[sel]).float(), 0.0)
    comp_now64 = torch.where(rank_ok, p_done[sel], -inf).max()
    comp_now32 = torch.where(n_clean > 0, comp_now64, t64).float()
    over_flush = c["over_flush"] + (n_clean - C).clamp(min=0)
    max_clean = torch.maximum(c["max_clean"],
                              torch.where(clean, p_done - p_start, -inf).max())
    dirty = due & ~p_learn
    drain.index_add_(0, rep, dirty.to(i32))
    d["comp_dirty"] = (dirty & is_real).sum()
    dr = due & is_real
    resp.scatter_reduce_(0, torch.where(dr, p_task, n_pad).long(),
                         torch.where(dr, p_done - p_arrv, inf), "amin", include_self=True)
    d["comp_real"] = dr.sum()
    d["comp_fake"] = (due & ~is_real).sum()
    p_valid = p_valid & ~due

    # -- (6) queue-view drain for killed and dirty copies, before the serve
    q_view = (c["q_view"] - drain).clamp(min=0)

    # -- (7) membership (outage windows ride the merged mask), then the μ̂
    #    sample, as the plain turn
    learner = lrn.LearnerState(**{f: c[f] for f in _LEARNER})
    if cfg.churn:
        active_t, burst_t = x["active"], x["burst"]
        learner = lrn.reset_workers(learner, x["rejoin"], t32, active_t)
    else:
        active_t, burst_t = None, torch.empty(0, dtype=i32, device=dev)
    mu_tr = learner.mu_hat

    # -- (8) stale-ghost sweep, (9) retry selection: earliest deadline
    #    first, candidacy the primary key (with timeouts off every
    #    deadline ties at +inf)
    tclip = p_task.clamp(0, n_pad).long()
    if retry_on:
        done_elsewhere = torch.isfinite(resp[tclip])
        ghosts = p_valid & p_retry & ~torch.isfinite(p_done)
        p_valid = p_valid & ~(ghosts & done_elsewhere)
        cand = p_valid & p_retry & ~done_elsewhere
        chosen = _lexsort((p_seq, torch.where(cand, p_dead, inf), ~cand))[:retry_cap]
        okR = torch.arange(retry_cap, device=dev) < cand.sum()
        r_task = torch.where(okR, p_task[chosen], 0)
        r_arrv = torch.where(okR, p_arrv[chosen], t64)
        r_cost = torch.where(okR, p_cost[chosen], 1.0)
        r_att = torch.where(okR, p_att[chosen] + 1, 0)
        d["retry"] = okR.sum()
        ghost_sel = okR & ~torch.isfinite(p_done[chosen])
        zero = torch.zeros_like(p_valid)
        p_retry = p_retry & ~zero.scatter(0, chosen, okR)
        p_dup = p_dup | zero.scatter(0, chosen, okR & ~ghost_sel)
        p_valid = p_valid & ~zero.scatter(0, chosen, ghost_sel)

    # -- (10) one widened serve: arrivals and retry slots against the
    #    current policy, mask and μ̂
    arr = est.EmaArrivalState(c["arr_last"], c["arr_gap"], c["arr_count"])
    fake_js, workers, q_view, learner, arr, key = rs.serve_step_device(
        q_view, learner, arr, cfg.lcfg, c["key"], comp_w, comp_t,
        (t32, c["last_fake"], comp_now32), k, cfg.policy, mf, cfg.use_alias, active_t,
        k + retry_cap if retry_on else None,
        torch.cat([torch.ones(k, dtype=torch.bool, device=dev), okR]) if retry_on else None)
    wk, rw = workers[:k], workers[k:]

    # -- (11) speculative copies on the post-serve μ̂: the slowest
    #    suspected stragglers, placed by the planner's greedy fill
    mu64 = learner.mu_hat.double()
    tail = []  # the copies after the batch: retries, then speculative copies
    if retry_on:
        tail.append(_Copies(rw, r_cost, okR, r_task, r_arrv, r_att, False))
    if spec_cap > 0:
        ratio = (t64 - p_arrv) / (p_cost / mu64[rep].clamp(min=mu_floor))
        candS = (p_valid & torch.isfinite(p_done) & is_real & ~p_dup & ~p_retry
                 & ~torch.isfinite(resp[tclip]) & (ratio > rc.spec_ratio))
        chosenS = _lexsort((p_seq, torch.where(candS, -ratio, inf), ~candS))[:spec_cap]
        okS = torch.arange(spec_cap, device=dev) < candS.sum()
        p_dup = p_dup | torch.zeros_like(p_valid).scatter(0, chosenS, okS)
        mu_plan = (torch.where(active_t, learner.mu_hat, 0.0) if cfg.churn
                   else learner.mu_hat)
        spec_w = strg.speculative_workers(mu_plan, spec_cap)
        d["spec"] = okS.sum()
        q_view = q_view.index_add(0, spec_w.long(), okS.to(i32))
        tail.append(_Copies(spec_w, torch.where(okS, p_cost[chosenS], 1.0), okS,
                            torch.where(okS, p_task[chosenS], 0),
                            torch.where(okS, p_arrv[chosenS], t64),
                            torch.where(okS, p_att[chosenS], 0), True))

    # -- (12) deadlines of the new copies from the post-serve μ̂, the host
    #    loop's t + (mult * lut[att]) * cost / max(μ̂[w], floor)
    def deadline(fac, cost, w):
        return t64 + fac * cost / mu64[w.clamp(min=0).long()].clamp(min=mu_floor)

    dead_new = deadline(mult * float(rcv.backoff_lut(rc)[0]), costs64, wk)
    tail_dead = [deadline(mult * c["lut"][g.att.clamp(0, n_lut - 1).long()], g.cost, g.w)
                 for g in tail]

    # -- (13) the pool chain in one launch: fakes, probe bursts, reals, then
    #    the tail of retries and speculative copies
    tw = ({} if not tail else dict(
        tail_w=torch.cat([g.w for g in tail]).to(i32),
        tail_cost=torch.cat([g.cost for g in tail]),
        tail_gate=torch.cat([g.gate for g in tail])))
    sub_start, sub_done, sub_w, act, _, _ = pool_kernel.pool_turn(
        free_at, speeds64, fake_js, burst_t, wk, times64, costs64, cfg.fake_cost,
        cfg.burst_cost, **tw, free_out=c["free_at"], chain_max=c["chain_max"])

    # -- (14) pending append: compact the survivors in insertion order, then
    #    write the active copies with their lifecycle columns behind them
    mb = mf + burst_t.shape[0]
    sub_task = torch.cat([torch.full((mb,), -1, dtype=i32, device=dev),
                          c["turn"] * k + torch.arange(k, dtype=i32, device=dev)]
                         + [g.task.to(i32) for g in tail])
    sub_arrv = torch.cat([t64.expand(mb), times64] + [g.arrv for g in tail])
    sub_cost = torch.cat([torch.full((mf,), cfg.fake_cost, dtype=f64, device=dev),
                          torch.full((mb - mf,), cfg.burst_cost, dtype=f64, device=dev),
                          costs64] + [g.cost for g in tail])
    sub_dead = torch.cat([torch.full((mb,), inf, dtype=f64, device=dev), dead_new]
                         + tail_dead)
    sub_att = torch.cat([torch.zeros(mb + k, dtype=i32, device=dev)]
                        + [g.att.to(i32) for g in tail])
    sub_dup = torch.cat([torch.zeros(mb + k, dtype=torch.bool, device=dev)]
                        + [torch.full(g.w.shape, g.dup, dtype=torch.bool, device=dev)
                           for g in tail])
    d["launch_fake"] = act[:mb].sum()
    perm = torch.sort(torch.where(p_valid, p_seq, _INT32_MAX), stable=True).indices
    cols = [a[perm] for a in (p_done, p_start, p_rep, p_seq, p_valid, p_task, p_arrv,
                              p_cost, p_dead, p_att, p_dup, p_learn, p_to, p_retry)]
    nv = p_valid.sum(dtype=i32)
    pos = torch.cumsum(act, 0, dtype=i32) - 1
    slot = torch.where(act, nv + pos, P)
    put = slot.clamp(max=P).long()

    def append(a, v):
        ext = torch.cat([a, a.new_zeros(1)])
        ext.index_put_((put,), v.to(a.dtype))
        return ext[:P]

    M = act.shape[0]
    true, false = (torch.full((M,), b, dtype=torch.bool, device=dev) for b in (True, False))
    new_vals = (sub_done, sub_start, sub_w, c["seq_ctr"] + pos, true, sub_task, sub_arrv,
                sub_cost, sub_dead, sub_att, sub_dup, true, false, false)
    ctr = c["ctr"] + torch.stack([d[name] if name in d
                                  else torch.zeros((), dtype=torch.int64, device=dev)
                                  for name in rcv.CTR]).to(torch.int64)
    new = dict(
        q_view=q_view, arr_last=arr.last_time, arr_gap=arr.mean_gap, arr_count=arr.count,
        key=key, last_fake=t32, seq_ctr=c["seq_ctr"] + act.sum(dtype=i32),
        over_flush=over_flush,
        over_pend=c["over_pend"] + (act & (slot >= P)).sum(dtype=i32),
        ctr=ctr, max_clean=max_clean, turn=c["turn"] + 1,
        **{f: append(a, v) for f, a, v in zip(_PEND, cols, new_vals)},
        **{f: getattr(learner, f) for f in _LEARNER})
    return new, mu_tr


class _Rows:
    """Per-turn rows of several columns in one device buffer: row r of every
    column lies in bytes [r * width, (r + 1) * width), so T rows are one
    contiguous copy. ``cols`` maps a name to (dtype, shape of a row); the
    widest dtypes come first, so every column stays aligned."""

    def __init__(self, cols: dict, rows: int, device):
        order = sorted(cols, key=lambda c: -np.dtype(cols[c][0]).itemsize)
        fields, off = {}, 0
        for name in order:
            dt, shape = np.dtype(cols[name][0]), tuple(cols[name][1])
            fields[name] = (dt, shape, off)
            off += dt.itemsize * int(np.prod(shape, dtype=np.int64))
        self.width = -(-off // 8) * 8
        self.np_dtype = np.dtype({
            "names": list(fields), "formats": [(dt, s) for dt, s, _ in fields.values()],
            "offsets": [o for _, _, o in fields.values()], "itemsize": self.width})
        self.buf = torch.zeros((rows, self.width), dtype=torch.uint8, device=device)
        self.col = {}
        for name, (dt, shape, o) in fields.items():
            nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
            tdt = torch.from_numpy(np.zeros(0, dt)).dtype
            self.col[name] = self.buf[:, o:o + nbytes].view(tdt).view(rows, *shape)

    def put(self, columns: dict) -> None:
        """Copy the first T rows in from numpy columns [T, ...]: one copy."""
        T = len(next(iter(columns.values())))
        rec = np.zeros(T, self.np_dtype)
        for name, a in columns.items():
            rec[name] = a
        self.buf[:T].copy_(torch.from_numpy(rec.view(np.uint8).reshape(T, self.width)))

    def get(self, T: int) -> np.ndarray:
        """The first T rows as a numpy record array: one copy."""
        return self.buf[:T].cpu().numpy().reshape(-1).view(self.np_dtype)


class _KernelNodeParams(ctypes.Structure):
    """The driver's CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p), ("dims", ctypes.c_uint * 6),
                ("shared_bytes", ctypes.c_uint), ("params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL


def _graph_nodes(graph) -> tuple[int, dict[str, int]]:
    """A captured graph that torch kept (``keep_graph=True``), read through
    the driver: its node count, and its kernel nodes counted by the
    kernel's (mangled) name. A driver error raises."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed with CUresult {err}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    kernels: dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        params = _KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)),
                  "cuKernelGetName")
        key = name.value.decode()
        kernels[key] = kernels.get(key, 0) + 1
    return int(count.value), kernels


class TurnRunner:
    """The carry, a chunk's workload and result rows as static device
    tensors, and the turn step on them. On CUDA the step is captured once
    as a CUDA graph (``capture_s``: warm-up and capture, host clock;
    ``graph_nodes``: its node count; ``graph_kernels``: its kernel nodes
    by name, the launches of one replay) and every turn is a replay
    (``replays`` counts them); a capture error raises. On the CPU the step
    runs eagerly."""

    def __init__(self, cfg: ScanConfig, device, rows: int):
        self.cfg, self.device, self.rows = cfg, torch.device(device), rows
        n, P, cap = cfg.n, cfg.pend_cap, cfg.lcfg.ring_cap
        f32, f64, i32 = torch.float32, torch.float64, torch.int32

        def z(shape, dt, fill=0):
            return torch.full(shape, fill, dtype=dt, device=self.device)

        self.carry = dict(
            q_view=z((n,), i32), samples=z((n, cap), f32), stamps=z((n, cap), f32),
            widx=z((n,), i32), count=z((n,), i32), epoch_start=z((n,), f32),
            mu_hat=z((n,), f32, 1.0), arr_last=z((), f32), arr_gap=z((), f32),
            arr_count=z((), i32), key=z((2,), torch.int64), last_fake=z((), f32),
            free_at=z((n,), f64), chain_max=z((), i32), p_done=z((P,), f64, float("inf")),
            p_start=z((P,), f64), p_rep=z((P,), i32), p_seq=z((P,), i32),
            p_valid=z((P,), torch.bool), seq_ctr=z((), i32), over_flush=z((), i32),
            over_pend=z((), i32))
        self.faulty = cfg.recovery is not None
        if self.faulty:
            self.carry.update(
                p_task=z((P,), i32, -1), p_arrv=z((P,), f64), p_cost=z((P,), f64, 1.0),
                p_dead=z((P,), f64, float("inf")), p_att=z((P,), i32),
                p_dup=z((P,), torch.bool), p_learn=z((P,), torch.bool, True),
                p_to=z((P,), torch.bool), p_retry=z((P,), torch.bool),
                resp=z((cfg.task_cap + 1,), f64, float("inf")),
                ctr=z((rcv.NCTR,), torch.int64), max_clean=z((), f64), turn=z((), i32),
                lut=torch.from_numpy(rcv.backoff_lut(cfg.recovery)).to(self.device))
        cols = {"times": (np.float64, (cfg.k,)), "costs": (np.float64, (cfg.k,)),
                "speeds": (np.float64, (n,))}
        if cfg.churn:
            cols.update(active=(np.bool_, (n,)), rejoin=(np.bool_, (n,)),
                        burst=(np.int32, (cfg.burst_cap,)))
        if self.faulty:
            cols.update(kill=(np.float64, (n,)), stall=(np.float64, (n,)),
                        stall_dur=(np.float64, (n,)))
        self.xs = _Rows(cols, rows, self.device)
        self.xs.col["speeds"].fill_(1.0)
        if cfg.churn:
            self.xs.col["active"].fill_(True)
        if self.faulty:
            self.xs.col["kill"].fill_(float("inf"))
            self.xs.col["stall"].fill_(float("inf"))
        ys = {"mu": (np.float32, (n,))}
        if not self.faulty:  # the faulty turn's responses are the min-fold
            ys["resp"] = (np.float64, (cfg.k,))
        self.ys = _Rows(ys, rows, self.device)
        self.turn = z((), torch.int64)
        self.graph = None
        self.capture_s = None
        self.graph_nodes = None
        self.graph_kernels: dict[str, int] = {}
        self.replays = 0
        if self.device.type == "cuda":
            self._capture()

    def step(self) -> None:
        """One turn: read row ``turn`` of the workload, write row ``turn`` of
        the results, update the carry in place, advance ``turn``."""
        idx = self.turn.view(1)
        x = {name: v.index_select(0, idx)[0] for name, v in self.xs.col.items()}
        if self.faulty:
            new, mu = _turn_faulty(self.cfg, self.carry, x)
        else:
            new, resp, mu = _turn(self.cfg, self.carry, x)
            self.ys.col["resp"].index_copy_(0, idx, resp[None])
        # the results first: the μ̂ sample may be a carry tensor itself
        self.ys.col["mu"].index_copy_(0, idx, mu[None])
        for name, t in new.items():
            self.carry[name].copy_(t)
        self.turn.add_(1)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_TURNS):
                self.step()
                self.turn.zero_()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            self.step()
        graph.instantiate()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        self.graph_nodes, self.graph_kernels = _graph_nodes(graph)

    def load(self, router: rt.RosellaRouter, pool: rt.SimulatedPool) -> None:
        """Copy the router's and the pool's state into the carry."""
        c = self.carry
        c["q_view"].copy_(router.q_view)
        for f in _LEARNER:
            c[f].copy_(getattr(router.learner, f))
        c["arr_last"].fill_(float(router.arr.last_time))
        c["arr_gap"].fill_(float(router.arr.mean_gap))
        c["arr_count"].fill_(int(router.arr.count))
        c["key"].copy_(prng.device_key(router.key, "cpu"))
        c["last_fake"].fill_(float(np.float32(router.last_fake_time)))
        c["free_at"].copy_(torch.from_numpy(np.asarray(pool.free_at, np.float64)))
        c["p_done"].fill_(float("inf"))
        for f in ("chain_max", "p_start", "p_rep", "p_seq", "p_valid", "seq_ctr",
                  "over_flush", "over_pend"):
            c[f].zero_()
        if self.faulty:
            for f, v in (("p_task", -1), ("p_cost", 1.0), ("p_dead", float("inf")),
                         ("p_learn", True), ("resp", float("inf"))):
                c[f].fill_(v)
            for f in ("p_arrv", "p_att", "p_dup", "p_to", "p_retry", "ctr", "max_clean",
                      "turn"):
                c[f].zero_()

    def run_chunk(self, columns: dict):
        """Run the chunk's turns (numpy columns [T, ...], T <= rows) from the
        carry; returns (resp f64[T, k], μ̂ trace f32[T, n]), resp None for
        the faulty turn (its responses are the carry's min-fold)."""
        T = len(columns["times"])
        if not 0 < T <= self.rows:
            raise ValueError(f"a chunk of {T} turns for {self.rows} rows")
        self.xs.put(columns)
        self.turn.zero_()
        for _ in range(T):
            if self.graph is None:
                self.step()
            else:
                self.graph.replay()
                self.replays += 1
        ys = self.ys.get(T)
        return (None if self.faulty else ys["resp"].copy()), ys["mu"].copy()


@functools.lru_cache(maxsize=8)
def runner(cfg: ScanConfig, device: str, rows: int) -> TurnRunner:
    """One runner (one captured graph on CUDA) per configuration, device and
    chunk size, as the reference caches one compiled program."""
    return TurnRunner(cfg, device, rows)


def scan_config(router: rt.RosellaRouter, k: int, *, churn: bool = False,
                burst_cap: int = 0, fake_cost: float = 0.25,
                burst_cost: float | None = None, pend_cap: int = PEND_CAP,
                comp_cap: int | None = None, recovery=None,
                task_cap: int = 0) -> ScanConfig:
    """The configuration a run of ``router`` at batch ``k`` captures:
    ``comp_cap`` None is min(SERVE_COMP_CAP, pend_cap), the host loop's
    padding, and is never above ``pend_cap``; a ``recovery`` config (the
    resolved one) is the faulty turn over ``task_cap`` tasks."""
    comp_cap = (min(rt.SERVE_COMP_CAP, pend_cap) if comp_cap is None
                else min(int(comp_cap), pend_cap))
    return ScanConfig(
        n=router.n, k=k, comp_cap=comp_cap, pend_cap=pend_cap, policy=router.policy,
        max_fake=rt.MAX_FAKE, use_alias=router.use_alias, fake_cost=float(fake_cost),
        churn=churn, burst_cap=burst_cap,
        burst_cost=float(4.0 * fake_cost if burst_cost is None else burst_cost),
        lcfg=router.lcfg, recovery=recovery,
        task_cap=int(task_cap) if recovery is not None else 0)


def run_simulation_scan(
    router: rt.RosellaRouter,
    pool: rt.SimulatedPool,
    *,
    arrival_rate: float,
    horizon: float,
    request_cost: float = 1.0,
    speed_schedule: "list[tuple[float, np.ndarray]] | None" = None,
    seed: int = 0,
    arrival_batch: int = 1,
    pend_cap: int | None = PEND_CAP,
    strict_overflow: bool = True,
    chunk_turns: int | None = None,
    kill_np: np.ndarray | None = None,
    stall_np: np.ndarray | None = None,
    stall_dur_np: np.ndarray | None = None,
    recovery: rcv.RecoveryConfig | None = None,
    observe=None,
    obs_sink=None,
):
    """Drop-in for ``run_simulation`` with every turn on the device.

    ``router`` supplies the initial state and configuration (learner
    config, key, ``use_alias``, device) and ``pool`` the replica speeds;
    both are advanced to their final states on return, like the host loop.
    Semantics are the router's deterministic ``async_mu=False`` mode.
    Returns ``(response_times, mu_trace, info)``; ``info`` carries the
    overflow counters (both 0: the fixed capacities were faithful to the
    host loop), the turn count, the most submissions one replica took in a
    turn (``longest_chain``) and, on CUDA, the capture's time (0.0 where
    the graph was captured by an earlier run), the graph's node count, its
    kernel nodes by name and the replays this run issued. Fault columns
    (f64[T, n] over the precomputed turns) or ``recovery`` run the faulty
    turn, as in ``run_workload_scan``.
    """
    _not_ported(observe=observe, obs_sink=obs_sink)
    wl = _precompute_workload(arrival_rate, horizon, request_cost, speed_schedule,
                              seed, arrival_batch, pool.speeds)
    if wl is None:
        return np.empty(0), np.zeros((0, router.n)), {
            "turns": 0, "flush_overflow": 0, "pend_overflow": 0, "longest_chain": 0}
    times_np, costs_np, speeds_np = wl
    return run_workload_scan(
        router, pool, times_np, costs_np, speeds_np, fake_cost=request_cost * 0.25,
        pend_cap=pend_cap, strict_overflow=strict_overflow, chunk_turns=chunk_turns,
        kill_np=kill_np, stall_np=stall_np, stall_dur_np=stall_dur_np, recovery=recovery)


def _not_ported(**kw) -> None:
    """The reference's telemetry options: not ported yet."""
    for name, v in kw.items():
        if v is not None:
            raise NotImplementedError(
                f"{name}: the scan loop's telemetry is not ported yet (ROADMAP queue A, A5)")


def run_workload_scan(
    router: rt.RosellaRouter,
    pool: rt.SimulatedPool,
    times_np: np.ndarray,  # f64[T, k] per-turn arrival times
    costs_np: np.ndarray,  # f64[T, k] per-turn request costs
    speeds_np: np.ndarray,  # f64[T, n] replica speeds entering each turn
    *,
    active_np: np.ndarray | None = None,  # bool[T, n] membership per turn
    rejoin_np: np.ndarray | None = None,  # bool[T, n] offline→online edges
    burst_np: np.ndarray | None = None,  # i32[T, Bc] probe-burst targets (-1 pad)
    fake_cost: float = 0.25,
    burst_cost: float | None = None,  # default 4 × fake_cost, the full request cost
    kill_np: np.ndarray | None = None,  # f64[T, n] crash instants (+inf none)
    stall_np: np.ndarray | None = None,  # f64[T, n] blackout instants (+inf none)
    stall_dur_np: np.ndarray | None = None,  # f64[T, n] blackout durations
    recovery: rcv.RecoveryConfig | None = None,  # the faulty turn, also
    # without fault columns (timeouts, retries against slow workers)
    pend_cap: int | None = None,  # None: the total-submission bound, clamped to
    # [PEND_CAP, 65536]; the cap does not change results absent overflow
    strict_overflow: bool = True,
    chunk_turns: int | None = None,  # None: ``auto_chunk_turns``
    chunk_max_bytes: int | None = None,
    comp_cap: int | None = None,  # None: min(SERVE_COMP_CAP, pend_cap)
    observe=None,
    obs_sink=None,
):
    """Run a pre-materialised workload with every turn on the device: the
    environment engine's entry point, as the reference's.

    With the membership columns the churn turn runs: the active mask
    restricts every draw, rejoin edges cold-start the learner in the
    carry, and each turn's probe bursts (``burst_np`` worker ids, -1
    padded) submit at ``burst_cost``. A router that already carries a
    membership mask runs it as a constant column.

    With fault columns (``kill_np``, ``stall_np``, ``stall_dur_np`` from
    ``Scenario.compile_serving``) or a ``recovery`` config the faulty turn
    runs (``_turn_faulty``): crash kills, blackout stalls, timeouts, retry
    re-dispatch and speculative copies, float for float against
    ``env.run_workload`` with the same config. Its responses are
    task-indexed with NaN for a lost task, and ``info["ledger"]`` is the
    conservation ledger. Returns ``(response_times, mu_trace, info)`` as
    ``run_simulation_scan``."""
    _not_ported(observe=observe, obs_sink=obs_sink)
    T, k = times_np.shape
    n = router.n
    faulty = kill_np is not None or stall_np is not None or recovery is not None
    rc = (recovery if recovery is not None else rcv.INERT_RECOVERY) if faulty else None
    if active_np is None and router.active is not None:
        active_np = np.broadcast_to(router.active.cpu().numpy(), (T, n)).copy()
    churn = active_np is not None
    burst_cap = int(burst_np.shape[1]) if churn and burst_np is not None else 0
    if burst_cost is None:
        burst_cost = 4.0 * fake_cost
    if pend_cap is None:
        per_turn = rt.MAX_FAKE + burst_cap + k + (rc.retry_cap + rc.spec_cap if faulty else 0)
        need = max(PEND_CAP, T * per_turn)
        pend_cap = PEND_CAP
        while pend_cap < need and pend_cap < 65536:
            pend_cap <<= 1
    cols = dict(times=np.asarray(times_np, np.float64),
                costs=np.asarray(costs_np, np.float64),
                speeds=np.asarray(speeds_np, np.float64))
    if churn:
        cols.update(
            active=np.asarray(active_np, bool),
            rejoin=(np.zeros((T, n), bool) if rejoin_np is None
                    else np.asarray(rejoin_np, bool)),
            burst=(np.zeros((T, 0), np.int32) if burst_np is None
                   else np.asarray(burst_np, np.int32)))
    if faulty:
        cols.update(
            kill=np.full((T, n), np.inf) if kill_np is None else np.asarray(kill_np, np.float64),
            stall=(np.full((T, n), np.inf) if stall_np is None
                   else np.asarray(stall_np, np.float64)),
            stall_dur=(np.zeros((T, n)) if stall_dur_np is None
                       else np.asarray(stall_dur_np, np.float64)))
    if chunk_turns is None:
        chunk_turns = auto_chunk_turns(T, k, n, churn=churn, burst_cap=burst_cap,
                                       faulty=faulty, pend_cap=pend_cap,
                                       max_bytes=chunk_max_bytes)
    step = max(int(chunk_turns), 1)
    chunks = ({name: a[s:s + step] for name, a in cols.items()}
              for s in range(0, T, step))
    return _drive_scan(router, pool, chunks, rows=min(step, T), k=k, churn=churn,
                       burst_cap=burst_cap, fake_cost=fake_cost,
                       burst_cost=float(burst_cost), pend_cap=pend_cap,
                       comp_cap=comp_cap, strict_overflow=strict_overflow, recovery=rc,
                       task_cap=T * k)


def _drive_scan(router: rt.RosellaRouter, pool: rt.SimulatedPool, chunks, *,
                rows: int, k: int, churn: bool, burst_cap: int, fake_cost: float,
                burst_cost: float, pend_cap: int, comp_cap: int | None,
                strict_overflow: bool, recovery=None, task_cap: int = 0):
    """The chunk driver: load the carry from the router and the pool, run
    each chunk ({column: numpy [t, ...]}, t <= rows) from the carry left by
    the last, read the overflow counters once, and write the final state
    back to the router and the pool. With ``recovery`` (the resolved
    config) the faulty turn runs over at most ``task_cap`` tasks, and the
    books close on the final carry with the host loop's epilogue
    (``drain_pending``, ``build_ledger``)."""
    cfg = scan_config(router, k, churn=churn, burst_cap=burst_cap, fake_cost=fake_cost,
                      burst_cost=burst_cost, pend_cap=pend_cap, comp_cap=comp_cap,
                      recovery=recovery, task_cap=task_cap)
    run = runner(cfg, str(router.device), rows)
    replays0 = run.replays
    run.load(router, pool)
    resp_l, mu_l = [], []
    active_last = None
    turns = 0
    for chunk in chunks:
        c_turns = len(chunk["times"])
        if recovery is not None and (turns + c_turns) * k > task_cap:
            raise RuntimeError(
                f"stream exceeded task_cap={task_cap}: a chunk would bring the launched-"
                f"task count to {(turns + c_turns) * k}; size task_cap to the stream's "
                f"total turns x k")
        turns += c_turns
        resp, mu = run.run_chunk(chunk)
        resp_l.append(resp)
        mu_l.append(mu)
        if churn:
            active_last = chunk["active"][-1]
    c = run.carry
    info = {"turns": sum(len(m) for m in mu_l),
            "flush_overflow": int(c["over_flush"].item()),
            "pend_overflow": int(c["over_pend"].item()),
            "longest_chain": int(c["chain_max"].item()),
            "capture_s": run.capture_s if replays0 == 0 else 0.0,
            "graph_nodes": run.graph_nodes,
            "graph_kernels": dict(run.graph_kernels), "replays": run.replays - replays0}
    mu_trace = np.concatenate(mu_l) if mu_l else np.zeros((0, router.n), np.float32)
    if recovery is not None:
        # the response min-fold rides the carry (a task's copies may finish
        # many turns after it arrived): close the books as the host loop does
        n_tasks = turns * k
        valid = c["p_valid"].cpu().numpy()
        resp = c["resp"].cpu().numpy()[:n_tasks].copy()
        ctr = c["ctr"].cpu().numpy().copy()
        rcv.drain_pending(resp, ctr, c["p_done"].cpu().numpy()[valid],
                          c["p_task"].cpu().numpy()[valid], c["p_arrv"].cpu().numpy()[valid])
        resp, info["ledger"] = rcv.build_ledger(resp, ctr, n_tasks,
                                                float(c["max_clean"].item()))
    else:
        resp = np.concatenate(resp_l).reshape(-1) if resp_l else np.empty(0)

    router.q_view = c["q_view"].clone()
    router.learner = lrn.LearnerState(**{f: c[f].clone() for f in _LEARNER})
    router.arr = est.to_host(est.EmaArrivalState(c["arr_last"], c["arr_gap"],
                                                 c["arr_count"]))
    router.key = prng.host_key(c["key"])
    router.last_fake_time = float(c["last_fake"].item())
    router.mu_front = router.learner.mu_hat
    router._mu_pending = None
    pool.free_at = c["free_at"].cpu().numpy().copy()
    if active_last is not None:
        router.active = torch.from_numpy(np.array(active_last, bool)).to(router.device)
    if router.use_alias:
        router.table_front = dsp.build_alias_table(router.mu_front, router.active)
    if strict_overflow and (info["flush_overflow"] or info["pend_overflow"]):
        raise RuntimeError(
            f"scan capacities overflowed (flush_overflow={info['flush_overflow']}, "
            f"pend_overflow={info['pend_overflow']}): results silently dropped work. "
            f"Raise pend_cap (current {pend_cap}; pend_cap=None auto-sizes to the "
            f"total-submission bound) or pass strict_overflow=False to inspect the "
            f"counters.")
    return resp, mu_trace, info
