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

With an ``obs.ObserveConfig`` either turn folds the windowed telemetry
(``obs.windows.observe_turn``, with the regime detector when configured)
after its serve step, inside the same graph: the telemetry state rides the
carry in four packed tensors, each turn's row gains the post-fold window
state and the boundary flag, and ``_drive_scan`` turns a chunk's boundary
rows into records after its one copy back. ``observe=None`` captures the
turn node for node as without telemetry.

The frontend fleet (``run_fleet_workload_scan``, ``run_fleet_simulation_scan``,
the reference's one-program fleet) runs ``_fleet_turn``:
S frontends, each a full router state on a leading axis of the carry, own
contiguous k / S slices of each batch and reconcile every ``sync_every``
turns; their submissions share one pending set (tagged with the placing
frontend, to which each completion returns) and one replica chain. The
reference's conditionals (the sync round, a membership change that rebuilds
frozen alias tables) are known on the host before each turn, so each
pattern is captured as a graph of its own (``FleetRunner``) and the turn
replays the graph of its pattern. With ``mesh=`` (a ``fleet.sync.FrontendMesh``,
one process a rank) each rank serves its own frontend rows, the sync rounds
are the mesh's collectives and the turn's placements are gathered for the
shared pool; the collectives are captured in the graphs with the rest.

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
from repro_torch.fleet import conflict as cfl
from repro_torch.fleet import state as fst
from repro_torch.fleet import sync as fsync
from repro_torch.kernels.pool_chain import kernel as pool_kernel
from repro_torch.obs import detect as obd
from repro_torch.obs import export as oex
from repro_torch.obs import tracing as obt
from repro_torch.obs import windows as obw
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
#: the fleet carry's per-frontend fields (with the packed telemetry ``tc_*``):
#: a rank of a mesh holds its own rows of these, and the whole of the rest
_FLEET_FRONTEND_FIELDS = _LEARNER + ("q_view", "arr_last", "arr_gap", "arr_count", "key",
                                     "mu_front", "mu_pend", "herd_scale", "herd_applied",
                                     "last_fake", "tab_p", "tab_a")
#: the in-flight columns of the faulty turn's carry, in its compaction order
_PEND = ("p_done", "p_start", "p_rep", "p_seq", "p_valid", "p_task", "p_arrv", "p_cost",
         "p_dead", "p_att", "p_dup", "p_learn", "p_to", "p_retry")
#: the telemetry carry (``obs.windows.TelemetryCarry``) packed in four
#: device tensors, so a turn stacks and copies four groups, not 31 fields:
#: the histogram, the f32 scalars, the detector's f32[NSIG] vectors, and the
#: i32 scalars (with the boundary flag appended in a turn's row)
_TC_F32, _TC_DET, _TC_I32 = obw.PACK_F32, obw.PACK_DET, obw.PACK_I32


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
    #: the windowed telemetry folded every turn (``obs.ObserveConfig``); None
    #: captures the turn without it, node for node
    observe: obw.ObserveConfig | None = None
    #: each turn's placements of its arrival batch as a result row (the
    #: decision trace's source)
    emit_workers: bool = False
    #: the fleet turn (``_fleet_turn``) of S frontends, each owning k / S of
    #: the batch; 0 is the single router's turn
    S: int = 0
    sync_every: int = 1  # the fleet's sync cadence, in turns
    #: the fleet routes on its carried μ̂ views and alias tables, rebuilt
    #: only at syncs and membership changes (else on each flush's fresh μ̂)
    frozen_mu: bool = False
    herd: bool = False  # some frontend's herd-correction gain is nonzero (S > 1)


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
    f32[n], extra): ``extra`` holds the turn's ``obs.TurnObs`` under
    ``"tob"`` when the configuration observes, and the batch's placements
    under ``"workers"`` when it emits them. The pool chain writes the
    carry's ``free_at`` and ``chain_max`` in place; the new carry holds
    everything else, and nothing else of the inputs is written."""
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
    extra = {}
    if cfg.observe is not None:
        # the fold reads the post-serve state: the queue view, λ̂ and the μ̂
        # after this turn's flush (mu_tr, the μ̂ sample, is the one entering)
        extra["tob"] = obw.plain_turn_obs(
            cfg.observe, t=t32, resp=resp, arrivals_k=k, q_view=q_view,
            lam_hat=est.lam_hat_ema(arr), mu_hat=learner.mu_hat, mu_true=speeds64,
            active=active_t)
    if cfg.emit_workers:
        extra["workers"] = workers
    return new, resp, mu_tr, extra




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
    f32[n], extra), ``extra`` as ``_turn``'s (the ``obs.TurnObs`` reads the
    clean flush's copy latencies and this turn's counter deltas); the chain
    writes ``free_at`` and ``chain_max`` in place and the fold writes
    ``resp``, the response min-fold, in place."""
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
    lat = p_done - p_arrv  # a real completion's copy latency (telemetry reads it too)
    resp.scatter_reduce_(0, torch.where(dr, p_task, n_pad).long(),
                         torch.where(dr, lat, inf), "amin", include_self=True)
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
    dctr = torch.stack([d[name] if name in d
                        else torch.zeros((), dtype=torch.int64, device=dev)
                        for name in rcv.CTR]).to(torch.int64)
    ctr = c["ctr"] + dctr
    new = dict(
        q_view=q_view, arr_last=arr.last_time, arr_gap=arr.mean_gap, arr_count=arr.count,
        key=key, last_fake=t32, seq_ctr=c["seq_ctr"] + act.sum(dtype=i32),
        over_flush=over_flush,
        over_pend=c["over_pend"] + (act & (slot >= P)).sum(dtype=i32),
        ctr=ctr, max_clean=max_clean, turn=c["turn"] + 1,
        **{f: append(a, v) for f, a, v in zip(_PEND, cols, new_vals)},
        **{f: getattr(learner, f) for f in _LEARNER})
    extra = {}
    if cfg.observe is not None:
        extra["tob"] = obw.faulty_turn_obs(
            cfg.observe, t=t32, resp=lat, resp_ok=dr, arrivals_k=k, q_view=q_view,
            lam_hat=est.lam_hat_ema(arr), mu_hat=learner.mu_hat, mu_true=speeds64,
            active=active_t, dctr=dctr)
    if cfg.emit_workers:
        extra["workers"] = wk
    return new, mu_tr, extra


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


def _tc_view(c: dict) -> obw.TelemetryCarry:
    """The telemetry carry as views into its four packed groups (a field of
    the fleet's carry keeps its leading frontend axis)."""
    i32, f32, det = c["tc_i32"], c["tc_f32"], c["tc_det"]
    return obw.TelemetryCarry(
        hist=c["tc_hist"], **{f: i32[..., j] for j, f in enumerate(_TC_I32)},
        **{f: f32[..., j] for j, f in enumerate(_TC_F32)},
        **{f: det[..., j, :] for j, f in enumerate(_TC_DET)})


def _tc_pack(tc: obw.TelemetryCarry, detect: bool, flag=None) -> dict:
    """A telemetry state as the packed groups (one stack a group), the
    boundary ``flag`` appended to the i32 group of a row; the detector's
    vectors only when the detector runs (else they never move)."""
    ints = [getattr(tc, f) for f in _TC_I32]
    if flag is not None:
        ints.append(flag.to(torch.int32))
    out = {"tc_hist": tc.hist, "tc_i32": torch.stack(ints),
           "tc_f32": torch.stack([getattr(tc, f) for f in _TC_F32])}
    if detect:
        out["tc_det"] = torch.stack([getattr(tc, f) for f in _TC_DET])
    return out


def _tc_rows(ys: np.ndarray, detect: bool):
    """Result rows [T] → (TelemetryCarry of numpy [T, ...] fields, bool[T]
    boundary flags); a fleet's rows keep their frontend axis ([T, S, ...])
    and take the flag of frontend 0 (every frontend folds the same turns)."""
    i32, f32 = ys["tc_i32"], ys["tc_f32"]
    det = (ys["tc_det"] if detect
           else np.zeros(i32.shape[:-1] + (len(_TC_DET), obd.NSIG), np.float32))
    rows = obw.TelemetryCarry(
        hist=ys["tc_hist"], **{f: i32[..., j] for j, f in enumerate(_TC_I32)},
        **{f: f32[..., j] for j, f in enumerate(_TC_F32)},
        **{f: det[..., j, :] for j, f in enumerate(_TC_DET)})
    flags = i32[..., len(_TC_I32)] != 0
    return rows, flags if flags.ndim == 1 else flags[:, 0]


class TurnRunner:
    """The carry, a chunk's workload and result rows as static device
    tensors, and the turn step on them. On CUDA the step is captured once
    as a CUDA graph (``capture_s``: warm-up and capture, host clock;
    ``graph_nodes``: its node count; ``graph_kernels``: its kernel nodes
    by name, the launches of one replay) and every turn is a replay
    (``replays`` counts them); a capture error raises. On the CPU the step
    runs eagerly. With ``cfg.observe`` the carry holds the telemetry state
    (packed, ``tc_*``) and each turn's row gains the post-fold window state
    and the boundary flag; with ``emit_responses=False`` the rows hold
    nothing else."""

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
        ocfg = cfg.observe
        self.detect = ocfg is not None and ocfg.detect is not None
        if ocfg is not None:
            self.carry.update(_tc_pack(obw.init_carry(ocfg, self.device), True))
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
        ys = {}
        self.emit = ocfg is None or ocfg.emit_responses
        if self.emit:
            ys["mu"] = (np.float32, (n,))
            if not self.faulty:  # the faulty turn's responses are the min-fold
                ys["resp"] = (np.float64, (cfg.k,))
        if ocfg is not None:
            ys.update(tc_hist=(np.int32, (ocfg.hist_bins,)),
                      tc_i32=(np.int32, (len(_TC_I32) + 1,)),
                      tc_f32=(np.float32, (len(_TC_F32),)))
            if self.detect:
                ys["tc_det"] = (np.float32, (len(_TC_DET), obd.NSIG))
        if cfg.emit_workers:
            ys["workers"] = (np.int32, (cfg.k,))
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
        cfg = self.cfg
        idx = self.turn.view(1)
        x = {name: v.index_select(0, idx)[0] for name, v in self.xs.col.items()}
        row = {}
        if self.faulty:
            new, mu, extra = _turn_faulty(cfg, self.carry, x)
        else:
            new, resp, mu, extra = _turn(cfg, self.carry, x)
            if self.emit:
                row["resp"] = resp
        if self.emit:
            row["mu"] = mu
        if cfg.observe is not None:
            tc_next, obs_row, flag = obw.observe_turn(cfg.observe, _tc_view(self.carry),
                                                      extra["tob"])
            row.update(_tc_pack(obs_row, self.detect, flag))
            new.update(_tc_pack(tc_next, self.detect))
        if cfg.emit_workers:
            row["workers"] = extra["workers"].to(torch.int32)
        # the results first: the μ̂ sample (and a telemetry row) may be a
        # carry tensor itself
        for name, v in row.items():
            self.ys.col[name].index_copy_(0, idx, v[None])
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
        if self.cfg.observe is not None:
            for f, v in _tc_pack(obw.init_carry(self.cfg.observe, self.device), True).items():
                c[f].copy_(v)

    def run_rows(self, columns: dict) -> np.ndarray:
        """Run the chunk's turns (numpy columns [T, ...], T <= rows) from the
        carry; returns the T result rows as a numpy record array (one copy
        back)."""
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
        return self.ys.get(T)

    def run_chunk(self, columns: dict):
        """``run_rows``, as (resp f64[T, k], μ̂ trace f32[T, n]): resp None for
        the faulty turn (its responses are the carry's min-fold), both None
        in stream-only mode."""
        ys = self.run_rows(columns)
        if not self.emit:
            return None, None
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
                task_cap: int = 0, observe: obw.ObserveConfig | None = None,
                emit_workers: bool = False) -> ScanConfig:
    """The configuration a run of ``router`` at batch ``k`` captures:
    ``comp_cap`` None is min(SERVE_COMP_CAP, pend_cap), the host loop's
    padding, and is never above ``pend_cap``; a ``recovery`` config (the
    resolved one) is the faulty turn over ``task_cap`` tasks; ``observe``
    folds the windowed telemetry every turn; ``emit_workers`` writes each
    turn's placements to its row."""
    comp_cap = (min(rt.SERVE_COMP_CAP, pend_cap) if comp_cap is None
                else min(int(comp_cap), pend_cap))
    return ScanConfig(
        n=router.n, k=k, comp_cap=comp_cap, pend_cap=pend_cap, policy=router.policy,
        max_fake=rt.MAX_FAKE, use_alias=router.use_alias, fake_cost=float(fake_cost),
        churn=churn, burst_cap=burst_cap,
        burst_cost=float(4.0 * fake_cost if burst_cost is None else burst_cost),
        lcfg=router.lcfg, recovery=recovery,
        task_cap=int(task_cap) if recovery is not None else 0, observe=observe,
        emit_workers=bool(emit_workers))


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
    observe: obw.ObserveConfig | None = None,
    obs_sink=None,
    decisions=None,
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
    turn, as in ``run_workload_scan``; so do ``observe``, ``obs_sink`` and
    ``decisions``.
    """
    wl = _precompute_workload(arrival_rate, horizon, request_cost, speed_schedule,
                              seed, arrival_batch, pool.speeds)
    if wl is None:
        return np.empty(0), np.zeros((0, router.n)), {
            "turns": 0, "flush_overflow": 0, "pend_overflow": 0, "longest_chain": 0}
    times_np, costs_np, speeds_np = wl
    return run_workload_scan(
        router, pool, times_np, costs_np, speeds_np, fake_cost=request_cost * 0.25,
        pend_cap=pend_cap, strict_overflow=strict_overflow, chunk_turns=chunk_turns,
        kill_np=kill_np, stall_np=stall_np, stall_dur_np=stall_dur_np, recovery=recovery,
        observe=observe, obs_sink=obs_sink, decisions=decisions)


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
    observe: obw.ObserveConfig | None = None,  # in-loop telemetry: the window
    # fold every turn (read-only to the routing math: responses stay
    # bit-equal to observe=None), records in info["windows"]
    obs_sink=None,  # callable(list[record]), called once per chunk with the
    # chunk's new window records (e.g. obs.JsonlSink), and with the tail
    decisions=None,  # obs.DecisionTrace: arrivals, placements, completions
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
    ``run_simulation_scan``.

    ``observe`` (an ``obs.ObserveConfig``) folds the windowed telemetry
    inside every turn, float for float the host loops' fold, and returns
    the window records in ``info["windows"]`` (streamed to ``obs_sink`` per
    chunk); ``emit_responses=False`` drops the response and μ̂ rows from
    the turn, so only window rows come back (the faulty turn's responses,
    a carry min-fold, still return). ``decisions`` records each task's
    arrival and placement from a row of placements the turn then writes,
    and its completion at arrival + response (the faulty turn's kills,
    timeouts and retries stay inside the turn: the host loops record
    those)."""
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
                       task_cap=T * k, observe=observe, obs_sink=obs_sink,
                       decisions=decisions)


def _record_decisions(decisions, times, workers, task0: int, resp) -> None:
    """A chunk's arrivals and placements (and, given the responses, the
    completions at arrival + response) into the decision trace, in the host
    loop's order."""
    T, k = workers.shape
    for r in range(T):
        for i in range(k):
            task, t, w = task0 + r * k + i, float(times[r, i]), int(workers[r, i])
            decisions.arrive(t, task)
            decisions.place(t, task, w)
            if resp is not None:
                decisions.complete(t + float(resp[r, i]), task, w)


def _drive_scan(router: rt.RosellaRouter, pool: rt.SimulatedPool, chunks, *,
                rows: int, k: int, churn: bool, burst_cap: int, fake_cost: float,
                burst_cost: float, pend_cap: int, comp_cap: int | None,
                strict_overflow: bool, recovery=None, task_cap: int = 0,
                observe: obw.ObserveConfig | None = None, obs_sink=None, decisions=None,
                timing: bool = False):
    """The chunk driver, shared by ``run_workload_scan`` (slices of a
    materialised workload) and ``load.run_stream_scan`` (chunks generated
    as they are pulled): load the carry from the router and the pool, run
    each chunk ({column: numpy [t, ...]}, t <= rows; an empty one is
    skipped, a longer one raises) from the carry left by the last, read
    the overflow counters once, and write the final state back to the
    router and the pool. With ``recovery`` (the resolved config) the faulty
    turn runs over at most ``task_cap`` tasks, and the books close on the
    final carry with the host loop's epilogue (``drain_pending``,
    ``build_ledger``). With ``observe`` each chunk's boundary rows become
    window records after its one copy back (handed to ``obs_sink``), and
    the trailing partial window closes the stream. With ``timing`` each
    chunk's record goes to ``info["chunks"]``: its turns and requests,
    ``gen_s`` (pulling it from ``chunks``), ``run_s`` (its turns, fenced by
    a device synchronize on the card) and the process's ``rss_mb`` after
    it."""
    cfg = scan_config(router, k, churn=churn, burst_cap=burst_cap, fake_cost=fake_cost,
                      burst_cost=burst_cost, pend_cap=pend_cap, comp_cap=comp_cap,
                      recovery=recovery, task_cap=task_cap, observe=observe,
                      emit_workers=decisions is not None)
    run = runner(cfg, str(router.device), rows)
    replays0 = run.replays
    run.load(router, pool)
    resp_l, mu_l = [], []
    windows: list = []
    arrivals_l = []  # the decision trace's arrival times (faulty turn)
    chunks_meta: list = []
    active_last = None
    turns = ci = 0
    it = iter(chunks)
    while True:
        t0 = time.perf_counter()
        chunk = next(it, None)
        if chunk is None:
            break
        gen_s = time.perf_counter() - t0
        c_turns = len(chunk["times"])
        if c_turns == 0:
            continue
        if c_turns > rows:
            raise ValueError(
                f"chunk {ci} holds {c_turns} turns, more than the {rows} rows the turn "
                f"was captured for (chunk_turns, or the first chunk's length): pass "
                f"chunks no longer than the first")
        if recovery is not None and (turns + c_turns) * k > task_cap:
            raise RuntimeError(
                f"stream exceeded task_cap={task_cap}: a chunk would bring the launched-"
                f"task count to {(turns + c_turns) * k}; size task_cap to the stream's "
                f"total turns x k")
        t1 = time.perf_counter()
        with obt.step_annotation("serve_scan_chunk", ci, router.device):
            ys = run.run_rows(chunk)
        if timing:
            if run.device.type == "cuda":
                torch.cuda.synchronize(run.device)
            chunks_meta.append({"chunk": ci, "turns": c_turns, "requests": c_turns * k,
                                "gen_s": gen_s, "run_s": time.perf_counter() - t1,
                                "rss_mb": oex.rss_mb()})
        if run.emit:
            mu_l.append(ys["mu"].copy())
            if recovery is None:
                resp_l.append(ys["resp"].copy())
        if observe is not None:
            new = obw.records_from_rows(observe, *_tc_rows(ys, run.detect))
            windows.extend(new)
            if obs_sink is not None and new:
                obs_sink(new)
        if decisions is not None:
            _record_decisions(decisions, chunk["times"], ys["workers"], turns * k,
                              None if recovery is not None else ys["resp"])
            arrivals_l.append(chunk["times"])
        turns += c_turns
        ci += 1
        if churn:
            active_last = chunk["active"][-1]
    c = run.carry
    if observe is not None and turns > 0:
        tail = obw.final_partial_record(observe, _tc_view(c))
        if tail is not None:
            windows.append(tail)
            if obs_sink is not None:
                obs_sink([tail])
    info = {"turns": turns,
            "flush_overflow": int(c["over_flush"].item()),
            "pend_overflow": int(c["over_pend"].item()),
            "longest_chain": int(c["chain_max"].item()),
            "capture_s": run.capture_s if replays0 == 0 else 0.0,
            "graph_nodes": run.graph_nodes,
            "graph_kernels": dict(run.graph_kernels), "replays": run.replays - replays0}
    if observe is not None:
        info["windows"] = windows
    if timing:
        info["chunks"] = chunks_meta
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
        if decisions is not None:
            # a completed task's first completion, worker unknown: the copy
            # that finished first may be a retry or a speculative copy
            arrv = np.concatenate(arrivals_l).reshape(-1) if arrivals_l else np.empty(0)
            for task in np.nonzero(np.isfinite(resp))[0]:
                decisions.complete(arrv[task] + resp[task], int(task), -1)
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


# ---------------------------------------------------------------------------
# The one-program fleet: S frontends, the environment and the pool in one turn
# ---------------------------------------------------------------------------

def _fleet_turn(cfg: ScanConfig, c: dict, x: dict, sync: bool, rebuild: bool,
                mesh: fsync.FrontendMesh | None = None):
    """One turn of the S-frontend fleet on the carry ``c`` and the workload
    row ``x``: the reference's fleet scan body, in its order: the fault
    subset (stall, kill), the membership transition, the sync round, each
    frontend's flush from the shared pending set, the herd correction, the
    μ̂ front-buffer flips, the S serving turns, the shared replica chain,
    the pending append with each submission's frontend.

    The reference's three conditionals are host decisions here, known
    before the turn: ``sync`` (the turn index is a multiple of
    ``sync_every``) and ``rebuild`` (a membership change under frozen
    tables rebuilds every frontend's table), so each pattern is a graph of
    its own with the reference's work and no other; a rejoin's cold start
    is the identity without one, so it always runs. Returns (new carry,
    resp f64[k], μ̂ sample f32[n], extra): ``extra`` holds the placements
    i32[k] (``"workers"``), the sync's view gaps i32[S] (``"gaps"``) and,
    when the configuration observes, the per-frontend ``obs.TurnObs``
    (``"tobs"``). The chain writes ``free_at`` and ``chain_max`` in place,
    the faulty turn's fold writes ``resp``.

    With a ``mesh`` the carry's per-frontend fields hold this rank's local
    rows only (``mesh.rows``); the shared environment (the pending set, the
    pool, the sync agreement, the ledger) is whole on every rank, and every
    rank runs it alike. Each rank flushes, corrects and serves its own rows
    (``fleet.sync.make_fleet_serve_stage``, no collective), the sync round
    reconciles over the mesh (``fleet.sync.make_fleet_scan_sync``, the only
    scheduler collectives), and the turn's fake jobs and placements are
    gathered before the shared chain: the environment's data motion, the
    requests reaching the replicas. ``mesh=None`` is the stacked fleet, all
    rows local and no collective.""" 
    S, n, k, P, C, mf = cfg.S, cfg.n, cfg.k, cfg.pend_cap, cfg.comp_cap, cfg.max_fake
    kf = k // S
    r0, Sl = (0, S) if mesh is None else mesh.rows(S)
    loc = slice(r0, r0 + Sl)
    faulty = cfg.recovery is not None
    frozen_tables = cfg.frozen_mu and cfg.use_alias
    i32, inf = torch.int32, float("inf")
    times64, costs64, speeds64 = x["times"], x["costs"], x["speeds"]
    dev = times64.device
    t64 = times64[-1]
    t32 = t64.float()
    fr_ids = obw._const(tuple(range(S)), i32, dev)
    p_done, p_start, p_rep, p_seq, p_fr, p_valid = (
        c[f] for f in ("p_done", "p_start", "p_rep", "p_seq", "p_fr", "p_valid"))
    free_at = c["free_at"]
    rep = p_rep.long()
    d = {}  # the faulty turn's counter deltas

    # -- the fault subset: blackout stalls and crash kills with the loss
    #    ledger (no retry, timeout or speculation), the queue drain kept per
    #    (frontend, worker)
    if faulty:
        kill_t, stall_t, stall_d = x["kill"], x["stall"], x["stall_dur"]
        p_task, p_arrv, p_learn, resp_acc = c["p_task"], c["p_arrv"], c["p_learn"], c["resp"]
        is_real = p_task >= 0
        n_pad = resp_acc.shape[0] - 1
        cell = p_fr.long() * n + rep
        drain = torch.zeros(S * n, dtype=i32, device=dev)
        aff = p_valid & torch.isfinite(p_done) & (p_done > stall_t[rep])
        p_done = torch.where(aff, p_done + stall_d[rep], p_done)
        p_learn = p_learn & ~aff
        d["stalled"] = (aff & is_real).sum()
        free_at = torch.where(free_at > stall_t, free_at + stall_d, free_at)
        killed = p_valid & torch.isfinite(p_done) & (p_done > kill_t[rep])
        drain.index_add_(0, cell, killed.to(i32))
        d["kill_real"] = (killed & is_real).sum()
        d["kill_fake"] = (killed & ~is_real).sum()
        p_learn = p_learn & ~killed
        p_valid = p_valid & ~killed
        free_at = torch.where(free_at > kill_t, kill_t, free_at)

    # -- membership: every frontend cold-starts the rejoined workers, and a
    #    change turn flips every μ̂ front buffer (and, under frozen tables,
    #    rebuilds each masked table): no frontend can route offline after
    learners = [lrn.LearnerState(**{f: c[f][s] for f in _LEARNER}) for s in range(Sl)]
    mu_front, mu_pend = c["mu_front"], c["mu_pend"]
    tab_p, tab_a = (c["tab_p"], c["tab_a"]) if frozen_tables else (None, None)
    if cfg.churn:
        active_t, burst_t, changed = x["active"], x["burst"], x["changed"]
        learners = [lrn.reset_workers(lf, x["rejoin"], t32, active_t) for lf in learners]
        mu_now = torch.stack([lf.mu_hat for lf in learners])
        mu_front = torch.where(changed, mu_now, mu_front)
        mu_pend = mu_pend & ~changed
        if rebuild:
            tbs = [dsp.build_alias_table(mu_front[s], active_t) for s in range(Sl)]
            tab_p, tab_a = torch.stack([t.prob for t in tbs]), torch.stack([t.alias for t in tbs])
    else:
        active_t, burst_t = None, torch.empty(0, dtype=i32, device=dev)
        mu_now = torch.stack([lf.mu_hat for lf in learners])

    # -- the sync round: herd corrections unwind, per-frontend deltas sum
    #    onto the agreed snapshot, μ̂ merges, the λ̂ streams sum (a numeric
    #    no-op on the views at S = 1)
    arr = est.EmaArrivalState(c["arr_last"], c["arr_gap"], c["arr_count"])
    lam_f = est.lam_hat_ema(arr)  # f32[Sl], before the serve, as the host loop reads it
    q_view, herd_applied, q_snap = c["q_view"], c["herd_applied"], c["q_snap"]
    t_sync, lam_global = c["t_sync"], c["lam_global"]
    gaps = None
    if sync:
        global_q, mu_merged, gaps, lam_sum = fsync.make_fleet_scan_sync(mesh)(
            q_view, herd_applied, q_snap, mu_now, lam_f)
        q_view, q_snap = global_q[None].expand(Sl, n), global_q
        herd_applied = torch.zeros_like(herd_applied)
        mu_front = mu_merged[None].expand(Sl, n)
        mu_pend = torch.zeros_like(mu_pend)
        if frozen_tables:
            tb = dsp.build_alias_table(mu_merged, active_t)
            tab_p, tab_a = tb.prob[None].expand(Sl, n), tb.alias[None].expand(Sl, n)
        t_sync, lam_global = t32, lam_sum

    # -- each frontend flushes its own due completions from the shared
    #    pending set: oldest done first, ties in insertion order, all S
    #    partitions in one stable sort along the rows
    due = p_valid & (p_done <= t64)
    clean = due & p_learn if faulty else due
    fmask = clean[None, :] & (p_fr[None, :] == fr_ids[:, None])  # [S, P]
    n_due_f = fmask.sum(1, dtype=i32)
    by_seq = torch.sort(p_seq, stable=True).indices
    keyd = torch.where(fmask, p_done[None, :], inf)[:, by_seq]
    sel = by_seq[torch.sort(keyd, dim=1, stable=True).indices[:, :C]]  # [S, C]
    rank_ok = torch.arange(C, device=dev)[None, :] < n_due_f[:, None]
    comp_w = torch.where(rank_ok, p_rep[sel], -1)
    comp_t = torch.where(rank_ok, (p_done[sel] - p_start[sel]).float(), 0.0)
    comp_now64 = torch.where(rank_ok, p_done[sel], -inf).amax(1)
    comp_now32 = torch.where(n_due_f > 0, comp_now64, t64).float()
    if mesh is not None:  # every rank flushes the shared set; each serves its own rows
        comp_w, comp_t, comp_now32 = comp_w[loc], comp_t[loc], comp_now32[loc]
    over_flush = c["over_flush"] + (n_due_f - C).clamp(min=0).sum(dtype=i32)
    tobs_f = {}
    if faulty:
        # dirty completions drain their frontend's view only; every real
        # completion min-folds its task's response
        max_clean = torch.maximum(c["max_clean"],
                                  torch.where(clean, p_done - p_start, -inf).max())
        dirty = due & ~p_learn
        drain.index_add_(0, cell, dirty.to(i32))
        d["comp_dirty"] = (dirty & is_real).sum()
        dr = due & is_real
        lat = p_done - p_arrv
        resp_acc.scatter_reduce_(0, torch.where(dr, p_task, n_pad).long(),
                                 torch.where(dr, lat, inf), "amin", include_self=True)
        d["comp_real"] = dr.sum()
        d["comp_fake"] = (due & ~is_real).sum()
        if cfg.observe is not None:
            fr_l = p_fr.long()

            def per_frontend(mask):
                return torch.zeros(S, dtype=i32, device=dev).index_add_(0, fr_l, mask.to(i32))

            tobs_f = dict(killed=per_frontend(killed & is_real)[loc],
                          dirty=per_frontend(dirty & is_real)[loc],
                          completed=per_frontend(clean & is_real)[loc], lat=lat,
                          ok=(dr[None, :] & (p_fr[None, :] == fr_ids[:, None]))[loc])
        p_valid = p_valid & ~due
        q_view = (q_view - drain.view(S, n)[loc]).clamp(min=0)
    else:
        flushed = torch.zeros((S, P), dtype=torch.bool, device=dev).scatter(1, sel, rank_ok)
        p_valid = p_valid & ~flushed.any(0)

    # -- herd correction on the pre-flip μ̂: each view carries the expected
    #    peer placements since its last sync, as an increment over what it
    #    already holds (0 where a gain is 0)
    if cfg.herd:
        dt = t32 - t_sync
        extra = torch.stack([cfl.expected_peer_placements(lam_f[s], dt, mu_front[s], S)
                             for s in range(Sl)])
        want = torch.round(c["herd_scale"][:, None] * extra).to(i32)
        q_view = q_view + (want - herd_applied)
        herd_applied = want

    # -- each frontend's μ̂ front-buffer flip (a pending refresh is always
    #    its own learner's μ̂), then its serving turn
    mu_front = torch.where(mu_pend[:, None], mu_now, mu_front)
    serve = fsync.make_fleet_serve_stage(mesh, kf, cfg.policy, max_fake=mf,
                                         use_fresh_mu=not cfg.frozen_mu,
                                         use_alias=cfg.use_alias, churn=cfg.churn)
    fake_js, workers, q_view, learner, arr2, key = serve(
        q_view, learners, arr, mu_front, c["key"], comp_w, comp_t, c["last_fake"], comp_now32,
        t32, cfg.lcfg, dsp.AliasTable(tab_p, tab_a) if frozen_tables else None, active_t)
    if mesh is not None:  # every rank's fake jobs and placements, for the shared chain
        both = mesh.all_gather_rows(torch.cat([fake_js, workers], 1), "placements")
        fake_js, workers = both[:, :mf], both[:, mf:]

    # -- the shared replica chain: every frontend's fakes (frontend order),
    #    the probe burst, then all reals in global arrival order
    sub_start, sub_done, sub_w, act, _, resp = pool_kernel.pool_turn(
        free_at, speeds64, fake_js.reshape(-1), burst_t, workers.reshape(-1), times64,
        costs64, cfg.fake_cost, cfg.burst_cost, free_out=c["free_at"], chain_max=c["chain_max"])
    bc = burst_t.shape[0]
    sub_fr = obw._const(tuple(np.concatenate([
        np.repeat(np.arange(S), mf), np.arange(bc) % S, np.repeat(np.arange(S), kf)]).tolist()),
        i32, dev)

    # -- the pending append, as the single turn's, with the frontend tag
    perm = torch.sort(torch.where(p_valid, p_seq, _INT32_MAX), stable=True).indices
    names = ["p_done", "p_start", "p_rep", "p_seq", "p_fr", "p_valid"]
    cols = [p_done, p_start, p_rep, p_seq, p_fr, p_valid]
    nfb = S * mf + bc
    M = act.shape[0]
    true = torch.ones(M, dtype=torch.bool, device=dev)
    vals = [sub_done, sub_start, sub_w, None, sub_fr, true]
    if faulty:
        names += ["p_task", "p_arrv", "p_learn"]
        cols += [p_task, p_arrv, p_learn]
        vals += [torch.cat([torch.full((nfb,), -1, dtype=i32, device=dev),
                            c["turn"] * k + torch.arange(k, dtype=i32, device=dev)]),
                 torch.cat([t64.expand(nfb), times64]), true]
        d["launch_fake"] = act[:nfb].sum()
    nv = p_valid.sum(dtype=i32)
    pos = torch.cumsum(act, 0, dtype=i32) - 1
    vals[3] = c["seq_ctr"] + pos
    slot = torch.where(act, nv + pos, P)
    put = slot.clamp(max=P).long()

    def append(a, v):
        ext = torch.cat([a[perm], a.new_zeros(1)])
        ext.index_put_((put,), v.to(a.dtype))
        return ext[:P]

    new = dict(
        q_view=q_view, key=key, mu_front=mu_front, mu_pend=n_due_f[loc] > 0,
        herd_applied=herd_applied, last_fake=t32.expand(Sl), q_snap=q_snap, t_sync=t_sync,
        lam_global=lam_global, arr_last=torch.stack([a.last_time for a in arr2]),
        arr_gap=torch.stack([a.mean_gap for a in arr2]),
        arr_count=torch.stack([a.count for a in arr2]),
        seq_ctr=c["seq_ctr"] + act.sum(dtype=i32), over_flush=over_flush,
        over_pend=c["over_pend"] + (act & (slot >= P)).sum(dtype=i32),
        **{f: append(a, v) for f, a, v in zip(names, cols, vals)}, **learner)
    if frozen_tables and (sync or rebuild):
        new.update(tab_p=tab_p, tab_a=tab_a)
    if faulty:
        dctr = torch.stack([d[name] if name in d
                            else torch.zeros((), dtype=torch.int64, device=dev)
                            for name in rcv.CTR]).to(torch.int64)
        new.update(ctr=c["ctr"] + dctr, max_clean=max_clean, turn=c["turn"] + 1)
    extra = {"workers": workers.reshape(-1), "gaps": gaps}
    if cfg.observe is not None:
        lam_post = est.lam_hat_ema(est.EmaArrivalState(
            new["arr_last"], new["arr_gap"], new["arr_count"]))
        coll = obw.fleet_collisions(workers, n)
        if faulty:
            kf_t = obw._const(kf, i32, dev)
            z = obw._const(0, i32, dev)
            lat32, mu_true = tobs_f["lat"].float(), speeds64.float()
            extra["tobs"] = [obw.TurnObs(
                t=t32, resp=lat32, resp_ok=tobs_f["ok"][s], arrivals=kf_t,
                q_view=q_view[s], lam_hat=lam_post[s], mu_hat=learner["mu_hat"][s],
                mu_true=mu_true, active=active_t, launched=kf_t,
                completed=tobs_f["completed"][s], dirty=tobs_f["dirty"][s],
                killed=tobs_f["killed"][s], retried=z, collisions=coll[r0 + s])
                for s in range(Sl)]
        else:
            extra["tobs"] = [obw.plain_turn_obs(
                cfg.observe, t=t32, resp=resp.view(S, kf)[r0 + s], arrivals_k=kf,
                q_view=q_view[s], lam_hat=lam_post[s], mu_hat=learner["mu_hat"][s],
                mu_true=speeds64, active=active_t, collisions=coll[r0 + s]) for s in range(Sl)]
    return new, resp, mu_front[0], extra


def _stack_packs(packs: list[dict]) -> dict:
    return {name: torch.stack([p[name] for p in packs]) for name in packs[0]}


class FleetRunner:
    """``TurnRunner`` for the fleet turn: the carry (each frontend's fields
    with a leading axis S, the fleet's sync agreement, the shared pool and
    pending set), a chunk's workload and result rows as static device
    tensors, and the turn step on them. The turn has up to four patterns
    (sync or not, and under frozen tables with churn a membership rebuild
    or not), each captured on CUDA as a graph of its own; every turn
    replays the graph of its pattern, chosen on the host from the turn
    index and the membership column (``replays`` by pattern; ``graphs``:
    each pattern's node count and kernel nodes by name). On the CPU the
    step runs eagerly.

    With a ``mesh`` (``fleet.sync.FrontendMesh``) the runner is one rank's:
    its carry holds the rank's local frontend rows and the whole shared
    environment, its graphs hold the turn's collectives (``collectives``:
    each pattern's by kind, added to ``mesh.counts`` at each replay), and
    the μ̂ sample rows are frontend 0's, broadcast from rank 0 after each
    chunk."""

    def __init__(self, cfg: ScanConfig, device, rows: int,
                 mesh: fsync.FrontendMesh | None = None):
        self.cfg, self.device, self.rows, self.mesh = cfg, torch.device(device), rows, mesh
        n, P, cap = cfg.n, cfg.pend_cap, cfg.lcfg.ring_cap
        r0, S = (0, cfg.S) if mesh is None else mesh.rows(cfg.S)
        self.local = slice(r0, r0 + S)  # S here is the rank's row count
        f32, f64, i32, b = torch.float32, torch.float64, torch.int32, torch.bool

        def z(shape, dt, fill=0):
            return torch.full(shape, fill, dtype=dt, device=self.device)

        self.frozen_tables = cfg.frozen_mu and cfg.use_alias
        self.faulty = cfg.recovery is not None
        self.carry = dict(
            q_view=z((S, n), i32), samples=z((S, n, cap), f32), stamps=z((S, n, cap), f32),
            widx=z((S, n), i32), count=z((S, n), i32), epoch_start=z((S, n), f32),
            mu_hat=z((S, n), f32, 1.0), arr_last=z((S,), f32), arr_gap=z((S,), f32),
            arr_count=z((S,), i32), key=z((S, 2), torch.int64), mu_front=z((S, n), f32, 1.0),
            mu_pend=z((S,), b), herd_scale=z((S,), f32), herd_applied=z((S, n), i32),
            last_fake=z((S,), f32), q_snap=z((n,), i32), t_sync=z((), f32),
            lam_global=z((), f32), free_at=z((n,), f64), chain_max=z((), i32),
            p_done=z((P,), f64, float("inf")), p_start=z((P,), f64), p_rep=z((P,), i32),
            p_seq=z((P,), i32), p_fr=z((P,), i32), p_valid=z((P,), b), seq_ctr=z((), i32),
            over_flush=z((), i32), over_pend=z((), i32))
        if self.frozen_tables:
            self.carry.update(tab_p=z((S, n), f32, 1.0), tab_a=z((S, n), i32))
        if self.faulty:
            self.carry.update(
                p_task=z((P,), i32, -1), p_arrv=z((P,), f64), p_learn=z((P,), b, True),
                resp=z((cfg.task_cap + 1,), f64, float("inf")), ctr=z((rcv.NCTR,), torch.int64),
                max_clean=z((), f64), turn=z((), i32))
        ocfg = cfg.observe
        self.detect = ocfg is not None and ocfg.detect is not None
        if ocfg is not None:
            self.carry.update(_stack_packs(
                [_tc_pack(obw.init_carry(ocfg, self.device), True)] * S))
        cols = {"times": (np.float64, (cfg.k,)), "costs": (np.float64, (cfg.k,)),
                "speeds": (np.float64, (n,))}
        if cfg.churn:
            cols.update(active=(np.bool_, (n,)), rejoin=(np.bool_, (n,)),
                        changed=(np.bool_, ()), burst=(np.int32, (cfg.burst_cap,)))
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
        ys = {}
        self.emit = ocfg is None or ocfg.emit_responses
        if self.emit:
            ys.update(mu=(np.float32, (n,)), workers=(np.int32, (cfg.k,)),
                      gaps=(np.int32, (cfg.S,)))
            if not self.faulty:
                ys["resp"] = (np.float64, (cfg.k,))
        if ocfg is not None:
            ys.update(tc_hist=(np.int32, (S, ocfg.hist_bins)),
                      tc_i32=(np.int32, (S, len(_TC_I32) + 1)),
                      tc_f32=(np.float32, (S, len(_TC_F32))))
            if self.detect:
                ys["tc_det"] = (np.float32, (S, len(_TC_DET), obd.NSIG))
        self.ys = _Rows(ys, rows, self.device)
        self.turn = z((), torch.int64)
        syncs = (True,) if cfg.sync_every == 1 else (True, False)
        rebuilds = (False, True) if self.frozen_tables and cfg.churn else (False,)
        self.patterns = [(sy, rb) for sy in syncs for rb in rebuilds]
        self.graphs: dict = {}
        self.graph_nodes: dict = {}
        self.graph_kernels: dict = {}
        self.collectives: dict = {}
        self.replays = {p: 0 for p in self.patterns}
        #: the carry's per-frontend fields (leading axis: the local rows)
        self.frontend_fields = [f for f in self.carry
                                if f in _FLEET_FRONTEND_FIELDS or f.startswith("tc_")]
        self.capture_s = None
        if self.device.type == "cuda":
            self._capture()

    def step(self, pattern) -> None:
        """One turn of ``pattern`` (sync, rebuild): read row ``turn`` of the
        workload, write row ``turn`` of the results, update the carry in
        place, advance ``turn``."""
        cfg = self.cfg
        idx = self.turn.view(1)
        x = {name: v.index_select(0, idx)[0] for name, v in self.xs.col.items()}
        new, resp, mu, extra = _fleet_turn(cfg, self.carry, x, *pattern, mesh=self.mesh)
        row = {}
        if self.emit:
            row.update(mu=mu, workers=extra["workers"])
            if extra["gaps"] is not None:
                row["gaps"] = extra["gaps"]
            if not self.faulty:
                row["resp"] = resp
        if cfg.observe is not None:
            nxt, rows = [], []
            for s, tob in enumerate(extra["tobs"]):
                tc_view = _tc_view({g: self.carry[g][s] for g in ("tc_hist", "tc_i32", "tc_f32",
                                                                   "tc_det")})
                tc_next, obs_row, flag = obw.observe_turn(cfg.observe, tc_view, tob)
                rows.append(_tc_pack(obs_row, self.detect, flag))
                nxt.append(_tc_pack(tc_next, self.detect))
            row.update(_stack_packs(rows))
            new.update(_stack_packs(nxt))
        # the results first: the μ̂ sample may be a carry tensor itself; a
        # field the turn left as it was is not copied onto itself
        for name, v in row.items():
            self.ys.col[name].index_copy_(0, idx, v[None])
        for name, t in new.items():
            if t is not self.carry[name]:
                self.carry[name].copy_(t)
        self.turn.add_(1)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        counts = None if self.mesh is None else self.mesh.counts.copy()
        for pattern in self.patterns:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_TURNS):
                    self.step(pattern)
                    self.turn.zero_()
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            if self.mesh is not None:
                self.mesh.counts.clear()
            with torch.cuda.graph(graph):
                self.step(pattern)
            graph.instantiate()
            torch.cuda.synchronize(self.device)
            self.graphs[pattern] = graph
            self.graph_nodes[pattern], self.graph_kernels[pattern] = _graph_nodes(graph)
            if self.mesh is not None:
                self.collectives[pattern] = dict(self.mesh.counts)
        if self.mesh is not None:  # the warm-up turns and the captures issue no turn's
            self.mesh.counts.clear()
            self.mesh.counts.update(counts)
        self.capture_s = time.perf_counter() - t0

    def load(self, router, pool: rt.SimulatedPool) -> None:
        """Copy a ``FleetRouter``'s and the pool's state into the carry."""
        c, loc = self.carry, self.local
        fc = fst.fleet_serve_carry(router, self.device, self.frozen_tables)
        for f in _LEARNER:
            c[f].copy_(getattr(fc.learner, f)[loc])
        for f in ("q_view", "key", "mu_front", "mu_pend", "herd_scale", "herd_applied",
                  "last_fake"):
            c[f].copy_(getattr(fc, f)[loc])
        for f in ("q_snap", "t_sync", "lam_global"):
            c[f].copy_(getattr(fc, f))
        c["arr_last"].copy_(fc.arr.last_time[loc])
        c["arr_gap"].copy_(fc.arr.mean_gap[loc])
        c["arr_count"].copy_(fc.arr.count[loc])
        if self.frozen_tables:
            c["tab_p"].copy_(fc.tables.prob[loc])
            c["tab_a"].copy_(fc.tables.alias[loc])
        c["free_at"].copy_(torch.from_numpy(np.asarray(pool.free_at, np.float64)))
        c["p_done"].fill_(float("inf"))
        for f in ("chain_max", "p_start", "p_rep", "p_seq", "p_fr", "p_valid", "seq_ctr",
                  "over_flush", "over_pend"):
            c[f].zero_()
        if self.faulty:
            for f, v in (("p_task", -1), ("p_learn", True), ("resp", float("inf"))):
                c[f].fill_(v)
            for f in ("p_arrv", "ctr", "max_clean", "turn"):
                c[f].zero_()
        if self.cfg.observe is not None:
            init = _tc_pack(obw.init_carry(self.cfg.observe, self.device), True)
            for f, v in init.items():
                c[f].copy_(v[None].expand(c[f].shape))

    def pattern(self, turn: int, changed: bool):
        """The pattern of global turn ``turn``: whether it syncs, and
        whether a membership change rebuilds frozen tables."""
        return (turn % self.cfg.sync_every == 0,
                bool(changed) and self.frozen_tables and self.cfg.churn)

    def run_rows(self, columns: dict, turn0: int) -> np.ndarray:
        """Run the chunk's turns (numpy columns [T, ...], T <= rows; its first
        turn is global turn ``turn0``) from the carry; returns the T result
        rows as a numpy record array (one copy back), on a mesh as a dict of
        its columns with every frontend's rows."""
        T = len(columns["times"])
        if not 0 < T <= self.rows:
            raise ValueError(f"a chunk of {T} turns for {self.rows} rows")
        self.xs.put(columns)
        self.turn.zero_()
        changed = columns.get("changed", np.zeros(T, bool))
        for r in range(T):
            pattern = self.pattern(turn0 + r, changed[r])
            if self.graphs:
                self.graphs[pattern].replay()
                self.replays[pattern] += 1
                if self.mesh is not None:
                    self.mesh.counts.update(self.collectives[pattern])
            else:
                self.step(pattern)
        ys = self.ys.get(T)
        if self.mesh is None:
            return ys
        # on a mesh: the μ̂ sample is frontend 0's, on rank 0; the telemetry
        # rows are each rank's frontends', gathered in frontend order
        out = {name: ys[name] for name in ys.dtype.names}
        if self.emit:
            mu = self.ys.col["mu"][:T].contiguous()
            out["mu"] = self.mesh.broadcast(mu, "trace").cpu().numpy()
        for name in out:
            if name.startswith("tc_"):
                rows = self.ys.col[name][:T].transpose(0, 1).contiguous()
                out[name] = self.mesh.all_gather_rows(rows, "telemetry").transpose(
                    0, 1).cpu().numpy()
        return out

    def full_carry(self) -> dict:
        """The carry with every frontend's rows (gathered over the mesh)."""
        if self.mesh is None:
            return self.carry
        return {f: self.mesh.all_gather_rows(t, "write_back") if f in self.frontend_fields
                else t for f, t in self.carry.items()}


@functools.lru_cache(maxsize=8)
def fleet_runner(cfg: ScanConfig, device: str, rows: int,
                 mesh: fsync.FrontendMesh | None = None) -> FleetRunner:
    """One fleet runner (its patterns' graphs on CUDA) per configuration,
    device, chunk size and mesh."""
    return FleetRunner(cfg, device, rows, mesh)


def fleet_scan_config(router, k: int, *, churn: bool = False, burst_cap: int = 0,
                      fake_cost: float = 0.25, burst_cost: float | None = None,
                      pend_cap: int = PEND_CAP, faulty: bool = False, task_cap: int = 0,
                      sync_every: int = 1, frozen_mu: bool = False,
                      observe: obw.ObserveConfig | None = None) -> ScanConfig:
    """The configuration a fleet run of the ``FleetRouter`` ``router`` at
    batch ``k`` (S | k) captures: as ``scan_config`` for its frontends, plus
    S, the sync cadence, ``frozen_mu``, whether a herd gain is on, and the
    fault subset (kill and stall with the ledger, over ``task_cap`` tasks)."""
    fr = router.frontends[0]
    cfg = scan_config(fr, k, churn=churn, burst_cap=burst_cap, fake_cost=fake_cost,
                      burst_cost=burst_cost, pend_cap=pend_cap,
                      recovery=rcv.INERT_RECOVERY if faulty else None, task_cap=task_cap,
                      observe=observe)
    return dataclasses.replace(
        cfg, S=router.S, sync_every=max(int(sync_every), 1), frozen_mu=bool(frozen_mu),
        herd=bool(router.herd_scale.any()) and router.S > 1)


def run_fleet_workload_scan(
    router: rt.FleetRouter,
    pool: rt.SimulatedPool,
    times_np: np.ndarray,  # f64[T, k] per-turn arrival times, in global order
    costs_np: np.ndarray,  # f64[T, k]
    speeds_np: np.ndarray,  # f64[T, n]
    *,
    active_np: np.ndarray | None = None,  # bool[T, n] membership per turn
    rejoin_np: np.ndarray | None = None,  # bool[T, n] offline→online edges
    burst_np: np.ndarray | None = None,  # i32[T, Bc] probe-burst targets (-1 pad)
    fake_cost: float = 0.25,
    burst_cost: float | None = None,
    pend_cap: int = PEND_CAP,  # comp_cap is min(SERVE_COMP_CAP, pend_cap)
    sync_every: int = 1,
    frozen_mu: bool = False,
    chunk_turns: int | None = None,  # None: ``auto_chunk_turns``
    mesh=None,
    kill_np: np.ndarray | None = None,  # f64[T, n] crash instants (+inf none)
    stall_np: np.ndarray | None = None,  # f64[T, n] blackout instants (+inf none)
    stall_dur_np: np.ndarray | None = None,  # f64[T, n] blackout durations
    strict_overflow: bool = True,
    observe: obw.ObserveConfig | None = None,
    obs_sink=None,  # callable(list[record]), the fleet-aggregate records per chunk
):
    """The one-program fleet over a pre-materialised workload: S frontends,
    the environment and the shared pool, every turn on the device (one
    graph replay a turn on CUDA), chunked as ``run_workload_scan``.

    Frontend f owns the contiguous chunk ``[:, f·k/S, (f+1)·k/S)`` of each
    turn, so S must divide k. The kill/stall columns run the fleet's fault
    subset (crash and blackout with the loss ledger, ``info["ledger"]``;
    no timeout, retry or speculation: those are single-frontend). Under
    churn every frontend's draws are masked, rejoins cold-start every
    learner, and a change turn flips every μ̂ front buffer.

    ``frozen_mu=False`` routes each frontend on its own flush's fresh μ̂,
    as a deterministic (``async_mu=False``) ``RosellaRouter``: with a
    ``SequentialPool`` the run equals ``run_fleet_simulation`` float for
    float at any sync cadence, and at S = 1 the single-frontend scan bit
    for bit. ``frozen_mu=True`` routes on the carried μ̂ views and alias
    tables, rebuilt only at syncs and membership changes.

    ``observe`` folds each frontend's windowed telemetry every turn:
    fleet-aggregate records in ``info["windows"]`` (streamed to
    ``obs_sink``), per-frontend ones in ``info["windows_frontends"]``;
    ``emit_responses=False`` returns the window streams only.

    ``mesh`` (a ``fleet.sync.FrontendMesh``, called on every rank with the
    same arguments) shards the frontends over the mesh's processes: rank r
    serves the frontend rows ``mesh.rows(S)``, the sync rounds run the
    mesh's collectives (``fleet.sync.SYNC_KINDS``, on sync turns only) and
    the turn's placements are gathered for the shared pool, which every
    rank runs alike. Every rank returns the stacked run's results, bit for
    bit, and its router ends with every frontend's state;
    ``info["collectives"]`` counts the run's collectives by kind. The
    router's device must be the mesh's.

    Returns ``(response_times, mu_trace, info)`` with ``run_fleet_simulation``'s
    info keys, the overflow counters and the graphs' records."""
    T, k = times_np.shape
    n, S = router.n, router.S
    if k % S != 0:
        raise ValueError(f"arrival_batch={k} must divide evenly over S={S} frontends on the "
                         "scan path")
    if mesh is not None:
        if not isinstance(mesh, fsync.FrontendMesh):
            raise TypeError(f"mesh= takes a fleet.sync.FrontendMesh, not {type(mesh).__name__}")
        mesh.rows(S)
        mesh.check_device(router.frontends[0].q_view)
        colls0 = mesh.counts.copy()
    kf = k // S
    frs = router.frontends
    if active_np is None and frs[0].active is not None:
        active_np = np.broadcast_to(frs[0].active.cpu().numpy(), (T, n)).copy()
    churn = active_np is not None
    burst_cap = int(burst_np.shape[1]) if churn and burst_np is not None else 0
    if burst_cost is None:
        burst_cost = 4.0 * fake_cost
    sync_every = max(int(sync_every), 1)
    faulty = kill_np is not None or stall_np is not None
    cols = dict(times=np.asarray(times_np, np.float64), costs=np.asarray(costs_np, np.float64),
                speeds=np.asarray(speeds_np, np.float64))
    if churn:
        changed = np.zeros(T, bool)
        if T:
            changed[0] = True
            changed[1:] = np.any(active_np[1:] != active_np[:-1], axis=1)
        cols.update(active=np.asarray(active_np, bool),
                    rejoin=(np.zeros((T, n), bool) if rejoin_np is None
                            else np.asarray(rejoin_np, bool)),
                    changed=changed,
                    burst=(np.zeros((T, 0), np.int32) if burst_np is None
                           else np.asarray(burst_np, np.int32)))
    if faulty:
        cols.update(
            kill=np.full((T, n), np.inf) if kill_np is None else np.asarray(kill_np, np.float64),
            stall=(np.full((T, n), np.inf) if stall_np is None
                   else np.asarray(stall_np, np.float64)),
            stall_dur=(np.zeros((T, n)) if stall_dur_np is None
                       else np.asarray(stall_dur_np, np.float64)))
    n_tasks = T * k
    windows: list = []
    windows_f: list = []
    resp_l, mu_l, w_l, gaps_l = [], [], [], []
    synced = (np.arange(T) % sync_every) == 0
    run = None
    if T:
        cfg = fleet_scan_config(router, k, churn=churn, burst_cap=burst_cap, fake_cost=fake_cost,
                                burst_cost=burst_cost, pend_cap=pend_cap, faulty=faulty,
                                task_cap=n_tasks, sync_every=sync_every, frozen_mu=frozen_mu,
                                observe=observe)
        if chunk_turns is None:
            chunk_turns = auto_chunk_turns(T, k, n, churn=churn, burst_cap=burst_cap,
                                           faulty=faulty, pend_cap=pend_cap)
        step = max(int(chunk_turns), 1)
        run = fleet_runner(cfg, str(router.device), min(step, T), mesh)
        replays0 = dict(run.replays)
        run.load(router, pool)
        for ci, s in enumerate(range(0, T, step)):
            chunk = {name: a[s:s + step] for name, a in cols.items()}
            with obt.step_annotation("fleet_scan_chunk", ci, router.device):
                ys = run.run_rows(chunk, s)
            if run.emit:
                mu_l.append(ys["mu"].copy())
                w_l.append(ys["workers"].copy())
                gaps_l.append(ys["gaps"][synced[s:s + step]].copy())
                if not faulty:
                    resp_l.append(ys["resp"].copy())
            if observe is not None:
                new, new_f = obw.fleet_records_from_rows(observe, *_tc_rows(ys, run.detect))
                windows.extend(new)
                windows_f.extend(new_f)
                if obs_sink is not None and new:
                    obs_sink(new)
    resp = np.concatenate(resp_l).reshape(-1) if resp_l else np.empty(0)
    mu_trace = np.concatenate(mu_l) if mu_l else np.zeros((0, n), np.float32)
    workers_log = np.concatenate(w_l) if w_l else np.zeros((0, k), np.int32)
    gaps = np.concatenate(gaps_l) if gaps_l else np.zeros((0, S), np.int32)
    info = {"turns": T, "flush_overflow": 0, "pend_overflow": 0, "longest_chain": 0,
            "frontends": np.tile(np.repeat(np.arange(S, dtype=np.int64), kf), T),
            "workers": workers_log.reshape(-1).astype(np.int64),
            "epochs": np.repeat(np.arange(T, dtype=np.int64) // sync_every, k),
            "sync_gaps": gaps.astype(np.int64) if S > 1 else np.zeros((0, S))}
    if run is not None:
        c = run.full_carry()
        info.update(flush_overflow=int(c["over_flush"].item()),
                    pend_overflow=int(c["over_pend"].item()),
                    longest_chain=int(c["chain_max"].item()))
        replays = {p: run.replays[p] - replays0[p] for p in run.patterns}
        info.update(
            capture_s=run.capture_s if not any(replays0.values()) else 0.0,
            replays=sum(replays.values()),
            graphs={_pattern_label(p): dict(nodes=run.graph_nodes.get(p),
                                            kernels=dict(run.graph_kernels.get(p, {})),
                                            collectives=run.collectives.get(p, {}),
                                            replays=replays[p]) for p in run.patterns})
        launches: dict[str, int] = {}
        for p in run.patterns:
            for name, cnt in run.graph_kernels.get(p, {}).items():
                launches[name] = launches.get(name, 0) + cnt * replays[p]
        info["graph_launches"] = launches
        if faulty:
            # the books close on the final carry with the host loop's epilogue
            valid = c["p_valid"].cpu().numpy()
            resp_acc = c["resp"].cpu().numpy()[:n_tasks].copy()
            ctr = c["ctr"].cpu().numpy().copy()
            rcv.drain_pending(resp_acc, ctr, c["p_done"].cpu().numpy()[valid],
                              c["p_task"].cpu().numpy()[valid], c["p_arrv"].cpu().numpy()[valid])
            resp, info["ledger"] = rcv.build_ledger(resp_acc, ctr, n_tasks,
                                                    float(c["max_clean"].item()))
        if observe is not None:
            tail, tail_f = obw.fleet_final_partial(observe, _tc_view(c))
            if tail is not None:
                windows.append(tail)
                windows_f.append(tail_f)
                if obs_sink is not None:
                    obs_sink([tail])
        _write_back_fleet(router, pool, c, active_np[-1] if churn else None)
    if mesh is not None:
        info["collectives"] = dict(mesh.counts - colls0)
    info["lam_hats"] = router.lam_hats
    if observe is not None:
        info["windows"] = windows
        info["windows_frontends"] = windows_f
    if strict_overflow and (info["flush_overflow"] or info["pend_overflow"]):
        raise RuntimeError(
            f"fleet scan capacities overflowed (flush_overflow={info['flush_overflow']}, "
            f"pend_overflow={info['pend_overflow']}) with pend_cap={pend_cap}: results "
            f"silently dropped work. Raise pend_cap or pass strict_overflow=False.")
    return resp, mu_trace, info


def _pattern_label(pattern) -> str:
    sync, rebuild = pattern
    return ("sync" if sync else "no sync") + (" + rebuild" if rebuild else "")


def _write_back_fleet(router: rt.FleetRouter, pool: rt.SimulatedPool, c: dict,
                      active_last) -> None:
    """The final carry (every frontend's rows) back into the ``FleetRouter``'s
    frontends and the pool."""
    mu_pend = c["mu_pend"].cpu().numpy()
    for s, fr in enumerate(router.frontends):
        fr.q_view = c["q_view"][s].clone()
        fr.learner = lrn.LearnerState(**{f: c[f][s].clone() for f in _LEARNER})
        fr.arr = est.to_host(est.EmaArrivalState(c["arr_last"][s], c["arr_gap"][s],
                                                 c["arr_count"][s]))
        fr.key = prng.host_key(c["key"][s])
        fr.last_fake_time = float(c["last_fake"][s].item())
        fr.mu_front = c["mu_front"][s].clone()
        fr._mu_pending = fr.learner.mu_hat if bool(mu_pend[s]) else None
        fr._mu_event = None
        if active_last is not None:
            fr.active = torch.from_numpy(np.array(active_last, bool)).to(fr.device)
        if fr.use_alias:
            fr.table_front = dsp.build_alias_table(fr.mu_front, fr.active)
    router._snap = c["q_snap"].cpu().numpy().astype(np.int64)
    router._herd_applied = c["herd_applied"].cpu().numpy().astype(np.int64)
    router.t_sync = float(c["t_sync"].item())
    router.lam_global = float(c["lam_global"].item())
    pool.free_at = c["free_at"].cpu().numpy().copy()


def run_fleet_simulation_scan(
    router: rt.FleetRouter,
    pool: rt.SimulatedPool,
    *,
    arrival_rate: float,
    horizon: float,
    request_cost: float = 1.0,
    speed_schedule: "list[tuple[float, np.ndarray]] | None" = None,
    seed: int = 0,
    arrival_batch: int = 1,
    sync_every: int = 1,
    pend_cap: int = PEND_CAP,
    frozen_mu: bool = False,
    chunk_turns: int | None = None,
    mesh=None,
):
    """Drop-in for ``run_fleet_simulation`` with every turn on the device
    (the same workload draws, so host and scan fleets see the same
    arrivals); ``arrival_batch`` a multiple of S; ``mesh`` as
    ``run_fleet_workload_scan``'s. Returns ``(response_times, mu_trace,
    info)``."""
    wl = _precompute_workload(arrival_rate, horizon, request_cost, speed_schedule, seed,
                              arrival_batch, pool.speeds)
    if wl is None:
        S = router.S
        return np.empty(0), np.zeros((0, router.n)), {
            "turns": 0, "flush_overflow": 0, "pend_overflow": 0,
            "frontends": np.empty(0, np.int64), "workers": np.empty(0, np.int64),
            "epochs": np.empty(0, np.int64), "sync_gaps": np.zeros((0, S)),
            "lam_hats": np.zeros(S)}
    times_np, costs_np, speeds_np = wl
    return run_fleet_workload_scan(
        router, pool, times_np, costs_np, speeds_np, fake_cost=request_cost * 0.25,
        pend_cap=pend_cap, sync_every=sync_every, frozen_mu=frozen_mu,
        chunk_turns=chunk_turns, mesh=mesh)
