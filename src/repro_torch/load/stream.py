"""Chunked workload streaming: million-request horizons in bounded memory.

The port's copy of the JAX package's ``repro.load.stream``. Two producers
and one consumer:

  * ``ScenarioStream`` — a lazy ``Scenario.compile_serving``, numpy only
    and copied from the reference: the environment processes compile ONCE
    (their trajectories are small — O(horizon / dwell) breakpoints), then
    ``chunks(chunk_turns)`` yields ``ServingWorkload`` pieces of ≤
    ``chunk_turns`` turns, drawing the workload stream incrementally. For
    the classic arrival modes (homogeneous Poisson / thinning / trace
    replay) the per-turn loop and its ``RandomState`` call order replicate
    ``compile_serving`` exactly, so the CONCATENATION of the chunks is
    bit-identical to the monolithic arrays; for ``is_stream`` generators
    (``repro_torch.load.traces``) a vectorized block path produces arrivals
    at ~10⁶/s so generation never holds the loop back (its draws depend on
    ``chunk_turns``, see the class). Every chunk equals the reference's
    (tests/test_torch_load.py).
  * ``ServingWorkload.iter_chunks`` — slices of an already-materialized
    workload (the parity bridge: same chunks, zero generation ambiguity).
  * ``run_stream_scan`` — feeds either producer to the one-program loop's
    chunk driver (``serving.scanloop._drive_scan``): the carry (router,
    pending set, telemetry) stays on the device across chunk boundaries,
    so the host's live set is one chunk of workload columns plus the
    window records. A scan over T turns is the composition of scans over
    its chunks, so the streamed run is bit-equal to a monolithic
    ``run_workload_scan`` on the concatenated arrays.

Memory model: peak host RSS is O(chunk_turns · k + windows) regardless of
horizon; peak device memory is O(chunk_turns · k + pend_cap). Stream-only
telemetry (``ObserveConfig(emit_responses=False)``) keeps even the
per-request responses from materializing: only window records come back.
"""
from __future__ import annotations

import numpy as np

from repro_torch.env import processes as prc
from repro_torch.env.scenario import Scenario, ServingWorkload
from repro_torch.load import traces as ltr
from repro_torch.serving import recovery as rcv
from repro_torch.serving import scanloop


class ScenarioStream:
    """Lazy, chunked ``compile_serving`` (see module docstring).

    State persists across ``chunks()`` pulls: the workload RandomState,
    the clock, the trace cursor, the previous membership row (rejoin
    edges cross chunk boundaries) and the fault-event cursor — so for the
    classic arrival modes the chunk sequence depends only on ``(scenario,
    seed, arrival_batch)``, never on ``chunk_turns``. A generated stream
    draws a chunk's costs after the arrival blocks that chunk needed, from
    the same ``RandomState``, so its trace also depends on ``chunk_turns``,
    as the reference's does.
    """

    def __init__(self, scn: Scenario, *, seed: int = 0,
                 arrival_batch: int = 1, block: int = 65536):
        self.scn = scn
        self.seed = seed
        self.k = int(arrival_batch)
        self.n = scn.n
        self._block = block

        rate, (cap_bp, cap_val), memb, flt = scn._compile_env(seed)
        if flt is not None:
            fmask = prc.fault_outage_masks(self.n, flt)
            memb = fmask if memb is None else prc.and_masks(memb, fmask)
        self._rate = rate
        self._cap = (np.asarray(cap_bp), np.asarray(cap_val))
        self._memb = memb
        self._flt = flt
        self.shift_times = scn._shifts_from(cap_bp, memb, flt)
        self.churn = memb is not None
        self.faulty = flt is not None
        #: fixed probe-burst width: every chunk pads to the global worst
        #: case (all n workers rejoining at once) — -1 slots are inert in
        #: the scan body, and a FIXED width keeps one compiled program
        #: across chunks (the monolithic compile pads to the realized max
        #: instead, so compare against burst arrays padded to this width
        #: for program-identical parity runs)
        self.burst_cap = self.n * scn.probe_burst if self.churn else 0

        self._rng = np.random.RandomState(seed)
        self._t = 0.0
        self._done = False
        self._prev_active: np.ndarray | None = None
        self.turns_emitted = 0
        self.trace_dropped = 0

        self._mode = (
            "homogeneous" if getattr(scn.arrivals, "is_homogeneous", False)
            else "trace" if getattr(scn.arrivals, "is_trace", False)
            else "stream" if getattr(scn.arrivals, "is_stream", False)
            else "thinning"
        )
        if self._mode == "trace":
            tr_t = np.asarray(scn.arrivals.times, float)
            keep = tr_t < scn.horizon
            self._tr_t = tr_t[keep]
            self._tr_c = (
                None if scn.arrivals.costs is None
                else np.asarray(scn.arrivals.costs, float)[keep]
            )
            self._tr_i = 0
        elif self._mode == "stream":
            self._gen = ltr.stream_arrivals(
                rate, scn.horizon, self._rng, block=block)
            self._buf_t = np.empty(0)

    # -- per-turn workload draws (exact compile_serving replication) --------

    def _draw_turn(self):
        """One turn's (times, costs) with compile_serving's exact
        RandomState call order, or None when the horizon/trace ends."""
        scn, rng, k = self.scn, self._rng, self.k
        if self._t >= scn.horizon:
            return None
        if self._mode == "homogeneous":
            gaps = rng.exponential(1.0 / scn.rate, size=k)
            times = self._t + np.cumsum(gaps)
        elif self._mode == "trace":
            if self._tr_i + k > len(self._tr_t):
                self.trace_dropped = len(self._tr_t) - self._tr_i
                return None
            times = self._tr_t[self._tr_i:self._tr_i + k].copy()
        else:  # thinning
            lam_max = self._rate.max
            times = np.empty(k)
            tt = self._t
            for i in range(k):
                while True:
                    tt += rng.exponential(1.0 / lam_max)
                    if rng.uniform() * lam_max < self._rate.at(tt):
                        break
                times[i] = tt
        self._t = float(times[-1])
        if self._mode == "trace" and self._tr_c is not None:
            costs = scn.request_cost * self._tr_c[self._tr_i:self._tr_i + k]
        else:
            costs = scn.request_cost * rng.exponential(1.0, size=k)
        if self._mode == "trace":
            self._tr_i += k
        return times, costs

    def _stream_turns(self, max_turns: int):
        """Vectorized arrivals for ``is_stream`` generators: pull blocks
        from the thinning generator, cut full k-batches, keep the
        remainder buffered. Returns (times[T,k], costs[T,k]) or None."""
        scn, k = self.scn, self.k
        need = max_turns * k
        while self._buf_t.size < need:
            try:
                self._buf_t = np.concatenate([self._buf_t, next(self._gen)])
            except StopIteration:
                break
        T = min(self._buf_t.size // k, max_turns)
        if T == 0:
            if self._buf_t.size and self._buf_t.size < k:
                self.trace_dropped = int(self._buf_t.size)
                self._buf_t = np.empty(0)
            return None
        take = self._buf_t[:T * k]
        self._buf_t = self._buf_t[T * k:]
        times = take.reshape(T, k)
        costs = scn.request_cost * scn.arrivals.draw_costs(
            self._rng, T * k).reshape(T, k)
        self._t = float(times[-1, -1])
        return times, costs

    # -- chunk assembly ------------------------------------------------------

    def chunks(self, chunk_turns: int):
        """Yield ``ServingWorkload`` chunks of ≤ ``chunk_turns`` turns
        until the horizon (or trace) is exhausted."""
        step = max(int(chunk_turns), 1)
        while not self._done:
            wl = self._next_chunk(step)
            if wl is None:
                self._done = True
                return
            yield wl

    def _next_chunk(self, step: int):
        scn, n = self.scn, self.n
        cap_bp, cap_val = self._cap
        if self._mode == "stream":
            tc = self._stream_turns(step)
            if tc is None:
                return None
            times, costs = tc
            t_end = times[:, -1]
            speeds = prc.piecewise_at(cap_bp, cap_val, t_end)
        else:
            times_l, costs_l, speeds_l = [], [], []
            while len(times_l) < step:
                turn = self._draw_turn()
                if turn is None:
                    break
                times_l.append(turn[0])
                costs_l.append(turn[1])
                speeds_l.append(
                    prc.piecewise_at(cap_bp, cap_val, self._t))
            if not times_l:
                return None
            times = np.stack(times_l)
            costs = np.stack(costs_l)
            speeds = np.stack(speeds_l)
            t_end = times[:, -1]
        T = len(times)

        active = rejoin = burst = None
        if self.churn:
            act_bp, act_val = self._memb
            active = prc.piecewise_at(act_bp, act_val, t_end)
            prev0 = (active[0] if self._prev_active is None
                     else self._prev_active)
            prev = np.concatenate([prev0[None, :], active[:-1]], axis=0)
            rejoin = active & ~prev  # global turn 0 has no rejoin edge
            self._prev_active = active[-1]
            burst = np.full((T, self.burst_cap), -1, np.int32)
            per_turn = rejoin.sum(axis=1) * scn.probe_burst
            for ti in np.nonzero(per_turn)[0]:
                ids = np.repeat(np.nonzero(rejoin[ti])[0], scn.probe_burst)
                burst[ti, :len(ids)] = ids

        kill_at = stall_at = stall_dur = None
        if self.faulty:
            # same assignment rule as the monolithic compile: event i
            # lands on the FIRST turn whose end time reaches its instant
            # (searchsorted left); with chunks partitioning the
            # nondecreasing t_end sequence, that turn is in THIS chunk
            # iff prev_last_t_end < ft0[i] <= t_end[-1]. Events are
            # walked in trace order so same-(turn, worker) overwrites
            # resolve identically.
            prev_last = getattr(self, "_last_t_end", -np.inf)
            ft0, ft1, fw, fkind = self._flt
            kill_at = np.full((T, n), np.inf)
            stall_at = np.full((T, n), np.inf)
            stall_dur = np.zeros((T, n))
            for i in range(len(ft0)):
                if not (prev_last < ft0[i] <= t_end[-1]):
                    continue
                ti = int(np.searchsorted(t_end, ft0[i], side="left"))
                if fkind[i] == prc.FAULT_CRASH:
                    kill_at[ti, fw[i]] = ft0[i]
                else:
                    stall_at[ti, fw[i]] = ft0[i]
                    stall_dur[ti, fw[i]] = ft1[i] - ft0[i]
            self._last_t_end = float(t_end[-1])

        self.turns_emitted += T
        return ServingWorkload(
            times, costs, speeds, active, rejoin, burst,
            self.shift_times, self.trace_dropped,
            kill_at=kill_at, stall_at=stall_at, stall_dur=stall_dur,
        )


def _wl_to_cols(wl: ServingWorkload, *, churn: bool, burst_cap: int,
                faulty: bool, n: int) -> dict:
    """One chunk's workload columns ({name: numpy [t, ...]}) under the
    names the chunk driver reads: times, costs, speeds; then active,
    rejoin, burst with churn; then kill, stall, stall_dur with faults."""
    T = wl.turns
    cols = dict(times=np.asarray(wl.times, np.float64),
                costs=np.asarray(wl.costs, np.float64),
                speeds=np.asarray(wl.speeds, np.float64))
    if churn:
        if (wl.active is None) or (wl.burst is None and burst_cap) or (
                wl.burst is not None and wl.burst.shape[1] != burst_cap):
            raise ValueError(
                "inconsistent membership columns across chunks: every "
                f"chunk must carry active/rejoin and a width-{burst_cap} "
                "burst array (pad with -1)")
        cols.update(active=np.asarray(wl.active, bool),
                    rejoin=np.asarray(wl.rejoin, bool),
                    burst=(np.zeros((T, 0), np.int32) if wl.burst is None
                           else np.asarray(wl.burst, np.int32)))
    elif wl.active is not None:
        raise ValueError(
            "chunk 0 had no membership columns but a later chunk does — "
            "the captured turn is fixed at the first chunk's shape")
    if faulty:
        cols.update(
            kill=(np.asarray(wl.kill_at, np.float64) if wl.kill_at is not None
                  else np.full((T, n), np.inf)),
            stall=(np.asarray(wl.stall_at, np.float64) if wl.stall_at is not None
                   else np.full((T, n), np.inf)),
            stall_dur=(np.asarray(wl.stall_dur, np.float64)
                       if wl.stall_dur is not None else np.zeros((T, n))))
    elif wl.has_faults:
        raise ValueError(
            "chunk 0 had no fault columns but a later chunk does — pass "
            "recovery= to engage the failure-semantics turn up front")
    return cols


def run_stream_scan(
    router,
    pool,
    chunks,  # ScenarioStream, or an iterable of ServingWorkload chunks
    # (e.g. ``wl.iter_chunks(c)``); the FIRST non-empty chunk fixes the
    # turn's shape (membership/fault columns, burst width, arrival batch)
    # and, for an iterable, the rows a chunk may hold
    *,
    chunk_turns: int | None = None,  # required with a ScenarioStream
    fake_cost: float = 0.25,
    burst_cost: float | None = None,
    recovery=None,
    pend_cap: int = scanloop.PEND_CAP,  # streams have no known total-
    # submission bound to auto-size against — pass the in-flight bound
    # you can afford; overflow raises under strict_overflow
    comp_cap: int | None = None,
    task_cap: int | None = None,  # REQUIRED for fault/recovery streams:
    # capacity of the task-indexed response buffer riding the carry
    strict_overflow: bool = True,
    observe=None,
    obs_sink=None,
    timing: bool = False,  # per-chunk wall clock + RSS → info["chunks"]
):
    """Drive a chunked workload stream through the one-program loop.

    Consumes ``ScenarioStream.chunks(chunk_turns)`` or any iterable of
    ``ServingWorkload`` chunks, converts each to the turn's workload
    columns, and hands them to the chunk driver: the carry crosses chunk
    boundaries on the device, so the result (responses, μ̂ trace, ledger,
    telemetry windows, final router/pool state) is bit-equal to a
    monolithic ``run_workload_scan`` over the concatenated arrays. The
    turn is captured for ``chunk_turns`` rows with a ``ScenarioStream``,
    else for the first chunk's turns (a longer later chunk raises).
    Returns ``(responses, mu_trace, info)``; for generated streams,
    ``info["trace_dropped"]`` counts the partial tail batch."""
    stream = None
    if isinstance(chunks, ScenarioStream):
        if chunk_turns is None:
            raise ValueError("chunk_turns is required with a ScenarioStream")
        stream = chunks
        chunk_iter = stream.chunks(chunk_turns)
    else:
        chunk_iter = iter(chunks)

    first = next((wl for wl in chunk_iter if wl.turns > 0), None)
    if first is None:
        return np.empty(0), np.zeros((0, router.n), np.float32), {
            "turns": 0, "flush_overflow": 0, "pend_overflow": 0, "longest_chain": 0}
    n = router.n
    k = int(first.times.shape[1])
    churn = first.active is not None
    burst_cap = int(first.burst.shape[1]) if (churn and first.burst is not None) else 0
    faulty = first.has_faults or recovery is not None
    rc = (recovery if recovery is not None else rcv.INERT_RECOVERY) if faulty else None
    if burst_cost is None:
        burst_cost = 4.0 * fake_cost
    if faulty:
        if task_cap is None:
            raise ValueError(
                "task_cap is required for fault/recovery streams: the "
                "task-indexed response buffer rides the scan carry and "
                "must be sized up front (total stream turns × k)")
    else:
        task_cap = 0
    rows = max(int(chunk_turns), 1) if stream is not None else first.turns

    def _cols():
        yield _wl_to_cols(first, churn=churn, burst_cap=burst_cap, faulty=faulty, n=n)
        for wl in chunk_iter:
            yield _wl_to_cols(wl, churn=churn, burst_cap=burst_cap, faulty=faulty, n=n)

    resp, mu_trace, info = scanloop._drive_scan(
        router, pool, _cols(), rows=rows, k=k, churn=churn, burst_cap=burst_cap,
        fake_cost=fake_cost, burst_cost=float(burst_cost), pend_cap=pend_cap,
        comp_cap=comp_cap, strict_overflow=strict_overflow, recovery=rc,
        task_cap=int(task_cap), observe=observe, obs_sink=obs_sink, timing=timing)
    if stream is not None:
        info["trace_dropped"] = stream.trace_dropped
    return resp, mu_trace, info
