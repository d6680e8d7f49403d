"""Scenario — a declarative cluster environment, compiled for the serving
loops.

The port's copy of the JAX package's ``repro.env.scenario``, numpy only. A
``Scenario`` is a named composition of one arrival process, one capacity
process and (optionally) one membership and one fault process over a
horizon (``env/processes.py``), plus the cluster's baseline speeds and
rate. It compiles to:

  * ``compile_serving`` → a ``ServingWorkload``: per-turn arrival times,
    request costs, speed trajectory and membership schedule as dense
    arrays — consumed BOTH by the host serving loop
    (``env/serving.run_workload``) and by the one-program loop
    (``serving/scanloop.run_workload_scan``), which is what makes
    host-vs-scan float-for-float parity a per-scenario test instead of a
    special case. For every registered scenario and seed the arrays equal
    the reference's (tests/test_torch_env.py);
  * ``shift_times`` → the environment's shock instants, feeding the
    adaptation-time harness (``core/metrics.adaptation_report``).

``to_sim`` (the chain simulator's compile) is not ported yet and raises
(ROADMAP queue A, A8).

The registry maps names to factories: ``env.make("flash_crowd")``,
``env.make("churn_heavy", horizon=900.0)``, … — see the builtin catalog
at the bottom. The ``null`` scenario draws exactly ``run_simulation``'s
workload, so its host run is bit-equal to ``run_simulation``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.env import processes as prc

#: Seed offset separating the environment's compile-time randomness (MMPP
#: regime paths, OU drift, random churn, reshuffles) from the workload's
#: RandomState stream (arrival gaps + request costs) — the null scenario
#: must consume the workload stream EXACTLY like run_simulation does.
ENV_SEED_OFFSET = 0x5CE4A


@dataclasses.dataclass(frozen=True)
class ServingWorkload:
    """A scenario materialized for the serving loops (host and scan)."""

    times: np.ndarray  # f64[T, k] per-turn arrival times
    costs: np.ndarray  # f64[T, k] per-turn request costs
    speeds: np.ndarray  # f64[T, n] replica speeds entering each turn
    active: np.ndarray | None  # bool[T, n] membership (None → no churn)
    rejoin: np.ndarray | None  # bool[T, n] offline→online edges per turn
    burst: np.ndarray | None  # i32[T, Bc] probe-burst targets (-1 padded)
    shift_times: np.ndarray  # f64[/] capacity+membership shock instants
    # Trace replay only: requests the trace holds beyond the last full
    # arrival batch (the serving turn shape is fixed at ``arrival_batch``,
    # so a partial tail cannot run) — NEVER silently zero for a truncated
    # replay; consumers surface it (benchmarks/scenario_suite.py).
    trace_dropped: int = 0
    # Fault tracks (None on fault-free scenarios). A fault event lands on
    # the first turn whose end time reaches its instant; when two faults
    # at the same worker map to the same turn, the later one wins.
    kill_at: np.ndarray | None = None  # f64[T, n] crash instants (+inf none)
    stall_at: np.ndarray | None = None  # f64[T, n] blackout instants (+inf)
    stall_dur: np.ndarray | None = None  # f64[T, n] blackout durations

    @property
    def has_faults(self) -> bool:
        return self.kill_at is not None or self.stall_at is not None

    @property
    def turns(self) -> int:
        return self.times.shape[0]

    def partition(self, n_frontends: int):
        """Materialize the per-FRONTEND view of this workload for the
        one-program fleet (``scanloop.run_fleet_workload_scan``): frontend
        f owns the contiguous chunk ``[:, f*k_f:(f+1)*k_f]`` of each turn
        (the host ``run_fleet_simulation`` split at its equal-chunk
        shapes). Returns ``(times_f, costs_f, frontend_of)`` with
        ``times_f``/``costs_f`` shaped ``f64[T, S, k_f]`` and
        ``frontend_of`` the i32[k] request→frontend map shared by every
        turn. Raises when the batch does not split evenly — the fleet scan
        needs one fixed per-frontend shape."""
        S = int(n_frontends)
        T, k = self.times.shape
        if S < 1 or k % S != 0:
            raise ValueError(
                f"arrival_batch={k} must divide evenly over "
                f"S={S} frontends"
            )
        k_f = k // S
        times_f = self.times.reshape(T, S, k_f)
        costs_f = self.costs.reshape(T, S, k_f)
        frontend_of = np.repeat(np.arange(S, dtype=np.int32), k_f)
        return times_f, costs_f, frontend_of

    def iter_chunks(self, chunk_turns: int):
        """Slice this MATERIALIZED workload into ≤ ``chunk_turns``-turn
        ``ServingWorkload`` views (every per-turn column — times, costs,
        speeds, membership, rejoin edges, burst targets, fault tracks —
        sliced consistently; ``shift_times`` stays whole as run-level
        metadata and ``trace_dropped`` rides the final chunk). The chunked
        scan driver composes these back into exactly the monolithic
        program — ``repro_torch.load.run_stream_scan(iter_chunks(...))`` is
        bit-equal to ``run_workload_scan`` on the whole arrays. Lazily
        GENERATED chunk streams (the host never holding the full trace)
        come from ``repro_torch.load.ScenarioStream`` instead."""
        step = max(int(chunk_turns), 1)
        T = self.turns

        def sl(a, s):
            return None if a is None else a[s:s + step]

        for s in range(0, T, step):
            last = s + step >= T
            yield dataclasses.replace(
                self,
                times=self.times[s:s + step],
                costs=self.costs[s:s + step],
                speeds=self.speeds[s:s + step],
                active=sl(self.active, s),
                rejoin=sl(self.rejoin, s),
                burst=sl(self.burst, s),
                kill_at=sl(self.kill_at, s),
                stall_at=sl(self.stall_at, s),
                stall_dur=sl(self.stall_dur, s),
                trace_dropped=self.trace_dropped if last else 0,
            )


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A declarative cluster environment (see module docstring)."""

    name: str
    speeds: tuple  # baseline worker speeds
    rate: float  # baseline arrival rate λ
    horizon: float
    arrivals: object = prc.HomogeneousPoisson()
    capacity: object = prc.StaticCapacity()
    membership: object | None = None
    faults: object | None = None  # FaultSchedule / RandomFaults
    request_cost: float = 1.0
    probe_burst: int = prc.PROBE_BURST
    description: str = ""

    # -- properties ---------------------------------------------------------

    @property
    def n(self) -> int:
        return len(self.speeds)

    @property
    def is_null(self) -> bool:
        """True iff this scenario is the pre-env behavior exactly:
        homogeneous Poisson arrivals, static capacity, no churn."""
        return (
            getattr(self.arrivals, "is_homogeneous", False)
            and getattr(self.capacity, "is_static", False)
            and self.membership is None
            and self.faults is None
        )

    @property
    def sim_supported(self) -> bool:
        """Trace replays drive the serving layers verbatim; the chain
        simulator sees only their binned empirical rate (still runs, but
        it is an approximation, not a replay)."""
        return True

    @property
    def scan_supported(self) -> bool:
        return True

    def _env_rng(self, seed: int) -> np.random.RandomState:
        return np.random.RandomState((seed + ENV_SEED_OFFSET) % (2**31))

    def _compile_env(self, seed: int):
        """Compile all four processes off ONE env stream in a fixed order
        (arrivals, capacity, membership, faults) — every consumer must
        draw in this order or stochastic processes would diverge between
        callers (faults drawn LAST so pre-fault scenarios keep their
        exact earlier streams). Returns
        (rate, (cap_bp, cap_val), (act_bp, act_val) | None, faults | None)
        where faults = (t0[E], t1[E], w[E], kind[E])."""
        rng = self._env_rng(seed)
        rate = self.arrivals.compile_rate(self.rate, self.horizon, rng)
        cap = self.capacity.compile(
            np.asarray(self.speeds, float), self.horizon, rng
        )
        memb = (
            None if self.membership is None
            else self.membership.compile(self.n, self.horizon, rng)
        )
        flt = (
            None if self.faults is None
            else self.faults.compile(self.n, self.horizon, rng)
        )
        if flt is not None and not len(flt[0]):
            flt = None
        return rate, cap, memb, flt

    def _shifts_from(self, cap_bp, memb, flt=None) -> np.ndarray:
        """Shock instants from ALREADY-compiled trajectories (t=0
        baselines excluded) — compile once, derive shifts for free."""
        shifts = list(np.asarray(cap_bp)[1:])
        if memb is not None:
            shifts += list(np.asarray(memb[0])[1:])
        if flt is not None:
            shifts += list(np.asarray(flt[0])) + list(np.asarray(flt[1]))
        shifts = np.asarray(sorted(set(float(t) for t in shifts)))
        return shifts[shifts < self.horizon]

    def shift_times(self, seed: int = 0) -> np.ndarray:
        """Environment shock instants (capacity + membership + fault
        breakpoints). Deterministic in ``seed`` (the same env stream the
        compiles consume)."""
        _, (cap_bp, _), memb, flt = self._compile_env(seed)
        return self._shifts_from(cap_bp, memb, flt)

    @property
    def drifting(self) -> bool:
        """True when an axis changes CONTINUOUSLY (diurnal wave, OU
        drift, empirical trace rate): its compiled breakpoints are
        discretization artifacts, not shift events, so detector
        false-alarm accounting is undefined on this scenario
        (``obs.detect.detection_report(drifting=True)``)."""
        arr, cap = self.arrivals, self.capacity
        arr_drifts = not (getattr(arr, "is_homogeneous", False)
                          or getattr(arr, "shift_like", False))
        cap_drifts = not (getattr(cap, "is_static", False)
                          or getattr(cap, "shift_like", False))
        return arr_drifts or cap_drifts

    def shift_events(self, seed: int = 0) -> list:
        """Ground-truth (time, kind) shift events for detector
        attribution (``obs.detect.detection_report``), kinds in
        {"load", "capacity", "membership", "fault"}.

        Unlike ``shift_times`` (which feeds the adaptation harness and
        keeps its historical capacity+membership+fault definition), this
        includes ARRIVAL breakpoints — but only for processes that mark
        themselves ``shift_like`` (MMPP regime switches, step schedules,
        …); drift discretization bins (diurnal, OU) are excluded because
        their breakpoints are not events anything should detect.
        Deterministic in ``seed``; sorted; times < horizon."""
        rate, (cap_bp, _), memb, flt = self._compile_env(seed)
        events: set = set()
        if getattr(self.arrivals, "shift_like", False):
            events |= {(float(t), "load") for t in np.asarray(rate.bp)[1:]}
        if getattr(self.capacity, "shift_like", False):
            events |= {(float(t), "capacity")
                       for t in np.asarray(cap_bp)[1:]}
        if memb is not None:
            events |= {(float(t), "membership")
                       for t in np.asarray(memb[0])[1:]}
        if flt is not None:
            events |= {(float(t), "fault")
                       for t in np.concatenate([flt[0], flt[1]])}
        return sorted((t, k) for t, k in events if t < self.horizon)

    # -- serving compile ----------------------------------------------------

    def compile_serving(self, seed: int = 0,
                        arrival_batch: int = 1) -> ServingWorkload:
        """Materialize the scenario as per-turn serving arrays.

        The workload RandomState consumes, per turn, arrival gaps then
        request costs — for the null scenario this is EXACTLY
        ``run_simulation``'s call sequence (the bit-exactness anchor).
        Environment randomness (regime paths, drift, churn) comes from a
        separate stream keyed off the same seed, so a scenario + seed is
        one deterministic workload.
        """
        if getattr(self.arrivals, "is_stream", False):
            raise ValueError(
                f"scenario {self.name!r} uses a streaming arrival process "
                f"({type(self.arrivals).__name__}) — it cannot be "
                f"materialized whole; drive it through "
                f"repro_torch.load.ScenarioStream / run_stream_scan instead"
            )
        speeds0 = np.asarray(self.speeds, float)
        n = self.n

        # capacity / membership / fault trajectories (compile-time
        # randomness). Fault outage windows [t0, t1) merge into the
        # membership masks, so crashed/blacked-out workers stop receiving
        # placements and their recoveries ride the existing rejoin
        # machinery (probe burst + learner cold-start).
        rate, (cap_bp, cap_val), memb, flt = self._compile_env(seed)
        if flt is not None:
            fmask = prc.fault_outage_masks(n, flt)
            memb = fmask if memb is None else prc.and_masks(memb, fmask)
        act_bp, act_val = memb if memb is not None else (None, None)
        shifts = self._shifts_from(cap_bp, memb, flt)

        def cap_at(t):
            return prc.piecewise_at(cap_bp, cap_val, t)

        def act_at(t):
            return prc.piecewise_at(act_bp, act_val, t)

        # workload stream: per turn, gaps then costs (run_simulation order)
        rng = np.random.RandomState(seed)
        lam_max = rate.max
        trace = getattr(self.arrivals, "is_trace", False)
        if trace:
            tr_t = np.asarray(self.arrivals.times, float)
            keep = tr_t < self.horizon
            tr_t = tr_t[keep]
            tr_c = (
                None if self.arrivals.costs is None
                else np.asarray(self.arrivals.costs, float)[keep]
            )

        times_l, costs_l, speeds_l, act_l = [], [], [], []
        t, tr_i, dropped = 0.0, 0, 0
        while t < self.horizon:
            if getattr(self.arrivals, "is_homogeneous", False):
                gaps = rng.exponential(1.0 / self.rate, size=arrival_batch)
                times = t + np.cumsum(gaps)
            elif trace:
                if tr_i + arrival_batch > len(tr_t):
                    # trace exhausted: the run ends with the last FULL
                    # batch (serving turns have a fixed shape) — the
                    # partial tail is counted, never silently discarded
                    dropped = len(tr_t) - tr_i
                    break
                times = tr_t[tr_i:tr_i + arrival_batch].copy()
            else:
                # Ogata thinning off the compiled piecewise rate: candidate
                # jumps at λmax, accepted w.p. λ(t)/λmax — exact
                # nonhomogeneous-Poisson arrivals
                times = np.empty(arrival_batch)
                tt = t
                for i in range(arrival_batch):
                    while True:
                        tt += rng.exponential(1.0 / lam_max)
                        if rng.uniform() * lam_max < rate.at(tt):
                            break
                    times[i] = tt
            t = float(times[-1])
            if trace and tr_c is not None:
                costs = self.request_cost * tr_c[tr_i:tr_i + arrival_batch]
            else:
                costs = self.request_cost * rng.exponential(
                    1.0, size=arrival_batch
                )
            tr_i += arrival_batch
            times_l.append(times)
            costs_l.append(costs)
            speeds_l.append(cap_at(t))
            if act_bp is not None:
                act_l.append(act_at(t))

        if not times_l:
            z = np.zeros((0, arrival_batch))
            return ServingWorkload(z, z, np.zeros((0, n)), None, None, None,
                                   shifts, dropped)

        times = np.stack(times_l)
        costs = np.stack(costs_l)
        speeds = np.stack(speeds_l)
        active = rejoin = burst = None
        if act_bp is not None:
            active = np.stack(act_l)
            prev = np.concatenate([active[:1], active[:-1]], axis=0)
            rejoin = active & ~prev  # turn 0 has no rejoin edge
            # probe-burst targets: each rejoined worker repeated
            # ``probe_burst`` times, -1 padded to the widest turn
            per_turn = rejoin.sum(axis=1) * self.probe_burst
            bc = int(per_turn.max())
            burst = np.full((len(times_l), max(bc, 0)), -1, np.int32)
            for ti in np.nonzero(per_turn)[0]:
                ids = np.repeat(np.nonzero(rejoin[ti])[0], self.probe_burst)
                burst[ti, :len(ids)] = ids
        kill_at = stall_at = stall_dur = None
        if flt is not None:
            # fault events land on the first turn whose end time reaches
            # the fault instant (that turn's fault pass sees every entry
            # the fault could touch); events past the last turn end fall
            # outside the simulated window
            T = len(times_l)
            t_end = times[:, -1]
            ft0, ft1, fw, fkind = flt
            kill_at = np.full((T, n), np.inf)
            stall_at = np.full((T, n), np.inf)
            stall_dur = np.zeros((T, n))
            for i in range(len(ft0)):
                ti = int(np.searchsorted(t_end, ft0[i], side="left"))
                if ti >= T:
                    continue
                if fkind[i] == prc.FAULT_CRASH:
                    kill_at[ti, fw[i]] = ft0[i]
                else:
                    stall_at[ti, fw[i]] = ft0[i]
                    stall_dur[ti, fw[i]] = ft1[i] - ft0[i]
        return ServingWorkload(times, costs, speeds, active, rejoin, burst,
                               shifts, dropped, kill_at=kill_at,
                               stall_at=stall_at, stall_dur=stall_dur)

    # -- simulator compile --------------------------------------------------

    def to_sim(self, policy: str, *, rounds: int = 120_000, seed: int = 0,
               **cfg_kw):
        """Compile for the chain simulator: ``(SimConfig, SimParams, env)``.
        The chain simulator is not ported yet: raises."""
        del policy, rounds, seed, cfg_kw
        raise NotImplementedError(
            f"Scenario.to_sim ({self.name!r}): the chain simulator is not "
            f"ported yet (ROADMAP queue A, A8)")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

SCENARIOS: dict = {}


def register(name: str):
    """Decorator: register a scenario factory under ``name``. The factory
    takes keyword overrides and returns a ``Scenario``."""

    def deco(fn):
        SCENARIOS[name] = fn
        return fn

    return deco


def make(name: str, **overrides) -> Scenario:
    """Instantiate a registered scenario: ``env.make("flash_crowd")``,
    ``env.make("churn_heavy", horizon=900.0)``, …"""
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {sorted(SCENARIOS)}"
        )
    return SCENARIOS[name](**overrides)


def names() -> list:
    return sorted(SCENARIOS)


# ---------------------------------------------------------------------------
# Builtin catalog
# ---------------------------------------------------------------------------

#: The shared baseline cluster of the serving examples
#: (examples/volatile_cluster.py): two fast, two medium, one slow replica.
BASE_SPEEDS = (2.0, 2.0, 1.0, 1.0, 0.5)
BASE_RATE = 3.0
BASE_HORIZON = 360.0


def _base(name, desc, **kw):
    args = dict(name=name, speeds=BASE_SPEEDS, rate=BASE_RATE,
                horizon=BASE_HORIZON, description=desc)
    args.update(kw)
    return Scenario(**args)


@register("null")
def _null(**kw):
    return _base(
        "null",
        "Homogeneous Poisson, static speeds, no churn — bit-exact to the "
        "pre-env run_simulation/simulate (the parity anchor).",
        **kw,
    )


@register("reshuffle")
def _reshuffle(period: float = 60.0, **kw):
    return _base(
        "reshuffle",
        "Fig-11 volatility: speeds randomly permuted every period; total "
        "capacity constant (learning transients only).",
        capacity=prc.Reshuffle(period=period),
        **kw,
    )


@register("flash_crowd")
def _flash_crowd(burst_factor: float = 4.0, **kw):
    return _base(
        "flash_crowd",
        "MMPP bursty arrivals: calm epochs at the base rate punctuated by "
        "short flash crowds at burst_factor x (transient overload).",
        arrivals=prc.MMPP(factors=(1.0, burst_factor), dwell=(45.0, 9.0)),
        **kw,
    )


@register("diurnal")
def _diurnal(**kw):
    return _base(
        "diurnal",
        "Sinusoidal day/night arrival wave (+-60% around the base rate).",
        arrivals=prc.Diurnal(period=120.0, depth=0.6),
        **kw,
    )


@register("cotenant_shock")
def _cotenant(**kw):
    return _base(
        "cotenant_shock",
        "Paper Fig. 2 / examples/volatile_cluster.py: a co-tenant batch "
        "job halves replicas 0-1 on [120, 240).",
        capacity=prc.OnOffInterference(
            affected=(0, 1), factor=0.5, t_on=120.0, t_off=240.0
        ),
        **kw,
    )


@register("speed_drift")
def _drift(**kw):
    return _base(
        "speed_drift",
        "Mean-reverting OU log-speed drift (sigma=0.3, tau=60s): slow "
        "environmental wander instead of discrete shocks.",
        capacity=prc.OUDrift(sigma=0.3, tau=60.0, dt=10.0),
        **kw,
    )


@register("churn")
def _churn(**kw):
    return _base(
        "churn",
        "One worker leaves and rejoins: replica 1 offline on [120, 240) — "
        "the minimal membership scenario (examples/churn_cluster.py).",
        membership=prc.ChurnSchedule(
            events=((120.0, 1, False), (240.0, 1, True))
        ),
        **kw,
    )


@register("churn_heavy")
def _churn_heavy(**kw):
    return _base(
        "churn_heavy",
        "Random churn: every non-anchor worker alternates Exp(90s) online "
        "/ Exp(30s) offline epochs; worker 0 never leaves.",
        membership=prc.RandomChurn(mean_up=90.0, mean_down=30.0, anchor=0),
        **kw,
    )


@register("crash_storm")
def _crash_storm(mttf: float = 110.0, mean_down: float = 35.0, **kw):
    return _base(
        "crash_storm",
        "Random crashes: every non-anchor worker fails ~Exp(mttf=110s), "
        "killing its in-flight tasks, and recovers ~Exp(35s) later with a "
        "cold learner; worker 0 never crashes.",
        faults=prc.RandomFaults(
            mttf=mttf, mean_down=mean_down, kind="crash", anchor=0
        ),
        **kw,
    )


@register("blackout")
def _blackout(**kw):
    return _base(
        "blackout",
        "Two scheduled blackouts: worker 0 (fast) freezes on [120, 165), "
        "worker 2 on [200, 245) — in-flight tasks stall the full window "
        "and complete late; nothing is lost.",
        faults=prc.FaultSchedule(
            events=((120.0, 0, 45.0, "blackout"), (200.0, 2, 45.0, "blackout"))
        ),
        **kw,
    )


@register("grey_failure")
def _grey_failure(factor: float = 0.05, **kw):
    return _base(
        "grey_failure",
        "Degraded mode (grey failure): replicas 0-1 collapse to 5% speed "
        "on [120, 240) but STAY members — tasks placed there crawl, and "
        "only the recovery layer's timeouts rescue them.",
        capacity=prc.OnOffInterference(
            affected=(0, 1), factor=factor, t_on=120.0, t_off=240.0
        ),
        **kw,
    )


@register("trace_replay")
def _trace_replay(trace_seed: int = 0, **kw):
    kw.setdefault("horizon", BASE_HORIZON)
    kw.setdefault("rate", BASE_RATE)
    return _base(
        "trace_replay",
        "TPC-H-style trace replay (fig9 machinery: 1..4-task stage widths "
        "folded into request costs); the trace owns times AND costs.",
        arrivals=prc.TraceArrivals.tpch(
            kw["horizon"], kw["rate"], seed=trace_seed
        ),
        **kw,
    )
