"""Environment processes — the pure building blocks of cluster scenarios.

The port's own copy of the JAX package's ``repro.env.processes`` (numpy
only, unchanged): the port imports nothing of that package, and compiled
workloads are held ``array_equal`` to the reference's
(tests/test_torch_env.py).

A scenario (``env/scenario.py``) composes three independent axes, each a
pure process of time compiled once per run (host-side numpy, seeded):

  * **arrival processes** — λ(t): homogeneous Poisson (today's behavior),
    MMPP regime-switching flash crowds, diurnal sinusoids, and trace
    replay (CSV or the synthesized TPC-H-style trace reusing the fig9
    workload machinery). Every process reduces to a piecewise-constant
    rate (``PiecewiseRate``), which is exactly what both execution
    substrates consume: the chain simulator thins uniformized arrival
    jumps by λ(t)/λmax, and the serving workload generator draws arrival
    times by Ogata thinning off the same rate path (trace replay skips
    sampling and emits its times verbatim).

  * **capacity processes** — μ(t): static, explicit step schedules (the
    pre-env ``speed_schedule`` as a special case), periodic on/off
    co-tenant interference (the Fig. 2 story in
    ``examples/volatile_cluster.py``), mean-reverting OU speed drift, and
    the Fig-11 permutation reshuffle. All compile to
    ``(breakpoints[K], speeds[K, n])``.

  * **membership processes** — worker churn: an active-mask schedule
    ``(breakpoints[M], active[M, n])`` taking backends offline/online
    mid-run, from an explicit event list or random alternating up/down
    epochs (with an anchor worker that never leaves, so the cluster is
    never empty).

Everything here is plain numpy and deterministic given (process, seed):
the scan-compiled serving loop, the host serving loop and the chain
simulator all consume the SAME compiled arrays, which is what makes
cross-layer parity testable per scenario.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: Fake-job probe burst dispatched at a worker that rejoins the cluster —
#: the learner's exploration kick (paper §5: fake jobs keep estimates
#: fresh; a rejoining worker is a cold estimate by construction).
PROBE_BURST = 4


def piecewise_at(bp: np.ndarray, vals: np.ndarray, t):
    """Value of a piecewise-constant process at time(s) ``t``: segment i
    covers [bp[i], bp[i+1]), the last segment is open-ended. The ONE
    host-side lookup every consumer shares (the reference's chain simulator
    has a traced twin, ``simulator._env_seg``)."""
    i = np.clip(np.searchsorted(bp, t, side="right") - 1, 0, len(bp) - 1)
    return vals[i]


@dataclasses.dataclass(frozen=True)
class PiecewiseRate:
    """Piecewise-constant λ(t): segment i on [bp[i], bp[i+1]), last open."""

    bp: np.ndarray  # f64[K] segment start times, bp[0] == 0
    val: np.ndarray  # f64[K] rate per segment

    def at(self, t) -> np.ndarray:
        return piecewise_at(self.bp, self.val, t)

    @property
    def max(self) -> float:
        return float(np.max(self.val))


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HomogeneousPoisson:
    """Constant-rate Poisson arrivals — the null process. The serving
    workload generator special-cases it to the exact pre-env RandomState
    draw sequence (``rng.exponential(1/λ, size=batch)`` per turn), which
    is what keeps the null scenario bit-exact to ``run_simulation``."""

    is_homogeneous = True
    is_trace = False
    shift_like = False  # constant: no discrete shifts, no drift

    def compile_rate(self, base_rate: float, horizon: float,
                     rng: np.random.RandomState) -> PiecewiseRate:
        del horizon, rng
        return PiecewiseRate(np.zeros(1), np.full(1, float(base_rate)))


@dataclasses.dataclass(frozen=True)
class MMPP:
    """Markov-modulated Poisson process — regime-switching arrivals.

    Regimes cycle (0 → 1 → … → 0) with exponential dwell times; regime r
    runs at ``base_rate · factors[r]``. The canonical flash crowd is two
    regimes, factors (1, 4): long calm epochs punctuated by short bursts
    several times the provisioned rate (Decima/Sparrow-style trace
    generators model exactly this burstiness). The regime path is drawn
    ONCE at compile time from the scenario's env stream, so all three
    execution layers see the same bursts at the same times.
    """

    factors: tuple = (1.0, 4.0)
    dwell: tuple = (45.0, 9.0)  # mean dwell time per regime
    is_homogeneous = False
    is_trace = False
    shift_like = True  # discrete regime switches at the compiled bps

    def compile_rate(self, base_rate, horizon, rng) -> PiecewiseRate:
        t, r = 0.0, 0
        bps, vals = [0.0], [base_rate * self.factors[0]]
        while t < horizon:
            t += float(rng.exponential(self.dwell[r]))
            r = (r + 1) % len(self.factors)
            bps.append(t)
            vals.append(base_rate * self.factors[r])
        return PiecewiseRate(np.asarray(bps), np.asarray(vals))


@dataclasses.dataclass(frozen=True)
class Diurnal:
    """Sinusoidal day/night wave: λ(t) = base · (1 + depth·sin(2πt/period)),
    discretized to ``bins_per_period`` piecewise segments (both execution
    layers consume piecewise rates; 32 bins keep the discretization error
    under 2% of the swing)."""

    period: float = 120.0
    depth: float = 0.6
    bins_per_period: int = 32
    is_homogeneous = False
    is_trace = False
    shift_like = False  # continuous drift — bps are discretization, not shifts

    def compile_rate(self, base_rate, horizon, rng) -> PiecewiseRate:
        del rng
        step = self.period / self.bins_per_period
        bps = np.arange(0.0, horizon + step, step)
        mid = bps + step / 2
        vals = base_rate * (1.0 + self.depth * np.sin(2 * np.pi * mid / self.period))
        return PiecewiseRate(bps, np.maximum(vals, 1e-6))


def synthesize_tpch_trace(horizon: float, rate: float, seed: int = 0,
                          max_tasks: int = 4,
                          task_probs=(0.4, 0.3, 0.2, 0.1)):
    """A TPC-H-style request trace — the fig9 workload machinery
    (multi-task Shark stages, §6.1) flattened into a serving trace.

    Arrivals are Poisson at ``rate`` JOBS/s; each job carries a stage
    width k ~ ``task_probs`` (fig9's 1..4-task mix) and its request cost
    is k · Exp(1) — a k-task stage is k units of work routed as one
    request. Returns (times[f64], costs[f64]); deterministic in ``seed``.
    """
    rng = np.random.RandomState(seed)
    p = np.asarray(task_probs, float)
    p = p / p.sum()
    est = int(np.ceil(rate * horizon * 1.5)) + 64
    gaps = rng.exponential(1.0 / rate, size=est)
    times = np.cumsum(gaps)
    times = times[times < horizon]
    k = rng.choice(np.arange(1, max_tasks + 1), size=len(times), p=p)
    costs = k * rng.exponential(1.0, size=len(times))
    return times, costs


@dataclasses.dataclass(frozen=True)
class TraceArrivals:
    """Replay an explicit request trace: arrival times (and optionally
    per-request costs — a trace that carries costs OWNS the cost stream;
    otherwise costs are drawn like any other scenario's).

    For the chain simulator (which needs a rate, not timestamps) the
    trace compiles to its binned empirical rate — an honest piecewise
    approximation, documented as such; the serving layers replay the
    timestamps verbatim.
    """

    times: tuple  # arrival timestamps (sorted)
    costs: tuple | None = None  # optional per-request costs
    is_homogeneous = False
    is_trace = True
    shift_like = False  # empirical rate bins carry no shift semantics

    @classmethod
    def from_arrays(cls, times, costs=None) -> "TraceArrivals":
        t = np.asarray(times, float)
        order = np.argsort(t, kind="stable")
        c = None if costs is None else tuple(np.asarray(costs, float)[order])
        return cls(times=tuple(t[order]), costs=c)

    @classmethod
    def from_csv(cls, path: str, time_col: int = 0,
                 cost_col: int | None = 1,
                 chunk_rows: int = 262_144) -> "TraceArrivals":
        """Load a trace CSV in ``chunk_rows``-sized pieces (the file is
        never whole-file-read, so multi-GB traces load at a bounded RSS)
        and VALIDATE monotone timestamps instead of silently re-sorting:
        a trace whose clock runs backwards is a corrupt trace, and the
        error names the offending row so it can be fixed at the source."""
        t_chunks: list = []
        c_chunks: list = []
        have_cost = cost_col is not None
        row0 = 0
        prev_last = -np.inf
        with open(path) as f:
            while True:
                try:
                    import warnings

                    with warnings.catch_warnings():
                        # EOF on the incremental handle is the loop's
                        # normal exit, not a user-facing condition
                        warnings.filterwarnings(
                            "ignore", message=".*input contained no data.*")
                        raw = np.loadtxt(f, delimiter=",", ndmin=2,
                                         max_rows=chunk_rows)
                except ValueError as e:
                    raise ValueError(
                        f"{path}: malformed CSV near row {row0} "
                        f"(rows are 0-indexed): {e}"
                    ) from e
                if raw.size == 0:
                    break
                t = np.asarray(raw[:, time_col], float)
                prev = np.concatenate(([prev_last], t[:-1]))
                bad = np.nonzero(t < prev)[0]
                if bad.size:
                    i = int(bad[0])
                    raise ValueError(
                        f"{path}: non-monotone timestamp at row {row0 + i}: "
                        f"t={t[i]!r} after t={prev[i]!r} — trace rows must "
                        f"be sorted by arrival time"
                    )
                prev_last = t[-1]
                t_chunks.append(t)
                if have_cost and raw.shape[1] > cost_col:
                    c_chunks.append(np.asarray(raw[:, cost_col], float))
                else:
                    have_cost = False
                row0 += len(t)
        if not t_chunks:
            return cls(times=(), costs=None)
        times = np.concatenate(t_chunks)
        costs = np.concatenate(c_chunks) if have_cost and c_chunks else None
        return cls(times=tuple(times),
                   costs=None if costs is None else tuple(costs))

    @classmethod
    def tpch(cls, horizon: float, rate: float, seed: int = 0) -> "TraceArrivals":
        return cls.from_arrays(*synthesize_tpch_trace(horizon, rate, seed))

    def compile_rate(self, base_rate, horizon, rng, bins: int = 32) -> PiecewiseRate:
        del base_rate, rng
        t = np.asarray(self.times, float)
        t = t[t < horizon]
        if not len(t):
            return PiecewiseRate(np.zeros(1), np.full(1, 1e-6))
        edges = np.linspace(0.0, horizon, bins + 1)
        counts, _ = np.histogram(t, bins=edges)
        vals = counts / (horizon / bins)
        return PiecewiseRate(edges[:-1], np.maximum(vals, 1e-6))


# ---------------------------------------------------------------------------
# Capacity processes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StaticCapacity:
    """Speeds never change — the null capacity process."""

    is_static = True
    shift_like = False

    def compile(self, speeds0, horizon, rng):
        del horizon, rng
        s = np.asarray(speeds0, float)
        return np.zeros(1), s[None, :].copy()


@dataclasses.dataclass(frozen=True)
class StepSchedule:
    """Explicit (t, speeds) steps — the pre-env ``speed_schedule`` list as
    a first-class process (entries in time order)."""

    entries: tuple  # ((t, speeds), ...)
    is_static = False
    shift_like = True  # every entry is a discrete capacity shift

    def compile(self, speeds0, horizon, rng):
        del horizon, rng
        bps = [0.0]
        vals = [np.asarray(speeds0, float)]
        for t, s in self.entries:
            bps.append(float(t))
            vals.append(np.asarray(s, float))
        return np.asarray(bps), np.stack(vals)


@dataclasses.dataclass(frozen=True)
class OnOffInterference:
    """Co-tenant interference à la ``examples/volatile_cluster.py`` /
    paper Fig. 2: during [t_on, t_off) (repeating every ``period`` when
    set) the ``affected`` workers run at ``factor`` of their speed."""

    affected: tuple  # worker indices sharing hosts with the co-tenant
    factor: float = 0.5
    t_on: float = 120.0
    t_off: float = 240.0
    period: float | None = None
    is_static = False
    shift_like = True  # on/off edges are discrete capacity shifts

    def compile(self, speeds0, horizon, rng):
        del rng
        if self.period is not None and self.period <= self.t_off - self.t_on:
            # overlapping repeats would emit non-monotonic breakpoints and
            # silently corrupt every downstream searchsorted lookup
            raise ValueError(
                f"OnOffInterference: period={self.period} must exceed the "
                f"window length t_off-t_on={self.t_off - self.t_on} "
                "(overlapping interference windows)"
            )
        s0 = np.asarray(speeds0, float)
        hit = s0.copy()
        hit[list(self.affected)] *= self.factor
        bps, vals = [0.0], [s0]
        start, stop, k = self.t_on, self.t_off, 0
        while start < horizon:
            bps += [start, stop]
            vals += [hit, s0]
            if self.period is None:
                break
            k += 1
            start = self.t_on + k * self.period
            stop = self.t_off + k * self.period
        return np.asarray(bps), np.stack(vals)


@dataclasses.dataclass(frozen=True)
class OUDrift:
    """Mean-reverting log-speed drift: every ``dt`` the log-speed offsets
    follow an Ornstein-Uhlenbeck step x ← x·e^(−dt/τ) + σ√(1−e^(−2dt/τ))·N
    (stationary std σ, correlation time τ). Models slow environmental
    wander — thermal throttling, noisy neighbors coming and going —
    rather than discrete shocks."""

    sigma: float = 0.3
    tau: float = 60.0
    dt: float = 10.0
    is_static = False
    shift_like = False  # continuous wander — dt steps are not shift events

    def compile(self, speeds0, horizon, rng):
        s0 = np.asarray(speeds0, float)
        n = len(s0)
        K = int(np.ceil(horizon / self.dt)) + 1
        decay = np.exp(-self.dt / self.tau)
        kick = self.sigma * np.sqrt(1.0 - decay**2)
        x = np.zeros(n)
        vals = [s0.copy()]
        for _ in range(K - 1):
            x = x * decay + kick * rng.standard_normal(n)
            vals.append(s0 * np.exp(x))
        return np.arange(K) * self.dt, np.stack(vals)


@dataclasses.dataclass(frozen=True)
class Reshuffle:
    """Fig-11 volatility: randomly permute the speed set every ``period``
    (total capacity constant — the paper's learning-transient design)."""

    period: float = 60.0
    is_static = False
    shift_like = True  # each permutation instant is a capacity shift

    def compile(self, speeds0, horizon, rng):
        s0 = np.asarray(speeds0, float)
        K = int(np.ceil(horizon / self.period)) + 1
        vals = [s0.copy()] + [rng.permutation(s0) for _ in range(K - 1)]
        return np.arange(K) * self.period, np.stack(vals)


# ---------------------------------------------------------------------------
# Membership processes (worker churn)
# ---------------------------------------------------------------------------


def _events_to_masks(n: int, events) -> tuple[np.ndarray, np.ndarray]:
    """Fold sorted (t, worker, up) events into stepwise active masks."""
    bps = [0.0]
    masks = [np.ones(n, bool)]
    for t, w, up in sorted(events, key=lambda e: e[0]):
        m = masks[-1].copy()
        m[int(w)] = bool(up)
        if t == bps[-1]:
            masks[-1] = m  # coincident events merge into one segment
        else:
            bps.append(float(t))
            masks.append(m)
    return np.asarray(bps), np.stack(masks)


@dataclasses.dataclass(frozen=True)
class ChurnSchedule:
    """Explicit churn: ``events`` = ((t, worker, up), ...) — worker leaves
    (up=False) or rejoins (up=True) at time t. Everyone starts online."""

    events: tuple
    is_none = False

    def compile(self, n, horizon, rng):
        del horizon, rng
        return _events_to_masks(n, self.events)


@dataclasses.dataclass(frozen=True)
class RandomChurn:
    """Stochastic churn: each non-anchor worker alternates online epochs
    ~ Exp(mean_up) and offline epochs ~ Exp(mean_down). Worker ``anchor``
    never leaves, so the cluster is never empty (and μ̄ > 0 always)."""

    mean_up: float = 90.0
    mean_down: float = 30.0
    anchor: int = 0
    is_none = False

    def compile(self, n, horizon, rng):
        events = []
        for w in range(n):
            if w == self.anchor:
                continue
            t = float(rng.exponential(self.mean_up))
            up = False  # first event takes the worker down
            while t < horizon:
                events.append((t, w, up))
                t += float(rng.exponential(
                    self.mean_up if up else self.mean_down
                ))
                up = not up
        if not events:
            return np.zeros(1), np.ones((1, n), bool)
        return _events_to_masks(n, events)


# ---------------------------------------------------------------------------
# Fault processes (crash / blackout)
# ---------------------------------------------------------------------------
#
# Faults are the VIOLENT end of the membership axis. Graceful churn
# (ChurnSchedule / RandomChurn) is a drain: a departing worker stops
# receiving NEW placements but finishes what it holds. A **crash**
# (FAULT_CRASH) kills everything in flight on the worker at the fault
# instant and takes it offline until recovery. A **blackout**
# (FAULT_BLACKOUT) freezes the worker for its duration — in-flight tasks
# stall and complete ``duration`` late, nothing is lost. Both kinds also
# contribute an offline window [t0, t1) to the membership mask, so the
# existing rejoin machinery (probe burst + learner cold-start) covers
# fault recovery for free. "Degraded" / grey-failure mode needs no new
# process: it is a capacity collapse (``OnOffInterference`` with a factor
# near zero) where the worker stays a member but barely serves — the
# recovery layer's timeouts are what rescue tasks stuck on it.

FAULT_CRASH = 0
FAULT_BLACKOUT = 1

_FAULT_KINDS = {"crash": FAULT_CRASH, "blackout": FAULT_BLACKOUT}


def _pack_fault_events(events):
    """Sort raw (t0, t1, worker, kind) tuples into the compiled arrays
    every consumer shares: ``(t0 f64[E], t1 f64[E], w i32[E], kind i32[E])``
    ordered by fault instant (ties by worker, for determinism)."""
    ev = sorted(events, key=lambda e: (e[0], e[2]))
    t0 = np.asarray([e[0] for e in ev], float)
    t1 = np.asarray([e[1] for e in ev], float)
    w = np.asarray([e[2] for e in ev], np.int32)
    kind = np.asarray([e[3] for e in ev], np.int32)
    return t0, t1, w, kind


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Explicit faults: ``events`` = ((t, worker, duration, kind), ...)
    with kind in {"crash", "blackout"} — worker ``worker`` faults at time
    ``t`` and recovers at ``t + duration``."""

    events: tuple

    def compile(self, n, horizon, rng):
        del rng
        out = []
        for t, w, dur, kind in self.events:
            if kind not in _FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
            if not 0 <= int(w) < n:
                raise ValueError(f"fault worker {w} out of range [0, {n})")
            if float(t) < horizon:
                out.append((float(t), float(t) + float(dur), int(w),
                            _FAULT_KINDS[kind]))
        return _pack_fault_events(out)


@dataclasses.dataclass(frozen=True)
class RandomFaults:
    """Stochastic faults: each non-anchor worker draws time-to-failure
    ~ Exp(mttf) and downtime ~ Exp(mean_down), repeating after recovery
    (per-worker fault windows never overlap). ``anchor`` never faults, so
    the cluster always keeps at least one live worker."""

    mttf: float = 120.0
    mean_down: float = 30.0
    kind: str = "crash"
    anchor: int = 0

    def compile(self, n, horizon, rng):
        if self.kind not in _FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        kd = _FAULT_KINDS[self.kind]
        events = []
        for w in range(n):
            if w == self.anchor:
                continue
            t = float(rng.exponential(self.mttf))
            while t < horizon:
                down = float(rng.exponential(self.mean_down))
                events.append((t, t + down, w, kd))
                t = t + down + float(rng.exponential(self.mttf))
        return _pack_fault_events(events)


def fault_outage_masks(n: int, fault_ev) -> tuple[np.ndarray, np.ndarray]:
    """Compiled fault events → stepwise active masks (the outage windows):
    worker w is inactive on every [t0, t1) it faults in."""
    t0, t1, w, _kind = fault_ev
    events = []
    for i in range(len(t0)):
        events.append((float(t0[i]), int(w[i]), False))
        events.append((float(t1[i]), int(w[i]), True))
    if not events:
        return np.zeros(1), np.ones((1, n), bool)
    return _events_to_masks(n, events)


def and_masks(a: tuple[np.ndarray, np.ndarray],
              b: tuple[np.ndarray, np.ndarray]):
    """AND two stepwise mask processes (membership ∧ fault outages):
    union of breakpoints, elementwise conjunction of the masks."""
    bp = np.union1d(np.asarray(a[0], float), np.asarray(b[0], float))
    va = piecewise_at(np.asarray(a[0], float), np.asarray(a[1]), bp)
    vb = piecewise_at(np.asarray(b[0], float), np.asarray(b[1]), bp)
    return bp, va & vb
