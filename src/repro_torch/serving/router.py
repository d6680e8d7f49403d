"""Rosella serving router and its closed-loop simulation harness.

N replicas of one service run at different speeds; the router is the
Rosella scheduler in front of them. Each turn (``serve_turn``) flushes the
due completions into the learner, draws benchmark requests and routes one
arrival batch through the dispatch engine (``core.scheduler.serve_step``).

μ̂ is double-buffered: routing reads the front snapshot ``mu_front`` (and
its alias table ``table_front``), while each completion fold produces a
refreshed μ̂ that becomes the front only once it has materialised. On a
CUDA device "materialised" is a ``torch.cuda.Event`` recorded after the
fold, queried without blocking; on the CPU it always is. A flip is the
only event that rebuilds the alias table. ``async_mu=False`` routes on the
fresh μ̂ of every flush instead, the deterministic mode.

``run_simulation`` moves every arrival batch as arrays end to end:
Poisson arrivals, one ``serve_turn``, replica execution in
``SimulatedPool.submit_batch`` and completion flushing, with one μ̂ sample
per batch.

``ReferenceRouter`` + ``run_simulation_reference`` are the per-request
baseline: Python ``Request``/``Completion`` objects, a heap of pending
events, every call synchronous through ``core.scheduler.RosellaScheduler``.
They draw the same streams as ``RosellaRouter`` + ``run_simulation`` in the
deterministic mode (``async_mu=False, use_alias=False``), so on a
``SequentialPool`` the two give the same responses.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.core import dispatch as dsp
from repro_torch.core import estimator as est
from repro_torch.core import learner as lrn
from repro_torch.core import policies as pol
from repro_torch.core import scheduler as rs
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    tokens: np.ndarray | None = None
    n_decode: int = 8  # decode steps the request needs
    fake: bool = False


@dataclasses.dataclass
class Completion:
    rid: int
    replica: int
    t_start: float
    t_done: float
    fake: bool = False

    @property
    def service_time(self) -> float:
        return self.t_done - self.t_start


class SimulatedPool:
    """Replica pool with fixed speeds: a request of cost c takes c/s
    seconds on a replica of speed s, queued FIFO behind earlier ones."""

    def __init__(self, speeds):
        self.speeds = np.asarray(speeds, float)
        self.free_at = np.zeros(len(speeds))

    def submit(self, replica: int, req: Request, now: float, cost: float) -> Completion:
        """One request: ``start = max(now, free_at); done = start + cost/speed``."""
        start = max(now, self.free_at[replica])
        done = start + cost / self.speeds[replica]
        self.free_at[replica] = done
        return Completion(req.rid, replica, start, done, fake=req.fake)

    def submit_batch(self, replicas, arrivals, costs):
        """(t_start[k], t_done[k]) for a request batch.

        Per replica the queue chains ``start_i = max(arrival_i, done_{i-1})``,
        a running max with a closed form: with cumulative durations c,
        ``done = c + cummax(lead - c_shifted)``. Arrivals are nondecreasing
        per replica (batches arrive in time order). Only the replicas the
        batch reaches are visited.
        """
        replicas = np.asarray(replicas, np.int64)
        arrivals = np.asarray(arrivals, float)
        costs = np.asarray(costs, float)
        starts = np.empty_like(arrivals)
        dones = np.empty_like(arrivals)
        for r in np.unique(replicas):
            m = replicas == r
            dur = costs[m] / self.speeds[r]
            c = np.cumsum(dur)
            lead = arrivals[m].copy()
            lead[0] = max(lead[0], self.free_at[r])
            done = c + np.maximum.accumulate(lead - np.concatenate(([0.0], c[:-1])))
            dones[m] = done
            starts[m] = done - dur
            self.free_at[r] = done[-1]
        return starts, dones

    def set_speeds(self, speeds):
        self.speeds = np.asarray(speeds, float)


class SequentialPool(SimulatedPool):
    """``SimulatedPool`` whose batch submit is the literal per-request
    recurrence ``start = max(arrival, free_at); done = start + cost/speed``
    (the closed form above agrees with it only to ~1e-12)."""

    def submit_batch(self, replicas, arrivals, costs):
        replicas = np.asarray(replicas, np.int64)
        starts = np.empty(len(replicas))
        dones = np.empty(len(replicas))
        for i, (r, a, c) in enumerate(zip(replicas, arrivals, costs)):
            start = max(a, self.free_at[r])
            done = start + c / self.speeds[r]
            self.free_at[r] = done
            starts[i], dones[i] = start, done
        return starts, dones


#: Fixed completion capacity of one serving turn (about 2x a typical
#: flush); a larger flush folds its oldest overflow first through
#: ``complete_arrays``, which leaves the same final state.
SERVE_COMP_CAP = 256
MAX_FAKE = 8


class RosellaRouter:
    """Host-side router over a device-resident scheduler state.

    ``device=None`` is the CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU. ``use_alias`` holds only for the
    policies that draw through an alias table (``dsp.ALIAS_POLICIES``);
    the others never build one.
    """

    def __init__(self, n_replicas: int, mu_bar: float, *, policy: str = pol.PPOT_SQ2,
                 c0: float = 0.1, c_window: float = 10.0, seed: int = 0,
                 async_mu: bool = True, use_alias: bool = True, device=None):
        self.device = resolve_device(device)
        self.n = n_replicas
        self.policy = policy
        self.async_mu = async_mu
        self.use_alias = use_alias and policy in dsp.ALIAS_POLICIES
        self.lcfg = lrn.default_learner_config(mu_bar, c0=c0, c_window=c_window)
        self.q_view = torch.zeros(n_replicas, dtype=torch.int32, device=self.device)
        self.arr = est.init_ema_arrival()
        self.learner = lrn.init_learner(n_replicas, self.lcfg, 1.0, self.device)
        self.mu_front = self.learner.mu_hat  # the routing snapshot
        self.active: torch.Tensor | None = None  # membership mask; None = all
        self.table_front = (
            dsp.build_alias_table(self.mu_front) if self.use_alias else None)
        self._mu_pending: torch.Tensor | None = None  # refreshed μ̂ in flight
        self._mu_event: torch.cuda.Event | None = None  # marks it materialised
        self.last_fake_time = 0.0
        self.key = prng.PRNGKey(seed)

    def _next_key(self):
        self.key, k = prng.split(self.key)
        return k

    def _set_pending(self):
        self._mu_pending = self.learner.mu_hat
        self._mu_event = None
        if self.device.type == "cuda":
            self._mu_event = torch.cuda.Event()
            self._mu_event.record(torch.cuda.current_stream(self.device))

    def _flip_mu(self):
        """Adopt the refreshed μ̂ iff it has materialised (always, with
        async_mu=False), and rebuild the alias table from it."""
        if self._mu_pending is None:
            return
        if self.async_mu and self._mu_event is not None and not self._mu_event.query():
            return
        self.mu_front = self._mu_pending
        self._mu_pending = None
        if self.use_alias:
            self.table_front = dsp.build_alias_table(self.mu_front, self.active)

    def set_membership(self, active, now: float, rejoin=None) -> np.ndarray:
        """Apply a cluster-membership change (worker churn).

        ``active`` (bool[n]) is the new membership. Workers that come back
        online (``rejoin``, inferred from the previous mask when not given)
        are cold-started in the learner and returned, so the caller can aim
        benchmark requests at them. The change is a forced μ̂ flip: the
        masked table is rebuilt here, so no later route reaches an offline
        replica.
        """
        act = np.asarray(active, bool)
        prev = None if self.active is None else self.active.cpu().numpy()
        if rejoin is None:
            rejoin = (act & ~prev) if prev is not None else np.zeros_like(act)
        rj = np.asarray(rejoin, bool)
        act_t = torch.from_numpy(act).to(self.device)
        if rj.any():
            self.learner = lrn.reset_workers(
                self.learner, torch.from_numpy(rj).to(self.device), now, act_t)
        self.active = act_t
        self.mu_front = self.learner.mu_hat
        self._mu_pending = None
        if self.use_alias:
            self.table_front = dsp.build_alias_table(self.mu_front, self.active)
        return np.nonzero(rj)[0]

    def route(self, now: float, k: int = 1) -> np.ndarray:
        """Route a batch of k requests in one dispatch-engine call."""
        self._flip_mu()
        workers, self.q_view, self.arr = rs.route_view(
            self.q_view, self.arr, self.mu_front, self._next_key(), now, k,
            self.policy, self.table_front, self.active)
        return workers.cpu().numpy()

    def serve_turn(self, now: float, k: int, comp_workers=None, comp_times=None,
                   comp_now: float | None = None) -> tuple[np.ndarray, np.ndarray]:
        """One serving turn: completion flush + benchmark draw + batch route
        (``scheduler.serve_step``). Returns (fake_workers, workers[k])."""
        self._flip_mu()
        comp_now = now if comp_now is None else comp_now
        nw = 0 if comp_workers is None else len(comp_workers)
        if nw > SERVE_COMP_CAP:
            cut = nw - SERVE_COMP_CAP
            self.complete_arrays(comp_workers[:cut], comp_times[:cut], comp_now)
            comp_workers, comp_times = comp_workers[cut:], comp_times[cut:]
            nw = SERVE_COMP_CAP
        w = np.full((SERVE_COMP_CAP,), -1, np.int32)
        ts = np.zeros((SERVE_COMP_CAP,), np.float32)
        if nw:
            w[:nw] = comp_workers
            ts[:nw] = comp_times
        fake_js, workers, self.q_view, self.learner, self.arr, self.key = rs.serve_step(
            self.q_view, self.learner, self.arr, self.mu_front, self.lcfg,
            self.key, w, ts, (now, self.last_fake_time, comp_now), k,
            self.policy, MAX_FAKE, not self.async_mu, self.table_front,
            self.use_alias, self.active)
        self.last_fake_time = float(now)
        if nw:
            self._set_pending()
        out = torch.cat([fake_js, workers]).cpu().numpy()  # one device sync
        fake_js = out[:MAX_FAKE]
        return fake_js[fake_js >= 0], out[MAX_FAKE:]

    def complete(self, completions: "list[Completion]"):
        """Fold a list of completions (``complete_arrays`` on their
        replicas and service times, at the latest completion time)."""
        if not completions:
            return
        workers = np.array([c.replica for c in completions], np.int32)
        times = np.array([c.service_time for c in completions], np.float32)
        now = max(c.t_done for c in completions)
        self.complete_arrays(workers, times, now)

    def complete_arrays(self, workers, service_times, now: float):
        """Fold a completion batch: queue-view drain, learner fold and
        refresh; the refreshed μ̂ becomes pending."""
        if len(workers) == 0:
            return
        self.q_view, self.learner = rs.complete_step(
            self.q_view, self.learner, self.lcfg, self.arr, workers,
            service_times, now)
        self._set_pending()

    def benchmark_requests(self, now: float) -> np.ndarray:
        js = rs.fake_jobs_from(
            self.lcfg, self._next_key(), est.lam_hat_ema(self.arr),
            np.float32(now) - np.float32(self.last_fake_time), MAX_FAKE, self.n,
            self.active, self.device).cpu().numpy()
        self.last_fake_time = float(now)
        return js[js >= 0]

    @property
    def mu_hat(self) -> np.ndarray:
        """Latest learner estimates (a device-to-host copy)."""
        return self.learner.mu_hat.cpu().numpy()


class ReferenceRouter:
    """The per-request baseline router: every call runs synchronously
    through ``RosellaScheduler`` (a completion batch is reported, then μ̂
    refreshed, before the next route), on the inverse-CDF stream."""

    def __init__(self, n_replicas: int, mu_bar: float, *, policy: str = pol.PPOT_SQ2,
                 c0: float = 0.1, c_window: float = 10.0, seed: int = 0, device=None):
        self.sched = rs.RosellaScheduler(n_replicas, mu_bar, c0=c0, c_window=c_window,
                                         seed=seed, device=device)
        self.policy = policy
        self.n = n_replicas

    def route(self, now: float, k: int = 1) -> np.ndarray:
        return self.sched.schedule(now, k, policy=self.policy).cpu().numpy()

    def complete(self, completions: "list[Completion]"):
        if not completions:
            return
        workers = np.array([c.replica for c in completions], np.int32)
        times = np.array([c.service_time for c in completions], np.float32)
        now = max(c.t_done for c in completions)
        self.sched.report(workers, times, now)

    def benchmark_requests(self, now: float) -> np.ndarray:
        js = self.sched.fake_jobs(now).cpu().numpy()
        return js[js >= 0]

    @property
    def mu_hat(self) -> np.ndarray:
        return self.sched.mu_hat.cpu().numpy()


def run_simulation_reference(
    router: ReferenceRouter,
    pool: SimulatedPool,
    *,
    arrival_rate: float,
    horizon: float,
    request_cost: float = 1.0,
    speed_schedule: "list[tuple[float, np.ndarray]] | None" = None,
    seed: int = 0,
    arrival_batch: int = 1,
):
    """The per-request event loop: ``Request``/``Completion`` objects, a
    heap of pending events, one ``pool.submit`` and one μ̂ copy per
    request. It draws ``run_simulation``'s streams (arrivals, costs, keys);
    completions flush oldest first, fakes before the batch's requests.
    Returns (response_times[R], mu_trace[R, n])."""
    rng = np.random.RandomState(seed)
    t, rid, seq = 0.0, 0, 0
    responses = []
    mu_trace = []
    pending: list = []  # (t_done, seq, Completion)
    sched_i = 0

    while t < horizon:
        gaps = rng.exponential(1.0 / arrival_rate, size=arrival_batch)
        times = t + np.cumsum(gaps)
        t = float(times[-1])
        if speed_schedule is not None:
            while sched_i < len(speed_schedule) and speed_schedule[sched_i][0] <= t:
                pool.set_speeds(speed_schedule[sched_i][1])
                sched_i += 1
        done_now = []
        while pending and pending[0][0] <= t:
            done_now.append(heapq.heappop(pending)[2])
        router.complete(done_now)

        for j in router.benchmark_requests(t):
            comp = pool.submit(int(j), Request(rid=-1, arrival=t, fake=True), t,
                               request_cost * 0.25)
            heapq.heappush(pending, (comp.t_done, seq, comp))
            seq += 1

        js = router.route(t, arrival_batch)
        for ti, j in zip(times, js):
            req = Request(rid=rid, arrival=float(ti))
            rid += 1
            comp = pool.submit(int(j), req, float(ti), request_cost * rng.exponential(1.0))
            heapq.heappush(pending, (comp.t_done, seq, comp))
            seq += 1
            responses.append(comp.t_done - float(ti))
            mu_trace.append(router.mu_hat.copy())

    return np.asarray(responses), np.asarray(mu_trace)


def run_simulation(
    router: RosellaRouter,
    pool: SimulatedPool,
    *,
    arrival_rate: float,
    horizon: float,
    request_cost: float = 1.0,
    speed_schedule: "list[tuple[float, np.ndarray]] | None" = None,
    seed: int = 0,
    arrival_batch: int = 1,
):
    """Closed-loop serving simulation: Poisson arrivals, Rosella routing,
    completion telemetry fed back. Returns (response_times[R],
    mu_trace[T, n]) with μ̂ (the routing snapshot) sampled once per arrival
    batch. ``speed_schedule``: [(t, speeds), ...] volatility."""
    rng = np.random.RandomState(seed)
    t = 0.0
    responses: list[np.ndarray] = []
    mu_trace: list[np.ndarray] = []
    p_done = np.empty(0)
    p_rep = np.empty(0, np.int32)
    p_start = np.empty(0)
    sched_i = 0

    while t < horizon:
        gaps = rng.exponential(1.0 / arrival_rate, size=arrival_batch)
        times = t + np.cumsum(gaps)
        t = float(times[-1])
        if speed_schedule is not None:
            while sched_i < len(speed_schedule) and speed_schedule[sched_i][0] <= t:
                pool.set_speeds(speed_schedule[sched_i][1])
                sched_i += 1

        # completions that happened before this batch, oldest first
        due = p_done <= t
        comp_w = comp_t = None
        comp_now = t
        if due.any():
            order = np.argsort(p_done[due], kind="stable")
            comp_w = p_rep[due][order]
            comp_t = (p_done - p_start)[due][order]
            comp_now = float(p_done[due].max())
            keep = ~due
            p_done, p_rep, p_start = p_done[keep], p_rep[keep], p_start[keep]

        fake_js, js = router.serve_turn(t, arrival_batch, comp_w, comp_t, comp_now)
        if len(fake_js):
            fs, fd = pool.submit_batch(
                fake_js, np.full(len(fake_js), t),
                np.full(len(fake_js), request_cost * 0.25))
            p_done = np.concatenate([p_done, fd])
            p_rep = np.concatenate([p_rep, fake_js.astype(np.int32)])
            p_start = np.concatenate([p_start, fs])
        costs = request_cost * rng.exponential(1.0, size=arrival_batch)
        ss, dd = pool.submit_batch(js, times, costs)
        responses.append(dd - times)
        p_done = np.concatenate([p_done, dd])
        p_rep = np.concatenate([p_rep, js.astype(np.int32)])
        p_start = np.concatenate([p_start, ss])
        mu_trace.append(router.mu_front.cpu().numpy())

    resp = np.concatenate(responses) if responses else np.empty(0)
    return resp, np.asarray(mu_trace)
