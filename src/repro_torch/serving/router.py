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

``FleetRouter`` runs S such routers over one replica pool, each routing its
share of the arrivals against its own stale queue view, reconciled every
``sync_every`` turns (``sync``: views rebuilt from per-frontend deltas, μ̂
merged, λ̂ streams summed); ``run_fleet_simulation`` is its closed loop,
bit-equal to ``run_simulation`` at S = 1 with ``async_mu=False``.

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
from repro_torch.fleet import conflict as cfl
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
        rj_ids = self._apply_membership(active, now, rejoin)
        self.mu_front = self.learner.mu_hat
        self._mu_pending = None
        if self.use_alias:
            self.table_front = dsp.build_alias_table(self.mu_front, self.active)
        return rj_ids

    def _apply_membership(self, active, now: float, rejoin=None) -> np.ndarray:
        """The membership change without its flip: the mask adopted and the
        rejoined workers cold-started in the learner (their ids returned).
        ``set_membership`` adds the flip; ``FleetRouter.sync`` runs this on
        every frontend and flips them all to one merged table."""
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
        return self._serve(now, k, comp_workers, comp_times, comp_now)

    def serve_turn_recovery(self, now: float, k: int, comp_workers=None, comp_times=None,
                            comp_now: float | None = None, retry_cap: int = 0,
                            retry_slots=None) -> tuple[np.ndarray, np.ndarray]:
        """``serve_turn`` widened by the recovery layer's retry quota: one
        engine call routes the ``k`` arrivals and ``retry_cap`` retry slots,
        gated by ``retry_slots`` bool[retry_cap] (an inactive slot returns
        worker -1); λ̂ observes ``k`` arrivals. With ``retry_cap=0`` use
        ``serve_turn``. Returns (fake_workers, workers[k + retry_cap])."""
        slots = np.ones(k + retry_cap, bool)
        slots[k:] = np.asarray(retry_slots, bool) if retry_slots is not None else False
        return self._serve(now, k, comp_workers, comp_times, comp_now, k + retry_cap,
                           torch.from_numpy(slots).to(self.device))

    def _serve(self, now, k, comp_workers, comp_times, comp_now, m_route=None, slots=None):
        self._flip_mu()
        comp_now = now if comp_now is None else comp_now
        nw = 0 if comp_workers is None else len(comp_workers)
        if nw > SERVE_COMP_CAP:
            # fold the oldest overflow first: the refresh reads only the
            # final rings, so the state is the same
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
            self.use_alias, self.active, m_route, slots)
        self.last_fake_time = float(now)
        if nw:
            self._set_pending()
        out = torch.cat([fake_js, workers]).cpu().numpy()  # one device sync
        fake_js = out[:MAX_FAKE]
        return fake_js[fake_js >= 0], out[MAX_FAKE:]

    def drain_queue(self, counts):
        """The recovery layer's queue-view drain: copies that left a replica
        without a clean completion (killed, or a dirty completion the
        learner does not see) still leave its queue, with the saturating
        subtract of the clean flush."""
        c = torch.from_numpy(np.asarray(counts, np.int32)).to(self.device)
        self.q_view = (self.q_view - c).clamp(min=0)

    def add_queue(self, counts):
        """The recovery layer's queue-view load: speculative copies are
        placed outside the engine (the straggler planner's fill), so their
        occupancy is added here."""
        self.q_view = self.q_view + torch.from_numpy(np.asarray(counts, np.int32)).to(
            self.device)

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


class FleetRouter:
    """S logical Rosella routers over one replica pool: the serving form of
    the frontend fleet (``repro_torch.fleet``).

    Each frontend is a full ``RosellaRouter`` that sees only its own share
    of the arrivals and its own completions: its ``q_view`` is exact about
    its own in-flight work and blind to the other S−1 frontends' between
    syncs. ``sync`` is the bounded-staleness layer: the agreed global view
    is rebuilt from per-frontend deltas (own view − snapshot at the last
    agreement, summed), every frontend adopts it, the learners' μ̂ merge
    into one front buffer with one alias table, and the per-frontend λ̂
    streams sum into the fleet's arrival-rate estimate. ``herd_correction``
    inflates each frontend's view by the expected peer placements since
    its last sync (``fleet.conflict``): a bool (1.0 or 0.0 fleet-wide), a
    float (fleet-wide) or a length-S sequence of per-frontend gains.

    Frontend f is seeded ``seed + 7919·f``, so with S = 1 and
    ``async_mu=False`` every sync is a numeric no-op and ``serve_turn``
    delegates verbatim: bit-equal to a lone ``RosellaRouter``.
    ``device=None`` is the CUDA card and raises without one.
    """

    def __init__(self, n_frontends: int, n_replicas: int, mu_bar: float, *,
                 policy: str = pol.PPOT_SQ2, c0: float = 0.1, c_window: float = 10.0,
                 seed: int = 0, async_mu: bool = True, herd_correction=False,
                 use_alias: bool = True, device=None):
        self.S = n_frontends
        self.n = n_replicas
        hs = np.asarray(herd_correction, np.float32)
        if hs.ndim == 0:
            hs = np.full((n_frontends,), float(hs), np.float32)
        if hs.shape != (n_frontends,):
            raise ValueError(f"herd_correction: expected a scalar or a length-{n_frontends} "
                             f"sequence, got shape {hs.shape}")
        self.herd_scale = hs
        self.herd_correction = bool(hs.any())
        self.frontends = [
            RosellaRouter(n_replicas, mu_bar, policy=policy, c0=c0, c_window=c_window,
                          seed=seed + 7919 * f, async_mu=async_mu, use_alias=use_alias,
                          device=device)
            for f in range(n_frontends)]
        self.device = self.frontends[0].device
        self._snap = np.zeros((n_replicas,), np.int64)  # the agreed view at the last sync
        self._herd_applied = np.zeros((n_frontends, n_replicas), np.int64)
        self.t_sync = 0.0
        self.lam_global = 0.0

    def serve_turn(self, f: int, now: float, k: int, comp_workers=None, comp_times=None,
                   comp_now: float | None = None):
        """Frontend ``f``'s serving turn (completion flush, benchmark draw,
        batch route) against its own stale view. With herd correction the
        view first takes the increment of the current expected peer
        placements (times this frontend's gain) over what it already holds;
        the next sync discards the whole correction."""
        fr = self.frontends[f]
        if self.herd_scale[f] and self.S > 1:
            extra = cfl.expected_peer_placements(est.lam_hat_ema(fr.arr), now - self.t_sync,
                                                 fr.mu_front, self.S)
            want = np.round(self.herd_scale[f] * extra.cpu().numpy()).astype(np.int64)
            delta = want - self._herd_applied[f]
            if delta.any():
                fr.q_view = fr.q_view + torch.from_numpy(delta.astype(np.int32)).to(fr.device)
                self._herd_applied[f] = want
        return fr.serve_turn(now, k, comp_workers, comp_times, comp_now)

    def sync(self, now: float, active=None) -> dict:
        """Reconcile the fleet: the global queue view rebuilt from
        per-frontend deltas and shared, μ̂ merged (``learner.sync_estimates``)
        with one alias table every frontend adopts, the λ̂ streams summed.
        ``active`` (bool[n]) applies a membership mask fleet-wide: rejoining
        workers cold-start in every frontend's learner and the merged table
        is masked. Returns the pre-sync per-frontend view gaps
        (``view_gaps``), the λ̂s, the global view and the rejoined worker
        ids (``rejoined``), which the caller targets with a probe burst."""
        rejoined = np.empty(0, np.int64)
        if active is not None:
            for fr in self.frontends:
                rejoined = np.union1d(rejoined, fr._apply_membership(active, now))
        qs = np.stack([fr.q_view.cpu().numpy() for fr in self.frontends]).astype(np.int64)
        qs -= self._herd_applied  # corrections are a routing bias, not state
        self._herd_applied[:] = 0
        deltas = qs - self._snap[None, :]
        global_q = np.maximum(self._snap + deltas.sum(axis=0), 0)
        gaps = np.abs(qs - global_q[None, :]).sum(axis=1)
        shared = torch.from_numpy(global_q.astype(np.int32)).to(self.device)
        mu_merged = lrn.sync_estimates(torch.stack([fr.learner.mu_hat for fr in self.frontends]))
        lam_f = self.lam_hats
        # one table a sync, shared by every frontend (a sync is the flip)
        table = (dsp.build_alias_table(mu_merged, self.frontends[0].active)
                 if any(fr.use_alias for fr in self.frontends) else None)
        for fr in self.frontends:
            fr.q_view = shared.clone()
            fr.mu_front = mu_merged
            if fr.use_alias:
                fr.table_front = table
            fr._mu_pending = fr._mu_event = None
        self._snap = global_q
        self.lam_global = float(lam_f.sum())
        self.t_sync = float(now)
        return {"view_gaps": gaps, "lam_f": lam_f, "global_q": global_q, "rejoined": rejoined}

    @property
    def lam_hats(self) -> np.ndarray:
        """Per-frontend λ̂ estimates (host values; no device read)."""
        return np.array([float(est.lam_hat_ema(fr.arr)) for fr in self.frontends])

    @property
    def mu_hat(self) -> np.ndarray:
        """The learners' estimates averaged over the fleet."""
        return np.stack([fr.learner.mu_hat.cpu().numpy() for fr in self.frontends]).mean(axis=0)


def run_fleet_simulation(
    router: FleetRouter,
    pool: SimulatedPool,
    *,
    arrival_rate: float,
    horizon: float,
    request_cost: float = 1.0,
    speed_schedule: "list[tuple[float, np.ndarray]] | None" = None,
    seed: int = 0,
    arrival_batch: int = 1,
    sync_every: int = 1,
):
    """Closed-loop serving simulation with S concurrent frontends.

    ``run_simulation``'s numpy streams (the same arrival gaps and request
    costs): each arrival batch splits into S contiguous chunks, every
    frontend routes its chunk against its own stale view in its own engine
    call, completions return to the frontend that placed them, and the
    fleet reconciles every ``sync_every`` turns (the staleness bound, in
    arrival batches). With S = 1 and ``async_mu=False`` the responses are
    bit-equal to ``run_simulation``'s at any ``sync_every``.

    Returns ``(response_times, mu_trace, info)``: ``info`` holds the
    placement log (``frontends``, ``workers``, ``epochs``: frontend, worker
    and sync epoch per request), the pre-sync view gaps of every sync
    (``sync_gaps``, S > 1), the final per-frontend λ̂s (``lam_hats``) and
    the turn count, for ``core.metrics.fleet_summary``.
    """
    S = router.S
    if arrival_batch < S:
        raise ValueError(f"arrival_batch={arrival_batch} must be >= S={S}")
    base, rem = divmod(arrival_batch, S)
    chunks = [base + (f < rem) for f in range(S)]
    offs = np.concatenate([[0], np.cumsum(chunks)])
    every = max(sync_every, 1)

    rng = np.random.RandomState(seed)
    t = 0.0
    turn = 0
    responses: list[np.ndarray] = []
    mu_trace: list[np.ndarray] = []
    log_fr: list[np.ndarray] = []
    log_w: list[np.ndarray] = []
    log_ep: list[np.ndarray] = []
    sync_gaps: list[np.ndarray] = []
    p_done = np.empty(0)
    p_rep = np.empty(0, np.int32)
    p_start = np.empty(0)
    p_fr = np.empty(0, np.int32)
    sched_i = 0

    while t < horizon:
        gaps = rng.exponential(1.0 / arrival_rate, size=arrival_batch)
        times = t + np.cumsum(gaps)
        t = float(times[-1])
        if speed_schedule is not None:
            while sched_i < len(speed_schedule) and speed_schedule[sched_i][0] <= t:
                pool.set_speeds(speed_schedule[sched_i][1])
                sched_i += 1

        # bounded-staleness sync (a numeric no-op at S = 1)
        if turn % every == 0:
            info = router.sync(t)
            if S > 1:
                sync_gaps.append(info["view_gaps"])

        # completions flush back to the frontend that placed them
        due = p_done <= t
        comp: list[tuple] = [(None, None, t)] * S
        if due.any():
            for f in range(S):
                m = due & (p_fr == f)
                if not m.any():
                    continue
                order = np.argsort(p_done[m], kind="stable")
                comp[f] = (p_rep[m][order], (p_done - p_start)[m][order],
                           float(p_done[m].max()))
            keep = ~due
            p_done, p_rep, p_start, p_fr = p_done[keep], p_rep[keep], p_start[keep], p_fr[keep]

        # every frontend routes its chunk in its own engine call
        workers = np.empty(arrival_batch, np.int64)
        fakes: list[tuple[int, np.ndarray]] = []
        for f in range(S):
            cw, ct, cn = comp[f]
            fake_js, ws = router.serve_turn(f, t, chunks[f], cw, ct, cn)
            workers[offs[f]:offs[f + 1]] = ws
            if len(fake_js):
                fakes.append((f, fake_js))

        for f, fake_js in fakes:
            fs, fd = pool.submit_batch(fake_js, np.full(len(fake_js), t),
                                       np.full(len(fake_js), request_cost * 0.25))
            p_done = np.concatenate([p_done, fd])
            p_rep = np.concatenate([p_rep, fake_js.astype(np.int32)])
            p_start = np.concatenate([p_start, fs])
            p_fr = np.concatenate([p_fr, np.full(len(fake_js), f, np.int32)])

        costs = request_cost * rng.exponential(1.0, size=arrival_batch)
        ss, dd = pool.submit_batch(workers, times, costs)
        responses.append(dd - times)
        req_fr = np.repeat(np.arange(S, dtype=np.int32), chunks)
        p_done = np.concatenate([p_done, dd])
        p_rep = np.concatenate([p_rep, workers.astype(np.int32)])
        p_start = np.concatenate([p_start, ss])
        p_fr = np.concatenate([p_fr, req_fr])

        log_fr.append(req_fr.astype(np.int64))
        log_w.append(workers.copy())
        log_ep.append(np.full(arrival_batch, turn // every, np.int64))
        mu_trace.append(router.frontends[0].mu_front.cpu().numpy())
        turn += 1

    resp = np.concatenate(responses) if responses else np.empty(0)
    info = {
        "frontends": np.concatenate(log_fr) if log_fr else np.empty(0, np.int64),
        "workers": np.concatenate(log_w) if log_w else np.empty(0, np.int64),
        "epochs": np.concatenate(log_ep) if log_ep else np.empty(0, np.int64),
        "sync_gaps": np.stack(sync_gaps) if sync_gaps else np.zeros((0, S)),
        "lam_hats": router.lam_hats,
        "turns": turn,
    }
    return resp, np.asarray(mu_trace), info
