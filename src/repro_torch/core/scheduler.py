"""Rosella runtime scheduler (paper Fig. 1): arrival estimator + a
scheduling policy (PPoT-SQ(2) by default) + performance learner, driven by
the caller.

``RosellaState`` with ``schedule`` / ``report_completions`` / ``refresh`` /
``fake_jobs_due`` is the plain state machine, and ``RosellaScheduler`` its
host-side wrapper: every batch of m jobs is one engine call, and a
completion batch is folded as its completions one at a time (the batched
ring write is the same).

The serving turn ``serve_step`` does three things: it flushes the due
completions into the learner, draws benchmark ("fake") jobs, and places
the arrival batch through the dispatch engine. The router keeps its state
split along the routing/learning seam: routing reads a μ̂ SNAPSHOT (and its
alias table) it is handed, while completions fold into the learner beside
it; ``use_fresh_mu=True`` instead routes on this flush's refreshed μ̂.

Tensors (queue view, rings, μ̂, tables, draws) live on the caller's
device. In ``serve_step`` keys, the arrival estimator and the turn's time
scalars are host values; every time scalar is taken to float32 before any
arithmetic on it, as the reference does on the device. Completion batches
arrive as host arrays from the replica pool, so whether a turn has any
completion is a host decision and costs no device synchronisation.

``serve_step_device`` is the same turn with everything on the device (the
key an int64 tensor, the estimator and the time scalars 0-d tensors, the
completion batch a padded tensor), for the device-resident loop
(``serving.scanloop``), the counterpart of the reference's
``_serve_step_math``. It makes no host decision: the completion fold
always runs and its result is selected, as ``lax.cond`` does. It routes
on the fresh μ̂ (``use_fresh_mu=True``), or on a given snapshot and its
table, the frozen views of the one-program fleet. Both forms share the
choice of μ̂ (``_route_mu``), the draws and the route (``_draw_and_route``).
The fleet's S serving turns (the reference's ``serve_step_fleet``, a vmap
that is bit-identical per row to S calls) are S calls of either form.

Distributed mode (paper §5): ``schedule_shard`` / ``make_sharded_schedule``
run one scheduler state a process of a ``fleet.sync.FrontendMesh`` and
average μ̂ and the queue views over the mesh after every batch, "they need
only synchronize the estimates of worker speeds regularly".
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dispatch as dsp
from repro_torch.core import estimator as est
from repro_torch.core import learner as lrn
from repro_torch.core import policies as pol
from repro_torch.utils import prng, scalars

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class RosellaState:
    q_view: torch.Tensor  # i32[n] the scheduler's view of outstanding work
    arr: est.EmaArrivalState  # host form
    learner: lrn.LearnerState
    last_fake_time: np.float32  # the fake-job clock

    def replace(self, **kw) -> "RosellaState":
        return dataclasses.replace(self, **kw)


def init_rosella(n: int, lcfg: lrn.LearnerConfig, mu_init: float = 1.0,
                 device=None) -> RosellaState:
    learner = lrn.init_learner(n, lcfg, mu_init, device)
    return RosellaState(
        q_view=torch.zeros(n, dtype=torch.int32, device=learner.mu_hat.device),
        arr=est.init_ema_arrival(), learner=learner, last_fake_time=f32(0.0))


def schedule(state: RosellaState, key, now, m: int, policy: str = pol.PPOT_SQ2,
             table: dsp.AliasTable | None = None) -> tuple[torch.Tensor, RosellaState]:
    """Place ``m`` jobs arriving at ``now`` in one engine call against the
    queue view; the batch folds back into it. The runtime has no oracle
    speeds, so Halo's μ is μ̂. Returns (workers[m], state')."""
    workers, q_view, arr = route_view(state.q_view, state.arr, state.learner.mu_hat, key,
                                      f32(now), m, policy, table)
    return workers, state.replace(q_view=q_view, arr=arr)


def report_completions(state: RosellaState, workers, service_times, now) -> RosellaState:
    """Feed a completion batch (workers -1 = padding) into the learner's
    rings and drain it from the queue view (clamped at 0 once, at the
    end)."""
    w, ts = _to_device(workers, service_times, state.q_view.device)
    learner = lrn.record_completions(state.learner, w, ts, f32(now))
    return state.replace(learner=learner, q_view=absorb_completions(state.q_view, w))


def refresh(state: RosellaState, lcfg: lrn.LearnerConfig, now) -> RosellaState:
    return state.replace(learner=lrn.refresh_estimates(
        state.learner, lcfg, est.lam_hat_ema(state.arr), f32(now)))


def fake_jobs_due(state: RosellaState, lcfg: lrn.LearnerConfig, key, now,
                  max_fake: int = 8) -> tuple[torch.Tensor, RosellaState]:
    """LEARNER-DISPATCHER tick: Poisson(ν·Δt) benchmark jobs since the last
    tick, each at a uniform worker. Returns (workers[max_fake] padded with
    -1, state')."""
    now = f32(now)
    js = fake_jobs_from(lcfg, key, est.lam_hat_ema(state.arr), now - state.last_fake_time,
                        max_fake, state.q_view.shape[0], device=state.q_view.device)
    return js, state.replace(last_fake_time=now)


class RosellaScheduler:
    """Host-side wrapper holding (state, config, key). ``device=None`` is
    the CUDA card and raises without one."""

    def __init__(self, n: int, mu_bar: float, *, c0: float = 0.1, c_window: float = 10.0,
                 window_mode: str = "practical", mu_init: float = 1.0, seed: int = 0,
                 device=None):
        self.n = n
        self.lcfg = lrn.default_learner_config(mu_bar, c0=c0, c_window=c_window,
                                               window_mode=window_mode)
        self.state = init_rosella(n, self.lcfg, mu_init, device)
        self.key = prng.PRNGKey(seed)

    def _next_key(self):
        self.key, k = prng.split(self.key)
        return k

    def schedule(self, now: float, m: int, policy: str = pol.PPOT_SQ2) -> torch.Tensor:
        workers, self.state = schedule(self.state, self._next_key(), now, m, policy)
        return workers

    def report(self, workers, service_times, now: float) -> None:
        self.state = report_completions(self.state, workers, service_times, now)
        self.state = refresh(self.state, self.lcfg, now)

    def fake_jobs(self, now: float, max_fake: int = 8) -> torch.Tensor:
        js, self.state = fake_jobs_due(self.state, self.lcfg, self._next_key(), now,
                                       max_fake)
        return js

    @property
    def mu_hat(self) -> torch.Tensor:
        return self.state.learner.mu_hat


def init_rosella_shards(num_shards: int, n: int, lcfg: lrn.LearnerConfig,
                        mu_init: float = 1.0, device=None) -> list[RosellaState]:
    """``num_shards`` fresh states, one a rank of the mesh, in rank order."""
    return [init_rosella(n, lcfg, mu_init, device) for _ in range(num_shards)]


def sync_shard_estimates(mesh, state: RosellaState) -> RosellaState:
    """Average μ̂ and the queue view over the mesh's ranks (paper §5). The
    ranks' rows are gathered in rank order and averaged there, so every
    rank holds the same bits as a mean over the stacked rows; the view is
    rounded back to integers."""
    mu = mesh.all_gather_rows(state.learner.mu_hat[None], "pmean").mean(0)
    q = mesh.all_gather_rows(state.q_view.to(torch.float32)[None], "pmean").mean(0)
    return state.replace(learner=state.learner.replace(mu_hat=mu),
                         q_view=torch.round(q).to(torch.int32))


def schedule_shard(mesh, state: RosellaState, key, now, m: int,
                   policy: str = pol.PPOT_SQ2) -> tuple[torch.Tensor, RosellaState]:
    """One frontend step on this rank of ``mesh``: place a local batch of
    ``m`` jobs through the dispatch engine, then average μ̂ and q̂ over the
    ranks. Returns (workers[m], state')."""
    workers, state = schedule(state, key, now, m, policy)
    return workers, sync_shard_estimates(mesh, state)


def make_sharded_schedule(mesh, m: int, policy: str = pol.PPOT_SQ2):
    """The multi-frontend scheduler over ``mesh`` (a ``fleet.sync.FrontendMesh``
    with one scheduler state a rank): ``fn(state, key, now) -> (workers[m],
    state')``, called on every rank with the rank's own state and key. Each
    rank runs the batched engine against its own queue view, then the
    estimates sync over the ranks."""

    def fn(state: RosellaState, key, now):
        mesh.check_device(state.q_view)
        return schedule_shard(mesh, state, key, now, m, policy)

    return fn


def absorb_completions(q_view: torch.Tensor, workers: torch.Tensor) -> torch.Tensor:
    """Drain a completion batch (padded with -1) from the queue view."""
    done = dsp.fold_counts(q_view, workers, workers >= 0)
    return (q_view - done).clamp(min=0)


def fold_telemetry(learner: lrn.LearnerState, lcfg: lrn.LearnerConfig,
                   workers: torch.Tensor, service_times: torch.Tensor,
                   lam_hat, now) -> lrn.LearnerState:
    """LEARNER-AGGREGATE for a completion batch, then the estimate refresh."""
    learner = lrn.record_completions(learner, workers, service_times, now)
    return lrn.refresh_estimates(learner, lcfg, lam_hat, now)


def _to_device(workers: np.ndarray, times: np.ndarray, device):
    return (torch.from_numpy(np.asarray(workers, np.int32)).to(device),
            torch.from_numpy(np.asarray(times, np.float32)).to(device))


def complete_step(q_view, learner, lcfg, arr: est.EmaArrivalState,
                  workers: np.ndarray, service_times: np.ndarray, now):
    """Completion fold: queue-view drain + LEARNER-AGGREGATE + refresh.
    Returns (q_view', learner')."""
    w, ts = _to_device(workers, service_times, q_view.device)
    q2 = absorb_completions(q_view, w)
    learner2 = fold_telemetry(learner, lcfg, w, ts, est.lam_hat_ema(arr), f32(now))
    return q2, learner2


def route_view(q_view, arr, mu_hat, key, now, m: int, policy: str = pol.PPOT_SQ2,
               table: dsp.AliasTable | None = None, mask=None):
    """Route ``m`` requests against a queue view and a μ̂ snapshot.
    Returns (workers[m], q_view', arr')."""
    arr2 = est.observe_arrivals_ema(arr, now, m, window=est.EMA_ARR_WINDOW)
    res = dsp.dispatch(policy, key, q_view, mu_hat, mu_hat,
                       pol.default_policy_config(), m, table=table, mask=mask)
    return res.workers, res.q_after, arr2


def fake_jobs_from(lcfg: lrn.LearnerConfig, key, lam_hat, dt, max_fake: int,
                   n: int, mask: torch.Tensor | None = None,
                   device=None) -> torch.Tensor:
    """LEARNER-DISPATCHER tick: min(Poisson(ν·dt), max_fake) benchmark jobs
    at uniform workers (uniform over the active ones under ``mask``);
    returns workers i32[max_fake] padded with -1.

    The count is the inverse CDF of the truncated Poisson pmf at one
    counter-hash uniform; the workers are scaled counter-hash uniforms.
    ``device`` defaults to the mask's (and must be given without one).
    """
    dev = mask.device if mask is not None else torch.device(device)
    x = scalars.of(lam_hat)
    lam = lrn.fake_job_rate(lcfg, lam_hat) * x.maximum(x.f32(dt), x.const(0.0))
    u1, u2 = prng.uniform_pair(key, max_fake, dev)
    ks = torch.arange(max_fake + 1, dtype=torch.float32, device=dev)
    logfact = torch.zeros(max_fake + 1, dtype=torch.float32, device=dev)
    logfact[1:] = torch.cumsum(torch.log(ks[1:]), 0)
    lam_t = scalars.fill(lam, torch.empty((), dtype=torch.float32, device=dev))
    log_lam = torch.log(lam_t.clamp(min=1e-30))
    cdf = torch.cumsum(torch.exp(ks * log_lam - lam_t - logfact), 0)
    k = (cdf <= u1[0]).sum()
    js = (u2 * n).to(torch.int32) if mask is None else dsp.active_choice(mask, u2)
    return torch.where(torch.arange(max_fake, device=dev) < k, js, -1)


def _draw_and_route(q1, arr, lam0, lcfg, key, now, last_fake, m: int, policy: str,
                    max_fake: int, mu_route, tbl, mask, m_route: int | None = None,
                    slots: torch.Tensor | None = None):
    """The turn after the completion fold: the key splits in the
    reference's order (``key1, k_fake = split(key)``, then ``key2, k_route
    = split(key1)``), the benchmark draw, the λ̂ EMA and the route of
    ``m`` slots, or of ``m_route`` gated by ``slots`` (the λ̂ EMA still
    observes ``m`` arrivals). Returns (fake_js, workers, q_view', arr',
    key')."""
    key1, k_fake = prng.split(key)
    key2, k_route = prng.split(key1)
    fake_js = fake_jobs_from(lcfg, k_fake, lam0, now - last_fake, max_fake,
                             q1.shape[0], mask=mask, device=q1.device)
    arr2 = est.observe_arrivals_ema(arr, now, m, window=est.EMA_ARR_WINDOW)
    res = dsp.dispatch(policy, k_route, q1, mu_route, mu_route,
                       pol.default_policy_config(), m if m_route is None else m_route,
                       active=slots, table=tbl, mask=mask)
    return fake_js, res.workers, res.q_after, arr2, key2


def _route_mu(learner2: lrn.LearnerState, mu_hat, table, use_alias: bool, mask):
    """The μ̂ and alias table a turn routes on: with ``mu_hat`` None, this
    flush's refreshed μ̂, whose table is rebuilt from it (the front table
    would be stale; once per flush); else the given snapshot and its
    table."""
    if mu_hat is None:
        mu_route = learner2.mu_hat
        return mu_route, (dsp.build_alias_table(mu_route, mask) if use_alias else None)
    return mu_hat, (table if use_alias else None)


def serve_step(q_view, learner, arr, mu_hat, lcfg, key,
               comp_workers: np.ndarray, comp_times: np.ndarray, scalars,
               m: int, policy: str = pol.PPOT_SQ2, max_fake: int = 8,
               use_fresh_mu: bool = False, table: dsp.AliasTable | None = None,
               use_alias: bool = False, mask: torch.Tensor | None = None,
               m_route: int | None = None, slots: torch.Tensor | None = None):
    """One whole serving turn: flush the due completion batch (host arrays
    padded with -1), draw benchmark requests, route the arrival batch.

    ``scalars`` is (now, last_fake_time, comp_now). The key splits keep the
    reference's order: ``key1, k_fake = split(key)``, then
    ``key2, k_route = split(key1)``.

    ``m_route``/``slots`` are the recovery layer's widened dispatch (the
    reference's ``serve_step_recovery``): one engine call routes ``m_route
    >= m`` slots, the first ``m`` the arrival batch and the tail the turn's
    retry quota, gated by ``slots`` bool[m_route] (an inactive slot places
    nothing and returns worker -1). λ̂ still observes ``m`` arrivals.
    ``m_route=None`` is the plain turn.

    Returns (fake_js[max_fake], workers[m or m_route], q_view', learner',
    arr', key').
    """
    now, last_fake, comp_now = (f32(s) for s in scalars)
    dev = q_view.device
    cw, ct = _to_device(comp_workers, comp_times, dev)
    q1 = absorb_completions(q_view, cw)
    lam0 = est.lam_hat_ema(arr)
    learner2 = learner
    if (np.asarray(comp_workers) >= 0).any():
        learner2 = fold_telemetry(learner, lcfg, cw, ct, lam0, comp_now)
    mu_route, tbl = _route_mu(learner2, None if use_fresh_mu else mu_hat, table, use_alias,
                              mask)
    fake_js, workers, q2, arr2, key2 = _draw_and_route(
        q1, arr, lam0, lcfg, key, now, last_fake, m, policy, max_fake, mu_route, tbl, mask,
        m_route=m_route, slots=slots)
    return fake_js, workers, q2, learner2, arr2, key2


def serve_step_device(q_view, learner, arr, lcfg, key, comp_workers: torch.Tensor,
                      comp_times: torch.Tensor, clock, m: int,
                      policy: str = pol.PPOT_SQ2, max_fake: int = 8,
                      use_alias: bool = False, mask: torch.Tensor | None = None,
                      m_route: int | None = None, slots: torch.Tensor | None = None,
                      mu_hat: torch.Tensor | None = None,
                      table: dsp.AliasTable | None = None):
    """``serve_step`` with the whole turn on the device: ``key`` an int64
    tensor [2], ``arr`` the device estimator, ``clock`` = (now,
    last_fake_time, comp_now) as f32 0-d tensors, the completion batch
    i32/f32 tensors padded with -1; ``m_route``/``slots`` as in
    ``serve_step``. It routes on the fresh μ̂ (``use_fresh_mu=True``), or,
    given ``mu_hat``, on that snapshot and its alias ``table`` (the frozen
    views of the one-program fleet, ``use_fresh_mu=False``).

    The fold runs every turn and is selected only where the batch has a
    completion: over an all-padding batch it is not a no-op
    (``refresh_estimates`` moves μ̂ through the dead-worker cut-off).
    Returns (fake_js[max_fake], workers, q_view', learner', arr', key').
    """
    now, last_fake, comp_now = clock
    q1 = absorb_completions(q_view, comp_workers)
    lam0 = est.lam_hat_ema(arr)
    folded = fold_telemetry(learner, lcfg, comp_workers, comp_times, lam0, comp_now)
    learner2 = lrn.select((comp_workers >= 0).any(), folded, learner)
    mu_route, tbl = _route_mu(learner2, mu_hat, table, use_alias, mask)
    fake_js, workers, q2, arr2, key2 = _draw_and_route(
        q1, arr, lam0, lcfg, key, now, last_fake, m, policy, max_fake, mu_route,
        tbl, mask, m_route=m_route, slots=slots)
    return fake_js, workers, q2, learner2, arr2, key2
