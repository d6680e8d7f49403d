"""Rosella runtime scheduler (paper Fig. 1): arrival estimator + PPoT-SQ(2)
placement + performance learner, driven by the caller.

The serving turn ``serve_step`` does three things: it flushes the due
completions into the learner, draws benchmark ("fake") jobs, and places
the arrival batch through the dispatch engine. The router keeps its state
split along the routing/learning seam: routing reads a μ̂ SNAPSHOT (and its
alias table) it is handed, while completions fold into the learner beside
it; ``use_fresh_mu=True`` instead routes on this flush's refreshed μ̂.

Tensors (queue view, rings, μ̂, tables, draws) live on the caller's
device. Keys, the arrival estimator and the turn's time scalars are host
values; every time scalar is taken to float32 before any arithmetic on it,
as the reference does on the device. Completion batches arrive as host
arrays from the replica pool, so whether a turn has any completion is a
host decision and costs no device synchronisation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dispatch as dsp
from repro_torch.core import estimator as est
from repro_torch.core import learner as lrn
from repro_torch.core import policies as pol
from repro_torch.utils import prng

f32 = np.float32


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
    lam = lrn.fake_job_rate(lcfg, lam_hat) * max(f32(dt), f32(0.0))
    u1, u2 = prng.uniform_pair(key, max_fake, dev)
    ks = torch.arange(max_fake + 1, dtype=torch.float32, device=dev)
    logfact = torch.zeros(max_fake + 1, dtype=torch.float32, device=dev)
    logfact[1:] = torch.cumsum(torch.log(ks[1:]), 0)
    log_lam = torch.log(torch.full((), float(max(lam, f32(1e-30))), device=dev))
    cdf = torch.cumsum(torch.exp(ks * log_lam - float(lam) - logfact), 0)
    k = (cdf <= u1[0]).sum()
    js = (u2 * n).to(torch.int32) if mask is None else dsp.active_choice(mask, u2)
    return torch.where(torch.arange(max_fake, device=dev) < k, js, -1)


def serve_step(q_view, learner, arr, mu_hat, lcfg, key,
               comp_workers: np.ndarray, comp_times: np.ndarray, scalars,
               m: int, policy: str = pol.PPOT_SQ2, max_fake: int = 8,
               use_fresh_mu: bool = False, table: dsp.AliasTable | None = None,
               use_alias: bool = False, mask: torch.Tensor | None = None):
    """One whole serving turn: flush the due completion batch (host arrays
    padded with -1), draw benchmark requests, route the arrival batch.

    ``scalars`` is (now, last_fake_time, comp_now). The key splits keep the
    reference's order: ``key1, k_fake = split(key)``, then
    ``key2, k_route = split(key1)``.

    Returns (fake_js[max_fake], workers[m], q_view', learner', arr', key').
    """
    now, last_fake, comp_now = (f32(s) for s in scalars)
    dev = q_view.device
    cw, ct = _to_device(comp_workers, comp_times, dev)
    q1 = absorb_completions(q_view, cw)
    lam0 = est.lam_hat_ema(arr)
    learner2 = learner
    if (np.asarray(comp_workers) >= 0).any():
        learner2 = fold_telemetry(learner, lcfg, cw, ct, lam0, comp_now)
    key1, k_fake = prng.split(key)
    key2, k_route = prng.split(key1)
    n = q1.shape[0]
    fake_js = fake_jobs_from(lcfg, k_fake, lam0, now - last_fake, max_fake, n,
                             mask=mask, device=dev)
    arr2 = est.observe_arrivals_ema(arr, now, m, window=est.EMA_ARR_WINDOW)
    if use_fresh_mu:
        # route on THIS flush's μ̂: the front table would be stale, so the
        # table is rebuilt from the fresh estimates (once per flush)
        mu_route = learner2.mu_hat
        tbl = dsp.build_alias_table(mu_route, mask) if use_alias else None
    else:
        mu_route = mu_hat
        tbl = table if use_alias else None
    res = dsp.dispatch(policy, k_route, q1, mu_route, mu_route,
                       pol.default_policy_config(), m, table=tbl, mask=mask)
    return fake_js, res.workers, res.q_after, learner2, arr2, key2
