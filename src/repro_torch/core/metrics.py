"""Summaries of serving runs (numpy, host side): response-time summaries,
the adaptation-time metric of the environment engine (``repro_torch.env``)
and the fault-run ledger checks of the recovery layer
(``serving.recovery``), copied from the JAX package's ``core/metrics.py``."""
from __future__ import annotations

import numpy as np


def serve_summary(responses: np.ndarray, mu_trace: np.ndarray | None = None) -> dict:
    """Mean/p50/p99 response time of a ``serving.run_simulation`` run, plus
    the final μ̂ snapshot and its replica ranking. ``mu_trace`` rows are
    sampled once per arrival batch, not per request."""
    out: dict = {"n_requests": int(np.asarray(responses).size)}
    r = np.asarray(responses, dtype=np.float64)
    if r.size:
        out.update(mean=float(r.mean()), p50=float(np.percentile(r, 50)),
                   p99=float(np.percentile(r, 99)))
    else:
        out.update(mean=float("nan"), p50=float("nan"), p99=float("nan"))
    if mu_trace is not None and len(mu_trace):
        mu_last = np.asarray(mu_trace[-1], dtype=np.float64)
        out["mu_final"] = [round(float(x), 4) for x in mu_last]
        out["mu_ranking"] = np.argsort(-mu_last).tolist()
    return out


def mu_rel_error_trace(
    mu_hat: np.ndarray,  # [T, n] learner estimates over time
    mu_true: np.ndarray,  # [T, n] or [n] true speeds over time
    active: np.ndarray | None = None,  # bool[T, n] membership (churn)
    normalize: bool = True,
) -> np.ndarray:
    """Per-sample relative estimate error e(t) = Σ|μ̂ − μ| / Σμ.

    With ``normalize`` (default) both vectors are first normalized to unit
    sum over the ACTIVE workers — the error then measures the learner's
    *ranking/shape* miscalibration and is invariant to the constant scale
    factors between μ̂ and raw speeds (the (1−ε) deliberate underestimate,
    request-cost units in the serving layer), which is what adaptation is
    about: after an environment shift the shape diverges, and re-learning
    restores it. Offline workers are excluded at each time step (their μ̂
    is meaningless while they're gone).
    """
    mu_hat = np.asarray(mu_hat, np.float64)
    T, n = mu_hat.shape
    mu_true = np.asarray(mu_true, np.float64)
    if mu_true.ndim == 1:
        mu_true = np.broadcast_to(mu_true[None, :], (T, n))
    act = (
        np.ones((T, n), bool) if active is None
        else np.asarray(active, bool)
    )
    h = np.where(act, mu_hat, 0.0)
    m = np.where(act, mu_true, 0.0)
    if normalize:
        h = h / np.maximum(h.sum(axis=1, keepdims=True), 1e-12)
        m = m / np.maximum(m.sum(axis=1, keepdims=True), 1e-12)
    return np.abs(h - m).sum(axis=1) / np.maximum(m.sum(axis=1), 1e-12)


def adaptation_time(
    times: np.ndarray,  # [T] sample times of the error trajectory
    err: np.ndarray,  # [T] estimate-error trajectory (mu_rel_error_trace)
    shift: float,  # the environment shift instant
    *,
    pre_window: float = 30.0,  # how far before the shift the band is fit
    band_quantile: float = 0.9,
    min_band: float = 0.02,  # floor: a perfectly-converged pre-shift band
    # of ~0 would make re-entry unreachable noise-wise
) -> float:
    """Time from an environment shift until μ̂'s relative error re-enters
    its pre-shift band — the paper's "adapts to environment changes
    quickly" claim as a number.

    The band is the ``band_quantile`` of the error over the
    ``pre_window`` preceding the shift (floored at ``min_band``); the
    adaptation time is the first post-shift sample whose error is back
    inside the band, minus the shift instant. NaN if the error never
    re-enters before the trajectory ends (not adapted), 0.0 if the shift
    never pushed the error out of band at all (nothing to adapt to).
    """
    times = np.asarray(times, np.float64)
    err = np.asarray(err, np.float64)
    pre = (times >= shift - pre_window) & (times < shift)
    if not pre.any():
        return float("nan")
    band = max(float(np.quantile(err[pre], band_quantile)), min_band)
    post = times >= shift
    if not post.any():
        return float("nan")
    e_post = err[post]
    t_post = times[post]
    inside = e_post <= band
    if not inside.any():
        return float("nan")
    first = int(np.argmax(inside))
    if first == 0:
        return 0.0  # never left the band: the shift was absorbed instantly
    return float(t_post[first] - shift)


def adaptation_report(
    times: np.ndarray,  # [T] sample times
    mu_hat: np.ndarray,  # [T, n]
    mu_true: np.ndarray,  # [T, n] or [n]
    shifts,  # environment shift instants
    *,
    active: np.ndarray | None = None,
    pre_window: float = 30.0,
    band_quantile: float = 0.9,
    min_band: float = 0.02,
) -> dict:
    """Adaptation-time summary over every environment shift of a run:
    per-shift times plus mean/max over the shifts that were measurable
    (non-NaN) and the count that never re-adapted. The ``repro_torch.env``
    scenario engine supplies ``shifts`` (``ServingWorkload.shift_times``)
    and the per-turn ``mu_true``/``active`` trajectories."""
    err = mu_rel_error_trace(mu_hat, mu_true, active=active)
    per = {
        float(s): adaptation_time(
            times, err, float(s), pre_window=pre_window,
            band_quantile=band_quantile, min_band=min_band,
        )
        for s in np.asarray(shifts, np.float64)
    }
    vals = np.asarray([v for v in per.values() if np.isfinite(v)])
    # 3-decimal keys: random churn draws continuous shift times, and a
    # coarser format could merge near-coincident shifts into one entry
    return {
        "per_shift": {f"{k:.3f}": (round(v, 3) if np.isfinite(v) else None)
                      for k, v in per.items()},
        "n_shifts": len(per),
        "n_unadapted": int(sum(1 for v in per.values() if not np.isfinite(v))),
        "mean": float(vals.mean()) if vals.size else float("nan"),
        "max": float(vals.max()) if vals.size else float("nan"),
    }


def check_conservation(ledger: dict) -> tuple[bool, dict]:
    """The task-conservation invariant over a fault-run ledger
    (``info["ledger"]`` from the serving loops): every arrived task is
    completed or lost, every launched real COPY (original + retries +
    speculative) is completed or killed, and every fake/burst probe is
    completed or killed. Returns (ok, residuals) — residuals are the
    per-identity imbalances, all zero when the ledger conserves."""
    res = {
        "tasks": ledger["n_tasks"]
        - ledger["completed_tasks"] - ledger["lost_tasks"],
        "real_copies": ledger["copies_real_launched"]
        - ledger["copies_real_completed"] - ledger["copies_real_killed"],
        "fakes": ledger["fake_launched"]
        - ledger["fake_completed"] - ledger["fake_killed"],
    }
    return all(v == 0 for v in res.values()), res


def fault_report(responses, ledger: dict, *, horizon: float | None = None) -> dict:
    """Robustness metrics for a fault run — the failure-side companion of
    ``adaptation_report``. ``responses`` is the task-indexed response
    array of the fault-aware serving loops (NaN = lost task); ``ledger``
    is their ``info["ledger"]`` conservation ledger.

    Reports goodput (distinct tasks completed per unit time) vs
    throughput (real copies completed per unit time — retries and
    speculation inflate this above goodput), the retry amplification
    factor (real copies launched per arrived task; 1.0 = no recovery
    overhead), loss rate, and latency percentiles including p999 over
    the completed tasks."""
    r = np.asarray(responses, np.float64)
    done = r[np.isfinite(r)]
    n_tasks = int(ledger["n_tasks"])
    completed = int(ledger["completed_tasks"])
    lost = int(ledger["lost_tasks"])
    ok, residuals = check_conservation(ledger)
    out: dict = {
        "n_tasks": n_tasks,
        "completed": completed,
        "lost": lost,
        "loss_rate": lost / max(n_tasks, 1),
        "timeouts": int(ledger.get("n_timeouts", 0)),
        "retries": int(ledger.get("n_retries", 0)),
        "speculative": int(ledger.get("n_spec", 0)),
        "killed_copies": int(ledger.get("copies_real_killed", 0)),
        "dirty_completions": int(ledger.get("n_dirty_completions", 0)),
        "retry_amplification": (
            int(ledger["copies_real_launched"]) / max(n_tasks, 1)
        ),
        "dup_completions": (
            int(ledger["copies_real_completed"]) - completed
        ),
        "conserved": ok,
        "conservation_residuals": residuals,
    }
    if done.size:
        out.update(
            mean=float(done.mean()),
            p50=float(np.percentile(done, 50)),
            p99=float(np.percentile(done, 99)),
            p999=float(np.percentile(done, 99.9)),
        )
    else:
        out.update(mean=float("nan"), p50=float("nan"),
                   p99=float("nan"), p999=float("nan"))
    if horizon:
        out["goodput"] = completed / horizon
        out["throughput"] = int(ledger["copies_real_completed"]) / horizon
    return out
