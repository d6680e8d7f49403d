"""Summaries of serving runs (numpy, host side): response-time summaries,
the adaptation-time metric of the environment engine (``repro_torch.env``),
the fault-run ledger checks of the recovery layer (``serving.recovery``),
the load harness's whole-horizon report from window records
(``calibration_report``) and the frontend fleet's health summary
(``fleet_summary``), copied from the JAX package's ``core/metrics.py``."""
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


def calibration_report(cfg, windows: "list[dict]", *,
                       warmup_windows: int = 0, tol: float = 0.1) -> dict:
    """λ̂-calibration and latency over a FULL (possibly streamed) horizon,
    computed from the windowed telemetry records — the load harness's
    whole-run report (the ``[load]`` phase of ``chip_smoke.py``), usable on any
    ``info["windows"]`` stream or a re-read JSONL sink.

    Aggregates the per-window log-histograms into whole-horizon
    p50/p99/p999 (exact fold: histogram addition commutes with the
    quantile read within the pinned one-bin tolerance) and reduces the
    ``lam_calibration`` series (λ̂ / realized arrival rate, target 1.0) to:
    its post-warmup mean/min/max, the final window's value, and
    ``settle_t`` — the earliest window-end time after which EVERY later
    window stays within ``tol`` of 1.0 (the λ̂ analogue of
    ``adaptation_time``; NaN if it never settles)."""
    from repro_torch.obs import windows as obw

    recs = list(windows)
    out: dict = {"n_windows": len(recs), "warmup_windows": warmup_windows}
    if not recs:
        return out
    body = recs[warmup_windows:] or recs
    hist = np.sum([np.asarray(r["hist"]) for r in body], axis=0)
    out.update(
        requests=int(sum(r["arrivals"] for r in recs)),
        completed=int(sum(r["n_resp"] for r in recs)),
        horizon_t=float(recs[-1]["t_end"]),
        p50=obw.hist_quantile(hist, 0.50, cfg),
        p99=obw.hist_quantile(hist, 0.99, cfg),
        p999=obw.hist_quantile(hist, 0.999, cfg),
        mean_est=obw.hist_mean(hist, cfg),
    )
    cal = np.asarray([r["lam_calibration"] for r in body], np.float64)
    t_end = np.asarray([r["t_end"] for r in body], np.float64)
    ok = np.isfinite(cal)
    if ok.any():
        c = cal[ok]
        out["lam_calibration"] = {
            "mean": float(c.mean()),
            "min": float(c.min()),
            "max": float(c.max()),
            "final": float(c[-1]),
            "worst_abs_err": float(np.abs(c - 1.0).max()),
        }
        # earliest window end after which |calibration − 1| ≤ tol holds
        # for every later finite window
        bad = ok & (np.abs(cal - 1.0) > tol)
        if bad.any():
            last_bad = int(np.nonzero(bad)[0][-1])
            out["lam_calibration"]["settle_t"] = (
                float(t_end[last_bad]) if last_bad + 1 < len(cal)
                else float("nan")
            )
        else:
            out["lam_calibration"]["settle_t"] = float(t_end[0])
    return out


def fleet_summary(
    frontends: np.ndarray,  # frontend id per placement
    workers: np.ndarray,  # worker id per placement
    epochs: np.ndarray,  # sync-window index per placement
    *,
    n_frontends: int,
    lam_hat_frontends: np.ndarray | None = None,  # f32[S] per-frontend λ̂
    lam_true: float | None = None,  # true TOTAL arrival rate λ
    view_gaps: np.ndarray | None = None,  # staleness |view − truth| samples
    sync_ages: np.ndarray | None = None,  # time-since-last-sync samples
    ledger: dict | None = None,  # recovery.build_ledger conservation books
) -> dict:
    """Fleet health metrics shared by the benchmark and the tests:
    per-frontend λ̂ calibration error (each frontend sees ~λ/S), the sync
    staleness histogram (view-gap and age distributions), the herd-collision
    rate (``fleet.conflict.collision_stats``), and arrival-share balance.

    ``ledger`` (the faulty runs' ``info["ledger"]``) folds the fault /
    recovery counters into the summary: the full conservation books under
    ``"ledger"`` plus derived ``"fault"`` rates (loss_rate, kill_rate,
    retry_rate over the real copies launched).

    Serving callers pass ``run_fleet_simulation``'s (or the fleet scan's)
    info fields directly; the chain simulator's trace form
    (``fleet_summary_from_trace``) is ROADMAP queue A, A8.
    """
    from repro_torch.fleet import conflict as cfl

    S = int(n_frontends)
    frontends = np.asarray(frontends, np.int64)
    workers = np.asarray(workers, np.int64)
    epochs = np.asarray(epochs, np.int64)
    out: dict = {"n_frontends": S}
    out.update(cfl.collision_stats(frontends, workers, epochs))

    share = np.bincount(frontends, minlength=S).astype(np.float64)
    tot = max(share.sum(), 1.0)
    out["arrival_share"] = (share / tot).tolist()
    out["share_imbalance"] = float(np.abs(share / tot - 1.0 / S).max() * S)

    if lam_hat_frontends is not None:
        lam_f = np.asarray(lam_hat_frontends, np.float64)
        out["lam_hat_frontends"] = [round(float(x), 4) for x in lam_f]
        out["lam_hat_fleet"] = float(lam_f.sum())
        if lam_true is not None:
            target = lam_true / S
            rel = np.abs(lam_f - target) / max(target, 1e-9)
            out["lam_calibration_rel_err"] = {
                "per_frontend": [round(float(x), 4) for x in rel],
                "mean": float(rel.mean()),
                "max": float(rel.max()),
            }
            out["lam_fleet_rel_err"] = float(
                abs(lam_f.sum() - lam_true) / max(lam_true, 1e-9)
            )

    if view_gaps is not None and np.asarray(view_gaps).size:
        g = np.asarray(view_gaps, np.float64).ravel()
        hist = np.bincount(np.minimum(g.astype(np.int64), 64), minlength=65)
        out["staleness"] = {
            "gap_mean": float(g.mean()),
            "gap_p95": float(np.percentile(g, 95)),
            "gap_max": float(g.max()),
            "gap_hist_capped64": hist.tolist(),
        }
    if sync_ages is not None and np.asarray(sync_ages).size:
        a = np.asarray(sync_ages, np.float64).ravel()
        out["sync_age"] = {
            "mean": float(a.mean()),
            "p95": float(np.percentile(a, 95)),
            "max": float(a.max()),
        }
    if ledger is not None:
        out["ledger"] = dict(ledger)
        n_tasks = max(int(ledger.get("n_tasks", 0)), 1)
        launched = max(int(ledger.get("copies_real_launched", 0)), 1)
        out["fault"] = {
            "loss_rate": int(ledger.get("lost_tasks", 0)) / n_tasks,
            "kill_rate": int(ledger.get("copies_real_killed", 0)) / launched,
            "retry_rate": int(ledger.get("n_retries", 0)) / launched,
            "dirty_rate": (
                int(ledger.get("n_dirty_completions", 0)) / launched
            ),
            "timeout_rate": int(ledger.get("n_timeouts", 0)) / launched,
            "conserved": bool(ledger.get("conserved", True)),
        }
    return out
