"""Summaries of serving runs (numpy, host side)."""
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
