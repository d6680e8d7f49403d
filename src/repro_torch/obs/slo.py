"""Declarative SLO objectives + multi-window burn-rate alerting.

The alerting half of the introspection layer (``obs.detect`` is the
regime half): a set of ``SLObjective``s — latency-quantile targets read
from the windowed latency histogram, loss-rate targets read from the
window ledger counters — evaluated per window record by an
``SLOTracker`` with the SRE-style multi-window burn-rate rule:

    burn = (window error rate) / (error budget)
    alert ⇔ mean burn over the FAST window ≥ fast_burn
          ∧ mean burn over the SLOW window ≥ slow_burn

The fast window confirms the problem is happening NOW (so alerts clear
quickly when it stops); the slow window filters one-window blips (so a
single bad window cannot page). Burn of 1.0 means the error budget is
being consumed exactly at the sustainable rate.

The tracker is host-side and O(slow_windows) memory — it folds the
record stream as it arrives (``update`` per record), composing with
``JsonlSink``/stream-only mode on million-turn horizons. ``update``
annotates each record in place with an ``"slo"`` key, which the
Prometheus/dashboard exporters and the Chrome-trace converter render as
active alert state.

Copied verbatim from the JAX package's ``obs/slo.py``.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Iterable

import numpy as np

from repro_torch.obs import windows as obw


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One service-level objective.

    ``metric="latency"``: "no more than ``budget`` of requests slower
    than ``threshold``" — the window error rate is the histogram mass
    above ``threshold`` (so a latency-quantile target q at value v is
    ``threshold=v, budget=1-q``). ``metric="loss"``: "no more than
    ``budget`` of launched copies killed" — the window error rate is
    killed/launched. Burn thresholds follow the SRE fast/slow pairing;
    window lengths are in telemetry windows.
    """

    name: str
    metric: str = "latency"  # "latency" | "loss"
    threshold: float = 10.0  # latency bound (seconds); unused for loss
    budget: float = 0.01  # allowed violating fraction (error budget)
    fast_windows: int = 3
    slow_windows: int = 12
    fast_burn: float = 2.0
    slow_burn: float = 1.0

    def __post_init__(self):
        if self.metric not in ("latency", "loss"):
            raise ValueError(f"unknown SLO metric {self.metric!r}")
        if not (0.0 < self.budget < 1.0):
            raise ValueError("budget must be in (0, 1)")
        if self.fast_windows < 1 or self.slow_windows < self.fast_windows:
            raise ValueError("need 1 <= fast_windows <= slow_windows")
        if self.fast_burn <= 0.0 or self.slow_burn <= 0.0:
            raise ValueError("burn thresholds must be > 0")


def default_objectives(*, p99_target: float = 10.0,
                       loss_budget: float = 0.01) -> tuple:
    """A reasonable default pair: a p99 latency objective and a kill
    loss-rate objective."""
    return (
        SLObjective(name="latency_p99", metric="latency",
                    threshold=p99_target, budget=0.01),
        SLObjective(name="loss_rate", metric="loss", budget=loss_budget),
    )


def hist_frac_above(hist, x: float, cfg: obw.ObserveConfig) -> float:
    """Fraction of histogram mass above value ``x`` (log-interpolated
    within the containing bin — the inverse read of
    ``windows.hist_quantile``). NaN on an empty histogram."""
    c = np.asarray(hist, np.float64)
    total = c.sum()
    if total <= 0:
        return float("nan")
    r = obw.bin_ratio(cfg)
    # continuous bin coordinate of x: p bins of mass lie below x
    p = math.log(max(x, cfg.hist_lo) / cfg.hist_lo) / math.log(r)
    if p <= 0.0:
        return 1.0
    if p >= cfg.hist_bins:
        return 0.0
    b = int(p)
    below = c[:b].sum() + c[b] * (p - b)
    return float(max(total - below, 0.0) / total)


def window_error_rate(obj: SLObjective, record: dict,
                      cfg: obw.ObserveConfig) -> float:
    """One window's error rate for one objective (NaN when the window
    carries no eligible events — an idle window consumes no budget)."""
    if obj.metric == "latency":
        if int(record.get("n_resp", 0)) <= 0:
            return float("nan")
        return hist_frac_above(record["hist"], obj.threshold, cfg)
    launched = int(record.get("launched", 0))
    if launched <= 0:
        return float("nan")
    return int(record.get("killed", 0)) / launched


class SLOTracker:
    """Fold the window-record stream into burn rates and alert state.

    Call ``update(record)`` per record (in stream order); it returns —
    and annotates the record with — the per-objective state::

        {"latency_p99": {"burn_fast": 2.3, "burn_slow": 1.4,
                         "err_rate": 0.023, "alert": True}, ...}

    ``report()`` summarizes the whole stream: alert windows,
    activations (rising edges), first-alert times per objective.
    """

    def __init__(self, cfg: obw.ObserveConfig,
                 objectives: Iterable[SLObjective] | None = None):
        self.cfg = cfg
        self.objectives = tuple(objectives if objectives is not None
                                else default_objectives())
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self._err: dict[str, deque] = {
            o.name: deque(maxlen=o.slow_windows) for o in self.objectives
        }
        self._active: dict[str, bool] = {o.name: False
                                         for o in self.objectives}
        self._activations: dict[str, int] = {o.name: 0
                                             for o in self.objectives}
        self._alert_windows: dict[str, int] = {o.name: 0
                                               for o in self.objectives}
        self._first_alert_t: dict[str, float | None] = {
            o.name: None for o in self.objectives
        }
        self.n_windows = 0

    @staticmethod
    def _burn(errs, k: int, budget: float) -> float:
        tail = [e for e in list(errs)[-k:] if not math.isnan(e)]
        if not tail:
            return 0.0
        return float(np.mean(tail)) / budget

    def update(self, record: dict) -> dict:
        self.n_windows += 1
        state = {}
        for obj in self.objectives:
            err = window_error_rate(obj, record, self.cfg)
            dq = self._err[obj.name]
            dq.append(err)
            burn_fast = self._burn(dq, obj.fast_windows, obj.budget)
            burn_slow = self._burn(dq, obj.slow_windows, obj.budget)
            alert = (burn_fast >= obj.fast_burn
                     and burn_slow >= obj.slow_burn)
            if alert:
                self._alert_windows[obj.name] += 1
                if not self._active[obj.name]:
                    self._activations[obj.name] += 1
                    if self._first_alert_t[obj.name] is None:
                        self._first_alert_t[obj.name] = float(
                            record.get("t_end", float("nan")))
            self._active[obj.name] = alert
            state[obj.name] = {
                "err_rate": None if math.isnan(err) else err,
                "burn_fast": burn_fast,
                "burn_slow": burn_slow,
                "alert": alert,
            }
        record["slo"] = state
        return state

    def __call__(self, records: Iterable[dict]) -> None:
        """Batch form — chainable in front of an ``obs_sink``."""
        for rec in records:
            self.update(rec)

    @property
    def active_alerts(self) -> list:
        return [n for n, a in self._active.items() if a]

    def report(self) -> dict:
        return {
            "n_windows": self.n_windows,
            "objectives": {
                o.name: {
                    "metric": o.metric,
                    "threshold": o.threshold,
                    "budget": o.budget,
                    "alert_windows": self._alert_windows[o.name],
                    "activations": self._activations[o.name],
                    "first_alert_t": self._first_alert_t[o.name],
                    "active": self._active[o.name],
                }
                for o in self.objectives
            },
        }


def annotate(records, cfg: obw.ObserveConfig,
             objectives: Iterable[SLObjective] | None = None) -> SLOTracker:
    """Run a tracker over an existing record list (annotating each
    record with ``"slo"`` in place) and return it."""
    tracker = SLOTracker(cfg, objectives)
    tracker(records)
    return tracker


class SinkWithSLO:
    """Wrap an ``obs_sink`` so records are SLO-annotated (and optionally
    detector-aware dashboards stay live) before they hit the sink —
    drop-in for ``run_workload_scan(obs_sink=...)`` streamed runs."""

    def __init__(self, tracker: SLOTracker, sink=None):
        self.tracker = tracker
        self.sink = sink

    def __call__(self, records) -> None:
        recs = list(records)
        self.tracker(recs)
        if self.sink is not None:
            self.sink(recs)
