"""Host-side sinks for the window stream.

Three exporters over the record schema of ``windows.record_from_state``:

  * ``prometheus_snapshot`` — Prometheus text exposition (one scrapeable
    snapshot per window record, histogram in cumulative-bucket form);
  * ``JsonlSink`` — append-only JSONL, one record per line (callable, so
    it plugs straight into ``run_workload_scan(obs_sink=...)`` and
    streams across chunk boundaries in bounded memory);
  * ``dashboard`` — terminal printer for the examples (a live, aligned
    per-window table instead of a final-summary-only dump).

Copied verbatim from the JAX package's ``obs/export.py``.
"""
from __future__ import annotations

import json
import math
from typing import IO, Iterable

from repro_torch.obs import windows as obw


def rss_mb() -> float:
    """Current resident-set size in MiB (stdlib-only: /proc on Linux,
    ``resource`` peak elsewhere — callers sampling per chunk get a flat
    series exactly when the streamed path is truly bounded-memory)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return peak_rss_mb()


def peak_rss_mb() -> float:
    """Process-lifetime peak RSS in MiB (ru_maxrss; kilobytes on Linux)."""
    import resource
    import sys

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return peak / (1024.0 if sys.platform != "darwin" else 1024.0 * 1024.0)


# record key → (prometheus metric name, type, help)
_PROM_GAUGES = [
    ("p50", "rosella_latency_p50_seconds", "windowed p50 response time"),
    ("p99", "rosella_latency_p99_seconds", "windowed p99 response time"),
    ("p999", "rosella_latency_p999_seconds", "windowed p999 response time"),
    ("throughput", "rosella_throughput_rps", "completed responses per second"),
    ("goodput", "rosella_goodput_rps", "clean completions per second"),
    ("arrival_rate", "rosella_arrival_rate_rps", "realized arrival rate"),
    ("lam_hat", "rosella_lam_hat_rps", "arrival-rate estimate"),
    ("mu_rel_err", "rosella_mu_rel_err", "shape-normalized mu-hat error"),
    ("q_mean", "rosella_queue_depth_mean", "mean active queue depth"),
    ("q_max", "rosella_queue_depth_max", "max queue depth in window"),
    ("collision_rate", "rosella_herd_collision_rate",
     "share of placements colliding across frontends"),
    ("in_flight", "rosella_tasks_in_flight", "launched - completed - killed"),
    ("n_active", "rosella_workers_active", "active-worker membership count"),
    # regime-detector keys (present when ObserveConfig.detect is on)
    ("regime", "rosella_regime", "regime label code (obs.detect.REGIMES)"),
    ("detected", "rosella_regime_detected",
     "regime kind fired this window (0 = none)"),
]
_PROM_COUNTERS = [
    ("launched", "rosella_copies_launched_total"),
    ("completed", "rosella_completions_clean_total"),
    ("dirty", "rosella_completions_dirty_total"),
    ("killed", "rosella_copies_killed_total"),
    ("retried", "rosella_retries_total"),
    ("det_count", "rosella_regime_detections_total"),
]


def _finite(v) -> bool:
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


def prometheus_snapshot(cfg: obw.ObserveConfig, record: dict,
                        labels: dict | None = None) -> str:
    """One window record → Prometheus text-exposition snapshot."""
    lab = "".join(
        f'{k}="{v}",' for k, v in sorted((labels or {}).items())
    ).rstrip(",")
    lab = "{" + lab + "}" if lab else ""
    lines = []
    for key, name, help_ in _PROM_GAUGES:
        v = record.get(key)
        if _finite(v):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{lab} {float(v):.9g}")
    for key, name in _PROM_COUNTERS:
        v = record.get(key)
        if _finite(v):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name}{lab} {int(v)}")
    slo = record.get("slo")
    if slo:
        base = lab[1:-1] if lab else ""
        sep = "," if base else ""
        for metric, help_ in (
            ("burn_fast", "fast-window SLO burn rate"),
            ("burn_slow", "slow-window SLO burn rate"),
            ("alert", "1 while the multi-window burn alert is active"),
        ):
            name = f"rosella_slo_{metric}"
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            for obj_name, st in slo.items():
                v = st.get(metric)
                val = float(bool(v)) if metric == "alert" else v
                if _finite(val):
                    lines.append(
                        f'{name}{{{base}{sep}objective="{obj_name}"}} '
                        f"{float(val):.9g}"
                    )
    hist = record.get("hist")
    if hist is not None:
        edges = obw.bin_edges(cfg)
        name = "rosella_latency_seconds"
        lines.append(f"# HELP {name} windowed response-time histogram")
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        base = lab[1:-1] if lab else ""
        sep = "," if base else ""
        for i, c in enumerate(hist):
            cum += int(c)
            lines.append(
                f'{name}_bucket{{{base}{sep}le="{edges[i + 1]:.6g}"}} {cum}'
            )
        lines.append(f'{name}_bucket{{{base}{sep}le="+Inf"}} {cum}')
        lines.append(f"{name}_count{lab} {cum}")
        mean = record.get("mean_est")
        total = cum * float(mean) if _finite(mean) else 0.0
        lines.append(f"{name}_sum{lab} {total:.9g}")
    return "\n".join(lines) + "\n"


class JsonlSink:
    """Append-only JSONL sink; usable as ``obs_sink`` (called with a
    list of records per scan chunk) or record-by-record via ``write``."""

    def __init__(self, path: str):
        self.path = path
        self.count = 0
        self._f: IO | None = open(path, "a")

    def write(self, record: dict) -> None:
        assert self._f is not None, "sink is closed"
        self._f.write(json.dumps(_jsonable(record)) + "\n")
        self.count += 1

    def __call__(self, records: Iterable[dict]) -> None:
        for r in records:
            self.write(r)
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _jsonable(record: dict) -> dict:
    out = {}
    for k, v in record.items():
        if isinstance(v, float) and not math.isfinite(v):
            out[k] = None
        else:
            out[k] = v
    return out


_DASH_COLS = [
    ("win", "window", "{:>4d}"),
    ("t", "t_end", "{:>8.1f}"),
    ("p50", "p50", "{:>8.3f}"),
    ("p99", "p99", "{:>8.2f}"),
    ("p999", "p999", "{:>8.2f}"),
    ("thru/s", "throughput", "{:>8.1f}"),
    ("good/s", "goodput", "{:>8.1f}"),
    ("lam^", "lam_hat", "{:>7.2f}"),
    ("muErr", "mu_rel_err", "{:>7.3f}"),
    ("qAvg", "q_mean", "{:>7.2f}"),
    ("qMax", "q_max", "{:>5d}"),
    ("kill", "killed", "{:>5d}"),
    ("rtry", "retried", "{:>5d}"),
    ("infl", "in_flight", "{:>5d}"),
]


def dashboard_header() -> str:
    return " ".join(f"{h:>{len(fmt.format(0))}s}"
                    for h, _, fmt in _DASH_COLS)


def dashboard_row(record: dict) -> str:
    cells = []
    for _, key, fmt in _DASH_COLS:
        v = record.get(key)
        if v is None or (isinstance(v, float) and not math.isfinite(v)):
            cells.append(f"{'-':>{len(fmt.format(0))}s}")
        else:
            cells.append(fmt.format(int(v) if "d" in fmt else float(v)))
    line = " ".join(cells)
    # active introspection state rides the row's tail: the regime label
    # while non-stable (detector on) and any firing SLO burn alerts
    if record.get("regime", 0):
        line += f"  << {record.get('regime_label', record['regime'])}"
        if record.get("detected", 0):
            line += " !"
    alerts = [n for n, st in (record.get("slo") or {}).items()
              if st.get("alert")]
    if alerts:
        line += f"  ** SLO ALERT: {','.join(alerts)} **"
    return line


def dashboard(records: Iterable[dict], *, title: str | None = None,
              print_fn=print) -> None:
    """Print the live window dashboard for a stream of records."""
    if title:
        print_fn(f"--- {title} ---")
    print_fn(dashboard_header())
    for rec in records:
        print_fn(dashboard_row(rec))
