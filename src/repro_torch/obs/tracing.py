"""Decision-lifecycle tracing and profiler hooks.

``DecisionTrace`` captures structured per-task lifecycle events
(arrive → place → launch → {complete | kill | timeout → retry}) into a
bounded ring (oldest events drop; memory stays O(cap) no matter the
horizon) and exports them as Chrome trace-event JSON loadable in
Perfetto / chrome://tracing: one duration slice per task copy on its
worker's track, instant markers for kills/timeouts/retries.

``windows_to_chrome_trace`` converts a window-record stream (the scan's
telemetry rows — available even when no per-task trace was
materialized) into Perfetto counter tracks, so a million-request
stream-only run still produces a loadable trace.

``trace_annotation`` / ``step_annotation`` wrap
``torch.profiler.record_function`` (a no-op unless a profiler session
is active), with an NVTX range (``torch.cuda.nvtx``) beside it when the
``device`` given is a CUDA one, so profiler and NVTX timelines segment by
chunk. They are null contexts only where torch has no profiler API.

Copied from the JAX package's ``obs/tracing.py``: ``DecisionTrace``,
``windows_to_chrome_trace`` and ``save_chrome_trace`` verbatim; the
annotations, which wrap ``jax.profiler`` there, on torch's profiler.
"""
from __future__ import annotations

import contextlib
import json
from collections import deque

import torch

try:  # stay importable if the profiler API moves
    from torch.profiler import record_function
except Exception:  # pragma: no cover - profiler API absent
    record_function = None


@contextlib.contextmanager
def _nvtx(name: str):
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


def _annotation(name: str, args: str | None, device):
    if record_function is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(record_function(name, args))
    if device is not None and torch.device(device).type == "cuda":
        stack.enter_context(_nvtx(name))
    return stack


def trace_annotation(name: str, *, device=None, **kwargs):
    """``torch.profiler.record_function(name)`` (its keyword arguments as the
    record's argument string), plus an NVTX range on a CUDA ``device``; a
    null context where torch has no profiler API."""
    args = ",".join(f"{k}={v}" for k, v in sorted(kwargs.items())) or None
    return _annotation(name, args, device)


def step_annotation(name: str, step: int, device=None):
    """``trace_annotation`` of step ``step`` (``step_num=step``), the form the
    chunk driver wraps each chunk in."""
    return _annotation(name, f"step_num={int(step)}", device)


# event phases in the ring
ARRIVE, PLACE, LAUNCH, COMPLETE, KILL, TIMEOUT, RETRY = (
    "arrive", "place", "launch", "complete", "kill", "timeout", "retry",
)
_US = 1e6  # trace-event timestamps are microseconds; sim time is seconds


class DecisionTrace:
    """Bounded ring of decision-lifecycle events.

    ``sample_every`` thins by task id (task % sample_every == 0) so the
    ring covers the whole horizon instead of only its tail when the
    event volume exceeds ``cap``.
    """

    def __init__(self, cap: int = 65536, sample_every: int = 1):
        self.cap = int(cap)
        self.sample_every = max(int(sample_every), 1)
        self.ring: deque = deque(maxlen=self.cap)
        self.dropped = 0
        self.seen = 0

    def _keep(self, task: int) -> bool:
        return task < 0 or (task % self.sample_every) == 0

    def event(self, phase: str, t: float, task: int, *, worker: int = -1,
              frontend: int = 0, attempt: int = 0) -> None:
        self.seen += 1
        if not self._keep(task):
            return
        if len(self.ring) == self.cap:
            self.dropped += 1
        self.ring.append(
            (phase, float(t), int(task), int(worker), int(frontend),
             int(attempt))
        )

    # convenience wrappers (keep call sites readable in the loops)
    def arrive(self, t, task, frontend=0):
        self.event(ARRIVE, t, task, frontend=frontend)

    def place(self, t, task, worker, frontend=0, attempt=0):
        self.event(PLACE, t, task, worker=worker, frontend=frontend,
                   attempt=attempt)

    def launch(self, t, task, worker, attempt=0):
        self.event(LAUNCH, t, task, worker=worker, attempt=attempt)

    def complete(self, t, task, worker, attempt=0):
        self.event(COMPLETE, t, task, worker=worker, attempt=attempt)

    def kill(self, t, task, worker, attempt=0):
        self.event(KILL, t, task, worker=worker, attempt=attempt)

    def timeout(self, t, task, worker, attempt=0):
        self.event(TIMEOUT, t, task, worker=worker, attempt=attempt)

    def retry(self, t, task, worker, attempt=0):
        self.event(RETRY, t, task, worker=worker, attempt=attempt)

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable).

        Each task copy becomes one complete ("X") slice on its worker's
        thread track from launch (falling back to place/arrive) to its
        terminal event; kills/timeouts/retries add instant ("i")
        markers. pid = frontend, tid = worker.
        """
        open_at: dict = {}  # (task, attempt) -> (t, worker, frontend)
        events = []
        for phase, t, task, worker, frontend, attempt in self.ring:
            key = (task, attempt)
            if phase in (ARRIVE, PLACE, LAUNCH):
                # keep the earliest open point; refine worker when known
                t0, w0, f0 = open_at.get(key, (t, worker, frontend))
                if worker >= 0:
                    w0 = worker
                if frontend >= 0 and phase != LAUNCH:
                    f0 = frontend
                open_at[key] = (min(t0, t), w0, f0)
                if phase == ARRIVE:
                    events.append({
                        "name": "arrive", "ph": "i", "s": "t",
                        "ts": t * _US, "pid": max(frontend, 0),
                        "tid": 0, "args": {"task": task},
                    })
            elif phase in (COMPLETE, KILL, TIMEOUT):
                t0, w0, f0 = open_at.pop(key, (t, worker, frontend))
                w = worker if worker >= 0 else w0
                events.append({
                    "name": f"task{task}.{attempt}", "ph": "X",
                    "ts": t0 * _US, "dur": max(t - t0, 0.0) * _US,
                    "pid": max(f0, 0), "tid": max(w, 0),
                    "args": {"task": task, "attempt": attempt,
                             "outcome": phase},
                })
                if phase in (KILL, TIMEOUT):
                    events.append({
                        "name": phase, "ph": "i", "s": "t", "ts": t * _US,
                        "pid": max(f0, 0), "tid": max(w, 0),
                        "args": {"task": task, "attempt": attempt},
                    })
            elif phase == RETRY:
                events.append({
                    "name": "retry", "ph": "i", "s": "t", "ts": t * _US,
                    "pid": max(frontend, 0), "tid": max(worker, 0),
                    "args": {"task": task, "attempt": attempt},
                })
        # tasks still open at export: emit zero-duration begin markers
        for (task, attempt), (t0, w0, f0) in open_at.items():
            events.append({
                "name": f"task{task}.{attempt} (open)", "ph": "i",
                "s": "t", "ts": t0 * _US, "pid": max(f0, 0),
                "tid": max(w0, 0), "args": {"task": task},
            })
        events.sort(key=lambda e: e["ts"])
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "events_seen": self.seen,
                "events_dropped": self.dropped,
                "sample_every": self.sample_every,
            },
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


_COUNTER_KEYS = [
    ("p50", "latency p50 (s)"),
    ("p99", "latency p99 (s)"),
    ("throughput", "throughput (rps)"),
    ("goodput", "goodput (rps)"),
    ("lam_hat", "lambda-hat (rps)"),
    ("arrival_rate", "arrival rate (rps)"),
    ("q_mean", "queue depth mean"),
    ("q_max", "queue depth max"),
    ("in_flight", "tasks in flight"),
    ("mu_rel_err", "mu-hat shape error"),
]


def windows_to_chrome_trace(records: list) -> dict:
    """Window-record stream → Perfetto counter tracks ("C" events).

    The stream-only companion to ``DecisionTrace``: derived entirely
    from the in-scan window rows, so it exists even when no per-task
    trace was materialized. Regime detections (``obs.detect``) and SLO
    burn-rate alerts (``obs.slo`` annotations) become instant markers
    on the same timeline, so a Perfetto view shows WHEN the system
    noticed each shift against the metric curves.
    """
    events = []
    slo_active: set = set()
    for rec in records:
        ts = float(rec["t_end"]) * _US
        for key, name in _COUNTER_KEYS:
            v = rec.get(key)
            if v is None:
                continue
            v = float(v)
            if v != v:  # NaN (empty window)
                continue
            events.append({
                "name": name, "ph": "C", "ts": ts, "pid": 0,
                "args": {name: v},
            })
        if rec.get("detected", 0):
            events.append({
                "name": f"regime:{rec.get('detected_label', 'shift')}",
                "ph": "i", "s": "g", "ts": ts, "pid": 0, "tid": 0,
                "args": {"turn": rec.get("turn"),
                         "window": rec.get("window"),
                         "regime": rec.get("regime_label")},
            })
        for obj_name, st in (rec.get("slo") or {}).items():
            firing = bool(st.get("alert"))
            was = obj_name in slo_active
            if firing and not was:
                slo_active.add(obj_name)
                events.append({
                    "name": f"slo-alert:{obj_name}", "ph": "i", "s": "g",
                    "ts": ts, "pid": 0, "tid": 0,
                    "args": {"burn_fast": st.get("burn_fast"),
                             "burn_slow": st.get("burn_slow")},
                })
            elif was and not firing:
                slo_active.discard(obj_name)
                events.append({
                    "name": f"slo-clear:{obj_name}", "ph": "i", "s": "g",
                    "ts": ts, "pid": 0, "tid": 0, "args": {},
                })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def save_chrome_trace(trace: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(trace, f)
