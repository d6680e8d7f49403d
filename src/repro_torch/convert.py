"""Carry a router's learned state across from the JAX package.

For a scheduler the learned state plays the part of weights: the queue
view, the arrival estimator, the learner's rings and μ̂, the routing
snapshot and its alias table, and the key. A JAX ``RosellaRouter``'s state
exported as numpy arrays, under the names below, loads into the port's
router; both packages then compute the same next turn.

    q_view                         i32[n]
    arr.last_time, arr.mean_gap    f32 scalars;  arr.count  int
    learner.samples, .stamps       f32[n, cap]
    learner.widx, .count           i32[n]
    learner.epoch_start, .mu_hat   f32[n]
    mu_front                       f32[n]
    table.prob, table.alias        f32[n], i32[n]   (alias routers only)
    mu_pending                     f32[n]           (optional)
    active                         bool[n]          (optional)
    key                            u32[2]
    last_fake_time                 float
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dispatch as dsp
from repro_torch.core import estimator as est
from repro_torch.core import learner as lrn
from repro_torch.utils.device import resolve_device

_LEARNER = ("samples", "stamps", "widx", "count", "epoch_start", "mu_hat")


def router_state_from_numpy(d: dict, device=None) -> dict:
    """The port's router attributes (name -> value) for an exported state."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
    out = {
        "q_view": t(np.asarray(d["q_view"], np.int32)),
        "arr": est.EmaArrivalState(
            last_time=np.float32(d["arr.last_time"]),
            mean_gap=np.float32(d["arr.mean_gap"]),
            count=int(d["arr.count"])),
        "learner": lrn.LearnerState(**{f: t(d[f"learner.{f}"]) for f in _LEARNER}),
        "mu_front": t(np.asarray(d["mu_front"], np.float32)),
        "table_front": None,
        "_mu_pending": None,
        "_mu_event": None,
        "active": None,
        "key": tuple(int(k) for k in np.asarray(d["key"], np.uint32)),
        "last_fake_time": float(d["last_fake_time"]),
    }
    if d.get("table.prob") is not None:
        out["table_front"] = dsp.AliasTable(
            prob=t(np.asarray(d["table.prob"], np.float32)),
            alias=t(np.asarray(d["table.alias"], np.int32)))
    if d.get("mu_pending") is not None:
        out["_mu_pending"] = t(np.asarray(d["mu_pending"], np.float32))
    if d.get("active") is not None:
        out["active"] = t(np.asarray(d["active"], bool))
    return out


def load_router_state(router, d: dict) -> None:
    """Set an exported state onto a port ``RosellaRouter`` in place."""
    for name, value in router_state_from_numpy(d, router.device).items():
        setattr(router, name, value)
