"""Carry a router's learned state, a model's parameters and decode cache,
and the chain simulator's params across from the JAX package.

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
from repro_torch.models import api as model_api
from repro_torch.models import layers as model_layers
from repro_torch.models import lm as model_lm
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


# ---------------------------------------------------------------------------
# Model parameters and decode caches
# ---------------------------------------------------------------------------


def _layer_leaf(tree: dict, name: str, i: int, n_layers: int) -> np.ndarray:
    """Layer i's leaf ``name``: a stacked [L, ...] array under
    ``layers.<name>`` (``scan_layers=True``) or ``layers.<i>.<name>``."""
    if f"layers.{name}" in tree:
        a = np.asarray(tree[f"layers.{name}"])
        if a.shape[0] != n_layers:
            raise ValueError(f"layers.{name}: {a.shape[0]} layers, expected {n_layers}")
        return a[i]
    return np.asarray(tree[f"layers.{i}.{name}"])


def _layer_keys(tree: dict, n_layers: int) -> set:
    """The names under which ``_layer_leaf`` finds layer leaves."""
    keys = set()
    for key in tree:
        if key.startswith("layers."):
            rest = key[len("layers."):]
            head, _, tail = rest.partition(".")
            keys.add(tail if head.isdigit() and int(head) < n_layers else rest)
    return keys


def lm_params_from_numpy(cfg, tree: dict, device=None):
    """The port's model (``models.lm``) holding the JAX package's
    parameters, given as numpy arrays under their dotted key paths
    (``embed``, ``final_norm.scale``, ``layers.attn.wq``, ``layers.ssm.A_log``,
    ...), stacked or per layer. Raises on a missing, unknown or misshapen
    leaf."""
    model = model_api.init_params(cfg, 0, device)
    used = set()
    for name, p in model.named_parameters():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            a = _layer_leaf(tree, rest, int(i), cfg.n_layers)
            used.add(f"layers.{rest}")
        else:
            a = np.asarray(tree[name])
            used.add(name)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected {tuple(p.shape)}")
        p.data.copy_(torch.from_numpy(np.array(a, np.float32)).to(p.dtype))
    top = {k for k in tree if not k.startswith("layers.")}
    layer = {f"layers.{k}" for k in _layer_keys(tree, cfg.n_layers)}
    if (top | layer) - used:
        raise ValueError(f"leaves the port has no place for: {sorted((top | layer) - used)}")
    return model


_CACHE_LEAVES = {"attn": ("k", "v", "len"), "ssm": ("conv_x", "conv_bc", "h")}


def lm_cache_from_numpy(cfg, tree: dict, device=None) -> list:
    """The port's decode cache (one nested dict per layer) from the JAX
    package's cache, as numpy arrays under ``layers.attn.k`` / ``.v`` /
    ``.len`` and ``layers.ssm.conv_x`` / ``.conv_bc`` / ``.h`` (stacked) or
    ``layers.<i>.attn.k`` / ...; each row's ``len`` is the layer's ``len``.
    Raises on a missing, unknown or misshapen leaf."""
    dev = resolve_device(device)
    dt = model_layers.DTYPES[cfg.dtype]
    parts = model_lm.LAYER_PARTS[model_lm._layer_kind(cfg)]
    want = {f"{part}.{leaf}" for part in parts for leaf in _CACHE_LEAVES[part]}
    have = _layer_keys(tree, cfg.n_layers) | {k for k in tree if not k.startswith("layers.")}
    if have - want:
        raise ValueError(f"cache leaves the port has no place for: {sorted(have - want)}")
    t = lambda a, dtype: torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)  # noqa: E731
    out = []
    for i in range(cfg.n_layers):
        leaf = lambda name: _layer_leaf(tree, name, i, cfg.n_layers)  # noqa: E731
        c = {}
        if "attn" in parts:
            k, v = leaf("attn.k"), leaf("attn.v")
            n = int(leaf("attn.len"))
            if k.shape != v.shape or k.shape[2:] != (cfg.n_kv_heads, cfg.d_head):
                raise ValueError(f"layer {i}: k {k.shape}, v {v.shape}")
            c["attn"] = {"k": t(k, dt), "v": t(v, dt),
                         "len": torch.full((k.shape[0],), n, dtype=torch.long, device=dev)}
        if "ssm" in parts:
            conv_x, conv_bc, h = leaf("ssm.conv_x"), leaf("ssm.conv_bc"), leaf("ssm.h")
            batch = h.shape[0]
            shapes = {"conv_x": (batch, cfg.d_conv - 1, cfg.d_inner),
                      "conv_bc": (batch, cfg.d_conv - 1, 2 * cfg.ssm_state),
                      "h": (batch, cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_headdim)}
            got = {"conv_x": conv_x, "conv_bc": conv_bc, "h": h}
            for name, shape in shapes.items():
                if got[name].shape != shape:
                    raise ValueError(f"layer {i}: ssm.{name} {got[name].shape}, "
                                     f"expected {shape}")
            c["ssm"] = {"conv_x": t(conv_x, dt), "conv_bc": t(conv_bc, dt),
                        "h": t(h, torch.float32)}
        out.append(c)
    return out


#: the chain simulator's params, by the reference's field names
SIM_PARAMS = ("lam", "mu_schedule", "phase_period", "mu_bar", "mu_hat0", "task_logits",
              "lb_weights")


def sim_params_from_reference(d: dict, device=None):
    """The port's ``core.simulator.SimParams`` from the reference's
    ``SimParams`` leaves given as numpy arrays (name -> array, the names in
    ``SIM_PARAMS``), as float32 tensors on ``device`` (``None``: the card)."""
    from repro_torch.core.simulator import SimParams

    dev = resolve_device(device)
    return SimParams(**{k: torch.from_numpy(np.array(d[k], np.float32)).to(dev)
                        for k in SIM_PARAMS})


#: the chain simulator's environment tracks, by the reference's field names
ENV_SCHEDULE = ("lam_bp", "lam_val", "mu_bp", "mu_val", "act_bp", "act_val", "burst",
                "stall_bp", "stall_val", "crash_t", "crash_w")


def env_schedule_from_reference(d: dict | None, device=None):
    """The port's ``core.simulator.EnvSchedule`` from the reference's
    ``EnvSchedule`` leaves given as numpy arrays (name -> array or None, the
    names in ``ENV_SCHEDULE``; ``d`` None for no environment) on ``device``
    (``None``: the card): the breakpoints and rates as float32, the masks
    as bool, the burst and the crashed workers as int32."""
    if d is None:
        return None
    from repro_torch.core.simulator import EnvSchedule

    dev = resolve_device(device)
    dtypes = {"act_val": np.bool_, "stall_val": np.bool_, "burst": np.int32,
              "crash_w": np.int32}

    def t(k):
        v = d.get(k)
        return None if v is None else torch.from_numpy(
            np.array(v, dtypes.get(k, np.float32))).to(dev)

    return EnvSchedule(**{k: t(k) for k in ENV_SCHEDULE})
