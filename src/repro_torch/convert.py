"""Carry a router's learned state, a model's parameters, optimizer state
and decode cache, and the chain simulator's params across from the JAX
package; name the reference parameter tree's leaves in its flatten order
(``reference_leaves``).

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


def _layer_leaf(tree: dict, name: str, i: int, n_layers: int,
                stack: str = "layers") -> np.ndarray:
    """Layer i's leaf ``name`` of the layer stack ``stack``: a stacked
    [L, ...] array under ``<stack>.<name>`` (``scan_layers=True``) or
    ``<stack>.<i>.<name>``."""
    if f"{stack}.{name}" in tree:
        a = np.asarray(tree[f"{stack}.{name}"])
        if a.shape[0] != n_layers:
            raise ValueError(f"{stack}.{name}: {a.shape[0]} layers, expected {n_layers}")
        return a[i]
    return np.asarray(tree[f"{stack}.{i}.{name}"])


def _layer_keys(tree: dict, n_layers: int, stack: str = "layers") -> set:
    """The names under which ``_layer_leaf`` finds leaves of ``stack``."""
    keys = set()
    for key in tree:
        if key.startswith(f"{stack}."):
            rest = key[len(stack) + 1:]
            head, _, tail = rest.partition(".")
            keys.add(tail if head.isdigit() and int(head) < n_layers else rest)
    return keys


def _arrays_for(model, tree: dict, stacks: dict) -> dict:
    """``tree``'s leaf for each of ``model``'s parameters (name -> array).
    ``stacks``: the layer stacks (name -> number of layers) whose leaves may
    come stacked; every other leaf, ``prefix_layers.<i>.<name>`` too, sits
    under the parameter's own name. Raises on a missing, unknown or
    misshapen leaf."""
    used, out = set(), {}
    for name, p in model.named_parameters():
        stack, _, rest = name.partition(".")
        if stack in stacks:
            i, _, rest = rest.partition(".")
            a = _layer_leaf(tree, rest, int(i), stacks[stack], stack)
            used.add(f"{stack}.{rest}")
        else:
            a = np.asarray(tree[name])
            used.add(name)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected {tuple(p.shape)}")
        out[name] = a
    have = {k for k in tree if k.partition(".")[0] not in stacks}
    for stack, n in stacks.items():
        have |= {f"{stack}.{k}" for k in _layer_keys(tree, n, stack)}
    if have - used:
        raise ValueError(f"leaves the port has no place for: {sorted(have - used)}")
    return out


def _params_from_numpy(model, tree: dict, stacks: dict):
    """Copy ``tree``'s leaves into ``model``'s parameters (``_arrays_for``)."""
    params = dict(model.named_parameters())
    for name, a in _arrays_for(model, tree, stacks).items():
        params[name].data.copy_(torch.from_numpy(np.array(a, np.float32)).to(params[name].dtype))
    return model


def _stacks(cfg, model) -> dict:
    """The layer stacks whose leaves the reference may stack ([L, ...])."""
    if cfg.family == "encdec":
        return {"enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_layers}
    return {"layers": len(model.layers)}


def reference_leaves(cfg, model) -> list:
    """The leaves of the reference's parameter tree in its flatten order
    (``jax.tree.leaves``: dict keys sorted at every level, list items in
    order), each as (its dotted key, the port's parameter names that it
    holds). A leaf of a stacked layer stack (``layers`` with
    ``scan_layers``, the encoder-decoder's ``enc_layers`` / ``dec_layers``,
    always stacked there) holds that parameter of every layer, in layer
    order; any other leaf holds one parameter. The optimizer's global norm
    and the int8 gradient sync (one key a leaf) walk this order."""
    stacked = set(_stacks(cfg, model))
    if cfg.family != "encdec" and not cfg.scan_layers:
        stacked = set()
    groups: dict = {}
    for name, _ in model.named_parameters():
        stack, _, rest = name.partition(".")
        key = f"{stack}.{rest.partition('.')[2]}" if stack in stacked else name
        groups.setdefault(key, []).append(name)

    def order(key):
        return tuple(int(part) if part.isdigit() else part for part in key.split("."))

    return [(key, groups[key]) for key in sorted(groups, key=order)]


def adamw_state_from_numpy(cfg, tree: dict, device=None):
    """The port's ``optim.adamw.AdamWState`` from the reference's, given as
    numpy: {"master", "m", "v": each a dotted-path tree as
    ``lm_params_from_numpy`` / ``encdec_params_from_numpy`` take it,
    "count": int}. Each leaf lands under the port's parameter names, f32,
    on ``device`` (None: the card)."""
    from repro_torch.optim.adamw import AdamWState

    dev = resolve_device(device)
    model = model_api.init_params(cfg, 0, "cpu")
    stacks = _stacks(cfg, model)
    part = {k: {name: torch.from_numpy(np.array(a, np.float32)).to(dev)
                for name, a in _arrays_for(model, tree[k], stacks).items()}
            for k in ("master", "m", "v")}
    return AdamWState(**part, count=torch.tensor(int(tree["count"]), dtype=torch.int32,
                                                 device=dev))


def lm_params_from_numpy(cfg, tree: dict, device=None):
    """The port's model (``models.lm``) holding the JAX package's
    parameters, given as numpy arrays under their dotted key paths
    (``embed``, ``final_norm.scale``, ``layers.attn.wq``, ``layers.ssm.A_log``,
    ``layers.moe.wg`` [L, E, d, f], ``layers.moe.shared.wg``,
    ``prefix_layers.0.mlp.wu``, ``patch_proj``, ...), the main layers
    stacked or per layer. Raises on a missing, unknown or misshapen
    leaf."""
    model = model_api.init_params(cfg, 0, device)
    return _params_from_numpy(model, tree, _stacks(cfg, model))


def encdec_params_from_numpy(cfg, tree: dict, device=None):
    """The port's encoder-decoder (``models.encdec``) holding the JAX
    package's parameters (``embed``, ``dec_pos``, ``enc_norm.scale``,
    ``enc_layers.attn.wq``, ``dec_layers.cross_attn.wk``, ...), the layers
    stacked or per layer."""
    model = model_api.init_params(cfg, 0, device)
    return _params_from_numpy(model, tree, _stacks(cfg, model))


_CACHE_LEAVES = {"attn": ("k", "v", "len"), "ssm": ("conv_x", "conv_bc", "h")}
_QUANT_LEAVES = ("k_q", "k_s", "v_q", "v_s", "len")


def _attn_cache_from(cfg, leaf, where: str, dev) -> dict:
    """One attention cache ({k, v, len} or the int8 form) from
    ``leaf(name)``; each row's ``len`` is the layer's ``len``."""
    dt = model_layers.DTYPES[cfg.dtype]
    names = ("k_q", "v_q", "k_s", "v_s") if cfg.kv_quant else ("k", "v")
    got = {name: leaf(name) for name in names}
    k = got[names[0]]
    shapes = {name: a.shape for name, a in got.items()}
    want = {name: k.shape[:3] if name.endswith("_s") else k.shape for name in names}
    if k.shape[2:] != (cfg.n_kv_heads, cfg.d_head) or shapes != want:
        raise ValueError(f"{where}: {shapes}")
    n = int(leaf("len"))
    t = lambda a, dtype: torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)  # noqa: E731
    dtypes = {"k": dt, "v": dt, "k_q": torch.int8, "v_q": torch.int8,
              "k_s": torch.bfloat16, "v_s": torch.bfloat16}
    out = {name: t(a, dtypes[name]) for name, a in got.items()}
    out["len"] = torch.full((k.shape[0],), n, dtype=torch.long, device=dev)
    return out


def lm_cache_from_numpy(cfg, tree: dict, device=None) -> list:
    """The port's decode cache (one nested dict per layer, the prefix
    layers first) from the JAX package's cache, as numpy arrays under
    ``layers.attn.k`` / ``.v`` / ``.len`` (or ``.k_q`` / ``.k_s`` / ``.v_q`` /
    ``.v_s`` / ``.len`` with ``kv_quant``) and ``layers.ssm.conv_x`` /
    ``.conv_bc`` / ``.h`` (stacked) or ``layers.<i>.attn.k`` / ..., and
    ``prefix.<i>.attn.k`` / ... for the moe family's dense prefix; each
    row's ``len`` is the layer's ``len``. Raises on a missing, unknown or
    misshapen leaf."""
    dev = resolve_device(device)
    dt = model_layers.DTYPES[cfg.dtype]
    prefix, main, n_prefix = model_lm.layer_kinds(cfg)
    n_main = cfg.n_layers - n_prefix
    leaves = dict(_CACHE_LEAVES, attn=_QUANT_LEAVES if cfg.kv_quant else _CACHE_LEAVES["attn"])
    want = {f"{part}.{leaf}" for part in model_lm.LAYER_PARTS[main] for leaf in leaves[part]}
    want |= {f"prefix.{i}.{part}.{leaf}" for i in range(n_prefix)
             for part in model_lm.LAYER_PARTS[prefix] for leaf in leaves[part]}
    have = _layer_keys(tree, n_main) | {k for k in tree if not k.startswith("layers.")}
    if have - want:
        raise ValueError(f"cache leaves the port has no place for: {sorted(have - want)}")
    t = lambda a, dtype: torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)  # noqa: E731
    out = []
    for i in range(cfg.n_layers):
        if i < n_prefix:
            kind = prefix
            leaf = lambda name: np.asarray(tree[f"prefix.{i}.{name}"])  # noqa: E731
        else:
            kind = main
            leaf = lambda name: _layer_leaf(tree, name, i - n_prefix, n_main)  # noqa: E731
        c = {}
        if "attn" in model_lm.LAYER_PARTS[kind]:
            c["attn"] = _attn_cache_from(cfg, lambda name: leaf(f"attn.{name}"),
                                         f"layer {i}", dev)
        if "ssm" in model_lm.LAYER_PARTS[kind]:
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


def encdec_cache_from_numpy(cfg, tree: dict, device=None) -> list:
    """The port's encoder-decoder decode cache (one {k, v, len} a decoder
    layer) from the JAX package's, as numpy arrays under ``layers.k`` /
    ``.v`` / ``.len`` (stacked) or ``layers.<i>.k`` / ...."""
    dev = resolve_device(device)
    have = _layer_keys(tree, cfg.n_layers) | {k for k in tree if not k.startswith("layers.")}
    if have - set(_CACHE_LEAVES["attn"]):
        raise ValueError(f"cache leaves the port has no place for: "
                         f"{sorted(have - set(_CACHE_LEAVES['attn']))}")
    return [_attn_cache_from(cfg, lambda name: _layer_leaf(tree, name, i, cfg.n_layers),
                             f"layer {i}", dev) for i in range(cfg.n_layers)]


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
