"""Wrapper of the hand-written chain kernel (``csrc/sim_chain.cu``).

``sim_chain`` runs a batch of chains that share their shapes (workers n,
slots mt, ring, arrival window, what is traced), each with its own policy,
flags, rounds, speeds and draw columns, for all their rounds. It checks
device, dtype, shape and contiguity. Given CPU tensors it runs the plain
chain from ``ref.py``; given CUDA tensors it launches the kernel (one
block a chain) on the current stream or raises. There is no fallback from
a failed build or launch to the plain chain.

``launches["sim_chain"]`` counts launches: a plain int raised by one
where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.core import policies as pol
from repro_torch.kernels.sim_chain import build, ref

launches = {"sim_chain": 0}

#: what one block takes: up to MAX_MT slots a job (kMaxMt in the source)
#: and a shared-memory footprint (``smem_bytes``) within SMEM_LIMIT, the
#: H100's 227 KB a block less 1 KB for the kernel's static shared memory
MAX_MT = 8
SMEM_LIMIT = 232448 - 1024


def smem_bytes(n: int, ring_cap: int, arrival_window: int) -> int:
    """The block's dynamic shared memory: the learner rings (8 B a slot),
    15 arrays of n words and the arrival window (see the source)."""
    return 8 * n * ring_cap + 60 * n + 4 * arrival_window


def check_shape(n: int, mt: int, ring_cap: int, arrival_window: int) -> None:
    """Raise on a shape the kernel does not take."""
    smem = smem_bytes(n, ring_cap, arrival_window)
    if not (n >= 1 and 1 <= mt <= MAX_MT and ring_cap >= 1 and arrival_window >= 1
            and smem <= SMEM_LIMIT):
        raise ValueError(
            f"sim_chain: n={n}, max_tasks={mt}, ring_cap={ring_cap}, "
            f"arrival_window={arrival_window} outside max_tasks <= {MAX_MT} and shared "
            f"memory 8·n·ring_cap + 60·n + 4·arrival_window = {smem} <= {SMEM_LIMIT} B")


#: the draw columns and their dtypes (``core.simulator.draw_rounds``)
COLS = {"dt": torch.float32, "ev": torch.int32, "u_svc": torch.float32,
        "u_fake": torch.float32, "j_fake": torch.int32, "n_tasks": torch.int32,
        "pins": torch.int32, "u": torch.float32, "j": torch.int32}


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype}{list(shape)}, got "
                         f"{t.dtype}{list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _device(ts) -> torch.device:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def sim_chain(conf_i, conf_f, mu_sched, mu_hat0, cols: dict, *, n: int, mt: int,
              ring_cap: int, arrival_window: int, trace_queues: bool, trace_mu: bool):
    """conf_i i32[C, NI], conf_f f32[C, NF], mu_sched f32[C, K, n], mu_hat0
    f32[C, n], and the draw columns ``cols`` (``core.simulator.draw_rounds``)
    stacked to [C, T, ...] -> (final, trace): dicts of tensors with the
    chain axis leading (``ref.final_shapes``, ``ref.trace_shapes``). A
    chain's rounds (conf_i[:, ROUNDS]) are at most T; its trace rows after
    them are zeros."""
    check_shape(n, mt, ring_cap, arrival_window)
    C, T = cols["dt"].shape
    K = mu_sched.shape[1]
    J = cols["j"].shape[2] if cols["j"].dim() == 3 else -1
    _check(conf_i, "conf_i", torch.int32, (C, ref.NI))
    _check(conf_f, "conf_f", torch.float32, (C, ref.NF))
    _check(mu_sched, "mu_sched", torch.float32, (C, K, n))
    _check(mu_hat0, "mu_hat0", torch.float32, (C, n))
    per_round = {"dt": (), "ev": (), "u_svc": (), "u_fake": (), "j_fake": (), "n_tasks": (),
                 "pins": (mt,), "u": (4, mt), "j": (J,)}
    if set(cols) != set(COLS):
        raise ValueError(f"cols: expected {sorted(COLS)}, got {sorted(cols)}")
    for name, dt in COLS.items():
        _check(cols[name], name, dt, (C, T) + per_round[name])
    if J < 2 * mt:
        raise ValueError(f"j: {J} integer draws a round, need at least 2·max_tasks")
    if C < 1 or K < 1:
        raise ValueError("need at least one chain and one phase")
    ins = (conf_i, conf_f, mu_sched, mu_hat0, *(cols[k] for k in COLS))
    dev = _device(ins)
    ci = conf_i.cpu()  # a few ints a chain: the kernel indexes by them
    rounds, phases, policy = ci[:, ref.ROUNDS], ci[:, ref.PHASES], ci[:, ref.POLICY]
    if bool((rounds < 0).any() or (rounds > T).any() or (phases < 1).any()
            or (phases > K).any() or (policy < 0).any()
            or (policy >= len(pol.ALL_POLICIES)).any()):
        raise ValueError("conf_i: rounds must lie in [0, T], phases in [1, K] and the "
                         "policy be an index of ALL_POLICIES")
    if dev.type == "cpu":
        return ref.sim_chain_ref(conf_i, conf_f, mu_sched, mu_hat0, cols, n=n, mt=mt,
                                 ring_cap=ring_cap, arrival_window=arrival_window,
                                 trace_queues=trace_queues, trace_mu=trace_mu)
    final = {name: torch.zeros((C,) + shape, dtype=dt, device=dev) for name, (dt, shape)
             in ref.final_shapes(n, ring_cap, arrival_window).items()}
    trace = {name: torch.zeros((C,) + shape, dtype=dt, device=dev) for name, (dt, shape)
             in ref.trace_shapes(T, n, mt, trace_queues, trace_mu).items()}
    ptr = lambda t: t.data_ptr()  # noqa: E731
    trace_order = ("code", "worker", "n_tasks", "task_workers", "task_targets", "frontend",
                   "view_gap", "sync_age", "now", "lam_hat", "killed_fake", "q_real",
                   "mu_hat")
    with torch.cuda.device(dev):
        err = build.load().sim_chain(
            *map(ptr, ins), C, T, n, mt, J, K, arrival_window, ring_cap,
            int(trace_queues), int(trace_mu),
            *(ptr(trace[k]) for k in trace_order), *map(ptr, final.values()),
            torch.cuda.current_stream(dev).cuda_stream)
    build.LIBRARY.raise_on(err, "sim_chain")
    if not torch.cuda.is_current_stream_capturing():
        launches["sim_chain"] += 1
    return final, trace


def reset_launches() -> None:
    launches["sim_chain"] = 0


def launch_counts() -> dict[str, int]:
    return dict(launches)
