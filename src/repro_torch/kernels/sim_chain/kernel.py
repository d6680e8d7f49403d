"""Wrapper of the hand-written chain kernel (``csrc/sim_chain.cu``).

``sim_chain`` runs a batch of chains that share their shapes (workers n,
slots mt, ring, arrival window, what is traced), each with its own policy,
flags, rounds, speeds and draw columns, for all their rounds. It checks
device, dtype, shape and contiguity. Given CPU tensors it runs the plain
chain from ``ref.py``; given CUDA tensors it launches the kernel (one
block a chain) on the current stream or raises. There is no fallback from
a failed build or launch to the plain chain.

The wrapper sizes the block's shared memory: the ring stride
(``ring_stride``) and the rounds a tile stages (``tile_rounds``), within
``smem_bytes``'s formula, the kernel's own.

``launches["sim_chain"]`` counts launches: a plain int raised by one
where the kernel is launched and nowhere else. ``clock_split`` makes the
same launch through the clocked build (``build.CLOCKED``), uncounted, and
returns each chain's cycles by phase (``read_clocks``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import policies as pol
from repro_torch.kernels.sim_chain import build, ref

launches = {"sim_chain": 0}

#: what one block takes: up to MAX_MT slots a job (kMaxMt in the source)
#: and a shared-memory footprint (``smem_bytes``) within SMEM_LIMIT, the
#: H100's 227 KB a block less 1 KB for the kernel's static shared memory
MAX_MT = 8
SMEM_LIMIT = 232448 - 1024
#: the longest tile of rounds staged in shared memory (``tile_rounds``)
TILE_MAX = 256
#: arrays of n words in the block's state (kStateArrays in the source),
#: beside the table's stack of n + 4 (index, weight) pairs
STATE_ARRAYS = 12


def record_words(mt: int) -> int:
    """A round's trace record in words (rec_words in the source): code,
    worker, n_tasks, now, lam_hat and the workers and targets of 1 slot, or
    of MAX_MT when mt > 1, padded to 16 bytes."""
    return (5 + 2 * (1 if mt == 1 else MAX_MT) + 3) // 4 * 4


def _col_words(tile: int, width: int) -> int:
    """A staged column's tile region in words (col_words in the source)."""
    return (tile * width + 3) // 4 * 4 + 4


def smem_bytes(n: int, mt: int, ring_cap: int, arrival_window: int, *, tile: int = 1,
               stride: int | None = None, J: int | None = None, trace_queues: bool = True,
               trace_mu: bool = True) -> int:
    """The block's dynamic shared memory (smem_bytes in the source): a
    tile region for each staged column (draws: six of width 1, mt, 4·mt
    and J = 2·mt unless given; the trace: a record a round of
    ``record_words(mt)``, and n for the queue and μ̂ rows when traced), the
    learner rings (8 B a slot, ``stride`` >= n words a slot, n unless
    given), the table's stack (8·(n + 4) B), STATE_ARRAYS arrays of n words
    and the arrival window."""
    J = 2 * mt if J is None else J
    stride = n if stride is None else stride
    widths = [1] * 6 + [mt, 4 * mt, J] + [record_words(mt), n if trace_queues else 0,
                                          n if trace_mu else 0]
    return 4 * (sum(_col_words(tile, w) for w in widths) + 2 * stride * ring_cap
                + 2 * (n + 4) + STATE_ARRAYS * n + arrival_window)


def ring_stride(n: int, mt: int, ring_cap: int, arrival_window: int, **kw) -> int:
    """The words a ring slot spans: n rounded up to a multiple of 32 where a
    tile of one round still fits (a refresh then reads every worker's ring
    on its lane's bank), else n."""
    padded = -(-n // 32) * 32
    fits = smem_bytes(n, mt, ring_cap, arrival_window, stride=padded, **kw) <= SMEM_LIMIT
    return padded if fits else n


def tile_rounds(T: int, n: int, mt: int, ring_cap: int, arrival_window: int, **kw) -> int:
    """The rounds a tile stages: the most, up to TILE_MAX and T, whose
    footprint fits in SMEM_LIMIT (at least one; ``check_shape`` first);
    ``kw``: ``smem_bytes``'s stride, J and trace flags."""
    tile = max(1, min(TILE_MAX, T))
    while tile > 1 and smem_bytes(n, mt, ring_cap, arrival_window, tile=tile, **kw) > SMEM_LIMIT:
        tile -= 1
    return tile


def check_shape(n: int, mt: int, ring_cap: int, arrival_window: int, **kw) -> None:
    """Raise on a shape the kernel does not take: a tile of one round must
    fit beside the rings (``kw``: ``smem_bytes``'s J and trace flags)."""
    smem = smem_bytes(n, mt, ring_cap, arrival_window, **kw)
    if not (n >= 1 and 1 <= mt <= MAX_MT and ring_cap >= 1 and arrival_window >= 1
            and smem <= SMEM_LIMIT):
        raise ValueError(
            f"sim_chain: n={n}, max_tasks={mt}, ring_cap={ring_cap}, "
            f"arrival_window={arrival_window} outside max_tasks <= {MAX_MT} and shared "
            f"memory 8·n·ring_cap + {4 * STATE_ARRAYS + 8}·n + 32 + 4·arrival_window + a tile "
            f"of one round = {smem} <= {SMEM_LIMIT} B")


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
    C, T = cols["dt"].shape
    K = mu_sched.shape[1]
    J = cols["j"].shape[2] if cols["j"].dim() == 3 else -1
    check_shape(n, mt, ring_cap, arrival_window, J=max(J, 2 * mt),
                trace_queues=trace_queues, trace_mu=trace_mu)
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
    out = _launch(build.LIBRARY, ins, dev, C, T, n, mt, J, K, ring_cap, arrival_window,
                  trace_queues, trace_mu)
    if not torch.cuda.is_current_stream_capturing():
        launches["sim_chain"] += 1
    return out


def _launch(lib, ins, dev, C, T, n, mt, J, K, ring_cap, arrival_window, trace_queues,
            trace_mu):
    """One launch of ``lib``'s kernel on checked CUDA inputs: (final, trace)."""
    final = {name: torch.zeros((C,) + shape, dtype=dt, device=dev) for name, (dt, shape)
             in ref.final_shapes(n, ring_cap, arrival_window).items()}
    trace = {name: torch.zeros((C,) + shape, dtype=dt, device=dev) for name, (dt, shape)
             in ref.trace_shapes(T, n, mt, trace_queues, trace_mu).items()}
    ptr = lambda t: t.data_ptr()  # noqa: E731
    trace_order = ("code", "worker", "n_tasks", "task_workers", "task_targets", "frontend",
                   "view_gap", "sync_age", "now", "lam_hat", "killed_fake", "q_real",
                   "mu_hat")
    kw = dict(J=J, trace_queues=trace_queues, trace_mu=trace_mu)
    stride = ring_stride(n, mt, ring_cap, arrival_window, **kw)
    tile = tile_rounds(T, n, mt, ring_cap, arrival_window, stride=stride, **kw)
    with torch.cuda.device(dev):
        err = lib.load().sim_chain(
            *map(ptr, ins), C, T, n, mt, J, K, arrival_window, ring_cap, stride, tile,
            int(trace_queues), int(trace_mu),
            *(ptr(trace[k]) for k in trace_order), *map(ptr, final.values()),
            torch.cuda.current_stream(dev).cuda_stream)
    lib.raise_on(err, "sim_chain")
    return final, trace


#: the clocked build's record of a chain (csrc/sim_chain.cu: CK_* cycles,
#: then CN_* counts), kept for the first CLOCK_CHAINS chains of a launch
CLOCK_PHASES = ("setup", "head", "arrival", "service", "fake", "rebuild", "refresh", "trace",
                "tile", "barrier")
CLOCK_COUNTS = ("rounds", "arrivals", "services", "fakes", "refreshes", "rebuilds", "tiles")
CLOCK_CHAINS = 64


def read_clocks(lib, chains: int) -> list[dict]:
    """The per-phase cycles and counts of the clocked library ``lib``'s
    last launch, one dict a chain."""
    k = min(chains, CLOCK_CHAINS)
    width = len(CLOCK_PHASES) + len(CLOCK_COUNTS)
    out = np.zeros(k * width, np.uint64)
    torch.cuda.synchronize()
    lib.raise_on(lib.load().sim_chain_clocks(out.ctypes.data, k), "sim_chain_clocks")
    return [dict(cycles=dict(zip(CLOCK_PHASES, map(int, r[:len(CLOCK_PHASES)]))),
                 counts=dict(zip(CLOCK_COUNTS, map(int, r[len(CLOCK_PHASES):]))))
            for r in out.reshape(k, width)]


def clock_split(conf_i, conf_f, mu_sched, mu_hat0, cols: dict, *, n: int, mt: int,
                ring_cap: int, arrival_window: int, trace_queues: bool, trace_mu: bool,
                lib=None):
    """``sim_chain`` on CUDA inputs through the clocked build
    (``build.CLOCKED``, or ``lib``), not counted as a launch: (final, trace,
    records), the records ``read_clocks``'s."""
    lib = build.CLOCKED if lib is None else lib
    C, T = cols["dt"].shape
    ins = (conf_i, conf_f, mu_sched, mu_hat0, *(cols[k] for k in COLS))
    final, trace = _launch(lib, ins, _device(ins), C, T, n, mt, cols["j"].shape[2],
                           mu_sched.shape[1], ring_cap, arrival_window, trace_queues, trace_mu)
    return final, trace, read_clocks(lib, C)


def reset_launches() -> None:
    launches["sim_chain"] = 0


def launch_counts() -> dict[str, int]:
    return dict(launches)
