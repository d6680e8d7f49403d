"""Wrapper of the hand-written chain kernel (``csrc/sim_chain.cu``).

``sim_chain`` runs a batch of chains that share their shapes (workers n,
slots mt, ring, arrival window, what is traced), each with its own policy,
flags, rounds, speeds and draw columns, for all their rounds; with ``ext``
(the environment and fleet inputs, ``ref.EXT``) in the environment, fault
and fleet modes, each chain with its own tracks and frontends; with ``obs``
(the telemetry inputs, ``ref.OBS``) each chain that has them folds the
window telemetry once a round into a packed row of the trace column
``obs``. It checks
device, dtype, shape and contiguity. Given CPU tensors it runs the plain
chain from ``ref.py``; given CUDA tensors it launches the kernel (one
block a chain; the paper mode's instances, or with ``ext`` the environment
and fleet modes', each with ``obs`` in its telemetry form) on the current
stream or raises. There is no fallback from a failed build or
launch to the plain chain.

The wrapper sizes the block's shared memory: the ring stride
(``ring_stride``) and the rounds a tile stages (``tile_rounds``), within
``smem_bytes``'s formula, the kernel's own.

``launches["sim_chain"]`` counts launches: a plain int raised by one
where the kernel is launched and nowhere else. ``clock_split`` makes the
same launch through the clocked build (``build.CLOCKED``), uncounted, and
returns each chain's cycles by phase (``read_clocks``). ``launch_only`` is
the launch without the wrapper's checks, uncounted: what a timing by CUDA
events queues.
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


#: more arrays of n in the environment and fleet modes (kExtArrays)
EXT_ARRAYS = 6


#: the telemetry's shared words (kObsWords in the source): the detector's
#: four vectors of NSIG; the histogram's thresholds and counts are registers,
#: up to OBS_MAX_BINS bins (kMaxBins)
OBS_WORDS = 20
OBS_MAX_BINS = 128


def record_words(mt: int, ext: bool = False) -> int:
    """A round's trace record in words (rec_words in the source): code,
    worker, n_tasks, now, lam_hat, (``ext``: frontend, view_gap, sync_age,
    killed_fake,) and the workers and targets of 1 slot, or of MAX_MT when
    mt > 1, padded to 16 bytes."""
    return ((9 if ext else 5) + 2 * (1 if mt == 1 else MAX_MT) + 3) // 4 * 4


def _col_words(tile: int, width: int) -> int:
    """A staged column's tile region in words (col_words in the source)."""
    return (tile * width + 3) // 4 * 4 + 4


def smem_bytes(n: int, mt: int, ring_cap: int, arrival_window: int, *, tile: int = 1,
               stride: int | None = None, J: int | None = None, trace_queues: bool = True,
               trace_mu: bool = True, frontends: int = 0, obs_bins: int = 0) -> int:
    """The block's dynamic shared memory (smem_bytes in the source): a
    tile region for each staged column (draws: six of width 1, mt, 4·mt
    and J = 2·mt unless given; the trace: a record a round of
    ``record_words(mt)``, and n for the queue and μ̂ rows when traced), the
    learner rings (8 B a slot, ``stride`` >= n words a slot, n unless
    given), the table's stack (8·(n + 4) B), STATE_ARRAYS arrays of n words
    and the arrival window. ``frontends`` > 0 (the environment and fleet
    modes, with that many frontends at most) adds five draw columns (three
    of width 1, mt and J), the longer record, EXT_ARRAYS arrays of n, a row
    of n and three words a frontend; ``obs_bins`` > 0 (telemetry) adds
    OBS_WORDS."""
    J = 2 * mt if J is None else J
    stride = n if stride is None else stride
    ext = frontends > 0
    widths = [1] * 6 + [mt, 4 * mt, J] + [record_words(mt, ext), n if trace_queues else 0,
                                          n if trace_mu else 0]
    if ext:
        widths += [1, 1, 1, mt, J]
    return 4 * (sum(_col_words(tile, w) for w in widths) + 2 * stride * ring_cap
                + 2 * (n + 4) + STATE_ARRAYS * n + arrival_window
                + (EXT_ARRAYS * n + frontends * n + 3 * frontends if ext else 0)
                + (OBS_WORDS if obs_bins else 0))


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
    fit beside the rings (``kw``: ``smem_bytes``'s J, trace flags and
    frontends)."""
    smem = smem_bytes(n, mt, ring_cap, arrival_window, **kw)
    F, HB = kw.get("frontends", 0), kw.get("obs_bins", 0)
    ext = (f" + the environment and fleet state ({4 * EXT_ARRAYS + 4 * F}·n + {12 * F} "
           f"at {F} frontends)" if F else "")
    ext += f" + the telemetry ({4 * OBS_WORDS})" if HB else ""
    if HB > OBS_MAX_BINS:
        raise ValueError(f"sim_chain: a histogram of {HB} bins, the kernel takes at most "
                         f"{OBS_MAX_BINS}")
    if not (n >= 1 and 1 <= mt <= MAX_MT and ring_cap >= 1 and arrival_window >= 1
            and smem <= SMEM_LIMIT):
        raise ValueError(
            f"sim_chain: n={n}, max_tasks={mt}, ring_cap={ring_cap}, "
            f"arrival_window={arrival_window} outside max_tasks <= {MAX_MT} and shared "
            f"memory 8·n·ring_cap + {4 * STATE_ARRAYS + 8}·n + 32 + 4·arrival_window{ext} + "
            f"a tile of one round = {smem} <= {SMEM_LIMIT} B")


#: the draw columns and their dtypes (``core.simulator.draw_rounds``)
COLS = {"dt": torch.float32, "ev": torch.int32, "u_svc": torch.float32,
        "u_fake": torch.float32, "j_fake": torch.int32, "n_tasks": torch.int32,
        "pins": torch.int32, "u": torch.float32, "j": torch.int32}
#: the environment and fleet modes' draw columns
XCOLS = {"u_thin": torch.float32, "fe": torch.int32, "u_pin": torch.float32,
         "u_jfake": torch.float32, "uj": torch.float32}


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


def sim_chain(conf_i, conf_f, mu_sched, mu_hat0, cols: dict, ext: dict | None = None,
              obs: dict | None = None, *, n: int, mt: int, ring_cap: int,
              arrival_window: int, trace_queues: bool, trace_mu: bool):
    """conf_i i32[C, NI], conf_f f32[C, NF], mu_sched f32[C, K, n], mu_hat0
    f32[C, n], and the draw columns ``cols`` (``core.simulator.draw_rounds``)
    stacked to [C, T, ...] -> (final, trace): dicts of tensors with the
    chain axis leading (``ref.final_shapes``, ``ref.trace_shapes``). A
    chain's rounds (conf_i[:, ROUNDS]) are at most T; its trace rows after
    them are zeros. ``ext`` (``ref.EXT``, from ``core.simulator.
    chain_inputs``) runs the environment and fleet modes, with the draw
    columns ``XCOLS`` in ``cols``; the final state then has the fleet's and
    the crash track's fields, ``q_delta`` and the EMA rows at the batch's
    most frontends, and ``killed`` is [C, T, n] where a chain has a crash
    track. ``obs`` (``ref.OBS``, from ``core.simulator.chain_inputs``) adds
    the trace column ``obs`` [C, T, row_words(HB)], HB = obs_thr's width:
    each round's packed window row of the chains whose conf_o OBS_ON is
    set, zeros elsewhere."""
    C, T = cols["dt"].shape
    K = mu_sched.shape[1]
    J = cols["j"].shape[2] if cols["j"].dim() == 3 else -1
    F = 0
    if ext is not None:
        if set(ext) != set(ref.EXT):
            raise ValueError(f"ext: expected {sorted(ref.EXT)}, got {sorted(ext)}")
        for name, (dt, w) in ref.EXT.items():
            v = ext[name]
            want = {"conf_x": (C, ref.NX), "conf_xf": (C, ref.NXF)}.get(
                name, (C, v.shape[1] if v.dim() > 1 else -1) + ((n,) if w == "n" else ()))
            _check(v, name, dt, want)
        F = int(ext["conf_x"][:, ref.FRONTENDS].max())
        if int(ext["conf_x"][:, ref.FRONTENDS].min()) < 1:
            raise ValueError("conf_x: every chain needs at least one frontend")
    HB = 0
    if obs is not None:
        if set(obs) != set(ref.OBS):
            raise ValueError(f"obs: expected {sorted(ref.OBS)}, got {sorted(obs)}")
        HB = obs["obs_thr"].shape[1] if obs["obs_thr"].dim() == 2 else -1
        for name, want in (("conf_o", (C, ref.NO)), ("conf_of", (C, ref.NOF)),
                           ("obs_thr", (C, HB))):
            _check(obs[name], name, ref.OBS[name], want)
        co = obs["conf_o"].cpu()
        on = co[:, ref.OBS_ON] != 0
        if HB < 2 or bool((on & ((co[:, ref.BINS] < 2) | (co[:, ref.BINS] > HB)
                                 | (co[:, ref.WINDOW] < 1))).any()):
            raise ValueError(f"conf_o: a chain's histogram needs 2 to {HB} bins (obs_thr's "
                             "width) and its window at least one round")
    check_shape(n, mt, ring_cap, arrival_window, J=max(J, 2 * mt),
                trace_queues=trace_queues, trace_mu=trace_mu, frontends=F, obs_bins=HB)
    _check(conf_i, "conf_i", torch.int32, (C, ref.NI))
    _check(conf_f, "conf_f", torch.float32, (C, ref.NF))
    _check(mu_sched, "mu_sched", torch.float32, (C, K, n))
    _check(mu_hat0, "mu_hat0", torch.float32, (C, n))
    per_round = {"dt": (), "ev": (), "u_svc": (), "u_fake": (), "j_fake": (), "n_tasks": (),
                 "pins": (mt,), "u": (4, mt), "j": (J,), "u_thin": (), "fe": (),
                 "u_pin": (mt,), "u_jfake": (), "uj": (J,)}
    names = COLS | (XCOLS if ext is not None else {})
    if set(cols) != set(names):
        raise ValueError(f"cols: expected {sorted(names)}, got {sorted(cols)}")
    for name, dt in names.items():
        _check(cols[name], name, dt, (C, T) + per_round[name])
    if J < 2 * mt:
        raise ValueError(f"j: {J} integer draws a round, need at least 2·max_tasks")
    if C < 1 or K < 1:
        raise ValueError("need at least one chain and one phase")
    ins = (conf_i, conf_f, mu_sched, mu_hat0, *(cols[k] for k in names))
    xins = () if ext is None else tuple(ext[k] for k in ref.EXT)
    oins = () if obs is None else tuple(obs[k] for k in ref.OBS)
    dev = _device(ins + xins + oins)
    ci = conf_i.cpu()  # a few ints a chain: the kernel indexes by them
    rounds, phases, policy = ci[:, ref.ROUNDS], ci[:, ref.PHASES], ci[:, ref.POLICY]
    if bool((rounds < 0).any() or (rounds > T).any() or (phases < 1).any()
            or (phases > K).any() or (policy < 0).any()
            or (policy >= len(pol.ALL_POLICIES)).any()):
        raise ValueError("conf_i: rounds must lie in [0, T], phases in [1, K] and the "
                         "policy be an index of ALL_POLICIES")
    if ext is not None:
        cx = ext["conf_x"].cpu()
        for k, name in ((ref.KA, "lam_bp"), (ref.KC, "mu_bp"), (ref.KM, "act_bp"),
                        (ref.KS, "stall_bp"), (ref.KCRASH, "crash_t")):
            if bool((cx[:, k] < 0).any() or (cx[:, k] > ext[name].shape[1]).any()):
                raise ValueError(f"conf_x: a track's count exceeds {name}'s rows")
        if bool(((cx[:, ref.ENV] != 0) & ((cx[:, ref.KA] < 1) | (cx[:, ref.KC] < 1)
                                          | (cx[:, ref.KM] < 1))).any()):
            raise ValueError("conf_x: an environment needs a segment on every track")
    if dev.type == "cpu":
        return ref.sim_chain_ref(conf_i, conf_f, mu_sched, mu_hat0, cols, ext, obs, n=n,
                                 mt=mt, ring_cap=ring_cap, arrival_window=arrival_window,
                                 trace_queues=trace_queues, trace_mu=trace_mu)
    out = _launch(build.LIBRARY, ins, dev, C, T, n, mt, J, K, ring_cap, arrival_window,
                  trace_queues, trace_mu, ext, obs)
    if not torch.cuda.is_current_stream_capturing():
        launches["sim_chain"] += 1
    return out


_TRACE_ORDER = ("code", "worker", "n_tasks", "task_workers", "task_targets", "frontend",
                "view_gap", "sync_age", "now", "lam_hat", "killed_fake", "q_real", "mu_hat")
_FINAL_EXT = ("crash_i", "q_snap", "q_delta", "mu_view", "ema_last", "ema_gap", "ema_count",
              "t_sync", "lam_global", "alias_p", "alias_a")


def _launch(lib, ins, dev, C, T, n, mt, J, K, ring_cap, arrival_window, trace_queues,
            trace_mu, ext=None, obs=None):
    """One launch of ``lib``'s kernel on checked CUDA inputs: (final, trace)."""
    F = killed = HB = None
    if ext is not None:
        cx = ext["conf_x"].cpu()
        F = int(cx[:, ref.FRONTENDS].max())
        killed = bool((cx[:, ref.ENV] * cx[:, ref.KCRASH]).any())
    if obs is not None:
        HB = obs["obs_thr"].shape[1]
    final = {name: torch.zeros((C,) + shape, dtype=dt, device=dev) for name, (dt, shape)
             in ref.final_shapes(n, ring_cap, arrival_window, F).items()}
    trace = {name: torch.zeros((C,) + shape, dtype=dt, device=dev) for name, (dt, shape)
             in ref.trace_shapes(T, n, mt, trace_queues, trace_mu, bool(killed), HB).items()}
    ptr = lambda t: t.data_ptr()  # noqa: E731
    kw = dict(J=J, trace_queues=trace_queues, trace_mu=trace_mu, frontends=F or 0,
              obs_bins=HB or 0)
    stride = ring_stride(n, mt, ring_cap, arrival_window, **kw)
    tile = tile_rounds(T, n, mt, ring_cap, arrival_window, stride=stride, **kw)
    base = [f for f in final if f not in _FINAL_EXT]
    if ext is None:  # the paper's mode: null for the modes' columns, inputs and outputs
        xptrs = (None,) * (len(XCOLS) + len(ref.EXT))
        lens, xfinal = [0] * 6, [None] * len(_FINAL_EXT)
    else:
        xptrs = tuple(ptr(ext[k]) for k in ref.EXT)
        lens = [ext[k].shape[1] for k in ("lam_bp", "mu_bp", "act_bp", "stall_bp",
                                           "crash_t")] + [F]
        xfinal = [ptr(final[k]) for k in _FINAL_EXT]
    optrs = (None,) * len(ref.OBS) if obs is None else tuple(ptr(obs[k]) for k in ref.OBS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.load().sim_chain(
            *map(ptr, ins), *xptrs, *optrs, C, T, n, mt, J, K, arrival_window, ring_cap,
            stride, tile, int(trace_queues), int(trace_mu), *lens, HB or 0,
            *(ptr(trace[k]) for k in _TRACE_ORDER),
            ptr(trace["killed"]) if killed else None,
            ptr(trace["obs"]) if obs is not None else None, *(ptr(final[k]) for k in base),
            *xfinal, stream)
    lib.raise_on(err, "sim_chain")
    return final, trace


#: the clocked build's record of a chain (csrc/sim_chain.cu: CK_* cycles,
#: then CN_* counts), kept for the first CLOCK_CHAINS chains of a launch
CLOCK_PHASES = ("setup", "head", "arrival", "service", "fake", "rebuild", "refresh", "trace",
                "tile", "barrier", "obs")
CLOCK_COUNTS = ("rounds", "arrivals", "services", "fakes", "refreshes", "rebuilds", "tiles",
                "windows")
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


def launch_only(conf_i, conf_f, mu_sched, mu_hat0, cols: dict, ext: dict | None = None,
                obs: dict | None = None, *, n: int, mt: int, ring_cap: int,
                arrival_window: int, trace_queues: bool, trace_mu: bool, lib=None):
    """``sim_chain``'s launch (any of its modes) on CUDA inputs that
    ``sim_chain`` has accepted, through ``lib`` (``build.LIBRARY`` unless
    given), not counted and without its checks, whose reads of the configs
    wait for the stream: (final, trace). Timing by CUDA events, a queue of
    these holds nothing of the host between a launch's two events."""
    lib = build.LIBRARY if lib is None else lib
    C, T = cols["dt"].shape
    ins = (conf_i, conf_f, mu_sched, mu_hat0,
           *(cols[k] for k in COLS | (XCOLS if ext is not None else {})))
    return _launch(lib, ins, _device(ins), C, T, n, mt, cols["j"].shape[2], mu_sched.shape[1],
                   ring_cap, arrival_window, trace_queues, trace_mu, ext, obs)


def clock_split(conf_i, conf_f, mu_sched, mu_hat0, cols: dict, ext: dict | None = None,
                obs: dict | None = None, *, n: int, mt: int, ring_cap: int,
                arrival_window: int, trace_queues: bool, trace_mu: bool, lib=None):
    """``sim_chain`` on CUDA inputs through the clocked build
    (``build.CLOCKED``, or ``lib``), not counted as a launch: (final, trace,
    records), the records ``read_clocks``'s."""
    lib = build.CLOCKED if lib is None else lib
    final, trace = launch_only(conf_i, conf_f, mu_sched, mu_hat0, cols, ext, obs, n=n, mt=mt,
                               ring_cap=ring_cap, arrival_window=arrival_window,
                               trace_queues=trace_queues, trace_mu=trace_mu, lib=lib)
    return final, trace, read_clocks(lib, conf_i.shape[0])


def reset_launches() -> None:
    launches["sim_chain"] = 0


def launch_counts() -> dict[str, int]:
    return dict(launches)
