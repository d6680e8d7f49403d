"""The one-program serving loop: the closed-loop serving simulation with
every turn on the device.

``run_simulation`` (``serving/router.py``) moves each arrival batch as
arrays, but its loop is Python: every turn pays some 215 kernel launches,
a host-side pass over the pending completions and a device-to-host copy.
This module keeps everything that loop keeps in Python state in device
tensors of fixed size, the carry:

  * the router state (queue view, learner rings, λ̂ EMA, key, fake-job
    clock), in the device forms of ``core.scheduler.serve_step_device``;
  * the in-flight completions: ``pend_cap`` slots of done and start time
    (f64), replica, insertion sequence and validity. Each turn flushes the
    ``comp_cap`` oldest due completions in (done time, insertion) order,
    the host loop's stable sort;
  * the replica pool (``free_at`` per replica, f64). The turn's submission
    chain is one launch of the pool-chain kernel (``pool_turn``), which
    assembles the turn's submissions and runs ``SimulatedPool.submit``'s
    recurrence ``start = max(arrival, free_at); done = start + cost/μ``
    step for step (the host side pairs with ``SequentialPool`` for exact
    parity); ``chain_max`` keeps the most submissions one replica took in
    a turn (``info["longest_chain"]``).

A turn reads its row of the workload (arrival times, costs, speeds, and
with churn the membership columns) from a chunk of rows on the device and
writes its row of results (responses f64[k], the μ̂ sample f32[n]). On
CUDA the turn is captured once as a ``torch.cuda.CUDAGraph`` and replayed
once per turn; on the CPU the same step runs eagerly. A chunk is one
host-to-device copy of its rows, one replay per turn and one copy back;
the carry stays on the device across chunks, so a chunked run is the
composition of its turns, bit-equal to an unchunked one.

The turn places with the router's policy, any of ``core.policies``; the
configuration (and so the captured graph) is one per policy, as the
reference compiles one program per policy.

The numpy side of the workload is drawn up front with the same
``RandomState`` call sequence as ``run_simulation``; the key stream and
the f32 math are the host loop's (``serve_step_device`` shares them with
``serve_step``), so routing is bit-identical to a ``RosellaRouter`` in its
deterministic ``async_mu=False`` mode. Event times are f64 and cross to
f32 where the host loop crosses into ``serve_turn``.

Parity (tests/test_torch_scanloop.py):
  * against the port's host loop with ``SequentialPool`` and
    ``async_mu=False``: equal float for float on both probe streams
    (responses, μ̂ trace, ``free_at``, queue view, learner, key);
  * against the reference ``run_simulation_scan``: responses equal, μ̂
    within the learner's stated ulps, as the host loop against the
    reference's;
  * with ``SimulatedPool`` (closed-form chains, ~1e-12 apart) or once the
    capacities overflow: statistical.

Capacity overflows (more due completions in a turn than ``comp_cap``, more
in-flight work than ``pend_cap``) are counted on the device and read once
at the end; they void exactness (the host loop pre-folds overflow
instead), and ``strict_overflow`` turns them into an error.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.core import dispatch as dsp
from repro_torch.core import estimator as est
from repro_torch.core import learner as lrn
from repro_torch.core import scheduler as rs
from repro_torch.kernels.pool_chain import kernel as pool_kernel
from repro_torch.serving import router as rt
from repro_torch.utils import prng

#: In-flight completion capacity of the carry (see the reference's
#: ``PEND_CAP``): 1024 clears the Fig-8/Fig-11 workloads with ~2x headroom;
#: the flush sorts it every turn.
PEND_CAP = 1024
#: Target xs footprint of one chunk when ``chunk_turns`` is auto-sized.
CHUNK_MAX_BYTES = 64 << 20
#: Turns run on a side stream before the capture (each on a zero carry).
WARMUP_TURNS = 2
_INT32_MAX = 2**31 - 1
_LEARNER = tuple(f.name for f in dataclasses.fields(lrn.LearnerState))


def _precompute_workload(arrival_rate, horizon, request_cost, speed_schedule,
                         seed, arrival_batch, speeds0):
    """Replay ``run_simulation``'s numpy RandomState call sequence up
    front: per turn, arrival gaps then request costs — identical draws,
    identical workload."""
    rng = np.random.RandomState(seed)
    t = 0.0
    sched_i = 0
    speeds = np.asarray(speeds0, float).copy()
    times_l, costs_l, speeds_l = [], [], []
    while t < horizon:
        gaps = rng.exponential(1.0 / arrival_rate, size=arrival_batch)
        times = t + np.cumsum(gaps)
        t = float(times[-1])
        if speed_schedule is not None:
            while sched_i < len(speed_schedule) and speed_schedule[sched_i][0] <= t:
                speeds = np.asarray(speed_schedule[sched_i][1], float).copy()
                sched_i += 1
        times_l.append(times)
        costs_l.append(request_cost * rng.exponential(1.0, size=arrival_batch))
        speeds_l.append(speeds.copy())
    if not times_l:
        return None
    return (np.stack(times_l), np.stack(costs_l), np.stack(speeds_l))


def auto_chunk_turns(T, k, n, *, churn=False, burst_cap=0, faulty=False,
                     pend_cap=PEND_CAP, max_bytes=None) -> int:
    """Chunk length (turns) for the chunked driver: the most turns whose xs
    rows (``8·(2k + n)`` bytes a turn, plus ``2n + 4·burst_cap`` with
    membership columns and ``24n`` with fault columns) fit ``max_bytes``
    (default ``CHUNK_MAX_BYTES``), floored at ``max(64, pend_cap // k)``
    turns and clamped to ``[1, T]``."""
    per_turn = 8 * (2 * k + n)
    if churn:
        per_turn += 2 * n + 4 * burst_cap
    if faulty:
        per_turn += 3 * 8 * n
    if max_bytes is None:
        max_bytes = CHUNK_MAX_BYTES
    cap = int(max_bytes) // max(per_turn, 1)
    floor = max(64, pend_cap // max(k, 1))
    return max(1, min(int(T), max(cap, floor))) if T > 0 else 1


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """What one captured turn is specialised to."""

    n: int
    k: int
    comp_cap: int
    pend_cap: int
    policy: str
    max_fake: int
    use_alias: bool
    fake_cost: float
    churn: bool
    burst_cap: int
    burst_cost: float
    lcfg: lrn.LearnerConfig


def _turn(cfg: ScanConfig, c: dict, x: dict):
    """One serving turn on the carry ``c`` and the workload row ``x``, as
    the reference's scan body. Returns (new carry, resp f64[k], μ̂ sample
    f32[n]). The pool chain writes the carry's ``free_at`` and
    ``chain_max`` in place; the new carry holds everything else, and
    nothing else of the inputs is written."""
    times64, costs64, speeds64 = x["times"], x["costs"], x["speeds"]
    dev = times64.device
    P, C, k, mf = cfg.pend_cap, cfg.comp_cap, cfg.k, cfg.max_fake
    t64 = times64[-1]
    t32 = t64.float()
    p_done, p_start, p_rep, p_seq, p_valid = (
        c["p_done"], c["p_start"], c["p_rep"], c["p_seq"], c["p_valid"])

    # -- flush the due completions, oldest done first, ties in insertion
    #    order (lexsort by (done, seq) as two stable sorts)
    due = p_valid & (p_done <= t64)
    n_due = due.sum(dtype=torch.int32)
    keydone = torch.where(due, p_done, float("inf"))
    by_seq = torch.sort(p_seq, stable=True).indices
    order = by_seq[torch.sort(keydone[by_seq], stable=True).indices]
    sel = order[:C]
    rank_ok = torch.arange(C, device=dev) < n_due
    comp_w = torch.where(rank_ok, p_rep[sel], -1)
    comp_t = torch.where(rank_ok, (p_done[sel] - p_start[sel]).float(), 0.0)
    comp_now64 = torch.where(rank_ok, p_done[sel], float("-inf")).max()
    comp_now32 = torch.where(n_due > 0, comp_now64, t64).float()
    p_valid = p_valid & ~torch.zeros_like(p_valid).scatter(0, sel, rank_ok)
    over_flush = c["over_flush"] + (n_due - C).clamp(min=0)

    learner = lrn.LearnerState(**{f: c[f] for f in _LEARNER})
    if cfg.churn:
        active_t, burst_t = x["active"], x["burst"]
        # rejoining workers cold-start before this turn's fold; with no
        # rejoin the reset is the identity, so it needs no select
        learner = lrn.reset_workers(learner, x["rejoin"], t32, active_t)
    else:
        active_t, burst_t = None, torch.empty(0, dtype=torch.int32, device=dev)
    mu_tr = learner.mu_hat  # the μ̂ entering this turn, as run_simulation samples it

    arr = est.EmaArrivalState(c["arr_last"], c["arr_gap"], c["arr_count"])
    fake_js, workers, q_view, learner, arr, key = rs.serve_step_device(
        c["q_view"], learner, arr, cfg.lcfg, c["key"], comp_w, comp_t,
        (t32, c["last_fake"], comp_now32), k, cfg.policy, mf, cfg.use_alias, active_t)

    # -- the replica pool: fakes, probe bursts, then the arrival batch, in
    #    the host's submit order, assembled and chained in one launch that
    #    updates the carry's clocks in place; inactive fakes and burst pads
    #    reach no replica's clock
    sub_start, sub_done, sub_w, act, _, resp = pool_kernel.pool_turn(
        c["free_at"], speeds64, fake_js, burst_t, workers, times64, costs64,
        cfg.fake_cost, cfg.burst_cost, free_out=c["free_at"], chain_max=c["chain_max"])

    # -- append the new in-flight work: compact the survivors to the front
    #    in insertion order, then write the active submissions behind them;
    #    a write past pend_cap lands in a scratch slot that is cut off
    pkey = torch.where(p_valid, p_seq, _INT32_MAX)
    perm = torch.sort(pkey, stable=True).indices
    p_done, p_start, p_rep, p_seq, p_valid = (
        a[perm] for a in (p_done, p_start, p_rep, p_seq, p_valid))
    nv = p_valid.sum(dtype=torch.int32)
    pos = torch.cumsum(act, 0, dtype=torch.int32) - 1
    slot = torch.where(act, nv + pos, P)
    put = slot.clamp(max=P).long()

    def append(a, v):
        ext = torch.cat([a, a.new_zeros(1)])
        ext.index_put_((put,), v.to(a.dtype))
        return ext[:P]

    new = dict(
        q_view=q_view, arr_last=arr.last_time, arr_gap=arr.mean_gap,
        arr_count=arr.count, key=key, last_fake=t32,
        p_done=append(p_done, sub_done), p_start=append(p_start, sub_start),
        p_rep=append(p_rep, sub_w), p_seq=append(p_seq, c["seq_ctr"] + pos),
        p_valid=append(p_valid, torch.ones_like(act)),
        seq_ctr=c["seq_ctr"] + act.sum(dtype=torch.int32),
        over_flush=over_flush,
        over_pend=c["over_pend"] + (act & (slot >= P)).sum(dtype=torch.int32),
        **{f: getattr(learner, f) for f in _LEARNER})
    return new, resp, mu_tr


class _Rows:
    """Per-turn rows of several columns in one device buffer: row r of every
    column lies in bytes [r * width, (r + 1) * width), so T rows are one
    contiguous copy. ``cols`` maps a name to (dtype, shape of a row); the
    widest dtypes come first, so every column stays aligned."""

    def __init__(self, cols: dict, rows: int, device):
        order = sorted(cols, key=lambda c: -np.dtype(cols[c][0]).itemsize)
        fields, off = {}, 0
        for name in order:
            dt, shape = np.dtype(cols[name][0]), tuple(cols[name][1])
            fields[name] = (dt, shape, off)
            off += dt.itemsize * int(np.prod(shape, dtype=np.int64))
        self.width = -(-off // 8) * 8
        self.np_dtype = np.dtype({
            "names": list(fields), "formats": [(dt, s) for dt, s, _ in fields.values()],
            "offsets": [o for _, _, o in fields.values()], "itemsize": self.width})
        self.buf = torch.zeros((rows, self.width), dtype=torch.uint8, device=device)
        self.col = {}
        for name, (dt, shape, o) in fields.items():
            nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
            tdt = torch.from_numpy(np.zeros(0, dt)).dtype
            self.col[name] = self.buf[:, o:o + nbytes].view(tdt).view(rows, *shape)

    def put(self, columns: dict) -> None:
        """Copy the first T rows in from numpy columns [T, ...]: one copy."""
        T = len(next(iter(columns.values())))
        rec = np.zeros(T, self.np_dtype)
        for name, a in columns.items():
            rec[name] = a
        self.buf[:T].copy_(torch.from_numpy(rec.view(np.uint8).reshape(T, self.width)))

    def get(self, T: int) -> np.ndarray:
        """The first T rows as a numpy record array: one copy."""
        return self.buf[:T].cpu().numpy().reshape(-1).view(self.np_dtype)


class _KernelNodeParams(ctypes.Structure):
    """The driver's CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p), ("dims", ctypes.c_uint * 6),
                ("shared_bytes", ctypes.c_uint), ("params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL


def _graph_nodes(graph) -> tuple[int, dict[str, int]]:
    """A captured graph that torch kept (``keep_graph=True``), read through
    the driver: its node count, and its kernel nodes counted by the
    kernel's (mangled) name. A driver error raises."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed with CUresult {err}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    kernels: dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        params = _KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)),
                  "cuKernelGetName")
        key = name.value.decode()
        kernels[key] = kernels.get(key, 0) + 1
    return int(count.value), kernels


class TurnRunner:
    """The carry, a chunk's workload and result rows as static device
    tensors, and the turn step on them. On CUDA the step is captured once
    as a CUDA graph (``capture_s``: warm-up and capture, host clock;
    ``graph_nodes``: its node count; ``graph_kernels``: its kernel nodes
    by name, the launches of one replay) and every turn is a replay
    (``replays`` counts them); a capture error raises. On the CPU the step
    runs eagerly."""

    def __init__(self, cfg: ScanConfig, device, rows: int):
        self.cfg, self.device, self.rows = cfg, torch.device(device), rows
        n, P, cap = cfg.n, cfg.pend_cap, cfg.lcfg.ring_cap
        f32, f64, i32 = torch.float32, torch.float64, torch.int32

        def z(shape, dt, fill=0):
            return torch.full(shape, fill, dtype=dt, device=self.device)

        self.carry = dict(
            q_view=z((n,), i32), samples=z((n, cap), f32), stamps=z((n, cap), f32),
            widx=z((n,), i32), count=z((n,), i32), epoch_start=z((n,), f32),
            mu_hat=z((n,), f32, 1.0), arr_last=z((), f32), arr_gap=z((), f32),
            arr_count=z((), i32), key=z((2,), torch.int64), last_fake=z((), f32),
            free_at=z((n,), f64), chain_max=z((), i32), p_done=z((P,), f64, float("inf")),
            p_start=z((P,), f64), p_rep=z((P,), i32), p_seq=z((P,), i32),
            p_valid=z((P,), torch.bool), seq_ctr=z((), i32), over_flush=z((), i32),
            over_pend=z((), i32))
        cols = {"times": (np.float64, (cfg.k,)), "costs": (np.float64, (cfg.k,)),
                "speeds": (np.float64, (n,))}
        if cfg.churn:
            cols.update(active=(np.bool_, (n,)), rejoin=(np.bool_, (n,)),
                        burst=(np.int32, (cfg.burst_cap,)))
        self.xs = _Rows(cols, rows, self.device)
        self.xs.col["speeds"].fill_(1.0)
        if cfg.churn:
            self.xs.col["active"].fill_(True)
        self.ys = _Rows({"resp": (np.float64, (cfg.k,)), "mu": (np.float32, (n,))},
                        rows, self.device)
        self.turn = z((), torch.int64)
        self.graph = None
        self.capture_s = None
        self.graph_nodes = None
        self.graph_kernels: dict[str, int] = {}
        self.replays = 0
        if self.device.type == "cuda":
            self._capture()

    def step(self) -> None:
        """One turn: read row ``turn`` of the workload, write row ``turn`` of
        the results, update the carry in place, advance ``turn``."""
        idx = self.turn.view(1)
        x = {name: v.index_select(0, idx)[0] for name, v in self.xs.col.items()}
        new, resp, mu = _turn(self.cfg, self.carry, x)
        # the results first: the μ̂ sample may be a carry tensor itself
        self.ys.col["resp"].index_copy_(0, idx, resp[None])
        self.ys.col["mu"].index_copy_(0, idx, mu[None])
        for name, t in new.items():
            self.carry[name].copy_(t)
        self.turn.add_(1)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_TURNS):
                self.step()
                self.turn.zero_()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            self.step()
        graph.instantiate()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        self.graph_nodes, self.graph_kernels = _graph_nodes(graph)

    def load(self, router: rt.RosellaRouter, pool: rt.SimulatedPool) -> None:
        """Copy the router's and the pool's state into the carry."""
        c = self.carry
        c["q_view"].copy_(router.q_view)
        for f in _LEARNER:
            c[f].copy_(getattr(router.learner, f))
        c["arr_last"].fill_(float(router.arr.last_time))
        c["arr_gap"].fill_(float(router.arr.mean_gap))
        c["arr_count"].fill_(int(router.arr.count))
        c["key"].copy_(prng.device_key(router.key, "cpu"))
        c["last_fake"].fill_(float(np.float32(router.last_fake_time)))
        c["free_at"].copy_(torch.from_numpy(np.asarray(pool.free_at, np.float64)))
        c["p_done"].fill_(float("inf"))
        for f in ("chain_max", "p_start", "p_rep", "p_seq", "p_valid", "seq_ctr",
                  "over_flush", "over_pend"):
            c[f].zero_()

    def run_chunk(self, columns: dict):
        """Run the chunk's turns (numpy columns [T, ...], T <= rows) from the
        carry; returns (resp f64[T, k], μ̂ trace f32[T, n])."""
        T = len(columns["times"])
        if not 0 < T <= self.rows:
            raise ValueError(f"a chunk of {T} turns for {self.rows} rows")
        self.xs.put(columns)
        self.turn.zero_()
        for _ in range(T):
            if self.graph is None:
                self.step()
            else:
                self.graph.replay()
                self.replays += 1
        ys = self.ys.get(T)
        return ys["resp"].copy(), ys["mu"].copy()


@functools.lru_cache(maxsize=8)
def runner(cfg: ScanConfig, device: str, rows: int) -> TurnRunner:
    """One runner (one captured graph on CUDA) per configuration, device and
    chunk size, as the reference caches one compiled program."""
    return TurnRunner(cfg, device, rows)


def scan_config(router: rt.RosellaRouter, k: int, *, churn: bool = False,
                burst_cap: int = 0, fake_cost: float = 0.25,
                burst_cost: float | None = None, pend_cap: int = PEND_CAP,
                comp_cap: int | None = None) -> ScanConfig:
    """The configuration a run of ``router`` at batch ``k`` captures:
    ``comp_cap`` None is min(SERVE_COMP_CAP, pend_cap), the host loop's
    padding, and is never above ``pend_cap``."""
    comp_cap = (min(rt.SERVE_COMP_CAP, pend_cap) if comp_cap is None
                else min(int(comp_cap), pend_cap))
    return ScanConfig(
        n=router.n, k=k, comp_cap=comp_cap, pend_cap=pend_cap, policy=router.policy,
        max_fake=rt.MAX_FAKE, use_alias=router.use_alias, fake_cost=float(fake_cost),
        churn=churn, burst_cap=burst_cap,
        burst_cost=float(4.0 * fake_cost if burst_cost is None else burst_cost),
        lcfg=router.lcfg)


def run_simulation_scan(
    router: rt.RosellaRouter,
    pool: rt.SimulatedPool,
    *,
    arrival_rate: float,
    horizon: float,
    request_cost: float = 1.0,
    speed_schedule: "list[tuple[float, np.ndarray]] | None" = None,
    seed: int = 0,
    arrival_batch: int = 1,
    pend_cap: int | None = PEND_CAP,
    strict_overflow: bool = True,
    chunk_turns: int | None = None,
    observe=None,
    obs_sink=None,
):
    """Drop-in for ``run_simulation`` with every turn on the device.

    ``router`` supplies the initial state and configuration (learner
    config, key, ``use_alias``, device) and ``pool`` the replica speeds;
    both are advanced to their final states on return, like the host loop.
    Semantics are the router's deterministic ``async_mu=False`` mode.
    Returns ``(response_times, mu_trace, info)``; ``info`` carries the
    overflow counters (both 0: the fixed capacities were faithful to the
    host loop), the turn count, the most submissions one replica took in a
    turn (``longest_chain``) and, on CUDA, the capture's time (0.0 where
    the graph was captured by an earlier run), the graph's node count, its
    kernel nodes by name and the replays this run issued.
    """
    _not_ported(observe=observe, obs_sink=obs_sink)
    wl = _precompute_workload(arrival_rate, horizon, request_cost, speed_schedule,
                              seed, arrival_batch, pool.speeds)
    if wl is None:
        return np.empty(0), np.zeros((0, router.n)), {
            "turns": 0, "flush_overflow": 0, "pend_overflow": 0, "longest_chain": 0}
    times_np, costs_np, speeds_np = wl
    return run_workload_scan(
        router, pool, times_np, costs_np, speeds_np, fake_cost=request_cost * 0.25,
        pend_cap=pend_cap, strict_overflow=strict_overflow, chunk_turns=chunk_turns)


def _not_ported(**kw) -> None:
    """The reference's fault and telemetry options: not ported yet."""
    where = {"kill_np": "A4", "stall_np": "A4", "stall_dur_np": "A4", "recovery": "A4",
             "observe": "A5", "obs_sink": "A5"}
    for name, v in kw.items():
        if v is not None:
            raise NotImplementedError(
                f"{name}: the scan loop's {'failure semantics' if where[name] == 'A4' else 'telemetry'}"
                f" are not ported yet (ROADMAP queue A, {where[name]})")


def run_workload_scan(
    router: rt.RosellaRouter,
    pool: rt.SimulatedPool,
    times_np: np.ndarray,  # f64[T, k] per-turn arrival times
    costs_np: np.ndarray,  # f64[T, k] per-turn request costs
    speeds_np: np.ndarray,  # f64[T, n] replica speeds entering each turn
    *,
    active_np: np.ndarray | None = None,  # bool[T, n] membership per turn
    rejoin_np: np.ndarray | None = None,  # bool[T, n] offline→online edges
    burst_np: np.ndarray | None = None,  # i32[T, Bc] probe-burst targets (-1 pad)
    fake_cost: float = 0.25,
    burst_cost: float | None = None,  # default 4 × fake_cost, the full request cost
    kill_np=None,
    stall_np=None,
    stall_dur_np=None,
    recovery=None,
    pend_cap: int | None = None,  # None: the total-submission bound, clamped to
    # [PEND_CAP, 65536]; the cap does not change results absent overflow
    strict_overflow: bool = True,
    chunk_turns: int | None = None,  # None: ``auto_chunk_turns``
    chunk_max_bytes: int | None = None,
    comp_cap: int | None = None,  # None: min(SERVE_COMP_CAP, pend_cap)
    observe=None,
    obs_sink=None,
):
    """Run a pre-materialised workload with every turn on the device: the
    environment engine's entry point, as the reference's.

    With the membership columns the churn turn runs: the active mask
    restricts every draw, rejoin edges cold-start the learner in the
    carry, and each turn's probe bursts (``burst_np`` worker ids, -1
    padded) submit at ``burst_cost``. A router that already carries a
    membership mask runs it as a constant column. Returns
    ``(response_times, mu_trace, info)`` as ``run_simulation_scan``."""
    _not_ported(kill_np=kill_np, stall_np=stall_np, stall_dur_np=stall_dur_np,
                recovery=recovery, observe=observe, obs_sink=obs_sink)
    T, k = times_np.shape
    n = router.n
    if active_np is None and router.active is not None:
        active_np = np.broadcast_to(router.active.cpu().numpy(), (T, n)).copy()
    churn = active_np is not None
    burst_cap = int(burst_np.shape[1]) if churn and burst_np is not None else 0
    if burst_cost is None:
        burst_cost = 4.0 * fake_cost
    if pend_cap is None:
        need = max(PEND_CAP, T * (rt.MAX_FAKE + burst_cap + k))
        pend_cap = PEND_CAP
        while pend_cap < need and pend_cap < 65536:
            pend_cap <<= 1
    cols = dict(times=np.asarray(times_np, np.float64),
                costs=np.asarray(costs_np, np.float64),
                speeds=np.asarray(speeds_np, np.float64))
    if churn:
        cols.update(
            active=np.asarray(active_np, bool),
            rejoin=(np.zeros((T, n), bool) if rejoin_np is None
                    else np.asarray(rejoin_np, bool)),
            burst=(np.zeros((T, 0), np.int32) if burst_np is None
                   else np.asarray(burst_np, np.int32)))
    if chunk_turns is None:
        chunk_turns = auto_chunk_turns(T, k, n, churn=churn, burst_cap=burst_cap,
                                       pend_cap=pend_cap, max_bytes=chunk_max_bytes)
    step = max(int(chunk_turns), 1)
    chunks = ({name: a[s:s + step] for name, a in cols.items()}
              for s in range(0, T, step))
    return _drive_scan(router, pool, chunks, rows=min(step, T), k=k, churn=churn,
                       burst_cap=burst_cap, fake_cost=fake_cost,
                       burst_cost=float(burst_cost), pend_cap=pend_cap,
                       comp_cap=comp_cap, strict_overflow=strict_overflow)


def _drive_scan(router: rt.RosellaRouter, pool: rt.SimulatedPool, chunks, *,
                rows: int, k: int, churn: bool, burst_cap: int, fake_cost: float,
                burst_cost: float, pend_cap: int, comp_cap: int | None,
                strict_overflow: bool):
    """The chunk driver: load the carry from the router and the pool, run
    each chunk ({column: numpy [t, ...]}, t <= rows) from the carry left by
    the last, read the overflow counters once, and write the final state
    back to the router and the pool."""
    cfg = scan_config(router, k, churn=churn, burst_cap=burst_cap, fake_cost=fake_cost,
                      burst_cost=burst_cost, pend_cap=pend_cap, comp_cap=comp_cap)
    run = runner(cfg, str(router.device), rows)
    replays0 = run.replays
    run.load(router, pool)
    resp_l, mu_l = [], []
    active_last = None
    for chunk in chunks:
        resp, mu = run.run_chunk(chunk)
        resp_l.append(resp)
        mu_l.append(mu)
        if churn:
            active_last = chunk["active"][-1]
    c = run.carry
    info = {"turns": sum(len(m) for m in mu_l),
            "flush_overflow": int(c["over_flush"].item()),
            "pend_overflow": int(c["over_pend"].item()),
            "longest_chain": int(c["chain_max"].item()),
            "capture_s": run.capture_s if replays0 == 0 else 0.0,
            "graph_nodes": run.graph_nodes,
            "graph_kernels": dict(run.graph_kernels), "replays": run.replays - replays0}
    resp = np.concatenate(resp_l).reshape(-1) if resp_l else np.empty(0)
    mu_trace = np.concatenate(mu_l) if mu_l else np.zeros((0, router.n), np.float32)

    router.q_view = c["q_view"].clone()
    router.learner = lrn.LearnerState(**{f: c[f].clone() for f in _LEARNER})
    router.arr = est.to_host(est.EmaArrivalState(c["arr_last"], c["arr_gap"],
                                                 c["arr_count"]))
    router.key = prng.host_key(c["key"])
    router.last_fake_time = float(c["last_fake"].item())
    router.mu_front = router.learner.mu_hat
    router._mu_pending = None
    pool.free_at = c["free_at"].cpu().numpy().copy()
    if active_last is not None:
        router.active = torch.from_numpy(np.array(active_last, bool)).to(router.device)
    if router.use_alias:
        router.table_front = dsp.build_alias_table(router.mu_front, router.active)
    if strict_overflow and (info["flush_overflow"] or info["pend_overflow"]):
        raise RuntimeError(
            f"scan capacities overflowed (flush_overflow={info['flush_overflow']}, "
            f"pend_overflow={info['pend_overflow']}): results silently dropped work. "
            f"Raise pend_cap (current {pend_cap}; pend_cap=None auto-sizes to the "
            f"total-submission bound) or pass strict_overflow=False to inspect the "
            f"counters.")
    return resp, mu_trace, info
