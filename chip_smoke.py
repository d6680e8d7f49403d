#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of Rosella on one CUDA card.

    python3 chip_smoke.py

Builds the PPoT dispatch kernels from ``src/repro_torch`` (into ``build/``),
holds each against its plain PyTorch version on the card, drives the
port's serving turn (``RosellaRouter`` + ``run_simulation``) at a
thousand-replica cell in three modes, and times each kernel. Every phase
is a hard failure: the script exits non-zero and prints no result line.
The last line of standard output is the device record
``{"ok": true, "device": {...}}``; the line before it lists the kernels.

It imports torch, numpy and the port, nothing of JAX or the JAX package,
and refuses to run without a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/ppot_dispatch/csrc/ppot_dispatch.cu"
REPLACES = {
    "ppot_dispatch_fused_alias": "src/repro/kernels/ppot_dispatch/kernel.py:211",
    "ppot_dispatch_fused": "src/repro/kernels/ppot_dispatch/kernel.py:242",
    "ppot_dispatch": "src/repro/kernels/ppot_dispatch/kernel.py:126",
    "alias_pairing": "src/repro/core/dispatch.py:184",
}

# the main-path cell: a thousand-replica cluster with the paper's §6.1
# k²/100 speeds, Poisson arrivals at 70% of capacity, batches of 128
N_REPLICAS, BATCH, LOAD, SEED = 1024, 128, 0.7, 0
TURNS = {"a": 2050, "b": 520, "c": 520}  # horizon, in expected turns
MIN_TURNS = {"a": 2000, "b": 500, "c": 500}
CHECK_EVERY = 10


class SmokeFailure(Exception):
    pass


def need(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def spearman(x, y) -> float:
    """Rank correlation with average ranks for ties."""
    def ranks(a):
        a = np.asarray(a, np.float64)
        order = np.argsort(a, kind="stable")
        r = np.empty(len(a))
        r[order] = np.arange(len(a))
        _, inv, cnt = np.unique(a, return_inverse=True, return_counts=True)
        sums = np.bincount(inv, weights=r)
        return (sums / cnt)[inv]
    rx, ry = ranks(x), ranks(y)
    rx, ry = rx - rx.mean(), ry - ry.mean()
    return float((rx * ry).sum() / np.sqrt((rx * rx).sum() * (ry * ry).sum()))


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


class KernelChecks:
    """Runs every kernel-vs-plain comparison and keeps the worst error."""

    def __init__(self, torch, K, R):
        self.torch, self.K, self.R = torch, K, R
        self.max_err = {name: 0.0 for name in REPLACES}
        self.checks = {name: 0 for name in REPLACES}

    def compare(self, name, got, want):
        torch = self.torch
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if got[0].is_cuda:
            torch.cuda.synchronize()
        for g, w in zip(got, want):
            need(g.shape == w.shape and g.dtype == w.dtype,
                 f"{name}: {g.dtype}{list(g.shape)} vs plain {w.dtype}{list(w.shape)}")
            err = (g.double() - w.to(g.device).double()).abs().max().item() if g.numel() else 0.0
            self.max_err[name] = max(self.max_err[name], err)
            need(torch.equal(g, w.to(g.device)), f"{name}: differs from its plain "
                 f"version (max abs err {err})")
        self.checks[name] += 1

    def plain(self, name):
        R = self.R
        return {"ppot_dispatch_fused_alias": R.ppot_dispatch_fused_alias_ref,
                "ppot_dispatch_fused": R.ppot_dispatch_fused_ref,
                "ppot_dispatch": R.ppot_dispatch_ref,
                "alias_pairing": R.alias_pairing_ref}[name]

    def wrap(self, name, every: int):
        """A stand-in for kernel.<name> that runs the kernel and, on every
        ``every``-th call, its plain version on the same device tensors."""
        fn, plain, calls = getattr(self.K, name), self.plain(name), [0]

        def checked(*args):
            out = fn(*args)
            calls[0] += 1
            if calls[0] % every == 1:
                self.compare(name, out, plain(*args))
            return out
        return checked


def pairing_inputs(torch, mu):
    n = mu.shape[0]
    w = torch.where(mu.sum() > 0, mu, torch.ones_like(mu))
    s = w.sum()
    p = (w * (torch.full_like(s, n) / s)).float()
    idx = torch.arange(n, device=mu.device)
    small = p < 1.0
    stack = idx[torch.argsort(torch.where(small, idx, n + idx))].to(torch.int32)
    return p, stack, small.sum(dtype=torch.int32).reshape(1)


def phase_kernels(torch, chk, dev):
    K = chk.K
    shapes = [(n, B) for n in (1024, 2048) for B in (128, 300, 4096, 16384)]
    for n, B in shapes:
        for case in ("random", "zero", "single_hot"):
            rng = np.random.RandomState(n + B)
            mu = rng.rand(n).astype(np.float32) * 5
            if case != "random":
                mu[:] = 0
            if case == "single_hot":
                mu[rng.randint(n)] = 3.0
            mu_t = torch.from_numpy(mu).to(dev)
            q = torch.from_numpy(rng.randint(0, 50, n).astype(np.int32)).to(dev)
            u1, u2, v1, v2 = (torch.from_numpy(rng.randint(0, 65536, B).astype(np.float32)
                                               / 65536.0).to(dev) for _ in range(4))
            cdf = chk.R.make_cdf(mu_t)
            p, stack, ns0 = pairing_inputs(torch, mu_t)
            prob, alias = K.alias_pairing(p, stack, ns0)
            chk.compare("alias_pairing", (prob, alias),
                        chk.R.alias_pairing_ref(p, stack, ns0))
            chk.compare("ppot_dispatch_fused_alias",
                        K.ppot_dispatch_fused_alias(prob, alias, q, u1, v1, u2, v2),
                        chk.R.ppot_dispatch_fused_alias_ref(prob, alias, q, u1, v1, u2, v2))
            chk.compare("ppot_dispatch_fused", K.ppot_dispatch_fused(cdf, q, u1, u2),
                        chk.R.ppot_dispatch_fused_ref(cdf, q, u1, u2))
            chk.compare("ppot_dispatch", K.ppot_dispatch(cdf, q, u1, u2),
                        chk.R.ppot_dispatch_ref(cdf, q, u1, u2))
    print(f"[kernels] {len(shapes) * 3} shape/μ̂ cases: every kernel equal to "
          f"its plain version (workers, q_after, prob, alias)")


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def make_router_class(tr):
    class CheckedRouter(tr.RosellaRouter):
        """RosellaRouter that checks every turn's output, can take part of
        the cluster offline mid-run, and at turn ``flood_at`` adds a burst
        of completions (service times drawn from the true ``speeds``) ahead
        of the due ones, so that the flush overflows SERVE_COMP_CAP and
        takes the ``complete_arrays`` path on the card."""

        membership_at: tuple | None = None
        flood_at: int | None = None
        speeds: np.ndarray | None = None
        overflow_turns = 0
        turns = 0

        def serve_turn(self, now, k, comp_workers=None, comp_times=None, comp_now=None):
            if self.membership_at is not None and now >= self.membership_at[0]:
                self.set_membership(self.membership_at[1], now)
                self.membership_at = None
            if self.turns == self.flood_at:
                rng = np.random.RandomState(self.turns)
                live = (np.arange(self.n) if self.active is None
                        else np.nonzero(self.active.cpu().numpy())[0])
                w = rng.choice(live, tr.SERVE_COMP_CAP + 40).astype(np.int32)
                ts = rng.exponential(1.0, len(w)) / self.speeds[w]
                comp_workers = w if comp_workers is None else np.concatenate([w, comp_workers])
                comp_times = ts if comp_times is None else np.concatenate([ts, comp_times])
                comp_now = now if comp_now is None else comp_now
            if comp_workers is not None and len(comp_workers) > tr.SERVE_COMP_CAP:
                self.overflow_turns += 1
            fake, workers = super().serve_turn(now, k, comp_workers, comp_times, comp_now)
            self.turns += 1
            need(len(workers) == k, "wrong batch size")
            routed = np.concatenate([fake, workers])
            need(((routed >= 0) & (routed < self.n)).all(), "worker out of range")
            if self.active is not None:
                act = self.active.cpu().numpy()
                need(act[routed].all(), "routed to an inactive replica")
            need(int(self.q_view.min()) >= 0, "negative queue view")
            return fake, workers
    return CheckedRouter


def run_mode(torch, tr, K, chk, speeds, mode: str, dev):
    use_alias, async_mu = {"a": (True, True), "b": (False, False),
                           "c": (False, False)}[mode]
    Router = make_router_class(tr)
    rate = LOAD * float(speeds.sum())
    horizon = TURNS[mode] * BATCH / rate
    router = Router(N_REPLICAS, float(speeds.sum()), seed=SEED, use_alias=use_alias,
                    async_mu=async_mu, device=dev)
    router.speeds, router.flood_at = speeds, TURNS[mode] // 4
    if mode == "c":
        off = np.random.RandomState(SEED + 1).choice(N_REPLICAS, N_REPLICAS // 20,
                                                     replace=False)
        act = np.ones(N_REPLICAS, bool)
        act[off] = False
        router.membership_at = (horizon / 2, act)
    saved = {name: getattr(K, name) for name in REPLACES}
    for name in REPLACES:
        setattr(K, name, chk.wrap(name, CHECK_EVERY))
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        resp, mu_trace = tr.run_simulation(
            router, tr.SimulatedPool(speeds), arrival_rate=rate, horizon=horizon,
            request_cost=1.0, seed=SEED, arrival_batch=BATCH)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)
    return router, resp, mu_trace, wall, counts


def phase_main_path(torch, tr, K, met, chk, speeds, dev):
    results = {}
    expect = {"a": ("ppot_dispatch_fused_alias", "alias_pairing"),
              "b": ("ppot_dispatch_fused",),
              "c": ("ppot_dispatch_fused", "ppot_dispatch")}
    for mode in ("a", "b", "c"):
        router, resp, mu_trace, wall, counts = run_mode(torch, tr, K, chk, speeds, mode, dev)
        turns = router.turns
        need(turns >= MIN_TURNS[mode], f"run ({mode}): only {turns} turns")
        for name in expect[mode]:
            need(counts[name] > 0, f"run ({mode}): {name} was never launched")
        need(router.overflow_turns > 0, f"run ({mode}): no flush overflowed "
             f"SERVE_COMP_CAP, so complete_arrays never ran")
        need(np.isfinite(resp).all() and (resp > 0).all(), f"run ({mode}): bad responses")
        s = met.serve_summary(resp)
        rho = spearman(router.mu_hat, speeds)
        results[mode] = dict(turns=turns, launches=counts, wall_s=wall, rho=rho,
                             overflow_turns=router.overflow_turns, **s)
        print(f"[main {mode}] turns={turns} requests={s['n_requests']} "
              f"p50={s['p50']:.6f} p99={s['p99']:.6f} mean={s['mean']:.6f} "
              f"turns/s={turns / wall:.2f} decisions/s={s['n_requests'] / wall:.1f} "
              f"spearman(mu_hat, speeds)={rho:.4f} overflow_turns={router.overflow_turns} "
              f"launches={counts}")
    need(results["a"]["rho"] >= 0.9,
         f"run (a): μ̂ ranks the replicas poorly (Spearman {results['a']['rho']:.3f})")
    print(f"[main] kernel-vs-plain checks during the runs: {chk.checks}")
    return results


def phase_turn_cost(torch, tr, speeds, timed_turns: int = 300, prof_turns: int = 60):
    """Where a turn of the default mode goes: wall clock of an unchecked,
    unprofiled run split into the router's turn and the rest of the loop
    (the numpy replica pool, arrivals, the μ̂ trace), then CUDA launches
    and device busy time per turn from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    class TimedRouter(tr.RosellaRouter):
        turn_s = 0.0

        def serve_turn(self, *args, **kw):
            t0 = time.perf_counter()
            out = super().serve_turn(*args, **kw)
            self.turn_s += time.perf_counter() - t0
            return out

    rate = LOAD * float(speeds.sum())
    router = TimedRouter(N_REPLICAS, float(speeds.sum()), seed=SEED)
    tr.run_simulation(router, tr.SimulatedPool(speeds), arrival_rate=rate,
                      horizon=20 * BATCH / rate, seed=SEED, arrival_batch=BATCH)
    router.turn_s = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp, mu = tr.run_simulation(router, tr.SimulatedPool(speeds), arrival_rate=rate,
                                 horizon=timed_turns * BATCH / rate, seed=SEED + 1,
                                 arrival_batch=BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    turns = len(mu)
    print(f"[turn] {turns} unchecked turns of run (a): {turns / wall:.2f} turns/s, "
          f"{len(resp) / wall:.1f} decisions/s, {wall / turns * 1e3:.3f} ms/turn, "
          f"of which serve_turn {router.turn_s / turns * 1e3:.3f} ms "
          f"({router.turn_s / wall:.4f} of the wall clock)")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, mu = tr.run_simulation(router, tr.SimulatedPool(speeds), arrival_rate=rate,
                                  horizon=prof_turns * BATCH / rate, seed=SEED + 2,
                                  arrival_batch=BATCH)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    pturns = len(mu)
    kernels = copies = 0
    busy_us = 0.0
    by_name: dict[str, int] = {}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        nm = e.name.lower()
        if "memcpy" in nm or "memset" in nm:
            copies += 1
        else:
            kernels += 1
            by_name[e.name] = by_name.get(e.name, 0) + 1
        busy_us += e.time_range.elapsed_us()
    need(kernels > 0, "profiler saw no CUDA kernel")
    idle = 1 - busy_us / 1e6 / pwall
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[profile] {pturns} turns of run (a): {kernels / pturns:.1f} kernel launches "
          f"and {copies / pturns:.1f} copies per turn; device busy "
          f"{busy_us / 1e3:.3f} ms of {pwall * 1e3:.3f} ms wall (idle share {idle:.4f})")
    print(f"[profile] most launched: {[(n[:90], c) for n, c in top]}")
    return kernels / pturns, copies / pturns, idle


# ---------------------------------------------------------------------------
# times
# ---------------------------------------------------------------------------


def event_median_ms(torch, launch, reps: int = 200) -> float:
    """Median device time of one call, from an event pair around each call.
    A long spin queued first lets the host enqueue every call before the
    device reaches them, so host launch latency stays out of the pairs."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for e0, e1 in evs:
        e0.record()
        launch()
        e1.record()
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in evs]))


def host_median_ms(torch, fn, reps: int = 20) -> float:
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def phase_times(torch, K, R, build, dev):
    """Each kernel alone (its C entry point on preallocated buffers), its
    plain version, and its bound, at the main path's shape and a large one."""
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    floor_t = torch.zeros(1, device=dev)
    floor_ms = event_median_ms(torch, floor_t.zero_)
    print(f"[times] launch floor (one 1-element fill kernel, event pair): {floor_ms:.6f} ms")
    out = {}
    for n, B in ((1024, BATCH), (2048, 16384)):
        rng = np.random.RandomState(n + B)
        mu = torch.from_numpy(rng.rand(n).astype(np.float32) * 5).to(dev)
        q = torch.from_numpy(rng.randint(0, 50, n).astype(np.int32)).to(dev)
        u1, u2, v1, v2 = (torch.from_numpy(rng.randint(0, 65536, B).astype(np.float32)
                                           / 65536.0).to(dev) for _ in range(4))
        cdf = R.make_cdf(mu)
        p, stack, ns0 = pairing_inputs(torch, mu)
        prob, alias = K.alias_pairing(p, stack, ns0)
        w = torch.empty(B, dtype=torch.int32, device=dev)
        qa = q.clone()
        P = lambda t: t.data_ptr()  # noqa: E731
        logn = int(np.ceil(np.log2(n)))
        cases = {
            "ppot_dispatch_fused_alias": (
                lambda: lib.ppot_fused_alias(P(prob), P(alias), P(q), P(u1), P(v1), P(u2),
                                             P(v2), n, B, P(w), P(qa), stream),
                lambda: R.ppot_dispatch_fused_alias_ref(prob, alias, q, u1, v1, u2, v2),
                16 * n + 20 * B, 3 * B),
            "ppot_dispatch_fused": (
                lambda: lib.ppot_fused_cdf(P(cdf), P(q), P(u1), P(u2), n, B, P(w), P(qa),
                                           stream),
                lambda: R.ppot_dispatch_fused_ref(cdf, q, u1, u2),
                12 * n + 12 * B, B * (2 * logn + 1)),
            "ppot_dispatch": (
                lambda: lib.ppot_select_cdf(P(cdf), P(q), P(u1), P(u2), n, B, P(w), stream),
                lambda: R.ppot_dispatch_ref(cdf, q, u1, u2),
                8 * n + 12 * B, B * (2 * logn + 1)),
        }
        pp, pa = torch.empty_like(prob), torch.empty_like(alias)
        cases["alias_pairing"] = (
            lambda: lib.alias_pairing(P(p), P(stack), P(ns0), n, P(pp), P(pa), stream),
            lambda: R.alias_pairing_ref(p, stack, ns0),
            16 * n + 4, 3 * n)
        for name, (kern, plain, nbytes, nops) in cases.items():
            ms = event_median_ms(torch, kern)
            if name == "alias_pairing":  # the plain walk runs on the host
                plain_ms = host_median_ms(torch, plain)
            else:
                plain_ms = event_median_ms(torch, plain)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = nops / F32_OPS_PER_S * 1e3
            rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                       bytes=nbytes, library_ms=None)
            out[(name, n, B)] = rec
            shape = f"n={n}" + ("" if name == "alias_pairing" else f" B={B}")
            print(f"[times] {name} {shape}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
                  f"bound {rec['bound_ms']:.9f} ms ({rec['bound_by']}, {nbytes} B), "
                  f"launch floor {floor_ms:.6f} ms, library call: none")
    print("[times] library_ms: no single PyTorch call computes these functions")
    return out, floor_ms


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device")
    try:
        from repro_torch.configs.rosella_sim import tpch_speed_set
        from repro_torch.core import metrics as met
        from repro_torch.kernels.ppot_dispatch import build
        from repro_torch.kernels.ppot_dispatch import kernel as K
        from repro_torch.kernels.ppot_dispatch import ref as R
        from repro_torch.serving import router as tr
    except ImportError as e:
        raise SmokeFailure(f"the port is not next to this script ({e})") from e
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; {card}")

    t0 = time.perf_counter()
    build.build()
    print(f"[build] {build.library_path().name} in {time.perf_counter() - t0:.2f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    chk = KernelChecks(torch, K, R)
    phase_kernels(torch, chk, dev)
    speeds = tpch_speed_set(N_REPLICAS, SEED)
    main_runs = phase_main_path(torch, tr, K, met, chk, speeds, dev)
    per_turn, copies, idle = phase_turn_cost(torch, tr, speeds)
    times, floor_ms = phase_times(torch, K, R, build, dev)

    total = {name: sum(r["launches"][name] for r in main_runs.values())
             for name in REPLACES}
    kernels = []
    for name in REPLACES:
        t = times[(name, 1024, BATCH)]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=total[name], max_abs_err=chk.max_err[name], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=None))
    summary = {m: {k: r[k] for k in ("turns", "p50", "p99", "rho", "wall_s",
                                     "overflow_turns", "launches")}
               for m, r in main_runs.items()}
    print(f"[summary] {json.dumps(summary)}")
    print(f"[summary] launches/turn {per_turn:.1f}, copies/turn {copies:.1f}, "
          f"idle share {idle:.4f}, launch floor {floor_ms:.6f} ms")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
