#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of Rosella on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch`` (into ``build/``, one nvcc
per source, all at once) and holds each against its plain PyTorch version
on the card. Then it drives the port's two paths:

  * the scheduler: the serving turn (``RosellaRouter`` +
    ``run_simulation``) at a thousand-replica cell in three modes, through
    the PPoT dispatch kernels;
  * model serving: a full-width smollm-360m (published config, bf16,
    random weights from the seed) prefilled at B=4, S=4096 through
    ``models.api.prefill`` (one flash-attention launch per layer), then
    four such replicas as continuous-batching engines behind the router
    (``launch.serve._run_engine_executor``);

and times each kernel. Every phase is a hard failure: the script exits
non-zero and prints no result line. The last line of standard output is
the device record ``{"ok": true, "device": {...}}``; the line before it
lists the kernels.

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
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
SOURCE = "src/repro_torch/kernels/ppot_dispatch/csrc/ppot_dispatch.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:105"
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

# model serving: smollm-360m at its published widths (15 heads, 5 kv heads,
# d_head 64), prefilled at B=4, S=4096; four engine replicas of it at
# slowdowns 1, 3, 5, 1 with 4 slots of 256 positions each
PREFILL_B, PREFILL_S = 4, 4096
# last-position logits (|logit| < 4) of the kernel path against the plain
# chunked path, both bf16: they round attention's p and output to bf16 at
# other points in each of the 32 layers; 0.125 is 8 bf16 ulps at 2..4
PREFILL_TOL = 0.125
# the same model in f32 (the kernel's FMA variant against the plain chunked
# path), logits at every position: f32 rounding alone (1.5e-5 measured on
# an H100), far below the mean |logit| of 0.49, so a wrong tile or mask on
# any row shows
PREFILL_F32_TOL = 1e-4
SERVE_SLOWDOWNS = (1, 3, 5, 1)
SERVE_REQUESTS, SERVE_BATCH, SERVE_NEW = 64, 4, 8
# flash-attention against its plain version: elementwise as in
# tests/test_kernels.py, and each row's largest error over that row's
# largest |value| (ref.row_relative_error), which holds the late rows of a
# long causal sequence, whose values shrink below the elementwise atol.
# Rounding alone gives a row 1 bf16 ulp (2^-7) or ~1e-6 in f32; a kv tile
# dropped from the late rows gives ~0.2 (tests/test_torch_flash_attention.py)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_ROW_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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

    mus = []
    prof = device_profile(torch, lambda: mus.append(tr.run_simulation(
        router, tr.SimulatedPool(speeds), arrival_rate=rate,
        horizon=prof_turns * BATCH / rate, seed=SEED + 2, arrival_batch=BATCH)[1]))
    pturns = len(mus[0])
    kernels, copies, idle = prof["launches"], prof["copies"], prof["idle"]
    top = sorted(prof["count"].items(), key=lambda kv: -kv[1])[:8]
    print(f"[profile] {pturns} turns of run (a): {kernels / pturns:.1f} kernel launches "
          f"and {copies / pturns:.1f} copies per turn; device busy "
          f"{prof['busy_us'] / 1e3:.3f} ms of {prof['wall'] * 1e3:.3f} ms wall (idle share {idle:.4f})")
    print(f"[profile] most launched: {[(n[:90], c) for n, c in top]}")
    return kernels / pturns, copies / pturns, idle


# ---------------------------------------------------------------------------
# model serving: flash attention, prefill, engines behind the router
# ---------------------------------------------------------------------------


def flash_plain_ops(FR, q, k, v, **kw):
    """The plain version of ``ops.flash_attention`` ([B, S, H, D])."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    o = FR.attention_ref(q.transpose(1, 2).reshape(B * H, Sq, D),
                         k.transpose(1, 2).reshape(B * Hkv, -1, D),
                         v.transpose(1, 2).reshape(B * Hkv, -1, D), **kw)
    return o.reshape(B, H, Sq, D).transpose(1, 2)


def phase_flash(torch, FK, FO, FR, dev):
    """K4 against its plain version on the card: the shapes of
    tests/test_kernels.py in f32 and bf16, the decode offset, a window
    whose late rows see no key, GQA through ``ops``, and the prefill's
    shape. Returns the largest error."""
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, dtype):
        return (torch.randn(shape, generator=gen, device=dev) * 0.5).to(dtype)

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for BH, Sq, Sk, D, causal, window, off in (
                (2, 128, 128, 64, True, 0, 0), (2, 256, 256, 64, True, 64, 0),
                (1, 128, 384, 128, False, 0, 0), (3, 384, 384, 32, True, 0, 0),
                (2, 128, 256, 64, True, 0, 128), (2, 128, 256, 64, True, 16, 200),
                (2, 2048, 2048, 64, True, 0, 0)):
            cases.append((f"BH={BH} Sq={Sq} Sk={Sk} D={D} causal={causal} "
                          f"window={window} q_offset={off}", dt, "kernel",
                          (rand(BH, Sq, D, dtype=dt), rand(BH, Sk, D, dtype=dt),
                           rand(BH, Sk, D, dtype=dt)),
                          dict(causal=causal, window=window, q_offset=off)))
        cases.append((f"ops GQA B=2 S=300 H=6 Hkv=2 D=64", dt, "ops",
                      (rand(2, 300, 6, 64, dtype=dt), rand(2, 300, 2, 64, dtype=dt),
                       rand(2, 300, 2, 64, dtype=dt)), dict(causal=True, q_offset=0)))
    B, S = PREFILL_B, PREFILL_S
    cases.append((f"ops prefill shape B={B} S={S} H=15 Hkv=5 D=64", torch.bfloat16, "ops",
                  (rand(B, S, 15, 64, dtype=torch.bfloat16),
                   rand(B, S, 5, 64, dtype=torch.bfloat16),
                   rand(B, S, 5, 64, dtype=torch.bfloat16)), dict(causal=True, q_offset=0)))
    worst = worst_row = 0.0
    for name, dt, route, (q, k, v), kw in cases:
        if route == "kernel":
            got = FK.flash_attention_fwd(q, k, v, **kw)
            want = FR.attention_ref(q, k, v, **kw)
        else:
            got = FO.flash_attention(q, k, v, **kw)
            want = flash_plain_ops(FR, q, k, v, **kw)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype == dt,
             f"[flash] {name}: {got.dtype}{list(got.shape)} vs {want.dtype}{list(want.shape)}")
        tol = FLASH_TOL[str(dt).split(".")[-1]]
        row_tol = FLASH_ROW_TOL[str(dt).split(".")[-1]]
        err = (got.float() - want.float()).abs()
        need(bool(torch.isfinite(got).all()), f"[flash] {name}: non-finite output")
        need(bool((err <= tol + tol * want.float().abs()).all()),
             f"[flash] {name} {dt}: max abs err {err.max().item()} above tol {tol}")
        row = FR.row_relative_error(got, want)
        need(bool((row <= row_tol).all()),
             f"[flash] {name} {dt}: {int((row > row_tol).sum())} rows with an error above "
             f"{row_tol} of the row's largest |value| (worst {row.max().item()})")
        if kw.get("window"):
            rows = kw["q_offset"] + torch.arange(q.shape[1], device=dev)
            empty = rows >= k.shape[1] + kw["window"] - 1  # see no key at all
            need(bool((got[:, empty] == 0).all()),
                 f"[flash] {name}: rows with no valid key are not 0")
        worst = max(worst, err.max().item())
        worst_row = max(worst_row, row.max().item())
        print(f"[flash] {name} {str(dt).split('.')[-1]}: max abs err {err.max().item():.3e} "
              f"(tol {tol}), worst row error {row.max().item():.3e} of the row's "
              f"largest |value| (tol {row_tol})")
    print(f"[flash] all cases: max abs err {worst:.3e}, worst row error {worst_row:.3e}")
    return worst


def phase_prefill(torch, FK, dev):
    """The full-width prefill through ``api.prefill``: exactly one K4
    launch per layer; its last-position logits against the same model
    through the plain chunked path on the card; and the same model in f32,
    its logits at every position, against the plain chunked path."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM

    cfg = configs.get_config("smollm-360m")
    model = api.init_params(cfg, SEED, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FK.reset_launches()
    logits = api.prefill(cfg, model, {"tokens": toks})
    torch.cuda.synchronize()
    launches = FK.launch_counts()["flash_attention_fwd"]
    peak = torch.cuda.max_memory_allocated()
    need(launches == cfg.n_layers, f"[prefill] {launches} flash-attention launches, "
         f"expected one per layer ({cfg.n_layers})")
    need(logits.shape == (PREFILL_B, 1, cfg.vocab) and logits.dtype == torch.bfloat16,
         f"[prefill] logits {logits.dtype}{list(logits.shape)}")
    need(bool(torch.isfinite(logits).all()), "[prefill] non-finite logits")
    ms = host_median_ms(torch, lambda: api.prefill(cfg, model, {"tokens": toks}), reps=5)

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = api.init_params(cfg32, SEED, dev)

    @torch.no_grad()
    def all_logits():
        return LM.logits_head(cfg32, model32, LM.forward(cfg32, model32, toks))

    FK.reset_launches()
    got32 = all_logits()
    torch.cuda.synchronize()
    need(FK.launch_counts()["flash_attention_fwd"] == cfg.n_layers,
         "[prefill] the f32 model did not go through the kernel in every layer")
    saved = L.chunked_attention
    L.chunked_attention = lambda cfg, q, k, v, **kw: L.flash_attention_plain(
        q, k, v, chunk=cfg.attn_chunk, **kw)
    try:
        plain = api.prefill(cfg, model, {"tokens": toks})
        want32 = all_logits()
        torch.cuda.synchronize()
    finally:
        L.chunked_attention = saved
    err = (logits.float() - plain.float()).abs().max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    need(err <= PREFILL_TOL, f"[prefill] logits differ from the plain chunked path by "
         f"{err} (tol {PREFILL_TOL})")
    need(bool(torch.isfinite(got32).all()), "[prefill] non-finite f32 logits")
    err32 = (got32 - want32).abs().max().item()
    mean32 = want32.abs().mean().item()
    need(err32 <= PREFILL_F32_TOL, f"[prefill] f32 logits differ from the plain chunked "
         f"path by {err32} (tol {PREFILL_F32_TOL})")
    del got32, want32, model32
    tok_s = PREFILL_B * PREFILL_S / (ms / 1e3)
    print(f"[prefill] smollm-360m full width (L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads}/{cfg.n_kv_heads} V={cfg.vocab}, bf16) B={PREFILL_B} "
          f"S={PREFILL_S}: flash launches {launches}, {ms:.3f} ms per prefill "
          f"({tok_s:.1f} tokens/s), peak memory {peak / 2**30:.3f} GiB; last-position "
          f"logits vs the plain chunked path: max abs err {err:.4f} (tol {PREFILL_TOL}, "
          f"|logit| max {logits.float().abs().max().item():.3f}), argmax agreement {agree:.2f}; "
          f"f32 model, logits at all {PREFILL_B}x{PREFILL_S} positions vs the plain chunked "
          f"path: max abs err {err32:.3e} (tol {PREFILL_F32_TOL}, mean |logit| {mean32:.3f})")
    return cfg, model, dict(launches=launches, ms=ms, tok_s=tok_s, peak=peak, err=err,
                            agree=agree, err_f32=err32)


def phase_serve(torch, cfg, model, dev):
    """Four full-width engines behind the router, through the serving
    entry point's own executor loop."""
    import types

    from repro_torch.launch import serve as S
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.router import RosellaRouter

    engines = [ContinuousBatchingEngine(cfg, model, n_slots=4, max_len=256)
               for _ in SERVE_SLOWDOWNS]
    rates = S.engine_rates(engines, SERVE_SLOWDOWNS, SERVE_NEW)
    router = RosellaRouter(len(engines), float(sum(rates)), seed=SEED, device=dev)
    args = types.SimpleNamespace(requests=SERVE_REQUESTS, arrival_batch=SERVE_BATCH,
                                 n_new=SERVE_NEW)
    t0 = time.perf_counter()
    lat = S._run_engine_executor(args, cfg, engines, list(SERVE_SLOWDOWNS), router,
                                 np.random.RandomState(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    need(len(lat) == SERVE_REQUESTS, f"[serve] {len(lat)} of {SERVE_REQUESTS} completed")
    need(not any(e.active.any() for e in engines), "[serve] a slot is still active")
    mu = router.mu_hat
    speeds = [1.0 / s for s in SERVE_SLOWDOWNS]
    need(min(mu[0], mu[3]) > mu[2], f"[serve] μ̂ {mu} does not rank the 1x replicas "
         f"above the 5x one")
    tok_s = SERVE_REQUESTS * SERVE_NEW / wall
    print(f"[serve] {len(engines)} smollm-360m engines (slowdowns {list(SERVE_SLOWDOWNS)}, "
          f"4 slots, max_len 256) behind RosellaRouter (ppot_sq2): {len(lat)} requests "
          f"in {wall:.3f} s, latency mean {lat.mean() * 1e3:.3f} ms p95 "
          f"{np.percentile(lat, 95) * 1e3:.3f} ms, decode {tok_s:.1f} tokens/s; "
          f"μ̂ {[round(float(x), 3) for x in mu]} vs true speeds "
          f"{[round(x, 3) for x in speeds]}")
    return dict(n=len(lat), mean_ms=lat.mean() * 1e3, p95_ms=np.percentile(lat, 95) * 1e3,
                tok_s=tok_s, mu=mu.tolist())


def device_profile(torch, fn) -> dict:
    """Run ``fn`` under torch.profiler: its wall clock (s), device busy
    time (us), kernel launches and copies, and per kernel name its launch
    count and device time (us)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = dict(wall=wall, busy_us=0.0, launches=0, copies=0, count={}, us={})
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        us = e.time_range.elapsed_us()
        out["busy_us"] += us
        nm = e.name.lower()
        if "memcpy" in nm or "memset" in nm:
            out["copies"] += 1
            continue
        out["launches"] += 1
        out["count"][e.name] = out["count"].get(e.name, 0) + 1
        out["us"][e.name] = out["us"].get(e.name, 0.0) + us
    need(out["launches"] > 0, "profiler saw no CUDA kernel")
    out["idle"] = 1 - out["busy_us"] / 1e6 / wall
    return out


def phase_model_profile(torch, cfg, model, dev, steps: int = 10):
    """Where model serving's time goes: one full-width prefill, and
    ``steps`` engine ticks with all 4 slots decoding."""
    from repro_torch.models import api
    from repro_torch.serving.engine import ContinuousBatchingEngine

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen, device=dev)
    prof = device_profile(torch, lambda: api.prefill(cfg, model, {"tokens": toks}))
    flash_us = sum(us for name, us in prof["us"].items() if "flash_fwd" in name)
    top = sorted(prof["us"].items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile prefill] {prof['wall'] * 1e3:.3f} ms wall, device busy "
          f"{prof['busy_us'] / 1e3:.3f} ms (idle share {prof['idle']:.4f}), {prof['launches']} "
          f"kernel launches; flash attention {flash_us / 1e3:.3f} ms "
          f"({flash_us / prof['busy_us']:.4f} of device time); top by device time: "
          f"{[(nm[:60], round(us / 1e3, 3)) for nm, us in top]}")
    prefill = dict(wall_ms=prof["wall"] * 1e3, busy_ms=prof["busy_us"] / 1e3, idle=prof["idle"],
                   launches=prof["launches"], flash_share=flash_us / prof["busy_us"])

    eng = ContinuousBatchingEngine(cfg, model, n_slots=4, max_len=256)
    rng = np.random.RandomState(SEED)
    eng.try_admit_batch([(i, rng.randint(1, cfg.vocab, size=4), 10 * steps)
                         for i in range(4)])
    eng.step()

    def ticks():
        for _ in range(steps):
            eng.step()
    prof = device_profile(torch, ticks)
    top = sorted(prof["us"].items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile decode] {steps} engine ticks, 4 slots: {prof['wall'] / steps * 1e3:.3f} ms "
          f"per tick, {prof['launches'] / steps:.1f} kernel launches per tick, device busy "
          f"{prof['busy_us'] / steps / 1e3:.3f} ms per tick (idle share {prof['idle']:.4f}); "
          f"top by device time: {[(nm[:60], round(us / 1e3, 3)) for nm, us in top]}")
    decode = dict(tick_ms=prof["wall"] / steps * 1e3, launches=prof["launches"] / steps,
                  busy_ms=prof["busy_us"] / steps / 1e3, idle=prof["idle"])
    return prefill, decode


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


def phase_flash_times(torch, FK, FR, dev):
    """K4 alone at the prefill's shape and at a smaller one (B=1, S=2048),
    with its plain version, its bound and the library's fused attention
    (``scaled_dot_product_attention``, causal, GQA) on the same tensors."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, B, S in (("main", PREFILL_B, PREFILL_S), ("small", 1, 2048)):
        H, Hkv, D = 15, 5, 64
        q = torch.randn(B * H, S, D, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(B * Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        ms = event_median_ms(torch, lambda: FK.flash_attention_fwd(q, k, v, causal=True),
                             reps=50)
        plain_ms = event_median_ms(torch, lambda: FR.attention_ref(q, k, v, causal=True),
                                   reps=10)
        qq, kk, vv = q.view(B, H, S, D), k.view(B, Hkv, S, D), v.view(B, Hkv, S, D)
        lib_ms = event_median_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, is_causal=True, enable_gqa=True), reps=50)
        pairs = B * H * S * (S + 1) // 2  # the valid (query, key) pairs, causal
        flops = 2 * 2 * D * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        ops_ms = flops / BF16_OPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes", flops=flops,
                   bytes=nbytes)
        out[label] = rec
        print(f"[times] flash_attention_fwd {label} (B={B} S={S} H={H}/{Hkv} D={D} bf16 causal): "
              f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound {rec['bound_ms']:.6f} ms "
              f"({rec['bound_by']}: {flops} FLOPs at 989 TFLOP/s = {ops_ms:.6f} ms, "
              f"{nbytes} B at 3.35 TB/s = {bytes_ms:.6f} ms), library "
              f"(scaled_dot_product_attention) {lib_ms:.6f} ms, "
              f"{rec['bound_ms'] / ms:.4f} of the bound")
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device")
    try:
        from repro_torch.configs.rosella_sim import tpch_speed_set
        from repro_torch.core import metrics as met
        from repro_torch.kernels import _nvcc
        from repro_torch.kernels.flash_attention import build as flash_build
        from repro_torch.kernels.flash_attention import kernel as FK
        from repro_torch.kernels.flash_attention import ops as FO
        from repro_torch.kernels.flash_attention import ref as FR
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
    _nvcc.build_all(build.LIBRARY, flash_build.LIBRARY)
    print(f"[build] {build.library_path().name} and {flash_build.library_path().name} "
          f"in {time.perf_counter() - t0:.2f} s (one nvcc each, at once)")
    for log in (build.LIBRARY.build_log, flash_build.LIBRARY.build_log):
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    chk = KernelChecks(torch, K, R)
    phase_kernels(torch, chk, dev)
    flash_err = phase_flash(torch, FK, FO, FR, dev)
    speeds = tpch_speed_set(N_REPLICAS, SEED)
    main_runs = phase_main_path(torch, tr, K, met, chk, speeds, dev)
    cfg, model, prefill = phase_prefill(torch, FK, dev)
    serve = phase_serve(torch, cfg, model, dev)
    prof_prefill, prof_decode = phase_model_profile(torch, cfg, model, dev)
    per_turn, copies, idle = phase_turn_cost(torch, tr, speeds)
    times, floor_ms = phase_times(torch, K, R, build, dev)
    flash_times = phase_flash_times(torch, FK, FR, dev)

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
    t = flash_times["main"]
    kernels.append(dict(
        name="flash_attention_fwd", route="cuda", source=FLASH_SOURCE,
        replaces=FLASH_REPLACES, launches=prefill["launches"], max_abs_err=flash_err,
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"]))
    summary = {m: {k: r[k] for k in ("turns", "p50", "p99", "rho", "wall_s",
                                     "overflow_turns", "launches")}
               for m, r in main_runs.items()}
    print(f"[summary] {json.dumps(summary)}")
    print(f"[summary] prefill {json.dumps(prefill)}")
    print(f"[summary] serve {json.dumps(serve)}")
    print(f"[summary] profile prefill {json.dumps(prof_prefill)} decode "
          f"{json.dumps(prof_decode)}")
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
