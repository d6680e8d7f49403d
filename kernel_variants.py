#!/usr/bin/env python3
"""Times the port's flash-attention (K4), SSD-scan (K5), PPoT dispatch
(K1-K3 and the alias-table build) and pool-chain kernels against variants
of their own sources on one CUDA card, at the shapes of chip_smoke.py's
[times] phase.

Each variant is the current source with one textual edit (a design choice
undone, or a part of the work left out to see what it costs: those are
marked "diagnostic" and compute a wrong result). With ``--parent DIR``,
the kernels of another checkout of this repository (``git archive`` of an
earlier commit unpacked into DIR) are built and timed on the same inputs,
in turns with the current ones (parent, current, current, parent). Its
K4/K5 entry points are read as they were before their redesign, its PPoT
ones as they were before the alias-table kernel (``alias_pairing`` walks a
stack built by tensor ops), its pool chain's array form (``pool_chain``) as
it has been since the chain was ported; with the chain, the one-program
loop's [scan a] and [scan e] also run whole on each checkout, each in a
process of its own. ``--kernels`` picks the sources (default all four).

    python3 kernel_variants.py [--kernels flash,ssd,ppot,chain] [--parent DIR] [--out FILE.json]

Needs a CUDA card and nvcc; imports torch and the port, nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

K4_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
K5_SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"

_K4_SOFTMAX = "      // positions only on the tiles that need them\n"
_K4_PV = "      // acc += P V, P from registers, V MN-major\n"
_K4_LOOP = "      // S = Q K^T: 64 rows x BK keys, f32\n"
_K4_LOOP_END = "      if (lane == 0) mbar_arrive(empty_v(s));\n    }\n"


def _between(src: str, start: str, end: str, new: str) -> str:
    a, b = src.index(start), src.index(end)
    return src[:a] + new + src[b:]


# (name, edit of the source); the edit raises if the source has moved on
K4_VARIANTS = [
    ("two consumer warpgroups a block (128 rows, one block per SM)",
     lambda s: s.replace("constexpr int kConsumers = 1;", "constexpr int kConsumers = 2;")),
    ("rescale skipped by a warp whose rows' maxima did not move",
     lambda s: s.replace("""#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= c0;""", """#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (!__any_sync(0xffffffffu, m0 != mx0 || m1 != mx1)) break;
        acc[4 * j] *= c0;""")),
    ("diagnostic: no ex2 (p = s * c - m * c)", lambda s: s.replace("ex2(fmaf(", "(fmaf(")),
    ("diagnostic: no softmax (P = bf16(S))",
     lambda s: _between(s, _K4_SOFTMAX, _K4_PV, """      uint32_t pf[T::BK / 16][4];
#pragma unroll
      for (int j = 0; j < T::BK / 8; ++j) {
        pf[j / 2][2 * (j & 1)] = pack_f32(sc[4 * j], sc[4 * j + 1]);
        pf[j / 2][2 * (j & 1) + 1] = pack_f32(sc[4 * j + 2], sc[4 * j + 3]);
      }
""")),
    ("diagnostic: no PV product",
     lambda s: s.replace("        wgmma_rs<D>(acc, pf[kk], db);", "        if (db == 0) wgmma_rs<D>(acc, pf[kk], db);")),
    ("diagnostic: loads only (the TMA ring, no products, no softmax)",
     lambda s: _between(s, _K4_LOOP, _K4_LOOP_END, """      (void)k0;
      mbar_wait(full_k(s), ph);
      if (lane == 0) mbar_arrive(empty_k(s));
      mbar_wait(full_v(s), ph);
""")),
]

K5_VARIANTS = [
    ("split by rounding (cvt.rna.tf32) instead of masking",
     lambda s: s.replace("""  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));""", """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));""")),
    ("carry loads 4 chunk states ahead",
     lambda s: s.replace("constexpr int kCarryAhead = 8;", "constexpr int kCarryAhead = 4;")),
    ("no register cap on grids 1 and 3 (one block per SM)",
     lambda s: s.replace("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")),
    ("4 rows a block of grids 1 and 3 at every shape",
     lambda s: s.replace("  return rows;\n}", "  return 4;\n}")),
    ("the carry one state element a thread",
     lambda s: s.replace("(N * P) % 4 ? 1 : 4", "1").replace("if ((N * P) % 4)", "if (true)")),
    ("C·Bᵀ (grid 0) on the tensor cores, 3xTF32",
     lambda s: s.replace(
         "warp_fma<false, kLdN, 1, 1, kLdN>(acc, N, Cs + tm * 32 * kLdN, Bs + tn * 32 * kLdN);",
         "warp_mma<false, false, kLdN, 1, 1, kLdN>(acc, round_up(N, 8), Cs + tm * 32 * kLdN, "
         "Bs + tn * 32 * kLdN);")),
]

PPOT_SRC = "src/repro_torch/kernels/ppot_dispatch/csrc/ppot_dispatch.cu"
_PROBE = "  int a = 0, b = 0;\n"
_PROBE_END = "  j1 = a < n - 1 ? a : n - 1;\n"
_WALK = "  // 2. the walk"
_WALK_BODY = "  if (threadIdx.x == 0) {\n    int steps = 0;"
_WALK_END = "  // 3. where the walk ended"
_LOOKAHEAD_WALK = """  if (threadIdx.x == 0) {
    int steps = 0;
    if (ns0 > 0 && nl0 > 0) {
      const float* ps = val + ns0 - 1;  // the next small
      const float* pL = val + n - 1;    // the current large
      float s1 = ps[0], s2 = ps[-1];    // the next two smalls
      float pl = pL[0], n1 = pL[-1], n2 = pL[-2];  // the large, the next two
      // The small a consuming step shifts in and the large a drop shifts in
      // are loaded two steps ahead, one load for each outcome of the steps
      // between (c: for this step, n: for the next)
      float yc0 = ps[-1], yc1 = ps[-2], yn0 = ps[-2], yn1 = ps[-3];
      float xc0 = pL[-3], xc1 = pL[-4], xc2 = pL[-5];
      float xn0 = xc0, xn1 = xc1, xn2 = xc2;
      bool pend = false, pend_prev = false;  // the last residual is the next small
      float a = 0.0f;  // its deficit
      for (;;) {
#pragma unroll
        for (int u = 0; u < kWalkUnroll; ++u) {
          const float y = pend_prev ? yc0 : yc1;
          const float x = pend_prev ? (pend ? xc2 : xc1) : (pend ? xc1 : xc0);
          // the loads for two steps on, issued before this step's store to
          // the log (which the compiler does not move loads across)
          const float* ps_nx = pend ? ps : ps - 1;
          const float yf0 = ps_nx[-2], yf1 = ps_nx[-3];
          const float xf0 = pL[-3], xf1 = pL[-4], xf2 = pL[-5];
          // the large's residual mass, two explicit roundings as in the reference
          const float r = __fsub_rn(pl, pend ? a : s1);
          lg[steps + u] = r;
          const bool drop = r < 1.0f;
          a = __fsub_rn(1.0f, r);
          if (!pend) {
            s1 = s2;
            s2 = y;
          }
          ps = ps_nx;
          if (drop) {
            pl = n1;
            n1 = n2;
            n2 = x;
            --pL;
          } else {
            pl = r;
          }
          pend_prev = pend;
          pend = drop;
          yc0 = yn0;
          yc1 = yn1;
          yn0 = yf0;
          yn1 = yf1;
          xc0 = xn0;
          xc1 = xn1;
          xc2 = xn2;
          xn0 = xf0;
          xn1 = xf1;
          xn2 = xf2;
        }
        steps += kWalkUnroll;
        if ((ps < val && !pend) || pL < val + ns0) break;  // both stay true once true
      }
    }
    s_steps = steps;
  }
  __syncthreads();

"""

def _l1_search(s: str) -> str:
    """K2/K3 search the cdf and read q through L1 (__ldg) with nothing
    staged; the alias kernel (K1) keeps its staging."""
    edits = [
        ("    const float ca = cdf[min(a + step, n) - 1];\n"
         "    const float cb = cdf[min(b + step, n) - 1];\n",
         "    const float ca = __ldg(cdf + min(a + step, n) - 1);\n"
         "    const float cb = __ldg(cdf + min(b + step, n) - 1);\n"),
        ("    s_tab[i] = tab[i];\n    s_q[i] = q[i];\n",
         "    if (ALIAS) {\n      s_tab[i] = tab[i];\n      s_q[i] = q[i];\n    }\n"),
        ("  __syncthreads();\n\n  const int b = blockIdx.x",
         "  if (ALIAS || FOLD) __syncthreads();\n\n  const int b = blockIdx.x"),
        ("cdf_probe2(s_tab, n, u1[b], u2[b], j1, j2);",
         "cdf_probe2(tab, n, u1[b], u2[b], j1, j2);"),
        ("const int w = s_q[j1] <= s_q[j2] ? j1 : j2;",
         "const int w = (ALIAS ? s_q[j1] : __ldg(q + j1)) <= (ALIAS ? s_q[j2] : __ldg(q + j2))"
         " ? j1 : j2;"),
        ("(size_t)n * 4 * (2 + (ALIAS ? 1 : 0) + (FOLD ? 1 : 0))",
         "(size_t)n * 4 * (ALIAS ? 3 + (FOLD ? 1 : 0) : (FOLD ? 3 : 0))"),
    ]
    for a, b in edits:
        if s.count(a) != 1:
            raise SystemExit(f"the L1 search variant no longer applies: {a!r}")
        s = s.replace(a, b)
    return s


PPOT_VARIANTS = [
    ("K2/K3: the dense probe #{i : cdf[i] <= u} (the earlier design)",
     lambda s: _between(s, _PROBE, _PROBE_END, """  int a = 0, b = 0;
  for (int i = 0; i < n; ++i) a += cdf[i] <= u1 ? 1 : 0;
  for (int i = 0; i < n; ++i) b += cdf[i] <= u2 ? 1 : 0;
""")),
    ("K2/K3: the cdf and q read through L1 (__ldg), nothing staged", _l1_search),
    ("alias_table: the earlier stack walk (every operand and update through shared memory)",
     lambda s: _between(s, _WALK, _WALK_END, """  // 2. the walk as the earlier stack walk, writing the same log
  if (threadIdx.x == 0) {
    int steps = 0, ns = ns0, nl = nl0;
    while (ns > 0 && nl > 0) {
      float* ds = val + ns - 1;        // the top small's deficit
      float* pL = val + ns0 + nl - 1;  // the current large
      const float r = __fsub_rn(*pL, *ds);
      lg[steps++] = r;
      *pL = r;
      if (r < 1.0f) {
        *ds = __fsub_rn(1.0f, r);  // the residual takes the vacated slot
        --nl;
      } else {
        --ns;
      }
    }
    s_steps = steps;
  }
  __syncthreads();

""")),
    ("alias_table: no register windows (a step loads its own small and the large after a drop)",
     lambda s: s.replace("pend ? a : s1", "pend ? a : ps[0]").replace("pl = n1;", "pl = pL[-1];")),
    ("alias_table: what a step shifts in loaded two steps ahead, one load per outcome",
     lambda s: _between(s, _WALK_BODY, _WALK_END, _LOOKAHEAD_WALK)),
    ("alias_table: the exit test every step",
     lambda s: s.replace("constexpr int kWalkUnroll = 32;", "constexpr int kWalkUnroll = 1;")),
]

POOL_SRC = "src/repro_torch/kernels/pool_chain/csrc/pool_chain.cu"
CHAIN_VARIANTS = [
    ("256 threads a block",
     lambda s: s.replace("constexpr int kThreads = 1024;", "constexpr int kThreads = 256;")),
    ("a chain's clock read from device memory by its walker (not gathered in step 2)",
     lambda s: s.replace("double clk = fa0[h];", "double clk = p.free_at[ws[h]];")),
    ("one warp links the tiles in turn (tile groups and stitch in one pass)",
     lambda s: s.replace("for (int base = warp * 32; base < M; base += nt) {",
                         "for (int base = 0; warp == 0 && base < M; base += 32) {")),
    ("the stitch reads one tile ahead (not 8)",
     lambda s: s.replace("constexpr int kStitch = 8;", "constexpr int kStitch = 1;")),
    ("diagnostic: no walk (chains linked, none walked)",
     lambda s: s.replace("    if (!(one_tile ? flag[h] & kFirst : flag[h])) continue;",
                         "    if (true) continue;")),
    ("diagnostic: no stitch (every tile's groups walked as chains of their own)",
     lambda s: s.replace("if (warp == 0 && !one_tile) {", "if (false) {")),
]

# the C entry points of the kernels before their redesign, for --parent
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {
    "flash": {"flash_attention_fwd": (_P,) * 4 + (_I,) * 6 + (ctypes.c_float, _I, _I, _I, _P)},
    "ssd": {"ssd_scan": (_P,) * 7 + (_I,) * 9 + (_P,)},
    "ppot": {"ppot_fused_alias": (_P,) * 7 + (_I, _I, _P, _P, _P),
             "ppot_fused_cdf": (_P,) * 4 + (_I, _I, _P, _P, _P),
             "ppot_select_cdf": (_P,) * 4 + (_I, _I, _P, _P),
             "alias_pairing": (_P, _P, _P, _I, _P, _P, _P)},
    "chain": {"pool_chain": (_P,) * 6 + (_I, _I) + (_P,) * 4},
}


def variant_sources(path: str, variants, tmp: Path) -> list[tuple[str, Path]]:
    src = (ROOT / path).read_text()
    out = []
    for i, (name, edit) in enumerate(variants):
        text = edit(src)
        if text == src:
            raise SystemExit(f"variant {name!r}: its edit no longer applies to {path}")
        p = tmp / f"{Path(path).stem}_v{i}.cu"
        p.write_text(text)
        out.append((name, p))
    return out


def time_ppot(torch, libs, parent, median_ms) -> dict:
    """K2/K3 and the alias-table kernel against their variants, each in turns
    with the current source (current, variant, variant, current), at
    chip_smoke.py's [times] shapes; with a parent, its K1-K3 and its pairing
    walk the same way, and its whole table build (tensor ops for the stack
    order and the mask pass around its walk) against build_alias_table."""
    import chip_smoke as CS
    from repro_torch.core import dispatch as D
    from repro_torch.kernels.ppot_dispatch import ref as R

    stream = torch.cuda.current_stream().cuda_stream
    P = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    out = {}
    for n, B in ((1024, CS.BATCH), (2048, 16384)):
        rng = np.random.RandomState(n + B)
        dev = torch.device("cuda")
        mu = torch.from_numpy(rng.rand(n).astype(np.float32) * 5).to(dev)
        q = torch.from_numpy(rng.randint(0, 50, n).astype(np.int32)).to(dev)
        u1, u2, v1, v2 = (torch.from_numpy(rng.randint(0, 65536, B).astype(np.float32)
                                           / 65536.0).to(dev) for _ in range(4))
        act = torch.from_numpy(R.make_mask("tenth_off", n, rng)).to(dev)
        cdf = R.make_cdf(mu)
        p = D.scaled_weights(mu)
        prob, alias = R.alias_table_ref(p)
        w, qa = torch.empty(B, dtype=torch.int32, device=dev), q.clone()
        pp, pa = torch.empty_like(prob), torch.empty_like(alias)
        calls = {  # name -> (launch on a library, output, plain version)
            "ppot_dispatch_fused": (
                lambda lib: lib.ppot_fused_cdf(P(cdf), P(q), P(u1), P(u2), n, B, P(w), P(qa),
                                               stream), lambda: w,
                lambda: R.ppot_dispatch_ref(cdf, q, u1, u2)),
            "ppot_dispatch": (
                lambda lib: lib.ppot_select_cdf(P(cdf), P(q), P(u1), P(u2), n, B, P(w),
                                                stream), lambda: w,
                lambda: R.ppot_dispatch_ref(cdf, q, u1, u2)),
            "alias_table": (
                lambda lib: lib.alias_table(P(p), None, n, P(pp), P(pa), stream),
                lambda: (pp, pa), lambda: (prob, alias)),
            "alias_table masked": (
                lambda lib: lib.alias_table(P(p), P(act), n, P(pp), P(pa), stream),
                lambda: (pp, pa), lambda: R.alias_table_ref(p, act)),
        }
        label = f"n={n} B={B}"
        row = out[label] = {}
        cur = libs[0][1].load()
        for vname, lib in libs[1:]:
            vl = lib.load()
            names = [k for k in calls if k.startswith("alias_table") == vname.startswith("alias")]
            for name in names:
                launch, got, want = calls[name]
                launch(vl)
                torch.cuda.synchronize()
                g, wnt = got(), want()
                equal = all(torch.equal(a, b) for a, b in zip(
                    g if isinstance(g, tuple) else (g,), wnt if isinstance(wnt, tuple) else (wnt,)))
                turns = [median_ms(lambda lb=lb: launch(lb), 200) for lb in (cur, vl, vl, cur)]
                row.setdefault(name, {})[vname] = dict(
                    ms=statistics.mean(turns[1:3]),
                    current_same_call_ms=statistics.mean((turns[0], turns[3])), equal=equal)
        if parent is not None:
            pl = parent.load()
            stack, ns0 = R.stack_order(p)
            old = {
                "ppot_dispatch_fused_alias": lambda: pl.ppot_fused_alias(
                    P(prob), P(alias), P(q), P(u1), P(v1), P(u2), P(v2), n, B, P(w), P(qa),
                    stream),
                "ppot_dispatch_fused": lambda: pl.ppot_fused_cdf(
                    P(cdf), P(q), P(u1), P(u2), n, B, P(w), P(qa), stream),
                "ppot_dispatch": lambda: pl.ppot_select_cdf(
                    P(cdf), P(q), P(u1), P(u2), n, B, P(w), stream),
                "alias_table": lambda: pl.alias_pairing(
                    P(p), P(stack), P(ns0), n, P(pp), P(pa), stream),
            }
            new = dict(calls, ppot_dispatch_fused_alias=(
                lambda lib: lib.ppot_fused_alias(P(prob), P(alias), P(q), P(u1), P(v1), P(u2),
                                                 P(v2), n, B, P(w), P(qa), stream),))
            for name, fn in old.items():
                nf = lambda: new[name][0](cur)  # noqa: E731
                turns = [median_ms(f, 200) for f in (fn, nf, nf, fn)]
                row.setdefault(name, {})["parent"] = dict(
                    ms=statistics.mean((turns[0], turns[3])),
                    current_same_call_ms=statistics.mean(turns[1:3]))

            def parent_build(a):
                pw = D.scaled_weights(mu, a)
                st, k = R.stack_order(pw)
                pr, al = torch.empty_like(pw), torch.empty(n, dtype=torch.int32, device=dev)
                pl.alias_pairing(P(pw), P(st), P(k), n, P(pr), P(al), stream)
                return (pr, al) if a is None else R.mask_pass(pr, al, a)

            for mlabel, a in (("unmasked", None), ("masked", act)):
                want = D.build_alias_table(mu, a)
                got = parent_build(a)
                torch.cuda.synchronize()
                rec = {}
                for how, fn in (("parent composition", lambda: parent_build(a)),
                                ("build_alias_table", lambda: D.build_alias_table(mu, a))):
                    prof = CS.device_profile(torch, lambda: [fn() for _ in range(20)])
                    rec[how] = dict(launches=prof["launches"] / 20,
                                    host_ms=CS.host_median_ms(torch, fn, reps=50))
                rec["equal"] = all(torch.equal(x, y) for x, y in zip(got, want))
                row[f"table build {mlabel}"] = rec
        for name, r in row.items():
            print(f"[ppot {label}] {name}: {json.dumps(r)}", flush=True)
    return out


# the one-program loop run whole by one checkout's package, for --parent:
# per cell (n, batch, turns, comp_cap, pend_cap: the capacities chip_smoke.py
# sizes for [scan a] and [scan e] from the host loop), the turns/s of the
# replays (the best of five runs, capture left out: the host's noise is
# larger than the difference), the graph's nodes and a hash of the
# responses, printed as JSON
SCAN_CELLS = {"a": (1024, 128, 2050, 256, 4096), "e": (2048, 2048, 300, 4096, 16384)}
SCAN_RUN = """
import hashlib, json, sys, time
sys.path.insert(0, {src!r})
import torch
from repro_torch.configs.rosella_sim import tpch_speed_set
from repro_torch.serving import router as tr, scanloop as tsl
out = {{}}
for mode, (n, B, turns, comp_cap, pend_cap) in {cells!r}.items():
    sp = tpch_speed_set(n, 0)
    rate = 0.7 * float(sp.sum())
    times, costs, spd = tsl._precompute_workload(rate, turns * B / rate, 1.0, None, 0, B, sp)
    walls = []
    for _ in range(5):
        r = tr.RosellaRouter(n, float(sp.sum()), seed=0, use_alias=True, async_mu=False,
                             device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp, mu, info = tsl.run_workload_scan(r, tr.SimulatedPool(sp), times, costs, spd,
                                               fake_cost=0.25, pend_cap=pend_cap,
                                               comp_cap=comp_cap)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0 - (info["capture_s"] or 0.0))
    out[mode] = dict(turns=info["turns"], turns_per_s=info["turns"] / min(walls),
                     graph_nodes=info["graph_nodes"],
                     resp_sha256=hashlib.sha256(resp.tobytes()).hexdigest()[:16])
print(json.dumps(out))
"""


def time_scan(parent_dir: Path) -> dict:
    """[scan a] and [scan e] run whole by this checkout and by the parent,
    each in a process of its own, in turns (parent, current, current,
    parent)."""
    runs = []
    for tree in (parent_dir, ROOT, ROOT, parent_dir):
        res = subprocess.run([sys.executable, "-c", SCAN_RUN.format(
            src=str(tree / "src"), cells=SCAN_CELLS)], capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"the scan run of {tree} failed:\n{res.stderr[-3000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    out = {}
    for mode in SCAN_CELLS:
        r = [run[mode] for run in runs]
        out[mode] = dict(
            parent_turns_per_s=statistics.mean((r[0]["turns_per_s"], r[3]["turns_per_s"])),
            current_turns_per_s=statistics.mean((r[1]["turns_per_s"], r[2]["turns_per_s"])),
            parent_graph_nodes=r[0]["graph_nodes"], current_graph_nodes=r[1]["graph_nodes"],
            turns=r[0]["turns"], runs=r,
            same_responses=len({x["resp_sha256"] for x in r}) == 1)
        print(f"[scan {mode}] {json.dumps(out[mode])}", flush=True)
    return out


def time_chain(torch, libs, parent, median_ms) -> dict:
    """The pool chain's array form at chip_smoke.py's POOL_CASES and on the
    steps of two real turns of each of its REAL_TURN_MODES cells (turn
    SCAN_PROFILE_TURNS and the turn with the cell's longest chain): each variant
    and, with a parent, the parent's kernel in turns with the current
    source (other, current, current, other), every result held against the
    plain version, beside the launch floor (one 1-element fill kernel
    between an event pair) of the same run; on the real turns also the turn
    form in place, as the scan runs it."""
    import chip_smoke as CS
    from repro_torch.configs.rosella_sim import tpch_speed_set
    from repro_torch.kernels.pool_chain import ref as CR
    from repro_torch.serving import router as tr
    from repro_torch.serving import scanloop as tsl

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    floor_t = torch.zeros(1, device=dev)
    out = {"launch_floor_ms": median_ms(floor_t.zero_, 200)}
    print(f"[chain] launch floor {out['launch_floor_ms']:.6f} ms", flush=True)
    cur = libs[0][1].load()
    others = [(name, lib.load()) for name, lib in libs[1:]]
    if parent is not None:
        others.append(("parent", parent.load()))
    cases = {CS.pool_case_label(n, M, one): CS.pool_chain_case(torch, dev, n, M, n + M, one)
             for n, M, one in CS.POOL_CASES}
    real = {}
    for mode in CS.REAL_TURN_MODES:
        # turn SCAN_PROFILE_TURNS and the turn with the cell's longest chain,
        # at capacities no turn of these cells fills
        n, B, turns = CS.SCAN_SHAPE.get(mode, (CS.N_REPLICAS, CS.BATCH, CS.SCAN_TURNS))[:3]
        speeds = tpch_speed_set(n, CS.SEED)
        pend_cap, comp_cap = 65536, 8192
        rate = CS.LOAD * float(speeds.sum())
        cols = dict(zip(("times", "costs", "speeds"), tsl._precompute_workload(
            rate, turns * B / rate, 1.0, None, CS.SEED, B, speeds)))
        router = tr.RosellaRouter(n, float(speeds.sum()), seed=CS.SEED, use_alias=True,
                                  async_mu=False, device=dev)
        cfg = tsl.scan_config(router, B, fake_cost=0.25, pend_cap=pend_cap,
                              comp_cap=comp_cap)
        chains, _ = CS.chain_by_turn(torch, tr, tsl, cfg, speeds, dev, True, cols)
        for turn in sorted({CS.SCAN_PROFILE_TURNS, int(chains.argmax())}):
            t = CS.scan_turn_args(torch, tr, tsl, speeds, dev, True, B, comp_cap, pend_cap,
                                  turns=turn)
            w, a, c, act = CR.turn_submissions(*t[2:])
            label = CS.real_turn_label(mode, turn, n, len(w))
            real[label] = t
            cases[label] = (t[0], t[1], w, a, c, act)
    for label, args in cases.items():
        n, M = args[0].shape[0], args[2].shape[0]
        want = CR.pool_chain_ref(*args)
        got = (torch.empty_like(args[3]), torch.empty_like(args[3]), torch.empty_like(args[0]))
        ptrs = [x.data_ptr() for x in (*args, *got)]

        def call(lib):
            lib.pool_chain(*ptrs[:6], n, M, *ptrs[6:], stream)

        def equal(lib):
            for x in got:
                x.fill_(float("nan"))
            call(lib)
            torch.cuda.synchronize()
            return all(torch.equal(g, w) for g, w in zip(got, want))

        row = {"current": dict(ms=median_ms(lambda: call(cur), 200), equal=equal(cur))}
        for name, lib in others:
            turns = [median_ms(lambda lb=lb: call(lb), 200) for lb in (lib, cur, cur, lib)]
            row[name] = dict(ms=statistics.mean((turns[0], turns[3])),
                             current_same_call_ms=statistics.mean(turns[1:3]),
                             equal=equal(lib))
        if label in real:  # the turn form, in place
            t = real[label]
            k = t[4].shape[0]
            f64 = dict(dtype=torch.float64, device=dev)
            outs = (torch.empty(M, **f64), torch.empty(M, **f64),
                    torch.empty(M, dtype=torch.int32, device=dev),
                    torch.empty(M, dtype=torch.bool, device=dev), t[0].clone(),
                    torch.empty(k, **f64))
            ins = [x.data_ptr() for x in (outs[4], *t[1:7])]
            ptrs_t = [x.data_ptr() for x in outs]
            row["current, turn form in place"] = dict(ms=median_ms(
                lambda: cur.pool_turn(*ins, t[7], t[8], n, t[2].shape[0], t[3].shape[0], k,
                                      *ptrs_t, None, stream), 200))
        out[label] = dict(row, longest_chain=CR.longest_chain(args[2], n))
        for name, r in row.items():
            print(f"[chain {label}] {name}: {json.dumps(r)}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="flash,ssd,ppot,chain",
                    help="comma-separated sources to time: flash, ssd, ppot, chain")
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit")
    ap.add_argument("--out", type=Path, help="write the readings as JSON")
    args = ap.parse_args()
    kinds = set(args.kernels.split(","))
    known = {"flash", "ssd", "ppot", "chain"}
    if not kinds <= known:
        raise SystemExit(f"--kernels: unknown {sorted(kinds - known)}")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.flash_attention import build as fbuild
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.pool_chain import build as cbuild
    from repro_torch.kernels.ppot_dispatch import build as pbuild
    from repro_torch.kernels.ssd_scan import build as sbuild
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="kernel_variants_", dir=ROOT / "build"
                                if (ROOT / "build").is_dir() else None))
    sources = {"flash": (K4_SRC, K4_VARIANTS, fbuild, "flash_error_string"),
               "ssd": (K5_SRC, K5_VARIANTS, sbuild, "ssd_error_string"),
               "ppot": (PPOT_SRC, PPOT_VARIANTS, pbuild, "ppot_error_string"),
               "chain": (POOL_SRC, CHAIN_VARIANTS, cbuild, "pool_chain_error_string")}
    libs, parent = {}, {}
    for kind in sorted(kinds):
        path, variants, bld, err = sources[kind]
        libs[kind] = [("current", bld.LIBRARY)] + [
            (n, _nvcc.CudaLibrary(p, bld._SIGNATURES, err))
            for n, p in variant_sources(path, variants, tmp)]
        if args.parent:
            parent[kind] = _nvcc.CudaLibrary(args.parent / path, PARENT_SIGNATURES[kind], err)
    _nvcc.build_all(*(lib for row in libs.values() for _, lib in row), *parent.values())

    def median_ms(fn, reps):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(reps)]
        torch.cuda._sleep(200_000_000)
        for a, b in evs:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in evs)

    class use:
        """Route a wrapper module's launches through another library."""

        def __init__(self, module, lib):
            self.module, self.lib = module, lib

        def __enter__(self):
            self.saved = self.module.build
            self.module.build = types.SimpleNamespace(load=self.lib.load, LIBRARY=self.lib)

        def __exit__(self, *exc):
            self.module.build = self.saved

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    readings = {"card": card}
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "ppot" in kinds:
        readings["ppot"] = time_ppot(torch, libs["ppot"], parent.get("ppot"), median_ms)
    if "chain" in kinds:
        readings["pool_chain"] = time_chain(torch, libs["chain"], parent.get("chain"), median_ms)
        if args.parent:
            readings["scan"] = time_scan(args.parent)

    # K4: q [B, S, H, D] in the model's layout, causal (hymba: window 1024)
    k4 = libs.get("flash", [])
    if k4:
        readings["flash_attention_fwd"] = {}
    for label, B, S, H, Hkv, window in (("main", 4, 4096, 15, 5, 0), ("small", 1, 2048, 15, 5, 0),
                                        ("hymba", 2, 4096, 25, 5, 1024)) if k4 else ():
        D = 64
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        want = FK.flash_attention_heads(q, k, v, causal=True, window=window)
        row = {}
        for name, lib in k4:
            with use(FK, lib):
                got = FK.flash_attention_heads(q, k, v, causal=True, window=window)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                row[name] = dict(ms=median_ms(lambda: FK.flash_attention_heads(
                    q, k, v, causal=True, window=window), 50), max_abs_diff=err)
        if parent:
            qr, kr, vr = (t.transpose(1, 2).reshape(-1, S, D).contiguous() for t in (q, k, v))
            o = torch.empty_like(qr)
            lib = parent["flash"].load()

            def old():
                lib.flash_attention_fwd(qr.data_ptr(), kr.data_ptr(), vr.data_ptr(),
                                        o.data_ptr(), B * H, H // Hkv, S, S, D, 1,
                                        D ** -0.5, 1, window, 0, stream())

            def new():
                FK.flash_attention_fwd(qr, kr, vr, causal=True, window=window)

            turns = [median_ms(f, 50) for f in (old, new, new, old)]
            o_new = FK.flash_attention_fwd(qr, kr, vr, causal=True, window=window)
            torch.cuda.synchronize()
            row["parent"] = dict(ms=statistics.mean((turns[0], turns[3])),
                                 current_same_call_ms=statistics.mean(turns[1:3]),
                                 max_abs_diff=(o.float() - o_new.float()).abs().max().item())
        readings["flash_attention_fwd"][label] = row
        for name, r in row.items():
            print(f"[K4 {label}] {name}: {r['ms']:.6f} ms" + (
                f" (current in the same turns {r['current_same_call_ms']:.6f} ms)"
                if "current_same_call_ms" in r else "")
                + f", max |diff| vs current {r['max_abs_diff']:.3e}", flush=True)

    # K5: mamba2's prefill layer (x bf16), and B = 1, S = 2048
    import chip_smoke as CS
    from torch.profiler import ProfilerActivity, profile

    k5 = libs.get("ssd", [])
    if k5:
        readings["ssd_scan"] = {}
    for label, B, S in (("main", 4, 4096), ("small", 1, 2048)) if k5 else ():
        H, P, N, Q = 32, 64, 128, 128
        x, dt, A, Bm, Cm = CS.ssd_inputs(torch, gen, torch.device("cuda"), B, S, H, P, N,
                                         xdtype=torch.bfloat16, heads=True)
        want = SR.ssd_chunked_heads(x, dt, A, Bm, Cm, chunk=Q)
        row = {}
        for name, lib in k5:
            with use(SK, lib):
                got = SK.ssd_scan_heads(x, dt, A, Bm, Cm, chunk=Q)
                torch.cuda.synchronize()
                err = SR.row_relative_error(got[0], want[0]).max().item()
                row[name] = dict(ms=median_ms(lambda: SK.ssd_scan_heads(
                    x, dt, A, Bm, Cm, chunk=Q), 20), worst_row_error=err)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                SK.ssd_scan_heads(x, dt, A, Bm, Cm, chunk=Q)
            torch.cuda.synchronize()
        row["current"]["grids_ms"] = {
            re.search(r"ssd_scan_\w+", ev.key).group(0): ev.device_time_total / ev.count / 1e3
            for ev in prof.key_averages()
            if ev.device_time_total > 0 and re.search(r"ssd_scan_\w+", ev.key)}
        if parent:
            y, h = (torch.empty_like(t) for t in want)
            lib = parent["ssd"].load()

            def old():
                lib.ssd_scan(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                             Cm.data_ptr(), y.data_ptr(), h.data_ptr(), B * H, H, B, H, S, P, N,
                             Q, 1, stream())

            def new():
                SK.ssd_scan_heads(x, dt, A, Bm, Cm, chunk=Q)

            turns = [median_ms(f, 20) for f in (old, new, new, old)]
            torch.cuda.synchronize()
            row["parent"] = dict(ms=statistics.mean((turns[0], turns[3])),
                                 current_same_call_ms=statistics.mean(turns[1:3]),
                                 worst_row_error=SR.row_relative_error(y, want[0]).max().item())
        readings["ssd_scan"][label] = row
        for name, r in row.items():
            print(f"[K5 {label}] {name}: {r['ms']:.6f} ms" + (
                f" (current in the same turns {r['current_same_call_ms']:.6f} ms)"
                if "current_same_call_ms" in r else "")
                + f", worst row error vs the plain version {r['worst_row_error']:.3e}"
                + (f"; grids {json.dumps(r['grids_ms'])}" if "grids_ms" in r else ""), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(readings, indent=1))
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
