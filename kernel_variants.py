#!/usr/bin/env python3
"""Times the port's flash-attention (K4), SSD-scan (K5), PPoT dispatch
(K1-K3 and the alias-table build), pool-chain and chain-simulator
(``sim_chain``) kernels against variants of their own sources on one CUDA
card, at the shapes of chip_smoke.py's [times] phase.

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
process of its own. Its chain simulator is read as it was ported, and its
per-phase cycle split is taken by inserting this source's clock block and
marks into it (``clocked_parent_source``), or, from the redesigned kernel
on (its source carries the clock block), through its own paper-mode entry
and clocked build; with ``sim``, a small probe
kernel also reads what one warp pays a step for the instruction classes
the chain kernel is made of (``WARP_PROBE_SRC``). ``--kernels`` picks the
sources (default all five).

    python3 kernel_variants.py [--kernels flash,ssd,ppot,chain,sim] [--parent DIR] [--out FILE.json]

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
    "sim": {"sim_chain": (_P,) * 13 + (_I,) * 10 + (_P,) * 28 + (_P,)},
    # the redesigned chain kernel's paper-mode entry, before its one entry of
    # both modes: the ring stride and the tile's rounds after cap
    "sim_tiled": {"sim_chain": (_P,) * 13 + (_I,) * 12 + (_P,) * 28 + (_P,)},
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


SIM_SRC = "src/repro_torch/kernels/sim_chain/csrc/sim_chain.cu"
# (name, edit of the source): each undoes one design choice of the chain
# kernel; every variant still equals the plain chain bit for bit
_SIM_TILE_OUT = """    // the tile's trace rows out, by the whole warp: a round's record a lane
    for (int x = lane; x < rt; x += kThreads) {
      uint32_t rec[kRec];
      get_record<kRec>(o_rec + x * kRec, rec);
      put_trace<MT, EXT>(tr, row0 + x, mt_, rec);
    }
    if (tq) stage_out(words(tr.q_real + row0 * n), words(w_q), rt * n, lane);
    if (tm) stage_out(words(tr.mu_hat + row0 * n), words(w_mu), rt * n, lane);
"""


def _edits(*pairs):
    """An edit of the source made of text replacements, each of text that
    is found exactly once (else the edit leaves the source as it was, and
    variant_sources refuses it)."""
    def edit(src: str) -> str:
        out = src
        for old, new in pairs:
            if out.count(old) != 1:
                return src
            out = out.replace(old, new)
        return out
    return edit


SIM_VARIANTS = [
    ("rings ring-major ([n][cap], as ported: 30 lanes on one bank at a refresh)",
     _edits(("auto ring = [&](int l, int i) { return l * rs + i; };",
             "auto ring = [&](int l, int i) { return i * cap + l; };"))),
    ("trace rows stored to device memory every round (not staged by tiles)",
     _edits(("put_record<kRec>(o_rec + r * kRec, rec);",
             "put_trace<MT, EXT>(tr, row0 + r, mt_, rec);"),
            ("reinterpret_cast<int*>(o_q + word_shift(tr.q_real + (tq ? row0 * n : 0)))",
             "tr.q_real + (tq ? row0 * n : 0)"),
            ("reinterpret_cast<float*>(o_mu + word_shift(tr.mu_hat + (tm ? row0 * n : 0)))",
             "tr.mu_hat + (tm ? row0 * n : 0)"),
            (_SIM_TILE_OUT, ""))),
    ("the round's warp syncs left out (right only while the warp stays converged)",
     lambda s: s.replace("        __syncwarp();  // every lane's reads before any lane's writes\n", "")
     .replace("      __syncwarp();  // the event's writes before the refresh and the rows read "
              "them\n", "")
     .replace("      __syncwarp();  // this round's accesses before the next round's\n", "")),
    ("launch bounds without a minimum of one block (ptxas caps registers and spills)",
     lambda s: s.replace("__launch_bounds__(kThreads, 1) sim_chain_kernel(",
                         "__launch_bounds__(kThreads) sim_chain_kernel(")),
    ("the probing policies tested last in a job's policy ladder",
     lambda s: s.replace("              if (two_probes) {", "              if (false) {")
     .replace("""              } else {  // uniform
                sel = uw(b);
              }""", """              } else if (policy == UNIFORM) {
                sel = uw(b);
              } else {
                const int j1 = probe(0, 2), j2 = probe(1, 3);
                if (policy == PPOT_LL2) {
                  const float w1 = ((float)qv(j1) + 1.0f) / fmaxf(mu_view_now[j1], 1e-9f);
                  const float w2 = ((float)qv(j2) + 1.0f) / fmaxf(mu_view_now[j2], 1e-9f);
                  sel = w1 <= w2 ? j1 : j2;
                } else {
                  sel = qv(j1) <= qv(j2) ? j1 : j2;
                  if (policy == BANDIT && jj[mt_ + b] != 0) sel = uw(b);
                }
              }""")),
]
# What one warp alone on its scheduler pays, in cycles a step of 256 (the
# chain kernel's regime): a dependent f32 add, a dependent shared load, a
# shared load with an add (broadcast, a word a lane), a shared store, a
# 16-byte shared store, a shared load feeding a select, and ALU work ending
# in a branch on data.
WARP_PROBE_SRC = r"""
#include <cuda_runtime.h>
__global__ void warp_probe_kernel(unsigned long long* out, const float* buf, const int* nxt) {
  __shared__ __align__(16) float s[4096];
  __shared__ int si[1024];
  const int lane = threadIdx.x;
  for (int i = lane; i < 1024; i += 32) { s[i] = buf[i]; si[i] = nxt[i]; }
  __syncwarp();
  float a = buf[lane];
  int p = si[lane & 7], q = p, x = p;
  float b = 0.0f, c = 0.0f;
  long long t[9];
  t[0] = clock64();
  for (int i = 0; i < 256; ++i) a = a + 1.0f;
  t[1] = clock64();
  for (int i = 0; i < 256; ++i) p = si[p];
  t[2] = clock64();
#pragma unroll 8
  for (int i = 0; i < 256; ++i) b = b + s[i];
  t[3] = clock64();
#pragma unroll 8
  for (int i = 0; i < 256; ++i) c = c + s[(i * 32 + lane) & 1023];
  t[4] = clock64();
#pragma unroll 16
  for (int i = 0; i < 256; ++i) s[((i * 32) & 4064) + lane] = a + i;
  t[5] = clock64();
#pragma unroll 16
  for (int i = 0; i < 256; ++i)
    reinterpret_cast<float4*>(s)[(i * 2) & 1023] = make_float4(a, a + i, a, a);
  t[6] = clock64();
  for (int i = 0; i < 256; ++i) { const int v = si[q & 1023]; q += v > 3 ? 3 : 1; }
  t[7] = clock64();
  for (int i = 0; i < 256; ++i) { x = x * 3 + 1; if (x & 4) x ^= 0x55; }
  t[8] = clock64();
  if (lane == 0)
    for (int k = 0; k < 8; ++k) out[k] = t[k + 1] - t[k];
  if (a + b + c + p + q + x + s[lane] == 1234.5f) out[8] = 1;
}
extern "C" int warp_probe(unsigned long long* out, const float* buf, const int* nxt) {
  warp_probe_kernel<<<1, 32>>>(out, buf, nxt);
  return (int)cudaGetLastError();
}
extern "C" const char* warp_probe_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
"""
WARP_PROBE_STEPS = ("dependent f32 add", "dependent shared load", "shared load + add, broadcast",
                    "shared load + add, a word a lane", "shared store, a word a lane",
                    "16-byte shared store", "shared load feeding a select",
                    "ALU work and a branch on data")
_CLOCK_BEGIN, _CLOCK_END = "// -- per-phase clock: begin\n", "// -- per-phase clock: end\n"
# the per-phase clock's marks in the chain kernel as it was ported (before
# its redesign): (text, text with the marks), each found once
PARENT_SIM_MARKS = [
    ("  const int c = blockIdx.x, tid = threadIdx.x;\n",
     "  const int c = blockIdx.x, tid = threadIdx.x;\n  CLK_BEGIN();\n"),
    ("  const float nu_den = fmaxf(nu_max, 1e-30f);\n  __syncthreads();\n",
     "  const float nu_den = fmaxf(nu_max, 1e-30f);\n  __syncthreads();\n  CLK(CK_SETUP);\n"),
    ("      const float* mu_now = sched + (size_t)phase * n;\n",
     "      const float* mu_now = sched + (size_t)phase * n;\n      CLK(CK_HEAD);\n"),
    ("      for (int b = 0; b < mt; ++b) tw[b] = tt[b] = -1;\n",
     "      for (int b = 0; b < mt; ++b) tw[b] = tt[b] = -1;\n      CLK(CK_TRACE);\n"),
    ("          build_views(mu_view, n, use_table, !use_table, p, prob, alias, stack, cdf);\n",
     "          CLK(CK_ARRIVAL);\n"
     "          build_views(mu_view, n, use_table, !use_table, p, prob, alias, stack, cdf);\n"
     "          CLK(CK_REBUILD);\n          CLK_COUNT(CN_REBUILDS);\n"),
    ("          build_views(mu_now, n, false, true, p, prob, alias, stack, hcdf);\n",
     "          CLK(CK_ARRIVAL);\n"
     "          build_views(mu_now, n, false, true, p, prob, alias, stack, hcdf);\n"
     "          CLK(CK_REBUILD);\n          CLK_COUNT(CN_REBUILDS);\n"),
    ("        for (int b = 0; b < nt && b < mt; ++b) q_real[w[b]] += 1;\n      } else if (ev <= n) {",
     "        for (int b = 0; b < nt && b < mt; ++b) q_real[w[b]] += 1;\n"
     "        CLK(CK_ARRIVAL);\n        CLK_COUNT(CN_ARRIVALS);\n      } else if (ev <= n) {"),
    ("          code = EV_FAKE_DONE;\n        }\n      } else {",
     "          code = EV_FAKE_DONE;\n        }\n"
     "        CLK(CK_SERVICE);\n        CLK_COUNT(CN_SERVICES);\n      } else {"),
    ("          code = EV_FAKE_DISPATCH;\n        }\n      }\n",
     "          code = EV_FAKE_DISPATCH;\n        }\n"
     "        CLK(CK_FAKE);\n        CLK_COUNT(CN_FAKES);\n      }\n"),
    ("      s_lam = lam_hat;\n    }\n    __syncthreads();\n",
     "      s_lam = lam_hat;\n      CLK(CK_TRACE);\n    }\n    __syncthreads();\n"
     "    CLK(CK_BARRIER);\n"),
    ("      if (tid == 0) view_stale = true;\n      __syncthreads();\n",
     "      if (tid == 0) view_stale = true;\n      CLK(CK_REFRESH);\n"
     "      CLK_COUNT(CN_REFRESHES);\n      __syncthreads();\n      CLK(CK_BARRIER);\n"),
    ("tr.mu_hat[row * n + i] = mu_hat[i];\n    __syncthreads();\n  }\n",
     "tr.mu_hat[row * n + i] = mu_hat[i];\n    CLK(CK_TRACE);\n    __syncthreads();\n"
     "    CLK(CK_BARRIER);\n    CLK_COUNT(CN_ROUNDS);\n  }\n"),
    ("    fin.arr_count[c] = arr_count;\n  }\n}\n",
     "    fin.arr_count[c] = arr_count;\n  }\n  CLK(CK_SETUP);\n  CLK_END(c);\n}\n"),
]


def clocked_parent_source(parent_src: str) -> str:
    """The ported chain kernel with the current source's per-phase clock
    block and the marks above, so that its clocked build records the same
    phases (CK_TILE stays 0: it stages nothing)."""
    src = (ROOT / SIM_SRC).read_text()
    block = src[src.index(_CLOCK_BEGIN):src.index(_CLOCK_END) + len(_CLOCK_END)]
    out = parent_src.replace("#include <math.h>\n", "#include <math.h>\n\n" + block, 1)
    for old, new in PARENT_SIM_MARKS:
        if out.count(old) != 1:
            raise SystemExit(f"the parent's sim_chain source has moved on: {old!r}")
        out = out.replace(old, new)
    return out


def parent_sim_chain(torch, lib, args, shape, tiled: bool = False):
    """One launch of an earlier chain kernel's paper-mode C entry (its
    wrapper's call): as ported, or ``tiled`` as redesigned, with the ring
    stride and the tile's rounds, before the one entry of both modes:
    (final, trace)."""
    from repro_torch.kernels.sim_chain import kernel as SK
    from repro_torch.kernels.sim_chain import ref as SR

    conf_i, conf_f, sched, mu0, cols = args
    n, mt, cap, S = shape["n"], shape["mt"], shape["ring_cap"], shape["arrival_window"]
    tq, tm = shape["trace_queues"], shape["trace_mu"]
    C, T = cols["dt"].shape
    dev = cols["dt"].device
    final = {k: torch.zeros((C,) + sh, dtype=dt, device=dev)
             for k, (dt, sh) in SR.final_shapes(n, cap, S).items()}
    trace = {k: torch.zeros((C,) + sh, dtype=dt, device=dev)
             for k, (dt, sh) in SR.trace_shapes(T, n, mt, tq, tm).items()}
    order = ("code", "worker", "n_tasks", "task_workers", "task_targets", "frontend",
             "view_gap", "sync_age", "now", "lam_hat", "killed_fake", "q_real", "mu_hat")
    ins = (conf_i, conf_f, sched, mu0, *(cols[k] for k in SK.COLS))
    J = cols["j"].shape[2]
    tiling = ()
    if tiled:
        kw = dict(J=J, trace_queues=tq, trace_mu=tm)
        rs = SK.ring_stride(n, mt, cap, S, **kw)
        tiling = (rs, SK.tile_rounds(T, n, mt, cap, S, stride=rs, **kw))
    err = lib.load().sim_chain(*(t.data_ptr() for t in ins), C, T, n, mt, J, sched.shape[1], S,
                               cap, *tiling, int(tq), int(tm),
                               *(trace[k].data_ptr() for k in order),
                               *(v.data_ptr() for v in final.values()),
                               torch.cuda.current_stream().cuda_stream)
    lib.raise_on(err, "parent sim_chain")
    return final, trace


def warp_costs(torch, lib) -> dict:
    """WARP_PROBE_SRC's steps on one warp: cycles a step (median of 3)."""
    dev = torch.device("cuda")
    out = torch.zeros(9, dtype=torch.int64, device=dev)
    buf = torch.rand(1024, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    nxt = torch.randint(0, 1024, (1024,), dtype=torch.int32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    runs = []
    for _ in range(3):
        lib.raise_on(lib.load().warp_probe(out.data_ptr(), buf.data_ptr(), nxt.data_ptr()),
                     "warp_probe")
        torch.cuda.synchronize()
        runs.append([v / 256 for v in out[:8].tolist()])
    costs = {name: statistics.median(r[k] for r in runs)
             for k, name in enumerate(WARP_PROBE_STEPS)}
    print("[sim warp costs] cycles a step, one warp: "
          + ", ".join(f"{k} {v:.2f}" for k, v in costs.items()), flush=True)
    return costs


def time_sim(torch, libs, clocked, parent, median_ms) -> dict:
    """The chain kernel at chip_smoke.py's split runs (Fig. 8's static
    Rosella run, Fig. 10a's known-speed PPoT run) and its kernels-line case
    (Fig. 8's run cut to SIM_LINE_ROUNDS), one chain a launch, and
    at Fig. 9's ten chains in one launch (jobs of 1-4 tasks: the kernel's
    MT = kMaxMt body): the current source, each variant in turns with it
    (current, variant, variant, current) and, with a parent, the ported
    kernel the same way (parent, current, current, parent), every output
    held equal to the current kernel's bit for bit; and the per-phase split
    of the launch's slowest chain for the current kernel, each variant and
    the parent (their clocked builds, ``clocked`` in the order of
    ``libs``). Then the environment and fleet program on Fig. 8's run (in
    turns with the paper program) and on [sim fleet]'s six chains, each
    with its split."""
    import dataclasses

    import chip_smoke as CS
    from repro_torch.configs import rosella_sim as RS
    from repro_torch.core import simulator as tsim
    from repro_torch.kernels.sim_chain import kernel as SK

    dev = torch.device("cuda")
    out = {}
    variants = [(name, lib) for name, lib in libs[1:]]

    def slowest(recs):
        return max((CS.sim_split(r) for r in recs), key=lambda x: x["cycles_per_round"])

    figs = CS.sim_figures(RS, dev)
    cases = {label: [run] for label, run in CS.sim_split_runs(figs).items()}
    cases["fig9 batch"] = [run for _, run, _ in figs["fig9"]]
    # chip_smoke.py's kernels-line case: Fig. 8's run cut to SIM_LINE_ROUNDS
    c8, p8, k8 = cases["fig8 static/rosella"][0]
    cases[f"fig8 static/rosella, {CS.SIM_LINE_ROUNDS} rounds"] = [
        (dataclasses.replace(c8, rounds=CS.SIM_LINE_ROUNDS), p8, k8)]
    for label, runs in cases.items():
        cfg = runs[0][0]
        args, shape = tsim.chain_inputs(runs, [tsim.draw_rounds(c, p, k, dev)
                                               for c, p, k in runs], dev)
        C = args[4]["dt"].shape[0]

        SK.sim_chain(*args, **shape)  # the wrapper's checks, once

        def current(lib=None):  # the launch alone: nothing waits for the stream
            return SK.launch_only(*args, **shape, lib=lib)

        want = current()

        def same(got) -> bool:
            return all(torch.equal(g, w) for part in (0, 1) for g, w in
                       zip(got[part].values(), want[part].values()))

        # the launches alone, queued behind the sleep: no host work between
        # a pair's events; a short launch gets more reps
        reps = 3 if cfg.rounds > CS.SIM_LINE_ROUNDS else CS.SIM_LINE_REPS
        row = {"rounds": cfg.rounds, "current": dict(ms=median_ms(current, reps))}
        others = [(name, lambda lb=lib: current(lb)) for name, lib in variants]
        if parent is not None:
            others.append(("parent", lambda: current(parent["plain"]) if parent["entry"] == "one"
                           else parent_sim_chain(torch, parent["plain"], args, shape,
                                                 parent["entry"] == "tiled")))
        for name, fn in others:
            turns = [median_ms(f, reps) for f in (fn, current, current, fn)]
            row[name] = dict(ms=statistics.mean((turns[0], turns[3])),
                             current_same_call_ms=statistics.mean(turns[1:3]),
                             equal=same(fn()))
        for (name, _), lib in zip(libs, clocked):
            *_, recs = SK.clock_split(*args, **shape, lib=lib)
            row[name]["split"] = slowest(recs)
        if parent is not None and parent["entry"] == "one":
            *_, recs = SK.clock_split(*args, **shape, lib=parent["clocked"])
            row["parent"]["split"] = slowest(recs)
        elif parent is not None:
            parent_sim_chain(torch, parent["clocked"], args, shape, parent["entry"] == "tiled")
            row["parent"]["split"] = slowest(SK.read_clocks(parent["clocked"], C))
        out[label] = row
        for name, r in row.items():
            if name == "rounds":
                continue
            print(f"[sim {label}] {name}: {r['ms']:.6f} ms for {len(runs)} chain(s) of "
                  f"{cfg.rounds} rounds"
                  + (f" (current in the same turns {r['current_same_call_ms']:.6f} ms, "
                     f"equal to the current kernel bit for bit: {r['equal']})"
                     if "current_same_call_ms" in r else "")
                  + (f"; split: {CS.sim_split_text(r['split'])}" if "split" in r else ""),
                  flush=True)
    # the environment and fleet program (the EXT instances):
    # Fig. 8's run on it (the paper's chain, the same trace bit for bit) in
    # turns with the paper program, and [sim fleet]'s six chains; each split
    # by phase through the current source's clocked build (in EXT the
    # "rebuild" phase is the round's head after the clock: membership,
    # crash, sync and the view's build)
    fig8 = cases["fig8 static/rosella"]
    for label, runs, ext in (("fig8 static/rosella on the EXT program", fig8, True),
                             ("sim fleet sweep", CS.sim_fleet_runs(RS, dev), None)):
        draws = [tsim.draw_rounds(c, p, k, dev) for c, p, k in runs]
        args, shape = tsim.chain_inputs(runs, draws, dev, ext=ext)
        fn = lambda a=args, sh=shape: SK.sim_chain(*a, **sh)  # noqa: E731
        row = {"rounds": runs[0][0].rounds}
        if ext:
            pargs, _ = tsim.chain_inputs(runs, draws, dev)
            paper = lambda: SK.sim_chain(*pargs, **shape)  # noqa: E731
            same = all(torch.equal(g, w) for g, w in zip(fn()[1].values(),
                                                         paper()[1].values()))
            turns = [median_ms(f, 3) for f in (fn, paper, paper, fn)]
            row["current"] = dict(ms=statistics.mean((turns[0], turns[3])),
                                  paper_same_call_ms=statistics.mean(turns[1:3]), equal=same)
        else:
            row["current"] = dict(ms=median_ms(fn, 3))
        conf_i, conf_f, sched, mu0, cols, xins = args
        names = {**SK.COLS, **SK.XCOLS}
        ins = (conf_i, conf_f, sched, mu0, *(cols[k] for k in names))
        C, T = cols["dt"].shape
        SK._launch(clocked[0], ins, dev, C, T, shape["n"], shape["mt"], cols["j"].shape[2],
                   sched.shape[1], shape["ring_cap"], shape["arrival_window"],
                   shape["trace_queues"], shape["trace_mu"], xins)
        row["current"]["split"] = slowest(SK.read_clocks(clocked[0], C))
        out[label] = row
        r = row["current"]
        print(f"[sim {label}] current: {r['ms']:.6f} ms for {len(runs)} chain(s) of "
              f"{row['rounds']} rounds"
              + (f" (the paper program in the same turns {r['paper_same_call_ms']:.6f} ms, "
                 f"the same trace bit for bit: {r['equal']})" if ext else "")
              + f"; split: {CS.sim_split_text(r['split'])}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="flash,ssd,ppot,chain,sim",
                    help="comma-separated sources to time: flash, ssd, ppot, chain, sim")
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit")
    ap.add_argument("--out", type=Path, help="write the readings as JSON")
    args = ap.parse_args()
    kinds = set(args.kernels.split(","))
    known = {"flash", "ssd", "ppot", "chain", "sim"}
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
    from repro_torch.kernels.sim_chain import build as simbuild
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
               "chain": (POOL_SRC, CHAIN_VARIANTS, cbuild, "pool_chain_error_string"),
               "sim": (SIM_SRC, SIM_VARIANTS, simbuild, "sim_chain_error_string")}
    libs, parent = {}, {}
    for kind in sorted(kinds):
        path, variants, bld, err = sources[kind]
        own = bld.LIBRARY.flags[len(_nvcc.FLAGS):]
        libs[kind] = [("current", bld.LIBRARY)] + [
            (n, _nvcc.CudaLibrary(p, bld._SIGNATURES, err, extra_flags=own))
            for n, p in variant_sources(path, variants, tmp)]
        if args.parent and kind == "sim":
            parent_src = (args.parent / path).read_text()
            # its entry: today's one entry of both modes, the redesigned
            # kernel's paper-mode entry (tiled), or the ported one's
            entry = ("ported" if _CLOCK_BEGIN not in parent_src
                     else "one" if "conf_x != nullptr" in parent_src else "tiled")
            if entry == "ported":
                clocked = tmp / "sim_chain_parent_clocked.cu"
                clocked.write_text(clocked_parent_source(parent_src))
                sigs = PARENT_SIGNATURES[kind]
            else:
                clocked = args.parent / path
                sigs = (simbuild._SIGNATURES if entry == "one"
                        else PARENT_SIGNATURES["sim_tiled"])
            parent[kind] = {"plain": _nvcc.CudaLibrary(args.parent / path, sigs, err, own),
                            "clocked": _nvcc.CudaLibrary(
                                clocked, {**sigs, **simbuild.CLOCK_SIGNATURE}, err,
                                simbuild.CLOCKED.flags[len(_nvcc.FLAGS):]),
                            "entry": entry}
        elif args.parent:
            parent[kind] = _nvcc.CudaLibrary(args.parent / path, PARENT_SIGNATURES[kind], err)
    probe = None
    if "sim" in kinds:
        (tmp / "warp_probe.cu").write_text(WARP_PROBE_SRC)
        probe = _nvcc.CudaLibrary(tmp / "warp_probe.cu", {"warp_probe": (_P,) * 3},
                                  "warp_probe_error_string")
    # the chain kernel's variants also in clocked builds, for their splits
    sim_clocked = [_nvcc.CudaLibrary(lib.src, {**simbuild._SIGNATURES,
                                               **simbuild.CLOCK_SIGNATURE},
                                     "sim_chain_error_string",
                                     simbuild.CLOCKED.flags[len(_nvcc.FLAGS):])
                   for _, lib in libs.get("sim", [])]
    extra = sim_clocked + ([probe] if probe else [])
    _nvcc.build_all(*(lib for row in libs.values() for _, lib in row), *extra,
                    *(lib for p in parent.values()
                      for lib in ((p["plain"], p["clocked"]) if isinstance(p, dict) else (p,))))

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
    if "sim" in kinds:
        readings["sim_chain"] = time_sim(torch, libs["sim"], sim_clocked, parent.get("sim"),
                                         median_ms)
        readings["sim_chain"]["warp_costs"] = warp_costs(torch, probe)

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
