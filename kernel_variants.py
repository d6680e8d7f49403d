#!/usr/bin/env python3
"""Times the port's flash-attention (K4) and SSD-scan (K5) kernels against
variants of their own sources on one CUDA card, at the shapes of
chip_smoke.py's [times] phase.

Each variant is the current source with one textual edit (a design choice
undone, or a part of the work left out to see what it costs: those are
marked "diagnostic" and compute a wrong result). With ``--parent DIR``,
the kernels of another checkout of this repository (``git archive`` of an
earlier commit unpacked into DIR) are built and timed on the same inputs,
in turns with the current ones (parent, current, current, parent).

    python3 kernel_variants.py [--parent DIR] [--out FILE.json]

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

# the C entry points of the kernels before their redesign, for --parent
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {
    "flash": {"flash_attention_fwd": (_P,) * 4 + (_I,) * 6 + (ctypes.c_float, _I, _I, _I, _P)},
    "ssd": {"ssd_scan": (_P,) * 7 + (_I,) * 9 + (_P,)},
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit")
    ap.add_argument("--out", type=Path, help="write the readings as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.flash_attention import build as fbuild
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssd_scan import build as sbuild
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="kernel_variants_", dir=ROOT / "build"
                                if (ROOT / "build").is_dir() else None))
    k4 = [("current", fbuild.LIBRARY)] + [
        (n, _nvcc.CudaLibrary(p, fbuild._SIGNATURES, "flash_error_string"))
        for n, p in variant_sources(K4_SRC, K4_VARIANTS, tmp)]
    k5 = [("current", sbuild.LIBRARY)] + [
        (n, _nvcc.CudaLibrary(p, sbuild._SIGNATURES, "ssd_error_string"))
        for n, p in variant_sources(K5_SRC, K5_VARIANTS, tmp)]
    parent = {}
    if args.parent:
        parent = {
            "flash": _nvcc.CudaLibrary(args.parent / K4_SRC, PARENT_SIGNATURES["flash"],
                                       "flash_error_string"),
            "ssd": _nvcc.CudaLibrary(args.parent / K5_SRC, PARENT_SIGNATURES["ssd"],
                                     "ssd_error_string")}
    _nvcc.build_all(*(lib for _, lib in k4 + k5), *parent.values())

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
    readings = {"card": card, "flash_attention_fwd": {}, "ssd_scan": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)

    # K4: q [B, S, H, D] in the model's layout, causal (hymba: window 1024)
    for label, B, S, H, Hkv, window in (("main", 4, 4096, 15, 5, 0), ("small", 1, 2048, 15, 5, 0),
                                        ("hymba", 2, 4096, 25, 5, 1024)):
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

    for label, B, S in (("main", 4, 4096), ("small", 1, 2048)):
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
