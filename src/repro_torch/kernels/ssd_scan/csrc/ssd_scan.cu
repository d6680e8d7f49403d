// Mamba2 SSD chunked scan for sm_90a. Replaces ssd_scan
// (src/repro/kernels/ssd_scan/kernel.py, _kernel): per chunk of Q steps,
// with cum the in-chunk cumulative sum of dt * A,
//   y  = (C B^T . exp(cum_q - cum_k)[q >= k]) (dt x) + (C . exp(cum)) h_in
//   h' = exp(cum_end) h_in + sum_k exp(cum_end - cum_k) B_k (x) (dt_k x_k)
// with the [N, P] state carried from chunk to chunk and returned at the
// end. All arithmetic is f32 or as exact as f32 (the TPU kernel's
// preferred_element_type).
//
// Bound on an H100 at the main path's shape (mamba2-370m prefill, B = 4,
// S = 4096, H = 32, P = 64, N = 128, x bf16): x 67.1 MB, dt 2.1 MB, B and
// C 8.4 MB each read once, y 134.2 MB and h 4.2 MB written once: 224 MB,
// 0.067 ms at 3.35 TB/s; 2.18e10 FLOPs with C B^T counted once per (batch
// row, chunk) on the causal triangle, 0.325 ms on the FMA units (67
// TFLOP/s) or 0.132 ms on the tensor cores at the 3xTF32 rate (495 / 3
// TFLOP/s). Operations bound it.
//
// Design. The TPU grid walks the chunks in order with the state in VMEM;
// a CUDA block that did the same (the first port) had one block per
// (batch, head), a single wave at B = 4 and a quarter of one at B = 1.
// Every chunk is independent except for a short carry, so the scan runs
// as four grids (ref.ssd_chunk_parallel is the same decomposition in
// torch):
//   0. cb:    per (group, chunk): CB = C B^T on the causal triangle, once
//             for all the rows that share B and C (Mamba2's one group: the
//             32 heads of a batch row), into a [G, nc, Qp, Qp] scratch, on
//             the FMA units: on the tensor cores (exact products: B and C
//             are bf16 values in the model) the f32 accumulation of these
//             cancelling 128-term sums moved rows of y by up to 2.7e-4 of
//             their scale, against 6.2e-5 in f32 FMA; the grid is 3% of
//             the scan's time (PERF.md).
//   1. intra: per (chunk, group, 2 to 8 rows of the group): the in-chunk
//             cumulative sum (one warp, shuffles); y = (CB . exp(cum_q -
//             cum_k) dt_k) x on the triangle; the chunk's own state
//             s_c = (B . exp(cum_end - cum) dt)^T x into a [BH, nc, N, P]
//             f32 scratch, and cum into a [BH, S] scratch.
//   2. carry: per 4 state elements (a float4; 1 where N * P is odd), the
//             chunks in order: h_in,c = h; h = exp(cum_end,c) h + s_c,
//             h_in written over s_c; the final h. Elementwise,
//             memory-bound, 8 chunk states loaded ahead.
//   3. inter: per (chunk > 0, group, rows): y += exp(cum_q) (C h_in).
// Grids 1 and 3 give each block the most rows (8, 4, 2) that still leave
// two blocks per SM: 512 blocks of 8 rows at the main shape, 256 of 2 at
// B = 1, S = 2048; 2 resident per SM. Their products are 32 x 32 warp tiles of
// mma.sync m16n8k8 TF32 with both operands split into a TF32 high part
// and residual (3 products, "3xTF32", near-f32 accuracy); x in bf16 is
// exact in TF32, so its residual is 0 and its products take 2. Scores
// and decays are formed on the fly from the shared CB and each row's cum.
// Loads in flight: B, C, CB and h_in come by cp.async; each row's x is
// loaded into registers while the previous row computes, grid 3 loads y
// before its product, and the two resident blocks cover each other's
// loads.
//
// B and C are shared by the rows of a group: row bh reads B/C row
// bh / (BH / G), so the JAX wrapper's broadcast to [BH, S, N] is never
// made. x, dt and y are addressed as [BH / heads, S, heads, ...]: heads = 1
// is the reference's [BH, S, ...] layout, heads = H the model's
// [B, S, H, ...], read and written in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 (rows) x 2 (columns) of 32 x 32 tiles
constexpr int kMaxQ = 128, kMaxN = 128, kMaxP = 64;
constexpr int kMaxRows = 8;  // rows of a group that one block of grids 1 and 3 takes, at most
constexpr int kCarryAhead = 8;    // chunk states grid 2 loads ahead

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory row strides, fixed at the largest tiles so that every
// fragment load is a base address plus a constant: 4 floats past a row
// for operands read along rows (g * ld + t hits 32 banks), 8 for those
// read along columns (t * ld + g).
constexpr int kLdQ = kMaxQ + 4;  // CB [q][k]
constexpr int kLdN = kMaxN + 4;  // C [q][n] and, in grid 0, B [k][n]
constexpr int kLdB = kMaxN + 8;  // B [k][n] read as the state product's A (n, k)
constexpr int kLdP = kMaxP + 8;  // x [k][p] and h_in [n][p]

// Padded extents: the warp tiles are 32 x 32, so Q, N and P round up to 32.
struct Dims {
  int Q, N, P, Qp, Np, Pp;
  __host__ __device__ Dims(int q, int n, int p)
      : Q(q), N(n), P(p), Qp(round_up(q, 32)), Np(round_up(n, 32)), Pp(round_up(p, 32)) {}
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// rows x cols f32 from global (row stride lds) into shared memory (row
// stride ldd), zero-filled out to rows_p x cols_p; cp.async, 16 bytes at a
// time where rows allow it. The caller waits and syncs.
__device__ void load_tile(float* dst, int ldd, const float* src, long long lds, int rows,
                          int cols, int rows_p, int cols_p) {
  const bool vec = cols % 4 == 0 && lds % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    const int c4 = cols_p / 4;
    for (int i = threadIdx.x; i < rows_p * c4; i += kThreads) {
      const int r = i / c4, c = (i - r * c4) * 4;
      float* d = dst + r * ldd + c;
      if (r < rows && c < cols) cp_async16(d, src + r * lds + c);
      else *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < rows_p * cols_p; i += kThreads) {
      const int r = i / cols_p, c = i - r * cols_p;
      float* d = dst + r * ldd + c;
      if (r < rows && c < cols) cp_async4(d, src + r * lds + c);
      else *d = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 warp tiles
// ---------------------------------------------------------------------------

// x = hi + lo: hi is x with the 13 mantissa bits TF32 drops cleared (exact
// in TF32), lo = x - hi is exact in f32 and the mma reads its top 11
// bits, so hi * b + lo * b keeps ~22 bits of each product.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

using Acc = float[2][4][4];  // a warp's 32 x 32 tile: [m16 tile][n8 tile][fragment]

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// The B fragments of k-step k0: b(k, n) at B[k * LBK + n * LBN], split
// unless B_EXACT (B already TF32).
template <bool B_EXACT, int LBK, int LBN>
__device__ __forceinline__ void b_frags(const float* pb, int k0, uint32_t (&bh)[4][2],
                                        uint32_t (&bl)[4][2]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float v = pb[(k0 + 4 * j) * LBK + nt * 8 * LBN];
      if (B_EXACT) bh[nt][j] = __float_as_uint(v);
      else split(v, bh[nt][j], bl[nt][j]);
    }
}

// acc += a_hi b_hi + a_lo b_hi + a_hi b_lo (the last dropped if B_EXACT)
template <bool B_EXACT>
__device__ __forceinline__ void mma_3x(Acc& acc, const uint32_t (&ah)[2][4],
                                       const uint32_t (&al)[2][4], const uint32_t (&bh)[4][2],
                                       const uint32_t (&bl)[4][2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mma_tf32(acc[mt][nt], al[mt], bh[nt]);
      if (!B_EXACT) mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
      mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
    }
}

// acc += A B over k in [0, kend) (a multiple of 8) for one warp's 32 x 32
// tile: A(m, k) at A[m * LAM + k * LAK] (times scale[k] if SCALED), B(k, n)
// at B[k * LBK + n * LBN], both in shared memory.
template <bool B_EXACT, bool SCALED, int LAM, int LAK, int LBK, int LBN>
__device__ __forceinline__ void warp_mma(Acc& acc, int kend, const float* A, const float* B,
                                         const float* scale = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* pa = A + g * LAM + t * LAK;
  const float* pb = B + t * LBK + g * LBN;
#pragma unroll 2
  for (int k0 = 0; k0 < kend; k0 += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
    const float s0 = SCALED ? scale[k0 + t] : 1.f, s1 = SCALED ? scale[k0 + t + 4] : 1.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // (row, col) = (g + 8 (i & 1), t + 4 (i >> 1))
        const float v = pa[(mt * 16 + (i & 1) * 8) * LAM + (k0 + (i >> 1) * 4) * LAK];
        split(SCALED ? v * (i >> 1 ? s1 : s0) : v, ah[mt][i], al[mt][i]);
      }
    b_frags<B_EXACT, LBK, LBN>(pb, k0, bh, bl);
    mma_3x<B_EXACT>(acc, ah, al, bh, bl);
  }
}

// acc += A B over k in [0, kend) as warp_mma lays it out, on the FMA units
// in f32: each thread computes its own fragment's elements.
template <bool SCALED, int LAM, int LAK, int LBK, int LBN>
__device__ __forceinline__ void warp_fma(Acc& acc, int kend, const float* A, const float* B,
                                         const float* scale = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* pa = A + g * LAM;
  const float* pb = B + 2 * t * LBN;
#pragma unroll 2
  for (int k = 0; k < kend; ++k) {
    float a[2][2], b[4][2];
    const float sk = SCALED ? scale[k] : 1.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) a[mt][r] = pa[(mt * 16 + 8 * r) * LAM + k * LAK] * sk;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) b[nt][c] = pb[k * LBK + (nt * 8 + c) * LBN];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nt][e] = fmaf(a[mt][e >> 1], b[nt][e & 1], acc[mt][nt][e]);
  }
}

// Calls f(m, n, element, mt, nt, e) for each element acc[mt][nt][e] of a
// warp's 32 x 32 tile, at row m and column n of the tile.
template <typename F>
__device__ __forceinline__ void for_each(Acc& acc, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(mt * 16 + g + (e >> 1) * 8, nt * 8 + 2 * t + (e & 1), acc[mt][nt][e], mt, nt, e);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// grid 0: CB = C B^T on the causal triangle, per (group, chunk)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) ssd_scan_cb(const float* __restrict__ Bm,
                                                      const float* __restrict__ Cm,
                                                      float* __restrict__ cb, int S, int N,
                                                      int Q) {
  extern __shared__ float smem[];
  const Dims d(Q, N, 1);
  float* Cs = smem;
  float* Bs = Cs + d.Qp * kLdN;
  const int c = blockIdx.x, g = blockIdx.y, nc = gridDim.x;
  const size_t row0 = (size_t)g * S + (size_t)c * Q;
  load_tile(Cs, kLdN, Cm + row0 * N, N, Q, N, d.Qp, d.Np);
  load_tile(Bs, kLdN, Bm + row0 * N, N, Q, N, d.Qp, d.Np);
  cp_async_wait_all();
  __syncthreads();

  float* out = cb + ((size_t)g * nc + c) * d.Qp * d.Qp;
  const int nt = d.Qp / 32, warp = threadIdx.x >> 5;
  for (int tile = warp; tile < nt * nt; tile += kThreads / 32) {
    const int tm = tile / nt, tn = tile % nt;
    Acc acc;
    zero(acc);
    if (tn <= tm)  // tiles above the diagonal stay 0
      warp_fma<false, kLdN, 1, 1, kLdN>(acc, N, Cs + tm * 32 * kLdN, Bs + tn * 32 * kLdN);
    for_each(acc, [&](int m, int n, float& v, int, int, int) {
      const int q = tm * 32 + m, k = tn * 32 + n;
      out[q * d.Qp + k] = k <= q && q < Q ? v : 0.f;
    });
  }
}

// ---------------------------------------------------------------------------
// grid 1: y = (CB . decay . dt) x and the chunk states, per (chunk, rows)
// ---------------------------------------------------------------------------

// One row's x chunk [Q, P], staged through registers so that the next
// row's loads are in flight while this one computes.
template <typename XT>
struct XChunk {
  static constexpr int VE = 16 / sizeof(XT);         // elements per 16-byte load
  static constexpr int REGS = kMaxQ * kMaxP / VE / kThreads;
  uint4 v[REGS];

  // rows [0, Q) x columns [0, P) of row bh's chunk c; x is
  // [BH / heads, S, heads, P], read 16 bytes at a time where P allows
  __device__ void load(const XT* x, int bh, int heads, int S, int c, const Dims& d) {
    const int b = bh / heads, hh = bh % heads, pv = d.Pp / VE;
#pragma unroll
    for (int r = 0; r < REGS; ++r) {
      const int i = threadIdx.x + r * kThreads, k = i / pv, p = (i - k * pv) * VE;
      v[r] = make_uint4(0u, 0u, 0u, 0u);
      if (k >= d.Q || p >= d.P) continue;
      const XT* row = x + (((size_t)b * S + (size_t)c * d.Q + k) * heads + hh) * d.P;
      if (d.P % VE == 0) {
        v[r] = *reinterpret_cast<const uint4*>(row + p);
      } else {  // columns past P repeat the last one; store() writes them as 0
        XT e[VE];
#pragma unroll
        for (int j = 0; j < VE; ++j) e[j] = row[min(p + j, d.P - 1)];
        memcpy(&v[r], e, sizeof(e));
      }
    }
  }
  // into shared memory as f32, [Qp][ld], zero outside [Q, P)
  __device__ void store(float* Xs, int ld, const Dims& d) const {
    const int pv = d.Pp / VE;
#pragma unroll
    for (int r = 0; r < REGS; ++r) {
      const int i = threadIdx.x + r * kThreads, k = i / pv, p = (i - k * pv) * VE;
      if (k >= d.Qp) continue;
      XT e[VE];
      memcpy(e, &v[r], sizeof(e));
#pragma unroll
      for (int j = 0; j < VE; ++j) Xs[k * ld + p + j] = p + j < d.P ? widen(e[j]) : 0.f;
    }
  }
};

// The in-chunk cumulative sum of dt * a over the first Q of dts into cum
// (one warp, each lane <= 4 steps, then a shuffle scan).
__device__ void chunk_cumsum(const float* dts, float a, int Q, float* cum) {
  const int lane = threadIdx.x & 31;
  const int per = (Q + 31) / 32;
  float loc[4];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = lane * per + e;
    if (e < per && k < Q) run += dts[k] * a;
    loc[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float prev = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) prev = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = lane * per + e;
    if (e < per && k < Q) cum[k] = prev + loc[e];
  }
}

template <typename XT>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_intra(const XT* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ cb, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ cum_out, int BH, int heads,
                 int G, int nA, int S, int P, int N, int Q, int rows) {
  extern __shared__ float smem[];
  const Dims d(Q, N, P);
  float* Ms = smem;  // CB [Qp][kLdQ] for the outputs, then B [Qp][kLdB] for the states
  float* Xs = Ms + d.Qp * kLdB;             // x [Qp][kLdP]
  float* dts = Xs + d.Qp * kLdP;       // [rows][Qp]
  float* cum = dts + rows * d.Qp;      // [rows][Qp]
  float* wk = cum + rows * d.Qp;       // [Qp]

  const int c = blockIdx.x, g = blockIdx.y, nc = gridDim.x;
  const int R = BH / G, r0 = g * R + blockIdx.z * rows;
  const int nrows = min(rows, g * R + R - r0);
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  constexpr bool kExactX = sizeof(XT) == 2;  // bf16 is exact in TF32

  // ---- outputs: CB resident, each row's x in turn ----
  load_tile(Ms, kLdQ, cb + ((size_t)g * nc + c) * d.Qp * d.Qp, d.Qp, d.Qp, d.Qp, d.Qp, d.Qp);
  XChunk<XT> xr;
  xr.load(x, r0, heads, S, c, d);
  for (int i = 0; i < nrows; ++i) {
    const int bh = r0 + i, b = bh / heads, hh = bh % heads;
    float* dti = dts + i * d.Qp;
    float* cumi = cum + i * d.Qp;
    for (int k = threadIdx.x; k < d.Qp; k += kThreads)
      dti[k] = k < Q ? dt[((size_t)b * S + (size_t)c * Q + k) * heads + hh] : 0.f;
    xr.store(Xs, kLdP, d);
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < nrows) xr.load(x, bh + 1, heads, S, c, d);  // in flight from here
    if (warp == 0) chunk_cumsum(dti, A[bh % nA], Q, cumi);
    __syncthreads();
    for (int k = threadIdx.x; k < Q; k += kThreads)
      cum_out[(size_t)bh * S + (size_t)c * Q + k] = cumi[k];

    // y[q, p] = sum_{k <= q} CB[q, k] exp(cum_q - cum_k) dt_k x[k, p]: the
    // scores are formed as A fragments, each thread's 4 rows' cum_q held
    if (wm * 32 < Q && wn * 32 < P) {
      const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, q0 = wm * 32;
      int qr[2][2];
      float cq[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qr[mt][j] = q0 + mt * 16 + 8 * j + g;
          cq[mt][j] = cumi[qr[mt][j]];
        }
      const float* pa = Ms + (q0 + g) * kLdQ + t;
      const float* pb = Xs + t * kLdP + wn * 32 + g;
      Acc acc;
      zero(acc);
      const int kend = min(round_up(Q, 8), q0 + 32);  // keys up to the tile's last row
#pragma unroll 2
      for (int k0 = 0; k0 < kend; k0 += 8) {
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
        const int kk[2] = {k0 + t, k0 + t + 4};
        const float ck[2] = {cumi[kk[0]], cumi[kk[1]]}, dk[2] = {dti[kk[0]], dti[kk[1]]};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // (row, col) = (g + 8 (i & 1), t + 4 (i >> 1))
            const int q = qr[mt][i & 1], j = i >> 1;
            const float v = pa[(mt * 16 + (i & 1) * 8) * kLdQ + k0 + 4 * j];
            split(kk[j] <= q && q < Q ? v * __expf(cq[mt][i & 1] - ck[j]) * dk[j] : 0.f,
                  ah[mt][i], al[mt][i]);
          }
        b_frags<kExactX, kLdP, 1>(pb, k0, bh, bl);
        mma_3x<kExactX>(acc, ah, al, bh, bl);
      }
      for_each(acc, [&](int m, int n, float& v, int, int, int) {
        const int q = q0 + m, p = wn * 32 + n;
        if (q < Q && p < P) y[(((size_t)b * S + (size_t)c * Q + q) * heads + hh) * P + p] = v;
      });
    }
    __syncthreads();  // Xs and dts are rewritten for the next row
  }

  // ---- states: B resident, each row's x again (now from L2) ----
  load_tile(Ms, kLdB, Bm + ((size_t)g * S + (size_t)c * Q) * N, N, Q, N, d.Qp, d.Np);
  xr.load(x, r0, heads, S, c, d);
  for (int i = 0; i < nrows; ++i) {
    const int bh = r0 + i;
    const float* dti = dts + i * d.Qp;
    const float* cumi = cum + i * d.Qp;
    xr.store(Xs, kLdP, d);
    const float cend = cumi[Q - 1];
    for (int k = threadIdx.x; k < d.Qp; k += kThreads)
      wk[k] = k < Q ? expf(cend - cumi[k]) * dti[k] : 0.f;
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < nrows) xr.load(x, bh + 1, heads, S, c, d);

    // s[n, p] = sum_k B[k, n] exp(cum_end - cum_k) dt_k x[k, p]
    if (wm * 32 < N && wn * 32 < P) {
      Acc acc;
      zero(acc);
      warp_mma<kExactX, true, 1, kLdB, kLdP, 1>(acc, round_up(Q, 8), Ms + wm * 32,
                                                Xs + wn * 32, wk);
      float* st = states + ((size_t)bh * nc + c) * N * P;
      for_each(acc, [&](int m, int n, float& v, int, int, int) {
        const int nn = wm * 32 + m, p = wn * 32 + n;
        if (nn < N && p < P) st[nn * P + p] = v;
      });
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// grid 2: the carry over the chunks, per state element
// ---------------------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_carry(float* __restrict__ states, const float* __restrict__ cum,
                   float* __restrict__ hout, int BH, int S, int NP, int Q) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (e >= (long long)BH * NP) return;  // V divides NP: a thread stays in one row
  const int nc = S / Q;
  const int bh = (int)(e / NP), r = (int)(e - (long long)bh * NP);
  float* st = states + (size_t)bh * nc * NP + r;
  const float* cend = cum + (size_t)bh * S + Q - 1;
  float h[V] = {};
  for (int c0 = 0; c0 < nc; c0 += kCarryAhead) {
    float s[kCarryAhead][V], dec[kCarryAhead];
#pragma unroll
    for (int i = 0; i < kCarryAhead; ++i)
      if (c0 + i < nc) {
        *reinterpret_cast<Vec*>(s[i]) = *reinterpret_cast<const Vec*>(st + (size_t)(c0 + i) * NP);
        dec[i] = expf(cend[(size_t)(c0 + i) * Q]);
      }
#pragma unroll
    for (int i = 0; i < kCarryAhead; ++i)
      if (c0 + i < nc) {
        // the state entering chunk c0 + i
        *reinterpret_cast<Vec*>(st + (size_t)(c0 + i) * NP) = *reinterpret_cast<Vec*>(h);
#pragma unroll
        for (int v = 0; v < V; ++v) h[v] = h[v] * dec[i] + s[i][v];
      }
  }
  *reinterpret_cast<Vec*>(hout + e) = *reinterpret_cast<Vec*>(h);
}

// ---------------------------------------------------------------------------
// grid 3: y += exp(cum_q) (C h_in), per (chunk > 0, rows)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_inter(const float* __restrict__ Cm, const float* __restrict__ states,
                 const float* __restrict__ cum, float* __restrict__ y, int BH, int heads,
                 int G, int S, int P, int N, int Q, int rows) {
  const int c = blockIdx.x, g = blockIdx.y, nc = gridDim.x;
  if (c == 0) return;  // the first chunk enters with h = 0
  extern __shared__ float smem[];
  const Dims d(Q, N, P);
  float* Cs = smem;                // C [Qp][kLdN]
  float* Hs = Cs + d.Qp * kLdN;    // h_in [Np][kLdP]
  float* ecum = Hs + d.Np * kLdP;  // exp(cum) [Qp]
  const int R = BH / G, r0 = g * R + blockIdx.z * rows;
  const int nrows = min(rows, g * R + R - r0);
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;

  load_tile(Cs, kLdN, Cm + ((size_t)g * S + (size_t)c * Q) * N, N, Q, N, d.Qp, d.Np);
  for (int i = 0; i < nrows; ++i) {
    const int bh = r0 + i, b = bh / heads, hh = bh % heads;
    load_tile(Hs, kLdP, states + ((size_t)bh * nc + c) * N * P, P, N, P, d.Np, d.Pp);
    for (int q = threadIdx.x; q < d.Qp; q += kThreads)
      ecum[q] = q < Q ? expf(cum[(size_t)bh * S + (size_t)c * Q + q]) : 0.f;
    cp_async_wait_all();
    __syncthreads();

    if (wm * 32 < Q && wn * 32 < P) {
      // this tile's y, loaded before the product so that its latency hides
      // under it
      float* yc = y + (((size_t)b * S + (size_t)c * Q) * heads + hh) * P;
      Acc acc, prev;
      zero(acc);
      for_each(prev, [&](int m, int n, float& v, int, int, int) {
        const int q = wm * 32 + m, p = wn * 32 + n;
        v = q < Q && p < P ? yc[(size_t)q * heads * P + p] : 0.f;
      });
      warp_mma<false, false, kLdN, 1, kLdP, 1>(acc, round_up(N, 8), Cs + wm * 32 * kLdN,
                                               Hs + wn * 32);
      for_each(acc, [&](int m, int n, float& v, int i, int j, int e) {
        const int q = wm * 32 + m, p = wn * 32 + n;
        if (q < Q && p < P) yc[(size_t)q * heads * P + p] = prev[i][j][e] + ecum[q] * v;
      });
    }
    __syncthreads();  // Hs and ecum are rewritten for the next row
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

size_t cb_smem(const Dims& d) { return sizeof(float) * 2 * d.Qp * kLdN; }
size_t intra_smem(const Dims& d, int rows) {  // kLdB > kLdQ: B's tile is the larger
  return sizeof(float) * (d.Qp * kLdB + d.Qp * kLdP + (2 * rows + 1) * d.Qp);
}

// Rows of a group per block of grids 1 and 3: the most (8, 4, 2) that still
// give two blocks per SM; fewer rows a block means more blocks, more loads
// of B, C and CB, and less reuse of them. Measured best at both ends of the
// main path's shapes (PERF.md): 8 at B = 4, S = 4096; 2 at B = 1, S = 2048.
int rows_per_block(int nc, int G, int R) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  int rows = kMaxRows;
  while (rows > 2 && (long long)nc * G * ((R + rows - 1) / rows) < 2LL * sms) rows /= 2;
  return rows;
}
size_t inter_smem(const Dims& d) {
  return sizeof(float) * (d.Qp * kLdN + d.Np * kLdP + d.Qp);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename XT>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* h, void* states, void* cum, void* cb, int BH, int heads, int G,
           int nA, int S, int P, int N, int Q, cudaStream_t stream) {
  static bool configured = false;
  const Dims most(kMaxQ, kMaxN, kMaxP);
  if (!configured) {
    cudaError_t err = allow_smem(ssd_scan_cb, cb_smem(most));
    if (err == cudaSuccess) err = allow_smem(ssd_scan_intra<XT>, intra_smem(most, kMaxRows));
    if (err == cudaSuccess) err = allow_smem(ssd_scan_inter, inter_smem(most));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const Dims d(Q, N, P);
  const int nc = S / Q, R = BH / G, rows = rows_per_block(nc, G, R);
  const dim3 grid(nc, G, (R + rows - 1) / rows);
  ssd_scan_cb<<<dim3(nc, G), kThreads, cb_smem(d), stream>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<float*>(cb), S,
      N, Q);
  ssd_scan_intra<XT><<<grid, kThreads, intra_smem(d, rows), stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(cb), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(cum), BH, heads, G, nA, S, P, N, Q,
      rows);
  const long long threads = (long long)BH * N * P / ((N * P) % 4 ? 1 : 4);
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if ((N * P) % 4)
    ssd_scan_carry<1><<<blocks, kThreads, 0, stream>>>(
        static_cast<float*>(states), static_cast<const float*>(cum), static_cast<float*>(h), BH,
        S, N * P, Q);
  else
    ssd_scan_carry<4><<<blocks, kThreads, 0, stream>>>(
        static_cast<float*>(states), static_cast<const float*>(cum), static_cast<float*>(h), BH,
        S, N * P, Q);
  ssd_scan_inter<<<grid, kThreads, inter_smem(d), stream>>>(
      static_cast<const float*>(Cm), static_cast<const float*>(states),
      static_cast<const float*>(cum), static_cast<float*>(y), BH, heads, G, S, P, N, Q, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [BH / heads, S, heads, P] (bf16 != 0: bfloat16, else float32);
// dt [BH / heads, S, heads], A [nA] (row bh reads A[bh % nA]), Bm / Cm
// [G, S, N] (row bh reads row bh / (BH / G)), all float32 and contiguous;
// y as x in float32, h [BH, N, P] float32. Launches 4 grids (kernel.GRIDS).
// Scratch, float32: states
// [BH, S / Q, N, P], cum [BH, S], cb [G, S / Q, Qp, Qp] with Qp = Q rounded
// up to 32. Q divides S; Q <= 128, N <= 128, P <= 64.
int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             void* y, void* h, void* states, void* cum, void* cb, int BH, int heads, int G,
             int nA, int S, int P, int N, int Q, int bf16, cudaStream_t stream) {
  if (BH < 1 || heads < 1 || BH % heads || G < 1 || BH % G || nA < 1 || S < 1 || Q < 1 ||
      Q > kMaxQ || S % Q || P < 1 || P > kMaxP || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h, states, cum, cb, BH, heads, G, nA, S,
                                 P, N, Q, stream);
  return launch<float>(x, dt, A, Bm, Cm, y, h, states, cum, cb, BH, heads, G, nA, S, P, N, Q,
                       stream);
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
