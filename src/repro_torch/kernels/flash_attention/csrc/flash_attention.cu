// Flash-attention forward for sm_90a. Replaces flash_attention_fwd
// (src/repro/kernels/flash_attention/kernel.py, _kernel): blocked
// online-softmax attention with causal / sliding-window masks built from
// positions (qpos = q_offset + row, kpos = col), f32 running max, sum and
// accumulator, p rounded to v's dtype before the PV product, and rows
// that see no valid key written as 0.
//
// Bound on an H100 at the main path's shape (smollm-360m prefill, B=4,
// S=4096, 15 heads, 5 kv heads, D=64, bf16, causal): the two products
// take 2 x 2 x B x H x S(S+1)/2 x D = 1.29e11 FLOPs, 0.130 ms at 989
// TFLOP/s; q and o are 31.5 MB each and k, v 10.5 MB each, read or
// written once, 0.025 ms at 3.35 TB/s. The tensor cores bound it, and
// close behind them the exponent unit: every score takes one ex2, and
// at D=64 an SM's 16 ex2 per clock need as long for a tile's 128 x 128
// exponents as its tensor cores need for the tile's two products.
//
// Design. One block owns one (batch, head, 64-row q tile) and walks the
// kv tiles that can hold a valid key for it; tiles are scheduled longest
// first, two blocks resident per SM. Two warpgroups:
//   * a producer (one thread issues) keeps a ring of NS = 3 (K, V) tile
//     stages in flight with TMA (cp.async.bulk.tensor; per stage a "full"
//     and an "empty" mbarrier for K and for V, so that Q K^T starts before
//     V lands). The tensor maps are encoded on the host with
//     cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, so
//     nothing links libcuda) over the 4-d view [B, S, H, D] with any
//     strides: the model's layout is read in place and GQA reads kv head
//     h / group. TMA writes the tiles 128-byte swizzled (64-byte at D=32),
//     the layout the wgmma descriptors name, and zero-fills rows past S;
//   * the consumer warpgroup owns the 64 query rows. S = Q K^T is one
//     wgmma chain with Q and K from shared memory; the S accumulator's
//     register layout is the A-fragment layout of the PV product, so P is
//     rounded to bf16 in registers and never leaves them (wgmma with A
//     from registers, V read MN-major through the descriptor's transpose
//     bit). The other resident block's softmax (ex2 unit) runs under this
//     one's products (tensor cores). setmaxnreg hands the producer's
//     registers (24 kept) to the consumer (232).
// Less work per element: the mask is applied only on the tiles that need
// it (the rule of ref.tile_plan: the ragged last kv tile, the tiles that
// reach past the causal diagonal, the window's first tile); interior
// tiles take no position test. Scores are scaled into the exponent as
// ex2(s * scale * log2(e) - m * scale * log2(e)), one FFMA and one ex2.
// Tiles wholly masked are never visited. What these choices measured
// against their alternatives (two consumer warpgroups a block, softmax
// overlapped with PV inside a warpgroup, ping-pong, skipping the
// accumulator's rescale where no row maximum moved) is in PERF.md.
//
// float32 inputs take a plain FMA kernel (one thread per query row): the
// tensor cores' TF32 would not hold the f32 tolerance. It exists for the
// tests; the model path runs bf16.
//
// The log-sum-exp. Given an lse pointer (training), both forward kernels
// also write each row's natural log-sum-exp of its scaled scores, f32
// [B, Hq, Sq]: m + log(l) with m the row's largest scaled score, as
// _flash_fwd_impl computes it (src/repro/models/layers.py:203, :218); a
// row with no valid key gets -1e30 (the reference's -1e30 + log(1e-30),
// which rounds to it in f32), finite, so the backward's exp(s - lse) is 0
// there and never NaN. Without the pointer (serving) nothing else changes:
// o is computed by the same instructions.
//
// K4b, the backward (flash_bwd_*, below), is the counterpart of the JAX
// package's _flash_bwd (src/repro/models/layers.py:232-298), the custom
// VJP that keeps training at O(S) memory; it is XLA there, not Pallas.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace wmma = nvcuda::wmma;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf32 = -1e30f;  // the f32 kernel's masked score

struct Strides {  // element strides of a [B, S, H, D] view (D contiguous)
  long long b, s, h;
};

__device__ __forceinline__ bool valid(int qpos, int kpos, int Sk, int causal,
                                      int window) {
  const int dif = qpos - kpos;
  return kpos < Sk && (!causal || dif >= 0) && (window <= 0 || dif < window);
}

// The kv tiles [*t0, *t1) that can hold a valid key for query positions
// [qlo, qhi]; the others are wholly masked and skipped (ref.tile_plan).
__host__ __device__ __forceinline__ void kv_tiles(int qlo, int qhi, int Sk, int BK,
                                                  int causal, int window, int* t0,
                                                  int* t1) {
  int kend = Sk;
  if (causal) kend = min(kend, qhi + 1);
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  *t0 = kbeg / BK;
  *t1 = kend <= kbeg ? *t0 : (kend + BK - 1) / BK;
}

// Whether kv tile [k0, k0 + BK) holds an invalid pair for some query
// position in [qlo, qhi] (ref.tile_plan): if not, no element is tested.
__device__ __forceinline__ bool needs_mask(int k0, int BK, int qlo, int qhi, int Sk,
                                           int causal, int window) {
  return k0 + BK > Sk || (causal && k0 + BK - 1 > qlo) ||
         (window > 0 && qhi - k0 >= window);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// One box of a 4-d tensor map into shared memory; completion is counted
// (in bytes) on `bar`. Coordinates innermost first: (d, h, s, b).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), layout (1: 128-byte swizzle, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that an asynchronous wgmma reads or writes, so that the
// compiler neither reuses nor reads them across the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d[32] = (scale_d ? d : 0) + A (smem, K-major) B (smem, K-major), m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d[64] = (scale_d ? d : 0) + A (smem, K-major) B (smem, K-major), m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d[16] += A (registers) B (smem, MN-major), m64n32k16
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d[32] += A (registers) B (smem, MN-major), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d[64] += A (registers) B (smem, MN-major), m64n128k16
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

// Consumer warpgroups per block, 64 query rows each. One, with two blocks
// resident per SM, measured 6% faster at the main shape than two sharing
// a block's K/V ring (PERF.md).
constexpr int kConsumers = 1;
constexpr int kThreadsTma = 128 * (kConsumers + 1);  // + the producer warpgroup

template <int D>
struct Tile {
  static constexpr int BQ = 64 * kConsumers;   // query rows of a block
  static constexpr int BK = D == 128 ? 64 : 128;  // keys of a kv tile
  static constexpr int NS = 3;                 // K/V stages in flight
  static constexpr int ROWB = D == 32 ? 64 : 128;  // bytes of a swizzled row
  static constexpr int CW = ROWB / 2;          // elements of a column block's row
  static constexpr int NCB = D / CW;           // column blocks (TMA boxes) per tile
  static constexpr int LAYOUT = D == 32 ? 2 : 1;  // descriptor swizzle
  static constexpr int QBYTES = BQ * D * 2, KVBYTES = BK * D * 2;
  static constexpr int NBARS = 1 + 4 * NS;
  static constexpr int SMEM = 1024 + QBYTES + 2 * NS * KVBYTES + 8 * NBARS;
};

template <int D>
__global__ void __launch_bounds__(kThreadsTma, 3 - kConsumers) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, Strides so,
    float* __restrict__ lse, int Hq, int group, int Sq, int Sk, float scale_log2,
    int causal, int window, int q_offset) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grain
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sq = smem_u32(smem);
  const uint32_t sk = sq + T::QBYTES, sv = sk + T::NS * T::KVBYTES;
  const uint32_t bar0 = sv + T::NS * T::KVBYTES;
  const uint32_t full_q = bar0;
  auto full_k = [&](int s) { return bar0 + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar0 + 8u * (1 + T::NS + s); };
  auto empty_k = [&](int s) { return bar0 + 8u * (1 + 2 * T::NS + s); };
  auto empty_v = [&](int s) { return bar0 + 8u * (1 + 3 * T::NS + s); };

  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::BQ;  // longest tiles first
  const int qlo = q_offset + q0, qhi = q_offset + min(q0 + T::BQ, Sq) - 1;
  int t0, t1;
  kv_tiles(qlo, qhi, Sk, T::BK, causal, window, &t0, &t1);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < T::NS; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * kConsumers);  // lane 0 of each consumer warp
      mbar_init(empty_v(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---- producer warpgroup: one thread issues ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, T::QBYTES);
      for (int cb = 0; cb < T::NCB; ++cb)
        tma_load(sq + cb * T::BQ * T::ROWB, &tq, cb * T::CW, h, q0, b, full_q);
      const int hk = h / group;
      for (int it = 0; it < t1 - t0; ++it) {
        const int s = it % T::NS, ph = (it / T::NS) & 1, k0 = (t0 + it) * T::BK;
        mbar_wait(empty_k(s), ph ^ 1);
        mbar_expect_tx(full_k(s), T::KVBYTES);
        for (int cb = 0; cb < T::NCB; ++cb)
          tma_load(sk + s * T::KVBYTES + cb * T::BK * T::ROWB, &tk, cb * T::CW, hk, k0, b,
                   full_k(s));
        mbar_wait(empty_v(s), ph ^ 1);
        mbar_expect_tx(full_v(s), T::KVBYTES);
        for (int cb = 0; cb < T::NCB; ++cb)
          tma_load(sv + s * T::KVBYTES + cb * T::BK * T::ROWB, &tv, cb * T::CW, hk, k0, b,
                   full_v(s));
      }
    }
  } else {  // ---- consumer warpgroups, 64 query rows each ----
    // the registers the producer gave up (65,536 per SM over the blocks)
    if constexpr (kConsumers == 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    else asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + cw * 64 + warp * 16 + g, r1 = r0 + 8;  // this thread's rows
    const int qp0 = q_offset + r0, qp1 = q_offset + r1;
    constexpr uint32_t SBO = 8 * T::ROWB;  // between 8-row core-matrix groups

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // row maxima (equal across a row's 4 threads)
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

    mbar_wait(full_q, 0);
    for (int it = 0; it < t1 - t0; ++it) {
      const int s = it % T::NS, ph = (it / T::NS) & 1, k0 = (t0 + it) * T::BK;

      // S = Q K^T: 64 rows x BK keys, f32
      float sc[T::BK / 2];
      mbar_wait(full_k(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t cb = kk * 16 / T::CW, off = (kk * 16 % T::CW) * 2;
        const uint64_t da = smem_desc(sq + cb * T::BQ * T::ROWB + cw * 64 * T::ROWB + off,
                                      16, SBO, T::LAYOUT);
        const uint64_t db = smem_desc(sk + s * T::KVBYTES + cb * T::BK * T::ROWB + off, 16,
                                      SBO, T::LAYOUT);
        wgmma_ss<T::BK>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_k(s));

      // positions only on the tiles that need them
      if (needs_mask(k0, T::BK, qlo, qhi, Sk, causal, window)) {
#pragma unroll
        for (int j = 0; j < T::BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + j * 8 + 2 * t + e;
            if (!valid(qp0, kp, Sk, causal, window)) sc[4 * j + e] = -INFINITY;
            if (!valid(qp1, kp, Sk, causal, window)) sc[4 * j + 2 + e] = -INFINITY;
          }
      }

      // new row maxima; p = ex2(s * c - m * c), c = scale * log2(e)
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < T::BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // a row with no valid key so far keeps m = -inf: subtract 0 there
      const float mc0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
      const float mc1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
      const float c0 = ex2(m0 * scale_log2 - mc0), c1 = ex2(m1 * scale_log2 - mc1);

      uint32_t pf[T::BK / 16][4];  // P in the A-fragment layout of the PV product
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < T::BK / 8; ++j) {
        const float p0 = ex2(fmaf(sc[4 * j], scale_log2, -mc0));
        const float p1 = ex2(fmaf(sc[4 * j + 1], scale_log2, -mc0));
        const float p2 = ex2(fmaf(sc[4 * j + 2], scale_log2, -mc1));
        const float p3 = ex2(fmaf(sc[4 * j + 3], scale_log2, -mc1));
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        pf[j / 2][2 * (j & 1)] = pack_f32(p0, p1);
        pf[j / 2][2 * (j & 1) + 1] = pack_f32(p2, p3);
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= c0;
        acc[4 * j + 1] *= c0;
        acc[4 * j + 2] *= c1;
        acc[4 * j + 3] *= c1;
      }
      m0 = mx0;
      m1 = mx1;

      // acc += P V, P from registers, V MN-major
      mbar_wait(full_v(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::BK / 16; ++kk) {
        const uint64_t db = smem_desc(sv + s * T::KVBYTES + kk * 16 * T::ROWB,
                                      T::BK * T::ROWB, SBO, T::LAYOUT);
        wgmma_rs<D>(acc, pf[kk], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pf);
      if (lane == 0) mbar_arrive(empty_v(s));
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = l0 > 0.f ? 1.f / l0 : 0.f, d1 = l1 > 0.f ? 1.f / l1 : 0.f;
    if (lse != nullptr && t == 0) {  // natural log: (m c + log2 l) ln 2, c = scale log2(e)
      float* lb = lse + (long long)(b * Hq + h) * Sq;
      if (r0 < Sq) lb[r0] = l0 > 0.f ? (m0 * scale_log2 + log2f(l0)) * kLn2 : kNegInf32;
      if (r1 < Sq) lb[r1] = l1 > 0.f ? (m1 * scale_log2 + log2f(l1)) * kLn2 : kNegInf32;
    }
    __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t;
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * so.s + c) =
            pack_f32(acc[4 * j] * d0, acc[4 * j + 1] * d0);
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r1 * so.s + c) =
            pack_f32(acc[4 * j + 2] * d1, acc[4 * j + 3] * d1);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA, one thread per query row
// ---------------------------------------------------------------------------

constexpr int kBQ32 = 32, kBK32 = 16;

template <int D>
__global__ void __launch_bounds__(kBQ32) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
    Strides sq, Strides sk, Strides sv, Strides so, int Hq, int group, int Sq, int Sk,
    float scale, int causal, int window, int q_offset) {
  __shared__ float Qs[kBQ32][D + 1];  // +1: each thread's row on its own bank
  __shared__ __align__(16) float Ks[kBK32][D];
  __shared__ __align__(16) float Vs[kBK32][D];

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ32;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  for (int i = threadIdx.x; i < kBQ32 * D; i += kBQ32) {
    const int r = i / D, c = i % D;
    Qs[r][c] = q0 + r < Sq ? qb[(q0 + r) * sq.s + c] : 0.f;
  }
  const int row = q0 + threadIdx.x;
  const int qp = q_offset + row;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf32, l = 0.f;

  int t0, t1;
  kv_tiles(q_offset + q0, q_offset + min(q0 + kBQ32, Sq) - 1, Sk, kBK32, causal,
           window, &t0, &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kBK32;
    __syncthreads();
    for (int i = threadIdx.x; i < kBK32 * D / 4; i += kBQ32) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const float4*>(kb + (k0 + r) * sk.s + c);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + r) * sv.s + c);
      }
      *reinterpret_cast<float4*>(&Ks[r][c]) = kv;
      *reinterpret_cast<float4*>(&Vs[r][c]) = vv;
    }
    __syncthreads();

    float s[kBK32];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[threadIdx.x][d], Ks[j][d], dot);
      s[j] = valid(qp, k0 + j, Sk, causal, window) ? dot * scale : kNegInf32;
      mx = fmaxf(mx, s[j]);
    }
    const float c = expf(m - mx);
    m = mx;
    l *= c;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= c;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      const float p = valid(qp, k0 + j, Sk, causal, window) ? expf(s[j] - mx) : 0.f;
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d]);
    }
  }
  if (row < Sq) {
    const float dn = l > 0.f ? l : 1.f;
    float* orow = o + b * so.b + h * so.h + row * so.s;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / dn;
    if (lse != nullptr) lse[(long long)(b * Hq + h) * Sq + row] = l > 0.f ? m + logf(l) : kNegInf32;
  }
}

// ---------------------------------------------------------------------------
// K4b: the backward. dq, dk, dv from q, k, v, o, dO and the forward's lse
// ---------------------------------------------------------------------------
//
// Bound on an H100 at smollm-360m's training shape (B=4, S=2048, 15 heads,
// 5 kv heads, D=64, bf16, causal): five products of 2 B H Sq Sk D FLOPs,
// halved by the causal mask, 8.05e10 FLOPs, 0.081 ms at 989 TFLOP/s; q,
// k, v, o, dO, dq, dk, dv are 25 MB read or written once, 0.008 ms at
// 3.35 TB/s. The tensor cores bound it.
//
// Design (simple first; wgmma and TMA are later work). Three grids on the
// stream, no global atomics, so every run gives the same bits:
//   * flash_bwd_delta: delta = rowsum(dO * o) in f32, one warp a row;
//   * flash_bwd_dkdv: one block per (batch, kv head, 64-key tile) holds K
//     and V in shared memory and walks every q head of the kv head's GQA
//     group and every 64-row q tile that can see a key of the tile. For
//     each it recomputes S = Q K^T and P = exp(S scale - lse) (0 where the
//     mask or the window excludes the pair, or past Sq / Sk), dP = dO V^T
//     and dS = P (dP - delta) scale, and adds P^T dO to dV and dS^T Q to
//     dK, which stay in registers: the group's q heads are summed in the
//     block, and dk, dv are written once per kv head;
//   * flash_bwd_dq: one block per (batch, q head, 64-row q tile) walks the
//     kv tiles the forward visits (kv_tiles), recomputes S, P, dP, dS and
//     adds dS K to dQ.
// bf16: the products on the tensor cores through the warp-level mma.sync
// API (nvcuda::wmma, 16x16x16 bf16 tiles, f32 accumulators); S and dP go
// through shared memory in f32 for the elementwise step, P and dS are
// rounded to bf16 for their products. f32: 32 x 32 tiles and plain FMA
// loops, as flash_fwd_f32. Each block recomputes S and dP, so the card
// does seven products where the bound counts five.

constexpr int kThreadsBwd = 256;  // 8 warps

template <typename T>
struct BwdTile;
template <>
struct BwdTile<__nv_bfloat16> {
  static constexpr int BQ = 64, BK = 64;
};
template <>
struct BwdTile<float> {
  static constexpr int BQ = 32, BK = 32;
};

template <typename T>
__device__ __forceinline__ T to_t(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ float to_t<float>(float x) {
  return x;
}
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

// Shared-memory layout of a backward block: four [rows][LD] tiles of T (Q,
// dO, K, V; rows padded by 16 bytes), S and dP in f32, P and dS in T, and
// lse, delta of the q tile. Every part starts on a 32-byte grain (wmma).
template <typename T, int D>
struct BwdSmem {
  static constexpr int BQ = BwdTile<T>::BQ, BK = BwdTile<T>::BK;
  static constexpr int LD = D + 16 / (int)sizeof(T);    // Q, dO, K, V rows
  static constexpr int LDS = BK + 4;                     // S, dP rows (f32)
  static constexpr int LDP = BK + 16 / (int)sizeof(T);  // P, dS rows
  static constexpr int LDO = D + 4;                      // dq / dk / dv staging (f32)
  static constexpr int Q = 0;
  static constexpr int DO = Q + BQ * LD * (int)sizeof(T);
  static constexpr int K = DO + BQ * LD * (int)sizeof(T);
  static constexpr int V = K + BK * LD * (int)sizeof(T);
  static constexpr int S = V + BK * LD * (int)sizeof(T);
  static constexpr int DP = S + BQ * LDS * 4;
  static constexpr int P = DP + BQ * LDS * 4;
  static constexpr int DS = P + BQ * LDP * (int)sizeof(T);
  static constexpr int LSE = DS + BQ * LDP * (int)sizeof(T);
  static constexpr int DEL = LSE + BQ * 4;
  static constexpr int BYTES = DEL + BQ * 4;
  // the f32 staging of a finished [64][D] accumulator reuses S and dP
  static_assert(BQ * LDO <= 2 * BQ * LDS || sizeof(T) == 4, "staging does not fit");
};

// rows [row0, row0 + ROWS) of a [S, D] slice (rows `s_stride` apart, D
// contiguous) into dst[ROWS][ld], 16 bytes a copy; rows past S as zeros.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long s_stride,
                                          int row0, int S) {
  constexpr int V = 16 / (int)sizeof(T), CPR = D / V;
  for (int i = threadIdx.x; i < ROWS * CPR; i += kThreadsBwd) {
    const int r = i / CPR, c = (i % CPR) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * s_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__global__ void __launch_bounds__(kThreadsBwd) flash_bwd_delta(
    const void* __restrict__ o, const void* __restrict__ dout, float* __restrict__ delta,
    Strides so, Strides sdo, int Hq, int Sq, int D, int bf16, long long rows) {
  const long long r = (long long)blockIdx.x * (kThreadsBwd / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i = (int)(r % Sq), bh = (int)(r / Sq), b = bh / Hq, h = bh % Hq;
  const long long oo = b * so.b + i * so.s + h * so.h, od = b * sdo.b + i * sdo.s + h * sdo.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    if (bf16)
      acc = fmaf(to_f(static_cast<const __nv_bfloat16*>(dout)[od + d]),
                 to_f(static_cast<const __nv_bfloat16*>(o)[oo + d]), acc);
    else
      acc = fmaf(static_cast<const float*>(dout)[od + d], static_cast<const float*>(o)[oo + d],
                 acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// S = Q K^T into Sf and dP = dO V^T into dPf, [BQ][BK] f32, from the tiles
// in shared memory.
template <typename T, int D>
__device__ __forceinline__ void bwd_scores(uint8_t* sm) {
  using L = BwdSmem<T, D>;
  const T* Qs = reinterpret_cast<const T*>(sm + L::Q);
  const T* dOs = reinterpret_cast<const T*>(sm + L::DO);
  const T* Ks = reinterpret_cast<const T*>(sm + L::K);
  const T* Vs = reinterpret_cast<const T*>(sm + L::V);
  float* Sf = reinterpret_cast<float*>(sm + L::S);
  float* dPf = reinterpret_cast<float*>(sm + L::DP);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int w = threadIdx.x / 32;
    constexpr int NT = L::BK / 16;  // column tiles
#pragma unroll
    for (int f = w; f < (L::BQ / 16) * NT; f += kThreadsBwd / 32) {
      const int rt = f / NT, ct = f % NT;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s, dp;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dp, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, Qs + rt * 16 * L::LD + kk * 16, L::LD);
        wmma::load_matrix_sync(bm, Ks + ct * 16 * L::LD + kk * 16, L::LD);
        wmma::mma_sync(s, a, bm, s);
        wmma::load_matrix_sync(a, dOs + rt * 16 * L::LD + kk * 16, L::LD);
        wmma::load_matrix_sync(bm, Vs + ct * 16 * L::LD + kk * 16, L::LD);
        wmma::mma_sync(dp, a, bm, dp);
      }
      wmma::store_matrix_sync(Sf + rt * 16 * L::LDS + ct * 16, s, L::LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(dPf + rt * 16 * L::LDS + ct * 16, dp, L::LDS,
                              wmma::mem_row_major);
    }
  } else {
    for (int e = threadIdx.x; e < L::BQ * L::BK; e += kThreadsBwd) {
      const int i = e / L::BK, j = e % L::BK;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(Qs[i * L::LD + d], Ks[j * L::LD + d], s);
        dp = fmaf(dOs[i * L::LD + d], Vs[j * L::LD + d], dp);
      }
      Sf[i * L::LDS + j] = s;
      dPf[i * L::LDS + j] = dp;
    }
  }
}

// P = exp(S scale - lse) where (q0 + i, k0 + j) is a valid pair, else 0,
// and dS = P (dP - delta) scale, into P and dS (type T).
template <typename T, int D>
__device__ __forceinline__ void bwd_probs(uint8_t* sm, int q0, int k0, int Sq, int Sk,
                                          float scale, int causal, int window, int q_offset) {
  using L = BwdSmem<T, D>;
  const float* Sf = reinterpret_cast<const float*>(sm + L::S);
  const float* dPf = reinterpret_cast<const float*>(sm + L::DP);
  const float* lse_s = reinterpret_cast<const float*>(sm + L::LSE);
  const float* del_s = reinterpret_cast<const float*>(sm + L::DEL);
  T* Ps = reinterpret_cast<T*>(sm + L::P);
  T* dSs = reinterpret_cast<T*>(sm + L::DS);
  for (int e = threadIdx.x; e < L::BQ * L::BK; e += kThreadsBwd) {
    const int i = e / L::BK, j = e % L::BK;
    const bool ok = q0 + i < Sq && valid(q_offset + q0 + i, k0 + j, Sk, causal, window);
    const float p = ok ? expf(Sf[i * L::LDS + j] * scale - lse_s[i]) : 0.f;
    const float ds = p * (dPf[i * L::LDS + j] - del_s[i]) * scale;
    Ps[i * L::LDP + j] = to_t<T>(p);
    dSs[i * L::LDP + j] = to_t<T>(ds);
  }
}

// The q tile's rows of head h: Q, dO, lse and delta into shared memory.
template <typename T, int D>
__device__ __forceinline__ void bwd_load_q(uint8_t* sm, const T* q, const T* dout,
                                           const float* lse, const float* delta, Strides sq,
                                           Strides sdo, int b, int h, int Hq, int q0, int Sq) {
  using L = BwdSmem<T, D>;
  load_rows<T, D, L::BQ>(reinterpret_cast<T*>(sm + L::Q), L::LD, q + b * sq.b + h * sq.h, sq.s,
                         q0, Sq);
  load_rows<T, D, L::BQ>(reinterpret_cast<T*>(sm + L::DO), L::LD,
                         dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq);
  float* lse_s = reinterpret_cast<float*>(sm + L::LSE);
  float* del_s = reinterpret_cast<float*>(sm + L::DEL);
  const long long base = (long long)(b * Hq + h) * Sq;
  for (int i = threadIdx.x; i < L::BQ; i += kThreadsBwd) {
    lse_s[i] = q0 + i < Sq ? lse[base + q0 + i] : 0.f;
    del_s[i] = q0 + i < Sq ? delta[base + q0 + i] : 0.f;
  }
}

// acc[NF] (bf16: wmma fragments of a [64][D] result, f32: this thread's
// elements of a [32][D] result) written as rows [r0, min(r0 + ROWS, S)) of
// a [S, D] slice of `out`.
template <typename T, int D, typename Acc, int NF>
__device__ __forceinline__ void bwd_store(uint8_t* sm, Acc (&acc)[NF], T* out,
                                          long long s_stride, int r0, int S) {
  using L = BwdSmem<T, D>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    float* st = reinterpret_cast<float*>(sm + L::S);
    const int w = threadIdx.x / 32;
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int f = w + n * (kThreadsBwd / 32), rt = f / (D / 16), ct = f % (D / 16);
      wmma::store_matrix_sync(st + rt * 16 * L::LDO + ct * 16, acc[n], L::LDO,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 64 * D; e += kThreadsBwd) {
      const int r = e / D, d = e % D;
      if (r0 + r < S) out[(r0 + r) * s_stride + d] = to_t<T>(st[r * L::LDO + d]);
    }
  } else {
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int e = threadIdx.x + n * kThreadsBwd, r = e / D, d = e % D;
      if (r0 + r < S) out[(r0 + r) * s_stride + d] = acc[n];
    }
  }
}

template <typename T, int D>
struct BwdAcc {  // the accumulator of a [rows][D] result held by the block
  static constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int ROWS = BF ? 64 : 32;
  static constexpr int NF = BF ? ROWS * D / 256 / 8 : ROWS * D / kThreadsBwd;
  using Type = typename std::conditional<
      BF, wmma::fragment<wmma::accumulator, 16, 16, 16, float>, float>::type;
};

template <typename Acc, int NF>
__device__ __forceinline__ void acc_zero(Acc (&acc)[NF]) {
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    if constexpr (std::is_same<Acc, float>::value) acc[n] = 0.f;
    else wmma::fill_fragment(acc[n], 0.f);
  }
}

// acc += A^T B (TRANS) or A B, A [ROWS_A][LDA] of T in shared memory with
// the inner dimension of KDIM, B [KDIM][LDB]; the result has D columns.
template <typename T, int D, bool TRANS, int KDIM, typename Acc, int NF>
__device__ __forceinline__ void bwd_mma(Acc (&acc)[NF], const T* A, int lda, const T* Bm,
                                        int ldb) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int w = threadIdx.x / 32;
    using ALayout = typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int f = w + n * (kThreadsBwd / 32), rt = f / (D / 16), ct = f % (D / 16);
#pragma unroll
      for (int kk = 0; kk < KDIM / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
        if constexpr (TRANS) wmma::load_matrix_sync(a, A + kk * 16 * lda + rt * 16, lda);
        else wmma::load_matrix_sync(a, A + rt * 16 * lda + kk * 16, lda);
        wmma::load_matrix_sync(bm, Bm + kk * 16 * ldb + ct * 16, ldb);
        wmma::mma_sync(acc[n], a, bm, acc[n]);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int e = threadIdx.x + n * kThreadsBwd, r = e / D, d = e % D;
      float s = acc[n];
#pragma unroll 8
      for (int kk = 0; kk < KDIM; ++kk)
        s = fmaf(TRANS ? A[kk * lda + r] : A[r * lda + kk], Bm[kk * ldb + d], s);
      acc[n] = s;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsBwd) flash_bwd_dkdv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Strides sq,
    Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int Hq, int Hkv, int Sq,
    int Sk, float scale, int causal, int window, int q_offset) {
  using L = BwdSmem<T, D>;
  using A = BwdAcc<T, D>;
  extern __shared__ __align__(128) uint8_t smem_bwd[];
  uint8_t* sm = smem_bwd;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, group = Hq / Hkv;
  const int k0 = blockIdx.y * L::BK;
  load_rows<T, D, L::BK>(reinterpret_cast<T*>(sm + L::K), L::LD, k + b * sk.b + hk * sk.h,
                         sk.s, k0, Sk);
  load_rows<T, D, L::BK>(reinterpret_cast<T*>(sm + L::V), L::LD, v + b * sv.b + hk * sv.h,
                         sv.s, k0, Sk);
  // the q rows that can see a key of [k0, khi]
  const int khi = min(k0 + L::BK, Sk) - 1;
  const int ilo = causal ? max(0, k0 - q_offset) : 0;
  const int ihi = window > 0 ? min(Sq - 1, khi + window - 1 - q_offset) : Sq - 1;
  typename A::Type dka[A::NF], dva[A::NF];
  acc_zero(dka);
  acc_zero(dva);
  if (ilo <= ihi) {
    for (int h = hk * group; h < (hk + 1) * group; ++h) {
      for (int qt = ilo / L::BQ; qt <= ihi / L::BQ; ++qt) {
        const int q0 = qt * L::BQ;
        __syncthreads();  // the previous tile's products are done with Q, dO, P, dS
        bwd_load_q<T, D>(sm, q, dout, lse, delta, sq, sdo, b, h, Hq, q0, Sq);
        __syncthreads();
        bwd_scores<T, D>(sm);
        __syncthreads();
        bwd_probs<T, D>(sm, q0, k0, Sq, Sk, scale, causal, window, q_offset);
        __syncthreads();
        // dV += P^T dO, dK += dS^T Q (the key tile's rows)
        bwd_mma<T, D, true, L::BQ>(dva, reinterpret_cast<const T*>(sm + L::P), L::LDP,
                                   reinterpret_cast<const T*>(sm + L::DO), L::LD);
        bwd_mma<T, D, true, L::BQ>(dka, reinterpret_cast<const T*>(sm + L::DS), L::LDP,
                                   reinterpret_cast<const T*>(sm + L::Q), L::LD);
      }
    }
  }
  bwd_store<T, D>(sm, dka, dk + b * sdk.b + hk * sdk.h, sdk.s, k0, Sk);
  bwd_store<T, D>(sm, dva, dv + b * sdv.b + hk * sdv.h, sdv.s, k0, Sk);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsBwd) flash_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
    Strides sdo, Strides sdq, int Hq, int group, int Sq, int Sk, float scale, int causal,
    int window, int q_offset) {
  using L = BwdSmem<T, D>;
  using A = BwdAcc<T, D>;
  extern __shared__ __align__(128) uint8_t smem_bwd[];
  uint8_t* sm = smem_bwd;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BQ;  // longest tiles first
  bwd_load_q<T, D>(sm, q, dout, lse, delta, sq, sdo, b, h, Hq, q0, Sq);
  int t0, t1;
  kv_tiles(q_offset + q0, q_offset + min(q0 + L::BQ, Sq) - 1, Sk, L::BK, causal, window, &t0,
           &t1);
  typename A::Type dqa[A::NF];
  acc_zero(dqa);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * L::BK;
    __syncthreads();  // the previous tile's products are done with K, dS
    load_rows<T, D, L::BK>(reinterpret_cast<T*>(sm + L::K), L::LD, k + b * sk.b + hk * sk.h,
                           sk.s, k0, Sk);
    load_rows<T, D, L::BK>(reinterpret_cast<T*>(sm + L::V), L::LD, v + b * sv.b + hk * sv.h,
                           sv.s, k0, Sk);
    __syncthreads();
    bwd_scores<T, D>(sm);
    __syncthreads();
    bwd_probs<T, D>(sm, q0, k0, Sq, Sk, scale, causal, window, q_offset);
    __syncthreads();
    // dQ += dS K
    bwd_mma<T, D, false, L::BK>(dqa, reinterpret_cast<const T*>(sm + L::DS), L::LDP,
                                reinterpret_cast<const T*>(sm + L::K), L::LD);
  }
  bwd_store<T, D>(sm, dqa, dq + b * sdq.b + h * sdq.h, sdq.s, q0, Sq);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 [B, S, H, D] view, boxes of `rows` x one
// swizzled column block.
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int B, int S, int H, Strides st, int rows) {
  using T = Tile<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::CW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
           int Hkv, int Sq, int Sk, int bf16, const Strides* st, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const int group = Hq / Hkv;
  if (bf16) {
    using T = Tile<D>;
    static bool configured = false;
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
    CUtensorMap tq, tk, tv;
    if (!encode<D>(&tq, q, B, Sq, Hq, st[0], T::BQ) ||
        !encode<D>(&tk, k, B, Sk, Hkv, st[1], T::BK) ||
        !encode<D>(&tv, v, B, Sk, Hkv, st[2], T::BK))
      return (int)cudaErrorInvalidValue;
    const dim3 grid(B * Hq, (Sq + T::BQ - 1) / T::BQ);
    flash_fwd_wgmma<D><<<grid, kThreadsTma, T::SMEM, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[3], lse, Hq, group, Sq, Sk,
        scale * kLog2e, causal, window, q_offset);
  } else {
    const dim3 grid(B * Hq, (Sq + kBQ32 - 1) / kBQ32);
    flash_fwd_f32<D><<<grid, kBQ32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, st[0], st[1], st[2],
        st[3], Hq, group, Sq, Sk, scale, causal, window, q_offset);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
               int Hkv, int Sq, int Sk, const Strides* st, float scale, int causal,
               int window, int q_offset, cudaStream_t stream) {
  using L = BwdSmem<T, D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long rows = (long long)B * Hq * Sq;
  const int warps = kThreadsBwd / 32;
  flash_bwd_delta<<<(unsigned)((rows + warps - 1) / warps), kThreadsBwd, 0, stream>>>(
      o, dout, delta, st[3], st[4], Hq, Sq, D, std::is_same<T, __nv_bfloat16>::value, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  flash_bwd_dkdv<T, D><<<dim3(B * Hkv, (Sk + L::BK - 1) / L::BK), kThreadsBwd, L::BYTES,
                         stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
                                   static_cast<T*>(dv), st[0], st[1], st[2], st[4], st[6],
                                   st[7], Hq, Hkv, Sq, Sk, scale, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<T, D><<<dim3(B * Hq, (Sq + L::BQ - 1) / L::BQ), kThreadsBwd, L::BYTES,
                       stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), st[0],
                                 st[1], st[2], st[4], st[5], Hq, Hq / Hkv, Sq, Sk, scale,
                                 causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_d(int bf16, const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, void* dq, void* dk,
                 void* dv, int B, int Hq, int Hkv, int Sq, int Sk, const Strides* st,
                 float scale, int causal, int window, int q_offset, cudaStream_t stream) {
  if (bf16)
    return launch_bwd<__nv_bfloat16, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv,
                                        Sq, Sk, st, scale, causal, window, q_offset, stream);
  return launch_bwd<float, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, st,
                              scale, causal, window, q_offset, stream);
}

}  // namespace

extern "C" {

// q [B, Sq, Hq, D], k / v [B, Sk, Hkv, D], o [B, Sq, Hq, D], any element
// strides with D contiguous (strides: 12 values, (batch, seq, head) of q,
// k, v, o in that order), all of one dtype (bf16 != 0: bfloat16, else
// float32); D in {32, 64, 128}; Hkv divides Hq (q head h reads kv head
// h / (Hq / Hkv)). bfloat16 strides are multiples of 8 elements and the
// pointers 16-byte aligned (TMA). lse: null, or f32 [B, Hq, Sq] for each
// row's log-sum-exp.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Hq, int Hkv, int Sq, int Sk, int D, int bf16,
                        const long long* strides, float scale, int causal, int window,
                        int q_offset, cudaStream_t stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, bf16, st, scale, causal, window,
                        q_offset, stream);
    case 64:
      return launch<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, bf16, st, scale, causal, window,
                        q_offset, stream);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, bf16, st, scale, causal, window,
                         q_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K4b. q, o, dout, dq [B, Sq, Hq, D]; k, v, dk, dv [B, Sk, Hkv, D]; any
// element strides with D contiguous (strides: 24 values, (batch, seq,
// head) of q, k, v, o, dout, dq, dk, dv in that order), one dtype as the
// forward's; lse: the forward's f32 [B, Hq, Sq]; delta: f32 [B, Hq, Sq]
// scratch. Strides are multiples of 8 elements and the pointers 16-byte
// aligned (16-byte loads). Three launches on `stream`; no atomics.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int D, int bf16,
                        const long long* strides, float scale, int causal, int window,
                        int q_offset, cudaStream_t stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  switch (D) {
    case 32:
      return launch_bwd_d<32>(bf16, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq,
                              Sk, st, scale, causal, window, q_offset, stream);
    case 64:
      return launch_bwd_d<64>(bf16, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq,
                              Sk, st, scale, causal, window, q_offset, stream);
    case 128:
      return launch_bwd_d<128>(bf16, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq,
                               Sk, st, scale, causal, window, q_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
