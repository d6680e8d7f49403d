// Flash-attention forward for sm_90a. Replaces flash_attention_fwd
// (src/repro/kernels/flash_attention/kernel.py, _kernel): blocked
// online-softmax attention over [BH, S, D] with causal / sliding-window
// masks built from positions (qpos = q_offset + row, kpos = col), f32
// running max, sum and accumulator, and rows that see no valid key
// written as 0.
//
// Bound on an H100 at the main path's shape (smollm-360m prefill, B=4,
// S=4096, 15 heads so BH=60, 5 kv heads, D=64, bf16, causal): the two
// products take 2 x 2 x BH x S(S+1)/2 x D = 1.29e11 FLOPs, 0.130 ms at
// 989 TFLOP/s; q and o are 31.5 MB each and k, v 10.5 MB each (read once,
// GQA), 84 MB, 0.025 ms at 3.35 TB/s (126 MB, 0.038 ms were the kv heads
// repeated). Compute bounds it. Design answer: the bf16 products run on the tensor cores
// (mma.sync m16n8k16, f32 accumulate), and every kv tile that is wholly
// masked (above the causal diagonal, or before the window) is skipped,
// which halves the causal work. The static TPU grid could not skip them.
//
// Layout: one block owns one (bh, 64-row q tile) and walks the kv tiles
// itself; that loop takes the place of the TPU grid's sequential innermost
// dimension, so the running max m, sum l and [64, D] accumulator stay in
// registers for the whole sweep. Four warps each own 16 query rows. Q's
// fragments are loaded once into registers; each 64-row kv tile is staged
// in shared memory (rows padded by 8 elements so the fragment loads hit
// 32 distinct banks). The S accumulator's register layout is the A
// fragment layout of the PV product, so P never leaves registers: it is
// rounded to bf16 there (p cast to v's dtype before the PV product, as
// the TPU kernel does).
//
// GQA: k and v hold BH / group rows and q row bh reads kv row bh / group
// (with bh = b * Hq + h and group = Hq / Hkv that is b * Hkv + h / group),
// so the kv heads are never repeated in memory.
//
// float32 inputs take a plain FMA kernel (one thread per query row, 32
// rows and 16 keys per tile): the tensor cores' TF32 would not hold the
// f32 tolerance. It exists for the tests; the model path runs bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool valid(int qpos, int kpos, int Sk, int causal,
                                      int window) {
  const int dif = qpos - kpos;
  return kpos < Sk && (!causal || dif >= 0) && (window <= 0 || dif < window);
}

// The kv tiles [*t0, *t1) that can hold a valid key for query positions
// [qlo, qhi]; the others are wholly masked and skipped.
__device__ __forceinline__ void kv_tiles(int qlo, int qhi, int Sk, int BK,
                                         int causal, int window, int* t0,
                                         int* t1) {
  int kend = Sk;
  if (causal) kend = min(kend, qhi + 1);
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  *t0 = kbeg / BK;
  *t1 = kend <= kbeg ? *t0 : (kend + BK - 1) / BK;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 h = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* base, int row,
                                            int col, int S, int D) {
  return row < S ? *reinterpret_cast<const uint32_t*>(base + (size_t)row * D + col)
                 : 0u;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64, kBK = 64, kThreadsBf16 = 128;

template <int D>
__global__ void __launch_bounds__(kThreadsBf16) flash_fwd_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int group, int Sq, int Sk, float scale, int causal, int window,
    int q_offset) {
  constexpr int LD = D + 8;      // padded shared-memory row
  constexpr int NKC = D / 16;    // k-steps of Q K^T
  constexpr int NDT = D / 8;     // n-tiles of the output
  constexpr int NST = kBK / 8;   // n-tiles of S
  constexpr int CPR = D / 8;     // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * LD];

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = q + (size_t)bh * Sq * D;
  const __nv_bfloat16* kb = k + (size_t)(bh / group) * Sk * D;
  const __nv_bfloat16* vb = v + (size_t)(bh / group) * Sk * D;

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const int qp0 = q_offset + r0, qp1 = q_offset + r1;

  uint32_t qf[NKC][4];
#pragma unroll
  for (int kc = 0; kc < NKC; ++kc) {
    qf[kc][0] = ld_pair(qb, r0, kc * 16 + 2 * t, Sq, D);
    qf[kc][1] = ld_pair(qb, r1, kc * 16 + 2 * t, Sq, D);
    qf[kc][2] = ld_pair(qb, r0, kc * 16 + 8 + 2 * t, Sq, D);
    qf[kc][3] = ld_pair(qb, r1, kc * 16 + 8 + 2 * t, Sq, D);
  }

  float acc[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // row maxima (equal across a row's 4 threads)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  int t0, t1;
  kv_tiles(q_offset + q0, q_offset + min(q0 + kBQ, Sq) - 1, Sk, kBK, causal,
           window, &t0, &t1);

  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBK * CPR; i += kThreadsBf16) {
      const int r = i / CPR, c = (i % CPR) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LD + c) = vv;
    }
    __syncthreads();

    // S = Q K^T over the tile: rows (g, g+8), key columns j*8 + 2t + {0,1}
    float s[NST][4];
#pragma unroll
    for (int j = 0; j < NST; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < NKC; ++kc) {
        const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + kc * 16 + 2 * t;
        mma_bf16(s[j], qf[kc], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale the f32 product, mask by position, new row maxima
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + j * 8 + 2 * t + e;
        s[j][e] = valid(qp0, kp, Sk, causal, window) ? s[j][e] * scale : kNegInf;
        s[j][2 + e] = valid(qp1, kp, Sk, causal, window) ? s[j][2 + e] * scale : kNegInf;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = __expf(m0 - mx0), c1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // p = exp(s - m), zeroed where masked, summed in f32, rounded to bf16
    uint32_t pf[NST][2];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NST; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + j * 8 + 2 * t + e;
        p[e] = valid(qp0, kp, Sk, causal, window) ? __expf(s[j][e] - mx0) : 0.f;
        p[2 + e] = valid(qp1, kp, Sk, causal, window) ? __expf(s[j][2 + e] - mx1) : 0.f;
      }
      ps0 += p[0] + p[1];
      ps1 += p[2] + p[3];
      pf[j][0] = pack_f32(p[0], p[1]);
      pf[j][1] = pack_f32(p[2], p[3]);
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      acc[dt][0] *= c0;
      acc[dt][1] *= c0;
      acc[dt][2] *= c1;
      acc[dt][3] *= c1;
    }

    // acc += P V: P's A fragments come straight from the S registers
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t a[4] = {pf[2 * kc][0], pf[2 * kc][1], pf[2 * kc + 1][0],
                             pf[2 * kc + 1][1]};
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        const __nv_bfloat16* vr = Vs + (kc * 16 + 2 * t) * LD + dt * 8 + g;
        mma_bf16(acc[dt], a, pack_bf16(vr[0], vr[LD]),
                 pack_bf16(vr[8 * LD], vr[9 * LD]));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 > 0.f ? l0 : 1.f, d1 = l1 > 0.f ? l1 : 1.f;
  __nv_bfloat16* ob = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + c) =
          pack_f32(acc[dt][0] / d0, acc[dt][1] / d0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + c) =
          pack_f32(acc[dt][2] / d1, acc[dt][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// float32: FMA, one thread per query row
// ---------------------------------------------------------------------------

constexpr int kBQ32 = 32, kBK32 = 16;

template <int D>
__global__ void __launch_bounds__(kBQ32) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int group, int Sq,
    int Sk, float scale, int causal, int window, int q_offset) {
  __shared__ float Qs[kBQ32][D + 1];  // +1: each thread's row on its own bank
  __shared__ __align__(16) float Ks[kBK32][D];
  __shared__ __align__(16) float Vs[kBK32][D];

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ32;
  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)(bh / group) * Sk * D;
  const float* vb = v + (size_t)(bh / group) * Sk * D;
  for (int i = threadIdx.x; i < kBQ32 * D; i += kBQ32) {
    const int r = i / D, c = i % D;
    Qs[r][c] = q0 + r < Sq ? qb[(size_t)(q0 + r) * D + c] : 0.f;
  }
  const int row = q0 + threadIdx.x;
  const int qp = q_offset + row;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

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
        kv = *reinterpret_cast<const float4*>(kb + (size_t)(k0 + r) * D + c);
        vv = *reinterpret_cast<const float4*>(vb + (size_t)(k0 + r) * D + c);
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
      s[j] = valid(qp, k0 + j, Sk, causal, window) ? dot * scale : kNegInf;
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
    float* orow = o + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / dn;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int group, int Sq, int Sk, int bf16, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  if (bf16) {
    const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
    flash_fwd_bf16<D><<<grid, kThreadsBf16, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        group, Sq, Sk, scale, causal, window, q_offset);
  } else {
    const dim3 grid(BH, (Sq + kBQ32 - 1) / kBQ32);
    flash_fwd_f32<D><<<grid, kBQ32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), group, Sq, Sk,
        scale, causal, window, q_offset);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [BH, Sq, D], k/v [BH / group, Sk, D], o [BH, Sq, D], all contiguous and
// of one dtype (bf16 != 0: bfloat16, else float32); D in {32, 64, 128}.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int BH, int group, int Sq, int Sk, int D, int bf16,
                        float scale, int causal, int window, int q_offset,
                        cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, BH, group, Sq, Sk, bf16, scale, causal,
                        window, q_offset, stream);
    case 64:
      return launch<64>(q, k, v, o, BH, group, Sq, Sk, bf16, scale, causal,
                        window, q_offset, stream);
    case 128:
      return launch<128>(q, k, v, o, BH, group, Sq, Sk, bf16, scale, causal,
                         window, q_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
