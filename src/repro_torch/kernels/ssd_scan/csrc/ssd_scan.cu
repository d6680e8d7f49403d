// Mamba2 SSD chunked scan for sm_90a. Replaces ssd_scan
// (src/repro/kernels/ssd_scan/kernel.py, _kernel): per chunk of Q steps,
// with cum the in-chunk cumulative sum of dt * A,
//   y  = (C B^T . exp(cum_q - cum_k)[q >= k]) (dt x) + (C . exp(cum)) h_in
//   h' = exp(cum_end) h_in + sum_k exp(cum_end - cum_k) B_k (x) (dt_k x_k)
// with the [N, P] state carried from chunk to chunk and returned at the
// end. All arithmetic is f32 (the TPU kernel's preferred_element_type).
//
// Layout: the TPU grid is (BH, S / Q) with the chunk axis innermost and
// sequential, the state in VMEM scratch across its steps. Blocks of a CUDA
// grid run in no order and carry nothing, so one block owns one bh and
// walks the chunks itself: the state stays in shared memory (32 KiB at
// N = 128, P = 64) for the whole sequence. 256 threads as a 16 x 16 grid;
// every product of a chunk is a small matrix product out of shared memory,
// each thread holding a register tile of rows ty + 16 i and columns
// tx + 16 j. Per chunk:
//   1. load C, B [Q, N] (f32), x [Q, P] (f32 or bf16, widened) and dt;
//      one warp takes the in-chunk cumulative sum with shuffles;
//   2. y = exp(cum_q) * (C h_in)                        [Q, P]
//   3. for each block of 32 keys k: the scores
//      s[q, k] = (C_q . B_k) exp(cum_q - cum_k) dt_k for q >= k, then
//      y += s x; row groups wholly above the diagonal are skipped;
//   4. h = exp(cum_end) h + (B . exp(cum_end - cum) dt)^T x   [N, P].
// Shared memory at Q = 128, N = 128, P = 64: 211.5 KiB, one block per SM.
//
// B and C are shared by the heads (Mamba2's n_groups = 1): the kernel
// takes them as G rows and row bh reads row bh / (BH / G), so the JAX
// wrapper's broadcast to [BH, S, N] is never made. x, dt and y are
// addressed as [BH / heads, S, heads, ...]: heads = 1 is the reference's
// [BH, S, ...] layout, heads = H the model's [B, S, H, ...], read and
// written in place.
//
// Bound on an H100 at the main path's shape (mamba2-370m prefill, B = 4,
// S = 4096, H = 32, P = 64, N = 128, x bf16): x 67.1 MB, dt 2.1 MB, B and
// C 8.4 MB each read once, y 134.2 MB and h 4.2 MB written once: 224 MB,
// 0.067 ms at 3.35 TB/s. The f32 work with C B^T counted once per
// (batch row, chunk) on the causal triangle: 2.18e10 FLOPs, 0.325 ms at
// the 67 TFLOP/s of f32 outside the tensor cores, so operations bound it.
// This kernel recomputes C B^T per head and runs on the FMA units at one
// block per bh (128 blocks on 132 SMs at B = 4, 32 at B = 1): it is the
// direct analogue, right first. The redesign splits the chunks across
// blocks (intra-chunk terms and chunk states for all chunks in parallel,
// then the short carry over S / Q) and takes the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128, kMaxN = 128, kMaxP = 64;
constexpr int kKB = 32;  // keys per score block
constexpr int kLdS = kKB + 1;
constexpr int kLoads = 16;  // global loads a thread keeps in flight

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ __forceinline__ size_t smem_floats(int Qp, int Np, int Pp) {
  // C and B [Qp][Np + 1], x [Qp][Pp], state [Np][Pp], scores [Qp][kLdS],
  // cum, dt, exp(cum), exp(cum_end - cum) * dt [Qp] each
  return (size_t)2 * Qp * (Np + 1) + (size_t)Qp * Pp + (size_t)Np * Pp +
         (size_t)Qp * kLdS + 4 * (size_t)Qp;
}

template <typename XT>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const XT* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, float* __restrict__ y,
                    float* __restrict__ hout, int BH, int heads, int G, int nA,
                    int S, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int Qp = round_up(Q, kKB), Np = round_up(N, 16), Pp = round_up(P, 16);
  const int ldn = Np + 1;  // odd row stride: column reads hit distinct banks
  float* Cs = smem;
  float* Bs = Cs + Qp * ldn;
  float* Xs = Bs + Qp * ldn;
  float* Hs = Xs + Qp * Pp;
  float* Ss = Hs + Np * Pp;
  float* cum = Ss + Qp * kLdS;
  float* dts = cum + Qp;
  float* ecum = dts + Qp;
  float* wk = ecum + Qp;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / heads, hh = bh % heads;
  const int g = bh / (BH / G);
  const float a = A[bh % nA];
  const int qt = Qp / 16, nt = Np / 16, pt = Pp / 16;
  const float* Brow = Bm + (size_t)g * S * N;
  const float* Crow = Cm + (size_t)g * S * N;

  for (int i = tid; i < Np * Pp; i += kThreads) Hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // ---- 1. load the chunk (zero-padded to Qp rows, Np / Pp columns),
    // kLoads elements a thread at a time so that their latencies overlap ----
    for (int i0 = 0; i0 < Qp * Np; i0 += kThreads * kLoads) {
      float cv[kLoads], bv[kLoads];
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int i = i0 + r * kThreads + tid;
        const int q = i / Np, n = i - q * Np;
        cv[r] = bv[r] = 0.f;
        if (q < Q && n < N) {
          const size_t o = (size_t)(c0 + q) * N + n;
          cv[r] = Crow[o];
          bv[r] = Brow[o];
        }
      }
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int i = i0 + r * kThreads + tid;
        if (i < Qp * Np) {
          const int q = i / Np, n = i - q * Np;
          Cs[q * ldn + n] = cv[r];
          Bs[q * ldn + n] = bv[r];
        }
      }
    }
    for (int i0 = 0; i0 < Qp * Pp; i0 += kThreads * kLoads) {
      float v[kLoads];
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int i = i0 + r * kThreads + tid;
        const int k = i / Pp, p = i - k * Pp;
        v[r] = 0.f;
        if (k < Q && p < P) v[r] = widen(x[(((size_t)b * S + c0 + k) * heads + hh) * P + p]);
      }
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int i = i0 + r * kThreads + tid;
        if (i < Qp * Pp) Xs[i] = v[r];
      }
    }
    for (int k = tid; k < Qp; k += kThreads) {
      dts[k] = k < Q ? dt[((size_t)b * S + c0 + k) * heads + hh] : 0.f;
      if (k >= Q) cum[k] = 0.f;
    }
    __syncthreads();
    if (tid < 32) {  // in-chunk cumulative sum of dt * A: lane l owns <= 4 steps
      const int per = (Q + 31) / 32;
      float loc[4];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = tid * per + e;
        if (e < per && k < Q) run += dts[k] * a;
        loc[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      float prev = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) prev = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = tid * per + e;
        if (e < per && k < Q) cum[k] = prev + loc[e];
      }
    }
    __syncthreads();
    const float cend = cum[Q - 1];
    for (int k = tid; k < Qp; k += kThreads) {
      ecum[k] = k < Q ? expf(cum[k]) : 0.f;
      wk[k] = k < Q ? expf(cend - cum[k]) * dts[k] : 0.f;
    }
    __syncthreads();

    // ---- 2. y = exp(cum_q) (C h_in) ----
    float yacc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;
    for (int n = 0; n < Np; ++n) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = i < qt ? Cs[(ty + 16 * i) * ldn + n] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = j < pt ? Hs[n * Pp + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yacc[i][j] = fmaf(av[i], bv[j], yacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = i < qt ? ecum[ty + 16 * i] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[i][j] *= e;
    }

    // ---- 3. y += s x, one block of kKB keys at a time ----
    for (int k0 = 0; k0 < Qp; k0 += kKB) {
      const int ilo = k0 / 16;  // row groups i < ilo lie wholly above the diagonal
      float sacc[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) sacc[i][0] = sacc[i][1] = 0.f;
      for (int n = 0; n < Np; ++n) {
        float av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = (i >= ilo && i < qt) ? Cs[(ty + 16 * i) * ldn + n] : 0.f;
        const float b0 = Bs[(k0 + tx) * ldn + n];
        const float b1 = Bs[(k0 + tx + 16) * ldn + n];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          sacc[i][0] = fmaf(av[i], b0, sacc[i][0]);
          sacc[i][1] = fmaf(av[i], b1, sacc[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < ilo || i >= qt) continue;
        const int q = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = k0 + tx + 16 * j;
          float s = 0.f;
          if (q >= k && q < Q) s = sacc[i][j] * expf(cum[q] - cum[k]) * dts[k];
          Ss[q * kLdS + tx + 16 * j] = s;
        }
      }
      __syncthreads();
      for (int kk = 0; kk < kKB; ++kk) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = (i >= ilo && i < qt) ? Ss[(ty + 16 * i) * kLdS + kk] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = j < pt ? Xs[(k0 + kk) * Pp + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yacc[i][j] = fmaf(av[i], bv[j], yacc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = ty + 16 * i;
      if (i >= qt || q >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (j < pt && p < P) y[(((size_t)b * S + c0 + q) * heads + hh) * P + p] = yacc[i][j];
      }
    }

    // ---- 4. h = exp(cum_end) h + (B . w)^T x; each thread updates only
    // the state entries it owns, and every read of h_in (step 2) lies
    // behind the barriers of step 3 ----
    const float dend = expf(cend);
    float hacc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hacc[i][j] = (i < nt && j < pt) ? Hs[(ty + 16 * i) * Pp + tx + 16 * j] * dend : 0.f;
    for (int k = 0; k < Q; ++k) {
      const float w = wk[k];
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = i < nt ? Bs[k * ldn + ty + 16 * i] * w : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = j < pt ? Xs[k * Pp + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) hacc[i][j] = fmaf(av[i], bv[j], hacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i < nt && j < pt) Hs[(ty + 16 * i) * Pp + tx + 16 * j] = hacc[i][j];
    __syncthreads();  // the next chunk overwrites C, B, x and reads h
  }

  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P, p = i - n * P;
    hout[(size_t)bh * N * P + i] = Hs[n * Pp + p];
  }
}

template <typename XT>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* h, int BH, int heads, int G, int nA,
           int S, int P, int N, int Q, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const size_t most = sizeof(float) * smem_floats(kMaxQ, kMaxN, kMaxP);
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<XT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const size_t smem =
      sizeof(float) * smem_floats(round_up(Q, kKB), round_up(N, 16), round_up(P, 16));
  ssd_scan_kernel<XT><<<BH, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), static_cast<float*>(h),
      BH, heads, G, nA, S, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [BH / heads, S, heads, P] (bf16 != 0: bfloat16, else float32);
// dt [BH / heads, S, heads], A [nA] (row bh reads A[bh % nA]), Bm / Cm
// [G, S, N] (row bh reads row bh / (BH / G)), all float32 and contiguous;
// y as x in float32, h [BH, N, P] float32. Q divides S; Q <= 128, N <= 128,
// P <= 64.
int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, void* h, int BH, int heads, int G, int nA,
             int S, int P, int N, int Q, int bf16, cudaStream_t stream) {
  if (BH < 1 || heads < 1 || BH % heads || G < 1 || BH % G || nA < 1 || S < 1 ||
      Q < 1 || Q > kMaxQ || S % Q || P < 1 || P > kMaxP || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h, BH, heads, G, nA, S, P, N, Q,
                                 stream);
  return launch<float>(x, dt, A, Bm, Cm, y, h, BH, heads, G, nA, S, P, N, Q, stream);
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
