// PPoT-SQ(2) dispatch kernels and the alias-table pairing walk, for sm_90a.
//
// Three dispatch kernels share one templated body (the probe is an alias
// table or an inverse CDF, the fold-back is on or off):
//
//   ppot_fused_alias  replaces ppot_dispatch_fused_alias
//                     (src/repro/kernels/ppot_dispatch/kernel.py, _fused_alias_kernel)
//   ppot_fused_cdf    replaces ppot_dispatch_fused
//                     (same file, _fused_kernel)
//   ppot_select_cdf   replaces ppot_dispatch (same file, _kernel)
//
// and alias_pairing replaces the n-step pairing fori_loop of
// build_alias_table (src/repro/core/dispatch.py).
//
// Bound on an H100: each dispatch kernel moves under 400 KB even at n=2048,
// B=16384 (alias: 16n + 20B bytes, fused CDF: 12n + 12B), about 0.1 us at
// 3.35 TB/s, so it is bound by launch latency, not bytes or operations.
// Design answer: one launch per call, one thread per job, the [n] worker
// arrays staged once per block in shared memory (n <= 2048 is at most
// 32 KB) and read there directly. The TPU version's one-hot MXU dots were a
// workaround for slow gathers; a shared-memory gather is one load here.
//
// The fold-back: the TPU kernel accumulated q_after in an output block that
// the sequential grid revisited. CUDA blocks run in parallel and in no
// order, so the caller seeds q_after with a copy of q, each block builds a
// shared-memory histogram of its own (real, unpadded) jobs and adds each
// nonzero bin with one global atomicAdd. Integer adds commute, so the
// result is exact whatever the order.
//
// The inverse-CDF probe is the dense count #{i : cdf[i] <= u}, clipped to
// n - 1: right for any cdf, sorted or not. Every thread of a warp reads the
// same cdf[i] at once, a shared-memory broadcast.
//
// alias_pairing is a sequential chain of n dependent steps (each finalises
// one bin), so one thread walks the two stacks in shared memory; the block
// only stages the arrays in and out. Bound: latency of the chain, about n
// shared-memory round trips. It replaces n x ~15 eager launches per build.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int cdf_probe(const float* cdf, int n, float u) {
  int c = 0;
  for (int i = 0; i < n; ++i) c += (cdf[i] <= u) ? 1 : 0;
  return c < n - 1 ? c : n - 1;
}

__device__ __forceinline__ int alias_probe(const float* prob, const int* alias,
                                           int n, float u, float v) {
  int bin = (int)(u * (float)n);  // one f32 multiply, then truncation
  bin = bin < n - 1 ? bin : n - 1;
  return v < prob[bin] ? bin : alias[bin];
}

template <bool ALIAS, bool FOLD>
__global__ void __launch_bounds__(kThreads) ppot_kernel(
    const float* __restrict__ tab, const int* __restrict__ alias,
    const int* __restrict__ q, const float* __restrict__ u1,
    const float* __restrict__ v1, const float* __restrict__ u2,
    const float* __restrict__ v2, int n, int B, int* __restrict__ workers,
    int* __restrict__ q_after) {
  extern __shared__ int smem[];
  float* s_tab = reinterpret_cast<float*>(smem);
  int* s_q = smem + n;
  int* s_alias = s_q + n;                // ALIAS only
  int* s_hist = s_alias + (ALIAS ? n : 0);  // FOLD only
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_tab[i] = tab[i];
    s_q[i] = q[i];
    if (ALIAS) s_alias[i] = alias[i];
    if (FOLD) s_hist[i] = 0;
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) {
    int j1, j2;
    if (ALIAS) {
      j1 = alias_probe(s_tab, s_alias, n, u1[b], v1[b]);
      j2 = alias_probe(s_tab, s_alias, n, u2[b], v2[b]);
    } else {
      j1 = cdf_probe(s_tab, n, u1[b]);
      j2 = cdf_probe(s_tab, n, u2[b]);
    }
    const int w = s_q[j1] <= s_q[j2] ? j1 : j2;
    workers[b] = w;
    if (FOLD) atomicAdd(&s_hist[w], 1);
  }
  if (FOLD) {
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = s_hist[i];
      if (c) atomicAdd(&q_after[i], c);
    }
  }
}

__global__ void __launch_bounds__(kThreads) alias_pairing_kernel(
    const float* __restrict__ p_in, const int* __restrict__ stack_in,
    const int* __restrict__ ns0, int n, float* __restrict__ prob_out,
    int* __restrict__ alias_out) {
  extern __shared__ int smem[];
  float* p = reinterpret_cast<float*>(smem);
  int* st = smem + n;
  float* prob = reinterpret_cast<float*>(st + n);
  int* alias = st + 2 * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    p[i] = p_in[i];
    st[i] = stack_in[i];
    prob[i] = 1.0f;
    alias[i] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int ns = *ns0;
    int nl = n - ns;
    // each step finalises one bin; once either stack is empty the rest
    // keep prob 1 and alias themselves, which the init already holds
    while (ns > 0 && nl > 0) {
      const int s = st[ns - 1];
      const int l = st[n - nl];
      const float ps = p[s];
      prob[s] = ps;
      alias[s] = l;
      const float pl = p[l] - (1.0f - ps);  // large's residual mass
      p[l] = pl;
      if (pl < 1.0f) {
        st[ns - 1] = l;  // residual large takes the vacated small slot
        --nl;
      } else {
        --ns;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    prob_out[i] = prob[i];
    alias_out[i] = alias[i];
  }
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool ALIAS, bool FOLD>
int ppot_launch(const float* tab, const int* alias, const int* q,
                const float* u1, const float* v1, const float* u2,
                const float* v2, int n, int B, int* workers, int* q_after,
                cudaStream_t stream) {
  const size_t smem = (size_t)n * 4 * (2 + (ALIAS ? 1 : 0) + (FOLD ? 1 : 0));
  const int blocks = (B + kThreads - 1) / kThreads;
  cudaError_t e = allow_smem(ppot_kernel<ALIAS, FOLD>, smem);
  if (e != cudaSuccess) return (int)e;
  ppot_kernel<ALIAS, FOLD><<<blocks, kThreads, smem, stream>>>(
      tab, alias, q, u1, v1, u2, v2, n, B, workers, q_after);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ppot_fused_alias(const float* prob, const int* alias, const int* q,
                     const float* u1, const float* v1, const float* u2,
                     const float* v2, int n, int B, int* workers,
                     int* q_after, cudaStream_t stream) {
  return ppot_launch<true, true>(prob, alias, q, u1, v1, u2, v2, n, B,
                                 workers, q_after, stream);
}

int ppot_fused_cdf(const float* cdf, const int* q, const float* u1,
                   const float* u2, int n, int B, int* workers, int* q_after,
                   cudaStream_t stream) {
  return ppot_launch<false, true>(cdf, nullptr, q, u1, nullptr, u2, nullptr,
                                  n, B, workers, q_after, stream);
}

int ppot_select_cdf(const float* cdf, const int* q, const float* u1,
                    const float* u2, int n, int B, int* workers,
                    cudaStream_t stream) {
  return ppot_launch<false, false>(cdf, nullptr, q, u1, nullptr, u2, nullptr,
                                   n, B, workers, nullptr, stream);
}

int alias_pairing(const float* p, const int* stack, const int* ns0, int n,
                  float* prob, int* alias, cudaStream_t stream) {
  const size_t smem = (size_t)n * 16;
  cudaError_t e = allow_smem(alias_pairing_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  alias_pairing_kernel<<<1, kThreads, smem, stream>>>(p, stack, ns0, n, prob,
                                                      alias);
  return (int)cudaGetLastError();
}

const char* ppot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
