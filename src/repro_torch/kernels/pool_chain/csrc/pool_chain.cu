// The replica pool's submission chain of one serving turn, for sm_90a.
//
// pool_chain replaces XLA's inner lax.scan over a turn's submissions
// (pstep, src/repro/serving/scanloop.py:203-210). It is not a Pallas
// kernel. For every submission i, in order (benchmark jobs, probe bursts,
// then the arrival batch):
//
//   start[i] = max(arrival[i], free_at[w[i]])
//   done[i]  = start[i] + cost[i] / speed[w[i]]
//   free_at[w[i]] = done[i]                  (only where active[i])
//
// in f64 with the reference's rounding: one division and one addition,
// each rounded to nearest (__ddiv_rn and __dadd_rn pin it: nothing is
// contracted into a fused multiply-add). The max propagates NaN, as
// jnp.maximum does.
//
// Bound on an H100: it moves 16n + 37M bytes (free_at in and out; w,
// arrival, cost, active, start and done a step) and 8 bytes of speed for
// each distinct replica it submits to, at most 16n + 45M (about 22.5 KB at
// n = 1024, M = 136), a few ns at 3.35 TB/s. What bounds it is the serial chain of
// its M = k + max_fake + burst_cap steps: a step may read what the step
// before it wrote (the same replica), so the steps run one after another.
// Design answer: one block. Its threads stage free_at[n] and the steps'
// inputs in shared memory and compute the M durations cost / speed in
// parallel, since they do not depend on the chain; one thread then walks
// the chain through shared memory (a load, a max and an add a step); the
// block writes free_at back. Shared memory: 8n + 21M bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 16384;
constexpr int kMaxM = 4096;  // 8 * 16384 + 21 * 4096 bytes < 227 KB

__global__ void __launch_bounds__(kThreads) pool_chain_kernel(
    const double* __restrict__ free_at, const double* __restrict__ speeds,
    const int* __restrict__ workers, const double* __restrict__ arrivals,
    const double* __restrict__ costs, const unsigned char* __restrict__ active,
    int n, int M, double* __restrict__ start, double* __restrict__ done,
    double* __restrict__ free_out) {
  extern __shared__ double smem[];
  double* fa = smem;             // [n]
  double* dur = fa + n;          // [M]
  double* arr = dur + M;         // [M]
  int* w = reinterpret_cast<int*>(arr + M);                // [M]
  unsigned char* act = reinterpret_cast<unsigned char*>(w + M);  // [M]

  for (int i = threadIdx.x; i < n; i += blockDim.x) fa[i] = free_at[i];
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const int wi = workers[i];
    w[i] = wi;
    arr[i] = arrivals[i];
    act[i] = active[i];
    dur[i] = __ddiv_rn(costs[i], speeds[wi]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll 8
    for (int i = 0; i < M; ++i) {
      const int wi = w[i];
      const double a = arr[i];
      const double f = fa[wi];
      const double s = (a > f || a != a) ? a : f;
      const double d = __dadd_rn(s, dur[i]);
      start[i] = s;
      done[i] = d;
      if (act[i]) fa[wi] = d;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) free_out[i] = fa[i];
}

}  // namespace

extern "C" {

// free_out may alias free_at: the block stages free_at before it writes.
int pool_chain(const double* free_at, const double* speeds, const int* workers,
               const double* arrivals, const double* costs,
               const unsigned char* active, int n, int M, double* start,
               double* done, double* free_out, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || M < 0 || M > kMaxM) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * 8 + (size_t)M * 21;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pool_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pool_chain_kernel<<<1, kThreads, smem, stream>>>(
      free_at, speeds, workers, arrivals, costs, active, n, M, start, done,
      free_out);
  return (int)cudaGetLastError();
}

const char* pool_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
