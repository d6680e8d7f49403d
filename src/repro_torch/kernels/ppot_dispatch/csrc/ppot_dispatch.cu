// PPoT-SQ(2) dispatch kernels and the alias-table build, for sm_90a.
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
// and alias_table replaces build_alias_table after its scaling: the stack
// order, the n-step pairing fori_loop and the mask pass
// (src/repro/core/dispatch.py).
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
// The inverse-CDF probe is a branchless upper bound: power-of-two steps,
// ceil(log2 n) + 1 loads, the two probes of a job searched in one loop so
// that their load chains overlap. PRECONDITION: cdf is non-decreasing (no
// NaN). Then the search equals the dense count #{i : cdf[i] <= u} clipped
// to n - 1 that the Pallas kernel computes, ties and zero-mass plateaus
// included. make_cdf and masked_cdf give that order by construction: a
// cumsum of non-negative f32 weights divided by its own last element.
// The cdf and q are staged in shared memory like the alias table: reading
// both through L1 (__ldg) instead was no faster at either timed shape.
//
// alias_table is one block of kTableThreads threads, in four phases:
//   1. a stable partition (one block-wide scan a tile) lays the bins out in
//      walk order in shared memory: the smalls (p < 1; NaN counts as large)
//      at [0, ns0) in index order beside their deficit 1 - p, the larges at
//      [ns0, n) in descending index order beside their p;
//   2. one thread walks, one step per bin finalised. What must stay serial
//      is the next residual, r < 1 ? n1 - (1 - r) : r - s1: two dependent
//      subtractions and a select a step, at least 12 cycles (about 6.2 us
//      at n = 1024 and 1.98 GHz). The step's small is the last residual if
//      the step before dropped its large below 1 (the reference's stack put
//      it in the vacated top slot), else the next small in descending index
//      order; its large is the next in ascending index order after a drop.
//      So both streams are read in a fixed order: the current large, the
//      next two larges and the next two smalls sit in registers, and what a
//      step may shift in is loaded at its start, a step before the chain
//      can need it. The choices are selects; the only branch is the exit
//      test, once every kWalkUnroll steps. A step stores only its residual,
//      into a log;
//   3. a block-wide scan of the log's drops (residual < 1) says which small
//      and which large every step took and where the walk ended (the steps
//      past the end only wrote the log);
//   4. the write-out: every bin prob 1 aliasing itself, then each step's
//      small its p (or the residual) and its large, with the reference's
//      mask pass applied on the way: prob = active ? prob : 0, alias =
//      active[alias] ? alias : the first active worker (0 if none), prob = 1
//      everywhere if none is active.
// Bytes: 12n (p in, prob and alias out) plus n for the mask. Shared memory:
// 12n + 4 kPads + 8 kWalkUnroll bytes, so one block takes n <= kTableMaxN.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTableThreads = 1024;
constexpr int kTableWarps = kTableThreads / 32;
constexpr int kTableMaxN = 16384;  // u16 bin indices; 12n + 400 bytes of shared memory
constexpr int kWalkUnroll = 32;
constexpr int kPads = kWalkUnroll + 4;

// upper bounds of u1 and u2 in the non-decreasing cdf[0, n), clipped to n - 1
__device__ __forceinline__ void cdf_probe2(const float* cdf, int n, float u1,
                                           float u2, int& j1, int& j2) {
  int a = 0, b = 0;
  for (int step = n <= 1 ? 1 : 1 << (32 - __clz(n - 1)); step > 0; step >>= 1) {
    const float ca = cdf[min(a + step, n) - 1];
    const float cb = cdf[min(b + step, n) - 1];
    a += (a + step <= n && ca <= u1) ? step : 0;
    b += (b + step <= n && cb <= u2) ? step : 0;
  }
  j1 = a < n - 1 ? a : n - 1;
  j2 = b < n - 1 ? b : n - 1;
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
  int* s_alias = s_q + n;                   // ALIAS only
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
      cdf_probe2(s_tab, n, u1[b], u2[b], j1, j2);
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

// Exclusive scan over the block of one count per thread, after the running
// total of earlier tiles in *base (which it advances); returns this
// thread's offset. Uses w[0, kTableWarps] as scratch; every thread calls it.
__device__ __forceinline__ int block_scan(int c, int* w, int* base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) w[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kTableWarps ? w[lane] : 0;
    int z = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, z, d);
      if (lane >= d) z += y;
    }
    if (lane < kTableWarps) w[lane] = z - v;
    if (lane == 31) w[kTableWarps] = z;
  }
  __syncthreads();
  const int off = *base + w[warp] + x - c;
  __syncthreads();
  if (threadIdx.x == 0) *base += w[kTableWarps];
  __syncthreads();
  return off;
}

__global__ void __launch_bounds__(kTableThreads) alias_table_kernel(
    const float* __restrict__ p, const unsigned char* __restrict__ active,
    int n, float* __restrict__ prob, int* __restrict__ alias) {
  // shared: val f32[kPads + n], lg f32[n + kWalkUnroll], ord u16[n],
  // drops u16[n + kWalkUnroll]. Walk position k holds bin ord[k]: smalls at
  // [0, ns0) in ascending index order with their deficit 1 - p in val[k],
  // larges at [ns0, n) in descending index order with their p. val[-kPads,
  // 0) are pads: a deficit of -inf never lets a large drop, so the walk's
  // state stays still once the smalls are spent.
  extern __shared__ float smem_f[];
  float* val = smem_f + kPads;
  float* lg = val + n;  // the walk's residual after each step
  unsigned short* ord = reinterpret_cast<unsigned short*>(lg + n + kWalkUnroll);
  unsigned short* drops = ord + n;  // drops before each step
  __shared__ int w_scan[kTableWarps + 1], s_small, s_scan;
  __shared__ int s_first, s_steps, s_end;
  if (threadIdx.x == 0) {
    s_first = n;
    s_small = s_scan = 0;
    s_end = 0x7fffffff;
  }
  if (threadIdx.x < kPads) smem_f[threadIdx.x] = __int_as_float(0xff800000);  // -inf
  __syncthreads();

  // 1. stable partition, one tile of kTableThreads bins at a time; the
  // smalls count up from 0, the larges down from n - 1
  for (int t0 = 0; t0 < n; t0 += kTableThreads) {
    const int i = t0 + threadIdx.x;
    const bool in = i < n;
    const float pi = in ? p[i] : 0.0f;
    const bool small = in && pi < 1.0f;  // NaN compares false: a large
    const bool large = in && !small;
    if (active != nullptr) {
      const unsigned ba = __ballot_sync(0xffffffffu, in && active[i]);
      if ((threadIdx.x & 31) == 0 && ba)
        atomicMin(&s_first, t0 + (threadIdx.x & ~31) + __ffs(ba) - 1);
    }
    const int ks = block_scan(small, w_scan, &s_small);  // the larges before i: i - ks
    if (small) {
      ord[ks] = (unsigned short)i;
      val[ks] = __fsub_rn(1.0f, pi);
    } else if (large) {
      ord[n - 1 - (i - ks)] = (unsigned short)i;
      val[n - 1 - (i - ks)] = pi;
    }
  }
  __syncthreads();
  const int ns0 = s_small, nl0 = n - ns0;

  // 2. the walk (see the top of the file). The exit test comes every
  // kWalkUnroll steps: the steps past the end only add to the log, which
  // phase 3 cuts where the walk ended.
  if (threadIdx.x == 0) {
    int steps = 0;
    if (ns0 > 0 && nl0 > 0) {
      const float* ps = val + ns0 - 1;  // the next small
      const float* pL = val + n - 1;    // the current large
      float s1 = ps[0], s2 = ps[-1];    // the next two smalls
      float pl = pL[0], n1 = pL[-1], n2 = pL[-2];  // the large, the next two
      bool pend = false;  // the last residual is the next small
      float a = 0.0f;     // its deficit
      for (;;) {
#pragma unroll
        for (int u = 0; u < kWalkUnroll; ++u) {
          // what this step may shift in, loaded before its store to the log
          // (which the compiler does not move loads across)
          const float y = ps[-2], x = pL[-3];
          // the large's residual mass, two explicit roundings as in the reference
          const float r = __fsub_rn(pl, pend ? a : s1);
          lg[steps + u] = r;
          const bool drop = r < 1.0f;
          a = __fsub_rn(1.0f, r);
          if (!pend) {
            s1 = s2;
            s2 = y;
            --ps;
          }
          if (drop) {
            pl = n1;
            n1 = n2;
            n2 = x;
            --pL;
          } else {
            pl = r;
          }
          pend = drop;
        }
        steps += kWalkUnroll;
        if ((ps < val && !pend) || pL < val + ns0) break;  // both stay true once true
      }
    }
    s_steps = steps;
  }
  __syncthreads();

  // 3. where the walk ended. drops[t] counts the drops before step t; step
  // t takes the last residual if step t-1 dropped, else an original small.
  // After step t, nl = nl0 - drops through t and ns = ns0 - originals taken
  // through t + (step t dropped); the first step after which either is 0
  // is the last one
  const int steps = s_steps;
  for (int t0 = 0; t0 < steps; t0 += kTableThreads) {
    const int t = t0 + threadIdx.x;
    const bool dr = t < steps && lg[t] < 1.0f;
    const int before = block_scan(dr, w_scan, &s_scan);
    if (t < steps) {
      drops[t] = (unsigned short)before;
      const int taken = t + 1 - before;  // steps through t that took an original
      if (nl0 - before - dr == 0 || ns0 - taken + dr == 0) atomicMin(&s_end, t);
    }
  }
  // 4. the write-out with the mask pass: every bin prob 1 aliasing itself,
  // then each step's small its prob and its large
  const int first = s_first;  // n if no worker is active
  const bool none = active != nullptr && first == n;
  for (int i = threadIdx.x; i < n; i += kTableThreads) {
    const bool on = active == nullptr || active[i];
    prob[i] = none || on ? 1.0f : 0.0f;
    alias[i] = none ? 0 : on ? i : first;
  }
  __syncthreads();
  const int last = steps > 0 ? s_end : -1;  // the walk's last step
  for (int t = threadIdx.x; t <= last; t += kTableThreads) {
    const bool pend = t > 0 && lg[t - 1] < 1.0f;
    const int j = drops[t];
    int bin;
    float pr;
    if (pend) {  // large j - 1's residual
      bin = ord[n - j];
      pr = lg[t - 1];
    } else {
      bin = ord[ns0 - 1 - (t - (t > 0 ? drops[t - 1] : 0))];
      pr = p[bin];
    }
    int a = ord[n - 1 - j];
    if (active != nullptr) {
      if (none) {
        pr = 1.0f;
        a = 0;
      } else {
        if (!active[bin]) pr = 0.0f;
        if (!active[a]) a = first;
      }
    }
    prob[bin] = pr;
    alias[bin] = a;
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

// active may be null (no mask)
int alias_table(const float* p, const unsigned char* active, int n,
                float* prob, int* alias, cudaStream_t stream) {
  if (n < 1 || n > kTableMaxN) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * 12 + 4 * kPads + 8 * kWalkUnroll;
  cudaError_t e = allow_smem(alias_table_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  alias_table_kernel<<<1, kTableThreads, smem, stream>>>(p, active, n, prob,
                                                         alias);
  return (int)cudaGetLastError();
}

const char* ppot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
