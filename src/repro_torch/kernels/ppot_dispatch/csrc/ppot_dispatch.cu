// PPoT-SQ(2) dispatch kernels and the alias-table build, for sm_90a.
//
// K1 is one kernel template, ppot_kernel_alias<KEYED>, behind two entries:
//
//   ppot_fused_alias_keyed  replaces ppot_dispatch_fused_alias
//                           (src/repro/kernels/ppot_dispatch/kernel.py,
//                           _fused_alias_kernel) together with the engine's
//                           counter-hash draws in front of it
//                           (src/repro/core/dispatch.py, _uniform_quad)
//   ppot_fused_alias        the same kernel on given uniforms: the Pallas
//                           kernel's own contract
//
// K2 and K3 share ppot_kernel_cdf<FOLD>:
//
//   ppot_fused_cdf    replaces ppot_dispatch_fused (same file, _fused_kernel)
//   ppot_select_cdf   replaces ppot_dispatch (same file, _kernel)
//
// and alias_table replaces build_alias_table after its scaling: the stack
// order, the n-step pairing fori_loop and the mask pass
// (src/repro/core/dispatch.py).
//
// Bound on an H100: K1 reads prob, alias and q (12n bytes) and the key, and
// writes workers and q_after: 16n + 4B bytes (+B with slots; its uniforms
// never touch device memory), 0.005 us at n = 1024, B = 128 and 0.03 us at
// n = 2048, B = 16384 at 3.35 TB/s. K2 moves 12n + 12B, K3 8n + 12B. Every
// dispatch kernel is bound by launch latency, not bytes or operations, so
// what it can save is the launches around it. Design answer: one launch per
// dispatch call, one thread per job, the [n] worker arrays staged once per
// block in shared memory and read there directly. The TPU version's one-hot
// MXU dots were a workaround for slow gathers; a shared-memory gather is one
// load here.
//
// K1 (ppot_kernel_alias): the launch is one thread-block cluster of c =
// ceil(B / 1024) blocks, at most 8 (the portable cluster size): a larger
// batch is taken in a loop by each thread, so B = 16384 runs as 8 blocks of
// 1024 threads and two jobs a thread, and B <= 1024 as a cluster of one.
//   1. Thread 0 of each block arms an mbarrier and stages prob, alias and q
//      by three TMA bulk copies (cp.async.bulk), one an array; the at most
//      three words before an array's first 16-byte boundary and the at most
//      three after its last are copied by threads.
//   2. While the copies are in flight every thread zeroes its part of the
//      block's histogram and draws its first job's four uniforms. Keyed,
//      that is the engine's counter hash (prng.uniform_quad), bit for bit
//      in native u32: the Weyl counter x = b 0x9E3779B9 + k0, h1 =
//      fmix32(x ^ k1 0x85EBCA6B), h2 = fmix32((x + 0x7F4A7C15) ^ k1
//      0xC2B2AE35), their 16-bit halves times 2^-16. The key's words come
//      from a device int64[2] (the scan turn's carry: a captured graph reads
//      each replay's key) or by value (a host key).
//   3. After the barrier, per job: two alias probes, SQ(2) with ties to j1,
//      workers[b] (-1 at an inactive slot) and, at an active slot, a
//      shared-memory atomicAdd into the block's histogram.
//   4. The fold: a cluster barrier, then block r writes bins [r n / c,
//      (r + 1) n / c) of q_after = q + the c histograms, read through
//      distributed shared memory. Every bin is written once: no global
//      atomics and no copy of q made by the caller, and integer sums are
//      exact in any order. A second cluster barrier keeps each histogram
//      alive until every block has read it.
// Shared memory: 16 + 3 (4n + 16) + 4n bytes, rounded to 16-byte regions,
// so n <= kAliasMaxN = 14524 fills the 227 KB a block may opt in to.
//
// K2's fold-back: the TPU kernel accumulated q_after in an output block
// that the sequential grid revisited. Here the caller seeds q_after with a
// copy of q, each block builds a shared-memory histogram of its own jobs
// and adds each nonzero bin with one global atomicAdd. Integer adds
// commute, so the result is exact whatever the order.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kAliasThreads = 1024;    // K1's largest block
constexpr int kAliasMinThreads = 128;  // K1's smallest block
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kAliasMaxN = 14524;      // alias_smem(kAliasMaxN) = 227 KB
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

// K2 (FOLD) and K3
template <bool FOLD>
__global__ void __launch_bounds__(kThreads) ppot_kernel_cdf(
    const float* __restrict__ cdf, const int* __restrict__ q,
    const float* __restrict__ u1, const float* __restrict__ u2, int n, int B,
    int* __restrict__ workers, int* __restrict__ q_after) {
  extern __shared__ int smem[];
  float* s_cdf = reinterpret_cast<float*>(smem);
  int* s_q = smem + n;
  int* s_hist = s_q + n;  // FOLD only
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_cdf[i] = cdf[i];
    s_q[i] = q[i];
    if (FOLD) s_hist[i] = 0;
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) {
    int j1, j2;
    cdf_probe2(s_cdf, n, u1[b], u2[b], j1, j2);
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

// ---------------------------------------------------------------------------
// K1: mbarrier and TMA bulk-copy primitives, the counter hash, the kernel
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

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// this block's shared memory; completion is counted (in bytes) on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// murmur3's finaliser, as prng.fmix32
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

struct AliasArgs {
  const float* prob;
  const int* alias;
  const int* q;
  const float *u1, *v1, *u2, *v2;  // unkeyed: the uniforms, f32[B]
  const long long* key;            // keyed: the route key on the device, or null
  uint32_t k0, k1;                 // keyed, key null: the key's words
  const unsigned char* active;     // bool[B], or null: every slot active
  int n, B;
  int* workers;
  int* q_after;
};

struct Quad {
  float u1, v1, u2, v2;
};

// job b's uniforms: prng.uniform_quad's (u1, u2, v1, v2) of the key (k0, k1),
// or read from the unkeyed entry's arrays (zeros past the batch)
template <bool KEYED>
__device__ __forceinline__ Quad draw(const AliasArgs& a, int b, uint32_t k0, uint32_t k1) {
  if constexpr (KEYED) {
    const uint32_t x = (uint32_t)b * 0x9E3779B9u + k0;
    const uint32_t h1 = fmix32(x ^ (k1 * 0x85EBCA6Bu));
    const uint32_t h2 = fmix32((x + 0x7F4A7C15u) ^ (k1 * 0xC2B2AE35u));
    const float s = 1.0f / 65536.0f;  // the 16-bit halves are exact in f32
    return Quad{(float)(h1 >> 16) * s, (float)(h2 >> 16) * s, (float)(h1 & 0xFFFFu) * s,
                (float)(h2 & 0xFFFFu) * s};
  }
  else {
    if (b >= a.B) return Quad{0.0f, 0.0f, 0.0f, 0.0f};
    return Quad{a.u1[b], a.v1[b], a.u2[b], a.v2[b]};
  }
}

// How an array of n 4-byte words is staged: the `head` words before its
// first 16-byte boundary and the words after the last whole 16 bytes by
// threads, the `body` words between by one bulk copy
struct Stage {
  int head, body;
};

__device__ __forceinline__ Stage stage_of(const void* src, int n) {
  const int head =
      min(n, (int)(((16u - ((uint32_t)reinterpret_cast<uintptr_t>(src) & 15u)) & 15u) >> 2));
  return Stage{head, (n - head) & ~3};
}

// a staged array's region: 4n bytes, 16 of slack, rounded up to 16 bytes
__host__ __device__ __forceinline__ int alias_region(int n) { return (4 * n + 31) & ~15; }

__host__ __device__ __forceinline__ size_t alias_smem(int n) {
  return 16 + 3 * (size_t)alias_region(n) + 4 * (size_t)n;
}

template <bool KEYED>
__global__ void __launch_bounds__(kAliasThreads) ppot_kernel_alias(const AliasArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  // shared: the mbarrier (16 bytes), the three staged arrays' regions, the
  // block's histogram. An array's word i sits at region + 16 + 4 (i - head),
  // so its bulk-copied words start on a 16-byte boundary
  extern __shared__ __align__(16) unsigned char smem_a[];
  const int n = a.n, tid = threadIdx.x, region = alias_region(n);
  unsigned char* r0 = smem_a + 16;
  const Stage st[3] = {stage_of(a.prob, n), stage_of(a.alias, n), stage_of(a.q, n)};
  const int* src[3] = {reinterpret_cast<const int*>(a.prob), a.alias, a.q};
  int* dst[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dst[k] = reinterpret_cast<int*>(r0 + k * region + 16) - st[k].head;
  const float* s_prob = reinterpret_cast<const float*>(dst[0]);
  const int* s_alias = dst[1];
  const int* s_q = dst[2];
  int* s_hist = reinterpret_cast<int*>(r0 + 3 * region);
  const uint32_t bar = smem_u32(smem_a);
  const uint32_t tx = 4u * (uint32_t)(st[0].body + st[1].body + st[2].body);

  if (tid == 0 && tx) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && tx) {
    mbar_expect_tx(bar, tx);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (st[k].body)
        bulk_load(smem_u32(dst[k] + st[k].head), src[k] + st[k].head, 4u * st[k].body, bar);
  }

  // while the copies are in flight: the key, the first job's draws, the
  // histogram's zeros and the words the bulk copies leave out
  uint32_t k0 = a.k0, k1 = a.k1;
  if (KEYED && a.key != nullptr) {
    k0 = (uint32_t)a.key[0];
    k1 = (uint32_t)a.key[1];
  }
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int stride = c * (int)blockDim.x;
  int b = rank * (int)blockDim.x + tid;
  Quad d = draw<KEYED>(a, b, k0, k1);
  for (int i = tid; i < n; i += blockDim.x) s_hist[i] = 0;
  if (tid < 24) {  // eight threads an array: its head, then its tail
    const int k = tid >> 3, t = tid & 7;
    const Stage sk = k == 0 ? st[0] : k == 1 ? st[1] : st[2];
    const int* from = k == 0 ? src[0] : k == 1 ? src[1] : src[2];
    int* to = k == 0 ? dst[0] : k == 1 ? dst[1] : dst[2];
    const int i = t < 4 ? t : sk.head + sk.body + t - 4;
    if (t < 4 ? i < sk.head : i < n) to[i] = from[i];
  }
  __syncthreads();
  if (tx) mbar_wait(bar, 0);

  for (; b < a.B; b += stride) {
    const int j1 = alias_probe(s_prob, s_alias, n, d.u1, d.v1);
    const int j2 = alias_probe(s_prob, s_alias, n, d.u2, d.v2);
    const int w = s_q[j2] < s_q[j1] ? j2 : j1;  // ties to j1
    const bool on = a.active == nullptr || a.active[b];
    a.workers[b] = on ? w : -1;
    if (on) atomicAdd(&s_hist[w], 1);
    d = draw<KEYED>(a, b + stride, k0, k1);
  }

  // the fold: this block's bins of q + every block's histogram
  cluster.sync();
  const int lo = (int)((long long)rank * n / c), hi = (int)((long long)(rank + 1) * n / c);
  for (int i = lo + tid; i < hi; i += blockDim.x) {
    int s = s_q[i];
    for (int r = 0; r < c; ++r) s += cluster.map_shared_rank(s_hist, r)[i];
    a.q_after[i] = s;
  }
  cluster.sync();  // no block leaves while another reads its histogram
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

template <bool FOLD>
int cdf_launch(const float* cdf, const int* q, const float* u1, const float* u2, int n,
               int B, int* workers, int* q_after, cudaStream_t stream) {
  const size_t smem = (size_t)n * 4 * (2 + (FOLD ? 1 : 0));
  const int blocks = (B + kThreads - 1) / kThreads;
  cudaError_t e = allow_smem(ppot_kernel_cdf<FOLD>, smem);
  if (e != cudaSuccess) return (int)e;
  ppot_kernel_cdf<FOLD><<<blocks, kThreads, smem, stream>>>(cdf, q, u1, u2, n, B, workers,
                                                            q_after);
  return (int)cudaGetLastError();
}

// K1 as one cluster: c blocks of `threads`, c * threads >= B up to 8 blocks
// of 1024, beyond which each thread loops
template <bool KEYED>
int alias_launch(const AliasArgs& a, cudaStream_t stream) {
  if (a.n < 1 || a.n > kAliasMaxN || a.B < 0) return (int)cudaErrorInvalidValue;
  const int need = (a.B + kAliasThreads - 1) / kAliasThreads;
  const int c = need < 1 ? 1 : need > kMaxCluster ? kMaxCluster : need;
  const int per = ((a.B + c - 1) / c + 31) & ~31;
  const int threads = per < kAliasMinThreads ? kAliasMinThreads
                      : per > kAliasThreads  ? kAliasThreads
                                             : per;
  const size_t smem = alias_smem(a.n);
  cudaError_t e = allow_smem(ppot_kernel_alias<KEYED>, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ppot_kernel_alias<KEYED>, a);
  const cudaError_t last = cudaGetLastError();  // read (and clear) either way
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

extern "C" {

// K1 on given uniforms. q_after is written whole (no seed needed)
int ppot_fused_alias(const float* prob, const int* alias, const int* q,
                     const float* u1, const float* v1, const float* u2,
                     const float* v2, int n, int B, int* workers,
                     int* q_after, cudaStream_t stream) {
  const AliasArgs a{prob, alias, q, u1, v1, u2, v2, nullptr, 0u, 0u, nullptr,
                    n, B, workers, q_after};
  return alias_launch<false>(a, stream);
}

// K1 drawing its own uniforms from the route key: the device key int64[2]
// `key` if not null, else the words (k0, k1). active (bool[B]) may be null
int ppot_fused_alias_keyed(const float* prob, const int* alias, const int* q,
                           const long long* key, unsigned k0, unsigned k1,
                           const unsigned char* active, int n, int B, int* workers,
                           int* q_after, cudaStream_t stream) {
  const AliasArgs a{prob, alias, q, nullptr, nullptr, nullptr, nullptr, key, k0, k1,
                    active, n, B, workers, q_after};
  return alias_launch<true>(a, stream);
}

int ppot_fused_cdf(const float* cdf, const int* q, const float* u1,
                   const float* u2, int n, int B, int* workers, int* q_after,
                   cudaStream_t stream) {
  return cdf_launch<true>(cdf, q, u1, u2, n, B, workers, q_after, stream);
}

int ppot_select_cdf(const float* cdf, const int* q, const float* u1,
                    const float* u2, int n, int B, int* workers,
                    cudaStream_t stream) {
  return cdf_launch<false>(cdf, q, u1, u2, n, B, workers, nullptr, stream);
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
