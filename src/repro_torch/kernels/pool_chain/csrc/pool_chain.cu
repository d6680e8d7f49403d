// The replica pool's submission chain of one serving turn, for sm_90a.
//
// pool_chain replaces XLA's inner lax.scan over a turn's submissions
// (pstep, src/repro/serving/scanloop.py:203-210), not a Pallas kernel. For
// every submission i, in order (benchmark jobs, probe bursts, then the
// arrival batch):
//
//   start[i] = max(arrival[i], free_at[w[i]])
//   done[i]  = start[i] + cost[i] / speed[w[i]]
//   free_at[w[i]] = done[i]                  (only where active[i])
//
// in f64 with the reference's rounding. Three entry points run one kernel:
// pool_chain takes the steps as arrays; pool_turn takes a turn's three
// groups as the turn holds them (benchmark replicas, -1 inactive; burst
// targets, -1 a pad; the batch's replicas, arrival times and costs),
// assembles the steps itself (a benchmark job or burst arrives at the
// turn's time, the batch's last arrival, at its fixed cost; a negative
// replica is inactive and submits to replica 0) and also writes the
// assembled replicas and active flags and the batch's responses
// done - arrival. pool_turn_tail adds a fourth group after the batch, the
// faulty turn's retry and speculative copies (the reference's faulty
// pstep, src/repro/serving/scanloop.py:501-530): R replicas, costs and
// gates, each arriving at the turn's time, active where its gate is set
// and its replica is not negative; pool_turn is pool_turn_tail with R = 0.
//
// Only steps on the same replica depend on each other: the recurrence is
// one chain per replica, in submission order. So one block, a thread for
// each replica or step in whole warps up to 1024 (a tiny turn is cheaper
// on a small block),
//   1. stages the steps in shared memory;
//   2. links the steps inside each tile of 32: every warp takes tiles in
//      turn, __match_any_sync groups a tile's lanes by replica, and each
//      lane links to the next lane of its group and marks whether it is
//      its group's first or last lane. Beside that every thread gathers a
//      step's speed and its replica's clock and divides cost / speed,
//      which no chain waits for;
//   3. stitches the tiles in order (one warp, M/32 steps): a group's first
//      lane follows last[w], its replica's last step before the tile, or
//      heads a chain; the group's last lane then becomes last[w];
//   4. walks every chain on a thread of its own: a thread takes each chain
//      head whose index is its own modulo the block, keeps the replica's
//      clock in a register, follows the links and writes each step's start
//      and done at the step's own index, then the final clock. Replicas
//      that no step touches are copied (nothing to do in place).
// A step of the walk is a max and an add on the register clock and the
// shared-memory load of the next link, with no store and reload of the
// clock. The source asks for the next step's loads before this step's
// arithmetic, but ptxas schedules the link's load after the add, so a
// step costs both latencies, about 70 cycles on an H100: that is what a
// long chain costs. The serial part of the link is step 3 alone, one read and
// one write of last[] a tile; the tile groups of step 2 run in all warps.
//
// Bound on an H100: pool_chain moves 16n + 37M bytes plus 8 for the speed
// of each distinct replica (free_at in and out; a step's w, arrival, cost,
// active, start and done); pool_turn in place moves 24 bytes for each
// distinct replica (its clock in and out, its speed) and 4 + 21 bytes a
// step (replica in; start, done, sub_w, act out), 24 a batch step
// (arrival, cost, response) and 9 a tail step (cost, gate): a few ns at
// 3.35 TB/s. What bounds it is the
// longest chain of these inputs: L dependent steps of a max and an f64 add,
// 8 cycles each, L * 8 cycles at the SM clock. The least time is the larger
// of the two.
//
// Traps:
//   * __match_any_sync takes the full mask, so every lane of a warp runs
//     every tile of that warp; the lanes past M hold distinct negative
//     sentinels, which match no replica and no other lane.
//   * The max propagates NaN from either side, as jnp.maximum does: a NaN
//     arrival starts a NaN chain, and a NaN clock carries on.
//   * __ddiv_rn, __dadd_rn and __dsub_rn round each operation to nearest:
//     nothing is contracted into a fused multiply-add, so done is the
//     reference's division then addition, bit for bit.
//   * Every step on one replica is one chain of length M on one thread,
//     the worst case: the walk then costs M steps of the link's
//     shared-memory round trip overlapped with the arithmetic, which must
//     stay shorter than the serial walk through a shared-memory clock it
//     replaces.
// Shared memory: 4n + 34M bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // the most threads a block takes
constexpr int kMaxN = 16384;
constexpr int kMaxM = 4096;
constexpr int kMaxSmem = 4 * kMaxN + 34 * kMaxM;  // 204,800 B < 227 KB
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStitch = 8;  // tiles whose flags the stitching warp reads ahead
constexpr unsigned char kFirst = 1, kLast = 2;  // a step's place in its tile's group

struct Params {
  const double* free_at;  // [n]; may be free_out itself
  const double* speeds;   // [n]
  // pool_chain: the steps as arrays
  const int* workers;     // [M]
  const double* arrivals; // [M]
  const double* costs;    // [M] (pool_turn: the batch's [k])
  const unsigned char* active;  // [M]
  // pool_turn: the turn's groups
  const int* fake_js;     // [mf]
  const int* burst;       // [bc]
  const double* times;    // [k]
  const int* tail_w;      // [R] (pool_turn_tail)
  const double* tail_cost;  // [R]
  const unsigned char* tail_gate;  // [R]
  double fake_cost, burst_cost;
  int n, M, mf, bc, k;
  double* start;          // [M]
  double* done;           // [M]
  double* free_out;       // [n]
  int* sub_w;             // [M] (pool_turn)
  unsigned char* act_out; // [M] (pool_turn)
  double* resp;           // [k] (pool_turn)
  int* chain_max;         // running max of the longest chain, or null
};

template <bool kTurn>
__global__ void __launch_bounds__(kThreads) pool_chain_kernel(Params p) {
  extern __shared__ double smem[];
  const int n = p.n, M = p.M, nt = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* arr = smem;      // [M]
  double* dur = arr + M;   // [M] cost, then cost / speed
  double* fa0 = dur + M;   // [M] the clock of the step's replica on entry
  int* last = reinterpret_cast<int*>(fa0 + M);  // [n]
  int* ws = last + n;      // [M]
  int* nxt = ws + M;       // [M] the next step on the same replica, or -1
  unsigned char* act = reinterpret_cast<unsigned char*>(nxt + M);  // [M]
  unsigned char* flag = act + M;  // [M] kFirst | kLast in its tile, then head
  const int mb = p.mf + p.bc;  // the batch's first step (pool_turn)
  const int mt = mb + p.k;     // the tail's first step (pool_turn)

  // 1. stage
  for (int r = threadIdx.x; r < n; r += nt) last[r] = -1;
  const double t = kTurn ? __ldg(p.times + p.k - 1) : 0.0;
  for (int i = threadIdx.x; i < M; i += nt) {
    int wi;
    double a, c;
    bool on;
    if (!kTurn) {
      wi = __ldg(p.workers + i);
      a = __ldg(p.arrivals + i);
      c = __ldg(p.costs + i);
      on = __ldg(p.active + i);
    } else if (i < mb) {
      wi = i < p.mf ? __ldg(p.fake_js + i) : __ldg(p.burst + i - p.mf);
      a = t;
      c = i < p.mf ? p.fake_cost : p.burst_cost;
      on = wi >= 0;
      wi = on ? wi : 0;
    } else if (i < mt) {
      wi = __ldg(p.workers + i - mb);
      a = __ldg(p.times + i - mb);
      c = __ldg(p.costs + i - mb);
      on = true;
    } else {
      wi = __ldg(p.tail_w + i - mt);
      a = t;
      c = __ldg(p.tail_cost + i - mt);
      on = __ldg(p.tail_gate + i - mt) && wi >= 0;
      wi = wi >= 0 ? wi : 0;
    }
    ws[i] = wi;
    arr[i] = a;
    dur[i] = c;
    act[i] = on;
    nxt[i] = -1;
    if (kTurn) {
      p.sub_w[i] = wi;
      p.act_out[i] = on;
    }
  }
  __syncthreads();

  // 2. link inside each tile of 32 steps (every warp, a tile at a time),
  //    gather and divide (every thread, a step at a time)
  for (int base = warp * 32; base < M; base += nt) {
    const int i = base + lane;
    const bool valid = i < M;
    const int wi = valid ? ws[i] : -1 - lane;
    const unsigned same = __match_any_sync(kFull, wi);
    const unsigned below = same & ((1u << lane) - 1u);
    if (valid) {
      if (below) nxt[base + 31 - __clz(below)] = i;
      flag[i] = (below ? 0 : kFirst) | ((same >> lane) == 1u ? kLast : 0);
    }
  }
  for (int i = threadIdx.x; i < M; i += nt) {
    const int wi = ws[i];
    fa0[i] = p.free_at[wi];
    dur[i] = __ddiv_rn(dur[i], __ldg(p.speeds + wi));
  }
  if (p.free_out != p.free_at)
    for (int r = threadIdx.x; r < n; r += nt) p.free_out[r] = p.free_at[r];
  __syncthreads();

  // 3. stitch the tiles in order (warp 0): a tile's first step of a replica
  //    follows the last one before the tile; kStitch tiles' flags and
  //    replicas are read ahead, so a tile costs one read and one write of
  //    last[] and two warp barriers. One tile needs no stitch: its groups'
  //    first steps are the heads
  const bool one_tile = M <= 32;
  if (warp == 0 && !one_tile) {
    for (int base0 = 0; base0 < M; base0 += 32 * kStitch) {
      unsigned char f[kStitch];
      int w[kStitch];
#pragma unroll
      for (int u = 0; u < kStitch; ++u) {
        const int i = base0 + 32 * u + lane;
        f[u] = i < M ? flag[i] : 0;
        w[u] = i < M ? ws[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kStitch; ++u) {
        const int i = base0 + 32 * u + lane;
        const int prev = (f[u] & kFirst) ? last[w[u]] : -1;
        __syncwarp();
        if (prev >= 0) nxt[prev] = i;
        if (i < M) flag[i] = (f[u] & kFirst) && prev < 0;
        if (f[u] & kLast) last[w[u]] = i;
        __syncwarp();
      }
    }
  }
  if (!one_tile) __syncthreads();

  // 4. walk each chain on its own thread, the next step's loads written
  //    before this step's arithmetic
  for (int h = threadIdx.x; h < M; h += nt) {
    if (!(one_tile ? flag[h] & kFirst : flag[h])) continue;
    double clk = fa0[h];
    int i = h, len = 0;
    double a = arr[i], du = dur[i];
    bool on = act[i];
    int next = nxt[i];
    for (;;) {
      const int j = next >= 0 ? next : i;
      const double a2 = arr[j], du2 = dur[j];
      const bool on2 = act[j];
      const int next2 = nxt[j];
      const double s = (a > clk || a != a) ? a : clk;
      const double d = __dadd_rn(s, du);
      p.start[i] = s;
      p.done[i] = d;
      if (kTurn && i >= mb && i < mt) p.resp[i - mb] = __dsub_rn(d, a);
      if (on) clk = d;
      ++len;
      if (next < 0) break;
      i = next;
      a = a2;
      du = du2;
      on = on2;
      next = next2;
    }
    p.free_out[ws[h]] = clk;
    if (p.chain_max != nullptr) atomicMax(p.chain_max, len);
  }
}

template <bool kTurn>
int launch(const Params& p, cudaStream_t stream) {
  if (p.n < 1 || p.n > kMaxN || p.M < 0 || p.M > kMaxM) return (int)cudaErrorInvalidValue;
  // set once, before any capture: the first launch of the one-program loop
  // is an eager warm-up turn
  static const cudaError_t attr = cudaFuncSetAttribute(
      pool_chain_kernel<kTurn>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = (size_t)p.n * 4 + (size_t)p.M * 34;
  // a thread for each replica or step, in whole warps, at most kThreads
  const int work = p.n > p.M ? p.n : p.M;
  const int threads = work >= kThreads ? kThreads : (work + 31) / 32 * 32;
  pool_chain_kernel<kTurn><<<1, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The steps as arrays. free_out may alias free_at.
int pool_chain(const double* free_at, const double* speeds, const int* workers,
               const double* arrivals, const double* costs,
               const unsigned char* active, int n, int M, double* start,
               double* done, double* free_out, cudaStream_t stream) {
  Params p{};
  p.free_at = free_at;
  p.speeds = speeds;
  p.workers = workers;
  p.arrivals = arrivals;
  p.costs = costs;
  p.active = active;
  p.n = n;
  p.M = M;
  p.start = start;
  p.done = done;
  p.free_out = free_out;
  return launch<false>(p, stream);
}

// A turn's groups and its tail: M = mf + bc + k + R steps, k >= 1, R >= 0
// (the tail's arrays may be null when R = 0). free_out may alias free_at;
// chain_max (an int, or null) is raised to the longest chain.
int pool_turn_tail(const double* free_at, const double* speeds, const int* fake_js,
                   const int* burst, const int* workers, const double* times,
                   const double* costs, const int* tail_w, const double* tail_cost,
                   const unsigned char* tail_gate, double fake_cost, double burst_cost,
                   int n, int mf, int bc, int k, int R, double* start, double* done,
                   int* sub_w, unsigned char* act, double* free_out, double* resp,
                   int* chain_max, cudaStream_t stream) {
  if (mf < 0 || bc < 0 || k < 1 || R < 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.free_at = free_at;
  p.speeds = speeds;
  p.fake_js = fake_js;
  p.burst = burst;
  p.workers = workers;
  p.times = times;
  p.costs = costs;
  p.tail_w = tail_w;
  p.tail_cost = tail_cost;
  p.tail_gate = tail_gate;
  p.fake_cost = fake_cost;
  p.burst_cost = burst_cost;
  p.n = n;
  p.M = mf + bc + k + R;
  p.mf = mf;
  p.bc = bc;
  p.k = k;
  p.start = start;
  p.done = done;
  p.sub_w = sub_w;
  p.act_out = act;
  p.free_out = free_out;
  p.resp = resp;
  p.chain_max = chain_max;
  return launch<true>(p, stream);
}

// A turn's three groups: pool_turn_tail with no tail.
int pool_turn(const double* free_at, const double* speeds, const int* fake_js,
              const int* burst, const int* workers, const double* times,
              const double* costs, double fake_cost, double burst_cost, int n,
              int mf, int bc, int k, double* start, double* done, int* sub_w,
              unsigned char* act, double* free_out, double* resp, int* chain_max,
              cudaStream_t stream) {
  return pool_turn_tail(free_at, speeds, fake_js, burst, workers, times, costs, nullptr,
                        nullptr, nullptr, fake_cost, burst_cost, n, mf, bc, k, 0, start,
                        done, sub_w, act, free_out, resp, chain_max, stream);
}

const char* pool_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
