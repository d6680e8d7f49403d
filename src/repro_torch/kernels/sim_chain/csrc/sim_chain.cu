// The chain simulator's round loop as one kernel, for sm_90a.
//
// Replaces the round function under lax.scan of the JAX package's chain
// simulator (src/repro/core/simulator.py:553-743; XLA, not Pallas) in its
// paper mode: one frontend synced every round, no environment, no
// telemetry. One block runs one chain for all its rounds; a launch takes a
// batch of chains that share their shapes (n workers, mt slots a job, the
// learner ring, the arrival window), each with its own policy, flags,
// rounds, speeds and draw columns.
//
// Every random quantity comes in as a column drawn before the launch
// (core/simulator.draw_rounds), so what is left is a sequential
// integer-and-float state machine. Its float operations are the plain
// chain's (kernels/sim_chain/ref.py) one for one: the file is built with
// -fmad=false (no contraction), division is IEEE, no transcendental is
// left, and every sum runs left to right as the plain chain's do (Σμ and
// the prefix sums of the alias scaling and the CDF; the ring sum of the
// learner refresh, lane 0 up). So the kernel equals its plain version bit
// for bit on the same draws.
//
// What bounds it on an H100: latency. A round is a chain of dependent
// steps that no thread can start before the previous round ends; the bytes
// (the draw columns in, the trace rows out: 52 B and 268 B a round at
// Fig. 8's n = 30) are far below the memory rate, and the chains of a batch
// run side by side on SMs of their own. The clock's add is the floor, ~4
// cycles a round. One warp alone on its scheduler pays ~4 cycles a
// dependent add, ~8-11 a shared access, ~29 a dependent shared load and
// ~24 for a little ALU work ending in a branch on data (kernel_variants.py's
// warp probe; PERF.md), so the design cuts instructions, shared accesses
// and branches from a round.
//
// Design, one warp a chain:
//  * The warp runs a round's scalar logic together, every lane on the
//    same values (loads of one shared word are broadcasts, stores of one
//    value to one word are one store), so no lane waits at a barrier for
//    another and the warp is at hand for the O(n) steps: the refresh (a
//    worker a lane), the table's scaling and stack partition
//    (__ballot_sync + __popc keep the stack order), the CDF's division and
//    its probe (a ballot count), the trace rows. Σμ, the prefix sums and
//    the pairing walk stay sequential, run alike by every lane. The walk
//    has no branch but its loop's: its current small and large are in
//    registers and the next two entries of both lists are loaded two steps
//    before a step can need them. Slots of a job are unrolled to MT (1, or
//    kMaxMt with mt at run time), so no array of the round leaves
//    registers; the policy test puts the probing policies first.
//  * Independent thread scheduling does not promise that the warp stays
//    converged, so a __syncwarp parts an event's reads of shared state from
//    its writes (which every lane makes alike, from registers), the writes
//    from the round's later reads, and a round from the next; the CDF's
//    prefix stores from its division likewise.
//  * State that a round reads together lies together: a worker's (q_fake,
//    s_real, busy, widx) is one 16-byte word, the alias table's (prob,
//    alias) one 8-byte word, and a round's trace fields one record of 16-byte
//    words, written out to their columns a tile at a time. A completion is
//    one branch and selects.
//  * Draw columns come in (cp.async, every column's copies at once) and
//    trace rows go out by tiles of R rounds staged in shared memory, moved
//    by the whole warp (the wrapper picks R from the shared memory the rings
//    leave, at most TILE_MAX); a round reads and writes shared memory only.
//  * The learner rings lie slot-major ([cap][rs], rs = n rounded up to 32
//    where the footprint allows, so worker i is on bank i % 32 whatever
//    slot it is read at). At a refresh every lane walks the warp's largest
//    window in one loop without a branch, its own k newest slots in
//    increasing slot (two ranges once the ring wrapped), adding +0 past its
//    own k: a sum that starts at +0 is never -0, so +0 changes nothing, as
//    the plain chain's invalid lanes add +0. Wraps are compare-and-subtract.
//  * The tables are rebuilt in one place, at the top of a round: from μ̂
//    after every refresh with the learner (λ̂ moves the window and with it
//    μ̂ at nearly every refresh, so a test for an unchanged μ̂ saves
//    nothing), from the phase's μ at a phase change with known speeds. The
//    acceptance thresholds μ(phase)/max μ are divided once a phase.
//
// Shared memory, in 4-byte words (kernel.smem_bytes): a tile region for
// each staged column, ((R·w + 3) & ~3) + 4 words for a column of width w
// (draws: six of 1, mt, 4·mt, J; the trace: a record of rec_words words,
// and n for the queue and μ̂ rows when traced), the rings 2·rs·cap, the
// stack 2·(n + 4), 12 arrays of n (the worker words count as four, the
// table's as two) and the arrival window S.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// -- per-phase clock: begin
// Built with -DSIM_CHAIN_CLOCKS (build.CLOCKED), lane 0 of a chain's warp,
// the chain's critical path, adds the clock64() cycles between two marks to
// the phase the second mark closes, and counts rounds by branch, refreshes,
// rebuilds and tiles; sim_chain_clocks copies the records of the first
// kClockChains chains out. Without the macro the marks compile to nothing.
enum { CK_SETUP, CK_HEAD, CK_ARRIVAL, CK_SERVICE, CK_FAKE, CK_REBUILD, CK_REFRESH, CK_TRACE,
       CK_TILE, CK_BARRIER, CK_PHASES };
enum { CN_ROUNDS = CK_PHASES, CN_ARRIVALS, CN_SERVICES, CN_FAKES, CN_REFRESHES, CN_REBUILDS,
       CN_TILES, CK_SLOTS };
#ifdef SIM_CHAIN_CLOCKS
constexpr int kClockChains = 64;
__device__ unsigned long long sim_chain_clock_rec[kClockChains * CK_SLOTS];
#define CLK_BEGIN()                          \
  unsigned long long clk_rec_[CK_SLOTS] = {}; \
  long long clk_t_ = clock64()
#define CLK(p)                                 \
  do {                                         \
    const long long clk_now_ = clock64();      \
    clk_rec_[p] += clk_now_ - clk_t_;          \
    clk_t_ = clk_now_;                         \
  } while (0)
#define CLK_COUNT(s) \
  do {               \
    clk_rec_[s] += 1; \
  } while (0)
#define CLK_END(c)                                                        \
  do {                                                                    \
    if (threadIdx.x == 0 && (c) < kClockChains) {                         \
      _Pragma("unroll") for (int s_ = 0; s_ < CK_SLOTS; ++s_)             \
          sim_chain_clock_rec[(size_t)(c) * CK_SLOTS + s_] = clk_rec_[s_]; \
    }                                                                     \
  } while (0)
extern "C" int sim_chain_clocks(unsigned long long* out, int chains) {
  const int k = chains < kClockChains ? chains : kClockChains;
  return (int)cudaMemcpyFromSymbol(out, sim_chain_clock_rec,
                                   sizeof(unsigned long long) * k * CK_SLOTS);
}
#else
#define CLK_BEGIN() \
  do {              \
  } while (0)
#define CLK(p) \
  do {         \
  } while (0)
#define CLK_COUNT(s) \
  do {               \
  } while (0)
#define CLK_END(c) \
  do {             \
  } while (0)
#endif
// -- per-phase clock: end

namespace {

enum { POLICY, ROUNDS, USE_LEARNER, USE_FAKE, FAKE_CAP, REFRESH, FOLD, USE_TABLE,
       THEORY, PHASES, NI };
enum { MU_BAR, PERIOD, NU_MAX, C0, C_WINDOW, THEORY_NUM, NF };
// core/policies.ALL_POLICIES, in order
enum { UNIFORM, POT, PSS, PPOT_SQ2, PPOT_LL2, BANDIT, HALO, SPARROW };
enum { EV_ARRIVAL, EV_REAL_DONE, EV_FAKE_DONE, EV_FAKE_DISPATCH, EV_SELF_LOOP };

constexpr int kThreads = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxMt = 8;
constexpr float kAvgWindowMult = 2.25f;
// arrays of n words (the worker records as four, the table's pairs as
// two), beside the stack, 2·(n + 4)
constexpr int kStateArrays = 12;

struct Cols {
  const float* __restrict__ dt;
  const int* __restrict__ ev;
  const float* __restrict__ u_svc;
  const float* __restrict__ u_fake;
  const int* __restrict__ j_fake;
  const int* __restrict__ n_tasks;
  const int* __restrict__ pins;
  const float* __restrict__ u;
  const int* __restrict__ j;
};

struct Trace {
  int* code;
  int* worker;
  int* n_tasks;
  int* task_workers;
  int* task_targets;
  int* frontend;
  int* view_gap;  // view_gap, sync_age and killed_fake are 0 in this mode:
  float* sync_age;  // the wrapper's zeros stand, unwritten
  float* now;
  float* lam_hat;
  int* killed_fake;
  int* q_real;  // null when not traced
  float* mu_hat;
};

struct Final {
  float* now;
  int* q_real;
  int* q_fake;
  int* s_real;
  float* busy_start;
  float* arr_times;
  int* arr_idx;
  int* arr_count;
  float* lam_hat;
  float* samples;
  float* stamps;
  int* widx;
  int* count;
  float* epoch_start;
  float* mu_hat;
};

// A staged column's tile region, in words.
__host__ __device__ constexpr int col_words(int R, int w) { return ((R * w + 3) & ~3) + 4; }

__device__ __forceinline__ int word_shift(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Starts the copy of count words from device memory to the 16-byte aligned
// region dst, at dst + (src's word offset mod 4), so that all but at most
// 3 + 3 words move as aligned 16-byte copies; returns that offset. The
// copies run asynchronously (cp.async), every column's at once, until
// cp.async.wait_all.
__device__ __forceinline__ int stage_in(uint32_t* dst, const uint32_t* __restrict__ src,
                                        int count, int lane) {
  const int sh = word_shift(src);
  uint32_t* d = dst + sh;
  const int head = min((4 - sh) & 3, count);
  if (lane < head) cp_async(d + lane, src + lane, 4);
  const int body = (count - head) >> 2;
  for (int i = lane; i < body; i += kThreads) cp_async(d + head + 4 * i, src + head + 4 * i, 16);
  for (int i = head + 4 * body + lane; i < count; i += kThreads) cp_async(d + i, src + i, 4);
  return sh;
}

// The way back: count words staged at src (at the offset word_shift(dst))
// to device memory at dst, 16 bytes a lane where aligned.
__device__ __forceinline__ void stage_out(uint32_t* dst, const uint32_t* src, int count,
                                          int lane) {
  const int head = min((4 - word_shift(dst)) & 3, count);
  if (lane < head) dst[lane] = src[lane];
  const int body = (count - head) >> 2;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
#pragma unroll 4
  for (int i = lane; i < body; i += kThreads) d4[i] = s4[i];
  for (int i = head + 4 * body + lane; i < count; i += kThreads) dst[i] = src[i];
}

// The words of a round's trace record: code, worker, n_tasks, now, lam_hat,
// MT slot workers, MT slot targets, padded to 16 bytes.
__host__ __device__ constexpr int rec_words(int mt) { return (5 + 2 * mt + 3) & ~3; }

template <int W>
__device__ __forceinline__ void put_record(uint32_t* dst, const uint32_t* rec) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q)
    reinterpret_cast<uint4*>(dst)[q] = make_uint4(rec[4 * q], rec[4 * q + 1], rec[4 * q + 2],
                                                  rec[4 * q + 3]);
}

template <int W>
__device__ __forceinline__ void get_record(const uint32_t* src, uint32_t* rec) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const uint4 v = reinterpret_cast<const uint4*>(src)[q];
    rec[4 * q] = v.x, rec[4 * q + 1] = v.y, rec[4 * q + 2] = v.z, rec[4 * q + 3] = v.w;
  }
}

template <typename T>
__device__ __forceinline__ uint32_t* words(T* p) {
  return reinterpret_cast<uint32_t*>(p);
}
template <typename T>
__device__ __forceinline__ const uint32_t* words(const T* p) {
  return reinterpret_cast<const uint32_t*>(p);
}

// Batches of kBatch loads issued ahead of their adds. A sum that starts at
// +0 is never -0, so adding +0 for the padding past its end leaves it bit
// for bit as it was: loops run whole batches, with no tail.
constexpr int kBatch = 8;

// x[0] + ... + x[n - 1], left to right from +0
__device__ __forceinline__ float sum_in_order(const float* x, int n) {
  float s = 0.0f;
  for (int l = 0; l < n; l += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const float y = x[min(l + q, n - 1)];
      v[q] = l + q < n ? y : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) s = s + v[q];
  }
  return s;
}

// A round's record into its row of each trace column (frontend: 0 for an
// arrival's, else -1).
template <int MT>
__device__ __forceinline__ void put_trace(const Trace& tr, size_t row, int mt,
                                          const uint32_t* rec) {
  tr.code[row] = rec[0];
  tr.worker[row] = rec[1];
  tr.n_tasks[row] = rec[2];
  tr.now[row] = __uint_as_float(rec[3]);
  tr.lam_hat[row] = __uint_as_float(rec[4]);
  tr.frontend[row] = (int)rec[0] == EV_ARRIVAL ? 0 : -1;
#pragma unroll
  for (int b = 0; b < MT; ++b) {
    if (b < mt) {
      tr.task_workers[row * mt + b] = rec[5 + b];
      tr.task_targets[row * mt + b] = rec[5 + MT + b];
    }
  }
}

// The view's tables from mu, as ref.py builds them, by the whole warp: Σμ
// left to right (no mass gives uniform weights); cdf: the prefix sums over
// their last; table: tab[i] = (prob bits, alias) from the scaled weights
// w · (n / Σw), smalls then larges in index order (stk[2..n + 1]: (index,
// weight bits); two guards at each end) and the reference's pairing walk.
__device__ __forceinline__ void build_views(const float* mu, int n, bool table, int2* stk,
                                            int2* tab, float* cdf, int lane) {
  const float total = sum_in_order(mu, n);
  const bool guard = total > 0.0f;
  if (!table) {
    float c = 0.0f;
    for (int l = 0; l < n; l += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const float y = mu[min(l + q, n - 1)];
        v[q] = l + q < n ? (guard ? y : 1.0f) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        c = c + v[q];
        if (l + q < n) cdf[l + q] = c;
      }
    }
    __syncwarp();  // every lane's prefix stores before any division
    for (int i = lane; i < n; i += kThreads) cdf[i] = cdf[i] / c;
    __syncwarp();
    return;
  }
  // Σ of the weights: Σμ, or n ones added left to right, which is n
  const float f = (float)n / (guard ? total : (float)n);
  const unsigned below = (1u << lane) - 1u;
  int ns = 0;
  if (n > kThreads)  // the smalls of every chunk first: the larges follow them
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + lane;
      const float pv = i < n ? (guard ? mu[i] : 1.0f) * f : 0.0f;
      ns += __popc(__ballot_sync(kFull, i < n && pv < 1.0f));
    }
  int ks = 0, kl = ns;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + lane;
    const bool in = i < n;
    const float pv = in ? (guard ? mu[i] : 1.0f) * f : 0.0f;
    const bool small = in && pv < 1.0f;  // NaN counts as large
    const unsigned bs = __ballot_sync(kFull, small), bl = __ballot_sync(kFull, in && !small);
    if (n <= kThreads) ns = kl = __popc(bs);  // one chunk, one pass
    if (in) {
      const int pos = small ? ks + __popc(bs & below) : kl + __popc(bl & below);
      stk[2 + pos] = make_int2(i, __float_as_int(pv));
      tab[i] = make_int2(__float_as_int(1.0f), i);
    }
    ks += __popc(bs);
    kl += __popc(bl);
  }
  __syncwarp();
  // The walk: the top small (the residual of a large that fell below 1
  // takes its place) against the first large left, without a branch but
  // the loop's own; the two next entries of both lists are in registers,
  // loaded two steps before a step can need them.
  int nsr = ns, nl = n - ns;
  if (nsr == 0 || nl == 0) return;
  const int2 *ps = stk + 1 + ns, *pl = stk + 2 + ns;  // the top small, the large
  int sm = ps->x, lg = pl->x;
  float psm = __int_as_float(ps->y), plg = __int_as_float(pl->y);
  int2 s1 = ps[-1], s2 = ps[-2], l1 = pl[1], l2 = pl[2];
  while (true) {
    tab[sm] = make_int2(__float_as_int(psm), lg);
    const float r = plg - (1.0f - psm);  // the large's residual mass
    const bool lt = r < 1.0f;            // it becomes the top small, else the next small comes
    nl -= lt;
    nsr -= !lt;
    if (nl == 0 || nsr == 0) break;
    const int2 res = make_int2(lg, __float_as_int(r));
    const int2 top = lt ? res : s1, large = lt ? l1 : res;
    sm = top.x;
    psm = __int_as_float(top.y);
    lg = large.x;
    plg = __int_as_float(large.y);
    pl += lt;
    ps -= !lt;
    const int2 ns2 = ps[-2], nl2 = pl[2];
    s1 = lt ? s1 : s2;
    s2 = lt ? s2 : ns2;
    l1 = lt ? l2 : l1;
    l2 = lt ? nl2 : l2;
  }
  __syncwarp();
}

__device__ __forceinline__ int alias_probe(const int2* tab, int n, float u, float v) {
  int bin = (int)(u * (float)n);
  bin = bin < n - 1 ? bin : n - 1;
  const int2 e = tab[bin];
  return v < __int_as_float(e.x) ? bin : e.y;
}

// #{i : cdf[i] <= u} clipped to n - 1, by a ballot over the warp
__device__ __forceinline__ int cdf_probe(const float* cdf, int n, float u, int lane) {
  int c = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + lane;
    c += __popc(__ballot_sync(kFull, i < n && cdf[i] <= u));
  }
  return c < n - 1 ? c : n - 1;
}

// MT: the slots a job, 1, or kMaxMt with mt at run time
template <int MT>
__global__ void __launch_bounds__(kThreads, 1) sim_chain_kernel(
    const int* __restrict__ conf_i, const float* __restrict__ conf_f,
    const float* __restrict__ mu_sched, const float* __restrict__ mu_hat0, Cols cols,
    int T, int n, int mt, int J, int K, int S, int cap, int rs, int R, Trace tr, Final fin) {
  const int c = blockIdx.x, lane = threadIdx.x;
  const int mt_ = MT == 1 ? 1 : mt;
  CLK_BEGIN();
  const int* ci = conf_i + (size_t)c * NI;
  const float* cf = conf_f + (size_t)c * NF;
  const int policy = ci[POLICY], rounds = ci[ROUNDS], phases = ci[PHASES];
  const int refresh = ci[REFRESH], fold = ci[FOLD], fake_cap = ci[FAKE_CAP];
  const bool use_learner = ci[USE_LEARNER], use_fake = ci[USE_FAKE];
  const bool use_table = ci[USE_TABLE], theory = ci[THEORY];
  const float mu_bar = cf[MU_BAR], period = cf[PERIOD], nu_max = cf[NU_MAX];
  const float c0 = cf[C0], c_window = cf[C_WINDOW], theory_num = cf[THEORY_NUM];
  const float* sched = mu_sched + (size_t)c * K * n;
  const bool probes_mu =
      policy == PSS || policy == PPOT_SQ2 || policy == PPOT_LL2 || policy == BANDIT;
  // the view of μ̂ (learner) or of the phase's μ (known speeds, and Halo's)
  const bool learner_view = probes_mu && use_learner;
  const bool phase_view = (probes_mu && !use_learner) || policy == HALO;
  const bool table = use_table && policy != HALO;
  const bool two_probes = policy == PPOT_SQ2 || policy == PPOT_LL2 || policy == BANDIT;
  const bool one_phase = phases == 1 || isinf(period);
  const bool tq = tr.q_real != nullptr, tm = tr.mu_hat != nullptr;

  // shared memory: the tile regions, the worker words, the table's stack
  // and pairs, the rings, the rest of the state, the arrival window
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* next = smem;
  auto region = [&](int w) {
    uint32_t* r = next;
    next += col_words(R, w);
    return r;
  };
  uint32_t *b_dt = region(1), *b_ev = region(1), *b_usvc = region(1), *b_ufake = region(1),
           *b_jfake = region(1), *b_nt = region(1), *b_pins = region(mt),
           *b_u = region(4 * mt), *b_j = region(J);
  // the trace: a record of kRec words a round (code, worker, n_tasks, now,
  // lam_hat, then the slots' workers and targets), and the queue and μ̂
  // rows
  constexpr int kRec = rec_words(MT);
  uint32_t *o_rec = region(kRec), *o_q = region(tq ? n : 0), *o_mu = region(tm ? n : 0);
  // a worker's (q_fake, s_real, busy bits, widx), one 16-byte load
  int4* wst = reinterpret_cast<int4*>(next);
  int2* stk = reinterpret_cast<int2*>(wst + n);
  int2* tab = stk + n + 4;                      // the alias table: (prob bits, alias)
  float* cdf = reinterpret_cast<float*>(tab);  // or the CDF
  float* samples = reinterpret_cast<float*>(tab + n);
  float* stamps = samples + (size_t)rs * cap;
  float* epoch = stamps + (size_t)rs * cap;
  float* mu_hat = epoch + n;
  float* mu_built = mu_hat + n;  // the phase's μ, for the phase view
  float* thr = mu_built + n;     // μ(phase) / max μ, the service acceptance
  int* q_real = reinterpret_cast<int*>(thr + n);
  int* count = q_real + n;
  float* arr_times = reinterpret_cast<float*>(count + n);
  // slot l of worker i; rs, a multiple of 32 where the footprint allows,
  // puts every worker on the bank of its lane whatever slot it reads
  auto ring = [&](int l, int i) { return l * rs + i; };

  for (int i = lane; i < n; i += kThreads) {
    wst[i] = make_int4(0, 0, __float_as_int(0.0f), 0);
    epoch[i] = 0.0f;
    mu_hat[i] = mu_hat0[(size_t)c * n + i];
    q_real[i] = count[i] = 0;
  }
  for (int i = lane; i < rs * cap; i += kThreads) samples[i] = stamps[i] = 0.0f;
  for (int i = lane; i < S; i += kThreads) arr_times[i] = 0.0f;
  __syncwarp();
  // the scalar state, the same in every lane; mu_lane: μ̂ of worker lane
  // while n <= 32; rebuild: the learner's view is to be built from μ̂
  float now = 0.0f, lam_hat = 0.0f;
  float mu_lane = lane < n ? mu_hat0[(size_t)c * n + lane] : 0.0f;
  int arr_idx = 0, arr_count = 0, cur_phase = -1, until_refresh = 0;
  bool rebuild = learner_view;
  const float nu_den = fmaxf(nu_max, 1e-30f);
  CLK(CK_SETUP);

  for (int t0 = 0; t0 < rounds; t0 += R) {
    const int rt = min(R, rounds - t0);
    const size_t row0 = (size_t)c * T + t0;
    const float* s_dt = reinterpret_cast<const float*>(
        b_dt + stage_in(b_dt, words(cols.dt + row0), rt, lane));
    const int* s_ev = reinterpret_cast<const int*>(
        b_ev + stage_in(b_ev, words(cols.ev + row0), rt, lane));
    const float* s_usvc = reinterpret_cast<const float*>(
        b_usvc + stage_in(b_usvc, words(cols.u_svc + row0), rt, lane));
    const float* s_ufake = reinterpret_cast<const float*>(
        b_ufake + stage_in(b_ufake, words(cols.u_fake + row0), rt, lane));
    const int* s_jfake = reinterpret_cast<const int*>(
        b_jfake + stage_in(b_jfake, words(cols.j_fake + row0), rt, lane));
    const int* s_nt = reinterpret_cast<const int*>(
        b_nt + stage_in(b_nt, words(cols.n_tasks + row0), rt, lane));
    const int* s_pins = reinterpret_cast<const int*>(
        b_pins + stage_in(b_pins, words(cols.pins + row0 * mt), rt * mt, lane));
    const float* s_u = reinterpret_cast<const float*>(
        b_u + stage_in(b_u, words(cols.u + row0 * 4 * mt), rt * 4 * mt, lane));
    const int* s_j = reinterpret_cast<const int*>(
        b_j + stage_in(b_j, words(cols.j + row0 * J), rt * J, lane));
    // this tile's queue and μ̂ rows, staged at the offset their device rows
    // have mod 16 bytes
    int* w_q = reinterpret_cast<int*>(o_q + word_shift(tr.q_real + (tq ? row0 * n : 0)));
    float* w_mu = reinterpret_cast<float*>(o_mu + word_shift(tr.mu_hat + (tm ? row0 * n : 0)));
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    CLK(CK_TILE);

    for (int r = 0; r < rt; ++r) {
      now = now + s_dt[r];
      const int ev = s_ev[r];
      const int phase = one_phase ? 0 : ((int)(now / period)) % phases;
      CLK(CK_HEAD);
      if (rebuild || phase != cur_phase) {  // one branch a round for both
        if (phase != cur_phase) {  // the acceptance thresholds and the phase's view
          cur_phase = phase;
          const float* mu_now = sched + (size_t)phase * n;
#pragma unroll 1
          for (int i = lane; i < n; i += kThreads) {
            float m = sched[i];
            for (int k = 1; k < phases; ++k) m = fmaxf(m, sched[(size_t)k * n + i]);
            thr[i] = mu_now[i] / fmaxf(m, 1e-30f);
            if (phase_view) mu_built[i] = mu_now[i];
          }
          __syncwarp();
          rebuild = rebuild || phase_view;
          CLK(CK_HEAD);
        }
        if (rebuild) {  // the one place the tables are built
          build_views(learner_view ? mu_hat : mu_built, n, table, stk, tab, cdf, lane);
          rebuild = false;
          CLK(CK_REBUILD);
          CLK_COUNT(CN_REBUILDS);
        }
      }
      int code = EV_SELF_LOOP, worker = -1, nt = 0;
      int w[MT], tgt[MT];
      if (ev == 0) {  // an arrival
        code = EV_ARRIVAL;
        nt = s_nt[r];
        arr_times[arr_idx] = now;
        arr_idx = arr_idx + 1 == S ? 0 : arr_idx + 1;
        arr_count += 1;
        const int k = arr_count < S ? arr_count : S;
        const float oldest = arr_count >= S ? arr_times[arr_idx] : arr_times[0];
        const float span = now - oldest;
        if (k >= 2 && span > 0.0f) lam_hat = (float)(k - 1) / span;
        const float* mu_view = use_learner ? mu_hat : mu_built;
        const int* pins = s_pins + r * mt_;
        const float* u = s_u + r * 4 * mt_;
        const int* jj = s_j + r * J;
        // q_work: the engine's view (re-snapshotted after each chunk); the
        // true queue is folded at the end. Kept as per-slot counts over
        // q_real so that q_real stays the snapshot until the fold. Every
        // loop over slots is unrolled to MT, so w, tgt and load stay in
        // registers.
        if (policy == SPARROW) {
          const int probes = 2 * mt_;
          int load[2 * MT];
#pragma unroll
          for (int q = 0; q < 2 * MT; ++q) {
            if (q < probes) {
              const int wq = jj[q];
              int l = q_real[wq];
#pragma unroll
              for (int b = 0; b < MT; ++b)
                l += (b < mt_ && b < nt && pins[b] == wq);  // pins first
              load[q] = l;
            }
          }
          // the k-th active unpinned slot takes the k-th greedy pick: least
          // load, earliest probe
#pragma unroll
          for (int b = 0; b < MT; ++b) {
            if (b < mt_) {
              if (b >= nt) {
                w[b] = -1;
              } else if (pins[b] >= 0) {
                w[b] = pins[b];
              } else {
                int best = 0, least = load[0];
#pragma unroll
                for (int q = 1; q < 2 * MT; ++q)
                  if (q < probes && load[q] < least) best = q, least = load[q];
                const int wb = jj[best];
                w[b] = wb;
#pragma unroll
                for (int q = 0; q < 2 * MT; ++q)
                  if (q < probes) load[q] += jj[q] == wb;
              }
            }
          }
        } else {
          const int chunks = fold < 1 ? 1 : (fold > mt_ ? mt_ : fold);
          const int cs = (mt_ + chunks - 1) / chunks;
#pragma unroll
          for (int b = 0; b < MT; ++b) {
            if (b < mt_) {
              // the queue the slot sees: the snapshot plus the active
              // slots of earlier chunks
              const int placed = b - b % cs;
              auto qv = [&](int x) {
                int v = q_real[x];
#pragma unroll
                for (int a = 0; a < MT; ++a) v += (a < b && a < placed && a < nt && w[a] == x);
                return v;
              };
              auto probe = [&](int ui, int vi) {
                return table ? alias_probe(tab, n, u[ui * mt_ + b], u[vi * mt_ + b])
                             : cdf_probe(cdf, n, u[ui * mt_ + b], lane);
              };
              int sel;
              if (two_probes) {
                const int j1 = probe(0, 2), j2 = probe(1, 3);
                if (policy == PPOT_LL2) {
                  const float w1 = ((float)qv(j1) + 1.0f) / fmaxf(mu_view[j1], 1e-9f);
                  const float w2 = ((float)qv(j2) + 1.0f) / fmaxf(mu_view[j2], 1e-9f);
                  sel = w1 <= w2 ? j1 : j2;
                } else {
                  sel = qv(j1) <= qv(j2) ? j1 : j2;
                  if (policy == BANDIT && jj[mt_ + b] != 0) sel = jj[b];
                }
              } else if (policy == PSS) {
                sel = probe(0, 2);
              } else if (policy == POT) {
                const int j1 = jj[b], j2 = jj[mt_ + b];
                sel = qv(j1) <= qv(j2) ? j1 : j2;
              } else if (policy == HALO) {
                sel = cdf_probe(cdf, n, u[b], lane);
              } else {  // uniform
                sel = jj[b];
              }
              if (pins[b] >= 0) sel = pins[b];
              w[b] = b < nt ? sel : -1;
            }
          }
        }
        // completion targets on the true queues, the queues after the fold
        // (a worker's last slot holds its total) and the idle test, all on
        // the queues before it; then the busy clocks and the fold
        int qn[MT];
        bool idle[MT];
#pragma unroll
        for (int b = 0; b < MT; ++b) {
          if (b < mt_ && b < nt) {
            const int wb = w[b];
            int rank = 0;
#pragma unroll
            for (int a = 0; a < MT; ++a) rank += a < b && w[a] == wb;
            const int4 ws = wst[wb];
            const int q = q_real[wb];
            tgt[b] = ws.y + q + rank + 1;
            qn[b] = q + rank + 1;
            idle[b] = q + ws.x == 0;
          }
        }
        __syncwarp();  // every lane's reads before any lane's writes
        // (an idle worker given two slots is set twice to the same now)
#pragma unroll
        for (int b = 0; b < MT; ++b) {
          if (b < mt_ && b < nt) {
            if (idle[b]) wst[w[b]].z = __float_as_int(now);
            q_real[w[b]] = qn[b];
          }
        }
        CLK(CK_ARRIVAL);
        CLK_COUNT(CN_ARRIVALS);
      } else if (ev <= n) {  // a potential service event
        const int wv = ev - 1;
        worker = wv;
        const bool accept = s_usvc[r] < thr[wv];
        const int qr = q_real[wv], cnt = count[wv];
        const int4 ws = wst[wv];
        const bool do_real = accept && qr > 0;
        const bool do_fake = accept && qr <= 0 && ws.x > 0;
        __syncwarp();  // every lane's reads before any lane's writes
        if (do_real || do_fake) {  // a completion: one branch, the rest selects
          const int slot = ws.w;
          samples[ring(slot, wv)] = now - __int_as_float(ws.z);
          stamps[ring(slot, wv)] = now;
          count[wv] = cnt + 1;
          q_real[wv] = qr - do_real;
          wst[wv] = make_int4(ws.x - do_fake, ws.y + do_real, __float_as_int(now),
                              slot + 1 == cap ? 0 : slot + 1);
          code = do_real ? EV_REAL_DONE : EV_FAKE_DONE;
        }
        CLK(CK_SERVICE);
        CLK_COUNT(CN_SERVICES);
      } else {  // a potential benchmark-job dispatch
        const int jf = s_jfake[r];
        worker = jf;
        const float nu = c0 * fmaxf(mu_bar - lam_hat, 0.0f);
        const bool accept = s_ufake[r] < nu / nu_den;
        const int4 ws = wst[jf];
        __syncwarp();  // every lane's reads before any lane's writes
        if (accept && use_fake && ws.x < fake_cap) {
          const bool idle = q_real[jf] + ws.x == 0;
          wst[jf] = make_int4(ws.x + 1, ws.y, idle ? __float_as_int(now) : ws.z, ws.w);
          code = EV_FAKE_DISPATCH;
        }
        CLK(CK_FAKE);
        CLK_COUNT(CN_FAKES);
      }
      __syncwarp();  // the event's writes before the refresh and the rows read them
      {
        uint32_t rec[kRec];
        rec[0] = code;
        rec[1] = worker;
        rec[2] = nt;
        rec[3] = __float_as_uint(now);
        rec[4] = __float_as_uint(lam_hat);
#pragma unroll
        for (int b = 0; b < MT; ++b) {
          rec[5 + b] = b < nt ? w[b] : -1;
          rec[5 + MT + b] = b < nt ? tgt[b] : -1;
        }
#pragma unroll
        for (int x = 5 + 2 * MT; x < kRec; ++x) rec[x] = 0;
        put_record<kRec>(o_rec + r * kRec, rec);
      }
      CLK(CK_TRACE);
      if (use_learner && until_refresh == 0) {
        // the window parameters (core/learner.window_params), the same f32
        // operations in every lane
        float alpha = lam_hat / fmaxf(mu_bar, 1e-9f);
        alpha = fminf(fmaxf(alpha, 0.0f), 0.999f);
        const float one_a = 1.0f - alpha;
        const float eps = 0.3f * one_a;
        const float avg_rate = mu_bar / (float)n;
        const float mu_star = one_a / 10.0f * avg_rate;
        const float L_f = theory ? theory_num / fmaxf(eps * eps, 1e-6f)
                                 : c_window / fmaxf(one_a, 1e-3f);
        int L = (int)ceilf(L_f);
        L = L < 1 ? 1 : (L > cap ? cap : L);
        int L_avg = (int)(kAvgWindowMult * (float)L);
        L_avg = L_avg < cap ? L_avg : cap;
        const float num = 1.0f - eps;
        const float horizon = (1.0f + eps) * (float)L / fmaxf(mu_star, 1e-9f);
        for (int base = 0; base < n; base += kThreads) {
          const int i = base + lane;
          const bool in = i < n;
          const int cnt = in ? count[i] : 0, wi = in ? wst[i].w : 0;
          // the k newest slots, in increasing slot: [a0, a0 + len0), then
          // [a1, cap) once the ring wrapped. Every lane walks the warp's
          // largest k without a branch: its element qq sits at slot
          // a0 + qq, or qq + jump past len0 (clamped into the ring, and
          // +0 past its own k: exact, samples are >= +0).
          const int k = cnt < L_avg ? cnt : L_avg;
          const int lo = wi - k, a0 = lo < 0 ? 0 : lo, len0 = wi - a0, jump = cap + lo - len0;
          const float* ri = samples + ring(0, i);
          const int st = ring(1, i) - ring(0, i);
          const int kmax = __reduce_max_sync(kFull, k);
          float s = 0.0f;
          for (int q0 = 0; q0 < kmax; q0 += kBatch) {
            float v[kBatch];
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              const int qq = q0 + q;
              const int l = min(qq < len0 ? a0 + qq : qq + jump, cap - 1);
              const float x = ri[l * st];
              v[q] = qq < k ? x : 0.0f;
            }
#pragma unroll
            for (int q = 0; q < kBatch; ++q) s = s + v[q];
          }
          if (in) {
            float mu_new = mu_hat[i];
            if (cnt > 0) mu_new = num / fmaxf(s / (float)k, 1e-9f);
            const int lth = wi - L < 0 ? wi - L + cap : wi - L;
            const float t_ref = cnt >= L ? stamps[ring(lth, i)] : epoch[i];
            const float m = (now - t_ref) > horizon ? 0.0f : mu_new;
            mu_hat[i] = m;
            if (base == 0) mu_lane = m;
          }
        }
        __syncwarp();
        rebuild = learner_view;
        CLK(CK_REFRESH);
        CLK_COUNT(CN_REFRESHES);
      }
      until_refresh = until_refresh + 1 == refresh ? 0 : until_refresh + 1;
      if (n <= kThreads) {  // a store a lane; μ̂ from the lane's register
        if (tq && lane < n) w_q[r * n + lane] = q_real[lane];
        if (tm && lane < n) w_mu[r * n + lane] = mu_lane;
      } else {
        if (tq)
          for (int i = lane; i < n; i += kThreads) w_q[r * n + i] = q_real[i];
        if (tm)
          for (int i = lane; i < n; i += kThreads) w_mu[r * n + i] = mu_hat[i];
      }
      __syncwarp();  // this round's accesses before the next round's
      CLK(CK_TRACE);
      CLK_COUNT(CN_ROUNDS);
    }

    // the tile's trace rows out, by the whole warp: a round's record a lane
    for (int x = lane; x < rt; x += kThreads) {
      uint32_t rec[kRec];
      get_record<kRec>(o_rec + x * kRec, rec);
      put_trace<MT>(tr, row0 + x, mt_, rec);
    }
    if (tq) stage_out(words(tr.q_real + row0 * n), words(w_q), rt * n, lane);
    if (tm) stage_out(words(tr.mu_hat + row0 * n), words(w_mu), rt * n, lane);
    __syncwarp();
    CLK(CK_TILE);
    CLK_COUNT(CN_TILES);
  }

  // the final state, the rings back to [n][cap]
  const size_t cn = (size_t)c * n;
  for (int i = lane; i < n; i += kThreads) {
    fin.q_real[cn + i] = q_real[i];
    const int4 ws = wst[i];
    fin.q_fake[cn + i] = ws.x;
    fin.s_real[cn + i] = ws.y;
    fin.busy_start[cn + i] = __int_as_float(ws.z);
    fin.widx[cn + i] = ws.w;
    fin.count[cn + i] = count[i];
    fin.epoch_start[cn + i] = epoch[i];
    fin.mu_hat[cn + i] = mu_hat[i];
  }
  for (int x = lane; x < n * cap; x += kThreads) {
    const int i = x / cap, l = x - i * cap;
    fin.samples[cn * cap + x] = samples[ring(l, i)];
    fin.stamps[cn * cap + x] = stamps[ring(l, i)];
  }
  for (int i = lane; i < S; i += kThreads) fin.arr_times[(size_t)c * S + i] = arr_times[i];
  if (lane == 0) {
    fin.now[c] = now;
    fin.lam_hat[c] = lam_hat;
    fin.arr_idx[c] = arr_idx;
    fin.arr_count[c] = arr_count;
  }
  CLK(CK_SETUP);
  CLK_END(c);
}

// The block's dynamic shared memory (kernel.smem_bytes).
size_t smem_bytes(int n, int mt, int J, int S, int cap, int rs, int R, int trace_queues,
                  int trace_mu) {
  const size_t w = 6 * (size_t)col_words(R, 1) + col_words(R, mt) + col_words(R, 4 * mt) +
                   col_words(R, J) + col_words(R, rec_words(mt == 1 ? 1 : kMaxMt)) +
                   col_words(R, trace_queues ? n : 0) + col_words(R, trace_mu ? n : 0) +
                   2 * (size_t)rs * cap + 2 * (size_t)(n + 4) + (size_t)kStateArrays * n + S;
  return 4 * w;
}

}  // namespace

extern "C" {

int sim_chain(const int* conf_i, const float* conf_f, const float* mu_sched,
              const float* mu_hat0, const float* dt, const int* ev, const float* u_svc,
              const float* u_fake, const int* j_fake, const int* n_tasks, const int* pins,
              const float* u, const int* j, int C, int T, int n, int mt, int J, int K, int S,
              int cap, int rs, int R, int trace_queues, int trace_mu, int* t_code,
              int* t_worker,
              int* t_n_tasks, int* t_task_workers, int* t_task_targets, int* t_frontend,
              int* t_view_gap, float* t_sync_age, float* t_now, float* t_lam_hat,
              int* t_killed_fake, int* t_q_real, float* t_mu_hat, float* f_now,
              int* f_q_real, int* f_q_fake, int* f_s_real, float* f_busy_start,
              float* f_arr_times, int* f_arr_idx, int* f_arr_count, float* f_lam_hat,
              float* f_samples, float* f_stamps, int* f_widx, int* f_count,
              float* f_epoch_start, float* f_mu_hat, cudaStream_t stream) {
  if (C < 1 || n < 1 || mt < 1 || mt > kMaxMt || J < 2 * mt || K < 1 || S < 1 || cap < 1 ||
      rs < n || R < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, mt, J, S, cap, rs, R, trace_queues, trace_mu);
  auto kernel = mt == 1 ? sim_chain_kernel<1> : sim_chain_kernel<kMaxMt>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Cols cols{dt, ev, u_svc, u_fake, j_fake, n_tasks, pins, u, j};
  Trace tr{t_code, t_worker, t_n_tasks, t_task_workers, t_task_targets, t_frontend,
           t_view_gap, t_sync_age, t_now, t_lam_hat, t_killed_fake,
           trace_queues ? t_q_real : nullptr, trace_mu ? t_mu_hat : nullptr};
  Final fin{f_now, f_q_real, f_q_fake, f_s_real, f_busy_start, f_arr_times, f_arr_idx,
            f_arr_count, f_lam_hat, f_samples, f_stamps, f_widx, f_count, f_epoch_start,
            f_mu_hat};
  kernel<<<C, kThreads, smem, stream>>>(conf_i, conf_f, mu_sched, mu_hat0, cols, T, n, mt, J, K,
                                        S, cap, rs, R, tr, fin);
  return (int)cudaGetLastError();
}

const char* sim_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
