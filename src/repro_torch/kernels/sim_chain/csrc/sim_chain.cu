// The chain simulator's round loop as one kernel, for sm_90a.
//
// Replaces the round function under lax.scan of the JAX package's chain
// simulator (src/repro/core/simulator.py:553-743; XLA, not Pallas) in its
// paper mode (one frontend synced every round, no environment: the EXT =
// false instances) and in its environment, fault and fleet modes (EXT =
// true; the one C entry sim_chain takes them when given conf_x): piecewise λ(t) / μ(t) / membership
// with thinning, cold starts, rejoin bursts, blackouts and crashes, and S
// frontends dispatching against stale views synced every fleet_sync_every
// rounds, with the herd correction; and, in either, the in-chain telemetry
// (OBS = true; SimConfig.observe): the window fold of obs.windows.
// observe_turn once a round and the CUSUM detector of obs.detect at window
// boundaries, each round's window row written out. One
// block runs one chain for all its rounds; a launch takes a batch of
// chains that share their shapes (n workers, mt slots a job, the learner
// ring, the arrival window), each with its own policy, flags, rounds,
// speeds, environment, fleet and draw columns.
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
// table's as two) and the arrival window S. EXT adds the draw columns
// u_thin, fe, u_jfake (1), u_pin (mt) and uj (J), four words a record, six
// arrays of n (the active mask, the actives in index order, the stalled
// mask, the views' snapshot, their μ, the masked weights), F rows of n
// (each frontend's own placements) and 3·F words (its λ̂ EMA).
//
// The environment and fleet modes (EXT). The tracks (λ, μ, membership,
// stall segments; the crashes) stay in device memory; time never goes
// back, so each track keeps a cursor that only moves forward, equal to
// searchsorted(bp, now, right) - 1 clipped, and the μ, mask and stall rows
// move to shared memory when their cursor moves. A membership change is two
// masks that differ, not a cursor that moved. The sync is global: one
// snapshot, one view μ, one table or CDF (built under the active mask and
// frozen until the next sync, rebuilt there only if μ or the mask moved
// since) and one sync time serve every frontend; each frontend keeps its
// own placements since (q_delta) and its λ̂ EMA. Under an environment the
// uniform worker draws are floats mapped through the actives in index
// order (dispatch.active_choice). The new float sums (the kept μ̂ of a cold
// start, the herd correction's Σμ, the fleet's Σλ̂) run left to right; the
// λ̂ EMA step is one fused multiply-add (__fmaf_rn), as the reference's.
//
// The telemetry (OBS). A chain whose conf_o OBS_ON is set folds each round,
// after the refresh, what the reference's round folds (the real
// completion's service time as the histogram's one sample, the round's
// dispatched tasks, its real completion, the crash's killed tasks, the true
// queues, λ̂, μ̂ and the true μ under the active mask), then at a window
// boundary the detector, then writes the window's row (the packed layout of
// obs.windows.row_offsets: the histogram, the i32 fields and the boundary
// flag, the f32 scalars, the detector's vectors) straight to device memory
// from registers, then resets the window. The window's scalars are
// registers alike in every lane; the histogram's thresholds and counts are
// registers too, bin 32·k + l in slot k of lane l (up to kMaxBins bins),
// so a sample's bin is the count of the thresholds at or below it
// (obs.windows.hist_thresholds: a ballot a slot, no logarithm) and its
// count is one add in its lane; the detector's vectors live in shared
// memory, word l of them also in lane l's register for the rows. The
// queues' Σq and max q under the mask are integer warp reductions only at a
// window's first round and where the mask moved; elsewhere they follow
// the round's events exactly (a placement adds its task and may raise the
// max, a real completion and a crash take theirs away; the running max of
// a window can only be raised by a placement). Σμ̂, Σμ and Σ|ĥ − m| run
// lane-strided, then in a butterfly over 16, 8, 4, 2, 1 (ref.warp_sum,
// which every lane ends with); their result only moves when μ̂, μ or the
// mask does, so it is recomputed after a refresh, a phase or segment change
// or a membership change only. In the paper's mode the queue mean adds to
// the window's sum as one fused multiply-add, q_sum + Σq·(1/n), as the
// reference's compiled chain does; under a mask it is Σq / max(#active,
// 1). The detector runs a signal a lane (lanes 0-4), its four product-sums
// fused (__fmaf_rn) where obs.detect.update_row fuses them; a ballot gives
// the alarm and its kind.

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
       CK_TILE, CK_BARRIER, CK_OBS, CK_PHASES };
enum { CN_ROUNDS = CK_PHASES, CN_ARRIVALS, CN_SERVICES, CN_FAKES, CN_REFRESHES, CN_REBUILDS,
       CN_TILES, CN_WINDOWS, CK_SLOTS };
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
// the environment and fleet modes (kernels/sim_chain/ref.py: conf_x, conf_xf)
enum { ENV, FRONTENDS, SYNC_EVERY, HERD, LB, KA, KC, KM, KS, KCRASH, BURST, NX };
enum { LAM_MAX, NXF };
enum { LB_UNIFORM, LB_WEIGHTED, LB_STICKY };
// the telemetry (kernels/sim_chain/ref.py: conf_o, conf_of)
enum { OBS_ON, WINDOW, BINS, DETECT, WARMUP, COOLDOWN, NO };
enum { INV_N, EMA_ALPHA, REBASE_ALPHA, K_SIGMA, H_SIGMA, REL_FLOOR, ABS_FLOOR = REL_FLOOR + 5,
       DECAY, CLIP_Z, SCALE_CLIP_Z, NOF };
// obs.detect: the signals, the regime codes
constexpr int kNsig = 5;
enum { STABLE, LOAD_SHIFT, CAPACITY_SHIFT, MEMBERSHIP_SHIFT, FAILURE_STORM };
// a packed row (obs.windows.PACK_I32, PACK_F32, PACK_DET): the i32 fields
// (the boundary flag after them), the f32 scalars, the detector's vectors
enum { R_N_RESP, R_ARRIVALS, R_LAUNCHED, R_COMPLETED, R_DIRTY, R_KILLED, R_RETRIED,
       R_COLLISIONS, R_Q_MAX, R_TURNS, R_TURN_IDX, R_CUM_LAUNCHED, R_CUM_COMPLETED,
       R_CUM_KILLED, R_N_ACTIVE, R_DET_WINS, R_DET_COOL, R_DET_REGIME, R_DET_FIRED,
       R_DET_LAST_TURN, R_DET_COUNT, R_FLAG, R_I32 };
enum { R_Q_SUM, R_MU_ERR_SUM, R_LAM_HAT, R_T_START, R_T_LAST, R_F32 };
constexpr int kPackDet = 4;
// the most histogram bins a chain takes: kMaxBins / 32 slots a lane
constexpr int kMaxBins = 128;
constexpr int kBinSlots = kMaxBins / 32;
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
// more arrays of n in the environment and fleet modes, beside F rows of n
// and 3·F words
constexpr int kExtArrays = 6;

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

// the environment and fleet modes' draw columns
struct XCols {
  const float* __restrict__ u_thin;
  const int* __restrict__ fe;
  const float* __restrict__ u_pin;
  const float* __restrict__ u_jfake;
  const float* __restrict__ uj;
};

// the environment's tracks, each chain's padded to the batch's longest
// (Ka, Kc, Km, Ks, Kr rows; conf_x holds the chain's own counts)
struct Env {
  const int* __restrict__ conf_x;
  const float* __restrict__ conf_xf;
  const float* __restrict__ lam_bp;
  const float* __restrict__ lam_val;
  const float* __restrict__ mu_bp;
  const float* __restrict__ mu_val;
  const float* __restrict__ act_bp;
  const int* __restrict__ act_val;
  const float* __restrict__ stall_bp;
  const int* __restrict__ stall_val;
  const float* __restrict__ crash_t;
  const int* __restrict__ crash_w;
  int Ka, Kc, Km, Ks, Kr;
};

// the telemetry inputs (ref.OBS), each chain's thresholds padded with +inf
// to HB, and the rows it writes, [C][T][row_words(HB)]
struct Obs {
  const int* __restrict__ conf_o;
  const float* __restrict__ conf_of;
  const float* __restrict__ thr;
  int* rows;
  int HB;
};

// The words of a packed row (obs.windows.row_words), and the telemetry's
// shared words (kernel.OBS_WORDS): the detector's vectors.
__host__ __device__ constexpr int row_words(int HB) {
  return (HB + R_I32 + R_F32 + kPackDet * kNsig + 3) & ~3;
}
constexpr int kObsWords = kPackDet * kNsig;

struct Trace {
  int* code;
  int* worker;
  int* n_tasks;
  int* task_workers;
  int* task_targets;
  int* frontend;
  int* view_gap;  // view_gap, sync_age and killed_fake are 0 in the paper
  float* sync_age;  // mode: the wrapper's zeros stand, unwritten
  float* now;
  float* lam_hat;
  int* killed_fake;
  int* q_real;  // null when not traced
  float* mu_hat;
  int* killed;  // [T, n] (EXT with a crash track; else null)
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
  // EXT: the next crash, the views' snapshot, each frontend's own
  // placements [F][n], the view's μ, each frontend's λ̂ EMA (last arrival,
  // mean gap, count), the last sync's time and the fleet's Σλ̂
  int* crash_i;
  int* q_snap;
  int* q_delta;
  float* mu_view;
  float* ema_last;
  float* ema_gap;
  int* ema_count;
  float* t_sync;
  float* lam_global;
  // EXT: the view's alias table, frozen at the last sync: (prob, alias)
  float* alias_p;
  int* alias_a;
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
// (EXT: frontend, view_gap, sync_age, killed_fake,) MT slot workers, MT
// slot targets, padded to 16 bytes.
__host__ __device__ constexpr int rec_head(bool ext) { return ext ? 9 : 5; }
__host__ __device__ constexpr int rec_words(int mt, bool ext = false) {
  return (rec_head(ext) + 2 * mt + 3) & ~3;
}

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

// A round's record into its row of each trace column (the paper mode's
// frontend: 0 for an arrival's, else -1).
template <int MT, bool EXT>
__device__ __forceinline__ void put_trace(const Trace& tr, size_t row, int mt,
                                          const uint32_t* rec) {
  constexpr int H = rec_head(EXT);
  tr.code[row] = rec[0];
  tr.worker[row] = rec[1];
  tr.n_tasks[row] = rec[2];
  tr.now[row] = __uint_as_float(rec[3]);
  tr.lam_hat[row] = __uint_as_float(rec[4]);
  if constexpr (EXT) {
    tr.frontend[row] = rec[5];
    tr.view_gap[row] = rec[6];
    tr.sync_age[row] = __uint_as_float(rec[7]);
    tr.killed_fake[row] = rec[8];
  } else {
    tr.frontend[row] = (int)rec[0] == EV_ARRIVAL ? 0 : -1;
  }
#pragma unroll
  for (int b = 0; b < MT; ++b) {
    if (b < mt) {
      tr.task_workers[row * mt + b] = rec[H + b];
      tr.task_targets[row * mt + b] = rec[H + MT + b];
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

// dispatch.active_choice: u in [0, 1) picks one of the n_act active
// workers listed in index order; with none active, u · n
__device__ __forceinline__ int active_choice(const int* order, int n_act, int n, float u) {
  if (n_act == 0) return (int)(u * (float)n);
  const int j = (int)(u * (float)n_act);
  return order[j < n_act - 1 ? j : n_act - 1];
}

// The active workers in index order into order[0, n_act), by the whole warp
// (a ballot a chunk keeps the order); returns n_act.
__device__ __forceinline__ int build_order(const int* act, int* order, int n, int lane) {
  const unsigned below = (1u << lane) - 1u;
  int k = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + lane;
    const bool a = i < n && act[i] != 0;
    const unsigned b = __ballot_sync(kFull, a);
    if (a) order[k + __popc(b & below)] = i;
    k += __popc(b);
  }
  __syncwarp();
  return k;
}

// The weights of a view under the active mask (ref.masked_weights): μ on
// the active workers, 0 elsewhere; 1 on the active workers if they have no
// mass; all ones if none is active. Σ left to right by every lane, +0 for
// the inactive workers.
__device__ __forceinline__ void masked_weights(const float* mu, const int* act, int n_act,
                                               int n, float* w, int lane) {
  float total = 0.0f;
  for (int i = 0; i < n; ++i) total = total + (act[i] ? mu[i] : 0.0f);
  const bool mass = total > 0.0f;
  for (int i = lane; i < n; i += kThreads)
    w[i] = mass ? (act[i] ? mu[i] : 0.0f) : (n_act > 0 ? (act[i] ? 1.0f : 0.0f) : 1.0f);
  __syncwarp();
}

// The reference's mask pass over a walked table: an inactive bin accepts
// nothing and every alias lands on an active worker (the first one when
// it would not); with none active, prob 1 and alias 0 everywhere.
__device__ __forceinline__ void mask_pass(int2* tab, const int* act, const int* order,
                                          int n_act, int n, int lane) {
  const int first = n_act > 0 ? order[0] : 0;
  for (int i = lane; i < n; i += kThreads) {
    const int2 e = tab[i];
    const float p = n_act > 0 ? (act[i] ? __int_as_float(e.x) : 0.0f) : 1.0f;
    tab[i] = make_int2(__float_as_int(p), act[e.y] ? e.y : first);
  }
  __syncwarp();
}

// λ̂ of a frontend's EMA (estimator.lam_hat_ema)
__device__ __forceinline__ float ema_lam(float mean_gap) {
  return mean_gap > 0.0f ? 1.0f / fmaxf(mean_gap, 1e-9f) : 0.0f;
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

// Σ of the lanes' values in a butterfly over 16, 8, 4, 2, 1 (ref.warp_sum):
// every lane ends with the same sum, addition being commutative
__device__ __forceinline__ float butterfly_sum(float v) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) v = v + __shfl_xor_sync(kFull, v, d);
  return v;
}

// MT: the slots a job, 1, or kMaxMt with mt at run time; EXT: the
// environment and fleet modes (F: the batch's most frontends, rows of the
// q_delta and EMA arrays); OBS: the telemetry
template <int MT, bool EXT, bool OBS>
__global__ void __launch_bounds__(kThreads, 1) sim_chain_kernel(
    const int* __restrict__ conf_i, const float* __restrict__ conf_f,
    const float* __restrict__ mu_sched, const float* __restrict__ mu_hat0, Cols cols,
    XCols xc, Env env, Obs ob, int T, int n, int mt, int J, int K, int S, int cap, int rs,
    int R, int F, Trace tr, Final fin) {
  const int c = blockIdx.x, lane = threadIdx.x;
  const int mt_ = MT == 1 ? 1 : mt;
  CLK_BEGIN();
  const int* ci = conf_i + (size_t)c * NI;
  const float* cf = conf_f + (size_t)c * NF;
  const int policy = ci[POLICY], rounds = ci[ROUNDS];
  const int refresh = ci[REFRESH], fold = ci[FOLD], fake_cap = ci[FAKE_CAP];
  const bool use_learner = ci[USE_LEARNER], use_fake = ci[USE_FAKE];
  const bool use_table = ci[USE_TABLE], theory = ci[THEORY];
  const float mu_bar = cf[MU_BAR], period = cf[PERIOD], nu_max = cf[NU_MAX];
  const float c0 = cf[C0], c_window = cf[C_WINDOW], theory_num = cf[THEORY_NUM];
  const bool probes_mu =
      policy == PSS || policy == PPOT_SQ2 || policy == PPOT_LL2 || policy == BANDIT;
  // the view of μ̂ (learner) or of the phase's μ (known speeds, and Halo's)
  const bool learner_view = probes_mu && use_learner;
  const bool phase_view = (probes_mu && !use_learner) || policy == HALO;
  const bool table = use_table && policy != HALO;
  const bool two_probes = policy == PPOT_SQ2 || policy == PPOT_LL2 || policy == BANDIT;
  const bool tq = tr.q_real != nullptr, tm = tr.mu_hat != nullptr;
  // the environment and fleet configuration (EXT)
  const int* cx = EXT ? env.conf_x + (size_t)c * NX : nullptr;
  const bool has_env = EXT && cx[ENV] != 0;
  const int nf = EXT ? cx[FRONTENDS] : 1;
  const int sync_every = EXT ? cx[SYNC_EVERY] : 1;
  const bool herd = EXT && cx[HERD] != 0;
  const int lb = EXT ? cx[LB] : LB_UNIFORM;
  const int ka = EXT ? cx[KA] : 1, km = EXT ? cx[KM] : 1;
  const int ks = EXT ? cx[KS] : 0, kcr = EXT && has_env ? cx[KCRASH] : 0;
  const int burst = EXT ? cx[BURST] : 0;
  const float lam_max = EXT ? env.conf_xf[(size_t)c * NXF + LAM_MAX] : 0.0f;
  // the speeds: the phases, or the environment's μ segments
  const int phases = has_env ? cx[KC] : ci[PHASES];
  const float* sched = has_env ? env.mu_val + (size_t)c * env.Kc * n : mu_sched + (size_t)c * K * n;
  const bool one_phase = phases == 1 || (!has_env && isinf(period));
  const float* lam_bp = EXT ? env.lam_bp + (size_t)c * env.Ka : nullptr;
  const float* lam_val = EXT ? env.lam_val + (size_t)c * env.Ka : nullptr;
  const float* mu_bp = EXT ? env.mu_bp + (size_t)c * env.Kc : nullptr;
  const float* act_bp = EXT ? env.act_bp + (size_t)c * env.Km : nullptr;
  const int* act_val = EXT ? env.act_val + (size_t)c * env.Km * n : nullptr;
  const float* stall_bp = EXT ? env.stall_bp + (size_t)c * env.Ks : nullptr;
  const int* stall_val = EXT ? env.stall_val + (size_t)c * env.Ks * n : nullptr;
  const float* crash_t = EXT ? env.crash_t + (size_t)c * env.Kr : nullptr;
  const int* crash_w = EXT ? env.crash_w + (size_t)c * env.Kr : nullptr;
  // the telemetry's configuration (OBS)
  const int* co = OBS ? ob.conf_o + (size_t)c * NO : nullptr;
  const float* cof = OBS ? ob.conf_of + (size_t)c * NOF : nullptr;
  const bool obs_on = OBS && co[OBS_ON] != 0;
  const int window = obs_on ? co[WINDOW] : 1;
  const bool detect = obs_on && co[DETECT] != 0;
  const int HB = OBS ? ob.HB : 0, RW = row_words(HB);

  // shared memory: the tile regions, the worker words, the table's stack
  // and pairs, the rings, the rest of the state, the arrival window (EXT:
  // then the fleet and environment state)
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
  uint32_t *b_uthin = nullptr, *b_fe = nullptr, *b_upin = nullptr, *b_ujfake = nullptr,
           *b_uj = nullptr;
  if constexpr (EXT) {
    b_uthin = region(1), b_fe = region(1), b_upin = region(mt), b_ujfake = region(1),
    b_uj = region(J);
  }
  // the trace: a record of kRec words a round (code, worker, n_tasks, now,
  // lam_hat, (EXT: frontend, view_gap, sync_age, killed_fake,) then the
  // slots' workers and targets), and the queue and μ̂ rows
  constexpr int kHead = rec_head(EXT);
  constexpr int kRec = rec_words(MT, EXT);
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
  // EXT: the active mask, the actives in index order, the stalled mask,
  // the views' snapshot and μ, the masked weights of a build, each
  // frontend's own placements and λ̂ EMA
  int* act = reinterpret_cast<int*>(arr_times + S);
  int* order = act + n;
  int* stall = order + n;
  int* q_snap = stall + n;
  float* mu_view = reinterpret_cast<float*>(q_snap + n);
  float* wmask = mu_view + n;
  int* q_delta = reinterpret_cast<int*>(wmask + n);
  float* ema_last = reinterpret_cast<float*>(q_delta + (size_t)F * n);
  float* ema_gap = ema_last + F;
  int* ema_cnt = reinterpret_cast<int*>(ema_gap + F);
  // OBS: the detector's vectors [kPackDet][kNsig] (mean, scale, pos, neg)
  float* o_det = EXT ? reinterpret_cast<float*>(ema_cnt + F) : arr_times + S;
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
  // the tracks' cursors (EXT): searchsorted(bp, now, right) - 1, clipped
  int lc = 0, ac = 0, sc = 0, crash_i = 0, n_act = n;
  auto advance = [&](const float* bp, int k, int cur, float t) {
    while (cur + 1 < k && bp[cur + 1] <= t) ++cur;
    return cur;
  };
  if constexpr (EXT) {
    if (has_env) {
      lc = advance(lam_bp, ka, 0, 0.0f);
      ac = advance(act_bp, km, 0, 0.0f);
      if (ks > 0) sc = advance(stall_bp, ks, 0, 0.0f);
    }
    for (int i = lane; i < n; i += kThreads) {
      act[i] = has_env ? act_val[(size_t)ac * n + i] != 0 : 1;
      stall[i] = has_env && ks > 0 ? stall_val[(size_t)sc * n + i] != 0 : 0;
      q_snap[i] = 0;
      mu_view[i] = mu_hat0[(size_t)c * n + i];
    }
    for (int i = lane; i < F * n; i += kThreads) q_delta[i] = 0;
    for (int i = lane; i < F; i += kThreads) ema_last[i] = ema_gap[i] = 0.0f, ema_cnt[i] = 0;
    __syncwarp();
    n_act = build_order(act, order, n, lane);
  }
  // OBS: the histogram's thresholds and counts, bin 32·k + lane in slot k
  float h_thr[kBinSlots];
  int h_cnt[kBinSlots];
#pragma unroll
  for (int k = 0; k < kBinSlots; ++k) {
    const int b = 32 * k + lane;
    h_thr[k] = obs_on && b < HB ? ob.thr[(size_t)c * HB + b] : INFINITY;
    h_cnt[k] = 0;
  }
  if (obs_on)  // the detector's state at zero (STABLE is 0)
    for (int i = lane; i < kObsWords; i += kThreads) o_det[i] = 0.0f;
  __syncwarp();
  // the scalar state, the same in every lane; mu_lane: μ̂ of worker lane
  // while n <= 32; rebuild: the learner's view is to be built from μ̂
  float now = 0.0f, lam_hat = 0.0f;
  float mu_lane = lane < n ? mu_hat0[(size_t)c * n + lane] : 0.0f;
  int arr_idx = 0, arr_count = 0, cur_phase = -1, until_refresh = 0;
  bool rebuild = !EXT && learner_view;
  // EXT: the view's μ moved since the last sync's build (view_dirty), the
  // mask or Halo's μ moved (halo_dirty); the sync's time, the fleet's Σλ̂
  // and the herd correction's Σμ of the view
  bool view_dirty = true, halo_dirty = false;
  // EXT: tab holds the view's alias table of the last sync (not a CDF)
  bool tab_view = false;
  float t_sync = 0.0f, lam_global = 0.0f, herd_tot = 1.0f;
  int until_sync = 0;
  const float nu_den = fmaxf(nu_max, 1e-30f);
  // OBS: the window's scalars (every lane alike): its counts, the queue
  // and μ̂-error sums, λ̂ and its start; the global counters and gauges; the
  // detector's alarm state; the rounds to the boundary; Σ|ĥ − m| of the
  // current μ̂, μ and mask (mu_err_dirty: to be recomputed)
  int w_resp = 0, w_arr = 0, w_comp = 0, w_kill = 0, w_qmax = 0, w_turns = 0, turn_idx = 0;
  int cum_arr = 0, cum_comp = 0, cum_kill = 0, n_active = n;
  int d_wins = 0, d_cool = 0, d_regime = STABLE, d_fired = STABLE, d_last = 0, d_count = 0;
  float w_qsum = 0.0f, w_err = 0.0f, t_start = 0.0f, mu_err = 0.0f;
  int until_window = window;
  bool mu_err_dirty = true;
  // the queues' Σq under the mask as of the round's fold; lane l < kObsWords
  // holds word l of the detector's vectors; 1/n of the paper's mean
  int q_tot = 0;
  float det_w = 0.0f;
  const float inv_n = obs_on ? cof[INV_N] : 0.0f;
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
    const float *s_uthin = nullptr, *s_upin = nullptr, *s_ujfake = nullptr, *s_uj = nullptr;
    const int* s_fe = nullptr;
    if constexpr (EXT) {
      s_uthin = reinterpret_cast<const float*>(
          b_uthin + stage_in(b_uthin, words(xc.u_thin + row0), rt, lane));
      s_fe = reinterpret_cast<const int*>(b_fe + stage_in(b_fe, words(xc.fe + row0), rt, lane));
      s_upin = reinterpret_cast<const float*>(
          b_upin + stage_in(b_upin, words(xc.u_pin + row0 * mt), rt * mt, lane));
      s_ujfake = reinterpret_cast<const float*>(
          b_ujfake + stage_in(b_ujfake, words(xc.u_jfake + row0), rt, lane));
      s_uj = reinterpret_cast<const float*>(
          b_uj + stage_in(b_uj, words(xc.uj + row0 * J), rt * J, lane));
    }
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
      int phase;
      if constexpr (EXT) {
        phase = has_env ? advance(mu_bp, phases, cur_phase < 0 ? 0 : cur_phase, now)
                        : (one_phase ? 0 : ((int)(now / period)) % phases);
      } else {
        phase = one_phase ? 0 : ((int)(now / period)) % phases;
      }
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
            if (EXT || OBS || phase_view) mu_built[i] = mu_now[i];
          }
          __syncwarp();
          mu_err_dirty = true;
          if constexpr (EXT) {
            view_dirty = view_dirty || !use_learner;
            halo_dirty = policy == HALO;
          } else {
            rebuild = rebuild || phase_view;
          }
          CLK(CK_HEAD);
        }
        if (!EXT && rebuild) {  // the one place the tables are built
          build_views(learner_view ? mu_hat : mu_built, n, table, stk, tab, cdf, lane);
          rebuild = false;
          CLK(CK_REBUILD);
          CLK_COUNT(CN_REBUILDS);
        }
      }
      int frontend = -1, view_gap = 0, killed_fake = 0;
      float sync_age = 0.0f;
      // OBS: the round's real completion's service time, its killed tasks,
      // the change of Σq under the mask and the highest queue a placement
      // left, and whether the mask moved (Σq and max q then recounted)
      float svc = 0.0f;
      bool svc_ok = false;
      int killed_real = 0, obs_dq = 0, obs_qhi = 0;
      bool obs_recount = false;
      if constexpr (EXT) {
        bool memb = false;
        if (has_env) {
          const int ac2 = advance(act_bp, km, ac, now);
          if (ac2 != ac) {  // the mask may have changed
            ac = ac2;
            const int* row = act_val + (size_t)ac * n;
            bool diff = false;
            for (int base = 0; base < n; base += kThreads) {
              const int i = base + lane;
              diff = diff || __any_sync(kFull, i < n && (row[i] != 0) != (act[i] != 0));
            }
            if (diff) {  // cold start, burst and busy clock of the rejoining workers
              memb = true;
              float mu_keep = 0.0f, denom = 0.0f;
              for (int i = 0; i < n; ++i) {
                const bool keep = row[i] != 0 && act[i] != 0;
                mu_keep = mu_keep + (keep ? mu_hat[i] : 0.0f);
                denom = denom + (keep ? 1.0f : 0.0f);
              }
              const float mu0 = denom > 0.0f ? mu_keep / fmaxf(denom, 1.0f) : 1.0f;
              __syncwarp();  // every lane's reads of μ̂ and the mask before the writes
              for (int base = 0; base < n; base += kThreads) {
                const int i = base + lane;
                if (i < n) {
                  const bool now_on = row[i] != 0, rejoin = now_on && act[i] == 0;
                  if (rejoin) {
                    const int4 ws = wst[i];
                    const bool stale = q_real[i] + ws.x == 0 || stall[i] != 0;
                    int qf = ws.x, wi = ws.w, busy = ws.z;
                    if (use_learner) {
                      wi = 0;
                      count[i] = 0;
                      epoch[i] = now;
                      mu_hat[i] = mu0;
                      if (base == 0) mu_lane = mu0;
                      for (int l = 0; l < cap; ++l) samples[ring(l, i)] = stamps[ring(l, i)] = 0.0f;
                    }
                    if (use_fake) qf = min(qf + burst, fake_cap);
                    if (stale) busy = __float_as_int(now);
                    wst[i] = make_int4(qf, ws.y, busy, wi);
                  }
                  act[i] = now_on;
                }
              }
              __syncwarp();
              n_act = build_order(act, order, n, lane);
              view_dirty = true;
              halo_dirty = policy == HALO;
              mu_err_dirty = true;
              obs_recount = true;
            }
          }
          if (ks > 0) {  // the stalled mask at now, after the cold start read the last
            const int sc2 = advance(stall_bp, ks, sc, now);
            if (sc2 != sc) {
              sc = sc2;
              for (int i = lane; i < n; i += kThreads)
                stall[i] = stall_val[(size_t)sc * n + i] != 0;
              __syncwarp();
            }
          }
          if (crash_i < kcr && now >= crash_t[crash_i]) {  // at most one crash a round
            const int wc = crash_w[crash_i];
            const int kreal = q_real[wc];
            const int4 ws = wst[wc];
            __syncwarp();
            q_real[wc] = 0;
            wst[wc] = make_int4(0, ws.y + kreal, __float_as_int(now), ws.w);
            killed_fake = ws.x;
            killed_real = kreal;
            if (OBS && act[wc] != 0) obs_dq -= kreal;
            if (lane == 0) tr.killed[((size_t)c * T + t0 + r) * n + wc] = kreal;
            crash_i += 1;
            __syncwarp();
          }
        }
        if (halo_dirty) {  // Halo's CDF: the current μ under the current mask
          masked_weights(mu_built, act, n_act, n, wmask, lane);
          build_views(wmask, n, false, stk, tab, cdf, lane);
          halo_dirty = false;
          CLK_COUNT(CN_REBUILDS);
        }
        const bool do_sync = (sync_every > 0 ? until_sync == 0 : t0 + r == 0) || memb;
        if (do_sync) {  // every frontend's view reconciles at the true state
          for (int i = lane; i < n; i += kThreads) {
            q_snap[i] = q_real[i];
            for (int f = 0; f < nf; ++f) q_delta[(size_t)f * n + i] = 0;
          }
          if (view_dirty) {
            const float* central = use_learner ? mu_hat : mu_built;
            for (int i = lane; i < n; i += kThreads) mu_view[i] = central[i];
            __syncwarp();
            if (herd) {
              float s = 0.0f;
              for (int i = 0; i < n; ++i) s = s + fmaxf(mu_view[i], 0.0f);
              herd_tot = fmaxf(s, 1e-9f);
            }
            if (probes_mu) {
              masked_weights(mu_view, act, n_act, n, wmask, lane);
              build_views(wmask, n, table, stk, tab, cdf, lane);
              if (table) mask_pass(tab, act, order, n_act, n, lane);
              tab_view = table;
              CLK_COUNT(CN_REBUILDS);
            }
            view_dirty = false;
          }
          t_sync = now;
          float s = 0.0f;
          for (int f = 0; f < nf; ++f) s = s + ema_lam(ema_gap[f]);
          lam_global = s;
          __syncwarp();
        }
        if (sync_every > 0) until_sync = until_sync + 1 == sync_every ? 0 : until_sync + 1;
        CLK(CK_REBUILD);
      }
      int code = EV_SELF_LOOP, worker = -1, nt = 0;
      int w[MT], tgt[MT];
      bool arrival = ev == 0;
      if constexpr (EXT) {
        if (arrival && has_env) {  // thinned by λ(now) / λmax
          lc = advance(lam_bp, ka, lc, now);
          arrival = s_uthin[r] * lam_max < lam_val[lc];
        }
      }
      if (arrival) {  // an arrival
        code = EV_ARRIVAL;
        nt = s_nt[r];
        const int ordinal = arr_count;
        arr_times[arr_idx] = now;
        arr_idx = arr_idx + 1 == S ? 0 : arr_idx + 1;
        arr_count += 1;
        const int k = arr_count < S ? arr_count : S;
        const float oldest = arr_count >= S ? arr_times[arr_idx] : arr_times[0];
        const float span = now - oldest;
        if (k >= 2 && span > 0.0f) lam_hat = (float)(k - 1) / span;
        const float* mu_view_now = EXT ? mu_view : (use_learner ? mu_hat : mu_built);
        const int* pins = s_pins + r * mt_;
        const float* u = s_u + r * 4 * mt_;
        const int* jj = s_j + r * J;
        // EXT: the job's frontend, its stale view (snapshot + its own
        // placements, + the herd correction), the gap to the true queues
        const int* qd = q_delta;
        float rate = 0.0f;
        if constexpr (EXT) {
          frontend = lb == LB_STICKY ? ordinal % nf : s_fe[r];
          qd = q_delta + (size_t)frontend * n;
          int g = 0;
          for (int i = lane; i < n; i += kThreads) g += abs(q_snap[i] + qd[i] - q_real[i]);
          view_gap = __reduce_add_sync(kFull, g);
          sync_age = now - t_sync;
          if (herd)
            rate = ((float)(nf - 1) * fmaxf(ema_lam(ema_gap[frontend]), 0.0f)) *
                   fmaxf(sync_age, 0.0f);
        }
        // the queue a dispatch sees at worker x before this job
        auto view = [&](int x) {
          if constexpr (EXT) {
            int v = q_snap[x] + qd[x];
            if (herd) v += (int)rintf(rate * fmaxf(mu_view[x], 0.0f) / herd_tot);
            return v;
          } else {
            return q_real[x];
          }
        };
        // the uniform worker at draw position q (EXT under an environment:
        // over the active workers)
        const float* uj = EXT ? s_uj + r * J : nullptr;
        auto uw = [&](int q) {
          if constexpr (EXT) {
            if (has_env) return active_choice(order, n_act, n, uj[q]);
          }
          return jj[q];
        };
        int pin[MT];
#pragma unroll
        for (int b = 0; b < MT; ++b) {
          if (b < mt_) {
            pin[b] = pins[b];
            if constexpr (EXT) {
              if (has_env && pins[b] >= 0)
                pin[b] = active_choice(order, n_act, n, s_upin[r * mt_ + b]);
            }
          }
        }
        // q_work: the engine's view (re-snapshotted after each chunk); the
        // true queue is folded at the end. Kept as per-slot counts over
        // the view so that it stays the snapshot until the fold. Every
        // loop over slots is unrolled to MT, so w, tgt and load stay in
        // registers.
        if (policy == SPARROW) {
          const int probes = 2 * mt_;
          int load[2 * MT], pw[2 * MT];
#pragma unroll
          for (int q = 0; q < 2 * MT; ++q) {
            if (q < probes) {
              const int wq = uw(q);
              pw[q] = wq;
              int l = view(wq);
#pragma unroll
              for (int b = 0; b < MT; ++b)
                l += (b < mt_ && b < nt && pin[b] == wq);  // pins first
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
              } else if (pin[b] >= 0) {
                w[b] = pin[b];
              } else {
                int best = 0, least = load[0];
#pragma unroll
                for (int q = 1; q < 2 * MT; ++q)
                  if (q < probes && load[q] < least) best = q, least = load[q];
                const int wb = pw[best];
                w[b] = wb;
#pragma unroll
                for (int q = 0; q < 2 * MT; ++q)
                  if (q < probes) load[q] += pw[q] == wb;
              }
            }
          }
        } else {
          const int chunks = fold < 1 ? 1 : (fold > mt_ ? mt_ : fold);
          const int cs = (mt_ + chunks - 1) / chunks;
#pragma unroll
          for (int b = 0; b < MT; ++b) {
            if (b < mt_) {
              // the queue the slot sees: the view plus the active slots of
              // earlier chunks
              const int placed = b - b % cs;
              auto qv = [&](int x) {
                int v = view(x);
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
                  const float w1 = ((float)qv(j1) + 1.0f) / fmaxf(mu_view_now[j1], 1e-9f);
                  const float w2 = ((float)qv(j2) + 1.0f) / fmaxf(mu_view_now[j2], 1e-9f);
                  sel = w1 <= w2 ? j1 : j2;
                } else {
                  sel = qv(j1) <= qv(j2) ? j1 : j2;
                  if (policy == BANDIT && jj[mt_ + b] != 0) sel = uw(b);
                }
              } else if (policy == PSS) {
                sel = probe(0, 2);
              } else if (policy == POT) {
                const int j1 = uw(b), j2 = uw(mt_ + b);
                sel = qv(j1) <= qv(j2) ? j1 : j2;
              } else if (policy == HALO) {
                sel = cdf_probe(cdf, n, u[b], lane);
              } else {  // uniform
                sel = uw(b);
              }
              if (pin[b] >= 0) sel = pin[b];
              w[b] = b < nt ? sel : -1;
            }
          }
        }
        // completion targets on the true queues, the queues after the fold
        // (a worker's last slot holds its total) and the idle test, all on
        // the queues before it; then the busy clocks and the fold (EXT:
        // into the frontend's own placements too)
        int qn[MT], qdn[MT];
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
            if constexpr (EXT) qdn[b] = qd[wb] + rank + 1;
          }
        }
        if constexpr (OBS) {  // Σq and the window's max under the mask
#pragma unroll
          for (int b = 0; b < MT; ++b) {
            if (b < mt_ && b < nt) {
              const bool on = !(EXT && has_env) || act[w[b]] != 0;
              obs_dq += on;
              obs_qhi = max(obs_qhi, on ? qn[b] : 0);
            }
          }
        }
        float ema_l = 0.0f, ema_g = 0.0f;
        int ema_c = 0;
        if constexpr (EXT) {  // the frontend's λ̂ EMA step (estimator.observe_arrivals_ema)
          const float gap = now - ema_last[frontend];
          ema_c = ema_cnt[frontend];
          ema_g = ema_c == 0 ? gap : __fmaf_rn(0.984375f, ema_gap[frontend], 0.015625f * gap);
          ema_l = now;
        }
        __syncwarp();  // every lane's reads before any lane's writes
        // (an idle worker given two slots is set twice to the same now)
#pragma unroll
        for (int b = 0; b < MT; ++b) {
          if (b < mt_ && b < nt) {
            if (idle[b]) wst[w[b]].z = __float_as_int(now);
            q_real[w[b]] = qn[b];
            if constexpr (EXT) q_delta[(size_t)frontend * n + w[b]] = qdn[b];
          }
        }
        if constexpr (EXT) {
          ema_last[frontend] = ema_l;
          ema_gap[frontend] = ema_g;
          ema_cnt[frontend] = ema_c + 1;
        }
        CLK(CK_ARRIVAL);
        CLK_COUNT(CN_ARRIVALS);
      } else if (ev == 0) {  // a thinned arrival: a self-loop
      } else if (ev <= n) {  // a potential service event
        const int wv = ev - 1;
        worker = wv;
        bool accept = s_usvc[r] < thr[wv];
        if constexpr (EXT) accept = accept && stall[wv] == 0;  // a blackout stalls it
        const int qr = q_real[wv], cnt = count[wv];
        const int4 ws = wst[wv];
        const bool do_real = accept && qr > 0;
        const bool do_fake = accept && qr <= 0 && ws.x > 0;
        svc = now - __int_as_float(ws.z);
        svc_ok = do_real;
        if constexpr (OBS) obs_dq -= do_real && (!(EXT && has_env) || act[wv] != 0);
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
        int jf = s_jfake[r];
        if constexpr (EXT) {
          if (has_env) jf = active_choice(order, n_act, n, s_ujfake[r]);
        }
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
        if constexpr (EXT) {
          rec[5] = code == EV_ARRIVAL ? frontend : -1;
          rec[6] = code == EV_ARRIVAL ? view_gap : 0;
          rec[7] = __float_as_uint(code == EV_ARRIVAL ? sync_age : 0.0f);
          rec[8] = killed_fake;
        }
#pragma unroll
        for (int b = 0; b < MT; ++b) {
          rec[kHead + b] = b < nt ? w[b] : -1;
          rec[kHead + MT + b] = b < nt ? tgt[b] : -1;
        }
#pragma unroll
        for (int x = kHead + 2 * MT; x < kRec; ++x) rec[x] = 0;
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
        if constexpr (EXT) {
          view_dirty = true;
        } else {
          rebuild = learner_view;
        }
        mu_err_dirty = true;
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
      if (obs_on) {  // the window fold, the detector at a boundary, the row, the reset
        CLK(CK_TRACE);
        const bool masked = EXT && has_env;
        if (svc_ok) {  // the sample's bin: the thresholds at or below it
          int bin = 0;
#pragma unroll
          for (int k = 0; k < kBinSlots; ++k)
            if (32 * k < HB) bin += __popc(__ballot_sync(kFull, svc >= h_thr[k]));
#pragma unroll
          for (int k = 0; k < kBinSlots; ++k) h_cnt[k] += bin == 32 * k + lane;
        }
        int qm;
        if (w_turns == 0 || obs_recount) {  // Σq and max q counted over the workers
          int qs = 0;
          qm = 0;
          for (int i = lane; i < n; i += kThreads) {
            const int q = !masked || act[i] != 0 ? q_real[i] : 0;
            qs += q;
            qm = max(qm, q);
          }
          q_tot = __reduce_add_sync(kFull, qs);
          qm = __reduce_max_sync(kFull, qm);
        } else {  // the round's events: exact, the window's max raised only by a placement
          q_tot += obs_dq;
          qm = obs_qhi;
        }
        if (mu_err_dirty) {  // Σ|ĥ − m| of the shares under the mask (ref.ObsFold)
          float hs = 0.0f, ms = 0.0f;
          for (int i = lane; i < n; i += kThreads) {
            const bool a = !masked || act[i] != 0;
            hs = hs + (a ? mu_hat[i] : 0.0f);
            ms = ms + (a ? mu_built[i] : 0.0f);
          }
          const float dh = fmaxf(butterfly_sum(hs), 1e-12f);
          const float dm = fmaxf(butterfly_sum(ms), 1e-12f);
          float ds = 0.0f;
          for (int i = lane; i < n; i += kThreads) {
            const bool a = !masked || act[i] != 0;
            ds = ds + fabsf((a ? mu_hat[i] : 0.0f) / dh - (a ? mu_built[i] : 0.0f) / dm);
          }
          mu_err = butterfly_sum(ds);
          mu_err_dirty = false;
        }
        w_qsum = masked ? w_qsum + (float)q_tot / fmaxf((float)n_act, 1.0f)
                        : __fmaf_rn((float)q_tot, inv_n, w_qsum);
        const int comp = code == EV_REAL_DONE;
        w_resp += svc_ok;
        w_arr += nt;
        w_comp += comp;
        w_kill += killed_real;
        w_qmax = max(w_qmax, qm);
        w_err = w_err + mu_err;
        w_turns += 1;
        turn_idx += 1;
        cum_arr += nt;
        cum_comp += comp;
        cum_kill += killed_real;
        n_active = masked ? n_act : n;
        const bool flag = --until_window == 0;
        if (flag && detect) {  // obs.detect.update_row: a signal a lane
          CLK_COUNT(CN_WINDOWS);
          const int s = lane < kNsig ? lane : 0;
          const float turns_f = fmaxf((float)w_turns, 1.0f);
          const float x = s == 0   ? lam_hat
                          : s == 1 ? w_err / turns_f
                          : s == 2 ? w_qsum / turns_f
                          : s == 3 ? (float)n_active
                                   : (float)w_kill;  // killed + dirty + retried, these 0
          const float mean = o_det[s], scale = o_det[kNsig + s];
          const float pos = o_det[2 * kNsig + s], neg = o_det[3 * kNsig + s];
          const bool first = d_wins == 0, warm = d_wins < co[WARMUP], cooling = d_cool > 0;
          const float absf = cof[ABS_FLOOR];
          const float mean0 = first ? x : mean;
          const float scale_eff = fmaxf(fmaxf(scale, cof[REL_FLOOR + s] * fabsf(mean0)), absf);
          const float z = (x - mean0) / scale_eff;
          const float k = cof[K_SIGMA], h = cof[H_SIGMA], rho = cof[DECAY];
          const float pos1 = fmaxf(__fmaf_rn(rho, pos, z) - k, 0.0f);
          const float neg1 = fmaxf(__fmaf_rn(rho, neg, -z) - k, 0.0f);
          const bool armed = !warm && !cooling;
          const bool two = s == 0 || s == 2 || s == 3;  // obs.detect.TWO_SIDED
          const unsigned bits =
              __ballot_sync(kFull, lane < kNsig && armed && (pos1 > h || (two && neg1 > h)));
          const bool fired = bits != 0u;
          // label precedence: membership > failure > capacity > load
          const int kind = bits & 8u    ? MEMBERSHIP_SHIFT
                           : bits & 16u ? FAILURE_STORM
                           : bits & 2u  ? CAPACITY_SHIFT
                           : bits & 5u  ? LOAD_SHIFT
                                        : STABLE;
          const bool rb = warm || cooling || fired;
          const float alpha = rb ? cof[REBASE_ALPHA] : cof[EMA_ALPHA];
          const float clip = cof[CLIP_Z] * scale_eff;
          float innov = x - mean0;
          if (!rb) innov = fminf(fmaxf(innov, -clip), clip);
          float dev = fabsf(x - mean0);
          if (!rb) dev = fminf(dev, cof[SCALE_CLIP_Z] * scale_eff);
          const float scale0 = first ? fmaxf(dev, absf) : scale;
          const float mean1 = __fmaf_rn(alpha, innov, mean0);
          const float scale1 = __fmaf_rn(alpha, dev - scale0, scale0);
          const bool keep = armed && !fired;
          __syncwarp();  // every lane's reads before the writes
          if (lane < kNsig) {
            o_det[s] = mean1;
            o_det[kNsig + s] = scale1;
            o_det[2 * kNsig + s] = keep ? pos1 : 0.0f;
            o_det[3 * kNsig + s] = keep ? neg1 : 0.0f;
          }
          __syncwarp();  // the writes before each lane reads its word
          if (lane < kObsWords) det_w = o_det[lane];
          const int cool1 = fired ? co[COOLDOWN] : max(d_cool - 1, 0);
          d_wins += 1;
          d_regime = fired ? kind : (cool1 > 0 ? d_regime : STABLE);
          d_fired = fired ? kind : STABLE;
          if (fired) d_last = turn_idx;
          d_count += fired;
          d_cool = cool1;
        }
        // the row, straight to device memory: the histogram a slot a lane, the
        // scalars (the same value from every lane, one store), the detector's
        // vectors a word a lane
        int* row = ob.rows + ((size_t)c * T + t0 + r) * RW;
#pragma unroll
        for (int k = 0; k < kBinSlots; ++k)
          if (32 * k + lane < HB) row[32 * k + lane] = h_cnt[k];
        int* ri = row + HB;
        ri[R_N_RESP] = w_resp;
        ri[R_ARRIVALS] = w_arr;
        ri[R_LAUNCHED] = w_arr;
        ri[R_COMPLETED] = w_comp;
        ri[R_KILLED] = w_kill;
        ri[R_Q_MAX] = w_qmax;
        ri[R_TURNS] = w_turns;
        ri[R_TURN_IDX] = turn_idx;
        ri[R_CUM_LAUNCHED] = cum_arr;
        ri[R_CUM_COMPLETED] = cum_comp;
        ri[R_CUM_KILLED] = cum_kill;
        ri[R_N_ACTIVE] = n_active;
        ri[R_DET_WINS] = d_wins;
        ri[R_DET_COOL] = d_cool;
        ri[R_DET_REGIME] = d_regime;
        ri[R_DET_FIRED] = d_fired;
        ri[R_DET_LAST_TURN] = d_last;
        ri[R_DET_COUNT] = d_count;
        ri[R_FLAG] = flag;
        float* rf = reinterpret_cast<float*>(ri + R_I32);
        rf[R_Q_SUM] = w_qsum;
        rf[R_MU_ERR_SUM] = w_err;
        rf[R_LAM_HAT] = lam_hat;
        rf[R_T_START] = t_start;
        rf[R_T_LAST] = now;
        if (lane < kObsWords) rf[R_F32 + lane] = det_w;
        if (flag) {  // the reset, after the row: the window's fields, its start
#pragma unroll
          for (int k = 0; k < kBinSlots; ++k) h_cnt[k] = 0;
          w_resp = w_arr = w_comp = w_kill = w_qmax = w_turns = 0;
          w_qsum = w_err = 0.0f;
          t_start = now;
          until_window = window;
        }
        CLK(CK_OBS);
      }
      __syncwarp();  // this round's accesses before the next round's
      CLK(CK_TRACE);
      CLK_COUNT(CN_ROUNDS);
    }

    // the tile's trace rows out, by the whole warp: a round's record a lane
    for (int x = lane; x < rt; x += kThreads) {
      uint32_t rec[kRec];
      get_record<kRec>(o_rec + x * kRec, rec);
      put_trace<MT, EXT>(tr, row0 + x, mt_, rec);
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
  if constexpr (EXT) {
    // the view's alias table as the sync gives it to every frontend: the
    // frozen one, or, where the chain probes a CDF or no μ (or ran no
    // round), one build from the view's μ under the mask, which no
    // membership change has moved since the last sync
    if (!tab_view) {
      masked_weights(mu_view, act, n_act, n, wmask, lane);
      build_views(wmask, n, true, stk, tab, cdf, lane);
      mask_pass(tab, act, order, n_act, n, lane);
    }
    for (int i = lane; i < n; i += kThreads) {
      fin.alias_p[cn + i] = __int_as_float(tab[i].x);
      fin.alias_a[cn + i] = tab[i].y;
      fin.q_snap[cn + i] = q_snap[i];
      fin.mu_view[cn + i] = mu_view[i];
      for (int f = 0; f < nf; ++f)
        fin.q_delta[((size_t)c * F + f) * n + i] = q_delta[(size_t)f * n + i];
    }
    for (int f = lane; f < nf; f += kThreads) {
      fin.ema_last[(size_t)c * F + f] = ema_last[f];
      fin.ema_gap[(size_t)c * F + f] = ema_gap[f];
      fin.ema_count[(size_t)c * F + f] = ema_cnt[f];
    }
    if (lane == 0) {
      fin.crash_i[c] = crash_i;
      fin.t_sync[c] = t_sync;
      fin.lam_global[c] = lam_global;
    }
  }
  CLK(CK_SETUP);
  CLK_END(c);
}

// The block's dynamic shared memory (kernel.smem_bytes); F > 0: the
// environment and fleet modes with F frontends; HB > 0: the telemetry.
size_t smem_bytes(int n, int mt, int J, int S, int cap, int rs, int R, int trace_queues,
                  int trace_mu, int F, int HB) {
  const bool ext = F > 0;
  size_t w = 6 * (size_t)col_words(R, 1) + col_words(R, mt) + col_words(R, 4 * mt) +
             col_words(R, J) + col_words(R, rec_words(mt == 1 ? 1 : kMaxMt, ext)) +
             col_words(R, trace_queues ? n : 0) + col_words(R, trace_mu ? n : 0) +
             2 * (size_t)rs * cap + 2 * (size_t)(n + 4) + (size_t)kStateArrays * n + S;
  if (ext)
    w += 3 * (size_t)col_words(R, 1) + col_words(R, mt) + col_words(R, J) +
         (size_t)kExtArrays * n + (size_t)F * n + 3 * (size_t)F;
  if (HB > 0) w += kObsWords;
  return 4 * w;
}

template <bool EXT, bool OBS>
int launch(const int* conf_i, const float* conf_f, const float* mu_sched, const float* mu_hat0,
           Cols cols, XCols xc, Env env, Obs ob, int C, int T, int n, int mt, int J, int K,
           int S, int cap, int rs, int R, int trace_queues, int trace_mu, int F, Trace tr,
           Final fin, cudaStream_t stream) {
  if (C < 1 || n < 1 || mt < 1 || mt > kMaxMt || J < 2 * mt || K < 1 || S < 1 || cap < 1 ||
      rs < n || R < 1 || (EXT && F < 1) ||
      (OBS && (ob.HB < 2 || ob.HB > kMaxBins || ob.rows == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(n, mt, J, S, cap, rs, R, trace_queues, trace_mu, EXT ? F : 0, OBS ? ob.HB : 0);
  auto kernel = mt == 1 ? sim_chain_kernel<1, EXT, OBS> : sim_chain_kernel<kMaxMt, EXT, OBS>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<C, kThreads, smem, stream>>>(conf_i, conf_f, mu_sched, mu_hat0, cols, xc, env, ob, T,
                                        n, mt, J, K, S, cap, rs, R, F, tr, fin);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One entry for both programs: the paper mode's arguments (conf_i ...
// j), the environment and fleet modes' draw columns (u_thin, fe, u_pin,
// u_jfake, uj), conf_x / conf_xf and the tracks (ref.EXT's order), the
// shapes, the tracks' padded lengths (Ka, Kc, Km, Ks, Kr) and the batch's
// most frontends F, the telemetry's inputs (conf_o, conf_of, obs_thr) and
// its most bins HB, the trace columns, the killed column (null without a
// crash track), the window rows (null without telemetry), the final state
// and the EXT final state. With conf_x null the EXT pointers are null and
// their counts 0, and the paper mode's program runs; else the environment
// and fleet modes'. With conf_o null (HB 0) the program folds no
// telemetry; else its OBS instance runs.
int sim_chain(const int* conf_i, const float* conf_f, const float* mu_sched,
              const float* mu_hat0, const float* dt, const int* ev, const float* u_svc,
              const float* u_fake, const int* j_fake, const int* n_tasks, const int* pins,
              const float* u, const int* j, const float* u_thin, const int* fe,
              const float* u_pin, const float* u_jfake, const float* uj, const int* conf_x,
              const float* conf_xf, const float* lam_bp, const float* lam_val,
              const float* mu_bp, const float* mu_val, const float* act_bp, const int* act_val,
              const float* stall_bp, const int* stall_val, const float* crash_t,
              const int* crash_w, const int* conf_o, const float* conf_of,
              const float* obs_thr, int C, int T, int n, int mt, int J, int K, int S, int cap,
              int rs, int R, int trace_queues, int trace_mu, int Ka, int Kc, int Km, int Ks,
              int Kr, int F, int HB, int* t_code, int* t_worker, int* t_n_tasks,
              int* t_task_workers, int* t_task_targets, int* t_frontend, int* t_view_gap,
              float* t_sync_age, float* t_now, float* t_lam_hat, int* t_killed_fake,
              int* t_q_real, float* t_mu_hat, int* t_killed, int* t_obs, float* f_now,
              int* f_q_real, int* f_q_fake,
              int* f_s_real, float* f_busy_start, float* f_arr_times, int* f_arr_idx,
              int* f_arr_count, float* f_lam_hat, float* f_samples, float* f_stamps,
              int* f_widx, int* f_count, float* f_epoch_start, float* f_mu_hat, int* f_crash_i,
              int* f_q_snap, int* f_q_delta, float* f_mu_view, float* f_ema_last,
              float* f_ema_gap, int* f_ema_count, float* f_t_sync, float* f_lam_global,
              float* f_alias_p, int* f_alias_a, cudaStream_t stream) {
  const bool ext = conf_x != nullptr;
  if (ext && (Ka < 1 || Kc < 1 || Km < 1 || Ks < 1 || Kr < 1))
    return (int)cudaErrorInvalidValue;
  Cols cols{dt, ev, u_svc, u_fake, j_fake, n_tasks, pins, u, j};
  XCols xc{u_thin, fe, u_pin, u_jfake, uj};
  Env env{conf_x, conf_xf, lam_bp, lam_val, mu_bp, mu_val, act_bp, act_val, stall_bp,
          stall_val, crash_t, crash_w, Ka, Kc, Km, Ks, Kr};
  Trace tr{t_code, t_worker, t_n_tasks, t_task_workers, t_task_targets, t_frontend,
           t_view_gap, t_sync_age, t_now, t_lam_hat, t_killed_fake,
           trace_queues ? t_q_real : nullptr, trace_mu ? t_mu_hat : nullptr,
           ext ? t_killed : nullptr};
  Final fin{f_now, f_q_real, f_q_fake, f_s_real, f_busy_start, f_arr_times, f_arr_idx,
            f_arr_count, f_lam_hat, f_samples, f_stamps, f_widx, f_count, f_epoch_start,
            f_mu_hat, f_crash_i, f_q_snap, f_q_delta, f_mu_view, f_ema_last, f_ema_gap,
            f_ema_count, f_t_sync, f_lam_global, f_alias_p, f_alias_a};
  const bool obs = conf_o != nullptr;
  Obs ob{conf_o, conf_of, obs_thr, obs ? t_obs : nullptr, obs ? HB : 0};
  auto run = ext ? (obs ? launch<true, true> : launch<true, false>)
                 : (obs ? launch<false, true> : launch<false, false>);
  return run(conf_i, conf_f, mu_sched, mu_hat0, cols, xc, env, ob, C, T, n, mt, J, K, S, cap,
             rs, R, trace_queues, trace_mu, ext ? F : 0, tr, fin, stream);
}

const char* sim_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
