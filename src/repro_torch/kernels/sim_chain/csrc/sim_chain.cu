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
// steps, each a shared-memory load and a compare or an add, on one
// thread; the bytes (the draw columns in, the trace rows out: about 60 B
// plus 8n B a round) are far below the memory rate, and the chains of a
// batch run side by side on their own SMs. Design answer: one warp a
// chain, the whole state in shared memory (the learner rings, 8 B a slot,
// are most of it), one thread for a round's scalar logic and the warp for
// the O(n) steps (the learner refresh, a worker a lane, and the trace
// row). The alias table and the CDFs are rebuilt only when their μ
// changes (after a refresh with the learner; at a phase change with known
// speeds), by one thread, as the plain chain's pairing walk builds them.
//
// Shared memory: 8·n·cap (rings) + 60·n + 4·S bytes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

enum { POLICY, ROUNDS, USE_LEARNER, USE_FAKE, FAKE_CAP, REFRESH, FOLD, USE_TABLE,
       THEORY, PHASES, NI };
enum { MU_BAR, PERIOD, NU_MAX, C0, C_WINDOW, THEORY_NUM, NF };
// core/policies.ALL_POLICIES, in order
enum { UNIFORM, POT, PSS, PPOT_SQ2, PPOT_LL2, BANDIT, HALO, SPARROW };
enum { EV_ARRIVAL, EV_REAL_DONE, EV_FAKE_DONE, EV_FAKE_DISPATCH, EV_SELF_LOOP };

constexpr int kThreads = 32;
constexpr int kMaxMt = 8;
constexpr int kMaxProbes = 2 * kMaxMt;
constexpr float kAvgWindowMult = 2.25f;

struct Cols {
  const float* dt;
  const int* ev;
  const float* u_svc;
  const float* u_fake;
  const int* j_fake;
  const int* n_tasks;
  const int* pins;
  const float* u;
  const int* j;
};

struct Trace {
  int* code;
  int* worker;
  int* n_tasks;
  int* task_workers;
  int* task_targets;
  int* frontend;
  int* view_gap;
  float* sync_age;
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

// The view's tables from mu, as ref.py builds them: Σμ left to right; no
// mass gives uniform weights. table: the scaled weights w · (n / Σw) and
// the reference's stack walk; cdf: the prefix sums over their last.
__device__ void build_views(const float* mu, int n, bool table, bool cdf_too,
                            float* p, float* prob, int* alias, int* stack,
                            float* cdf) {
  float total = 0.0f;
  for (int i = 0; i < n; ++i) total = total + mu[i];
  const bool guard = total > 0.0f;
  if (cdf_too) {
    float c = 0.0f;
    for (int i = 0; i < n; ++i) {
      c = c + (guard ? mu[i] : 1.0f);
      cdf[i] = c;
    }
    for (int i = 0; i < n; ++i) cdf[i] = cdf[i] / c;
  }
  if (!table) return;
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s = s + (guard ? mu[i] : 1.0f);
  const float f = (float)n / s;
  int ns = 0;
  for (int i = 0; i < n; ++i) {
    p[i] = (guard ? mu[i] : 1.0f) * f;
    prob[i] = 1.0f;
    alias[i] = i;
    if (p[i] < 1.0f) stack[ns++] = i;
  }
  int k = ns;
  for (int i = 0; i < n; ++i)
    if (!(p[i] < 1.0f)) stack[k++] = i;  // NaN counts as large
  int nl = n - ns;
  while (ns > 0 && nl > 0) {
    const int sm = stack[ns - 1], lg = stack[n - nl];
    prob[sm] = p[sm];
    alias[sm] = lg;
    const float pl = p[lg] - (1.0f - p[sm]);  // the large's residual mass
    p[lg] = pl;
    if (pl < 1.0f) {
      stack[ns - 1] = lg;  // the residual takes the vacated small slot
      --nl;
    } else {
      --ns;
    }
  }
}

__device__ __forceinline__ int alias_probe(const float* prob, const int* alias, int n,
                                           float u, float v) {
  int bin = (int)(u * (float)n);
  bin = bin < n - 1 ? bin : n - 1;
  return v < prob[bin] ? bin : alias[bin];
}

// #{i : cdf[i] <= u} clipped to n - 1
__device__ __forceinline__ int cdf_probe(const float* cdf, int n, float u) {
  int c = 0;
  for (int i = 0; i < n; ++i) c += cdf[i] <= u;
  return c < n - 1 ? c : n - 1;
}

__global__ void __launch_bounds__(kThreads) sim_chain_kernel(
    const int* __restrict__ conf_i, const float* __restrict__ conf_f,
    const float* __restrict__ mu_sched, const float* __restrict__ mu_hat0, Cols cols,
    int T, int n, int mt, int J, int K, int S, int cap, Trace tr, Final fin) {
  const int c = blockIdx.x, tid = threadIdx.x;
  const int* ci = conf_i + (size_t)c * NI;
  const float* cf = conf_f + (size_t)c * NF;
  const int policy = ci[POLICY], rounds = ci[ROUNDS], phases = ci[PHASES];
  const int refresh = ci[REFRESH], fold = ci[FOLD], fake_cap = ci[FAKE_CAP];
  const bool use_learner = ci[USE_LEARNER], use_fake = ci[USE_FAKE];
  const bool use_table = ci[USE_TABLE], theory = ci[THEORY];
  const float mu_bar = cf[MU_BAR], period = cf[PERIOD], nu_max = cf[NU_MAX];
  const float c0 = cf[C0], c_window = cf[C_WINDOW], theory_num = cf[THEORY_NUM];
  const float* sched = mu_sched + (size_t)c * K * n;

  extern __shared__ float smem[];
  float* samples = smem;
  float* stamps = samples + (size_t)n * cap;
  float* busy = stamps + (size_t)n * cap;
  float* epoch = busy + n;
  float* mu_hat = epoch + n;
  float* mu_max = mu_hat + n;
  float* p = mu_max + n;
  float* prob = p + n;
  float* cdf = prob + n;
  float* hcdf = cdf + n;
  float* arr_times = hcdf + n;
  int* q_real = reinterpret_cast<int*>(arr_times + S);
  int* q_fake = q_real + n;
  int* s_real = q_fake + n;
  int* widx = s_real + n;
  int* count = widx + n;
  int* alias = count + n;
  int* stack = alias + n;
  __shared__ float s_now, s_lam;

  for (int i = tid; i < n; i += kThreads) {
    busy[i] = epoch[i] = 0.0f;
    mu_hat[i] = mu_hat0[(size_t)c * n + i];
    float m = sched[i];
    for (int k = 1; k < phases; ++k) m = fmaxf(m, sched[(size_t)k * n + i]);
    mu_max[i] = m;
    q_real[i] = q_fake[i] = s_real[i] = widx[i] = count[i] = 0;
    for (int l = 0; l < cap; ++l) samples[(size_t)i * cap + l] = stamps[(size_t)i * cap + l] = 0.0f;
  }
  for (int i = tid; i < S; i += kThreads) arr_times[i] = 0.0f;
  // thread 0's scalar state
  float now = 0.0f, lam_hat = 0.0f;
  int arr_idx = 0, arr_count = 0;
  int view_phase = -1, halo_phase = -1;  // the phase the tables were built for
  bool view_stale = true;                // learner: μ̂ refreshed since the build
  const float nu_den = fmaxf(nu_max, 1e-30f);
  __syncthreads();

  for (int t = 0; t < rounds; ++t) {
    const size_t row = (size_t)c * T + t;
    if (tid == 0) {
      const float dt = cols.dt[row];
      const int ev = cols.ev[row];
      now = now + dt;
      const int phase =
          (phases == 1 || isinf(period)) ? 0 : ((int)(now / period)) % phases;
      const float* mu_now = sched + (size_t)phase * n;
      int code = EV_SELF_LOOP, worker = -1, nt = 0;
      int* tw = tr.task_workers + row * mt;
      int* tt = tr.task_targets + row * mt;
      for (int b = 0; b < mt; ++b) tw[b] = tt[b] = -1;
      if (ev == 0) {  // an arrival
        code = EV_ARRIVAL;
        nt = cols.n_tasks[row];
        arr_times[arr_idx] = now;
        arr_idx = (arr_idx + 1) % S;
        arr_count += 1;
        const int k = arr_count < S ? arr_count : S;
        const float oldest = arr_count >= S ? arr_times[arr_idx % S] : arr_times[0];
        const float span = now - oldest;
        if (k >= 2 && span > 0.0f) lam_hat = (float)(k - 1) / span;
        // the view's μ and its tables
        const float* mu_view = use_learner ? mu_hat : mu_now;
        const bool probes_mu = policy == PSS || policy == PPOT_SQ2 ||
                               policy == PPOT_LL2 || policy == BANDIT;
        if (probes_mu && (use_learner ? view_stale : view_phase != phase)) {
          build_views(mu_view, n, use_table, !use_table, p, prob, alias, stack, cdf);
          view_stale = false;
          view_phase = phase;
        }
        if (policy == HALO && halo_phase != phase) {
          build_views(mu_now, n, false, true, p, prob, alias, stack, hcdf);
          halo_phase = phase;
        }
        const int* pins = cols.pins + row * mt;
        const float* u = cols.u + row * 4 * mt;
        const int* jj = cols.j + row * J;
        int w[kMaxMt];
        // q_work: the engine's view (re-snapshotted after each chunk); the
        // true queue is folded at the end. Kept as per-slot counts over
        // q_real so that q_real stays the snapshot until the fold.
        if (policy == SPARROW) {
          int probes = 2 * mt;
          int load[kMaxProbes];
          int m = 0;
          for (int b = 0; b < mt; ++b) m += (b < nt && pins[b] < 0);
          for (int q = 0; q < probes; ++q) {
            const int wq = jj[q];
            int l = q_real[wq];
            for (int b = 0; b < mt; ++b) l += (b < nt && pins[b] == wq);  // pins first
            load[q] = l;
          }
          int seq[kMaxMt];
          for (int k2 = 0; k2 < m; ++k2) {  // greedy: least load, earliest probe
            int best = 0;
            for (int q = 1; q < probes; ++q)
              if (load[q] < load[best]) best = q;
            const int wb = jj[best];
            seq[k2] = wb;
            for (int q = 0; q < probes; ++q) load[q] += jj[q] == wb;
          }
          int r = 0;
          for (int b = 0; b < mt; ++b)
            w[b] = b >= nt ? -1 : pins[b] >= 0 ? pins[b] : seq[r++];
        } else {
          const int chunks = fold < 1 ? 1 : (fold > mt ? mt : fold);
          const int cs = (mt + chunks - 1) / chunks;
          int placed[kMaxMt];  // active slots placed so far (their workers)
          int np = 0;
          for (int c0s = 0; c0s < mt; c0s += cs) {
            const int c1s = c0s + cs < mt ? c0s + cs : mt;
            for (int b = c0s; b < c1s; ++b) {
              int sel;
              // the queue the slot sees: the snapshot plus earlier chunks
              auto qv = [&](int x) {
                int v = q_real[x];
                for (int a = 0; a < np; ++a) v += placed[a] == x;
                return v;
              };
              auto probe = [&](int ui, int vi) {
                return use_table ? alias_probe(prob, alias, n, u[ui * mt + b], u[vi * mt + b])
                                 : cdf_probe(cdf, n, u[ui * mt + b]);
              };
              if (policy == UNIFORM) {
                sel = jj[b];
              } else if (policy == POT) {
                const int j1 = jj[b], j2 = jj[mt + b];
                sel = qv(j1) <= qv(j2) ? j1 : j2;
              } else if (policy == PSS) {
                sel = probe(0, 2);
              } else if (policy == HALO) {
                sel = cdf_probe(hcdf, n, u[b]);
              } else {
                const int j1 = probe(0, 2), j2 = probe(1, 3);
                if (policy == PPOT_LL2) {
                  const float w1 = ((float)qv(j1) + 1.0f) / fmaxf(mu_view[j1], 1e-9f);
                  const float w2 = ((float)qv(j2) + 1.0f) / fmaxf(mu_view[j2], 1e-9f);
                  sel = w1 <= w2 ? j1 : j2;
                } else {
                  sel = qv(j1) <= qv(j2) ? j1 : j2;
                  if (policy == BANDIT && jj[mt + b] != 0) sel = jj[b];
                }
              }
              if (pins[b] >= 0) sel = pins[b];
              w[b] = sel;
            }
            for (int b = c0s; b < c1s; ++b)
              if (b < nt) placed[np++] = w[b];
          }
          for (int b = nt; b < mt; ++b) w[b] = -1;
        }
        // completion targets on the true queues, busy clocks, then the fold
        for (int b = 0; b < nt && b < mt; ++b) {
          const int wb = w[b];
          int rank = 0;
          for (int a = 0; a < b; ++a) rank += w[a] == wb;
          tw[b] = wb;
          tt[b] = s_real[wb] + q_real[wb] + rank + 1;
        }
        for (int b = 0; b < nt && b < mt; ++b)
          if (q_real[w[b]] + q_fake[w[b]] == 0) busy[w[b]] = now;
        // (an idle worker given two slots is set twice to the same now;
        // the test reads q before any slot is folded)
        for (int b = 0; b < nt && b < mt; ++b) q_real[w[b]] += 1;
      } else if (ev <= n) {  // a potential service event
        const int wv = ev - 1;
        worker = wv;
        const bool accept = cols.u_svc[row] < mu_now[wv] / fmaxf(mu_max[wv], 1e-30f);
        const bool has_real = q_real[wv] > 0, has_fake = q_fake[wv] > 0;
        const bool do_real = accept && has_real;
        const bool do_fake = accept && !has_real && has_fake;
        if (do_real || do_fake) {
          const int slot = widx[wv];
          samples[(size_t)wv * cap + slot] = now - busy[wv];
          stamps[(size_t)wv * cap + slot] = now;
          widx[wv] = (slot + 1) % cap;
          count[wv] += 1;
          busy[wv] = now;
        }
        if (do_real) {
          q_real[wv] -= 1;
          s_real[wv] += 1;
          code = EV_REAL_DONE;
        } else if (do_fake) {
          q_fake[wv] -= 1;
          code = EV_FAKE_DONE;
        }
      } else {  // a potential benchmark-job dispatch
        const int jf = cols.j_fake[row];
        worker = jf;
        const float nu = c0 * fmaxf(mu_bar - lam_hat, 0.0f);
        const bool accept = cols.u_fake[row] < nu / nu_den;
        if (accept && use_fake && q_fake[jf] < fake_cap) {
          if (q_real[jf] + q_fake[jf] == 0) busy[jf] = now;
          q_fake[jf] += 1;
          code = EV_FAKE_DISPATCH;
        }
      }
      tr.code[row] = code;
      tr.worker[row] = worker;
      tr.n_tasks[row] = nt;
      tr.frontend[row] = code == EV_ARRIVAL ? 0 : -1;
      tr.view_gap[row] = 0;
      tr.sync_age[row] = 0.0f;
      tr.now[row] = now;
      tr.lam_hat[row] = lam_hat;
      tr.killed_fake[row] = 0;
      s_now = now;
      s_lam = lam_hat;
    }
    __syncthreads();
    if (use_learner && t % refresh == 0) {
      // the window parameters (core/learner.window_params), the same f32
      // operations on every thread
      const float lam = s_lam, tnow = s_now;
      float alpha = lam / fmaxf(mu_bar, 1e-9f);
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
      for (int i = tid; i < n; i += kThreads) {
        const int cnt = count[i], wi = widx[i];
        float mu_new = mu_hat[i];
        if (cnt > 0) {
          const int k = cnt < L_avg ? cnt : L_avg;
          const int filled = cnt < cap ? cnt : cap;
          float s = 0.0f;
          int nval = 0;
          for (int l = 0; l < cap; ++l) {
            const int age = ((wi - 1 - l) % cap + cap) % cap;
            if (age < k && l < filled) {
              s = s + samples[(size_t)i * cap + l];
              ++nval;
            }
          }
          const float q_hat = s / (float)(nval > 1 ? nval : 1);
          mu_new = num / fmaxf(q_hat, 1e-9f);
        }
        const float t_lth = stamps[(size_t)i * cap + ((wi - L) % cap + cap) % cap];
        const float t_ref = cnt >= L ? t_lth : epoch[i];
        mu_hat[i] = (tnow - t_ref) > horizon ? 0.0f : mu_new;
      }
      if (tid == 0) view_stale = true;
      __syncthreads();
    }
    if (tr.q_real != nullptr)
      for (int i = tid; i < n; i += kThreads) tr.q_real[row * n + i] = q_real[i];
    if (tr.mu_hat != nullptr)
      for (int i = tid; i < n; i += kThreads) tr.mu_hat[row * n + i] = mu_hat[i];
    __syncthreads();
  }

  // the final state
  const size_t cn = (size_t)c * n;
  for (int i = tid; i < n; i += kThreads) {
    fin.q_real[cn + i] = q_real[i];
    fin.q_fake[cn + i] = q_fake[i];
    fin.s_real[cn + i] = s_real[i];
    fin.busy_start[cn + i] = busy[i];
    fin.widx[cn + i] = widx[i];
    fin.count[cn + i] = count[i];
    fin.epoch_start[cn + i] = epoch[i];
    fin.mu_hat[cn + i] = mu_hat[i];
    for (int l = 0; l < cap; ++l) {
      fin.samples[(cn + i) * cap + l] = samples[(size_t)i * cap + l];
      fin.stamps[(cn + i) * cap + l] = stamps[(size_t)i * cap + l];
    }
  }
  for (int i = tid; i < S; i += kThreads) fin.arr_times[(size_t)c * S + i] = arr_times[i];
  if (tid == 0) {
    fin.now[c] = now;
    fin.lam_hat[c] = lam_hat;
    fin.arr_idx[c] = arr_idx;
    fin.arr_count[c] = arr_count;
  }
}

}  // namespace

extern "C" {

int sim_chain(const int* conf_i, const float* conf_f, const float* mu_sched,
              const float* mu_hat0, const float* dt, const int* ev, const float* u_svc,
              const float* u_fake, const int* j_fake, const int* n_tasks, const int* pins,
              const float* u, const int* j, int C, int T, int n, int mt, int J, int K, int S,
              int cap, int trace_queues, int trace_mu, int* t_code, int* t_worker,
              int* t_n_tasks, int* t_task_workers, int* t_task_targets, int* t_frontend,
              int* t_view_gap, float* t_sync_age, float* t_now, float* t_lam_hat,
              int* t_killed_fake, int* t_q_real, float* t_mu_hat, float* f_now,
              int* f_q_real, int* f_q_fake, int* f_s_real, float* f_busy_start,
              float* f_arr_times, int* f_arr_idx, int* f_arr_count, float* f_lam_hat,
              float* f_samples, float* f_stamps, int* f_widx, int* f_count,
              float* f_epoch_start, float* f_mu_hat, cudaStream_t stream) {
  if (C < 1 || n < 1 || mt < 1 || mt > kMaxMt || J < 2 * mt || K < 1 || S < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)8 * n * cap + (size_t)60 * n + (size_t)4 * S;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sim_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Cols cols{dt, ev, u_svc, u_fake, j_fake, n_tasks, pins, u, j};
  Trace tr{t_code, t_worker, t_n_tasks, t_task_workers, t_task_targets, t_frontend,
           t_view_gap, t_sync_age, t_now, t_lam_hat, t_killed_fake,
           trace_queues ? t_q_real : nullptr, trace_mu ? t_mu_hat : nullptr};
  Final fin{f_now, f_q_real, f_q_fake, f_s_real, f_busy_start, f_arr_times, f_arr_idx,
            f_arr_count, f_lam_hat, f_samples, f_stamps, f_widx, f_count, f_epoch_start,
            f_mu_hat};
  sim_chain_kernel<<<C, kThreads, smem, stream>>>(conf_i, conf_f, mu_sched, mu_hat0, cols, T,
                                                  n, mt, J, K, S, cap, tr, fin);
  return (int)cudaGetLastError();
}

const char* sim_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
