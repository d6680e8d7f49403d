"""The plain chain: ``sim_chain``'s plain version, one round at a time.

A Python loop over rounds on torch tensors, in the reference's order
within a round (``src/repro/core/simulator.py:553-735``):

  1. ``now += dt``;
  2. under an environment: a membership change (the active mask at
     ``now`` differs from the last) cold-starts the rejoining workers in
     the learner (``core.learner.reset_workers``), gives them a burst of
     benchmark jobs (capped at ``fake_cap``) and restarts their busy clock
     where it was stale (idle, or stalled by a blackout); then at most one
     crash of the fault track empties its worker's queues;
  3. the sync at true state, every ``fleet_sync_every`` rounds (at t = 0
     only, when it is <= 0) or on a membership change: the views are the
     true queue, their μ is μ̂ (or, with known speeds, the current μ), and
     the alias table or CDF is built from that μ under the active mask
     (rebuilt only when μ or the mask changed: the same inputs give the
     same table); in the paper's own mode it fires every round;
  4. the branch the round's event picks: an arrival (thinned by
     λ(now)/λmax under an environment; the estimator, the frontend, its
     stale view, then the job through the dispatch engine
     ``core.dispatch.place``, then the completion targets on the true
     queues), a service event (thinned by μ(now)/μmax and by a blackout;
     the real queue drains before the fake one; a completion feeds the
     learner ring) or a benchmark dispatch (to an active worker);
  5. the learner refresh every ``learner_refresh`` rounds, after the
     branch;
  6. the trace row, after the refresh;
  7. with telemetry (``OBS``), the window fold of the round
     (``ObsFold``: its real completion's service time, its dispatched
     tasks, its killed tasks, the true queues, λ̂, μ̂ and μ(now) under the
     active mask), the detector at a window boundary, the window's row,
     then the reset.

Every float reduction runs left to right in f32: Σμ and the cumulative
sum of the alias scaling and the CDF (numpy's ``accumulate``, a plain
loop), the ring sum of the refresh (lane 0 up, invalid lanes adding +0),
the kept μ̂ of a cold start, the herd correction's Σμ and the fleet's
Σλ̂. The kernel makes the same sums in the same order and its other float
operations one IEEE operation each (the frontends' λ̂ EMA step one fused
multiply-add, as the reference's), so the two agree bit for bit on the
same draws. The draws are ``core.simulator.draw_rounds``'s columns.

The chains of a batch run one after another; each reads its row of the
config arrays (fields below), of every draw column and, outside the paper's
own mode, of the environment and fleet inputs (``EXT``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dispatch as dsp
from repro_torch.core import estimator as est
from repro_torch.core import learner as lrn
from repro_torch.core import policies as pol
from repro_torch.kernels.ppot_dispatch import ref as pref
from repro_torch.obs import detect as obd
from repro_torch.obs import windows as obw

f32 = np.float32

# conf_i fields (i32)
POLICY, ROUNDS, USE_LEARNER, USE_FAKE, FAKE_CAP, REFRESH, FOLD, USE_TABLE, THEORY, PHASES = \
    range(10)
NI = 10
# conf_f fields (f32): μ̄, the phase period (inf: static), νmax, c0, the
# window constant c and the theory window's numerator c·log(n)
MU_BAR, PERIOD, NU_MAX, C0, C_WINDOW, THEORY_NUM = range(6)
NF = 6

# conf_x fields (i32) of the environment and fleet modes: whether an
# environment is given, S frontends, the sync cadence, the herd correction,
# the load balancer (LB_*), the segment counts of the λ, μ, membership and
# stall tracks (0: no blackouts), the crashes (0: none) and the rejoin burst
ENV, FRONTENDS, SYNC_EVERY, HERD, LB, KA, KC, KM, KS, KCRASH, BURST = range(11)
NX = 11
# conf_xf fields (f32): λmax, the thinning bound
LAM_MAX = 0
NXF = 1
LB_UNIFORM, LB_WEIGHTED, LB_STICKY = range(3)
#: the environment and fleet inputs of a batch (``core.simulator.ext_config``):
#: name -> (dtype, per-chain width: None rows, "n" rows of n)
EXT = {"conf_x": (torch.int32, None), "conf_xf": (torch.float32, None),
       "lam_bp": (torch.float32, None), "lam_val": (torch.float32, None),
       "mu_bp": (torch.float32, None), "mu_val": (torch.float32, "n"),
       "act_bp": (torch.float32, None), "act_val": (torch.int32, "n"),
       "stall_bp": (torch.float32, None), "stall_val": (torch.int32, "n"),
       "crash_t": (torch.float32, None), "crash_w": (torch.int32, None)}

# conf_o fields (i32) of the in-chain telemetry: whether the chain folds it,
# the window in rounds, the histogram's bins, whether the detector runs, its
# warm-up and cool-down windows
OBS_ON, WINDOW, BINS, DETECT, WARMUP, COOLDOWN = range(6)
NO = 6
# conf_of fields (f32): 1/n (the paper mean's factor), the detector's EMA
# and re-baseline rates, k, h, the five relative scale floors, the absolute
# floor, the CUSUM decay and the two clips
INV_N, EMA_ALPHA, REBASE_ALPHA, K_SIGMA, H_SIGMA = range(5)
REL_FLOOR = 5  # five entries, one a signal
ABS_FLOOR, DECAY, CLIP_Z, SCALE_CLIP_Z = range(10, 14)
NOF = 14
#: the telemetry inputs of a batch (``core.simulator.obs_config``): conf_o,
#: conf_of and the histogram's thresholds (``obs.windows.hist_thresholds``,
#: padded with +inf to the batch's most bins)
OBS = {"conf_o": torch.int32, "conf_of": torch.float32, "obs_thr": torch.float32}

EV_ARRIVAL, EV_REAL_DONE, EV_FAKE_DONE, EV_FAKE_DISPATCH, EV_SELF_LOOP = range(5)

#: the trace columns: name -> (dtype, per-round width: None scalar, "mt",
#: "n", or 0)
TRACE = {
    "code": (torch.int32, None), "worker": (torch.int32, None),
    "n_tasks": (torch.int32, None), "task_workers": (torch.int32, "mt"),
    "task_targets": (torch.int32, "mt"), "frontend": (torch.int32, None),
    "view_gap": (torch.int32, None), "sync_age": (torch.float32, None),
    "now": (torch.float32, None), "lam_hat": (torch.float32, None),
    "killed": (torch.int32, 0), "killed_fake": (torch.int32, None),
    "q_real": (torch.int32, "n"), "mu_hat": (torch.float32, "n"),
}


def trace_shapes(T: int, n: int, mt: int, trace_queues: bool, trace_mu: bool,
                 killed: bool = False, obs_bins: int | None = None) -> dict:
    """name -> (dtype, shape of one chain's column); ``killed`` [T, n] with
    a crash track, else [T, 0]; with telemetry (``obs_bins``: the batch's
    most histogram bins) the packed window rows ``obs`` [T, W]
    (``obs.windows.row_words``)."""
    width = {None: (), "mt": (mt,), "n": (n,), 0: ((n,) if killed else (0,))}
    out = {}
    for name, (dt, w) in TRACE.items():
        shape = (T,) + width[w]
        if (name == "q_real" and not trace_queues) or (name == "mu_hat" and not trace_mu):
            shape = (T, 0)
        out[name] = (dt, shape)
    if obs_bins is not None:
        out["obs"] = (torch.int32, (T, obw.row_words(obs_bins)))
    return out


def final_shapes(n: int, ring_cap: int, arrival_window: int,
                 frontends: int | None = None) -> dict:
    """name -> (dtype, shape) of one chain's final state; outside the
    paper's mode (``frontends``: the batch's most frontends) also the next
    crash, the views' snapshot, the frontends' own placements, the view's
    μ, the frontends' λ̂ EMA state, the last sync's time, the fleet's Σλ̂
    and the view's alias table (one copy of what the sync gives every
    frontend)."""
    i32, fl = torch.int32, torch.float32
    ext = {} if frontends is None else {
        "crash_i": (i32, ()), "q_snap": (i32, (n,)), "q_delta": (i32, (frontends, n)),
        "mu_view": (fl, (n,)), "ema_last": (fl, (frontends,)), "ema_gap": (fl, (frontends,)),
        "ema_count": (i32, (frontends,)), "t_sync": (fl, ()), "lam_global": (fl, ()),
        "alias_p": (fl, (n,)), "alias_a": (i32, (n,))}
    return ext | {
        "now": (fl, ()), "q_real": (i32, (n,)), "q_fake": (i32, (n,)),
        "s_real": (i32, (n,)), "busy_start": (fl, (n,)),
        "arr_times": (fl, (arrival_window,)), "arr_idx": (i32, ()),
        "arr_count": (i32, ()), "lam_hat": (fl, ()),
        "samples": (fl, (n, ring_cap)), "stamps": (fl, (n, ring_cap)),
        "widx": (i32, (n,)), "count": (i32, (n,)), "epoch_start": (fl, (n,)),
        "mu_hat": (fl, (n,)),
    }


def seq_cumsum(w: np.ndarray) -> np.ndarray:
    """Inclusive f32 prefix sums, left to right."""
    return np.add.accumulate(np.asarray(w, np.float32))


def guarded_weights(mu: np.ndarray) -> np.ndarray:
    """μ, or uniform weights if it has no mass (Σμ left to right)."""
    mu = np.asarray(mu, np.float32)
    return mu if seq_cumsum(mu)[-1] > 0 else np.ones_like(mu)


def scaled_weights(mu: np.ndarray) -> np.ndarray:
    """The alias table's weights: w · (n / Σw), mean 1."""
    w = guarded_weights(mu)
    return w * (f32(w.shape[0]) / seq_cumsum(w)[-1])


def make_cdf(mu: np.ndarray) -> np.ndarray:
    """The inverse-CDF draw's table: the prefix sums over their last."""
    c = seq_cumsum(guarded_weights(mu))
    return c / c[-1]


def masked_weights(mu: np.ndarray, act: np.ndarray) -> np.ndarray:
    """μ with the inactive workers' mass zeroed; if no active worker has
    mass, 1 on the active workers (all ones if none is active)."""
    mu, act = np.asarray(mu, np.float32), np.asarray(act, bool)
    w = np.where(act, mu, f32(0.0)).astype(np.float32)
    if seq_cumsum(w)[-1] > 0:
        return w
    return act.astype(np.float32) if act.any() else np.ones_like(mu)


def view_table(mu: torch.Tensor, act: torch.Tensor | None):
    """(prob, alias) of the alias table of ``mu`` under the active mask
    ``act`` (None: every worker), as the sync builds it."""
    m = mu.cpu().numpy()
    if act is None:
        return pref.alias_table_ref(torch.from_numpy(scaled_weights(m)).to(mu.device))
    p = torch.from_numpy(scaled_weights(masked_weights(m, act.cpu().numpy()))).to(mu.device)
    return pref.alias_table_ref(p, act.to(torch.bool).to(mu.device))


class _Views:
    """The view's alias table and CDF of one μ (and active mask), rebuilt
    when either changes."""

    def __init__(self, dev):
        self.dev = dev
        self.mu = self.act = None

    def of(self, mu: torch.Tensor, act: torch.Tensor | None = None):
        if (self.mu is None or not torch.equal(self.mu, mu)
                or (act is not None and not torch.equal(self.act, act))):
            self.mu, self.act = mu.clone(), None if act is None else act.clone()
            m = mu.cpu().numpy()
            w = m if act is None else masked_weights(m, act.cpu().numpy())
            self.prob, self.alias = view_table(mu, act)
            self.cdf = torch.from_numpy(make_cdf(w)).to(self.dev)
        return self


def active_choice(order: list, n: int, u: float) -> int:
    """``dispatch.active_choice`` on the active workers ``order`` (in index
    order): the uniform ``u`` in [0, 1) picks one; none active: u · n."""
    k = len(order)
    if k == 0:
        return int(f32(f32(u) * f32(n)))
    return order[min(int(f32(f32(u) * f32(k))), k - 1)]


def _probe_draws(policy: str, u: torch.Tensor, j: torch.Tensor, mt: int, view: _Views,
                 halo: _Views, use_table: bool, jw: torch.Tensor | None = None) -> dict:
    """The engine's draws for one job from the round's raw draws u [4, mt]
    and j [J] and the current tables; ``jw`` [J] replaces j's uniform
    workers (under an environment, drawn over the active workers)."""
    jf = j
    j = j if jw is None else jw
    def probe(ui, vi):
        if use_table:
            return pref.alias_probe(view.prob, view.alias, u[ui], u[vi])
        return pref.cdf_probe(view.cdf, u[ui])

    if policy == pol.UNIFORM:
        return {"j_uni": j[:mt]}
    if policy == pol.POT:
        return {"j1": j[:mt], "j2": j[mt:2 * mt]}
    if policy == pol.PSS:
        return {"j1": probe(0, 2)}
    if policy == pol.HALO:
        return {"j1": pref.cdf_probe(halo.cdf, u[0])}
    if policy in (pol.PPOT_SQ2, pol.PPOT_LL2):
        return {"j1": probe(0, 2), "j2": probe(1, 3)}
    if policy == pol.BANDIT:
        return {"j1": probe(0, 2), "j2": probe(1, 3), "explore": jf[mt:2 * mt] != 0,
                "j_uni": j[:mt]}
    return {"probes": j[:max(2 * mt, mt)]}  # Sparrow, d = 2


def run_chain(ci: list, cf: list, mu_sched: torch.Tensor, mu_hat0: torch.Tensor,
              cols: dict, *, n: int, mt: int, ring_cap: int, arrival_window: int,
              trace_queues: bool, trace_mu: bool, x: dict | None = None,
              o: dict | None = None):
    """One chain: (final dict, trace dict) for its own rounds; ``x`` the
    chain's environment and fleet inputs (``EXT``, conf_x and conf_xf as
    lists), None in the paper's own mode; ``o`` its telemetry inputs
    (``OBS``, conf_o and conf_of as lists, and ``HB``, the batch's most
    bins), None in a batch without telemetry: the trace then has no
    ``obs`` column, and a chain of a batch with it that folds none leaves
    its rows zero."""
    dev = mu_sched.device
    i32 = torch.int32
    policy = pol.ALL_POLICIES[ci[POLICY]]
    T, K, refresh = ci[ROUNDS], ci[PHASES], ci[REFRESH]
    use_learner, use_fake, use_table = bool(ci[USE_LEARNER]), bool(ci[USE_FAKE]), \
        bool(ci[USE_TABLE])
    mu_bar, period, nu_max, c0 = (f32(cf[k]) for k in (MU_BAR, PERIOD, NU_MAX, C0))
    lcfg = lrn.LearnerConfig(mu_bar=mu_bar, c0=c0, c_window=f32(cf[C_WINDOW]),
                             window_mode="theory" if ci[THEORY] else "practical",
                             ring_cap=ring_cap)
    sched = mu_sched[:K]
    S, cap = arrival_window, ring_cap
    ext = x is not None
    env = ext and bool(x["conf_x"][ENV])
    if env:
        cx = x["conf_x"]
        segs = lambda name, k: x[name][:cx[k]].cpu().numpy()  # noqa: E731
        lam_bp, lam_val = segs("lam_bp", KA), segs("lam_val", KA)
        mu_bp, mu_val = segs("mu_bp", KC), x["mu_val"][:cx[KC]]
        act_bp, act_val = segs("act_bp", KM), x["act_val"][:cx[KM]].to(torch.bool)
        stall_bp = segs("stall_bp", KS) if cx[KS] else None
        stall_val = x["stall_val"][:cx[KS]].to(torch.bool) if cx[KS] else None
        crash_t, crash_w = segs("crash_t", KCRASH), segs("crash_w", KCRASH)
        sched = mu_val
    mu_max = sched.max(0).values
    mu_max_h = mu_max.cpu().numpy()
    nu_den = max(nu_max, f32(1e-30))

    # state
    now, lam_hat = f32(0.0), f32(0.0)
    q_real = torch.zeros(n, dtype=i32, device=dev)
    q_fake, s_real = torch.zeros_like(q_real), torch.zeros_like(q_real)
    busy = torch.zeros(n, dtype=torch.float32, device=dev)
    arr_times = torch.zeros(S, dtype=torch.float32, device=dev)
    arr_idx = arr_count = 0
    samples = torch.zeros(n, cap, dtype=torch.float32, device=dev)
    stamps = torch.zeros_like(samples)
    widx, count = torch.zeros_like(q_real), torch.zeros_like(q_real)
    epoch = torch.zeros_like(busy)
    mu_hat = mu_hat0.clone()

    dts, evs = cols["dt"][:T].tolist(), cols["ev"][:T].tolist()
    u_svc, u_fake = cols["u_svc"][:T].tolist(), cols["u_fake"][:T].tolist()
    j_fake, n_tasks_c = cols["j_fake"][:T].tolist(), cols["n_tasks"][:T].tolist()
    pins, uu, jj = cols["pins"], cols["u"], cols["j"]
    slots = torch.arange(mt, device=dev)
    view, halo = _Views(dev), _Views(dev)
    fold = ci[FOLD]

    sc = {k: [] for k in ("code", "worker", "n_tasks", "frontend", "now", "lam_hat",
                          "view_gap", "sync_age", "killed_fake")}
    tw = torch.full((T, mt), -1, dtype=i32, device=dev)
    tt = torch.full((T, mt), -1, dtype=i32, device=dev)
    tq = torch.zeros((T, n if trace_queues else 0), dtype=i32, device=dev)
    tm = torch.zeros((T, n if trace_mu else 0), dtype=torch.float32, device=dev)
    lanes = torch.arange(cap, device=dev)
    ofold = tobs = None
    if o is not None:
        tobs = np.zeros((T, obw.row_words(o["HB"])), np.int32)
        if o["conf_o"][OBS_ON]:
            ofold = ObsFold(o["conf_o"], o["conf_of"], o["obs_thr"].cpu().numpy(), o["HB"], n)

    if ext:  # the fleet: one snapshot, view μ and sync time for all S frontends
        F = x["conf_x"][FRONTENDS]
        sync_every, herd = x["conf_x"][SYNC_EVERY], bool(x["conf_x"][HERD])
        lb, burst = x["conf_x"][LB], x["conf_x"][BURST]
        lam_max = f32(x["conf_xf"][LAM_MAX])
        u_thin, fe = cols["u_thin"][:T].tolist(), cols["fe"][:T].tolist()
        u_pin, u_jfake, uj = cols["u_pin"], cols["u_jfake"][:T].tolist(), cols["uj"]
        q_snap = torch.zeros_like(q_real)
        q_delta = torch.zeros((F, n), dtype=i32, device=dev)
        mu_view = mu_hat0.clone()
        ema = [est.init_ema_arrival() for _ in range(F)]
        t_sync, lam_global, herd_tot = f32(0.0), f32(0.0), f32(1.0)
        crash_i = 0
        killed = torch.zeros((T, n if env and len(crash_t) else 0), dtype=i32, device=dev)
        act = (act_val[env_segment(act_bp, now)] if env
               else torch.ones(n, dtype=torch.bool, device=dev))
        stall = stall_val[env_segment(stall_bp, now)] if env and stall_bp is not None else None
        order = torch.nonzero(act)[:, 0].tolist()

    for t in range(T):
        now = f32(now + f32(dts[t]))
        if env:
            mu_now = mu_val[env_segment(mu_bp, now)]
        else:
            phase = 0 if K == 1 or not np.isfinite(period) else int(now / period) % K
            mu_now = sched[phase]
        ev = evs[t]
        nt, worker, code = 0, -1, EV_SELF_LOOP
        frontend, view_gap, sync_age, killed_fake = -1, 0, f32(0.0), 0
        svc, svc_ok, kl = f32(0.0), False, 0
        memb = False
        if env:
            act_new = act_val[env_segment(act_bp, now)]
            stall_prev = stall
            if stall_bp is not None:
                stall = stall_val[env_segment(stall_bp, now)]
            memb = not torch.equal(act_new, act)
            if memb:  # cold start, burst and busy clock of the rejoining workers
                rejoin = act_new & ~act
                if use_learner:
                    samples, stamps, widx, count, epoch, mu_hat = _reset_workers(
                        rejoin, act_new, now, samples, stamps, widx, count, epoch, mu_hat)
                stale = (q_real + q_fake) == 0
                if stall_prev is not None:
                    stale = stale | stall_prev
                if use_fake:
                    q_fake = torch.where(rejoin, (q_fake + burst).clamp(max=ci[FAKE_CAP]),
                                         q_fake)
                busy = torch.where(rejoin & stale, float(now), busy)
                act = act_new
                order = torch.nonzero(act)[:, 0].tolist()
            if crash_i < len(crash_t) and now >= crash_t[crash_i]:
                w = int(crash_w[crash_i])
                kreal, killed_fake = int(q_real[w]), int(q_fake[w])
                killed[t, w] = kl = kreal
                q_real[w], q_fake[w] = 0, 0
                s_real[w] += kreal
                busy[w] = float(now)
                crash_i += 1
        if ext and ((t % sync_every == 0) if sync_every > 0 else t == 0) | memb:
            q_snap = q_real.clone()
            q_delta.zero_()
            mu_view = (mu_hat if use_learner else mu_now).clone()
            herd_tot = max(seq_cumsum(mu_view.clamp(min=0.0).cpu().numpy())[-1], f32(1e-9))
            t_sync = now
            lam_global = seq_cumsum([est.lam_hat_ema(e) for e in ema])[-1]
        if ev == 0 and env and not f32(f32(u_thin[t]) * lam_max) < f32(
                lam_val[env_segment(lam_bp, now)]):
            pass  # a thinned arrival: a self-loop
        elif ev == 0:  # an arrival
            nt, code = n_tasks_c[t], EV_ARRIVAL
            sticky_ordinal = arr_count
            arr_times[arr_idx] = float(now)
            arr_idx, arr_count = (arr_idx + 1) % S, arr_count + 1
            k = min(arr_count, S)
            oldest = f32(arr_times[arr_idx % S if arr_count >= S else 0].item())
            span = f32(now - oldest)
            if k >= 2 and span > 0:
                lam_hat = f32(f32(k - 1) / span)
            active = slots < nt
            if not ext:
                q_view = q_real
                mu_view = mu_hat if use_learner else mu_now
                d = _probe_draws(policy, uu[t], jj[t], mt, view.of(mu_view),
                                 halo.of(mu_now) if policy == pol.HALO else halo, use_table)
                forced = pins[t]
            else:
                frontend = sticky_ordinal % F if lb == LB_STICKY else fe[t]
                q_view = q_snap + q_delta[frontend]
                view_gap = int((q_view - q_real).abs().sum())
                sync_age = f32(now - t_sync)
                if herd:
                    lam_f = est.lam_hat_ema(ema[frontend])
                    rate = f32(f32(f32(F - 1) * max(lam_f, f32(0.0))) * max(sync_age, f32(0.0)))
                    mu_v = np.maximum(mu_view.cpu().numpy(), f32(0.0))
                    extra = np.rint((rate * mu_v) / herd_tot).astype(np.int32)
                    q_view = q_view + torch.from_numpy(extra).to(dev)
                jw = (torch.tensor([active_choice(order, n, v) for v in uj[t].tolist()],
                                   dtype=i32, device=dev) if env else None)
                d = _probe_draws(policy, uu[t], jj[t], mt, view.of(mu_view, act),
                                 halo.of(mu_now, act) if policy == pol.HALO else halo,
                                 use_table, jw)
                forced = pins[t]
                if env:
                    forced = torch.tensor(
                        [active_choice(order, n, v) if p >= 0 else -1
                         for p, v in zip(forced.tolist(), u_pin[t].tolist())],
                        dtype=i32, device=dev)
            res = dsp.place(policy, d, q_view, mu_view, mt, active=active, forced=forced,
                            fold_chunks=fold)
            counts = res.q_after - q_view
            rank = dsp.within_batch_rank(res.workers, active)
            wsafe = torch.where(active, res.workers, 0).long()
            tw[t] = res.workers
            tt[t] = torch.where(active, s_real[wsafe] + q_real[wsafe] + rank + 1, -1)
            was_idle = (q_real + q_fake) == 0
            busy = torch.where((counts > 0) & was_idle, float(now), busy)
            q_real = q_real + counts
            if ext:
                q_delta[frontend] += counts
                ema[frontend] = est.observe_arrivals_ema(ema[frontend], now, 1,
                                                         window=est.EMA_ARR_WINDOW)
        elif ev <= n:  # a potential service event at worker ev - 1
            w = ev - 1
            worker = w
            accept = f32(u_svc[t]) < f32(f32(mu_now[w].item()) / max(f32(mu_max_h[w]),
                                                                     f32(1e-30)))
            if env and stall is not None and bool(stall[w]):
                accept = False
            has_real, has_fake = q_real[w].item() > 0, q_fake[w].item() > 0
            do_real = accept and has_real
            do_fake = accept and not has_real and has_fake
            svc, svc_ok = f32(now - f32(busy[w].item())), do_real
            if do_real or do_fake:
                slot = widx[w].item()
                samples[w, slot] = float(f32(now - f32(busy[w].item())))
                stamps[w, slot] = float(now)
                widx[w] = (slot + 1) % cap
                count[w] += 1
                busy[w] = float(now)
            if do_real:
                q_real[w] -= 1
                s_real[w] += 1
                code = EV_REAL_DONE
            elif do_fake:
                q_fake[w] -= 1
                code = EV_FAKE_DONE
        else:  # a potential benchmark-job dispatch
            worker = j = active_choice(order, n, u_jfake[t]) if env else j_fake[t]
            nu = f32(c0 * max(f32(mu_bar - lam_hat), f32(0.0)))
            accept = f32(u_fake[t]) < f32(nu / nu_den)
            if accept and use_fake and q_fake[j].item() < ci[FAKE_CAP]:
                if q_real[j].item() + q_fake[j].item() == 0:
                    busy[j] = float(now)
                q_fake[j] += 1
                code = EV_FAKE_DISPATCH
        if use_learner and t % refresh == 0:
            mu_hat = _refresh(samples, stamps, widx, count, epoch, mu_hat, lcfg, lam_hat,
                              now, lanes)
        sc["code"].append(code)
        sc["worker"].append(worker)
        sc["n_tasks"].append(nt)
        sc["frontend"].append(frontend if ext else (0 if code == EV_ARRIVAL else -1))
        sc["now"].append(float(now))
        sc["lam_hat"].append(float(lam_hat))
        sc["view_gap"].append(view_gap)
        sc["sync_age"].append(float(sync_age))
        sc["killed_fake"].append(killed_fake)
        if trace_queues:
            tq[t] = q_real
        if trace_mu:
            tm[t] = mu_hat
        if ofold is not None:
            tobs[t] = ofold.step(now, svc, svc_ok, nt, int(code == EV_REAL_DONE), kl,
                                q_real.cpu().numpy(), lam_hat, mu_hat.cpu().numpy(),
                                mu_now.cpu().numpy(), act.cpu().numpy() if env else None)

    as_t = lambda v, dt: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
    trace = {name: as_t(v, torch.float32 if name in ("now", "lam_hat", "sync_age") else i32)
             for name, v in sc.items()}
    trace.update(task_workers=tw, task_targets=tt, q_real=tq, mu_hat=tm,
                 killed=killed if ext else torch.zeros((T, 0), dtype=i32, device=dev))
    if tobs is not None:
        trace["obs"] = torch.from_numpy(tobs).to(dev)
    final = {
        "now": as_t(float(now), torch.float32), "q_real": q_real, "q_fake": q_fake,
        "s_real": s_real, "busy_start": busy, "arr_times": arr_times,
        "arr_idx": as_t(arr_idx, i32), "arr_count": as_t(arr_count, i32),
        "lam_hat": as_t(float(lam_hat), torch.float32), "samples": samples,
        "stamps": stamps, "widx": widx, "count": count, "epoch_start": epoch,
        "mu_hat": mu_hat,
    }
    if ext:
        # the view's table of the last sync: no membership change since, so
        # the current mask is the one it was built under
        table = view.of(mu_view, act)
        final.update(
            alias_p=table.prob, alias_a=table.alias, crash_i=as_t(crash_i, i32), q_snap=q_snap, q_delta=q_delta, mu_view=mu_view,
            ema_last=as_t([float(e.last_time) for e in ema], torch.float32),
            ema_gap=as_t([float(e.mean_gap) for e in ema], torch.float32),
            ema_count=as_t([int(e.count) for e in ema], i32),
            t_sync=as_t(float(t_sync), torch.float32),
            lam_global=as_t(float(lam_global), torch.float32))
    return final, trace


def env_segment(bp: np.ndarray, now) -> int:
    """The segment of the breakpoints ``bp`` that holds ``now``:
    searchsorted(bp, now, right) - 1, clipped to the segments."""
    i = int(np.searchsorted(bp, f32(now), side="right")) - 1
    return min(max(i, 0), len(bp) - 1)


def _reset_workers(rejoin, act, now, samples, stamps, widx, count, epoch, mu_hat):
    """``core.learner.reset_workers`` with the kept μ̂ summed left to right:
    the rejoining workers' rings cleared, their window restarted at ``now``
    and their μ̂ the mean of the active workers that stayed (1 if none)."""
    keep = (act & ~rejoin).cpu().numpy()
    denom = f32(keep.sum())
    mu_keep = seq_cumsum(np.where(keep, mu_hat.cpu().numpy(), f32(0.0)))[-1]
    mu0 = f32(mu_keep / max(denom, f32(1.0))) if denom > 0 else f32(1.0)
    r = rejoin[:, None]
    return (torch.where(r, 0.0, samples), torch.where(r, 0.0, stamps),
            torch.where(rejoin, 0, widx), torch.where(rejoin, 0, count),
            torch.where(rejoin, float(now), epoch), torch.where(rejoin, float(mu0), mu_hat))


def _refresh(samples, stamps, widx, count, epoch, mu_hat, lcfg, lam_hat, now, lanes):
    """LEARNER-AGGREGATE (``core.learner.refresh_estimates``) with the ring
    sums taken lane by lane from lane 0."""
    n, cap = samples.shape
    _, eps, mu_star, L = lrn.window_params(lcfg, lam_hat, n)
    age = (widx[:, None] - 1 - lanes) % cap
    k = count.clamp(max=lrn.avg_window(L, cap))[:, None]
    valid = (age < k) & (lanes < count.clamp(max=cap)[:, None])
    masked = torch.where(valid, samples, 0.0).cpu().numpy()
    sums = torch.from_numpy(np.add.accumulate(masked, axis=1)[:, -1].copy()).to(samples.device)
    q_hat = sums / valid.sum(1).clamp(min=1)
    mu_new = torch.full_like(q_hat, float(f32(1.0) - eps)) / q_hat.clamp(min=1e-9)
    mu_new = torch.where(count > 0, mu_new, mu_hat)
    t_lth = stamps.gather(1, ((widx - L) % cap).long()[:, None])[:, 0]
    t_ref = torch.where(count >= L, t_lth, epoch)
    horizon = f32(f32(f32(1.0) + eps) * f32(L)) / max(mu_star, f32(1e-9))
    too_slow = (torch.full_like(t_ref, float(now)) - t_ref) > float(horizon)
    return torch.where(too_slow, 0.0, mu_new)


def warp_sum(x: np.ndarray) -> np.float32:
    """Σx in the kernel's fixed order: lane l of a 32-lane warp adds x[l],
    x[l + 32], ... from +0, then the lanes pair up across 16, 8, 4, 2 and 1
    (a butterfly: lane l adds lane l ^ d's value to its own), each add one
    f32 rounding. Addition is commutative, so every lane of the kernel ends
    with this one value."""
    x = np.asarray(x, np.float32)
    a = np.zeros(32, np.float32)
    for base in range(0, x.shape[0], 32):
        c = x[base:base + 32]
        a[:c.shape[0]] = a[:c.shape[0]] + c
    lanes = np.arange(32)
    for d in (16, 8, 4, 2, 1):
        a = a + a[lanes ^ d]
    return a[0]


#: a packed row's i32 group: name -> index (``obs.windows.PACK_I32``, then the flag)
_I = {f: j for j, f in enumerate(obw.PACK_I32)}
_FLAG = len(obw.PACK_I32)
#: the fields a window boundary zeroes in the i32 and f32 groups
_RESET_I = [_I[f] for f in obw.WINDOW_FIELDS if f in _I]
_TWO = np.array(obd.TWO_SIDED)


class ObsFold:
    """The in-chain telemetry of one chain (``obs.windows.observe_turn`` once
    a round, the reference's ``SimConfig.observe``), in numpy f32 with every
    operation rounded once as the kernel's: the window state as a packed
    row (``obs.windows.row_offsets`` at the batch's ``HB`` bins) and
    ``step`` one round's fold, the detector at a boundary, the row and the
    reset. The sums over workers run in ``warp_sum``'s order; Σq is exact
    (integers). In the paper's mode (no active mask) the window's queue sum
    adds the mean as one fused multiply-add, q_sum + Σq·(1/n), as the
    reference's compiled chain does; under a mask it adds Σq / max(#active,
    1). The histogram bins a sample by the count of thresholds at or below
    it (``obs.windows.hist_thresholds``). The detector is
    ``obs.detect.update_row`` with the same four fused multiply-adds."""

    def __init__(self, co: list, cof: list, thr: np.ndarray, HB: int, n: int):
        self.window, self.bins, self.detect = co[WINDOW], co[BINS], bool(co[DETECT])
        self.warmup, self.cooldown = co[WARMUP], co[COOLDOWN]
        self.cf = [f32(v) for v in cof]
        self.rel = np.array(cof[REL_FLOOR:REL_FLOOR + obd.NSIG], np.float32)
        self.thr = np.asarray(thr[:self.bins - 1], np.float32)
        self.off = obw.row_offsets(HB)
        self.n = n
        self.row = np.zeros(obw.row_words(HB), np.int32)
        o = self.off
        self.hist = self.row[:HB]
        self.ints = self.row[o["i32"]:o["i32"] + _FLAG + 1]
        self.fl = self.row[o["f32"]:o["f32"] + len(obw.PACK_F32)].view(np.float32)
        self.det = self.row[o["det"]:o["det"] + 4 * obd.NSIG].view(np.float32).reshape(
            4, obd.NSIG)
        self.ints[_I["det_regime"]] = self.ints[_I["det_fired"]] = obd.STABLE

    def step(self, now, svc, svc_ok: bool, arrived: int, completed: int, killed: int,
             q: np.ndarray, lam_hat, mu_hat: np.ndarray, mu_true: np.ndarray,
             act: np.ndarray | None) -> np.ndarray:
        """One round's fold; returns the row (post-fold, pre-reset)."""
        ints, fl, cf = self.ints, self.fl, self.cf
        if svc_ok:
            self.hist[int((f32(svc) >= self.thr).sum())] += 1
        if act is None:
            h, m = mu_hat, mu_true
            q_sum = est.fma_f32(f32(int(q.sum())), cf[INV_N], fl[0])
            q_hi, n_active = int(q.max()), self.n
        else:
            h = np.where(act, mu_hat, f32(0.0)).astype(np.float32)
            m = np.where(act, mu_true, f32(0.0)).astype(np.float32)
            nact = max(f32(int(act.sum())), f32(1.0))
            q_sum = f32(fl[0] + f32(f32(int(q[act].sum())) / nact))
            q_hi, n_active = int(np.where(act, q, 0).max()), int(act.sum())
        tiny = f32(1e-12)
        h = h / max(warp_sum(h), tiny)
        m = m / max(warp_sum(m), tiny)
        err = warp_sum(np.abs(h - m))
        for f, v in (("n_resp", int(svc_ok)), ("arrivals", arrived), ("launched", arrived),
                     ("completed", completed), ("killed", killed), ("turns", 1),
                     ("turn_idx", 1), ("cum_launched", arrived), ("cum_completed", completed),
                     ("cum_killed", killed)):
            ints[_I[f]] += v
        ints[_I["q_max"]] = max(int(ints[_I["q_max"]]), q_hi)
        ints[_I["n_active"]] = n_active
        fl[0] = q_sum
        fl[1] = f32(fl[1] + err)
        fl[2], fl[4] = f32(lam_hat), f32(now)
        flag = ints[_I["turn_idx"]] % self.window == 0
        ints[_FLAG] = int(flag)
        if flag and self.detect:
            self._detect()
        row = self.row.copy()
        if flag:  # the reset, after the row
            self.hist[:] = 0
            ints[_RESET_I] = 0
            fl[0] = fl[1] = f32(0.0)
            fl[3] = fl[4]
        return row

    def _detect(self) -> None:
        """``obs.detect.update_row`` on the window just folded."""
        ints, fl, cf, (mean, scale, pos, neg) = self.ints, self.fl, self.cf, self.det
        turns = max(f32(int(ints[_I["turns"]])), f32(1.0))
        x = np.array([fl[2], f32(fl[1] / turns), f32(fl[0] / turns),
                      f32(int(ints[_I["n_active"]])),
                      f32(int(ints[_I["killed"]] + ints[_I["dirty"]] + ints[_I["retried"]]))],
                     np.float32)
        wins, cool = int(ints[_I["det_wins"]]), int(ints[_I["det_cool"]])
        first, warm, cooling = wins == 0, wins < self.warmup, cool > 0
        mean0 = x.copy() if first else mean.copy()
        scale_eff = np.maximum(np.maximum(scale, self.rel * np.abs(mean0)), cf[ABS_FLOOR])
        z = (x - mean0) / scale_eff
        fma = lambda a, b, c: np.array([est.fma_f32(a[i] if np.ndim(a) else a, b[i], c[i])  # noqa: E731
                                        for i in range(obd.NSIG)], np.float32)
        k, rho, h = cf[K_SIGMA], cf[DECAY], cf[H_SIGMA]
        pos1 = np.maximum(fma(rho, pos, z) - k, f32(0.0))
        neg1 = np.maximum(fma(rho, neg, -z) - k, f32(0.0))
        armed = not warm and not cooling
        sig = ((pos1 > h) | (_TWO & (neg1 > h))) & armed
        fired = bool(sig.any())
        kind = (obd.MEMBERSHIP_SHIFT if sig[3] else obd.FAILURE_STORM if sig[4]
                else obd.CAPACITY_SHIFT if sig[1] else obd.LOAD_SHIFT if sig[0] or sig[2]
                else obd.STABLE)
        rb = warm or cooling or fired
        alpha = cf[REBASE_ALPHA] if rb else cf[EMA_ALPHA]
        clip = cf[CLIP_Z] * scale_eff
        innov = x - mean0
        if not rb:
            innov = np.minimum(np.maximum(innov, -clip), clip)
        dev = np.abs(x - mean0)
        if not rb:
            dev = np.minimum(dev, cf[SCALE_CLIP_Z] * scale_eff)
        scale0 = np.maximum(dev, cf[ABS_FLOOR]) if first else scale.copy()
        mean[:] = fma(alpha, innov, mean0)
        scale[:] = fma(alpha, dev - scale0, scale0)
        keep = armed and not fired
        pos[:] = pos1 if keep else f32(0.0)
        neg[:] = neg1 if keep else f32(0.0)
        cool1 = self.cooldown if fired else max(cool - 1, 0)
        ints[_I["det_wins"]] = wins + 1
        ints[_I["det_cool"]] = cool1
        ints[_I["det_regime"]] = kind if fired else (
            int(ints[_I["det_regime"]]) if cool1 > 0 else obd.STABLE)
        ints[_I["det_fired"]] = kind if fired else obd.STABLE
        if fired:
            ints[_I["det_last_turn"]] = ints[_I["turn_idx"]]
        ints[_I["det_count"]] += int(fired)


def sim_chain_ref(conf_i, conf_f, mu_sched, mu_hat0, cols: dict, ext: dict | None = None,
                  obs: dict | None = None, *, n: int, mt: int, ring_cap: int,
                  arrival_window: int, trace_queues: bool, trace_mu: bool):
    """Every chain of the batch, one after another: (final, trace), each a
    dict of tensors with the chain axis leading; a chain's trace rows past
    its own rounds are zeros. ``ext``: the batch's environment and fleet
    inputs (``EXT``), None in the paper's own mode; ``obs``: its telemetry
    inputs (``OBS``), None without telemetry."""
    C, T = cols["dt"].shape
    dev = cols["dt"].device
    kw = dict(n=n, mt=mt, ring_cap=ring_cap, arrival_window=arrival_window,
              trace_queues=trace_queues, trace_mu=trace_mu)
    F = killed = None
    if ext is not None:
        F = int(ext["conf_x"][:, FRONTENDS].max())
        killed = bool((ext["conf_x"][:, ENV] * ext["conf_x"][:, KCRASH]).any())
    HB = None if obs is None else obs["obs_thr"].shape[1]
    final = {name: torch.zeros((C,) + shape, dtype=dt, device=dev)
             for name, (dt, shape) in final_shapes(n, ring_cap, arrival_window, F).items()}
    trace = {name: torch.zeros((C,) + shape, dtype=dt, device=dev)
             for name, (dt, shape) in trace_shapes(T, n, mt, trace_queues, trace_mu,
                                                   bool(killed), HB).items()}
    ci_all, cf_all = conf_i.tolist(), conf_f.tolist()
    for c in range(C):
        x = None
        if ext is not None:
            x = {name: v[c] for name, v in ext.items()}
            x["conf_x"], x["conf_xf"] = x["conf_x"].tolist(), x["conf_xf"].tolist()
        o = None
        if obs is not None:
            o = dict(conf_o=obs["conf_o"][c].tolist(), conf_of=obs["conf_of"][c].tolist(),
                     obs_thr=obs["obs_thr"][c], HB=HB)
        f, tr = run_chain(ci_all[c], cf_all[c], mu_sched[c], mu_hat0[c],
                          {name: v[c] for name, v in cols.items()}, x=x, o=o, **kw)
        for name, v in f.items():
            final[name][c][tuple(slice(0, d) for d in v.shape)] = v
        for name, v in tr.items():
            trace[name][c][tuple(slice(0, d) for d in v.shape)] = v
    return final, trace
