"""The plain chain: ``sim_chain``'s plain version, one round at a time.

A Python loop over rounds on torch tensors, in the reference's order
within a round (``src/repro/core/simulator.py:553-735``):

  1. ``now += dt``;
  2. the sync at true state: the view is the true queue, its μ is μ̂ (or,
     with known speeds, the current phase's μ), and its alias table or CDF
     is built from that μ (rebuilt only when it changes: the same μ gives
     the same table);
  3. the branch the round's event picks: an arrival (the estimator, then
     the job through the dispatch engine ``core.dispatch.place``, then the
     completion targets on the true queues), a service event (the real
     queue drains before the fake one; a completion feeds the learner
     ring) or a benchmark dispatch;
  4. the learner refresh every ``learner_refresh`` rounds, after the
     branch;
  5. the trace row, after the refresh.

Every float reduction runs left to right in f32: Σμ and the cumulative
sum of the alias scaling and the CDF (numpy's ``accumulate``, a plain
loop), and the ring sum of the refresh (lane 0 up, invalid lanes adding
+0). The kernel makes the same sums in the same order and its other float
operations one IEEE operation each, so the two agree bit for bit on the
same draws. The draws are ``core.simulator.draw_rounds``'s columns.

The chains of a batch run one after another; each reads its row of the
config arrays (fields below) and of every draw column.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dispatch as dsp
from repro_torch.core import learner as lrn
from repro_torch.core import policies as pol
from repro_torch.kernels.ppot_dispatch import ref as pref

f32 = np.float32

# conf_i fields (i32)
POLICY, ROUNDS, USE_LEARNER, USE_FAKE, FAKE_CAP, REFRESH, FOLD, USE_TABLE, THEORY, PHASES = \
    range(10)
NI = 10
# conf_f fields (f32): μ̄, the phase period (inf: static), νmax, c0, the
# window constant c and the theory window's numerator c·log(n)
MU_BAR, PERIOD, NU_MAX, C0, C_WINDOW, THEORY_NUM = range(6)
NF = 6

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


def trace_shapes(T: int, n: int, mt: int, trace_queues: bool, trace_mu: bool) -> dict:
    """name -> (dtype, shape of one chain's column)."""
    width = {None: (), "mt": (mt,), "n": (n,), 0: (0,)}
    out = {}
    for name, (dt, w) in TRACE.items():
        shape = (T,) + width[w]
        if (name == "q_real" and not trace_queues) or (name == "mu_hat" and not trace_mu):
            shape = (T, 0)
        out[name] = (dt, shape)
    return out


def final_shapes(n: int, ring_cap: int, arrival_window: int) -> dict:
    """name -> (dtype, shape) of one chain's final state."""
    i32, fl = torch.int32, torch.float32
    return {
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


class _Views:
    """The view's alias table and CDF of one μ, rebuilt when μ changes."""

    def __init__(self, dev):
        self.dev = dev
        self.mu = None

    def of(self, mu: torch.Tensor):
        if self.mu is None or not torch.equal(self.mu, mu):
            self.mu = mu.clone()
            m = mu.cpu().numpy()
            p = torch.from_numpy(scaled_weights(m)).to(self.dev)
            self.prob, self.alias = pref.alias_table_ref(p)
            self.cdf = torch.from_numpy(make_cdf(m)).to(self.dev)
        return self


def _probe_draws(policy: str, u: torch.Tensor, j: torch.Tensor, mt: int, view: _Views,
                 halo: _Views, use_table: bool) -> dict:
    """The engine's draws for one job from the round's raw draws u [4, mt]
    and j [J] and the current tables."""
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
        return {"j1": probe(0, 2), "j2": probe(1, 3), "explore": j[mt:2 * mt] != 0,
                "j_uni": j[:mt]}
    return {"probes": j[:max(2 * mt, mt)]}  # Sparrow, d = 2


def run_chain(ci: list, cf: list, mu_sched: torch.Tensor, mu_hat0: torch.Tensor,
              cols: dict, *, n: int, mt: int, ring_cap: int, arrival_window: int,
              trace_queues: bool, trace_mu: bool):
    """One chain: (final dict, trace dict) for its own rounds."""
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
    mu_max = sched.max(0).values
    mu_max_h = mu_max.cpu().numpy()
    nu_den = max(nu_max, f32(1e-30))
    S, cap = arrival_window, ring_cap

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

    sc = {k: [] for k in ("code", "worker", "n_tasks", "frontend", "now", "lam_hat")}
    tw = torch.full((T, mt), -1, dtype=i32, device=dev)
    tt = torch.full((T, mt), -1, dtype=i32, device=dev)
    tq = torch.zeros((T, n if trace_queues else 0), dtype=i32, device=dev)
    tm = torch.zeros((T, n if trace_mu else 0), dtype=torch.float32, device=dev)
    lanes = torch.arange(cap, device=dev)

    for t in range(T):
        now = f32(now + f32(dts[t]))
        phase = 0 if K == 1 or not np.isfinite(period) else int(now / period) % K
        mu_now = sched[phase]
        ev = evs[t]
        nt, worker, code = 0, -1, EV_SELF_LOOP
        if ev == 0:  # an arrival
            nt, code = n_tasks_c[t], EV_ARRIVAL
            arr_times[arr_idx] = float(now)
            arr_idx, arr_count = (arr_idx + 1) % S, arr_count + 1
            k = min(arr_count, S)
            oldest = f32(arr_times[arr_idx % S if arr_count >= S else 0].item())
            span = f32(now - oldest)
            if k >= 2 and span > 0:
                lam_hat = f32(f32(k - 1) / span)
            mu_view = mu_hat if use_learner else mu_now
            d = _probe_draws(policy, uu[t], jj[t], mt, view.of(mu_view),
                             halo.of(mu_now) if policy == pol.HALO else halo, use_table)
            active = slots < nt
            res = dsp.place(policy, d, q_real, mu_view, mt, active=active, forced=pins[t],
                            fold_chunks=fold)
            rank = dsp.within_batch_rank(res.workers, active)
            wsafe = torch.where(active, res.workers, 0).long()
            tw[t] = res.workers
            tt[t] = torch.where(active, s_real[wsafe] + q_real[wsafe] + rank + 1, -1)
            was_idle = (q_real + q_fake) == 0
            busy = torch.where((res.q_after > q_real) & was_idle, float(now), busy)
            q_real = res.q_after
        elif ev <= n:  # a potential service event at worker ev - 1
            w = ev - 1
            worker = w
            accept = f32(u_svc[t]) < f32(f32(mu_now[w].item()) / max(f32(mu_max_h[w]),
                                                                     f32(1e-30)))
            has_real, has_fake = q_real[w].item() > 0, q_fake[w].item() > 0
            do_real = accept and has_real
            do_fake = accept and not has_real and has_fake
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
            worker = j = j_fake[t]
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
        sc["frontend"].append(0 if code == EV_ARRIVAL else -1)
        sc["now"].append(float(now))
        sc["lam_hat"].append(float(lam_hat))
        if trace_queues:
            tq[t] = q_real
        if trace_mu:
            tm[t] = mu_hat

    as_t = lambda v, dt: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
    trace = {name: as_t(v, torch.float32 if name in ("now", "lam_hat") else i32)
             for name, v in sc.items()}
    trace.update(task_workers=tw, task_targets=tt, q_real=tq, mu_hat=tm,
                 view_gap=torch.zeros(T, dtype=i32, device=dev),
                 sync_age=torch.zeros(T, dtype=torch.float32, device=dev),
                 killed=torch.zeros((T, 0), dtype=i32, device=dev),
                 killed_fake=torch.zeros(T, dtype=i32, device=dev))
    final = {
        "now": as_t(float(now), torch.float32), "q_real": q_real, "q_fake": q_fake,
        "s_real": s_real, "busy_start": busy, "arr_times": arr_times,
        "arr_idx": as_t(arr_idx, i32), "arr_count": as_t(arr_count, i32),
        "lam_hat": as_t(float(lam_hat), torch.float32), "samples": samples,
        "stamps": stamps, "widx": widx, "count": count, "epoch_start": epoch,
        "mu_hat": mu_hat,
    }
    return final, trace


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


def sim_chain_ref(conf_i, conf_f, mu_sched, mu_hat0, cols: dict, *, n: int, mt: int,
                  ring_cap: int, arrival_window: int, trace_queues: bool, trace_mu: bool):
    """Every chain of the batch, one after another: (final, trace), each a
    dict of tensors with the chain axis leading; a chain's trace rows past
    its own rounds are zeros."""
    C, T = cols["dt"].shape
    dev = cols["dt"].device
    kw = dict(n=n, mt=mt, ring_cap=ring_cap, arrival_window=arrival_window,
              trace_queues=trace_queues, trace_mu=trace_mu)
    final = {name: torch.zeros((C,) + shape, dtype=dt, device=dev)
             for name, (dt, shape) in final_shapes(n, ring_cap, arrival_window).items()}
    trace = {name: torch.zeros((C,) + shape, dtype=dt, device=dev)
             for name, (dt, shape) in trace_shapes(T, n, mt, trace_queues, trace_mu).items()}
    ci_all, cf_all = conf_i.tolist(), conf_f.tolist()
    for c in range(C):
        f, tr = run_chain(ci_all[c], cf_all[c], mu_sched[c], mu_hat0[c],
                          {name: v[c] for name, v in cols.items()}, **kw)
        for name, v in f.items():
            final[name][c] = v
        for name, v in tr.items():
            trace[name][c, :v.shape[0]] = v
    return final, trace
