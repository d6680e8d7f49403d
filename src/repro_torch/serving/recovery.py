"""Failure semantics on the serving path: timeout → retry re-dispatch,
speculative re-execution, and the task-conservation ledger.

The serving layers execute *copies* of logical tasks. A task is launched
once on arrival; recovery may launch further copies (retry after a crash
kill or a deadline timeout, speculative duplicates of suspected
stragglers). The first copy to finish defines the task's response time;
every copy is accounted for in the ledger so conservation is checkable as
an invariant:

    copies_real_launched == copies_real_completed + copies_real_killed
    fake_launched        == fake_completed       + fake_killed
    n_tasks              == completed_tasks      + lost_tasks

Copy lifecycle (both the host loop here and the faulty turn of the
one-program loop in ``serving/scanloop.py`` walk it in the same per-turn
order)::

            launch (arrival / retry / spec)
               │
               ▼
         ┌─ in-flight ──────────────┐
         │    │ blackout touches it │──▶ clock += stall, completion DIRTY
         │    │ deadline passes     │──▶ timed-out (dirty) ──▶ retry?
         │    │ worker crashes      │──▶ killed ──▶ ghost ──▶ retry?
         ▼    ▼
       completes CLEAN ──▶ learner fold + response
       completes DIRTY ──▶ queue drain + response only (μ̂ NEVER sees a
                           stall-inflated or timed-out service time)

Retry re-dispatch goes through the *current* policy under the *current*
membership mask (the widened dispatch, ``RosellaRouter.serve_turn_recovery``
through ``scheduler.serve_step(m_route=, slots=)``); speculative copies are placed by the
straggler planner's greedy makespan fill (``dist/straggler.py``) on the
post-serve μ̂. Neither invents arrivals: the λ̂ estimator observes only
first launches.

Copied from the JAX package's ``serving/recovery.py``: the configuration,
the counters and the numpy epilogue verbatim, the host loop with the
router's state on its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import estimator as est
from repro_torch.dist import straggler as strg
from repro_torch.obs import windows as obw


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Knobs of the failure-recovery layer (hashable: part of the one-program
    loop's ``ScanConfig``, one captured graph per config).

    ``timeout_mult``: a copy placed on worker w with cost c gets deadline
    ``t + timeout_mult · backoff^attempt · c / max(μ̂_w, mu_floor)``;
    ``inf`` disables timeouts. ``retry_budget`` caps re-launch attempts
    per task; ``retry_cap`` is the per-turn re-dispatch quota (0 disables
    retries entirely — the dispatch program is then bit-identical to the
    recovery-free router). ``spec_cap`` > 0 enables speculative
    re-execution: each turn, up to spec_cap in-flight copies whose age
    exceeds ``spec_ratio`` × their expected service get a duplicate on
    the planner-chosen workers."""

    timeout_mult: float = 8.0
    retry_budget: int = 2
    backoff: float = 2.0
    retry_cap: int = 4
    spec_cap: int = 0
    spec_ratio: float = 3.0
    mu_floor: float = 1e-3


#: Recovery disabled: faults still kill/stall copies, but nothing is
#: retried, nothing times out, nothing is speculated — the "no recovery"
#: baseline of the fault benchmarks.
INERT_RECOVERY = RecoveryConfig(
    timeout_mult=np.inf, retry_budget=0, retry_cap=0, spec_cap=0
)


#: Counter layout shared by the host loop and the scan carry (i64[NCTR]).
CTR = {
    "kill_real": 0,     # real copies killed by crashes
    "kill_fake": 1,     # fake/burst probes killed by crashes
    "timeout": 2,       # copies whose deadline fired
    "retry": 3,         # retry copies launched
    "spec": 4,          # speculative copies launched
    "comp_real": 5,     # real copies completed (clean + dirty)
    "comp_fake": 6,     # fake/burst probes completed
    "comp_dirty": 7,    # real completions excluded from the learner
    "stalled": 8,       # real copies whose clock a blackout stretched
    "launch_fake": 9,   # fake/burst probes launched
}
NCTR = len(CTR)


def backoff_lut(rc: RecoveryConfig) -> np.ndarray:
    """``backoff^attempt`` lookup, sized past the attempt range — computed
    in numpy for BOTH loops (the scan's turn copies it to the device) so
    the deadline arithmetic never mixes two pows."""
    return np.power(
        float(rc.backoff), np.arange(rc.retry_budget + 2, dtype=np.float64)
    )


def drain_pending(resp, ctr, done, task, arrv):
    """Finalize: fold still-in-flight copies with finite completion times
    into the response min-fold and the completion counters (the horizon
    ended before their flush turn — they did complete). Ghosts (killed
    copies parked at done=+inf awaiting a retry slot) were already
    counted killed and fold nowhere. Shared by the host loop and the scan
    epilogue (on the final carry) so both finalize identically."""
    done = np.asarray(done, float)
    task = np.asarray(task, np.int64)
    fin = np.isfinite(done)
    real = task >= 0
    dr = fin & real
    if dr.any():
        np.minimum.at(resp, task[dr], done[dr] - np.asarray(arrv, float)[dr])
    ctr[CTR["comp_real"]] += int(dr.sum())
    ctr[CTR["comp_fake"]] += int((fin & ~real).sum())


def build_ledger(resp, ctr, n_tasks: int, max_clean: float):
    """Close the books: returns ``(responses, ledger)`` where lost tasks
    (no copy ever completed) are NaN in ``responses`` and the ledger
    carries the conservation identities ready for
    ``metrics.check_conservation``."""
    resp = np.asarray(resp, float)
    completed = int(np.isfinite(resp).sum())
    lost = int(n_tasks) - completed
    c = {name: int(ctr[i]) for name, i in CTR.items()}
    launched = int(n_tasks) + c["retry"] + c["spec"]
    ledger = {
        "n_tasks": int(n_tasks),
        "completed_tasks": completed,
        "lost_tasks": lost,
        "copies_real_launched": launched,
        "copies_real_completed": c["comp_real"],
        "copies_real_killed": c["kill_real"],
        "fake_launched": c["launch_fake"],
        "fake_completed": c["comp_fake"],
        "fake_killed": c["kill_fake"],
        "n_timeouts": c["timeout"],
        "n_retries": c["retry"],
        "n_spec": c["spec"],
        "n_dirty_completions": c["comp_dirty"],
        "n_stalled": c["stalled"],
        "max_clean_service": float(max_clean),
    }
    ledger["conserved"] = (
        launched == c["comp_real"] + c["kill_real"]
        and c["launch_fake"] == c["comp_fake"] + c["kill_fake"]
        and int(n_tasks) == completed + lost
    )
    return np.where(np.isfinite(resp), resp, np.nan), ledger


def _keep(cols: dict, mask: np.ndarray) -> dict:
    return {k: v[mask] for k, v in cols.items()}


def _append(cols: dict, **new) -> dict:
    return {k: np.concatenate([cols[k], np.asarray(new[k], cols[k].dtype)])
            for k in cols}


def run_workload_recovery(
    router,
    pool,
    wl,
    *,
    fake_cost: float,
    burst_cost: float | None = None,
    recovery: RecoveryConfig | None = None,
    observe=None,
    decisions=None,
    obs_sink=None,
):
    """The host serving loop with failure semantics — ``run_workload``
    extended by the copy lifecycle in the module docstring. Per turn, in
    this exact order (the one-program loop's faulty turn replays it step
    for step):

      1. advance speeds;  2. blackout stalls stretch in-flight clocks
      (completions go dirty);  3. crash kills drop in-flight copies
      (retryable ones park as ghosts);  4. deadlines fire timeouts;
      5. flush due completions — CLEAN ones feed the learner, dirty ones
      only drain the queue view, every real one min-folds its task's
      response;  6. queue-view drain for killed/dirty copies;
      7. membership hook (outage windows ride the merged mask);
      8. stale-ghost sweep;  9. retry selection (earliest deadline
      first); 10. ONE widened serve/dispatch call routes arrivals + retry
      slots; 11. speculative copies on the post-serve μ̂; 12. deadlines
      for the new copies; 13. pool submission chain fakes → burst →
      reals → retries → specs; 14. pending append.

    ``observe`` (an ``obs.ObserveConfig``) folds the windowed telemetry
    each turn (``obs.windows.observe_turn`` on the router's device, over
    the clean flush's copy latencies and the turn's counter deltas) into
    ``info["windows"]``, each record also handed to ``obs_sink``;
    ``decisions`` (an ``obs.DecisionTrace``) records kills, timeouts,
    completions, retries, arrivals and placements.

    Returns ``(responses[n_tasks] (NaN = lost), mu_trace, info)`` with
    ``info["ledger"]`` the conservation ledger, and the most copies in
    flight after a turn's append and the largest clean flush
    (``most_in_flight``, ``largest_flush``: what the one-program loop's
    ``pend_cap`` and ``comp_cap`` must hold)."""
    rc = recovery if recovery is not None else INERT_RECOVERY
    if burst_cost is None:
        burst_cost = 4.0 * fake_cost
    T = wl.turns
    k = wl.times.shape[1] if T else 0
    n = router.n
    n_tasks = T * k
    retry_on = rc.retry_cap > 0
    lut = backoff_lut(rc)
    mult = float(rc.timeout_mult)

    resp = np.full(max(n_tasks, 1), np.inf)
    ctr = np.zeros(NCTR, np.int64)
    max_clean = 0.0
    mu_trace: list[np.ndarray] = []
    seq_ctr = 0
    most_in_flight = largest_flush = 0  # what the scan's capacities must hold

    cols = {
        "done": np.empty(0), "start": np.empty(0),
        "rep": np.empty(0, np.int32), "seq": np.empty(0, np.int64),
        "task": np.empty(0, np.int64), "arrv": np.empty(0),
        "cost": np.empty(0), "dead": np.empty(0),
        "att": np.empty(0, np.int32), "dup": np.empty(0, bool),
        "learn": np.empty(0, bool), "to": np.empty(0, bool),
        "retry": np.empty(0, bool),
    }

    def deadline(t, att, cost, w, mu64):
        # identical op order to the scan body: f64 throughout
        return t + (mult * lut[att]) * cost / np.maximum(mu64[w], rc.mu_floor)

    tc = obw.init_carry(observe, router.device) if observe is not None else None
    windows: list = []

    for turn in range(T):
        times = wl.times[turn]
        t = float(times[-1])
        pool.set_speeds(wl.speeds[turn])
        drain = np.zeros(n, np.int64)
        real = cols["task"] >= 0
        ctr_in = ctr.copy()  # the window ledger deltas: end-of-turn ctr - ctr_in

        # (2) blackout stall: in-flight copies past the stall instant take
        # the outage on their clock; their completions go dirty. The
        # replica's FIFO chain shifts with them.
        if wl.stall_at is not None:
            st, sd = wl.stall_at[turn], wl.stall_dur[turn]
            if np.isfinite(st).any():
                aff = np.isfinite(cols["done"]) & (cols["done"] > st[cols["rep"]])
                if aff.any():
                    cols["done"] = np.where(
                        aff, cols["done"] + sd[cols["rep"]], cols["done"])
                    cols["learn"] &= ~aff
                    ctr[CTR["stalled"]] += int((aff & real).sum())
                pool.free_at = np.where(
                    pool.free_at > st, pool.free_at + sd, pool.free_at)

        # (3) crash kill: copies that would finish after the crash are
        # dropped from the replica; retryable real copies park as ghosts
        # (done=+inf) until a retry slot re-dispatches them.
        if wl.kill_at is not None:
            kt = wl.kill_at[turn]
            if np.isfinite(kt).any():
                killed = np.isfinite(cols["done"]) & (cols["done"] > kt[cols["rep"]])
                if killed.any():
                    drain += np.bincount(
                        cols["rep"][killed], minlength=n).astype(np.int64)
                    ghost = (killed & real & ~cols["dup"]
                             & (cols["att"] < rc.retry_budget) & retry_on)
                    ctr[CTR["kill_real"]] += int((killed & real).sum())
                    ctr[CTR["kill_fake"]] += int((killed & ~real).sum())
                    if decisions is not None:
                        for i in np.nonzero(killed & real)[0]:
                            decisions.kill(t, int(cols["task"][i]), int(cols["rep"][i]),
                                           attempt=int(cols["att"][i]))
                    cols["learn"] &= ~killed
                    cols["done"] = np.where(ghost, np.inf, cols["done"])
                    cols["retry"] |= ghost
                    cols = _keep(cols, ~(killed & ~ghost))
                    real = cols["task"] >= 0
                pool.free_at = np.where(pool.free_at > kt, kt, pool.free_at)

        # (4) timeout: a copy past its deadline goes dirty (its eventual
        # completion must not feed μ̂) and, if retryable, queues a retry.
        if np.isfinite(mult):
            newly = (real & np.isfinite(cols["done"]) & (t > cols["dead"])
                     & ~cols["to"])
            if newly.any():
                cols["to"] |= newly
                cols["learn"] &= ~newly
                if retry_on:
                    cols["retry"] |= (newly & ~cols["dup"]
                                      & (cols["att"] < rc.retry_budget))
                ctr[CTR["timeout"]] += int(newly.sum())
                if decisions is not None:
                    for i in np.nonzero(newly)[0]:
                        decisions.timeout(t, int(cols["task"][i]), int(cols["rep"][i]),
                                          attempt=int(cols["att"][i]))

        # (5) flush due completions: clean → learner fold, dirty → drain
        # only; every real completion min-folds its task's response.
        due = cols["done"] <= t
        comp_w = comp_t = None
        comp_now = t
        clean = due & cols["learn"]
        largest_flush = max(largest_flush, int(clean.sum()))
        if clean.any():
            idx = np.nonzero(clean)[0]
            order = np.lexsort((cols["seq"][idx], cols["done"][idx]))
            comp_w = cols["rep"][idx][order]
            comp_t = (cols["done"] - cols["start"])[idx][order]
            comp_now = float(cols["done"][idx].max())
            max_clean = max(max_clean, float(comp_t.max()))
        dirty = due & ~cols["learn"]
        if dirty.any():
            drain += np.bincount(cols["rep"][dirty], minlength=n).astype(np.int64)
            ctr[CTR["comp_dirty"]] += int((dirty & real).sum())
        dr = due & real
        if dr.any():
            np.minimum.at(resp, cols["task"][dr],
                          cols["done"][dr] - cols["arrv"][dr])
        if observe is not None:
            lat_obs = (cols["done"] - cols["arrv"])[dr]
        if decisions is not None:
            for i in np.nonzero(dr)[0]:
                decisions.complete(float(cols["done"][i]), int(cols["task"][i]),
                                   int(cols["rep"][i]), attempt=int(cols["att"][i]))
        ctr[CTR["comp_real"]] += int(dr.sum())
        ctr[CTR["comp_fake"]] += int((due & ~real).sum())
        cols = _keep(cols, ~due)
        real = cols["task"] >= 0

        # (6) queue-view drain for copies that left a replica without a
        # clean completion (killed or dirty) — BEFORE the serve step.
        if drain.any():
            router.drain_queue(drain)

        # (7) membership hook (fault outage windows are merged into the
        # mask at compile time — a crashed/blacked-out worker is offline
        # here, and its rejoin gets the probe burst + learner cold-start).
        burst_js = np.empty(0, np.int64)
        if wl.active is not None:
            changed = turn == 0 or not np.array_equal(
                wl.active[turn], wl.active[turn - 1])
            if changed:
                router.set_membership(wl.active[turn], t,
                                      rejoin=wl.rejoin[turn])
            if wl.burst is not None and wl.burst.shape[1]:
                bt = wl.burst[turn]
                burst_js = bt[bt >= 0].astype(np.int64)

        # (8) stale-ghost sweep: a parked ghost whose task already
        # completed via another copy never re-dispatches.
        if retry_on and len(cols["done"]):
            ghosts = cols["retry"] & ~np.isfinite(cols["done"])
            if ghosts.any():
                stale = np.zeros(len(ghosts), bool)
                gi = np.nonzero(ghosts)[0]
                stale[gi] = np.isfinite(resp[cols["task"][gi]])
                if stale.any():
                    cols = _keep(cols, ~stale)
                    real = cols["task"] >= 0

        # (9) retry selection: earliest deadline first, up to retry_cap.
        r_act = np.zeros(rc.retry_cap, bool)
        r_task = np.zeros(rc.retry_cap, np.int64)
        r_arrv = np.full(rc.retry_cap, t)
        r_cost = np.full(rc.retry_cap, 1.0)
        r_att = np.zeros(rc.retry_cap, np.int32)
        if retry_on and len(cols["done"]):
            live = np.zeros(len(cols["done"]), bool)
            ri = np.nonzero(cols["retry"])[0]
            if len(ri):
                live[ri] = ~np.isfinite(resp[cols["task"][ri]])
            cand = cols["retry"] & live
            nsel = min(rc.retry_cap, int(cand.sum()))
            if nsel:
                # candidacy is the PRIMARY key: with timeouts disabled every
                # deadline is +inf and would tie with non-candidates
                keyd = np.where(cand, cols["dead"], np.inf)
                chosen = np.lexsort((cols["seq"], keyd, ~cand))[:nsel]
                r_act[:nsel] = True
                r_task[:nsel] = cols["task"][chosen]
                r_arrv[:nsel] = cols["arrv"][chosen]
                r_cost[:nsel] = cols["cost"][chosen]
                r_att[:nsel] = cols["att"][chosen] + 1
                ctr[CTR["retry"]] += nsel
                ghost_sel = ~np.isfinite(cols["done"][chosen])
                # alive timed-out originals keep running but never spawn
                # another copy; ghosts are consumed by their retry
                cols["retry"][chosen] = False
                cols["dup"][chosen[~ghost_sel]] = True
                keep = np.ones(len(cols["done"]), bool)
                keep[chosen[ghost_sel]] = False
                cols = _keep(cols, keep)
                real = cols["task"] >= 0

        # (10) ONE widened serve/dispatch call: flush + benchmark draw +
        # arrivals + retry slots, all against the CURRENT policy/mask/μ̂.
        if retry_on:
            fake_js, workers = router.serve_turn_recovery(
                t, k, comp_w, comp_t, comp_now, rc.retry_cap, r_act)
            js, rw = workers[:k], workers[k:]
        else:
            fake_js, js = router.serve_turn(t, k, comp_w, comp_t, comp_now)
            rw = np.empty(0, np.int64)
        if decisions is not None and retry_on:
            for i in np.nonzero(r_act & (np.asarray(rw) >= 0))[0]:
                decisions.retry(t, int(r_task[i]), int(rw[i]), attempt=int(r_att[i]))

        # (11) speculative re-execution on the post-serve μ̂: duplicate the
        # slowest suspected stragglers via the planner's greedy fill.
        s_act = np.zeros(rc.spec_cap, bool)
        s_task = np.zeros(rc.spec_cap, np.int64)
        s_arrv = np.full(rc.spec_cap, t)
        s_cost = np.full(rc.spec_cap, 1.0)
        s_att = np.zeros(rc.spec_cap, np.int32)
        spec_w = np.zeros(rc.spec_cap, np.int32)
        if rc.spec_cap > 0:
            mu64 = router.mu_hat.astype(np.float64)
            if len(cols["done"]):
                age = t - cols["arrv"]
                expect = cols["cost"] / np.maximum(
                    mu64[cols["rep"]], rc.mu_floor)
                ratio = age / expect
                live = np.zeros(len(cols["done"]), bool)
                ti_ = np.nonzero(real)[0]
                if len(ti_):
                    live[ti_] = ~np.isfinite(resp[cols["task"][ti_]])
                cand = (np.isfinite(cols["done"]) & real & ~cols["dup"]
                        & ~cols["retry"] & live & (ratio > rc.spec_ratio))
                nsel = min(rc.spec_cap, int(cand.sum()))
            else:
                nsel = 0
            if nsel:
                keyS = np.where(cand, -ratio, np.inf)
                chosen = np.lexsort((cols["seq"], keyS, ~cand))[:nsel]
                cols["dup"][chosen] = True
                s_act[:nsel] = True
                s_task[:nsel] = cols["task"][chosen]
                s_arrv[:nsel] = cols["arrv"][chosen]
                s_cost[:nsel] = cols["cost"][chosen]
                s_att[:nsel] = cols["att"][chosen]
                ctr[CTR["spec"]] += nsel
                mu_plan = router.learner.mu_hat
                if router.active is not None:
                    mu_plan = torch.where(router.active, mu_plan, 0.0)
                spec_w = strg.speculative_workers(mu_plan, rc.spec_cap).cpu().numpy()
                router.add_queue(np.bincount(
                    spec_w[s_act], minlength=n).astype(np.int64))

        # (12) deadlines for the new copies, from the post-serve μ̂
        mu64 = router.mu_hat.astype(np.float64)
        costs_r = np.asarray(wl.costs[turn], float)
        dead_new = deadline(t, np.zeros(k, np.int32), costs_r,
                            np.maximum(js, 0), mu64)
        dead_rt = deadline(t, np.minimum(r_att, len(lut) - 1), r_cost,
                           np.maximum(rw, 0), mu64) if retry_on else None
        dead_sp = (deadline(t, np.minimum(s_att, len(lut) - 1), s_cost,
                            spec_w, mu64) if rc.spec_cap > 0 else None)

        # (13) + (14): pool submission chain and pending append, in the
        # scan body's fixed order fakes → burst → reals → retries → specs
        for sub_js, sub_cost in ((fake_js, fake_cost), (burst_js, burst_cost)):
            if len(sub_js):
                fs, fd = pool.submit_batch(
                    sub_js, np.full(len(sub_js), t),
                    np.full(len(sub_js), sub_cost))
                m_ = len(sub_js)
                cols = _append(
                    cols, done=fd, start=fs, rep=sub_js,
                    seq=seq_ctr + np.arange(m_), task=np.full(m_, -1),
                    arrv=np.full(m_, t), cost=np.full(m_, sub_cost),
                    dead=np.full(m_, np.inf), att=np.zeros(m_),
                    dup=np.zeros(m_, bool), learn=np.ones(m_, bool),
                    to=np.zeros(m_, bool), retry=np.zeros(m_, bool))
                seq_ctr += m_
                ctr[CTR["launch_fake"]] += m_
        ss, dd = pool.submit_batch(js, times, costs_r)
        if decisions is not None:
            for i in range(k):
                task = turn * k + i
                decisions.arrive(times[i], task)
                decisions.place(times[i], task, int(js[i]))
        cols = _append(
            cols, done=dd, start=ss, rep=js,
            seq=seq_ctr + np.arange(k),
            task=turn * k + np.arange(k), arrv=times, cost=costs_r,
            dead=dead_new, att=np.zeros(k), dup=np.zeros(k, bool),
            learn=np.ones(k, bool), to=np.zeros(k, bool),
            retry=np.zeros(k, bool))
        seq_ctr += k
        for act_, w_, task_, arrv_, cost_, att_, dead_, dup_ in (
            (r_act, rw, r_task, r_arrv, r_cost, r_att, dead_rt, False),
            (s_act, spec_w, s_task, s_arrv, s_cost, s_att, dead_sp, True),
        ):
            use = act_ & (np.asarray(w_) >= 0) if len(act_) else act_
            if not use.any():
                continue
            cs, cd = pool.submit_batch(
                np.asarray(w_)[use], np.full(int(use.sum()), t), cost_[use])
            m_ = int(use.sum())
            cols = _append(
                cols, done=cd, start=cs, rep=np.asarray(w_)[use],
                seq=seq_ctr + np.arange(m_), task=task_[use],
                arrv=arrv_[use], cost=cost_[use], dead=dead_[use],
                att=att_[use], dup=np.full(m_, dup_),
                learn=np.ones(m_, bool), to=np.zeros(m_, bool),
                retry=np.zeros(m_, bool))
            seq_ctr += m_
        most_in_flight = max(most_in_flight, len(cols["done"]))
        mu_trace.append(router.mu_front.cpu().numpy())

        if observe is not None:
            # no padding: the reference pads the latencies to a power of two
            # to bound its jit retraces; torch runs any length eagerly
            tob = obw.faulty_turn_obs(
                observe, t=np.float32(times[-1]), resp=lat_obs,
                resp_ok=np.ones(len(lat_obs), bool), arrivals_k=k, q_view=router.q_view,
                lam_hat=est.lam_hat_ema(est.to_device(router.arr, router.device)),
                mu_hat=router.learner.mu_hat, mu_true=wl.speeds[turn],
                active=None if wl.active is None else wl.active[turn], dctr=ctr - ctr_in)
            tc, row, flag = obw.observe_turn(observe, tc, tob)
            if bool(flag):
                rec = obw.record_from_state(observe, row)
                windows.append(rec)
                if obs_sink is not None:
                    obs_sink([rec])

    drain_pending(resp, ctr, cols["done"], cols["task"], cols["arrv"])
    resp_out, ledger = build_ledger(resp[:n_tasks], ctr, n_tasks, max_clean)
    info = {"turns": T, "flush_overflow": 0, "pend_overflow": 0,
            "ledger": ledger, "most_in_flight": most_in_flight,
            "largest_flush": largest_flush}
    if observe is not None:
        tail = obw.final_partial_record(observe, tc)
        if tail is not None:
            windows.append(tail)
            if obs_sink is not None:
                obs_sink([tail])
        info["windows"] = windows
    return resp_out, np.asarray(mu_trace), info
