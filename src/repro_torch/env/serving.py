"""Serving-layer execution of compiled scenarios.

``run_workload`` is the HOST loop over a ``ServingWorkload`` — the same
per-turn structure as ``serving/router.run_simulation`` (flush due
completions → one ``serve_turn`` → submit fakes/reals → one μ̂ sample),
consuming the scenario's pre-materialized arrays instead of drawing
lazily, plus the two membership hooks of churn scenarios:
``router.set_membership`` at mask-change turns (masked table rebuild +
learner cold-start) and the fake-job probe burst at rejoined replicas.

Because the null scenario's workload arrays replay ``run_simulation``'s
exact RandomState sequence and this loop issues the identical router and
pool calls in the identical order, ``run_workload(null)`` is bit-exact to
``run_simulation`` — and for every fault-free scenario it is float for
float equal to the one-program loop (``serving/scanloop.run_workload_scan``)
when driven with a deterministic (``async_mu=False``) router and a
``SequentialPool``, on the CPU and on the card (tests/test_torch_env.py,
tests/test_torch_cuda.py).

``run_scenario`` builds router and pool, compiles the scenario, runs the
host loop or the one-program loop and returns responses, μ̂ trace and
the workload (whose speed and membership trajectories feed the
adaptation-time metric, ``core.metrics.adaptation_report``).

A fault scenario (crash kills, blackout stalls) or a ``recovery`` config
(timeouts, retries, speculative copies) runs the failure-semantics loops:
``serving.recovery.run_workload_recovery`` on the host and the faulty turn
of the one-program loop, equal float for float, responses task-indexed
with NaN for a lost task and ``info["ledger"]`` the conservation ledger.

Not ported yet, and refused by name: ``observe`` and ``decisions``
(telemetry, ROADMAP queue A, A5), ``n_frontends > 1`` (the frontend fleet,
A6). Every policy of ``core.policies.ALL_POLICIES`` runs through both
loops.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import policies as pol
from repro_torch.env.scenario import Scenario, ServingWorkload
from repro_torch.serving import recovery as rcv
from repro_torch.serving import router as rt
from repro_torch.serving import scanloop


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue A, {item})")


def run_workload(
    router: rt.RosellaRouter,
    pool: rt.SimulatedPool,
    wl: ServingWorkload,
    *,
    fake_cost: float,
    burst_cost: float | None = None,
    recovery=None,
    observe=None,
    decisions=None,
):
    """Drive the host serving loop over a compiled workload.

    Rejoin probe bursts submit at ``burst_cost`` (default 4×fake_cost =
    the full request cost): they dominate a rejoined worker's fresh
    sample ring, so they must be cost-calibrated with real traffic —
    cheap fake-cost probes would rebuild its μ̂ ~4× high and herd the
    router onto the worker that just came back.

    Returns ``(response_times, mu_trace, info)`` — the scan loop's
    contract (``info`` carries the turn count; overflow accounting is a
    scan-only concern, reported as zeros here for symmetry).
    """
    if wl.has_faults or recovery is not None:
        # the failure-semantics loop subsumes this one (fault-free with
        # inert recovery it is bit-equal); the plain loop stays the fast
        # path of the fault-free case
        return rcv.run_workload_recovery(
            router, pool, wl, fake_cost=fake_cost, burst_cost=burst_cost,
            recovery=recovery, observe=observe, decisions=decisions)
    if observe is not None:
        raise _not_ported("run_workload(observe=...): telemetry", "A5")
    if decisions is not None:
        raise _not_ported("run_workload(decisions=...): the decision trace", "A5")
    if burst_cost is None:
        burst_cost = 4.0 * fake_cost
    T = wl.turns
    k = wl.times.shape[1] if T else 0
    responses: list[np.ndarray] = []
    mu_trace: list[np.ndarray] = []
    p_done = np.empty(0)
    p_rep = np.empty(0, np.int32)
    p_start = np.empty(0)

    for turn in range(T):
        times = wl.times[turn]
        t = float(times[-1])
        pool.set_speeds(wl.speeds[turn])

        # gather completions that happened before this batch, oldest first
        # (identical to run_simulation)
        due = p_done <= t
        comp_w = comp_t = None
        comp_now = t
        if due.any():
            order = np.argsort(p_done[due], kind="stable")
            comp_w = p_rep[due][order]
            comp_t = (p_done - p_start)[due][order]
            comp_now = float(p_done[due].max())
            keep = ~due
            p_done, p_rep, p_start = p_done[keep], p_rep[keep], p_start[keep]

        # membership hook: apply the mask at turn 0 and at change turns —
        # rejoins cold-start the learner BEFORE this turn's completion
        # fold, the same ordering as the scan body
        burst_js = np.empty(0, np.int64)
        if wl.active is not None:
            changed = turn == 0 or not np.array_equal(wl.active[turn], wl.active[turn - 1])
            if changed:
                router.set_membership(wl.active[turn], t, rejoin=wl.rejoin[turn])
            if wl.burst is not None and wl.burst.shape[1]:
                bt = wl.burst[turn]
                burst_js = bt[bt >= 0].astype(np.int64)

        # completion flush + benchmark requests + batch route: one turn
        fake_js, js = router.serve_turn(t, k, comp_w, comp_t, comp_now)

        # submissions in fakes → probe burst → reals order (the scan
        # body's order; the insertion sequence must match)
        for sub_js, sub_cost in ((fake_js, fake_cost), (burst_js, burst_cost)):
            if len(sub_js):
                fs, fd = pool.submit_batch(sub_js, np.full(len(sub_js), t),
                                           np.full(len(sub_js), sub_cost))
                p_done = np.concatenate([p_done, fd])
                p_rep = np.concatenate([p_rep, sub_js.astype(np.int32)])
                p_start = np.concatenate([p_start, fs])
        ss, dd = pool.submit_batch(js, times, wl.costs[turn])
        responses.append(dd - times)
        p_done = np.concatenate([p_done, dd])
        p_rep = np.concatenate([p_rep, js.astype(np.int32)])
        p_start = np.concatenate([p_start, ss])
        mu_trace.append(router.mu_front.cpu().numpy())

    resp = np.concatenate(responses) if responses else np.empty(0)
    info = {"turns": T, "flush_overflow": 0, "pend_overflow": 0}
    return resp, np.asarray(mu_trace), info


def run_scenario(
    scn: Scenario,
    *,
    policy: str = pol.PPOT_SQ2,
    seed: int = 0,
    arrival_batch: int = 8,
    use_scan: bool = False,
    async_mu: bool = False,
    use_alias: bool = True,
    sequential_pool: bool = False,
    c_window: float = 10.0,
    router: rt.RosellaRouter | None = None,
    pool: rt.SimulatedPool | None = None,
    n_frontends: int = 1,
    sync_every: int = 1,
    herd_correction=False,
    frozen_mu: bool = False,
    recovery=None,
    observe=None,
    obs_sink=None,
    decisions=None,
    chunk_turns: int | None = None,
    pend_cap: int | None = None,
    comp_cap: int | None = None,
    device=None,
):
    """One scenario end to end on the serving layer.

    Builds a ``RosellaRouter`` (μ̄ = baseline capacity) on ``device``
    (``None`` is the CUDA card, and raises without one; ``"cpu"`` runs on
    the CPU) and a pool at the baseline speeds, compiles the workload,
    runs the host loop (or the one-program loop with ``use_scan``) and
    returns a dict with the responses, the μ̂ trace, the loop's ``info``,
    the workload (for adaptation-time analysis) and the router and pool
    (final states). ``async_mu=False`` is the deterministic default so
    scenario runs are reproducible; pass ``sequential_pool=True`` for the
    exact-parity pool chain.

    ``n_frontends > 1`` (the frontend fleet, with ``sync_every``,
    ``herd_correction`` and ``frozen_mu``) is not ported yet and raises.
    """
    if n_frontends > 1:
        raise _not_ported(f"run_scenario(n_frontends={n_frontends}): the frontend "
                          f"fleet", "A6")
    del sync_every, herd_correction, frozen_mu  # the fleet's options
    speeds0 = np.asarray(scn.speeds, float)
    if router is None:
        router = rt.RosellaRouter(
            scn.n, mu_bar=float(speeds0.sum()), policy=policy, seed=seed,
            async_mu=async_mu, use_alias=use_alias, c_window=c_window, device=device)
    if pool is None:
        pool_cls = rt.SequentialPool if sequential_pool else rt.SimulatedPool
        pool = pool_cls(speeds0)
    wl = scn.compile_serving(seed=seed, arrival_batch=arrival_batch)
    fake_cost = scn.request_cost * 0.25
    if use_scan:
        resp, mu_trace, info = scanloop.run_workload_scan(
            router, pool, wl.times, wl.costs, wl.speeds,
            active_np=wl.active, rejoin_np=wl.rejoin, burst_np=wl.burst,
            fake_cost=fake_cost, kill_np=wl.kill_at, stall_np=wl.stall_at,
            stall_dur_np=wl.stall_dur, recovery=recovery,
            chunk_turns=chunk_turns, pend_cap=pend_cap, comp_cap=comp_cap,
            observe=observe, obs_sink=obs_sink,
        )
    else:
        resp, mu_trace, info = run_workload(
            router, pool, wl, fake_cost=fake_cost, recovery=recovery,
            observe=observe, decisions=decisions,
        )
    return {
        "responses": resp,
        "mu_trace": mu_trace,
        "info": info,
        "workload": wl,
        "router": router,
        "pool": pool,
    }
