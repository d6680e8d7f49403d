"""The port's failure semantics (``repro_torch.serving.recovery``, the faulty
turn of ``serving.scanloop``, ``core.metrics.check_conservation`` /
``fault_report``) on the CPU, at the registry's own cluster (n = 5,
batches of 8, seed 0), mirroring the single-frontend cases of
tests/test_faults.py:

(i) an inert ``RecoveryConfig`` is bit-exact to the plain paths, host and
scan (``null``, ``churn``);
(ii) the fault scenarios with recovery armed, host against scan and each
against the reference (the port's host recovery loop against
``repro.serving.recovery.run_workload_recovery``, the port's faulty scan
against the reference's), are tests/test_torch_faults_scan.py, which makes
each port run once for all three comparisons; the fault columns without
recovery with the retries' rescue are tests/test_torch_faults_bare.py;
(iii) the ledger conserves over random fault schedules and budgets;
stalled completions never reach the learner; churn departures drain;
pending overflow raises by default and ``pend_cap=None`` sizes itself;
(iv) against the reference: the other seven policies are held to the
reference's host loop (its scan draws float64 threefry uniforms, ROADMAP
queue C) and to the port's own host loop, responses and every ledger entry
equal, μ̂ exact for the first turns and within ``MU_ULPS`` after;
``fault_report`` and ``check_conservation`` equal on the same inputs;
(v) the widened serve (``RosellaRouter.serve_turn_recovery``, the
scheduler's ``m_route``/``slots``) and the queue-view edits against the
reference's router.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import numpy as np
import pytest
import torch

from repro import env as jenv
from repro.core import metrics as jmet
from repro.serving import recovery as jrcv
from repro.serving import router as jrt
from repro_torch import env as tenv
from repro_torch.core import metrics as tmet
from repro_torch.core import policies as tpol
from repro_torch.serving import recovery as trcv
from repro_torch.serving import router as tr
from repro_torch.serving import scanloop as tsl

K = 8  # arrival batch
ARMED = dict(timeout_mult=8.0, retry_budget=2, retry_cap=4, spec_cap=2, spec_ratio=3.0)
RECOVERY = trcv.RecoveryConfig(**ARMED)
REF_RECOVERY = jrcv.RecoveryConfig(**ARMED)
FAULT_SCENARIOS = ["crash_storm", "blackout", "grey_failure"]
MU_ULPS = 8  # the learner's float sum (test_torch_router)


def ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _run(name, *, use_scan, recovery=None, seed=0, use_alias=True, policy="ppot_sq2", **mk):
    return tenv.run_scenario(
        tenv.make(name, **mk), use_scan=use_scan, sequential_pool=True, arrival_batch=K,
        seed=seed, recovery=recovery, use_alias=use_alias, policy=policy, device="cpu")


def shared_runs():
    """A cache of ``_run``'s results for one test module: a run that several
    of its tests read (never write) is made once."""
    cache = {}

    def run(name, **kw):
        key = (name, repr(sorted(kw.items())))
        if key not in cache:
            cache[key] = _run(name, **kw)
        return cache[key]

    return run


_shared = shared_runs()


def _ref(name, *, use_scan=False, use_alias=True, policy="ppot_sq2"):
    return jenv.run_scenario(jenv.make(name), use_scan=use_scan, sequential_pool=True,
                             arrival_batch=K, seed=0, recovery=REF_RECOVERY,
                             use_alias=use_alias, policy=policy)


def _same(a, b):
    """Float for float: responses (NaN at the same tasks), μ̂ trace, the
    pool's clocks, the final learner and key, the ledger."""
    np.testing.assert_array_equal(a["responses"], b["responses"])
    np.testing.assert_array_equal(a["mu_trace"], b["mu_trace"])
    np.testing.assert_array_equal(a["pool"].free_at, b["pool"].free_at)
    assert torch.equal(a["router"].learner.mu_hat, b["router"].learner.mu_hat)
    assert torch.equal(a["router"].q_view, b["router"].q_view)
    assert a["router"].key == b["router"].key
    assert a["info"]["ledger"] == b["info"]["ledger"]


# ---------------------------------------------------------------------------
# (i) zero-fault parity: the recovery machinery costs nothing when unused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["null", "churn"])
def test_inert_recovery_bit_exact_host(name):
    a = _run(name, use_scan=False)
    b = _shared(name, use_scan=False, recovery=trcv.INERT_RECOVERY)
    np.testing.assert_array_equal(a["responses"], b["responses"])
    np.testing.assert_array_equal(a["mu_trace"], b["mu_trace"])
    np.testing.assert_array_equal(a["pool"].free_at, b["pool"].free_at)
    led = b["info"]["ledger"]
    assert led["lost_tasks"] == 0 and led["conserved"]
    assert "ledger" not in a["info"]


@pytest.mark.parametrize("name", ["null", "churn"])
def test_inert_recovery_bit_exact_scan(name):
    a = _run(name, use_scan=True)
    b = _run(name, use_scan=True, recovery=trcv.INERT_RECOVERY)
    h = _shared(name, use_scan=False, recovery=trcv.INERT_RECOVERY)
    np.testing.assert_array_equal(a["responses"], b["responses"])
    np.testing.assert_array_equal(a["mu_trace"], b["mu_trace"])
    np.testing.assert_array_equal(a["pool"].free_at, b["pool"].free_at)
    _same(h, b)
    assert b["info"]["turns"] == len(b["mu_trace"]) > 100


# ---------------------------------------------------------------------------
# (iii) the recovery layer's contract
# ---------------------------------------------------------------------------


def test_conservation_random_fault_schedules():
    """Random crash/blackout schedules x random budgets, timeouts and
    speculation: host and scan ledgers equal and conserved on every draw."""
    rng = np.random.RandomState(7)
    for trial in range(6):
        events = tuple(
            (float(rng.uniform(5.0, 70.0)), int(rng.randint(5)),
             float(rng.uniform(4.0, 25.0)),
             "crash" if rng.rand() < 0.5 else "blackout")
            for _ in range(rng.randint(2, 5)))
        rc = trcv.RecoveryConfig(
            timeout_mult=float(rng.choice([4.0, 8.0, 16.0, np.inf])),
            retry_budget=int(rng.randint(0, 4)), retry_cap=4,
            spec_cap=int(rng.randint(0, 3)))
        scn = tenv.Scenario(f"prop{trial}", speeds=(0.25, 0.5, 1.0, 2.0, 1.0), rate=3.0,
                            horizon=90.0, faults=tenv.FaultSchedule(events=events))
        kw = dict(sequential_pool=True, arrival_batch=K, seed=trial, recovery=rc,
                  device="cpu")
        h = tenv.run_scenario(scn, **kw)
        s = tenv.run_scenario(scn, use_scan=True, **kw)
        lh, ls = h["info"]["ledger"], s["info"]["ledger"]
        assert lh == ls, (trial, events)
        ok, residuals = tmet.check_conservation(ls)
        assert ok, (trial, events, residuals)
        np.testing.assert_array_equal(h["responses"], s["responses"])
        np.testing.assert_array_equal(h["mu_trace"], s["mu_trace"])
        assert np.isfinite(s["responses"]).sum() == ls["completed_tasks"]


def test_learner_not_contaminated_by_stalled_completions():
    """A 45 s blackout stretches in-flight service by the full window; those
    completions are dirty and never feed μ̂."""
    out = _run("blackout", use_scan=True, recovery=RECOVERY)
    led = out["info"]["ledger"]
    assert led["n_dirty_completions"] > 0
    assert led["n_stalled"] > 0
    assert 0.0 < led["max_clean_service"] < 45.0


def test_serving_churn_departure_drains_in_flight():
    """Graceful churn loses nothing on either loop; the same membership
    dynamics as crashes kill in-flight copies."""
    for use_scan in (False, True):
        out = _run("churn", use_scan=use_scan, recovery=trcv.INERT_RECOVERY)
        led = out["info"]["ledger"]
        assert led["lost_tasks"] == 0 and led["copies_real_killed"] == 0, use_scan
        assert np.isfinite(out["responses"]).all()
    out = _run("crash_storm", use_scan=True)
    assert out["info"]["ledger"]["copies_real_killed"] > 0


def _tiny_workload():
    T, k, n = 8, 4, 3
    times = (np.arange(T * k, dtype=np.float64).reshape(T, k) + 1) * 0.01
    costs = np.full((T, k), 5.0)  # slow tasks pile up the pending set
    speeds = np.ones((T, n))
    return times, costs, speeds, n


def _tiny_router(n):
    return tr.RosellaRouter(n, mu_bar=float(n), async_mu=False, device="cpu")


@pytest.mark.parametrize("recovery", [None, RECOVERY], ids=["plain", "armed"])
def test_pend_overflow_raises_by_default(recovery):
    times, costs, speeds, n = _tiny_workload()
    with pytest.raises(RuntimeError, match="pend_cap"):
        tsl.run_workload_scan(_tiny_router(n), tr.SequentialPool(np.ones(n)), times, costs,
                              speeds, fake_cost=0.25, pend_cap=8, recovery=recovery)


def test_pend_overflow_reported_when_opted_out():
    times, costs, speeds, n = _tiny_workload()
    _, _, info = tsl.run_workload_scan(_tiny_router(n), tr.SequentialPool(np.ones(n)), times,
                                       costs, speeds, fake_cost=0.25, pend_cap=8,
                                       strict_overflow=False, recovery=RECOVERY)
    assert info["pend_overflow"] > 0


def test_pend_cap_autosizes_from_workload_bound():
    """``pend_cap=None`` sizes the pending set from the submission bound,
    retry and speculation slots included: the piled-up workload runs clean
    with a crash and recovery armed, equal to the host loop."""
    times, costs, speeds, n = _tiny_workload()
    kill = np.full((times.shape[0], n), np.inf)
    kill[4, 0] = 0.3
    resp, mu, info = tsl.run_workload_scan(
        _tiny_router(n), tr.SequentialPool(np.ones(n)), times, costs, speeds,
        fake_cost=0.25, kill_np=kill, recovery=RECOVERY)
    assert info["pend_overflow"] == 0 and info["flush_overflow"] == 0
    assert tmet.check_conservation(info["ledger"])[0]
    wl = tenv.ServingWorkload(times=times, costs=costs, speeds=speeds, active=None,
                              rejoin=None, burst=None, shift_times=np.empty(0), kill_at=kill)
    h_resp, h_mu, h_info = tenv.run_workload(_tiny_router(n), tr.SequentialPool(np.ones(n)),
                                             wl, fake_cost=0.25, recovery=RECOVERY)
    np.testing.assert_array_equal(resp, h_resp)
    np.testing.assert_array_equal(mu, h_mu)
    assert h_info["ledger"] == info["ledger"]


def test_task_cap_and_telemetry_raise():
    times, costs, speeds, n = _tiny_workload()
    router, pool = _tiny_router(n), tr.SequentialPool(np.ones(n))
    chunks = ({"times": times, "costs": costs, "speeds": speeds,
               "kill": np.full((8, n), np.inf), "stall": np.full((8, n), np.inf),
               "stall_dur": np.zeros((8, n))} for _ in range(1))
    with pytest.raises(RuntimeError, match="task_cap"):
        tsl._drive_scan(router, pool, chunks, rows=8, k=4, churn=False, burst_cap=0,
                        fake_cost=0.25, burst_cost=1.0, pend_cap=1024, comp_cap=None,
                        strict_overflow=True, recovery=RECOVERY, task_cap=16)
    # telemetry runs since A5 (the cases stay, inverted): the recovery loop
    # folds windows and records the lifecycle, the faulty scan streams windows
    from repro_torch import obs

    wl = tenv.make("crash_storm", horizon=20.0).compile_serving(seed=0, arrival_batch=K)
    off = trcv.run_workload_recovery(_tiny_router(5), tr.SequentialPool(np.ones(5)), wl,
                                     fake_cost=0.25, recovery=RECOVERY)
    trace, seen = obs.DecisionTrace(), []
    resp, _, info = trcv.run_workload_recovery(
        _tiny_router(5), tr.SequentialPool(np.ones(5)), wl, fake_cost=0.25, recovery=RECOVERY,
        observe=obs.ObserveConfig(window_turns=4), decisions=trace, obs_sink=seen.extend)
    np.testing.assert_array_equal(resp, off[0])
    assert info["ledger"] == off[2]["ledger"] and seen == info["windows"]
    assert sum(r["killed"] for r in seen) == info["ledger"]["copies_real_killed"]
    assert sum(e[0] == "complete" for e in trace.ring) == sum(r["n_resp"] for r in seen)
    seen = []
    _, _, sinfo = tsl.run_workload_scan(_tiny_router(n), tr.SequentialPool(np.ones(n)), times,
                                        costs, speeds, recovery=RECOVERY, obs_sink=seen.extend,
                                        observe=obs.ObserveConfig(window_turns=3))
    assert seen == sinfo["windows"] and len(seen) == 3


# ---------------------------------------------------------------------------
# (iv) against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", [p for p in tpol.ALL_POLICIES if p != "ppot_sq2"])
def test_every_policy_recovers_as_the_reference_host_loop(policy):
    """crash_storm, recovery armed, under each other policy: the port's scan
    equal to its host loop, and its host loop to the reference's
    (responses and ledger equal, μ̂ within MU_ULPS and exact for at least
    the first 6 turns)."""
    h = _run("crash_storm", use_scan=False, recovery=RECOVERY, policy=policy)
    s = _run("crash_storm", use_scan=True, recovery=RECOVERY, policy=policy)
    _same(h, s)
    ref = _ref("crash_storm", policy=policy)
    np.testing.assert_array_equal(h["responses"], ref["responses"])
    assert h["info"]["ledger"] == ref["info"]["ledger"]
    mu_r = np.asarray(ref["mu_trace"])
    np.testing.assert_array_equal(h["mu_trace"][:6], mu_r[:6])
    assert ulps(mu_r, h["mu_trace"]) <= MU_ULPS
    assert h["info"]["ledger"]["n_retries"] > 0


def test_metrics_equal_the_reference_on_planted_ledgers():
    rng = np.random.RandomState(2)
    resp = rng.exponential(2.0, 400)
    resp[rng.rand(400) < 0.05] = np.nan
    done = int(np.isfinite(resp).sum())
    good = {"n_tasks": 400, "completed_tasks": done, "lost_tasks": 400 - done,
            "copies_real_launched": 470, "copies_real_completed": 450,
            "copies_real_killed": 20, "fake_launched": 90, "fake_completed": 88,
            "fake_killed": 2, "n_timeouts": 31, "n_retries": 50, "n_spec": 20,
            "n_dirty_completions": 40, "n_stalled": 3}
    bad = dict(good, copies_real_killed=19, fake_killed=0)
    for led in (good, bad):
        for horizon in (None, 120.0):
            got = tmet.fault_report(resp, led, horizon=horizon)
            want = jmet.fault_report(resp, led, horizon=horizon)
            assert got == want
        assert tmet.check_conservation(led) == jmet.check_conservation(led)
    assert not tmet.check_conservation(bad)[0]
    empty = tmet.fault_report(np.full(4, np.nan), dict(good, n_tasks=4, completed_tasks=0,
                                                       lost_tasks=4))
    assert np.isnan(empty["p50"]) and empty["loss_rate"] == 1.0


def test_recovery_epilogue_equals_the_reference():
    """``backoff_lut``, ``drain_pending`` and ``build_ledger`` on planted
    inputs: equal to the reference's."""
    for rc in (RECOVERY, trcv.INERT_RECOVERY, trcv.RecoveryConfig(backoff=1.5,
                                                                   retry_budget=5)):
        ref_rc = jrcv.RecoveryConfig(**{f: getattr(rc, f) for f in rc.__dataclass_fields__})
        np.testing.assert_array_equal(trcv.backoff_lut(rc), jrcv.backoff_lut(ref_rc))
    assert trcv.CTR == jrcv.CTR and trcv.NCTR == jrcv.NCTR
    rng = np.random.RandomState(3)
    done = np.where(rng.rand(60) < 0.2, np.inf, rng.rand(60) * 10)
    task = np.where(rng.rand(60) < 0.3, -1, rng.randint(0, 40, 60))
    arrv = rng.rand(60)
    resp0 = np.where(rng.rand(40) < 0.5, np.inf, 3.0)
    outs = []
    for mod in (trcv, jrcv):
        resp = resp0.copy()
        ctr = np.arange(mod.NCTR, dtype=np.int64)
        mod.drain_pending(resp, ctr, done, task, arrv)
        outs.append((resp, ctr, *mod.build_ledger(resp, ctr, 40, 2.5)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[0][2], outs[1][2])
    assert outs[0][3] == outs[1][3]


# ---------------------------------------------------------------------------
# (v) the widened serve and the queue-view edits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_alias", [True, False], ids=["alias", "icdf"])
def test_serve_turn_recovery_matches_the_reference(use_alias, masked):
    """Twelve turns of ``serve_turn_recovery`` (retry slots gated at random,
    completions folded, drains and loads between) on both routers: fake
    jobs, workers (-1 in a closed slot), queue views equal; μ̂ within
    MU_ULPS."""
    n, rcap = 12, 4
    rng = np.random.RandomState(11 + use_alias + 2 * masked)
    kw = dict(mu_bar=6.0, seed=5, async_mu=False, use_alias=use_alias)
    rt_, rj = tr.RosellaRouter(n, device="cpu", **kw), jrt.RosellaRouter(n, **kw)
    if masked:
        act = rng.rand(n) < 0.7
        rt_.set_membership(act, 0.0)
        rj.set_membership(act, 0.0)
    t = 0.0
    for turn in range(12):
        t += float(rng.exponential(0.5))
        slots = rng.rand(rcap) < 0.5
        nw = int(rng.choice([0, 3, 9]))
        cw = rng.randint(0, n, nw).astype(np.int32) if nw else None
        ct = rng.exponential(1.0, nw).astype(np.float32) if nw else None
        a = rt_.serve_turn_recovery(t, K, cw, ct, t, rcap, slots)
        b = rj.serve_turn_recovery(t, K, cw, ct, t, rcap, slots)
        np.testing.assert_array_equal(a[0], np.asarray(b[0]))
        np.testing.assert_array_equal(a[1], np.asarray(b[1]))
        assert len(a[1]) == K + rcap and (a[1][K:][~slots] == -1).all()
        assert (a[1][K:][slots] >= 0).all()
        counts = rng.randint(0, 3, n)
        (rt_.drain_queue if turn % 2 else rt_.add_queue)(counts)
        (rj.drain_queue if turn % 2 else rj.add_queue)(counts)
        np.testing.assert_array_equal(rt_.q_view.numpy(), np.asarray(rj.q_view))
        assert ulps(rt_.mu_hat, np.asarray(rj.learner.mu_hat)) <= MU_ULPS
    assert (rt_.q_view >= 0).all()
