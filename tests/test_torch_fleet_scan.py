"""The port's one-program fleet (``serving.scanloop.run_fleet_workload_scan``,
``run_fleet_simulation_scan``, ``env.run_scenario(n_frontends > 1)``) on the
CPU, at tests/test_fleet_scan.py's sizes: n = 4 (speeds 0.25/0.5/1/2,
arrivals at 3/s for 80 s) and the registry's scenarios (n = 5, 360 s),
batches of 8.

(i) Its own contracts, exact: at S = 1 bit-equal to the single-frontend
scan (and so to the host loops) on both probe streams, plain, under churn
and with faults; at S ∈ {2, 4} and any sync cadence equal float for float to
the host fleet loop (``run_fleet_simulation``, ``SequentialPool``,
``async_mu=False``); chunked runs equal to one chunk; telemetry on equal to
off for the responses; stream-only windows equal to the full mode's.
(ii) Against the reference's fleet scan (under the ``ref_scan`` alias of
``jax.experimental.enable_x64``, as tests/test_torch_env.py): responses,
placements, sync gaps and the ledger equal; μ̂ exact until the turn at which
the learners' float sums part (``EXACT_MU_TURNS``) and within ``MU_ULPS``
after; placements never on an inactive replica. The telemetry windows
within tests/test_torch_obs.py's bars; the per-frontend windows too, except
the detector's float state, held to ``DET_ATOL_FRONTEND``: a frontend folds
a quarter of the samples, so its μ̂ error, which differs by the learners'
ulps (within ``MU_ERR_ULPS`` here too), moves its detector baselines more
(measured 2.9e-6 beyond ``DET_RTOL``·|x|); every alarm field is equal.
(iii) What the fleet refuses, as the reference does.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import functools

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro_torch import env as tenv
from repro_torch import obs
from repro_torch.serving import recovery as trcv
from repro_torch.serving import router as tr
from repro_torch.serving import scanloop as tsl

from test_torch_obs import assert_windows_within_bars, edge_count, window_diffs

SPEEDS = np.array([0.25, 0.5, 1.0, 2.0])
KW = dict(arrival_rate=3.0, horizon=80.0, seed=1, arrival_batch=8)
K = 8
MU_ULPS = 8  # the learner's refresh sums, as tests/test_torch_router.py
#: the turn at which the port's μ̂ trace parts from the reference scan's,
#: measured at seed 0 (the responses stay equal on every turn)
EXACT_MU_TURNS = 2
DET_ATOL_FRONTEND = 1e-5
OCFG = obs.ObserveConfig(window_turns=8, detect=obs.DetectConfig(warmup_windows=4))
#: the reference comparisons: the scenario and the fleet options
REF_CASES = {
    "churn": ("churn", {}),
    "churn_heavy": ("churn_heavy", {}),
    "frozen_mu": ("churn_heavy", dict(frozen_mu=True, sync_every=4)),
    "herd_gains": ("cotenant_shock", dict(herd_correction=[1.0, 0.0, 0.5, 1.0], sync_every=4)),
    "crash_storm": ("crash_storm", {}),
}


def ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _fleet(S, use_alias=True, **kw):
    return (tr.FleetRouter(S, 4, mu_bar=SPEEDS.sum(), seed=0, async_mu=False,
                           use_alias=use_alias, device="cpu", **kw), tr.SequentialPool(SPEEDS))


@functools.lru_cache(maxsize=None)
def _port(name, observe=None, chunk_turns=None, **kw):
    kw = {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}
    return tenv.run_scenario(tenv.make(name), use_scan=True, sequential_pool=True,
                             arrival_batch=K, seed=0, n_frontends=4, device="cpu",
                             observe=observe, chunk_turns=chunk_turns, **kw)


def _port_case(case, **kw):
    name, opts = REF_CASES[case]
    return _port(name, **{k: tuple(v) if isinstance(v, list) else v for k, v in opts.items()},
                 **kw)


@pytest.fixture(scope="module")
def ref_scan():
    """The reference's scenarios on jax 0.9, which has ``jax.enable_x64(True)``
    where the reference imports ``jax.experimental.enable_x64``; one run per
    case for the module."""
    from repro import env as jenv
    from repro import obs as jobs

    runs = {}

    def run(case, observe=False):
        if (case, observe) not in runs:
            name, opts = REF_CASES[case]
            jcfg = (jobs.ObserveConfig(window_turns=8,
                                       detect=jobs.DetectConfig(warmup_windows=4))
                    if observe else None)
            runs[(case, observe)] = jenv.run_scenario(
                jenv.make(name), use_scan=True, sequential_pool=True, arrival_batch=K,
                seed=0, n_frontends=4, observe=jcfg, **opts)
        return runs[(case, observe)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                   raising=False)
        yield run


def _same_runs(a, b) -> None:
    """Two runs of the port, equal in everything they return."""
    np.testing.assert_array_equal(a["responses"], b["responses"])
    np.testing.assert_array_equal(a["mu_trace"], b["mu_trace"])
    np.testing.assert_array_equal(a["pool"].free_at, b["pool"].free_at)
    for key in ("workers", "sync_gaps", "epochs", "frontends", "lam_hats"):
        np.testing.assert_array_equal(a["info"][key], b["info"][key], err_msg=key)
    assert a["info"].get("ledger") == b["info"].get("ledger")


# ---------------------------------------------------------------------------
# (i) the port's own contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_alias", [True, False])
def test_s1_fleet_scan_is_bit_equal_to_the_single_scan(use_alias):
    """At S = 1 the fleet turn's extra machinery (sync, herd terms, the
    frontend partition) is numerically inert: responses, μ̂ trace, replica
    clocks, queue view, learner and key equal the single scan's."""
    ra = tr.RosellaRouter(4, mu_bar=SPEEDS.sum(), seed=0, async_mu=False, use_alias=use_alias,
                          device="cpu")
    pa = tr.SequentialPool(SPEEDS)
    resp_a, mu_a, _ = tsl.run_simulation_scan(ra, pa, **KW)
    rb, pb = _fleet(1, use_alias)
    resp_b, mu_b, info = tsl.run_fleet_simulation_scan(rb, pb, sync_every=3, **KW)
    assert info["flush_overflow"] == info["pend_overflow"] == 0
    np.testing.assert_array_equal(resp_a, resp_b)
    np.testing.assert_array_equal(mu_a, mu_b)
    np.testing.assert_array_equal(pa.free_at, pb.free_at)
    fr = rb.frontends[0]
    assert torch.equal(ra.q_view, fr.q_view) and torch.equal(ra.learner.mu_hat,
                                                              fr.learner.mu_hat)
    assert ra.key == fr.key and info["sync_gaps"].shape == (0, 1)


@pytest.mark.parametrize("name,use_alias", [("churn", True), ("churn_heavy", False),
                                            ("crash_storm", True)])
def test_s1_fleet_scan_under_churn_and_faults_is_the_single_scan(name, use_alias):
    """The environment at S = 1: a scenario's compiled workload through the
    fleet turn equals the single scan (and the single host loop) bit for
    bit: membership masking, cold starts, probe bursts, and the fault
    subset with its ledger (the single scan's inert recovery)."""
    scn = tenv.make(name)
    wl = scn.compile_serving(seed=0, arrival_batch=K)
    sp = np.asarray(scn.speeds)
    args = (wl.times, wl.costs, wl.speeds)
    kw = dict(active_np=wl.active, rejoin_np=wl.rejoin, burst_np=wl.burst,
              fake_cost=scn.request_cost * 0.25, kill_np=wl.kill_at, stall_np=wl.stall_at,
              stall_dur_np=wl.stall_dur)
    single = tr.RosellaRouter(scn.n, mu_bar=float(sp.sum()), seed=0, async_mu=False,
                              use_alias=use_alias, device="cpu")
    ps = tr.SequentialPool(sp)
    resp_s, mu_s, info_s = tsl.run_workload_scan(single, ps, *args, pend_cap=tsl.PEND_CAP, **kw)
    fleet = tr.FleetRouter(1, scn.n, mu_bar=float(sp.sum()), seed=0, async_mu=False,
                           use_alias=use_alias, device="cpu")
    pf = tr.SequentialPool(sp)
    resp_f, mu_f, info_f = tsl.run_fleet_workload_scan(fleet, pf, *args, sync_every=2, **kw)
    np.testing.assert_array_equal(resp_s, resp_f)
    np.testing.assert_array_equal(mu_s, mu_f)
    np.testing.assert_array_equal(ps.free_at, pf.free_at)
    assert info_s.get("ledger") == info_f.get("ledger")
    assert torch.equal(single.learner.mu_hat, fleet.frontends[0].learner.mu_hat)
    assert torch.equal(single.active, fleet.frontends[0].active)
    host = tenv.run_scenario(scn, seed=0, arrival_batch=K, use_alias=use_alias,
                             sequential_pool=True, device="cpu")
    np.testing.assert_array_equal(host["responses"], resp_f)
    if name == "crash_storm":
        assert info_f["ledger"]["conserved"] and info_f["ledger"]["copies_real_killed"] > 0


@functools.lru_cache(maxsize=None)
def _host_and_scan(S, sync_every, use_alias=True, chunk_turns=None):
    rh, ph = _fleet(S, use_alias)
    host = tr.run_fleet_simulation(rh, ph, sync_every=sync_every, **KW)
    rs, ps = _fleet(S, use_alias)
    scan = tsl.run_fleet_simulation_scan(rs, ps, sync_every=sync_every,
                                         chunk_turns=chunk_turns, **KW)
    return (host, rh, ph), (scan, rs, ps)


@pytest.mark.parametrize("S,sync_every,use_alias", [(2, 1, True), (4, 1, True),
                                                    (2, 4, True), (4, 4, False)])
def test_fleet_scan_equals_the_host_fleet_loop(S, sync_every, use_alias):
    """S frontends in one program reproduce the host fleet loop float for
    float, at the every-turn cadence and with stale views: responses, μ̂
    trace, replica clocks, the agreed snapshot, the placement log and sync
    gaps, and every frontend's queue view, learner, μ̂ front and key."""
    ((resp_h, mu_h, ih), rh, ph), ((resp_s, mu_s, info), rs, ps) = _host_and_scan(
        S, sync_every, use_alias)
    assert info["flush_overflow"] == info["pend_overflow"] == 0
    assert info["turns"] == ih["turns"] == len(mu_h) > 20
    np.testing.assert_array_equal(resp_h, resp_s)
    np.testing.assert_array_equal(mu_h, mu_s)
    np.testing.assert_array_equal(ph.free_at, ps.free_at)
    np.testing.assert_array_equal(rh._snap, rs._snap)
    for key in ("frontends", "workers", "epochs", "sync_gaps", "lam_hats"):
        np.testing.assert_array_equal(ih[key], info[key], err_msg=key)
    for fh, fs in zip(rh.frontends, rs.frontends):
        assert torch.equal(fh.q_view, fs.q_view) and torch.equal(fh.mu_front, fs.mu_front)
        assert torch.equal(fh.learner.mu_hat, fs.learner.mu_hat) and fh.key == fs.key
        assert (fh._mu_pending is None) == (fs._mu_pending is None)


def test_fleet_scan_chunks_equal_one_chunk():
    """A run in chunks of 7 turns equals the unchunked run in every output
    and in the final state."""
    (_, ((resp_a, mu_a, ia), ra, pa)) = _host_and_scan(2, 1)
    (_, ((resp_b, mu_b, ib), rb, pb)) = _host_and_scan(2, 1, chunk_turns=7)
    np.testing.assert_array_equal(resp_a, resp_b)
    np.testing.assert_array_equal(mu_a, mu_b)
    np.testing.assert_array_equal(pa.free_at, pb.free_at)
    np.testing.assert_array_equal(ia["workers"], ib["workers"])
    for fa, fb in zip(ra.frontends, rb.frontends):
        assert torch.equal(fa.learner.samples, fb.learner.samples) and fa.key == fb.key
    _same_runs(_port_case("crash_storm"), _port_case("crash_storm", chunk_turns=7))


def test_fleet_scan_herd_gains_per_frontend():
    """``True`` equals a gain vector of ones bit for bit, a zeroed gain
    changes the routing, and the gains equal the host fleet loop's."""
    runs = {}
    for label, gains in (("true", True), ("ones", [1.0, 1.0]), ("zeroed", [1.0, 0.0])):
        r, p = _fleet(2, herd_correction=gains)
        runs[label] = tsl.run_fleet_simulation_scan(r, p, sync_every=4, **KW)
    np.testing.assert_array_equal(runs["true"][0], runs["ones"][0])
    assert not np.array_equal(runs["true"][0], runs["zeroed"][0])
    rh, ph = _fleet(2, herd_correction=[1.0, 0.0])
    resp_h, mu_h, _ = tr.run_fleet_simulation(rh, ph, sync_every=4, **KW)
    np.testing.assert_array_equal(runs["zeroed"][0], resp_h)
    np.testing.assert_array_equal(runs["zeroed"][1], mu_h)


# ---------------------------------------------------------------------------
# (ii) against the reference's fleet scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_fleet_scan_matches_the_reference_scan(ref_scan, case):
    """``run_scenario(n_frontends=4)`` against the reference's, nothing
    shared: responses (NaN for a lost task) and placements equal on every
    turn, the sync gaps and the ledger equal, μ̂ exact until
    EXACT_MU_TURNS and within MU_ULPS after; no placement lands on a replica
    inactive that turn."""
    p, r = _port_case(case), ref_scan(case)
    pi, ri = p["info"], r["info"]
    wl = p["workload"]
    assert pi["turns"] == ri["turns"] == wl.turns > 100
    assert pi["flush_overflow"] == pi["pend_overflow"] == 0
    for t in range(wl.turns):
        np.testing.assert_array_equal(p["responses"][t * K:(t + 1) * K],
                                      r["responses"][t * K:(t + 1) * K], err_msg=f"turn {t}")
    for key in ("workers", "sync_gaps", "epochs", "frontends"):
        np.testing.assert_array_equal(pi[key], ri[key], err_msg=key)
    assert pi.get("ledger") == ri.get("ledger")
    mu_p, mu_r = p["mu_trace"], np.asarray(r["mu_trace"])
    first = next((i for i in range(len(mu_r)) if not np.array_equal(mu_p[i], mu_r[i])),
                 len(mu_r))
    assert first == EXACT_MU_TURNS
    np.testing.assert_array_equal(mu_p == 0, mu_r == 0)
    assert ulps(mu_p, mu_r) <= MU_ULPS
    if wl.active is not None:
        placed = pi["workers"].reshape(wl.turns, -1)
        for t in range(wl.turns):
            assert wl.active[t][placed[t]].all(), (case, t)
    if case == "crash_storm":
        assert pi["ledger"]["conserved"] and pi["ledger"]["lost_tasks"] > 0
    if case in ("churn", "churn_heavy"):
        assert (~wl.active).any()


@pytest.mark.parametrize("case", ["churn", "crash_storm"])
def test_fleet_telemetry_matches_the_reference(ref_scan, case):
    """Windows of 8 turns with the detector on: the fleet-aggregate records
    and every frontend's records against the reference's within the bars;
    telemetry on equal to off for responses, placements and the ledger."""
    p, r = _port_case(case, observe=OCFG), ref_scan(case, observe=True)
    _same_runs_but_windows = _port_case(case)
    for key in ("responses", "mu_trace"):
        np.testing.assert_array_equal(p[key], _same_runs_but_windows[key])
    assert p["info"].get("ledger") == _same_runs_but_windows["info"].get("ledger")
    resp = p["responses"]
    n_edge = edge_count(resp[np.isfinite(resp)], OCFG)
    wp, wr = p["info"]["windows"], r["info"]["windows"]
    assert len(wp) == len(wr) == -(-p["info"]["turns"] // 8)
    assert_windows_within_bars(wp, wr, OCFG, n_edge)
    fp = [rec for w in p["info"]["windows_frontends"] for rec in w]
    fr = [rec for w in r["info"]["windows_frontends"] for rec in w]
    assert len(fp) == len(fr) == 4 * len(wp)
    assert [rec["frontend"] for rec in fp] == [rec["frontend"] for rec in fr]
    d = window_diffs(fp, fr, OCFG)
    assert d["hist_l1"] <= 2 * n_edge and d["q_ulps"] <= 2 and d["mu_ulps"] <= 16, d
    assert d["det_excess"] <= DET_ATOL_FRONTEND, d


def test_fleet_stream_only_and_sink_see_the_same_windows():
    """``emit_responses=False`` returns the window streams only, equal to the
    full mode's; ``obs_sink`` sees every fleet-aggregate record, chunked or
    not."""
    full = _port_case("churn", observe=OCFG)
    seen = []
    stream_cfg = obs.ObserveConfig(window_turns=8, detect=obs.DetectConfig(warmup_windows=4),
                                   emit_responses=False)
    s = tenv.run_scenario(tenv.make("churn"), use_scan=True, sequential_pool=True,
                          arrival_batch=K, seed=0, n_frontends=4, device="cpu",
                          observe=stream_cfg, obs_sink=seen.extend, chunk_turns=37)
    assert s["responses"].size == 0 and s["mu_trace"].shape[0] == 0
    ignore = ("partial",)
    for a, b in zip(s["info"]["windows"], full["info"]["windows"]):
        assert {k: v for k, v in a.items() if k not in ignore} == \
            {k: v for k, v in b.items() if k not in ignore}
    assert len(s["info"]["windows"]) == len(full["info"]["windows"]) == len(seen)
    assert s["info"]["windows_frontends"] == full["info"]["windows_frontends"]


# ---------------------------------------------------------------------------
# (iii) what the fleet refuses
# ---------------------------------------------------------------------------


def test_fleet_refusals():
    """As the reference: the fleet needs the scan, a FleetRouter, no
    recovery and S | k; ``mesh=`` takes a ``fleet.sync.FrontendMesh``
    (tests/test_torch_fleet_mesh.py runs it); no card, no default device."""
    scn = tenv.make("null", horizon=20.0)
    kw = dict(arrival_batch=K, n_frontends=2, device="cpu")
    with pytest.raises(ValueError, match="use_scan=True"):
        tenv.run_scenario(scn, **kw)
    with pytest.raises(ValueError, match="FleetRouter"):
        tenv.run_scenario(scn, use_scan=True, router=tr.RosellaRouter(
            5, mu_bar=6.5, device="cpu"), **kw)
    with pytest.raises(ValueError, match="single-frontend"):
        tenv.run_scenario(scn, use_scan=True, recovery=trcv.INERT_RECOVERY, **kw)
    with pytest.raises(ValueError, match="divide evenly"):
        tenv.run_scenario(scn, use_scan=True, **dict(kw, n_frontends=3))
    r, p = _fleet(3)
    with pytest.raises(ValueError, match="divide evenly"):
        tsl.run_fleet_simulation_scan(r, p, arrival_rate=3.0, horizon=20.0, seed=0,
                                      arrival_batch=8)
    r, p = _fleet(2)
    with pytest.raises(TypeError, match="FrontendMesh"):
        tsl.run_fleet_simulation_scan(r, p, mesh=object(), **KW)
    resp, mu, info = tsl.run_fleet_simulation_scan(r, p, arrival_rate=3.0, horizon=0.0,
                                                   seed=0, arrival_batch=4)
    assert len(resp) == 0 and mu.shape == (0, 4) and info["turns"] == 0
    out = tenv.run_scenario(scn, use_scan=True, **kw)
    assert isinstance(out["router"], tr.FleetRouter) and np.isfinite(out["responses"]).all()


def test_fleet_scenario_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenv.run_scenario(tenv.make("null", horizon=20.0), use_scan=True, n_frontends=2)
