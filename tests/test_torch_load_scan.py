"""The port's streaming load harness through the one-program loop
(``repro_torch.load.run_stream_scan`` over ``scanloop._drive_scan``), on the
CPU at the reference's sizes (the registry's cluster, n = 5, batches of 8).

It mirrors the scan cases of tests/test_load.py on the port:

  * chunked = monolithic, bit for bit, against the port's own
    ``run_workload_scan`` on the concatenated arrays (the burst padded to the
    stream's fixed width): responses, μ̂ trace, window records, the fault
    ledger and the final router and pool state; with a chunk boundary on a
    membership event (churn), on a capacity event (cotenant_shock, through
    ``iter_chunks``), across crash_storm's faults (recovery inert and
    armed), and with chunk lengths coprime with the window length, where
    the window stream stays gap-free;
  * a generated Azure-shaped stream end to end in stream-only telemetry,
    with per-chunk timing records, ``calibration_report`` and the
    sustained-throughput reduction of ``chip_smoke.py``.

Against the reference's ``run_stream_scan`` (under the module fixture's
alias of ``jax.experimental.enable_x64``, as tests/test_torch_scanloop.py),
the parity class of tests/test_torch_scanloop.py:
  * responses equal on every turn (NaN = lost on the faulty turn), and the
    ledger equal;
  * μ̂ exact for at least ``EXACT_MU_TURNS`` turns (the turn at which the
    learners' float sums first part, measured and pinned per probe stream),
    then within ``MU_ULPS``;
  * window records within tests/test_torch_obs.py's bars.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread a test worker)
import dataclasses
import math

import numpy as np
import pytest

from repro_torch import env as tenv
from repro_torch import obs
from repro_torch.core import metrics as M
from repro_torch.env.scenario import Scenario
from repro_torch.load import AzureLikeTrace, ScenarioStream, run_stream_scan
from repro_torch.serving import recovery as rcv
from repro_torch.serving import router as tr
from repro_torch.serving import scanloop
from test_torch_obs import assert_records_equal, assert_windows_within_bars, edge_count

OCFG = obs.ObserveConfig(window_turns=8)
MU_ULPS = 8  # test_torch_scanloop: refresh_estimates' float sum (measured ≤ 6 here)
#: the turn at which the port's μ̂ first parts from the reference's in its
#: last bits, per probe stream (measured)
EXACT_MU_TURNS = {True: 7, False: 5}
AZURE_EXACT_MU_TURNS = 7  # the generated stream, alias (the CDF stream parts at turn 4)
MINI_AZURE = dict(name="mini_azure", speeds=(2.0, 1.0, 1.0, 0.5), rate=4.0, horizon=300.0)
AZURE_SHAPE = dict(period=120.0, depth=0.3, dwell=(30.0, 8.0), cost_sigma=1.0)
RECOVERY = dict(timeout_mult=8.0, retry_budget=2, retry_cap=4, spec_cap=2, spec_ratio=3.0)


def _router_pool(mod, scn, use_alias=True, seed=0):
    speeds = np.asarray(scn.speeds, float)
    kw = {"device": "cpu"} if mod is tr else {}
    router = mod.RosellaRouter(scn.n, mu_bar=float(speeds.sum()), policy="ppot_sq2", seed=seed,
                               async_mu=False, use_alias=use_alias, c_window=10.0, **kw)
    return router, mod.SimulatedPool(speeds)


def _pad_burst(burst, turns, width):
    """Pad a monolithic burst array to the stream's FIXED width (-1 slots
    are inert in the turn, so this changes the captured shape only)."""
    out = np.full((turns, width), -1, np.int32)
    if burst is not None:
        out[:, : burst.shape[1]] = burst
    return out


def _mono(scn, wl, *, use_alias=True, burst_pad=None, **kw):
    router, pool = _router_pool(tr, scn, use_alias)
    burst = wl.burst if burst_pad is None else _pad_burst(wl.burst, wl.turns, burst_pad)
    out = scanloop.run_workload_scan(
        router, pool, wl.times, wl.costs, wl.speeds, active_np=wl.active,
        rejoin_np=wl.rejoin, burst_np=burst, fake_cost=scn.request_cost * 0.25,
        kill_np=wl.kill_at, stall_np=wl.stall_at, stall_dur_np=wl.stall_dur, **kw)
    return out, router, pool


def _same_final_state(ra, pa, rb, pb) -> None:
    """The router and the pool as two runs left them, equal bit for bit."""
    np.testing.assert_array_equal(ra.q_view.cpu().numpy(), rb.q_view.cpu().numpy())
    for f in ("samples", "stamps", "widx", "count", "epoch_start", "mu_hat"):
        np.testing.assert_array_equal(getattr(ra.learner, f).cpu().numpy(),
                                      getattr(rb.learner, f).cpu().numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(ra.key), np.asarray(rb.key))
    assert ra.last_fake_time == rb.last_fake_time
    assert (float(ra.arr.last_time), float(ra.arr.mean_gap), int(ra.arr.count)) == (
        float(rb.arr.last_time), float(rb.arr.mean_gap), int(rb.arr.count))
    assert (ra.active is None) == (rb.active is None)
    if ra.active is not None:
        np.testing.assert_array_equal(ra.active.cpu().numpy(), rb.active.cpu().numpy())
    np.testing.assert_array_equal(pa.free_at, pb.free_at)


def _same_runs(a, b) -> None:
    """Two runs of the port, equal in everything they return."""
    (ra, ma, ia), (rb, mb, ib) = a, b
    np.testing.assert_array_equal(ra, rb)  # NaN = NaN for lost tasks
    np.testing.assert_array_equal(ma, mb)
    assert ia["turns"] == ib["turns"]
    for key in ("flush_overflow", "pend_overflow", "longest_chain", "ledger"):
        assert ia.get(key) == ib.get(key), key
    assert ("windows" in ia) == ("windows" in ib)
    if "windows" in ia:
        assert_records_equal(ia["windows"], ib["windows"])


def _ulps(a, b) -> np.ndarray:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib).reshape(len(ia), -1).max(1)


def _matches_reference(port, ref, exact_mu_turns: int, n_edge: int | None = None) -> None:
    """The parity class against the reference's scan (module docstring)."""
    (rp, mp, ip), (rr, mr, ir) = port, ref
    np.testing.assert_array_equal(rp, np.asarray(rr))
    assert mp.shape == np.asarray(mr).shape
    d = _ulps(mp, mr)
    first = int(np.nonzero(d)[0][0]) if d.any() else len(d)
    assert first >= exact_mu_turns, (first, exact_mu_turns)
    assert int(d.max()) <= MU_ULPS
    assert ip["turns"] == ir["turns"]
    assert (ip["flush_overflow"], ip["pend_overflow"]) == (ir["flush_overflow"],
                                                           ir["pend_overflow"])
    assert ip.get("ledger") == ir.get("ledger")
    if n_edge is not None:
        assert_windows_within_bars(ip["windows"], ir["windows"], OCFG, n_edge)


def _churn(mod_env):
    scn = mod_env.make("churn", horizon=360.0)
    wl = scn.compile_serving(seed=0, arrival_batch=8)
    ev = int(np.nonzero(wl.rejoin.any(axis=1))[0][0])
    assert ev > 0, "scenario must have a rejoin inside the horizon"
    return scn, wl, ev


def _cotenant(mod_env):
    scn = mod_env.make("cotenant_shock")
    wl = scn.compile_serving(seed=0, arrival_batch=8)
    ev = int(np.searchsorted(wl.times[:, -1], 120.0, side="left"))
    assert 0 < ev < wl.turns
    return scn, wl, ev


def _coprime_window(ev: int) -> int:
    return next(w for w in (7, 9, 11, 13, 5) if math.gcd(ev, w) == 1)


# ---------------------------------------------------------------------------
# the stream runs of both packages, once per module
# ---------------------------------------------------------------------------


def _stream_run(mods, case: str, use_alias: bool):
    """One streamed run of ``case`` in the package ``mods`` (env, router
    module, ScenarioStream, run_stream_scan, ObserveConfig, Scenario,
    AzureLikeTrace)."""
    menv, rmod, Stream, run, Observe, Scn, Azure = mods
    if case == "churn":
        scn, _, ev = _churn(menv)
        return run(*_router_pool(rmod, scn, use_alias), Stream(scn, seed=0, arrival_batch=8),
                   chunk_turns=ev, fake_cost=scn.request_cost * 0.25,
                   observe=Observe(window_turns=8), timing=True)
    if case == "crash_storm":
        scn = menv.make("crash_storm", horizon=240.0)
        wl = scn.compile_serving(seed=0, arrival_batch=8)
        return run(*_router_pool(rmod, scn, use_alias), Stream(scn, seed=0, arrival_batch=8),
                   chunk_turns=13, fake_cost=scn.request_cost * 0.25, task_cap=wl.turns * 8)
    if case == "cotenant":
        scn, wl, ev = _cotenant(menv)
        return run(*_router_pool(rmod, scn, use_alias), wl.iter_chunks(ev),
                   fake_cost=scn.request_cost * 0.25)
    if case == "azure":
        scn = Scn(arrivals=Azure(**AZURE_SHAPE), **MINI_AZURE)
        return run(*_router_pool(rmod, scn, use_alias), Stream(scn, seed=0, arrival_batch=8),
                   chunk_turns=16, fake_cost=scn.request_cost * 0.25,
                   observe=Observe(window_turns=8))
    raise ValueError(case)


PORT = (tenv, tr, ScenarioStream, run_stream_scan, obs.ObserveConfig, Scenario, AzureLikeTrace)


@pytest.fixture(scope="module")
def port_runs():
    runs = {}

    def get(case, use_alias=True):
        if (case, use_alias) not in runs:
            runs[(case, use_alias)] = _stream_run(PORT, case, use_alias)
        return runs[(case, use_alias)]
    return get


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's streamed runs on jax 0.9, which has
    ``jax.enable_x64(True)`` where the reference imports
    ``jax.experimental.enable_x64``; one run per case for the module."""
    import jax
    import jax.experimental

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                   raising=False)
        from repro import env as jenv
        from repro import load as jload
        from repro import obs as jobs
        from repro.env.scenario import Scenario as JScenario
        from repro.serving import router as jr

        mods = (jenv, jr, jload.ScenarioStream, jload.run_stream_scan, jobs.ObserveConfig,
                JScenario, jload.AzureLikeTrace)
        runs = {}

        def get(case, use_alias=True):
            if (case, use_alias) not in runs:
                runs[(case, use_alias)] = _stream_run(mods, case, use_alias)
            return runs[(case, use_alias)]
        yield get


# ---------------------------------------------------------------------------
# chunked streaming == monolithic (bit parity), and == the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_alias", [True, False])
def test_stream_parity_churn_boundary_on_membership_event(port_runs, use_alias):
    """ScenarioStream chunks with a chunk boundary EXACTLY on the first
    rejoin turn: responses, μ̂ trace, telemetry windows and the final router
    and pool state bit-equal to the monolithic program (burst padded to the
    stream's fixed width); one timing record a chunk."""
    scn, wl, ev = _churn(tenv)
    router, pool = _router_pool(tr, scn, use_alias)
    stream = ScenarioStream(scn, seed=0, arrival_batch=8)
    got = run_stream_scan(router, pool, stream, chunk_turns=ev,
                          fake_cost=scn.request_cost * 0.25, observe=OCFG, timing=True)
    want, router0, pool0 = _mono(scn, wl, use_alias=use_alias, burst_pad=stream.burst_cap,
                                 observe=OCFG, pend_cap=scanloop.PEND_CAP)
    _same_runs(got, want)
    _same_final_state(router, pool, router0, pool0)
    info = got[2]
    assert info["turns"] == wl.turns and info["trace_dropped"] == 0
    assert [c["turns"] for c in info["chunks"]] == [ev, wl.turns - ev]
    assert info["flush_overflow"] == 0 and info["pend_overflow"] == 0
    _same_runs(got, port_runs("churn", use_alias))


@pytest.mark.parametrize("use_alias", [True, False])
def test_stream_churn_matches_the_reference(port_runs, ref_runs, use_alias):
    """The churn stream against the reference's ``run_stream_scan`` at the
    module's parity class, windows within test_torch_obs's bars."""
    port = port_runs("churn", use_alias)
    _matches_reference(port, ref_runs("churn", use_alias), EXACT_MU_TURNS[use_alias],
                       n_edge=edge_count(port[0], OCFG))


@pytest.mark.parametrize("armed", [False, True])
def test_stream_parity_faulty_ledger(armed):
    """Fault streams (crash_storm): the task-indexed responses, μ̂ trace,
    ledger and final state survive chunk boundaries bit for bit, recovery
    inert or armed; the ledger conserves."""
    scn = tenv.make("crash_storm", horizon=240.0)
    wl = scn.compile_serving(seed=0, arrival_batch=8)
    rc = rcv.RecoveryConfig(**RECOVERY) if armed else None
    stream = ScenarioStream(scn, seed=0, arrival_batch=8)
    router, pool = _router_pool(tr, scn)
    got = run_stream_scan(router, pool, stream, chunk_turns=13, recovery=rc,
                          fake_cost=scn.request_cost * 0.25, task_cap=wl.turns * 8,
                          pend_cap=4096)
    want, router0, pool0 = _mono(scn, wl, burst_pad=stream.burst_cap, recovery=rc,
                                 pend_cap=4096)
    _same_runs(got, want)
    _same_final_state(router, pool, router0, pool0)
    led = got[2]["ledger"]
    assert led["conserved"] and M.check_conservation(led)[0]
    assert np.isnan(got[0]).sum() == led["lost_tasks"]
    if armed:
        assert led["n_retries"] > 0 and led["n_timeouts"] > 0
    else:
        assert led["lost_tasks"] > 0


@pytest.mark.parametrize("use_alias", [True, False])
def test_stream_faulty_matches_the_reference(port_runs, ref_runs, use_alias):
    """crash_storm in chunks of 13 against the reference's stream: responses
    (NaN = lost) and the ledger equal, μ̂ at the pinned class."""
    _matches_reference(port_runs("crash_storm", use_alias), ref_runs("crash_storm", use_alias),
                       EXACT_MU_TURNS[use_alias])


def test_iter_chunks_parity_boundary_on_capacity_event(port_runs, ref_runs):
    """Materialized-workload chunking (``ServingWorkload.iter_chunks``)
    with the boundary exactly on the co-tenant shock turn: equal to the
    monolithic program bit for bit, and to the reference's chunked run at
    the module's class."""
    scn, wl, ev = _cotenant(tenv)
    got = port_runs("cotenant")
    want, _, _ = _mono(scn, wl, pend_cap=scanloop.PEND_CAP)
    _same_runs(got, want)
    assert got[2]["turns"] == wl.turns
    _matches_reference(got, ref_runs("cotenant"), EXACT_MU_TURNS[True])


def test_empty_chunks_are_skipped():
    """Empty chunks anywhere in an iterable (first, middle, last) run as if
    they were not there."""
    scn, wl, ev = _cotenant(tenv)
    parts = list(wl.iter_chunks(ev))
    empty = dataclasses.replace(parts[0], times=wl.times[:0], costs=wl.costs[:0],
                                speeds=wl.speeds[:0])
    got = run_stream_scan(*_router_pool(tr, scn), [empty, parts[0], empty, *parts[1:], empty],
                          fake_cost=scn.request_cost * 0.25, timing=True)
    want, _, _ = _mono(scn, wl, pend_cap=scanloop.PEND_CAP)
    _same_runs(got, want)
    assert [c["chunk"] for c in got[2]["chunks"]] == list(range(len(parts)))


# ---------------------------------------------------------------------------
# chunk × window boundary invariants (telemetry continuity)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_alias", [True, False])
def test_windows_gap_free_with_coprime_chunking(use_alias):
    """chunk_turns coprime with window_turns AND a chunk boundary on a
    membership event: the window stream is float-identical to the
    monolithic run and gap-free (consecutive ids, abutting time ranges,
    turns summing to T, only the final record partial)."""
    scn, wl, ev = _churn(tenv)
    cfg = obs.ObserveConfig(window_turns=_coprime_window(ev))
    stream = ScenarioStream(scn, seed=0, arrival_batch=8)
    got = run_stream_scan(*_router_pool(tr, scn, use_alias), stream, chunk_turns=ev,
                          fake_cost=scn.request_cost * 0.25, observe=cfg)
    want, _, _ = _mono(scn, wl, use_alias=use_alias, burst_pad=stream.burst_cap,
                       observe=cfg, pend_cap=scanloop.PEND_CAP)
    _same_runs(got, want)
    w = got[2]["windows"]
    assert [r["window"] for r in w] == list(range(len(w)))
    assert all(not r["partial"] for r in w[:-1])
    assert sum(r["turns"] for r in w) == wl.turns
    for a, b in zip(w, w[1:]):
        assert b["t_start"] == a["t_end"]


# ---------------------------------------------------------------------------
# end-to-end stream-only run + whole-horizon reports
# ---------------------------------------------------------------------------


def test_stream_only_end_to_end_bounded(port_runs):
    """A generated-trace scenario runs end to end in stream-only telemetry
    mode: no per-request rows, gap-free windows equal to the run that emits
    its responses, per-chunk timing records, and the whole-horizon
    calibration and sustained reports compute."""
    import chip_smoke

    scn = Scenario(arrivals=AzureLikeTrace(**AZURE_SHAPE), **MINI_AZURE)
    router, pool = _router_pool(tr, scn)
    stream = ScenarioStream(scn, seed=0, arrival_batch=8)
    cfg = obs.ObserveConfig(window_turns=8, emit_responses=False)
    resp, mu, info = run_stream_scan(router, pool, stream, chunk_turns=16,
                                     fake_cost=scn.request_cost * 0.25, observe=cfg,
                                     timing=True)
    assert np.asarray(resp).size == 0 and mu.shape == (0, scn.n)  # stream-only
    assert info["turns"] > 32 and info["trace_dropped"] == stream.trace_dropped
    assert len(info["chunks"]) == math.ceil(info["turns"] / 16)
    for c in info["chunks"]:
        assert c["requests"] == c["turns"] * 8
        assert c["run_s"] > 0 and c["gen_s"] >= 0 and c["rss_mb"] > 0
    w = info["windows"]
    assert sum(r["turns"] for r in w) == info["turns"]
    assert_records_equal(w, port_runs("azure")[2]["windows"])

    rep = M.calibration_report(cfg, w, warmup_windows=1)
    assert rep["requests"] == info["turns"] * 8
    assert rep["completed"] > 0
    assert rep["p50"] > 0 and rep["p999"] >= rep["p99"] >= rep["p50"]
    assert 0.2 < rep["lam_calibration"]["mean"] < 5.0

    s = chip_smoke.sustained_series(info["chunks"], warmup=1)
    assert s["requests_total"] == info["turns"] * 8
    assert s["n_chunks"] == len(info["chunks"])
    assert len(s["decs_series"]) == s["n_chunks"]
    assert s["decs_sustained"] > 0
    assert s["rss_mb_peak"] >= max(c["rss_mb"] for c in info["chunks"][1:])


def test_stream_azure_matches_the_reference(port_runs, ref_runs):
    """The generated Azure-shaped stream (alias, windows of 8) against the
    reference's: responses equal, μ̂ at the pinned class, windows within
    the bars, and ``calibration_report`` on each package's records equal
    wherever their histograms are."""
    port, ref = port_runs("azure"), ref_runs("azure")
    _matches_reference(port, ref, AZURE_EXACT_MU_TURNS, n_edge=edge_count(port[0], OCFG))
    from repro.core import metrics as jM

    got = M.calibration_report(OCFG, port[2]["windows"], warmup_windows=2)
    want = jM.calibration_report(OCFG, ref[2]["windows"], warmup_windows=2)
    assert got.keys() == want.keys()
    if all(np.array_equal(a["hist"], b["hist"])
           for a, b in zip(port[2]["windows"], ref[2]["windows"])):
        for k in ("requests", "completed", "horizon_t", "p50", "p99", "p999", "mean_est"):
            assert got[k] == want[k], k
