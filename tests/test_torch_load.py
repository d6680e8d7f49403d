"""The port's streaming load harness, its numpy side (``repro_torch.load``),
on the CPU at the reference's sizes (the registry's cluster, n = 5, batches
of 8).

It mirrors the numpy cases of tests/test_load.py on the port and holds them
to the reference (``repro.load``, ``repro.env``; imported by the ``ref``
fixture only, as ``repro.load`` imports the reference scan loop):

  * ``ScenarioStream``: the concatenation of its chunks equals the port's
    ``compile_serving`` bit for bit, whatever ``chunk_turns``; and every
    chunk equals the reference's chunk, array for array, in every arrival
    mode (homogeneous, thinning, trace replay with its dropped tail, the
    two generated streams), across membership and fault events;
  * ``AzureLikeTrace`` / ``GoogleLikeTrace``: the compiled rates, the
    thinned arrival blocks and the cost draws equal the reference's for a
    seed, and are rate- and cost-calibrated;
  * ``TraceArrivals.from_csv``: the five cases, arrays equal to the
    reference's and its refusals worded as its own;
  * ``auto_chunk_turns``: the reference's pins, and equal to its function;
  * ``calibration_report``: equal to the reference's on the same records;
  * the refusals of ``run_stream_scan`` and ``compile_serving``.

Every comparison here is exact: these are the same numpy draws and the same
integer and float operations in the same order.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread a test worker)
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch import env as tenv
from repro_torch import obs
from repro_torch.core import metrics as M
from repro_torch.env import processes as prc
from repro_torch.env.scenario import Scenario
from repro_torch.load import (
    AzureLikeTrace,
    GoogleLikeTrace,
    ScenarioStream,
    run_stream_scan,
    stream_arrivals,
)
from repro_torch.serving import router as rt
from repro_torch.serving import scanloop
from test_torch_load_scan import _router_pool

CHUNK_FIELDS = ("times", "costs", "speeds", "active", "rejoin", "burst", "shift_times",
                "kill_at", "stall_at", "stall_dur")
MINI_AZURE = dict(period=120.0, depth=0.3, dwell=(30.0, 8.0), cost_sigma=1.0)


@pytest.fixture(scope="module")
def ref():
    """The reference's load harness, environment and metrics."""
    from repro import env as jenv
    from repro import load as jload
    from repro import obs as jobs
    from repro.core import metrics as jM
    from repro.env import processes as jprc
    from repro.env.scenario import Scenario as JScenario
    from repro.serving import scanloop as jsl

    return SimpleNamespace(env=jenv, load=jload, obs=jobs, metrics=jM, prc=jprc,
                           Scenario=JScenario, scanloop=jsl)


def _mini(mod_env, Scn, arrivals, name="mini_stream", base=None, **kw):
    """A generated-stream scenario: the registry's ``base`` scenario (or a
    four-worker cluster) with ``arrivals`` in place of its own."""
    if base is not None:
        return dataclasses.replace(mod_env.make(base, **kw), arrivals=arrivals)
    return Scn(name=name, speeds=(2.0, 1.0, 1.0, 0.5), rate=4.0, horizon=300.0,
               arrivals=arrivals)


#: (registry name or generated stream, its options): every arrival mode,
#: membership and fault events, in both packages
STREAM_CASES = {
    "null": ("null", dict(horizon=120.0)),
    "churn": ("churn", dict(horizon=360.0)),
    "crash_storm": ("crash_storm", dict(horizon=240.0)),
    "flash_crowd": ("flash_crowd", {}),
    "trace_replay": ("trace_replay", {}),
    "azure": ("azure", {}),
    "google": ("google", {}),
    "azure_churn": ("azure", dict(base="churn_heavy", horizon=240.0)),
    "azure_faults": ("azure", dict(base="crash_storm", horizon=240.0)),
}


def _scenario(case, mod_env, Scn, load_mod):
    name, kw = STREAM_CASES[case]
    if name == "azure":
        return _mini(mod_env, Scn, load_mod.AzureLikeTrace(**MINI_AZURE), **kw)
    if name == "google":
        return _mini(mod_env, Scn, load_mod.GoogleLikeTrace(spike_rate=1 / 60.0), **kw)
    return mod_env.make(name, **kw)


def _port_scenario(case):
    import repro_torch.load as tload

    return _scenario(case, tenv, Scenario, tload)


def _same_chunk(a, b, where) -> None:
    for f in CHUNK_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), (where, f)
        if va is not None:
            assert np.asarray(va).dtype == np.asarray(vb).dtype, (where, f)
            np.testing.assert_array_equal(va, vb, err_msg=f"{where} {f}")
    assert a.trace_dropped == b.trace_dropped, where


# ---------------------------------------------------------------------------
# ScenarioStream: chunks = compile_serving, chunks = the reference's chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["churn", "crash_storm", "flash_crowd", "trace_replay"])
def test_stream_chunks_concat_equals_compile_serving(case):
    """The CONCATENATION of ScenarioStream chunks is bit-identical to the
    port's monolithic ``compile_serving`` arrays — same RandomState call
    order, same event→turn assignment — independent of chunk_turns (the
    burst array, padded to the realized width there, equal on that width)."""
    scn = _port_scenario(case)
    wl = scn.compile_serving(seed=0, arrival_batch=8)
    for step in (7, wl.turns):
        stream = ScenarioStream(scn, seed=0, arrival_batch=8)
        parts = list(stream.chunks(step))
        assert [p.turns for p in parts[:-1]] == [step] * (len(parts) - 1)
        for f in ("times", "costs", "speeds", "active", "rejoin", "kill_at", "stall_at",
                  "stall_dur"):
            if getattr(wl, f) is None:
                assert all(getattr(p, f) is None for p in parts), f
                continue
            np.testing.assert_array_equal(np.concatenate([getattr(p, f) for p in parts]),
                                          getattr(wl, f), err_msg=f)
        if wl.burst is not None:
            burst = np.concatenate([p.burst for p in parts])
            assert burst.shape[1] == stream.burst_cap == scn.n * scn.probe_burst
            np.testing.assert_array_equal(burst[:, :wl.burst.shape[1]], wl.burst)
            assert (burst[:, wl.burst.shape[1]:] == -1).all()
        np.testing.assert_array_equal(stream.shift_times, wl.shift_times)
        assert stream.trace_dropped == wl.trace_dropped
        assert stream.turns_emitted == wl.turns


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_chunks_equal_the_reference(ref, case):
    """Every chunk of the port's ScenarioStream equals the reference's, array
    for array (dtype included), at a chunk length that cuts across the
    scenario's events and in one chunk; the stream's burst width, shift
    instants, dropped tail and turn count too."""
    for step in (11, 10 ** 6):
        scn_t = _port_scenario(case)
        scn_j = _scenario(case, ref.env, ref.Scenario, ref.load)
        st_t = ScenarioStream(scn_t, seed=1, arrival_batch=8)
        st_j = ref.load.ScenarioStream(scn_j, seed=1, arrival_batch=8)
        parts_t, parts_j = list(st_t.chunks(step)), list(st_j.chunks(step))
        assert len(parts_t) == len(parts_j) > (1 if step == 11 else 0)
        for i, (a, b) in enumerate(zip(parts_t, parts_j)):
            _same_chunk(a, b, f"{case} step {step} chunk {i}")
        assert (st_t.burst_cap, st_t.churn, st_t.faulty, st_t.turns_emitted,
                st_t.trace_dropped) == (st_j.burst_cap, st_j.churn, st_j.faulty,
                                        st_j.turns_emitted, st_j.trace_dropped)
    if STREAM_CASES[case][0] in ("azure", "google"):
        assert st_t._mode == "stream" and st_t.turns_emitted > 50


def test_generated_stream_draws_depend_on_the_chunk_length(ref):
    """A generated stream draws a chunk's costs from the same RandomState as
    its arrival blocks, after the blocks that chunk needed: so, as in the
    reference, the trace depends on ``chunk_turns`` once a chunk boundary
    falls before a later block is pulled (a chunked run is held against the
    monolithic run over the SAME chunks, concatenated). Pinned on the load
    cell's shape: 64 workers at base rate 40, batches of 128, 2,060 s."""
    import repro_torch.load as tload

    def chunks(mod, Scn, step):
        scn = Scn(name="azure_like_load", speeds=tuple(np.tile(
            [2.0, 2.0, 1.0, 1.0, 0.5, 1.5, 1.0, 0.5], 8)), rate=40.0, horizon=2060.0,
            arrivals=mod.AzureLikeTrace(period=3600.0, depth=0.4, burst_factor=3.0,
                                        dwell=(120.0, 15.0), cost_sigma=1.2))
        return list(mod.ScenarioStream(scn, seed=0, arrival_batch=128).chunks(step))

    by_step = {}
    for step in (512, 10 ** 6):
        got, want = chunks(tload, Scenario, step), chunks(ref.load, ref.Scenario, step)
        for i, (a, b) in enumerate(zip(got, want)):
            _same_chunk(a, b, f"step {step} chunk {i}")
        by_step[step] = np.concatenate([c.times for c in got])
    assert by_step[512].shape != by_step[10 ** 6].shape or not np.array_equal(
        by_step[512], by_step[10 ** 6])


# ---------------------------------------------------------------------------
# the synthesized trace generators
# ---------------------------------------------------------------------------


def _rate_integral(rate: prc.PiecewiseRate, horizon: float) -> float:
    bp = np.append(np.asarray(rate.bp, float), horizon)
    val = np.asarray(rate.val, float)
    widths = np.clip(np.diff(bp), 0.0, None)[: len(val)]
    return float((val * widths).sum())


GENERATORS = {
    "azure": lambda mod: mod.AzureLikeTrace(period=600.0, depth=0.3, dwell=(60.0, 10.0)),
    "google": lambda mod: mod.GoogleLikeTrace(spike_rate=1 / 120.0),
}


@pytest.mark.parametrize("which", list(GENERATORS))
def test_generators_equal_the_reference(ref, which):
    """For a seed, the compiled piecewise rate, the thinned arrival blocks
    and the cost draws equal the reference's bit for bit."""
    import repro_torch.load as tload

    tr_t, tr_j = GENERATORS[which](tload), GENERATORS[which](ref.load)
    rng_t, rng_j = np.random.RandomState(3), np.random.RandomState(3)
    rate_t = tr_t.compile_rate(5.0, 800.0, rng_t)
    rate_j = tr_j.compile_rate(5.0, 800.0, rng_j)
    np.testing.assert_array_equal(rate_t.bp, rate_j.bp)
    np.testing.assert_array_equal(rate_t.val, rate_j.val)
    blocks_t = list(stream_arrivals(rate_t, 800.0, rng_t, block=512))
    blocks_j = list(ref.load.stream_arrivals(rate_j, 800.0, rng_j, block=512))
    assert len(blocks_t) == len(blocks_j) > 2
    for a, b in zip(blocks_t, blocks_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tr_t.draw_costs(rng_t, 5000), tr_j.draw_costs(rng_j, 5000))


@pytest.mark.parametrize("which", list(GENERATORS))
def test_generator_rate_calibration(which):
    """Realized arrival counts match the compiled rate's integral (exact
    thinning ⇒ Poisson with that mean; 5σ tolerance)."""
    import repro_torch.load as tload

    tr = GENERATORS[which](tload)
    rng = np.random.RandomState(0)
    rate = tr.compile_rate(5.0, 800.0, rng)
    times = np.concatenate(list(stream_arrivals(rate, 800.0, rng)))
    mean = _rate_integral(rate, 800.0)
    assert abs(times.size - mean) < 5.0 * math.sqrt(mean)
    assert np.all(np.diff(times) > 0) and times[-1] < 800.0


@pytest.mark.parametrize("tr", [AzureLikeTrace(), GoogleLikeTrace()])
def test_generator_costs_mean_one(tr):
    """Durations are normalized to mean 1 so λ/μ̄ utilization math holds."""
    c = tr.draw_costs(np.random.RandomState(1), 200_000)
    assert c.min() > 0
    assert abs(c.mean() - 1.0) < 0.05


# ---------------------------------------------------------------------------
# TraceArrivals.from_csv: chunked reads, loud validation, the reference's
# ---------------------------------------------------------------------------


def _both_refuse(ref, path, match, **kw) -> None:
    with pytest.raises(ValueError, match=match) as e_t:
        prc.TraceArrivals.from_csv(str(path), **kw)
    with pytest.raises(ValueError) as e_j:
        ref.prc.TraceArrivals.from_csv(str(path), **kw)
    assert str(e_t.value) == str(e_j.value)


def test_from_csv_malformed_names_row(ref, tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("0.5,1.0\n0.75,oops\n1.0,1.0\n")
    _both_refuse(ref, p, "malformed CSV near row 0")


def test_from_csv_non_monotone_names_row(ref, tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("0.5,1.0\n0.75,1.0\n0.6,1.0\n0.9,1.0\n")
    _both_refuse(ref, p, "non-monotone timestamp at row 2")


def test_from_csv_non_monotone_across_chunk_boundary(ref, tmp_path):
    """A violation whose two rows land in DIFFERENT read chunks must still
    be caught."""
    p = tmp_path / "bad.csv"
    t = np.arange(10, dtype=float)
    t[4] = 2.5  # row 4 < row 3, with chunk_rows=4 splitting them
    p.write_text("".join(f"{x:.3f}\n" for x in t))
    _both_refuse(ref, p, "non-monotone timestamp at row 4", chunk_rows=4)


def test_from_csv_streams_million_rows(ref, tmp_path):
    """A 1M-row trace parses in bounded chunks (forced small chunk_rows ⇒
    many reads) with values intact end to end, equal to the reference's."""
    n = 1_000_000
    t = np.round(np.cumsum(np.full(n, 0.001)), 6)
    p = tmp_path / "big.csv"
    with open(p, "w") as f:
        f.write("\n".join(f"{x:.6f}" for x in t) + "\n")
    tr = prc.TraceArrivals.from_csv(str(p), chunk_rows=131_072)
    times = np.asarray(tr.times)
    assert times.shape == (n,)
    assert times[0] == pytest.approx(0.001)
    assert times[-1] == pytest.approx(1000.0)
    assert tr.costs is None
    assert np.all(np.diff(times) >= 0)
    np.testing.assert_array_equal(
        times, np.asarray(ref.prc.TraceArrivals.from_csv(str(p), chunk_rows=131_072).times))


def test_from_csv_costs_roundtrip(ref, tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("0.5,2.0\n1.5,0.5\n2.0,1.0\n")
    tr = prc.TraceArrivals.from_csv(str(p))
    np.testing.assert_allclose(tr.times, [0.5, 1.5, 2.0])
    np.testing.assert_allclose(tr.costs, [2.0, 0.5, 1.0])
    tj = ref.prc.TraceArrivals.from_csv(str(p))
    np.testing.assert_array_equal(tr.times, tj.times)
    np.testing.assert_array_equal(tr.costs, tj.costs)


# ---------------------------------------------------------------------------
# auto chunk sizing
# ---------------------------------------------------------------------------


def test_auto_chunk_turns_pins(ref):
    A = scanloop.auto_chunk_turns
    # small workloads resolve to ONE chunk
    assert A(100, 8, 5) == 100
    assert A(0, 8, 5) == 1
    # 64 MiB default budget: plain rows cost 8·(2k+n) bytes
    assert A(1_000_000, 128, 64) == (64 << 20) // (8 * (2 * 128 + 64))
    # membership (+2n+4·burst_cap) and fault (+24n) columns shrink it
    assert A(1_000_000, 128, 64, churn=True, burst_cap=256,
             faulty=True) == (64 << 20) // (2560 + 128 + 1024 + 1536)
    # explicit byte hint
    assert A(10 ** 6, 128, 64, max_bytes=1 << 20) == (1 << 20) // 2560
    # the pend_cap floor: never chunk finer than the in-flight window
    assert A(10 ** 6, 128, 64, pend_cap=65536, max_bytes=0) == 512
    assert A(10 ** 6, 8, 5, max_bytes=0) == 128  # PEND_CAP // 8
    # and equal to the reference's sizing over a grid
    J = ref.scanloop.auto_chunk_turns
    for T in (0, 1, 77, 10 ** 6):
        for k, n in ((8, 5), (128, 64), (2048, 2048)):
            for churn, bc, faulty in ((False, 0, False), (True, 4 * n, False),
                                      (True, 4 * n, True)):
                for pc, mb in ((1024, None), (8192, 1 << 20), (65536, 0)):
                    kw = dict(churn=churn, burst_cap=bc, faulty=faulty, pend_cap=pc,
                              max_bytes=mb)
                    assert A(T, k, n, **kw) == J(T, k, n, **kw), (T, k, n, kw)


# ---------------------------------------------------------------------------
# calibration_report against the reference's
# ---------------------------------------------------------------------------


def _records(rng, n_win: int, cfg, lam, hist_scale: int = 40) -> list:
    recs, t = [], 0.0
    for w in range(n_win):
        t += float(rng.uniform(5.0, 9.0))
        hist = rng.poisson(hist_scale * rng.random(cfg.hist_bins)).astype(np.int64)
        recs.append(dict(window=w, hist=hist, arrivals=int(rng.integers(50, 90)),
                         n_resp=int(hist.sum()), t_end=t, lam_calibration=lam(w)))
    return recs


def _same_report(a, b) -> None:
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_report(a[k], b[k])
        elif isinstance(a[k], float) and math.isnan(a[k]):
            assert isinstance(b[k], float) and math.isnan(b[k]), k
        else:
            assert a[k] == b[k], (k, a[k], b[k])


@pytest.mark.parametrize("shape", ["settles", "never_settles", "always_within", "nan_windows",
                                   "empty"])
def test_calibration_report_equals_the_reference(ref, shape):
    """Whole-horizon p50/p99/p999, the histogram mean and the λ̂-calibration
    summary (mean, min, max, final, worst error, settle time) equal the
    reference's on the same records, key for key."""
    cfg = obs.ObserveConfig(window_turns=8)
    jc = ref.obs.ObserveConfig(window_turns=8)
    rng = np.random.default_rng(["settles", "never_settles", "always_within", "nan_windows",
                                 "empty"].index(shape))
    lam = {"settles": lambda w: 1.6 - 0.06 * w if w < 10 else 1.0 + 0.01 * (w % 3),
           "never_settles": lambda w: 1.0 if w < 15 else 1.4,
           "always_within": lambda w: 1.0 + 0.02 * math.sin(w),
           "nan_windows": lambda w: float("nan") if w % 4 == 0 else 0.95 + 0.01 * w,
           "empty": lambda w: 1.0}[shape]
    recs = [] if shape == "empty" else _records(rng, 20, cfg, lam)
    for warm in (0, 2):
        got = M.calibration_report(cfg, recs, warmup_windows=warm)
        want = ref.metrics.calibration_report(jc, recs, warmup_windows=warm)
        _same_report(got, want)
    if shape == "settles":
        assert got["lam_calibration"]["settle_t"] == recs[8]["t_end"]  # the last bad window
    if shape == "never_settles":
        assert math.isnan(got["lam_calibration"]["settle_t"])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_compile_serving_refuses_stream_arrivals():
    scn = Scenario(name="s", speeds=(1.0, 1.0), rate=3.0, horizon=50.0,
                   arrivals=AzureLikeTrace())
    with pytest.raises(ValueError, match="repro_torch.load.ScenarioStream"):
        scn.compile_serving(seed=0, arrival_batch=4)


def test_run_stream_scan_requires_task_cap_for_faults():
    scn = tenv.make("crash_storm", horizon=120.0)
    router, pool = _router_pool(rt, scn)
    with pytest.raises(ValueError, match="task_cap"):
        run_stream_scan(router, pool, ScenarioStream(scn, seed=0, arrival_batch=8),
                        chunk_turns=8)


def test_run_stream_scan_requires_chunk_turns_for_streams():
    scn = tenv.make("null")
    router, pool = _router_pool(rt, scn)
    with pytest.raises(ValueError, match="chunk_turns"):
        run_stream_scan(router, pool, ScenarioStream(scn, seed=0, arrival_batch=8))


def _null_chunks(horizon=40.0):
    scn = tenv.make("null", horizon=horizon)
    return scn, scn.compile_serving(seed=0, arrival_batch=8)


def test_run_stream_scan_refuses_columns_that_change_across_chunks():
    """The first chunk fixes the captured turn: membership or fault columns
    that appear (or a burst width that changes) later raise, naming it."""
    scn, wl = _null_chunks()
    T, n = wl.turns, wl.speeds.shape[1]
    a, b = wl.iter_chunks(T // 2)
    churned = dataclasses.replace(b, active=np.ones((b.turns, n), bool),
                                  rejoin=np.zeros((b.turns, n), bool),
                                  burst=np.full((b.turns, 4), -1, np.int32))
    with pytest.raises(ValueError, match="no membership columns"):
        run_stream_scan(*_router_pool(rt, scn), [a, churned], fake_cost=0.25)
    faulty = dataclasses.replace(b, kill_at=np.full((b.turns, n), np.inf))
    with pytest.raises(ValueError, match="no fault columns"):
        run_stream_scan(*_router_pool(rt, scn), [a, faulty], fake_cost=0.25)
    a2 = dataclasses.replace(a, active=np.ones((a.turns, n), bool),
                             rejoin=np.zeros((a.turns, n), bool),
                             burst=np.full((a.turns, 4), -1, np.int32))
    wider = dataclasses.replace(churned, burst=np.full((b.turns, 8), -1, np.int32))
    with pytest.raises(ValueError, match="width-4 burst"):
        run_stream_scan(*_router_pool(rt, scn), [a2, wider], fake_cost=0.25)


def test_run_stream_scan_refuses_a_chunk_longer_than_the_first():
    """An iterable's first chunk sets the rows the turn holds: a longer
    later chunk raises and says so."""
    scn, wl = _null_chunks()
    parts = list(wl.iter_chunks(5))
    longer = [parts[0], dataclasses.replace(
        wl, times=wl.times[5:12], costs=wl.costs[5:12], speeds=wl.speeds[5:12])]
    with pytest.raises(ValueError, match="more than the 5 rows"):
        run_stream_scan(*_router_pool(rt, scn), longer, fake_cost=0.25)
