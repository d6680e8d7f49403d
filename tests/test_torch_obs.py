"""The port's telemetry engine (``repro_torch.obs``) on the CPU, at the
reference's own sizes (the registry's cluster, n = 5, batches of 8).

It mirrors the single-frontend cases of tests/test_obs.py on the port:
windowed-quantile accuracy, telemetry-off bit-exactness on the host loops
and the one-program loop, host = scan window streams float for float,
crash_storm's windows against its ledger, chunked continuity, stream-only
mode with a ``JsonlSink``, the exporters and the decision trace. Against
the reference (``repro.obs``, ``repro.env``; imported by the ``ref``
fixtures only, so the helpers here import no jax and
tests/test_torch_cuda.py reuses them):

  * ``fold_turn``/``observe_turn``/``record_from_state`` on seeded random
    ``TurnObs`` against the reference's jitted host fold;
  * the window records of the port's host loop and scan against
    ``repro.env.run_workload``'s and the reference's scan (PPoT-SQ(2), both
    probe streams; the reference scan under the ``ref_scan`` alias of
    ``jax.experimental.enable_x64``, as tests/test_torch_env.py);
  * the exporters string-equal on the same records, and the numpy fleet and
    simulator helpers on synthetic stacked rows.

The bars against the reference (every other key equal, NaN = NaN):
  * ``hist``: its L1 distance at most twice the number of samples within
    ``EDGE_ULPS`` ulps of a bin edge in log space (torch's ``log`` and XLA's
    may part in the last bits; a sample that crosses moves one count to a
    neighbouring bin); the keys read from the histogram (p50, p99, p999,
    mean_est) equal wherever the histogram is;
  * ``q_sum`` (record ``q_mean``) within ``Q_ULPS``: the reference's compiled
    fold contracts ``q_sum + Σq · (1/n)`` into one fused multiply-add;
  * ``mu_err_sum`` (record ``mu_rel_err``) within ``MU_ERR_ULPS``: XLA sums the
    n shares left to right, torch in its own order (and after the turn at
    which the learners part, tests/test_torch_env.py, μ̂ itself differs);
  * the detector's float state (which reads those two) within
    ``DET_ATOL`` + ``DET_RTOL``·|x| (measured: 1.2e-7 at most); its alarm
    fields equal. The detector step itself, fed the same rows, is exact
    (tests/test_torch_detect.py).

Measured at these sizes: no sample within 2 ulps of an edge, ``q_sum``
at most 1 ulp apart, ``mu_err_sum`` at most 8.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread a test worker)
import json
import math

import numpy as np
import pytest
import torch

from repro_torch import env as tenv
from repro_torch import obs
from repro_torch.obs import windows as tw

OCFG = obs.ObserveConfig(window_turns=8)
EDGE_ULPS = 2  # torch's and XLA's log are each within an ulp or so of the true value
Q_ULPS = 2
MU_ERR_ULPS = 16
DET_RTOL, DET_ATOL = 1e-6, 1e-6
HIST_KEYS = ("hist", "p50", "p99", "p999", "mean_est")
DET_FLOATS = ("det_mean", "det_scale", "det_pos", "det_neg")


def _run(name, *, use_scan, horizon=160.0, seed=0, **kw):
    return tenv.run_scenario(tenv.make(name, horizon=horizon), use_scan=use_scan,
                             sequential_pool=True, arrival_batch=8, seed=seed, device="cpu",
                             **kw)


def assert_records_equal(wa, wb, ignore=()):
    """Equal in every key, NaN = NaN (the reference's helper)."""
    assert len(wa) == len(wb)
    for a, b in zip(wa, wb):
        assert set(a) - set(ignore) == set(b) - set(ignore)
        for k in set(a) - set(ignore):
            va, vb = a[k], b[k]
            if (isinstance(va, float) and isinstance(vb, float)
                    and math.isnan(va) and math.isnan(vb)):
                continue
            assert va == vb, (k, va, vb)


def edge_count(samples, cfg: obs.ObserveConfig, ulps: int = EDGE_ULPS) -> int:
    """How many of ``samples`` would change bin if ``log`` moved by up to
    ``ulps`` ulps: the bin computation of ``windows._hist_fold`` in numpy
    f32 with the log nudged both ways."""
    f32 = np.float32
    lo = f32(cfg.hist_lo)
    inv = f32(1.0 / math.log(tw.bin_ratio(cfg)))
    r = np.maximum(np.asarray(samples, np.float64).astype(f32), lo)
    x = np.log(r / lo).astype(f32)
    bins = []
    for j in range(-ulps, ulps + 1):
        y = x
        for _ in range(abs(j)):
            y = np.nextafter(y, f32(np.inf) if j > 0 else f32(-np.inf))
        bins.append(np.clip(np.floor(y * inv), 0, cfg.hist_bins - 1))
    bins = np.stack(bins)
    return int((bins.min(0) != bins.max(0)).sum())


def copy_latencies(trace: obs.DecisionTrace) -> np.ndarray:
    """Every real completion's latency (done − the task's arrival) from a
    host loop's decision trace: the samples the window fold reads."""
    arrival = {task: t for phase, t, task, *_ in trace.ring if phase == "arrive"}
    return np.array([t - arrival[task] for phase, t, task, *_ in trace.ring
                     if phase == "complete"])


def _f32_ulps(a: float, b: float) -> int:
    ia, ib = (int(np.float32(v).view(np.int32)) for v in (a, b))
    return abs(ia - ib)


def window_diffs(wa, wb, cfg: obs.ObserveConfig) -> dict:
    """Where two window streams of one run part: asserts every key outside
    the stated classes equal, and returns the measured size of each class
    (hist L1, the ulps of q_sum and mu_err_sum, the detector's float state
    as max |Δ| − DET_RTOL·|b| over its entries)."""
    assert len(wa) == len(wb)
    out = dict(hist_l1=0, q_ulps=0, mu_ulps=0, det_excess=0.0, det_abs=0.0)
    for a, b in zip(wa, wb):
        assert set(a) == set(b)
        hist_same = a["hist"] == b["hist"]
        out["hist_l1"] += int(np.abs(np.subtract(a["hist"], b["hist"])).sum())
        turns = max(a["turns"], 1)
        out["q_ulps"] = max(out["q_ulps"], _f32_ulps(a["q_mean"] * turns, b["q_mean"] * turns))
        out["mu_ulps"] = max(out["mu_ulps"],
                             _f32_ulps(a["mu_rel_err"] * turns, b["mu_rel_err"] * turns))
        for k in set(a) - {"q_mean", "mu_rel_err", "slo"} - set(DET_FLOATS):
            if k in HIST_KEYS and not hist_same:
                continue
            va, vb = a[k], b[k]
            if (isinstance(va, float) and isinstance(vb, float)
                    and math.isnan(va) and math.isnan(vb)):
                continue
            assert va == vb, (k, va, vb, a["window"])
        for k in DET_FLOATS:
            if k in a:
                x, y = np.asarray(a[k]), np.asarray(b[k])
                out["det_excess"] = max(out["det_excess"],
                                        float((np.abs(x - y) - DET_RTOL * np.abs(y)).max()))
                out["det_abs"] = max(out["det_abs"], float(np.abs(x - y).max()))
    return out


def assert_windows_within_bars(wa, wb, cfg, n_edge: int) -> dict:
    """``window_diffs`` held to the module's bars; returns the diffs."""
    d = window_diffs(wa, wb, cfg)
    assert d["hist_l1"] <= 2 * n_edge, (d, n_edge)
    assert d["q_ulps"] <= Q_ULPS, d
    assert d["mu_ulps"] <= MU_ERR_ULPS, d
    assert d["det_excess"] <= DET_ATOL, d
    return d


# ---------------------------------------------------------------------------
# windowed-quantile accuracy
# ---------------------------------------------------------------------------


def test_windowed_quantile_accuracy():
    """Histogram quantiles track exact percentiles within the pinned
    one-bin-ratio tolerance (samples inside [hist_lo, hist_hi])."""
    cfg = obs.ObserveConfig(window_turns=64, hist_bins=128)
    rng = np.random.default_rng(0)
    n = 4
    tc = tw.init_carry(cfg, "cpu")
    chunks = []
    row = flag = None
    for turn in range(cfg.window_turns):
        samples = np.clip(rng.lognormal(0.0, 1.5, size=32), 2e-3, 5e3)
        chunks.append(samples)
        tob = tw.plain_turn_obs(
            cfg, t=float(turn + 1), resp=samples, arrivals_k=32,
            q_view=torch.zeros(n, dtype=torch.int32), lam_hat=1.0,
            mu_hat=torch.ones(n), mu_true=np.ones(n), active=None)
        tc, row, flag = tw.observe_turn(cfg, tc, tob)
    assert bool(flag)  # window_turns folds -> boundary row
    rec = tw.record_from_state(cfg, row)
    samples = np.concatenate(chunks)
    assert rec["n_resp"] == rec["arrivals"] == samples.size
    tol = tw.quantile_tolerance(cfg)
    for q, key in [(50.0, "p50"), (99.0, "p99"), (99.9, "p999")]:
        exact = float(np.percentile(samples, q))
        assert abs(rec[key] - exact) / exact <= tol + 1e-9, (key, rec[key], exact)
    assert abs(rec["mean_est"] - samples.mean()) / samples.mean() <= tol


def test_quantile_tolerance_is_one_bin_ratio():
    cfg = obs.ObserveConfig()
    assert tw.quantile_tolerance(cfg) == pytest.approx(
        (cfg.hist_hi / cfg.hist_lo) ** (1 / cfg.hist_bins) - 1.0)
    edges = tw.bin_edges(cfg)
    assert edges.shape == (cfg.hist_bins + 1,)
    assert edges[0] == pytest.approx(cfg.hist_lo)
    assert edges[-1] == pytest.approx(cfg.hist_hi)


def test_configs_are_frozen_and_hashable():
    """Both configurations key the one-program loop's runner cache."""
    a = obs.ObserveConfig(window_turns=4, detect=obs.DetectConfig(rel_floor=0.1))
    b = obs.ObserveConfig(window_turns=4, detect=obs.DetectConfig(rel_floor=0.1))
    assert a == b and hash(a) == hash(b) and a.detect.rel_floor == (0.1,) * 5
    with pytest.raises(Exception):
        a.window_turns = 5
    with pytest.raises(TypeError):
        obs.ObserveConfig(detect={"warmup_windows": 2})


# ---------------------------------------------------------------------------
# telemetry-off bit-exactness, host vs scan, ledger, chunks, stream-only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_scan", [False, True])
@pytest.mark.parametrize("name", ["churn", "crash_storm"])
def test_telemetry_off_bit_exact_serving(name, use_scan):
    off = _run(name, use_scan=use_scan)
    on = _run(name, use_scan=use_scan, observe=OCFG)
    np.testing.assert_array_equal(off["responses"], on["responses"])
    np.testing.assert_array_equal(off["mu_trace"], on["mu_trace"])
    np.testing.assert_array_equal(off["pool"].free_at, on["pool"].free_at)
    assert off["info"].get("ledger") == on["info"].get("ledger")
    assert "windows" not in off["info"]
    assert on["info"]["windows"]


@pytest.mark.parametrize("name", ["null", "churn", "crash_storm"])
def test_host_scan_window_parity(name):
    h = _run(name, use_scan=False, observe=OCFG)
    s = _run(name, use_scan=True, observe=OCFG)
    wh, ws = h["info"]["windows"], s["info"]["windows"]
    assert wh
    assert_records_equal(wh, ws)
    # windows tile the horizon: full windows plus at most one partial
    T = h["info"]["turns"]
    assert len(wh) == -(-T // OCFG.window_turns)
    assert all(not w["partial"] for w in wh[:-1])


def test_crash_storm_windows_match_ledger():
    out = _run("crash_storm", use_scan=True, observe=OCFG)
    w = out["info"]["windows"]
    led = out["info"]["ledger"]
    assert sum(r["killed"] for r in w) == led["copies_real_killed"] > 0
    # the ledger also counts the end-of-run drain of copies still in flight
    # at the horizon, which no turn (hence no window) observes
    comp_w = sum(r["completed"] + r["dirty"] for r in w)
    assert 0 < comp_w <= led["copies_real_completed"]


def test_chunked_continuity():
    """chunk_turns=37 (coprime with the window width, so boundaries
    interleave) perturbs neither responses nor the window stream."""
    whole = _run("churn", use_scan=True, observe=OCFG)
    chunked = _run("churn", use_scan=True, observe=OCFG, chunk_turns=37)
    np.testing.assert_array_equal(whole["responses"], chunked["responses"])
    assert_records_equal(whole["info"]["windows"], chunked["info"]["windows"])


@pytest.mark.parametrize("name", ["churn", "crash_storm"])
def test_stream_only_mode(tmp_path, name):
    """emit_responses=False drops the response and μ̂ rows but leaves the
    window stream; a JsonlSink gets it chunk by chunk, one line a window."""
    so_cfg = obs.ObserveConfig(window_turns=8, emit_responses=False)
    full = _run(name, use_scan=True, observe=OCFG)
    path = tmp_path / "stream.jsonl"
    with obs.JsonlSink(str(path)) as sink:
        so = _run(name, use_scan=True, observe=so_cfg, chunk_turns=32, obs_sink=sink)
    assert so["mu_trace"].shape == (0, 5)
    if name == "crash_storm":  # the faulty turn's responses are a carry min-fold
        np.testing.assert_array_equal(so["responses"], full["responses"])
    else:
        assert so["responses"].size == 0
    assert_records_equal(full["info"]["windows"], so["info"]["windows"])
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(lines) == len(so["info"]["windows"]) == sink.count
    assert [r["turn"] for r in lines] == sorted(r["turn"] for r in lines)


@pytest.mark.parametrize("name", ["churn", "crash_storm"])
def test_host_loop_sink_sees_every_window(name):
    seen = []
    out = _run(name, use_scan=False, observe=OCFG, obs_sink=seen.extend)
    assert seen == out["info"]["windows"]


# ---------------------------------------------------------------------------
# exporters + decision tracing
# ---------------------------------------------------------------------------


def test_prometheus_and_dashboard():
    out = _run("churn", use_scan=True, observe=OCFG)
    rec = out["info"]["windows"][0]
    txt = obs.prometheus_snapshot(OCFG, rec, labels={"policy": "ppot_sq2"})
    assert "rosella_latency_p99_seconds" in txt
    assert 'policy="ppot_sq2"' in txt
    assert 'le="+Inf"' in txt
    # cumulative buckets end at the window's response count
    assert f'le="+Inf"}} {sum(rec["hist"])}' in txt
    header = obs.dashboard_header()
    row = obs.dashboard_row(rec)
    assert len(header.split()) == len(row.split())
    lines = []
    obs.dashboard(out["info"]["windows"], title="churn", print_fn=lines.append)
    assert lines[0] == "--- churn ---" and len(lines) == 2 + len(out["info"]["windows"])
    assert obs.rss_mb() > 0 and obs.peak_rss_mb() >= obs.rss_mb() * 0.5


@pytest.mark.parametrize("name", ["churn", "crash_storm"])
def test_decision_trace_and_chrome_export(tmp_path, name):
    dt = obs.DecisionTrace(cap=65536)
    out = _run(name, use_scan=False, observe=OCFG, decisions=dt)
    assert dt.seen > 0 and len(dt.ring) > 0 and dt.dropped == 0
    phases = {e[0] for e in dt.ring}
    assert {"arrive", "place", "complete"} <= phases
    if name == "crash_storm":
        assert {"kill", "timeout"} <= phases or "kill" in phases
    tr = dt.chrome_trace()
    assert tr["traceEvents"]
    path = tmp_path / "decisions.json"
    dt.save(str(path))
    assert json.loads(path.read_text())["traceEvents"]
    wtr = obs.windows_to_chrome_trace(out["info"]["windows"])
    assert [e for e in wtr["traceEvents"] if e.get("ph") == "C"]
    cpath = tmp_path / "windows.json"
    obs.save_chrome_trace(wtr, str(cpath))
    assert json.loads(cpath.read_text())["traceEvents"]


def test_scan_decision_trace_matches_the_host_loops():
    """The plain scan records every task's arrival, placement and completion
    from its placement rows: the host loop's events, completion instants
    (arrival + response) within an ulp of its done times."""
    hd, sd = obs.DecisionTrace(cap=1 << 20), obs.DecisionTrace(cap=1 << 20)
    _run("churn", use_scan=False, decisions=hd)
    _run("churn", use_scan=True, decisions=sd, chunk_turns=37)
    h, s = list(hd.ring), list(sd.ring)
    assert len(h) == len(s) > 0
    for a, b in zip(h, s):
        assert a[0] == b[0] and a[2:] == b[2:]
        assert a[1] == pytest.approx(b[1], rel=1e-15, abs=1e-12)
    # the faulty scan: arrivals and placements, and each completed task once
    fd = obs.DecisionTrace(cap=1 << 20)
    out = _run("crash_storm", use_scan=True, decisions=fd)
    done = [e for e in fd.ring if e[0] == "complete"]
    assert len(done) == int(np.isfinite(out["responses"]).sum())
    assert sum(e[0] == "place" for e in fd.ring) == out["responses"].size


def test_annotations_are_contexts():
    with obs.step_annotation("serve_scan_chunk", 3, "cpu"):
        with obs.trace_annotation("fold", device="cpu", turn=1):
            pass


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.fixture
def ref():
    """The reference's telemetry and environment packages."""
    from repro import env as jenv
    from repro import obs as jobs

    return jenv, jobs


@pytest.fixture
def ref_scan(monkeypatch, ref):
    """As ``ref``, with the reference scan loop runnable on jax 0.9, which has
    ``jax.enable_x64(True)`` where the reference imports
    ``jax.experimental.enable_x64``."""
    import jax
    import jax.experimental

    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                        raising=False)
    return ref


def _random_obs(rng, n, m, turn, masked):
    resp = rng.lognormal(0.0, 2.5, m)
    resp[rng.random(m) < 0.1] = 1e-6  # below hist_lo: clipped into bin 0
    resp[rng.random(m) < 0.05] = 1e7  # above hist_hi: clipped into the last bin
    return dict(
        t=np.float32(0.37 * (turn + 1)), resp=resp, resp_ok=rng.random(m) < 0.8,
        arrivals_k=m, lam_hat=np.float32(rng.random() * 20), mu_true=rng.random(n) * 3,
        dctr=rng.integers(0, 6, 10), q=rng.integers(0, 60, n).astype(np.int32),
        mu=(rng.random(n) * 3).astype(np.float32),
        active=(rng.random(n) < 0.75) if masked else None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("faulty", [False, True])
def test_fold_matches_the_reference(ref, faulty, masked):
    """``observe_turn`` (then ``record_from_state``) on seeded random turns
    (masked slots, samples below and above the histogram's range, window
    boundaries every 3 turns) against the reference's jitted host fold:
    every record key equal but the stated classes, within their bars."""
    import jax.numpy as jnp

    _, jobs = ref
    from repro.obs import windows as jw

    jcfg, tcfg = jobs.ObserveConfig(window_turns=3), obs.ObserveConfig(window_turns=3)
    rng = np.random.default_rng(7)
    jt, tt = jw.init_carry(jcfg), tw.init_carry(tcfg, "cpu")
    recs_j, recs_t, samples = [], [], []
    for turn in range(90):
        o = _random_obs(rng, 6, 24, turn, masked)
        common = dict(t=o["t"], resp=o["resp"], arrivals_k=o["arrivals_k"],
                      lam_hat=o["lam_hat"], mu_true=o["mu_true"])
        act_j = None if o["active"] is None else jnp.asarray(o["active"])
        act_t = None if o["active"] is None else torch.from_numpy(o["active"])
        if faulty:
            jo = jw.faulty_turn_obs(jcfg, resp_ok=o["resp_ok"], q_view=jnp.asarray(o["q"]),
                                    mu_hat=jnp.asarray(o["mu"]), active=act_j,
                                    dctr=o["dctr"], **common)
            to = tw.faulty_turn_obs(tcfg, resp_ok=o["resp_ok"], q_view=torch.from_numpy(o["q"]),
                                    mu_hat=torch.from_numpy(o["mu"]), active=act_t,
                                    dctr=o["dctr"], **common)
            samples.append(o["resp"][o["resp_ok"]])
        else:
            jo = jw.plain_turn_obs(jcfg, q_view=jnp.asarray(o["q"]),
                                   mu_hat=jnp.asarray(o["mu"]), active=act_j, **common)
            to = tw.plain_turn_obs(tcfg, q_view=torch.from_numpy(o["q"]),
                                   mu_hat=torch.from_numpy(o["mu"]), active=act_t, **common)
            samples.append(o["resp"])
        jt, jr, jf = jw.observe_turn_host(jcfg, jt, jo)
        tt, trow, tf = tw.observe_turn(tcfg, tt, to)
        assert bool(jf) == bool(tf)
        recs_j.append(jw.record_from_state(jcfg, jr))
        recs_t.append(tw.record_from_state(tcfg, trow))
    assert sum(r["partial"] is False for r in recs_t) == 30
    assert any(r["hist"][0] for r in recs_t) and any(r["hist"][-1] for r in recs_t)
    n_edge = edge_count(np.concatenate(samples), tcfg)
    d = assert_windows_within_bars(recs_t, recs_j, tcfg, n_edge)
    assert d["mu_ulps"] <= 4  # identical μ̂: only the sum order parts them
    tail_j, tail_t = jw.final_partial_record(jcfg, jt), tw.final_partial_record(tcfg, tt)
    assert tail_j is None and tail_t is None  # 90 turns: no partial window


def _ref_records(jenv, jobs, name, use_scan, use_alias, detect):
    jcfg = jobs.ObserveConfig(window_turns=8, detect=(jobs.DetectConfig(warmup_windows=4)
                                                       if detect else None))
    out = jenv.run_scenario(jenv.make(name, horizon=160.0), use_scan=use_scan,
                            sequential_pool=True, arrival_batch=8, seed=0, use_alias=use_alias,
                            observe=jcfg)
    return out


@pytest.mark.parametrize("use_alias", [True, False])
@pytest.mark.parametrize("use_scan", [False, True])
@pytest.mark.parametrize("name", ["null", "churn", "crash_storm"])
def test_records_match_the_reference(ref_scan, name, use_scan, use_alias):
    """The port's host loop against ``repro.env.run_workload``'s (and its
    recovery loop), its scan against the reference's scan, at n = 5,
    batches of 8, seed 0, with the detector on: responses equal, window
    records equal but the stated classes within their bars, alarm fields
    equal."""
    jenv, jobs = ref_scan
    r = _ref_records(jenv, jobs, name, use_scan, use_alias, True)
    ocfg = obs.ObserveConfig(window_turns=8, detect=obs.DetectConfig(warmup_windows=4))
    trace = obs.DecisionTrace(cap=1 << 20)
    _run(name, use_scan=False, use_alias=use_alias, decisions=trace)
    p = _run(name, use_scan=use_scan, use_alias=use_alias, observe=ocfg)
    np.testing.assert_array_equal(p["responses"], r["responses"])
    wr, wp = r["info"]["windows"], p["info"]["windows"]
    assert len(wp) == 8
    n_edge = edge_count(copy_latencies(trace), ocfg)
    assert_windows_within_bars(wp, wr, ocfg, n_edge)


def test_exporters_string_equal_the_reference(ref):
    """``prometheus_snapshot``, the dashboard, the window Chrome trace and the
    decision trace's Chrome trace, fed the same records and events, give
    the reference's strings."""
    from repro.obs import export as jexp
    from repro.obs import slo as jslo
    from repro.obs import tracing as jtr

    ocfg = obs.ObserveConfig(window_turns=4, detect=obs.DetectConfig(warmup_windows=4))
    dt = obs.DecisionTrace(cap=1 << 20)
    out = _run("crash_storm", use_scan=False, horizon=360.0, observe=ocfg, decisions=dt)
    recs = out["info"]["windows"]
    objs = obs.default_objectives(p99_target=8.0)
    obs.annotate(recs, ocfg, objs)
    jcfg = ref[1].ObserveConfig(window_turns=4, detect=ref[1].DetectConfig(warmup_windows=4))
    recs_j = json.loads(json.dumps(recs))  # the same records, annotated afresh
    for r in recs_j:
        r.pop("slo")
    jslo.annotate(recs_j, jcfg, jslo.default_objectives(p99_target=8.0))
    assert [r["slo"] for r in recs_j] == json.loads(json.dumps([r["slo"] for r in recs]))
    for r in recs[::7]:
        assert (obs.prometheus_snapshot(ocfg, r, labels={"p": "x"})
                == jexp.prometheus_snapshot(jcfg, r, labels={"p": "x"}))
        assert obs.dashboard_row(r) == jexp.dashboard_row(r)
    assert obs.dashboard_header() == jexp.dashboard_header()
    assert json.dumps(obs.windows_to_chrome_trace(recs)) == json.dumps(
        jtr.windows_to_chrome_trace(recs))
    jdt = jtr.DecisionTrace(cap=1 << 20)
    for e in dt.ring:
        phase, t, task, worker, frontend, attempt = e
        jdt.event(phase, t, task, worker=worker, frontend=frontend, attempt=attempt)
    assert json.dumps(dt.chrome_trace()) == json.dumps(jdt.chrome_trace())
    small = obs.DecisionTrace(cap=16, sample_every=3)
    jsmall = jtr.DecisionTrace(cap=16, sample_every=3)
    for e in list(dt.ring)[:200]:
        for d_ in (small, jsmall):
            d_.event(e[0], e[1], e[2], worker=e[3], frontend=e[4], attempt=e[5])
    assert (small.seen, small.dropped) == (jsmall.seen, jsmall.dropped) and small.dropped > 0
    assert json.dumps(small.chrome_trace()) == json.dumps(jsmall.chrome_trace())


def _stacked_rows(rng, T, S, bins=64):
    """Synthetic stacked TelemetryCarry rows [T, S, ...] (numpy)."""
    from repro_torch.obs import detect as td

    def i(*shape, hi=50):
        return rng.integers(0, hi, (T, S) + shape).astype(np.int32)

    def f(*shape):
        return rng.random((T, S) + shape).astype(np.float32) * 10

    t_last = np.cumsum(rng.random((T, S)), 0).astype(np.float32) + 1
    fields = dict(hist=i(bins, hi=9), t_start=t_last - np.float32(0.5), t_last=t_last,
                  turns=np.full((T, S), 4, np.int32),
                  turn_idx=np.tile((np.arange(T, dtype=np.int32) + 1)[:, None] * 4, (1, S)),
                  det_mean=f(td.NSIG), det_scale=f(td.NSIG), det_pos=f(td.NSIG),
                  det_neg=f(td.NSIG), det_regime=i(hi=5), det_fired=i(hi=5))
    return tw.TelemetryCarry(**{k: fields.get(k, f() if k in ("q_sum", "mu_err_sum", "lam_hat")
                                              else i()) for k in tw.TelemetryCarry._fields})


def test_fleet_and_simulator_helpers_match_the_reference(ref):
    """The numpy fleet and chain-simulator helpers on synthetic stacked rows
    (their callers arrive with the fleet and the simulator) and
    ``fleet_collisions`` against the reference's."""
    import jax.numpy as jnp
    from repro.obs import windows as jw

    rng = np.random.default_rng(3)
    jcfg = ref[1].ObserveConfig(window_turns=4, detect=ref[1].DetectConfig())
    tcfg = obs.ObserveConfig(window_turns=4, detect=obs.DetectConfig())
    rows = _stacked_rows(rng, 12, 3)
    flags = rng.random(12) < 0.5
    a, af = tw.fleet_records_from_rows(tcfg, rows, flags)
    b, bf = jw.fleet_records_from_rows(jcfg, rows, flags)
    assert_records_equal(a, b)
    assert len(af) == len(bf) == int(flags.sum())
    for x, y in zip(af, bf):
        assert_records_equal(x, y)
    last = tw.TelemetryCarry(*(v[-1] for v in rows))
    pa, pfa = tw.fleet_final_partial(tcfg, last)
    pb, pfb = jw.fleet_final_partial(jcfg, last)
    assert_records_equal([pa], [pb])
    assert_records_equal(pfa, pfb)
    assert tw.fleet_final_partial(tcfg, last._replace(turns=np.zeros(3, np.int32))) == (None, [])
    for fl in (flags, np.r_[flags[:-1], True], np.r_[flags[:-1], False]):
        sim = {"obs_row": tw.TelemetryCarry(*(v[:, 0] for v in rows)), "obs_flag": fl}
        assert_records_equal(tw.sim_records_from_trace(tcfg, sim),
                             jw.sim_records_from_trace(jcfg, sim))
    for S, k, n in ((1, 8, 5), (4, 16, 5), (3, 32, 64)):
        w = rng.integers(-2, n + 2, (S, k)).astype(np.int32)
        got = tw.fleet_collisions(torch.from_numpy(w), n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jw.fleet_collisions(jnp.asarray(w), n)))
