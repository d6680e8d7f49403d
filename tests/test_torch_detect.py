"""The port's regime detector and SLO alerting (``repro_torch.obs.detect``,
``obs.slo``) on the CPU at the registry's cluster (n = 5, batches of 8),
mirroring tests/test_detect.py: detector-off bit-exactness on both loops,
host = scan detector state float for float, chunk-boundary continuity,
zero false alarms on ``null``, the churn detection pin, the env ground
truth, the attribution report, the SLO burn-rate tracker and
``hist_frac_above``.

Against the reference: ``update_row`` over a seeded 200-window signal
stream with load, membership, queue and failure shifts, each side folding
its own state: every detector field equal, float state included. The
reference's compiled step contracts four product-sums into fused
multiply-adds; the port reproduces them with ``estimator.fma_f32`` (plain
separate operations part from it by up to some hundred ulps in the CUSUM
accumulators, near zero)."""
from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread a test worker)
import math

import numpy as np
import pytest
import torch

from repro_torch import env as tenv
from repro_torch import obs
from repro_torch.obs import detect as obd
from repro_torch.obs import windows as tw
from repro_torch.obs.detect import DetectConfig
from repro_torch.obs.slo import SLObjective, SLOTracker, annotate, hist_frac_above

from test_torch_obs import assert_records_equal

DCFG = DetectConfig(warmup_windows=4)
OCFG = obs.ObserveConfig(window_turns=8, detect=DCFG)
BASE = obs.ObserveConfig(window_turns=8)  # telemetry-only twin


def _run(name, *, use_scan, horizon=160.0, seed=0, observe=None, **kw):
    return tenv.run_scenario(tenv.make(name, horizon=horizon), use_scan=use_scan,
                             sequential_pool=True, arrival_batch=8, seed=seed,
                             observe=observe, device="cpu", **kw)


# ---------------------------------------------------------------------------
# detector-off bit-exactness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_scan", [False, True])
@pytest.mark.parametrize("name", ["churn", "crash_storm"])
def test_detector_off_bit_exact(name, use_scan):
    """Turning the detector on perturbs nothing: responses and μ̂ traces
    stay bit-equal to the no-telemetry and the telemetry-only runs, and
    every shared window key keeps its exact value (the detector only adds
    keys)."""
    off = _run(name, use_scan=use_scan)
    base = _run(name, use_scan=use_scan, observe=BASE)
    on = _run(name, use_scan=use_scan, observe=OCFG)
    np.testing.assert_array_equal(off["responses"], on["responses"])
    np.testing.assert_array_equal(off["mu_trace"], on["mu_trace"])
    np.testing.assert_array_equal(base["responses"], on["responses"])
    det_keys = set(on["info"]["windows"][0]) - set(base["info"]["windows"][0])
    assert {"regime", "detected", "det_count", "det_mean"} <= det_keys
    assert_records_equal(base["info"]["windows"], on["info"]["windows"], ignore=det_keys)


# ---------------------------------------------------------------------------
# host vs scan detector state, chunk boundaries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["null", "churn", "crash_storm"])
def test_host_scan_detector_state_parity(name):
    """The detector state itself (EMA baselines, scales, both CUSUM
    accumulators) equal float for float between the host loops' eager fold
    and the scan's turn, on every window."""
    h = _run(name, use_scan=False, observe=OCFG)
    s = _run(name, use_scan=True, observe=OCFG)
    assert_records_equal(h["info"]["windows"], s["info"]["windows"])
    for rec in h["info"]["windows"]:
        for k in ("det_mean", "det_scale", "det_pos", "det_neg"):
            assert len(rec[k]) == obd.NSIG


def test_chunk_boundary_continuity():
    """chunk_turns=37 is coprime with window_turns=8, so chunk edges land
    mid-window and mid-CUSUM: the detector fields cross them in the carry."""
    whole = _run("churn", use_scan=True, observe=OCFG)
    chunked = _run("churn", use_scan=True, observe=OCFG, chunk_turns=37)
    np.testing.assert_array_equal(whole["responses"], chunked["responses"])
    assert_records_equal(whole["info"]["windows"], chunked["info"]["windows"])


# ---------------------------------------------------------------------------
# zero false alarms on null + detection pins vs ground truth
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_scan", [False, True])
def test_null_zero_false_alarms(use_scan):
    """A stationary environment never fires (k = 1σ slack, h = 6σ)."""
    scn = tenv.make("null", horizon=360.0)
    ocfg = obs.ObserveConfig(window_turns=2, detect=DetectConfig(warmup_windows=8))
    out = tenv.run_scenario(scn, use_scan=use_scan, sequential_pool=True, arrival_batch=8,
                            seed=0, observe=ocfg, device="cpu")
    recs = out["info"]["windows"]
    assert recs[-1]["det_count"] == 0
    assert all(r["detected"] == 0 and r["regime"] == 0 for r in recs)
    assert obd.detections_from_records(recs) == []
    assert scn.shift_events(0) == [] and not scn.drifting


def test_churn_detection_pin():
    """churn loses a worker at its ground-truth shift (t = 120, seed 0); the
    detector fires a membership_shift within a few windows of it, and the
    attribution report joins the two."""
    scn = tenv.make("churn", horizon=360.0)
    ocfg = obs.ObserveConfig(window_turns=2, detect=DetectConfig(warmup_windows=12))
    out = tenv.run_scenario(scn, use_scan=True, sequential_pool=True, arrival_batch=8, seed=0,
                            observe=ocfg, device="cpu")
    recs = out["info"]["windows"]
    events = scn.shift_events(0)
    assert (120.0, "membership") in events
    dets = obd.detections_from_records(recs)
    memb = [d for d in dets if d["label"] == "membership_shift"]
    assert memb, dets
    first = min(d["t"] for d in memb if d["t"] >= 120.0)
    assert 120.0 <= first <= 135.0  # detected within ~7 windows
    rep = obd.detection_report(recs, shift_events=events, drifting=scn.drifting)
    assert rep["false_alarms"] == 0
    assert rep["n_detected_shifts"] >= 1
    ps = rep["per_shift"]["120.000"]
    assert ps["detected"] and ps["kind_match"]
    assert 0.0 <= ps["latency"] <= 15.0


def test_shift_events_kinds_and_drift_flags():
    fc = tenv.make("flash_crowd", horizon=360.0)
    ev = fc.shift_events(0)
    assert ev and all(k == "load" for _, k in ev)
    assert not fc.drifting
    assert len(fc.shift_times(0)) == 0  # arrival shifts never enter shift_times
    di = tenv.make("diurnal", horizon=360.0)
    assert di.drifting and di.shift_events(0) == []
    sd = tenv.make("speed_drift", horizon=360.0)
    assert sd.drifting and sd.shift_events(0) == []
    cs = tenv.make("crash_storm", horizon=360.0)
    assert {k for _, k in cs.shift_events(0)} == {"fault"}
    np.testing.assert_allclose([t for t, _ in cs.shift_events(0)], cs.shift_times(0))


def test_detection_report_attribution_synthetic():
    """The join on synthetic input: two shifts, one detected late with the
    right kind, one with the wrong kind, one false alarm before any shift."""
    def rec(t, turn, detected, count):
        return {"t_end": t, "turn": turn, "window": turn, "partial": False,
                "detected": detected, "det_count": count,
                "detected_label": obd.REGIMES[detected]}

    recs = [rec(10.0, 1, 0, 0), rec(20.0, 2, obd.LOAD_SHIFT, 1),
            rec(40.0, 4, 0, 1), rec(60.0, 6, obd.CAPACITY_SHIFT, 2),
            rec(80.0, 8, obd.CAPACITY_SHIFT, 3)]
    events = [(30.0, "capacity"), (70.0, "membership")]
    rep = obd.detection_report(recs, shift_events=events,
                               adaptation={"per_shift": {"30.000": 12.5}})
    assert rep["false_alarms"] == 1  # the t=20 alarm precedes any shift
    assert rep["n_detected_shifts"] == 2 and rep["repeats"] == 0
    s30 = rep["per_shift"]["30.000"]
    assert s30["detected"] and s30["latency"] == pytest.approx(30.0)
    assert s30["kind_match"] is True and s30["adaptation_time"] == 12.5
    s70 = rep["per_shift"]["70.000"]
    assert s70["detected"] and s70["kind_match"] is False  # wrong label
    assert rep["mean_adaptation"] == 12.5 and rep["kind_match_rate"] == 0.5
    rep_d = obd.detection_report(recs, shift_events=(), drifting=True)
    assert rep_d["false_alarms"] is None
    assert rep_d["n_detections"] == 3


# ---------------------------------------------------------------------------
# SLO burn-rate alerting
# ---------------------------------------------------------------------------


def _mkrec(err_n, tot, t):
    """A minimal record whose loss error rate is err_n/tot."""
    return {"t_end": t, "launched": tot, "killed": err_n, "n_resp": 0}


def _loss_objective():
    return SLObjective(name="loss", metric="loss", budget=0.01, fast_windows=2, slow_windows=4,
                       fast_burn=2.0, slow_burn=1.0)


def test_slo_multiwindow_burn_alert():
    tr = SLOTracker(obs.ObserveConfig(), objectives=(_loss_objective(),))
    for i in range(4):
        assert not tr.update(_mkrec(0, 100, float(i)))["loss"]["alert"]
    st = tr.update(_mkrec(5, 100, 4.0))
    assert st["loss"]["alert"]  # fast=2.5 ≥ 2, slow=1.25 ≥ 1
    st = tr.update(_mkrec(5, 100, 5.0))
    assert st["loss"]["alert"]
    rep = tr.report()["objectives"]["loss"]
    assert rep["activations"] == 1 and rep["first_alert_t"] == 4.0
    assert tr.active_alerts == ["loss"]
    tr.update(_mkrec(0, 100, 6.0))
    st = tr.update(_mkrec(0, 100, 7.0))
    assert not st["loss"]["alert"]  # the fast window is clean again
    st = tr.update(_mkrec(0, 0, 8.0))  # idle windows consume no budget
    assert st["loss"]["err_rate"] is None and not st["loss"]["alert"]
    with pytest.raises(ValueError):
        SLOTracker(obs.ObserveConfig(), objectives=(_loss_objective(), _loss_objective()))
    with pytest.raises(ValueError):
        SLObjective(name="x", metric="nope")


def test_slo_one_bad_window_cannot_page():
    tr = SLOTracker(obs.ObserveConfig(), objectives=(_loss_objective(),))
    for i in range(4):
        tr.update(_mkrec(0, 100, float(i)))
    st = tr.update(_mkrec(3, 100, 4.0))  # 3% once: fast = 1.5 < 2
    assert not st["loss"]["alert"]


def test_hist_frac_above_inverts_quantile():
    out = _run("churn", use_scan=True, observe=BASE)
    rec = next(r for r in out["info"]["windows"] if r["n_resp"] > 50)
    assert hist_frac_above(rec["hist"], rec["p99"], BASE) == pytest.approx(0.01, abs=1e-6)
    assert hist_frac_above(rec["hist"], 0.0, BASE) == 1.0
    assert hist_frac_above(rec["hist"], 1e9, BASE) == 0.0
    assert math.isnan(hist_frac_above(np.zeros(BASE.hist_bins), 1.0, BASE))


def test_slo_annotates_real_stream_and_exports():
    scn = tenv.make("crash_storm", horizon=360.0)
    ocfg = obs.ObserveConfig(window_turns=4, detect=DetectConfig(warmup_windows=8))
    out = tenv.run_scenario(scn, use_scan=True, sequential_pool=True, arrival_batch=8, seed=0,
                            observe=ocfg, device="cpu")
    recs = out["info"]["windows"]
    objs = (SLObjective(name="latency_p99", threshold=8.0, budget=0.01),
            SLObjective(name="loss_rate", metric="loss", budget=0.02))
    tr = annotate(recs, ocfg, objs)
    assert all("slo" in r for r in recs)
    assert tr.report()["n_windows"] == len(recs)
    txt = obs.prometheus_snapshot(ocfg, recs[-1], labels={"p": "x"})
    assert "rosella_slo_burn_fast" in txt and "rosella_workers_active" in txt
    header = obs.dashboard_header()
    for r in recs:
        assert len(obs.dashboard_row(r).split()) >= len(header.split())
    trace = obs.windows_to_chrome_trace(recs)
    names = {e["name"].split(":")[0] for e in trace["traceEvents"] if e.get("ph") == "i"}
    assert "regime" in names  # crash_storm detections become markers


def test_sink_with_slo_streams_a_chunked_run():
    """``SinkWithSLO`` as ``obs_sink`` on a chunked scan annotates every
    record as the batch form does and forwards them all."""
    ocfg = obs.ObserveConfig(window_turns=4)
    got = []
    sink = obs.SinkWithSLO(SLOTracker(ocfg), got.extend)
    out = _run("crash_storm", use_scan=True, horizon=360.0, observe=ocfg, chunk_turns=29,
               obs_sink=sink)
    recs = out["info"]["windows"]
    assert got == recs and sink.tracker.n_windows == len(recs)
    fresh = [{k: v for k, v in r.items() if k != "slo"} for r in recs]
    annotate(fresh, ocfg)
    assert [r["slo"] for r in fresh] == [r["slo"] for r in recs]


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def _signal_stream(rng, W):
    """Seeded per-window rows with a load step (80), a membership loss (120),
    a queue build-up (140) and a failure storm (170)."""
    for w in range(W):
        yield dict(
            lam_hat=np.float32(10.0 * (1 + (w >= 80)) + rng.normal(0, 0.5)),
            mu_err_sum=np.float32(4 * (0.2 + rng.random() * 0.05)),
            q_sum=np.float32(4 * (3 + rng.random() + (w >= 140) * 5)),
            n_active=np.int32(5 - (w >= 120)),
            killed=np.int32(rng.poisson(0.2 + 5 * (w >= 170))),
            dirty=np.int32(0), retried=np.int32(0),
            turns=np.int32(4), turn_idx=np.int32(4 * (w + 1)))


@pytest.mark.parametrize("flags", ["every", "alternate"])
def test_update_row_matches_the_reference(flags):
    """``update_row`` over a seeded 200-window stream with shifts, each side
    folding its own state: every detector field equal to the reference's
    jitted step, the float state bit for bit, the alarms with it; with
    ``flag`` false the state passes through untouched."""
    import jax
    import jax.numpy as jnp
    from repro.obs import detect as jd
    from repro.obs import windows as jw

    jdc, tdc = jd.DetectConfig(warmup_windows=8), DetectConfig(warmup_windows=8)
    rowj = jw.init_carry(jw.ObserveConfig(window_turns=4, detect=jdc))
    rowt = tw.init_carry(obs.ObserveConfig(window_turns=4, detect=tdc), "cpu")
    step = jax.jit(lambda r, f: jd.update_row(jdc, r, f))
    rng = np.random.default_rng(1)
    fired = []
    for w, vals in enumerate(_signal_stream(rng, 200)):
        flag = flags == "every" or w % 2 == 0
        rj = step(rowj._replace(**{k: jnp.asarray(v) for k, v in vals.items()}),
                  jnp.asarray(flag))
        rt = obd.update_row(tdc, rowt._replace(**{k: torch.tensor(v) for k, v in vals.items()}),
                            torch.tensor(flag))
        for f in obd.DETECT_FIELDS:
            a, b = np.asarray(getattr(rj, f)), getattr(rt, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a.view(np.int32), b.view(np.int32)), \
                (w, f, a, b)
        if not flag:
            for f in obd.DETECT_FIELDS:
                assert torch.equal(getattr(rt, f), getattr(rowt, f))
        fired.append(int(rt.det_fired))
        rowj, rowt = rj, rt
    kinds = {k for k in fired if k}
    assert {obd.LOAD_SHIFT, obd.MEMBERSHIP_SHIFT, obd.FAILURE_STORM} <= kinds


def test_record_fields_and_signals():
    """The detector's record keys read numpy rows; the signal vector reads a
    window row's means."""
    row = tw.init_carry(OCFG, "cpu")._replace(
        lam_hat=torch.tensor(3.0), mu_err_sum=torch.tensor(2.0), q_sum=torch.tensor(8.0),
        n_active=torch.tensor(5, dtype=torch.int32), killed=torch.tensor(2, dtype=torch.int32),
        turns=torch.tensor(4, dtype=torch.int32), det_regime=torch.tensor(3, dtype=torch.int32),
        det_fired=torch.tensor(3, dtype=torch.int32))
    np.testing.assert_array_equal(obd.signals_from_row(row).numpy(), [3.0, 0.5, 2.0, 5.0, 2.0])
    full = obd.record_fields(tw.host_row(row), partial=False)
    assert full["regime_label"] == full["detected_label"] == "membership_shift"
    assert obd.record_fields(tw.host_row(row), partial=True)["detected"] == obd.STABLE
