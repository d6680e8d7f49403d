"""The chain simulator's in-chain telemetry (``SimConfig.observe`` on the
CPU: ``kernels/sim_chain/ref.ObsFold`` in the plain chain) against the
reference's ``repro.core.simulator.simulate(observe=...)``, on the same
scenarios and seeds.

Cases: tests/test_obs.py's own (churn's paper-mode chain, 2000 rounds,
windows of 32); churn, crash_storm and cotenant_shock in their environments
with the detector (3000 rounds); the null scenario (the paper's mode, no
active mask) with the detector; Fig. 8's smoke settings through
``make_sim`` and ``dataclasses.replace(observe=...)``; a fleet chain at S = 4,
n = 8, synced every 16 rounds; known speeds on the inverse-CDF stream.

Parity classes:
  * the port's own draws: every integer row field (the histogram apart),
    the alarm fields and ``obs_flag`` equal on every round; ``q_sum``,
    ``lam_hat``, ``t_start`` and ``t_last`` within REL_TOL (the clock's and
    λ̂'s own bar); ``mu_err_sum`` and the detector's float state, which read
    μ̂ (within REL_TOL of the reference's), within MU_ERR_ATOL +
    MU_ERR_RTOL·|x| and DET_ATOL + DET_RTOL·|x|; the histogram's L1
    distance at most twice the real completions whose bin a move of
    EDGE_ULPS ulps in the logarithm would change (``test_torch_obs.
    edge_count``: the fold bins by thresholds, the reference by XLA's log);
  * the reference's own draws fed to the plain chain: every row field equal
    bit for bit (the histogram at the same edge bar), but ``mu_err_sum`` and
    the μ̂-error signal's detector state, at the bars above;
  * telemetry on against off: every other trace column equal; over the
    records ``n_resp`` and the histograms' counts sum to the trace's real
    completions (the reference's own assertions);
  * ``sim_records_from_trace``: the port's records against the reference's
    records of its trace, at the same bars.

Measured at these sizes (seed 0): every histogram equal (no sample lay
within 2 ulps of an edge), ``q_sum``, ``lam_hat`` and the clocks equal,
``mu_err_sum`` within 9.6e-6 relative (crash_storm; its terms are
differences of μ̂ shares, so μ̂'s own bar grows where μ̂ is near μ), the
detector's float state within 2.9e-5 beyond 1e-5·|x| (Fig. 8's 6000
rounds: the CUSUM divides the μ̂ error's small innovation by its scale),
every alarm field equal; with the reference's draws every field but those
two equal.

In the paper's mode the reference's compiled chain adds the queue mean to
the window's sum as one fused multiply-add, q_sum + Σq·(1/n); under an
active mask it divides (Σq / #active) and adds: ``q_sum`` is exact in
both forms.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import env as renv
from repro import obs as robs
from repro.core import simulator as rsim
from repro_torch import env as tenv
from repro_torch import obs as tobs
from repro_torch.configs import rosella_sim as TRS
from repro_torch.core import simulator as tsim
from repro_torch.kernels.sim_chain import kernel as SK
from repro_torch.kernels.sim_chain import ref as SR
from repro_torch.obs import windows as tw
from repro_torch.utils import prng
from test_torch_model import reference_shim
from test_torch_obs import edge_count
from test_torch_sim_env import jax_draws

REL_TOL = 1e-5
MU_ERR_RTOL, MU_ERR_ATOL = 2e-5, 1e-6
DET_RTOL, DET_ATOL = 1e-5, 1e-4
EDGE_ULPS = 2
TPCH = TRS.tpch_speed_set(30, 0)
MU8 = [0.3, 0.5, 1.0, 2.0, 1.0, 0.5, 2.0, 0.7]
KNOWN_CDF = dict(use_learner=False, use_fake_jobs=False, use_alias=False)


def _ocfg(pkg, window, warmup):
    det = None if warmup is None else pkg.DetectConfig(warmup_windows=warmup)
    return pkg.ObserveConfig(window_turns=window, detect=det)


#: name -> (source, scenario or speeds, rounds, window, detector warm-up,
#: SimConfig fields, whether the scenario's environment runs)
CASES = {
    "test_obs_churn": ("scenario", "churn", 2000, 32, None, {}, False),
    "churn": ("scenario", "churn", 3000, 32, 4, {}, True),
    "crash_storm": ("scenario", "crash_storm", 3000, 32, 4, {}, True),
    "cotenant_shock": ("scenario", "cotenant_shock", 3000, 32, 4, {}, True),
    "null": ("scenario", "null", 3000, 32, 4, {}, True),
    "fig8_smoke": ("make_sim", TPCH, 6000, 64, 4, {}, False),
    "fleet_s4_n8_sync16": ("make_sim", MU8, 3000, 32, 4,
                           dict(n_frontends=4, fleet_sync_every=16), False),
    "known_cdf": ("make_sim", TPCH, 3000, 32, 4, KNOWN_CDF, False),
}
#: the reference's own draws are fed to the plain chain for these
REF_DRAW_CASES = ("churn", "crash_storm", "null", "fleet_s4_n8_sync16", "known_cdf")
INT_FIELDS = tuple(f for f in tw.PACK_I32)
CLOCK_FIELDS = ("q_sum", "lam_hat", "t_start", "t_last")


def configs(rrs, name):
    """(reference cfg, params, env, port cfg, params, env) of a case."""
    src, what, rounds, window, warmup, kw, use_env = CASES[name]
    ro, to = _ocfg(robs, window, warmup), _ocfg(tobs, window, warmup)
    if src == "scenario":
        rc, rp, re_ = renv.make(what).to_sim("ppot_sq2", rounds=rounds, observe=ro, **kw)
        tc, tp, te = tenv.make(what).to_sim("ppot_sq2", rounds=rounds, observe=to,
                                            device="cpu", **kw)
        if not use_env:
            re_ = te = None
        return rc, rp, re_, tc, tp, te
    fleet = {k: v for k, v in kw.items() if k.startswith("n_") or k.startswith("fleet")}
    rest = {k: v for k, v in kw.items() if k not in fleet}
    mk = {k: v for k, v in rest.items() if k in ("use_learner", "use_fake_jobs")}
    rc, rp = rrs.make_sim("ppot_sq2", np.asarray(what), 0.8, rounds=rounds, **mk, **fleet)
    tc, tp = TRS.make_sim("ppot_sq2", np.asarray(what), 0.8, rounds=rounds, device="cpu", **mk,
                          **fleet)
    extra = {k: v for k, v in rest.items() if k not in mk}
    return (dataclasses.replace(rc, observe=ro, **extra), rp, None,
            dataclasses.replace(tc, observe=to, **extra), tp, None)


class _Samples:
    """Records the service-time sample of every real completion the plain
    chain folds (``ObsFold.step``'s ``svc`` where ``svc_ok``)."""

    def __init__(self):
        self.values = []

    def __enter__(self):
        self.step = SR.ObsFold.step
        rec = self.values

        def step(fold, now, svc, svc_ok, *a, **kw):
            if svc_ok:
                rec.append(float(svc))
            return self.step(fold, now, svc, svc_ok, *a, **kw)

        SR.ObsFold.step = step
        return self

    def __exit__(self, *exc):
        SR.ObsFold.step = self.step


@pytest.fixture(scope="module")
def runs():
    """Every case run once by the reference and by the port (seed 0), the
    port also with observe off."""
    out = {}
    with reference_shim():
        from repro.configs import rosella_sim as rrs
        for name in CASES:
            rc, rp, re_, tc, tp, te = configs(rrs, name)
            _, rt = rsim.simulate(rc, rp, jax.random.PRNGKey(0), re_)
            with _Samples() as s:
                _, tt = tsim.simulate(tc, tp, prng.PRNGKey(0), te, device="cpu")
            _, off = tsim.simulate(dataclasses.replace(tc, observe=None), tp, prng.PRNGKey(0),
                                   te, device="cpu")
            out[name] = dict(rc=rc, rp=rp, re=re_, tc=tc, tp=tp, te=te, rt=rt, tt=tt, off=off,
                             samples=np.asarray(s.values, np.float32))
    return out


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_rows_within_bars(rrows, rflags, trows, tflags, ocfg, samples, exact=False) -> dict:
    """The classes of the module's docstring; ``exact``: the reference's own
    draws (every field equal but μ̂'s two). Returns what was measured."""
    np.testing.assert_array_equal(_np(rflags), _np(tflags))
    got = {f: _np(getattr(trows, f)) for f in tw.TelemetryCarry._fields}
    want = {f: _np(getattr(rrows, f)) for f in tw.TelemetryCarry._fields}
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    n_edge = edge_count(samples, ocfg, EDGE_ULPS)
    l1 = int(np.abs(got["hist"].astype(np.int64) - want["hist"]).sum(1).max())
    assert l1 <= 2 * n_edge, (l1, n_edge)
    out = dict(hist_l1=l1, edge=n_edge)
    for f in CLOCK_FIELDS:
        a, b = got[f].astype(np.float64), want[f].astype(np.float64)
        if exact:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            assert (np.abs(a - b) <= REL_TOL * np.abs(b)).all(), f
    a, b = got["mu_err_sum"].astype(np.float64), want["mu_err_sum"].astype(np.float64)
    out["mu_err_rel"] = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())
    assert (np.abs(a - b) <= MU_ERR_ATOL + MU_ERR_RTOL * np.abs(b)).all(), out
    excess = 0.0
    for f in ("det_mean", "det_scale", "det_pos", "det_neg"):
        a, b = got[f].astype(np.float64), want[f].astype(np.float64)
        if exact:  # every signal but the μ̂ error's bit for bit
            keep = [0, 2, 3, 4]
            np.testing.assert_array_equal(got[f][..., keep], want[f][..., keep], err_msg=f)
        excess = max(excess, float((np.abs(a - b) - DET_RTOL * np.abs(b)).max()))
    assert excess <= DET_ATOL, excess
    out["det_excess"] = excess
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_rows_equal_the_reference(runs, name):
    """The port's own draws: every round's row within the bars."""
    r = runs[name]
    assert_rows_within_bars(r["rt"]["obs_row"], r["rt"]["obs_flag"], r["tt"]["obs_row"],
                            r["tt"]["obs_flag"], r["tc"].observe, r["samples"])


@pytest.mark.parametrize("name", REF_DRAW_CASES)
def test_plain_chain_on_the_references_draws(runs, name):
    """The fold's arithmetic apart from the generators and the clock."""
    r = runs[name]
    draws = jax_draws(r["rc"], r["rp"], jax.random.PRNGKey(0), r["re"],
                      np.asarray(r["rt"]["now"]))
    te = r["te"]
    if not tsim.uses_ext(r["tc"], te):  # the paper program's columns
        draws = {k: draws[k] for k in SK.COLS}
    with _Samples() as s:
        (_, tt), = tsim.simulate_many([(r["tc"], r["tp"], prng.PRNGKey(0), te)], "cpu", [draws])
    np.testing.assert_array_equal(tt["now"].numpy(), np.asarray(r["rt"]["now"]))
    assert_rows_within_bars(r["rt"]["obs_row"], r["rt"]["obs_flag"], tt["obs_row"],
                            tt["obs_flag"], r["tc"].observe, np.asarray(s.values, np.float32),
                            exact=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_telemetry_on_equals_off(runs, name):
    """Observe on against off: every other column equal; the records' n_resp
    and histogram counts sum to the real completions (the reference's own
    assertions, tests/test_obs.py)."""
    r = runs[name]
    tt, off = r["tt"], r["off"]
    assert set(tt) - set(off) == {"obs_row", "obs_flag"}
    for k in off:
        assert torch.equal(tt[k], off[k]), k
    recs = tw.sim_records_from_trace(r["tc"].observe, tt)
    assert recs
    n_done = int((off["code"] == tsim.EV_REAL_DONE).sum())
    assert sum(x["n_resp"] for x in recs) == n_done
    assert sum(sum(x["hist"]) for x in recs) == n_done


@pytest.mark.parametrize("name", sorted(CASES))
def test_records_equal_the_reference(runs, name):
    """``sim_records_from_trace`` of the port's trace against the reference's
    records of its own: the same windows, every key but the stated classes
    equal (the detector's keys included)."""
    r = runs[name]
    ocfg = r["tc"].observe
    want = robs.windows.sim_records_from_trace(r["rc"].observe, r["rt"])
    got = tw.sim_records_from_trace(ocfg, r["tt"])
    assert len(got) == len(want) > 0
    n_edge = edge_count(r["samples"], ocfg, EDGE_ULPS)
    l1 = 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        l1 += int(np.abs(np.subtract(a["hist"], b["hist"])).sum())
        same_hist = a["hist"] == b["hist"]
        turns = max(a["turns"], 1)
        for k in a:
            va, vb = a[k], b[k]
            if k in ("mu_rel_err",):
                assert abs(va - vb) * turns <= MU_ERR_ATOL + MU_ERR_RTOL * abs(vb) * turns, k
            elif k in ("q_mean", "lam_hat", "t_start", "t_end"):
                assert abs(va - vb) <= REL_TOL * abs(vb), k
            elif k in ("throughput", "goodput", "arrival_rate", "lam_calibration"):
                # over t_end − t_start: the clocks' bar relative to the window's span
                span = max(b["t_end"] - b["t_start"], 1e-12)
                assert abs(va - vb) <= 2 * REL_TOL * b["t_end"] / span * abs(vb), k
            elif k in ("det_mean", "det_scale", "det_pos", "det_neg"):
                x, y = np.asarray(va), np.asarray(vb)
                assert (np.abs(x - y) <= DET_ATOL + DET_RTOL * np.abs(y)).all(), k
            elif k in ("p50", "p99", "p999", "mean_est", "hist") and not same_hist:
                continue
            elif isinstance(va, float) and np.isnan(va):
                assert np.isnan(vb), k
            else:
                assert va == vb, (k, va, vb, a["window"])
    assert l1 <= 2 * n_edge


def test_the_reference_test_obs_case_on_the_port():
    """tests/test_obs.py's ``test_telemetry_off_bit_exact_sim`` on the port."""
    ocfg = tobs.ObserveConfig(window_turns=32)
    scn = tenv.make("churn")
    c0, p0, _ = scn.to_sim("ppot_sq2", rounds=2000, device="cpu")
    c1, p1, _ = scn.to_sim("ppot_sq2", rounds=2000, observe=ocfg, device="cpu")
    _, tr0 = tsim.simulate(c0, p0, prng.PRNGKey(0), device="cpu")
    _, tr1 = tsim.simulate(c1, p1, prng.PRNGKey(0), device="cpu")
    assert set(tr1) - set(tr0) == {"obs_row", "obs_flag"}
    for k in tr0:
        assert torch.equal(tr0[k], tr1[k]), k
    recs = tw.sim_records_from_trace(ocfg, tr1)
    n_done = int((tr0["code"] == tsim.EV_REAL_DONE).sum())
    assert sum(r["n_resp"] for r in recs) == n_done
    assert sum(sum(r["hist"]) for r in recs) == n_done


@pytest.mark.parametrize("bins,lo,hi", [(64, 1e-3, 1e4), (7, 0.01, 50.0), (128, 1e-4, 1e3)])
def test_hist_thresholds_bin_as_the_fold(bins, lo, hi):
    """The thresholds bin every sample as ``windows._hist_fold``'s formula
    does: random service times, every threshold and its f32 neighbours,
    samples below ``hist_lo`` and above ``hist_hi``."""
    ocfg = tobs.ObserveConfig(hist_bins=bins, hist_lo=lo, hist_hi=hi)
    th = tw.hist_thresholds(ocfg)
    assert th.shape == (bins - 1,) and (np.diff(th) > 0).all() and np.isfinite(th).all()
    rng = np.random.default_rng(bins)
    r = np.concatenate([rng.exponential(1.0, 20_000), rng.lognormal(0.0, 4.0, 20_000),
                        th, np.nextafter(th, np.float32(0)), np.nextafter(th, np.float32(1e9)),
                        [0.0, lo / 10, hi, 2 * hi, 1e20]]).astype(np.float32)
    want = tw._hist_fold(ocfg, torch.zeros(bins, dtype=torch.int32), torch.from_numpy(r),
                         torch.ones(r.shape[0], dtype=torch.bool))
    got = np.bincount((r[:, None] >= th[None, :]).sum(1), minlength=bins)
    np.testing.assert_array_equal(got, want.numpy())


def test_warp_sum_order():
    """``ref.warp_sum``: the lanes' strided partial sums, then the butterfly;
    exact on integers, and the pairing the kernel makes at n = 5, 32, 45."""
    rng = np.random.default_rng(0)
    for n in (1, 5, 30, 32, 45, 204):
        x = rng.integers(0, 50, n).astype(np.float32)
        assert SR.warp_sum(x) == np.float32(x.sum())
    x = rng.random(45).astype(np.float32)
    lanes = np.zeros(32, np.float32)
    lanes[:32] = x[:32]
    lanes[:13] = lanes[:13] + x[32:]
    for d in (16, 8, 4, 2, 1):
        lanes = np.array([np.float32(lanes[i] + lanes[i ^ d]) for i in range(32)], np.float32)
    assert SR.warp_sum(x) == lanes[0]


def test_rows_from_words_layout():
    """The packed row: each group where ``row_offsets`` says, the flag after
    the i32 fields, a chain's own bins cut from the batch's."""
    HB, T = 40, 3
    W = tw.row_words(HB)
    assert W % 4 == 0 and W >= HB + len(tw.PACK_I32) + 1 + 5 + 20
    words = torch.arange(T * W, dtype=torch.int32).reshape(T, W)
    rows, flags = tw.rows_from_words(words, HB, 32)
    off = tw.row_offsets(HB)
    assert rows.hist.shape == (T, 32) and torch.equal(rows.hist, words[:, :32])
    assert torch.equal(rows.n_resp, words[:, off["i32"]])
    assert torch.equal(rows.det_count, words[:, off["i32"] + len(tw.PACK_I32) - 1])
    assert torch.equal(flags, words[:, off["i32"] + len(tw.PACK_I32)] != 0)
    assert torch.equal(rows.q_sum, words[:, off["f32"]].view(torch.float32))
    assert rows.det_neg.shape == (T, 5)
    assert torch.equal(rows.det_neg, words[:, off["det"] + 15:off["det"] + 20].view(torch.float32))


def test_mixed_batch_equals_each_chain_alone():
    """One call with chains with and without telemetry, of other windows and
    bins, gives each chain's own run: a chain without it has no rows."""
    o1 = tobs.ObserveConfig(window_turns=32, detect=tobs.DetectConfig(warmup_windows=2))
    o2 = tobs.ObserveConfig(window_turns=16, hist_bins=24)
    c, p, e = tenv.make("churn").to_sim("ppot_sq2", rounds=500, device="cpu")
    runs = [(c, p, prng.PRNGKey(0), e), (dataclasses.replace(c, observe=o1), p, prng.PRNGKey(0), e),
            (dataclasses.replace(c, observe=o2, rounds=300), p, prng.PRNGKey(1), e)]
    for (_, ta), run in zip(tsim.simulate_many(runs, "cpu"), runs):
        _, tb = tsim.simulate(*run, device="cpu")
        assert set(ta) == set(tb)
        for k in ta:
            if k == "obs_row":
                assert all(torch.equal(x, y) for x, y in zip(ta[k], tb[k]))
            else:
                assert torch.equal(ta[k], tb[k]), k
    assert "obs_row" not in tsim.simulate_many(runs[:1], "cpu")[0][1]


def test_observe_must_be_an_observe_config():
    c, p, e = tenv.make("churn").to_sim("ppot_sq2", rounds=20, device="cpu")
    with pytest.raises(TypeError, match="ObserveConfig"):
        tsim.simulate(dataclasses.replace(c, observe=object()), p, prng.PRNGKey(0), e,
                      device="cpu")


def test_obs_constants_match_the_source():
    """The kernel's copies of the telemetry's layout and configuration: the
    packed row's i32 fields (then the flag) and f32 scalars in
    ``obs.windows.PACK_I32`` / ``PACK_F32`` order, conf_o's and conf_of's
    fields as ``ref``'s, the detector's shared words and the most bins the
    wrapper allows."""
    import re

    from repro_torch.kernels.sim_chain import build as SB

    src = SB.SRC.read_text()

    def enum(first):
        body = re.search(r"enum \{ (" + first + r"[^}]*) \};", src).group(1)
        return [w.strip().split(" ")[0] for w in body.replace("\n", " ").split(",")]

    i32 = enum("R_N_RESP")
    assert [w[2:].lower() for w in i32[:-2]] == list(tw.PACK_I32)
    assert i32[-2:] == ["R_FLAG", "R_I32"]
    assert [w[2:].lower() for w in enum("R_Q_SUM")[:-1]] == list(tw.PACK_F32)
    assert enum("OBS_ON") == ["OBS_ON", "WINDOW", "BINS", "DETECT", "WARMUP", "COOLDOWN", "NO"]
    assert (SR.OBS_ON, SR.WINDOW, SR.BINS, SR.DETECT, SR.WARMUP, SR.COOLDOWN, SR.NO) == \
        tuple(range(7))
    of = enum("INV_N")
    assert of == ["INV_N", "EMA_ALPHA", "REBASE_ALPHA", "K_SIGMA", "H_SIGMA", "REL_FLOOR",
                  "ABS_FLOOR", "DECAY", "CLIP_Z", "SCALE_CLIP_Z", "NOF"]
    assert "ABS_FLOOR = REL_FLOOR + 5" in src
    assert (SR.INV_N, SR.EMA_ALPHA, SR.REBASE_ALPHA, SR.K_SIGMA, SR.H_SIGMA, SR.REL_FLOOR,
            SR.ABS_FLOOR, SR.DECAY, SR.CLIP_Z, SR.SCALE_CLIP_Z, SR.NOF) == \
        (0, 1, 2, 3, 4, 5, 10, 11, 12, 13, 14)
    assert int(re.search(r"constexpr int kMaxBins = (\d+);", src).group(1)) == SK.OBS_MAX_BINS
    assert int(re.search(r"constexpr int kNsig = (\d+);", src).group(1)) * \
        int(re.search(r"constexpr int kPackDet = (\d+);", src).group(1)) == SK.OBS_WORDS
    with pytest.raises(ValueError, match="sim_chain"):
        SK.check_shape(30, 1, 128, 64, obs_bins=SK.OBS_MAX_BINS + 1)
