"""The chain simulator's fleet mode (``SimConfig.n_frontends = S > 1`` or
``fleet_sync_every != 1``, on the CPU: the plain chain of
``kernels/sim_chain/ref.py``) against the reference's
``repro.core.simulator.simulate``, on the same seeds.

Cases: ``benchmarks/fleet_scale.py``'s cell (§6.1's 30 speeds, load 0.8,
Rosella) cut to 2,000 rounds at S in {2, 4} and ``fleet_sync_every`` in
{1, 4, 64, 0}, the herd correction off and on, on the alias stream with
the learner, the CDF stream and known speeds; tests/test_env.py's n = 4
cluster under the sticky, weighted and uniform load balancers;
tests/test_fleet.py's n = 8 cluster at S = 2, sync 16; and churn at S = 4,
sync 64, where a membership flip forces the sync.

Parity classes (as tests/test_torch_sim_env.py's):
  * the port's own draws: every integer trace column (``code``, ``worker``,
    ``n_tasks``, ``task_workers``, ``task_targets``, ``frontend``,
    ``view_gap``, ``killed``, ``killed_fake``, ``q_real``) equal to the
    reference's on every round (FIRST_INT_DIFF pins that round at the
    run's length for every case: the herd correction's Σμ and its
    ``round()``, the fleet's Σλ̂ and the learner's sums moved no decision);
    ``now``, ``lam_hat`` and ``mu_hat`` within REL_TOL; ``sync_age``, a
    difference of two clocks, within REL_TOL of the clock; the final alias
    table's thresholds within REL_TOL of one;
  * the reference's own draws fed to the plain chain: every integer column,
    ``now``, ``lam_hat`` and ``sync_age`` equal bit for bit, ``mu_hat``
    within REL_TOL;
  * S = 1 synced every round run by the fleet program equals the paper's
    own chain bit for bit;
  * the reference's own assertions on the port (load-balancer shares,
    ``fleet_summary_from_trace``, conservation), and
    ``fleet_summary_from_trace`` against the reference's function on the
    same trace: integers equal, floats within 1e-12.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import env as renv
from repro.core import metrics as rmet
from repro.core import simulator as rsim
from repro_torch import env as tenv
from repro_torch.configs import rosella_sim as TRS
from repro_torch.core import metrics as tmet
from repro_torch.core import simulator as tsim
from repro_torch.fleet import fleet_lam_hats
from repro_torch.utils import prng
from test_torch_model import reference_shim
from test_torch_sim_env import REL_TOL, as_np, assert_plain_on_reference_draws, \
    assert_trace_parity, close

TPCH = TRS.tpch_speed_set(30, 0)
MU4 = [1.0, 1.0, 2.0, 0.5]
MU8 = [0.3, 0.5, 1.0, 2.0, 1.0, 0.5, 2.0, 0.7]
#: name -> (cluster, S, sync, herd, frontend_lb, rounds, SimConfig changes)
CASES = {
    "s2_sync1": ("tpch", 2, 1, False, "uniform", 2000, {}),
    "s2_sync4": ("tpch", 2, 4, False, "uniform", 2000, {}),
    "s2_sync0_herd": ("tpch", 2, 0, True, "uniform", 2000, {}),
    "s4_sync1_herd": ("tpch", 4, 1, True, "uniform", 2000, {}),
    "s4_sync4_herd": ("tpch", 4, 4, True, "uniform", 2000, {}),
    "s4_sync64": ("tpch", 4, 64, False, "uniform", 2000, {}),
    "s4_sync64_herd": ("tpch", 4, 64, True, "uniform", 2000, {}),
    "s4_sync0": ("tpch", 4, 0, False, "uniform", 2000, {}),
    "s4_sync16_cdf": ("tpch", 4, 16, True, "uniform", 2000, dict(use_alias=False)),
    "s4_sync16_known": ("tpch", 4, 16, True, "uniform", 2000,
                        dict(use_learner=False, use_fake_jobs=False)),
    "n4_sticky": ("mu4", 4, 4, False, "sticky", 3000, {}),
    "n4_weighted": ("mu4", 4, 4, False, "weighted", 3000, {}),
    "n4_s2_sync1": ("mu4", 2, 1, False, "uniform", 3000, {}),
    "mu8_s2_sync16": ("mu8", 2, 16, False, "uniform", 4000, {}),
    "churn_s4_sync64_herd": ("churn", 4, 64, True, "uniform", 3000, {}),
}
FIRST_INT_DIFF = {name: case[5] for name, case in CASES.items()}
REF_DRAW_CASES = ("s4_sync4_herd", "n4_weighted", "n4_sticky", "churn_s4_sync64_herd",
                  "s2_sync0_herd")


def configs(rrs, name):
    """(reference cfg, params, env, port cfg, params, env) of a case."""
    cluster, S, se, herd, lb, rounds, changes = CASES[name]
    fleet = dict(n_frontends=S, fleet_sync_every=se, fleet_herd_correction=herd)
    re_ = te = None
    if cluster == "tpch":
        rc, rp = rrs.make_sim("ppot_sq2", TPCH, 0.8, rounds=rounds, **fleet)
        tc, tp = TRS.make_sim("ppot_sq2", TPCH, 0.8, rounds=rounds, device="cpu", **fleet)
    elif cluster == "churn":
        rc, rp, re_ = renv.make("churn").to_sim("ppot_sq2", rounds=rounds, **fleet)
        tc, tp, te = tenv.make("churn").to_sim("ppot_sq2", rounds=rounds, device="cpu", **fleet)
    else:
        mu = MU4 if cluster == "mu4" else MU8
        lam = 3.0 if cluster == "mu4" else 0.85 * sum(MU8)
        weights = [6.0, 1.0, 1.0, 1.0] if lb == "weighted" else None
        rc = rsim.SimConfig(n=len(mu), policy="ppot_sq2", rounds=rounds, **fleet)
        tc = tsim.SimConfig(n=len(mu), policy="ppot_sq2", rounds=rounds, **fleet)
        rp = rsim.make_params(lam=lam, mu=mu, lb_weights=weights)
        tp = tsim.make_params(lam=lam, mu=mu, lb_weights=weights, device="cpu")
    changes = dict(changes, frontend_lb=lb)
    return (dataclasses.replace(rc, **changes), rp, re_, dataclasses.replace(tc, **changes),
            tp, te)


@pytest.fixture(scope="module")
def runs():
    """Every case run once by the reference and by the port."""
    with reference_shim():
        from repro.configs import rosella_sim as rrs
    out = {}
    for name in CASES:
        rc, rp, re_, tc, tp, te = configs(rrs, name)
        seed = 3 if name.startswith("mu8") else 0
        rf, rt = rsim.simulate(rc, rp, jax.random.PRNGKey(seed), re_)
        tf, tt = tsim.simulate(tc, tp, prng.PRNGKey(seed), te, device="cpu")
        out[name] = dict(rc=rc, rp=rp, re=re_, tc=tc, tp=tp, te=te, rf=rf, rt=as_np(rt),
                         tf=tf, tt=as_np(tt), seed=seed)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_fleet_chain_equals_the_reference(runs, name):
    r = runs[name]
    assert_trace_parity(r["rt"], r["tt"], FIRST_INT_DIFF[name])
    rf, tf = r["rf"], r["tf"]
    for f in ("q_real", "q_fake", "s_real"):
        np.testing.assert_array_equal(np.asarray(getattr(rf, f)), getattr(tf, f).numpy())
    for f in ("q_snap", "q_delta", "alias_a"):
        np.testing.assert_array_equal(np.asarray(getattr(rf.fleet, f)),
                                      getattr(tf.fleet, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(rf.fleet.arr.count), tf.fleet.arr.count.numpy())
    for f in ("mu_view", "t_sync", "lam_global"):
        close(getattr(rf.fleet, f), getattr(tf.fleet, f).numpy())
    # a table's thresholds are residuals of the mean-one weights: within
    # REL_TOL of 1
    close(rf.fleet.alias_p, tf.fleet.alias_p.numpy(), atol=REL_TOL)
    close(rf.fleet.arr.last_time, tf.fleet.arr.last_time.numpy())
    close(rf.fleet.arr.mean_gap, tf.fleet.arr.mean_gap.numpy())
    close(np.asarray(rsim.flt.fleet_lam_hats(rf.fleet)), fleet_lam_hats(tf.fleet).numpy())
    S = r["tc"].n_frontends
    arr = r["tt"]["code"] == tsim.EV_ARRIVAL
    assert set(r["tt"]["frontend"][arr].tolist()) == set(range(S))
    if S > 1 and r["tc"].fleet_sync_every != 1:
        assert r["tt"]["view_gap"][arr].max() > 0  # the views go stale between syncs


@pytest.mark.parametrize("name", REF_DRAW_CASES)
def test_plain_chain_on_the_references_draws(runs, name):
    r = runs[name]
    assert r["seed"] == 0
    assert_plain_on_reference_draws(r, r["te"])


def test_s1_synced_every_round_is_the_paper_chain():
    """S = 1 synced every round, run by the fleet program (in one batch
    with a fleet chain), equals the paper's own chain bit for bit."""
    cfg, params = TRS.make_sim("ppot_sq2", TPCH, 0.8, rounds=1500, volatile_phases=3,
                               phase_period=30.0, device="cpu")
    fleet_cfg = dataclasses.replace(cfg, n_frontends=2, fleet_sync_every=8)
    (fa, ta), = tsim.simulate_many([(cfg, params, prng.PRNGKey(5))], "cpu")
    (fb, tb), (ff, _) = tsim.simulate_many(
        [(cfg, params, prng.PRNGKey(5)), (fleet_cfg, params, prng.PRNGKey(5))], "cpu")
    assert fa.fleet is None and fb.fleet is None and ff.fleet is not None
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    for f in ("now", "q_real", "q_fake", "s_real", "busy_start"):
        assert torch.equal(getattr(fa, f), getattr(fb, f)), f
    for f in ("samples", "stamps", "widx", "count", "epoch_start", "mu_hat"):
        assert torch.equal(getattr(fa.learner, f), getattr(fb.learner, f)), f
    arr = ta["code"] == tsim.EV_ARRIVAL
    assert (ta["view_gap"][arr] == 0).all() and (ta["frontend"][arr] == 0).all()


# ---------------------------------------------------------------------------
# The reference's own assertions (tests/test_env.py, tests/test_fleet.py), on
# the port
# ---------------------------------------------------------------------------


def test_lb_sticky_round_robin_exact(runs):
    tt = runs["n4_sticky"]["tt"]
    shares = np.bincount(tt["frontend"][tt["code"] == tsim.EV_ARRIVAL], minlength=4)
    assert shares.max() - shares.min() <= 1  # perfect round-robin


def test_lb_weighted_shares(runs):
    tt = runs["n4_weighted"]["tt"]
    shares = np.bincount(tt["frontend"][tt["code"] == tsim.EV_ARRIVAL], minlength=4)
    frac = shares / shares.sum()
    assert abs(frac[0] - 6.0 / 9.0) < 0.08
    assert (frac[1:] < 0.25).all()


def test_lb_uniform_default_unchanged():
    """frontend_lb defaults to uniform: the field set explicitly gives the
    same run."""
    params = tsim.make_params(lam=3.0, mu=MU4, device="cpu")
    cfg_a = tsim.SimConfig(n=4, policy="ppot_sq2", rounds=1200, n_frontends=2,
                           fleet_sync_every=4)
    cfg_b = dataclasses.replace(cfg_a, frontend_lb="uniform")
    _, tr_a = tsim.simulate(cfg_a, params, prng.PRNGKey(0), device="cpu")
    _, tr_b = tsim.simulate(cfg_b, params, prng.PRNGKey(0), device="cpu")
    for k in tr_a:
        assert torch.equal(tr_a[k], tr_b[k]), k


def test_weighted_needs_one_weight_a_frontend():
    params = tsim.make_params(lam=3.0, mu=MU4, lb_weights=[1.0, 2.0], device="cpu")
    cfg = tsim.SimConfig(n=4, policy="ppot_sq2", rounds=50, n_frontends=4,
                         frontend_lb="weighted")
    with pytest.raises(ValueError, match="lb_weights"):
        tsim.simulate(cfg, params, prng.PRNGKey(0), device="cpu")
    with pytest.raises(ValueError, match="frontend_lb"):
        tsim.simulate(dataclasses.replace(cfg, frontend_lb="random"), params,
                      prng.PRNGKey(0), device="cpu")


def test_fleet_summary_from_trace(runs):
    """tests/test_fleet.py's assertions, and the reference's function on the
    same trace: integers equal, floats within 1e-12."""
    r = runs["mu8_s2_sync16"]
    lam = 0.85 * sum(MU8)
    kw = dict(n_frontends=2, sync_every=16, lam_true=lam)
    s = tmet.fleet_summary_from_trace(
        r["tt"], lam_hat_frontends=fleet_lam_hats(r["tf"].fleet).numpy(), **kw)
    assert s["placements"] > 0
    assert 0.0 <= s["collision_rate"] <= 1.0
    assert len(s["arrival_share"]) == 2
    assert abs(sum(s["arrival_share"]) - 1.0) < 1e-6
    assert s["lam_calibration_rel_err"]["mean"] < 1.0
    assert s["staleness"]["gap_mean"] >= 0.0
    assert s["sync_age"]["max"] > 0.0
    want = rmet.fleet_summary_from_trace(
        r["tt"], lam_hat_frontends=fleet_lam_hats(r["tf"].fleet).numpy(), **kw)
    assert_same_summary(want, s)
    # the crash track's counters
    tr = runs["churn_s4_sync64_herd"]["tt"]
    crash = dict(tr, killed=np.zeros((len(tr["code"]), 5), np.int32),
                 killed_fake=np.zeros_like(tr["killed_fake"]))
    crash["killed"][10, 2], crash["killed_fake"][10] = 3, 1
    got = tmet.fleet_summary_from_trace(crash, n_frontends=4, sync_every=64)
    assert got["fault"] == {"chain_killed_tasks": 3, "chain_killed_fake": 1}
    assert_same_summary(rmet.fleet_summary_from_trace(crash, n_frontends=4, sync_every=64),
                        got)


def assert_same_summary(want, got):
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_same_summary(w, g)
        elif isinstance(w, (list, tuple)):
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(w, float), rtol=1e-12,
                                       atol=0, err_msg=k)
        elif isinstance(w, (int, np.integer)) and not isinstance(w, bool):
            assert w == g, k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=k)


def test_fleet_sim_accounting_and_partition():
    """tests/test_fleet.py's S = 4, sync 32 case: tasks conserved at the
    true worker state, arrivals on every frontend, views fresh at a sync
    round and stale between."""
    S, sync_every = 4, 32
    cfg = tsim.SimConfig(n=8, policy="ppot_sq2", rounds=6000, n_frontends=S,
                         fleet_sync_every=sync_every)
    params = tsim.make_params(lam=0.85 * sum(MU8), mu=MU8, device="cpu")
    final, trace = tsim.simulate(cfg, params, prng.PRNGKey(3), device="cpu")
    code = trace["code"].numpy()
    arr = code == tsim.EV_ARRIVAL
    tasks_in = trace["n_tasks"].numpy()[arr].sum()
    assert tasks_in == (code == tsim.EV_REAL_DONE).sum() + int(final.q_real.sum())
    assert (np.bincount(trace["frontend"].numpy()[arr], minlength=S) / arr.sum() > 0.1).all()
    gaps = trace["view_gap"].numpy()[arr]
    rows = np.nonzero(arr)[0]
    assert (gaps[rows % sync_every == 0] == 0).all()
    assert gaps[rows % sync_every != 0].max() > 0
    assert (trace["sync_age"].numpy()[arr] >= 0).all()
    lam_f = fleet_lam_hats(final.fleet).numpy()
    np.testing.assert_allclose(lam_f, 0.85 * sum(MU8) / S, rtol=0.5)


def test_churn_flip_forces_a_fleet_sync(runs):
    """Under churn at S = 4, sync 64, the membership flips at t = 120 and
    240 force a sync: the arrival right after each sees a fresh view."""
    r = runs["churn_s4_sync64_herd"]
    tt = r["tt"]
    for t_flip in (120.0, 240.0):
        row = int(np.searchsorted(tt["now"], np.float32(t_flip)))  # the flip's round
        assert row % 64 != 0
        nxt = row + int(np.argmax(tt["code"][row:] == tsim.EV_ARRIVAL))
        assert tt["sync_age"][nxt] <= tt["now"][nxt] - tt["now"][row]
    off = (tt["code"] == tsim.EV_ARRIVAL) & (tt["now"] >= 120.0) & (tt["now"] < 240.0)
    assert off.sum() > 0 and (tt["task_workers"][off] != 1).all()
    assert tmet.analyze(tt, 5).killed_jobs == 0
    assert r["tf"].crash_i.item() == 0


def test_sim_chain_shape_limit_with_frontends():
    """``kernel.check_shape`` takes every environment and fleet chain of
    chip_smoke.py ([sim fleet], [sim env], the check chains) with a tile of
    at least one round, and refuses the first n past the limit at a ring of
    128 with four frontends (205) with a message naming the fleet state."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels.sim_chain import kernel as SK

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_ext_shapes", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    runs = [run for cases in cs.sim_ext_check_groups(TRS, tenv, "cpu").values()
            for _, run in cases] + cs.sim_fleet_runs(TRS, "cpu")
    assert {run[0].n for run in runs} == {5, 30}
    for run in runs:
        cfg = run[0]
        kw = dict(J=2 * cfg.max_tasks, trace_queues=cfg.trace_queues, trace_mu=cfg.trace_mu,
                  frontends=cfg.n_frontends)
        SK.check_shape(cfg.n, cfg.max_tasks, cfg.ring_cap, cfg.arrival_window, **kw)
        stride = SK.ring_stride(cfg.n, cfg.max_tasks, cfg.ring_cap, cfg.arrival_window, **kw)
        assert SK.tile_rounds(60_000, cfg.n, cfg.max_tasks, cfg.ring_cap, cfg.arrival_window,
                              stride=stride, **kw) >= 1
    first = next(n for n in range(150, 300)
                 if SK.smem_bytes(n, 1, 128, 64, frontends=4) > SK.SMEM_LIMIT)
    assert first == 205
    SK.check_shape(first - 1, 1, 128, 64, frontends=4)
    with pytest.raises(ValueError, match="sim_chain.*fleet state"):
        SK.check_shape(first, 1, 128, 64, frontends=4)
    cfg, params = TRS.make_sim("ppot_sq2", np.ones(first), 0.5, rounds=5, n_frontends=4,
                               fleet_sync_every=4, device="cpu")
    with pytest.raises(ValueError, match="sim_chain"):
        tsim.simulate(cfg, params, prng.PRNGKey(0), device="cpu")
