"""The port's frontend fleet on the host (``repro_torch.fleet``,
``serving.router.FleetRouter``, ``run_fleet_simulation``,
``core.metrics.fleet_summary``) against the JAX package's, on the CPU at
tests/test_fleet_scan.py's sizes (n = 4, speeds 0.25/0.5/1/2, arrivals at
3/s for 80 s, batches of 8) and tests/test_fleet.py's (n = 8).

The bars:
  * the herd model, the accounting, the simulator's stacked state and its
    sync fold: equal to the reference's, element for element (float32
    arithmetic in the same order; ``round`` half to even in torch, numpy
    and jax alike);
  * ``run_fleet_simulation`` against the reference's, nothing shared:
    responses, placements, epochs and sync gaps equal on every turn, μ̂
    exact until the turn at which a learner's float sum parts the two
    (``EXACT_MU_TURNS``, measured at these sizes) and within ``MU_ULPS``
    after, the router's bars (tests/test_torch_router.py);
  * the port's own contracts: S = 1 bit-equal to ``run_simulation``, a
    herd gain vector of ones equal to ``True``, a zeroed gain changing the
    routing.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import metrics as jmet  # before repro.fleet: the reference's import order
from repro.fleet import conflict as jcf
from repro.fleet import state as jst
from repro.fleet import sync as jsy
from repro.serving import router as jr
from repro_torch import fleet as tfl
from repro_torch.core import metrics as tmet
from repro_torch.serving import router as tr

SPEEDS = np.array([0.25, 0.5, 1.0, 2.0])
KW = dict(arrival_rate=3.0, horizon=80.0, seed=1, arrival_batch=8)
SPEEDS8 = np.array([0.25, 0.5, 1.0, 2.0, 1.0, 0.5, 2.0, 1.0])
MU_ULPS = 8  # the learner's refresh sums, as tests/test_torch_router.py
HERD_ULPS = 4  # the herd model's Σ μ̂, summed by torch and XLA in their own orders
#: the turn at which the port's μ̂ trace parts from the reference's in the
#: last bits, measured at (S, sync_every); the responses stay equal
EXACT_MU_TURNS = {(2, 1): 5, (4, 1): 9, (2, 4): 7, (4, 4): 9}


def ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _first_mu_divergence(mu_a, mu_b) -> int:
    return next((i for i in range(len(mu_a)) if not np.array_equal(mu_a[i], mu_b[i])),
                len(mu_a))


def _fleet(S, **kw):
    return (tr.FleetRouter(S, 4, mu_bar=SPEEDS.sum(), seed=0, async_mu=False, device="cpu",
                           **kw), tr.SequentialPool(SPEEDS))


def _ref_fleet(S, **kw):
    return jr.FleetRouter(S, 4, mu_bar=SPEEDS.sum(), seed=0, async_mu=False, **kw), \
        jr.SequentialPool(SPEEDS)


# ---------------------------------------------------------------------------
# the herd model and the accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_expected_peer_placements_equal_the_reference(S, grid):
    """Random μ̂ views (zeros and negatives among them), λ̂ and Δt, host
    scalars and 0-d tensors: the expected peer load and the corrected view
    equal the reference's bit for bit where Σ μ̂ is exact (μ̂ on a 2^-8
    grid); elsewhere torch and XLA sum μ̂ in different orders and the load
    is within HERD_ULPS of the reference's (measured: 2)."""
    rng = np.random.default_rng(S)
    for trial in range(20):
        n = int(rng.integers(1, 40))
        mu = (rng.random(n) * 4 - 0.5).astype(np.float32)
        if grid:
            mu = np.round(mu * 256) / np.float32(256)
        if trial % 5 == 0:
            mu[:] = 0.0
        lam, dt = float(rng.random() * 50), float(rng.random() * 30 - 2)
        want = np.asarray(jcf.expected_peer_placements(lam, dt, jnp.asarray(mu), S))
        got = tfl.expected_peer_placements(lam, dt, torch.from_numpy(mu), S)
        assert got.dtype == torch.float32
        got_t = tfl.expected_peer_placements(torch.tensor(np.float32(lam)),
                                             torch.tensor(np.float32(dt)),
                                             torch.from_numpy(mu), S)
        np.testing.assert_array_equal(got_t.numpy(), got.numpy())
        if not grid:
            assert ulps(got.numpy(), want) <= HERD_ULPS
            continue
        np.testing.assert_array_equal(got.numpy(), want)
        view = rng.integers(0, 20, n).astype(np.int32)
        np.testing.assert_array_equal(
            tfl.herd_corrected_view(torch.from_numpy(view), lam, dt, torch.from_numpy(mu),
                                    S).numpy(),
            np.asarray(jcf.herd_corrected_view(jnp.asarray(view), lam, dt, jnp.asarray(mu), S)))
    if S == 1:
        assert float(tfl.expected_peer_placements(2.0, 3.0, torch.ones(4), 1).sum()) == 0.0


def test_rounding_is_half_to_even_everywhere():
    """The host router rounds the correction in numpy, the fleet turn in
    torch, the reference in jax: all three round half to even."""
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 1e6 + 0.5], np.float32)
    want = np.asarray(jnp.round(jnp.asarray(x)))
    np.testing.assert_array_equal(np.round(x), want)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(), want)


def test_collision_accounting_equals_the_reference():
    fr = np.array([0, 1, 0, 0, 1])
    w = np.array([3, 3, 1, 3, 2])
    ep = np.array([0, 0, 0, 1, 1])
    s = tfl.collision_stats(fr, w, ep)
    assert s == {"placements": 5, "collision_rate": 2 / 5, "contested_cells": 1}
    rng = np.random.default_rng(0)
    for P in (0, 1, 50, 500):
        args = (rng.integers(0, 4, P), rng.integers(0, 9, P), rng.integers(0, 6, P))
        assert tfl.collision_stats(*args) == jcf.collision_stats(*args)
    for S, mu in ((1, None), (2, None), (8, None), (4, np.array([1.0, 2.0, 0.0, 5.0]))):
        assert (tfl.expected_collision_rate(S, 4.0, 4, 1.5, mu)
                == jcf.expected_collision_rate(S, 4.0, 4, 1.5, mu))
    assert 0.0 < tfl.expected_collision_rate(2, 4.0, 8, 1.0) \
        < tfl.expected_collision_rate(8, 4.0, 8, 1.0) < 1.0


# ---------------------------------------------------------------------------
# the simulator's stacked state and its sync fold
# ---------------------------------------------------------------------------


def _same_sim_state(t: tfl.FleetSimState, j) -> None:
    for f in ("q_snap", "q_delta", "mu_view", "alias_p", "alias_a", "t_sync", "lam_global"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    for f in ("last_time", "mean_gap", "count"):
        np.testing.assert_array_equal(getattr(t.arr, f).numpy(), np.asarray(getattr(j.arr, f)),
                                      err_msg=f)


@pytest.mark.parametrize("masked", [False, True])
def test_fleet_sim_state_and_sync_equal_the_reference(masked):
    """``init_fleet_sim``, per-frontend arrivals and placements, the views,
    tables and λ̂s, then ``sync_sim_views`` (masked under churn): every
    field equal to the reference's."""
    S, n = 3, 6
    mu0 = np.array([1.0, 0.5, 2.0, 0.0, 1.5, 0.25], np.float32)
    t = tfl.init_fleet_sim(S, n, torch.from_numpy(mu0), device="cpu")
    j = jst.init_fleet_sim(S, n, jnp.asarray(mu0))
    _same_sim_state(t, j)
    rng = np.random.default_rng(1)
    now = 0.0
    for step in range(12):
        f = int(rng.integers(0, S))
        now += float(rng.exponential(0.3))
        m = int(rng.integers(1, 5))
        counts = rng.integers(0, 3, n).astype(np.int32)
        t = tfl.fold_own_placements(tfl.observe_frontend_arrival(t, f, now, m), f,
                                    torch.from_numpy(counts))
        j = jst.fold_own_placements(jst.observe_frontend_arrival(j, f, jnp.float32(now), m), f,
                                    jnp.asarray(counts))
        _same_sim_state(t, j)
        np.testing.assert_array_equal(tfl.frontend_view(t, f).numpy(),
                                      np.asarray(jst.frontend_view(j, f)))
    np.testing.assert_array_equal(tfl.fleet_lam_hats(t).numpy(),
                                  np.asarray(jst.fleet_lam_hats(j)))
    tb, jb = tfl.frontend_table(t, 1), jst.frontend_table(j, 1)
    np.testing.assert_array_equal(tb.prob.numpy(), np.asarray(jb.prob))
    np.testing.assert_array_equal(tb.alias.numpy(), np.asarray(jb.alias))
    q_true = rng.integers(0, 9, n).astype(np.int32)
    mu_c = np.round(rng.random(n) * 768).astype(np.float32) / 256  # exact sums
    act = np.array([True, True, False, True, False, True]) if masked else None
    t2 = tfl.sync_sim_views(t, torch.from_numpy(q_true), torch.from_numpy(mu_c), now,
                            None if act is None else torch.from_numpy(act))
    j2 = jsy.sync_sim_views(j, jnp.asarray(q_true), jnp.asarray(mu_c), jnp.float32(now),
                            None if act is None else jnp.asarray(act))
    _same_sim_state(t2, j2)
    if masked:
        p = t2.alias_p.numpy()
        assert (p[:, ~act] == 0).all()


# ---------------------------------------------------------------------------
# FleetRouter and run_fleet_simulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_alias", [True, False])
def test_s1_fleet_is_bit_equal_to_run_simulation(use_alias):
    """S = 1 serving is the single-frontend loop bit for bit (the same
    streams, every sync a numeric no-op), at any sync cadence."""
    kw = dict(arrival_rate=4.0, horizon=120.0, seed=0, arrival_batch=16)
    r1 = tr.RosellaRouter(8, mu_bar=SPEEDS8.sum(), seed=0, async_mu=False, use_alias=use_alias,
                          device="cpu")
    resp1, mu1 = tr.run_simulation(r1, tr.SimulatedPool(SPEEDS8), **kw)
    rf = tr.FleetRouter(1, 8, mu_bar=SPEEDS8.sum(), seed=0, async_mu=False,
                        use_alias=use_alias, device="cpu")
    respf, muf, info = tr.run_fleet_simulation(rf, tr.SimulatedPool(SPEEDS8), sync_every=4,
                                               **kw)
    np.testing.assert_array_equal(resp1, respf)
    np.testing.assert_array_equal(mu1, muf)
    assert info["turns"] == len(mu1) > 0 and info["sync_gaps"].shape == (0, 1)
    assert r1.key == rf.frontends[0].key


@pytest.mark.parametrize("S,sync_every", sorted(EXACT_MU_TURNS))
def test_run_fleet_simulation_matches_the_reference(S, sync_every):
    """The port's host fleet loop against the reference's, nothing shared:
    responses equal on every turn, the placement log and sync gaps equal,
    μ̂ exact until EXACT_MU_TURNS and within MU_ULPS after, the λ̂s and
    the agreed snapshot equal."""
    rt_, pt = _fleet(S)
    resp_t, mu_t, it = tr.run_fleet_simulation(rt_, pt, sync_every=sync_every, **KW)
    rj, pj = _ref_fleet(S)
    resp_j, mu_j, ij = jr.run_fleet_simulation(rj, pj, sync_every=sync_every, **KW)
    T = it["turns"]
    assert T == ij["turns"] == len(mu_t) > EXACT_MU_TURNS[(S, sync_every)]
    for i in range(T):
        np.testing.assert_array_equal(resp_t[i * 8:(i + 1) * 8], resp_j[i * 8:(i + 1) * 8],
                                      err_msg=f"turn {i}")
    for key in ("frontends", "workers", "epochs", "sync_gaps", "lam_hats"):
        np.testing.assert_array_equal(it[key], ij[key], err_msg=key)
    assert _first_mu_divergence(mu_t, mu_j) == EXACT_MU_TURNS[(S, sync_every)]
    np.testing.assert_array_equal(mu_t == 0, mu_j == 0)
    assert ulps(mu_t, mu_j) <= MU_ULPS
    np.testing.assert_array_equal(rt_._snap, rj._snap)
    np.testing.assert_array_equal(pt.free_at, pj.free_at)
    assert it["sync_gaps"].shape[0] == -(-T // sync_every) and it["sync_gaps"].sum() > 0


def test_sync_reconciles_views_as_the_reference():
    """After turns on split views, ``sync`` makes every frontend adopt the
    delta-rebuilt global view, merges μ̂ and sums the λ̂ streams; the gaps
    and the global view equal the reference's."""
    S = 3
    rt_ = tr.FleetRouter(S, 8, mu_bar=float(SPEEDS8.sum()), seed=1, async_mu=False,
                         device="cpu")
    rj = jr.FleetRouter(S, 8, mu_bar=float(SPEEDS8.sum()), seed=1, async_mu=False)
    for turn in range(3):
        for f in range(S):
            a, b = rt_.serve_turn(f, 1.0 + turn, 4), rj.serve_turn(f, 1.0 + turn, 4)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    qs = np.stack([fr.q_view.numpy() for fr in rt_.frontends])
    assert (qs != qs[0]).any()  # stale: each frontend sees only its own work
    it, ij = rt_.sync(4.0), rj.sync(4.0)
    qs2 = np.stack([fr.q_view.numpy() for fr in rt_.frontends])
    assert (qs2 == qs2[0]).all() and qs2[0].sum() == qs.sum()
    for key in ("view_gaps", "lam_f", "global_q", "rejoined"):
        np.testing.assert_array_equal(it[key], ij[key], err_msg=key)
    mus = [fr.mu_front.numpy() for fr in rt_.frontends]
    for m in mus[1:]:
        np.testing.assert_array_equal(mus[0], m)
    assert ulps(mus[0], np.asarray(rj.frontends[0].mu_front)) <= MU_ULPS
    assert rt_.lam_global == pytest.approx(rt_.lam_hats.sum(), rel=1e-6)
    np.testing.assert_array_equal(rt_.mu_hat, np.stack([fr.learner.mu_hat.numpy()
                                                        for fr in rt_.frontends]).mean(0))
    # a membership mask rejoins through every learner and masks the one table
    act = np.array([True, False, True, True, False, True, True, True])
    rt_.sync(5.0, active=act)
    out = rt_.sync(6.0, active=np.ones(8, bool))
    np.testing.assert_array_equal(out["rejoined"], [1, 4])
    assert all(bool(fr.active.all()) for fr in rt_.frontends)


def test_herd_correction_biases_views_and_its_gains():
    """With herd correction on, a frontend's view carries the expected peer
    load (∝ μ̂) on top of its own work, as the reference's does; a gain
    vector of ones equals ``True`` bit for bit, a zeroed gain changes the
    routing, a wrong length raises."""
    S = 4
    rt_ = tr.FleetRouter(S, 8, mu_bar=float(SPEEDS8.sum()), seed=0, async_mu=False,
                         herd_correction=True, device="cpu")
    rj = jr.FleetRouter(S, 8, mu_bar=float(SPEEDS8.sum()), seed=0, async_mu=False,
                        herd_correction=True)
    for r in (rt_, rj):
        r.sync(0.0)
        for f in range(S):
            r.serve_turn(f, 1.0, 4)
            r.serve_turn(f, 2.0, 4)
    q_before = rt_.frontends[0].q_view.numpy().copy()
    rt_.serve_turn(0, 20.0, 4)
    rj.serve_turn(0, 20.0, 4)
    q_after = rt_.frontends[0].q_view.numpy()
    assert q_after.sum() - q_before.sum() - 4 > 0
    np.testing.assert_array_equal(q_after, np.asarray(rj.frontends[0].q_view))
    np.testing.assert_array_equal(rt_._herd_applied, rj._herd_applied)

    runs = {}
    for label, gains in (("true", True), ("ones", [1.0, 1.0]), ("zeroed", [1.0, 0.0])):
        r, p = _fleet(2, herd_correction=gains)
        runs[label] = tr.run_fleet_simulation(r, p, sync_every=4, **KW)
    np.testing.assert_array_equal(runs["true"][0], runs["ones"][0])
    np.testing.assert_array_equal(runs["true"][1], runs["ones"][1])
    assert not np.array_equal(runs["true"][0], runs["zeroed"][0])
    rj2, pj2 = _ref_fleet(2, herd_correction=[1.0, 0.0])
    np.testing.assert_array_equal(
        runs["zeroed"][0], jr.run_fleet_simulation(rj2, pj2, sync_every=4, **KW)[0])
    with pytest.raises(ValueError, match="herd_correction"):
        tr.FleetRouter(2, 4, mu_bar=SPEEDS.sum(), herd_correction=[1.0, 1.0, 1.0],
                       device="cpu")


def test_run_fleet_simulation_rejects_a_batch_smaller_than_the_fleet():
    r, p = _fleet(4)
    with pytest.raises(ValueError, match="must be >= S"):
        tr.run_fleet_simulation(r, p, arrival_rate=3.0, horizon=10.0, arrival_batch=2)


def test_fleet_router_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.FleetRouter(2, 4, mu_bar=3.75)


# ---------------------------------------------------------------------------
# fleet_summary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [2, 4])
def test_fleet_summary_equals_the_reference(S):
    """tests/test_fleet.py's multi-frontend run at n = 8 through the port:
    every request routed, all frontends in the log, staleness populated,
    collisions seen; ``fleet_summary`` of the port's info equal to the
    reference's of the same info, and of the reference's own run."""
    kw = dict(arrival_rate=4.0, horizon=100.0, seed=0, arrival_batch=16, sync_every=4)
    rt_ = tr.FleetRouter(S, 8, mu_bar=float(SPEEDS8.sum()), seed=0, async_mu=False,
                         device="cpu")
    resp, _, info = tr.run_fleet_simulation(rt_, tr.SimulatedPool(SPEEDS8), **kw)
    assert resp.size == info["frontends"].size == info["workers"].size
    assert set(np.unique(info["frontends"])) == set(range(S))
    assert np.isfinite(resp).all() and info["sync_gaps"].size > 0
    ledger = {"n_tasks": 10, "copies_real_launched": 12, "lost_tasks": 1,
              "copies_real_killed": 2, "n_retries": 1, "n_dirty_completions": 1,
              "n_timeouts": 0, "conserved": True}
    args = (info["frontends"], info["workers"], info["epochs"])
    kws = dict(n_frontends=S, lam_hat_frontends=info["lam_hats"], lam_true=4.0,
               view_gaps=info["sync_gaps"], sync_ages=np.linspace(0.0, 3.0, 7), ledger=ledger)
    s = tmet.fleet_summary(*args, **kws)
    assert s == jmet.fleet_summary(*args, **kws)
    assert s["collision_rate"] > 0.0 and s["lam_fleet_rel_err"] < 0.6
    assert tmet.fleet_summary(np.empty(0), np.empty(0), np.empty(0), n_frontends=S)[
        "placements"] == 0
    rj = jr.FleetRouter(S, 8, mu_bar=float(SPEEDS8.sum()), seed=0, async_mu=False)
    _, _, ij = jr.run_fleet_simulation(rj, jr.SimulatedPool(SPEEDS8), **kw)
    del kws["ledger"], kws["sync_ages"]
    kws.update(lam_hat_frontends=ij["lam_hats"], view_gaps=ij["sync_gaps"])
    assert (tmet.fleet_summary(*args, **kws)
            == jmet.fleet_summary(ij["frontends"], ij["workers"], ij["epochs"], **kws))
