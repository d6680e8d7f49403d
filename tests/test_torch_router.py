"""The serving turn as a whole: the port's RosellaRouter + run_simulation
against the reference's, on the CPU at n=32 replicas, arrival batches of 8,
with the SequentialPool.

(i) Teacher-forced: before every turn the reference router's state is
exported as numpy and loaded into the port (``convert``); both then run the
same ``serve_turn``. Routing reads the imported μ̂ snapshot, so the
benchmark draws, the routed workers and the queue view are exact; the
learner rings are exact; μ̂ is within the learner's stated ulps.
(ii) Free-running: both from the same seed, with nothing shared.
"""
import numpy as np
import pytest
import torch

from repro.core import learner as rlrn
from repro.serving import router as jr
from repro_torch import convert
from repro_torch.configs.rosella_sim import tpch_speed_set
from repro_torch.core import metrics as tmet
from repro_torch.serving import router as tr

N, BATCH = 32, 8
SPEEDS = tpch_speed_set(N, 0)
MU_BAR = float(SPEEDS.sum())
RATE = 0.7 * MU_BAR
LEARNER_FIELDS = ("samples", "stamps", "widx", "count", "epoch_start", "mu_hat")
MU_ULPS = 8  # as in test_torch_learner: refresh_estimates' mean is a float sum
MIN_EXACT_MU_TURNS = 10  # free-running μ̂ is bit-equal at least this long


def ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def export_router(r: jr.RosellaRouter) -> dict:
    """A reference router's state as numpy, in ``convert``'s names."""
    d = {
        "q_view": np.asarray(r.q_view),
        "arr.last_time": np.asarray(r.arr.last_time),
        "arr.mean_gap": np.asarray(r.arr.mean_gap),
        "arr.count": np.asarray(r.arr.count),
        "mu_front": np.asarray(r.mu_front),
        "key": np.asarray(r.key),
        "last_fake_time": r.last_fake_time,
        "mu_pending": None if r._mu_pending is None else np.asarray(r._mu_pending),
        "active": None if r.active is None else np.asarray(r.active),
    }
    for f in LEARNER_FIELDS:
        d[f"learner.{f}"] = np.asarray(getattr(r.learner, f))
    if r.table_front is not None:
        d["table.prob"] = np.asarray(r.table_front.prob)
        d["table.alias"] = np.asarray(r.table_front.alias)
    return d


def _flush(p_done, p_rep, p_start, t):
    due = p_done <= t
    if not due.any():
        return None, None, t, (p_done, p_rep, p_start)
    order = np.argsort(p_done[due], kind="stable")
    cw, ct = p_rep[due][order], (p_done - p_start)[due][order]
    return cw, ct, float(p_done[due].max()), (p_done[~due], p_rep[~due], p_start[~due])


def _assert_same_state(ref: jr.RosellaRouter, port: tr.RosellaRouter):
    np.testing.assert_array_equal(port.q_view.numpy(), np.asarray(ref.q_view))
    for f in ("samples", "stamps", "widx", "count", "epoch_start"):
        np.testing.assert_array_equal(getattr(port.learner, f).numpy(),
                                      np.asarray(getattr(ref.learner, f)), err_msg=f)
    a, b = np.asarray(ref.learner.mu_hat), port.learner.mu_hat.numpy()
    np.testing.assert_array_equal(a == 0, b == 0)
    assert ulps(a, b) <= MU_ULPS
    assert np.float32(ref.arr.mean_gap) == port.arr.mean_gap
    assert tuple(int(k) for k in np.asarray(ref.key)) == port.key


@pytest.mark.parametrize("use_alias", [True, False])
def test_teacher_forced_turns_match_reference(use_alias):
    ref = jr.RosellaRouter(N, MU_BAR, seed=1, async_mu=True, use_alias=use_alias)
    port = tr.RosellaRouter(N, MU_BAR, seed=1, async_mu=True, use_alias=use_alias,
                            device="cpu")
    pool = jr.SequentialPool(SPEEDS)
    rng = np.random.RandomState(1)
    p_done, p_rep, p_start = np.empty(0), np.empty(0, np.int32), np.empty(0)
    t = 0.0
    for turn in range(220):
        if turn == 150:  # one freak flush through the overflow path
            extra = rng.randint(0, N, tr.SERVE_COMP_CAP + 40).astype(np.int32)
            p_rep = np.concatenate([p_rep, extra])
            p_start = np.concatenate([p_start, np.full(len(extra), t)])
            p_done = np.concatenate([p_done, t + rng.exponential(0.01, len(extra))])
        times = t + np.cumsum(rng.exponential(1.0 / RATE, BATCH))
        t = float(times[-1])
        cw, ct, cnow, (p_done, p_rep, p_start) = _flush(p_done, p_rep, p_start, t)
        _sync_flip(ref)
        convert.load_router_state(port, export_router(ref))
        f_ref, w_ref = ref.serve_turn(t, BATCH, cw, ct, cnow)
        f_port, w_port = port.serve_turn(t, BATCH, cw, ct, cnow)
        np.testing.assert_array_equal(f_port, f_ref, err_msg=f"turn {turn}")
        np.testing.assert_array_equal(w_port, w_ref, err_msg=f"turn {turn}")
        _assert_same_state(ref, port)
        for js, arrive, cost in ((f_ref, np.full(len(f_ref), t), 0.25),
                                 (w_ref, times, None)):
            if not len(js):
                continue
            costs = rng.exponential(1.0, len(js)) if cost is None else np.full(len(js), cost)
            s, d = pool.submit_batch(js, arrive, costs)
            p_done = np.concatenate([p_done, d])
            p_rep = np.concatenate([p_rep, js.astype(np.int32)])
            p_start = np.concatenate([p_start, s])


def _mass(table) -> np.ndarray:
    prob = np.asarray(table.prob, np.float64)
    m = prob.copy()
    np.add.at(m, np.asarray(table.alias), 1.0 - prob)
    return m / len(prob)


def _sync_flip(ref: jr.RosellaRouter):
    """Make the reference's async μ̂ flip deterministic: wait, then flip."""
    if ref._mu_pending is not None:
        ref._mu_pending.block_until_ready()
        ref._flip_mu()


@pytest.mark.parametrize("use_alias", [True, False])
def test_set_membership_matches_reference(use_alias):
    """Membership changes mid-run: the learner's rejoin reset, the masked
    table (its sampled distribution, as in test_torch_dispatch) and masked
    routing, teacher-forced (CDF batches take the select kernel's plain
    version; alias batches the masked table)."""
    ref = jr.RosellaRouter(N, MU_BAR, seed=2, async_mu=True, use_alias=use_alias)
    port = tr.RosellaRouter(N, MU_BAR, seed=2, async_mu=True, use_alias=use_alias,
                            device="cpu")
    jr.run_simulation(ref, jr.SequentialPool(SPEEDS), arrival_rate=RATE,
                      horizon=8.0, seed=2, arrival_batch=BATCH)
    _sync_flip(ref)
    convert.load_router_state(port, export_router(ref))
    rng = np.random.RandomState(2)
    for step, frac in enumerate((0.2, 0.0)):
        act = rng.rand(N) >= frac
        rj_ref = ref.set_membership(act, 10.0 + step)
        rj_port = port.set_membership(act, 10.0 + step)
        np.testing.assert_array_equal(rj_port, rj_ref)
        _assert_same_state(ref, port)
        if use_alias:
            np.testing.assert_allclose(_mass(port.table_front), _mass(ref.table_front),
                                       rtol=0, atol=1e-6)
            assert act[port.table_front.alias.numpy()].all()
        for k in range(3):
            _sync_flip(ref)
            convert.load_router_state(port, export_router(ref))
            now = 10.5 + step + 0.1 * k
            f_ref, w_ref = ref.serve_turn(now, BATCH)
            f_port, w_port = port.serve_turn(now, BATCH)
            np.testing.assert_array_equal(w_port, w_ref)
            np.testing.assert_array_equal(f_port, f_ref)
            assert act[w_port].all() and act[f_port].all()


@pytest.mark.parametrize("use_alias", [True, False])
def test_route_complete_and_benchmark_calls_match_reference(use_alias):
    """The router's separate calls (the per-call form of a turn):
    complete_arrays, benchmark_requests and route, teacher-forced."""
    ref = jr.RosellaRouter(N, MU_BAR, seed=3, async_mu=False, use_alias=use_alias)
    port = tr.RosellaRouter(N, MU_BAR, seed=3, async_mu=False, use_alias=use_alias,
                            device="cpu")
    jr.run_simulation(ref, jr.SequentialPool(SPEEDS), arrival_rate=RATE,
                      horizon=6.0, seed=3, arrival_batch=BATCH)
    rng = np.random.RandomState(3)
    now = 7.0
    for _ in range(5):
        convert.load_router_state(port, export_router(ref))
        w = rng.randint(0, N, 20).astype(np.int32)
        ts = rng.exponential(1.0, 20).astype(np.float32)
        ref.complete_arrays(w, ts, now)
        port.complete_arrays(w, ts, now)
        _assert_same_state(ref, port)
        convert.load_router_state(port, export_router(ref))
        now += 0.4
        np.testing.assert_array_equal(port.benchmark_requests(now),
                                      ref.benchmark_requests(now))
        ref._flip_mu()  # route on the reference's table: load it after the flip
        convert.load_router_state(port, export_router(ref))
        np.testing.assert_array_equal(port.route(now, BATCH), ref.route(now, BATCH))
        np.testing.assert_array_equal(port.q_view.numpy(), np.asarray(ref.q_view))
        assert np.float32(ref.arr.mean_gap) == port.arr.mean_gap


def _free_run(mod, seed, use_alias, horizon):
    kw = {} if mod is jr else {"device": "cpu"}
    r = mod.RosellaRouter(N, MU_BAR, seed=seed, async_mu=False, use_alias=use_alias, **kw)
    return mod.run_simulation(r, mod.SequentialPool(SPEEDS), arrival_rate=RATE,
                              horizon=horizon, seed=seed, arrival_batch=BATCH)


@pytest.mark.parametrize("use_alias", [True, False])
def test_free_running_matches_reference(use_alias):
    """Same seed, nothing shared, async_mu=False (the deterministic mode).
    Every turn before the first μ̂ divergence is exact. μ̂ was measured to
    first differ (in its last bits) at turn 12 with alias tables and turn
    14 without, and the responses stayed equal through all 238 turns; the
    test holds μ̂ to at least 10 exact turns and the responses to all of
    them. p50/p99 over the run stay within 3 standard deviations of the
    reference's own spread over 5 seeds."""
    horizon = 250 * BATCH / RATE  # about 250 turns
    r_ref, mu_ref = _free_run(jr, 0, use_alias, horizon)
    r_port, mu_port = _free_run(tr, 0, use_alias, horizon)
    T = min(len(mu_ref), len(mu_port))
    assert T >= 230
    mu_div = next((i for i in range(T) if not np.array_equal(mu_ref[i], mu_port[i])), T)
    w_div = next((i for i in range(T) if not np.array_equal(
        r_ref[i * BATCH:(i + 1) * BATCH], r_port[i * BATCH:(i + 1) * BATCH])), T)
    print(f"use_alias={use_alias}: first mu divergence at turn {mu_div}, "
          f"first response divergence at turn {w_div} of {T}")
    assert mu_div >= MIN_EXACT_MU_TURNS
    assert w_div == T
    spread = np.array([
        [tmet.serve_summary(_free_run(jr, s, use_alias, horizon)[0])[p]
         for p in ("p50", "p99")] for s in range(1, 6)])
    tol = 3 * spread.std(axis=0)
    got, want = tmet.serve_summary(r_port), tmet.serve_summary(r_ref)
    for p, tl in zip(("p50", "p99"), tol):
        assert abs(got[p] - want[p]) <= tl, (p, got[p], want[p], tl)


def test_router_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.RosellaRouter(N, MU_BAR)
    from repro_torch.core import learner as tlrn

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlrn.init_learner(N, tlrn.default_learner_config(MU_BAR))


def test_router_rejects_policies_not_ported():
    with pytest.raises(NotImplementedError, match="not ported"):
        tr.RosellaRouter(N, MU_BAR, policy=tr.pol.PSS, device="cpu")


def test_serve_summary_matches_reference():
    from repro.core import metrics as rmet

    rng = np.random.RandomState(0)
    resp, mu = rng.exponential(2.0, 500), rng.rand(7, N)
    assert tmet.serve_summary(resp, mu) == rmet.serve_summary(resp, mu)


def test_learner_config_defaults_match_reference():
    r, t = rlrn.default_learner_config(MU_BAR), tr.lrn.default_learner_config(MU_BAR)
    assert (np.float32(r.mu_bar), np.float32(r.c0), np.float32(r.c_window),
            r.window_mode, r.ring_cap) == (t.mu_bar, t.c0, t.c_window,
                                           t.window_mode, t.ring_cap)
