"""The port's one-program serving loop (``repro_torch.serving.scanloop``)
on the CPU, where the turn runs eagerly:

(i) the device forms of the turn's modules against their host forms, bit
for bit: the turn math (``serve_step_device`` against ``serve_step``,
turns without completions included) and the pool chain's plain version,
which is also held to the reference's ``pstep`` recurrence;
(ii) the five tests of ``tests/test_scanloop.py`` against the port's host
loop: exact on both probe streams with ``SequentialPool`` and
``async_mu=False``, alias against inverse-CDF statistically, overflow
raised and counted, the empty horizon;
(iii) the port's scan against the reference's ``run_simulation_scan`` and
``run_workload_scan`` (churn columns built by hand), under a jax-0.9 alias
of ``jax.experimental.enable_x64`` that the fixture sets and removes:
responses equal on every turn, μ̂ exact for at least MIN_EXACT_MU_TURNS
turns and within MU_ULPS after, the bars of ``test_torch_router.py``;
(iv) chunked equal to unchunked, ``auto_chunk_turns`` equal to the
reference's, and churn placements only on active replicas.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import router as jr
from repro_torch.core import estimator as test_
from repro_torch.core import learner as tlrn
from repro_torch.core import scheduler as tsch
from repro_torch.kernels.pool_chain import kernel as CK
from repro_torch.kernels.pool_chain import ref as CR
from repro_torch.serving import router as tr
from repro_torch.serving import scanloop as tsl
from repro_torch.utils import prng

SPEEDS = np.array([0.25, 0.5, 1.0, 2.0])
MU_ULPS = 8  # test_torch_learner / test_torch_router: refresh_estimates' float sum
MIN_EXACT_MU_TURNS = 10  # at the router test's shape (n=32)
CHURN_EXACT_MU_TURNS = 6  # at _churn_workload's (n=8)
# at the reference test's shapes (n=4, CASES): the turn at which the port's
# host loop parts from the reference's in μ̂'s last bits, measured
N4_EXACT_MU_TURNS = {"icdf": 3, "alias": 7}


def ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _sched(horizon):
    return [(horizon / 3, SPEEDS[::-1].copy()), (2 * horizon / 3, SPEEDS.copy())]


#: the reference test's two exact-parity cases (tests/test_scanloop.py)
CASES = {
    "icdf": (False, dict(arrival_rate=3.0, horizon=150.0, seed=0, arrival_batch=16,
                         speed_schedule=_sched(150.0))),
    "alias": (True, dict(arrival_rate=3.0, horizon=100.0, seed=1, arrival_batch=8)),
}


def _router(mod, use_alias, n=4, speeds=SPEEDS, seed=0, async_mu=False):
    kw = {} if mod is jr else {"device": "cpu"}
    return mod.RosellaRouter(n, mu_bar=float(np.sum(speeds)), seed=seed,
                             async_mu=async_mu, use_alias=use_alias, **kw)


@pytest.fixture
def ref_scan(monkeypatch):
    """The reference scan loop on jax 0.9, which has ``jax.enable_x64(True)``
    where the reference imports ``jax.experimental.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    from repro.serving import scanloop

    return scanloop


# ---------------------------------------------------------------------------
# (i) device forms
# ---------------------------------------------------------------------------


def _host_turn_inputs(rng, n, P):
    """A completion batch padded to P: empty, partial, or full."""
    nw = rng.choice([0, 0, P // 3, P])
    w = np.full(P, -1, np.int32)
    ts = np.zeros(P, np.float32)
    w[:nw] = rng.randint(0, n, nw)
    ts[:nw] = rng.exponential(1.0, nw)
    return w, ts, nw


@pytest.mark.parametrize("use_alias", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_serve_step_device_equals_the_host_form(use_alias, masked):
    """40 turns of ``serve_step_device`` against ``serve_step`` with
    ``use_fresh_mu=True`` from the same state, half of them without
    completions: draws, placements, queue view, learner, λ̂ EMA and key
    equal bit for bit, and the carried states stay equal."""
    rng = np.random.RandomState(3 + use_alias + 2 * masked)
    n, P, m = 16, 32, 8
    lcfg = tlrn.default_learner_config(6.0)
    mask = torch.from_numpy(rng.rand(n) < 0.7) if masked else None
    q = torch.zeros(n, dtype=torch.int32)
    learner = tlrn.init_learner(n, lcfg, 1.0, "cpu")
    arr, key = test_.init_ema_arrival(), prng.PRNGKey(7)
    dq, dl, da, dk = q, learner, test_.to_device(arr, "cpu"), prng.device_key(key, "cpu")
    now, last_fake = 0.0, 0.0
    empty = 0
    for _ in range(40):
        now += float(rng.exponential(1.5))
        w, ts, nw = _host_turn_inputs(rng, n, P)
        empty += nw == 0
        comp_now = now - float(rng.rand()) * (nw > 0)
        host = tsch.serve_step(q, learner, arr, learner.mu_hat, lcfg, key, w, ts,
                               (now, last_fake, comp_now), m, use_fresh_mu=True,
                               use_alias=use_alias, mask=mask)
        f = lambda v: torch.tensor(np.float32(v))  # noqa: E731
        dev = tsch.serve_step_device(dq, dl, da, lcfg, dk, torch.from_numpy(w),
                                     torch.from_numpy(ts), (f(now), f(last_fake),
                                                            f(comp_now)), m,
                                     use_alias=use_alias, mask=mask)
        fake_h, w_h, q, learner, arr, key = host
        fake_d, w_d, dq, dl, da, dk = dev
        assert torch.equal(fake_h, fake_d) and torch.equal(w_h, w_d)
        assert torch.equal(q, dq)
        for fld in tlrn.LearnerState.__dataclass_fields__:
            assert torch.equal(getattr(learner, fld), getattr(dl, fld)), fld
        assert test_.to_host(da) == arr
        assert prng.host_key(dk) == key
        last_fake = now
    assert empty >= 10


def test_a_fold_over_an_all_padding_batch_is_not_a_no_op():
    """The trap the select exists for: refresh_estimates cuts a worker
    whose samples went stale, so folding an empty batch moves μ̂. A turn
    without completions keeps the learner as it was."""
    n, lcfg = 4, tlrn.default_learner_config(4.0)
    learner = tlrn.init_learner(n, lcfg, 1.0, "cpu")
    w = torch.tensor([0, 1, 2, 3] * 4, dtype=torch.int32)
    learner = tlrn.record_completions(learner, w, torch.ones(16), 1.0)
    pad_w, pad_t = torch.full((8,), -1, dtype=torch.int32), torch.zeros(8)
    late = torch.tensor(np.float32(5000.0))
    folded = tsch.fold_telemetry(learner, lcfg, pad_w, pad_t, np.float32(1.0), late)
    assert not torch.equal(folded.mu_hat, learner.mu_hat)
    arr = test_.to_device(test_.EmaArrivalState(np.float32(4990.0), np.float32(0.5), 40),
                          "cpu")
    out = tsch.serve_step_device(torch.zeros(n, dtype=torch.int32), learner, arr, lcfg,
                                 prng.device_key(prng.PRNGKey(0), "cpu"), pad_w, pad_t,
                                 (late, late, late), 4)
    for fld in tlrn.LearnerState.__dataclass_fields__:
        assert torch.equal(getattr(out[3], fld), getattr(learner, fld)), fld


def _chain_case(seed, n=64, M=136):
    """A turn's submissions: a repeated replica, arrivals equal to a
    replica's free_at (ties), inactive slots."""
    rng = np.random.RandomState(seed)
    fa = rng.rand(n) * 3
    sp = rng.rand(n) + 0.05
    w = rng.randint(0, n, M).astype(np.int32)
    w[10:30] = 5
    a = np.sort(rng.rand(M) * 3)
    a[12] = fa[5]
    a[40] = fa[w[40]]
    c = rng.exponential(1.0, M)
    act = rng.rand(M) < 0.85
    return fa, sp, w, a, c, act


def _jax_pstep_chain(fa, sp, w, a, c, act):
    """The reference's inner scan step (serving/scanloop.py, ``pstep``)."""
    with jax.enable_x64(True):
        speeds64 = jnp.asarray(sp, jnp.float64)

        def pstep(f, x):
            wi, ai, ci, ac = x
            start = jnp.maximum(ai, f[wi])
            done = start + ci / speeds64[wi]
            f = jnp.where(ac, f.at[wi].set(done), f)
            return f, (start, done)

        f, (s, d) = jax.lax.scan(pstep, jnp.asarray(fa, jnp.float64),
                                 (jnp.asarray(w), jnp.asarray(a, jnp.float64),
                                  jnp.asarray(c, jnp.float64), jnp.asarray(act)))
        return np.asarray(s), np.asarray(d), np.asarray(f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_chain_plain_version_equals_reference_pstep_and_sequential_pool(seed):
    """The CPU path of the pool-chain wrapper, bit for bit: against the
    reference's ``pstep`` scan, and against ``SequentialPool`` on the
    active submissions (where the host loop submits only those)."""
    fa, sp, w, a, c, act = _chain_case(seed)
    t = [torch.from_numpy(x) for x in (fa, sp, w, a, c, act)]
    start, done, free = CK.pool_chain(*t)
    want = _jax_pstep_chain(fa, sp, w, a, c, act)
    for got, exp in zip((start, done, free), want):
        np.testing.assert_array_equal(got.numpy(), exp)
    pool = tr.SequentialPool(sp)
    pool.free_at = fa.copy()
    s2, d2 = pool.submit_batch(w[act], a[act], c[act])
    np.testing.assert_array_equal(start.numpy()[act], s2)
    np.testing.assert_array_equal(done.numpy()[act], d2)
    np.testing.assert_array_equal(free.numpy(), pool.free_at)
    assert torch.equal(CR.pool_chain_ref(*t)[1], done)


def test_pool_chain_wrapper_checks_its_inputs():
    t = [torch.from_numpy(x) for x in _chain_case(0, n=8, M=48)]
    with pytest.raises(ValueError, match="workers"):
        CK.pool_chain(t[0], t[1], t[2].long(), *t[3:])
    with pytest.raises(ValueError, match="speeds"):
        CK.pool_chain(t[0], t[1][:4], *t[2:])
    before = CK.launch_counts()["pool_chain"]
    CK.pool_chain(*t)
    assert CK.launch_counts()["pool_chain"] == before  # the CPU path launches nothing


# ---------------------------------------------------------------------------
# (ii) against the port's host loop (tests/test_scanloop.py, mirrored)
# ---------------------------------------------------------------------------


def _host_and_scan(use_alias, kw, n=4, speeds=SPEEDS, **scan_kw):
    ra, pa = _router(tr, use_alias, n, speeds), tr.SequentialPool(speeds)
    resp_h, mu_h = tr.run_simulation(ra, pa, **kw)
    rb, pb = _router(tr, use_alias, n, speeds), tr.SequentialPool(speeds)
    resp_s, mu_s, info = tsl.run_simulation_scan(rb, pb, **kw, **scan_kw)
    return (ra, pa, resp_h, mu_h), (rb, pb, resp_s, mu_s, info)


def _assert_same_final_state(ra, pa, rb, pb):
    np.testing.assert_array_equal(pa.free_at, pb.free_at)
    assert torch.equal(ra.q_view, rb.q_view)
    for fld in tlrn.LearnerState.__dataclass_fields__:
        assert torch.equal(getattr(ra.learner, fld), getattr(rb.learner, fld)), fld
    assert ra.key == rb.key and ra.arr == rb.arr
    assert np.float32(ra.last_fake_time) == np.float32(rb.last_fake_time)
    # the scan leaves the fresh μ̂ adopted; the host loop adopts it at its
    # next turn's flip, which rebuilds the table from it
    ra._flip_mu()
    assert torch.equal(ra.mu_front, rb.mu_front)
    if ra.use_alias:
        assert torch.equal(ra.table_front.prob, rb.table_front.prob)
        assert torch.equal(ra.table_front.alias, rb.table_front.alias)


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_exact_parity_with_the_host_loop(case):
    """Both probe streams, SequentialPool, async_mu=False: responses, μ̂
    trace, replica clocks, queue view, learner, λ̂ EMA and key equal."""
    use_alias, kw = CASES[case]
    (ra, pa, resp_h, mu_h), (rb, pb, resp_s, mu_s, info) = _host_and_scan(use_alias, kw)
    assert info["flush_overflow"] == 0 and info["pend_overflow"] == 0
    assert info["turns"] == len(mu_h) and info["capture_s"] is None
    np.testing.assert_array_equal(resp_h, resp_s)
    np.testing.assert_array_equal(mu_h, mu_s)
    _assert_same_final_state(ra, pa, rb, pb)


@pytest.mark.parametrize("use_alias", [False, True])
def test_scan_exact_parity_with_the_host_loop_at_32_replicas(use_alias):
    """The router test's shape (n=32, §6.1 speeds, 70% load, batches of 8,
    about 250 turns): every turn equal, and the final states."""
    from repro_torch.configs.rosella_sim import tpch_speed_set

    speeds = tpch_speed_set(32, 0)
    rate = 0.7 * float(speeds.sum())
    kw = dict(arrival_rate=rate, horizon=250 * 8 / rate, seed=0, arrival_batch=8)
    (ra, pa, resp_h, mu_h), (rb, pb, resp_s, mu_s, info) = _host_and_scan(
        use_alias, kw, n=32, speeds=speeds)
    assert info["turns"] >= 230 and info["pend_overflow"] == 0
    np.testing.assert_array_equal(resp_h, resp_s)
    np.testing.assert_array_equal(mu_h, mu_s)
    _assert_same_final_state(ra, pa, rb, pb)


def test_scan_alias_vs_inverse_cdf_statistical_parity():
    """The alias stream changes the draws, not the distribution: p50/p99
    within 15% of the inverse-CDF stream on the same workload."""
    resp = {}
    for use_alias in (True, False):
        r, p = _router(tr, use_alias), tr.SimulatedPool(SPEEDS)
        resp[use_alias], _, info = tsl.run_simulation_scan(
            r, p, arrival_rate=3.0, horizon=400.0, seed=0, arrival_batch=16)
        assert info["pend_overflow"] == 0
    assert len(resp[True]) == len(resp[False])
    for q in (50, 99):
        a, b = np.percentile(resp[True], q), np.percentile(resp[False], q)
        assert abs(a - b) / b < 0.15, (q, a, b)


def test_scan_overflow_raises_and_is_counted():
    """An undersized pending set raises by default; opting out returns the
    counts. A flush capacity below a turn's due count is counted too."""
    kw = dict(arrival_rate=3.0, horizon=60.0, seed=0, arrival_batch=16)
    with pytest.raises(RuntimeError, match="pend_cap"):
        tsl.run_simulation_scan(_router(tr, True), tr.SimulatedPool(SPEEDS), pend_cap=8,
                                **kw)
    _, _, info = tsl.run_simulation_scan(_router(tr, True), tr.SimulatedPool(SPEEDS),
                                         pend_cap=8, strict_overflow=False, **kw)
    assert info["pend_overflow"] > 0
    times, costs, speeds = tsl._precompute_workload(3.0, 60.0, 1.0, None, 0, 16, SPEEDS)
    with pytest.raises(RuntimeError, match="flush_overflow=[1-9]"):
        tsl.run_workload_scan(_router(tr, True), tr.SimulatedPool(SPEEDS), times, costs,
                              speeds, comp_cap=2)


def test_scan_empty_horizon():
    r, p = _router(tr, True), tr.SimulatedPool(SPEEDS)
    resp, mu, info = tsl.run_simulation_scan(r, p, arrival_rate=3.0, horizon=0.0, seed=0,
                                             arrival_batch=4)
    assert len(resp) == 0 and mu.shape == (0, 4) and info["turns"] == 0


def test_scan_options_not_ported_raise():
    # telemetry (A5) runs since it was ported: the windows come back, and a
    # sink without an observe config is never called
    from repro_torch import obs

    kw = dict(arrival_rate=3.0, horizon=5.0, seed=0, arrival_batch=4)
    r, p = _router(tr, True), tr.SimulatedPool(SPEEDS)
    off = tsl.run_simulation_scan(r, p, **kw)
    r, p = _router(tr, True), tr.SimulatedPool(SPEEDS)
    resp, _, info = tsl.run_simulation_scan(r, p, observe=obs.ObserveConfig(window_turns=2),
                                            **kw)
    np.testing.assert_array_equal(resp, off[0])
    assert len(info["windows"]) == -(-info["turns"] // 2)
    x = np.arange(1, 9, dtype=np.float64).reshape(2, 4) / 10
    resp, _, info = tsl.run_workload_scan(_router(tr, True), tr.SimulatedPool(SPEEDS), x,
                                          np.ones((2, 4)), np.ones((2, 4)),
                                          obs_sink=pytest.fail)
    assert "windows" not in info and resp.shape == (8,)
    # the failure semantics (A4) run since they were ported: fault columns
    # or a recovery config take the faulty turn and close a ledger
    from repro_torch.serving import recovery as trcv

    times, costs = np.arange(1, 9, dtype=np.float64).reshape(2, 4) / 10, np.ones((2, 4))
    for kw in ({"kill_np": np.full((2, 4), np.inf)}, {"recovery": trcv.INERT_RECOVERY}):
        resp, _, info = tsl.run_workload_scan(_router(tr, True), tr.SimulatedPool(SPEEDS),
                                              times, costs, np.ones((2, 4)), **kw)
        assert info["ledger"]["conserved"] and resp.shape == (8,)
        assert np.isfinite(resp).sum() == info["ledger"]["completed_tasks"]


def test_scan_raises_without_a_card(monkeypatch):
    """The router's device is the scan's: CUDA unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.RosellaRouter(4, mu_bar=4.0)


# ---------------------------------------------------------------------------
# (iii) against the reference's scan loop
# ---------------------------------------------------------------------------


def _first_mu_divergence(mu_a, mu_b) -> int:
    mu_a, mu_b = np.asarray(mu_a), np.asarray(mu_b)
    return next((i for i in range(len(mu_a)) if not np.array_equal(mu_a[i], mu_b[i])),
                len(mu_a))


def _assert_reference_bars(resp_r, mu_r, resp_t, mu_t, k, exact_turns):
    """Responses equal on every turn; μ̂ equal for at least ``exact_turns``
    turns, zero where the reference's is and within MU_ULPS on every turn."""
    T = len(mu_r)
    assert len(mu_t) == T and len(resp_t) == len(resp_r) == T * k
    for i in range(T):
        np.testing.assert_array_equal(resp_t[i * k:(i + 1) * k], resp_r[i * k:(i + 1) * k],
                                      err_msg=f"turn {i}")
    assert _first_mu_divergence(mu_r, mu_t) >= exact_turns
    np.testing.assert_array_equal(np.asarray(mu_r) == 0, mu_t == 0)
    assert ulps(mu_r, mu_t) <= MU_ULPS


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_against_the_reference_run_simulation_scan(ref_scan, case):
    """At the reference test's shapes (n=4) μ̂ first parts from the
    reference in its last bits at turn 3 (icdf) and 7 (alias), the same
    turn at which the port's host loop parts from the reference's (the
    learner's mean is a float sum that XLA orders differently): the bar is
    that turn, N4_EXACT_MU_TURNS, and the two host loops must part exactly
    there."""
    use_alias, kw = CASES[case]
    rj, pj = _router(jr, use_alias), jr.SequentialPool(SPEEDS)
    resp_r, mu_r, info_r = ref_scan.run_simulation_scan(rj, pj, **kw)
    rt_, pt = _router(tr, use_alias), tr.SequentialPool(SPEEDS)
    resp_t, mu_t, info_t = tsl.run_simulation_scan(rt_, pt, **kw)
    _, mu_hj = jr.run_simulation(_router(jr, use_alias), jr.SequentialPool(SPEEDS), **kw)
    _, mu_ht = tr.run_simulation(_router(tr, use_alias), tr.SequentialPool(SPEEDS), **kw)
    assert _first_mu_divergence(mu_hj, mu_ht) == N4_EXACT_MU_TURNS[case]
    assert info_t["turns"] == info_r["turns"] and info_t["pend_overflow"] == 0
    _assert_reference_bars(resp_r, mu_r, resp_t, mu_t, kw["arrival_batch"],
                           N4_EXACT_MU_TURNS[case])
    np.testing.assert_array_equal(pt.free_at, pj.free_at)
    np.testing.assert_array_equal(rt_.q_view.numpy(), np.asarray(rj.q_view))
    assert rt_.key == tuple(int(x) for x in np.asarray(rj.key, np.uint32))


@pytest.mark.parametrize("use_alias", [False, True])
def test_scan_against_the_reference_at_32_replicas(ref_scan, use_alias):
    """The router test's shape (n=32, about 250 turns), where its bars
    hold: responses equal on every turn, μ̂ exact for at least
    MIN_EXACT_MU_TURNS turns."""
    from repro_torch.configs.rosella_sim import tpch_speed_set

    speeds = tpch_speed_set(32, 0)
    rate = 0.7 * float(speeds.sum())
    kw = dict(arrival_rate=rate, horizon=250 * 8 / rate, seed=0, arrival_batch=8)
    resp_r, mu_r, _ = ref_scan.run_simulation_scan(
        _router(jr, use_alias, 32, speeds), jr.SequentialPool(speeds), **kw)
    resp_t, mu_t, info = tsl.run_simulation_scan(
        _router(tr, use_alias, 32, speeds), tr.SequentialPool(speeds), **kw)
    assert info["turns"] >= 230
    _assert_reference_bars(resp_r, mu_r, resp_t, mu_t, 8, MIN_EXACT_MU_TURNS)


def _churn_workload(n=8, k=8, T=60, burst_cap=3, seed=2):
    """Arrivals and costs as run_simulation draws them, two replicas offline
    from turn 15 to 40 and rejoining with a burst of probes each."""
    speeds = np.linspace(0.5, 2.0, n)
    rate = 0.6 * float(speeds.sum())
    times, costs, _ = tsl._precompute_workload(rate, T * k / rate, 1.0, None, seed, k,
                                               speeds)
    T = len(times)
    active = np.ones((T, n), bool)
    active[15:40, [2, 5]] = False
    rejoin = np.zeros((T, n), bool)
    rejoin[40, [2, 5]] = True
    burst = np.full((T, burst_cap), -1, np.int32)
    burst[40, :2] = [2, 5]
    burst[41, :1] = [2]
    return speeds, dict(times_np=times, costs_np=costs,
                        speeds_np=np.broadcast_to(speeds, (T, n)).copy(),
                        active_np=active, rejoin_np=rejoin, burst_np=burst)


@pytest.mark.parametrize("use_alias", [False, True])
def test_scan_against_the_reference_run_workload_scan_with_churn(ref_scan, use_alias):
    speeds, wl = _churn_workload()
    n = len(speeds)
    rj, pj = _router(jr, use_alias, n, speeds), jr.SequentialPool(speeds)
    resp_r, mu_r, _ = ref_scan.run_workload_scan(rj, pj, **wl)
    rt_, pt = _router(tr, use_alias, n, speeds), tr.SequentialPool(speeds)
    resp_t, mu_t, info = tsl.run_workload_scan(rt_, pt, **wl)
    assert info["pend_overflow"] == 0 and info["flush_overflow"] == 0
    # μ̂ parts in its last bits at turn 7 (icdf) / 6 (alias), measured; the
    # port has no host churn loop to measure against (ROADMAP A2)
    _assert_reference_bars(resp_r, mu_r, resp_t, mu_t, wl["times_np"].shape[1],
                           CHURN_EXACT_MU_TURNS)
    np.testing.assert_array_equal(pt.free_at, pj.free_at)
    np.testing.assert_array_equal(rt_.active.numpy(), np.asarray(rj.active))


# ---------------------------------------------------------------------------
# (iv) chunks, chunk sizing, churn placements
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["icdf", "alias", "churn"])
def test_chunked_equals_unchunked(case):
    """A run in chunks of 7 turns (the carry crosses each boundary) equals
    one chunk, results and final state."""
    out = []
    for chunk_turns in (None, 7):
        if case == "churn":
            speeds, wl = _churn_workload()
            r, p = _router(tr, True, len(speeds), speeds), tr.SequentialPool(speeds)
            resp, mu, info = tsl.run_workload_scan(r, p, chunk_turns=chunk_turns, **wl)
        else:
            use_alias, kw = CASES[case]
            r, p = _router(tr, use_alias), tr.SequentialPool(SPEEDS)
            resp, mu, info = tsl.run_simulation_scan(r, p, chunk_turns=chunk_turns, **kw)
        out.append((resp, mu, r, p, info))
    (ra, ma, r1, p1, i1), (rb, mb, r2, p2, i2) = out
    assert i1["turns"] == i2["turns"] > 7
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(ma, mb)
    _assert_same_final_state(r1, p1, r2, p2)


def test_auto_chunk_turns_equals_the_reference(ref_scan):
    for T in (0, 1, 50, 5000, 10**6):
        for k, n in ((1, 4), (16, 64), (128, 1024), (1024, 4096)):
            for churn, bc, faulty in ((False, 0, False), (True, 8, False), (True, 0, True)):
                for pend_cap, mb in ((1024, None), (65536, None), (1024, 1 << 20)):
                    kw = dict(churn=churn, burst_cap=bc, faulty=faulty, pend_cap=pend_cap,
                              max_bytes=mb)
                    assert tsl.auto_chunk_turns(T, k, n, **kw) == \
                        ref_scan.auto_chunk_turns(T, k, n, **kw), (T, k, n, kw)


@pytest.mark.parametrize("use_alias", [False, True])
def test_churn_placements_only_on_active_replicas(monkeypatch, use_alias):
    """Every routed request and benchmark job of a churn run lands on a
    replica its turn's membership column marks active."""
    seen = []
    inner = tsch._draw_and_route

    def spy(*args, **kw):  # kw: the recovery layer's m_route/slots
        out = inner(*args, **kw)
        seen.append((out[0].clone(), out[1].clone(), args[-1].clone()))
        return out

    monkeypatch.setattr(tsch, "_draw_and_route", spy)
    speeds, wl = _churn_workload()
    r, p = _router(tr, use_alias, len(speeds), speeds), tr.SequentialPool(speeds)
    tsl.run_workload_scan(r, p, **wl)
    assert len(seen) == len(wl["times_np"])
    for t, (fake, workers, mask) in enumerate(seen):
        np.testing.assert_array_equal(mask.numpy(), wl["active_np"][t])
        fake = fake[fake >= 0]
        assert mask[workers.long()].all() and mask[fake.long()].all(), t
    assert not wl["active_np"].all()
