"""The chain simulator's parts against the reference, on the CPU: the
batched draws, the engine's ``forced`` pins, ``theory``, the trace
metrics, ``make_sim`` and ``sim_params_from_reference``.

Parity classes:
  * the batched draws (``utils.prng.v*``) equal ``jax.vmap`` of the
    single-key draw over 2000 keys: bit for bit for ``split``, ``uniform``,
    ``randint`` and the counter-hash pair and quad; ``exponential`` within
    EXP_ULPS ulp and ``gumbel`` within GUMBEL_TOL (torch's ``log1p`` /
    ``log`` against XLA's); ``categorical`` equal except at near ties
    (the two best scores within NEAR_TIE of each other), which are counted;
  * the engine with ``forced`` pins: ``workers`` and ``q_after`` equal to
    the reference engine's for every policy x fold_chunks x alias table
    (the reference's table handed to both, μ on a 2**-8 grid);
  * ``theory``, the trace metrics and ``make_sim``: equal (numpy code, and
    f32 leaves built by the same operations; the default μ̄ sums left to
    right, which is XLA's order for n <= 32).
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as rdsp
from repro.core import metrics as rmet
from repro.core import policies as rpol
from repro.core import simulator as rsim
from repro.core import theory as rth
from repro_torch import convert
from repro_torch.configs import rosella_sim as TRS
from repro_torch.core import dispatch as tdsp
from repro_torch.core import metrics as tmet
from repro_torch.core import policies as tpol
from repro_torch.core import simulator as tsim
from repro_torch.core import theory as tth
from repro_torch.utils import prng
from test_torch_model import reference_shim

EXP_ULPS = 2
GUMBEL_TOL = 2e-6
NEAR_TIE = 1e-5
KEYS = jax.random.split(jax.random.PRNGKey(7), 2000)
TKEYS = torch.from_numpy(np.array(KEYS).astype(np.int64))
F9 = [0.4, 0.3, 0.2, 0.1]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("kind", ["split", "uniform", "uniform_shape", "randint",
                                  "randint_span1", "pair", "quad"])
def test_batched_draws_equal_vmap_of_the_single_key_draw(kind):
    v = jax.vmap
    if kind == "split":
        _eq(v(lambda k: jax.random.split(k, 4))(KEYS), prng.vsplit(TKEYS, 4))
    elif kind == "uniform":
        _eq(v(lambda k: jax.random.uniform(k))(KEYS), prng.vuniform(TKEYS, ()))
    elif kind == "uniform_shape":
        _eq(v(lambda k: jax.random.uniform(k, (2, 3)))(KEYS), prng.vuniform(TKEYS, (2, 3)))
    elif kind == "randint":
        _eq(v(lambda k: jax.random.randint(k, (2, 4), 0, 30))(KEYS),
            prng.vrandint(TKEYS, (2, 4), 0, 30))
    elif kind == "randint_span1":
        _eq(v(lambda k: jax.random.randint(k, (3,), 0, 1))(KEYS), prng.vrandint(TKEYS, (3,), 0, 1))
    else:
        fn = rdsp._uniform_pair if kind == "pair" else rdsp._uniform_quad
        mine = prng.vuniform_pair if kind == "pair" else prng.vuniform_quad
        for a, b in zip(v(lambda k: fn(k, 4))(KEYS), mine(TKEYS, 4)):
            _eq(a, b)


def test_batched_draws_equal_the_single_key_draws_row_by_row():
    """Row r of each batched form is the port's own single-key draw on key
    r (the single-key functions are unchanged)."""
    for r in range(0, 2000, 397):
        key = tuple(int(x) for x in np.array(KEYS[r]))
        assert torch.equal(prng.vsplit(TKEYS, 3)[r], torch.tensor(prng.split(key, 3)))
        assert torch.equal(prng.vuniform(TKEYS, (5,))[r], prng.uniform(key, (5,)))
        assert torch.equal(prng.vrandint(TKEYS, (5,), 0, 17)[r], prng.randint(key, (5,), 0, 17))
        for a, b in zip(prng.vuniform_quad(TKEYS, 3), prng.uniform_quad(key, 3)):
            assert torch.equal(a[r], b)
        assert torch.equal(prng.vexponential(TKEYS, ())[r], prng.exponential(key, ()))


def test_batched_exponential_and_gumbel_within_their_ulps():
    want = np.asarray(jax.vmap(lambda k: jax.random.exponential(k, (3,)))(KEYS))
    got = prng.vexponential(TKEYS, (3,)).numpy()
    ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32))
    assert ulps.max() <= EXP_ULPS
    assert (ulps == 0).mean() > 0.8
    g_want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (5,)))(KEYS))
    np.testing.assert_allclose(prng.vgumbel(TKEYS, (5,)).numpy(), g_want, rtol=0,
                               atol=GUMBEL_TOL)


@pytest.mark.parametrize("m", [4, 32])
def test_batched_categorical_equal_except_at_counted_near_ties(m):
    """The chain's event draw (n + 2 rates) and its task count: every key
    where the port's draw differs is a near tie of the reference's scores."""
    rates = np.random.RandomState(m).choice([0.01, 0.3, 0.81, 2.4, 7.5], m).astype(np.float32)
    logits = jnp.log(jnp.asarray(rates))
    want = np.asarray(jax.vmap(lambda k: jax.random.categorical(k, logits))(KEYS))
    got = prng.vcategorical(TKEYS, torch.from_numpy(np.array(logits))).numpy()
    scores = np.sort(np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (m,)))(KEYS)
                                + logits), axis=1)
    near = scores[:, -1] - scores[:, -2] < NEAR_TIE * np.maximum(np.abs(scores[:, -1]), 1.0)
    differ = want != got
    assert not (differ & ~near).any()
    assert differ.sum() <= near.sum()


# -- the engine's forced pins --------------------------------------------------

N, B = 16, 6


def _pin_cases():
    cases = []
    for policy in tpol.ALL_POLICIES:
        tables = (False, True) if policy in tdsp.ALIAS_POLICIES else (False,)
        folds = (1,) if policy == tpol.SPARROW else (1, 3, B)
        cases += [(policy, fold, table) for fold in folds for table in tables]
    return cases


@pytest.mark.parametrize("policy,fold,table", _pin_cases())
def test_forced_pins_equal_the_reference_engine(policy, fold, table):
    rng = np.random.RandomState(tpol.ALL_POLICIES.index(policy) * 10 + fold)
    mu = (rng.randint(1, 64, N) / 256.0).astype(np.float32)  # exact sums in any order
    q = rng.randint(0, 6, N).astype(np.int32)
    pcfg, tcfg = rpol.default_policy_config(), tpol.default_policy_config()
    for trial in range(3):
        forced = np.where(rng.rand(B) < 0.4, rng.randint(0, N, B), -1).astype(np.int32)
        active = rng.rand(B) < 0.8 if trial else np.ones(B, bool)
        rt = rdsp.build_alias_table(jnp.asarray(mu)) if table else None
        want = rdsp.dispatch(policy, jax.random.PRNGKey(trial), jnp.asarray(q),
                             jnp.asarray(mu), jnp.asarray(mu), pcfg, B,
                             active=jnp.asarray(active), forced=jnp.asarray(forced),
                             fold_chunks=fold, use_kernel=False, table=rt)
        tt = (tdsp.AliasTable(torch.from_numpy(np.array(rt.prob)),
                              torch.from_numpy(np.array(rt.alias)))
              if table else None)
        got = tdsp.dispatch(policy, prng.PRNGKey(trial), torch.from_numpy(q),
                            torch.from_numpy(mu), torch.from_numpy(mu), tcfg, B,
                            active=torch.from_numpy(active), forced=torch.from_numpy(forced),
                            fold_chunks=fold, table=tt)
        _eq(want.workers, got.workers)
        _eq(want.q_after, got.q_after)
        pinned = (forced >= 0) & active
        assert (got.workers.numpy()[pinned] == forced[pinned]).all()


def test_no_pins_is_the_engine_without_forced():
    rng = np.random.RandomState(3)
    mu = (rng.randint(1, 64, N) / 256.0).astype(np.float32)
    q = torch.from_numpy(rng.randint(0, 6, N).astype(np.int32))
    none = torch.full((B,), -1, dtype=torch.int32)
    for policy in tpol.ALL_POLICIES:
        for fold in (1, B):
            a = tdsp.dispatch(policy, prng.PRNGKey(1), q, torch.from_numpy(mu),
                              torch.from_numpy(mu), tpol.default_policy_config(), B,
                              fold_chunks=fold)
            b = tdsp.dispatch(policy, prng.PRNGKey(1), q, torch.from_numpy(mu),
                              torch.from_numpy(mu), tpol.default_policy_config(), B,
                              forced=none, fold_chunks=fold)
            assert torch.equal(a.workers, b.workers) and torch.equal(a.q_after, b.q_after)


# -- theory --------------------------------------------------------------------


def test_theory_equals_the_reference_on_a_grid():
    ks = np.arange(0, 8)
    for alpha in (0.1, 0.5, 0.8, 0.9, 0.99):
        np.testing.assert_array_equal(tth.ppot_tail(alpha, ks), rth.ppot_tail(alpha, ks))
        np.testing.assert_array_equal(tth.pss_tail(alpha, ks), rth.pss_tail(alpha, ks))
        for n in (2, 20, 1000, 10**6):
            assert tth.max_queue_ppot(n, alpha) == rth.max_queue_ppot(n, alpha)
            assert tth.max_queue_pss(n, alpha) == rth.max_queue_pss(n, alpha)
            assert tth.learning_window(n, alpha, 2.0) == rth.learning_window(n, alpha, 2.0)
    assert tth.max_queue_pss(10, 0.0) == rth.max_queue_pss(10, 0.0)
    for c_max, eps in ((1.0, 0.1), (30.0, 0.01)):
        assert tth.recovery_time(c_max, eps) == rth.recovery_time(c_max, eps)
    rng = np.random.RandomState(0)
    for trial in range(20):
        mu = rng.choice([0.01, 0.1, 0.5, 1.0, 2.0], 12)
        lam = float(rng.uniform(0.1, 1.2) * mu.sum())
        for policy in ("uniform", "pot", "pss"):
            assert tth.stationarity_check(lam, mu, policy) == rth.stationarity_check(
                lam, mu, policy)


# -- trace metrics ---------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_trace():
    """A reference trace with multi-task jobs, pins and the learner, and a
    copy with kills planted (two crashes consuming completion ordinals)."""
    n = 12
    cfg = rsim.SimConfig(n=n, policy="ppot_sq2", rounds=3000, max_tasks=4,
                         constrained_frac=0.1)
    params = rsim.make_params(0.9 * 6.0, np.linspace(0.2, 0.8, n), max_tasks=4,
                              task_probs=F9)
    _, tr = rsim.simulate(cfg, params, jax.random.PRNGKey(2))
    tr = {k: np.asarray(v) for k, v in tr.items()}
    killed = np.zeros((3000, n), np.int32)
    killed[1200, 3], killed[2100, 7] = 2, 1
    return tr, dict(tr, killed=killed)


def _same_metrics(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kills", [False, True])
@pytest.mark.parametrize("warm", [0.0, 0.3])
def test_analyze_equals_the_reference(ref_trace, kills, warm):
    tr = ref_trace[1] if kills else ref_trace[0]
    want = rmet.analyze(tr, n=12, warmup_frac=warm)
    got = tmet.analyze(tr, n=12, warmup_frac=warm)
    _same_metrics(want, got)
    _same_metrics(want, tmet.analyze({k: torch.from_numpy(v.copy()) for k, v in tr.items()}, n=12,
                                     warmup_frac=warm))
    assert want.num_jobs > 100 and (not kills or want.killed_jobs > 0)
    assert tmet.percentiles(got.response_times) == rmet.percentiles(want.response_times)


def test_trace_summaries_equal_the_reference(ref_trace):
    tr = ref_trace[0]
    mu = np.linspace(0.2, 0.8, 12)
    for w in (0, 5, 11):
        np.testing.assert_array_equal(tmet.queue_length_histogram(tr, w),
                                      rmet.queue_length_histogram(tr, w))
    np.testing.assert_array_equal(tmet.estimate_error(tr, mu), rmet.estimate_error(tr, mu))
    np.testing.assert_array_equal(tmet.stationary_tail(tr), rmet.stationary_tail(tr))
    np.testing.assert_array_equal(tmet.stationary_tail(tr, 0.2), rmet.stationary_tail(tr, 0.2))
    empty = np.zeros(0)
    assert np.isnan(list(tmet.percentiles(empty).values())).all()


# -- make_sim and the params --------------------------------------------------------

SIM_SETTINGS = {
    "fig8_volatile": ("ppot_sq2", "tpch", 0.8, dict(volatile_phases=6, phase_period=120.0)),
    "fig9": ("sparrow", "tpch", 0.8, dict(use_learner=False, use_fake_jobs=False,
                                          max_tasks=4, task_probs=F9,
                                          constrained_frac=0.1)),
    "fig10": ("halo", "zipf", 0.9, dict(use_learner=False, use_fake_jobs=False)),
    "fig11": ("bandit", "s2", 0.85, dict(volatile_phases=8, phase_period=60.0, seed=3)),
    "fig12": ("ppot_sq2", "s1", 0.85, dict(use_fake_jobs=False, c_window=30.0)),
    "theory": ("pss", "ones", 0.8, dict(use_learner=False, use_fake_jobs=False)),
}


@pytest.fixture(scope="module")
def rrs():
    """The reference's ``configs.rosella_sim`` (its package imports the
    models, so it loads under the jax shim)."""
    with reference_shim():
        from repro.configs import rosella_sim
    return rosella_sim


@pytest.mark.parametrize("name", sorted(SIM_SETTINGS))
def test_make_sim_equals_the_reference(rrs, name):
    policy, speeds, load, kw = SIM_SETTINGS[name]
    sp = {"tpch": TRS.tpch_speed_set(30, 0), "zipf": TRS.zipf_speeds(15, seed=0),
          "s1": TRS.synthetic_s1(), "s2": TRS.synthetic_s2(), "ones": np.ones(20)}[speeds]
    for fn in ("tpch_speed_set", "synthetic_s1", "synthetic_s2"):
        args = (30, 0) if fn == "tpch_speed_set" else ()
        np.testing.assert_array_equal(getattr(TRS, fn)(*args), getattr(rrs, fn)(*args))
    np.testing.assert_array_equal(TRS.zipf_speeds(15, seed=2), rrs.zipf_speeds(15, seed=2))
    np.testing.assert_array_equal(TRS.permutation_schedule(sp, 4, 1),
                                  rrs.permutation_schedule(sp, 4, 1))
    rc, rp = rrs.make_sim(policy, sp, load, rounds=1000, **kw)
    tc, tp = TRS.make_sim(policy, sp, load, rounds=1000, device="cpu", **kw)
    assert dataclasses.asdict(tc) == {f.name: getattr(rc, f.name)
                                      for f in dataclasses.fields(tc)}
    leaves = {f: np.asarray(getattr(rp, f)) for f in convert.SIM_PARAMS}
    for f, want in leaves.items():
        got = getattr(tp, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    back = convert.sim_params_from_reference(leaves, device="cpu")
    for f, want in leaves.items():
        np.testing.assert_array_equal(getattr(back, f).numpy(), want, err_msg=f)
    for now in (0.0, 59.9, 60.0, 61.5, 250.0, 1000.0):
        np.testing.assert_array_equal(tsim._current_mu(tp, np.float32(now)).numpy(),
                                      np.asarray(rsim._current_mu(rp, jnp.float32(now))))
    assert TRS.PAPER_BASELINES == rrs.PAPER_BASELINES
