"""The seven policies beside PPoT-SQ(2) (uniform, PoT, PSS, PPoT-LL(2),
bandit, Halo, Sparrow) through every layer of the port, against the
reference on the same seeded inputs, on the CPU:

(i) the threefry draws they consume (``utils.prng``): ``randint``,
``uniform`` and ``split`` bit for bit on host and device keys; Gumbel noise
and ``categorical`` within the stated tolerance (torch's ``log`` against
XLA's);
(ii) the dispatch engine for every policy x mask x table x fold_chunks x
active slots: ``workers`` and ``q_after`` equal to the reference engine's;
Sparrow's water-filling against the reference and a greedy loop; masked
draws only on active workers;
(iii) the single-task closures, the sliding-window λ̂ and the
``RosellaScheduler`` state machine;
(iv) the host serving loop, the per-request baseline
(``ReferenceRouter`` + ``run_simulation_reference``), the one-program loop
and the environment's ``run_scenario`` for every policy.

Exact wherever both sides see the same CDF or alias table: μ̂ sits on a
2**-8 grid with small sums (so every partial sum is exact in f32 in any
order) or the reference's table is handed to both. μ̂ after a learner
refresh is a float sum that XLA orders differently: within MU_ULPS.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import itertools

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as rdsp
from repro.core import estimator as rest
from repro.core import policies as rpol
from repro.core import scheduler as rsch
from repro.serving import router as jr
from repro_torch import env as tenv
from repro_torch.configs.rosella_sim import tpch_speed_set
from repro_torch.core import dispatch as tdsp
from repro_torch.core import estimator as test_
from repro_torch.core import policies as tpol
from repro_torch.core import scheduler as tsch
from repro_torch.serving import router as tr
from repro_torch.serving import scanloop as tsl
from repro_torch.utils import prng

RCFG, TCFG = rpol.default_policy_config(), tpol.default_policy_config()
NEW_POLICIES = tuple(p for p in tpol.ALL_POLICIES if p != tpol.PPOT_SQ2)
#: Gumbel noise: torch's log against XLA's, each ~1 ulp from the true log;
#: measured at most 4.8e-7 apart on |g| < 20 (4000 draws). A categorical
#: draw may differ only where its two largest scores are this close.
GUMBEL_ATOL = 2e-6
#: μ̂ after a learner refresh: the ring mean is a float sum (as in
#: test_torch_learner / test_torch_router)
MU_ULPS = 8


def ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _t(a):
    return torch.from_numpy(np.array(a))


def _keys(seed):
    """The same key as a jax key, a port host key and a port device key."""
    tk = prng.PRNGKey(seed)
    return jax.random.PRNGKey(seed), tk, prng.device_key(tk, "cpu")


# ---------------------------------------------------------------------------
# (i) the draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("span", [1, 5, 64, 1000, 1024, 100000])
def test_randint_matches_jax(span):
    """JAX's modulus rule, u32 wrap-around included (a span above 2**16
    has multiplier 0), at the shapes the engine draws: (B,), (2, B), ()."""
    for seed, lo in itertools.product((0, 7, 2**31 + 5), (0, 3)):
        jk, tk, dk = _keys(seed)
        for shape in ((33,), (2, 17), ()):
            want = np.asarray(jax.random.randint(jk, shape, lo, lo + span, dtype=jnp.int32))
            for key in (tk, dk):
                got = prng.randint(key, shape, lo, lo + span)
                assert got.dtype == torch.int32 and got.shape == want.shape
                np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_and_split_match_jax():
    for seed in (0, 11, 2**31 + 9):
        jk, tk, dk = _keys(seed)
        for shape in ((40,), (2, 21), ()):
            want = np.asarray(jax.random.uniform(jk, shape))
            for key in (tk, dk):
                np.testing.assert_array_equal(prng.uniform(key, shape).numpy(), want)
        for num in (2, 3):
            want = np.asarray(jax.random.split(jk, num)).astype(np.int64)
            np.testing.assert_array_equal(np.array(prng.split(tk, num), np.int64), want)
            np.testing.assert_array_equal(prng.split(dk, num).numpy(), want)


def test_gumbel_within_stated_tolerance():
    for seed in range(4):
        jk, tk, _ = _keys(seed)
        want = np.asarray(jax.random.gumbel(jk, (1000,)))
        got = prng.gumbel(tk, (1000,)).numpy()
        assert np.abs(got - want).max() <= GUMBEL_ATOL
        assert np.isfinite(got).all()


def test_categorical_equal_except_at_near_ties():
    """A draw may part from JAX's only where its two largest Gumbel scores
    lie within GUMBEL_ATOL; on these 300 draws no score pair is that close
    (counted: 0), so every draw is equal."""
    rng = np.random.RandomState(0)
    near_ties = 0
    for i in range(300):
        n = int(rng.choice([2, 8, 64]))
        w = rng.rand(n).astype(np.float32) * (rng.rand(n) < 0.8)
        logits = np.asarray(rpol._safe_logits(jnp.asarray(w)))
        jk, tk, dk = _keys(i)
        want = int(jax.random.categorical(jk, jnp.asarray(logits)))
        scores = np.sort(np.asarray(jax.random.gumbel(jk, (n,))) + logits)
        near_ties += int(scores[-1] - scores[-2] <= GUMBEL_ATOL)
        for key in (tk, dk):
            got = prng.categorical(key, _t(logits))
            assert got.dtype == torch.int32
            assert int(got) == want or scores[-1] - scores[-2] <= GUMBEL_ATOL
    assert near_ties == 0


# ---------------------------------------------------------------------------
# (ii) the engine
# ---------------------------------------------------------------------------

N, B = 24, 37


def _engine_case(seed):
    """μ̂ and μ on a 2**-8 grid (exact CDFs), a zero μ̂, a queue, a 75%
    membership mask and a random slot mask."""
    rng = np.random.RandomState(seed)
    mu = (rng.randint(0, 1024, N) / 256.0).astype(np.float32)
    mu[rng.randint(N)] = 0.0
    mu_true = (rng.randint(1, 1024, N) / 256.0).astype(np.float32)
    q = rng.randint(0, 12, N).astype(np.int32)
    mask = rng.rand(N) < 0.75
    mask[0] = True
    act = rng.rand(B) < 0.8
    return mu, mu_true, q, mask, act


def _both_engines(policy, seed, *, masked, table, C, slots):
    mu, mu_true, q, mask, act = _engine_case(seed)
    jm = jnp.asarray(mask) if masked else None
    rtab = ttab = None
    if table:  # handed to every policy: the non-alias ones must ignore it
        rtab = rdsp.build_alias_table(jnp.asarray(mu), jm)
        ttab = tdsp.AliasTable(_t(rtab.prob), _t(rtab.alias))
    r = rdsp.dispatch(policy, jax.random.PRNGKey(seed), jnp.asarray(q), jnp.asarray(mu),
                      jnp.asarray(mu_true), RCFG, B, fold_chunks=C, use_kernel=False,
                      table=rtab, mask=jm, active=jnp.asarray(act) if slots else None)
    t = tdsp.dispatch(policy, prng.PRNGKey(seed), _t(q), _t(mu), _t(mu_true), TCFG, B,
                      fold_chunks=C, table=ttab, mask=_t(mask) if masked else None,
                      active=_t(act) if slots else None)
    return r, t, mask, act


@pytest.mark.parametrize("fold_chunks", [1, 7, "B"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("policy", tpol.ALL_POLICIES)
def test_engine_matches_reference_for_every_policy(policy, masked, fold_chunks):
    """Table {None, the reference's (masked) table} x slots {all, random}:
    workers and q_after equal to ``dispatch(use_kernel=False)``."""
    C = B if fold_chunks == "B" else fold_chunks
    for i, (table, slots) in enumerate(itertools.product((False, True), (False, True))):
        seed = 100 * tpol.ALL_POLICIES.index(policy) + 10 * masked + i
        r, t, mask, act = _both_engines(policy, seed, masked=masked, table=table, C=C,
                                        slots=slots)
        np.testing.assert_array_equal(t.workers.numpy(), np.asarray(r.workers),
                                      err_msg=f"table={table} slots={slots}")
        np.testing.assert_array_equal(t.q_after.numpy(), np.asarray(r.q_after))
        w = t.workers.numpy()
        assert ((w >= 0) == (act if slots else True)).all()
        if masked:
            assert mask[w[w >= 0]].all()


@pytest.mark.parametrize("policy", [p for p in tpol.ALL_POLICIES
                                    if p not in tdsp.ALIAS_POLICIES])
def test_a_table_is_ignored_by_the_policies_that_do_not_draw_from_it(policy):
    """The rule of the reference's ``_draws``: uniform, PoT, Halo and
    Sparrow draw the same with a table as without one."""
    mu, mu_true, q, mask, _ = _engine_case(5)
    table = tdsp.build_alias_table(_t(mu), _t(mask))
    for key in (prng.PRNGKey(5), prng.device_key(prng.PRNGKey(5), "cpu")):
        a = tdsp.dispatch(policy, key, _t(q), _t(mu), _t(mu_true), TCFG, B, mask=_t(mask))
        b = tdsp.dispatch(policy, key, _t(q), _t(mu), _t(mu_true), TCFG, B, mask=_t(mask),
                          table=table)
        assert torch.equal(a.workers, b.workers) and torch.equal(a.q_after, b.q_after)


def test_alias_policies_match_the_reference():
    assert tdsp.ALIAS_POLICIES == rdsp.ALIAS_POLICIES


def test_dispatch_sequential_matches_reference_for_every_policy():
    mu, mu_true, q, _, _ = _engine_case(9)
    for policy in tpol.ALL_POLICIES:
        r = rdsp.dispatch_sequential(policy, jax.random.PRNGKey(9), jnp.asarray(q),
                                     jnp.asarray(mu), jnp.asarray(mu_true), RCFG, 40)
        t = tdsp.dispatch_sequential(policy, prng.PRNGKey(9), _t(q), _t(mu), _t(mu_true),
                                     TCFG, 40)
        np.testing.assert_array_equal(t.workers.numpy(), np.asarray(r.workers))
        np.testing.assert_array_equal(t.q_after.numpy(), np.asarray(r.q_after))


@pytest.mark.parametrize("policy", [tpol.UNIFORM, tpol.PSS, tpol.HALO])
def test_queue_independent_policies_batched_equal_the_sequential_oracle(policy):
    """``tests/test_dispatch.py`` / ``test_alias.py`` on the port: a policy
    that never reads the queue places the same batched as one task at a
    time, with and without a mask and a table."""
    mu, mu_true, q, mask, _ = _engine_case(13)
    for masked in (False, True):
        m = _t(mask) if masked else None
        tab = tdsp.build_alias_table(_t(mu), m)
        for Bs in (1, 7, 64):
            a = tdsp.dispatch(policy, prng.PRNGKey(Bs), _t(q), _t(mu), _t(mu_true), TCFG,
                              Bs, mask=m, table=tab)
            b = tdsp.dispatch_sequential(policy, prng.PRNGKey(Bs), _t(q), _t(mu),
                                         _t(mu_true), TCFG, Bs, mask=m, table=tab)
            assert torch.equal(a.workers, b.workers) and torch.equal(a.q_after, b.q_after)


@pytest.mark.parametrize("policy", [tpol.PPOT_SQ2, tpol.PPOT_LL2, tpol.BANDIT])
def test_alias_placement_distribution_matches_inverse_cdf(policy):
    """``tests/test_alias.py``'s bar on the port: per-worker placement
    histograms under the alias stream and the inverse-CDF stream within
    L1 0.15 over 300 batches of 8."""
    n = 8
    mu = torch.tensor([1.0, 1.0, 2.0, 4.0, 1.0, 2.0, 1.0, 1.0])
    table = tdsp.build_alias_table(mu)
    rng = np.random.RandomState(0)
    ca, ci = np.zeros(n), np.zeros(n)
    for t in range(300):
        q = _t(rng.randint(0, 6, size=n).astype(np.int32))
        k = prng.PRNGKey(t)
        ca += np.bincount(tdsp.dispatch(policy, k, q, mu, mu, TCFG, 8, table=table)
                          .workers.numpy(), minlength=n)
        ci += np.bincount(tdsp.dispatch(policy, k, q, mu, mu, TCFG, 8).workers.numpy(),
                          minlength=n)
    assert float(np.abs(ca / ca.sum() - ci / ci.sum()).sum()) < 0.15


@pytest.mark.parametrize("policy", tpol.ALL_POLICIES)
def test_engine_takes_a_device_key_for_every_policy(policy):
    """The device-resident turn's key (an int64 tensor [2]) gives the host
    key's draws, for keys with bit 31 set, masked and with a table."""
    mu, mu_true, q, mask, act = _engine_case(21)
    tm = _t(mask)
    tab = tdsp.build_alias_table(_t(mu), tm)
    for key in (prng.PRNGKey(21), (0xFFFFFFFF, 0x80000000), (0x9E3779B9, 0xC2B2AE35)):
        for C in (1, 5):
            kw = dict(table=tab, mask=tm, active=_t(act), fold_chunks=C)
            want = tdsp.dispatch(policy, key, _t(q), _t(mu), _t(mu_true), TCFG, B, **kw)
            got = tdsp.dispatch(policy, prng.device_key(key, "cpu"), _t(q), _t(mu),
                                _t(mu_true), TCFG, B, **kw)
            assert torch.equal(got.workers, want.workers)
            assert torch.equal(got.q_after, want.q_after)


def test_repeat_to_is_jnp_repeat_with_total_length():
    """Slots past the repeats' sum take the last value even when its count
    is 0; a sum above the total is cut."""
    got = tdsp.repeat_to(_t([5, 6, 7]), _t([1, 2, 0]), 6)
    assert got.tolist() == [5, 6, 6, 7, 7, 7]
    assert np.asarray(jnp.repeat(jnp.array([5, 6, 7]), jnp.array([1, 2, 0]),
                                 total_repeat_length=6)).tolist() == [5, 6, 6, 7, 7, 7]
    rng = np.random.RandomState(0)
    for _ in range(60):
        k = rng.randint(1, 9)
        vals = rng.randint(0, 100, k).astype(np.int32)
        reps = (rng.randint(0, 4, k) * (rng.rand(k) < 0.7)).astype(np.int32)
        total = rng.randint(1, 20)
        want = np.asarray(jnp.repeat(jnp.asarray(vals), jnp.asarray(reps),
                                     total_repeat_length=total))
        np.testing.assert_array_equal(tdsp.repeat_to(_t(vals), _t(reps), total).numpy(),
                                      want)


def _greedy(q, probes, m):
    """The reference semantics: m times, the least-loaded probed worker
    (ties: earliest probe position), folded back."""
    qn = np.asarray(q).copy()
    out = []
    for _ in range(m):
        j = probes[np.argmin(qn[probes])]
        out.append(int(j))
        qn[j] += 1
    return np.array(out, np.int32), qn


@pytest.mark.parametrize("case", ["random", "ties", "all_equal", "one_hot_short"])
@pytest.mark.parametrize("slots", ["all", "some", "one"])
def test_sparrow_matches_reference_and_greedy(case, slots):
    """The closed-form water-filling against the reference engine and the
    greedy loop over the same probes, with queues full of ties and with
    fewer active slots than B (m < B)."""
    rng = np.random.RandomState(len(case) + 3 * len(slots))
    n, Bs = 16, 24
    q = {"random": rng.randint(0, 9, n), "ties": rng.randint(0, 2, n),
         "all_equal": np.full(n, 3), "one_hot_short": np.where(np.arange(n) == 5, 0, 40)
         }[case].astype(np.int32)
    act = {"all": np.ones(Bs, bool), "some": rng.rand(Bs) < 0.5,
           "one": np.arange(Bs) == 7}[slots]
    mu = np.ones(n, np.float32)
    for seed in range(3):
        r = rdsp.dispatch(rpol.SPARROW, jax.random.PRNGKey(seed), jnp.asarray(q),
                          jnp.asarray(mu), jnp.asarray(mu), RCFG, Bs,
                          active=jnp.asarray(act))
        t = tdsp.dispatch(tpol.SPARROW, prng.PRNGKey(seed), _t(q), _t(mu), _t(mu), TCFG,
                          Bs, active=_t(act))
        np.testing.assert_array_equal(t.workers.numpy(), np.asarray(r.workers))
        np.testing.assert_array_equal(t.q_after.numpy(), np.asarray(r.q_after))
        probes = tdsp._draws(tpol.SPARROW, prng.PRNGKey(seed), Bs, n, TCFG, _t(mu),
                             _t(mu))["probes"].numpy()
        want, qn = _greedy(q, probes, int(act.sum()))
        np.testing.assert_array_equal(t.workers.numpy()[act], want)
        assert (t.workers.numpy()[~act] == -1).all()
        np.testing.assert_array_equal(t.q_after.numpy(), qn)


def test_sparrow_select_matches_reference_for_every_m():
    rng = np.random.RandomState(4)
    n, Bs = 12, 20
    for _ in range(20):
        q = rng.randint(0, 4, n).astype(np.int32)
        probes = rng.randint(0, n, 2 * Bs).astype(np.int32)
        for m in (0, 1, 7, Bs):
            want = np.asarray(rdsp._sparrow_select(jnp.asarray(q), jnp.asarray(probes), Bs,
                                                   jnp.int32(m)))
            got = tdsp.sparrow_select(_t(q), _t(probes), Bs, torch.tensor(m, dtype=torch.int32))
            np.testing.assert_array_equal(got.numpy()[:m], want[:m])
            np.testing.assert_array_equal(got.numpy()[:m], _greedy(q, probes, m)[0])


@pytest.mark.parametrize("policy", tpol.ALL_POLICIES)
def test_masked_dispatch_never_selects_inactive(policy):
    """``tests/test_alias.py``'s mask test on the port: 512 tasks, 70% of
    48 workers active, with the masked table where the policy draws from
    one; the fold-back counts every placement."""
    rng = np.random.RandomState(0)
    n = 48
    mu = (rng.rand(n) * 4 + 0.1).astype(np.float32)
    mask = rng.rand(n) < 0.7
    mask[0] = True
    tab = tdsp.build_alias_table(_t(mu), _t(mask)) if policy in tdsp.ALIAS_POLICIES else None
    for C in (1, 4):
        res = tdsp.dispatch(policy, prng.PRNGKey(3), torch.zeros(n, dtype=torch.int32),
                            _t(mu), _t(mu), TCFG, 512, mask=_t(mask), table=tab,
                            fold_chunks=C)
        ws = res.workers.numpy()
        assert (ws >= 0).all() and mask[ws].all()
        np.testing.assert_array_equal(res.q_after.numpy(), np.bincount(ws, minlength=n))


def test_within_batch_rank_ref_matches_both_forms():
    rng = np.random.RandomState(1)
    for Bs in (1, 9, 64):
        w = rng.randint(-1, 5, Bs).astype(np.int32)
        a = w >= 0
        want = np.asarray(rdsp.within_batch_rank_ref(jnp.asarray(w), jnp.asarray(a)))
        np.testing.assert_array_equal(tdsp.within_batch_rank_ref(_t(w), _t(a)).numpy(), want)
        np.testing.assert_array_equal(tdsp.within_batch_rank(_t(w), _t(a)).numpy(), want)


# ---------------------------------------------------------------------------
# (iii) closures, λ̂ window, scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", tpol.ALL_POLICIES)
def test_single_task_closures_match_reference(policy):
    """``POLICY_FNS[policy]`` on 64 keys each, on grid μ̂ (one zero) and a
    zero μ̂ (uniform fallback): equal to the reference's closure."""
    rng = np.random.RandomState(7)
    n = 8
    q = rng.randint(0, 5, n).astype(np.int32)
    mu_t = (rng.randint(1, 64, n) / 8.0).astype(np.float32)
    for mu in ((rng.randint(0, 64, n) / 8.0).astype(np.float32), np.zeros(n, np.float32)):
        rfn, tfn = rpol.get_policy(policy), tpol.get_policy(policy)
        for s in range(64):
            want = rfn(jax.random.PRNGKey(s), jnp.asarray(q), jnp.asarray(mu),
                       jnp.asarray(mu_t), RCFG)
            got = tfn(prng.PRNGKey(s), _t(q), _t(mu), _t(mu_t), TCFG)
            assert got.dtype == torch.int32 and int(got) == int(want), (s, mu)
    with pytest.raises(ValueError, match="unknown policy"):
        tpol.get_policy("nope")


def _counts(policy, mu_hat, q, n_draws=3000, mu_true=None):
    mu_true = mu_hat if mu_true is None else mu_true
    fn = tpol.get_policy(policy)
    keys = prng.split(prng.device_key(prng.PRNGKey(0), "cpu"), n_draws)
    ws = [int(fn(k, _t(q), _t(mu_hat), _t(mu_true), TCFG)) for k in keys]
    return np.bincount(ws, minlength=len(mu_hat))


def test_closures_sample_their_distributions():
    """``tests/test_policies.py``'s distribution checks on the port."""
    c = _counts(tpol.UNIFORM, np.ones(8, np.float32), np.zeros(8, np.int32))
    assert (np.abs(c / c.sum() - 1 / 8) < 0.03).all()
    mu = np.array([1.0, 2.0, 4.0, 1.0], np.float32)
    c = _counts(tpol.PSS, mu, np.zeros(4, np.int32))
    np.testing.assert_allclose(c / c.sum(), mu / 8.0, atol=0.03)
    assert (_counts(tpol.PSS, np.zeros(5, np.float32), np.zeros(5, np.int32)) > 0).all()
    mu, q = np.array([10.0, 1.0], np.float32), np.array([2, 1], np.int32)
    c_ll2, c_sq2 = _counts(tpol.PPOT_LL2, mu, q), _counts(tpol.PPOT_SQ2, mu, q)
    assert c_ll2[0] > c_ll2[1] and c_sq2[1] / c_sq2.sum() > 0.10 and c_sq2[1] > 2 * c_ll2[1]
    c = _counts(tpol.HALO, np.ones(2, np.float32), np.zeros(2, np.int32),
                mu_true=np.array([1.0, 9.0], np.float32))
    assert c[1] / c.sum() > 0.8


def test_schedule_batch_and_sparrow_batch_match_reference():
    mu, mu_true, q, _, _ = _engine_case(3)
    for policy in tpol.ALL_POLICIES:
        rw, rq = rpol.schedule_batch(policy, jax.random.PRNGKey(3), jnp.asarray(q),
                                     jnp.asarray(mu), jnp.asarray(mu_true), RCFG, 16)
        tw, tq = tpol.schedule_batch(policy, prng.PRNGKey(3), _t(q), _t(mu), _t(mu_true),
                                     TCFG, 16)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(rw))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        assert int(tq.sum()) - int(q.sum()) == 16
    q = np.array([0, 100, 100, 100, 100, 100, 100, 100], np.int32)
    rw, rq = rpol.sparrow_batch(jax.random.PRNGKey(1), jnp.asarray(q), jnp.ones(8), RCFG, 4)
    tw, tq = tpol.sparrow_batch(prng.PRNGKey(1), _t(q), torch.ones(8), TCFG, 4)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert (tw.numpy() == 0).sum() >= 1


@pytest.mark.parametrize("window", [1, 2, 5, 16])
def test_sliding_window_estimator_matches_reference(window):
    """``observe_arrival`` over 80 arrivals (some simultaneous, so a span
    of 0 keeps λ̂): ring, slot, count and λ̂ equal."""
    rng = np.random.RandomState(window)
    r = rest.init_arrival_estimator(window, 0.5)
    t = test_.init_arrival_estimator(window, 0.5, device="cpu")
    now = 0.0
    for _ in range(80):
        now += float(rng.exponential(0.3)) * (rng.rand() < 0.85)
        r = rest.observe_arrival(r, jnp.float32(now))
        t = test_.observe_arrival(t, np.float32(now))
        np.testing.assert_array_equal(t.times.numpy(), np.asarray(r.times))
        assert (int(t.idx), int(t.count)) == (int(r.idx), int(r.count))
        assert t.lam_hat.numpy() == np.asarray(r.lam_hat)


def test_sliding_window_estimator_without_a_device_raises_without_a_card(monkeypatch):
    """``device=None`` is the card, as for every other constructor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_.init_arrival_estimator(8, 0.5)
    assert test_.init_arrival_estimator(8, 0.5, device="cpu").times.device.type == "cpu"


@pytest.mark.parametrize("policy", tpol.ALL_POLICIES)
def test_rosella_scheduler_matches_reference(policy):
    """A schedule / fake-jobs / report sequence on both wrappers: workers
    and benchmark draws equal, queue views equal, μ̂ within MU_ULPS."""
    n, mu_bar = 16, 12.0
    r = rsch.RosellaScheduler(n, mu_bar, seed=3)
    t = tsch.RosellaScheduler(n, mu_bar, seed=3, device="cpu")
    rng = np.random.RandomState(3)
    now, inflight = 0.0, []
    for step in range(30):
        now += float(rng.exponential(0.4))
        m = int(rng.choice([1, 4, 8]))
        rw, tw = r.schedule(now, m, policy), t.schedule(now, m, policy)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(rw), err_msg=f"step {step}")
        rf, tf = r.fake_jobs(now), t.fake_jobs(now)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(rf))
        inflight += list(np.asarray(rw))
        if step % 3 == 2:  # report a fixed-size batch (padded with -1)
            done = np.full(6, -1, np.int32)
            k = min(len(inflight), 6)
            done[:k] = inflight[:k]
            inflight = inflight[k:]
            st = rng.exponential(1.0, 6).astype(np.float32)
            r.report(done, st, now)
            t.report(done, st, now)
        np.testing.assert_array_equal(t.state.q_view.numpy(), np.asarray(r.state.q_view))
        assert ulps(t.mu_hat.numpy(), np.asarray(r.mu_hat)) <= MU_ULPS
    assert t.key == tuple(int(x) for x in np.asarray(r.key, np.uint32))


# ---------------------------------------------------------------------------
# (iv) the serving loops and the entry points
# ---------------------------------------------------------------------------

RN = 32
RSPEEDS = tpch_speed_set(RN, 0)
RMU_BAR = float(RSPEEDS.sum())
RKW = dict(arrival_rate=0.7 * RMU_BAR, horizon=80 * 8 / (0.7 * RMU_BAR), seed=0,
           arrival_batch=8)


def _router(mod, policy, use_alias=True, n=RN, speeds=RSPEEDS, seed=0):
    kw = {} if mod is jr else {"device": "cpu"}
    return mod.RosellaRouter(n, mu_bar=float(np.sum(speeds)), policy=policy, seed=seed,
                             async_mu=False, use_alias=use_alias, **kw)


def _by_turn(a, b, k=8):
    assert len(a) == len(b)
    for i in range(len(a) // k):
        np.testing.assert_array_equal(a[i * k:(i + 1) * k], b[i * k:(i + 1) * k],
                                      err_msg=f"turn {i}")


@pytest.mark.parametrize("policy", tpol.ALL_POLICIES)
def test_host_loop_matches_reference_for_every_policy(policy):
    """n = 32, batches of 8, async_mu=False, SequentialPool, ~80 turns:
    responses bit-equal on every turn, μ̂ within MU_ULPS."""
    resp_r, mu_r = jr.run_simulation(_router(jr, policy), jr.SequentialPool(RSPEEDS), **RKW)
    resp_t, mu_t = tr.run_simulation(_router(tr, policy), tr.SequentialPool(RSPEEDS), **RKW)
    assert len(resp_t) == len(resp_r) >= 70 * 8
    _by_turn(resp_t, resp_r)
    assert ulps(mu_t, mu_r) <= MU_ULPS


@pytest.mark.parametrize("policy", tpol.ALL_POLICIES)
def test_router_gates_use_alias_as_the_reference_does(policy, monkeypatch):
    """``use_alias`` holds only for ``ALIAS_POLICIES``: the others never
    build a table, at construction, at a flip or at a membership change."""
    built = []
    real = tdsp.build_alias_table
    monkeypatch.setattr(tdsp, "build_alias_table",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    t = _router(tr, policy, n=8, speeds=np.arange(1.0, 9.0))
    assert t.use_alias == _router(jr, policy, n=8, speeds=np.arange(1.0, 9.0)).use_alias
    assert t.use_alias == (policy in tdsp.ALIAS_POLICIES)
    tr.run_simulation(t, tr.SimulatedPool(np.arange(1.0, 9.0)), arrival_rate=20.0,
                      horizon=2.0, arrival_batch=4)
    t.set_membership(np.arange(8) != 3, 2.0)
    assert (len(built) > 0) == (policy in tdsp.ALIAS_POLICIES)
    assert (t.table_front is None) == (policy not in tdsp.ALIAS_POLICIES)


@pytest.mark.parametrize("policy", [tpol.PPOT_SQ2, tpol.POT, tpol.SPARROW, tpol.HALO])
def test_reference_router_matches_reference_and_the_host_loop(policy):
    """The port's per-request baseline against the reference's (responses
    equal, μ̂ trace within MU_ULPS) and against the port's RosellaRouter
    with async_mu=False, use_alias=False on a SequentialPool (responses and
    final μ̂ equal)."""
    speeds = np.array([0.25, 0.5, 1.0, 2.0])
    kw = dict(arrival_rate=3.0, horizon=80.0, seed=0, arrival_batch=16)
    resp_r, mu_r = jr.run_simulation_reference(
        jr.ReferenceRouter(4, speeds.sum(), policy=policy, seed=0), jr.SimulatedPool(speeds),
        **kw)
    ref_router = tr.ReferenceRouter(4, speeds.sum(), policy=policy, seed=0, device="cpu")
    resp_t, mu_t = tr.run_simulation_reference(ref_router, tr.SimulatedPool(speeds), **kw)
    np.testing.assert_array_equal(resp_t, resp_r)
    assert mu_t.shape == mu_r.shape and ulps(mu_t, mu_r) <= MU_ULPS
    host = _router(tr, policy, use_alias=False, n=4, speeds=speeds)
    resp_h, _ = tr.run_simulation(host, tr.SequentialPool(speeds), **kw)
    np.testing.assert_array_equal(resp_h, resp_t)
    np.testing.assert_array_equal(host.mu_hat, ref_router.mu_hat)


def test_pool_submit_equals_the_sequential_batch_submit():
    rng = np.random.RandomState(7)
    speeds = rng.rand(5) + 0.2
    pa, pb = tr.SequentialPool(speeds), tr.SequentialPool(speeds)
    reps = rng.randint(0, 5, 40)
    arrs = np.sort(rng.rand(40) * 5)
    costs = rng.rand(40) + 0.05
    starts, dones = pa.submit_batch(reps, arrs, costs)
    for i in range(40):
        c = pb.submit(int(reps[i]), tr.Request(rid=i, arrival=arrs[i]), float(arrs[i]),
                      float(costs[i]))
        assert (c.t_start, c.t_done, c.replica) == (starts[i], dones[i], reps[i])
    np.testing.assert_array_equal(pa.free_at, pb.free_at)


def test_router_learns_and_beats_pot():
    """``tests/test_router_and_straggler.py``'s test on the port."""
    speeds = np.array([0.25, 0.5, 1.0, 2.0])
    results = {}
    for policy in (tpol.PPOT_SQ2, tpol.POT):
        router = tr.RosellaRouter(4, mu_bar=speeds.sum(), policy=policy, seed=0,
                                  device="cpu")
        resp, mu = tr.run_simulation(router, tr.SimulatedPool(speeds), arrival_rate=3.0,
                                     horizon=150.0)
        results[policy] = resp[len(resp) // 2:].mean()
        if policy == tpol.PPOT_SQ2:
            assert (np.argsort(mu[-1]) == np.argsort(speeds)).all()
    assert results[tpol.PPOT_SQ2] < results[tpol.POT]


@pytest.mark.parametrize("use_alias", [True, False])
@pytest.mark.parametrize("policy", NEW_POLICIES)
def test_scan_equals_the_host_loop_for_every_policy(policy, use_alias):
    """The one-program loop (eager on the CPU) against the port's host loop
    at n = 32, ~80 turns: responses, μ̂ trace and replica clocks equal."""
    ra, pa = _router(tr, policy, use_alias), tr.SequentialPool(RSPEEDS)
    resp_h, mu_h = tr.run_simulation(ra, pa, **RKW)
    rb, pb = _router(tr, policy, use_alias), tr.SequentialPool(RSPEEDS)
    resp_s, mu_s, info = tsl.run_simulation_scan(rb, pb, **RKW)
    assert info["flush_overflow"] == 0 and info["pend_overflow"] == 0
    np.testing.assert_array_equal(resp_h, resp_s)
    np.testing.assert_array_equal(mu_h, mu_s)
    np.testing.assert_array_equal(pa.free_at, pb.free_at)
    assert torch.equal(ra.q_view, rb.q_view) and ra.key == rb.key


@pytest.fixture
def ref_scan(monkeypatch):
    """The reference scan loop on jax 0.9 (``jax.enable_x64(True)`` where the
    reference imports ``jax.experimental.enable_x64``)."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    from repro.serving import scanloop

    return scanloop


#: Where the reference's own scan parts from its host loop: the scan runs
#: under jax's x64 mode, where ``jax.random.uniform`` draws float64, so the
#: threefry uniforms of bandit's explore draw (and of PSS's and Halo's
#: inverse-CDF probe, and of every masked uniform draw) differ from the
#: host loop's float32 ones. The port's scan draws float32, as both host
#: loops do.
REF_SCAN_X64_DRAWS = (tpol.BANDIT,)


@pytest.mark.parametrize("policy", [tpol.POT, tpol.PPOT_LL2, tpol.BANDIT, tpol.SPARROW])
def test_scan_matches_the_reference_scan(ref_scan, policy):
    """Against the reference's ``run_simulation_scan`` (alias stream where
    the policy draws from a table): responses equal on every turn, μ̂
    within MU_ULPS. For bandit the reference's scan draws its explore
    uniforms in float64 (REF_SCAN_X64_DRAWS) and parts from the reference's
    host loop at its first turn; there the port's scan is held to the
    reference's host loop instead, and the reference's departure is
    checked to be there."""
    resp_r, mu_r, _ = ref_scan.run_simulation_scan(_router(jr, policy),
                                                   jr.SequentialPool(RSPEEDS), **RKW)
    rt_, pt = _router(tr, policy), tr.SequentialPool(RSPEEDS)
    resp_t, mu_t, info = tsl.run_simulation_scan(rt_, pt, **RKW)
    assert info["turns"] == len(mu_r) and info["pend_overflow"] == 0
    if policy in REF_SCAN_X64_DRAWS:
        resp_h, mu_h = jr.run_simulation(_router(jr, policy), jr.SequentialPool(RSPEEDS),
                                         **RKW)
        assert not np.array_equal(resp_r[:8], resp_h[:8])
        resp_r, mu_r = resp_h, mu_h
    _by_turn(resp_t, resp_r)
    assert ulps(mu_t, mu_r) <= MU_ULPS


@pytest.mark.parametrize("policy", NEW_POLICIES)
def test_run_scenario_churn_host_and_scan_equal_for_every_policy(policy):
    """``env.run_scenario`` on churn (a membership mask, rejoins and probe
    bursts) through both loops on a SequentialPool: responses, μ̂ trace and
    replica clocks equal."""
    scn = tenv.make("churn", horizon=60.0)
    kw = dict(policy=policy, seed=1, arrival_batch=8, sequential_pool=True, device="cpu")
    h = tenv.run_scenario(scn, **kw)
    s = tenv.run_scenario(scn, use_scan=True, **kw)
    assert s["info"]["flush_overflow"] == 0 and s["info"]["pend_overflow"] == 0
    np.testing.assert_array_equal(h["responses"], s["responses"])
    np.testing.assert_array_equal(h["mu_trace"], s["mu_trace"])
    np.testing.assert_array_equal(h["pool"].free_at, s["pool"].free_at)
    assert np.isfinite(h["responses"]).all() and (h["responses"] > 0).all()


def test_serve_main_takes_every_policy():
    from repro_torch.launch import serve as tserve

    for policy in NEW_POLICIES:
        out = tserve.main(["--device", "cpu", "--executor", "replica", "--requests", "4",
                           "--arrival-batch", "2", "--n-new", "2", "--replicas", "3",
                           "--policy", policy])
        assert out["policy"] == policy and out["mean_ms"] > 0
