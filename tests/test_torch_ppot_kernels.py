"""The PPoT dispatch kernels' plain versions against the reference Pallas
kernels (interpret mode), the alias-table build (the stack walk, the
kernel's restructured walk, and the whole build against the reference's)
and the wrappers' checks. K1 here is its unkeyed entry, on given uniforms;
the keyed entry the engine launches (``ppot_dispatch_fused_alias_keyed``,
its uniforms drawn from the route key) has its tests in
tests/test_torch_ppot_keyed.py.
The CUDA kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Both sides get the same inputs, made by numpy from a seed: the same cdf or
alias table, the same queue and the same uniforms. The work is compares,
gathers and integer counts, so every comparison is exact."""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as rdsp
from repro.kernels.ppot_dispatch import kernel as rk
from repro.kernels.ppot_dispatch import ref as rref
from repro_torch.kernels.ppot_dispatch import kernel as tk
from repro_torch.kernels.ppot_dispatch import ref as tref


def _mu(case: str, n: int, rng) -> np.ndarray:
    if case == "random":
        return (rng.rand(n) * 5).astype(np.float32)
    if case == "zero":
        return np.zeros(n, np.float32)
    mu = np.zeros(n, np.float32)  # single-hot
    mu[rng.randint(n)] = 3.0
    return mu


def _inputs(n: int, B: int, case: str, seed: int = 0):
    rng = np.random.RandomState(seed + 7 * n + B)
    mu = _mu(case, n, rng)
    q = rng.randint(0, 20, n).astype(np.int32)
    # the engine's 2**-16 grid for half the batch, full f32 draws for the rest
    us = []
    for _ in range(4):
        u = rng.rand(B).astype(np.float32)
        u[: B // 2] = rng.randint(0, 65536, B // 2) / 65536.0
        us.append(u)
    return mu, q, us


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", ["random", "zero", "single_hot"])
@pytest.mark.parametrize("B", [1, 300, 1024])
@pytest.mark.parametrize("n", [8, 64, 1024])
def test_plain_versions_match_pallas_kernels(n, B, case):
    mu, q, (u1, u2, v1, v2) = _inputs(n, B, case)
    cdf = np.asarray(rref.make_cdf(jnp.asarray(mu)))
    table = rdsp.build_alias_table(jnp.asarray(mu))
    prob, alias = np.asarray(table.prob), np.asarray(table.alias)
    jq, ju1, ju2, jv1, jv2 = map(jnp.asarray, (q, u1, u2, v1, v2))

    # K3: select only
    want = rk.ppot_dispatch(jnp.asarray(cdf), jq, ju1, ju2, interpret=True)
    got = tk.ppot_dispatch(_t(cdf), _t(q), _t(u1), _t(u2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # K2: inverse-CDF probe + select + fold
    ww, wq = rk.ppot_dispatch_fused(jnp.asarray(cdf), jq, ju1, ju2, interpret=True)
    gw, gq = tk.ppot_dispatch_fused(_t(cdf), _t(q), _t(u1), _t(u2))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    # K1: alias probe + select + fold
    ww, wq = rk.ppot_dispatch_fused_alias(
        jnp.asarray(prob), jnp.asarray(alias), jq, ju1, jv1, ju2, jv2,
        interpret=True)
    gw, gq = tk.ppot_dispatch_fused_alias(
        _t(prob), _t(alias), _t(q), _t(u1), _t(v1), _t(u2), _t(v2))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    # and the reference's own plain versions
    np.testing.assert_array_equal(
        tref.ppot_dispatch_alias_ref(_t(prob), _t(alias), _t(q), _t(u1), _t(v1),
                                     _t(u2), _t(v2)).numpy(),
        np.asarray(rref.ppot_dispatch_alias_ref(
            jnp.asarray(prob), jnp.asarray(alias), jq, ju1, jv1, ju2, jv2)))


def _exact_weights(n: int, rng, zeros: int = 0) -> np.ndarray:
    """Weights on a 2**-8 grid summing to exactly n: every partial sum is
    exact in f32 in any order, so both packages scale them by exactly 1 and
    the pairing walks see the same p."""
    a = rng.randint(0, 4 * 256, n).astype(np.int64)
    a[rng.choice(n, zeros, replace=False)] = 0
    a = a * (256 * n) // max(a.sum(), 1)
    a[np.argmax(a)] += 256 * n - a.sum()
    return (a / 256.0).astype(np.float32)


@pytest.mark.parametrize("n,zeros", [(1, 0), (8, 0), (64, 10), (1024, 100), (2048, 0)])
def test_alias_pairing_matches_reference_on_same_p(n, zeros):
    """Given the same scaled weights p, the pairing walk is exact."""
    from repro_torch.core import dispatch as tdsp

    rng = np.random.RandomState(n)
    p = _exact_weights(n, rng, zeros)
    want = rdsp.build_alias_table(jnp.asarray(p))
    got = tdsp.build_alias_table(_t(p))
    np.testing.assert_array_equal(got.prob.numpy(), np.asarray(want.prob))
    np.testing.assert_array_equal(got.alias.numpy(), np.asarray(want.alias))


@pytest.mark.parametrize("kind", tref.MASKS)
@pytest.mark.parametrize("n", [1, 8, 64, 1024, 2048])
def test_alias_table_matches_reference_exactly_on_grid_weights(n, kind):
    """The port's build_alias_table (on the CPU: the scaling, then
    ``ref.alias_table_ref``) is bit-identical to the reference's, masked or
    not, wherever both see the same scaled weights: the masked twin of
    test_alias_pairing_matches_reference_on_same_p."""
    from repro_torch.core import dispatch as tdsp

    rng = np.random.RandomState(n + len(kind))
    mu = _exact_weights(n, rng, zeros=n // 10)
    m = tref.make_mask(kind, n, rng)
    want = rdsp.build_alias_table(jnp.asarray(mu), None if m is None else jnp.asarray(m))
    got = tdsp.build_alias_table(_t(mu), None if m is None else _t(m))
    np.testing.assert_array_equal(got.prob.numpy().view(np.int32),
                                  np.asarray(want.prob).view(np.int32))
    np.testing.assert_array_equal(got.alias.numpy(), np.asarray(want.alias))


def _bits(t) -> np.ndarray:
    a = np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _sweep_p(case: str, n: int) -> np.ndarray:
    """Scaled weights for the walk. The planted cases put a small at the
    highest index and a large at index 0, so that the first step pairs them
    and leaves the large's residual at exactly 1.0 or one ulp below it."""
    rng = np.random.RandomState(100 + n)
    if case == "random":
        p = rng.rand(n) * 2
    elif case == "grid_zeros":
        p = _exact_weights(n, rng, zeros=n // 10)
    elif case == "single_hot":
        p = np.zeros(n)
        p[rng.randint(n)] = n
    elif case == "uniform":
        p = np.ones(n)
    elif case == "all_small":  # float drift can leave every p below 1
        p = np.full(n, 1 - 2.0 ** -24)
    elif case == "smalls_left":  # mean below 1: the larges run out first
        p = rng.rand(n) * 0.5 + 0.3
        p[: max(n // 8, 1)] = 1.2
    elif case == "nan":
        p = rng.rand(n) * 2
        p[n // 2] = np.nan
    else:
        p = rng.rand(n) * 2
        if n > 1:
            p[0], p[n - 1] = 1.5, {"residual_one": 0.5,
                                   "residual_below": 0.5 - 2.0 ** -24}[case]
    return p.astype(np.float32)


SWEEP_CASES = ["random", "grid_zeros", "single_hot", "uniform", "all_small",
               "smalls_left", "nan", "residual_one", "residual_below"]


@pytest.mark.parametrize("case", SWEEP_CASES)
@pytest.mark.parametrize("n", [1, 2, 7, 64, 1024, 2048])
def test_alias_sweep_matches_the_stack_walk(n, case):
    """The kernel's walk (two sequences, the residual large as the next
    small) is bit-identical to the reference's stack walk."""
    p = _t(_sweep_p(case, n))
    want = tref.alias_pairing_ref(p, *tref.stack_order(p))
    got = tref.alias_sweep_ref(p)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w.numpy()))
    prob, pn = got[0].numpy(), p.numpy()
    if case == "smalls_left" and n > 2:  # some small was never finalised
        assert ((pn < 1) & (prob == 1)).any()
    if case in ("residual_one", "residual_below") and n > 1:
        assert prob[n - 1] == pn[n - 1] and got[1][n - 1] == 0


@pytest.mark.parametrize("case", ["random", "grid_zeros", "nan", "residual_below"])
@pytest.mark.parametrize("masked", [False, True])
def test_alias_table_ref_is_the_stack_walk_and_the_mask_pass(case, masked):
    """alias_table_ref (the CPU path and the card's oracle) composes the
    stack order, the unchanged stack walk and the reference's mask pass."""
    n = 64
    p = _t(_sweep_p(case, n))
    active = _t(np.random.RandomState(3).rand(n) < 0.8) if masked else None
    prob, alias = tref.alias_table_ref(p, active)
    want_prob, want_alias = tref.alias_pairing_ref(p, *tref.stack_order(p))
    if masked:
        a = active.numpy()
        assert (prob.numpy()[~a] == 0).all() and a[alias.numpy()].all()
        keep = a & a[want_alias.numpy()]
        np.testing.assert_array_equal(alias.numpy()[keep], want_alias.numpy()[keep])
        np.testing.assert_array_equal(_bits(prob.numpy()[a]), _bits(want_prob.numpy()[a]))
    else:
        np.testing.assert_array_equal(_bits(prob.numpy()), _bits(want_prob.numpy()))
        np.testing.assert_array_equal(alias.numpy(), want_alias.numpy())


def test_alias_table_wrapper_checks_and_cpu_path():
    p = _t(_sweep_p("random", 16))
    active = _t(np.arange(16) % 4 != 0)
    tk.reset_launches()
    for a in (None, active):
        got = tk.alias_table(p, a)
        for g, w in zip(got, tref.alias_table_ref(p, a)):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w.numpy()))
    assert set(tk.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="active"):
        tk.alias_table(p, active.to(torch.int32))
    with pytest.raises(ValueError, match="active"):
        tk.alias_table(p, active[:8])
    with pytest.raises(ValueError, match="p"):
        tk.alias_table(p.double())


def test_wrappers_check_their_inputs():
    mu, q, (u1, u2, v1, v2) = _inputs(8, 16, "random")
    cdf = _t(np.cumsum(mu) / mu.sum()).float()
    with pytest.raises(ValueError, match="q"):
        tk.ppot_dispatch(cdf, _t(q).long(), _t(u1), _t(u2))
    with pytest.raises(ValueError, match="u2"):
        tk.ppot_dispatch_fused(cdf, _t(q), _t(u1), _t(u2[:5]))
    with pytest.raises(ValueError, match="contiguous"):
        tk.ppot_dispatch(cdf, _t(q), _t(np.repeat(u1, 2))[::2], _t(u2))


def test_cpu_tensors_take_the_plain_version_without_counting():
    """A CPU call runs the plain version; only kernel launches count."""
    mu, q, (u1, u2, _, _) = _inputs(8, 16, "random")
    cdf = _t(np.cumsum(mu) / mu.sum()).float()
    tk.reset_launches()
    w = tk.ppot_dispatch(cdf, _t(q), _t(u1), _t(u2))
    np.testing.assert_array_equal(
        w.numpy(), tref.ppot_dispatch_ref(cdf, _t(q), _t(u1), _t(u2)).numpy())
    assert set(tk.launch_counts().values()) == {0}


@pytest.mark.parametrize("B", [1, 300])
def test_standalone_entry_points_match_reference_ops(B):
    """ops.dispatch / dispatch_fused / dispatch_ref draw jax.random.uniform's
    threefry stream; on a μ̂ whose CDF is exact in any summation order they
    match the reference's entry points bit for bit."""
    import jax

    from repro.kernels.ppot_dispatch import ops as rops
    from repro_torch.kernels.ppot_dispatch import ops as tops
    from repro_torch.utils import prng

    rng = np.random.RandomState(B)
    mu = (rng.randint(1, 1024, 64) / 256.0).astype(np.float32)
    q = rng.randint(0, 9, 64).astype(np.int32)
    jk, tk_ = jax.random.PRNGKey(B), prng.PRNGKey(B)
    for r_fn, t_fn, kw in ((rops.dispatch, tops.dispatch, {"interpret": True}),
                           (rops.dispatch_fused, tops.dispatch_fused, {"interpret": True}),
                           (rops.dispatch_ref, tops.dispatch_ref, {})):
        want = r_fn(jk, jnp.asarray(mu), jnp.asarray(q), B, **kw)
        got = t_fn(tk_, _t(mu), _t(q), B)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
