"""The port's PPoT-SQ(2) dispatch engine against the reference engine.

Exact where both sides see the same CDF or alias table: the μ̂ inputs below
sit on a 2**-8 grid with small sums, so every partial sum is exact in f32
whatever the order and both ``make_cdf``s give the same bits; alias
tables are the reference's, handed to both. Where a float reduction feeds
a result from general inputs, the bar is a stated tolerance: XLA's CPU
reductions sum in another order than torch's."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as rdsp
from repro.core import policies as rpol
from repro.kernels.ppot_dispatch import ref as rref
from repro_torch.core import dispatch as tdsp
from repro_torch.core import policies as tpol
from repro_torch.kernels.ppot_dispatch import ref as tref
from repro_torch.utils import prng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCFG, TCFG = rpol.default_policy_config(), tpol.default_policy_config()


def ulps(a, b) -> int:
    """Largest distance in f32 units in the last place (same-sign values)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(n: int, seed: int):
    rng = np.random.RandomState(seed)
    mu = (rng.randint(0, 1024, n) / 256.0).astype(np.float32)  # exact sums
    mu[rng.randint(n)] = 0.0
    q = rng.randint(0, 12, n).astype(np.int32)
    mask = rng.rand(n) < 0.7
    mask[0] = True
    return mu, q, mask


def _both(n, B, seed, *, fold_chunks, masked, alias, use_kernel, slots=False):
    mu, q, mask = _case(n, seed)
    key = jax.random.PRNGKey(seed)
    jm = jnp.asarray(mask) if masked else None
    tm = _t(mask) if masked else None
    rtab = ttab = None
    if alias:
        rtab = rdsp.build_alias_table(jnp.asarray(mu), jm)
        ttab = tdsp.AliasTable(_t(rtab.prob), _t(rtab.alias))
    act = np.random.RandomState(seed + 1).rand(B) < 0.8 if slots else None
    r = rdsp.dispatch(rpol.PPOT_SQ2, key, jnp.asarray(q), jnp.asarray(mu),
                      jnp.asarray(mu), RCFG, B, fold_chunks=fold_chunks,
                      use_kernel=use_kernel, interpret=True, table=rtab, mask=jm,
                      active=None if act is None else jnp.asarray(act))
    t = tdsp.dispatch(tpol.PPOT_SQ2, prng.PRNGKey(seed), _t(q), _t(mu), _t(mu),
                      TCFG, B, fold_chunks=fold_chunks, table=ttab, mask=tm,
                      active=None if act is None else _t(act))
    return r, t


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fold_chunks", [1, 4, "B"])
@pytest.mark.parametrize("n,B", [(16, 8), (64, 301)])
def test_engine_matches_reference(n, B, fold_chunks, masked, alias):
    C = B if fold_chunks == "B" else fold_chunks
    r, t = _both(n, B, n + B, fold_chunks=C, masked=masked, alias=alias,
                 use_kernel=False)
    np.testing.assert_array_equal(t.workers.numpy(), np.asarray(r.workers))
    np.testing.assert_array_equal(t.q_after.numpy(), np.asarray(r.q_after))
    if masked:
        assert _case(n, n + B)[2][t.workers.numpy()].all()


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_engine_kernel_paths_match_reference_kernel_paths(masked, alias):
    """Against the reference's kernel path (use_kernel=True): the fused
    (alias or CDF) kernel, or the select kernel for masked CDF batches. On
    CPU tensors the port's wrappers run their plain versions; the reference
    runs its Pallas kernels in interpret mode."""
    r, t = _both(64, 300, 5, fold_chunks=1, masked=masked, alias=alias,
                 use_kernel=True)
    np.testing.assert_array_equal(t.workers.numpy(), np.asarray(r.workers))
    np.testing.assert_array_equal(t.q_after.numpy(), np.asarray(r.q_after))


def test_engine_slot_mask_matches_reference():
    for C in (1, 4):
        r, t = _both(32, 50, 3, fold_chunks=C, masked=False, alias=True,
                     use_kernel=False, slots=True)
        np.testing.assert_array_equal(t.workers.numpy(), np.asarray(r.workers))
        np.testing.assert_array_equal(t.q_after.numpy(), np.asarray(r.q_after))


def test_dispatch_sequential_matches_reference():
    mu, q, _ = _case(16, 9)
    r = rdsp.dispatch_sequential(rpol.PPOT_SQ2, jax.random.PRNGKey(9),
                                 jnp.asarray(q), jnp.asarray(mu), jnp.asarray(mu),
                                 RCFG, 40)
    t = tdsp.dispatch_sequential(tpol.PPOT_SQ2, prng.PRNGKey(9), _t(q), _t(mu),
                                 _t(mu), TCFG, 40)
    np.testing.assert_array_equal(t.workers.numpy(), np.asarray(r.workers))
    np.testing.assert_array_equal(t.q_after.numpy(), np.asarray(r.q_after))


def test_other_policies_are_not_ported_yet():
    """Kept under its first name: every policy now places through the engine
    (tests/test_torch_policies.py holds each to the reference) and only an
    unknown name is refused, as the reference refuses it."""
    mu, q, _ = _case(8, 0)
    for policy in tpol.ALL_POLICIES:
        res = tdsp.dispatch(policy, prng.PRNGKey(0), _t(q), _t(mu), _t(mu), TCFG, 4)
        assert (res.workers >= 0).all() and int(res.q_after.sum()) == int(q.sum()) + 4
    with pytest.raises(ValueError, match="unknown policy"):
        tdsp.dispatch("nope", prng.PRNGKey(0), _t(q), _t(mu), _t(mu), TCFG, 4)


@pytest.mark.parametrize("B", [1, 17, 512])
def test_within_batch_rank_matches_reference(B):
    rng = np.random.RandomState(B)
    w = rng.randint(-1, 6, B).astype(np.int32)
    got = tdsp.within_batch_rank(_t(w), _t(w >= 0))
    want = rdsp.within_batch_rank(jnp.asarray(w), jnp.asarray(w >= 0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_active_choice_matches_reference():
    rng = np.random.RandomState(0)
    u = (rng.randint(0, 65536, 200) / 65536.0).astype(np.float32)
    for mask in (rng.rand(40) < 0.5, np.zeros(40, bool), np.ones(40, bool)):
        got = tdsp.active_choice(_t(mask), _t(u))
        want = rdsp._active_choice(jnp.asarray(mask), jnp.asarray(u))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


#: make_cdf / masked_cdf: torch.cumsum and XLA's cumsum round in another
#: order; measured at most 5 ulps over n <= 2048 (20 seeds each).
CDF_ULPS = 8


@pytest.mark.parametrize("n", [8, 64, 1024, 2048])
def test_cdf_within_stated_ulps(n):
    for s in range(10):
        rng = np.random.RandomState(s)
        mu = (rng.rand(n) * 5).astype(np.float32)
        mask = rng.rand(n) < 0.8
        assert ulps(tref.make_cdf(_t(mu)), rref.make_cdf(jnp.asarray(mu))) <= CDF_ULPS
        assert ulps(tdsp.masked_cdf(_t(mu), _t(mask)),
                    rdsp.masked_cdf(jnp.asarray(mu), jnp.asarray(mask))) <= CDF_ULPS


def _mu_cases(n: int, rng):
    """(μ̂, mask) pairs that K2 and K3 are fed: plain, zero, single-hot and
    masked μ̂, a mask with every active worker at zero, and every worker
    masked."""
    mu = (rng.rand(n) * 5).astype(np.float32)
    mask = rng.rand(n) < 0.8
    mask[0] = True
    hot = np.zeros(n, np.float32)
    hot[rng.randint(n)] = 3.0
    return [(mu, None), (np.zeros(n, np.float32), None), (hot, None), (mu, mask),
            (np.where(mask, 0, mu).astype(np.float32), mask),
            (mu, np.zeros(n, bool)), (hot, np.arange(n) % 3 == 0)]


def _bisect(cdf: np.ndarray, u: np.ndarray) -> np.ndarray:
    """The kernel's probe, modelled: binary lifting in power-of-two steps
    from the smallest power of two >= n, then the clip to n - 1."""
    n = len(cdf)
    a = np.zeros(len(u), np.int64)
    step = 1 if n <= 1 else 1 << (n - 1).bit_length()
    while step:
        c = cdf[np.minimum(a + step, n) - 1]
        a += np.where((a + step <= n) & (c <= u), step, 0)
        step >>= 1
    return np.minimum(a, n - 1).astype(np.int32)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000, 1024, 2048])
def test_cdf_producers_are_sorted_so_bisection_equals_the_dense_count(n):
    """K2 and K3 bisect the cdf. make_cdf and masked_cdf are non-decreasing
    on every kind of μ̂ the engine feeds them, and on them the bisection
    (searchsorted, and the kernel's lifting modelled) equals the dense
    count of ref.cdf_probe, ties and zero-mass plateaus included."""
    rng = np.random.RandomState(n)
    for mu, mask in _mu_cases(n, rng):
        cdf = tref.make_cdf(_t(mu)) if mask is None else tdsp.masked_cdf(_t(mu), _t(mask))
        c = cdf.numpy()
        assert not np.isnan(c).any() and (c[1:] >= c[:-1]).all()
        u = np.concatenate([rng.randint(0, 65536, 300) / 65536.0, rng.rand(100),
                            c, np.nextafter(c, 0), [0.0]]).astype(np.float32)
        want = tref.cdf_probe(cdf, _t(u)).numpy()
        got = torch.searchsorted(cdf, _t(u), right=True).clamp(max=n - 1)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(_bisect(c, u), want)


def test_bisection_needs_a_sorted_cdf():
    """The precondition is real: on an unsorted cdf the bisection and the
    dense count part."""
    cdf = np.array([0.5, 0.2, 0.9, 1.0], np.float32)
    u = np.array([0.3], np.float32)
    dense = tref.cdf_probe(_t(cdf), _t(u)).numpy()
    assert dense[0] == 1 and _bisect(cdf, u)[0] == 2
    assert torch.searchsorted(_t(cdf), _t(u), right=True)[0] != dense[0]


#: build_alias_table: the scaled weights p = w * (n / sum(w)) inherit the
#: sum's reduction order (measured at most 8 ulps, n <= 2048). The pairing
#: walk is exact given the same p (test_torch_ppot_kernels), but a
#: different last bit in p can move a residual across 1.0 and so pair bins
#: differently; the sampled distribution, each worker's mass
#: (own prob + incoming alias mass) / n, agrees within 1e-6.
P_ULPS, MASS_ATOL = 8, 1e-6


def _mass(prob, alias):
    prob = np.asarray(prob, np.float64)
    m = prob.copy()
    np.add.at(m, np.asarray(alias), 1.0 - prob)
    return m / len(prob)


@pytest.mark.parametrize("n", [8, 64, 1024, 2048])
def test_alias_table_within_stated_tolerance(n):
    for s in range(10):
        rng = np.random.RandomState(s)
        mu = (rng.rand(n) * 5).astype(np.float32)
        active = rng.rand(n) < 0.8 if s % 2 else None
        w = jnp.asarray(mu)
        p_ref = (w * (n / jnp.sum(w))).astype(jnp.float32)
        tw = _t(mu)
        p_port = tw * (torch.full_like(tw.sum(), n) / tw.sum())
        assert ulps(p_port, p_ref) <= P_ULPS
        rt = rdsp.build_alias_table(w, None if active is None else jnp.asarray(active))
        tt = tdsp.build_alias_table(tw, None if active is None else _t(active))
        np.testing.assert_allclose(_mass(tt.prob, tt.alias), _mass(rt.prob, rt.alias),
                                   rtol=0, atol=MASS_ATOL)
        if active is not None:  # the hard mask guarantee holds exactly
            assert (tt.prob.numpy()[~active] == 0).all()
            assert active[tt.alias.numpy()].all()


def test_alias_table_degenerate_cases():
    t = tdsp.build_alias_table(torch.ones(8))
    assert (t.prob == 1).all()
    t = tdsp.build_alias_table(torch.tensor([0.0, 0.0, 4.0, 0.0]))
    u = torch.linspace(0.0, 0.999, 37)
    assert (tdsp.alias_sample(t, u, u) == 2).all()
    t = tdsp.build_alias_table(torch.zeros(4))
    np.testing.assert_allclose(_mass(t.prob, t.alias), 0.25, atol=1e-7)


def test_port_imports_neither_jax_nor_the_reference():
    """Import every module of repro_torch, and chip_smoke, with jax and
    repro blocked."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        BLOCKED = ("jax", "jaxlib", "repro")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked: {name}")

        sys.meta_path.insert(0, Block())
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        bad = [k for k in sys.modules if k.split(".")[0] in BLOCKED]
        assert not bad, bad
        for m in ("repro_torch.models.ssm", "repro_torch.kernels.ssd_scan.kernel",
                  "repro_torch.kernels.ssd_scan.ops", "repro_torch.kernels.ssd_scan.ref",
                  "repro_torch.kernels.ssd_scan.build", "repro_torch.serving.scanloop",
                  "repro_torch.kernels.pool_chain.kernel",
                  "repro_torch.kernels.pool_chain.ref",
                  "repro_torch.kernels.pool_chain.build", "repro_torch.utils.scalars",
                  "repro_torch.env", "repro_torch.env.processes", "repro_torch.env.scenario",
                  "repro_torch.env.serving", "repro_torch.core.metrics",
                  "repro_torch.core.policies", "repro_torch.core.scheduler",
                  "repro_torch.core.estimator", "repro_torch.serving.router",
                  "repro_torch.serving.recovery", "repro_torch.dist.straggler",
                  "repro_torch.obs", "repro_torch.obs.windows", "repro_torch.obs.detect",
                  "repro_torch.obs.slo", "repro_torch.obs.export", "repro_torch.obs.tracing",
                  "repro_torch.fleet", "repro_torch.fleet.conflict", "repro_torch.fleet.state",
                  "repro_torch.fleet.sync", "repro_torch.load", "repro_torch.load.traces",
                  "repro_torch.load.stream", "repro_torch.core.simulator",
                  "repro_torch.core.theory", "repro_torch.configs.rosella_sim",
                  "repro_torch.kernels.sim_chain", "repro_torch.kernels.sim_chain.kernel",
                  "repro_torch.kernels.sim_chain.ref", "repro_torch.kernels.sim_chain.build"):
            assert m in sys.modules, m
        print("clean")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("slots", [False, True])
def test_every_single_chunk_batch_goes_through_a_kernel_wrapper(monkeypatch, alias,
                                                                masked, slots):
    """C = 1 batches never select with tensor ops of their own: each calls
    exactly one dispatch wrapper (which on CUDA tensors launches its
    kernel); inactive slots place nothing and masked workers get nothing."""
    from repro_torch.kernels.ppot_dispatch import kernel as K

    calls = []
    for name in ("ppot_dispatch_fused_alias", "ppot_dispatch_fused", "ppot_dispatch"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    mu, q, mask = _case(64, 11)
    tab = tdsp.build_alias_table(_t(mu), _t(mask) if masked else None) if alias else None
    act = _t(np.random.RandomState(12).rand(40) < 0.8) if slots else None
    res = tdsp.dispatch(tpol.PPOT_SQ2, prng.PRNGKey(11), _t(q), _t(mu), _t(mu), TCFG, 40,
                        active=act, table=tab, mask=_t(mask) if masked else None)
    want = ("ppot_dispatch_fused_alias" if alias else
            "ppot_dispatch" if masked or slots else "ppot_dispatch_fused")
    assert calls == [want]
    w = res.workers.numpy()
    placed = w[w >= 0]
    if slots:
        assert ((w >= 0) == act.numpy()).all()
    if masked:
        assert mask[placed].all()
    np.testing.assert_array_equal(res.q_after.numpy(), q + np.bincount(placed, minlength=64))


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_engine_takes_a_device_key(alias, masked):
    """The device-resident turn passes its key as an int64 tensor [2]: the
    same draws and placements as the host key, for keys with bit 31 set."""
    mu, q, mask = _case(64, 21)
    tm = _t(mask) if masked else None
    tab = tdsp.build_alias_table(_t(mu), tm) if alias else None
    for key in (prng.PRNGKey(21), (0xFFFFFFFF, 0x80000000), (0x9E3779B9, 0xC2B2AE35)):
        want = tdsp.dispatch(tpol.PPOT_SQ2, key, _t(q), _t(mu), _t(mu), TCFG, 40,
                             table=tab, mask=tm)
        got = tdsp.dispatch(tpol.PPOT_SQ2, prng.device_key(key, "cpu"), _t(q), _t(mu),
                            _t(mu), TCFG, 40, table=tab, mask=tm)
        assert torch.equal(got.workers, want.workers)
        assert torch.equal(got.q_after, want.q_after)
