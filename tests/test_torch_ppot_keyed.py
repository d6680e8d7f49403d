"""The keyed K1 (``ppot_dispatch_fused_alias_keyed``: the alias dispatch
kernel drawing its own uniforms from the route key) on the CPU, where its
wrapper runs the plain version, against the reference package.

The reference draws ``_uniform_quad(key, B)`` and feeds the Pallas K1
(interpret mode), or, with a slot mask, its engine's ``_dispatch_impl``.
Both sides get the same alias table (the reference's, built from seeded
numpy μ̂) and the same queue; the key is given as a ``jax.random`` key and
as the port's host key and device key. The work is integer hashing,
compares, gathers and counts, so every comparison is exact."""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as rdsp
from repro.core import policies as rpol
from repro.kernels.ppot_dispatch import kernel as rk
from repro_torch.core import dispatch as tdsp
from repro_torch.core import policies as tpol
from repro_torch.kernels.ppot_dispatch import kernel as tk
from repro_torch.kernels.ppot_dispatch import ref as tref
from repro_torch.utils import prng

RCFG, TCFG = rpol.default_policy_config(), tpol.default_policy_config()
SHAPES = [(n, B) for n in (1, 8, 1024, 2048) for B in (1, 127, 128, 1025, 8193)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _mu(case: str, n: int, rng) -> np.ndarray:
    if case == "random":
        return (rng.rand(n) * 5).astype(np.float32)
    mu = np.zeros(n, np.float32)
    if case == "single_hot":
        mu[rng.randint(n)] = 3.0
    return mu


def _case(n: int, B: int, case: str, masked: bool, seed: int):
    """μ̂, the reference's alias table (with a tenth of the workers off if
    ``masked``), the queue, a slot mask and pins, as numpy arrays."""
    rng = np.random.RandomState(seed + 7 * n + B)
    mu = _mu(case, n, rng)
    member = tref.make_mask("tenth_off", n, rng) if masked else None
    table = rdsp.build_alias_table(jnp.asarray(mu),
                                   None if member is None else jnp.asarray(member))
    q = rng.randint(0, 20, n).astype(np.int32)
    slots = rng.rand(B) < 0.8
    pins = np.where(rng.rand(B) < 0.1, rng.randint(0, n, B), -1).astype(np.int32)
    return (mu, member, np.asarray(table.prob), np.asarray(table.alias), q, slots, pins,
            table)


def _keys(seed: int):
    """(jax key, the port's host key, its device key) with the same words:
    PRNGKey(seed), and a split of it (words with any bits set)."""
    jkey = jax.random.PRNGKey(seed)
    hkey = prng.PRNGKey(seed)
    yield jkey, hkey, prng.device_key(hkey, "cpu")
    jsub = jax.random.split(jkey)[1]
    hsub = prng.split(hkey)[1]
    assert tuple(np.asarray(jsub, np.uint32).tolist()) == hsub
    yield jsub, hsub, prng.device_key(hsub, "cpu")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["random", "zero", "single_hot"])
@pytest.mark.parametrize("n,B", SHAPES)
def test_keyed_plain_version_matches_uniform_quad_and_pallas(n, B, case, masked):
    """workers and q_after equal the reference's ``_uniform_quad`` fed to
    its Pallas K1 (interpret mode), for each form of the key."""
    seed = n + B
    _, _, prob, alias, q, _, _, _ = _case(n, B, case, masked, seed)
    for jkey, hkey, dkey in _keys(seed):
        u1, u2, v1, v2 = rdsp._uniform_quad(jkey, B)
        ww, wq = rk.ppot_dispatch_fused_alias(jnp.asarray(prob), jnp.asarray(alias),
                                              jnp.asarray(q), u1, v1, u2, v2, interpret=True)
        for key in (hkey, dkey):
            tk.reset_launches()
            gw, gq = tk.ppot_dispatch_fused_alias_keyed(_t(prob), _t(alias), _t(q), key, B)
            assert sum(tk.launch_counts().values()) == 0  # CPU tensors: the plain version
            np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
            np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        # the port's counter hash is the reference's, word for word
        for mine, theirs in zip(prng.uniform_quad(hkey, B), (u1, u2, v1, v2)):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,B", SHAPES)
def test_keyed_plain_version_with_slots_matches_dispatch_impl(n, B, masked):
    """With a slot mask: workers (-1 at an inactive slot) and q_after (the
    active slots folded in) equal the reference engine's PPoT-SQ(2) batch
    at C = 1 on the same table and slots, and so does the port's engine."""
    seed = 3 * n + B
    mu, member, prob, alias, q, slots, _, table = _case(n, B, "random", masked, seed)
    jm = None if member is None else jnp.asarray(member)
    tm = None if member is None else _t(member)
    ttab = tdsp.AliasTable(_t(prob), _t(alias))
    for jkey, hkey, dkey in _keys(seed):
        want = rdsp._dispatch_impl(rpol.PPOT_SQ2, jkey, jnp.asarray(q), jnp.asarray(mu),
                                   jnp.asarray(mu), RCFG, B, active=jnp.asarray(slots),
                                   table=table, mask=jm)
        for key in (hkey, dkey):
            for got in (tk.ppot_dispatch_fused_alias_keyed(_t(prob), _t(alias), _t(q), key, B,
                                                           _t(slots)),
                        tdsp.dispatch(tpol.PPOT_SQ2, key, _t(q), _t(mu), _t(mu), TCFG, B,
                                      active=_t(slots), table=ttab, mask=tm)):
                np.testing.assert_array_equal(got[0].numpy(), np.asarray(want.workers))
                np.testing.assert_array_equal(got[1].numpy(), np.asarray(want.q_after))


def _before(key, B, q, table, active, forced):
    """The engine's alias batch as it was composed before K1 drew its own
    uniforms: ``prng.uniform_quad``, the unkeyed K1's plain version on every
    slot, then the pins and the fold of the active slots."""
    u1, u2, v1, v2 = prng.uniform_quad(key, B)
    workers, q_after = tref.ppot_dispatch_fused_alias_ref(table.prob, table.alias, q,
                                                          u1, v1, u2, v2)
    if forced is None and active is None:
        return workers, q_after
    if forced is not None:
        workers = torch.where(forced >= 0, forced, workers)
    return tuple(tdsp._fold(q, workers, active))


@pytest.mark.parametrize("pins", [False, True])
@pytest.mark.parametrize("slots", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,B", SHAPES)
def test_dispatch_alias_path_unchanged(n, B, masked, slots, pins):
    """``dispatch()`` on the alias path gives the results it gave before
    the keyed K1, with and without slots and pins, for both key forms; and
    it equals the reference engine there."""
    seed = 5 * n + B
    mu, member, prob, alias, q, act, forced, table = _case(n, B, "random", masked, seed)
    ttab = tdsp.AliasTable(_t(prob), _t(alias))
    tm = None if member is None else _t(member)
    ta = _t(act) if slots else None
    tf = _t(forced) if pins else None
    jkey, hkey, dkey = next(_keys(seed))
    want = rdsp._dispatch_impl(rpol.PPOT_SQ2, jkey, jnp.asarray(q), jnp.asarray(mu),
                               jnp.asarray(mu), RCFG, B,
                               active=jnp.asarray(act) if slots else None,
                               forced=jnp.asarray(forced) if pins else None, table=table,
                               mask=None if member is None else jnp.asarray(member))
    before = _before(hkey, B, _t(q), ttab, ta, tf)
    for key in (hkey, dkey):
        got = tdsp.dispatch(tpol.PPOT_SQ2, key, _t(q), _t(mu), _t(mu), TCFG, B, active=ta,
                            forced=tf, table=ttab, mask=tm)
        for g, b, w in zip(got, before, want):
            assert g.dtype == b.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), b.numpy())
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_keyed_plain_version_takes_an_empty_batch():
    prob, alias = torch.ones(4), torch.arange(4, dtype=torch.int32)
    q = torch.tensor([3, 0, 2, 1], dtype=torch.int32)
    w, qa = tk.ppot_dispatch_fused_alias_keyed(prob, alias, q, prng.PRNGKey(0), 0)
    assert w.shape == (0,) and w.dtype == torch.int32 and torch.equal(qa, q)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    rng = np.random.RandomState(0)
    prob, alias, q = _t(np.float32(rng.rand(16))), _t(np.int32(rng.randint(0, 16, 16))), \
        _t(np.int32(rng.randint(0, 9, 16)))
    act = _t(rng.rand(40) < 0.5)
    key = prng.PRNGKey(9)
    tk.reset_launches()
    got = tk.ppot_dispatch_fused_alias_keyed(prob, alias, q, key, 40, act)
    want = tref.ppot_dispatch_fused_alias_keyed_ref(prob, alias, q, key, 40, act)
    u1, u2, v1, v2 = prng.uniform_quad(key, 40)
    unkeyed = tk.ppot_dispatch_fused_alias(prob, alias, q, u1, v1, u2, v2)
    assert tk.launch_counts() == dict.fromkeys(tk.launches, 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(unkeyed[0], tref.ppot_dispatch_alias_ref(prob, alias, q, u1, v1, u2, v2))


def _bad_calls():
    """(what the error names, the arguments that differ from a good call)"""
    prob, alias, q = torch.ones(8), torch.arange(8, dtype=torch.int32), \
        torch.zeros(8, dtype=torch.int32)
    yield "prob", dict(prob=prob.double())
    yield "alias", dict(alias=alias.long())
    yield "q", dict(q=q[:7])
    yield "q", dict(q=torch.zeros(16, dtype=torch.int32)[::2])  # not contiguous
    yield "need at least one worker", dict(prob=prob[:0], alias=alias[:0], q=q[:0])
    yield "active", dict(active=torch.ones(5, dtype=torch.bool))  # not B slots
    yield "active", dict(active=torch.ones(4, dtype=torch.int32))
    yield "key", dict(key=torch.zeros(2, dtype=torch.int32))
    yield "key", dict(key=torch.zeros(3, dtype=torch.int64))
    yield "key", dict(key=torch.zeros(4, dtype=torch.int64)[::2])
    yield "key", dict(key=(2**32, 0))
    yield "key", dict(key=(0, -1))
    yield "negative batch", dict(B=-1)


BAD_CALLS = list(_bad_calls())


@pytest.mark.parametrize("match,kw", BAD_CALLS, ids=[f"{i}-{m}" for i, (m, _) in
                                                     enumerate(BAD_CALLS)])
def test_keyed_wrapper_refuses_bad_inputs(match, kw):
    prob, alias, q = torch.ones(8), torch.arange(8, dtype=torch.int32), \
        torch.zeros(8, dtype=torch.int32)
    args = dict(prob=prob, alias=alias, q=q, key=prng.PRNGKey(1), B=4, active=None)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        tk.ppot_dispatch_fused_alias_keyed(**args)
