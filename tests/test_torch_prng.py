"""The port's key stream against jax.random and the reference's counter-hash
uniforms: integer-only work, so every comparison is exact."""
import jax
import numpy as np
import pytest

from repro.core import dispatch as rdsp
from repro_torch.utils import prng

SEEDS = [0, 1, 12345, 2**31 - 1, 2**32 - 1, 2**33 + 7, -1] + list(
    np.random.RandomState(0).randint(0, 2**31 - 1, size=100))


def _words(k) -> tuple:
    return tuple(int(x) for x in np.asarray(k, np.uint32))


def test_prngkey_split_fold_in_match_jax():
    for s in SEEDS:
        jk, tk = jax.random.PRNGKey(int(s)), prng.PRNGKey(int(s))
        assert _words(jk) == tk, s
        assert [_words(k) for k in jax.random.split(jk, 3)] == prng.split(tk, 3), s
        d = int(s) % 1000
        assert _words(jax.random.fold_in(jk, d)) == prng.fold_in(tk, d), s


def test_split_chain_matches_jax():
    """The router's key stream: 200 successive splits stay equal."""
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for _ in range(200):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        assert _words(jk) == tk and _words(jsub) == tsub


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_uniform_matches_jax(n):
    for s in SEEDS[:20]:
        jk = jax.random.PRNGKey(int(s))
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jk, (n,))),
            prng.uniform(prng.PRNGKey(int(s)), n).numpy())


@pytest.mark.parametrize("B", [1, 7, 4096])
def test_counter_hash_uniforms_match_reference(B):
    for s in SEEDS[:20]:
        jk, tk = jax.random.PRNGKey(int(s)), prng.PRNGKey(int(s))
        for a, b in zip(rdsp._uniform_pair(jk, B), prng.uniform_pair(tk, B)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for a, b in zip(rdsp._uniform_quad(jk, B), prng.uniform_quad(tk, B)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_fmix32_matches_reference_on_edge_words():
    """Words whose products overflow int64 if not split (top bit set)."""
    import jax.numpy as jnp
    import torch

    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF], np.uint32)
    want = np.asarray(rdsp._fmix32(jnp.asarray(x)))
    got = prng.fmix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
