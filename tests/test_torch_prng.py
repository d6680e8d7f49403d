"""The port's key stream against jax.random and the reference's counter-hash
uniforms: integer-only work, so every comparison is exact."""
import torch_threads  # noqa: F401  (one torch thread a test worker)
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


#: host keys with bit 31 set in either word, where a plain product of the
#: second word by a 32-bit constant leaves int64's range
HIGH_KEYS = [(0x80000000, 0xFFFFFFFF), (0xDEADBEEF, 0x80000001), (0xFFFFFFFF, 0xFFFFFFFF),
             (0, 0x80000000)]


def test_device_keys_give_the_host_keys_words():
    """A key held as an int64 tensor [2] (the device-resident turn's)
    splits, folds and draws the same words as the host ints, bit for bit."""
    import torch

    keys = HIGH_KEYS + [prng.PRNGKey(int(s)) for s in SEEDS[:30]]
    keys += [k for s in SEEDS[:10] for k in prng.split(prng.PRNGKey(int(s)), 3)]
    assert any(k[1] >= 2**31 for k in keys) and any(k[0] >= 2**31 for k in keys)
    for k in keys:
        dk = prng.device_key(k, "cpu")
        assert dk.dtype == torch.int64 and prng.host_key(dk) == k
        got = prng.split(dk, 3)
        assert got.shape == (3, 2) and [tuple(r.tolist()) for r in got] == prng.split(k, 3)
        a, b = prng.split(dk)  # unpacks row by row, as the host list does
        assert (prng.host_key(a), prng.host_key(b)) == tuple(prng.split(k))
        assert prng.host_key(prng.fold_in(dk, 77)) == prng.fold_in(k, 77)
        for x, y in zip(prng.uniform_pair(dk, 64), prng.uniform_pair(k, 64)):
            assert torch.equal(x, y)
        for x, y in zip(prng.uniform_quad(dk, 64), prng.uniform_quad(k, 64)):
            assert torch.equal(x, y)
        assert torch.equal(prng.uniform(dk, 16), prng.uniform(k, 16))


def test_device_key_chain_matches_jax():
    """The serving turn's two splits a turn, 100 turns, with the key
    carried as a tensor."""
    jk = jax.random.PRNGKey(11)
    tk = prng.device_key(prng.PRNGKey(11), "cpu")
    for _ in range(100):
        jk, jf = jax.random.split(jk)
        jk, jr_ = jax.random.split(jk)
        tk, tf = prng.split(tk)
        tk, tr_ = prng.split(tk)
        for j, t in ((jk, tk), (jf, tf), (jr_, tr_)):
            assert _words(j) == prng.host_key(t)
