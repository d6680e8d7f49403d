"""The port's int8 gradient compression (``repro_torch.dist.compression``)
against the JAX package's: ``q`` and ``scale`` bit-equal on the same
input and key (the uniforms are ``prng.uniform``, ``jax.random.uniform``
bit for bit), and |decompress(compress(x)) - x| <= scale."""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import types

import numpy as np
import pytest
import torch

from repro_torch.dist import compression as tc
from repro_torch.utils import prng
from test_torch_model import reference_shim


@pytest.fixture(scope="module")
def ref():
    with reference_shim():
        import jax
        import jax.numpy as jnp

        from repro.dist import compression

        yield types.SimpleNamespace(jax=jax, jnp=jnp, c=compression)


@pytest.mark.parametrize("shape,seed,scale", [((257,), 0, 1.0), ((16, 33), 1, 1e-3),
                                              ((4, 3, 50), 2, 30.0), ((2, 64, 8), 3, 1e-7)])
def test_compress_bit_equal(ref, shape, seed, scale):
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    key = prng.fold_in(prng.PRNGKey(seed), 0x5EED)
    rq, rs = ref.jax.jit(ref.c.compress)(ref.jnp.asarray(x),
                                         ref.jnp.asarray(np.array(key, np.uint32)))
    q, s = tc.compress(torch.from_numpy(x), key)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.item() == float(rs)
    err = (tc.decompress(q, s) - torch.from_numpy(x)).abs().max().item()
    assert err <= s.item()
    np.testing.assert_array_equal(tc.decompress(q, s).numpy(),
                                  np.asarray(ref.c.decompress(rq, rs)))


def test_compress_zeros(ref):
    q, s = tc.compress(torch.zeros(3, 5), prng.PRNGKey(0))
    rq, rs = ref.c.compress(ref.jnp.zeros((3, 5)), ref.jax.random.PRNGKey(0))
    assert s.item() == float(rs) == 0.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
