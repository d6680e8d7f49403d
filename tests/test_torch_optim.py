"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's, given the same gradients and state.

Bars. The schedule: rtol 2e-6 (torch's ``cos`` against XLA's, measured
up to 5 ulps of the rate where ``1 + cos(pi t)`` is small, at the end of
the decay; equal at 371 of 396 steps). The
moments: bit-equal when the clip is inactive (the port fuses ``b m + (1 -
b) g`` into one rounding as XLA does, ``estimator.fma_f32``); with the clip
active the clip factor parts by the global norm's summation order, so
rtol 1e-6 with atol 1e-6 of the leaf's largest moment (where ``b m`` and
``(1 - b) g`` nearly cancel, the relative error grows). The masters: within 2 ulps (XLA's ``sqrt`` on the CPU is not
correctly rounded: up to 1 ulp, measured); the global norm: rtol 1e-6."""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import types

import numpy as np
import pytest
import torch

from repro_torch.optim import adamw as TA
from test_torch_model import reference_shim

SHAPES = {"a": (64, 33), "b": (1000,), "c": (7, 5, 3)}


@pytest.fixture(scope="module")
def ref():
    with reference_shim():
        import jax
        import jax.numpy as jnp

        from repro.optim import adamw

        yield types.SimpleNamespace(jax=jax, jnp=jnp, adamw=adamw)


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


def test_schedule(ref):
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=40)
    rcfg, tcfg = ref.adamw.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    sched = ref.jax.jit(lambda s: ref.adamw.schedule(rcfg, s))
    for step in range(0, 45):
        want = np.float32(sched(ref.jnp.int32(step)))
        got = TA.schedule(tcfg, torch.tensor(step, dtype=torch.int32)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, err_msg=str(step))


@pytest.mark.parametrize("gscale,clipped", [(1e-3, False), (0.5, True)])
def test_update_given_the_same_grads(ref, gscale, clipped):
    rs = np.random.RandomState(0)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    kw = dict(warmup_steps=3, total_steps=10)
    rcfg, tcfg = ref.adamw.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    rst = ref.adamw.init({k: ref.jnp.asarray(v) for k, v in params.items()})
    upd = ref.jax.jit(lambda s, g: ref.adamw.update(rcfg, s, g, ref.jnp.float32))
    for step in range(5):
        tst = TA.AdamWState(  # the reference's state, so each step starts equal
            master={k: torch.from_numpy(np.array(v)) for k, v in rst.master.items()},
            m={k: torch.from_numpy(np.array(v)) for k, v in rst.m.items()},
            v={k: torch.from_numpy(np.array(v)) for k, v in rst.v.items()},
            count=torch.tensor(int(rst.count), dtype=torch.int32))
        grads = {k: (rs.randn(*s) * gscale).astype(np.float32) for k, s in SHAPES.items()}
        rp, rst, rstats = upd(rst, {k: ref.jnp.asarray(v) for k, v in grads.items()})
        tp, tst, tstats = TA.update(tcfg, tst, {k: torch.from_numpy(v)
                                                for k, v in grads.items()}, torch.float32,
                                    leaves=[[k] for k in grads])
        gn = float(rstats["grad_norm"])
        assert (gn > rcfg.grad_clip) == clipped
        np.testing.assert_allclose(tstats["grad_norm"].item(), gn, rtol=1e-6)
        np.testing.assert_allclose(tstats["lr"].numpy(), np.float32(rstats["lr"]), rtol=2e-6)
        assert int(tst.count) == int(rst.count)
        for k in SHAPES:
            for got, want in ((tst.m[k], rst.m[k]), (tst.v[k], rst.v[k])):
                if clipped:
                    want = np.asarray(want)
                    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                               atol=1e-6 * np.abs(want).max())
                else:
                    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert _ulps(tst.master[k].numpy(), rst.master[k]) <= 2
            np.testing.assert_array_equal(tp[k].numpy(), tst.master[k].numpy())


def test_global_norm_in_leaf_order(ref):
    rs = np.random.RandomState(1)
    g = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    want = float(ref.adamw.global_norm({k: ref.jnp.asarray(v) for k, v in g.items()}))
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    got = TA.global_norm(tg, leaves=[["a"], ["b"], ["c"]]).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # another order adds the same squares: equal within an f32 rounding
    np.testing.assert_allclose(TA.global_norm(tg, leaves=[["c"], ["b", "a"]]).item(), got,
                               rtol=1e-6)
