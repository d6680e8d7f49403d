"""The port's straggler planner (``repro_torch.dist.straggler``) against the
JAX package's (``repro.dist.straggler``), on the CPU.

The numpy part (``StragglerPlanner``, ``speculative_workers_np``,
``simulate_fleet``) is a copy and must be ``array_equal``; the torch
``speculative_workers``, which both serving loops call to place speculative
copies, must equal the reference's jnp twin on random, tied and masked μ̂
(zeros for masked replicas), including everything masked, and place
nothing for m = 0. The last two
tests mirror tests/test_router_and_straggler.py.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import straggler as rst
from repro_torch.dist import straggler as tst


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_planner_and_fleet_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    speeds = rng.rand(6) * 2 + 0.05
    t_ref, a_ref = rst.simulate_fleet(speeds, 40, steps=30, seed=seed)
    t_port, a_port = tst.simulate_fleet(speeds, 40, steps=30, seed=seed)
    np.testing.assert_array_equal(t_port, t_ref)
    np.testing.assert_array_equal(a_port, a_ref)
    pr, pt = rst.StragglerPlanner(6, 20, window=4), tst.StragglerPlanner(6, 20, window=4)
    for _ in range(7):
        per = rng.rand(6) + 0.1
        alloc = pr.plan()
        np.testing.assert_array_equal(pt.plan(), alloc)
        pr.observe(per, alloc)
        pt.observe(per, alloc)
        np.testing.assert_array_equal(pt.mu_hat, pr.mu_hat)


def _mu_cases():
    rng = np.random.RandomState(5)
    rand = rng.rand(64).astype(np.float32) * 3
    tied = np.full(16, 0.75, np.float32)
    tied[[3, 9]] = 1.5
    masked = rand.copy()
    masked[rng.rand(64) < 0.4] = 0.0
    grid = np.round(rng.rand(32) * 8).astype(np.float32) / 4  # many ties, zeros too
    return {"random": rand, "tied": tied, "masked": masked, "grid": grid,
            "all masked": np.zeros(8, np.float32), "one live": np.eye(1, 12, 7)[0].astype(
                np.float32)}


@pytest.mark.parametrize("case", list(_mu_cases()))
@pytest.mark.parametrize("m", [1, 2, 7, 40])
def test_speculative_workers_equal_the_reference(case, m):
    mu = _mu_cases()[case]
    want = np.asarray(rst.speculative_workers(jnp.asarray(mu), m))
    got = tst.speculative_workers(torch.from_numpy(mu), m)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tst.speculative_workers_np(mu, m), want)
    live = mu > 0
    if live.any():
        assert live[got.numpy()].all()  # never a masked replica
    # no copy to place (the reference's jnp twin cannot index an empty out)
    assert tst.speculative_workers(torch.from_numpy(mu), 0).shape == (0,)
    assert tst.speculative_workers_np(mu, 0).shape == (0,)


def test_straggler_planner_converges_to_proportional():
    speeds = np.array([1.0, 1.0, 0.5, 0.25])
    times, alloc = tst.simulate_fleet(speeds, 32, steps=50, seed=0)
    ideal = 32 / speeds.sum()
    assert times[-5:].mean() < 1.5 * ideal
    assert alloc[0] > alloc[3]  # fast worker gets more microbatches


def test_straggler_dead_worker_still_gets_one():
    p = tst.StragglerPlanner(4, 16)
    p.mu_hat = np.array([1.0, 1.0, 1.0, 1e-9])
    alloc = p.plan()
    assert alloc[3] >= 1  # must participate in the collective
    assert alloc.sum() >= 16
