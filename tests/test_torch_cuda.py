"""The CUDA kernels against their plain versions, on a CUDA card.

Every test here needs a card and nvcc and skips without them (the check
runs inside the fixture, never at import). This file imports neither jax
nor the reference package, so it also runs where only the port is
installed: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Comparisons are exact: the kernels compare, gather and count integers on
the same device tensors as their plain versions."""
import numpy as np
import pytest
import torch

from repro_torch.core import dispatch as tdsp
from repro_torch.kernels.ppot_dispatch import build
from repro_torch.kernels.ppot_dispatch import kernel as tk
from repro_torch.kernels.ppot_dispatch import ref as tref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        build.nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc")
    return torch.device("cuda")


def _inputs(n, B, case, dev, seed=0):
    rng = np.random.RandomState(seed + n + B)
    mu = (rng.rand(n) * 5).astype(np.float32)
    if case == "zero":
        mu[:] = 0
    elif case == "single_hot":
        mu[:] = 0
        mu[rng.randint(n)] = 3.0
    q = rng.randint(0, 20, n).astype(np.int32)
    us = [rng.randint(0, 65536, B).astype(np.float32) / 65536.0 for _ in range(4)]
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(mu), t(q), [t(u) for u in us]


@pytest.mark.parametrize("case", ["random", "zero", "single_hot"])
@pytest.mark.parametrize("n,B", [(8, 1), (1024, 128), (1024, 300), (2048, 16384)])
def test_dispatch_kernels_match_plain_versions(dev, n, B, case):
    mu, q, (u1, u2, v1, v2) = _inputs(n, B, case, dev)
    tk.reset_launches()
    cdf = tref.make_cdf(mu)
    table = tdsp.build_alias_table(mu)
    got = [tk.ppot_dispatch(cdf, q, u1, u2),
           *tk.ppot_dispatch_fused(cdf, q, u1, u2),
           *tk.ppot_dispatch_fused_alias(table.prob, table.alias, q, u1, v1, u2, v2)]
    want = [tref.ppot_dispatch_ref(cdf, q, u1, u2),
            *tref.ppot_dispatch_fused_ref(cdf, q, u1, u2),
            *tref.ppot_dispatch_fused_alias_ref(table.prob, table.alias, q, u1, v1, u2, v2)]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device == w.device and torch.equal(g, w)
    counts = tk.launch_counts()
    assert counts["ppot_dispatch"] == counts["ppot_dispatch_fused"] == 1
    assert counts["ppot_dispatch_fused_alias"] == 1 and counts["alias_pairing"] == 1


@pytest.mark.parametrize("n", [1, 7, 1024, 2048])
def test_alias_pairing_kernel_matches_plain_version(dev, n):
    for seed in range(3):
        w = torch.from_numpy(np.random.RandomState(seed).rand(n).astype(np.float32))
        w[: n // 10] = 0
        p = (w * (n / w.sum())).to(dev)
        idx = torch.arange(n, device=dev)
        small = p < 1.0
        stack = idx[torch.argsort(torch.where(small, idx, n + idx))].to(torch.int32)
        ns0 = small.sum(dtype=torch.int32).reshape(1)
        got = tk.alias_pairing(p, stack, ns0)
        want = tref.alias_pairing_ref(p, stack, ns0)
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


def test_wrappers_refuse_mixed_devices(dev):
    mu, q, (u1, u2, _, _) = _inputs(16, 8, "random", dev)
    with pytest.raises(ValueError, match="several devices"):
        tk.ppot_dispatch(tref.make_cdf(mu), q.cpu(), u1, u2)


@pytest.mark.parametrize("use_alias", [True, False])
def test_router_runs_through_the_kernels(dev, use_alias):
    from repro_torch.serving import router as tr

    speeds = np.random.RandomState(0).choice([0.1, 0.4, 0.9], 64)
    r = tr.RosellaRouter(64, float(speeds.sum()), seed=0, use_alias=use_alias,
                         async_mu=use_alias)
    tk.reset_launches()
    resp, mu = tr.run_simulation(r, tr.SimulatedPool(speeds),
                                 arrival_rate=0.7 * speeds.sum(), horizon=20.0,
                                 seed=0, arrival_batch=16)
    counts = tk.launch_counts()
    fused = "ppot_dispatch_fused_alias" if use_alias else "ppot_dispatch_fused"
    assert counts[fused] == len(mu)
    assert (counts["alias_pairing"] > 0) == use_alias
    assert np.isfinite(resp).all() and (resp > 0).all()
    assert (r.q_view >= 0).all()


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("slots", [False, True])
def test_engine_batches_on_the_card_launch_a_kernel(dev, alias, masked, slots):
    """Every C = 1 engine batch on CUDA tensors launches exactly one
    dispatch kernel, and its result equals the same batch on the CPU
    (where the wrappers run their plain versions) on the same table."""
    from repro_torch.core import policies as tpol
    from repro_torch.utils import prng

    mu, q, _ = _inputs(1024, 128, "random", dev, seed=1)
    rng = np.random.RandomState(2)
    mask = torch.from_numpy(rng.rand(1024) < 0.9).to(dev) if masked else None
    act = torch.from_numpy(rng.rand(128) < 0.8).to(dev) if slots else None
    table = tdsp.build_alias_table(mu, mask) if alias else None
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    cfg = tpol.default_policy_config()
    tk.reset_launches()
    got = tdsp.dispatch(tpol.PPOT_SQ2, prng.PRNGKey(3), q, mu, mu, cfg, 128,
                        active=act, table=table, mask=mask)
    counts = tk.launch_counts()
    want = tdsp.dispatch(tpol.PPOT_SQ2, prng.PRNGKey(3), q.cpu(), mu.cpu(), mu.cpu(),
                         cfg, 128, active=cpu(act), mask=cpu(mask),
                         table=None if table is None else tdsp.AliasTable(
                             table.prob.cpu(), table.alias.cpu()))
    name = ("ppot_dispatch_fused_alias" if alias else
            "ppot_dispatch" if masked or slots else "ppot_dispatch_fused")
    assert counts[name] == 1 and sum(counts.values()) == 1
    np.testing.assert_array_equal(got.workers.cpu().numpy(), want.workers.numpy())
    np.testing.assert_array_equal(got.q_after.cpu().numpy(), want.q_after.numpy())
