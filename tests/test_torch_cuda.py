"""The CUDA kernels against their plain versions, on a CUDA card.

Every test here needs a card and nvcc and skips without them (the check
runs inside the fixture, never at import). This file imports neither jax
nor the reference package, so it also runs where only the port is
installed: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Comparisons are exact: the kernels compare, gather and count integers on
the same device tensors as their plain versions."""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import dispatch as tdsp
from repro_torch.kernels.ppot_dispatch import build
from repro_torch.kernels.ppot_dispatch import kernel as tk
from repro_torch.kernels.ppot_dispatch import ref as tref
from repro_torch.utils import prng

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
    assert counts["ppot_dispatch_fused_alias_unkeyed"] == 1 and counts["alias_table"] == 1


@pytest.mark.parametrize("kind", tref.MASKS)
@pytest.mark.parametrize("n,B", [(8, 1), (1024, 128), (2048, 16384)])
def test_cdf_kernels_match_plain_versions_on_masked_cdfs(dev, n, B, kind):
    """K2 and K3 bisect the cdf: on masked_cdf's zero-mass plateaus too
    they equal the dense count of their plain versions."""
    mu, q, (u1, u2, _, _) = _inputs(n, B, "random", dev)
    m = tref.make_mask(kind, n, np.random.RandomState(n))
    cdf = tref.make_cdf(mu) if m is None else tdsp.masked_cdf(mu, torch.from_numpy(m).to(dev))
    got = [tk.ppot_dispatch(cdf, q, u1, u2), *tk.ppot_dispatch_fused(cdf, q, u1, u2)]
    want = [tref.ppot_dispatch_ref(cdf, q, u1, u2), *tref.ppot_dispatch_fused_ref(cdf, q, u1, u2)]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _scaled(case, n, rng):
    """Scaled weights p (mean about 1) as build_alias_table makes them, and
    the walk's edge cases: a residual one ulp below 1, larges that run out
    first, every p below 1, every p exactly 1, a NaN."""
    w = rng.rand(n).astype(np.float32)
    w[: n // 10] = 0
    p = w * np.float32(n / w.sum())
    if case == "residual_below" and n > 1:
        p[0], p[n - 1] = 1.5, 0.5 - 2.0 ** -24
    elif case == "smalls_left":
        p = rng.rand(n) * 0.5 + 0.3
        p[: max(n // 8, 1)] = 1.2
    elif case == "all_small":
        p = np.full(n, 1 - 2.0 ** -24)
    elif case == "uniform":
        p = np.ones(n)
    elif case == "nan":  # a NaN weight counts as large and never drops
        p[n // 2] = np.nan
    return torch.from_numpy(p.astype(np.float32))


@pytest.mark.parametrize("case", ["random", "residual_below", "smalls_left", "all_small",
                                  "uniform", "nan"])
@pytest.mark.parametrize("n", [1, 7, 1024, 2048, tk.ALIAS_TABLE_MAX_N])
def test_alias_table_kernel_matches_plain_version(dev, n, case):
    rng = np.random.RandomState(n)
    p = _scaled(case, n, rng).to(dev)
    for kind in tref.MASKS:
        m = tref.make_mask(kind, n, rng)
        active = None if m is None else torch.from_numpy(m).to(dev)
        tk.reset_launches()
        got = tk.alias_table(p, active)
        assert tk.launch_counts()["alias_table"] == 1
        want = tref.alias_table_ref(p, active)
        torch.cuda.synchronize()
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), kind
        assert torch.equal(got[1], want[1]), kind


def test_alias_table_refuses_what_one_block_cannot_hold(dev):
    p = torch.ones(tk.ALIAS_TABLE_MAX_N + 1, device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        tk.alias_table(p)
    with pytest.raises(ValueError, match="active"):
        tk.alias_table(p[:8], torch.ones(8, dtype=torch.int32, device=dev))


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
    assert (counts["alias_table"] > 0) == use_alias
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


# ---------------------------------------------------------------------------
# the keyed K1: its uniforms drawn in the kernel from the route key
# ---------------------------------------------------------------------------

K1_SHAPES = [(n, B) for n in (1, 8, 1024, 2048) for B in (1, 127, 128, 1025, 8193, 16384)]


def _k1_case(n, B, dev, case="random", masked=False, seed=0):
    """A table built on the card from seeded μ̂ (a tenth of the workers off
    if ``masked``), a queue and a slot mask."""
    rng = np.random.RandomState(seed + 3 * n + B)
    mu = (rng.rand(n) * 5).astype(np.float32)
    if case != "random":
        mu[:] = 0
    if case == "single_hot":
        mu[rng.randint(n)] = 3.0
    m = tref.make_mask("tenth_off", n, rng) if masked else None
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    table = tdsp.build_alias_table(t(mu), None if m is None else t(m))
    return table, t(rng.randint(0, 20, n).astype(np.int32)), t(rng.rand(B) < 0.8)


def _k1_keys(dev, seed):
    """Host keys with any bits set, and each as a device key."""
    for hk in (prng.PRNGKey(seed), prng.split(prng.PRNGKey(seed))[1], (0xFFFFFFFF, 0x80000000)):
        yield hk
        yield prng.device_key(hk, dev)


@pytest.mark.parametrize("n,B", K1_SHAPES)
def test_keyed_k1_equals_its_plain_version(dev, n, B):
    """Bit for bit against the plain version on the same device tensors:
    random, zero and single-hot μ̂, tables with and without a membership
    mask, host and device keys, with and without slots; one launch a call,
    counted as ppot_dispatch_fused_alias. The unkeyed entry on the same
    kernel equals its plain version too."""
    calls = 0
    tk.reset_launches()
    for case in ("random", "zero", "single_hot"):
        for masked in (False, True):
            table, q, act = _k1_case(n, B, dev, case, masked)
            for key in _k1_keys(dev, n + B):
                for a in (None, act):
                    got = tk.ppot_dispatch_fused_alias_keyed(table.prob, table.alias, q, key,
                                                             B, a)
                    want = tref.ppot_dispatch_fused_alias_keyed_ref(table.prob, table.alias,
                                                                    q, key, B, a)
                    calls += 1
                    torch.cuda.synchronize()
                    for g, w in zip(got, want):
                        assert g.device == w.device and torch.equal(g, w), (case, masked, a)
            u1, u2, v1, v2 = prng.uniform_quad(prng.PRNGKey(n), B, dev)
            got = tk.ppot_dispatch_fused_alias(table.prob, table.alias, q, u1, v1, u2, v2)
            want = tref.ppot_dispatch_fused_alias_ref(table.prob, table.alias, q, u1, v1, u2,
                                                      v2)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    counts = tk.launch_counts()
    assert counts["ppot_dispatch_fused_alias"] == calls
    assert counts["ppot_dispatch_fused_alias_unkeyed"] == 6


@pytest.mark.parametrize("n", [1, 3, 5, 13, 1024, 1027])
def test_keyed_k1_stages_unaligned_arrays(dev, n):
    """prob, alias and q starting 4, 8 and 12 bytes past a 16-byte
    boundary (heads of 3, 2 and 1 words, tails of every length), as rows of
    a frontend-stacked table may: equal to the plain version."""
    table, q, act = _k1_case(n, 300, dev)
    bufs = [torch.zeros(n + 4, dtype=d, device=dev) for d in (torch.float32, torch.int32,
                                                              torch.int32)]
    views = [b[o:o + n] for b, o in zip(bufs, (1, 2, 3))]
    for v, x in zip(views, (table.prob, table.alias, q)):
        v.copy_(x)
    for key in _k1_keys(dev, n):
        got = tk.ppot_dispatch_fused_alias_keyed(*views, key, 300, act)
        want = tref.ppot_dispatch_fused_alias_keyed_ref(table.prob, table.alias, q, key, 300,
                                                        act)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_keyed_k1_at_its_shared_memory_limit(dev):
    """n = K1_MAX_N (16n bytes of shared memory and 64 of alignment: 227 KB)
    at B = 16384 equals the plain version; one worker more raises."""
    n = tk.K1_MAX_N
    table, q, act = _k1_case(n, 16384, dev)
    for a in (None, act):
        got = tk.ppot_dispatch_fused_alias_keyed(table.prob, table.alias, q, (7, 9), 16384, a)
        want = tref.ppot_dispatch_fused_alias_keyed_ref(table.prob, table.alias, q, (7, 9),
                                                        16384, a)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    big = torch.ones(n + 1, device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        tk.ppot_dispatch_fused_alias_keyed(big, torch.zeros(n + 1, dtype=torch.int32,
                                                            device=dev),
                                           torch.zeros(n + 1, dtype=torch.int32, device=dev),
                                           (0, 1), 8)
    with pytest.raises(ValueError, match="several devices"):
        tk.ppot_dispatch_fused_alias_keyed(table.prob, table.alias, q, prng.device_key(
            (0, 1), "cpu"), 8)


def test_keyed_k1_is_deterministic(dev):
    """Ten runs of a batch that spans a cluster of 8 blocks give the same
    workers and q_after: the fold sums every block's histogram once, in
    no order that matters."""
    table, q, act = _k1_case(2048, 16384, dev)
    key = prng.device_key((123, 456), dev)
    runs = [tk.ppot_dispatch_fused_alias_keyed(table.prob, table.alias, q, key, 16384, act)
            for _ in range(10)]
    torch.cuda.synchronize()
    for w, qa in runs[1:]:
        assert torch.equal(w, runs[0][0]) and torch.equal(qa, runs[0][1])


@pytest.mark.parametrize("n,B", [(1024, 128), (2048, 2048), (64, 16384)])
def test_keyed_k1_in_a_graph_reads_each_replays_key(dev, n, B):
    """The engine's alias batch captured in a CUDA graph is one node, K1,
    with slots too: no draw and no copy around it. Its device key is
    rewritten between replays, and each replay equals the plain version
    under that replay's key."""
    from repro_torch.core import policies as tpol
    from repro_torch.serving import scanloop as tsl

    table, q, act = _k1_case(n, B, dev, masked=True)
    key = prng.device_key((0, 1), dev)
    cfg = tpol.default_policy_config()

    def call():
        return tdsp.dispatch(tpol.PPOT_SQ2, key, q, table.prob, table.prob, cfg, B,
                             active=act, table=table)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = call()
    graph.instantiate()
    nodes, kernels = tsl._graph_nodes(graph)
    assert nodes == 1 and sum(c for nm, c in kernels.items() if "ppot_kernel_alias" in nm) == 1
    for hk in ((5, 6), prng.PRNGKey(7), (0xFFFFFFFF, 0xFFFFFFFE), prng.split((1, 2))[0]):
        key.copy_(prng.device_key(hk, dev))
        graph.replay()
        want = tref.ppot_dispatch_fused_alias_keyed_ref(table.prob, table.alias, q, hk, B,
                                                        act)
        torch.cuda.synchronize()
        assert torch.equal(out.workers, want[0]) and torch.equal(out.q_after, want[1])


# ---------------------------------------------------------------------------
# flash attention (K4)
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# each row's largest error over that row's largest |value| (chip_smoke.py)
FLASH_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "BH,Sq,Sk,D,causal,window,q_offset",
    [
        (2, 128, 128, 64, True, 0, 0),
        (2, 256, 256, 64, True, 64, 0),
        (1, 128, 384, 128, False, 0, 0),
        (3, 384, 384, 32, True, 0, 0),
        (2, 128, 256, 64, True, 0, 128),
        (2, 128, 256, 64, True, 16, 200),
        (2, 2048, 2048, 64, True, 0, 0),
        # the tile plan's edges (ref.tile_plan): ragged Sq and Sk, windows
        # whose first key falls inside a tile, q_offset > 0, D = 32 and 128
        (1, 300, 300, 64, True, 0, 0),
        (2, 200, 333, 128, True, 0, 133),
        (1, 500, 500, 32, True, 100, 0),
        (2, 1000, 1000, 64, True, 200, 0),
        (1, 77, 1000, 64, False, 0, 0),
        (1, 256, 1024, 128, True, 300, 768),
        (3, 130, 190, 32, True, 0, 60),
    ],
)
def test_flash_kernel_matches_plain_version(dev, BH, Sq, Sk, D, causal, window, q_offset,
                                            dtype):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fref

    g = torch.Generator(device=dev).manual_seed(Sq + Sk + D)
    q, k, v = ((torch.randn(BH, S, D, generator=g, device=dev) * 0.5).to(dtype)
               for S in (Sq, Sk, Sk))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    fk.reset_launches()
    got = fk.flash_attention_fwd(q, k, v, **kw)
    assert fk.launch_counts()["flash_attention_fwd"] == 1
    want = fref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert (fref.row_relative_error(got, want) <= FLASH_ROW_TOL[dtype]).all()
    if window:  # rows whose window ends before the first key see none: 0
        empty = q_offset + torch.arange(Sq, device=dev) >= Sk + window - 1
        assert (got[:, empty] == 0).all()
        assert empty.sum().item() == (57 if q_offset == 200 else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,window,scale", [
    (2, 300, 6, 2, 0, 1.0),
    (1, 2048, 15, 5, 0, 0.5),  # smollm-360m's attention at B = 1
    (2, 4096, 25, 5, 1024, 0.5),  # hymba-1.5b's prefill attention (chip_smoke.py [flash])
])
def test_flash_ops_gqa_matches_plain_version(dev, dtype, B, S, H, Hkv, window, scale):
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    g = torch.Generator(device=dev).manual_seed(1)
    D = 64
    q = (torch.randn(B, S, H, D, generator=g, device=dev) * scale).to(dtype)
    k, v = ((torch.randn(B, S, Hkv, D, generator=g, device=dev) * scale).to(dtype)
            for _ in range(2))
    got = fops.flash_attention(q, k, v, q_offset=0, causal=True, window=window)
    want = fref.attention_ref(q.transpose(1, 2).reshape(B * H, S, D),
                              k.transpose(1, 2).reshape(B * Hkv, S, D),
                              v.transpose(1, 2).reshape(B * Hkv, S, D), window=window)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    want = want.reshape(B, H, S, D).transpose(1, 2)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert (fref.row_relative_error(got.transpose(1, 2), want.transpose(1, 2))
            <= FLASH_ROW_TOL[dtype]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_heads_reads_strided_views_in_place(dev, dtype):
    """q, k and v as views of one fused [B, S, H + 2 Hkv, D] projection:
    the model-layout entry reads them through their strides, one launch."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fref

    g = torch.Generator(device=dev).manual_seed(2)
    fused = (torch.randn(1, 333, 8 + 2 * 2, 32, generator=g, device=dev) * 0.5).to(dtype)
    q, k, v = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    assert not q.is_contiguous()
    fk.reset_launches()
    got = fk.flash_attention_heads(q, k, v, causal=True, window=50)
    assert fk.launch_counts()["flash_attention_fwd"] == 1
    want = fref.attention_heads_ref(q, k, v, causal=True, window=50)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert (fref.row_relative_error(got.transpose(1, 2), want.transpose(1, 2))
            <= FLASH_ROW_TOL[dtype]).all()


def test_cuda_prefill_launches_flash_once_per_layer(dev):
    """smollm-360m at its published widths, 3 layers, S=2048: the chunked
    path takes the kernel in every layer; its logits are close to the
    plain chunked path's, in bf16 at the last position and in f32 at every
    position."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import api
    from repro_torch.models import lm as LM

    cfg = dataclasses.replace(configs.get_config("smollm-360m"), n_layers=3)
    model = api.init_params(cfg, 0)
    toks = torch.randint(0, cfg.vocab, (1, 2048), device=dev)
    fk.reset_launches()
    got = api.prefill(cfg, model, {"tokens": toks})
    torch.cuda.synchronize()
    assert fk.launch_counts()["flash_attention_fwd"] == cfg.n_layers
    assert got.shape == (1, 1, cfg.vocab) and torch.isfinite(got).all()
    fk.reset_launches()
    api.prefill(cfg, model, {"tokens": toks[:, :2047]})  # below 2048: plain attention
    assert fk.launch_counts()["flash_attention_fwd"] == 0
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = api.init_params(cfg32, 0)

    @torch.no_grad()
    def all_logits():
        return LM.logits_head(cfg32, model32, LM.forward(cfg32, model32, toks))

    got32 = all_logits()
    with api.plain_paths():
        want = api.prefill(cfg, model, {"tokens": toks})
        want32 = all_logits()
    # tolerances of chip_smoke.py's [prefill]
    assert (got.float() - want.float()).abs().max().item() <= 0.125
    assert (got32 - want32).abs().max().item() <= 1e-4


@pytest.mark.parametrize("case", ["dtype", "noncontiguous", "mixed_device"])
def test_flash_wrapper_refuses_bad_inputs_on_the_card(dev, case):
    from repro_torch.kernels.flash_attention import kernel as fk

    q = torch.zeros(4, 64, 64, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(4, 64, 64, device=dev, dtype=torch.bfloat16)
    v = torch.zeros(4, 64, 64, device=dev, dtype=torch.bfloat16)
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "noncontiguous":
        q = q.transpose(1, 2)
    else:
        v = v.cpu()
    fk.reset_launches()
    with pytest.raises(ValueError):
        fk.flash_attention_fwd(q, k, v)
    assert fk.launch_counts()["flash_attention_fwd"] == 0


# ---------------------------------------------------------------------------
# the SSD chunked scan (K5)
# ---------------------------------------------------------------------------

# against the plain version (chip_smoke.py's [ssd] bars) and the
# sequential oracle (tests/test_kernels.py's bars)
SSD_TOL, SSD_ROW_TOL = 5e-4, 2e-4
SSD_ORACLE_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}


def _ssd_inputs(dev, B, S, H, P, N, xdtype, *, heads, seed=0, mamba2_decays=False):
    """chip_smoke.ssd_inputs: the decays of tests/test_kernels.py, or with
    ``mamba2_decays`` Mamba2's (``ref.mamba2_decays``), under which the
    state reaches across chunks."""
    from repro_torch.kernels.ssd_scan import ref as sref

    g = torch.Generator(device=dev).manual_seed(seed + S + P + N)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = (r(*((B, S, H, P) if heads else (B * H, S, P))) * 0.5).to(xdtype)
    dts = (B, S, H) if heads else (B * H, S)
    if mamba2_decays:
        A_log, dt_bias = sref.mamba2_decays(H if heads else B * H, g)
        dt = torch.nn.functional.softplus(r(*dts) + (dt_bias if heads else dt_bias[:, None]))
        A = -torch.exp(A_log)
    else:
        dt = torch.nn.functional.softplus(r(*dts) - 1.0)
        A = -torch.exp(r(H if heads else B * H) * 0.5)
    G = B if heads else B * H
    Bm, Cm = ((r(G, S, N) * 0.5).bfloat16().float() for _ in range(2))
    return x, dt, A, Bm, Cm


def _hold_ssd(got, want):
    from repro_torch.kernels.ssd_scan import ref as sref

    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=SSD_TOL, rtol=SSD_TOL)
        assert (sref.row_relative_error(g, w) <= SSD_ROW_TOL).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,P,N,chunk",
                         [(2, 128, 32, 16, 64), (1, 256, 64, 32, 128), (4, 192, 16, 8, 64)])
def test_ssd_kernel_matches_plain_version(dev, BH, S, P, N, chunk, dtype):
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ref as sref

    x, dt, A, Bm, Cm = _ssd_inputs(dev, BH, S, 1, P, N, dtype, heads=False)
    sk.reset_launches()
    got = sk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert sk.launch_counts()["ssd_scan"] == 1
    _hold_ssd(got, sref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk))
    tol = SSD_ORACLE_TOL[dtype]
    for g, w in zip(got, sref.ssd_ref(x, dt, A, Bm, Cm)):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", [
    (4, 4096, 32, 64, 128, 128, torch.bfloat16),  # mamba2-370m's layer at B=4, S=4096
    (2, 4096, 50, 64, 16, 128, torch.bfloat16),  # hymba-1.5b's layer at B=2, S=4096
    (2, 100, 4, 64, 128, 64, torch.float32),  # gcd chunk: Q = 4
    (2, 300, 4, 64, 128, 128, torch.float32),  # gcd chunk: Q = 4
    (1, 2048, 32, 64, 128, 128, torch.bfloat16),  # B = 1: the smallest chunk-parallel grid
    (2, 160, 6, 64, 128, 128, torch.bfloat16),  # gcd chunk: Q = 32
    (1, 160, 5, 20, 12, 128, torch.float32),  # Q = 32, P and N off the tile grid
    (1, 160, 5, 20, 12, 128, torch.bfloat16),  # x rows not 16-byte multiples: scalar loads
    (1, 96, 3, 18, 12, 32, torch.float32),  # the same in f32
])
def test_ssd_ops_matches_plain_version(dev, B, S, H, P, N, chunk, dtype):
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref

    x, dt, A, Bm, Cm = _ssd_inputs(dev, B, S, H, P, N, dtype, heads=True)
    Q = sops.pick_chunk(S, chunk)
    _hold_ssd(sops.ssd(x, dt, A, Bm, Cm, chunk=chunk),
              sref.ssd_chunked_heads(x, dt, A, Bm, Cm, chunk=Q))


@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", [
    (4, 4096, 32, 64, 128, 128, torch.bfloat16),
    (2, 4096, 50, 64, 16, 128, torch.bfloat16),
    (2, 300, 4, 64, 128, 128, torch.float32),
    (1, 2048, 32, 64, 128, 128, torch.bfloat16),
    (2, 160, 6, 64, 128, 128, torch.bfloat16),
])
def test_ssd_ops_holds_the_carry_under_mamba2_decays(dev, B, S, H, P, N, chunk, dtype):
    """chip_smoke.py's "mamba2 decays" cases of [ssd]: the kernel within the
    bars, and the plain version without its chunk carry far outside them."""
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref

    x, dt, A, Bm, Cm = _ssd_inputs(dev, B, S, H, P, N, dtype, heads=True, mamba2_decays=True)
    Q = sops.pick_chunk(S, chunk)
    want = sref.ssd_chunked_heads(x, dt, A, Bm, Cm, chunk=Q)
    _hold_ssd(sops.ssd(x, dt, A, Bm, Cm, chunk=chunk), want)
    faulty = sref.without_carry(sref.ssd_chunked_heads, x, dt, A, Bm, Cm, chunk=Q)[0]
    assert sref.row_relative_error(faulty, want[0]).max().item() > 100 * SSD_ROW_TOL


def test_ssd_in_place_bc_equals_the_broadcast_form(dev):
    from repro_torch.kernels.ssd_scan import kernel as sk

    B, H = 2, 8
    x, dt, A, Bm, Cm = _ssd_inputs(dev, B, 512, H, 64, 128, torch.bfloat16, heads=False)
    Bg, Cg = Bm[::H].contiguous(), Cm[::H].contiguous()
    got = sk.ssd_scan(x, dt, A, Bg, Cg, chunk=128)
    want = sk.ssd_scan(x, dt, A, Bg.repeat_interleave(H, 0), Cg.repeat_interleave(H, 0),
                       chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", ["dtype", "noncontiguous", "mixed_device"])
def test_ssd_wrapper_refuses_bad_inputs_on_the_card(dev, case):
    from repro_torch.kernels.ssd_scan import kernel as sk

    x, dt, A, Bm, Cm = _ssd_inputs(dev, 2, 128, 1, 64, 16, torch.bfloat16, heads=False)
    if case == "dtype":
        x = x.half()
    elif case == "noncontiguous":
        Bm = Bm.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        dt = dt.cpu()
    sk.reset_launches()
    with pytest.raises(ValueError):
        sk.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    assert sk.launch_counts()["ssd_scan"] == 0


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_cuda_prefill_launches_ssd_once_per_layer(dev, arch):
    """mamba2-370m and hymba-1.5b at their published widths, 3 layers,
    S=2048, A_log and dt_bias drawn as Mamba2 draws them: the prefill takes
    K5 in every layer (and K4 in hymba's); bf16 last-position logits and
    f32 logits at every position close to the plain paths' (smollm's
    [prefill] bars of chip_smoke.py), and the f32 model with the chunk carry
    left out far from them."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.models import api
    from repro_torch.models import lm as LM
    from repro_torch.models import ssm as SSM

    def mamba2_init(cfg):
        model, g = api.init_params(cfg, 0), torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            for layer in model.layers:
                A_log, dt_bias = sref.mamba2_decays(cfg.n_ssm_heads, g)
                layer.ssm.A_log.copy_(A_log)
                layer.ssm.dt_bias.copy_(dt_bias)
        return model

    cfg = dataclasses.replace(configs.get_config(arch), n_layers=3)
    model = mamba2_init(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (1, 2048), generator=g, device=dev)
    sk.reset_launches()
    fk.reset_launches()
    got = api.prefill(cfg, model, {"tokens": toks})
    torch.cuda.synchronize()
    assert sk.launch_counts()["ssd_scan"] == cfg.n_layers
    # one call per layer, several grids per call
    assert sk.launch_counts()["ssd_scan_grids"] == sk.GRIDS * cfg.n_layers > cfg.n_layers
    assert fk.launch_counts()["flash_attention_fwd"] == (cfg.n_layers if arch == "hymba-1.5b"
                                                         else 0)
    assert got.shape == (1, 1, cfg.vocab) and torch.isfinite(got).all()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = mamba2_init(cfg32)

    @torch.no_grad()
    def all_logits():
        return LM.logits_head(cfg32, model32, LM.forward(cfg32, model32, toks))

    got32 = all_logits()
    with api.plain_paths():
        want = api.prefill(cfg, model, {"tokens": toks})
        want32 = all_logits()
    saved = SSM.ssd_prefill
    SSM.ssd_prefill = lambda cfg, x, *a: sref.without_carry(
        sops.ssd, x, *a, chunk=sops.pick_chunk(x.shape[1], cfg.ssm_chunk))
    try:
        faulty32 = all_logits()
    finally:
        SSM.ssd_prefill = saved
    err, err32, fault32 = ((a.float() - b.float()).abs().max().item()
                           for a, b in ((got, want), (got32, want32), (faulty32, want32)))
    print(f"{arch} 3 layers: bf16 last-position logits {err}, f32 logits {err32}, f32 "
          f"without the chunk carry {fault32}")
    assert err <= 0.125 and err32 <= 1e-4 and fault32 > 1e-4


# ---------------------------------------------------------------------------
# the pool chain and the one-program serving loop
# ---------------------------------------------------------------------------


def _chain(n, M, dev, seed=0):
    rng = np.random.RandomState(seed + n + M)
    fa, sp = rng.rand(n) * 3, rng.rand(n) + 0.05
    w = rng.randint(0, n, M).astype(np.int32)
    w[M // 4:M // 2] = n // 2  # one replica many times in a row
    a = np.sort(rng.rand(M) * 3)
    if M > 4:
        a[M // 4 + 1] = fa[n // 2]  # an arrival tied with its replica's clock
    c, act = rng.exponential(1.0, M), rng.rand(M) < 0.9
    return [torch.from_numpy(x).to(dev) for x in (fa, sp, w, a, c, act)]


@pytest.mark.parametrize("n,M", [(4, 24), (1024, 136), (1024, 0), (16384, 4096)])
def test_pool_chain_kernel_matches_plain_version(dev, n, M):
    from repro_torch.kernels.pool_chain import kernel as ck
    from repro_torch.kernels.pool_chain import ref as cr

    args = _chain(n, M, dev)
    ck.reset_launches()
    got = ck.pool_chain(*args)
    want = cr.pool_chain_ref(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device == w.device and g.dtype == torch.float64 and torch.equal(g, w)
    assert ck.launch_counts()["pool_chain"] == 1


def _same_nan(g, w) -> bool:
    """Equal values, NaN where the other has NaN."""
    nan = torch.isnan(w)
    return torch.equal(torch.isnan(g), nan) and torch.equal(g[~nan], w[~nan])


def test_pool_chain_kernel_walks_one_replica_of_every_step(dev):
    """The worst case: all M = 4096 steps on one replica, one chain."""
    from repro_torch.kernels.pool_chain import kernel as ck
    from repro_torch.kernels.pool_chain import ref as cr

    args = _chain(16384, ck.MAX_M, dev)
    args[2].fill_(123)
    got, want = ck.pool_chain(*args), cr.pool_chain_ref(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["empty", "distinct", "one replica", "a replica 30 times",
                                  "tile borders", "inactive heads", "ties", "nan arrivals"])
def test_pool_chain_kernel_matches_plain_version_on_planted_chains(dev, name):
    from repro_torch.kernels.pool_chain import kernel as ck
    from repro_torch.kernels.pool_chain import ref as cr

    args = [torch.from_numpy(x).to(dev) for x in cr.planted_chains()[name]]
    got, want = ck.pool_chain(*args), cr.pool_chain_ref(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float64 and _same_nan(g, w)


@pytest.mark.parametrize("n,mf,bc,k", [(64, 8, 3, 32), (1024, 8, 0, 128), (2048, 8, 0, 2048),
                                       (16384, 8, 5, 4083)])
def test_pool_turn_kernel_matches_plain_version(dev, n, mf, bc, k):
    """The turn form: assembly, chain, responses, in-place clocks and the
    running longest chain, against the assembly and the host walk."""
    from repro_torch.kernels.pool_chain import kernel as ck
    from repro_torch.kernels.pool_chain import ref as cr

    rng = np.random.RandomState(n + k)
    fa, sp = rng.rand(n) * 3, rng.rand(n) + 0.05
    fake = rng.randint(0, n, mf).astype(np.int32)
    fake[::3] = -1
    burst = rng.randint(0, n, bc).astype(np.int32)
    burst[::2] = -1
    workers = rng.randint(0, n, k).astype(np.int32)
    workers[k // 3:k // 3 + 20] = fake[1]  # a benchmarked replica takes 20 in a row
    times = np.sort(rng.rand(k) * 3)
    costs = rng.exponential(1.0, k)
    t = [torch.from_numpy(x).to(dev) for x in (fa, sp, fake, burst, workers, times, costs)]
    want = cr.pool_turn_ref(*t, 0.25, 1.0)
    cm = torch.zeros((), dtype=torch.int32, device=dev)
    free = t[0].clone()
    ck.reset_launches()
    got = ck.pool_turn(free, *t[1:], 0.25, 1.0, free_out=free, chain_max=cm)
    torch.cuda.synchronize()
    assert ck.launch_counts()["pool_chain"] == 1 and got[4] is free
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(cm) == cr.longest_chain(want[2], n) >= 21
    got = ck.pool_turn(*t, 0.25, 1.0)  # into a new free_at
    assert torch.equal(got[4], want[4]) and torch.equal(t[0], torch.from_numpy(fa).to(dev))


@pytest.mark.parametrize("case", ["gated", "one replica", "empty"])
@pytest.mark.parametrize("n,k", [(64, 32), (1024, 128)])
def test_pool_turn_tail_kernel_matches_plain_version(dev, n, k, case):
    """The faulty turn's chain: the batch, then a tail of retry and
    speculative copies (gated slots, a -1 under an open gate, every tail
    step on one replica, or no tail), against the plain version; an empty
    tail gives the tail-less kernel's output bit for bit."""
    from repro_torch.kernels.pool_chain import kernel as ck
    from repro_torch.kernels.pool_chain import ref as cr

    rng = np.random.RandomState(n + k)
    fa, sp = rng.rand(n) * 3, rng.rand(n) + 0.05
    fake = rng.randint(0, n, 8).astype(np.int32)
    fake[::3] = -1
    burst = rng.randint(0, n, 3).astype(np.int32)
    workers = rng.randint(0, n, k).astype(np.int32)
    workers[:7] = 5
    times, costs = np.sort(rng.rand(k) * 3), rng.exponential(1.0, k)
    R = 0 if case == "empty" else 6
    tw = rng.randint(0, n, R).astype(np.int32)
    gate = rng.rand(R) < 0.7
    if case == "gated":
        tw[1], gate[1], gate[2] = -1, True, False
    elif case == "one replica":
        tw[:], gate[:] = 5, True
    t = [torch.from_numpy(x).to(dev) for x in (fa, sp, fake, burst, workers, times, costs)]
    tail = [torch.from_numpy(x).to(dev) for x in (tw, rng.exponential(1.0, R), gate)]
    want = cr.pool_turn_ref(*t, 0.25, 1.0, *tail)
    cm = torch.zeros((), dtype=torch.int32, device=dev)
    free = t[0].clone()
    ck.reset_launches()
    got = ck.pool_turn(free, *t[1:], 0.25, 1.0, tail_w=tail[0], tail_cost=tail[1],
                       tail_gate=tail[2], free_out=free, chain_max=cm)
    torch.cuda.synchronize()
    assert ck.launch_counts()["pool_chain"] == 1 and got[4] is free
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # replica 5 takes 7 of the batch, and every tail step in "one replica"
    assert int(cm) == cr.longest_chain(want[2], n) >= (13 if case == "one replica" else 7)
    if case == "empty":
        plain = ck.pool_turn(*t, 0.25, 1.0)
        for g, w in zip(got, plain):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name,use_alias", [("crash_storm", True), ("crash_storm", False),
                                            ("blackout", True), ("grey_failure", True)])
def test_faulty_scan_on_the_card_equals_the_cpu_and_the_host_loop(dev, name, use_alias):
    """The faulty turn captured and replayed at n = 64 (the §6.1 speed grid,
    0.7·Σ speeds, batches of 32, recovery armed as tests/test_faults.py arms
    it): equal bit for bit to the host recovery loop on the card (responses
    with NaN, μ̂ trace, free_at, ledger, learner); against the same scan run
    eagerly on the CPU, responses and ledger equal and μ̂ within 8 ulps (the
    learner's f32 sums reduce in another order on the card). Conserved,
    overflows 0, one pool_chain node a replay."""
    from repro_torch import env as tenv
    from repro_torch.configs.rosella_sim import tpch_speed_set
    from repro_torch.serving import recovery as trcv

    rc = trcv.RecoveryConfig(timeout_mult=8.0, retry_budget=2, retry_cap=4, spec_cap=2,
                             spec_ratio=3.0)
    speeds = tpch_speed_set(64, 0)
    scn = tenv.make(name, speeds=tuple(speeds), rate=0.7 * float(speeds.sum()))
    kw = dict(seed=0, arrival_batch=32, use_alias=use_alias, sequential_pool=True,
              recovery=rc)
    g = tenv.run_scenario(scn, use_scan=True, device=dev, **kw)
    h = tenv.run_scenario(scn, device=dev, **kw)
    c = tenv.run_scenario(scn, use_scan=True, device="cpu", **kw)
    info = g["info"]
    assert info["flush_overflow"] == info["pend_overflow"] == 0
    assert info["replays"] == info["turns"] == len(h["mu_trace"]) > 100
    assert sum(v for nm, v in info["graph_kernels"].items() if "pool_chain_kernel" in nm) == 1
    np.testing.assert_array_equal(g["mu_trace"], h["mu_trace"])
    np.testing.assert_array_equal(g["pool"].free_at, h["pool"].free_at)
    assert torch.equal(g["router"].learner.mu_hat, h["router"].learner.mu_hat)
    for other in (h, c):
        np.testing.assert_array_equal(g["responses"], other["responses"])
        assert g["info"]["ledger"] == other["info"]["ledger"]
    ia = g["mu_trace"].view(np.int32).astype(np.int64)
    ib = c["mu_trace"].view(np.int32).astype(np.int64)
    assert np.abs(ia - ib).max() <= 8
    led = info["ledger"]
    assert led["conserved"] and led["n_retries"] > 0 and led["n_timeouts"] > 0


def test_pool_chain_refuses_what_one_block_cannot_hold(dev):
    from repro_torch.kernels.pool_chain import kernel as ck

    with pytest.raises(ValueError, match="outside"):
        ck.pool_chain(*_chain(ck.MAX_N + 1, 8, dev))
    with pytest.raises(ValueError, match="outside"):
        ck.pool_chain(*_chain(16, ck.max_steps(16) + 1, dev))
    with pytest.raises(ValueError, match="outside"):
        ck.pool_chain(*_chain(ck.MAX_N, ck.MAX_M + 1, dev))


@pytest.mark.parametrize("use_alias", [True, False])
@pytest.mark.parametrize("churn", [False, True])
def test_graph_replays_equal_eager_turns(dev, use_alias, churn):
    """The captured turn replayed against the same turn run eagerly on the
    card, from the same state: results and carry equal after every turn
    of a 40-turn chunk at n=256, k=32."""
    from repro_torch.serving import router as tr
    from repro_torch.serving import scanloop as tsl

    n, k = 256, 32
    speeds = np.linspace(0.2, 3.0, n)
    rate = 0.7 * speeds.sum()
    times, costs, sp = tsl._precompute_workload(rate, 40 * k / rate, 1.0, None, 3, k, speeds)
    T = len(times)
    cols = dict(times=times, costs=costs, speeds=sp)
    if churn:
        active = np.ones((T, n), bool)
        active[T // 2:, :13] = False
        cols.update(active=active, rejoin=np.zeros((T, n), bool),
                    burst=np.zeros((T, 0), np.int32))
    router = tr.RosellaRouter(n, float(speeds.sum()), seed=1, async_mu=False,
                              use_alias=use_alias, device=dev)
    cfg = tsl.scan_config(router, k, churn=churn, pend_cap=4096)
    from repro_torch.kernels.pool_chain import kernel as ck

    ck.reset_launches()
    graph = tsl.TurnRunner(cfg, dev, T)
    # the eager warm-up turns count; the launch recorded by the capture does not
    assert ck.launch_counts()["pool_chain"] == tsl.WARMUP_TURNS
    eager = tsl.TurnRunner(cfg, dev, T)
    assert graph.graph is not None and graph.graph_nodes > 100

    def nodes(pattern):
        return sum(c for nm, c in graph.graph_kernels.items() if pattern in nm)

    assert nodes("pool_chain_kernel") == nodes("ppot_kernel") == 1
    assert nodes("alias_table_kernel") == int(use_alias)
    for r in (graph, eager):
        r.load(router, tr.SimulatedPool(speeds))
    resp_g, mu_g = graph.run_chunk(cols)
    assert graph.replays == T
    eager.xs.put(cols)
    eager.turn.zero_()
    for _ in range(T):
        eager.step()
    ys = eager.ys.get(T)
    np.testing.assert_array_equal(resp_g, ys["resp"])
    np.testing.assert_array_equal(mu_g, ys["mu"])
    for name, t in graph.carry.items():
        assert torch.equal(t, eager.carry[name]), name
    assert int(graph.carry["over_pend"]) == 0


@pytest.mark.parametrize("use_alias", [True, False])
def test_scan_on_the_card_equals_the_host_loop(dev, use_alias):
    """tests/test_scanloop.py's exact case on the card: the graph against
    the host loop, SequentialPool, async_mu=False."""
    from repro_torch.serving import router as tr
    from repro_torch.serving import scanloop as tsl

    speeds = np.array([0.25, 0.5, 1.0, 2.0])
    kw = dict(arrival_rate=3.0, horizon=150.0, seed=0, arrival_batch=16)
    mk = lambda: tr.RosellaRouter(4, 3.75, seed=0, async_mu=False,  # noqa: E731
                                  use_alias=use_alias, device=dev)
    ra, pa = mk(), tr.SequentialPool(speeds)
    rh, mh = tr.run_simulation(ra, pa, **kw)
    rb, pb = mk(), tr.SequentialPool(speeds)
    rs, ms, info = tsl.run_simulation_scan(rb, pb, **kw)
    assert info["capture_s"] is not None and info["pend_overflow"] == 0
    assert info["replays"] == info["turns"] == len(mh)
    assert info["longest_chain"] >= 2  # 16 arrivals and benchmarks on 4 replicas
    np.testing.assert_array_equal(rh, rs)
    np.testing.assert_array_equal(mh, ms)
    np.testing.assert_array_equal(pa.free_at, pb.free_at)
    assert torch.equal(ra.learner.mu_hat, rb.learner.mu_hat) and ra.key == rb.key


@pytest.mark.parametrize("use_alias", [True, False])
@pytest.mark.parametrize("name", ["null", "churn", "churn_heavy"])
def test_scenario_scan_on_the_card_equals_the_host_loop(dev, name, use_alias):
    """The environment engine on the card at n = 64 (the §6.1 speed grid,
    arrivals at 0.7·Σ speeds, the registry's horizon), batches of 32:
    ``run_scenario``'s host loop and one-program loop equal bit for bit on
    a SequentialPool, overflows 0, the final membership equal."""
    from repro_torch import env as tenv
    from repro_torch.configs.rosella_sim import tpch_speed_set

    speeds = tpch_speed_set(64, 0)
    scn = tenv.make(name, speeds=tuple(speeds), rate=0.7 * float(speeds.sum()))
    kw = dict(seed=0, arrival_batch=32, use_alias=use_alias, sequential_pool=True,
              device=dev)
    h = tenv.run_scenario(scn, **kw)
    s = tenv.run_scenario(scn, use_scan=True, **kw)
    info = s["info"]
    assert info["flush_overflow"] == info["pend_overflow"] == 0
    assert info["replays"] == info["turns"] == len(h["mu_trace"]) > 100
    np.testing.assert_array_equal(h["responses"], s["responses"])
    np.testing.assert_array_equal(h["mu_trace"], s["mu_trace"])
    np.testing.assert_array_equal(h["pool"].free_at, s["pool"].free_at)
    assert torch.equal(h["router"].learner.mu_hat, s["router"].learner.mu_hat)
    wl = h["workload"]
    if wl.active is not None:
        assert (~wl.active).any()
        assert torch.equal(h["router"].active, s["router"].active)


def _policy_case(n, B, masked, seed=0):
    """Grid μ̂ and μ (exact prefix sums, so both devices build the same
    CDF), a queue, and a mask with 25% of the workers offline."""
    rng = np.random.RandomState(seed + n + B)
    mu = (rng.randint(0, 1024, n) / 256.0).astype(np.float32)
    mu_true = (rng.randint(1, 1024, n) / 256.0).astype(np.float32)
    q = rng.randint(0, 20, n).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones(n, bool)
        mask[rng.permutation(n)[:n // 4]] = False
    return mu, mu_true, q, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("policy", ["uniform", "pot", "pss", "ppot_sq2", "ppot_ll2", "bandit",
                                    "halo", "sparrow"])
def test_engine_on_the_card_equals_the_cpu_for_every_policy(dev, policy, masked):
    """One engine call per policy on the card and on the CPU, same key and
    inputs, at (n, B) = (1024, 128) and (64, 4096), one chunk and seven:
    workers and q_after equal; the alias policies take a table built on
    each device (equal too)."""
    from repro_torch.core import policies as tpol
    from repro_torch.utils import prng

    cfg = tpol.default_policy_config()
    for n, B in ((1024, 128), (64, 4096)):
        mu, mu_true, q, mask = _policy_case(n, B, masked)
        out = {}
        for d in ("cpu", dev):
            t = lambda a: None if a is None else torch.from_numpy(a).to(d)  # noqa: E731
            tab = (tdsp.build_alias_table(t(mu), t(mask))
                   if policy in tdsp.ALIAS_POLICIES else None)
            out[str(d)] = [tab] + [tdsp.dispatch(policy, prng.PRNGKey(n + B), t(q), t(mu),
                                                  t(mu_true), cfg, B, table=tab,
                                                  mask=t(mask), fold_chunks=C)
                                   for C in (1, 7)]
        torch.cuda.synchronize()
        (tab_c, *cpu), (tab_d, *card) = out["cpu"], out[str(dev)]
        if tab_c is not None:
            assert torch.equal(tab_c.prob, tab_d.prob.cpu())
            assert torch.equal(tab_c.alias, tab_d.alias.cpu())
        for a, b in zip(cpu, card):
            assert b.workers.device.type == "cuda"
            assert torch.equal(a.workers, b.workers.cpu())
            assert torch.equal(a.q_after, b.q_after.cpu())
            if mask is not None:
                assert mask[a.workers.numpy()].all()


@pytest.mark.parametrize("policy", ["uniform", "pot", "pss", "ppot_sq2", "ppot_ll2", "bandit",
                                    "halo", "sparrow"])
def test_scan_on_the_card_equals_the_host_loop_for_every_policy(dev, policy):
    """Each policy's turn captured as a CUDA graph and replayed, against the
    host loop on the card at n = 64 (the §6.1 speed grid, arrivals at
    0.7·Σ speeds, batches of 32, ~150 turns), SequentialPool,
    async_mu=False: responses, μ̂ trace and replica clocks equal."""
    from repro_torch.configs.rosella_sim import tpch_speed_set
    from repro_torch.serving import router as tr
    from repro_torch.serving import scanloop as tsl

    speeds = tpch_speed_set(64, 0)
    rate = 0.7 * float(speeds.sum())
    kw = dict(arrival_rate=rate, horizon=150 * 32 / rate, seed=0, arrival_batch=32)
    mk = lambda: tr.RosellaRouter(64, float(speeds.sum()), policy=policy, seed=0,  # noqa: E731
                                  async_mu=False, device=dev)
    ra, pa = mk(), tr.SequentialPool(speeds)
    rh, mh = tr.run_simulation(ra, pa, **kw)
    rb, pb = mk(), tr.SequentialPool(speeds)
    rs, ms, info = tsl.run_simulation_scan(rb, pb, pend_cap=None, **kw)
    assert info["graph_nodes"] is not None and info["pend_overflow"] == 0
    assert info["replays"] == info["turns"] == len(mh) > 100
    np.testing.assert_array_equal(rh, rs)
    np.testing.assert_array_equal(mh, ms)
    np.testing.assert_array_equal(pa.free_at, pb.free_at)


#: graph nodes of the turn captured with ``observe=None`` at n = 64 (the §6.1
#: speed grid, 0.7·Σ speeds, batches of 32; crash_storm with recovery armed),
#: as the tree before the telemetry fold captured them on the H100 (851, 901,
#: 1355), less the nodes the keyed K1 took out of the turn (74 of the plain
#: turn: the counter hash's 73 kernels and the copy of q; 83 of the faulty
#: turn: also the slot refold's 9), counted by name against the turns before
#: it (kernel_variants.py --parent)
NODES_WITHOUT_TELEMETRY = {"null": 777, "churn": 827, "crash_storm": 1272}


def _obs_scenario(name):
    from repro_torch import env as tenv
    from repro_torch.configs.rosella_sim import tpch_speed_set
    from repro_torch.serving import recovery as trcv

    speeds = tpch_speed_set(64, 0)
    scn = tenv.make(name, speeds=tuple(speeds), rate=0.7 * float(speeds.sum()))
    rc = (trcv.RecoveryConfig(timeout_mult=8.0, retry_budget=2, retry_cap=4, spec_cap=2,
                              spec_ratio=3.0) if name == "crash_storm" else None)
    return tenv, scn, dict(seed=0, arrival_batch=32, sequential_pool=True, recovery=rc)


@pytest.mark.parametrize("name", ["null", "churn", "crash_storm"])
def test_turn_without_telemetry_captures_the_same_graph(dev, name):
    """``observe=None`` captures the turn node for node as before the fold."""
    tenv, scn, kw = _obs_scenario(name)
    s = tenv.run_scenario(scn, use_scan=True, device=dev, **kw)
    assert s["info"]["graph_nodes"] == NODES_WITHOUT_TELEMETRY[name]


@pytest.mark.parametrize("name", ["churn", "crash_storm"])
def test_telemetry_graph_on_the_card(dev, name):
    """The plain (churn) and the faulty (crash_storm) turn with the window
    fold and the detector captured and replayed at n = 64: responses and μ̂
    bit-equal to the turn without telemetry; window records equal in every
    key to the host loop's on the card; against the same scan run eagerly
    on the CPU, within tests/test_torch_obs.py's bars (the histogram at
    twice the samples within 2 ulps of a bin edge, counted from the host
    loop's decision trace: torch's ``log`` on the card and on the CPU may
    part in the last bit; μ̂ parts by up to 8 ulps, as the faulty scan
    test states, and with it ``mu_rel_err`` and the detector's float
    state); stream-only rows give the same stream."""
    from test_torch_obs import assert_records_equal, assert_windows_within_bars, \
        copy_latencies, edge_count

    from repro_torch import obs

    tenv, scn, kw = _obs_scenario(name)
    ocfg = obs.ObserveConfig(window_turns=16, detect=obs.DetectConfig())
    trace = obs.DecisionTrace(cap=1 << 22)
    g = tenv.run_scenario(scn, use_scan=True, device=dev, observe=ocfg, **kw)
    off = tenv.run_scenario(scn, use_scan=True, device=dev, **kw)
    h = tenv.run_scenario(scn, device=dev, observe=ocfg, decisions=trace, **kw)
    c = tenv.run_scenario(scn, use_scan=True, device="cpu", observe=ocfg, **kw)
    so = tenv.run_scenario(scn, use_scan=True, device=dev, chunk_turns=37,
                           observe=obs.ObserveConfig(window_turns=16, detect=obs.DetectConfig(),
                                                     emit_responses=False), **kw)
    info = g["info"]
    assert info["replays"] == info["turns"] == len(h["mu_trace"]) > 100
    assert info["graph_nodes"] > off["info"]["graph_nodes"]
    np.testing.assert_array_equal(g["responses"], off["responses"])
    np.testing.assert_array_equal(g["mu_trace"], off["mu_trace"])
    np.testing.assert_array_equal(g["responses"], h["responses"])
    assert_records_equal(h["info"]["windows"], info["windows"])
    assert_records_equal(so["info"]["windows"], info["windows"])
    assert so["mu_trace"].shape == (0, 64)
    assert trace.dropped == 0
    samples = copy_latencies(trace)
    assert len(samples) == sum(w["n_resp"] for w in h["info"]["windows"])
    n_edge = edge_count(samples, ocfg)
    d = assert_windows_within_bars(info["windows"], c["info"]["windows"], ocfg, n_edge)
    print(f"{name}: {len(samples)} samples, {n_edge} within 2 ulps of an edge; card vs CPU "
          f"{d}")


def _fleet_case(mode):
    """n = 64 (the §6.1 speed grid), arrivals at 0.7·Σ speeds, batches of 32
    over S = 4 frontends, SequentialPool: the plain and frozen-μ̂ cells on
    150 turns of Poisson arrivals; churn (churn_heavy) and faults
    (crash_storm, no recovery) on the registry's clock."""
    from repro_torch import env as tenv
    from repro_torch.configs.rosella_sim import tpch_speed_set

    speeds = tpch_speed_set(64, 0)
    rate = 0.7 * float(speeds.sum())
    name = {"churn": "churn_heavy", "faulty": "crash_storm"}.get(mode, "null")
    scn = tenv.make(name, speeds=tuple(speeds), rate=rate,
                    **({} if mode in ("churn", "faulty") else {"horizon": 150 * 32 / rate}))
    return tenv, scn, dict(seed=0, arrival_batch=32, sequential_pool=True, use_scan=True,
                           n_frontends=4, sync_every=4, frozen_mu=mode == "frozen_mu",
                           pend_cap=16384)


@pytest.mark.parametrize("mode", ["plain", "frozen_mu", "churn", "faulty"])
def test_fleet_scan_on_the_card_equals_the_cpu_and_the_host_fleet_loop(dev, mode):
    """The fleet turn captured (one graph per pattern: sync or not) and
    replayed at n = 64, S = 4, sync every 4 turns: against the same fleet
    scan run eagerly on the CPU, responses, placements, sync gaps and ledger
    equal and μ̂ within 8 ulps (the learners' f32 sums reduce in another
    order on the card); the plain cell also bit for bit against the host
    fleet loop on the card (run_fleet_simulation). No placement on a replica
    inactive that turn; the ledger conserved; overflows 0; each replay
    launches one pool_chain and one K1 per frontend."""
    from repro_torch.serving import router as tr

    tenv, scn, kw = _fleet_case(mode)
    g = tenv.run_scenario(scn, device=dev, **kw)
    c = tenv.run_scenario(scn, device="cpu", **kw)
    info, wl = g["info"], g["workload"]
    assert info["flush_overflow"] == info["pend_overflow"] == 0
    assert info["replays"] == info["turns"] == wl.turns > 100
    assert set(info["graphs"]) == {"sync", "no sync"}
    for graph in info["graphs"].values():
        assert sum(v for nm, v in graph["kernels"].items() if "pool_chain_kernel" in nm) == 1
        assert sum(v for nm, v in graph["kernels"].items() if "ppot_kernel" in nm) == 4
    np.testing.assert_array_equal(g["responses"], c["responses"])
    for key in ("workers", "sync_gaps", "epochs"):
        np.testing.assert_array_equal(info[key], c["info"][key], err_msg=key)
    assert info.get("ledger") == c["info"].get("ledger")
    ia = g["mu_trace"].view(np.int32).astype(np.int64)
    ib = c["mu_trace"].view(np.int32).astype(np.int64)
    assert np.abs(ia - ib).max() <= 8
    if wl.active is not None:
        placed = info["workers"].reshape(wl.turns, -1)
        assert all(wl.active[t][placed[t]].all() for t in range(wl.turns))
    if mode == "faulty":
        assert info["ledger"]["conserved"] and info["ledger"]["copies_real_killed"] > 0
    if mode == "plain":
        speeds = np.asarray(scn.speeds)
        rh = tr.FleetRouter(4, 64, float(speeds.sum()), seed=0, async_mu=False, device=dev)
        ph = tr.SequentialPool(speeds)
        # the null scenario's workload is run_simulation's draws
        resp_h, mu_h, ih = tr.run_fleet_simulation(
            rh, ph, arrival_rate=scn.rate, horizon=scn.horizon, seed=0, arrival_batch=32,
            sync_every=4)
        np.testing.assert_array_equal(resp_h, g["responses"])
        np.testing.assert_array_equal(mu_h, g["mu_trace"])
        np.testing.assert_array_equal(ph.free_at, g["pool"].free_at)
        np.testing.assert_array_equal(ih["sync_gaps"], info["sync_gaps"])
        for a, b in zip(rh.frontends, g["router"].frontends):
            assert torch.equal(a.q_view, b.q_view) and torch.equal(a.learner.mu_hat,
                                                                   b.learner.mu_hat)


@pytest.mark.parametrize("stream,sync_every,frozen",
                         [("alias", 1, False), ("icdf", 1, False), ("alias", 4, True)])
def test_mesh_fleet_scan_on_the_card_equals_the_stacked_scan(dev, tmp_path, stream, sync_every,
                                                             frozen):
    """The collective fleet on a one-rank NCCL mesh (a FileStore in a
    temporary directory) at tests/test_torch_fleet_mesh.py's size (n = 4,
    S = 4, batches of 8, 80 s): equal bit for bit to the stacked fleet scan
    on the card, every turn a replay of a graph that holds the sync's
    collectives; the sync kinds ran once a sync turn."""
    from repro_torch.fleet import sync as fsync
    from repro_torch.serving import router as tr
    from repro_torch.serving import scanloop as tsl

    speeds = np.array([0.25, 0.5, 1.0, 2.0])
    kw = dict(arrival_rate=3.0, horizon=80.0, seed=1, arrival_batch=8, sync_every=sync_every,
              frozen_mu=frozen)

    def fleet():
        return (tr.FleetRouter(4, 4, mu_bar=float(speeds.sum()), seed=0, async_mu=False,
                               use_alias=stream == "alias", device=dev),
                tr.SequentialPool(speeds))

    rn, pn = fleet()
    resp_n, mu_n, info_n = tsl.run_fleet_simulation_scan(rn, pn, **kw)
    rm, pm = fleet()
    with fsync.file_store_mesh(tmp_path / "store", 0, 1, dev, timeout_s=60) as mesh:
        resp_m, mu_m, info = tsl.run_fleet_simulation_scan(rm, pm, mesh=mesh, **kw)
        tsl.fleet_runner.cache_clear()
    T = info["turns"]
    assert info["replays"] == T == info_n["turns"] > 20
    np.testing.assert_array_equal(resp_m, resp_n)
    np.testing.assert_array_equal(mu_m, mu_n)
    np.testing.assert_array_equal(pm.free_at, pn.free_at)
    for key in ("workers", "epochs", "sync_gaps", "frontends", "lam_hats"):
        np.testing.assert_array_equal(info[key], info_n[key], err_msg=key)
    for a, b in zip(rm.frontends, rn.frontends):
        assert torch.equal(a.q_view, b.q_view) and torch.equal(a.learner.mu_hat,
                                                               b.learner.mu_hat)
        assert a.key == b.key
    for kind in fsync.SYNC_KINDS:
        assert info["collectives"][kind] == -(-T // sync_every)
    assert all(g["collectives"] for g in info["graphs"].values())


@pytest.mark.parametrize("n,bc", [(1024, 4096), (64, 256)])
def test_pool_turn_kernel_at_a_stream_burst_width(dev, n, bc):
    """The turn form at a churn stream's fixed burst width (n x probe_burst,
    -1 padded), with the faulty turn's tail: at n = 1024 that is 4,238 steps,
    more than MAX_M but within the block's shared memory (max_steps(n)); the
    -1 pads all submit to replica 0 inactive, one long chain. Equal to the
    plain version."""
    from repro_torch.kernels.pool_chain import kernel as ck
    from repro_torch.kernels.pool_chain import ref as cr

    rng = np.random.RandomState(n + bc)
    k, R = 128, 6
    assert 8 + bc + k + R <= ck.max_steps(n)
    fa, sp = rng.rand(n) * 3, rng.rand(n) + 0.05
    fake = rng.randint(0, n, 8).astype(np.int32)
    burst = np.full(bc, -1, np.int32)
    burst[:12] = np.repeat(rng.randint(0, n, 3), 4).astype(np.int32)  # three rejoins
    workers = rng.randint(0, n, k).astype(np.int32)
    times, costs = np.sort(rng.rand(k) * 3), rng.exponential(1.0, k)
    t = [torch.from_numpy(x).to(dev) for x in (fa, sp, fake, burst, workers, times, costs)]
    tail = [torch.from_numpy(x).to(dev) for x in (rng.randint(0, n, R).astype(np.int32),
                                                  rng.exponential(1.0, R), rng.rand(R) < 0.7)]
    want = cr.pool_turn_ref(*t, 0.25, 1.0, *tail)
    cm = torch.zeros((), dtype=torch.int32, device=dev)
    got = ck.pool_turn(*t, 0.25, 1.0, tail_w=tail[0], tail_cost=tail[1], tail_gate=tail[2],
                       chain_max=cm)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(cm) == cr.longest_chain(want[2], n) >= bc - 12


LOAD_SPEED_TILE = (2.0, 2.0, 1.0, 1.0, 0.5, 1.5, 1.0, 0.5)


def _load_scenario(horizon: float):
    """chip_smoke.py's [load] cell (64 workers, base rate 40, the Azure shape
    of benchmarks/loadtest.py, batches of 128) cut to ``horizon`` seconds."""
    from repro_torch.env.scenario import Scenario
    from repro_torch.load import AzureLikeTrace

    return Scenario(name="azure_like_load", speeds=tuple(np.tile(LOAD_SPEED_TILE, 8)),
                    rate=40.0, horizon=horizon,
                    arrivals=AzureLikeTrace(period=3600.0, depth=0.4, burst_factor=3.0,
                                            dwell=(120.0, 15.0), cost_sigma=1.2))


@pytest.mark.parametrize("use_alias", [True, False])
def test_stream_on_the_card_equals_the_monolithic_scan(dev, use_alias):
    """A generated stream through ``run_stream_scan`` on the card, in chunks
    of 32 turns (windows of 16): responses, μ̂ trace, window records and the
    final router and pool state equal bit for bit to ``run_workload_scan``
    on the card over the concatenated chunks (its own capture, one chunk);
    stream-only gives the same windows; every turn a graph replay. On the
    alias stream, against the same stream run eagerly on the CPU: responses
    equal, μ̂ within 8 ulps, windows within tests/test_torch_obs.py's bars
    (the CDF stream is not held to the CPU's: the card's cumsum orders the
    cdf's sums otherwise, a few ulps apart, and a draw near a step of the
    cdf then takes its neighbour, after which the runs part)."""
    from test_torch_load_scan import MU_ULPS, _same_final_state, _same_runs, _ulps
    from test_torch_obs import assert_records_equal, assert_windows_within_bars, edge_count

    from repro_torch import obs
    from repro_torch.load import ScenarioStream, run_stream_scan
    from repro_torch.serving import router as tr
    from repro_torch.serving import scanloop as tsl

    scn = _load_scenario(400.0)
    speeds = np.asarray(scn.speeds, float)
    ocfg = obs.ObserveConfig(window_turns=16)

    def router(device):
        return tr.RosellaRouter(64, float(speeds.sum()), seed=0, use_alias=use_alias,
                                async_mu=False, c_window=10.0, device=device)

    def stream_run(device, cfg=ocfg):
        r, p = router(device), tr.SimulatedPool(speeds)
        out = run_stream_scan(r, p, ScenarioStream(scn, seed=0, arrival_batch=128),
                              chunk_turns=32, fake_cost=0.25, pend_cap=8192, comp_cap=512,
                              observe=cfg, timing=True)
        return out, r, p

    got, r1, p1 = stream_run(dev)
    # the same chunks concatenated (a generated stream's draws depend on the
    # chunk length: its cost draws interleave with the arrival blocks)
    parts = list(ScenarioStream(scn, seed=0, arrival_batch=128).chunks(32))
    cols = {f: np.concatenate([getattr(c, f) for c in parts]) for f in ("times", "costs",
                                                                         "speeds")}
    r0, p0 = router(dev), tr.SimulatedPool(speeds)
    want = tsl.run_workload_scan(r0, p0, cols["times"], cols["costs"], cols["speeds"],
                                 fake_cost=0.25, pend_cap=8192, comp_cap=512, observe=ocfg)
    info = got[2]
    T = len(cols["times"])
    assert info["replays"] == info["turns"] == T > 100 and info["graph_nodes"]
    assert len(info["chunks"]) == len(parts)
    _same_runs(got, want)
    _same_final_state(r1, p1, r0, p0)
    so = stream_run(dev, obs.ObserveConfig(window_turns=16, emit_responses=False))[0]
    assert so[0].size == 0 and so[1].shape == (0, 64)
    assert_records_equal(so[2]["windows"], info["windows"])
    if not use_alias:
        return
    cpu, _, _ = stream_run("cpu")
    np.testing.assert_array_equal(got[0], cpu[0])
    assert int(_ulps(got[1], cpu[1]).max()) <= MU_ULPS
    assert_windows_within_bars(info["windows"], cpu[2]["windows"], ocfg,
                               edge_count(got[0], ocfg))


def test_faulty_stream_on_the_card_equals_the_monolithic_scan(dev):
    """crash_storm at n = 64 (the §6.1 speed grid, 0.7·Σ speeds, batches of
    32, recovery armed) as a ScenarioStream on the card, in chunks of 37
    with windows of 16 (coprime) and the stream's fixed burst width:
    responses (NaN = lost), μ̂ trace, windows, ledger and final state equal
    bit for bit to the monolithic faulty scan on the card; conserved."""
    from test_torch_load_scan import _pad_burst, _same_final_state, _same_runs

    from repro_torch import env as tenv
    from repro_torch import obs
    from repro_torch.configs.rosella_sim import tpch_speed_set
    from repro_torch.core import metrics as met
    from repro_torch.load import ScenarioStream, run_stream_scan
    from repro_torch.serving import recovery as rcv
    from repro_torch.serving import router as tr
    from repro_torch.serving import scanloop as tsl

    speeds = tpch_speed_set(64, 0)
    scn = tenv.make("crash_storm", speeds=tuple(speeds), rate=0.7 * float(speeds.sum()),
                    horizon=240.0)
    wl = scn.compile_serving(seed=0, arrival_batch=32)
    rc = rcv.RecoveryConfig(timeout_mult=8.0, retry_budget=2, retry_cap=4, spec_cap=2,
                            spec_ratio=3.0)
    ocfg = obs.ObserveConfig(window_turns=16)

    def router():
        return tr.RosellaRouter(64, float(speeds.sum()), seed=0, use_alias=True,
                                async_mu=False, device=dev)

    stream = ScenarioStream(scn, seed=0, arrival_batch=32)
    r1, p1 = router(), tr.SequentialPool(speeds)
    got = run_stream_scan(r1, p1, stream, chunk_turns=37, fake_cost=scn.request_cost * 0.25,
                          recovery=rc, pend_cap=16384, comp_cap=1024,
                          task_cap=wl.turns * 32, observe=ocfg)
    r0, p0 = router(), tr.SequentialPool(speeds)
    want = tsl.run_workload_scan(
        r0, p0, wl.times, wl.costs, wl.speeds, active_np=wl.active, rejoin_np=wl.rejoin,
        burst_np=_pad_burst(wl.burst, wl.turns, stream.burst_cap),
        fake_cost=scn.request_cost * 0.25, kill_np=wl.kill_at, stall_np=wl.stall_at,
        stall_dur_np=wl.stall_dur, recovery=rc, pend_cap=16384, comp_cap=1024, observe=ocfg)
    assert got[2]["replays"] == got[2]["turns"] == wl.turns and stream.burst_cap == 256
    _same_runs(got, want)
    _same_final_state(r1, p1, r0, p0)
    led = got[2]["ledger"]
    assert led["conserved"] and met.check_conservation(led)[0] and led["n_retries"] > 0


def _sim_batch(n, mt, specs, rounds, dev, *, trace_queues=True, trace_mu=True):
    """(runs, draws on the card): each spec a (policy, learner, alias,
    phases, bsc) run at n workers and mt slots of Fig. 9's job mix, each of
    ``rounds`` rounds (an int, or one a spec)."""
    import dataclasses

    from repro_torch.configs import rosella_sim as RS
    from repro_torch.core import simulator as tsim
    from repro_torch.utils import prng as tprng

    speeds = RS.tpch_speed_set(n, 0)
    probs = None if mt == 1 else [0.4, 0.3, 0.2, 0.1][:mt]
    lengths = [rounds] * len(specs) if isinstance(rounds, int) else rounds
    runs = []
    for i, ((policy, learner, alias, phases, bsc), T) in enumerate(zip(specs, lengths)):
        cfg, params = RS.make_sim(policy, speeds, 0.8, rounds=T, use_learner=learner,
                                  use_fake_jobs=learner, volatile_phases=phases,
                                  phase_period=15.0, max_tasks=mt, task_probs=probs,
                                  constrained_frac=0.1 if mt > 1 else 0.0, device=dev)
        cfg = dataclasses.replace(cfg, use_alias=alias, batch_self_correct=bsc,
                                  trace_queues=trace_queues, trace_mu=trace_mu)
        runs.append((cfg, params, tprng.PRNGKey(i)))
    draws = [tsim.draw_rounds(cfg, p, key, dev) for cfg, p, key in runs]
    return runs, draws


_MIXED = [("ppot_sq2", True, True, 0, True), ("pss", True, False, 3, True),
          ("halo", False, True, 2, True), ("sparrow", False, True, 0, True),
          ("pot", False, True, 0, True)]
#: case -> _sim_batch arguments (n, mt, specs, rounds, flags). tile_edges:
#: at n = 30 a tile is kernel.TILE_MAX = 256 rounds, so 100 is shorter than
#: one, 257 one past it, 600 and 1 no multiple of it, 256 exactly one
SIM_CASES = {
    "rosella": (30, 1, [("ppot_sq2", True, True, 4, True)], 3000, {}),
    "fig9_batch": (30, 4, [("sparrow", False, True, 0, True), ("bandit", True, False, 3, False),
                           ("ppot_ll2", False, True, 0, True), ("halo", False, True, 3, True),
                           ("pss", True, False, 0, True), ("uniform", False, True, 0, False),
                           ("pot", False, True, 2, True), ("ppot_sq2", True, False, 3, True)],
                   1500, {}),
    "tile_edges": (30, 1, _MIXED, [600, 100, 257, 256, 1], {}),
    "untraced": (30, 1, _MIXED, [600, 100, 257, 256, 1],
                 dict(trace_queues=False, trace_mu=False)),
    "queues_only": (30, 4, _MIXED[:3], [513, 40, 300], dict(trace_mu=False)),
    "n1": (1, 1, [("ppot_sq2", True, True, 0, True), ("pss", True, False, 2, True),
                  ("pot", False, True, 0, True)], 700, {}),
    "n200": (200, 1, [("ppot_sq2", True, True, 0, True), ("pss", True, False, 2, True)],
             [300, 251], {}),
    "cdf_learner": (30, 1, [("ppot_sq2", True, False, 0, True), ("bandit", True, False, 3, True),
                            ("ppot_ll2", True, False, 2, True)], 2000, {}),
}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_sim_chain_kernel_equals_the_plain_chain(dev, case):
    """The kernel and the plain chain on the CPU, fed the same draws (drawn
    on the card), agree in every trace column and every field of the final
    state, bit for bit: at the tile edges, on batches of unequal rounds,
    with and without the queue and μ̂ rows, at n = 1 and n = 200 (a ring of
    128), on the CDF stream with the learner."""
    from repro_torch.core import simulator as tsim
    from repro_torch.kernels.sim_chain import kernel as SCK

    n, mt, specs, rounds, flags = SIM_CASES[case]
    runs, draws = _sim_batch(n, mt, specs, rounds, dev, **flags)
    if case == "tile_edges":
        args, shape = tsim.chain_inputs(runs, draws, dev)
        assert SCK.tile_rounds(args[4]["dt"].shape[1], n, mt, shape["ring_cap"],
                               shape["arrival_window"], J=2 * mt) == SCK.TILE_MAX == 256
    SCK.reset_launches()
    got = tsim.simulate_many(runs, dev, draws)
    torch.cuda.synchronize()
    assert SCK.launch_counts()["sim_chain"] == 1
    cpu_runs = [(cfg, p.to("cpu"), key) for cfg, p, key in runs]
    want = tsim.simulate_many(cpu_runs, "cpu", [{k: v.cpu() for k, v in d.items()}
                                                for d in draws])
    assert SCK.launch_counts()["sim_chain"] == 1
    for (cfg, _, _), (gs, gt), (ws, wt) in zip(runs, got, want):
        assert set(gt) == set(wt)
        for name in wt:
            assert torch.equal(gt[name].cpu(), wt[name]), name
        for f in ("now", "q_real", "q_fake", "s_real", "busy_start"):
            assert torch.equal(getattr(gs, f).cpu(), getattr(ws, f)), f
        for f in ("samples", "stamps", "widx", "count", "epoch_start", "mu_hat"):
            assert torch.equal(getattr(gs.learner, f).cpu(), getattr(ws.learner, f)), f
        for f in ("times", "idx", "count", "lam_hat"):
            assert torch.equal(getattr(gs.arr, f).cpu(), getattr(ws.arr, f)), f
        if cfg.rounds >= 100:
            assert (gt["code"] == 0).sum() > 0


#: the environment, fault and fleet modes: case -> [(label, kind, arguments)];
#: kind "env" (a registry scenario at n = 5: scenario, policy, SimConfig
#: fields), "jobs" (crash_storm with Fig. 9's jobs) or "fleet" (6.1's 30
#: speeds: S, sync, herd, load balancer, SimConfig fields); each batch in one
#: launch of SIM_EXT_ROUNDS rounds a chain
SIM_EXT_CASES = {
    "env_tracks": [(name, "env", (name, "ppot_sq2", {}))
                   for name in ("flash_crowd", "reshuffle", "churn", "churn_heavy", "blackout",
                                "crash_storm", "grey_failure", "diurnal", "speed_drift")],
    "env_policies": [
        ("cdf", "env", ("churn_heavy", "ppot_sq2", dict(use_alias=False))),
        ("known", "env", ("crash_storm", "ppot_sq2", dict(use_learner=False,
                                                          use_fake_jobs=False))),
        ("sparrow", "env", ("churn_heavy", "sparrow", dict(use_learner=False))),
        ("bandit", "env", ("crash_storm", "bandit", {})),
        ("halo", "env", ("churn_heavy", "halo", dict(use_learner=False))),
        ("pot", "env", ("blackout", "pot", dict(use_learner=False))),
        ("uniform", "env", ("churn", "uniform", {})),
        ("pss cdf", "env", ("churn_heavy", "pss", dict(use_alias=False))),
        ("ll2", "env", ("churn_heavy", "ppot_ll2", dict(use_learner=False))),
        ("churn S=4 sync 64 herd", "env", ("churn", "ppot_sq2", dict(
            n_frontends=4, fleet_sync_every=64, fleet_herd_correction=True))),
        ("crash_storm S=2 sync 0 sticky", "env", ("crash_storm", "ppot_sq2", dict(
            n_frontends=2, fleet_sync_every=0, frontend_lb="sticky"))),
    ],
    "env_jobs": [("crash_storm jobs", "jobs", (True,)), ("churn jobs, fold 1", "jobs", (False,))],
    # the scenarios at 6.1's 30 speeds and rate 0.8 x their sum, as [sim env]
    # runs them: within 2,000 rounds (~96 s) each has 31 departures and more
    # than 20 rejoins, crash_storm 31 crashes
    "env_paper_cluster": [(name, "env30", (name, "ppot_sq2", {}))
                          for name in ("crash_storm", "churn_heavy")],
    "fleet": [
        ("S=4 sync 4 herd", "fleet", (4, 4, True, "uniform", {})),
        ("S=4 sync 4 weighted", "fleet", (4, 4, False, "weighted", {})),
        ("S=4 sync 4 sticky", "fleet", (4, 4, False, "sticky", {})),
        ("S=2 sync 0 herd", "fleet", (2, 0, True, "uniform", {})),
        ("S=4 sync 64 cdf", "fleet", (4, 64, False, "uniform", dict(use_alias=False))),
        ("S=4 sync 16 known", "fleet", (4, 16, True, "uniform", dict(use_learner=False,
                                                                      use_fake_jobs=False))),
        ("S=1 sync 8", "fleet", (1, 8, False, "uniform", {})),
        ("S=1 sync 1 (the paper's chain)", "fleet", (1, 1, False, "uniform", {})),
    ],
}
SIM_EXT_ROUNDS = 2000


def _sim_ext_run(kind, args, i, dev):
    """(cfg, params, key, env) of one SIM_EXT_CASES entry."""
    import dataclasses

    from repro_torch import env as tenv
    from repro_torch.configs import rosella_sim as RS
    from repro_torch.core import simulator as tsim
    from repro_torch.utils import prng as tprng

    key = tprng.PRNGKey(i)
    if kind in ("env", "env30"):
        scn, policy, kw = args
        at = {}
        if kind == "env30":
            speeds = RS.tpch_speed_set(30, 0)
            at = dict(speeds=tuple(speeds), rate=0.8 * float(speeds.sum()))
        cfg, params, e = tenv.make(scn, **at).to_sim(policy, rounds=SIM_EXT_ROUNDS, device=dev,
                                                      **kw)
        return cfg, params, key, e
    if kind == "jobs":
        (bsc,) = args
        scn = tenv.make("crash_storm" if bsc else "churn")
        cfg, params, e = scn.to_sim("ppot_sq2", rounds=SIM_EXT_ROUNDS, device=dev, max_tasks=4,
                                    constrained_frac=0.1, batch_self_correct=bsc)
        params = tsim.make_params(lam=params.lam.item(), mu=np.asarray(scn.speeds, float),
                                  mu_bar=float(np.sum(scn.speeds)),
                                  task_probs=[0.4, 0.3, 0.2, 0.1], max_tasks=4, device=dev)
        return cfg, params, key, e
    S, se, herd, lb, kw = args
    cfg, params = RS.make_sim("ppot_sq2", RS.tpch_speed_set(30, 0), 0.8, rounds=SIM_EXT_ROUNDS,
                              n_frontends=S, fleet_sync_every=se, fleet_herd_correction=herd,
                              device=dev)
    if lb == "weighted":
        params = dataclasses.replace(params, lb_weights=torch.tensor([6.0, 1.0, 1.0, 1.0],
                                                                     device=params.lam.device))
    return dataclasses.replace(cfg, frontend_lb=lb, **kw), params, key, None


def _same_sim_state(gs, ws) -> None:
    """Two chains' final states equal field by field (on the CPU)."""
    for f in ("now", "q_real", "q_fake", "s_real", "busy_start"):
        assert torch.equal(getattr(gs, f).cpu(), getattr(ws, f)), f
    for f in ("samples", "stamps", "widx", "count", "epoch_start", "mu_hat"):
        assert torch.equal(getattr(gs.learner, f).cpu(), getattr(ws.learner, f)), f
    for f in ("times", "idx", "count", "lam_hat"):
        assert torch.equal(getattr(gs.arr, f).cpu(), getattr(ws.arr, f)), f
    assert (gs.fleet is None) == (ws.fleet is None)
    if ws.fleet is not None:
        assert torch.equal(gs.crash_i.cpu(), ws.crash_i)
        for f in ("q_snap", "q_delta", "mu_view", "alias_p", "alias_a", "t_sync", "lam_global"):
            assert torch.equal(getattr(gs.fleet, f).cpu(), getattr(ws.fleet, f)), f
        for f in ("last_time", "mean_gap", "count"):
            assert torch.equal(getattr(gs.fleet.arr, f).cpu(), getattr(ws.fleet.arr, f)), f


@pytest.mark.parametrize("case", list(SIM_EXT_CASES))
def test_sim_chain_ext_kernel_equals_the_plain_chain(dev, case):
    """The environment, fault and fleet modes: the kernel (its environment
    and fleet instances) and the plain chain on the CPU, fed the same draws
    (drawn on the card), agree in every trace column and every field of the
    final state (the fleet's and the crash track's too, the view's alias
    table as the kernel froze it), bit for bit, in one launch a case."""
    from repro_torch.core import simulator as tsim
    from repro_torch.kernels.sim_chain import kernel as SCK

    runs = [_sim_ext_run(kind, args, i, dev)
            for i, (_, kind, args) in enumerate(SIM_EXT_CASES[case])]
    draws = [tsim.draw_rounds(cfg, p, key, dev, e) for cfg, p, key, e in runs]
    SCK.reset_launches()
    got = tsim.simulate_many(runs, dev, draws)
    torch.cuda.synchronize()
    assert SCK.launch_counts()["sim_chain"] == 1
    cpu_runs = [(cfg, p.to("cpu"), key, None if e is None else e.to("cpu"))
                for cfg, p, key, e in runs]
    want = tsim.simulate_many(cpu_runs, "cpu", [{k: v.cpu() for k, v in d.items()}
                                                for d in draws])
    for (label, _, _), (gs, gt), (ws, wt) in zip(SIM_EXT_CASES[case], got, want):
        assert set(gt) == set(wt)
        for name in wt:
            assert torch.equal(gt[name].cpu(), wt[name]), (label, name)
        _same_sim_state(gs, ws)
        assert (gt["code"] == 0).sum() > 0
    if case == "env_tracks":
        killed = {label: int(tr["killed"].sum()) for (label, _, _), (_, tr) in
                  zip(SIM_EXT_CASES[case], got)}
        assert killed["crash_storm"] > 0 and got[0][1]["killed"].shape == (SIM_EXT_ROUNDS, 0)


def test_sim_chain_ext_runs_the_paper_chain_as_the_paper_kernel(dev):
    """A paper-mode chain in a batch with a fleet chain runs on the
    environment and fleet kernel, and equals the paper kernel's run bit for
    bit; the paper kernel's output keeps no fleet state."""
    from repro_torch.configs import rosella_sim as RS
    from repro_torch.core import simulator as tsim
    from repro_torch.utils import prng as tprng

    speeds = RS.tpch_speed_set(30, 0)
    paper = RS.make_sim("ppot_sq2", speeds, 0.8, rounds=1500, volatile_phases=3,
                        phase_period=20.0, device=dev) + (tprng.PRNGKey(4),)
    fleet = RS.make_sim("ppot_sq2", speeds, 0.8, rounds=900, n_frontends=3, fleet_sync_every=5,
                        device=dev) + (tprng.PRNGKey(5),)
    (fa, ta), = tsim.simulate_many([paper], dev)
    (fb, tb), _ = tsim.simulate_many([paper, fleet], dev)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert fa.fleet is None and fb.fleet is None
    for f in ("now", "q_real", "q_fake", "s_real", "busy_start"):
        assert torch.equal(getattr(fa, f), getattr(fb, f)), f
    for f in ("samples", "stamps", "widx", "count", "epoch_start", "mu_hat"):
        assert torch.equal(getattr(fa.learner, f), getattr(fb.learner, f)), f


def test_sim_chain_refuses_what_one_block_cannot_hold(dev):
    """The first n past the shared-memory limit at a ring of 128 (213: the
    rings, the state and a tile of one round; 205 with four frontends), and
    mt past MAX_MT."""
    from repro_torch.configs import rosella_sim as RS
    from repro_torch.core import simulator as tsim
    from repro_torch.utils import prng as tprng

    for n, mt, S in ((213, 1, 1), (300, 1, 1), (15, 9, 1), (205, 1, 4)):
        cfg, params = RS.make_sim("ppot_sq2", np.ones(n), 0.5, rounds=10, max_tasks=mt,
                                  n_frontends=S, fleet_sync_every=4 if S > 1 else 1,
                                  device=dev)
        with pytest.raises(ValueError, match="sim_chain"):
            tsim.simulate(cfg, params, tprng.PRNGKey(0), device=dev)
    cfg, params = RS.make_sim("ppot_sq2", np.ones(204), 0.5, rounds=10, n_frontends=4,
                              fleet_sync_every=4, device=dev)
    tsim.simulate(cfg, params, tprng.PRNGKey(0), device=dev)


#: the telemetry instances' cases: name -> [(label, SIM_EXT_CASES kind, its
#: arguments, the observe config's window and detector warm-up, or None)];
#: "paper" is Fig. 8's smoke chain (n = 30, Rosella, 6000 rounds)
SIM_OBS_CASES = {
    "churn n=30": [("churn", "env30", ("churn", "ppot_sq2", {}), (64, 4))],
    "crash_storm n=30": [("crash_storm", "env30", ("crash_storm", "ppot_sq2", {}), (64, 4))],
    "churn_heavy n=30": [("churn_heavy", "env30", ("churn_heavy", "ppot_sq2", {}), (32, 2))],
    "fig8 smoke": [("fig8", "paper", (6000,), (64, 4))],
    "S=4 sync 16": [("S=4 sync 16", "fleet", (4, 16, False, "uniform", {}), (64, 4))],
    "mixed": [("churn", "env30", ("churn", "ppot_sq2", {}), (64, 4)),
              ("churn off", "env30", ("churn", "ppot_sq2", {}), None),
              ("fig8 24 bins", "paper", (1500,), (16, None)),
              ("S=4 sync 16", "fleet", (4, 16, False, "uniform", {}), (32, 8))],
}


def _sim_obs_run(kind, args, obs_args, i, dev):
    """(cfg, params, key, env) of one SIM_OBS_CASES entry, with its telemetry."""
    import dataclasses

    from repro_torch import obs as tobs
    from repro_torch.configs import rosella_sim as RS
    from repro_torch.utils import prng as tprng

    if kind == "paper":
        cfg, params = RS.make_sim("ppot_sq2", RS.tpch_speed_set(30, 0), 0.8, rounds=args[0],
                                  device=dev)
        run = (cfg, params, tprng.PRNGKey(i), None)
    else:
        run = _sim_ext_run(kind, args, i, dev)
    if obs_args is None:
        return run
    window, warmup = obs_args
    det = None if warmup is None else tobs.DetectConfig(warmup_windows=warmup)
    ocfg = tobs.ObserveConfig(window_turns=window, detect=det,
                              hist_bins=24 if warmup is None else 64)
    return (dataclasses.replace(run[0], observe=ocfg),) + run[1:]


@pytest.mark.parametrize("case", list(SIM_OBS_CASES))
def test_sim_chain_obs_kernel_equals_the_plain_chain(dev, case):
    """The telemetry instances: the kernel and the plain chain on the CPU,
    fed the same draws, agree in every trace column, every window row field
    and boundary flag, and every field of the final state, bit for bit, in
    one launch a case (a chain without telemetry beside ones with it has no
    rows); and every other column equals the same launch with telemetry
    off."""
    import dataclasses

    from repro_torch.core import simulator as tsim
    from repro_torch.kernels.sim_chain import kernel as SCK

    runs = [_sim_obs_run(kind, args, o, i, dev)
            for i, (_, kind, args, o) in enumerate(SIM_OBS_CASES[case])]
    draws = [tsim.draw_rounds(cfg, p, key, dev, e) for cfg, p, key, e in runs]
    SCK.reset_launches()
    got = tsim.simulate_many(runs, dev, draws)
    torch.cuda.synchronize()
    assert SCK.launch_counts()["sim_chain"] == 1
    cpu_runs = [(cfg, p.to("cpu"), key, None if e is None else e.to("cpu"))
                for cfg, p, key, e in runs]
    want = tsim.simulate_many(cpu_runs, "cpu", [{k: v.cpu() for k, v in d.items()}
                                                for d in draws])
    off = tsim.simulate_many([(dataclasses.replace(r[0], observe=None),) + r[1:] for r in runs],
                             dev, draws)
    for (label, _, _, o), (gs, gt), (ws, wt), (_, ot) in zip(SIM_OBS_CASES[case], got, want,
                                                              off):
        assert set(gt) == set(wt)
        assert ("obs_row" in gt) == (o is not None)
        for name in wt:
            if name == "obs_row":
                for f, a, b in zip(wt[name]._fields, gt[name], wt[name]):
                    assert torch.equal(a.cpu(), b), (label, f)
            else:
                assert torch.equal(gt[name].cpu(), wt[name]), (label, name)
        for name in ot:
            assert torch.equal(gt[name], ot[name]), (label, name)
        _same_sim_state(gs, ws)
        if o is not None:
            assert int(gt["obs_flag"].sum()) == gt["code"].shape[0] // o[0]


# ---------------------------------------------------------------------------
# the MoE, VLM and encoder-decoder families, the int8 cache
# ---------------------------------------------------------------------------

#: moonshot's routing (64 experts, top-6, 2 shared) at small widths, with
#: head dim 32 so that the chunked attention path takes the kernel
MOE_SMALL = dict(n_experts=64, top_k=6, n_shared=2, moe_dff=32, d_head=32)


def _small(arch, **over):
    from repro_torch import configs

    return configs.reduced(configs.get_config(arch), **over)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("router", ["topk", "ppot"])
def test_cuda_moe_layer_equals_the_cpu(dev, router, per_row):
    """The MoE layer on the card against the CPU on the same parameters and
    input (f32): the top-k route integer-equal on the same gates, the
    expert computation on the same routes within 1e-5, the layer within
    1e-5 where no token's k-th and (k+1)-th gates lie within 8 ulps
    (counted: 0)."""
    from repro_torch.models import api
    from repro_torch.models import moe as TM

    cfg = _small("moonshot-v1-16b-a3b", router=router, **MOE_SMALL)
    model = api.init_params(cfg, 0, "cpu")
    p = model.layers[0].moe
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 3, cfg.d_model).astype(np.float32))
    gates = torch.softmax(x.reshape(24, -1) @ p.router, -1)
    s = gates.sort(-1, descending=True).values
    ulps = (s[:, cfg.top_k - 1].view(torch.int32) - s[:, cfg.top_k].view(torch.int32)).abs()
    assert int((ulps <= 8).sum()) == 0
    idx, w = TM.topk_route(cfg, gates)
    cidx, cw = TM.topk_route(cfg, gates.to(dev))
    assert torch.equal(cidx.cpu(), idx) and torch.equal(cw.cpu(), w)
    cap = TM.capacity(cfg, 3, cfg.n_experts)
    want = TM.expert_compute(cfg, p, x, idx.view(8, 3, -1), w.view(8, 3, -1), cap, groups=8)
    pd = model.to(dev).layers[0].moe
    got = TM.expert_compute(cfg, pd, x.to(dev), cidx.view(8, 3, -1), cw.view(8, 3, -1), cap,
                            groups=8)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    model = model.cpu()
    want, _ = TM.moe_apply(cfg, model.layers[0].moe, x, per_row=per_row)
    got, _ = TM.moe_apply(cfg, model.to(dev).layers[0].moe, x.to(dev), per_row=per_row)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


def test_cuda_moe_prefill_launches_flash_once_per_layer(dev):
    """moonshot-v1-16b-a3b at its published widths, 3 layers (the dense one
    and 2 MoE), B=1, S=2048: one K4 launch a layer at head dim 128; bf16
    last-position logits within chip_smoke.py's bar of the plain path, and
    the f32 model's hidden states within its f32 bar, each on the kernel
    path's expert routes (free-running, one route two roundings part moves
    which tokens an overflowing expert drops: ``moe.RouteTape``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import api
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as TM

    cfg = configs.get_config("moonshot-v1-16b-a3b", n_layers=3)
    model = api.init_params(cfg, 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (1, 2048), generator=gen, device=dev)
    tape = TM.RouteTape()
    fk.reset_launches()
    with tape.recording():
        got = api.prefill(cfg, model, {"tokens": toks})
    torch.cuda.synchronize()
    assert fk.launch_counts()["flash_attention_fwd"] == cfg.n_layers
    with tape.replaying(), api.plain_paths():
        want = api.prefill(cfg, model, {"tokens": toks})
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 0.5
    del model
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32", param_dtype="float32")
    model32 = api.init_params(cfg32, 0)
    with torch.no_grad():
        with tape.recording():
            h = LM.forward(cfg32, model32, toks)
        with tape.replaying(), api.plain_paths():
            hp = LM.forward(cfg32, model32, toks)
    assert (h - hp).abs().max().item() <= 2e-4


@pytest.mark.parametrize("router", ["topk", "ppot"])
def test_cuda_engine_routes_rows_alone(dev, router):
    """At moonshot's routing (f32): 4 requests decoded together in a 4-slot
    engine give each one's tokens alone in a one-slot engine, and a joint
    decode step (the rows sharing the capacity) moves the logits."""
    from repro_torch.models import api
    from repro_torch.serving.engine import ContinuousBatchingEngine

    cfg = _small("moonshot-v1-16b-a3b", router=router, **MOE_SMALL)
    model = api.init_params(cfg, 0, dev)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab, size=3 + i) for i in range(4)]

    def run(eng, reqs):
        assert all(eng.try_admit_batch(reqs))
        out = {}
        while eng.active.any():
            out.update(dict(eng.step()))
        return out

    full = run(ContinuousBatchingEngine(cfg, model, n_slots=4, max_len=32),
               [(i, p, 6) for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        alone = run(ContinuousBatchingEngine(cfg, model, n_slots=1, max_len=32), [(i, p, 6)])
        assert alone[i] == full[i], i
    toks = torch.from_numpy(np.stack([p[:1] for p in prompts])).to(dev)
    cache = api.init_cache(cfg, 4, 8, dev)
    a, _ = api.decode_fn(cfg, model, {"tokens": toks, "pos": 0}, cache, per_row=True)
    b, _ = api.decode_fn(cfg, model, {"tokens": toks, "pos": 0}, cache)
    assert (a - b).abs().max().item() > 1e-2


@pytest.mark.parametrize("arch", ["smollm-360m", "moonshot-v1-16b-a3b", "pixtral-12b",
                                  "whisper-medium"])
def test_cuda_new_families_equal_the_cpu(dev, arch):
    """Small configs (f32, head dim 32) on the card against the CPU on the
    same parameters: a prefill at S = 2048 (K4 in every layer; whisper's
    encoder at 2048 frames, which its decoder's cross attention reads
    through K4 too) and 6 decode steps with the int8 cache (bf16
    cache for whisper), logits within 1e-4."""
    import dataclasses

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import api
    from repro_torch.models import encdec as ED

    over = dict(MOE_SMALL) if arch.startswith("moonshot") else dict(d_head=32)
    if arch == "whisper-medium":
        over["enc_len"] = 2048
    cfg = _small(arch, **over)
    model = api.init_params(cfg, 0, "cpu")
    rng = np.random.RandomState(5)
    S = 16 if arch == "whisper-medium" else 2048
    batch = {"tokens": rng.randint(0, cfg.vocab, (2, S))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.randn(2, cfg.n_patches, cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        batch["frame_embeds"] = rng.randn(2, cfg.enc_len, cfg.d_model).astype(np.float32)
    want = api.prefill(cfg, model, batch)
    model = model.to(dev)
    fk.reset_launches()
    got = api.prefill(cfg, model, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    # whisper: the encoder's self-attention and the decoder's cross attention
    n_attn = cfg.n_enc_layers + cfg.n_layers if cfg.family == "encdec" else cfg.n_layers
    assert fk.launch_counts()["flash_attention_fwd"] == n_attn
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    cfg_q = dataclasses.replace(cfg, kv_quant=cfg.family != "encdec")
    enc = None
    if cfg.family == "encdec":
        enc = ED.encode(cfg, model.cpu(), torch.as_tensor(batch["frame_embeds"]))
    caches = {d: api.init_cache(cfg_q, 2, 8, d) for d in ("cpu", dev)}
    for t in range(6):
        outs = {}
        for d in ("cpu", dev):
            b = {"tokens": torch.as_tensor(batch["tokens"][:, t:t + 1], device=d), "pos": t}
            if enc is not None:
                b["enc_out"] = enc.to(d)
            outs[d], caches[d] = api.decode_fn(cfg_q, model.to(d), b, caches[d], per_row=True)
        torch.testing.assert_close(outs[dev].cpu(), outs["cpu"], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# training: K4's log-sum-exp, K4b, the attention VJP, the K5 gradient
# ---------------------------------------------------------------------------

#: the backward's bars: f32 against the plain version 2e-5 of each output's
#: largest value; bf16 2e-2 (P and dS rounded to bf16 before their
#: products, in another summation order than the plain version's)
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _bwd_inputs(dev, dtype, B, Sq, Sk, H, Hkv, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa: E731
    return r(B, Sq, H, D), r(B, Sk, Hkv, D), r(B, Sk, Hkv, D), r(B, Sq, H, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,q_offset", [
    (2, 130, 130, 4, 2, 64, True, 0, 0),     # GQA, a ragged tail tile
    (1, 100, 77, 2, 2, 128, False, 0, 0),    # D = 128, Sq != Sk
    (1, 200, 200, 3, 1, 32, True, 50, 0),    # a window (hymba)
    (1, 96, 96, 2, 2, 64, True, 0, -40),     # empty rows
    (1, 64, 300, 2, 2, 64, False, 0, 0),     # cross attention
])
def test_flash_lse_and_backward_match_plain_versions(dev, dtype, B, Sq, Sk, H, Hkv, D,
                                                     causal, window, q_offset):
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    q, k, v, do = _bwd_inputs(dev, dtype, B, Sq, Sk, H, Hkv, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    FK.reset_launches()
    o0 = FK.flash_attention_heads(q, k, v, **kw)
    o, lse = FK.flash_attention_heads(q, k, v, return_lse=True, **kw)
    grads = FK.flash_attention_bwd_heads(q, k, v, o, do, lse, **kw)
    again = FK.flash_attention_bwd_heads(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert FK.launch_counts() == {"flash_attention_fwd": 2, "flash_attention_bwd": 2}
    assert torch.equal(o0, o)
    _, lse_ref = FR.attention_heads_ref(q, k, v, return_lse=True, **kw)
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-5)
    want = FR.attention_bwd_heads_ref(q, k, v, o, do, lse, **kw)
    for name, g, w, g2 in zip(("dq", "dk", "dv"), grads, want, again):
        assert g.dtype == dtype and g.shape == w.shape and torch.equal(g, g2), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * max(w.float().abs().max().item(), 1e-30), name
    if q_offset < 0:
        assert (grads[0][:, :-q_offset] == 0).all()


def test_flash_vjp_on_the_card_matches_the_plain_pair(dev):
    """The model's attention VJP (``layers.FlashAttention``) on the card
    (K4 with its lse, K4b) against the same on the card inside
    ``api.plain_paths()`` (the chunked plain pair), f32."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import api
    from repro_torch.models import layers as L

    q, k, v, do = _bwd_inputs(dev, torch.float32, 2, 256, 256, 4, 2, 64, seed=1)
    out = {}
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        FK.reset_launches()
        with api.plain_paths() if plain else contextlib.nullcontext():
            o = L.FlashAttention.apply(*leaves, 0, True, 0, 128)
            o.backward(do)
        out[plain] = [o.detach()] + [t.grad for t in leaves]
        launched = FK.launch_counts()
        assert launched == ({"flash_attention_fwd": 0, "flash_attention_bwd": 0} if plain
                            else {"flash_attention_fwd": 1, "flash_attention_bwd": 1})
    for g, w in zip(out[False], out[True]):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


def test_gradient_through_the_ssd_kernel_raises_on_the_card(dev):
    from repro_torch import configs
    from repro_torch.models import api

    cfg = configs.reduced(configs.get_config("mamba2-370m"))
    model = api.trainable(api.init_params(cfg, 0, dev))
    batch = {"tokens": torch.zeros(1, 64, dtype=torch.long, device=dev),
             "labels": torch.zeros(1, 64, dtype=torch.long, device=dev),
             "mask": torch.ones(1, 64, device=dev)}
    with pytest.raises(NotImplementedError, match="A9b"):
        api.loss_fn(cfg, model, batch)
    with api.plain_paths():
        loss, _ = api.loss_fn(cfg, model, batch)
    loss.backward()
    assert torch.isfinite(model.layers[0].ssm.x_proj.grad).all()
