"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on numpy-seeded inputs, in float32.

Tolerances:
  * ``topk_route`` and ``ppot_route`` on identical gates: indices and
    weights bit-equal (the weights' sum runs left to right in both; the
    ppot draws go through ``prng.fold_in``, ``split`` and the Gumbel
    noise). A ppot draw may part only where its two largest scores lie
    within GUMBEL_ATOL (torch's ``log`` against XLA's); on these inputs
    no score pair is that close (counted: 0).
  * ``expert_compute`` and ``moe_apply``: atol = rtol = 2e-5 (the expert
    products' reduction order, XLA's einsum against ``torch.bmm``), the
    dropped tokens' rows exactly 0. The gates are ``softmax(x @ router)``
    in both packages, summed in different orders; a token whose k-th and
    (k+1)-th gates lie within GATE_ULPS could take another expert, and on
    these inputs none does (counted: 0).
  * ``load_balance_loss`` and ``expert_load_stats``: rtol 1e-6 (f32
    means), the counts and the capacity exact.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import dataclasses
import types

import numpy as np
import pytest
import torch
from test_torch_model import reference_shim

from repro_torch import configs as tconfigs
from repro_torch.models import moe as TM

TOL = 2e-5
GUMBEL_ATOL = 2e-6
GATE_ULPS = 8
ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
#: moonshot's routing (64 experts, top-6, 2 shared) at reduced widths: one
#: slot an expert for a token routed alone, and one for eight rows routed
#: jointly (their 48 assignments among 64 experts collide)
WIDE = dict(n_experts=64, top_k=6, n_shared=2, moe_dff=16)
ROWS = 8


@pytest.fixture(scope="module")
def ref():
    with reference_shim():
        import jax
        import jax.numpy as jnp

        from repro import configs
        from repro.models import moe

        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs, moe=moe)


def _cfgs(ref, arch, **over):
    return (ref.configs.reduced(ref.configs.get_config(arch), **over),
            tconfigs.reduced(tconfigs.get_config(arch), **over))


def _gates(ref, T, E, seed, ties: bool = True):
    logits = np.random.RandomState(seed).randn(T, E).astype(np.float32) * 2
    g = np.array(ref.jax.nn.softmax(ref.jnp.asarray(logits), -1))
    if ties:  # equal gates: the lower index first
        g[:5, :3] = g[:5, 3:4]
    return g


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _gate_near_ties(gates, k) -> int:
    """Tokens whose k-th and (k+1)-th gates lie within GATE_ULPS."""
    s = np.sort(np.asarray(gates), -1)[:, ::-1]
    return int((_ulps(s[:, k - 1], s[:, k]) <= GATE_ULPS).sum()) if s.shape[1] > k else 0


def _ppot_near_ties(ref, gates, key, k) -> int:
    """Draws whose two largest Gumbel scores lie within GUMBEL_ATOL."""
    jax, jnp = ref.jax, ref.jnp
    logits = jnp.log(jnp.clip(jnp.asarray(gates), 1e-30))
    n = 0
    for slot in range(k):
        for kk in jax.random.split(jax.random.fold_in(key, slot)):
            s = np.sort(np.asarray(jax.random.gumbel(kk, gates.shape) + logits), -1)
            n += int((s[:, -1] - s[:, -2] <= GUMBEL_ATOL).sum())
    return n


def _port_moe(tcfg, jp):
    """The port's MoE module holding the reference's parameters."""
    p = TM.init_moe(tcfg, torch.Generator().manual_seed(0))
    for name, a in jp.items():
        if isinstance(a, dict):
            for sub, b in a.items():
                getattr(p.shared, sub).data.copy_(torch.from_numpy(np.array(b)))
        else:
            getattr(p, name).data.copy_(torch.from_numpy(np.array(a)))
    return p


# ---------------------------------------------------------------------------
# the routers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", [64, 1000])
def test_topk_route_bit_equal(ref, arch, T):
    jcfg, tcfg = ref.configs.get_config(arch), tconfigs.get_config(arch)
    g = _gates(ref, T, jcfg.n_experts, T)
    ji, jw = ref.moe.topk_route(jcfg, ref.jnp.asarray(g))
    ti, tw = TM.topk_route(tcfg, torch.from_numpy(g))
    assert ti.dtype == torch.int32 and np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 3])
def test_ppot_route_bit_equal(ref, arch, seed):
    jcfg, tcfg = ref.configs.get_config(arch), tconfigs.get_config(arch)
    g = _gates(ref, 512, jcfg.n_experts, seed)
    key = ref.jax.random.PRNGKey(seed)
    assert _ppot_near_ties(ref, g, key, jcfg.top_k) == 0
    ji, jw = ref.moe.ppot_route(jcfg, ref.jnp.asarray(g), key)
    ti, tw = TM.ppot_route(tcfg, torch.from_numpy(g), (0, seed))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tw.numpy(), np.asarray(jw))


def test_ppot_route_groups_are_the_vmapped_route(ref):
    """[G, T, E] gates: each group routed alone with the same draws, as
    ``jax.vmap`` of the reference's route over groups with one key."""
    jcfg, tcfg = ref.configs.get_config(ARCHS[0]), tconfigs.get_config(ARCHS[0])
    g = _gates(ref, 4 * 3, jcfg.n_experts, 5, ties=False).reshape(4, 3, -1)
    key = ref.jax.random.PRNGKey(2)
    assert _ppot_near_ties(ref, g.reshape(12, -1), key, jcfg.top_k) == 0
    ji, jw = ref.jax.vmap(lambda gg: ref.moe.ppot_route(jcfg, gg, key))(ref.jnp.asarray(g))
    ti, tw = TM.ppot_route(tcfg, torch.from_numpy(g), (0, 2))
    assert ti.shape == (4, 3, jcfg.top_k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    joint, _ = TM.ppot_route(tcfg, torch.from_numpy(g.reshape(12, -1)), (0, 2))
    assert not np.array_equal(joint.numpy(), ti.reshape(12, -1).numpy())


# ---------------------------------------------------------------------------
# expert computation, the loss and the load statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [3, 2, 64])
def test_expert_compute_with_capacity_drops(ref, cap):
    """Four experts; expert 0 takes most assignments, so at cap 3 and 2 it
    drops tokens (the reference's overflow bin receives them); cap 64 drops
    none. Tokens whose every assignment was dropped come out exactly 0."""
    jcfg, tcfg = _cfgs(ref, ARCHS[0])
    jp = ref.moe.init_moe(jcfg, ref.jax.random.PRNGKey(1))
    jp = {name: jp[name][:4] for name in ("wg", "wu", "wd")}
    tp = types.SimpleNamespace(**{name: torch.from_numpy(np.array(a)) for name, a in jp.items()})
    rng = np.random.RandomState(4)
    B, S, k = 2, 8, jcfg.top_k
    x = rng.randn(B, S, jcfg.d_model).astype(np.float32)
    idx = np.where(rng.rand(B, S, k) < 0.6, 0, rng.randint(0, 4, (B, S, k))).astype(np.int32)
    idx[..., 1] = np.where(idx[..., 1] == idx[..., 0], (idx[..., 0] + 1) % 4, idx[..., 1])
    w = rng.rand(B, S, k).astype(np.float32)
    want = np.asarray(ref.moe.expert_compute(jcfg, jp, *map(ref.jnp.asarray, (x, idx, w)),
                                             0, 4, cap))
    got = TM.expert_compute(tcfg, tp, *map(torch.from_numpy, (x, idx, w)), cap).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got == 0, want == 0)
    if cap < 64:
        assert (np.abs(want).sum(-1) == 0).any()  # a token lost every assignment


def test_load_balance_loss_and_expert_load_stats(ref):
    jcfg, tcfg = ref.configs.get_config(ARCHS[0]), tconfigs.get_config(ARCHS[0])
    g = _gates(ref, 300, jcfg.n_experts, 9)
    ji, _ = ref.moe.topk_route(jcfg, ref.jnp.asarray(g))
    tg, ti = torch.from_numpy(g), torch.from_numpy(np.array(ji))
    np.testing.assert_allclose(float(TM.load_balance_loss(tg, ti, jcfg.n_experts)),
                               float(ref.moe.load_balance_loss(ref.jnp.asarray(g), ji,
                                                               jcfg.n_experts)), rtol=1e-6)
    want = ref.moe.expert_load_stats(jcfg, ref.jnp.asarray(g), ji)
    got = TM.expert_load_stats(tcfg, tg, ti)
    assert got["capacity"] == want["capacity"] == TM.capacity(tcfg, 300, jcfg.n_experts)
    for key in ("max_load", "mean_load", "overflow_frac"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6)
    assert float(got["overflow_frac"]) > 0


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("router", ["topk", "ppot"])
def test_moe_apply_matches_reference(ref, arch, router):
    """moonshot with its shared expert, phi3.5 without; output and aux."""
    jcfg, tcfg = _cfgs(ref, arch, router=router)
    jp = ref.moe.init_moe(jcfg, ref.jax.random.PRNGKey(2))
    tp = _port_moe(tcfg, jp)
    assert hasattr(tp, "shared") == bool(jcfg.n_shared) == (arch == ARCHS[0])
    x = np.random.RandomState(5).randn(2, 24, jcfg.d_model).astype(np.float32)
    key = ref.jax.random.PRNGKey(7)
    gates = ref.jax.nn.softmax(ref.jnp.asarray(x).reshape(48, -1) @ jp["router"], -1)
    assert _gate_near_ties(gates, jcfg.top_k) == 0
    if router == "ppot":
        assert _ppot_near_ties(ref, np.asarray(gates), key, jcfg.top_k) == 0
    want, waux = ref.moe.moe_apply(jcfg, jp, ref.jnp.asarray(x), rng=key)
    got, gaux = TM.moe_apply(tcfg, tp, torch.from_numpy(x), rng=(0, 7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)


def test_route_tape_records_and_replays(ref):
    """``RouteTape`` (phi3.5: no shared expert): recording leaves the layer
    as it is and keeps its top-k routes and load stats; replayed on the
    same input it gives the same output, and on another input the layer
    takes the taped routes with that input's gates there renormalized, as
    the reference's ``expert_compute`` on those routes gives it."""
    jcfg, tcfg = _cfgs(ref, ARCHS[1])
    jp = ref.moe.init_moe(jcfg, ref.jax.random.PRNGKey(2))
    tp = _port_moe(tcfg, jp)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 24, jcfg.d_model).astype(np.float32)
    x2 = x + rng.randn(*x.shape).astype(np.float32)
    tx, tx2 = torch.from_numpy(x), torch.from_numpy(x2)
    gates = torch.softmax(tx.reshape(48, -1) @ tp.router, -1)
    gates2 = torch.softmax(tx2.reshape(48, -1) @ tp.router, -1)
    tape = TM.RouteTape()
    with tape.recording():
        got, _ = TM.moe_apply(tcfg, tp, tx)
    assert TM._TAPE is None
    assert torch.equal(got, TM.moe_apply(tcfg, tp, tx)[0])
    assert len(tape.routes) == 1
    assert torch.equal(tape.routes[0], TM.topk_route(tcfg, gates)[0])
    assert tape.stats[0]["capacity"] == TM.capacity(tcfg, 48, tcfg.n_experts)
    with tape.replaying():
        again, _ = TM.moe_apply(tcfg, tp, tx)
    assert torch.equal(again, got) and tape.flips == 0
    with tape.replaying():
        moved, _ = TM.moe_apply(tcfg, tp, tx2)
    taped = tape.routes[0]
    own = TM.topk_route(tcfg, gates2)[0]
    assert tape.flips == int((own != taped).any(-1).sum()) > 0
    w = np.take_along_axis(gates2.numpy(), taped.numpy().astype(np.int64), -1)
    w = w / w.sum(-1, keepdims=True)
    want = ref.moe.expert_compute(jcfg, jp, ref.jnp.asarray(x2),
                                  ref.jnp.asarray(taped.numpy().reshape(2, 24, -1)),
                                  ref.jnp.asarray(w.reshape(2, 24, -1)), 0, jcfg.n_experts,
                                  ref.moe.capacity(jcfg, 48, jcfg.n_experts))
    np.testing.assert_allclose(moved.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("router", ["topk", "ppot"])
@pytest.mark.parametrize("S", [1, 3])
def test_moe_rows_alone_match_the_vmapped_reference(ref, router, S):
    """``per_row=True`` on [B, S, d] equals the reference's layer mapped
    over the rows (each row a [1, S, d] call, the same key), which is how
    the reference's engine routes a decode step; at moonshot's routing a
    joint call (one capacity for all eight rows) drops tokens and
    differs."""
    jcfg, tcfg = _cfgs(ref, ARCHS[0], router=router, **WIDE)
    jp = ref.moe.init_moe(jcfg, ref.jax.random.PRNGKey(3))
    tp = _port_moe(tcfg, jp)
    x = np.random.RandomState(6 + S).randn(ROWS, S, jcfg.d_model).astype(np.float32)
    gates = ref.jax.nn.softmax(ref.jnp.asarray(x).reshape(ROWS * S, -1) @ jp["router"], -1)
    assert _gate_near_ties(gates, jcfg.top_k) == 0
    key = ref.jax.random.PRNGKey(0)
    if router == "ppot":
        for row in np.asarray(gates).reshape(ROWS, S, -1):
            assert _ppot_near_ties(ref, row, key, jcfg.top_k) == 0
    want = ref.jax.vmap(lambda xr: ref.moe.moe_apply(jcfg, jp, xr[None])[0][0])(
        ref.jnp.asarray(x))
    got, _ = TM.moe_apply(tcfg, tp, torch.from_numpy(x), per_row=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    joint_want, _ = ref.moe.moe_apply(jcfg, jp, ref.jnp.asarray(x))
    joint, _ = TM.moe_apply(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(joint.numpy(), np.asarray(joint_want), atol=TOL, rtol=TOL)
    assert np.abs(joint.numpy() - got.numpy()).max() > 1e-2


def test_capacity_and_config_fields(ref):
    for arch in ARCHS:
        jcfg, tcfg = ref.configs.get_config(arch), tconfigs.get_config(arch)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        for T in (1, 4, 16384):
            assert TM.capacity(tcfg, T, tcfg.n_experts) == ref.moe.capacity(jcfg, T,
                                                                            jcfg.n_experts)
    assert TM.capacity(tconfigs.get_config(ARCHS[0]), 1, 64) == 1


# ---------------------------------------------------------------------------
# benchmarks/moe_balance.py's settings
# ---------------------------------------------------------------------------


def test_normal_draws_match_jax(ref):
    """``prng.normal``: sqrt(2)·erfinv of JAX's uniform on (-1, 1); torch's
    erfinv against XLA's f32 polynomial, within 3e-5 (measured 2.2e-5 at
    |x| up to 5.1 over 8192 x 64 draws)."""
    from repro_torch.utils import prng

    for seed in (0, 1):
        want = np.asarray(ref.jax.random.normal(ref.jax.random.PRNGKey(seed), (8192, 64)))
        got = prng.normal(prng.PRNGKey(seed), (8192, 64)).numpy()
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)


def test_moe_balance_settings_match_reference(ref):
    """The benchmark's settings (T=8192, E=64, top-6, its skewed gates
    from ``PRNGKey(0)``, ppot under ``fold_in(key, 1)``): on the
    reference's gates the port's routes equal the reference's and so do
    the load statistics; on the port's own draws of the gates
    (``prng.normal``) the claim (ppot overflows less than top-k) holds and
    the overflows lie within 2e-3 of the reference's."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.utils import prng

    jax, jnp = ref.jax, ref.jnp
    T, E, k = 8192, 64, 6
    cfg = ModelConfig(arch="bench", family="moe", n_layers=1, d_model=64, n_heads=1,
                      n_kv_heads=1, d_head=64, d_ff=0, vocab=16, n_experts=E, top_k=k,
                      moe_dff=64, capacity_factor=1.25)
    key = jax.random.PRNGKey(0)
    jg = jax.nn.softmax(jax.random.normal(key, (T, E)) * 1.5 + jnp.linspace(2, 0, E)[None, :],
                        axis=-1)
    assert _ppot_near_ties(ref, np.asarray(jg), jax.random.fold_in(key, 1), k) == 0
    g = torch.from_numpy(np.array(jg))
    jcfg = ref.configs.get_config(ARCHS[0], n_experts=E, top_k=k)
    want = {"topk": ref.moe.topk_route(jcfg, jg)[0],
            "ppot": ref.moe.ppot_route(jcfg, jg, jax.random.fold_in(key, 1))[0]}
    routes = {"topk": TM.topk_route(cfg, g)[0],
              "ppot": TM.ppot_route(cfg, g, prng.fold_in(prng.PRNGKey(0), 1))[0]}
    derived = {}
    for name, idx in routes.items():
        assert np.array_equal(idx.numpy(), np.asarray(want[name])), name
        got = {kk: float(v) for kk, v in TM.expert_load_stats(cfg, g, idx).items()}
        derived[name] = {kk: float(v) for kk, v in
                         ref.moe.expert_load_stats(jcfg, jg, want[name]).items()}
        np.testing.assert_allclose([got[kk] for kk in sorted(got)],
                                   [derived[name][kk] for kk in sorted(got)], rtol=1e-6)
    assert derived["ppot"]["overflow_frac"] < derived["topk"]["overflow_frac"]
    tg = torch.softmax(prng.normal(prng.PRNGKey(0), (T, E)) * 1.5
                       + torch.linspace(2, 0, E)[None], -1)
    over = {name: float(TM.expert_load_stats(cfg, tg, route(tg))["overflow_frac"])
            for name, route in (("topk", lambda x: TM.topk_route(cfg, x)[0]),
                                ("ppot", lambda x: TM.ppot_route(
                                    cfg, x, prng.fold_in(prng.PRNGKey(0), 1))[0]))}
    assert over["ppot"] < over["topk"]
    np.testing.assert_allclose([over["topk"], over["ppot"]],
                               [derived["topk"]["overflow_frac"],
                                derived["ppot"]["overflow_frac"]], atol=2e-3)
