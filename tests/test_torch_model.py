"""The port's dense-family model (``repro_torch.models``) against the JAX
package's ``repro.models`` at reduced configs, in float32, on the same
parameters (carried across by ``convert.lm_params_from_numpy``).

``repro.models`` imports only on jax 0.9 with a shim: its compat module
asks ``prim in batching.primitive_batchers`` of a proxy that has no
``__contains__``. ``reference_shim`` gives the proxy one while the ``ref``
fixture imports the reference, and at the fixture's end takes the shim
away again together with every ``repro`` module imported under it, so
that no other test file sees them; nothing of it runs while the test
files are collected.

Tolerance of the logits: atol = rtol = 2e-5 (f32; matmul reduction order,
rsqrt and sin/cos differ by ulps between XLA and torch; measured up to
3e-6 on logits of size ~3)."""
import contextlib
import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL

TOL = 2e-5
ARCHS = ["smollm-360m", "qwen3-32b", "chatglm3-6b"]


@contextlib.contextmanager
def reference_shim():
    """Give jax 0.9's ``PrimitiveBatchersProxy`` the ``__contains__`` that
    ``repro.utils.jax_compat`` needs at import. On exit take it away and
    drop from ``sys.modules`` (and from their parent packages) the
    ``repro`` modules imported inside, so that a JAX-package test importing
    ``repro.models`` later fails as it does on its own, whichever test
    files ran before it on the same process."""
    from jax._src.interpreters import batching

    proxy = batching.PrimitiveBatchersProxy
    had = "__contains__" in vars(proxy)
    before = set(sys.modules)
    if not had:
        proxy.__contains__ = lambda self, prim: prim in batching.fancy_primitive_batchers
    try:
        yield
    finally:
        if not had:
            del proxy.__contains__
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name == "repro" or name.startswith("repro."):
                mod = sys.modules.pop(name)
                parent, _, child = name.rpartition(".")
                if getattr(sys.modules.get(parent), child, None) is mod:
                    delattr(sys.modules[parent], child)


@pytest.fixture(scope="module")
def ref():
    with reference_shim():
        import jax
        import jax.numpy as jnp

        from repro import configs
        from repro.models import api, layers

        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs, api=api,
                                    layers=layers)


def flat(jax, tree) -> dict:
    """A pytree as numpy arrays under dotted key paths."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[name] = np.asarray(leaf)
    return out


def _pair(ref, arch, **over):
    jcfg = ref.configs.reduced(ref.configs.get_config(arch), **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), **over)
    params = ref.api.init_params(jcfg, ref.jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(tcfg, flat(ref.jax, params), "cpu")
    return jcfg, tcfg, params, model


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-32b", "glm4-9b", "chatglm3-6b",
                                  "mamba2-370m", "hymba-1.5b"])
def test_configs_carry_across_field_for_field(ref, arch):
    j, t = ref.configs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.num_params() == j.num_params()
    assert dataclasses.asdict(ref.configs.reduced(j)) == dataclasses.asdict(
        tconfigs.reduced(t))
    for shape in ref.configs.SHAPES:
        assert ref.configs.shape_applicable(j, shape) == tconfigs.shape_applicable(t, shape)
        assert dataclasses.asdict(ref.configs.SHAPES[shape]) == dataclasses.asdict(
            tconfigs.SHAPES[shape])


@pytest.mark.parametrize("arch", sorted(tconfigs.NOT_PORTED))
def test_families_not_ported_raise(ref, arch):
    assert ref.configs.get_config(arch).family == tconfigs.NOT_PORTED[arch][0]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tconfigs.get_config(arch)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_params_have_the_reference_tree(ref):
    """Every parameter of the port has the reference's leaf, shape and
    dtype; seeds are deterministic and distinct."""
    jcfg = ref.configs.reduced(ref.configs.get_config("qwen3-32b"), scan_layers=False)
    tcfg = tconfigs.reduced(tconfigs.get_config("qwen3-32b"))
    leaves = flat(ref.jax, ref.api.init_params(jcfg, ref.jax.random.PRNGKey(0)))
    model = tapi.init_params(tcfg, 0, "cpu")
    names = dict(model.named_parameters())
    assert set(names) == set(leaves)
    for name, p in names.items():
        assert tuple(p.shape) == leaves[name].shape and not p.requires_grad
    again = tapi.init_params(tcfg, 0, "cpu")
    other = tapi.init_params(tcfg, 1, "cpu")
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), again.parameters()))
    assert not torch.equal(model.embed, other.embed)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [16, 2048])
@pytest.mark.parametrize("pallas", [False, True])
def test_prefill_matches_reference(ref, arch, S, pallas):
    """S=16 takes the plain path, S=2048 the chunked one. The reference
    runs ``use_pallas=False`` (``flash_attention_xla``, layers scanned)
    and ``use_pallas=True, scan_layers=False`` (the Pallas kernel in
    interpret mode; under the layer scan it cannot derive its q offset)."""
    jcfg, tcfg, params, model = _pair(ref, arch, use_pallas=pallas,
                                      scan_layers=not pallas)
    toks = np.random.RandomState(S).randint(0, jcfg.vocab, (2, S)).astype(np.int32)
    want = np.asarray(ref.api.prefill(jcfg, params, {"tokens": ref.jnp.asarray(toks)}))
    got = tapi.prefill(tcfg, model, {"tokens": toks})
    assert got.shape == (2, 1, jcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(ref, arch):
    """8 decode_fn steps from an empty cache: logits and the cache."""
    jcfg, tcfg, params, model = _pair(ref, arch)
    jcache = ref.api.init_cache(jcfg, 2, 16)
    tcache = tapi.init_cache(tcfg, 2, 16, "cpu")
    rng = np.random.RandomState(1)
    for t in range(8):
        tok = rng.randint(0, jcfg.vocab, (2, 1)).astype(np.int32)
        want, jcache = ref.api.decode_fn(
            jcfg, params, {"tokens": ref.jnp.asarray(tok), "pos": ref.jnp.int32(t)}, jcache)
        got, tcache = tapi.decode_fn(tcfg, model, {"tokens": tok, "pos": t}, tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    conv = convert.lm_cache_from_numpy(tcfg, flat(ref.jax, jcache), "cpu")
    for c, t in zip(conv, tcache):
        assert set(c) == set(t) == {"attn"}  # nested as the reference's layer cache
        c, t = c["attn"], t["attn"]
        assert c["len"].tolist() == t["len"].tolist() == [8, 8]
        for key in ("k", "v"):
            np.testing.assert_allclose(c[key].numpy(), t[key].numpy(), atol=TOL, rtol=TOL)


def test_decode_continues_from_a_converted_cache(ref):
    """Prefill 5 tokens into the reference cache, carry it across, and
    decode 3 more steps in both packages (stacked and per-layer leaves)."""
    for scan in (True, False):
        jcfg, tcfg, params, model = _pair(ref, "smollm-360m", scan_layers=scan)
        jcache = ref.api.init_cache(jcfg, 1, 12)
        rng = np.random.RandomState(2)
        for t in range(5):
            tok = ref.jnp.asarray(rng.randint(0, jcfg.vocab, (1, 1)), ref.jnp.int32)
            _, jcache = ref.api.decode_fn(jcfg, params, {"tokens": tok, "pos": ref.jnp.int32(t)},
                                          jcache)
        tcache = convert.lm_cache_from_numpy(tcfg, flat(ref.jax, jcache), "cpu")
        for t in range(5, 8):
            tok = rng.randint(0, jcfg.vocab, (1, 1)).astype(np.int32)
            want, jcache = ref.api.decode_fn(
                jcfg, params, {"tokens": ref.jnp.asarray(tok), "pos": ref.jnp.int32(t)}, jcache)
            got, tcache = tapi.decode_fn(tcfg, model, {"tokens": tok, "pos": t}, tcache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_converter_refuses_foreign_or_misshapen_leaves(ref):
    jcfg, tcfg, params, _ = _pair(ref, "smollm-360m")
    tree = flat(ref.jax, params)
    with pytest.raises(ValueError, match="no place"):
        convert.lm_params_from_numpy(tcfg, dict(tree, **{"layers.moe.router": tree["embed"]}),
                                     "cpu")
    bad = dict(tree)
    bad["embed"] = bad["embed"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_numpy(tcfg, bad, "cpu")


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


def test_chunked_plain_path_matches_flash_attention_xla(ref):
    """``layers.flash_attention_plain`` (GQA, window) against the
    reference's ``flash_attention_xla`` on repeated kv heads."""
    rng = np.random.RandomState(4)
    q = rng.randn(2, 256, 6, 32).astype(np.float32)
    k, v = (rng.randn(2, 256, 2, 32).astype(np.float32) for _ in range(2))
    pos = ref.jnp.arange(256)
    rep = lambda x: ref.jnp.repeat(ref.jnp.asarray(x), 3, axis=2)  # noqa: E731
    for window in (0, 40):
        want = ref.layers.flash_attention_xla(ref.jnp.asarray(q), rep(k), rep(v), pos, pos,
                                              True, window, 64)
        got = TL.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), window=window,
                                       chunk=64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_norm_and_mlp_match_reference(ref, norm, act):
    jcfg = ref.configs.reduced(ref.configs.get_config("smollm-360m"), norm=norm, act=act)
    tcfg = tconfigs.reduced(tconfigs.get_config("smollm-360m"), norm=norm, act=act)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 64).astype(np.float32)
    jn = ref.layers.init_norm(jcfg)
    jn = {k: ref.jnp.asarray(rng.randn(*a.shape).astype(np.float32)) for k, a in jn.items()}
    tn = TL.init_norm(tcfg)
    for k, a in jn.items():
        getattr(tn, k).data.copy_(torch.from_numpy(np.array(a)))
    np.testing.assert_allclose(TL.norm_apply(tcfg, tn, torch.from_numpy(x)).numpy(),
                               np.asarray(ref.layers.norm_apply(jcfg, jn, ref.jnp.asarray(x))),
                               atol=TOL, rtol=TOL)
    jm = ref.layers.init_mlp(jcfg, ref.jax.random.PRNGKey(3))
    tm = TL.init_mlp(tcfg, torch.Generator().manual_seed(0))
    for k, a in jm.items():
        getattr(tm, k).data.copy_(torch.from_numpy(np.array(a)))
    np.testing.assert_allclose(TL.mlp_apply(tcfg, tm, torch.from_numpy(x)).numpy(),
                               np.asarray(ref.layers.mlp_apply(jcfg, jm, ref.jnp.asarray(x))),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ["smollm-360m", "chatglm3-6b"])
def test_rope_and_head_norm_match_reference(ref, arch):
    """neox rope over all of the head dim (smollm) and over half of it
    (chatglm), at shared and per-row positions; qwen3's head RMSNorm."""
    jcfg, tcfg = ref.configs.get_config(arch), tconfigs.get_config(arch)
    rng = np.random.RandomState(8)
    x = rng.randn(3, 7, 4, 128).astype(np.float32)
    pos = rng.randint(0, 5000, (3, 7))
    for p in (pos[0], pos):
        want = ref.layers.apply_rope(jcfg, ref.jnp.asarray(x), ref.jnp.asarray(p))
        got = TL.apply_rope(tcfg, torch.from_numpy(x), torch.from_numpy(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    scale = rng.randn(128).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_head_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6).numpy(),
        np.asarray(ref.layers.rms_head_norm(ref.jnp.asarray(x), ref.jnp.asarray(scale), 1e-6)),
        atol=TOL, rtol=TOL)


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = tconfigs.reduced(tconfigs.get_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init_cache(cfg, 1, 8, "cuda")


@pytest.mark.parametrize("S", [16, 2048])
def test_prefill_positions_as_p0_and_the_chunked_path_refuses_a_tensor(S):
    """Without a cache, attention takes its positions as the host integer
    p0 (contiguous by construction: ``p0 + arange(S)``), equal to passing
    that range as a tensor where the plain path checks nothing (S < 2048).
    The chunked path (S >= 2048) assumes contiguous positions and cannot
    read a tensor back from the device to check them, so a tensor, here a
    non-contiguous one, raises there."""
    cfg = tconfigs.reduced(tconfigs.get_config("smollm-360m"))
    model = tapi.init_params(cfg, 0, "cpu")
    x = torch.from_numpy(np.random.RandomState(S).randn(1, S, cfg.d_model)
                         .astype(np.float32))
    attn = model.layers[0].attn
    got, _ = TL.attention_apply(cfg, attn, x, positions=3)
    gaps = torch.arange(S) * 2  # not contiguous
    if S < 2048:
        want, _ = TL.attention_apply(cfg, attn, x, positions=3 + torch.arange(S))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        TL.attention_apply(cfg, attn, x, positions=gaps)  # the plain path takes any
    else:
        assert torch.isfinite(got).all()
        for pos in (gaps, torch.arange(S)):
            with pytest.raises(ValueError, match="contiguous"):
                TL.attention_apply(cfg, attn, x, positions=pos)
