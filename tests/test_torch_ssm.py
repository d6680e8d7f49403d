"""The port's SSM and hybrid families (``repro_torch.models.ssm`` and the
``ssm`` / ``hybrid`` layers of ``models.lm``) against the JAX package's
``repro.models`` at reduced mamba2-370m and hymba-1.5b, in float32, on the
same parameters (carried across by ``convert.lm_params_from_numpy``).

The leaves that init to constants (``A_log``, ``dt_bias``, ``D``,
``norm_scale``, the conv biases: zeros and ones) are set from the seed,
so that a swapped head or leaf shows.

``repro.models`` imports only under the jax-0.9 shim of the ``ref``
fixture (see tests/test_torch_model.py).

Tolerance: atol = rtol = 2e-5 on logits and states, the dense family's
bar (f32; matmul reduction order, exp, softplus and rsqrt differ by ulps
between XLA and torch)."""
import types

import numpy as np
import pytest
import torch
from test_torch_model import reference_shim

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels.ssd_scan import ops as tops
from repro_torch.kernels.ssd_scan import ref as tref
from repro_torch.models import api as tapi
from repro_torch.models import ssm as TS

TOL = 2e-5
ARCHS = ["mamba2-370m", "hymba-1.5b"]
# leaves whose init is a constant: drawn from the seed instead
CONST_LEAVES = ("A_log", "dt_bias", "D", "norm_scale", "conv_bx", "conv_bbc")


@pytest.fixture(scope="module")
def ref():
    with reference_shim():
        import jax
        import jax.numpy as jnp

        from repro import configs
        from repro.models import api, ssm

        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs, api=api, ssm=ssm)


def _name(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def flat(jax, tree) -> dict:
    return {_name(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _seeded(ref, tree, seed, mamba2_decays=False):
    """``tree`` with every constant-initialised SSM leaf drawn from the
    seed: A_log, dt_bias ~ 0.5 N(0, 1), D, norm_scale ~ 1 + 0.3 N(0, 1),
    conv biases ~ 0.2 N(0, 1). With ``mamba2_decays``, A_log and dt_bias
    are drawn as Mamba2 draws them (``ssd_scan.ref.mamba2_decays``), under
    which the state reaches across chunks."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)

    def draw(path, leaf):
        last = _name(path).split(".")[-1]
        if last not in CONST_LEAVES or ".ssm." not in f".{_name(path)}":
            return leaf
        z = rng.randn(*leaf.shape).astype(np.float32)
        v = {"A_log": 0.5 * z, "dt_bias": 0.5 * z, "D": 1 + 0.3 * z,
             "norm_scale": 1 + 0.3 * z}.get(last, 0.2 * z)
        if mamba2_decays and last in ("A_log", "dt_bias"):
            A_log, dt_bias = tref.mamba2_decays(leaf.size, gen)
            v = (A_log if last == "A_log" else dt_bias).numpy().reshape(leaf.shape)
        return ref.jnp.asarray(v).astype(leaf.dtype)

    return ref.jax.tree_util.tree_map_with_path(draw, tree)


def _pair(ref, arch, seed=0, mamba2_decays=False, **over):
    jcfg = ref.configs.reduced(ref.configs.get_config(arch), **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), **over)
    params = _seeded(ref, ref.api.init_params(jcfg, ref.jax.random.PRNGKey(seed)), seed + 1,
                     mamba2_decays)
    model = convert.lm_params_from_numpy(tcfg, flat(ref.jax, params), "cpu")
    return jcfg, tcfg, params, model


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the SSM block's parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(ref, with_state):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 12).astype(np.float32)
    w = rng.randn(4, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    st = rng.randn(2, 3, 12).astype(np.float32) if with_state else None
    jst = None if st is None else ref.jnp.asarray(st)
    want_y, want_s = ref.ssm._causal_conv(*map(ref.jnp.asarray, (x, w, b)), jst)
    got_y, got_s = TS._causal_conv(*map(torch.from_numpy, (x, w, b)),
                                   None if st is None else torch.from_numpy(st))
    _close(got_y, want_y)
    _close(got_s, want_s)


def test_ssd_decode_step_matches_reference(ref):
    rng = np.random.RandomState(4)
    B, H, P, N = 3, 4, 8, 6
    x = rng.randn(B, 1, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, 1, H))).astype(np.float32)
    A = (-np.exp(rng.randn(H) * 0.3)).astype(np.float32)
    Bm, Cm = (rng.randn(B, 1, N).astype(np.float32) for _ in range(2))
    h = rng.randn(B, H, N, P).astype(np.float32)
    want = ref.ssm.ssd_decode_step(*map(ref.jnp.asarray, (x, dt, A, Bm, Cm, h)))
    got = TS.ssd_decode_step(*map(torch.from_numpy, (x, dt, A, Bm, Cm, h)))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [1, 48, 64])
def test_ssm_apply_matches_reference(ref, arch, S):
    """Without a cache at S in {1, 48 (gcd chunk 16), 64 (two chunks)};
    with a cache (decode, S=1) from a random state, whose input is left
    unchanged. Several tokens into a cache raise."""
    jcfg, tcfg, params, model = _pair(ref, arch, scan_layers=False)
    jp = params["layers"][0]["ssm"]
    tp = model.layers[0].ssm
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, jcfg.d_model).astype(np.float32)
    want, _ = ref.ssm.ssm_apply(jcfg, jp, ref.jnp.asarray(x))
    got, none = TS.ssm_apply(tcfg, tp, torch.from_numpy(x))
    assert none is None
    _close(got, want)
    if S != 1:
        with pytest.raises(NotImplementedError, match="ROADMAP A"):
            TS.ssm_apply(tcfg, tp, torch.from_numpy(x), cache=TS.init_ssm_cache(tcfg, 2, "cpu"))
        return
    tcache = TS.init_ssm_cache(tcfg, 2, "cpu")
    for key in tcache:
        tcache[key] = torch.from_numpy(rng.randn(*tcache[key].shape).astype(np.float32))
    before = {k: v.clone() for k, v in tcache.items()}
    jcache = {k: ref.jnp.asarray(v.numpy()) for k, v in tcache.items()}
    want, wc = ref.ssm.ssm_apply(jcfg, jp, ref.jnp.asarray(x), cache=jcache)
    got, gc = TS.ssm_apply(tcfg, tp, torch.from_numpy(x), cache=tcache)
    _close(got, want)
    for key in ("conv_x", "conv_bc", "h"):
        _close(gc[key], wc[key])
        assert torch.equal(tcache[key], before[key])


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_have_the_reference_tree(ref, arch):
    """Every parameter of the port has the reference's leaf, shape and
    dtype (the configs themselves: tests/test_torch_model.py)."""
    j, t = ref.configs.get_config(arch), tconfigs.get_config(arch)
    model = tapi.init_params(tconfigs.reduced(t), 0, "cpu")
    leaves = flat(ref.jax, ref.api.init_params(
        ref.configs.reduced(j, scan_layers=False), ref.jax.random.PRNGKey(0)))
    names = dict(model.named_parameters())
    assert set(names) == set(leaves)
    for name, p in names.items():
        assert tuple(p.shape) == leaves[name].shape
        assert str(p.dtype).split(".")[-1] == str(leaves[name].dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,scan", [(48, True), (48, False), (2048, True)])
def test_prefill_matches_reference(ref, arch, scan, S):
    """S=48 runs three gcd chunks of 16 (and hymba's plain attention under
    its window of 32), stacked and per-layer parameters; S=2048 runs 64
    chunks (and hymba's chunked attention)."""
    jcfg, tcfg, params, model = _pair(ref, arch, scan_layers=scan)
    toks = np.random.RandomState(S).randint(0, jcfg.vocab, (2, S)).astype(np.int32)
    want = ref.api.prefill(jcfg, params, {"tokens": ref.jnp.asarray(toks)})
    got = tapi.prefill(tcfg, model, {"tokens": toks})
    assert got.shape == (2, 1, jcfg.vocab) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_mamba2_decays_holds_the_carry(ref, arch, monkeypatch):
    """A_log and dt_bias drawn as Mamba2 draws them, S=2048 (64 chunks):
    the prefill matches the reference's, and the same prefill with the
    chunk carry left out (``ref.without_carry``, a planted fault) does not,
    by far more than the bar."""
    jcfg, tcfg, params, model = _pair(ref, arch, mamba2_decays=True)
    toks = np.random.RandomState(5).randint(0, jcfg.vocab, (2, 2048)).astype(np.int32)
    want = np.asarray(ref.api.prefill(jcfg, params, {"tokens": ref.jnp.asarray(toks)}))
    _close(tapi.prefill(tcfg, model, {"tokens": toks}), want)
    monkeypatch.setattr(TS, "ssd_prefill", lambda cfg, x, *a: tref.without_carry(
        tops.ssd, x, *a, chunk=tops.pick_chunk(x.shape[1], cfg.ssm_chunk)))
    faulty = tapi.prefill(tcfg, model, {"tokens": toks}).numpy()
    assert np.abs(faulty - want).max() > 100 * TOL


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scan", [True, False])
def test_decode_steps_match_reference(ref, arch, scan):
    """8 decode_fn steps from an empty cache: logits every step, then the
    reference's cache carried across equals the port's; a decode leaves
    its input cache unchanged."""
    jcfg, tcfg, params, model = _pair(ref, arch, scan_layers=scan)
    jcache = ref.api.init_cache(jcfg, 2, 16)
    tcache = tapi.init_cache(tcfg, 2, 16, "cpu")
    rng = np.random.RandomState(1)
    for t in range(8):
        tok = rng.randint(0, jcfg.vocab, (2, 1)).astype(np.int32)
        want, jcache = ref.api.decode_fn(
            jcfg, params, {"tokens": ref.jnp.asarray(tok), "pos": ref.jnp.int32(t)}, jcache)
        before = [{p: {k: v.clone() for k, v in c.items()} for p, c in layer.items()}
                  for layer in tcache]
        got, new = tapi.decode_fn(tcfg, model, {"tokens": tok, "pos": t}, tcache)
        for old, kept in zip(tcache, before):
            for part in old:
                for key in old[part]:
                    assert torch.equal(old[part][key], kept[part][key]), (part, key)
        tcache = new
        _close(got, want)
    conv = convert.lm_cache_from_numpy(tcfg, flat(ref.jax, jcache), "cpu")
    assert [set(c) for c in conv] == [set(c) for c in tcache]
    for c, t in zip(conv, tcache):
        for part in t:
            for key in t[part]:
                if key == "len":
                    assert c[part][key].tolist() == t[part][key].tolist() == [8, 8]
                else:
                    _close(t[part][key], c[part][key].numpy())


def test_decode_continues_from_a_converted_cache(ref):
    """Decode 5 tokens in the reference, carry its cache across (stacked and
    per-layer leaves), and decode 3 more in both packages."""
    for arch in ARCHS:
        for scan in (True, False):
            jcfg, tcfg, params, model = _pair(ref, arch, scan_layers=scan)
            jcache = ref.api.init_cache(jcfg, 1, 12)
            rng = np.random.RandomState(2)
            for t in range(5):
                tok = ref.jnp.asarray(rng.randint(0, jcfg.vocab, (1, 1)), ref.jnp.int32)
                _, jcache = ref.api.decode_fn(jcfg, params,
                                              {"tokens": tok, "pos": ref.jnp.int32(t)}, jcache)
            tcache = convert.lm_cache_from_numpy(tcfg, flat(ref.jax, jcache), "cpu")
            for t in range(5, 8):
                tok = rng.randint(0, jcfg.vocab, (1, 1)).astype(np.int32)
                want, jcache = ref.api.decode_fn(
                    jcfg, params, {"tokens": ref.jnp.asarray(tok), "pos": ref.jnp.int32(t)},
                    jcache)
                got, tcache = tapi.decode_fn(tcfg, model, {"tokens": tok, "pos": t}, tcache)
                _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_converters_refuse_missing_or_foreign_leaves(ref, arch):
    jcfg, tcfg, params, _ = _pair(ref, arch)
    tree = flat(ref.jax, params)
    with pytest.raises(ValueError, match="no place"):
        convert.lm_params_from_numpy(tcfg, dict(tree, **{"layers.ssm.A": tree["embed"]}),
                                     "cpu")
    with pytest.raises(KeyError):
        convert.lm_params_from_numpy(
            tcfg, {k: v for k, v in tree.items() if k != "layers.ssm.dt_bias"}, "cpu")
    cache = flat(ref.jax, ref.api.init_cache(jcfg, 1, 8))
    assert len(convert.lm_cache_from_numpy(tcfg, cache, "cpu")) == tcfg.n_layers
    with pytest.raises(ValueError, match="no place"):
        convert.lm_cache_from_numpy(tcfg, dict(cache, **{"layers.ssm.state": cache[
            "layers.ssm.h"]}), "cpu")
    with pytest.raises(KeyError):
        convert.lm_cache_from_numpy(
            tcfg, {k: v for k, v in cache.items() if k != "layers.ssm.conv_bc"}, "cpu")
    bad = dict(cache)
    bad["layers.ssm.h"] = bad["layers.ssm.h"][..., :4]
    with pytest.raises(ValueError, match="ssm.h"):
        convert.lm_cache_from_numpy(tcfg, bad, "cpu")
