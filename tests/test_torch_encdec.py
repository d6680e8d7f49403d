"""The port's encoder-decoder family (``repro_torch.models.encdec``,
whisper-medium) against the JAX package's ``repro.models.encdec`` at the
reduced config, in float32, on the same parameters (carried across by
``convert.encdec_params_from_numpy``), and ``layers.sincos_positions`` and
cross attention against ``repro.models.layers``.

Tolerances: atol = rtol = 2e-5 on hidden states, logits and caches, as
``tests/test_torch_model.py`` (reduction order, rsqrt, erf-free tanh GELU
and exp differ by ulps between XLA and torch). ``sincos_positions``:
atol 2e-4 at length 1500 (the angle pos / 10000^(2i/d) reaches 1500
rad, where an ulp of ``pow`` moves it by ~1e-4 and its sine with it;
measured 3.1e-5), 1e-6 at length 32 (measured 6.0e-8).
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import re
import types

import numpy as np
import pytest
import torch
from test_torch_model import flat, reference_shim

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import api as tapi
from repro_torch.models import encdec as TED
from repro_torch.models import layers as TL

TOL = 2e-5
ARCH = "whisper-medium"


@pytest.fixture(scope="module")
def ref():
    with reference_shim():
        import jax
        import jax.numpy as jnp

        from repro import configs
        from repro.models import api, encdec, layers

        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs, api=api, ed=encdec,
                                    layers=layers)


def _pair(ref, **over):
    jcfg = ref.configs.reduced(ref.configs.get_config(ARCH), **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(ARCH), **over)
    params = ref.api.init_params(jcfg, ref.jax.random.PRNGKey(0))
    model = convert.encdec_params_from_numpy(tcfg, flat(ref.jax, params), "cpu")
    return jcfg, tcfg, params, model


def _frames(cfg, B=2, seed=0):
    return np.random.RandomState(seed).randn(B, cfg.enc_len, cfg.d_model).astype(np.float32)


@pytest.mark.parametrize("d,length,atol", [(64, 32, 1e-6), (1024, 1500, 2e-4)])
def test_sincos_positions_match_reference(ref, d, length, atol):
    want = np.asarray(ref.layers.sincos_positions(d, length))
    got = TL.sincos_positions(d, length)
    assert got.shape == (length, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_params_have_the_reference_tree(ref):
    jcfg, tcfg, params, model = _pair(ref)
    leaves = flat(ref.jax, params)
    names = dict(model.named_parameters())
    stacked = {re.sub(r"^(\w+)\.\d+\.", r"\1.", n) for n in names}  # the [L, ...] leaves
    assert stacked == set(leaves)
    assert names["dec_pos"].shape == (TED.DEC_POSITIONS, tcfg.d_model)
    with pytest.raises(ValueError, match="no place"):
        convert.encdec_params_from_numpy(tcfg, dict(leaves, **{"layers.moe.router":
                                                               leaves["embed"]}), "cpu")


@pytest.mark.parametrize("enc_len", [32, 2048])
def test_encode_matches_reference(ref, enc_len):
    """enc_len 32 takes the plain attention path, 2048 the chunked one,
    non-causal."""
    jcfg, tcfg, params, model = _pair(ref, enc_len=enc_len)
    x = _frames(jcfg)
    want = np.asarray(ref.ed.encode(jcfg, params, ref.jnp.asarray(x)))
    got = TED.encode(tcfg, model, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_decode_and_prefill_match_reference(ref):
    """The decoder over 12 tokens without a cache (learned positions,
    causal self-attention, cross attention to the encoder), and
    ``api.prefill``'s last-position logits."""
    jcfg, tcfg, params, model = _pair(ref)
    x = _frames(jcfg, seed=1)
    toks = np.random.RandomState(2).randint(0, jcfg.vocab, (2, 12)).astype(np.int32)
    enc = ref.ed.encode(jcfg, params, ref.jnp.asarray(x))
    want, _ = ref.ed.decode(jcfg, params, ref.jnp.asarray(toks), enc)
    got, cache = TED.decode(tcfg, model, torch.from_numpy(toks),
                            torch.from_numpy(np.array(enc)))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    b = {"tokens": toks, "frame_embeds": x}
    want = ref.api.prefill(jcfg, params, {k: ref.jnp.asarray(v) for k, v in b.items()})
    got = tapi.prefill(tcfg, model, b)
    assert got.shape == (2, 1, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_cached_decode_fn_matches_reference(ref):
    """8 ``decode_fn`` steps with the self-attention cache and ``enc_out``;
    the reference's cache carried across equals the port's, and 3 more
    steps from it agree."""
    jcfg, tcfg, params, model = _pair(ref)
    enc = ref.ed.encode(jcfg, params, ref.jnp.asarray(_frames(jcfg, seed=3)))
    tenc = torch.from_numpy(np.array(enc))
    jcache = ref.api.init_cache(jcfg, 2, 16)
    tcache = tapi.init_cache(tcfg, 2, 16, "cpu")
    rng = np.random.RandomState(4)
    for t in range(8):
        tok = rng.randint(0, jcfg.vocab, (2, 1)).astype(np.int32)
        want, jcache = ref.api.decode_fn(jcfg, params, {"tokens": ref.jnp.asarray(tok),
                                                        "pos": ref.jnp.int32(t),
                                                        "enc_out": enc}, jcache)
        got, tcache = tapi.decode_fn(tcfg, model, {"tokens": tok, "pos": t, "enc_out": tenc},
                                     tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    conv = convert.encdec_cache_from_numpy(tcfg, flat(ref.jax, jcache), "cpu")
    assert len(conv) == len(tcache) == jcfg.n_layers
    for c, t in zip(conv, tcache):
        assert c["len"].tolist() == t["len"].tolist() == [8, 8]
        for key in ("k", "v"):
            np.testing.assert_allclose(c[key].numpy(), t[key].numpy(), atol=TOL, rtol=TOL)
    for t in range(8, 11):
        tok = rng.randint(0, jcfg.vocab, (2, 1)).astype(np.int32)
        want, jcache = ref.api.decode_fn(jcfg, params, {"tokens": ref.jnp.asarray(tok),
                                                        "pos": ref.jnp.int32(t),
                                                        "enc_out": enc}, jcache)
        got, conv = tapi.decode_fn(tcfg, model, {"tokens": tok, "pos": t, "enc_out": tenc},
                                   conv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("Skv", [40, 2048])
def test_cross_attention_matches_reference(ref, Skv):
    """``attention_apply(kv_x=...)``: k and v from the other sequence, no
    rope, non-causal; Skv 2048 takes the chunked path although S is 4."""
    jcfg = ref.configs.reduced(ref.configs.get_config("smollm-360m"))
    tcfg = tconfigs.reduced(tconfigs.get_config("smollm-360m"))
    jp = ref.layers.init_attention(jcfg, ref.jax.random.PRNGKey(1), cross=True)
    tp = TL.init_attention(tcfg, torch.Generator().manual_seed(0), cross=True)
    for k, a in jp.items():
        getattr(tp, k).data.copy_(torch.from_numpy(np.array(a)))
    rng = np.random.RandomState(Skv)
    x = rng.randn(2, 4, jcfg.d_model).astype(np.float32)
    kv = rng.randn(2, Skv, jcfg.d_model).astype(np.float32)
    want, _ = ref.layers.attention_apply(jcfg, jp, ref.jnp.asarray(x),
                                         positions=ref.jnp.arange(4) + 7, causal=False,
                                         kv_x=ref.jnp.asarray(kv),
                                         kv_positions=ref.jnp.arange(Skv))
    got, _ = TL.attention_apply(tcfg, tp, torch.from_numpy(x),
                                positions=7 + torch.arange(4), causal=False,
                                kv_x=torch.from_numpy(kv), kv_positions=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
