"""The port's MoE (moonshot-v1-16b-a3b, phi3.5-moe) and VLM (pixtral-12b)
families and the int8 ``kv_quant`` cache against the JAX package at
reduced configs, in float32, on the same parameters (carried across by
``convert.lm_params_from_numpy``).

Tolerances:
  * logits: atol = rtol = 2e-5, as ``tests/test_torch_model.py`` (matmul
    reduction order, rsqrt and sin/cos differ by ulps between XLA and
    torch). An MoE token whose k-th and (k+1)-th gates lie within
    GATE_ULPS could take another expert in the other package; the gates of
    every MoE layer are recorded on the port's side, and on these inputs
    no token is that close (counted: 0).
  * greedy tokens of the engine: equal to the reference engine's, up to a
    step whose reference top-2 logits lie within NEAR_TIE
    (``tests/test_torch_engine.py``); the test names any such step.
  * the int8 cache: the quantized values of the two packages within 1 (a
    value at a rounding midpoint may round either way after an ulp of
    difference in k or v), the bf16 scales within one bf16 ulp (2^-7
    relative), and the logits within KVQ_TOL; against the full-precision
    forward, within 5% of the largest |logit|, the bar of
    ``tests/test_arch_smoke.py::test_int8_kv_cache_decode_close_to_fp``.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import dataclasses
import types

import numpy as np
import pytest
import torch
from test_torch_engine import _check_tokens, _schedule
from test_torch_model import flat, reference_shim

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TM
from repro_torch.serving.engine import ContinuousBatchingEngine

TOL = 2e-5
KVQ_TOL = 1e-4
GATE_ULPS = 8
ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "pixtral-12b"]
NEW_ARCHS = ARCHS + ["whisper-medium"]
#: moonshot's routing (64 experts, top-6, 2 shared) at reduced widths
WIDE = dict(n_experts=64, top_k=6, n_shared=2, moe_dff=16)


@pytest.fixture(scope="module")
def ref():
    with reference_shim():
        import jax
        import jax.numpy as jnp

        from repro import configs
        from repro.models import api, lm
        from repro.serving import engine

        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs, api=api, lm=lm,
                                    engine=engine)


def _pair(ref, arch, **over):
    jcfg = ref.configs.reduced(ref.configs.get_config(arch), **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), **over)
    params = ref.api.init_params(jcfg, ref.jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(tcfg, flat(ref.jax, params), "cpu")
    return jcfg, tcfg, params, model


@pytest.fixture
def gate_record(monkeypatch):
    """Every MoE layer's gates as the port computes them."""
    seen = []
    orig = TM.moe_apply

    def recording(cfg, p, x, **kw):
        seen.append((cfg.top_k, torch.softmax(x.float() @ p.router, -1).reshape(
            -1, cfg.n_experts).numpy()))
        return orig(cfg, p, x, **kw)

    monkeypatch.setattr(TLM.MOE, "moe_apply", recording)
    return seen


def _gate_near_ties(seen) -> int:
    n = 0
    for k, g in seen:
        s = np.sort(g, -1)[:, ::-1]
        a = s[:, k - 1].view(np.int32).astype(np.int64)
        b = s[:, k].view(np.int32).astype(np.int64)
        n += int((np.abs(a - b) <= GATE_ULPS).sum())
    return n


def _batch(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.randn(B, cfg.n_patches, cfg.d_model).astype(np.float32)
    return b


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_carry_across_field_for_field(ref, arch):
    j, t = ref.configs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.num_params() == j.num_params() and t.active_params() == j.active_params()
    assert dataclasses.asdict(ref.configs.reduced(j)) == dataclasses.asdict(
        tconfigs.reduced(t))
    assert tconfigs.ARCHS == ref.configs.ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_params_have_the_reference_tree(ref, arch):
    """Every parameter of the port has the reference's leaf (per layer,
    the prefix layers and the stacked experts' [E, ...] leaves included),
    shape and dtype (the router f32)."""
    jcfg = ref.configs.reduced(ref.configs.get_config(arch), scan_layers=False)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    leaves = flat(ref.jax, ref.api.init_params(jcfg, ref.jax.random.PRNGKey(0)))
    names = dict(tapi.init_params(tcfg, 0, "cpu").named_parameters())
    assert set(names) == set(leaves)
    for name, p in names.items():
        assert tuple(p.shape) == leaves[name].shape
        assert str(p.dtype).split(".")[1] == str(leaves[name].dtype)
    if tcfg.family == "moe":
        assert names["layers.0.moe.wg"].shape == (tcfg.n_experts, tcfg.d_model, tcfg.moe_dff)


def test_converter_refuses_foreign_or_misshapen_moe_leaves(ref):
    jcfg, tcfg, params, _ = _pair(ref, ARCHS[0])
    tree = flat(ref.jax, params)
    with pytest.raises(ValueError, match="no place"):
        convert.lm_params_from_numpy(tcfg, dict(tree, **{"layers.ssm.A_log": tree["embed"]}),
                                     "cpu")
    bad = dict(tree)
    bad["layers.moe.wg"] = bad["layers.moe.wg"][:, :2]
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_numpy(tcfg, bad, "cpu")


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [16, 2048])
def test_prefill_matches_reference(ref, gate_record, arch, S):
    """S=16 takes the plain attention path, S=2048 the chunked one (the
    kernel's plain version here); pixtral's prefix holds 8 patch
    embeddings. The batch's seed is S + 1: at seed 2048 one of moonshot's
    4096 tokens has gates within GATE_ULPS (it was routed alike all the
    same, and the logits agreed)."""
    jcfg, tcfg, params, model = _pair(ref, arch)
    b = _batch(jcfg, 2, S, S + 1)
    want = np.asarray(ref.api.prefill(jcfg, params, {k: ref.jnp.asarray(v)
                                                     for k, v in b.items()}))
    got = tapi.prefill(tcfg, model, b)
    assert got.shape == (2, 1, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert _gate_near_ties(gate_record) == 0
    assert len(gate_record) == (jcfg.n_layers - jcfg.first_k_dense) * (jcfg.family == "moe")


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_forward_aux_matches_reference(ref, gate_record, arch):
    """The load-balance loss summed over the layers, as ``backbone`` sums
    it, with the ppot router (per-layer keys split from ``rng``)."""
    jcfg, tcfg, params, model = _pair(ref, arch, router="ppot")
    toks = _batch(jcfg, 2, 12, 3)["tokens"]
    for rng in (None, 5):
        jr = None if rng is None else ref.jax.random.PRNGKey(rng)
        jh, jaux = ref.lm.forward(jcfg, params, ref.jnp.asarray(toks), rng=jr)
        x = TLM.embed_tokens(tcfg, model, torch.from_numpy(toks))
        th, taux, _ = TLM.backbone(tcfg, model, x, positions=0,
                                   rng=None if rng is None else (0, rng))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert _gate_near_ties(gate_record) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(ref, gate_record, arch):
    """8 joint ``decode_fn`` steps on 2 rows from an empty cache (the
    reference's ``decode_fn`` on B rows): logits, then the caches (the
    prefix layer's too) carried across and equal."""
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
    assert _gate_near_ties(gate_record) == 0
    conv = convert.lm_cache_from_numpy(tcfg, flat(ref.jax, jcache), "cpu")
    assert len(conv) == len(tcache) == jcfg.n_layers
    for c, t in zip(conv, tcache):
        assert c["attn"]["len"].tolist() == t["attn"]["len"].tolist() == [8, 8]
        for key in ("k", "v"):
            np.testing.assert_allclose(c["attn"][key].numpy(), t["attn"][key].numpy(),
                                       atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the engine: rows routed alone
# ---------------------------------------------------------------------------


def _engine_ref(ref, arch, **over):
    jcfg, tcfg, params, model = _pair(ref, arch, **over)
    decode = ref.jax.jit(lambda params, tokens, pos, cache: ref.api.decode_fn(
        jcfg, params, {"tokens": tokens, "pos": pos}, cache))
    return types.SimpleNamespace(jax=ref.jax, jnp=ref.jnp, api=ref.api, engine=ref.engine,
                                 cfg=jcfg, params=params, decode=decode, tcfg=tcfg,
                                 model=model)


@pytest.mark.parametrize("arch,over", [
    ("moonshot-v1-16b-a3b", WIDE), ("moonshot-v1-16b-a3b", dict(WIDE, router="ppot")),
    ("phi3.5-moe-42b-a6.6b", {}), ("pixtral-12b", {})],
    ids=["moonshot-wide", "moonshot-wide-ppot", "phi3.5", "pixtral"])
def test_engine_tokens_match_reference_engine(ref, arch, over):
    """Batch admission of three, one tick, a fourth admitted mid-flight:
    the port's engine (rows routed alone) against the reference's (its
    decode mapped over the slots); moonshot at its own routing (64
    experts, top-6), where a joint route of four rows drops tokens."""
    r = _engine_ref(ref, arch, **over)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, r.cfg.vocab, size=ln) for ln in (6, 3, 9, 5)]
    n_new = 6
    want = _schedule(r.engine.ContinuousBatchingEngine(r.cfg, r.params, n_slots=4,
                                                       max_len=64), prompts, n_new)
    got = _schedule(ContinuousBatchingEngine(r.tcfg, r.model, n_slots=4, max_len=64),
                    prompts, n_new)
    _check_tokens(r, prompts, got, want, n_new)


@pytest.mark.parametrize("router", ["topk", "ppot"])
def test_engine_routes_rows_alone_and_a_joint_decode_differs(ref, router):
    """One engine step at moonshot's routing on 8 rows: the port's engine
    step equals the reference engine's (each row routed alone), the joint
    ``decode_fn`` equals the reference's ``decode_fn`` on 8 rows, and the
    two differ by far more than rounding (capacity drops)."""
    from repro_torch.serving import engine as teng

    r = _engine_ref(ref, ARCHS[0], router=router, **WIDE)
    B = 8
    toks = np.random.RandomState(4).randint(1, r.cfg.vocab, (B, 1)).astype(np.int32)
    pos = np.zeros(B, np.int32)
    want, _, _ = ref.engine._batched_decode(r.cfg, r.params, ref.jnp.asarray(toks),
                                            ref.jnp.asarray(pos),
                                            ref.api.init_cache(r.cfg, B, 8))
    got, _, _ = teng._batched_decode(r.tcfg, r.model, torch.from_numpy(toks).long(),
                                     torch.from_numpy(pos).long(),
                                     tapi.init_cache(r.tcfg, B, 8, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    jwant, _ = ref.api.decode_fn(r.cfg, r.params, {"tokens": ref.jnp.asarray(toks),
                                                   "pos": ref.jnp.int32(0)},
                                 ref.api.init_cache(r.cfg, B, 8))
    joint, _ = tapi.decode_fn(r.tcfg, r.model, {"tokens": toks, "pos": 0},
                              tapi.init_cache(r.tcfg, B, 8, "cpu"))
    np.testing.assert_allclose(joint.numpy(), np.asarray(jwant), atol=TOL, rtol=TOL)
    assert np.abs(joint.numpy() - got.numpy()).max() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_serves_the_new_families_on_cpu(arch):
    """``--arch`` takes the moe and vlm archs through the engine executor."""
    out = tserve.main(["--device", "cpu", "--arch", arch, "--executor", "engine",
                       "--requests", "4", "--arrival-batch", "2", "--n-new", "2",
                       "--replicas", "2"])
    assert out["executor"] == "engine" and len(out["mu_hat"]) == 2 and out["mean_ms"] > 0


# ---------------------------------------------------------------------------
# the int8 kv_quant cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-360m", "moonshot-v1-16b-a3b"])
def test_kv_quant_decode_matches_reference(ref, arch):
    """16 decode steps with the int8 cache in both packages: logits, the
    caches, a decode continued from the reference's cache carried across,
    and the 5% bar against the full-precision forward."""
    jcfg, tcfg, params, model = _pair(ref, arch, kv_quant=True)
    toks = np.random.RandomState(2).randint(0, jcfg.vocab, (2, 16)).astype(np.int32)
    jcache = ref.api.init_cache(jcfg, 2, 16)
    tcache = tapi.init_cache(tcfg, 2, 16, "cpu")
    outs = []
    for t in range(12):
        b = {"tokens": toks[:, t:t + 1], "pos": t}
        want, jcache = ref.api.decode_fn(jcfg, params, {"tokens": ref.jnp.asarray(b["tokens"]),
                                                        "pos": ref.jnp.int32(t)}, jcache)
        got, tcache = tapi.decode_fn(tcfg, model, b, tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KVQ_TOL, rtol=KVQ_TOL)
        outs.append(got[:, 0])
    conv = convert.lm_cache_from_numpy(tcfg, flat(ref.jax, jcache), "cpu")
    for c, t in zip(conv, tcache):
        c, t = c["attn"], t["attn"]
        assert t["k_q"].dtype == torch.int8 and t["k_s"].dtype == torch.bfloat16
        for key in ("k_q", "v_q"):
            assert (c[key].int() - t[key].int()).abs().max() <= 1
        for key in ("k_s", "v_s"):
            np.testing.assert_allclose(t[key].float().numpy(), c[key].float().numpy(),
                                       rtol=2 ** -7)
    for t in range(12, 16):  # continue from the reference's cache, carried across
        b = {"tokens": toks[:, t:t + 1], "pos": t}
        want, jcache = ref.api.decode_fn(jcfg, params, {"tokens": ref.jnp.asarray(b["tokens"]),
                                                        "pos": ref.jnp.int32(t)}, jcache)
        got, conv = tapi.decode_fn(tcfg, model, b, conv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KVQ_TOL, rtol=KVQ_TOL)
        outs.append(got[:, 0])
    full = TLM.logits_head(tcfg, model, TLM.forward(tcfg, model, torch.from_numpy(toks)))
    rel = float((full - torch.stack(outs, 1)).abs().max() / full.abs().max())
    assert rel < 0.05, rel


def test_kv_quantize_matches_reference(ref):
    """Round half to even, the f32 scale dividing, the bf16 scale kept;
    all-zero rows take scale 1."""
    from repro.models import layers as RL

    from repro_torch.models import layers as TL

    x = np.random.RandomState(3).randn(2, 5, 3, 16).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[1, 2, 1] = 0.0
    x[1, 2, 1, :5] = [0.5, 1.5, 2.5, -0.5, 127.0]  # scale 1: midpoints round to even
    jq, js = RL._kv_quantize(ref.jnp.asarray(x))
    tq, ts = TL._kv_quantize(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.float().numpy(), np.asarray(js, np.float32))
    assert float(ts[0, 0, 0]) == 1.0
