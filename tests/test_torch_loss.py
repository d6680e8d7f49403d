"""The port's training loss (``models.api.loss_fn``, ``chunked_xent``) and
its gradients against the JAX package's ``api.loss_fn`` under
``jax.value_and_grad``, for the six families at reduced configs in f32 on
the same parameters (carried across by ``convert``) and the same batch:
loss, ce and aux at the model tests' 2e-5, and every parameter's gradient
within 2e-5 of the largest gradient of its leaf (atol; rtol 2e-5). remat
none, full and dots give the port the same gradients bit for bit."""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import api as tapi
from test_torch_model import flat, reference_shim

TOL = 2e-5
FAMILIES = {"dense": "smollm-360m", "moe": "moonshot-v1-16b-a3b", "ssm": "mamba2-370m",
            "hybrid": "hymba-1.5b", "vlm": "pixtral-12b", "encdec": "whisper-medium"}
B, S = 2, 32


@pytest.fixture(scope="module")
def ref():
    with reference_shim():
        import jax
        import jax.numpy as jnp

        from repro import configs
        from repro.models import api

        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs, api=api)


def make_batch(cfg, seed: int = 0, B: int = B, S: int = S) -> dict:
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rs.randint(0, cfg.vocab, (B, S)).astype(np.int32),
             "mask": (rs.rand(B, S) < 0.8).astype(np.float32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rs.randn(B, cfg.n_patches, cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        batch["frame_embeds"] = rs.randn(B, cfg.enc_len, cfg.d_model).astype(np.float32)
    return batch


def port_model(cfg, tree: dict):
    load = (convert.encdec_params_from_numpy if cfg.family == "encdec"
            else convert.lm_params_from_numpy)
    return tapi.trainable(load(cfg, tree, "cpu"))


def reference_grads(cfg, model, jgrads) -> dict:
    """The reference's gradient tree as arrays under the port's names."""
    return convert._arrays_for(model, jgrads, convert._stacks(cfg, model))


def port_loss_and_grads(cfg, model, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, met = tapi.loss_fn(cfg, model, tb)
    params = dict(model.named_parameters())
    gs = torch.autograd.grad(loss, list(params.values()))
    return loss, met, {k: g.numpy() for k, g in zip(params, gs)}


@pytest.fixture(scope="module")
def runs(ref):
    """family -> (cfg, reference tree, batch, reference (loss, ce, aux),
    reference grads by flat key)."""
    out = {}
    for fam, arch in FAMILIES.items():
        jcfg = ref.configs.reduced(ref.configs.get_config(arch))
        cfg = tconfigs.reduced(tconfigs.get_config(arch))
        params = ref.api.init_params(jcfg, ref.jax.random.PRNGKey(0))
        batch = make_batch(cfg)
        jb = {k: ref.jnp.asarray(v) for k, v in batch.items()}
        (loss, met), g = ref.jax.jit(ref.jax.value_and_grad(
            lambda p: ref.api.loss_fn(jcfg, p, jb), has_aux=True))(params)
        out[fam] = (cfg, flat(ref.jax, params), batch,
                    (float(loss), float(met["ce"]), float(met["aux"])), flat(ref.jax, g))
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_against_the_reference(runs, family):
    cfg, tree, batch, (jloss, jce, jaux), jgrads = runs[family]
    model = port_model(cfg, tree)
    loss, met, grads = port_loss_and_grads(cfg, model, batch)
    np.testing.assert_allclose(loss.item(), jloss, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(met["ce"].item(), jce, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(met["aux"].item(), jaux, rtol=TOL, atol=TOL)
    want = reference_grads(cfg, model, jgrads)
    assert want.keys() == grads.keys()
    for k, g in grads.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("family", ["dense", "hybrid", "encdec"])
def test_remat_policies_give_the_same_grads(runs, family):
    cfg, tree, batch = runs[family][:3]
    out = {}
    for policy in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=policy)
        loss, _, grads = port_loss_and_grads(c, port_model(c, tree), batch)
        out[policy] = (loss.item(), grads)
    for policy in ("full", "dots"):
        assert out[policy][0] == out["none"][0]
        for k, g in out["none"][1].items():
            np.testing.assert_array_equal(out[policy][1][k], g, err_msg=f"{policy} {k}")


def test_chunked_xent_chunks(runs):
    """S not divisible by loss_chunk falls back to one chunk; the chunked
    sum equals one chunk's within f32 summation order."""
    cfg, tree, batch = runs["dense"][:3]
    model = port_model(cfg, tree)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        from repro_torch.models import lm as LM

        hidden = LM.forward(cfg, model, tb["tokens"])
        args = (hidden, tb["labels"], tb["mask"], LM.logits_head)
        chunked = tapi.chunked_xent(cfg, model, *args).item()
        one = tapi.chunked_xent(dataclasses.replace(cfg, loss_chunk=S), model, *args).item()
        ragged = tapi.chunked_xent(dataclasses.replace(cfg, loss_chunk=7), model, *args).item()
    assert ragged == one
    np.testing.assert_allclose(chunked, one, rtol=1e-6)
