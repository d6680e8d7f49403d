"""The port's train step (``dist.steps``), pipeline schedule
(``dist.pipeline``) and training driver (``launch.train``) against the JAX
package's, in f32 on reduced smollm-360m.

Bars. Loss rtol 2e-5 (the loss tests' bar); grad norm rtol 1e-5. After one
step Adam's update is about lr times the gradient's sign, so a gradient
that the two packages compute a few ulps apart near 0 can move a
parameter the other way: parameters are held within 2e-8 of the
reference's wherever the reference's first moment (the gradient, times
1 - b1) clears 1e-4 of its leaf's largest, and the parameters that part
by more elsewhere are counted, at most 0.2% of them. With int8 sync a
gradient a few ulps off can land on the other side of a stochastic
rounding step: the moments that differ by more than 1e-4 of their leaf's
largest are counted, at most 0.1% (none without int8).

D = 2 gloo ranks (each its own process, the launch killed after 180 s)
against one process: the same loss and parameters within the bars above
(the ranks' sums are added in another order), rank 0 = rank 1 bit for bit.
``launch.train.main --device cpu --reduced``: 4 steps from the same
parameters as the reference's ``main`` at the same flags, losses rtol 1e-4;
a run resumed from its step-2 checkpoint repeats steps 3-4 bit for bit.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.dist import pipeline as TP
from repro_torch.dist import sharding as TSH
from repro_torch.dist import steps as TS
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.optim import adamw as TA
from repro_torch.utils import prng
from test_torch_loss import make_batch
from test_torch_model import flat, reference_shim

import torch_train_ranks as ranks

REPO = pathlib.Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT_S = 180
ARCH = "smollm-360m"
B1 = 1 - 0.9


@pytest.fixture(scope="module")
def ref():
    with reference_shim():
        import jax
        import jax.numpy as jnp

        from repro import configs
        from repro.dist import pipeline, steps
        from repro.launch import train
        from repro.models import api
        from repro.optim import adamw

        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs, api=api, steps=steps,
                                    adamw=adamw, pipeline=pipeline, train=train)


@pytest.fixture(scope="module")
def ref_steps(ref):
    """(mbs, sync) -> the reference's step from its init at PRNGKey(0) on
    one batch: (params, new params, new opt state, metrics), flat."""
    jcfg = ref.configs.reduced(ref.configs.get_config(ARCH))
    params = ref.api.init_params(jcfg, ref.jax.random.PRNGKey(0))
    batch = {k: ref.jnp.asarray(v) for k, v in make_batch(jcfg, B=4).items()}
    key = ref.jnp.asarray(np.array(prng.fold_in(prng.PRNGKey(1), 0), np.uint32))
    out = {}
    for mbs in (1, 2):
        for sync in ("auto", "int8"):
            step = ref.jax.jit(ref.steps.make_train_step(jcfg, None, ref.adamw.AdamWConfig(),
                                                         microbatches=mbs, grad_sync=sync))
            p2, o2, m = step(params, ref.adamw.init(params), batch, key)
            out[mbs, sync] = (flat(ref.jax, params), flat(ref.jax, p2),
                              {k: flat(ref.jax, getattr(o2, k)) for k in ("master", "m", "v")},
                              {k: float(v) for k, v in m.items()})
    return out


def _hold_params(cfg, model, got: dict, want: dict, m_ref: dict) -> None:
    """Parameters ``got`` (name -> array) against the reference's, by the
    module docstring's bars."""
    stacks = convert._stacks(cfg, model)
    want = convert._arrays_for(model, want, stacks)
    m_ref = convert._arrays_for(model, m_ref, stacks)
    parted = total = 0
    for k, g in got.items():
        m = np.abs(np.asarray(m_ref[k]))
        ok = np.abs(g - np.asarray(want[k])) <= 2e-8
        assert ok[m > 1e-4 * m.max()].all(), k
        parted += int((~ok).sum())
        total += ok.size
    assert parted <= 0.002 * total, (parted, total)


@pytest.mark.parametrize("sync", ["auto", "int8"])
@pytest.mark.parametrize("mbs", [1, 2])
def test_step_against_the_reference(ref_steps, mbs, sync):
    tree, p_ref, o_ref, m_ref = ref_steps[mbs, sync]
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    model = tapi.trainable(convert.lm_params_from_numpy(cfg, tree, "cpu"))
    opt = TA.init(dict(model.named_parameters()))
    step = TS.make_train_step(cfg, TSH.make_ctx(), TA.AdamWConfig(), microbatches=mbs,
                              grad_sync=sync)
    opt, met = step(model, opt, make_batch(cfg, B=4), prng.fold_in(prng.PRNGKey(1), 0))
    np.testing.assert_allclose(met["loss"].item(), m_ref["loss"], rtol=2e-5)
    np.testing.assert_allclose(met["grad_norm"].item(), m_ref["grad_norm"], rtol=1e-5)
    assert met["lr"].item() == np.float32(m_ref["lr"])
    assert int(opt.count) == 1
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    _hold_params(cfg, model, got, p_ref, o_ref["m"])
    np.testing.assert_array_equal(
        np.concatenate([opt.master[k].numpy().ravel() for k in got]),
        np.concatenate([got[k].ravel() for k in got]))
    stacks = convert._stacks(cfg, model)
    for name in ("m", "v"):  # the moments, (1 - b1) g and (1 - b2) g^2
        want = convert._arrays_for(model, o_ref[name], stacks)
        parted = 0
        for k in got:
            w = np.asarray(want[k])
            got_k = getattr(opt, name)[k].numpy()
            parted += int((np.abs(got_k - w) > 1e-4 * max(np.abs(w).max(), 1e-30)).sum())
        assert parted <= (0.001 if sync == "int8" else 0) * sum(a.size for a in got.values()), name


def test_int8_keys_follow_the_reference_leaf_order(ref, ref_steps):
    """The reference's flatten order of its parameter tree is the port's
    ``convert.reference_leaves`` order, stacked leaves holding each layer."""
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    tree = ref_steps[1, "auto"][0]
    jcfg = ref.configs.reduced(ref.configs.get_config(ARCH))
    jparams = ref.api.init_params(jcfg, ref.jax.random.PRNGKey(0))
    paths = [".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
             for path, _ in ref.jax.tree_util.tree_flatten_with_path(jparams)[0]]
    model = convert.lm_params_from_numpy(cfg, tree, "cpu")
    leaves = convert.reference_leaves(cfg, model)
    assert [k for k, _ in leaves] == paths
    assert leaves[paths.index("layers.attn.wq")][1] == ["layers.0.attn.wq", "layers.1.attn.wq"]
    for arch in ("moonshot-v1-16b-a3b", "whisper-medium", "pixtral-12b"):
        jc = ref.configs.reduced(ref.configs.get_config(arch))
        jp = ref.api.init_params(jc, ref.jax.random.PRNGKey(0))
        want = [".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
                for path, _ in ref.jax.tree_util.tree_flatten_with_path(jp)[0]]
        c = tconfigs.reduced(tconfigs.get_config(arch))
        assert [k for k, _ in convert.reference_leaves(c, tapi.init_params(c, 0, "cpu"))] == want


def test_adamw_state_carries_across(ref, ref_steps):
    tree, _, o_ref, _ = ref_steps[2, "auto"]
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    st = convert.adamw_state_from_numpy(cfg, dict(o_ref, count=1), "cpu")
    model = convert.lm_params_from_numpy(cfg, tree, "cpu")
    want = convert._arrays_for(model, o_ref["v"], convert._stacks(cfg, model))
    assert st.v.keys() == dict(model.named_parameters()).keys() and int(st.count) == 1
    for k, v in st.v.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


def test_pipeline_against_the_reference(ref):
    """tests/test_dist.py's case: 4 stages of tanh(x @ w), 8 microbatches
    of 2 x 16."""
    rs = np.random.RandomState(0)
    Ws = (rs.randn(4, 16, 16) * 0.3).astype(np.float32)
    x = rs.randn(8, 2, 16).astype(np.float32)
    want = ref.jax.jit(ref.pipeline.pipeline_apply(lambda w, a: ref.jnp.tanh(a @ w), 4, 8))(
        ref.jnp.asarray(Ws), ref.jnp.asarray(x))
    got = TP.pipeline_apply(lambda w, a: torch.tanh(a @ w), 4, 8)(
        torch.from_numpy(Ws), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    seq = torch.from_numpy(x)
    for w in torch.from_numpy(Ws):
        seq = torch.tanh(seq @ w)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-6, atol=1e-6)


def _launch(D: int, out: pathlib.Path) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_train_ranks.py"),
                             str(D), str(out)], cwd=REPO, env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        log, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the {D}-rank launch ran over {LAUNCH_TIMEOUT_S} s and was killed")
    errors = [p.read_text() for p in out.glob("*.error")]
    assert proc.returncode == 0 and not errors, (log[-3000:], errors)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(D)]


def test_two_gloo_ranks_take_the_one_process_step(tmp_path):
    res = _launch(2, tmp_path / "d2")
    one = ranks.step_case(TSH.make_ctx())
    for k, v in res[0].items():
        np.testing.assert_array_equal(res[1][k], v, err_msg=k)
    for i in range(ranks.CASE["steps"]):
        np.testing.assert_allclose(res[0][f"loss{i}"], one[f"loss{i}"], rtol=2e-5)
        np.testing.assert_allclose(res[0][f"gnorm{i}"], one[f"gnorm{i}"], rtol=1e-5)
    parted = total = 0
    for k, v in one.items():
        if k.startswith("p."):
            close = np.abs(res[0][k] - v) <= 2e-8
            parted += int((~close).sum())
            total += v.size
    assert parted <= 0.002 * total, (parted, total)


TRAIN_FLAGS = ["--arch", ARCH, "--reduced", "--steps", "4", "--seq-len", "32",
               "--global-batch", "4", "--microbatches", "2", "--log-every", "1"]


def test_train_main_against_the_reference_and_resume(ref, tmp_path, monkeypatch):
    out_ref = ref.train.main(TRAIN_FLAGS + ["--ckpt-dir", str(tmp_path / "ref")])
    jcfg = ref.configs.reduced(ref.configs.get_config(ARCH))
    tree = flat(ref.jax, ref.api.init_params(jcfg, ref.jax.random.PRNGKey(0)))
    init = tapi.init_params

    def reference_init(cfg, seed, dev):  # the reference main's parameters
        model = init(cfg, seed, dev)
        return convert._params_from_numpy(model, tree, convert._stacks(cfg, model))

    monkeypatch.setattr(ttrain.api, "init_params", reference_init)
    flags = TRAIN_FLAGS + ["--device", "cpu", "--ckpt-every", "2"]
    run = ttrain.main(flags + ["--ckpt-dir", str(tmp_path / "a")])
    assert run["steps"] == out_ref["steps"] == 4 and run["params_m"] == out_ref["params_m"]
    np.testing.assert_allclose(run["first_loss"], out_ref["first_loss"], rtol=2e-5)
    np.testing.assert_allclose(run["final_loss"], out_ref["final_loss"], rtol=1e-4)
    # a run that stopped after its step-2 checkpoint, resumed
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000002", tmp_path / "b" / "step_00000002")
    (tmp_path / "b" / "latest").write_text("step_00000002")
    again = ttrain.main(flags + ["--ckpt-dir", str(tmp_path / "b")])
    assert again["losses"] == run["losses"][2:]
    for (k, p), q in zip(run["model"].named_parameters(), again["model"].parameters()):
        assert torch.equal(p, q), k
