"""The port's checkpoints (``repro_torch.ckpt``), mirroring the JAX
package's ``tests/test_ckpt_and_data.py`` cases (round trip, ``keep`` and
the gc, shape and missing-leaf checks, restore onto a named device), and
the on-disk format held to the reference's: the same tree saved by both
gives the same ``arrays.npz`` and the same manifest, and each restores the
other's."""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import json
import os
import types

import numpy as np
import pytest
import torch

from repro_torch import ckpt as CKPT
from repro_torch.optim import adamw
from test_torch_model import reference_shim


@pytest.fixture(scope="module")
def ref():
    with reference_shim():
        import jax
        import jax.numpy as jnp

        from repro import ckpt

        yield types.SimpleNamespace(jax=jax, jnp=jnp, ckpt=ckpt)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"a": torch.randn(8, 16, generator=g),
              "nested": {"b": torch.arange(10, dtype=torch.int32)},
              "w": torch.randn(4, 4, generator=g).to(torch.bfloat16)}
    flat = {"a": params["a"], "w": params["w"]}
    return params, adamw.init(flat)


def _leaves(tree):
    return list(CKPT.checkpoint._flatten(tree).items())


def test_ckpt_roundtrip(tmp_path):
    params, opt = _state()
    CKPT.save(str(tmp_path), 7, (params, opt))
    assert CKPT.latest_step(str(tmp_path)) == 7
    (p2, o2), manifest = CKPT.restore(str(tmp_path), (params, opt))
    assert manifest["step"] == 7 and isinstance(o2, adamw.AdamWState)
    for (ka, a), (kb, b) in zip(_leaves((params, opt)), _leaves((p2, o2))):
        assert ka == kb and a.dtype == b.dtype
        assert torch.equal(a, b), ka


def test_ckpt_keeps_latest_and_gc(tmp_path):
    params, opt = _state()
    for s in (1, 2, 3, 4, 5):
        CKPT.save(str(tmp_path), s, (params, opt), keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000004", "step_00000005"]
    assert CKPT.latest_step(str(tmp_path)) == 5
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]


def test_ckpt_shape_mismatch_and_missing_leaf(tmp_path):
    params, _ = _state()
    CKPT.save(str(tmp_path), 1, params)
    bad = dict(params, a=torch.zeros(4, 4))
    with pytest.raises(ValueError):
        CKPT.restore(str(tmp_path), bad)
    with pytest.raises(KeyError):
        CKPT.restore(str(tmp_path), dict(params, extra=torch.zeros(2)))
    assert CKPT.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        CKPT.restore(str(tmp_path / "none"), params)


def test_ckpt_restore_onto_device(tmp_path):
    params, _ = _state()
    CKPT.save(str(tmp_path), 3, params)
    p2, _ = CKPT.restore(str(tmp_path), params, device="cpu", step=3)
    assert p2["a"].device.type == "cpu" and p2["w"].dtype == torch.bfloat16
    assert torch.equal(p2["w"], params["w"])


def test_format_matches_the_reference(ref, tmp_path):
    """One tree saved by both packages: the same arrays under the same keys
    and the same manifest; each restores the other's checkpoint."""
    rs = np.random.RandomState(0)
    tree = {"embed": rs.randn(6, 4).astype(np.float32),
            "layers": [{"w": rs.randn(3).astype(np.float32)},
                       {"w": rs.randn(3).astype(np.float32)}],
            "count": np.int32(5)}
    ttree = {"embed": torch.from_numpy(tree["embed"]),
             "layers": [{"w": torch.from_numpy(d["w"])} for d in tree["layers"]],
             "count": torch.tensor(5, dtype=torch.int32)}
    rtree = ref.jax.tree.map(ref.jnp.asarray, tree)
    CKPT.save(str(tmp_path / "t"), 2, ttree, extra={"loss": 1.5})
    ref.ckpt.save(str(tmp_path / "r"), 2, rtree, extra={"loss": 1.5})
    for name in ("manifest.json",):
        a = json.load(open(tmp_path / "t" / "step_00000002" / name))
        b = json.load(open(tmp_path / "r" / "step_00000002" / name))
        assert a == b
    with np.load(tmp_path / "t" / "step_00000002" / "arrays.npz") as a, \
            np.load(tmp_path / "r" / "step_00000002" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    got, _ = CKPT.restore(str(tmp_path / "r"), ttree)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_leaves(got), _leaves(ttree)))
    back, _ = ref.ckpt.restore(str(tmp_path / "t"), rtree)
    for x, y in zip(ref.jax.tree.leaves(back), ref.jax.tree.leaves(rtree)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
