"""Checkpoint save and restore in the JAX package's on-disk format
(``ckpt/checkpoint.py``):

  ``step_<N>/arrays.npz``    every leaf as a numpy array, under its name
  ``step_<N>/manifest.json`` step, sorted keys, shapes, dtypes, ``extra``

written into a temporary directory and renamed into place, then a
``latest`` pointer; ``keep`` bounds the steps kept (the oldest removed).

A state is a (nested) dict or list of tensors, or an object with a
``__dict__`` of them (``AdamWState``); a leaf's name is its path joined by
``/``, the port's own names (``0/embed``, ``1/master/layers.0.attn.wq``,
``1/count``, ...). bfloat16 has no numpy dtype: such a leaf is stored as
float32 (exact) and restored to the template's dtype. ``restore`` loads
onto the device the caller names (default: each template leaf's own).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np
import torch


def _children(node):
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def _flatten(tree, prefix="") -> dict:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, v in kids:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _rebuild(tree, leaves: dict, prefix=""):
    kids = _children(tree)
    if kids is None:
        return leaves[prefix]
    new = {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k)) for k, v in kids}
    if isinstance(tree, dict):
        return new
    if isinstance(tree, (list, tuple)):
        return type(tree)(new[i] for i in range(len(tree)))
    return dataclasses.replace(tree, **new)


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def save(ckpt_dir: str, step: int, state, *, keep: int = 3, extra: dict | None = None):
    """Write ``state`` atomically as ``step_<step>``; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten(state).items()}
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    with open(os.path.join(ckpt_dir, "latest"), "w") as f:
        f.write(f"step_{step:08d}")
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    ptr = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "arrays.npz")):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, template, *, step: int | None = None, device=None):
    """Load into the structure of ``template`` (its leaves' shapes and
    dtypes), onto ``device`` (None: each template leaf's device). Raises
    ``KeyError`` on a leaf the checkpoint lacks and ``ValueError`` on a
    shape that differs. Returns (state, manifest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for key, tpl in _flatten(template).items():
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(tpl.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != template {tuple(tpl.shape)}")
            if isinstance(tpl, torch.Tensor):
                dev = tpl.device if device is None else torch.device(device)
                leaves[key] = torch.from_numpy(np.array(arr)).to(dev, tpl.dtype)
            else:
                leaves[key] = arr.astype(np.asarray(tpl).dtype)
    return _rebuild(template, leaves), manifest
