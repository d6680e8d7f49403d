"""Pipeline parallelism: the stage-sequential reference schedule.

``pipeline_apply(stage_fn, n_stages, n_micro, mesh)`` returns
``apply(Ws, x)`` mapping microbatches ``x[n_micro, mb, d]`` through
``n_stages`` stage weights ``Ws[n_stages, ...]``, as the JAX package's
``dist/pipeline.py`` does: the stages in order, each mapped over the
microbatch axis at once (``torch.func.vmap``, its ``jax.vmap``; ``stage_fn``
takes one microbatch), numerically a GPipe 1F1B schedule (pipelining
changes overlap, not values). The bubble schedule across ranks is open in
both packages.
"""
from __future__ import annotations

import torch


def pipeline_apply(stage_fn, n_stages: int, n_micro: int, mesh=None):
    del n_stages, n_micro, mesh  # shapes carried by the operands

    def apply(Ws, x):
        y = x
        for w in Ws:
            y = torch.func.vmap(lambda xx, w=w: stage_fn(w, xx))(y)
        return y

    return apply
