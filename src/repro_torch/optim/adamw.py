"""AdamW + cosine-with-warmup schedule, from scratch (no torch.optim), the
JAX package's ``optim/adamw.py`` on tensors.

Mixed precision as there: the model's parameters live in
``cfg.param_dtype``; the optimizer owns f32 master copies and the first and
second moments, one tensor each per parameter, on the parameters' device,
under the parameters' names (``model.named_parameters()``).

Arithmetic. Every f32 operation is the reference's, in its order. Where
XLA on the CPU fuses ``a * b + c`` into one rounding (the moment updates,
the weight-decay term and the master's step, the schedule's cosine term),
the port computes it as ``estimator.fma_f32`` does, so that given the same
gradients (and an inactive clip) the moments are the reference's bit for
bit. ``sqrt`` and ``cos`` are torch's, correctly rounded or nearly, where
XLA's on the CPU are approximations: the masters part by up to 2 ulps, the
rate by up to 5 ulps at the end of the decay (``tests/test_torch_optim.py``
states the bars).

``global_norm`` sums each parameter's squares in f32 and adds the sums in
the order of the reference's parameter tree (``leaves``: groups of the
port's names, one group a reference leaf, ``convert.reference_leaves``),
so only the reductions' own order parts it from the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.estimator import fma_f32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


@dataclasses.dataclass
class AdamWState:
    master: dict  # name -> f32 master copy
    m: dict
    v: dict
    count: torch.Tensor  # i32 0-d: updates taken


def init(params: dict) -> AdamWState:
    """f32 masters (copies, also of f32 parameters) and zero moments for
    ``params`` (name -> tensor)."""
    return AdamWState(
        master={k: p.detach().float().clone() for k, p in params.items()},
        m={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()},
        count=torch.zeros((), dtype=torch.int32,
                          device=next(iter(params.values())).device))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer 0-d tensor), f32."""
    step = step.float()
    warm = _f32(cfg.lr, step) * step / _f32(max(cfg.warmup_steps, 1), step)
    t = ((step - _f32(cfg.warmup_steps, step))
         / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step)).clamp(0.0, 1.0)
    cos = fma_f32(_f32((1 - cfg.min_lr_frac) * cfg.lr * 0.5, step),
                  _f32(1.0, step) + torch.cos(_f32(math.pi, step) * t),
                  _f32(cfg.min_lr_frac * cfg.lr, step))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(grads: dict, leaves) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32; the sums added
    in the order of ``leaves`` (groups of names: the reference tree's
    flatten order, ``convert.leaf_order``)."""
    total = None
    for group in leaves:
        for k in group:
            s = grads[k].float().square().sum()
            total = s if total is None else total + s
    return torch.sqrt(total)


def update(cfg: AdamWConfig, state: AdamWState, grads: dict, param_dtype: torch.dtype,
           leaves) -> tuple:
    """Returns (new parameters in ``param_dtype`` (name -> tensor), the new
    state, stats {grad_norm, lr}). ``grads``: name -> gradient, the
    state's names; ``leaves``: ``global_norm``'s order."""
    gnorm = global_norm(grads, leaves)
    scale = torch.minimum(_f32(1.0, gnorm), _f32(cfg.grad_clip, gnorm) / gnorm.clamp_min(1e-9))
    count = state.count + 1
    lr = schedule(cfg, count)
    cf = count.float()
    c1 = _f32(1.0, cf) - torch.pow(_f32(cfg.b1, cf), cf)
    c2 = _f32(1.0, cf) - torch.pow(_f32(cfg.b2, cf), cf)
    b1, b2 = _f32(cfg.b1, cf), _f32(cfg.b2, cf)
    ob1, ob2 = _f32(1 - cfg.b1, cf), _f32(1 - cfg.b2, cf)
    eps, wd = _f32(cfg.eps, cf), _f32(cfg.weight_decay, cf)

    params, m_new, v_new, master_new = {}, {}, {}, {}
    for k, g in grads.items():
        g = g.float() * scale
        mm, vv, mast = state.m[k], state.v[k], state.master[k]
        m = fma_f32(b1.expand_as(mm), mm, ob1 * g)
        v = fma_f32(b2.expand_as(vv), vv, ob2 * g.square())
        step_ = fma_f32(wd.expand_as(mast), mast, (m / c1) / (torch.sqrt(v / c2) + eps))
        mast = fma_f32(-lr.expand_as(step_), step_, mast)
        m_new[k], v_new[k], master_new[k] = m, v, mast
        params[k] = mast.to(param_dtype)
    new_state = AdamWState(master=master_new, m=m_new, v=v_new, count=count)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
