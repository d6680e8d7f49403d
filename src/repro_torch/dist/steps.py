"""The train step of the training stack, the JAX package's
``dist/steps.py`` on the port's model.

``make_train_step(cfg, ctx, opt_cfg, microbatches=, grad_sync=)`` returns
``step(model, opt_state, batch, rng) -> (opt_state', metrics)``: gradient
accumulation over microbatches of the batch's rows
(``reshape(mbs, B // mbs)``, one microbatch where ``mbs`` does not divide
B), the same ``rng`` (a host key) for every microbatch, the gradients
accumulated in f32 (each in its parameter's dtype first, as
``jax.grad`` gives it) and divided by ``mbs``; optionally int8
stochastic-rounding compression of each gradient leaf
(``grad_sync="int8"``, ``dist/compression.py``); then the AdamW update,
whose new parameters are written into ``model`` in place (the
reference's step returns them).

int8 keys: the reference draws ``split(fold_in(rng, 0x5EED), n)`` over the
n leaves of its parameter tree in flatten order, a stacked layer leaf
([L, ...]) being one leaf with one scale; the port compresses the same
leaves, stacked the same way, under the same keys
(``convert.reference_leaves``).

Ranks. With a ``ctx`` of D ranks each rank takes its rows of every
microbatch (``ctx.rows``), divides its cross-entropy sum by the whole
microbatch's mask count, and the ranks' gradient and loss sums are
gathered and added in rank order (``ShardCtx.sum_in_rank_order``): every
rank then holds the step one process computes, up to the order of the
sums (``tests/test_torch_train_step.py`` states the bar). The MoE family's
load-balance loss and expert capacity couple a batch's rows, so D > 1
raises there.
"""
from __future__ import annotations

import torch

from repro_torch import convert
from repro_torch.dist import compression
from repro_torch.models import api
from repro_torch.models.layers import DTYPES
from repro_torch.optim import adamw
from repro_torch.utils import prng


def _int8_sync(grads: dict, leaves: list, rng) -> dict:
    keys = prng.split(prng.fold_in(rng, 0x5EED), len(leaves))
    out = {}
    for key, (_, names) in zip(keys, leaves):
        g = grads[names[0]] if len(names) == 1 else torch.stack([grads[n] for n in names])
        g = compression.decompress(*compression.compress(g, key))
        out.update({n: (g if len(names) == 1 else g[i]) for i, n in enumerate(names)})
    return out


def make_train_step(cfg, ctx, opt_cfg, *, microbatches: int = 1, grad_sync: str = "auto"):
    if grad_sync not in ("auto", "int8"):
        raise ValueError(f"grad_sync {grad_sync!r} not in (auto, int8)")
    if ctx.size > 1 and cfg.family == "moe":
        raise NotImplementedError("a batch split over ranks changes the MoE layers' "
                                  "load-balance loss and capacity: D > 1 is not ported for "
                                  "the moe family")
    param_dtype = DTYPES[cfg.param_dtype]

    def step(model, opt_state, batch, rng):
        params = dict(model.named_parameters())
        leaves = convert.reference_leaves(cfg, model)
        dev = model.embed.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        B = batch["tokens"].shape[0]
        mbs = max(int(microbatches), 1)
        if B % mbs:
            mbs = 1  # fall back to one microbatch on ragged batches
        per = B // mbs

        grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                 for k, p in params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(mbs):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            denom = None
            if ctx.size > 1:
                denom = mb["mask"].float().sum().clamp_min(1.0)
                mb = {k: v[ctx.rows(per)] for k, v in mb.items()}
            loss, _ = api.loss_fn(cfg, model, mb, rng=rng, denom=denom)
            gs = torch.autograd.grad(loss, list(params.values()))
            for k, g in zip(params, gs):
                grads[k] += g.float()
            loss_sum += loss.detach()
        if ctx.size > 1:
            grads = {k: ctx.sum_in_rank_order(g) for k, g in grads.items()}
            loss_sum = ctx.sum_in_rank_order(loss_sum)
        loss = loss_sum / torch.full_like(loss_sum, mbs)
        grads = {k: g / torch.full_like(g, mbs) for k, g in grads.items()}
        if grad_sync == "int8":
            grads = _int8_sync(grads, leaves, rng)

        new, opt_state, stats = adamw.update(opt_cfg, opt_state, grads, param_dtype,
                                             leaves=[names for _, names in leaves])
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        metrics = {"loss": loss, "grad_norm": stats["grad_norm"], "lr": stats["lr"]}
        return opt_state, metrics

    return step
