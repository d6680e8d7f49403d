"""Sharding context and placements for the training stack.

The JAX package's ``dist/sharding.py`` wraps a mesh and gives every leaf
the replicated spec ``P()`` (data-parallel baseline; ZeRO-1 sharding of the
optimizer state is its documented next step). Here the context wraps an
optional ``torch.distributed`` process group: none is one process; with a
group of D ranks (gloo on the CPU, NCCL on the card) each rank holds every
parameter and optimizer leaf whole, takes its rows of each batch and the
train step combines the ranks' gradients (``dist/steps.py``).
``param_specs`` / ``opt_state_specs`` give one placement per leaf, all
``REPLICATED``, shaped for a later sharded placement as the reference's.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

#: the one placement there is so far: the whole leaf on every rank (``P()``)
REPLICATED = "replicated"


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """group: a ``torch.distributed`` process group or None (one process);
    rank and size: this process's place in it (0 and 1 without one)."""

    group: object = None
    rank: int = 0
    size: int = 1

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` rows, in rank order."""
        if n % self.size:
            raise ValueError(f"a batch of {n} rows does not divide over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def sum_in_rank_order(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, gathered and added in rank order,
        so that every rank gets the same bits whatever the backend's
        reduction order (a new tensor)."""
        if self.size == 1:
            return t.clone()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out


def make_ctx(group=None) -> ShardCtx:
    """A context over ``group`` (None: one process; ``dist.group.WORLD``
    or any group this process belongs to)."""
    if group is None:
        return ShardCtx()
    return ShardCtx(group=group, rank=dist.get_rank(group), size=dist.get_world_size(group))


def param_specs(cfg, ctx: ShardCtx, params: dict) -> dict:
    """One placement per parameter (replicated baseline)."""
    del cfg, ctx
    return {k: REPLICATED for k in params}


def opt_state_specs(cfg, ctx: ShardCtx, pspecs: dict, params: dict) -> dict:
    """Placements for one optimizer-state leaf tree (master / m / v)."""
    del cfg, ctx, pspecs
    return {k: REPLICATED for k in params}
