"""Standalone entry points of the PPoT dispatch kernels: draw B PPoT-SQ(2)
choices against a fixed queue snapshot. The uniforms come from
``jax.random.uniform``'s threefry stream (``utils.prng.uniform``), so these
follow the reference's ``ops`` module draw for draw. The engine in
``core/dispatch.py`` calls the kernels directly instead."""
from __future__ import annotations

import torch

from repro_torch.kernels.ppot_dispatch import kernel, ref
from repro_torch.utils import prng


def _uniforms(key, B: int, device):
    k1, k2 = prng.split(key)
    return prng.uniform(k1, B, device), prng.uniform(k2, B, device)


def dispatch(key, mu_hat: torch.Tensor, q: torch.Tensor, B: int):
    """Select kernel, then the fold-back as a separate pass."""
    cdf = ref.make_cdf(mu_hat)
    u1, u2 = _uniforms(key, B, q.device)
    workers = kernel.ppot_dispatch(cdf, q, u1, u2)
    return workers, ref.fold_back(q, workers)


def dispatch_fused(key, mu_hat: torch.Tensor, q: torch.Tensor, B: int):
    """One fused kernel returns (workers, q_after). Same stream as ``dispatch``."""
    cdf = ref.make_cdf(mu_hat)
    u1, u2 = _uniforms(key, B, q.device)
    return kernel.ppot_dispatch_fused(cdf, q, u1, u2)


def dispatch_ref(key, mu_hat: torch.Tensor, q: torch.Tensor, B: int):
    """The plain version with the same stream."""
    cdf = ref.make_cdf(mu_hat)
    u1, u2 = _uniforms(key, B, q.device)
    return ref.ppot_dispatch_fused_ref(cdf, q, u1, u2)
