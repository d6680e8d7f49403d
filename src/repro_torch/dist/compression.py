"""int8 gradient compression with stochastic rounding (unbiased).

Used by the ``grad_sync="int8"`` train-step mode: gradients are quantized
to int8 with a per-tensor scale before the (conceptual) all-reduce and
dequantized after. Stochastic rounding (floor(x/s + u), u ~ U[0,1)) makes
the quantizer unbiased, E[decompress(compress(x))] = x, so momentum
accumulation stays centered; the absolute error is bounded by one grid
step: |decompress(compress(x)) - x| <= scale.

The uniforms are ``prng.uniform(key, x.shape)``, the JAX package's
``jax.random.uniform(key, x.shape)`` bit for bit, so ``q`` and ``scale``
equal the reference's. Both divisions divide by a tensor: on CUDA a
division by a Python scalar may become a multiply by its reciprocal,
which rounds differently.
"""
from __future__ import annotations

import torch

from repro_torch.utils import prng


def compress(x: torch.Tensor, key):
    """Quantize to int8 under a host key. Returns (q int8[...], scale f32
    0-d tensor)."""
    x = x.float()
    amax = x.abs().amax() if x.numel() else torch.zeros((), device=x.device)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    u = prng.uniform(key, tuple(x.shape), x.device)
    q = torch.floor(x / safe + u).clamp(-127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
