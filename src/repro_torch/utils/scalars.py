"""One scalar arithmetic for host and device values.

The serving turn's scalars (λ̂, the time stamps, the window parameters)
are numpy float32 values on the host loop and 0-d float32 tensors in the
device-resident turn (``serving.scanloop``). ``of(x)`` returns the carrier
of ``x``; code written against it runs the same IEEE float32 operations in
the same order on either, so the two forms agree bit for bit.

Every constant of the device form is a tensor on the device
(``Device.const``): torch divides a CUDA tensor by a Python scalar as a
multiply by its reciprocal, which rounds differently from a division.
"""
from __future__ import annotations

import numpy as np
import torch

f32 = np.float32


class Host:
    """numpy float32 scalars and Python ints."""

    @staticmethod
    def f32(v):
        return f32(v)

    const = f32

    @staticmethod
    def maximum(a, b):
        return max(a, b)

    @staticmethod
    def minimum(a, b):
        return min(a, b)

    @staticmethod
    def where(cond, a, b):
        return a if cond else b

    @staticmethod
    def ceil_int(x, lo: int, hi: int) -> int:
        return min(max(int(np.ceil(x)), lo), hi)

    @staticmethod
    def int_f32(i):
        return f32(i)


class Device:
    """0-d tensors on one device: float32 values, int32 counts."""

    def __init__(self, like: torch.Tensor):
        self.device = like.device

    def f32(self, v):
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32)
        return self.const(v)

    def const(self, v):
        return torch.full((), float(f32(v)), dtype=torch.float32, device=self.device)

    maximum = staticmethod(torch.maximum)
    minimum = staticmethod(torch.minimum)
    where = staticmethod(torch.where)

    @staticmethod
    def ceil_int(x, lo: int, hi: int):
        return torch.ceil(x).clamp(lo, hi).to(torch.int32)

    @staticmethod
    def int_f32(i):
        return i.to(torch.float32)


HOST = Host()


def of(x):
    """The carrier of ``x``: ``Device`` for a tensor, else ``HOST``."""
    return Device(x) if isinstance(x, torch.Tensor) else HOST


def fill(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` broadcast to ``like``'s shape and dtype: a host scalar as a
    filled tensor, a 0-d tensor as an expanded view."""
    if isinstance(v, torch.Tensor):
        return v.to(like.dtype).expand_as(like)
    return torch.full_like(like, float(v))
