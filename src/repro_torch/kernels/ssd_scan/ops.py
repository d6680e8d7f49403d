"""The SSD scan in the model's layout, with the chunk length picked as
``models.ssm.ssd_chunked`` picks it (``src/repro/models/ssm.py:77-79``):
Q = min(chunk, S), or gcd(S, chunk) where that does not divide S. So the
kernel and the plain chunked path compute the same chunking. B and C are
read in place by every head (the JAX wrapper broadcast them to [B·H, S, N]
first), and x, dt and y keep the [B, S, H, ...] layout (no transposes)."""
from __future__ import annotations

import math

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_heads


def pick_chunk(S: int, chunk: int) -> int:
    Q = min(chunk, S)
    return math.gcd(S, chunk) if S % Q else Q


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x [B, S, H, P]; dt [B, S, H]; A [H]; Bm/Cm [B, S, N] (shared across
    heads) -> (y [B, S, H, P] f32, h [B, H, N, P] f32): the contract of
    ``models.ssm.ssd_chunked``."""
    return ssd_scan_heads(x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
                          Bm.float().contiguous(), Cm.float().contiguous(),
                          chunk=pick_chunk(x.shape[1], chunk))
