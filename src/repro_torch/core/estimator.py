"""Arrival-rate estimator (paper §3.3), the EMA form the serving router uses.

λ̂ is the reciprocal of an EMA of inter-arrival gaps. The state is three
scalars, so it lives on the host as numpy float32 values: every operation
is one IEEE f32 operation, as on the device, and reading λ̂ costs no device
synchronisation. The EMA update is one fused multiply-add, as the
reference's compiled serving turn computes it (XLA contracts
``r * mean_gap + (1 - r) * gap`` into ``fma(r, mean_gap, (1 - r) * gap)``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

f32 = np.float32

#: EMA window (decay 1/S) of every λ̂-EMA consumer.
EMA_ARR_WINDOW = 64


@dataclasses.dataclass(frozen=True)
class EmaArrivalState:
    last_time: np.float32
    mean_gap: np.float32  # EMA of the inter-arrival time
    count: int


def fma_f32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """a * b + c rounded once to float32.

    The product of two floats is exact in a double; ``s = p + c`` is then
    rounded to double, and ``e`` is that rounding's exact error. Rounding
    ``s`` on to float32 is wrong only where ``s`` is an exact midpoint
    between two floats and ``e`` is not 0; the sign of ``e`` then decides.
    """
    p, cd = float(a) * float(b), float(c)
    s = p + cd
    bv = s - p
    e = (p - (s - bv)) + (cd - bv)
    r = f32(s)
    if e != 0.0:
        for nb in (np.nextafter(r, f32(np.inf)), np.nextafter(r, f32(-np.inf))):
            if (float(r) + float(nb)) / 2.0 == s:
                r = max(r, nb) if e > 0 else min(r, nb)
    return r


def init_ema_arrival() -> EmaArrivalState:
    return EmaArrivalState(last_time=f32(0.0), mean_gap=f32(0.0), count=0)


def observe_arrivals_ema(state: EmaArrivalState, now, m: int,
                         window: int) -> EmaArrivalState:
    """Fold a batch of ``m`` arrivals ending at ``now`` as m evenly spaced
    arrivals: m EMA steps with one gap collapse to a closed form."""
    now = f32(now)
    gap = (now - state.last_time) / f32(max(m, 1))
    r = (1.0 - 1.0 / float(window)) ** int(max(m, 1))  # host double, as a constant
    if state.count == 0:
        mean_gap = gap
    else:
        mean_gap = fma_f32(f32(r), state.mean_gap, f32(1.0 - r) * gap)
    return EmaArrivalState(last_time=now, mean_gap=mean_gap, count=state.count + m)


def lam_hat_ema(state: EmaArrivalState) -> np.float32:
    if state.mean_gap > 0:
        return f32(1.0) / max(state.mean_gap, f32(1e-9))
    return f32(0.0)
