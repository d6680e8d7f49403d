"""Arrival-rate estimator (paper §3.3).

Two forms. The exact sliding-window estimator (``ArrivalEstimatorState``,
``observe_arrival``): λ̂ from the mean inter-arrival time of the last S
arrivals, held in a ring of timestamps on the caller's device. The EMA
form the serving router uses: λ̂ is the reciprocal of an EMA of
inter-arrival gaps. The state is three
scalars. The host loop keeps them as numpy float32 values (and a Python
int count): every operation is one IEEE f32 operation, as on the device,
and reading λ̂ costs no device synchronisation. The device-resident turn
(``serving.scanloop``) keeps them as 0-d tensors (f32 ``last_time`` and
``mean_gap``, an int32 ``count``, as the reference's state); the same code
(``utils.scalars``) runs on either form. The EMA update is one fused
multiply-add, as the reference's compiled serving turn computes it (XLA
contracts ``r * mean_gap + (1 - r) * gap`` into ``fma(r, mean_gap, (1 - r)
* gap)``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils import scalars
from repro_torch.utils.device import resolve_device

f32 = np.float32

@dataclasses.dataclass(frozen=True)
class ArrivalEstimatorState:
    times: torch.Tensor  # f32[S] ring of arrival timestamps
    idx: torch.Tensor  # i32 0-d, the next write slot
    count: torch.Tensor  # i32 0-d, arrivals seen
    lam_hat: torch.Tensor  # f32 0-d, the current estimate


def init_arrival_estimator(window: int, lam_init: float = 0.0,
                           device=None) -> ArrivalEstimatorState:
    """An empty ring of ``window`` timestamps on ``device`` (``None`` is the
    CUDA card and raises without one)."""
    device = resolve_device(device)
    z = lambda v, dt: torch.full((), v, dtype=dt, device=device)  # noqa: E731
    return ArrivalEstimatorState(
        times=torch.zeros(window, dtype=torch.float32, device=device),
        idx=z(0, torch.int32), count=z(0, torch.int32), lam_hat=z(lam_init, torch.float32))


def observe_arrival(state: ArrivalEstimatorState, now) -> ArrivalEstimatorState:
    """Record one arrival at ``now`` (taken to f32) and refresh λ̂ =
    (k - 1) / (t_newest - t_oldest) over the last k = min(count, S)
    arrivals; λ̂ keeps its value until two arrivals span a positive time."""
    S = state.times.shape[0]
    dev = state.times.device
    now = torch.as_tensor(now, dtype=torch.float32, device=dev)
    times = state.times.index_put((state.idx.reshape(1).long(),), now.reshape(1))
    idx = (state.idx + 1) % S
    count = state.count + 1
    k = torch.minimum(count, torch.full_like(count, S))
    # the oldest retained arrival: slot idx once the ring wrapped, else slot 0
    oldest = torch.where(count >= S, times.gather(0, (idx % S).reshape(1).long())[0],
                         times[0])
    span = now - oldest
    lam = torch.where((k >= 2) & (span > 0), (k - 1).to(torch.float32) / span,
                      state.lam_hat)
    return ArrivalEstimatorState(times=times, idx=idx, count=count, lam_hat=lam)


#: EMA window (decay 1/S) of every λ̂-EMA consumer.
EMA_ARR_WINDOW = 64


@dataclasses.dataclass(frozen=True)
class EmaArrivalState:
    last_time: np.float32  # or f32 0-d tensors and an i32 count (device form)
    mean_gap: np.float32  # EMA of the inter-arrival time
    count: int


def fma_f32(a, b, c):
    """a * b + c rounded once to float32 (numpy scalars or f32 tensors).

    The product of two floats is exact in a double; ``s = p + c`` is then
    rounded to double, and ``e`` is that rounding's exact error. Rounding
    ``s`` on to float32 is wrong only where ``s`` is an exact midpoint
    between two floats and ``e`` is not 0; the sign of ``e`` then decides.
    """
    if isinstance(a, torch.Tensor):
        return _fma_f32_t(a, b, c)
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


def _fma_f32_t(a, b, c):
    """``fma_f32`` on f32 tensors, elementwise: the same double sum and
    error term, the midpoint test against both float neighbours, and the
    same choice, as separate IEEE operations on CPU and CUDA alike."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    e = (p - (s - bv)) + (cd - bv)
    r = s.float()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.full_like(r, float("-inf")))
    rd = r.double()
    mid_up = (rd + up.double()) * 0.5 == s
    mid_dn = (rd + dn.double()) * 0.5 == s
    return torch.where((e > 0) & mid_up, up, torch.where((e < 0) & mid_dn, dn, r))


def init_ema_arrival() -> EmaArrivalState:
    return EmaArrivalState(last_time=f32(0.0), mean_gap=f32(0.0), count=0)


def to_device(state: EmaArrivalState, device) -> EmaArrivalState:
    """The host state as the device form."""
    t = lambda v, dt: torch.full((), v, dtype=dt, device=device)  # noqa: E731
    return EmaArrivalState(last_time=t(float(state.last_time), torch.float32),
                           mean_gap=t(float(state.mean_gap), torch.float32),
                           count=t(int(state.count), torch.int32))


def to_host(state: EmaArrivalState) -> EmaArrivalState:
    """The device state as the host form (one copy a field)."""
    return EmaArrivalState(last_time=f32(state.last_time.item()),
                           mean_gap=f32(state.mean_gap.item()),
                           count=int(state.count.item()))


def observe_arrivals_ema(state: EmaArrivalState, now, m: int,
                         window: int) -> EmaArrivalState:
    """Fold a batch of ``m`` arrivals ending at ``now`` as m evenly spaced
    arrivals: m EMA steps with one gap collapse to a closed form."""
    x = scalars.of(state.mean_gap)
    now = x.f32(now)
    gap = (now - state.last_time) / x.const(max(m, 1))
    r = (1.0 - 1.0 / float(window)) ** int(max(m, 1))  # host double, as a constant
    ema = fma_f32(x.const(r), state.mean_gap, x.const(1.0 - r) * gap)
    mean_gap = x.where(state.count == 0, gap, ema)
    return EmaArrivalState(last_time=now, mean_gap=mean_gap, count=state.count + m)


def lam_hat_ema(state: EmaArrivalState):
    x = scalars.of(state.mean_gap)
    mg = state.mean_gap
    return x.where(mg > 0, x.const(1.0) / x.maximum(mg, x.const(1e-9)), x.const(0.0))
