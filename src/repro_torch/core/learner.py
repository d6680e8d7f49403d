"""Performance learner (paper §3.2, Fig. 6).

LEARNER-DISPATCHER: benchmark ("fake") jobs arrive as a Poisson process of
rate ``c0 · (μ̄ − λ̂)`` at uniformly random workers (``fake_job_rate``; the
draw is ``core.scheduler.fake_jobs_from``).

LEARNER-AGGREGATE: each completion's service time goes into its worker's
ring (``record_completions``); ``refresh_estimates`` then sets

    q̂_i = mean of the last min(2.25·L, ring) samples
    μ̂_i = (1 − ε) / q̂_i                 (a deliberate underestimate)
    L   = c / (1 − α̂)  [practical]  or  c1·log(n) / ε²  [theory]
    ε   = 0.3 · (1 − α̂),  α̂ = λ̂ / μ̄

and μ̂_i = 0 when the last L samples span more than (1+ε)·L/μ* (the worker
is too slow to matter, Lemma 5(i)). Averaging over 2.25·L rather than L
halves the estimate's variance while keeping its lag within the paper's
volatility timescales.

The rings and estimates are tensors on the learner's device. The window
parameters (α̂, ε, μ*, L) are scalars of λ̂ and computed on the host in
float32, so no device value is read back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

f32 = np.float32

RING_CAP = 128  # per-worker sample ring capacity (>= any practical L)
AVG_WINDOW_MULT = 2.25  # averaging window = this × L


@dataclasses.dataclass(frozen=True)
class LearnerConfig:
    mu_bar: np.float32  # minimum guaranteed total service rate μ̄
    c0: np.float32  # fake-job rate constant (paper: 0.1)
    c_window: np.float32  # window constant (c1 theory / c practical)
    window_mode: str  # "practical" | "theory"
    ring_cap: int


def default_learner_config(mu_bar: float, c0: float = 0.1, c_window: float = 10.0,
                           window_mode: str = "practical",
                           ring_cap: int = RING_CAP) -> LearnerConfig:
    return LearnerConfig(mu_bar=f32(mu_bar), c0=f32(c0), c_window=f32(c_window),
                         window_mode=window_mode, ring_cap=ring_cap)


@dataclasses.dataclass(frozen=True)
class LearnerState:
    samples: torch.Tensor  # f32[n, CAP] service-time ring
    stamps: torch.Tensor  # f32[n, CAP] completion-timestamp ring
    widx: torch.Tensor  # i32[n] next write slot
    count: torch.Tensor  # i32[n] total samples per worker
    epoch_start: torch.Tensor  # f32[n] time the worker's window opened
    mu_hat: torch.Tensor  # f32[n] current estimates

    def replace(self, **kw) -> "LearnerState":
        return dataclasses.replace(self, **kw)


def init_learner(n: int, cfg: LearnerConfig, mu_init: float = 1.0,
                 device=None) -> LearnerState:
    dev = resolve_device(device)
    cap = cfg.ring_cap
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)
    return LearnerState(
        samples=z(n, cap), stamps=z(n, cap),
        widx=z(n, dt=torch.int32), count=z(n, dt=torch.int32),
        epoch_start=z(n),
        mu_hat=torch.full((n,), mu_init, dtype=torch.float32, device=dev),
    )


def _ring_write(ring: torch.Tensor, flat: torch.Tensor, values: torch.Tensor):
    """ring.view(-1)[flat] = values, where ``flat == ring.numel()`` marks a
    row to drop (it lands in a spare slot that is cut off)."""
    ext = torch.cat([ring.reshape(-1), ring.new_zeros(1)])
    ext.index_put_((flat,), values)
    return ext[:-1].view(ring.shape)


def record_completion(state: LearnerState, worker: int, service_time,
                      now) -> LearnerState:
    """Append one (service_time, now) sample for ``worker``."""
    cap = state.samples.shape[1]
    slot = state.widx[worker]
    samples, stamps = state.samples.clone(), state.stamps.clone()
    samples[worker, slot] = float(f32(service_time))
    stamps[worker, slot] = float(f32(now))
    widx, count = state.widx.clone(), state.count.clone()
    widx[worker] = (slot + 1) % cap
    count[worker] += 1
    return state.replace(samples=samples, stamps=stamps, widx=widx, count=count)


def record_completions(state: LearnerState, workers: torch.Tensor,
                       service_times: torch.Tensor, now) -> LearnerState:
    """Append a batch of samples (workers -1 = padding) in one write, the
    same as appending them one at a time.

    A completion's ring slot is its worker's write head plus its ordinal
    among the same worker's earlier completions in the batch
    (``within_batch_rank``). If one worker gets more than ``cap`` samples in
    a batch, only the last ``cap`` survive, as sequential writes would
    leave them; so the (worker, slot) pairs written are unique.
    """
    from repro_torch.core.dispatch import within_batch_rank

    n, cap = state.samples.shape
    valid = workers >= 0
    rank = within_batch_rank(workers, valid)
    wc = torch.where(valid, workers, 0).long()
    counts = torch.zeros(n + 1, dtype=torch.int32, device=workers.device).index_add_(
        0, torch.where(valid, workers.long(), n), valid.to(torch.int32))[:n]
    survives = valid & (rank >= counts[wc] - cap)
    slot = (state.widx[wc] + rank) % cap
    flat = torch.where(survives, wc * cap + slot, n * cap)
    return state.replace(
        samples=_ring_write(state.samples, flat, service_times),
        stamps=_ring_write(state.stamps, flat,
                           torch.full_like(service_times, float(f32(now)))),
        widx=(state.widx + counts) % cap,
        count=state.count + counts,
    )


def reset_workers(state: LearnerState, reset: torch.Tensor, now,
                  active: torch.Tensor | None = None) -> LearnerState:
    """Cold-start the ``reset`` workers (churn rejoin): clear their rings,
    restart their window at ``now`` and seed μ̂ with the mean estimate of
    the workers that stayed (1.0 if none did)."""
    keep = ~reset if active is None else (active & ~reset)
    denom = keep.to(torch.float32).sum()
    mu_keep = torch.where(keep, state.mu_hat, 0.0).sum()
    mu0 = torch.where(denom > 0, mu_keep / denom.clamp(min=1.0),
                      torch.ones_like(denom))
    r = reset[:, None]
    return state.replace(
        samples=torch.where(r, 0.0, state.samples),
        stamps=torch.where(r, 0.0, state.stamps),
        widx=torch.where(reset, 0, state.widx),
        count=torch.where(reset, 0, state.count),
        epoch_start=torch.where(reset, float(f32(now)), state.epoch_start),
        mu_hat=torch.where(reset, mu0, state.mu_hat),
    )


def window_params(cfg: LearnerConfig, lam_hat, n: int):
    """(α̂, ε, μ*, L): Fig. 6 lines 4-5 with the §6.2 practical window, as
    host float32 scalars and a Python int L."""
    alpha = min(max(f32(lam_hat) / max(cfg.mu_bar, f32(1e-9)), f32(0.0)), f32(0.999))
    eps = f32(0.3) * (f32(1.0) - alpha)
    avg_rate = cfg.mu_bar / f32(n)  # the paper normalises the average worker to 1
    mu_star = (f32(1.0) - alpha) / f32(10.0) * avg_rate
    if cfg.window_mode == "theory":
        L_f = cfg.c_window * np.log(f32(max(n, 2))) / max(eps * eps, f32(1e-6))
    else:
        L_f = cfg.c_window / max(f32(1.0) - alpha, f32(1e-3))
    L = min(max(int(np.ceil(L_f)), 1), cfg.ring_cap)
    return alpha, eps, mu_star, L


def refresh_estimates(state: LearnerState, cfg: LearnerConfig, lam_hat,
                      now) -> LearnerState:
    """LEARNER-AGGREGATE over all workers at once (see the module
    docstring); μ̂_i keeps its value while worker i has no sample."""
    n, cap = state.samples.shape
    _, eps, mu_star, L = window_params(cfg, lam_hat, n)
    dev = state.samples.device

    lanes = torch.arange(cap, device=dev)[None, :]
    widx = state.widx[:, None]
    count = state.count[:, None]
    age = (widx - 1 - lanes) % cap  # 0 = most recent; unwritten: >= count
    k = count.clamp(max=min(int(AVG_WINDOW_MULT * L), cap))
    valid = (age < k) & (lanes < count.clamp(max=cap))

    sums = torch.where(valid, state.samples, 0.0).sum(1)
    nval = valid.sum(1).clamp(min=1)
    q_hat = sums / nval
    # scalar / tensor: a true division (Python's rtruediv multiplies by a
    # reciprocal, which rounds differently)
    mu_new = torch.full_like(q_hat, float(f32(1.0) - eps)) / q_hat.clamp(min=1e-9)
    mu_new = torch.where(state.count > 0, mu_new, state.mu_hat)

    # dead-worker cut-off: the L-th most recent sample's time (or the epoch
    # start while fewer than L were collected) must lie within the horizon
    idx_Lth = ((state.widx - L) % cap).long()
    t_Lth = state.stamps.gather(1, idx_Lth[:, None])[:, 0]
    t_ref = torch.where(state.count >= L, t_Lth, state.epoch_start)
    horizon = (f32(1.0) + eps) * f32(L) / max(mu_star, f32(1e-9))
    too_slow = (float(f32(now)) - t_ref) > float(horizon)
    return state.replace(mu_hat=torch.where(too_slow, 0.0, mu_new))


def fake_job_rate(cfg: LearnerConfig, lam_hat) -> np.float32:
    """LEARNER-DISPATCHER Poisson rate c0 · (μ̄ − λ̂), clipped at 0."""
    return cfg.c0 * max(cfg.mu_bar - f32(lam_hat), f32(0.0))


def sync_estimates(mu_hats: torch.Tensor) -> torch.Tensor:
    """Multi-scheduler synchronisation (paper §5): the mean of the shards'
    μ̂ over the scheduler axis, f32[S, n] -> f32[n]."""
    return mu_hats.mean(0)
