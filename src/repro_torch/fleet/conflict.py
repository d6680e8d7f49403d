"""Herd-conflict model: S frontends piling onto the same short queues.

Between syncs every frontend dispatches against a view that is blind to the
other S−1 frontends' placements. When μ̂ concentrates probes on a few fast
workers (proportional sampling does exactly that), all S frontends see the
same short queue and pile on: the true queue exceeds every frontend's view
by the others' unsynced placements, and the p99 pays for it. Two tools:

  * a correction applied at dispatch time (``herd_corrected_view``):
    inflate the stale view by the expected placements of the other S−1
    frontends since the last sync. To first order each of them places at
    its own arrival rate λ̂_f and the probe marginal is proportional to μ̂,
    so the expected extra load on worker j is
    ``(S−1) · λ̂_f · Δt_sync · μ̂_j / Σ μ̂``;

  * accounting (``collision_stats``): given per-placement (frontend,
    worker, sync-epoch) triples, count the placements that landed on a
    worker some other frontend also hit within the same sync window, and
    an analytic ``expected_collision_rate`` to check it against.

The correction is torch: the host ``FleetRouter`` calls it on its router's
device with host scalars, the one-program fleet turn on the carry's
tensors. Every scalar is taken to float32 first, so both compute the same
float32 operations in the same order (``round`` of the result rounds half
to even in torch, numpy and the reference alike). The accounting is numpy.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.full((), float(np.float32(v)), dtype=torch.float32, device=device)


def expected_peer_placements(lam_f, dt_sync, mu_view, n_frontends: int) -> torch.Tensor:
    """Expected placements per worker by the other S−1 frontends since the
    last sync: ``(S−1)·λ̂_f·Δt`` arrivals spread ∝ μ̂. ``lam_f`` and
    ``dt_sync`` are host scalars or 0-d f32 tensors. Returns f32[n] on
    ``mu_view``'s device; zero when S == 1."""
    mu = torch.as_tensor(mu_view).to(torch.float32).clamp(min=0.0)
    dev = mu.device
    tot = mu.sum().clamp(min=1e-9)
    rate = (_f32(n_frontends - 1, dev) * _f32(lam_f, dev).clamp(min=0.0)
            * torch.maximum(_f32(dt_sync, dev), _f32(0.0, dev)))
    return rate * mu / tot


def herd_corrected_view(view: torch.Tensor, lam_f, dt_sync, mu_view,
                        n_frontends: int) -> torch.Tensor:
    """Stale view + rounded expected peer load: what frontend f should
    assume the queues look like given everyone else kept dispatching."""
    extra = expected_peer_placements(lam_f, dt_sync, mu_view, n_frontends)
    return view + torch.round(extra).to(view.dtype)


def collision_stats(frontends: np.ndarray, workers: np.ndarray, epochs: np.ndarray) -> dict:
    """Herd-collision accounting over a placement log (i64[P] each).

    A placement collides when at least one other frontend placed on the
    same worker within the same sync epoch. Returns the collision rate, the
    number of contested (epoch, worker) cells and the placements."""
    frontends = np.asarray(frontends, np.int64)
    workers = np.asarray(workers, np.int64)
    epochs = np.asarray(epochs, np.int64)
    P = frontends.shape[0]
    if P == 0:
        return {"placements": 0, "collision_rate": 0.0, "contested_cells": 0}
    # cell = (epoch, worker); a cell is contested when >= 2 distinct
    # frontends placed in it
    nw = int(workers.max()) + 1
    cell = epochs * nw + workers
    pair_cells = np.unique(np.stack([cell, frontends], axis=1), axis=0)[:, 0]
    uniq_cells, nf_per_cell = np.unique(pair_cells, return_counts=True)
    contested = uniq_cells[nf_per_cell >= 2]
    collided = np.isin(cell, contested)
    return {
        "placements": int(P),
        "collision_rate": float(collided.mean()),
        "contested_cells": int(contested.size),
    }


def expected_collision_rate(S: int, lam: float, n: int, window: float,
                            mu: np.ndarray | None = None) -> float:
    """Analytic first-order herd-collision estimate: a placement by frontend
    f on worker j collides unless no other frontend hits j in the same
    window. The others place ``(S−1)·(λ/S)·window`` jobs spread ∝ μ, so
    P(collide | j) = 1 − exp(−(S−1)·(λ/S)·window·p_j), averaged over the
    placement marginal p_j. 0 when S = 1."""
    if S <= 1:
        return 0.0
    p = (np.asarray(mu, float) / max(float(np.sum(mu)), 1e-9)
         if mu is not None else np.full(n, 1.0 / n))
    others = (S - 1) * (lam / S) * window
    return float(np.sum(p * (1.0 - np.exp(-others * p))))
