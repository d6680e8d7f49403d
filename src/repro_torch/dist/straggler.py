"""Beyond-paper: Rosella straggler mitigation for synchronous DP training
(the numpy part copied from the JAX package's ``dist/straggler.py``; the
speculative-copy placement also as a torch function on the device).

A synchronous data-parallel step pays ``max_i alloc_i / speed_i`` — one
co-tenant-degraded worker stalls the whole collective (the paper's Fig. 2
heterogeneity, mapped onto training). The planner is the Rosella learner
applied to microbatch allocation: observe per-worker step times
(LEARNER-AGGREGATE input), keep a sliding-window speed estimate μ̂, and
allocate the next step's microbatches ∝ μ̂ — with every live worker keeping
at least one microbatch so it still participates in the collective (the
analogue of the fake-job floor: a worker with zero work produces zero
telemetry and could never be re-promoted).
"""
from __future__ import annotations

import math

import numpy as np
import torch


class StragglerPlanner:
    """Proportional microbatch allocation from learned worker speeds."""

    def __init__(self, n: int, total_microbatches: int, *, window: int = 8):
        self.n = n
        self.total = total_microbatches
        self.window = window
        self.mu_hat = np.ones(n, dtype=float)
        self._samples: list[np.ndarray] = []  # ring of per-step rate vectors

    def plan(self) -> np.ndarray:
        """Allocate ``max(total, n)`` microbatches, everyone ≥ 1.

        Greedy makespan fill: every worker keeps its participation floor of
        one microbatch, then each remaining microbatch goes to the worker
        whose finish time (alloc+1)/μ̂ grows least — proportional to μ̂ in
        the large-total limit, but integer-exact at the tail (a plain
        proportional floor+remainder rounds a 0.25-speed worker from 0.8 up
        to 2 and doubles the step time). Conservation is exact:
        sum(alloc) == max(total, n).
        """
        total = max(self.total, self.n)
        mu = np.clip(self.mu_hat, 1e-12, None)
        alloc = np.ones(self.n, dtype=int)
        for _ in range(total - self.n):
            alloc[np.argmin((alloc + 1) / mu)] += 1
        return alloc

    def observe(self, per_worker_times: np.ndarray, alloc: np.ndarray) -> None:
        """Feed one step's per-worker busy times; refresh μ̂ from the
        sliding window of observed rates (alloc/time)."""
        t = np.clip(np.asarray(per_worker_times, float), 1e-12, None)
        self._samples.append(np.asarray(alloc, float) / t)
        if len(self._samples) > self.window:
            self._samples.pop(0)
        self.mu_hat = np.mean(self._samples, axis=0)


def speculative_workers_np(mu_hat: np.ndarray, m: int) -> np.ndarray:
    """Where to run ``m`` speculative task copies — the planner's greedy
    makespan fill (``plan``) without the participation floor: slot j goes
    to the worker whose finish time (alloc+1)/μ̂ grows least, so copies
    spread across the fastest estimated workers instead of herding onto
    the single argmax. Workers with μ̂ ≤ 0 (offline / masked) are never
    chosen. Returns i32[m] worker ids (numpy reference twin of
    ``speculative_workers``)."""
    mu = np.asarray(mu_hat, np.float32)
    safe = np.where(mu > 0, np.maximum(mu, 1e-30), 1e-30)
    cost = np.where(mu > 0, 1.0 / safe, np.inf).astype(np.float32)
    alloc = np.zeros(len(mu), np.int32)
    out = np.zeros(m, np.int32)
    for i in range(m):
        j = int(np.argmin((alloc + 1).astype(np.float32) * cost))
        alloc[j] += 1
        out[i] = j
    return out


def speculative_workers(mu_hat: torch.Tensor, m: int) -> torch.Tensor:
    """Torch twin of ``speculative_workers_np`` on ``mu_hat``'s device (the
    same greedy fill, ties to the first index as ``argmin`` breaks them),
    i32[m]. ``m`` is static and nothing is read back to the host, so it
    captures into a CUDA graph: the serving recovery layer's host loop and
    its one-program loop both place speculative copies through it."""
    mu = mu_hat.to(torch.float32)
    safe = torch.where(mu > 0, mu.clamp(min=1e-30), torch.full_like(mu, 1e-30))
    # a tensor numerator: a Python scalar over a tensor is a reciprocal
    # multiply in torch, not the reference's division
    cost = torch.where(mu > 0, torch.ones_like(safe) / safe, torch.full_like(mu, math.inf))
    alloc = torch.zeros(mu.shape, dtype=torch.int32, device=mu.device)
    one = torch.ones(1, dtype=torch.int32, device=mu.device)
    out = []
    for _ in range(m):
        j = torch.argmin((alloc + 1).to(torch.float32) * cost)
        alloc.index_add_(0, j.view(1), one)
        out.append(j.view(1))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=mu.device)
    return torch.cat(out).to(torch.int32)


def simulate_fleet(
    speeds, total_microbatches: int, steps: int = 50, seed: int = 0,
    noise: float = 0.05,
):
    """Closed-loop fleet simulation: each step runs the planner's
    allocation on workers with the given speeds (lognormal jitter
    ``noise``), the step time is the slowest worker, and the planner learns
    from the observed per-worker times. Returns (step_times[steps],
    final_alloc)."""
    speeds = np.asarray(speeds, float)
    rng = np.random.RandomState(seed)
    planner = StragglerPlanner(len(speeds), total_microbatches)
    times = []
    alloc = planner.plan()
    for _ in range(steps):
        alloc = planner.plan()
        per = alloc / speeds * rng.lognormal(0.0, noise, size=len(speeds))
        times.append(float(per.max()))
        planner.observe(per, alloc)
    return np.asarray(times), alloc
