"""Cluster-trace-shaped workload generators for the load harness.

The port's copy of the JAX package's ``repro.load.traces``, numpy only:
for a seed every stream equals the reference's (tests/test_torch_load.py).

Real public cluster traces (Azure Functions 2019/2021, Google cluster
2011/2019) cannot be vendored here, so these generators SYNTHESIZE
arrival + cost streams with the shape properties the trace papers
document, each parameter annotated with its provenance:

``AzureLikeTrace`` — serverless-invocation shape (Shahrad et al., ATC'20):
  * strong diurnal cycle in the aggregate invocation rate (the paper's
    Fig. 3 shows ~peak/trough ratios of 2-4× over a day) — modeled as a
    sinusoid of configurable ``depth`` around the base rate;
  * bursty short-timescale overlay on top of the cycle (per-app
    inter-arrival CVs far above 1) — modeled as a 2-state Markov-
    modulated multiplier (calm / burst epochs with exponential dwells);
  * heavy-tailed execution durations spanning orders of magnitude —
    modeled as a lognormal with ``cost_sigma`` ≈ 1.5 (the paper's
    duration distribution is roughly log-normal over ms…minutes),
    normalized to mean 1 so λ/μ̄ utilization math is unchanged.

``GoogleLikeTrace`` — batch-cluster shape (Reiss et al., SoCC'12):
  * a steadier aggregate rate (long-running service jobs dominate
    machine-hours) with occasional large batch-job spikes — modeled as a
    base rate plus Poisson-arriving spike epochs of multiplier
    ``spike_factor``;
  * task durations that are Pareto-ish heavy-tailed (most tasks are
    seconds, the tail runs to hours) — modeled as a bounded Pareto with
    shape ``cost_alpha`` ≈ 1.5, normalized to mean 1.

Both are STREAMING processes: ``blocks(horizon, seed)`` lazily yields
``(times, costs)`` numpy blocks via vectorized Ogata thinning against the
compiled piecewise rate, so a million-request horizon never materializes
on the host at once. They plug into ``Scenario(arrivals=...)`` and are
consumed by ``repro_torch.load.ScenarioStream`` (``is_stream`` marks them as
chunk-only: ``Scenario.compile_serving`` refuses them loudly rather than
materializing the full trace).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.env import processes as prc


def _mmpp_rate(base_rate, horizon, rng, factors, dwell):
    """2-state Markov-modulated piecewise rate (regime path drawn from the
    env stream — same construction as ``processes.MMPP``)."""
    bp, val = [0.0], []
    state = 0
    t = 0.0
    while t < horizon:
        val.append(base_rate * factors[state])
        t += rng.exponential(dwell[state])
        bp.append(t)
        state = 1 - state
    return np.asarray(bp[:-1]), np.asarray(val)


def _diurnal_bins(base_rate, horizon, depth, period, dt):
    """Sinusoidal rate sampled onto dt-wide piecewise-constant bins (the
    thinning envelope needs a finite λmax, so the continuous cycle is
    binned like ``processes.Diurnal`` does)."""
    bp = np.arange(0.0, horizon, dt)
    mid = bp + dt / 2.0
    val = base_rate * (1.0 + depth * np.sin(2.0 * np.pi * mid / period))
    return bp, np.maximum(val, 1e-6)


@dataclasses.dataclass(frozen=True)
class AzureLikeTrace:
    """Serverless-shaped arrivals: diurnal cycle × MMPP burst overlay,
    lognormal durations (see module docstring for provenance)."""

    period: float = 3600.0  # diurnal period (s of simulated time)
    depth: float = 0.6  # cycle amplitude (±60% around base)
    burst_factor: float = 3.0  # burst-epoch rate multiplier
    dwell: tuple = (120.0, 15.0)  # (calm, burst) mean epoch lengths
    cost_sigma: float = 1.5  # lognormal duration sigma
    rate_dt: float = 30.0  # piecewise bin width for the sinusoid

    is_homogeneous = False
    is_trace = False
    is_stream = True

    def compile_rate(self, base_rate, horizon, rng) -> prc.PiecewiseRate:
        dbp, dval = _diurnal_bins(base_rate, horizon, self.depth,
                                  self.period, self.rate_dt)
        mbp, mval = _mmpp_rate(1.0, horizon, rng,
                               (1.0, self.burst_factor), self.dwell)
        # product of the two piecewise processes on the merged breakpoints
        bp = np.unique(np.concatenate([dbp, mbp]))
        val = (prc.piecewise_at(dbp, dval, bp)
               * prc.piecewise_at(mbp, mval, bp))
        return prc.PiecewiseRate(bp, np.maximum(val, 1e-6))

    def draw_costs(self, rng, size: int) -> np.ndarray:
        # lognormal normalized to mean 1: E[lognormal(μ,σ)] = exp(μ+σ²/2)
        mu = -0.5 * self.cost_sigma ** 2
        return rng.lognormal(mu, self.cost_sigma, size=size)


@dataclasses.dataclass(frozen=True)
class GoogleLikeTrace:
    """Batch-cluster-shaped arrivals: steady base + Poisson batch spikes,
    bounded-Pareto durations (see module docstring for provenance)."""

    spike_factor: float = 4.0  # batch-spike rate multiplier
    spike_rate: float = 1.0 / 600.0  # spike arrivals per second
    spike_dur: float = 60.0  # mean spike length
    cost_alpha: float = 1.5  # Pareto shape (heavier tail as α→1)
    cost_max: float = 100.0  # tail truncation (×mean)

    is_homogeneous = False
    is_trace = False
    is_stream = True

    def compile_rate(self, base_rate, horizon, rng) -> prc.PiecewiseRate:
        bp, val = [0.0], [base_rate]
        t = 0.0
        while True:
            t += rng.exponential(1.0 / self.spike_rate)
            if t >= horizon:
                break
            d = rng.exponential(self.spike_dur)
            bp += [t, min(t + d, horizon)]
            val += [base_rate * self.spike_factor, base_rate]
        return prc.PiecewiseRate(np.asarray(bp), np.asarray(val))

    def draw_costs(self, rng, size: int) -> np.ndarray:
        # bounded Pareto on [x_m, cost_max·x_m] via inverse CDF, scaled
        # to mean 1 afterwards (the analytic mean of the bounded law)
        a, L = self.cost_alpha, self.cost_max
        u = rng.uniform(size=size)
        x = (1.0 - u * (1.0 - L ** -a)) ** (-1.0 / a)  # Pareto(x_m=1)
        if a == 1.0:
            mean = np.log(L) / (1.0 - 1.0 / L)
        else:
            mean = (a / (a - 1.0)) * (1.0 - L ** (1.0 - a)) / (1.0 - L ** -a)
        return x / mean


def stream_arrivals(rate: prc.PiecewiseRate, horizon: float,
                    rng: np.random.RandomState, *, block: int = 65536):
    """Vectorized Ogata thinning against a compiled piecewise rate:
    yields ``times`` blocks (sorted, < horizon) of ≤ ``block`` accepted
    arrivals each, never materializing the full stream. Exact
    nonhomogeneous-Poisson sampling — candidates at λmax, accepted w.p.
    λ(t)/λmax — identical in law to the per-arrival loop in
    ``Scenario.compile_serving`` (different rng consumption order, so the
    two are distribution-equal, not stream-equal)."""
    lam_max = rate.max
    t = 0.0
    while t < horizon:
        gaps = rng.exponential(1.0 / lam_max, size=block)
        cand = t + np.cumsum(gaps)
        u = rng.uniform(size=block)
        acc = u * lam_max < prc.piecewise_at(rate.bp, rate.val, cand)
        t = float(cand[-1])
        times = cand[acc]
        times = times[times < horizon]
        if times.size:
            yield times
