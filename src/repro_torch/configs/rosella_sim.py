"""The paper's own experiment settings (§6): the speed sets, the
volatility schedule and ``make_sim``, which makes the SimConfig and
SimParams of a paper experiment."""
from __future__ import annotations

import numpy as np

from repro_torch.core import policies as pol
from repro_torch.core import simulator as sim

#: §6.1's worker speeds: the k² grid over 100, {0.01, 0.04, ..., 0.81}.
SPEED_GRID = np.array([(k * k) / 100.0 for k in range(1, 10)])


def tpch_speed_set(n: int = 30, seed: int = 0) -> np.ndarray:
    """n worker speeds drawn uniformly from ``SPEED_GRID``."""
    rng = np.random.RandomState(seed)
    return SPEED_GRID[rng.randint(0, len(SPEED_GRID), size=n)]


def synthetic_s1() -> np.ndarray:
    """§6.2 speed set S1 = {0.2, 0.3, ..., 1.6}: 15 workers."""
    return np.round(np.arange(0.2, 1.61, 0.1), 2)


def synthetic_s2() -> np.ndarray:
    """§6.2 speed set S2 (more heterogeneous): 15 workers."""
    return np.array(
        [0.15, 0.15, 0.15, 0.15, 0.15, 0.2, 0.3, 0.4, 0.5, 0.6, 1, 1, 1, 2, 2])


def zipf_speeds(n: int = 15, a: float = 1.5, seed: int = 0) -> np.ndarray:
    """§6.2 heterogeneity: Zipf speeds (a few powerful servers), mean 1."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    speeds = 1.0 / ranks**a
    rng.shuffle(speeds)
    return speeds / speeds.mean()


def permutation_schedule(speeds: np.ndarray, n_phases: int, seed: int = 0) -> np.ndarray:
    """§6.1/§6.2 volatility: the speed set randomly permuted each phase, so
    the total throughput stays constant."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(speeds) for _ in range(n_phases)])


def make_sim(policy: str, speeds: np.ndarray, load: float, *, rounds: int = 120_000,
             use_learner: bool = True, use_fake_jobs: bool = True, volatile_phases: int = 0,
             phase_period: float = 60.0, c_window: float = 10.0, max_tasks: int = 1,
             task_probs=None, constrained_frac: float = 0.0, mu_hat0=None, seed: int = 0,
             n_frontends: int = 1, fleet_sync_every: int = 1,
             fleet_herd_correction: bool = False, device=None):
    """(SimConfig, SimParams) for a paper experiment at task load ``load``
    (α, normalised by the mean tasks a job); ``device=None`` puts the params
    on the CUDA card. The fleet arguments open the fleet mode on any paper
    workload: S frontends synced every ``fleet_sync_every`` rounds, with the
    herd correction if asked."""
    speeds = np.asarray(speeds, dtype=np.float64)
    n = len(speeds)
    if task_probs is not None:
        p = np.asarray(task_probs, dtype=np.float64)
        p = p / p.sum()
        mean_tasks = float((np.arange(1, len(p) + 1) * p).sum())
    else:
        mean_tasks = 1.0
    lam = load * speeds.sum() / mean_tasks
    sched = (permutation_schedule(speeds, volatile_phases, seed=seed)
             if volatile_phases > 0 else speeds[None, :])
    cfg = sim.SimConfig(
        n=n, policy=policy, rounds=rounds, max_tasks=max_tasks, use_learner=use_learner,
        use_fake_jobs=use_fake_jobs, c_window=c_window, constrained_frac=constrained_frac,
        n_frontends=n_frontends, fleet_sync_every=fleet_sync_every,
        fleet_herd_correction=fleet_herd_correction)
    params = sim.make_params(
        lam=lam, mu=speeds, mu_schedule=sched,
        phase_period=phase_period if volatile_phases > 0 else float("inf"),
        mu_hat0=mu_hat0, task_probs=task_probs, max_tasks=max_tasks, device=device)
    return cfg, params


PAPER_BASELINES = (pol.UNIFORM, pol.POT, pol.SPARROW, pol.BANDIT, pol.PSS, pol.PPOT_SQ2)
