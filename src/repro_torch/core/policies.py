"""Scheduling policies (paper §2.1, §3.1, §6 baselines).

Two forms per policy, one semantics:

  * the single-task closure defined here,
    ``policy(key, q_real, mu_hat, mu_true, cfg) -> worker`` (an i32 0-d
    tensor), the unit of specification and what places exactly one task;
  * the batch form in ``core/dispatch.py``, through which every layer
    (scheduler, serving router, the one-program loop) places whole batches.
    ``schedule_batch`` below is its sequential oracle (``fold_chunks = m``).

``q_real`` is the per-worker queue length the scheduler observes,
``mu_hat`` the learner's estimates and ``mu_true`` the true speeds, which
only Halo reads (paper §6: Halo "assumes the knowledge of worker speeds").
Keys are host keys (pairs of ints) or device keys (``utils.prng``).

Policies (paper names):
  uniform      uniform random worker                        (§2.1.1)
  pot          classical power-of-two-choices, SQ(2)        (§2.1.1)
  pss          proportional sampling schedule               (§3.1.1)
  ppot_sq2     Rosella: proportional sampling + PoT, SQ(2)  (§3.1.2, Fig. 5)
  ppot_ll2     same probes, join-least-loaded LL(2)         (§3.1, Fig. 4)
  bandit       η-uniform explore, else PPoT                 (§6 baseline v)
  halo         one proportional probe on TRUE speeds        (§6 baseline vi)
  sparrow      batch sampling d·m probes + late binding     (§6 baseline iii)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import prng

UNIFORM = "uniform"
POT = "pot"
PSS = "pss"
PPOT_SQ2 = "ppot_sq2"
PPOT_LL2 = "ppot_ll2"
BANDIT = "bandit"
HALO = "halo"
SPARROW = "sparrow"

ALL_POLICIES = (UNIFORM, POT, PSS, PPOT_SQ2, PPOT_LL2, BANDIT, HALO, SPARROW)


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    bandit_eta: float  # η of the multi-armed-bandit baseline (compared in f32)
    sparrow_d: int  # Sparrow's probe ratio d (d·m probes for m tasks)


def default_policy_config(bandit_eta: float = 0.2, sparrow_d: int = 2) -> PolicyConfig:
    return PolicyConfig(bandit_eta=bandit_eta, sparrow_d=sparrow_d)


def _safe_logits(weights: torch.Tensor) -> torch.Tensor:
    """Log-weights for categorical sampling; all-zero weights -> uniform
    (Lemma 5 can zero every μ̂ right after a shock)."""
    w = torch.where(weights.sum() > 0, weights, torch.ones_like(weights))
    return torch.log(w.clamp(min=1e-30))


def proportional_sample(key, mu_hat: torch.Tensor) -> torch.Tensor:
    """One draw with p_i = μ̂_i / Σ μ̂ (paper Fig. 5 l.2-4)."""
    return prng.categorical(key, _safe_logits(mu_hat))


def _n(mu_true: torch.Tensor) -> int:
    return mu_true.shape[0]


def uniform_policy(key, q_real, mu_hat, mu_true, cfg: PolicyConfig):
    del q_real, mu_hat, cfg
    return prng.randint(key, (), 0, _n(mu_true), mu_true.device)


def pot_policy(key, q_real, mu_hat, mu_true, cfg: PolicyConfig):
    """Classical PoT: two uniform probes, join the shorter queue."""
    del mu_hat, cfg
    j = prng.randint(key, (2,), 0, _n(mu_true), mu_true.device)
    return torch.where(q_real[j[0]] <= q_real[j[1]], j[0], j[1])


def pss_policy(key, q_real, mu_hat, mu_true, cfg: PolicyConfig):
    del q_real, mu_true, cfg
    return proportional_sample(key, mu_hat)


def _two_proportional(key, mu_hat):
    """Two independent draws with replacement (Fig. 5 line 4)."""
    k1, k2 = prng.split(key)
    return proportional_sample(k1, mu_hat), proportional_sample(k2, mu_hat)


def ppot_sq2_policy(key, q_real, mu_hat, mu_true, cfg: PolicyConfig):
    """Rosella's policy: PSS twice, join the SHORTER QUEUE (Fig. 5)."""
    del mu_true, cfg
    j1, j2 = _two_proportional(key, mu_hat)
    return torch.where(q_real[j1] <= q_real[j2], j1, j2)


def ll2_wait(q, mu_hat, j):
    """LL(2)'s expected wait (q_j + 1) / μ̂_j in f32; μ̂ = 0 is infinitely
    slow (clipped to 1e-9)."""
    return (q[j] + 1.0) / mu_hat.clamp(min=1e-9)[j]


def ppot_ll2_policy(key, q_real, mu_hat, mu_true, cfg: PolicyConfig):
    """LL(2): PSS twice, join the LEAST-LOADED queue (paper §3.1 Example 3,
    Fig. 13: it congests fast workers)."""
    del mu_true, cfg
    j1, j2 = _two_proportional(key, mu_hat)
    return torch.where(ll2_wait(q_real, mu_hat, j1) <= ll2_wait(q_real, mu_hat, j2), j1, j2)


def bandit_policy(key, q_real, mu_hat, mu_true, cfg: PolicyConfig):
    """η-greedy multi-armed bandit: uniform explore w.p. η, else PPoT."""
    ke, ku, kp = prng.split(key, 3)
    explore = prng.uniform(ke, (), mu_true.device) < eta_f32(cfg)
    j_uni = prng.randint(ku, (), 0, _n(mu_true), mu_true.device)
    j_ppot = ppot_sq2_policy(kp, q_real, mu_hat, mu_true, cfg)
    return torch.where(explore, j_uni, j_ppot)


def halo_policy(key, q_real, mu_hat, mu_true, cfg: PolicyConfig):
    """Halo: proportional sampling on the KNOWN true speeds, one probe."""
    del q_real, mu_hat, cfg
    return proportional_sample(key, mu_true)


def sparrow_policy(key, q_real, mu_hat, mu_true, cfg: PolicyConfig):
    """Sparrow for one task: batch sampling degenerates to PoT probes.
    Multi-task jobs use ``sparrow_batch``."""
    return pot_policy(key, q_real, mu_hat, mu_true, cfg)


def eta_f32(cfg: PolicyConfig) -> float:
    """η rounded to float32, as the reference holds it: a float32 uniform
    compares against it exactly."""
    return float(torch.tensor(cfg.bandit_eta, dtype=torch.float32))


POLICY_FNS = {
    UNIFORM: uniform_policy,
    POT: pot_policy,
    PSS: pss_policy,
    PPOT_SQ2: ppot_sq2_policy,
    PPOT_LL2: ppot_ll2_policy,
    BANDIT: bandit_policy,
    HALO: halo_policy,
    SPARROW: sparrow_policy,
}


def get_policy(name: str):
    if name not in POLICY_FNS:
        raise ValueError(f"unknown policy {name!r}; choose from {ALL_POLICIES}")
    return POLICY_FNS[name]


def schedule_batch(policy_name: str, key, q_real, mu_hat, mu_true, cfg, m: int):
    """Place ``m`` tasks with per-task queue fold-back: the engine's
    sequential oracle. Returns (workers[m] i32, q_after)."""
    from repro_torch.core import dispatch as dsp  # deferred: dispatch imports us

    res = dsp.dispatch_sequential(policy_name, key, q_real, mu_hat, mu_true, cfg, m)
    return res.workers, res.q_after


def sparrow_batch(key, q_real, mu_true, cfg, m: int):
    """Sparrow batch sampling with late binding: d·m uniform probes, the m
    tasks on the least-loaded probed workers, each placement charged to the
    queue (the engine's water-filling form). Returns (workers[m], q_after)."""
    from repro_torch.core import dispatch as dsp  # deferred: dispatch imports us

    res = dsp.dispatch(SPARROW, key, q_real, torch.ones_like(mu_true), mu_true, cfg, m)
    return res.workers, res.q_after
