"""Analytic predictions from the paper's §4, copied from the JAX package's
``core/theory.py`` (numpy only): used by the tests and the card's theory
checks.

These are the closed forms the empirical runs are validated against:

* Lemma 4 / §4.2 fixed point: under SQ(2) at load α the stationary tail is
  ``P[q ≥ k] = α^(2^k − 1)`` — doubly-exponential decay, hence max queue
  O(log log n).
* Proportional sampling alone: geometric tail ``α^k`` → max queue O(log n).
* Result 2 learning time: ``L = Θ(log(n)/(1−α)²)`` samples per worker.
* Proposition 1 recovery: ``T(v, ε) = O(C_max · log(1/ε))``.
"""
from __future__ import annotations

import math

import numpy as np


def ppot_tail(alpha: float, k: np.ndarray | int) -> np.ndarray:
    """P[q ≥ k] at the PPoT fixed point: α^(2^k − 1)."""
    k = np.asarray(k, dtype=np.float64)
    return np.power(alpha, np.exp2(k) - 1.0)


def pss_tail(alpha: float, k: np.ndarray | int) -> np.ndarray:
    """Geometric M/M/1 tail for proportional sampling: α^k."""
    k = np.asarray(k, dtype=np.float64)
    return np.power(alpha, k)


def max_queue_ppot(n: int, alpha: float, delta: float = 0.01) -> float:
    """Smallest k with n · α^(2^k − 1) ≤ δ  — the O(log log n) bound."""
    k = 0.0
    while n * ppot_tail(alpha, k) > delta and k < 64:
        k += 1.0
    return k


def max_queue_pss(n: int, alpha: float, delta: float = 0.01) -> float:
    """Smallest k with n · α^k ≤ δ — the O(log n) bound."""
    if alpha <= 0:
        return 0.0
    return max(0.0, math.log(delta / n) / math.log(alpha))


def learning_window(n: int, alpha: float, c1: float = 1.0) -> float:
    """Theoretical window L = c1 · log(n) / ε², ε = 0.3(1−α) (Fig. 6 l.5)."""
    eps = 0.3 * (1.0 - alpha)
    return c1 * math.log(max(n, 2)) / (eps * eps)


def recovery_time(c_max: float, eps: float, c: float = 1.0) -> float:
    """Proposition 1: T(v, ε) = O(C_max log(1/ε)), n-independent."""
    return c * c_max * math.log(1.0 / eps)


def stationarity_check(lam: float, mu: np.ndarray, policy: str) -> dict[str, bool]:
    """The paper's Examples 1-2: is each worker's effective arrival rate
    below its service rate under the naive policies?

    uniform: λ_i = λ/n.   PoT: workers probed uniformly — the aggregate rate
    into any subset S is at least λ·(|S|/n)², so a slow subset with
    Σμ_S < λ(|S|/n)² is non-stationary (Example 2's 0.81 computation).
    """
    mu = np.asarray(mu, dtype=np.float64)
    n = mu.shape[0]
    out = {}
    if policy == "uniform":
        out["stationary"] = bool(np.all(lam / n < mu))
    elif policy == "pot":
        order = np.argsort(mu)
        ok = True
        for s in range(1, n):
            subset = order[:s]
            lam_in = lam * (s / n) ** 2
            if lam_in > mu[subset].sum():
                ok = False
                break
        out["stationary"] = ok
    else:
        out["stationary"] = lam < mu.sum()
    return out
