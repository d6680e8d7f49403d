"""The paper's own experiment settings (§6) that the port needs."""
from __future__ import annotations

import numpy as np

#: §6.1's worker speeds: the k² grid over 100, {0.01, 0.04, ..., 0.81}.
SPEED_GRID = np.array([(k * k) / 100.0 for k in range(1, 10)])


def tpch_speed_set(n: int = 30, seed: int = 0) -> np.ndarray:
    """n worker speeds drawn uniformly from ``SPEED_GRID``."""
    rng = np.random.RandomState(seed)
    return SPEED_GRID[rng.randint(0, len(SPEED_GRID), size=n)]
