"""Policy names and the shared policy configuration the engine reads.

Only PPoT-SQ(2) (paper §3.1.2, Fig. 5: two μ̂-proportional probes, join the
shorter queue) has a batch form in this package so far; the other names
are kept so that configurations and errors read as in the reference.
"""
from __future__ import annotations

import dataclasses

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
    bandit_eta: float  # η of the multi-armed-bandit baseline
    sparrow_d: int  # Sparrow's probe ratio d (d·m probes for m tasks)


def default_policy_config(bandit_eta: float = 0.2, sparrow_d: int = 2) -> PolicyConfig:
    return PolicyConfig(bandit_eta=bandit_eta, sparrow_d=sparrow_d)
