"""Frontend fleet: S parallel schedulers with stale queue views and a
bounded-staleness sync layer (paper §5, "Distributed scheduler").

  state.py     per-frontend state: own λ̂ stream, stale queue snapshot +
               own-placement delta, frozen μ̂ view (the simulator's stacked
               form) and the serving fleet's carry (``FleetServeCarry``)
  sync.py      the simulator's round-based sync fold
  conflict.py  the herd model: expected peer placements between syncs
               (dispatch-time correction) and collision accounting

Consumers: ``serving.router`` (``FleetRouter``, ``run_fleet_simulation``),
``serving.scanloop`` (the one-program fleet turn), ``env.serving``
(``run_scenario(n_frontends > 1)``). The collective form over several
devices is ROADMAP queue A, A6b.
"""
from repro_torch.fleet.conflict import (
    collision_stats,
    expected_collision_rate,
    expected_peer_placements,
    herd_corrected_view,
)
from repro_torch.fleet.state import (
    FLEET_ARR_WINDOW,
    FleetServeCarry,
    FleetSimState,
    fleet_lam_hats,
    fleet_serve_carry,
    fold_own_placements,
    frontend_table,
    frontend_view,
    init_fleet_sim,
    observe_frontend_arrival,
)
from repro_torch.fleet.sync import sync_sim_views

__all__ = [
    "FLEET_ARR_WINDOW",
    "FleetServeCarry",
    "FleetSimState",
    "collision_stats",
    "expected_collision_rate",
    "expected_peer_placements",
    "fleet_lam_hats",
    "fleet_serve_carry",
    "fold_own_placements",
    "frontend_table",
    "frontend_view",
    "herd_corrected_view",
    "init_fleet_sim",
    "observe_frontend_arrival",
    "sync_sim_views",
]
