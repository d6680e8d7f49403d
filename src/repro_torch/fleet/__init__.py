"""Frontend fleet: S parallel schedulers with stale queue views and a
bounded-staleness sync layer (paper §5, "Distributed scheduler").

  state.py     per-frontend state: own λ̂ stream, stale queue snapshot +
               own-placement delta, frozen μ̂ view (the simulator's stacked
               form), the serving fleet's carry (``FleetServeCarry``) and one
               frontend of the collective fleet (``FleetFrontend``)
  sync.py      the sync layer at a configurable cadence: the simulator's
               round-based fold, and the collective form over a
               ``FrontendMesh`` (torch.distributed, one process a rank:
               gloo on the CPU, NCCL on the card) with the fleet step, the
               fleet sync and the one-program fleet turn's two stages
  conflict.py  the herd model: expected peer placements between syncs
               (dispatch-time correction) and collision accounting

Consumers: ``serving.router`` (``FleetRouter``, ``run_fleet_simulation``),
``serving.scanloop`` (the one-program fleet turn, stacked or over a mesh),
``env.serving`` (``run_scenario(n_frontends > 1)``), ``core.scheduler``
(``make_sharded_schedule``).
"""
from repro_torch.fleet.conflict import (
    collision_stats,
    expected_collision_rate,
    expected_peer_placements,
    herd_corrected_view,
)
from repro_torch.fleet.state import (
    FLEET_ARR_WINDOW,
    FleetFrontend,
    FleetServeCarry,
    FleetSimState,
    fleet_lam_hats,
    fleet_serve_carry,
    fold_own_placements,
    frontend_shard_table,
    frontend_table,
    frontend_view,
    init_fleet_frontends,
    init_fleet_sim,
    observe_frontend_arrival,
)
from repro_torch.fleet.sync import (
    SYNC_KINDS,
    FrontendMesh,
    file_store_mesh,
    make_fleet_scan_sync,
    make_fleet_serve_stage,
    make_fleet_step,
    make_fleet_sync,
    sync_frontend_shard,
    sync_sim_views,
)

__all__ = [
    "FLEET_ARR_WINDOW",
    "SYNC_KINDS",
    "FleetFrontend",
    "FleetServeCarry",
    "FleetSimState",
    "FrontendMesh",
    "collision_stats",
    "expected_collision_rate",
    "expected_peer_placements",
    "fleet_lam_hats",
    "file_store_mesh",
    "fleet_serve_carry",
    "fold_own_placements",
    "frontend_shard_table",
    "frontend_table",
    "frontend_view",
    "herd_corrected_view",
    "init_fleet_frontends",
    "init_fleet_sim",
    "make_fleet_scan_sync",
    "make_fleet_serve_stage",
    "make_fleet_step",
    "make_fleet_sync",
    "observe_frontend_arrival",
    "sync_frontend_shard",
    "sync_sim_views",
]
