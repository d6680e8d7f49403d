"""Bounded-staleness sync: reconciling S stale frontend views.

The paper's frontends "need only synchronize the estimates of worker
speeds regularly" (§5). ``sync_sim_views`` is that synchronisation in the
simulator's round-based form, where the true worker state is at hand:
every frontend's queue snapshot reconciles to the true queues, its
own-placement delta clears, its μ̂ view adopts the current central
estimate with one alias table built for all, and the per-frontend λ̂
streams merge into the fleet's ``lam_global = Σ_f λ̂_f`` (each frontend
sees ~λ/S of the arrivals, so the sum estimates λ).

The serving fleet reconciles in ``serving.router.FleetRouter.sync`` (host)
and in the one-program fleet turn (``serving.scanloop``), where no one
holds the true state: the global view is rebuilt from per-frontend deltas.
The collective form over several devices (the reference's ``shard_map``
stages) is ROADMAP queue A, A6b.
"""
from __future__ import annotations

import torch

from repro_torch.core import dispatch as dsp
from repro_torch.fleet.state import FleetSimState, fleet_lam_hats


def sync_sim_views(fleet: FleetSimState, q_true: torch.Tensor, mu_central: torch.Tensor,
                   now, active: torch.Tensor | None = None) -> FleetSimState:
    """Reconcile every frontend's view at the true worker state (i32[n]
    queues, f32[n] central μ̂) at time ``now``. The frozen alias table is
    part of the view: one build from the adopted μ̂, shared by every
    frontend until the next sync; under churn (``active`` bool[n]) it is
    masked, so offline workers carry no probe mass in any frontend's view
    until the sync that readmits them."""
    S, n = fleet.q_snap.shape
    lam_f = fleet_lam_hats(fleet)
    table = dsp.build_alias_table(mu_central, active)

    def rows(v):
        return v[None].expand(S, n).contiguous()

    return fleet.replace(
        q_snap=rows(q_true.to(torch.int32)), q_delta=torch.zeros_like(fleet.q_delta),
        mu_view=rows(mu_central.to(torch.float32)), alias_p=rows(table.prob),
        alias_a=rows(table.alias),
        t_sync=torch.full((S,), float(torch.as_tensor(now, dtype=torch.float32)),
                          dtype=torch.float32, device=fleet.t_sync.device),
        lam_global=lam_f.sum())
