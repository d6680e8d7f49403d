"""Per-frontend fleet state: S parallel schedulers with stale queue views.

Each of the paper's distributed frontends (§5) keeps local state the rest
of the fleet does not see between synchronisations:

  * an arrival estimator over its own λ̂ stream (each frontend observes
    only the arrivals routed through it, roughly λ/S);
  * a stale snapshot of the worker queues (``q_snap``, the cluster as of
    the last sync) plus its own placements since that sync (``q_delta``):
    its dispatch view is ``q_snap + q_delta``, blind to every other
    frontend's work. The serving ``FleetRouter`` drains the placing
    frontend's view as soon as a job completes (workers report to the
    frontend that placed the job); the simulator form below batches the
    completion reports to the next sync, a harsher staleness regime;
  * a μ̂ view frozen at the last sync, with its alias table.

Three layouts live here. ``FleetSimState`` is the simulator's stacked
form: every field carries a leading frontend axis of size S, and a frontend
is updated with a masked select, no per-frontend Python. ``FleetServeCarry``
is the serving fleet's whole state as the one-program fleet turn carries
it (``serving.scanloop``): S full routers plus the fleet's sync agreement.
``FleetFrontend`` is one frontend of the collective fleet
(``fleet.sync.make_fleet_step`` / ``make_fleet_sync``), the state one
process of a ``fleet.sync.FrontendMesh`` holds for itself.

Tensors live on the caller's device; the λ̂ streams are the estimator's
device form (0-d tensors become [S] vectors).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dispatch as dsp
from repro_torch.core import estimator as est
from repro_torch.core import learner as lrn
from repro_torch.core import scheduler as rs
from repro_torch.utils.device import resolve_device

#: EMA window of the per-frontend arrival estimators: the serving router's
#: own, so per-frontend and single-frontend estimates compare at S = 1.
FLEET_ARR_WINDOW = est.EMA_ARR_WINDOW


@dataclasses.dataclass(frozen=True)
class FleetSimState:
    """Stacked fleet state for the simulator (leading axis = frontend)."""

    q_snap: torch.Tensor  # i32[S, n] queue snapshot at each frontend's last sync
    q_delta: torch.Tensor  # i32[S, n] own placements since that sync
    mu_view: torch.Tensor  # f32[S, n] μ̂ view frozen at the last sync
    alias_p: torch.Tensor  # f32[S, n] alias-table thresholds for mu_view, built
    # at sync and used by every dispatch until the next
    alias_a: torch.Tensor  # i32[S, n] alias-table partners for mu_view
    arr: est.EmaArrivalState  # per-frontend λ̂ EMA, device form (fields [S])
    t_sync: torch.Tensor  # f32[S] time of each frontend's last sync
    lam_global: torch.Tensor  # f32 0-d merged fleet λ̂ (Σ_f λ̂_f at the last sync)

    def replace(self, **kw) -> "FleetSimState":
        return dataclasses.replace(self, **kw)


def _rows(v: torch.Tensor, S: int) -> torch.Tensor:
    """``v`` repeated on a new leading axis of S rows (its own storage)."""
    return v[None].expand(S, *v.shape).contiguous()


def init_fleet_sim(S: int, n: int, mu_view0, device=None) -> FleetSimState:
    """S fresh frontends over n workers, every view frozen at ``mu_view0``
    (a scalar or f32[n]) with its alias table. ``device=None`` is the CUDA
    card and raises without one."""
    dev = resolve_device(device)
    mu0 = torch.as_tensor(mu_view0, dtype=torch.float32, device=dev).expand(n).contiguous()
    t0 = dsp.build_alias_table(mu0)
    f32 = dict(dtype=torch.float32, device=dev)
    return FleetSimState(
        q_snap=torch.zeros((S, n), dtype=torch.int32, device=dev),
        q_delta=torch.zeros((S, n), dtype=torch.int32, device=dev),
        mu_view=_rows(mu0, S), alias_p=_rows(t0.prob, S), alias_a=_rows(t0.alias, S),
        arr=est.EmaArrivalState(last_time=torch.zeros(S, **f32),
                                mean_gap=torch.zeros(S, **f32),
                                count=torch.zeros(S, dtype=torch.int32, device=dev)),
        t_sync=torch.zeros(S, **f32), lam_global=torch.zeros((), **f32))


def frontend_view(fleet: FleetSimState, f: int) -> torch.Tensor:
    """Frontend ``f``'s dispatch view: stale snapshot + own in-flight work."""
    return fleet.q_snap[f] + fleet.q_delta[f]


def frontend_table(fleet: FleetSimState, f: int) -> dsp.AliasTable:
    """Frontend ``f``'s frozen alias table (matches ``mu_view[f]``)."""
    return dsp.AliasTable(prob=fleet.alias_p[f], alias=fleet.alias_a[f])


def fold_own_placements(fleet: FleetSimState, f: int, counts: torch.Tensor) -> FleetSimState:
    """Fold frontend ``f``'s placement histogram into its own delta."""
    q_delta = fleet.q_delta.clone()
    q_delta[f] += counts.to(q_delta.dtype)
    return fleet.replace(q_delta=q_delta)


def observe_frontend_arrival(fleet: FleetSimState, f: int, now, m: int = 1) -> FleetSimState:
    """Update only frontend ``f``'s λ̂ stream: the EMA step runs over the
    stacked [S] fields, then every row except ``f`` keeps its old value."""
    S = fleet.t_sync.shape[0]
    upd = est.observe_arrivals_ema(fleet.arr, now, m, window=FLEET_ARR_WINDOW)
    sel = torch.arange(S, device=fleet.t_sync.device) == f
    arr = est.EmaArrivalState(*(torch.where(sel, new, old) for new, old in zip(
        (upd.last_time, upd.mean_gap, upd.count),
        (fleet.arr.last_time, fleet.arr.mean_gap, fleet.arr.count))))
    return fleet.replace(arr=arr)


def fleet_lam_hats(fleet: FleetSimState) -> torch.Tensor:
    """Per-frontend λ̂ estimates, f32[S]."""
    return est.lam_hat_ema(fleet.arr)


@dataclasses.dataclass(frozen=True)
class FleetFrontend:
    """One frontend of the collective fleet: the runtime scheduler state
    (whose ``q_view`` is this frontend's stale view, the snapshot agreed at
    the last sync plus its own placements since) and what the sync needs to
    rebuild the global queues from per-frontend deltas."""

    core: rs.RosellaState
    q_snap: torch.Tensor  # i32[n] the view agreed at the last sync
    alias_p: torch.Tensor  # f32[n] frozen alias table (thresholds) of the merged μ̂
    # adopted at the last sync: the coordination-free step samples through
    # it, and only the sync rebuilds it
    alias_a: torch.Tensor  # i32[n] frozen alias table (partners)
    lam_global: torch.Tensor  # f32 0-d merged fleet λ̂ from the last sync
    t_sync: np.float32  # time of the last sync

    def replace(self, **kw) -> "FleetFrontend":
        return dataclasses.replace(self, **kw)


def frontend_shard_table(ff: FleetFrontend) -> dsp.AliasTable:
    """The frontend's frozen alias table (the μ̂ of its last sync)."""
    return dsp.AliasTable(prob=ff.alias_p, alias=ff.alias_a)


def init_fleet_frontends(S: int, n: int, lcfg: lrn.LearnerConfig, mu_init: float = 1.0,
                         device=None) -> list[FleetFrontend]:
    """S fresh frontends, in frontend order: rank r of a mesh with one
    frontend a rank takes entry r. ``device=None`` is the CUDA card and
    raises without one."""

    def one() -> FleetFrontend:
        core = rs.init_rosella(n, lcfg, mu_init, device)
        t0 = dsp.build_alias_table(core.learner.mu_hat)
        dev = core.q_view.device
        return FleetFrontend(core=core, q_snap=torch.zeros(n, dtype=torch.int32, device=dev),
                             alias_p=t0.prob, alias_a=t0.alias,
                             lam_global=torch.zeros((), dtype=torch.float32, device=dev),
                             t_sync=np.float32(0.0))

    return [one() for _ in range(S)]


@dataclasses.dataclass
class FleetServeCarry:
    """The serving fleet's whole state as the one-program fleet turn carries
    it: S full routers (each frontend's stale queue view, learner rings,
    λ̂ stream, key, μ̂ front buffer with its pending flag, frozen alias
    table, herd-correction bookkeeping) plus the fleet's sync agreement
    (``q_snap``, ``t_sync``, ``lam_global``). Every per-frontend field has
    a leading frontend axis S."""

    q_view: torch.Tensor  # i32[S, n] per-frontend stale views (snapshot + own work)
    learner: lrn.LearnerState  # per-frontend learners (fields [S, ...])
    arr: est.EmaArrivalState  # per-frontend λ̂ EMA streams, device form ([S])
    key: torch.Tensor  # i64[S, 2] per-frontend keys
    mu_front: torch.Tensor  # f32[S, n] per-frontend μ̂ routing snapshots
    mu_pend: torch.Tensor  # bool[S] a refreshed μ̂ is pending (the host router's
    # ``_mu_pending is not None``: with async_mu=False the pending value is
    # always the frontend's own learner μ̂, so a flag reproduces the buffer)
    tables: dsp.AliasTable | None  # frozen per-frontend tables ([S, n]); None
    # where routing rebuilds its table from the fresh μ̂ each turn
    herd_scale: torch.Tensor  # f32[S] per-frontend herd-correction gain
    herd_applied: torch.Tensor  # i32[S, n] corrections folded into q_view
    last_fake: torch.Tensor  # f32[S] per-frontend benchmark-job clocks
    q_snap: torch.Tensor  # i32[n] the agreed global view at the last sync
    t_sync: torch.Tensor  # f32 0-d time of the last sync round
    lam_global: torch.Tensor  # f32 0-d fleet arrival-rate estimate (Σ_f λ̂_f)


def fleet_serve_carry(router, device, frozen_tables: bool) -> FleetServeCarry:
    """A ``serving.router.FleetRouter``'s state stacked on ``device``; its
    frontends' alias tables when ``frozen_tables``."""
    frs = router.frontends
    dev = torch.device(device)

    def stack(vals, dtype=None):
        return torch.stack([torch.as_tensor(v).to(dev) for v in vals]).to(
            dtype or torch.as_tensor(vals[0]).dtype)

    learner = lrn.LearnerState(**{f.name: stack([getattr(fr.learner, f.name) for fr in frs])
                                  for f in dataclasses.fields(lrn.LearnerState)})
    arr = est.EmaArrivalState(
        last_time=torch.tensor([float(fr.arr.last_time) for fr in frs], dtype=torch.float32,
                               device=dev),
        mean_gap=torch.tensor([float(fr.arr.mean_gap) for fr in frs], dtype=torch.float32,
                              device=dev),
        count=torch.tensor([int(fr.arr.count) for fr in frs], dtype=torch.int32, device=dev))
    tables = None
    if frozen_tables:
        tables = dsp.AliasTable(prob=stack([fr.table_front.prob for fr in frs]),
                                alias=stack([fr.table_front.alias for fr in frs]))
    return FleetServeCarry(
        q_view=stack([fr.q_view for fr in frs]), learner=learner, arr=arr,
        key=torch.tensor([list(fr.key) for fr in frs], dtype=torch.int64, device=dev),
        mu_front=stack([fr.mu_front for fr in frs]),
        mu_pend=torch.tensor([fr._mu_pending is not None for fr in frs], device=dev),
        tables=tables,
        herd_scale=torch.from_numpy(np.asarray(router.herd_scale, np.float32)).to(dev),
        herd_applied=torch.from_numpy(np.asarray(router._herd_applied).astype(np.int32)).to(dev),
        last_fake=torch.tensor([float(np.float32(fr.last_fake_time)) for fr in frs],
                               dtype=torch.float32, device=dev),
        q_snap=torch.from_numpy(np.asarray(router._snap).astype(np.int32)).to(dev),
        t_sync=torch.tensor(float(np.float32(router.t_sync)), dtype=torch.float32, device=dev),
        lam_global=torch.tensor(float(np.float32(router.lam_global)), dtype=torch.float32,
                                device=dev))
