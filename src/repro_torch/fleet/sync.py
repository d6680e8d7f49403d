"""Bounded-staleness sync: reconciling S stale frontend views.

The paper's frontends "need only synchronize the estimates of worker
speeds regularly" (§5). This module is that synchronisation, at a cadence
the caller sets (the staleness bound), in two forms with one semantics:

  * the simulator's round-based fold (``sync_sim_views``), where the true
    worker state is at hand: every frontend's queue snapshot reconciles to
    the true queues, its own-placement delta clears, its μ̂ view adopts the
    current central estimate with one alias table built for all, and the
    per-frontend λ̂ streams merge into the fleet's ``lam_global = Σ_f λ̂_f``
    (each frontend sees ~λ/S of the arrivals, so the sum estimates λ);

  * the collective form over a ``FrontendMesh`` (one process a rank, a
    ``torch.distributed`` group between them), where no one holds the true
    state: the global queue view is the agreed snapshot plus the all-reduced
    per-frontend deltas ``q_view - q_snap``, μ̂ merges as the mean of the
    frontends' rows, and the λ̂ streams are gathered so every frontend knows
    the fleet's (kept per frontend; only their sum is adopted).

Between syncs the frontends run free of coordination: ``make_fleet_step``
places a batch against the rank's own stale view and runs no collective;
the caller fires ``make_fleet_sync``'s function every ``sync_every``
steps, so reduced coordination removes the collectives from the hot path.
``make_fleet_serve_stage`` and ``make_fleet_scan_sync`` are the same two
halves for the one-program fleet turn (``serving.scanloop``), on a rank's
local rows of S / D frontends; with no mesh they are the stacked turn's.

Float merges gather the ranks' rows and reduce them in frontend order, as
the stacked fleet turn reduces its [S, n] rows, so a mesh of any size gives
the stacked run's bits; integer deltas all-reduce exactly.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import dispatch as dsp
from repro_torch.core import estimator as est
from repro_torch.core import learner as lrn
from repro_torch.core import policies as pol
from repro_torch.core import scheduler as rs
from repro_torch.fleet.state import (FleetFrontend, FleetSimState, fleet_lam_hats,
                                     frontend_shard_table)

#: the collectives a sync round runs (``FrontendMesh.counts`` keys): the
#: queue deltas' all-reduce, the μ̂ and λ̂ rows' gathers, the view gaps'
#: gather; no other collective belongs to the scheduler
SYNC_KINDS = ("sync_q", "sync_mu", "sync_lam", "sync_gaps")


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


# ---------------------------------------------------------------------------
# The mesh: one process a rank over a torch.distributed group
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class FrontendMesh:
    """The frontends' mesh, the counterpart of ``jax.make_mesh((D,),
    ("sched",))``: the process group, this process's rank, the world size
    D and the device its tensors live on (gloo on the CPU, NCCL on a CUDA
    device). Rank r holds the frontend rows ``[r·Sl, (r+1)·Sl)`` of an
    S-frontend fleet, Sl = S / D (``rows``).

    ``counts`` tallies the collectives by kind as they are issued (a CUDA
    graph issues its captured collectives at each replay: the fleet runner
    adds them there). ``close`` destroys a group the mesh made."""

    group: object
    rank: int
    size: int
    device: torch.device
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    owns_group: bool = False

    def rows(self, S: int) -> tuple[int, int]:
        """(first row, Sl): this rank's share of S frontend rows."""
        if S % self.size:
            raise ValueError(f"S={S} frontends do not divide over a mesh of {self.size}")
        Sl = S // self.size
        return self.rank * Sl, Sl

    def check_device(self, t: torch.Tensor) -> None:
        if t.device.type != self.device.type:
            raise ValueError(f"a {t.device} tensor on a mesh of {self.device} "
                             f"({dist.get_backend(self.group)})")

    def all_reduce_sum(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor; integers exactly)."""
        self.check_device(t)
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        self.counts[kind] += 1
        return out

    def all_gather_rows(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Every rank's ``t`` stacked along dim 0 in rank order: local
        frontend rows become the fleet's rows in frontend order."""
        self.check_device(t)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        self.counts[kind] += 1
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place."""
        self.check_device(t)
        dist.broadcast(t, src=dist.get_global_rank(self.group, 0), group=self.group)
        self.counts[kind] += 1
        return t

    def close(self) -> None:
        if self.owns_group:
            dist.destroy_process_group(self.group)
            self.owns_group = False

    def __enter__(self) -> "FrontendMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def file_store_mesh(path, rank: int, size: int, device=None,
                    timeout_s: float = 120.0) -> FrontendMesh:
    """Join a ``size``-rank mesh as ``rank`` through a ``FileStore`` at
    ``path`` (a file every rank names and none has used; no port, no
    network). The backend follows the device: NCCL for CUDA (``None`` is
    the card), gloo for the CPU. The group is the process's default group;
    a group that cannot be made raises, with no fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a gloo mesh")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    store = dist.FileStore(os.fspath(path), size)
    kw = dict(device_id=dev) if dev.type == "cuda" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return FrontendMesh(group=dist.group.WORLD, rank=rank, size=size, device=dev,
                        owns_group=True)


def _all_reduce_sum(mesh, t, kind):
    return t if mesh is None else mesh.all_reduce_sum(t, kind)


def _gather_rows(mesh, t, kind):
    return t if mesh is None else mesh.all_gather_rows(t, kind)


# ---------------------------------------------------------------------------
# The collective sync: one frontend a rank
# ---------------------------------------------------------------------------


def _sync_collective_core(mesh: FrontendMesh | None, q_local, q_snap, mu_local, lam_local):
    """The sync round's collectives over a rank's LOCAL frontend rows
    (``[Sl, ...]``): global queues = snapshot + the all-reduced sum of the
    per-frontend deltas, clamped at 0; merged μ̂ = the mean of every
    frontend's row, gathered in frontend order; λ̂ streams gathered in
    frontend order. ``mesh=None`` is the stacked fleet (every row local).
    Returns (total_q i32[n], mu_merged f32[n], lam_all f32[S])."""
    delta = (q_local - q_snap[None]).sum(0, dtype=torch.int32)
    total = (q_snap + _all_reduce_sum(mesh, delta, "sync_q")).clamp(min=0)
    mu_merged = lrn.sync_estimates(_gather_rows(mesh, mu_local, "sync_mu"))
    lam_all = _gather_rows(mesh, lam_local, "sync_lam")
    return total, mu_merged, lam_all


def sync_frontend_shard(mesh: FrontendMesh, ff: FleetFrontend, now,
                        active: torch.Tensor | None = None) -> FleetFrontend:
    """This rank's frontend's half of the fleet sync. Global queue view =
    agreed snapshot + Σ_f (own view − own snapshot): each frontend's delta
    is what it did since the last agreement, so the sum rebuilds the
    outstanding work without any frontend observing the workers. μ̂ merges
    by the mean (paper §5); λ̂ streams stay per frontend, their gathered sum
    is adopted as the fleet's arrival rate. Every rank rebuilds the frozen
    alias table from the same merged μ̂ (masked by ``active`` bool[n] under
    churn), so the tables agree with no further collective."""
    dev = ff.core.q_view.device
    lam = torch.tensor([float(est.lam_hat_ema(ff.core.arr))], dtype=torch.float32, device=dev)
    total, mu, lam_all = _sync_collective_core(mesh, ff.core.q_view[None], ff.q_snap,
                                               ff.core.learner.mu_hat[None], lam)
    core = ff.core.replace(q_view=total, learner=ff.core.learner.replace(mu_hat=mu))
    table = dsp.build_alias_table(mu, active)
    return ff.replace(core=core, q_snap=total, alias_p=table.prob, alias_a=table.alias,
                      lam_global=lam_all.sum(), t_sync=np.float32(now))


def make_fleet_step(mesh: FrontendMesh, m: int, policy: str = pol.PPOT_SQ2,
                    use_alias: bool = True):
    """The coordination-free fleet step on this rank: ``fn(ff, key, now) ->
    (workers[m], ff')`` places the rank's batch through the dispatch engine
    against its own stale view and clock, with no collective; staleness
    accrues until the caller fires ``make_fleet_sync``'s function. With
    ``use_alias`` the μ̂-proportional probes draw through the frontend's
    frozen alias table, rebuilt only by the sync."""

    def fn(ff: FleetFrontend, key, now):
        mesh.check_device(ff.core.q_view)
        tbl = frontend_shard_table(ff) if use_alias else None
        workers, core = rs.schedule(ff.core, key, now, m, policy, tbl)
        return workers, ff.replace(core=core)

    return fn


def make_fleet_sync(mesh: FrontendMesh, masked: bool = False):
    """The fleet sync on this rank: ``fn(ff, now) -> ff'`` (the delta-
    reconciled queue view, merged μ̂, gathered λ̂). Fire it every
    ``sync_every`` steps: that cadence is the staleness bound.
    ``masked=True`` is the churn form ``fn(ff, now, active)`` with the
    membership mask bool[n]: every rank's frozen table is rebuilt masked,
    so no frontend probes an offline worker until the next sync."""
    if masked:
        def fn(ff: FleetFrontend, now, active: torch.Tensor):
            return sync_frontend_shard(mesh, ff, now, active)
    else:
        def fn(ff: FleetFrontend, now):
            return sync_frontend_shard(mesh, ff, now)
    return fn


# ---------------------------------------------------------------------------
# The one-program fleet turn's stages, on a rank's local rows
# ---------------------------------------------------------------------------


def make_fleet_serve_stage(mesh: FrontendMesh | None, m: int, policy: str, *,
                           max_fake: int = 8, use_fresh_mu: bool = True,
                           use_alias: bool = True, churn: bool = False):
    """The fleet turn's SERVE stage, free of coordination: each of the
    rank's local frontend rows runs ``scheduler.serve_step_device`` (the
    reference's ``serve_step_fleet``, row by row), with no collective.
    ``fn(q, learners, arr, mu_front, keys, comp_w, comp_t, last_fake,
    comp_now, now, lcfg, tables, mask) -> (fake_js, workers, q', learner
    fields, arr', keys')``: ``learners`` a list of the rows' learner states,
    ``arr`` the rows' device estimator ([Sl] fields), ``tables`` the rows'
    frozen alias tables ([Sl, n]) or None, ``mask`` the membership (read
    only with ``churn``); the outputs are stacked [Sl, ...] (the learner as
    a dict of fields, the estimator as a list of rows)."""
    del mesh  # the serve stage runs no collective

    def fn(q, learners, arr, mu_front, keys, comp_w, comp_t, last_fake, comp_now, now, lcfg,
           tables, mask):
        outs = [rs.serve_step_device(
            q[s], learners[s], est.EmaArrivalState(arr.last_time[s], arr.mean_gap[s],
                                                   arr.count[s]),
            lcfg, keys[s], comp_w[s], comp_t[s], (now, last_fake[s], comp_now[s]), m, policy,
            max_fake, use_alias, mask if churn else None,
            mu_hat=None if use_fresh_mu else mu_front[s],
            table=(dsp.AliasTable(tables.prob[s], tables.alias[s])
                   if tables is not None and not use_fresh_mu else None))
            for s in range(len(learners))]
        fake_js, workers, q2 = (torch.stack([o[j] for o in outs]) for j in range(3))
        learner = {f.name: torch.stack([getattr(o[3], f.name) for o in outs])
                   for f in dataclasses.fields(lrn.LearnerState)}
        return fake_js, workers, q2, learner, [o[4] for o in outs], torch.stack(
            [o[5] for o in outs])

    return fn


def make_fleet_scan_sync(mesh: FrontendMesh | None):
    """The fleet turn's SYNC stage: reconcile the rank's local stale views
    through ``_sync_collective_core`` (the same pattern as
    ``sync_frontend_shard``) after the herd corrections unwind
    (corrections are a routing bias, not state), with the view gaps of
    every frontend. Called only on sync turns, so its collectives run only
    there. ``fn(q_view, herd_applied, q_snap, mu_hat, lam_hat) -> (global_q
    i32[n], mu_merged f32[n], gaps i32[S], lam_sum f32)`` on the local rows
    ([Sl, n], [Sl]); ``mesh=None`` is the stacked turn."""

    def fn(q_view, herd_applied, q_snap, mu_hat, lam_hat):
        qs = q_view - herd_applied
        global_q, mu_merged, lam_all = _sync_collective_core(mesh, qs, q_snap, mu_hat,
                                                             lam_hat)
        gaps = _gather_rows(mesh, (qs - global_q[None]).abs().sum(1, dtype=torch.int32),
                            "sync_gaps")
        return global_q, mu_merged, gaps, lam_all.sum()

    return fn
