"""The port's collective fleet over D gloo ranks on the CPU, for
tests/test_torch_fleet_mesh.py.

``python tests/torch_mesh_ranks.py D OUT`` starts D rank processes (spawn)
that meet through a ``FileStore`` in a fresh temporary directory, runs on
every rank the sharded scheduler, the fleet step and sync at S = D, and the
mesh fleet scan at S = 4 for each case of ``SCAN_CASES`` (``scan_case``,
which the test also runs with no mesh), and writes every rank's results to
the JSON file OUT (a list, rank order). The launcher waits
``RANK_TIMEOUT_S`` at most for its ranks and ends any still running; the
test kills the launcher itself at its own limit. Imports no jax.
"""
import json
import multiprocessing
import os
import sys
import tempfile
import traceback

#: the mesh fleet scan cases: tests/test_fleet_scan.py's cell (n = 4, KW) on
#: both probe streams at sync 1 and with frozen μ̂ at sync 4, and three
#: registry scenarios (n = 5, 360 s) for the fault subset with telemetry,
#: churn's table rebuilds under frozen μ̂, and per-frontend herd gains
SCAN_CASES = {
    "alias sync 1": dict(use_alias=True),
    "icdf sync 1": dict(use_alias=False),
    "alias sync 4 frozen": dict(use_alias=True, sync_every=4, frozen_mu=True),
    "crash_storm telemetry": dict(scenario="crash_storm", observe=True),
    "churn_heavy sync 4 frozen": dict(scenario="churn_heavy", sync_every=4, frozen_mu=True),
    "cotenant_shock sync 4 herd": dict(scenario="cotenant_shock", sync_every=4,
                                       herd_correction=(1.0, 0.0, 0.5, 1.0)),
}
SPEEDS = (0.25, 0.5, 1.0, 2.0)
SCAN_KW = dict(arrival_rate=3.0, horizon=80.0, seed=1, arrival_batch=8)
SCAN_S = 4
RANK_TIMEOUT_S = 150.0


def _floats(t) -> list:
    """A tensor or array as a list of Python numbers (floats round-trip
    through JSON exactly)."""
    import numpy as np

    return np.asarray(t.cpu() if hasattr(t, "cpu") else t).tolist()


def scheduler_runs(mesh, S: int) -> dict:
    """The sharded scheduler and the fleet step/sync on this rank, S = D
    frontends over 8 workers, tests/test_dispatch.py's schedule."""
    import numpy as np

    from repro_torch.core import learner as lrn
    from repro_torch.core import scheduler as rs
    from repro_torch.fleet import init_fleet_frontends, make_fleet_step, make_fleet_sync
    from repro_torch.utils import prng

    r = mesh.rank
    lcfg = lrn.default_learner_config(mu_bar=8.0)
    state = rs.init_rosella_shards(S, 8, lcfg, device="cpu")[r]
    fn = rs.make_sharded_schedule(mesh, m=16)
    sched_workers = []
    for i in range(3):
        key = prng.split(prng.fold_in(prng.PRNGKey(0), i), S)[r]
        workers, state = fn(state, key, 1.0 + i)
        sched_workers.append(_floats(workers))
    out = dict(sched_workers=sched_workers, sched_q=_floats(state.q_view),
               sched_mu=_floats(state.learner.mu_hat))

    ff = init_fleet_frontends(S, 8, lcfg, device="cpu")[r]
    step, sync = make_fleet_step(mesh, m=16), make_fleet_sync(mesh)
    before = dict(mesh.counts)
    fleet_workers = []
    for i in range(4):
        key = prng.split(prng.fold_in(prng.PRNGKey(1), i), S)[r]
        w, ff = step(ff, key, float(np.float32(r + 1) * np.float32(i + 1)))
        fleet_workers.append(_floats(w))
    step_collectives = {k: v - before.get(k, 0) for k, v in mesh.counts.items()
                        if v != before.get(k, 0)}
    out.update(
        fleet_workers=fleet_workers, q_pre=_floats(ff.core.q_view),
        mu_pre=_floats(ff.core.learner.mu_hat), q_snap_pre=_floats(ff.q_snap),
        mean_gap_pre=float(ff.core.arr.mean_gap), step_collectives=step_collectives)
    ff = sync(ff, 99.0)
    out.update(
        q_post=_floats(ff.core.q_view), mu_post=_floats(ff.core.learner.mu_hat),
        alias_p=_floats(ff.alias_p), alias_a=_floats(ff.alias_a),
        mean_gap_post=float(ff.core.arr.mean_gap), lam_global=float(ff.lam_global),
        t_sync=float(ff.t_sync), q_snap_post=_floats(ff.q_snap))
    return out


def scan_case(case: str, mesh=None) -> dict:
    """One case of SCAN_CASES through the fleet scan, on ``mesh`` (None: the
    stacked fleet): everything the run returns, as JSON values."""
    import numpy as np

    from repro_torch import env as tenv
    from repro_torch import obs
    from repro_torch.serving import router as tr
    from repro_torch.serving import scanloop as tsl

    opts = dict(SCAN_CASES[case])
    name = opts.pop("scenario", None)
    kw = dict(sync_every=opts.get("sync_every", 1), frozen_mu=opts.get("frozen_mu", False),
              mesh=mesh)
    if name is None:
        speeds = np.asarray(SPEEDS)
        router = tr.FleetRouter(SCAN_S, len(speeds), mu_bar=float(speeds.sum()), seed=0,
                                async_mu=False, use_alias=opts["use_alias"], device="cpu")
        pool = tr.SequentialPool(speeds)
        resp, mu, info = tsl.run_fleet_simulation_scan(router, pool, **kw, **SCAN_KW)
    else:
        scn = tenv.make(name)
        speeds = np.asarray(scn.speeds, float)
        router = tr.FleetRouter(SCAN_S, scn.n, mu_bar=float(speeds.sum()), seed=0,
                                async_mu=False, device="cpu",
                                herd_correction=list(opts.get("herd_correction", ())) or False)
        pool = tr.SequentialPool(speeds)
        wl = scn.compile_serving(seed=0, arrival_batch=8)
        ocfg = (obs.ObserveConfig(window_turns=8, detect=obs.DetectConfig(warmup_windows=4))
                if opts.get("observe") else None)
        resp, mu, info = tsl.run_fleet_workload_scan(
            router, pool, wl.times, wl.costs, wl.speeds, active_np=wl.active,
            rejoin_np=wl.rejoin, burst_np=wl.burst, fake_cost=scn.request_cost * 0.25,
            kill_np=wl.kill_at, stall_np=wl.stall_at, stall_dur_np=wl.stall_dur,
            observe=ocfg, **kw)
    out = dict(
        resp=_floats(resp), mu=_floats(mu), workers=_floats(info["workers"]),
        epochs=_floats(info["epochs"]), gaps=_floats(info["sync_gaps"]),
        frontends=_floats(info["frontends"]), lam_hats=_floats(info["lam_hats"]),
        free_at=_floats(pool.free_at), turns=info["turns"], ledger=info.get("ledger"),
        windows=info.get("windows"), windows_frontends=info.get("windows_frontends"),
        q_view=[_floats(fr.q_view) for fr in router.frontends],
        mu_hat=[_floats(fr.learner.mu_hat) for fr in router.frontends],
        mu_front=[_floats(fr.mu_front) for fr in router.frontends],
        key=[list(fr.key) for fr in router.frontends],
        snap=_floats(router._snap), lam_global=float(router.lam_global),
        herd_applied=_floats(router._herd_applied))
    if mesh is not None:
        out["collectives"] = info["collectives"]
    return json.loads(json.dumps(out))


def rank_main(rank: int, size: int, store: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    from repro_torch.fleet import file_store_mesh

    try:
        with file_store_mesh(store, rank, size, "cpu", timeout_s=RANK_TIMEOUT_S) as mesh:
            res = dict(rank=rank, size=size, **scheduler_runs(mesh, size),
                       scans={case: scan_case(case, mesh) for case in SCAN_CASES})
    except Exception:  # the launcher reports a rank's failure with its traceback
        res = dict(rank=rank, size=size, error=traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def main(size: int, out: str) -> int:
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=rank_main, args=(r, size, store, tmp)) for r in range(size)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(RANK_TIMEOUT_S)
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        ranks = []
        for r in range(size):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
            else:
                ranks.append(dict(rank=r, size=size, error=f"no result (late ranks: {late})"))
    with open(out, "w") as f:
        json.dump(ranks, f)
    return 0 if not late and all("error" not in r for r in ranks) else 1


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), sys.argv[2]))
