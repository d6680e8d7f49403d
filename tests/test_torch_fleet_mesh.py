"""The port's collective fleet (``repro_torch.fleet.sync``: ``FrontendMesh``,
``make_fleet_step`` / ``make_fleet_sync``, the fleet turn's stages;
``core.scheduler.make_sharded_schedule``; the fleet scan's ``mesh=``) on
the CPU over gloo, through a ``FileStore`` rendezvous.

(a) In this process, one rank: the fleet step and sync (plain and masked,
tests/test_env.py:312's case) and the sharded scheduler against the
reference's on a one-device mesh, on the same inputs (random μ̂ rows drawn
with numpy): placements, queue views, the frozen alias tables, λ̂ and μ̂
equal.
(b) D = 2 and 4 gloo ranks, spawned by ``torch_mesh_ranks.py`` (one launch a
world size, killed after ``LAUNCH_TIMEOUT_S``; the module shares the runs):
tests/test_dispatch.py:208-286's properties at S = D (views part before a
sync and agree after it, the total is 4·S·16, the λ̂ streams are distinct
and kept, ``lam_global`` is their sum), and every rank's step, sync and
sharded schedule equal to the port's own stacked computation.
(c) The fleet scan with ``mesh=`` at D = 1, 2 and 4, S = 4, for each of
``torch_mesh_ranks.SCAN_CASES`` (tests/test_fleet_scan.py's router and
``KW`` on both probe streams at sync 1 and with frozen μ̂ at sync 4;
crash_storm with telemetry, churn_heavy with frozen μ̂, cotenant_shock with
herd gains): equal bit for bit to the port's stacked fleet scan on every
rank, in everything the run returns; the sync collectives run on sync
turns only. At D = 1 against the reference's one-device mesh scan on the
``KW`` cell at test_torch_fleet_scan.py's bars (responses, placements,
gaps equal; μ̂ exact until ``EXACT_MU_TURNS``, within ``MU_ULPS`` after).

The reference's mesh paths run under jax 0.9.0 only with two shims local to
the ``ref`` fixture: the ``enable_x64`` alias the port's scan tests use, and
``jax.shard_map`` with ``check_vma=False`` (ROADMAP queue C).
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import collections
import functools
import json
import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.core import dispatch as tdsp
from repro_torch.core import estimator as t_est
from repro_torch.core import learner as tlrn
from repro_torch.core import scheduler as trs
from repro_torch.fleet import state as tst
from repro_torch.fleet import sync as tsync
from repro_torch.utils import prng

REPO = pathlib.Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT_S = 180
WORLDS = (2, 4)
MU_ULPS = 8  # the learner's refresh sums (test_torch_fleet_scan)
#: the turn at which the port's μ̂ trace parts from the reference's on the
#: KW cell, measured at seed 1 in every case of CASES (the responses stay equal)
EXACT_MU_TURNS = 9
N_STEP = 8  # workers of the fleet step cases
M = 16  # jobs a rank places a step


def ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A one-rank gloo mesh in this process, through a FileStore."""
    path = tmp_path_factory.mktemp("mesh1") / "store"
    with tsync.file_store_mesh(path, 0, 1, "cpu", timeout_s=60) as mesh:
        yield mesh


@pytest.fixture(scope="module")
def ref():
    """The reference's fleet and mesh paths under jax 0.9.0: its scan loop
    imports ``jax.experimental.enable_x64`` (now ``jax.enable_x64(True)``)
    and its shard_maps fail the varying-axes check without
    ``check_vma=False``; both patched for this module only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                   raising=False)
        mp.setattr(jax, "shard_map", functools.partial(jax.shard_map, check_vma=False))
        from repro.core import learner as jlrn
        from repro.core import scheduler as jrs
        from repro.fleet import init_fleet_frontends, make_fleet_step, make_fleet_sync
        from repro.serving import FleetRouter, SequentialPool, run_fleet_simulation_scan

        yield dict(lrn=jlrn, rs=jrs, init=init_fleet_frontends, step=make_fleet_step,
                   sync=make_fleet_sync, FleetRouter=FleetRouter,
                   SequentialPool=SequentialPool, scan=run_fleet_simulation_scan,
                   mesh=jax.make_mesh((1,), ("sched",)))


def _launch(D: int, out: pathlib.Path) -> list:
    """One launch of D gloo ranks; its session is killed at LAUNCH_TIMEOUT_S."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_mesh_ranks.py"),
                             str(D), str(out)], cwd=REPO, env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        log, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the {D}-rank launch ran over {LAUNCH_TIMEOUT_S} s and was killed")
    res = json.loads(out.read_text()) if out.exists() else []
    errors = [r["error"] for r in res if "error" in r]
    assert proc.returncode == 0 and len(res) == D and not errors, (log[-3000:], errors)
    return res


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank's results at D = 2 and 4: {D: [rank 0, ..., rank D-1]}."""
    tmp = tmp_path_factory.mktemp("ranks")
    return {D: _launch(D, tmp / f"d{D}.json") for D in WORLDS}


# ---------------------------------------------------------------------------
# (a) one rank in this process against the reference's one-device mesh
# ---------------------------------------------------------------------------


def _mu_rows(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(0.25, 4.0, n).astype(np.float32)


@pytest.mark.parametrize("use_alias", [True, False], ids=["alias", "icdf"])
def test_fleet_step_and_sync_equal_the_reference(mesh1, ref, use_alias):
    """Four coordination-free steps with the frontend's μ̂ set to random
    rows, then the sync at t = 99: placements and views after every step,
    and after the sync the view, snapshot, merged μ̂, alias tables, λ̂ and
    t_sync, equal to the reference's; no collective runs in a step."""
    mu0 = _mu_rows(N_STEP, 3)
    jff = ref["init"](1, N_STEP, ref["lrn"].default_learner_config(mu_bar=8.0))
    jff = jff.replace(core=jff.core.replace(learner=jff.core.learner.replace(
        mu_hat=jnp.asarray(mu0)[None])))
    jstep, jsync = ref["step"](ref["mesh"], m=M, use_alias=use_alias), ref["sync"](ref["mesh"])
    ff = tst.init_fleet_frontends(1, N_STEP, tlrn.default_learner_config(mu_bar=8.0),
                                  device="cpu")[0]
    ff = ff.replace(core=ff.core.replace(learner=ff.core.learner.replace(
        mu_hat=torch.from_numpy(mu0))))
    step, sync = tsync.make_fleet_step(mesh1, m=M, use_alias=use_alias), \
        tsync.make_fleet_sync(mesh1)
    before = mesh1.counts.copy()
    for i in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(1), i)
        jw, jff = jstep(jff, jax.random.split(key, 1), jnp.asarray([i + 1.0], jnp.float32))
        w, ff = step(ff, prng.split(prng.fold_in(prng.PRNGKey(1), i), 1)[0], float(i + 1))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw)[0])
        np.testing.assert_array_equal(ff.core.q_view.numpy(), np.asarray(jff.core.q_view)[0])
    assert mesh1.counts == before
    jff = jsync(jff, jnp.float32(99.0))
    ff = sync(ff, 99.0)
    assert all(mesh1.counts[k] == before[k] + 1 for k in ("sync_q", "sync_mu", "sync_lam"))
    for got, want in ((ff.core.q_view, jff.core.q_view), (ff.q_snap, jff.q_snap),
                      (ff.core.learner.mu_hat, jff.core.learner.mu_hat),
                      (ff.alias_p, jff.alias_p), (ff.alias_a, jff.alias_a)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])
    assert float(ff.lam_global) == float(np.asarray(jff.lam_global)[0]) > 0
    assert ff.t_sync == np.asarray(jff.t_sync)[0] == np.float32(99.0)
    assert int(ff.core.q_view.sum()) == 4 * M


def test_masked_fleet_sync_equals_the_reference(mesh1, ref):
    """tests/test_env.py:312's case: the masked sync zeroes the offline
    worker's probe mass; the port's tables equal the reference's, with
    random μ̂ too."""
    active = np.array([True, True, False, True])
    for mu0 in (None, _mu_rows(4, 5)):
        jff = ref["init"](1, 4, ref["lrn"].default_learner_config(4.0), mu_init=1.0)
        ff = tst.init_fleet_frontends(1, 4, tlrn.default_learner_config(4.0), mu_init=1.0,
                                      device="cpu")[0]
        if mu0 is not None:
            jff = jff.replace(core=jff.core.replace(learner=jff.core.learner.replace(
                mu_hat=jnp.asarray(mu0)[None])))
            ff = ff.replace(core=ff.core.replace(learner=ff.core.learner.replace(
                mu_hat=torch.from_numpy(mu0))))
        jout = ref["sync"](ref["mesh"], masked=True)(jff, jnp.float32(1.0), jnp.asarray(active))
        out = tsync.make_fleet_sync(mesh1, masked=True)(ff, 1.0, torch.from_numpy(active))
        prob, alias = out.alias_p.numpy(), out.alias_a.numpy()
        np.testing.assert_array_equal(prob, np.asarray(jout.alias_p)[0])
        np.testing.assert_array_equal(alias, np.asarray(jout.alias_a)[0])
        assert prob[2] == 0.0 and alias[2] != 2


def test_sharded_schedule_equals_the_reference(mesh1, ref):
    """Three batches through the every-call sync of ``make_sharded_schedule``
    on one rank: placements, view and μ̂ equal to the reference's."""
    jst = ref["rs"].init_rosella_shards(1, N_STEP, ref["lrn"].default_learner_config(8.0))
    jfn = ref["rs"].make_sharded_schedule(ref["mesh"], m=M)
    st = trs.init_rosella_shards(1, N_STEP, tlrn.default_learner_config(8.0), device="cpu")[0]
    fn = trs.make_sharded_schedule(mesh1, m=M)
    for i in range(3):
        jw, jst = jfn(jst, jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), i), 1),
                      jnp.float32(1.0 + i))
        w, st = fn(st, prng.split(prng.fold_in(prng.PRNGKey(0), i), 1)[0], 1.0 + i)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw)[0])
        np.testing.assert_array_equal(st.q_view.numpy(), np.asarray(jst.q_view)[0])
        np.testing.assert_array_equal(st.learner.mu_hat.numpy(),
                                      np.asarray(jst.learner.mu_hat)[0])
    assert int(st.q_view.sum()) == 3 * M


def test_mesh_refusals(mesh1):
    """A tensor of another device on the gloo mesh raises (nothing moves it
    to the CPU), and so do frontend rows that do not divide over the mesh."""
    with pytest.raises(ValueError, match="on a mesh of cpu"):
        mesh1.check_device(torch.empty(0, device="meta"))
    with pytest.raises(ValueError, match="do not divide"):
        tsync.FrontendMesh(mesh1.group, 0, 3, mesh1.device).rows(4)


# ---------------------------------------------------------------------------
# (b) D gloo ranks: the reference test's properties, and the stacked bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", WORLDS)
def test_spawned_fleet_keeps_the_reference_properties(spawned, D):
    """tests/test_dispatch.py:208-286 at S = D ranks."""
    rs_ = spawned[D]
    S = D
    for r in rs_:
        w = np.asarray(r["sched_workers"])
        assert w.shape == (3, M) and (w >= 0).all() and (w < N_STEP).all()
        assert r["step_collectives"] == {}
    q = np.asarray([r["sched_q"] for r in rs_])
    assert (q == q[0]).all()
    qpre = np.asarray([r["q_pre"] for r in rs_])
    qpost = np.asarray([r["q_post"] for r in rs_])
    assert (qpre != qpre[0]).any() and (qpost == qpost[0]).all()
    assert int(qpost[0].sum()) == 4 * S * M
    lam_pre = np.float32(1.0) / np.maximum(np.asarray([r["mean_gap_pre"] for r in rs_],
                                                      np.float32), np.float32(1e-9))
    lam_post = np.float32(1.0) / np.maximum(np.asarray([r["mean_gap_post"] for r in rs_],
                                                       np.float32), np.float32(1e-9))
    assert np.unique(np.round(lam_pre, 6)).size == S
    np.testing.assert_array_equal(lam_pre, lam_post)
    want = float(torch.from_numpy(lam_pre).sum())
    assert all(r["lam_global"] == want for r in rs_)


def _stacked_fleet(S: int) -> dict:
    """The port's stacked computation of the spawned ranks' fleet cases:
    S frontends stepped one after another, the sync's collective core with
    no mesh over the stacked rows, and the sharded scheduler's mean over
    the stacked states."""
    lcfg = tlrn.default_learner_config(mu_bar=8.0)
    states = trs.init_rosella_shards(S, N_STEP, lcfg, device="cpu")
    sched_w = [[] for _ in range(S)]
    for i in range(3):
        keys = prng.split(prng.fold_in(prng.PRNGKey(0), i), S)
        for r in range(S):
            w, states[r] = trs.schedule(states[r], keys[r], 1.0 + i, M)
            sched_w[r].append(w.tolist())
        mu = torch.stack([s.learner.mu_hat for s in states]).mean(0)
        q = torch.round(torch.stack([s.q_view.float() for s in states]).mean(0)).int()
        states = [s.replace(q_view=q, learner=s.learner.replace(mu_hat=mu)) for s in states]
    ffs = tst.init_fleet_frontends(S, N_STEP, lcfg, device="cpu")
    fleet_w = [[] for _ in range(S)]
    for i in range(4):
        keys = prng.split(prng.fold_in(prng.PRNGKey(1), i), S)
        for r in range(S):
            now = float(np.float32(r + 1) * np.float32(i + 1))
            w, core = trs.schedule(ffs[r].core, keys[r], now, M, table=tst.frontend_shard_table(
                ffs[r]))
            ffs[r] = ffs[r].replace(core=core)
            fleet_w[r].append(w.tolist())
    lam = torch.tensor([float(t_est.lam_hat_ema(f.core.arr)) for f in ffs],
                       dtype=torch.float32)
    total, mu_merged, lam_all = tsync._sync_collective_core(
        None, torch.stack([f.core.q_view for f in ffs]), ffs[0].q_snap,
        torch.stack([f.core.learner.mu_hat for f in ffs]), lam)
    table = tdsp.build_alias_table(mu_merged)
    return dict(sched_w=sched_w, sched_q=states[0].q_view.tolist(),
                sched_mu=states[0].learner.mu_hat.tolist(), fleet_w=fleet_w,
                q_pre=[f.core.q_view.tolist() for f in ffs], q_post=total.tolist(),
                mu_post=mu_merged.tolist(), alias_p=table.prob.tolist(),
                alias_a=table.alias.tolist(), lam_global=float(lam_all.sum()))


@pytest.mark.parametrize("D", WORLDS)
def test_spawned_ranks_equal_the_stacked_computation(spawned, D):
    """Every rank's sharded schedule, fleet steps and fleet sync equal, bit
    for bit, to the same S = D frontends stacked in one process."""
    want = _stacked_fleet(D)
    for r in spawned[D]:
        k = r["rank"]
        assert r["sched_workers"] == want["sched_w"][k]
        assert r["sched_q"] == want["sched_q"] and r["sched_mu"] == want["sched_mu"]
        assert r["fleet_workers"] == want["fleet_w"][k]
        assert r["q_pre"] == want["q_pre"][k]
        for key in ("q_post", "mu_post", "alias_p", "alias_a", "lam_global"):
            assert r[key] == want[key], key
        assert r["q_snap_post"] == want["q_post"] and r["t_sync"] == 99.0


# ---------------------------------------------------------------------------
# (c) the fleet scan with mesh= at D = 1, 2, 4 against the stacked scan
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _stacked_scan(case: str) -> dict:
    return ranks.scan_case(case)


class _KindLog(collections.Counter):
    """A collective tally that also logs each collective's kind in order."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.log = []

    def __setitem__(self, kind, value):
        if value > self.get(kind, 0):
            self.log.append(kind)
        super().__setitem__(kind, value)


@pytest.fixture(scope="module")
def one_rank_scans(mesh1):
    """The D = 1 mesh scans in this process, each with its ordered kinds."""
    runs = {}
    for case in ranks.SCAN_CASES:
        mesh1.counts = _KindLog(mesh1.counts)
        runs[case] = dict(ranks.scan_case(case, mesh1), log=list(mesh1.counts.log))
    return runs


def _sync_every(case: str) -> int:
    return ranks.SCAN_CASES[case].get("sync_every", 1)


@pytest.mark.parametrize("case", list(ranks.SCAN_CASES))
@pytest.mark.parametrize("D", (1,) + WORLDS)
def test_mesh_fleet_scan_equals_the_stacked_scan(request, D, case):
    """Every rank's results equal the stacked fleet scan's bit for bit
    (responses with NaN for a lost task, μ̂, placements, epochs, gaps, λ̂,
    free_at, the ledger, the fleet and per-frontend windows, every
    frontend's final view, μ̂, front buffer and key, the agreement), and
    each sync kind ran once a sync turn."""
    runs = ([request.getfixturevalue("one_rank_scans")[case]] if D == 1
            else [r["scans"][case] for r in request.getfixturevalue("spawned")[D]])
    want = _stacked_scan(case)
    T = want["turns"]
    assert T > 20
    for got in runs:
        for key in want:
            assert json.dumps(got[key]) == json.dumps(want[key]), (D, case, key)
        coll = got["collectives"]
        for kind in tsync.SYNC_KINDS:
            assert coll[kind] == -(-T // _sync_every(case)), (kind, coll)
        assert coll["placements"] == T
        assert set(coll) <= set(tsync.SYNC_KINDS) | {"placements", "trace", "telemetry",
                                                      "write_back"}
    if ranks.SCAN_CASES[case].get("observe"):
        assert len(want["windows"]) == -(-T // 8) and want["ledger"]["conserved"]


def test_sync_collectives_run_on_sync_turns_only(one_rank_scans):
    """The ordered log of the D = 1 runs: a turn ends with its placements'
    gather; the sync kinds appear in a turn exactly when it syncs."""
    for case, run in one_rank_scans.items():
        turns, cur = [], []
        for kind in run["log"]:
            if kind == "placements":
                turns.append(cur)
                cur = []
            elif kind in tsync.SYNC_KINDS:
                cur.append(kind)
        assert len(turns) == run["turns"]
        for t, kinds in enumerate(turns):
            want = list(tsync.SYNC_KINDS) if t % _sync_every(case) == 0 else []
            assert kinds == want, (case, t)


@pytest.mark.parametrize("case", [c for c, o in ranks.SCAN_CASES.items() if "scenario" not in o])
def test_one_rank_mesh_scan_matches_the_reference_mesh_scan(one_rank_scans, ref, case):
    """The port's D = 1 mesh scan against the reference's one-device mesh
    scan on tests/test_fleet_scan.py's cell: responses, placements, epochs
    and sync gaps equal; μ̂ exact until EXACT_MU_TURNS, within MU_ULPS
    after."""
    from jax.sharding import Mesh

    opts = ranks.SCAN_CASES[case]
    rr = ref["FleetRouter"](ranks.SCAN_S, len(ranks.SPEEDS), mu_bar=float(sum(ranks.SPEEDS)),
                            seed=0, async_mu=False, use_alias=opts["use_alias"])
    rresp, rmu, rinfo = ref["scan"](
        rr, ref["SequentialPool"](np.asarray(ranks.SPEEDS)),
        sync_every=opts.get("sync_every", 1), frozen_mu=opts.get("frozen_mu", False),
        mesh=Mesh(np.array(jax.devices()[:1]), ("sched",)), **ranks.SCAN_KW)
    got = one_rank_scans[case]
    np.testing.assert_array_equal(np.asarray(got["resp"]), np.asarray(rresp))
    for key, rkey in (("workers", "workers"), ("epochs", "epochs"), ("gaps", "sync_gaps"),
                      ("frontends", "frontends")):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(rinfo[rkey]),
                                      err_msg=key)
    mu, rmu = np.asarray(got["mu"], np.float32), np.asarray(rmu)
    first = next((i for i in range(len(rmu)) if not np.array_equal(mu[i], rmu[i])), len(rmu))
    assert first == EXACT_MU_TURNS
    np.testing.assert_array_equal(mu == 0, rmu == 0)
    assert ulps(mu, rmu) <= MU_ULPS
