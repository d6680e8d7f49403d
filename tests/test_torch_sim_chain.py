"""The port's chain simulator (``core.simulator.simulate`` on the CPU: the
plain chain of ``kernels/sim_chain/ref.py``) against the reference's
``repro.core.simulator.simulate``, on the same seeds.

Cases: each policy of ``PAPER_BASELINES`` plus Halo and LL(2), with known
speeds and with the learner, on the alias and the CDF stream, static and
volatile, Fig. 9's jobs of 1-4 tasks with 10% of them pinned (under both
``batch_self_correct`` settings), and Fig. 8's smoke settings (6000
rounds) for Rosella and Sparrow.

Parity classes:
  * the port's own draws: every integer trace column (events, workers,
    task workers and completion targets, queues) equal to the reference's
    on every round (FIRST_INT_DIFF pins that round at the run's length for
    every case, the learner's too: μ̂'s ulps moved no decision in these
    runs); ``now``, ``lam_hat`` and ``mu_hat`` within REL_TOL, since
    ``dt``'s ``log1p`` is torch's (it parts from XLA's by an ulp in ~10% of
    the draws) and the learner's ring sums run left to right (XLA sums the
    128 lanes in another order); the final ring's service times, each a
    difference of two clocks, within REL_TOL of the clock;
  * the reference's own draws (``jax.random`` here) fed to the plain chain:
    with known speeds every column equal bit for bit; with the learner
    every integer column, ``now`` and ``lam_hat`` equal bit for bit and
    ``mu_hat`` within REL_TOL (the ring sums' order alone);
  * Fig. 8's smoke statistics through ``analyze``: job and censored counts
    equal, mean / p50 / p95 within REL_TOL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as rdsp
from repro.core import metrics as rmet
from repro.core import policies as rpol
from repro.core import simulator as rsim
from repro_torch.configs import rosella_sim as TRS
from repro_torch.core import metrics as tmet
from repro_torch.core import simulator as tsim
from repro_torch.utils import prng
from test_torch_model import reference_shim

REL_TOL = 1e-5
F9 = [0.4, 0.3, 0.2, 0.1]
TPCH, ZIPF = TRS.tpch_speed_set(30, 0), TRS.zipf_speeds(15, seed=0)
KNOWN = dict(use_learner=False, use_fake_jobs=False)
JOBS = dict(max_tasks=4, task_probs=F9, constrained_frac=0.1)
VOLATILE = dict(volatile_phases=6, phase_period=20.0)
#: name -> (policy, speeds, load, rounds, make_sim arguments, SimConfig changes)
CASES = {
    "uniform_jobs_batched": ("uniform", TPCH, 0.8, 2000, dict(KNOWN, **JOBS),
                             dict(batch_self_correct=False)),
    "pot_volatile": ("pot", ZIPF, 0.9, 2000, dict(KNOWN, volatile_phases=3,
                                                   phase_period=20.0), {}),
    "sparrow_jobs": ("sparrow", TPCH, 0.8, 2000, dict(KNOWN, **JOBS), {}),
    "bandit_jobs_cdf_batched": ("bandit", TPCH, 0.8, 2000, dict(JOBS),
                                dict(use_alias=False, batch_self_correct=False)),
    "pss_cdf_volatile": ("pss", TPCH, 0.8, 2000, dict(VOLATILE), dict(use_alias=False)),
    "rosella_jobs_volatile": ("ppot_sq2", TPCH, 0.8, 2000, dict(JOBS, **VOLATILE), {}),
    "halo_volatile": ("halo", ZIPF, 0.9, 2000, dict(KNOWN, volatile_phases=3,
                                                     phase_period=20.0), {}),
    "ll2_known": ("ppot_ll2", ZIPF, 0.9, 2000, dict(KNOWN), {}),
    "fig8_rosella": ("ppot_sq2", TPCH, 0.8, 6000, {}, {}),
    "fig8_sparrow": ("sparrow", TPCH, 0.8, 6000, dict(KNOWN), {}),
}
#: the first round whose integer columns may differ from the reference's
#: (the run's length: equal on every round)
FIRST_INT_DIFF = {name: case[3] for name, case in CASES.items()}
INT_COLS = ("code", "worker", "n_tasks", "task_workers", "task_targets", "frontend",
            "view_gap", "killed", "killed_fake", "q_real")
FLOAT_COLS = ("now", "lam_hat", "mu_hat", "sync_age")
#: the reference's own draws are fed to the plain chain for these
REF_DRAW_CASES = ("rosella_jobs_volatile", "pss_cdf_volatile", "halo_volatile",
                  "sparrow_jobs")


def _configs(rrs, name):
    policy, speeds, load, rounds, kw, changes = CASES[name]
    rc, rp = rrs.make_sim(policy, speeds, load, rounds=rounds, **kw)
    tc, tp = TRS.make_sim(policy, speeds, load, rounds=rounds, device="cpu", **kw)
    return (dataclasses.replace(rc, **changes), rp, dataclasses.replace(tc, **changes), tp)


@pytest.fixture(scope="module")
def runs():
    """Every case run once by the reference and by the port (seed 0)."""
    with reference_shim():
        from repro.configs import rosella_sim as rrs
    out = {}
    for name in CASES:
        rc, rp, tc, tp = _configs(rrs, name)
        rf, rt = rsim.simulate(rc, rp, jax.random.PRNGKey(0))
        tf, tt = tsim.simulate(tc, tp, prng.PRNGKey(0), device="cpu")
        out[name] = dict(rc=rc, rp=rp, tc=tc, tp=tp, rf=rf,
                         rt={k: np.asarray(v) for k, v in rt.items()}, tf=tf,
                         tt={k: v.numpy() for k, v in tt.items()})
    return out


def _first_row_differing(a, b) -> int:
    bad = np.nonzero((a != b).reshape(a.shape[0], -1).any(1))[0]
    return int(bad[0]) if bad.size else a.shape[0]


def _close(a, b, upto=None):
    a, b = np.atleast_1d(np.asarray(a, np.float64)), np.atleast_1d(np.asarray(b, np.float64))
    np.testing.assert_allclose(b[:upto], a[:upto], rtol=REL_TOL, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulate_equals_the_reference(runs, name):
    r = runs[name]
    rt, tt = r["rt"], r["tt"]
    assert set(rt) == set(tt)
    for k in rt:
        assert rt[k].shape == tt[k].shape and rt[k].dtype == tt[k].dtype, k
    T = FIRST_INT_DIFF[name]
    for k in INT_COLS:
        assert _first_row_differing(rt[k], tt[k]) >= T, k
    for k in FLOAT_COLS:
        _close(rt[k], tt[k], T)
    rf, tf = r["rf"], r["tf"]
    for f in ("q_real", "q_fake", "s_real"):
        np.testing.assert_array_equal(np.asarray(getattr(rf, f)), getattr(tf, f).numpy())
    for f in ("widx", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(rf.learner, f)),
                                      getattr(tf.learner, f).numpy())
    np.testing.assert_array_equal(np.asarray(rf.arr.count), tf.arr.count.numpy())
    _close(rf.now, tf.now)
    _close(rf.busy_start, tf.busy_start)
    _close(rf.learner.mu_hat, tf.learner.mu_hat)
    # a service time is a difference of two clocks: within REL_TOL of the clock
    clock = float(np.abs(rt["now"]).max())
    np.testing.assert_allclose(tf.learner.samples.numpy(), np.asarray(rf.learner.samples),
                               rtol=0, atol=REL_TOL * clock)
    assert (rt["code"] == rsim.EV_ARRIVAL).sum() > 100


def _jax_draws(cfg, params, key, now_ref) -> dict:
    """``draw_rounds`` written with jax.random: the draws the reference's
    round function makes from the same keys. dt is exponential / R; XLA
    sums R = Σ[λ, μmax, νmax] in an order that depends on the compiled
    program, so R is recovered from the reference's clock: the f32 value
    within 4 ulp of (λ + Σμmax) + νmax (left to right) whose dt reproduce
    ``now_ref``."""
    n, mt, T = cfg.n, cfg.max_tasks, cfg.rounds
    mu_max = np.asarray(jnp.max(params.mu_schedule, axis=0), np.float32)
    nu_max = np.float32(np.float32(cfg.c0) * np.float32(params.mu_bar)) \
        if cfg.use_fake_jobs else np.float32(0.0)
    R0 = np.float32(np.float32(np.float32(params.lam) + np.add.accumulate(mu_max)[-1]) + nu_max)
    e = np.asarray(jax.vmap(lambda k: jax.random.exponential(jax.random.split(k, 4)[0]))(
        jax.random.split(key, T)), np.float32)
    base = np.array(R0).view(np.int32)
    fits = [R for R in ((base + d).view(np.float32) for d in range(-4, 5))
            if np.array_equal(np.add.accumulate(e / R), now_ref)]
    assert fits, "no R within 4 ulp reproduces the reference's clock"
    R = np.float32(fits[0])
    logits = jnp.log(jnp.clip(jnp.concatenate([params.lam[None], jnp.asarray(mu_max),
                                               jnp.asarray(nu_max)[None]]), 1e-30))
    pcfg = rpol.default_policy_config()
    table = cfg.use_alias and cfg.policy in rdsp.ALIAS_POLICIES
    J = max(2 * mt, int(pcfg.sparrow_d) * mt)

    def one(k):
        k_dt, k_ev, k_br, _ = jax.random.split(k, 4)
        ka, kj = jax.random.split(k_br)
        k_tasks, k_sched = jax.random.split(k_br)
        kc, ku, kd = jax.random.split(k_sched, 3)
        u = jnp.zeros((4, mt), jnp.float32)
        j = jnp.zeros((J,), jnp.int32)
        p = cfg.policy

        def probe_u(k):
            if table:
                return jnp.stack(rdsp._uniform_quad(k, mt))
            return u.at[:2].set(jnp.stack(rdsp._uniform_pair(k, mt)))

        if p == "uniform":
            j = j.at[:mt].set(jax.random.randint(kd, (mt,), 0, n))
        elif p == "pot":
            j = j.at[:2 * mt].set(jax.random.randint(kd, (2, mt), 0, n).reshape(-1))
        elif p == "pss" and table:
            a, _, b, _ = rdsp._uniform_quad(kd, mt)
            u = u.at[0].set(a).at[2].set(b)
        elif p in ("pss", "halo"):
            u = u.at[0].set(jax.random.uniform(kd, (mt,)))
        elif p in ("ppot_sq2", "ppot_ll2"):
            u = probe_u(kd)
        elif p == "bandit":
            k1, k3, k4 = jax.random.split(kd, 3)
            u = probe_u(k1)
            j = j.at[:mt].set(jax.random.randint(k4, (mt,), 0, n))
            j = j.at[mt:2 * mt].set(
                (jax.random.uniform(k3, (mt,)) < pcfg.bandit_eta).astype(jnp.int32))
        else:  # sparrow
            j = j.at[:2 * mt].set(jax.random.randint(kd, (2 * mt,), 0, n))
        pins = jnp.full((mt,), -1, jnp.int32)
        if cfg.constrained_frac > 0:
            pins = jnp.where(jax.random.uniform(kc, (mt,)) < cfg.constrained_frac,
                             jax.random.randint(ku, (mt,), 0, n, dtype=jnp.int32), -1)
        return dict(
            dt=jax.random.exponential(k_dt) / R,
            ev=jax.random.categorical(k_ev, logits).astype(jnp.int32),
            u_svc=jax.random.uniform(k_br), u_fake=jax.random.uniform(ka),
            j_fake=jax.random.randint(kj, (), 0, n, dtype=jnp.int32),
            n_tasks=1 + jax.random.categorical(k_tasks, params.task_logits).astype(jnp.int32),
            pins=pins.astype(jnp.int32), u=u, j=j.astype(jnp.int32))

    d = jax.vmap(one)(jax.random.split(key, T))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("name", REF_DRAW_CASES)
def test_plain_chain_on_the_references_draws(runs, name):
    """The chain's arithmetic apart from the generators: the plain chain
    fed the reference's own draws."""
    r = runs[name]
    draws = _jax_draws(r["rc"], r["rp"], jax.random.PRNGKey(0), r["rt"]["now"])
    own = tsim.draw_rounds(r["tc"], r["tp"], prng.PRNGKey(0), device="cpu")
    for k in ("u_svc", "u_fake", "j_fake", "pins", "u", "j"):
        assert torch.equal(draws[k], own[k]), k
    (_, tt), = tsim.simulate_many([(r["tc"], r["tp"], prng.PRNGKey(0))], "cpu", [draws])
    rt = r["rt"]
    exact = INT_COLS + ("now", "lam_hat", "sync_age") + (
        () if r["tc"].use_learner else ("mu_hat",))
    for k in exact:
        np.testing.assert_array_equal(tt[k].numpy(), rt[k], err_msg=k)
    _close(rt["mu_hat"], tt["mu_hat"].numpy())


@pytest.mark.parametrize("name", ["fig8_rosella", "fig8_sparrow"])
def test_fig8_smoke_statistics_equal_the_reference(runs, name):
    r = runs[name]
    want = rmet.analyze(r["rt"], n=30, warmup_frac=0.3)
    got = tmet.analyze(r["tt"], n=30, warmup_frac=0.3)
    assert got.num_jobs == want.num_jobs and got.censored == want.censored
    assert got.response_times.shape == want.response_times.shape
    for p in (50, 95):
        _close(np.percentile(want.response_times, p), np.percentile(got.response_times, p))
    _close(want.response_times.mean(), got.response_times.mean())
    np.testing.assert_array_equal(got.max_queue, want.max_queue)


def test_simulate_many_equals_each_run_alone():
    """Chains of different policies, flags and lengths in one call equal
    each run on its own."""
    runs = []
    for i, (policy, learner, rounds) in enumerate((("ppot_sq2", True, 700),
                                                   ("sparrow", False, 400),
                                                   ("halo", False, 550))):
        cfg, params = TRS.make_sim(policy, ZIPF, 0.85, rounds=rounds, use_learner=learner,
                                   use_fake_jobs=learner, volatile_phases=2 * i,
                                   phase_period=10.0, device="cpu")
        runs.append((cfg, params, prng.PRNGKey(i)))
    for (cfg, params, key), (fs, tr) in zip(runs, tsim.simulate_many(runs, "cpu")):
        f1, t1 = tsim.simulate(cfg, params, key, device="cpu")
        assert tr["code"].shape[0] == cfg.rounds
        for k in tr:
            assert torch.equal(tr[k], t1[k]), k
        assert torch.equal(fs.learner.mu_hat, f1.learner.mu_hat)
        assert torch.equal(fs.arr.times, f1.arr.times)


def test_draw_rounds_columns():
    cfg, params = TRS.make_sim("bandit", ZIPF, 0.8, rounds=300, device="cpu", **JOBS)
    d = tsim.draw_rounds(cfg, params, prng.PRNGKey(5), device="cpu")
    shapes = {"dt": (300,), "ev": (300,), "u_svc": (300,), "u_fake": (300,),
              "j_fake": (300,), "n_tasks": (300,), "pins": (300, 4), "u": (300, 4, 4),
              "j": (300, 8)}
    assert {k: tuple(v.shape) for k, v in d.items()} == shapes
    assert (d["dt"] > 0).all() and ((d["ev"] >= 0) & (d["ev"] <= 16)).all()
    assert ((d["n_tasks"] >= 1) & (d["n_tasks"] <= 4)).all()
    assert ((d["pins"] == -1) | ((d["pins"] >= 0) & (d["pins"] < 15))).all()
    assert 0.02 < (d["pins"] >= 0).float().mean() < 0.2
    cfg0, params0 = TRS.make_sim("pot", ZIPF, 0.8, rounds=50, device="cpu")
    assert (tsim.draw_rounds(cfg0, params0, prng.PRNGKey(5), device="cpu")["pins"] == -1).all()


@pytest.mark.parametrize("mode", ["env", "n_frontends", "sync", "observe"])
def test_other_modes_raise_naming_a8b(mode):
    """The environment and fleet modes (ROADMAP A8b) run now; only in-chain
    telemetry is refused, naming A8c."""
    cfg, params = TRS.make_sim("ppot_sq2", ZIPF, 0.8, rounds=20, device="cpu")
    env = None
    if mode == "env":
        env = tsim.EnvSchedule(
            lam_bp=torch.zeros(1), lam_val=params.lam.reshape(1), mu_bp=torch.zeros(1),
            mu_val=params.mu_schedule[:1], act_bp=torch.zeros(1),
            act_val=torch.ones(1, 15, dtype=torch.bool),
            burst=torch.tensor(4, dtype=torch.int32))
    elif mode == "n_frontends":
        cfg = dataclasses.replace(cfg, n_frontends=2)
    elif mode == "sync":
        cfg = dataclasses.replace(cfg, fleet_sync_every=4)
    else:
        cfg = dataclasses.replace(cfg, observe=object())
        with pytest.raises(NotImplementedError, match="A8c"):
            tsim.simulate(cfg, params, prng.PRNGKey(0), env, device="cpu")
        return
    final, trace = tsim.simulate(cfg, params, prng.PRNGKey(0), env, device="cpu")
    assert trace["code"].shape == (20,) and final.fleet is not None


def test_simulate_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = TRS.make_sim("ppot_sq2", ZIPF, 0.8, rounds=20, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.simulate(cfg, params, prng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRS.make_sim("ppot_sq2", ZIPF, 0.8, rounds=20)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_shape(cfg) -> tuple:
    """(n, mt, ring_cap, arrival_window, J, trace_queues, trace_mu) of a run."""
    from repro_torch.core import policies as tpol

    j = tsim.probe_width(cfg, tpol.default_policy_config())
    return (cfg.n, cfg.max_tasks, cfg.ring_cap, cfg.arrival_window, j, cfg.trace_queues,
            cfg.trace_mu)


def test_sim_chain_shape_limit_takes_every_shape_the_card_runs():
    """``kernel.check_shape`` / ``smem_bytes`` take every chain shape of
    chip_smoke.py's figures, check chains and theory cell, of the card
    tests' cases, and n = 200 at a ring of 128, each with a tile of at
    least one round in SMEM_LIMIT; they refuse the first n past the limit
    at a ring of 128 (213) with a message naming sim_chain."""
    from repro_torch.kernels.sim_chain import kernel as SK
    from test_torch_cuda import SIM_CASES

    cs = _chip_smoke()
    cfgs = [cfg for runs in cs.sim_figures(TRS, "cpu").values() for _, (cfg, _, _), _ in runs]
    cfgs += [cfg for cases in cs.sim_check_groups(TRS, "cpu").values()
             for _, (cfg, _, _) in cases]
    cfgs.append(TRS.make_sim("ppot_sq2", np.ones(20), 0.8, rounds=80_000, use_learner=False,
                             device="cpu")[0])  # the theory cell
    shapes = {_kernel_shape(cfg) for cfg in cfgs}
    shapes |= {(n, mt, 128, 64, 2 * mt, flags.get("trace_queues", True),
                flags.get("trace_mu", True)) for n, mt, _, _, flags in SIM_CASES.values()}
    shapes.add((200, 1, 128, 64, 2, True, True))
    assert {s[0] for s in shapes} >= {1, 15, 20, 30, 200}
    for n, mt, cap, S, J, tq, tm in sorted(shapes):
        kw = dict(J=J, trace_queues=tq, trace_mu=tm)
        SK.check_shape(n, mt, cap, S, **kw)
        stride = SK.ring_stride(n, mt, cap, S, **kw)
        tile = SK.tile_rounds(120_000, n, mt, cap, S, stride=stride, **kw)
        assert n <= stride and tile >= 1
        assert SK.smem_bytes(n, mt, cap, S, tile=tile, stride=stride, **kw) <= SK.SMEM_LIMIT
    first = next(n for n in range(200, 300) if SK.smem_bytes(n, 1, 128, 64) > SK.SMEM_LIMIT)
    assert first == 213
    SK.check_shape(first - 1, 1, 128, 64)
    with pytest.raises(ValueError, match="sim_chain"):
        SK.check_shape(first, 1, 128, 64)
    with pytest.raises(ValueError, match="sim_chain"):
        SK.check_shape(30, SK.MAX_MT + 1, 128, 64)


def test_sim_chain_wrapper_constants_match_the_source():
    """The wrapper's copies of the kernel's constants: the state arrays and
    slots a job of the shared-memory formula, and the clocked build's record
    (the CK_* phases, then the CN_* counts) that ``read_clocks`` names."""
    import re

    from repro_torch.kernels.sim_chain import build as SB
    from repro_torch.kernels.sim_chain import kernel as SK

    src = SB.SRC.read_text()
    assert int(re.search(r"constexpr int kStateArrays = (\d+);", src).group(1)) == \
        SK.STATE_ARRAYS
    assert int(re.search(r"constexpr int kExtArrays = (\d+);", src).group(1)) == \
        SK.EXT_ARRAYS
    assert int(re.search(r"constexpr int kMaxMt = (\d+);", src).group(1)) == SK.MAX_MT
    assert int(re.search(r"constexpr int kClockChains = (\d+);", src).group(1)) == \
        SK.CLOCK_CHAINS
    assert "2 * (size_t)(n + 4)" in src  # the table's stack, beside the rings
    phases = re.search(r"enum \{ (CK_SETUP[^}]*) \};", src).group(1)
    counts = re.search(r"enum \{ (CN_ROUNDS[^}]*) \};", src).group(1)
    names = [w.strip().split(" ")[0] for w in phases.replace("\n", " ").split(",")]
    assert names[-1] == "CK_PHASES"
    assert [w[3:].lower() for w in names[:-1]] == list(SK.CLOCK_PHASES)
    cnames = [w.strip().split(" ")[0] for w in counts.replace("\n", " ").split(",")]
    assert cnames[-1] == "CK_SLOTS"
    assert [w[3:].lower() for w in cnames[:-1]] == list(SK.CLOCK_COUNTS)
