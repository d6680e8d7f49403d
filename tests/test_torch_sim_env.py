"""The chain simulator's environment and fault modes (``simulate(...,
env=...)`` on the CPU: the plain chain of ``kernels/sim_chain/ref.py``)
against the reference's ``repro.core.simulator.simulate``, on the same
scenarios (``Scenario.to_sim`` of both packages, the registry's cluster of
n = 5) and seeds.

Cases: flash_crowd (arrival thinning), reshuffle (capacity), churn and
churn_heavy (membership: rejoin bursts, ``reset_workers``), blackout
(stalls), crash_storm (crashes, the ``killed`` column) and grey_failure, on
the alias stream with the learner; churn_heavy and crash_storm on the CDF
stream and with known speeds; crash_storm with Fig. 9's jobs of 1-4 tasks,
10% pinned; churn_heavy under Sparrow, bandit, Halo and PoT (the uniform
worker draws over the active workers).

Parity classes:
  * ``to_sim``: every registry scenario's arrays ``array_equal`` to the
    reference's (the null scenario gives no environment in both), and
    ``convert.env_schedule_from_reference`` gives the same schedule;
  * the port's own draws: every integer trace column (``code``, ``worker``,
    ``n_tasks``, ``task_workers``, ``task_targets``, ``frontend``,
    ``view_gap``, ``killed``, ``killed_fake``, ``q_real``) equal to the
    reference's on every round (FIRST_INT_DIFF pins that round at the
    run's length for every case: no sum below moved a decision); ``now``,
    ``lam_hat`` and ``mu_hat`` within REL_TOL (``dt``'s ``log1p`` is
    torch's; the learner's ring sums and the cold start's Σ of the kept μ̂
    run left to right, XLA's in an order of its own); ``sync_age``, a
    difference of two clocks, within REL_TOL of the clock; the final
    frozen alias table's thresholds, residuals of weights of mean one,
    within REL_TOL of one;
  * the reference's own draws (``jax.random`` here, ``jax_draws``) fed to
    the plain chain: every integer column, ``now``, ``lam_hat`` and
    ``sync_age`` equal bit for bit, ``mu_hat`` within REL_TOL (the sums
    above alone);
  * the reference's own assertions on the port: churn masks placements,
    the MMPP's burst rate, crash_storm kills jobs and churn none.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import env as renv
from repro.core import dispatch as rdsp
from repro.core import policies as rpol
from repro.core import simulator as rsim
from repro_torch import convert
from repro_torch import env as tenv
from repro_torch.core import metrics as tmet
from repro_torch.core import simulator as tsim
from repro_torch.utils import prng
from test_torch_model import reference_shim

REL_TOL = 1e-5
F9 = [0.4, 0.3, 0.2, 0.1]
KNOWN = dict(use_learner=False, use_fake_jobs=False)
#: name -> (scenario, policy, rounds, SimConfig fields, Fig. 9's jobs)
CASES = {
    "flash_crowd": ("flash_crowd", "ppot_sq2", 3000, {}, False),
    "reshuffle": ("reshuffle", "ppot_sq2", 3000, {}, False),
    "churn": ("churn", "ppot_sq2", 3000, {}, False),
    "churn_heavy": ("churn_heavy", "ppot_sq2", 3000, {}, False),
    "blackout": ("blackout", "ppot_sq2", 3000, {}, False),
    "crash_storm": ("crash_storm", "ppot_sq2", 3000, {}, False),
    "grey_failure": ("grey_failure", "ppot_sq2", 3000, {}, False),
    "churn_heavy_cdf": ("churn_heavy", "ppot_sq2", 3000, dict(use_alias=False), False),
    "churn_heavy_known": ("churn_heavy", "ppot_sq2", 3000, KNOWN, False),
    "crash_storm_cdf_known": ("crash_storm", "ppot_sq2", 3000, dict(KNOWN, use_alias=False),
                              False),
    "crash_storm_jobs": ("crash_storm", "ppot_sq2", 3000,
                         dict(max_tasks=4, constrained_frac=0.1), True),
    "churn_heavy_sparrow": ("churn_heavy", "sparrow", 2000, KNOWN, False),
    "churn_heavy_bandit": ("churn_heavy", "bandit", 2000, {}, False),
    "churn_heavy_halo": ("churn_heavy", "halo", 2000, KNOWN, False),
    "churn_heavy_pot": ("churn_heavy", "pot", 2000, dict(use_learner=False), False),
}
#: the first round whose integer columns may differ from the reference's
#: (the run's length: equal on every round)
FIRST_INT_DIFF = {name: case[2] for name, case in CASES.items()}
INT_COLS = ("code", "worker", "n_tasks", "task_workers", "task_targets", "frontend",
            "view_gap", "killed", "killed_fake", "q_real")
FLOAT_COLS = ("now", "lam_hat", "mu_hat")
#: the reference's own draws are fed to the plain chain for these
REF_DRAW_CASES = ("churn_heavy", "crash_storm_jobs", "churn_heavy_sparrow", "blackout",
                  "churn_heavy_halo")


def jobs_params(sim, params, speeds, device=None):
    """``params`` with Fig. 9's jobs of 1-4 tasks (the rest as to_sim made
    them), from the package ``sim``'s ``make_params``."""
    kw = {} if device is None else dict(device=device)
    return sim.make_params(lam=float(params.lam), mu=np.asarray(speeds, float),
                           mu_bar=float(np.asarray(speeds, float).sum()), task_probs=F9,
                           max_tasks=4, **kw)


def configs(name):
    """(reference cfg, params, env, port cfg, params, env) of a case."""
    scn, policy, rounds, kw, jobs = CASES[name]
    rc, rp, re_ = renv.make(scn).to_sim(policy, rounds=rounds, **kw)
    tc, tp, te = tenv.make(scn).to_sim(policy, rounds=rounds, device="cpu", **kw)
    if jobs:
        speeds = renv.make(scn).speeds
        rp, tp = jobs_params(rsim, rp, speeds), jobs_params(tsim, tp, speeds, "cpu")
    return rc, rp, re_, tc, tp, te


def as_np(trace) -> dict:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in trace.items()}


@pytest.fixture(scope="module")
def runs():
    """Every case run once by the reference and by the port (seed 0)."""
    out = {}
    with reference_shim():
        for name in CASES:
            rc, rp, re_, tc, tp, te = configs(name)
            rf, rt = rsim.simulate(rc, rp, jax.random.PRNGKey(0), re_)
            tf, tt = tsim.simulate(tc, tp, prng.PRNGKey(0), te, device="cpu")
            out[name] = dict(rc=rc, rp=rp, re=re_, tc=tc, tp=tp, te=te, rf=rf,
                             rt=as_np(rt), tf=tf, tt=as_np(tt))
    return out


def first_row_differing(a, b) -> int:
    bad = np.nonzero((a != b).reshape(a.shape[0], -1).any(1))[0]
    return int(bad[0]) if bad.size else a.shape[0]


def close(a, b, upto=None, atol=0.0):
    a, b = np.atleast_1d(np.asarray(a, np.float64)), np.atleast_1d(np.asarray(b, np.float64))
    np.testing.assert_allclose(b[:upto], a[:upto], rtol=REL_TOL, atol=atol)


def assert_trace_parity(rt: dict, tt: dict, first_int_diff: int) -> None:
    """The parity classes of the port's own draws (module docstring)."""
    assert set(rt) == set(tt)
    for k in rt:
        assert rt[k].shape == tt[k].shape and rt[k].dtype == tt[k].dtype, k
    T = first_int_diff
    for k in INT_COLS:
        assert first_row_differing(rt[k], tt[k]) >= T, k
    for k in FLOAT_COLS:
        close(rt[k], tt[k], T)
    clock = float(np.abs(rt["now"]).max())
    close(rt["sync_age"], tt["sync_age"], T, atol=REL_TOL * clock)


@pytest.mark.parametrize("name", sorted(CASES))
def test_environment_chain_equals_the_reference(runs, name):
    r = runs[name]
    rt, tt = r["rt"], r["tt"]
    assert_trace_parity(rt, tt, FIRST_INT_DIFF[name])
    rf, tf = r["rf"], r["tf"]
    for f in ("q_real", "q_fake", "s_real", "crash_i"):
        np.testing.assert_array_equal(np.asarray(getattr(rf, f)), getattr(tf, f).numpy())
    for f in ("widx", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(rf.learner, f)),
                                      getattr(tf.learner, f).numpy())
    for f in ("q_snap", "q_delta", "alias_a"):
        np.testing.assert_array_equal(np.asarray(getattr(rf.fleet, f)),
                                      getattr(tf.fleet, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(rf.fleet.arr.count), tf.fleet.arr.count.numpy())
    close(rf.busy_start, tf.busy_start)
    close(rf.learner.mu_hat, tf.learner.mu_hat)
    close(rf.fleet.mu_view, tf.fleet.mu_view)
    close(rf.fleet.alias_p, tf.fleet.alias_p, atol=REL_TOL)  # residuals of mean-one weights
    assert (rt["code"] == rsim.EV_ARRIVAL).sum() > 300


def test_environment_cases_reach_their_events(runs):
    """The cases see what they are for: thinned arrivals under the flash
    crowd, a rejoin under churn, stalls, kills."""
    rt = {name: r["rt"] for name, r in runs.items()}
    killed = rt["crash_storm"]["killed"]
    assert killed.shape == (3000, 5) and killed.sum() > 0
    assert rt["churn"]["killed"].shape == (3000, 0)
    assert float(rt["churn"]["now"][-1]) > 240.0  # worker 1 leaves at 120, rejoins at 240
    assert float(rt["blackout"]["now"][-1]) > 245.0


@pytest.mark.parametrize("name", sorted(renv.names()))
def test_to_sim_equals_the_reference(name):
    rc, rp, re_ = renv.make(name).to_sim("ppot_sq2", rounds=100)
    tc, tp, te = tenv.make(name).to_sim("ppot_sq2", rounds=100, device="cpu")
    assert dataclasses.asdict(rc) == dataclasses.asdict(tc)
    for f in convert.SIM_PARAMS:
        np.testing.assert_array_equal(np.asarray(getattr(rp, f)), getattr(tp, f).numpy(), f)
    if re_ is None:
        assert te is None and name == "null"
        assert convert.env_schedule_from_reference(None, "cpu") is None
        return
    leaves = {f: None if getattr(re_, f) is None else np.asarray(getattr(re_, f))
              for f in convert.ENV_SCHEDULE}
    conv = convert.env_schedule_from_reference(leaves, "cpu")
    for f in convert.ENV_SCHEDULE:
        want, got = leaves[f], getattr(te, f)
        assert (want is None) == (got is None), f
        if want is not None:
            assert got.dtype == getattr(conv, f).dtype, f
            np.testing.assert_array_equal(want, got.numpy(), err_msg=f)
            np.testing.assert_array_equal(want, getattr(conv, f).numpy(), err_msg=f)


def jax_draws(cfg, params, key, env, now_ref) -> dict:
    """``draw_rounds`` written with jax.random: the draws the reference's
    round function makes from the same keys, the environment's and the
    fleet's included. dt is exponential / R with R recovered from the
    reference's clock, as in test_torch_sim_chain.py's ``_jax_draws``: the
    f32 value within 4 ulp of (λ + Σμmax) + νmax whose dt reproduce
    ``now_ref``."""
    n, mt, T, S = cfg.n, cfg.max_tasks, cfg.rounds, cfg.n_frontends
    masked = env is not None
    sched = params.mu_schedule if env is None else env.mu_val
    mu_max = np.asarray(jnp.max(sched, axis=0), np.float32)
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
        uj = jnp.zeros((J,), jnp.float32)
        p = cfg.policy

        def probe_u(k):
            if table:
                return jnp.stack(rdsp._uniform_quad(k, mt))
            return u.at[:2].set(jnp.stack(rdsp._uniform_pair(k, mt)))

        def workers(k, shape, j, uj, at):  # the engine's uniform worker draws
            if masked:
                return j, uj.at[at].set(jax.random.uniform(k, shape).reshape(-1))
            return j.at[at].set(jax.random.randint(k, shape, 0, n).reshape(-1)), uj

        if p == "uniform":
            j, uj = workers(kd, (mt,), j, uj, slice(0, mt))
        elif p == "pot":
            j, uj = workers(kd, (2, mt), j, uj, slice(0, 2 * mt))
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
            j, uj = workers(k4, (mt,), j, uj, slice(0, mt))
            j = j.at[mt:2 * mt].set(
                (jax.random.uniform(k3, (mt,)) < pcfg.bandit_eta).astype(jnp.int32))
        else:  # sparrow
            j, uj = workers(kd, (2 * mt,), j, uj, slice(0, 2 * mt))
        pins = jnp.full((mt,), -1, jnp.int32)
        u_pin = jnp.zeros((mt,), jnp.float32)
        if cfg.constrained_frac > 0:
            pinned = jax.random.uniform(kc, (mt,)) < cfg.constrained_frac
            if masked:
                pins, u_pin = jnp.where(pinned, 0, -1), jax.random.uniform(ku, (mt,))
            else:
                pins = jnp.where(pinned, jax.random.randint(ku, (mt,), 0, n, dtype=jnp.int32),
                                 -1)
        k_lb = jax.random.fold_in(k_sched, 0x5EED)
        if cfg.frontend_lb == "weighted":
            fe = jax.random.categorical(k_lb, jnp.log(jnp.clip(params.lb_weights, 1e-30)))
        elif cfg.frontend_lb == "sticky":
            fe = jnp.int32(0)
        else:
            fe = jax.random.randint(k_lb, (), 0, S, dtype=jnp.int32)
        zero = jnp.float32(0.0)
        return dict(
            dt=jax.random.exponential(k_dt) / R,
            ev=jax.random.categorical(k_ev, logits).astype(jnp.int32),
            u_svc=jax.random.uniform(k_br), u_fake=jax.random.uniform(ka),
            j_fake=jax.random.randint(kj, (), 0, n, dtype=jnp.int32),
            n_tasks=1 + jax.random.categorical(k_tasks, params.task_logits).astype(jnp.int32),
            pins=pins.astype(jnp.int32), u=u, j=j.astype(jnp.int32),
            u_thin=jax.random.uniform(jax.random.fold_in(k_br, 0x7A11)) if masked else zero,
            fe=fe.astype(jnp.int32), u_pin=u_pin,
            u_jfake=jax.random.uniform(kj) if masked else zero, uj=uj)

    d = jax.vmap(one)(jax.random.split(key, T))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


#: the draw columns equal between jax.random and the port's generators
#: (the categorical ones and dt go through each library's log)
SAME_DRAWS = ("u_svc", "u_fake", "j_fake", "pins", "u", "j", "u_thin", "fe", "u_pin",
              "u_jfake", "uj")


def assert_plain_on_reference_draws(r, env) -> None:
    """The plain chain fed the reference's own draws: the integer columns,
    ``now``, ``lam_hat`` and ``sync_age`` bit for bit, μ̂ within REL_TOL."""
    draws = jax_draws(r["rc"], r["rp"], jax.random.PRNGKey(0), r["re"], r["rt"]["now"])
    own = tsim.draw_rounds(r["tc"], r["tp"], prng.PRNGKey(0), device="cpu", env=env)
    for k in SAME_DRAWS:
        if r["tc"].frontend_lb == "weighted" and k == "fe":
            continue  # a categorical
        assert torch.equal(draws[k], own[k]), k
    (_, tt), = tsim.simulate_many([(r["tc"], r["tp"], prng.PRNGKey(0), env)], "cpu", [draws])
    rt = r["rt"]
    exact = INT_COLS + ("now", "lam_hat", "sync_age") + (
        () if r["tc"].use_learner else ("mu_hat",))
    for k in exact:
        np.testing.assert_array_equal(tt[k].numpy(), rt[k], err_msg=k)
    close(rt["mu_hat"], tt["mu_hat"].numpy())


@pytest.mark.parametrize("name", REF_DRAW_CASES)
def test_plain_chain_on_the_references_draws(runs, name):
    """The chain's arithmetic apart from the generators."""
    r = runs[name]
    assert_plain_on_reference_draws(r, r["te"])


# ---------------------------------------------------------------------------
# The reference's own assertions (tests/test_env.py, tests/test_faults.py),
# on the port
# ---------------------------------------------------------------------------


def test_simulate_env_churn_masks_placements():
    scn = tenv.make("churn", horizon=200.0)
    cfg, params, e = scn.to_sim("ppot_sq2", rounds=4000, device="cpu")
    assert e is not None
    _, trace = tsim.simulate(cfg, params, prng.PRNGKey(0), e, device="cpu")
    code, now = trace["code"].numpy(), trace["now"].numpy()
    tw = trace["task_workers"].numpy()
    off = (code == tsim.EV_ARRIVAL) & (now >= 120.0) & (now < 240.0)
    assert off.sum() > 0
    assert (tw[off] != 1).all()  # replica 1 never placed while offline


def test_simulate_null_scenario_is_plain_simulate():
    cfg, params, e = tenv.make("null").to_sim("ppot_sq2", rounds=1500, device="cpu")
    assert e is None
    _, tr1 = tsim.simulate(cfg, params, prng.PRNGKey(0), device="cpu")
    _, tr2 = tsim.simulate(cfg, params, prng.PRNGKey(0), None, device="cpu")
    for k in tr1:
        assert torch.equal(tr1[k], tr2[k]), k


def test_simulate_env_mmpp_rate_modulation():
    """Arrival counts track the piecewise rate: the burst regime sees a
    higher arrival rate than the calm one."""
    scn = tenv.make("flash_crowd", horizon=400.0)
    cfg, params, e = scn.to_sim("ppot_sq2", rounds=20_000, device="cpu")
    _, trace = tsim.simulate(cfg, params, prng.PRNGKey(0), e, device="cpu")
    code, now = trace["code"].numpy(), trace["now"].numpy()
    lam_bp, lam_val = e.lam_bp.numpy(), e.lam_val.numpy()
    arr_t = now[code == tsim.EV_ARRIVAL]
    hi = lam_val > lam_val.min()

    def rate_in(mask_seg):
        tot_t, tot_n = 0.0, 0
        for i in np.nonzero(mask_seg)[0]:
            t0 = lam_bp[i]
            t1 = min(lam_bp[i + 1] if i + 1 < len(lam_bp) else float(now[-1]), float(now[-1]))
            if t1 <= t0:
                continue
            tot_t += t1 - t0
            tot_n += int(((arr_t >= t0) & (arr_t < t1)).sum())
        return tot_n / max(tot_t, 1e-9)

    assert rate_in(hi) > 1.8 * rate_in(~hi)


def test_sim_crash_kills_churn_drains():
    """A crash storm reports killed jobs through the trace's killed column;
    graceful churn kills nothing: departures drain."""
    cfg, params, e = tenv.make("crash_storm").to_sim("ppot_sq2", rounds=9000, device="cpu")
    _, trace = tsim.simulate(cfg, params, prng.PRNGKey(0), e, device="cpu")
    assert tmet.analyze(trace, cfg.n).killed_jobs > 0
    cfg, params, e = tenv.make("churn").to_sim("ppot_sq2", rounds=9000, device="cpu")
    _, trace = tsim.simulate(cfg, params, prng.PRNGKey(0), e, device="cpu")
    assert tmet.analyze(trace, cfg.n).killed_jobs == 0


def test_observe_is_refused_naming_a8c():
    cfg, params, e = tenv.make("churn").to_sim("ppot_sq2", rounds=50, device="cpu")
    cfg = dataclasses.replace(cfg, observe=object())
    with pytest.raises(NotImplementedError, match="A8c"):
        tsim.simulate(cfg, params, prng.PRNGKey(0), e, device="cpu")


def test_env_draw_columns():
    """The environment's draws: the pins as flags with their uniforms, the
    uniform worker draws as floats, the thinning uniforms in [0, 1)."""
    cfg, params, e = tenv.make("churn").to_sim("pot", rounds=400, device="cpu", max_tasks=2,
                                               constrained_frac=0.3)
    d = tsim.draw_rounds(cfg, params, prng.PRNGKey(3), device="cpu", env=e)
    assert {k: tuple(v.shape) for k, v in d.items()} == {
        "dt": (400,), "ev": (400,), "u_svc": (400,), "u_fake": (400,), "j_fake": (400,),
        "n_tasks": (400,), "pins": (400, 2), "u": (400, 4, 2), "j": (400, 4),
        "u_thin": (400,), "fe": (400,), "u_pin": (400, 2), "u_jfake": (400,), "uj": (400, 4)}
    assert set(d["pins"].unique().tolist()) == {-1, 0}
    assert (d["j"] == 0).all() and ((d["uj"] >= 0) & (d["uj"] < 1)).all()
    assert d["uj"].std() > 0.2 and ((d["u_thin"] >= 0) & (d["u_thin"] < 1)).all()
    assert (d["fe"] == 0).all()  # one frontend
