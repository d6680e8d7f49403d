"""The port's environment engine (``repro_torch.env``) against the JAX
package's (``repro.env``), on the CPU at the registry's own cluster (n = 5,
batches of 8):

(i) every scenario of the registry compiles to the reference's workload,
``array_equal`` field by field, on two seeds;
(ii) the port's host loop (``run_workload``): ``null`` bit-equal to the
port's ``run_simulation``, deterministic on repeat, equal float for float
to the port's one-program loop on the Poisson, MMPP and churn scenarios
(``SequentialPool``, ``async_mu=False``, both probe streams), never
routing to an offline replica, and equal on the reference's compiled
arrays;
(iii) the port against the reference, host loop against host loop and
scan against scan (the reference's scan under the ``ref_scan`` alias of
``jax.experimental.enable_x64``, as in tests/test_torch_scanloop.py):
responses equal on every turn, μ̂ exact until the measured turn at which
the learner's float sum parts the two (``EXACT_MU_TURNS``) and within
``MU_ULPS`` after, the bars of tests/test_torch_router.py;
(iv) the adaptation metrics equal to the reference's;
(v) what is not ported yet raises and names its ROADMAP queue A item (the
items ported since, A3, A4, A5 and A6, now run).
"""
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro import env as jenv
from repro.core import metrics as jmet
from repro_torch import env as tenv
from repro_torch.core import metrics as tmet
from repro_torch.serving import router as tr

K = 8  # arrival batch
HORIZON = 120.0
#: churn takes replica 1 offline on [120, 240): its runs need the window
CHURN_HORIZON = 300.0
SEED = 1
PARITY = ("null", "flash_crowd", "churn", "churn_heavy")
FIELDS = ("times", "costs", "speeds", "active", "rejoin", "burst", "shift_times",
          "trace_dropped", "kill_at", "stall_at", "stall_dur")
MU_ULPS = 8  # test_torch_router: refresh_estimates' float sum
#: the turn at which the port's host loop parts from the reference's in
#: μ̂'s last bits (learner float sums), measured at SEED on the alias
#: stream; the responses stayed equal on every turn
EXACT_MU_TURNS = {"null": 5, "flash_crowd": 4, "churn": 5, "churn_heavy": 5}


def _horizon(name):
    return CHURN_HORIZON if name == "churn" else HORIZON


def ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _first_mu_divergence(mu_a, mu_b) -> int:
    return next((i for i in range(len(mu_a)) if not np.array_equal(mu_a[i], mu_b[i])),
                len(mu_a))


def _assert_reference_bars(ref, port, exact_turns):
    """Responses equal on every turn; μ̂ equal for ``exact_turns`` turns,
    zero where the reference's is and within MU_ULPS on every turn."""
    resp_r, mu_r = ref["responses"], np.asarray(ref["mu_trace"])
    resp_t, mu_t = port["responses"], port["mu_trace"]
    T = len(mu_r)
    assert T > exact_turns and len(mu_t) == T and len(resp_t) == len(resp_r) == T * K
    for i in range(T):
        np.testing.assert_array_equal(resp_t[i * K:(i + 1) * K], resp_r[i * K:(i + 1) * K],
                                      err_msg=f"turn {i}")
    assert _first_mu_divergence(mu_r, mu_t) == exact_turns
    np.testing.assert_array_equal(mu_r == 0, mu_t == 0)
    assert ulps(mu_r, mu_t) <= MU_ULPS
    np.testing.assert_array_equal(port["pool"].free_at, ref["pool"].free_at)


def _port(name, **kw):
    return tenv.run_scenario(tenv.make(name, horizon=_horizon(name)), seed=SEED,
                             arrival_batch=K, device="cpu", **kw)


@pytest.fixture
def ref_scan(monkeypatch):
    """The reference scan loop on jax 0.9, which has ``jax.enable_x64(True)``
    where the reference imports ``jax.experimental.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    return jenv


# ---------------------------------------------------------------------------
# (i) the compiled workloads
# ---------------------------------------------------------------------------


def test_registry_names_and_unknown_name():
    assert tenv.names() == jenv.names()
    assert len(tenv.names()) == 12
    with pytest.raises(KeyError, match="unknown scenario"):
        tenv.make("no_such_scenario")


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", sorted(jenv.SCENARIOS))
def test_workload_equals_the_reference(name, seed):
    """At the registry's own horizon (360 s) and n = 5: every field of the
    compiled ``ServingWorkload`` array_equal to the reference's, and the
    shift instants and events too."""
    a = jenv.make(name).compile_serving(seed=seed, arrival_batch=K)
    b = tenv.make(name).compile_serving(seed=seed, arrival_batch=K)
    assert a.turns == b.turns > 0
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    scn_j, scn_t = jenv.make(name), tenv.make(name)
    np.testing.assert_array_equal(scn_j.shift_times(seed), scn_t.shift_times(seed))
    assert scn_j.shift_events(seed) == scn_t.shift_events(seed)
    assert (scn_j.is_null, scn_j.drifting) == (scn_t.is_null, scn_t.drifting)


def test_workload_views_equal_the_reference():
    """``iter_chunks`` and ``partition`` on churn_heavy, and a trace's
    partial tail, as the reference's."""
    a = jenv.make("churn_heavy").compile_serving(seed=0, arrival_batch=K)
    b = tenv.make("churn_heavy").compile_serving(seed=0, arrival_batch=K)
    for ca, cb in zip(a.iter_chunks(7), b.iter_chunks(7), strict=True):
        for f in FIELDS:
            x, y = getattr(ca, f), getattr(cb, f)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
    for pa, pb in zip(a.partition(4), b.partition(4)):
        np.testing.assert_array_equal(pa, pb)
    with pytest.raises(ValueError, match="divide evenly"):
        b.partition(3)
    tr_ = tenv.TraceArrivals.from_arrays(np.arange(10) * 1.0)
    scn = tenv.Scenario(name="t", speeds=(1.0, 1.0), rate=1.0, horizon=100.0,
                        arrivals=tr_)
    wl = scn.compile_serving(seed=0, arrival_batch=4)
    assert wl.turns == 2 and wl.trace_dropped == 2


# ---------------------------------------------------------------------------
# (ii) the port's host loop
# ---------------------------------------------------------------------------


def test_null_is_bit_equal_to_run_simulation():
    scn = tenv.make("null", horizon=HORIZON)
    sp = np.asarray(scn.speeds)
    ra = tr.RosellaRouter(scn.n, mu_bar=sp.sum(), seed=0, async_mu=False, device="cpu")
    resp, mu = tr.run_simulation(ra, tr.SimulatedPool(sp), arrival_rate=scn.rate,
                                 horizon=scn.horizon, seed=0, arrival_batch=K)
    out = tenv.run_scenario(scn, seed=0, arrival_batch=K, device="cpu")
    np.testing.assert_array_equal(resp, out["responses"])
    np.testing.assert_array_equal(mu, out["mu_trace"])


@pytest.mark.parametrize("name", ["flash_crowd", "churn"])
def test_scenario_deterministic_repeat(name):
    a, b = _port(name), _port(name)
    np.testing.assert_array_equal(a["responses"], b["responses"])
    np.testing.assert_array_equal(a["mu_trace"], b["mu_trace"])


@pytest.mark.parametrize("use_alias", [True, False])
@pytest.mark.parametrize("name", PARITY)
def test_host_equals_scan(name, use_alias):
    """The port's host loop against the port's one-program loop, float for
    float (SequentialPool, async_mu=False), overflows 0."""
    h = _port(name, sequential_pool=True, use_alias=use_alias)
    s = _port(name, sequential_pool=True, use_alias=use_alias, use_scan=True)
    assert s["info"]["flush_overflow"] == s["info"]["pend_overflow"] == 0
    assert s["info"]["turns"] == h["info"]["turns"] == len(h["mu_trace"]) > 30
    np.testing.assert_array_equal(h["responses"], s["responses"])
    np.testing.assert_array_equal(h["mu_trace"], s["mu_trace"])
    np.testing.assert_array_equal(h["pool"].free_at, s["pool"].free_at)
    assert torch.equal(h["router"].learner.mu_hat, s["router"].learner.mu_hat)
    assert h["router"].key == s["router"].key
    wl = h["workload"]
    if wl.active is not None:
        assert torch.equal(h["router"].active, s["router"].active)
        assert (~wl.active).any() or name != "churn"


def test_churn_never_routes_offline():
    """Replica 1 is offline on [120, 240): run only up to its last offline
    turn, and its clock holds no work submitted after it left."""
    scn = tenv.make("churn", horizon=CHURN_HORIZON)
    wl = scn.compile_serving(seed=0, arrival_batch=K)
    off = np.nonzero(~wl.active[:, 1])[0]
    assert len(off) > 10
    cut = off[-1] + 1
    wl_cut = dataclasses.replace(
        wl, times=wl.times[:cut], costs=wl.costs[:cut], speeds=wl.speeds[:cut],
        active=wl.active[:cut], rejoin=wl.rejoin[:cut], burst=wl.burst[:cut])
    for use_alias in (True, False):
        router = tr.RosellaRouter(scn.n, mu_bar=float(np.sum(scn.speeds)), seed=0,
                                  async_mu=False, use_alias=use_alias, device="cpu")
        pool = tr.SequentialPool(np.asarray(scn.speeds))
        tenv.run_workload(router, pool, wl_cut, fake_cost=scn.request_cost * 0.25)
        # the work it still owed was submitted before it left
        before = tr.SequentialPool(np.asarray(scn.speeds))
        r0 = tr.RosellaRouter(scn.n, mu_bar=float(np.sum(scn.speeds)), seed=0,
                              async_mu=False, use_alias=use_alias, device="cpu")
        tenv.run_workload(r0, before, dataclasses.replace(
            wl_cut, times=wl.times[:off[0]], costs=wl.costs[:off[0]],
            speeds=wl.speeds[:off[0]], active=wl.active[:off[0]],
            rejoin=wl.rejoin[:off[0]], burst=wl.burst[:off[0]]),
            fake_cost=scn.request_cost * 0.25)
        assert pool.free_at[1] == before.free_at[1]
        assert not bool(router.active[1])
    # after the rejoin the probe burst reaches replica 1
    rj = int(np.nonzero(wl.rejoin[:, 1])[0][0])
    assert (wl.burst[rj] == 1).sum() == scn.probe_burst


@pytest.mark.parametrize("name", PARITY)
def test_port_loops_on_the_reference_workload(name):
    """The reference's compiled arrays, copied field by field, through the
    port's host loop and the port's scan: equal to the port's own compile."""
    jwl = jenv.make(name, horizon=_horizon(name)).compile_serving(seed=SEED,
                                                                  arrival_batch=K)
    wl = tenv.ServingWorkload(**{f.name: getattr(jwl, f.name)
                                 for f in dataclasses.fields(tenv.ServingWorkload)})
    scn = tenv.make(name, horizon=_horizon(name))
    own = _port(name, sequential_pool=True)
    sp = np.asarray(scn.speeds)
    mk = lambda: tr.RosellaRouter(scn.n, mu_bar=float(sp.sum()), seed=SEED,  # noqa: E731
                                  async_mu=False, device="cpu")
    resp, mu, _ = tenv.run_workload(mk(), tr.SequentialPool(sp), wl,
                                    fake_cost=scn.request_cost * 0.25)
    np.testing.assert_array_equal(resp, own["responses"])
    np.testing.assert_array_equal(mu, own["mu_trace"])
    from repro_torch.serving import scanloop as tsl

    resp_s, mu_s, info = tsl.run_workload_scan(
        mk(), tr.SequentialPool(sp), wl.times, wl.costs, wl.speeds, active_np=wl.active,
        rejoin_np=wl.rejoin, burst_np=wl.burst, fake_cost=scn.request_cost * 0.25)
    assert info["pend_overflow"] == 0
    np.testing.assert_array_equal(resp_s, own["responses"])
    np.testing.assert_array_equal(mu_s, own["mu_trace"])


# ---------------------------------------------------------------------------
# (iii) against the reference's loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PARITY)
def test_host_loop_matches_the_reference(name):
    """The port's run_workload against the reference's, same scenario and
    seed, nothing shared: responses equal on every turn, μ̂ exact until
    EXACT_MU_TURNS[name] and within MU_ULPS after."""
    port = _port(name, sequential_pool=True)
    ref = jenv.run_scenario(jenv.make(name, horizon=_horizon(name)), seed=SEED,
                            arrival_batch=K, sequential_pool=True)
    _assert_reference_bars(ref, port, EXACT_MU_TURNS[name])


@pytest.mark.parametrize("name", PARITY)
def test_scan_matches_the_reference_scan(ref_scan, name):
    """The port's one-program loop against the reference's, the same bars."""
    port = _port(name, sequential_pool=True, use_scan=True)
    ref = ref_scan.run_scenario(ref_scan.make(name, horizon=_horizon(name)), seed=SEED,
                                arrival_batch=K, sequential_pool=True, use_scan=True)
    assert ref["info"]["pend_overflow"] == port["info"]["pend_overflow"] == 0
    _assert_reference_bars(ref, port, EXACT_MU_TURNS[name])


# ---------------------------------------------------------------------------
# (iv) the adaptation metrics
# ---------------------------------------------------------------------------


def test_adaptation_time_on_synthetic_trajectories():
    """tests/test_env.py's constructed trajectories, against the reference."""
    times = np.arange(0.0, 100.0, 1.0)
    shift = 40.0
    post = times >= shift
    err = np.full_like(times, 0.05)
    err[post] = 0.05 + 0.45 * np.exp(-(times[post] - shift) / 8.0)
    err2 = np.full_like(times, 0.05)
    err2[post] = np.where(times[post] < 60.0, 0.5, 0.04)
    cases = [(err, 20.0), (err2, 20.0), (np.full_like(times, 0.01), 20.0),
             (err2, 0.5), (err2[:50], 20.0)]
    for e, pre in cases:
        t = times[:len(e)]
        got = tmet.adaptation_time(t, e, shift, pre_window=pre)
        want = jmet.adaptation_time(t, e, shift, pre_window=pre)
        assert got == want or (np.isnan(got) and np.isnan(want))
    assert tmet.adaptation_time(times, err2, shift, pre_window=20.0) == pytest.approx(20.0)
    assert tmet.adaptation_time(times, np.full_like(times, 0.01), shift,
                                pre_window=20.0) == 0.0
    assert np.isnan(tmet.adaptation_time(times, err2, 0.0))  # no pre-shift window


@pytest.mark.parametrize("name", ["cotenant_shock", "churn_heavy"])
def test_adaptation_report_equals_the_reference(name):
    """The same μ̂ trace (the port's host run) through both metrics: the
    relative-error trace and the whole report equal."""
    out = tenv.run_scenario(tenv.make(name), seed=0, arrival_batch=K, device="cpu")
    wl, mu = out["workload"], out["mu_trace"]
    args = (wl.times[:, -1], mu, wl.speeds, wl.shift_times)
    got = tmet.adaptation_report(*args, active=wl.active)
    want = jmet.adaptation_report(*args, active=wl.active)
    np.testing.assert_array_equal(
        tmet.mu_rel_error_trace(mu, wl.speeds, wl.active),
        jmet.mu_rel_error_trace(mu, wl.speeds, wl.active))
    assert got["per_shift"] == want["per_shift"]
    for key in ("n_shifts", "n_unadapted", "mean", "max"):
        assert got[key] == want[key] or (np.isnan(got[key]) and np.isnan(want[key])), key
    if name == "cotenant_shock":
        assert got["n_shifts"] == 2 and got["n_unadapted"] < 2
        assert np.isfinite(got["mean"]) and got["mean"] >= 0.0


# ---------------------------------------------------------------------------
# (v) what is not ported yet
# ---------------------------------------------------------------------------


def _null_wl():
    return tenv.make("null", horizon=20.0).compile_serving(seed=0, arrival_batch=K)


def _router():
    return tr.RosellaRouter(5, mu_bar=6.5, seed=0, async_mu=False, device="cpu")


@pytest.mark.parametrize("case", ["policy", "crash_storm", "blackout", "recovery",
                                  "observe", "decisions", "scan_faults", "n_frontends",
                                  "to_sim"])
def test_what_is_not_ported_raises_naming_its_item(case):
    item = {"policy": "A3", "crash_storm": "A4", "blackout": "A4", "recovery": "A4",
            "observe": "A5", "decisions": "A5", "scan_faults": "A4", "n_frontends": "A6",
            "to_sim": "A8"}[case]
    if case == "policy":  # every policy runs since A3; the case stays, inverted
        out = tenv.run_scenario(tenv.make("null", horizon=20.0), policy="pss", device="cpu")
        assert np.isfinite(out["responses"]).all() and out["info"]["turns"] > 0
        assert out["router"].policy == "pss"
        return
    if item == "A4":  # failure semantics run since A4; the cases stay, inverted
        from repro_torch.core import metrics as tmet
        from repro_torch.serving import recovery as trcv

        if case in ("crash_storm", "blackout"):
            wl = tenv.make(case).compile_serving(seed=0, arrival_batch=K)
            assert wl.has_faults
            resp, _, info = tenv.run_workload(_router(), tr.SimulatedPool(tenv.BASE_SPEEDS),
                                              wl, fake_cost=0.25)
        elif case == "scan_faults":
            out = tenv.run_scenario(tenv.make("crash_storm"), use_scan=True, device="cpu")
            resp, info = out["responses"], out["info"]
        else:
            resp, _, info = tenv.run_workload(_router(), tr.SimulatedPool(tenv.BASE_SPEEDS),
                                              _null_wl(), fake_cost=0.25,
                                              recovery=trcv.INERT_RECOVERY)
            assert np.isfinite(resp).all()
        assert tmet.check_conservation(info["ledger"])[0]
        assert np.isfinite(resp).sum() == info["ledger"]["completed_tasks"] > 0
        return
    if case == "to_sim":  # the chain's environment mode runs since A8b; inverted
        from repro_torch.core import simulator as tsim
        from repro_torch.utils import prng

        cfg, params, e = tenv.make("churn").to_sim("ppot_sq2", rounds=300, device="cpu")
        assert e is not None and cfg.n == 5 and e.act_val.shape[1] == 5
        _, trace = tsim.simulate(cfg, params, prng.PRNGKey(0), e, device="cpu")
        assert trace["code"].shape == (300,) and torch.isfinite(trace["now"]).all()
        return
    if item == "A6":  # the fleet runs since A6; the case stays, inverted
        out = tenv.run_scenario(tenv.make("null", horizon=20.0), n_frontends=2,
                                use_scan=True, device="cpu")
        assert isinstance(out["router"], tr.FleetRouter) and out["router"].S == 2
        assert np.isfinite(out["responses"]).all() and out["info"]["turns"] > 0
        assert out["info"]["flush_overflow"] == out["info"]["pend_overflow"] == 0
        return
    if item == "A5":  # telemetry runs since A5; the cases stay, inverted
        from repro_torch import obs

        off = tenv.run_workload(_router(), tr.SimulatedPool(tenv.BASE_SPEEDS), _null_wl(),
                                fake_cost=0.25)
        kw = ({"observe": obs.ObserveConfig(window_turns=4)} if case == "observe"
              else {"decisions": obs.DecisionTrace()})
        resp, _, info = tenv.run_workload(_router(), tr.SimulatedPool(tenv.BASE_SPEEDS),
                                          _null_wl(), fake_cost=0.25, **kw)
        np.testing.assert_array_equal(resp, off[0])
        if case == "observe":
            assert len(info["windows"]) == -(-info["turns"] // 4)
        else:
            assert sum(e[0] == "complete" for e in kw["decisions"].ring) == resp.size
        return
    with pytest.raises(NotImplementedError, match=f"not ported yet.*{item}"):
        if case in ("crash_storm", "blackout"):
            wl = tenv.make(case).compile_serving(seed=0, arrival_batch=K)
            assert wl.has_faults
            tenv.run_workload(_router(), tr.SimulatedPool(tenv.BASE_SPEEDS), wl,
                              fake_cost=0.25)
        elif case == "scan_faults":
            tenv.run_scenario(tenv.make("crash_storm"), use_scan=True, device="cpu")
        else:
            tenv.make("churn").to_sim("ppot_sq2")


def test_run_scenario_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenv.run_scenario(tenv.make("null", horizon=20.0))

