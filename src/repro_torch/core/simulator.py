"""The paper's coupled chain (§4): a discrete-event queueing simulator.

One round is one jump of the uniformized continuous-time chain, at the
constant rate R = λ + Σ_i μmax_i + νmax:

  * with prob λ/R       a job of 1..max_tasks tasks arrives and is placed as
                        one batch through the dispatch engine
                        (``core.dispatch``; ``batch_self_correct`` decides
                        whether the tasks of a job see each other's
                        placements), and the arrival estimator updates;
  * with prob μmax_i/R  a potential service event at worker i, accepted with
                        prob μ_i(t)/μmax_i (thinning handles speeds that
                        change); the real queue drains before the fake one;
  * with prob νmax/R    a potential benchmark-job dispatch, accepted with
                        prob c0(μ̄ − λ̂)/νmax, to a uniform worker, throttled
                        by ``fake_cap``;
  * otherwise           a self-loop.

``dt ~ Exp(R)`` gives exact timestamps. Worker speeds follow a phase
schedule ``mu_schedule[K, n]`` switching every ``phase_period``. A
completion at time t feeds the learner the exact Exp(μ_i) sample
``t − busy_start[i]``. The chain emits one trace row a round; response
times, percentiles and queue histograms come from ``core.metrics``.

Every random quantity of a round depends only on the seed and the round
index, so ``draw_rounds`` makes all of them for all rounds at once,
whichever branch a round takes, from the reference's keys: the run's key
splits into one key a round, and each round's key into the keys of ``dt``,
of the event, of the branch and of the learner refresh. What is left is a
sequential integer-and-float state machine over the n workers: the
``sim_chain`` kernel on the card, its plain version (``kernels/sim_chain/
ref.py``) on the CPU. Its float sums run left to right, so the kernel
equals its plain version bit for bit on the same draws.

**Environment mode** (``env=``, an ``EnvSchedule``, as
``env.Scenario.to_sim`` compiles it): piecewise λ(t), μ(t) and membership,
with blackouts (a stalled mask) and crashes. The chain uniformizes at λmax
(``SimParams.lam``) and thins each arrival by λ(now)/λmax; μmax is taken
over the μ segments; dispatch, pins and benchmark targets draw over the
active workers only (uniform floats through ``dispatch.active_choice``
where the paper mode draws ``randint``); a membership change cold-starts
the rejoining workers in the learner, gives them a benchmark-job burst and
forces a fleet sync; a blackout thins its worker's service events to
self-loops; a crash empties its worker's queues (the ``killed`` column).

**Fleet mode** (``n_frontends = S > 1`` or ``fleet_sync_every != 1``): each
job goes to one frontend (``frontend_lb``: uniform, weighted or sticky),
which dispatches against its stale view (the queues at the last sync plus
its own placements since) and its μ view frozen at the last sync, with the
herd correction if asked; the views reconcile every ``fleet_sync_every``
rounds. The trace's ``frontend`` / ``view_gap`` / ``sync_age`` columns
feed ``core.metrics.fleet_summary_from_trace``.

**In-chain telemetry** (``SimConfig.observe``, an ``obs.ObserveConfig``,
in any mode): the windowed fold of ``obs.windows.observe_turn`` once a
round, read-only on the chain (windows span ``window_turns`` rounds;
arrivals and launches count the round's dispatched tasks, completions its
real completion, whose exact service time is the histogram's one sample,
kills the crash track's emptied queue), with the regime detector at the
window boundaries. The trace gains the reference's ``obs_row`` (a
``TelemetryCarry`` of [T, ...] tensors, each round's post-fold, pre-reset
row) and ``obs_flag`` (bool [T]) for ``obs.windows.sim_records_from_trace``.

The paper's own mode (no environment, one frontend synced every round)
runs the program it always ran; the other modes run on the same kernel
built with them (``kernels/sim_chain``), and a batch with telemetry on the
kernel's telemetry instances.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dispatch as dsp
from repro_torch.core import estimator as est
from repro_torch.core import learner as lrn
from repro_torch.core import policies as pol
from repro_torch.fleet import state as flt
from repro_torch.kernels.sim_chain import kernel as chain_kernel
from repro_torch.kernels.sim_chain import ref as chain_ref
from repro_torch.obs import windows as obw
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

f32 = np.float32

# Event codes in the trace.
EV_ARRIVAL = 0
EV_REAL_DONE = 1
EV_FAKE_DONE = 2
EV_FAKE_DISPATCH = 3
EV_SELF_LOOP = 4

#: the load balancers in front of the frontends (``SimConfig.frontend_lb``)
LB_MODES = ("uniform", "weighted", "sticky")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration."""

    n: int  # number of workers
    policy: str  # one of policies.ALL_POLICIES
    rounds: int  # chain length T
    max_tasks: int = 1  # max tasks per job
    use_learner: bool = True  # False -> the policy sees the true μ(t) ("known speeds")
    use_fake_jobs: bool = True
    fake_cap: int = 4  # per-worker fake-queue throttle (paper §5)
    arrival_window: int = 64  # S of the arrival estimator
    window_mode: str = "practical"  # learner window mode
    c_window: float = 10.0
    c0: float = 0.1
    learner_refresh: int = 8  # rounds between LEARNER-AGGREGATE refreshes
    trace_queues: bool = True
    trace_mu: bool = True
    constrained_frac: float = 0.0  # fraction of tasks pinned to a random worker
    ring_cap: int = lrn.RING_CAP
    # True: the tasks of one job see each other's placements (engine
    # fold_chunks = max_tasks); False: the whole job places against one
    # queue snapshot
    batch_self_correct: bool = True
    # the frontend fleet: S frontends, each dispatching against its stale
    # view, reconciled every fleet_sync_every rounds (<= 0: only at t = 0);
    # S = 1 synced every round is the paper's own chain
    n_frontends: int = 1
    fleet_sync_every: int = 1
    # True: inflate each view by the other S - 1 frontends' expected
    # placements since the last sync (fleet.conflict)
    fleet_herd_correction: bool = False
    # True: μ̂-proportional probes draw through the view's Walker alias
    # table; False: the inverse-CDF draw
    use_alias: bool = True
    # how jobs split over the frontends: uniform, weighted (by
    # SimParams.lb_weights) or sticky (round-robin by job ordinal)
    frontend_lb: str = "uniform"
    # in-chain telemetry: an obs.ObserveConfig folded once a round (windows
    # of window_turns rounds), the trace gaining obs_row / obs_flag; None
    # runs the chain without it
    observe: "obw.ObserveConfig | None" = None


@dataclasses.dataclass(frozen=True)
class EnvSchedule:
    """An environment's piecewise-constant processes (λ(t), μ(t), the active
    mask, blackouts and crashes): each axis is segment starts ``bp`` (bp[0]
    = 0, ascending) and values, segment i holding on [bp[i], bp[i + 1]).
    With an environment, ``SimParams.lam`` is λmax = max(lam_val)."""

    lam_bp: torch.Tensor  # f32[Ka]
    lam_val: torch.Tensor  # f32[Ka]
    mu_bp: torch.Tensor  # f32[Kc]
    mu_val: torch.Tensor  # f32[Kc, n]
    act_bp: torch.Tensor  # f32[Km]
    act_val: torch.Tensor  # bool[Km, n]
    burst: torch.Tensor  # i32 fake-job probe burst per rejoining worker
    stall_bp: torch.Tensor | None = None  # f32[Ks] blackouts: the stalled mask
    stall_val: torch.Tensor | None = None  # bool[Ks, n]
    crash_t: torch.Tensor | None = None  # f32[C] crash instants (ascending)
    crash_w: torch.Tensor | None = None  # i32[C] the crashed worker of each

    def to(self, device) -> "EnvSchedule":
        return EnvSchedule(**{f.name: None if getattr(self, f.name) is None
                              else torch.as_tensor(getattr(self, f.name)).to(device)
                              for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Dynamic inputs, f32 tensors on one device."""

    lam: torch.Tensor  # arrival rate (0-d)
    mu_schedule: torch.Tensor  # [K, n] per-phase worker speeds
    phase_period: torch.Tensor  # time between speed shuffles (inf -> static)
    mu_bar: torch.Tensor  # guaranteed total throughput μ̄
    mu_hat0: torch.Tensor  # [n] initial estimates
    task_logits: torch.Tensor  # [max_tasks] log P(job has k + 1 tasks)
    lb_weights: torch.Tensor  # [S] frontend weights

    def to(self, device) -> "SimParams":
        return SimParams(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class SimState:
    """The chain's state after its last round."""

    now: torch.Tensor  # f32 0-d
    q_real: torch.Tensor  # i32[n]
    q_fake: torch.Tensor  # i32[n]
    s_real: torch.Tensor  # i32[n] cumulative real completions
    busy_start: torch.Tensor  # f32[n]
    arr: est.ArrivalEstimatorState
    learner: lrn.LearnerState
    # the frontends' stale views and λ̂ streams (stacked over S) and the
    # next crash of the fault track; None and 0 in the paper's own mode,
    # whose chain keeps no fleet apart from the true queues
    fleet: flt.FleetSimState | None = None
    crash_i: torch.Tensor | None = None


def make_params(lam: float, mu, *, mu_schedule=None, phase_period: float = float("inf"),
                mu_bar: float | None = None, mu_hat0=None, task_probs=None,
                max_tasks: int = 1, lb_weights=None, device=None) -> SimParams:
    """The chain's dynamic inputs; ``device=None`` is the CUDA card. The
    default μ̄ is the first phase's speeds summed left to right in f32."""
    dev = resolve_device(device)
    mu = np.asarray(mu, np.float32)
    sched = (np.asarray(mu_schedule, np.float32) if mu_schedule is not None
             else mu[None, :])
    if mu_bar is None:
        mu_bar = float(chain_ref.seq_cumsum(sched[0])[-1])
    if mu_hat0 is None:
        mu_hat0 = np.ones_like(mu)
    if task_probs is None:
        probs = np.zeros((max_tasks,), np.float32)
        probs[0] = 1.0
    else:
        probs = np.asarray(task_probs, np.float32)
        probs = probs / chain_ref.seq_cumsum(probs)[-1]
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev)  # noqa: E731
    return SimParams(
        lam=t(f32(lam)), mu_schedule=t(sched), phase_period=t(f32(phase_period)),
        mu_bar=t(f32(mu_bar)), mu_hat0=t(mu_hat0),
        task_logits=torch.log(t(probs).clamp(min=1e-30)),
        lb_weights=t(np.ones(1) if lb_weights is None else lb_weights))


def _current_mu(params: SimParams, now) -> torch.Tensor:
    """The speeds of the phase that holds ``now`` (f32)."""
    K = params.mu_schedule.shape[0]
    if K == 1:
        return params.mu_schedule[0]
    period = f32(params.phase_period.item())
    phase = int(f32(now) / period) % K if np.isfinite(period) else 0
    return params.mu_schedule[phase]


def uses_ext(cfg: SimConfig, env=None) -> bool:
    """Whether a run leaves the paper's own mode: an environment, several
    frontends, or a sync cadence other than every round."""
    return env is not None or cfg.n_frontends != 1 or cfg.fleet_sync_every != 1


def refuse_other_modes(cfg: SimConfig, env=None, params: SimParams | None = None) -> None:
    """Raise on what the chain does not run: the reference's own refusals,
    and an ``observe`` that is not an ``obs.ObserveConfig``."""
    if cfg.observe is not None and not isinstance(cfg.observe, obw.ObserveConfig):
        raise TypeError(f"observe must be an obs.ObserveConfig or None, got "
                        f"{type(cfg.observe).__name__}")
    if cfg.n_frontends < 1:
        raise ValueError(f"n_frontends={cfg.n_frontends}: need at least one frontend")
    if cfg.frontend_lb not in LB_MODES:
        raise ValueError(f"frontend_lb={cfg.frontend_lb!r}: choose uniform|weighted|sticky")
    if (params is not None and cfg.frontend_lb == "weighted"
            and params.lb_weights.shape[0] != cfg.n_frontends):
        raise ValueError(
            f"frontend_lb='weighted' needs lb_weights of length n_frontends="
            f"{cfg.n_frontends}, got {params.lb_weights.shape[0]} (pass lb_weights= to "
            "make_params)")
    if env is not None and env.mu_val.shape[-1] != cfg.n:
        raise ValueError(f"env: mu_val has {env.mu_val.shape[-1]} workers, the config {cfg.n}")
    if cfg.policy not in pol.ALL_POLICIES:
        raise ValueError(f"unknown policy {cfg.policy!r}; choose from {pol.ALL_POLICIES}")
    if cfg.window_mode not in ("practical", "theory"):
        raise ValueError(f"window_mode={cfg.window_mode!r}: choose practical|theory")


# ---------------------------------------------------------------------------
# The draws
# ---------------------------------------------------------------------------


def probe_width(cfg: SimConfig, pcfg: pol.PolicyConfig) -> int:
    """J, the integer policy draws a round: two per slot (PoT's pair,
    bandit's uniform worker and explore flag) or Sparrow's probes."""
    mt = cfg.max_tasks
    return max(2 * mt, int(pcfg.sparrow_d) * mt, mt)


def uses_table(cfg: SimConfig) -> bool:
    """Whether the policy's probes draw through the alias table."""
    return cfg.use_alias and cfg.policy in dsp.ALIAS_POLICIES


def rates_of(cfg: SimConfig, params: SimParams, env: EnvSchedule | None = None):
    """(R f32, logits f32[n + 2], μmax f32[n], νmax f32): the uniformized
    chain's rates. R is (λ + Σμmax) + νmax with Σ left to right: the
    grouping the reference's compiled sum of [λ, μmax, νmax] takes in most
    of its programs (XLA splits the sum of a concatenation into the sums
    of its parts); where it takes another, dt parts from the reference's
    by an ulp. μmax is over the phases, or over the environment's μ
    segments."""
    sched = params.mu_schedule if env is None else env.mu_val.to(params.lam.device)
    mu_max = sched.max(0).values
    nu_max = (torch.full_like(params.mu_bar, float(f32(cfg.c0))) * params.mu_bar
              if cfg.use_fake_jobs else torch.zeros_like(params.mu_bar))
    rates = torch.cat([params.lam[None], mu_max, nu_max[None]])
    R = f32(params.lam.item()) + chain_ref.seq_cumsum(mu_max.cpu().numpy())[-1]
    R = R + f32(nu_max.item())
    return f32(R), torch.log(rates.clamp(min=1e-30)), mu_max, nu_max


def _policy_draws(cfg: SimConfig, pcfg: pol.PolicyConfig, kd: torch.Tensor, J: int,
                  masked: bool = False):
    """The policy's raw draws for ``max_tasks`` slots from the engine keys
    kd [T, 2], as the engine's ``_draws`` makes them: u f32[T, 4, mt] (rows
    u1, u2, v1, v2), j i32[T, J] (uniform workers, PoT's pair, bandit's
    worker and explore flag, or Sparrow's probes) and uj f32[T, J]. Under
    a membership mask (``masked``) the uniform workers are drawn as
    uniform floats into uj, at their places in j, for
    ``dispatch.active_choice``; uj is zeros otherwise."""
    T, mt, n = kd.shape[0], cfg.max_tasks, cfg.n
    dev = kd.device
    u = torch.zeros(T, 4, mt, dtype=torch.float32, device=dev)
    j = torch.zeros(T, J, dtype=torch.int32, device=dev)
    uj = torch.zeros(T, J, dtype=torch.float32, device=dev)
    table = uses_table(cfg)
    p = cfg.policy

    def workers(k, shape, at):  # the uniform worker draws, into j or uj
        if masked:
            uj[:, at] = prng.vuniform(k, shape).reshape(T, -1)
        else:
            j[:, at] = prng.vrandint(k, shape, 0, n).reshape(T, -1)

    def probe_uniforms(k):
        if table:
            u[:] = torch.stack(prng.vuniform_quad(k, mt), 1)
        else:
            u[:, :2] = torch.stack(prng.vuniform_pair(k, mt), 1)

    if p == pol.UNIFORM:
        workers(kd, (mt,), slice(0, mt))
    elif p == pol.POT:
        workers(kd, (2, mt), slice(0, 2 * mt))
    elif p == pol.PSS and table:
        u1, _, v1, _ = prng.vuniform_quad(kd, mt)
        u[:, 0], u[:, 2] = u1, v1
    elif p in (pol.PSS, pol.HALO):
        u[:, 0] = prng.vuniform(kd, (mt,))
    elif p in (pol.PPOT_SQ2, pol.PPOT_LL2):
        probe_uniforms(kd)
    elif p == pol.BANDIT:
        ks = prng.vsplit(kd, 3)
        probe_uniforms(ks[:, 0])
        workers(ks[:, 2], (mt,), slice(0, mt))
        j[:, mt:2 * mt] = (prng.vuniform(ks[:, 1], (mt,)) < pol.eta_f32(pcfg)).to(torch.int32)
    elif p == pol.SPARROW:
        P = max(int(pcfg.sparrow_d) * mt, mt)
        workers(kd, (P,), slice(0, P))
    return u, j, uj


def draw_rounds(cfg: SimConfig, params: SimParams, key, device=None,
                env: EnvSchedule | None = None) -> dict:
    """Every random quantity of every round, drawn at once on ``device``
    (``None``: the card) from the run's ``key`` (a host key or an int64
    tensor [2]). Columns, T = ``cfg.rounds``:

      dt      f32[T]   Exp(R) time to the jump (``exponential / R``)
      ev      i32[T]   the event: 0 arrival, 1..n service at worker ev-1,
                       n+1 benchmark dispatch
      u_svc   f32[T]   the service event's acceptance uniform
      u_fake  f32[T]   the benchmark dispatch's acceptance uniform
      j_fake  i32[T]   its target worker
      n_tasks i32[T]   the arriving job's task count
      pins    i32[T, mt]  the constrained tasks' pinned workers, -1 if free
      u, j    the policy's raw draws (``_policy_draws``)

    Outside the paper's own mode (``uses_ext``) five more:

      u_thin  f32[T]      the arrival's thinning uniform (environment)
      fe      i32[T]      the job's frontend draw (uniform: randint(0, S);
                          weighted: a categorical over lb_weights; sticky: 0,
                          the chain takes the job ordinal)
      u_pin   f32[T, mt]  the pins' uniforms over the active workers
      u_jfake f32[T]      the benchmark target's uniform over them
      uj      f32[T, J]   the policy's uniform worker draws over them

    the last three only under an environment (zeros otherwise), where every
    uniform worker is drawn as a float for ``dispatch.active_choice`` and
    ``pins`` holds 0 for a pinned task, -1 for a free one.

    A round's key splits into (k_dt, k_ev, k_br, k_refresh); the branch key
    k_br is the service uniform itself, split in two for the benchmark
    dispatch (accept, target) and for an arrival (task count, engine),
    whose engine key splits in three (constrained flags, pins, policy).
    The thinning uniform is ``fold_in(k_br, 0x7A11)``'s, the frontend draw
    ``fold_in`` of the arrival's engine key with 0x5EED."""
    dev = resolve_device(device)
    params = params.to(dev)
    T, n, mt = cfg.rounds, cfg.n, cfg.max_tasks
    masked = env is not None
    pcfg = pol.default_policy_config()
    R, logits, _, _ = rates_of(cfg, params, env)
    key = key.to(dev) if isinstance(key, torch.Tensor) else prng.device_key(key, dev)
    ks = prng.vsplit(prng.split(key, T), 4)  # [T, 4, 2]
    k_br = ks[:, 2]
    fake = prng.vsplit(k_br, 2)
    arrival = prng.vsplit(k_br, 2)
    eng = prng.vsplit(arrival[:, 1], 3)
    u_pin = torch.zeros(T, mt, dtype=torch.float32, device=dev)
    if cfg.constrained_frac > 0.0:
        pinned = prng.vuniform(eng[:, 0], (mt,)) < float(f32(cfg.constrained_frac))
        if masked:
            pins = torch.where(pinned, 0, -1)
            u_pin = prng.vuniform(eng[:, 1], (mt,))
        else:
            pins = torch.where(pinned, prng.vrandint(eng[:, 1], (mt,), 0, n), -1)
    else:
        pins = torch.full((T, mt), -1, dtype=torch.int32, device=dev)
    u, j, uj = _policy_draws(cfg, pcfg, eng[:, 2], probe_width(cfg, pcfg), masked)
    out = {
        "dt": prng.vexponential(ks[:, 0], ()) / torch.tensor(R, device=dev),
        "ev": prng.vcategorical(ks[:, 1], logits),
        "u_svc": prng.vuniform(k_br, ()),
        "u_fake": prng.vuniform(fake[:, 0], ()),
        "j_fake": prng.vrandint(fake[:, 1], (), 0, n),
        "n_tasks": 1 + prng.vcategorical(arrival[:, 0], params.task_logits),
        "pins": pins.to(torch.int32),
        "u": u,
        "j": j,
    }
    if not uses_ext(cfg, env):
        return out
    zeros = torch.zeros(T, dtype=torch.float32, device=dev)
    k_lb = prng.vfold_in(arrival[:, 1], 0x5EED)
    if cfg.frontend_lb == "weighted":
        fe = prng.vcategorical(k_lb, torch.log(params.lb_weights.clamp(min=1e-30)))
    elif cfg.frontend_lb == "sticky":
        fe = torch.zeros(T, dtype=torch.int32, device=dev)
    else:
        fe = prng.vrandint(k_lb, (), 0, cfg.n_frontends)
    out.update(
        u_thin=prng.vuniform(prng.vfold_in(k_br, 0x7A11), ()) if masked else zeros,
        fe=fe.to(torch.int32), u_pin=u_pin,
        u_jfake=prng.vuniform(fake[:, 1], ()) if masked else zeros, uj=uj)
    return out


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------


def chain_config(cfg: SimConfig, params: SimParams):
    """One chain's runtime configuration as the kernel takes it: (conf_i
    i32[NI], conf_f f32[NF]) on the params' device; see
    ``kernels.sim_chain.ref`` for the fields."""
    n = cfg.n
    _, _, _, nu_max = rates_of(cfg, params)
    theory_num = f32(cfg.c_window) * np.log(f32(max(n, 2)))
    ci = [0] * chain_ref.NI
    ci[chain_ref.POLICY] = pol.ALL_POLICIES.index(cfg.policy)
    ci[chain_ref.ROUNDS] = cfg.rounds
    ci[chain_ref.USE_LEARNER] = int(cfg.use_learner)
    ci[chain_ref.USE_FAKE] = int(cfg.use_fake_jobs)
    ci[chain_ref.FAKE_CAP] = cfg.fake_cap
    ci[chain_ref.REFRESH] = cfg.learner_refresh
    ci[chain_ref.FOLD] = cfg.max_tasks if cfg.batch_self_correct else 1
    ci[chain_ref.USE_TABLE] = int(uses_table(cfg))
    ci[chain_ref.THEORY] = int(cfg.window_mode == "theory")
    ci[chain_ref.PHASES] = params.mu_schedule.shape[0]
    cf = [0.0] * chain_ref.NF
    cf[chain_ref.MU_BAR] = params.mu_bar.item()
    cf[chain_ref.PERIOD] = params.phase_period.item()
    cf[chain_ref.NU_MAX] = nu_max.item()
    cf[chain_ref.C0] = float(f32(cfg.c0))
    cf[chain_ref.C_WINDOW] = float(f32(cfg.c_window))
    cf[chain_ref.THEORY_NUM] = float(theory_num)
    dev = params.mu_bar.device
    return (torch.tensor(ci, dtype=torch.int32, device=dev),
            torch.tensor(cf, dtype=torch.float32, device=dev))


def ext_config(cfg: SimConfig, params: SimParams, env: EnvSchedule | None) -> dict:
    """One chain's environment and fleet inputs as the kernel takes them
    (``kernels.sim_chain.ref.EXT``): conf_x i32[NX], conf_xf f32[NXF] and
    the environment's tracks, each at least one row long. Without an
    environment the tracks are one segment of the paper's values, which
    the chain does not read (conf_x ENV = 0)."""
    dev = params.mu_bar.device
    n = cfg.n
    f = dict(dtype=torch.float32, device=dev)
    i = dict(dtype=torch.int32, device=dev)
    cx = [0] * chain_ref.NX
    cx[chain_ref.ENV] = int(env is not None)
    cx[chain_ref.FRONTENDS] = cfg.n_frontends
    cx[chain_ref.SYNC_EVERY] = cfg.fleet_sync_every
    cx[chain_ref.HERD] = int(cfg.fleet_herd_correction and cfg.n_frontends > 1)
    cx[chain_ref.LB] = LB_MODES.index(cfg.frontend_lb)
    if env is None:
        tracks = dict(lam_bp=torch.zeros(1, **f), lam_val=params.lam.reshape(1).to(**f),
                      mu_bp=torch.zeros(1, **f), mu_val=params.mu_schedule[:1].to(**f),
                      act_bp=torch.zeros(1, **f), act_val=torch.ones(1, n, **i))
    else:
        env = env.to(dev)
        tracks = dict(lam_bp=env.lam_bp.to(**f), lam_val=env.lam_val.to(**f),
                      mu_bp=env.mu_bp.to(**f), mu_val=env.mu_val.to(**f),
                      act_bp=env.act_bp.to(**f), act_val=env.act_val.to(**i))
        cx[chain_ref.BURST] = int(env.burst)
    has_stall = env is not None and env.stall_bp is not None
    has_crash = env is not None and env.crash_t is not None
    tracks.update(
        stall_bp=env.stall_bp.to(**f) if has_stall else torch.zeros(1, **f),
        stall_val=env.stall_val.to(**i) if has_stall else torch.zeros(1, n, **i),
        crash_t=env.crash_t.to(**f) if has_crash else torch.zeros(1, **f),
        crash_w=env.crash_w.to(**i) if has_crash else torch.zeros(1, **i))
    cx[chain_ref.KA] = tracks["lam_bp"].shape[0]
    cx[chain_ref.KC] = tracks["mu_bp"].shape[0]
    cx[chain_ref.KM] = tracks["act_bp"].shape[0]
    cx[chain_ref.KS] = tracks["stall_bp"].shape[0] if has_stall else 0
    cx[chain_ref.KCRASH] = tracks["crash_t"].shape[0] if has_crash else 0
    cxf = [0.0] * chain_ref.NXF
    cxf[chain_ref.LAM_MAX] = params.lam.item()
    return dict(conf_x=torch.tensor(cx, **i), conf_xf=torch.tensor(cxf, **f), **tracks)


def obs_config(cfg: SimConfig, params: SimParams, bins: int) -> dict:
    """One chain's telemetry inputs as the kernel takes them
    (``kernels.sim_chain.ref.OBS``): conf_o i32[NO], conf_of f32[NOF] and
    the histogram's thresholds padded with +inf to ``bins`` (the batch's
    most); all zeros and +inf, with conf_o OBS_ON 0, without telemetry."""
    dev = params.mu_bar.device
    o, d = cfg.observe, None if cfg.observe is None else cfg.observe.detect
    co = [0] * chain_ref.NO
    cof = [0.0] * chain_ref.NOF
    thr = np.full(bins, np.inf, np.float32)
    if o is not None:
        co[chain_ref.OBS_ON], co[chain_ref.WINDOW], co[chain_ref.BINS] = 1, o.window_turns, \
            o.hist_bins
        thr[:o.hist_bins - 1] = obw.hist_thresholds(o)
        cof[chain_ref.INV_N] = float(f32(1.0 / cfg.n))
    if d is not None:
        co[chain_ref.DETECT], co[chain_ref.WARMUP], co[chain_ref.COOLDOWN] = \
            1, d.warmup_windows, d.cooldown_windows
        for k, v in ((chain_ref.EMA_ALPHA, d.ema_alpha), (chain_ref.REBASE_ALPHA,
                                                          d.rebaseline_alpha),
                     (chain_ref.K_SIGMA, d.k_sigma), (chain_ref.H_SIGMA, d.h_sigma),
                     (chain_ref.ABS_FLOOR, d.abs_floor), (chain_ref.DECAY, d.cusum_decay),
                     (chain_ref.CLIP_Z, d.clip_z), (chain_ref.SCALE_CLIP_Z, d.scale_clip_z)):
            cof[k] = float(f32(v))
        for i, v in enumerate(d.rel_floor):
            cof[chain_ref.REL_FLOOR + i] = float(f32(v))
    return dict(conf_o=torch.tensor(co, dtype=torch.int32, device=dev),
                conf_of=torch.tensor(cof, dtype=torch.float32, device=dev),
                obs_thr=torch.from_numpy(thr).to(dev))


def obs_bins(runs) -> int | None:
    """The most histogram bins of the runs' telemetry, None if none has it."""
    bins = [r[0].observe.hist_bins for r in runs if r[0].observe is not None]
    return max(bins) if bins else None


def chain_shape(cfg: SimConfig) -> dict:
    """The shape-level statics a batch of chains must share."""
    return dict(n=cfg.n, mt=cfg.max_tasks, ring_cap=cfg.ring_cap,
                arrival_window=cfg.arrival_window, trace_queues=cfg.trace_queues,
                trace_mu=cfg.trace_mu)


def _run_parts(run) -> tuple:
    """(cfg, params, key, env) of a run given as (cfg, params, key) or
    (cfg, params, key, env)."""
    return tuple(run) + (None,) * (4 - len(run))


def _pad_rows(x, rows):  # [r, ...] -> [rows, ...] with zeros after r
    out = x.new_zeros((rows,) + tuple(x.shape[1:]))
    out[:x.shape[0]] = x
    return out


def chain_inputs(runs, draws: "list[dict]", device, ext: bool | None = None) -> tuple:
    """The ``sim_chain`` call of several runs ((SimConfig, SimParams, key[,
    env]) that agree on ``chain_shape``) with their draws: (args, kwargs),
    the draw columns padded with zeros to the longest run and the speed
    schedules to the most phases. Where any run leaves the paper's mode
    (``uses_ext``), or ``ext`` asks for it, args gains the environment and
    fleet inputs (``ext_config``, each track padded to the longest) and
    every run's draws the extra columns (zeros where it has none): the
    environment and fleet program, which runs a paper-mode chain as the
    paper's own program does. Where any run has telemetry, args also gains
    the environment and fleet inputs or None, then the telemetry inputs
    (``obs_config``, one row a run)."""
    dev = resolve_device(device)
    runs = [_run_parts(r) for r in runs]
    shapes = {tuple(sorted(chain_shape(cfg).items())) for cfg, _, _, _ in runs}
    if len(shapes) != 1:
        raise ValueError(f"simulate_many: the runs' shapes differ: {sorted(shapes)}")
    ps = [params.to(dev) for _, params, _, _ in runs]
    T = max(cfg.rounds for cfg, _, _, _ in runs)
    K = max(p.mu_schedule.shape[0] for p in ps)
    confs = [chain_config(cfg, p) for (cfg, _, _, _), p in zip(runs, ps)]
    if ext is None:
        ext = any(uses_ext(cfg, env) for cfg, _, _, env in runs)
    if ext:
        cfg0 = runs[0][0]
        J = draws[0]["j"].shape[1]
        filler = {"u_thin": (torch.float32, ()), "fe": (torch.int32, ()),
                  "u_pin": (torch.float32, (cfg0.max_tasks,)),
                  "u_jfake": (torch.float32, ()), "uj": (torch.float32, (J,))}
        draws = [dict(d, **{k: torch.zeros((d["dt"].shape[0],) + sh, dtype=dt, device=dev)
                            for k, (dt, sh) in filler.items() if k not in d})
                 for d in draws]
    cols = {name: torch.stack([_pad_rows(d[name].to(dev), T) for d in draws])
            for name in draws[0]}
    args = (torch.stack([c[0] for c in confs]), torch.stack([c[1] for c in confs]),
            torch.stack([_pad_rows(p.mu_schedule, K) for p in ps]),
            torch.stack([p.mu_hat0 for p in ps]), cols)
    if ext:
        xs = [ext_config(cfg, p, env) for (cfg, _, _, env), p in zip(runs, ps)]
        args += ({name: torch.stack([_pad_rows(x[name], max(y[name].shape[0] for y in xs))
                                     for x in xs]) for name in xs[0]},)
    HB = obs_bins(runs)
    if HB is not None:
        os_ = [obs_config(cfg, p, HB) for (cfg, _, _, _), p in zip(runs, ps)]
        args += (() if ext else (None,)) + (
            {name: torch.stack([o[name] for o in os_]) for name in chain_ref.OBS},)
    return args, chain_shape(runs[0][0])


def simulate_many(runs, device=None, draws: "list[dict] | None" = None):
    """Run several chains in one ``sim_chain`` call: ``runs`` is a list of
    (SimConfig, SimParams, key) or (SimConfig, SimParams, key, env) that
    agree on ``chain_shape``; each chain keeps its own policy, flags,
    rounds, params, environment, fleet and draws. ``draws`` (one
    ``draw_rounds`` dict a run) replaces the chains' own draws. Returns a
    list of (SimState, trace), each trace cut to its run's rounds (and
    ``killed`` to width 0 where the run has no crash track); a run with
    telemetry has ``obs_row`` and ``obs_flag`` in its trace."""
    dev = resolve_device(device)
    runs = [_run_parts(r) for r in runs]
    for cfg, params, _, env in runs:
        refuse_other_modes(cfg, env, params)
    if draws is None:
        draws = [draw_rounds(cfg, params, key, dev, env) for cfg, params, key, env in runs]
    args, shape = chain_inputs(runs, draws, dev)
    final, trace = chain_kernel.sim_chain(*args, **shape)
    HB = obs_bins(runs)
    out = []
    for c, (cfg, _, _, env) in enumerate(runs):
        tr = {name: v[c, :cfg.rounds] for name, v in trace.items()}
        if env is None or env.crash_t is None:
            tr["killed"] = tr["killed"][:, :0]
        words = tr.pop("obs", None)
        if cfg.observe is not None:
            tr["obs_row"], tr["obs_flag"] = obw.rows_from_words(words, HB,
                                                                cfg.observe.hist_bins)
        out.append((_state_of({name: v[c] for name, v in final.items()}, cfg, env), tr))
    return out


def _state_of(f: dict, cfg: SimConfig, env: EnvSchedule | None) -> SimState:
    fleet = crash_i = None
    if uses_ext(cfg, env) and "q_snap" in f:
        S = cfg.n_frontends
        rows = lambda v: v[None].expand(S, -1).contiguous()  # noqa: E731
        fleet = flt.FleetSimState(
            q_snap=rows(f["q_snap"]), q_delta=f["q_delta"][:S].contiguous(),
            mu_view=rows(f["mu_view"]), alias_p=rows(f["alias_p"]),
            alias_a=rows(f["alias_a"]),
            arr=est.EmaArrivalState(last_time=f["ema_last"][:S], mean_gap=f["ema_gap"][:S],
                                    count=f["ema_count"][:S]),
            t_sync=f["t_sync"].expand(S).contiguous(), lam_global=f["lam_global"])
        crash_i = f["crash_i"]
    return SimState(
        now=f["now"], q_real=f["q_real"], q_fake=f["q_fake"], s_real=f["s_real"],
        busy_start=f["busy_start"],
        arr=est.ArrivalEstimatorState(times=f["arr_times"], idx=f["arr_idx"],
                                      count=f["arr_count"], lam_hat=f["lam_hat"]),
        learner=lrn.LearnerState(samples=f["samples"], stamps=f["stamps"], widx=f["widx"],
                                 count=f["count"], epoch_start=f["epoch_start"],
                                 mu_hat=f["mu_hat"]),
        fleet=fleet, crash_i=crash_i)


def simulate(cfg: SimConfig, params: SimParams, key, env: EnvSchedule | None = None, *,
             device=None):
    """Run the chain for ``cfg.rounds`` jumps on ``device`` (``None``: the
    card, through the ``sim_chain`` kernel; ``"cpu"``: its plain version),
    in the environment ``env`` if given. Returns ``(final_state, trace)``
    with the reference's trace columns: code, worker, n_tasks, task_workers
    [T, mt], task_targets [T, mt], frontend, view_gap, sync_age, now,
    lam_hat, killed [T, n] (width 0 without a crash track), killed_fake,
    q_real [T, n] and mu_hat [T, n] (width 0 when not traced), and with
    ``cfg.observe`` obs_row (a ``TelemetryCarry`` of [T, ...] tensors) and
    obs_flag [T]."""
    return simulate_many([(cfg, params, key, env)], device)[0]


__all__ = ["EV_ARRIVAL", "EV_REAL_DONE", "EV_FAKE_DONE", "EV_FAKE_DISPATCH", "EV_SELF_LOOP",
           "EnvSchedule", "LB_MODES", "SimConfig", "SimParams", "SimState", "draw_rounds",
           "make_params", "simulate", "simulate_many"]
