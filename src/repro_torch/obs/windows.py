"""Windowed telemetry engine: the in-carry observation fold.

The observability substrate the paper's "monitors total system load /
adjusts in real-time" claim presupposes: rolling windowed metrics
computed inside the serving loops (a ``TelemetryCarry`` of device tensors
folded once per turn, emitted as per-turn rows the host filters at window
boundaries) rather than post-hoc reductions over a fully materialised
per-task trace. The same fold functions run in

  * ``serving.scanloop.run_workload_scan``'s plain and faulty turns,
    inside the captured CUDA graph on the card,
  * the host loops (``env.serving.run_workload``,
    ``serving.recovery.run_workload_recovery``) via ``observe_turn``,
    called eagerly on the router's device,

so host and scan window streams are equal float for float by
construction: the same torch operations, in the same order, on the same
per-turn inputs and the same device.

Design rules that make the parity claims hold (the reference's):

  * the fold is read-only with respect to scheduler state: folding never
    touches router or learner math, so telemetry-on responses stay
    bit-equal to telemetry-off;
  * every float accumulator is a per-turn scalar sum (same order on host
    and scan); per-response reductions use only order-independent integer
    scatter-adds (the latency histogram), never float sums over
    variable-length completion sets, which would differ between the host's
    compacted arrays and the scan's masked fixed-width slots;
  * window quantiles come from a fixed log-spaced histogram, so the
    p50/p99/p999 streams match exact trace percentiles within one bin
    ratio (``quantile_tolerance``).

Windows are turn-based (every ``window_turns`` folds), so boundaries are
static and cross chunks: ``turn_idx`` in the carry is global and never
resets, which is what makes the stream continuous across ``chunk_turns``
chunk boundaries.

Every step of the fold is a torch operation with no host synchronisation,
so it can be captured; its constants are device tensors made once per
device (``_const``) outside any capture, and a division is always tensor
by tensor (torch divides a CUDA tensor by a Python scalar as a multiply by
its reciprocal).

Copied from the JAX package's ``obs/windows.py``: the configuration and
the host-side record helpers verbatim (numpy), the fold in torch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.obs import detect as _detect
from repro_torch.obs.detect import DetectConfig
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ObserveConfig:
    """Static telemetry configuration (hashable: part of the one-program
    loop's ``ScanConfig``, one captured graph per configuration).

    ``window_turns``: serving turns per emitted window row.
    ``hist_lo``/``hist_hi``/``hist_bins``: the log-spaced latency histogram;
    quantile error is bounded by one bin ratio (see ``quantile_tolerance``).
    ``emit_responses=False`` puts the one-program loop in stream-only mode:
    the per-request response rows (and the μ̂ trace) are dropped from the
    turn's results, so a long horizon copies back only the window stream.
    ``detect`` switches on the in-carry regime detector (``obs.detect``):
    the CUSUM fold runs at every window boundary inside the same turns, and
    the window records gain the regime/alarm keys; ``None`` keeps the
    detector arithmetic out of the turn and the record schema unchanged.
    """

    window_turns: int = 16
    hist_bins: int = 64
    hist_lo: float = 1e-3
    hist_hi: float = 1e4
    emit_responses: bool = True
    detect: DetectConfig | None = None

    def __post_init__(self):
        if self.window_turns < 1:
            raise ValueError("window_turns must be >= 1")
        if not (0.0 < self.hist_lo < self.hist_hi):
            raise ValueError("need 0 < hist_lo < hist_hi")
        if self.hist_bins < 2:
            raise ValueError("hist_bins must be >= 2")
        if self.detect is not None and not isinstance(self.detect, DetectConfig):
            raise TypeError("detect must be a DetectConfig or None")


def bin_ratio(cfg: ObserveConfig) -> float:
    """Geometric width of one histogram bin."""
    return (cfg.hist_hi / cfg.hist_lo) ** (1.0 / cfg.hist_bins)


def quantile_tolerance(cfg: ObserveConfig) -> float:
    """Pinned relative-error bound for windowed quantiles vs exact
    percentiles: one bin ratio (values inside [hist_lo, hist_hi])."""
    return bin_ratio(cfg) - 1.0


def bin_edges(cfg: ObserveConfig) -> np.ndarray:
    """f64[hist_bins + 1] log-spaced bin edges."""
    return cfg.hist_lo * bin_ratio(cfg) ** np.arange(cfg.hist_bins + 1)


class TelemetryCarry(NamedTuple):
    """The in-carry window state, 0-d tensors unless a shape is given.
    Window-local fields reset at each boundary; ``turn_idx`` and the
    ``cum_*`` ledger counters are global (they survive resets and chunk
    boundaries)."""

    hist: torch.Tensor  # i32[hist_bins] latency histogram (window-local)
    n_resp: torch.Tensor  # i32 responses folded this window
    arrivals: torch.Tensor  # i32 task arrivals this window
    launched: torch.Tensor  # i32 real copies launched (incl. retry/spec)
    completed: torch.Tensor  # i32 clean real completions
    dirty: torch.Tensor  # i32 dirty completions (post-kill stragglers)
    killed: torch.Tensor  # i32 real copies killed
    retried: torch.Tensor  # i32 retry re-dispatches
    collisions: torch.Tensor  # i32 herd collisions (fleet; 0 single-frontend)
    q_sum: torch.Tensor  # f32 sum over turns of mean active queue depth
    q_max: torch.Tensor  # i32 max queue depth seen this window
    mu_err_sum: torch.Tensor  # f32 sum of shape-normalized mu-hat rel error
    lam_hat: torch.Tensor  # f32 lambda-hat gauge at last fold
    t_start: torch.Tensor  # f32 window start time
    t_last: torch.Tensor  # f32 time of last fold
    turns: torch.Tensor  # i32 turns folded this window
    turn_idx: torch.Tensor  # i32 global turn counter (never resets)
    cum_launched: torch.Tensor  # i32 global launched counter
    cum_completed: torch.Tensor  # i32 global clean+dirty completions
    cum_killed: torch.Tensor  # i32 global killed counter
    n_active: torch.Tensor  # i32 active-worker count gauge at last fold
    # regime-detector state (obs.detect; all global: never reset at window
    # boundaries, updated only on boundaries, inert zeros when
    # ObserveConfig.detect is None)
    det_mean: torch.Tensor  # f32[NSIG] EMA signal baselines
    det_scale: torch.Tensor  # f32[NSIG] EMA |dev| scales
    det_pos: torch.Tensor  # f32[NSIG] CUSUM positive accumulators
    det_neg: torch.Tensor  # f32[NSIG] CUSUM negative accumulators
    det_wins: torch.Tensor  # i32 windows folded by the detector
    det_cool: torch.Tensor  # i32 cooldown windows remaining
    det_regime: torch.Tensor  # i32 current regime label code
    det_fired: torch.Tensor  # i32 kind fired at the last boundary (0 none)
    det_last_turn: torch.Tensor  # i32 turn_idx of the last alarm
    det_count: torch.Tensor  # i32 total alarms fired


#: the window state packed in four groups (the one-program loop's carry and
#: the chain simulator's rows share the layout): the histogram, the i32
#: fields (a row appends the boundary flag), the f32 scalars and the
#: detector's f32[NSIG] vectors
PACK_F32 = ("q_sum", "mu_err_sum", "lam_hat", "t_start", "t_last")
PACK_DET = ("det_mean", "det_scale", "det_pos", "det_neg")
PACK_I32 = tuple(f for f in TelemetryCarry._fields if f not in ("hist",) + PACK_F32 + PACK_DET)


def row_words(hist_bins: int) -> int:
    """The words of one packed row: ``hist_bins`` of the histogram, the i32
    fields and the boundary flag, the f32 scalars and the detector's
    vectors, padded to 16 bytes (``row_offsets``)."""
    return (hist_bins + len(PACK_I32) + 1 + len(PACK_F32) + len(PACK_DET) * _detect.NSIG
            + 3) // 4 * 4


def row_offsets(hist_bins: int) -> dict:
    """Where each group of a packed row starts: hist, i32 (the flag at
    i32 + len(PACK_I32)), f32, det (f32[len(PACK_DET), NSIG], row-major)."""
    i32 = hist_bins
    f32 = i32 + len(PACK_I32) + 1
    return {"hist": 0, "i32": i32, "f32": f32, "det": f32 + len(PACK_F32)}


def rows_from_words(words: torch.Tensor, hist_bins: int, own_bins: int | None = None):
    """Packed rows i32[T, row_words(hist_bins)] (a chain simulator's trace
    column ``obs``) → (TelemetryCarry of [T, ...] tensors, bool[T] boundary
    flags), each field a view of ``words``; ``own_bins`` (the chain's own
    ``hist_bins``, at most the layout's) cuts the histogram."""
    off = row_offsets(hist_bins)
    nb = hist_bins if own_bins is None else own_bins
    i32 = words[..., off["i32"]:off["i32"] + len(PACK_I32) + 1]
    f32 = words[..., off["f32"]:off["f32"] + len(PACK_F32)].view(torch.float32)
    det = words[..., off["det"]:off["det"] + len(PACK_DET) * _detect.NSIG].view(torch.float32)
    det = det.reshape(det.shape[:-1] + (len(PACK_DET), _detect.NSIG))
    rows = TelemetryCarry(
        hist=words[..., :nb], **{f: i32[..., j] for j, f in enumerate(PACK_I32)},
        **{f: f32[..., j] for j, f in enumerate(PACK_F32)},
        **{f: det[..., j, :] for j, f in enumerate(PACK_DET)})
    return rows, i32[..., len(PACK_I32)] != 0


@functools.lru_cache(maxsize=None)
def _thresholds(cfg: "ObserveConfig") -> tuple:
    f32 = torch.float32
    lo = torch.tensor(float(np.float32(cfg.hist_lo)), dtype=f32)
    inv = torch.tensor(float(np.float32(1.0 / math.log(bin_ratio(cfg)))), dtype=f32)

    def bins(bits: np.ndarray) -> np.ndarray:  # _hist_fold's bin of each f32 bit pattern
        r = torch.maximum(torch.from_numpy(bits.view(np.float32).copy()), lo)
        idx = torch.floor(torch.log(r / lo) * inv).to(torch.int32)
        return idx.clamp(0, cfg.hist_bins - 1).numpy()

    k = np.arange(1, cfg.hist_bins, dtype=np.int64)
    ends = np.array([cfg.hist_lo, 2.0 * cfg.hist_hi], np.float32).view(np.int32)
    a = np.full(k.shape, ends[0], np.int64)  # bin < k
    b = np.full(k.shape, ends[1], np.int64)  # bin >= k
    top = bins(b.astype(np.int32)) >= k
    while (b - a > 1).any():
        m = (a + b) // 2
        up = bins(m.astype(np.int32)) >= k
        a, b = np.where(up, a, m), np.where(up, m, b)
    out = b.astype(np.int32).view(np.float32)
    return tuple(float(v) if t else float("inf") for v, t in zip(out, top))


def hist_thresholds(cfg: "ObserveConfig") -> np.ndarray:
    """f32[hist_bins - 1]: threshold k - 1 is the least f32 sample that
    ``_hist_fold``'s formula (torch's ``log`` on the CPU) puts in bin k or
    above, found by bisection over the f32 bit patterns from ``hist_lo`` to
    2·``hist_hi`` (+inf if none there). A sample's bin is then the count of thresholds at or
    below it, with no logarithm: the chain simulator's fold bins so, the
    plain chain and its kernel alike."""
    return np.asarray(_thresholds(cfg), np.float32)


#: the fields a window boundary resets (``reset_window``); the rest carry on
WINDOW_FIELDS = ("hist", "n_resp", "arrivals", "launched", "completed", "dirty", "killed",
                 "retried", "collisions", "q_sum", "q_max", "mu_err_sum", "turns")


class TurnObs(NamedTuple):
    """What one serving turn exposes to the fold.

    ``resp``/``resp_ok``: this turn's completed-task response times and a
    validity mask (fixed width; masked slots are ignored). All other fields
    are 0-d tensors or [n] vectors sampled after the turn's serve step, so
    host loop and scan observe the same post-step state.
    """

    t: torch.Tensor  # f32 turn-end time
    resp: torch.Tensor  # f32[m] response-time samples
    resp_ok: torch.Tensor  # bool[m] validity mask
    arrivals: torch.Tensor  # i32 tasks arrived this turn
    q_view: torch.Tensor  # i32[n] queue depths after the serve step
    lam_hat: torch.Tensor  # f32 arrival-rate estimate
    mu_hat: torch.Tensor  # f32[n] learner speed estimates
    mu_true: torch.Tensor  # f32[n] true speeds this turn
    active: torch.Tensor | None  # bool[n] membership (None = all active)
    launched: torch.Tensor  # i32 real copies launched this turn
    completed: torch.Tensor  # i32 clean completions this turn
    dirty: torch.Tensor  # i32 dirty completions this turn
    killed: torch.Tensor  # i32 copies killed this turn
    retried: torch.Tensor  # i32 retries this turn
    collisions: torch.Tensor  # i32 herd collisions this turn


@functools.lru_cache(maxsize=None)
def _const_on(value, dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def _const(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A constant (a scalar, or a tuple as a vector) on ``device``, made once
    per device and value. A turn's first eager call (the warm-up before a
    capture, or a host-loop turn) makes it; a captured turn reads the same
    tensor. Never write into it."""
    return _const_on(value, dtype, str(torch.device(device)))


def init_carry(cfg: ObserveConfig, device=None) -> TelemetryCarry:
    """A zero window state on ``device`` (``None`` is the CUDA card and raises
    without one), every field its own tensor."""
    dev = resolve_device(device)
    i32, f32 = torch.int32, torch.float32

    def z(dt, shape=()):
        return torch.zeros(shape, dtype=dt, device=dev)

    return TelemetryCarry(
        hist=z(i32, (cfg.hist_bins,)),
        n_resp=z(i32), arrivals=z(i32), launched=z(i32), completed=z(i32),
        dirty=z(i32), killed=z(i32), retried=z(i32), collisions=z(i32),
        q_sum=z(f32), q_max=z(i32), mu_err_sum=z(f32),
        lam_hat=z(f32), t_start=z(f32), t_last=z(f32),
        turns=z(i32), turn_idx=z(i32),
        cum_launched=z(i32), cum_completed=z(i32), cum_killed=z(i32),
        n_active=z(i32),
        **_detect.init_state(cfg.detect, dev),
    )


def _hist_fold(cfg: ObserveConfig, hist, resp, ok):
    """Order-independent scatter-add of response samples into the
    log-spaced histogram (below-range clips to bin 0, above-range to the
    last bin; masked slots add 0, which is the reference's drop slot)."""
    dev = hist.device
    f32 = torch.float32
    lo = _const(float(np.float32(cfg.hist_lo)), f32, dev)
    inv_log_ratio = _const(float(np.float32(1.0 / math.log(bin_ratio(cfg)))), f32, dev)
    r = torch.maximum(resp.to(f32), lo)
    idx = torch.floor(torch.log(r / lo) * inv_log_ratio).to(torch.int32)
    idx = idx.clamp(0, cfg.hist_bins - 1)
    return hist.index_add(0, idx, ok.to(torch.int32))


def _mu_shape_err(mu_hat, mu_true, active):
    """Per-turn shape-normalized mu-hat relative error: the same
    normalize-to-unit-shares formula as ``metrics.mu_rel_error_trace``, in
    f32."""
    f32 = torch.float32
    if active is None:
        h = mu_hat.to(f32)
        m = mu_true.to(f32)
    else:
        h = torch.where(active, mu_hat, 0.0).to(f32)
        m = torch.where(active, mu_true, 0.0).to(f32)
    tiny = _const(1e-12, f32, h.device)
    h = h / torch.maximum(h.sum(), tiny)
    m = m / torch.maximum(m.sum(), tiny)
    return (h - m).abs().sum()


def fold_turn(cfg: ObserveConfig, tc: TelemetryCarry, obs: TurnObs) -> TelemetryCarry:
    """Fold one turn's observations into the window state (pure)."""
    i32, f32 = torch.int32, torch.float32
    dev = obs.q_view.device
    qf = obs.q_view.to(f32)
    if obs.active is None:
        # the reference's jnp.mean: the sum times the f32 reciprocal of n
        n = obs.q_view.shape[-1]
        q_mean = qf.sum() * _const(float(np.float32(1.0 / n)), f32, dev)
        q_hi = obs.q_view.max().to(i32)
        n_active = _const(n, i32, dev)
    else:
        nact = torch.maximum(obs.active.to(f32).sum(), _const(1.0, f32, dev))
        q_mean = torch.where(obs.active, qf, 0.0).sum() / nact
        q_hi = torch.where(obs.active, obs.q_view, 0).max().to(i32)
        n_active = obs.active.sum(dtype=i32)
    return TelemetryCarry(
        hist=_hist_fold(cfg, tc.hist, obs.resp, obs.resp_ok),
        n_resp=tc.n_resp + obs.resp_ok.sum(dtype=i32),
        arrivals=tc.arrivals + obs.arrivals,
        launched=tc.launched + obs.launched,
        completed=tc.completed + obs.completed,
        dirty=tc.dirty + obs.dirty,
        killed=tc.killed + obs.killed,
        retried=tc.retried + obs.retried,
        collisions=tc.collisions + obs.collisions,
        q_sum=tc.q_sum + q_mean,
        q_max=torch.maximum(tc.q_max, q_hi),
        mu_err_sum=tc.mu_err_sum + _mu_shape_err(obs.mu_hat, obs.mu_true, obs.active),
        lam_hat=obs.lam_hat.to(f32),
        t_start=tc.t_start,
        t_last=obs.t.to(f32),
        turns=tc.turns + 1,
        turn_idx=tc.turn_idx + 1,
        cum_launched=tc.cum_launched + obs.launched,
        cum_completed=tc.cum_completed + obs.completed + obs.dirty,
        cum_killed=tc.cum_killed + obs.killed,
        n_active=n_active,
        # detector fields pass through the per-turn fold untouched:
        # obs.detect.update_row folds them at window boundaries only
        det_mean=tc.det_mean, det_scale=tc.det_scale,
        det_pos=tc.det_pos, det_neg=tc.det_neg,
        det_wins=tc.det_wins, det_cool=tc.det_cool,
        det_regime=tc.det_regime, det_fired=tc.det_fired,
        det_last_turn=tc.det_last_turn, det_count=tc.det_count,
    )


def reset_window(tc: TelemetryCarry) -> TelemetryCarry:
    """Zero the window-local fields; the new window starts where the old
    one ended (abutting t spans). Global fields persist."""
    return tc._replace(t_start=tc.t_last,
                       **{f: torch.zeros_like(getattr(tc, f)) for f in WINDOW_FIELDS})


def observe_turn(cfg: ObserveConfig, tc: TelemetryCarry, obs: TurnObs):
    """Fold one turn, snapshot the row, reset at window boundaries.

    Returns ``(tc_next, row, flag)``: ``row`` is the post-fold window state
    (meaningful only where ``flag`` is true: the scan writes a row every
    turn and the host filters) and ``flag``, a 0-d bool tensor, marks a
    window boundary (every ``cfg.window_turns`` global turns). The same
    function runs inside the captured turn and, eagerly, in the host loops,
    which is what makes the streams equal float for float. The reset is
    ``reset_window`` selected field by field with ``torch.where`` (fields a
    reset keeps are passed through, ``where(flag, x, x)`` being ``x``).
    """
    row = fold_turn(cfg, tc, obs)
    flag = (row.turn_idx % cfg.window_turns) == 0
    if cfg.detect is not None:
        # the regime detector folds over the completed window's stats; the
        # update is where(flag)-gated inside, so off-boundary turns pass
        # through and the boundary row carries its own alarm state
        row = _detect.update_row(cfg.detect, row, flag)
    tc_next = row._replace(
        t_start=torch.where(flag, row.t_last, row.t_start),
        **{f: torch.where(flag, 0, getattr(row, f)) for f in WINDOW_FIELDS})
    return tc_next, row, flag


def _as(v, dtype, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.as_tensor(np.asarray(v), device=device).to(dtype)


def plain_turn_obs(cfg, *, t, resp, arrivals_k, q_view, lam_hat, mu_hat, mu_true, active,
                   collisions=None) -> TurnObs:
    """TurnObs for a fault-free serving turn: every arrival launches and
    completes within the turn (the pool is work-conserving), so the ledger
    deltas collapse to launched = completed = k. Tensors stay where they
    are (``q_view``'s device); host values are copied there."""
    del cfg
    i32, f32 = torch.int32, torch.float32
    dev = q_view.device
    resp = _as(resp, f32, dev)
    k = _const(int(arrivals_k), i32, dev)
    z = _const(0, i32, dev)
    return TurnObs(
        t=_as(t, f32, dev),
        resp=resp,
        resp_ok=_const((True,) * resp.shape[0], torch.bool, dev),
        arrivals=k, q_view=q_view,
        lam_hat=_as(lam_hat, f32, dev),
        mu_hat=mu_hat, mu_true=_as(mu_true, f32, dev),
        active=None if active is None else _as(active, torch.bool, dev),
        launched=k, completed=k, dirty=z, killed=z, retried=z,
        collisions=z if collisions is None else _as(collisions, i32, dev),
    )


def faulty_turn_obs(cfg, *, t, resp, resp_ok, arrivals_k, q_view, lam_hat, mu_hat, mu_true,
                    active, dctr, collisions=None) -> TurnObs:
    """TurnObs for a faulty turn. ``dctr`` is this turn's delta of the
    recovery counter vector (``serving.recovery.CTR`` layout): the window
    ledger deltas read straight out of it, identically on host (numpy
    snapshot diff) and scan (carry diff)."""
    from repro_torch.serving import recovery as rcv

    del cfg
    i32, f32 = torch.int32, torch.float32
    dev = q_view.device
    k = _const(int(arrivals_k), i32, dev)
    d = _as(dctr, torch.int64, dev)
    retried = d[rcv.CTR["retry"]].to(i32)
    spec = d[rcv.CTR["spec"]].to(i32)
    # CTR["comp_real"] counts all real completions (dirty included); report
    # clean and dirty disjointly so cum_completed never double-counts
    comp_all = d[rcv.CTR["comp_real"]].to(i32)
    dirty = d[rcv.CTR["comp_dirty"]].to(i32)
    return TurnObs(
        t=_as(t, f32, dev),
        resp=_as(resp, f32, dev),
        resp_ok=_as(resp_ok, torch.bool, dev),
        arrivals=k, q_view=q_view,
        lam_hat=_as(lam_hat, f32, dev),
        mu_hat=mu_hat, mu_true=_as(mu_true, f32, dev),
        active=None if active is None else _as(active, torch.bool, dev),
        launched=k + retried + spec,
        completed=comp_all - dirty,
        dirty=dirty,
        killed=d[rcv.CTR["kill_real"]].to(i32),
        retried=retried,
        collisions=(_const(0, i32, dev) if collisions is None
                    else _as(collisions, i32, dev)),
    )


def fleet_collisions(workers: torch.Tensor, n: int) -> torch.Tensor:
    """Per-frontend herd-collision counts for one fleet turn.

    ``workers`` is i32[S, k_f] (this turn's placements per frontend); a
    placement collides when its worker also received a placement from
    another frontend this turn. Returns i32[S].
    """
    i32 = torch.int32
    w = workers.clamp(0, n - 1).long()
    counts = torch.zeros((workers.shape[0], n), dtype=i32, device=workers.device)
    counts.scatter_add_(1, w, torch.ones_like(w, dtype=i32))  # i32[S, n]
    others = counts.sum(0, dtype=i32)[None, :] - counts
    return torch.where(others > 0, counts, 0).sum(1, dtype=i32)


# ---------------------------------------------------------------------------
# Host-side row → record conversion (exporters consume these)
# ---------------------------------------------------------------------------


def _np(v) -> np.ndarray:
    """A row field as numpy: tensors (on any device) copied to the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def host_row(row) -> TelemetryCarry:
    """A window state (a TelemetryCarry, or any object with its fields) as
    numpy fields (one copy a field)."""
    return TelemetryCarry(*(_np(getattr(row, f)) for f in TelemetryCarry._fields))


def hist_quantile(hist: np.ndarray, q: float, cfg: ObserveConfig) -> float:
    """Quantile from the log-spaced histogram with linear-in-log within-bin
    interpolation. NaN on an empty histogram."""
    c = np.asarray(hist, np.float64)
    total = c.sum()
    if total <= 0:
        return float("nan")
    cum = np.cumsum(c)
    target = q * total
    b = int(np.searchsorted(cum, target, side="left"))
    b = min(b, cfg.hist_bins - 1)
    below = cum[b] - c[b]
    frac = (target - below) / c[b] if c[b] > 0 else 0.5
    frac = min(max(frac, 0.0), 1.0)
    r = bin_ratio(cfg)
    return float(cfg.hist_lo * r ** (b + frac))


def hist_mean(hist: np.ndarray, cfg: ObserveConfig) -> float:
    """Histogram-estimated mean (geometric bin midpoints)."""
    c = np.asarray(hist, np.float64)
    total = c.sum()
    if total <= 0:
        return float("nan")
    r = bin_ratio(cfg)
    mids = cfg.hist_lo * r ** (np.arange(cfg.hist_bins) + 0.5)
    return float((c * mids).sum() / total)


def record_from_state(cfg: ObserveConfig, row) -> dict:
    """One window row (a TelemetryCarry snapshot of numpy scalars or
    tensors) → a flat JSON-friendly record: the exporter schema and the
    state-observer feature vector."""
    row = host_row(row)
    hist = row.hist
    turns = int(row.turns)
    t0, t1 = float(row.t_start), float(row.t_last)
    dt = max(t1 - t0, 1e-12)
    n_resp = int(row.n_resp)
    arrivals = int(row.arrivals)
    launched = int(row.launched)
    arr_rate = arrivals / dt
    lam_hat = float(row.lam_hat)
    rec = {
        "window": int(row.turn_idx - 1) // cfg.window_turns,
        "turn": int(row.turn_idx),
        "turns": turns,
        "t_start": t0,
        "t_end": t1,
        "partial": turns != cfg.window_turns,
        "n_resp": n_resp,
        "p50": hist_quantile(hist, 0.50, cfg),
        "p99": hist_quantile(hist, 0.99, cfg),
        "p999": hist_quantile(hist, 0.999, cfg),
        "mean_est": hist_mean(hist, cfg),
        "throughput": n_resp / dt,
        "goodput": int(row.completed) / dt,
        "arrivals": arrivals,
        "arrival_rate": arr_rate,
        "lam_hat": lam_hat,
        "lam_calibration": lam_hat / arr_rate if arr_rate > 0 else float("nan"),
        "mu_rel_err": float(row.mu_err_sum) / max(turns, 1),
        "q_mean": float(row.q_sum) / max(turns, 1),
        "q_max": int(row.q_max),
        "launched": launched,
        "completed": int(row.completed),
        "dirty": int(row.dirty),
        "killed": int(row.killed),
        "retried": int(row.retried),
        "collisions": int(row.collisions),
        "collision_rate": (int(row.collisions) / launched if launched > 0 else 0.0),
        "in_flight": int(row.cum_launched) - int(row.cum_completed) - int(row.cum_killed),
        "n_active": int(row.n_active),
        "hist": hist.tolist(),
    }
    if cfg.detect is not None:
        rec.update(_detect.record_fields(row, partial=rec["partial"]))
    return rec


class _RowView:
    """Attribute view of one row index of stacked TelemetryCarry rows."""

    def __init__(self, stacked, i):
        for f in TelemetryCarry._fields:
            setattr(self, f, _np(getattr(stacked, f))[i])


def records_from_rows(cfg: ObserveConfig, rows, flags, base: list | None = None) -> list:
    """Boundary rows of stacked per-turn rows → list of records. ``rows`` is
    a TelemetryCarry of [T, ...] arrays, ``flags`` bool[T]."""
    out = base if base is not None else []
    idx = np.nonzero(_np(flags))[0]
    for i in idx:
        out.append(record_from_state(cfg, _RowView(rows, int(i))))
    return out


def final_partial_record(cfg: ObserveConfig, tc) -> dict | None:
    """The trailing partial window (if any turns were folded after the last
    boundary): same schema, ``partial=True``."""
    if int(_np(tc.turns)) == 0:
        return None
    return record_from_state(cfg, tc)


def aggregate_rows(cfg: ObserveConfig, rows_s) -> "_RowView":
    """Fleet-aggregate fold of S per-frontend window rows (stacked on axis
    0): counts, histograms and λ̂ sum (each frontend's λ̂ estimates its own
    k/S arrival stream), q_max maxes, view gauges average, times span.
    Returns a row usable with ``record_from_state``."""

    class _Agg:
        pass

    a = _Agg()
    for f in TelemetryCarry._fields:
        v = _np(getattr(rows_s, f))
        if f == "hist":
            a.hist = v.sum(axis=0)
        elif f in ("q_max",):
            setattr(a, f, v.max(axis=0))
        elif f in ("q_sum", "mu_err_sum"):
            setattr(a, f, v.mean(axis=0))
        elif f == "t_start":
            a.t_start = v.min(axis=0)
        elif f in ("t_last",):
            a.t_last = v.max(axis=0)
        elif f in ("turns", "turn_idx"):
            setattr(a, f, v.max(axis=0))
        elif f in ("det_mean", "det_scale", "det_pos", "det_neg"):
            setattr(a, f, v.mean(axis=0))  # detector float state: mean view
        elif f in ("n_active", "det_wins", "det_cool", "det_regime", "det_fired",
                   "det_last_turn"):
            # membership is global (same on every frontend) and the
            # aggregate regime/alarm view is "any frontend detected"
            setattr(a, f, v.max(axis=0))
        else:  # counts, lam_hat and det_count: sum across frontends
            setattr(a, f, v.sum(axis=0))
    return a


def fleet_records_from_rows(cfg: ObserveConfig, rows, flags):
    """Fleet rows → (fleet-aggregate records, per-frontend records).

    ``rows`` is a TelemetryCarry of [T, S, ...] arrays, ``flags`` bool[T].
    The second return is a list (one entry per window) of S-length record
    lists, each tagged with its frontend index.
    """
    out: list = []
    out_f: list = []
    idx = np.nonzero(_np(flags))[0]
    for i in idx:
        rv = _RowView(rows, int(i))  # fields are [S, ...]
        out.append(record_from_state(cfg, aggregate_rows(cfg, rv)))
        per = []
        for s in range(np.asarray(rv.n_resp).shape[0]):
            rec = record_from_state(cfg, _RowView(rv, s))
            rec["frontend"] = s
            per.append(rec)
        out_f.append(per)
    return out, out_f


def sim_records_from_trace(cfg: ObserveConfig, trace) -> list:
    """Window records from a chain-simulator trace run with an observe
    config: boundary rows plus the trailing partial window (recovered from
    the last row: rows are post-fold, pre-reset snapshots, so when the
    final round is not a boundary the last row is the partial window's
    state)."""
    rows, flags = trace["obs_row"], trace["obs_flag"]
    recs = records_from_rows(cfg, rows, flags)
    fl = _np(flags)
    if fl.size and not fl[-1]:
        recs.append(record_from_state(cfg, _RowView(rows, -1)))
    return recs


def fleet_final_partial(cfg: ObserveConfig, tc):
    """Trailing partial window of a fleet run: (aggregate record | None,
    per-frontend record list)."""
    if int(_np(tc.turns)[0]) == 0:
        return None, []
    rv = _RowView(tc, slice(None))  # materialize [S, ...] numpy views
    agg = record_from_state(cfg, aggregate_rows(cfg, rv))
    per = []
    for s in range(np.asarray(rv.n_resp).shape[0]):
        rec = record_from_state(cfg, _RowView(rv, s))
        rec["frontend"] = s
        per.append(rec)
    return agg, per
