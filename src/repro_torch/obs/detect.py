"""Online regime detection over the windowed telemetry stream.

The self-driving introspection layer: the ``TelemetryCarry`` fold
computes per-window signals (λ̂, μ̂ shape error, queue depth,
membership count, failure counters) inside the serving loops; this
module turns those signals into an online changepoint detector that
rides the same carry: a bank of two-sided CUSUM statistics over
standardized per-window innovations, with a self-learned EMA baseline
(mean + mean-absolute-deviation scale), emitting a discrete **regime
label stream**::

    stable / load_shift / capacity_shift / membership_shift / failure_storm

with the detection turn index of every alarm. The detector state is a
handful of extra ``TelemetryCarry`` fields (see ``DETECT_FIELDS``), so
it crosses window resets AND chunk boundaries for free and runs
identically in the host loops and the plain and faulty turns of the
one-program loop, float for float, like every other telemetry field.
``ObserveConfig(detect=DetectConfig())`` switches it on; ``detect=None``
(the default) keeps the detector arithmetic out of the record schema and
the update out of the fold entirely.

Detector semantics (classic changepoint, not threshold monitoring):

  * each signal keeps an EMA baseline mean m and scale s (EMA of
    |x − m|, floored at ``rel_floor·|m|`` and ``abs_floor`` so exactly-
    constant signals — membership counts, failure counters on a healthy
    cluster — stay detectable at the first real move);
  * the standardized innovation z = (x − m)/s feeds one-sided CUSUM
    accumulators g⁺ = max(0, g⁺ + z − k), g⁻ = max(0, g⁻ − z − k)
    (g⁻ only for ``TWO_SIDED`` signals: a μ̂-error DECLINE is
    convergence and a failure-counter decline is recovery, not a shift);
  * an alarm fires when any armed accumulator crosses ``h_sigma``; the
    regime label is the highest-precedence fired signal
    (membership > failure > capacity > load — the more specific
    evidence wins when a shift moves several signals at once);
  * after an alarm the detector re-anchors: accumulators reset, the
    baseline tracks fast (``rebaseline_alpha``) for ``cooldown_windows``
    windows, and the regime label holds until the cooldown expires —
    so a persistent new operating point reads as ONE detected shift
    (the change is the event), and the label stream returns to
    ``stable`` once re-anchored.

Attribution (host-side, ``detection_report``): the scenario registry
knows its own ground-truth shift events (``Scenario.shift_events``),
so detections join to (time, kind) ground truth and to
``metrics.adaptation_report`` — detection latency, false-alarm count,
kind-match rate, and time-to-alert vs time-to-adapt per shift.

Copied from the JAX package's ``obs/detect.py``: the configuration, the
constants and the attribution verbatim, the detector step in torch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.estimator import fma_f32

#: Monitored per-window signals, in detector-state vector order. Derived
#: from the window row: ``lam_hat`` (arrival-rate estimate gauge),
#: ``mu_rel_err`` (μ̂ shape error, window mean), ``q_mean`` (mean active
#: queue depth), ``n_active`` (membership count gauge), ``fail_events``
#: (killed + dirty + retried this window).
SIGNALS = ("lam_hat", "mu_rel_err", "q_mean", "n_active", "fail_events")
NSIG = len(SIGNALS)

#: Regime label codes — the discrete label stream (and the categorical
#: half of ROADMAP item 2's feature/label vector).
STABLE, LOAD_SHIFT, CAPACITY_SHIFT, MEMBERSHIP_SHIFT, FAILURE_STORM = range(5)
REGIMES = ("stable", "load_shift", "capacity_shift", "membership_shift",
           "failure_storm")

#: Regime kind each signal evidences (λ̂ and queue depth are load
#: symptoms; μ̂ shape error is capacity; membership and failure counters
#: are their own axes).
SIGNAL_KINDS = (LOAD_SHIFT, CAPACITY_SHIFT, LOAD_SHIFT, MEMBERSHIP_SHIFT,
                FAILURE_STORM)

#: Signals whose DOWNWARD moves are also shifts (load drops, queue
#: drains, rejoins). μ̂-error decline is convergence, failure-count
#: decline is recovery — one-sided there.
TWO_SIDED = (True, False, True, True, False)

#: Ground-truth shift kinds (``Scenario.shift_events``) → regime codes.
KIND_CODES = {"load": LOAD_SHIFT, "capacity": CAPACITY_SHIFT,
              "membership": MEMBERSHIP_SHIFT, "fault": FAILURE_STORM}

#: TelemetryCarry fields owned by the detector (all global: they are
#: never reset at window boundaries and cross chunk boundaries in the
#: carry; the update itself applies only on boundary turns).
DETECT_FIELDS = ("det_mean", "det_scale", "det_pos", "det_neg", "det_wins",
                 "det_cool", "det_regime", "det_fired", "det_last_turn",
                 "det_count")


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Static detector configuration (hashable: nests inside
    ``ObserveConfig`` and keys the one-program loop's runner cache with it).

    ``warmup_windows``: baseline-learning windows before the detector
    arms (cover the λ̂/μ̂ cold-start transient or it reads as a shift).
    ``ema_alpha``/``rebaseline_alpha``: baseline tracking rate when
    armed / while warming·cooling·on-alarm. ``k_sigma``/``h_sigma``:
    CUSUM slack and decision threshold in scale units (the standard
    false-alarm bound is ~exp(−2·k·h) per armed window).
    ``rel_floor``/``abs_floor``: scale floors. ``cooldown_windows``:
    post-alarm re-anchor span (alarms suppressed, regime label held).
    """

    warmup_windows: int = 8
    ema_alpha: float = 0.1
    rebaseline_alpha: float = 0.5
    k_sigma: float = 1.0
    h_sigma: float = 6.0
    # Per-SIGNAL relative scale floors (fraction of the baseline level a
    # move must exceed to register): λ̂ and the μ̂ shape error are
    # estimator EMAs whose stationary wander is ~10% / ~25% of their
    # level, and a Poisson queue's depth wanders ~20% — floors below
    # that read estimator noise as shifts. Membership counts are exact
    # (0.02) and failure counters burst-noisy (0.05). A scalar is
    # accepted and broadcast.
    rel_floor: tuple | float = (0.10, 0.25, 0.20, 0.02, 0.05)
    abs_floor: float = 0.02
    cooldown_windows: int = 2
    cusum_decay: float = 0.9
    clip_z: float = 4.0
    scale_clip_z: float = 2.0

    def __post_init__(self):
        if self.warmup_windows < 1:
            raise ValueError("warmup_windows must be >= 1")
        for f in ("ema_alpha", "rebaseline_alpha"):
            a = getattr(self, f)
            if not (0.0 < a <= 1.0):
                raise ValueError(f"{f} must be in (0, 1]")
        if self.k_sigma < 0.0 or self.h_sigma <= 0.0:
            raise ValueError("need k_sigma >= 0 and h_sigma > 0")
        rf = self.rel_floor
        if isinstance(rf, (int, float)):
            rf = (float(rf),) * NSIG
        rf = tuple(float(v) for v in rf)
        if len(rf) != NSIG:
            raise ValueError(f"rel_floor needs {NSIG} entries, got {len(rf)}")
        object.__setattr__(self, "rel_floor", rf)
        if self.abs_floor <= 0.0 or any(v < 0.0 for v in rf):
            raise ValueError("need abs_floor > 0 and rel_floor >= 0")
        if self.cooldown_windows < 0:
            raise ValueError("cooldown_windows must be >= 0")
        if not (0.0 < self.cusum_decay <= 1.0):
            raise ValueError("cusum_decay must be in (0, 1]")
        if self.clip_z <= self.k_sigma:
            raise ValueError("clip_z must exceed k_sigma")
        if self.scale_clip_z <= 0.0:
            raise ValueError("scale_clip_z must be > 0")


def _c(value, dtype, device) -> torch.Tensor:
    from repro_torch.obs.windows import _const

    return _const(value, dtype, device)


def init_state(dcfg: DetectConfig | None, device) -> dict:
    """Zeroed detector fields (keyed by ``DETECT_FIELDS``) for
    ``windows.init_carry``, each its own tensor on ``device``."""
    del dcfg
    f32, i32 = torch.float32, torch.int32

    def z(dt, shape=()):
        return torch.zeros(shape, dtype=dt, device=device)

    return dict(
        det_mean=z(f32, (NSIG,)), det_scale=z(f32, (NSIG,)), det_pos=z(f32, (NSIG,)),
        det_neg=z(f32, (NSIG,)), det_wins=z(i32), det_cool=z(i32),
        det_regime=torch.full((), STABLE, dtype=i32, device=device),
        det_fired=torch.full((), STABLE, dtype=i32, device=device),
        det_last_turn=z(i32), det_count=z(i32),
    )


def signals_from_row(row) -> torch.Tensor:
    """f32[NSIG] per-window signal vector from a post-fold window row
    (meaningful at boundary turns, where the window stats are full)."""
    f32 = torch.float32
    turns = torch.maximum(row.turns.to(f32), _c(1.0, f32, row.turns.device))
    return torch.stack([
        row.lam_hat.to(f32),
        row.mu_err_sum.to(f32) / turns,
        row.q_sum.to(f32) / turns,
        row.n_active.to(f32),
        (row.killed + row.dirty + row.retried).to(f32),
    ])


def update_row(dcfg: DetectConfig, row, flag):
    """One detector step over a post-fold window row (torch, no host
    synchronisation; shared verbatim by the captured turn and the host
    loops' eager fold, like ``windows.observe_turn`` itself). The update
    applies only where ``flag`` (a 0-d bool, a window boundary):
    off-boundary turns pass every detector field through unchanged, so the
    returned row is safe to feed the window reset exactly like before.
    The reference's compiled step contracts its four product-sums (the
    CUSUM updates ``rho·g + z`` and ``rho·g − z``, the baseline and scale
    EMAs ``m + alpha·innov`` and ``s + alpha·(dev − s)``) into fused
    multiply-adds, which ``estimator.fma_f32`` reproduces as separate IEEE
    operations on the CPU and the card alike; every other expression is
    separate torch operations in the reference's order, and every constant
    a device tensor.
    """
    f32, i32 = torch.float32, torch.int32
    dev = row.det_mean.device

    def cf(v):
        return _c(float(np.float32(v)), f32, dev)

    def ci(v):
        return _c(int(v), i32, dev)

    x = signals_from_row(row)
    first = row.det_wins == 0
    warm = row.det_wins < dcfg.warmup_windows
    cooling = row.det_cool > 0

    mean0 = torch.where(first, x, row.det_mean)
    rel = _c(tuple(float(np.float32(v)) for v in dcfg.rel_floor), f32, dev)
    scale_eff = torch.maximum(torch.maximum(row.det_scale, rel * mean0.abs()),
                              cf(dcfg.abs_floor))
    z = (x - mean0) / scale_eff
    k = cf(dcfg.k_sigma)
    # leaky CUSUM: the decay bounds what sub-threshold wander can ever
    # accumulate at (z̄ − k)/(1 − decay) — telemetry signals like λ̂ are
    # themselves EMAs, so their window-to-window innovations are
    # correlated and a classic (decay=1) CUSUM slowly integrates the
    # wander into false alarms; a real shift still blows through h in a
    # couple of windows because its |z| is far above k
    rho = cf(dcfg.cusum_decay)
    zero = cf(0.0)
    # rho·g⁺ + z and rho·g⁻ − z, fused, in one call over both rows
    acc = fma_f32(rho.expand(2, NSIG), torch.stack([row.det_pos, row.det_neg]),
                  torch.stack([z, -z]))
    pos = torch.maximum(acc[0] - k, zero)
    neg = torch.maximum(acc[1] - k, zero)

    h = cf(dcfg.h_sigma)
    two = _c(TWO_SIDED, torch.bool, dev)
    armed = ~warm & ~cooling
    sig_fired = ((pos > h) | (two & (neg > h))) & armed
    fired = sig_fired.any()
    # label precedence: membership > failure > capacity > load
    kind = torch.where(
        sig_fired[3], ci(MEMBERSHIP_SHIFT),
        torch.where(sig_fired[4], ci(FAILURE_STORM),
                    torch.where(sig_fired[1], ci(CAPACITY_SHIFT),
                                torch.where(sig_fired[0] | sig_fired[2],
                                            ci(LOAD_SHIFT), ci(STABLE)))))

    # baseline: fast tracking while warming / cooling / on alarm (the
    # re-anchor that makes a persistent new level one event), slow EMA
    # when armed and quiet. While armed, the innovation feeding the
    # baseline EMA is clipped at clip_z·scale — an outlier burst must not
    # drag the baseline after it before the CUSUM has had its couple of
    # windows to fire on it — and the scale EMA is clipped tighter
    # (scale_clip_z): a shift-in-progress inflating the scale would shrink
    # its own z and absorb the very excursion under test.
    rb = warm | cooling | fired
    alpha = torch.where(rb, cf(dcfg.rebaseline_alpha), cf(dcfg.ema_alpha))
    clip = cf(dcfg.clip_z) * scale_eff
    innov = x - mean0
    innov = torch.where(rb, innov, torch.minimum(torch.maximum(innov, -clip), clip))
    dev_ = (x - mean0).abs()
    dev_ = torch.where(rb, dev_, torch.minimum(dev_, cf(dcfg.scale_clip_z) * scale_eff))
    scale0 = torch.where(first, torch.maximum(dev_, cf(dcfg.abs_floor)), row.det_scale)
    # mean0 + alpha·innov and scale0 + alpha·(dev − scale0), fused, in one call
    ema = fma_f32(alpha.expand(2, NSIG), torch.stack([innov, dev_ - scale0]),
                  torch.stack([mean0, scale0]))
    mean1, scale1 = ema[0], ema[1]

    keep = armed & ~fired
    cool1 = torch.where(fired, ci(dcfg.cooldown_windows),
                        torch.maximum(row.det_cool - 1, ci(0)))
    upd = dict(
        det_mean=mean1,
        det_scale=scale1,
        det_pos=torch.where(keep, pos, zero),
        det_neg=torch.where(keep, neg, zero),
        det_wins=row.det_wins + 1,
        det_cool=cool1,
        det_regime=torch.where(fired, kind,
                               torch.where(cool1 > 0, row.det_regime, ci(STABLE))),
        det_fired=torch.where(fired, kind, ci(STABLE)),
        det_last_turn=torch.where(fired, row.turn_idx, row.det_last_turn),
        det_count=row.det_count + fired.to(i32),
    )
    return row._replace(**{f: torch.where(flag, v, getattr(row, f))
                           for f, v in upd.items()})


def record_fields(row, *, partial: bool) -> dict:
    """Detector keys of a window record (``windows.record_from_state``
    appends these when ``cfg.detect`` is on). The float state is emitted
    at full precision — the host-vs-scan detector-state parity tests
    compare these float for float. ``row`` holds numpy values
    (``windows.host_row``)."""
    regime = int(row.det_regime)
    fired = int(row.det_fired) if not partial else STABLE
    return {
        "regime": regime,
        "regime_label": REGIMES[regime],
        "detected": fired,
        "detected_label": REGIMES[fired],
        "det_turn": int(row.det_last_turn),
        "det_count": int(row.det_count),
        "det_wins": int(row.det_wins),
        "det_mean": [float(v) for v in np.asarray(row.det_mean)],
        "det_scale": [float(v) for v in np.asarray(row.det_scale)],
        "det_pos": [float(v) for v in np.asarray(row.det_pos)],
        "det_neg": [float(v) for v in np.asarray(row.det_neg)],
    }


# ---------------------------------------------------------------------------
# Attribution: detections × env ground truth × adaptation_report
# ---------------------------------------------------------------------------


def detections_from_records(records) -> list:
    """The alarm stream: one entry per fired window record."""
    out = []
    for rec in records:
        fired = int(rec.get("detected", STABLE))
        if fired != STABLE:
            out.append({
                "t": float(rec["t_end"]),
                "turn": int(rec["turn"]),
                "window": int(rec["window"]),
                "kind": fired,
                "label": REGIMES[fired],
            })
    return out


def detection_report(records, *, shift_events=(), adaptation=None,
                     drifting=False) -> dict:
    """Join the alarm stream to ground truth — the detection analogue of
    ``metrics.adaptation_report``.

    ``shift_events`` is ``Scenario.shift_events(seed)``: a list of
    ``(time, kind)`` DISCRETE environment shifts (kind ∈
    ``KIND_CODES``). Each detection is attributed to the most recent
    preceding shift: the first detection in a shift's segment measures
    that shift's detection latency (and kind match); later detections
    in the same segment are ``repeats``; detections with no preceding
    shift are ``false_alarms``. On drifting scenarios (``drifting=True``
    — an axis changes continuously, e.g. diurnal or OU drift, so there
    is no discrete ground truth) unattributed detections are NOT false
    alarms and the count reports ``None``.

    ``adaptation`` (optional) is ``metrics.adaptation_report``'s output
    for the same run: per-shift time-to-adapt joins the per-shift
    time-to-alert so the report answers "does the system know before it
    has re-adapted?".
    """
    dets = detections_from_records(records)
    events = sorted(
        ((float(t), str(kind)) for t, kind in shift_events),
    )
    ad_per = (adaptation or {}).get("per_shift", {})

    per_shift: list = []
    for t, kind in events:
        per_shift.append({
            "t": t,
            "kind": kind,
            "kind_code": KIND_CODES.get(kind),
            "detected": False,
            "det_t": None,
            "latency": None,
            "det_kind": None,
            "kind_match": None,
            "adaptation_time": ad_per.get(f"{t:.3f}"),
        })

    false_alarms, repeats = 0, 0
    shift_ts = [e[0] for e in events]
    for d in dets:
        seg = int(np.searchsorted(shift_ts, d["t"], side="right")) - 1
        if seg < 0:
            false_alarms += 1
            continue
        ps = per_shift[seg]
        if ps["detected"]:
            repeats += 1
            continue
        ps["detected"] = True
        ps["det_t"] = d["t"]
        ps["latency"] = d["t"] - ps["t"]
        ps["det_kind"] = d["label"]
        ps["kind_match"] = (ps["kind_code"] is not None
                            and d["kind"] == ps["kind_code"])

    lats = [p["latency"] for p in per_shift if p["latency"] is not None]
    ads = [p["adaptation_time"] for p in per_shift
           if p["adaptation_time"] is not None]
    matches = [p["kind_match"] for p in per_shift if p["detected"]]
    n_windows = sum(1 for _ in records)
    out = {
        "n_windows": n_windows,
        "n_detections": len(dets),
        "detections": dets[:64],
        "n_shifts": len(events),
        "n_detected_shifts": sum(1 for p in per_shift if p["detected"]),
        # keyed like adaptation_report's per_shift ("%.3f" of the shift
        # time) so the two reports join on their keys
        "per_shift": {f"{p['t']:.3f}": p for p in per_shift},
        "false_alarms": None if (drifting and not events) else false_alarms,
        "repeats": repeats,
        "mean_latency": float(np.mean(lats)) if lats else None,
        "max_latency": float(np.max(lats)) if lats else None,
        "kind_match_rate": (float(np.mean(matches)) if matches else None),
        "mean_adaptation": float(np.mean(ads)) if ads else None,
    }
    return out
