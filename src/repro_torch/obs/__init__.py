"""repro_torch.obs — the telemetry subsystem.

``windows``: the in-carry windowed metric fold (``TelemetryCarry`` of
device tensors + the fold functions shared by the captured scan turns and
the host loops).
``detect``: in-carry CUSUM regime detection over the window stream
(``ObserveConfig(detect=DetectConfig())``) + ``detection_report``
ground-truth attribution.
``slo``: declarative SLO objectives with multi-window burn-rate
alerting over the record stream.
``export``: Prometheus / JSONL / terminal-dashboard sinks.
``tracing``: decision-lifecycle ring → Chrome trace JSON, profiler
annotations.

The reference's export list, less ``observe_turn_host`` (its jitted host
entry): the host loops call ``observe_turn`` itself on the router's device.
"""
from repro_torch.obs.detect import (  # noqa: F401
    REGIMES,
    SIGNALS,
    DetectConfig,
    detection_report,
    detections_from_records,
)
from repro_torch.obs.export import (  # noqa: F401
    JsonlSink,
    dashboard,
    dashboard_header,
    dashboard_row,
    peak_rss_mb,
    prometheus_snapshot,
    rss_mb,
)
from repro_torch.obs.slo import (  # noqa: F401
    SinkWithSLO,
    SLObjective,
    SLOTracker,
    annotate,
    default_objectives,
    hist_frac_above,
)
from repro_torch.obs.tracing import (  # noqa: F401
    DecisionTrace,
    save_chrome_trace,
    step_annotation,
    trace_annotation,
    windows_to_chrome_trace,
)
from repro_torch.obs.windows import (  # noqa: F401
    ObserveConfig,
    TelemetryCarry,
    TurnObs,
    aggregate_rows,
    bin_edges,
    bin_ratio,
    faulty_turn_obs,
    final_partial_record,
    fleet_collisions,
    fleet_final_partial,
    fleet_records_from_rows,
    fold_turn,
    hist_mean,
    hist_quantile,
    init_carry,
    observe_turn,
    plain_turn_obs,
    quantile_tolerance,
    record_from_state,
    records_from_rows,
    reset_window,
    sim_records_from_trace,
)
