"""The monitor core of the port (counterpart of
``deeplearning4j_tpu/monitor/``, its core planes):

- :func:`get_registry`: the process-global :class:`MetricsRegistry`
  (labeled counters, gauges, histograms; Prometheus text).
- :func:`get_tracer`: the host-side span :class:`Tracer` (ring buffer,
  Chrome trace-event JSON; nests ``torch.profiler.record_function`` while a
  profiler records).
- :func:`get_health`: :class:`HealthState` and
  :class:`TrainingHealthListener`, the NaN/divergence/stall watchdog.
- :func:`get_flight_recorder`: the bounded structured event log that dumps
  JSONL on a halt or a crash.
- :func:`get_fleet`: per-worker telemetry shipped over the parameter
  server's ``OP_TELEMETRY`` (merged scrape, merged trace, liveness).
- :func:`get_lockwatch` and the lock factories (``make_lock`` ...):
  plain ``threading`` primitives unless ``DL4J_TPU_LOCKWATCH=1``.
- :func:`monitored_jit` and :func:`get_jit_registry`: first-call
  (compile) counts, retrace storms and their cost, and
  :func:`profile_report`/:func:`render_profile_text` (``GET /profile``);
  :func:`sample_device_memory`: the allocator's gauges.
- :func:`get_history`: the metric-history ring (``GET /history``, the
  profile's trends block).
- :func:`get_alert_engine`: threshold, burn-rate, health and fleet rules
  over the history (OK -> PENDING -> FIRING with hold-down,
  ``alert_firing``/``alert_resolved`` flight events, the
  ``alerts_firing{rule=}`` gauge, ``GET /alerts``) and the rule packs
  ``default_*_rules``.
- :func:`get_collector`: the scrape plane, a :class:`TelemetryCollector`
  that polls each replica's ``GET /telemetry`` (:func:`telemetry_snapshot`)
  into the fleet table, with a history ring of its own for fleet-scope
  rules.
- :func:`get_prober`: the probe plane, a :class:`Prober` that posts each
  :class:`ProbeTarget`'s golden inputs to its replica and compares the
  answers (``GET /probes``).

The fit loops, the transport, the input pipeline and the parameter server
(single and sharded) report here under the JAX package's names. The
per-iteration score the fit loops record is a device-to-host value fetch
(``float(loss)``) a minibatch; :func:`set_enabled` (False), or
``DL4J_TPU_MONITOR=0``, turns the fit-loop instrumentation off when no
listener is set. The switch changes what is recorded, never which device
or kernel runs.

Not ported yet (ROADMAP A 17d): the incident recorder.
"""
from __future__ import annotations

import contextlib
import os

from .lockwatch import (InstrumentedLock, LockWatch, get_lockwatch,
                        make_lock, make_rlock, make_condition)
from .registry import (MetricsRegistry, LatencyHistogram, Counter, Gauge,
                       Histogram, get_registry, render_prometheus_dump)
from .tracer import SpanContext, Tracer, get_tracer, new_context
from .health import (HealthState, get_health, TrainingHealthListener,
                     TrainingHealthError)
from .flightrec import FlightRecorder, get_flight_recorder
from .fleet import FleetState, get_fleet, merge_traces
from .history import MetricsHistory, get_history
from .alerts import (AlertEngine, AlertError, AlertRule, BurnRateRule, FleetStalenessRule,
                     HealthRule, ThresholdRule, default_fleet_rules, default_fleet_scope_rules,
                     default_probe_rules, default_rules, default_serving_rules,
                     default_training_rules, get_alert_engine)
from .collector import ScrapeTarget, TelemetryCollector, get_collector, telemetry_snapshot
from .probes import ProbeTarget, Prober, get_prober
from .jitwatch import (MonitoredJit, JitRegistry, monitored_jit, get_jit_registry,
                       sample_device_memory, maybe_sample_device_memory, profile_report,
                       render_profile_text)

__all__ = [
    "MetricsRegistry", "LatencyHistogram", "Counter", "Gauge", "Histogram",
    "get_registry", "render_prometheus_dump", "SpanContext", "Tracer",
    "get_tracer", "new_context", "HealthState", "get_health",
    "TrainingHealthListener", "TrainingHealthError",
    "FlightRecorder", "get_flight_recorder", "FleetState", "get_fleet",
    "merge_traces", "MonitoredJit", "JitRegistry", "monitored_jit",
    "get_jit_registry", "sample_device_memory", "maybe_sample_device_memory",
    "profile_report", "render_profile_text", "MetricsHistory", "get_history",
    "InstrumentedLock", "LockWatch", "get_lockwatch", "make_lock",
    "make_rlock", "make_condition",
    "AlertEngine", "AlertError", "AlertRule", "ThresholdRule", "BurnRateRule",
    "HealthRule", "FleetStalenessRule", "get_alert_engine", "default_rules",
    "default_serving_rules", "default_training_rules", "default_fleet_rules",
    "default_fleet_scope_rules", "default_probe_rules",
    "ScrapeTarget", "TelemetryCollector", "get_collector", "telemetry_snapshot",
    "ProbeTarget", "Prober", "get_prober",
    "set_enabled", "enabled", "record_training_iteration", "step_span",
]

#: fit-loop instrumentation switch: when False the containers skip the
#: per-iteration value fetch (and every metric/health write) unless
#: listeners are set. On by default (a bare fit fills the registry and the
#: health state); DL4J_TPU_MONITOR=0 per process, set_enabled at run time.
_ENABLED = os.environ.get("DL4J_TPU_MONITOR", "1") not in ("0", "false", "")


def set_enabled(value: bool):
    global _ENABLED
    _ENABLED = bool(value)


def enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def step_span(iteration: int):
    """The per-minibatch training span. The caller performs its
    device-to-host value fetch (``float(loss)``) inside it, so the span
    measures the finished step, not its launches. After the span ends the
    device-memory gauges are sampled (throttled), so the sampling never
    counts in the step's duration."""
    try:
        with get_tracer().span("step", cat="train",
                               iteration=int(iteration)) as ctx:
            yield ctx
    finally:
        maybe_sample_device_memory()


def record_training_iteration(model, iteration: int, score: float,
                              batch_size: int = 0, step_ms: float = None,
                              etl_ms: float = None):
    """One call per applied minibatch from the fit loops: the training
    counters and gauges, and the health state's liveness."""
    reg = get_registry()
    reg.counter("training_iterations_total",
                "optimizer iterations applied").inc()
    reg.gauge("training_score", "last minibatch score").set(score)
    reg.gauge("training_iteration", "last iteration index").set(iteration)
    if batch_size:
        reg.counter("training_examples_total",
                    "examples consumed by fit").inc(batch_size)
    if step_ms is not None:
        reg.histogram("training_step_ms",
                      "wall-clock per applied step, value-fetch "
                      "barrier included").observe(step_ms)
    if etl_ms is not None:
        reg.histogram("training_etl_ms",
                      "host wait for the next minibatch").observe(etl_ms)
    get_health().record_iteration(iteration, score)
