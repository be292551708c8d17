"""The probe plane: black-box synthetic probes with golden-answer checks.

Counterpart of ``deeplearning4j_tpu/monitor/probes.py``, under its series,
flight events and document keys, with the golden set in its dict format,
so a port prober can probe a JAX replica and the other way round.

- :class:`ProbeTarget`: one replica endpoint and its golden set, the dict
  :meth:`~deeplearning4j_torch.serving.registry.ServedModel.golden`
  returns (``inputs``, f32 ``outputs``, ``atol``, ``version``).
- :class:`Prober`: an opt-in daemon (idempotent ``start(interval_s)``,
  ``stop()`` joins its thread, ``tick(now=)`` the deterministic seam) that
  sends real ``POST /v1/models/<m>/predict`` requests and compares the
  answers with the golden outputs at the golden's ``atol``.

Every probe is a client-side SLI: ``probe_requests_total{target,model,
outcome=ok|error|timeout|mismatch}``, ``probe_latency_ms{target,model}``
(the probes' trace ids latched as exemplars) and
``probe_last_success_age_s{target}``, the deadman that only an ``ok``
probe resets, so a replica answering fast but wrong still trips it. A
probe mints its own trace context and sends it as ``X-DL4J-Trace`` (the
replica's ``/trace`` resolves it) and sends ``X-DL4J-Probe: 1``, so the
serving tier bypasses its response cache and every probe reaches the
model.

Each tick samples the prober's own history ring and evaluates its own
alert engine (``alerts.default_probe_rules``). ``fail_threshold``
consecutive non-ok probes land one ``health_problem`` (kind ``"probe"``)
on this process's ``/healthz``. The prober's lock is a leaf: probes,
metric writes, flight events, health, sampling and evaluation run with no
lock held.
"""
from __future__ import annotations

import json
import logging
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

import numpy as np

from .lockwatch import make_lock

log = logging.getLogger(__name__)

__all__ = ["ProbeTarget", "Prober", "get_prober"]

#: default probe cadence (seconds) — one real prediction per target per
#: tick; same order as the scrape plane, far below serving QPS
DEFAULT_INTERVAL_S = 5.0

#: per-probe HTTP timeout (seconds); a hung replica costs one probe slot
#: (outcome="timeout"), never the whole tick loop
DEFAULT_TIMEOUT_S = 5.0

#: consecutive non-ok probes before the incident lands on /healthz as a
#: health_problem (kind="probe") — one flap never dirties the ring
DEFAULT_FAIL_THRESHOLD = 3

#: comparison tolerance when a golden set carries none (f32 serving)
DEFAULT_ATOL = 1e-4


class ProbeTarget:
    """One probe-plane endpoint: a label, the replica's base URL
    (scheme optional; ``/v1/models/<model>/predict`` is appended), the
    model to probe and its **golden set** — the dict
    :meth:`ServedModel.golden` returns (``inputs``, f32 ``outputs``,
    ``atol``, ``version``). ``model`` defaults to the golden set's own
    ``model`` key."""

    def __init__(self, label: str, url: str, golden: Dict[str, Any],
                 model: Optional[str] = None,
                 deadline_ms: Optional[float] = None):
        self.label = str(label)
        url = str(url)
        if "://" not in url:
            url = f"http://{url}"
        self.url = url.rstrip("/")
        if not isinstance(golden, dict) or "inputs" not in golden \
                or "outputs" not in golden:
            raise ValueError(
                f"probe target {label!r}: golden must be a dict with "
                f"'inputs' and 'outputs' (ServedModel.golden() shape)")
        self.model = str(model if model is not None
                         else golden.get("model") or "")
        if not self.model:
            raise ValueError(f"probe target {label!r}: no model name "
                             f"(pass model= or a golden with 'model')")
        # inputs stay nested lists (the JSON body); expected becomes the
        # f32 oracle array the comparison runs against
        self.inputs = np.asarray(golden["inputs"], np.float32).tolist()
        self.expected = np.asarray(golden["outputs"], np.float32)
        self.atol = float(golden.get("atol") or DEFAULT_ATOL)
        self.version = golden.get("version")
        self.deadline_ms = (float(deadline_ms)
                            if deadline_ms is not None else None)

    def to_dict(self) -> dict:
        return {"label": self.label, "url": self.url, "model": self.model,
                "golden_version": self.version, "atol": self.atol}

    def __repr__(self):
        return (f"ProbeTarget({self.label!r}, {self.url!r}, "
                f"model={self.model!r}, version={self.version!r})")


class _ProbeDumpSource:
    """Registry-shaped adapter (``.dump()``) so the prober's
    :class:`MetricsHistory` samples the process registry with the probe
    series FILTERED to the current target set — a long-lived process
    registry must not leak a retired target's stale
    ``probe_last_success_age_s`` into the deadman rule (the same
    retired-series hazard ``TelemetryCollector.fleet_dump`` filters)."""

    def __init__(self, prober: "Prober"):
        self._prober = prober

    def dump(self) -> dict:
        return self._prober.probe_dump()


class Prober:
    """Black-box prober daemon. Opt-in like the collector: construction
    starts nothing; tests drive :meth:`tick` deterministically;
    production calls ``start(interval_s)`` and ``stop()`` timed-joins
    the thread.

    ``history`` defaults to a private :class:`~.history.MetricsHistory`
    sampling the process registry with probe series filtered to the
    CURRENT target set (:meth:`probe_dump`), and ``engine`` to a
    private :class:`~.alerts.AlertEngine` over it — attach the probe
    SLO pack with ``prober.engine.add(*default_probe_rules(prober))``.
    """

    def __init__(self, history=None, engine=None, *,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 fail_threshold: int = DEFAULT_FAIL_THRESHOLD):
        from .history import MetricsHistory
        from .alerts import AlertEngine
        self.history = (history if history is not None
                        else MetricsHistory(
                            registry=_ProbeDumpSource(self)))
        self.engine = (engine if engine is not None
                       else AlertEngine(history=self.history))
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.fail_threshold = max(1, int(fail_threshold))
        self._lock = make_lock("Prober._lock")
        self._targets: Dict[str, ProbeTarget] = {}
        #: per-target probe state (guarded by the leaf lock): outcome of
        #: the last probe, consecutive non-ok count, deadman timestamps,
        #: the last probe's trace id (the /trace join key)
        self._state: Dict[str, Dict[str, Any]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ targets
    def add_target(self, label: str, url: str, golden: Dict[str, Any],
                   model: Optional[str] = None,
                   deadline_ms: Optional[float] = None) -> "Prober":
        target = ProbeTarget(label, url, golden, model=model,
                             deadline_ms=deadline_ms)
        with self._lock:
            self._targets[target.label] = target
            self._state.setdefault(target.label, {})
        return self

    def remove_target(self, label: str):
        with self._lock:
            self._targets.pop(str(label), None)
            self._state.pop(str(label), None)

    def targets(self) -> List[ProbeTarget]:
        with self._lock:
            return [self._targets[k] for k in sorted(self._targets)]

    def failing_targets(self) -> List[ProbeTarget]:
        """Targets whose LAST probe was not ``ok`` (the view a
        probe-failure policy reads at fire time — error, timeout and mismatch all count: a wrong answer is
        as failed as no answer)."""
        with self._lock:
            return [self._targets[k] for k in sorted(self._targets)
                    if self._state.get(k, {}).get("last_outcome")
                    not in (None, "ok")]

    # ------------------------------------------------------------ probing
    def _probe(self, target: ProbeTarget, trace_header: str) -> np.ndarray:
        """One UNLOCKED golden-set replay: a real ``POST .../predict``
        carrying the probe's own trace context and the cache-bypass
        marker. Returns the replica's f32 outputs; raises on transport
        or HTTP failure."""
        from ..serving.server import PROBE_HEADER, TRACE_HEADER
        body: Dict[str, Any] = {"inputs": target.inputs}
        if target.deadline_ms is not None:
            body["deadline_ms"] = target.deadline_ms
        req = urllib.request.Request(
            f"{target.url}/v1/models/{target.model}/predict",
            data=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json",
                     TRACE_HEADER: trace_header,
                     PROBE_HEADER: "1"},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            doc = json.loads(r.read().decode("utf-8"))
        return np.asarray(doc.get("outputs"), np.float32)

    @staticmethod
    def _probe_metrics(target: ProbeTarget):
        from .registry import get_registry
        reg = get_registry()
        return (reg.histogram("probe_latency_ms",
                              "client-observed synthetic probe latency",
                              target=target.label, model=target.model),
                reg.gauge("probe_last_success_age_s",
                          "seconds since the target last answered a probe "
                          "CORRECTLY (the deadman — mismatches do not "
                          "reset it)", target=target.label))

    @staticmethod
    def _count(target: ProbeTarget, outcome: str):
        from .registry import get_registry
        get_registry().counter(
            "probe_requests_total",
            "synthetic probes by outcome (ok|error|timeout|mismatch)",
            target=target.label, model=target.model,
            outcome=outcome).inc()

    def tick(self, now: Optional[float] = None) -> dict:
        """One probe pass (the daemon's beat; also the test seam).

        Probes every configured target with NO lock held, classifies
        each answer (``ok`` / ``error`` / ``timeout`` / ``mismatch``),
        lands the SLI series, maintains the deadman gauge, records
        edge-triggered ``probe_target_failing`` / ``_recovered`` flight
        events, folds sustained failure into ``/healthz`` as a
        ``health_problem`` (kind="probe"), then samples the history ring
        and evaluates the probe alert engine. Returns a per-tick summary
        so tests latch exact numbers."""
        from .flightrec import get_flight_recorder
        from .health import get_health
        from .tracer import new_context
        t_tick0 = time.perf_counter()
        now = float(now) if now is not None else time.time()
        with self._lock:
            targets = [self._targets[k] for k in sorted(self._targets)]
        probed: List[str] = []
        outcomes: Dict[str, str] = {}
        errors: Dict[str, str] = {}
        probe_ms: Dict[str, float] = {}
        for target in targets:
            hist, age_gauge = self._probe_metrics(target)
            ctx = new_context()
            trace_hex = f"{ctx.trace_id:x}"
            outcome, detail = "ok", ""
            t0 = time.perf_counter()
            try:
                out = self._probe(target,
                                  f"{ctx.trace_id:x}:{ctx.span_id:x}")
                if out.shape != target.expected.shape or not np.allclose(
                        out, target.expected, atol=target.atol,
                        equal_nan=False):
                    outcome = "mismatch"
                    detail = (f"answer diverges from golden "
                              f"{target.version or '?'} "
                              f"(atol={target.atol:g})")
            except (socket.timeout, TimeoutError) as e:
                outcome, detail = "timeout", f"{type(e).__name__}: {e}"
            except urllib.error.URLError as e:
                # a timeout surfaces as URLError(reason=timeout) too
                timed_out = isinstance(getattr(e, "reason", None),
                                       (socket.timeout, TimeoutError))
                outcome = "timeout" if timed_out else "error"
                detail = f"{type(e).__name__}: {e}"
            except Exception as e:          # bad JSON, refused, 5xx body
                outcome, detail = "error", f"{type(e).__name__}: {e}"
            ms = (time.perf_counter() - t0) * 1e3
            # every probe is a data point — a down replica must show up
            # in the client-side latency distribution, not vanish
            hist.observe(ms, exemplar=trace_hex)
            self._count(target, outcome)
            probe_ms[target.label] = ms
            outcomes[target.label] = outcome
            if outcome != "ok":
                errors[target.label] = detail
            with self._lock:
                st = self._state.setdefault(target.label, {})
                was = st.get("last_outcome")
                st.setdefault("first_probe_t", now)
                st["last_outcome"] = outcome
                st["last_detail"] = detail or None
                st["last_trace_id"] = trace_hex
                st["last_probe_t"] = now
                st["probes"] = st.get("probes", 0) + 1
                if outcome == "ok":
                    st["consecutive_failures"] = 0
                    st["last_success_t"] = now
                else:
                    st["consecutive_failures"] = \
                        st.get("consecutive_failures", 0) + 1
                fails = st["consecutive_failures"]
                age = now - st.get("last_success_t",
                                   st["first_probe_t"])
            age_gauge.set(max(0.0, age))
            if outcome != "ok" and was in (None, "ok"):
                # edge-triggered, never per-tick — and the event carries
                # the probe's OWN trace id, resolvable on the replica
                get_flight_recorder().record(
                    "probe_target_failing", target=target.label,
                    model=target.model, url=target.url, outcome=outcome,
                    trace_id=trace_hex, detail=detail)
                log.warning("probe of %s (%s %s) failing: %s — %s",
                            target.label, target.url, target.model,
                            outcome, detail)
            elif outcome == "ok" and was not in (None, "ok"):
                get_flight_recorder().record(
                    "probe_target_recovered", target=target.label,
                    model=target.model, url=target.url,
                    trace_id=trace_hex)
            if outcome != "ok" and fails == self.fail_threshold:
                # sustained: the gray failure lands on THIS process's
                # /healthz as a timestamped, resolvable problem
                get_health().record_problem(
                    "probe", f"target {target.label} ({target.model}) "
                             f"failed {fails} consecutive probes: "
                             f"{outcome} — {detail} "
                             f"[trace {trace_hex}]")
            probed.append(target.label)
        # upward loop: probe series -> history ring -> probe SLO engine
        if targets:
            self.history.sample(now=now)
            self.engine.evaluate(now=now, strict=False)
        return {"t": now, "probed": probed, "outcomes": outcomes,
                "errors": errors, "probe_ms": probe_ms,
                "duration_ms": (time.perf_counter() - t_tick0) * 1e3}

    # ------------------------------------------------------------ queries
    def probe_dump(self) -> dict:
        """The registry dump the prober's history samples: all families,
        with ``probe_*`` series filtered to the CURRENT target set —
        retiring a target retires its series from rule evaluation (its
        stale deadman gauge must not fire forever)."""
        from .registry import get_registry
        dump = get_registry().dump()
        with self._lock:
            current = set(self._targets)
        out = {}
        for name, fam in dump.items():
            if not name.startswith("probe_"):
                out[name] = fam
                continue
            rows = [r for r in fam.get("children", [])
                    if r.get("labels", {}).get("target") in current]
            if rows:
                out[name] = {**{k: v for k, v in fam.items()
                                if k != "children"}, "children": rows}
        return out

    def last_failure_trace(self) -> Optional[str]:
        """The most recent failing target's probe trace id (exemplar
        seam for the deadman/mismatch rules — resolvable on the guilty
        replica's ``/trace``)."""
        with self._lock:
            worst = None
            for k in sorted(self._targets):
                st = self._state.get(k, {})
                if st.get("last_outcome") in (None, "ok"):
                    continue
                t = st.get("last_probe_t") or 0.0
                if worst is None or t > worst[0]:
                    worst = (t, st.get("last_trace_id"))
        return worst[1] if worst else None

    def failure_detail(self) -> str:
        """One-line 'who is failing and why' for alert annotations."""
        with self._lock:
            rows = [f"{k}: {st.get('last_outcome')}"
                    f" ({st.get('last_detail') or 'no detail'})"
                    for k in sorted(self._targets)
                    if (st := self._state.get(k, {})).get("last_outcome")
                    not in (None, "ok")]
        return "; ".join(rows)

    def snapshot(self) -> dict:
        """The prober's own state (targets, outcomes, deadman ages) —
        the ``GET /probes`` / ``monitor --probes`` view."""
        now = time.time()
        with self._lock:
            targets = {}
            for k, t in sorted(self._targets.items()):
                st = self._state.get(k, {})
                base = st.get("last_success_t", st.get("first_probe_t"))
                targets[k] = {
                    "url": t.url, "model": t.model,
                    "golden_version": t.version, "atol": t.atol,
                    "last_outcome": st.get("last_outcome"),
                    "consecutive_failures":
                        st.get("consecutive_failures", 0),
                    "probes": st.get("probes", 0),
                    "last_trace_id": st.get("last_trace_id"),
                    "last_detail": st.get("last_detail"),
                    "last_probe_t": st.get("last_probe_t"),
                    "last_success_age_s": (max(0.0, now - base)
                                           if base is not None else None),
                }
        return {"interval_s": self.interval_s,
                "timeout_s": self.timeout_s,
                "fail_threshold": self.fail_threshold,
                "running": self.running(),
                "targets": targets}

    # ---------------------------------------------------------- lifecycle
    def start(self, interval_s: Optional[float] = None) -> "Prober":
        """Start the background probe loop (idempotent). The thread is
        a daemon AND joined by :meth:`stop` — THR002 discipline."""
        if interval_s is not None:
            self.interval_s = float(interval_s)
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="prober", daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        # first probe immediately: the deadman baseline exists after one
        # interval, not two
        self._safe_tick()
        while not self._stop.wait(self.interval_s):
            self._safe_tick()

    def _safe_tick(self):
        try:
            self.tick()
        except Exception:
            log.exception("prober tick failed")

    def stop(self, timeout: float = 5.0):
        with self._lock:
            thread, self._thread = self._thread, None
            if thread is not None:
                # set the event INSIDE the lock: a concurrent start()
                # serializes behind us and clears it for ITS thread —
                # setting after release could kill the fresh loop on its
                # first wait() (same invariant as MetricsHistory.stop)
                self._stop.set()
        if thread is not None:
            thread.join(timeout)

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()


#: lazily-created process-global prober (no thread, no targets until
#: someone configures and starts it — tier-1 suites run with zero
#: probers); the GET /probes endpoint serves its snapshot
_PROBER: Optional[Prober] = None
_PROBER_LOCK = threading.Lock()


def get_prober() -> Prober:
    global _PROBER
    with _PROBER_LOCK:
        if _PROBER is None:
            _PROBER = Prober()
        return _PROBER
