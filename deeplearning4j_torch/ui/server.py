"""The JSON request handler every server of the port builds on.

Counterpart of ``deeplearning4j_tpu/ui/server.py``'s
``JsonRequestHandler``.
:meth:`JsonRequestHandler._monitor_get` serves the process-monitor routes
so that every server shares their routing and framing:

- ``/metrics``: Prometheus text of the registry (device-memory gauges
  sampled at scrape time);
- ``/healthz``: the health snapshot (HTTP 503 when unhealthy);
- ``/profile``: ``jitwatch.profile_report`` (``?format=text`` for the
  terminal rendering);
- ``/history``: the metric-history ring (``?metric=<name>[&seconds=N]``
  for one series);
- ``/trace``: the tracer's Chrome trace-event JSON;
- ``/events``: the flight recorder;
- ``/fleet`` (``?format=json`` for the liveness table) and
  ``/fleet/trace``: the merged fleet views;
- ``/alerts``: the alert engine's snapshot, evaluated at request time
  (``strict=False``) and always HTTP 200;
- ``/probes``: the prober's snapshot, always HTTP 200;
- ``/control``: the control plane's snapshot, always HTTP 200;
- ``/incidents``: the incident recorder's table, always HTTP 200, and
  ``/incidents/<id>``: one incident's bundle (404 on an unknown id);
- ``/telemetry``: the scrape payload (``?since_seq=N`` for the flight
  events after N; none without it; 400 on a cursor that is not an int).

The training UI (``UIServer``, with its stats storages and listener) is
ROADMAP A 17f; until then the port serves these routes from every
``InferenceServer`` and every other server built on this handler.
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler

from ..monitor import (get_fleet, get_flight_recorder, get_health, get_registry, get_tracer,
                       profile_report, render_profile_text, sample_device_memory)

__all__ = ["JsonRequestHandler", "MAX_POST_BYTES"]

#: POST bodies above this are refused (413) before they are read
MAX_POST_BYTES = 8 << 20


class JsonRequestHandler(BaseHTTPRequestHandler):
    """Quiet logging, ``_json``/``_text`` replies with their
    Content-Length, bounded POST reads and the monitor routes."""

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, obj, code=200, default=None, headers=None):
        payload = json.dumps(obj, default=default).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _post_body(self, max_bytes: int = None):
        """The decoded POST body, or None after sending the 400/413 reply."""
        limit = MAX_POST_BYTES if max_bytes is None else max_bytes
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            length = -1
        if length < 0:
            self._json({"error": "bad Content-Length"}, 400)
            return None
        if length > limit:
            self._json({"error": f"body of {length} bytes exceeds the {limit}-byte limit"},
                       413)
            return None
        return self.rfile.read(length).decode("utf-8")

    def _text(self, text: str, content_type: str, code: int = 200):
        payload = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _monitor_get(self, url, q) -> bool:
        """Serve a monitor route; True when ``url.path`` was one."""
        if url.path == "/metrics":
            sample_device_memory()
            self._text(get_registry().render_prometheus(),
                       "text/plain; version=0.0.4; charset=utf-8")
            return True
        if url.path == "/healthz":
            snap = get_health().snapshot()
            self._json(snap, 200 if snap["healthy"] else 503)
            return True
        if url.path == "/profile":
            rep = profile_report()
            if q.get("format", [""])[0] == "text":
                self._text(render_profile_text(rep), "text/plain; charset=utf-8")
            else:
                self._json(rep)
            return True
        if url.path == "/history":
            from ..monitor.history import get_history
            hist = get_history()
            metric = q.get("metric", [None])[0]
            if metric:
                seconds = q.get("seconds", [None])[0]
                try:
                    seconds = float(seconds) if seconds else None
                except ValueError:
                    self._json({"error": "seconds must be a number"}, 400)
                    return True
                self._json(hist.series(metric, seconds=seconds))
            else:
                self._json(hist.describe())
            return True
        if url.path == "/trace":
            self._json(get_tracer().export())
            return True
        if url.path == "/fleet":
            fleet = get_fleet()
            if q.get("format", [""])[0] == "json":
                self._json(fleet.liveness())
                return True
            self._text(fleet.render_prometheus(), "text/plain; version=0.0.4; charset=utf-8")
            return True
        if url.path == "/fleet/trace":
            self._json(get_fleet().merged_trace())
            return True
        if url.path == "/alerts":
            from ..monitor.alerts import get_alert_engine
            engine = get_alert_engine()
            engine.evaluate(strict=False)
            self._json(engine.snapshot())
            return True
        if url.path == "/probes":
            from ..monitor.probes import get_prober
            self._json(get_prober().snapshot())
            return True
        if url.path == "/control":
            from ..control.plane import get_control_plane
            self._json(get_control_plane().snapshot())
            return True
        if url.path == "/incidents":
            from ..monitor.incidents import get_incident_recorder
            self._json(get_incident_recorder().snapshot())
            return True
        if url.path.startswith("/incidents/"):
            from ..monitor.incidents import get_incident_recorder
            incident_id = url.path[len("/incidents/"):]
            bundle = get_incident_recorder().bundle(incident_id)
            if bundle is None:
                self._json({"error": f"unknown incident {incident_id!r}"}, 404)
            else:
                self._json(bundle, default=repr)
            return True
        if url.path == "/telemetry":
            from ..monitor.collector import telemetry_snapshot
            since = q.get("since_seq", [None])[0]
            if since is not None:
                try:
                    since = int(since)
                except ValueError:
                    self._json({"error": "since_seq must be an int"}, 400)
                    return True
            self._json(telemetry_snapshot(since_seq=since), default=repr)
            return True
        if url.path == "/events":
            rec = get_flight_recorder()
            self._json({"events": rec.events(), "dropped": rec.dropped,
                        "last_dump_path": rec.last_dump_path}, default=repr)
            return True
        return False
