"""HTTP/JSON inference front door.

Counterpart of ``deeplearning4j_tpu/serving/server.py`` (stdlib
``ThreadingHTTPServer`` on the shared
:class:`~deeplearning4j_torch.ui.server.JsonRequestHandler`):

- ``POST /v1/models/<name>/predict``: body ``{"inputs": [[...], ...],
  "deadline_ms": optional}``; responds ``{"model", "outputs",
  "latency_ms", "trace_id"}``. Unknown model -> 404, malformed body or
  shape -> 400, :class:`OverloadedError` -> 429 with ``Retry-After``,
  :class:`DeadlineExceededError` -> 504, anything else -> 500.
- ``GET /v1/models`` (each model's row: config, precision, cache
  occupancy, golden version) and ``GET /v1/models/<name>``.
- the monitor routes of ``JsonRequestHandler._monitor_get`` (``/metrics``,
  ``/healthz``, ``/profile``, ``/history``, ``/trace``, ``/events``,
  ``/fleet``, ``/fleet/trace``), so a serving replica is scrapeable alone.

Requests are traced: the ``X-DL4J-Trace`` header (``<trace hex>:<span
hex>``) joins the caller's trace, the ``http/predict`` span's context rides
the request through the batcher (``serving/queue_wait`` links to the shared
``serving/flush``), and the response carries the ``trace_id``. An
``X-DL4J-Probe`` request bypasses the response cache. Each handler thread
blocks on its request's Future while the batcher coalesces;
``stop(drain=True)`` stops accepting, drains every model, then closes.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..monitor.tracer import SpanContext, get_tracer
from ..ui.server import JsonRequestHandler, MAX_POST_BYTES
from .batcher import DeadlineExceededError, ModelNotFoundError, OverloadedError
from .registry import ModelRegistry

__all__ = ["InferenceServer", "MAX_POST_BYTES", "TRACE_HEADER", "PROBE_HEADER",
           "parse_trace_header"]

#: request trace-context header: ``<trace_id hex>:<span_id hex>``
TRACE_HEADER = "X-DL4J-Trace"

#: probe-traffic marker: the request bypasses the response cache
PROBE_HEADER = "X-DL4J-Probe"


def parse_trace_header(value: Optional[str]) -> Optional[SpanContext]:
    """``"<trace hex>:<span hex>"`` -> :class:`SpanContext`; None for a
    missing or malformed header (it never fails the request)."""
    if not value:
        return None
    try:
        tid_s, _, sid_s = value.partition(":")
        tid, sid = int(tid_s, 16), int(sid_s, 16)
        if not (0 < tid < 1 << 64 and 0 < sid < 1 << 64):
            return None
        return SpanContext(tid, sid)
    except ValueError:
        return None


class _ServingHandler(JsonRequestHandler):
    registry: ModelRegistry = None     # bound by the server

    def do_GET(self):
        url = urlparse(self.path)
        if self._monitor_get(url, parse_qs(url.query)):
            return
        parts = [p for p in url.path.split("/") if p]
        if parts == ["v1", "models"]:
            self._json({"models": self.registry.list_models()})
            return
        if len(parts) == 3 and parts[:2] == ["v1", "models"]:
            try:
                self._json(self.registry.get(parts[2]).stats())
            except ModelNotFoundError:
                self._json({"error": f"model {parts[2]!r} not found",
                            "models": self.registry.names()}, 404)
            return
        self._json({"error": "not found"}, 404)

    def do_POST(self):
        parts = [p for p in urlparse(self.path).path.split("/") if p]
        if not (len(parts) == 4 and parts[:2] == ["v1", "models"] and parts[3] == "predict"):
            self._json({"error": "not found"}, 404)
            return
        body = self._post_body()
        if body is None:
            return
        name = parts[2]
        try:
            doc = json.loads(body)
            inputs = np.asarray(doc["inputs"], np.float32)
            deadline_ms = doc.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
                if deadline_ms <= 0:
                    raise ValueError("deadline_ms must be > 0")
            if inputs.ndim < 1 or inputs.shape[0] < 1:
                raise ValueError("inputs must be a non-empty [b, ...] array")
        except (KeyError, TypeError, ValueError) as e:
            self._json({"error": f"bad request body: {e}"}, 400)
            return
        t0 = time.perf_counter()
        remote = parse_trace_header(self.headers.get(TRACE_HEADER))
        probe = self.headers.get(PROBE_HEADER) not in (None, "", "0")
        span_args = {"model": name}
        if probe:
            span_args["probe"] = True
        ctx = None
        try:
            with get_tracer().span("http/predict", cat="serving", parent=remote,
                                   **span_args) as ctx:
                fut = self.registry.submit(name, inputs, deadline_ms=deadline_ms,
                                           trace_ctx=ctx, cache_bypass=probe)
                # transport-level backstop; shedding is the batcher's deadline
                out = fut.result(timeout=max(60.0, (deadline_ms or 0.0) / 1e3 + 30.0))
        except ModelNotFoundError:
            self._json({"error": f"model {name!r} not found",
                        "models": self.registry.names()}, 404)
            return
        except ValueError as e:            # oversize request, bad shape
            self._json({"error": str(e)}, 400)
            return
        except OverloadedError as e:
            self._json({"error": str(e)}, 429, headers={"Retry-After": "1"})
            return
        except DeadlineExceededError as e:
            self._json({"error": str(e)}, 504)
            return
        except Exception as e:             # the model failed
            self._json({"error": f"{type(e).__name__}: {e}"}, 500)
            return
        self._json({"model": name, "outputs": np.asarray(out).tolist(),
                    "latency_ms": round((time.perf_counter() - t0) * 1e3, 3),
                    "trace_id": f"{ctx.trace_id:x}"})


class InferenceServer:
    """A :class:`ModelRegistry` behind HTTP. ``start(port=0)`` returns the
    bound port; the bind is loopback by default (the endpoints are
    unauthenticated)."""

    def __init__(self, registry: Optional[ModelRegistry] = None, port: int = 8500,
                 host: str = "127.0.0.1"):
        self.registry = registry if registry is not None else ModelRegistry()
        self.port = port
        self.host = host
        self._httpd = None
        self._thread = None

    def register(self, name: str, model, **config):
        """Passthrough to :meth:`ModelRegistry.register` (the model is
        served on ``device="cuda"`` unless the config says otherwise)."""
        return self.registry.register(name, model, **config)

    def start(self, port: Optional[int] = None, host: Optional[str] = None) -> int:
        if self._httpd is not None:
            return self.port
        if port is not None:
            self.port = port
        if host is not None:
            self.host = host
        handler = type("BoundServingHandler", (_ServingHandler,), {"registry": self.registry})
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                                        name="inference-server")
        self._thread.start()
        return self.port

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Stop accepting, drain every model's batcher so accepted requests
        resolve, then close the socket. The batchers are closed even when
        the server was never started."""
        if self._httpd is None:
            self.registry.close_all(drain=drain, timeout=timeout)
            return
        self._httpd.shutdown()
        self.registry.close_all(drain=drain, timeout=timeout)
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
