"""HTTP/JSON inference front door.

Counterpart of ``deeplearning4j_tpu/serving/server.py`` (stdlib
``ThreadingHTTPServer``):

- ``POST /v1/models/<name>/predict`` — body ``{"inputs": [[...], ...],
  "deadline_ms": optional}``; responds ``{"model", "outputs",
  "latency_ms"}``. Unknown model -> 404, malformed body or shape -> 400,
  :class:`OverloadedError` -> 429 with ``Retry-After``,
  :class:`DeadlineExceededError` -> 504, anything else -> 500.
- ``GET /v1/models`` — hosted models with their serving config.
- ``GET /v1/models/<name>`` — one model's row.

The monitor routes of the JAX server are not ported yet. Each handler
thread blocks on its request's Future while the model's batcher coalesces
concurrent requests; ``stop(drain=True)`` stops accepting, drains every
model's queue, then closes the socket.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from .batcher import DeadlineExceededError, ModelNotFoundError, OverloadedError
from .registry import ModelRegistry

__all__ = ["InferenceServer", "MAX_POST_BYTES"]

#: request bodies above this are refused (413) before they are read
MAX_POST_BYTES = 8 << 20


class _ServingHandler(BaseHTTPRequestHandler):
    registry: ModelRegistry = None     # bound by the server

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, obj, code=200, headers=None):
        payload = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _post_body(self) -> Optional[str]:
        """The POST body, or None after sending the 400/413 reply."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            length = -1
        if length < 0:
            self._json({"error": "bad Content-Length"}, 400)
            return None
        if length > MAX_POST_BYTES:
            self._json({"error": f"body of {length} bytes exceeds the "
                        f"{MAX_POST_BYTES}-byte limit"}, 413)
            return None
        return self.rfile.read(length).decode("utf-8")

    def do_GET(self):
        parts = [p for p in urlparse(self.path).path.split("/") if p]
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
        if not (len(parts) == 4 and parts[:2] == ["v1", "models"]
                and parts[3] == "predict"):
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
        try:
            fut = self.registry.submit(name, inputs, deadline_ms=deadline_ms)
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
                    "latency_ms": round((time.perf_counter() - t0) * 1e3, 3)})


class InferenceServer:
    """A :class:`ModelRegistry` behind HTTP. ``start(port=0)`` returns the
    bound port; the bind is loopback by default (the endpoints are
    unauthenticated)."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 port: int = 8500, host: str = "127.0.0.1"):
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
        handler = type("BoundServingHandler", (_ServingHandler,),
                       {"registry": self.registry})
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="inference-server")
        self._thread.start()
        return self.port

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Stop accepting, drain every model's batcher so accepted requests
        resolve, then close the listening socket. The models' batchers are
        closed even when the server was never started."""
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
