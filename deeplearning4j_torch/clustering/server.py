"""Nearest-neighbours REST server.

Counterpart of ``deeplearning4j_tpu/clustering/server.py`` (reference
``nearestneighbor-server/.../NearestNeighborsServer.java`` and its client):
a stdlib HTTP server answering VPTree kNN queries over a loaded point set.

 - POST /knn       {"index": i, "k": n}           -> neighbours of stored point
 - POST /knnnew    {"point": [...], "k": n}       -> neighbours of a new point
 - GET  /status    -> {"numPoints": ..., "dim": ...}
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from .trees import VPTree


class NearestNeighborsServer:
    def __init__(self, points: np.ndarray, distance: str = "euclidean",
                 port: int = 9200):
        self.points = np.asarray(points, np.float64)
        self.tree = VPTree(self.points, distance=distance)
        self.port = port
        self._httpd = None
        self._thread = None

    def start(self, port: Optional[int] = None) -> int:
        if port is not None:
            self.port = port
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _json(self, obj, code=200):
                payload = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if urlparse(self.path).path == "/status":
                    self._json({"numPoints": len(server.points),
                                "dim": int(server.points.shape[1])})
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                path = urlparse(self.path).path
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length).decode("utf-8"))
                    k = int(body.get("k", 5))
                    if path == "/knn":
                        q = server.points[int(body["index"])]
                    elif path == "/knnnew":
                        q = np.asarray(body["point"], np.float64)
                    else:
                        self._json({"error": "not found"}, 404)
                        return
                    idxs, dists = server.tree.search(q, k)
                    self._json({"results": [
                        {"index": int(i), "distance": float(d)}
                        for i, d in zip(idxs, dists)]})
                except Exception as e:
                    self._json({"error": str(e)}, 400)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


class NearestNeighborsClient:
    """HTTP client (reference ``nearestneighbor-client``)."""

    def __init__(self, address: str):
        self.address = address.rstrip("/")

    def _post(self, path, body):
        import urllib.request
        req = urllib.request.Request(
            self.address + path, data=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def knn(self, index: int, k: int):
        return self._post("/knn", {"index": index, "k": k})

    def knn_new(self, point, k: int):
        return self._post("/knnnew", {"point": list(map(float, point)),
                                      "k": k})

    knnNew = knn_new
