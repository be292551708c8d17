"""The training UI server and the JSON request handler every server of
the port builds on.

Counterpart of ``deeplearning4j_tpu/ui/server.py``.
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

The training UI's server, :class:`UIServer` (reference ``PlayUIServer``
and ``RemoteReceiverModule``), serves them first and then its own routes
over a :class:`~.stats.StatsStorage`: ``/`` (a self-contained page with
inline SVG charts), ``/train/sessions``, ``/train/overview``,
``/train/model``, ``/train/system``, ``/train/activations`` and
``/tsne/coords`` (each ``?sid=`` a session, default the latest), POST
``/remote`` (a :class:`~.stats.StatsReport` posted by
:class:`RemoteUIStatsStorageRouter`) and POST ``/tsne/upload``.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..monitor import (get_fleet, get_flight_recorder, get_health, get_registry, get_tracer,
                       profile_report, render_profile_text, sample_device_memory)
from .stats import InMemoryStatsStorage, StatsReport, StatsStorage

__all__ = ["JsonRequestHandler", "MAX_POST_BYTES", "UIServer", "RemoteUIStatsStorageRouter"]

#: POST bodies above this are refused (413) before they are read
MAX_POST_BYTES = 8 << 20

_PAGE = """<!DOCTYPE html>
<html><head><title>deeplearning4j_torch training</title>
<style>body{font-family:sans-serif;margin:2em}h1{font-size:1.3em}
.chart{border:1px solid #ccc;margin:1em 0}td,th{padding:2px 8px;text-align:right}
th{background:#eee}</style></head>
<body><h1>Training overview</h1>
<div id="meta"></div>
<svg id="score" class="chart" width="800" height="240"></svg>
<table id="params"></table>
<h1>System</h1>
<div id="sysmeta"></div>
<svg id="system" class="chart" width="800" height="160"></svg>
<h1>t-SNE</h1>
<svg id="tsne" class="chart" width="400" height="400"></svg>
<h1>Convolutional activations</h1>
<div id="actmeta"></div>
<div id="acts"></div>
<script>
function polyline(svg, xs, ys, w, h, color){
  if(ys.length<2){return;}
  const xmin=Math.min(...xs), xmax=Math.max(...xs);
  const ymin=Math.min(...ys), ymax=Math.max(...ys);
  const pts=xs.map((x,i)=>((x-xmin)/(xmax-xmin||1)*(w-20)+10)+','+
    (h-10-(ys[i]-ymin)/(ymax-ymin||1)*(h-20))).join(' ');
  svg.innerHTML+='<polyline fill="none" stroke="'+color+'" points="'+pts+'"/>';
}
async function refresh(){
  const sessions = await (await fetch('/train/sessions')).json();
  if(!sessions.length){setTimeout(refresh,2000);return;}
  const sid = sessions[sessions.length-1];
  const ov = await (await fetch('/train/overview?sid='+sid)).json();
  document.getElementById('meta').textContent =
    'session '+sid+' — '+ov.iterations.length+' iterations, last score '+
    (ov.scores.length?ov.scores[ov.scores.length-1].toFixed(5):'n/a');
  const svg = document.getElementById('score');
  svg.innerHTML='';
  polyline(svg, ov.iterations, ov.scores, 800, 240, '#07c');
  const model = await (await fetch('/train/model?sid='+sid)).json();
  function hist(st){
    if(!st.histogram||!st.histogram.length){return '';}
    const h=st.histogram, hmax=Math.max(...h)||1;
    return '<svg width="'+(h.length*4)+'" height="24">'+h.map((v,i)=>
      '<rect x="'+i*4+'" y="'+(24-22*v/hmax)+'" width="3" height="'+(22*v/hmax)+
      '" fill="#07c"/>').join('')+'</svg>';
  }
  let html='<tr><th>param</th><th>norm2</th><th>mean</th><th>stdev</th>'+
    '<th>histogram</th><th>update hist</th></tr>';
  for(const [name,st] of Object.entries(model.params||{})){
    const up=(model.updates||{})[name]||{};
    html+='<tr><td style="text-align:left">'+name+'</td><td>'+
      (st.norm2||0).toFixed(4)+'</td><td>'+(st.mean!==undefined?st.mean.toFixed(5):'')+
      '</td><td>'+(st.stdev!==undefined?st.stdev.toFixed(5):'')+'</td><td>'+
      hist(st)+'</td><td>'+hist(up)+'</td></tr>';
  }
  document.getElementById('params').innerHTML=html;
  const sys = await (await fetch('/train/system?sid='+sid)).json();
  const ssvg = document.getElementById('system');
  ssvg.innerHTML='';
  const rss = (sys.host_rss_bytes||[]).filter(v=>v!=null);
  if(rss.length){
    document.getElementById('sysmeta').textContent =
      'host RSS '+(rss[rss.length-1]/1048576).toFixed(0)+' MB';
    polyline(ssvg, sys.iterations, rss, 800, 160, '#c70');
  }
  const dev=(sys.device_bytes_in_use||[]).filter(v=>v!=null);
  if(dev.length){polyline(ssvg, sys.iterations.slice(-dev.length), dev, 800, 160, '#0a5');}
  const ts = await (await fetch('/tsne/coords')).json();
  const tsvg = document.getElementById('tsne');
  tsvg.innerHTML='';
  if(ts.coords && ts.coords.length){
    const xs=ts.coords.map(c=>c[0]), ys=ts.coords.map(c=>c[1]);
    const xmin=Math.min(...xs),xmax=Math.max(...xs);
    const ymin=Math.min(...ys),ymax=Math.max(...ys);
    tsvg.innerHTML=ts.coords.map((c,i)=>'<circle r="2" fill="#07c" cx="'+
      ((c[0]-xmin)/(xmax-xmin||1)*380+10)+'" cy="'+
      ((c[1]-ymin)/(ymax-ymin||1)*380+10)+'"/>').join('');
  }
  const act = await (await fetch('/train/activations?sid='+sid)).json();
  if(act.grids && act.grids.length){
    document.getElementById('actmeta').textContent =
      'layer '+act.layer+' @ iteration '+act.iteration;
    document.getElementById('acts').innerHTML = act.grids.map(g=>{
      const h=g.length,w=g[0].length;
      let lo=Infinity,hi=-Infinity;
      g.forEach(r=>r.forEach(v=>{lo=Math.min(lo,v);hi=Math.max(hi,v);}));
      const cells=g.map((row,y)=>row.map((v,x)=>{
        const s=Math.round((v-lo)/(hi-lo||1)*255);
        return '<rect x="'+x*4+'" y="'+y*4+'" width="4" height="4" fill="rgb('+
          s+','+s+','+s+')"/>';}).join('')).join('');
      return '<svg class="chart" width="'+w*4+'" height="'+h*4+'">'+cells+'</svg>';
    }).join(' ');
  }
  setTimeout(refresh,2000);
}
refresh();
</script></body></html>"""


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


class _Handler(JsonRequestHandler):
    """The training UI's routes after the monitor routes."""
    storage: StatsStorage = None  # set by UIServer.start
    tsne_data = None              # the latest uploaded t-SNE coordinates and labels

    def do_GET(self):
        url = urlparse(self.path)
        q = parse_qs(url.query)
        if self._monitor_get(url, q):
            return
        if url.path in ("/", "/train", "/train/overview.html"):
            self._text(_PAGE, "text/html")
            return
        if url.path == "/train/sessions":
            self._json(self.storage.list_session_ids())
            return
        sid = q.get("sid", [None])[0] or self._latest_session()
        if url.path == "/train/overview":
            ups = self.storage.get_all_updates(sid) if sid else []
            self._json({"iterations": [u.iteration for u in ups],
                        "scores": [u.score for u in ups],
                        "durations_ms": [u.duration_ms for u in ups]})
            return
        if url.path == "/train/model":
            latest = self.storage.get_latest_update(sid) if sid else None
            self._json({"params": latest.param_stats if latest else {},
                        "updates": latest.update_stats if latest else {}})
            return
        if url.path == "/train/system":
            # the reference train UI's system tab: memory and GC a report
            ups = [u for u in (self.storage.get_all_updates(sid) if sid else [])
                   if getattr(u, "system", None)]
            self._json({
                "iterations": [u.iteration for u in ups],
                **{k: [u.system.get(k) for u in ups]
                   for k in ("host_rss_bytes", "host_peak_rss_bytes", "device_bytes_in_use",
                             "gc_collections")}})
            return
        if url.path == "/train/activations":
            # the latest convolutional activation map
            for u in reversed(self.storage.get_all_updates(sid) if sid else []):
                if getattr(u, "activations", None):
                    self._json({"iteration": u.iteration, **u.activations})
                    return
            self._json({"iteration": None, "layer": None, "grids": []})
            return
        if url.path == "/tsne/coords":
            self._json(type(self).tsne_data or {"coords": [], "labels": []})
            return
        self._json({"error": "not found"}, 404)

    def do_POST(self):
        path = urlparse(self.path).path
        body = self._post_body()
        if body is None:
            return
        if path == "/remote":
            try:
                report = StatsReport.from_json(body)
            except (ValueError, TypeError) as e:   # malformed JSON or keys
                self._json({"error": str(e)}, 400)
                return
            self.storage.put_update(report)
            self._json({"status": "ok"})
            return
        if path == "/tsne/upload":
            # the t-SNE tab's data: {"coords": [[x, y], ...], "labels": [...]}
            try:
                data = json.loads(body)
                type(self).tsne_data = {"coords": data.get("coords", []),
                                        "labels": data.get("labels", [])}
            except (ValueError, AttributeError) as e:
                self._json({"error": str(e)}, 400)
                return
            self._json({"status": "ok"})
            return
        self._json({"error": "not found"}, 404)

    def _latest_session(self):
        ids = self.storage.list_session_ids()
        return ids[-1] if ids else None


class UIServer:
    """Reference ``UIServer.getInstance()`` / ``attach(statsStorage)``."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000, host: str = "127.0.0.1"):
        self.port = port
        self.host = host
        self.storage: StatsStorage = InMemoryStatsStorage()
        self._httpd = None
        self._thread = None

    @classmethod
    def get_instance(cls) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer()
        return cls._instance

    getInstance = get_instance

    def attach(self, storage: StatsStorage):
        self.storage = storage
        if self._httpd is not None:
            self._httpd.RequestHandlerClass.storage = storage
        return self

    def start(self, port: Optional[int] = None, host: Optional[str] = None) -> int:
        """Serve on a thread; returns the bound port (0: an ephemeral one).

        ``host`` defaults to the constructor's (loopback); ``"0.0.0.0"``
        makes the routes reachable from other machines, and they are
        unauthenticated."""
        if self._httpd is not None:
            return self.port
        if port is not None:
            self.port = port
        if host is not None:
            self.host = host
        handler = type("BoundHandler", (_Handler,), {"storage": self.storage})
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                                        name="ui-server")
        self._thread.start()
        return self.port

    def upload_tsne(self, coords, labels=None):
        """Publish t-SNE coordinates (an array, a nested list or a tensor,
        e.g. from ``clustering.tsne``) to the t-SNE tab."""
        if isinstance(coords, torch.Tensor):
            coords = coords.detach().cpu()
        data = {"coords": np.asarray(coords).tolist(),
                "labels": list(labels) if labels is not None else []}
        if self._httpd is not None:
            self._httpd.RequestHandlerClass.tsne_data = data
        else:
            _Handler.tsne_data = data
        return self

    uploadTsne = upload_tsne

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = self._thread = None

    detach = stop


class RemoteUIStatsStorageRouter:
    """POSTs reports to a UI server's ``/remote`` (reference
    ``RemoteUIStatsStorageRouter`` + ``RemoteReceiverModule``)."""

    def __init__(self, address: str):
        self.address = address.rstrip("/")

    def put_update(self, report: StatsReport):
        import urllib.request
        req = urllib.request.Request(
            self.address + "/remote", data=report.to_json().encode("utf-8"),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read().decode("utf-8"))

    putUpdate = put_update
