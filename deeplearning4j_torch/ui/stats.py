"""Training stats: the report, its storages and the listener.

Counterpart of ``deeplearning4j_tpu/ui/stats.py`` (reference
``deeplearning4j-ui-model``: ``BaseStatsListener.java:286-307``'s
``iterationDone``, the ``StatsStorage`` SPI and the in-memory, file and
sqlite backends). Reports are the JAX package's JSON records with its
keys, so a stats file (JSON lines or sqlite) written by either package
loads in the other.

What is the port's own is where the numbers are computed. The JAX
listener pulls every parameter to the host each report; here a report's
statistics are reduced in float64 where the parameters lie
(:func:`_stats_batch`), and a report copies two small vectors to the
host, never a parameter:

1. every array's min and max, from which the host computes numpy's
   histogram edges (``np.histogram_bin_edges``: ``linspace(min, max,
   bins + 1)``, widened to ``min - 0.5 .. max + 0.5`` for a constant
   array);
2. the moments (mean, variance, norm2, the sum of magnitudes) and, for
   each inner edge, how many elements lie on or above it, counted on the
   device against those edges; the host takes the bin counts from them
   (right-open bins, the last closed: numpy's rule). ``torch.histc`` is
   not used: its range for constant data is not numpy's, and it bins in
   float32.

The listener's previous parameters stay on the model's device as clones,
so an update's delta never crosses to the host either.
"""
from __future__ import annotations

import gc
import json
import math
import resource
import sqlite3
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..monitor.lockwatch import make_lock
from ..optimize.listeners import TrainingListener

__all__ = ["StatsReport", "StatsStorage", "InMemoryStatsStorage", "FileStatsStorage",
           "SqliteStatsStorage", "StatsListener"]

#: bins of every histogram (the JAX package's)
BINS = 20


# ---------------------------------------------------------------- stat record
#: elements compared with an array's edges at once (the comparison is a
#: [run, bins - 1] boolean block on the device)
RUN_ELEMS = 1 << 22


def _stats_batch(arrays: Sequence[torch.Tensor], bins: int = BINS,
                 histograms: bool = True) -> List[Dict[str, Any]]:
    """The JAX package's ``_array_stats`` of each array (``{}`` for an
    empty one), or only ``{"norm2": ...}`` without ``histograms``.

    The arrays lie on one device and each is reduced there in float64 by a
    few launches (min and max; mean and variance; the two norms; the
    number of elements on or above each inner edge, from which the host
    takes the bin counts: right-open bins, the last closed, as numpy's).
    The results of all of them reach the host in two copies (one without
    histograms); the edges between them are numpy's, from the copied min
    and max."""
    ts = [a.detach().reshape(-1) for a in arrays]
    f64 = torch.float64
    if not histograms:
        if not ts:
            return []
        norms = torch.stack([torch.linalg.vector_norm(t.to(f64)) for t in ts])
        return [{"norm2": v} for v in norms.cpu().tolist()]
    out: List[Dict[str, Any]] = [{} for _ in ts]
    full = [i for i, t in enumerate(ts) if t.numel()]
    if not full:
        return out
    ends = torch.stack([v for i in full for v in torch.aminmax(ts[i])]).to(f64)
    ends = ends.cpu().numpy().reshape(-1, 2)
    # numpy's edges (and its ValueError for a range that is not finite)
    edges = np.stack([np.histogram_bin_edges(e, bins=bins) for e in ends])
    inner = torch.from_numpy(edges[:, 1:-1]).to(ts[full[0]].device)
    moments, above = [], []
    for k, i in enumerate(full):
        x = ts[i].to(f64)
        var, mean = torch.var_mean(x, correction=0)
        moments += [mean, var, torch.linalg.vector_norm(x), torch.linalg.vector_norm(x, 1)]
        ge = None
        for s in range(0, x.numel(), RUN_ELEMS):
            c = (x[s:s + RUN_ELEMS, None] >= inner[k]).sum(0)
            ge = c if ge is None else ge + c
        above.append(ge)
    rest = torch.cat((torch.stack(moments).view(-1, 4), torch.stack(above).to(f64)), 1)
    rest = rest.cpu().numpy()
    for k, i in enumerate(full):
        n = ts[i].numel()
        mean, var, norm2, l1 = (float(v) for v in rest[k, :4])
        counts = -np.diff(np.concatenate(([n], rest[k, 4:], [0])))
        out[i] = {"mean": mean, "stdev": math.sqrt(var), "min": float(ends[k, 0]),
                  "max": float(ends[k, 1]), "norm2": norm2, "mean_magnitude": l1 / n,
                  "histogram": [int(c) for c in counts],
                  "histogram_edges": [float(edges[k, 0]), float(edges[k, -1])]}
    return out


def _array_stats(arr: torch.Tensor, bins: int = BINS) -> Dict[str, Any]:
    """One tensor's statistics, as the JAX package's ``_array_stats``."""
    return _stats_batch([arr], bins)[0]


def _system_stats(device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Memory and GC stats of one iteration (reference
    ``BaseStatsListener.java:286-307``): host RSS and its peak, the card's
    allocator counters when ``device`` is a card (left out for a CPU
    model, as the JAX package's CPU backend leaves them out), and Python's
    GC counts in place of the JVM's."""
    out: Dict[str, Any] = {}
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out["host_peak_rss_bytes"] = int(ru.ru_maxrss) * 1024   # KiB on Linux
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        out["host_rss_bytes"] = pages * 4096
    except OSError:
        out["host_rss_bytes"] = out["host_peak_rss_bytes"]
    if device is not None and device.type == "cuda":
        ms = torch.cuda.memory_stats(device)
        out["device_bytes_in_use"] = int(ms.get("allocated_bytes.all.current", 0))
        out["device_bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
        out["device_peak_bytes_in_use"] = int(ms.get("allocated_bytes.all.peak", 0))
    out["gc_collections"] = [s.get("collections", 0) for s in gc.get_stats()]
    out["gc_collected"] = [s.get("collected", 0) for s in gc.get_stats()]
    return out


class StatsReport:
    """One iteration's stats (reference ``StatsReport``)."""

    def __init__(self, session_id: str, worker_id: str, iteration: int,
                 timestamp: float, score: float,
                 param_stats: Dict[str, Dict], update_stats: Dict[str, Dict],
                 duration_ms: float, memory_bytes: Optional[int] = None,
                 system: Optional[Dict[str, Any]] = None,
                 activations: Optional[Dict[str, Any]] = None):
        self.session_id = session_id
        self.worker_id = worker_id
        self.iteration = iteration
        self.timestamp = timestamp
        self.score = score
        self.param_stats = param_stats
        self.update_stats = update_stats
        self.duration_ms = duration_ms
        self.memory_bytes = memory_bytes
        self.system = system
        self.activations = activations

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @staticmethod
    def from_json(s: str) -> "StatsReport":
        return StatsReport(**json.loads(s))


# -------------------------------------------------------------------- storage
class StatsStorage:
    """SPI (reference ``api/storage/StatsStorage.java``)."""

    def put_update(self, report: StatsReport):
        raise NotImplementedError

    putUpdate = put_update

    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    listSessionIDs = list_session_ids

    def get_all_updates(self, session_id: str) -> List[StatsReport]:
        raise NotImplementedError

    getAllUpdates = get_all_updates

    def get_latest_update(self, session_id: str) -> Optional[StatsReport]:
        ups = self.get_all_updates(session_id)
        return ups[-1] if ups else None

    getLatestUpdate = get_latest_update

    def close(self):
        pass


class InMemoryStatsStorage(StatsStorage):
    """Reference ``ui/storage/InMemoryStatsStorage``."""

    def __init__(self):
        self._updates: Dict[str, List[StatsReport]] = {}
        self._lock = make_lock("InMemoryStatsStorage._lock")

    def put_update(self, report: StatsReport):
        with self._lock:
            self._updates.setdefault(report.session_id, []).append(report)

    putUpdate = put_update

    def list_session_ids(self):
        return list(self._updates)

    listSessionIDs = list_session_ids

    def get_all_updates(self, session_id):
        return list(self._updates.get(session_id, []))

    getAllUpdates = get_all_updates


class FileStatsStorage(StatsStorage):
    """JSON lines, one report a line, flushed at each put (reference
    ``FileStatsStorage``: every update persisted and reloadable)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = make_lock("FileStatsStorage._lock")
        self._fh = open(path, "a", encoding="utf-8")

    def put_update(self, report: StatsReport):
        with self._lock:
            self._fh.write(report.to_json() + "\n")
            self._fh.flush()

    putUpdate = put_update

    def _read_all(self) -> List[StatsReport]:
        with self._lock:
            self._fh.flush()
        with open(self.path, encoding="utf-8") as f:
            return [StatsReport.from_json(line) for line in (ln.strip() for ln in f) if line]

    def list_session_ids(self):
        return sorted({r.session_id for r in self._read_all()})

    listSessionIDs = list_session_ids

    def get_all_updates(self, session_id):
        return [r for r in self._read_all() if r.session_id == session_id]

    getAllUpdates = get_all_updates

    def close(self):
        self._fh.close()


class SqliteStatsStorage(StatsStorage):
    """Reference ``ui/storage/sqlite/J7FileStatsStorage``: one row a
    report (session, iteration, JSON payload)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = make_lock("SqliteStatsStorage._lock")
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("CREATE TABLE IF NOT EXISTS updates (session_id TEXT, "
                           "iteration INTEGER, payload TEXT)")
        self._conn.commit()

    def put_update(self, report: StatsReport):
        with self._lock:
            self._conn.execute("INSERT INTO updates VALUES (?, ?, ?)",
                               (report.session_id, report.iteration, report.to_json()))
            self._conn.commit()

    putUpdate = put_update

    def list_session_ids(self):
        cur = self._conn.execute("SELECT DISTINCT session_id FROM updates")
        return [r[0] for r in cur.fetchall()]

    listSessionIDs = list_session_ids

    def get_all_updates(self, session_id):
        cur = self._conn.execute(
            "SELECT payload FROM updates WHERE session_id=? ORDER BY iteration", (session_id,))
        return [StatsReport.from_json(r[0]) for r in cur.fetchall()]

    getAllUpdates = get_all_updates

    def close(self):
        self._conn.close()


# ------------------------------------------------------------------- listener
class StatsListener(TrainingListener):
    """Reference ``BaseStatsListener.java:286`` ``iterationDone``: the
    score, every parameter's and every update's statistics, system stats
    and (with ``activation_probe``) a convolutional activation map, into
    ``storage`` every ``frequency`` iterations.

    ``collect_system``: the memory/GC stats of :func:`_system_stats`.
    ``activation_probe``: a features batch; every ``activation_frequency``
    reports the model runs it forward on its device and stores example 0's
    first rank-4 (NHWC) activation, cut to ``activation_max_channels``
    channels (the reference train UI's convolutional-activations view)."""

    def __init__(self, storage: StatsStorage, frequency: int = 1,
                 session_id: Optional[str] = None, worker_id: str = "worker0",
                 collect_histograms: bool = True,
                 collect_system: bool = True,
                 activation_probe=None, activation_frequency: int = 10,
                 activation_max_channels: int = 16):
        self.storage = storage
        self.frequency = max(1, frequency)
        self.session_id = session_id or f"session_{int(time.time() * 1e3)}"
        self.worker_id = worker_id
        self.collect_histograms = collect_histograms
        self.collect_system = collect_system
        self.activation_probe = activation_probe
        self.activation_frequency = max(1, activation_frequency)
        self.activation_max_channels = activation_max_channels
        self._last_time = None
        #: the parameters at the last report, cloned on the model's device
        self._prev_params: Optional[Dict[str, torch.Tensor]] = None
        self._reports = 0

    def _conv_activations(self, model):
        """Example 0's first rank-4 activation on the probe batch, as
        ``{"layer", "grids": [channel][row][col]}``; None without one."""
        acts = model.feed_forward(self.activation_probe)
        if isinstance(acts, dict):
            # a graph: skip its inputs, keep the vertices' activations
            inputs = set(getattr(model.conf, "network_inputs", ()))
            items = ((k, v) for k, v in acts.items() if k not in inputs)
        else:
            # a MultiLayerNetwork's list starts with the input itself
            items = ((str(i), a) for i, a in enumerate(acts[1:]))
        for name, a in items:
            if a.dim() == 4:  # NHWC
                grid = a[0, :, :, :self.activation_max_channels].permute(2, 0, 1)
                return {"layer": name, "grids": grid.float().cpu().tolist()}
        return None

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency != 0:
            return
        now = time.perf_counter()
        duration = 0.0 if self._last_time is None else (now - self._last_time) * 1e3
        self._last_time = now
        table = {k: v.detach() for k, v in model.param_table().items()}
        prev = self._prev_params
        moved = [k for k in table if prev is not None and k in prev]
        stats = _stats_batch([*table.values(), *(table[k] - prev[k] for k in moved)],
                             histograms=self.collect_histograms)
        params = dict(zip(table, stats))
        updates = dict(zip(moved, stats[len(table):]))
        self._prev_params = {k: v.clone() for k, v in table.items()}
        device = next(iter(table.values())).device if table else None
        system = _system_stats(device) if self.collect_system else None
        activations = None
        if self.activation_probe is not None and self._reports % self.activation_frequency == 0:
            activations = self._conv_activations(model)
        self._reports += 1
        self.storage.put_update(StatsReport(
            self.session_id, self.worker_id, int(iteration), time.time(), float(score), params,
            updates, duration, system=system, activations=activations))
