"""The shared kernel-library cache (the compile-once fleet, half 1).

Counterpart of ``deeplearning4j_tpu/compilecache/cache.py``. The JAX
package points XLA's persistent compilation cache at a directory; the
port's compile step is the ``nvcc`` build of its kernel libraries
(``ops/cuda_build.py``), so the cache is the directory those libraries are
built in and loaded from:

- :func:`enable` makes ``cache_dir`` (or ``DL4J_TPU_COMPILE_CACHE_DIR``)
  the place where every process of a fleet builds and loads libraries;
  without it they stay in ``build/torch_kernels/``.
- :func:`maybe_enable` is the fleet seam: a no-op unless the variable is
  set, called where a process is about to compile (a serving
  registration).
- A library found on disk is a *hit*, an ``nvcc`` run a *miss*
  (:func:`note_library`, called by ``cuda_build``). :func:`hits_count` and
  :func:`claim_persistent_hit` are jitwatch's claim protocol: a first call
  whose window saw a hit counts under
  ``jit_persistent_cache_hits_total{fn=}``.
- :func:`cache_stats` counts libraries, warmup artifacts and bytes;
  :func:`gc_cache` evicts libraries whose recorded fingerprint (toolkit,
  flags, architecture) differs from the running one, artifacts whose
  runtime fingerprint differs, unreadable ones and orphaned temp files.
  Dry-run by default.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)

__all__ = ["ENV_DIR", "enable", "maybe_enable", "enabled", "cache_dir", "note_library",
           "hits_count", "claim_persistent_hit", "persistent_cache_counts", "cache_stats",
           "gc_cache"]

#: the fleet dial: one shared directory, exported to every replica
ENV_DIR = "DL4J_TPU_COMPILE_CACHE_DIR"

# a leaf mutex over the counters, deliberately not a lockwatch lock (as
# in the JAX package): it never nests
_LOCK = threading.Lock()
_STATE: Dict[str, Any] = {"dir": None, "hits": 0, "misses": 0, "claimed": 0}
#: lock-free flag read on every monitored call
_ENABLED_FAST = [False]


def note_library(hit: bool) -> None:
    """One library request of ``cuda_build``: found on disk (``hit``) or
    built by ``nvcc``."""
    with _LOCK:
        _STATE["hits" if hit else "misses"] += 1


def enable(cache_dir: Optional[str] = None) -> Optional[str]:
    """Build and load kernel libraries in ``cache_dir`` (or the
    ``DL4J_TPU_COMPILE_CACHE_DIR`` directory). Idempotent; returns the
    active directory, or None when none is configured or it cannot be
    made (the cache is an optimisation: the libraries then stay in
    ``build/torch_kernels/``)."""
    d = cache_dir or os.environ.get(ENV_DIR)
    if not d:
        return None
    d = os.path.abspath(d)
    try:
        os.makedirs(d, exist_ok=True)
    except OSError as e:
        log.warning("compilecache: could not use %s: %r", d, e)
        return None
    with _LOCK:
        _STATE["dir"] = d
    _ENABLED_FAST[0] = True
    log.info("compilecache: kernel libraries at %s", d)
    return d


def maybe_enable() -> Optional[str]:
    """:func:`enable` iff ``DL4J_TPU_COMPILE_CACHE_DIR`` is set."""
    with _LOCK:
        if _STATE["dir"]:
            return _STATE["dir"]
    if not os.environ.get(ENV_DIR):
        return None
    return enable()


def enabled() -> bool:
    return _ENABLED_FAST[0]


def cache_dir() -> Optional[str]:
    with _LOCK:
        return _STATE["dir"]


def hits_count() -> int:
    """The raw hit count, read without the lock before a monitored call
    (the claim re-checks under it)."""
    return _STATE["hits"]


def claim_persistent_hit(hits_before: int) -> bool:
    """Claim one hit for a first call the caller just saw, only when the
    hit count grew inside the caller's window and an unclaimed hit
    remains (so the process total stays exact under racing calls)."""
    with _LOCK:
        if _STATE["hits"] > hits_before and _STATE["claimed"] < _STATE["hits"]:
            _STATE["claimed"] += 1
            return True
        return False


def persistent_cache_counts() -> Dict[str, int]:
    """This process's {hits, misses}: a miss is one ``nvcc`` run."""
    with _LOCK:
        return {"hits": _STATE["hits"], "misses": _STATE["misses"]}


def _resolve_dir(cache_dir_: Optional[str]) -> Optional[str]:
    if cache_dir_:
        return os.path.abspath(cache_dir_)
    return _STATE["dir"] or os.environ.get(ENV_DIR) or None


def _library_names(d: str) -> List[str]:
    try:
        return sorted(n for n in os.listdir(d) if n.startswith("lib") and n.endswith(".so"))
    except OSError:
        return []


def cache_stats(cache_dir: Optional[str] = None) -> Dict[str, Any]:
    """Directory census: kernel libraries (``entries``), warmup
    artifacts, total bytes, and this process's hit/miss counts."""
    from .artifacts import ARTIFACT_EXT
    d = _resolve_dir(cache_dir)
    out: Dict[str, Any] = {"dir": d, "enabled": enabled(), "entries": 0, "artifacts": 0,
                           "bytes": 0, "process": persistent_cache_counts()}
    if not d or not os.path.isdir(d):
        return out
    libs = set(_library_names(d))
    for name in os.listdir(d):
        try:
            out["bytes"] += os.path.getsize(os.path.join(d, name))
        except OSError:
            continue
        if name.endswith(ARTIFACT_EXT):
            out["artifacts"] += 1
        elif name in libs:
            out["entries"] += 1
    return out


def _library_reason(path: str, fp: Dict[str, Any]) -> Optional[str]:
    side = os.path.splitext(path)[0] + ".json"
    try:
        with open(side) as fh:
            rec = json.load(fh)
    except (OSError, ValueError) as e:
        return f"no readable fingerprint: {e!r}"
    got = {k: rec.get(k) for k in fp}
    if got != fp:
        return f"fingerprint mismatch: library {got} vs running {fp}"
    return None


def gc_cache(cache_dir: Optional[str] = None, dry_run: bool = True) -> Dict[str, Any]:
    """Evict libraries built under another toolkit, flags or architecture
    than the running ones (with their sidecars and build logs), artifacts
    whose runtime fingerprint differs or that cannot be read, and the
    temp files of killed builds or exports. ``dry_run`` lists them only."""
    from ..ops import cuda_build
    from .artifacts import ARTIFACT_EXT, read_manifest, runtime_fingerprint
    d = _resolve_dir(cache_dir)
    report: Dict[str, Any] = {"dir": d, "dry_run": bool(dry_run), "scanned": 0, "kept": 0,
                              "evicted": []}
    if not d or not os.path.isdir(d):
        return report
    lib_fp = cuda_build.fingerprint()
    run_fp = runtime_fingerprint()
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if name.endswith(".tmp"):
            reason = "orphaned temp file"
            extra: List[str] = []
        elif name.startswith("lib") and name.endswith(".so"):
            reason = _library_reason(path, lib_fp)
            stem = os.path.splitext(path)[0]
            extra = [p for p in (stem + ".json", stem + ".log") if os.path.exists(p)]
        elif name.endswith(ARTIFACT_EXT):
            extra = []
            try:
                manifest = read_manifest(path)
            except Exception as e:
                reason = f"unreadable: {e!r}"
            else:
                fp = manifest.get("fingerprint")
                reason = (None if fp == run_fp else
                          f"fingerprint mismatch: artifact {fp} vs running {run_fp}")
        else:
            continue
        report["scanned"] += 1
        if reason is None:
            report["kept"] += 1
            continue
        entry: Dict[str, Any] = {"path": path, "reason": reason}
        if not dry_run:
            try:
                for p in [path] + extra:
                    os.unlink(p)
                entry["removed"] = True
            except OSError as e:
                entry["removed"] = False
                entry["error"] = repr(e)
        report["evicted"].append(entry)
    return report
