"""Warmup artifacts (the compile-once fleet, half 2).

Counterpart of ``deeplearning4j_tpu/compilecache/artifacts.py``. The JAX
artifact holds a served model's compiled executables. An eager port has no
executable to ship: its compile step is the ``nvcc`` build of the kernel
libraries, and a forward's first call at a new signature is what warmup
pays. So the port's artifact is one zip with

- ``manifest.json``: the runtime fingerprint (torch, CUDA, the card's
  name, ``sm_90a``), the topology hash (sha256 of the configuration JSON),
  the precision, the buckets and ``compile_signatures``, and each
  library's source, file name, sha256 and the fingerprint it was built
  under (the builder's sidecar: toolkit, flags, architecture);
- ``golden.json``: the model's golden set (``ServedModel.golden``);
- ``lib/<name>``: the kernel libraries the model's forward loads, under
  their source-hash names (``cuda_build._target``);

and nothing else. :func:`try_install` checks every field before it writes
a byte: the fingerprint, topology, precision and buckets must match, a
library is installed only under the name ``cuda_build._target`` computes
from this tree's sources and the flags, and its bytes must have the
recorded sha256. Any mismatch or corruption falls back loudly (a
``compile_cache_miss`` flight event naming the reason) to the live
warmup, never a crash. After an install the served forward is the same
eager forward: it loads the installed libraries instead of running
``nvcc``, and the install runs no ``nvcc`` either (the sidecar it writes
is the builder's fingerprint from the manifest).

Trust boundary: these checks catch a STALE or corrupt artifact, not a
crafted one. The name is a hash of the sources and flags, not of the
binary, and the sha256 is the artifact's own, so an installed library is
whatever its exporter built; it is loaded into the process with ctypes.
The artifact and the cache directory are trusted infrastructure, as the
JAX package's are (anyone who can write them can already plant a library
the next build would load).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import zipfile
from typing import Any, Dict, Iterable, Optional

import torch

log = logging.getLogger(__name__)

__all__ = ["ARTIFACT_EXT", "ArtifactError", "runtime_fingerprint", "topology_hash",
           "export_warmup_artifact", "read_manifest", "load_warmup_artifact",
           "try_install"]

ARTIFACT_EXT = ".dl4jaot"
#: the port's format tag; a JAX-written artifact (format 1) is refused
FORMAT = "torch/1"


class ArtifactError(RuntimeError):
    """The artifact cannot be used (corrupt, or a fingerprint, topology,
    configuration or library mismatch)."""


def runtime_fingerprint() -> Dict[str, Optional[str]]:
    """What the artifact's libraries and first calls are valid under:
    torch, its CUDA, the card's name (None without one) and the
    architecture the kernels are built for. Compared exactly."""
    from ..ops.cuda_build import ARCH
    card = torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
    return {"torch": str(torch.__version__), "cuda": torch.version.cuda, "device": card,
            "arch": ARCH}


def topology_hash(model) -> str:
    """sha256 of the configuration JSON (architecture, not weights); a
    model without one hashes its class."""
    conf = getattr(model, "conf", None)
    to_json = getattr(conf, "to_json", None)
    material = (to_json() if callable(to_json)
                else f"{type(model).__module__}.{type(model).__qualname__}")
    return hashlib.sha256(material.encode("utf-8")).hexdigest()


def _manifest_digest(manifest: Dict[str, Any]) -> str:
    material = json.dumps({k: manifest[k] for k in ("topology", "precision", "signatures",
                                                    "batch_buckets", "time_buckets",
                                                    "fingerprint", "kind")}, sort_keys=True)
    return hashlib.sha256(material.encode("utf-8")).hexdigest()


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def export_warmup_artifact(served, out: str, sources: Optional[Iterable[str]] = None) -> str:
    """Write ``served``'s warmup artifact to ``out`` (a directory: the
    file gets the name ``<model>-<digest16>.dl4jaot``; else the exact
    path). The export warms the model live, recording the kernel
    libraries its forward loads (``sources`` overrides that list), and
    captures the golden set. Returns the written path."""
    from ..ops import cuda_build
    model = served.model
    if not hasattr(model, "impls"):
        raise ValueError(f"model {served.name!r} ({type(model).__name__}) is not a framework "
                         f"net: warmup artifacts cover MultiLayerNetwork/ComputationGraph")
    if served.input_shape is None:
        raise ValueError(f"model {served.name!r}: export needs input_shape= at registration "
                         f"(same as warm())")
    b = served.batcher
    sigs = b.compile_signatures(served.input_shape)
    with cuda_build.recording() as used:
        served.warm()
    golden = served.golden()
    srcs = sorted(set(sources) if sources is not None else used)
    libs = []
    for src in srcs:
        path = cuda_build._target(src)
        data = path.read_bytes()
        # the fingerprint the library was built under, from its build's
        # sidecar (the replica that installs it may have no toolkit)
        built = json.loads(path.with_suffix(".json").read_text())
        libs.append({"source": src, "name": path.name, "sha256": _sha256(data),
                     "built": {k: built.get(k) for k in ("nvcc", "flags", "arch")},
                     "data": data})
    manifest: Dict[str, Any] = {
        "format": FORMAT, "name": served.name, "model_class": type(model).__name__,
        "kind": "graph" if hasattr(model.conf, "vertices") else "mln",
        "topology": topology_hash(model), "precision": served.precision,
        "input_shape": list(served.input_shape),
        "batch_buckets": list(b._bb) if b._bb else None,
        "time_buckets": list(b._tb) if b._tb else None,
        "fingerprint": runtime_fingerprint(),
        "signatures": [{"shape": list(shape), "dtype": dt, "masked": m}
                       for shape, dt, m in sigs],
        "golden_version": golden["version"],
        "libraries": [{k: v for k, v in lib.items() if k != "data"} for lib in libs],
    }
    if os.path.isdir(out) or out.endswith(os.sep):
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"{served.name}-{_manifest_digest(manifest)[:16]}{ARTIFACT_EXT}")
    else:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        path = out
    tmp = path + ".tmp"
    # libraries are stored, not deflated: tens of MB of machine code
    # compress little and the cold replica reads them on its start
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED) as z:
        z.writestr("manifest.json", json.dumps(manifest, indent=2))
        z.writestr("golden.json", json.dumps(golden))
        for lib in libs:
            z.writestr(f"lib/{lib['name']}", lib["data"])
    os.replace(tmp, path)
    log.info("compilecache: exported warmup artifact for %r (%d signatures, %d libraries) "
             "to %s", served.name, len(sigs), len(libs), path)
    return path


def read_manifest(path: str) -> Dict[str, Any]:
    """The manifest alone; raises :class:`ArtifactError` on another
    format (a JAX-written artifact among them)."""
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read("manifest.json").decode("utf-8"))
    if manifest.get("format") != FORMAT:
        raise ArtifactError(f"unsupported artifact format {manifest.get('format')!r} "
                            f"(expected {FORMAT!r})")
    return manifest


def load_warmup_artifact(path: str):
    """(manifest, golden set, {library name: bytes}); no checks beyond the
    format (:func:`try_install` makes them)."""
    manifest = read_manifest(path)
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        expected = {"manifest.json", "golden.json"} | {
            f"lib/{lib['name']}" for lib in manifest.get("libraries", [])}
        if names != expected:
            raise ArtifactError(f"artifact members {sorted(names)} differ from what its "
                                f"manifest lists {sorted(expected)}")
        golden = json.loads(z.read("golden.json").decode("utf-8"))
        libs = {lib["name"]: z.read(f"lib/{lib['name']}")
                for lib in manifest.get("libraries", [])}
    return manifest, golden, libs


def _verify(served, manifest: Dict[str, Any]) -> None:
    """Every gate before anything is installed; raises
    :class:`ArtifactError` naming the first mismatch."""
    from ..ops import cuda_build
    fp = runtime_fingerprint()
    if manifest.get("fingerprint") != fp:
        raise ArtifactError(f"fingerprint mismatch: artifact {manifest.get('fingerprint')} "
                            f"vs running {fp}")
    topo = topology_hash(served.model)
    if manifest.get("topology") != topo:
        raise ArtifactError(f"topology mismatch: artifact {manifest.get('topology', '')[:16]}"
                            f"… vs model {topo[:16]}…")
    if manifest.get("precision") != served.precision:
        raise ArtifactError(f"precision mismatch: artifact {manifest.get('precision')!r} vs "
                            f"served {served.precision!r}")
    b = served.batcher
    bb = list(b._bb) if b._bb else None
    tb = list(b._tb) if b._tb else None
    if manifest.get("batch_buckets") != bb or manifest.get("time_buckets") != tb:
        raise ArtifactError(f"bucket mismatch: artifact ({manifest.get('batch_buckets')}, "
                            f"{manifest.get('time_buckets')}) vs batcher ({bb}, {tb})")
    for lib in manifest.get("libraries", []):
        want = cuda_build._target(lib["source"]).name
        if lib["name"] != want:
            raise ArtifactError(f"library {lib['name']} is not what this tree's "
                                f"{lib['source']} builds ({want})")
        if not isinstance(lib.get("built"), dict):
            raise ArtifactError(f"library {lib['name']}: no build fingerprint")


def _install_library(lib: Dict[str, Any], data: bytes) -> bool:
    """Write one checked library into the build directory (atomic), with
    a sidecar holding the fingerprint it was built under; True when it was
    written, False when an identical one was there."""
    from ..ops import cuda_build
    name, sha = lib["name"], lib["sha256"]
    if _sha256(data) != sha:
        raise ArtifactError(f"library {name}: sha256 differs from the manifest's")
    dest = cuda_build.build_dir() / name
    if dest.exists() and _sha256(dest.read_bytes()) == sha:
        return False
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_bytes(data)
    dest.with_suffix(".json").write_text(json.dumps({"source": lib["source"],
                                                      **lib["built"]}))
    os.replace(tmp, dest)
    return True


def try_install(served, path: str) -> bool:
    """Check ``path`` against ``served`` and install its libraries. True on
    success (a ``compile_cache_artifact_loaded`` flight event); False on
    any failure, after a ``compile_cache_miss`` flight event with the
    reason: the caller then warms live. Never raises."""
    from ..monitor.flightrec import get_flight_recorder
    try:
        manifest = read_manifest(path)
        _verify(served, manifest)
        manifest, golden, libs = load_warmup_artifact(path)
        for lib in manifest.get("libraries", []):
            if _sha256(libs[lib["name"]]) != lib["sha256"]:
                raise ArtifactError(f"library {lib['name']}: sha256 differs from the "
                                    f"manifest's")
        written = [lib["name"] for lib in manifest.get("libraries", [])
                   if _install_library(lib, libs[lib["name"]])]
    except Exception as e:
        log.warning("compilecache: artifact %s rejected for model %r (%r): warming live",
                    path, served.name, e)
        get_flight_recorder().record("compile_cache_miss", model=served.name, artifact=path,
                                     reason=repr(e))
        return False
    served._aot = {(tuple(int(d) for d in s["shape"]), str(s["dtype"]), bool(s["masked"]))
                   for s in manifest["signatures"]}
    if served.input_shape is None and manifest.get("input_shape"):
        served.input_shape = tuple(int(d) for d in manifest["input_shape"])
    if served._golden is None:
        served._golden = golden
    get_flight_recorder().record("compile_cache_artifact_loaded", model=served.name,
                                 artifact=path, signatures=len(served._aot),
                                 libraries=len(manifest.get("libraries", [])),
                                 written=len(written))
    log.info("compilecache: model %r installed artifact %s (%d signatures, %d libraries)",
             served.name, path, len(served._aot), len(manifest.get("libraries", [])))
    return True
