"""Build the hand-written CUDA kernels with ``nvcc`` and bind them with ctypes.

Each source under ``deeplearning4j_torch/csrc/`` compiles into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes). Libraries land in ``build/torch_kernels/`` at
the repository root, or in the shared compile-cache directory once
``compilecache.enable`` (``DL4J_TPU_COMPILE_CACHE_DIR``) names one. They
are named by a hash of the sources and flags and built at first use; each
carries a ``.json`` sidecar with the toolkit fingerprint it was built
under. :func:`build_all` starts one ``nvcc`` per source at once;
:func:`library` builds (or reuses) and loads one. A library that is
already on disk is a compile-cache hit, an ``nvcc`` run a miss
(``compilecache.cache``), and :func:`recording` collects the sources a
block of code loads (the warmup artifact's library list).

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Set

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH = "sm_90a"
NVCC_FLAGS = ["-gencode", f"arch=compute_90a,code={ARCH}", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_recordings: List[Set[str]] = []
_toolkit: List[Optional[str]] = []


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return path


def toolkit_version() -> Optional[str]:
    """The ``nvcc --version`` release line, or None without a toolkit."""
    if not _toolkit:
        try:
            out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                                 timeout=60).stdout.strip().splitlines()
            _toolkit.append(next((ln for ln in out if "release" in ln), out[-1] if out else None))
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _toolkit.append(None)
    return _toolkit[0]


def fingerprint() -> Dict[str, Optional[str]]:
    """What a library was built under: toolkit, flags and architecture."""
    return {"nvcc": toolkit_version(), "flags": " ".join(NVCC_FLAGS), "arch": ARCH}


def build_dir() -> Path:
    """Where libraries are built and loaded: the compile-cache directory
    when one is enabled, else ``build/torch_kernels/``."""
    from ..compilecache.cache import cache_dir
    d = cache_dir()
    return Path(d) if d else BUILD_DIR


def _target(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh") and (p.name == source
                                            or p.suffix == ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return build_dir() / f"lib{Path(source).stem}-{h.hexdigest()[:12]}.so"


def _start(source: str):
    from ..compilecache import cache as _cc
    out = _target(source)
    if out.exists():
        _cc.note_library(hit=True)
        return None
    _cc.note_library(hit=False)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(source: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit "
                           f"{proc.returncode}):\n{log}")
    out.with_suffix(".json").write_text(json.dumps({"source": source, **fingerprint()}))
    os.replace(tmp, out)


def build_all(sources: List[str]) -> Dict[str, str]:
    """Compile every source that has no current library, all ``nvcc``
    processes started together. Returns source -> compiler log (the
    ``-Xptxas -v`` register and shared-memory report)."""
    with _lock:
        started = {s: _start(s) for s in sources}
        for s, st in started.items():
            _finish(s, st)
    return {s: _target(s).with_suffix(".log").read_text()
            if _target(s).with_suffix(".log").exists() else "" for s in sources}


def library(source: str, entry: str, argtypes) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed, with
    ``entry``'s ``argtypes`` declared (``restype`` int: a cudaError_t). A
    source may hold several entries; each is declared at its first call."""
    for used in _recordings:
        used.add(source)
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            _finish(source, _start(source))
            lib = ctypes.CDLL(str(_target(source)))
            lib.dl4j_error_string.argtypes = [ctypes.c_int]
            lib.dl4j_error_string.restype = ctypes.c_char_p
            _loaded[source] = lib
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib


@contextlib.contextmanager
def recording():
    """Collect the sources whose library :func:`library` hands out inside
    the block (every launch asks for its library)."""
    used: Set[str] = set()
    _recordings.append(used)
    try:
        yield used
    finally:
        _recordings.remove(used)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry."""
    if code != 0:
        msg = lib.dl4j_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, or NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


class Counter:
    """A kernel's launch count: each wrapper adds one where it launches
    its kernel, and nowhere else, so a run can show that the main path
    went through the kernel. Serving schedulers launch from their own
    threads, hence the lock."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.launches += 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
