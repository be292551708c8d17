"""ctypes bindings for the native host library: the gradient wire codec and
two parsers.

Counterpart of ``deeplearning4j_tpu/ops/native.py`` (the JNI seam to
libnd4j's host ops in the reference: thresholdEncode/bitmapEncode of
``EncodingHandler.java:136-178``, IDX and CSV parsing). The C++ source is
the JAX package's ``native/dl4jtpu_native.cpp``; the port compiles it at
first use, as it builds its CUDA kernels (``cuda_build.py``), with the host
compiler (``$CXX``, else ``g++``) and ``native/Makefile``'s flags, into
``build/native/`` at the repository root, named by a hash of the source
and flags. A build that fails raises: nothing falls back to numpy behind
the caller's back.

The numpy functions (``*_plain``) are the plain versions the tests and
``chip_smoke.py`` hold the library against, bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["load", "library_path", "threshold_encode", "threshold_decode",
           "bitmap_encode", "bitmap_decode", "idx_read", "csv_read_f32",
           "threshold_encode_plain", "threshold_decode_plain", "bitmap_encode_plain",
           "bitmap_decode_plain"]

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dl4jtpu_native.cpp"
BUILD_DIR = _ROOT / "build" / "native"
#: ``native/Makefile``'s CXXFLAGS, then ``-shared``
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]

_lock = threading.Lock()
_lib = None
#: seconds the last build in this process took (None: the library was
#: already built when it was first loaded)
build_seconds = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"the native host library is built at first use and needs a "
                           f"C++ compiler; {cxx!r} was not found (set CXX)")
    return path


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdl4jtpu-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    global build_seconds
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native host library failed (exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0


def load():
    """The bound library, built first if needed; a failed build raises
    with the compiler's output."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not SOURCE.exists():
            raise RuntimeError(f"native source {SOURCE} is missing")
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        i8p = ctypes.POINTER(ctypes.c_int8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.threshold_encode_f32.restype = ctypes.c_int64
        lib.threshold_encode_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_float,
                                             i32p, i8p, f32p]
        lib.threshold_decode_f32.restype = None
        lib.threshold_decode_f32.argtypes = [i32p, i8p, ctypes.c_int64,
                                             ctypes.c_float, f32p, ctypes.c_int64]
        lib.bitmap_encode_f32.restype = ctypes.c_int64
        lib.bitmap_encode_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_float,
                                          u32p, f32p]
        lib.bitmap_decode_f32.restype = None
        lib.bitmap_decode_f32.argtypes = [u32p, ctypes.c_int64, ctypes.c_float, f32p]
        lib.idx_read_header.restype = ctypes.c_int
        lib.idx_read_header.argtypes = [ctypes.c_char_p, i32p, i32p, i64p]
        lib.idx_read_u8.restype = ctypes.c_int
        lib.idx_read_u8.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int64]
        lib.csv_parse_f32.restype = ctypes.c_int64
        lib.csv_parse_f32.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                      ctypes.c_int64, f32p, ctypes.c_int64, i64p]
        _lib = lib
        return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# ------------------------------------------------------------ gradient codec
def threshold_encode_plain(grad: np.ndarray, threshold: float
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(int32 indices of |g| >= threshold, int8 signs, residual): numpy."""
    grad = np.asarray(grad, np.float32)
    g = np.ascontiguousarray(grad).ravel()
    idx = np.flatnonzero(np.abs(g) >= threshold).astype(np.int32)
    signs = np.sign(g[idx]).astype(np.int8)
    residual = g.copy()
    residual[idx] -= signs.astype(np.float32) * np.float32(threshold)
    return idx, signs, residual.reshape(grad.shape)


def threshold_decode_plain(idx, signs, threshold: float, shape) -> np.ndarray:
    n = int(np.prod(shape))
    out = np.zeros(n, np.float32)
    out[np.asarray(idx, np.int64)] = np.asarray(signs).astype(np.float32) * np.float32(threshold)
    return out.reshape(shape)


def bitmap_encode_plain(grad: np.ndarray, threshold: float
                        ) -> Tuple[np.ndarray, int, np.ndarray]:
    """(u32 words, 2 bits an element: 1 = +threshold, 2 = -threshold; the
    count of nonzero codes; residual): numpy."""
    grad = np.asarray(grad, np.float32)
    g = np.ascontiguousarray(grad).ravel()
    thr = np.float32(threshold)
    words = (g.size + 15) // 16
    pos = g >= thr
    neg = g <= -thr
    codes = np.zeros(words * 16, np.uint32)
    codes[:g.size] = np.where(pos, 1, np.where(neg, 2, 0))
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    # each code owns its two bits of the word, so the sum is the bitwise or
    bitmap = (codes.reshape(words, 16) << shifts).sum(axis=1, dtype=np.uint64).astype(np.uint32)
    residual = g.copy()
    residual[pos] -= thr
    residual[neg] += thr
    return bitmap, int(pos.sum() + neg.sum()), residual.reshape(grad.shape)


def bitmap_decode_plain(bitmap: np.ndarray, n: int, threshold: float) -> np.ndarray:
    bitmap = np.asarray(bitmap, np.uint32)
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    codes = ((bitmap[:, None] >> shifts) & 3).ravel()[:n]
    thr = np.float32(threshold)
    return np.where(codes == 1, thr, np.where(codes == 2, -thr, np.float32(0))).astype(np.float32)


def threshold_encode(grad: np.ndarray, threshold: float
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indices, signs, residual) through the library."""
    lib = load()
    grad = np.asarray(grad, np.float32)
    g = np.ascontiguousarray(grad).ravel()
    idx = np.empty(g.size, np.int32)
    signs = np.empty(g.size, np.int8)
    residual = np.empty(g.size, np.float32)
    k = lib.threshold_encode_f32(_ptr(g, ctypes.c_float), g.size, ctypes.c_float(threshold),
                                 _ptr(idx, ctypes.c_int32), _ptr(signs, ctypes.c_int8),
                                 _ptr(residual, ctypes.c_float))
    return idx[:k].copy(), signs[:k].copy(), residual.reshape(grad.shape)


def threshold_decode(idx: np.ndarray, signs: np.ndarray, threshold: float,
                     shape) -> np.ndarray:
    lib = load()
    n = int(np.prod(shape))
    idx = np.ascontiguousarray(idx, np.int32)
    signs = np.ascontiguousarray(signs, np.int8)
    out = np.empty(n, np.float32)
    lib.threshold_decode_f32(_ptr(idx, ctypes.c_int32), _ptr(signs, ctypes.c_int8), idx.size,
                             ctypes.c_float(threshold), _ptr(out, ctypes.c_float), n)
    return out.reshape(shape)


def bitmap_encode(grad: np.ndarray, threshold: float
                  ) -> Tuple[np.ndarray, int, np.ndarray]:
    """(bitmap u32 words, nonzero count, residual): the 2 bits an element
    wire format (reference bitmapEncode), through the library."""
    lib = load()
    grad = np.asarray(grad, np.float32)
    g = np.ascontiguousarray(grad).ravel()
    bitmap = np.empty((g.size + 15) // 16, np.uint32)
    residual = np.empty(g.size, np.float32)
    k = lib.bitmap_encode_f32(_ptr(g, ctypes.c_float), g.size, ctypes.c_float(threshold),
                              _ptr(bitmap, ctypes.c_uint32), _ptr(residual, ctypes.c_float))
    return bitmap, int(k), residual.reshape(grad.shape)


def bitmap_decode(bitmap: np.ndarray, n: int, threshold: float) -> np.ndarray:
    lib = load()
    bitmap = np.ascontiguousarray(bitmap, np.uint32)
    out = np.empty(n, np.float32)
    lib.bitmap_decode_f32(_ptr(bitmap, ctypes.c_uint32), n, ctypes.c_float(threshold),
                          _ptr(out, ctypes.c_float))
    return out


# ------------------------------------------------------------------- parsers
def idx_read(path: str) -> Optional[np.ndarray]:
    """An uncompressed u8 IDX file through the library; None for a gz
    file or another element type (the caller's Python parser reads
    those)."""
    lib = load()
    if path.endswith(".gz"):
        return None
    dtype_code = ctypes.c_int32()
    ndim = ctypes.c_int32()
    dims = (ctypes.c_int64 * 8)()
    rc = lib.idx_read_header(path.encode(), ctypes.byref(dtype_code), ctypes.byref(ndim), dims)
    if rc != 0 or dtype_code.value != 0x08:
        return None
    shape = tuple(dims[i] for i in range(ndim.value))
    out = np.empty(int(np.prod(shape)), np.uint8)
    if lib.idx_read_u8(path.encode(), _ptr(out, ctypes.c_uint8), out.size) != 0:
        return None
    return out.reshape(shape)


def csv_read_f32(path: str, delimiter: str = ",", skip_lines: int = 0) -> Optional[np.ndarray]:
    """A float CSV as [rows, cols] through the library; None when a field
    is not numeric."""
    lib = load()
    cols = ctypes.c_int64()
    rows = lib.csv_parse_f32(path.encode(), ctypes.c_char(delimiter.encode()), skip_lines,
                             None, 0, ctypes.byref(cols))
    if rows < 0:
        return None
    out = np.empty(rows * cols.value, np.float32)
    rows2 = lib.csv_parse_f32(path.encode(), ctypes.c_char(delimiter.encode()), skip_lines,
                              _ptr(out, ctypes.c_float), out.size, ctypes.byref(cols))
    if rows2 != rows:
        return None
    return out.reshape(rows, cols.value)
