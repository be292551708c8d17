"""Gradient accumulation and Strom-style threshold encoding.

Counterpart of ``deeplearning4j_tpu/parallel/accumulation.py`` (reference
``optimize/solvers/accumulation/``: ``EncodedGradientsAccumulator.java:33``
with ``EncodingHandler.java:136-178``, adaptive threshold, residual kept in
the accumulator). Inside a mesh the slots' gradients are summed in
process (``sharding.py``), so the accumulator is the seam for updates that
cross a host boundary, encoded as the reference's wire format. The codec
runs in the native host library (``ops/native.py``: the C++ of
``native/``, built at first use), where the JAX package's runs when its
library is built.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import native as _native
from ..utils.trees import nest, sorted_leaves


def threshold_encode(grad: np.ndarray, threshold: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Sparsify: indices where |g| >= threshold, values quantized to
    ±threshold (the reference's 1-bit-per-significant-element scheme;
    ``EncodingHandler.java:136``). Returns (int32 indices, int8 signs)."""
    idx, signs, _ = _native.threshold_encode(np.asarray(grad, np.float32), threshold)
    return idx, signs


def threshold_decode(idx: np.ndarray, signs: np.ndarray, threshold: float,
                     shape) -> np.ndarray:
    """Densify an encoded update (reference ``thresholdDecode``).

    ``signs`` is normally the int8 ±1 vector of a quantized frame; a
    float32 ``signs`` array is an *exact* frame (lossless accumulator,
    threshold 0) carrying the raw values."""
    signs = np.asarray(signs)
    if signs.dtype == np.float32:
        out = np.zeros(int(np.prod(shape)) if shape else 1, np.float32)
        out[np.asarray(idx, np.int64)] = signs
        return out.reshape(shape)
    return _native.threshold_decode(idx, signs, threshold, shape)


def encode_residual(grad: np.ndarray, threshold: float
                    ) -> Tuple[Tuple[np.ndarray, np.ndarray], np.ndarray]:
    """Encode and return the residual kept locally for the next round
    (reference keeps sub-threshold mass in the accumulator)."""
    idx, signs, residual = _native.threshold_encode(np.asarray(grad, np.float32), threshold)
    return (idx, signs), residual


class EncodingHandler:
    """Adaptive threshold controller (reference ``EncodingHandler``): the
    threshold shrinks when too little of the update is transmitted and grows
    when the encoding gets dense, targeting ``target_sparsity``."""

    def __init__(self, initial_threshold: float = 1e-3,
                 min_threshold: float = 1e-5,
                 target_sparsity: float = 1e-2,
                 adaptation: float = 1.2):
        self.threshold = float(initial_threshold)
        self.min_threshold = float(min_threshold)
        self.target_sparsity = float(target_sparsity)
        self.adaptation = float(adaptation)
        self.iterations = 0

    def encode(self, grad: np.ndarray):
        used = self.threshold  # adaptation applies to the NEXT round
        (idx, signs), residual = encode_residual(grad, used)
        density = len(idx) / max(grad.size, 1)
        if density > 2 * self.target_sparsity:
            self.threshold *= self.adaptation
        elif density < 0.5 * self.target_sparsity:
            self.threshold = max(self.threshold / self.adaptation,
                                 self.min_threshold)
        self.iterations += 1
        return (idx, signs, used), residual


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def flatten_tree_f32(tree):
    """The one tree -> flat-f32 layout of everything that crosses the
    update wire: the leaves in sorted key order (the JAX package's pytree
    order), each raveled as float32. Returns ``(vec, paths, shapes)``."""
    items = sorted_leaves(tree)
    paths = [p for p, _ in items]
    shapes = [tuple(t.shape) for _, t in items]
    if not items:
        return np.zeros(0, np.float32), paths, shapes
    vec = np.concatenate([_host(t).ravel() for _, t in items])
    return vec, paths, shapes


class GradientsAccumulator:
    """SPI seam (reference ``GradientsAccumulator``): receives local updates,
    hands back the aggregate to apply. The base implementation is the
    identity (the slots' reduction happens inside the step)."""

    def store_update(self, grads):
        return grads

    storeUpdate = store_update

    def apply_update(self, grads):
        return grads

    applyUpdate = apply_update

    def reset(self):
        pass


class EncodedGradientsAccumulator(GradientsAccumulator):
    """Host-side residual accumulator (reference
    ``EncodedGradientsAccumulator``): each ``store_update`` call
    threshold-encodes the *flattened* update vector (the reference encodes
    the flat param-view buffer, not per-layer tensors), keeps the residual,
    and returns the decoded (quantized) update as a tree of numpy arrays:
    what a peer would apply after receiving the wire bytes. Updates may be
    tensors on any device or arrays.
    """

    def __init__(self, initial_threshold: float = 1e-3, **handler_kw):
        self._handler_kw = dict(initial_threshold=initial_threshold,
                                **handler_kw)
        self._handler = EncodingHandler(**self._handler_kw)
        self._residual: Optional[np.ndarray] = None
        self._treedef = None
        self._shapes = None
        self.last_encoded = None  # (idx, signs, threshold, n) — wire form

    def _flatten(self, grads) -> np.ndarray:
        vec, self._treedef, self._shapes = flatten_tree_f32(grads)
        return vec

    def _unflatten(self, flat: np.ndarray):
        out = []
        off = 0
        for shp in self._shapes:
            n = int(np.prod(shp)) if shp else 1
            out.append(flat[off:off + n].reshape(shp))
            off += n
        return nest(dict(zip(self._treedef, out)))

    @property
    def lossless(self) -> bool:
        """True when the codec is exact: threshold 0 encodes the raw f32
        values, so decode(encode(g)) == g and the residual stays empty."""
        return self._handler.threshold <= 0.0

    @property
    def has_residual(self) -> bool:
        """True when reinjected/sub-threshold mass is pending — the next
        ``store_update`` will fold it in, so the stored update is NOT equal
        to the incoming gradient alone."""
        return self._residual is not None and bool(np.any(self._residual))

    def store_update(self, grads):
        g = self._flatten(grads)
        if self._residual is not None:
            g = g + self._residual
        if self._handler.threshold <= 0.0:
            # lossless fast path: an *exact* frame (f32 values instead of
            # int8 signs) — decode is the identity, nothing stays behind
            idx = np.flatnonzero(g).astype(np.int32)
            self._residual = None
            self._handler.iterations += 1
            self.last_encoded = (idx, np.ascontiguousarray(g[idx]),
                                 0.0, g.size)
            return self._unflatten(g)
        (idx, signs, thr), residual = self._handler.encode(g)
        self._residual = residual
        self.last_encoded = (idx, signs, thr, g.size)
        return self._unflatten(threshold_decode(idx, signs, thr, (g.size,)))

    storeUpdate = store_update

    def reinject(self, dense_update: np.ndarray):
        """Return un-deliverable quantized mass to the residual: a sharded
        push that lost a shard server hands the dead shard's DECODED update
        back here, so the next ``store_update`` re-encodes it — supra- and
        sub-threshold mass alike is never lost to a down server (the same
        never-lose-mass rule the residual already guarantees)."""
        d = np.asarray(dense_update, np.float32)
        self._residual = (d.copy() if self._residual is None
                          else self._residual + d)

    def encoded_bytes(self) -> int:
        """Wire size of the last encoding (index + sign bytes)."""
        if not self.last_encoded:
            return 0
        idx, signs, _, _ = self.last_encoded
        return idx.nbytes + signs.nbytes

    # ------------------------------------------------------------- wire form
    def serialize_last(self) -> bytes:
        """Wire bytes of the last encoding (the reference's
        ``SilentUpdatesMessage`` payload)."""
        if self.last_encoded is None:
            raise ValueError("no update stored yet")
        return serialize_encoded(self.last_encoded)

    serializeLast = serialize_last

    def decode_payload(self, data: bytes):
        """Decode a peer's wire bytes into an update pytree shaped like the
        last stored update (reference ``SilentTrainingDriver`` applying a
        received ``SilentUpdatesMessage``)."""
        idx, signs, thr, n = deserialize_encoded(data)
        return self._unflatten(threshold_decode(idx, signs, thr, (n,)))

    decodePayload = decode_payload

    def reset(self):
        self._residual = None
        # fresh handler: the adaptive threshold returns to initial_threshold,
        # matching a newly constructed accumulator
        self._handler = EncodingHandler(**self._handler_kw)
        self.last_encoded = None


# ------------------------------------------------------------------ wire I/O
_WIRE_MAGIC = 0x444C3454        # "DL4T" — quantized frame (int8 signs)
_WIRE_MAGIC_EXACT = 0x444C3458  # "DL4X" — exact frame (f32 values)


def serialize_encoded(encoded) -> bytes:
    """Pack (idx, signs, threshold, n) into the wire frame: little-endian
    header [magic u32, n u64, k u64, threshold f32] + idx i32[k] + signs
    i8[k] — the Aeron-free counterpart of the reference's
    ``SilentUpdatesMessage`` (``networking/messages/SilentUpdatesMessage.java``).
    Float32 ``signs`` mark an *exact* frame (lossless accumulator): the
    payload carries f32 values under ``_WIRE_MAGIC_EXACT`` instead."""
    idx, signs, thr, n = encoded
    idx = np.ascontiguousarray(idx, np.int32)
    signs = np.asarray(signs)
    exact = signs.dtype == np.float32
    signs = np.ascontiguousarray(signs,
                                 np.float32 if exact else np.int8)
    header = np.zeros(6, np.uint32)
    header[0] = _WIRE_MAGIC_EXACT if exact else _WIRE_MAGIC
    header[1] = n & 0xFFFFFFFF
    header[2] = n >> 32
    header[3] = idx.size & 0xFFFFFFFF
    header[4] = idx.size >> 32
    header[5] = np.float32(thr).view(np.uint32)
    return header.tobytes() + idx.tobytes() + signs.tobytes()


def deserialize_encoded(data: bytes):
    header = np.frombuffer(data[:24], np.uint32)
    if int(header[0]) not in (_WIRE_MAGIC, _WIRE_MAGIC_EXACT):
        raise ValueError("bad wire frame")
    n = int(header[1]) | (int(header[2]) << 32)
    k = int(header[3]) | (int(header[4]) << 32)
    thr = float(header[5:6].view(np.float32)[0])
    idx = np.frombuffer(data[24:24 + 4 * k], np.int32)
    if int(header[0]) == _WIRE_MAGIC_EXACT:
        signs = np.frombuffer(data[24 + 4 * k:24 + 8 * k], np.float32)
    else:
        signs = np.frombuffer(data[24 + 4 * k:24 + 5 * k], np.int8)
    return idx, signs, thr, n
