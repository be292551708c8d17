"""The mesh substrate: one place that builds, validates and describes the
slot grids every parallelism style in ``parallel/`` runs on.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. PyTorch has no
SPMD partitioner and no ``shard_map``, so a mesh here is an ordered grid
of *slots*, each a :class:`torch.device`, driven from one process (as the
reference's ParallelWrapper drives its cards from worker threads). A slot
holds its shard of the batch, of the sequence, or of a parameter and its
updater state; the collectives between slots are in-process tensor
operations in a fixed rank order (``sharding.py``: sum and mean, the
split and gather of a sharded tensor; ``sequence.py``: the ring's
rotation and the all-to-all's split-and-concatenate).

By default a mesh spans every visible card, as ``jax.devices()`` spans
every device. ``devices=`` may repeat a device: eight ``"cpu"`` slots are
the counterpart of the JAX suite's eight virtual CPU devices, and several
slots on ``cuda:0`` put a mesh on a one-card machine.

Axis conventions, MeshSpec's auto-factorisation and its loud validation,
the partition-spec machinery (:class:`P` in place of ``PartitionSpec``,
:class:`Sharding` in place of ``NamedSharding``: a spec names, per
dimension, the mesh axis that splits it) and the active-topology registry
(:func:`record_step`, :func:`mesh_block`) are the JAX module's.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPELINE_AXIS = "pipe"
SEQUENCE_AXIS = "sequence"
EXPERT_AXIS = "expert"

#: canonical axis order — MeshSpec sorts nothing, but docs and the
#: auto-factoriser's "earlier axes get bigger extents" rule follow it
CANONICAL_AXES = (DATA_AXIS, MODEL_AXIS, PIPELINE_AXIS, SEQUENCE_AXIS, EXPERT_AXIS)


def _prime_factors(n: int):
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


def auto_factor(n: int, k: int):
    """Factorise ``n`` slots into ``k`` near-balanced extents,
    deterministically: prime factors (largest first) go to the currently
    smallest extent, then the extents are ordered largest-first (8 over 2
    axes -> (4, 2); 12 -> (4, 3); 8 over 3 -> (2, 2, 2))."""
    ext = [1] * k
    for f in _prime_factors(n):
        i = min(range(k), key=lambda j: (ext[j], j))
        ext[i] *= f
    return tuple(sorted(ext, reverse=True))


def default_devices():
    """Every visible card, in index order (the counterpart of
    ``jax.devices()``); raises without one: a CPU mesh is asked for by
    passing ``devices=["cpu", ...]``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh spans the visible CUDA devices by default and none is "
            "available; pass devices=['cpu', ...] (a device may repeat) to "
            "build a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _as_device(d) -> torch.device:
    from .. import resolve_device
    return resolve_device(d)


class Mesh:
    """A grid of slots with named axes: ``devices`` is an object array of
    :class:`torch.device` shaped by the axis extents, ``shape`` maps each
    axis name to its extent (as ``jax.sharding.Mesh.shape``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in devices.shape)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def slots(self):
        """(coordinates, device) of every slot in rank (row-major) order."""
        return [(idx, self.devices[idx]) for idx in np.ndindex(*self.devices.shape)]

    def device_at(self, **coords) -> torch.device:
        """The slot at the given axis coordinates (0 on the axes not named)."""
        idx = tuple(int(coords.get(a, 0)) for a in self.axis_names)
        return self.devices[idx]

    def axis_devices(self, axis: str):
        """The devices along ``axis``, at coordinate 0 of every other axis:
        where a shard over ``axis`` lives."""
        return [self.device_at(**{axis: i}) for i in range(self.shape[axis])]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


class MeshSpec:
    """Declarative mesh: named axes with fixed or auto (``None``/``-1``)
    extents, resolved over a device list at :meth:`build` time. Duplicate
    axes, non-positive extents and fixed extents that do not divide or
    cover the device count raise ``ValueError`` naming the numbers."""

    def __init__(self, axes: Sequence[str] = (DATA_AXIS,),
                 shape: Optional[Sequence[Optional[int]]] = None,
                 devices: Optional[Sequence] = None):
        axes = tuple(axes)
        if not axes:
            raise ValueError("MeshSpec needs at least one axis name")
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate mesh axis names: {axes}")
        if shape is None:
            shape = (None,) * len(axes)
        shape = tuple(shape)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} names {len(shape)} extents for "
                             f"{len(axes)} axes {axes}")
        norm = []
        for ax, s in zip(axes, shape):
            if s is None or s == -1:
                norm.append(None)
            elif int(s) <= 0:
                raise ValueError(f"axis {ax!r} has non-positive extent {s}; use None "
                                 f"(or -1) for an auto-factorized extent")
            else:
                norm.append(int(s))
        self.axes = axes
        self.shape = tuple(norm)
        self.devices = None if devices is None else list(devices)

    def resolve_shape(self, n_devices: int):
        """Concrete per-axis extents over ``n_devices`` slots: fixed extents
        must divide the count; auto extents split the quotient
        near-balanced (:func:`auto_factor`, earlier axes >= later)."""
        fixed = [s for s in self.shape if s is not None]
        prod = int(np.prod(fixed)) if fixed else 1
        if n_devices % prod:
            raise ValueError(
                f"mesh axes {dict(zip(self.axes, self.shape))} need a multiple of "
                f"{prod} devices but {n_devices} are available; change the fixed "
                f"extents so their product divides {n_devices}, or pass an explicit "
                f"device subset")
        n_auto = sum(1 for s in self.shape if s is None)
        rest = n_devices // prod
        if n_auto == 0:
            if rest != 1:
                raise ValueError(
                    f"mesh shape {dict(zip(self.axes, self.shape))} covers {prod} "
                    f"devices but {n_devices} are available; mark one axis auto "
                    f"(None) to absorb the rest, or shrink the device list")
            return tuple(self.shape)
        auto = list(auto_factor(rest, n_auto))
        return tuple(s if s is not None else auto.pop(0) for s in self.shape)

    def build(self) -> Mesh:
        devices = (default_devices() if self.devices is None
                   else [_as_device(d) for d in self.devices])
        shape = self.resolve_shape(len(devices))
        grid = np.empty(len(devices), dtype=object)
        grid[:] = devices
        return Mesh(grid.reshape(shape), self.axes)

    def __repr__(self):
        return (f"MeshSpec(axes={self.axes!r}, shape={self.shape!r}, "
                f"devices={'default' if self.devices is None else len(self.devices)})")


def make_mesh(devices: Optional[Sequence] = None, axes: Sequence[str] = (DATA_AXIS,),
              shape: Optional[Sequence[Optional[int]]] = None) -> Mesh:
    """Build a mesh over ``devices`` (default: every visible card) with
    named ``axes``; ``shape`` entries of ``None``/``-1`` (and a wholly
    omitted shape) auto-factorise."""
    return MeshSpec(axes=axes, shape=shape, devices=devices).build()


def require_axes(mesh: Mesh, axes: Sequence[str], style: str = "step"):
    """Loudly verify ``mesh`` carries every named axis."""
    missing = [a for a in axes if a and a not in mesh.axis_names]
    if missing:
        raise ValueError(
            f"{style} needs mesh axis(es) {missing} but the mesh has "
            f"{tuple(mesh.axis_names)} (shape {dict(mesh.shape)}); build it with "
            f"parallel.make_mesh/MeshSpec naming those axes")
    return mesh


# ---------------------------------------------------------------- specs
class P(tuple):
    """A partition spec: per leading dimension, the mesh axis that splits
    it or ``None`` (``jax.sharding.PartitionSpec``); trailing dimensions
    not named are whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


class Sharding:
    """A spec on a mesh (``NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def __repr__(self):
        return f"Sharding({self.spec!r})"


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, P())


def batch_sharded(mesh: Mesh, axis: str = DATA_AXIS) -> Sharding:
    """Shard the leading (batch) dim across ``axis``."""
    return Sharding(mesh, P(axis))


def spec_for_path(path: str, rules: Dict[str, P]) -> P:
    """First rule whose regex matches ``path`` (replicated otherwise)."""
    for pat, spec in rules.items():
        if re.search(pat, path):
            return P() if spec is None else spec
    return P()


def clean_spec(spec: P, dims, mesh: Mesh) -> P:
    """Drop spec axes that don't divide their dim (that dim falls back to
    replication) and pad to the leaf's rank."""
    cleaned = []
    for d, s in zip(dims, tuple(spec) + (None,) * (len(dims) - len(tuple(spec)))):
        cleaned.append(None if s is None or d % mesh.shape[s] != 0 else s)
    return P(*cleaned)


def tree_map_path(fn, tree, prefix=""):
    """``fn(keypath, tensor)`` over nested dicts, tuples and lists (None
    passes); keypaths join keys and indices with "/" as the model zips
    name them (``"0/W"``, Adam's m at ``"0/W/0"``)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_map_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn, tree, *rest):
    """``fn`` on each leaf of nested dicts, tuples and lists (and the
    leaves at the same places of ``rest``); None passes."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def tree_get(tree, path: str):
    """The leaf at a "/"-joined keypath of nested dicts, tuples and lists
    (KeyError when a dict lacks a key)."""
    node = tree
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, (tuple, list)) else node[part]
    return node


def rule_shardings(params, mesh: Mesh, rules: Dict[str, P]):
    """Sharding tree for ``params`` from {path-regex: spec} rules (axes that
    don't divide a dim fall back to replication on that dim)."""
    return tree_map_path(
        lambda path, leaf: Sharding(mesh, clean_spec(spec_for_path(path, rules),
                                                     tuple(leaf.shape), mesh)), params)


def mirror_updater_shardings(params, updater_state, mesh: Mesh, rules: Dict[str, P]):
    """Updater-state leaves shaped like a parameter inherit that
    parameter's rule sharding (Adam's moments shard with their parameter);
    everything else replicates. Updater keypaths are ``layer/param/slot``
    or ``layer/param``, so the parameter name is searched among all
    trailing path segments."""
    p_flat = {}

    def note(path, leaf):
        p_flat[(path, tuple(leaf.shape))] = Sharding(
            mesh, clean_spec(spec_for_path(path, rules), tuple(leaf.shape), mesh))
    tree_map_path(note, params)

    def one(path, leaf):
        parts = path.split("/")
        shape = tuple(leaf.shape)
        for (ppath, pshape), sh in p_flat.items():
            psegs = ppath.split("/")
            if shape == pshape and parts[0] == psegs[0] and psegs[-1] in parts[1:]:
                return sh
        return Sharding(mesh, P())
    return tree_map_path(one, updater_state)


def zero_update_specs(tree, mesh: Mesh, axis: str = DATA_AXIS, base=None):
    """ZeRO sharding over the ``axis`` extent of whatever mesh is given
    (arXiv:2004.13336): each leaf shards its largest ``axis``-divisible
    dim that the ``base`` specs (e.g. tensor-parallel rules over ``model``)
    have not already claimed, ties toward the later dim; leaves with no
    free divisible dim keep their base sharding (replicated without one).
    On a 2-D ``data x model`` mesh the base specs keep the TP split and
    ZeRO rides the remaining dims over ``data``."""
    n = int(mesh.shape[axis])

    def one(x, base_sh):
        shape = tuple(x.shape)
        spec = () if base_sh is None else tuple(getattr(base_sh, "spec", base_sh))
        spec = spec + (None,) * (len(shape) - len(spec))
        best = None
        if axis not in spec:
            for d, s in enumerate(shape):
                if spec[d] is None and s >= n and s % n == 0 and (
                        best is None or s >= shape[best]):
                    best = d
        new = list(spec)
        if best is not None:
            new[best] = axis
        while new and new[-1] is None:
            new.pop()
        return Sharding(mesh, P(*new))

    if base is None:
        return tree_map(lambda x: one(x, None), tree)
    return tree_map(one, tree, base)


# ------------------------------------------------- active-topology registry
_REG_LOCK = threading.Lock()
_ACTIVE: Dict[str, Dict] = {}


def _leaf_counts(*spec_trees):
    sharded = replicated_n = 0
    for tree in spec_trees:
        if tree is None:
            continue
        for leaf in tree_leaves(tree):
            spec = getattr(leaf, "spec", leaf)
            if any(s is not None for s in tuple(spec)):
                sharded += 1
            else:
                replicated_n += 1
    return sharded, replicated_n


def record_step(style: str, mesh: Mesh, *spec_trees, zero: bool = False):
    """Register a parallel step built on ``mesh`` under a stable ``style``
    name (``wrapper/sync``, ``tensor/step``, ...): axis extents, slots,
    steps built and the sharded-vs-replicated split of the spec trees it
    was built with."""
    sharded, repl = _leaf_counts(*spec_trees)
    with _REG_LOCK:
        row = _ACTIVE.setdefault(style, {"axes": {}, "devices": 0, "steps": 0,
                                         "sharded_leaves": 0, "replicated_leaves": 0,
                                         "zero": False})
        row["axes"] = {str(a): int(mesh.shape[a]) for a in mesh.axis_names}
        row["devices"] = mesh.size
        row["steps"] += 1
        row["sharded_leaves"] = sharded
        row["replicated_leaves"] = repl
        row["zero"] = bool(zero) or row["zero"]


def mesh_block() -> Dict[str, Dict]:
    """Per-style active topology; empty until a parallel step factory runs."""
    with _REG_LOCK:
        return {style: dict(row) for style, row in sorted(_ACTIVE.items())}


def reset_mesh_registry():
    """Test hook: forget every recorded topology."""
    with _REG_LOCK:
        _ACTIVE.clear()
