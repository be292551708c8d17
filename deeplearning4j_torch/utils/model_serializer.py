"""Model zips, both ways, in the JAX package's format.

Counterpart of ``deeplearning4j_tpu/utils/model_serializer.py``, for both
containers. The zip holds ``configuration.json`` (``{"type", "config",
"iteration_count", "epoch_count"}``, the config in the JSON of
``nn/conf/serde.py``) and ``coefficients.bin``, an ``.npz`` keyed by
parameter keypath (``"<layer>/<param>"``: ``"0/W"``, ``"1/RW"`` ... for a
MultiLayerNetwork, ``"<vertex name>/W"`` for a ComputationGraph); a
bfloat16 array is stored as its uint16 bit pattern under ``"__bf16__" +
keypath`` (``model_serializer.py:46-82``). ``updaterState.bin`` has the same
layout at ``"<layer>/<param>/<slot>"`` (Adam's m at ``0/W/0`` and v at
``0/W/1``), ``states.bin`` the layers' state (``"<layer>/mean"``,
``"<layer>/var"`` of a BatchNormalization), and ``normalizer.bin`` a
normalizer's JSON. A wrapper layer's parameters nest (``utils/trees.py``):
``"0/fwd/W"``, and Adam's m ``"0/fwd/W/0"``.

:func:`write_model` writes every array in the dtype the network holds it,
which is the JAX package's for the same config, so a zip written here
restores and resumes there, and JAX -> port -> JAX round-trips bit for
bit. The restore functions read the JAX package's zips (and these): the
parameters, the layer state when the zip has one, the updater state and
``iteration_count``, so that training resumes with the same moments and
bias correction. :class:`ModelSerializer` carries the reference's
camelCase names.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, Mapping

import numpy as np
import torch

from .. import resolve_device
from ..datasets.normalizers import Normalizer
from ..nn.conf import ComputationGraphConfiguration, MultiLayerConfiguration
from ..nn.conf.layers import Layer
from ..nn.conf.serde import decode, to_json
from ..nn.graph import ComputationGraph
from ..nn.multilayer import MultiLayerNetwork
from .trees import leaves, nest

__all__ = ["ModelSerializer", "write_model", "restore_model", "restore_multi_layer_network",
           "restore_computation_graph", "restore_normalizer", "params_from_numpy",
           "states_from_numpy", "updater_state_from_numpy", "tree_to_npz_bytes"]

CONFIG_JSON = "configuration.json"
COEFFICIENTS_BIN = "coefficients.bin"
UPDATER_BIN = "updaterState.bin"
STATES_BIN = "states.bin"
NORMALIZER_BIN = "normalizer.bin"
_BF16 = "__bf16__"


def _tensor(a: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).float()
    return torch.from_numpy(np.array(a))


def _decoded(arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    out = {}
    for key, a in arrays.items():
        bf16 = key.startswith(_BF16)
        out[key[len(_BF16):] if bf16 else key] = _tensor(a, bf16)
    return out


def _layer_keys(conf):
    """The parameter-dict keys of a configuration's layers: "0", "1" ... of
    a MultiLayerConfiguration, the layer vertices' names of a graph."""
    if isinstance(conf, ComputationGraphConfiguration):
        return [n for n, v in conf.vertices.items() if isinstance(v, Layer)]
    return [str(i) for i in range(len(conf.layers))]


def _split_layer(keys, path):
    """(layer key, the rest) of a keypath: the longest layer key that,
    followed by "/", starts it (a graph's vertex name may hold "/"), or
    (None, path)."""
    best = None
    for k in keys:
        if path.startswith(k + "/") and len(path) > len(k) + 1 and (
                best is None or len(k) > len(best)):
            best = k
    return (None, path) if best is None else (best, path[len(best) + 1:])


def _by_layer(conf, arrays: Mapping[str, np.ndarray], what: str
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{keypath: ndarray} -> {layer key: {name: tensor}}, a nested keypath
    ("0/fwd/W") nested ({"0": {"fwd": {"W": ...}}})."""
    keys = _layer_keys(conf)
    flat: Dict[str, Dict[str, torch.Tensor]] = {k: {} for k in keys}
    for path, t in _decoded(arrays).items():
        layer, rest = _split_layer(keys, path)
        if layer is None:
            raise ValueError(f"{what} '{path}' does not name a {what} of "
                             f"one of the {len(keys)} layers")
        flat[layer][rest] = t
    return {k: nest(v) for k, v in flat.items()}


def params_from_numpy(conf, arrays: Mapping[str, np.ndarray]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{keypath: ndarray} (the npz layout) -> {layer key: {"W": tensor}, ...}
    for a MultiLayerConfiguration or a ComputationGraphConfiguration, ready
    for ``init(params=...)`` of its container, which checks every shape
    against ``conf``."""
    return _by_layer(conf, arrays, "parameter")


def states_from_numpy(conf, arrays: Mapping[str, np.ndarray]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{keypath: ndarray} (a ``states.bin``) -> {layer key: {"mean": tensor,
    ...}}, ready for ``init(states=...)``, which checks each layer's names
    and shapes (every stateful layer's state must be there)."""
    return _by_layer(conf, arrays, "state")


def updater_state_from_numpy(net, arrays: Mapping[str, np.ndarray]):
    """{keypath: ndarray} (an ``updaterState.bin``) -> updater state shaped
    like ``net.updater_state`` of either container (per parameter: a
    tensor, or a tuple of slot
    tensors at ``"<layer>/<param>/<slot>"``), on the network's device.
    Every slot must be present with its parameter's shape; unknown keypaths
    are refused."""
    stored = _decoded(arrays)
    used = set()

    def one(path, like):
        if path not in stored:
            raise KeyError(f"saved updater state is missing '{path}'")
        t = stored[path]
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"updater state '{path}': shape {tuple(t.shape)}, model "
                             f"needs {tuple(like.shape)}")
        used.add(path)
        return t.to(device=like.device, dtype=like.dtype)

    def tree(prefix, node):
        if isinstance(node, dict):
            return {k: tree(f"{prefix}/{k}", s) for k, s in node.items()}
        if isinstance(node, tuple):
            return tuple(one(f"{prefix}/{j}", x) for j, x in enumerate(node))
        return one(prefix, node)

    state = {i: tree(i, layer) for i, layer in net.updater_state.items()}
    extra = set(stored) - used
    if extra:
        raise ValueError(f"saved updater state has entries the model's updaters do not: "
                         f"{sorted(extra)}")
    return state


def tree_to_npz_bytes(tree) -> bytes:
    """Nested dicts and tuples of tensors -> ``.npz`` bytes keyed by
    keypath, each array in its tensor's dtype (bfloat16 as its uint16 bits
    under ``"__bf16__" + keypath``)."""
    arrays = {}
    for path, t in leaves(tree):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[_BF16 + path] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[path] = t.numpy()
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def write_model(model, path, save_updater: bool = True, normalizer=None):
    """Write ``model`` (either container) to the zip at ``path``: its
    configuration with the iteration and epoch counts, parameters, layer
    state, the updater state when ``save_updater``, and ``normalizer``
    when given. Returns ``path``."""
    kind = ("MultiLayerNetwork" if isinstance(model, MultiLayerNetwork)
            else "ComputationGraph")
    conf_doc = {"type": kind, "config": json.loads(to_json(model.conf)),
                "iteration_count": int(model.iteration_count),
                "epoch_count": int(model.epoch_count)}
    # stored, not deflated: weights barely compress (a 350 MB TransformerLM
    # checkpoint deflated to 299 MB in 21.6 s on the card's host), and a
    # reader takes either
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr(CONFIG_JSON, json.dumps(conf_doc, indent=2))
        z.writestr(COEFFICIENTS_BIN, tree_to_npz_bytes(model.params))
        z.writestr(STATES_BIN, tree_to_npz_bytes(model.states))
        if save_updater and model.updater_state is not None:
            z.writestr(UPDATER_BIN, tree_to_npz_bytes(model.updater_state))
        if normalizer is not None:
            z.writestr(NORMALIZER_BIN, normalizer.to_bytes())
    return path


def _npz(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data)) as npz:
        return {k: npz[k] for k in npz.files}


def _restore(path, device, load_updater, kind, conf_cls, net_cls):
    dev = resolve_device(device)
    with zipfile.ZipFile(path, "r") as z:
        conf_doc = json.loads(z.read(CONFIG_JSON).decode("utf-8"))
        coeff = z.read(COEFFICIENTS_BIN)
        states = z.read(STATES_BIN) if STATES_BIN in z.namelist() else None
        upd = (z.read(UPDATER_BIN) if load_updater and UPDATER_BIN in z.namelist()
               else None)
    if conf_doc.get("type") != kind:
        raise ValueError(f"Saved model is a {conf_doc.get('type')}, not a {kind}")
    conf = decode(conf_doc["config"])
    if not isinstance(conf, conf_cls):
        raise ValueError(f"configuration.json does not describe a {conf_cls.__name__}")
    net = net_cls(conf).init(params=params_from_numpy(conf, _npz(coeff)), device=dev,
                             states=None if states is None
                             else states_from_numpy(conf, _npz(states)))
    if upd is not None:
        net.updater_state = updater_state_from_numpy(net, _npz(upd))
    net.iteration_count = int(conf_doc.get("iteration_count", 0))
    net.epoch_count = int(conf_doc.get("epoch_count", 0))
    return net


def restore_multi_layer_network(path, device="cuda", load_updater=True) -> MultiLayerNetwork:
    """The network saved at ``path``, on ``device`` (the card unless
    ``device="cpu"``), with its layer state when the zip has one, its
    updater state when the zip has one (and ``load_updater``) and its
    iteration and epoch counts."""
    return _restore(path, device, load_updater, "MultiLayerNetwork", MultiLayerConfiguration,
                    MultiLayerNetwork)


def restore_computation_graph(path, device="cuda", load_updater=True) -> ComputationGraph:
    """The ComputationGraph saved at ``path``, restored as
    :func:`restore_multi_layer_network` restores a MultiLayerNetwork."""
    return _restore(path, device, load_updater, "ComputationGraph",
                    ComputationGraphConfiguration, ComputationGraph)


def restore_model(path, device="cuda", load_updater=True):
    """The network saved at ``path``, of whichever container its
    ``configuration.json`` names, restored on ``device`` as
    :func:`restore_multi_layer_network` restores one."""
    dev = resolve_device(device)
    with zipfile.ZipFile(path, "r") as z:
        kind = json.loads(z.read(CONFIG_JSON).decode("utf-8")).get("type")
    if kind == "MultiLayerNetwork":
        return restore_multi_layer_network(path, dev, load_updater)
    if kind == "ComputationGraph":
        return restore_computation_graph(path, dev, load_updater)
    raise ValueError(f"Saved model is a {kind}, not a MultiLayerNetwork or a "
                     f"ComputationGraph")


def restore_normalizer(path):
    """The normalizer saved in the zip at ``path``, or None."""
    with zipfile.ZipFile(path, "r") as z:
        if NORMALIZER_BIN not in z.namelist():
            return None
        return Normalizer.from_bytes(z.read(NORMALIZER_BIN))


class ModelSerializer:
    """The reference's static facade (``ModelSerializer.java``), with its
    camelCase names."""

    write_model = writeModel = staticmethod(write_model)
    restore_model = restoreModel = staticmethod(restore_model)
    restore_multi_layer_network = restoreMultiLayerNetwork = staticmethod(
        restore_multi_layer_network)
    restore_computation_graph = restoreComputationGraph = staticmethod(
        restore_computation_graph)
    restore_normalizer = restoreNormalizer = staticmethod(restore_normalizer)
