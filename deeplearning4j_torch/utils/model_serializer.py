"""Read a model zip written by the JAX package into the port.

Counterpart of the restore half of ``deeplearning4j_tpu/utils/
model_serializer.py``, for both containers. The zip holds
``configuration.json`` (``{"type", "config", "iteration_count",
"epoch_count"}``, the config in the JSON of ``nn/conf/serde.py``) and
``coefficients.bin``, an ``.npz`` keyed by parameter keypath
(``"<layer>/<param>"``: ``"0/W"``, ``"1/RW"`` ... for a
MultiLayerNetwork, ``"<vertex name>/W"`` for a ComputationGraph); a
bfloat16 array is stored
as its uint16 bit pattern under ``"__bf16__" + keypath``
(``model_serializer.py:46-82``). This is how weights carry across from
the JAX package. ``updaterState.bin`` (same layout, keypaths
``"<layer>/<param>/<slot>"``, e.g. Adam's m at ``0/W/0`` and v at ``0/W/1``)
and ``iteration_count`` are read too, so a JAX checkpoint resumes training
in the port with the same updater moments and bias correction. Layer state
(``states.bin``, same layout: ``"<layer>/mean"``, ``"<layer>/var"`` of a
BatchNormalization) is read when the zip has it, so a CNN restores with its
running statistics. Writing zips is not ported yet.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, Mapping

import numpy as np
import torch

from .. import resolve_device
from ..nn.conf import ComputationGraphConfiguration, MultiLayerConfiguration
from ..nn.conf.layers import Layer
from ..nn.conf.serde import decode
from ..nn.graph import ComputationGraph
from ..nn.multilayer import MultiLayerNetwork

__all__ = ["restore_multi_layer_network", "restore_computation_graph", "params_from_numpy",
           "states_from_numpy", "updater_state_from_numpy"]

CONFIG_JSON = "configuration.json"
COEFFICIENTS_BIN = "coefficients.bin"
UPDATER_BIN = "updaterState.bin"
STATES_BIN = "states.bin"
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


def _by_layer(conf, arrays: Mapping[str, np.ndarray], what: str
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{keypath: ndarray} -> {layer key: {name: tensor}}; a keypath splits
    at its last "/"."""
    keys = _layer_keys(conf)
    out: Dict[str, Dict[str, torch.Tensor]] = {k: {} for k in keys}
    for path, t in _decoded(arrays).items():
        layer, _, name = path.rpartition("/")
        if layer not in out or not name:
            raise ValueError(f"{what} '{path}' does not name a {what} of "
                             f"one of the {len(keys)} layers")
        out[layer][name] = t
    return out


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

    state = {}
    for i, layer in net.updater_state.items():
        state[i] = {}
        for k, s in layer.items():
            state[i][k] = (tuple(one(f"{i}/{k}/{j}", x) for j, x in enumerate(s))
                           if isinstance(s, tuple) else one(f"{i}/{k}", s))
    extra = set(stored) - used
    if extra:
        raise ValueError(f"saved updater state has entries the model's updaters do not: "
                         f"{sorted(extra)}")
    return state


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
