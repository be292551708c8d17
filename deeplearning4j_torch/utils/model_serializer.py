"""Read a model zip written by the JAX package into the port.

Counterpart of the restore half of ``deeplearning4j_tpu/utils/
model_serializer.py``. The zip holds ``configuration.json`` (``{"type",
"config", "iteration_count", "epoch_count"}``, the config in the JSON of
``nn/conf/serde.py``) and ``coefficients.bin``, an ``.npz`` keyed by
parameter keypath (``"0/W"``, ``"1/RW"`` ...); a bfloat16 array is stored
as its uint16 bit pattern under ``"__bf16__" + keypath``
(``model_serializer.py:46-82``). This is how weights carry across from
the JAX package. Updater and layer state are not read: the port serves.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, Mapping

import numpy as np
import torch

from .. import resolve_device
from ..nn.conf import MultiLayerConfiguration
from ..nn.conf.serde import decode
from ..nn.multilayer import MultiLayerNetwork

__all__ = ["restore_multi_layer_network", "params_from_numpy"]

CONFIG_JSON = "configuration.json"
COEFFICIENTS_BIN = "coefficients.bin"
_BF16 = "__bf16__"


def _tensor(a: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).float()
    return torch.from_numpy(np.array(a))


def params_from_numpy(conf: MultiLayerConfiguration,
                      arrays: Mapping[str, np.ndarray]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{keypath: ndarray} (the npz layout) -> {"0": {"W": tensor}, ...},
    ready for ``MultiLayerNetwork(conf).init(params=...)``, which checks
    every shape against ``conf``."""
    out: Dict[str, Dict[str, torch.Tensor]] = {
        str(i): {} for i in range(len(conf.layers))}
    for key, a in arrays.items():
        bf16 = key.startswith(_BF16)
        path = key[len(_BF16):] if bf16 else key
        layer, _, name = path.partition("/")
        if layer not in out or not name or "/" in name:
            raise ValueError(f"parameter '{path}' does not name a parameter of "
                             f"one of the {len(conf.layers)} layers")
        out[layer][name] = _tensor(a, bf16)
    return out


def restore_multi_layer_network(path, device="cuda") -> MultiLayerNetwork:
    """The network saved at ``path``, on ``device`` (the card unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    with zipfile.ZipFile(path, "r") as z:
        conf_doc = json.loads(z.read(CONFIG_JSON).decode("utf-8"))
        coeff = z.read(COEFFICIENTS_BIN)
    if conf_doc.get("type") != "MultiLayerNetwork":
        raise ValueError(f"Saved model is a {conf_doc.get('type')}; the port "
                         f"restores MultiLayerNetwork only")
    conf = decode(conf_doc["config"])
    if not isinstance(conf, MultiLayerConfiguration):
        raise ValueError("configuration.json does not describe a "
                         "MultiLayerConfiguration")
    with np.load(io.BytesIO(coeff)) as npz:
        arrays = {k: npz[k] for k in npz.files}
    net = MultiLayerNetwork(conf).init(params=params_from_numpy(conf, arrays),
                                       device=dev)
    net.iteration_count = int(conf_doc.get("iteration_count", 0))
    net.epoch_count = int(conf_doc.get("epoch_count", 0))
    return net
