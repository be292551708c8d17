"""ModelGuesser: load a model or a configuration without knowing its kind.

Counterpart of ``deeplearning4j_tpu/utils/model_guesser.py`` (reference
``ModelGuesser.java``). The format is sniffed from the file's magic bytes
first: a zip (``PK``) is a model zip of either container, restored by
``model_serializer.restore_model``; anything else but HDF5 is read as a
bare configuration JSON and becomes a freshly initialised network. Keras
HDF5 import is not ported: an HDF5 file raises rather than being guessed
at.
"""
from __future__ import annotations

import json

from .. import resolve_device
from ..nn.conf import ComputationGraphConfiguration, MultiLayerConfiguration
from ..nn.graph import ComputationGraph
from ..nn.multilayer import MultiLayerNetwork
from . import model_serializer

__all__ = ["ModelGuesser", "load_model_guess", "load_config_guess", "load_normalizer"]

_ZIP_MAGIC = b"PK"
_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


def _magic(path, n: int = 8) -> bytes:
    with open(path, "rb") as fh:
        return fh.read(n)


def load_model_guess(path, load_updater: bool = True, device="cuda"):
    """A network from ``path`` on ``device`` (the card unless
    ``device="cpu"``): a model zip of either container (with its updater
    state when ``load_updater``), or a bare configuration JSON (a fresh
    ``init()`` from the config's seed)."""
    dev = resolve_device(device)
    head = _magic(path)
    if head.startswith(_ZIP_MAGIC):
        return model_serializer.restore_model(path, dev, load_updater)
    if head.startswith(_HDF5_MAGIC):
        raise NotImplementedError(f"{path} is HDF5: Keras model import is not ported to "
                                  f"deeplearning4j_torch yet")
    conf = load_config_guess(path)
    if isinstance(conf, MultiLayerConfiguration):
        return MultiLayerNetwork(conf).init(device=dev)
    return ComputationGraph(conf).init(device=dev)


def load_config_guess(path):
    """A network configuration from a JSON file: a MultiLayerConfiguration,
    else a ComputationGraphConfiguration (the first that accepts wins)."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    json.loads(text)  # fail fast with a JSON error, not a serde error
    errors = []
    for cls in (MultiLayerConfiguration, ComputationGraphConfiguration):
        try:
            return cls.from_json(text)
        except (ValueError, TypeError) as e:
            errors.append(f"{cls.__name__}: {e}")
    raise ValueError("Could not interpret the JSON as either container configuration:\n"
                     + "\n".join(errors))


def load_normalizer(path):
    """The normalizer saved in the model zip at ``path``, or None."""
    return model_serializer.restore_normalizer(path)


class ModelGuesser:
    """The reference's static facade, with its camelCase names."""

    load_model_guess = loadModelGuess = staticmethod(load_model_guess)
    load_config_guess = loadConfigGuess = staticmethod(load_config_guess)
    load_normalizer = loadNormalizer = staticmethod(load_normalizer)
