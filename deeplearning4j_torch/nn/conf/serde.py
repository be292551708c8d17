"""JSON serde for configuration objects.

Counterpart of ``deeplearning4j_tpu/nn/conf/serde.py``, with its own
``@class`` registry: it decodes the JSON the JAX package writes
(``MultiLayerConfiguration.to_json``, the ``configuration.json`` member of
a model zip). Configs the port only carries as data (updaters, schedules,
weight distributions) decode to :class:`PlainConfig`; any other unknown
``@class`` fails loudly.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type

_REGISTRY: Dict[str, Type] = {}
_PLAIN = set()


def register(cls):
    """Class decorator: make a config dataclass JSON round-trippable."""
    _REGISTRY[cls.__name__] = cls
    return cls


def register_plain(*names: str):
    """Accept ``@class`` names whose objects the port keeps as data only."""
    _PLAIN.update(names)


@dataclasses.dataclass
class PlainConfig:
    """A config object kept as its class name and fields (an updater or a
    weight distribution: the serving slice reads none of them)."""
    kind: str
    fields: Dict[str, Any]


def encode(obj) -> Any:
    """Recursively encode dataclasses / containers into JSON-able structures."""
    if isinstance(obj, PlainConfig):
        return {"@class": obj.kind, **{k: encode(v) for k, v in obj.fields.items()}}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"@class": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = encode(getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return [encode(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): encode(v) for k, v in obj.items()}
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    raise TypeError(f"Cannot encode {type(obj)} ({obj!r}) to config JSON")


def decode(data) -> Any:
    """Inverse of :func:`encode`."""
    if isinstance(data, dict):
        if "@class" in data:
            d = dict(data)
            name = d.pop("@class")
            kwargs = {k: decode(v) for k, v in d.items()}
            if name in _PLAIN:
                return PlainConfig(name, kwargs)
            if name not in _REGISTRY:
                raise ValueError(f"Unknown config class '{name}' in JSON "
                                 f"(known: {sorted(_REGISTRY)})")
            cls = _REGISTRY[name]
            # tolerate forward-compat extra keys
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in kwargs.items() if k in names})
        return {k: decode(v) for k, v in data.items()}
    if isinstance(data, list):
        return [decode(v) for v in data]
    return data


def to_json(obj, indent=2) -> str:
    return json.dumps(encode(obj), indent=indent)


def from_json(s: str):
    return decode(json.loads(s))
