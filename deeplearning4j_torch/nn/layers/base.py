"""Layer implementation protocol, registry and dtype policy.

Counterpart of ``deeplearning4j_tpu/nn/layers/base.py``. Each
implementation is an ``nn.Module`` built from its layer config; its
parameters carry the reference names (``W``, ``RW``, ``b``, ``pi`` ...)
and ``forward(x, mask=None, ctx=None)`` runs inference.

Dtype policy (``base.py:78-86``, ``:211-226`` of the JAX package):
parameters live in ``dtype`` (f32 masters); matmul operands are cast to
``compute_dtype`` (bf16 under the mixed-precision policy); activations
flow between layers in ``out_dtype`` (the compute dtype when it is
narrower than 32 bits); recurrent state and accumulations use
:func:`acc_dtype` (f32 under bf16 compute).
"""
from __future__ import annotations

from typing import Dict, Tuple, Type

import torch
from torch import nn

from ..activations import get_activation
from ..weights import init_weight

_IMPL_REGISTRY: Dict[str, Type["LayerImpl"]] = {}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    if str(name) not in _DTYPES:
        raise ValueError(f"Unknown dtype '{name}' (known: {sorted(_DTYPES)})")
    return _DTYPES[str(name)]


def acc_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """f32 when computing in a sub-32-bit dtype, else the compute dtype."""
    return torch.float32 if compute_dtype.itemsize < 4 else compute_dtype


def implements(*config_class_names):
    def deco(cls):
        for n in config_class_names:
            _IMPL_REGISTRY[n] = cls
        return cls
    return deco


def impl_for(conf, global_conf) -> "LayerImpl":
    name = type(conf).__name__
    if name not in _IMPL_REGISTRY:
        raise ValueError(f"No layer implementation registered for config '{name}'")
    return _IMPL_REGISTRY[name](conf, global_conf)


def _resolved(conf, gc, field, default=None):
    v = getattr(conf, field, None)
    if v is None:
        v = getattr(gc, field, None)
    return default if v is None else v


class LayerImpl(nn.Module):
    """Base implementation; resolves per-layer vs global config fields."""

    def __init__(self, conf, gc):
        super().__init__()
        self.conf = conf
        self.gc = gc
        self.index = None
        self.dtype = torch_dtype(gc.dtype)
        self.compute_dtype = torch_dtype(gc.compute_dtype)
        self.out_dtype = (self.compute_dtype
                          if self.compute_dtype.itemsize < 4 else self.dtype)
        self.activation_name = _resolved(conf, gc, "activation", "identity")
        self.activation = get_activation(self.activation_name)
        self.weight_init = _resolved(conf, gc, "weight_init", "xavier")
        self.dist = _resolved(conf, gc, "dist")
        self.bias_init = float(_resolved(conf, gc, "bias_init", 0.0))
        self.dropout_p = _resolved(conf, gc, "dropout")

    # ----------------------------------------------------------- parameters
    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        return {}

    def _init_w(self, gen, shape, fan_in, fan_out):
        return init_weight(gen, shape, fan_in, fan_out, self.weight_init,
                           self.dist, self.dtype)

    def set_params(self, params: Dict[str, torch.Tensor], device) -> None:
        """Install ``params`` (shape-checked against the config, cast to
        ``dtype``) on ``device``."""
        want = self.param_shapes()
        if set(params) != set(want):
            raise ValueError(f"layer {self.index} ({type(self.conf).__name__}):"
                             f" parameters {sorted(params)} do not match "
                             f"{sorted(want)}")
        for name, shape in want.items():
            t = torch.as_tensor(params[name])
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"layer {self.index} parameter '{name}': "
                                 f"shape {tuple(t.shape)}, config needs "
                                 f"{tuple(shape)}")
            self.register_parameter(name, nn.Parameter(
                t.to(device=device, dtype=self.dtype), requires_grad=False))

    def param_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.named_parameters(recurse=False)}

    def forward(self, x, mask=None, ctx=None):
        raise NotImplementedError
