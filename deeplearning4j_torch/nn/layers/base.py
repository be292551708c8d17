"""Layer implementation protocol, registry and dtype policy.

Counterpart of ``deeplearning4j_tpu/nn/layers/base.py``. Each
implementation is an ``nn.Module`` built from its layer config; its
trainable parameters carry the reference names (``W``, ``RW``, ``b``,
``pi`` ...), ``forward(x, mask=None, ctx=None)`` runs the layer (autograd
records it when the caller trains), and ``regularization()`` gives the
L1/L2 penalty.

Layer state (the JAX package's ``state`` pytree: BatchNormalization's
running mean and var) lives in buffers, never in parameters, so neither
the updater nor autograd sees it: ``init_state``/``set_state`` make and
install it, ``layer_state()`` reads it as ``{name: tensor}``. A training
forward (``ctx["train"]``) computes the new state and, when the container
passes a ``ctx["new_states"]`` dict, leaves it there under the layer's
index; the container commits it (``commit_state``) only after a fit
step's update, so ``score(training=True)`` and
``compute_gradient_and_score`` use batch statistics but change nothing,
as in the JAX package.

Regularisation in training (``nn/conf/dropout.py``): ``maybe_dropout``
applies the layer's input dropout, ``noised_forward`` runs the forward on
weight-noised parameters (``torch.func.functional_call``, so autograd
reaches the parameters through the noise), and the containers project
``constraints`` after each update. Each draws from the layer's
``torch.Generator`` for the step (``ctx["rng"]``, split per layer by the
container); with none (inference, ``score``, the gradient check) every
one of them is the identity, as with ``rng=None`` in the JAX package.

Remat (``GlobalConfig.remat``, :func:`remat_enabled`): a training step
runs the forward in checkpointed regions (:func:`checkpointed`), each from
the outputs of layers with ``save_output`` (convolutions, GEMMs, pooling,
recurrent and attention layers; JAX's ``"dl4j_act"`` names) up to the next
such output, so the backward keeps only those outputs (and every graph
vertex's) and recomputes the rest, the kernels' reserves and flash o/lse
included. A region's draws replay from the generators' states taken
before its first run (:func:`generator_state`, :func:`replay_generator`).

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
from torch.utils.checkpoint import checkpoint

from ..activations import get_activation
from ..conf.dropout import draw_seed, resolve_dropout
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


class StepGenerators:
    """One training forward's per-layer streams, the JAX package's
    ``jax.random.split(rng, n)``: one seed drawn from the step's generator,
    and the k-th layer's generator (a CPU ``torch.Generator``) seeded from
    it and k, made only for a layer that draws. Without a step generator
    every layer gets None."""

    def __init__(self, gen):
        self._seed = None if gen is None else draw_seed(gen)
        self._k = 0

    def next(self, impl):
        """The generator of the next layer of the forward (None when it
        draws nothing or outside training)."""
        self._k += 1
        if self._seed is None or not impl.draws():
            return None
        return torch.Generator().manual_seed(self._seed * 65536 + self._k)


def split_generator(gen):
    """Two generators seeded from ``gen`` in turn (the JAX package's
    ``jax.random.split`` of one layer's key); two Nones for None."""
    if gen is None:
        return None, None
    return tuple(torch.Generator().manual_seed(draw_seed(gen)) for _ in range(2))


def remat_enabled(gc, impls) -> bool:
    """Whether a training step runs under remat (``GlobalConfig.remat``,
    the JAX package's ``remat_enabled``): always on "on"; on "auto" only for
    a convolutional net without a layer that carries a recurrent state
    through its training forward (an attention layer's KV cache does not
    count, ``scan_free_training``). Wrappers are looked through (``inner``,
    a Bidirectional's ``fwd``), so a wrapped LSTM still counts."""
    mode = getattr(gc, "remat", "off")
    if mode == "on":
        return True
    if mode != "auto":
        return False
    flat = []
    for impl in impls:
        while impl is not None:
            flat.append(impl)
            impl = getattr(impl, "inner", None) or getattr(impl, "fwd", None)
    has_conv = any(getattr(j.conf, "kernel_size", None) is not None for j in flat)
    has_rnn = any(hasattr(j, "init_stream_state")
                  and not getattr(j, "scan_free_training", False) for j in flat)
    return has_conv and not has_rnn


def generator_state(gen):
    """The state of a CPU generator (None for None), to replay its draws."""
    return None if gen is None else gen.get_state()


def replay_generator(state):
    """A fresh generator at ``state`` (None for None): the same draws each
    time a checkpointed region runs."""
    if state is None:
        return None
    gen = torch.Generator()
    gen.set_state(state)
    return gen


#: forward-context entries that a region hands out on its first run only
_REGION_OUTPUTS = ("new_states", "rnn_state_out", "aux_loss")


def checkpointed(fn, ctx, *args):
    """``fn(c, first, *args)`` under ``torch.utils.checkpoint``
    (non-reentrant): autograd keeps ``args`` and what ``fn`` returns, and
    the backward runs ``fn`` again for everything else it needs. ``c`` is
    a copy of the forward context ``ctx`` as it stood before the first run,
    so a recompute sees the same context; what the first run (``first``)
    leaves in it goes back to ``ctx``: new layer state, recurrent carries,
    auxiliary losses and the preprocessors' notes. A recompute's go
    nowhere, so state is committed once, from the first forward."""
    start = {k: v for k, v in ctx.items() if k not in _REGION_OUTPUTS}
    runs = []

    def region(*a):
        first = not runs
        runs.append(1)
        c = dict(start)
        if "new_states" in ctx:
            c["new_states"] = {}
        out = fn(c, first, *a)
        if first:
            c.pop("rng", None)
            for k, v in c.items():
                if k == "new_states":
                    ctx[k].update(v)
                elif k == "rnn_state_out":
                    ctx.setdefault(k, {}).update(v)
                elif k == "aux_loss":
                    ctx[k] = ctx.get(k, 0.0) + v
                else:
                    ctx[k] = v
        return out

    return checkpoint(region, *args, use_reentrant=False)


def train_rng(ctx):
    """(training?, the layer's generator) from a forward's ``ctx``."""
    ctx = ctx or {}
    return ctx.get("train", False), ctx.get("rng")


def _is_bias_key(k: str) -> bool:
    return k == "b" or k.endswith("_b") or k == "beta"


def _resolved(conf, gc, field, default=None):
    v = getattr(conf, field, None)
    if v is None:
        v = getattr(gc, field, None)
    return default if v is None else v


class LayerImpl(nn.Module):
    """Base implementation; resolves per-layer vs global config fields."""

    #: under remat the step keeps this layer's output (convolutions, GEMMs,
    #: pooling ...); layers that set it False (elementwise ones, the
    #: normalizations, padding and cropping) are recomputed in the backward
    save_output = True

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
        self.l1 = float(_resolved(conf, gc, "l1", 0.0))
        self.l2 = float(_resolved(conf, gc, "l2", 0.0))
        self.l1_bias = float(_resolved(conf, gc, "l1_bias", 0.0))
        self.l2_bias = float(_resolved(conf, gc, "l2_bias", 0.0))
        # float (retain probability) or a dropout object -> one apply() object
        self.dropout_obj = resolve_dropout(_resolved(conf, gc, "dropout"))
        self.weight_noise = getattr(conf, "weight_noise", None)
        self.constraints = getattr(conf, "constraints", None)

    def draws(self) -> bool:
        """Whether a training forward of this layer draws random numbers
        (the container makes its generator only then)."""
        return self.dropout_obj is not None or self.weight_noise is not None

    def maybe_dropout(self, x, train, gen):
        """Input dropout or noise in training (reference
        ``BaseLayer.preOutput``); the identity otherwise."""
        if self.dropout_obj is None or not train or gen is None:
            return x
        return self.dropout_obj.apply(x, gen, train)

    def noised_params(self, params, train, gen):
        """``params`` with this forward's weight noise (DropConnect,
        WeightNoise), drawn in sorted key order, the order the JAX
        package's jitted step sees a layer's parameters in; ``params``
        itself when none applies."""
        wn = self.weight_noise
        if wn is None or not train or gen is None or not params:
            return params
        return {k: wn.apply_to_weights(params[k], k, gen, train) for k in sorted(params)}

    def noised_forward(self, x, mask, ctx):
        """The forward, on weight-noised parameters when ``ctx`` trains with
        a generator: the noised tensors stand in for the parameters
        (``functional_call``), so a kernel receives them and autograd
        carries their gradients back through the noise (a DropConnect
        mask included)."""
        params = self.param_dict()
        noised = self.noised_params(params, ctx.get("train", False), ctx.get("rng"))
        if noised is params:
            return self(x, mask=mask, ctx=ctx)
        return torch.func.functional_call(self, noised, (x,), {"mask": mask, "ctx": ctx})

    # ----------------------------------------------------------- parameters
    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        return {}

    def _init_w(self, gen, shape, fan_in, fan_out):
        return init_weight(gen, shape, fan_in, fan_out, self.weight_init,
                           self.dist, self.dtype)

    def set_params(self, params: Dict[str, torch.Tensor], device) -> None:
        """Install copies of ``params`` (shape-checked against the config,
        cast to ``dtype``) on ``device`` as trainable parameters."""
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
                t.detach().to(device=device, dtype=self.dtype).clone()))

    def param_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.named_parameters(recurse=False)}

    # ---------------------------------------------------------------- state
    def init_state(self) -> Dict[str, torch.Tensor]:
        """The layer's initial state, {} for a stateless layer."""
        return {}

    def set_state(self, state: Dict[str, torch.Tensor], device) -> None:
        """Install copies of ``state`` (the names and shapes of
        :meth:`init_state`, cast to its dtypes) on ``device`` as buffers."""
        want = self.init_state()
        if set(state) != set(want):
            raise ValueError(f"layer {self.index} ({type(self.conf).__name__}): state "
                             f"{sorted(state)} does not match {sorted(want)}")
        for name, like in want.items():
            t = torch.as_tensor(state[name])
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"layer {self.index} state '{name}': shape "
                                 f"{tuple(t.shape)}, config needs {tuple(like.shape)}")
            self.register_buffer(name, t.detach().to(device=device, dtype=like.dtype).clone())

    def layer_state(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers(recurse=False))

    def commit_state(self, new_state: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for name, t in new_state.items():
                getattr(self, name).copy_(t)

    def constraint_sets(self):
        """(constraints, {name: parameter}) pairs that the container
        projects after each update: this layer's constraints on its own
        parameters (a wrapper gives its inner layers')."""
        return [(self.constraints, self.param_dict())] if self.constraints else []

    def regularization(self):
        """L1/L2 penalty (reference ``BaseLayer.calcL1/calcL2``), weights and
        biases with their own coefficients; 0.0 when none is set."""
        total = 0.0
        for k, v in self.param_dict().items():
            l1, l2 = (self.l1_bias, self.l2_bias) if _is_bias_key(k) else (self.l1, self.l2)
            if l1:
                total = total + l1 * v.abs().sum()
            if l2:
                total = total + 0.5 * l2 * (v * v).sum()
        return total

    def forward(self, x, mask=None, ctx=None):
        raise NotImplementedError
