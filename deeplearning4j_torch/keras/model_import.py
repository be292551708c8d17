"""Keras model import from HDF5.

Counterpart of ``deeplearning4j_tpu/keras/model_import.py`` (reference
``deeplearning4j-modelimport``, ``KerasModelImport.java:50-233``): a
Sequential model becomes a MultiLayerNetwork, a functional model a
ComputationGraph with ``Add``/``Concatenate`` vertices. The config
translation (``KerasLayerMapper``, Keras 1 and 2/3 spellings) and the weight
layouts are the JAX package's; the network is built and initialised on
``device`` (the card unless ``device="cpu"``) and the Keras weights are then
copied onto its parameters and layer state in place, under ``no_grad``, by
keypath.

Each entry point is a thin HDF5 front end (h5py, imported when a file is
read) over a core that takes the parsed ``model_config``, the
``training_config`` and a ``{layer name: {short weight name: ndarray}}``
map, so a model whose config and arrays come from elsewhere imports the same
way.

Weight layouts (TF-backend Keras):
 - Dense kernel [in, out] is the port's "W"; after a Flatten of a
   convolutional map its rows are permuted from Keras's (h, w, c) order to
   the (c, h, w) order of ``CnnToFeedForwardPreProcessor``.
 - Conv2D kernels are HWIO, the port's layout: a straight copy.
   Depthwise and separable kernels [kh, kw, C, m] become [kh, kw, 1, C*m].
 - LSTM kernels [in, 4H] in Keras's gate order (i, f, c, o) are permuted to
   the port's (i, f, o, g=c); a ``use_bias=False`` RNN gets a zero bias
   (the port initialises the forget gate's to 1.0).
 - BatchNormalization gamma/beta are parameters (copied independently, for
   ``scale=False``/``center=False``); the moving mean and variance go into
   the layer's running-statistics buffers.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..nn.conf import NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (DenseLayer, ConvolutionLayer, SubsamplingLayer,
                              BatchNormalization, DropoutLayer, ActivationLayer,
                              EmbeddingSequenceLayer, LSTM, SimpleRnn,
                              LastTimeStep, OutputLayer, RnnOutputLayer,
                              GlobalPoolingLayer, ZeroPaddingLayer,
                              Upsampling2D, Upsampling1D, PoolingType,
                              ConvolutionMode, SeparableConvolution2D,
                              DepthwiseConvolution2D, Convolution1DLayer,
                              Subsampling1DLayer, Cropping2D, Bidirectional)
from ..nn.conf.graph import MergeVertex, ElementWiseVertex
from ..nn.graph import ComputationGraph
from ..nn.multilayer import MultiLayerNetwork
from ..utils.trees import leaves

__all__ = ["KerasModelImport", "KerasLayerMapper", "register_custom_layer",
           "registerCustomLayer"]

_ACTIVATIONS = {"relu": "relu", "softmax": "softmax", "sigmoid": "sigmoid",
                "tanh": "tanh", "linear": "identity", "elu": "elu",
                "selu": "selu", "softplus": "softplus", "softsign": "softsign",
                "hard_sigmoid": "hardsigmoid", "swish": "swish"}

_LOSSES = {"categorical_crossentropy": "mcxent",
           "sparse_categorical_crossentropy": "sparse_mcxent",
           "binary_crossentropy": "xent",
           "mean_squared_error": "mse", "mse": "mse",
           "mean_absolute_error": "mean_absolute_error", "mae":
           "mean_absolute_error",
           "kullback_leibler_divergence": "kl_divergence",
           "poisson": "poisson", "cosine_proximity": "cosine_proximity",
           "hinge": "hinge", "squared_hinge": "squared_hinge"}


def _act(name: Optional[str]) -> str:
    if not name:
        return "identity"
    key = str(name).lower()
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unsupported Keras activation '{name}'")
    return _ACTIVATIONS[key]


def _pair(v):
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


def _padding_mode(cfg) -> str:
    mode = cfg.get("padding", cfg.get("border_mode", "valid"))
    return (ConvolutionMode.Same if str(mode).lower() == "same"
            else ConvolutionMode.Truncate)


def _maybe_last_step(layer, cfg):
    """Keras ``return_sequences=False`` returns the final timestep only —
    wrap in LastTimeStep (reference ``KerasLstm`` does the same)."""
    if cfg.get("return_sequences", False):
        return layer
    return LastTimeStep(inner=layer)


#: custom-layer SPI (reference ``KerasLayer.registerCustomLayer`` +
#: ``keras/layers/custom/``): Keras class name → mapper(cfg) returning a
#: layer config; optional weight_setter(params_dict, state_dict, weights)
#: overrides the built-in weight copy for that layer.
_CUSTOM_LAYERS: Dict[str, Tuple[Any, Optional[Any]]] = {}


def register_custom_layer(class_name: str, mapper, weight_setter=None):
    """Register an importer for a custom Keras layer type. ``mapper(cfg)``
    receives the Keras config dict and returns a layer config;
    ``weight_setter(params, state, weights)`` (optional) receives the layer's
    param/state dicts and the {short name: array} weight map."""
    _CUSTOM_LAYERS[str(class_name)] = (mapper, weight_setter)


registerCustomLayer = register_custom_layer


class KerasLayerMapper:
    """Config-dict → layer-config translation (reference ``KerasLayer``
    subclasses). Keras 1 and 2 key spellings both accepted (the reference
    carries both in ``config/KerasLayerConfiguration.java:43-71``)."""

    SKIPPED = {"InputLayer", "Flatten", "Reshape"}  # handled structurally

    @staticmethod
    def map(class_name: str, cfg: Dict) -> Optional[Any]:
        if class_name in _CUSTOM_LAYERS:
            mapper, setter = _CUSTOM_LAYERS[class_name]
            layer = mapper(cfg)
            if setter is not None:
                # carried to _set_layer_weights (custom copy semantics)
                layer._keras_weight_setter = setter
            return layer
        m = getattr(KerasLayerMapper, f"_map_{class_name.lower()}", None)
        if m is None:
            raise ValueError(
                f"Unsupported Keras layer type '{class_name}' — register an "
                f"importer with register_custom_layer('{class_name}', ...)")
        return m(cfg)

    # ------------------------------------------------------------- dense etc.
    @staticmethod
    def _map_dense(cfg):
        return DenseLayer(n_out=int(cfg.get("units", cfg.get("output_dim"))),
                          activation=_act(cfg.get("activation")),
                          has_bias=bool(cfg.get("use_bias", cfg.get("bias", True))))

    @staticmethod
    def _map_dropout(cfg):
        # Keras rate = drop prob; our dropout = retain prob (reference 0.9.x)
        return DropoutLayer(dropout=1.0 - float(cfg.get("rate", cfg.get("p", 0.5))))

    @staticmethod
    def _map_activation(cfg):
        return ActivationLayer(activation=_act(cfg.get("activation")))

    @staticmethod
    def _map_conv2d(cfg):
        k = _pair(cfg.get("kernel_size",
                          (cfg.get("nb_row", 3), cfg.get("nb_col", 3))))
        return ConvolutionLayer(
            n_out=int(cfg.get("filters", cfg.get("nb_filter"))),
            kernel_size=k,
            stride=_pair(cfg.get("strides", cfg.get("subsample", (1, 1)))),
            dilation=_pair(cfg.get("dilation_rate", (1, 1))),
            convolution_mode=_padding_mode(cfg),
            activation=_act(cfg.get("activation")),
            has_bias=bool(cfg.get("use_bias", cfg.get("bias", True))))

    _map_convolution2d = _map_conv2d  # Keras 1 name

    @staticmethod
    def _map_maxpooling2d(cfg):
        return SubsamplingLayer(
            pooling_type=PoolingType.MAX,
            kernel_size=_pair(cfg.get("pool_size", (2, 2))),
            stride=_pair(cfg.get("strides") or cfg.get("pool_size", (2, 2))),
            convolution_mode=_padding_mode(cfg))

    @staticmethod
    def _map_averagepooling2d(cfg):
        return SubsamplingLayer(
            pooling_type=PoolingType.AVG,
            kernel_size=_pair(cfg.get("pool_size", (2, 2))),
            stride=_pair(cfg.get("strides") or cfg.get("pool_size", (2, 2))),
            convolution_mode=_padding_mode(cfg))

    @staticmethod
    def _map_globalmaxpooling2d(cfg):
        return GlobalPoolingLayer(pooling_type=PoolingType.MAX)

    @staticmethod
    def _map_globalaveragepooling2d(cfg):
        return GlobalPoolingLayer(pooling_type=PoolingType.AVG)

    @staticmethod
    def _map_globalmaxpooling1d(cfg):
        return GlobalPoolingLayer(pooling_type=PoolingType.MAX)

    @staticmethod
    def _map_globalaveragepooling1d(cfg):
        return GlobalPoolingLayer(pooling_type=PoolingType.AVG)

    @staticmethod
    def _map_zeropadding2d(cfg):
        p = cfg.get("padding", (1, 1))
        if isinstance(p, (list, tuple)) and len(p) == 2 \
                and isinstance(p[0], (list, tuple)):
            pads = (int(p[0][0]), int(p[0][1]), int(p[1][0]), int(p[1][1]))
        else:
            ph, pw = _pair(p)
            pads = (ph, ph, pw, pw)
        return ZeroPaddingLayer(padding=pads)

    @staticmethod
    def _map_upsampling2d(cfg):
        return Upsampling2D(size=_pair(cfg.get("size", (2, 2))))

    @staticmethod
    def _map_batchnormalization(cfg):
        return BatchNormalization(
            decay=float(cfg.get("momentum", 0.99)),
            eps=float(cfg.get("epsilon", 1e-3)))

    @staticmethod
    def _map_embedding(cfg):
        return EmbeddingSequenceLayer(
            n_in=int(cfg.get("input_dim")),
            n_out=int(cfg.get("output_dim")),
            activation="identity", has_bias=False)

    @staticmethod
    def _map_lstm(cfg):
        layer = LSTM(n_out=int(cfg.get("units", cfg.get("output_dim"))),
                     activation=_act(cfg.get("activation", "tanh")),
                     gate_activation=_act(cfg.get("recurrent_activation",
                                                  cfg.get("inner_activation",
                                                          "sigmoid"))))
        return _maybe_last_step(layer, cfg)

    @staticmethod
    def _map_simplernn(cfg):
        layer = SimpleRnn(n_out=int(cfg.get("units", cfg.get("output_dim"))),
                          activation=_act(cfg.get("activation", "tanh")))
        return _maybe_last_step(layer, cfg)

    @staticmethod
    def _map_separableconv2d(cfg):
        return SeparableConvolution2D(
            n_out=int(cfg.get("filters", cfg.get("nb_filter"))),
            kernel_size=_pair(cfg.get("kernel_size",
                                      (cfg.get("nb_row", 3),
                                       cfg.get("nb_col", 3)))),
            stride=_pair(cfg.get("strides", cfg.get("subsample", (1, 1)))),
            dilation=_pair(cfg.get("dilation_rate", (1, 1))),
            depth_multiplier=int(cfg.get("depth_multiplier", 1)),
            convolution_mode=_padding_mode(cfg),
            activation=_act(cfg.get("activation")),
            has_bias=bool(cfg.get("use_bias", cfg.get("bias", True))))

    @staticmethod
    def _map_depthwiseconv2d(cfg):
        return DepthwiseConvolution2D(
            kernel_size=_pair(cfg.get("kernel_size", (3, 3))),
            stride=_pair(cfg.get("strides", (1, 1))),
            dilation=_pair(cfg.get("dilation_rate", (1, 1))),
            depth_multiplier=int(cfg.get("depth_multiplier", 1)),
            convolution_mode=_padding_mode(cfg),
            activation=_act(cfg.get("activation")),
            has_bias=bool(cfg.get("use_bias", True)))

    @staticmethod
    def _map_conv1d(cfg):
        k = cfg.get("kernel_size", cfg.get("filter_length", 3))
        k = int(k[0] if isinstance(k, (list, tuple)) else k)
        s = cfg.get("strides", cfg.get("subsample_length", 1))
        s = int(s[0] if isinstance(s, (list, tuple)) else s)
        d = cfg.get("dilation_rate", 1)
        d = int(d[0] if isinstance(d, (list, tuple)) else d)
        return Convolution1DLayer(
            n_out=int(cfg.get("filters", cfg.get("nb_filter"))),
            kernel_size=k, stride=s, dilation=d,
            convolution_mode=_padding_mode(cfg),
            activation=_act(cfg.get("activation")),
            has_bias=bool(cfg.get("use_bias", cfg.get("bias", True))))

    _map_convolution1d = _map_conv1d  # Keras 1 name

    @staticmethod
    def _map_maxpooling1d(cfg):
        p = cfg.get("pool_size", cfg.get("pool_length", 2))
        p = int(p[0] if isinstance(p, (list, tuple)) else p)
        s = cfg.get("strides", cfg.get("stride")) or p
        s = int(s[0] if isinstance(s, (list, tuple)) else s)
        return Subsampling1DLayer(pooling_type=PoolingType.MAX,
                                  kernel_size=p, stride=s,
                                  convolution_mode=_padding_mode(cfg))

    @staticmethod
    def _map_averagepooling1d(cfg):
        p = cfg.get("pool_size", cfg.get("pool_length", 2))
        p = int(p[0] if isinstance(p, (list, tuple)) else p)
        s = cfg.get("strides", cfg.get("stride")) or p
        s = int(s[0] if isinstance(s, (list, tuple)) else s)
        return Subsampling1DLayer(pooling_type=PoolingType.AVG,
                                  kernel_size=p, stride=s,
                                  convolution_mode=_padding_mode(cfg))

    @staticmethod
    def _map_leakyrelu(cfg):
        # Keras 3 spells it negative_slope; Keras 1/2 alpha. Default 0.3
        # (Keras) ≠ 0.01 (our bare "leakyrelu") — carry it explicitly
        alpha = float(cfg.get("negative_slope", cfg.get("alpha", 0.3)))
        return ActivationLayer(activation=f"leakyrelu:{alpha}")

    @staticmethod
    def _map_elu(cfg):
        return ActivationLayer(
            activation=f"elu:{float(cfg.get('alpha', 1.0))}")

    @staticmethod
    def _map_cropping2d(cfg):
        c = cfg.get("cropping", ((0, 0), (0, 0)))
        if isinstance(c, (list, tuple)) and c and isinstance(c[0], (list, tuple)):
            crops = (int(c[0][0]), int(c[0][1]), int(c[1][0]), int(c[1][1]))
        else:
            ch, cw = _pair(c)
            crops = (ch, ch, cw, cw)
        return Cropping2D(cropping=crops)

    @staticmethod
    def _map_upsampling1d(cfg):
        sz = cfg.get("size", cfg.get("length", 2))
        return Upsampling1D(size=int(sz[0] if isinstance(sz, (list, tuple))
                                     else sz))

    @staticmethod
    def _map_spatialdropout2d(cfg):
        # per-feature-map dropout approximated by elementwise dropout (the
        # reference maps SpatialDropout to plain DropoutLayer too)
        return DropoutLayer(dropout=1.0 - float(cfg.get("rate",
                                                        cfg.get("p", 0.5))))

    _map_spatialdropout1d = _map_spatialdropout2d

    @staticmethod
    def _map_bidirectional(cfg):
        inner_cfg = cfg.get("layer", {})
        inner = KerasLayerMapper.map(inner_cfg.get("class_name"),
                                     inner_cfg.get("config", {}))
        merge = cfg.get("merge_mode", "concat")
        modes = {"concat": "concat", "sum": "add", "ave": "ave", "mul": "mul"}
        if merge not in modes:
            # merge_mode=None means TWO output tensors — structurally
            # unrepresentable as one wrapped layer; fail loudly
            raise ValueError(f"Unsupported Bidirectional merge_mode "
                             f"{merge!r} (supported: {sorted(modes)})")
        mode = modes[merge]
        if type(inner).__name__ == "LastTimeStep":
            # wrap order: Bidirectional over the RNN, LastTimeStep outside
            return LastTimeStep(inner=Bidirectional(inner=inner.inner,
                                                    mode=mode))
        return Bidirectional(inner=inner, mode=mode)

    @staticmethod
    def _map_timedistributed(cfg):
        """TimeDistributed wrapper (reference ``KerasTimeDistributed``,
        dual-name row in ``KerasLayerConfiguration.java``): per-timestep
        application of the wrapped layer. Dense & co. already apply
        per-timestep on [b, T, f] activations, so the mapping is the inner
        layer itself."""
        inner = cfg.get("layer", {})
        return KerasLayerMapper.map(inner.get("class_name"),
                                    inner.get("config", {}))


# --------------------------------------------------------------------- parse
def _decode(v):
    if isinstance(v, bytes):
        return v.decode("utf-8")
    return v


def _tensor_source(entry):
    """Source layer name from one inbound tensor reference: Keras 3
    ``__keras_tensor__`` dicts carry it in ``keras_history``; Keras 1/2 use
    ``[name, node_idx, tensor_idx, ...]`` lists or bare names."""
    if isinstance(entry, dict):
        hist = entry.get("config", {}).get("keras_history", [None])
        return hist[0]
    if isinstance(entry, (list, tuple)):
        return entry[0]
    return entry


def _inbound_names(inbound) -> List[str]:
    """Input layer names from a layer's ``inbound_nodes`` across Keras
    dialects (1/2: nested lists; 3: {"args": [...]} call records)."""
    if not inbound:
        return []
    node = inbound[0]
    if isinstance(node, dict):  # Keras 3
        args = node.get("args", [])
        if not args:
            return []
        first = args[0]
        entries = first if isinstance(first, list) else [first]
        return [_tensor_source(e) for e in entries]
    return [_tensor_source(e) for e in node]


def _io_names(spec) -> List[str]:
    """Model input/output layer names: Keras 2 nests ``[[name, 0, 0], ...]``;
    Keras 3 flattens a single entry to ``[name, 0, 0]``."""
    if not spec:
        return []
    if isinstance(spec[0], (list, tuple)):
        return [s[0] for s in spec]
    if (len(spec) == 3 and isinstance(spec[0], str)
            and isinstance(spec[1], int)):
        return [spec[0]]
    return [s if isinstance(s, str) else s[0] for s in spec]


def _read_model_config(f) -> Dict:
    raw = f.attrs.get("model_config")
    if raw is None:
        raise ValueError("HDF5 file has no 'model_config' attribute — not a "
                         "Keras full-model save (weights-only files need the "
                         "architecture JSON, reference importKerasModelAndWeights"
                         "(json, h5) overload)")
    return json.loads(_decode(raw))


def _layer_list(model_cfg: Dict) -> List[Dict]:
    cfg = model_cfg.get("config")
    if isinstance(cfg, list):  # Keras 1 / early 2
        return cfg
    return cfg["layers"]


#: Keras-1 weight-name suffixes → Keras-2 canonical names (the reference's
#: dual-dialect table, ``KerasLayerConfiguration.java:43-71``). Longest
#: suffixes first so ``_running_mean`` wins over ``_b``-style matches.
_K1_WEIGHT_SUFFIXES = (("running_mean", "moving_mean"),
                       ("running_std", "moving_variance"),
                       ("gamma", "gamma"), ("beta", "beta"),
                       ("U", "recurrent_kernel"),
                       ("W", "kernel"), ("b", "bias"))


def _canonical_weight_name(short: str) -> str:
    for suf, canon in _K1_WEIGHT_SUFFIXES:
        if short == suf or short.endswith("_" + suf):
            return canon
    return short


def _layer_weights(f, name: str) -> Dict[str, np.ndarray]:
    """{short weight name: array} for a layer from model_weights; Keras-1
    ``<layer>_W``-style names normalized to the Keras-2 spellings."""
    mw = f["model_weights"] if "model_weights" in f else f
    if name not in mw:
        return {}
    grp = mw[name]
    weight_names = [_decode(n) for n in grp.attrs.get("weight_names", [])]
    out = {}
    for wn in weight_names:
        short = wn.split("/")[-1].split(":")[0]
        canon = _canonical_weight_name(short)
        # Bidirectional wrappers carry direction in a PATH SEGMENT
        # ('forward_lstm/...'); anchor the match there so a layer merely
        # NAMED 'feedforward' is not misclassified
        segs = wn.split("/")[:-1]
        if any(g == "forward" or g.startswith("forward_") for g in segs):
            canon = "forward_" + canon
        elif any(g == "backward" or g.startswith("backward_") for g in segs):
            canon = "backward_" + canon
        out[canon] = np.asarray(grp[wn])
    return out


def _lstm_reorder(arr: np.ndarray, H: int) -> np.ndarray:
    """Keras gate order (i, f, c, o) → ours (i, f, o, g=c), last axis."""
    i, fgate, cgate, o = (arr[..., 0:H], arr[..., H:2 * H],
                          arr[..., 2 * H:3 * H], arr[..., 3 * H:4 * H])
    return np.concatenate([i, fgate, o, cgate], axis=-1)


def _host_copy(tree):
    """Numpy copies of a dict tree of tensors (bfloat16 as float32)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _host_copy(v)
        else:
            t = v.detach().to("cpu", copy=True)
            out[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def _write_back(key, what, live, host) -> None:
    """Copy the arrays of ``host`` onto the tensors of ``live`` (the same
    keypaths) in place, under ``no_grad``, each cast to its tensor's dtype on
    its device; a keypath missing or added, or a changed shape, raises."""
    live_flat = dict(leaves(live))
    host_flat = dict(_flat_items(host))
    if set(host_flat) != set(live_flat):
        raise ValueError(f"Layer {key}: {what} {sorted(host_flat)} do not match the "
                         f"layer's {sorted(live_flat)}")
    with torch.no_grad():
        for path, t in live_flat.items():
            arr = np.asarray(host_flat[path])
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"Layer {key}: {what[:-1]} '{path}' shape {arr.shape} != "
                                 f"expected {tuple(t.shape)}")
            t.copy_(torch.as_tensor(arr).to(device=t.device, dtype=t.dtype))


def _flat_items(tree, prefix=""):
    """(keypath, array) of a dict tree of arrays."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flat_items(v, path)
        else:
            yield path, v


def _set_layer_weights(net, key, layer_conf, weights):
    """Copy Keras weights onto the parameters and state of layer ``key`` of
    ``net`` (the JAX package's ``_set_layer_weights`` on numpy copies of the
    layer's trees, written back by keypath)."""
    impl = net._layers()[key]
    live_p, live_s = impl.param_dict(), impl.layer_state()
    p, st = _host_copy(live_p), _host_copy(live_s)
    setter = getattr(layer_conf, "_keras_weight_setter", None)
    if setter is not None:  # custom-layer SPI override
        setter(p, st, weights)
        _write_back(key, "parameters", live_p, p)
        _write_back(key, "states", live_s, st)
        return
    if type(layer_conf).__name__ == "LastTimeStep":
        layer_conf = layer_conf.inner  # params live on the wrapped layer
    t = type(layer_conf).__name__

    def put(name, arr):
        tgt = p[name]
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"Layer {key} ({t}): weight '{name}' shape "
                             f"{arr.shape} != expected {tuple(tgt.shape)}")
        p[name] = np.asarray(arr, dtype=tgt.dtype)

    if t in ("DenseLayer", "OutputLayer", "RnnOutputLayer"):
        put("W", weights["kernel"] if "kernel" in weights else weights["W"])
        if "b" in p:
            put("b", weights.get("bias", weights.get("b")))
    elif t in ("ConvolutionLayer", "Convolution1DLayer"):
        put("W", weights["kernel"])  # HWIO == HWIO, straight copy
        if "b" in p:
            put("b", weights["bias"])
    elif t == "DepthwiseConvolution2D":
        # Keras 3 names the depthwise kernel plain "kernel"
        dk = weights.get("depthwise_kernel", weights.get("kernel"))  # [kh,kw,C,m]
        kh, kw, cin, m = dk.shape
        put("W", dk.reshape(kh, kw, 1, cin * m))  # grouped-conv layout
        if "b" in p:
            put("b", weights["bias"])
    elif t == "SeparableConvolution2D":
        dk = weights["depthwise_kernel"]
        kh, kw, cin, m = dk.shape
        put("dW", dk.reshape(kh, kw, 1, cin * m))
        put("pW", weights["pointwise_kernel"])
        if "b" in p:
            put("b", weights["bias"])
    elif t == "Bidirectional":
        H = layer_conf.inner.n_out
        for side, pre in (("fwd", "forward_"), ("bwd", "backward_")):
            sub = p[side]
            for ours, theirs in (("W", "kernel"), ("RW", "recurrent_kernel"),
                                 ("b", "bias")):
                if theirs == "bias" and (ours not in sub
                                         or pre + theirs not in weights):
                    if ours in sub:
                        # use_bias=False inner RNN: zero the initialised
                        # bias (forget gate starts at 1.0) instead of
                        # silently keeping it
                        sub[ours] = np.zeros_like(sub[ours])
                    continue
                arr = _lstm_reorder(weights[pre + theirs], H)
                tgt = sub[ours]
                if tuple(arr.shape) != tuple(tgt.shape):
                    raise ValueError(f"Layer {key} Bidirectional {side}.{ours}"
                                     f": {arr.shape} != {tuple(tgt.shape)}")
                sub[ours] = np.asarray(arr, tgt.dtype)
    elif t == "BatchNormalization":
        # scale=False / center=False models ship only one of gamma/beta —
        # copy each independently
        if "gamma" in p and "gamma" in weights:
            put("gamma", weights["gamma"])
        if "beta" in p and "beta" in weights:
            put("beta", weights["beta"])
        if "moving_mean" in weights:
            st["mean"] = np.asarray(weights["moving_mean"], st["mean"].dtype)
            st["var"] = np.asarray(weights["moving_variance"], st["var"].dtype)
    elif t in ("EmbeddingSequenceLayer", "EmbeddingLayer"):
        put("W", weights["embeddings"])
    elif t == "LSTM":
        H = layer_conf.n_out
        put("W", _lstm_reorder(weights["kernel"], H))
        put("RW", _lstm_reorder(weights["recurrent_kernel"], H))
        if "b" in p:
            if "bias" in weights:
                put("b", _lstm_reorder(weights["bias"], H))
            else:
                # use_bias=False: the port's init sets the forget-gate bias
                # to 1.0; zero it so the imported model computes what Keras did
                p["b"] = np.zeros_like(p["b"])
    elif t == "SimpleRnn":
        put("W", weights["kernel"])
        put("RW", weights["recurrent_kernel"])
        if "b" in p:
            if "bias" in weights:
                put("b", weights["bias"])
            else:
                p["b"] = np.zeros_like(p["b"])
    elif not weights:
        pass
    else:
        raise ValueError(f"Weight copy not implemented for layer type {t}")
    _write_back(key, "parameters", live_p, p)
    _write_back(key, "states", live_s, st)


def _maybe_permute_dense_kernel(weights: Dict[str, np.ndarray],
                                pre) -> Dict[str, np.ndarray]:
    """Keras flattens conv activations in (h, w, c) order; our
    CnnToFeedForward preprocessor flattens channel-major (c, h, w) —
    reference parity, ``CnnToFeedForwardPreProcessor.java``. A Dense kernel
    following a Flatten must have its input rows permuted accordingly
    (reference ``KerasDense`` dim-ordering handling)."""
    if pre is None or type(pre).__name__ != "CnnToFeedForwardPreProcessor":
        return weights
    k = weights.get("kernel")
    if k is None or k.ndim != 2:
        return weights
    h, w, c = int(pre.height), int(pre.width), int(pre.channels)
    if h * w * c != k.shape[0]:
        return weights
    k2 = k.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(k.shape[0], -1)
    out = dict(weights)
    out["kernel"] = k2
    return out


def _input_type_from_shape(shape) -> Optional[Any]:
    """Keras batch_input_shape/input_shape (batch dim already stripped) →
    InputType, classified by RANK so variable-length sequence shapes like
    ``(None, features)`` stay recurrent. NHWC assumed for rank 3 (TF
    ordering)."""
    if shape is None:
        return None
    shape = tuple(shape)
    if len(shape) == 3:
        h, w, c = shape
        if None in (h, w, c):
            return None  # variable spatial dims: let shape inference handle it
        return InputType.convolutional(h, w, c)
    if len(shape) == 2:
        return (None if shape[-1] is None
                else InputType.recurrent(shape[-1]))
    if len(shape) == 1:
        return (None if shape[0] is None
                else InputType.feed_forward(shape[0]))
    return None


# ------------------------------------------------------------------ importers
def _read_h5(path):
    """(model_config, training_config or None, {layer name: {short weight
    name: ndarray}}) of a Keras full-model HDF5 file."""
    import h5py
    with h5py.File(path, "r") as f:
        model_cfg = _read_model_config(f)
        raw = f.attrs.get("training_config")
        training_cfg = None if raw is None else json.loads(_decode(raw))
        if model_cfg.get("class_name") == "Sequential":
            names = [lc.get("config", {}).get("name", lc["class_name"].lower())
                     for lc in _layer_list(model_cfg)]
        else:
            names = [lc.get("name", lc.get("config", {}).get("name"))
                     for lc in model_cfg["config"]["layers"]]
        weights = {n: _layer_weights(f, n) for n in names}
    return model_cfg, training_cfg, {n: w for n, w in weights.items() if w}


def _loss(training_cfg) -> Optional[str]:
    return None if training_cfg is None else training_cfg.get("loss")


def _import_sequential(model_cfg: Dict, training_cfg: Optional[Dict],
                       weights: Mapping[str, Mapping[str, np.ndarray]],
                       device="cuda") -> MultiLayerNetwork:
    """A Sequential ``model_config`` and its weights -> MultiLayerNetwork
    on ``device``."""
    if model_cfg.get("class_name") not in ("Sequential",):
        raise ValueError("Not a Sequential model; use "
                         "import_keras_model_and_weights")
    layer_cfgs = _layer_list(model_cfg)
    loss = _loss(training_cfg)
    layers, names, input_type = [], [], None
    for lc in layer_cfgs:
        cls = lc["class_name"]
        cfg = lc.get("config", {})
        if input_type is None:
            shape = cfg.get("batch_input_shape", cfg.get("batch_shape"))
            it = _input_type_from_shape(shape[1:] if shape else None)
            if it is not None:
                input_type = it
        if cls in KerasLayerMapper.SKIPPED:
            continue
        layers.append(KerasLayerMapper.map(cls, cfg))
        names.append(cfg.get("name", cls.lower()))

    recurrent_stream = _ends_recurrent(layers)
    layers = _convert_last_to_output(layers, loss, recurrent_stream)
    lb = NeuralNetConfiguration.builder().list()
    for l in layers:
        lb.layer(l)
    if input_type is not None:
        lb.set_input_type(input_type)
    conf = lb.build()
    net = MultiLayerNetwork(conf).init(device=device)
    # weight copy: Keras layer name -> the port's layer index (skipped
    # layers carry no weights)
    for li, name in enumerate(names):
        w = dict(weights.get(name, {}))
        if w:
            w = _maybe_permute_dense_kernel(w, conf.preprocessor(li))
            _set_layer_weights(net, str(li), conf.layers[li], w)
    return net


def _import_functional(model_cfg: Dict, training_cfg: Optional[Dict],
                       weights: Mapping[str, Mapping[str, np.ndarray]],
                       device="cuda"):
    """A functional ``model_config`` and its weights -> ComputationGraph on
    ``device`` (a Sequential one -> MultiLayerNetwork)."""
    cls_name = model_cfg.get("class_name")
    if cls_name == "Sequential":
        return _import_sequential(model_cfg, training_cfg, weights, device)
    if cls_name not in ("Model", "Functional"):
        raise ValueError(f"Unsupported Keras model class '{cls_name}'")
    cfg = model_cfg["config"]
    layer_cfgs = cfg["layers"]
    input_layers = _io_names(cfg["input_layers"])
    output_layers = _io_names(cfg["output_layers"])
    loss = _loss(training_cfg)

    g = NeuralNetConfiguration.builder().graph_builder()
    g.add_inputs(*input_layers)
    input_types = []
    name_to_conf = {}
    skipped_alias: Dict[str, str] = {}  # skipped layer -> its input
    for lc in layer_cfgs:
        cls = lc["class_name"]
        kcfg = lc.get("config", {})
        name = lc.get("name", kcfg.get("name"))
        ins = [skipped_alias.get(src, src)
               for src in _inbound_names(lc.get("inbound_nodes", []))]
        if cls == "InputLayer":
            shape = kcfg.get("batch_input_shape", kcfg.get("batch_shape"))
            input_types.append(_input_type_from_shape(shape[1:] if shape else None))
            continue
        if cls in KerasLayerMapper.SKIPPED:
            skipped_alias[name] = ins[0]
            continue
        if cls in ("Add",):
            g.add_vertex(name, ElementWiseVertex(op="add"), *ins)
            continue
        if cls in ("Concatenate", "Merge"):
            g.add_vertex(name, MergeVertex(), *ins)
            continue
        mapped = KerasLayerMapper.map(cls, kcfg)
        if name in output_layers and _is_output_candidate(mapped):
            mapped = _to_output_layer(mapped, loss)
        name_to_conf[name] = mapped
        g.add_layer(name, mapped, *ins)
    g.set_outputs(*[skipped_alias.get(o, o) for o in output_layers])
    if input_types and all(t is not None for t in input_types):
        g.set_input_types(*input_types)
    conf = g.build()
    net = ComputationGraph(conf).init(device=device)
    for name, lconf in name_to_conf.items():
        w = dict(weights.get(name, {}))
        if w:
            w = _maybe_permute_dense_kernel(w, conf.input_preprocessors.get(name))
            _set_layer_weights(net, name, lconf, w)
    return net


class KerasModelImport:
    """Entry points (reference ``KerasModelImport.java:50-233``). Each takes
    the path of a Keras full-model HDF5 file (h5py reads it) and builds the
    network on ``device``, the card unless ``device="cpu"``."""

    @staticmethod
    def import_keras_sequential_model_and_weights(path: str,
                                                  enforce_training_config=False,
                                                  device="cuda"):
        dev = resolve_device(device)
        return _import_sequential(*_read_h5(path), device=dev)

    importKerasSequentialModelAndWeights = import_keras_sequential_model_and_weights

    @staticmethod
    def import_keras_model_and_weights(path: str, enforce_training_config=False,
                                       device="cuda"):
        dev = resolve_device(device)
        return _import_functional(*_read_h5(path), device=dev)

    importKerasModelAndWeights = import_keras_model_and_weights


def _is_output_candidate(layer) -> bool:
    return isinstance(layer, DenseLayer) and type(layer) is DenseLayer


def _ends_recurrent(layers) -> bool:
    """Does the activation stream reaching the last layer still have a time
    axis? (Decides OutputLayer vs RnnOutputLayer for the converted head.)"""
    rec = False
    for layer in layers[:-1]:
        t = type(layer).__name__
        if t in ("LSTM", "GravesLSTM", "SimpleRnn", "GravesBidirectionalLSTM",
                 "Bidirectional", "EmbeddingSequenceLayer"):
            rec = True
        elif t in ("LastTimeStep", "GlobalPoolingLayer", "ConvolutionLayer",
                   "SubsamplingLayer"):
            # DenseLayer deliberately NOT here: Keras Dense on 3D input applies
            # per-timestep, so LSTM(return_sequences)->Dense keeps the time
            # axis and the head must stay RnnOutputLayer (reference KerasLstm/
            # RnnOutputLayer pairing)
            rec = False
    return rec


def _to_output_layer(layer: DenseLayer, loss, recurrent=False):
    cls = RnnOutputLayer if recurrent else OutputLayer
    return cls(n_out=layer.n_out, activation=layer.activation,
               has_bias=layer.has_bias,
               loss=_LOSSES.get(str(loss), "mcxent"))


def _convert_last_to_output(layers, loss, recurrent=False):
    """The reference converts the final Keras layer + training loss into a
    DL4J output layer; without a training config it defaults to MCXENT, which
    preserves inference behavior exactly. A recurrent stream gets
    RnnOutputLayer (per-timestep head) like the reference's KerasLstm→
    RnnOutputLayer pairing."""
    if not layers:
        return layers
    last = layers[-1]
    if _is_output_candidate(last):
        layers = layers[:-1] + [_to_output_layer(last, loss, recurrent)]
    return layers