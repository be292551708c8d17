"""Model zoo: standard architectures as config builders.

Counterpart of ``deeplearning4j_tpu/models/zoo.py``: the ``ZooModel`` base
(``conf``, ``init``, ``_builder``), ``LeNet``, ``SimpleCNN``, ``ResNet50``,
``TextGenerationLSTM`` and ``TransformerLM`` (dense or MoE), with the JAX
package's layer and vertex names, so that the keypaths of its zips match;
``generate_tokens``, the sampling loop over either container's
``rnn_time_step``; and ``ModelSelector``, which knows every name the JAX
package's does. The other zoo models (selecting one raises) and pretrained
weights are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..nn.conf import InputType, MultiLayerConfiguration, NeuralNetConfiguration
from ..nn.conf.graph import ElementWiseVertex
from ..nn.conf.layers import (ActivationLayer, BatchNormalization, ConvolutionLayer,
                              ConvolutionMode, DenseLayer, DropoutLayer, EmbeddingSequenceLayer,
                              GlobalPoolingLayer, GravesLSTM, LayerNormalization, MoEDenseLayer,
                              OutputLayer, PoolingType, RnnOutputLayer, SelfAttentionLayer,
                              SubsamplingLayer)
from ..nn.graph import ComputationGraph
from ..nn.multilayer import MultiLayerNetwork
from ..nn.updaters import Adam

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "ResNet50", "TextGenerationLSTM", "TransformerLM",
           "generate_tokens", "ZOO", "ModelSelector"]


class ZooModel:
    """Base: ``conf()`` builds the configuration, ``init()`` a fresh network
    on ``device`` (the card unless ``device="cpu"``)."""

    name: str = "zoo_model"

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape: Optional[Tuple[int, int, int]] = None):
        self.num_classes = num_classes
        self.seed = seed
        if input_shape is not None:
            self.input_shape = input_shape

    def conf(self):
        raise NotImplementedError

    def init(self, device="cuda"):
        conf = self.conf()
        if isinstance(conf, MultiLayerConfiguration):
            return MultiLayerNetwork(conf).init(device=device)
        return ComputationGraph(conf).init(device=device)

    def _builder(self, updater=None, activation="relu", weight_init="relu"):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(updater or Adam(learning_rate=1e-3))
                .activation(activation)
                .weight_init(weight_init))


class LeNet(ZooModel):
    """Reference ``zoo/model/LeNet.java``: 28x28xc -> conv20-5 -> max2 ->
    conv50-5 -> max2 -> dense500 -> softmax (a MultiLayerNetwork)."""

    name = "lenet"
    input_shape = (1, 28, 28)

    def __init__(self, num_classes: int = 10, seed: int = 123, **kw):
        super().__init__(num_classes, seed, **kw)

    def conf(self):
        c, h, w = self.input_shape
        return (self._builder()
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                        activation="identity"))
                .layer(SubsamplingLayer(pooling_type=PoolingType.MAX, kernel_size=(2, 2),
                                        stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                        activation="identity"))
                .layer(SubsamplingLayer(pooling_type=PoolingType.MAX, kernel_size=(2, 2),
                                        stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class SimpleCNN(ZooModel):
    """Reference ``zoo/model/SimpleCNN.java``: a compact 48x48 CNN (a
    MultiLayerNetwork): three SAME 3x3 convolutions (16, 32, 64; relu) each
    with BatchNormalization and relu, max pools after the second and
    third, global average pool, DropoutLayer(0.5), softmax."""

    name = "simplecnn"
    input_shape = (3, 48, 48)

    def __init__(self, num_classes: int = 10, seed: int = 123, **kw):
        super().__init__(num_classes, seed, **kw)

    def conf(self):
        c, h, w = self.input_shape
        same = ConvolutionMode.Same
        return (self._builder()
                .list()
                .layer(ConvolutionLayer(n_out=16, kernel_size=(3, 3), convolution_mode=same))
                .layer(BatchNormalization())
                .layer(ActivationLayer(activation="relu"))
                .layer(ConvolutionLayer(n_out=32, kernel_size=(3, 3), convolution_mode=same))
                .layer(BatchNormalization())
                .layer(ActivationLayer(activation="relu"))
                .layer(SubsamplingLayer(pooling_type=PoolingType.MAX, kernel_size=(2, 2),
                                        stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=64, kernel_size=(3, 3), convolution_mode=same))
                .layer(BatchNormalization())
                .layer(ActivationLayer(activation="relu"))
                .layer(SubsamplingLayer(pooling_type=PoolingType.MAX, kernel_size=(2, 2),
                                        stride=(2, 2)))
                .layer(GlobalPoolingLayer(pooling_type=PoolingType.AVG))
                .layer(DropoutLayer(dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class ResNet50(ZooModel):
    """Reference ``zoo/model/ResNet50.java`` (conv/identity blocks): stem
    conv7/2 -> max pool 3/2 -> [3, 4, 6, 3] bottleneck stages -> global
    average pool -> softmax (a ComputationGraph). Every convolution is SAME
    without bias, followed by BatchNormalization."""

    name = "resnet50"
    input_shape = (3, 224, 224)
    STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))

    def _conv_bn(self, g, name, inp, n_out, k, stride=(1, 1), activation="relu"):
        g.add_layer(f"{name}-conv", ConvolutionLayer(
            n_out=n_out, kernel_size=k, stride=stride, convolution_mode=ConvolutionMode.Same,
            activation="identity", has_bias=False), inp)
        g.add_layer(f"{name}-bn", BatchNormalization(), f"{name}-conv")
        if activation == "identity":
            return f"{name}-bn"
        g.add_layer(f"{name}-act", ActivationLayer(activation=activation), f"{name}-bn")
        return f"{name}-act"

    def _bottleneck(self, g, name, inp, width, stride, project):
        """conv block (with a projection shortcut) or identity block."""
        a = self._conv_bn(g, f"{name}-a", inp, width, (1, 1), stride)
        b = self._conv_bn(g, f"{name}-b", a, width, (3, 3))
        c = self._conv_bn(g, f"{name}-c", b, 4 * width, (1, 1), activation="identity")
        shortcut = (self._conv_bn(g, f"{name}-sc", inp, 4 * width, (1, 1), stride,
                                  activation="identity") if project else inp)
        g.add_vertex(f"{name}-add", ElementWiseVertex(op="add"), c, shortcut)
        g.add_layer(f"{name}", ActivationLayer(activation="relu"), f"{name}-add")
        return name

    def conf(self):
        c, h, w = self.input_shape
        same = ConvolutionMode.Same
        g = (self._builder().graph_builder()
             .add_inputs("input")
             .add_layer("stem-conv", ConvolutionLayer(
                 n_out=64, kernel_size=(7, 7), stride=(2, 2), convolution_mode=same,
                 activation="identity", has_bias=False), "input")
             .add_layer("stem-bn", BatchNormalization(), "stem-conv")
             .add_layer("stem-act", ActivationLayer(activation="relu"), "stem-bn")
             .add_layer("stem-pool", SubsamplingLayer(
                 pooling_type=PoolingType.MAX, kernel_size=(3, 3), stride=(2, 2),
                 convolution_mode=same), "stem-act"))
        prev = "stem-pool"
        for si, (blocks, width) in enumerate(self.STAGES):
            for bi in range(blocks):
                stride = (2, 2) if (bi == 0 and si > 0) else (1, 1)
                prev = self._bottleneck(g, f"s{si}b{bi}", prev, width, stride,
                                        project=(bi == 0))
        g.add_layer("gap", GlobalPoolingLayer(pooling_type=PoolingType.AVG), prev)
        g.add_layer("output", OutputLayer(n_out=self.num_classes, activation="softmax",
                                          loss="mcxent"), "gap")
        g.set_outputs("output")
        g.set_input_types(InputType.convolutional(h, w, c))
        return g.build()


class TextGenerationLSTM(ZooModel):
    """Reference ``zoo/model/TextGenerationLSTM.java``: a char-level stack of
    ``num_layers`` (>= 2) GravesLSTM(``lstm_size``, tanh) and a per-step
    softmax (a MultiLayerNetwork), 47 characters by default."""

    name = "textgenlstm"

    def __init__(self, total_unique_characters: Optional[int] = None,
                 num_classes: Optional[int] = None, seed: int = 123,
                 lstm_size: int = 256, num_layers: int = 2, **kw):
        n = total_unique_characters if total_unique_characters is not None \
            else (num_classes if num_classes is not None else 47)
        super().__init__(n, seed, **kw)
        self.lstm_size = lstm_size
        if int(num_layers) < 2:
            raise ValueError(f"TextGenerationLSTM needs num_layers >= 2 (got {num_layers})")
        self.num_layers = int(num_layers)

    def conf(self):
        n = self.num_classes
        b = (self._builder(activation="tanh", weight_init="xavier")
             .list()
             .layer(GravesLSTM(n_in=n, n_out=self.lstm_size, activation="tanh")))
        for _ in range(self.num_layers - 1):
            b.layer(GravesLSTM(n_in=self.lstm_size, n_out=self.lstm_size, activation="tanh"))
        b.layer(RnnOutputLayer(n_in=self.lstm_size, n_out=n, activation="softmax",
                               loss="mcxent"))
        return b.build()


class TransformerLM(ZooModel):
    """Decoder-only transformer language model, built as a ComputationGraph
    so that the residual adds are ``ElementWiseVertex`` edges:

        ids [b, T] -> embed -> n_blocks x [ x + Attn(LN(x));
                                            x + FFN(LN(x)) ] -> LN -> softmax

    No position embedding: causal attention makes it order-aware, and every
    layer stays shape-agnostic in T. Attention takes the flash kernels at T
    >= 4096 (``ops/flash_attention.MIN_SEQ``), the dense body below."""

    name = "transformerlm"

    def __init__(self, vocab_size: Optional[int] = None,
                 num_classes: Optional[int] = None, seed: int = 123,
                 embed_dim: int = 256, num_heads: int = 4,
                 num_blocks: int = 4, ffn_mult: int = 4,
                 dropout_rate: float = 0.0, num_experts: int = 0,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_weight: float = 1e-2, **kw):
        n = vocab_size if vocab_size is not None \
            else (num_classes if num_classes is not None else 256)
        super().__init__(n, seed, **kw)
        self.embed_dim = int(embed_dim)
        self.num_heads = int(num_heads)
        self.num_blocks = int(num_blocks)
        self.ffn_mult = int(ffn_mult)
        self.dropout_rate = float(dropout_rate)
        self.num_experts = int(num_experts)
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.aux_loss_weight = float(aux_loss_weight)
        if self.embed_dim % self.num_heads:
            raise ValueError(f"num_heads {num_heads} must divide embed_dim {embed_dim}")

    def _ffn(self, E, F):
        """The block FFN's up-projection: a dense gelu layer, or with
        ``num_experts`` > 0 a gelu ``MoEDenseLayer`` (the Mixtral-style
        sparse decoder; capacity dispatch in training). The
        down-projection stays one shared dense layer."""
        if self.num_experts > 0:
            return MoEDenseLayer(n_in=E, n_out=F, activation="gelu",
                                 num_experts=self.num_experts, top_k=self.top_k,
                                 capacity_factor=self.capacity_factor,
                                 aux_loss_weight=self.aux_loss_weight)
        return DenseLayer(n_in=E, n_out=F, activation="gelu")

    def conf(self):
        E, V = self.embed_dim, self.num_classes
        F = E * self.ffn_mult
        # explicit n_in everywhere and no input types: every layer is
        # sequence-shaped [b, T, .] end to end
        g = (self._builder(activation="identity", weight_init="xavier")
             .graph_builder()
             .add_inputs("ids")
             .add_layer("embed", EmbeddingSequenceLayer(n_in=V, n_out=E), "ids"))
        prev = "embed"
        for i in range(self.num_blocks):
            g = (g.add_layer(f"b{i}-ln-a", LayerNormalization(n_in=E, n_out=E), prev)
                 .add_layer(f"b{i}-attn",
                            SelfAttentionLayer(n_in=E, n_out=E, num_heads=self.num_heads,
                                               causal=True, dropout_rate=self.dropout_rate),
                            f"b{i}-ln-a")
                 .add_vertex(f"b{i}-res-a", ElementWiseVertex(op="add"), prev, f"b{i}-attn")
                 .add_layer(f"b{i}-ln-f", LayerNormalization(n_in=E, n_out=E), f"b{i}-res-a")
                 .add_layer(f"b{i}-ffn", self._ffn(E, F), f"b{i}-ln-f")
                 .add_layer(f"b{i}-proj", DenseLayer(n_in=F, n_out=E, activation="identity"),
                            f"b{i}-ffn")
                 .add_vertex(f"b{i}-res-f", ElementWiseVertex(op="add"),
                             f"b{i}-res-a", f"b{i}-proj"))
            prev = f"b{i}-res-f"
        g = (g.add_layer("ln-final", LayerNormalization(n_in=E, n_out=E), prev)
             .add_layer("out", RnnOutputLayer(n_in=E, n_out=V, activation="softmax",
                                              loss="mcxent"), "ln-final")
             .set_outputs("out"))
        return g.build()


def generate_tokens(net, prompt_ids, n_tokens, temperature=1.0, seed=0,
                    advance_state=True):
    """Autoregressive sampling through the streaming state of either
    container (``rnn_time_step``): a ``TransformerLM`` through its KV
    cache (id inputs), a ``TextGenerationLSTM`` through its recurrent state
    (one-hot inputs). ``prompt_ids`` [b, T] or [T] ints -> [b, n_tokens]
    sampled ids (int64). The prompt is primed in one call; sampling is the
    JAX package's numpy loop (``np.random.default_rng(seed)``, probabilities
    floored at 1e-12, ``temperature`` -> 0 approaches greedy), so it is
    deterministic given ``seed``. ``advance_state`` also feeds the last
    sampled token, so that a caller continuing with ``rnn_time_step`` sees
    the returned history; False saves that last step."""
    prompt = np.asarray(prompt_ids)
    if prompt.ndim == 1:
        prompt = prompt[None]
    prompt = prompt.astype(np.int64)
    b = prompt.shape[0]
    if prompt.shape[1] == 0:
        raise ValueError("generate_tokens needs a non-empty prompt (the first sampling "
                         "distribution comes from the prompt's last step)")
    if int(n_tokens) <= 0:
        return np.zeros((b, 0), np.int64)
    first = (next(iter(net.conf.vertices.values())) if hasattr(net.conf, "vertices")
             else net.conf.layers[0])
    takes_ids = type(first).__name__ == "EmbeddingSequenceLayer"
    vocab = first.n_in

    def last_probs(x):
        y = net.rnn_time_step(x).float().cpu().numpy()
        return (y[:, -1, :] if y.ndim == 3 else y).astype(np.float64)     # [b, V]

    def encode(toks):
        """[b, T] ids -> a sequence input: ids [b, T, 1] (rank 3, so that the
        container takes the sequence path) or one-hot [b, T, V]."""
        if takes_ids:
            return toks[:, :, None].astype(np.float32)
        return np.eye(vocab, dtype=np.float32)[toks]

    def step(tok):
        """[b] ids -> one step: ids [b, 1] or one-hot [b, V]."""
        if takes_ids:
            return tok[:, None].astype(np.float32)
        return np.eye(vocab, dtype=np.float32)[tok]

    net.rnn_clear_previous_state()
    rng = np.random.default_rng(seed)
    probs = last_probs(encode(prompt))
    out = []
    for t in range(int(n_tokens)):
        p = np.maximum(probs, 1e-12)
        if temperature != 1.0:
            logp = np.log(p) / max(float(temperature), 1e-6)
            p = np.exp(logp - logp.max(-1, keepdims=True))
        p = p / p.sum(-1, keepdims=True)
        nxt = np.array([rng.choice(p.shape[-1], p=p[i]) for i in range(b)], dtype=np.int64)
        out.append(nxt)
        if t + 1 < int(n_tokens) or advance_state:
            probs = last_probs(step(nxt))
    return np.stack(out, axis=1)


class _NotPorted:
    """A zoo model the JAX package has and the port does not yet."""

    def __init__(self, name):
        self.name = name

    def __call__(self, **kwargs):
        raise NotImplementedError(f"zoo model '{self.name}' is not ported to "
                                  f"deeplearning4j_torch yet")


ZOO = {m.name: m for m in (LeNet, SimpleCNN, ResNet50, TextGenerationLSTM, TransformerLM)}
ZOO.update({n: _NotPorted(n) for n in ("alexnet", "vgg16", "vgg19", "googlenet",
                                        "inceptionresnetv1", "facenetnn4small2")})


class ModelSelector:
    """Reference ``zoo/ModelSelector.java``: select zoo models by name."""

    @staticmethod
    def select(name: str, **kwargs) -> ZooModel:
        key = name.lower()
        if key not in ZOO:
            raise ValueError(f"Unknown zoo model '{name}' (known: {sorted(ZOO)})")
        return ZOO[key](**kwargs)
