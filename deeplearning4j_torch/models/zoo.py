"""Model zoo: standard architectures as config builders.

Counterpart of ``deeplearning4j_tpu/models/zoo.py``: the ``ZooModel`` base
(``conf``, ``init``, ``_builder``, ``_inception``), ``LeNet``,
``SimpleCNN``, ``AlexNet``, ``VGG16``, ``VGG19``, ``GoogLeNet``,
``ResNet50``, ``InceptionResNetV1``, ``FaceNetNN4Small2``,
``TextGenerationLSTM`` and ``TransformerLM`` (dense or MoE), with the JAX
package's layer and vertex names, widths, modes and updaters, so that its
configuration JSON is written byte for byte and the keypaths of its zips
match; ``generate_tokens``, the sampling loop over either container's
``rnn_time_step``; and ``ModelSelector``, which selects every name the JAX
package's does. Pretrained weights are not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..nn.conf import InputType, MultiLayerConfiguration, NeuralNetConfiguration
from ..nn.conf.graph import ElementWiseVertex, MergeVertex, ScaleVertex
from ..nn.conf.layers import (ActivationLayer, BatchNormalization, CenterLossOutputLayer,
                              ConvolutionLayer, ConvolutionMode, DenseLayer, DropoutLayer,
                              EmbeddingSequenceLayer, GlobalPoolingLayer, GravesLSTM,
                              LayerNormalization, LocalResponseNormalization, MoEDenseLayer,
                              OutputLayer, PoolingType, RnnOutputLayer, SelfAttentionLayer,
                              SubsamplingLayer)
from ..nn.graph import ComputationGraph
from ..nn.multilayer import MultiLayerNetwork
from ..nn.updaters import Adam, Nesterovs

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19", "GoogLeNet",
           "ResNet50", "InceptionResNetV1", "FaceNetNN4Small2", "TextGenerationLSTM",
           "TransformerLM", "generate_tokens", "ZOO", "ModelSelector"]


def _max_pool_3_2(mode):
    """The zoo's 3x3 stride-2 max pool (AlexNet's Truncate, the others' Same)."""
    return SubsamplingLayer(pooling_type=PoolingType.MAX, kernel_size=(3, 3), stride=(2, 2),
                            convolution_mode=mode)


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

    def _inception(self, g, name, inp, c1, r3, c3, r5, c5, pp):
        """A GoogLeNet inception module (GoogLeNet's and FaceNetNN4Small2's):
        1x1, 1x1 -> 3x3, 1x1 -> 5x5 and max pool 3/1 -> 1x1 branches, all
        SAME, merged on the channel axis."""
        same = ConvolutionMode.Same
        g.add_layer(f"{name}-1x1", ConvolutionLayer(n_out=c1, kernel_size=(1, 1),
                                                    convolution_mode=same), inp)
        g.add_layer(f"{name}-3x3r", ConvolutionLayer(n_out=r3, kernel_size=(1, 1),
                                                     convolution_mode=same), inp)
        g.add_layer(f"{name}-3x3", ConvolutionLayer(n_out=c3, kernel_size=(3, 3),
                                                    convolution_mode=same), f"{name}-3x3r")
        g.add_layer(f"{name}-5x5r", ConvolutionLayer(n_out=r5, kernel_size=(1, 1),
                                                     convolution_mode=same), inp)
        g.add_layer(f"{name}-5x5", ConvolutionLayer(n_out=c5, kernel_size=(5, 5),
                                                    convolution_mode=same), f"{name}-5x5r")
        g.add_layer(f"{name}-pool", SubsamplingLayer(
            pooling_type=PoolingType.MAX, kernel_size=(3, 3), stride=(1, 1),
            convolution_mode=same), inp)
        g.add_layer(f"{name}-poolproj", ConvolutionLayer(
            n_out=pp, kernel_size=(1, 1), convolution_mode=same), f"{name}-pool")
        g.add_vertex(name, MergeVertex(), f"{name}-1x1", f"{name}-3x3", f"{name}-5x5",
                     f"{name}-poolproj")
        return name


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


class AlexNet(ZooModel):
    """Reference ``zoo/model/AlexNet.java`` (one tower; a MultiLayerNetwork):
    224x224x3 -> conv96-11/4 -> LRN -> max 3/2 -> conv256-5 -> LRN -> max
    3/2 -> conv384-3 x 2 -> conv256-3 -> max 3/2 -> dense4096 (dropout 0.5)
    x 2 -> softmax, under Nesterovs(1e-2, 0.9)."""

    name = "alexnet"
    input_shape = (3, 224, 224)

    def conf(self):
        c, h, w = self.input_shape
        return (self._builder(updater=Nesterovs(learning_rate=1e-2, momentum=0.9))
                .list()
                .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11), stride=(4, 4),
                                        padding=(3, 3)))
                .layer(LocalResponseNormalization())
                .layer(_max_pool_3_2(ConvolutionMode.Truncate))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5), stride=(1, 1),
                                        padding=(2, 2)))
                .layer(LocalResponseNormalization())
                .layer(_max_pool_3_2(ConvolutionMode.Truncate))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3), padding=(1, 1)))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3), padding=(1, 1)))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3), padding=(1, 1)))
                .layer(_max_pool_3_2(ConvolutionMode.Truncate))
                .layer(DenseLayer(n_out=4096, dropout=0.5))
                .layer(DenseLayer(n_out=4096, dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class VGG16(ZooModel):
    """Reference ``zoo/model/VGG16.java`` (a MultiLayerNetwork): SAME 3x3
    convolution stacks of (2, 2, 3, 3, 3) layers, 64-128-256-512-512 wide,
    each followed by max 2/2, then dense4096 x 2 -> softmax: 138,357,544
    parameters at 224x224x3 and 1000 classes."""

    name = "vgg16"
    input_shape = (3, 224, 224)
    block_convs = (2, 2, 3, 3, 3)

    def conf(self):
        c, h, w = self.input_shape
        b = self._builder().list()
        for width, n_convs in zip((64, 128, 256, 512, 512), self.block_convs):
            for _ in range(n_convs):
                b.layer(ConvolutionLayer(n_out=width, kernel_size=(3, 3),
                                         convolution_mode=ConvolutionMode.Same))
            b.layer(SubsamplingLayer(pooling_type=PoolingType.MAX, kernel_size=(2, 2),
                                     stride=(2, 2)))
        return (b.layer(DenseLayer(n_out=4096))
                .layer(DenseLayer(n_out=4096))
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class VGG19(VGG16):
    """Reference ``zoo/model/VGG19.java``: stacks of (2, 2, 4, 4, 4)
    convolutions (143,667,240 parameters)."""

    name = "vgg19"
    block_convs = (2, 2, 4, 4, 4)


class GoogLeNet(ZooModel):
    """Reference ``zoo/model/GoogLeNet.java`` (Inception v1; a
    ComputationGraph): stem (conv7/2, max 3/2, LRN, conv1, conv3, LRN, max
    3/2), nine inception modules with max 3/2 after 3b and 4e, global
    average pool, DropoutLayer(0.6), softmax; every convolution and pool
    SAME."""

    name = "googlenet"
    input_shape = (3, 224, 224)
    # (name, 1x1, 3x3 reduce, 3x3, 5x5 reduce, 5x5, pool projection)
    MODULES = [
        ("3a", 64, 96, 128, 16, 32, 32),
        ("3b", 128, 128, 192, 32, 96, 64),
        ("4a", 192, 96, 208, 16, 48, 64),
        ("4b", 160, 112, 224, 24, 64, 64),
        ("4c", 128, 128, 256, 24, 64, 64),
        ("4d", 112, 144, 288, 32, 64, 64),
        ("4e", 256, 160, 320, 32, 128, 128),
        ("5a", 256, 160, 320, 32, 128, 128),
        ("5b", 384, 192, 384, 48, 128, 128),
    ]
    POOL_AFTER = {"3b", "4e"}

    def conf(self):
        c, h, w = self.input_shape
        same = ConvolutionMode.Same
        g = (self._builder().graph_builder()
             .add_inputs("input")
             .add_layer("stem-conv", ConvolutionLayer(
                 n_out=64, kernel_size=(7, 7), stride=(2, 2), convolution_mode=same), "input")
             .add_layer("stem-pool", _max_pool_3_2(same), "stem-conv")
             .add_layer("stem-lrn", LocalResponseNormalization(), "stem-pool")
             .add_layer("stem-conv2", ConvolutionLayer(
                 n_out=64, kernel_size=(1, 1), convolution_mode=same), "stem-lrn")
             .add_layer("stem-conv3", ConvolutionLayer(
                 n_out=192, kernel_size=(3, 3), convolution_mode=same), "stem-conv2")
             .add_layer("stem-lrn2", LocalResponseNormalization(), "stem-conv3")
             .add_layer("stem-pool2", _max_pool_3_2(same), "stem-lrn2"))
        prev = "stem-pool2"
        for name, c1, r3, c3, r5, c5, pp in self.MODULES:
            prev = self._inception(g, f"inc{name}", prev, c1, r3, c3, r5, c5, pp)
            if name in self.POOL_AFTER:
                g.add_layer(f"pool-{name}", _max_pool_3_2(same), prev)
                prev = f"pool-{name}"
        g.add_layer("gap", GlobalPoolingLayer(pooling_type=PoolingType.AVG), prev)
        g.add_layer("dropout", DropoutLayer(dropout=0.6), "gap")
        g.add_layer("output", OutputLayer(n_out=self.num_classes, activation="softmax",
                                          loss="mcxent"), "dropout")
        g.set_outputs("output")
        g.set_input_types(InputType.convolutional(h, w, c))
        return g.build()


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


class InceptionResNetV1(ZooModel):
    """Reference ``zoo/model/InceptionResNetV1.java`` (a ComputationGraph):
    stem (conv32-3/2, conv64-3, max 3/2, conv80-1, conv192-3, conv256-3/2),
    ``blocks_a`` residual inception blocks A (256 wide, scale 0.17), max 3/2
    and conv896-1, ``blocks_b`` blocks B (896, the 1x7 and 7x1 kernels,
    0.10), max 3/2 and conv1792-1, ``blocks_c`` blocks C (1792, 1x3 and
    3x1, 0.20), global average pool, softmax; every convolution and pool
    SAME. A block: its branches merged, a 1x1 identity projection back to
    the block's width, a ScaleVertex, the add to the block's input, relu."""

    name = "inceptionresnetv1"
    input_shape = (3, 160, 160)

    def __init__(self, num_classes: int = 1000, seed: int = 123, blocks_a: int = 5,
                 blocks_b: int = 10, blocks_c: int = 5, **kw):
        super().__init__(num_classes, seed, **kw)
        self.blocks = (blocks_a, blocks_b, blocks_c)

    def _conv(self, g, name, inp, n_out, k, stride=(1, 1)):
        g.add_layer(name, ConvolutionLayer(n_out=n_out, kernel_size=k, stride=stride,
                                           convolution_mode=ConvolutionMode.Same), inp)
        return name

    def _res_block(self, g, name, inp, branches, n_channels, scale):
        outs = []
        for i, branch in enumerate(branches):
            prev = inp
            for j, (n_out, k) in enumerate(branch):
                prev = self._conv(g, f"{name}-br{i}-{j}", prev, n_out, k)
            outs.append(prev)
        g.add_vertex(f"{name}-merge", MergeVertex(), *outs)
        g.add_layer(f"{name}-proj", ConvolutionLayer(
            n_out=n_channels, kernel_size=(1, 1), activation="identity",
            convolution_mode=ConvolutionMode.Same), f"{name}-merge")
        g.add_vertex(f"{name}-scale", ScaleVertex(scale=scale), f"{name}-proj")
        g.add_vertex(f"{name}-add", ElementWiseVertex(op="add"), inp, f"{name}-scale")
        g.add_layer(name, ActivationLayer(activation="relu"), f"{name}-add")
        return name

    def conf(self):
        c, h, w = self.input_shape
        same = ConvolutionMode.Same
        g = self._builder().graph_builder().add_inputs("input")
        prev = self._conv(g, "stem1", "input", 32, (3, 3), (2, 2))
        prev = self._conv(g, "stem2", prev, 64, (3, 3))
        g.add_layer("stem-pool", _max_pool_3_2(same), prev)
        prev = self._conv(g, "stem3", "stem-pool", 80, (1, 1))
        prev = self._conv(g, "stem4", prev, 192, (3, 3))
        prev = self._conv(g, "stem5", prev, 256, (3, 3), (2, 2))
        a, b, cc = self.blocks
        for i in range(a):
            prev = self._res_block(g, f"A{i}", prev,
                                   [[(32, (1, 1))],
                                    [(32, (1, 1)), (32, (3, 3))],
                                    [(32, (1, 1)), (32, (3, 3)), (32, (3, 3))]], 256, 0.17)
        g.add_layer("redA-pool", _max_pool_3_2(same), prev)
        prev = self._conv(g, "redA-conv", "redA-pool", 896, (1, 1))
        for i in range(b):
            prev = self._res_block(g, f"B{i}", prev,
                                   [[(128, (1, 1))],
                                    [(128, (1, 1)), (128, (1, 7)), (128, (7, 1))]], 896, 0.10)
        g.add_layer("redB-pool", _max_pool_3_2(same), prev)
        prev = self._conv(g, "redB-conv", "redB-pool", 1792, (1, 1))
        for i in range(cc):
            prev = self._res_block(g, f"C{i}", prev,
                                   [[(192, (1, 1))],
                                    [(192, (1, 1)), (192, (1, 3)), (192, (3, 1))]], 1792, 0.20)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type=PoolingType.AVG), prev)
        g.add_layer("output", OutputLayer(n_out=self.num_classes, activation="softmax",
                                          loss="mcxent"), "gap")
        g.set_outputs("output")
        g.set_input_types(InputType.convolutional(h, w, c))
        return g.build()


class FaceNetNN4Small2(ZooModel):
    """Reference ``zoo/model/FaceNetNN4Small2.java`` (a ComputationGraph),
    trained by center loss: stem (conv64-7/2, max 3/2, LRN, conv64-1,
    conv192-3, LRN, max 3/2; all SAME), two inception modules, global
    average pool, an identity dense ``embedding_size`` embedding, and a
    CenterLossOutputLayer softmax."""

    name = "facenetnn4small2"
    input_shape = (3, 96, 96)

    def __init__(self, num_classes: int = 1000, embedding_size: int = 128, seed: int = 123,
                 **kw):
        super().__init__(num_classes, seed, **kw)
        self.embedding_size = embedding_size

    def conf(self):
        c, h, w = self.input_shape
        same = ConvolutionMode.Same
        g = (self._builder().graph_builder()
             .add_inputs("input")
             .add_layer("conv1", ConvolutionLayer(
                 n_out=64, kernel_size=(7, 7), stride=(2, 2), convolution_mode=same), "input")
             .add_layer("pool1", _max_pool_3_2(same), "conv1")
             .add_layer("lrn1", LocalResponseNormalization(), "pool1")
             .add_layer("conv2", ConvolutionLayer(
                 n_out=64, kernel_size=(1, 1), convolution_mode=same), "lrn1")
             .add_layer("conv3", ConvolutionLayer(
                 n_out=192, kernel_size=(3, 3), convolution_mode=same), "conv2")
             .add_layer("lrn2", LocalResponseNormalization(), "conv3")
             .add_layer("pool2", _max_pool_3_2(same), "lrn2"))
        prev = "pool2"
        for name, (c1, r3, c3, r5, c5, pp) in (("inc1", (64, 96, 128, 16, 32, 32)),
                                                ("inc2", (64, 96, 128, 32, 64, 64))):
            prev = self._inception(g, name, prev, c1, r3, c3, r5, c5, pp)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type=PoolingType.AVG), prev)
        g.add_layer("embedding", DenseLayer(n_out=self.embedding_size, activation="identity"),
                    "gap")
        g.add_layer("output", CenterLossOutputLayer(
            n_in=self.embedding_size, n_out=self.num_classes, activation="softmax",
            loss="mcxent"), "embedding")
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


ZOO = {m.name: m for m in (LeNet, SimpleCNN, AlexNet, VGG16, VGG19, GoogLeNet, ResNet50,
                           InceptionResNetV1, FaceNetNN4Small2, TextGenerationLSTM,
                           TransformerLM)}


class ModelSelector:
    """Reference ``zoo/ModelSelector.java``: select zoo models by name."""

    @staticmethod
    def select(name: str, **kwargs) -> ZooModel:
        key = name.lower()
        if key not in ZOO:
            raise ValueError(f"Unknown zoo model '{name}' (known: {sorted(ZOO)})")
        return ZOO[key](**kwargs)
