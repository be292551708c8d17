"""deeplearning4j_torch: the PyTorch/CUDA port of deeplearning4j_tpu.

The JAX package beside this one is the reference; module paths and names
here mirror it, so ``deeplearning4j_tpu/ops/lstm_cell.py`` has its
counterpart in ``deeplearning4j_torch/ops/lstm_cell.py``. The port imports
``torch`` and nothing of JAX or of the JAX package.

Every entry point runs on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; with no card present it raises instead of falling
back. Kernel wrappers launch their CUDA kernel for CUDA tensors and take
their plain PyTorch version only for CPU tensors.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "NeuralNetConfiguration", "CacheMode", "MultiLayerNetwork",
           "ComputationGraph", "InferenceServer", "ModelRegistry", "ServedModel", "DataSet",
           "MultiDataSet", "DataSetIterator", "ListDataSetIterator", "PrefetchDataSetIterator",
           "ShapeBucketingDataSetIterator", "NormalizerStandardize", "NormalizerMinMaxScaler",
           "ImagePreProcessingScaler", "LossFunction", "Sgd", "Adam", "AdaMax", "Nadam",
           "Nesterovs", "RmsProp", "AdaGrad", "AdaDelta", "NoOp", "AMSGrad"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, checked: ``"cuda"`` (the
    default everywhere in the port) raises when no CUDA device is present;
    the CPU is used only when asked for by name."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deeplearning4j_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


from .datasets.dataset import (DataSet, DataSetIterator, ListDataSetIterator,  # noqa: E402
                               MultiDataSet)
from .datasets.prefetch import PrefetchDataSetIterator  # noqa: E402
from .datasets.bucketing import ShapeBucketingDataSetIterator  # noqa: E402
from .datasets.normalizers import (ImagePreProcessingScaler,  # noqa: E402
                                   NormalizerMinMaxScaler, NormalizerStandardize)
from .nn.conf import CacheMode, NeuralNetConfiguration  # noqa: E402
from .nn.losses import LossFunction  # noqa: E402
from .nn.updaters import (AdaDelta, AdaGrad, AdaMax, Adam, AMSGrad, Nadam,  # noqa: E402
                          Nesterovs, NoOp, RmsProp, Sgd)
from .nn.multilayer import MultiLayerNetwork  # noqa: E402
from .nn.graph import ComputationGraph  # noqa: E402
from .serving import InferenceServer, ModelRegistry, ServedModel  # noqa: E402
