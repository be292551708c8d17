"""Hand-written CUDA kernels and their plain PyTorch versions, and the
host-side native library (``native``: the gradient wire codec, built from
``native/dl4jtpu_native.cpp`` at first use)."""
from . import native

__all__ = ["native"]
