"""Keras model import (reference ``deeplearning4j-modelimport``).

Counterpart of ``deeplearning4j_tpu/keras/``.
"""
from .model_import import KerasLayerMapper, KerasModelImport, register_custom_layer

__all__ = ["KerasModelImport", "KerasLayerMapper", "register_custom_layer"]
