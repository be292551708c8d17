"""Serving tier: continuous batching behind an HTTP front door."""
from .batcher import (ContinuousBatcher, DeadlineExceededError,  # noqa: F401
                      ModelNotFoundError, OverloadedError)
from .registry import ModelRegistry, ServedModel  # noqa: F401
from .server import InferenceServer  # noqa: F401

__all__ = ["ContinuousBatcher", "DeadlineExceededError", "ModelNotFoundError",
           "OverloadedError", "ModelRegistry", "ServedModel", "InferenceServer"]
