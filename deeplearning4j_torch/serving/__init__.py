"""Serving tier: continuous batching behind an HTTP front door
(counterpart of ``deeplearning4j_tpu/serving/``): the batcher with its
closed signature set, admission, precision and response cache; the
registry with the precision flip, golden sets and warmup artifacts; the
traced HTTP front door with the monitor routes."""
from .batcher import (ContinuousBatcher, DeadlineExceededError,  # noqa: F401
                      ModelNotFoundError, OverloadedError)
from .registry import ModelRegistry, ServedModel, DEFAULT_BATCH_BUCKETS  # noqa: F401
from .server import (InferenceServer, PROBE_HEADER, TRACE_HEADER,  # noqa: F401
                     parse_trace_header)

__all__ = ["ContinuousBatcher", "ModelRegistry", "ServedModel", "InferenceServer",
           "OverloadedError", "DeadlineExceededError", "ModelNotFoundError",
           "DEFAULT_BATCH_BUCKETS", "TRACE_HEADER", "PROBE_HEADER", "parse_trace_header"]
