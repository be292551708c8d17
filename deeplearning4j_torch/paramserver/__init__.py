"""The parameter server (counterpart of ``deeplearning4j_tpu/paramserver/``
without ``sharded.py``): a standalone fault-tolerant server node
(:class:`ParameterServer`), a retry/backoff client with bounded-staleness
pulls (:class:`ParameterServerClient`), the asynchronous TrainingMaster
over them (:class:`ParameterServerTrainingMaster`), the comms pipeline that
hides the wire behind compute (``overlap.py``) and the metrics
(:class:`ParamServerMetricsListener`). The wire is the JAX package's, so
clients and servers of the two packages talk to each other. The sharded
fleet (``ShardedParameterServerGroup``, ``ShardedParameterServerClient``)
is ROADMAP A 15b.
"""
from .server import ParameterServer, OP_TELEMETRY, OP_PULL_DELTA, FLAG_TRACE, PROTO_VERSION
from .client import ParameterServerClient, ServerUnavailableError, ParameterServerError, Fanout
from .training import ParameterServerTrainingMaster, flatten_params, set_params_from_flat
from .metrics import (ParamServerMetrics, ParamServerMetricsListener, LatencyHistogram,
                      TrainStepPhases)
from .overlap import CommsPipeline, async_device_get

__all__ = [
    "ParameterServer", "OP_TELEMETRY", "OP_PULL_DELTA", "FLAG_TRACE",
    "PROTO_VERSION", "ParameterServerClient", "ServerUnavailableError",
    "ParameterServerError", "Fanout", "ParameterServerTrainingMaster",
    "flatten_params", "set_params_from_flat", "ParamServerMetrics",
    "ParamServerMetricsListener", "LatencyHistogram", "TrainStepPhases",
    "CommsPipeline", "async_device_get",
]
