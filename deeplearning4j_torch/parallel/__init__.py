"""Parallelism and distribution (reference ``deeplearning4j-scaleout/``).

Counterpart of ``deeplearning4j_tpu/parallel/``: the mesh substrate (``mesh.py``: MeshSpec, an in-process grid of slots,
each a :class:`torch.device`), the data-parallel steps (``sharding.py``),
ParallelWrapper and ParallelInference, gradient accumulation and the
threshold codec, the update transport and the TrainingMaster SPI over
``torch.distributed``, and the model-family axes: tensor (``model``),
sequence (ring and Ulysses attention on the flash kernels K5-K7),
pipeline (GPipe over ``pipe``: ``pipeline.py``) and expert (MoE over
``expert``) parallelism.
"""
from .mesh import (MeshSpec, mesh_block, require_axes, zero_update_specs, P, Sharding,
                   EXPERT_AXIS)
from .sharding import (DATA_AXIS, MODEL_AXIS, SEQUENCE_AXIS, make_mesh, replicated,
                       batch_sharded, shard_batch, data_parallel_step)
from .wrapper import ParallelWrapper, TrainingMode
from .inference import ParallelInference, InferenceMode
from .accumulation import (GradientsAccumulator, EncodedGradientsAccumulator,
                           EncodingHandler, threshold_encode, threshold_decode,
                           serialize_encoded, deserialize_encoded)
from .transport import UpdateChannel, PeerFailedError
from .distributed import (ProcessLocalIterator, is_chief, TrainingMaster,
                          ParameterAveragingTrainingMaster, SharedTrainingMaster,
                          SharedGradientsClusterTrainer, DistributedMultiLayerNetwork,
                          DistributedComputationGraph, SparkDl4jMultiLayer,
                          SparkComputationGraph, initialize_distributed,
                          allgather_objects, DistributedDataSetLossCalculator,
                          DistributedEarlyStoppingTrainer)
from .sequence import (ring_attention, ulysses_attention, full_attention,
                       ring_flash_attention, ring_flash_supported,
                       ulysses_flash_attention, ulysses_flash_supported,
                       sequence_parallel_step, sp_attend, current_sp_axis)
from .tensor import megatron_rules, tensor_parallel_step, param_shardings
from .pipeline import (PIPELINE_AXIS, GPipe, spmd_pipeline, PipelinedNetwork, PipelinedGraph,
                       pipeline_parallel_step, partition_network, partition_graph,
                       stack_stage_params)
from .expert import expert_rules, expert_parallel_step

__all__ = [
    "MeshSpec", "mesh_block", "require_axes", "zero_update_specs",
    "DATA_AXIS", "MODEL_AXIS", "SEQUENCE_AXIS", "make_mesh", "replicated",
    "batch_sharded", "shard_batch", "data_parallel_step",
    "ParallelWrapper", "TrainingMode", "ParallelInference", "InferenceMode",
    "GradientsAccumulator", "EncodedGradientsAccumulator", "EncodingHandler",
    "threshold_encode", "threshold_decode", "serialize_encoded",
    "deserialize_encoded", "UpdateChannel", "PeerFailedError",
    "SharedGradientsClusterTrainer",
    "TrainingMaster", "ParameterAveragingTrainingMaster", "SharedTrainingMaster",
    "DistributedMultiLayerNetwork", "DistributedComputationGraph",
    "SparkDl4jMultiLayer", "SparkComputationGraph", "initialize_distributed",
    "ProcessLocalIterator", "is_chief",
    "ring_attention", "ulysses_attention", "full_attention",
    "ulysses_flash_attention", "ulysses_flash_supported",
    "ring_flash_attention", "ring_flash_supported",
    "sequence_parallel_step",
    "megatron_rules", "tensor_parallel_step", "param_shardings",
    "PIPELINE_AXIS", "GPipe", "spmd_pipeline", "stack_stage_params",
    "PipelinedNetwork", "PipelinedGraph", "pipeline_parallel_step",
    "partition_network", "partition_graph",
    "EXPERT_AXIS", "expert_rules", "expert_parallel_step",
    "allgather_objects", "DistributedDataSetLossCalculator",
    "DistributedEarlyStoppingTrainer",
]
