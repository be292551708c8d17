"""Tensor (model) parallelism: parameter sharding rules over the ``model``
axis.

Counterpart of ``deeplearning4j_tpu/parallel/tensor.py``.
:func:`megatron_rules` gives the classic pairing (even layers split the
output dim, odd layers the input dim; attention's Wq/Wk/Wv split the head
dim and Wo its input dim). The JAX package annotates the parameters and
lets XLA's partitioner split the work; ``torch.distributed.tensor`` needs
a process group, which an in-process mesh does not have, so here the
rules decide what each slot holds (``sharding.ShardedModel``: its block
of each parameter's updater state, and under ``shard_params`` of the
parameter) and the step reassembles the blocks as the rules say
(``sharding.SyncStep``).
"""
from __future__ import annotations

import re
from typing import Dict, Optional

from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, P, require_axes, rule_shardings)
from .sharding import SyncStep

__all__ = ["megatron_rules", "param_shardings", "tensor_parallel_step"]


def megatron_rules(net, axis: str = MODEL_AXIS) -> Dict[str, P]:
    """Alternating column/row parallel specs for the network's dense-family
    parameters, {parameter-path regex: spec}, for both containers (the JAX
    package's rules, vertex by vertex in builder order on a graph)."""
    rules: Dict[str, P] = {}
    layers = getattr(net.conf, "layers", None)
    if layers is not None:                     # MultiLayerNetwork
        for i, _ in enumerate(layers):
            if i % 2 == 0:
                rules[rf"^{i}/W$"] = P(None, axis)
                rules[rf"^{i}/b$"] = P(axis)
            else:
                rules[rf"^{i}/W$"] = P(axis, None)
                rules[rf"^{i}/b$"] = P()
        return rules
    parity = 0                                 # ComputationGraph
    for name, v in net.conf.vertices.items():
        k = re.escape(name)
        tname = type(v).__name__
        if tname == "SelfAttentionLayer":
            rules[rf"^{k}/W[qkv]$"] = P(None, axis)
            rules[rf"^{k}/Wo$"] = P(axis, None)
            rules[rf"^{k}/b$"] = P()
            parity = 0
        elif tname in ("DenseLayer", "OutputLayer", "RnnOutputLayer"):
            if parity % 2 == 0:
                rules[rf"^{k}/W$"] = P(None, axis)
                rules[rf"^{k}/b$"] = P(axis)
            else:
                rules[rf"^{k}/W$"] = P(axis, None)
                rules[rf"^{k}/b$"] = P()
            parity += 1
        elif tname == "MoEDenseLayer":
            if parity % 2 == 0:
                rules[rf"^{k}/W$"] = P(None, None, axis)
                rules[rf"^{k}/b$"] = P(None, axis)
            else:
                rules[rf"^{k}/W$"] = P(None, axis, None)
                rules[rf"^{k}/b$"] = P()
            parity += 1
    return rules


def param_shardings(params, mesh: Mesh, rules: Dict[str, P]):
    """Sharding tree for ``params`` from path-regex rules."""
    return rule_shardings(params, mesh, rules)


def tensor_parallel_step(net, mesh: Mesh, rules: Optional[Dict[str, P]] = None,
                         shard_update: bool = False,
                         shard_params: bool = False, style: str = "tensor/step"):
    """The network's step with the rules' parameter shardings (and data
    parallelism over ``data`` when the mesh has that axis). Returns
    ``(step, place)``: ``place(net)`` splits the model state over the
    slots, ``step(f, l, fm=None, lm=None)`` takes one update on a whole
    batch and returns its loss. ``shard_update``/``shard_params`` layer
    ZeRO over the mesh's ``data`` axis on the rules."""
    if rules is None:
        rules = megatron_rules(net)
    if shard_update or shard_params:
        require_axes(mesh, (DATA_AXIS,), style="tensor_parallel_step ZeRO")
    step = SyncStep(net, mesh, DATA_AXIS, shard_update=shard_update,
                    shard_params=shard_params, tp_rules=rules, style=style)

    def place(model):
        if model is not net:
            raise ValueError("place() takes the network the step was built for")
        step.place()

    return step, place
