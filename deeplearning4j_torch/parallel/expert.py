"""Expert parallelism: MoE expert parameters over an ``expert`` axis.

Counterpart of ``deeplearning4j_tpu/parallel/expert.py``. A
``MoEDenseLayer`` keeps its experts on a leading axis (``W: [E, n_in,
n_out]``); :func:`expert_rules` shards that axis over the mesh's
``expert`` dim, and :func:`expert_parallel_step` is
:func:`~.tensor.tensor_parallel_step` with those rules: each slot holds
its experts' block of ``W``/``b`` and of their updater state, and runs
the updater on that block; the router ``Wg`` stays replicated. As for the
tensor-parallel matmuls, the forward and backward run on the gathered
``W`` on the network's device: the combine's reduction over the experts
is not partitioned across the slots.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

from .mesh import EXPERT_AXIS, Mesh, P
from .tensor import tensor_parallel_step

__all__ = ["EXPERT_AXIS", "expert_rules", "expert_parallel_step"]


def expert_rules(net, axis: str = EXPERT_AXIS) -> Dict[str, P]:
    """{parameter-path regex: spec} sharding every MoE layer's expert dim;
    the router (``Wg``) stays replicated."""
    rules: Dict[str, P] = {}
    layers = getattr(net.conf, "layers", None)
    it = ([(str(i), l) for i, l in enumerate(layers)] if layers is not None
          else list(net.conf.vertices.items()))
    for key, layer in it:
        if type(layer).__name__ == "MoEDenseLayer":
            k = re.escape(key)
            rules[rf"^{k}/W$"] = P(axis, None, None)
            rules[rf"^{k}/b$"] = P(axis, None)
    return rules


def expert_parallel_step(net, mesh: Mesh, extra_rules: Optional[Dict[str, P]] = None,
                         axis: str = EXPERT_AXIS):
    """The network's step with expert shardings (and data parallelism over
    ``data`` when the mesh has that axis): ``(step, place)`` as
    :func:`~.tensor.tensor_parallel_step`."""
    rules = expert_rules(net, axis)
    if extra_rules:
        rules.update(extra_rules)
    return tensor_parallel_step(net, mesh, rules=rules, style="expert/step")
