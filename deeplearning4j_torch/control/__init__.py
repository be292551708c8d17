"""The closed-loop control plane: alert edges and flight events in,
actuator calls out. Counterpart of ``deeplearning4j_tpu/control/``; see
:mod:`.plane` for the state machine and :mod:`.policies` for the pack."""
from .plane import (ControlPlane, ControlPolicy, control_block,
                    get_control_plane)
from .policies import (default_control_policies, fleet_replica_policy,
                       fleet_scale_policy, probe_failure_policy,
                       serving_pressure_policy, shard_restart_policy)

__all__ = ["ControlPlane", "ControlPolicy", "get_control_plane",
           "control_block", "fleet_scale_policy", "shard_restart_policy",
           "serving_pressure_policy", "fleet_replica_policy",
           "probe_failure_policy", "default_control_policies"]
