"""Scene-affinity replica fleet: a fault-tolerant scheduler tier above the
dispatchers.  A :class:`FleetRouter` routes requests over N in-process
:class:`~esac_tpu_torch.serve.dispatcher.MicroBatchDispatcher` replicas --
each with its own :class:`~esac_tpu_torch.registry.serving.SceneRegistry`
and weight cache -- with scene-affinity routing, per-replica health
breakers, failover within deadlines, hot-scene replication and fleet-level
outcome accounting that sums exactly to offered.  Pure host code."""

from esac_tpu_torch.fleet.router import (
    OUTCOMES,
    FleetPolicy,
    FleetRequest,
    FleetRouter,
    Replica,
    ReplicaQuarantinedError,
)

__all__ = [
    "OUTCOMES",
    "FleetPolicy",
    "FleetRequest",
    "FleetRouter",
    "Replica",
    "ReplicaQuarantinedError",
]
