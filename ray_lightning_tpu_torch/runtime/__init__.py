"""The port's worker runtime (``ray_lightning_tpu/runtime/``): actor
processes, the object store, the queue and the node agent. Importing it
starts nothing; :func:`init` (or the first actor) brings it up.

Not ported (each refuses, see ROADMAP.md): the native shared-memory queue
and store (``runtime/native/``), the zygote fork server, fault injection,
elastic membership, the supervisor and telemetry publishing."""
from ray_lightning_tpu_torch.runtime.actor import (
    ActorError,
    ActorHandle,
    ActorTimeout,
    CallFuture,
)
from ray_lightning_tpu_torch.runtime.api import (
    actor_node_id,
    cluster_resources,
    connect_node,
    create_actor,
    create_actors,
    delete,
    get,
    init,
    is_initialized,
    kill,
    nodes,
    plan_placement,
    put,
    shutdown,
    wait,
)
from ray_lightning_tpu_torch.runtime.object_store import ObjectRef
from ray_lightning_tpu_torch.runtime.queue import (
    Queue,
    QueueClient,
    ShmQueue,
    make_queue,
)

__all__ = [
    "init", "shutdown", "is_initialized", "connect_node", "nodes",
    "plan_placement", "create_actor", "create_actors", "kill", "put", "get",
    "delete", "wait", "cluster_resources", "actor_node_id", "ActorError",
    "ActorHandle", "ActorTimeout", "CallFuture", "ObjectRef", "Queue",
    "QueueClient", "ShmQueue", "make_queue",
]
