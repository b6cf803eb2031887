"""The port's worker runtime (``ray_lightning_tpu/runtime/``): actor
processes, the object store and the queues (the native shared-memory ring
and store of ``native/``, with Python fallbacks), the zygote fork server
(``zygote.py``), the node agent; fault injection (``faults.py``, the rank
family), the hang supervisor (``supervisor.py``) and elastic membership
(``elastic.py``). Importing it starts, builds and loads nothing; :func:`init`
(or the first actor) brings it up, and the native library is built at its
first use.

Not ported (ROADMAP.md): the telemetry publishing of heartbeats."""
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
    warm_zygote,
)
from ray_lightning_tpu_torch.runtime.object_store import ObjectRef
from ray_lightning_tpu_torch.runtime.queue import (
    Queue,
    QueueClient,
    ShmQueue,
    ShmQueueHandle,
    make_queue,
)

__all__ = [
    "init", "shutdown", "is_initialized", "connect_node", "nodes",
    "plan_placement", "create_actor", "create_actors", "kill", "put", "get",
    "delete", "wait", "cluster_resources", "actor_node_id", "ActorError",
    "ActorHandle", "ActorTimeout", "CallFuture", "ObjectRef", "Queue",
    "QueueClient", "ShmQueue", "ShmQueueHandle", "make_queue", "warm_zygote",
]
