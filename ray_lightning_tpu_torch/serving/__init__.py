"""Continuous-batching serving on the slot and paged KV layouts: the
engine, its pools and scheduler, tenancy (per-tenant DRR, quotas, shed
classes), KV shipments between a prefill and a decode engine, the
resilience pieces (request journal, circuit breaker, shed policy,
preemption drain), and the fleet of replicas over them (in-process or as
actors, with routing, recovery, migration and autoscaling)."""
from ray_lightning_tpu_torch.serving.engine import (
    Completion,
    EngineClosed,
    EngineConfig,
    InferenceEngine,
)
from ray_lightning_tpu_torch.serving.kv_pool import KVSlotPool, Slot
from ray_lightning_tpu_torch.serving.migration import (
    KVShipment,
    MigrationPolicy,
    MigrationRejected,
    MigrationStats,
    ShipmentCorrupt,
    ShipmentError,
    ShipmentMismatch,
    build_shipment,
    kv_fingerprint,
    verify_shipment,
)
from ray_lightning_tpu_torch.serving.paged_kv import (
    TRASH_BLOCK,
    BlockAllocation,
    BlockAllocator,
    OutOfBlocks,
    PagedKVPool,
    blocks_for,
)
from ray_lightning_tpu_torch.serving.replica import (
    Autoscaler,
    CapacityBlocked,
    LocalReplicaFleet,
    ReplicaGroup,
    ServeFuture,
    ServeReplicaActor,
    autoscale_decision,
    needs_relaunch,
    pick_least_loaded,
)
from ray_lightning_tpu_torch.serving.resilience import (
    CircuitBreaker,
    JournalEntry,
    RequestJournal,
    RequestShed,
    ShedPolicy,
    install_sigterm_drain,
)
from ray_lightning_tpu_torch.serving.scheduler import (
    ContinuousBatchScheduler,
    Plan,
    Request,
    RequestQueueFull,
)
from ray_lightning_tpu_torch.serving.tenancy import (
    QuotaExceeded,
    TenantRegistry,
    TenantSpec,
    TokenBucket,
    parse_tenant_specs,
)

__all__ = [
    "TRASH_BLOCK",
    "Autoscaler",
    "BlockAllocation",
    "BlockAllocator",
    "CapacityBlocked",
    "CircuitBreaker",
    "Completion",
    "ContinuousBatchScheduler",
    "EngineClosed",
    "EngineConfig",
    "InferenceEngine",
    "JournalEntry",
    "KVShipment",
    "KVSlotPool",
    "LocalReplicaFleet",
    "MigrationPolicy",
    "MigrationRejected",
    "MigrationStats",
    "OutOfBlocks",
    "PagedKVPool",
    "Plan",
    "QuotaExceeded",
    "Request",
    "RequestJournal",
    "RequestQueueFull",
    "ReplicaGroup",
    "RequestShed",
    "ServeFuture",
    "ServeReplicaActor",
    "ShedPolicy",
    "ShipmentCorrupt",
    "ShipmentError",
    "ShipmentMismatch",
    "Slot",
    "TenantRegistry",
    "TenantSpec",
    "TokenBucket",
    "autoscale_decision",
    "blocks_for",
    "build_shipment",
    "install_sigterm_drain",
    "kv_fingerprint",
    "needs_relaunch",
    "parse_tenant_specs",
    "pick_least_loaded",
    "verify_shipment",
]
