"""Continuous-batching serving on the slot and paged KV layouts."""
from ray_lightning_tpu_torch.serving.engine import (
    Completion,
    EngineClosed,
    EngineConfig,
    InferenceEngine,
)
from ray_lightning_tpu_torch.serving.kv_pool import KVSlotPool, Slot
from ray_lightning_tpu_torch.serving.paged_kv import (
    TRASH_BLOCK,
    BlockAllocator,
    OutOfBlocks,
    PagedKVPool,
    blocks_for,
)
from ray_lightning_tpu_torch.serving.resilience import RequestShed, ShedPolicy
from ray_lightning_tpu_torch.serving.scheduler import (
    ContinuousBatchScheduler,
    Plan,
    Request,
    RequestQueueFull,
)

__all__ = [
    "TRASH_BLOCK",
    "BlockAllocator",
    "Completion",
    "ContinuousBatchScheduler",
    "EngineClosed",
    "EngineConfig",
    "InferenceEngine",
    "KVSlotPool",
    "OutOfBlocks",
    "PagedKVPool",
    "Plan",
    "Request",
    "RequestQueueFull",
    "RequestShed",
    "ShedPolicy",
    "Slot",
    "blocks_for",
]
