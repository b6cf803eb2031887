"""What a data-parallel strategy shards (``ray_lightning_tpu/parallel/
sharding.py``, its ``ShardingPolicy`` only). The JAX package hands the
policy to XLA as shardings over a device mesh; the port's strategies read
``zero_stage`` and run the collectives themselves
(``parallel/data_parallel.py``), one rank per process."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ShardingPolicy:
    """``zero_stage``:
      0: parameters and optimizer state replicated, gradients all-reduced
         (DDP);
      1: each rank keeps only its shard of the optimizer state;
      2: and the gradients are reduce-scattered;
      3: and the parameters are kept sharded between steps, all-gathered
         for each step (FSDP).
    ``data_axes``, ``shard_axes`` and ``min_shard_size`` are the JAX
    policy's fields; the port has one data axis, ranks over processes, and
    shards one flat buffer per parameter group, so only the default axes
    are accepted and ``min_shard_size`` does not apply."""

    zero_stage: int = 0
    data_axes: Tuple[str, ...] = ("dp",)
    shard_axes: Tuple[str, ...] = ()
    min_shard_size: int = 2 ** 14

    def __post_init__(self):
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(
                f"zero_stage={self.zero_stage}: expected 0, 1, 2 or 3")
        if tuple(self.data_axes) != ("dp",) or tuple(self.shard_axes) not in (
                (), ("dp",)):
            raise NotImplementedError(
                f"data_axes={self.data_axes}, shard_axes={self.shard_axes}: "
                "the port has one data axis over processes ('dp'); device "
                "meshes with more axes are not ported yet (ROADMAP.md, queue "
                "1 item 9: the parallelism layer)")

    @staticmethod
    def ddp() -> "ShardingPolicy":
        return ShardingPolicy(zero_stage=0)
