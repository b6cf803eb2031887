"""Strategies (``ray_lightning_tpu/strategies/base.py``): what a Trainer's
step does across ranks. ``Strategy`` is the base, one process and one rank,
with the multi-rank surface the Trainer reads (world size, ranks,
``is_global_zero``, ``distributed_sampler_kwargs``, ``barrier``,
``broadcast_host``, ``global_batch_size``); ``SingleDeviceStrategy`` is the
one-device strategy. The strategies over several processes are in
``strategies/ray_strategies.py``.

A strategy places nothing itself, since the Trainer owns its device; it
carries the input pipeline's two settings, validated as the JAX strategy
validates them."""
from __future__ import annotations

from typing import Any, Dict, Optional


class Strategy:
    """One process, one rank; no launcher (the Trainer runs its stages in
    its own process) and no collectives."""

    strategy_name = "base"
    zero_stage = 0

    def __init__(self, prefetch_depth: int = 2,
                 loader_num_workers: Optional[int] = None,
                 telemetry: Optional[bool] = None):
        """``prefetch_depth``: how many batches beyond the one being trained
        have their host-to-device copies issued ahead (``core/prefetch.py``,
        ``DevicePrefetcher``); each costs one resident batch on the device,
        and 0 is the synchronous path. ``loader_num_workers``: background
        threads assembling host batches (``AsyncLoader``); ``None`` defers
        to the loader's own ``num_workers`` (else one feeder thread), 0
        keeps host loading on the training thread. ``telemetry``: see
        :attr:`telemetry`."""
        prefetch_depth = int(prefetch_depth)
        if prefetch_depth < 0:
            raise ValueError(
                f"prefetch_depth must be >= 0, got {prefetch_depth}"
            )
        if loader_num_workers is not None:
            loader_num_workers = int(loader_num_workers)
            if loader_num_workers < 0:
                raise ValueError(
                    f"loader_num_workers must be >= 0, got {loader_num_workers}"
                )
        self.prefetch_depth = prefetch_depth
        self.loader_num_workers = loader_num_workers
        self._telemetry = telemetry

    @property
    def launcher(self):
        return None

    @property
    def telemetry(self) -> bool:
        """Whether the flight recorder is on (spans and metrics, shipped to
        the main process's aggregator on the heartbeats; see
        ``observability/``). Off by default: the instrumented paths reduce
        to one attribute check. The constructor argument wins, else the
        ``TORCHRT_TELEMETRY`` variable (``1``/``true``/``yes``/``on``)."""
        if self._telemetry is not None:
            return bool(self._telemetry)
        from ray_lightning_tpu_torch.observability import env_enabled

        return env_enabled()

    # ------------------------------------------------------------------ #
    # topology
    # ------------------------------------------------------------------ #
    @property
    def world_size(self) -> int:
        """Number of ranks (processes)."""
        return 1

    @property
    def global_rank(self) -> int:
        return 0

    @property
    def local_rank(self) -> int:
        return 0

    @property
    def node_rank(self) -> int:
        return 0

    @property
    def is_global_zero(self) -> bool:
        return self.global_rank == 0

    @property
    def distributed_sampler_kwargs(self) -> Optional[Dict[str, int]]:
        """Rank sharding of the host-side data loader: one shard per rank,
        None with one rank."""
        if self.world_size <= 1:
            return None
        return {"num_replicas": self.world_size, "rank": self.global_rank}

    def global_batch_size(self, local_batch_size: int) -> int:
        return local_batch_size * self.world_size

    @property
    def process_mesh(self):
        """The named axes laid over the ranks (``parallel/mesh.py::
        ProcessMesh``), or None: one data axis over every rank."""
        return None

    # ------------------------------------------------------------------ #
    # the Trainer's hooks
    # ------------------------------------------------------------------ #
    def data_parallel(self, trainer):
        """The engine that runs this rank's collectives
        (``parallel/data_parallel.py``), or None for one rank."""
        return None

    # ------------------------------------------------------------------ #
    # host-side sync
    # ------------------------------------------------------------------ #
    def barrier(self) -> None:
        if self.world_size > 1:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                dist.barrier()

    def broadcast_host(self, obj: Any, src: int = 0) -> Any:
        """``obj`` as rank ``src`` holds it, on every rank (pickled by
        reference)."""
        if self.world_size <= 1:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]


class SingleDeviceStrategy(Strategy):
    """The one-device strategy (``SingleDeviceStrategy``)."""

    strategy_name = "single_device"
    world_size = 1
    global_rank = 0
