"""The one-device strategy (``ray_lightning_tpu/strategies/base.py``,
``SingleDeviceStrategy``). It places nothing itself, since the Trainer owns
its device; it carries the input pipeline's two settings, validated as the
JAX strategy validates them. The strategies over several devices are not
ported yet (ROADMAP.md, queue 1 item 6); the Trainer refuses them."""
from __future__ import annotations

from typing import Optional


class SingleDeviceStrategy:
    world_size = 1
    global_rank = 0

    def __init__(self, prefetch_depth: int = 2,
                 loader_num_workers: Optional[int] = None):
        """``prefetch_depth``: how many batches beyond the one being trained
        have their host-to-device copies issued ahead (``core/prefetch.py``,
        ``DevicePrefetcher``); each costs one resident batch on the device,
        and 0 is the synchronous path. ``loader_num_workers``: background
        threads assembling host batches (``AsyncLoader``); ``None`` defers
        to the loader's own ``num_workers`` (else one feeder thread), 0
        keeps host loading on the training thread."""
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
