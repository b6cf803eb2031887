"""The worker actor and its result (``ray_lightning_tpu/launchers/
utils.py``): the reference's ``RayExecutor`` and ``_RayOutput``. The worker
is where ``torch.distributed.init_process_group`` runs, with the rank, the
world size and the rendezvous address passed as arguments."""
from __future__ import annotations

import datetime
from typing import Any, Callable, Dict, NamedTuple, Optional

from ray_lightning_tpu_torch.utils.ports import find_free_port, node_ip_address


class WorkerOutput(NamedTuple):
    """What rank 0 sends back. The weights travel as a ``torch.save`` byte
    stream, so no shared file system is assumed. ``launch_counts`` are the
    kernel launches of the stage, summed over every rank by the launcher
    (each worker counts its own from 0)."""

    best_model_path: Optional[str]
    weights_stream: Optional[bytes]
    trainer_state: Dict[str, str]
    trainer_results: Any
    callback_metrics: Dict[str, Any]
    logged_metrics: Dict[str, Any]
    callback_states: Dict[str, Any]
    current_epoch: int
    global_step: int
    launch_counts: Dict[str, int]
    collect_s: float  # rank 0 serialising its weights
    sent_at: float  # rank 0's wall clock as it returns
    gather_s: float = 0.0  # the ranks' all-gather of the expert slices


class RankReport(NamedTuple):
    """What a rank other than 0 sends back: its kernel launches."""

    launch_counts: Dict[str, int]


class RayExecutor:
    """The generic worker actor: introspection, the process group, and
    ``execute`` for the launcher's wrapping function."""

    def __init__(self):
        self._distributed = False

    def get_node_ip(self) -> str:
        return node_ip_address()

    def find_free_port(self) -> int:
        return find_free_port()

    def device_count(self) -> int:
        """CUDA cards visible to this worker (0 without CUDA)."""
        import torch

        return torch.cuda.device_count() if torch.cuda.is_available() else 0

    def init_distributed(self, init_method: str, world_size: int, rank: int,
                         backend: str, device_index: Optional[int] = None,
                         timeout_s: float = 1800.0) -> Dict[str, Any]:
        """Join the group: ``init_process_group(backend, init_method=
        "tcp://host:port", world_size, rank, timeout)``. With
        ``device_index`` the worker first makes that card its own. Returns
        what it joined, for the launcher's check."""
        import torch
        import torch.distributed as dist

        if device_index is not None:
            torch.cuda.set_device(device_index)
        if not self._distributed:
            dist.init_process_group(
                backend, init_method=init_method, world_size=world_size,
                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
            self._distributed = True
        return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
                "backend": dist.get_backend(), "device_index": device_index}

    def all_reduce_smoke_test(self) -> float:
        """A one-element all-reduce: proves the collective plane is up."""
        import torch
        import torch.distributed as dist

        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        x = torch.ones(1, device=dev)
        dist.all_reduce(x)
        return float(x.item())

    def execute(self, fn: Callable, *args, **kwargs) -> Any:
        return fn(*args, **kwargs)

    def shutdown_distributed(self) -> None:
        import torch.distributed as dist

        if self._distributed and dist.is_initialized():
            dist.destroy_process_group()
        self._distributed = False
