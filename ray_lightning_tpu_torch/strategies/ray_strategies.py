"""The Ray-actor strategy family (``ray_lightning_tpu/strategies/
ray_strategies.py``): ``RayStrategy``, ``RayShardedStrategy`` and
``HorovodRayStrategy``, one engine under three names.

The main process's Trainer hands its stage to a :class:`~ray_lightning_tpu_torch.
launchers.ray_launcher.RayLauncher`, which starts ``num_workers`` worker
processes on the port's own runtime (``runtime/``), joins them into one
``torch.distributed`` group (NCCL when each worker owns a card, gloo
otherwise), runs the stage in each, and brings rank 0's weights and metrics
back. In each worker the Trainer runs the stage itself; the strategy gives
it the rank, the sampler's shard and the collectives
(``parallel/data_parallel.py``):

- ``RayStrategy``: data parallel. Every rank holds the model; the mean of
  the gradients is all-reduced at each update, bucketed over the flat
  parameter list (the JAX package lets XLA insert this all-reduce).
- ``RayShardedStrategy(zero_stage=1|2|3)``: ZeRO, with the stage semantics
  of ``parallel/sharding.py``'s ``ShardingPolicy.zero_stage``: each rank
  keeps its shard of the optimizer state (1), the gradients are
  reduce-scattered (2), and the parameters stay sharded between steps,
  all-gathered for each step (3).
- ``HorovodRayStrategy``: the reference's ring-allreduce name for the same
  engine as ``RayStrategy``, with ``num_slots``.

``mesh_spec`` (``parallel/mesh.py::MeshSpec`` with the axes 'dp' and 'ep')
lays named axes over the ranks, row-major: the members of an 'ep' group see
the same batch and each holds E / ep of a MoE model's experts
(``moe_ffn_local_experts``); the sampler shards the data over 'dp' and the
engine reduces gradients, ZeRO shards and metrics over the 'dp' group, as
``ShardingPolicy(data_axes=("dp",))`` does in JAX.

Failures: ``max_failures`` relaunches a worker group whose process died (or
that the hang supervisor killed) up to that many times, resuming from the
newest checkpoint the run wrote (``launchers/ray_launcher.py``);
``hang_timeout`` (seconds of heartbeat silence, None or 0 for none) and
``heartbeat_interval`` drive the supervisor (``runtime/supervisor.py``).
``elastic=True`` (with ``num_workers`` > 1) shrinks the group around a
dead or hung worker instead, without a relaunch, and grows it back with a
spare forked from the zygote at the next epoch boundary
(``runtime/elastic.py``), while at least ``min_workers`` (default 1,
clamped to 1) survive; below that the relaunch runs. These are constructor
arguments only: the port reads no environment variable for them (the JAX
strategies also read ``RLT_ELASTIC`` and ``RLT_MIN_WORKERS``).

``telemetry`` (the argument, else ``TORCHRT_TELEMETRY``) turns the flight
recorder on (``observability/``): the launcher pins the verdict into each
worker's environment, the workers' beats carry their spans and metrics to
the main process's ``DriverAggregator``, and the fit leaves ``trace.json``,
``metrics.json``, ``metrics.prom``, ``summary.json`` and ``events.jsonl``
under ``<default_root_dir>/telemetry`` (or ``TORCHRT_TELEMETRY_DIR``).

The constructors take the JAX strategies' arguments. Those that steer what
the port does not have (other mesh axes, partition rules, gradient
compression, several devices per worker, the XLA cache) refuse any value
but their default with a message that names ROADMAP.md.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from ray_lightning_tpu_torch.parallel.mesh import MeshSpec, ProcessMesh
from ray_lightning_tpu_torch.parallel.sharding import ShardingPolicy
from ray_lightning_tpu_torch.strategies.base import Strategy
from ray_lightning_tpu_torch.utils.common import rank_zero_warn


def _refuse(name: str, value: Any, what: str) -> None:
    raise NotImplementedError(
        f"{name}={value!r}: {what} is not ported yet; see ROADMAP.md")


class RayStrategy(Strategy):
    """Distributed data-parallel training over worker processes.

    ``num_workers``, ``num_cpus_per_worker``, ``use_gpu``, ``init_hook``
    and ``resources_per_worker`` as in the reference (``ray_ddp.py``):
    each worker demands ``num_cpus_per_worker`` CPUs
    (``resources_per_worker["CPU"]`` wins) and, with ``use_gpu``, one
    ``"GPU"`` (``resources_per_worker["GPU"]`` wins; 0.5 lets two workers
    share a card). The workers train on the Trainer's device: with
    ``device="cpu"`` on the CPU over gloo; on the card each worker takes
    card ``local_rank`` and the group runs NCCL, unless more workers than
    cards share a host, and then gloo through host copies. ``use_gpu=True``
    with a CPU Trainer is refused. ``timeout_s`` bounds the workers'
    start-up, the rendezvous and every collective. ``mesh_spec``: a
    ``MeshSpec`` over 'dp' and 'ep' whose resolved sizes multiply to
    ``num_workers`` (see the module's note). ``max_failures``,
    ``hang_timeout``, ``heartbeat_interval``, ``elastic`` and
    ``min_workers``, ``telemetry``: see the module's note.
    """

    strategy_name = "ddp_ray"

    def __init__(
        self,
        num_workers: int = 1,
        num_cpus_per_worker: int = 1,
        use_gpu: bool = False,
        use_tpu: Optional[bool] = None,
        init_hook: Optional[Callable] = None,
        resources_per_worker: Optional[Dict[str, float]] = None,
        platform: Optional[str] = None,
        devices_per_worker: Optional[int] = None,
        chips_per_host: Optional[int] = None,
        mesh_spec: Optional[MeshSpec] = None,
        sharding_policy: Optional[ShardingPolicy] = None,
        dcn_grad_compression: Optional[str] = None,
        debug_collectives: bool = False,
        max_failures: int = 0,
        elastic: Optional[bool] = None,
        min_workers: Optional[int] = None,
        heartbeat_interval: Optional[float] = None,
        hang_timeout: Optional[float] = None,
        telemetry: Optional[bool] = None,
        prefetch_depth: Optional[int] = None,
        loader_num_workers: Optional[int] = None,
        xla_cache_dir: Optional[str] = None,
        partition_rules: Optional[Any] = None,
        zero_quantized_allgather: Optional[bool] = None,
        zero_gather_group_size: int = 8,
        timeout_s: float = 1800.0,
        **kwargs: Any,
    ):
        super().__init__(2 if prefetch_depth is None else prefetch_depth,
                         loader_num_workers, telemetry)
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if use_tpu:
            _refuse("use_tpu", use_tpu, "a TPU worker (the port runs on CUDA "
                    "cards and CPUs)")
        if platform not in (None, "cpu", "gpu", "cuda"):
            raise ValueError(f"platform={platform!r}: expected None, 'cpu', "
                             "'gpu' or 'cuda'")
        if devices_per_worker not in (None, 1):
            _refuse("devices_per_worker", devices_per_worker,
                    "a worker over several devices (a device mesh)")
        for name, value, what in (
            ("chips_per_host", chips_per_host, "TPU chip partitioning"),
            ("dcn_grad_compression", dcn_grad_compression,
             "gradient compression (parallel/compression.py)"),
            ("xla_cache_dir", xla_cache_dir, "XLA's compilation cache"),
            ("partition_rules", partition_rules, "partition rules"),
            ("zero_quantized_allgather", zero_quantized_allgather or None,
             "the quantized ZeRO all-gather"),
        ):
            if value is not None:
                _refuse(name, value, what)
        if heartbeat_interval is not None and float(heartbeat_interval) <= 0:
            raise ValueError(f"heartbeat_interval must be > 0, got "
                             f"{heartbeat_interval}")
        if hang_timeout is not None and float(hang_timeout) < 0:
            raise ValueError(f"hang_timeout must be >= 0, got {hang_timeout}")
        if zero_gather_group_size != 8:
            _refuse("zero_gather_group_size", zero_gather_group_size,
                    "the quantized ZeRO all-gather")
        if mesh_spec is not None:
            # the sizes multiply to the world; unported axes refuse
            ProcessMesh(mesh_spec, int(num_workers), 0)
        self.mesh_spec = mesh_spec
        self.sharding_policy = sharding_policy or ShardingPolicy.ddp()
        self.num_workers = int(num_workers)
        self.num_cpus_per_worker = num_cpus_per_worker
        self.use_gpu = bool(use_gpu)
        self.init_hook = init_hook
        self.resources_per_worker = dict(resources_per_worker or {})
        self.platform = platform
        self.debug_collectives = bool(debug_collectives)
        self.timeout_s = float(timeout_s)
        self.max_failures = int(max_failures)
        # supervision is opt-in: None (or 0) watches nothing
        self.hang_timeout = float(hang_timeout) if hang_timeout else None
        self.heartbeat_interval = (1.0 if heartbeat_interval is None
                                   else float(heartbeat_interval))
        # elastic membership (runtime/elastic.py), off unless asked for
        self._elastic = elastic
        self._min_workers = min_workers
        if kwargs:
            rank_zero_warn("ignoring unsupported strategy kwargs: %s",
                           sorted(kwargs))
        self._launcher = None
        self._is_remote = False
        # (global_rank, world, local_rank, node_rank) inside a worker
        self._worker_ctx: Optional[Tuple[int, int, int, int]] = None
        self._mesh: Optional[ProcessMesh] = None

    @property
    def zero_stage(self) -> int:
        return self.sharding_policy.zero_stage

    @property
    def elastic(self) -> bool:
        """Shrink and grow the group around a failed worker instead of
        relaunching it (False unless the constructor says so)."""
        return bool(self._elastic)

    @property
    def min_workers(self) -> int:
        """The smallest world an elastic group shrinks to before it falls
        back to the ``max_failures`` relaunch (at least 1; default 1)."""
        return 1 if self._min_workers is None else max(1, int(self._min_workers))

    # the launcher (main-process actor handles) and the mesh's process
    # groups never ship to a worker
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_launcher"] = None
        state["_mesh"] = None
        return state

    @property
    def launcher(self):
        """On the main process, the launcher (made at first use); in a worker,
        None: the stage runs in place."""
        if self._is_remote:
            return None
        if self._launcher is None:
            from ray_lightning_tpu_torch.launchers.ray_launcher import RayLauncher

            self._launcher = RayLauncher(self)
        return self._launcher

    def set_remote(self, remote: bool) -> None:
        self._is_remote = remote

    def _set_worker_context(self, global_rank: int, num_workers: int,
                            local_rank: int = 0,
                            node_rank: Optional[int] = None) -> None:
        self._worker_ctx = (global_rank, num_workers, local_rank,
                            global_rank if node_rank is None else node_rank)
        self._mesh = None

    # ------------------------------------------------------------------ #
    # topology
    # ------------------------------------------------------------------ #
    @property
    def world_size(self) -> int:
        if self._worker_ctx is not None:
            return self._worker_ctx[1]
        return self.num_workers

    @property
    def global_rank(self) -> int:
        return self._worker_ctx[0] if self._worker_ctx is not None else 0

    @property
    def local_rank(self) -> int:
        return self._worker_ctx[2] if self._worker_ctx is not None else 0

    @property
    def node_rank(self) -> int:
        return (self._worker_ctx[3] if self._worker_ctx is not None
                else self.global_rank)

    @property
    def process_mesh(self) -> Optional[ProcessMesh]:
        """``mesh_spec`` laid over the ranks (None without one): this rank's
        coordinates; its groups exist once :meth:`data_parallel` ran in a
        worker."""
        if self.mesh_spec is None:
            return None
        mesh = self._mesh
        if mesh is None or (mesh.rank, mesh.world_size) != (
                self.global_rank, self.world_size):
            mesh = self._mesh = ProcessMesh(self.mesh_spec, self.world_size,
                                            self.global_rank)
        return mesh

    @property
    def distributed_sampler_kwargs(self) -> Optional[Dict[str, int]]:
        """One shard of the data per dp coordinate: under a mesh the members
        of an ep group read the same shard."""
        mesh = self.process_mesh
        if mesh is None:
            return super().distributed_sampler_kwargs
        return {"num_replicas": mesh.size("dp"), "rank": mesh.coords["dp"]}

    def global_batch_size(self, local_batch_size: int) -> int:
        mesh = self.process_mesh
        dp = self.world_size if mesh is None else mesh.size("dp")
        return local_batch_size * dp

    # ------------------------------------------------------------------ #
    def data_parallel(self, trainer):
        """This worker's engine over the process group the launcher has
        joined before the stage starts: the default group, or under a mesh
        the 'dp' subgroup, with the 'ep' subgroup for the experts (the mesh's
        groups are created here, on every rank at the same point)."""
        import torch
        import torch.distributed as dist

        from ray_lightning_tpu_torch.parallel.data_parallel import DataParallel

        if not dist.is_initialized():
            raise RuntimeError(
                f"{type(self).__name__}: no torch.distributed process group "
                "in this process; the strategy's stages run in the workers "
                "that its launcher starts (Trainer.fit in the main process)")
        backend = dist.get_backend()
        comm = (trainer.device if backend == "nccl" else torch.device("cpu"))
        mesh = self.process_mesh
        if mesh is None:
            return DataParallel(self.world_size, self.global_rank,
                                self.zero_stage, comm)
        mesh.join()
        return DataParallel(mesh.size("dp"), mesh.coords["dp"], self.zero_stage,
                            comm, group=mesh.group("dp"),
                            ep_group=mesh.group("ep"), ep_size=mesh.size("ep"),
                            ep_rank=mesh.coords["ep"])


class RayShardedStrategy(RayStrategy):
    """ZeRO sharded data parallel (the reference's FairScale-sharded DDP):
    ``zero_stage`` 1 and 2 shard the optimizer state (2 also the gradients),
    3 also the parameters between steps."""

    strategy_name = "ddp_sharded_ray"

    def __init__(self, *args, zero_stage: int = 2, **kwargs):
        kwargs.setdefault("sharding_policy",
                          ShardingPolicy(zero_stage=zero_stage,
                                         data_axes=("dp",)))
        super().__init__(*args, **kwargs)


class HorovodRayStrategy(RayStrategy):
    """The reference's ring-allreduce name (``ray_horovod.py``): the same
    engine as ``RayStrategy``."""

    strategy_name = "horovod_ray"

    def __init__(self, num_workers: int = 1, num_cpus_per_worker: int = 1,
                 use_gpu: bool = False, **kwargs):
        super().__init__(num_workers=num_workers,
                         num_cpus_per_worker=num_cpus_per_worker,
                         use_gpu=use_gpu, **kwargs)

    @property
    def num_slots(self) -> int:  # hvd.size()
        return self.world_size
