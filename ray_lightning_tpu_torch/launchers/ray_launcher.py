"""The main process's launcher (``ray_lightning_tpu/launchers/ray_launcher.py``):
start the worker processes, join them into one ``torch.distributed`` group,
ship the trainer, run the stage in each, bring rank 0's results back.

The reference's call stack (``ray_launcher.py:48-379``) on the port's own
runtime:

- ``setup_workers``: one ``RayExecutor`` actor per worker, placed by their
  demands (CPUs, and a ``"GPU"`` each with ``use_gpu`` when the host
  advertises cards); local ranks from the workers' node addresses; on the
  card, NCCL when every worker of a host has a card of its own (worker
  ``local_rank`` takes card ``local_rank``), else gloo; the rendezvous is
  ``tcp://`` worker 0's address and a free port of its host, with rank and
  world size passed to ``init_process_group`` as arguments;
- ``run_function_on_workers``: the trainer and the module, pickled once on
  the main process (stdlib pickle inside a ``torch.save`` stream, classes by
  reference), go through the object store to every local worker (inline to
  a remote one); each worker runs the Trainer's stage; every rank then
  gathers the whole tree (under an ep mesh, the expert slices over the ep
  group) and rank 0 returns its weights as a ``torch.save`` stream, its
  metrics, its callback states and the best checkpoint's path;
- the main process loads them into its trainer and module, as if it had trained.

Inside a tune trial (``tune.session.is_session_enabled()`` in the launching
process) ``setup_workers`` also makes the tune queue; every worker's session
gets its handle, and ``process_results`` runs the callables the Tune
callbacks put there, in the trial process, while it waits for the workers.

Relaunching a failed group, elastic membership, the hang supervisor and
telemetry are not ported (ROADMAP.md).
"""
from __future__ import annotations

import io
import math
import os
import pickle
import secrets
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.runtime.actor import dumps
from ray_lightning_tpu_torch.callbacks.base import (
    collect_callback_states,
    restore_callback_states,
)
from ray_lightning_tpu_torch.launchers.utils import (
    RankReport,
    RayExecutor,
    WorkerOutput,
)
from ray_lightning_tpu_torch.session import init_session, reset_session
from ray_lightning_tpu_torch.tune import session as tune_session
from ray_lightning_tpu_torch.utils.seed import seed_everything
from ray_lightning_tpu_torch.utils.serialization import (
    load_state_stream,
    to_state_stream,
)


def _drain_queue(queue) -> None:
    """Run the callables the workers put into the tune queue (a Tune
    callback's report or checkpoint must run in the trial process)."""
    if queue is None:
        return
    for item in queue.get_all():
        if callable(item):
            item()


def process_results(futures: List[rt.CallFuture], queue=None) -> List[Any]:
    """Wait for every worker's future, running what the workers put into
    ``queue`` (the tune queue) as it arrives and once more after the last
    future settles. Raises a worker's error, preferring a process failure
    (a dead worker) over the collective errors its peers then raise."""
    remaining = list(futures)
    settled: Dict[int, Any] = {}
    first_error: Optional[Exception] = None

    def check(fut) -> None:
        nonlocal first_error
        try:
            settled[id(fut)] = fut.result()
        except rt.ActorError as e:
            if e.is_process_failure:
                raise
            first_error = first_error or e
        except Exception as e:
            first_error = first_error or e

    while remaining:
        ready, remaining = rt.wait(remaining, num_returns=1, timeout=0.1)
        for fut in ready:
            check(fut)
        if first_error is not None:
            # a crashed peer's lost connection surfaces in a moment: let it
            # win, so the error names the root cause
            grace = time.monotonic() + 3.0
            while remaining and time.monotonic() < grace:
                ready, remaining = rt.wait(remaining, num_returns=1,
                                           timeout=0.2)
                for fut in ready:
                    check(fut)
            raise first_error
        _drain_queue(queue)
    _drain_queue(queue)
    return [settled[id(f)] for f in futures]


def compute_local_ranks(node_ips: List[str]) -> List[Tuple[int, int]]:
    """global rank -> (node rank, local rank): nodes numbered in order of
    first appearance, workers numbered within their node."""
    node_of: Dict[str, int] = {}
    seen: Dict[str, int] = {}
    out = []
    for ip in node_ips:
        node = node_of.setdefault(ip, len(node_of))
        out.append((node, seen.get(ip, 0)))
        seen[ip] = seen.get(ip, 0) + 1
    return out


def _wrapping_function(global_rank: int, num_workers: int, payload_ref,
                       local_rank: int, node_rank: int, device: str,
                       queue_handle=None):
    """Runs in each worker (``RayExecutor.execute``): rebuild the trainer,
    take this rank's place and device, run the stage, and return rank 0's
    results (a ``RankReport`` of the kernel launches from the others)."""
    from ray_lightning_tpu_torch import kernels

    payload = payload_ref if isinstance(payload_ref, bytes) else rt.get(payload_ref)
    trainer, fn_name, fn_args = torch.load(io.BytesIO(payload),
                                           map_location="cpu",
                                           weights_only=False)
    strategy = trainer.strategy
    strategy.set_remote(True)
    strategy._set_worker_context(global_rank, num_workers,
                                 local_rank=local_rank, node_rank=node_rank)
    trainer.device = torch.device(device)
    reset_session()
    # the tune queue's handle inside a trial, else None
    init_session(rank=global_rank, queue=queue_handle)
    module = trainer._module
    module.trainer = trainer
    kernels.reset_launch_counts()
    trainer.state.status = "running"
    results = getattr(trainer, fn_name)(*fn_args)
    trainer.state.status = "finished"
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    counts = kernels.launch_counts()
    # every rank, at this one point: under an ep mesh the expert slices are
    # all-gathered, so that rank 0 returns every expert
    t = time.perf_counter()
    params = trainer.whole_params()
    gather_s = time.perf_counter() - t
    if global_rank != 0:
        return RankReport(counts)
    return _collect_rank_zero_results(trainer, results, counts, params,
                                      gather_s)


def _to_host_metrics(metrics: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in metrics.items()}


def _collect_rank_zero_results(trainer, results, counts, params,
                               gather_s: float) -> WorkerOutput:
    t = time.perf_counter()
    ckpt_cb = trainer.checkpoint_callback
    stream = to_state_stream(params) if params is not None else None
    return WorkerOutput(
        best_model_path=ckpt_cb.best_model_path if ckpt_cb else None,
        weights_stream=stream,
        trainer_state={"fn": trainer.state.fn, "status": trainer.state.status},
        trainer_results=results,
        callback_metrics=_to_host_metrics(trainer.callback_metrics),
        logged_metrics=_to_host_metrics(trainer.logged_metrics),
        callback_states=collect_callback_states(trainer.callbacks),
        current_epoch=trainer.current_epoch,
        global_step=trainer.global_step,
        launch_counts=counts,
        collect_s=time.perf_counter() - t,
        sent_at=time.time(),
        gather_s=gather_s,
    )


class RayLauncher:
    """Starts, feeds and stops one strategy's worker group. Timing of the
    last launch is in ``timings``: ``setup_s`` (spawn, rendezvous),
    ``run_s`` (from shipping the payload to the last worker's reply), and
    the weights' way back, ``weights_s``: under an ep mesh the ranks'
    all-gather of the expert slices (``gather_s``, 0 otherwise), rank 0
    serialising them (``collect_s``), the reply's transfer and unpickling
    (``transfer_s``, between the two processes' wall clocks on one host) and
    the main process loading them onto its device (``load_s``)."""

    is_interactive_compatible = True  # workers boot as fresh interpreters

    def __init__(self, strategy):
        self._strategy = strategy
        self._workers: List[rt.ActorHandle] = []
        self._worker_ranks: List[Tuple[int, int]] = []
        self._devices: List[str] = []
        self._any_remote = False
        self._tune_queue: Optional[rt.Queue] = None
        self.backend: Optional[str] = None
        self.timings: Dict[str, float] = {}

    # ------------------------------------------------------------------ #
    def launch(self, function, *args, trainer=None) -> Any:
        strategy = self._strategy
        device = trainer.device
        if strategy.use_gpu and device.type != "cuda":
            raise ValueError(
                f"{type(strategy).__name__}(use_gpu=True) with a Trainer on "
                f"{device}: the workers train on the Trainer's device")
        if strategy.platform is not None and (
                (strategy.platform == "cpu") != (device.type == "cpu")):
            raise ValueError(f"platform={strategy.platform!r} contradicts the "
                             f"Trainer's device {device}")
        if not rt.is_initialized():
            cards = torch.cuda.device_count() if device.type == "cuda" else 0
            rt.init(resources={"GPU": float(cards)} if cards else None)
        # every worker initialises the same parameters and shards the data
        # with the same permutation: the seed is fixed here, once
        seed = seed_everything(trainer.seed)
        original_seed, trainer.seed = trainer.seed, seed
        try:
            # pickled before any worker starts: what cannot be shipped fails
            # at once
            payload = self._payload(function, args, trainer)
            if strategy.init_hook is not None:
                dumps(strategy.init_hook, "the init_hook")
            t = time.perf_counter()
            self.setup_workers(device)
            self.timings = {"setup_s": time.perf_counter() - t}
            output = self.run_function_on_workers(payload)
            self._recover_results_in_main_process(output, trainer)
            return output.trainer_results
        finally:
            trainer.seed = original_seed
            self.teardown_workers()

    @staticmethod
    def _payload(function, args, trainer) -> bytes:
        """The trainer, the stage's name and its arguments (the module
        first) in one ``torch.save`` stream: one pickle memo, so the
        module and ``trainer._module`` stay one object in the worker."""
        buf = io.BytesIO()
        try:
            torch.save((trainer, function.__name__, args), buf)
        except (AttributeError, TypeError, pickle.PicklingError) as e:
            raise TypeError(
                f"cannot ship the trainer and module to the workers: {e}. The "
                "port pickles with the standard library, by reference: the "
                "module's class, its callbacks and its data must be importable "
                "at module level in the main process's sys.path (no lambdas or "
                "classes defined inside a function)") from e
        return buf.getvalue()

    def _worker_demand(self) -> Dict[str, float]:
        """``resources_per_worker["CPU"]`` wins over ``num_cpus_per_worker``;
        ``use_gpu`` claims one ``"GPU"`` where the cluster advertises cards,
        unless ``resources_per_worker`` sets its own share."""
        strategy = self._strategy
        resources = dict(strategy.resources_per_worker)
        demand = {"CPU": float(resources.pop("CPU",
                                             strategy.num_cpus_per_worker))}
        if "GPU" in resources:
            demand["GPU"] = float(resources.pop("GPU"))
        elif strategy.use_gpu and rt.cluster_resources().get("GPU", 0.0):
            demand["GPU"] = 1.0
        demand.update({k: float(v) for k, v in resources.items()})
        return demand

    def setup_workers(self, device: torch.device) -> None:
        strategy = self._strategy
        n = strategy.num_workers
        timeout = strategy.timeout_s
        demands = [self._worker_demand() for _ in range(n)]
        placement = "spread" if len(rt.nodes()) > 1 else None
        assignments = rt.plan_placement(demands, placement)
        tag = secrets.token_hex(3)
        # as Ray does for an actor: its CPU ops use the CPUs it demands
        # (unless the caller set OMP_NUM_THREADS), not every core of the
        # host each, which oversubscribes a host shared by several workers
        threads = [{"OMP_NUM_THREADS": str(max(1, math.ceil(d["CPU"])))}
                   for d in demands]
        self._workers = rt.create_actors(
            [(RayExecutor, (), {}) for _ in range(n)],
            names=[f"torchrt-worker-{i}-{os.getpid()}-{tag}" for i in range(n)],
            per_actor_env=None if "OMP_NUM_THREADS" in os.environ else threads,
            demands=demands, assignments=assignments, timeout=timeout)
        self._any_remote = any(rt.actor_node_id(w) != 0 for w in self._workers)
        if self._any_remote:
            ips = rt.get([w.get_node_ip.remote() for w in self._workers],
                         timeout=timeout)
        else:
            ips = ["127.0.0.1"] * n
        self._worker_ranks = compute_local_ranks(ips)

        if device.type == "cuda":
            cards = rt.get([w.device_count.remote() for w in self._workers],
                           timeout=timeout)
            if min(cards) < 1:
                raise RuntimeError(f"a worker sees no CUDA card: {cards}")
            own = all(local < c for (_, local), c in
                      zip(self._worker_ranks, cards))
            self.backend = "nccl" if own else "gloo"
            indices = [local % c for (_, local), c in
                       zip(self._worker_ranks, cards)]
            self._devices = [f"cuda:{i}" for i in indices]
        else:
            self.backend = "gloo"
            indices = [None] * n
            self._devices = ["cpu"] * n

        if strategy.init_hook is not None:
            rt.get([w.execute.remote(strategy.init_hook) for w in self._workers],
                   timeout=timeout)
        host = ips[0]
        port = rt.get(self._workers[0].find_free_port.remote(), timeout=timeout)
        init_method = f"tcp://{host}:{port}"
        joined = rt.get([w.init_distributed.remote(init_method, n, rank,
                                                   self.backend, idx, timeout)
                         for rank, (w, idx) in
                         enumerate(zip(self._workers, indices))],
                        timeout=timeout + 30)
        if sorted(j["rank"] for j in joined) != list(range(n)):
            raise RuntimeError(f"the workers joined as {joined}")
        if strategy.debug_collectives:
            sums = rt.get([w.all_reduce_smoke_test.remote()
                           for w in self._workers], timeout=timeout)
            if sums != [float(n)] * n:
                raise RuntimeError(f"all-reduce smoke test gave {sums}")
        if tune_session.is_session_enabled():
            self._tune_queue = rt.make_queue(cross_host=self._any_remote,
                                             timeout=timeout)

    # ------------------------------------------------------------------ #
    def run_function_on_workers(self, payload: bytes) -> WorkerOutput:
        """Ship the payload and run the stage in every worker; rank 0's
        output, with the launch counts summed over the ranks."""
        t0 = time.perf_counter()
        payload_ref: Any = payload if self._any_remote else rt.put(payload)
        n = len(self._workers)
        queue = self._tune_queue
        queue_handle = queue.handle() if queue is not None else None
        try:
            futures = [
                w.execute.remote(_wrapping_function, rank, n, payload_ref,
                                 self._worker_ranks[rank][1],
                                 self._worker_ranks[rank][0],
                                 self._devices[rank], queue_handle)
                for rank, w in enumerate(self._workers)
            ]
            results = process_results(futures, queue)
            received = time.time()
        finally:
            if not isinstance(payload_ref, bytes):
                rt.delete(payload_ref)
        self.timings["run_s"] = time.perf_counter() - t0
        counts: Dict[str, int] = {}
        for r in results:
            for k, v in r.launch_counts.items():
                counts[k] = counts.get(k, 0) + v
        output = next(r for r in results if isinstance(r, WorkerOutput))
        self.timings["collect_s"] = output.collect_s
        self.timings["gather_s"] = output.gather_s
        self.timings["transfer_s"] = max(0.0, received - output.sent_at)
        return output._replace(launch_counts=counts)

    def _recover_results_in_main_process(self, output: WorkerOutput,
                                         trainer) -> None:
        """Make the main process's trainer look as if it had trained locally: the
        weights on its device, the metrics, the progress and the callback
        states; ``trainer.worker_launch_counts`` holds the workers' kernel
        launches."""
        t = time.perf_counter()
        if output.weights_stream is not None:
            params = load_state_stream(output.weights_stream,
                                       device=trainer.device)
            trainer._module._params = params
            trainer._params = params
        self.timings["load_s"] = time.perf_counter() - t
        self.timings["weights_s"] = (output.gather_s + output.collect_s
                                     + self.timings.get("transfer_s", 0.0)
                                     + self.timings["load_s"])
        trainer.callback_metrics.update(output.callback_metrics)
        trainer.logged_metrics.update(output.logged_metrics)
        trainer.current_epoch = output.current_epoch
        trainer.global_step = output.global_step
        restore_callback_states(trainer.callbacks, output.callback_states)
        trainer.worker_launch_counts = dict(output.launch_counts)

    def teardown_workers(self) -> None:
        """Leave the process group, stop every worker process and the tune
        queue."""
        if self._workers:
            try:
                rt.get([w.shutdown_distributed.remote() for w in self._workers],
                       timeout=30)
            except Exception as e:  # the kill below still reaps them
                print(f"RayLauncher: shutdown_distributed: {e}", file=sys.stderr)
        for w in self._workers:
            rt.kill(w)
        self._workers = []
        if self._tune_queue is not None:
            self._tune_queue.shutdown()
            self._tune_queue = None
