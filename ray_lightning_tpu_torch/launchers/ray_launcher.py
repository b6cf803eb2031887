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

Failures (``strategy.max_failures``): a worker group whose process died,
or that the hang supervisor killed, is torn down (its processes are waited
for until they have exited, so a relaunched worker finds the card free) and
started again, up to ``max_failures`` times, on a fresh rendezvous port.
The relaunched group resumes from the newest ``.ckpt`` that this run wrote
(``_find_relaunch_checkpoint``: files older than the launch are ignored,
``save_weights_only`` families skipped), passed to each worker's fit as
``trainer._relaunch_ckpt_path``. A user exception in the stage is not
retried: it would fail again. With ``strategy.hang_timeout`` the workers'
sessions beat into a heartbeat queue that a ``runtime/supervisor.py``
thread drains; a rank silent for longer is declared hung, the group is
killed, and the wait raises ``WorkerHangError``, a process failure that the
relaunch takes like a crash. ``failures`` records each failure.

Elastic membership (``strategy.elastic``, ``runtime/elastic.py``): the
group joins through a TCPStore that the main process hosts for each
membership epoch, and the workers get a ledger directory. A process failure
or a hang verdict is offered first to an ``ElasticController``: while at
least ``min_workers`` survive, the group shrinks around the dead rank
without a relaunch (``process_results`` drops its future), a warm spare is
forked from the zygote (warmed at set-up) and joins at the next epoch
boundary, and its future joins the wait. Below ``min_workers`` the
controller declines and the relaunch above runs, from the checkpoint that
``_find_relaunch_checkpoint`` finds (also the controller's pinned restore).
Workers are indexed by boot id (spares get the next ids); each worker's
resizes come back in ``elastic`` beside the controller's.

The queues (tune, heartbeats) are the native ring (``runtime/queue.py``)
when the workers share this host and the library builds, else actors.

Telemetry (``observability/``): the heartbeat channel exists whenever
``hang_timeout`` or ``telemetry`` is set, and then a ``DriverAggregator``
sits behind the supervisor. With telemetry on it merges the workers' beat
payloads (spans, metrics, goodput) into ``trace.json``, ``metrics.json``,
``metrics.prom`` and ``summary.json`` under ``<default_root_dir>/telemetry``
(``TORCHRT_TELEMETRY_DIR`` wins); with it off it is the flight record
alone: ``events.jsonl`` of the run's start and end, the supervisor's
verdicts, the launcher's crashes and the elastic controller's resizes,
with an incident bundle for each fault.
"""
from __future__ import annotations

import io
import math
import os
import pickle
import secrets
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch import observability as obs
from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.callbacks.checkpoint import ModelCheckpoint
from ray_lightning_tpu_torch.runtime import faults
from ray_lightning_tpu_torch.runtime.actor import dumps
from ray_lightning_tpu_torch.runtime.supervisor import Supervisor
from ray_lightning_tpu_torch.callbacks.base import (
    collect_callback_states,
    restore_callback_states,
)
from ray_lightning_tpu_torch.launchers.utils import (
    RankReport,
    RayExecutor,
    WorkerOutput,
)
from ray_lightning_tpu_torch.session import (
    emit_done,
    flush_telemetry,
    init_session,
    reset_session,
)
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


def process_results(futures: List[rt.CallFuture], queue=None,
                    supervisor: Optional[Supervisor] = None,
                    controller=None) -> List[Any]:
    """Wait for every worker's future, running what the workers put into
    ``queue`` (the tune queue) as it arrives and once more after the last
    future settles. Raises a worker's error, preferring a process failure
    (a dead worker) over the collective errors its peers then raise. With a
    ``supervisor`` each round first raises its hang verdict, if it has one:
    it kills the group after recording the verdict, so a hang is reported
    as a hang and not as the lost connections that follow. With an elastic
    ``controller`` a process failure is first offered to it: when the group
    shrank around it the dead future is dropped, and the futures of the
    spares it spawned join the wait. Returns the settled results, spares'
    included."""
    remaining = list(futures)
    tracked = list(futures)
    settled: Dict[int, Any] = {}
    first_error: Optional[Exception] = None

    def check(fut) -> None:
        nonlocal first_error
        try:
            settled[id(fut)] = fut.result()
        except rt.ActorError as e:
            if e.is_process_failure:
                if controller is not None and controller.on_future_failure(
                        fut, e):
                    return  # absorbed: the group shrank and trains on
                raise
            first_error = first_error or e
        except Exception as e:
            first_error = first_error or e

    def take_spares() -> bool:
        if controller is None:
            return False
        controller.poll()
        spares = controller.drain_new_futures()
        remaining.extend(spares)
        tracked.extend(spares)
        # a spare announced after the survivors' last epoch boundary waits
        # for an admission that never comes: take the grow back
        stranded = controller.stranded_joiner(remaining)
        if stranded is not None:
            controller.cancel_grow(stranded)
            remaining.clear()
        return bool(spares)

    try:
        while remaining or take_spares():
            ready, remaining = rt.wait(remaining, num_returns=1, timeout=0.1)
            if supervisor is not None:
                supervisor.poll()
            for fut in ready:
                check(fut)
            take_spares()
            if first_error is not None:
                # a crashed peer's lost connection surfaces in a moment: let
                # it win, so the error names the root cause
                grace = time.monotonic() + 3.0
                while remaining and time.monotonic() < grace:
                    ready, remaining = rt.wait(remaining, num_returns=1,
                                               timeout=0.2)
                    for fut in ready:
                        check(fut)
                raise first_error
            _drain_queue(queue)
    except BaseException:
        # what a worker queued before it failed still runs (a Tune
        # checkpoint written just before a crash is the one a retry needs)
        try:
            _drain_queue(queue)
        except Exception as e:
            print(f"process_results: draining the queue: {e!r}",
                  file=sys.stderr)
        raise
    _drain_queue(queue)
    return [settled[id(f)] for f in tracked if id(f) in settled]


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
                       queue_handle=None, heartbeat_handle=None,
                       heartbeat_interval: float = 1.0,
                       backend: Optional[str] = None):
    """Runs in each worker (``RayExecutor.execute``): rebuild the trainer,
    take this rank's place and device, run the stage, and return rank 0's
    results (a ``RankReport`` of the kernel launches from the others). In
    an elastic group ``global_rank`` is the worker's boot id; the results
    follow its rank at the end, which resizes may have changed."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.runtime import elastic

    # TORCHRT_TELEMETRY is pinned in the worker's environment before it
    # starts (RayLauncher._worker_env): boot is recorded before the payload
    # that holds the strategy is even loaded
    obs.maybe_enable_from_env()
    with obs.span("boot/payload_load"):
        payload = (payload_ref if isinstance(payload_ref, bytes)
                   else rt.get(payload_ref))
        trainer, fn_name, fn_args = torch.load(io.BytesIO(payload),
                                               map_location="cpu",
                                               weights_only=False)
    strategy = trainer.strategy
    strategy.set_remote(True)
    strategy._set_worker_context(global_rank, num_workers,
                                 local_rank=local_rank, node_rank=node_rank)
    trainer.device = torch.device(device)
    agent = elastic.worker_agent_from_env(global_rank)
    if agent is not None:
        agent.backend = backend or "gloo"
        agent.timeout_s = getattr(strategy, "timeout_s", agent.timeout_s)
        if agent.is_joiner and trainer.device.type == "cuda":
            torch.cuda.set_device(trainer.device)
    trainer._elastic_agent = agent
    reset_session()
    # the tune queue's handle inside a trial, else None; the heartbeat
    # queue's with a hang_timeout
    init_session(rank=global_rank, queue=queue_handle,
                 heartbeat=heartbeat_handle,
                 heartbeat_interval=heartbeat_interval)
    module = trainer._module
    module.trainer = trainer
    kernels.reset_launch_counts()
    trainer.state.status = "running"
    try:
        with obs.span(f"worker/{fn_name}"):
            results = getattr(trainer, fn_name)(*fn_args)
    finally:
        # one forced last beat with the whole ring and a cumulative
        # snapshot: short runs and error exits included
        flush_telemetry(getattr(trainer, "global_step", 0))
    emit_done()
    trainer.state.status = "finished"
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    counts = kernels.launch_counts()
    # every rank, at this one point: under an ep mesh the expert slices are
    # all-gathered, so that rank 0 returns every expert
    t = time.perf_counter()
    params = trainer.whole_params()
    gather_s = time.perf_counter() - t
    if strategy.global_rank != 0:
        return RankReport(counts, trainer.elastic_log)
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
        elastic_log=trainer.elastic_log,
    )


# how long a killed worker may take to exit (a process that holds a CUDA
# context frees it as it exits)
_KILL_WAIT_S = 60.0


_exited = rt.api.pid_exited


class RayLauncher:
    """Starts, feeds and stops one strategy's worker group. Each failure
    that the launch relaunched or raised is in ``failures``: its attempt,
    the error's type and message, when the main process caught it (wall
    clock), the checkpoint the next group resumes from, and for a hang the
    ranks' silence when the supervisor tripped. Timing of the
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
        self._hb_queue: Optional[rt.Queue] = None
        self._supervisor: Optional[Supervisor] = None
        # the main process's telemetry collector of the last stage (the
        # flight record when telemetry is off), None without a heartbeat
        # channel
        self._aggregator = None
        self.backend: Optional[str] = None
        self.timings: Dict[str, float] = {}
        self.failures: List[Dict[str, Any]] = []
        # elastic membership: the ledger directory, the stores' host, the
        # controller of the running stage, the devices of evicted workers
        # (a spare takes one), what the last stage's resizes did
        self._elastic_dir: Optional[str] = None
        self._store_host = None
        self._controller = None
        self._spare_ctx: Optional[tuple] = None
        self._freed: List[Tuple[str, int]] = []
        self._evicted: set = set()
        self._launch_ctx: Optional[Tuple[Any, float]] = None
        self.elastic: Dict[str, Any] = {}
        # how the last group's traffic travelled: the kinds of its tune and
        # heartbeat queues ("shm", "actor" or None) and the payload's
        # object-store backend ("inline" to remote workers)
        self.transport: Dict[str, Optional[str]] = {}
        # (pickled bytes, spilled) of each item the last stage's heartbeat
        # ring delivered (the ring's ``traffic``; empty for an actor queue)
        self.heartbeat_traffic: List[Tuple[int, bool]] = []

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
        # checkpoints older than this are another run's
        launch_t0 = time.time()
        self._launch_ctx = (trainer, launch_t0)
        trainer._relaunch_ckpt_path = None
        self.failures = []
        if strategy.telemetry:
            obs.enable()  # the main process's own track in the merged trace
        attempt = 0
        try:
            # pickled before any worker starts: what cannot be shipped fails
            # at once
            payload = self._payload(function, args, trainer)
            if strategy.init_hook is not None:
                dumps(strategy.init_hook, "the init_hook")
            while True:
                failed = False
                try:
                    t = time.perf_counter()
                    with obs.span("boot/setup_workers", attempt=attempt):
                        self.setup_workers(device)
                    self.timings = {"setup_s": time.perf_counter() - t}
                    output = self.run_function_on_workers(
                        payload, function.__name__)
                    self._recover_results_in_main_process(output, trainer)
                    return output.trainer_results
                except rt.ActorError as e:
                    failed = True
                    record = {"attempt": attempt, "error": type(e).__name__,
                              "message": str(e), "at": time.time(),
                              "silence": dict(self._supervisor.silence_at_trip)
                              if self._supervisor is not None else {}}
                    self.failures.append(record)
                    # only a dead (or killed) worker is worth a relaunch: a
                    # user exception would fail again in a fresh group
                    if attempt >= strategy.max_failures or not e.is_process_failure:
                        self._record_event("crash", attempt=attempt,
                                           fatal=True,
                                           error=f"{type(e).__name__}: {e}")
                        raise
                finally:
                    self.teardown_workers(force=failed)
                attempt += 1
                resume = self._find_relaunch_checkpoint(trainer, launch_t0)
                record["resume"] = resume
                self._record_event("crash", attempt=attempt,
                                   max_failures=strategy.max_failures,
                                   resume=resume,
                                   error=f"{record['error']}: "
                                         f"{record['message']}")
                print(f"RayLauncher: worker failure ({record['error']}); "
                      f"relaunching (attempt {attempt}/{strategy.max_failures})"
                      + (f" from {resume}" if resume else " from scratch"),
                      file=sys.stderr)
                trainer._relaunch_ckpt_path = resume
                payload = self._payload(function, args, trainer)
        finally:
            trainer.seed = original_seed
            trainer._relaunch_ckpt_path = None
            self._launch_ctx = None
            # its incident sources reach the elastic controller, whose
            # restore scan holds the trainer: the launch keeps neither
            self._aggregator = None

    @staticmethod
    def _find_relaunch_checkpoint(trainer, not_before: float) -> Optional[str]:
        """The newest ``.ckpt`` of the trainer's ``ModelCheckpoint``
        directories written since ``not_before`` (the launch), so that a
        relaunched group continues where the failed one had saved. Older
        files are another run's; ``save_weights_only`` families hold no
        optimizer or callback states and are skipped. None: from scratch.
        (The JAX launcher also considers orbax checkpoints, not ported.)"""
        candidates = []
        for cb in trainer.callbacks:
            if not isinstance(cb, ModelCheckpoint) or cb.save_weights_only:
                continue
            d = cb.dirpath or cb.default_dirpath(trainer)
            if not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                if not name.endswith(ModelCheckpoint.CHECKPOINT_EXT):
                    continue
                path = os.path.join(d, name)
                try:
                    mtime = os.path.getmtime(path)
                except OSError:
                    continue
                if mtime >= not_before:
                    candidates.append((mtime, path))
        return max(candidates)[1] if candidates else None

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
        per_actor_env = [self._worker_env(i, d) for i, d in enumerate(demands)]
        elastic_group = bool(strategy.elastic) and n > 1
        if elastic_group:
            from ray_lightning_tpu_torch.runtime import elastic

            # a fresh ledger per bring-up: a relaunch must not replay the
            # membership epochs of the group before it
            self._elastic_dir = tempfile.mkdtemp(
                prefix="torchrt-elastic-",
                dir=os.environ.get(elastic.ELASTIC_DIR_ENV) or None)
            for env in per_actor_env:
                env[elastic.ELASTIC_DIR_ENV] = self._elastic_dir
            # the spare's zygote imports while the workers boot
            rt.api.warm_zygote()
        with obs.span("boot/spawn_workers", workers=n):
            self._workers = rt.create_actors(
                [(RayExecutor, (), {}) for _ in range(n)],
                names=[f"torchrt-worker-{i}-{os.getpid()}-{tag}"
                       for i in range(n)],
                per_actor_env=per_actor_env, demands=demands,
                assignments=assignments, timeout=timeout)
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
        with (obs.span("boot/init_distributed", workers=n) if n > 1
              else obs.NOOP_SPAN):
            joined = self._join_group(ips, indices, elastic_group)
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
        if strategy.hang_timeout or strategy.telemetry:
            # the channel of the hang watchdog and of telemetry: payloads
            # ride the beats. With neither, no beats and no supervisor
            self._hb_queue = rt.make_queue(cross_host=self._any_remote,
                                           timeout=timeout)
        self.transport = {
            "tune_queue": getattr(self._tune_queue, "kind", None),
            "heartbeat_queue": getattr(self._hb_queue, "kind", None)}

    def _join_group(self, ips: List[str], indices: List[Optional[int]],
                    elastic_group: bool) -> List[Dict[str, Any]]:
        """Every worker's ``init_process_group`` at once: through a store
        that the main process hosts for an elastic group (so that it
        outlives any worker, one a membership epoch), else at worker 0's
        address. Returns what each worker joined as."""
        n, timeout = len(self._workers), self._strategy.timeout_s
        if elastic_group:
            from ray_lightning_tpu_torch.runtime import elastic
            from ray_lightning_tpu_torch.utils.ports import node_ip_address

            self._store_host = elastic.StoreHost(
                node_ip_address() if self._any_remote else "127.0.0.1")
            coordinator = self._store_host.new_address(n)
            return rt.get([w.init_elastic_distributed.remote(
                coordinator, n, rank, self.backend, idx, timeout)
                for rank, (w, idx) in enumerate(zip(self._workers, indices))],
                timeout=timeout + 30)
        port = rt.get(self._workers[0].find_free_port.remote(), timeout=timeout)
        init_method = f"tcp://{ips[0]}:{port}"
        return rt.get([w.init_distributed.remote(init_method, n, rank,
                                                 self.backend, idx, timeout)
                       for rank, (w, idx) in
                       enumerate(zip(self._workers, indices))],
                      timeout=timeout + 30)

    def _worker_env(self, boot_id: int, demand: Dict[str, float]
                    ) -> Dict[str, str]:
        """A worker's own variables: its rank from its first instruction (a
        fault scripted @boot fires before its ready line) and, as Ray does
        for an actor, ``OMP_NUM_THREADS`` = the CPUs it demands unless the
        caller set it: a host shared by several workers is not
        oversubscribed. The strategy's telemetry verdict is pinned there
        too, and the profiler's knobs as the driver has them now (empty when
        unset): a worker forked from the zygote inherits the zygote's
        boot-time environment, and a window armed in the driver after that
        would otherwise never open in it."""
        env = {faults.RANK_ENV: str(boot_id),
               # explicit in the child: a constructor-only telemetry=True
               # must reach the boot spans before the payload loads
               obs.trace.ENABLE_ENV: "1" if self._strategy.telemetry else "0"}
        for knob in obs.profiler.ENV_KNOBS:
            env[knob] = os.environ.get(knob, "")
        if "OMP_NUM_THREADS" not in os.environ:
            env["OMP_NUM_THREADS"] = str(max(1, math.ceil(demand["CPU"])))
        return env

    # ------------------------------------------------------------------ #
    def run_function_on_workers(self, payload: bytes,
                                fn_name: str = "fit") -> WorkerOutput:
        """Ship the payload and run the stage ``fn_name`` in every worker;
        rank 0's output, with the launch counts summed over the ranks."""
        t0 = time.perf_counter()
        payload_ref: Any = payload if self._any_remote else rt.put(payload)
        self.transport["payload"] = getattr(payload_ref, "backend", "inline")
        n = len(self._workers)
        queue = self._tune_queue
        queue_handle = queue.handle() if queue is not None else None
        hb = self._hb_queue
        interval = self._strategy.heartbeat_interval
        supervisor = None
        hb_handle = hb.handle() if hb is not None else None
        aggregator = self._make_aggregator(fn_name)
        controller = self._controller = self._make_elastic_controller(
            aggregator)
        if hb is not None:
            # hang_timeout None: monitor only, the thread pumps the beats
            # into the aggregator and never classifies or kills
            supervisor = self._supervisor = Supervisor(
                n, drain=lambda: hb.get_all(timeout=5.0),
                hang_timeout=self._strategy.hang_timeout,
                heartbeat_interval=interval,
                kill_group=self._kill_worker_group, is_alive=self._worker_alive,
                label=f"worker group ({n} ranks)",
                on_hung=controller.on_hung if controller is not None else None,
                aggregator=aggregator)
            if controller is not None:
                controller.supervisor = supervisor
            supervisor.start()
        self._spare_ctx = (payload_ref, queue_handle, hb_handle, interval)
        try:
            futures = [
                w.execute.remote(_wrapping_function, rank, n, payload_ref,
                                 self._worker_ranks[rank][1],
                                 self._worker_ranks[rank][0],
                                 self._devices[rank], queue_handle,
                                 hb_handle, interval, self.backend)
                for rank, w in enumerate(self._workers)
            ]
            if controller is not None:
                for rank, fut in enumerate(futures):
                    controller.register_future(fut, rank)
            results = process_results(futures, queue, supervisor, controller)
            received = time.time()
            if supervisor is not None:
                gaps = [h.max_gap for h in [*supervisor.health.values(),
                                            *supervisor.finished.values()]
                        if h is not None]
                self.timings["max_beat_gap_s"] = max(gaps, default=0.0)
        finally:
            self._spare_ctx = None
            if supervisor is not None:
                # the thread ends at once, or after its kill of the group
                supervisor.stop(timeout=_KILL_WAIT_S + 10)
                # the last forced beats (flush_telemetry) may still be in
                # the queue: the aggregator's last view takes every rank's
                # whole snapshot
                try:
                    for beat in hb.get_all(timeout=5.0):
                        supervisor.ingest(beat)
                except Exception:
                    pass
                self.heartbeat_traffic = list(getattr(hb, "traffic", ()))
            if aggregator is not None:
                aggregator.record_event("run_finished", fn=fn_name)
                rec = obs.get_recorder()
                out_dir = aggregator.finalize(
                    driver_events=rec.drain() if rec is not None else None)
                if out_dir:
                    print(f"RayLauncher: telemetry written to {out_dir}",
                          file=sys.stderr)
            if not isinstance(payload_ref, bytes):
                rt.delete(payload_ref)
        self.timings["run_s"] = time.perf_counter() - t0
        if controller is not None:
            self.elastic = {"resizes": dict(controller.resizes),
                            "members": list(controller.members),
                            "events": list(controller.events),
                            "worker_logs": [r.elastic_log for r in results]}
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

    def _make_aggregator(self, fn_name: str):
        """The main process's collector on the heartbeat channel, whenever
        the channel exists: ``full`` (trace and metrics files) only with
        telemetry, else the flight record of the verdicts alone."""
        self._aggregator = None
        if self._hb_queue is None:
            return None
        from ray_lightning_tpu_torch.observability.aggregator import (
            DriverAggregator,
            telemetry_dir,
        )

        trainer = self._launch_ctx[0] if self._launch_ctx else None
        root = getattr(trainer, "default_root_dir", None)
        n = self._strategy.num_workers
        aggregator = DriverAggregator(telemetry_dir(root), num_workers=n,
                                      full=self._strategy.telemetry)
        aggregator.record_event("run_started", fn=fn_name, workers=n)
        self._aggregator = aggregator
        return aggregator

    def _record_event(self, kind: str, **fields) -> None:
        """A line of the last stage's flight record, if it has one."""
        if self._aggregator is not None:
            self._aggregator.record_event(kind, **fields)

    def _make_elastic_controller(self, aggregator=None):
        """The stage's membership controller, in an elastic group only;
        its events and gauges go to ``aggregator``."""
        if self._store_host is None:
            return None
        from ray_lightning_tpu_torch.runtime import elastic

        trainer, launch_t0 = self._launch_ctx
        strategy = self._strategy
        controller = elastic.ElasticController(
            ledger=elastic.MembershipLedger(self._elastic_dir),
            host=self._store_host, num_workers=len(self._workers),
            min_workers=strategy.min_workers, kill_worker=self._kill_worker,
            spawn_worker=self._spawn_spare,
            find_restore=lambda: self._find_relaunch_checkpoint(trainer,
                                                                launch_t0),
            aggregator=aggregator)
        controller._publish()  # the world-size gauge before any resize
        return controller

    def _kill_worker(self, boot_id: int) -> None:
        """Evict one worker (an elastic shrink): kill it now and keep its
        device for the spare that replaces it."""
        if boot_id >= len(self._workers):
            return
        w = self._workers[boot_id]
        if boot_id not in self._evicted:
            self._evicted.add(boot_id)
            self._freed.append((self._devices[boot_id],
                                self._worker_ranks[boot_id][1]))
        try:
            rt.kill(w, force=True, timeout=_KILL_WAIT_S)
        except Exception as e:
            print(f"RayLauncher: killing {w.name}: {e}", file=sys.stderr)

    def _spawn_spare(self, boot_id: int, world_hint: int):
        """A warm spare for an elastic grow, forked from the zygote, on the
        device of a worker it replaces: it waits in its Trainer's join until
        a grow names ``boot_id``. Returns its stage's future."""
        from ray_lightning_tpu_torch.runtime import elastic

        payload_ref, queue_handle, hb_handle, interval = self._spare_ctx
        strategy = self._strategy
        device, local = (self._freed.pop(0) if self._freed
                         else (self._devices[0], self._worker_ranks[0][1]))
        demand = self._worker_demand()
        env = self._worker_env(boot_id, demand)
        env.update({elastic.ELASTIC_DIR_ENV: self._elastic_dir,
                    elastic.ELASTIC_JOINER_ENV: "1"})
        t = time.perf_counter()
        with obs.span("elastic/spawn_spare", boot_id=boot_id):
            [w] = rt.create_actors(
                [(RayExecutor, (), {})],
                names=[f"torchrt-worker-{boot_id}-{os.getpid()}-"
                       f"{secrets.token_hex(3)}"],
                per_actor_env=[env], demands=[demand],
                timeout=strategy.timeout_s, zygote=True)
        self.timings["spare_spawn_s"] = time.perf_counter() - t
        # workers are indexed by boot id: a spare's id is the next one
        self._workers.append(w)
        self._worker_ranks.append((0, local))
        self._devices.append(device)
        return w.execute.remote(_wrapping_function, boot_id, world_hint,
                                payload_ref, local, 0, device, queue_handle,
                                hb_handle, interval, self.backend)

    def _worker_alive(self, rank: int) -> bool:
        """The supervisor's probe: whether rank's process still runs. Only a
        local worker can be probed; a remote one counts as alive, so that
        its silence is a hang (killing it is safe either way)."""
        w = self._workers[rank] if rank < len(self._workers) else None
        if w is None or rt.actor_node_id(w) != 0 or not w._pid:
            return w is not None
        return not _exited(w._pid)

    def _kill_worker_group(self) -> None:
        """The supervisor's verdict: kill every worker now, and wait for
        each to exit. The survivors of a hung group wait in collectives with
        the hung rank: nothing graceful is left to do."""
        for w in list(self._workers):
            try:
                rt.kill(w, force=True, timeout=_KILL_WAIT_S)
            except Exception as e:
                print(f"RayLauncher: killing {w.name}: {e}", file=sys.stderr)

    def teardown_workers(self, force: bool = False) -> None:
        """Leave the process group, stop every worker process and the
        queues. ``force`` (after a failure) kills the workers at once: a
        survivor may be blocked in a collective with a dead rank. Either
        way every local worker has exited when this returns, so that a
        relaunched group finds its card free."""
        live = [w for w in self._workers
                if rt.actor_node_id(w) != 0 or not _exited(w._pid)]
        if live and not force:
            try:
                rt.get([w.shutdown_distributed.remote() for w in live],
                       timeout=30)
            except Exception as e:  # the kill below still reaps them
                print(f"RayLauncher: shutdown_distributed: {e}", file=sys.stderr)
        pids = [w._pid for w in self._workers
                if rt.actor_node_id(w) == 0 and w._pid]
        for w in self._workers:
            rt.kill(w, force=force, timeout=_KILL_WAIT_S if force else 5.0)
        self._workers = []
        deadline = time.monotonic() + _KILL_WAIT_S
        left = [p for p in pids if not _exited(p)]
        while left and time.monotonic() < deadline:
            time.sleep(0.05)
            left = [p for p in left if not _exited(p)]
        if left:
            raise RuntimeError(f"worker processes {left} did not exit within "
                               f"{_KILL_WAIT_S}s of being killed")
        for name in ("_tune_queue", "_hb_queue"):
            queue = getattr(self, name)
            if queue is not None:
                queue.shutdown()
                setattr(self, name, None)
        self._supervisor = None
        self._controller = None
        self._freed, self._evicted = [], set()
        if self._store_host is not None:
            self._store_host.shutdown()
            self._store_host = None
        if self._elastic_dir is not None:
            shutil.rmtree(self._elastic_dir, ignore_errors=True)
            self._elastic_dir = None
