"""The tune controller (``ray_lightning_tpu/tune/tune.py``): trials as actors
of the port's runtime, scheduler-driven early stopping and PBT's
exploit/explore, retries and the hang sweep, result collection.

Each trial is a trial process (a :class:`_TrialRunner` actor) running the
user's trainable. Inside it, the trainable may build a Trainer with a Ray
strategy, which starts its own worker actors: the reference's process
topology. A worker's Tune callback hands a callable to the launcher's tune
queue; the launcher runs it in the trial process, where the trial session
puts ``("report" | "checkpoint", trial_id, payload, iteration)`` on the
controller's queue.

Where the port differs from the JAX package:

- The trainable is pickled with the standard library, by reference: it
  must be a function (or a callable class instance) importable at module
  level, not a lambda, a closure or a function of ``__main__``. Anything
  else raises ``TypeError`` in :func:`run` before any actor starts.
  :func:`with_parameters` returns such an instance.
- ``hang_timeout`` is an argument only (no environment variable), and the
  trial runner sizes its own nested runtime from a ``PlacementGroupFactory``
  (an argument of the trial call; the JAX package exports a variable).
- The accelerator is the CUDA card: ``get_tune_resources(use_gpu=True)``
  gives each worker bundle a ``"GPU"`` share; ``use_tpu=True`` raises.

PBT restore contract: an exploited trial restarts with the mutated config
plus ``config["__checkpoint_path__"]``, the donor's checkpoint; trainables
pass it to ``trainer.fit(ckpt_path=...)``. A retry resumes the same way from
the trial's own latest checkpoint.
"""
from __future__ import annotations

import json
import os
import pickle
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.runtime.actor import dumps
from ray_lightning_tpu_torch.tune.schedulers import (
    CONTINUE,
    EXPLOIT,
    STOP,
    FIFOScheduler,
    TrialScheduler,
)
from ray_lightning_tpu_torch.tune.search import generate_trial_configs, mutate_config


@dataclass(frozen=True)
class PlacementGroupFactory:
    """Trial resource bundles: a head bundle for the trial process plus one
    bundle per worker, strategy "PACK". The controller reserves
    ``total()`` for the whole trial."""

    bundles: Tuple[Dict[str, float], ...]
    strategy: str = "PACK"

    def total(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for bundle in self.bundles:
            for key, value in bundle.items():
                out[key] = out.get(key, 0.0) + float(value)
        return out


def get_tune_resources(
    num_workers: int = 1,
    num_cpus_per_worker: int = 1,
    use_gpu: bool = False,
    use_tpu: bool = False,
) -> PlacementGroupFactory:
    """``[{CPU: 1}] + num_workers * [{CPU: c, GPU: 1 / num_workers}]``: the
    workers of a trial split one card, the ``"GPU"`` key that
    ``RayStrategy(use_gpu=True)`` demands."""
    if use_tpu:
        raise ValueError(
            "get_tune_resources(use_tpu=True): the port runs on CUDA cards; "
            "pass use_gpu=True")
    head: Dict[str, float] = {"CPU": 1.0}
    worker: Dict[str, float] = {"CPU": float(num_cpus_per_worker)}
    if use_gpu:
        worker["GPU"] = 1.0 / num_workers
    return PlacementGroupFactory(
        bundles=(head,) + (dict(worker),) * num_workers, strategy="PACK"
    )


def _normalize_trial_demand(resources_per_trial) -> Dict[str, float]:
    if resources_per_trial is None:
        return {"CPU": 1.0}
    if isinstance(resources_per_trial, PlacementGroupFactory):
        return resources_per_trial.total()
    return {k: float(v) for k, v in dict(resources_per_trial).items()}


def max_concurrent_for(
    demand: Dict[str, float], cluster: Dict[str, float]
) -> int:
    """How many trials of ``demand`` fit in ``cluster`` at once (>= 1 so a
    single over-sized trial still runs rather than deadlocking)."""
    cap = None
    for key, value in demand.items():
        if value <= 0:
            continue
        have = cluster.get(key, 0.0)
        this = int(have // value)
        cap = this if cap is None else min(cap, this)
    return max(1, cap if cap is not None else 1)


def _host_cards() -> Optional[Dict[str, float]]:
    """This host's CUDA cards as the runtime's ``"GPU"`` resource."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"GPU": float(n)} if n else None


def _trainable_bytes(trainable: Callable) -> bytes:
    """The trainable pickled by reference, or ``TypeError`` naming the rule."""
    inner = getattr(trainable, "trainable", trainable)
    if getattr(inner, "__module__", None) == "__main__":
        raise TypeError(
            f"cannot send the trainable {inner!r} to a trial process: it is "
            "defined in __main__, which a trial process does not import. The "
            "port pickles with the standard library, by reference: define it "
            "at module level in an importable module")
    return dumps(trainable, f"the trainable {trainable!r}")


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    logdir: str
    status: str = "PENDING"  # RUNNING | TERMINATED | STOPPED | ERROR
    results: List[Dict[str, Any]] = field(default_factory=list)
    checkpoints: List[Dict[str, Any]] = field(default_factory=list)
    error: Optional[str] = None
    num_failures: int = 0
    last_iteration: int = 0
    _actor: Any = None
    _future: Any = None
    _last_activity: float = 0.0  # monotonic time of start/last message

    @property
    def last_result(self) -> Dict[str, Any]:
        return self.results[-1] if self.results else {}

    def metric_value(self, metric: str, mode: str) -> Optional[float]:
        values = [r[metric] for r in self.results if metric in r]
        if not values:
            return None
        return min(values) if mode == "min" else max(values)


class _TrialRunner:
    """Actor hosting one trial process."""

    def run(self, trainable_bytes, config, trial_id, trial_dir, queue_handle,
            num_cpus=None):
        """Run the trainable under a trial session. With ``num_cpus`` (a
        ``PlacementGroupFactory``'s worker bundles) the trial's own runtime
        is brought up with that many CPUs and the host's cards, what the
        launcher would give it; else it sizes itself."""
        from ray_lightning_tpu_torch.tune.session import (
            TrialSession,
            clear_trial_session,
            init_trial_session,
        )

        os.makedirs(trial_dir, exist_ok=True)
        queue = queue_handle
        trainable = pickle.loads(trainable_bytes)
        if num_cpus is not None:
            rt.init(num_cpus=num_cpus, resources=_host_cards())

        def report_fn(metrics, iteration):
            row = dict(metrics)
            row["training_iteration"] = iteration
            row["trial_id"] = trial_id
            with open(os.path.join(trial_dir, "result.json"), "a") as f:
                f.write(json.dumps(row) + "\n")
            queue.put(("report", trial_id, row, iteration))

        def checkpoint_fn(data: bytes, name: str, iteration: int) -> str:
            ckpt_dir = os.path.join(trial_dir, f"checkpoint_{iteration:06d}")
            os.makedirs(ckpt_dir, exist_ok=True)
            path = os.path.join(ckpt_dir, name)
            with open(path, "wb") as f:
                f.write(data)
            queue.put(("checkpoint", trial_id, path, iteration))
            return path

        init_trial_session(TrialSession(trial_id, trial_dir, report_fn, checkpoint_fn))
        try:
            trainable(config)
        finally:
            clear_trial_session()
            # the trial's own actors and object-store segments
            rt.shutdown()
        return "done"


class ExperimentAnalysis:
    def __init__(self, trials: List[Trial], metric: Optional[str], mode: str):
        self.trials = trials
        self.default_metric = metric
        self.default_mode = mode

    def _resolve(self, metric, mode):
        return metric or self.default_metric, mode or self.default_mode

    @property
    def best_trial(self) -> Optional[Trial]:
        return self.get_best_trial()

    def get_best_trial(self, metric=None, mode=None) -> Optional[Trial]:
        metric, mode = self._resolve(metric, mode)
        scored = [
            (t, t.metric_value(metric, mode))
            for t in self.trials
            if t.metric_value(metric, mode) is not None
        ]
        if not scored:
            return None
        return (min if mode == "min" else max)(scored, key=lambda kv: kv[1])[0]

    @property
    def best_config(self) -> Optional[Dict[str, Any]]:
        trial = self.best_trial
        return trial.config if trial else None

    @property
    def best_checkpoint(self) -> Optional[str]:
        trial = self.best_trial
        if trial and trial.checkpoints:
            return trial.checkpoints[-1]["path"]
        return None

    def dataframe(self) -> List[Dict[str, Any]]:
        return [
            {**t.last_result, "trial_id": t.trial_id, "status": t.status}
            for t in self.trials
        ]

    @property
    def results(self) -> Dict[str, List[Dict[str, Any]]]:
        return {t.trial_id: t.results for t in self.trials}


class _WithParameters:
    """The trainable of :func:`with_parameters`: it holds the user's
    trainable and the object-store refs, and its stdlib pickle carries only
    those (the trainable by reference)."""

    def __init__(self, trainable: Callable, refs: Dict[str, Any]):
        self.trainable = trainable
        self._rlt_parameter_refs = refs
        self.__name__ = getattr(trainable, "__name__", "trainable")

    def __call__(self, config):
        resolved = {k: rt.get(r) for k, r in self._rlt_parameter_refs.items()}
        return self.trainable(config, **resolved)

    def cleanup(self) -> None:
        """Free the segments (a long-lived main process calls it when done)."""
        for ref in self._rlt_parameter_refs.values():
            rt.delete(ref)
        self._rlt_parameter_refs.clear()


def with_parameters(trainable: Callable, **kwargs) -> _WithParameters:
    """Attach large objects (datasets, weights) to a trainable through the
    object store, one ``rt.put`` each, ONCE: every trial process maps the
    same segment and unpickles locally, instead of each trial's call
    carrying a copy. ``trainable(config, **kwargs)`` runs in the trial.

    Host-local (shared memory does not cross hosts). The segments live until
    this process's runtime shuts down or ``.cleanup()`` is called."""
    refs = {k: rt.put(v) for k, v in kwargs.items()}
    return _WithParameters(trainable, refs)


def run(
    trainable: Callable[[Dict[str, Any]], Any],
    config: Optional[Dict[str, Any]] = None,
    num_samples: int = 1,
    metric: Optional[str] = None,
    mode: str = "min",
    scheduler: Optional[TrialScheduler] = None,
    name: Optional[str] = None,
    local_dir: Optional[str] = None,
    resources_per_trial: Optional[Dict[str, float]] = None,
    max_concurrent_trials: Optional[int] = None,
    trial_env: Optional[Dict[str, str]] = None,
    seed: int = 0,
    poll_interval: float = 0.05,
    verbose: int = 1,
    max_failures: int = 0,
    hang_timeout: Optional[float] = None,
) -> ExperimentAnalysis:
    """``hang_timeout``: seconds a RUNNING trial may go without any report
    or checkpoint message before the controller declares it hung,
    force-kills the trial actor, and counts the hang toward the trial's
    ``max_failures`` retries (resuming from its latest checkpoint). Must
    exceed the trial's longest legitimate report interval, start-up
    included. None or 0 disables it."""
    trainable_bytes = _trainable_bytes(trainable)
    if not rt.is_initialized():
        rt.init(resources=_host_cards())
    hang_timeout = hang_timeout or None
    scheduler = scheduler or FIFOScheduler()
    name = name or f"tune-{int(time.time())}"
    local_dir = os.path.abspath(local_dir or os.path.join(os.getcwd(), "tune_results"))
    exp_dir = os.path.join(local_dir, name)
    os.makedirs(exp_dir, exist_ok=True)

    configs = generate_trial_configs(config, num_samples, seed=seed)
    trials = [
        Trial(
            trial_id=f"trial_{i:05d}",
            config=conf,
            logdir=os.path.join(exp_dir, f"trial_{i:05d}"),
        )
        for i, conf in enumerate(configs)
    ]
    by_id = {t.trial_id: t for t in trials}

    trial_demand = _normalize_trial_demand(resources_per_trial)
    if max_concurrent_trials is None:
        max_concurrent_trials = max_concurrent_for(
            trial_demand, rt.cluster_resources()
        )
    max_concurrent_trials = min(max_concurrent_trials, len(trials)) or 1

    # a trainable that starts workers (a Ray strategy) does so from the
    # trial's own runtime. With a PlacementGroupFactory that runtime gets
    # the worker bundles' CPUs (the total less the head), so concurrent
    # trials draw workers from their own reservations; a head-only factory
    # or a plain dict leaves it to size itself
    nested_cpus: Optional[float] = None
    if isinstance(resources_per_trial, PlacementGroupFactory):
        nested_cpus = max(
            trial_demand.get("CPU", 1.0)
            - resources_per_trial.bundles[0].get("CPU", 0.0),
            0.0,
        ) or None

    def _demand_fits_now() -> bool:
        # the trial actor's reservation must land on ONE node
        for node in rt.nodes():
            if all(
                node["available"].get(k, 0.0) >= v
                for k, v in trial_demand.items()
            ):
                return True
        return False

    def _largest_node_total() -> Dict[str, float]:
        out: Dict[str, float] = {}
        for node in rt.nodes():
            for key, value in node["total"].items():
                out[key] = max(out.get(key, 0.0), value)
        return out

    # trials on another host need a queue they can dial
    cross_host = any(n.get("remote") for n in rt.nodes())
    queue = rt.make_queue(cross_host=cross_host)

    def start_trial(trial: Trial):
        trial.status = "RUNNING"
        # the trial actor carries the WHOLE bundle's demand: its workers
        # start from the trial's own runtime, so this reservation is what
        # keeps concurrent trials from oversubscribing the host
        demand = dict(trial_demand)
        biggest = _largest_node_total()
        clamped = {k: v for k, v in demand.items() if v > biggest.get(k, 0.0)}
        if clamped:
            # a demand no node can hold runs at the largest node's capacity
            if verbose:
                print(
                    f"[tune] {trial.trial_id}: demand {clamped} exceeds "
                    f"every node (largest: {biggest}); clamping (trial "
                    "runs alone on the biggest node)"
                )
            demand = {k: min(v, biggest.get(k, 0.0)) for k, v in demand.items()}
        (trial._actor,) = rt.create_actors(
            [(_TrialRunner, (), {})],
            names=[f"tune-{name}-{trial.trial_id}-{time.monotonic_ns()}"],
            env=dict(trial_env or {}),
            demands=[demand],
        )
        trial._future = trial._actor.run.remote(
            trainable_bytes, trial.config, trial.trial_id, trial.logdir,
            queue.handle(), nested_cpus,
        )
        trial._last_activity = time.monotonic()

    def stop_trial(trial: Trial, status: str):
        trial.status = status
        if trial._actor is not None:
            # the runner's one call thread is busy with the trainable, so
            # the graceful call times out and the process is terminated;
            # its workers exit with it (runtime/actor_boot.py)
            rt.kill(trial._actor, timeout=2.0)
            trial._actor = None
        scheduler.on_complete(trial.trial_id)

    def reap_finished(trial: Trial) -> str:
        """Resolve a completed future into TERMINATED or ERROR."""
        try:
            trial._future.result()
            return "TERMINATED"
        except Exception:
            trial.error = traceback.format_exc()
            return "ERROR"

    def handle_decision(trial: Trial, decision, extra):
        if decision == STOP:
            # a trial that already ran to completion terminated (or errored)
            # naturally; STOP only means "don't let it run further"
            if trial._future is not None and trial._future.done():
                stop_trial(trial, reap_finished(trial))
            else:
                if verbose:
                    print(
                        f"[tune] {trial.trial_id} stopped by scheduler "
                        f"at iter {trial.last_iteration}"
                    )
                stop_trial(trial, "STOPPED")
        elif decision == EXPLOIT:
            source = by_id[extra]
            if verbose:
                print(f"[tune] {trial.trial_id} exploits {source.trial_id}")
            stop_trial(trial, "PENDING")
            # clone the WINNER's config, then explore around it
            mutations = getattr(scheduler, "hyperparam_mutations", {})
            rng = getattr(scheduler, "rng", None)
            if rng is not None and mutations:
                new_config = mutate_config(source.config, mutations, rng)
            else:
                new_config = dict(source.config)
            if source.checkpoints:
                new_config["__checkpoint_path__"] = source.checkpoints[-1]["path"]
            trial.config = new_config
            trial.status = "PENDING"

    def resolve_failure(trial: Trial):
        """A trial just entered ERROR (a crash or a hang): retry it up to
        ``max_failures`` times, from its latest checkpoint when it has one,
        or make it final. Drain first: a checkpoint written just before the
        failure may still sit in the queue."""
        if trial.num_failures >= max_failures:
            # a retried trial keeps its scheduler state (ASHA's rungs must
            # not count it twice), so on_complete fires only when final
            scheduler.on_complete(trial.trial_id)
            return
        drain_messages()
        trial.num_failures += 1
        trial._future = None
        trial.error = None
        if trial.checkpoints:
            trial.config = dict(
                trial.config,
                __checkpoint_path__=trial.checkpoints[-1]["path"],
            )
        if verbose:
            print(
                f"[tune] {trial.trial_id} errored; retry "
                f"{trial.num_failures}/{max_failures}"
            )
        trial.status = "PENDING"

    def sweep_hung_trials():
        """A RUNNING trial whose future never settles and whose messages
        have stopped for hang_timeout is force-killed and counts as a
        failure (toward max_failures, resuming from its latest
        checkpoint)."""
        now = time.monotonic()
        for trial in trials:
            if (
                trial.status != "RUNNING"
                or trial._future is None
                or trial._future.done()
            ):
                continue
            silent = now - trial._last_activity
            if silent <= hang_timeout:
                continue
            trial.error = (
                f"trial hung: no report or checkpoint for {silent:.1f}s "
                f"(hang_timeout={hang_timeout}s, last iteration "
                f"{trial.last_iteration}); trial actor killed"
            )
            if verbose:
                print(f"[tune] {trial.trial_id} {trial.error}")
            if trial._actor is not None:
                rt.kill(trial._actor, force=True, timeout=2.0)
                trial._actor = None
            trial._future = None
            trial.status = "ERROR"
            resolve_failure(trial)

    def drain_messages():
        for msg in queue.get_all():
            kind, trial_id, payload, iteration = msg
            trial = by_id[trial_id]
            trial._last_activity = time.monotonic()
            if kind == "report":
                trial.results.append(payload)
                trial.last_iteration = iteration
                decision, extra = scheduler.on_result(trial_id, payload, iteration)
                if decision != CONTINUE and trial.status == "RUNNING":
                    handle_decision(trial, decision, extra)
            elif kind == "checkpoint":
                trial.checkpoints.append({"path": payload, "iteration": iteration})

    try:
        while True:
            running = [t for t in trials if t.status == "RUNNING"]
            pending = [t for t in trials if t.status == "PENDING"]
            while (
                pending
                and len(running) < max_concurrent_trials
                and (_demand_fits_now() or not running)
            ):
                # queue (don't crash) when capacity is taken; an over-sized
                # demand still runs alone rather than deadlocking
                trial = pending.pop(0)
                start_trial(trial)
                running.append(trial)

            drain_messages()
            if hang_timeout:
                sweep_hung_trials()

            for trial in trials:
                if trial.status != "RUNNING" or trial._future is None:
                    continue
                if trial._future.done():
                    trial.status = reap_finished(trial)
                    if trial._actor is not None:
                        rt.kill(trial._actor, timeout=2.0)
                        trial._actor = None
                    if trial.status == "ERROR":
                        # a scheduler-STOPped trial is final by the
                        # scheduler's decision even if it errored
                        resolve_failure(trial)
                    else:
                        scheduler.on_complete(trial.trial_id)

            if all(t.status in ("TERMINATED", "STOPPED", "ERROR") for t in trials):
                # a trial's last reports may have landed in the queue after
                # this iteration's drain but before its future resolved
                drain_messages()
                break
            time.sleep(poll_interval)
    finally:
        for trial in trials:
            if trial._actor is not None:
                rt.kill(trial._actor, timeout=2.0)
        queue.shutdown()

    errored = [t for t in trials if t.status == "ERROR"]
    if errored and verbose:
        for t in errored:
            print(f"[tune] {t.trial_id} ERROR:\n{t.error}")

    analysis = ExperimentAnalysis(trials, metric, mode)
    with open(os.path.join(exp_dir, "experiment_state.json"), "w") as f:
        json.dump(
            [
                {
                    "trial_id": t.trial_id,
                    "status": t.status,
                    "config": {k: repr(v) for k, v in t.config.items()},
                    "last_result": t.last_result,
                    "checkpoints": t.checkpoints,
                }
                for t in trials
            ],
            f,
            indent=2,
            default=str,
        )
    return analysis
