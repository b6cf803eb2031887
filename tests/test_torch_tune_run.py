"""The port's tune controller (ray_lightning_tpu_torch/tune/tune.py) on the
CPU: ``tune.run`` with FIFO, ASHA and PBT, retries, the hang sweep,
``with_parameters`` and resource bundles, the JAX package's tests
(tests/test_tune.py, tests/test_pbt.py) ported, and a FIFO run held
against the JAX package's ``tune.run`` field by field.

The trainables are module-level functions of tests/torch_tune_helpers.py:
the port pickles them with the standard library, by reference. Every run
is bounded (trials finish in seconds, the hang sweep at a few seconds) and
the runtime is shut down in a ``finally`` block."""
import json
import os
import pickle

import numpy as np
import pytest

from ray_lightning_tpu import runtime as jrt
from ray_lightning_tpu import tune as jtune
from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch import tune

import torch_tune_helpers as helpers


@pytest.fixture(autouse=True)
def _runtime_down():
    yield
    rt.shutdown()


def _files(root):
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_fifo_run_matches_jax(tmp_path):
    """Twin trainables (a checkpoint and a report per iteration, as
    tests/test_tune.py::test_tune_run_reports_and_analysis) through both
    packages' ``tune.run``: the same trial ids, configs, statuses, rows,
    result.json lines, checkpoint files and bytes, best config and best
    checkpoint."""
    kw = dict(config={"x": tune.grid_search([5.0, 1.0])}, num_samples=1,
              metric="loss", mode="min", name="exp", verbose=0)
    try:
        want = jtune.run(helpers.jax_fifo_trainable, local_dir=str(tmp_path / "jax"),
                         trial_env={"JAX_PLATFORMS": "cpu"},
                         **dict(kw, config={"x": jtune.grid_search([5.0, 1.0])}))
    finally:
        jrt.shutdown()
    got = tune.run(helpers.fifo_trainable, local_dir=str(tmp_path / "port"), **kw)
    assert [t.trial_id for t in got.trials] == [t.trial_id for t in want.trials] \
        == ["trial_00000", "trial_00001"]
    assert [t.config for t in got.trials] == [t.config for t in want.trials]
    assert [t.status for t in got.trials] == [t.status for t in want.trials] \
        == ["TERMINATED"] * 2
    assert got.results == want.results
    assert all(len(rows) == 3 for rows in got.results.values())
    assert got.dataframe() == want.dataframe()
    assert got.best_config == want.best_config == {"x": 1.0}
    root_got, root_want = tmp_path / "port" / "exp", tmp_path / "jax" / "exp"
    assert os.path.relpath(got.best_checkpoint, root_got) == os.path.relpath(
        want.best_checkpoint, root_want) == "trial_00001/checkpoint_000002/ckpt.bin"
    files_got, files_want = _files(root_got), _files(root_want)
    state_got = json.loads(files_got.pop("experiment_state.json"))
    state_want = json.loads(files_want.pop("experiment_state.json"))
    assert files_got == files_want  # result.json lines and checkpoint bytes
    assert len(files_got) == 2 * 4
    for a, b in zip(state_got, state_want):
        for ckpt_a, ckpt_b in zip(a.pop("checkpoints"), b.pop("checkpoints")):
            assert os.path.relpath(ckpt_a["path"], root_got) == os.path.relpath(
                ckpt_b["path"], root_want)
            assert ckpt_a["iteration"] == ckpt_b["iteration"]
        assert a == b


def test_with_parameters_ships_large_objects_once(tmp_path):
    """A 16 MB array goes into the object store once: the wrapper's stdlib
    pickle carries only the ref (and the trainable by reference), and every
    trial process reads the same values."""
    import hashlib

    big = np.arange(2_000_000, dtype=np.float64)
    wrapped = tune.with_parameters(helpers.digest_trainable, data=big)
    payload = pickle.dumps(wrapped)
    assert len(payload) < 100_000, len(payload)
    (ref,) = wrapped._rlt_parameter_refs.values()
    assert ref.size > big.nbytes
    assert wrapped.__name__ == "digest_trainable"
    analysis = tune.run(
        wrapped, config={"root": str(tmp_path), "i": tune.grid_search([0, 1, 2])},
        metric="done", mode="max", local_dir=str(tmp_path), name="exp_withparams",
        verbose=0)
    assert len(analysis.trials) == 3
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    expect = f"{hashlib.sha256(big.tobytes()).hexdigest()} {big.shape[0]}"
    for i in range(3):
        with open(tmp_path / f"seen-{i}") as f:
            assert f.read() == expect
    wrapped.cleanup()
    assert not wrapped._rlt_parameter_refs


def test_max_failures_retries_errored_trials(tmp_path):
    """A trial that errors retries up to ``max_failures`` times, from its
    latest checkpoint; without the knob the error is final."""
    kw = dict(config={"root": str(tmp_path)}, metric="loss", mode="min",
              local_dir=str(tmp_path), verbose=0)
    analysis = tune.run(helpers.flaky_trainable, name="exp_flaky",
                        max_failures=1, **kw)
    (trial,) = analysis.trials
    assert trial.status == "TERMINATED"
    assert trial.num_failures == 1
    assert trial.error is None
    assert [r["iter_seen"] for r in trial.results] == [0.0, 1.0, 2.0]
    # the checkpoint before the crash's report: two reports had been made
    assert trial.config["__checkpoint_path__"].endswith(
        "checkpoint_000001/progress.txt")

    os.remove(tmp_path / "crashed_once")
    analysis = tune.run(helpers.flaky_trainable, name="exp_flaky2", **kw)
    (trial,) = analysis.trials
    assert trial.status == "ERROR"
    assert "flaky crash" in trial.error


def _kinds(marker):
    with open(marker) as f:
        events = [json.loads(line) for line in f]
    return [e["event"] for e in sorted(events, key=lambda e: e["t"])]


def test_trials_reserve_cluster_capacity(tmp_path):
    """Each trial reserves its whole demand: at half the host's CPUs plus
    one, two trials run one after the other."""
    rt.init(num_cpus=4)
    marker = str(tmp_path / "timeline.jsonl")
    analysis = tune.run(helpers.timeline_trainable, config={"marker": marker},
                        num_samples=2, metric="loss", local_dir=str(tmp_path),
                        resources_per_trial={"CPU": 3}, verbose=0)
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    assert _kinds(marker) == ["start", "end", "start", "end"]


def test_nested_workers_respect_bundles(tmp_path):
    """With a PlacementGroupFactory the trial runner brings the trial's own
    runtime up with the worker bundles' CPUs (3 - the head's 1 = 2; an
    argument of the trial call, no environment variable), so a spawn past
    them is refused; two 3-CPU trials on a 5-CPU host run in turn."""
    rt.init(num_cpus=5)
    marker = str(tmp_path / "timeline.jsonl")
    analysis = tune.run(
        helpers.nested_cap_trainable, config={"marker": marker}, num_samples=2,
        metric="loss", local_dir=str(tmp_path),
        resources_per_trial=tune.get_tune_resources(num_workers=2,
                                                    num_cpus_per_worker=1),
        verbose=0)
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    for t in analysis.trials:
        assert t.last_result["nested_cap"] == 2.0, t.last_result
        assert t.last_result["over_bundle_rejected"] == 1, t.last_result
        assert t.last_result["initialized_by_runner"] == 1, t.last_result
    assert _kinds(marker) == ["start", "end", "start", "end"]


def test_pbt_exploits_and_improves(tmp_path):
    """tests/test_pbt.py on the port: the population moves to the low lr
    and some trial restarts from a donor's checkpoint."""
    scheduler = tune.PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=2,
        hyperparam_mutations={"lr": tune.loguniform(1e-3, 1.0)},
        quantile_fraction=0.34, seed=0)
    analysis = tune.run(
        helpers.pbt_trainable, config={"lr": tune.grid_search([0.001, 0.5, 0.9])},
        metric="loss", mode="min", scheduler=scheduler, local_dir=str(tmp_path),
        name="pbt", max_concurrent_trials=3, verbose=0)
    assert analysis.best_config is not None
    assert analysis.best_config["lr"] <= 0.01
    exploited = [t for t in analysis.trials if "__checkpoint_path__" in t.config]
    assert exploited, "no trial exploited a donor checkpoint"
    statuses = {t.trial_id: t.status for t in analysis.trials}
    assert all(s in ("TERMINATED", "STOPPED") for s in statuses.values()), statuses


def test_hang_timeout_kills_a_silent_trial(tmp_path):
    """``hang_timeout`` (an argument; the port reads no variable): a trial
    that sends nothing for that long is killed and ends in ERROR, and its
    process is gone. The timeout counts from the trial's start, so it
    leaves the trial process room to import torch on a loaded host."""
    analysis = tune.run(helpers.silent_trainable, config={"root": str(tmp_path)},
                        metric="loss", local_dir=str(tmp_path), hang_timeout=12.0,
                        verbose=0)
    (trial,) = analysis.trials
    assert trial.status == "ERROR"
    assert "trial hung" in trial.error
    (name,) = [n for n in os.listdir(tmp_path) if n.startswith("silent-")]
    assert helpers.wait_gone([int(name.split("-")[1])], timeout=10) == []


class RecordingASHA(tune.ASHAScheduler):
    """ASHA that keeps the iteration of each trial's first STOP."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.stops = {}

    def on_result(self, trial_id, metrics, iteration):
        decision = super().on_result(trial_id, metrics, iteration)
        if decision[0] == "STOP":
            self.stops.setdefault(trial_id, iteration)
        return decision


def test_stopped_trials_leave_no_process(tmp_path):
    """ASHA stops both trials while they run (the worse at rung 1, the
    better at max_t); each had started an actor from its own runtime. After
    ``run`` returns, neither the trial processes nor their actors remain:
    an actor exits with the process that created it. (As in the JAX
    package, reports a trial makes while it is being stopped still reach
    its results.)"""
    scheduler = RecordingASHA(metric="loss", mode="min", max_t=3,
                              grace_period=1, reduction_factor=2)
    analysis = tune.run(
        helpers.nested_actor_trainable,
        config={"root": str(tmp_path), "loss": tune.grid_search([1.0, 5.0]),
                "reports": 300},
        metric="loss", scheduler=scheduler, local_dir=str(tmp_path),
        max_concurrent_trials=1, verbose=0)
    assert [t.status for t in analysis.trials] == ["STOPPED", "STOPPED"]
    assert scheduler.stops == {"trial_00000": 3, "trial_00001": 1}
    pids = []
    for loss in (1.0, 5.0):
        with open(tmp_path / f"pids-{loss}.json") as f:
            entry = json.load(f)
        assert entry["nested"] != entry["trial"]
        pids += [entry["trial"], entry["nested"]]
    assert helpers.wait_gone(pids, timeout=10) == []


def _local():
    def closure(config):  # pragma: no cover - never sent
        return config

    return closure


@pytest.mark.parametrize("make", [lambda: (lambda config: None), _local,
                                  lambda: tune.with_parameters(_local(), x=1)],
                         ids=["lambda", "closure", "with_parameters_closure"])
def test_unpicklable_trainable_is_refused_before_any_actor(tmp_path, make):
    """A lambda, a closure, or ``with_parameters`` of one: ``TypeError``
    naming the module-level rule, before any actor or directory exists."""
    trainable = make()
    with pytest.raises(TypeError, match="module level"):
        tune.run(trainable, config={"x": 1}, local_dir=str(tmp_path), verbose=0)
    assert os.listdir(tmp_path) == []
    assert rt.api._state.actors == {}
