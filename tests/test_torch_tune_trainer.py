"""The Tune callbacks (ray_lightning_tpu_torch/tune/callbacks.py) on the
port's Trainer, and the launcher's tune queue
(launchers/ray_launcher.py), on the CPU.

- Against the JAX Trainer: from the same fp32 weights, under a local trial
  session, TuneReportCheckpointCallback reports the same rows (keys, count,
  values within 1e-4 relative), none while sanity checking.
- Through ``tune.run``: a trainable fitting through ``RayStrategy`` over
  gloo reports from rank 0's worker through the session queue, the
  launcher's tune queue and the trial process to the controller; a PBT
  exploit and a ``max_failures`` retry resume from a checkpoint bitwise; a
  ZeRO stage 1 checkpoint holds no optimizer states and its resume raises
  (ROADMAP.md item 6d).
- Under an ep mesh every rank gathers the experts before rank 0 writes the
  checkpoint: no deadlock, every expert in it.

Workers and trials are bounded at 60 s (``timeout_s``), with at most 2
workers, and every session and runtime is stopped in a ``finally`` block."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.trainer import Trainer as JTrainer
from ray_lightning_tpu.models import llama as jllama
from ray_lightning_tpu.strategies.base import SingleDeviceStrategy as JSingle
from ray_lightning_tpu.tune import callbacks as jcallbacks
from ray_lightning_tpu.tune import session as jsession
from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch import tune
from ray_lightning_tpu_torch.core import Trainer
from ray_lightning_tpu_torch.models import llama as tllama
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.parallel.mesh import MeshSpec
from ray_lightning_tpu_torch.strategies import RayStrategy
from ray_lightning_tpu_torch.tune import callbacks as tcallbacks
from ray_lightning_tpu_torch.tune import session as tsession
from ray_lightning_tpu_torch.utils.serialization import load_state_stream
from ray_lightning_tpu_torch.utils.tree import tree_leaves

import torch_tune_helpers as helpers

TIMEOUT = helpers.TIMEOUT


@pytest.fixture(autouse=True)
def _two_threads_and_cleanup():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
    tsession.clear_trial_session()
    rt.shutdown()


class _Sink:
    """A trial session's report and checkpoint functions, recording."""

    def __init__(self):
        self.rows, self.checkpoints = [], []

    def report(self, metrics, iteration):
        self.rows.append((iteration, dict(metrics)))

    def checkpoint(self, data, name, iteration):
        self.checkpoints.append((iteration, name, data))
        return name


def _session(module, sink, trial_dir):
    return module.TrialSession("trial_00000", str(trial_dir), sink.report,
                               sink.checkpoint)


def test_report_rows_match_jax_trainer(tmp_path):
    """The JAX Trainer and the port's, on LlamaModule(tiny, fp32) from the
    same weights (two epochs of 5 steps, a validation at each epoch's end,
    one sanity-check batch first), each with TuneReportCheckpointCallback
    under a local trial session: the same rows at the same iterations, none
    from the sanity check, the checkpoint before each report; the port's
    last checkpoint loads back to the trained weights bitwise."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_dict(jcfg.to_dict())
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(3), jcfg))
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    dm_kw = dict(batch_size=4, n_train=20, n_val=8)
    trainer_kw = dict(max_steps=10, enable_checkpointing=False, seed=0,
                      logger=False, num_sanity_val_steps=1)

    jsink, tsink = _Sink(), _Sink()
    jsession.init_trial_session(_session(jsession, jsink, tmp_path))
    try:
        jmod = jllama.LlamaModule(jcfg, **kw)
        jmod._params = jax.tree_util.tree_map(jnp.asarray, tree)
        JTrainer(strategy=JSingle(), default_root_dir=str(tmp_path / "jax"),
                 callbacks=[jcallbacks.TuneReportCheckpointCallback()],
                 **trainer_kw).fit(
            jmod, datamodule=jllama.SyntheticLMDataModule(jcfg, **dm_kw))
    finally:
        jsession.clear_trial_session()
    tsession.init_trial_session(_session(tsession, tsink, tmp_path))
    tmod = tllama.LlamaModule(tcfg, **kw)
    tmod.params = params_from_jax(tree, tcfg, device="cpu")
    Trainer(device="cpu", default_root_dir=str(tmp_path / "port"),
            callbacks=[tune.TuneReportCheckpointCallback()], **trainer_kw).fit(
        tmod, datamodule=tllama.SyntheticLMDataModule(tcfg, **dm_kw))

    assert [i for i, _ in tsink.rows] == [i for i, _ in jsink.rows] == [1, 2]
    for (_, got), (_, want) in zip(tsink.rows, jsink.rows):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=0,
                                       err_msg=key)
    # each report's checkpoint was written first, at the report's iteration
    assert [(i, n) for i, n, _ in tsink.checkpoints] == [
        (i, n) for i, n, _ in jsink.checkpoints] == [(0, "checkpoint"),
                                                       (1, "checkpoint")]
    last = load_state_stream(tsink.checkpoints[-1][2])
    assert last["global_step"] == 10 and "optimizer_states" in last
    for a, b in zip(tree_leaves(last["state_dict"]), tree_leaves(tmod.params)):
        assert torch.equal(a, b.detach())


def test_ray_trial_reports_through_the_tune_queue(tmp_path):
    """``tune.run`` of a trainable fitting through RayStrategy(num_workers=2)
    over gloo: rank 0's reports reach the controller, one per validation,
    equal to the trainer's callback_metrics there; each checkpoint lands
    in the trial directory and loads back."""
    analysis = tune.run(
        helpers.ddp_trainable, config={"lr": 3e-3, "steps": 4, "val_every": 2},
        metric="val_loss", local_dir=str(tmp_path), name="ddp",
        resources_per_trial=tune.get_tune_resources(num_workers=2), verbose=0)
    (trial,) = analysis.trials
    assert trial.status == "TERMINATED", trial.error
    with open(os.path.join(trial.logdir, "validation_metrics.json")) as f:
        seen = json.load(f)
    assert len(seen) == len(trial.results) == 2
    for row, metrics in zip(trial.results, seen):
        assert row["val_loss"] == metrics["val_loss"]
    assert [r["training_iteration"] for r in trial.results] == [1, 2]
    assert [c["iteration"] for c in trial.checkpoints] == [0, 1]
    with open(trial.checkpoints[-1]["path"], "rb") as f:
        ckpt = load_state_stream(f.read())
    assert ckpt["global_step"] == 4
    with open(os.path.join(trial.logdir, "result.json")) as f:
        assert [json.loads(line) for line in f] == trial.results


def _restore(trial):
    with open(os.path.join(trial.logdir, "restore.json")) as f:
        return json.load(f)


def test_pbt_exploit_resumes_from_the_donor_bitwise(tmp_path):
    """Two trials start together (lr 3e-3 and 0.0, a validation and its
    checkpoint at every step, paced 0.4 s); at its second report the lr 0
    trial is last and PBT clones the other: it restarts from the donor's
    checkpoint, and its parameters after the restore equal that stream
    bitwise."""
    scheduler = tune.PopulationBasedTraining(
        metric="val_loss", mode="min", perturbation_interval=2,
        hyperparam_mutations={"lr": tune.loguniform(1e-4, 1e-2)},
        quantile_fraction=0.34, seed=0)
    analysis = tune.run(
        helpers.resume_trainable,
        config={"lr": tune.grid_search([3e-3, 0.0]), "steps": 6, "pace": 0.4,
                "barrier": str(tmp_path / "barrier"), "trials": 2},
        metric="val_loss", scheduler=scheduler, local_dir=str(tmp_path),
        name="pbt", max_concurrent_trials=2, verbose=0)
    assert all(t.status == "TERMINATED" for t in analysis.trials), [
        (t.status, t.error) for t in analysis.trials]
    donor, exploited = analysis.trials
    assert "__checkpoint_path__" in exploited.config
    assert exploited.config["__checkpoint_path__"].startswith(donor.logdir)
    restored = _restore(exploited)
    assert restored["bitwise"] and restored["global_step"] >= 2, restored


def test_max_failures_retry_resumes_from_its_checkpoint_bitwise(tmp_path):
    """A trial that crashes after its second checkpoint and report is
    retried from that checkpoint: parameters bitwise, no step lost."""
    analysis = tune.run(
        helpers.resume_trainable,
        config={"lr": 3e-3, "steps": 4, "crash_at": 2, "root": str(tmp_path)},
        metric="val_loss", local_dir=str(tmp_path), name="retry",
        max_failures=1, verbose=0)
    (trial,) = analysis.trials
    assert trial.status == "TERMINATED", trial.error
    assert trial.num_failures == 1
    assert trial.config["__checkpoint_path__"].endswith(
        "checkpoint_000001/checkpoint")
    restored = _restore(trial)
    assert restored == {"bitwise": True, "global_step": 2,
                        "leaves": restored["leaves"]}
    assert len(trial.results) == 4


def test_zero_checkpoint_resume_through_tune_is_refused(tmp_path):
    """RayShardedStrategy(zero_stage=1) writes the Tune checkpoint without
    optimizer states; the retry passes it to fit, which raises
    NotImplementedError, and the trial ends in ERROR with that message
    (a fence: ROADMAP.md item 6d rewrites it)."""
    analysis = tune.run(
        helpers.zero_trainable,
        config={"lr": 3e-3, "steps": 4, "root": str(tmp_path)},
        metric="val_loss", local_dir=str(tmp_path), name="zero",
        max_failures=1, verbose=0)
    (trial,) = analysis.trials
    assert trial.status == "ERROR"
    assert trial.num_failures == 1
    assert "NotImplementedError" in trial.error
    assert "ZeRO stage 1" in trial.error
    with open(trial.checkpoints[-1]["path"], "rb") as f:
        ckpt = load_state_stream(f.read())
    assert ckpt["zero_stage"] == 1 and "optimizer_states" not in ckpt


def test_checkpoint_under_an_ep_mesh_holds_every_expert(tmp_path):
    """A local trial session around a RayStrategy fit of a MoE model over
    ``MeshSpec(axes={"ep": 2})``: every rank gathers the experts, rank 0
    writes; the last checkpoint equals the weights the launcher returns,
    bitwise, with all E experts."""
    sink = _Sink()
    tsession.init_trial_session(_session(tsession, sink, tmp_path))
    cfg = helpers.tiny_config(n_experts=4)
    module = tllama.LlamaModule(cfg, lr=3e-3, warmup_steps=0, total_steps=2)
    trainer = Trainer(
        device="cpu", max_steps=2, logger=False, enable_checkpointing=False,
        seed=0, val_check_interval=1, limit_val_batches=1,
        strategy=RayStrategy(num_workers=2, timeout_s=TIMEOUT,
                             mesh_spec=MeshSpec(axes={"ep": 2})),
        callbacks=[tune.TuneReportCheckpointCallback({"val_loss": "val_loss"})])
    trainer.fit(module, datamodule=tllama.SyntheticLMDataModule(
        cfg, batch_size=4, n_train=8, n_val=4))
    assert [i for i, _ in sink.rows] == [1, 2]
    assert [i for i, _, _ in sink.checkpoints] == [0, 1]
    last = load_state_stream(sink.checkpoints[-1][2])
    assert last["state_dict"]["layers"]["moe"]["w_gate"].shape[1] == 4
    for a, b in zip(tree_leaves(last["state_dict"]), tree_leaves(module.params)):
        assert a.shape == b.shape and torch.equal(a, b.detach())
    assert len(last["optimizer_states"]) == 1


def test_callbacks_without_a_trial_session_or_queue():
    """Outside a trial, a report has nowhere to go: the in-place call
    raises as the JAX package's does, and ``put_queue`` without a queue
    raises as before."""
    from ray_lightning_tpu_torch import session as worker_session

    with pytest.raises(RuntimeError, match="no tune trial session"):
        tcallbacks._deliver(lambda: tsession.report(loss=1.0))
    worker_session.reset_session()
    worker_session.init_session(rank=0, queue=None)
    try:
        with pytest.raises(ValueError, match="no queue"):
            tcallbacks._deliver(lambda: None)
    finally:
        worker_session.reset_session()
