"""Module-level trainables, actors and callbacks for the port's tune tests
(tests/test_torch_tune_run.py, tests/test_torch_tune_trainer.py,
tests/test_torch_cuda.py). Trial and worker processes import them by
reference from the main process's sys.path, so this module imports neither
JAX nor the JAX package at module level; the JAX twins of the trainables
import it inside their bodies, in the JAX package's trial processes."""
import dataclasses
import hashlib
import json
import os
import time

import torch

from ray_lightning_tpu_torch.callbacks import Callback

TIMEOUT = 60.0


def alive(pid):
    """Whether process ``pid`` still runs (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False


def wait_gone(pids, timeout=30.0):
    """The pids still alive after waiting up to ``timeout`` for them."""
    deadline = time.monotonic() + timeout
    left = [p for p in pids if alive(p)]
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        left = [p for p in left if alive(p)]
    return left


def touch_and_wait(shared_dir, tag, n, timeout=TIMEOUT):
    """Mark ``tag`` in ``shared_dir``, then wait (bounded) until ``n`` marks
    are there: trials that start seconds apart begin together."""
    os.makedirs(shared_dir, exist_ok=True)
    open(os.path.join(shared_dir, tag), "w").close()
    deadline = time.monotonic() + timeout
    while len(os.listdir(shared_dir)) < n and time.monotonic() < deadline:
        time.sleep(0.05)


# --------------------------------------------------------------------- #
# the controller: twin trainables of the JAX package's tune tests
# --------------------------------------------------------------------- #
def _fifo_body(sess, config):
    for it in range(3):
        sess.checkpoint(f"state-{it}-x{config['x']}".encode(), "ckpt.bin")
        sess.report(loss=config["x"] * (3 - it), x=config["x"])


def fifo_trainable(config):
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    _fifo_body(get_trial_session(), config)


def jax_fifo_trainable(config):
    from ray_lightning_tpu.tune.session import get_trial_session

    _fifo_body(get_trial_session(), config)


def digest_trainable(config, data=None):
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    digest = hashlib.sha256(data.tobytes()).hexdigest()
    with open(os.path.join(config["root"], f"seen-{config['i']}"), "w") as f:
        f.write(f"{digest} {data.shape[0]}")
    get_trial_session().report(done=1.0)


def flaky_trainable(config):
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    sess = get_trial_session()
    marker = os.path.join(config["root"], "crashed_once")
    start = 0
    ckpt = config.get("__checkpoint_path__")
    if ckpt:
        with open(ckpt, "rb") as f:
            start = int(f.read().decode())
    for it in range(start, 3):
        sess.checkpoint(str(it + 1).encode(), "progress.txt")
        sess.report(loss=float(3 - it), iter_seen=float(it))
        if it == 1 and not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("flaky crash")


def timeline_trainable(config):
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    with open(config["marker"], "a") as f:
        f.write(json.dumps({"event": "start", "t": time.time()}) + "\n")
    time.sleep(0.5)
    get_trial_session().report(loss=0.0)
    with open(config["marker"], "a") as f:
        f.write(json.dumps({"event": "end", "t": time.time()}) + "\n")


class Pinger:
    """A small actor a trial process starts from its own runtime."""

    def pid(self):
        return os.getpid()


def nested_cap_trainable(config):
    """The trial's runtime, brought up by the trial runner from the
    bundles, sees the worker bundles' CPUs, and refuses a spawn past them."""
    from ray_lightning_tpu_torch import runtime as nrt
    from ray_lightning_tpu_torch.runtime.actor import ActorError
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    with open(config["marker"], "a") as f:
        f.write(json.dumps({"event": "start", "t": time.time()}) + "\n")
    initialized = nrt.is_initialized()
    cap = nrt.cluster_resources()["CPU"]
    rejected = False
    try:
        nrt.create_actors([(Pinger, (), {})] * 3, demands=[{"CPU": 1.0}] * 3)
    except ActorError:
        rejected = True
    time.sleep(0.5)
    get_trial_session().report(loss=0.0, nested_cap=cap,
                               over_bundle_rejected=int(rejected),
                               initialized_by_runner=int(initialized))
    with open(config["marker"], "a") as f:
        f.write(json.dumps({"event": "end", "t": time.time()}) + "\n")


def pbt_trainable(config):
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    sess = get_trial_session()
    state = {"it": 0}
    ckpt = config.get("__checkpoint_path__")
    if ckpt and os.path.exists(ckpt):
        with open(ckpt) as f:
            state = json.loads(f.read())
    for _ in range(6):
        state["it"] += 1
        sess.checkpoint(json.dumps(state).encode(), "state.json")
        # the loss falls with the iterations, scaled by how good lr is
        sess.report(loss=10.0 * config["lr"] + 1.0 / state["it"], lr=config["lr"])
        # paced so that the controller acts mid-trial
        time.sleep(0.4)


def silent_trainable(config):
    """Never reports: the hang sweep must kill it."""
    with open(os.path.join(config["root"], f"silent-{os.getpid()}"), "w"):
        pass
    time.sleep(120)


def nested_actor_trainable(config):
    """Starts an actor from the trial's own runtime, records both pids,
    then reports ``config["loss"]`` ``config["reports"]`` times, 0.2 s
    apart."""
    from ray_lightning_tpu_torch import runtime as nrt
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    actor = nrt.create_actor(Pinger, timeout=TIMEOUT)
    pids = {"trial": os.getpid(), "nested": actor.pid.remote().result(TIMEOUT)}
    with open(os.path.join(config["root"], f"pids-{config['loss']}.json"),
              "w") as f:
        json.dump(pids, f)
    sess = get_trial_session()
    for _ in range(config["reports"]):
        sess.report(loss=config["loss"])
        time.sleep(0.2)


# --------------------------------------------------------------------- #
# the Trainer in a trial
# --------------------------------------------------------------------- #
def tiny_config(**fields):
    from ray_lightning_tpu_torch.models.llama import LlamaConfig

    fields = {"dtype": torch.float32, "max_seq": 32, **fields}
    return dataclasses.replace(LlamaConfig.tiny(), **fields)


class ValidationMetrics(Callback):
    """``callback_metrics`` at each validation's end, on global rank 0; the
    list comes back to the trial process in the callback states."""

    def __init__(self):
        self.rows = []

    def on_validation_end(self, trainer, module):
        if trainer.is_global_zero and not trainer.sanity_checking:
            self.rows.append({k: float(v.detach().cpu()) if torch.is_tensor(v)
                              else float(v)
                              for k, v in trainer.callback_metrics.items()})

    def state_dict(self):
        return {"rows": self.rows}

    def load_state_dict(self, state):
        self.rows = list(state["rows"])


class RestoreProbe(Callback):
    """At the start of training (after ``fit(ckpt_path=...)`` restored the
    checkpoint) writes whether the parameters equal the checkpoint's
    bitwise, on global rank 0."""

    def __init__(self, ckpt_path, out_path):
        self.ckpt_path, self.out_path = ckpt_path, out_path

    def on_train_start(self, trainer, module):
        if not trainer.is_global_zero:
            return
        from ray_lightning_tpu_torch.utils.serialization import load_state_stream
        from ray_lightning_tpu_torch.utils.tree import tree_leaves

        with open(self.ckpt_path, "rb") as f:
            want = load_state_stream(f.read())["state_dict"]
        got = [t.detach().cpu() for t in tree_leaves(trainer.params)]
        want = list(tree_leaves(want))
        same = len(got) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
        with open(self.out_path, "w") as f:
            json.dump({"bitwise": same, "global_step": trainer.global_step,
                       "leaves": len(got)}, f)


class Pace(Callback):
    """Sleeps after each validation (after the Tune callback reported), so
    that the controller sees the trials' reports interleave."""

    def __init__(self, seconds):
        self.seconds = seconds

    def on_validation_end(self, trainer, module):
        if not trainer.sanity_checking:
            time.sleep(self.seconds)


class CrashOnce(Callback):
    """Raises at the ``at``-th validation's end the first time (a marker
    file remembers it), after the Tune callback checkpointed and reported."""

    def __init__(self, marker, at):
        self.marker, self.at, self.seen = marker, at, 0

    def on_validation_end(self, trainer, module):
        if trainer.sanity_checking:
            return
        self.seen += 1
        if self.seen == self.at and not os.path.exists(self.marker):
            open(self.marker, "w").close()
            raise RuntimeError("planted crash after a checkpoint")


def _fit_in_trial(config, strategy, extra_callbacks=()):
    """A tiny fp32 LlamaModule fitted under the trial session: validation
    of one batch at every ``val_every`` steps, checkpoint and report at each
    through TuneReportCheckpointCallback (resuming from
    ``__checkpoint_path__`` when given, with a RestoreProbe)."""
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import LlamaModule, SyntheticLMDataModule
    from ray_lightning_tpu_torch.tune import TuneReportCheckpointCallback
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    torch.set_num_threads(1)
    sess = get_trial_session()
    cfg = tiny_config()
    ckpt = config.get("__checkpoint_path__")
    callbacks = [TuneReportCheckpointCallback({"val_loss": "val_loss"}),
                 ValidationMetrics(), *extra_callbacks]
    if ckpt:
        callbacks.append(RestoreProbe(ckpt, os.path.join(sess.trial_dir,
                                                          "restore.json")))
    module = LlamaModule(cfg, lr=config["lr"], warmup_steps=0,
                         total_steps=config["steps"])
    # 8 validation rows: one batch of 4 on each of up to two ranks
    dm = SyntheticLMDataModule(cfg, batch_size=4, n_train=4 * config["steps"],
                               n_val=8)
    trainer = Trainer(device="cpu", strategy=strategy,
                      max_steps=config["steps"], logger=False,
                      enable_checkpointing=False, seed=0,
                      val_check_interval=config.get("val_every", 1),
                      limit_val_batches=1, callbacks=callbacks)
    trainer.fit(module, datamodule=dm, ckpt_path=ckpt)
    with open(os.path.join(sess.trial_dir, "validation_metrics.json"), "w") as f:
        json.dump(callbacks[1].rows, f)
    return trainer


def resume_trainable(config):
    """One process: pace the reports, crash once if asked, resume from a
    checkpoint when given one."""
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    extra = [Pace(config.get("pace", 0.0))]
    if config.get("crash_at"):
        extra.append(CrashOnce(os.path.join(config["root"], "crashed"),
                               config["crash_at"]))
    if config.get("barrier"):
        touch_and_wait(config["barrier"], get_trial_session().trial_id,
                       config["trials"])
    _fit_in_trial(config, None, extra)


def ddp_trainable(config):
    """Two workers over gloo: the rows travel from rank 0's Tune callback
    through the session queue and the launcher's tune queue."""
    from ray_lightning_tpu_torch.strategies import RayStrategy

    _fit_in_trial(config, RayStrategy(num_workers=2, timeout_s=TIMEOUT))


def zero_trainable(config):
    """ZeRO stage 1 in one worker: crashes once after a checkpoint; the
    retry passes that checkpoint to fit, which resumes from it."""
    from ray_lightning_tpu_torch.strategies import RayShardedStrategy

    extra = [CrashOnce(os.path.join(config["root"], "crashed"), 2)]
    _fit_in_trial(config, RayShardedStrategy(num_workers=1, zero_stage=1,
                                             timeout_s=TIMEOUT), extra)


# --------------------------------------------------------------------- #
# the card: two trials sharing it
# --------------------------------------------------------------------- #
class WorkerPid(Callback):
    """Writes its worker's pid into ``directory`` at the start of fit."""

    def __init__(self, directory):
        self.directory = directory

    def on_fit_start(self, trainer, module):
        open(os.path.join(self.directory, f"worker-{os.getpid()}"), "w").close()


def cuda_sweep_trainable(config):
    """A narrow bf16 model, 2 steps through one worker that claims half the
    card, a validation after each step reported through TuneReportCallback."""
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import LlamaModule, SyntheticLMDataModule
    from ray_lightning_tpu_torch.strategies import RayStrategy
    from ray_lightning_tpu_torch.tune import TuneReportCallback
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    sess = get_trial_session()
    open(os.path.join(sess.trial_dir, f"trial-{os.getpid()}"), "w").close()
    cfg = tiny_config(dtype=torch.bfloat16, max_seq=128)
    module = LlamaModule(cfg, lr=config["lr"], warmup_steps=0, total_steps=2)
    dm = SyntheticLMDataModule(cfg, batch_size=4, n_train=8, n_val=4)
    trainer = Trainer(device="cuda", max_steps=2, logger=False,
                      enable_checkpointing=False, seed=0, val_check_interval=1,
                      limit_val_batches=1,
                      strategy=RayStrategy(num_workers=1, use_gpu=True,
                                           resources_per_worker={"GPU": 0.5},
                                           timeout_s=TIMEOUT),
                      callbacks=[TuneReportCallback({"val_loss": "val_loss"}),
                                 WorkerPid(sess.trial_dir)])
    trainer.fit(module, datamodule=dm)
