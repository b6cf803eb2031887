"""Module-level helpers for the port's fault and relaunch tests
(tests/test_torch_faults.py, tests/test_torch_zero_resume.py,
tests/test_torch_cuda.py). Worker and trial processes import them by
reference from the main process's sys.path, so this module imports neither
JAX nor the JAX package."""
import dataclasses
import os
import time

import numpy as np
import torch

from ray_lightning_tpu_torch.callbacks import Callback
from ray_lightning_tpu_torch.core import LightningModule

TIMEOUT = 60.0


def tiny_config(**fields):
    from ray_lightning_tpu_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                               max_seq=32, **fields)


class EpochLog(Callback):
    """Appends each epoch that global rank 0 starts to ``path``: the proof
    of where a relaunched group resumed."""

    def __init__(self, path):
        self.path = path

    def on_train_epoch_start(self, trainer, module):
        if trainer.global_rank == 0:
            with open(self.path, "a") as f:
                f.write(f"{trainer.current_epoch}\n")


def read_epochs(path):
    with open(path) as f:
        return [int(line) for line in f.read().split()]


class WorkerPids(Callback):
    """Writes its worker's pid into ``directory`` at the start of fit."""

    def __init__(self, directory):
        self.directory = directory

    def on_fit_start(self, trainer, module):
        os.makedirs(self.directory, exist_ok=True)
        open(os.path.join(self.directory, str(os.getpid())), "w").close()


def pids_in(directory):
    return sorted(int(p) for p in os.listdir(directory)) if os.path.isdir(
        directory) else []


class RaiseAtStep(Callback):
    """Raises a user exception at the start of global step ``step``."""

    def __init__(self, step):
        self.step = step

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        if trainer.global_step == self.step:
            raise RuntimeError("planted user exception")


# --------------------------------------------------------------------- #
# tune trainables
# --------------------------------------------------------------------- #
class ExitOnce(Callback):
    """Kills its worker process (``os._exit``) at the start of epoch 1 the
    first time (a marker file remembers it), on rank 0."""

    def __init__(self, marker):
        self.marker = marker

    def on_train_epoch_start(self, trainer, module):
        if (trainer.global_rank == 0 and trainer.current_epoch >= 1
                and not os.path.exists(self.marker)):
            open(self.marker, "w").close()
            os._exit(1)


def relaunch_trainable(config):
    """A worker crash inside a trial: ``RayStrategy(max_failures=1)``
    relaunches the group from the epoch-0 checkpoint, and the trial reports
    its final epoch."""
    from ray_lightning_tpu_torch.callbacks import ModelCheckpoint
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import LlamaModule, SyntheticLMDataModule
    from ray_lightning_tpu_torch.strategies import RayStrategy
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    torch.set_num_threads(1)
    root = config["root"]
    cfg = tiny_config()
    trainer = Trainer(
        device="cpu", max_epochs=2, logger=False, seed=0,
        default_root_dir=root, limit_train_batches=2, limit_val_batches=1,
        strategy=RayStrategy(num_workers=1, max_failures=1, timeout_s=TIMEOUT),
        callbacks=[ModelCheckpoint(dirpath=os.path.join(root, "ckpts"),
                                   save_last=True),
                   ExitOnce(os.path.join(root, "crashed_once")),
                   EpochLog(os.path.join(root, "epochs_trained"))])
    trainer.fit(LlamaModule(cfg, lr=3e-3, warmup_steps=0, total_steps=4),
                datamodule=SyntheticLMDataModule(cfg, batch_size=4, n_train=8,
                                                 n_val=4))
    get_trial_session().report(final_epoch=float(trainer.current_epoch))


def hang_once_trainable(config):
    """Reports once, then hangs the first time (a marker file remembers
    it): the hang sweep kills it; the retry reports again and ends."""
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    sess = get_trial_session()
    marker = os.path.join(config["root"], "hung_once")
    sess.report(loss=1.0)
    if not os.path.exists(marker):
        open(marker, "w").close()
        while True:  # a real hang: only a kill ends it
            time.sleep(60)
    sess.report(loss=0.5)


# --------------------------------------------------------------------- #
# ZeRO checkpoints: the JAX test's MLP (tests/test_zero.py::_ZeroModel)
# --------------------------------------------------------------------- #
ZERO_ROWS, ZERO_BATCH, ZERO_IN, ZERO_HIDDEN, ZERO_OUT = 48, 16, 64, 300, 10


def zero_data():
    """The JAX test's data (``_loader``), cut to 48 rows: x [48, 64] and y
    [48, 10] from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, ZERO_IN).astype(np.float32)[:ZERO_ROWS]
    y = rng.randn(64, ZERO_OUT).astype(np.float32)[:ZERO_ROWS]
    return x, y


ZERO_LR, ZERO_MOMENTUM = 1e-2, 0.9


class ZeroMLP(LightningModule):
    """tanh(x W0 + b0) W1 + b1, the mean squared error: the port's twin of
    the JAX test's flax model, on a parameter tree of the same keys, with
    SGD with momentum (``optax.sgd(ZERO_LR, momentum=ZERO_MOMENTUM)``'s
    update)."""

    def __init__(self, params=None):
        super().__init__()
        self.params = params

    def init_params(self, generator, device=None):
        raise ValueError("ZeroMLP starts from given parameters")

    def training_step(self, params, batch, batch_idx):
        x, y = batch
        p = params["params"]
        h = torch.tanh(x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])
        out = h @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"]
        loss = torch.mean((out - y) ** 2)
        self.log("loss", loss)
        return loss

    def configure_optimizers(self):
        from ray_lightning_tpu_torch.utils.tree import tree_leaves

        return torch.optim.SGD(list(tree_leaves(self.params)), lr=ZERO_LR,
                               momentum=ZERO_MOMENTUM)


class RankRows:
    """The rows of each global batch of ``global_batch`` that this rank
    reads: its contiguous ``1 / world`` of it, in order, unshuffled (the
    rank and world from the process group, at iteration time). Over the
    ranks of a step they are the global batch of one process."""

    def __init__(self, n, global_batch):
        self.n, self.global_batch = n, global_batch

    def set_epoch(self, epoch):
        pass

    def _place(self):
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1

    def __len__(self):
        return self.n // self._place()[1]

    def __iter__(self):
        rank, world = self._place()
        per = self.global_batch // world
        out = []
        for b in range(self.n // self.global_batch):
            lo = b * self.global_batch + rank * per
            out.extend(range(lo, lo + per))
        return iter(out)


def zero_loader(world):
    """A loader of :func:`zero_data` whose batches are this rank's rows of
    each global batch of ``ZERO_BATCH`` at world size ``world``."""
    from ray_lightning_tpu_torch.core import DataLoader

    x, y = zero_data()
    return DataLoader(list(zip(x, y)), batch_size=ZERO_BATCH // world,
                      sampler=RankRows(ZERO_ROWS, ZERO_BATCH))
