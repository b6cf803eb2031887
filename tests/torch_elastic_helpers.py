"""Module-level helpers for the port's elastic tests
(tests/test_torch_elastic.py, tests/test_torch_cuda.py). Worker processes
import them by reference from the main process's sys.path, so this module
imports neither JAX nor the JAX package."""
import glob
import hashlib
import json
import os

import numpy as np

from ray_lightning_tpu_torch.callbacks import Callback


class WorldProbe(Callback):
    """Every process of an elastic fit writes one record per epoch start
    (pid, epoch, step, world), one per applied step (step, world, logical
    rank, pid, and the step's batch as .npy) and a hash of its weights at
    the end of fit: pids prove which process lived through which resize,
    the step records let one process replay the same global batches, and
    the hashes prove the members end bitwise equal."""

    def __init__(self, probe_dir):
        self.probe_dir = probe_dir

    def _append(self, name, record):
        with open(os.path.join(self.probe_dir, name), "a") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def on_train_epoch_start(self, trainer, module):
        self._append(f"probe_{os.getpid()}.jsonl", {
            "pid": os.getpid(), "epoch": trainer.current_epoch,
            "step": trainer.global_step, "world": trainer.world_size})

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        # the hook runs after the step's update, before global_step moves
        step, rank = trainer.global_step, trainer.global_rank
        np.save(os.path.join(self.probe_dir, f"batch_s{step}_r{rank}.npy"),
                np.asarray(batch["input_ids"]))
        self._append(f"steps_{os.getpid()}.jsonl", {
            "step": step, "world": trainer.world_size, "rank": rank,
            "pid": os.getpid()})

    def on_fit_end(self, trainer, module):
        h = hashlib.sha256()
        for leaf in _leaves(trainer.params):
            h.update(np.ascontiguousarray(
                leaf.detach().float().cpu().numpy()).tobytes())
        with open(os.path.join(self.probe_dir, f"hash_{os.getpid()}"), "w") as f:
            f.write(h.hexdigest())


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _read_jsonl(pattern):
    out = []
    for path in glob.glob(pattern):
        with open(path) as f:
            out.extend(json.loads(line) for line in f if line.strip())
    return out


def read_probes(probe_dir):
    return _read_jsonl(os.path.join(probe_dir, "probe_*.jsonl"))


def read_hashes(probe_dir):
    out = {}
    for path in glob.glob(os.path.join(probe_dir, "hash_*")):
        with open(path) as f:
            out[os.path.basename(path)] = f.read().strip()
    return out


def global_batches(probe_dir):
    """The applied steps in order, each the union of its ranks' batches in
    rank order: what one process trains to follow the group. Raises when a
    step's records disagree on the world or miss a rank."""
    steps = {}
    for r in _read_jsonl(os.path.join(probe_dir, "steps_*.jsonl")):
        steps.setdefault(r["step"], []).append(r)
    out = []
    for step in sorted(steps):
        recs = steps[step]
        worlds = {r["world"] for r in recs}
        ranks = sorted(r["rank"] for r in recs)
        if len(worlds) != 1 or ranks != list(range(worlds.pop())):
            raise AssertionError(f"step {step}: records {recs}")
        rows = [np.load(os.path.join(probe_dir, f"batch_s{step}_r{r}.npy"))
                for r in ranks]
        out.append({"step": step, "world": len(ranks),
                    "batch": {"input_ids": np.concatenate(rows)}})
    return out


def replay_group(module, batches, rows, device="cpu", seed=0):
    """One process training ``batches`` (``global_batches``' records) in
    order with the group's arithmetic: at each step every rank's ``rows``
    rows in a forward and backward of their own, the gradients accumulated
    in the leaves (the sum the all-reduce makes), divided by the step's
    world, then the module's optimizer and schedule. One backward over the
    global batch would sum each leaf's contributions in another order (the
    chunked loss gives the head several), and AdamW turns that rounding
    into sign flips of near-zero gradients. Returns the parameter tree."""
    import torch

    from ray_lightning_tpu_torch.models.llama import lm_loss
    from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map

    gen = torch.Generator(device=device).manual_seed(seed)
    module.params = tree_map(lambda t: torch.nn.Parameter(t.detach().clone()),
                             module.init_params(gen, torch.device(device)))
    conf = module.configure_optimizers()
    opt, sched = conf["optimizer"], conf["lr_scheduler"]
    leaves = list(tree_leaves(module.params))
    for b in batches:
        tokens = torch.as_tensor(b["batch"]["input_ids"]).to(device)
        for chunk in tokens.split(rows):
            lm_loss(module.params, chunk, module.config)[0].backward()
        grads = [t.grad for t in leaves]
        if b["world"] > 1:
            torch._foreach_div_(grads, float(b["world"]))
        opt.step()
        sched.step()
        for t in leaves:
            t.grad = None
    return module.params
