"""ZeRO checkpoints that resume (ray_lightning_tpu_torch/parallel/
data_parallel.py: ``gather_zero_state``, ``slice_zero_state``;
core/trainer.py: ``whole_state``, ``_restore_checkpoint``), on the CPU over
gloo.

The JAX flow of tests/test_zero.py:278 (a ZeRO stage 3 fit of 3 steps,
``save_checkpoint``, a second fit from it to step 6) on the JAX test's MLP
and data (64 -> 300 tanh -> 10, the squared error; 48 rows of its
``RandomState(0)`` data, global batches of 16 in order) is the reference,
with SGD with momentum 0.9 at lr 1e-2 in place of its Adam. Adam divides
each element's step by that element's own gradient magnitude, so where a
gradient cancels to near zero, a difference in the order of a sum (4 devices
in JAX, 2 ranks or 1 process here) moves the element by a part of lr: with
Adam, 4 of the first layer's 19,200 weights end 1.7e-6 apart, the rest
within 1e-6. The momentum buffer is a per-element state as Adam's moments
are, and the scalar state (Adam's step) is held by
``test_whole_state_round_trips_through_the_shards`` (AdamW, bitwise) and
``test_zero3_crash_resume_is_bitwise``.

Both packages start from the same numpy weights. The port writes its
checkpoint under one (world size, ZeRO stage) at step 3 and resumes it
under another to step 6: the final weights equal the JAX flow's within
1e-6, and the checkpoint's ``optimizer_states`` (whole, in the optimizer's
parameter order) equal those of a one-process fit of the same 3 steps
within 1e-6 of each state's largest element (fp32). Each case starts at
most 2 worker processes at a time, bounded at 60 s (``timeout_s``), and
stops the runtime in a ``finally`` block.
"""
import dataclasses
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_lightning_tpu as rlt
from ray_lightning_tpu.parallel.sharding import ShardingPolicy as JShardingPolicy
from ray_lightning_tpu.strategies.base import XLAStrategy
from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.callbacks import ModelCheckpoint
from ray_lightning_tpu_torch.core import Trainer
from ray_lightning_tpu_torch.strategies import RayShardedStrategy, RayStrategy
from ray_lightning_tpu_torch.utils.tree import tree_map

import torch_fault_helpers as helpers

TIMEOUT = helpers.TIMEOUT
WRITE_STEPS, RESUME_STEPS = 3, 6
TOL = 1e-6


class _JaxNet(nn.Module):
    @nn.compact
    def __call__(self, x):
        h = nn.tanh(nn.Dense(helpers.ZERO_HIDDEN)(x))
        return nn.Dense(helpers.ZERO_OUT)(h)


class _JaxZeroModel(rlt.LightningModule):
    """tests/test_zero.py's ``_ZeroModel``, from given parameters, with
    SGD with momentum."""

    def __init__(self, params):
        super().__init__()
        self.net = _JaxNet()
        self._params = params

    def training_step(self, params, batch, batch_idx):
        x, y = batch
        loss = jnp.mean((self.net.apply(params, x) - y) ** 2)
        self.log("loss", loss)
        return loss

    def configure_optimizers(self):
        return optax.sgd(helpers.ZERO_LR, momentum=helpers.ZERO_MOMENTUM)


def _init_weights():
    """The MLP's weights as numpy arrays, from a seeded generator, in
    flax's tree ({"params": {"Dense_i": {"kernel", "bias"}}})."""
    rng = np.random.default_rng(7)
    dims = [(helpers.ZERO_IN, helpers.ZERO_HIDDEN),
            (helpers.ZERO_HIDDEN, helpers.ZERO_OUT)]
    return {"params": {f"Dense_{i}": {
        "kernel": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(b)).astype(np.float32)}
        for i, (a, b) in enumerate(dims)}}


def _jax_flow(tmp_path, weights):
    """tests/test_zero.py:278's flow, ZeRO stage 3 over 4 devices: 3 steps,
    ``save_checkpoint``, a fresh Trainer resuming it to step 6."""
    x, y = helpers.zero_data()
    loader = rlt.DataLoader(
        list(zip(x, y)), batch_size=helpers.ZERO_BATCH,
        collate_fn=lambda items: (np.stack([i[0] for i in items]),
                                  np.stack([i[1] for i in items])))
    policy = JShardingPolicy(zero_stage=3, data_axes=("dp",),
                             min_shard_size=1000)

    def trainer(steps):
        return rlt.Trainer(strategy=XLAStrategy(devices=4,
                                                sharding_policy=policy),
                           max_steps=steps, max_epochs=20,
                           enable_progress_bar=False,
                           enable_checkpointing=False, logger=False, seed=0)

    first = trainer(WRITE_STEPS)
    first.fit(_JaxZeroModel(jax.tree.map(jnp.asarray, weights)), loader)
    path = os.path.join(str(tmp_path), "jax.ckpt")
    first.save_checkpoint(path)
    second = trainer(RESUME_STEPS)
    second.fit(_JaxZeroModel(jax.tree.map(jnp.asarray, weights)), loader,
               ckpt_path=path)
    assert second.global_step == RESUME_STEPS
    assert second._train_program == "zero_train_step"
    return jax.tree.map(np.asarray, jax.device_get(second._params))


def _port_params(weights):
    return tree_map(lambda a: torch.from_numpy(a.copy()), weights)


def _port_fit(root, strategy, weights, steps, ckpt_path=None):
    """The port's twin on ``strategy`` (None: the main process) at world
    size ``w``: each rank reads its contiguous part of every global batch of
    16; a checkpoint at the end of fit. Returns the module and the
    checkpoint's path."""
    world = strategy.num_workers if strategy is not None else 1
    module = helpers.ZeroMLP(_port_params(weights))
    ckpts = os.path.join(str(root), "ckpts")
    trainer = Trainer(device="cpu", strategy=strategy, max_steps=steps,
                      max_epochs=20, logger=False, seed=0,
                      callbacks=[ModelCheckpoint(dirpath=ckpts)])
    try:
        trainer.fit(module, train_dataloaders=helpers.zero_loader(world),
                    ckpt_path=ckpt_path)
    finally:
        rt.shutdown()
    assert trainer.global_step == steps
    (name,) = [n for n in os.listdir(ckpts) if f"step={steps}" in n]
    return module, os.path.join(ckpts, name)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX flow's final weights, and a one-process port fit of the
    first 3 steps: its checkpoint (stage 0 optimizer states)."""
    root = tmp_path_factory.mktemp("zero_reference")
    weights = _init_weights()
    final = _jax_flow(root, weights)
    _, one_ckpt = _port_fit(root / "one", None, weights, WRITE_STEPS)
    return {"weights": weights, "jax_final": final, "one_ckpt": one_ckpt}


def _strategy(world, stage):
    if stage == 0 and world == 1:
        return None
    cls = RayShardedStrategy if stage else RayStrategy
    kw = {"zero_stage": stage} if stage else {}
    return cls(num_workers=world, timeout_s=TIMEOUT, **kw)


def _assert_states_close(got, want):
    """Two whole optimizer states (stage 0's layout): the same parameter
    groups and keys, each tensor within TOL of the largest element of its
    reference."""
    assert len(got["param_groups"]) == len(want["param_groups"])
    for g, w in zip(got["param_groups"], want["param_groups"]):
        assert g["params"] == w["params"] and g["lr"] == w["lr"]
    assert sorted(got["state"]) == sorted(want["state"])
    for idx, state in want["state"].items():
        assert sorted(got["state"][idx]) == sorted(state)
        for key, w in state.items():
            g = got["state"][idx][key]
            assert g.shape == w.shape and g.dtype == w.dtype, key
            if not w.dim():
                assert torch.equal(g, w), (idx, key)
                continue
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= TOL * scale, (idx, key)


CASES = {
    # (written at world, stage) -> (resumed at world, stage)
    "zero1_w2_to_one_process": ((2, 1), (1, 0)),
    "zero2_w2_to_zero3_w2": ((2, 2), (2, 3)),
    "zero3_w2_to_zero1_w1": ((2, 3), (1, 1)),
    "stage0_one_process_to_zero2_w2": ((1, 0), (2, 2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_zero_checkpoint_resumes_at_another_world_and_stage(case, reference,
                                                            tmp_path):
    (w_world, w_stage), (r_world, r_stage) = CASES[case]
    weights = reference["weights"]
    if (w_world, w_stage) == (1, 0):
        ckpt_path = reference["one_ckpt"]
    else:
        _, ckpt_path = _port_fit(tmp_path / "write",
                                 _strategy(w_world, w_stage), weights,
                                 WRITE_STEPS)
    ckpt = _load(ckpt_path)
    assert ckpt.get("zero_stage", 0) == w_stage
    assert ckpt["global_step"] == WRITE_STEPS
    (states,) = ckpt["optimizer_states"]
    (want,) = _load(reference["one_ckpt"])["optimizer_states"]
    _assert_states_close(states, want)
    module, _ = _port_fit(tmp_path / "resume", _strategy(r_world, r_stage),
                          weights, RESUME_STEPS, ckpt_path=ckpt_path)
    want = reference["jax_final"]["params"]
    got = module.params["params"]
    for layer in want:
        for name, w in want[layer].items():
            g = got[layer][name].detach().numpy()
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL,
                                       err_msg=f"{layer}/{name}")


def test_whole_state_round_trips_through_the_shards():
    """``slice_zero_state`` of ``gather_zero_state`` at world 1 is the
    optimizer's own state, and a stage-0 optimizer loads the whole state:
    both optimizers then take the same step bitwise."""
    from ray_lightning_tpu_torch.core.trainer import _Update
    from ray_lightning_tpu_torch.parallel.data_parallel import DataParallel

    gen = torch.Generator().manual_seed(3)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    whole = [torch.nn.Parameter(torch.randn(s, generator=gen)) for s in shapes]
    sharded = [torch.nn.Parameter(t.detach().clone()) for t in whole]
    grads = [torch.randn(s, generator=gen) for s in shapes]
    opt_w = torch.optim.AdamW(whole, lr=1e-2)
    opt_s = torch.optim.AdamW(sharded, lr=1e-2)
    dp = DataParallel(1, 0, 1, torch.device("cpu"))
    dp.setup([_Update([opt_s], [], sharded)])
    for p, g in zip(whole, grads):
        p.grad = g.clone()
    opt_w.step()
    for p, g in zip(sharded, grads):
        p.grad = g.clone()
    dp.sharded_update(0, _Update([opt_s], [], sharded), 1, None)
    gathered = dp.gather_zero_state(opt_s)
    assert sorted(gathered["state"]) == [0, 1, 2]
    for i, p in enumerate(whole):
        for key, value in opt_w.state[p].items():
            assert torch.equal(gathered["state"][i][key], value), (i, key)
    sliced = dp.slice_zero_state(opt_s, gathered)
    own = opt_s.state_dict()
    for key, value in own["state"][0].items():
        assert torch.equal(sliced["state"][0][key], value), key
    fresh = [torch.nn.Parameter(t.detach().clone()) for t in whole]
    opt_f = torch.optim.AdamW(fresh, lr=1e-2)
    opt_f.load_state_dict(gathered)
    for p, q, g in zip(whole, fresh, grads):
        p.grad, q.grad = g.clone(), g.clone()
    opt_w.step()
    opt_f.step()
    for p, q in zip(whole, fresh):
        assert torch.equal(p, q)


@pytest.mark.parametrize("mesh", ["dp", "ep"])
def test_zero3_crash_resume_is_bitwise(mesh, tmp_path, monkeypatch):
    """ZeRO stage 3 with AdamW at world 2 (``dp``: LlamaConfig.tiny(),
    two data-parallel ranks; ``ep``: tiny_moe over ``MeshSpec(axes={"ep":
    2})``, each rank holding half the experts in flat groups of their own):
    rank 1 crashes at step 3 (fused); the group is relaunched from the
    step-2 checkpoint (whole AdamW states, every expert, step counts
    included, cut back to the shards and slices) and ends bitwise equal to
    the uninterrupted fit, whose summation order it shares."""
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.parallel.mesh import MeshSpec
    from ray_lightning_tpu_torch.runtime import faults
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    if mesh == "dp":
        cfg, kw = helpers.tiny_config(), {}
    else:
        cfg = dataclasses.replace(LlamaConfig.tiny_moe(), dtype=torch.float32,
                                  max_seq=32)
        kw = {"mesh_spec": MeshSpec(axes={"ep": 2})}

    def fit(sub, max_failures=0):
        module = LlamaModule(cfg, lr=3e-3, warmup_steps=1, total_steps=4)
        strategy = RayShardedStrategy(num_workers=2, zero_stage=3,
                                      max_failures=max_failures,
                                      timeout_s=TIMEOUT, **kw)
        trainer = Trainer(device="cpu", strategy=strategy, max_steps=4,
                          logger=False, seed=0, limit_val_batches=1,
                          callbacks=[ModelCheckpoint(
                              dirpath=str(tmp_path / sub), save_top_k=-1)])
        rows = 2 if mesh == "dp" else 1  # an ep group reads one batch
        try:
            trainer.fit(module, datamodule=SyntheticLMDataModule(
                cfg, batch_size=2, n_train=4 * rows, n_val=4))
        finally:
            rt.shutdown()
        assert trainer.global_step == 4
        return module, strategy.launcher.failures

    want, _ = fit("uninterrupted")
    monkeypatch.setenv(faults.FAULT_ENV, "rank1:crash@step3")
    monkeypatch.setenv(faults.FUSE_ENV, str(tmp_path / "fuses"))
    got, failures = fit("faulted", max_failures=1)
    assert [f["error"] for f in failures] == ["ActorError"]
    assert "step=2" in failures[0]["resume"]
    ckpt = _load(failures[0]["resume"])
    (states,) = ckpt["optimizer_states"]
    leaves = list(tree_leaves(ckpt["state_dict"]))
    assert ckpt["zero_stage"] == 3 and len(states["state"]) == len(leaves)
    for i, leaf in enumerate(leaves):
        assert states["state"][i]["exp_avg"].shape == leaf.shape
        assert float(states["state"][i]["step"]) == 2.0
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert torch.equal(a, b)
