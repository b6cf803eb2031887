"""The port's Ray strategies, launcher and worker runtime
(ray_lightning_tpu_torch/strategies/ray_strategies.py, launchers/, runtime/,
session.py, parallel/data_parallel.py), on the CPU over gloo.

Against the JAX package: the constructors' surface
(tests/test_ray_strategy.py's cases) and the DistributedSampler's indices.
Against the port itself: at world size 2, each strategy's final weights and
per-rank losses equal one process stepping on the global batch (the union
of the ranks' batches), fp32 AdamW with a clip. Each step's mean loss
within 1e-5 relative (the means of two halves against the mean of the
whole). The weights after 4 steps: every element within WEIGHT_TOL = 1e-4
(lr 3e-3 x 4 steps / 120) and all but 1 in 10^4 of a leaf's elements
within 1e-6. AdamW divides each gradient by its own running magnitude, so
an element whose gradient sits at the rounding floor (1-5 of 65536 here)
moves by a sizeable part of lr on a rounding difference; the measured worst
was 4.3e-5. ZeRO stages 1-3 equal stage 0 within the same bound.

Each test that starts processes uses at most 2 workers, bounds start-up,
rendezvous and every collective at 60 s (``timeout_s``), and shuts the
runtime down in a ``finally`` block.
"""
import dataclasses
import socket

import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.data import DistributedSampler as JDistributedSampler
from ray_lightning_tpu.strategies.ray_strategies import (
    HorovodRayStrategy as JHorovodRayStrategy,
    RayShardedStrategy as JRayShardedStrategy,
    RayStrategy as JRayStrategy,
)
from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.core import DataLoader, Trainer
from ray_lightning_tpu_torch.core.data import DistributedSampler
from ray_lightning_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModule,
    SyntheticLMDataModule,
)
from ray_lightning_tpu_torch.parallel.mesh import MeshSpec
from ray_lightning_tpu_torch.parallel.sharding import ShardingPolicy
from ray_lightning_tpu_torch.strategies import (
    HorovodRayStrategy,
    RayShardedStrategy,
    RayStrategy,
    SingleDeviceStrategy,
)
from ray_lightning_tpu_torch.utils.ports import find_free_port
from ray_lightning_tpu_torch.utils.serialization import (
    load_state_stream,
    to_state_stream,
)
from ray_lightning_tpu_torch.utils.tree import tree_leaves

from torch_ray_helpers import (
    RECEIVED,
    BroadcastProbe,
    Echo,
    GlobalBatchSampler,
    RankLosses,
)

TIMEOUT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------------------------------- #
# the constructors, against the JAX strategies
# --------------------------------------------------------------------- #
def test_ctor_parity_kwargs():
    kw = dict(num_workers=4, num_cpus_per_worker=2, use_gpu=False,
              resources_per_worker={"CPU": 2})
    for s in (RayStrategy(**kw), JRayStrategy(**kw)):
        assert s.num_workers == 4
        assert s.world_size == 4
        assert s.global_rank == 0
        assert s.is_global_zero
        assert s.distributed_sampler_kwargs == {"num_replicas": 4, "rank": 0}
        assert s.global_batch_size(8) == 32
    assert SingleDeviceStrategy().distributed_sampler_kwargs is None


def test_sharded_strategy_defaults():
    for cls in (RayShardedStrategy, JRayShardedStrategy):
        s = cls(num_workers=2)
        assert s.zero_stage == 2
        assert s.sharding_policy.zero_stage == 2
        s3 = cls(num_workers=2, zero_stage=3)
        assert s3.sharding_policy.zero_stage == 3 and s3.zero_stage == 3
    assert RayStrategy(num_workers=2).zero_stage == 0
    custom = RayStrategy(num_workers=2,
                         sharding_policy=ShardingPolicy(zero_stage=1))
    assert custom.zero_stage == 1
    with pytest.raises(ValueError):
        ShardingPolicy(zero_stage=4)


def test_horovod_parity_props():
    for cls in (HorovodRayStrategy, JHorovodRayStrategy):
        s = cls(num_workers=3, use_gpu=False)
        assert s.num_slots == 3
        assert s.world_size == 3
    assert HorovodRayStrategy(num_workers=3).zero_stage == 0


@pytest.mark.parametrize("kw", [
    dict(max_failures=1), dict(elastic=True), dict(min_workers=1),
    dict(hang_timeout=5.0), dict(heartbeat_interval=1.0),
    dict(telemetry=True), dict(mesh_spec=MeshSpec(axes={"tp": 2})),
    dict(partition_rules="^w$=dp"), dict(dcn_grad_compression="int8"),
    dict(devices_per_worker=4), dict(xla_cache_dir="/nonexistent"),
    dict(zero_quantized_allgather=True), dict(use_tpu=True),
], ids=lambda kw: next(iter(kw)))
def test_unported_strategy_arguments_are_refused(kw):
    """Each argument that steers what the port does not have refuses with a
    message that names ROADMAP.md; the JAX strategy accepts it. A mesh
    takes 'dp' and 'ep' (tests/test_torch_expert_parallel.py): a 'tp' axis
    refuses."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RayStrategy(num_workers=2, **kw)


def test_trainer_accepts_the_ray_strategies():
    for strategy in (RayStrategy(num_workers=2),
                     RayShardedStrategy(num_workers=2, zero_stage=3),
                     HorovodRayStrategy(num_workers=2)):
        trainer = Trainer(device="cpu", strategy=strategy)
        assert trainer.strategy is strategy
        assert trainer.world_size == 2 and trainer.is_global_zero
        assert trainer.strategy.launcher is not None
    with pytest.raises(NotImplementedError, match="RayStrategy"):
        Trainer(device="cpu", strategy="ddp")
    with pytest.raises(NotImplementedError, match="RayStrategy"):
        Trainer(device="cpu", devices=2)


# --------------------------------------------------------------------- #
# the sampler and the host-side helpers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("n,world", [(16, 2), (17, 2), (10, 3), (5, 4)])
def test_distributed_sampler_matches_jax(shuffle, drop_last, n, world):
    """Every rank's indices over three epochs, bitwise the JAX sampler's."""
    for rank in range(world):
        ours = DistributedSampler(n, world, rank, shuffle=shuffle, seed=7,
                                  drop_last=drop_last)
        theirs = JDistributedSampler(n, world, rank, shuffle=shuffle, seed=7,
                                     drop_last=drop_last)
        assert len(ours) == len(theirs)
        for epoch in range(3):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == list(theirs), (rank, epoch)
    with pytest.raises(ValueError):
        DistributedSampler(4, 2, 2)


def test_loader_with_sampler_shards_the_batches():
    """A DataLoader re-wrapped with each rank's sampler yields the rows of
    that rank's indices, and together the ranks cover the epoch; set_epoch
    reaches the sampler."""
    data = np.arange(24, dtype=np.int32)[:, None] * np.ones((1, 3), np.int32)
    from ray_lightning_tpu_torch.core import DictDataset

    loader = DataLoader(DictDataset(x=data), batch_size=4, shuffle=True,
                        drop_last=True)
    seen = []
    for rank in range(2):
        sharded = loader.with_sampler(DistributedSampler(24, 2, rank, seed=3,
                                                         drop_last=True))
        sharded.set_epoch(1)
        assert len(sharded) == 3 and sharded.sampler.epoch == 1
        rows = np.concatenate([b["x"][:, 0] for b in sharded])
        sampler = DistributedSampler(24, 2, rank, seed=3, drop_last=True)
        sampler.set_epoch(1)
        assert rows.tolist() == list(sampler)
        seen.extend(rows.tolist())
    assert sorted(seen) == list(range(24))


def test_state_stream_round_trip_is_bitwise():
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 4, generator=gen),
            "b": [torch.randn(5, generator=gen).bfloat16(),
                  torch.arange(6, dtype=torch.int32)],
            "c": {"d": torch.nn.Parameter(torch.ones(2))}}
    back = load_state_stream(to_state_stream(tree))
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b)
        assert not isinstance(b, torch.nn.Parameter)


def test_find_free_port_is_bindable():
    port = find_free_port()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


# --------------------------------------------------------------------- #
# the runtime: actors, the object store, the queue and the session
# --------------------------------------------------------------------- #
def test_actor_calls_errors_store_and_session_queue():
    """One actor process: calls return in order, a remote exception comes
    back as ActorError with its traceback, an object put in the store is
    read by the actor's process, a local function is refused before
    anything is sent, and a callable the actor puts into the session queue
    runs in the main process. Everything is stopped in ``finally``."""
    RECEIVED.clear()
    queue = None
    try:
        rt.init(num_cpus=4)
        actor = rt.create_actor(Echo, args=("t",), timeout=TIMEOUT)
        futs = [actor.echo.remote(i) for i in range(5)]
        assert rt.get(futs, timeout=TIMEOUT) == [("t", i) for i in range(5)]
        with pytest.raises(rt.ActorError, match="planted failure") as err:
            actor.fail.remote().result(timeout=TIMEOUT)
        assert not err.value.is_process_failure
        ref = rt.put({"w": np.arange(4)})
        got = actor.call("echo", ref).result(timeout=TIMEOUT)
        assert got[1] == ref
        assert rt.get(ref)["w"].tolist() == [0, 1, 2, 3]
        rt.delete(ref)

        def local():  # pragma: no cover - never sent
            return 1

        with pytest.raises(TypeError, match="module level"):
            actor.echo.remote(local)
        queue = rt.Queue(timeout=TIMEOUT)
        assert actor.put_through_session.remote(
            queue.handle(), 42).result(timeout=TIMEOUT) == 3
        for item in queue.get_all():
            item()
        assert RECEIVED == [(3, 42)]
        assert queue.empty()
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            rt.ShmQueue()
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            rt.create_actors([(Echo, ("x",), {})], zygote=True)
    finally:
        if queue is not None:
            queue.shutdown()
        rt.shutdown()
    assert not rt.is_initialized()


def test_node_agent_spawns_actors_for_a_client_main_process():
    """A node agent process (``python -m ray_lightning_tpu_torch.runtime.
    node``, the 'ray start' role) on this host; a main process in client mode
    (``init(address=..., authkey=...)``: its own node offers nothing)
    places an actor on the agent's node, calls it and kills it. The agent
    is stopped in ``finally``."""
    import subprocess
    import sys

    from ray_lightning_tpu_torch.runtime.actor import ActorHandle, make_authkey

    key = make_authkey()
    agent = subprocess.Popen(
        [sys.executable, "-m", "ray_lightning_tpu_torch.runtime.node",
         "--host", "127.0.0.1", "--advertise-ip", "127.0.0.1",
         "--authkey-hex", key.hex(), "--num-cpus", "2"],
        stdout=subprocess.PIPE, env=rt.api._child_env(None))
    handle = None
    try:
        line = agent.stdout.readline().decode()
        assert line.startswith("TORCHRT_ACTOR_READY"), line
        port = int(line.split()[1])
        rt.init(address=f"127.0.0.1:{port}", authkey=key)
        assert [n["remote"] for n in rt.nodes()] == [False, True]
        assert rt.cluster_resources()["CPU"] == 2.0
        actor = rt.create_actor(Echo, args=("remote",), timeout=TIMEOUT)
        assert rt.actor_node_id(actor) == 1
        assert actor.echo.remote(7).result(timeout=TIMEOUT) == ("remote", 7)
        rt.kill(actor)
        handle = ActorHandle("agent", ("127.0.0.1", port), key)
        assert handle.live_actors.remote().result(timeout=TIMEOUT) == []
    finally:
        rt.shutdown()
        if handle is not None:
            handle.shutdown(timeout=5)
        try:
            agent.wait(timeout=10)
        except subprocess.TimeoutExpired:
            agent.kill()
            agent.wait(timeout=TIMEOUT)


# --------------------------------------------------------------------- #
# the strategies at world size 2 against one process on the global batch
# --------------------------------------------------------------------- #
STEPS, BATCH, WORLD = 4, 4, 2
N_TRAIN, N_VAL = 16, 8
TOL = 1e-5
WEIGHT_TOL = 1e-4


def _assert_weights_close(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        d = (a.detach() - b.detach()).abs()
        assert float(d.max()) <= WEIGHT_TOL
        assert float((d > 1e-6).float().mean()) <= 1e-4


def _cfg():
    return dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                               max_seq=32)


def _fit(strategy, module=None, **trainer_kw):
    cfg = _cfg()
    module = module or LlamaModule(cfg, lr=3e-3, warmup_steps=0,
                                   total_steps=STEPS)
    losses, probe = RankLosses(), BroadcastProbe()
    trainer = Trainer(device="cpu", strategy=strategy, max_steps=STEPS,
                      seed=0, logger=False, enable_checkpointing=False,
                      gradient_clip_val=1.0, callbacks=[losses, probe],
                      **trainer_kw)
    dm = SyntheticLMDataModule(cfg, batch_size=BATCH, n_train=N_TRAIN,
                               n_val=N_VAL)
    trainer.fit(module, datamodule=dm)
    assert probe.received == [{"from": 0}] * WORLD
    return trainer, module, losses.losses


@pytest.fixture(scope="module")
def reference():
    return _reference()


def _reference():
    """One process on the global batch: at each step the union of the two
    ranks' batches (their DistributedSampler shards of the run's seeded
    permutation)."""
    cfg = _cfg()
    dm = SyntheticLMDataModule(cfg, batch_size=BATCH, n_train=N_TRAIN,
                               n_val=N_VAL)
    dm.setup("fit")
    loader = DataLoader(dm.train_data, batch_size=BATCH * WORLD,
                        drop_last=True,
                        sampler=GlobalBatchSampler(N_TRAIN, WORLD, BATCH, 0))
    module = LlamaModule(cfg, lr=3e-3, warmup_steps=0, total_steps=STEPS)
    losses = RankLosses()
    trainer = Trainer(device="cpu", max_steps=STEPS, seed=0, logger=False,
                      enable_checkpointing=False, gradient_clip_val=1.0,
                      callbacks=[losses])
    trainer.fit(module, train_dataloaders=loader,
                val_dataloaders=dm.val_dataloader())
    return {"params": module.params, "losses": [l[0] for l in losses.losses],
            "val_loss": float(trainer.callback_metrics["val_loss"])}


_STAGE0 = {}

CASES = {
    "ddp": lambda: RayStrategy(num_workers=2, timeout_s=TIMEOUT,
                               debug_collectives=True),
    "horovod": lambda: HorovodRayStrategy(num_workers=2, timeout_s=TIMEOUT),
    "zero1": lambda: RayShardedStrategy(num_workers=2, zero_stage=1,
                                        timeout_s=TIMEOUT),
    "zero2": lambda: RayShardedStrategy(num_workers=2, zero_stage=2,
                                        timeout_s=TIMEOUT),
    "zero3": lambda: RayShardedStrategy(num_workers=2, zero_stage=3,
                                        timeout_s=TIMEOUT),
}


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_one_process_on_the_global_batch(case, reference):
    """Two CPU workers over gloo: every step's mean of the two ranks' losses
    equals the reference's loss on the union of their batches, the ranks'
    losses differ (they saw different rows), and the weights, val_loss and
    progress that rank 0 sends back equal the reference's. ZeRO stages
    equal stage 0. No kernel launches on the CPU."""
    try:
        trainer, module, losses = _fit(CASES[case]())
    finally:
        rt.shutdown()
    assert not rt.api._state.actors
    assert trainer.global_step == STEPS and trainer.state.status == "finished"
    assert trainer.strategy.launcher.backend == "gloo"
    assert len(losses) == STEPS and all(len(l) == WORLD for l in losses)
    assert any(abs(a - b) > 1e-3 for a, b in losses)
    means = [float(np.mean(l)) for l in losses]
    np.testing.assert_allclose(means, reference["losses"], rtol=TOL, atol=0)
    assert float(trainer.callback_metrics["val_loss"]) == pytest.approx(
        reference["val_loss"], rel=TOL)
    assert "train_loss_epoch" in trainer.callback_metrics
    assert set(trainer.worker_launch_counts.values()) == {0}
    got = list(tree_leaves(module.params))
    want = list(tree_leaves(reference["params"]))
    assert len(got) == len(want)
    _assert_weights_close(got, want)
    if case == "ddp":
        _STAGE0["params"] = got
    elif case.startswith("zero") and "params" in _STAGE0:
        _assert_weights_close(got, _STAGE0["params"])


def test_zero3_accumulation_keeps_parameters_sharded_between_steps(reference):
    """ZeRO stage 3 with two micro-batches an update and validation at each
    epoch's end: the trained weights are whole in the main process, finite, and
    the loss of the first micro-batch equals the reference's first step
    (both start from the same weights). A module class defined inside a
    function is refused before any worker starts."""

    class Local(LlamaModule):
        pass

    with pytest.raises(TypeError, match="module level"):
        Trainer(device="cpu", strategy=RayStrategy(num_workers=2),
                max_steps=1, logger=False, enable_checkpointing=False).fit(
            Local(_cfg()), datamodule=SyntheticLMDataModule(_cfg()))
    assert not rt.api._state.actors
    try:
        trainer, module, losses = _fit(
            RayShardedStrategy(num_workers=2, zero_stage=3, timeout_s=TIMEOUT),
            accumulate_grad_batches=2)
    finally:
        rt.shutdown()
    assert trainer.global_step == STEPS
    assert float(np.mean(losses[0])) == pytest.approx(reference["losses"][0],
                                                      rel=TOL)
    for leaf in tree_leaves(module.params):
        assert leaf.numel() > 0 and torch.isfinite(leaf).all()
    assert np.isfinite(float(trainer.callback_metrics["val_loss"]))


def test_use_gpu_with_a_cpu_trainer_is_refused():
    trainer = Trainer(device="cpu", strategy=RayStrategy(num_workers=1,
                                                         use_gpu=True),
                      max_steps=1, logger=False, enable_checkpointing=False)
    with pytest.raises(ValueError, match="use_gpu"):
        trainer.fit(LlamaModule(_cfg()),
                    datamodule=SyntheticLMDataModule(_cfg()))
    assert not rt.api._state.actors
