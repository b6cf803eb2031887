"""Expert parallelism in the port (ray_lightning_tpu_torch/parallel/mesh.py,
parallel/moe.py::moe_ffn_local_experts, models/llama.py's param_specs /
param_shardings / the mesh keyword, the Ray strategies' mesh_spec), on the
CPU over gloo, fp32, at small widths (LlamaConfig.tiny_moe).

Against the JAX package: MeshSpec.resolved, moe_param_specs, the
param_shardings layout on a {"dp": 2, "ep": 4} mesh of host CPU devices,
and moe_ffn_local_experts at ep 2 (two processes) against JAX's under
shard_map and against JAX's moe_ffn: output, aux and the gradients of the
router, x and each member's experts within 1e-5 of each leaf's max (fp32
sums in other orders).

Against one process: the strategies at world 2 ({"ep": 2}) and world 4
({"dp": 2, "ep": 2}), stage 0 and ZeRO 3, after 4 AdamW steps with a clip,
within tests/test_torch_ray_strategy.py's bound (each step's loss within
1e-5 relative, every weight within 1e-4). Each dp rank routes its own
batch, as JAX's moe_ffn_local_experts routes the member's own x, so the
one-process reference of a dp 2 mesh takes the mean of the loss over the
two dp shards
of its global batch (ShardedBatchLlama); a global routing differs once a
token overflows its expert's capacity, and the aux loss is a per-shard
mean (test_dp_ranks_route_their_own_batch).

Each test that starts processes bounds start-up, rendezvous and every
collective at 60 s and stops every process in a ``finally`` block.
"""
import dataclasses
import importlib
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.callbacks import ModelCheckpoint
from ray_lightning_tpu_torch.core import DataLoader, Trainer
from ray_lightning_tpu_torch.models import llama as tllama
from ray_lightning_tpu_torch.ops import paged_attention as tpa
from ray_lightning_tpu_torch.parallel import moe as tmoe
from ray_lightning_tpu_torch.parallel.mesh import MeshSpec, ProcessMesh
from ray_lightning_tpu_torch.strategies import (
    HorovodRayStrategy,
    RayShardedStrategy,
    RayStrategy,
)
from ray_lightning_tpu_torch.utils.ports import find_free_port
from ray_lightning_tpu_torch.utils.tree import tree_leaves

from torch_ray_helpers import GlobalBatchSampler, RankLosses, ep_moe_worker

jmesh = importlib.import_module("ray_lightning_tpu.parallel.mesh")
jmoe = importlib.import_module("ray_lightning_tpu.parallel.moe")
jllama = importlib.import_module("ray_lightning_tpu.models.llama")
jpa = importlib.import_module("ray_lightning_tpu.ops.paged_attention")

TIMEOUT = 60.0
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close_to_max(got, want, tol=TOL):
    """Every element within ``tol`` of the reference leaf's max."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    peak = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * peak


# --------------------------------------------------------------------- #
# the mesh, against the JAX MeshSpec
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("axes,n", [
    ({"dp": -1}, 8), ({"dp": 2, "ep": 4}, 8), ({"dp": -1, "ep": 2}, 8),
    ({"ep": 2, "tp": 1}, 2), ({}, 4), ({"dp": 1, "ep": 2}, 2),
    ({"ep": -1}, 4),
    # errors: two fills, a fill that does not divide, a wrong product
    ({"dp": -1, "ep": -1}, 4), ({"dp": 3, "ep": -1}, 8), ({"dp": 2, "ep": 2}, 8),
])
def test_mesh_spec_resolved_matches_jax(axes, n):
    """The resolved sizes, or the ValueError and its message, as JAX's."""
    try:
        want = jmesh.MeshSpec(axes=dict(axes)).resolved(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("{", ".").replace(
                "}", ".")):
            MeshSpec(axes=dict(axes)).resolved(n)
        return
    assert MeshSpec(axes=dict(axes)).resolved(n) == want


def test_mesh_spec_constructors_match_jax():
    for name, args in (("data_parallel", ()), ("fsdp", ()), ("pipeline", (2,)),
                       ("composed", (2, 2, 2)), ("composed", (-1, 1, 1))):
        assert getattr(MeshSpec, name)(*args).axes == \
            getattr(jmesh.MeshSpec, name)(*args).axes


def test_process_mesh_lays_ranks_row_major():
    """{"dp": 2, "ep": 4}: ranks 0-3 form dp-row 0's ep group; every rank's
    coordinates, its groups' members, and the refusals of what the port does
    not lay over ranks."""
    spec = MeshSpec(axes={"dp": 2, "ep": 4})
    for r in range(8):
        m = ProcessMesh(spec, 8, r)
        assert m.axes == {"dp": 2, "ep": 4}
        assert m.coords == {"dp": r // 4, "ep": r % 4}
        assert m.ranks_of("ep") == [r // 4 * 4 + i for i in range(4)]
        assert m.ranks_of("dp") == [r % 4, r % 4 + 4]
    ep_only = ProcessMesh(MeshSpec(axes={"ep": 2}), 2, 1)
    assert ep_only.axes == {"dp": 1, "ep": 2}
    assert ep_only.coords == {"dp": 0, "ep": 1}
    assert ep_only.ranks_of("dp") == [1]
    for axis in ("tp", "fsdp", "pp", "sp"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ProcessMesh(MeshSpec(axes={"dp": 1, axis: 2}), 2, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ProcessMesh(MeshSpec(axes={"ep": 2}, dcn_axes=("ep",)), 2, 0)
    with pytest.raises(ValueError, match="use 4 devices, have 2"):
        ProcessMesh(MeshSpec(axes={"dp": 2, "ep": 2}), 2, 0)
    with pytest.raises(RuntimeError, match="before join"):
        ep_only.group("ep")


@pytest.mark.parametrize("n_layers", [None, 4])
def test_moe_param_specs_match_jax(n_layers):
    want = {k: tuple(v) for k, v in jmoe.moe_param_specs(n_layers).items()}
    assert tmoe.moe_param_specs(n_layers) == want


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree.spec)


@pytest.mark.parametrize("variant", ["tiny_moe", "tiny_bias"])
def test_param_shardings_match_jax_on_a_dp_ep_mesh(variant):
    """LlamaModule.param_shardings of a {"dp": 2, "ep": 4} ProcessMesh equals
    the JAX module's on a {"dp": 2, "ep": 4} mesh of host CPU devices
    (param_specs filtered to the mesh), and sets module.mesh; ep must divide
    the experts, with JAX's message."""
    if variant == "tiny_moe":
        jcfg = jllama.LlamaConfig.tiny_moe()
    else:
        jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), attn_bias=True)
    devices = np.asarray(jax.devices()[:8]).reshape(2, 4)
    want = _as_tuples(jllama.LlamaModule(jcfg).param_shardings(
        Mesh(devices, ("dp", "ep"))))
    cfg = tllama.LlamaConfig.from_dict(jcfg.to_dict())
    module = tllama.LlamaModule(cfg)
    mesh = ProcessMesh(MeshSpec(axes={"dp": 2, "ep": 4}), 8, 5)
    assert module.param_shardings(mesh) == want
    assert module.mesh is mesh
    assert module.param_shardings(None) is None
    if cfg.n_experts:
        with pytest.raises(ValueError, match="ep=3 must divide n_experts=4"):
            tllama.LlamaModule(cfg).param_shardings(
                ProcessMesh(MeshSpec(axes={"ep": 3}), 3, 0))


# --------------------------------------------------------------------- #
# moe_ffn_local_experts at ep 2, against JAX
# --------------------------------------------------------------------- #
E, TOP_K, D, FF = 8, 2, 16, 32
B, S = 2, 12
CASES = {"cf_1.5": 1.5, "cf_E_over_k": E / TOP_K}


def _moe_inputs(seed=0):
    """Whole fp32 MoE params (a router skewed towards expert 0, so that
    capacity 1.5 drops tokens), x and the cotangents, from numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    router = rng.standard_normal((D, E)) / np.sqrt(D)
    router[:, 0] += 1.0  # x has a positive mean: expert 0 is the favourite
    params = {
        "router": router.astype(f32),
        "w_gate": (rng.standard_normal((E, D, FF)) / np.sqrt(D)).astype(f32),
        "w_up": (rng.standard_normal((E, D, FF)) / np.sqrt(D)).astype(f32),
        "w_down": (rng.standard_normal((E, FF, D)) / np.sqrt(FF)).astype(f32),
    }
    x = (rng.standard_normal((B, S, D)) + 0.5).astype(f32)
    out_ct = rng.standard_normal((B, S, D)).astype(f32)
    return params, x, out_ct, f32(0.7)


@pytest.fixture(scope="module")
def two_rank_moe(tmp_path_factory):
    """moe_ffn_local_experts in two processes of one gloo ep group, on the
    inputs of every case; each rank's results."""
    params, x, out_ct, aux_ct = _moe_inputs()
    cases = [{"params": {k: torch.from_numpy(v) for k, v in params.items()},
              "x": torch.from_numpy(x), "out_ct": torch.from_numpy(out_ct),
              "aux_ct": float(aux_ct), "top_k": TOP_K, "capacity_factor": cf}
             for cf in CASES.values()]
    d = tmp_path_factory.mktemp("ep_moe")
    inputs = str(d / "inputs.pt")
    torch.save(cases, inputs)
    out_path = str(d / "rank{}.pt")
    ctx = multiprocessing.get_context("spawn")
    init = f"tcp://127.0.0.1:{find_free_port()}"
    procs = [ctx.Process(target=ep_moe_worker,
                         args=(r, 2, init, inputs, out_path)) for r in range(2)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(TIMEOUT)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [torch.load(out_path.format(r), weights_only=True) for r in range(2)]
    return {name: [ranks[0][i], ranks[1][i]] for i, name in enumerate(CASES)}


def _jax_grads(fn, params, x, out_ct, aux_ct):
    def loss(p, xx):
        out, aux = fn(p, xx)
        return jnp.sum(out * out_ct) + aux_ct * aux

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    out, aux = jax.jit(fn)(jp, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    return np.asarray(out), float(aux), {k: np.asarray(v) for k, v in gp.items()}, \
        np.asarray(gx)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("reference", ["local_experts_shard_map", "moe_ffn"])
def test_local_experts_at_ep_2_match_jax(two_rank_moe, case, reference):
    """Both members return the same output and aux (the g sum), and the same
    x and router gradients (the f sum); together their expert slices'
    gradients are the whole experts' gradients. Against JAX's
    moe_ffn_local_experts under shard_map at ep 2, and JAX's moe_ffn, at
    capacity factor 1.5 (tokens dropped) and at E / top_k (none)."""
    cf = CASES[case]
    params, x, out_ct, aux_ct = _moe_inputs()
    if reference == "moe_ffn":
        def fn(p, xx):
            return jmoe.moe_ffn(p, xx, top_k=TOP_K, capacity_factor=cf)
    else:
        mesh = Mesh(np.asarray(jax.devices()[:2]), ("ep",))
        specs = {"router": P(), "w_gate": P("ep"), "w_up": P("ep"),
                 "w_down": P("ep")}

        def local(p, xx):
            return jmoe.moe_ffn_local_experts(p, xx, "ep", top_k=TOP_K,
                                              capacity_factor=cf)

        fn = jax.shard_map(local, mesh=mesh, in_specs=(specs, P()),
                           out_specs=(P(), P()), check_vma=False)
    out, aux, gp, gx = _jax_grads(fn, params, x, out_ct, aux_ct)
    r0, r1 = two_rank_moe[case]
    for key in ("out", "aux", "x", "router"):
        assert torch.equal(r0[key], r1[key]), key
    _close_to_max(r0["out"].numpy(), out)
    assert float(r0["aux"]) == pytest.approx(aux, rel=1e-6)
    _close_to_max(r0["x"].numpy(), gx)
    _close_to_max(r0["router"].numpy(), gp["router"])
    half = E // 2
    for name in ("w_gate", "w_up", "w_down"):
        for r, res in enumerate((r0, r1)):
            _close_to_max(res[name].numpy(), gp[name][r * half:(r + 1) * half])
    # the 1.5 case does drop tokens: it tests the capacity bound
    disp, _, _ = tmoe._route(torch.from_numpy(x).reshape(-1, D),
                             torch.from_numpy(params["router"]), TOP_K,
                             max(1, int(cf * TOP_K * B * S / E)))
    dropped = B * S * TOP_K - int(disp.sum())
    assert (dropped > 0) == (case == "cf_1.5")


def test_local_experts_without_an_axis_equal_moe_ffn():
    """axis=None: every expert is local, no collective; the output, aux and
    gradients are moe_ffn's, bitwise."""
    params, x, out_ct, _ = _moe_inputs(1)
    outs = []
    for fn in (lambda p, xx: tmoe.moe_ffn_local_experts(p, xx, None),
               lambda p, xx: tmoe.moe_ffn(p, xx)):
        p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
        xx = torch.from_numpy(x).requires_grad_(True)
        out, aux = fn(p, xx)
        ((out * torch.from_numpy(out_ct)).sum() + aux).backward()
        outs.append([out, aux, xx.grad] + [p[k].grad for k in sorted(p)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_unported_expert_parallel_arguments_are_refused():
    """tp_axis (tensor parallelism inside the experts) refuses naming
    ROADMAP.md, as does a mesh with a 'tp' axis given to param_shardings."""
    params, x, _, _ = _moe_inputs()
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(NotImplementedError, match="tensor parallelism.*ROADMAP"):
        tmoe.moe_ffn_local_experts(p, torch.from_numpy(x), None, tp_axis="tp")
    module = tllama.LlamaModule(tllama.LlamaConfig.tiny_moe())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        module.param_shardings(MeshSpec(axes={"dp": 2, "tp": 2}))


def test_generation_refuses_an_expert_slice():
    """Generation runs every expert on one device (moe_ffn_lossless), so
    params holding one ep member's experts refuse in generate and in the
    engine; the whole tree serves."""
    from ray_lightning_tpu_torch.models.generation import generate
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = _cfg()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    sliced = dict(params, layers=dict(params["layers"], moe={
        k: v if k == "router" else v[:, :2]
        for k, v in params["layers"]["moe"].items()}))
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="2 of the config's 4 experts"):
        generate(sliced, prompt, cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="2 of the config's 4 experts"):
        InferenceEngine(sliced, cfg, EngineConfig(num_slots=1, max_prompt_len=4,
                                                  max_len=8), device="cpu")
    assert generate(params, prompt, cfg, 2, device="cpu").shape == (1, 6)


@pytest.mark.parametrize("cf", [1.5, E / TOP_K])
def test_dp_ranks_route_their_own_batch(cf):
    """Each dp rank routes its own batch: the port's layer on each of two
    shards equals JAX's moe_ffn on that shard. JAX's GSPMD moe_ffn routes
    the global batch: at E / top_k (no token dropped) it equals the shards'
    outputs too; at 1.5 the capacities and queue positions differ and the
    outputs part (ROADMAP.md, reference behaviours)."""
    params, x, _, _ = _moe_inputs(2)
    x = np.concatenate([x, _moe_inputs(3)[1]])  # a global batch of 2 shards
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    shards = np.split(x, 2)
    ours = np.concatenate([
        tmoe.moe_ffn_local_experts(p, torch.from_numpy(xs), None,
                                   capacity_factor=cf)[0].numpy()
        for xs in shards])
    per_shard = np.concatenate([
        np.asarray(jmoe.moe_ffn(jp, jnp.asarray(xs), capacity_factor=cf)[0])
        for xs in shards])
    global_ = np.asarray(jmoe.moe_ffn(jp, jnp.asarray(x), capacity_factor=cf)[0])
    _close_to_max(ours, per_shard)
    if cf == E / TOP_K:
        _close_to_max(ours, global_)
    else:
        assert float(np.abs(ours - global_).max()) > 1e-3


# --------------------------------------------------------------------- #
# paged decode: a group above 8 through the same split as on the card
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("group", [12, 16])
def test_paged_decode_splits_groups_above_8(group):
    """The wrapper serves G 12 and 16 as launches of at most 8 query heads
    over the same caches (paged_group_chunks): through that split, the
    plain version equals itself on the whole group and the JAX kernel in
    interpret mode; each launch's group pads as before."""
    rng = np.random.default_rng(group)
    Bq, hkv, hd, bs, maxb = 3, 2, 64, 16, 4
    n = Bq * maxb + 1
    q = rng.standard_normal((Bq, hkv, group, hd)).astype(np.float32)
    kc = rng.standard_normal((n, hkv, bs, hd)).astype(np.float32)
    vc = rng.standard_normal((n, hkv, bs, hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n)).reshape(Bq, maxb).astype(np.int32)
    pos = np.asarray([0, 33, 63], np.int32)
    t = [torch.from_numpy(a) for a in (q, kc, vc, tables, pos)]
    chunks = tpa.paged_group_chunks(group)
    assert chunks == [(0, 8), (8, group)]
    assert [tpa.paged_group(hi - lo) for lo, hi in chunks] == [
        8, 4 if group == 12 else 8]
    split = tpa.over_group_chunks(
        t[0], lambda qc: tpa.paged_decode_attention_plain(qc, *t[1:]))
    whole = tpa.paged_decode_attention(*t)
    assert torch.equal(split, whole)
    want = jpa.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, tables, pos)), interpret=True)
    np.testing.assert_allclose(split.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_paged_head_dims_between_the_instantiated_ones():
    """Phi-2's 80 and Phi-3's 96 run on the 128-wide instantiation, 40 on the
    64-wide; a width that is no multiple of 8, or above 256, refuses naming
    it; the scratch counts the padded width."""
    assert [tpa.paged_head_dim(h) for h in (8, 32, 40, 64, 80, 96, 128, 200, 256)] \
        == [32, 32, 64, 64, 128, 128, 128, 256, 256]
    for bad in (36, 17, 264, 0):
        with pytest.raises(ValueError, match=f"hd={bad}"):
            tpa.paged_head_dim(bad)
    assert tpa.paged_decode_plan(8, 8, 4, 80, 16, 64)["scratch"] == \
        8 * 8 * 16 * 4 * 130


# --------------------------------------------------------------------- #
# the strategies under a mesh, against one process
# --------------------------------------------------------------------- #
STEPS, BATCH, N_TRAIN, N_VAL = 4, 4, 16, 8
WEIGHT_TOL = 1e-4


def _cfg():
    return dataclasses.replace(tllama.LlamaConfig.tiny_moe(), dtype=torch.float32,
                               max_seq=32)


class ShardedBatchLlama(tllama.LlamaModule):
    """One process on the global batch of ``dp`` ranks, routed as the ranks
    route it: each step's loss (and validation's) is the mean over the dp
    shards, in the order GlobalBatchSampler concatenates them, of
    ``lm_loss`` on each shard."""

    dp = 1

    def _mean_over_shards(self, params, batch):
        parts = [tllama.lm_loss(params, t, self.config)
                 for t in self._tokens_of(batch).chunk(self.dp)]
        loss = torch.stack([p[0] for p in parts]).mean()
        aux = torch.stack([p[1]["moe_aux"] for p in parts]).mean()
        return loss, aux

    def training_step(self, params, batch, batch_idx):
        loss, aux = self._mean_over_shards(params, batch)
        self.log("train_loss", loss, on_step=True, on_epoch=True)
        self.log("train_moe_aux", aux, on_step=False, on_epoch=True)
        return loss

    def validation_step(self, params, batch, batch_idx):
        loss, aux = self._mean_over_shards(params, batch)
        self.log("val_loss", loss)
        self.log("val_moe_aux", aux)


def _reference(dp, n_train=N_TRAIN, steps=STEPS):
    """One process, the global batch of ``dp`` ranks' batches."""
    cfg = _cfg()
    dm = tllama.SyntheticLMDataModule(cfg, batch_size=BATCH, n_train=n_train,
                                      n_val=N_VAL)
    dm.setup("fit")
    train = DataLoader(dm.train_data, batch_size=BATCH * dp, drop_last=True,
                       sampler=GlobalBatchSampler(n_train, dp, BATCH, 0))
    val = DataLoader(dm.val_data, batch_size=BATCH * dp, drop_last=True,
                     sampler=GlobalBatchSampler(N_VAL, dp, BATCH, 0,
                                                shuffle=False))
    module = ShardedBatchLlama(cfg, lr=3e-3, warmup_steps=0, total_steps=steps)
    module.dp = dp
    losses = RankLosses()
    trainer = Trainer(device="cpu", max_steps=steps, seed=0, logger=False,
                      enable_checkpointing=False, gradient_clip_val=1.0,
                      callbacks=[losses])
    trainer.fit(module, train_dataloaders=train, val_dataloaders=val)
    return {"params": module.params, "losses": [l[0] for l in losses.losses],
            "val_loss": float(trainer.callback_metrics["val_loss"]),
            "val_moe_aux": float(trainer.callback_metrics["val_moe_aux"])}


@pytest.fixture(scope="module")
def references():
    return {dp: _reference(dp) for dp in (1, 2)}


def _fit(strategy, n_train=N_TRAIN, callbacks=(), ckpt_path=None, **kw):
    cfg = _cfg()
    module = tllama.LlamaModule(cfg, lr=3e-3, warmup_steps=0, total_steps=STEPS)
    losses = RankLosses()
    kw.setdefault("max_steps", STEPS)
    trainer = Trainer(device="cpu", strategy=strategy, seed=0, logger=False,
                      gradient_clip_val=1.0, callbacks=[losses, *callbacks],
                      enable_checkpointing=bool(callbacks), **kw)
    dm = tllama.SyntheticLMDataModule(cfg, batch_size=BATCH, n_train=n_train,
                                      n_val=N_VAL)
    try:
        trainer.fit(module, datamodule=dm, ckpt_path=ckpt_path)
    finally:
        rt.shutdown()
    assert not rt.api._state.actors
    return trainer, module, losses.losses


def _assert_whole_and_close(got, want):
    """Every expert of every layer came back ([L, E, ...] leaves), and every
    weight is within WEIGHT_TOL of the reference (AdamW moves an element
    whose gradient sits at the rounding floor by a part of lr)."""
    got_l, want_l = list(tree_leaves(got)), list(tree_leaves(want))
    assert len(got_l) == len(want_l)
    assert got["layers"]["moe"]["w_gate"].shape[1] == _cfg().n_experts
    for a, b in zip(got_l, want_l):
        assert a.shape == b.shape and a.dtype == b.dtype
        d = (a.detach() - b.detach()).abs()
        assert float(d.max()) <= WEIGHT_TOL
        assert float((d > 1e-6).float().mean()) <= 1e-3


MESH_CASES = {
    "ep2": (lambda: RayStrategy(num_workers=2, timeout_s=TIMEOUT,
                                mesh_spec=MeshSpec(axes={"ep": 2})), 1, 2),
    "dp2_ep2": (lambda: RayStrategy(num_workers=4, timeout_s=TIMEOUT,
                                    mesh_spec=MeshSpec(axes={"dp": 2, "ep": 2})),
                2, 4),
    "dp2_ep2_zero3": (lambda: RayShardedStrategy(
        num_workers=4, zero_stage=3, timeout_s=TIMEOUT,
        mesh_spec=MeshSpec(axes={"dp": 2, "ep": 2})), 2, 4),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_expert_parallel_fit_equals_one_process(case, references):
    """Workers over gloo under an ep mesh: the members of an ep group share
    each step's loss (the g sum), the mean over the ranks equals the
    reference's loss, val_loss and val_moe_aux equal the reference's, and
    rank 0 returns every expert, equal to the reference's weights."""
    make, dp, world = MESH_CASES[case]
    trainer, module, losses = _fit(make())
    ref = references[dp]
    assert trainer.global_step == STEPS
    assert trainer.strategy.launcher.backend == "gloo"
    assert len(losses) == STEPS and all(len(l) == world for l in losses)
    for step in losses:  # rank r is (dp r // 2, ep r % 2)
        assert step[0] == step[1] and step[-2] == step[-1]
    means = [float(np.mean(l)) for l in losses]
    np.testing.assert_allclose(means, ref["losses"], rtol=TOL, atol=0)
    assert float(trainer.callback_metrics["val_loss"]) == pytest.approx(
        ref["val_loss"], rel=TOL)
    assert float(trainer.callback_metrics["val_moe_aux"]) == pytest.approx(
        ref["val_moe_aux"], rel=TOL)
    assert trainer.strategy.launcher.timings["gather_s"] > 0
    _assert_whole_and_close(module.params, ref["params"])


def test_mesh_spec_on_every_ray_strategy():
    """Every Ray strategy takes a dp x ep mesh: the sampler shards over dp,
    the global batch scales by dp; a spec whose sizes do not multiply to the
    workers raises as resolved() does."""
    spec = MeshSpec(axes={"dp": 2, "ep": 4})
    for s in (RayStrategy(num_workers=8, mesh_spec=spec),
              RayShardedStrategy(num_workers=8, zero_stage=1, mesh_spec=spec),
              HorovodRayStrategy(num_workers=8, mesh_spec=spec)):
        assert s.mesh_spec is spec
        assert s.distributed_sampler_kwargs == {"num_replicas": 2, "rank": 0}
        assert s.global_batch_size(4) == 8
        s._set_worker_context(6, 8)
        assert s.process_mesh.coords == {"dp": 1, "ep": 2}
        assert s.distributed_sampler_kwargs == {"num_replicas": 2, "rank": 1}
    with pytest.raises(ValueError, match="use 8 devices, have 4"):
        RayStrategy(num_workers=4, mesh_spec=spec)


def test_checkpoint_holds_every_expert_and_resumes_at_stage_0(tmp_path):
    """Under {"ep": 2} a ModelCheckpoint file holds the whole tree (every
    expert, its optimizer moments too); a stage-0 fit resumed from it under
    the same mesh slices it again and ends bitwise where the uninterrupted
    fit ends, its losses those of one process."""
    n_train = 2 * BATCH  # two steps an epoch: a checkpoint at epoch 1's end
    ref = _reference(1, n_train=n_train)
    ckpt = ModelCheckpoint(dirpath=str(tmp_path), save_last=True)

    def strategy():
        return RayStrategy(num_workers=2, timeout_s=TIMEOUT,
                           mesh_spec=MeshSpec(axes={"ep": 2}))

    _, straight, straight_losses = _fit(strategy(), n_train=n_train)
    _, first_module, _ = _fit(strategy(), n_train=n_train, callbacks=[ckpt],
                              max_steps=-1, max_epochs=1)
    saved = torch.load(str(tmp_path / "last.ckpt"), weights_only=True)
    assert saved["global_step"] == 2 and saved["epoch_complete"]
    w = saved["state_dict"]["layers"]["moe"]["w_gate"]
    assert w.shape[1] == _cfg().n_experts
    assert torch.equal(w, first_module.params["layers"]["moe"]["w_gate"].cpu())
    moments = [v for s in saved["optimizer_states"][0]["state"].values()
               for v in s.values() if torch.is_tensor(v) and v.shape == w.shape]
    assert len(moments) == 4  # AdamW's two moments of w_gate and w_up, whole
    _, resumed, losses = _fit(strategy(), n_train=n_train,
                              ckpt_path=str(tmp_path / "last.ckpt"))
    # the first two losses come back with the callback's checkpointed state;
    # the resumed fit is the uninterrupted one, bitwise
    assert losses == straight_losses
    np.testing.assert_allclose([l[0] for l in losses], ref["losses"],
                               rtol=TOL, atol=0)
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(straight.params)):
        assert torch.equal(a, b)
