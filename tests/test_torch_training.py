"""The port's training path (ray_lightning_tpu_torch/) against the JAX
package's, on the CPU at small sizes.

Same numpy inputs through both. The JAX side runs its Pallas kernels in
interpret mode (its flash backward included); the port runs its kernels'
plain versions, which is what a CPU tensor takes. fp32 unless a test says
otherwise, so the tolerances only absorb summation order; each test states
its own.
"""
import csv
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_lightning_tpu.callbacks.base import Callback as JCallback
from ray_lightning_tpu.core.trainer import Trainer as JTrainer
from ray_lightning_tpu.loggers.csv_logger import CSVLogger as JCSVLogger
from ray_lightning_tpu.models import llama as jllama
from ray_lightning_tpu.ops import losses as jlosses
from ray_lightning_tpu.ops.rmsnorm import rmsnorm as jrmsnorm
from ray_lightning_tpu.strategies.base import SingleDeviceStrategy
from ray_lightning_tpu_torch.callbacks import Callback, ModelCheckpoint
from ray_lightning_tpu_torch.core import Trainer
from ray_lightning_tpu_torch.loggers import CSVLogger
from ray_lightning_tpu_torch.models import llama as tllama
from ray_lightning_tpu_torch.models.convert import params_from_jax, params_to_numpy
from ray_lightning_tpu_torch.ops import attention as tattn
from ray_lightning_tpu_torch.ops import losses as tlosses
from ray_lightning_tpu_torch.ops.rmsnorm import RMSNormFunction, rmsnorm

# the package's ops/__init__ re-exports a function named `attention`
jattn = importlib.import_module("ray_lightning_tpu.ops.attention")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes run fastest on two threads; restore the process's count
    for the test files that share this worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a, requires_grad=False):
    return torch.from_numpy(np.asarray(a).copy()).requires_grad_(requires_grad)


def _bf16(a):
    """A JAX/ml_dtypes bfloat16 array as a torch bfloat16 tensor, bitwise."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# --------------------------------------------------------------------- #
# (a) flash-attention backward
# --------------------------------------------------------------------- #
# the four gradient cases of tests/test_ops.py (mha, GQA across blocks, GQA
# non-causal, maximal group) plus a sliding window, at S 64 in 16-row blocks
GRAD_CASES = {
    "mha": dict(hq=2, hkv=2, causal=True, window=None),
    "gqa_multiblock": dict(hq=8, hkv=2, causal=True, window=None),
    "gqa_noncausal": dict(hq=8, hkv=2, causal=False, window=None),
    "gqa_group4": dict(hq=4, hkv=1, causal=True, window=None),
    "window": dict(hq=4, hkv=2, causal=True, window=24),
}
S_GRAD, D_GRAD = 64, 32


def _grad_inputs(c, seed=7):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, c["hq"], S_GRAD, D_GRAD)).astype(np.float32)
    k = rng.standard_normal((2, c["hkv"], S_GRAD, D_GRAD)).astype(np.float32)
    v = rng.standard_normal((2, c["hkv"], S_GRAD, D_GRAD)).astype(np.float32)
    do = rng.standard_normal((2, c["hq"], S_GRAD, D_GRAD)).astype(np.float32)
    return q, k, v, do


def _jax_flash_grads(q, k, v, do, c):
    def loss(q, k, v):
        out = jattn.attention(q, k, v, causal=c["causal"], impl="flash",
                              interpret=True, block_q=16, block_k=16,
                              window=c["window"])
        return jnp.sum(out * jnp.asarray(do))

    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_flash_backward_matches_jax_grad(case):
    """fp32: the plain backward and the autograd Function against jax.grad
    of the interpreted Pallas kernels, 1e-4 relative to each gradient's
    max (sums over 64 keys and a group of up to 4 heads, in other
    orders)."""
    c = GRAD_CASES[case]
    q, k, v, do = _grad_inputs(c)
    want = _jax_flash_grads(q, k, v, do, c)
    scale = 1.0 / np.sqrt(D_GRAD)

    o, lse = tattn.flash_attention(_t(q), _t(k), _t(v), c["causal"], None,
                                   c["window"])
    plain = tattn.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, lse,
                                            _t(do), c["causal"], scale,
                                            c["window"])
    tq, tk, tv = (_t(a, requires_grad=True) for a in (q, k, v))
    out = tattn.FlashAttentionFunction.apply(tq, tk, tv, c["causal"], scale,
                                             c["window"])
    via_fn = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    for name, w, p, f in zip("qkv", want, plain, via_fn):
        assert _rel(p.numpy(), w) < 1e-4, f"plain d{name}"
        assert _rel(f.numpy(), w) < 1e-4, f"autograd Function d{name}"
    # the dispatcher's CPU path (the reference einsum under autograd) agrees
    tq, tk, tv = (_t(a, requires_grad=True) for a in (q, k, v))
    out = tattn.attention(tq, tk, tv, causal=c["causal"], window=c["window"])
    for name, w, g in zip("qkv", want, torch.autograd.grad(out, (tq, tk, tv),
                                                           _t(do))):
        assert _rel(g.numpy(), w) < 1e-4, f"attention() d{name}"


@pytest.mark.parametrize("case", ["gqa_multiblock", "window", "gqa_noncausal"])
def test_flash_backward_plain_matches_jax_kernels_in_bf16(case):
    """bf16: the plain backward against the JAX ``_flash_bwd`` (interpreted
    Pallas) on the same bf16 q, k, v, O, lse and dO. Both round dS (and P
    before Pᵀ·dO) to bf16 at the same places and accumulate in fp32, then
    round the result to bf16 once; the roundings of P and dS can still
    fall differently where XLA's and torch's fp32 exp differ by an ulp, so
    the bound is two bf16 ulps of the gradient's max (2^-7 relative)."""
    c = GRAD_CASES[case]
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16) for a in _grad_inputs(c, 9))
    scale = float(1.0 / np.sqrt(D_GRAD))
    out, lse = jattn._flash_fwd(q, k, v, c["causal"], scale, True, (16, 16),
                                c["window"])
    want = jattn._flash_bwd(q, k, v, out, lse, do, c["causal"], scale, True,
                            (16, 16), c["window"])
    got = tattn.flash_attention_bwd_plain(
        _bf16(q), _bf16(k), _bf16(v), _bf16(out), _t(lse), _bf16(do),
        c["causal"], scale, c["window"])
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float().numpy(), np.asarray(w, np.float32)) <= 2.0 ** -7, name


# the shapes where the card tests hold the tensor-core backward kernels
# against the plain version: head dims that are not a power of two (the JAX
# flash path lane-pads them to 128) and a ragged S, which impl="flash"
# refuses, so its gradient comes from impl="reference"
EDGE_CASES = {
    "hd80": dict(S=48, d=80, window=None, impl="flash"),
    "hd96_window": dict(S=48, d=96, window=20, impl="flash"),
    "ragged77": dict(S=77, d=64, window=None, impl="reference"),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_flash_backward_plain_matches_jax_at_kernel_edges(case):
    """fp32: flash_attention_bwd_plain against jax.grad of the JAX attention
    (interpreted Pallas kernels in 16-row blocks, or the einsum reference
    for the ragged length), GQA group 2, causal; 1e-4 relative to each
    gradient's max (sums in other orders)."""
    c = EDGE_CASES[case]
    rng = np.random.default_rng(11)
    q, do = (rng.standard_normal((1, 4, c["S"], c["d"])).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 2, c["S"], c["d"])).astype(np.float32)
            for _ in range(2))
    extra = (dict(interpret=True, block_q=16, block_k=16)
             if c["impl"] == "flash" else {})

    def loss(q, k, v):
        out = jattn.attention(q, k, v, causal=True, impl=c["impl"],
                              window=c["window"], **extra)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o, lse = tattn.flash_attention(_t(q), _t(k), _t(v), True, None,
                                   c["window"])
    got = tattn.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, lse, _t(do),
                                          True, None, c["window"])
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) < 1e-4, f"d{name}"


def test_flash_backward_checks_its_inputs():
    q = torch.zeros(1, 2, 8, 16)
    lse = torch.zeros(1, 2, 8, 1)
    with pytest.raises(ValueError):
        tattn.flash_attention_bwd(q, q, q, q, lse[:, :, :4], q)
    with pytest.raises(ValueError):
        tattn.flash_attention_bwd(q, q[:, :1, :4], q[:, :1, :4], q, lse, q)
    m = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_bwd(m, m, m, m, torch.empty((1, 2, 8, 1),
                                                           device="meta"), m)


# --------------------------------------------------------------------- #
# (b) RMSNorm gradients
# --------------------------------------------------------------------- #
def test_rmsnorm_gradients_match_jax():
    """The autograd Function (kernel forward, reference-formula backward)
    and the CPU dispatcher against jax.vjp of the JAX rmsnorm, fp32,
    1e-5 relative (sums over a 96-wide row)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    g = rng.standard_normal((3, 5, 96)).astype(np.float32)
    want_y, vjp = jax.vjp(lambda a, b: jrmsnorm(a, b, 1e-5),
                          jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    for fn in (lambda a, b: RMSNormFunction.apply(a, b, 1e-5),
               lambda a, b: rmsnorm(a, b, 1e-5)):
        tx, tw = _t(x, True), _t(w, True)
        y = fn(tx, tw)
        assert _rel(y.detach().numpy(), want_y) < 1e-6
        dx, dw = torch.autograd.grad(y, (tx, tw), _t(g))
        assert _rel(dx.numpy(), want[0]) < 1e-5
        assert _rel(dw.numpy(), want[1]) < 1e-5


# --------------------------------------------------------------------- #
# (c) losses
# --------------------------------------------------------------------- #
def test_cross_entropy_losses_match_jax():
    """Masked and chunked CE: values and gradients against
    ray_lightning_tpu/ops/losses.py, fp32, 1e-5 relative (log-sum-exp over
    50 classes, sums over 32 positions)."""
    rng = np.random.default_rng(4)
    B, S, D, V, n = 2, 16, 32, 50, 4
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    mask[1, 3] = 0.0

    def jchunked(h, w):
        total, count = jlosses.chunked_softmax_cross_entropy(
            h, w, jnp.asarray(targets), jnp.asarray(mask), n)
        return total / count

    def jmasked(h, w):
        total, count = jlosses.masked_softmax_cross_entropy(
            h @ w, jnp.asarray(targets), jnp.asarray(mask))
        return total / count

    for jfn, tfn in (
        (jchunked, lambda h, w: tlosses.chunked_softmax_cross_entropy(
            h, w, _t(targets), _t(mask), n)),
        (jmasked, lambda h, w: tlosses.masked_softmax_cross_entropy(
            h @ w, _t(targets), _t(mask))),
    ):
        want, want_g = jax.value_and_grad(jfn, argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(w))
        th, tw = _t(h, True), _t(w, True)
        total, count = tfn(th, tw)
        loss = total / count
        assert float(count) == float(mask.sum())
        assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
        for g, wg in zip(torch.autograd.grad(loss, (th, tw)), want_g):
            assert _rel(g.numpy(), wg) < 1e-5
    with pytest.raises(ValueError):
        tlosses.chunked_softmax_cross_entropy(_t(h), _t(w), _t(targets),
                                              _t(mask), 5)


# --------------------------------------------------------------------- #
# (d) lm_loss
# --------------------------------------------------------------------- #
def _configs(**overrides):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32,
                               **overrides)
    return jcfg, tllama.LlamaConfig.from_dict(jcfg.to_dict())


def _numpy_params(jcfg, seed=0):
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(seed), jcfg))
    # norms start at ones: perturb so their gradients mean something
    rng = np.random.default_rng(seed + 1)
    for name in ("attn_norm", "mlp_norm"):
        arr = tree["layers"][name]
        tree["layers"][name] = (arr + 0.1 * rng.standard_normal(arr.shape)
                                ).astype(arr.dtype)
    return tree


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("chunks", [0, 4])
def test_lm_loss_and_gradients_match_jax(remat, chunks):
    """lm_loss value and every parameter gradient on ``tiny`` in fp32
    against jax.value_and_grad of the JAX lm_loss: 1e-5 on the loss, 1e-4
    relative to each leaf's max on the gradients (two layers, sums over
    up to 512 classes and 64 positions in other orders)."""
    jcfg, tcfg = _configs(remat=remat, loss_chunks=chunks)
    assert tcfg.remat is remat and tcfg.loss_chunks == chunks
    tree = _numpy_params(jcfg)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    (want, want_logs), want_g = jax.value_and_grad(
        lambda p: jllama.lm_loss(p, jnp.asarray(tokens), jcfg), has_aux=True
    )(jax.tree_util.tree_map(jnp.asarray, tree))
    params = params_from_jax(tree, tcfg, device="cpu")
    leaves = [params["embed"], *params["layers"].values(),
              params["final_norm"], params["lm_head"]]
    for t in leaves:
        t.requires_grad_(True)
    loss, logs = tllama.lm_loss(params, _t(tokens), tcfg)
    assert abs(loss.item() - float(want)) <= 1e-5 * float(want)
    assert abs(logs["ppl"].item() - float(want_logs["ppl"])) <= 1e-4 * float(
        want_logs["ppl"])
    loss.backward()
    got_g = params_to_numpy({
        "embed": params["embed"].grad,
        "layers": {k: v.grad for k, v in params["layers"].items()},
        "final_norm": params["final_norm"].grad,
        "lm_head": params["lm_head"].grad,
    })
    want_np = jax.tree_util.tree_map(np.asarray, want_g)
    for key in ("embed", "final_norm", "lm_head"):
        assert _rel(got_g[key], want_np[key]) < 1e-4, key
    for key, g in got_g["layers"].items():
        assert _rel(g, want_np["layers"][key]) < 1e-4, key


def test_config_round_trip_and_refusals():
    jcfg = jllama.LlamaConfig.small()
    tcfg = tllama.LlamaConfig.from_dict(jcfg.to_dict())
    assert tcfg == tllama.LlamaConfig.small()
    assert (tcfg.remat, tcfg.remat_policy, tcfg.loss_chunks) == (True, "nothing", 8)
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.flops_per_token() == jcfg.flops_per_token()
    assert tllama.LlamaConfig.from_dict(tcfg.to_dict()) == tcfg
    # "dots" is ported: the JAX config's policy carries over
    dots = tllama.LlamaConfig.from_dict(
        dataclasses.replace(jcfg, remat_policy="dots").to_dict())
    assert dots.remat_policy == "dots" and dots.remat
    with pytest.raises(ValueError):
        tllama.LlamaConfig(remat_policy="everything")


# --------------------------------------------------------------------- #
# (e) the optimizer
# --------------------------------------------------------------------- #
def test_adamw_schedule_matches_optax():
    """LlamaModule.configure_optimizers (AdamW + LambdaLR) against the JAX
    module's optax.adamw(warmup_cosine_decay_schedule) on fixed gradients
    over 5 steps, through warm-up and decay; fp32, 1e-6 relative. The first
    update uses lr 0 on both sides."""
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in tree.items()} for _ in range(5)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1)
    tx = jllama.LlamaModule(None, **kw).configure_optimizers()
    module = tllama.LlamaModule(None, **kw)
    module.params = {k: torch.nn.Parameter(_t(v)) for k, v in tree.items()}
    conf = module.configure_optimizers()
    opt, sched = conf["optimizer"], conf["lr_scheduler"]

    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(jparams)
    for i, g in enumerate(grads):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.params.items():
            p.grad = _t(g[k])
        opt.step()
        sched.step()
        for k, p in module.params.items():
            got = p.detach().numpy()
            if i == 0:
                np.testing.assert_array_equal(got, tree[k])  # lr 0
            assert _rel(got, np.asarray(jparams[k])) < 1e-6, (i, k)


# --------------------------------------------------------------------- #
# (f) the loss trajectory through Trainer.fit
# --------------------------------------------------------------------- #
class _Losses:
    """Collects each step's loss from on_train_batch_end (JAX and port)."""

    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        self.losses.append(outputs["loss"])


class _JLosses(_Losses, JCallback):
    pass


class _TLosses(_Losses, Callback):
    pass


def _csv_columns(log_dir):
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        return next(csv.reader(f))


# (config overrides, Trainer arguments) of each trajectory case. With 5
# batches an epoch, accumulations of 2 and 3 leave a partial accumulation
# open across the epoch's end and its validation.
TRAJECTORY_CASES = {
    "fp32": ({}, {}),
    "accumulate2": ({}, dict(accumulate_grad_batches=2)),
    "accumulate3_clip": ({}, dict(accumulate_grad_batches=3,
                                  gradient_clip_val=0.5)),
    "remat_dots": (dict(remat=True, remat_policy="dots"), {}),
    "32-true": ({}, dict(precision="32-true")),
    "bf16-true": ({}, dict(precision="bf16-true")),
    "bf16-mixed": ({}, dict(precision="bf16-mixed")),
}
# bf16 cases: both sides round the same products and sums to bf16 in other
# orders, and AdamW amplifies the differences of the first updates. The
# largest gap measured over the 10 steps, on the CPU, was 2.0e-3 relative
# (bf16-true; bf16-mixed 4.6e-4); the bound is twice that, against a fall
# of the loss of ~34 % (6.2 -> 4.1).
BF16_RTOL = 4e-3


@pytest.mark.parametrize("case", list(TRAJECTORY_CASES))
def test_ten_step_trajectory_matches_jax_trainer(tmp_path, case):
    """The JAX Trainer and the port's Trainer fit LlamaModule(tiny, fp32
    weights) on SyntheticLMDataModule from the same parameters for 10 steps
    (two epochs of 5 batches, validation at each epoch's end), under each
    case's config and Trainer arguments: every step's loss agrees (fp32:
    1e-4 relative; bf16: BF16_RTOL), the loss falls, both log the same
    metric names and CSV columns, count the same global steps and hold the
    parameters in the same dtypes."""
    cfg_kw, case_kw = TRAJECTORY_CASES[case]
    jcfg, tcfg = _configs(**cfg_kw)
    tree = _numpy_params(jcfg, seed=2)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    dm_kw = dict(batch_size=4, n_train=20, n_val=8)
    trainer_kw = dict(max_steps=10, enable_checkpointing=False, seed=0,
                      log_every_n_steps=1, **case_kw)

    jmod = jllama.LlamaModule(jcfg, **kw)
    jmod._params = jax.tree_util.tree_map(jnp.asarray, tree)
    jcb = _JLosses()
    jtrainer = JTrainer(strategy=SingleDeviceStrategy(), callbacks=[jcb],
                        logger=JCSVLogger(str(tmp_path / "jax")),
                        default_root_dir=str(tmp_path / "jax"), **trainer_kw)
    jtrainer.fit(jmod, datamodule=jllama.SyntheticLMDataModule(jcfg, **dm_kw))

    tmod = tllama.LlamaModule(tcfg, **kw)
    tmod.params = params_from_jax(tree, tcfg, device="cpu")
    tcb = _TLosses()
    ttrainer = Trainer(device="cpu", callbacks=[tcb],
                       logger=CSVLogger(str(tmp_path / "port")),
                       default_root_dir=str(tmp_path / "port"), **trainer_kw)
    ttrainer.fit(tmod, datamodule=tllama.SyntheticLMDataModule(tcfg, **dm_kw))

    want = np.asarray([float(x) for x in jcb.losses])
    got = np.asarray([float(x) for x in tcb.losses])
    assert len(want) == len(got) == 10
    rtol = BF16_RTOL if case.startswith("bf16") else 1e-4
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    assert got[-1] < got[0]
    assert sorted(ttrainer.logged_metrics) == sorted(jtrainer.logged_metrics)
    assert sorted(ttrainer.callback_metrics) == sorted(jtrainer.callback_metrics)
    assert _csv_columns(ttrainer.logger.log_dir) == _csv_columns(
        jtrainer.logger.log_dir)
    assert ttrainer.global_step == jtrainer.global_step == 10
    # the tensors the port hands back are the trained ones, in JAX's dtypes
    trained = params_to_numpy(tmod.params)
    assert not np.array_equal(trained["lm_head"], tree["lm_head"])
    jdtypes = {k: str(np.dtype(a.dtype)) for k, a in
               jax.tree_util.tree_flatten_with_path(jtrainer.params)[0]}
    tdtypes = {k: str(a.dtype).replace("torch.", "") for k, a in
               jax.tree_util.tree_flatten_with_path(tmod.params)[0]}
    assert tdtypes == jdtypes


# --------------------------------------------------------------------- #
# (g) the Trainer's surface
# --------------------------------------------------------------------- #
def _tiny_fit(tmp_path, **trainer_kw):
    _, tcfg = _configs(max_seq=32)
    module = tllama.LlamaModule(tcfg, lr=3e-3, warmup_steps=1, total_steps=20)
    dm = tllama.SyntheticLMDataModule(tcfg, batch_size=4, n_train=24, n_val=8)
    kw = dict(device="cpu", seed=0, default_root_dir=str(tmp_path))
    kw.update(trainer_kw)
    trainer = Trainer(**kw)
    trainer.fit(module, datamodule=dm)
    return trainer, module, dm


def test_trainer_limits_and_validation_interval(tmp_path):
    """max_steps stops mid-epoch; limit_train_batches (int and fraction)
    cuts each epoch; an int val_check_interval validates every N steps."""
    seen = []

    class Count(Callback):
        def on_validation_end(self, trainer, module):
            seen.append(trainer.global_step)

    trainer, _, _ = _tiny_fit(tmp_path, max_steps=5, logger=False,
                              enable_checkpointing=False)
    assert trainer.global_step == 5
    trainer, _, _ = _tiny_fit(tmp_path, max_epochs=2, limit_train_batches=2,
                              logger=False, enable_checkpointing=False)
    assert trainer.global_step == 4
    trainer, _, _ = _tiny_fit(tmp_path, max_epochs=1, limit_train_batches=0.5,
                              logger=False, enable_checkpointing=False)
    assert trainer.global_step == 3
    trainer, _, _ = _tiny_fit(tmp_path, max_epochs=1, val_check_interval=2,
                              logger=False, enable_checkpointing=False,
                              callbacks=[Count()])
    assert seen == [2, 4, 6]
    assert {"val_loss", "val_ppl", "train_loss_epoch"} <= set(
        trainer.callback_metrics)


def test_trainer_validate_test_predict(tmp_path):
    trainer, module, dm = _tiny_fit(tmp_path, max_steps=3, logger=False,
                                    enable_checkpointing=False)
    val = trainer.validate(module, datamodule=dm)
    assert set(val[0]) == {"val_loss", "val_ppl"}
    assert np.isfinite(float(val[0]["val_loss"]))
    test = trainer.test(module, dataloaders=dm.val_dataloader())
    assert float(test[0]["val_loss"]) == pytest.approx(float(val[0]["val_loss"]))
    preds = trainer.predict(module, dataloaders=dm.val_dataloader())
    assert len(preds) == 2 and preds[0].shape == (4, 32, module.config.vocab_size)
    assert preds[0].device.type == "cpu"


def test_trainer_refuses_what_it_does_not_port():
    """What stays refused: strategies over several devices and the TPU
    accelerator."""
    for kw in (dict(strategy="ddp"), dict(devices=2),
               dict(accelerator="tpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(device="cpu", **kw)
    with pytest.raises(ValueError):
        Trainer(device="cpu", limit_train_batches=1.5)


def test_csv_logger_rows(tmp_path):
    trainer, _, _ = _tiny_fit(tmp_path, max_epochs=2, limit_train_batches=3,
                              log_every_n_steps=1, enable_checkpointing=False,
                              logger=CSVLogger(str(tmp_path / "logs")))
    with open(os.path.join(trainer.logger.log_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    step_rows = [r for r in rows if r["train_loss_step"]]
    assert [int(r["step"]) for r in step_rows] == [0, 1, 2, 3, 4, 5]
    assert all(np.isfinite(float(r["train_ppl"])) for r in step_rows)
    assert sum(1 for r in rows if r["train_loss_epoch"]) == 2
    assert sum(1 for r in rows if r["val_loss"]) == 2
    assert os.path.exists(os.path.join(trainer.logger.log_dir, "hparams.json"))


def test_model_checkpoint_top_k_and_reload(tmp_path):
    ckpt = ModelCheckpoint(dirpath=str(tmp_path / "ckpt"), monitor="val_loss",
                           save_top_k=2, save_last=True,
                           filename="{epoch}-{val_loss}")
    trainer, module, dm = _tiny_fit(tmp_path, max_epochs=3,
                                    limit_train_batches=2, logger=False,
                                    callbacks=[ckpt])
    kept = sorted(p for p in os.listdir(tmp_path / "ckpt") if p != "last.ckpt")
    assert len(kept) == 2 and len(ckpt.best_k_models) == 2
    assert ckpt.best_model_score == min(ckpt.best_k_models.values())
    assert os.path.exists(ckpt.last_model_path)
    saved = torch.load(ckpt.last_model_path, map_location="cpu",
                       weights_only=True)
    assert {"state_dict", "optimizer_states", "hyper_parameters", "epoch",
            "global_step"} <= set(saved)
    assert saved["global_step"] == 6

    reloaded = tllama.LlamaModule.load_from_checkpoint(ckpt.last_model_path)
    assert reloaded.config == module.config and reloaded.lr == module.lr
    for a, b in zip(params_to_numpy(reloaded.params)["layers"].values(),
                    params_to_numpy(module.params)["layers"].values()):
        np.testing.assert_array_equal(a, b)
    fresh = Trainer(device="cpu", logger=False, enable_checkpointing=False)
    val = fresh.validate(reloaded, datamodule=dm)
    want = trainer.validate(module, datamodule=dm)
    assert float(val[0]["val_loss"]) == pytest.approx(float(want[0]["val_loss"]),
                                                      rel=1e-6)
    # resume: the optimizer and progress come back, training goes on
    resumed = Trainer(device="cpu", logger=False, enable_checkpointing=False,
                      max_epochs=4, limit_train_batches=2, seed=0)
    resumed.fit(tllama.LlamaModule(module.config, lr=3e-3, warmup_steps=1,
                                   total_steps=20),
                datamodule=dm, ckpt_path=ckpt.last_model_path)
    assert resumed.global_step == 8 and resumed.current_epoch == 4
