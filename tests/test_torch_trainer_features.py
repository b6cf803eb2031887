"""The port's complete single-device Trainer against the JAX Trainer, on the
CPU at small sizes: precision policies, several optimizers, a resume in the
middle of a gradient accumulation, remat "dots", the callbacks and logger,
the input pipeline and the remaining Trainer arguments.

Weights and inputs come from numpy and a seed and go through both packages
(``params_from_jax`` for the Llama family). Each test states its
tolerance.
"""
import dataclasses
import glob
import logging
import os
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_lightning_tpu.callbacks.base import Callback as JCallback
from ray_lightning_tpu.callbacks.early_stopping import EarlyStopping as JEarlyStopping
from ray_lightning_tpu.callbacks.throughput import ThroughputMonitor as JThroughput
from ray_lightning_tpu.core.data import DataLoader as JDataLoader
from ray_lightning_tpu.core.data import TensorDataset as JTensorDataset
from ray_lightning_tpu.core.module import LightningModule as JModule
from ray_lightning_tpu.core.trainer import Trainer as JTrainer
from ray_lightning_tpu.models import llama as jllama
from ray_lightning_tpu.strategies.base import SingleDeviceStrategy as JSingleDevice
from ray_lightning_tpu.utils import precision as jprec
from ray_lightning_tpu_torch.callbacks import (
    Callback,
    EarlyStopping,
    ProfilerCallback,
    ThroughputMonitor,
)
from ray_lightning_tpu_torch.callbacks.throughput import peak_tflops_for
from ray_lightning_tpu_torch.core import DataLoader, LightningModule, TensorDataset, Trainer
from ray_lightning_tpu_torch.core.prefetch import (
    _THREAD_PREFIX,
    AsyncLoader,
    DevicePrefetcher,
)
from ray_lightning_tpu_torch.loggers import TENSORBOARD_AVAILABLE, TensorBoardLogger
from ray_lightning_tpu_torch.models import llama as tllama
from ray_lightning_tpu_torch.models.convert import params_from_jax, params_to_numpy
from ray_lightning_tpu_torch.strategies import SingleDeviceStrategy
from ray_lightning_tpu_torch.utils import precision as tprec
from ray_lightning_tpu_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


class _Outputs:
    """Each step's outputs (the logged dict) from on_train_batch_end, as
    floats."""

    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        self.rows.append({k: float(v.double()) if torch.is_tensor(v)
                          else float(np.asarray(v))
                          for k, v in outputs.items()})


class _JOutputs(_Outputs, JCallback):
    pass


class _TOutputs(_Outputs, Callback):
    pass


# --------------------------------------------------------------------- #
# precision tables
# --------------------------------------------------------------------- #
SPELLINGS = [None, "32-true", 32, "32", "bf16", "bf16-mixed", "bf16-true",
             "64-true", 64, "64", "16-mixed", "16-true", "16", 16]


def _dtype_name(dt):
    return None if dt is None else str(np.dtype(dt)) if not isinstance(
        dt, torch.dtype) else str(dt).replace("torch.", "")


@pytest.mark.parametrize("spelling", SPELLINGS, ids=repr)
def test_parse_precision_matches_jax(spelling, caplog):
    """Every spelling the JAX Trainer accepts gives the same policy (name,
    parameter and compute dtypes, the mixed flag) and the same warning (the
    fp16 spellings map to their bf16 twins). 64-true needs JAX's x64 mode;
    torch has no such switch."""
    with caplog.at_level(logging.WARNING):
        with jax.enable_x64(True):
            want = jprec.parse_precision(spelling)
        jwarned = [r.getMessage() for r in caplog.records]
        caplog.clear()
        got = tprec.parse_precision(spelling)
        twarned = [r.getMessage() for r in caplog.records]
    assert got.name == want.name
    assert _dtype_name(got.param_dtype) == _dtype_name(want.param_dtype)
    assert _dtype_name(got.compute_dtype) == _dtype_name(want.compute_dtype)
    assert got.active == want.active
    assert got.cast_params_in_compute == want.cast_params_in_compute
    assert len(twarned) == len(jwarned)
    for t, j in zip(twarned, jwarned):
        assert t.split(":")[0] == j.split(":")[0]  # "precision='16-mixed'"
        assert t.split()[-1] == j.split()[-1]  # the twin it maps to


@pytest.mark.parametrize("bad", ["8-true", "fp8", "bf32", 8])
def test_parse_precision_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError, match="unknown precision"):
        jprec.parse_precision(bad)
    with pytest.raises(ValueError, match="unknown precision"):
        tprec.parse_precision(bad)
    with pytest.raises(ValueError, match="unknown precision"):
        Trainer(device="cpu", precision=bad)


def test_matmul_precision_names_and_parity_match_jax():
    """parse_matmul_precision's names and aliases, its refusal, and
    promises_decode_parity on the CPU over every pair, as JAX's."""
    names = ["default", "bf16", "tensorfloat32", "highest", "fp8-emulated",
             "fp8", "f32", "fp32", "tf32", " HIGHEST ", None]
    for name in names:
        assert tprec.parse_matmul_precision(name) == (
            jprec.parse_matmul_precision(name if name is not None else "default"))
    for bad in ("fp16", "tf16"):
        with pytest.raises(ValueError, match="unknown matmul precision"):
            jprec.parse_matmul_precision(bad)
        with pytest.raises(ValueError, match="unknown matmul precision"):
            tprec.parse_matmul_precision(bad)
        with pytest.raises(ValueError, match="unknown matmul precision"):
            Trainer(device="cpu", matmul_precision=bad)
    for a in names[:5]:
        for b in names[:5]:
            assert tprec.promises_decode_parity(a, b, device="cpu") == (
                jprec.promises_decode_parity(a, b)), (a, b)


def test_fp8_rounding_is_bitwise_jax():
    """round_matmul_inputs("fp8-emulated") against JAX's on the same numpy
    arrays, fp32 and bf16: ties to even, subnormals, the largest finite
    value, past it (NaN, where torch's own cast saturates), infinities and
    NaN, and a tree of operands; bitwise."""
    rng = np.random.default_rng(0)
    edge = np.array([0.0, -0.0, 1e-9, 2.0 ** -10, 2.0 ** -9.5, 0.3, -0.7,
                     447.0, 448.0, 456.0, 464.0, 465.0, 500.0, -1e6, np.inf,
                     -np.inf, np.nan], np.float32)
    x = np.concatenate([edge, (rng.standard_normal(4096) * 100).astype(np.float32)])
    for np_dt, t_dt in ((np.float32, torch.float32),
                        (ml_dtypes.bfloat16, torch.bfloat16)):
        a = x.astype(np_dt)
        want = np.asarray(jprec.round_matmul_inputs("fp8-emulated", jnp.asarray(a)))
        t = torch.from_numpy(a.view(np.int16 if np_dt is not np.float32
                                    else np.float32).copy())
        if t_dt is torch.bfloat16:
            t = t.view(torch.bfloat16)
        got = tprec.round_matmul_inputs("fp8-emulated", t)
        got_np = (got.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                  if t_dt is torch.bfloat16 else got.numpy())
        np.testing.assert_array_equal(got_np.view(np.uint8), want.view(np.uint8))
    # trees, integer leaves untouched, identity for other policies
    tree = {"w": _t(x[:8]), "ids": torch.arange(4)}
    out_a, out_b = tprec.round_matmul_inputs("fp8-emulated", tree, _t(x[8:16]))
    assert torch.equal(out_a["ids"], tree["ids"])
    assert tprec.round_matmul_inputs("highest", tree) is tree


def test_matmul_precision_scope_restores_the_setting():
    """The scope sets cuBLAS's TF32 switch for its block and leaves it as
    it found it, after an exception too; "default" and "fp8-emulated"
    leave it alone. The CPU's fp32 products are not touched."""
    mkldnn_before = torch.backends.mkldnn.matmul.fp32_precision
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for start in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = start
            for policy, inside in (("bf16", True), ("tensorfloat32", True),
                                   ("highest", False), ("default", start),
                                   ("fp8-emulated", start)):
                with tprec.matmul_precision_scope(policy):
                    assert torch.backends.cuda.matmul.allow_tf32 is inside
                    assert (torch.backends.mkldnn.matmul.fp32_precision
                            == mkldnn_before)
                assert torch.backends.cuda.matmul.allow_tf32 is start
            with pytest.raises(RuntimeError):
                with tprec.matmul_precision_scope("highest"):
                    raise RuntimeError("inside")
            assert torch.backends.cuda.matmul.allow_tf32 is start
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_cast_floats_leaves_integers_alone():
    tree = {"x": torch.ones(2), "ids": torch.arange(3), "n": [torch.zeros(1, dtype=torch.float64)]}
    out = tprec.cast_floats(tree, torch.bfloat16)
    assert out["x"].dtype == torch.bfloat16 and out["n"][0].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int64
    assert tprec.cast_floats(tree, None) is tree


# --------------------------------------------------------------------- #
# a small non-Llama module on both packages: linear regression
# --------------------------------------------------------------------- #
def _regression_data(n=64, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    y = x @ rng.standard_normal((d, 1)) + 0.1 * rng.standard_normal((n, 1))
    w0 = {"w": (0.1 * rng.standard_normal((d, 1))), "b": np.zeros((1,))}
    return x, y, w0


class JRegression(JModule):
    def __init__(self, lr=0.05, dtype=np.float32):
        super().__init__()
        self.lr = lr
        self.seen = {}

    def training_step(self, params, batch, batch_idx):
        x, y = batch
        self.seen["dtypes"] = (params["w"].dtype, x.dtype)
        loss = jnp.mean((x @ params["w"] + params["b"] - y) ** 2)
        self.log("train_loss", loss)
        return loss

    def validation_step(self, params, batch, batch_idx):
        x, y = batch
        self.log("val_loss", jnp.mean((x @ params["w"] + params["b"] - y) ** 2))

    def configure_optimizers(self):
        return optax.sgd(self.lr)


class TRegression(LightningModule):
    def __init__(self, lr=0.05):
        super().__init__()
        self.lr = lr
        self.seen = {}

    def training_step(self, params, batch, batch_idx):
        x, y = batch
        self.seen["dtypes"] = (params["w"].dtype, x.dtype)
        loss = torch.mean((x @ params["w"] + params["b"] - y) ** 2)
        self.log("train_loss", loss)
        return loss

    def validation_step(self, params, batch, batch_idx):
        x, y = batch
        self.log("val_loss", torch.mean((x @ params["w"] + params["b"] - y) ** 2))

    def configure_optimizers(self):
        return torch.optim.SGD(list(tree_leaves(self.params)), lr=self.lr)


def _fit_regression(tmp_path, dtype=np.float32, callbacks=(), jcallbacks=(),
                    n=64, **trainer_kw):
    """Fit the regression module on both packages from the same numpy data
    and weights; returns (jax trainer, port trainer, jax module, port
    module)."""
    x, y, w0 = _regression_data(n)
    x, y = x.astype(dtype), y.astype(dtype)
    w0 = {k: v.astype(dtype) for k, v in w0.items()}
    kw = dict(enable_checkpointing=False, logger=False, seed=0, max_epochs=3)
    kw.update(trainer_kw)
    jmod = JRegression()
    jmod._params = {k: jnp.asarray(v) for k, v in w0.items()}
    jtrainer = JTrainer(strategy=JSingleDevice(), callbacks=list(jcallbacks),
                        default_root_dir=str(tmp_path / "jax"), **kw)
    loader = lambda dl, ds: dl(ds(x, y), batch_size=16, shuffle=True)  # noqa: E731
    jtrainer.fit(jmod, train_dataloaders=loader(JDataLoader, JTensorDataset),
                 val_dataloaders=JDataLoader(JTensorDataset(x, y), batch_size=32))
    tmod = TRegression()
    tmod.params = {k: _t(v) for k, v in w0.items()}
    ttrainer = Trainer(device="cpu", callbacks=list(callbacks),
                       default_root_dir=str(tmp_path / "port"), **kw)
    ttrainer.fit(tmod, train_dataloaders=loader(DataLoader, TensorDataset),
                 val_dataloaders=DataLoader(TensorDataset(x, y), batch_size=32))
    return jtrainer, ttrainer, jmod, tmod


def test_64_true_on_a_small_module_matches_jax(tmp_path):
    """precision="64-true" on the regression module (JAX in x64 mode): the
    parameters and the step's inputs are fp64 on both sides, and every
    step's loss and the final weights agree to 1e-12 relative (fp64 sums
    in other orders)."""
    jout, tout = _JOutputs(), _TOutputs()
    with jax.enable_x64(True):
        jtrainer, ttrainer, jmod, tmod = _fit_regression(
            tmp_path, precision="64-true", callbacks=[tout], jcallbacks=[jout])
        jparams = jax.device_get(jtrainer.params)
    assert [str(d) for d in tmod.seen["dtypes"]] == ["torch.float64"] * 2
    assert [np.dtype(d) for d in jmod.seen["dtypes"]] == [np.float64] * 2
    got = [r["loss"] for r in tout.rows]
    want = [r["loss"] for r in jout.rows]
    assert len(got) == len(want) == 12
    np.testing.assert_allclose(got, want, rtol=1e-12)
    for k in ("w", "b"):
        assert tmod.params[k].dtype == torch.float64
        assert _rel(tmod.params[k].detach().numpy(), jparams[k]) < 1e-12


def test_bf16_mixed_keeps_fp32_masters_and_computes_in_bf16(tmp_path):
    """bf16-mixed on the regression module: training_step sees bf16
    parameters and inputs, the masters stay fp32, and the losses follow
    JAX's. The losses are bf16 scalars (8 significant bits): in this run
    they differ by at most two ulps of the value (2^-6 relative), from sums
    of bf16 products in another order; the bound is four (2^-5)."""
    jout, tout = _JOutputs(), _TOutputs()
    jtrainer, ttrainer, jmod, tmod = _fit_regression(
        tmp_path, precision="bf16-mixed", callbacks=[tout], jcallbacks=[jout])
    assert [str(d) for d in tmod.seen["dtypes"]] == ["torch.bfloat16"] * 2
    assert [str(d) for d in jmod.seen["dtypes"]] == ["bfloat16"] * 2
    assert all(t.dtype == torch.float32 for t in tree_leaves(tmod.params))
    np.testing.assert_allclose([r["loss"] for r in tout.rows],
                               [r["loss"] for r in jout.rows], rtol=2.0 ** -5)


# --------------------------------------------------------------------- #
# several optimizers
# --------------------------------------------------------------------- #
def _mlp_numpy(rng, sizes):
    return [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
             "b": np.zeros((b,), np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _gan_numpy(z_dim=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"gen": _mlp_numpy(rng, (z_dim, 16, 1)),
            "disc": _mlp_numpy(rng, (1, 16, 1))}


def _gan_data(n=128, z_dim=4, seed=1):
    rng = np.random.default_rng(seed)
    real = (3.0 + 0.5 * rng.standard_normal((n, 1))).astype(np.float32)
    z = rng.standard_normal((n, z_dim)).astype(np.float32)
    return real, z


def _japply(layers, x):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1:
            x = jax.nn.relu(x)
    return x


def _tapply(layers, x):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


class JGAN(JModule):
    """tests/test_gan.py's TinyGAN with its noise taken from the batch, so
    both packages see the same noise."""

    lr = 2e-3

    def training_step(self, params, batch, batch_idx, optimizer_idx):
        real, z = batch
        fake = _japply(params["gen"], z)
        d = lambda x: _japply(params["disc"], x)  # noqa: E731
        if optimizer_idx == 0:
            g_loss = jnp.mean(jax.nn.softplus(-d(fake)))
            self.log("g_loss", g_loss, on_step=False, on_epoch=True)
            return g_loss
        fake = jax.lax.stop_gradient(fake)
        d_loss = (jnp.mean(jax.nn.softplus(-d(real)))
                  + jnp.mean(jax.nn.softplus(d(fake))))
        self.log("d_loss", d_loss, on_step=False, on_epoch=True)
        return d_loss

    def configure_optimizers(self):
        return {"optimizers": [optax.adam(self.lr), optax.adam(self.lr)],
                "param_labels": {"gen": 0, "disc": 1}}


class TGAN(LightningModule):
    """The port's TinyGAN: two torch Adams, one per group."""

    lr = 2e-3

    def training_step(self, params, batch, batch_idx, optimizer_idx):
        real, z = batch
        fake = _tapply(params["gen"], z)
        d = lambda x: _tapply(params["disc"], x)  # noqa: E731
        sp = torch.nn.functional.softplus
        if optimizer_idx == 0:
            g_loss = torch.mean(sp(-d(fake)))
            self.log("g_loss", g_loss, on_step=False, on_epoch=True)
            return g_loss
        fake = fake.detach()
        d_loss = torch.mean(sp(-d(real))) + torch.mean(sp(d(fake)))
        self.log("d_loss", d_loss, on_step=False, on_epoch=True)
        return d_loss

    def configure_optimizers(self):
        gen = list(tree_leaves(self.params["gen"]))
        disc = list(tree_leaves(self.params["disc"]))
        return {"optimizers": [torch.optim.Adam(gen, lr=self.lr, eps=1e-8),
                               torch.optim.Adam(disc, lr=self.lr, eps=1e-8)],
                "param_labels": {"gen": 0, "disc": 1}}


def _fit_gan(tmp_path, jcls=JGAN, tcls=TGAN, **trainer_kw):
    tree = _gan_numpy()
    real, z = _gan_data()
    kw = dict(enable_checkpointing=False, logger=False, seed=0, max_epochs=1,
              **trainer_kw)
    jout, tout = _JOutputs(), _TOutputs()
    jmod = jcls()
    jmod._params = jax.tree_util.tree_map(jnp.asarray, tree)
    jtrainer = JTrainer(strategy=JSingleDevice(), callbacks=[jout],
                        default_root_dir=str(tmp_path / "jax"), **kw)
    jtrainer.fit(jmod, train_dataloaders=JDataLoader(
        JTensorDataset(real, z), batch_size=16, shuffle=True))
    tmod = tcls()
    tmod.params = {g: [{k: _t(v) for k, v in layer.items()} for layer in layers]
                   for g, layers in tree.items()}
    ttrainer = Trainer(device="cpu", callbacks=[tout],
                       default_root_dir=str(tmp_path / "port"), **kw)
    ttrainer.fit(tmod, train_dataloaders=DataLoader(
        TensorDataset(real, z), batch_size=16, shuffle=True))
    return jtrainer, ttrainer, jout, tout, tmod


@pytest.mark.parametrize("accumulate", [1, 2])
def test_alternating_optimizers_match_jax(tmp_path, accumulate):
    """The GAN's alternating optimizers over 8 batches (with and without an
    accumulation of 2): loss_opt0, loss_opt1 and their sum 'loss' per step,
    the epoch's g_loss/d_loss, and every parameter after the fit agree with
    the JAX Trainer to 1e-4 relative (fp32; Adam rescales each gradient, so
    the first updates carry rounding at the 1e-6 level)."""
    jtrainer, ttrainer, jout, tout, tmod = _fit_gan(
        tmp_path, accumulate_grad_batches=accumulate)
    assert len(jout.rows) == len(tout.rows) == 8
    for j, t in zip(jout.rows, tout.rows):
        for key in ("loss_opt0", "loss_opt1", "loss"):
            assert abs(t[key] - j[key]) <= 1e-4 * abs(j[key]), (key, t, j)
    for key in ("g_loss", "d_loss"):
        assert abs(float(ttrainer.callback_metrics[key])
                   - float(jtrainer.callback_metrics[key])) <= 1e-4 * abs(
            float(jtrainer.callback_metrics[key]))
    want = jax.device_get(jtrainer.params)
    for group in ("gen", "disc"):
        for jl, tl in zip(want[group], tmod.params[group]):
            for k in ("w", "b"):
                got = tl[k].detach().numpy()
                assert _rel(got, jl[k]) < 1e-4, (group, k)


def test_alternating_refusals_match_jax(tmp_path):
    """A training_step without optimizer_idx is a TypeError, param_labels
    missing, an ambiguous bare list and out-of-range labels are
    ValueErrors, in both packages; the port also refuses labels that
    disagree with the optimizers' own parameter sets."""

    class JNoIdx(JGAN):
        def training_step(self, params, batch, batch_idx):
            return jnp.float32(0.0)

    class TNoIdx(TGAN):
        def training_step(self, params, batch, batch_idx):
            return torch.zeros((), requires_grad=True)

    for jcls, tcls, err, match in (
        (JNoIdx, TNoIdx, TypeError, "optimizer_idx"),
    ):
        with pytest.raises(err, match=match):
            _fit_gan(tmp_path, jcls=jcls, tcls=JGAN)
        with pytest.raises(err, match=match):
            _fit_gan(tmp_path, jcls=JGAN, tcls=tcls)

    def port_with(configure):
        return type("T", (TGAN,), {"configure_optimizers": configure})

    def jax_with(configure):
        return type("J", (JGAN,), {"configure_optimizers": configure})

    def adams(self):
        return [torch.optim.Adam(list(tree_leaves(self.params[g])), lr=1e-3)
                for g in ("gen", "disc")]

    cases = [
        (lambda s: {"optimizers": [optax.adam(1e-3), optax.adam(1e-3)]},
         lambda s: {"optimizers": adams(s)}, "param_labels"),
        (lambda s: [optax.adam(1e-3), optax.adam(1e-3)],
         lambda s: adams(s), "param_labels"),
        (lambda s: {"optimizers": [optax.adam(1e-3), optax.adam(1e-3)],
                    "param_labels": {"gen": 0, "disc": 2}},
         lambda s: {"optimizers": adams(s),
                    "param_labels": {"gen": 0, "disc": 2}}, "param_labels"),
    ]
    for jconf, tconf, match in cases:
        with pytest.raises(ValueError, match=match):
            _fit_gan(tmp_path, jcls=jax_with(jconf), tcls=JGAN)
        with pytest.raises(ValueError, match=match):
            _fit_gan(tmp_path, jcls=JGAN, tcls=port_with(tconf))
    # labels that swap the groups against the optimizers' parameter sets
    swapped = port_with(lambda s: {"optimizers": adams(s),
                                   "param_labels": {"gen": 1, "disc": 0}})
    with pytest.raises(ValueError, match="holds it"):
        _fit_gan(tmp_path, jcls=JGAN, tcls=swapped)


class JTwoGroup(JModule):
    def training_step(self, params, batch, batch_idx):
        x, y = batch
        out = x @ params["w1"] + jnp.tanh(x @ params["w2"])
        loss = jnp.mean((out - y) ** 2)
        self.log("train_loss", loss)
        return loss

    def configure_optimizers(self):
        return {"optimizers": {"a": optax.adamw(1e-2, weight_decay=0.1),
                               "b": optax.adamw(1e-3, weight_decay=0.1)},
                "param_labels": {"w1": "a", "w2": "b"}}


class TTwoGroup(LightningModule):
    def training_step(self, params, batch, batch_idx):
        x, y = batch
        out = x @ params["w1"] + torch.tanh(x @ params["w2"])
        loss = torch.mean((out - y) ** 2)
        self.log("train_loss", loss)
        return loss

    def configure_optimizers(self):
        p = self.params
        return {"optimizers": {
                    "a": torch.optim.AdamW([p["w1"]], lr=1e-2, weight_decay=0.1),
                    "b": torch.optim.AdamW([p["w2"]], lr=1e-3, weight_decay=0.1)},
                "param_labels": {"w1": "a", "w2": "b"}}


def test_per_group_optimizers_match_optax_multi_transform(tmp_path):
    """Two AdamWs with different learning rates over one loss (one
    backward, both step) against the JAX Trainer's optax.multi_transform,
    with a clip over both groups: every step's loss and both weights to
    1e-4 relative over 8 steps (fp32)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((128, 8)).astype(np.float32)
    y = rng.standard_normal((128, 1)).astype(np.float32)
    w = {"w1": (0.3 * rng.standard_normal((8, 1))).astype(np.float32),
         "w2": (0.3 * rng.standard_normal((8, 1))).astype(np.float32)}
    kw = dict(enable_checkpointing=False, logger=False, seed=0, max_epochs=1,
              gradient_clip_val=0.5)
    jout, tout = _JOutputs(), _TOutputs()
    jmod = JTwoGroup()
    jmod._params = {k: jnp.asarray(v) for k, v in w.items()}
    jtrainer = JTrainer(strategy=JSingleDevice(), callbacks=[jout],
                        default_root_dir=str(tmp_path / "j"), **kw)
    jtrainer.fit(jmod, train_dataloaders=JDataLoader(
        JTensorDataset(x, y), batch_size=16, shuffle=True))
    tmod = TTwoGroup()
    tmod.params = {k: _t(v) for k, v in w.items()}
    ttrainer = Trainer(device="cpu", callbacks=[tout],
                       default_root_dir=str(tmp_path / "t"), **kw)
    ttrainer.fit(tmod, train_dataloaders=DataLoader(
        TensorDataset(x, y), batch_size=16, shuffle=True))
    assert len(tout.rows) == len(jout.rows) == 8
    np.testing.assert_allclose([r["loss"] for r in tout.rows],
                               [r["loss"] for r in jout.rows], rtol=1e-4)
    want = jax.device_get(jtrainer.params)
    for k in ("w1", "w2"):
        assert _rel(tmod.params[k].detach().numpy(), want[k]) < 1e-4, k
    assert len(ttrainer.optimizers) == 2


# --------------------------------------------------------------------- #
# gradient accumulation: a resume in the middle of one
# --------------------------------------------------------------------- #
def _llama(**overrides):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32,
                               max_seq=32, **overrides)
    tcfg = tllama.LlamaConfig.from_dict(jcfg.to_dict())
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(4), jcfg))
    return jcfg, tcfg, tree


def test_resume_in_the_middle_of_an_accumulation(tmp_path):
    """accumulate_grad_batches=2 over epochs of 3 micro-batches: a fit of
    one epoch (which ends with one micro-batch accumulated), a checkpoint,
    and a resume for the second epoch give exactly the losses and final
    parameters of one uninterrupted two-epoch fit (same ops in the same
    order on the CPU: bitwise)."""
    _, tcfg, tree = _llama()
    kw = dict(device="cpu", logger=False, enable_checkpointing=False, seed=0,
              accumulate_grad_batches=2, limit_train_batches=3,
              gradient_clip_val=1.0)
    dm_kw = dict(batch_size=2, n_train=12, n_val=2)

    def module():
        m = tllama.LlamaModule(tcfg, lr=3e-3, warmup_steps=1, total_steps=6)
        m.params = params_from_jax(tree, tcfg, device="cpu")
        return m

    full_out = _TOutputs()
    full = module()
    Trainer(max_epochs=2, callbacks=[full_out], **kw).fit(
        full, datamodule=tllama.SyntheticLMDataModule(tcfg, **dm_kw))

    path = str(tmp_path / "mid.ckpt")

    class SaveAtEpochEnd(Callback):
        def on_train_epoch_end(self, trainer, module):
            assert trainer._micro_step == 1
            trainer.save_checkpoint(path)

    first_out = _TOutputs()
    Trainer(max_epochs=1, callbacks=[first_out, SaveAtEpochEnd()], **kw).fit(
        module(), datamodule=tllama.SyntheticLMDataModule(tcfg, **dm_kw))
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert saved["accumulation"]["micro_step"] == 1

    rest_out = _TOutputs()
    resumed = Trainer(max_epochs=2, callbacks=[rest_out], **kw)
    resumed.fit(module(), datamodule=tllama.SyntheticLMDataModule(tcfg, **dm_kw),
                ckpt_path=path)
    assert resumed.global_step == 6 and resumed._micro_step == 0
    got = [r["loss"] for r in first_out.rows + rest_out.rows]
    assert got == [r["loss"] for r in full_out.rows]
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(full.params)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# remat "dots"
# --------------------------------------------------------------------- #
class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_saves_the_projections_and_matches_jax():
    """On the 2-layer tiny config: backward under "dots" runs exactly the
    products of backward without remat (no forward projection is
    recomputed), where "nothing" recomputes them; the loss and every
    gradient are bitwise equal across the three; and they agree with JAX's
    remat_policy="dots" to 1e-5 (loss) and 1e-4 relative to each leaf's max
    (gradients), fp32."""
    jcfg, _, tree = _llama(remat=True, remat_policy="dots")
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    results, products = {}, {}
    for name, over in (("off", dict(remat=False)), ("nothing", dict(remat_policy="nothing")),
                       ("dots", {})):
        tcfg = tllama.LlamaConfig.from_dict(
            dataclasses.replace(jcfg, **over).to_dict())
        params = params_from_jax(tree, tcfg, device="cpu")
        leaves = list(tree_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = tllama.lm_loss(params, _t(tokens), tcfg)
        count = _CountProducts()
        with count:
            loss.backward()
        products[name] = count.n
        results[name] = (loss.detach(), [t.grad for t in leaves], params)
    recomputed = products["nothing"] - products["off"]
    assert recomputed >= jcfg.n_layers * 6  # the projections, per layer
    assert products["dots"] == products["off"]
    for name in ("nothing", "dots"):
        assert torch.equal(results[name][0], results["off"][0])
        for a, b in zip(results[name][1], results["off"][1]):
            assert torch.equal(a, b), name

    (want, _), want_g = jax.value_and_grad(
        lambda p: jllama.lm_loss(p, jnp.asarray(tokens), jcfg), has_aux=True
    )(jax.tree_util.tree_map(jnp.asarray, tree))
    loss, grads, params = results["dots"]
    assert abs(float(loss) - float(want)) <= 1e-5 * float(want)
    got_g = params_to_numpy({
        "embed": params["embed"].grad, "final_norm": params["final_norm"].grad,
        "lm_head": params["lm_head"].grad,
        "layers": {k: v.grad for k, v in params["layers"].items()}})
    want_np = jax.tree_util.tree_map(np.asarray, want_g)
    for key in ("embed", "final_norm", "lm_head"):
        assert _rel(got_g[key], want_np[key]) < 1e-4, key
    for key, g in got_g["layers"].items():
        assert _rel(g, want_np["layers"][key]) < 1e-4, key


# --------------------------------------------------------------------- #
# callbacks and logger
# --------------------------------------------------------------------- #
def test_early_stopping_stops_at_the_jax_epoch_and_keeps_its_state(tmp_path):
    """EarlyStopping(mode="max") on a falling val_loss stops both Trainers
    at the same epoch with the same state; the state round-trips; and
    min_epochs holds the stop off to the same epoch on both."""
    es_kw = dict(monitor="val_loss", mode="max", patience=2)
    jes, tes = JEarlyStopping(**es_kw), EarlyStopping(**es_kw)
    jtrainer, ttrainer, _, _ = _fit_regression(
        tmp_path, callbacks=[tes], jcallbacks=[jes], max_epochs=20)
    assert ttrainer.early_stopping_callback is tes
    assert ttrainer.current_epoch == jtrainer.current_epoch < 20
    assert tes.stopped_epoch == jes.stopped_epoch > 0
    assert tes.state_dict() == pytest.approx(jes.state_dict(), rel=1e-5)
    again = EarlyStopping(**es_kw)
    again.load_state_dict(tes.state_dict())
    assert again.state_dict() == tes.state_dict()

    jes, tes = JEarlyStopping(**es_kw), EarlyStopping(**es_kw)
    jtrainer, ttrainer, _, _ = _fit_regression(
        tmp_path, callbacks=[tes], jcallbacks=[jes], max_epochs=20,
        min_epochs=6)
    assert ttrainer.current_epoch == jtrainer.current_epoch == 6


def test_throughput_monitor_summary_has_the_jax_keys(tmp_path):
    """ThroughputMonitor's summary after a fit has JAX's keys (the values
    differ: JAX's CPU backend counts 8 virtual chips); the peak table maps
    the H100's name to 989 TFLOP/s."""
    kw = dict(flops_per_sample=1e3, tokens_per_sample=8, sync_every=2)
    jtm, ttm = JThroughput(**kw), ThroughputMonitor(**kw)
    jtrainer, ttrainer, _, _ = _fit_regression(tmp_path, callbacks=[ttm],
                                               jcallbacks=[jtm])
    assert set(ttm.summary(ttrainer)) == set(jtm.summary(jtrainer)) == {
        "step_time_s", "samples_per_sec", "tokens_per_sec_per_chip",
        "train_mfu"}
    assert all(np.isfinite(v) and v > 0 for v in ttm.summary(ttrainer).values())
    assert "train_mfu" in ttrainer.callback_metrics
    assert peak_tflops_for("NVIDIA H100 80GB HBM3") == 989.0
    with pytest.raises(ValueError):
        ThroughputMonitor(peak_tflops=0)


def test_profiler_callback_writes_a_trace(tmp_path):
    prof = ProfilerCallback(start_step=1, num_steps=2)
    _fit_regression(tmp_path, callbacks=[prof])
    traces = glob.glob(str(tmp_path / "port" / "profile" / "rank0" / "*.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0


def test_tensorboard_logger_writes_events(tmp_path):
    if not TENSORBOARD_AVAILABLE:
        pytest.skip("tensorboard is not installed")
    logger = TensorBoardLogger(str(tmp_path / "tb"))
    x, y, w0 = _regression_data()
    mod = TRegression()
    mod.params = {k: _t(v.astype(np.float32)) for k, v in w0.items()}
    Trainer(device="cpu", logger=logger, max_epochs=1, log_every_n_steps=1,
            enable_checkpointing=False).fit(
        mod, train_dataloaders=DataLoader(TensorDataset(
            x.astype(np.float32), y.astype(np.float32)), batch_size=16))
    events = glob.glob(os.path.join(logger.log_dir, "events.out.tfevents.*"))
    assert events and os.path.getsize(events[0]) > 0


# --------------------------------------------------------------------- #
# the input pipeline (tests/test_prefetch.py's counterparts)
# --------------------------------------------------------------------- #
def _input_threads():
    return [t for t in threading.enumerate() if t.name.startswith(_THREAD_PREFIX)]


def _no_input_threads(timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not _input_threads():
            return True
        time.sleep(0.02)
    return False


class _Jitter:
    """Per-item sleeps so pooled workers finish out of order."""

    def __init__(self, n=48, poison=None):
        self.n, self.poison = n, poison

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        if idx == self.poison:
            raise ValueError(f"poisoned item {idx}")
        time.sleep(0.001 * (idx % 3))
        return np.full((4,), idx, dtype=np.float32)


@pytest.mark.parametrize("num_workers", [1, 3])
def test_async_loader_keeps_order(num_workers):
    loader = DataLoader(_Jitter(), batch_size=4)
    want = [b.copy() for b in loader]
    got = list(AsyncLoader(loader, num_workers=num_workers))
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert _no_input_threads()


def test_async_loader_raises_after_the_good_batches():
    loader = DataLoader(_Jitter(n=24, poison=13), batch_size=4)
    seen = []
    with pytest.raises(ValueError, match="poisoned item 13"):
        for batch in AsyncLoader(loader, num_workers=2):
            seen.append(int(batch[0, 0]))
    assert seen == [0, 4, 8]
    assert _no_input_threads()


def test_async_loader_early_break_and_serial_mode_leak_no_threads():
    for _ in AsyncLoader(DataLoader(_Jitter(), batch_size=2), num_workers=2):
        break
    assert _no_input_threads()

    def gen():
        for i in range(5):
            yield np.full((2,), i)

    got = [int(b[0]) for b in AsyncLoader(gen())]
    assert got == [0, 1, 2, 3, 4]
    assert _no_input_threads()


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_device_prefetcher_window_order_and_limit(depth):
    copied = []

    def shard(batch):
        copied.append(int(batch[0]))
        return batch * 2

    pf = DevicePrefetcher(shard, depth=depth)
    src = [np.full((2,), i, dtype=np.float32) for i in range(10)]
    seen = []
    for idx, host, dev in pf.iterate(src):
        assert int(host[0]) == idx
        np.testing.assert_array_equal(dev, host * 2)
        assert len(copied) - len(seen) <= depth + 1
        seen.append(idx)
    assert seen == copied == list(range(10))
    assert pf.batches == 10 and pf.starved_s >= 0.0
    loads = []

    def gen():
        for i in range(100):
            loads.append(i)
            yield np.full((2,), i)

    assert [i for i, _, _ in DevicePrefetcher(lambda b: b, depth=depth).iterate(
        gen(), limit=4)] == [0, 1, 2, 3]
    assert len(loads) == 4


def test_device_prefetcher_error_contract():
    def gen():
        yield np.zeros((2,))
        yield np.ones((2,))
        raise RuntimeError("ragged final batch")

    seen = []
    with pytest.raises(RuntimeError, match="ragged final batch"):
        for idx, _, _ in DevicePrefetcher(lambda b: b, depth=2).iterate(gen()):
            seen.append(idx)
    assert seen == [0, 1]

    def bad_shard(batch):
        if int(batch[0]) == 2:
            raise ValueError("uncopyable")
        return batch

    seen = []
    with pytest.raises(ValueError, match="uncopyable"):
        for idx, _, _ in DevicePrefetcher(bad_shard, depth=2).iterate(
                [np.full((2,), i) for i in range(5)]):
            seen.append(idx)
    assert seen == [0, 1]


def test_single_device_strategy_settings():
    s = SingleDeviceStrategy()
    assert (s.prefetch_depth, s.loader_num_workers) == (2, None)
    s = SingleDeviceStrategy(prefetch_depth=0, loader_num_workers=0)
    assert (s.prefetch_depth, s.loader_num_workers) == (0, 0)
    with pytest.raises(ValueError, match="prefetch_depth"):
        SingleDeviceStrategy(prefetch_depth=-1)
    with pytest.raises(ValueError, match="loader_num_workers"):
        SingleDeviceStrategy(loader_num_workers=-2)


@pytest.mark.parametrize("depth,workers", [(0, 0), (2, None), (3, 2)])
def test_fit_through_the_pipeline_trains_the_same(tmp_path, depth, workers):
    """The fit through every pipeline setting gives the synchronous
    path's losses bitwise, stops early at max_steps and leaves no input
    thread behind."""
    out = {}
    for key, strategy in (("sync", SingleDeviceStrategy(0, 0)),
                          ("case", SingleDeviceStrategy(depth, workers))):
        rows = _TOutputs()
        x, y, w0 = _regression_data()
        mod = TRegression()
        mod.params = {k: _t(v.astype(np.float32)) for k, v in w0.items()}
        trainer = Trainer(device="cpu", strategy=strategy, logger=False,
                          max_steps=7, enable_checkpointing=False,
                          callbacks=[rows])
        trainer.fit(mod, train_dataloaders=DataLoader(TensorDataset(
            x.astype(np.float32), y.astype(np.float32)), batch_size=8,
            shuffle=True, num_workers=1))
        out[key] = [r["loss"] for r in rows.rows]
        # the lookahead copies at most `depth` batches past the last step
        assert 7 <= trainer._input_stats["batches"] <= 7 + strategy.prefetch_depth
        assert trainer._input_stats["starved_s"] >= 0.0
    assert len(out["case"]) == 7 and out["case"] == out["sync"]
    assert _no_input_threads()


# --------------------------------------------------------------------- #
# the remaining Trainer arguments
# --------------------------------------------------------------------- #
def test_trainer_arguments_are_accepted(tmp_path, capsys):
    """fast_dev_run (one batch a stage, one epoch, no checkpoint), the
    accelerator/devices pairs that mean one device here,
    use_distributed_sampler, SingleDeviceStrategy and the progress line."""
    x, y, w0 = _regression_data()
    loader = DataLoader(TensorDataset(x.astype(np.float32), y.astype(np.float32)),
                        batch_size=8)
    mod = TRegression()
    mod.params = {k: _t(v.astype(np.float32)) for k, v in w0.items()}
    trainer = Trainer(device="cpu", fast_dev_run=True, max_epochs=5,
                      default_root_dir=str(tmp_path), logger=False,
                      enable_progress_bar=True, use_distributed_sampler=False,
                      strategy=SingleDeviceStrategy())
    trainer.fit(mod, train_dataloaders=loader, val_dataloaders=loader)
    assert trainer.global_step == 1 and trainer.current_epoch == 1
    assert trainer.checkpoint_callback is None
    assert not os.path.exists(tmp_path / "checkpoints")
    assert "[epoch 0] 1 steps" in capsys.readouterr().out
    for kw in (dict(accelerator="cpu"), dict(accelerator="cpu", devices=1),
               dict(device="cpu", accelerator="auto", devices="auto")):
        assert Trainer(**kw).device.type == "cpu"
    with pytest.raises(ValueError, match="contradicts"):
        Trainer(device="cpu", accelerator="gpu")
    with pytest.raises(ValueError):
        Trainer(device="cpu", accumulate_grad_batches=0)
