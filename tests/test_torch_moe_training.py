"""Training a mixture of experts on one device: the port's ``forward``
auxiliary loss, ``lm_loss`` with ``moe_aux_weight``, their gradients and
``Trainer.fit`` of a MoE ``LlamaModule``, against the JAX package on the
CPU.

The same numpy weights (``params_from_jax``) and tokens go through both, in
fp32 with the capacity bound of ``tiny_moe`` (factor 1.5, so tokens are
dropped on both sides). Tolerances: 1e-5 relative on the loss and the
auxiliary loss, 1e-4 relative to each leaf's max on the gradients (two
layers, the dispatch and combine sums in other orders), and 1e-4 relative
on each step of a Trainer trajectory.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.callbacks.base import Callback as JCallback
from ray_lightning_tpu.core.trainer import Trainer as JTrainer
from ray_lightning_tpu.models import llama as jllama
from ray_lightning_tpu.strategies.base import SingleDeviceStrategy
from ray_lightning_tpu_torch.callbacks import Callback
from ray_lightning_tpu_torch.core import Trainer
from ray_lightning_tpu_torch.core.module import LightningModule
from ray_lightning_tpu_torch.models import llama as tllama
from ray_lightning_tpu_torch.models.convert import params_from_jax, params_to_numpy
from ray_lightning_tpu_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(**overrides):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny_moe(), dtype=jnp.float32,
                               **overrides)
    return jcfg, tllama.LlamaConfig.from_dict(jcfg.to_dict())


def _numpy_params(jcfg, seed=0):
    """JAX init with the norms moved off 1, so their gradients matter."""
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    for name in ("attn_norm", "mlp_norm"):
        arr = tree["layers"][name]
        tree["layers"][name] = (arr + 0.1 * rng.standard_normal(arr.shape)
                                ).astype(arr.dtype)
    return tree


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _tokens(jcfg, seed=5, batch=2, seq=64):
    return np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (batch, seq)).astype(np.int32)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("chunks", [0, 4])
def test_moe_lm_loss_aux_and_gradients_match_jax(remat, chunks):
    """lm_loss on tiny_moe in fp32 against jax.value_and_grad of the JAX
    lm_loss: the loss (cross entropy + 0.01 x aux), the aux loss and ppl
    (exp of the cross entropy alone), and every gradient, the router's and
    the experts' included; on the plain path and the chunked one, with and
    without per-layer remat (the aux leaves the checkpointed layer)."""
    jcfg, tcfg = _configs(remat=remat, loss_chunks=chunks)
    tree = _numpy_params(jcfg)
    tokens = _tokens(jcfg)
    (want, want_logs), want_g = jax.value_and_grad(
        lambda p: jllama.lm_loss(p, jnp.asarray(tokens), jcfg), has_aux=True
    )(jax.tree_util.tree_map(jnp.asarray, tree))
    params = params_from_jax(tree, tcfg, device="cpu")
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    loss, logs = tllama.lm_loss(params, torch.from_numpy(tokens), tcfg)
    assert set(logs) == set(want_logs) == {"loss", "ppl", "moe_aux"}
    assert float(want_logs["moe_aux"]) > 0
    assert abs(loss.item() - float(want)) <= 1e-5 * float(want)
    assert abs(logs["moe_aux"].item() - float(want_logs["moe_aux"])) <= (
        1e-5 * float(want_logs["moe_aux"]))
    assert abs(logs["ppl"].item() - float(want_logs["ppl"])) <= 1e-4 * float(
        want_logs["ppl"])
    ce = loss.item() - tcfg.moe_aux_weight * logs["moe_aux"].item()
    assert logs["ppl"].item() == pytest.approx(np.exp(ce), rel=1e-5)
    loss.backward()
    got_g = params_to_numpy(jax.tree_util.tree_map(
        lambda t: t.grad, params, is_leaf=torch.is_tensor))
    want_np = jax.tree_util.tree_map(np.asarray, want_g)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_np))
    flat_got = jax.tree_util.tree_leaves_with_path(got_g)
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        assert np.abs(flat_want[path]).max() > 0, path
        assert _rel(g, flat_want[path]) < 1e-4, path


def test_moe_forward_returns_aux_only_when_asked():
    """forward(return_aux=True) is the JAX forward's (logits, aux) pair, and
    the hidden-state variant carries the same aux; without it the callers
    that want logits (generation, predict_step) get the logits alone,
    equal to the pair's first element."""
    jcfg, tcfg = _configs()
    tree = _numpy_params(jcfg, seed=1)
    tokens = _tokens(jcfg, seed=6)
    want_logits, want_aux = jllama.forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens), jcfg)
    params = params_from_jax(tree, tcfg, device="cpu")
    x = torch.from_numpy(tokens)
    logits, aux = tllama.forward(params, x, tcfg, return_aux=True)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(aux.item() - float(want_aux)) <= 1e-5 * float(want_aux)
    assert _rel(logits.numpy(), want_logits) < 1e-4
    alone = tllama.forward(params, x, tcfg)
    assert torch.is_tensor(alone) and torch.equal(alone, logits)
    hidden, aux_h = tllama.forward(params, x, tcfg, return_hidden=True,
                                   return_aux=True)
    assert hidden.shape == (2, 64, tcfg.dim) and torch.equal(aux_h, aux)
    # a dense config's aux is an fp32 zero, as JAX's
    dense = dataclasses.replace(tcfg, n_experts=0)
    dparams = tllama.init_params(dense, torch.Generator().manual_seed(0),
                                 device="cpu")
    _, zero = tllama.forward(dparams, x, dense, return_aux=True)
    assert zero.item() == 0.0 and zero.dtype == torch.float32
    assert "moe_aux" not in tllama.lm_loss(dparams, x, dense)[1]


class _Losses:
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        self.losses.append(float(outputs["loss"]))


class _JLosses(_Losses, JCallback):
    pass


class _TLosses(_Losses, Callback):
    pass


def test_moe_llama_trains_and_logs_aux_like_jax(tmp_path):
    """tests/test_llama.py::test_moe_llama_trains on the port, held against
    the JAX Trainer from the same weights: 6 steps (two epochs of 3
    batches, validation at each epoch's end), every step's loss within
    1e-4, the loss falling, and the same logged and callback metric names,
    train_moe_aux and val_moe_aux among them, with epoch values within
    1e-4."""
    jcfg, tcfg = _configs()
    tree = _numpy_params(jcfg, seed=2)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=100)
    dm_kw = dict(batch_size=4, n_train=12, n_val=8)
    trainer_kw = dict(max_steps=6, enable_checkpointing=False, seed=0,
                      logger=False)

    jmod = jllama.LlamaModule(jcfg, **kw)
    jmod._params = jax.tree_util.tree_map(jnp.asarray, tree)
    jcb = _JLosses()
    jtrainer = JTrainer(strategy=SingleDeviceStrategy(), callbacks=[jcb],
                        default_root_dir=str(tmp_path / "jax"), **trainer_kw)
    jtrainer.fit(jmod, datamodule=jllama.SyntheticLMDataModule(jcfg, **dm_kw))

    tmod = tllama.LlamaModule(tcfg, **kw)
    tmod.params = params_from_jax(tree, tcfg, device="cpu")
    tcb = _TLosses()
    ttrainer = Trainer(device="cpu", callbacks=[tcb],
                       default_root_dir=str(tmp_path / "port"), **trainer_kw)
    ttrainer.fit(tmod, datamodule=tllama.SyntheticLMDataModule(tcfg, **dm_kw))

    assert len(tcb.losses) == len(jcb.losses) == 6
    np.testing.assert_allclose(tcb.losses, jcb.losses, rtol=1e-4, atol=0)
    assert tcb.losses[-1] < tcb.losses[0]
    for name in ("val_loss", "val_moe_aux", "train_moe_aux"):
        assert name in ttrainer.callback_metrics, name
        assert float(ttrainer.callback_metrics[name]) == pytest.approx(
            float(jtrainer.callback_metrics[name]), rel=1e-4), name
    assert sorted(ttrainer.callback_metrics) == sorted(jtrainer.callback_metrics)
    assert sorted(ttrainer.logged_metrics) == sorted(jtrainer.logged_metrics)


class _MoELossModule(LightningModule):
    """A user's module that trains a MoE config through lm_loss with SGD."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    def init_params(self, generator, device=None):
        return tllama.init_params(self.cfg, generator, device)

    def training_step(self, params, batch, batch_idx):
        return tllama.lm_loss(params, batch, self.cfg)[0]

    def configure_optimizers(self):
        return torch.optim.SGD(list(tree_leaves(self.params)), lr=0.1)


def test_user_module_moe_step_moves_router_and_experts():
    """One SGD step of a user's module through lm_loss: the router (reached
    through the gates and the auxiliary loss) and every expert matrix move;
    their backward is autograd over the plain torch ops."""
    _, tcfg = _configs()
    module = _MoELossModule(tcfg)
    tokens = torch.from_numpy(_tokens(tcfg, seed=7, batch=1, seq=16)).long()
    trainer = Trainer(device="cpu", max_steps=1, logger=False, seed=0,
                      enable_checkpointing=False)
    gen = torch.Generator().manual_seed(0)
    before = tllama.init_params(tcfg, gen, device="cpu")["layers"]["moe"]
    trainer.fit(module, train_dataloaders=[tokens, tokens])
    after = module.params["layers"]["moe"]
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert not torch.equal(after[name].detach(), before[name]), name
        assert torch.isfinite(after[name]).all(), name
