"""The port's model and generation (ray_lightning_tpu_torch/models/) against
the JAX package's, on tiny fp32 configs built from the same numpy weights.

Tolerance 1e-4 on logits: two fp32 layers of matmuls summed in another
order; greedy tokens must agree exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models import generation as jgen
from ray_lightning_tpu.models import llama as jllama
from ray_lightning_tpu_torch.models import generation as tgen
from ray_lightning_tpu_torch.models import llama as tllama
from ray_lightning_tpu_torch.models.convert import params_from_jax, params_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes run fastest on two threads; restore the process's count
    for the test files that share this worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(**overrides):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32,
                               **overrides)
    return jcfg, tllama.LlamaConfig.from_dict(jcfg.to_dict())


def _numpy_params(jcfg, seed=0):
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(seed), jcfg)
    )
    if jcfg.attn_bias:  # the JAX init zeroes biases: randomize so they count
        rng = np.random.default_rng(seed)
        for name in ("bq", "bk", "bv"):
            arr = tree["layers"][name]
            tree["layers"][name] = rng.standard_normal(arr.shape).astype(arr.dtype)
    # norms start at ones: perturb so the weight multiply is exercised
    rng = np.random.default_rng(seed + 1)
    for name in ("attn_norm", "mlp_norm"):
        arr = tree["layers"][name]
        tree["layers"][name] = (arr + 0.1 * rng.standard_normal(arr.shape)
                                ).astype(arr.dtype)
    return tree


def _both(tree, jcfg, tcfg):
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jparams, params_from_jax(tree, tcfg, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_is_bitwise(dtype):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(),
                               dtype=getattr(jnp, dtype), attn_bias=True)
    tcfg = tllama.LlamaConfig.from_dict(jcfg.to_dict())
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(3), jcfg)
    )
    params = params_from_jax(tree, tcfg, device="cpu")
    assert params["layers"]["wq"].dtype == tcfg.dtype
    back = params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), path


def test_converter_refuses_mismatches():
    jcfg, tcfg = _configs()
    tree = _numpy_params(jcfg)
    # a MoE subtree on a dense config is a leaf the config does not have
    bad = dict(tree, layers=dict(tree["layers"], moe={}))
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(bad, tcfg, device="cpu")
    with pytest.raises(ValueError):
        params_from_jax(tree, dataclasses.replace(tcfg, ffn_dim=128), device="cpu")
    with pytest.raises(TypeError):
        params_from_jax(tree, dataclasses.replace(tcfg, dtype=torch.bfloat16),
                        device="cpu")
    # a MoE config carries over (it serves and trains): it builds a module
    moe_cfg = tllama.LlamaConfig.from_dict(jllama.LlamaConfig.tiny_moe().to_dict())
    assert moe_cfg.n_experts == 4
    module = tllama.LlamaModule(moe_cfg)
    assert module.config is moe_cfg and module.hparams["config"]["n_experts"] == 4


@pytest.mark.parametrize("variant", ["dense", "attn_bias", "window"])
def test_forward_logits_match_jax(variant):
    overrides = {"attn_bias": True} if variant == "attn_bias" else (
        {"sliding_window": 5} if variant == "window" else {})
    jcfg, tcfg = _configs(**overrides)
    jparams, tparams = _both(_numpy_params(jcfg), jcfg, tcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 12))
    want, _ = jllama.forward(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    got = tllama.forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    plain = tllama.forward(tparams, torch.from_numpy(tokens), tcfg, plain=True)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


def test_prefill_and_paged_decode_match_jax_kernel():
    """Prefill two prompts, pack their caches into one paged pool (block 0
    is trash, row 2 is a free slot on a trash table row), then one
    decode_step_paged on each side: the JAX one through its Pallas kernel
    in interpret mode."""
    jcfg, tcfg = _configs()
    jparams, tparams = _both(_numpy_params(jcfg), jcfg, tcfg)
    rng = np.random.default_rng(7)
    bs, maxb = 4, 8
    C = bs * maxb
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (5, 11)]
    L, hkv, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    k_pool = rng.standard_normal((L, 12, hkv, bs, hd)).astype(np.float32)
    v_pool = rng.standard_normal((L, 12, hkv, bs, hd)).astype(np.float32)
    tables = np.zeros((3, maxb), np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :3] = [1, 9, 4]
    tokens, pos = [], []
    for row, prompt in enumerate(prompts):
        P = len(prompt)
        jcache = jgen.init_kv_cache(jcfg, 1, C)
        jlog, jcache = jgen.prefill(jparams, jnp.asarray([prompt], jnp.int32),
                                    jcfg, jcache)
        tcache = tgen.init_kv_cache(tcfg, 1, C, device="cpu")
        tlog, tcache = tgen.prefill(tparams, torch.tensor([prompt]), tcfg, tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tcache["k"][:, :, :, :P].numpy(),
                                   np.asarray(jcache["k"])[:, :, :, :P],
                                   rtol=1e-5, atol=1e-5)
        kc = np.asarray(jcache["k"])[:, 0]  # [L, Hkv, C, hd]
        vc = np.asarray(jcache["v"])[:, 0]
        for j in range((P - 1) // bs + 1):
            blk = tables[row, j]
            k_pool[:, blk] = kc[:, :, j * bs:(j + 1) * bs]
            v_pool[:, blk] = vc[:, :, j * bs:(j + 1) * bs]
        tokens.append(int(np.argmax(np.asarray(jlog)[0])))
        pos.append(P)  # the first generated position
    tokens.append(0)
    pos.append(0)
    tokens = np.asarray(tokens, np.int32)
    pos = np.asarray(pos, np.int32)

    jlog, jcache = jgen.decode_step_paged(
        jparams, {"k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool)},
        jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(tables), jcfg,
        kernel=True,
    )
    tcache = {"k": torch.from_numpy(k_pool.copy()),
              "v": torch.from_numpy(v_pool.copy())}
    tlog, tcache = tgen.decode_step_paged(
        tparams, tcache, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(tables), tcfg,
    )
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tlog[:2].argmax(-1).numpy(),
                                  np.asarray(jlog)[:2].argmax(-1))
    # the in-place writes land where the JAX function's new cache has them
    # (block 0, the trash block, is excluded: its writes race by design)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name][:, 1:].numpy(),
                                   np.asarray(jcache[name])[:, 1:],
                                   rtol=1e-5, atol=1e-5)


def test_sample_logits_plain_paths():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 50, generator=g)
    greedy = tgen._sample_logits(logits, g, 0.0, None, None)
    torch.testing.assert_close(greedy, logits.argmax(-1).to(torch.int32))
    top1 = tgen._sample_logits(logits, g, 0.9, 1, None)
    torch.testing.assert_close(top1, greedy)  # top-k 1 is greedy
    nucleus = tgen._sample_logits(logits, g, 0.9, None, 1e-6)
    torch.testing.assert_close(nucleus, greedy)  # only the top token survives
    topk = tgen._sample_logits(logits, g, 1.0, 5, None)
    kth = torch.topk(logits, 5, dim=-1).values[:, -1]
    assert bool((logits.gather(1, topk.long()[:, None])[:, 0] >= kth).all())


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.init_params(tcfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.init_kv_cache(tcfg, 1, 8)
