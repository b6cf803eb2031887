"""The port's mixture of experts (ray_lightning_tpu_torch/parallel/moe.py and
the MoE branches of models/) against the JAX package's, on the CPU.

The same numpy inputs go through both. fp32 at 1e-5 (the expert sums in
another order); bf16 at bf16 rounding: the products round their outputs to
bf16, so two libraries may land one bf16 ulp apart on an intermediate,
which the relative tolerance 2^-6 of the output's scale covers. The
tiny_moe forward at 1e-4 (two fp32 layers), and the paged engine's greedy
streams token-identical to the JAX ``generate``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models import generation as jgen
from ray_lightning_tpu.models import llama as jllama
from ray_lightning_tpu.parallel import moe as jmoe
from ray_lightning_tpu_torch.models import generation as tgen
from ray_lightning_tpu_torch.models import llama as tllama
from ray_lightning_tpu_torch.models.convert import params_from_jax, params_to_numpy
from ray_lightning_tpu_torch.parallel import moe as tmoe
from ray_lightning_tpu_torch.parallel.mesh import MeshSpec
from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

BF16_RTOL = 2.0 ** -6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _moe_inputs(dtype, T=16, D=32, F=48, E=4, seed=0):
    rng = np.random.default_rng(seed)

    def draw(shape, fan_in, dt):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(dt)

    dt = jnp.dtype(dtype)
    params = {
        "router": draw((D, E), D, np.float32),
        "w_gate": draw((E, D, F), D, dt),
        "w_up": draw((E, D, F), D, dt),
        "w_down": draw((E, F, D), F, dt),
    }
    x = draw((2, T // 2, D), 1.0, dt)
    return params, x


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_np(t):
    return t.detach().float().numpy()


def _assert_close(got, want, dtype):
    want = np.asarray(want, np.float32)
    got = _to_np(got)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = float(np.max(np.abs(want)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_RTOL * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["lossless", "route", "moe_ffn",
                                "moe_ffn_capacity_binds"])
def test_moe_functions_match_jax(fn, dtype):
    np_params, x = _moe_inputs(dtype)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    tp = {k: _to_torch(v) for k, v in np_params.items()}
    assert tp["router"].dtype == torch.float32
    jx, tx = jnp.asarray(x), _to_torch(x)
    if fn == "lossless":
        want = jmoe.moe_ffn_lossless(jp, jx, top_k=2)
        got = tmoe.moe_ffn_lossless(tp, tx, top_k=2)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        _assert_close(got, want, dtype)
    elif fn == "route":
        xt = x.reshape(-1, x.shape[-1])
        jd, jc, ja = jmoe._route(jnp.asarray(xt), jp["router"], 2, 5)
        td, tc, ta = tmoe._route(_to_torch(xt), tp["router"], 2, 5)
        # gates are fp32 from an exact fp32 copy of x on both sides
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    else:
        # capacity 3 of 16 tokens x 2 choices over 4 experts must drop
        cap = 3 if fn == "moe_ffn_capacity_binds" else None
        want, jaux = jmoe.moe_ffn(jp, jx, top_k=2, capacity_factor=1.5,
                                  capacity=cap)
        got, taux = tmoe.moe_ffn(tp, tx, top_k=2, capacity_factor=1.5,
                                 capacity=cap)
        assert got.dtype == tx.dtype
        _assert_close(got, want, dtype)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
        if cap is not None:
            xt = tx.reshape(-1, tx.shape[-1])
            disp, _, _ = tmoe._route(xt, tp["router"], 2, cap)
            assert float(disp.sum()) < xt.shape[0] * 2  # tokens were dropped


def test_lossless_equals_capacity_routing_where_capacity_never_binds():
    """moe_ffn at capacity_factor E / top_k keeps every token: it and the
    lossless path agree (the serving exactness check relies on this)."""
    np_params, x = _moe_inputs("float32", seed=3)
    tp = {k: _to_torch(v) for k, v in np_params.items()}
    tx = _to_torch(x)
    routed, _ = tmoe.moe_ffn(tp, tx, top_k=2, capacity_factor=4 / 2)
    np.testing.assert_allclose(routed.numpy(),
                               tmoe.moe_ffn_lossless(tp, tx, 2).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_init_moe_params_keeps_the_router_in_fp32():
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe_params(gen, 16, 24, 4, dtype=torch.bfloat16,
                             n_layers=3, device="cpu")
    assert p["router"].dtype == torch.float32 and p["router"].shape == (3, 16, 4)
    assert p["w_gate"].dtype == torch.bfloat16
    assert p["w_gate"].shape == p["w_up"].shape == (3, 4, 16, 24)
    assert p["w_down"].shape == (3, 4, 24, 16)
    again = tmoe.init_moe_params(torch.Generator().manual_seed(0), 16, 24, 4,
                                 dtype=torch.bfloat16, n_layers=3, device="cpu")
    for k in p:
        assert torch.equal(p[k], again[k])
    # N(0, 1/fan_in): the down projection's fan-in is the ffn width
    assert abs(float(p["w_down"].float().std()) * np.sqrt(24) - 1.0) < 0.1


def _moe_configs(**overrides):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny_moe(),
                               dtype=jnp.float32, **overrides)
    return jcfg, tllama.LlamaConfig.from_dict(jcfg.to_dict())


def _moe_tree(jcfg, seed=0):
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 1)  # norms start at ones: perturb
    for name in ("attn_norm", "mlp_norm"):
        arr = tree["layers"][name]
        tree["layers"][name] = (arr + 0.1 * rng.standard_normal(arr.shape)
                                ).astype(arr.dtype)
    return tree


def test_config_carries_the_moe_fields():
    jcfg = jllama.LlamaConfig.tiny_moe()
    tcfg = tllama.LlamaConfig.from_dict(jcfg.to_dict())
    assert tcfg == tllama.LlamaConfig.tiny_moe()
    for name in ("n_experts", "expert_top_k", "capacity_factor",
                 "moe_aux_weight"):
        assert getattr(tcfg, name) == getattr(jcfg, name)
    mixtral = dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, ffn_dim=14336, n_experts=8)
    assert (tllama.LlamaConfig(**mixtral).num_params()
            == jllama.LlamaConfig(**mixtral).num_params() == 46_702_792_704)
    assert tcfg.flops_per_token() == jcfg.flops_per_token()


def test_forward_tiny_moe_matches_jax():
    jcfg, tcfg = _moe_configs()
    tree = _moe_tree(jcfg)
    tparams = params_from_jax(tree, tcfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 12))
    want, _ = jllama.forward(jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(tokens, jnp.int32), jcfg)
    got = tllama.forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    plain = tllama.forward(tparams, torch.from_numpy(tokens), tcfg, plain=True)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_params_round_trip_is_bitwise(dtype):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny_moe(),
                               dtype=getattr(jnp, dtype))
    tcfg = tllama.LlamaConfig.from_dict(jcfg.to_dict())
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(3), jcfg))
    params = params_from_jax(tree, tcfg, device="cpu")
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    assert params["layers"]["moe"]["w_gate"].dtype == tcfg.dtype
    back = params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_converter_checks_the_moe_subtree():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny_moe(), dtype=jnp.bfloat16)
    tcfg = tllama.LlamaConfig.from_dict(jcfg.to_dict())
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(0), jcfg))
    moe = tree["layers"]["moe"]
    bad_router = dict(moe, router=moe["router"].astype(jnp.bfloat16))
    with pytest.raises(TypeError, match="router"):
        params_from_jax(dict(tree, layers=dict(tree["layers"], moe=bad_router)),
                        tcfg, device="cpu")
    with pytest.raises(ValueError, match="router: shape"):
        params_from_jax(tree, dataclasses.replace(tcfg, n_experts=2), device="cpu")
    dense = {k: v for k, v in tree["layers"].items() if k != "moe"}
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(dict(tree, layers=dense), tcfg, device="cpu")


def test_init_params_places_the_moe_subtree():
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny_moe(), dtype=torch.bfloat16)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    layers = params["layers"]
    assert not {"w_gate", "w_up", "w_down"} & set(layers)
    assert layers["moe"]["router"].dtype == torch.float32
    lp = tllama.layer_params(params, 1)
    assert lp["moe"]["w_gate"].shape == (4, cfg.dim, cfg.ffn_dim)
    assert lp["moe"]["router"].data_ptr() == layers["moe"]["router"][1].data_ptr()
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(params))
    assert n == cfg.num_params()


def test_prefill_routes_losslessly_as_jax():
    """prefill on tiny_moe against the JAX prefill (which routes every
    prompt losslessly too), logits and the cache it fills."""
    jcfg, tcfg = _moe_configs()
    tree = _moe_tree(jcfg, seed=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_jax(tree, tcfg, device="cpu")
    prompt = np.random.default_rng(4).integers(1, jcfg.vocab_size, (2, 9))
    jlog, jcache = jgen.prefill(jparams, jnp.asarray(prompt, jnp.int32), jcfg,
                                jgen.init_kv_cache(jcfg, 2, 16))
    tlog, tcache = tgen.prefill(tparams, torch.from_numpy(prompt), tcfg,
                                tgen.init_kv_cache(tcfg, 2, 16, device="cpu"))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]),
                               rtol=1e-4, atol=1e-4)


def test_engine_greedy_streams_match_jax_generate():
    """Staggered requests, some sharing a prefix, through the port's paged
    engine on tiny_moe with fewer slots than requests: every greedy stream
    token-identical to the JAX package's sequential generate."""
    jcfg, tcfg = _moe_configs()
    tree = _moe_tree(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_jax(tree, tcfg, device="cpu")
    system = [3, 1, 4, 1, 5, 9, 2, 6]
    n_new = 6
    rng = np.random.default_rng(0)
    # one prompt length, so the reference generates every prompt in one
    # batch (rows are independent: lossless routing is per token)
    prompts = [(system if i % 3 == 0 else
                [int(t) for t in rng.integers(10, tcfg.vocab_size, 8)])
               + [int(t) for t in rng.integers(10, tcfg.vocab_size, 3)]
               for i in range(7)]
    engine = InferenceEngine(tparams, tcfg, EngineConfig(
        num_slots=3, max_prompt_len=12, max_len=32, block_size=4,
        kv_layout="paged"), device="cpu")
    comps = [engine.submit(p, max_new_tokens=n_new) for p in prompts[:3]]
    for _ in range(3):
        engine.step()
    comps += [engine.submit(p, max_new_tokens=n_new) for p in prompts[3:]]
    engine.run_until_idle()
    want = np.asarray(jgen.generate(jparams, jnp.asarray(prompts, jnp.int32),
                                    jcfg, max_new_tokens=n_new,
                                    temperature=0.0))[:, len(prompts[0]):]
    for row, comp in zip(want, comps):
        assert comp.finish_reason == "length"
        assert comp.tokens == [int(t) for t in row]
    assert engine.pool.allocator.prefix_hits_total >= 2
    assert set(engine.kernel_launches().values()) == {0}


def test_moe_training_is_refused():
    """MoE training runs on one device (tests/test_torch_moe_training.py) and
    with expert parallelism over a mesh's 'ep' axis
    (tests/test_torch_expert_parallel.py); what stays refused is tensor
    parallelism: a mesh with 'tp' given to param_shardings, and the experts'
    tp_axis."""
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny_moe(), dtype=torch.float32)
    module = tllama.LlamaModule(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        module.param_shardings(MeshSpec(axes={"tp": 2}))
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        tllama.LlamaModule(cfg.to_dict()).param_shardings(
            MeshSpec(axes={"dp": 2, "tp": 2}))
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros((1, 8, cfg.dim))
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        tmoe.moe_ffn_local_experts(tllama.layer_params(params, 0)["moe"], x,
                                   None, tp_axis="tp")
    # the one-device path a user's module takes is not refused any more
    tokens = torch.zeros((1, 8), dtype=torch.long)
    loss = tllama.lm_loss(params, tokens, cfg)[0]
    assert torch.isfinite(loss)
