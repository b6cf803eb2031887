"""The port's Hugging Face importers (ray_lightning_tpu_torch/models/
hf_import.py) against ``transformers`` and the JAX package's importers.

Each model is a randomly initialised ``transformers`` model at tiny widths
(hidden 64, 1-2 layers, fp32). The port's logits must match HF's and the
JAX import's ``forward`` to 1e-4, and the port's params must equal
``params_from_jax`` of the JAX import bitwise (in bf16 too, where the
Mixtral router stays fp32). Every refusal of ``config_from_hf`` and the
importers is held against the JAX importer's.
"""
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models import hf_import as jhf
from ray_lightning_tpu.models import llama as jllama
from ray_lightning_tpu_torch.models import hf_import as thf
from ray_lightning_tpu_torch.models import llama as tllama
from ray_lightning_tpu_torch.models.convert import params_from_jax, params_to_numpy
from ray_lightning_tpu_torch.ops.rope import normalize_rope_scaling
from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

transformers = pytest.importorskip("transformers")

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=64, rms_norm_eps=1e-6,
             rope_theta=10000.0, tie_word_embeddings=False,
             attention_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _llama_family(variant):
    if variant == "llama3_rope":
        cfg = transformers.LlamaConfig(
            **dict(SMALL, max_position_embeddings=128, rope_theta=500000.0),
            num_hidden_layers=2,
            rope_scaling={"rope_type": "llama3", "factor": 8.0,
                          "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                          "original_max_position_embeddings": 16})
        return transformers.LlamaForCausalLM, cfg, 48
    if variant == "mistral_window":
        cfg = transformers.MistralConfig(**SMALL, num_hidden_layers=1,
                                         sliding_window=8)
        return transformers.MistralForCausalLM, cfg, 32
    if variant == "qwen2_bias":
        cfg = transformers.Qwen2Config(**SMALL, num_hidden_layers=1,
                                       sliding_window=8,
                                       use_sliding_window=True,
                                       max_window_layers=0)
        return transformers.Qwen2ForCausalLM, cfg, 32
    cfg = transformers.LlamaConfig(**dict(SMALL, tie_word_embeddings=True),
                                   num_hidden_layers=1)
    return transformers.LlamaForCausalLM, cfg, 16


def _mixtral(window):
    cfg = transformers.MixtralConfig(
        **SMALL, num_hidden_layers=2 if window is None else 1,
        num_local_experts=4, num_experts_per_tok=2, sliding_window=window)
    return transformers.MixtralForCausalLM, cfg, 32 if window else 16


def _build(cls, cfg, seed=0):
    torch.manual_seed(seed)
    hf = cls(cfg).eval()
    with torch.no_grad():
        for layer in hf.model.layers:  # norms and biases start at constants
            layer.input_layernorm.weight.normal_(1.0, 0.1)
            layer.post_attention_layernorm.weight.normal_(1.0, 0.1)
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj):
                if proj.bias is not None:
                    proj.bias.normal_(0, 0.5)
    return hf


def _assert_bitwise(params, jparams, cfg):
    want = params_to_numpy(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu"))
    got = params_to_numpy(params)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        g = flat_g[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


def _hold(hf, port_import, jax_import, seq):
    params, cfg = port_import(hf, dtype=torch.float32, device="cpu")
    jparams, jcfg = jax_import(hf, dtype=jnp.float32)
    assert cfg == tllama.LlamaConfig.from_dict(jcfg.to_dict())
    _assert_bitwise(params, jparams, cfg)
    tokens = np.random.default_rng(seq).integers(0, cfg.vocab_size, (2, seq))
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
        ours = tllama.forward(params, torch.from_numpy(tokens), cfg).numpy()
    jours, _ = jllama.forward(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours, np.asarray(jours), rtol=0, atol=1e-4)
    return params, cfg


@pytest.mark.parametrize("variant", ["llama3_rope", "mistral_window",
                                     "qwen2_bias", "tied"])
def test_llama_family_import_matches_hf_and_jax(variant):
    cls, hf_cfg, seq = _llama_family(variant)
    params, cfg = _hold(_build(cls, hf_cfg), thf.import_hf_llama,
                        jhf.import_hf_llama, seq)
    assert cfg.attn_bias == (variant == "qwen2_bias")
    assert cfg.sliding_window == (8 if variant in ("mistral_window",
                                                   "qwen2_bias") else 0)
    if variant == "tied":
        assert torch.equal(params["lm_head"], params["embed"].t())
        assert params["lm_head"].data_ptr() != params["embed"].data_ptr()


@pytest.mark.parametrize("window", [None, 8], ids=["dense", "window8"])
def test_mixtral_import_matches_hf_and_jax(window):
    cls, hf_cfg, seq = _mixtral(window)
    params, cfg = _hold(_build(cls, hf_cfg), thf.import_hf_mixtral,
                        jhf.import_hf_mixtral, seq)
    assert (cfg.n_experts, cfg.expert_top_k) == (4, 2)
    assert cfg.capacity_factor == 2.0  # E / top_k: never binds
    assert cfg.moe_aux_weight == float(hf_cfg.router_aux_loss_coef)
    assert cfg.sliding_window == (window or 0)
    assert params["layers"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_bf16_import_is_bitwise_the_jax_import(family):
    cls, hf_cfg, _ = (_llama_family("tied") if family == "llama"
                      else _mixtral(None))
    hf = _build(cls, hf_cfg, seed=3)
    port_import, jax_import = ((thf.import_hf_llama, jhf.import_hf_llama)
                               if family == "llama" else
                               (thf.import_hf_mixtral, jhf.import_hf_mixtral))
    params, cfg = port_import(hf, dtype=torch.bfloat16, device="cpu")
    jparams, jcfg = jax_import(hf, dtype=jnp.bfloat16)
    assert cfg.dtype == torch.bfloat16
    assert params["layers"]["wq"].dtype == torch.bfloat16
    _assert_bitwise(params, jparams, cfg)


def test_imported_mixtral_serves_hf_greedy_tokens():
    """A user's path: import a Mixtral checkpoint and serve it on the
    paged engine; greedy streams equal transformers' own generate."""
    cls, hf_cfg, _ = _mixtral(None)
    hf = _build(cls, hf_cfg, seed=5)
    params, cfg = thf.import_hf_mixtral(hf, dtype=torch.float32, device="cpu")
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (3, 7))
    engine = InferenceEngine(params, cfg, EngineConfig(
        num_slots=2, max_prompt_len=8, max_len=16, block_size=4,
        kv_layout="paged"), device="cpu")
    comps = [engine.submit(p.tolist(), max_new_tokens=6) for p in prompts]
    engine.run_until_idle()
    with torch.no_grad():
        ref = hf.generate(torch.from_numpy(prompts), max_new_tokens=6,
                          do_sample=False, pad_token_id=0).numpy()
    assert [c.tokens for c in comps] == [r[7:].tolist() for r in ref]


def _hf_namespace(**over):
    base = dict(SMALL, num_hidden_layers=2, rope_scaling=None)
    base.update(over)
    return SimpleNamespace(**base)


REFUSED = {
    # yarn maps, but not on a model whose layers mix attention types
    "yarn": dict(rope_scaling={"rope_type": "yarn", "factor": 4.0,
                               "original_max_position_embeddings": 32},
                 sliding_window=8,
                 layer_types=["sliding_attention", "full_attention"]),
    # longrope maps, but not with a partial rotary factor (Phi-4-mini)
    "longrope": dict(rope_scaling={"rope_type": "longrope", "factor": 2.0,
                                   "long_factor": [2.0] * 8,
                                   "short_factor": [1.0] * 8,
                                   "original_max_position_embeddings": 32},
                     partial_rotary_factor=0.75),
    "dynamic": dict(rope_scaling={"rope_type": "dynamic", "factor": 4.0}),
    "partial_rotary": dict(partial_rotary_factor=0.75),
    "mlp_bias": dict(mlp_bias=True),
    "attention_bias": dict(attention_bias=True),
    "mixed_layer_types": dict(sliding_window=8, layer_types=[
        "sliding_attention", "full_attention"]),
    "max_window_layers": dict(sliding_window=8, use_sliding_window=True,
                              max_window_layers=1),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_config_from_hf_refuses_what_it_cannot_map(case):
    hf_cfg = _hf_namespace(**REFUSED[case])
    with pytest.raises(NotImplementedError) as port:
        thf.config_from_hf(hf_cfg)
    # the JAX importer refuses the same configs
    with pytest.raises(NotImplementedError) as ref:
        jhf.config_from_hf(hf_cfg)
    if case in ("yarn", "longrope"):
        # the rope itself maps: the refusal is the model's other feature
        assert normalize_rope_scaling(hf_cfg.rope_scaling) is not None
        assert ("mixed per-layer" if case == "yarn"
                else "partial_rotary_factor") in str(port.value)
    if case == "dynamic":
        assert "dynamic" in str(port.value) and "dynamic" in str(ref.value)


@pytest.mark.parametrize("over,window", [
    (dict(sliding_window=8, use_sliding_window=True, max_window_layers=0), 8),
    (dict(sliding_window=8, use_sliding_window=False), 0),
    (dict(sliding_window=8, layer_types=["full_attention"] * 2), 0),
    (dict(sliding_window=8, max_window_layers=2), 0),
    (dict(sliding_window=None), 0),
], ids=["all_slide", "window_off", "all_full", "none_slide", "no_window"])
def test_config_from_hf_window_gating_matches_jax(over, window):
    hf_cfg = _hf_namespace(**over)
    cfg = thf.config_from_hf(hf_cfg, dtype=torch.float32)
    assert cfg.sliding_window == window
    assert cfg == tllama.LlamaConfig.from_dict(
        jhf.config_from_hf(hf_cfg, dtype=jnp.float32).to_dict())


def test_mixtral_8x7b_published_config():
    """The published Mixtral-8x7B-v0.1 config.json values, as the card's
    serving phase reads them: 46.7 B parameters at 32 layers."""
    ns = SimpleNamespace(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=1e6,
        sliding_window=None, num_local_experts=8, num_experts_per_tok=2,
        router_aux_loss_coef=0.02, tie_word_embeddings=False)
    cfg = thf.mixtral_config_from_hf(ns)
    assert cfg.num_params() == 46_702_792_704
    assert (cfg.n_experts, cfg.expert_top_k, cfg.capacity_factor) == (8, 2, 4.0)
    assert cfg.dtype == torch.bfloat16 and cfg.sliding_window == 0
    assert cfg.head_dim == 128 and cfg.n_heads // cfg.n_kv_heads == 4
    cut = thf.mixtral_config_from_hf(ns, n_layers=16)
    assert cut.n_layers == 16 and cut.num_params() < 24e9


def _fake_model(hf_cfg, sd):
    return SimpleNamespace(config=hf_cfg, state_dict=lambda: sd)


def test_importers_refuse_what_they_cannot_map():
    o_bias = _build(transformers.LlamaForCausalLM, transformers.LlamaConfig(
        **SMALL, num_hidden_layers=1, attention_bias=True))
    with pytest.raises(NotImplementedError, match="o_proj"):
        thf.import_hf_llama(o_bias, device="cpu")
    mlp_bias = _build(transformers.LlamaForCausalLM, transformers.LlamaConfig(
        **SMALL, num_hidden_layers=1, mlp_bias=True))
    with pytest.raises(NotImplementedError, match="mlp bias"):
        thf.import_hf_llama(mlp_bias, device="cpu")
    cls, hf_cfg, _ = _mixtral(None)
    with pytest.raises(NotImplementedError, match="attn_bias"):
        thf.import_hf_mixtral(_build(cls, hf_cfg), device="cpu",
                              attn_bias=True)
    # head widths that do not tile the hidden size
    with pytest.raises(ValueError, match="non-uniform"):
        thf.import_hf_llama(_fake_model(_hf_namespace(
            hidden_size=60, num_attention_heads=8, num_key_value_heads=8),
            {}), device="cpu")
    # an explicit head_dim the hidden size does not imply: the projection
    # shapes disagree with the config
    narrow = _build(transformers.LlamaForCausalLM, transformers.LlamaConfig(
        **SMALL, num_hidden_layers=1, head_dim=8))
    with pytest.raises(ValueError, match="q_proj"):
        thf.import_hf_llama(narrow, device="cpu")


def test_name_or_path_needs_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    for importer in (thf.import_hf_llama, thf.import_hf_mixtral):
        with pytest.raises(ImportError, match="pass a model object"):
            importer("some/checkpoint", device="cpu")


def test_importers_run_on_the_card_unless_asked():
    cls, hf_cfg, _ = _llama_family("tied")
    hf = _build(cls, hf_cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            thf.import_hf_llama(hf)
    params, cfg = thf.import_hf_llama(hf, dtype=torch.float32, device="cpu")
    assert params["embed"].device.type == "cpu" and cfg.n_layers == 1
