"""yarn and longrope rope scaling in the port (ray_lightning_tpu_torch/ops/
rope.py), their mapping in ``config_from_hf``, the Phi-3 importer and the
longrope default-table refusal of generation, against the JAX package and
``transformers``.

Tolerances: the scaled frequencies are computed in numpy float32, one
rounding per operation, and equal the JAX package's bitwise. The cos/sin
tables agree within 1e-6: XLA's and torch's fp32 ``cos``/``sin`` differ by
up to an ulp on the same angles (neither is correctly rounded), which the
magnitude correction (<= 1.42 here) scales to at most ~1.7e-7. Logits of
imported tiny fp32 models agree with ``transformers`` and the JAX import to
1e-4 (longrope: 1e-3, as tests/test_llama.py holds the JAX import); greedy
streams are identical.
"""
import dataclasses
import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models import generation as jgen
from ray_lightning_tpu.models import hf_import as jhf
from ray_lightning_tpu.models import llama as jllama
from ray_lightning_tpu_torch.models import generation as tgen
from ray_lightning_tpu_torch.models import hf_import as thf
from ray_lightning_tpu_torch.models import llama as tllama
from ray_lightning_tpu_torch.models.convert import params_to_numpy
from ray_lightning_tpu_torch.ops import rope as trope

jrope = importlib.import_module("ray_lightning_tpu.ops.rope")

TABLE_TOL = 1e-6
LOGIT_TOL = 1e-4
LONGROPE_LOGIT_TOL = 1e-3

YARN = {"rope_type": "yarn", "factor": 4.0,
        "original_max_position_embeddings": 32}
YARN_QWEN = {"type": "yarn", "factor": 4.0,
             "original_max_position_embeddings": 32768}
YARN_MSCALE = {"rope_type": "yarn", "factor": 8.0,
               "original_max_position_embeddings": 4096, "mscale": 1.0,
               "mscale_all_dim": 0.5, "beta_fast": 16, "beta_slow": 2}
YARN_ATTN = {"rope_type": "yarn", "factor": 2.0, "attention_factor": 1.3,
             "original_max_position_embeddings": 64, "truncate": False}


def _longrope(half, orig=32, factor=4.0):
    return {"type": "longrope", "factor": factor,
            "original_max_position_embeddings": orig,
            "long_factor": [2.0 + 0.25 * i for i in range(half)],
            "short_factor": [1.0 + 0.05 * i for i in range(half)]}


# (scaling, head_dim, theta, seq_len, offset)
TABLES = {
    "yarn": (YARN, 16, 10000.0, 48, 0),
    "yarn_qwen2.5_7b": (YARN_QWEN, 128, 1e6, 300, 0),
    "yarn_mscale_hd96": (YARN_MSCALE, 96, 1e4, 200, 7),
    "yarn_attention_factor": (YARN_ATTN, 64, 5e5, 100, 0),
    "longrope_short": (_longrope(8), 16, 10000.0, 16, 0),
    "longrope_long": (_longrope(8), 16, 10000.0, 48, 0),
    "longrope_long_by_offset": (_longrope(8), 16, 10000.0, 16, 20),
    "longrope_phi3_hd96": (_longrope(48, orig=4096, factor=32.0), 96,
                           10000.0, 4608, 0),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("case", sorted(TABLES))
def test_tables_match_jax(case):
    scaling, hd, theta, seq, offset = TABLES[case]
    jc, js = jrope.rope_angles(seq, hd, theta, offset=offset, scaling=scaling)
    tc, ts = trope.rope_angles(seq, hd, theta, offset=offset,
                               scaling=scaling, device="cpu")
    assert tc.dtype == ts.dtype == torch.float32
    assert tuple(tc.shape) == (seq, hd // 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=TABLE_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=TABLE_TOL)


@pytest.mark.parametrize("case", sorted(TABLES))
def test_scaled_frequencies_are_bitwise_jax(case):
    """The part of the table the port computes itself (the frequencies and
    the magnitude correction) is bitwise JAX's."""
    scaling, hd, theta, seq, offset = TABLES[case]
    d = trope.normalize_rope_scaling(scaling)
    jbase = theta ** (jnp.arange(0, hd, 2, dtype=jnp.float32) / hd)
    exponent = np.arange(0, hd, 2, dtype=np.float32) / np.float32(hd)
    tbase = torch.from_numpy(
        (np.float64(theta) ** exponent.astype(np.float64)).astype(np.float32))
    assert np.array_equal(tbase.numpy(), np.asarray(jbase))
    if d.get("rope_type", d.get("type")) == "yarn":
        jinv, jaf = jrope._yarn_scale(1.0 / jbase, d, hd, theta)
        tinv, taf = trope._yarn_scale(1.0 / tbase, d, hd, theta)
    else:
        jinv, jaf = jrope._longrope_scale(d, hd, theta, offset + seq)
        tinv, taf = trope._longrope_scale(tbase, d, hd, offset + seq)
    assert np.array_equal(tinv.numpy(), np.asarray(jinv))
    assert taf == jaf


@pytest.mark.parametrize("hd,theta", [(128, 5e5), (128, 1e6), (96, 1e4),
                                      (64, 1e4)])
def test_default_frequencies_are_bitwise_jax(hd, theta):
    """theta ** (2i / hd) is rounded once, as XLA's pow, at the head dims
    and thetas of Llama-3, Qwen2.5 and Phi-3."""
    jc, js = jrope.rope_angles(1, hd, theta, offset=1)
    tc, ts = trope.rope_angles(1, hd, theta, offset=1, device="cpu")
    # at position 1 the angle is the frequency itself
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=TABLE_TOL)
    jinv = 1.0 / (theta ** (jnp.arange(0, hd, 2, dtype=jnp.float32) / hd))
    exponent = np.arange(0, hd, 2, dtype=np.float32) / np.float32(hd)
    tinv = np.float32(1.0) / (np.float64(theta) ** exponent.astype(
        np.float64)).astype(np.float32)
    assert np.array_equal(tinv, np.asarray(jinv))


REFUSED_SCALING = {
    "yarn_no_original": {"rope_type": "yarn", "factor": 4.0},
    "longrope_no_original": {"type": "longrope", "factor": 4.0,
                             "long_factor": [1.0] * 8,
                             "short_factor": [1.0] * 8},
    "longrope_no_lists": {"type": "longrope", "factor": 4.0,
                          "original_max_position_embeddings": 32},
    "longrope_no_factor": {"type": "longrope",
                           "original_max_position_embeddings": 32,
                           "long_factor": [1.0] * 8,
                           "short_factor": [1.0] * 8},
    "unknown_kind": {"rope_type": "dynamic", "factor": 2.0},
}


@pytest.mark.parametrize("case", sorted(REFUSED_SCALING))
def test_refusals_match_jax(case):
    scaling = REFUSED_SCALING[case]
    with pytest.raises((ValueError, NotImplementedError)) as ref:
        jrope.normalize_rope_scaling(scaling)
    with pytest.raises(ref.type) as port:
        trope.normalize_rope_scaling(scaling)
    assert str(port.value) == str(ref.value)


def test_longrope_factor_list_length_is_checked():
    scaling = _longrope(4)  # head dim 16 needs 8 entries
    with pytest.raises(ValueError, match="head_dim/2 = 8") as ref:
        jrope.rope_angles(8, 16, scaling=scaling)
    with pytest.raises(ValueError) as port:
        trope.rope_angles(8, 16, scaling=scaling, device="cpu")
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("scaling,kind", [
    (None, None), ({"rope_type": "default"}, None), (YARN, "yarn"),
    (_longrope(8), "longrope"), (tuple(sorted(YARN.items())), "yarn"),
])
def test_rope_scaling_kind(scaling, kind):
    assert trope.rope_scaling_kind(scaling) == kind
    assert jrope.rope_scaling_kind(scaling) == kind


# --------------------------------------------------------------------- #
# config_from_hf: yarn's and longrope's pretrain length and factor
# --------------------------------------------------------------------- #
BASE_HF = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=128,
               rms_norm_eps=1e-6, rope_theta=10000.0)

HF_SCALINGS = {
    "yarn_with_original": dict(rope_scaling=dict(YARN)),
    "yarn_without_original": dict(rope_scaling={"rope_type": "yarn",
                                                "factor": 4.0}),
    "longrope_config_original": dict(
        rope_scaling={k: v for k, v in _longrope(8).items()
                      if k not in ("factor", "original_max_position_embeddings")},
        original_max_position_embeddings=32),
    "longrope_dict_only": dict(
        rope_scaling={k: v for k, v in _longrope(8).items()
                      if k != "original_max_position_embeddings"}),
}


@pytest.mark.parametrize("case", sorted(HF_SCALINGS))
def test_config_from_hf_maps_yarn_and_longrope_as_jax(case):
    hf_cfg = SimpleNamespace(**dict(BASE_HF, **HF_SCALINGS[case]))
    cfg = thf.config_from_hf(hf_cfg, dtype=torch.float32)
    jcfg = jhf.config_from_hf(hf_cfg, dtype=jnp.float32)
    assert cfg == tllama.LlamaConfig.from_dict(jcfg.to_dict())
    d = dict(cfg.rope_scaling)
    if case == "yarn_without_original":
        assert d["original_max_position_embeddings"] == 128
    if case == "longrope_config_original":
        assert d["original_max_position_embeddings"] == 32
        assert d["factor"] == 4.0
    if case == "longrope_dict_only":
        assert d["original_max_position_embeddings"] == 128


def test_qwen25_7b_published_config_maps_with_yarn():
    """Qwen2.5-7B-Instruct's config.json with the yarn scaling its model
    card documents for long inputs: 28 query / 4 KV heads (GQA group 7),
    qkv bias from the weights, no window."""
    hf_cfg = SimpleNamespace(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
        max_position_embeddings=32768, rms_norm_eps=1e-6, rope_theta=1e6,
        sliding_window=131072, use_sliding_window=False, max_window_layers=28,
        tie_word_embeddings=False,
        rope_scaling={"type": "yarn", "factor": 4.0,
                      "original_max_position_embeddings": 32768})
    cfg = thf.config_from_hf(hf_cfg, attn_bias=True)
    jcfg = jhf.config_from_hf(hf_cfg, attn_bias=True)
    assert cfg == tllama.LlamaConfig.from_dict(jcfg.to_dict())
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
            cfg.sliding_window) == (7, 128, 0)
    assert trope.rope_scaling_kind(cfg.rope_scaling) == "yarn"


# --------------------------------------------------------------------- #
# imports against transformers and the JAX importer
# --------------------------------------------------------------------- #
transformers = pytest.importorskip("transformers")


def _randomise_norms(hf):
    torch.manual_seed(1)
    with torch.no_grad():
        for layer in hf.model.layers:
            layer.input_layernorm.weight.normal_(1.0, 0.1)
            layer.post_attention_layernorm.weight.normal_(1.0, 0.1)
    return hf


def _same_leaves(params, jparams):
    got = params_to_numpy(params)
    want = jax.tree_util.tree_map(np.asarray, jparams)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        assert flat_g[path].shape == w.shape, path
        np.testing.assert_array_equal(flat_g[path], w, err_msg=str(path))


def _phi3():
    hf_cfg = transformers.Phi3Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, original_max_position_embeddings=32,
        rope_theta=10000.0, pad_token_id=0, bos_token_id=1, eos_token_id=2,
        tie_word_embeddings=False, attention_dropout=0.0, resid_pdrop=0.0,
        embd_pdrop=0.0,
        rope_scaling={k: v for k, v in _longrope(8).items()
                      if k in ("type", "long_factor", "short_factor")})
    # tests/test_llama.py's model, norms left at one: with random norms
    # this seed puts a 0.003 near-tie at one step, where HF's cached
    # generate departs from its own full forward (the port and JAX follow
    # the forward)
    torch.manual_seed(0)
    return transformers.Phi3ForCausalLM(hf_cfg).eval()


@pytest.fixture(scope="module")
def phi3():
    hf = _phi3()
    params, cfg = thf.import_hf_phi3(hf, dtype=torch.float32, device="cpu")
    jparams, jcfg = jhf.import_hf_phi3(hf, dtype=jnp.float32)
    return hf, params, cfg, jparams, jcfg


def test_import_hf_phi3_splits_the_fused_projections(phi3):
    hf, params, cfg, jparams, jcfg = phi3
    assert cfg == tllama.LlamaConfig.from_dict(jcfg.to_dict())
    assert trope.rope_scaling_kind(cfg.rope_scaling) == "longrope"
    assert dict(cfg.rope_scaling)["factor"] == 4.0
    assert tuple(params["layers"]["wq"].shape) == (2, 64, 64)
    assert tuple(params["layers"]["wk"].shape) == (2, 64, 32)
    assert tuple(params["layers"]["w_gate"].shape) == (2, 64, 128)
    _same_leaves(params, jparams)
    sd = hf.state_dict()
    qkv = sd["model.layers.1.self_attn.qkv_proj.weight"]
    assert torch.equal(params["layers"]["wv"][1], qkv[96:].t())
    gate_up = sd["model.layers.0.mlp.gate_up_proj.weight"]
    assert torch.equal(params["layers"]["w_up"][0], gate_up[128:].t())


@pytest.mark.parametrize("seq", [16, 48], ids=["short_factors",
                                               "long_factors"])
def test_import_hf_phi3_logit_parity(phi3, seq):
    """Within the pretrain context (short factors) and beyond it (long
    factors)."""
    hf, params, cfg, jparams, jcfg = phi3
    tokens = np.random.default_rng(seq).integers(0, 128, (2, seq))
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
        ours = tllama.forward(params, torch.from_numpy(tokens), cfg).numpy()
    jours, _ = jllama.forward(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=LONGROPE_LOGIT_TOL)
    np.testing.assert_allclose(ours, np.asarray(jours), rtol=0,
                               atol=LOGIT_TOL)


def test_imported_phi3_generates_hf_and_jax_greedy_tokens(phi3):
    hf, params, cfg, jparams, jcfg = phi3
    prompt = np.random.default_rng(7).integers(0, 128, (2, 8))
    ours = tgen.generate(params, torch.from_numpy(prompt), cfg, 6,
                         device="cpu").numpy()
    jours = np.asarray(jgen.generate(jparams, jnp.asarray(prompt, jnp.int32),
                                     jcfg, max_new_tokens=6))
    with torch.no_grad():
        ref = hf.generate(torch.from_numpy(prompt), max_new_tokens=6,
                          do_sample=False).numpy()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, jours)


def test_yarn_llama_import_logit_parity():
    hf_cfg = transformers.LlamaConfig(**dict(BASE_HF, num_hidden_layers=1),
                                      tie_word_embeddings=False,
                                      attention_dropout=0.0,
                                      rope_scaling=dict(YARN))
    torch.manual_seed(3)
    hf = _randomise_norms(transformers.LlamaForCausalLM(hf_cfg).eval())
    params, cfg = thf.import_hf_llama(hf, dtype=torch.float32, device="cpu")
    jparams, jcfg = jhf.import_hf_llama(hf, dtype=jnp.float32)
    assert cfg == tllama.LlamaConfig.from_dict(jcfg.to_dict())
    _same_leaves(params, jparams)
    tokens = np.random.default_rng(4).integers(0, 128, (2, 48))
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
        ours = tllama.forward(params, torch.from_numpy(tokens), cfg).numpy()
    jours, _ = jllama.forward(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(ours, np.asarray(jours), rtol=0,
                               atol=LOGIT_TOL)


def test_yarn_qwen2_serves_hf_greedy_tokens():
    """A yarn Qwen2 (qkv bias, GQA group 2) through the paged engine."""
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

    hf_cfg = transformers.Qwen2Config(**dict(BASE_HF, num_hidden_layers=2),
                                      tie_word_embeddings=False,
                                      rope_scaling=dict(YARN))
    torch.manual_seed(5)
    hf = _randomise_norms(transformers.Qwen2ForCausalLM(hf_cfg).eval())
    with torch.no_grad():
        for layer in hf.model.layers:
            layer.self_attn.q_proj.bias.normal_(0, 0.5)
            layer.self_attn.k_proj.bias.normal_(0, 0.5)
    params, cfg = thf.import_hf_llama(hf, dtype=torch.float32, device="cpu")
    assert cfg.attn_bias
    prompts = np.random.default_rng(6).integers(0, 128, (3, 7))
    engine = InferenceEngine(params, cfg, EngineConfig(
        num_slots=2, max_prompt_len=8, max_len=32, block_size=4,
        kv_layout="paged"), device="cpu")
    comps = [engine.submit(p.tolist(), max_new_tokens=6) for p in prompts]
    engine.run_until_idle()
    with torch.no_grad():
        ref = hf.generate(torch.from_numpy(prompts), max_new_tokens=6,
                          do_sample=False, pad_token_id=0).numpy()
    assert [c.tokens for c in comps] == [r[7:].tolist() for r in ref]


# --------------------------------------------------------------------- #
# the longrope default-table refusal
# --------------------------------------------------------------------- #
def _longrope_tiny():
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32,
                              rope_scaling=_longrope(16, orig=16))
    return tllama.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu"), cfg


def test_longrope_steps_without_a_table_are_refused():
    params, cfg = _longrope_tiny()
    assert cfg.head_dim == 32
    tok = torch.tensor([3, 4])
    pos = torch.tensor([2, 3])
    cache = tgen.init_kv_cache(cfg, 2, 16, device="cpu")
    calls = {
        "prefill": lambda: tgen.prefill(params, torch.tensor([[1, 2, 3]] * 2),
                                        cfg, cache),
        "decode_step": lambda: tgen.decode_step(params, cache, tok, 2, cfg),
        "decode_step_ragged": lambda: tgen.decode_step_ragged(
            params, cache, tok, pos, cfg),
        "decode_step_verify": lambda: tgen.decode_step_verify(
            params, cache, torch.tensor([[3, 4], [5, 6]]), pos, cfg),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="longrope configs need an "
                                             "explicit rope_table"):
            call()
    # the JAX package refuses the same way
    jcfg = jllama.LlamaConfig.from_dict(
        dict(cfg.to_dict(), dtype="float32"))
    with pytest.raises(ValueError, match="explicit rope_table"):
        jgen._default_table_or_raise(jcfg, 16)
    # with a table, stepping runs
    table = trope.rope_angles(16, cfg.head_dim, cfg.rope_theta,
                              scaling=cfg.rope_scaling, device="cpu")
    logits, _ = tgen.decode_step_ragged(params, cache, tok, pos, cfg, table)
    assert logits.shape == (2, cfg.vocab_size)


def test_longrope_generate_builds_one_table_and_matches_jax():
    """``generate`` builds one table for prompt + new tokens (past the
    16-position pretrain context: long factors throughout) and passes it to
    prefill and every decode step: greedy streams equal JAX's."""
    params, cfg = _longrope_tiny()
    jcfg = jllama.LlamaConfig.from_dict(dict(cfg.to_dict(), dtype="float32"))
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(params))
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12))
    ours = tgen.generate(params, torch.from_numpy(prompt), cfg, 10,
                         device="cpu").numpy()
    jours = np.asarray(jgen.generate(jparams, jnp.asarray(prompt, jnp.int32),
                                     jcfg, max_new_tokens=10))
    np.testing.assert_array_equal(ours, jours)
