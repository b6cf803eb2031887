"""Self-speculative decoding in the port (ray_lightning_tpu_torch/serving/
speculative.py::ngram_propose, models/generation.py::decode_step_verify and
the engine's ``speculate_k``), against the JAX package on the CPU, after
tests/test_speculative.py.

Tolerances: ``decode_step_verify`` logits within 1e-4 of JAX's and of the
port's own one-token steps fed the same tokens (tiny fp32 configs: two
layers of fp32 products summed in another order; the reference's own verify
is not bitwise against its sequential decode either), cache contents within
1e-5. Greedy token streams must be identical: the speculative engine's, the
unspeculated engine's, the JAX engine's and JAX ``generate``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models import generation as jgen
from ray_lightning_tpu.models import llama as jllama
from ray_lightning_tpu.serving import EngineConfig as JaxEngineConfig
from ray_lightning_tpu.serving import InferenceEngine as JaxInferenceEngine
from ray_lightning_tpu.serving.speculative import ngram_propose as jax_propose
from ray_lightning_tpu_torch.models import generation as tgen
from ray_lightning_tpu_torch.models import llama as tllama
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.serving import (
    EngineConfig,
    InferenceEngine,
    PagedKVPool,
)
from ray_lightning_tpu_torch.serving.speculative import ngram_propose

pytestmark = pytest.mark.serving

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------------------------------- #
# ngram_propose
# --------------------------------------------------------------------- #
PROPOSE_CASES = [  # tests/test_speculative.py's cases, then edges
    ([1, 7, 8, 9, 7, 8], 3, {}),
    ([], 4, {}), ([5], 4, {}), ([5, 5], 4, {}),
    ([1, 2, 3, 4, 5], 4, {}),
    ([9, 1, 2, 7, 7, 1, 2], 8, {}), ([3, 4, 3], 8, {}),
    ([2, 3, 4, 2, 3, 5, 2, 3], 1, {}),
    ([1, 2, 1, 2], 0, {}), ([1, 2, 1, 2], -1, {}),
    ([1, 2, 3, 1, 2, 3, 1, 2], 5, dict(max_ngram=2)),
    ([4, 4, 4, 4], 3, dict(max_ngram=1, min_ngram=1)),
    ([1, 2, 3, 9, 2, 3, 8, 1, 2, 3], 4, dict(min_ngram=3)),
]


@pytest.mark.parametrize("hist,budget,kw", PROPOSE_CASES)
def test_ngram_propose_equals_jax(hist, budget, kw):
    assert ngram_propose(hist, budget, **kw) == jax_propose(hist, budget, **kw)


def test_ngram_propose_equals_jax_on_random_histories():
    rng = np.random.default_rng(0)
    for _ in range(400):
        n = int(rng.integers(0, 40))
        vocab = int(rng.integers(2, 6))
        hist = rng.integers(0, vocab, n).tolist()
        budget = int(rng.integers(0, 6))
        max_ngram = int(rng.integers(1, 5))
        got = ngram_propose(hist, budget, max_ngram=max_ngram)
        assert got == jax_propose(hist, budget, max_ngram=max_ngram)
        assert len(got) <= max(budget, 0)


@pytest.mark.parametrize("kw", [dict(min_ngram=0),
                                dict(max_ngram=1, min_ngram=2)])
def test_ngram_propose_validation(kw):
    with pytest.raises(ValueError) as ref:
        jax_propose([1, 2], 2, **kw)
    with pytest.raises(ValueError) as port:
        ngram_propose([1, 2], 2, **kw)
    assert str(port.value) == str(ref.value)


# --------------------------------------------------------------------- #
# decode_step_verify against JAX and the port's one-token steps
# --------------------------------------------------------------------- #
def _build(variant, seed):
    if variant == "moe":
        jcfg = dataclasses.replace(jllama.LlamaConfig.tiny_moe(),
                                   dtype=jnp.float32)
    else:
        jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(),
                                   dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.key(seed), jcfg)
    tcfg = tllama.LlamaConfig.from_dict(jcfg.to_dict())
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, jcfg, params_from_jax(tree, tcfg, device="cpu"), tcfg


@pytest.fixture(scope="module")
def models():
    return {"dense": _build("dense", 0), "moe": _build("moe", 3)}


B, K, BS, MAXB = 3, 4, 4, 6
C = BS * MAXB  # 24 positions a row on both layouts


def _state(cfg, layout, seed):
    """A cache of random (k, v), positions with room for K candidates and
    random candidate tokens, as numpy arrays (the paged pool has a trash
    block 0 and a shuffled table per row)."""
    rng = np.random.default_rng(seed)
    hkv, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    pos = np.asarray([C - K - 1, 9, 3], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, K)).astype(np.int32)
    if layout == "slot":
        shape = (L, B, hkv, C, hd)
        tables = None
    else:
        n_blocks = B * MAXB + 1
        shape = (L, n_blocks, hkv, BS, hd)
        tables = (1 + rng.permutation(B * MAXB)).reshape(B, MAXB).astype(
            np.int32)
    cache = {name: rng.standard_normal(shape).astype(np.float32)
             for name in ("k", "v")}
    return cache, tokens, pos, tables


def _torch_cache(cache):
    return {k: torch.from_numpy(v.copy()) for k, v in cache.items()}


@pytest.mark.parametrize("variant", ["dense", "moe"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_verify_matches_jax(models, variant, layout):
    jparams, jcfg, tparams, tcfg = models[variant]
    cache, tokens, pos, tables = _state(tcfg, layout, seed=1)
    jtab = None if tables is None else jnp.asarray(tables)
    want, jcache = jgen.decode_step_verify(
        jparams, {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(tokens), jnp.asarray(pos), jcfg, block_tables=jtab)
    tcache = _torch_cache(cache)
    got, out_cache = tgen.decode_step_verify(
        tparams, tcache, torch.from_numpy(tokens), torch.from_numpy(pos),
        tcfg, block_tables=None if tables is None else torch.from_numpy(tables))
    assert out_cache is tcache  # updated in place
    assert got.dtype == torch.float32 and got.shape == (B, K, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=0,
                                   atol=CACHE_TOL)


@pytest.mark.parametrize("variant", ["dense", "moe"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_verify_equals_one_token_steps(models, variant, layout):
    """K one-token steps (``decode_step_ragged`` / ``decode_step_paged``)
    fed the same candidates give the verify step's logits and cache."""
    _, _, tparams, tcfg = models[variant]
    cache, tokens, pos, tables = _state(tcfg, layout, seed=2)
    vcache = _torch_cache(cache)
    ttab = None if tables is None else torch.from_numpy(tables)
    got, _ = tgen.decode_step_verify(tparams, vcache, torch.from_numpy(tokens),
                                     torch.from_numpy(pos), tcfg,
                                     block_tables=ttab)
    scache = _torch_cache(cache)
    steps = []
    for i in range(K):
        tok = torch.from_numpy(tokens[:, i].copy())
        p = torch.from_numpy(pos + i)
        if layout == "slot":
            lg, _ = tgen.decode_step_ragged(tparams, scache, tok, p, tcfg)
        else:
            lg, _ = tgen.decode_step_paged(tparams, scache, tok, p, ttab, tcfg)
        steps.append(lg)
    np.testing.assert_allclose(got.numpy(), torch.stack(steps, 1).numpy(),
                               rtol=0, atol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(vcache[name].numpy(),
                                   scache[name].numpy(), rtol=0,
                                   atol=CACHE_TOL)


def test_verify_first_position_ignores_the_proposals(models):
    """Garbage proposals leave logits[:, 0] (the correction token's) equal
    to the one-token step's: a tick that accepts nothing is the k = 0
    tick."""
    _, _, tparams, tcfg = models["dense"]
    cache, tokens, pos, _ = _state(tcfg, "slot", seed=3)
    ref, _ = tgen.decode_step_ragged(
        tparams, _torch_cache(cache), torch.from_numpy(tokens[:, 0].copy()),
        torch.from_numpy(pos), tcfg)
    garbage = tokens.copy()
    garbage[:, 1:] = 0
    got, _ = tgen.decode_step_verify(tparams, _torch_cache(cache),
                                     torch.from_numpy(garbage),
                                     torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(got[:, 0].numpy(), ref.numpy(), rtol=0,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_verify_clamps_writes_past_the_cache(models, layout):
    """A row whose candidates run past the last position writes the
    overflow to the last slot (slot layout) or through the table's end
    (paged); its real queries, which end before that slot, match JAX."""
    jparams, jcfg, tparams, tcfg = models["dense"]
    cache, tokens, _, tables = _state(tcfg, layout, seed=4)
    pos = np.asarray([C - 3, C - 2, 0], np.int32)
    jtab = None if tables is None else jnp.asarray(tables)
    want, _ = jgen.decode_step_verify(
        jparams, {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(tokens), jnp.asarray(pos), jcfg, block_tables=jtab)
    got, _ = tgen.decode_step_verify(
        tparams, _torch_cache(cache), torch.from_numpy(tokens),
        torch.from_numpy(pos), tcfg,
        block_tables=None if tables is None else torch.from_numpy(tables))
    assert bool(torch.isfinite(got).all())
    want = np.asarray(want)
    # queries at positions <= C - 2 never see slot C - 1
    for b, n_real in ((0, 2), (1, 1), (2, K)):
        np.testing.assert_allclose(got[b, :n_real].numpy(), want[b, :n_real],
                                   rtol=0, atol=LOGIT_TOL)


def test_verify_refuses_a_sliding_window(models):
    _, _, tparams, tcfg = models["dense"]
    cfg = dataclasses.replace(tcfg, sliding_window=8)
    cache = tgen.init_kv_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="sliding") as port:
        tgen.decode_step_verify(tparams, cache, torch.zeros((1, 2),
                                                            dtype=torch.int32),
                                torch.zeros((1,), dtype=torch.int32), cfg)
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32,
                               sliding_window=8)
    with pytest.raises(ValueError) as ref:
        jgen.decode_step_verify(
            None, jgen.init_kv_cache(jcfg, 1, 16), jnp.zeros((1, 2), jnp.int32),
            jnp.zeros((1,), jnp.int32), jcfg)
    assert str(port.value) == str(ref.value)


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #
def test_speculate_k_validation_matches_jax():
    for kw in (dict(speculate_k=1), dict(speculate_k=-2),
               dict(speculate_k=4, temperature=0.7)):
        with pytest.raises(ValueError) as ref:
            JaxEngineConfig(**kw).validate()
        with pytest.raises(ValueError) as port:
            EngineConfig(**kw).validate()
        assert str(port.value) == str(ref.value)
    EngineConfig(speculate_k=4).validate()
    EngineConfig(speculate_k=0, temperature=0.7).validate()
    assert EngineConfig().speculate_k == 0


def _reference(jparams, jcfg, prompt, n_new):
    out = jgen.generate(jparams, jnp.asarray([prompt], jnp.int32), jcfg,
                        max_new_tokens=n_new)
    return [int(t) for t in np.asarray(out)[0, len(prompt):]]


def _staggered(engine, prompts, n_new):
    comps = [engine.submit(prompts[0], max_new_tokens=n_new[0]),
             engine.submit(prompts[1], max_new_tokens=n_new[1])]
    for _ in range(3):
        engine.step()
    comps += [engine.submit(p, max_new_tokens=n)
              for p, n in zip(prompts[2:], n_new[2:])]
    engine.run_until_idle()
    return comps


PROMPTS = [[5, 9, 5, 9, 5, 9, 5], [3, 3, 3, 3], [7, 1, 2, 7, 1, 2],
           [11, 12, 13]]
N_NEW = [10, 8, 12, 6]


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_speculative_engine_streams_are_token_identical(models, layout):
    """Staggered requests at k = 4: the same streams as the port's k = 0
    engine, the JAX engine at k = 4 and JAX ``generate``, with the same
    acceptance accounting as the JAX engine's."""
    jparams, jcfg, tparams, tcfg = models["dense"]
    kw = dict(num_slots=2, max_len=32, max_prompt_len=8, kv_layout=layout,
              num_kv_blocks=64 if layout == "paged" else None)
    runs = {}
    for k in (0, 4):
        engine = InferenceEngine(tparams, tcfg, EngineConfig(
            speculate_k=k, block_size=16, **kw), device="cpu")
        runs[k] = (engine, [c.tokens for c in _staggered(engine, PROMPTS,
                                                         N_NEW)])
    jengine = JaxInferenceEngine(jparams, jcfg, engine_config=JaxEngineConfig(
        speculate_k=4, **kw))
    jstreams = [c.tokens for c in _staggered(jengine, PROMPTS, N_NEW)]
    want = [_reference(jparams, jcfg, p, n) for p, n in zip(PROMPTS, N_NEW)]
    assert runs[4][1] == runs[0][1] == jstreams == want
    engine = runs[4][0]
    for key in ("accepted_tokens", "spec_row_ticks", "decode_steps",
                "tokens_out"):
        assert engine.stats[key] == jengine.stats[key], key
    assert engine.stats["accepted_tokens"] > engine.stats["spec_row_ticks"]
    assert engine.stats["decode_steps"] < runs[0][0].stats["decode_steps"]
    assert not engine._history  # dropped at release
    assert runs[0][0].stats["spec_row_ticks"] == 0


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_speculative_moe_engine_is_token_identical(models, layout):
    jparams, jcfg, tparams, tcfg = models["moe"]
    streams = {}
    for k in (0, 3):
        engine = InferenceEngine(tparams, tcfg, EngineConfig(
            num_slots=2, max_len=32, max_prompt_len=8, block_size=4,
            kv_layout=layout, speculate_k=k), device="cpu")
        streams[k] = [c.tokens for c in _staggered(engine, PROMPTS, N_NEW)]
    want = [_reference(jparams, jcfg, p, n) for p, n in zip(PROMPTS, N_NEW)]
    assert streams[3] == streams[0] == want


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_eos_mid_burst_truncates(models, layout):
    """An EOS inside an accepted burst ends the request there: nothing past
    it is delivered or streamed, as on the unspeculated engine."""
    jparams, jcfg, tparams, tcfg = models["dense"]
    prompt, n_new = [5, 9, 5, 9, 5, 9, 5], 12
    base = _reference(jparams, jcfg, prompt, n_new)
    eos = base[len(base) // 2]
    want = base[: base.index(eos) + 1]
    for k in (0, 4):
        engine = InferenceEngine(tparams, tcfg, EngineConfig(
            num_slots=2, max_len=32, max_prompt_len=8, block_size=4,
            kv_layout=layout, speculate_k=k), device="cpu")
        streamed = []
        comp = engine.submit(prompt, max_new_tokens=n_new, eos_id=eos,
                             on_token=lambda rid, t: streamed.append(t))
        engine.run_until_idle()
        assert comp.tokens == streamed == want, f"k={k}"
        assert comp.finish_reason == "eos", f"k={k}"


@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("n_new", [1, 2, 5])
def test_speculation_respects_the_length_budget(models, layout, n_new):
    jparams, jcfg, tparams, tcfg = models["dense"]
    prompt = [6, 6, 6, 6, 6, 6]  # every proposal a repeat
    engine = InferenceEngine(tparams, tcfg, EngineConfig(
        num_slots=2, max_len=32, max_prompt_len=8, block_size=4,
        kv_layout=layout, speculate_k=4), device="cpu")
    comp = engine.submit(prompt, max_new_tokens=n_new)
    engine.run_until_idle()
    assert comp.tokens == _reference(jparams, jcfg, prompt, n_new)
    assert comp.finish_reason in ("length", "eos")


def test_speculation_at_the_end_of_the_position_budget(models):
    """A prompt of max_prompt_len and max_len - max_prompt_len new tokens:
    the deepest proposal reaches the last position a request may write, and
    the paged engine grows its table to it on demand."""
    jparams, jcfg, tparams, tcfg = models["dense"]
    prompt = [4, 8, 4, 8, 4, 8, 4, 8]
    n_new = 24  # positions 0 .. 31 = max_len - 1
    want = _reference(jparams, jcfg, prompt, n_new)
    for layout in ("slot", "paged"):
        engine = InferenceEngine(tparams, tcfg, EngineConfig(
            num_slots=1, max_len=32, max_prompt_len=8, block_size=4,
            kv_layout=layout, speculate_k=4), device="cpu")
        comp = engine.submit(prompt, max_new_tokens=n_new)
        engine.run_until_idle()
        assert comp.tokens == want, layout


def test_ensure_writable_grows_to_the_deepest_speculative_write(models):
    _, _, _, tcfg = models["dense"]
    pool = PagedKVPool(tcfg, 2, 32, block_size=4, device="cpu")
    slot = pool.acquire("r", prompt_len=5, max_new_tokens=20)
    slot.pos = 4
    pool.ensure_writable(slot)
    assert (pool.block_tables[slot.index] != 0).sum() == 2
    pool.ensure_writable(slot, upto_pos=slot.pos + 3)  # position 7: block 1
    assert (pool.block_tables[slot.index] != 0).sum() == 2
    pool.ensure_writable(slot, upto_pos=slot.pos + 4)  # position 8: block 2
    assert (pool.block_tables[slot.index] != 0).sum() == 3
    pool.ensure_writable(slot)  # never shrinks
    assert (pool.block_tables[slot.index] != 0).sum() == 3
