"""The port's sequential generation (ray_lightning_tpu_torch/models/
generation.py: ``decode_step``, ``decode_step_ragged``, the rolling-window
cache and ``generate``) against the JAX package's, on tiny fp32 configs
built from the same numpy weights: ``tiny``, ``tiny`` with an 8-position
sliding window, and ``tiny_moe``.

Tolerances: 1e-4 on logits (two fp32 layers of matmuls summed in another
order, as tests/test_torch_model.py), 1e-5 on cache contents (one layer's
projections and rope); greedy token streams must be identical.
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
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.ops.rope import rope_angles

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
WINDOW = 8


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes run fastest on two threads; restore the process's count
    for the test files that share this worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _build(variant, seed):
    if variant == "moe":
        # capacity = 2T: training's routing never drops a token, so the
        # full forward equals lossless decode
        jcfg = dataclasses.replace(jllama.LlamaConfig.tiny_moe(),
                                   dtype=jnp.float32, capacity_factor=4.0)
    else:
        jcfg = dataclasses.replace(
            jllama.LlamaConfig.tiny(), dtype=jnp.float32,
            sliding_window=WINDOW if variant == "window" else 0)
    jparams = jllama.init_params(jax.random.key(seed), jcfg)
    tcfg = tllama.LlamaConfig.from_dict(jcfg.to_dict())
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, jcfg, params_from_jax(tree, tcfg, device="cpu"), tcfg


@pytest.fixture(scope="module")
def models():
    return {v: _build(v, seed) for v, seed in
            (("dense", 1), ("window", 2), ("moe", 3))}


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("variant", ["dense", "window", "moe"])
def test_decode_step_logits_match_forward_at_every_position(models, variant):
    """Twelve tokens stepped one at a time (the windowed cache is 8 long
    and wraps at step 8) give the full causal forward's logits at every
    position, the port's and JAX's."""
    jparams, jcfg, tparams, tcfg = models[variant]
    tokens = _tokens(0, (2, 12))
    want, _ = jllama.forward(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    full = tllama.forward(tparams, torch.from_numpy(tokens), tcfg)
    cache = tgen.init_kv_cache(tcfg, 2, 12, device="cpu")
    assert cache["k"].shape[3] == (WINDOW if variant == "window" else 12)
    for t in range(12):
        logits, cache = tgen.decode_step(tparams, cache,
                                         torch.from_numpy(tokens[:, t]), t, tcfg)
        assert logits.dtype == torch.float32
        _close(logits, full[:, t], LOGIT_TOL)
        _close(logits, want[:, t], LOGIT_TOL)


@pytest.mark.parametrize("variant", ["dense", "moe"])
def test_prefill_fills_the_stepwise_cache(models, variant):
    """One batched prefill writes the (k, v) that stepwise decode writes,
    and JAX's prefill writes the same cache."""
    jparams, jcfg, tparams, tcfg = models[variant]
    tokens = _tokens(4, (2, 7))
    batched = tgen.init_kv_cache(tcfg, 2, 7, device="cpu")
    logits_b, batched = tgen.prefill(tparams, torch.from_numpy(tokens), tcfg,
                                     batched)
    stepped = tgen.init_kv_cache(tcfg, 2, 7, device="cpu")
    for t in range(7):
        logits_s, stepped = tgen.decode_step(
            tparams, stepped, torch.from_numpy(tokens[:, t]), t, tcfg)
    jlogits, jcache = jgen.prefill(jparams, jnp.asarray(tokens, jnp.int32),
                                   jcfg, jgen.init_kv_cache(jcfg, 2, 7))
    for name in ("k", "v"):
        assert tuple(batched[name].shape) == jcache[name].shape
        _close(batched[name], stepped[name], CACHE_TOL)
        _close(batched[name], jcache[name], CACHE_TOL)
    _close(logits_b, logits_s, LOGIT_TOL)
    _close(logits_b, jlogits, LOGIT_TOL)


def test_rolling_window_cache_has_jax_shape_and_contents(models):
    """A windowed cache is min(max_len, window) long, as JAX sizes it, and a
    prompt longer than it lands at slots pos % C on both sides; the
    prefill's last logits are the full forward's."""
    jparams, jcfg, tparams, tcfg = models["window"]
    cache = tgen.init_kv_cache(tcfg, 2, 64, device="cpu")
    assert tuple(cache["k"].shape) == jgen.init_kv_cache(jcfg, 2, 64)["k"].shape
    assert cache["k"].shape[3] == WINDOW
    assert tgen.init_kv_cache(tcfg, 2, 5, device="cpu")["k"].shape[3] == 5
    tokens = _tokens(5, (2, 13))  # 13 > 8: slots 5..7 then 0..4
    logits, cache = tgen.prefill(tparams, torch.from_numpy(tokens), tcfg, cache)
    jlogits, jcache = jgen.prefill(jparams, jnp.asarray(tokens, jnp.int32),
                                   jcfg, jgen.init_kv_cache(jcfg, 2, 64))
    for name in ("k", "v"):
        _close(cache[name], jcache[name], CACHE_TOL)
    full = tllama.forward(tparams, torch.from_numpy(tokens), tcfg)
    _close(logits, full[:, -1], LOGIT_TOL)
    _close(logits, jlogits, LOGIT_TOL)
    # the slot of position 12 holds its key: the same as a cache long
    # enough to hold every position
    wide = tgen.init_kv_cache(dataclasses.replace(tcfg, sliding_window=0),
                              2, 13, device="cpu")
    tgen.prefill(tparams, torch.from_numpy(tokens), tcfg, wide)
    torch.testing.assert_close(cache["k"][:, :, :, 12 % WINDOW],
                               wide["k"][:, :, :, 12], rtol=0, atol=0)


def test_midsized_and_undersized_caches_are_refused(models):
    """A windowed cache strictly between the window and the served range
    raises in both decode steps; a cache that holds every served position
    (a rope table no longer than it) or only the window is fine. A cache
    shorter than the prompt raises in prefill unless it rolls a window;
    the paged decode refuses windows."""
    _, _, tparams, tcfg = models["window"]
    dense_cfg = dataclasses.replace(tcfg, sliding_window=0)
    token = torch.zeros(2, dtype=torch.int64)
    mid = tgen.init_kv_cache(dense_cfg, 2, 16, device="cpu")
    assert mid["k"].shape[3] == 16
    with pytest.raises(ValueError, match="between sliding_window"):
        tgen.decode_step(tparams, mid, token, 0, tcfg)
    with pytest.raises(ValueError, match="between sliding_window"):
        tgen.decode_step_ragged(tparams, mid, token, token, tcfg)
    table = rope_angles(16, tcfg.head_dim, tcfg.rope_theta, device="cpu")
    tgen.decode_step(tparams, mid, token, 0, tcfg, rope_table=table)
    tgen.decode_step_ragged(tparams, mid, token, token, tcfg, rope_table=table)
    tgen.decode_step(tparams, tgen.init_kv_cache(tcfg, 2, 64, device="cpu"),
                     token, 0, tcfg)

    prompt = torch.from_numpy(_tokens(6, (1, 10)))
    _, _, dparams, dcfg = models["dense"]
    with pytest.raises(ValueError, match="cache length 8 < prompt length 10"):
        tgen.prefill(dparams, prompt, dcfg,
                     tgen.init_kv_cache(dcfg, 1, 8, device="cpu"))
    # a windowed cache shorter than the window cannot roll a prompt
    with pytest.raises(ValueError, match="cache length 4 < prompt length 10"):
        tgen.prefill(tparams, prompt, tcfg,
                     tgen.init_kv_cache(tcfg, 1, 4, device="cpu"))
    with pytest.raises(ValueError, match="dense-causal"):
        tgen.decode_step_paged(
            tparams, {"k": mid["k"][:, :1], "v": mid["v"][:, :1]}, token,
            token, torch.zeros((2, 1), dtype=torch.int32), tcfg)


@pytest.mark.parametrize("variant", ["dense", "moe"])
def test_ragged_decode_agrees_with_prefill(models, variant):
    """Rows parked at different depths (a 6-token and a 3-token prefix, the
    shorter one re-feeding its last token at a frozen position) each give
    the last-position logits of a prefill over their own prefix, the
    port's and JAX's."""
    jparams, jcfg, tparams, tcfg = models[variant]
    lens = [6, 3]
    rows = [_tokens(7 + b, (1, n)) for b, n in enumerate(lens)]
    cache = tgen.init_kv_cache(tcfg, 2, 16, device="cpu")
    got = {}
    for t in range(max(lens)):
        tok = torch.tensor([int(rows[b][0, min(t, lens[b] - 1)])
                            for b in range(2)])
        pos = torch.tensor([min(t, lens[b] - 1) for b in range(2)],
                           dtype=torch.int32)
        logits, cache = tgen.decode_step_ragged(tparams, cache, tok, pos, tcfg)
        for b in range(2):
            if t == lens[b] - 1:
                got[b] = logits[b]
    for b, row in enumerate(rows):
        want, _ = tgen.prefill(tparams, torch.from_numpy(row), tcfg,
                               tgen.init_kv_cache(tcfg, 1, 16, device="cpu"))
        jwant, _ = jgen.prefill(jparams, jnp.asarray(row, jnp.int32), jcfg,
                                jgen.init_kv_cache(jcfg, 1, 16))
        _close(got[b], want[0], LOGIT_TOL)
        _close(got[b], np.asarray(jwant)[0], LOGIT_TOL)


@pytest.mark.parametrize("variant,P,n_new", [
    ("dense", 5, 6), ("moe", 5, 6),
    ("window", 12, 10),  # prefill scatters, decode wraps twice
])
def test_generate_greedy_streams_equal_jax(models, variant, P, n_new):
    jparams, jcfg, tparams, tcfg = models[variant]
    prompt = _tokens(10, (2, P))
    want = jgen.generate(jparams, jnp.asarray(prompt, jnp.int32), jcfg,
                         max_new_tokens=n_new)
    got = tgen.generate(tparams, torch.from_numpy(prompt), tcfg, n_new,
                        device="cpu")
    assert tuple(got.shape) == (2, P + n_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_eos_freezes_finished_rows(models, monkeypatch):
    """eos_id = the model's first greedy token on two equal rows: the whole
    tail is eos, as in JAX, and once every row has finished the decoder is
    not stepped; a row that has not finished keeps decoding."""
    jparams, jcfg, tparams, tcfg = models["dense"]
    zeros = np.zeros((2, 3), np.int64)
    eos = int(tgen.generate(tparams, torch.from_numpy(zeros), tcfg, 1,
                            device="cpu")[0, 3])
    steps = []
    real_step = tgen.decode_step
    monkeypatch.setattr(tgen, "decode_step",
                        lambda *a, **k: steps.append(1) or real_step(*a, **k))
    out = tgen.generate(tparams, torch.from_numpy(zeros), tcfg, 6,
                        eos_id=eos, device="cpu")
    assert (out[:, 3:] == eos).all() and not steps
    want = jgen.generate(jparams, jnp.asarray(zeros, jnp.int32), jcfg,
                         max_new_tokens=6, eos_id=eos)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    # one row ends at its first token, the other decodes to the end
    prompt = np.stack([zeros[0], _tokens(11, 3)])
    out = tgen.generate(tparams, torch.from_numpy(prompt), tcfg, 6,
                        eos_id=eos, device="cpu")
    assert (out[0, 3:] == eos).all() and len(steps) == 5
    want = jgen.generate(jparams, jnp.asarray(prompt, jnp.int32), jcfg,
                         max_new_tokens=6, eos_id=eos)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_generate_eos_stops_the_decoder_at_the_next_poll(models, monkeypatch):
    """Both rows are forced to emit eos from the third decode step on: the
    tail from there is eos, and the host, which reads the finished flag
    every EOS_POLL_STEPS steps, stops the decoder at the first read after
    that, and no later."""
    _, _, tparams, tcfg = models["dense"]
    prompt = torch.from_numpy(_tokens(12, (2, 3)))
    n_new = 2 * tgen.EOS_POLL_STEPS
    free = tgen.generate(tparams, prompt, tcfg, n_new, device="cpu")
    eos = next(t for t in range(tcfg.vocab_size)
               if t not in set(free[:, 3:].flatten().tolist()))
    steps = []
    real_step = tgen.decode_step

    def forced(*a, **k):
        steps.append(1)
        logits, cache = real_step(*a, **k)
        if len(steps) >= 3:
            logits[:, eos] = 1e9
        return logits, cache

    monkeypatch.setattr(tgen, "decode_step", forced)
    out = tgen.generate(tparams, prompt, tcfg, n_new, eos_id=eos,
                        device="cpu")
    assert (out[:, 3 + 3:] == eos).all()
    assert torch.equal(out[:, :3 + 3], free[:, :3 + 3])
    assert len(steps) == tgen.EOS_POLL_STEPS


def test_generate_pad_id_warns_and_max_new_tokens_is_checked(models):
    _, _, tparams, tcfg = models["dense"]
    prompt = torch.zeros((1, 3), dtype=torch.int64)
    with pytest.warns(DeprecationWarning, match="pad_id"):
        out = tgen.generate(tparams, prompt, tcfg, 2, pad_id=0, device="cpu")
    assert tuple(out.shape) == (1, 5)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tgen.generate(tparams, prompt, tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        tgen.generate(tparams, prompt, tcfg, 2, device="meta")


def _support(logits, temperature, top_k, top_p, draws=300, seed=0):
    """The set of tokens ``_sample_logits`` draws for one row of logits."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.log(torch.tensor([logits])).expand(draws, -1)
    return set(tgen._sample_logits(rows, g, temperature, top_k,
                                   top_p).tolist())


def test_sampling_filters_restrict_the_support():
    """top-k, then nucleus over the survivors (the token that crosses top_p
    is kept, so at least one always is), then the categorical; greedy
    ignores both filters."""
    probs = [0.5, 0.25, 0.15, 0.07, 0.03]
    assert _support(probs, 1.0, 2, None) == {0, 1}
    assert _support(probs, 1.0, None, 0.7) == {0, 1}
    assert _support(probs, 1.0, None, 0.1) == {0}
    assert _support(probs, 1.0, 1, None) == {0}  # top-k 1 is greedy
    assert _support([0.9, 0.06, 0.04], 1.0, None, 0.05) == {0}
    assert _support([0.5, 0.3, 0.2], 1.0, None, 0.45) == {0}
    assert _support([0.5, 0.3, 0.2], 1.0, None, 0.51) == {0, 1}
    composed = [0.35, 0.25, 0.2, 0.15, 0.05]
    assert _support(composed, 1.0, None, 0.99) == {0, 1, 2, 3, 4}
    assert _support(composed, 1.0, 2, 0.99) == {0, 1}
    assert _support(composed, 1.0, 3, 0.5) == {0, 1}
    rows = torch.log(torch.tensor([[0.1, 0.2, 0.6, 0.1],
                                   [0.7, 0.1, 0.1, 0.1]]))
    for top_k, top_p in ((1, 0.01), (None, 1e-6), (4, None), (2, 0.3)):
        out = tgen._sample_logits(rows, torch.Generator(), 0.0, top_k, top_p)
        assert out.tolist() == [2, 0]


def test_generate_sampling_is_seeded_by_the_generator(models):
    """Temperature streams repeat under the same generator seed (they differ
    from JAX's by design: the noise comes from torch); top-k 1 is greedy."""
    _, _, tparams, tcfg = models["dense"]
    prompt = torch.from_numpy(_tokens(12, (2, 4)))

    def run(seed, **kw):
        return tgen.generate(tparams, prompt, tcfg, 8, temperature=1.0,
                             generator=torch.Generator().manual_seed(seed),
                             device="cpu", **kw)

    a, b = run(3, top_p=0.9), run(3, top_p=0.9)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size
    assert not torch.equal(run(3), run(4))
    greedy = tgen.generate(tparams, prompt, tcfg, 8, device="cpu")
    torch.testing.assert_close(run(5, top_k=1), greedy, rtol=0, atol=0)


def test_module_generate(models):
    _, _, tparams, tcfg = models["dense"]
    module = tllama.LlamaModule(tcfg)
    prompt = torch.from_numpy(_tokens(13, (1, 4)))
    with pytest.raises(ValueError, match="trained params"):
        module.generate(prompt, 2, device="cpu")
    module.params = tparams
    torch.testing.assert_close(
        module.generate(prompt, 5, device="cpu"),
        tgen.generate(tparams, prompt, tcfg, 5, device="cpu"), rtol=0, atol=0)
