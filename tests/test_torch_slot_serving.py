"""The port's slot KV layout (ray_lightning_tpu_torch/serving/kv_pool.py::
KVSlotPool and the engine's slot branch, stepping ``decode_step_ragged``)
on the CPU, mirroring tests/test_serving.py.

The acceptance e2e: 8 staggered requests of mixed lengths through a 2-slot
pool, every greedy stream token-identical to the JAX package's sequential
``generate()`` on the same weights (fp32), to the port's paged engine and
to the port's ``generate``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.generation import generate as jax_generate
from ray_lightning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_lightning_tpu.models.llama import init_params as jax_init_params
from ray_lightning_tpu_torch.models import generation as tgen
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.llama import LlamaConfig
from ray_lightning_tpu_torch.serving import (
    EngineConfig,
    InferenceEngine,
    KVSlotPool,
    PagedKVPool,
)

pytestmark = pytest.mark.serving


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes run fastest on two threads; restore the process's count
    for the test files that share this worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jax_init_params(jax.random.key(0), jcfg)
    tcfg = LlamaConfig.from_dict(jcfg.to_dict())
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, jcfg, params_from_jax(tree, tcfg, device="cpu"), tcfg


def _reference(jparams, jcfg, prompt, n_new):
    out = jax_generate(jparams, jnp.asarray([prompt], jnp.int32), jcfg,
                       max_new_tokens=n_new, temperature=0.0)
    return [int(t) for t in np.asarray(out)[0, len(prompt):]]


@pytest.fixture(scope="module")
def staggered(model):
    """tests/test_serving.py's 8 requests and their JAX greedy streams."""
    jparams, jcfg, _, tcfg = model
    rng = np.random.default_rng(0)
    reqs = [([int(t) for t in rng.integers(1, tcfg.vocab_size,
                                           rng.integers(3, 8))],
             int(rng.integers(4, 9))) for _ in range(8)]
    return reqs, [_reference(jparams, jcfg, p, n) for p, n in reqs]


def _serve(engine, reqs):
    """3 requests land before serving starts, the rest mid-decode."""
    comps = [engine.submit(p, max_new_tokens=n) for p, n in reqs[:3]]
    for _ in range(4):
        engine.step()
    comps += [engine.submit(p, max_new_tokens=n) for p, n in reqs[3:]]
    engine.run_until_idle()
    return comps


def _slot_engine(tparams, tcfg, **kw):
    base = dict(num_slots=2, max_prompt_len=8, max_len=32)
    base.update(kw)
    return InferenceEngine(tparams, tcfg, EngineConfig(**base), device="cpu")


# --------------------------------------------------------------------- #
# KV slot pool
# --------------------------------------------------------------------- #
def test_pool_acquire_release_cycle_and_stats(model):
    _, _, _, tcfg = model
    pool = KVSlotPool(tcfg, num_slots=2, max_len=16, device="cpu")
    assert tuple(pool.cache["k"].shape) == (
        tcfg.n_layers, 2, tcfg.n_kv_heads, 16, tcfg.head_dim)
    a = pool.acquire("a", prompt_len=3, max_new_tokens=4)
    b = pool.acquire("b", prompt_len=5, max_new_tokens=2)
    assert a.index != b.index and pool.occupancy == 2
    assert pool.acquire("c", 2, 2) is None  # full -> None, not an error
    assert [s.request_id for s in pool.active_slots()] == ["a", "b"]
    assert pool.utilization() == 1.0

    pool.release(a.index)
    assert pool.free_count == 1 and not a.occupied
    c = pool.acquire("c", 2, 2)
    assert c.index == a.index  # recycled row
    assert pool.admitted_total == 3 and pool.recycled_total == 1
    assert pool.tenancies[c.index] == ["a", "c"]
    assert pool.highwater == 2
    assert pool.stats() == {
        "layout": "slot", "num_slots": 2, "max_len": 16, "occupancy": 2,
        "highwater": 2, "admitted_total": 3, "recycled_total": 1,
        "tenants_per_slot": {c.index: 2, b.index: 1},
    }

    pool.release(c.index)
    with pytest.raises(ValueError, match="already free"):
        pool.release(c.index)


def test_pool_validates_lengths_and_refuses_windows(model):
    _, _, tparams, tcfg = model
    pool = KVSlotPool(tcfg, num_slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="max_len=8"):
        pool.acquire("a", prompt_len=6, max_new_tokens=3)
    with pytest.raises(ValueError, match="prompt_len"):
        pool.acquire("a", prompt_len=0, max_new_tokens=3)
    windowed = dataclasses.replace(tcfg, sliding_window=8)
    with pytest.raises(ValueError, match="sliding"):
        KVSlotPool(windowed, num_slots=2, max_len=16, device="cpu")
    # neither engine layout serves a window: generate is the windowed path
    with pytest.raises(ValueError, match="sliding"):
        _slot_engine(tparams, windowed)
    with pytest.raises(ValueError, match="dense-causal"):
        PagedKVPool(windowed, 2, 16, block_size=4, device="cpu")


# --------------------------------------------------------------------- #
# the slot engine
# --------------------------------------------------------------------- #
def test_slot_is_the_default_layout(model):
    _, _, tparams, tcfg = model
    assert EngineConfig().kv_layout == "slot"
    engine = InferenceEngine(tparams, tcfg, EngineConfig(
        num_slots=2, max_prompt_len=8, max_len=30), device="cpu")
    # no block_size constraint on the slot layout (30 % 16 != 0)
    assert isinstance(engine.pool, KVSlotPool)
    assert tuple(engine.pool.cache["k"].shape)[1::2] == (2, 30)


def test_slot_engine_greedy_streams_match_jax_generate(model, staggered):
    """The staggered e2e through a 2-slot pool: every completion equals
    sequential JAX generate(); every slot served several tenants; the CPU
    run launches no CUDA kernel."""
    _, _, tparams, tcfg = model
    reqs, want = staggered
    engine = _slot_engine(tparams, tcfg)
    comps = _serve(engine, reqs)
    for comp, ref in zip(comps, want):
        assert comp.finish_reason == "length"
        assert comp.result(timeout=1) == ref
        assert comp.ttft_s is not None and comp.ttft_s >= 0.0
    pool = engine.pool
    assert pool.recycled_total == 8 and pool.occupancy == 0
    assert all(len(v) > 1 for v in pool.tenancies.values())
    assert engine.stats["prefills"] == 8
    assert engine.stats["tokens_out"] == sum(n for _, n in reqs)
    assert set(engine.kernel_launches().values()) == {0}


def test_slot_engine_equals_paged_engine_and_port_generate(model, staggered):
    """The same staggered requests on the paged layout (blocks of 4, so
    decode grows tables) and through the port's own generate: identical
    streams on all three paths."""
    _, _, tparams, tcfg = model
    reqs, _ = staggered
    slot = [c.tokens for c in _serve(_slot_engine(tparams, tcfg), reqs)]
    paged_engine = _slot_engine(tparams, tcfg, kv_layout="paged", block_size=4)
    paged = [c.tokens for c in _serve(paged_engine, reqs)]
    assert paged_engine.pool.allocator.grown_total > 0
    own = [tgen.generate(tparams, torch.tensor([p]), tcfg, n,
                         device="cpu")[0, len(p):].tolist() for p, n in reqs]
    assert slot == paged == own


def test_slot_engine_eos_recycles_slot_early(model):
    """A request whose first greedy token is its eos finishes 'eos' after
    one token, and its slot goes to the next tenant."""
    jparams, jcfg, tparams, tcfg = model
    prompt = [5, 6, 7]
    first = _reference(jparams, jcfg, prompt, 1)[0]
    engine = _slot_engine(tparams, tcfg, num_slots=1)
    c1 = engine.submit(prompt, max_new_tokens=8, eos_id=first)
    c2 = engine.submit(prompt, max_new_tokens=2, eos_id=None)
    engine.run_until_idle()
    assert c1.finish_reason == "eos" and c1.result(timeout=1) == [first]
    assert c2.finish_reason == "length" and len(c2.result(timeout=1)) == 2
    assert engine.pool.tenancies[0] == [c1.request_id, c2.request_id]


@pytest.mark.parametrize("sampling", [
    dict(temperature=0.8),
    dict(temperature=0.8, top_k=5),
], ids=["fused", "top_k"])
def test_slot_engine_sampling_is_seeded(model, sampling):
    _, _, tparams, tcfg = model
    runs = []
    for _ in range(2):
        engine = _slot_engine(tparams, tcfg, seed=11, **sampling)
        comp = engine.submit([4, 5, 6], max_new_tokens=6)
        engine.run_until_idle()
        runs.append(comp.tokens)
    assert runs[0] == runs[1] and len(runs[0]) == 6


def test_new_entry_points_need_a_device_without_cuda(model, monkeypatch):
    """generate, KVSlotPool and a slot engine run on the card unless given
    a device: with no CUDA device they raise."""
    _, _, tparams, tcfg = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.generate(tparams, torch.zeros((1, 3), dtype=torch.int64), tcfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVSlotPool(tcfg, num_slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tparams, tcfg, EngineConfig(kv_layout="slot"))
