"""The port's serving slice (ray_lightning_tpu_torch/serving/) on the CPU.

The acceptance e2e: staggered requests of mixed lengths, some sharing a
system prompt, through the port's paged InferenceEngine with fewer slots
than requests — every greedy stream token-identical to the JAX package's
sequential ``generate()`` on the same weights (fp32, so no near-tie can
fall differently). The allocator cases mirror tests/test_paged_kv.py.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.generation import generate
from ray_lightning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_lightning_tpu.models.llama import init_params as jax_init_params
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
from ray_lightning_tpu_torch.serving import (
    TRASH_BLOCK,
    BlockAllocator,
    EngineClosed,
    EngineConfig,
    InferenceEngine,
    OutOfBlocks,
    PagedKVPool,
    RequestQueueFull,
    RequestShed,
    blocks_for,
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

SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6]  # two full 4-token blocks


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jax_init_params(jax.random.key(0), jcfg)
    tcfg = LlamaConfig.from_dict(jcfg.to_dict())
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, jcfg, params_from_jax(tree, tcfg, device="cpu"), tcfg


def _reference(jparams, jcfg, prompt, n_new):
    out = generate(jparams, jnp.asarray([prompt], jnp.int32), jcfg,
                   max_new_tokens=n_new, temperature=0.0)
    return [int(t) for t in np.asarray(out)[0, len(prompt):]]


def _engine(tparams, tcfg, **kw):
    base = dict(num_slots=3, max_prompt_len=12, max_len=32, block_size=4,
                kv_layout="paged")
    base.update(kw)
    return InferenceEngine(tparams, tcfg, EngineConfig(**base), device="cpu")


# --------------------------------------------------------------------- #
# the slice end to end
# --------------------------------------------------------------------- #
def test_engine_greedy_streams_match_jax_generate(model):
    jparams, jcfg, tparams, tcfg = model
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(8):
        n_prompt = int(rng.integers(2, 5))
        tail = [int(t) for t in rng.integers(10, tcfg.vocab_size, n_prompt)]
        prompt = SYSTEM + tail if i % 3 == 0 else tail
        reqs.append((prompt, int(rng.integers(4, 9))))
    engine = _engine(tparams, tcfg)
    comps = [engine.submit(p, max_new_tokens=n) for p, n in reqs[:3]]
    for _ in range(3):
        engine.step()
    comps += [engine.submit(p, max_new_tokens=n) for p, n in reqs[3:]]
    engine.run_until_idle()

    for (prompt, n_new), comp in zip(reqs, comps):
        assert comp.finish_reason == "length"
        assert comp.result(timeout=1) == _reference(jparams, jcfg, prompt, n_new)
        assert comp.ttft_s is not None and comp.ttft_s >= 0.0
    alloc = engine.pool.allocator
    assert alloc.prefix_hits_total >= 2  # the shared system prompt hit
    assert alloc.grown_total > 0  # decode crossed block boundaries
    assert alloc.used_blocks == 0  # every request released its blocks
    assert engine.pool.allocator.released_total == 8 and engine.pool.occupancy == 0
    assert engine.stats["tokens_out"] == sum(n for _, n in reqs)
    assert engine.stats["prefills"] == 8
    # CPU tensors never launch a CUDA kernel
    assert set(engine.kernel_launches().values()) == {0}


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_shared_prefix_is_bitwise_identical_to_unshared(model, prefix_cache):
    jparams, jcfg, tparams, tcfg = model
    prompts = [SYSTEM + [11, 12], SYSTEM + [21, 22, 23]]
    engine = _engine(tparams, tcfg, num_slots=2, prefix_cache=prefix_cache)
    comps = [engine.submit(p, max_new_tokens=6) for p in prompts]
    engine.run_until_idle()
    assert engine.pool.allocator.prefix_hits_total == (2 if prefix_cache else 0)
    for prompt, comp in zip(prompts, comps):
        assert comp.result(timeout=1) == _reference(jparams, jcfg, prompt, 6)


def test_threaded_loop_and_drain(model):
    _, _, tparams, tcfg = model
    engine = _engine(tparams, tcfg, num_slots=2)
    streamed = []
    engine.start()
    comps = [engine.submit([5, 6, 7], max_new_tokens=3,
                           on_token=lambda rid, t: streamed.append((rid, t)))
             for _ in range(3)]
    results = [c.result(timeout=60) for c in comps]
    engine.drain(timeout=30)
    assert engine._thread is not None and not engine._thread.is_alive()
    assert all(len(r) == 3 for r in results)
    assert len(streamed) == 9
    assert results[0] == results[1] == results[2]
    with pytest.raises(EngineClosed):
        engine.submit([1], max_new_tokens=1)


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_decode_step_counted_before_its_tokens_are_delivered(model, layout):
    """A thread that sees a token (or the completion it ends) sees the step
    that made it counted: the k-th token of a lone request arrives with
    ``decode_steps == k``, so a snapshot of ``stats`` taken once a loop
    thread's request has finished leaves none of its steps to come."""
    _, _, tparams, tcfg = model
    engine = _engine(tparams, tcfg, num_slots=1, kv_layout=layout)
    seen = []
    comp = engine.submit([5, 6, 7], max_new_tokens=4, on_token=lambda rid, t:
                         seen.append(engine.stats["decode_steps"]))
    engine.run_until_idle()
    assert comp.finish_reason == "length"
    assert seen == [1, 2, 3, 4]
    assert engine.stats["decode_steps"] == 4
    assert engine.stats["busy_slot_steps"] == 4


def test_shutdown_without_drain_fails_in_flight(model):
    _, _, tparams, tcfg = model
    engine = _engine(tparams, tcfg, num_slots=1)
    first = engine.submit([1, 2], max_new_tokens=20)
    queued = engine.submit([3, 4], max_new_tokens=2)
    engine.step()
    engine.shutdown(drain=False)
    for comp in (first, queued):
        assert comp.finish_reason == "error"
        with pytest.raises(EngineClosed):
            comp.result(timeout=1)
    assert engine.pool.occupancy == 0
    assert not any(t.name == "rlt-torch-serve-engine"
                   for t in threading.enumerate())


def test_eos_deadline_and_admission_errors(model):
    _, _, tparams, tcfg = model
    engine = _engine(tparams, tcfg, num_slots=1, max_queue=10)
    probe = engine.submit([8, 9, 10], max_new_tokens=2)
    engine.run_until_idle()
    eos = probe.tokens[0]
    comp = engine.submit([8, 9, 10], max_new_tokens=5, eos_id=eos)
    expired = engine.submit([1, 2], max_new_tokens=2, deadline_ms=0.0)
    engine.run_until_idle()
    assert comp.finish_reason == "eos" and comp.tokens == [eos]
    assert expired.finish_reason == "expired"
    with pytest.raises(ValueError):
        engine.submit(list(range(13)), max_new_tokens=1)  # > max_prompt_len
    with pytest.raises(ValueError):
        engine.submit([1] * 12, max_new_tokens=25)  # > max_len
    for _ in range(9):
        engine.submit([1], max_new_tokens=1)
    with pytest.raises(RequestShed):  # priority 1 past the 0.9 watermark
        engine.submit([1], max_new_tokens=1, priority=1)
    engine.submit([2], max_new_tokens=1)  # priority 0 is never shed
    with pytest.raises(RequestQueueFull):
        engine.submit([3], max_new_tokens=1)
    engine.run_until_idle()


@pytest.mark.parametrize("sampling", [
    dict(temperature=0.8), dict(temperature=0.8, top_k=5),
    dict(temperature=0.8, top_p=0.9),
], ids=["fused", "top_k", "top_p"])
def test_sampling_is_seeded(model, sampling):
    _, _, tparams, tcfg = model
    runs = []
    for _ in range(2):
        engine = _engine(tparams, tcfg, seed=11, **sampling)
        comp = engine.submit([4, 5, 6], max_new_tokens=6)
        engine.run_until_idle()
        runs.append(comp.tokens)
    assert runs[0] == runs[1] and len(runs[0]) == 6


@pytest.mark.parametrize("kw,err", [
    # kw0, kw2 and kw4 were refused (NotImplementedError) until the
    # disaggregated roles were ported; their ids stay, their outcome is
    # now the JAX package's
    pytest.param(dict(role="decode"), None, id="kw0-NotImplementedError"),
    pytest.param(dict(kv_layout="ragged"), ValueError, id="kw1-ValueError"),
    pytest.param(dict(kv_layout="paged", role="decode"), None,
                 id="kw2-NotImplementedError"),
    pytest.param(dict(speculate_k=1), ValueError, id="kw3-ValueError"),
    pytest.param(dict(role="prefill"), None, id="kw4-NotImplementedError"),
    pytest.param(dict(max_len=30), ValueError, id="kw5-ValueError"),
    pytest.param(dict(max_prompt_len=32), ValueError, id="kw6-ValueError"),
])
def test_unported_or_invalid_configs_refused(model, kw, err):
    """Each config gets the outcome the JAX package's
    ``EngineConfig.validate`` gives it: refused with ValueError, or an
    engine of that role."""
    from ray_lightning_tpu.serving import EngineConfig as JaxEngineConfig

    _, _, tparams, tcfg = model
    full = dict(num_slots=3, max_prompt_len=12, max_len=32, block_size=4,
                kv_layout="paged")
    full.update(kw)
    try:
        JaxEngineConfig(**full).validate()
        jax_err = None
    except ValueError:
        jax_err = ValueError
    assert jax_err is err
    if err is None:
        engine = _engine(tparams, tcfg, **kw)
        assert engine.engine_config.role == kw["role"]
        assert engine.load()["role"] == kw["role"]
    else:
        with pytest.raises(err):
            _engine(tparams, tcfg, **kw)


def test_tenancy_refused_and_device_checked(model, monkeypatch):
    """``configure_tenants`` (refused until tenancy was ported) installs
    the registry in the engine and its scheduler; the device checks stay."""
    from ray_lightning_tpu_torch.serving import TenantRegistry, TenantSpec

    _, _, tparams, tcfg = model
    engine = _engine(tparams, tcfg)
    registry = TenantRegistry([TenantSpec("gold", weight=2.0)])
    engine.configure_tenants(registry)
    assert engine._tenancy is registry and engine._tenancy_admission
    assert engine.scheduler._tenancy is registry
    comp = engine.submit([1, 2, 3], max_new_tokens=2, tenant="gold")
    assert engine.scheduler.tenant_depths() == {"gold": 1}
    engine.run_until_idle()
    assert comp.tenant == "gold" and comp.finish_reason == "length"
    assert engine.scheduler.admitted_by_tenant == {"gold": 1}
    with pytest.raises(ValueError):
        InferenceEngine(tparams, tcfg, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tparams, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVPool(tcfg, 2, 32, block_size=4)


def test_paged_pool_write_redirect_and_growth():
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    pool = PagedKVPool(cfg, num_slots=2, max_len=16, block_size=4, device="cpu")
    assert pool.cache["k"].shape == (2, 9, 2, 4, 32)
    s1 = pool.acquire("a", prompt_len=9, max_new_tokens=6, prompt_tokens=[7] * 9)
    wt1 = pool.prompt_write_table(s1.index, 3)
    assert TRASH_BLOCK not in wt1
    s2 = pool.acquire("b", prompt_len=9, max_new_tokens=6, prompt_tokens=[7] * 9)
    wt2 = pool.prompt_write_table(s2.index, 3)
    assert list(wt2[:2]) == [TRASH_BLOCK, TRASH_BLOCK]  # shared: written once
    assert wt2[2] != wt1[2]  # private write frontier
    assert list(pool.block_tables[s2.index, :2]) == list(wt1[:2])
    s2.pos = 12
    pool.ensure_writable(s2)
    assert pool.block_tables[s2.index, 3] != TRASH_BLOCK
    pool.release(s1.index)
    pool.release(s2.index)
    assert pool.allocator.used_blocks == 0


def test_init_params_is_seeded_and_shaped():
    cfg = dataclasses.replace(LlamaConfig.tiny(), attn_bias=True)
    a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert a["layers"]["wq"].shape == (2, 128, 128)
    assert a["layers"]["bk"].shape == (2, 64)
    assert a["lm_head"].dtype == torch.bfloat16
    for name in ("embed", "lm_head"):
        assert torch.equal(a[name], b[name])
    assert torch.equal(a["layers"]["w_down"], b["layers"]["w_down"])
    assert float(a["layers"]["w_up"].float().std()) == pytest.approx(
        1 / np.sqrt(128), rel=0.05)


# --------------------------------------------------------------------- #
# BlockAllocator: the host cases of tests/test_paged_kv.py
# --------------------------------------------------------------------- #
def _blocks_for_worst_case():
    assert blocks_for(1, 1, 4) == 1
    assert blocks_for(4, 1, 4) == 1
    assert blocks_for(4, 2, 4) == 2
    assert blocks_for(8, 8, 4) == 4
    assert blocks_for(3, 6, 4) == 2


def _admit_allocates_prompt_and_reserves_growth():
    a = BlockAllocator(num_blocks=9, block_size=4, prefix_cache=False)
    assert a.capacity == 8
    alloc = a.admit("r0", prompt_len=6, max_new_tokens=7)
    assert len(alloc.blocks) == 2 and alloc.reserved == 1
    assert TRASH_BLOCK not in alloc.blocks
    assert a.used_blocks == 2
    assert a.available() == 8 - 2 - 1


def _release_returns_blocks_and_reservation():
    a = BlockAllocator(num_blocks=9, block_size=4, prefix_cache=False)
    a.admit("r0", prompt_len=6, max_new_tokens=7)
    a.release("r0")
    assert a.used_blocks == 0 and a.free_blocks == 8 and a.available() == 8
    with pytest.raises(KeyError):
        a.release("r0")


def _grow_within_reservation_then_raises_past_it():
    a = BlockAllocator(num_blocks=9, block_size=4, prefix_cache=False)
    alloc = a.admit("r0", prompt_len=4, max_new_tokens=9)
    assert len(alloc.blocks) == 1 and alloc.reserved == 2
    b1 = a.grow("r0")
    b2 = a.grow("r0")
    assert alloc.blocks[-2:] == [b1, b2]
    assert len(set(alloc.blocks)) == 3
    with pytest.raises(OutOfBlocks):
        a.grow("r0")


def _out_of_blocks_backpressure_defers_not_raises():
    a = BlockAllocator(num_blocks=5, block_size=4, prefix_cache=False)
    assert a.admit("big", prompt_len=8, max_new_tokens=7) is not None
    assert a.admit("next", prompt_len=4, max_new_tokens=1) is None
    assert a.deferred_total == 1
    a.release("big")
    assert a.admit("next", prompt_len=4, max_new_tokens=1) is not None


def _reservation_counts_against_admission():
    a = BlockAllocator(num_blocks=5, block_size=4, prefix_cache=False)
    assert a.admit("r0", prompt_len=4, max_new_tokens=12) is not None
    assert a.available() == 0
    assert a.admit("r1", prompt_len=1, max_new_tokens=1) is None
    for _ in range(3):
        a.grow("r0")


def _prefix_chain_hit_and_refcount_sharing():
    a = BlockAllocator(num_blocks=17, block_size=4)
    sys_prompt = list(range(10, 22))
    a1 = a.admit("r0", 12, 5, prompt_tokens=sys_prompt)
    assert a1.shared == 0 and a1.cached == 2
    assert a.prefix_misses_total == 2
    a2 = a.admit("r1", 12, 5, prompt_tokens=sys_prompt)
    assert a2.shared == 2
    assert a2.blocks[:2] == a1.blocks[:2]
    assert a2.blocks[2] != a1.blocks[2]
    assert a.prefix_hits_total == 2
    a.release("r0")
    assert a.cached_blocks == 0
    a.release("r1")
    assert a.cached_blocks == 2


def _prefix_miss_on_different_prompt():
    a = BlockAllocator(num_blocks=17, block_size=4)
    a.admit("r0", 8, 2, prompt_tokens=[1] * 8)
    alloc = a.admit("r1", 8, 2, prompt_tokens=[2] * 8)
    assert alloc.shared == 0 and a.prefix_hits_total == 0


def _divergent_suffix_shares_only_common_prefix():
    a = BlockAllocator(num_blocks=33, block_size=4)
    common = [7, 7, 7, 7, 8, 8, 8, 8]
    a.admit("r0", 12, 5, prompt_tokens=common + [1, 1, 1, 1])
    alloc = a.admit("r1", 12, 5, prompt_tokens=common + [2, 2, 2, 2])
    assert alloc.shared == 2


def _lru_eviction_is_leaf_first_and_frees_capacity():
    a = BlockAllocator(num_blocks=5, block_size=4)
    a.admit("r0", 8, 2, prompt_tokens=[1] * 8)
    a.release("r0")
    assert a.cached_blocks == 1
    assert a.admit("r1", 8, 9, prompt_tokens=None) is not None
    a.grow("r1")
    assert a.evictions_total == 0
    a.grow("r1")
    assert a.evictions_total == 1 and a.cached_blocks == 0


def _lru_evicts_oldest_chain_first():
    a = BlockAllocator(num_blocks=7, block_size=4)
    a.admit("old", 5, 2, prompt_tokens=[1] * 5)
    a.release("old")
    a.admit("new", 5, 2, prompt_tokens=[2] * 5)
    a.release("new")
    assert a.cached_blocks == 2
    while a.free_blocks > 0:
        a._free.pop()
    evicted = a._alloc_block()
    assert a.evictions_total == 1
    a._free.append(evicted)
    survivor = a.admit("probe", 5, 2, prompt_tokens=[2] * 5)
    assert survivor is not None and survivor.shared == 1


def _chain_nodes_with_children_are_not_evicted_before_leaves():
    a = BlockAllocator(num_blocks=9, block_size=2)
    a.admit("r0", 6, 3, prompt_tokens=[1, 2, 3, 4, 5, 6])
    a.release("r0")
    assert a.cached_blocks == 2
    a._evict_lru()
    remaining = list(a._chains.values())
    assert len(remaining) == 1 and remaining[0].children == 0


def _fragmentation_interleaved_long_short_tenancies():
    a = BlockAllocator(num_blocks=13, block_size=4, prefix_cache=False)
    long1 = a.admit("L1", 8, 9, prompt_tokens=None)
    short1 = a.admit("S1", 4, 1, prompt_tokens=None)
    long2 = a.admit("L2", 8, 9, prompt_tokens=None)
    assert long1 and short1 and long2
    assert a.admit("L3", 8, 9, prompt_tokens=None) is None
    a.release("S1")
    assert a.admit("L3", 8, 5, prompt_tokens=None) is not None
    for rid in ("L1", "L2", "L3"):
        a.release(rid)
    assert a.free_blocks == 12 and a.used_blocks == 0
    assert a.admitted_total == 4 and a.released_total == 4


def _cow_private_counter_on_write_frontier_match():
    a = BlockAllocator(num_blocks=17, block_size=4)
    a.admit("r0", 8, 2, prompt_tokens=[5] * 8)
    a.release("r0")
    a.admit("r1", 12, 2, prompt_tokens=[5] * 8 + [6] * 4)
    a.release("r1")
    alloc = a.admit("r2", 8, 2, prompt_tokens=[5] * 8)
    assert alloc.shared == 1 and a.cow_private_total == 1


def _admit_validation():
    a = BlockAllocator(num_blocks=5, block_size=4)
    with pytest.raises(ValueError):
        a.admit("r", 0, 1)
    with pytest.raises(ValueError):
        a.admit("r", 1, 0)
    a.admit("r", 1, 1)
    with pytest.raises(ValueError):
        a.admit("r", 1, 1)
    with pytest.raises(ValueError):
        a.admit("q", 4, 1, prompt_tokens=[1, 2])
    with pytest.raises(ValueError):
        BlockAllocator(num_blocks=1, block_size=4)
    with pytest.raises(ValueError):
        BlockAllocator(num_blocks=4, block_size=0)


def _stats_roundtrip():
    a = BlockAllocator(num_blocks=9, block_size=4)
    a.admit("r0", 8, 3, prompt_tokens=[3] * 8)
    st = a.stats()
    assert st["blocks_used"] == 2 and st["block_size"] == 4
    assert st["admitted_total"] == 1 and st["blocks_highwater"] == 2
    a.release("r0")
    assert a.stats()["released_total"] == 1


ALLOCATOR_CASES = [
    _blocks_for_worst_case,
    _admit_allocates_prompt_and_reserves_growth,
    _release_returns_blocks_and_reservation,
    _grow_within_reservation_then_raises_past_it,
    _out_of_blocks_backpressure_defers_not_raises,
    _reservation_counts_against_admission,
    _prefix_chain_hit_and_refcount_sharing,
    _prefix_miss_on_different_prompt,
    _divergent_suffix_shares_only_common_prefix,
    _lru_eviction_is_leaf_first_and_frees_capacity,
    _lru_evicts_oldest_chain_first,
    _chain_nodes_with_children_are_not_evicted_before_leaves,
    _fragmentation_interleaved_long_short_tenancies,
    _cow_private_counter_on_write_frontier_match,
    _admit_validation,
    _stats_roundtrip,
]


@pytest.mark.parametrize("case", ALLOCATOR_CASES,
                         ids=[c.__name__.strip("_") for c in ALLOCATOR_CASES])
def test_block_allocator(case):
    case()
