"""KV migration between a prefill and a decode engine in the port
(ray_lightning_tpu_torch/serving/migration.py, the engine's export and
import, the allocator's shipment pins), held against the JAX package:
the same fingerprint, the same checksums for the same bits, shipments that
cross between the packages in both directions, and streams token-identical
to JAX's ``generate`` on the same weights (fp32)."""
import dataclasses
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from ray_lightning_tpu.serving import migration as jax_migration
from ray_lightning_tpu.serving import paged_kv as jax_paged_kv
from ray_lightning_tpu_torch.serving import migration as port_migration
from ray_lightning_tpu_torch.serving import paged_kv as port_paged_kv
from ray_lightning_tpu_torch.serving import (
    MigrationRejected,
    ShipmentCorrupt,
    ShipmentMismatch,
)
from torch_serving_helpers import (
    jax_engine,
    port_engine,
    reference,
    tiny_models,
    two_threads,
)

pytestmark = pytest.mark.serving


@pytest.fixture(scope="module")
def model():
    prev = two_threads()
    yield tiny_models()
    torch.set_num_threads(prev)


def _blocks(n, seed=0, shape=(2, 2, 4, 3), dtype=np.float32):
    rng = np.random.default_rng(seed)
    ks = tuple(rng.standard_normal(shape).astype(dtype) for _ in range(n))
    vs = tuple(rng.standard_normal(shape).astype(dtype) for _ in range(n))
    return ks, vs


# --------------------------------------------------------------------- #
# the shipment format, byte for byte the JAX package's
# --------------------------------------------------------------------- #
def test_shipment_checksums_and_digest_equal_jax():
    ks, vs = _blocks(3)
    args = ("r0", (5, 6, 7, 8, 9), "f" * 16, 4, ks, vs)
    port, jax = port_migration.build_shipment(*args), \
        jax_migration.build_shipment(*args)
    assert port.block_shas == jax.block_shas and port.digest == jax.digest
    assert port_migration.verify_shipment(port, "f" * 16) == port.nbytes()
    # each side verifies the other's shipment
    assert port_migration.verify_shipment(jax, "f" * 16) == jax.nbytes()
    assert jax_migration.verify_shipment(port, "f" * 16) == port.nbytes()


def test_bf16_words_checksum_as_jax_bf16():
    """A bf16 payload travels as its raw 16-bit words: the sha of the
    port's uint16 view equals the sha of JAX's bf16 array of the same
    bits, and the digests agree."""
    rng = np.random.default_rng(3)
    vals = [rng.standard_normal((2, 2, 4, 3)).astype(ml_dtypes.bfloat16)
            for _ in range(4)]
    words = [v.view(np.uint16) for v in vals]
    for j in range(2):
        assert port_migration._block_sha(words[j], words[j + 2]) == \
            jax_migration._block_sha(vals[j], vals[j + 2])
    p = port_migration.build_shipment("r", (1, 2), "a" * 16, 4,
                                      tuple(words[:2]), tuple(words[2:]))
    j = jax_migration.build_shipment("r", (1, 2), "a" * 16, 4,
                                     tuple(vals[:2]), tuple(vals[2:]))
    assert p.digest == j.digest


def test_corrupt_mismatch_and_forged_refused_like_jax():
    ks, vs = _blocks(3)
    ship = port_migration.build_shipment("r0", (5, 6, 7, 8, 9), "f" * 16, 4,
                                         ks, vs)
    cases = [
        port_migration.corrupt_copy(ship),
        dataclasses.replace(ship, prompt=(1, 2, 3, 4, 5)),
        dataclasses.replace(ship, version=ship.version + 1),
        dataclasses.replace(ship, block_shas=ship.block_shas[:2]),
    ]
    for bad in cases:
        for fp in ("f" * 16, "0" * 16):
            errors = []
            for mod in (port_migration, jax_migration):
                try:
                    mod.verify_shipment(bad, fp)
                    errors.append(None)
                except mod.ShipmentError as e:
                    errors.append((type(e).__name__, str(e)))
            assert errors[0] == errors[1] and errors[0] is not None
    # the clean original survives its corrupt copy
    assert port_migration.verify_shipment(ship, "f" * 16) == ship.nbytes()
    with pytest.raises(ShipmentMismatch, match="fingerprint"):
        port_migration.verify_shipment(ship, "0" * 16)


@pytest.mark.parametrize("key,bad", [
    ("block_size", 8), ("block_shape", (2, 2, 8, 3)), ("dtype", "bfloat16"),
    ("max_len", 64), ("kv_layout", "dense"),
], ids=["block_size", "block_shape", "dtype", "max_len", "kv_layout"])
def test_kv_fingerprint_equals_jax(key, bad):
    base = dict(kv_layout="paged", block_size=4, block_shape=(2, 2, 4, 3),
                dtype="float32", max_len=32)
    changed = {**base, key: bad}
    assert port_migration.kv_fingerprint(**base) == \
        jax_migration.kv_fingerprint(**base)
    assert port_migration.kv_fingerprint(**changed) == \
        jax_migration.kv_fingerprint(**changed)
    assert port_migration.kv_fingerprint(**base) != \
        port_migration.kv_fingerprint(**changed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_fingerprint_equals_jax_engine(dtype):
    jparams, jcfg, tparams, tcfg = tiny_models(dtype)
    assert tparams["embed"].dtype == getattr(torch, dtype)
    port = port_engine(tparams, tcfg, role="decode")
    jax = jax_engine(jparams, jcfg, role="decode")
    assert port.kv_fingerprint() == jax.kv_fingerprint()
    assert port.kv_fingerprint() != port_engine(
        tparams, tcfg, max_len=64).kv_fingerprint()


def test_migration_policy_and_stats_match_jax():
    for mod in (port_migration, jax_migration):
        p = mod.MigrationPolicy(backoff_base_s=0.1, backoff_factor=2.0,
                                backoff_max_s=0.3)
        assert [round(p.backoff(n), 12) for n in (0, 1, 2, 3, 9)] == \
            [0.0, 0.1, 0.2, 0.3, 0.3]
    assert port_migration.MigrationStats().as_dict() == \
        jax_migration.MigrationStats().as_dict()


# --------------------------------------------------------------------- #
# shipment pins in the allocator
# --------------------------------------------------------------------- #
def _pin_script(mod):
    a = mod.BlockAllocator(num_blocks=9, block_size=4)
    prompt = list(range(1, 10))
    alloc = a.admit("mig", prompt_len=9, max_new_tokens=1,
                    prompt_tokens=prompt)
    chain_blocks = set(alloc.blocks[:2])
    pinned = a.pin_request("mig")
    out = [len(pinned), a.stats()["chains_pinned"]]
    a.release("mig")
    out.append(a.stats()["chains_pinned"])
    taken = set()
    for i in range(a.available()):
        got = a.admit(f"g{i}", prompt_len=3, max_new_tokens=1,
                      prompt_tokens=[50 + i] * 3)
        taken.update(got.blocks)
    out += [a.evictions_total, sorted(chain_blocks & taken)]
    out.append(a.admit("over", prompt_len=3, max_new_tokens=1,
                       prompt_tokens=[7] * 3))
    out.append(a.deferred_total)
    a.unpin(pinned)
    out.append(a.stats()["chains_pinned"])
    over = a.admit("over", prompt_len=3, max_new_tokens=1,
                   prompt_tokens=[7] * 3)
    out += [over.blocks, a.evictions_total, a.stats()]
    try:
        a.pin_request("never-admitted")
    except KeyError:
        out.append("KeyError")
    return out


def test_pinned_chains_survive_eviction_like_jax():
    got, want = _pin_script(port_paged_kv), _pin_script(jax_paged_kv)
    assert got == want
    assert got[:3] == [2, 2, 2]
    assert got[3] == 0 and got[4] == []  # no eviction, bytes untouched
    assert got[5] is None and got[6] == 1  # refused, never rewritten
    assert got[7] == 0 and got[9] > 0  # unpinned: evictable again
    assert got[-1] == "KeyError"


def test_pool_views_match_jax_pool():
    _, jcfg, _, tcfg = tiny_models()
    pools = [port_paged_kv.PagedKVPool(tcfg, 2, 16, block_size=4,
                                       device="cpu"),
             jax_paged_kv.PagedKVPool(jcfg, 2, 16, block_size=4)]
    views = []
    for pool in pools:
        s = pool.acquire("a", 9, 4, prompt_tokens=[3] * 9)
        pool.acquire("b", 9, 4, prompt_tokens=[3] * 9)
        out = [pool.shared_blocks(s.index), pool.free_count,
               pool.utilization(), round(pool.block_utilization(), 12)]
        pool.release(s.index)
        views.append(out + [pool.stats()])
    assert views[0] == views[1]


# --------------------------------------------------------------------- #
# engine to engine
# --------------------------------------------------------------------- #
def _export_one(src, prompt, n_new, request_id=None):
    comp = src.submit(prompt, max_new_tokens=n_new, request_id=request_id)
    src.step()  # the prefill runs; the slot parks
    [rid] = src.drain_ready_exports()
    return comp, rid, src.export_shipment(rid)


def test_port_prefill_to_decode_token_identical_to_jax_generate(model):
    jparams, jcfg, tparams, tcfg = model
    src = port_engine(tparams, tcfg, role="prefill")
    dst = port_engine(tparams, tcfg, role="decode")
    dst.start()
    try:
        assert src.kv_fingerprint() == dst.kv_fingerprint()
        for prompt, n_new in (([3, 1, 4, 1, 5], 6),
                              ([2, 7, 1, 8, 2, 8, 1, 8, 2, 8], 5)):
            comp_src, rid, ship = _export_one(src, prompt, n_new)
            assert src.pool.allocator.stats()["chains_pinned"] > 0
            assert ship.num_blocks == (len(prompt) - 1) // 4 + 1
            comp = dst.import_shipment(ship, max_new_tokens=n_new,
                                       request_id=rid)
            src.finish_export(rid)
            src.step()
            assert comp.result(timeout=60) == reference(jparams, jcfg,
                                                        prompt, n_new)
            assert comp.finish_reason == "length"
            assert comp_src.finish_reason == "migrated"
            assert src.pool.allocator.stats()["chains_pinned"] == 0
            assert src.pool.occupancy == 0
        # the prefill engine never decoded
        assert src.stats["decode_steps"] == 0
        assert src.stats["prefills"] == 2 and dst.stats["prefills"] == 2
    finally:
        dst.shutdown()
        src.shutdown()


def _jax_export(jparams, jcfg, prompt, n_new):
    src = jax_engine(jparams, jcfg, role="prefill")
    comp, rid, ship = _export_one(src, prompt, n_new, request_id="x")
    return src, comp, ship


def test_jax_shipment_decodes_on_port_and_back(model):
    """JAX's prefill engine ships to the port's decode engine, and the
    port's prefill engine to JAX's decode engine: both decode JAX's
    tokens."""
    jparams, jcfg, tparams, tcfg = model
    prompt, n_new = [6, 2, 8, 3, 1, 8, 5], 6
    want = reference(jparams, jcfg, prompt, n_new)

    _, _, jship = _jax_export(jparams, jcfg, prompt, n_new)
    dst = port_engine(tparams, tcfg, role="decode")
    dst.start()
    try:
        comp = dst.import_shipment(jship, max_new_tokens=n_new)
        assert comp.result(timeout=60) == want
    finally:
        dst.shutdown()

    src = port_engine(tparams, tcfg, role="prefill")
    _, rid, pship = _export_one(src, prompt, n_new)
    # the same prompt's KV, within fp32 rounding of XLA's
    for a, b in zip(pship.block_k + pship.block_v,
                    jship.block_k + jship.block_v):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    jdst = jax_engine(jparams, jcfg, role="decode")
    jdst.start()
    try:
        comp = jdst.import_shipment(pship, max_new_tokens=n_new)
        assert comp.result(timeout=120) == want
    finally:
        jdst.shutdown()


def _admit_now(engine_mod, engine, ship, rid):
    """Run an engine's admission of ``ship`` on this thread; returns the
    physical blocks of the prompt."""
    ticket = engine_mod._ImportTicket(ship, rid, 1, None, None, None, 0, 0)
    if hasattr(engine, "_stage_import"):  # the port verifies and stages first
        ticket.payload = engine._stage_import(ship)
    engine._admit_import(ticket)
    slot = next(s for s in engine.pool.slots if s.request_id == rid)
    return list(engine.pool._alloc_of[slot.index].blocks[:ship.num_blocks])


def test_bf16_shipments_cross_bit_for_bit():
    """At bf16 the payload bits cross both ways: JAX's shipment lands in
    the port's cache bit for bit, and the port's (its words viewed as
    JAX's bf16) verifies and lands in JAX's cache bit for bit."""
    from ray_lightning_tpu.serving import engine as jax_engine_mod
    from ray_lightning_tpu_torch.serving import engine as port_engine_mod

    jparams, jcfg, tparams, tcfg = tiny_models("bfloat16")
    prompt = [6, 2, 8, 3, 1, 8, 5, 9, 4]
    _, _, jship = _jax_export(jparams, jcfg, prompt, 4)
    src = port_engine(tparams, tcfg, role="prefill")
    _, _, pship = _export_one(src, prompt, 4)
    assert all(a.dtype == np.uint16 for a in pship.block_k + pship.block_v)

    dst = port_engine(tparams, tcfg, role="decode")
    blocks = _admit_now(port_engine_mod, dst, jship, "j")
    for j, bid in enumerate(blocks):
        for name, payload in (("k", jship.block_k), ("v", jship.block_v)):
            got = dst.pool.cache[name][:, bid].view(torch.int16).numpy()
            np.testing.assert_array_equal(got.view(np.uint16),
                                          payload[j].view(np.uint16))

    as_jax = dataclasses.replace(
        pship,
        block_k=tuple(a.view(ml_dtypes.bfloat16) for a in pship.block_k),
        block_v=tuple(a.view(ml_dtypes.bfloat16) for a in pship.block_v))
    jdst = jax_engine(jparams, jcfg, role="decode")
    blocks = _admit_now(jax_engine_mod, jdst, as_jax, "p")
    for j, bid in enumerate(blocks):
        for name, payload in (("k", pship.block_k), ("v", pship.block_v)):
            got = np.asarray(jdst.pool.cache[name][:, bid])
            np.testing.assert_array_equal(got.view(np.uint16), payload[j])


def test_shipment_payload_is_the_cache_blocks(model):
    _, _, tparams, tcfg = model
    src = port_engine(tparams, tcfg, role="prefill")
    prompt = list(range(3, 14))
    _, rid, ship = _export_one(src, prompt, 4)
    slot = src.pool.slots[src._exports[rid]["slot"]]
    blocks = src.pool._alloc_of[slot.index].blocks
    for j in range(ship.num_blocks):
        assert torch.equal(torch.from_numpy(ship.block_k[j]),
                           src.pool.cache["k"][:, blocks[j]])
        assert torch.equal(torch.from_numpy(ship.block_v[j]),
                           src.pool.cache["v"][:, blocks[j]])


def test_refused_shipments_take_no_slot_and_leave_cache_bitwise(model):
    jparams, jcfg, tparams, tcfg = model
    src = port_engine(tparams, tcfg, role="prefill")
    prompt, n_new = [2, 7, 1, 8, 9, 9], 5
    _, rid, ship = _export_one(src, prompt, n_new)
    dst = port_engine(tparams, tcfg, role="decode")
    other = port_engine(tparams, tcfg, role="decode", block_size=2,
                        max_prompt_len=8, max_len=32)
    dst.start()
    other.start()
    try:
        before = {k: v.clone() for k, v in dst.pool.cache.items()}
        free = dst.pool.allocator.free_blocks
        with pytest.raises(ShipmentCorrupt):
            dst.import_shipment(port_migration.corrupt_copy(ship),
                                max_new_tokens=n_new)
        with pytest.raises(ShipmentMismatch):
            other.import_shipment(ship, max_new_tokens=n_new)
        assert dst.pool.occupancy == 0 and other.pool.occupancy == 0
        assert dst.pool.allocator.free_blocks == free
        assert all(torch.equal(before[k], dst.pool.cache[k]) for k in before)
        # the clean resend decodes
        comp = dst.import_shipment(ship, max_new_tokens=n_new,
                                   request_id=rid)
        assert comp.result(timeout=60) == reference(jparams, jcfg, prompt,
                                                    n_new)
    finally:
        dst.shutdown()
        other.shutdown()


def test_import_at_capacity_is_rejected(model):
    """The receiver's only slot is taken: the import is verified and
    staged, then refused at the reservation on the loop (stepped here)."""
    import threading

    _, _, tparams, tcfg = model
    src = port_engine(tparams, tcfg, role="prefill")
    _, _, ship = _export_one(src, [4, 4, 5], 3)
    dst = port_engine(tparams, tcfg, role="decode", num_slots=1)
    dst.submit([9, 9], max_new_tokens=20)
    dst.step()  # admitted: the only slot is taken
    out = {}

    def offer():
        try:
            dst.import_shipment(ship, max_new_tokens=3, timeout=30)
        except Exception as e:
            out["error"] = e

    thread = threading.Thread(target=offer)
    thread.start()
    deadline = time.time() + 30
    while not dst._pending_imports and time.time() < deadline:
        time.sleep(0.001)
    dst.step()  # the loop's half: the reservation refuses
    thread.join(30)
    assert isinstance(out.get("error"), MigrationRejected)
    assert dst.pool.occupancy == 1


def test_cancel_export_decodes_in_place(model):
    jparams, jcfg, tparams, tcfg = model
    src = port_engine(tparams, tcfg, role="prefill")
    prompt, n_new = [1, 6, 1, 8], 5
    comp, rid, _ = _export_one(src, prompt, n_new)
    src.cancel_export(rid)
    src.run_until_idle()
    assert comp.result(timeout=1) == reference(jparams, jcfg, prompt, n_new)
    assert comp.finish_reason == "length"
    assert src.pool.allocator.stats()["chains_pinned"] == 0


def test_parked_blocks_bitwise_unchanged_by_other_decodes(model):
    """A parked slot's row rides every decode step as padding (token 0,
    position 0): it must point at the trash block, or the padding write
    lands in the parked request's first prompt block."""
    jparams, jcfg, tparams, tcfg = model
    src = port_engine(tparams, tcfg, role="prefill")
    a = src.submit([5, 9, 2, 6, 5, 3], max_new_tokens=4, request_id="a")
    b = src.submit([7, 7, 1, 2], max_new_tokens=6, request_id="b")
    src.step()  # a prefilled and parked; nothing decodes
    assert src.drain_ready_exports() == ["a"]
    slot_a = src.pool.slots[src._exports["a"]["slot"]]
    blocks_a = list(src.pool._alloc_of[slot_a.index].blocks)
    snap = {k: v[:, blocks_a].clone() for k, v in src.pool.cache.items()}
    src.step()  # b prefilled and parked
    src.cancel_export("b")
    for _ in range(7):  # b decodes beside a, which stays parked
        src.step()
    assert b.result(timeout=1) == reference(jparams, jcfg, [7, 7, 1, 2], 6)
    assert src.stats["decode_steps"] >= 6
    for k, v in src.pool.cache.items():
        assert torch.equal(v[:, blocks_a], snap[k])
    ship = src.export_shipment("a")
    for j, block in enumerate(blocks_a):
        assert torch.equal(torch.from_numpy(ship.block_k[j]),
                           snap["k"][:, j])
    assert not a.done


def test_parked_export_expiry_unpins(model):
    _, _, tparams, tcfg = model
    src = port_engine(tparams, tcfg, role="prefill")
    comp = src.submit(list(range(1, 11)), max_new_tokens=4,
                      deadline_ms=300.0)
    src.step()
    [rid] = src.drain_ready_exports()
    assert src.pool.allocator.stats()["chains_pinned"] == 2
    time.sleep(0.35)
    src.step()
    assert comp.finish_reason == "expired"
    assert src.pool.allocator.stats()["chains_pinned"] == 0
    assert src.pool.occupancy == 0 and rid not in src._exports
    assert src.pool.allocator.used_blocks == 0
    # the expired export's finish is a no-op
    src.finish_export(rid)
    src.step()
    assert comp.finish_reason == "expired"


def test_roles_validate_like_jax(model):
    from ray_lightning_tpu.serving import EngineConfig as JaxEngineConfig
    from ray_lightning_tpu_torch.serving import EngineConfig

    for kw in (dict(role="prefill"), dict(role="prefill", kv_layout="paged"),
               dict(role="decode"), dict(role="decode", kv_layout="paged"),
               dict(role="mixed")):
        outcomes = []
        for cfg_cls in (EngineConfig, JaxEngineConfig):
            try:
                cfg_cls(**kw).validate()
                outcomes.append("ok")
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], kw
    _, _, tparams, tcfg = model
    eng = port_engine(tparams, tcfg, role="decode")
    assert eng.load()["role"] == "decode"
