"""Paged KV cache: block allocation + shared-prefix reuse for serving
(``ray_lightning_tpu/serving/paged_kv.py`` in PyTorch, without the gauges).

- :class:`BlockAllocator` — pure host logic: a free list of physical
  blocks, per-request allocations with a worst-case growth RESERVATION (so
  mid-decode growth can never fail), and a hash-chained prefix cache with
  per-block refcounts and LRU eviction of refcount-0 chains.
- :class:`PagedKVPool` — the device-facing pool the engine drives: one
  pair of cache tensors [L, num_blocks, Hkv, block_size, hd] on the
  device (updated in place by prefill and decode), the host block table
  [num_slots, max_blocks] int32 (a fixed shape, trash-padded), and the
  slot bookkeeping.

Prefix sharing: a prompt's FULL blocks are identified by a rolling hash
chain (``H_i = sha256(H_{i-1} || tokens[i*bs:(i+1)*bs])``), so a hit means
every preceding block matched too and the cached (k, v) sit at the same
absolute positions. Sharing is copy-on-write at admission: decode rewrites
position ``P - 1`` and then writes ``P, P+1, ...``, so the block holding
``P - 1`` and everything after is always private, and shared blocks are
immutable while referenced.

Physical block 0 is the TRASH block: prefill writes of already-cached
blocks and the dummy decode writes of free slots land there, so the
fixed-shape prefill and decode never need a "skip this write" branch.
Trash is never attended: block tables reference it only past a row's
position.

Shipment pins: a prefill engine pins the chain blocks of a request whose
KV is in flight to a decode engine (:meth:`BlockAllocator.pin_request`).
A pinned chain whose refcount drops to 0 is neither claimable supply nor
an eviction victim until it is unpinned, so its bytes stay put while the
shipment (or a resend) still reads them.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.serving.kv_pool import Slot

__all__ = [
    "BlockAllocation",
    "BlockAllocator",
    "OutOfBlocks",
    "PagedKVPool",
    "TRASH_BLOCK",
    "blocks_for",
]

# physical block 0: write-redirect target for shared-prefix prefill slots
# and free-slot dummy decode writes; never allocated, never attendable
TRASH_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """A block was requested beyond the allocator's capacity guarantee —
    either a ``grow`` past the request's reservation or an internal
    accounting violation. Admission-time shortages are NOT an error:
    :meth:`BlockAllocator.admit` returns ``None`` (back-pressure)."""


@dataclass
class _ChainNode:
    """One cached prefix block: chain key -> physical block + refcount."""

    block: int
    parent: Optional[bytes]  # parent chain key (None for the first block)
    refcount: int = 0  # active requests referencing this block
    children: int = 0  # cached chain nodes extending this one
    last_used: int = 0  # allocator LRU clock
    pinned: int = 0  # in-flight KV shipments referencing this block


@dataclass
class BlockAllocation:
    """Host-side record of one admitted request's blocks.

    ``blocks[:cached]`` are chain-cache-owned (shared or registered by
    this request — released by refcount, never freed directly);
    ``blocks[cached:]`` are plain private blocks returned to the free
    list on release. ``reserved`` counts the growth blocks this request
    is still guaranteed (decremented by :meth:`BlockAllocator.grow`).
    """

    request_id: str
    blocks: List[int]
    shared: int  # leading blocks reused from the prefix cache (hits)
    cached: int  # leading blocks owned by the chain cache (>= shared)
    chain_keys: List[bytes] = field(default_factory=list)
    reserved: int = 0


def blocks_for(prompt_len: int, max_new_tokens: int, block_size: int) -> int:
    """Worst-case blocks a request needs: cache positions run
    [0, prompt_len + max_new_tokens - 2] (the final sampled token is
    output, never written)."""
    last_pos = prompt_len + max_new_tokens - 2
    return last_pos // block_size + 1


class BlockAllocator:
    """Fixed-size block pool + refcounted prefix-chain cache (pure host).

    Capacity accounting is reservation-based: :meth:`admit` only
    succeeds when the prompt's private blocks AND the request's
    worst-case growth fit in ``free + evictable-cached`` blocks, so
    :meth:`grow` can never fail mid-decode — a request that was admitted
    always finishes. Requests that finish early (EOS) return their
    unused reservation immediately, which is the capacity win over the
    slot layout.
    """

    def __init__(
        self, num_blocks: int, block_size: int, prefix_cache: bool = True
    ):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (1 data block + the trash "
                f"block), got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_cache_enabled = bool(prefix_cache)
        # block 0 is TRASH: excluded from the free list forever
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._allocs: Dict[str, BlockAllocation] = {}
        self._chains: Dict[bytes, _ChainNode] = {}
        self._idle_cached = 0  # chain nodes with refcount == 0 (evictable)
        self._pinned_idle = 0  # of those, pinned by an in-flight shipment
        self._reserved_total = 0
        self._clock = 0
        # lifetime counters (stats() + the serving gauges)
        self.admitted_total = 0
        self.released_total = 0
        self.grown_total = 0
        self.prefix_hits_total = 0  # blocks served from the chain cache
        self.prefix_misses_total = 0  # full blocks newly registered
        self.cow_private_total = 0  # matched blocks privatized (decode writes)
        self.evictions_total = 0
        self.deferred_total = 0  # admissions refused for lack of blocks
        self.blocks_highwater = 0  # peak used_blocks over the lifetime

    # ------------------------------------------------------------------ #
    # capacity views
    # ------------------------------------------------------------------ #
    @property
    def capacity(self) -> int:
        """Usable data blocks (excludes the trash block)."""
        return self.num_blocks - 1

    @property
    def used_blocks(self) -> int:
        return self.capacity - len(self._free) - self._idle_cached

    @property
    def cached_blocks(self) -> int:
        """Blocks held by the chain cache with no active reference."""
        return self._idle_cached

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def available(self) -> int:
        """Blocks an admission may claim: free + evictable cached, minus
        everything already promised to active requests. Idle chains pinned
        by an in-flight shipment are not evictable, so not supply."""
        evictable = self._idle_cached - self._pinned_idle
        return len(self._free) + evictable - self._reserved_total

    # ------------------------------------------------------------------ #
    # admission / growth / release
    # ------------------------------------------------------------------ #
    def admit(
        self,
        request_id: str,
        prompt_len: int,
        max_new_tokens: int,
        prompt_tokens: Optional[Sequence[int]] = None,
    ) -> Optional[BlockAllocation]:
        """Claim blocks for a request; ``None`` = not enough blocks
        (back-pressure — the caller keeps the request queued).

        Allocates the PROMPT blocks now (positions [0, prompt_len)) and
        reserves the rest of the worst case; pass ``prompt_tokens`` to
        enable prefix matching/registration (without them the request is
        admitted with sharing disabled).
        """
        if prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if request_id in self._allocs:
            raise ValueError(f"request {request_id!r} is already admitted")
        if prompt_tokens is not None and len(prompt_tokens) != prompt_len:
            raise ValueError(
                f"prompt_tokens length {len(prompt_tokens)} != prompt_len "
                f"{prompt_len}"
            )
        bs = self.block_size
        total_needed = blocks_for(prompt_len, max_new_tokens, bs)
        prompt_blocks = (prompt_len - 1) // bs + 1
        # decode writes positions >= prompt_len - 1, so the block holding
        # that position (and everything after) must be private: sharing is
        # copy-on-write at admission, not at decode time
        writable_from = (prompt_len - 1) // bs
        shareable = min(prompt_len // bs, writable_from)

        keys: List[bytes] = []
        matched: List[_ChainNode] = []
        if self.prefix_cache_enabled and prompt_tokens is not None:
            keys = self._chain_keys(prompt_tokens, shareable)
            for key in keys:
                node = self._chains.get(key)
                if node is None:
                    break
                matched.append(node)
            # a full-prompt match capped by writable_from is the CoW case:
            # the cache HAS the block but decode will write it
            if len(matched) == shareable and shareable < prompt_len // bs:
                extra = self._chain_keys(prompt_tokens, prompt_len // bs)
                if extra[shareable] in self._chains:
                    self.cow_private_total += 1

        shared = len(matched)
        revived = sum(1 for n in matched if n.refcount == 0)
        private_now = prompt_blocks - shared
        reserved_new = total_needed - prompt_blocks
        if private_now + reserved_new + revived > self.available():
            self.deferred_total += 1
            return None

        # ---- commit (no failures past this point) ---- #
        self._clock += 1
        for node in matched:
            if node.refcount == 0:
                self._idle_cached -= 1
                if node.pinned > 0:
                    self._pinned_idle -= 1
            node.refcount += 1
            node.last_used = self._clock
        self.prefix_hits_total += shared
        blocks = [n.block for n in matched]
        chain_keys = list(keys[:shared])
        cached = shared
        for i in range(shared, prompt_blocks):
            block = self._alloc_block()
            blocks.append(block)
            if i < len(keys):  # full block before the write frontier
                parent = keys[i - 1] if i > 0 else None
                self._chains[keys[i]] = _ChainNode(
                    block=block, parent=parent, refcount=1,
                    last_used=self._clock,
                )
                if parent is not None:
                    self._chains[parent].children += 1
                chain_keys.append(keys[i])
                cached += 1
                self.prefix_misses_total += 1
        self._reserved_total += reserved_new
        alloc = BlockAllocation(
            request_id=request_id,
            blocks=blocks,
            shared=shared,
            cached=cached,
            chain_keys=chain_keys,
            reserved=reserved_new,
        )
        self._allocs[request_id] = alloc
        self.admitted_total += 1
        self.blocks_highwater = max(self.blocks_highwater, self.used_blocks)
        return alloc

    def grow(self, request_id: str) -> int:
        """Allocate one reserved block for an active request (decode
        crossed a block boundary). Guaranteed to succeed within the
        admission-time reservation; growing past it raises."""
        alloc = self._allocs.get(request_id)
        if alloc is None:
            raise KeyError(f"request {request_id!r} is not admitted")
        if alloc.reserved <= 0:
            raise OutOfBlocks(
                f"request {request_id!r} grew past its reservation "
                f"({len(alloc.blocks)} blocks allocated): the admission "
                "contract sizes blocks to prompt_len + max_new_tokens"
            )
        block = self._alloc_block()
        alloc.reserved -= 1
        self._reserved_total -= 1
        alloc.blocks.append(block)
        self.grown_total += 1
        self.blocks_highwater = max(self.blocks_highwater, self.used_blocks)
        return block

    def release(self, request_id: str) -> None:
        """Return a finished request's blocks: refcount-down the cached
        prefix (chains stay warm for future hits), free the private tail,
        return the unused reservation."""
        alloc = self._allocs.pop(request_id, None)
        if alloc is None:
            raise KeyError(f"request {request_id!r} is not admitted")
        self._clock += 1
        for key in alloc.chain_keys:
            node = self._chains[key]
            node.refcount -= 1
            node.last_used = self._clock
            if node.refcount == 0:
                self._idle_cached += 1
                if node.pinned > 0:
                    self._pinned_idle += 1
        self._free.extend(alloc.blocks[alloc.cached:])
        self._reserved_total -= alloc.reserved
        self.released_total += 1

    # ------------------------------------------------------------------ #
    # shipment pinning
    # ------------------------------------------------------------------ #
    def pin_request(self, request_id: str) -> List[bytes]:
        """Pin the chain blocks of an active request for the life of an
        in-flight KV shipment; returns the pinned chain keys, which the
        caller hands back to :meth:`unpin` when the shipment lands or is
        given up. Without the pin, a sibling's release could drop the
        chain to refcount 0 and allocation pressure evict and rewrite its
        blocks while the shipment still needs their bytes."""
        alloc = self._allocs.get(request_id)
        if alloc is None:
            raise KeyError(f"request {request_id!r} is not admitted")
        self.pin(alloc.chain_keys)
        return list(alloc.chain_keys)

    def pin(self, chain_keys: Sequence[bytes]) -> None:
        for key in chain_keys:
            node = self._chains.get(key)
            if node is None:
                continue
            node.pinned += 1
            if node.refcount == 0 and node.pinned == 1:
                self._pinned_idle += 1

    def unpin(self, chain_keys: Sequence[bytes]) -> None:
        for key in chain_keys:
            node = self._chains.get(key)
            if node is None:
                continue
            node.pinned = max(0, node.pinned - 1)
            if node.refcount == 0 and node.pinned == 0:
                self._pinned_idle -= 1

    # ------------------------------------------------------------------ #
    # internals
    # ------------------------------------------------------------------ #
    def _chain_keys(
        self, tokens: Sequence[int], n_blocks: int
    ) -> List[bytes]:
        """Rolling hash chain over the first ``n_blocks`` full blocks."""
        bs = self.block_size
        keys: List[bytes] = []
        digest = b""
        for i in range(n_blocks):
            chunk = np.asarray(
                tokens[i * bs:(i + 1) * bs], dtype=np.int64
            ).tobytes()
            digest = hashlib.sha256(digest + chunk).digest()
            keys.append(digest)
        return keys

    def _alloc_block(self) -> int:
        if self._free:
            return self._free.pop()
        evicted = self._evict_lru()
        if evicted is None:
            raise OutOfBlocks(
                "no free or evictable blocks — allocation outside the "
                "admission/reservation contract"
            )
        return evicted

    def _evict_lru(self) -> Optional[int]:
        """Evict the least-recently-used refcount-0 LEAF chain node
        (leaf-first keeps every cached chain reachable from its root).
        Pinned nodes are untouchable: an in-flight KV shipment still reads
        their bytes."""
        victim_key = None
        victim = None
        for key, node in self._chains.items():
            if node.refcount == 0 and node.children == 0 and node.pinned == 0:
                if victim is None or node.last_used < victim.last_used:
                    victim_key, victim = key, node
        if victim is None:
            return None
        del self._chains[victim_key]
        if victim.parent is not None:
            self._chains[victim.parent].children -= 1
        self._idle_cached -= 1
        self.evictions_total += 1
        return victim.block

    def stats(self) -> Dict[str, object]:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_used": self.used_blocks,
            "blocks_free": self.free_blocks,
            "blocks_cached": self.cached_blocks,
            "blocks_reserved": self._reserved_total,
            "blocks_highwater": self.blocks_highwater,
            "chains_cached": len(self._chains),
            "chains_pinned": sum(
                1 for n in self._chains.values() if n.pinned > 0
            ),
            "admitted_total": self.admitted_total,
            "released_total": self.released_total,
            "grown_total": self.grown_total,
            "prefix_hits_total": self.prefix_hits_total,
            "prefix_misses_total": self.prefix_misses_total,
            "cow_private_total": self.cow_private_total,
            "evictions_total": self.evictions_total,
            "deferred_total": self.deferred_total,
        }


class PagedKVPool:
    """Block-paged device KV pool with slot bookkeeping.

    The cache is one pair of device tensors ``{"k", "v"}`` of shape
    [L, num_blocks, Hkv, block_size, hd] in ``cfg.dtype``; prefill and
    decode write it in place. Each engine slot has a row of the host block
    table [num_slots, max_blocks] (int32, trash-padded). Admission is by
    slot AND block availability (the allocator's reservation contract):
    the pool can refuse a request while slots are free, which the
    scheduler turns into FIFO head-of-line waiting.
    """

    def __init__(self, cfg, num_slots: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True, device: DeviceLike = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if cfg.sliding_window:
            raise ValueError(
                "the paged KV pool requires dense-causal configs: block "
                "tables map logical positions 1:1 to cache slots"
            )
        if max_len % block_size != 0:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of block_size "
                f"({block_size})"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.block_size = int(block_size)
        self.max_blocks = self.max_len // self.block_size
        if num_blocks is None:
            # slot-equivalent worst case + the trash block
            num_blocks = self.num_slots * self.max_blocks + 1
        self.allocator = BlockAllocator(
            num_blocks, self.block_size, prefix_cache=prefix_cache
        )
        shape = (cfg.n_layers, num_blocks, cfg.n_kv_heads, self.block_size,
                 cfg.head_dim)
        self.cache = {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
        }
        self.block_tables = np.full(
            (self.num_slots, self.max_blocks), TRASH_BLOCK, np.int32
        )
        self.slots: List[Slot] = [Slot(i) for i in range(self.num_slots)]
        self._free: List[int] = list(range(self.num_slots - 1, -1, -1))
        self._alloc_of: Dict[int, BlockAllocation] = {}
        self.admitted_total = 0
        self.recycled_total = 0
        self.highwater = 0
        # slot -> the request ids it served, in order
        self.tenancies: Dict[int, List[str]] = {
            i: [] for i in range(self.num_slots)
        }

    layout = "paged"

    def acquire(self, request_id: str, prompt_len: int, max_new_tokens: int,
                eos_id: Optional[int] = None,
                prompt_tokens: Optional[Sequence[int]] = None,
                deadline: Optional[float] = None) -> Optional[Slot]:
        """Admit by slot AND block availability; ``None`` when either is
        exhausted (the scheduler keeps the request queued)."""
        if prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"request {request_id!r} needs {prompt_len} prompt + "
                f"{max_new_tokens} new tokens, but the pool serves "
                f"max_len={self.max_len}"
            )
        if not self._free:
            return None
        alloc = self.allocator.admit(
            request_id, prompt_len, max_new_tokens,
            prompt_tokens=prompt_tokens,
        )
        if alloc is None:
            return None
        slot = self.slots[self._free.pop()]
        slot.request_id = request_id
        slot.prompt_len = int(prompt_len)
        slot.max_new_tokens = int(max_new_tokens)
        slot.eos_id = eos_id
        slot.deadline = deadline
        slot.generated = 0
        row = self.block_tables[slot.index]
        row[:] = TRASH_BLOCK
        row[: len(alloc.blocks)] = alloc.blocks
        self._alloc_of[slot.index] = alloc
        self.admitted_total += 1
        self.tenancies[slot.index].append(request_id)
        self.highwater = max(self.highwater, self.occupancy)
        return slot

    def release(self, index: int) -> Slot:
        slot = self.slots[index]
        if not slot.occupied:
            raise ValueError(f"slot {index} is already free")
        self.allocator.release(slot.request_id)
        self.block_tables[index, :] = TRASH_BLOCK
        self._alloc_of.pop(index, None)
        slot.reset()
        self._free.append(index)
        self.recycled_total += 1
        return slot

    def prompt_write_table(self, slot_index: int,
                           n_prompt_blocks: int) -> np.ndarray:
        """Write-redirect table for the fixed-shape prefill: entry j is the
        physical block for prompt block j, or TRASH for shared-prefix blocks
        (already written once, immutable while referenced) and for padding
        blocks past this prompt's real length."""
        alloc = self._alloc_of[slot_index]
        slot = self.slots[slot_index]
        own = (slot.prompt_len - 1) // self.block_size + 1
        table = np.full((n_prompt_blocks,), TRASH_BLOCK, np.int32)
        for j in range(alloc.shared, min(own, n_prompt_blocks)):
            table[j] = alloc.blocks[j]
        return table

    def ensure_writable(self, slot: Slot,
                        upto_pos: Optional[int] = None) -> None:
        """Grow the slot's block table from its reservation until the block
        holding ``upto_pos`` (default ``slot.pos``, the position the next
        decode writes) is allocated. A speculative verify writes every
        proposed position before acceptance is known, so it passes
        ``slot.pos + n_proposals``; the engine caps proposals at the
        remaining token budget, which keeps that inside the admission-time
        reservation: growth cannot fail."""
        alloc = self._alloc_of[slot.index]
        pos = slot.pos if upto_pos is None else int(upto_pos)
        needed = pos // self.block_size + 1
        while len(alloc.blocks) < needed:
            block = self.allocator.grow(slot.request_id)
            self.block_tables[slot.index, len(alloc.blocks) - 1] = block

    def shared_blocks(self, slot_index: int) -> int:
        return self._alloc_of[slot_index].shared

    def block_utilization(self) -> float:
        return self.allocator.used_blocks / max(self.allocator.capacity, 1)

    @property
    def occupancy(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def active_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.occupied]

    def utilization(self) -> float:
        return self.occupancy / self.num_slots

    def stats(self) -> Dict[str, object]:
        out = {
            "layout": self.layout,
            "num_slots": self.num_slots,
            "max_len": self.max_len,
            "occupancy": self.occupancy,
            "highwater": self.highwater,
            "admitted_total": self.admitted_total,
            "recycled_total": self.recycled_total,
            "tenants_per_slot": {
                i: len(v) for i, v in self.tenancies.items()
            },
        }
        out.update(self.allocator.stats())
        return out
