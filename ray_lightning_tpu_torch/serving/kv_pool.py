"""The slot KV layout (``ray_lightning_tpu/serving/kv_pool.py``): the
host-side state of one serving slot, which the paged pool
(``paged_kv.py``) keeps its slots in too, and ``KVSlotPool``.

One device allocation, many requests: the pool owns a single
``init_kv_cache(cfg, batch=num_slots, max_len)`` cache whose batch rows are
slots. A request is admitted into a free slot, decoded in lockstep with
every other occupied slot by one ``decode_step_ragged`` call (each row at
its own position) and recycled on EOS or max-tokens. The cache tensors
never reallocate: admission and recycling are host bookkeeping. Slot
isolation is structural: each row writes and attends only its own batch
row, masked against its own position, so a freed slot's stale keys are
never attendable by its next tenant.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ray_lightning_tpu_torch import observability as _obs
from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.models.generation import init_kv_cache


@dataclass
class Slot:
    """One row of the fixed-shape decode batch.

    ``pos`` is the position of ``pending_token`` — the token the NEXT
    batched decode step feeds for this row. After a prefill of P prompt
    tokens the cache holds positions [0, P) and ``pos = P - 1`` with
    ``pending_token = prompt[-1]``: the first decode step rewrites that
    last position's (k, v) with identical values and yields the logits
    for position P, i.e. the request's FIRST sampled token, so one decode
    step serves both the first token and every later one.
    """

    index: int
    request_id: Optional[str] = None
    pos: int = -1
    pending_token: int = 0
    prompt_len: int = 0
    generated: int = 0
    max_new_tokens: int = 0
    eos_id: Optional[int] = None
    # absolute deadline (time.perf_counter domain)
    deadline: Optional[float] = None
    # when the request's latest token was delivered (inter-token latency)
    last_token_at: Optional[float] = None
    # the request's RequestTrace (None with telemetry off or when sampling
    # dropped it): the decode loop's only tracing cost a token is reading it
    trace: Optional[object] = None
    # a prefill-role engine parks a prefilled slot here while its KV is in
    # flight to a decode engine: the decode tick skips it, and a cancelled
    # migration clears the flag so the request decodes in place
    export_pending: bool = False

    @property
    def occupied(self) -> bool:
        return self.request_id is not None

    def reset(self) -> None:
        self.request_id = None
        self.pos = -1
        self.pending_token = 0
        self.prompt_len = 0
        self.generated = 0
        self.max_new_tokens = 0
        self.eos_id = None
        self.deadline = None
        self.last_token_at = None
        self.trace = None
        self.export_pending = False


class KVSlotPool:
    """``num_slots`` cache rows of ``max_len`` positions, a free list and
    occupancy counters. The cache is ``{"k", "v"}`` of shape
    [L, num_slots, Hkv, max_len, hd] in ``cfg.dtype`` on ``device`` (the
    card unless ``device="cpu"``); prefill and decode write it in place.

    Sliding-window configs are refused: a rolling buffer wraps at
    pos % window, which is unsound when one row is recycled across requests
    at unrelated depths, so every slot holds ``max_len`` positions of a
    dense-causal config.
    """

    layout = "slot"

    def __init__(self, cfg, num_slots: int, max_len: int,
                 device: DeviceLike = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if cfg.sliding_window:
            raise ValueError(
                "the serving KV pool requires dense-causal configs: a "
                "rolling sliding-window buffer wraps slots at pos % W, "
                "which is unsound when the same row is recycled across "
                "requests at unrelated depths"
            )
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.cache = init_kv_cache(cfg, self.num_slots, self.max_len,
                                   device=self.device)
        self.slots: List[Slot] = [Slot(i) for i in range(self.num_slots)]
        self._free: List[int] = list(range(self.num_slots - 1, -1, -1))
        self.admitted_total = 0
        self.recycled_total = 0
        self.highwater = 0
        # slot -> the request ids it served, in order
        self.tenancies: Dict[int, List[str]] = {
            i: [] for i in range(self.num_slots)
        }

    def acquire(self, request_id: str, prompt_len: int, max_new_tokens: int,
                eos_id: Optional[int] = None,
                prompt_tokens: Optional[Sequence[int]] = None,
                deadline: Optional[float] = None) -> Optional[Slot]:
        """Claim a free slot for a request; ``None`` when the pool is full.
        The request's last decode reads position ``prompt_len - 1 +
        max_new_tokens - 1``, which must fit the slot. ``prompt_tokens`` is
        accepted for the paged pool's interface and ignored: the slot layout
        shares no prefixes."""
        del prompt_tokens
        if prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"request {request_id!r} needs {prompt_len} prompt + "
                f"{max_new_tokens} new tokens = "
                f"{prompt_len + max_new_tokens} positions, but pool slots "
                f"hold max_len={self.max_len}"
            )
        if not self._free:
            return None
        slot = self.slots[self._free.pop()]
        slot.request_id = request_id
        slot.prompt_len = int(prompt_len)
        slot.max_new_tokens = int(max_new_tokens)
        slot.eos_id = eos_id
        slot.deadline = deadline
        slot.generated = 0
        self.admitted_total += 1
        self.tenancies[slot.index].append(request_id)
        self.highwater = max(self.highwater, self.occupancy)
        self._publish_gauges()
        return slot

    def release(self, index: int) -> Slot:
        """Recycle a slot back to the free list (EOS, max-tokens, error)."""
        slot = self.slots[index]
        if not slot.occupied:
            raise ValueError(f"slot {index} is already free")
        slot.reset()
        self._free.append(index)
        self.recycled_total += 1
        self._publish_gauges()
        return slot

    @property
    def occupancy(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def active_slots(self) -> List[Slot]:
        """Occupied slots in index order (the decode batch)."""
        return [s for s in self.slots if s.occupied]

    def utilization(self) -> float:
        return self.occupancy / self.num_slots

    def stats(self) -> Dict[str, object]:
        return {
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

    def _publish_gauges(self) -> None:
        reg = _obs.registry()
        if reg is not None:
            reg.gauge("rlt_serve_slot_occupancy").set(self.occupancy)
            reg.gauge("rlt_serve_slot_highwater").set(self.highwater)
