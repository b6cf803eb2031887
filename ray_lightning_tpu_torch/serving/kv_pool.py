"""Host-side state of one serving slot (``ray_lightning_tpu/serving/
kv_pool.py::Slot``). The slot-layout pool itself is not ported yet; the
paged pool (``paged_kv.py``) keeps its slots here."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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
