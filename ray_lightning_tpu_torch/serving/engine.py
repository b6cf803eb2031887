"""Single-replica continuous-batching inference engine
(``ray_lightning_tpu/serving/engine.py``) on either KV layout: ``"slot"``
(the default, a full ``max_len`` cache row per slot, ``serving/kv_pool.py``)
or ``"paged"`` (blocks from one shared pool with shared-prefix reuse,
``serving/paged_kv.py``).

Each :meth:`InferenceEngine.step` runs up to ``max_prefills_per_tick``
prefills and one batched decode over every slot:

- prefill takes the request's prompt right-padded to ``max_prompt_len``
  through every layer in one pass (flash attention) into a one-row scratch
  cache. The slot layout copies it into the first ``max_prompt_len``
  positions of the slot's row; the paged layout scatters it, cut into
  blocks, to the physical blocks of the request's write table, whose
  shared-prefix and padding entries point at the trash block, so a cached
  prefix is written once. The padded
  positions write garbage (k, v) past the prompt; no row attends them
  before decode overwrites them;
- decode feeds every slot's pending token at its own position through
  ``decode_step_ragged`` (slot: fp32 attention over the dense rows in
  plain torch, as the JAX package computes it in XLA) or
  ``decode_step_paged`` (the paged decode kernel over the block table),
  then the sampler: the argmax kernel for greedy and plain-temperature
  configs, the plain sampler for top-k / top-p. Free slots ride along with
  token 0 at position 0 (on a trash table row, for the paged layout);
- a request's first token comes from the first decode after its prefill,
  which re-runs the last prompt token at position P - 1 (an idempotent
  cache write), so prefill needs no logits head;
- with ``speculate_k = K > 0`` (greedy only), each decode is a verify step
  instead: every slot feeds its pending token and up to K - 1 tokens
  proposed by prompt lookup over its own history (``ngram_propose``)
  through one ``decode_step_verify`` on either layout, the [S * K, V]
  logits are sampled greedily, and the longest prefix of proposals that
  the model itself emits is delivered with the model's next token after
  it, so every tick delivers at least one token a slot and the stream is
  token-identical to one-token decoding.

The cache tensors and block tables never change shape; admission,
recycling and block growth are host bookkeeping. The KV pool is updated in
place. Neither pool serves a sliding-window config (``generate`` does).

Not ported yet, and refused at construction: the disaggregated
prefill/decode roles and tenancy. Fault injection and telemetry
(environment-driven in the JAX package, the accepted-tokens histogram
among them) have no counterpart here.

Threading: ``submit`` may be called from any thread; ``start()`` spawns
the loop thread (a daemon, joined by ``drain``/``shutdown``), or call
``step()`` / ``run_until_idle()`` yourself.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_lightning_tpu_torch import kernels
from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.models.generation import (
    _sample_logits,
    decode_step_paged,
    decode_step_ragged,
    decode_step_verify,
    init_kv_cache,
    prefill_hidden,
    require_every_expert,
)
from ray_lightning_tpu_torch.ops.paged_attention import (
    fused_sample,
    fused_sample_supported,
)
from ray_lightning_tpu_torch.ops.rope import rope_angles
from ray_lightning_tpu_torch.serving.kv_pool import KVSlotPool
from ray_lightning_tpu_torch.serving.paged_kv import PagedKVPool
from ray_lightning_tpu_torch.serving.resilience import RequestShed, ShedPolicy
from ray_lightning_tpu_torch.serving.scheduler import (
    ContinuousBatchScheduler,
    Request,
    RequestQueueFull,
)
from ray_lightning_tpu_torch.serving.speculative import ngram_propose

__all__ = [
    "Completion",
    "EngineClosed",
    "EngineConfig",
    "InferenceEngine",
    "RequestQueueFull",
    "RequestShed",
]


class EngineClosed(RuntimeError):
    """submit() after drain/shutdown."""


@dataclass(frozen=True)
class EngineConfig:
    """Serving settings, as the JAX package's ``EngineConfig``.

    ``max_prompt_len`` is the fixed prefill length (longer prompts are
    rejected at submit); ``max_len`` is each request's position budget
    (``prompt_len + max_new_tokens <= max_len``). ``kv_layout`` is
    ``"slot"`` (a full cache row per slot) or ``"paged"``, whose
    ``max_len`` must be a multiple of ``block_size`` and whose
    ``num_kv_blocks`` sizes the block pool (default: the slot-equivalent
    ``num_slots * max_len / block_size`` + the trash block);
    ``block_size``, ``num_kv_blocks`` and ``prefix_cache`` are paged-only.
    Sampling settings are engine-wide. ``shed_watermark`` is the
    queue fill at which priority >= 1 requests are shed;
    ``head_skip_limit`` / ``head_aging_ticks`` bound the skip-ahead window
    behind a deferred queue head (0 = strict FIFO).

    ``speculate_k``: 0 decodes one token a slot a tick; K >= 2 verifies
    the pending token and up to K - 1 prompt-lookup proposals a slot in
    one pass (greedy sampling only). ``role`` must be ``"both"``: the
    disaggregated roles are not ported yet.
    """

    num_slots: int = 4
    max_prompt_len: int = 64
    max_len: int = 256
    max_queue: int = 256
    max_prefills_per_tick: int = 1
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None
    seed: int = 0
    kv_layout: str = "slot"
    block_size: int = 16
    num_kv_blocks: Optional[int] = None
    prefix_cache: bool = True
    shed_watermark: float = 0.9
    head_skip_limit: int = 0
    head_aging_ticks: int = 16
    speculate_k: int = 0
    role: str = "both"

    def validate(self) -> None:
        if self.kv_layout not in ("slot", "paged"):
            raise ValueError(
                f"kv_layout must be 'slot' or 'paged', got "
                f"{self.kv_layout!r}"
            )
        k = self.speculate_k
        if k < 0 or k == 1:
            raise ValueError(
                f"speculate_k must be 0 (off) or >= 2, got {k}: k = 1 "
                "verifies only the pending token, which is the ordinary "
                "decode step with extra overhead"
            )
        if k > 0 and self.temperature > 0.0:
            raise ValueError(
                f"speculate_k={k} requires greedy sampling "
                f"(temperature 0, got {self.temperature}): greedy "
                "verification is what makes the accepted stream "
                "token-identical to the unspeculated engine"
            )
        if self.role in ("prefill", "decode"):
            raise NotImplementedError(
                f"role={self.role!r}: disaggregated serving is not ported yet"
            )
        if self.role != "both":
            raise ValueError(f"role must be 'both', got {self.role!r}")
        if self.max_prompt_len < 1:
            raise ValueError("max_prompt_len must be >= 1")
        if self.max_prompt_len >= self.max_len:
            raise ValueError(
                f"max_prompt_len ({self.max_prompt_len}) must be < max_len "
                f"({self.max_len}): a full-length prompt still needs room "
                "for at least one generated token"
            )
        if not 0.0 < self.shed_watermark:
            raise ValueError(
                f"shed_watermark must be > 0, got {self.shed_watermark}"
            )
        if self.kv_layout == "paged":
            if self.block_size < 1:
                raise ValueError(
                    f"block_size must be >= 1, got {self.block_size}"
                )
            if self.max_len % self.block_size != 0:
                raise ValueError(
                    f"max_len ({self.max_len}) must be a multiple of "
                    f"block_size ({self.block_size}) for the paged layout"
                )


class Completion:
    """Caller-facing handle: collected tokens + a done event.

    ``tokens`` excludes the prompt. ``finish_reason`` is one of ``"eos"``,
    ``"length"``, ``"error"`` or ``"expired"``. Streaming:
    ``on_token(request_id, token)`` passed at submit is called from the
    engine loop for every sampled token.
    """

    __slots__ = (
        "request_id", "tokens", "finish_reason", "error", "ttft_s", "_done",
        "submitted_at",
    )

    def __init__(self, request_id: str):
        self.request_id = request_id
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.ttft_s: Optional[float] = None
        self.submitted_at = time.perf_counter()
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until finished; returns the generated tokens."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id!r} not finished within {timeout}s"
            )
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    def _finish(self, reason: str,
                error: Optional[BaseException] = None) -> None:
        if self._done.is_set():  # idempotent under racing shutdowns
            return
        self.finish_reason = reason
        self.error = error
        self._done.set()


class InferenceEngine:
    """Continuous batching over one model replica on one device (the card
    unless ``device="cpu"``). ``params`` must already live there."""

    def __init__(self, params: Dict[str, Any], cfg,
                 engine_config: Optional[EngineConfig] = None,
                 device: DeviceLike = None):
        ecfg = engine_config or EngineConfig()
        ecfg.validate()
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on "
                f"{self.device}"
            )
        require_every_expert(params, cfg, "InferenceEngine")
        self.cfg = cfg
        self.engine_config = ecfg
        self.params = params
        self._paged = ecfg.kv_layout == "paged"
        if self._paged:
            self.pool = PagedKVPool(
                cfg, ecfg.num_slots, ecfg.max_len, block_size=ecfg.block_size,
                num_blocks=ecfg.num_kv_blocks, prefix_cache=ecfg.prefix_cache,
                device=self.device,
            )
            bs = ecfg.block_size
            self._n_prompt_blocks = (ecfg.max_prompt_len - 1) // bs + 1
            scratch_len = self._n_prompt_blocks * bs
        else:
            self.pool = KVSlotPool(cfg, ecfg.num_slots, ecfg.max_len,
                                   device=self.device)
            scratch_len = ecfg.max_prompt_len
        self._scratch = init_kv_cache(cfg, 1, scratch_len, device=self.device)
        self.scheduler = ContinuousBatchScheduler(
            self.pool, max_queue=ecfg.max_queue,
            max_prefills_per_tick=ecfg.max_prefills_per_tick,
            head_skip_limit=ecfg.head_skip_limit,
            head_aging_ticks=ecfg.head_aging_ticks,
        )
        self.scheduler.on_evict = self._on_queue_expired
        self.shed_policy = ShedPolicy(queue_watermark=ecfg.shed_watermark)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(ecfg.seed)
        # one rope table for every position a slot can reach, shared by
        # prefill and decode
        self._table = rope_angles(
            ecfg.max_len, cfg.head_dim, cfg.rope_theta,
            scaling=cfg.rope_scaling, device=self.device,
        )
        self._use_fused = fused_sample_supported(
            ecfg.temperature, ecfg.top_k, ecfg.top_p
        )
        self._completions: Dict[str, Completion] = {}
        self._on_token: Dict[str, Callable[[str, int], Any]] = {}
        # prompt-lookup corpus of each request (prompt + delivered tokens),
        # kept only when speculating
        self._history: Dict[str, List[int]] = {}
        self._req_counter = itertools.count()
        self._work = threading.Condition(threading.Lock())
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._stop_when_idle = False
        self._abort = False  # shutdown without drain: leave the loop now
        self.failed: Optional[BaseException] = None
        self.stats: Dict[str, float] = {
            "decode_steps": 0,
            "prefills": 0,
            "tokens_out": 0,
            "busy_slot_steps": 0,
            "completed": 0,
            # accepted_tokens / spec_row_ticks: tokens a slot a verify step
            "accepted_tokens": 0,
            "spec_row_ticks": 0,
        }

    def configure_tenants(self, registry: Any, admission: bool = True) -> None:
        raise NotImplementedError(
            "multi-tenant QoS is not ported yet (single-tenant FIFO only)"
        )

    @staticmethod
    def kernel_launches() -> Dict[str, int]:
        """Launch count of each CUDA kernel of the port, process-wide."""
        return kernels.launch_counts()

    # ------------------------------------------------------------------ #
    # submission
    # ------------------------------------------------------------------ #
    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: int = 16,
               request_id: Optional[str] = None, eos_id: Any = "__default__",
               on_token: Optional[Callable[[str, int], Any]] = None,
               deadline_ms: Optional[float] = None,
               priority: int = 0) -> Completion:
        """Enqueue one request; returns its :class:`Completion`.

        ``deadline_ms`` is a TTL from now (past it the request finishes
        ``"expired"``); ``priority`` 0 is never shed. Raises
        :class:`RequestQueueFull`, :class:`RequestShed`,
        :class:`EngineClosed`, or ``ValueError`` for prompts that do not
        fit."""
        tokens = tuple(int(t) for t in prompt_tokens)
        if not tokens:
            raise ValueError("prompt_tokens must be non-empty")
        if len(tokens) > self.engine_config.max_prompt_len:
            raise ValueError(
                f"prompt length {len(tokens)} exceeds max_prompt_len="
                f"{self.engine_config.max_prompt_len}"
            )
        if eos_id == "__default__":
            eos_id = self.engine_config.eos_id
        if self.shed_policy.should_shed(
            priority=int(priority), queue_depth=self.scheduler.queue_depth,
            max_queue=self.engine_config.max_queue,
        ):
            raise RequestShed(
                f"request shed (priority={priority}): the engine is past "
                "its queue watermark; retry later or raise the priority"
            )
        rid = request_id or f"req-{next(self._req_counter)}"
        completion = Completion(rid)
        req = Request(
            request_id=rid, tokens=tokens, max_new_tokens=int(max_new_tokens),
            eos_id=eos_id, on_token=on_token,
            deadline=(time.perf_counter() + float(deadline_ms) / 1e3
                      if deadline_ms is not None else None),
            priority=int(priority),
        )
        with self._work:
            if self._closed:
                raise EngineClosed(
                    "engine is draining/shut down; no new requests"
                )
            if rid in self._completions:
                raise ValueError(f"duplicate request_id {rid!r}")
            self.scheduler.submit(req)
            self._completions[rid] = completion
            if on_token is not None:
                self._on_token[rid] = on_token
            self._work.notify_all()
        return completion

    # ------------------------------------------------------------------ #
    # one iteration
    # ------------------------------------------------------------------ #
    def _prefill_into(self, tokens: Sequence[int], slot_index: int):
        cfg = self.cfg
        ecfg = self.engine_config
        padded = np.zeros((1, ecfg.max_prompt_len), np.int64)
        padded[0, : len(tokens)] = tokens
        prompt = torch.from_numpy(padded).to(self.device)
        prefill_hidden(self.params, prompt, cfg, self._scratch, self._table)
        if not self._paged:
            # prefill writes positions [0, max_prompt_len) only; the slot's
            # later positions keep a former tenant's entries, which no row
            # attends before decode overwrites them
            P = ecfg.max_prompt_len
            for name in ("k", "v"):
                self.pool.cache[name][:, slot_index, :, :P] = (
                    self._scratch[name][:, 0])
            return
        write_table = self.pool.prompt_write_table(slot_index,
                                                   self._n_prompt_blocks)
        L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        nb, bs = self._n_prompt_blocks, ecfg.block_size
        wt = torch.from_numpy(write_table.astype(np.int64)).to(self.device)
        for name in ("k", "v"):
            # [L, Hkv, nb*bs, hd] -> [L, nb, Hkv, bs, hd]; duplicate trash
            # entries in wt race harmlessly (trash is never read)
            blocks = self._scratch[name][:, 0].view(L, hkv, nb, bs, hd)
            self.pool.cache[name][:, wt] = blocks.transpose(1, 2)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        ecfg = self.engine_config
        if self._use_fused:
            return fused_sample(logits, self.generator, ecfg.temperature,
                                ecfg.top_k, ecfg.top_p)
        return _sample_logits(logits, self.generator, ecfg.temperature,
                              ecfg.top_k, ecfg.top_p)

    def step(self) -> Dict[str, Any]:
        """One scheduler tick: up to N prefills + one batched decode.
        Returns ``{"prefills": int, "decoded": int, "completed": [ids]}``.
        Call from one thread only (the loop thread, or the caller)."""
        self._evict_expired_slots()
        plan = self.scheduler.tick()
        speculate = self.engine_config.speculate_k > 0
        for req, slot in plan.prefills:
            self._prefill_into(req.tokens, slot.index)
            slot.pos = req.prompt_len - 1
            slot.pending_token = req.tokens[-1]
            if speculate:
                self._history[req.request_id] = list(req.tokens)
            self.stats["prefills"] += 1

        completed: List[str] = []
        decode_slots = plan.decode_slots
        if decode_slots:
            self._decode_tick(decode_slots, completed)
            self.stats["decode_steps"] += 1
            self.stats["busy_slot_steps"] += len(decode_slots)
        return {
            "prefills": len(plan.prefills),
            "decoded": len(decode_slots),
            "completed": completed,
        }

    def _decode_tick(self, decode_slots, completed: List[str]) -> None:
        """One batched decode over every slot (free ones ride along at token
        0, position 0; on a trash table row, for the paged layout). Without
        speculation, one token a slot through ``decode_step_paged`` or
        ``decode_step_ragged``. With ``speculate_k = K``, each slot's
        pending token and up to K - 1 proposals through one
        ``decode_step_verify``, greedy sampling of all [S * K] positions and
        greedy acceptance: out[j] is the model's token after consuming the
        proposals before j, so the first mismatch ends the accepted prefix
        and is delivered as its correction."""
        K = max(self.engine_config.speculate_k, 1)
        n = self.pool.num_slots
        token = np.zeros((n, K), np.int32)
        pos = np.zeros((n,), np.int32)
        proposals: Dict[int, List[int]] = {}
        for slot in decode_slots:
            props: List[int] = []
            if K > 1:
                # a row delivers at most `remaining` tokens this tick, so it
                # proposes at most remaining - 1: this also keeps every
                # speculative write inside the blocks reserved at admission
                remaining = slot.max_new_tokens - slot.generated
                props = ngram_propose(self._history.get(slot.request_id, ()),
                                      min(K - 1, remaining - 1))
            proposals[slot.index] = props
            if self._paged:
                # on-demand growth: the blocks up to the deepest write must
                # be physical before the step writes them
                self.pool.ensure_writable(slot, upto_pos=slot.pos + len(props))
            token[slot.index, 0] = slot.pending_token
            token[slot.index, 1:1 + len(props)] = props
            pos[slot.index] = slot.pos
        dev = self.device
        token_d = torch.from_numpy(token).to(dev)
        pos_d = torch.from_numpy(pos).to(dev)
        tables = (torch.from_numpy(self.pool.block_tables).to(dev)
                  if self._paged else None)
        if K > 1:
            logits, _ = decode_step_verify(
                self.params, self.pool.cache, token_d, pos_d, self.cfg,
                self._table, block_tables=tables)
            logits = logits.view(n * K, -1)
        elif self._paged:
            logits, _ = decode_step_paged(
                self.params, self.pool.cache, token_d[:, 0], pos_d, tables,
                self.cfg, self._table)
        else:
            logits, _ = decode_step_ragged(
                self.params, self.pool.cache, token_d[:, 0], pos_d, self.cfg,
                self._table)
        sampled = self._sample(logits).view(n, K).cpu().numpy()  # the sync
        now = time.perf_counter()
        for slot in decode_slots:
            rid = slot.request_id
            if rid is None:  # released re-entrantly by a callback
                continue
            out = sampled[slot.index]
            accepted = 1
            for j, p in enumerate(proposals[slot.index]):
                if int(out[j]) != int(p):
                    break
                accepted += 1
            before = self.stats["tokens_out"]
            for j in range(accepted):
                if not self._deliver_token(slot, rid, int(out[j]), now,
                                           completed):
                    break  # EOS, length, or the callback detached it
            if K > 1:
                self.stats["spec_row_ticks"] += 1
                self.stats["accepted_tokens"] += (self.stats["tokens_out"]
                                                  - before)

    def _deliver_token(self, slot, rid: str, tok: int, now: float,
                       completed: List[str]) -> bool:
        """Deliver one sampled token to the slot's request. Returns False
        once the slot stops consuming tokens (finished on EOS or length, or
        detached by its callback), which cuts the rest of a speculative
        burst: tokens past EOS are never delivered."""
        completion = self._completions.get(rid)
        if completion is not None and not completion.done:
            completion.tokens.append(tok)
            if completion.ttft_s is None:
                completion.ttft_s = now - completion.submitted_at
            cb = self._on_token.get(rid)
            if cb is not None:
                try:
                    cb(rid, tok)
                except Exception:  # a broken consumer must not stall decode
                    pass
            if slot.request_id != rid:
                return False  # the callback finished this request
        slot.generated += 1
        slot.pos += 1
        slot.pending_token = tok
        hist = self._history.get(rid)
        if hist is not None:
            hist.append(tok)
        self.stats["tokens_out"] += 1
        reason = None
        if slot.eos_id is not None and tok == slot.eos_id:
            reason = "eos"
        elif slot.generated >= slot.max_new_tokens:
            reason = "length"
        if reason is not None:
            completed.append(rid)
            self._finish(rid, reason)
            self.pool.release(slot.index)
            return False
        return True

    def _finish(self, request_id: str, reason: str,
                error: Optional[BaseException] = None) -> None:
        completion = self._completions.pop(request_id, None)
        self._on_token.pop(request_id, None)
        self._history.pop(request_id, None)
        if completion is not None:
            completion._finish(reason, error)
        self.stats["completed"] += 1

    # ------------------------------------------------------------------ #
    # deadlines
    # ------------------------------------------------------------------ #
    def _on_queue_expired(self, req: Request) -> None:
        self._finish(req.request_id, "expired")

    def _evict_expired_slots(self) -> None:
        now = time.perf_counter()
        for slot in self.pool.active_slots():
            if slot.deadline is not None and now > slot.deadline:
                self._finish(slot.request_id, "expired")
                self.pool.release(slot.index)

    # ------------------------------------------------------------------ #
    # loop thread + lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> None:
        """Spawn the serving loop thread (idempotent)."""
        with self._work:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="rlt-torch-serve-engine"
            )
            self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._work:
                while self._abort or not self.scheduler.has_work():
                    if self._abort or self._stop_when_idle:
                        return
                    self._work.wait(timeout=0.05)
            try:
                self.step()
            except Exception as e:  # fail every in-flight request loudly
                self._fail_all(e)
                return

    def _fail_all(self, error: BaseException) -> None:
        self.failed = error
        for req in self.scheduler.drain_queue():
            self._finish(req.request_id, "error", error)
        for slot in self.pool.active_slots():
            self._finish(slot.request_id, "error", error)
            self.pool.release(slot.index)

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        """Single-threaded drive: step until queue and pool are empty."""
        for _ in range(max_steps):
            if not self.scheduler.has_work():
                return
            self.step()
        raise RuntimeError(f"still busy after {max_steps} steps")

    def drain(self, timeout: Optional[float] = 60.0) -> None:
        """Stop admitting; finish in-flight and queued work; stop the loop."""
        with self._work:
            self._closed = True
            self._stop_when_idle = True
            thread = self._thread
            self._work.notify_all()
        if thread is not None:
            thread.join(timeout)
        else:
            self.run_until_idle()

    def shutdown(self, drain: bool = True) -> None:
        """``drain=False`` fails queued and in-flight requests instead of
        finishing them."""
        if drain:
            self.drain()
            return
        with self._work:
            self._closed = True
            self._abort = True
            thread = self._thread
            self._work.notify_all()
        if thread is not None:
            thread.join(60.0)  # at most the step in flight
        self._fail_all(EngineClosed("engine shut down without drain"))
