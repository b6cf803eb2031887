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

Disaggregated serving (``EngineConfig.role``, paged layout): a
``"prefill"`` engine parks each freshly prefilled slot (its chain blocks
pinned, its row pointed at the trash block in the table the decode step is
launched with, so no padding write lands in its blocks) and lists it in
:meth:`InferenceEngine.drain_ready_exports`; a pump reads it with
:meth:`~InferenceEngine.export_shipment` (one gather of the prompt blocks
and one device-to-host copy, on the engine's stream, after the prefill's
writes), hands it to a decode engine's :meth:`~InferenceEngine.
import_shipment`, and then calls :meth:`~InferenceEngine.finish_export`
(the source completion ends ``"migrated"``) or
:meth:`~InferenceEngine.cancel_export` (the request decodes in place). An
import passes the JAX package's gates in order: the caller's thread
verifies the checksums and stages the payload on the host, then the
receiver's loop thread passes the fault point, reserves, and writes the
device cache (one host-to-device copy and an ``index_copy_`` on the block
axis a cache tensor), so the write is ordered before its next decode step.
Two engines may share one card and one params dict. Each engine's ticks
launch on the stream that was current where it was constructed: the
legacy default stream unless the constructing thread made another one
current, so two engines constructed on one thread never overlap their
kernels.

Multi-tenant QoS (:meth:`InferenceEngine.configure_tenants`): per-tenant
DRR queues, tenant classes in the shed policy, token-bucket quotas at
submit (:class:`~.tenancy.QuotaExceeded`). Scripted serving faults
(``TORCHRT_FAULT`` ``replica<R>:`` specs, ``runtime/faults.py``) fire in an
engine built with ``replica_index=R``. The JAX engine's ``compile_stats``
(its jit caches) has no counterpart.

Telemetry (``observability.enable()`` before the engine is built): a
:class:`~ray_lightning_tpu_torch.observability.reqtrace.RequestTracer`
traces each head-sampled request (its ``requests.jsonl`` records, drained by
:meth:`InferenceEngine.drain_request_records`, and its Perfetto track), a
goodput ledger classifies the engine's wall time, the ``serve_prefill`` and
``serve_decode`` spans go to the trace ring, and the ``rlt_serve_*`` and
``rlt_tenant_*`` series (TTFT and ITL histograms with exemplars, tokens,
requests, completions, sheds, quota refusals, expiries, the pools' gauges)
to the metrics registry. An ``slo_monitor`` set on the engine sheds
priority >= 1 work while its serving objectives burn. With telemetry off
every site is one ``is None`` check, and none of them reads the device: the
tick's one synchronisation stays the sampled tokens' copy to the host.

Threading: ``submit`` and ``import_shipment`` may be called from any
thread; ``start()`` spawns the loop thread (a daemon, joined by
``drain``/``shutdown``), or call ``step()`` / ``run_until_idle()``
yourself.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_lightning_tpu_torch import kernels
from ray_lightning_tpu_torch import observability as _obs
from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.observability import metrics as _metrics
from ray_lightning_tpu_torch.observability import reqtrace as _reqtrace
from ray_lightning_tpu_torch.runtime import faults as _faults
from ray_lightning_tpu_torch.serving import migration as _migration
from ray_lightning_tpu_torch.models.generation import (
    _sample_logits,
    decode_step_paged,
    decode_step_ragged,
    decode_step_verify,
    init_kv_cache,
    prefill_hidden,
    require_every_expert,
)
from ray_lightning_tpu_torch.ops.attention import FLASH_FWD_KERNEL
from ray_lightning_tpu_torch.ops.paged_attention import (
    ARGMAX_KERNEL,
    PAGED_DECODE_KERNEL,
    fused_sample,
    fused_sample_supported,
)
from ray_lightning_tpu_torch.ops.rmsnorm import RMSNORM_KERNEL
from ray_lightning_tpu_torch.ops.rope import rope_angles
from ray_lightning_tpu_torch.serving.kv_pool import KVSlotPool
from ray_lightning_tpu_torch.serving.paged_kv import TRASH_BLOCK, PagedKVPool
from ray_lightning_tpu_torch.serving.resilience import RequestShed, ShedPolicy
from ray_lightning_tpu_torch.serving.scheduler import (
    ContinuousBatchScheduler,
    Request,
    RequestQueueFull,
)
from ray_lightning_tpu_torch.serving.speculative import ngram_propose
from ray_lightning_tpu_torch.serving.tenancy import QuotaExceeded

__all__ = [
    "Completion",
    "EngineClosed",
    "EngineConfig",
    "InferenceEngine",
    "RequestQueueFull",
    "RequestShed",
]


# TTFT and ITL land in seconds; bounds down to 0.5 ms for the fast end
LATENCY_BOUNDS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

# tokens a slot delivers a verify step (1 = no proposal accepted)
ACCEPTED_BOUNDS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)


class EngineClosed(RuntimeError):
    """submit() after drain/shutdown."""


# numpy's name of a cache dtype, as the KV fingerprint names it, and the
# host dtype a payload travels in (bf16 as its raw 16-bit words)
_WIRE = {
    torch.float32: ("float32", np.float32),
    torch.bfloat16: ("bfloat16", np.uint16),
    torch.float16: ("float16", np.float16),
}


def _to_wire(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the numpy array a shipment carries."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _check_wire(shipment, dtype: torch.dtype) -> None:
    """Refuse payloads whose element size is not the cache's."""
    size = torch.empty((), dtype=dtype).element_size()
    for a in shipment.block_k + shipment.block_v:
        if np.asarray(a).dtype.itemsize != size:
            raise _migration.ShipmentMismatch(
                f"shipment {shipment.request_id!r}: payload of "
                f"{np.asarray(a).dtype} for a {dtype} cache")


def _from_wire(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A shipment payload (the port's ``uint16`` words, or any array of the
    cache's element size, a bf16 one of the JAX package's included) as a
    host tensor of ``dtype``, bit for bit."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.view(_WIRE[dtype][1]))


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
    one pass (greedy sampling only). ``role``: ``"both"`` (the colocated
    engine), ``"prefill"`` (prefill and park each request for a KV shipment
    to a decode engine, keeping decode as the fallback; paged layout only)
    or ``"decode"`` (the colocated engine that also takes shipments).
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
    role: str = "both"  # "both" | "prefill" | "decode" (disaggregation)

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
        if self.role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"role must be 'both', 'prefill' or 'decode', got "
                f"{self.role!r}"
            )
        if self.role == "prefill" and self.kv_layout != "paged":
            raise ValueError(
                "role='prefill' requires kv_layout='paged': KV shipments "
                "are paged block chains (the slot layout has no block "
                "granularity to ship)"
            )
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
    ``"length"``, ``"error"``, ``"expired"``, ``"cancelled"`` (handed back
    by :meth:`InferenceEngine.handback_queued`) or ``"migrated"`` (a
    prefill engine's request that a decode engine took over). Streaming:
    ``on_token(request_id, token)`` passed at submit is called from the
    engine loop for every sampled token.
    """

    __slots__ = (
        "request_id", "tokens", "finish_reason", "error", "ttft_s", "tenant",
        "_done", "submitted_at",
    )

    def __init__(self, request_id: str, tenant: Optional[str] = None):
        self.request_id = request_id
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.ttft_s: Optional[float] = None
        self.tenant = tenant
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


class _ImportTicket:
    """One cross-thread KV import: the caller of
    :meth:`InferenceEngine.import_shipment` verifies and stages the payload,
    then waits on ``event`` while the loop admits it (fault point,
    reservation, device write, resume), so pool and allocator state change
    on the loop thread alone. A caller that gave up waiting sets
    ``abandoned`` and the loop skips it."""

    __slots__ = (
        "shipment", "request_id", "max_new_tokens", "eos_id", "on_token",
        "deadline_ms", "priority", "retries", "payload", "completion",
        "error", "abandoned", "event",
    )

    def __init__(self, shipment, request_id, max_new_tokens, eos_id,
                 on_token, deadline_ms, priority, retries):
        self.shipment = shipment
        self.request_id = request_id
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.on_token = on_token
        self.deadline_ms = deadline_ms
        self.priority = int(priority)
        self.retries = int(retries)
        # the verified payloads, staged on the host by the caller
        self.payload: Optional[Dict[str, torch.Tensor]] = None
        self.completion: Optional[Completion] = None
        self.error: Optional[BaseException] = None
        self.abandoned = False
        self.event = threading.Event()


class InferenceEngine:
    """Continuous batching over one model replica on one device (the card
    unless ``device="cpu"``). ``params`` must already live there.
    ``replica_index`` names the engine to the ``replica<R>:`` fault specs
    (None: no serving fault fires)."""

    def __init__(self, params: Dict[str, Any], cfg,
                 engine_config: Optional[EngineConfig] = None,
                 device: DeviceLike = None,
                 replica_index: Optional[int] = None):
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
        self.kv_layout = ecfg.kv_layout
        self._paged = ecfg.kv_layout == "paged"
        # the stream the engine's work is ordered on (the constructing
        # thread's current one): every tick launches on it, and an export
        # reads on it, after the prefill's writes
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
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
        self.replica_index = replica_index
        self.shed_policy = ShedPolicy(queue_watermark=ecfg.shed_watermark)
        # multi-tenant QoS: None until configure_tenants installs a registry
        self._tenancy: Optional[Any] = None
        self._tenancy_admission = False
        # an SLOMonitor whose serving breach sheds priority >= 1 work
        self.slo_monitor: Optional[Any] = None
        self._ticks = 0
        self._admit_seq = 0
        # request_id -> the token budget a drop-stream fault armed
        self._drop_stream: Dict[str, int] = {}
        # recent first-token and inter-token latencies (load())
        self._recent_ttfts: deque = deque(maxlen=128)
        self._recent_itls: deque = deque(maxlen=256)
        # disaggregated serving, guarded by self._work; the loop thread is
        # the only one that changes pool or allocator state
        self._role = ecfg.role
        # rid -> {"slot", "pinned" chain keys, "prompt"} of a parked prefill
        self._exports: Dict[str, Dict[str, Any]] = {}
        self._ready_exports: List[str] = []
        self._export_actions: List[tuple] = []  # (rid, "finish" | "cancel")
        self._pending_imports: List[_ImportTicket] = []
        self._import_seq = 0
        # bumped under self._work by every call that hands the loop work
        self._wake_seq = 0
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
        # request tracing: None with telemetry off, so every trace site is
        # one attribute check
        self._tracer: Optional[_reqtrace.RequestTracer] = (
            _reqtrace.RequestTracer(
                pool=self._role if self._role in ("prefill", "decode")
                else "serve")
            if _obs.enabled() else None
        )
        # the goodput ledger of the engine's wall time; a relaunch under the
        # same replica index adopts its predecessor's totals
        self._goodput = (
            _obs.goodput.new_ledger(
                f"serve{replica_index}" if replica_index is not None
                else "serve", category="idle")
            if _obs.enabled() else None
        )
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
        """Install a :class:`~.tenancy.TenantRegistry`: the scheduler admits
        by DRR over per-tenant queues, the shed policy reads tenant classes
        and, with ``admission``, submit charges each request to its
        tenant's token bucket. A front door that charges the quota itself
        passes ``admission=False``, so no request is billed twice."""
        self._tenancy = registry
        self._tenancy_admission = bool(admission) and registry is not None
        self.scheduler.configure_tenants(registry)

    def _notify(self) -> None:
        """Wake the loop (call with self._work held)."""
        self._wake_seq += 1
        self._work.notify_all()

    @staticmethod
    def kernel_launches() -> Dict[str, int]:
        """Launch count of each CUDA kernel of the port, process-wide."""
        return kernels.launch_counts()

    def _kernels(self) -> List[Any]:
        """The CUDA kernels this engine's paths launch: RMSNorm and flash
        forward (prefill), paged decode (the paged one-token decode step)
        and argmax (the fused sampler)."""
        out = [RMSNORM_KERNEL, FLASH_FWD_KERNEL]
        if self._paged and self.engine_config.speculate_k == 0:
            out.append(PAGED_DECODE_KERNEL)
        if self._use_fused:
            out.append(ARGMAX_KERNEL)
        return out

    def warmup(self) -> List[str]:
        """Load, on a CUDA device, the libraries of the kernels the engine's
        paths launch (built first when stale), so that the first request
        pays no nvcc build and no ``dlopen``; a replica calls this before
        it becomes routable. Executes nothing, launches nothing, and leaves
        ``stats`` and the launch counts as they were. Returns the names of
        the kernels loaded (none on the CPU, whose paths are plain torch)."""
        if self.device.type != "cuda":
            return []
        names = []
        for kernel in self._kernels():
            kernel.load()
            names.append(kernel.name)
        return names

    def drain_request_records(self) -> List[Dict[str, Any]]:
        """Pop the finished requests' trace records (``requests.jsonl``
        lines); none with telemetry off. A replica's beat loop ships them;
        a local caller hands them to
        ``observability.aggregator.write_local_dump``."""
        if self._tracer is None:
            return []
        return self._tracer.drain()

    # ------------------------------------------------------------------ #
    # submission
    # ------------------------------------------------------------------ #
    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: int = 16,
               request_id: Optional[str] = None, eos_id: Any = "__default__",
               on_token: Optional[Callable[[str, int], Any]] = None,
               deadline_ms: Optional[float] = None,
               priority: int = 0, retries: int = 0,
               trace_ctx: Optional[_reqtrace.TraceContext] = None,
               tenant: Optional[str] = None) -> Completion:
        """Enqueue one request; returns its :class:`Completion`.

        ``deadline_ms`` is a TTL from now (past it the request finishes
        ``"expired"``); ``priority`` 0 is never shed; ``retries`` is the
        journal's attempt number; ``trace_ctx`` is the fleet's lineage
        context of the hop (its parent attempt, hop index and upstream TTFT
        components; observability only); ``tenant`` names the submitting
        tenant once a registry is installed (its DRR queue, shed class,
        quota and per-tenant metric labels).
        Raises :class:`RequestQueueFull`, :class:`RequestShed`,
        :class:`~.tenancy.QuotaExceeded`, :class:`EngineClosed`, or
        ``ValueError`` for prompts that do not fit."""
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
        tenant_class = None
        if self._tenancy is not None:
            tenant_class = self._tenancy.tenant_class(tenant)
            reg = _obs.registry()
            if reg is not None and tenant is not None:
                reg.counter(_metrics.TENANT_REQUESTS_METRIC,
                            tenant=reg.tenant_label(tenant)).inc()
            if self._tenancy_admission and not self._tenancy.admit(tenant):
                if reg is not None and tenant is not None:
                    reg.counter(_metrics.TENANT_QUOTA_REJECTED_METRIC,
                                tenant=reg.tenant_label(tenant)).inc()
                raise QuotaExceeded(
                    f"tenant {tenant!r} exceeded its admission quota "
                    "(token bucket empty); retry after the bucket refills"
                )
        if self.shed_policy.should_shed(
            priority=int(priority), queue_depth=self.scheduler.queue_depth,
            max_queue=self.engine_config.max_queue,
            slo_breached=self._slo_breached(),
            tenant_class=tenant_class,
        ):
            reg = _obs.registry()
            if reg is not None:
                reg.counter(_metrics.SERVE_SHED_METRIC).inc()
                if self._tenancy is not None and tenant is not None:
                    reg.counter(_metrics.TENANT_SHED_METRIC,
                                tenant=reg.tenant_label(tenant)).inc()
            raise RequestShed(
                f"request shed (priority={priority}): the engine is past "
                "its queue watermark or burning SLO budget; retry later or "
                "raise the priority"
            )
        rid = request_id or f"req-{next(self._req_counter)}"
        completion = Completion(rid, tenant=tenant)
        req = Request(
            request_id=rid, tokens=tokens, max_new_tokens=int(max_new_tokens),
            eos_id=eos_id, on_token=on_token,
            deadline=(time.perf_counter() + float(deadline_ms) / 1e3
                      if deadline_ms is not None else None),
            priority=int(priority), retries=int(retries), tenant=tenant,
        )
        if self._tracer is not None:
            req.trace = self._tracer.start(
                rid, len(tokens), int(max_new_tokens),
                replica=self.replica_index, retries=int(retries),
                ctx=trace_ctx, tenant=tenant,
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
            self._notify()
        reg = _obs.registry()
        if reg is not None:
            reg.counter("rlt_serve_requests_total").inc()
        return completion

    # ------------------------------------------------------------------ #
    # one iteration
    # ------------------------------------------------------------------ #
    def _prefill_into(self, tokens: Sequence[int], slot_index: int):
        ecfg = self.engine_config
        padded = np.zeros((1, ecfg.max_prompt_len), np.int64)
        padded[0, : len(tokens)] = tokens
        prompt = torch.from_numpy(padded).to(self.device)
        where: Any = slot_index
        if self._paged:
            write_table = self.pool.prompt_write_table(slot_index,
                                                       self._n_prompt_blocks)
            where = torch.from_numpy(write_table.astype(np.int64)).to(
                self.device)
        self._prefill_program(self.params, self.pool.cache, self._scratch,
                              prompt, where, self._table)

    def _prefill_program(self, params, cache, scratch, prompt, where,
                         table) -> None:
        """The ``serve_prefill`` program: the padded prompt [1, P] through
        every layer into ``scratch``, then into the pool: at slot ``where``
        (the slot layout) or through the write table ``where`` [nb] (the
        paged layout)."""
        cfg = self.cfg
        ecfg = self.engine_config
        prefill_hidden(params, prompt, cfg, scratch, table)
        if not self._paged:
            # prefill writes positions [0, max_prompt_len) only; the slot's
            # later positions keep a former tenant's entries, which no row
            # attends before decode overwrites them
            P = ecfg.max_prompt_len
            for name in ("k", "v"):
                cache[name][:, where, :, :P] = scratch[name][:, 0]
            return
        L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        nb, bs = self._n_prompt_blocks, ecfg.block_size
        for name in ("k", "v"):
            # [L, Hkv, nb*bs, hd] -> [L, nb, Hkv, bs, hd]; duplicate trash
            # entries in the write table race harmlessly (trash is never
            # read)
            blocks = scratch[name][:, 0].view(L, hkv, nb, bs, hd)
            cache[name][:, where] = blocks.transpose(1, 2)

    def _decode_program(self, params, cache, token, pos, tables, table,
                        sample: Callable[[torch.Tensor], torch.Tensor]
                        ) -> torch.Tensor:
        """The ``serve_decode`` program: one batched step over every slot
        (token [n, K] int32, pos [n], the paged layout's tables [n,
        max_blocks]) and ``sample`` of its logits; [n * K] tokens."""
        n = token.shape[0]
        if token.shape[1] > 1:
            logits, _ = decode_step_verify(
                params, cache, token, pos, self.cfg, table,
                block_tables=tables)
            logits = logits.view(n * token.shape[1], -1)
        elif self._paged:
            logits, _ = decode_step_paged(
                params, cache, token[:, 0], pos, tables, self.cfg, table)
        else:
            logits, _ = decode_step_ragged(
                params, cache, token[:, 0], pos, self.cfg, table)
        return sample(logits)

    def _program_specs(self):
        """``(name, fn, args)`` of both serving programs, with meta tensors
        of exactly the shapes and dtypes that :meth:`step` gives them (the
        parameters, the pool, the scratch cache, the prompt, the write table
        or slot, the tokens, positions and tables, the rope table): the
        programs :meth:`cost_summary` counts are the ones the serving loop
        runs. Sampling takes no generator on meta (the noise of a
        temperature > 0 is drawn on the device, as in the loop)."""
        to_meta = _obs.profiler.to_meta
        ecfg = self.engine_config
        n = self.pool.num_slots
        K = max(ecfg.speculate_k, 1)
        params, cache = to_meta(self.params), to_meta(self.pool.cache)
        table = to_meta(self._table)
        prompt = torch.empty((1, ecfg.max_prompt_len), dtype=torch.int64,
                             device="meta")
        where: Any = 0
        tables = None
        if self._paged:
            where = torch.empty((self._n_prompt_blocks,), dtype=torch.int64,
                                device="meta")
            tables = torch.empty(self.pool.block_tables.shape,
                                 dtype=torch.int32, device="meta")
        token = torch.empty((n, K), dtype=torch.int32, device="meta")
        pos = torch.empty((n,), dtype=torch.int32, device="meta")

        def sample(logits):
            if self._use_fused:
                return fused_sample(logits, None, ecfg.temperature,
                                    ecfg.top_k, ecfg.top_p)
            return _sample_logits(logits, None, ecfg.temperature, ecfg.top_k,
                                  ecfg.top_p)

        return (
            ("serve_prefill", self._prefill_program,
             (params, cache, to_meta(self._scratch), prompt, where, table)),
            ("serve_decode", self._decode_program,
             (params, cache, token, pos, tables, table, sample)),
        )

    def cost_summary(self) -> Dict[str, Any]:
        """The counted cost of the two serving programs
        (``observability.profiler.analyze_program`` on meta tensors of the
        tick's shapes, :meth:`_program_specs`): publishes the
        ``rlt_step_flops``/``rlt_step_bytes`` gauges labelled
        ``program=serve_prefill|serve_decode`` (with telemetry on) and
        returns each program's report with its analytic roofline on this
        engine's device (``None`` for a program that cannot be counted). The
        decode step is counted with every row at its table's full length
        (the meta trace knows no positions). Runs nothing on the device and
        leaves ``stats``, the pool, the allocator and the launch counts as
        they were."""
        profiler = _obs.profiler
        out: Dict[str, Any] = {}
        reg = _obs.registry()
        for name, fn, args in self._program_specs():
            rep = profiler.analyze_program(fn, *args, program=name)
            if rep is None:
                out[name] = None
                continue
            if reg is not None:
                profiler.publish_cost_report(reg, rep, device=self.device)
            d = rep.to_dict()
            d["roofline"] = profiler.roofline(rep, device=self.device)
            out[name] = d
        return out

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
        Call from one thread only (the loop thread, or the caller). The
        tick's device work is queued on the engine's stream."""
        with self._stream_scope():
            return self._step()

    def _step(self) -> Dict[str, Any]:
        self._ticks += 1
        if self._goodput is not None:
            self._goodput.enter("productive_compute")
        # scripted serving faults: a crash raises out of step(), the loop
        # fails every in-flight request and dies
        _faults.fire_serve_tick_faults(self.replica_index, self._ticks)
        self._process_export_actions()
        self._process_imports()
        self._evict_expired_slots()
        plan = self.scheduler.tick()
        speculate = self.engine_config.speculate_k > 0
        new_exports: List[str] = []
        for req, slot in plan.prefills:
            self._admit_seq += 1
            fspec = _faults.serve_request_fault(self.replica_index,
                                                self._admit_seq)
            if fspec is not None and fspec.kind == "drop-stream":
                self._drop_stream[req.request_id] = max(1, int(fspec.arg or 1))
            tr = req.trace
            t0 = time.perf_counter() if tr is not None else 0.0
            with _obs.span("serve_prefill", prompt_len=req.prompt_len):
                self._prefill_into(req.tokens, slot.index)
            if tr is not None:
                # the host's time to queue the prefill: its device time
                # lands in the first token's "decode" component
                tr.prefilled(time.perf_counter() - t0)
            slot.pos = req.prompt_len - 1
            slot.pending_token = req.tokens[-1]
            if speculate:
                self._history[req.request_id] = list(req.tokens)
            if self._role == "prefill":
                # park the slot for migration and pin its chains now (the
                # loop thread, serialized with every allocator operation),
                # so a sibling's release cannot leave them to eviction
                # while the shipment is in flight
                slot.export_pending = True
                pinned = self.pool.allocator.pin_request(req.request_id)
                with self._work:
                    self._exports[req.request_id] = {
                        "slot": slot.index, "pinned": pinned,
                        "prompt": tuple(req.tokens),
                    }
                new_exports.append(req.request_id)
            self.stats["prefills"] += 1

        # parked slots are not decoded here, not even the first decode of
        # this tick's prefills (the receiver would repeat that token). A
        # no-op for the "both" and "decode" roles.
        decode_slots = plan.decode_slots
        parked: List[int] = []
        if self._role == "prefill":
            decode_slots = [s for s in decode_slots if not s.export_pending]
            parked = [s.index for s in self.pool.slots
                      if s.occupied and s.export_pending]

        completed: List[str] = []
        if decode_slots:
            # counted before the tick delivers its tokens: a thread that
            # sees one of this tick's completions resolve (or its slot
            # freed) sees the step counted too
            self.stats["decode_steps"] += 1
            self.stats["busy_slot_steps"] += len(decode_slots)
            self._decode_tick(decode_slots, completed, parked)
        if new_exports:
            # published after this tick's prefill writes were queued on the
            # engine's stream, which export_shipment reads on
            with self._work:
                self._ready_exports.extend(new_exports)
                self._notify()
        return {
            "prefills": len(plan.prefills),
            "decoded": len(decode_slots),
            "completed": completed,
        }

    def _decode_tick(self, decode_slots, completed: List[str],
                     parked: Sequence[int] = ()) -> None:
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
        tables = None
        if self._paged:
            # a parked row rides the step as padding (token 0, position 0):
            # in the table the step is launched with it points at the trash
            # block, or the padding write would land in the request's first
            # prompt block. The copy is taken after this tick's growth.
            block_tables = self.pool.block_tables
            if parked:
                block_tables = block_tables.copy()
                block_tables[list(parked), :] = TRASH_BLOCK
            tables = torch.from_numpy(block_tables).to(dev)
        with _obs.span("serve_decode"):
            sampled = self._decode_program(
                self.params, self.pool.cache, token_d, pos_d, tables,
                self._table, self._sample).view(n, K).cpu().numpy()  # sync
        now = time.perf_counter()
        reg = _obs.registry()
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
                if not self._deliver_token(slot, rid, int(out[j]), now, reg,
                                           completed):
                    break  # EOS, length, or the callback detached it
            if K > 1:
                delivered = int(self.stats["tokens_out"] - before)
                self.stats["spec_row_ticks"] += 1
                self.stats["accepted_tokens"] += delivered
                if delivered > 0 and reg is not None:
                    reg.histogram("rlt_serve_accepted_tokens",
                                  bounds=ACCEPTED_BOUNDS).observe(
                        float(delivered), exemplar=rid)

    def _deliver_token(self, slot, rid: str, tok: int, now: float, reg,
                       completed: List[str]) -> bool:
        """Deliver one sampled token to the slot's request. Returns False
        once the slot stops consuming tokens (its stream cut by a scripted
        drop-stream fault, finished on EOS or length, or detached by its
        callback), which cuts the rest of a speculative burst: tokens past
        EOS are never delivered."""
        drop_after = self._drop_stream.get(rid)
        if drop_after is not None and slot.generated >= drop_after:
            # the stream dies here: this token is never delivered, and a
            # journal resumes from the tokens the client has
            self._drop_stream.pop(rid, None)
            completed.append(rid)
            self._finish(rid, "error", _faults.ServeFault(
                f"scripted serving fault: {rid} stream dropped after "
                f"{slot.generated} tokens"))
            if slot.trace is not None:
                self._tracer.finish(slot.trace, "error")
            self.pool.release(slot.index)
            return False
        completion = self._completions.get(rid)
        if completion is not None and not completion.done:
            completion.tokens.append(tok)
            if completion.ttft_s is None:
                completion.ttft_s = now - completion.submitted_at
                self._recent_ttfts.append(completion.ttft_s)
                if reg is not None:
                    reg.histogram("rlt_serve_ttft_seconds",
                                  bounds=LATENCY_BOUNDS).observe(
                        completion.ttft_s, exemplar=rid)
                    if (self._tenancy is not None
                            and completion.tenant is not None):
                        reg.histogram(
                            _metrics.TENANT_TTFT_METRIC,
                            bounds=LATENCY_BOUNDS,
                            tenant=reg.tenant_label(completion.tenant),
                        ).observe(completion.ttft_s, exemplar=rid)
                if (self.slo_monitor is not None
                        and self._tenancy is not None
                        and completion.tenant is not None):
                    try:
                        self.slo_monitor.observe_latency(
                            f"tenant_ttft_{completion.tenant}",
                            completion.ttft_s)
                    except Exception:
                        pass  # no objective for this tenant
            elif slot.last_token_at is not None:
                itl = now - slot.last_token_at
                self._recent_itls.append(itl)
                if reg is not None:
                    reg.histogram("rlt_serve_itl_seconds",
                                  bounds=LATENCY_BOUNDS).observe(
                        itl, exemplar=rid)
            cb = self._on_token.get(rid)
            if cb is not None:
                try:
                    cb(rid, tok)
                except Exception:  # a broken consumer must not stall decode
                    pass
            if slot.request_id != rid:
                return False  # the callback finished this request
        slot.last_token_at = now
        tr = slot.trace
        if tr is not None:
            tr.token()
        slot.generated += 1
        slot.pos += 1
        slot.pending_token = tok
        hist = self._history.get(rid)
        if hist is not None:
            hist.append(tok)
        self.stats["tokens_out"] += 1
        if reg is not None:
            reg.counter("rlt_serve_tokens_total").inc()
        reason = None
        if slot.eos_id is not None and tok == slot.eos_id:
            reason = "eos"
        elif slot.generated >= slot.max_new_tokens:
            reason = "length"
        if reason is not None:
            completed.append(rid)
            self._finish(rid, reason)
            if tr is not None:
                self._tracer.finish(tr, reason)
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
        reg = _obs.registry()
        if reg is not None:
            reg.counter("rlt_serve_completions_total", reason=reason).inc()
            if (self._tenancy is not None and completion is not None
                    and completion.tenant is not None):
                reg.counter(_metrics.TENANT_COMPLETIONS_METRIC,
                            tenant=reg.tenant_label(completion.tenant),
                            reason=reason).inc()

    # ------------------------------------------------------------------ #
    # disaggregated serving: KV export (prefill role) and import
    # ------------------------------------------------------------------ #
    def kv_fingerprint(self) -> str:
        """The engine and layout identity a KV shipment must match to be
        admitted, equal to the JAX package's for the same engine (paged
        layout only: shipments are block chains)."""
        if not self._paged:
            raise ValueError("kv_fingerprint requires kv_layout='paged'")
        cfg = self.cfg
        return _migration.kv_fingerprint(
            self.kv_layout, self.pool.block_size,
            (cfg.n_layers, cfg.n_kv_heads, self.pool.block_size,
             cfg.head_dim),
            _WIRE[self.pool.cache["k"].dtype][0], self.pool.max_len,
        )

    def drain_ready_exports(self) -> List[str]:
        """Pop the request ids whose prefill finished and whose KV is ready
        to ship (the prefill role; empty otherwise)."""
        with self._work:
            out = self._ready_exports
            self._ready_exports = []
        return out

    def _stream_scope(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def export_shipment(self, request_id: str) -> "_migration.KVShipment":
        """A parked prefill's prompt-block KV as a checksummed
        :class:`~.migration.KVShipment`, callable from any thread.

        The block list is read under the engine's lock; the blocks are
        gathered by one ``index_select`` a cache tensor into one buffer and
        copied to the host once, on the engine's stream, so after the
        prefill's writes. The cache is written in place, but not these
        blocks: the slot is parked (its row points at the trash block in
        every decode step), a later prefill writes a shared block only to
        the trash block, and the chains are pinned. All prompt blocks ship,
        shared ones included: the receiver may not hold the chain."""
        with self._work:
            rec = self._exports.get(request_id)
            if rec is None:
                raise KeyError(f"request {request_id!r} has no parked export")
            slot = self.pool.slots[rec["slot"]]
            if slot.request_id != request_id:
                raise KeyError(f"request {request_id!r} no longer owns slot "
                               f"{rec['slot']}")
            bs = self.pool.block_size
            n_blocks = (slot.prompt_len - 1) // bs + 1
            blocks = list(self.pool._alloc_of[rec["slot"]].blocks[:n_blocks])
            prompt = tuple(rec["prompt"])
            trace = slot.trace
        cache = self.pool.cache
        k = cache["k"]
        with self._stream_scope():
            ids = torch.tensor(blocks, dtype=torch.long, device=self.device)
            both = k.new_empty((2, k.shape[0], len(blocks)) + k.shape[2:])
            torch.index_select(k, 1, ids, out=both[0])
            torch.index_select(cache["v"], 1, ids, out=both[1])
            # block-major on the device, so that each block's payload is a
            # contiguous view of the one host copy: [n, 2, L, Hkv, bs, hd]
            host = _to_wire(both.permute(2, 0, 1, 3, 4, 5).contiguous().cpu())
        # the lineage context of the next hop (the parent rid, the TTFT
        # components so far, the send stamp after the copy, as JAX's), so
        # that the receiver records a linked child hop
        trace_ctx = trace.export_context() if trace is not None else None
        return _migration.build_shipment(
            request_id=request_id, prompt=prompt,
            fingerprint=self.kv_fingerprint(), block_size=bs,
            block_k=tuple(host[j, 0] for j in range(len(blocks))),
            block_v=tuple(host[j, 1] for j in range(len(blocks))),
            trace_ctx=trace_ctx,
        )

    def finish_export(self, request_id: str) -> None:
        """The migration landed: release the parked slot and finish the
        source completion ``"migrated"`` (on the loop, at its next tick)."""
        with self._work:
            self._export_actions.append((request_id, "finish"))
            self._notify()

    def cancel_export(self, request_id: str) -> None:
        """The migration was given up: un-park the slot so the request
        decodes here (on the loop, at its next tick)."""
        with self._work:
            self._export_actions.append((request_id, "cancel"))
            self._notify()

    def _process_export_actions(self) -> None:
        """The loop's half of finish_export and cancel_export."""
        if not self._export_actions:
            return
        with self._work:
            actions = self._export_actions
            self._export_actions = []
        for rid, action in actions:
            with self._work:
                rec = self._exports.pop(rid, None)
            if rec is None:
                continue
            slot = self.pool.slots[rec["slot"]]
            if slot.request_id != rid:
                continue  # the slot was recycled (expiry, engine death)
            self.pool.allocator.unpin(rec["pinned"])
            slot.export_pending = False
            if action == "finish":
                self._finish(rid, "migrated")
                if slot.trace is not None:
                    self._tracer.finish(slot.trace, "migrated")
                self.pool.release(slot.index)

    def import_shipment(self, shipment: "_migration.KVShipment",
                        max_new_tokens: int,
                        request_id: Optional[str] = None,
                        eos_id: Any = "__default__",
                        on_token: Optional[Callable[[str, int], Any]] = None,
                        deadline_ms: Optional[float] = None,
                        priority: int = 0, retries: int = 0,
                        timeout: Optional[float] = 30.0) -> Completion:
        """Admit a prefilled request from a KV shipment (paged layout).

        Callable from any thread. The gates run in the JAX package's order:
        the shipment is verified (version, fingerprint, every block's
        checksum, the digest) and staged as host tensors on the calling
        thread, so checksums and host copies never stall the decode loop;
        then the loop thread, through a ticket, passes the fault point,
        reserves a slot and blocks, and writes the device cache (with no
        loop thread, the caller must ``step()`` while this waits). Waits up
        to ``timeout`` seconds for the verdict; on timeout the ticket is
        abandoned and ``TimeoutError`` raises.

        Raises :class:`~.migration.ShipmentMismatch` or
        :class:`~.migration.ShipmentCorrupt` before the loop sees the
        shipment, :class:`~.migration.MigrationRejected` when no slot or
        blocks fit the worst-case reservation, :class:`EngineClosed`, and
        the :class:`~ray_lightning_tpu_torch.runtime.faults.ServeFault` of
        a scripted crash mid-admit."""
        if not self._paged:
            raise ValueError("import_shipment requires kv_layout='paged'")
        rid = request_id or f"req-{next(self._req_counter)}"
        if eos_id == "__default__":
            eos_id = self.engine_config.eos_id
        ticket = _ImportTicket(shipment, rid, max_new_tokens, eos_id,
                               on_token, deadline_ms, priority, retries)
        ticket.payload = self._stage_import(shipment)
        with self._work:
            if self._closed:
                raise EngineClosed(
                    "engine is draining/shut down; no new shipments"
                )
            self._pending_imports.append(ticket)
            self._notify()
        if not ticket.event.wait(timeout):
            with self._work:
                ticket.abandoned = True
            if not ticket.event.is_set():
                raise TimeoutError(
                    f"shipment {rid!r} not admitted within {timeout}s"
                )
        if ticket.error is not None:
            raise ticket.error
        assert ticket.completion is not None
        return ticket.completion

    def _stage_import(self, shipment) -> Dict[str, torch.Tensor]:
        """The caller's half of an import: verify the shipment against this
        engine's fingerprint, then stack its payloads into host tensors
        [L, n_blocks, Hkv, bs, hd] of the cache's dtype, bit for bit."""
        _migration.verify_shipment(shipment, self.kv_fingerprint())
        dtype = self.pool.cache["k"].dtype
        _check_wire(shipment, dtype)
        return {name: _from_wire(np.stack(payload, axis=1), dtype)
                for name, payload in (("k", shipment.block_k),
                                      ("v", shipment.block_v))}

    def _process_imports(self) -> None:
        """The loop's half of :meth:`import_shipment`. A scripted crash
        mid-admit re-raises out of here after answering the waiting caller,
        so the engine dies as a real receiver crash would."""
        if not self._pending_imports:
            return
        with self._work:
            tickets = self._pending_imports
            self._pending_imports = []
        for ticket in tickets:
            with self._work:
                if ticket.abandoned:
                    continue
            try:
                ticket.completion = self._admit_import(ticket)
            except BaseException as e:
                ticket.error = e
                ticket.event.set()
                if isinstance(e, _faults.ServeFault):
                    raise
                continue
            ticket.event.set()

    def _admit_import(self, ticket: _ImportTicket) -> Completion:
        """Admit a verified, staged ticket: the fault point, the
        reservation, the device write, the resume."""
        shipment = ticket.shipment
        self._import_seq += 1
        _faults.migration_admit_fault(self.replica_index, self._import_seq)
        prompt = tuple(int(t) for t in shipment.prompt)
        rid = ticket.request_id
        if rid in self._completions:
            raise ValueError(f"duplicate request_id {rid!r}")
        deadline = (time.perf_counter() + float(ticket.deadline_ms) / 1e3
                    if ticket.deadline_ms is not None else None)
        slot = self.pool.acquire(
            rid, len(prompt), int(ticket.max_new_tokens),
            eos_id=ticket.eos_id, prompt_tokens=prompt, deadline=deadline,
        )
        if slot is None:
            raise _migration.MigrationRejected(
                f"shipment {rid!r}: no slot/blocks under the worst-case "
                "reservation — decode engine at capacity"
            )
        # install the payloads of the blocks this engine does not already
        # share: its own prefix hits hold identical bytes by the chain key
        alloc = self.pool._alloc_of[slot.index]
        n_blocks = (len(prompt) - 1) // self.pool.block_size + 1
        if alloc.shared < n_blocks:
            ids = torch.tensor(alloc.blocks[alloc.shared:n_blocks],
                               dtype=torch.long, device=self.device)
            for name, host in ticket.payload.items():
                self.pool.cache[name].index_copy_(
                    1, ids, host[:, alloc.shared:n_blocks].to(self.device))
        # resume where the colocated engine stands after its own prefill:
        # the next decode step re-runs the last prompt token at P - 1 (an
        # idempotent cache write), so every token equals the colocated one
        slot.pos = len(prompt) - 1
        slot.pending_token = prompt[-1]
        if self.engine_config.speculate_k > 0:
            self._history[rid] = list(prompt)
        completion = Completion(rid)
        if self._tracer is not None:
            # the receiving hop's trace, seeded from the shipment's lineage
            # context: its parent attempt, hop index and the TTFT seconds
            # spent upstream (the gap since the send stamp is "transfer")
            slot.trace = self._tracer.start(
                rid, len(prompt), int(ticket.max_new_tokens),
                replica=self.replica_index, retries=ticket.retries,
                ctx=shipment.trace_ctx,
            )
        with self._work:
            self._completions[rid] = completion
            if ticket.on_token is not None:
                self._on_token[rid] = ticket.on_token
        self.stats["prefills"] += 1
        reg = _obs.registry()
        if reg is not None:
            reg.counter("rlt_serve_requests_total").inc()
        return completion

    # ------------------------------------------------------------------ #
    # deadlines and shedding
    # ------------------------------------------------------------------ #
    def _slo_breached(self) -> bool:
        mon = self.slo_monitor
        if mon is None:
            return False
        try:
            return bool(mon.serving_breached())
        except AttributeError:
            return bool(mon.breached())

    def _on_queue_expired(self, req: Request) -> None:
        """The scheduler evicted a queued request past its deadline."""
        self._expire(req.request_id, req.trace)

    def _evict_expired_slots(self) -> None:
        now = time.perf_counter()
        for slot in self.pool.active_slots():
            if slot.deadline is not None and now > slot.deadline:
                if slot.export_pending:
                    # a parked export expires: drop its record and unpin
                    # its chains so they are evictable again
                    with self._work:
                        rec = self._exports.pop(slot.request_id, None)
                    if rec is not None:
                        self.pool.allocator.unpin(rec["pinned"])
                self._expire(slot.request_id, slot.trace)
                self.pool.release(slot.index)

    def _expire(self, request_id: str, trace: Optional[Any]) -> None:
        self._finish(request_id, "expired")
        if trace is not None:
            self._tracer.finish(trace, "expired")
        reg = _obs.registry()
        if reg is not None:
            reg.counter(_metrics.SERVE_DEADLINE_EXPIRED_METRIC).inc()

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
        led = self._goodput
        while True:
            with self._work:
                while self._abort or not self.scheduler.has_work():
                    if not self._abort and (self._pending_imports
                                            or self._export_actions):
                        break  # migration work needs a tick, idle or not
                    if self._abort or self._stop_when_idle:
                        return
                    if led is not None:
                        led.enter("idle")
                    self._work.wait(timeout=0.05)
                seq = self._wake_seq
            try:
                out = self.step()
            except Exception as e:  # fail every in-flight request loudly
                self._fail_all(e)
                return
            if not (out["prefills"] or out["decoded"]):
                # nothing could run (every occupied slot parked for export,
                # the queue waiting for them): sleep until new work arrives
                # or the next deadline sweep, not spin on the lock
                with self._work:
                    if (self._wake_seq == seq and not self._abort
                            and not self._stop_when_idle):
                        self._work.wait(timeout=0.05)

    def _fail_all(self, error: BaseException) -> None:
        self.failed = error
        if self._goodput is not None:
            # until a successor adopts the ledger: recovery, not idle
            self._goodput.enter("fault_recovery")
        for req in self.scheduler.drain_queue():
            self._finish(req.request_id, "error", error)
            if req.trace is not None:
                self._tracer.finish(req.trace, "error")
        for slot in self.pool.active_slots():
            self._finish(slot.request_id, "error", error)
            if slot.trace is not None:
                self._tracer.finish(slot.trace, "error")
            self.pool.release(slot.index)

    @property
    def alive(self) -> bool:
        """False once the loop has died (``_fail_all`` ran): the engine is
        unusable and must be dropped. A never-started engine (driven by
        ``step()``) counts as alive."""
        if self.failed is not None:
            return False
        thread = self._thread
        return thread is None or thread.is_alive()

    def handback_queued(self) -> List[Dict[str, Any]]:
        """Stop admission and hand back every queued (not yet admitted)
        request as a resubmittable spec; their completions finish
        ``"cancelled"`` with no error, which a journal reads as "resubmit
        elsewhere, no failure charged"."""
        with self._work:
            self._closed = True
        if self._goodput is not None:
            self._goodput.enter("drain")
        out: List[Dict[str, Any]] = []
        for req in self.scheduler.drain_queue():
            self._finish(req.request_id, "cancelled")
            if req.trace is not None:
                self._tracer.finish(req.trace, "cancelled")
            out.append({
                "request_id": req.request_id,
                "prompt": list(req.tokens),
                "max_new_tokens": req.max_new_tokens,
                "eos_id": req.eos_id,
                "priority": req.priority,
                "deadline": req.deadline,
                "retries": req.retries,
                "tenant": req.tenant,
            })
        return out

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        """Single-threaded drive: step until queue and pool are empty."""
        for _ in range(max_steps):
            if not self.scheduler.has_work():
                return
            self.step()
        raise RuntimeError(f"still busy after {max_steps} steps")

    def drain(self, timeout: Optional[float] = 60.0) -> None:
        """Stop admitting; finish in-flight and queued work; stop the loop."""
        if self._goodput is not None:
            self._goodput.enter("drain")
        with self._work:
            self._closed = True
            self._stop_when_idle = True
            thread = self._thread
            self._notify()
        if thread is not None:
            thread.join(timeout)
        else:
            self.run_until_idle()

    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> None:
        """``drain=False`` fails queued and in-flight requests instead of
        finishing them, once the loop has left its step in flight or
        ``timeout`` seconds have passed (a wedged loop)."""
        if drain:
            self.drain()
            return
        with self._work:
            self._closed = True
            self._abort = True
            thread = self._thread
            self._notify()
        if thread is not None:
            thread.join(timeout)  # at most the step in flight
        self._fail_all(EngineClosed("engine shut down without drain"))

    # ------------------------------------------------------------------ #
    # views
    # ------------------------------------------------------------------ #
    def load(self) -> Dict[str, Any]:
        """The routing and autoscaling signal: queue depth, active slots,
        the p95 of the last ~128 first-token latencies and the p99 of the
        last ~256 inter-token latencies (0.0 before any), and the role."""
        ttfts = list(self._recent_ttfts)
        p95 = _metrics.percentile(ttfts, 95.0) * 1000.0 if ttfts else 0.0
        itls = list(self._recent_itls)
        itl_p99 = _metrics.percentile(itls, 99.0) * 1000.0 if itls else 0.0
        return {
            "queue_depth": self.scheduler.queue_depth,
            "active": self.pool.occupancy,
            "ttft_p95_ms": round(p95, 3),
            "itl_p99_ms": round(itl_p99, 3),
            "role": self._role,
        }

    def slot_utilization(self) -> float:
        steps = self.stats["decode_steps"]
        if not steps:
            return 0.0
        return self.stats["busy_slot_steps"] / (steps * self.pool.num_slots)

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.stats)
        out.update(self.pool.stats())
        out["kv_layout"] = self.kv_layout
        out["slot_utilization"] = round(self.slot_utilization(), 4)
        if self._paged:
            out["block_utilization"] = round(self.pool.block_utilization(), 4)
        out["queue_depth"] = self.scheduler.queue_depth
        return out
