"""Kernels of the paged serving decode path, each beside its plain version:

- paged decode attention (``csrc/paged_decode.cu``, the port of
  ``ray_lightning_tpu/ops/paged_attention.py::_paged_decode_kernel``): one
  query per row walks its block table; the gathered [B, Hkv, C, hd] cache is
  never built;
- the blockwise argmax sampler (``csrc/argmax.cu``, the port of
  ``_argmax_kernel`` / ``_noisy_argmax_kernel``): greedy sampling is the
  argmax with first-max tie-breaking (and the first NaN, if a row holds
  one), temperature sampling is the argmax of
  the scaled logits plus Gumbel noise (the Gumbel-max identity). The noise is
  an operand drawn by the caller's ``torch.Generator``: the port cannot
  reproduce ``jax.random``, so temperature streams differ from the JAX
  package's by design, while greedy streams do not.

CPU tensors take the plain versions; CUDA tensors launch the kernels (or
raise). top-k / top-p sampling stays on the plain sampler
(``fused_sample_supported`` gates callers, as in the JAX engine).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ray_lightning_tpu_torch.kernels import (
    CudaKernel,
    dtype_code,
    load_library,
    require_cuda,
    stream_of,
)

PAGED_DECODE_KERNEL = CudaKernel(
    "paged_decode", "paged_decode.cu", "rlt_paged_decode",
    [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    replaces="ray_lightning_tpu/ops/paged_attention.py:196",
)
# positions per block of the kernel's split over a row's positions: four
# 16-position tiles at hd 128 in bf16, all in flight at once (csrc note)
PAGED_SPLIT = 64
# the GQA groups the kernel is instantiated for; the wrapper pads any group
# up to 8 to the next of them (paged_group) and splits a larger one into
# launches of at most 8 query heads (paged_group_chunks)
PAGED_GROUPS = (1, 2, 4, 8)
# the head dims the kernel is instantiated for; another multiple of 8 runs on
# the next of them up (paged_head_dim)
PAGED_HEAD_DIMS = (32, 64, 128, 256)
# (row, KV head) pairs the kernel's arrival counters cover
PAGED_MAX_ROWS = 1 << 16

ARGMAX_KERNEL = CudaKernel(
    "argmax", "argmax.cu", "rlt_argmax",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    replaces="ray_lightning_tpu/ops/paged_attention.py:272",
)
# the argmax kernel's split of a row: one thread-block cluster per row
ARGMAX_MAX_CHUNKS = 8     # Hopper's largest portable cluster
ARGMAX_MIN_CHUNK = 2048   # elements a block reads at the least
ARGMAX_WAVES = 2          # blocks per SM the plan aims at, at most
ARGMAX_MAX_VOCAB = (1 << 31) - (1 << 16)  # int32 indices with room to spare


# --------------------------------------------------------------------- #
# paged decode attention
# --------------------------------------------------------------------- #
def paged_decode_attention_plain(q, k_cache, v_cache, block_tables, pos,
                                 sm_scale: Optional[float] = None):
    """Gather each row's blocks into logical order, mask columns past
    ``pos``, softmax in fp32 (the gather path of ``decode_step_paged``)."""
    B, hkv, group, hd = q.shape
    bs = k_cache.shape[2]
    C = block_tables.shape[1] * bs
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    tables = block_tables.long()
    kk = k_cache[tables].transpose(1, 2).reshape(B, hkv, C, hd).float()
    vv = v_cache[tables].transpose(1, 2).reshape(B, hkv, C, hd).float()
    logits = torch.einsum("bhgd,bhtd->bhgt", q.float(), kk) * scale
    valid = torch.arange(C, device=q.device)[None, :] <= pos.long()[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgt,bhtd->bhgd", probs, vv)


def paged_group(group: int) -> int:
    """The instantiated group one launch of a GQA group of ``group`` query
    heads runs at: the smallest of ``PAGED_GROUPS`` that holds it. Raises
    for groups above 8 (the wrapper splits those first,
    ``paged_group_chunks``)."""
    for g in PAGED_GROUPS:
        if group <= g:
            return g
    raise ValueError(
        f"paged_decode_attention: the kernel takes GQA groups up to "
        f"{PAGED_GROUPS[-1]} (padded to one of {PAGED_GROUPS}), got G={group}"
    )


def paged_group_chunks(group: int) -> List[Tuple[int, int]]:
    """The slices [lo, hi) of q's group dim that one launch each takes: at
    most ``PAGED_GROUPS[-1]`` query heads (G 16 is two launches of 8, G 12
    one of 8 and one of 4)."""
    step = PAGED_GROUPS[-1]
    return [(lo, min(lo + step, group)) for lo in range(0, group, step)]


def paged_head_dim(hd: int) -> int:
    """The instantiated head dim a cache of head dim ``hd`` runs at: ``hd``
    itself when it is one of ``PAGED_HEAD_DIMS``, else the next of them up
    (the kernel reads the rows at ``hd``'s stride and masks past it; q and
    the output are padded to it, the pool never). Raises for a width the
    kernel's tiles cannot serve: not a multiple of 8 (a row would not be
    16-byte aligned), or above 256."""
    if hd <= 0 or hd % 8 or hd > PAGED_HEAD_DIMS[-1]:
        raise ValueError(
            f"paged_decode_attention: the kernel takes head dims that are "
            f"multiples of 8 up to {PAGED_HEAD_DIMS[-1]}, got hd={hd}"
        )
    return next(w for w in PAGED_HEAD_DIMS if hd <= w)


def paged_decode_plan(batch: int, hkv: int, group: int, hd: int, bs: int,
                      max_blocks: int) -> dict:
    """One launch's plan, from host-known sizes only (never ``pos``, which
    lies on the card): ``split`` positions per block, ``chunks`` blocks per
    (row, KV head) and the fp32 ``scratch`` floats for the chunks' partial
    states (max and sum per query head of the padded group
    ``paged_group(group)``, unnormalised output at the padded head dim
    ``paged_head_dim(hd)``), which the last block of each (row, KV head)
    merges."""
    if batch * hkv > PAGED_MAX_ROWS:
        raise ValueError(
            f"paged_decode_attention: B * Hkv = {batch * hkv} exceeds the "
            f"kernel's {PAGED_MAX_ROWS} arrival counters"
        )
    padded = paged_group(group)
    chunks = -(-max_blocks * bs // PAGED_SPLIT)
    return {"split": PAGED_SPLIT, "chunks": chunks,
            "scratch": batch * hkv * chunks * padded * (paged_head_dim(hd) + 2)}


def over_group_chunks(q: torch.Tensor,
                      run: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``run`` on each slice of ``paged_group_chunks`` of q's group dim (q:
    [B, Hkv, G, hd]), the outputs concatenated along it: how the wrapper
    serves a group above 8 (tested on the CPU with the plain version as
    ``run``)."""
    outs = [run(q[:, :, lo:hi]) for lo, hi in paged_group_chunks(q.shape[2])]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


# (device index, stream handle) -> the zeroed arrival counters of the eager
# calls on that stream: the kernel's last block of each (row, KV head)
# resets its counter, so a buffer stays zero between calls, and two streams
# never share one
_ARRIVALS: Dict[Tuple[int, int], torch.Tensor] = {}
# (device index, capture id, counters) of the CUDA-graph capture of the last
# captured call
_CAPTURED: List[Optional[Tuple[int, int, torch.Tensor]]] = [None]


@functools.lru_cache(maxsize=None)
def _capture_id_fn():
    fn = load_library(PAGED_DECODE_KERNEL.source).rlt_paged_capture_id
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_ulonglong
    return fn


def _arrivals(device: torch.device, stream: int) -> torch.Tensor:
    """The arrival counters of a call on ``stream``. A CUDA-graph capture
    gets counters of its own, allocated in the graph's memory at its first
    call and zeroed by a memset the graph records, so each replay starts
    from zero: a graph never reads counters that another graph captured on
    the same stream (torch.cuda.graph's one capture stream) left, and
    graphs replayed on two streams at once share none."""
    if torch.cuda.is_current_stream_capturing():
        capture = int(_capture_id_fn()(stream))
        held = _CAPTURED[0]
        if held is None or held[:2] != (device.index, capture):
            held = (device.index, capture,
                    torch.zeros(PAGED_MAX_ROWS, dtype=torch.int32,
                                device=device))
            _CAPTURED[0] = held
        return held[2]
    key = (device.index, stream)
    buf = _ARRIVALS.get(key)
    if buf is None:
        buf = torch.zeros(PAGED_MAX_ROWS, dtype=torch.int32, device=device)
        _ARRIVALS[key] = buf
    return buf


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, block_tables: torch.Tensor,
                           pos: torch.Tensor,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hkv, G, hd] fp32 (GQA-folded, one position per row); k/v
    caches: [N, Hkv, bs, hd]; block_tables: [B, max_blocks] int32
    (trash-padded); pos: [B] int32. Returns fp32 [B, Hkv, G, hd], the
    attention of each row over its logical positions [0, pos[b]].

    Any group runs, and any head dim that is a multiple of 8 up to 256, as
    the JAX kernel pads its group to the sublane tile and its head dim to
    the lane tile. A group the kernel is not instantiated for (3, 5, 6, 7;
    Qwen2.5-7B has 7) is padded with zero query heads up to the next
    instantiated one and the padded heads' outputs are sliced off: a KV
    head's blocks are read once for its whole group, so the K/V bytes,
    which bound the kernel, do not change, and the extra query heads cost
    only registers and FMAs in a latency-bound kernel. A group above 8
    (Llama-3.1-405B's and Falcon-40B's 16) is split into launches of at
    most 8 query heads over the same caches and tables, each padded the same
    way, one launch each (``over_group_chunks``). A head dim between the
    instantiated ones (Phi-2's 80, Phi-3's 96) runs on the next instantiated
    width up, with q zero-padded to it and the output sliced back; the cache
    is read at its own stride."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, block_tables, pos, sm_scale
        )
    require_cuda("paged_decode_attention", q, k_cache, v_cache, block_tables,
                 pos)
    B, hkv, group, hd = q.shape
    n, hkv_c, bs, hd_c = k_cache.shape
    if q.dtype != torch.float32:
        raise TypeError("paged_decode_attention: q must be float32")
    if (hkv_c, hd_c) != (hkv, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)} does not match "
            f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)}"
        )
    if v_cache.dtype != k_cache.dtype:
        raise TypeError("paged_decode_attention: k and v caches differ in dtype")
    if (block_tables.dtype != torch.int32 or pos.dtype != torch.int32
            or block_tables.shape[0] != B or pos.shape != (B,)):
        raise ValueError(
            "paged_decode_attention: block_tables [B, max_blocks] and pos [B] "
            "must be int32"
        )
    code = dtype_code("paged_decode_attention", k_cache.dtype)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    hdp = paged_head_dim(hd)
    stream = stream_of(q)
    arrivals = _arrivals(q.device, stream)

    def launch(qc: torch.Tensor) -> torch.Tensor:
        g = qc.shape[2]
        plan = paged_decode_plan(B, hkv, g, hd, bs, block_tables.shape[1])
        gp = paged_group(g)
        if (gp, hdp) != (g, hd) or not qc.is_contiguous():
            qp = qc.new_zeros((B, hkv, gp, hdp))
            qp[:, :, :g, :hd] = qc
            qc = qp
        elif qc.data_ptr() % 16:  # the kernel reads q in 16-byte loads
            qc = qc.clone()
        scratch = torch.empty(plan["scratch"], dtype=torch.float32,
                              device=q.device)
        out = torch.empty_like(qc)
        PAGED_DECODE_KERNEL.launch(
            qc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), arrivals.data_ptr(), B, hkv, gp, hd, bs,
            block_tables.shape[1], plan["split"], float(scale), code, stream,
        )
        return out if (gp, hdp) == (g, hd) else out[:, :, :g, :hd]

    return over_group_chunks(q, launch)


# --------------------------------------------------------------------- #
# blockwise argmax sampler
# --------------------------------------------------------------------- #
def blockwise_argmax_plain(x: torch.Tensor,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmax over the last axis of ``x (+ noise)`` in fp32: the first
    maximum on ties, the first NaN in a row that holds one; [B] int32."""
    v = x.float() if noise is None else x.float() + noise.float()
    return torch.argmax(v, dim=-1).to(torch.int32)


def argmax_plan(batch: int, vocab: int, sms: int = 132) -> dict:
    """The argmax kernel's launch plan, from host-known sizes: ``chunks``
    blocks per row, which form one thread-block cluster, so that
    ``batch * chunks`` fills at most ``ARGMAX_WAVES`` blocks per SM and each
    block reads at least ``ARGMAX_MIN_CHUNK`` elements; ``chunk`` elements
    per block (see ``_chunk_len``)."""
    chunks = max(1, min(ARGMAX_MAX_CHUNKS, -(-vocab // ARGMAX_MIN_CHUNK),
                        ARGMAX_WAVES * sms // max(batch, 1)))
    return {"chunks": chunks, "chunk": _chunk_len(vocab, chunks)}


def _chunk_len(vocab: int, chunks: int) -> int:
    """Elements a block reads: ceil(vocab / chunks) rounded up to a
    multiple of 4, so that every block of an aligned row starts on a
    16-byte boundary."""
    return (-(-vocab // chunks) + 3) // 4 * 4


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_argmax(x: torch.Tensor, noise: Optional[torch.Tensor],
                   chunks: int) -> torch.Tensor:
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    ARGMAX_KERNEL.launch(
        x.data_ptr(), None if noise is None else noise.data_ptr(),
        out.data_ptr(), x.shape[0], x.shape[1], chunks,
        _chunk_len(x.shape[1], chunks), stream_of(x),
    )
    return out


def blockwise_argmax(x: torch.Tensor,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x, noise: [B, V] fp32 -> [B] int32, the first maximum of x + noise
    (the first NaN in a row that holds one)."""
    if x.device.type == "cpu":
        return blockwise_argmax_plain(x, noise)
    tensors = (x,) if noise is None else (x, noise)
    require_cuda("blockwise_argmax", *tensors)
    if x.dim() != 2 or any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("blockwise_argmax: x (and noise) must be [B, V] float32")
    if noise is not None and noise.shape != x.shape:
        raise ValueError("blockwise_argmax: noise must match x's shape")
    B, V = x.shape
    if not 0 < V <= ARGMAX_MAX_VOCAB:
        raise ValueError(
            f"blockwise_argmax: the vocabulary must hold 1 to "
            f"{ARGMAX_MAX_VOCAB} entries, got {V}"
        )
    if B == 0:
        return torch.empty((0,), dtype=torch.int32, device=x.device)
    plan = argmax_plan(B, V, _sm_count(x.device))
    return _launch_argmax(x, noise, plan["chunks"])


def fused_greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling: [B, V] fp32 -> [B] int32, equal to
    ``torch.argmax(logits, -1)`` including first-max ties and the first
    NaN."""
    return blockwise_argmax(logits, None)


def fused_sample_supported(temperature: float, top_k: Optional[int],
                           top_p: Optional[float]) -> bool:
    """Greedy and plain-temperature sampling run on the kernel; top-k /
    top-p filtering keeps the plain sampler."""
    if top_k is not None and top_k > 0:
        return False
    if top_p is not None and 0.0 < top_p < 1.0:
        return False
    return True


def gumbel_noise(shape, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def fused_sample(logits: torch.Tensor, generator: torch.Generator,
                 temperature: float, top_k: Optional[int] = None,
                 top_p: Optional[float] = None) -> torch.Tensor:
    """The kernel sampler for the configs ``fused_sample_supported``
    admits: greedy is the argmax; temperature > 0 is the argmax of
    ``logits / temperature`` plus Gumbel noise from ``generator``."""
    if not fused_sample_supported(temperature, top_k, top_p):
        raise ValueError(
            "fused_sample supports greedy and plain-temperature sampling "
            "only (top_k/top_p filtering keeps the plain sampler); gate "
            "callers with fused_sample_supported()"
        )
    if temperature <= 0.0:
        return fused_greedy_sample(logits)
    scaled = logits / temperature
    noise = gumbel_noise(scaled.shape, generator, scaled.device)
    return blockwise_argmax(scaled, noise)
