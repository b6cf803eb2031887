"""Attention: the reference einsum path, the hand-written flash-attention
forward kernel (``csrc/flash_fwd.cu``, the port of
``ray_lightning_tpu/ops/attention.py::_fwd_kernel``) with its plain version,
and the dispatcher.

Layout as in the JAX package: q [B, Hq, S, D], k/v [B, Hkv, S, D] with
Hq % Hkv == 0 (GQA: query head h reads KV head h // (Hq / Hkv)).

The dispatcher sends CUDA tensors to the kernel and CPU tensors to the
reference. There is no ``flash_supported`` gate: the kernel masks the ragged
last tile itself, so every length self-attention takes it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_lightning_tpu_torch.kernels import (
    CudaKernel,
    dtype_code,
    require_cuda,
    stream_of,
)

FLASH_FWD_KERNEL = CudaKernel(
    "flash_fwd", "flash_fwd.cu", "rlt_flash_fwd",
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p],
    replaces="ray_lightning_tpu/ops/attention.py:385",
)

MAX_HEAD_DIM = 128


def _normalize_window(window: Optional[int], causal: bool,
                      kv_len: int) -> Optional[int]:
    """As the JAX dispatcher: a window needs causal attention, must be
    >= 1, and is dropped when it covers every key."""
    if window is None:
        return None
    if not causal:
        raise NotImplementedError(
            "sliding-window attention is causal-only (decoder bands)"
        )
    if window < 1:
        raise ValueError(f"window={window}: must be >= 1")
    return None if window >= kv_len else int(window)


def _masked_logits(q, k, causal, scale, window):
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        skv = k.shape[2]
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        keep = qi >= ki
        if window:
            keep &= (qi - ki) < window
        logits = logits.masked_fill(~keep, float("-inf"))
    return logits


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Einsum attention in fp32, output in q's dtype (``ops/attention.py::
    reference_attention``). ``window`` W: position i attends [i-W+1, i]."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    probs = torch.softmax(_masked_logits(q, k, causal, scale, window), dim=-1)
    hq, hkv = q.shape[1], v.shape[1]
    if hq != hkv:
        v = v.repeat_interleave(hq // hkv, dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def flash_attention_plain(q, k, v, causal=True, sm_scale=None, window=None):
    """Plain version of the flash forward kernel: (O in q's dtype, lse
    [B, Hq, S, 1] fp32)."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    lse = torch.logsumexp(
        _masked_logits(q, k, causal, scale, window), dim=-1, keepdim=True
    )
    return reference_attention(q, k, v, causal, scale, window), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward over self-attention (S_q == S_kv): returns
    (O in q's dtype, lse [B, Hq, S, 1] fp32). CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    b, hq, s, d = q.shape
    if k.shape[2] != s or v.shape != k.shape:
        raise ValueError(
            f"flash attention is self-attention with S_q == S_kv; got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"query heads {hq} must be a multiple of KV heads {hkv}")
    window = _normalize_window(window, causal, s)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, window)
    require_cuda("flash_attention", q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    code = dtype_code("flash_attention", q.dtype)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s, 1), dtype=torch.float32, device=q.device)
    FLASH_FWD_KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, hq, hkv, s, d, float(scale), int(causal),
        int(window or 0), code, stream_of(q),
    )
    return out, lse


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None,
              window: Optional[int] = None) -> torch.Tensor:
    """Dispatching attention op: CUDA tensors -> the flash kernel, CPU
    tensors -> the reference path."""
    window = _normalize_window(window, causal, k.shape[2])
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal, sm_scale, window)
    return flash_attention(q, k, v, causal, sm_scale, window)[0]
