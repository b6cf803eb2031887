"""Attention: the reference einsum path, the hand-written flash-attention
kernels with their plain versions, the autograd Function that joins them, and
the dispatcher.

- forward: ``csrc/flash_fwd.cu``, the port of
  ``ray_lightning_tpu/ops/attention.py::_fwd_kernel``;
- backward: ``csrc/flash_bwd.cu``, the ports of ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``; ``delta = rowsum(dO * O)`` is a torch op here, as it
  is a jnp op outside the TPU kernels;
- ``FlashAttentionFunction`` takes the place of the ``_flash_attention``
  custom VJP: its forward saves q, k, v, O and lse, its backward launches
  the two backward kernels.

Layout as in the JAX package: q [B, Hq, S, D], k/v [B, Hkv, S, D] with
Hq % Hkv == 0 (GQA: query head h reads KV head h // (Hq / Hkv)).

The dispatcher sends CUDA tensors to the kernels (through
``FlashAttentionFunction`` when a gradient is wanted) and CPU tensors to the
reference. There is no ``flash_supported`` gate: the kernels mask the ragged
last tile themselves, so every length self-attention takes them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_lightning_tpu_torch.kernels import (
    CudaKernel,
    dtype_code,
    refuse_untracked_grad,
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

_BWD_TAIL = ([ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
FLASH_BWD_DQ_KERNEL = CudaKernel(
    "flash_bwd_dq", "flash_bwd.cu", "rlt_flash_bwd_dq",
    [ctypes.c_void_p] * 7 + _BWD_TAIL,
    replaces="ray_lightning_tpu/ops/attention.py:427",
)
FLASH_BWD_DKV_KERNEL = CudaKernel(
    "flash_bwd_dkv", "flash_bwd.cu", "rlt_flash_bwd_dkv",
    [ctypes.c_void_p] * 8 + _BWD_TAIL,
    replaces="ray_lightning_tpu/ops/attention.py:451",
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


def _check_self_attention(q, k, v) -> None:
    hq, s = q.shape[1], q.shape[2]
    if k.shape[2] != s or v.shape != k.shape:
        raise ValueError(
            f"flash attention is self-attention with S_q == S_kv; got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if hq % k.shape[1]:
        raise ValueError(
            f"query heads {hq} must be a multiple of KV heads {k.shape[1]}"
        )


def _kernel_dtype(name: str, q, *others) -> int:
    if any(t.dtype != q.dtype for t in others):
        raise TypeError(f"{name}: q, k, v (and O, dO) must share one dtype")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[-1]} > {MAX_HEAD_DIM}")
    return dtype_code(name, q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward over self-attention (S_q == S_kv): returns
    (O in q's dtype, lse [B, Hq, S, 1] fp32). CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise). The kernel is
    invisible to autograd: with grad mode on, inputs that require grad are
    refused (``attention`` is the differentiable entry)."""
    _check_self_attention(q, k, v)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    window = _normalize_window(window, causal, s)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, window)
    require_cuda("flash_attention", q, k, v)
    refuse_untracked_grad("flash_attention", q, k, v)
    code = _kernel_dtype("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s, 1), dtype=torch.float32, device=q.device)
    FLASH_FWD_KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, hq, hkv, s, d, float(scale), int(causal),
        int(window or 0), code, stream_of(q),
    )
    return out, lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True, sm_scale=None,
                              window=None):
    """Plain version of the two backward kernels: the same recompute in fp32
    with the TPU kernels' roundings (dS to q's dtype before dS·K and dSᵀ·Q,
    P to dO's dtype before Pᵀ·dO). Returns (dq, dk, dv) in the inputs'
    dtypes, dk/dv [B, Hkv, S, D] with the GQA group summed. The -inf of the
    causal mask and the -1e30 of a window give the same P = 0 once lse is
    known, so one mask serves both."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    p = torch.exp(_masked_logits(q, k, causal, scale, window) - lse)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    dof = do.float()
    delta = (o.float() * dof).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    del dp
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    del ds
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), dof)
    dk = dk.reshape(b, hkv, group, s, d).sum(dim=2)
    dv = dv.reshape(b, hkv, group, s, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of flash attention from the forward's O and lse
    (``ops/attention.py::_flash_bwd``): (dq, dk, dv). CPU tensors take the
    plain version; CUDA tensors launch the dQ and dK/dV kernels (or
    raise)."""
    _check_self_attention(q, k, v)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, hq, s, 1):
        raise ValueError(
            f"flash_attention_bwd: O and dO must be {tuple(q.shape)} and lse "
            f"{(b, hq, s, 1)}; got {tuple(o.shape)}, {tuple(do.shape)}, "
            f"{tuple(lse.shape)}"
        )
    window = _normalize_window(window, causal, s)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                         window)
    require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    refuse_untracked_grad("flash_attention_bwd", q, k, v, o, lse, do)
    _kernel_dtype("flash_attention_bwd", q, k, v, o, do)
    delta = (o.float() * do.float()).sum(dim=-1, keepdim=True)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale, window)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                     window)
    return dq, dk, dv


def _bwd_kernel_args(name, q, k, v, do, lse, delta, causal, scale, window):
    """The checks and the scalar tail shared by the two backward kernels'
    C entry points (CUDA tensors only; ``window`` already normalised)."""
    require_cuda(name, q, k, v, do, lse, delta)
    refuse_untracked_grad(name, q, k, v, do, lse, delta)
    code = _kernel_dtype(name, q, k, v, do)
    b, hq, s, d = q.shape
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"{name}: lse and delta must be float32")
    if lse.shape != (b, hq, s, 1) or delta.shape != (b, hq, s, 1):
        raise ValueError(f"{name}: lse and delta must be {(b, hq, s, 1)}")
    return (b, hq, k.shape[1], s, d, float(scale), int(causal),
            int(window or 0), code, stream_of(q))


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale, window):
    """Launch the dQ kernel: dq [B, Hq, S, D] in q's dtype from the
    forward's lse and ``delta = rowsum(dO * O)`` (fp32 [B, Hq, S, 1])."""
    tail = _bwd_kernel_args("flash_attention_bwd_dq", q, k, v, do, lse, delta,
                            causal, scale, window)
    dq = torch.empty_like(q)
    FLASH_BWD_DQ_KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *tail,
    )
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale, window):
    """Launch the dK/dV kernel: dk, dv [B, Hkv, S, D] in k's dtype with the
    GQA group summed, from the same inputs as the dQ kernel."""
    tail = _bwd_kernel_args("flash_attention_bwd_dkv", q, k, v, do, lse,
                            delta, causal, scale, window)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    FLASH_BWD_DKV_KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail,
    )
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its gradient (the ``_flash_attention`` custom
    VJP of the JAX package). Forward and backward each call the kernel
    wrappers with grad mode off, so on CUDA tensors both go through the
    hand-written kernels; on CPU tensors through their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float,
                window: Optional[int]):
        o, lse = flash_attention(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale, ctx.window)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None,
              window: Optional[int] = None) -> torch.Tensor:
    """Dispatching attention op: CUDA tensors -> the flash kernels, through
    ``FlashAttentionFunction`` when a gradient is wanted; CPU tensors -> the
    reference path."""
    window = _normalize_window(window, causal, k.shape[2])
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal, sm_scale, window)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, scale, window)
    return flash_attention(q, k, v, causal, scale, window)[0]
