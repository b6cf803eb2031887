"""RMSNorm: the hand-written CUDA kernel (``csrc/rmsnorm.cu``, the port of
``ray_lightning_tpu/ops/rmsnorm.py::_rmsnorm_pallas``) for CUDA tensors and
its plain PyTorch version for CPU tensors. fp32 accumulation, one cast at the
end, as the JAX reference (``ops/rmsnorm.py:13-17``).

The gradient is the JAX package's too (``ops/rmsnorm.py:52-67``): the
forward is the kernel, the backward differentiates the reference formula by
recompute. That backward was never a Pallas kernel, so torch autograd over
``rmsnorm_plain`` is its port."""
from __future__ import annotations

import ctypes
import math

import torch

from ray_lightning_tpu_torch.kernels import (
    CudaKernel,
    KernelCost,
    dtype_code,
    refuse_untracked_grad,
    require_cuda,
    stream_of,
)

RMSNORM_KERNEL = CudaKernel(
    "rmsnorm", "rmsnorm.cu", "rlt_rmsnorm_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    replaces="ray_lightning_tpu/ops/rmsnorm.py:37",
)


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * weight.float()).to(dtype)


def rmsnorm_cost(shape, dtype: torch.dtype) -> KernelCost:
    """The kernel's work on x of ``shape`` [..., D] in ``dtype``: x read and
    the output written once, the weight [D] read once; four operations an
    element (square, sum, scale, weight)."""
    n, dim = math.prod(shape), shape[-1]
    return KernelCost(flops=4 * n, bytes=(2 * n + dim) * dtype.itemsize)


def rmsnorm_fwd(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """The forward wrapper: CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise). The kernel is invisible to autograd: with
    grad mode on, CUDA inputs that require grad are refused (``rmsnorm`` is
    the differentiable entry)."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    if x.is_meta:
        RMSNORM_KERNEL.record_cost(rmsnorm_cost(x.shape, x.dtype))
        return torch.empty_like(x)
    require_cuda("rmsnorm", x, weight)
    refuse_untracked_grad("rmsnorm", x, weight)
    code = dtype_code("rmsnorm", x.dtype)
    dim = x.shape[-1]
    if weight.dtype != x.dtype or weight.shape != (dim,):
        raise ValueError(
            f"rmsnorm: weight must be [{dim}] of {x.dtype}, got "
            f"{list(weight.shape)} of {weight.dtype}"
        )
    out = torch.empty_like(x)
    RMSNORM_KERNEL.launch(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), x.numel() // dim,
        dim, float(eps), code, stream_of(x),
    )
    return out


class RMSNormFunction(torch.autograd.Function):
    """Forward: the kernel (its plain version on CPU tensors). Backward: the
    reference formula's gradient by recompute, as the JAX package's custom
    VJP does."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rmsnorm_fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            wr = weight.detach().requires_grad_()
            y = rmsnorm_plain(xr, wr, ctx.eps)
        dx, dw = torch.autograd.grad(y, (xr, wr), g)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D], weight: [D] of x's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise), through
    ``RMSNormFunction`` when a gradient is wanted; meta tensors record its
    cost (``rmsnorm_cost``) on the same route."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return RMSNormFunction.apply(x, weight, eps)
    return rmsnorm_fwd(x, weight, eps)
