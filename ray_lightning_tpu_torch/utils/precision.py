"""Precision policies (``ray_lightning_tpu/utils/precision.py``): the
Trainer's ``precision`` argument as a dtype policy, and the matmul
precision policy.

- ``None`` (default)          -> module-owned dtypes, nothing is touched
- ``"32-true"`` / 32          -> parameters and compute fp32
- ``"bf16"``/``"bf16-mixed"`` -> fp32 master weights; each step runs the
  forward and backward on a bf16 cast of the parameters and of the float
  inputs, and the gradients land on the fp32 masters
- ``"bf16-true"``             -> parameters and compute bf16
- ``"64-true"`` / 64          -> fp64 (the Llama kernels refuse it on the
  card; it serves small modules)
- ``"16-mixed"``/``"16-true"``/``"16"`` -> their bf16 twins, with a warning:
  bf16 keeps fp32's exponent range, so no loss scaling is needed

The mixed policy casts every float leaf, as the JAX package does; it is not
``torch.autocast``, which picks per op what to cast and keeps some ops in
fp32.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional, Union

import torch

from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.utils.common import rank_zero_warn
from ray_lightning_tpu_torch.utils.tree import tree_map


@dataclass(frozen=True)
class PrecisionPolicy:
    name: str
    param_dtype: Optional[torch.dtype]  # None = leave module-owned dtypes
    compute_dtype: Optional[torch.dtype]

    @property
    def active(self) -> bool:
        return self.param_dtype is not None or self.compute_dtype is not None

    @property
    def cast_params_in_compute(self) -> bool:
        """Mixed precision: the step computes on a bf16 view of the fp32
        masters, cast inside autograd, so the gradients reach the masters
        in fp32."""
        return self.name.endswith("-mixed")


_POLICIES = {
    "32-true": ("32-true", torch.float32, torch.float32),
    "bf16-mixed": ("bf16-mixed", None, torch.bfloat16),
    "bf16-true": ("bf16-true", torch.bfloat16, torch.bfloat16),
    "64-true": ("64-true", torch.float64, torch.float64),
}
_ALIASES = {"bf16": "bf16-mixed"}
_FP16_ALIASES = {"16-mixed": "bf16-mixed", "16-true": "bf16-true",
                 "16": "bf16-mixed"}


def parse_precision(precision: Union[str, int, None]) -> PrecisionPolicy:
    if precision is None:
        return PrecisionPolicy("default", None, None)
    key = str(precision)
    if key in ("32", "64"):
        key += "-true"
    key = _ALIASES.get(key, key)
    if key in _FP16_ALIASES:
        rank_zero_warn(
            "precision=%r: fp16 has no advantage here (bf16 keeps fp32's "
            "exponent range, so no loss scaling is needed); using %s instead",
            precision,
            _FP16_ALIASES[key],
        )
        key = _FP16_ALIASES[key]
    if key not in _POLICIES:
        raise ValueError(
            f"unknown precision {precision!r}; supported: "
            f"{sorted(_POLICIES)} (or 16-mixed/16-true, mapped to bf16)"
        )
    return PrecisionPolicy(*_POLICIES[key])


def cast_floats(tree: Any, dtype: Optional[torch.dtype]) -> Any:
    """Cast the floating-point tensor leaves to ``dtype`` (differentiably:
    a cast of a leaf that requires grad sends its gradient back in the
    leaf's dtype); integer and bool leaves are untouched."""
    if dtype is None:
        return tree

    def cast(leaf):
        if torch.is_tensor(leaf) and leaf.is_floating_point():
            return leaf.to(dtype)
        return leaf

    return tree_map(cast, tree)


# --------------------------------------------------------------------- #
# matmul precision policy
# --------------------------------------------------------------------- #
#   "default"       -> leave torch's setting alone
#   "bf16"          -> TF32 for fp32 cuBLAS products (cuBLAS has no bf16
#                      mode for fp32 operands; JAX's "default" precision is
#                      TF32 on this card too)
#   "tensorfloat32" -> TF32 for fp32 cuBLAS products
#   "highest"       -> full fp32 cuBLAS products
#   "fp8-emulated"  -> operands rounded through float8_e4m3fn (the value
#                      grid only; the product runs at the default setting)
#
# The scope sets ``torch.backends.cuda.matmul.allow_tf32``, which steers
# cuBLAS alone: the process-wide ``torch.set_float32_matmul_precision``
# would also turn the CPU's oneDNN fp32 products into bf16. The port's
# hand-written kernels ignore all of these settings: only cuBLAS products
# change.

_MATMUL_POLICIES = ("default", "bf16", "tensorfloat32", "highest",
                    "fp8-emulated")
# what each policy asks of allow_tf32 (None = leave alone)
_ALLOW_TF32 = {
    "default": None,
    "bf16": True,
    "tensorfloat32": True,
    "highest": False,
    "fp8-emulated": None,
}
_MATMUL_ALIASES = {"fp8": "fp8-emulated", "f32": "highest", "fp32": "highest",
                   "tf32": "tensorfloat32"}
# float8_e4m3fn has no infinity: JAX rounds magnitudes above 464 (the
# midpoint between its largest finite value, 448, and the next step) to
# NaN, where torch's cast saturates to 448; JAX's NaNs are the quiet NaN
# with the operand's sign
_FP8_E4M3FN_OVERFLOW = 464.0


def parse_matmul_precision(value: Optional[str] = None) -> str:
    """The matmul policy's canonical name; ``None`` is ``"default"``.
    Raises ValueError naming an unknown value."""
    key = str(value if value is not None else "default").strip().lower()
    key = _MATMUL_ALIASES.get(key, key)
    if key not in _MATMUL_POLICIES:
        raise ValueError(
            f"unknown matmul precision {value!r}; supported: "
            f"{list(_MATMUL_POLICIES)}"
        )
    return key


@contextlib.contextmanager
def matmul_precision_scope(policy: Optional[str] = None):
    """Apply the matmul policy to cuBLAS's fp32 products while the block
    runs, and restore the previous setting on exit."""
    allow = _ALLOW_TF32[parse_matmul_precision(policy)]
    if allow is None:
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _round_fp8(x):
    if not (torch.is_tensor(x) and x.is_floating_point()):
        return x
    rounded = x.to(torch.float8_e4m3fn).to(x.dtype)
    nan = torch.copysign(torch.full_like(x, float("nan")), x)
    return torch.where((x.abs() > _FP8_E4M3FN_OVERFLOW) | x.isnan(), nan,
                       rounded)


def round_matmul_inputs(policy: str, *operands):
    """fp8-emulated: round the float leaves of each operand (a tensor or a
    tree) through float8_e4m3fn, as JAX's ``astype`` round trip does (ties
    to even, NaN past the largest finite value); storage and the product
    stay in the original dtype. Identity for every other policy."""
    if policy != "fp8-emulated":
        return operands if len(operands) != 1 else operands[0]
    out = tuple(tree_map(_round_fp8, x) for x in operands)
    return out if len(out) != 1 else out[0]


def promises_decode_parity(a: Optional[str], b: Optional[str],
                           device: DeviceLike = None) -> bool:
    """Whether two matmul policies promise token-identical greedy decode on
    ``device`` (the card unless ``"cpu"``). On the CPU the scope changes
    nothing, so every policy but fp8-emulated agrees with every other;
    fp8-emulated changes values everywhere; on the card only policies that
    ask cuBLAS for the same setting promise it."""
    ka, kb = parse_matmul_precision(a), parse_matmul_precision(b)
    if ka == kb:
        return True
    if "fp8-emulated" in (ka, kb):
        return False
    if resolve_device(device).type == "cpu":
        return True
    return _ALLOW_TF32[ka] == _ALLOW_TF32[kb]
