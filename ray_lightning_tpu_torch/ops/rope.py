"""Rotary position embeddings, as ``ray_lightning_tpu/ops/rope.py``:
precomputed fp32 (cos, sin) tables, applied in fp32 in split-half form and
cast back. Scaling kinds: none, ``linear``, ``llama3``, ``yarn`` (the
Qwen2/DeepSeek long-context scaling) and ``longrope`` (the Phi-3 family);
yarn's and longrope's cos/sin magnitude correction rides the tables.

The scaled frequencies are computed in numpy float32, one rounding per
operation, which matches XLA's tables bit for bit where torch's elementwise
kernels did not."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.device import DeviceLike

_KINDS = ("llama3", "linear", "yarn", "longrope")


def normalize_rope_scaling(scaling) -> Optional[dict]:
    """HF-style ``rope_scaling`` (a dict or a (key, value)-pair tuple) ->
    plain dict, or None for default/absent. Refuses unknown kinds
    (``NotImplementedError``) and, as the JAX package does, yarn or
    longrope without the pretrain length, longrope without its factor
    lists or its ``factor`` (``ValueError``)."""
    if not scaling:
        return None
    d = dict(scaling)
    kind = d.get("rope_type", d.get("type", "default"))
    if kind == "default":
        return None
    if kind not in _KINDS:
        raise NotImplementedError(
            f"rope_scaling type {kind!r}; 'llama3'/'linear'/'yarn'/"
            "'longrope' are mapped"
        )
    if kind in ("yarn", "longrope") and not d.get(
            "original_max_position_embeddings"):
        # both key on the pretrain context length (yarn's correction range,
        # longrope's long/short switch); config_from_hf fills it from the
        # HF config, a hand-built config must say it
        raise ValueError(
            f"{kind} rope_scaling requires "
            "'original_max_position_embeddings' (the pretrain context "
            "length)"
        )
    if kind == "longrope" and not (d.get("long_factor")
                                   and d.get("short_factor")):
        raise ValueError(
            "longrope rope_scaling requires 'long_factor' and "
            "'short_factor' (per-frequency rescale lists)"
        )
    if kind == "longrope" and not d.get("factor"):
        # the magnitude correction derives from it; a default of 1.0 would
        # silently drop the correction HF applies
        raise ValueError(
            "longrope rope_scaling requires 'factor' — the context "
            "extension ratio max_position_embeddings / "
            "original_max_position_embeddings (hf_import injects it; "
            "hand-built configs must state it)"
        )
    return d


def rope_scaling_kind(scaling) -> Optional[str]:
    """The validated rope_scaling type name, or None for default/absent."""
    d = normalize_rope_scaling(scaling)
    return d.get("rope_type", d.get("type")) if d else None


def _llama3_scale(inv_freq: torch.Tensor, scaling: dict) -> torch.Tensor:
    """Llama-3.1 frequency rescaling, as ``ops/rope.py::_llama3_scale``."""
    f32 = np.float32
    factor = f32(scaling["factor"])
    low = f32(scaling.get("low_freq_factor", 1.0))
    high = f32(scaling.get("high_freq_factor", 4.0))
    orig = f32(scaling.get("original_max_position_embeddings", 8192))
    x = inv_freq.numpy()
    low_wavelen = orig / low
    high_wavelen = orig / high
    wavelen = f32(2.0 * math.pi) / x
    scaled = np.where(wavelen > low_wavelen, x / factor, x)
    smooth = (orig / wavelen - low) / (high - low)
    smoothed = (f32(1.0) - smooth) * x / factor + smooth * x
    mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return torch.from_numpy(np.where(mid, smoothed, scaled).astype(f32))


def _yarn_scale(inv_freq: torch.Tensor, scaling: dict, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, float]:
    """YaRN, as ``ops/rope.py::_yarn_scale``: a per-dimension blend of the
    interpolated (inv_freq / factor) and the unchanged frequencies over a
    linear ramp between the beta_fast / beta_slow correction dims, and the
    cos/sin magnitude correction. Returns (inv_freq, attention_factor)."""
    f32 = np.float32
    factor = float(scaling["factor"])
    attention_factor = scaling.get("attention_factor")
    mscale = scaling.get("mscale")
    mscale_all_dim = scaling.get("mscale_all_dim")
    orig = float(scaling["original_max_position_embeddings"])

    def get_mscale(scale, ms=1.0):
        return 1.0 if scale <= 1 else 0.1 * ms * math.log(scale) + 1.0

    if attention_factor is None:
        if mscale and mscale_all_dim:
            attention_factor = float(get_mscale(factor, mscale)
                                     / get_mscale(factor, mscale_all_dim))
        else:
            attention_factor = get_mscale(factor)
    beta_fast = float(scaling.get("beta_fast") or 32)
    beta_slow = float(scaling.get("beta_slow") or 1)

    def correction_dim(num_rotations):
        return (head_dim * math.log(orig / (num_rotations * 2 * math.pi))
                ) / (2 * math.log(theta))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if scaling.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, head_dim - 1)
    if low == high:
        high += 0.001  # no singularity in the ramp
    ramp = np.clip((np.arange(head_dim // 2, dtype=f32) - f32(low))
                   / f32(high - low), f32(0.0), f32(1.0))
    extrapolation = f32(1.0) - ramp
    x = inv_freq.numpy()
    blended = x / f32(factor) * (f32(1.0) - extrapolation) + x * extrapolation
    return torch.from_numpy(blended.astype(f32)), float(attention_factor)


def _longrope_scale(base: torch.Tensor, scaling: dict, head_dim: int,
                    seq_len: int) -> Tuple[torch.Tensor, float]:
    """LongRoPE, as ``ops/rope.py::_longrope_scale``: ``short_factor``
    within the pretrain context, ``long_factor`` when ``seq_len`` reaches
    past it, dividing the frequencies, and a magnitude correction.
    ``base`` is theta ** (2i / head_dim). Returns (inv_freq,
    attention_factor)."""
    f32 = np.float32
    orig = int(scaling["original_max_position_embeddings"])
    ext = np.asarray(scaling["long_factor"] if seq_len > orig
                     else scaling["short_factor"], f32)
    if ext.shape != (head_dim // 2,):
        raise ValueError(
            f"longrope factor lists must have head_dim/2 = {head_dim // 2} "
            f"entries, got {ext.shape}"
        )
    factor = float(scaling.get("factor") or 1.0)
    attention_factor = scaling.get("attention_factor")
    if attention_factor is None:
        attention_factor = (1.0 if factor <= 1.0 else
                            math.sqrt(1.0 + math.log(factor) / math.log(orig)))
    inv_freq = f32(1.0) / (ext * base.numpy())
    return torch.from_numpy(inv_freq.astype(f32)), float(attention_factor)


def rope_angles(seq_len: int, head_dim: int, theta: float = 500000.0,
                offset: int = 0, scaling=None, *,
                device: DeviceLike) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) fp32 tables of shape [seq_len, head_dim // 2] on
    ``device``. longrope picks its long or short factors by ``offset +
    seq_len`` against the pretrain context, so a table serves one length:
    build it once for every position a generation will reach."""
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / np.float32(head_dim)
    # theta ** exponent correctly rounded to fp32, as XLA's pow is (torch's
    # fp32 pow is an ulp off at some head dims and thetas)
    base = torch.from_numpy(
        (np.float64(theta) ** exponent.astype(np.float64)).astype(np.float32))
    inv_freq = 1.0 / base
    attention_factor = 1.0
    scaling = normalize_rope_scaling(scaling)
    if scaling:
        kind = scaling.get("rope_type", scaling.get("type"))
        if kind == "llama3":
            inv_freq = _llama3_scale(inv_freq, scaling)
        elif kind == "yarn":
            inv_freq, attention_factor = _yarn_scale(inv_freq, scaling,
                                                     head_dim, theta)
        elif kind == "longrope":
            inv_freq, attention_factor = _longrope_scale(
                base, scaling, head_dim, offset + seq_len)
        else:  # "linear"
            inv_freq = inv_freq / float(scaling["factor"])
    positions = torch.arange(offset, offset + seq_len, dtype=torch.float32)
    angles = positions[:, None] * inv_freq[None, :]
    dev = torch.device(device)
    tables = (torch.cos(angles), torch.sin(angles))
    if attention_factor != 1.0:
        tables = tuple(t * attention_factor for t in tables)
    if dev.type == "cuda":
        # from pinned memory the copy is asynchronous; a pageable copy
        # would make the host wait for the stream on every forward
        return tuple(t.pin_memory().to(dev, non_blocking=True) for t in tables)
    return tuple(t.to(dev) for t in tables)


def rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Split-half rotation in fp32; ``c``/``s`` broadcast against
    ``x[..., :hd/2]``. Returns x's dtype."""
    dtype = x.dtype
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, n_heads, head_dim]; cos/sin: [seq, head_dim // 2]."""
    return rotate(x, cos[:, None, :], sin[:, None, :])
