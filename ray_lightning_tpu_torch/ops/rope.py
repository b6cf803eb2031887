"""Rotary position embeddings, as ``ray_lightning_tpu/ops/rope.py``:
precomputed fp32 (cos, sin) tables, applied in fp32 in split-half form and
cast back. Scaling kinds: none, ``linear`` and ``llama3``; ``yarn`` and
``longrope`` are not ported yet and raise."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.device import DeviceLike


def normalize_rope_scaling(scaling) -> Optional[dict]:
    """HF-style ``rope_scaling`` (a dict or a (key, value)-pair tuple) ->
    plain dict, or None for default/absent. Refuses kinds the port lacks."""
    if not scaling:
        return None
    d = dict(scaling)
    kind = d.get("rope_type", d.get("type", "default"))
    if kind == "default":
        return None
    if kind in ("yarn", "longrope"):
        raise NotImplementedError(
            f"rope_scaling type {kind!r} is not ported yet (the port maps "
            "'linear' and 'llama3')"
        )
    if kind not in ("llama3", "linear"):
        raise NotImplementedError(
            f"rope_scaling type {kind!r}; 'llama3'/'linear' are mapped"
        )
    return d


def _llama3_scale(inv_freq: torch.Tensor, scaling: dict) -> torch.Tensor:
    """Llama-3.1 frequency rescaling, as ``ops/rope.py::_llama3_scale``.
    Computed in numpy float32, one rounding per operation, which matches
    XLA's tables bit for bit where torch's elementwise kernels did not."""
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


def rope_angles(seq_len: int, head_dim: int, theta: float = 500000.0,
                offset: int = 0, scaling=None, *,
                device: DeviceLike) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) fp32 tables of shape [seq_len, head_dim // 2] on
    ``device``."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    scaling = normalize_rope_scaling(scaling)
    if scaling:
        if scaling.get("rope_type", scaling.get("type")) == "llama3":
            inv_freq = _llama3_scale(inv_freq, scaling)
        else:  # "linear"
            inv_freq = inv_freq / float(scaling["factor"])
    positions = torch.arange(offset, offset + seq_len, dtype=torch.float32)
    angles = positions[:, None] * inv_freq[None, :]
    dev = torch.device(device)
    tables = (torch.cos(angles), torch.sin(angles))
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
