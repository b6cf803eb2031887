"""The Llama decoder family in PyTorch: the dense path of
``ray_lightning_tpu/models/llama.py``.

Parameters are a plain dict with the JAX package's layout: stacked
``[L, in, out]`` layer leaves applied as ``x @ W``, so the converter
(``models/convert.py``) moves tensors without transposing them. Training-only
features (mixture of experts, pipeline / tensor / sequence parallelism,
rematerialisation) are not part of the port yet: ``LlamaConfig.from_dict``
refuses a MoE config, and ``forward`` takes no mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.ops.attention import attention, reference_attention
from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain
from ray_lightning_tpu_torch.ops.rope import (
    apply_rope,
    normalize_rope_scaling,
    rope_angles,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# JAX LlamaConfig fields that only steer training or sharding; the port's
# inference path has nothing to set with them
_TRAINING_FIELDS = (
    "remat", "remat_policy", "attn_impl", "flash_block_q", "flash_block_k",
    "expert_top_k", "capacity_factor", "moe_aux_weight", "loss_chunks",
    "ring_load_balance", "pp_microbatches", "pp_schedule",
)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    ffn_dim: int = 5632
    max_seq: int = 2048
    rope_theta: float = 500000.0
    # HF-style rope_scaling ('llama3', 'linear'); stored as a sorted
    # (key, value) tuple so the frozen config stays hashable
    rope_scaling: Optional[Any] = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # sliding-window attention (0 = dense causal), HF Mistral semantics
    sliding_window: int = 0
    # qkv projection bias (Qwen2-family checkpoints)
    attn_bias: bool = False

    def __post_init__(self):
        if self.dtype not in _DTYPES.values():
            raise TypeError(
                f"dtype {self.dtype}: the port runs float32 or bfloat16"
            )
        if self.sliding_window < 0:
            raise ValueError(
                f"sliding_window={self.sliding_window}: must be >= 0"
            )
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads={self.n_heads} must be a multiple of "
                f"n_kv_heads={self.n_kv_heads}"
            )
        if self.rope_scaling is not None:
            normalize_rope_scaling(self.rope_scaling)  # refuses what we lack
            items = tuple(
                (k, tuple(v) if isinstance(v, list) else v)
                for k, v in sorted(dict(self.rope_scaling).items())
            )
            object.__setattr__(self, "rope_scaling", items)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LlamaConfig":
        """Build from a JAX ``LlamaConfig.to_dict()``. Training-only fields
        are dropped; a mixture-of-experts config is refused."""
        d = dict(d)
        if d.pop("n_experts", 0):
            raise NotImplementedError(
                "mixture-of-experts configs are not ported yet (dense path "
                "only)"
            )
        for key in _TRAINING_FIELDS:
            d.pop(key, None)
        if isinstance(d.get("dtype"), str):
            d["dtype"] = _DTYPES[d["dtype"]]
        return LlamaConfig(**d)

    # ---- presets (the JAX package's widths) ----
    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=256, max_seq=128,
        )

    @staticmethod
    def mini() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32000, dim=768, n_layers=12, n_heads=6, n_kv_heads=6,
            ffn_dim=2048, max_seq=1024,
        )

    @staticmethod
    def small() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, ffn_dim=14336, max_seq=8192,
        )


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters N(0, 1/fan_in) in ``cfg.dtype`` on ``device`` (the
    card unless ``device="cpu"``), drawn from ``generator``, which must
    live on that device. Stacked leaves are drawn one layer at a time so
    the fp32 draw never holds more than one layer."""
    dev = resolve_device(device)
    d, hd, L = cfg.dim, cfg.head_dim, cfg.n_layers
    dt = cfg.dtype

    def dense(shape, fan_in, stacked=True):
        out = torch.empty(shape, dtype=dt, device=dev)
        parts = out if stacked else out[None]
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=dev, dtype=torch.float32)
                       / math.sqrt(fan_in))
        return out

    layers = {
        "attn_norm": torch.ones((L, d), dtype=dt, device=dev),
        "wq": dense((L, d, cfg.n_heads * hd), d),
        "wk": dense((L, d, cfg.n_kv_heads * hd), d),
        "wv": dense((L, d, cfg.n_kv_heads * hd), d),
        "wo": dense((L, cfg.n_heads * hd, d), cfg.n_heads * hd),
        "mlp_norm": torch.ones((L, d), dtype=dt, device=dev),
        "w_gate": dense((L, d, cfg.ffn_dim), d),
        "w_up": dense((L, d, cfg.ffn_dim), d),
        "w_down": dense((L, cfg.ffn_dim, d), cfg.ffn_dim),
    }
    if cfg.attn_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            layers[name] = torch.zeros((L, width * hd), dtype=dt, device=dev)
    return {
        "embed": dense((cfg.vocab_size, d), d, stacked=False),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
        "lm_head": dense((d, cfg.vocab_size), d, stacked=False),
    }


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slice of the stacked leaves (views, no copies)."""
    return {k: v[i] for k, v in params["layers"].items()}


def _decoder_layer(x, lp, cfg: LlamaConfig, cos, sin,
                   attn_fn: Callable, norm_fn: Callable = rmsnorm):
    """One pre-norm block (attention + gated MLP) on x [B, S, D]. Returns
    (x, (k, v)) with this layer's post-rope k, v in cache layout
    [B, Hkv, S, hd] — the prefill path reuses it to fill the cache."""
    B, S = x.shape[0], x.shape[1]
    hd = cfg.head_dim
    nh = lp["wq"].shape[-1] // hd
    nkv = lp["wk"].shape[-1] // hd
    h = norm_fn(x, lp["attn_norm"], cfg.norm_eps)
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if "bq" in lp:  # Qwen2-family qkv bias
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = apply_rope(q.view(B, S, nh, hd), cos, sin).transpose(1, 2).contiguous()
    k = apply_rope(k.view(B, S, nkv, hd), cos, sin).transpose(1, 2).contiguous()
    v = v.view(B, S, nkv, hd).transpose(1, 2).contiguous()
    att = attn_fn(q, k, v)
    att = att.transpose(1, 2).reshape(B, S, nh * hd)
    x = x + att @ lp["wo"]
    h2 = norm_fn(x, lp["mlp_norm"], cfg.norm_eps)
    x = x + (F.silu(h2 @ lp["w_gate"]) * (h2 @ lp["w_up"])) @ lp["w_down"]
    return x, (k, v)


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            plain: bool = False) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] in ``cfg.dtype`` (the JAX
    ``forward`` without its MoE auxiliary loss). ``plain=True`` runs the
    kernels' plain versions even on CUDA tensors: the reference that tests
    and the chip check hold the kernel path against."""
    S = tokens.shape[1]
    dev = tokens.device
    cos, sin = rope_angles(S, cfg.head_dim, cfg.rope_theta,
                           scaling=cfg.rope_scaling, device=dev)
    window = cfg.sliding_window or None
    attn = reference_attention if plain else attention
    norm = rmsnorm_plain if plain else rmsnorm

    def attn_fn(q, k, v):
        return attn(q, k, v, causal=True, window=window)

    x = params["embed"][tokens.long()]
    for i in range(cfg.n_layers):
        x, _ = _decoder_layer(x, layer_params(params, i), cfg, cos, sin,
                              attn_fn, norm)
    x = norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"]

