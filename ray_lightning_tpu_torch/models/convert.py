"""Carry parameters between the JAX package and the port.

Both keep the same pytree: ``embed [V, D]``, ``layers`` of stacked
``[L, in, out]`` leaves applied as ``x @ W`` (``ray_lightning_tpu/models/
llama.py:209-251``), ``final_norm [D]`` and ``lm_head [D, V]``. The caller
turns the JAX tree into numpy arrays (``jax.tree.map(np.asarray, params)``);
this module never imports JAX. bfloat16 crosses as its raw 16-bit pattern,
so the round trip is bitwise.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.models.llama import LlamaConfig


def _expected_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    d, hd, L, f = cfg.dim, cfg.head_dim, cfg.n_layers, cfg.ffn_dim
    shapes = {
        "attn_norm": (L, d), "mlp_norm": (L, d),
        "wq": (L, d, cfg.n_heads * hd), "wk": (L, d, cfg.n_kv_heads * hd),
        "wv": (L, d, cfg.n_kv_heads * hd), "wo": (L, cfg.n_heads * hd, d),
        "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d),
    }
    if cfg.attn_bias:
        shapes.update(bq=(L, cfg.n_heads * hd), bk=(L, cfg.n_kv_heads * hd),
                      bv=(L, cfg.n_kv_heads * hd))
    return shapes


def _to_tensor(name: str, arr, shape, cfg: LlamaConfig, dev) -> torch.Tensor:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(shape)}")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    if t.dtype != cfg.dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, config says {cfg.dtype}")
    return t.to(dev)


def params_from_jax(tree: Dict[str, Any], cfg: LlamaConfig,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """JAX Llama params (as numpy) -> the port's parameter dict on
    ``device`` (the card unless ``device="cpu"``). Shapes and dtype are
    checked against ``cfg``; MoE trees are refused."""
    dev = resolve_device(device)
    layers = tree["layers"]
    if "moe" in layers:
        raise NotImplementedError("mixture-of-experts params are not ported yet")
    shapes = _expected_shapes(cfg)
    extra = set(layers) - set(shapes)
    missing = set(shapes) - set(layers)
    if extra or missing:
        raise ValueError(
            f"layer leaves differ from the config: unexpected "
            f"{sorted(extra)}, missing {sorted(missing)}"
        )
    return {
        "embed": _to_tensor("embed", tree["embed"],
                            (cfg.vocab_size, cfg.dim), cfg, dev),
        "layers": {k: _to_tensor(f"layers/{k}", layers[k], s, cfg, dev)
                   for k, s in shapes.items()},
        "final_norm": _to_tensor("final_norm", tree["final_norm"],
                                 (cfg.dim,), cfg, dev),
        "lm_head": _to_tensor("lm_head", tree["lm_head"],
                              (cfg.dim, cfg.vocab_size), cfg, dev),
    }


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16 type (the one JAX uses)

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: the same tree of numpy arrays."""
    return {
        "embed": _to_numpy(params["embed"]),
        "layers": {k: _to_numpy(v) for k, v in params["layers"].items()},
        "final_norm": _to_numpy(params["final_norm"]),
        "lm_head": _to_numpy(params["lm_head"]),
    }
