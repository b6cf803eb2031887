"""Carry parameters between the JAX package and the port.

Both keep the same pytree: ``embed [V, D]``, ``layers`` of stacked
``[L, in, out]`` leaves applied as ``x @ W`` (``ray_lightning_tpu/models/
llama.py:209-251``), with a MoE config's ``layers["moe"]`` subtree of
``router [L, D, E]`` (fp32 whatever the model's dtype) and expert stacks
``[L, E, in, out]``, ``final_norm [D]`` and ``lm_head [D, V]``. The caller
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
from ray_lightning_tpu_torch.utils.tree import tree_map


def _layer_specs(cfg: LlamaConfig) -> Dict[str, Any]:
    """Layer leaf -> (shape, dtype); the ``moe`` entry is a nested dict of
    the same."""
    d, hd, L, f = cfg.dim, cfg.head_dim, cfg.n_layers, cfg.ffn_dim
    dt = cfg.dtype
    shapes: Dict[str, Any] = {
        "attn_norm": ((L, d), dt), "mlp_norm": ((L, d), dt),
        "wq": ((L, d, cfg.n_heads * hd), dt),
        "wk": ((L, d, cfg.n_kv_heads * hd), dt),
        "wv": ((L, d, cfg.n_kv_heads * hd), dt),
        "wo": ((L, cfg.n_heads * hd, d), dt),
    }
    if cfg.n_experts:
        e = cfg.n_experts
        shapes["moe"] = {
            "router": ((L, d, e), torch.float32),
            "w_gate": ((L, e, d, f), dt), "w_up": ((L, e, d, f), dt),
            "w_down": ((L, e, f, d), dt),
        }
    else:
        shapes.update(w_gate=((L, d, f), dt), w_up=((L, d, f), dt),
                      w_down=((L, f, d), dt))
    if cfg.attn_bias:
        shapes.update(bq=((L, cfg.n_heads * hd), dt),
                      bk=((L, cfg.n_kv_heads * hd), dt),
                      bv=((L, cfg.n_kv_heads * hd), dt))
    return shapes


def _to_tensor(name: str, arr, shape, dtype: torch.dtype, dev) -> torch.Tensor:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(shape)}")
    if arr.dtype.name == "bfloat16" or (dtype == torch.bfloat16
                                        and arr.dtype == np.uint16):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, config says {dtype}")
    return t.to(dev)


def _layers_from(tree: Dict[str, Any], shapes: Dict[str, Any], prefix: str,
                 dev) -> Dict[str, Any]:
    extra = set(tree) - set(shapes)
    missing = set(shapes) - set(tree)
    if extra or missing:
        raise ValueError(
            f"{prefix} leaves differ from the config: unexpected "
            f"{sorted(extra)}, missing {sorted(missing)}"
        )
    out: Dict[str, Any] = {}
    for k, spec in shapes.items():
        name = f"{prefix}/{k}"
        if isinstance(spec, dict):
            if not isinstance(tree[k], dict):
                raise ValueError(f"{name}: expected a subtree")
            out[k] = _layers_from(tree[k], spec, name, dev)
        else:
            out[k] = _to_tensor(name, tree[k], *spec, dev)
    return out


def params_from_jax(tree: Dict[str, Any], cfg: LlamaConfig,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """JAX Llama params (as numpy) -> the port's parameter dict on
    ``device`` (the card unless ``device="cpu"``). Shapes and dtypes are
    checked against ``cfg``, the MoE router against fp32."""
    dev = resolve_device(device)
    dt = cfg.dtype
    return {
        "embed": _to_tensor("embed", tree["embed"],
                            (cfg.vocab_size, cfg.dim), dt, dev),
        "layers": _layers_from(tree["layers"], _layer_specs(cfg),
                               "layers", dev),
        "final_norm": _to_tensor("final_norm", tree["final_norm"],
                                 (cfg.dim,), dt, dev),
        "lm_head": _to_tensor("lm_head", tree["lm_head"],
                              (cfg.dim, cfg.vocab_size), dt, dev),
    }


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        words = t.view(torch.int16).numpy().view(np.uint16)
        try:  # numpy's bfloat16, once a library (JAX's ml_dtypes) has it
            return words.view(np.dtype("bfloat16"))
        except TypeError:  # none has: the raw 16-bit words
            return words
    return t.numpy()


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: the same tree of numpy arrays.
    bf16 leaves take numpy's ``bfloat16`` (JAX's) where a loaded library
    has registered it, else stay their raw 16-bit words (``uint16``), which
    :func:`params_from_jax` takes back for a bf16 config too."""
    return tree_map(_to_numpy, params)
