"""Prefill and paged decode for the Llama family: the serving path of
``ray_lightning_tpu/models/generation.py`` in PyTorch.

Where the JAX functions return new caches, these update the cache tensors
IN PLACE (and return them too): the KV pool is one device allocation the
engine keeps for its lifetime, and a functional copy per step would double
its memory traffic. The casts of the JAX package are kept: queries go to
fp32 before attention, the attention output goes back to the activations'
dtype, logits come out in fp32. A mixture-of-experts config routes every
token losslessly here, at prefill and at decode (every expert runs, the
top-k gates combine them), as the JAX package's generation does: prefill
and stepwise decode then fill identical caches, whatever the batch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.models.llama import (
    LlamaConfig,
    _decoder_layer,
    layer_params,
)
from ray_lightning_tpu_torch.ops.attention import attention
from ray_lightning_tpu_torch.ops.paged_attention import (
    gumbel_noise,
    paged_decode_attention,
)
from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm
from ray_lightning_tpu_torch.ops.rope import rope_angles, rotate
from ray_lightning_tpu_torch.parallel.moe import moe_ffn_lossless

RopeTable = Tuple[torch.Tensor, torch.Tensor]


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed cache: k/v of shape [L, B, Hkv, max_len, head_dim]. (The
    JAX package rolls a sliding-window cache at the window's length; the
    port keeps every position and lets the attention mask the band.)"""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


def prefill_hidden(params: Dict[str, Any], prompt: torch.Tensor,
                   cfg: LlamaConfig, cache: Dict[str, torch.Tensor],
                   rope_table: Optional[RopeTable] = None) -> torch.Tensor:
    """Run the prompt [B, P] through every layer in one batched pass,
    writing each layer's post-rope (k, v) into ``cache`` positions [0, P)
    in place. Returns the last layer's hidden states [B, P, D]."""
    P = prompt.shape[1]
    if cache["k"].shape[3] < P:
        raise ValueError(
            f"cache length {cache['k'].shape[3]} < prompt length {P}"
        )
    if rope_table is None:
        rope_table = rope_angles(P, cfg.head_dim, cfg.rope_theta,
                                 scaling=cfg.rope_scaling,
                                 device=prompt.device)
    cos, sin = rope_table[0][:P], rope_table[1][:P]
    window = cfg.sliding_window or None

    def attn_fn(q, k, v):
        return attention(q, k, v, causal=True, window=window)

    x = params["embed"][prompt.long()]
    for i in range(cfg.n_layers):
        x, (k, v) = _decoder_layer(x, layer_params(params, i), cfg, cos, sin,
                                   attn_fn, moe_lossless=True)
        cache["k"][i, :, :, :P] = k
        cache["v"][i, :, :, :P] = v
    return x


def prefill(params: Dict[str, Any], prompt: torch.Tensor, cfg: LlamaConfig,
            cache: Dict[str, torch.Tensor],
            rope_table: Optional[RopeTable] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Consume the prompt [B, P] in one batched forward, filling cache
    positions [0, P) in place. Returns (last-position logits [B, V] fp32,
    the cache)."""
    x = prefill_hidden(params, prompt, cfg, cache, rope_table)
    h = rmsnorm(x[:, -1].contiguous(), params["final_norm"], cfg.norm_eps)
    return (h @ params["lm_head"]).float(), cache


def decode_step_paged(params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                      token: torch.Tensor, pos: torch.Tensor,
                      block_tables: torch.Tensor, cfg: LlamaConfig,
                      rope_table: Optional[RopeTable] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over the block-paged cache [L, N, Hkv, bs, hd].
    token, pos: [B] int32 (each row at its own position); block_tables:
    [B, max_blocks] int32. Logical position p of row b lives in physical
    block ``block_tables[b, p // bs]`` at offset ``p % bs``.

    Each layer writes the row's (k, v) there in place — free slots all
    write the trash block, whose duplicate writes are harmless because
    trash is never attended — then attends through the paged decode kernel
    (its plain version for CPU tensors). Returns (logits [B, V] fp32, the
    cache)."""
    if cfg.sliding_window:
        raise ValueError(
            "decode_step_paged requires dense-causal configs: block tables "
            "map positions 1:1 to cache slots"
        )
    hd = cfg.head_dim
    bs = cache["k"].shape[3]
    C = block_tables.shape[1] * bs
    if rope_table is None:
        rope_table = rope_angles(max(C, cfg.max_seq), hd, cfg.rope_theta,
                                 scaling=cfg.rope_scaling,
                                 device=token.device)
    posl = pos.long()
    c = rope_table[0][posl][:, None, :]  # [B, 1, hd/2]
    s = rope_table[1][posl][:, None, :]
    B = token.shape[0]
    phys = block_tables.long().gather(1, (posl // bs)[:, None])[:, 0]
    off = posl % bs
    x = params["embed"][token.long()]  # [B, D]
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        nh = lp["wq"].shape[-1] // hd
        nkv = lp["wk"].shape[-1] // hd
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = h @ lp["wq"]
        k = h @ lp["wk"]
        v = h @ lp["wv"]
        if "bq" in lp:  # Qwen2-family qkv bias
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = rotate(q.view(B, nh, hd), c, s)
        k = rotate(k.view(B, nkv, hd), c, s)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[phys, :, off, :] = k.to(k_cache.dtype)
        v_cache[phys, :, off, :] = v.view(B, nkv, hd).to(v_cache.dtype)
        qf = q.view(B, nkv, nh // nkv, hd).float().contiguous()
        att = paged_decode_attention(qf, k_cache, v_cache, block_tables, pos)
        x = x + att.reshape(B, nh * hd).to(x.dtype) @ lp["wo"]
        h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        if cfg.n_experts and "moe" in lp:
            x = x + moe_ffn_lossless(lp["moe"], h2[:, None, :],
                                     top_k=cfg.expert_top_k)[:, 0]
        else:
            x = x + (F.silu(h2 @ lp["w_gate"]) * (h2 @ lp["w_up"])) @ lp["w_down"]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float(), cache


def _sample_logits(logits: torch.Tensor, generator: torch.Generator,
                   temperature: float, top_k: Optional[int],
                   top_p: Optional[float]) -> torch.Tensor:
    """One sampling step over [B, V] logits in plain torch, for the configs
    the kernel sampler does not cover: top-k first, then nucleus (top-p)
    over the surviving mass, then the temperature-scaled categorical as the
    argmax of logits plus Gumbel noise. Greedy is the argmax. [B] int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    noise = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)
