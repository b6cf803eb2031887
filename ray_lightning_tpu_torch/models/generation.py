"""Generation for the Llama family: ``ray_lightning_tpu/models/
generation.py`` in PyTorch. Batched prefill, the dense decode steps
(``decode_step`` at one position for the whole batch, ``decode_step_ragged``
at a position per row), paged decode and ``generate``.

Where the JAX functions return new caches, these update the cache tensors
IN PLACE (and return them too): the KV pool is one device allocation the
engine keeps for its lifetime, and a functional copy per step would double
its memory traffic. The casts of the JAX package are kept: queries go to
fp32 before attention, the attention output goes back to the activations'
dtype, logits come out in fp32. A sliding-window config's dense cache
ROLLS: it holds C = min(max_len, window) positions, position p in slot
p % C, so decode memory is O(window) however long the generation. Decode
attention over a dense cache is fp32 plain torch, as the JAX package
computes it in XLA outside any Pallas kernel. A mixture-of-experts config
routes every token losslessly here, at prefill and at decode (every expert
runs, the top-k gates combine them), as the JAX package's generation does:
prefill and stepwise decode then fill identical caches, whatever the batch.
"""
from __future__ import annotations

import math
import warnings
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

# ``generate`` with an ``eos_id`` reads "has every row finished?" back to the
# host once every this many steps (and before the first), not at every step:
# each read waits for the device. Finished rows are frozen to eos, so the
# extra steps change no output.
EOS_POLL_STEPS = 8


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed cache: k/v of shape [L, B, Hkv, C, head_dim], where
    C = min(max_len, sliding_window) for a windowed config and max_len
    otherwise. A windowed config never attends more than the last W
    positions, so its cache rolls (slot = pos % C)."""
    dev = resolve_device(device)
    length = (min(max_len, cfg.sliding_window) if cfg.sliding_window
              else max_len)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, length, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


def prefill_hidden(params: Dict[str, Any], prompt: torch.Tensor,
                   cfg: LlamaConfig, cache: Dict[str, torch.Tensor],
                   rope_table: Optional[RopeTable] = None) -> torch.Tensor:
    """Run the prompt [B, P] through every layer in one batched pass,
    writing each layer's post-rope (k, v) into ``cache`` in place: positions
    [0, P) when the cache holds P, else (a rolling window cache, C >= the
    window) the last C positions to their slots ``pos % C``. Returns the
    last layer's hidden states [B, P, D]."""
    P = prompt.shape[1]
    C = cache["k"].shape[3]
    if P > C and not (cfg.sliding_window and C >= cfg.sliding_window):
        # dropping all but the last C positions is only sound when the band
        # guarantees they can never be attended again
        raise ValueError(
            f"cache length {C} < prompt length {P}: an undersized cache "
            "silently loses attendable context (rolling is only valid for "
            "sliding-window configs with cache length >= the window)"
        )
    if rope_table is None:
        # sized to the prompt, not the cache: a rolling buffer is shorter
        # than the prompt positions it receives
        rope_table = rope_angles(P, cfg.head_dim, cfg.rope_theta,
                                 scaling=cfg.rope_scaling,
                                 device=prompt.device)
    cos, sin = rope_table[0][:P], rope_table[1][:P]
    window = cfg.sliding_window or None
    slots = (torch.arange(P - C, P, device=prompt.device) % C
             if P > C else None)

    def attn_fn(q, k, v):
        return attention(q, k, v, causal=True, window=window)

    x = params["embed"][prompt.long()]
    for i in range(cfg.n_layers):
        x, (k, v) = _decoder_layer(x, layer_params(params, i), cfg, cos, sin,
                                   attn_fn, moe_lossless=True)
        if slots is None:
            cache["k"][i, :, :, :P] = k
            cache["v"][i, :, :, :P] = v
        else:
            cache["k"][i, :, :, slots] = k[:, :, P - C:].to(cache["k"].dtype)
            cache["v"][i, :, :, slots] = v[:, :, P - C:].to(cache["v"].dtype)
    return x


def prefill(params: Dict[str, Any], prompt: torch.Tensor, cfg: LlamaConfig,
            cache: Dict[str, torch.Tensor],
            rope_table: Optional[RopeTable] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Consume the prompt [B, P] in one batched forward, filling the cache
    in place as ``prefill_hidden`` does. Returns (last-position logits
    [B, V] fp32, the cache)."""
    x = prefill_hidden(params, prompt, cfg, cache, rope_table)
    h = rmsnorm(x[:, -1].contiguous(), params["final_norm"], cfg.norm_eps)
    return (h @ params["lm_head"]).float(), cache


def _refuse_midsized_window_cache(cfg: LlamaConfig, C: int,
                                  total: int) -> None:
    """A cache strictly between the window and the served position range
    ``total`` is unsound: once pos wraps (pos >= C) the band mask compares
    slot indices with absolute positions and attends stale entries. The
    sound sizes are C <= window (rolling) and C >= every served position
    (full)."""
    if cfg.sliding_window and cfg.sliding_window < C < total:
        raise ValueError(
            f"cache length {C} is between sliding_window "
            f"{cfg.sliding_window} and the served position range {total}: "
            "the rolling slot (pos % C) wraps at C while the band mask "
            "compares absolute positions, silently corrupting attention "
            "once pos >= C. Size the cache to the window (rolling) or to "
            "the full position range, or pass a rope_table no longer than "
            "the positions you will actually step"
        )


def dense_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           masked: torch.Tensor) -> torch.Tensor:
    """One query position a row against a dense cache, in fp32 as the JAX
    package's einsums compute it: q [B, Hkv, G, hd] fp32 (GQA folded), k/v
    [B, Hkv, C, hd], ``masked`` [B, 1, 1, C] True where a slot may not be
    attended. Returns [B, Hkv, G, hd] fp32."""
    scores = (q @ k_cache.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores.masked_fill(masked, float("-inf")), dim=-1)
    return probs @ v_cache.float()


def _dense_decode(params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                  token: torch.Tensor, pos: torch.Tensor, cfg: LlamaConfig,
                  rope_table: RopeTable
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over the dense cache [L, B, Hkv, C, hd] with row b
    at position ``pos[b]`` ([B] int64): rope rows gathered per row, a
    per-row write at slot ``pos_b % C``, and attention in fp32 over the C
    slots, where slot s is valid once s <= pos_b, banded by the window only
    when the cache is longer than it (a rolling cache holds exactly the
    band). Rows never see each other's keys."""
    hd = cfg.head_dim
    C = cache["k"].shape[3]
    B = token.shape[0]
    c = rope_table[0][pos][:, None, :]  # [B, 1, hd/2]
    s = rope_table[1][pos][:, None, :]
    rows = torch.arange(B, device=token.device)
    slot = pos % C
    positions = torch.arange(C, device=token.device)
    keep = positions[None, :] <= pos[:, None]  # [B, C]
    if cfg.sliding_window and C > cfg.sliding_window:
        keep &= positions[None, :] > pos[:, None] - cfg.sliding_window
    masked = ~keep[:, None, None, :]  # [B, 1, 1, C]
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
        k_cache, v_cache = cache["k"][i], cache["v"][i]  # [B, Hkv, C, hd]
        k_cache[rows, :, slot, :] = k.to(k_cache.dtype)
        v_cache[rows, :, slot, :] = v.view(B, nkv, hd).to(v_cache.dtype)
        att = dense_decode_attention(q.view(B, nkv, nh // nkv, hd).float(),
                                     k_cache, v_cache, masked)
        x = x + att.reshape(B, nh * hd).to(x.dtype) @ lp["wo"]
        h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        if cfg.n_experts and "moe" in lp:
            x = x + moe_ffn_lossless(lp["moe"], h2[:, None, :],
                                     top_k=cfg.expert_top_k)[:, 0]
        else:
            x = x + (F.silu(h2 @ lp["w_gate"]) * (h2 @ lp["w_up"])) @ lp["w_down"]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float(), cache


def decode_step(params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: int, cfg: LlamaConfig,
                rope_table: Optional[RopeTable] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. token: [B] int; pos: one position (an int) for the
    whole batch, written at cache slot ``pos % C``. Returns (logits [B, V]
    fp32, the cache, updated in place).

    ``rope_table``: (cos, sin) covering every position the caller will
    step (not the cache length, which under a rolling cache is shorter);
    pass it when stepping in a loop so it is built once. The default
    covers ``max(C, cfg.max_seq)`` positions. A windowed config's cache
    strictly between the window and that range is refused."""
    C = cache["k"].shape[3]
    if rope_table is None:
        rope_table = rope_angles(max(C, cfg.max_seq), cfg.head_dim,
                                 cfg.rope_theta, scaling=cfg.rope_scaling,
                                 device=token.device)
    _refuse_midsized_window_cache(cfg, C, int(rope_table[0].shape[0]))
    pos_rows = torch.full((token.shape[0],), int(pos), dtype=torch.long,
                          device=token.device)
    return _dense_decode(params, cache, token, pos_rows, cfg, rope_table)


def decode_step_ragged(params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                       token: torch.Tensor, pos: torch.Tensor,
                       cfg: LlamaConfig, rope_table: Optional[RopeTable] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step with a position per row. token, pos: [B] int. The
    primitive the slot-layout engine steps: the rows of one cache are slots
    holding unrelated requests at different depths. Same math and the same
    refusal as ``decode_step``. Returns (logits [B, V] fp32, the cache,
    updated in place)."""
    C = cache["k"].shape[3]
    if rope_table is None:
        rope_table = rope_angles(max(C, cfg.max_seq), cfg.head_dim,
                                 cfg.rope_theta, scaling=cfg.rope_scaling,
                                 device=token.device)
    _refuse_midsized_window_cache(cfg, C, int(rope_table[0].shape[0]))
    return _dense_decode(params, cache, token, pos.long(), cfg, rope_table)


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


def generate(params: Dict[str, Any], prompt, cfg: LlamaConfig,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             pad_id: Optional[int] = None, top_k: Optional[int] = None,
             top_p: Optional[float] = None, eos_id: Optional[int] = None,
             device: DeviceLike = None) -> torch.Tensor:
    """Generate ``max_new_tokens`` after ``prompt`` [B, P] (dense prompts:
    every row has length P) on ``device`` (the card unless
    ``device="cpu"``), where ``params`` must live. Returns
    [B, P + max_new_tokens].

    One batched ``prefill`` consumes the prompt, then ``decode_step`` runs
    once per new token; one rope table covers all P + max_new_tokens
    positions. A windowed config decodes on a rolling cache of the
    window's length. Temperature 0 is greedy; above it, the categorical
    sample (as the argmax of logits plus Gumbel noise drawn from
    ``generator``, default seeded 0), filtered by ``top_k`` and then by
    nucleus ``top_p``. Rows that have emitted ``eos_id`` keep emitting it;
    once every row has, the decoder stops within ``EOS_POLL_STEPS`` steps
    (the host reads the flag that seldom) and the rest is eos.

    ``pad_id`` is accepted for backward compatibility and ignored, with a
    ``DeprecationWarning``: dense prompts have no padding.
    """
    if pad_id is not None:
        warnings.warn(
            "generate(pad_id=...) is deprecated and ignored: prompts are "
            "dense (all rows share length P), so there is nothing to pad",
            DeprecationWarning,
            stacklevel=2,
        )
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(
            f"params live on {params['embed'].device}, generate runs on {dev}"
        )
    prompt = torch.as_tensor(prompt, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    B, P = prompt.shape
    total = P + max_new_tokens
    cache = init_kv_cache(cfg, B, total, device=dev)
    table = rope_angles(total, cfg.head_dim, cfg.rope_theta,
                        scaling=cfg.rope_scaling, device=dev)

    def sample(logits):
        return _sample_logits(logits, generator, temperature, top_k,
                              top_p).to(prompt.dtype)

    logits, cache = prefill(params, prompt, cfg, cache, table)
    tok = sample(logits)  # the token at position P
    out = [tok]
    done = tok == eos_id if eos_id is not None else None
    for t in range(P, total - 1):
        if (done is not None and (t - P) % EOS_POLL_STEPS == 0
                and bool(done.all())):
            # every row has finished: the rest is eos, with no decoder step
            out += [tok] * (total - 1 - t)
            break
        logits, cache = decode_step(params, cache, tok, t, cfg, table)
        tok = sample(logits)
        if done is not None:
            tok = tok.masked_fill(done, eos_id)
            done |= tok == eos_id
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
