"""Generation for the Llama family: ``ray_lightning_tpu/models/
generation.py`` in PyTorch. Batched prefill, the dense decode steps
(``decode_step`` at one position for the whole batch, ``decode_step_ragged``
at a position per row), paged decode, the verify step of self-speculative
decoding (``decode_step_verify``, K positions a row on either KV layout)
and ``generate``.

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
from ray_lightning_tpu_torch.ops.rope import (
    rope_angles,
    rope_scaling_kind,
    rotate,
)
from ray_lightning_tpu_torch.parallel.moe import moe_ffn_lossless

RopeTable = Tuple[torch.Tensor, torch.Tensor]

# ``generate`` with an ``eos_id`` reads "has every row finished?" back to the
# host once every this many steps (and before the first), not at every step:
# each read waits for the device. Finished rows are frozen to eos, so the
# extra steps change no output.
EOS_POLL_STEPS = 8


def require_every_expert(params: Dict[str, Any], cfg: LlamaConfig,
                         where: str) -> None:
    """Generation routes every token over every expert on one device
    (``moe_ffn_lossless``), as the JAX package serves MoE: params that hold
    an expert-parallel member's slice of the experts refuse."""
    if not cfg.n_experts:
        return
    held = params["layers"]["moe"]["w_gate"].shape[1]
    if held != cfg.n_experts:
        raise ValueError(
            f"{where}: the params hold {held} of the config's "
            f"{cfg.n_experts} experts (an expert-parallel member's slice); "
            "generation runs every expert on one device, so it takes the "
            "whole tree (the Ray strategies return it whole)")


def _default_table_or_raise(cfg: LlamaConfig, seq_len: int,
                            device: DeviceLike) -> RopeTable:
    """The rope table of a caller that passed ``rope_table=None``. longrope
    refuses: its long/short factor choice keys on the full generation
    length, so prefill and decode defaults built from different lengths
    could rotate queries and cached keys with different factor sets. Pass
    one shared table (``generate`` builds it from prompt + new tokens)."""
    if rope_scaling_kind(cfg.rope_scaling) == "longrope":
        raise ValueError(
            "longrope configs need an explicit rope_table covering the "
            "full generation length (rope_angles(total, ...)): the "
            "long/short factor choice is length-dependent, and prefill/"
            "decode defaults built from different lengths would rotate "
            "queries and cached keys inconsistently"
        )
    return rope_angles(seq_len, cfg.head_dim, cfg.rope_theta,
                       scaling=cfg.rope_scaling, device=device)


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
        rope_table = _default_table_or_raise(cfg, P, prompt.device)
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
    """Query rows against a dense cache, in fp32 as the JAX package's
    einsums compute it: q [B, Hkv, R, hd] fp32 (GQA folded: R = G query
    heads, or G x K for K positions a row), k/v [B, Hkv, C, hd], ``masked``
    broadcastable to [B, Hkv, R, C], True where a slot may not be attended.
    Returns [B, Hkv, R, hd] fp32."""
    scores = (q @ k_cache.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores.masked_fill(masked, float("-inf")), dim=-1)
    return probs @ v_cache.float()


def _apply_rope_block(x: torch.Tensor, c: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """x: [B, K, H, hd], row b / query i at its own position; c/s:
    [B, K, hd/2] gathered per (row, query)."""
    return rotate(x, c[:, :, None], s[:, :, None])


def _decode_layers(params: Dict[str, Any], cfg: LlamaConfig,
                   tokens: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
                   attend) -> torch.Tensor:
    """The layer stack of every decode step, K positions a row (K = 1 for
    ``decode_step``, ``decode_step_ragged`` and ``decode_step_paged``, the
    candidates for ``decode_step_verify``). tokens: [B, K]; c/s: [B, K,
    hd/2]. ``attend(i, q, k, v)`` takes layer i's post-rope q [B, K, H, hd]
    and k, v [B, K, Hkv, hd], writes k and v into the cache and returns the
    attention [B, K, H * hd]. Returns the logits [B, K, V] fp32."""
    hd = cfg.head_dim
    B, K = tokens.shape
    x = params["embed"][tokens.long()]  # [B, K, D]
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
        q = _apply_rope_block(q.view(B, K, nh, hd), c, s)
        k = _apply_rope_block(k.view(B, K, nkv, hd), c, s)
        att = attend(i, q, k, v.view(B, K, nkv, hd))
        x = x + att.to(x.dtype) @ lp["wo"]
        h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        if cfg.n_experts and "moe" in lp:
            # lossless routing, as everywhere at inference: h2 is [B, K, D]
            x = x + moe_ffn_lossless(lp["moe"], h2, top_k=cfg.expert_top_k)
        else:
            x = x + (F.silu(h2 @ lp["w_gate"]) * (h2 @ lp["w_up"])) @ lp["w_down"]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()


def _dense_attend(write, masked: torch.Tensor):
    """``attend`` of ``_decode_layers`` over a dense view of the cache, in
    fp32 plain torch. ``write(i, k, v)`` stores layer i's k/v [B, K, Hkv,
    hd] and returns its dense view (k, v) [B, Hkv, C, hd], so every
    candidate is written before any is attended; ``masked`` broadcasts
    to the scores [B, Hkv, G * K, C] (rows g-major, k-minor)."""
    def attend(i, q, k, v):
        B, K, nh, hd = q.shape
        kk, vv = write(i, k, v)
        nkv = kk.shape[1]
        group = nh // nkv
        qf = q.view(B, K, nkv, group, hd).permute(0, 2, 3, 1, 4).reshape(
            B, nkv, group * K, hd).float()
        att = dense_decode_attention(qf, kk, vv, masked)
        return att.view(B, nkv, group, K, hd).permute(0, 3, 1, 2, 4).reshape(
            B, K, nh * hd)

    return attend


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

    def write(i, k, v):
        k_cache, v_cache = cache["k"][i], cache["v"][i]  # [B, Hkv, C, hd]
        k_cache[rows, :, slot, :] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, :, slot, :] = v[:, 0].to(v_cache.dtype)
        return k_cache, v_cache

    logits = _decode_layers(params, cfg, token[:, None], c, s,
                            _dense_attend(write, masked))
    return logits[:, 0], cache


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
        rope_table = _default_table_or_raise(cfg, max(C, cfg.max_seq),
                                             token.device)
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
        rope_table = _default_table_or_raise(cfg, max(C, cfg.max_seq),
                                             token.device)
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
        rope_table = _default_table_or_raise(cfg, max(C, cfg.max_seq),
                                             token.device)
    posl = pos.long()
    c = rope_table[0][posl][:, None, :]  # [B, 1, hd/2]
    s = rope_table[1][posl][:, None, :]
    B = token.shape[0]
    phys = block_tables.long().gather(1, (posl // bs)[:, None])[:, 0]
    off = posl % bs

    def attend(i, q, k, v):
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[phys, :, off, :] = k[:, 0].to(k_cache.dtype)
        v_cache[phys, :, off, :] = v[:, 0].to(v_cache.dtype)
        nh, nkv = q.shape[2], k.shape[2]
        qf = q.view(B, nkv, nh // nkv, hd).float().contiguous()
        att = paged_decode_attention(qf, k_cache, v_cache, block_tables, pos)
        return att.reshape(B, 1, nh * hd)

    logits = _decode_layers(params, cfg, token[:, None], c, s, attend)
    return logits[:, 0], cache


def decode_step_verify(params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                       tokens: torch.Tensor, pos: torch.Tensor,
                       cfg: LlamaConfig, rope_table: Optional[RopeTable] = None,
                       block_tables: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Score K candidate positions a row in one pass: the verify step of
    self-speculative decoding. tokens: [B, K] int, row b's candidates for
    positions ``pos[b] .. pos[b] + K - 1`` (t_0 the pending token, then
    the proposals, then padding); pos: [B] int base positions. Returns
    (logits [B, K, V] fp32, where logits[b, i] conditions on t_0..t_i, and
    the cache, updated in place).

    With ``block_tables=None`` the cache is the slot layout ([L, B, Hkv,
    C, hd], as ``decode_step_ragged``); with block tables [B, max_blocks]
    it is the paged layout ([L, N, Hkv, bs, hd], as ``decode_step_paged``).
    Every candidate's (k, v) is written before any is attended, at
    positions clamped to ``C - 1``: a padding query past the budget lands
    in the last slot (slot layout), which no real query attends, or in the
    trash-padded tail of the block table (paged). Query i of row b sees
    positions ``<= pos[b] + i`` (a [B, K, C] mask), so the logits of the
    prefix the host accepts are those of stepping one token at a time.
    The attention is fp32 plain torch over the dense view of the cache (a
    gather through the tables, for the paged layout), as the JAX package
    computes it in XLA: verify does not call the paged decode kernel.

    Sliding-window configs are refused (the serving pools refuse them
    too)."""
    if cfg.sliding_window:
        raise ValueError(
            "decode_step_verify requires dense-causal configs: a rolling "
            "sliding-window buffer wraps positions at pos % window, and a "
            "K-position write burst could wrap onto its own still-"
            "attendable band"
        )
    paged = block_tables is not None
    bs = cache["k"].shape[3]
    C = block_tables.shape[1] * bs if paged else bs
    if rope_table is None:
        rope_table = _default_table_or_raise(cfg, max(C, cfg.max_seq),
                                             tokens.device)
    total = int(rope_table[0].shape[0])
    B, K = tokens.shape
    dev = tokens.device
    qpos = pos.long()[:, None] + torch.arange(K, device=dev)[None, :]  # [B, K]
    # rope rows per (row, query); padding queries clamp into the table
    ridx = qpos.clamp(max=total - 1)
    c, s = rope_table[0][ridx], rope_table[1][ridx]  # [B, K, hd/2]
    wpos = qpos.clamp(max=C - 1)
    keep = torch.arange(C, device=dev)[None, None, :] <= qpos[:, :, None]
    group = cfg.n_heads // cfg.n_kv_heads
    # [B, K, C] -> [B, 1, G * K, C], the scores' rows g-major, k-minor
    masked = (~keep)[:, None, None].expand(B, 1, group, K, C).reshape(
        B, 1, group * K, C)
    if paged:
        tables = block_tables.long()
        phys = tables.gather(1, wpos // bs)  # [B, K]
        off = wpos % bs

        def write(i, k, v):
            k_cache, v_cache = cache["k"][i], cache["v"][i]  # [N, Hkv, bs, hd]
            k_cache[phys, :, off, :] = k.to(k_cache.dtype)
            v_cache[phys, :, off, :] = v.to(v_cache.dtype)
            hkv, hd = k_cache.shape[1], k_cache.shape[3]
            return tuple(
                t[tables].transpose(1, 2).reshape(B, hkv, C, hd)
                for t in (k_cache, v_cache))
    else:
        rows = torch.arange(B, device=dev)[:, None]

        def write(i, k, v):
            k_cache, v_cache = cache["k"][i], cache["v"][i]  # [B, Hkv, C, hd]
            k_cache[rows, :, wpos, :] = k.to(k_cache.dtype)
            v_cache[rows, :, wpos, :] = v.to(v_cache.dtype)
            return k_cache, v_cache

    return _decode_layers(params, cfg, tokens, c, s,
                          _dense_attend(write, masked)), cache


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
    require_every_expert(params, cfg, "generate")
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
