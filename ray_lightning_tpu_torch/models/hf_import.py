"""Import Hugging Face Llama-family checkpoints into the port's parameter
dict, as ``ray_lightning_tpu/models/hf_import.py`` does for the JAX
package: Llama, Mistral (with its sliding window), Qwen2 (with its qkv
bias and yarn long-context scaling), Mixtral (mixture of experts) and
Phi-3 (fused projections, longrope scaling).

The family is bit-compatible with the port's Llama (split-half rope,
RMSNorm, SwiGLU, GQA), so an import is a relayout: torch ``[out, in]``
projections transpose to the port's ``[in, out]``, and per-layer tensors
land in the stacked ``[L, ...]`` leaves. The leaves are allocated once on
the target device and filled layer by layer, so the import holds the
source model, the imported tree and one layer in flight.

``transformers`` is touched only when the caller passes a name or path:
the importers take a model object (anything with a ``config`` and a
``state_dict()`` in the ``model.layers.N.`` layout), and a
``SimpleNamespace`` of a published ``config.json`` serves
:func:`config_from_hf`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.models.convert import _layer_specs
from ray_lightning_tpu_torch.models.llama import LlamaConfig
from ray_lightning_tpu_torch.ops.rope import normalize_rope_scaling


def config_from_hf(hf_config, dtype: torch.dtype = torch.bfloat16,
                   **overrides) -> LlamaConfig:
    """Map a ``transformers`` Llama-family config onto :class:`LlamaConfig`.
    yarn's pretrain length defaults to ``max_position_embeddings``;
    longrope's comes from the config's ``original_max_position_embeddings``
    (then ``factor = max_position_embeddings / original``), as in
    ``transformers``. What the port cannot represent is refused rather than
    dropped: unknown rope kinds, a partial rotary factor, MLP or o_proj
    biases, and per-layer window gating."""
    raw = getattr(hf_config, "rope_scaling", None)
    if raw:
        raw = dict(raw)
        kind = raw.get("rope_type", raw.get("type"))
        if kind == "yarn" and not raw.get("original_max_position_embeddings"):
            # absent means max_position_embeddings (transformers'
            # _compute_yarn_parameters)
            raw["original_max_position_embeddings"] = int(
                hf_config.max_position_embeddings)
        if kind == "longrope":
            # Phi-3: the pretrain length lives on the config; when it is
            # there, the attention-factor ratio is max_position / original,
            # over any 'factor' in the dict; absent, max_position is the
            # pretrain length (short factors always) with the dict's factor
            attr_orig = getattr(hf_config, "original_max_position_embeddings",
                                None)
            orig = attr_orig or hf_config.max_position_embeddings
            raw["original_max_position_embeddings"] = int(orig)
            if attr_orig:
                raw["factor"] = (float(hf_config.max_position_embeddings)
                                 / int(orig))
    # refuses unsupported kinds: importing with plain rope_theta would
    # silently change every position's angles
    scaling = normalize_rope_scaling(raw)
    if float(getattr(hf_config, "partial_rotary_factor", 1.0) or 1.0) != 1.0:
        raise NotImplementedError(
            "partial_rotary_factor != 1.0 is not mapped (the rope rotates "
            "the whole head dim)"
        )
    if getattr(hf_config, "mlp_bias", False):
        raise NotImplementedError(
            "mlp_bias checkpoints are not mapped (the MLP is bias-free, as "
            "in the whole Llama/Mistral/Qwen2 family)"
        )
    if getattr(hf_config, "attention_bias", False):
        # HF's attention_bias puts a bias on o_proj too; Qwen2's qkv-only
        # bias has no config attribute and is read from the state_dict
        raise NotImplementedError(
            "attention_bias checkpoints carry an o_proj bias the attention "
            "does not have; only qkv-only bias (Qwen2 family) is mapped"
        )
    # the port's window is uniform across layers, so per-layer gating
    # (Qwen2's max_window_layers, mixed layer_types) refuses
    window = getattr(hf_config, "sliding_window", None)
    if window and not getattr(hf_config, "use_sliding_window", True):
        window = None
    if window:
        n_layers = hf_config.num_hidden_layers
        layer_types = getattr(hf_config, "layer_types", None)
        if layer_types and len(set(layer_types)) > 1:
            raise NotImplementedError(
                f"mixed per-layer attention types {sorted(set(layer_types))}"
                ": the sliding window is uniform across layers"
            )
        if layer_types and set(layer_types) == {"full_attention"}:
            window = None
        # Qwen2: layers with idx >= max_window_layers slide
        mwl = getattr(hf_config, "max_window_layers", None)
        if window and mwl is not None and 0 < mwl < n_layers:
            raise NotImplementedError(
                f"max_window_layers={mwl} of {n_layers}: mixed dense/"
                "windowed layers; the sliding window is uniform"
            )
        if window and mwl is not None and mwl >= n_layers:
            window = None  # no layer slides
    fields = dict(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads", None)
        or hf_config.num_attention_heads,
        ffn_dim=hf_config.intermediate_size,
        max_seq=hf_config.max_position_embeddings,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        rope_scaling=scaling,
        norm_eps=float(hf_config.rms_norm_eps),
        sliding_window=int(window or 0),
        dtype=dtype,
    )
    fields.update(overrides)
    return LlamaConfig(**fields)


def mixtral_config_from_hf(hf_config, dtype: torch.dtype = torch.bfloat16,
                           **overrides) -> LlamaConfig:
    """:func:`config_from_hf` for a Mixtral config: the experts and top-k
    from the config, and ``capacity_factor = E / top_k``, at which the
    capacity bound (``cf * top_k * T / E = T``) never binds, so ``forward``
    routes as Mixtral's token choice does; ``moe_aux_weight`` from
    ``router_aux_loss_coef``."""
    fields = dict(
        n_experts=hf_config.num_local_experts,
        expert_top_k=hf_config.num_experts_per_tok,
        capacity_factor=(
            float(hf_config.num_local_experts) / hf_config.num_experts_per_tok
        ),
        moe_aux_weight=float(getattr(hf_config, "router_aux_loss_coef", 0.001)),
    )
    fields.update(overrides)
    return config_from_hf(hf_config, dtype=dtype, **fields)


def _from_pretrained(class_name: str, path: str):
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            f"loading {path!r} by name or path needs the `transformers` "
            "package; without it, pass a model object instead"
        ) from e
    return getattr(transformers, class_name).from_pretrained(path)


def _make_take(sd: Dict[str, torch.Tensor]) -> Callable:
    def take(name: str, out: torch.Tensor, transpose: bool = False):
        """Copy ``sd[name]`` (transposed from torch's [out, in]) into
        ``out``, casting to its dtype on the way."""
        t = sd[name].detach()
        if tuple(out.shape) != tuple(t.shape[::-1] if transpose else t.shape):
            raise ValueError(
                f"{name}: shape {tuple(t.shape)}, the config needs "
                f"{tuple(out.shape)}{' transposed' if transpose else ''}"
            )
        out.copy_(t.t() if transpose else t)
        return out

    return take


def _check_uniform_heads(cfg: LlamaConfig) -> None:
    if cfg.n_heads * cfg.head_dim != cfg.dim:
        raise ValueError(
            f"hidden_size {cfg.dim} != num_attention_heads {cfg.n_heads} x "
            f"head_dim {cfg.head_dim}: non-uniform head dims are not "
            "supported"
        )


def _empty_layers(cfg: LlamaConfig, dev: torch.device) -> Dict[str, Any]:
    def alloc(specs):
        return {k: alloc(v) if isinstance(v, dict)
                else torch.empty(v[0], dtype=v[1], device=dev)
                for k, v in specs.items()}

    return alloc(_layer_specs(cfg))


def _attn_layer_leaves(take, p: str, layers: Dict[str, Any], i: int,
                       attn_bias: bool = False) -> None:
    """Layer ``i``'s attention and norm leaves, shared by every family
    member."""
    take(p + "input_layernorm.weight", layers["attn_norm"][i])
    take(p + "self_attn.q_proj.weight", layers["wq"][i], True)
    take(p + "self_attn.k_proj.weight", layers["wk"][i], True)
    take(p + "self_attn.v_proj.weight", layers["wv"][i], True)
    take(p + "self_attn.o_proj.weight", layers["wo"][i], True)
    take(p + "post_attention_layernorm.weight", layers["mlp_norm"][i])
    if attn_bias:  # Qwen2-family qkv bias (o_proj stays bias-free)
        take(p + "self_attn.q_proj.bias", layers["bq"][i])
        take(p + "self_attn.k_proj.bias", layers["bk"][i])
        take(p + "self_attn.v_proj.bias", layers["bv"][i])


def _assemble(take, hf_config, cfg: LlamaConfig, layers: Dict[str, Any],
              dev: torch.device) -> Dict[str, Any]:
    d, v, dt = cfg.dim, cfg.vocab_size, cfg.dtype
    embed = take("model.embed_tokens.weight",
                 torch.empty((v, d), dtype=dt, device=dev))
    if getattr(hf_config, "tie_word_embeddings", False):
        # a tied head is the embedding; it gets its own [D, V] tensor (the
        # state_dict may still carry an aliased lm_head.weight: the
        # config's flag decides)
        lm_head = embed.t().contiguous()
    else:
        lm_head = take("lm_head.weight",
                       torch.empty((d, v), dtype=dt, device=dev), True)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": take("model.norm.weight",
                           torch.empty((d,), dtype=dt, device=dev)),
        "lm_head": lm_head,
    }


def import_hf_llama(model_or_path, dtype: torch.dtype = torch.bfloat16,
                    device: DeviceLike = None, **config_overrides
                    ) -> Tuple[Dict[str, Any], LlamaConfig]:
    """``(params, cfg)`` from a ``transformers`` Llama-family model: Llama,
    Mistral (``sliding_window``), Qwen2 (qkv bias, read from the
    state_dict) or anything else with the ``model.layers.N.self_attn/mlp``
    layout, or a name or path for ``AutoModelForCausalLM.from_pretrained``.
    Tied word embeddings become an explicit ``lm_head``. The params land on
    ``device`` (the card unless ``device="cpu"``); ``config_overrides`` go
    to :class:`LlamaConfig`."""
    dev = resolve_device(device)
    if isinstance(model_or_path, str):
        # Auto, not LlamaForCausalLM: a Qwen2 checkpoint loaded through
        # the Llama class drops its qkv biases with only a warning
        model_or_path = _from_pretrained("AutoModelForCausalLM", model_or_path)
    model = model_or_path
    sd = dict(model.state_dict())
    if "model.layers.0.self_attn.o_proj.bias" in sd:
        raise NotImplementedError(
            "o_proj bias is not mapped (no family member ships one; the "
            "out-projection is bias-free)"
        )
    if "model.layers.0.mlp.gate_proj.bias" in sd:
        raise NotImplementedError("mlp bias is not mapped (the MLP is bias-free)")
    config_overrides.setdefault(
        "attn_bias", "model.layers.0.self_attn.q_proj.bias" in sd)
    cfg = config_from_hf(model.config, dtype=dtype, **config_overrides)
    _check_uniform_heads(cfg)
    if cfg.n_experts:
        raise NotImplementedError(
            "n_experts on a dense checkpoint: a Mixtral model imports "
            "through import_hf_mixtral"
        )

    take = _make_take(sd)
    layers = _empty_layers(cfg, dev)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        _attn_layer_leaves(take, p, layers, i, attn_bias=cfg.attn_bias)
        take(p + "mlp.gate_proj.weight", layers["w_gate"][i], True)
        take(p + "mlp.up_proj.weight", layers["w_up"][i], True)
        take(p + "mlp.down_proj.weight", layers["w_down"][i], True)
    return _assemble(take, model.config, cfg, layers, dev), cfg


def import_hf_mixtral(model_or_path, dtype: torch.dtype = torch.bfloat16,
                      device: DeviceLike = None, **config_overrides
                      ) -> Tuple[Dict[str, Any], LlamaConfig]:
    """``(params, cfg)`` from a ``transformers`` Mixtral model, or a name or
    path for ``MixtralForCausalLM.from_pretrained``. The experts map onto
    the ``layers["moe"]`` leaves (w1 = gate, w3 = up, w2 = down; the router
    in fp32), and the routing is Mixtral's: a softmax over the top-k logits
    equals a softmax over all followed by renormalising the top k. The
    config is :func:`mixtral_config_from_hf`'s; a ``sliding_window``
    checkpoint maps onto the attention's band."""
    dev = resolve_device(device)
    if isinstance(model_or_path, str):
        model_or_path = _from_pretrained("MixtralForCausalLM", model_or_path)
    model = model_or_path
    cfg = mixtral_config_from_hf(model.config, dtype=dtype, **config_overrides)
    _check_uniform_heads(cfg)
    if cfg.attn_bias:
        raise NotImplementedError(
            "attn_bias is not supported on the Mixtral import (the family "
            "ships no qkv bias)"
        )
    if not cfg.n_experts:
        raise NotImplementedError(
            "n_experts=0 on a Mixtral checkpoint: a dense model imports "
            "through import_hf_llama"
        )

    take = _make_take(dict(model.state_dict()))
    layers = _empty_layers(cfg, dev)
    moe = layers["moe"]
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        _attn_layer_leaves(take, p, layers, i)
        take(p + "block_sparse_moe.gate.weight", moe["router"][i], True)
        for e in range(cfg.n_experts):
            q = f"{p}block_sparse_moe.experts.{e}."
            take(q + "w1.weight", moe["w_gate"][i, e], True)
            take(q + "w3.weight", moe["w_up"][i, e], True)
            take(q + "w2.weight", moe["w_down"][i, e], True)
    return _assemble(take, model.config, cfg, layers, dev), cfg


def import_hf_phi3(model_or_path, dtype: torch.dtype = torch.bfloat16,
                   device: DeviceLike = None, **config_overrides
                   ) -> Tuple[Dict[str, Any], LlamaConfig]:
    """``(params, cfg)`` from a ``transformers`` Phi-3 model, or a name or
    path for ``AutoModelForCausalLM.from_pretrained``. A Llama-family
    member (RMSNorm, SwiGLU, GQA, no biases) whose qkv and gate/up
    projections ship fused (``self_attn.qkv_proj``, ``mlp.gate_up_proj``):
    they are split along torch's out dim into the separate leaves. Its rope
    is longrope (:func:`config_from_hf`). A table picks the long or the
    short factors by its whole length, where ``transformers`` switches
    mid-generation once the live length crosses the pretrain context: a
    generation that straddles it differs from HF at the crossing."""
    dev = resolve_device(device)
    if isinstance(model_or_path, str):
        model_or_path = _from_pretrained("AutoModelForCausalLM", model_or_path)
    model = model_or_path
    cfg = config_from_hf(model.config, dtype=dtype, **config_overrides)
    _check_uniform_heads(cfg)
    sd = dict(model.state_dict())
    take = _make_take(sd)
    q_rows = cfg.n_heads * cfg.head_dim
    kv_rows = cfg.n_kv_heads * cfg.head_dim
    layers = _empty_layers(cfg, dev)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        take(p + "input_layernorm.weight", layers["attn_norm"][i])
        # the fused [q_rows + 2 kv_rows, D] and [2 F, D] torch layouts, cut
        # by rows and transposed into the [in, out] leaves
        qkv = sd[p + "self_attn.qkv_proj.weight"]
        gate_up = sd[p + "mlp.gate_up_proj.weight"]
        sd.update({p + "wq": qkv[:q_rows], p + "wk": qkv[q_rows:q_rows + kv_rows],
                   p + "wv": qkv[q_rows + kv_rows:],
                   p + "w_gate": gate_up[:cfg.ffn_dim],
                   p + "w_up": gate_up[cfg.ffn_dim:]})
        for name in ("wq", "wk", "wv", "w_gate", "w_up"):
            take(p + name, layers[name][i], True)
        take(p + "self_attn.o_proj.weight", layers["wo"][i], True)
        take(p + "post_attention_layernorm.weight", layers["mlp_norm"][i])
        take(p + "mlp.down_proj.weight", layers["w_down"][i], True)
    return _assemble(take, model.config, cfg, layers, dev), cfg
