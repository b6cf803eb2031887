"""The Llama decoder family in PyTorch: ``ray_lightning_tpu/models/
llama.py`` on one device, dense or mixture of experts, its training loss and
its LightningModule.

Parameters are a plain dict with the JAX package's layout: stacked
``[L, in, out]`` layer leaves applied as ``x @ W``, with a MoE config's
experts in a nested ``layers["moe"]`` subtree, so the converter
(``models/convert.py``) moves tensors without transposing them. A MoE
config trains on one device: ``forward`` routes with the capacity bound and
returns the layers' mean Switch auxiliary loss when asked, ``lm_loss`` adds
it at ``moe_aux_weight``. Expert parallelism runs over the ranks of a Ray
strategy: ``LlamaModule.param_shardings`` gives the layout of a
``ProcessMesh`` with 'dp' and 'ep' axes (``param_specs``), and ``forward``
and ``lm_loss`` take the mesh and route each MoE layer through
``moe_ffn_local_experts`` over its 'ep' group. The pipeline, tensor and
sequence-parallel layouts are not part of the port yet and refuse.
Rematerialisation is per layer (``torch.utils.checkpoint``) with the JAX
package's two policies: ``"nothing"`` recomputes the whole layer in
backward, ``"dots"`` keeps the layer's projections and recomputes the rest.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_lightning_tpu_torch.core.data import DataLoader, DictDataset
from ray_lightning_tpu_torch.core.datamodule import LightningDataModule
from ray_lightning_tpu_torch.core.module import LightningModule
from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.ops.attention import attention, reference_attention
from ray_lightning_tpu_torch.ops.losses import (
    chunked_softmax_cross_entropy,
    masked_softmax_cross_entropy,
)
from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain
from ray_lightning_tpu_torch.ops.rope import (
    apply_rope,
    normalize_rope_scaling,
    rope_angles,
)
from ray_lightning_tpu_torch.parallel.mesh import refuse_unported_axes
from ray_lightning_tpu_torch.parallel.moe import (
    init_moe_params,
    moe_ffn,
    moe_ffn_local_experts,
    moe_ffn_lossless,
    moe_param_specs,
)
from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}

# JAX LlamaConfig fields that steer only what the port does not have (the
# TPU kernels' block sizes, the ring and pipeline paths)
_UNPORTED_FIELDS = (
    "attn_impl", "flash_block_q", "flash_block_k", "ring_load_balance",
    "pp_microbatches", "pp_schedule",
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
    # mixture-of-experts MLP (0 = dense): top-k routing over n_experts;
    # capacity_factor bounds each expert's tokens in forward (generation
    # routes without a bound); moe_aux_weight is the auxiliary loss's
    # weight in lm_loss
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.5
    moe_aux_weight: float = 0.01
    # per-layer rematerialisation in training: "nothing" recomputes the
    # whole layer in backward; "dots" keeps the products with no batch
    # dimension (the layer's projections) and recomputes the rest
    remat: bool = True
    remat_policy: str = "nothing"
    # sequence-chunked LM loss (ops/losses.py): 0/1 = monolithic logits
    loss_chunks: int = 0

    def __post_init__(self):
        if self.remat_policy not in ("nothing", "dots"):
            raise ValueError(
                f"remat_policy={self.remat_policy!r}: expected 'nothing' or "
                "'dots'"
            )
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

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["dtype"] = _DTYPE_NAMES[self.dtype]
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LlamaConfig":
        """Build from a ``to_dict()`` of this class or of the JAX
        ``LlamaConfig``. Fields of what the port lacks (kernel block sizes,
        ring and pipeline knobs) are dropped."""
        d = dict(d)
        for key in _UNPORTED_FIELDS:
            d.pop(key, None)
        if isinstance(d.get("dtype"), str):
            d["dtype"] = _DTYPES[d["dtype"]]
        return LlamaConfig(**d)

    def num_params(self) -> int:
        d, f, v = self.dim, self.ffn_dim, self.vocab_size
        if self.n_experts:
            mlp = d * self.n_experts + 3 * self.n_experts * d * f  # router+experts
        else:
            mlp = 3 * d * f  # gate, up, down
        per_layer = (
            d * (self.n_heads * self.head_dim)  # wq
            + 2 * d * (self.n_kv_heads * self.head_dim)  # wk, wv
            + (self.n_heads * self.head_dim) * d  # wo
            + mlp
            + 2 * d  # norms (qkv biases are not counted, as in JAX)
        )
        return v * d * 2 + self.n_layers * per_layer + d

    def flops_per_token(self) -> float:
        """Training FLOPs per token ~ 6 N plus the attention term (the JAX
        package's formula)."""
        return (6.0 * self.num_params()
                + 12.0 * self.n_layers * self.dim * self.max_seq)

    # ---- presets (the JAX package's widths) ----
    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=256, max_seq=128, remat=False,
        )

    @staticmethod
    def tiny_moe() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=256, max_seq=128, remat=False, n_experts=4,
        )

    @staticmethod
    def mini() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32000, dim=768, n_layers=12, n_heads=6, n_kv_heads=6,
            ffn_dim=2048, max_seq=1024,
        )

    @staticmethod
    def small() -> "LlamaConfig":
        """~0.89 B, seq 2048: the JAX package's single-device training
        config, with the sequence-chunked loss."""
        return LlamaConfig(loss_chunks=8)

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
    the fp32 draw never holds more than one layer (one expert's matrix for
    a MoE config, whose router stays fp32)."""
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
    }
    if cfg.n_experts:
        layers["moe"] = init_moe_params(generator, d, cfg.ffn_dim,
                                        cfg.n_experts, dtype=dt, n_layers=L,
                                        device=dev)
    else:
        layers.update(
            w_gate=dense((L, d, cfg.ffn_dim), d),
            w_up=dense((L, d, cfg.ffn_dim), d),
            w_down=dense((L, cfg.ffn_dim, d), cfg.ffn_dim),
        )
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


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s slice of the stacked leaves, the ``moe`` subtree's
    too (views, no copies)."""
    return tree_map(lambda v: v[i], params["layers"])


Spec = Tuple[Any, ...]


def param_specs(cfg: LlamaConfig) -> Dict[str, Any]:
    """Per-leaf mesh axes (``models/llama.py::param_specs``, its
    ``PartitionSpec`` entries as plain tuples): the megatron tp layout
    (column-parallel in-projections, row-parallel out-projections), 'fsdp'
    on the other big axis, the stacked layer axis over 'pp', a MoE layer's
    experts over 'ep' (``moe_param_specs``). Names a mesh lacks are dropped
    by :func:`filter_spec`."""
    layer_specs: Dict[str, Any] = {
        "attn_norm": ("pp", None),
        "wq": ("pp", "fsdp", "tp"),
        "wk": ("pp", "fsdp", "tp"),
        "wv": ("pp", "fsdp", "tp"),
        "wo": ("pp", "tp", "fsdp"),
        "mlp_norm": ("pp", None),
    }
    if cfg.attn_bias:
        layer_specs.update(bq=("pp", "tp"), bk=("pp", "tp"), bv=("pp", "tp"))
    if cfg.n_experts:
        layer_specs["moe"] = {
            k: ("pp", *s[1:])
            for k, s in moe_param_specs(n_layers=cfg.n_layers).items()
        }
    else:
        layer_specs.update(
            w_gate=("pp", "fsdp", "tp"),
            w_up=("pp", "fsdp", "tp"),
            w_down=("pp", "tp", "fsdp"),
        )
    return {
        "embed": (None, ("fsdp", "tp")),
        "layers": layer_specs,
        "final_norm": (None,),
        "lm_head": ("fsdp", "tp"),
    }


def filter_spec(spec: Spec, axes: Dict[str, int]) -> Spec:
    """``_filter_spec``: drop the axis names a mesh does not have (or has
    at size 1); an emptied tuple entry becomes None."""
    def keep(a):
        return a in axes and axes[a] != 1

    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if keep(a))
            out.append(kept if kept else None)
        else:
            out.append(entry if keep(entry) else None)
    return tuple(out)


def _map_specs(fn, specs):
    """``fn`` over the spec tuples of a nested dict of specs."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def check_expert_parallel(cfg: LlamaConfig, ep: int) -> None:
    """The JAX stage set-up's check: ep must divide the experts."""
    if cfg.n_experts and ep > 1 and cfg.n_experts % ep:
        raise ValueError(f"ep={ep} must divide n_experts={cfg.n_experts}")


def _ep_group(cfg: LlamaConfig, mesh):
    """The mesh's 'ep' group when it splits this config's experts, else
    None (every expert local)."""
    if mesh is None or not cfg.n_experts or mesh.size("ep") == 1:
        return None
    check_expert_parallel(cfg, mesh.size("ep"))
    return mesh.group("ep")


def _decoder_layer(x, lp, cfg: LlamaConfig, cos, sin,
                   attn_fn: Callable, norm_fn: Callable = rmsnorm,
                   moe_lossless: bool = False, with_aux: bool = False,
                   ep_group=None):
    """One pre-norm block (attention + gated MLP or mixture of experts) on
    x [B, S, D]. Returns (x, (k, v)) with this layer's post-rope k, v in
    cache layout [B, Hkv, S, hd] — the prefill path reuses it to fill the
    cache — and, with ``with_aux``, (x, (k, v), aux): the layer's Switch
    auxiliary loss (an fp32 0 for a dense layer and under
    ``moe_lossless``, as in JAX). A MoE layer routes with its capacity
    bound, or every expert densely under ``moe_lossless`` (generation);
    with an ``ep_group`` its experts are this member's slice
    (``moe_ffn_local_experts``)."""
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
    aux = None
    if cfg.n_experts and "moe" in lp and not moe_lossless:
        if ep_group is not None:
            out, aux = moe_ffn_local_experts(
                lp["moe"], h2, ep_group, top_k=cfg.expert_top_k,
                capacity_factor=cfg.capacity_factor)
        else:
            out, aux = moe_ffn(lp["moe"], h2, top_k=cfg.expert_top_k,
                               capacity_factor=cfg.capacity_factor)
        x = x + out
    elif cfg.n_experts and "moe" in lp:
        x = x + moe_ffn_lossless(lp["moe"], h2, top_k=cfg.expert_top_k)
    else:
        x = x + (F.silu(h2 @ lp["w_gate"]) * (h2 @ lp["w_up"])) @ lp["w_down"]
    if not with_aux:
        return x, (k, v)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, (k, v), aux


# the products with no batch dimension: a projection x @ W reaches the
# dispatcher as one aten.mm (or aten.addmm) over the flattened tokens, where
# attention's products are aten.bmm
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of the products with no batch dimension, recompute every
    other op. The kernels launch outside the dispatcher into buffers from
    ``torch.empty``, so nothing but a product may be kept: a kept
    allocation would hand the recompute a buffer the kernel then
    overwrites."""
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(cfg: LlamaConfig) -> Dict[str, Any]:
    kwargs: Dict[str, Any] = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return kwargs


def _flat_layers(layers: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """(key path, leaf) pairs of the layer tree, the ``moe`` subtree's
    leaves under ("moe", name)."""
    for k, v in layers.items():
        if isinstance(v, dict):
            yield from _flat_layers(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflat_layers(paths, leaves) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            plain: bool = False, return_hidden: bool = False,
            return_aux: bool = False, mesh=None):
    """tokens [B, S] -> logits [B, S, V] in ``cfg.dtype``; a MoE config
    routes with its capacity bound, as in JAX. With ``return_hidden`` the
    result is instead the final-norm hidden states [B, S, D]: the chunked
    loss applies the head itself, one sequence chunk at a time. With
    ``return_aux`` the result is the pair (that, moe_aux), as the JAX
    ``forward`` returns it: moe_aux is the mean over the layers of the
    Switch auxiliary loss, an fp32 scalar (0 for a dense config). Without
    it, callers that want only the logits (generation, ``predict_step``)
    get them alone.

    With ``cfg.remat`` and grad mode on, each layer runs under
    ``torch.utils.checkpoint``: backward recomputes it (the flash forward
    and the layer's two norms run again) instead of keeping its
    activations; under ``remat_policy="dots"`` the seven projections'
    outputs are kept and only the rest is recomputed. The auxiliary loss
    leaves the checkpointed layer as its second output: the recompute in
    backward routes the same tokens again to rebuild the saved tensors, and
    its aux is not used. ``plain=True`` runs the kernels' plain versions
    even on CUDA tensors: the reference that tests and the chip check hold
    the kernel path against.

    ``mesh``: a joined ``ProcessMesh`` whose 'ep' axis splits a MoE
    config's experts; ``params`` then hold this member's E / ep experts
    (``LlamaModule.param_shardings``) and every MoE layer runs
    ``moe_ffn_local_experts`` over the 'ep' group (a collective: every
    member of the group runs the same forward)."""
    S = tokens.shape[1]
    ep_group = _ep_group(cfg, mesh)
    dev = tokens.device
    cos, sin = rope_angles(S, cfg.head_dim, cfg.rope_theta,
                           scaling=cfg.rope_scaling, device=dev)
    window = cfg.sliding_window or None
    attn = reference_attention if plain else attention
    norm = rmsnorm_plain if plain else rmsnorm

    def attn_fn(q, k, v):
        return attn(q, k, v, causal=True, window=window)

    paths, stacked = zip(*_flat_layers(params["layers"]))

    def layer_fn(x, *leaves):
        x, _, aux = _decoder_layer(x, _unflat_layers(paths, leaves), cfg, cos,
                                   sin, attn_fn, norm, with_aux=True,
                                   ep_group=ep_group)
        return x, aux

    # unbind once: its backward stacks the L layer gradients in one op,
    # where per-layer indexing would add L full-size zero-padded gradients
    per_layer = [t.unbind(0) for t in stacked]
    remat = _remat_kwargs(cfg) if cfg.remat and torch.is_grad_enabled() else None
    x = params["embed"][tokens.long()]
    auxes = []
    for i in range(cfg.n_layers):
        leaves = [t[i] for t in per_layer]
        if remat is not None:
            x, aux = checkpoint(layer_fn, x, *leaves, **remat)
        else:
            x, aux = layer_fn(x, *leaves)
        auxes.append(aux)
    x = norm(x, params["final_norm"], cfg.norm_eps)
    out = x if return_hidden else x @ params["lm_head"]
    if not return_aux:
        return out
    return out, torch.stack(auxes).mean()


def lm_loss(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            plain: bool = False, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (``models/llama.py::lm_loss``): the full
    sequence is fed, targets are the tokens rolled by one, and the last
    position is masked out. With ``cfg.loss_chunks > 1`` the loss is
    computed over sequence chunks (``ops/losses.py``). A MoE config adds
    ``moe_aux_weight`` times the layers' mean auxiliary loss. Returns
    (loss, {"loss", "ppl"}, and "moe_aux" for a MoE config); ppl is
    exp(cross entropy), without the auxiliary term. ``mesh`` as in
    :func:`forward`."""
    tokens = tokens.long()
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if cfg.loss_chunks > 1:
        h, moe_aux = forward(params, tokens, cfg, plain=plain,
                             return_hidden=True, return_aux=True, mesh=mesh)
        total, count = chunked_softmax_cross_entropy(
            h, params["lm_head"], targets, mask, cfg.loss_chunks
        )
    else:
        logits, moe_aux = forward(params, tokens, cfg, plain=plain,
                                  return_aux=True, mesh=mesh)
        total, count = masked_softmax_cross_entropy(logits, targets, mask)
    ce = total / count
    if not cfg.n_experts:
        return ce, {"loss": ce, "ppl": torch.exp(ce)}
    loss = ce + cfg.moe_aux_weight * moe_aux
    return loss, {"loss": loss, "ppl": torch.exp(ce), "moe_aux": moe_aux}


def _warmup_cosine(step: int, peak: float, warmup: int, decay: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup, decay)`` at
    optimizer step ``step`` (optax's count: the first update sees 0)."""
    if step < warmup:
        return peak * step / warmup
    frac = min(step - warmup, decay - warmup) / (decay - warmup)
    return peak * 0.5 * (1.0 + math.cos(math.pi * frac))


class LlamaModule(LightningModule):
    """The flagship LightningModule: decoder-LM pretraining step
    (``models/llama.py::LlamaModule``)."""

    def __init__(self, config: Optional[LlamaConfig] = None, lr: float = 3e-4,
                 warmup_steps: int = 100, total_steps: int = 10000,
                 weight_decay: float = 0.1):
        super().__init__()
        if isinstance(config, dict):  # rebuilt from checkpoint hparams
            config = LlamaConfig.from_dict(config)
        self.config = config or LlamaConfig.tiny()
        self.lr = lr
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.weight_decay = weight_decay
        self.hparams.update(
            config=self.config.to_dict(),
            lr=lr, warmup_steps=warmup_steps, total_steps=total_steps,
            weight_decay=weight_decay,
        )
        # the ProcessMesh the strategy hands over (param_shardings), in a
        # worker; the steps route the experts over its 'ep' group
        self.mesh = None

    def init_params(self, generator: torch.Generator, device: DeviceLike = None):
        return init_params(self.config, generator, device)

    def param_shardings(self, mesh):
        """The module's layout over ``mesh`` (``LlamaModule.
        param_shardings``): the tree of per-leaf axis tuples,
        :func:`param_specs` filtered to the mesh's axes, or None without a
        mesh. Sets ``self.mesh``, which the steps pass to ``lm_loss``.
        ``mesh`` is a ``ProcessMesh`` (anything with an ``axes`` mapping of
        names to sizes); an axis the port does not lay over ranks ('tp',
        'pp', 'sp', 'fsdp') refuses, and ep must divide the experts."""
        if mesh is None:
            return None
        axes = dict(mesh.axes)
        refuse_unported_axes(axes)
        check_expert_parallel(self.config, axes.get("ep", 1))
        self.mesh = mesh
        return _map_specs(lambda spec: filter_spec(spec, axes),
                          param_specs(self.config))

    def _tokens_of(self, batch):
        if isinstance(batch, dict):
            return batch["input_ids"]
        return batch

    def training_step(self, params, batch, batch_idx):
        loss, logs = lm_loss(params, self._tokens_of(batch), self.config,
                             mesh=self.mesh)
        self.log("train_loss", loss, on_step=True, on_epoch=True)
        self.log("train_ppl", logs["ppl"], on_step=True, on_epoch=False)
        if "moe_aux" in logs:
            self.log("train_moe_aux", logs["moe_aux"], on_step=False,
                     on_epoch=True)
        return loss

    def validation_step(self, params, batch, batch_idx):
        loss, logs = lm_loss(params, self._tokens_of(batch), self.config,
                             mesh=self.mesh)
        self.log("val_loss", loss)
        self.log("val_ppl", logs["ppl"])
        if "moe_aux" in logs:
            self.log("val_moe_aux", logs["moe_aux"])

    def predict_step(self, params, batch, batch_idx):
        return forward(params, self._tokens_of(batch), self.config,
                       mesh=self.mesh)

    def configure_optimizers(self):
        """AdamW (b1 0.9, b2 0.95, eps 1e-8, weight decay on every leaf)
        with a warm-up + cosine schedule, as ``optax.adamw(
        warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1)))``:
        ``LambdaLR`` counts optimizer steps as optax does, so the first
        update uses lr 0."""
        opt = torch.optim.AdamW(list(tree_leaves(self.params)), lr=self.lr,
                                betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=self.weight_decay)
        warmup = self.warmup_steps
        decay = max(self.total_steps, warmup + 1)
        peak = self.lr

        def factor(step):
            return _warmup_cosine(step, peak, warmup, decay) / peak if peak else 0.0

        sched = torch.optim.lr_scheduler.LambdaLR(opt, factor)
        return {"optimizer": opt, "lr_scheduler": sched}

    def generate(self, prompt, max_new_tokens: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None, top_k=None,
                 top_p=None, eos_id=None, device: DeviceLike = None):
        """Cached autoregressive decoding with the trained params
        (``models/generation.py::generate``)."""
        from ray_lightning_tpu_torch.models.generation import generate

        if self.params is None:
            raise ValueError("generate requires trained params; fit first "
                             "or set module.params")
        return generate(self.params, prompt, self.config, max_new_tokens,
                        temperature=temperature, generator=generator,
                        top_k=top_k, top_p=top_p, eos_id=eos_id, device=device)

    def flops_per_sample(self) -> float:
        return self.config.flops_per_token() * self.config.max_seq

    def tokens_per_sample(self) -> int:
        return self.config.max_seq


class SyntheticLMDataModule(LightningDataModule):
    """Learnable synthetic token streams (arithmetic progressions), the JAX
    package's numpy streams from the same seed."""

    def __init__(self, cfg: LlamaConfig, batch_size: int = 8, n_train: int = 256,
                 n_val: int = 64, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.batch_size = batch_size
        self.n_train = n_train
        self.n_val = n_val
        self.seed = seed

    def _make(self, n, seed):
        rng = np.random.default_rng(seed)
        starts = rng.integers(0, self.cfg.vocab_size, size=(n, 1))
        steps = rng.integers(1, 4, size=(n, 1))
        seq = (starts + steps * np.arange(self.cfg.max_seq)[None, :]) % self.cfg.vocab_size
        return DictDataset(input_ids=seq.astype(np.int32))

    def setup(self, stage):
        self.train_data = self._make(self.n_train, self.seed)
        self.val_data = self._make(self.n_val, self.seed + 1)

    def train_dataloader(self):
        return DataLoader(self.train_data, batch_size=self.batch_size,
                          shuffle=True, drop_last=True)

    def val_dataloader(self):
        return DataLoader(self.val_data, batch_size=self.batch_size,
                          drop_last=True)
