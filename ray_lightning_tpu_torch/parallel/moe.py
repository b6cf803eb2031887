"""Mixture-of-experts FFN on one device, as ``ray_lightning_tpu/parallel/
moe.py``: capacity-bounded top-k routing with one-hot dispatch/combine
einsums and the Switch-Transformer auxiliary loss (``moe_ffn``), and the
no-drop evaluation that generation uses (``moe_ffn_lossless``).

Leaves are stacked over the expert dim: ``router [D, E]`` (fp32 whatever the
model's dtype), ``w_gate``/``w_up [E, D, F]`` and ``w_down [E, F, D]``,
applied as ``x @ W``. The expert products stay library matmuls: the JAX
package computes them outside any Pallas kernel, and their backward in
training is autograd over these plain ops. Expert parallelism
(``moe_ffn_local_experts``, ``moe_param_specs``) is not part of the port
yet: both refuse (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_lightning_tpu_torch.device import DeviceLike, resolve_device


def init_moe_params(generator: torch.Generator, dim: int, ffn_dim: int,
                    n_experts: int, dtype: torch.dtype = torch.bfloat16,
                    n_layers: Optional[int] = None,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random expert leaves N(0, 1/fan_in) in ``dtype`` (the router in
    fp32), with a leading ``[n_layers]`` dim when given, drawn from
    ``generator`` on ``device`` one [in, out] matrix at a time, so the fp32
    draw never holds more than one expert's matrix."""
    dev = resolve_device(device)
    lead = (n_layers,) if n_layers else ()

    def dense(shape, fan_in, dt):
        out = torch.empty(lead + shape, dtype=dt, device=dev)
        for part in out.view(-1, *shape[-2:]):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=dev, dtype=torch.float32)
                       / math.sqrt(fan_in))
        return out

    return {
        "router": dense((dim, n_experts), dim, torch.float32),
        "w_gate": dense((n_experts, dim, ffn_dim), dim, dtype),
        "w_up": dense((n_experts, dim, ffn_dim), dim, dtype),
        "w_down": dense((n_experts, ffn_dim, dim), ffn_dim, dtype),
    }


def _top_k_weights(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """fp32 gates [T, E], the top-k choices as one-hots [T, K, E] (first
    choice first) and their renormalised gate weights [T, K]."""
    e = router.shape[-1]
    gates = torch.softmax(xt.float() @ router.float(), dim=-1)
    top_vals, top_idx = torch.topk(gates, top_k, dim=-1)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    sel = F.one_hot(top_idx, e).float()
    return gates, sel, top_vals


def moe_ffn_lossless(params: Dict[str, Any], x: torch.Tensor,
                     top_k: int = 2) -> torch.Tensor:
    """No-drop MoE for inference: every expert runs on every token, and the
    outputs are summed in fp32, in expert order, weighted by the
    renormalised top-k gates (zero for the experts a token did not pick).
    Equal to :func:`moe_ffn` wherever its capacity does not bind, with no
    [T, E, C] dispatch tensors. x: [B, S, D] -> [B, S, D] in x's dtype."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    _, sel, top_vals = _top_k_weights(xt, params["router"], top_k)
    w = (sel * top_vals[..., None]).sum(dim=1)  # [T, E]
    acc = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for i in range(params["router"].shape[-1]):
        h = F.silu(xt @ params["w_gate"][i]) * (xt @ params["w_up"][i])
        acc = acc + w[:, i, None] * (h @ params["w_down"][i]).float()
    return acc.reshape(b, s, d).to(x.dtype)


def _route(xt: torch.Tensor, router: torch.Tensor, top_k: int,
           capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k selection, capacity-bounded queue positions (first choices of
    every token before any second choice), the dispatch/combine one-hots
    and the load-balancing loss. xt: [T, D] -> (disp [T, E, C], combine
    [T, E, C], aux scalar).

    aux is the Switch-Transformer loss over the raw assignment fractions,
    before capacity truncation: n_experts x sum_i(mean gate_i x
    assignment fraction_i) / top_k."""
    t = xt.shape[0]
    e = router.shape[-1]
    gates, sel, top_vals = _top_k_weights(xt, router, top_k)
    flat = sel.transpose(0, 1).reshape(top_k * t, e)  # k-major priority
    pos = torch.cumsum(flat, dim=0) - flat  # slots taken before each entry
    keep = (pos < capacity).float() * flat
    # a position at or past capacity matches no slot: an all-zero row, as
    # jax.nn.one_hot gives for an index out of range
    slots = torch.arange(capacity, device=xt.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).float()
    disp = (keep[..., None] * pos_oh).reshape(top_k, t, e, capacity).sum(dim=0)
    weights = (sel * top_vals[..., None]).sum(dim=1)  # [T, E]
    combine = disp * weights[:, :, None]
    frac_tokens = sel.sum(dim=1).mean(dim=0)  # [E]
    frac_gates = gates.mean(dim=0)
    aux = e * torch.sum(frac_tokens * frac_gates) / top_k
    return disp, combine, aux


def _expert_ffn(disp: torch.Tensor, combine: torch.Tensor, xt: torch.Tensor,
                params: Dict[str, Any]) -> torch.Tensor:
    """Dispatch -> expert FFNs -> combine. Returns [T, D] fp32."""
    expert_in = torch.einsum("tec,td->ecd", disp, xt.float()).to(
        params["w_gate"].dtype)
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, params["w_gate"])) \
        * torch.einsum("ecd,edf->ecf", expert_in, params["w_up"])
    expert_out = torch.einsum("ecf,efd->ecd", h, params["w_down"])
    return torch.einsum("tec,ecd->td", combine, expert_out.float())


def moe_ffn(params: Dict[str, Any], x: torch.Tensor, top_k: int = 2,
            capacity_factor: float = 1.5, capacity: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded routing: x [B, S, D] -> (out [B, S, D] in x's
    dtype, aux loss). Each expert takes at most ``capacity`` tokens
    (default ``max(1, int(capacity_factor * top_k * T / E))``); a token
    past it loses that expert's contribution."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    t = b * s
    xt = x.reshape(t, d)
    if capacity is None:
        capacity = max(1, int(capacity_factor * top_k * t / e))
    disp, combine, aux = _route(xt, params["router"], top_k, capacity)
    out = _expert_ffn(disp, combine, xt, params)
    return out.reshape(b, s, d).to(x.dtype), aux


_NO_EXPERT_PARALLELISM = (
    "expert parallelism is not ported yet (ROADMAP.md, queue 1: expert "
    "parallelism): the port has no device mesh with an 'ep' axis. A MoE "
    "config trains on one device through moe_ffn, or data-parallel through "
    "RayStrategy"
)


def moe_ffn_local_experts(*args, **kwargs):
    """``parallel/moe.py::moe_ffn_local_experts`` (each 'ep' rank runs its
    own experts, tokens move by all-to-all): refused, see ROADMAP.md."""
    raise NotImplementedError("moe_ffn_local_experts: " + _NO_EXPERT_PARALLELISM)


def moe_param_specs(*args, **kwargs):
    """``parallel/moe.py::moe_param_specs`` (the experts' partition over
    'ep'): refused, see ROADMAP.md."""
    raise NotImplementedError("moe_param_specs: " + _NO_EXPERT_PARALLELISM)
