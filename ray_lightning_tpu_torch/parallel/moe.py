"""Mixture-of-experts FFN on one device, as ``ray_lightning_tpu/parallel/
moe.py``: capacity-bounded top-k routing with one-hot dispatch/combine
einsums and the Switch-Transformer auxiliary loss (``moe_ffn``), and the
no-drop evaluation that generation uses (``moe_ffn_lossless``).

Leaves are stacked over the expert dim: ``router [D, E]`` (fp32 whatever the
model's dtype), ``w_gate``/``w_up [E, D, F]`` and ``w_down [E, F, D]``,
applied as ``x @ W``. The expert products stay library matmuls: the JAX
package computes them outside any Pallas kernel, and their backward in
training is autograd over these plain ops.

Expert parallelism (``moe_ffn_local_experts``) runs over the 'ep' subgroup
of a :class:`~ray_lightning_tpu_torch.parallel.mesh.ProcessMesh`: each
member holds E / ep experts of every layer (``moe_param_specs`` says which
leaves are split), routes over all E with the full router, runs its own
experts and all-reduces the output over the group. The collectives are
autograd Functions, the port's copies of the megatron f/g pair and
``scale_bwd`` (``parallel/pipeline_1f1b.py``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.parallel.data_parallel import all_reduce_


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


def moe_param_specs(n_layers: Optional[int] = None
                    ) -> Dict[str, Tuple[Optional[str], ...]]:
    """The experts' layout over mesh axes, as the JAX ``moe_param_specs``'s
    ``PartitionSpec`` entries in plain tuples: the expert dim over 'ep' (and
    the JAX package's 'fsdp' / 'tp' inside each expert), the router
    replicated; with ``n_layers`` a leading stacked-layer entry ``None``."""
    lead = (None,) if n_layers else ()
    return {
        "router": (*lead, None, None),
        "w_gate": (*lead, "ep", "fsdp", "tp"),
        "w_up": (*lead, "ep", "fsdp", "tp"),
        "w_down": (*lead, "ep", "tp", "fsdp"),
    }


# --------------------------------------------------------------------- #
# the ep collectives as autograd Functions
# --------------------------------------------------------------------- #
def _ep_all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over the ep group (through a host copy under
    gloo, ``data_parallel.all_reduce_``), as a ``moe_ep_all_reduce`` span of
    torch.profiler: what a profiled step reads as the ep collectives' time."""
    with torch.profiler.record_function("moe_ep_all_reduce"):
        return all_reduce_(t, group)


class IdentityFwdAllReduceBwd(torch.autograd.Function):
    """Megatron's "f" (``identity_fwd_psum_bwd``): forward identity,
    backward the sum over the group. Placed where a replicated value
    enters a member's partial computation (its experts), so that each
    member's partial cotangent is summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _ep_all_reduce_(grad.contiguous().clone(), ctx.group), None


class AllReduceFwdIdentityBwd(torch.autograd.Function):
    """Megatron's "g" (``psum_fwd_identity_bwd``): forward the sum over the
    group, backward identity (each member's cotangent of the replicated
    sum is already the cotangent of its partial)."""

    @staticmethod
    def forward(ctx, x, group):
        return _ep_all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ScaleBwd(torch.autograd.Function):
    """``scale_bwd``: forward identity, backward the cotangent times
    ``factor``. A value computed replicated on every member of a group
    whose inputs' cotangents an f operator sums: seeding each member with
    1 / group size makes the sum recover one copy."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.factor, None


def member_share(params: Dict[str, Any], xt: torch.Tensor,
                 router: torch.Tensor, top_k: int, capacity: int, start: int,
                 ep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ep member's part of :func:`moe_ffn_local_experts`, between its
    f operators and its g: routing over all E experts (xt [T, D]), the
    dispatch/combine columns of its experts ``[start, start + E_local)``
    and their FFNs. Returns (the member's partial output [T, D] fp32, aux
    seeded at 1 / ``ep`` in backward); at ``ep`` 1 every expert is local."""
    disp, combine, aux = _route(xt, router, top_k, capacity)
    if ep > 1:
        aux = ScaleBwd.apply(aux, 1.0 / ep)
        e_local = params["w_gate"].shape[0]
        disp = disp[:, start:start + e_local]
        combine = combine[:, start:start + e_local]
    return _expert_ffn(disp, combine, xt, params), aux


def moe_ffn_local_experts(params: Dict[str, Any], x: torch.Tensor, axis,
                          top_k: int = 2, capacity_factor: float = 1.5,
                          capacity: Optional[int] = None, tp_axis=None,
                          vjp_safe: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism (``parallel/moe.py::moe_ffn_local_experts``):
    this member holds E_local = E / ep experts (``w_*`` leaves of
    [E_local, ...]) and the full router; ``axis`` is the 'ep' subgroup of a
    :class:`~ray_lightning_tpu_torch.parallel.mesh.ProcessMesh` (the
    member's ep coordinate is its rank in the group), or ``None`` when
    every expert is local. x: [B, S, D] -> (out [B, S, D] in x's dtype,
    aux).

    Routing (gates, capacity positions, aux) runs over all E experts, with
    the capacity of the member's own tokens, so it is the same on every
    member of the group and top-k and capacity mean what they mean in
    :func:`moe_ffn`. The member slices the dispatch/combine columns of its
    experts, ``[start, start + E_local)`` with ``start`` its ep coordinate
    times E_local, runs them, and the outputs are summed over the group.
    The aux loss needs no collective: every member computes it from the
    full gate matrix.

    Under autograd the collectives are the f/g pair and ``ScaleBwd``: the
    input and the router enter through f (backward sums each member's
    partial cotangent), the combined output leaves through g (forward sum,
    backward identity), and the aux loss is seeded at 1 / ep in backward,
    so that f's sum restores one copy of its cotangent. JAX needs the pair
    only under a manual ``jax.vjp`` (``vjp_safe``), because its autodiff of
    ``shard_map`` transposes a plain ``psum`` itself; torch's
    ``dist.all_reduce`` has no autograd rule, so the port is always in
    JAX's manual case and runs the pair whatever ``vjp_safe`` says (the
    argument stays for the signature). ``tp_axis`` (tensor parallelism
    inside each expert) is not ported and refuses."""
    if tp_axis is not None:
        raise NotImplementedError(
            f"moe_ffn_local_experts(tp_axis={tp_axis!r}): tensor parallelism "
            "inside the experts is not ported yet (ROADMAP.md, queue 1 item "
            "9: the parallelism layer)")
    b, s, d = x.shape
    e = params["router"].shape[-1]
    e_local = params["w_gate"].shape[0]
    t = b * s
    xt = x.reshape(t, d)
    if capacity is None:
        capacity = max(1, int(capacity_factor * top_k * t / e))
    # reduce over ep only when this member really holds a slice of the
    # experts: a sum of whole outputs would multiply them by the group size
    ep_sharded = axis is not None and e_local != e
    router = params["router"]
    if ep_sharded:
        ep = dist.get_world_size(axis)
        if e_local * ep != e:
            raise ValueError(
                f"moe_ffn_local_experts: {e_local} local experts x ep={ep} != "
                f"n_experts={e}")
        xt = IdentityFwdAllReduceBwd.apply(xt, axis)
        router = IdentityFwdAllReduceBwd.apply(router, axis)
    start = dist.get_rank(axis) * e_local if ep_sharded else 0
    out, aux = member_share(params, xt, router, top_k, capacity, start,
                            ep if ep_sharded else 1)
    if ep_sharded:
        out = AllReduceFwdIdentityBwd.apply(out, axis)
    return out.reshape(b, s, d).to(x.dtype), aux
