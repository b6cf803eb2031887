"""The data-parallel engine of the Ray strategies: the collectives that the
JAX package leaves to XLA, written out over ``torch.distributed``, one rank
per process: over the default process group, or over the 'dp' subgroup of a
strategy's ``ProcessMesh``.

The JAX strategies hand GSPMD a ``ShardingPolicy`` and XLA inserts the
collectives; here the Trainer calls the engine at fixed points of a step:

- ``zero_stage`` 0 (``RayStrategy``, ``HorovodRayStrategy``): every rank
  keeps the whole model and optimizer; at each update the accumulated
  gradients are all-reduced to their mean over the ranks, in buckets of at
  most ``bucket_bytes`` over the flat list of gradients (one collective per
  bucket), and every rank then runs the same clip and optimizer step.
- ``zero_stage`` >= 1 (``RayShardedStrategy``): each optimizer parameter
  group's leaves become views into one flat buffer, zero-padded to a
  multiple of the world size; rank r owns elements [r S, (r + 1) S). The
  optimizer holds only that shard (an ``nn.Parameter`` of S elements), so
  its state is 1/world of the whole. Stage 1 all-reduces the flat
  gradient and keeps its shard; stage 2 reduce-scatters it. After the
  shard's step the shards are all-gathered into the flat buffer. Stage 3
  frees the flat buffer after the update (the leaves become empty) and
  gathers it again before the next forward, validation, the epoch's end,
  and the end of fit: the parameters are sharded between steps.

The padding is zero and its gradient is zero, so it adds nothing to the
gradient norm of a clip, and an elementwise optimizer (AdamW's moments,
its weight decay) leaves it at zero: the shards' step is the unsharded
step. Optimizers that are not elementwise are refused under ZeRO.

A ZeRO checkpoint holds whole optimizer states: ``gather_zero_state``
all-gathers each flat group's per-element states (a collective: every rank
calls it at the same point, before rank 0 writes) and cuts them into the
states of the leaves, in the optimizer's original parameter order, which is
the state dict a stage-0 optimizer gives. ``slice_zero_state`` cuts such a
state back to this rank's shards, so a checkpoint written under one (world
size, stage) resumes under another, as the JAX package's whole-state
checkpoint does.

With the gloo backend (CPU ranks, or ranks sharing one card) collectives
run on host copies of the buffers; with NCCL on the card itself
(``all_reduce_``, which the ep collectives of ``parallel/moe.py`` share).
A group of one rank skips its collectives: they are identities.

Under a mesh with an 'ep' axis (expert parallelism) each member of an ep
group holds E / ep experts of every MoE layer (``shard_experts``, by the
module's ``param_shardings``) and sees the same batch as the other members.
The f operator of ``moe_ffn_local_experts`` makes the other gradients equal
over the ep group and the expert leaves are this member's slice, so the
gradients, the ZeRO shards and the metrics reduce over the dp group alone.
A clip takes the global norm of the whole model: the expert slices' squares
are summed over the ep group, the rest counted once (ZeRO keeps the expert
leaves in flat groups of their own for it). The whole tree leaves a worker
through ``gather_experts`` (an all-gather over the ep group).
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map

# torch 2.13 renamed the flat-tensor collectives; older releases have only
# the *_tensor names
_ALL_GATHER = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_REDUCE_SCATTER = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)



# called while a gloo collective waits (the Trainer sets it when its worker
# beats to a hang supervisor): a rank waiting for a peer stays alive to the
# supervisor, so that only the rank that hung goes silent
_beat: Optional[Callable[[], None]] = None


def set_collective_beat(beat: Optional[Callable[[], None]]) -> None:
    global _beat
    _beat = beat


def _gloo_call(fn, *args, **kwargs) -> None:
    """Run a gloo collective, beating while it waits when a beat is set (a
    gloo collective blocks the host anyway: polling its work adds nothing
    to the device's timeline)."""
    if _beat is None:
        fn(*args, **kwargs)
        return
    work = fn(*args, async_op=True, **kwargs)
    while not work.is_completed():
        _beat()
        time.sleep(0.0005)
    work.wait()


def all_reduce_(t: torch.Tensor, group=None,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` in place over ``group`` (the default group when None).
    A gloo group reduces host buffers, so a tensor on the card goes through
    a host copy (the copy out, the reduction, the copy back); NCCL reduces
    it where it lies."""
    if dist.get_backend(group) == "gloo":
        host = t.cpu() if t.device.type != "cpu" else t
        _gloo_call(dist.all_reduce, host, op=op, group=group)
        if host is not t:
            t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


# optimizers whose update of an element reads only that element's gradient
# and state: stepping a shard equals stepping the whole
_ELEMENTWISE = (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW,
                torch.optim.Adamax, torch.optim.NAdam, torch.optim.RAdam,
                torch.optim.RMSprop, torch.optim.Adagrad, torch.optim.Adadelta,
                torch.optim.ASGD, torch.optim.Rprop)


class _FlatGroup:
    """One optimizer parameter group's leaves as views into a flat buffer
    of ``size`` elements (a multiple of the world size), and this rank's
    shard of it, the parameter the optimizer steps."""

    def __init__(self, leaves: List[torch.nn.Parameter], world: int, rank: int,
                 expert: bool = False):
        dtypes = {t.dtype for t in leaves}
        devices = {t.device for t in leaves}
        if len(dtypes) != 1 or len(devices) != 1:
            raise NotImplementedError(
                f"ZeRO needs each optimizer parameter group in one dtype on "
                f"one device, got {sorted(map(str, dtypes))} on "
                f"{sorted(map(str, devices))}")
        self.leaves = leaves
        # the leaves are expert slices (their squares sum over the ep group)
        self.expert = expert
        self.dtype, self.device = dtypes.pop(), devices.pop()
        self.shapes = [t.shape for t in leaves]
        self.numels = [t.numel() for t in leaves]
        self.offsets = np.cumsum([0] + self.numels[:-1]).tolist()
        numel = sum(self.numels)
        self.shard_size = max(1, math.ceil(numel / world))
        self.size = self.shard_size * world
        self.rank = rank
        full = torch.zeros(self.size, dtype=self.dtype, device=self.device)
        for leaf, o, k in zip(leaves, self.offsets, self.numels):
            full[o:o + k].copy_(leaf.detach().reshape(-1))
        lo = rank * self.shard_size
        self.shard = torch.nn.Parameter(full[lo:lo + self.shard_size].clone())
        self.full: Optional[torch.Tensor] = None
        self.bind(full)

    def bind(self, full: torch.Tensor) -> None:
        """Make every leaf a view of ``full``."""
        self.full = full
        for leaf, o, k, shape in zip(self.leaves, self.offsets, self.numels,
                                     self.shapes):
            leaf.data = full[o:o + k].view(shape)

    def release(self) -> None:
        """Drop the flat buffer: every leaf becomes an empty tensor."""
        self.full = None
        for leaf in self.leaves:
            leaf.data = torch.empty(0, dtype=self.dtype, device=self.device)

    def flat_grad(self) -> torch.Tensor:
        g = torch.zeros(self.size, dtype=self.dtype, device=self.device)
        for leaf, o, k in zip(self.leaves, self.offsets, self.numels):
            if leaf.grad is not None:
                g[o:o + k].copy_(leaf.grad.reshape(-1))
        return g


class DataParallel:
    """The collectives of one rank. ``world_size`` and ``rank`` are the
    size of ``group`` and this rank's place in it (the default group when
    ``group`` is None); ``comm_device`` is where buffers must lie for the
    process group's backend (the CPU for gloo). ``ep_group`` is the mesh's
    'ep' subgroup, of ``ep_size`` members of which this rank is
    ``ep_rank``, when expert parallelism splits the experts."""

    def __init__(self, world_size: int, rank: int, zero_stage: int,
                 comm_device: torch.device, bucket_bytes: int = 25 * 2 ** 20,
                 group=None, ep_group=None, ep_size: int = 1, ep_rank: int = 0):
        self.world = int(world_size)
        self.rank = int(rank)
        self.zero_stage = int(zero_stage)
        self.comm_device = torch.device(comm_device)
        self.bucket_bytes = int(bucket_bytes)
        self.group = group
        # a group of one rank: its collectives are identities, skipped
        self._solo = self.world == 1
        self.ep_group = ep_group if ep_size > 1 else None
        self.ep_size = int(ep_size)
        self.ep_rank = int(ep_rank)
        # flat index (tree_leaves order) of each expert leaf -> its ep dim,
        # and the same by the leaf's id
        self.expert_dims: Dict[int, int] = {}
        self._dim_of: Dict[int, int] = {}
        # _Update index -> its flat groups (ZeRO)
        self._groups: Dict[int, List[_FlatGroup]] = {}
        # ZeRO: id(shard) -> its flat group; id(optimizer) -> its parameter
        # groups' leaves before they were re-pointed at the shards
        self._group_of_shard: Dict[int, _FlatGroup] = {}
        self._leaves_of: Dict[int, List[List[torch.Tensor]]] = {}

    # ------------------------------------------------------------------ #
    # collectives on the backend's device
    # ------------------------------------------------------------------ #
    def _on_comm(self, t: torch.Tensor) -> torch.Tensor:
        return t if t.device == self.comm_device else t.to(self.comm_device)

    def _all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                     over_ep: bool = False) -> None:
        """In place over the dp group (the ep group with ``over_ep``)."""
        if self._solo and not over_ep:
            return
        all_reduce_(t, self.ep_group if over_ep else self.group, op)

    def _call(self, fn, *args, **kwargs) -> None:
        if self.comm_device.type == "cpu":
            _gloo_call(fn, *args, **kwargs)
        else:
            fn(*args, **kwargs)

    def _reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        if self._solo:
            out.copy_(inp)
            return
        c_out, c_in = self._on_comm(out), self._on_comm(inp)
        self._call(_REDUCE_SCATTER, c_out, c_in, group=self.group)
        if c_out is not out:
            out.copy_(c_out)

    def _all_gather(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        if self._solo:
            out.copy_(inp)
            return
        c_out, c_in = self._on_comm(out), self._on_comm(inp)
        self._call(_ALL_GATHER, c_out, c_in, group=self.group)
        if c_out is not out:
            out.copy_(c_out)

    # ------------------------------------------------------------------ #
    # set-up
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def broadcast_(self, leaves: List[torch.Tensor]) -> None:
        """Every rank starts from global rank 0's tensors (as DDP's first
        broadcast does): over the whole world, whatever the mesh, so that an
        ep group's members share the replicated leaves and the experts they
        slice from the whole tree."""
        for t in leaves:
            c = self._on_comm(t.data)
            dist.broadcast(c, src=0)
            if c is not t.data:
                t.data.copy_(c)

    # ------------------------------------------------------------------ #
    # expert parallelism: this member's slice of the experts
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def shard_experts(self, params, specs):
        """The tree with every leaf whose spec (``param_shardings``) has 'ep'
        cut to this member's slice along that dim: ``[ep_rank * n / ep,
        (ep_rank + 1) * n / ep)``, a new ``nn.Parameter`` (the whole leaf is
        freed). Records the expert leaves for the clip, ZeRO and
        :meth:`gather_experts`."""
        flat_specs = _specs_by_leaf(params, specs)
        leaves = list(tree_leaves(params))
        self.expert_dims = {i: spec.index("ep") for i, spec in
                            enumerate(flat_specs) if spec and "ep" in spec}
        out = iter([torch.nn.Parameter(
            self.slice_expert(t.detach(), self.expert_dims[i]).clone(),
            requires_grad=t.requires_grad) if i in self.expert_dims else t
            for i, t in enumerate(leaves)])
        tree = tree_map(lambda _: next(out), params)
        self._dim_of = {id(t): self.expert_dims[i]
                        for i, t in enumerate(tree_leaves(tree))
                        if i in self.expert_dims}
        return tree

    def slice_expert(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This member's slice of a whole expert leaf (a view)."""
        n = t.shape[dim]
        if n % self.ep_size:
            raise ValueError(f"ep={self.ep_size} must divide the expert dim "
                             f"{n} of a leaf of shape {tuple(t.shape)}")
        per = n // self.ep_size
        return t.narrow(dim, self.ep_rank * per, per)

    def is_expert(self, leaf: torch.Tensor) -> bool:
        return id(leaf) in self._dim_of

    @torch.no_grad()
    def gather_expert(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf from every member's slice (an all-gather over the
        ep group: every member calls it at the same point). The result lies
        on the backend's device (the host for gloo)."""
        c = self._on_comm(t.detach()).contiguous()
        parts = [torch.empty_like(c) for _ in range(self.ep_size)]
        dist.all_gather(parts, c, group=self.ep_group)
        return torch.cat(parts, dim=dim)

    def gather_experts(self, params):
        """The tree with every expert leaf whole (:meth:`gather_expert`, in
        tree order), the other leaves detached as they are."""
        leaves = iter([self.gather_expert(t, self.expert_dims[i])
                       if i in self.expert_dims else t.detach()
                       for i, t in enumerate(tree_leaves(params))])
        return tree_map(lambda _: next(leaves), params)

    def gather_optimizer_state(self, opt) -> Dict[str, Any]:
        """``opt.state_dict()`` with each expert leaf's per-element states
        (those of the leaf's shape: AdamW's moments) gathered whole, in the
        optimizer's parameter order (a collective, as :meth:`gather_expert`)."""
        sd = opt.state_dict()
        state = dict(sd["state"])
        held = [p for g in opt.param_groups for p in g["params"]]
        for idx, p in enumerate(held):
            if self.is_expert(p) and idx in state:
                state[idx] = {
                    k: self.gather_expert(v, self._dim_of[id(p)])
                    if torch.is_tensor(v) and v.shape == p.shape else v
                    for k, v in state[idx].items()}
        return {**sd, "state": state}

    def slice_optimizer_state(self, opt, sd: Dict[str, Any]) -> Dict[str, Any]:
        """A state of :meth:`gather_optimizer_state` cut back to this
        member's expert slices."""
        state = dict(sd["state"])
        held = [p for g in opt.param_groups for p in g["params"]]
        for idx, p in enumerate(held):
            if not self.is_expert(p) or idx not in state:
                continue
            dim = self._dim_of[id(p)]
            whole = p.shape[dim] * self.ep_size
            state[idx] = {
                k: self.slice_expert(v, dim) if torch.is_tensor(v)
                and v.dim() == p.dim() and v.shape[dim] == whole else v
                for k, v in state[idx].items()}
        return {**sd, "state": state}

    def gather_grads(self, leaves: List[torch.Tensor]
                     ) -> List[Optional[torch.Tensor]]:
        """The leaves' gradients, each expert leaf's gathered whole (a
        collective, as :meth:`gather_expert`)."""
        return [None if t.grad is None else (
            self.gather_expert(t.grad, self._dim_of[id(t)]) if self.is_expert(t)
            else t.grad.detach()) for t in leaves]

    def slice_whole(self, tree):
        """A whole tree (a checkpoint's) cut to this member's expert
        slices, by the recorded dims."""
        leaves = iter([self.slice_expert(t, self.expert_dims[i])
                       if i in self.expert_dims else t
                       for i, t in enumerate(tree_leaves(tree))])
        return tree_map(lambda _: next(leaves), tree)

    # ------------------------------------------------------------------ #
    # ZeRO set-up
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def setup(self, updates) -> None:
        """Under ZeRO: the flat groups of every update's optimizers, each
        optimizer group re-pointed at its shards (before its first step, so
        no state exists yet); an optimizer group's expert leaves get a flat
        group of their own."""
        if not self.zero_stage:
            return
        for u, unit in enumerate(updates):
            groups = []
            for opt in unit.optimizers:
                if not isinstance(opt, _ELEMENTWISE):
                    raise NotImplementedError(
                        f"ZeRO stage {self.zero_stage} with "
                        f"{type(opt).__name__}: a shard's step equals the "
                        "whole step only for elementwise optimizers "
                        f"({', '.join(c.__name__ for c in _ELEMENTWISE)}); "
                        "use RayStrategy (zero_stage 0)")
                if opt.state:
                    raise RuntimeError("ZeRO set-up after an optimizer step")
                self._leaves_of[id(opt)] = [list(g["params"])
                                            for g in opt.param_groups]
                for group in opt.param_groups:
                    leaves = [p for p in group["params"] if p.requires_grad]
                    made = []
                    for expert in (False, True):
                        part = [p for p in leaves if self.is_expert(p) == expert]
                        if part:
                            made.append(_FlatGroup(part, self.world, self.rank,
                                                   expert))
                    if not made:
                        continue
                    group["params"] = [fg.shard for fg in made]
                    groups.extend(made)
                    self._group_of_shard.update({id(fg.shard): fg
                                                 for fg in made})
            self._groups[u] = groups

    def zero_gather_bytes(self) -> Dict[str, int]:
        """The ZeRO parameter all-gather of one update (stages 1-2 after
        the step, stage 3 before the next forward): ``wire`` bytes as
        gathered (the flat buffers in their own dtype), ``fp32`` bytes of
        the same elements in fp32, and the ``leaves`` sharded (the JAX
        ``ZeroContext``'s ``gather_wire_bytes``, ``gather_fp32_bytes`` and
        ``big_leaves``; the port shards every trained leaf)."""
        groups = [fg for gs in self._groups.values() for fg in gs]
        return {"wire": sum(fg.size * fg.shard.element_size() for fg in groups),
                "fp32": sum(4 * fg.size for fg in groups),
                "leaves": sum(len(fg.leaves) for fg in groups)}

    @torch.no_grad()
    def sync_shards(self) -> None:
        """Copy each flat buffer's slice into this rank's shard: after the
        leaves were written in place (a checkpoint's restore), the shards
        the optimizer steps hold the same values."""
        for groups in self._groups.values():
            for fg in groups:
                lo = fg.rank * fg.shard_size
                fg.shard.copy_(fg.full[lo:lo + fg.shard_size])

    # ------------------------------------------------------------------ #
    # ZeRO checkpoints: whole optimizer states
    # ------------------------------------------------------------------ #
    def _whole_shape(self, leaf: torch.Tensor) -> torch.Size:
        """A leaf's shape in the whole model (an expert slice's whole leaf)."""
        if not self.is_expert(leaf):
            return leaf.shape
        shape = list(leaf.shape)
        shape[self._dim_of[id(leaf)]] *= self.ep_size
        return torch.Size(shape)

    def _whole_index(self, opt) -> Dict[int, int]:
        """id(leaf) -> the leaf's index in a stage-0 state dict of ``opt``
        (its parameter groups' leaves before ZeRO re-pointed them)."""
        index: Dict[int, int] = {}
        for group in self._leaves_of[id(opt)]:
            for leaf in group:
                index.setdefault(id(leaf), len(index))
        return index

    @torch.no_grad()
    def gather_zero_state(self, opt) -> Dict[str, Any]:
        """``opt``'s state under ZeRO as a stage-0 optimizer of the whole
        model gives it: each shard's per-element states (those of the
        shard's shape) all-gathered into the flat buffer's and cut into the
        leaves' (expert slices also gathered over the ep group), scalar
        states (AdamW's step) given to every leaf of the group, indexed in
        the optimizer's original parameter order. A collective: every rank
        calls it for the same optimizers in the same order."""
        sd = opt.state_dict()
        originals = self._leaves_of[id(opt)]
        index = self._whole_index(opt)
        state: Dict[int, Dict[str, Any]] = {}
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p)
                if not st:
                    continue
                fg = self._group_of_shard.get(id(p))
                if fg is None:  # a leaf kept whole (no shard)
                    state[index[id(p)]] = {k: v.clone() if torch.is_tensor(v)
                                           else v for k, v in st.items()}
                    continue
                flat = {}
                for key, v in st.items():
                    if _per_element(key, v, p.shape):
                        full = torch.empty(fg.size, dtype=v.dtype,
                                           device=v.device)
                        self._all_gather(full, v.detach())
                        flat[key] = full
                for leaf, o, k, shape in zip(fg.leaves, fg.offsets, fg.numels,
                                             fg.shapes):
                    leaf_state = {}
                    for key, v in st.items():
                        if key in flat:
                            t = flat[key][o:o + k].view(shape)
                            leaf_state[key] = (
                                self.gather_expert(t, self._dim_of[id(leaf)])
                                if self.is_expert(leaf) else t.clone())
                        else:
                            # one tensor a leaf: a stage-0 optimizer steps
                            # each leaf's own
                            leaf_state[key] = (v.clone() if torch.is_tensor(v)
                                               else v)
                    state[index[id(leaf)]] = leaf_state
        groups = [dict(g, params=[index[id(leaf)] for leaf in leaves])
                  for g, leaves in zip(sd["param_groups"], originals)]
        return {"state": state, "param_groups": groups}

    def slice_zero_state(self, opt, sd: Dict[str, Any]) -> Dict[str, Any]:
        """A whole state (:meth:`gather_zero_state`'s, or a stage-0
        optimizer's) cut to this rank's shards, as ``opt.state_dict()``
        would give it under ZeRO: each flat group's per-element states laid
        into its zero-padded flat buffer and sliced, its scalar states taken
        from its first leaf."""
        originals = self._leaves_of[id(opt)]
        if len(sd["param_groups"]) != len(originals):
            raise ValueError(
                f"the checkpoint's optimizer has {len(sd['param_groups'])} "
                f"parameter groups, this one {len(originals)}")
        index = self._whole_index(opt)
        whole = sd["state"]
        state: Dict[int, Dict[str, Any]] = {}
        groups = []
        n = 0
        for saved, group in zip(sd["param_groups"], opt.param_groups):
            ids = []
            for p in group["params"]:
                ids.append(n)
                fg = self._group_of_shard.get(id(p))
                if fg is None:
                    if index[id(p)] in whole:
                        state[n] = whole[index[id(p)]]
                    n += 1
                    continue
                per_leaf = [whole.get(index[id(leaf)]) for leaf in fg.leaves]
                n += 1
                if all(st is None for st in per_leaf):
                    continue
                if any(st is None for st in per_leaf):
                    raise ValueError(
                        "the checkpoint holds optimizer states for some "
                        "leaves of a parameter group and not for others")
                first = per_leaf[0]
                shard_state = {}
                lo = fg.rank * fg.shard_size
                for key, v in first.items():
                    if not _per_element(key, v, self._whole_shape(fg.leaves[0])):
                        shard_state[key] = v.clone() if torch.is_tensor(v) else v
                        continue
                    flat = torch.zeros(fg.size, dtype=v.dtype)
                    for leaf, st, o, k in zip(fg.leaves, per_leaf, fg.offsets,
                                              fg.numels):
                        t = st[key]
                        if self.is_expert(leaf):
                            t = self.slice_expert(t, self._dim_of[id(leaf)])
                        flat[o:o + k].copy_(t.reshape(-1))
                    shard_state[key] = flat[lo:lo + fg.shard_size].clone()
                state[ids[-1]] = shard_state
            groups.append(dict(saved, params=ids))
        return {"state": state, "param_groups": groups}

    # ------------------------------------------------------------------ #
    # the update
    # ------------------------------------------------------------------ #
    def _buckets(self, grads: List[torch.Tensor]) -> List[List[torch.Tensor]]:
        """Stage 0's buckets: runs of the flat list of at most
        ``bucket_bytes``, each in one dtype on one device."""
        buckets: List[List[torch.Tensor]] = []
        size = 0
        for g in grads:
            nbytes = g.numel() * g.element_size()
            if (not buckets or size + nbytes > self.bucket_bytes
                    or g.dtype != buckets[-1][0].dtype
                    or g.device != buckets[-1][0].device):
                buckets.append([])
                size = 0
            buckets[-1].append(g)
            size += nbytes
        return buckets

    def step_collectives(self, updates, clip: Optional[float]
                         ) -> Dict[str, Dict[str, int]]:
        """The collectives of one train step over the dp group, by the JAX
        package's op names, each with its count and its result bytes (the
        profiler's cost report): stage 0's all-reduce of each bucket of
        gradients; under ZeRO, each flat group's all-reduce (stage 1) or
        reduce-scatter (stages 2-3) of its gradients, the clip's all-reduce
        of two floats, and the all-gather of the parameters (after the
        update, or at stage 3 before the next forward). None for a group of
        one rank, whose collectives are skipped; an ep group's clip term is
        not counted."""
        out: Dict[str, Dict[str, int]] = {}
        if self._solo:
            return out

        def add(op: str, nbytes: int) -> None:
            d = out.setdefault(op, {"count": 0, "bytes": 0})
            d["count"] += 1
            d["bytes"] += int(nbytes)

        for u, unit in enumerate(updates):
            if not self.zero_stage:
                for bucket in self._buckets(
                        [t for t in unit.leaves if t.requires_grad]):
                    add("all-reduce", sum(t.numel() * t.element_size()
                                          for t in bucket))
                continue
            for fg in self._groups.get(u, ()):
                size = fg.dtype.itemsize
                if self.zero_stage == 1:
                    add("all-reduce", fg.size * size)
                else:
                    add("reduce-scatter", fg.shard_size * size)
                add("all-gather", fg.size * size)
            if clip:
                add("all-reduce", 8)
        return out

    @torch.no_grad()
    def all_reduce_mean_(self, grads: List[torch.Tensor]) -> None:
        """Stage 0: each gradient becomes its mean over the ranks, bucketed
        by dtype and device over the flat list."""
        for bucket in self._buckets(grads):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            self._all_reduce_(flat)
            flat.div_(self.world)
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))

    @torch.no_grad()
    def clip_(self, leaves: List[torch.Tensor], max_norm: float) -> None:
        """Stage 0: ``optax.clip_by_global_norm`` over the whole model's
        gradients, as the Trainer's ``_clip_by_global_norm`` on one device
        (the norm of the leaves' norms): the expert slices' squares are
        summed over the ep group, the replicated leaves counted once.
        Without expert leaves that term is zero."""
        held = [t for t in leaves if t.grad is not None]
        if not held:
            return
        norms = torch.stack([torch.linalg.vector_norm(t.grad.float())
                             for t in held])
        expert = torch.tensor([self.is_expert(t) for t in held],
                              device=norms.device)
        sq = norms[expert].square().sum().reshape(1)
        if self.ep_group is not None:
            self._all_reduce_(sq, over_ep=True)
        norm = torch.linalg.vector_norm(torch.cat([norms[~expert], sq.sqrt()]))
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        for t in held:
            t.grad.mul_(scale.to(t.grad.dtype))

    @torch.no_grad()
    def sharded_update(self, unit_index: int, unit, accumulate: int,
                       clip: Optional[float]) -> None:
        """Stages 1-3: reduce the flat gradients to this rank's shards, take
        their mean over the micro-batches, clip by the global norm (summed
        over every rank's shards), step the unit's optimizers and
        schedulers on the shards, then all-gather (stages 1-2) or release
        (stage 3) the flat buffers."""
        groups = self._groups[unit_index]
        lo = self.rank
        for fg in groups:
            flat = fg.flat_grad()
            if self.zero_stage == 1:
                self._all_reduce_(flat)
                shard = flat[lo * fg.shard_size:(lo + 1) * fg.shard_size].clone()
            else:
                shard = torch.empty(fg.shard_size, dtype=fg.dtype,
                                    device=fg.device)
                self._reduce_scatter(shard, flat)
            del flat
            shard.div_(self.world * accumulate)
            fg.shard.grad = shard
        for leaf in unit.leaves:
            leaf.grad = None
        if clip:
            # [replicated leaves, expert slices]: the second summed over ep
            sq = torch.zeros(2, dtype=torch.float32, device=groups[0].device
                             if groups else self.comm_device)
            for fg in groups:
                sq[int(fg.expert)] += fg.shard.grad.float().square().sum()
            self._all_reduce_(sq)
            if self.ep_group is not None:
                self._all_reduce_(sq[1:], over_ep=True)
            norm = sq.sum().sqrt()
            scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
            for fg in groups:
                fg.shard.grad.mul_(scale.to(fg.dtype))
        for opt in unit.optimizers:
            opt.step()
        for sched in unit.schedulers:
            sched.step()
        for fg in groups:
            fg.shard.grad = None
            if self.zero_stage == 3:
                fg.release()
            else:
                self._all_gather(fg.full, fg.shard.detach())

    # ------------------------------------------------------------------ #
    # stage 3: whole parameters when something reads them
    # ------------------------------------------------------------------ #
    @property
    def released(self) -> bool:
        return any(fg.full is None for gs in self._groups.values() for fg in gs)

    @torch.no_grad()
    def ensure_full(self) -> None:
        """All-gather every released flat buffer (a collective: every rank
        calls it at the same points)."""
        for groups in self._groups.values():
            for fg in groups:
                if fg.full is None:
                    full = torch.empty(fg.size, dtype=fg.dtype, device=fg.device)
                    self._all_gather(full, fg.shard.detach())
                    fg.bind(full)

    # ------------------------------------------------------------------ #
    # metrics
    # ------------------------------------------------------------------ #
    def reduce_metrics(self, metrics: Dict[str, np.ndarray],
                       kinds: Dict[str, str]) -> Dict[str, np.ndarray]:
        """Scalar epoch metrics over the ranks of the group: the mean of
        "mean" metrics (the ranks' batches are equal in number and size),
        the sum of "sum" metrics, the max and min of "max" and "min" ones.
        One collective per kind, names in sorted order on every rank. Under
        a mesh the group is dp: the members of an ep group computed the same
        values."""
        if self.world == 1 or not metrics:
            return metrics
        out = dict(metrics)
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}
        for kind in ("mean", "sum", "max", "min"):
            names = sorted(n for n in metrics if kinds.get(n, "mean") == kind
                           or (kind == "mean" and kinds.get(n) not in ops))
            names = [n for n in names if np.asarray(metrics[n]).size == 1]
            if not names:
                continue
            vals = torch.tensor([float(np.asarray(metrics[n])) for n in names],
                                dtype=torch.float64, device=self.comm_device)
            self._all_reduce_(vals, ops.get(kind, dist.ReduceOp.SUM))
            if kind == "mean":
                vals /= self.world
            for n, v in zip(names, vals.cpu().numpy()):
                out[n] = np.asarray(v)
        return out


def _per_element(key: str, value: Any, shape: torch.Size) -> bool:
    """Whether an optimizer state holds one value an element of a parameter
    of ``shape`` (AdamW's moments), not one a parameter (its step)."""
    return (torch.is_tensor(value) and key != "step"
            and value.shape == shape)


def _specs_by_leaf(params, specs) -> List[Any]:
    """The spec (an axis tuple, or None) of every leaf of ``params``, in
    ``tree_leaves`` order, matched by key path: the two trees need not list
    their keys in one order."""
    out: List[Any] = []

    def walk(node, spec):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, spec.get(k) if isinstance(spec, dict) else None)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, spec[i] if isinstance(spec, list) else None)
        else:
            out.append(spec if isinstance(spec, tuple) else None)

    walk(params, specs)
    return out
