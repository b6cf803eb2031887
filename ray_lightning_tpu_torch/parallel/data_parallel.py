"""The data-parallel engine of the Ray strategies: the collectives that the
JAX package leaves to XLA, written out over ``torch.distributed``'s default
process group, one rank per process.

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

With the gloo backend (CPU ranks, or ranks sharing one card) collectives
run on host copies of the buffers; with NCCL on the card itself.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# torch 2.13 renamed the flat-tensor collectives; older releases have only
# the *_tensor names
_ALL_GATHER = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_REDUCE_SCATTER = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)

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

    def __init__(self, leaves: List[torch.nn.Parameter], world: int, rank: int):
        dtypes = {t.dtype for t in leaves}
        devices = {t.device for t in leaves}
        if len(dtypes) != 1 or len(devices) != 1:
            raise NotImplementedError(
                f"ZeRO needs each optimizer parameter group in one dtype on "
                f"one device, got {sorted(map(str, dtypes))} on "
                f"{sorted(map(str, devices))}")
        self.leaves = leaves
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
    """The collectives of one rank. ``comm_device`` is where buffers must
    lie for the process group's backend (the CPU for gloo)."""

    def __init__(self, world_size: int, rank: int, zero_stage: int,
                 comm_device: torch.device, bucket_bytes: int = 25 * 2 ** 20):
        self.world = int(world_size)
        self.rank = int(rank)
        self.zero_stage = int(zero_stage)
        self.comm_device = torch.device(comm_device)
        self.bucket_bytes = int(bucket_bytes)
        # _Update index -> its flat groups (ZeRO)
        self._groups: Dict[int, List[_FlatGroup]] = {}

    # ------------------------------------------------------------------ #
    # collectives on the backend's device
    # ------------------------------------------------------------------ #
    def _on_comm(self, t: torch.Tensor) -> torch.Tensor:
        return t if t.device == self.comm_device else t.to(self.comm_device)

    def _all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
        c = self._on_comm(t)
        dist.all_reduce(c, op=op)
        if c is not t:
            t.copy_(c)

    def _reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        c_out, c_in = self._on_comm(out), self._on_comm(inp)
        _REDUCE_SCATTER(c_out, c_in)
        if c_out is not out:
            out.copy_(c_out)

    def _all_gather(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        c_out, c_in = self._on_comm(out), self._on_comm(inp)
        _ALL_GATHER(c_out, c_in)
        if c_out is not out:
            out.copy_(c_out)

    # ------------------------------------------------------------------ #
    # set-up
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def broadcast_(self, leaves: List[torch.Tensor]) -> None:
        """Every rank starts from rank 0's tensors (as DDP's first
        broadcast does)."""
        for t in leaves:
            c = self._on_comm(t.data)
            dist.broadcast(c, src=0)
            if c is not t.data:
                t.data.copy_(c)

    @torch.no_grad()
    def setup(self, updates) -> None:
        """Under ZeRO: the flat groups of every update's optimizers, each
        optimizer group re-pointed at its shard (before its first step, so
        no state exists yet)."""
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
                for group in opt.param_groups:
                    leaves = [p for p in group["params"] if p.requires_grad]
                    if not leaves:
                        continue
                    fg = _FlatGroup(leaves, self.world, self.rank)
                    group["params"] = [fg.shard]
                    groups.append(fg)
            self._groups[u] = groups

    # ------------------------------------------------------------------ #
    # the update
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def all_reduce_mean_(self, grads: List[torch.Tensor]) -> None:
        """Stage 0: each gradient becomes its mean over the ranks, bucketed
        by dtype and device over the flat list."""
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
        for bucket in buckets:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            self._all_reduce_(flat)
            flat.div_(self.world)
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))

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
            sq = torch.zeros((), dtype=torch.float32, device=groups[0].device
                             if groups else self.comm_device)
            for fg in groups:
                sq += fg.shard.grad.float().square().sum()
            self._all_reduce_(sq)
            norm = sq.sqrt()
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
        """Scalar epoch metrics over the ranks: the mean of "mean" metrics
        (the ranks' batches are equal in number and size), the sum of
        "sum" metrics, the max and min of "max" and "min" ones. One
        collective per kind, names in sorted order on every rank."""
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
