"""Named parallelism axes over the ranks of a Ray strategy
(``ray_lightning_tpu/parallel/mesh.py``).

The JAX package lays a ``MeshSpec`` over devices (``build_mesh``) and XLA
places the collectives. Here one process drives one device, so the mesh is
laid over the strategy's ranks instead: :class:`ProcessMesh` gives each axis
its size, this rank its coordinates, and each axis a ``torch.distributed``
subgroup in which the collectives of that axis run.

The port takes the axes ``dp`` (data parallel: each dp coordinate trains on
its own shard of the data, gradients are averaged over dp) and ``ep``
(expert parallel: the members of an ep group see the same batch and each
holds E / ep of every MoE layer's experts, ``parallel/moe.py::
moe_ffn_local_experts``). ZeRO stays ``ShardingPolicy.zero_stage`` over dp.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# the axes the port lays over ranks; the JAX package's others refuse
PORTED_AXES = ("dp", "ep")
_UNPORTED_AXES = {
    "fsdp": "fully sharded data parallelism as a mesh axis (ZeRO is "
            "ShardingPolicy.zero_stage over 'dp')",
    "tp": "tensor parallelism",
    "pp": "pipeline parallelism",
    "sp": "sequence parallelism (ring attention)",
}


@dataclass
class MeshSpec:
    """Named parallelism axes and their sizes (the JAX ``MeshSpec``).

    Axis names follow the scaling-book convention:
      - ``dp``: pure data parallel (batch)
      - ``fsdp``: data parallel with parameter/optimizer sharding (ZeRO)
      - ``tp``: tensor parallel
      - ``sp``: sequence/context parallel (ring attention)
      - ``ep``: expert parallel (MoE)
      - ``pp``: pipeline stages
    A size of -1 means "absorb all remaining ranks". The port lays ``dp``
    and ``ep`` over ranks (:class:`ProcessMesh`); ``dcn_axes`` (axes laid
    across TPU slices) has no counterpart and refuses.
    """

    axes: Dict[str, int] = field(default_factory=dict)
    dcn_axes: Tuple[str, ...] = ()

    def resolved(self, n_devices: int) -> Dict[str, int]:
        """The axes with -1 filled in, size-1 axes other than ``dp``
        dropped; raises ``ValueError`` as the JAX ``resolved`` does."""
        axes = {k: v for k, v in self.axes.items() if v != 1 or k in ("dp",)}
        if not axes:
            axes = {"dp": -1}
        fill_keys = [k for k, v in axes.items() if v == -1]
        if len(fill_keys) > 1:
            raise ValueError("at most one axis may be -1")
        fixed = int(np.prod([v for v in axes.values() if v != -1]))
        if fill_keys:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {axes}"
                )
            axes[fill_keys[0]] = n_devices // fixed
        else:
            total = int(np.prod(list(axes.values())))
            if total != n_devices:
                raise ValueError(
                    f"mesh axes {axes} use {total} devices, have {n_devices}"
                )
        return axes

    @staticmethod
    def data_parallel() -> "MeshSpec":
        return MeshSpec(axes={"dp": -1})

    @staticmethod
    def fsdp() -> "MeshSpec":
        return MeshSpec(axes={"fsdp": -1})

    @staticmethod
    def pipeline(pp: int) -> "MeshSpec":
        """GPipe stages over 'pp'; remaining devices become data parallel."""
        return MeshSpec(axes={"pp": pp, "dp": -1})

    @staticmethod
    def composed(dp: int = -1, tp: int = 1, pp: int = 1) -> "MeshSpec":
        """3D composed-parallelism mesh: pipeline stages outermost, data
        parallel next, tensor parallel innermost; ``dp=-1`` absorbs the
        remaining devices, and ``resolved()`` keeps a size-1 ``dp``."""
        axes: Dict[str, int] = {}
        if pp != 1:
            axes["pp"] = pp
        axes["dp"] = dp
        if tp != 1:
            axes["tp"] = tp
        return MeshSpec(axes=axes)


def refuse_unported_axes(axes: Dict[str, int]) -> None:
    """``NotImplementedError`` naming ROADMAP.md for an axis of size above
    1 that the port does not lay over ranks."""
    for name, size in axes.items():
        if size == 1 or name in PORTED_AXES:
            continue
        what = _UNPORTED_AXES.get(name, f"the mesh axis {name!r}")
        raise NotImplementedError(
            f"mesh axis {name!r}={size}: {what} is not ported yet (ROADMAP.md, "
            "queue 1 item 9: the parallelism layer); the port lays 'dp' and "
            "'ep' over the strategy's ranks")


class ProcessMesh:
    """A ``MeshSpec`` laid over ``world_size`` ranks, row-major in the
    spec's axis order as the JAX mesh lays out devices: for ``{"dp": 2,
    "ep": 4}`` ranks 0-3 are dp-row 0's ep group and rank r has dp
    coordinate r // 4 and ep coordinate r % 4.

    ``axes`` holds the resolved sizes (``dp`` and ``ep`` always, 1 where
    the spec has none); ``coords`` this rank's coordinates. :meth:`join`
    creates one ``torch.distributed`` subgroup per axis (every rank creates
    every group, in one order, as torch requires) once the default process
    group exists; until then the mesh is a layout only (the main process's
    strategy reads its sizes)."""

    def __init__(self, spec: MeshSpec, world_size: int, rank: int):
        if spec.dcn_axes:
            raise NotImplementedError(
                f"dcn_axes={spec.dcn_axes}: axes laid across TPU slices have "
                "no counterpart in the port, whose ranks are processes "
                "(ROADMAP.md)")
        resolved = spec.resolved(world_size)
        refuse_unported_axes(resolved)
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a world of {world_size}")
        self.spec = spec
        self.world_size = int(world_size)
        self.rank = int(rank)
        # the spec's order (the layout's), every ported axis present
        self.order = [n for n in resolved if n in PORTED_AXES]
        self.axes = {n: resolved.get(n, 1) for n in PORTED_AXES}
        self.coords: Dict[str, int] = {n: 0 for n in PORTED_AXES}
        rest = self.rank
        for name in reversed(self.order):
            self.coords[name] = rest % self.axes[name]
            rest //= self.axes[name]
        self._groups: Optional[Dict[str, object]] = None

    def size(self, axis: str) -> int:
        return self.axes.get(axis, 1)

    def ranks_of(self, axis: str, rank: Optional[int] = None) -> List[int]:
        """The global ranks of ``rank``'s group along ``axis`` (this rank's
        by default), in coordinate order."""
        rank = self.rank if rank is None else rank
        if self.size(axis) == 1:
            return [rank]
        sizes = [self.axes[n] for n in self.order]
        coords = list(np.unravel_index(rank, sizes))
        i = self.order.index(axis)
        out = []
        for c in range(sizes[i]):
            coords[i] = c
            out.append(int(np.ravel_multi_index(coords, sizes)))
        return out

    def join(self) -> "ProcessMesh":
        """Create every axis's subgroups (a collective call on every rank:
        each rank creates all of them, in axis order, then group order), and
        keep the ones this rank belongs to. Idempotent."""
        if self._groups is not None:
            return self
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessMesh.join: no torch.distributed process group; the "
                "strategy's workers join one before the stage starts")
        if dist.get_world_size() != self.world_size:
            raise RuntimeError(
                f"ProcessMesh over {self.world_size} ranks in a process group "
                f"of {dist.get_world_size()}")
        groups = {}
        for axis in PORTED_AXES:
            seen = set()
            for r in range(self.world_size):
                members = tuple(self.ranks_of(axis, r))
                if members in seen:
                    continue
                seen.add(members)
                group = dist.new_group(list(members))
                if self.rank in members:
                    groups[axis] = group
        self._groups = groups
        return self

    def group(self, axis: str):
        """This rank's subgroup along ``axis`` (after :meth:`join`)."""
        if self._groups is None:
            raise RuntimeError("ProcessMesh.group before join()")
        return self._groups[axis]

    def __getstate__(self):
        # process groups live in one process: a shipped mesh is a layout
        state = dict(self.__dict__)
        state["_groups"] = None
        return state

    def __repr__(self) -> str:
        return (f"ProcessMesh(axes={self.axes}, rank={self.rank}, "
                f"coords={self.coords})")
