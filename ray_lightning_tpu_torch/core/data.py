"""Host-side data pipeline (``ray_lightning_tpu/core/data.py``): datasets,
the batch loader and collation. Batches are numpy until the Trainer moves
them to the device in one copy per array.

The shuffle plan is the JAX package's, ``np.random.default_rng(seed +
epoch).permutation``, so the port and the JAX package see the same batches
in the same order. ``num_workers > 0`` assembles batches on background
threads (``core/prefetch.py``). Over several ranks the Trainer re-wraps a
``DataLoader`` with a ``DistributedSampler`` (rank ``rank`` of
``num_replicas`` takes every ``num_replicas``-th index of one seeded
per-epoch permutation), as the JAX Trainer does.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch


class Dataset:
    """Minimal map-style dataset protocol."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int):
        raise NotImplementedError


class TensorDataset(Dataset):
    def __init__(self, *arrays):
        if not arrays or any(len(a) != len(arrays[0]) for a in arrays):
            raise ValueError("TensorDataset needs arrays of one length")
        self.arrays = [np.asarray(a) for a in arrays]

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, idx):
        items = tuple(a[idx] for a in self.arrays)
        return items[0] if len(items) == 1 else items


class DictDataset(Dataset):
    def __init__(self, **arrays):
        if len({len(v) for v in arrays.values()}) != 1:
            raise ValueError("DictDataset needs arrays of one length")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}

    def __len__(self):
        return len(next(iter(self.arrays.values())))

    def __getitem__(self, idx):
        return {k: v[idx] for k, v in self.arrays.items()}


class DistributedSampler:
    """Deterministic rank-sharded index sampler
    (``ray_lightning_tpu/core/data.py::DistributedSampler``). ``set_epoch``
    reshuffles with ``seed + epoch``, so every replica agrees on the
    permutation, and each takes a strided slice. Without ``drop_last`` the
    permutation is padded by wrapping so every replica sees the same count."""

    def __init__(self, data_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.data_len = data_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.num_samples = data_len // num_replicas
        else:
            self.num_samples = math.ceil(data_len / num_replicas)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.data_len)
        else:
            indices = np.arange(self.data_len)
        total = self.num_samples * self.num_replicas
        if not self.drop_last and total > len(indices):
            indices = np.concatenate([indices, indices[:total - len(indices)]])
        indices = indices[:total]
        return iter(indices[self.rank::self.num_replicas].tolist())


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def default_collate(items: Sequence[Any]):
    """Stack a list of samples into a batch, keeping tuple/dict structure."""
    first = items[0]
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate(list(col)) for col in zip(*items))
    return np.stack([_to_numpy(it) for it in items])


def _to_numpy_tree(batch):
    """Convert any torch tensors in a (possibly nested) batch to numpy."""
    if isinstance(batch, torch.Tensor):
        return batch.detach().cpu().numpy()
    if isinstance(batch, dict):
        return {k: _to_numpy_tree(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_numpy_tree(v) for v in batch)
    return batch


class DataLoader:
    """Map-style batch loader emitting numpy batches. Accepts this package's
    :class:`Dataset` or any object with ``__len__``/``__getitem__``."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None,
                 seed: int = 0, sampler: Optional[DistributedSampler] = None,
                 num_workers: int = 0, prefetch_factor: int = 2):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.seed = seed
        self.sampler = sampler
        self.num_workers = int(num_workers)
        self.prefetch_factor = int(prefetch_factor)
        if self.num_workers < 0:
            raise ValueError(f"num_workers must be >= 0, got {num_workers}")
        if self.prefetch_factor < 1:
            raise ValueError(f"prefetch_factor must be >= 1, got {prefetch_factor}")
        self._epoch = 0

    def with_sampler(self, sampler: DistributedSampler) -> "DataLoader":
        """The same loader over ``sampler``'s indices (the sampler owns the
        shuffle): how the Trainer shards a loader across ranks."""
        return DataLoader(
            self.dataset, batch_size=self.batch_size, shuffle=False,
            drop_last=self.drop_last, collate_fn=self.collate_fn,
            seed=self.seed, sampler=sampler, num_workers=self.num_workers,
            prefetch_factor=self.prefetch_factor,
        )

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    # the split iteration protocol that prefetch.AsyncLoader consumes: the
    # plan (index chunks) is cheap and ordered, the assembly (__getitem__,
    # collate, numpy) is the work that runs in parallel
    def _batch_plan(self):
        if self.sampler is not None:
            indices = list(self.sampler)
        elif self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            indices = rng.permutation(len(self.dataset)).tolist()
        else:
            indices = list(range(len(self.dataset)))
        bs = self.batch_size
        stop = len(indices) - len(indices) % bs if self.drop_last else len(indices)
        for start in range(0, stop, bs):
            yield indices[start:start + bs]

    def _assemble(self, chunk):
        return _to_numpy_tree(self.collate_fn([self.dataset[i] for i in chunk]))

    def __iter__(self):
        if self.num_workers > 0:
            from ray_lightning_tpu_torch.core.prefetch import AsyncLoader

            yield from AsyncLoader(self)
            return
        for chunk in self._batch_plan():
            yield self._assemble(chunk)


class _ForeignLoader:
    """Wraps an arbitrary iterable (e.g. a torch DataLoader) into numpy."""

    def __init__(self, loader):
        self.loader = loader

    def set_epoch(self, epoch: int) -> None:
        sampler = getattr(self.loader, "sampler", None)
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield _to_numpy_tree(batch)


def ensure_loader(loader):
    """Normalise user-supplied loaders to an object with this module's
    iteration API."""
    if loader is None or isinstance(loader, (DataLoader, _ForeignLoader)):
        return loader
    if hasattr(loader, "__iter__"):
        return _ForeignLoader(loader)
    raise TypeError(f"Cannot use {type(loader)!r} as a dataloader")
