"""Shared-memory object store (``ray_lightning_tpu/runtime/object_store.py``):
the role of Ray's plasma store, ``ray.put(model)`` shipping the trainer once
per host instead of once per worker.

The port keeps the JAX package's Python backend,
``multiprocessing.shared_memory``: the owner creates and unlinks a segment,
any process on the host attaches and reads it. Segment names start with
``torchrt_``. The native C++ backend (``runtime/native/``, a refcount in the
segment's header) is not ported: ``ObjectStore(backend="native")`` raises
(ROADMAP.md)."""
from __future__ import annotations

import os
import pickle
import secrets
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Any, Dict

from ray_lightning_tpu_torch.runtime.actor import dumps

PREFIX = "torchrt"


@dataclass(frozen=True)
class ObjectRef:
    """Handle of an object in the store; picklable, resolvable by any
    process of the host with :func:`get_object`."""

    name: str
    size: int
    backend: str = "python"


def _untrack(shm: shared_memory.SharedMemory) -> None:
    """A reader must not hand the segment to its own resource tracker: the
    owner unlinks it (``SharedMemory(track=False)`` is Python 3.13+)."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


class ObjectStore:
    """Owner-side store: the segments this process created."""

    def __init__(self, prefix: str = PREFIX, backend: str = "python"):
        if backend != "python":
            raise NotImplementedError(
                f"object store backend {backend!r}: the native shared-memory "
                "store (runtime/native/) is not ported; see ROADMAP.md. The "
                "port stores through multiprocessing.shared_memory ('python')"
            )
        self._prefix = prefix
        self._owned: Dict[str, shared_memory.SharedMemory] = {}

    def _new_name(self) -> str:
        return f"{self._prefix}_{os.getpid()}_{secrets.token_hex(8)}"

    def put(self, obj: Any) -> ObjectRef:
        """Store ``obj`` (pickled by reference; ``bytes`` are stored as
        they are, so a ``torch.save`` stream costs no second pickle)."""
        payload = obj if isinstance(obj, bytes) else dumps(obj, "an object")
        raw = isinstance(obj, bytes)
        name = self._new_name()
        shm = shared_memory.SharedMemory(name=name, create=True,
                                         size=max(1, len(payload)))
        shm.buf[:len(payload)] = payload
        self._owned[name] = shm
        return ObjectRef(name=name, size=len(payload),
                         backend="python-bytes" if raw else "python")

    def delete(self, ref: ObjectRef) -> None:
        """Unlink a segment this process created (a no-op for others)."""
        shm = self._owned.pop(ref.name, None)
        if shm is None:
            return
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass

    def shutdown(self) -> None:
        for name in list(self._owned):
            self.delete(ObjectRef(name=name, size=0))


def get_object(ref: ObjectRef) -> Any:
    """Attach the segment and read the object back."""
    if ref.backend not in ("python", "python-bytes"):
        raise NotImplementedError(
            f"object {ref.name} was stored by the {ref.backend!r} backend, "
            "which the port does not have (ROADMAP.md)")
    shm = shared_memory.SharedMemory(name=ref.name)
    _untrack(shm)
    try:
        data = bytes(shm.buf[:ref.size])
    finally:
        shm.close()
    return data if ref.backend == "python-bytes" else pickle.loads(data)
