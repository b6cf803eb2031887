"""Shared-memory object store (``ray_lightning_tpu/runtime/object_store.py``):
the role of Ray's plasma store, ``ray.put(model)`` shipping the trainer once
per host instead of once per worker.

Two backends behind one API, chosen as the JAX store chooses:

- **native** (preferred): the port's ``librlt_shm`` (``runtime/native/``),
  POSIX shm segments with an atomic cross-process refcount in the header. A
  segment outlives its creator and is unlinked by whichever process drops
  the last reference, so a consumer frees a segment it was handed (a queue's
  spilled payload) without a round trip to the producer.
- **python**: ``multiprocessing.shared_memory``, when the library cannot be
  built; the owner creates and unlinks, any process of the host reads.

Segment names start with ``torchrt_``. ``bytes`` are stored as they are (a
``torch.save`` stream costs no second pickle): the ref's backend says so
with a ``-bytes`` suffix."""
from __future__ import annotations

import ctypes
import os
import pickle
import secrets
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Any, Dict, List

from ray_lightning_tpu_torch.runtime import native
from ray_lightning_tpu_torch.runtime.actor import dumps

PREFIX = "torchrt"


@dataclass(frozen=True)
class ObjectRef:
    """Handle of an object in the store; picklable, resolvable by any
    process of the host with :func:`get_object`."""

    name: str
    size: int
    backend: str = "python"

    @property
    def kind(self) -> str:
        """The backend without the ``-bytes`` suffix."""
        return self.backend.split("-")[0]


def _pointer(payload: bytes):
    """The bytes' own buffer as the C library's ``const uint8_t *`` (no
    copy: a trainer's payload may be GBs)."""
    return ctypes.cast(ctypes.c_char_p(payload), ctypes.POINTER(ctypes.c_uint8))


def _untrack(shm: shared_memory.SharedMemory) -> None:
    """A reader must not hand the segment to its own resource tracker: the
    owner unlinks it (``SharedMemory(track=False)`` is Python 3.13+)."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


class ObjectStore:
    """Owner-side store: the segments this process created, native when the
    library loads, else Python ones."""

    def __init__(self, prefix: str = PREFIX):
        self._prefix = prefix
        self._lib = native.get_lib()
        self._owned_py: Dict[str, shared_memory.SharedMemory] = {}
        self._owned_native: List[str] = []

    def _new_name(self) -> str:
        return f"{self._prefix}_{os.getpid()}_{secrets.token_hex(8)}"

    def put(self, obj: Any) -> ObjectRef:
        """Store ``obj`` (pickled by reference; ``bytes`` as they are)."""
        raw = isinstance(obj, bytes)
        payload = obj if raw else dumps(obj, "an object")
        suffix = "-bytes" if raw else ""
        name = self._new_name()
        if self._lib is not None:
            rc = self._lib.rlt_store_create(("/" + name).encode(),
                                            _pointer(payload), len(payload))
            if rc != 0:
                raise OSError(-rc, f"rlt_store_create({name}) failed: "
                              f"{os.strerror(-rc)}")
            self._owned_native.append(name)
            return ObjectRef(name, len(payload), "native" + suffix)
        shm = shared_memory.SharedMemory(name=name, create=True,
                                         size=max(1, len(payload)))
        shm.buf[:len(payload)] = payload
        self._owned_py[name] = shm
        return ObjectRef(name, len(payload), "python" + suffix)

    def delete(self, ref: ObjectRef) -> None:
        """Drop the creator's reference. A native segment may be released
        from any process (it is unlinked when its last reader detaches); a
        Python one only by the process that created it (a no-op
        elsewhere)."""
        if ref.kind == "native":
            if ref.name in self._owned_native:
                self._owned_native.remove(ref.name)
            release(ref)
            return
        shm = self._owned_py.pop(ref.name, None)
        if shm is None:
            return
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass

    def shutdown(self) -> None:
        for name in list(self._owned_py):
            self.delete(ObjectRef(name, 0, "python"))
        for name in list(self._owned_native):
            self.delete(ObjectRef(name, 0, "native"))


def put_detached(payload: bytes) -> ObjectRef:
    """A native segment whose creator reference belongs to whoever is handed
    the ref, not to this process's store: a queue's spilled payload, which
    must survive its producer and which the reader frees with
    :func:`release`."""
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("put_detached needs librlt_shm, which could not be "
                           "built or loaded here")
    name = f"{PREFIX}_{os.getpid()}_{secrets.token_hex(8)}"
    rc = lib.rlt_store_create(("/" + name).encode(), _pointer(payload),
                              len(payload))
    if rc != 0:
        raise OSError(-rc, f"rlt_store_create({name}) failed: "
                      f"{os.strerror(-rc)}")
    return ObjectRef(name, len(payload), "native-bytes")


def release(ref: ObjectRef) -> int:
    """Drop the creator reference of a native segment from any process;
    returns the references left (the segment is unlinked at 0), or a
    negative errno when it is gone."""
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("release needs librlt_shm")
    return int(lib.rlt_store_release(("/" + ref.name).encode()))


def _read_native(ref: ObjectRef) -> bytes:
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError(f"object {ref.name} was stored by the native "
                           "backend, but librlt_shm is unavailable in this "
                           "process")
    size, base, length = ctypes.c_uint64(), ctypes.c_void_p(), ctypes.c_uint64()
    payload = lib.rlt_store_map(("/" + ref.name).encode(), ctypes.byref(size),
                                ctypes.byref(base), ctypes.byref(length))
    if not payload:
        raise FileNotFoundError(f"shm object {ref.name} not found")
    try:
        return ctypes.string_at(payload, size.value)
    finally:
        lib.rlt_store_unmap(("/" + ref.name).encode(), base, length)


def get_object(ref: ObjectRef) -> Any:
    """Attach the segment and read the object back."""
    if ref.kind == "native":
        data = _read_native(ref)
    elif ref.kind == "python":
        shm = shared_memory.SharedMemory(name=ref.name)
        _untrack(shm)
        try:
            data = bytes(shm.buf[:ref.size])
        finally:
            shm.close()
    else:
        raise ValueError(f"object {ref.name}: unknown backend {ref.backend!r}")
    return data if ref.backend.endswith("-bytes") else pickle.loads(data)
