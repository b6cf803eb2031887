"""ctypes bindings of the port's native runtime core, ``librlt_shm.so``
(``ray_lightning_tpu/runtime/native/__init__.py``): refcounted POSIX
shared-memory segments for the object store and a lock-free MPMC ring for
the queues (``rlt_shm.cpp`` beside this file, byte-compatible with the JAX
package's).

The library is built from this package's own source with ``g++ -O2
-std=c++17 -fPIC -shared ... -lrt -pthread`` at first use, into
``build/torchrt_native/`` at the root of the checkout (rebuilt when the
source is newer), never at import. Concurrent first users build under an
``flock`` and rename the library into place. Without a compiler
:func:`get_lib` returns None and the callers take their Python paths
(``make_queue`` the actor queue, the object store
``multiprocessing.shared_memory``).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "rlt_shm.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torchrt_native"
LIB = BUILD_DIR / "librlt_shm.so"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rlt_store_create.argtypes = [ctypes.c_char_p, u8p, ctypes.c_uint64]
    lib.rlt_store_create.restype = ctypes.c_int
    lib.rlt_store_size.argtypes = [ctypes.c_char_p]
    lib.rlt_store_size.restype = ctypes.c_int64
    lib.rlt_store_map.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64)]
    lib.rlt_store_map.restype = ctypes.c_void_p
    lib.rlt_store_unmap.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                    ctypes.c_uint64]
    lib.rlt_store_unmap.restype = ctypes.c_int64
    lib.rlt_store_release.argtypes = [ctypes.c_char_p]
    lib.rlt_store_release.restype = ctypes.c_int64
    lib.rlt_queue_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_uint64]
    lib.rlt_queue_create.restype = ctypes.c_int
    lib.rlt_queue_attach.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.rlt_queue_attach.restype = ctypes.c_void_p
    lib.rlt_queue_detach.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rlt_queue_unlink.argtypes = [ctypes.c_char_p]
    lib.rlt_queue_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32]
    lib.rlt_queue_push.restype = ctypes.c_int
    lib.rlt_queue_pop.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32]
    lib.rlt_queue_pop.restype = ctypes.c_int64
    lib.rlt_queue_slot_bytes.argtypes = [ctypes.c_void_p]
    lib.rlt_queue_slot_bytes.restype = ctypes.c_uint64
    lib.rlt_queue_size.argtypes = [ctypes.c_void_p]
    lib.rlt_queue_size.restype = ctypes.c_uint64
    return lib


def _stale() -> bool:
    return (not LIB.exists()
            or LIB.stat().st_mtime < SOURCE.stat().st_mtime)


def build() -> Path:
    """Compile the library if it is missing or older than its source (under
    an flock, so that processes starting together build it once); raises
    with the compiler's output on failure."""
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if _stale():
                tmp = BUILD_DIR / f".librlt_shm.{os.getpid()}.so"
                out = subprocess.run(
                    [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                     str(SOURCE), "-lrt", "-pthread"],
                    capture_output=True, text=True, timeout=120)
                if out.returncode != 0:
                    raise RuntimeError("building librlt_shm.so failed:\n"
                                       + out.stderr)
                os.replace(tmp, LIB)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return LIB


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at the first call; None when it cannot
    be built or loaded here (the failure is remembered)."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            try:
                build()
                _lib = _configure(ctypes.CDLL(str(LIB)))
            except Exception:
                _build_failed = True
    return _lib


def available() -> bool:
    return get_lib() is not None
