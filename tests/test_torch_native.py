"""The port's native runtime core (ray_lightning_tpu_torch/runtime/native/,
runtime/object_store.py, runtime/queue.py) on the CPU: the refcounted
shared-memory store and the MPMC ring, built with g++ from the port's own
source into build/torchrt_native/.

Against the JAX package: tests/test_native.py's four cases on the port
(the store's refcount lifecycle, the ring's FIFO order and its Full, the
spill of a payload larger than a slot, a producer in another process), and
the two libraries on one ring and one segment at the byte level: what one
pushes with ``rlt_queue_push`` the other pops with ``rlt_queue_pop``,
bitwise, and a segment either creates the other maps and releases."""
import ctypes
import os
import queue as queue_mod
import subprocess
import sys

import pytest

from ray_lightning_tpu.runtime import native as jnative
from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.runtime import native, object_store

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _runtime():
    yield
    rt.shutdown()


def test_library_builds_from_the_ports_source_into_build():
    lib = native.get_lib()
    assert lib is not None and native.available()
    assert native.LIB.exists()
    assert native.LIB.parent == native.BUILD_DIR
    assert str(native.BUILD_DIR).startswith(os.path.join(ROOT, "build"))
    assert native.SOURCE.parent.name == "native"
    assert "ray_lightning_tpu_torch" in str(native.SOURCE)
    assert not native._stale()


def test_store_refcount_lifecycle():
    rt.init(num_cpus=2)
    ref = rt.put({"x": list(range(1000))})
    assert ref.backend == "native"
    assert rt.get(ref)["x"][-1] == 999
    raw = rt.put(b"\x00\x01raw")
    assert raw.backend == "native-bytes" and rt.get(raw) == b"\x00\x01raw"
    rt.delete(ref)
    with pytest.raises((FileNotFoundError, RuntimeError)):
        rt.get(ref)
    # a reader's map holds a reference: a release leaves the segment to it
    lib = native.get_lib()
    size, base, length = (ctypes.c_uint64(), ctypes.c_void_p(),
                          ctypes.c_uint64())
    name = ("/" + raw.name).encode()
    assert lib.rlt_store_map(name, ctypes.byref(size), ctypes.byref(base),
                             ctypes.byref(length))
    rt.delete(raw)
    assert lib.rlt_store_unmap(name, base, length) == 0
    with pytest.raises(FileNotFoundError):
        rt.get(raw)


def test_shm_queue_fifo_and_full():
    q = rt.ShmQueue(capacity=4, slot_bytes=128)
    try:
        assert q.kind == "shm"
        q.put(1)
        q.put(2)
        assert q.get_all() == [1, 2]
        for i in range(4):
            q.put(i)
        with pytest.raises(queue_mod.Full, match=q.name):
            q.put(99, timeout=None)
        with pytest.raises(queue_mod.Full, match="gave up"):
            q.put(99, timeout=0.05)
        assert q.qsize() == 4
        assert q.get_all() == [0, 1, 2, 3]
        assert q.empty()
    finally:
        q.shutdown()


def test_shm_queue_spills_large_payloads(monkeypatch):
    from ray_lightning_tpu_torch.runtime import queue as queue_module

    released = []

    def release(ref):
        released.append(ref)
        return object_store.release(ref)

    monkeypatch.setattr(queue_module, "release", release)
    q = rt.ShmQueue(capacity=4, slot_bytes=256)
    try:
        big = {"blob": b"z" * 50_000}
        q.handle().put(big)
        (item,) = q.get_all()
        assert item["blob"] == big["blob"]
        # the reader freed the spilled segment
        (ref,) = released
        assert ref.backend == "native-bytes" and ref.size > 50_000
        assert not os.path.exists(f"/dev/shm/{ref.name}")
    finally:
        q.shutdown()


def test_shm_queue_cross_process():
    """A producer in another interpreter attaches by the handle's name and
    puts; the main process reads in order. make_queue picks the ring."""
    q = rt.make_queue()
    assert q.kind == "shm"
    code = (
        "import pickle, sys\n"
        "h = pickle.loads(bytes.fromhex(sys.argv[1]))\n"
        "for i in range(3):\n"
        "    h.put(('w', i))\n"
    )
    import pickle

    try:
        out = subprocess.run(
            [sys.executable, "-c", code, pickle.dumps(q.handle()).hex()],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert q.get_all() == [("w", 0), ("w", 1), ("w", 2)]
    finally:
        q.shutdown()
    assert not os.path.exists(f"/dev/shm/{q.name}")
    # across hosts the actor queue serves
    actor_q = rt.make_queue(cross_host=True, timeout=60.0)
    try:
        assert actor_q.kind == "actor"
        actor_q.put(5)
        assert actor_q.get_all() == [5]
    finally:
        actor_q.shutdown()


def _push(lib, q, payload: bytes) -> int:
    buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
    return lib.rlt_queue_push(q, buf, len(payload))


def _pop(lib, q, capacity: int) -> bytes:
    out = (ctypes.c_uint8 * capacity)()
    n = lib.rlt_queue_pop(q, out, capacity)
    assert n >= 0, n
    return bytes(out[:n])


def _attach(lib, name: str):
    base, length = ctypes.c_void_p(), ctypes.c_uint64()
    q = lib.rlt_queue_attach(("/" + name).encode(), ctypes.byref(base),
                             ctypes.byref(length))
    assert q
    return ctypes.c_void_p(q), base, length


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ring_and_store_are_byte_compatible_with_the_jax_library(writer):
    """One ring created by ``writer``'s library: bytes pushed by one library
    pop bitwise in the other, in order; a store segment created by one maps
    in the other and is unlinked by the other's release."""
    port, jax = native.get_lib(), jnative.get_lib()
    if jax is None:
        pytest.skip("the JAX package's librlt_shm cannot be built here")
    libs = {"port": port, "jax": jax}
    reader = "jax" if writer == "port" else "port"
    name = f"torchrtq_compat_{os.getpid()}_{writer}"
    assert libs[writer].rlt_queue_create(("/" + name).encode(), 8, 64) == 0
    try:
        qw, bw, lw = _attach(libs[writer], name)
        qr, br, lr = _attach(libs[reader], name)
        payloads = [bytes(range(i, i + 17)) for i in range(5)] + [b"", b"\xff" * 64]
        for p in payloads:
            assert _push(libs[writer], qw, p) == 0
        assert libs[reader].rlt_queue_size(qr) == len(payloads)
        assert [_pop(libs[reader], qr, 64) for _ in payloads] == payloads
        # and back the other way on the same ring
        assert _push(libs[reader], qr, b"back") == 0
        assert _pop(libs[writer], qw, 64) == b"back"
        assert libs[writer].rlt_queue_pop(qw, (ctypes.c_uint8 * 64)(), 64) == -11
        libs[writer].rlt_queue_detach(bw, lw)
        libs[reader].rlt_queue_detach(br, lr)
    finally:
        libs[writer].rlt_queue_unlink(("/" + name).encode())

    seg = f"/torchrt_compat_{os.getpid()}_{writer}".encode()
    data = bytes(range(256)) * 3
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    assert libs[writer].rlt_store_create(seg, buf, len(data)) == 0
    assert libs[reader].rlt_store_size(seg) == len(data)
    size, base, length = ctypes.c_uint64(), ctypes.c_void_p(), ctypes.c_uint64()
    ptr = libs[reader].rlt_store_map(seg, ctypes.byref(size), ctypes.byref(base),
                                     ctypes.byref(length))
    assert ctypes.string_at(ptr, size.value) == data
    assert libs[reader].rlt_store_unmap(seg, base, length) == 1
    assert libs[reader].rlt_store_release(seg) == 0
    assert not os.path.exists("/dev/shm" + seg.decode())


def test_queue_and_store_fall_back_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert not native.available()
    q = rt.make_queue(timeout=60.0)
    try:
        assert q.kind == "actor"
        q.put([1])
        assert q.get_all() == [[1]]
    finally:
        q.shutdown()
    with pytest.raises(RuntimeError, match="librlt_shm"):
        rt.ShmQueue()
    # and the store falls back to multiprocessing.shared_memory
    store = object_store.ObjectStore()
    py = store.put([1, 2])
    assert py.backend == "python" and object_store.get_object(py) == [1, 2]
    store.shutdown()
