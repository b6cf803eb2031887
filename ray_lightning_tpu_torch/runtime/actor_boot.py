"""Actor process entry point: ``python -m
ray_lightning_tpu_torch.runtime.actor_boot``
(``ray_lightning_tpu/runtime/actor_boot.py``).

Spawned as a fresh interpreter (``subprocess``, never ``fork``), so the
main process's ``__main__`` is not imported again and no CUDA context of the
main process's reaches the actor: a worker opens its own on its own card.

Bootstrap on stdin, each message length-prefixed: the authkey; a JSON
context (the main process's ``sys.path`` and working directory, the interface to
bind); the pickled class; the pickled ``(args, kwargs)``. Handshake on
stdout: ``TORCHRT_ACTOR_READY <port>``, or ``TORCHRT_ACTOR_ERROR`` and a
traceback. A fault scripted ``@boot`` for this actor's rank
(``runtime/faults.py``) fires before the ready line, so the spawner sees a
start-up failure that it may retry.

The creator keeps the write end of stdin open for the actor's life, so the
actor sees end-of-file on it only when the creator has gone, whatever way
it went (a graceful exit, SIGTERM, SIGKILL). A daemon thread waits for that
and exits the process: an actor never outlives the process that created
it, and a trial process that is stopped takes its workers, and their CUDA
contexts, with it.
"""
from __future__ import annotations

import json
import os
import pickle
import struct
import sys
import threading
import traceback

_LEN = struct.Struct("!Q")


def _read_exact(stream, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            raise EOFError("bootstrap stream closed")
        buf.extend(chunk)
    return bytes(buf)


def _read_msg(stream) -> bytes:
    (n,) = _LEN.unpack(_read_exact(stream, _LEN.size))
    return _read_exact(stream, n)


def _exit_with_creator(stdin) -> None:
    """Exit this process once ``stdin`` reaches end-of-file."""

    def watch():
        try:
            stdin.read()
        except (OSError, ValueError):
            pass
        os._exit(1)

    threading.Thread(target=watch, daemon=True,
                     name="torchrt-creator-watch").start()


def main() -> None:
    from ray_lightning_tpu_torch.runtime import faults
    from ray_lightning_tpu_torch.runtime.actor import serve_instance

    stdin = sys.stdin.buffer
    try:
        authkey = _read_msg(stdin)
        ctx = json.loads(_read_msg(stdin))
        if ctx.get("cwd") and os.path.isdir(ctx["cwd"]):
            os.chdir(ctx["cwd"])
        # classes pickled by reference resolve as in the main process
        for p in reversed(ctx.get("sys_path", [])):
            if p not in sys.path:
                sys.path.insert(0, p)
        cls_blob = _read_msg(stdin)
        args_blob = _read_msg(stdin)
        _exit_with_creator(stdin)
        cls = pickle.loads(cls_blob)
        args, kwargs = pickle.loads(args_blob)
        instance = cls(*args, **kwargs)
    except BaseException:
        sys.stdout.write("TORCHRT_ACTOR_ERROR\n" + traceback.format_exc())
        sys.stdout.flush()
        sys.exit(1)
    faults.fire_boot_faults()
    serve_instance(instance, authkey, ready_stream=sys.stdout,
                   bind_host=ctx.get("bind_host") or "127.0.0.1")


if __name__ == "__main__":
    main()
