"""Preload-fork actor spawner, the "zygote" (``ray_lightning_tpu/runtime/
zygote.py``): pay the interpreter's and torch's import once, then fork one
actor per request in milliseconds.

A fresh actor interpreter (``runtime/actor_boot.py``) imports torch and the
port, seconds per actor; a worker group, a spare that joins an elastic group
and every tune trial pay it again. The zygote is a process that imports
them once and serves ``spawn`` requests from the process that started it
(its client): each forks a child that unpickles the actor's class and
arguments and serves it (``runtime/actor.py::serve_instance``).

What makes fork-after-import sound here:

- the zygote never initializes CUDA: it imports torch and the port and runs
  no op. A process that called ``cuInit`` before a fork leaves every child
  unable to use the card ("Cannot re-initialize CUDA in forked
  subprocess"), so each spawn checks ``torch.cuda.is_initialized()`` first
  and refuses when it is. Children open their own contexts;
- the zygote stays single-threaded at the Python level: one request at a
  time, the child's ready line read synchronously, no thread that could
  hold a lock across the fork (numpy's BLAS pool, started at import, has
  its own fork handlers);
- what third-party code reads at import time cannot change through the
  zygote. ``OMP_NUM_THREADS``, which torch read at import, is applied by the
  child itself (``torch.set_num_threads``); the rest of the actor's
  environment is set before its class is unpickled.

Lifetimes: the zygote serves one client connection and exits when it
closes, so it dies with its client however the client ends; each child asks
the kernel to kill it when the zygote exits (``PR_SET_PDEATHSIG``), so no
child outlives the process that created it, as a fresh interpreter's stdin
watch ensures in the classic boot.

Opt-in, as in the JAX package: ``create_actors(..., zygote=True)`` or
``TORCHRT_ZYGOTE=1`` in the creator's environment. The classic boot stays
the default.
"""
from __future__ import annotations

import os
import pickle
import secrets
import select
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ray_lightning_tpu_torch.runtime.actor import (
    _recv_msg,
    _send_msg,
    dumps,
)

ZYGOTE_ENV = "TORCHRT_ZYGOTE"
_AUTHKEY_ENV = "TORCHRT_ZYGOTE_AUTHKEY"
_T0_ENV = "TORCHRT_ZYGOTE_T0"
_READY = "TORCHRT_ZYGOTE_READY"
_PR_SET_PDEATHSIG = 1
# how long a fresh zygote waits for its client to connect
_ACCEPT_TIMEOUT_S = 120.0


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when its parent (the zygote) exits."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    if os.getppid() != parent:  # the zygote died before the prctl
        os._exit(1)


# --------------------------------------------------------------------- #
# the child, after the fork
# --------------------------------------------------------------------- #
def _child_main(request: Dict[str, Any], ready_fd: int, parent: int) -> None:
    signal.signal(signal.SIGCHLD, signal.SIG_DFL)  # the child waits its own
    _die_with_parent(parent)
    for key, value in request["env"].items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(value)
    if request.get("cwd") and os.path.isdir(request["cwd"]):
        os.chdir(request["cwd"])
    for p in reversed(request.get("sys_path", [])):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    threads = os.environ.get("OMP_NUM_THREADS")
    if threads and threads.isdigit() and int(threads) > 0:
        torch.set_num_threads(int(threads))

    from ray_lightning_tpu_torch.runtime import faults
    from ray_lightning_tpu_torch.runtime.actor import serve_instance

    ready = os.fdopen(ready_fd, "w")
    try:
        cls = pickle.loads(request["cls_blob"])
        args, kwargs = pickle.loads(request["args_blob"])
        instance = cls(*args, **kwargs)
    except BaseException:
        import traceback

        ready.write("TORCHRT_ACTOR_ERROR "
                    + repr(traceback.format_exc()) + "\n")
        ready.flush()
        os._exit(1)
    faults.fire_boot_faults()
    serve_instance(instance, request["authkey"], ready,
                   bind_host=request.get("bind_host") or "127.0.0.1")
    os._exit(0)


# --------------------------------------------------------------------- #
# the zygote
# --------------------------------------------------------------------- #
def _status() -> Dict[str, Any]:
    import torch

    return {"pid": os.getpid(),
            "cuda_initialized": bool(torch.cuda.is_initialized()),
            "python_threads": threading.active_count()}


def _fork_check() -> Optional[str]:
    """Why a fork is unsafe now, or None."""
    import torch

    if torch.cuda.is_initialized():
        return ("the zygote has initialized CUDA; a forked child could not "
                "use the card")
    if threading.active_count() != 1:
        return (f"the zygote runs {threading.active_count()} Python threads; "
                "it must fork from a single thread")
    return None


def _handle_spawn(conn: socket.socket, request: Dict[str, Any],
                  server: socket.socket) -> None:
    unsafe = _fork_check()
    if unsafe is not None:
        _send_msg(conn, pickle.dumps({"ok": False, "pid": 0,
                                      "error": unsafe}))
        return
    parent = os.getpid()
    read_fd, write_fd = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(read_fd)
        for inherited in (conn, server):
            try:
                inherited.close()
            except OSError:
                pass
        try:
            _child_main(request, write_fd, parent)
        finally:
            os._exit(1)
    os.close(write_fd)
    # a bounded wait on the ready line: a wedged constructor must not stall
    # the single-threaded loop
    timeout = float(request.get("timeout", 120.0))
    line = ""
    with os.fdopen(read_fd) as ready:
        r, _, _ = select.select([ready], [], [], timeout)
        if r:
            line = ready.readline().strip()
    if line.startswith("TORCHRT_ACTOR_READY"):
        reply = {"ok": True, "port": int(line.split()[1]), "pid": pid}
    else:
        reply = {"ok": False, "pid": pid,
                 "error": line or f"no ready line within {timeout:.0f}s"}
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    _send_msg(conn, pickle.dumps(reply))


def main() -> int:
    # children are reaped by the kernel: the client kills them by pid
    signal.signal(signal.SIGCHLD, signal.SIG_IGN)
    # the preload: what an actor of the port imports, without any CUDA call
    # (torch._dynamo, which an optimizer's first step imports, is a third
    # of it)
    import torch  # noqa: F401
    import torch._dynamo  # noqa: F401

    import ray_lightning_tpu_torch.core  # noqa: F401
    import ray_lightning_tpu_torch.launchers.ray_launcher  # noqa: F401
    import ray_lightning_tpu_torch.models.llama  # noqa: F401
    import ray_lightning_tpu_torch.runtime.actor_boot  # noqa: F401

    authkey = bytes.fromhex(os.environ.pop(_AUTHKEY_ENV))
    # the boot's seconds, from the client's start of this process
    boot_s = time.time() - float(os.environ.pop(_T0_ENV, time.time()))
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    server.settimeout(1.0)
    sys.stdout.write(f"{_READY} {server.getsockname()[1]} {boot_s:.3f}\n")
    sys.stdout.flush()
    creator, deadline = os.getppid(), time.monotonic() + _ACCEPT_TIMEOUT_S
    conn = None
    while conn is None:
        # a creator that dies before it connects must not leave us behind
        if os.getppid() != creator or time.monotonic() > deadline:
            return 1
        try:
            conn, _ = server.accept()
        except socket.timeout:
            continue
        except OSError:
            return 1
    conn.settimeout(None)
    try:
        if _recv_msg(conn) != authkey:
            return 1
        # one client: its connection closing (however it ended) ends the
        # zygote, and with it every child (PR_SET_PDEATHSIG)
        while True:
            msg = pickle.loads(_recv_msg(conn))
            op = msg.get("op")
            if op == "shutdown":
                return 0
            if op == "status":
                _send_msg(conn, pickle.dumps(_status()))
            else:
                _handle_spawn(conn, msg, server)
    except (ConnectionError, OSError, EOFError):
        return 0
    finally:
        conn.close()
        server.close()


# --------------------------------------------------------------------- #
# the client
# --------------------------------------------------------------------- #
class ZygoteClient:
    """The creator's handle of one zygote. The process starts at
    construction; the first request waits for its banner, so a zygote made
    ahead of need (``api.warm_zygote``) imports while the creator works.

    Spawns are served one at a time (single-threadedness is what makes the
    fork sound), so actors with heavy constructors start in turn; the
    port's actors construct nothing heavy."""

    def __init__(self, env: Dict[str, str], startup_timeout: float = 180.0):
        self._authkey = secrets.token_bytes(16)
        env = dict(env)
        # the environment every child inherits: spawn sends each child's
        # difference from it
        self._zygote_env = dict(env)
        env[_AUTHKEY_ENV] = self._authkey.hex()
        env[_T0_ENV] = repr(time.time())
        self._startup_timeout = startup_timeout
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self.broken = False
        # the zygote's boot (its imports), known at the first request
        self.ready_s: Optional[float] = None
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "ray_lightning_tpu_torch.runtime.zygote"],
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=None,
            env=env)

    @property
    def pid(self) -> int:
        return self._proc.pid

    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        deadline = time.monotonic() + self._startup_timeout
        line = ""
        while time.monotonic() < deadline:
            r, _, _ = select.select([self._proc.stdout], [], [], 1.0)
            if r:
                raw = self._proc.stdout.readline()
                if not raw:
                    break
                line = raw.decode(errors="replace").strip()
                if line.startswith(_READY):
                    break
            if self._proc.poll() is not None:
                break
        if not line.startswith(_READY):
            self.broken = True
            self._proc.kill()
            raise RuntimeError(f"the zygote did not start within "
                               f"{self._startup_timeout:.0f}s (last output: "
                               f"{line!r})")
        _, port, boot_s = line.split()
        port, self.ready_s = int(port), float(boot_s)

        def drain():  # children share the zygote's stdout
            try:
                for out in self._proc.stdout:
                    sys.stderr.write("(zygote) " + out.decode(errors="replace"))
            except ValueError:
                pass

        threading.Thread(target=drain, daemon=True,
                         name="torchrt-zygote-drain").start()
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        sock.settimeout(None)
        _send_msg(sock, self._authkey)
        self._sock = sock
        return sock

    def alive(self) -> bool:
        return not self.broken and self._proc.poll() is None

    def _request(self, msg: Dict[str, Any], timeout: float) -> Dict[str, Any]:
        with self._lock:
            try:
                sock = self._connect()
                sock.settimeout(timeout)
                _send_msg(sock, pickle.dumps(msg))
                reply = pickle.loads(_recv_msg(sock))
                sock.settimeout(None)
                return reply
            except Exception:
                # the protocol may be out of step: the caller starts a new one
                self.broken = True
                raise

    def status(self, timeout: float = 60.0) -> Dict[str, Any]:
        """The zygote's pid, whether it has initialized CUDA and its Python
        threads."""
        return self._request({"op": "status"}, timeout + self._startup_timeout)

    def spawn(self, cls: type, args, kwargs, authkey: bytes,
              child_env: Dict[str, str], timeout: float,
              ctx: Dict[str, Any]) -> Tuple[int, int]:
        """Fork one actor; returns (port, pid). Raises RuntimeError with the
        child's traceback when its construction fails."""
        delta: Dict[str, Optional[str]] = {
            k: v for k, v in child_env.items() if self._zygote_env.get(k) != v}
        delta.update({k: None for k in self._zygote_env if k not in child_env})
        request = {
            "op": "spawn", "authkey": authkey, "env": delta,
            "cwd": ctx.get("cwd"), "sys_path": ctx.get("sys_path", []),
            "timeout": timeout,
            "cls_blob": dumps(cls, f"the actor class {cls!r}"),
            "args_blob": dumps((tuple(args), dict(kwargs or {})),
                               "the actor's arguments"),
        }
        # the zygote bounds the child's start itself and always replies;
        # the socket's deadline covers a zygote that died or wedged
        reply = self._request(request, timeout + 30 + self._startup_timeout)
        if not reply.get("ok"):
            raise RuntimeError(f"zygote spawn failed: {reply.get('error')}")
        return reply["port"], reply["pid"]

    def shutdown(self) -> None:
        """End the zygote; its children die with it."""
        self.broken = True
        if self._sock is None:
            self._proc.kill()
            self._proc.stdout.close()
        else:
            try:
                _send_msg(self._sock, pickle.dumps({"op": "shutdown"}))
            except OSError:
                pass
            self._sock.close()
        try:
            self._proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(timeout=5)


if __name__ == "__main__":
    sys.exit(main())
