"""Process actors with socket-addressable handles
(``ray_lightning_tpu/runtime/actor.py``).

- Each actor is a process running a serve loop on a TCP socket (loopback,
  or the node's interface for actors a node agent spawned).
- An :class:`ActorHandle` holds (address, authkey) and pickles; each process
  opens its own connection lazily. Calls run **serially**, in arrival
  order, on one executor thread (Ray's single-threaded actor semantics);
  replies go back on the connection that asked.
- ``call`` returns a :class:`CallFuture`; ``runtime.get`` and
  ``runtime.wait`` resolve them.

Messages are stdlib ``pickle``: classes and functions travel by reference
(the worker imports them from the main process's ``sys.path``), so a lambda or a
class defined inside a function cannot be sent. Such a call raises
``TypeError`` on the caller's side, before anything is sent. A fault
scripted ``@boot`` fires in ``actor_boot.py`` before ``serve_instance``
announces the actor (the JAX package fires it in ``serve_instance``); the
JAX package's call telemetry is not ported (ROADMAP.md).
"""
from __future__ import annotations

import itertools
import os
import pickle
import queue as queue_mod
import secrets
import socket
import struct
import threading
import time
import traceback
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Any, Dict, Optional, Tuple

from ray_lightning_tpu_torch import observability as _obs

_LEN = struct.Struct("!Q")
_SHUTDOWN = "__torchrt_shutdown__"


def dumps(obj: Any, what: str = "a message") -> bytes:
    """``pickle.dumps`` with the reason spelled out when an object cannot be
    sent by reference."""
    try:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"cannot send {what} to a worker process: {e}. The port pickles "
            "with the standard library, by reference: functions and classes "
            "must be importable at module level in the main process's sys.path "
            "(no lambdas, no classes or functions defined inside another "
            "function)"
        ) from e


def _send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)))
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("socket closed")
        got += k
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return _recv_exact(sock, n)


class ActorError(RuntimeError):
    """The actor method raised (the remote traceback is in the message), or
    the actor's process is gone: ``is_process_failure`` tells the two
    apart."""

    def __init__(self, message: str, is_process_failure: bool = False):
        super().__init__(message)
        self.is_process_failure = is_process_failure


class ActorTimeout(ActorError, TimeoutError):
    """A bounded wait on a :class:`CallFuture` expired; the call may still
    finish and ``result`` may be called again."""

    def __init__(self, message: str):
        super().__init__(message, is_process_failure=False)


# --------------------------------------------------------------------- #
# server side (inside the actor's process)
# --------------------------------------------------------------------- #
def serve_instance(instance, authkey: bytes, ready_stream,
                   bind_host: str = "127.0.0.1", port: int = 0) -> None:
    """Serve a constructed actor: bind, announce ``TORCHRT_ACTOR_READY
    <port>`` on ``ready_stream``, then serve calls until a shutdown call,
    and exit the process."""
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind((bind_host, port))
    server.listen(64)
    address = server.getsockname()
    self_host = "127.0.0.1" if bind_host in ("0.0.0.0", "::") else bind_host
    ready_stream.write(f"TORCHRT_ACTOR_READY {address[1]}\n")
    ready_stream.flush()

    work: "queue_mod.Queue[Optional[tuple]]" = queue_mod.Queue()
    stop = threading.Event()

    def executor():
        while not stop.is_set():
            item = work.get()
            if item is None:
                return
            sock, send_lock, call_id, method, args, kwargs = item
            if method == _SHUTDOWN:
                payload = pickle.dumps((call_id, "ok", None))
                stop.set()
            else:
                try:
                    result = getattr(instance, method)(*args, **kwargs)
                    payload = dumps((call_id, "ok", result),
                                    f"the result of {method}")
                except BaseException:
                    payload = pickle.dumps(
                        (call_id, "error", traceback.format_exc()))
            try:
                with send_lock:
                    _send_msg(sock, payload)
            except OSError:
                pass
            if stop.is_set():
                try:  # unblock the accept loop
                    socket.create_connection((self_host, address[1]),
                                             timeout=1).close()
                except OSError:
                    pass
                return

    threading.Thread(target=executor, daemon=True,
                     name="torchrt-actor-exec").start()

    def client_thread(sock: socket.socket):
        send_lock = threading.Lock()
        try:
            if _recv_msg(sock) != authkey:
                sock.close()
                return
            while not stop.is_set():
                call_id, method, args, kwargs = pickle.loads(_recv_msg(sock))
                work.put((sock, send_lock, call_id, method, args, kwargs))
        except (ConnectionError, OSError, EOFError):
            pass

    while not stop.is_set():
        try:
            sock, _ = server.accept()
        except OSError:
            break
        if stop.is_set():
            break
        threading.Thread(target=client_thread, args=(sock,), daemon=True).start()
    server.close()
    os._exit(0)


# --------------------------------------------------------------------- #
# client side
# --------------------------------------------------------------------- #
class CallFuture:
    """Future of one remote method call."""

    def __init__(self, fut: Future, actor: "ActorHandle", method: str):
        self._fut = fut
        self.actor = actor
        self.method = method
        # telemetry off costs one enabled() check at dispatch
        self._t0 = time.perf_counter() if _obs.enabled() else None

    def result(self, timeout: Optional[float] = None) -> Any:
        try:
            status, value = self._fut.result(timeout)
            if self._t0 is not None:
                reg = _obs.registry()
                if reg is not None:
                    reg.histogram("rlt_actor_call_seconds",
                                  method=self.method).observe(
                        time.perf_counter() - self._t0)
                self._t0 = None  # a polled result() counts the call once
        except (_FuturesTimeout, TimeoutError):
            raise ActorTimeout(
                f"{self.actor.name}.{self.method}: no reply within {timeout}s "
                "(the call may still be running)"
            ) from None
        if status == "connection_lost":
            raise ActorError(
                f"{self.actor.name}.{self.method}: worker process failed: "
                f"{value}", is_process_failure=True)
        if status == "error":
            raise ActorError(
                f"{self.actor.name}.{self.method} raised remotely:\n{value}")
        return value

    def done(self) -> bool:
        return self._fut.done()


class _Connection:
    """One process's connection to one actor: a sender and a reader thread
    that settles the futures."""

    def __init__(self, address: Tuple[str, int], authkey: bytes,
                 timeout: float = 30.0):
        self.sock = socket.create_connection(address, timeout=timeout)
        self.sock.settimeout(None)
        _send_msg(self.sock, authkey)
        self._pending: Dict[int, Future] = {}
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        threading.Thread(target=self._read_loop, daemon=True,
                         name="torchrt-conn-reader").start()

    def _read_loop(self):
        try:
            while True:
                call_id, status, value = pickle.loads(_recv_msg(self.sock))
                with self._lock:
                    fut = self._pending.pop(call_id, None)
                if fut is not None:
                    fut.set_result((status, value))
        except (ConnectionError, OSError, EOFError) as e:
            with self._lock:
                pending = list(self._pending.values())
                self._pending.clear()
            for fut in pending:
                if not fut.done():
                    fut.set_result(("connection_lost", repr(e)))

    def call(self, method: str, args, kwargs) -> Future:
        fut: Future = Future()
        with self._lock:
            call_id = next(self._ids)
            self._pending[call_id] = fut
        try:
            payload = dumps((call_id, method, args, kwargs), f"a call of {method}")
        except TypeError:
            with self._lock:
                self._pending.pop(call_id, None)
            raise
        try:
            with self._send_lock:
                _send_msg(self.sock, payload)
        except OSError as e:
            with self._lock:
                self._pending.pop(call_id, None)
            if not fut.done():
                fut.set_result(("connection_lost", repr(e)))
        return fut

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class ActorHandle:
    """Picklable handle; a connection is opened lazily in each process.
    Any public attribute is a remote method: ``handle.method.remote(...)``
    (or ``handle.call("method", ...)``) returns a :class:`CallFuture`."""

    def __init__(self, name: str, address: Tuple[str, int], authkey: bytes,
                 pid: int = 0):
        self._name = name
        self._address = tuple(address)
        self._authkey = authkey
        self._pid = pid

    @property
    def name(self) -> str:
        return self._name

    def __getstate__(self):
        return {"_name": self._name, "_address": self._address,
                "_authkey": self._authkey, "_pid": self._pid}

    def __setstate__(self, state):
        self.__dict__.update(state)

    def _conn(self) -> _Connection:
        conn = self.__dict__.get("_connection")
        if conn is None:
            conn = _Connection(self._address, self._authkey)
            self.__dict__["_connection"] = conn
        return conn

    def call(self, method: str, *args, **kwargs) -> CallFuture:
        return CallFuture(self._conn().call(method, args, kwargs), self, method)

    def __getattr__(self, item):
        if item.startswith("_") or item in ("name", "call", "shutdown"):
            raise AttributeError(item)
        handle = self

        class _Method:
            def remote(self, *args, **kwargs):
                return handle.call(item, *args, **kwargs)

            __call__ = remote

        return _Method()

    def shutdown(self, timeout: float = 5.0) -> bool:
        """Ask the actor to exit (best effort) and close this connection.
        Returns whether the actor acknowledged within ``timeout`` (a busy
        actor serves the request only after its running call)."""
        try:
            self.call(_SHUTDOWN).result(timeout=timeout)
            acked = True
        except Exception:
            acked = False
        conn = self.__dict__.pop("_connection", None)
        if conn is not None:
            conn.close()
        return acked


def make_authkey() -> bytes:
    return secrets.token_bytes(16)
