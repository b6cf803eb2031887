"""Runtime API (``ray_lightning_tpu/runtime/api.py``): init and shutdown, the
node registry, actor creation with resource-aware placement, futures and the
object store. The role of the Ray-core surface the reference uses
(``ray.init``, ``ray.remote``, ``ray.get``, ``ray.put``, ``ray.wait``,
``ray.kill``).

Node 0 is this machine: its actors are child interpreters
(``runtime/actor_boot.py``). Further nodes are hosts running a
:class:`~ray_lightning_tpu_torch.runtime.node.NodeAgent`; the main process
attaches with :func:`connect_node`, the agent spawns the actors placed
there, and the main process dials them directly. Every node advertises
``{"CPU": n, ...}``; every actor carries a demand; placement is first-fit
("pack"), round-robin ("spread") or pinned, and a demand that fits nowhere
raises at once.

Local actors boot as fresh interpreters by default. ``create_actors(...,
zygote=True)``, or ``TORCHRT_ZYGOTE=1`` in this process's environment (the
JAX runtime's ``RLT_ZYGOTE``, the one variable this module reads), forks them
from a zygote instead (``runtime/zygote.py``): one preloaded process per
creator, started at the first such spawn (or ahead, :func:`warm_zygote`),
replaced if it dies, shut down with the runtime. Unlike the JAX runtime the
logical CPU count is an argument of :func:`init`, and everything is pickled
with the standard library.
"""
from __future__ import annotations

import atexit
import json
import os
import select
import signal
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.runtime.actor import (
    ActorError,
    ActorHandle,
    CallFuture,
    dumps,
    make_authkey,
)
from ray_lightning_tpu_torch.runtime.object_store import (
    ObjectRef,
    ObjectStore,
    get_object,
)

_LEN = struct.Struct("!Q")
ZYGOTE_ENV = "TORCHRT_ZYGOTE"
# the directory that holds the package: a child interpreter must import the
# port before it reads the main process's sys.path from its bootstrap
_PACKAGE_ROOT = str(Path(__file__).resolve().parent.parent.parent)


class _Node:
    """One schedulable host: capacity bookkeeping and, for a remote host,
    the agent that spawns its actors."""

    def __init__(self, node_id: int, ip: str, num_cpus: float,
                 resources: Optional[Dict[str, float]] = None,
                 agent: Optional[ActorHandle] = None,
                 dial: Optional[Tuple[str, int]] = None):
        self.node_id = node_id
        self.ip = ip
        self.dial = dial
        self.total: Dict[str, float] = {"CPU": float(num_cpus)}
        for key, value in (resources or {}).items():
            self.total[key] = float(value)
        self.available: Dict[str, float] = dict(self.total)
        self.agent = agent
        self.actor_demands: Dict[str, Dict[str, float]] = {}

    def reserve(self, name: str, demand: Dict[str, float]) -> None:
        for key, value in demand.items():
            self.available[key] = self.available.get(key, 0.0) - value
        self.actor_demands[name] = dict(demand)

    def release(self, name: str) -> None:
        demand = self.actor_demands.pop(name, None)
        for key, value in (demand or {}).items():
            self.available[key] = min(self.total.get(key, 0.0),
                                      self.available.get(key, 0.0) + value)


class _RuntimeState:
    def __init__(self):
        self.initialized = False
        self.store: Optional[ObjectStore] = None
        # name -> (handle, local Popen or None, node id)
        self.actors: Dict[str, Tuple[ActorHandle, Optional[subprocess.Popen],
                                     int]] = {}
        self.nodes: List[_Node] = []
        self.next_node_id = 1
        self.atexit_registered = False
        self.zygote = None  # runtime/zygote.py's ZygoteClient


_state = _RuntimeState()


def is_initialized() -> bool:
    return _state.initialized


def init(num_cpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         address: Optional[Any] = None, authkey: Optional[bytes] = None) -> None:
    """Idempotent bring-up; registers this machine as node 0 with
    ``num_cpus`` logical CPUs (scheduling bookkeeping, not a cgroup; default
    ``os.cpu_count()``) and ``resources``, including ``{"GPU": n}`` for its
    cards when given. With ``address`` (``"host:port"`` of a node agent)
    and its ``authkey`` this is a client: node 0 offers nothing and every
    actor lands on the attached node(s)."""
    if address is not None and authkey is None:
        raise ValueError("init(address=...) requires the node agent's authkey")
    if isinstance(address, str):
        host, _, port = address.rpartition(":")
        address = (host, int(port))
    if _state.initialized:
        if address is not None and not any(n.dial == tuple(address)
                                           for n in _state.nodes):
            connect_node(tuple(address), authkey)
        return
    _state.store = ObjectStore()
    merged = dict(resources or {})
    if address is not None:
        num_cpus, merged = 0.0, {}
    elif num_cpus is None:
        num_cpus = float(os.cpu_count() or 1)
    _state.nodes = [_Node(0, "127.0.0.1", float(num_cpus), merged)]
    _state.initialized = True
    if not _state.atexit_registered:
        atexit.register(shutdown)
        _state.atexit_registered = True
    if address is not None:
        connect_node(tuple(address), authkey)


def connect_node(address: Tuple[str, int], authkey: bytes,
                 timeout: float = 30.0) -> int:
    """Attach a host running a NodeAgent; returns its node id. Its address
    and resources come from the agent's ``node_info()``."""
    if not _state.initialized:
        init()
    agent = ActorHandle(name=f"node-agent-{address[0]}:{address[1]}",
                        address=tuple(address), authkey=authkey)
    info = agent.node_info.remote().result(timeout=timeout)
    node = _Node(_state.next_node_id, info["node_ip"], info["num_cpus"],
                 info.get("resources"), agent=agent, dial=tuple(address))
    _state.next_node_id += 1
    _state.nodes.append(node)
    return node.node_id


def _get_node(node_id: int) -> _Node:
    for node in _state.nodes:
        if node.node_id == node_id:
            return node
    raise KeyError(f"unknown node id {node_id}")


def nodes() -> List[Dict[str, Any]]:
    return [{"node_id": n.node_id, "ip": n.ip, "total": dict(n.total),
             "available": dict(n.available), "remote": n.agent is not None}
            for n in _state.nodes]


def shutdown() -> None:
    """Kill every actor this process started and free the object store."""
    if not _state.initialized:
        return
    for name in list(_state.actors):
        kill(_state.actors[name][0])
    if _state.zygote is not None:
        _state.zygote.shutdown()
        _state.zygote = None
    if _state.store is not None:
        _state.store.shutdown()
        _state.store = None
    _state.nodes = []
    _state.initialized = False


def cluster_resources() -> Dict[str, float]:
    """Every node's resources, summed."""
    if not _state.initialized:
        init()
    out: Dict[str, float] = {}
    for node in _state.nodes:
        for key, value in node.total.items():
            out[key] = out.get(key, 0.0) + value
    return out


def plan_placement(demands: Sequence[Dict[str, float]],
                   placement: Any = None) -> List[int]:
    """One node id per demand, spawning nothing: None/"pack" fills nodes in
    id order, "spread" round-robins over the nodes that fit, a sequence of
    node ids pins each actor. Raises :class:`ActorError` when a demand fits
    nowhere, with every node's availability in the message."""
    if not _state.initialized:
        init()
    avail = {n.node_id: dict(n.available) for n in _state.nodes}
    order = [n.node_id for n in _state.nodes]

    def try_reserve(node_id: int, demand: Dict[str, float]) -> bool:
        a = avail[node_id]
        if all(a.get(k, 0.0) >= v for k, v in demand.items()):
            for k, v in demand.items():
                a[k] = a.get(k, 0.0) - v
            return True
        return False

    out: List[int] = []
    rr = 0
    for i, demand in enumerate(demands):
        chosen: Optional[int] = None
        if placement is not None and not isinstance(placement, str):
            node_id = list(placement)[i]
            if node_id not in avail:
                raise ActorError(f"cannot place actor {i}: pinned node id "
                                 f"{node_id} is not attached ({sorted(avail)})")
            if try_reserve(node_id, demand):
                chosen = node_id
        elif placement == "spread":
            for j in range(len(order)):
                node_id = order[(rr + j) % len(order)]
                if try_reserve(node_id, demand):
                    chosen = node_id
                    rr = (order.index(node_id) + 1) % len(order)
                    break
        else:
            chosen = next((n for n in order if try_reserve(n, demand)), None)
        if chosen is None:
            detail = ", ".join(
                f"node{n.node_id}({n.ip}): " + " ".join(
                    f"{k}={avail[n.node_id].get(k, 0.0):g}"
                    for k in sorted(set(demand) | set(n.total)))
                for n in _state.nodes)
            raise ActorError(
                f"cannot place actor {i} with demand {demand}: no node has "
                f"capacity [{detail}]. Lower num_cpus_per_worker or "
                "resources_per_worker, attach nodes, or raise the logical CPU "
                "count with runtime.init(num_cpus=...)")
        out.append(chosen)
    return out


def create_actor(cls: type, args: Sequence[Any] = (),
                 kwargs: Optional[Dict[str, Any]] = None,
                 name: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None, num_cpus: float = 1,
                 resources: Optional[Dict[str, float]] = None,
                 timeout: float = 120.0) -> ActorHandle:
    """Spawn one actor process; returns its picklable handle."""
    demand = {"CPU": float(num_cpus)}
    demand.update({k: float(v) for k, v in (resources or {}).items()})
    return create_actors([(cls, args, kwargs)], names=[name] if name else None,
                         env=env, timeout=timeout, demands=[demand])[0]


def _child_env(env: Optional[Dict[str, Optional[str]]]) -> Dict[str, str]:
    """The spawner's environment, ``env`` applied (None removes a key), and
    the port's root first on PYTHONPATH."""
    child = dict(os.environ)
    for key, value in (env or {}).items():
        if value is None:
            child.pop(key, None)
        else:
            child[key] = str(value)
    path = child.get("PYTHONPATH", "")
    child["PYTHONPATH"] = (_PACKAGE_ROOT + os.pathsep + path if path
                           else _PACKAGE_ROOT)
    return child


def _spec_blobs(cls: type, args: Sequence[Any],
                kwargs: Optional[Dict[str, Any]]) -> Tuple[bytes, bytes]:
    """An actor's class and arguments, pickled by reference in the main process:
    only the actor's own process unpickles them."""
    return (dumps(cls, f"the actor class {cls!r}"),
            dumps((tuple(args), dict(kwargs or {})), "the actor's arguments"))


def _spawn_local_proc(spec: Tuple[bytes, bytes], authkey: bytes,
                      child_env: Dict[str, str], ctx: Dict[str, Any],
                      bind_host: str = "127.0.0.1") -> subprocess.Popen:
    """Boot one actor interpreter on this host (the node agent uses it for
    remote spawns too). ``ctx`` is the main process's ``sys_path`` and ``cwd``.
    The child's stdin pipe stays open in this process for the child's life:
    the actor exits when it reads end-of-file there, that is when this
    process is gone (``actor_boot.py``)."""
    blobs = [authkey, json.dumps(dict(ctx, bind_host=bind_host)).encode(),
             *spec]
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_lightning_tpu_torch.runtime.actor_boot"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=None,
        env=child_env)
    try:
        for blob in blobs:
            proc.stdin.write(_LEN.pack(len(blob)) + blob)
        proc.stdin.flush()
    except BrokenPipeError:
        pass
    return proc


def pid_exited(pid: int) -> bool:
    """Whether process ``pid`` has exited (gone, or a zombie)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return True


class ForkedProcess:
    """A zygote's child, driven like the ``Popen`` of a classic actor (it is
    not this process's child: the zygote reaps it, so exit is read from
    ``/proc``)."""

    def __init__(self, pid: int):
        self.pid = pid

    def poll(self) -> Optional[int]:
        return 0 if pid_exited(self.pid) else None

    def _signal(self, sig: int) -> None:
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            pass

    def kill(self) -> None:
        self._signal(signal.SIGKILL)

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while not pid_exited(self.pid):
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(f"pid {self.pid}", timeout)
            time.sleep(0.01)
        return 0


def _use_zygote() -> bool:
    return os.environ.get(ZYGOTE_ENV) == "1"


def _get_zygote():
    """This process's zygote, started at the first call; one that died or
    lost step is replaced."""
    from ray_lightning_tpu_torch.runtime.zygote import ZygoteClient

    if _state.zygote is not None and not _state.zygote.alive():
        try:
            _state.zygote.shutdown()
        except Exception:
            pass
        _state.zygote = None
    if _state.zygote is None:
        _state.zygote = ZygoteClient(_child_env(None))
    return _state.zygote


def warm_zygote():
    """Start this process's zygote now, so that its imports overlap other
    work (an elastic launch warms it for the spare it may need); returns
    the client."""
    if not _state.initialized:
        init()
    return _get_zygote()


def _main_ctx() -> Dict[str, Any]:
    return {"sys_path": list(sys.path), "cwd": os.getcwd()}


def create_actors(specs: Sequence[Tuple[type, Sequence[Any],
                                        Optional[Dict[str, Any]]]],
                  names: Optional[Sequence[str]] = None,
                  env: Optional[Dict[str, str]] = None,
                  per_actor_env: Optional[Sequence[Dict[str, str]]] = None,
                  timeout: float = 180.0,
                  demands: Optional[Sequence[Dict[str, float]]] = None,
                  placement: Any = None,
                  assignments: Optional[Sequence[int]] = None,
                  zygote: bool = False) -> List[ActorHandle]:
    """Spawn many actors at once (their interpreter boots overlap). Local
    actors are child processes; each remote node gets one ``spawn`` call
    for its share. On any failure every actor of the call is killed and
    :class:`ActorError` (a process failure) names the causes."""
    if not _state.initialized:
        init()
    zygote = zygote or _use_zygote()
    n = len(specs)
    if names is None:
        names = [f"torchrt-actor-{len(_state.actors) + i}-{os.getpid()}"
                 for i in range(n)]
    if demands is None:
        demands = [{"CPU": 1.0} for _ in range(n)]
    if assignments is None:
        assignments = plan_placement(demands, placement)
    for name, demand, node_id in zip(names, demands, assignments):
        _get_node(node_id).reserve(name, demand)

    handles: List[ActorHandle] = []
    errors: List[str] = []
    local_pending = []
    remote_groups: Dict[int, List[int]] = {}
    try:
        for i, ((cls, args, kwargs), name, node_id) in enumerate(
                zip(specs, names, assignments)):
            if _get_node(node_id).agent is None:
                merged = dict(env or {})
                merged.update(per_actor_env[i] if per_actor_env else {})
                authkey = make_authkey()
                if zygote:
                    # forked from the preloaded zygote: no interpreter boot
                    try:
                        port, pid = _get_zygote().spawn(
                            cls, args, kwargs, authkey, _child_env(merged),
                            timeout, _main_ctx())
                    except Exception as e:
                        _get_node(node_id).release(name)
                        errors.append(f"{name}: {e}")
                        continue
                    handle = ActorHandle(name, ("127.0.0.1", port), authkey,
                                         pid)
                    _state.actors[name] = (handle, ForkedProcess(pid), node_id)
                    handles.append(handle)
                    continue
                proc = _spawn_local_proc(_spec_blobs(cls, args, kwargs),
                                         authkey, _child_env(merged),
                                         _main_ctx())
                local_pending.append((name, authkey, proc, node_id))
            else:
                remote_groups.setdefault(node_id, []).append(i)

        remote_futures = []
        for node_id, idxs in remote_groups.items():
            node = _get_node(node_id)
            keys = [make_authkey() for _ in idxs]
            fut = node.agent.spawn.remote(
                [_spec_blobs(*specs[i]) for i in idxs], _main_ctx(),
                [names[i] for i in idxs], [k.hex() for k in keys],
                dict(env or {}),
                [per_actor_env[i] if per_actor_env else None for i in idxs],
                timeout)
            remote_futures.append((node_id, idxs, keys, fut))

        for name, authkey, proc, node_id in local_pending:
            port = _handshake(name, proc, timeout, errors)
            if port is None:
                _get_node(node_id).release(name)
                continue
            handle = ActorHandle(name, ("127.0.0.1", port), authkey, proc.pid)
            _state.actors[name] = (handle, proc, node_id)
            handles.append(handle)

        for node_id, idxs, keys, fut in remote_futures:
            node = _get_node(node_id)
            try:
                spawned = {e["name"]: e for e in fut.result(timeout=timeout + 30)}
            except Exception as e:
                for i in idxs:
                    node.release(names[i])
                errors.append(f"agent on node {node_id} ({node.ip}): {e!r}")
                continue
            for i, key in zip(idxs, keys):
                entry = spawned.get(names[i])
                if entry is None or entry.get("error"):
                    node.release(names[i])
                    errors.append(f"{names[i]}: "
                                  f"{entry.get('error') if entry else 'no result'}")
                    continue
                handle = ActorHandle(names[i], (node.ip, entry["port"]), key,
                                     entry.get("pid", 0))
                _state.actors[names[i]] = (handle, None, node_id)
                handles.append(handle)
    except BaseException:
        for h in handles:
            try:
                kill(h, timeout=1.0)
            except Exception:
                pass
        for name, _, proc, node_id in local_pending:
            if proc.poll() is None:
                proc.kill()
        for name, node_id in zip(names, assignments):
            try:
                _get_node(node_id).release(name)
            except KeyError:
                pass
            _state.actors.pop(name, None)
        raise

    if errors:
        for h in handles:
            kill(h)
        raise ActorError("actor startup failed:\n" + "\n".join(errors),
                         is_process_failure=True)
    order = {name: i for i, name in enumerate(names)}
    handles.sort(key=lambda h: order[h.name])
    return handles


def _handshake(name: str, proc: subprocess.Popen, timeout: float,
               errors: List[str]) -> Optional[int]:
    """Wait (bounded by ``timeout``) for the ready line, then keep
    forwarding the actor's stdout to this process's stderr."""
    line = b""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        remaining = deadline - time.monotonic()
        ready, _, _ = select.select([proc.stdout], [], [],
                                    max(0.0, min(remaining, 1.0)))
        if ready:
            line = proc.stdout.readline()
            if line:
                break
        if proc.poll() is not None:
            break
    text = line.decode(errors="replace").strip()
    if not text.startswith("TORCHRT_ACTOR_READY"):
        rest = b""
        if proc.poll() is not None:
            rest = proc.stdout.read() or b""
        proc.kill()
        proc.wait(timeout=10)
        errors.append(f"{name}: " + (text or f"did not report readiness "
                                     f"within {timeout}s")
                      + ("\n" + rest.decode(errors="replace") if rest else ""))
        return None
    port = int(text.split()[1])

    def drain():
        try:
            for out_line in proc.stdout:
                sys.stderr.write(f"({name}) {out_line.decode(errors='replace')}")
        except ValueError:
            pass

    threading.Thread(target=drain, daemon=True, name=f"drain-{name}").start()
    return port


def actor_node_id(handle: ActorHandle) -> int:
    """The node an actor was placed on (0 = this machine)."""
    entry = _state.actors.get(handle.name)
    return entry[2] if entry is not None else 0


def kill(handle: ActorHandle, no_restart: bool = True, timeout: float = 5.0,
         force: bool = False) -> None:
    """A graceful shutdown call, then the process is reaped (terminated,
    then killed, if it does not exit within ``timeout``). A local actor that
    did not acknowledge the call within ``timeout`` (busy in a call) is
    terminated at once. ``force`` kills at once."""
    entry = _state.actors.pop(handle.name, None)
    node = None
    if entry is not None:
        try:
            node = _get_node(entry[2])
        except KeyError:
            node = None
    acked = False
    if not force:
        acked = handle.shutdown(timeout=timeout)
    if node is not None and node.agent is not None:
        try:
            node.agent.kill_actor.remote(handle.name, timeout, force).result(
                timeout=timeout + 10)
        except Exception:
            pass
        node.release(handle.name)
    elif entry is not None:
        proc = entry[1]
        if node is not None:
            node.release(handle.name)
        if proc is not None:
            if force:
                proc.kill()
            elif not acked:
                proc.terminate()
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=timeout)
    conn = handle.__dict__.pop("_connection", None)
    if conn is not None:
        conn.close()


def put(obj: Any) -> ObjectRef:
    if not _state.initialized:
        init()
    return _state.store.put(obj)


def delete(ref: ObjectRef) -> None:
    """Free an object-store segment this process created."""
    if _state.store is not None:
        _state.store.delete(ref)


def get(ref_or_fut, timeout: Optional[float] = None):
    if isinstance(ref_or_fut, (list, tuple)):
        return [get(r, timeout) for r in ref_or_fut]
    if isinstance(ref_or_fut, ObjectRef):
        return get_object(ref_or_fut)
    if isinstance(ref_or_fut, CallFuture):
        return ref_or_fut.result(timeout)
    raise TypeError(f"cannot get {type(ref_or_fut)!r}")


def wait(futures: List[CallFuture], num_returns: int = 1,
         timeout: Optional[float] = None
         ) -> Tuple[List[CallFuture], List[CallFuture]]:
    """``ray.wait``: poll until ``num_returns`` futures are done or
    ``timeout`` passes."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        ready = [f for f in futures if f.done()]
        if len(ready) >= num_returns or (
                deadline is not None and time.monotonic() >= deadline):
            return ready, [f for f in futures if not f.done()]
        time.sleep(0.01)
