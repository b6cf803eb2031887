"""Per-host node agent (``ray_lightning_tpu/runtime/node.py``): the role of
Ray's raylet, the process through which a main process places actors on another
machine. ``python -m ray_lightning_tpu_torch.runtime.node --authkey-file F``
plays ``ray start``; the main process attaches with
:func:`ray_lightning_tpu_torch.runtime.api.connect_node`.

The agent is itself an actor, bound to the host's interface and gated by a
shared authkey. The actors it spawns bind every interface and the main process
dials them directly: the agent carries control calls only. The authkey comes
from ``--authkey-hex`` or ``--authkey-file``; the port reads no environment
variable for it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional, Tuple

from ray_lightning_tpu_torch.utils.ports import node_ip_address


class NodeAgent:
    """Spawns and kills actor processes on this host for a main process."""

    def __init__(self, advertise_ip: Optional[str] = None,
                 num_cpus: Optional[int] = None,
                 resources: Optional[Dict[str, float]] = None):
        self.advertise_ip = advertise_ip or node_ip_address()
        self.num_cpus = float(num_cpus or os.cpu_count() or 1)
        self.resources = dict(resources or {})
        self._procs: Dict[str, subprocess.Popen] = {}

    def ping(self) -> str:
        return "pong"

    def node_info(self) -> Dict[str, Any]:
        return {"node_ip": self.advertise_ip, "num_cpus": self.num_cpus,
                "resources": dict(self.resources), "pid": os.getpid()}

    def spawn(self, specs: List[Tuple[bytes, bytes]], ctx: Dict[str, Any],
              names: List[str], authkeys_hex: List[str], env: Dict[str, str],
              per_actor_env: List[Optional[Dict[str, str]]],
              timeout: float) -> List[Dict[str, Any]]:
        """Boot actor interpreters here; returns ``{"name", "port", "pid"}``
        (or ``{"name", "error"}``) for each. The main process made the authkeys
        and pickled each actor's class and arguments; only the actor's own
        process unpickles them, with the main process's ``sys.path`` (``ctx``)
        ahead of its own."""
        from ray_lightning_tpu_torch.runtime.api import (
            _child_env,
            _handshake,
            _spawn_local_proc,
        )

        pending = []
        for i, (spec, name) in enumerate(zip(specs, names)):
            merged = dict(env)
            merged.update(per_actor_env[i] or {})
            proc = _spawn_local_proc(spec, bytes.fromhex(authkeys_hex[i]),
                                     _child_env(merged), ctx,
                                     bind_host="0.0.0.0")
            pending.append((name, proc))
        results: List[Dict[str, Any]] = []
        for name, proc in pending:
            errors: List[str] = []
            port = _handshake(name, proc, timeout, errors)
            if port is None:
                results.append({"name": name, "error": "; ".join(errors)})
                continue
            self._procs[name] = proc
            results.append({"name": name, "port": port, "pid": proc.pid})
        return results

    def kill_actor(self, name: str, timeout: float = 5.0,
                   force: bool = False) -> bool:
        proc = self._procs.pop(name, None)
        if proc is None:
            return False
        if force:
            proc.kill()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.terminate()
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
        return True

    def live_actors(self) -> List[str]:
        return [n for n, p in self._procs.items() if p.poll() is None]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Start a node agent of the port's runtime (the "
                    "'ray start' role).")
    parser.add_argument("--host", default="0.0.0.0",
                        help="interface for the agent's control socket")
    parser.add_argument("--port", type=int, default=0, help="0 = any free port")
    parser.add_argument("--advertise-ip", default=None,
                        help="the address main processes dial for this "
                             "node's actors")
    parser.add_argument("--authkey-hex", default=None, help="shared secret (hex)")
    parser.add_argument("--authkey-file", default=None,
                        help="a file whose contents are the secret (hex)")
    parser.add_argument("--num-cpus", type=int, default=None)
    parser.add_argument("--resources", default=None,
                        help='JSON dict of custom resources, e.g. \'{"GPU": 8}\'')
    args = parser.parse_args(argv)
    if args.authkey_file:
        with open(args.authkey_file) as f:
            args.authkey_hex = f.read().strip()
    if not args.authkey_hex:
        parser.error("an authkey is required (--authkey-hex or --authkey-file):"
                     " the agent runs code it is sent on this host")
    from ray_lightning_tpu_torch.runtime.actor import serve_instance

    agent = NodeAgent(advertise_ip=args.advertise_ip, num_cpus=args.num_cpus,
                      resources=json.loads(args.resources)
                      if args.resources else None)
    serve_instance(agent, bytes.fromhex(args.authkey_hex),
                   ready_stream=sys.stdout, bind_host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
