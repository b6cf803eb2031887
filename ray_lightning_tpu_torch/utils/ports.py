"""Network helpers for the workers' rendezvous (``ray_lightning_tpu/utils/
ports.py``): a free TCP port for ``torch.distributed``'s ``tcp://`` init
method, and this host's address as peers see it."""
from __future__ import annotations

import socket
from typing import Optional


def find_free_port(host: str = "") -> int:
    """A TCP port that was free a moment ago on ``host`` (all interfaces by
    default). Another process may take it before the caller binds it; the
    rendezvous then fails loudly and the launcher's caller retries."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        return s.getsockname()[1]


def node_ip_address(override: Optional[str] = None) -> str:
    """This host's address for peers: ``override`` when given (a node agent
    passes its advertised address), else what the host name resolves to,
    else loopback. Unlike the JAX package's helper this reads no environment
    variable and opens no socket toward another host."""
    if override:
        return override
    try:
        ip = socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"
    return ip or "127.0.0.1"
