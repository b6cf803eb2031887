"""Parameter trees to byte streams and back (``ray_lightning_tpu/utils/
serialization.py``). Weights cross process and host boundaries as in-memory
streams, so several hosts need no shared file system. The JAX package writes
msgpack through flax; the port writes ``torch.save`` streams, which carry
every tensor's dtype (bf16 included) and keep the tree's dicts, lists and
tuples."""
from __future__ import annotations

import io
from typing import Any

import torch

from ray_lightning_tpu_torch.device import DeviceLike
from ray_lightning_tpu_torch.utils.tree import tree_map


def _to_host(tree: Any) -> Any:
    """Every tensor leaf detached and on the CPU (a plain tensor, not an
    ``nn.Parameter``); other leaves as they are."""
    return tree_map(
        lambda x: x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x,
        tree)


def to_state_stream(tree: Any) -> bytes:
    """``torch.save`` of the tree with its tensors on the host."""
    buf = io.BytesIO()
    torch.save(_to_host(tree), buf)
    return buf.getvalue()


def load_state_stream(stream: bytes, device: DeviceLike = "cpu") -> Any:
    """Inverse of :func:`to_state_stream`, the tensors placed on ``device``
    (the CPU by default). Only tensors and plain containers load:
    ``weights_only=True``."""
    return torch.load(io.BytesIO(stream), map_location=device,
                      weights_only=True)

