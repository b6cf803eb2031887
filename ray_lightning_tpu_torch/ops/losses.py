"""Memory-lean LM losses (``ray_lightning_tpu/ops/losses.py``).

:func:`chunked_softmax_cross_entropy` computes the masked next-token cross
entropy over sequence chunks, each under ``torch.utils.checkpoint``: forward
keeps only the scalar partial sums, backward recomputes one chunk's logits at
a time, so peak logits memory is O(B·S/n·V) instead of O(B·S·V). The sum over
chunks is the sum over positions; the head matmul runs twice.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _masked_ce_sum(logits: torch.Tensor, targets: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """sum(mask * CE(logits in fp32, targets)) — optax's
    softmax_cross_entropy_with_integer_labels, masked and summed."""
    v = logits.shape[-1]
    losses = F.cross_entropy(logits.float().reshape(-1, v),
                             targets.long().reshape(-1), reduction="none")
    return (losses * mask.reshape(-1)).sum()


def masked_softmax_cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The monolithic path: full [B, S, V] logits in one shot. Returns (sum
    of masked per-token losses, sum of mask)."""
    return _masked_ce_sum(logits, targets, mask), mask.sum()


def _chunk_loss(h, w, targets, mask):
    return _masked_ce_sum(h @ w, targets, mask)


def chunked_softmax_cross_entropy(
    h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
    mask: torch.Tensor, n_chunks: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token CE without materialising full logits.

    h: [B, S, D] final hidden states (post final norm); w: [D, V] head;
    targets/mask: [B, S]. Returns (sum of masked per-token losses, sum of
    mask); callers divide. S must divide by ``n_chunks``."""
    s = h.shape[1]
    if s % n_chunks:
        raise ValueError(f"sequence {s} must divide into {n_chunks} chunks")
    c = s // n_chunks
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        part = (slice(None), slice(i * c, (i + 1) * c))
        args = (h[part], w, targets[part], mask[part])
        if remat:
            total = total + checkpoint(_chunk_loss, *args, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + _chunk_loss(*args)
    return total, mask.sum()
