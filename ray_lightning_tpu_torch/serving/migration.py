"""Checksummed KV shipments for disaggregated serving
(``ray_lightning_tpu/serving/migration.py``), byte-compatible with the JAX
package's: a shipment one side exports, the other verifies and imports.

A prefill engine (``EngineConfig(role="prefill")``) runs a request's
prompt pass and parks the slot; its prompt blocks then travel to a decode
engine as a :class:`KVShipment`, which carries enough identity to make a
wrong delivery loud:

- a sha256 a block and a digest over the whole shipment: a corrupt
  shipment is refused at the receiver before any payload reaches its
  cache;
- an engine/layout fingerprint over everything that must agree for the
  bytes to mean the same thing on both sides (format version, layout,
  block size, block shape, dtype, ``max_len``): a mismatched receiver
  refuses with :class:`ShipmentMismatch`;
- a format version.

Payloads are host numpy arrays of shape ``[layers, kv_heads, block_size,
head_dim]``, one a prompt block in chain order. A bf16 cache ships as its
raw 16-bit words (a ``uint16`` view: numpy has no bf16 of its own), which
are the bytes the JAX package's bf16 arrays hold, so both sides' checksums
agree; the dtype's name in the fingerprint is numpy's (``"bfloat16"``,
``"float32"``).

Token identity across the handoff holds by construction: the engine's
first token comes from the first decode step, which re-runs the last
prompt token at position ``prompt_len - 1``; a receiver that installs the
prompt blocks and resumes there emits what the colocated engine would.
:class:`MigrationPolicy` and :class:`MigrationStats` are the retry budget
and counters of a pump that moves shipments between engines.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

SHIPMENT_VERSION = 1


class ShipmentError(RuntimeError):
    """Base class for KV-shipment rejections at the receiver."""


class ShipmentCorrupt(ShipmentError):
    """A block payload's bytes do not match its recorded sha256 (or the
    whole-shipment digest fails). The payload was NOT decoded."""


class ShipmentMismatch(ShipmentError):
    """The shipment's format version or engine/layout fingerprint does
    not match the receiver — same bytes, different meaning. Rejected
    before checksum verification even runs."""


class MigrationRejected(RuntimeError):
    """The receiver verified the shipment but could not admit it under
    its own worst-case reservation (no free slot, or not enough paged
    blocks). Not a corruption: the sender may retry elsewhere or fall
    back to colocated decode."""


def kv_fingerprint(
    kv_layout: str,
    block_size: int,
    block_shape: Tuple[int, ...],
    dtype: str,
    max_len: int,
) -> str:
    """Engine/layout fingerprint: 16 hex chars over every property that
    must agree between sender and receiver for a raw block payload to be
    meaningful. Includes the format version so a protocol bump also
    changes the fingerprint."""
    h = hashlib.sha256()
    h.update(
        repr(
            (
                SHIPMENT_VERSION,
                str(kv_layout),
                int(block_size),
                tuple(int(d) for d in block_shape),
                str(dtype),
                int(max_len),
            )
        ).encode("utf-8")
    )
    return h.hexdigest()[:16]


def _block_sha(k: np.ndarray, v: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(k).tobytes())
    h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def _shipment_digest(
    fingerprint: str, prompt: Tuple[int, ...], block_shas: Tuple[str, ...]
) -> str:
    h = hashlib.sha256()
    h.update(repr((SHIPMENT_VERSION, fingerprint, prompt)).encode("utf-8"))
    for sha in block_shas:
        h.update(sha.encode("ascii"))
    return h.hexdigest()


@dataclass(frozen=True)
class KVShipment:
    """One prefilled request's KV, packaged for cross-replica transfer.

    ``block_k[i]`` / ``block_v[i]`` are the host payloads of the i-th
    prompt block (shape ``[layers, kv_heads, block_size, head_dim]``,
    chain order). ``block_shas`` are their per-block checksums and
    ``digest`` seals the whole shipment including the header fields, so
    neither a flipped payload bit nor a swapped prompt survives
    verification."""

    version: int
    fingerprint: str
    request_id: str
    prompt: Tuple[int, ...]
    block_size: int
    block_k: Tuple[np.ndarray, ...]
    block_v: Tuple[np.ndarray, ...]
    block_shas: Tuple[str, ...]
    digest: str
    # the request trace's lineage context, observability only: not sealed
    # by the digest, and None while request tracing is not ported
    trace_ctx: Optional[object] = None

    @property
    def num_blocks(self) -> int:
        return len(self.block_k)

    def nbytes(self) -> int:
        return sum(k.nbytes + v.nbytes for k, v in zip(self.block_k, self.block_v))


def build_shipment(
    request_id: str,
    prompt: Tuple[int, ...],
    fingerprint: str,
    block_size: int,
    block_k: Tuple[np.ndarray, ...],
    block_v: Tuple[np.ndarray, ...],
    trace_ctx: Optional[object] = None,
) -> KVShipment:
    """Seal prompt-block payloads into a checksummed shipment."""
    if len(block_k) != len(block_v):
        raise ValueError("block_k and block_v must pair up")
    shas = tuple(_block_sha(k, v) for k, v in zip(block_k, block_v))
    prompt = tuple(int(t) for t in prompt)
    return KVShipment(
        version=SHIPMENT_VERSION,
        fingerprint=fingerprint,
        request_id=request_id,
        prompt=prompt,
        block_size=int(block_size),
        block_k=tuple(block_k),
        block_v=tuple(block_v),
        block_shas=shas,
        digest=_shipment_digest(fingerprint, prompt, shas),
        trace_ctx=trace_ctx,
    )


def verify_shipment(shipment: KVShipment, expected_fingerprint: str) -> int:
    """Receiver-side gate: version + fingerprint, then every block sha,
    then the whole-shipment digest. Raises :class:`ShipmentMismatch` or
    :class:`ShipmentCorrupt`; returns the verified payload size in bytes.
    MUST run before any payload is written to the device cache."""
    if shipment.version != SHIPMENT_VERSION:
        raise ShipmentMismatch(
            f"shipment {shipment.request_id!r}: format version "
            f"{shipment.version} != {SHIPMENT_VERSION}"
        )
    if shipment.fingerprint != expected_fingerprint:
        raise ShipmentMismatch(
            f"shipment {shipment.request_id!r}: engine fingerprint "
            f"{shipment.fingerprint} != receiver {expected_fingerprint}"
        )
    if len(shipment.block_shas) != len(shipment.block_k):
        raise ShipmentCorrupt(
            f"shipment {shipment.request_id!r}: {len(shipment.block_k)} "
            f"blocks but {len(shipment.block_shas)} checksums"
        )
    for i, (k, v, sha) in enumerate(
        zip(shipment.block_k, shipment.block_v, shipment.block_shas)
    ):
        if _block_sha(k, v) != sha:
            raise ShipmentCorrupt(
                f"shipment {shipment.request_id!r}: block {i} checksum "
                "mismatch — payload corrupted in flight"
            )
    if (
        _shipment_digest(
            shipment.fingerprint, shipment.prompt, shipment.block_shas
        )
        != shipment.digest
    ):
        raise ShipmentCorrupt(
            f"shipment {shipment.request_id!r}: whole-shipment digest "
            "mismatch — header or checksum list corrupted in flight"
        )
    return shipment.nbytes()


def corrupt_copy(shipment: KVShipment) -> KVShipment:
    """Fault-injection helper: a copy of ``shipment`` with one byte of the
    first block's K payload flipped and the ORIGINAL checksums kept — the
    exact artifact a transport bit-flip produces, guaranteed to fail
    :func:`verify_shipment`. The original shipment is untouched, so a
    retry after the corrupt delivery can resend clean bytes."""
    if not shipment.block_k:
        raise ValueError("cannot corrupt an empty shipment")
    bad_k = np.array(shipment.block_k[0], copy=True)
    flat = bad_k.view(np.uint8).reshape(-1)
    flat[0] ^= 0xFF
    return KVShipment(
        version=shipment.version,
        fingerprint=shipment.fingerprint,
        request_id=shipment.request_id,
        prompt=shipment.prompt,
        block_size=shipment.block_size,
        block_k=(bad_k,) + shipment.block_k[1:],
        block_v=shipment.block_v,
        block_shas=shipment.block_shas,
        digest=shipment.digest,
        trace_ctx=shipment.trace_ctx,
    )


@dataclass
class MigrationPolicy:
    """Retry/timeout budget for one migration. Each step (send, verify,
    admit) is timed against its own wall-clock budget; a failed attempt
    backs off exponentially (``backoff_base_s * factor**n``, capped) and
    the whole migration gives up — falling back to colocated decode on
    the prefill replica — after ``max_attempts``."""

    max_attempts: int = 3
    send_timeout_s: float = 1.0
    admit_timeout_s: float = 2.0
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 1.0

    def backoff(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (1-based)."""
        if attempt <= 0:
            return 0.0
        raw = self.backoff_base_s * (self.backoff_factor ** (attempt - 1))
        return min(raw, self.backoff_max_s)


@dataclass
class MigrationStats:
    """Host-side counters of one migration pump."""

    attempts: int = 0
    verified: int = 0
    corrupt: int = 0
    retries: int = 0
    fallbacks: int = 0
    migrated: int = 0
    bytes_shipped: int = 0
    transfer_ms: list = field(default_factory=list)

    def as_dict(self) -> Dict[str, int]:
        return {
            "attempts": self.attempts,
            "verified": self.verified,
            "corrupt": self.corrupt,
            "retries": self.retries,
            "fallbacks": self.fallbacks,
            "migrated": self.migrated,
            "bytes_shipped": self.bytes_shipped,
        }
