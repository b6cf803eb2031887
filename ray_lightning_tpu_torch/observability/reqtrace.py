"""The file layer of request tracing (``ray_lightning_tpu/observability/
reqtrace.py``): the size-rotated JSONL writer behind ``events.jsonl`` and
``requests.jsonl``, the rotation-stitched trailing window that incident
bundles and lineage read, and the request-id grammar they share.

The request tracer itself (``TraceContext``, ``RequestTrace``,
``RequestTracer``) belongs beside the serving engine that calls it and is
not ported yet (ROADMAP.md, item 9b).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

EVENTS_MAX_ENV = "TORCHRT_EVENTS_MAX_BYTES"

REQUESTS_FILE = "requests.jsonl"

# JSONL writers rotate once past this size unless the env overrides.
DEFAULT_MAX_JSONL_BYTES = 64 * 1024 * 1024


def disposition_for(finish_reason: str) -> str:
    """Collapse a finish reason into the client-facing disposition
    (completed / shed / expired / cancelled / migrated / failed).

    ``migrated`` is a per-hop disposition, not a client outcome: the
    prefill-side hop of a disaggregated request finishes with it when its
    KV shipment is admitted downstream, and the decode-side hop carries
    the client-facing outcome."""
    if finish_reason in ("eos", "length"):
        return "completed"
    if finish_reason in ("shed", "expired", "cancelled", "migrated"):
        return finish_reason
    return "failed"


def base_rid(request_id: str) -> str:
    """Strip the attempt suffix (``~rN`` retry / ``~mK`` migration) off an
    attempt rid, recovering the client-facing base request id."""
    return str(request_id).split("~", 1)[0]


def jsonl_max_bytes(environ=os.environ) -> int:
    try:
        return int(environ.get(EVENTS_MAX_ENV, DEFAULT_MAX_JSONL_BYTES))
    except ValueError:
        return DEFAULT_MAX_JSONL_BYTES


class JsonlWriter:
    """Append-mode JSONL writer with single-generation size rotation.

    Once the file passes ``max_bytes`` it is renamed to ``<path>.1``
    (replacing the previous rotation) and a fresh file is started, so
    multi-day runs hold at most two generations on disk. ``max_bytes <=
    0`` disables rotation. Used for ``events.jsonl`` and
    ``requests.jsonl``.
    """

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = jsonl_max_bytes() if max_bytes is None else int(max_bytes)
        self.rotations = 0
        self._fh = None
        self._bytes = 0

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, sort_keys=True) + "\n"
        if self._fh is None:
            self._open()
        try:
            self._fh.write(line)
            self._fh.flush()
        except (OSError, ValueError):
            return
        self._bytes += len(line)
        if 0 < self.max_bytes <= self._bytes:
            self._rotate()

    def _open(self) -> None:
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        try:
            self._bytes = self._fh.tell()
        except OSError:
            self._bytes = 0

    def _rotate(self) -> None:
        self.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass
        self.rotations += 1
        self._bytes = 0

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except Exception:
                pass
            self._fh = None

    def read_window(
        self, max_bytes: int = 256 * 1024, rotated_floor: float = 0.5
    ) -> List[str]:
        """Trailing window of this writer's records — see
        :func:`read_window`. Flushes nothing (``write`` already flushes
        per line) but stitches the live file with its rotation, so a
        reader never loses the seconds straddling a rotation boundary."""
        return read_window(self.path, max_bytes, rotated_floor=rotated_floor)


def read_window(
    path: str, max_bytes: int = 256 * 1024, rotated_floor: float = 0.5
) -> List[str]:
    """The last ``max_bytes`` worth of JSONL lines ending at ``path``'s
    tail, stitched across the single-generation rotation, returned
    oldest-first. A partially-included first line (the seek landed
    mid-record) is dropped rather than returned corrupt.

    When both generations exist, ``rotated_floor`` (fraction of the
    budget) is reserved for the ``<path>.1`` tail before the live file
    spends the rest. Without the floor, a live file larger than the
    window starves the rotated generation entirely — and a rotation
    mid-burst splits one request's hop records across the boundary, so a
    lineage reconstructor reading only the live side sees orphan hops.
    The floor still trims from the OLD side first: the live file's last
    complete line is always kept, however small the budget."""
    budget = max(0, int(max_bytes))
    live, rotated = path, path + ".1"
    sizes: Dict[str, int] = {}
    for p in (live, rotated):
        try:
            sizes[p] = os.path.getsize(p)
        except OSError:
            sizes[p] = 0

    def _tail_lines(p: str, take: int) -> List[bytes]:
        size = sizes[p]
        if take <= 0 or size <= 0:
            return []
        take = min(take, size)
        try:
            with open(p, "rb") as fh:
                fh.seek(size - take)
                data = fh.read(take)
        except OSError:
            return []
        if take < size:
            # the seek landed mid-record: drop the corrupt first line
            nl = data.find(b"\n")
            data = data[nl + 1:] if nl >= 0 else b""
        return [ln for ln in data.splitlines() if ln.strip()]

    live_lines = _tail_lines(live, budget)
    reserve = 0
    if live_lines and sizes[rotated] > 0:
        floor = max(0.0, min(1.0, float(rotated_floor)))
        reserve = min(sizes[rotated], int(budget * floor))
    if reserve:
        # give the rotated generation its reserve by shedding the live
        # tail's OLDEST lines — but never its newest complete line
        keep = budget - reserve
        spent = sum(len(ln) + 1 for ln in live_lines)
        while len(live_lines) > 1 and spent > keep:
            spent -= len(live_lines[0]) + 1
            live_lines = live_lines[1:]
        reserve = budget - spent
    rotated_take = budget if not live_lines else reserve
    rotated_lines = _tail_lines(rotated, rotated_take)
    return [
        ln.decode("utf-8", "replace") for ln in rotated_lines + live_lines
    ]


def read_requests(path: str, limit: int = 0) -> List[Dict[str, Any]]:
    """Load a ``requests.jsonl`` (including its ``.1`` rotation if
    present), oldest first; bad lines are skipped."""
    out: List[Dict[str, Any]] = []
    for p in (path + ".1", path):
        if not os.path.exists(p):
            continue
        with open(p, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    if limit > 0:
        out = out[-limit:]
    return out
