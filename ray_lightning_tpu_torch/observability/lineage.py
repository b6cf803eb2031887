"""Driver-side cross-replica request lineage reconstruction
(``ray_lightning_tpu/observability/lineage.py``).

Under disaggregated serving one request lives on several replicas: a
prefill replica runs the prompt pass, a checksummed KV shipment crosses
the pool boundary, a decode replica streams the tokens — plus retry and
colocated-fallback branches when anything on that path fails. Each
replica's :mod:`~.reqtrace` records only its own hop; this module merges
the fleet-wide ``requests.jsonl`` stream back into one causal timeline
per request.

Every hop record carries its position in the causal chain (``hop``,
``parent_rid``, ``origin_replica`` — threaded through the hop-carrying
:class:`~.reqtrace.TraceContext` that rides fleet dispatch and
``KVShipment``), so reconstruction is a join on the base request id plus
parent linkage, not a guess. Per-rank wall clocks are aligned with the
aggregator's heartbeat skew estimates (:func:`~.trace.estimate_skew`)
before any cross-replica duration is computed.

Outputs:

- :func:`build_lineages` — ``base rid -> Lineage`` (ordered hops,
  retry/migration branches, orphan detection);
- :func:`write_lineage` / ``lineage.jsonl`` — one summary line per
  request (hops, per-hop spans, TTFT decomposition, completeness);
- :func:`chrome_events` — per-hop slices on each replica's process plus
  Perfetto flow arrows connecting consecutive hops across tracks,
  appended to the merged ``trace.json``;
- :func:`render` — the ``cli lineage <rid>`` text timeline.
"""
from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

from . import reqtrace, trace

LINEAGE_FILE = "lineage.jsonl"

# Bytes of the fleet requests.jsonl tail an incident bundle's lineage
# slice reads (stitched across rotation; see reqtrace.read_window).
LINEAGE_WINDOW_ENV = "TORCHRT_LINEAGE_WINDOW_BYTES"
DEFAULT_LINEAGE_WINDOW = 256 * 1024

# tid for the lineage row under each replica's process in trace.json —
# far above the dynamic per-request track tids to avoid colliding with
# to_chrome_events' small sequential assignments
LINEAGE_TID = 9999


def lineage_window_bytes(environ=os.environ) -> int:
    try:
        return int(environ.get(LINEAGE_WINDOW_ENV, DEFAULT_LINEAGE_WINDOW))
    except ValueError:
        return DEFAULT_LINEAGE_WINDOW


@dataclass
class Hop:
    """One replica's view of one attempt of one request, clock-corrected
    onto the driver's timeline."""

    rid: str
    base_rid: str
    hop: int
    parent_rid: Optional[str]
    replica: Optional[Any]
    rank: Optional[Any]
    pool: Optional[str]
    start_ts: float
    end_ts: float
    finish_reason: str
    disposition: str
    record: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return max(0.0, self.end_ts - self.start_ts)

    def spans(self) -> List[Dict[str, Any]]:
        """This hop's own timeline segments, back-to-back from
        ``start_ts`` (plus a leading ``transfer`` segment ENDING at
        ``start_ts`` on a migrated-in hop): what the cli renders and
        what the flow arrows anchor to."""
        out: List[Dict[str, Any]] = []
        rec = self.record
        transfer = rec.get("transfer_s")
        if transfer:
            out.append({
                "name": "transfer",
                "start_ts": round(self.start_ts - float(transfer), 6),
                "duration_s": float(transfer),
            })
        t = self.start_ts
        parts: List[tuple] = []
        if rec.get("queue_wait_s") is not None:
            parts.append(("queue_wait", float(rec["queue_wait_s"])))
        if rec.get("prefill_s") is not None:
            parts.append(("prefill", float(rec["prefill_s"])))
        ttft = rec.get("ttft_s")
        if ttft is not None:
            covered = sum(d for _, d in parts)
            parts.append(("decode", max(0.0, float(ttft) - covered)))
        for name, dur in parts:
            out.append({
                "name": name,
                "start_ts": round(t, 6),
                "duration_s": round(dur, 6),
            })
            t += dur
        tail = self.end_ts - t
        if tail > 0:
            # migrated hops park here awaiting the pump; completed hops
            # stream their remaining tokens
            out.append({
                "name": "parked" if self.disposition == "migrated" else "stream",
                "start_ts": round(t, 6),
                "duration_s": round(tail, 6),
            })
        return out


@dataclass
class Lineage:
    """All hops of one base request, in causal order."""

    base_rid: str
    hops: List[Hop] = field(default_factory=list)

    @property
    def migrations(self) -> int:
        return sum(1 for h in self.hops if "~m" in h.rid)

    @property
    def retries(self) -> int:
        return sum(1 for h in self.hops if "~r" in h.rid)

    @property
    def final_hop(self) -> Optional[Hop]:
        """The hop that carried the client-facing outcome: the last hop
        whose disposition is not the internal ``migrated`` hand-off."""
        for h in reversed(self.hops):
            if h.disposition != "migrated":
                return h
        return self.hops[-1] if self.hops else None

    def orphan_hops(self) -> List[str]:
        """Rids whose recorded parent attempt left no record — the
        lineage is missing a link (rotation loss, an unsampled hop, or a
        replica that died before draining its records)."""
        known = {h.rid for h in self.hops}
        out = []
        for h in self.hops:
            parent = h.parent_rid or _implied_parent(h.rid)
            if parent and parent not in known:
                out.append(h.rid)
        return out

    @property
    def complete(self) -> bool:
        return bool(self.hops) and not self.orphan_hops()

    def branches(self) -> Dict[str, List[str]]:
        """Parent rid -> child attempt rids, for hops that share a
        parent (a retry/fallback fan-out reads as one parent with
        several children; attempt suffixes beyond the recorded children
        imply shipment attempts that never landed)."""
        out: Dict[str, List[str]] = {}
        for h in self.hops:
            parent = h.parent_rid or _implied_parent(h.rid)
            if parent:
                out.setdefault(parent, []).append(h.rid)
        return out


def _implied_parent(rid: str) -> Optional[str]:
    """Parent attempt implied by the rid grammar when no explicit
    parent_rid was recorded: ``base~rN`` retries ``base~r(N-1)`` (or the
    base attempt for N=1). Migration rids (``~mK``) have no implied
    parent — their parent is whichever prefill attempt exported, known
    only from the shipment's trace context."""
    base = reqtrace.base_rid(rid)
    if rid == base:
        return None
    suffix = rid[len(base):]
    if suffix.startswith("~r"):
        try:
            n = int(suffix[2:])
        except ValueError:
            return None
        return base if n <= 1 else f"{base}~r{n - 1}"
    return None


def _hop_from_record(
    rec: Dict[str, Any], skew_by_rank: Optional[Dict[Any, float]] = None
) -> Optional[Hop]:
    rid = rec.get("request_id")
    ts = rec.get("ts")
    if rid is None or ts is None:
        return None
    rank = rec.get("rank")
    skew = 0.0
    if skew_by_rank and rank is not None:
        skew = float(skew_by_rank.get(rank, 0.0))
    end_ts = float(ts) - skew
    start = rec.get("start_ts")
    if start is None:
        start = end_ts - float(rec.get("total_s", 0.0))
    else:
        start = float(start) - skew
    reason = str(rec.get("finish_reason", ""))
    return Hop(
        rid=str(rid),
        base_rid=str(rec.get("base_rid", reqtrace.base_rid(str(rid)))),
        hop=int(rec.get("hop", 0)),
        parent_rid=rec.get("parent_rid"),
        replica=rec.get("replica"),
        rank=rank,
        pool=rec.get("pool"),
        start_ts=start,
        end_ts=end_ts,
        finish_reason=reason,
        disposition=str(
            rec.get("disposition", reqtrace.disposition_for(reason))
        ),
        record=rec,
    )


def build_lineages(
    records: Iterable[Dict[str, Any]],
    skew_by_rank: Optional[Dict[Any, float]] = None,
) -> Dict[str, Lineage]:
    """Group finished-request records by base rid into causal lineages.
    ``skew_by_rank`` (rank -> seconds, the aggregator's heartbeat
    estimates) is subtracted from each record's wall timestamps so hop
    durations measured across replicas are meaningful. Duplicate records
    for one attempt rid keep the latest."""
    by_rid: Dict[str, Hop] = {}
    for rec in records:
        hop = _hop_from_record(rec, skew_by_rank)
        if hop is not None:
            by_rid[hop.rid] = hop
    out: Dict[str, Lineage] = {}
    for hop in by_rid.values():
        out.setdefault(hop.base_rid, Lineage(hop.base_rid)).hops.append(hop)
    for lin in out.values():
        lin.hops.sort(key=lambda h: (h.hop, h.start_ts, h.rid))
    return out


def load_lineages(
    path: str, skew_by_rank: Optional[Dict[Any, float]] = None
) -> Dict[str, Lineage]:
    """Lineages from a ``requests.jsonl`` path (or the telemetry dir
    containing one), both rotation generations included."""
    if os.path.isdir(path):
        path = os.path.join(path, reqtrace.REQUESTS_FILE)
    return build_lineages(reqtrace.read_requests(path), skew_by_rank)


def lineages_from_window(
    path: str,
    max_bytes: Optional[int] = None,
    skew_by_rank: Optional[Dict[Any, float]] = None,
) -> Dict[str, Lineage]:
    """Bounded-read variant for incident capture: the trailing window of
    ``requests.jsonl`` stitched across its rotation (half the budget is
    reserved for the rotated generation, so a rotation mid-burst cannot
    orphan the hops on the far side of the boundary)."""
    if max_bytes is None:
        max_bytes = lineage_window_bytes()
    records = []
    for line in reqtrace.read_window(path, max_bytes):
        try:
            records.append(json.loads(line))
        except ValueError:
            continue
    return build_lineages(records, skew_by_rank)


def summary(lin: Lineage) -> Dict[str, Any]:
    """One ``lineage.jsonl`` line: the request's causal story, flat."""
    final = lin.final_hop
    out: Dict[str, Any] = {
        "base_rid": lin.base_rid,
        "hops": [
            {
                "rid": h.rid,
                "hop": h.hop,
                "parent_rid": h.parent_rid,
                "replica": h.replica,
                "rank": h.rank,
                "pool": h.pool,
                "start_ts": round(h.start_ts, 6),
                "end_ts": round(h.end_ts, 6),
                "finish_reason": h.finish_reason,
                "disposition": h.disposition,
                "spans": h.spans(),
            }
            for h in lin.hops
        ],
        "migrations": lin.migrations,
        "retries": lin.retries,
        "complete": lin.complete,
    }
    orphans = lin.orphan_hops()
    if orphans:
        out["orphan_hops"] = orphans
    if final is not None:
        out["disposition"] = final.disposition
        comps = final.record.get("ttft_components")
        if comps:
            out["ttft_components"] = comps
        if final.record.get("ttft_total_s") is not None:
            out["ttft_total_s"] = final.record["ttft_total_s"]
    return out


def write_lineage(path: str, lineages: Dict[str, Lineage]) -> int:
    """Write one summary line per lineage; returns the line count."""
    writer = reqtrace.JsonlWriter(path, max_bytes=0)
    n = 0
    for base in sorted(lineages):
        writer.write(summary(lineages[base]))
        n += 1
    writer.close()
    return n


# --------------------------------------------------------------------- #
# Perfetto output
# --------------------------------------------------------------------- #
def _hop_pid(hop: Hop) -> int:
    who = hop.rank if hop.rank is not None else hop.replica
    return trace._pid_for(who if who is not None else trace.DRIVER)


def chrome_events(lineages: Dict[str, Lineage]) -> List[Dict[str, Any]]:
    """Per-hop slices on a dedicated ``lineage`` row under each replica's
    process, connected hop-to-hop by Perfetto flow arrows — the
    cross-track causal thread the per-process request tracks cannot
    show. Timestamps are already skew-corrected by build time."""
    out: List[Dict[str, Any]] = []
    pids_used: set = set()
    for base in sorted(lineages):
        lin = lineages[base]
        flow_base = zlib.crc32(base.encode("utf-8", "replace")) << 4
        prev: Optional[Hop] = None
        for i, hop in enumerate(lin.hops):
            pid = _hop_pid(hop)
            pids_used.add(pid)
            out.append({
                "name": f"hop {hop.hop} {hop.rid}",
                "cat": "lineage",
                "ph": "X",
                "ts": hop.start_ts * 1e6,
                "dur": hop.duration_s * 1e6,
                "pid": pid,
                "tid": LINEAGE_TID,
                "args": {
                    "disposition": hop.disposition,
                    "pool": hop.pool,
                    "parent": hop.parent_rid,
                },
            })
            if prev is not None:
                out.extend(trace.flow_pair(
                    flow_base | (i & 0xF),
                    f"req {base}",
                    (_hop_pid(prev), LINEAGE_TID, prev.end_ts),
                    (pid, LINEAGE_TID, hop.start_ts),
                ))
            prev = hop
    for pid in sorted(pids_used):
        out.append({
            "name": "thread_name", "ph": "M", "pid": pid,
            "tid": LINEAGE_TID, "args": {"name": "lineage"},
        })
    return out


# --------------------------------------------------------------------- #
# text rendering (cli lineage)
# --------------------------------------------------------------------- #
# causal order of the TTFT decomposition (records store sorted keys)
_COMPONENT_ORDER = (
    "dispatch", "queue_wait", "prefill", "export_wait", "transfer", "decode",
)


def render(lin: Lineage) -> str:
    """Human timeline for one request: one line per hop plus the TTFT
    decomposition of the hop that delivered the first token."""
    final = lin.final_hop
    head = (
        f"{lin.base_rid} — {len(lin.hops)} hop(s), "
        f"{lin.migrations} migration(s), {lin.retries} retr{'y' if lin.retries == 1 else 'ies'}, "
        f"disposition {final.disposition if final else '?'}"
    )
    if not lin.complete:
        head += f"  [INCOMPLETE: orphan hops {', '.join(lin.orphan_hops())}]"
    lines = [head]
    t0 = min(h.start_ts for h in lin.hops) if lin.hops else 0.0
    for hop in lin.hops:
        where = f"replica {hop.replica}" if hop.replica is not None else "replica ?"
        pool = f" pool {hop.pool}" if hop.pool else ""
        segs = " | ".join(
            f"{s['name']} {s['duration_s'] * 1e3:.1f}ms" for s in hop.spans()
        )
        branch = ""
        mnum = _migration_number(hop.rid)
        if mnum is not None and mnum > 1:
            branch = f"  [retry branch: {mnum - 1} failed shipment attempt(s)]"
        parent = f" <- {hop.parent_rid}" if hop.parent_rid else ""
        lines.append(
            f"  hop {hop.hop}  +{(hop.start_ts - t0) * 1e3:8.1f}ms  "
            f"{where}{pool}  {hop.rid}{parent}  "
            f"[{segs}] -> {hop.finish_reason}{branch}"
        )
    if final is not None:
        comps = final.record.get("ttft_components")
        if comps:
            ordered = sorted(
                comps.items(),
                key=lambda kv: (
                    _COMPONENT_ORDER.index(kv[0])
                    if kv[0] in _COMPONENT_ORDER
                    else len(_COMPONENT_ORDER)
                ),
            )
            parts = " + ".join(
                f"{k} {float(v) * 1e3:.1f}ms" for k, v in ordered
            )
            total = final.record.get("ttft_total_s")
            if total is not None:
                parts += f" = {float(total) * 1e3:.1f}ms TTFT"
            lines.append(f"  ttft: {parts}")
    return "\n".join(lines)


def _migration_number(rid: str) -> Optional[int]:
    base = reqtrace.base_rid(rid)
    suffix = rid[len(base):]
    if suffix.startswith("~m"):
        try:
            return int(suffix[2:])
        except ValueError:
            return None
    return None
