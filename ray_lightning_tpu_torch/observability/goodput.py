"""Wall-time goodput ledger: every second classified into one category
(``ray_lightning_tpu/observability/goodput.py``).

A :class:`GoodputLedger` is a tiny state machine over wall time. At any
instant exactly one *category* is open; ``enter()`` closes the open
interval into its category's accumulator and opens the next one. Because
transitions are edges on a single monotonic clock, the per-category
totals sum to the ledger's wall time *by construction* — there is no
sampling error to reconcile, which is what makes the fleet-level
``goodput_fraction`` a trustworthy trajectory metric even on hardware
where raw step time is meaningless (CPU fallback rounds).

Categories (the well-known set; arbitrary names are accepted):

=====================  ====================================================
productive_compute     forward/backward/optimizer dispatch, decode/prefill
compile                first-dispatch jit tracing + XLA compilation
input_wait             blocked on the host input pipeline
collective_wait        blocked on cross-rank collectives (profiler-attributed)
checkpoint             save/restore of model state
elastic_transition     planned membership change (shrink/grow reshard)
arbitration_transfer   chip ownership moving between train and serve
fault_recovery         unplanned recovery (relaunch, resume, re-join)
drain                  graceful teardown / handing back queued work
idle                   none of the above (startup folds here at first enter)
=====================  ====================================================

One process usually owns one ledger (a trainer rank, a serve replica
actor), but the driver process can host several (its own bookkeeping
ledger plus in-process serve engines), so ledgers register under a
``src`` name and publish counters labelled ``{category, src}``. The
DriverAggregator folds those per-rank counters into fleet totals.
"""

from __future__ import annotations

import threading

import time
from typing import Callable, Dict, Iterator, Optional

from contextlib import contextmanager

GOODPUT_SECONDS_METRIC = "rlt_goodput_seconds_total"
GOODPUT_FRACTION_METRIC = "rlt_goodput_fraction"

# the category whose share defines the goodput fraction
PRODUCTIVE = "productive_compute"

CATEGORIES = (
    "productive_compute",
    "compile",
    "input_wait",
    "collective_wait",
    "checkpoint",
    "elastic_transition",
    "arbitration_transfer",
    "fault_recovery",
    "drain",
    "idle",
)


class GoodputLedger:
    """Classify wall time into categories via explicit transitions.

    Thread-safety: transitions are expected from the owning thread;
    ``snapshot()``/``publish()`` may run from a heartbeat thread and
    take the same lock, so readers never see a torn interval.
    """

    def __init__(
        self,
        src: str = "train",
        clock: Callable[[], float] = time.monotonic,
        category: str = "idle",
    ) -> None:
        self.src = src
        self._clock = clock
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._carried = 0.0  # wall time inherited from a predecessor ledger
        self._started = clock()
        self._current = category
        self._since = self._started

    # -- transitions -----------------------------------------------------

    def enter(self, category: str) -> None:
        """Close the open interval and start accumulating ``category``."""
        now = self._clock()
        with self._lock:
            elapsed = max(0.0, now - self._since)
            if elapsed:
                self._totals[self._current] = (
                    self._totals.get(self._current, 0.0) + elapsed
                )
            self._current = category
            self._since = now

    @contextmanager
    def phase(self, category: str) -> Iterator[None]:
        """Enter ``category`` for the duration of the block, then restore
        whatever category was open before (not necessarily the lexical
        previous one — a nested phase that leaked would otherwise pin the
        ledger)."""
        with self._lock:
            previous = self._current
        self.enter(category)
        try:
            yield
        finally:
            self.enter(previous)

    def adopt(self, other: "GoodputLedger") -> None:
        """Carry a predecessor's totals forward so published counters stay
        monotonic across an in-process restart (engine relaunch)."""
        snap = other.snapshot()
        with self._lock:
            for cat, secs in snap.items():
                self._totals[cat] = self._totals.get(cat, 0.0) + secs
                self._carried += secs

    # -- readers ---------------------------------------------------------

    @property
    def current(self) -> str:
        return self._current

    def snapshot(self, now: Optional[float] = None) -> Dict[str, float]:
        """Per-category seconds including the open interval. Values sum to
        ``wall_s()`` at the same instant (modulo float rounding)."""
        now = self._clock() if now is None else now
        with self._lock:
            out = dict(self._totals)
            open_s = max(0.0, now - self._since)
            if open_s:
                out[self._current] = out.get(self._current, 0.0) + open_s
        return out

    def wall_s(self, now: Optional[float] = None) -> float:
        now = self._clock() if now is None else now
        return self._carried + max(0.0, now - self._started)

    def fraction(self, now: Optional[float] = None) -> float:
        snap = self.snapshot(now)
        total = sum(snap.values())
        return (snap.get(PRODUCTIVE, 0.0) / total) if total > 0 else 0.0

    # -- publication -----------------------------------------------------

    def publish(self, reg) -> None:
        """Set cumulative ``rlt_goodput_seconds_total{category,src}``
        counters on ``reg``. Counters carry absolute totals (the
        aggregator folds them latest-wins, same as every other counter
        riding the heartbeat)."""
        for cat, secs in self.snapshot().items():
            c = reg.counter(GOODPUT_SECONDS_METRIC, category=cat, src=self.src)
            c.value = secs


# -- process-local ledger registry ---------------------------------------

_LEDGERS: Dict[str, GoodputLedger] = {}
_REG_LOCK = threading.Lock()


def new_ledger(src: str = "train", category: str = "idle") -> GoodputLedger:
    """Create (and register) a fresh ledger for ``src``. If a previous
    ledger held the name, its totals are adopted so counters published
    under the same ``src`` never regress."""
    led = GoodputLedger(src=src, category=category)
    with _REG_LOCK:
        prev = _LEDGERS.get(src)
        if prev is not None:
            led.adopt(prev)
        _LEDGERS[src] = led
    return led


def get_ledger(src: str) -> Optional[GoodputLedger]:
    with _REG_LOCK:
        return _LEDGERS.get(src)


def ensure_ledger(src: str, category: str = "idle") -> GoodputLedger:
    """Get-or-create: unlike :func:`new_ledger` an existing ledger is
    returned as-is (no restart/adopt)."""
    with _REG_LOCK:
        led = _LEDGERS.get(src)
    return led if led is not None else new_ledger(src, category=category)


def ledgers() -> Dict[str, GoodputLedger]:
    with _REG_LOCK:
        return dict(_LEDGERS)


def publish_all(reg) -> None:
    """Publish every registered ledger into ``reg`` (called from the
    heartbeat payload collector so goodput rides the existing beat)."""
    for led in ledgers().values():
        led.publish(reg)


def reset() -> None:
    with _REG_LOCK:
        _LEDGERS.clear()


# -- fold helpers (driver side) ------------------------------------------


def fold(per_rank: Dict[object, Dict[str, float]]) -> Dict[str, object]:
    """Fold per-(rank,src) category seconds into the fleet-level summary
    section: total seconds per category, the goodput fraction, and the
    per-rank breakdown (each with its own fraction)."""
    by_category: Dict[str, float] = {}
    ranks: Dict[str, object] = {}
    for key, cats in sorted(per_rank.items(), key=lambda kv: str(kv[0])):
        total = sum(cats.values())
        for cat, secs in cats.items():
            by_category[cat] = by_category.get(cat, 0.0) + secs
        ranks[str(key)] = {
            "seconds": {c: round(s, 3) for c, s in sorted(cats.items())},
            "wall_s": round(total, 3),
            "fraction": round(cats.get(PRODUCTIVE, 0.0) / total, 4)
            if total > 0
            else 0.0,
        }
    total = sum(by_category.values())
    return {
        "by_category": {c: round(s, 3) for c, s in sorted(by_category.items())},
        "total_s": round(total, 3),
        "fraction": round(by_category.get(PRODUCTIVE, 0.0) / total, 4)
        if total > 0
        else 0.0,
        "per_rank": ranks,
    }
