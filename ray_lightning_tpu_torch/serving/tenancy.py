"""Multi-tenant QoS (``ray_lightning_tpu/serving/tenancy.py``): tenant
identity, admission quotas and fair-share weights, pure host logic.

- :class:`TenantSpec` — one tenant's contract: its class (``guaranteed``,
  ``standard`` or ``best_effort``), its deficit-round-robin ``weight`` (its
  share of admissions under saturation) and an optional token-bucket quota
  (``rate`` requests/s sustained, ``burst`` above it).
- :class:`TokenBucket` — ``burst`` tokens refilled at ``rate``/s; an
  admission takes one, an empty bucket refuses. The clock is injectable.
- :class:`TenantRegistry` — the installed tenants: the scheduler reads
  their DRR weights, the shed policy their classes, the engine charges
  their quotas. An unknown name registers itself with the default
  contract (``standard``, weight 1, no quota): tenants churn, and an
  unknown one degrades to standard service rather than an error.

A quota refusal is its own disposition (``quota_rejected``, raised as
:class:`QuotaExceeded`), never a shed: the tenant exceeded its contract.
The shed order (``resilience.ShedPolicy``): ``guaranteed`` is never shed;
``standard`` and classless traffic shed by the priority rule;
``best_effort`` sheds first, at any priority, at the lower watermark.

With no registry installed nothing of this module runs, and the engine
serves one FIFO as before.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

from ray_lightning_tpu_torch.serving.scheduler import RequestQueueFull

__all__ = [
    "BEST_EFFORT",
    "GUARANTEED",
    "STANDARD",
    "TENANT_CLASSES",
    "QuotaExceeded",
    "TenantRegistry",
    "TenantSpec",
    "TokenBucket",
    "parse_tenant_specs",
]

GUARANTEED = "guaranteed"
STANDARD = "standard"
BEST_EFFORT = "best_effort"
TENANT_CLASSES = (GUARANTEED, STANDARD, BEST_EFFORT)


class QuotaExceeded(RequestQueueFull):
    """Refused by the tenant's token-bucket admission quota.

    Subclasses :class:`~.scheduler.RequestQueueFull` so callers with
    back-pressure handling (retry with backoff) keep working, but the
    journal disposition is ``quota_rejected`` — never ``shed``: the
    tenant exceeded its contract, the system did not fail it.
    """


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's QoS contract.

    ``weight`` is the DRR fair-share weight (relative admissions under
    saturation). ``rate``/``burst`` arm the token-bucket quota
    (``rate=None`` = unlimited; ``burst`` defaults to ``max(1, rate)``).
    ``ttft_slo_ms`` is the tenant's TTFT objective, kept for the SLO
    monitor (not ported yet: the port reads no environment for it).
    """

    name: str
    tenant_class: str = STANDARD
    weight: float = 1.0
    rate: Optional[float] = None  # sustained requests/second; None = no quota
    burst: Optional[float] = None  # bucket capacity; None -> max(1, rate)
    ttft_slo_ms: Optional[float] = None

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.tenant_class not in TENANT_CLASSES:
            raise ValueError(
                f"tenant {self.name!r}: class must be one of "
                f"{TENANT_CLASSES}, got {self.tenant_class!r}"
            )
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got {self.weight}"
            )
        if self.rate is not None and self.rate < 0:
            raise ValueError(
                f"tenant {self.name!r}: rate must be >= 0, got {self.rate}"
            )
        if self.burst is not None and self.burst < 1:
            raise ValueError(
                f"tenant {self.name!r}: burst must be >= 1, got {self.burst}"
            )

    def resolved_burst(self) -> float:
        if self.burst is not None:
            return float(self.burst)
        if self.rate is None:
            return 1.0
        return max(1.0, float(self.rate))


class TokenBucket:
    """Classic token bucket: ``capacity`` tokens, refilled at ``rate``/s.

    Starts full (a fresh tenant may burst immediately). ``try_acquire``
    refuses — never blocks — so the front door turns an empty bucket
    into an immediate :class:`QuotaExceeded` instead of queueing work
    the contract does not cover. Thread-safe: the fleet front door and
    engine submitters race on it.
    """

    def __init__(
        self,
        rate: float,
        capacity: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate < 0:
            raise ValueError(f"rate must be >= 0, got {rate}")
        self.rate = float(rate)
        self.capacity = float(capacity if capacity is not None else max(1.0, rate))
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        self._clock = clock
        self._tokens = self.capacity
        self._last = clock()
        self._lock = threading.Lock()
        self.acquired_total = 0
        self.refused_total = 0

    def _refill(self, now: float) -> None:
        elapsed = max(0.0, now - self._last)
        self._last = now
        self._tokens = min(self.capacity, self._tokens + elapsed * self.rate)

    def tokens(self, now: Optional[float] = None) -> float:
        """Current token count (after refill) — test/introspection view."""
        with self._lock:
            self._refill(self._clock() if now is None else now)
            return self._tokens

    def try_acquire(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        with self._lock:
            self._refill(self._clock() if now is None else now)
            if self._tokens >= n:
                self._tokens -= n
                self.acquired_total += 1
                return True
            self.refused_total += 1
            return False


class TenantRegistry:
    """The installed tenant set: specs, quota buckets, class lookups.

    One registry instance is shared by every layer that makes a
    tenant-aware decision (scheduler DRR, shed policy, quota front
    door, per-tenant SLOs); installing it is the single switch that
    turns multi-tenant QoS on. ``clock`` is injectable and threads into
    every bucket, so quota conformance tests can script time.
    """

    def __init__(
        self,
        specs: Iterable[TenantSpec] = (),
        clock: Callable[[], float] = time.monotonic,
    ):
        self._clock = clock
        self._lock = threading.Lock()
        self._specs: Dict[str, TenantSpec] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self.quota_rejected: Dict[str, int] = {}
        self.admitted: Dict[str, int] = {}
        for spec in specs:
            self.register(spec)

    def register(self, spec: TenantSpec) -> None:
        with self._lock:
            self._specs[spec.name] = spec
            if spec.rate is not None:
                self._buckets[spec.name] = TokenBucket(
                    spec.rate, spec.resolved_burst(), clock=self._clock
                )
            else:
                self._buckets.pop(spec.name, None)

    @staticmethod
    def default_spec(name: str) -> TenantSpec:
        """The contract an unknown tenant degrades to: ``standard``
        class, weight 1, no quota."""
        return TenantSpec(name=name)

    def spec(self, name: str) -> TenantSpec:
        """Spec for ``name``, auto-registering unknown tenants with the
        default contract (tenants churn; unknown != error)."""
        with self._lock:
            spec = self._specs.get(name)
            if spec is None:
                spec = self.default_spec(name)
                self._specs[name] = spec
            return spec

    def names(self) -> List[str]:
        with self._lock:
            return list(self._specs)

    def tenant_class(self, name: Optional[str]) -> Optional[str]:
        if name is None:
            return None
        return self.spec(name).tenant_class

    def weight(self, name: Optional[str]) -> float:
        if name is None:
            return 1.0
        return float(self.spec(name).weight)

    def admit(self, name: Optional[str], now: Optional[float] = None) -> bool:
        """Charge one request against ``name``'s quota. ``True`` when
        the tenant has no quota or the bucket had a token; classless
        (``None``) traffic is never quota-checked."""
        if name is None:
            return True
        self.spec(name)  # auto-register
        with self._lock:
            bucket = self._buckets.get(name)
        if bucket is None or bucket.try_acquire(now=now):
            with self._lock:
                self.admitted[name] = self.admitted.get(name, 0) + 1
            return True
        with self._lock:
            self.quota_rejected[name] = self.quota_rejected.get(name, 0) + 1
        return False

    def bucket(self, name: str) -> Optional[TokenBucket]:
        with self._lock:
            return self._buckets.get(name)


def parse_tenant_specs(text: str) -> List[TenantSpec]:
    """Parse the CLI tenant grammar: comma-separated
    ``name:class[:weight[:rate[:burst]]]`` items, e.g.
    ``gold:guaranteed:4:50,free:best_effort:1:5:10``."""
    specs: List[TenantSpec] = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"tenant spec {raw!r}: expected name:class[:weight[:rate"
                f"[:burst]]]"
            )
        name, cls = parts[0], parts[1]
        weight = float(parts[2]) if len(parts) > 2 and parts[2] else 1.0
        rate = float(parts[3]) if len(parts) > 3 and parts[3] else None
        burst = float(parts[4]) if len(parts) > 4 and parts[4] else None
        specs.append(
            TenantSpec(
                name=name, tenant_class=cls, weight=weight,
                rate=rate, burst=burst,
            )
        )
    if not specs:
        raise ValueError("tenant spec string parsed to zero tenants")
    return specs
