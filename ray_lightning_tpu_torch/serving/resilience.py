"""Load shedding at the engine's front door (``ray_lightning_tpu/serving/
resilience.py::RequestShed`` and ``ShedPolicy``, without tenant classes).
The request journal, circuit breakers and the fleet are not ported yet."""
from __future__ import annotations

from dataclasses import dataclass

from ray_lightning_tpu_torch.serving.scheduler import RequestQueueFull


class RequestShed(RequestQueueFull):
    """Rejected by the load-shed policy (queue watermark).
    Subclasses :class:`RequestQueueFull` so back-pressure handling applies
    unchanged."""


@dataclass
class ShedPolicy:
    """When to reject low-priority work: priority 0 is never shed;
    priority >= 1 is rejected once the queue crosses ``queue_watermark`` of
    its capacity, which keeps headroom for the traffic that must not fail.
    (The JAX package also sheds on SLO burn; the port has no SLO monitor
    yet.)"""

    queue_watermark: float = 0.9

    def should_shed(self, priority: int, queue_depth: int,
                    max_queue: int) -> bool:
        if priority < 1:
            return False
        return queue_depth >= self.queue_watermark * max_queue
