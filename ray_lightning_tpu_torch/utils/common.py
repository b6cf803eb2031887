"""Shared helpers (``ray_lightning_tpu/utils/common.py``): the warning
logger and the optional-dependency placeholder. The port has one process
and one rank, so a warning is always emitted."""
from __future__ import annotations

import logging

logger = logging.getLogger("ray_lightning_tpu_torch")


def rank_zero_warn(msg: str, *args) -> None:
    logger.warning(msg, *args)


class Unavailable:
    """Placeholder for an optional integration that is not installed:
    importing the name succeeds, using it raises with the reason."""

    _reason = "this optional dependency is not available in this environment"

    def __init__(self, *args, **kwargs):
        raise RuntimeError(f"Cannot instantiate: {self._reason}")

    def __getattr__(self, item):
        raise RuntimeError(f"Cannot use attribute {item!r}: {self._reason}")
