"""The trial process's session (``ray_lightning_tpu/tune/session.py``, a
copy): set while a trainable runs in its trial actor. The launcher asks
:func:`is_session_enabled` before it makes the tune queue, and the Tune
callbacks' callables report through :func:`get_trial_session`."""
from __future__ import annotations

from typing import Optional


class TrialSession:
    """Lives in the trial process while a trial function runs."""

    def __init__(self, trial_id: str, trial_dir: str, report_fn, checkpoint_fn):
        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self._report_fn = report_fn
        self._checkpoint_fn = checkpoint_fn
        self.iteration = 0

    def report(self, **metrics) -> None:
        self.iteration += 1
        self._report_fn(dict(metrics), self.iteration)

    def checkpoint(self, data: bytes, name: str) -> str:
        return self._checkpoint_fn(data, name, self.iteration)


_trial_session: Optional[TrialSession] = None


def init_trial_session(session: TrialSession) -> None:
    global _trial_session
    _trial_session = session


def clear_trial_session() -> None:
    global _trial_session
    _trial_session = None


def is_session_enabled() -> bool:
    return _trial_session is not None


def get_trial_session() -> TrialSession:
    if _trial_session is None:
        raise RuntimeError("no tune trial session is active in this process")
    return _trial_session


def report(**metrics) -> None:
    """tune.report parity: record one result row for the running trial."""
    get_trial_session().report(**metrics)
