"""Callback hook surface (``ray_lightning_tpu/callbacks/base.py``): epoch and
batch boundaries, validation and test ends, checkpoint state round trip, fit
start/end."""
from __future__ import annotations

from typing import Any, Dict


class Callback:
    # checkpoint-WRITING callbacks set this True; the Trainer dispatches
    # them after all other callbacks (PTL semantics) so the state they
    # snapshot — EarlyStopping patience, user counters — reflects the hook
    # having already run everywhere else
    saves_checkpoints = False

    @property
    def state_key(self) -> str:
        return type(self).__name__

    def setup(self, trainer, module, stage: str) -> None: ...

    def teardown(self, trainer, module, stage: str) -> None: ...

    def on_fit_start(self, trainer, module) -> None: ...

    def on_fit_end(self, trainer, module) -> None: ...

    def on_sanity_check_start(self, trainer, module) -> None: ...

    def on_sanity_check_end(self, trainer, module) -> None: ...

    def on_train_start(self, trainer, module) -> None: ...

    def on_train_end(self, trainer, module) -> None: ...

    def on_train_epoch_start(self, trainer, module) -> None: ...

    def on_train_epoch_end(self, trainer, module) -> None: ...

    def on_train_batch_start(self, trainer, module, batch, batch_idx) -> None: ...

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx) -> None: ...

    def on_validation_start(self, trainer, module) -> None: ...

    def on_validation_end(self, trainer, module) -> None: ...

    def on_validation_epoch_start(self, trainer, module) -> None: ...

    def on_validation_epoch_end(self, trainer, module) -> None: ...

    def on_validation_batch_end(self, trainer, module, outputs, batch, batch_idx) -> None: ...

    def on_test_start(self, trainer, module) -> None: ...

    def on_test_end(self, trainer, module) -> None: ...

    def on_test_epoch_end(self, trainer, module) -> None: ...

    def on_test_batch_end(self, trainer, module, outputs, batch, batch_idx) -> None: ...

    def on_predict_start(self, trainer, module) -> None: ...

    def on_predict_end(self, trainer, module) -> None: ...

    def on_exception(self, trainer, module, err: BaseException) -> None: ...

    # checkpoint state round trip (callback state survives a resume)
    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state: Dict[str, Any]) -> None: ...


def _enumerate_state_keys(callbacks):
    """Stable, instance-unique keys: second and later callbacks of the same
    class get '#<n>' suffixes (same enumeration on save and restore)."""
    counts: Dict[str, int] = {}
    for cb in callbacks:
        key = cb.state_key
        n = counts.get(key, 0)
        counts[key] = n + 1
        yield (f"{key}#{n}" if n else key), cb


def collect_callback_states(callbacks) -> Dict[str, Any]:
    states: Dict[str, Any] = {}
    for key, cb in _enumerate_state_keys(callbacks):
        sd = cb.state_dict()
        if sd:
            states[key] = sd
    return states


def restore_callback_states(callbacks, states: Dict[str, Any]) -> None:
    for key, cb in _enumerate_state_keys(callbacks):
        if key in states and states[key]:
            cb.load_state_dict(states[key])
