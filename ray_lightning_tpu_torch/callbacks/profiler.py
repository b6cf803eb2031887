"""torch.profiler around a window of training steps
(``ray_lightning_tpu/callbacks/profiler.py``). The trace lands under
``<log_dir>/rank<r>/`` as a ``*.pt.trace.json`` file, which both Chrome's
trace viewer (or Perfetto) and TensorBoard's profiler plugin read."""
from __future__ import annotations

import os
from typing import Optional

import torch

from ray_lightning_tpu_torch.callbacks.base import Callback


class ProfilerCallback(Callback):
    def __init__(self, log_dir: Optional[str] = None, start_step: int = 5,
                 num_steps: int = 3):
        self.log_dir = log_dir
        self.start_step = start_step
        self.num_steps = num_steps
        self._prof: Optional[torch.profiler.profile] = None
        self._rank_suffixed = False

    def setup(self, trainer, module, stage: str) -> None:
        if self.log_dir is None:
            self.log_dir = os.path.join(trainer.default_root_dir, "profile")
        if not self._rank_suffixed:
            # ranks that share a filesystem must not share a trace directory
            rank = getattr(trainer, "global_rank", 0) or 0
            self.log_dir = os.path.join(self.log_dir, f"rank{int(rank)}")
            self._rank_suffixed = True

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.stop()  # writes the trace through on_trace_ready

    def on_train_batch_start(self, trainer, module, batch, batch_idx) -> None:
        if trainer.global_step == self.start_step and self._prof is None:
            os.makedirs(self.log_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if trainer.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.log_dir),
            )
            self._prof.start()

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx) -> None:
        if (self._prof is not None
                and trainer.global_step >= self.start_step + self.num_steps):
            self._stop()

    def on_train_end(self, trainer, module) -> None:
        self._stop()

    def on_exception(self, trainer, module, err) -> None:
        # a failure inside the window must not leave the tracer running
        self._stop()

    def teardown(self, trainer, module, stage: str) -> None:
        self._stop()
