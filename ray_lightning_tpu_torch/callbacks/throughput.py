"""Step time, throughput and MFU (``ray_lightning_tpu/callbacks/
throughput.py``): per-step time, samples/s, tokens/s per card and
model-FLOPs utilisation against the card's peak bf16 tensor-core rate.

The JAX callback also publishes its numbers to the flight recorder's
registry (``_publish_telemetry``); that waits for the port's observability
slice (ROADMAP.md, queue 1 item 9) and is left out here.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.callbacks.base import Callback
from ray_lightning_tpu_torch.utils.common import rank_zero_warn
from ray_lightning_tpu_torch.utils.tree import tree_leaves

# dense bf16 tensor-core TFLOP/s per card (NVIDIA's data sheets, at the full
# power limit), matched against the lower-cased device name
_PEAK_TFLOPS = {
    "h100": 989.0,
}
_DEFAULT_PEAK_TFLOPS = 989.0
_CPU_ESTIMATE_TFLOPS = 0.1  # so CPU runs give finite MFU numbers


def peak_tflops_for(device_name: str) -> float:
    """The peak bf16 TFLOP/s of a card by its name (as
    ``torch.cuda.get_device_name`` gives it); a card missing from the table
    falls back to the H100's with a warning."""
    kind = device_name.lower()
    for key, tflops in _PEAK_TFLOPS.items():
        if key in kind:
            return tflops
    rank_zero_warn(
        "unknown accelerator %r: assuming %.0f peak TFLOP/s for MFU; pass "
        "ThroughputMonitor(peak_tflops=...) with the card's real peak",
        device_name,
        _DEFAULT_PEAK_TFLOPS,
    )
    return _DEFAULT_PEAK_TFLOPS


def detect_peak_tflops(device: torch.device) -> float:
    """Peak bf16 TFLOP/s of ``device``: the card's from the table, or a
    nominal estimate on the CPU."""
    if device.type == "cpu":
        return _CPU_ESTIMATE_TFLOPS
    return peak_tflops_for(torch.cuda.get_device_name(device))


class ThroughputMonitor(Callback):
    def __init__(self, flops_per_sample: Optional[float] = None,
                 tokens_per_sample: Optional[int] = None, window: int = 20,
                 log_every_n_steps: int = 0, sync_every: int = 4,
                 peak_tflops: Optional[float] = None):
        """``peak_tflops`` overrides the card's peak from the table (the
        JAX callback reads it from an environment variable). The device
        runs behind the host, so a time stamp per step would time the
        launches; waiting on every step would stall the host. So every
        ``sync_every`` steps the host waits on a CUDA event recorded after
        the step's work, and the interval's mean step time is kept."""
        if peak_tflops is not None and peak_tflops <= 0:
            raise ValueError(f"peak_tflops must be > 0, got {peak_tflops}")
        self.flops_per_sample = flops_per_sample
        self.tokens_per_sample = tokens_per_sample
        self.window = window
        self.log_every_n_steps = log_every_n_steps
        self.sync_every = max(1, sync_every)
        self.peak_tflops = peak_tflops
        self._times: list = []  # per-interval mean step times
        self._last_sync_t: Optional[float] = None
        self._steps_since_sync = 0
        self._batch_size: Optional[int] = None

    def setup(self, trainer, module, stage: str) -> None:
        # adopt what the module advertises (LlamaModule does) unless given
        def advertised(name):
            value = getattr(module, name, None)
            return value() if callable(value) else value

        if self.flops_per_sample is None:
            flops = advertised("flops_per_sample")
            if flops:
                self.flops_per_sample = float(flops)
        if self.tokens_per_sample is None:
            tokens = advertised("tokens_per_sample")
            if tokens:
                self.tokens_per_sample = int(tokens)
        if self.peak_tflops is None:
            self.peak_tflops = detect_peak_tflops(trainer.device)

    @staticmethod
    def _infer_batch_size(batch) -> int:
        leaves = [x for x in tree_leaves(batch) if hasattr(x, "shape")]
        return int(leaves[0].shape[0]) if leaves else 0

    def on_train_batch_start(self, trainer, module, batch, batch_idx) -> None:
        self._batch_size = self._infer_batch_size(batch)

    def _record_interval(self, now: float) -> None:
        if self._last_sync_t is not None and self._steps_since_sync:
            self._times.append((now - self._last_sync_t) / self._steps_since_sync)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last_sync_t = now
        self._steps_since_sync = 0

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx) -> None:
        self._steps_since_sync += 1
        if self._steps_since_sync < self.sync_every:
            return
        if trainer.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        self._record_interval(time.perf_counter())
        if (self.log_every_n_steps
                and trainer.global_step % self.log_every_n_steps == 0
                and trainer.logger is not None):
            trainer.logger.log_metrics(self.summary(trainer),
                                       step=trainer.global_step)

    def summary(self, trainer) -> dict:
        if not self._times or not self._batch_size:
            return {}
        # _record_interval never measures from t=0, so the first step's
        # start-up costs are outside every kept interval
        step_time = float(np.mean(self._times))
        n_cards = max(1, trainer.world_size)
        global_batch = self._batch_size * n_cards
        out = {"step_time_s": step_time,
               "samples_per_sec": global_batch / step_time}
        if self.tokens_per_sample:
            out["tokens_per_sec_per_chip"] = (
                global_batch * self.tokens_per_sample / step_time / n_cards)
        if self.flops_per_sample:
            peak = self.peak_tflops or detect_peak_tflops(trainer.device)
            achieved = global_batch * self.flops_per_sample / step_time / n_cards
            out["train_mfu"] = achieved / (peak * 1e12)
        return out

    def on_train_end(self, trainer, module) -> None:
        for k, v in self.summary(trainer).items():
            trainer.callback_metrics[k] = np.asarray(v)
