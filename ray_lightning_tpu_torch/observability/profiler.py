"""Fleet-wide performance profiler: cost accounting, coordinated capture and
step-time attribution (``ray_lightning_tpu/observability/profiler.py``).

Three layers, all riding the existing telemetry plumbing:

1. **Cost accounting.** PyTorch has no compiled program to ask, and the
   port's kernels launch through ``ctypes``, out of the dispatcher's sight.
   So a program is counted by running it on ``device="meta"`` tensors of
   the same shapes under a :class:`CostCounter` (a ``TorchDispatchMode``):
   every aten op adds the FLOPs of the matmul class
   (``torch.utils.flop_counter``'s formulas) and its bytes, each input read
   once and each output written once (a gather reads only the rows it
   takes, a scatter writes only the rows it puts, a view moves nothing);
   every kernel wrapper given meta tensors records its own kernel's FLOPs
   and bytes (``kernels.record_cost``, from the cost function beside the
   kernel) and returns empty outputs of the right shapes, so the plain
   versions' ops are never counted. Shapes alone decide the counts: they
   are the same on the CPU and on the card, every layer of a stack is
   counted, remat's recompute is counted as it runs, and counting launches
   nothing and touches no tensor on the card. ``roofline`` turns a
   :class:`CostReport` and a measured step time into an MFU figure and a
   compute-versus-bandwidth verdict from the arithmetic intensity against
   the card's balance.

2. **Coordinated fleet capture.** :class:`FleetProfiler` lives in each
   worker's hot loop. The driver (``cli profile --steps N``) writes an
   atomic ``profile_cmd.json`` into the shared telemetry directory naming
   an absolute global step; every rank polls the file (one throttled
   ``os.stat`` an interval) and starts ``torch.profiler`` on that same
   step, so the ranks' traces line up. ``TORCHRT_PROFILE_AT_STEP`` arms
   the same window from the environment. The command file is the JAX
   package's, so a command written by either package arms the other's
   profiler.

3. **Step-time attribution.** Inside a window the profiler synchronises
   the step's CUDA stream (honest device time), splits the mean step into
   compute, collective-wait, host-input and device-transfer estimates from
   the cost report and the card's peak rates, and ships ``capture``,
   ``attribution`` and ``cost`` records to the
   :class:`~.aggregator.DriverAggregator` on the heartbeat payload (the
   ``"p"`` key). ``format_profile_report`` renders the folded summary for
   ``cli profile --report``.

Programs that cannot be traced on meta return ``None`` from
:func:`analyze_program`, as JAX's ``analyze_jitted`` does on any failure: a
program that reads a value back to the host (``.item()``, ``.tolist()``),
or whose shapes depend on the data, such as a MoE layer's capacity
dispatch in training (``parallel/moe.py::moe_ffn``), and a program that
runs a collective or touches a CUDA tensor. The dense Llama
train step and the serving programs of both KV layouts count.

Importing this module starts nothing: ``torch.profiler`` is imported only
when a window opens.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ray_lightning_tpu_torch import kernels as _kernels
from ray_lightning_tpu_torch.utils import fsio
from ray_lightning_tpu_torch.utils.tree import tree_map

from . import metrics as _metrics
from . import trace as _trace

# ------------------------------------------------------------------ #
# knobs / constants
# ------------------------------------------------------------------ #
PROFILE_CMD_FILE = "profile_cmd.json"
PROFILE_DIR = "profile"
PROFILE_AT_STEP_ENV = "TORCHRT_PROFILE_AT_STEP"
PROFILE_STEPS_ENV = "TORCHRT_PROFILE_STEPS"
COST_ANALYSIS_ENV = "TORCHRT_COST_ANALYSIS"
PEAK_GBPS_ENV = "TORCHRT_PEAK_GBPS"
# the knobs a launcher pins into its workers' environment
ENV_KNOBS = (PROFILE_AT_STEP_ENV, PROFILE_STEPS_ENV, COST_ANALYSIS_ENV,
             PEAK_GBPS_ENV)
DEFAULT_PROFILE_STEPS = 3
DEFAULT_LEAD_STEPS = 20
CMD_POLL_INTERVAL_S = 1.0

STEP_FLOPS_METRIC = "rlt_step_flops"
STEP_BYTES_METRIC = "rlt_step_bytes"
COLLECTIVE_BYTES_METRIC = "rlt_collective_bytes_total"
COST_MFU_METRIC = "rlt_cost_mfu"

_metrics.set_help(
    STEP_FLOPS_METRIC,
    "Analytic FLOPs per execution of the program (counted on meta tensors "
    "of its shapes), labeled by program",
)
_metrics.set_help(
    STEP_BYTES_METRIC,
    "Analytic bytes accessed per execution of the program (counted on meta "
    "tensors of its shapes), labeled by program",
)
_metrics.set_help(
    COLLECTIVE_BYTES_METRIC,
    "Bytes moved by collective ops per execution of the program, labeled "
    "by op and program",
)
_metrics.set_help(
    COST_MFU_METRIC,
    "Model FLOPs utilization derived from the counted FLOPs over the "
    "measured step time, labeled by program",
)

# peak HBM bandwidth per card, GB/s, matched against the lower-cased device
# name: NVIDIA's H100 SXM5 data sheet (HBM3, at its 700 W power limit); the
# same spirit as the peak-TFLOP/s table in callbacks/throughput.py
_PEAK_HBM_GBPS = {
    "h100": 3350.0,
}
_DEFAULT_PEAK_GBPS = 3350.0
# a token DDR figure so CPU runs give finite rooflines
_CPU_PEAK_GBPS = 10.0


def _profile_device(device: Any = None) -> torch.device:
    """``device``, or the card when there is one, else the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def detect_peak_bandwidth_gbps(device: Any = None) -> float:
    """Peak HBM bandwidth (GB/s) of ``device`` (default: the card, if any).

    ``TORCHRT_PEAK_GBPS`` overrides; a card missing from the table takes the
    H100's figure, the CPU a token DDR figure."""
    env = os.environ.get(PEAK_GBPS_ENV)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    dev = _profile_device(device)
    if dev.type != "cuda":
        return _CPU_PEAK_GBPS
    try:
        kind = torch.cuda.get_device_name(dev).lower()
    except Exception:
        return _DEFAULT_PEAK_GBPS
    for key, gbps in _PEAK_HBM_GBPS.items():
        if key in kind:
            return gbps
    return _DEFAULT_PEAK_GBPS


def detect_peak_tflops(device: Any = None) -> float:
    """Peak bf16 TFLOP/s of ``device`` (default: the card, if any), from
    ``callbacks/throughput.py``'s table."""
    from ray_lightning_tpu_torch.callbacks.throughput import (
        detect_peak_tflops as _peak,
    )

    return _peak(_profile_device(device))


def cost_analysis_enabled() -> bool:
    """Escape hatch: ``TORCHRT_COST_ANALYSIS=0`` skips the meta trace."""
    return os.environ.get(COST_ANALYSIS_ENV, "1") != "0"


# ------------------------------------------------------------------ #
# cost accounting
# ------------------------------------------------------------------ #
@dataclass
class CostReport:
    """Analytic cost of one execution of a program."""

    program: str
    flops: float
    bytes_accessed: float
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return float(sum(d.get("bytes", 0) for d in self.collectives.values()))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "program": self.program,
            "step_flops": self.flops,
            "step_bytes": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "collectives": {
                op: dict(d) for op, d in sorted(self.collectives.items())
            },
        }


_aten = torch.ops.aten
# ops that move no data: views and aliases, allocations, metadata
_FREE_OPS = frozenset({
    _aten._unsafe_view.default, _aten.detach.default, _aten.alias.default,
    _aten.lift_fresh.default, _aten.empty.memory_format,
    _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
    _aten.resize_.default, _aten.set_.source_Storage_storage_offset,
    _aten._local_scalar_dense.default,
})
# gathers read only the rows they take (the output's bytes) and the indices
_GATHER_OPS = frozenset({
    _aten.index.Tensor, _aten.embedding.default, _aten.index_select.default,
    _aten.gather.default,
})
# scatters read the values and the indices and write only the rows they put
_SCATTER_OPS = frozenset({
    _aten.index_put_.default, _aten.index_put.default,
    _aten._index_put_impl_.default, _aten.index_copy_.default,
    _aten.scatter_.src, _aten.scatter.src, _aten.index_add_.default,
    _aten.scatter_add_.default, _aten.scatter_add.default,
})
# in-place ops that overwrite their first argument without reading it
_OVERWRITE_OPS = frozenset({
    _aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
    _aten.zero_.default, _aten.uniform_.default, _aten.normal_.default,
})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    leaves, _ = tree_flatten(tree)
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def _unique(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    seen, out = set(), []
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of every aten op on meta tensors, and
    every kernel cost a wrapper records (``kernels.record_cost``), while
    active. An op on host tensors alone (a rope table built on the host
    before its copy to the device) is host work and is not counted; an op
    on a CUDA tensor raises, so a count never runs device work."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        # kernel name -> {"launches", "flops", "bytes"} of the recorded costs
        self.kernels: Dict[str, Dict[str, float]] = {}

    def __enter__(self):
        _kernels.COST_SINKS.append(self)
        try:
            return super().__enter__()
        except BaseException:
            _kernels.COST_SINKS.remove(self)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _kernels.COST_SINKS.remove(self)

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += float(flops)
        k["bytes"] += float(nbytes)
        self.flops += float(flops)
        self.bytes += float(nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        inputs = _unique(_tensors((args, kwargs)))
        for t in inputs:
            if t.is_cuda:
                raise RuntimeError(
                    f"CostCounter: {func} got a CUDA tensor of shape "
                    f"{tuple(t.shape)}; a program is counted on meta tensors "
                    "only")
        out = func(*args, **kwargs)
        outputs = _unique(_tensors(out))
        if any(t.is_meta for t in inputs) or any(t.is_meta for t in outputs):
            self._count(func, args, kwargs, inputs, outputs, out)
        return out

    def _count(self, func, args, kwargs, inputs, outputs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        if func in _FREE_OPS or func.is_view:
            return
        if func in _GATHER_OPS:
            # the source comes first, the indices after it
            moved = sum(map(_nbytes, outputs))
            self.bytes += 2 * moved + sum(map(_nbytes, inputs[1:]))
            return
        if func in _SCATTER_OPS and len(inputs) > 1:
            # the destination comes first, the values put last
            self.bytes += (sum(map(_nbytes, inputs[1:]))
                           + _nbytes(inputs[-1]))
            return
        read = inputs[1:] if func in _OVERWRITE_OPS else inputs
        self.bytes += sum(map(_nbytes, read)) + sum(map(_nbytes, outputs))

    def report(self, program: str = "program") -> CostReport:
        return CostReport(program=program, flops=self.flops,
                          bytes_accessed=self.bytes)


def count_program(fn: Callable[..., Any], *args: Any,
                  program: str = "program") -> CostReport:
    """Run ``fn(*args)`` under a :class:`CostCounter` and report its cost.
    ``args`` hold meta tensors (``to_meta``); raises where the program cannot
    run on them."""
    with CostCounter() as counter:
        fn(*args)
    return counter.report(program)


def analyze_program(fn: Callable[..., Any], *args: Any,
                    program: str = "program") -> Optional[CostReport]:
    """:func:`count_program`, or ``None`` when the program cannot be traced
    on meta tensors (the module docstring names which)."""
    try:
        return count_program(fn, *args, program=program)
    except Exception:
        return None


def to_meta(tree: Any, requires_grad: bool = False) -> Any:
    """The tree with every tensor leaf replaced by a meta tensor of its
    shape and dtype (floating leaves that required grad keep requiring it
    when ``requires_grad``); other leaves as they are. Allocates nothing on
    any device."""
    def convert(x):
        if not isinstance(x, torch.Tensor):
            return x
        m = torch.empty(x.shape, dtype=x.dtype, device="meta")
        if requires_grad and x.requires_grad:
            m.requires_grad_()
        return m

    return tree_map(convert, tree)


def roofline(
    report: CostReport,
    step_time_s: Optional[float] = None,
    peak_tflops: Optional[float] = None,
    peak_gbps: Optional[float] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """Roofline placement of a cost report.

    The analytic verdict compares arithmetic intensity (FLOPs a byte) with
    the card's balance (peak FLOP/s over peak byte/s); with a measured
    ``step_time_s`` it also reports MFU, the achieved bandwidth, and which
    ceiling better explains the measured time. Peaks default to
    ``device``'s (the card, if any)."""
    if peak_tflops is None:
        peak_tflops = detect_peak_tflops(device)
    if peak_gbps is None:
        peak_gbps = detect_peak_bandwidth_gbps(device)
    peak_flops_s = peak_tflops * 1e12
    peak_bytes_s = peak_gbps * 1e9
    intensity = (
        report.flops / report.bytes_accessed if report.bytes_accessed else float("inf")
    )
    balance = peak_flops_s / peak_bytes_s
    out: Dict[str, Any] = {
        "arithmetic_intensity": round(intensity, 4),
        "machine_balance": round(balance, 4),
        "verdict": "compute-bound" if intensity >= balance else "bandwidth-bound",
        "peak_tflops_assumed": peak_tflops,
        "peak_gbps_assumed": peak_gbps,
    }
    if step_time_s and step_time_s > 0:
        achieved_flops_s = report.flops / step_time_s
        achieved_bytes_s = report.bytes_accessed / step_time_s
        mfu = achieved_flops_s / peak_flops_s
        bw_util = achieved_bytes_s / peak_bytes_s
        out["step_time_s"] = round(step_time_s, 6)
        out["mfu"] = round(mfu, 6)
        out["achieved_tflops"] = round(achieved_flops_s / 1e12, 4)
        out["bandwidth_util"] = round(bw_util, 6)
        out["achieved_gbps"] = round(achieved_bytes_s / 1e9, 4)
        # which ceiling the measured run leaned on
        out["measured_bound"] = "compute" if mfu >= bw_util else "bandwidth"
    return out


def publish_cost_report(
    reg: Any, report: CostReport, step_time_s: Optional[float] = None,
    peak_tflops: Optional[float] = None, device: Any = None,
) -> None:
    """Publish a cost report to a metrics registry (latest wins)."""
    reg.gauge(STEP_FLOPS_METRIC, program=report.program).set(report.flops)
    reg.gauge(STEP_BYTES_METRIC, program=report.program).set(
        report.bytes_accessed
    )
    for op, d in report.collectives.items():
        c = reg.counter(COLLECTIVE_BYTES_METRIC, op=op, program=report.program)
        c.value = float(d.get("bytes", 0))
    if step_time_s and step_time_s > 0:
        if peak_tflops is None:
            peak_tflops = detect_peak_tflops(device)
        mfu = report.flops / step_time_s / (peak_tflops * 1e12)
        reg.gauge(COST_MFU_METRIC, program=report.program).set(round(mfu, 6))


# ------------------------------------------------------------------ #
# record queue: profiler -> heartbeat payload ("p" key)
# ------------------------------------------------------------------ #
_PENDING: List[dict] = []
_PENDING_CAP = 256


def push_record(rec: dict) -> None:
    """Queue a profile record for the next heartbeat payload."""
    _PENDING.append(rec)
    if len(_PENDING) > _PENDING_CAP:
        del _PENDING[: len(_PENDING) - _PENDING_CAP]


def drain_pending() -> List[dict]:
    out = list(_PENDING)
    _PENDING.clear()
    return out


def reset_pending() -> None:
    _PENDING.clear()


# ------------------------------------------------------------------ #
# driver side: the command file
# ------------------------------------------------------------------ #
_CMD_SEQ = 0


def write_profile_command(
    run_dir: str,
    num_steps: int = DEFAULT_PROFILE_STEPS,
    start_step: Optional[int] = None,
    note: Optional[str] = None,
) -> Dict[str, Any]:
    """Atomically write ``profile_cmd.json`` into the telemetry directory.

    Every rank polls this file and opens a capture window at ``start_step``
    (an absolute global step: every rank shares the step sequence, which is
    what makes the capture coordinated)."""
    global _CMD_SEQ
    os.makedirs(run_dir, exist_ok=True)
    _CMD_SEQ += 1
    cmd: Dict[str, Any] = {
        "id": f"{os.getpid():x}-{int(time.time() * 1000):x}-{_CMD_SEQ}",
        "num_steps": int(num_steps),
        "ts": time.time(),
    }
    if start_step is not None:
        cmd["start_step"] = int(start_step)
    if note:
        cmd["note"] = str(note)
    path = os.path.join(run_dir, PROFILE_CMD_FILE)
    fsio.atomic_write_json(path, cmd)
    return cmd


def read_profile_command(run_dir: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(run_dir, PROFILE_CMD_FILE)) as f:
            cmd = json.load(f)
    except (OSError, ValueError):
        return None
    return cmd if isinstance(cmd, dict) else None


# the torch.profiler session of the open window: (profile, its directory)
_SESSION: List[Any] = [None]


def _start_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` session (CPU activity, and CUDA when there
    is a card) whose trace :func:`_stop_trace` writes into ``log_dir``. An
    indirection, so that tests can replace the backend."""
    import torch.profiler as _tp

    activities = [_tp.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(_tp.ProfilerActivity.CUDA)
    session = _tp.profile(activities=activities)
    session.start()
    _SESSION[0] = (session, log_dir)


def _stop_trace() -> None:
    """Stop the open session and write its Chrome trace as
    ``<log_dir>/<host>_<pid>.pt.trace.json`` (what Perfetto and TensorBoard's
    profiler plugin read)."""
    held, _SESSION[0] = _SESSION[0], None
    if held is None:
        return
    session, log_dir = held
    session.stop()
    name = f"{os.uname().nodename}_{os.getpid()}.pt.trace.json"
    session.export_chrome_trace(os.path.join(log_dir, name))


def _batch_bytes(batch: Any) -> int:
    """Host-to-device payload of one batch (the leaves' bytes)."""
    try:
        leaves, _ = tree_flatten(batch)
        return int(sum(
            _nbytes(x) if isinstance(x, torch.Tensor)
            else int(getattr(x, "nbytes", 0))
            for x in leaves))
    except Exception:
        return 0


def _synchronize(sync: Any) -> None:
    """Wait for the step's work: the current stream of the device of the
    first CUDA tensor in ``sync`` (the step's outputs); CPU work is already
    done."""
    for t in _tensors(sync):
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
            return


# ------------------------------------------------------------------ #
# worker side: FleetProfiler
# ------------------------------------------------------------------ #
class FleetProfiler:
    """Per-worker coordinated capture, cost accounting and attribution.

    Lives next to the trainer's hot loop; the loop pays one attribute check
    a step when no window is armed (``before_step``'s throttled poll,
    ``after_step``'s deque append). Never raises into training."""

    def __init__(
        self,
        run_dir: str,
        rank: int = 0,
        recorder: Optional[Any] = None,
        poll_interval: float = CMD_POLL_INTERVAL_S,
        environ: Optional[Any] = None,
        device: Any = None,
    ) -> None:
        env = os.environ if environ is None else environ
        self.run_dir = run_dir
        self.rank = int(rank)
        self.device = _profile_device(device)
        self._recorder = recorder
        self._cmd_path = os.path.join(run_dir, PROFILE_CMD_FILE)
        self._poll_interval = float(poll_interval)
        self._next_poll = 0.0
        self._applied_id: Optional[str] = None
        self._armed: Optional[Dict[str, Any]] = None
        self._window: Optional[Dict[str, Any]] = None
        self._reports: Dict[str, CostReport] = {}
        self._step_times: deque = deque(maxlen=64)
        self._mfu_published = False
        at_step = env.get(PROFILE_AT_STEP_ENV)
        if at_step:
            try:
                self._armed = {
                    "id": "env",
                    "start": int(at_step),
                    "steps": max(1, int(env.get(PROFILE_STEPS_ENV)
                                        or DEFAULT_PROFILE_STEPS)),
                }
            except ValueError:
                pass

    # -------------------------------------------------------------- #
    # cost accounting hook (call once, at the first dispatch)
    # -------------------------------------------------------------- #
    def analyze(
        self, program: str, fn: Callable[..., Any], args: Sequence[Any],
        collectives: Optional[Dict[str, Dict[str, float]]] = None,
    ) -> Optional[CostReport]:
        """One-time cost count of a program on meta tensors
        (:func:`analyze_program`), with the ``collectives`` the caller
        reckons for it; publishes the gauges and ships a ``cost`` record.
        Never raises."""
        if not cost_analysis_enabled() or program in self._reports:
            return self._reports.get(program)
        try:
            rep = analyze_program(fn, *args, program=program)
        except Exception:
            rep = None
        if rep is None:
            return None
        for op, d in (collectives or {}).items():
            rep.collectives[op] = dict(d)
        self._reports[program] = rep
        try:
            reg = _metrics.get_registry() if _trace.enabled() else None
            if reg is not None:
                publish_cost_report(reg, rep, device=self.device)
            rec = {
                "kind": "cost",
                "rank": self.rank,
                "ts": time.time(),
            }
            rec.update(rep.to_dict())
            rec["roofline"] = roofline(rep, device=self.device)
            push_record(rec)
        except Exception:
            pass
        return rep

    # -------------------------------------------------------------- #
    # hot-loop hooks
    # -------------------------------------------------------------- #
    def _poll(self, step: int) -> None:
        now = time.monotonic()
        if now < self._next_poll:
            return
        self._next_poll = now + self._poll_interval
        try:
            os.stat(self._cmd_path)
        except OSError:
            return
        cmd = read_profile_command(self.run_dir)
        if cmd is None or cmd.get("id") == self._applied_id:
            return
        self._applied_id = cmd.get("id")
        try:
            steps = max(1, int(cmd.get("num_steps", DEFAULT_PROFILE_STEPS)))
            start = cmd.get("start_step")
            # a command with no start step means "as soon as possible"
            start = int(start) if start is not None else step + 1
        except (TypeError, ValueError):
            return
        self._armed = {"id": self._applied_id, "start": start, "steps": steps}

    def before_step(self, step: int, batch: Any = None) -> None:
        """Poll for commands and open the capture window when the armed
        global step arrives (or has already passed)."""
        self._poll(step)
        armed = self._armed
        if armed is not None and self._window is None and step >= armed["start"]:
            self._begin_window(step, armed, batch)

    def _begin_window(
        self, step: int, armed: Dict[str, Any], batch: Any
    ) -> None:
        self._armed = None
        trace_dir = os.path.join(self.run_dir, PROFILE_DIR, f"rank{self.rank}")
        active = False
        try:
            os.makedirs(trace_dir, exist_ok=True)
            _start_trace(trace_dir)
            active = True
        except Exception:
            pass
        self._window = {
            "id": armed["id"],
            "start_step": armed["start"],
            "actual_start": step,
            "stop_after": step + armed["steps"] - 1,
            "trace_dir": trace_dir,
            "samples": [],
            "batch_bytes": _batch_bytes(batch),
            "starved0": None,
            "active": active,
        }
        if self._recorder is not None:
            self._recorder.add_event(
                "profile/start", step=step, args={"trace_dir": trace_dir}
            )

    def after_step(
        self,
        step: int,
        duration_s: float,
        sync: Any = None,
        starved_s: float = 0.0,
    ) -> None:
        """Record one step. Inside a window this waits for ``sync`` (the
        step's outputs: their CUDA stream, for honest device time), emits
        the attribution spans, and closes the window at its last step."""
        w = self._window
        if w is None:
            self._step_times.append(duration_s)
            if not self._mfu_published and len(self._step_times) >= 4:
                self._publish_measured()
            return
        if sync is not None:
            t0 = time.perf_counter()
            try:
                _synchronize(sync)
            except Exception:
                pass
            duration_s += time.perf_counter() - t0
        self._step_times.append(duration_s)
        if w["starved0"] is None:
            w["starved0"] = starved_s - 0.0
        w["samples"].append(duration_s)
        self._emit_attr_spans(step, duration_s)
        if step >= w["stop_after"]:
            self._end_window(starved_s)

    def _train_report(self):
        """The training step's cost report under whichever program name the
        trainer counted it as ("train_step", or "zero_train_step" under
        ZeRO)."""
        rep = self._reports.get("train_step")
        if rep is not None:
            return rep
        for program, rep in self._reports.items():
            if program.endswith("train_step"):
                return rep
        return None

    def _emit_attr_spans(self, step: int, duration_s: float) -> None:
        """A step's breakdown as sub-spans on an "attribution" track."""
        rec = self._recorder
        rep = self._train_report()
        if rec is None or rep is None or duration_s <= 0:
            return
        try:
            peak_flops_s = detect_peak_tflops(self.device) * 1e12
            peak_bytes_s = detect_peak_bandwidth_gbps(self.device) * 1e9
            compute_s = min(rep.flops / peak_flops_s, duration_s)
            collective_s = min(
                rep.collective_bytes / peak_bytes_s, duration_s - compute_s
            )
            wall = time.time() - duration_s
            rec.add_span(
                "attr/compute", wall, compute_s, step=step,
                args={_trace.TRACK_ARG: "attribution"},
            )
            if collective_s > 0:
                rec.add_span(
                    "attr/collective", wall + compute_s, collective_s,
                    step=step, args={_trace.TRACK_ARG: "attribution"},
                )
            other = duration_s - compute_s - collective_s
            if other > 0:
                rec.add_span(
                    "attr/other", wall + compute_s + collective_s, other,
                    step=step, args={_trace.TRACK_ARG: "attribution"},
                )
        except Exception:
            pass

    def attribution(
        self,
        samples: Sequence[float],
        starved_delta_s: float,
        batch_bytes: int,
    ) -> Dict[str, Any]:
        """Split the mean captured step into attributed components."""
        n = max(1, len(samples))
        mean = sum(samples) / n
        out: Dict[str, Any] = {"steps": len(samples), "step_time_s": round(mean, 6)}
        try:
            peak_flops_s = detect_peak_tflops(self.device) * 1e12
            peak_bytes_s = detect_peak_bandwidth_gbps(self.device) * 1e9
        except Exception:
            return out
        rep = self._train_report()
        compute_s = rep.flops / peak_flops_s if rep else 0.0
        collective_s = rep.collective_bytes / peak_bytes_s if rep else 0.0
        transfer_s = batch_bytes / peak_bytes_s
        host_s = max(0.0, starved_delta_s) / n
        attributed = compute_s + collective_s + transfer_s + host_s
        out.update(
            compute_s=round(compute_s, 6),
            collective_s=round(collective_s, 6),
            device_transfer_s=round(transfer_s, 6),
            host_input_s=round(host_s, 6),
            unattributed_s=round(max(0.0, mean - attributed), 6),
        )
        if rep is not None and rep.collectives:
            # the wait a collective op accounts for: under ZeRO the
            # all-gather's and the reduce-scatter's seconds apart
            out["collective_breakdown"] = {
                op: round(info.get("bytes", 0) / peak_bytes_s, 6)
                for op, info in sorted(rep.collectives.items())
            }
            out["program"] = rep.program
        return out

    def _publish_measured(self) -> None:
        """Re-emit the cost records with a measured MFU once step times
        exist."""
        self._mfu_published = True
        if not self._reports or not self._step_times:
            return
        times = sorted(self._step_times)
        median = times[len(times) // 2]
        try:
            reg = _metrics.get_registry() if _trace.enabled() else None
            for program, rep in self._reports.items():
                if reg is not None:
                    publish_cost_report(reg, rep, step_time_s=median,
                                        device=self.device)
                rec = {"kind": "cost", "rank": self.rank, "ts": time.time()}
                rec.update(rep.to_dict())
                rec["roofline"] = roofline(rep, step_time_s=median,
                                           device=self.device)
                push_record(rec)
        except Exception:
            pass

    def _end_window(self, starved_s: float) -> None:
        w = self._window
        if w is None:
            return
        self._window = None
        if w["active"]:
            try:
                _stop_trace()
            except Exception:
                pass
        samples = w["samples"]
        now = time.time()
        push_record(
            {
                "kind": "capture",
                "rank": self.rank,
                "window": w["id"],
                "start_step": w["start_step"],
                "actual_start": w["actual_start"],
                "num_steps": len(samples),
                "trace_dir": w["trace_dir"],
                "ts": now,
            }
        )
        starved_delta = (
            starved_s - w["starved0"] if w["starved0"] is not None else 0.0
        )
        attr = {
            "kind": "attribution",
            "rank": self.rank,
            "window": w["id"],
            "ts": now,
        }
        attr.update(self.attribution(samples, starved_delta, w["batch_bytes"]))
        push_record(attr)
        self._mfu_published = False
        self._publish_measured()
        if self._recorder is not None:
            self._recorder.add_event(
                "profile/stop", step=w["actual_start"] + len(samples) - 1
            )

    def close(self) -> None:
        """Stop an open window (the fit ending, or its exception path)."""
        if self._window is not None:
            try:
                self._end_window(0.0)
            except Exception:
                self._window = None


# ------------------------------------------------------------------ #
# report rendering (cli profile --report)
# ------------------------------------------------------------------ #
def _fmt_num(v: float) -> str:
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.0f}"


def format_profile_report(summary: Optional[Dict[str, Any]]) -> str:
    """Render the ``profile`` section of summary.json as a set of tables
    (the JAX package's text, line for line)."""
    prof = (summary or {}).get("profile")
    if not prof:
        return (
            "no profile data in summary.json — run with telemetry enabled "
            "and arm a window (cli profile --steps N, or "
            "TORCHRT_PROFILE_AT_STEP)"
        )
    lines: List[str] = []
    cost = prof.get("cost") or {}
    if cost:
        lines.append("cost accounting (per program execution):")
        hdr = f"  {'program':<16} {'flops':>9} {'bytes':>9} {'coll.bytes':>10} {'mfu':>8}  verdict"
        lines.append(hdr)
        for program in sorted(cost):
            rec = cost[program]
            rl = rec.get("roofline") or {}
            mfu = rl.get("mfu")
            lines.append(
                f"  {program:<16} {_fmt_num(rec.get('step_flops', 0)):>9} "
                f"{_fmt_num(rec.get('step_bytes', 0)):>9} "
                f"{_fmt_num(rec.get('collective_bytes', 0)):>10} "
                f"{(f'{mfu:.4f}' if mfu is not None else '-'):>8}  "
                f"{rl.get('verdict', '-')}"
            )
    captures = prof.get("captures") or []
    if captures:
        lines.append("")
        lines.append("captures:")
        lines.append(f"  {'rank':>4} {'start':>6} {'actual':>6} {'steps':>5}  trace_dir")
        for rec in captures:
            lines.append(
                f"  {rec.get('rank', '?'):>4} {rec.get('start_step', '?'):>6} "
                f"{rec.get('actual_start', '?'):>6} {rec.get('num_steps', '?'):>5}  "
                f"{rec.get('trace_dir', '')}"
            )
    attr = prof.get("attribution") or {}
    if attr:
        lines.append("")
        lines.append("step-time attribution (mean over captured steps):")
        lines.append(
            f"  {'rank':>4} {'step_ms':>8} {'compute':>8} {'collect':>8} "
            f"{'h2d':>8} {'input':>8} {'other':>8}"
        )

        def pct(rec: Dict[str, Any], key: str) -> str:
            total = rec.get("step_time_s") or 0
            if not total:
                return "-"
            return f"{100.0 * rec.get(key, 0) / total:.1f}%"

        for rank in sorted(attr, key=str):
            rec = attr[rank]
            lines.append(
                f"  {rank:>4} {1000.0 * rec.get('step_time_s', 0):>8.2f} "
                f"{pct(rec, 'compute_s'):>8} {pct(rec, 'collective_s'):>8} "
                f"{pct(rec, 'device_transfer_s'):>8} "
                f"{pct(rec, 'host_input_s'):>8} {pct(rec, 'unattributed_s'):>8}"
            )
    return "\n".join(lines) if lines else "profile section is empty"
