"""Telemetry on the port's training path against the JAX package's.

- The same beats, verdicts and requests fed to both packages'
  ``DriverAggregator`` (one fake clock patched into each module's ``time``)
  give equal ``summary()`` and byte-identical files, in full and in
  flight-record-only mode.
- A port Ray fit of the tiny Llama on the CPU (1 and 2 gloo workers) with
  ``telemetry=True`` leaves the files, span names and metric series that a
  JAX fit of the same model leaves, less the series of modules the port
  does not have yet (named below).
- ``hang_timeout`` alone leaves the flight record (``events.jsonl``, a
  crash's incident bundle) and no ``trace.json``, as in JAX.
- The in-process fit writes its own run directory, as JAX's does.
- ``cli top``, ``goodput`` and ``incidents`` print the same text in both
  packages on the same run directory.

Every test resets both packages' process-global telemetry state."""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import time

import pytest
import torch

from ray_lightning_tpu import observability as jobs
from ray_lightning_tpu.cli import main as jmain
from ray_lightning_tpu.observability import aggregator as jagg
from ray_lightning_tpu.observability import metrics as jmetrics
from ray_lightning_tpu.observability import slo as jslo
from ray_lightning_tpu_torch import observability as pobs
from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.observability import slo as pslo
from ray_lightning_tpu_torch.cli import main as pmain
from ray_lightning_tpu_torch.core import Trainer
from ray_lightning_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModule,
    SyntheticLMDataModule,
)
from ray_lightning_tpu_torch.observability import aggregator as pagg
from ray_lightning_tpu_torch.observability import metrics as pmetrics
from ray_lightning_tpu_torch.runtime import faults
from ray_lightning_tpu_torch.strategies import RayStrategy
from ray_lightning_tpu_torch.strategies.base import SingleDeviceStrategy

# series the JAX fit publishes from modules not ported yet: the XLA
# compile cache (ROADMAP.md item 9h); the profiler's cost series and the
# summary's profile section (item 9c) are the port's too
JAX_ONLY_SERIES = {"rlt_compile_ms", "rlt_compile_cache_misses_total",
                   "rlt_compile_cache_hits_total"}
JAX_ONLY_SUMMARY = set()
FILES = ["events.jsonl", "metrics.json", "metrics.prom", "summary.json",
         "trace.json"]


@pytest.fixture(autouse=True)
def reset_both(monkeypatch):
    for prefix in ("RLT_", "TORCHRT_"):
        for name in ("TELEMETRY", "TELEMETRY_DIR", "PROM_PORT", "FAULT",
                     "FAULT_FUSE", "INCIDENT_COOLDOWN_S"):
            monkeypatch.delenv(prefix + name, raising=False)
    jobs.reset()
    pobs.reset()
    yield
    jobs.reset()
    pobs.reset()


class FakeTime:
    """The ``time`` module as an aggregator sees it, at a settable now."""

    def __init__(self, now):
        self.now = float(now)
        self.localtime = time.localtime
        self.strftime = time.strftime
        self.sleep = time.sleep

    def time(self):
        return self.now


# --------------------------------------------------------------------- #
# the aggregators on the same beats
# --------------------------------------------------------------------- #
def _payload(metrics, rank, i):
    reg = metrics.MetricsRegistry()
    h = reg.histogram("rlt_step_time_seconds")
    for k in range(4):
        h.observe(0.1 + 0.01 * ((rank * 7 + i * 3 + k) % 5) + 0.2 * (rank == 2))
    reg.gauge("rlt_samples_per_sec").set(100.0 + rank + i)
    reg.gauge("rlt_train_mfu").set(0.25 + 0.01 * rank)
    reg.gauge(metrics.HBM_IN_USE_METRIC, device="cuda:0").set(1e9 + rank)
    reg.gauge(metrics.HBM_PEAK_METRIC, device="cuda:0").set(2e9 + rank)
    reg.counter("rlt_input_starved_seconds").inc(0.01 * i)
    reg.histogram("rlt_serve_itl_seconds").observe(0.02)
    for cat, secs in (("productive_compute", 10.0 * i), ("compile", 3.0),
                      ("input_wait", 0.5 * i)):
        reg.counter("rlt_goodput_seconds_total", category=cat,
                    src="train").value = secs
    return {
        "m": reg.snapshot(delta=True),
        "t": [("X", "step", 5000.0 + i + 0.1 * rank, 0.1, i, None),
              ("i", "checkpoint/new_best", 5000.5 + i, 0.0, i, {"score": 1.5})],
        "r": [{"request_id": f"r{rank}-{i}", "ts": 5000.0 + i,
               "start_ts": 4999.5 + i, "finish_reason": "eos",
               "queue_wait_s": 0.01, "prefill_s": 0.1, "ttft_s": 0.2}],
    }


def _drive(agg_mod, metrics, run_dir, full, monkeypatch):
    clock = FakeTime(5000.0)
    monkeypatch.setattr(agg_mod, "time", clock)
    agg = agg_mod.DriverAggregator(run_dir, num_workers=3, full=full)
    agg.incidents._clock = clock.time
    agg.record_event("run_started", fn="_fit_impl", workers=3)
    agg.set_elastic(world_size=3, membership_epoch=0)
    for i in range(1, 25):
        clock.now += 0.75
        for rank in range(3 if i <= 12 else 2):
            agg.on_beat(rank, i, clock.now - 0.01 * rank,
                        _payload(metrics, rank, i) if i % 3 else None,
                        recv_wall=clock.now + 0.002)
            agg.heartbeat_age(rank, 0.25 * rank)
        if i == 8:
            agg.record_event("straggler", rank=2, silent_s=1.5, last_step=8,
                             label="worker group (3 ranks)")
        if i == 12:
            agg.record_event("hang", ranks=[2], last_steps={2: 12},
                             hang_timeout=10.0, label="worker group")
            agg.drop_rank(2)
            agg.set_elastic(world_size=2, membership_epoch=1, shrinks=1,
                            recovery_s=1.25)
    agg.record_event("run_finished", fn="_fit_impl")
    summary = agg.summary()
    out = agg.finalize(driver_events=[
        ("X", "boot/setup_workers", 4999.0, 0.5, None, {"attempt": 0})])
    agg.record_event("crash", attempt=0, fatal=True, error="ActorError: x")
    files = {}
    for root, _, names in os.walk(run_dir):
        for name in names:
            path = os.path.join(root, name)
            with open(path) as f:
                files[os.path.relpath(path, run_dir)] = f.read().replace(
                    run_dir, "<run>")
    return out is not None, summary, files


@pytest.mark.parametrize("full", [True, False], ids=["full", "flight_record"])
def test_same_beats_give_equal_summaries_and_files(full, tmp_path, monkeypatch):
    j = _drive(jagg, jmetrics, str(tmp_path / "jax"), full, monkeypatch)
    p = _drive(pagg, pmetrics, str(tmp_path / "torch"), full, monkeypatch)
    assert p[0] == j[0] == full
    assert p[1] == j[1]
    assert sorted(p[2]) == sorted(j[2])
    for name in j[2]:
        assert p[2][name] == j[2][name], name
    names = set(p[2])
    assert ("trace.json" in names) == full
    assert any(n.startswith("incidents/") and n.endswith("incident.json")
               for n in names)
    if full:
        assert {"summary.json", "metrics.prom", "lineage.jsonl",
                "requests.jsonl"} <= names
        assert p[1]["elastic"]["shrinks"] == 1 and "2" not in p[1]["per_rank"]


def test_an_slo_monitor_is_refused_naming_its_item(tmp_path):
    """The aggregator takes an SLO monitor: its burn rates land in the
    summary's ``slo`` section, as the JAX aggregator's do from the same
    (empty) monitor."""
    summaries = []
    for agg, slo in ((pagg, pslo), (jagg, jslo)):
        run_dir = str(tmp_path / agg.__name__)
        a = agg.DriverAggregator(run_dir, num_workers=1,
                                 slo_monitor=slo.SLOMonitor())
        a.finalize()
        with open(os.path.join(run_dir, "summary.json")) as fh:
            summaries.append(json.load(fh)["slo"])
    assert summaries[0] == summaries[1]
    assert summaries[0]["ttft_p95"] == {"fast": 0.0, "slow": 0.0,
                                        "breached": 0.0}


def test_telemetry_dir_resolution(tmp_path, monkeypatch):
    root = str(tmp_path / "root")
    assert pagg.telemetry_dir(root) == jagg.telemetry_dir(root)
    monkeypatch.setenv("RLT_TELEMETRY_DIR", str(tmp_path / "jax"))
    assert pagg.telemetry_dir(root) == os.path.join(root, "telemetry")
    monkeypatch.setenv("TORCHRT_TELEMETRY_DIR", str(tmp_path / "port"))
    assert pagg.telemetry_dir(root) == str(tmp_path / "port")


# --------------------------------------------------------------------- #
# the CLI on one run directory
# --------------------------------------------------------------------- #
def _run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["top"], ["goodput"], ["goodput", "--json"], ["incidents"],
    ["incidents", "--json"], ["incidents", "--show", "{bundle}"],
    ["incidents", "--show", "{bundle}", "--json"],
    ["incidents", "--show", "nope"]],
    ids=["top", "goodput", "goodput_json", "incidents", "incidents_json",
         "show", "show_json", "show_missing"])
def test_cli_renders_a_run_directory_as_jax_s(argv, tmp_path, monkeypatch):
    """Each package renders the run directory that the other wrote: one
    made by the JAX aggregator, one by the port's, on the same beats."""
    _drive(jagg, jmetrics, str(tmp_path / "jax"), True, monkeypatch)
    _drive(pagg, pmetrics, str(tmp_path / "torch"), True, monkeypatch)
    for run in ("jax", "torch"):
        run_dir = str(tmp_path / run)
        bundle = sorted(os.listdir(os.path.join(run_dir, "incidents")))[0]
        args = [a.format(bundle=bundle) for a in argv] + ["--dir", run_dir]
        monkeypatch.setattr(jagg, "time", FakeTime(5030.0))
        monkeypatch.setattr(pagg, "time", FakeTime(5030.0))
        j = _run_cli(jmain, args)
        p = _run_cli(pmain, args)
        assert p == j
        assert p[0] == (1 if "nope" in argv else 0)


def test_cli_on_an_empty_directory(tmp_path):
    for sub in (["goodput"], ["incidents"]):
        args = sub + ["--dir", str(tmp_path)]
        rc, text = _run_cli(pmain, args)
        assert rc == 1 and text
        assert rc == _run_cli(jmain, args)[0]
    rc, text = _run_cli(pmain, ["top", "--dir", str(tmp_path)])
    assert rc == 1 and "TORCHRT_TELEMETRY=1" in text


# --------------------------------------------------------------------- #
# fits
# --------------------------------------------------------------------- #
def _cfg():
    return dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                               max_seq=32)


def _port_fit(root, strategy, steps=4):
    cfg = _cfg()
    trainer = Trainer(device="cpu", strategy=strategy, max_steps=steps,
                      seed=0, default_root_dir=str(root), logger=False,
                      enable_progress_bar=False, limit_val_batches=1)
    try:
        trainer.fit(LlamaModule(cfg), datamodule=SyntheticLMDataModule(
            cfg, batch_size=4, n_train=16, n_val=4))
    finally:
        rt.shutdown()
    return trainer


def _jax_fit(root, strategy, steps=4):
    import jax.numpy as jnp
    import ray_lightning_tpu as rlt
    from ray_lightning_tpu.models.llama import LlamaConfig as JConfig
    from ray_lightning_tpu.models.llama import LlamaModule as JModule
    from ray_lightning_tpu.models.llama import (
        SyntheticLMDataModule as JData,
    )

    cfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32, max_seq=32)
    trainer = rlt.Trainer(strategy=strategy, max_steps=steps, seed=0,
                          default_root_dir=str(root), logger=False,
                          enable_progress_bar=False, limit_val_batches=1)
    trainer.fit(JModule(cfg), datamodule=JData(cfg, batch_size=4, n_train=16,
                                               n_val=4))
    return trainer


def _names(run_dir):
    """What a run directory holds, by name: files, (track, span or event)
    pairs, metric families and the flight record's event kinds."""
    trace = json.load(open(os.path.join(run_dir, "trace.json")))
    tracks = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
              if e["name"] == "process_name"}
    spans = {(tracks[e["pid"]], e["name"]) for e in trace["traceEvents"]
             if e["ph"] in ("X", "i")}
    prom = open(os.path.join(run_dir, "metrics.prom")).read()
    families = {line.split()[2] for line in prom.splitlines()
                if line.startswith("# TYPE")}
    metrics = json.load(open(os.path.join(run_dir, "metrics.json")))
    hists = {(name, key) for name, per in metrics["per_rank_histograms"].items()
             for key in per}
    events = [json.loads(line)["event"] for line in
              open(os.path.join(run_dir, "events.jsonl"))]
    return {"files": sorted(os.listdir(run_dir)), "spans": spans,
            "families": families - JAX_ONLY_SERIES,
            "histograms": {h for h in hists if h[0] not in JAX_ONLY_SERIES},
            "events": events,
            "summary_keys": sorted(set(metrics["summary"]) - JAX_ONLY_SUMMARY),
            "rank_keys": {r: sorted(v) for r, v in
                          metrics["summary"]["per_rank"].items()}}


@pytest.mark.parametrize("world", [1, 2])
def test_ray_fit_leaves_the_jax_fit_s_names(world, tmp_path):
    import ray_lightning_tpu as rlt

    _jax_fit(tmp_path / "jax", rlt.RayStrategy(
        num_workers=world, platform="cpu", telemetry=True))
    jobs.reset()
    trainer = _port_fit(tmp_path / "torch", RayStrategy(
        num_workers=world, telemetry=True, timeout_s=120))
    want = _names(str(tmp_path / "jax" / "telemetry"))
    got = _names(str(tmp_path / "torch" / "telemetry"))
    assert got == want
    assert ("rank %d" % (world - 1), "compile") in got["spans"]
    run_dir = str(tmp_path / "torch" / "telemetry")
    metrics = json.load(open(os.path.join(run_dir, "metrics.json")))
    for r in range(world):
        hist = metrics["per_rank_histograms"]["rlt_step_time_seconds"]
        assert hist['{rank="%d"}' % r]["count"] == trainer.global_step - 1
    stats = metrics["summary"]["cluster"]
    assert stats["steps_min"] == stats["steps_max"] == trainer.global_step
    # the beats rode the ring, each within a slot
    traffic = trainer.strategy.launcher.heartbeat_traffic
    assert traffic and not any(spilled for _, spilled in traffic)


def test_hang_timeout_alone_leaves_the_flight_record(tmp_path, monkeypatch):
    """Telemetry off, ``hang_timeout`` on: ``events.jsonl`` with the run's
    start and end, a crash that the relaunch took, its incident bundle, and
    no trace or metrics files."""
    monkeypatch.setenv(faults.FAULT_ENV, "rank0:crash@step2")
    monkeypatch.setenv(faults.FUSE_ENV, str(tmp_path / "fuses"))
    trainer = _port_fit(tmp_path, RayStrategy(
        num_workers=1, hang_timeout=30.0, max_failures=1, timeout_s=120))
    assert trainer.global_step == 4
    run_dir = str(tmp_path / "telemetry")
    assert sorted(os.listdir(run_dir)) == ["events.jsonl", "incidents"]
    events = [json.loads(line) for line in
              open(os.path.join(run_dir, "events.jsonl"))]
    assert [e["event"] for e in events] == [
        "run_started", "run_finished", "crash", "run_started", "run_finished"]
    crash = events[2]
    assert crash["attempt"] == 1 and crash["max_failures"] == 1
    assert crash["error"].startswith("ActorError: ")
    (bundle,) = os.listdir(os.path.join(run_dir, "incidents"))
    assert bundle.endswith("_crash")
    assert not pobs.enabled()


def test_a_launch_keeps_no_trainer_alive(tmp_path):
    """An elastic group's stage has an aggregator (``hang_timeout``) whose
    incident sources reach the controller and, through its restore scan,
    the trainer: once ``fit`` returns, the launcher holds none of them, so
    the trainer and the weights it brought back are freed with it."""
    import gc
    import weakref

    strategy = RayStrategy(num_workers=2, elastic=True, hang_timeout=30.0,
                           timeout_s=120)
    trainer = _port_fit(tmp_path, strategy, steps=2)
    assert sorted(os.listdir(tmp_path / "telemetry")) == ["events.jsonl"]
    ref = weakref.ref(trainer)
    del trainer
    gc.collect()
    assert ref() is None and strategy.launcher._aggregator is None


def test_in_process_fit_writes_its_own_run_directory(tmp_path, monkeypatch):
    """No launcher: the trainer dumps its ring and registry at the end of
    fit, as JAX's does (one track, no flight record)."""
    import ray_lightning_tpu as rlt

    monkeypatch.setenv("RLT_TELEMETRY", "1")
    _jax_fit(tmp_path / "jax", rlt.SingleDeviceStrategy())
    jobs.reset()
    monkeypatch.setenv("TORCHRT_TELEMETRY", "1")
    trainer = _port_fit(tmp_path / "torch", SingleDeviceStrategy())
    run_dir = str(tmp_path / "torch" / "telemetry")
    files = sorted(os.listdir(run_dir))
    assert files == sorted(os.listdir(str(tmp_path / "jax" / "telemetry")))
    assert files == [f for f in FILES if f != "events.jsonl"]
    open(os.path.join(run_dir, "events.jsonl"), "w").close()
    open(os.path.join(str(tmp_path / "jax" / "telemetry"), "events.jsonl"),
         "w").close()
    got = _names(run_dir)
    want = _names(str(tmp_path / "jax" / "telemetry"))
    assert got == want
    hist = json.load(open(os.path.join(run_dir, "metrics.json")))[
        "per_rank_histograms"]["rlt_step_time_seconds"]['{rank="0"}']
    assert hist["count"] == trainer.global_step - 1
