"""The profiler (ray_lightning_tpu_torch/observability/profiler.py) against
the JAX package's (ray_lightning_tpu/observability/profiler.py) on the CPU.

- The same ``CostReport`` numbers and explicit peaks give the same
  ``roofline``, the same series from ``publish_cost_report`` and the same
  ``format_profile_report`` text.
- A ``profile_cmd.json`` written by either package arms the other's
  ``FleetProfiler``; the window scripts (the environment, a command with
  dedup, a late command, ``close()`` mid-window, a never-armed profiler)
  give both packages the same trace calls and records.
- ``collect_beat_payload`` carries ``"p"`` with and without a recorder, and
  ``reset()`` clears it, as in JAX; the same records fed to both
  aggregators give equal ``profile`` sections and local dumps, and
  ``drop_rank`` evicts them in both.
- The port's counts: exact on a tiny matmul (JAX's within its own test's
  bounds), each kernel's cost function against a hand formula at two
  shapes, and the serving programs and the train step at
  ``LlamaConfig.tiny()`` in fp32 linear in ``n_layers`` and equal to a
  closed form. JAX's counts of a scanned layer stack are pinned as the
  reference behaviour the port does not copy. Counting changes no engine
  state and launches nothing.
- End to end: an in-process fit with a window armed at step 2 writes the
  ``profile`` section JAX's does and a ``torch.profiler`` trace; a 2-rank
  gloo Ray fit armed at step 3 captures on both ranks at step 3; ``cli
  profile`` and ``--report`` print the same text in both packages.

Every test resets both packages' process-global telemetry state."""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import time

import numpy as np
import pytest
import torch

from ray_lightning_tpu import observability as jobs
from ray_lightning_tpu.cli import main as jmain
from ray_lightning_tpu.observability import aggregator as jagg
from ray_lightning_tpu.observability import metrics as jmetrics
from ray_lightning_tpu.observability import profiler as jprof
from ray_lightning_tpu_torch import kernels
from ray_lightning_tpu_torch import observability as pobs
from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.cli import main as pmain
from ray_lightning_tpu_torch.core import Trainer
from ray_lightning_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModule,
    SyntheticLMDataModule,
    init_params,
)
from ray_lightning_tpu_torch.observability import aggregator as pagg
from ray_lightning_tpu_torch.observability import metrics as pmetrics
from ray_lightning_tpu_torch.observability import profiler as pprof
from ray_lightning_tpu_torch.ops.attention import (
    attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_bwd_dkv_cost,
    flash_bwd_dq_cost,
    flash_fwd_cost,
)
from ray_lightning_tpu_torch.ops.paged_attention import (
    argmax_cost,
    blockwise_argmax,
    paged_decode_attention,
    paged_decode_cost,
)
from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_cost
from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine
from ray_lightning_tpu_torch.strategies import RayStrategy
from ray_lightning_tpu_torch.strategies.base import SingleDeviceStrategy

pytestmark = pytest.mark.profiling

PEAKS = dict(peak_tflops=989.0, peak_gbps=3350.0)


@pytest.fixture(autouse=True)
def reset_both(monkeypatch):
    for prefix in ("RLT_", "TORCHRT_"):
        for name in ("TELEMETRY", "TELEMETRY_DIR", "PROFILE_AT_STEP",
                     "PROFILE_STEPS", "COST_ANALYSIS", "PEAK_GBPS"):
            monkeypatch.delenv(prefix + name, raising=False)
    jobs.reset()
    pobs.reset()
    yield
    jobs.reset()
    pobs.reset()


@pytest.fixture
def fake_traces(monkeypatch):
    """Both packages' trace backends replaced by one call log each."""
    calls = {"jax": [], "port": []}
    for key, mod in (("jax", jprof), ("port", pprof)):
        log = calls[key]
        monkeypatch.setattr(mod, "_start_trace",
                            lambda d, log=log: log.append(("start", d)))
        monkeypatch.setattr(mod, "_stop_trace",
                            lambda log=log: log.append(("stop",)))
    return calls


MODS = {"jax": jprof, "port": pprof}


# --------------------------------------------------------------------- #
# cost reports, rooflines, series, report text
# --------------------------------------------------------------------- #
REPORTS = [
    (1e9, 1e6, {"all-reduce": {"count": 2, "bytes": 4096}}, None),
    (3.2e12, 2.1e10, {}, 0.05),
    (5e8, 4e9, {"all-gather": {"count": 3, "bytes": 1 << 20},
                "reduce-scatter": {"count": 3, "bytes": 1 << 18}}, 0.0125),
]


@pytest.mark.parametrize("flops,nbytes,coll,step", REPORTS,
                         ids=["analytic", "measured", "zero"])
def test_roofline_and_series_match_jax(flops, nbytes, coll, step):
    jr = jprof.CostReport("train_step", flops, nbytes, json.loads(json.dumps(coll)))
    pr = pprof.CostReport("train_step", flops, nbytes, json.loads(json.dumps(coll)))
    assert pr.to_dict() == jr.to_dict()
    assert pr.collective_bytes == jr.collective_bytes
    assert (pprof.roofline(pr, step, **PEAKS)
            == jprof.roofline(jr, step, **PEAKS))
    jreg, preg = jmetrics.MetricsRegistry(), pmetrics.MetricsRegistry()
    jprof.publish_cost_report(jreg, jr, step_time_s=step, peak_tflops=989.0)
    pprof.publish_cost_report(preg, pr, step_time_s=step, peak_tflops=989.0)
    assert preg.snapshot(delta=False) == jreg.snapshot(delta=False)


def _summary(records):
    agg = pagg.DriverAggregator("/nonexistent-run-dir", num_workers=2,
                                full=False)
    for rank, rec in records:
        agg.ingest_profile(rank, rec)
    return agg.summary()


def _records():
    cost = {"kind": "cost", "rank": 0, "program": "train_step",
            "step_flops": 7.3e11, "step_bytes": 2.4e9,
            "collective_bytes": 1048576.0,
            "collectives": {"all-reduce": {"count": 4, "bytes": 1048576}},
            "roofline": {"verdict": "compute-bound", "mfu": 0.2734},
            "ts": 1.0}
    serve = {"kind": "cost", "rank": 0, "program": "serve_decode",
             "step_flops": 1.2e11, "step_bytes": 1.6e10,
             "collective_bytes": 0.0, "collectives": {},
             "roofline": {"verdict": "bandwidth-bound"}, "ts": 1.5}
    caps = [{"kind": "capture", "rank": r, "window": "env", "start_step": 3,
             "actual_start": 3, "num_steps": 2,
             "trace_dir": f"/run/telemetry/profile/rank{r}", "ts": 2.0}
            for r in (0, 1)]
    attrs = [{"kind": "attribution", "rank": r, "window": "env", "steps": 2,
              "step_time_s": 0.3697 + r * 0.01, "compute_s": 0.101,
              "collective_s": 0.0003, "device_transfer_s": 1e-05,
              "host_input_s": 0.002, "unattributed_s": 0.2663, "ts": 2.0}
             for r in (0, 1)]
    return [(0, cost), (0, serve), (0, caps[0]), (1, caps[1]), (0, attrs[0]),
            (1, attrs[1])]


def test_report_text_matches_jax():
    summary = _summary(_records())
    assert set(summary["profile"]) == {"cost", "captures", "attribution"}
    text = pprof.format_profile_report(summary)
    assert text == jprof.format_profile_report(summary)
    assert "serve_decode" in text and "rank1" in text and "0.2734" in text
    # no data: the same sentence, naming each package's own knob
    for empty in (None, {"cluster": {}}):
        assert (pprof.format_profile_report(empty)
                == jprof.format_profile_report(empty).replace(
                    "RLT_", "TORCHRT_"))
    assert (pprof.format_profile_report({"profile": {"x": 1}})
            == jprof.format_profile_report({"profile": {"x": 1}}))


def test_peak_bandwidth_table_and_override(monkeypatch):
    assert pprof.detect_peak_bandwidth_gbps("cpu") == 10.0
    assert pprof._PEAK_HBM_GBPS["h100"] == 3350.0
    monkeypatch.setenv(pprof.PEAK_GBPS_ENV, "1234.5")
    assert pprof.detect_peak_bandwidth_gbps("cpu") == 1234.5
    monkeypatch.setenv(pprof.PEAK_GBPS_ENV, "nope")
    assert pprof.detect_peak_bandwidth_gbps("cpu") == 10.0
    monkeypatch.setenv(pprof.COST_ANALYSIS_ENV, "0")
    assert not pprof.cost_analysis_enabled()
    p = pprof.FleetProfiler("/nonexistent", environ={}, device="cpu")
    assert p.analyze("m", lambda a: a @ a,
                     (torch.empty(4, 4, device="meta"),)) is None


# --------------------------------------------------------------------- #
# the command file and the window
# --------------------------------------------------------------------- #
def _run_steps(p, steps, dt=0.01):
    for step in steps:
        p.before_step(step)
        p.after_step(step, dt)


def _normalized(records, run_dir):
    out = []
    for rec in records:
        rec = {k: v for k, v in rec.items() if k != "ts"}
        if "trace_dir" in rec:
            rec["trace_dir"] = os.path.relpath(rec["trace_dir"], run_dir)
        if rec.get("window") not in (None, "env"):
            rec["window"] = "cmd"
        out.append(rec)
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_command_from_either_package_arms_the_other(writer, tmp_path,
                                                      fake_traces):
    reader = "port" if writer == "jax" else "jax"
    cmd = MODS[writer].write_profile_command(str(tmp_path), num_steps=2,
                                             start_step=3)
    assert MODS[reader].read_profile_command(str(tmp_path)) == cmd
    p = MODS[reader].FleetProfiler(str(tmp_path), rank=1, poll_interval=0.0,
                                   environ={})
    _run_steps(p, range(7))
    assert [c[0] for c in fake_traces[reader]] == ["start", "stop"]
    assert fake_traces[reader][0][1] == str(tmp_path / "profile" / "rank1")
    cap = next(r for r in MODS[reader].drain_pending()
               if r["kind"] == "capture")
    assert (cap["window"], cap["start_step"], cap["actual_start"],
            cap["num_steps"]) == (cmd["id"], 3, 3, 2)


def _window_env(mod, run_dir):
    p = mod.FleetProfiler(run_dir, rank=1, environ={
        mod.PROFILE_AT_STEP_ENV: "3", mod.PROFILE_STEPS_ENV: "2"})
    _run_steps(p, range(7))


def _window_command_dedup(mod, run_dir):
    p = mod.FleetProfiler(run_dir, rank=0, poll_interval=0.0, environ={})
    mod.write_profile_command(run_dir, num_steps=1, start_step=2)
    _run_steps(p, range(5))
    _run_steps(p, range(5, 10))  # the same id does not re-arm


def _window_late(mod, run_dir):
    p = mod.FleetProfiler(run_dir, environ={mod.PROFILE_AT_STEP_ENV: "1"})
    _run_steps(p, range(5, 9))


def _window_asap(mod, run_dir):
    p = mod.FleetProfiler(run_dir, poll_interval=0.0, environ={})
    mod.write_profile_command(run_dir, num_steps=2)  # no start step
    _run_steps(p, range(4, 9))


def _window_close(mod, run_dir):
    p = mod.FleetProfiler(run_dir, environ={mod.PROFILE_AT_STEP_ENV: "0"})
    p.before_step(0)
    p.close()
    p.close()  # idempotent


def _window_never(mod, run_dir):
    p = mod.FleetProfiler(run_dir, environ={}, poll_interval=3600.0)
    _run_steps(p, range(20))


@pytest.mark.parametrize("script", [
    _window_env, _window_command_dedup, _window_late, _window_asap,
    _window_close, _window_never],
    ids=["env", "command_dedup", "late", "asap", "close", "never"])
def test_window_arming_matches_jax(script, tmp_path, fake_traces):
    got = {}
    for key, mod in MODS.items():
        run_dir = str(tmp_path / key)
        script(mod, run_dir)
        calls = [(c[0],) + tuple(os.path.relpath(x, run_dir) for x in c[1:])
                 for c in fake_traces[key]]
        got[key] = (calls, _normalized(mod.drain_pending(), run_dir))
    assert got["port"] == got["jax"]
    calls, records = got["port"]
    if script is _window_never:
        assert calls == [] and records == []
    else:
        assert calls[0] == ("start", os.path.join("profile", calls[0][1]
                                                  .split(os.sep)[-1]))
        assert calls.count(("stop",)) == 1


def test_env_steps_left_empty_take_the_default(tmp_path, fake_traces):
    """A launcher pins an unset knob as an empty string: the window takes
    the default length."""
    p = pprof.FleetProfiler(str(tmp_path), environ={
        pprof.PROFILE_AT_STEP_ENV: "1", pprof.PROFILE_STEPS_ENV: ""})
    _run_steps(p, range(6))
    cap = next(r for r in pprof.drain_pending() if r["kind"] == "capture")
    assert cap["num_steps"] == pprof.DEFAULT_PROFILE_STEPS
    assert pprof.FleetProfiler(str(tmp_path), environ={
        pprof.PROFILE_AT_STEP_ENV: ""})._armed is None


def test_a_window_waits_for_the_step_it_syncs(tmp_path, fake_traces,
                                             monkeypatch):
    """Inside a window, ``after_step`` waits for its ``sync`` (the step's
    outputs) and adds the wait to the step; outside one it waits for
    nothing. On the CPU the outputs are already done."""
    waited = []

    def slow(sync):
        waited.append(sync)
        time.sleep(0.05)

    p = pprof.FleetProfiler(str(tmp_path), environ={
        pprof.PROFILE_AT_STEP_ENV: "0", pprof.PROFILE_STEPS_ENV: "1"})
    pprof._synchronize({"loss": torch.zeros(())})
    monkeypatch.setattr(pprof, "_synchronize", slow)
    logs = {"loss": torch.zeros(())}
    p.before_step(0)
    p.after_step(0, 0.001, sync=logs)
    attr = next(r for r in pprof.drain_pending()
                if r["kind"] == "attribution")
    assert attr["step_time_s"] >= 0.05 and waited == [logs]
    p.after_step(1, 0.001, sync=logs)
    assert p._step_times[-1] == 0.001 and waited == [logs]


# --------------------------------------------------------------------- #
# beats, aggregators, local dumps
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("recorder", [True, False], ids=["recorder", "bare"])
def test_beat_payload_carries_profile_records_as_jax(recorder):
    got = {}
    for key, (obs, mod) in {"jax": (jobs, jprof), "port": (pobs, pprof)}.items():
        if recorder:
            obs.enable()
        mod.push_record({"kind": "capture", "rank": 0})
        first = obs.collect_beat_payload()
        second = obs.collect_beat_payload()
        mod.push_record({"kind": "cost"})
        obs.reset()
        got[key] = (first["p"], sorted(first), second is None or "p" not in second,
                    mod.drain_pending())
    assert got["port"] == got["jax"]
    assert got["port"][0] == [{"kind": "capture", "rank": 0}]
    assert got["port"][3] == []  # reset() dropped the pending record


def test_aggregators_fold_the_same_profile_and_evict_it(tmp_path):
    sections, events = {}, {}
    for key, agg_mod in (("jax", jagg), ("port", pagg)):
        run_dir = str(tmp_path / key)
        agg = agg_mod.DriverAggregator(run_dir, num_workers=2)
        recs = _records()
        # analytic then measured then analytic again: the measured one stays
        agg.on_beat(0, 5, time.time(), payload={"p": [
            dict(recs[0][1], roofline={"verdict": "compute-bound"})]})
        for rank, rec in recs:
            agg.on_beat(rank, 5, time.time(), payload={"p": [rec]})
        agg.ingest_profile(0, dict(recs[0][1], roofline={"verdict": "x"}))
        before = agg.summary()["profile"]
        agg.drop_rank(1)
        after = agg.summary()["profile"]
        agg.finalize()
        sections[key] = (before, after)
        events[key] = [(e["event"], e.get("rank"), e.get("trace_dir"))
                       for e in map(json.loads, open(os.path.join(
                           run_dir, agg_mod.EVENTS_FILE)))
                       if e["event"] in ("profile_capture", "rank_dropped")]
    assert sections["port"] == sections["jax"]
    before, after = sections["port"]
    assert before["cost"]["train_step"]["roofline"]["mfu"] == 0.2734
    assert [c["rank"] for c in before["captures"]] == [0, 1]
    assert [c["rank"] for c in after["captures"]] == [0]
    assert set(after["attribution"]) == {"0"}
    assert events["port"] == events["jax"]
    assert ("profile_capture", 1, "/run/telemetry/profile/rank1") in events["port"]


def test_local_dumps_carry_the_same_profile(tmp_path):
    got = {}
    for key, (obs, agg_mod, metrics) in {
            "jax": (jobs, jagg, jmetrics),
            "port": (pobs, pagg, pmetrics)}.items():
        run_dir = str(tmp_path / key)
        rec = obs.enable()
        agg_mod.write_local_dump(run_dir, rec, metrics.get_registry(),
                                 profile=[r for _, r in _records()])
        obs.reset()
        bare = str(tmp_path / (key + "_bare"))
        agg_mod.write_local_dump(bare, None, None,
                                 profile=[r for _, r in _records()[:1]])
        got[key] = [json.load(open(os.path.join(d, agg_mod.SUMMARY_FILE)))[
            "profile"] for d in (run_dir, bare)]
    assert got["port"] == got["jax"]
    assert got["port"][1]["cost"]["train_step"]["step_flops"] == 7.3e11


# --------------------------------------------------------------------- #
# counts
# --------------------------------------------------------------------- #
def test_tiny_matmul_counts_exactly():
    import jax
    import jax.numpy as jnp

    a = torch.empty(8, 16, device="meta")
    b = torch.empty(16, 32, device="meta")
    rep = pprof.count_program(lambda a, b: a @ b, a, b, program="matmul")
    flops, io_bytes = 2 * 8 * 32 * 16, (8 * 16 + 16 * 32 + 8 * 32) * 4
    assert (rep.program, rep.flops, rep.bytes_accessed) == (
        "matmul", flops, io_bytes)
    assert rep.collectives == {} and rep.to_dict()["collective_bytes"] == 0
    assert pprof.analyze_program(lambda a, b: a @ b, a, b) == dataclasses.replace(
        rep, program="program")
    # the JAX package's count of the same product, within its own bounds
    jrep = jprof.analyze_jitted(jax.jit(lambda a, b: a @ b),
                                jnp.ones((8, 16), jnp.float32),
                                jnp.ones((16, 32), jnp.float32))
    assert flops <= jrep.flops <= 2 * flops
    assert io_bytes <= jrep.bytes_accessed <= 2 * io_bytes


def test_counting_refuses_tensors_on_the_card_and_host_work_is_free():
    a = torch.empty(8, 16, device="meta")
    host = torch.ones(16, 32)
    with pprof.CostCounter() as c:
        (host * 2).sum()  # host-side work: not counted
        a @ torch.empty(16, 32, device="meta")
    assert c.flops == 2 * 8 * 32 * 16
    # a program that fails to run on meta tensors is not counted
    assert pprof.analyze_program(lambda x: x.sum().item(), a) is None
    assert not kernels.COST_SINKS


def _bytes(dtype):
    return torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("shape,dtype", [((8, 4096), torch.bfloat16),
                                         ((3, 5, 64), torch.float32)])
def test_rmsnorm_cost_is_the_hand_formula(shape, dtype):
    n, d = math.prod(shape), shape[-1]
    cost = rmsnorm_cost(shape, dtype)
    assert cost == (4 * n, (2 * n + d) * _bytes(dtype))
    x = torch.empty(shape, dtype=dtype, device="meta")
    with pprof.CostCounter() as c:
        y = rmsnorm(x, torch.empty(d, dtype=dtype, device="meta"))
    assert y.shape == x.shape and y.dtype == dtype and y.is_meta
    assert c.kernels == {"rmsnorm": {"launches": 1, "flops": cost.flops,
                                     "bytes": cost.bytes}}


FLASH_SHAPES = [
    # B, Hq, Hkv, S, hd, dtype, causal, window
    (1, 32, 8, 512, 128, torch.bfloat16, True, None),
    (2, 4, 2, 100, 64, torch.float32, True, 16),
    (2, 4, 4, 64, 32, torch.float32, False, None),
]


@pytest.mark.parametrize("b,hq,hkv,s,hd,dtype,causal,window", FLASH_SHAPES,
                         ids=["causal_bf16", "window_fp32", "full_fp32"])
def test_flash_costs_are_the_hand_formulas(b, hq, hkv, s, hd, dtype, causal,
                                           window):
    if not causal:
        pairs = s * s
    elif window is None:
        pairs = s * (s + 1) // 2
    else:
        pairs = sum(min(t + 1, window) for t in range(s))
    pairs *= b * hq
    size = _bytes(dtype)
    q_bytes, kv_bytes, lse = b * hq * s * hd * size, b * hkv * s * hd * size, b * hq * s * 4
    qs, ks = (b, hq, s, hd), (b, hkv, s, hd)
    fwd = flash_fwd_cost(qs, ks, dtype, causal, window)
    dq = flash_bwd_dq_cost(qs, ks, dtype, causal, window)
    dkv = flash_bwd_dkv_cost(qs, ks, dtype, causal, window)
    assert fwd == (4 * pairs * hd, 2 * q_bytes + 2 * kv_bytes + lse)
    in_bytes = 2 * q_bytes + 2 * kv_bytes + 2 * lse
    assert dq == (6 * pairs * hd, in_bytes + q_bytes)
    assert dkv == (8 * pairs * hd, in_bytes + 2 * kv_bytes)
    # the differentiable op on meta tensors takes the kernels' route: the
    # forward, then both backward kernels, each recording its own cost
    q = torch.empty(qs, dtype=dtype, device="meta", requires_grad=True)
    k = torch.empty(ks, dtype=dtype, device="meta", requires_grad=True)
    v = torch.empty(ks, dtype=dtype, device="meta", requires_grad=True)
    with pprof.CostCounter() as c:
        attention(q, k, v, causal=causal, window=window).sum().backward()
    assert q.grad.shape == qs and k.grad.shape == ks and v.grad.shape == ks
    assert {n: (r["launches"], r["flops"], r["bytes"])
            for n, r in c.kernels.items()} == {
        "flash_fwd": (1, *fwd), "flash_bwd_dq": (1, *dq),
        "flash_bwd_dkv": (1, *dkv)}
    assert flash_attention_bwd_dq is not None and flash_attention_bwd_dkv


@pytest.mark.parametrize("rows,hkv,group,hd,bs,maxb,dtype", [
    (8, 8, 4, 128, 16, 64, torch.bfloat16),
    (3, 2, 7, 64, 4, 5, torch.float32)], ids=["serving", "odd"])
def test_paged_and_argmax_costs_are_the_hand_formulas(rows, hkv, group, hd,
                                                       bs, maxb, dtype):
    q_shape, cache_shape = (rows, hkv, group, hd), (rows * maxb + 1, hkv, bs, hd)
    size = _bytes(dtype)
    pos = np.arange(rows) * 3 + 1
    positions = int((pos + 1).sum())
    entries = int((pos // bs + 1).sum())
    q_bytes = rows * hkv * group * hd * 4
    cost = paged_decode_cost(q_shape, cache_shape, dtype, maxb, pos=pos)
    assert cost == (4 * hkv * group * hd * positions,
                    positions * hkv * hd * 2 * size + 2 * q_bytes
                    + entries * 4 + rows * 4)
    full = rows * maxb * bs
    meta_cost = paged_decode_cost(q_shape, cache_shape, dtype, maxb)
    assert meta_cost == (4 * hkv * group * hd * full,
                         full * hkv * hd * 2 * size + 2 * q_bytes
                         + rows * maxb * 4 + rows * 4)
    vocab = 1000 + rows
    assert argmax_cost((rows, vocab)) == (rows * vocab, rows * vocab * 4 + rows * 4)
    assert argmax_cost((rows, vocab), noisy=True) == (
        2 * rows * vocab, 2 * rows * vocab * 4 + rows * 4)
    meta = dict(device="meta")
    with pprof.CostCounter() as c:
        out = paged_decode_attention(
            torch.empty(q_shape, **meta), torch.empty(cache_shape, dtype=dtype, **meta),
            torch.empty(cache_shape, dtype=dtype, **meta),
            torch.empty((rows, maxb), dtype=torch.int32, **meta),
            torch.empty((rows,), dtype=torch.int32, **meta))
        tok = blockwise_argmax(torch.empty((rows, vocab), **meta),
                               torch.empty((rows, vocab), **meta))
    assert out.shape == q_shape and tok.shape == (rows,)
    assert tok.dtype == torch.int32
    assert c.kernels["paged_decode"] == {"launches": 1, "flops": meta_cost[0],
                                         "bytes": meta_cost[1]}
    assert c.kernels["argmax"]["bytes"] == argmax_cost((rows, vocab), True)[1]
    assert sum(kernels.launch_counts().values()) == 0


def _cfg(n_layers, **kw):
    return dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                               n_layers=n_layers, **kw)


def _layer_flops(cfg):
    """Matmul FLOPs of one layer body for one token."""
    d, hd = cfg.dim, cfg.head_dim
    return 2 * (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                + cfg.n_heads * hd * d + 3 * d * cfg.ffn_dim)


def _engine(cfg, **kw):
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return InferenceEngine(params, cfg, EngineConfig(
        num_slots=2, max_prompt_len=8, max_len=16, block_size=4,
        kv_layout="paged", **kw), device="cpu")


def test_serving_counts_are_linear_in_depth_and_a_closed_form():
    fl = {"serve_prefill": [], "serve_decode": []}
    for L in (1, 2, 4):
        cfg = _cfg(L)
        out = _engine(cfg).cost_summary()
        P, n, d, V = 8, 2, cfg.dim, cfg.vocab_size
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        prefill = L * (P * _layer_flops(cfg)
                       + flash_fwd_cost((1, hq, P, hd), (1, hkv, P, hd),
                                        torch.float32).flops
                       + 2 * rmsnorm_cost((1, P, d), torch.float32).flops)
        decode = (n * (L * _layer_flops(cfg) + 2 * d * V)
                  + L * paged_decode_cost((n, hkv, hq // hkv, hd),
                                          (9, hkv, 4, hd), torch.float32,
                                          4).flops
                  + (2 * L + 1) * rmsnorm_cost((n, 1, d), torch.float32).flops
                  + argmax_cost((n, V)).flops)
        assert out["serve_prefill"]["step_flops"] == prefill
        assert out["serve_decode"]["step_flops"] == decode
        for name in fl:
            fl[name].append((out[name]["step_flops"], out[name]["step_bytes"]))
            assert out[name]["roofline"]["verdict"] in ("compute-bound",
                                                        "bandwidth-bound")
    for name, ((f1, b1), (f2, b2), (f4, b4)) in fl.items():
        assert f4 - f2 == 2 * (f2 - f1) and f2 > f1, name
        assert b4 - b2 == 2 * (b2 - b1) and b2 > b1, name


def _train_count(cfg, **trainer_kw):
    counted = {}

    class Counting(Trainer):
        def _analyze_train_step(self, prof, batch):
            fn, args, coll = self._train_cost_program(batch)
            counted["rep"] = pprof.count_program(fn, *args,
                                                 program=self._train_program())
            counted["coll"] = coll

    trainer = Counting(device="cpu", max_steps=1, seed=0, logger=False,
                       enable_progress_bar=False, limit_val_batches=0,
                       strategy=SingleDeviceStrategy(telemetry=True),
                       **trainer_kw)
    trainer.fit(LlamaModule(cfg, lr=3e-3, warmup_steps=2, total_steps=20),
                datamodule=SyntheticLMDataModule(cfg, batch_size=4, n_train=8,
                                                 n_val=4))
    return counted["rep"], counted["coll"]


def test_train_step_count_is_linear_in_depth_and_a_closed_form(tmp_path):
    flops = []
    for L in (1, 2, 4):
        cfg = _cfg(L, max_seq=32)
        rep, coll = _train_count(cfg, default_root_dir=str(tmp_path / str(L)))
        assert rep.program == "train_step" and coll == {}
        T, d, V = 4 * 32, cfg.dim, cfg.vocab_size
        qs, ks = (4, cfg.n_heads, 32, cfg.head_dim), (4, cfg.n_kv_heads, 32,
                                                      cfg.head_dim)
        # forward and the two products of each backward matmul, the three
        # flash kernels a layer, the forward's 2L + 1 norms (their backward
        # is elementwise)
        want = (3 * T * (L * _layer_flops(cfg) + 2 * d * V)
                + L * sum(f(qs, ks, torch.float32).flops for f in (
                    flash_fwd_cost, flash_bwd_dq_cost, flash_bwd_dkv_cost))
                + (2 * L + 1) * rmsnorm_cost((4, 32, d), torch.float32).flops)
        assert rep.flops == want
        flops.append((rep.flops, rep.bytes_accessed))
    (f1, b1), (f2, b2), (f4, b4) = flops
    assert f4 - f2 == 2 * (f2 - f1)
    assert b4 - b2 == 2 * (b2 - b1)
    # remat recomputes each layer's forward as it runs: its products, its
    # flash forward and its two norms, up to the last tensor the backward
    # needs (torch.utils.checkpoint stops there), so not the last product
    # (w_down), whose output no backward reads
    cfg = _cfg(2, max_seq=32, remat=True)
    rep, _ = _train_count(cfg, default_root_dir=str(tmp_path / "remat"))
    T = 4 * 32
    extra = 2 * (T * (_layer_flops(cfg) - 2 * cfg.dim * cfg.ffn_dim)
                 + flash_fwd_cost((4, 4, 32, 32), (4, 2, 32, 32),
                                  torch.float32).flops
                 + 2 * rmsnorm_cost((4, 32, 128), torch.float32).flops)
    assert rep.flops == f2 + extra


def test_jax_counts_a_scanned_layer_stack_once():
    """The reference behaviour the port does not copy: XLA's cost analysis
    costs the ``lax.scan`` over the layers as one trip, so JAX's counts at 2
    and 4 layers are within 1 % of each other, where the port's double."""
    import jax
    import jax.numpy as jnp

    from ray_lightning_tpu.models.llama import LlamaConfig as JConfig
    from ray_lightning_tpu.models.llama import init_params as jinit
    from ray_lightning_tpu.serving.engine import EngineConfig as JEngineConfig
    from ray_lightning_tpu.serving.engine import InferenceEngine as JEngine

    counts = {}
    for L in (2, 4):
        cfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32, n_layers=L)
        engine = JEngine(jinit(jax.random.key(0), cfg), cfg, JEngineConfig(
            num_slots=2, max_prompt_len=8, max_len=16, kv_layout="paged"))
        counts[L] = {k: v["step_flops"] for k, v in engine.cost_summary().items()}
        port = _engine(_cfg(L)).cost_summary()
        counts[("port", L)] = {k: v["step_flops"] for k, v in port.items()}
    for name in ("serve_prefill", "serve_decode"):
        assert abs(counts[4][name] - counts[2][name]) <= 0.01 * counts[2][name]
        assert counts[("port", 4)][name] > 1.5 * counts[("port", 2)][name]


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_counting_changes_no_engine_state(layout):
    params = init_params(_cfg(2), torch.Generator().manual_seed(0),
                         device="cpu")
    engine = InferenceEngine(params, _cfg(2), EngineConfig(
        num_slots=2, max_prompt_len=8, max_len=16, block_size=4,
        kv_layout=layout), device="cpu")
    comp = engine.submit([5, 9, 5, 9, 1], max_new_tokens=3)
    engine.step()  # a request mid-decode holds a slot and its blocks
    stats = dict(engine.stats)
    cache = {k: v.clone() for k, v in engine.pool.cache.items()}
    pool = engine.pool.stats()
    tables = (engine.pool.block_tables.copy() if layout == "paged" else None)
    params_before = {k: v.clone() for k, v in params.items()
                     if isinstance(v, torch.Tensor)}
    gen = engine.generator.get_state().clone()
    kernels.reset_launch_counts()
    out = engine.cost_summary()
    assert out["serve_prefill"] and out["serve_decode"]
    assert engine.stats == stats and engine.pool.stats() == pool
    assert all(torch.equal(engine.pool.cache[k], v) for k, v in cache.items())
    assert all(torch.equal(params[k], v) for k, v in params_before.items())
    assert torch.equal(engine.generator.get_state(), gen)
    if tables is not None:
        assert np.array_equal(engine.pool.block_tables, tables)
    assert sum(kernels.launch_counts().values()) == 0
    engine.run_until_idle()
    assert comp.done and len(comp.tokens) == 3


def test_serve_cost_published_gauges(capsys):
    pobs.enable()
    engine = _engine(_cfg(1))
    out = engine.cost_summary()
    snap = pobs.registry().snapshot(delta=False)
    gauges = {(name, tuple(sorted(labels.items())) if isinstance(labels, dict)
               else tuple(labels)): value for name, labels, value in snap["gauges"]}
    flops = {k: v for k, v in gauges.items() if k[0] == pprof.STEP_FLOPS_METRIC}
    assert sorted(v for v in flops.values()) == sorted(
        r["step_flops"] for r in out.values())


# --------------------------------------------------------------------- #
# end to end
# --------------------------------------------------------------------- #
def _fit(root, strategy, steps, **kw):
    cfg = _cfg(2, max_seq=32)
    trainer = Trainer(device="cpu", strategy=strategy, max_steps=steps,
                      seed=0, default_root_dir=str(root), logger=False,
                      enable_progress_bar=False, limit_val_batches=1, **kw)
    try:
        trainer.fit(LlamaModule(cfg), datamodule=SyntheticLMDataModule(
            cfg, batch_size=4, n_train=32, n_val=4))
    finally:
        rt.shutdown()
    return trainer


def _keys(profile):
    return {
        "sections": sorted(profile),
        "cost": {p: sorted(r) for p, r in profile["cost"].items()},
        "roofline": {p: sorted(r["roofline"]) for p, r in profile["cost"].items()},
        "captures": [sorted(c) for c in profile["captures"]],
        "attribution": {r: sorted(a) for r, a in profile["attribution"].items()},
    }


def test_inprocess_fit_profile_section_as_jax_s(tmp_path, monkeypatch,
                                                 fake_traces):
    """JAX's ``test_inprocess_fit_profile_section`` on both packages: a
    window armed at step 2 for one step; the port's trace is a real
    ``torch.profiler`` one."""
    import ray_lightning_tpu as rlt
    from tests.utils import BoringModel, get_trainer

    monkeypatch.setenv(jprof.PROFILE_AT_STEP_ENV, "2")
    monkeypatch.setenv(jprof.PROFILE_STEPS_ENV, "1")
    jroot = str(tmp_path / "jax")
    get_trainer(jroot, strategy=rlt.XLAStrategy(devices=1, telemetry=True),
                limit_train_batches=6).fit(BoringModel())
    jobs.reset()
    want = json.load(open(os.path.join(jagg.telemetry_dir(jroot),
                                       jagg.SUMMARY_FILE)))["profile"]

    monkeypatch.undo()  # the port's trace backend is the real one
    monkeypatch.setenv(pprof.PROFILE_AT_STEP_ENV, "2")
    monkeypatch.setenv(pprof.PROFILE_STEPS_ENV, "1")
    trainer = _fit(tmp_path / "torch", SingleDeviceStrategy(telemetry=True), 6)
    run_dir = pagg.telemetry_dir(str(tmp_path / "torch"))
    got = json.load(open(os.path.join(run_dir, pagg.SUMMARY_FILE)))["profile"]
    assert _keys(got) == _keys(want)
    assert got["cost"]["train_step"]["step_flops"] > 0
    assert got["cost"]["train_step"]["roofline"]["verdict"] in (
        "compute-bound", "bandwidth-bound")
    cap = got["captures"][0]
    assert (cap["start_step"], cap["actual_start"], cap["num_steps"]) == (2, 2, 1)
    traces = os.listdir(cap["trace_dir"])
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    events = json.load(open(os.path.join(cap["trace_dir"], traces[0])))
    assert events["traceEvents"]
    assert "0" in got["attribution"]
    attr = got["attribution"]["0"]
    assert attr["compute_s"] <= attr["step_time_s"]
    assert trainer.global_step == 6
    assert pprof._SESSION == [None]


def test_ray_fit_captures_on_both_ranks_at_the_armed_step(tmp_path,
                                                          monkeypatch):
    """Two gloo workers armed from the driver's environment at step 3 for
    two steps: both capture at step 3 (the launcher pins the knobs in each
    worker's environment), each rank's trace in its own directory."""
    monkeypatch.setenv(pprof.PROFILE_AT_STEP_ENV, "3")
    monkeypatch.setenv(pprof.PROFILE_STEPS_ENV, "2")
    _fit(tmp_path, RayStrategy(num_workers=2, telemetry=True, timeout_s=120),
         6)
    run_dir = pagg.telemetry_dir(str(tmp_path))
    profile = json.load(open(os.path.join(run_dir, pagg.SUMMARY_FILE)))[
        "profile"]
    captures = profile["captures"]
    assert {c["rank"] for c in captures} == {0, 1}
    assert {c["actual_start"] for c in captures} == {3}
    assert {c["num_steps"] for c in captures} == {2}
    for c in captures:
        assert any(f.endswith(".pt.trace.json")
                   for f in os.listdir(c["trace_dir"])), c["trace_dir"]
    cost = profile["cost"]["train_step"]
    assert cost["step_flops"] > 0
    assert cost["collectives"]["all-reduce"]["count"] >= 1
    assert set(profile["attribution"]) == {"0", "1"}


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_profile_and_report_print_as_jax_s(tmp_path):
    dirs = {}
    for key, (obs, agg_mod, metrics) in {
            "jax": (jobs, jagg, jmetrics),
            "port": (pobs, pagg, pmetrics)}.items():
        dirs[key] = str(tmp_path / key)
        agg_mod.write_local_dump(dirs[key], None, None,
                                 profile=[r for _, r in _records()])
    for run_dir in dirs.values():
        outs = [_cli(main, ["profile", "--report", "--dir", run_dir])
                for main in (pmain, jmain)]
        assert outs[0] == outs[1] and outs[0][0] == 0
        assert "cost accounting" in outs[0][1]
    # arming: an explicit step, then the summary's latest step plus --lead
    for argv in (["--steps", "2", "--at-step", "7"], ["--lead", "5"]):
        rows = []
        for main, key in ((pmain, "port"), (jmain, "jax")):
            run_dir = str(tmp_path / f"live_{key}")
            os.makedirs(run_dir, exist_ok=True)
            json.dump({"cluster": {"steps_max": 11}},
                      open(os.path.join(run_dir, "summary.json"), "w"))
            rc, out = _cli(main, ["profile", "--dir", run_dir] + argv)
            row = json.loads(out)
            assert row["profile_cmd"] == f"{run_dir}/profile_cmd.json"
            cmd = pprof.read_profile_command(run_dir)
            rows.append((rc, {k: v for k, v in cmd.items()
                              if k not in ("id", "ts")}))
        assert rows[0] == rows[1]
    assert rows[0][1] == {"num_steps": 3, "start_step": 16}
    # nothing to anchor the start step on: the same refusals
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for summary in (None, {"cluster": {}}):
        if summary is not None:
            json.dump(summary, open(os.path.join(empty, "summary.json"), "w"))
        outs = [_cli(main, ["profile", "--dir", empty]) for main in (pmain, jmain)]
        assert outs[0][0] == outs[1][0] == 1
        assert outs[0][1] == outs[1][1].replace("RLT_", "TORCHRT_")
