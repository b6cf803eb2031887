"""The port's flight recorder (``ray_lightning_tpu_torch/observability/``
trace, metrics and ``__init__``) against the JAX package's on the same
operations: the ring and its no-op span, the environment knobs, registry
snapshots, deltas, merges, history and Prometheus text (byte for byte),
the clock-skew estimate, the merged Chrome trace, ``step_time_stats``, the
beat payload, the Prometheus endpoint and the device-memory gauges.

Both packages run the same Python arithmetic on the same floats, so every
comparison is exact (``==``); wall times are fixed or patched where they
enter. Each test starts and ends with both packages' process-global state
reset (recorder, registry, goodput ledgers, device-memory cache)."""
from __future__ import annotations

import pickle
import urllib.request

import numpy as np
import pytest
import torch

from ray_lightning_tpu import observability as jobs
from ray_lightning_tpu.observability import aggregator as jagg
from ray_lightning_tpu.observability import metrics as jmetrics
from ray_lightning_tpu.observability import trace as jtrace
from ray_lightning_tpu_torch import observability as pobs
from ray_lightning_tpu_torch.observability import aggregator as pagg
from ray_lightning_tpu_torch.observability import metrics as pmetrics
from ray_lightning_tpu_torch.observability import trace as ptrace

PKGS = {
    "jax": (jobs, jtrace, jmetrics, jagg),
    "torch": (pobs, ptrace, pmetrics, pagg),
}
ENV = ("TELEMETRY", "TELEMETRY_RING", "TELEMETRY_DIR", "METRICS_HISTORY",
       "PROM_PORT", "METRIC_TENANT_CARDINALITY", "EVENTS_MAX_BYTES")


@pytest.fixture(autouse=True)
def reset_both(monkeypatch):
    for name in ENV:
        monkeypatch.delenv("RLT_" + name, raising=False)
        monkeypatch.delenv("TORCHRT_" + name, raising=False)
    jobs.reset()
    pobs.reset()
    yield
    jobs.reset()
    pobs.reset()


def _both_env(monkeypatch, name, value):
    """One knob, set under each package's own prefix."""
    monkeypatch.setenv("RLT_" + name, value)
    monkeypatch.setenv("TORCHRT_" + name, value)


# --------------------------------------------------------------------- #
# trace
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("pkg", list(PKGS))
def test_disabled_span_is_the_noop_singleton(pkg):
    obs, trace, _, _ = PKGS[pkg]
    assert obs.span("step", step=1) is obs.NOOP_SPAN
    with obs.span("x"):
        pass
    obs.event("e", a=1)
    assert obs.get_recorder() is None and obs.registry() is None
    assert obs.collect_beat_payload() is None
    assert obs.collect_beat_payload(final=True) is None


@pytest.mark.parametrize("value", ["1", "true", "YES", " on ", "0", "off", ""])
def test_env_switch_reads_its_own_prefix(value, monkeypatch):
    """``TORCHRT_TELEMETRY`` means what ``RLT_TELEMETRY`` means to JAX; the
    port never reads the JAX variable."""
    monkeypatch.setenv("RLT_TELEMETRY", value)
    monkeypatch.delenv("TORCHRT_TELEMETRY", raising=False)
    want = jtrace.env_enabled()
    assert ptrace.env_enabled() is False
    assert pobs.maybe_enable_from_env() is None
    monkeypatch.setenv("TORCHRT_TELEMETRY", value)
    assert ptrace.env_enabled() == want
    assert (pobs.maybe_enable_from_env() is not None) == want
    assert (jobs.maybe_enable_from_env() is not None) == want


@pytest.mark.parametrize("ring", ["3", "40", "junk"])
def test_ring_bounds_follow_the_env(ring, monkeypatch):
    """The ring's capacity (16 at least, the default on a bad value) and
    its drop-oldest behaviour; spans, events and their args as JAX's."""
    _both_env(monkeypatch, "TELEMETRY_RING", ring)
    out = {}
    for pkg, (obs, trace, _, _) in PKGS.items():
        rec = obs.enable()
        assert obs.enable() is rec  # idempotent
        for i in range(70):
            with obs.span(f"s{i % 5}", step=i, k=i % 3):
                pass
            obs.event("verdict", step=i)
            rec.add_span("fixed", 1000.0 + i, 0.5, i, {"a": i})
        peeked = rec.peek(7)
        got = rec.drain()
        assert peeked == got[-7:] and rec.drain() == []
        out[pkg] = (rec.capacity, [(k, n, s, a) for k, n, _, _, s, a in got])
    assert out["jax"] == out["torch"]


def test_estimate_skew_and_merge_traces_are_jax_s():
    rng = np.random.default_rng(0)
    samples = {r: [(float(s), float(s + d)) for s, d in zip(
        rng.uniform(1e9, 1e9 + 100, 50), rng.uniform(-5, 5, 50))]
        for r in (0, 1, 2)}
    skews = {r: ptrace.estimate_skew(v) for r, v in samples.items()}
    assert skews == {r: jtrace.estimate_skew(v) for r, v in samples.items()}
    assert ptrace.estimate_skew([]) == jtrace.estimate_skew([]) == 0.0
    events = {
        "driver": [("X", "boot/setup_workers", 1000.0, 1.0, None, None),
                   ("i", "run_started", 1000.5, 0.0, None, {"fn": "fit"})],
        0: [("X", "step", 1001.0 + i * 0.1, 0.05, i, None) for i in range(5)]
        + [("X", "req/prefill", 1002.0, 0.2, None, {"track": "req r1"}),
           ("X", "req/decode", 1002.2, 0.4, None, {"track": "req r2", "n": 3})],
        2: [("X", "step", 996.0, 0.5, 7, {"x": 1})],
    }
    skew = {0: skews[0], 2: skews[2]}
    assert ptrace.merge_traces(events, skew) == jtrace.merge_traces(events, skew)
    assert ptrace.merge_traces(events) == jtrace.merge_traces(events)
    assert (ptrace.flow_pair(7 << 40, "req a", (1, 9999, 1.5), (2, 9999, 2.5))
            == jtrace.flow_pair(7 << 40, "req a", (1, 9999, 1.5),
                                (2, 9999, 2.5)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_time_stats_and_percentile_are_jax_s(seed):
    rng = np.random.default_rng(seed)
    by_rank = {r: [float(v) for v in rng.lognormal(-3, 0.5, n)]
               for r, n in zip(range(seed + 1), (1, 17, 64))}
    assert pagg.step_time_stats(by_rank) == jagg.step_time_stats(by_rank)
    assert pagg.step_time_stats({}) == jagg.step_time_stats({}) == {}
    pooled = [v for vs in by_rank.values() for v in vs]
    for q in (0, 10, 50, 90, 99, 100):
        assert pmetrics.percentile(pooled, q) == jmetrics.percentile(pooled, q)
    with pytest.raises(ValueError):
        pmetrics.percentile([], 50)


# --------------------------------------------------------------------- #
# metrics
# --------------------------------------------------------------------- #
def _script(reg, seed):
    """A seeded run of registry operations: counters, gauges, histograms
    with custom bounds and exemplars, capped tenant labels, an escaped
    label value and a dropped series."""
    rng = np.random.default_rng(seed)
    for i in range(200):
        op = int(rng.integers(0, 6))
        rank = int(rng.integers(0, 3))
        if op == 0:
            reg.counter("rlt_saves_total", kind="k%d" % rank).inc(
                float(rng.integers(1, 4)))
        elif op == 1:
            reg.gauge("rlt_mfu", rank=rank).set(float(rng.uniform()))
        elif op == 2:
            reg.histogram("rlt_step_time_seconds", rank=rank).observe(
                float(rng.lognormal(-3, 1)))
        elif op == 3:
            reg.histogram("rlt_serve_ttft_seconds", bounds=(0.01, 0.1, 1.0),
                          replica=rank).observe(
                float(rng.uniform(0, 2)), exemplar=f"req-{i}~r{rank}")
        elif op == 4:
            reg.counter(jmetrics.TENANT_REQUESTS_METRIC,
                        tenant=reg.tenant_label(f"t{int(rng.integers(0, 9))}")
                        ).inc()
        else:
            reg.gauge("rlt_odd", path='a\\b"c\nd%d' % rank).inc(0.25)
    reg.drop_series(rank=2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshots_deltas_and_merges_are_jax_s(seed, monkeypatch):
    _both_env(monkeypatch, "METRIC_TENANT_CARDINALITY", "4")
    _both_env(monkeypatch, "METRICS_HISTORY", "3")
    regs = {}
    for pkg, (_, _, metrics, _) in PKGS.items():
        reg = regs[pkg] = metrics.MetricsRegistry()
        _script(reg, seed)
    j, p = regs["jax"], regs["torch"]
    assert p.snapshot() == j.snapshot()
    assert p.snapshot(delta=True) == j.snapshot(delta=True)
    assert p.snapshot(delta=True) == j.snapshot(delta=True)  # drained
    assert p.prometheus_text() == j.prometheus_text()
    for reg in (j, p):
        for ts in (10.0, 20.0, 30.0, 40.0):
            reg.push_history(ts)
    assert p.history() == j.history() and len(p.history()) == 3
    assert p.history(since=30.0) == j.history(since=30.0)
    # the driver's side: a delta then a cumulative snapshot, relabelled
    for src_seed in (seed + 10, seed + 20):
        snaps = {}
        for pkg, (_, _, metrics, _) in PKGS.items():
            src = metrics.MetricsRegistry()
            _script(src, src_seed)
            snaps[pkg] = (src.snapshot(delta=True), src.snapshot())
        assert snaps["jax"] == snaps["torch"]
        for reg, (delta, full) in ((j, snaps["jax"]), (p, snaps["torch"])):
            reg.merge_snapshot(delta, extra_labels={"rank": 5})
            reg.merge_snapshot(full, extra_labels={"rank": 5})
    assert p.snapshot() == j.snapshot()
    assert p.prometheus_text() == j.prometheus_text()
    hp = p.get("rlt_serve_ttft_seconds", replica=0, rank=5)
    hj = j.get("rlt_serve_ttft_seconds", replica=0, rank=5)
    assert hp.bucket_exemplars(0.1) == hj.bucket_exemplars(0.1)
    assert hp.percentile(90) == hj.percentile(90)


def test_histogram_pending_cap_and_kind_conflict():
    for metrics in (jmetrics, pmetrics):
        metrics.PENDING_CAP  # noqa: B018  (both define it)
    hj = jmetrics.Histogram(pending_cap=5)
    hp = pmetrics.Histogram(pending_cap=5)
    for i in range(12):
        hj.observe(i * 0.01, exemplar=str(i))
        hp.observe(i * 0.01, exemplar=str(i))
    assert hp.drain_pending() == hj.drain_pending() == [0.0, 0.01, 0.02,
                                                        0.03, 0.04]
    assert hp.exemplars == hj.exemplars
    reg = pmetrics.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")


def test_prometheus_help_registry_is_jax_s():
    """The port's help texts are JAX's; the JAX modules that are not ported
    (the compile cache) add theirs at import. The profiler's cost series
    have help in both packages, each naming where its counts come from
    (XLA's cost analysis; meta tensors of the program's shapes)."""
    from ray_lightning_tpu.observability import profiler as jprof
    from ray_lightning_tpu_torch.observability import profiler as pprof

    cost = {pprof.STEP_FLOPS_METRIC, pprof.STEP_BYTES_METRIC,
            pprof.COLLECTIVE_BYTES_METRIC, pprof.COST_MFU_METRIC}
    assert cost == {jprof.STEP_FLOPS_METRIC, jprof.STEP_BYTES_METRIC,
                    jprof.COLLECTIVE_BYTES_METRIC, jprof.COST_MFU_METRIC}
    assert cost <= set(pmetrics.HELP) and cost <= set(jmetrics.HELP)
    assert ({k: v for k, v in pmetrics.HELP.items() if k not in cost}
            == {k: jmetrics.HELP[k] for k in pmetrics.HELP if k not in cost})
    for name in ("rlt_step_time_seconds", "rlt_unknown_thing_total"):
        assert pmetrics.help_for(name) == jmetrics.help_for(name)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_prom_server_serves_the_provider_on_localhost(pkg):
    metrics = PKGS[pkg][2]
    reg = metrics.MetricsRegistry()
    reg.counter("rlt_saves_total").inc(3)
    srv = metrics.PromServer(reg.prometheus_text, port=0)
    port = srv.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            assert r.read().decode() == reg.prometheus_text()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=10)
    finally:
        srv.stop()
        srv.stop()  # idempotent


@pytest.mark.parametrize("raw", [None, "", "0", "9091", "x"])
def test_prom_port_knob(raw, monkeypatch):
    if raw is not None:
        _both_env(monkeypatch, "PROM_PORT", raw)
    assert pmetrics.prom_port_from_env() == jmetrics.prom_port_from_env()


def test_device_memory_on_a_process_without_cuda_is_empty():
    """The CPU's allocator has no stats: both packages give ``[]``, and the
    port's probe opens no CUDA context."""
    assert pmetrics.device_memory_stats() == []
    assert jmetrics.device_memory_stats() == []
    pobs.enable()
    pobs.sample_device_memory(force=True)
    assert pmetrics.last_device_memory() == []
    assert not torch.cuda.is_initialized()
    assert pobs.registry().snapshot()["gauges"] == []


def test_device_memory_gauges_from_the_stats(monkeypatch):
    """What the gauges publish from a stats list, and the throttle: a
    second call within the interval returns the cached list."""
    stats = [{"device": "cuda:0", "bytes_in_use": 5 << 20,
              "peak_bytes": 9 << 20, "bytes_limit": 80 << 30}]
    calls = []
    monkeypatch.setattr(pmetrics, "device_memory_stats",
                        lambda: calls.append(1) or stats)
    monkeypatch.setattr(jmetrics, "device_memory_stats",
                        lambda: calls.append(1) or stats)
    regs = [jmetrics.MetricsRegistry(), pmetrics.MetricsRegistry()]
    for metrics, reg in zip((jmetrics, pmetrics), regs):
        assert metrics.publish_device_memory(reg) == stats
        assert metrics.publish_device_memory(reg) == stats  # cached
    assert len(calls) == 2
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[1].get(pmetrics.HBM_IN_USE_METRIC, device="cuda:0").value == (
        5 << 20)


# --------------------------------------------------------------------- #
# the beat payload
# --------------------------------------------------------------------- #
def _record(pkg, clock):
    """The same spans, metrics and goodput ledger in one package."""
    obs = PKGS[pkg][0]
    rec = obs.enable()
    reg = obs.registry()
    led = obs.goodput.GoodputLedger("train", clock=clock)
    obs.goodput._LEDGERS["train"] = led
    rec.add_span("compile", 100.0, 2.0, 0, None)
    for i in range(1, 5):
        rec.add_span("step", 102.0 + i, 0.25 * i, i, {"k": i})
        reg.histogram("rlt_step_time_seconds").observe(0.25 * i)
    reg.counter("rlt_input_starved_seconds").inc(0.125)
    reg.gauge("rlt_prefetch_queue_depth").set(2)
    clock.t = 10.0
    led.enter("compile")
    clock.t = 12.5
    led.enter("productive_compute")
    clock.t = 20.0
    return rec


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_collect_beat_payload_round_trips_into_both_aggregators(tmp_path):
    payloads = {}
    for pkg in PKGS:
        _record(pkg, _Clock())
        delta = PKGS[pkg][0].collect_beat_payload()
        again = PKGS[pkg][0].collect_beat_payload()
        final = PKGS[pkg][0].collect_beat_payload(final=True)
        payloads[pkg] = (delta, again, final)
    assert payloads["torch"] == payloads["jax"]
    delta, again, final = payloads["torch"]
    assert [e[1] for e in delta["t"]] == ["compile"] + ["step"] * 4
    assert again["t"] == [] and final["t"] == []
    # the beat crosses the ring as a stdlib pickle; each aggregator takes
    # the other package's payload
    wire = pickle.loads(pickle.dumps(delta))
    summaries = []
    for agg, sub in ((jagg, "j"), (pagg, "p")):
        a = agg.DriverAggregator(str(tmp_path / sub), num_workers=1,
                                 summary_interval=1e9)
        a.on_beat(0, 4, 50.0, wire, recv_wall=50.25)
        a.on_beat(0, 4, 51.0, final, recv_wall=51.5)
        s = a.summary()
        s.pop("ts")
        for info in s["per_rank"].values():
            info.pop("heartbeat_age_s")
        summaries.append(s)
        a.finalize()
    assert summaries[0] == summaries[1]
    assert summaries[1]["goodput"]["by_category"] == {
        "compile": 2.5, "idle": 10.0, "productive_compute": 7.5}
