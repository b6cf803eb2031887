"""The port's request tracer (``observability/reqtrace.py``) and SLO monitor
(``observability/slo.py``) against the JAX package's on the same inputs:
head-sampling verdicts, ``TraceContext`` export, ``RequestTrace`` records
and spans across a migration hop, the tracer's records and TTFT-component
histograms, the burn-rate monitors' rates, breaches and gauges,
``ttft_burn_attribution``, and the SLO verdicts of the Autoscaler, the
supervisor and the driver aggregator (with its ``summary.json`` section).

Both packages run the same Python arithmetic on the same floats, so the
comparisons are exact; every clock is injected (a fake ``perf_counter`` and
``time`` for the traces, a fake monotonic clock for the monitors), so no
raw time of a run is compared."""
from __future__ import annotations

import dataclasses
import json
import os
import time

import pytest

from ray_lightning_tpu import observability as jobs
from ray_lightning_tpu.observability import aggregator as jagg
from ray_lightning_tpu.observability import metrics as jmetrics
from ray_lightning_tpu.observability import reqtrace as jreqtrace
from ray_lightning_tpu.observability import slo as jslo
from ray_lightning_tpu.runtime import supervisor as jsup
from ray_lightning_tpu.serving import replica as jreplica
from ray_lightning_tpu.serving import tenancy as jtenancy
from ray_lightning_tpu_torch import observability as pobs
from ray_lightning_tpu_torch.observability import aggregator as pagg
from ray_lightning_tpu_torch.observability import metrics as pmetrics
from ray_lightning_tpu_torch.observability import reqtrace as preqtrace
from ray_lightning_tpu_torch.observability import slo as pslo
from ray_lightning_tpu_torch.runtime import supervisor as psup
from ray_lightning_tpu_torch.serving import replica as preplica
from ray_lightning_tpu_torch.serving import tenancy as ptenancy

PKGS = {
    "jax": dict(obs=jobs, agg=jagg, metrics=jmetrics, reqtrace=jreqtrace,
                slo=jslo, sup=jsup, replica=jreplica, tenancy=jtenancy,
                prefix="RLT_"),
    "torch": dict(obs=pobs, agg=pagg, metrics=pmetrics, reqtrace=preqtrace,
                  slo=pslo, sup=psup, replica=preplica, tenancy=ptenancy,
                  prefix="TORCHRT_"),
}
KNOBS = ("TRACE_SAMPLE", "SLO_TTFT_S", "SLO_ITL_S", "SLO_STEP_S",
         "SLO_STARVED_S", "SLO_ERROR_TARGET", "SLO_TENANT_TTFT_S",
         "TELEMETRY", "TELEMETRY_DIR", "PROM_PORT")


@pytest.fixture(autouse=True)
def reset_both(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv("RLT_" + name, raising=False)
        monkeypatch.delenv("TORCHRT_" + name, raising=False)
    jobs.reset()
    pobs.reset()
    yield
    jobs.reset()
    pobs.reset()


def both(fn):
    """``fn(pkg)`` on each package: (the JAX result, the port's result)."""
    return fn(PKGS["jax"]), fn(PKGS["torch"])


class Clock:
    """A monotonic clock that moves only when told to."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def fake_time(monkeypatch):
    """Patch ``time.perf_counter`` and ``time.time`` (both packages' traces
    read them through the one ``time`` module): returns a factory of fresh
    clocks, the wall clock a fixed offset from the perf clock."""

    def fresh():
        clock = Clock(50.0)
        monkeypatch.setattr(time, "perf_counter", clock)
        monkeypatch.setattr(time, "time", lambda: 1.7e9 + clock.t)
        return clock

    return fresh


# --------------------------------------------------------------------- #
# head sampling and the environment knob
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.37, 0.5, 0.9, 1.0])
def test_head_sampled_verdicts_match_jax(rate):
    rids = ([f"req-{i}" for i in range(300)] + [f"g{i}" for i in range(100)]
            + [f"f{i}~m1" for i in range(50)])
    j, p = both(lambda m: [m["reqtrace"].head_sampled(r, rate) for r in rids])
    assert j == p
    if 0.0 < rate < 1.0:
        assert 0 < sum(p) < len(rids)


@pytest.mark.parametrize("raw", [None, "0.25", "1", "0", "-3", "7", "x"])
def test_sample_rate_reads_its_own_prefix(raw):
    for pkg in PKGS.values():
        env = {} if raw is None else {pkg["prefix"] + "TRACE_SAMPLE": raw}
        want = jreqtrace.sample_rate(
            {} if raw is None else {"RLT_TRACE_SAMPLE": raw})
        assert pkg["reqtrace"].sample_rate(env) == want
    assert preqtrace.SAMPLE_ENV == "TORCHRT_TRACE_SAMPLE"
    # the JAX knob does not reach the port
    assert preqtrace.sample_rate({"RLT_TRACE_SAMPLE": "0.1"}) == 1.0


# --------------------------------------------------------------------- #
# RequestTrace: stamps, records, TTFT components across a hop, contexts
# --------------------------------------------------------------------- #
def _two_hops(rt, clock):
    """A prefill hop deferred twice, admitted, prefilled and exported, then
    the decode hop seeded from its context, which emits four tokens."""
    tr = rt.RequestTrace("req-7", prompt_len=5, max_new_tokens=4, replica=0,
                         pool="prefill", tenant="gold")
    clock.advance(0.01)
    tr.deferred()
    clock.advance(0.02)
    tr.deferred()
    clock.advance(0.005)
    tr.admitted(slot=2)
    clock.advance(0.03)
    tr.prefilled(0.025)
    clock.advance(0.002)
    ctx = tr.export_context()
    first = tr.record("migrated")
    clock.advance(0.004)  # in flight
    tr1 = rt.RequestTrace("req-7~m1", 5, 4, replica=1, ctx=ctx, pool="decode")
    clock.advance(0.001)
    tr1.admitted(0)
    for i in range(4):
        clock.advance(0.01 * (i + 1))
        tr1.token()
    return tr, tr1, ctx, first, tr1.record("length")


def test_request_records_across_a_migration_hop_match_jax(fake_time):
    out = {}
    for name, pkg in PKGS.items():
        out[name] = _two_hops(pkg["reqtrace"], fake_time())
    (_, jtr1, jctx, jfirst, jsecond) = out["jax"]
    (_, ptr1, pctx, pfirst, psecond) = out["torch"]
    assert dataclasses.asdict(pctx) == dataclasses.asdict(jctx)
    assert (pctx.hop, pctx.rid, pctx.gap_component) == (1, "req-7", "transfer")
    assert pfirst == jfirst and psecond == jsecond
    assert pfirst["disposition"] == "migrated" and pfirst["deferred_ticks"] == 2
    assert psecond["parent_rid"] == "req-7" and psecond["hop"] == 1
    # the shipment's context carries no tenant, in both packages
    assert pfirst["tenant"] == "gold" and "tenant" not in psecond
    assert psecond["transfer_s"] > 0
    comps = psecond["ttft_components"]
    assert set(comps) == {"queue_wait", "prefill", "export_wait", "transfer",
                          "decode"}
    # the components telescope to the request's end-to-end TTFT
    assert sum(comps.values()) == pytest.approx(psecond["ttft_total_s"],
                                                abs=1e-5)
    assert ptr1.itls() == jtr1.itls()


def test_local_components_sum_to_the_hops_ttft(fake_time):
    for pkg in PKGS.values():
        clock = fake_time()
        tr = pkg["reqtrace"].RequestTrace("r0", 3, 2)
        clock.advance(0.003)
        tr.admitted(1)
        clock.advance(0.004)
        tr.prefilled(0.004)
        clock.advance(0.005)
        tr.token()
        rec = tr.record("length")
        assert "parent_rid" not in rec and rec["hop"] == 0
        assert sum(tr.local_components().values()) == pytest.approx(
            tr.ttft_s)
        assert rec["ttft_total_s"] == pytest.approx(rec["ttft_s"], abs=2e-6)


def test_emit_spans_match_jax(fake_time):
    spans = {}
    for name, pkg in PKGS.items():
        pkg["obs"].enable()
        tr, tr1, *_ = _two_hops(pkg["reqtrace"], fake_time())
        rec = pkg["obs"].get_recorder()
        rec.drain()
        tr.emit_spans(rec, "migrated")
        tr1.emit_spans(rec, "length")
        spans[name] = rec.drain()
        pkg["obs"].reset()
    assert spans["torch"] == spans["jax"]
    assert [e[1] for e in spans["torch"]] == [
        "req/queue_wait", "req/deferred_block_wait", "req/prefill",
        "req/queue_wait", "req/decode"]


@pytest.mark.parametrize("rate", [1.0, 0.5])
def test_tracer_records_histograms_and_file_match_jax(fake_time, tmp_path,
                                                      rate):
    out = {}
    for name, pkg in PKGS.items():
        pkg["obs"].enable()
        clock = fake_time()
        tracer = pkg["reqtrace"].RequestTracer(
            out_dir=str(tmp_path / name), rate=rate, pool="serve")
        live = []
        for i in range(24):
            tr = tracer.start(f"req-{i}", 4, 3, replica=0, retries=i % 2,
                              tenant="t" if i % 3 else None)
            clock.advance(0.001)
            if tr is not None:
                tr.admitted(i % 4)
                clock.advance(0.002)
                tr.prefilled(0.002)
                live.append(tr)
        for tr in live:
            for _ in range(3):
                clock.advance(0.003)
                tr.token()
            tracer.finish(tr, "length")
        tracer.close()
        snap = pkg["obs"].registry().snapshot(delta=False)
        out[name] = (tracer.drain(), tracer.drain(),
                     (tracer.started_total, tracer.sampled_total,
                      tracer.finished_total),
                     snap["histograms"],
                     open(tracer.path).read(),
                     pkg["obs"].get_recorder().drain())
        pkg["obs"].reset()
    assert out["torch"] == out["jax"]
    records, again, totals = out["torch"][:3]
    assert again == [] and totals[0] == 24 and totals[1] == len(records)
    assert (totals[1] == 24) == (rate == 1.0)


# --------------------------------------------------------------------- #
# burn-rate monitors
# --------------------------------------------------------------------- #
def _monitor(pkg, target=0.95, **kw):
    objective = pkg["slo"].SLObjective(
        "ttft_p95", metric="rlt_serve_ttft_seconds", threshold=1.0,
        target=target)
    clock = Clock()
    return pkg["slo"].BurnRateMonitor(objective, clock=clock, **kw), clock


def _burn_math(pkg):
    m, clock = _monitor(pkg)
    rates = []
    for i in range(10):
        m.observe(2.0 if i % 2 else 0.1)
        rates.append(m.burn_rate(60.0))
    m.observe(5.0)
    clock.advance(120.0)
    rates += [m.burn_rate(60.0), m.burn_rate(600.0)]
    clock.advance(700.0)
    rates.append(m.evaluate())
    return rates, len(m._samples), m.attainment(), m.good_total, m.bad_total


def _short_spike(pkg):
    m, clock = _monitor(pkg)
    for _ in range(200):
        m.observe(0.1)
        clock.advance(2.0)
    clock.advance(60.0)
    for _ in range(5):
        m.observe(5.0)
        clock.advance(1.0)
    return (m.burn_rate(m.fast_window_s), m.burn_rate(m.slow_window_s),
            m.evaluate(), m.breached)


def _breach_and_clear(pkg):
    m, clock = _monitor(pkg)
    out = []
    for _ in range(20):
        m.observe(5.0)
        clock.advance(1.0)
    out += [m.evaluate(), m.evaluate(), m.breached, m.breaches_total]
    for _ in range(100):
        m.observe(0.1)
        clock.advance(1.0)
    out += [m.evaluate(), m.breached]
    return out


def _ratio(pkg):
    objective = pkg["slo"].SLObjective(
        "error_rate", metric="rlt_serve_completions_total", threshold=0.0,
        target=0.9, kind="ratio")
    m = pkg["slo"].BurnRateMonitor(objective, clock=Clock())
    m.record(good=80, bad=20)
    m.record(good=0, bad=0)
    return m.burn_rate(60.0), len(m._samples), objective.error_budget


@pytest.mark.parametrize("scenario", [_burn_math, _short_spike,
                                      _breach_and_clear, _ratio],
                         ids=["math", "short_spike", "breach_clear", "ratio"])
def test_burn_rate_monitor_matches_jax(scenario):
    j, p = both(scenario)
    assert p == j


def test_breach_then_clear_events():
    _, p = both(_breach_and_clear)
    assert p[0]["event"] == "slo_breach" and p[1] is None
    assert p[0]["fast_burn_rate"] >= pslo.DEFAULT_FAST_BURN
    assert p[4]["event"] == "slo_clear" and p[5] is False


def _monitor_routing(pkg):
    clock = Clock()
    mon = pkg["slo"].SLOMonitor(clock=clock)
    mon.observe_latency("ttft_p95", 100.0)
    mon.observe_latency("rlt_serve_itl_seconds", 0.01)
    mon.observe_latency("error_rate", 100.0)
    mon.record("error_rate", 9, 1)
    mon.record("nope", 1, 1)
    for _ in range(20):
        mon.observe_latency("ttft_p95", 100.0)
        mon.observe_latency("step_time", 1e6)
        clock.advance(1.0)
    reg = pkg["metrics"].MetricsRegistry()
    verdicts = mon.evaluate(reg=reg)
    return (verdicts, mon.breached(), mon.breached("ttft_p95"),
            mon.breached("itl_p99"), mon.serving_breached(),
            mon.serving_fast_burn(), mon.burn_rates(),
            mon.attainment("ttft_p95"), mon.attainment("nope"),
            reg.snapshot(delta=False)["gauges"],
            mon.monitor_for_metric("rlt_nope"))


def test_slo_monitor_routing_verdicts_and_gauges_match_jax():
    j, p = both(_monitor_routing)
    assert p == j
    assert sorted(v["objective"] for v in p[0]) == [
        "error_rate", "step_time", "ttft_p95"]
    assert p[4] is True and p[5] >= pslo.DEFAULT_FAST_BURN


def _training_only_breach(pkg):
    clock = Clock()
    mon = pkg["slo"].SLOMonitor(clock=clock)
    for _ in range(20):
        mon.observe_latency("step_time", 1e6)
        clock.advance(1.0)
    mon.evaluate()
    return mon.breached(), mon.serving_breached(), mon.serving_fast_burn()


def test_a_training_breach_is_not_a_serving_breach():
    j, p = both(_training_only_breach)
    assert p == j == (True, False, 0.0)


def test_default_objectives_read_their_own_prefix(monkeypatch):
    values = {"SLO_TTFT_S": "0.5", "SLO_ITL_S": "0.05", "SLO_STEP_S": "9",
              "SLO_STARVED_S": "0.2", "SLO_ERROR_TARGET": "0.9"}
    plain = pslo.default_objectives({})
    for k, v in values.items():
        monkeypatch.setenv("RLT_" + k, v)
    assert pslo.default_objectives() == plain  # the JAX knobs do not reach
    for k, v in values.items():
        monkeypatch.setenv("TORCHRT_" + k, v)
    j, p = both(lambda m: [dataclasses.astuple(o)
                           for o in m["slo"].default_objectives()])
    assert p == j
    assert p != [dataclasses.astuple(o) for o in plain]
    monkeypatch.setenv("TORCHRT_SLO_TTFT_S", "bad")
    assert pslo.default_objectives()[0].threshold == 2.0


def _tenant_objectives(pkg):
    t = pkg["tenancy"]
    reg = t.TenantRegistry(t.parse_tenant_specs(
        "silver:standard:2,free:best_effort:1")
        + [t.TenantSpec(name="gold", tenant_class="guaranteed", weight=4,
                        ttft_slo_ms=250.0)])
    return [dataclasses.astuple(o)
            for o in pkg["slo"].tenant_objectives(reg)]


def test_tenant_objectives_match_jax(monkeypatch):
    monkeypatch.setenv("RLT_SLO_TENANT_TTFT_S", "1.5")
    monkeypatch.setenv("TORCHRT_SLO_TENANT_TTFT_S", "1.5")
    j, p = both(_tenant_objectives)
    assert p == j and len(p) == 3
    assert {o[0]: o[2] for o in p} == {"tenant_ttft_gold": 0.25,
                                       "tenant_ttft_silver": 1.5,
                                       "tenant_ttft_free": 1.5}


# --------------------------------------------------------------------- #
# TTFT burn attribution
# --------------------------------------------------------------------- #
COMPONENTS = [("queue_wait", "prefill", [0.2, 0.3]),
              ("prefill", "prefill", [0.05]),
              ("transfer", "decode", [0.01, 0.02]),
              ("decode", "decode", [0.4, 0.5, 0.1]),
              ("dispatch", "serve", [0.001])]


def _attribution(pkg, drop=()):
    reg = pkg["metrics"].MetricsRegistry()
    for comp, pool, values in COMPONENTS:
        if comp in drop:
            continue
        h = reg.histogram(pkg["metrics"].SERVE_TTFT_COMPONENT_METRIC,
                          bounds=pkg["metrics"].TTFT_COMPONENT_BOUNDS,
                          component=comp, pool=pool)
        for v in values:
            h.observe(v, exemplar=f"r-{comp}")
    return pkg["slo"].ttft_burn_attribution(reg)


@pytest.mark.parametrize("drop", [(), ("decode",), ("decode", "queue_wait"),
                                  tuple(c for c, _, _ in COMPONENTS)],
                         ids=["all", "no_decode", "transfer_led", "empty"])
def test_ttft_burn_attribution_matches_jax(drop):
    j, p = both(lambda m: _attribution(m, drop))
    assert p == j
    assert (p is None) == (len(drop) == len(COMPONENTS))
    assert pslo.ttft_burn_attribution(object()) is None


def _attributed_breach(pkg):
    reg = pkg["metrics"].MetricsRegistry()
    h = reg.histogram(pkg["metrics"].SERVE_TTFT_COMPONENT_METRIC,
                      component="transfer", pool="decode")
    h.observe(3.0)
    clock = Clock()
    mon = pkg["slo"].SLOMonitor(clock=clock)
    for _ in range(20):
        mon.observe_latency("ttft_p95", 100.0)
        clock.advance(1.0)
    return mon.evaluate(reg=reg)


def test_a_ttft_breach_names_its_dominant_component():
    j, p = both(_attributed_breach)
    assert p == j
    assert p[0]["dominant_component"] == "transfer"
    assert p[0]["dominant_pool"] == "migration"


# --------------------------------------------------------------------- #
# the verdicts' consumers: Autoscaler, supervisor, aggregator
# --------------------------------------------------------------------- #
class Fleet:
    """The Autoscaler's duck type, with a device capacity."""

    def __init__(self, mod, capacity=3, role=None):
        self.mod = mod
        self.num_replicas = 1
        self.capacity = capacity
        self.role = role
        self.load = {"queue_depth": 0, "active": 0}

    def loads(self):
        out = {i: dict(self.load) for i in range(self.num_replicas)}
        if self.role is not None:
            for v in out.values():
                v["role"] = self.role
        return out

    def add_replica(self, role=None):
        if self.num_replicas >= self.capacity:
            raise self.mod.CapacityBlocked("at capacity")
        self.num_replicas += 1

    def remove_replica(self, role=None):
        self.num_replicas -= 1


def _autoscaler_run(pkg):
    """Telemetry on: an Autoscaler over a fleet of capacity 2, driven by an
    SLO monitor and by the decode pool's TTFT component read from the
    process registry."""
    pkg["obs"].enable()
    reg = pkg["obs"].registry()
    clock = Clock()
    mon = pkg["slo"].SLOMonitor(clock=clock)
    fleet = Fleet(pkg["replica"], capacity=2)
    scaler = pkg["replica"].Autoscaler(fleet, min_replicas=1, max_replicas=4,
                                       slo_monitor=mon, idle_ticks_down=1)
    deltas = [scaler.tick(now=0.0)]
    for _ in range(20):
        mon.observe_latency("ttft_p95", 100.0)
        clock.advance(1.0)
    deltas += [scaler.tick(now=1.0), scaler.tick(now=2.0)]
    for _ in range(200):
        mon.observe_latency("ttft_p95", 0.01)
        clock.advance(1.0)
    deltas.append(scaler.tick(now=3.0))
    # the decode pool's own signal: the mean TTFT "decode" component of
    # the requests finished since the last tick
    pool = pkg["replica"].Autoscaler(
        Fleet(pkg["replica"], role="decode"), role="decode",
        min_replicas=1, max_replicas=4, ttft_component_high_s=0.1)
    hist = reg.histogram(pkg["metrics"].SERVE_TTFT_COMPONENT_METRIC,
                         bounds=pkg["metrics"].TTFT_COMPONENT_BOUNDS,
                         component="decode", pool="decode")
    hist.observe(0.5)
    deltas.append(pool.tick(now=10.0))
    deltas.append(pool.tick(now=11.0))  # no new samples: no signal
    hist.observe(0.01)
    deltas.append(pool.tick(now=12.0))
    snap = reg.snapshot(delta=False)
    # (kind, name, step, args): the wall time is left out
    events = [(e[0], e[1], e[4], e[5])
              for e in pkg["obs"].get_recorder().drain()]
    out = (deltas, scaler.capacity_blocked_total, scaler.last_outcome,
           scaler.history, pool.history,
           [c for c in snap["counters"] if c[0].startswith("rlt_serve")],
           [g for g in snap["gauges"] if g[0].startswith(("rlt_serve",
                                                          "rlt_slo"))],
           events)
    pkg["obs"].reset()
    return out


def test_autoscaler_with_a_registry_and_an_slo_monitor_matches_jax():
    j, p = both(_autoscaler_run)
    assert p == j
    deltas = p[0]
    assert deltas[:3] == [0, 1, 0]  # the breach scales up, then capacity
    assert p[1] == 1 and ["rlt_serve_capacity_blocked_total", [], 1.0] in p[5]
    # the pool's component signal scales up, then two idle ticks drain
    assert deltas[4:] == [1, 0, -1]
    assert any(e[1] == "serve_capacity_blocked" for e in p[7])


def _supervisor_verdicts(pkg, tmp_path):
    clock = Clock()
    mon = pkg["slo"].SLOMonitor(clock=clock)
    run_dir = str(tmp_path / pkg["prefix"])

    class Tap:
        def __init__(self):
            self.events = []

        def on_beat(self, *a):
            pass

        def heartbeat_age(self, *a):
            pass

        def record_event(self, kind, **fields):
            self.events.append((kind, fields))

    tap = Tap()
    sup = pkg["sup"].Supervisor(num_workers=1, drain=lambda: [],
                                hang_timeout=None, aggregator=tap,
                                slo_monitor=mon)
    first = sup.check()
    for _ in range(20):
        mon.observe_latency("step_time", 1e6)
        clock.advance(1.0)
    second = sup.check()
    for _ in range(400):
        mon.observe_latency("step_time", 0.01)
        clock.advance(0.1)
    third = sup.check()
    agg = pkg["agg"].DriverAggregator(run_dir, num_workers=1, full=False)
    sup2 = pkg["sup"].Supervisor(num_workers=1, drain=lambda: [],
                                 hang_timeout=None, aggregator=agg,
                                 slo_monitor=pkg["slo"].SLOMonitor(
                                     clock=clock))
    sup2._slo_monitor.observe_latency("input_starvation", 9.0)
    for _ in range(20):
        sup2._slo_monitor.observe_latency("input_starvation", 9.0)
        clock.advance(1.0)
    sup2.check()
    agg.finalize()
    with open(os.path.join(run_dir, "events.jsonl")) as fh:
        logged = [{k: v for k, v in json.loads(line).items() if k != "ts"}
                  for line in fh]
    return (first, second, third), tap.events, logged


def test_supervisor_records_slo_verdicts_as_jax(tmp_path):
    j, p = both(lambda m: _supervisor_verdicts(m, tmp_path))
    assert p == j
    kinds = [k for k, _ in p[1]]
    assert kinds == ["slo_breach", "slo_clear"]
    assert all(v == {0: "ok"} for v in p[0])
    assert [e["event"] for e in p[2]] == ["slo_breach"]


def _payload(pkg, ttfts=(), errors=0, ok=0, starved=0.0):
    reg = pkg["metrics"].MetricsRegistry()
    h = reg.histogram("rlt_serve_ttft_seconds")
    for v in ttfts:
        h.observe(v)
    if errors:
        reg.counter("rlt_serve_completions_total", reason="error").value = (
            errors)
    if ok:
        reg.counter("rlt_serve_completions_total", reason="eos").value = ok
    if starved:
        reg.counter("rlt_input_starved_seconds").value = starved
    return {"m": reg.snapshot(delta=True)}


def _aggregator_slo(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv(pkg["prefix"] + "SLO_TTFT_S", "0.2")
    run_dir = str(tmp_path / pkg["prefix"])
    clock = Clock()
    agg = pkg["agg"].DriverAggregator(
        run_dir, num_workers=2, slo_monitor=pkg["slo"].SLOMonitor(clock=clock))
    states = []
    beats = [
        (0, _payload(pkg, [1.0] * 10, errors=5, ok=5)),
        (1, _payload(pkg, [0.05] * 4, ok=10, starved=0.5)),
        (0, _payload(pkg, [0.01] * 400, errors=5, ok=95)),
        (1, _payload(pkg, [], ok=30, starved=0.52)),
    ]
    for step, (rank, payload) in enumerate(beats):
        clock.advance(1.0)
        agg.on_beat(rank, step, 1.7e9 + step, payload=payload,
                    recv_wall=1.7e9 + step + 0.001)
        states.append((agg.slo.breached(), agg.slo.burn_rates()))
    summary = agg.summary()
    err = agg.slo.monitors["error_rate"]
    counts = err._counts(60.0, err.clock())
    agg.drop_rank(1)
    agg.finalize()
    with open(os.path.join(run_dir, "events.jsonl")) as fh:
        events = [{k: v for k, v in json.loads(line).items() if k != "ts"}
                  for line in fh]
    with open(os.path.join(run_dir, "summary.json")) as fh:
        written = json.load(fh)
    prom = open(os.path.join(run_dir, "metrics.prom")).read()
    return (states, summary["slo"], counts, events, written["slo"],
            sorted(line.split(" ")[0] for line in prom.splitlines()
                   if line.startswith("rlt_slo")),
            # bundles are named <wall time>_<kind>: their kinds only
            sorted(n.split("_", 1)[1] for n in os.listdir(
                os.path.join(run_dir, "incidents"))))


def test_aggregator_slo_feed_events_and_summary_match_jax(tmp_path,
                                                          monkeypatch):
    j, p = both(lambda m: _aggregator_slo(m, tmp_path, monkeypatch))
    assert p == j
    states, slo_section, counts, events = p[:4]
    assert states[0][0] is True
    assert states[0][1]["ttft_p95"]["breached"] == 1.0
    assert states[2][1]["ttft_p95"]["breached"] == 0.0
    assert slo_section == p[4] and "ttft_p95" in slo_section
    assert counts == (125, 5)  # per-rank counter deltas
    kinds = [e["event"] for e in events]
    assert kinds.index("slo_breach") < kinds.index("slo_clear")
    assert p[6], "a breach freezes an incident bundle"


def test_aggregator_renders_the_slo_section(tmp_path, monkeypatch):
    """``top`` renders the summary's ``slo`` line the same for both
    packages' run directories."""
    outs = {}
    for name, pkg in PKGS.items():
        _aggregator_slo(pkg, tmp_path / "r", monkeypatch)
        run_dir = str(tmp_path / "r" / pkg["prefix"])
        summary = pagg._read_summary(run_dir)
        outs[name] = pagg.format_summary(summary, [])
        assert outs[name] == jagg.format_summary(jagg._read_summary(run_dir),
                                                 [])
    strip = [ln for ln in outs["torch"].splitlines() if ln.startswith("slo")]
    assert strip and strip == [ln for ln in outs["jax"].splitlines()
                               if ln.startswith("slo")]
