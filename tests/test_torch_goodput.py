"""The port's goodput ledger, anomaly detectors, incident recorder, request
lineage and JSONL file layer (``ray_lightning_tpu_torch/observability/``)
against the JAX package's on the same inputs: ledgers driven by one fake
clock, the fleet fold, detector verdicts on the same sample streams,
incident bundles (file by file), and lineages rebuilt from the same
``requests.jsonl``. Outputs are compared exactly, with only the run
directories' paths masked; wall clocks are fake or patched into each
module's ``time``. Every test resets both packages' process-global state."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from ray_lightning_tpu import observability as jobs
from ray_lightning_tpu.observability import anomaly as janomaly
from ray_lightning_tpu.observability import goodput as jgoodput
from ray_lightning_tpu.observability import incidents as jincidents
from ray_lightning_tpu.observability import lineage as jlineage
from ray_lightning_tpu.observability import metrics as jmetrics
from ray_lightning_tpu.observability import reqtrace as jreqtrace
from ray_lightning_tpu_torch import observability as pobs
from ray_lightning_tpu_torch.observability import anomaly as panomaly
from ray_lightning_tpu_torch.observability import goodput as pgoodput
from ray_lightning_tpu_torch.observability import incidents as pincidents
from ray_lightning_tpu_torch.observability import lineage as plineage
from ray_lightning_tpu_torch.observability import metrics as pmetrics
from ray_lightning_tpu_torch.observability import reqtrace as preqtrace

PKGS = {
    "jax": dict(goodput=jgoodput, anomaly=janomaly, incidents=jincidents,
                lineage=jlineage, metrics=jmetrics, reqtrace=jreqtrace),
    "torch": dict(goodput=pgoodput, anomaly=panomaly, incidents=pincidents,
                  lineage=plineage, metrics=pmetrics, reqtrace=preqtrace),
}


@pytest.fixture(autouse=True)
def reset_both(monkeypatch):
    for prefix in ("RLT_", "TORCHRT_"):
        for name in ("INCIDENT_MAX_BUNDLES", "INCIDENT_COOLDOWN_S",
                     "PROBE_INCIDENT_COOLDOWN_S", "LINEAGE_WINDOW_BYTES",
                     "EVENTS_MAX_BYTES", "METRICS_HISTORY"):
            monkeypatch.delenv(prefix + name, raising=False)
    jobs.reset()
    pobs.reset()
    yield
    jobs.reset()
    pobs.reset()


class Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _masked(obj, roots):
    """``obj`` with each run directory's path replaced by ``<run>``."""
    text = json.dumps(obj, sort_keys=True, default=str)
    for root in roots:
        text = text.replace(str(root), "<run>")
    return json.loads(text)


# --------------------------------------------------------------------- #
# goodput
# --------------------------------------------------------------------- #
def _ledger_script(goodput, clock, seed):
    rng = np.random.default_rng(seed)
    led = goodput.GoodputLedger("train", clock=clock)
    seen = []
    for _ in range(40):
        clock.t += float(rng.uniform(0, 3))
        cat = goodput.CATEGORIES[int(rng.integers(0, len(goodput.CATEGORIES)))]
        if rng.uniform() < 0.3:
            with led.phase(cat):
                clock.t += float(rng.uniform(0, 1))
                seen.append(("phase", led.current, led.snapshot()))
        else:
            led.enter(cat)
        seen.append((led.current, led.snapshot(), led.wall_s(),
                     led.fraction()))
    return led, seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ledgers_under_one_fake_clock_are_jax_s(seed):
    out = {}
    for pkg, mods in PKGS.items():
        clock = Clock(100.0)
        led, seen = _ledger_script(mods["goodput"], clock, seed)
        reg = mods["metrics"].MetricsRegistry()
        led.publish(reg)
        # a restart under the same name adopts the totals (new_ledger)
        mods["goodput"]._LEDGERS["train"] = led
        nxt = mods["goodput"].new_ledger("train")
        assert mods["goodput"].ensure_ledger("train") is nxt
        carried = nxt.snapshot(now=nxt._started)
        out[pkg] = (seen, reg.snapshot(), carried, sorted(
            mods["goodput"].ledgers()))
    assert out["torch"] == out["jax"]
    seen = out["torch"][0]
    cur, snap, wall, _ = seen[-1]
    assert abs(sum(snap.values()) - wall) < 1e-9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_is_jax_s(seed):
    rng = np.random.default_rng(seed)
    per = {}
    for key in [0, 1, "2/serve", "driver/arbiter"][:seed + 2]:
        cats = list(jgoodput.CATEGORIES)
        rng.shuffle(cats)
        per[key] = {c: float(rng.uniform(0, 50))
                    for c in cats[:int(rng.integers(1, 6))]}
    per["empty"] = {}
    assert pgoodput.fold(per) == jgoodput.fold(per)
    assert pgoodput.fold({}) == jgoodput.fold({})


def test_publish_all_rides_the_beat():
    for pkg, obs in (("jax", jobs), ("torch", pobs)):
        obs.enable()
    payloads = []
    for obs, goodput in ((jobs, jgoodput), (pobs, pgoodput)):
        for src, t in (("train", 5.0), ("serve", 2.0)):
            clock = Clock(0.0)
            led = goodput.GoodputLedger(src, clock=clock)
            goodput._LEDGERS[src] = led
            clock.t = t
            led.enter("productive_compute")
            clock.t = 3 * t
        payloads.append(obs.collect_beat_payload())
    assert payloads[0] == payloads[1]
    assert sorted(c[1] for c in payloads[1]["m"]["counters"]) == [
        [("category", "idle"), ("src", "serve")],
        [("category", "idle"), ("src", "train")],
        [("category", "productive_compute"), ("src", "serve")],
        [("category", "productive_compute"), ("src", "train")]]


# --------------------------------------------------------------------- #
# anomaly
# --------------------------------------------------------------------- #
def _stream(scenario, seed):
    """(kind, rank or None, value) samples and evaluate points."""
    rng = np.random.default_rng(seed)
    out = []
    if scenario == "step_shift":
        for i in range(60):
            out.append(("step", 0, 0.1 + float(rng.normal(0, 0.002))
                        + (0.2 if i >= 40 else 0.0)))
            out.append(("eval", None, None))
    elif scenario == "spike":
        for i in range(40):
            out.append(("step", 0, 0.1 + (1.0 if i == 25 else 0.0)))
            out.append(("eval", None, None))
    elif scenario == "itl":
        for i in range(60):
            out.append(("itl", None, 0.02 + float(rng.normal(0, 0.0005))
                        + (0.05 if 30 <= i < 45 else 0.0)))
            out.append(("eval", None, None))
    elif scenario == "straggler":
        for i in range(40):
            for r in range(3):
                slow = 2.5 if (r == 2 and i >= 12) else 1.0
                out.append(("step", r, 0.1 * slow + float(rng.uniform(0, 1e-3))))
            out.append(("eval", None, None))
    else:  # silent goodput, with and without a recent fault
        for i in range(40):
            frac = 0.8 if i < 20 else 0.4
            out.append(("gp", scenario == "silent_after_fault", frac))
    return out


@pytest.mark.parametrize("scenario", ["step_shift", "spike", "itl", "straggler",
                                      "silent", "silent_after_fault"])
def test_anomaly_verdicts_on_the_same_streams_are_jax_s(scenario):
    out = {}
    for pkg, mods in PKGS.items():
        clock = Clock(1000.0)
        mon = mods["anomaly"].AnomalyMonitor(clock=clock)
        reg = mods["metrics"].MetricsRegistry()
        events = []
        for kind, who, value in _stream(scenario, 7):
            clock.t += 1.0
            if kind == "step":
                mon.observe_step(who, value)
            elif kind == "itl":
                mon.observe_itl(value)
            elif kind == "eval":
                events.append(mon.evaluate(reg=reg))
            else:
                # a fault 10 s ago explains the drop
                events.append(mon.evaluate(
                    reg=reg, goodput_fraction=value,
                    last_fault_ts=clock.t - 10.0 if who else None))
        mon.drop_rank(0)
        out[pkg] = (events, reg.snapshot())
    assert out["torch"] == out["jax"]
    fired = [e["event"] for batch in out["torch"][0] for e in batch]
    want = {"step_shift": ["anomaly_step_time"], "spike": [],
            "itl": ["anomaly_itl_p99"], "straggler": ["anomaly_straggler"],
            "silent": ["anomaly_silent_goodput"], "silent_after_fault": []}
    assert fired == want[scenario]


def test_robust_z_and_baseline_are_jax_s():
    rng = np.random.default_rng(3)
    base = [float(v) for v in rng.normal(1.0, 0.1, 50)]
    for v in (0.5, 1.0, 1.7, 9.0):
        assert panomaly.robust_z(v, base) == janomaly.robust_z(v, base)
    bj, bp = janomaly.RollingBaseline(), panomaly.RollingBaseline()
    for v in [1.0] * 20 + [5.0] * 4 + [1.0] * 3:
        assert bp.add(v) == bj.add(v)
        assert bp.firing == bj.firing


# --------------------------------------------------------------------- #
# incidents
# --------------------------------------------------------------------- #
def _bundle_files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name)) as f:
            out[name] = f.read()
    return out


def _recorder(mods, run_dir, clock, **kw):
    reg = mods["metrics"].MetricsRegistry()
    events_path = os.path.join(run_dir, "events.jsonl")
    w = mods["reqtrace"].JsonlWriter(events_path)
    for i in range(50):
        w.write({"ts": 900.0 + i, "event": "tick", "i": i})
    w.close()
    reg.counter("rlt_serve_requests_total").inc(7)
    reg.histogram("rlt_step_time_seconds").observe(0.25)
    reg.push_history(now=950.0)
    rec = mods["incidents"].IncidentRecorder(
        run_dir, registry=reg, events_path=events_path, clock=clock,
        trace_provider=lambda: {"traceEvents": [{"name": "x", "ph": "i"}]},
        **kw)
    rec.register_source("membership_ledger", lambda: {"members": [0, 2]})
    rec.register_source("broken", lambda: 1 / 0)
    return rec, reg


def test_incident_bundles_are_jax_s_file_by_file(tmp_path):
    out = {}
    for pkg, mods in PKGS.items():
        run = tmp_path / pkg
        run.mkdir()
        clock = Clock(1000.0)
        rec, reg = _recorder(mods, str(run), clock, cooldown=60.0,
                             bundle_cap=3)
        paths = []
        for kind, dt in (("crash", 0), ("crash", 10), ("hang", 5),
                         ("crash", 70), ("anomaly_step_time", 1),
                         ("straggler", 1), ("hang", 200)):
            clock.t += dt
            paths.append(rec.maybe_capture(
                kind, event={"ts": clock(), "event": kind, "rank": 1},
                attachments={"probe_log.txt": "tail\n"}))
        bundles = mods["incidents"].list_bundles(str(run))
        files = {b["name"]: _bundle_files(b["path"]) for b in bundles}
        loaded = [mods["incidents"].load_bundle(b["path"]) for b in bundles]
        out[pkg] = _masked((
            [p is not None and os.path.basename(p) for p in paths],
            bundles, files, loaded, reg.snapshot()), [run])
    assert out["torch"] == out["jax"]
    names = [b["name"] for b in out["torch"][1]]
    assert names == ["1086_anomaly_step_time", "1087_straggler", "1287_hang"]
    assert out["torch"][0][1] is False  # the crash within the cooldown


def test_record_probe_failure_is_jax_s(tmp_path):
    """The probe failure's event, counter and bundle. The recorder it
    builds stamps the bundle with the real wall clock (its default clock),
    so the bundle's name and ``ts`` are masked."""
    out = {}
    for pkg, mods in PKGS.items():
        run = tmp_path / pkg
        first = mods["incidents"].record_probe_failure(str(run), "timeout",
                                                       "last line\n")
        again = mods["incidents"].record_probe_failure(str(run), "timeout")
        (bundle,) = mods["incidents"].list_bundles(str(run))
        files = _bundle_files(first)
        files["events.jsonl"] = [dict(json.loads(line), ts=None) for line in
                                 files["events.jsonl"].splitlines()]
        meta = json.loads(files.pop("incident.json"))
        meta["ts"] = meta["event"]["ts"] = None
        events = [dict(json.loads(line), ts=None) for line in
                  (run / "events.jsonl").read_text().splitlines()]
        out[pkg] = (again, bundle["kind"], bundle["files"], files, meta,
                    events, mods["metrics"].get_registry().snapshot())
    assert out["torch"] == out["jax"]
    assert out["torch"][0] is None  # the cross-run dedup


# --------------------------------------------------------------------- #
# the JSONL file layer and lineage
# --------------------------------------------------------------------- #
def _requests(seed):
    """Finished-request records of a fleet: plain, retried, migrated (one
    failed shipment), an orphan and clock-skewed ranks."""
    rng = np.random.default_rng(seed)
    recs = []
    t = 3000.0
    for i in range(12):
        base = f"req-{i}"
        kind = i % 4
        t += float(rng.uniform(0.1, 0.5))
        q, pre = float(rng.uniform(0, 0.05)), float(rng.uniform(0.05, 0.2))
        if kind == 0:
            recs.append({"request_id": base, "hop": 0, "start_ts": t,
                         "ts": t + 0.5, "total_s": 0.5, "finish_reason": "eos",
                         "replica": 0, "rank": 0, "queue_wait_s": q,
                         "prefill_s": pre, "ttft_s": q + pre + 0.01})
        elif kind == 1:
            recs.append({"request_id": base, "hop": 0, "start_ts": t,
                         "ts": t + 0.1, "finish_reason": "error",
                         "replica": 0, "rank": 0})
            recs.append({"request_id": base + "~r1", "hop": 1, "start_ts": t + 0.2,
                         "ts": t + 0.9, "finish_reason": "length", "replica": 1,
                         "rank": 1, "queue_wait_s": q, "prefill_s": pre,
                         "ttft_s": q + pre})
        elif kind == 2:
            recs.append({"request_id": base, "hop": 0, "start_ts": t,
                         "ts": t + 0.3, "total_s": 0.3,
                         "finish_reason": "migrated", "pool": "prefill",
                         "replica": 0, "rank": 0, "queue_wait_s": q,
                         "prefill_s": pre})
            recs.append({"request_id": base + "~m2", "base_rid": base,
                         "parent_rid": base, "hop": 1, "start_ts": t + 0.4,
                         "ts": t + 0.8, "finish_reason": "length",
                         "pool": "decode", "replica": 1, "rank": 1,
                         "transfer_s": 0.1, "ttft_s": 0.05,
                         "ttft_components": {"dispatch": 0.01,
                                             "queue_wait": q, "prefill": pre,
                                             "transfer": 0.1, "decode": 0.05},
                         "ttft_total_s": 0.16 + q + pre})
        else:  # a decode hop whose parent left no record
            recs.append({"request_id": base + "~m1", "base_rid": base,
                         "parent_rid": base, "hop": 1, "start_ts": t,
                         "ts": t + 0.2, "finish_reason": "eos", "rank": 2})
    return recs


@pytest.mark.parametrize("seed", [0, 1])
def test_lineages_from_the_same_requests_are_jax_s(seed, tmp_path, monkeypatch):
    out = {}
    records = _requests(seed)
    skew = {0: 0.0, 1: -0.25, 2: 1.5}
    for pkg, mods in PKGS.items():
        run = tmp_path / pkg
        monkeypatch.setenv("RLT_EVENTS_MAX_BYTES", "3000")
        monkeypatch.setenv("TORCHRT_EVENTS_MAX_BYTES", "3000")
        writer = mods["reqtrace"].JsonlWriter(
            str(run / mods["reqtrace"].REQUESTS_FILE))
        for rec in records:
            writer.write(rec)
        writer.close()
        path = str(run / "requests.jsonl")
        lineage = mods["lineage"]
        lins = lineage.load_lineages(str(run), skew)
        n = lineage.write_lineage(str(run / "lineage.jsonl"), lins)
        window = lineage.lineages_from_window(path, 2500, skew)
        out[pkg] = (
            writer.rotations, mods["reqtrace"].read_requests(path),
            mods["reqtrace"].read_requests(path, limit=3),
            mods["reqtrace"].read_window(path, 1500),
            mods["reqtrace"].read_window(path, 1500, rotated_floor=0.0),
            {b: lineage.summary(lin) for b, lin in lins.items()},
            {b: lineage.render(lin) for b, lin in lins.items()},
            lineage.chrome_events(lins), n,
            (run / "lineage.jsonl").read_text(),
            {b: lineage.summary(lin) for b, lin in window.items()},
        )
    assert out["torch"] == out["jax"]
    rotations, everything = out["torch"][0], out["torch"][1]
    assert rotations >= 1 and everything == records[-len(everything):]
    summaries = out["torch"][5]
    assert summaries["req-3"]["complete"] is False
    assert summaries["req-2"]["migrations"] == 1
    assert summaries["req-1"]["retries"] == 1


@pytest.mark.parametrize("rid", ["a", "a~r1", "a~r3", "a~m2", "a~x", "a~r"])
def test_rid_grammar_is_jax_s(rid):
    assert preqtrace.base_rid(rid) == jreqtrace.base_rid(rid)
    assert plineage._implied_parent(rid) == jlineage._implied_parent(rid)
    assert plineage._migration_number(rid) == jlineage._migration_number(rid)
    for reason in ("eos", "length", "shed", "expired", "error", "migrated"):
        assert (preqtrace.disposition_for(reason)
                == jreqtrace.disposition_for(reason))


@pytest.mark.parametrize("raw", [None, "100", "0", "junk"])
def test_file_layer_knobs_read_their_own_prefix(raw, monkeypatch):
    if raw is not None:
        monkeypatch.setenv("RLT_EVENTS_MAX_BYTES", raw)
        monkeypatch.setenv("RLT_LINEAGE_WINDOW_BYTES", raw)
        monkeypatch.setenv("RLT_INCIDENT_MAX_BUNDLES", raw)
        monkeypatch.setenv("RLT_INCIDENT_COOLDOWN_S", raw)
    # the JAX variables do not reach the port
    assert preqtrace.jsonl_max_bytes() == jreqtrace.DEFAULT_MAX_JSONL_BYTES
    assert plineage.lineage_window_bytes() == jlineage.DEFAULT_LINEAGE_WINDOW
    assert pincidents.max_bundles() == jincidents.MAX_BUNDLES_DEFAULT
    assert pincidents.cooldown_s() == jincidents.COOLDOWN_DEFAULT
    if raw is not None:
        monkeypatch.setenv("TORCHRT_EVENTS_MAX_BYTES", raw)
        monkeypatch.setenv("TORCHRT_LINEAGE_WINDOW_BYTES", raw)
        monkeypatch.setenv("TORCHRT_INCIDENT_MAX_BUNDLES", raw)
        monkeypatch.setenv("TORCHRT_INCIDENT_COOLDOWN_S", raw)
    assert preqtrace.jsonl_max_bytes() == jreqtrace.jsonl_max_bytes()
    assert plineage.lineage_window_bytes() == jlineage.lineage_window_bytes()
    assert pincidents.max_bundles() == jincidents.max_bundles()
    assert pincidents.cooldown_s() == jincidents.cooldown_s()
