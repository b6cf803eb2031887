"""The port's serving path with telemetry on (the engine's, the fleet's and
the replica group's metrics, events and request records, and the ``serve
--telemetry``, ``requests`` and ``lineage`` commands) against the JAX
package on the same tiny fp32 model and the same requests: the same record
keys, dispositions and token counts, equal ``rlt_serve_*`` and
``rlt_tenant_*`` counter values, the same lineages of a disaggregated
fleet, the same command-line text on either package's run directory, and
greedy streams token-identical with telemetry on and off.

Times differ between two runs, so the comparisons are of structure, counts
and sums; the JAX package's compile-cache series (``rlt_compile_*``), which
the port has no counterpart of, are left out."""
from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import pickle

import pytest
import torch

from ray_lightning_tpu import cli as jcli
from ray_lightning_tpu import observability as jobs
from ray_lightning_tpu.observability import aggregator as jagg
from ray_lightning_tpu.observability import lineage as jlineage
from ray_lightning_tpu.observability import slo as jslo
from ray_lightning_tpu.serving import LocalReplicaFleet as JaxFleet
from ray_lightning_tpu.serving import MigrationPolicy as JaxPolicy
from ray_lightning_tpu.serving import replica as jreplica
from ray_lightning_tpu.serving import tenancy as jtenancy
from ray_lightning_tpu_torch import cli as pcli
from ray_lightning_tpu_torch import observability as pobs
from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.observability import aggregator as pagg
from ray_lightning_tpu_torch.observability import lineage as plineage
from ray_lightning_tpu_torch.observability import slo as pslo
from ray_lightning_tpu_torch.serving import LocalReplicaFleet, MigrationPolicy
from ray_lightning_tpu_torch.serving import ReplicaGroup, RequestShed
from ray_lightning_tpu_torch.serving import replica as preplica
from ray_lightning_tpu_torch.serving import tenancy as ptenancy
from torch_fleet_helpers import save_model, saved_builder, wait_for
from torch_serving_helpers import (
    PAGED_KW,
    jax_engine,
    port_engine,
    random_requests,
    references,
    tiny_models,
    two_threads,
)

pytestmark = pytest.mark.serving

WAIT = 60.0
SERIES = ("rlt_serve_", "rlt_tenant_")


@pytest.fixture(scope="module")
def model():
    prev = two_threads()
    yield tiny_models()
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def reset_both(monkeypatch):
    for prefix in ("RLT_", "TORCHRT_"):
        for name in ("TELEMETRY", "TELEMETRY_DIR", "TRACE_SAMPLE",
                     "PROM_PORT", "FAULT"):
            monkeypatch.delenv(prefix + name, raising=False)
    jobs.reset()
    pobs.reset()
    yield
    jobs.reset()
    pobs.reset()


def series(obs):
    """The process registry's serving and tenant series: counter and gauge
    values, and each histogram's sample count."""
    snap = obs.registry().snapshot(delta=False)
    out = {}
    for kind in ("counters", "gauges"):
        for name, labels, value in snap[kind]:
            if name.startswith(SERIES):
                out[(kind, name, tuple(map(tuple, labels)))] = value
    for name, labels, h in snap["histograms"]:
        if name.startswith(SERIES):
            out[("histograms", name, tuple(map(tuple, labels)))] = h["count"]
    return out


def shape(records, drop=()):
    """Each record's keys (but ``drop``), id, disposition, finish reason and
    token count, in request-id order."""
    return sorted((r["request_id"], sorted(set(r) - set(drop)),
                   r["disposition"],
                   r["finish_reason"], r["tokens_out"], r.get("tenant"),
                   r["hop"], r.get("parent_rid"), r.get("pool"))
                  for r in records)


def _drive(engine, reqs, **kw):
    comps = [engine.submit(p, max_new_tokens=n, request_id=f"r{i}", **kw)
             for i, (p, n) in enumerate(reqs)]
    engine.run_until_idle()
    return [c.tokens for c in comps], [c.finish_reason for c in comps]


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #
ENGINES = {"paged": dict(), "slot": dict(kv_layout="slot"),
           "paged_spec": dict(speculate_k=4)}


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_engine_records_and_series_match_jax(model, case):
    jparams, jcfg, tparams, tcfg = model
    kw = ENGINES[case]
    reqs = random_requests(tcfg.vocab_size, 6, 11)
    if case == "paged_spec":  # repetitive prompts, so that proposals land
        reqs = [([5, 9, 5, 9, 5], n) for _, n in reqs[:4]]
    want = references(jparams, jcfg, reqs)
    off = port_engine(tparams, tcfg, **kw)
    off_streams, _ = _drive(off, reqs)
    assert off.drain_request_records() == []
    out = {}
    for name, obs, make, params, cfg in (
            ("jax", jobs, jax_engine, jparams, jcfg),
            ("torch", pobs, port_engine, tparams, tcfg)):
        obs.enable()
        engine = make(params, cfg, **kw)
        streams, reasons = _drive(engine, reqs)
        records = engine.drain_request_records()
        out[name] = (streams, reasons, shape(records), series(obs),
                     engine.drain_request_records())
        if name == "torch":
            port_records = records
        obs.reset()
    assert out["torch"] == out["jax"]
    streams = out["torch"][0]
    assert streams == want == off_streams
    assert len(port_records) == len(reqs)
    for rec in port_records:
        comps = rec["ttft_components"]
        assert set(comps) == {"queue_wait", "prefill", "decode"}
        assert abs(sum(comps.values()) - rec["ttft_s"]) < 1e-3
        assert rec["pool"] == "serve" and rec["itl_p50_ms"] >= 0
    got = out["torch"][3]
    assert got[("counters", "rlt_serve_tokens_total", ())] == sum(
        n for _, n in reqs)
    assert got[("counters", "rlt_serve_requests_total", ())] == len(reqs)
    if case == "paged_spec":
        assert got[("histograms", "rlt_serve_accepted_tokens", ())] > 0
    if case != "slot":
        assert ("gauges", "rlt_serve_kv_blocks_free", ()) in got


TENANTS = "gold:guaranteed:4,silver:standard:2,free:best_effort:1:0:3"


def test_tenant_series_quota_and_records_match_jax(model):
    """Per-tenant requests, quota refusals, completions, TTFT and queue
    depth: the same counts in both packages, and every record names its
    tenant."""
    jparams, jcfg, tparams, tcfg = model
    reqs = random_requests(tcfg.vocab_size, 12, 4)
    tenants = ["gold", "silver", "free", "free", "gold", "free",
               "silver", "free", "free", "gold", "free", "silver"]
    out = {}
    for name, obs, make, params, cfg, ten in (
            ("jax", jobs, jax_engine, jparams, jcfg, jtenancy),
            ("torch", pobs, port_engine, tparams, tcfg, ptenancy)):
        obs.enable()
        engine = make(params, cfg)
        engine.configure_tenants(ten.TenantRegistry(
            ten.parse_tenant_specs(TENANTS)))
        comps, refused = [], []
        for i, ((p, n), t) in enumerate(zip(reqs, tenants)):
            try:
                comps.append(engine.submit(p, max_new_tokens=n,
                                           request_id=f"r{i}", tenant=t))
            except ten.QuotaExceeded:
                refused.append(i)
        engine.run_until_idle()
        out[name] = ([c.tokens for c in comps], refused,
                     shape(engine.drain_request_records()), series(obs))
        obs.reset()
    assert out["torch"] == out["jax"]
    refused, records, got = out["torch"][1:]
    assert refused == [7, 8, 10]  # free's bucket holds 3
    assert {r[5] for r in records} == {"gold", "silver", "free"}
    assert got[("counters", "rlt_tenant_quota_rejected_total",
                (("tenant", "free"),))] == 3
    assert got[("histograms", "rlt_tenant_ttft_seconds",
                (("tenant", "gold"),))] == 3


def _burning_monitor(slo):
    clock = [0.0]
    mon = slo.SLOMonitor(clock=lambda: clock[0])
    for _ in range(20):
        mon.observe_latency("ttft_p95", 100.0)
        clock[0] += 1.0
    mon.evaluate()
    return mon


def test_slo_shed_expiry_and_errors_match_jax(model):
    """An SLO monitor burning serving budget sheds priority >= 1 work
    (``rlt_serve_shed_total``), a deadline of 0 ms expires a request
    (``rlt_serve_deadline_expired_total``, an ``"expired"`` record), and a
    shutdown without drain fails what is queued (``"failed"`` records)."""
    jparams, jcfg, tparams, tcfg = model
    reqs = random_requests(tcfg.vocab_size, 5, 8)
    out = {}
    for name, obs, make, params, cfg, slo in (
            ("jax", jobs, jax_engine, jparams, jcfg, jslo),
            ("torch", pobs, port_engine, tparams, tcfg, pslo)):
        obs.enable()
        engine = make(params, cfg)
        engine.slo_monitor = _burning_monitor(slo)
        assert engine._slo_breached()
        shed = 0
        with pytest.raises(Exception) as err:
            engine.submit(reqs[0][0], max_new_tokens=2, priority=1)
        shed += "shed" in type(err.value).__name__.lower()
        ok = engine.submit(reqs[0][0], max_new_tokens=3, request_id="keep")
        gone = engine.submit(reqs[1][0], max_new_tokens=3, request_id="late",
                             deadline_ms=0.0)
        engine.run_until_idle()
        engine.slo_monitor = None
        queued = [engine.submit(p, max_new_tokens=n, request_id=f"q{i}")
                  for i, (p, n) in enumerate(reqs[2:])]
        engine.shutdown(drain=False)
        out[name] = (shed, ok.tokens, gone.finish_reason,
                     [c.finish_reason for c in queued],
                     shape(engine.drain_request_records()), series(obs))
        obs.reset()
    assert out["torch"] == out["jax"]
    shed, _, expired, failed, records, got = out["torch"]
    assert shed == 1 and expired == "expired" and set(failed) == {"error"}
    assert got[("counters", "rlt_serve_shed_total", ())] == 1
    assert got[("counters", "rlt_serve_deadline_expired_total", ())] == 1
    assert {r[2] for r in records} == {"completed", "expired", "failed"}
    assert issubclass(RequestShed, Exception)


def test_sampling_drops_whole_requests_alike(model, monkeypatch):
    """Under ``TORCHRT_TRACE_SAMPLE`` (the JAX package's
    ``RLT_TRACE_SAMPLE``) both engines trace the same request ids."""
    jparams, jcfg, tparams, tcfg = model
    monkeypatch.setenv("RLT_TRACE_SAMPLE", "0.5")
    monkeypatch.setenv("TORCHRT_TRACE_SAMPLE", "0.5")
    reqs = random_requests(tcfg.vocab_size, 12, 2, lo=2, hi=3)
    out = {}
    for name, obs, make, params, cfg in (
            ("jax", jobs, jax_engine, jparams, jcfg),
            ("torch", pobs, port_engine, tparams, tcfg)):
        obs.enable()
        engine = make(params, cfg)
        _drive(engine, reqs)
        out[name] = sorted(r["request_id"]
                           for r in engine.drain_request_records())
        obs.reset()
    assert out["torch"] == out["jax"]
    assert 0 < len(out["torch"]) < len(reqs)


# --------------------------------------------------------------------- #
# the disaggregated fleet: hop records and lineages
# --------------------------------------------------------------------- #
def _fleet(model, package, **kw):
    jparams, jcfg, tparams, tcfg = model
    kw = dict(dict(engine_kwargs=PAGED_KW, max_retries=2,
                   initial_replicas=3, prefill_replicas=1), **kw)
    policy = {"send_timeout_s": WAIT, "admit_timeout_s": WAIT}
    if package == "torch":
        return LocalReplicaFleet(lambda: (tparams, tcfg), device="cpu",
                                 migration_policy=MigrationPolicy(**policy),
                                 **kw)
    return JaxFleet(lambda: (jparams, jcfg),
                    migration_policy=JaxPolicy(**policy), **kw)


def _lineage_view(lineages):
    out = {}
    for base, lin in lineages.items():
        out[base] = ([(h.rid, h.hop, h.parent_rid, h.disposition, h.pool)
                      for h in lin.hops], lin.complete, lin.orphan_hops(),
                     lin.migrations, lin.retries)
    return out


def _fleet_run(model, name, obs, reqs):
    obs.enable()
    fleet = _fleet(model, name)
    try:
        entries = [fleet.submit(p, max_new_tokens=n, request_id=f"f{i}")
                   for i, (p, n) in enumerate(reqs)]
        tokens = [e.result(timeout=WAIT) for e in entries]
        # the prefill hop's record is written when the pump's finish_export
        # reaches the prefill engine's loop: wait for every hop
        records = []
        wait_for(lambda: records.extend(fleet.drain_request_records())
                 or len(records) >= 2 * len(reqs), timeout=WAIT)
        stats = fleet.stats()
    finally:
        fleet.shutdown()
    got = series(obs)
    obs.reset()
    return tokens, records, stats, got


def test_disaggregated_fleet_lineages_match_jax(model):
    jparams, jcfg, _, tcfg = model
    reqs = random_requests(tcfg.vocab_size, 6, 21)
    want = references(jparams, jcfg, reqs)
    runs = {name: _fleet_run(model, name, obs, reqs)
            for name, obs in (("jax", jobs), ("torch", pobs))}
    views = {}
    for name, lin in (("jax", jlineage), ("torch", plineage)):
        tokens, records, stats, got = runs[name]
        assert tokens == want
        # whether a request waited for a prefill slot depends on how soon
        # the pump's threads freed one: the deferral's key is left out
        views[name] = (shape(records, drop=("deferred_wait_s",)),
                       _lineage_view(lin.build_lineages(records)),
                       {k: v for k, v in got.items()
                        if "migration" in k[1] and k[0] == "counters"})
    assert views["torch"] == views["jax"]
    _, records, stats, got = runs["torch"]
    lineages = plineage.build_lineages(records)
    assert len(lineages) == len(reqs)
    for lin in lineages.values():
        assert lin.complete and lin.migrations == 1
        assert [h.disposition for h in lin.hops] == ["migrated", "completed"]
        assert [h.pool for h in lin.hops] == ["prefill", "decode"]
    migration = stats["migration"]
    assert got[("counters", "rlt_serve_migration_verified_total", ())] == \
        migration["verified"] == len(reqs)
    assert got[("counters", "rlt_serve_migration_bytes_total", ())] == \
        migration["bytes_shipped"]
    decode_hops = [r for r in records if r["hop"] == 1]
    assert all(r["transfer_s"] >= 0 and "export_wait" in r["ttft_components"]
               for r in decode_hops)
    for rec in decode_hops:
        assert abs(sum(rec["ttft_components"].values())
                   - rec["ttft_total_s"]) < 1e-3


def _cli_text(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_requests_and_lineage_commands_print_what_jax_prints(model,
                                                             tmp_path):
    """Each package's fleet run dumped with its own ``write_local_dump``;
    on either run directory the port's ``requests`` and ``lineage``
    commands print the JAX package's text."""
    reqs = random_requests(model[3].vocab_size, 4, 31)
    dirs = {}
    for name, obs, agg in (("jax", jobs, jagg), ("torch", pobs, pagg)):
        obs.enable()
        fleet = _fleet(model, name, initial_replicas=2)
        try:
            for e in [fleet.submit(p, max_new_tokens=n, request_id=f"c{i}")
                      for i, (p, n) in enumerate(reqs)]:
                e.result(timeout=WAIT)
            records = []
            wait_for(lambda: records.extend(fleet.drain_request_records())
                     or len(records) >= 2 * len(reqs), timeout=WAIT)
            dirs[name] = str(tmp_path / name)
            agg.write_local_dump(dirs[name], obs.get_recorder(),
                                 obs.registry(), requests=records)
        finally:
            fleet.shutdown()
        obs.reset()
    for name, run_dir in dirs.items():
        assert {"requests.jsonl", "lineage.jsonl", "trace.json",
                "summary.json"} <= set(os.listdir(run_dir))
        for argv in (["requests", "--dir", run_dir],
                     ["requests", "--dir", run_dir, "--sort", "total_s",
                      "--limit", "3"],
                     ["requests", "--dir", run_dir, "--json"],
                     ["lineage", "--dir", run_dir],
                     ["lineage", "--dir", run_dir, "c2~m1"],
                     ["lineage", "--dir", run_dir, "c1", "--json"],
                     ["lineage", "--dir", run_dir, "nope"],
                     ["requests", "--dir", str(tmp_path / "empty")]):
            port = _cli_text(pcli.main, argv)
            assert port == _cli_text(jcli.main, argv), (name, argv)
        rc, text = _cli_text(pcli.main, ["lineage", "--dir", run_dir, "c0"])
        assert rc == 0 and "c0~m1" in text


SERVE = ["serve", "--fp32", "--max-new-tokens", "4", "--random-requests",
         "4", "--max-prompt-len", "16", "--max-len", "32", "--seed", "5",
         "--telemetry"]
SERVE_FLAGS = {
    "engine": ["--kv-layout", "paged", "--block-size", "4"],
    "disagg": ["--replicas", "2", "--prefill-replicas", "1", "--kv-layout",
               "paged", "--block-size", "4"],
}


@pytest.mark.parametrize("flags", sorted(SERVE_FLAGS))
def test_serve_telemetry_dir_leaves_the_jax_files(flags, tmp_path,
                                                  monkeypatch):
    """``serve --telemetry --telemetry-dir`` on either package: the same
    files, records of the same keys, dispositions and token counts, the
    same Prometheus families of the serving series. The command's fleet
    takes the default migration policy, whose 1 s send and 2 s admit
    timeouts the JAX engine's first shipment (its export and import
    compile then) can pass: both packages' defaults get generous timeouts
    here, so that no shipment is retried or falls back."""
    from ray_lightning_tpu.serving import migration as jmigration
    from ray_lightning_tpu_torch.serving import migration as pmigration

    for mod in (jmigration, pmigration):
        monkeypatch.setattr(mod, "MigrationPolicy", functools.partial(
            mod.MigrationPolicy, send_timeout_s=WAIT, admit_timeout_s=WAIT))
    out = {}
    for name, main, obs, extra in (("jax", jcli.main, jobs, []),
                                   ("torch", pcli.main, pobs,
                                    ["--device", "cpu"])):
        run_dir = str(tmp_path / name)
        rc, text = _cli_text(main, SERVE + SERVE_FLAGS[flags] + extra
                             + ["--telemetry-dir", run_dir])
        obs.reset()
        assert rc == 0
        families = sorted({line.split("{")[0].split(" ")[0]
                           for line in text.splitlines()
                           if line.startswith(SERIES)})
        with open(os.path.join(run_dir, "requests.jsonl")) as fh:
            records = [json.loads(line) for line in fh]
        with open(os.path.join(run_dir, "summary.json")) as fh:
            summary = json.load(fh)
        out[name] = (sorted(os.listdir(run_dir)),
                     shape(records, drop=("deferred_wait_s",)), families,
                     summary["cluster"].get("requests_total"),
                     json.loads(text.splitlines()[-1]))
    assert out["torch"][:4] == out["jax"][:4]
    files, records, families = out["torch"][:3]
    # events.jsonl is written at the first recorded event: a clean run of
    # either package records none
    assert {"requests.jsonl", "trace.json", "metrics.json", "metrics.prom",
            "lineage.jsonl", "summary.json"} <= set(files)
    hops = 2 if flags == "disagg" else 1
    assert len(records) == 4 * hops
    assert "rlt_serve_ttft_seconds_count" in families
    assert out["torch"][4] == {"telemetry_dir": str(tmp_path / "torch")}


# --------------------------------------------------------------------- #
# the replica group: telemetry beats, and the load tap that drops them
# --------------------------------------------------------------------- #
def test_replica_group_beats_records_the_tap_drops_like_jax(model,
                                                            tmp_path):
    """``ReplicaGroup(telemetry=True)``: the actor's beats carry its load,
    its metric deltas and trace events and its request records (``"r"``);
    the group's load tap keeps only the load, and the JAX package's tap
    keeps exactly the same from the same beats."""
    jparams, jcfg, tparams, tcfg = model
    path = str(tmp_path / "tiny.pt")
    save_model(path, tparams, tcfg)
    reqs = random_requests(tcfg.vocab_size, 3, 41)
    want = references(jparams, jcfg, reqs)
    group = ReplicaGroup(functools.partial(saved_builder, path),
                         engine_kwargs=dict(num_slots=2, max_prompt_len=16,
                                            max_len=48, max_queue=64),
                         num_replicas=1, device="cpu", heartbeat_interval=0.1,
                         actor_timeout=WAIT, telemetry=True)
    beats = []
    on_beat = group.tap.on_beat

    def recording(rank, step, wall, payload):
        beats.append((rank, step, wall, payload))
        on_beat(rank, step, wall, payload)

    group.tap.on_beat = recording
    try:
        group.start()
        futures = [group.submit(p, max_new_tokens=n) for p, n in reqs]
        assert [f.result(timeout=WAIT) for f in futures] == want
        wait_for(lambda: sum(len(b[3].get("r", ())) for b in beats)
                 >= len(reqs), timeout=WAIT)
    finally:
        group.shutdown()
        rt.shutdown()
    records = [r for b in beats for r in b[3].get("r", ())]
    assert sorted(r["request_id"] for r in records) == ["g0", "g1", "g2"]
    assert {r["disposition"] for r in records} == {"completed"}
    assert any("m" in b[3] for b in beats) and all(
        "load" in b[3] for b in beats)
    assert all(len(pickle.dumps(b)) > 0 for b in beats)
    taps = (preplica._LoadTap(), jreplica._LoadTap())
    for tap in taps:
        for b in beats:
            tap.on_beat(*b)
    assert taps[0].snapshot() == taps[1].snapshot() == {
        0: dict(beats[-1][3]["load"])}
    assert group.tap.snapshot() == taps[0].snapshot()
    for tap in taps + (group.tap,):
        assert all(set(v) == set(beats[-1][3]["load"])
                   for v in tap.loads.values())
