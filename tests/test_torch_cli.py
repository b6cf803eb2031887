"""The port's ``serve`` command (ray_lightning_tpu_torch/cli.py) on the CPU:
its rows equal the port's fleet (or engine) driven directly with the same
seed and flags; its row schema, dispositions and summary keys match the
JAX package's ``cli.main(["serve", ...])`` run with the same flags (the
summary without ``compile_stats``); its argument errors are JAX's;
``--telemetry`` and ``--telemetry-dir`` serve with the flight recorder on,
and ``--cost`` prints both serving programs' counted cost."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_lightning_tpu import cli as jax_cli
from ray_lightning_tpu.observability.reqtrace import (
    disposition_for as jax_disposition_for,
)
from ray_lightning_tpu_torch import cli
from ray_lightning_tpu_torch import observability as pobs
from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
from ray_lightning_tpu_torch.serving import (
    EngineConfig,
    InferenceEngine,
    LocalReplicaFleet,
)

pytestmark = pytest.mark.serving

ROOT = Path(__file__).resolve().parent.parent
BASE = ["serve", "--fp32", "--max-new-tokens", "5", "--random-requests", "4",
        "--max-prompt-len", "16", "--max-len", "32", "--seed", "3"]
# the JAX fleet needs --block-size (its default, None, fails in the fleet's
# affinity setup even on the slot layout); the port's default is 16
FLAG_SETS = {
    "engine": [],
    "fleet": ["--replicas", "2", "--max-retries", "1", "--block-size", "16"],
    "disagg": ["--replicas", "2", "--prefill-replicas", "1", "--kv-layout",
               "paged", "--block-size", "4"],
    "expired": ["--deadline-ms", "0", "--max-retries", "1", "--block-size",
                "16"],
    "prompts": ["--prompt", "1,2,3", "--prompt", " 4, 5 ", "--kv-layout",
                "paged"],
}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run(main, argv, capsys):
    assert main(argv) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    return lines[:-1], lines[-1]["summary"]


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_serve_schema_and_dispositions_match_jax(flags, capsys):
    port_rows, port_sum = _run(cli.main, BASE + FLAG_SETS[flags] +
                               ["--device", "cpu"], capsys)
    jax_rows, jax_sum = _run(jax_cli.main, BASE + FLAG_SETS[flags], capsys)
    assert [list(r) for r in port_rows] == [list(r) for r in jax_rows]
    for key in ("request_id", "finish_reason", "disposition", "retries"):
        assert [r[key] for r in port_rows] == [r[key] for r in jax_rows], key
    assert [len(r["tokens"]) for r in port_rows] == \
        [len(r["tokens"]) for r in jax_rows]
    assert set(jax_sum) - set(port_sum) == {"compile_stats"}
    assert set(port_sum) <= set(jax_sum)
    for key in ("requests", "generated_tokens", "shed", "kv_layout"):
        assert port_sum[key] == jax_sum[key], key
    if "journal" in jax_sum:
        for key in ("completed", "shed", "expired", "failed",
                    "quota_rejected", "open"):
            assert port_sum["journal"][key] == jax_sum["journal"][key], key
        assert ("migration" in port_sum["journal"]) == \
            ("migration" in jax_sum["journal"])


def _prompts(vocab, n, max_prompt, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(1, max_prompt + 1))
        out.append([int(t) for t in rng.integers(1, vocab, size=plen)])
    return out


@pytest.mark.parametrize("flags", ["engine", "fleet", "disagg"])
def test_serve_rows_equal_the_port_driven_directly(flags, capsys):
    rows, summary = _run(cli.main, BASE + FLAG_SETS[flags] +
                         ["--device", "cpu"], capsys)
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    paged = flags == "disagg"
    ecfg = EngineConfig(num_slots=4, max_prompt_len=16, max_len=32, seed=3,
                        kv_layout="paged" if paged else "slot",
                        block_size=4 if paged else 16)
    prompts = _prompts(cfg.vocab_size, 4, 16, 3)
    if flags == "engine":
        engine = InferenceEngine(params, cfg, ecfg, device="cpu")
        comps = [engine.submit(p, max_new_tokens=5) for p in prompts]
        engine.run_until_idle()
        want = [c.tokens for c in comps]
        assert summary["slot_utilization"] == round(
            engine.slot_utilization(), 4)
    else:
        fleet = LocalReplicaFleet(
            lambda: (params, cfg), engine_kwargs=dataclasses.asdict(ecfg),
            initial_replicas=2, max_retries=1 if flags == "fleet" else 0,
            prefill_replicas=1 if paged else 0, device="cpu")
        try:
            want = [fleet.submit(p, max_new_tokens=5).result(timeout=60)
                    for p in prompts]
        finally:
            fleet.shutdown()
        assert summary["journal"]["completed"] == 4
    assert [r["tokens"] for r in rows] == want
    assert all(r["disposition"] == "completed" for r in rows)
    assert summary["generated_tokens"] == 20


@pytest.mark.parametrize("flag", [["--telemetry"],
                                  ["--telemetry", "--telemetry-dir", "DIR"],
                                  ["--cost"]], ids=["telemetry", "dir", "cost"])
def test_unported_flags_are_refused(flag, capsys, tmp_path):
    """``--telemetry`` serves and prints the Prometheus text after the
    summary; with ``--telemetry-dir`` the run's files are written there;
    ``--cost`` (item 9c, ported) serves and then prints the cost summary of
    both serving programs, as the JAX package's does."""
    flag = [str(tmp_path / "t") if f == "DIR" else f for f in flag]
    argv = BASE + flag + ["--device", "cpu"]
    try:
        assert cli.main(argv) == 0
    finally:
        pobs.reset()
    out = capsys.readouterr().out
    if "--cost" in flag:
        lines = [json.loads(x) for x in out.splitlines()]
        assert "summary" in lines[-2] and lines[-2]["summary"]["requests"] == 4
        cost = lines[-1]["cost_summary"]
        assert set(cost) == {"serve_prefill", "serve_decode"}
        for rep in cost.values():
            assert rep["step_flops"] > 0 and rep["step_bytes"] > 0
            assert rep["roofline"]["verdict"] in ("compute-bound",
                                                  "bandwidth-bound")
        return
    assert "rlt_serve_requests_total 4" in out
    assert "rlt_serve_ttft_seconds_count 4" in out
    if "--telemetry-dir" in flag:
        run_dir = str(tmp_path / "t")
        assert json.loads(out.splitlines()[-1]) == {"telemetry_dir": run_dir}
        assert {"requests.jsonl", "trace.json", "metrics.json",
                "metrics.prom", "lineage.jsonl", "summary.json"} <= set(
            os.listdir(run_dir))


@pytest.mark.parametrize("argv", [
    ["--preset", "nope", "--random-requests", "1"],
    [],
    ["--prompt", "1,x"],
    ["--prompt", ","],
    ["--prompt", ",".join(["1"] * 70)],
    ["--random-requests", "1", "--replicas", "2", "--prefill-replicas", "1"],
], ids=["preset", "nothing", "bad", "empty", "too_long", "disagg_slot"])
def test_argument_errors_match_jax(argv):
    errors = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
        with pytest.raises(SystemExit) as exc:
            main(["serve"] + argv + extra)
        errors.append(str(exc.value.code))
    assert errors[0] == errors[1]


def test_disposition_for_matches_jax():
    for reason in ("eos", "length", "shed", "expired", "cancelled",
                   "migrated", "error", "quota", None, "other"):
        assert cli.disposition_for(reason) == jax_disposition_for(reason)


def test_module_entry_point_serves():
    out = subprocess.run(
        [sys.executable, "-m", "ray_lightning_tpu_torch.cli", "serve",
         "--device", "cpu", "--prompt", "1,2,3", "--max-new-tokens", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert lines[0]["disposition"] == "completed"
    assert len(lines[0]["tokens"]) == 2
    assert lines[-1]["summary"]["requests"] == 1
    no_cmd = subprocess.run(
        [sys.executable, "-m", "ray_lightning_tpu_torch.cli"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert no_cmd.returncode == 2 and "serve" in no_cmd.stdout
