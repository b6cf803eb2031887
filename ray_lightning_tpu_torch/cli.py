"""The port's command line (``ray_lightning_tpu/cli.py``): the ``serve``,
``top``, ``goodput``, ``incidents``, ``requests``, ``lineage`` and
``profile`` subcommands.

    python -m ray_lightning_tpu_torch.cli serve --preset tiny \\
        --random-requests 8 --device cpu

stands up a continuous-batching engine on random weights from a seeded
``torch.Generator`` and serves token-id prompts (``--prompt "1,2,3"``,
repeatable, and ``--random-requests N``). With ``--replicas > 1``,
``--prefill-replicas > 0`` or ``--max-retries > 0`` it serves through a
:class:`~ray_lightning_tpu_torch.serving.LocalReplicaFleet`. It prints one
JSON row a request (``request_id``, ``finish_reason``, ``disposition``,
``retries``, ``ttft_s``, ``tokens``) and a ``summary`` row, as the JAX
package's does, without its ``compile_stats`` (the port has no jit caches).
``--cost`` then prints ``{"cost_summary": ...}``: both serving programs'
FLOPs, bytes and roofline verdict, counted on meta tensors of the engine's
shapes (``InferenceEngine.cost_summary``).
``--device`` (default ``cuda``) names the device; ``--preset`` names a
``LlamaConfig`` preset (``tiny``, ``small``, ``llama3_8b``, ...).
``--telemetry`` turns the flight recorder on and prints the Prometheus text
after the summary; with ``--telemetry-dir`` the engine's (or every fleet
replica's) request records, trace and metrics are written there too
(``requests.jsonl``, ``trace.json``, ``metrics.json``, ``metrics.prom``,
``lineage.jsonl``, ``summary.json``, ``events.jsonl``).

``top --dir <run>/telemetry`` renders a run's ``summary.json`` and the
last events of its ``events.jsonl`` (``--follow`` refreshes, ``--serve-port``
also serves ``metrics.prom`` to Prometheus); ``goodput`` prints the goodput
section and ``incidents`` lists the incident bundles (``--show`` one). The
files are the JAX package's, so each package renders the other's run
directories. ``requests --dir <dir>`` lists the slowest finished requests of
a ``requests.jsonl``; ``lineage --dir <dir> [rid]`` lists every request's
lineage or renders one request's hops (prefill, KV shipment, decode, retry
branches).

``profile --dir <run>/telemetry --steps N`` arms a coordinated
``torch.profiler`` capture: it writes ``profile_cmd.json``, which every rank
of the run polls, so that each opens its window at the same absolute global
step (``--at-step``, or the cluster's latest step plus ``--lead``); each
rank's trace lands under ``<run>/telemetry/profile/rank<k>/``. ``profile
--report`` renders the cost accounting, captures and step-time attribution
that the aggregator folded into ``summary.json``.

The JAX package's other subcommands are absent.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional

from ray_lightning_tpu_torch.observability.reqtrace import disposition_for

__all__ = ["disposition_for", "main"]

def _parse_prompt(spec: str) -> List[int]:
    try:
        tokens = [int(t) for t in spec.replace(" ", "").split(",") if t != ""]
    except ValueError:
        raise SystemExit(f"--prompt wants comma-separated token ids, got {spec!r}")
    if not tokens:
        raise SystemExit("--prompt must contain at least one token id")
    return tokens


def _cmd_serve(args) -> int:
    """Serve token-id prompts on random weights: one engine, or a fleet when
    retries, replicas or a prefill pool are asked for."""
    import numpy as np
    import torch

    from ray_lightning_tpu_torch import observability as _obs

    if args.telemetry:
        _obs.enable()

    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_lightning_tpu_torch.serving import (
        EngineConfig,
        InferenceEngine,
        LocalReplicaFleet,
        RequestShed,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here; pass --device cpu")
    preset = getattr(LlamaConfig, args.preset, None)
    if preset is None:
        raise SystemExit(f"unknown --preset {args.preset!r} (try: tiny, small)")
    cfg = preset()
    if args.fp32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)

    prompts = [_parse_prompt(p) for p in (args.prompt or [])]
    if args.random_requests:
        rng = np.random.default_rng(args.seed)
        for _ in range(args.random_requests):
            plen = int(rng.integers(1, args.max_prompt_len + 1))
            prompts.append(
                [int(t) for t in rng.integers(1, cfg.vocab_size, size=plen)]
            )
    if not prompts:
        raise SystemExit("nothing to serve: pass --prompt and/or --random-requests")
    too_long = [i for i, p in enumerate(prompts) if len(p) > args.max_prompt_len]
    if too_long:
        raise SystemExit(
            f"prompt(s) {too_long} exceed --max-prompt-len {args.max_prompt_len}"
        )

    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device,
    )
    engine_cfg = EngineConfig(
        num_slots=args.num_slots,
        max_prompt_len=args.max_prompt_len,
        max_len=args.max_len,
        temperature=args.temperature,
        eos_id=args.eos_id,
        seed=args.seed,
        kv_layout=args.kv_layout,
        block_size=16 if args.block_size is None else args.block_size,
    )
    fleet = None
    if args.max_retries > 0 or args.replicas > 1 or args.prefill_replicas > 0:
        # the request journal: a replica fault re-runs the request, and a
        # prefill pool ships KV to the decode pool
        try:
            fleet = LocalReplicaFleet(
                lambda: (params, cfg),
                engine_kwargs=dataclasses.asdict(engine_cfg),
                initial_replicas=args.replicas,
                max_retries=args.max_retries,
                prefill_replicas=args.prefill_replicas,
                device=device,
            )
        except ValueError as exc:  # e.g. --prefill-replicas without paged
            raise SystemExit(str(exc))
        engine = fleet._replicas[0]
    else:
        engine = InferenceEngine(params, cfg, engine_cfg, device=device)

    t0 = time.perf_counter()
    completions = []
    shed_rows = []
    submit = fleet.submit if fleet is not None else engine.submit
    for i, p in enumerate(prompts):
        try:
            completions.append(
                submit(
                    p,
                    max_new_tokens=args.max_new_tokens,
                    deadline_ms=args.deadline_ms,
                    priority=args.priority,
                )
            )
        except RequestShed:
            shed_rows.append({
                "request_id": f"prompt-{i}",
                "finish_reason": "shed",
                "disposition": "shed",
                "retries": 0,
                "ttft_s": None,
                "tokens": [],
            })
    if fleet is not None:
        for c in completions:
            try:
                c.result(timeout=300)
            except Exception:
                pass  # the row reports its disposition
    else:
        engine.run_until_idle()
    wall = time.perf_counter() - t0

    for c in completions:
        print(json.dumps({
            "request_id": c.request_id,
            "finish_reason": c.finish_reason,
            "disposition": (c.disposition if fleet is not None
                            else disposition_for(c.finish_reason)),
            "retries": c.retries if fleet is not None else 0,
            "ttft_s": round(c.ttft_s, 6) if c.ttft_s else None,
            "tokens": list(c.tokens),
        }))
    for row in shed_rows:
        print(json.dumps(row))
    total_tokens = sum(len(c.tokens) for c in completions)
    summary = {
        "requests": len(completions) + len(shed_rows),
        "generated_tokens": total_tokens,
        "shed": len(shed_rows),
        "wall_s": round(wall, 3),
        "tokens_per_sec": round(total_tokens / wall, 2) if wall > 0 else None,
        "kv_layout": engine.kv_layout,
        "slot_utilization": round(engine.slot_utilization(), 4),
        "pool": engine.pool.stats(),
    }
    if fleet is not None:
        summary["journal"] = fleet.stats()
    if engine.kv_layout == "paged":
        summary["block_utilization"] = round(
            engine.pool.block_utilization(), 4
        )
    print(json.dumps({"summary": summary}))
    if args.cost:
        # counted on meta tensors of the engine's shapes, off the loop
        print(json.dumps({"cost_summary": engine.cost_summary()}))
    if args.telemetry:
        reg = _obs.registry()
        if reg is not None:
            print(reg.prometheus_text())
        if args.telemetry_dir:
            from ray_lightning_tpu_torch.observability.aggregator import (
                write_local_dump,
            )

            # a fleet drains every live engine, so that a migrated request
            # lands both its prefill hop's and its decode hop's records
            records = (fleet.drain_request_records() if fleet is not None
                       else engine.drain_request_records())
            write_local_dump(args.telemetry_dir, _obs.get_recorder(), reg,
                             requests=records)
            print(json.dumps({"telemetry_dir": args.telemetry_dir}))
    if fleet is not None:
        fleet.shutdown()
    else:
        engine.shutdown(drain=False)
    return 0


def _cmd_profile(args) -> int:
    """Coordinate a fleet profile capture, or render the profile report.

    Without ``--report``: write ``profile_cmd.json`` into the run's
    telemetry directory. Every rank polls the file from its train loop and
    starts ``torch.profiler`` at the same absolute global step
    (``--at-step``, or the cluster's latest step plus ``--lead``). With
    ``--report``: render the cost/capture/attribution tables that the
    driver aggregator folded into ``summary.json``."""
    from ray_lightning_tpu_torch.observability import profiler as _profiler
    from ray_lightning_tpu_torch.observability.aggregator import _read_summary

    if args.report:
        print(_profiler.format_profile_report(_read_summary(args.dir)))
        return 0

    start = args.at_step
    if start is None:
        summary = _read_summary(args.dir)
        steps_max = (summary or {}).get("cluster", {}).get("steps_max")
        if steps_max is None:
            if summary is None:
                print(
                    f"no live summary under {args.dir} to anchor the start "
                    "step — pass --at-step N (absolute global step), or "
                    "start the run with TORCHRT_TELEMETRY=1"
                )
            else:
                print(
                    f"summary under {args.dir} has no live worker step "
                    "counter (finished or in-process run) — pass --at-step "
                    "N (absolute global step) to arm a future window"
                )
            return 1
        start = int(steps_max) + args.lead
    cmd = _profiler.write_profile_command(
        args.dir, num_steps=args.steps, start_step=start
    )
    print(
        json.dumps(
            {
                "profile_cmd": f"{args.dir}/{_profiler.PROFILE_CMD_FILE}",
                **cmd,
            }
        )
    )
    return 0


def _cmd_requests(args) -> int:
    """List the slowest finished requests of a run's ``requests.jsonl``
    (written by the driver aggregator or ``serve --telemetry-dir``)."""
    from ray_lightning_tpu_torch.observability import reqtrace

    path = os.path.join(args.dir, reqtrace.REQUESTS_FILE)
    records = reqtrace.read_requests(path)
    if not records:
        print(f"no request records found at {path}")
        return 1
    key = args.sort
    records.sort(key=lambda r: (r.get(key) or 0.0), reverse=True)
    if args.limit > 0:
        records = records[: args.limit]
    if args.json:
        for r in records:
            print(json.dumps(r))
        return 0
    cols = (
        ("request_id", 14), ("finish_reason", 8), ("disposition", 11),
        ("retries", 7), ("prompt_len", 6),
        ("tokens_out", 6), ("queue_wait_s", 12), ("prefill_s", 9),
        ("ttft_s", 8), ("total_s", 8), ("itl_p50_ms", 10),
        ("itl_max_ms", 10), ("deferred_ticks", 8), ("replica", 7),
        ("hop", 3), ("pool", 7), ("origin_replica", 6),
    )
    print("  ".join(f"{name:>{w}}" for name, w in cols))
    for r in records:
        cells = []
        for name, w in cols:
            v = r.get(name)
            if isinstance(v, float):
                v = f"{v:.4f}"
            cells.append(f"{'-' if v is None else v:>{w}}")
        print("  ".join(cells))
    return 0


def _cmd_lineage(args) -> int:
    """List every request's lineage in a run's ``requests.jsonl``, or render
    one request's cross-replica timeline (prefill hop, KV shipment, decode
    hop, retry branches)."""
    from ray_lightning_tpu_torch.observability import lineage as _lineage
    from ray_lightning_tpu_torch.observability import reqtrace

    path = os.path.join(args.dir, reqtrace.REQUESTS_FILE)
    lineages = _lineage.load_lineages(path)
    if not lineages:
        print(f"no request records found at {path}")
        return 1
    if args.rid is None:
        # every lineage, the multi-hop (migrated or retried) ones first
        rows = sorted(lineages.values(),
                      key=lambda lin: (-len(lin.hops), lin.base_rid))
        if args.json:
            for lin in rows:
                print(json.dumps(_lineage.summary(lin), sort_keys=True))
            return 0
        print(f"{'base_rid':>14}  {'hops':>4}  {'migr':>4}  {'retry':>5}  "
              f"{'complete':>8}  {'disposition':>11}  {'ttft_s':>8}")
        for lin in rows:
            s = _lineage.summary(lin)
            ttft = s.get("ttft_total_s")
            print(f"{lin.base_rid:>14}  {len(lin.hops):>4}  "
                  f"{s['migrations']:>4}  {s['retries']:>5}  "
                  f"{str(s['complete']):>8}  "
                  f"{s.get('disposition') or '-':>11}  "
                  f"{f'{ttft:.4f}' if ttft is not None else '-':>8}")
        return 0
    base = reqtrace.base_rid(args.rid)
    lin = lineages.get(base)
    if lin is None:
        print(f"no lineage for rid {args.rid!r} (base {base!r}) in {path}")
        return 1
    if args.json:
        print(json.dumps(_lineage.summary(lin), sort_keys=True))
        return 0
    print(_lineage.render(lin))
    return 0


def _cmd_goodput(args) -> int:
    """The goodput section that the aggregator folds into ``summary.json``:
    the fraction, seconds a category and the sources' breakdown."""
    from ray_lightning_tpu_torch.observability.aggregator import _read_summary

    summary = _read_summary(args.dir)
    gp = (summary or {}).get("goodput")
    if not gp:
        print(f"no goodput section in the summary under {args.dir} "
              "(needs a run with TORCHRT_TELEMETRY=1 that has reported "
              "beats)")
        return 1
    if args.json:
        print(json.dumps(gp, indent=2, sort_keys=True))
        return 0
    total = float(gp.get("total_s") or 0.0)
    print(f"goodput fraction: {gp.get('fraction', 0.0):.4f}  "
          f"({total:.1f}s classified wall time across sources)")
    print(f"{'category':<22}{'seconds':>12}{'share':>9}")
    for cat, secs in sorted(gp.get("by_category", {}).items(),
                            key=lambda kv: -kv[1]):
        share = (secs / total) if total > 0 else 0.0
        print(f"{cat:<22}{secs:>12.3f}{share:>9.1%}")
    per = gp.get("per_rank", {})
    if per:
        print()
        print(f"{'source':<18}{'wall(s)':>10}{'fraction':>10}  top categories")
        for key, info in sorted(per.items()):
            cats = sorted((info.get("seconds") or {}).items(),
                          key=lambda kv: -kv[1])[:3]
            tops = ", ".join(f"{c} {s:.1f}s" for c, s in cats)
            print(f"{key:<18}{info.get('wall_s', 0.0):>10.1f}"
                  f"{info.get('fraction', 0.0):>10.4f}  {tops}")
    return 0


def _cmd_incidents(args) -> int:
    """List the incident bundles under ``<dir>/incidents/``, or one
    bundle's contents with ``--show``."""
    from ray_lightning_tpu_torch.observability import incidents

    def when(ts) -> str:
        return (time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))
                if ts else "-")

    bundles = incidents.list_bundles(args.dir)
    if args.show is not None:
        match = [b for b in bundles if b["name"] == args.show]
        if not match:
            print(f"no incident bundle named {args.show!r} under {args.dir}")
            return 1
        detail = incidents.load_bundle(match[0]["path"])
        if args.json:
            print(json.dumps(detail, indent=2, sort_keys=True))
            return 0
        meta = detail.get("incident", {})
        print(f"bundle:  {match[0]['name']}")
        print(f"kind:    {meta.get('kind', '-')}")
        print(f"time:    {when(meta.get('ts'))}")
        ev = meta.get("event")
        if ev:
            print(f"trigger: {json.dumps(ev, sort_keys=True)}")
        print("files:")
        for name, info in sorted(detail.get("files", {}).items()):
            bits = ", ".join(f"{k}={v}" for k, v in sorted(info.items()))
            print(f"  {name:<24} {bits}")
        return 0
    if not bundles:
        print("no incident bundles under "
              f"{os.path.join(args.dir, incidents.INCIDENTS_DIRNAME)}")
        return 1
    if args.json:
        for b in bundles:
            print(json.dumps(b, sort_keys=True))
        return 0
    print(f"{'time':<20}{'kind':<24}{'files':>6}  name")
    for b in bundles:
        print(f"{when(b.get('ts')):<20}{b.get('kind', '-'):<24}"
              f"{len(b.get('files', [])):>6}  {b['name']}")
    return 0


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m ray_lightning_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command")
    tdir = "telemetry directory (e.g. <default_root_dir>/telemetry)"
    top = sub.add_parser(
        "top", help="live cluster summary from a run's telemetry directory")
    top.add_argument("--dir", required=True, help=tdir)
    top.add_argument("--follow", "-f", action="store_true",
                     help="keep refreshing until interrupted")
    top.add_argument("--interval", type=float, default=2.0,
                     help="refresh period seconds")
    top.add_argument(
        "--serve-port", type=int, default=None,
        help="also expose the run's metrics.prom at "
        "http://127.0.0.1:PORT/metrics for Prometheus scraping (0 picks an "
        "ephemeral port; see also TORCHRT_PROM_PORT for the endpoint in the "
        "main process)")
    goodput = sub.add_parser(
        "goodput", help="wall-time goodput breakdown (category seconds + "
        "fraction) from a run's telemetry directory")
    goodput.add_argument("--dir", required=True, help=tdir)
    goodput.add_argument("--json", action="store_true",
                         help="emit the raw goodput section")
    incidents = sub.add_parser(
        "incidents", help="list or inspect black-box incident bundles "
        "captured under <telemetry>/incidents/")
    incidents.add_argument("--dir", required=True, help=tdir)
    incidents.add_argument(
        "--show", default=None, metavar="BUNDLE",
        help="inspect one bundle by directory name instead of listing")
    incidents.add_argument("--json", action="store_true",
                           help="emit JSON instead of a table")
    requests_p = sub.add_parser(
        "requests", help="slowest finished requests from a run's "
        "requests.jsonl")
    requests_p.add_argument(
        "--dir", required=True,
        help="telemetry directory containing requests.jsonl")
    requests_p.add_argument(
        "--sort", default="ttft_s",
        choices=("ttft_s", "total_s", "queue_wait_s", "deferred_wait_s",
                 "prefill_s", "itl_p50_ms", "itl_max_ms", "tokens_out"),
        help="sort key (descending)")
    requests_p.add_argument("--limit", type=int, default=20,
                            help="show at most N requests")
    requests_p.add_argument("--json", action="store_true",
                            help="emit JSONL instead of a table")
    lineage_p = sub.add_parser(
        "lineage", help="cross-replica causal timeline for one request "
        "(prefill -> shipment -> decode hops, retry branches)")
    lineage_p.add_argument(
        "--dir", required=True,
        help="telemetry directory containing requests.jsonl")
    lineage_p.add_argument(
        "rid", nargs="?", default=None,
        help="request id (any attempt rid; resolved to its base lineage). "
        "Omit to list all lineages")
    lineage_p.add_argument("--json", action="store_true",
                           help="emit JSON summaries")
    profile_p = sub.add_parser(
        "profile",
        help="coordinate a fleet torch.profiler capture, or show the report",
    )
    profile_p.add_argument(
        "--dir", required=True,
        help="telemetry directory of the live run "
        "(e.g. <default_root_dir>/telemetry)",
    )
    profile_p.add_argument(
        "--steps", type=int, default=3, help="capture window length in steps"
    )
    profile_p.add_argument(
        "--at-step", type=int, default=None,
        help="absolute global step to start at (default: the cluster's "
        "latest step from summary.json plus --lead)",
    )
    profile_p.add_argument(
        "--lead", type=int, default=20,
        help="steps of headroom past the latest observed step, so every "
        "rank sees the command before the window opens",
    )
    profile_p.add_argument(
        "--report", action="store_true",
        help="render cost accounting / captures / step-time attribution "
        "from summary.json instead of arming a capture",
    )
    serve = sub.add_parser(
        "serve",
        help="continuous-batching inference demo on random-init params",
    )
    serve.add_argument(
        "--prompt",
        action="append",
        help='token-id prompt, e.g. --prompt "1,2,3" (repeatable)',
    )
    serve.add_argument(
        "--random-requests", type=int, default=0,
        help="additionally submit N random prompts",
    )
    serve.add_argument("--preset", default="tiny", help="LlamaConfig preset")
    serve.add_argument("--num-slots", type=int, default=4)
    serve.add_argument("--max-prompt-len", type=int, default=64)
    serve.add_argument("--max-len", type=int, default=256)
    serve.add_argument("--max-new-tokens", type=int, default=16)
    serve.add_argument(
        "--kv-layout", choices=("slot", "paged"), default="slot",
        help="KV cache layout: full row per request (slot) or block-paged "
        "with shared-prefix reuse (paged)",
    )
    serve.add_argument(
        "--block-size", type=int, default=None,
        help="paged layout block size in tokens (default 16; must divide "
        "--max-len)",
    )
    serve.add_argument("--temperature", type=float, default=0.0)
    serve.add_argument("--eos-id", type=int, default=None)
    serve.add_argument("--seed", type=int, default=0)
    serve.add_argument(
        "--deadline-ms", type=float, default=None,
        help="per-request TTL: past it the request is evicted (queued or "
        "decoding) with finish_reason=expired",
    )
    serve.add_argument(
        "--priority", type=int, default=0,
        help="admission class: 0 is never shed; >= 1 is sheddable under "
        "queue pressure",
    )
    serve.add_argument(
        "--replicas", type=int, default=1,
        help="> 1 serves through a multi-replica fleet (request journal + "
        "least-loaded routing)",
    )
    serve.add_argument(
        "--prefill-replicas", type=int, default=0,
        help="> 0 disaggregates the fleet: the first N replicas form the "
        "prefill pool and ship checksummed KV to the decode pool "
        "(requires --kv-layout paged and N < --replicas)",
    )
    serve.add_argument(
        "--max-retries", type=int, default=0,
        help="> 0 serves through the request journal (one-replica fleet): "
        "a replica fault re-runs the request up to this many times",
    )
    serve.add_argument(
        "--fp32", action="store_true", help="force float32 params/activations"
    )
    serve.add_argument(
        "--device", default="cuda",
        help="the device the engines run on: cuda (default) or cpu",
    )
    serve.add_argument(
        "--telemetry", action="store_true",
        help="enable spans/metrics and dump the Prometheus text exposition",
    )
    serve.add_argument(
        "--telemetry-dir", default=None,
        help="with --telemetry: write trace.json / summary.json / "
        "requests.jsonl to this directory on exit",
    )
    serve.add_argument(
        "--cost", action="store_true",
        help="also print both serving programs' counted FLOPs, bytes and "
        "roofline verdict (cost_summary)",
    )
    return parser


def main(argv: Optional[list] = None) -> int:
    """``top``, ``goodput``, ``incidents``, ``requests`` and ``lineage``
    read a run's telemetry directory; ``profile`` arms a coordinated
    capture in one, or renders its profile report; ``serve`` stands up a
    continuous-batching engine (or fleet) on random weights and serves
    token-id prompts."""
    parser = _parser()
    args = parser.parse_args(argv)
    if args.command == "top":
        from ray_lightning_tpu_torch.observability.aggregator import render_top

        return render_top(args.dir, follow=args.follow, interval=args.interval,
                          serve_port=args.serve_port)
    if args.command == "goodput":
        return _cmd_goodput(args)
    if args.command == "incidents":
        return _cmd_incidents(args)
    if args.command == "requests":
        return _cmd_requests(args)
    if args.command == "lineage":
        return _cmd_lineage(args)
    if args.command == "profile":
        return _cmd_profile(args)
    if args.command == "serve":
        return _cmd_serve(args)
    parser.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
