"""The port's command line (``ray_lightning_tpu/cli.py``): the ``serve``
subcommand.

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
``--device`` (default ``cuda``) names the device; ``--preset`` names a
``LlamaConfig`` preset (``tiny``, ``small``, ``llama3_8b``, ...).

Not ported (ROADMAP.md, queue 1 item 9: observability): ``--telemetry``,
``--telemetry-dir`` and ``--cost`` exit non-zero, and the JAX package's other
subcommands are absent.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional

__all__ = ["disposition_for", "main"]

_UNPORTED = ("ROADMAP.md, queue 1 item 9: observability")


def disposition_for(finish_reason: str) -> str:
    """A finish reason as the client-facing disposition (completed, shed,
    expired, cancelled, migrated or failed), as the JAX package's
    ``observability/reqtrace.py`` collapses it."""
    if finish_reason in ("eos", "length"):
        return "completed"
    if finish_reason in ("shed", "expired", "cancelled", "migrated"):
        return finish_reason
    return "failed"


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
    refused = [flag for flag, on in (("--telemetry", args.telemetry),
                                     ("--telemetry-dir", args.telemetry_dir),
                                     ("--cost", args.cost)) if on]
    if refused:
        raise SystemExit(f"{', '.join(refused)}: not ported yet ({_UNPORTED})")

    import numpy as np
    import torch

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
    if fleet is not None:
        fleet.shutdown()
    else:
        engine.shutdown(drain=False)
    return 0


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m ray_lightning_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command")
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
        help=f"not ported yet ({_UNPORTED})",
    )
    serve.add_argument(
        "--telemetry-dir", default=None,
        help=f"not ported yet ({_UNPORTED})",
    )
    serve.add_argument(
        "--cost", action="store_true",
        help=f"not ported yet ({_UNPORTED})",
    )
    return parser


def main(argv: Optional[list] = None) -> int:
    """``serve``: stand up a continuous-batching engine (or fleet) on random
    weights and serve token-id prompts."""
    parser = _parser()
    args = parser.parse_args(argv)
    if args.command == "serve":
        return _cmd_serve(args)
    parser.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
