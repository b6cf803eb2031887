#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (ray_lightning_tpu_torch) on one card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero without the
final line):

1. device — the card's name and power limit; TF32 is switched off for
   matmuls and cuDNN so fp32 references mean fp32;
2. build — every ``csrc/*.cu`` kernel compiled from the checkout with nvcc
   (one process per source, all at once), timed; registers and spills
   (``nvcc -Xptxas -v``): the flash kernels' tensor-core (bf16)
   instantiations, two forward and four backward, and every instantiation
   of the paged decode, RMSNorm and argmax kernels must not spill;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it (and, for the flash kernels, at odd
   ones: ragged S, a window, non-causal, GQA group 4 at head dim 64,
   fp32, Qwen2.5's GQA group 7), with the stated tolerance; the kernel's,
   the plain version's and
   a library call's times (CUDA events around the replay of a CUDA graph
   of the calls, so the host's launch rate is out of them; the kernel's
   eager back-to-back time beside it as ``ms_eager``), every kernel's
   share of its bound and the flash kernels' TFLOP/s. RMSNorm is timed at
   the decode, prefill and training shapes, at ``generate_window``'s
   decode and prefill shapes, at a verify step's [32,4096], at
   Qwen2.5-7B's and Phi-3-mini's prefill and decode shapes and at [1,64]
   (the practical floor of a launch); flash forward also at
   ``generate_window``'s windowed prefill and at ``generate_longrope``'s
   (head dim 96); paged decode at ragged positions and at the full cache,
   at Qwen2.5-7B's group 7 (padded to the G 8 instantiation), bitwise
   repeatable, and replayed from a CUDA graph at new positions, bitwise
   equal to eager calls; the argmax sampler bitwise
   equal to torch.argmax on planted ties and planted NaNs (the first NaN
   wins), greedy and noisy, timed with L2 flushed (beside the HBM bytes
   bound) and hot, at batch 1, 8 and 64, and at every cluster size at
   batch 8; at the MoE path's vocabulary, [8,32000]; at a verify step's
   [32,128256] and at Qwen2.5's vocabulary, [8,152064];
4. serving main path — Llama-3-8B at full width and depth (random bf16
   weights from a seeded generator) served by the paged
   ``InferenceEngine``: 16 staggered requests of mixed lengths, some
   sharing a prefix, 32 new tokens each. Every request must complete, every
   decode step's logits must be finite, every serving kernel must have
   launched, and the launch counts must match the layer count. The same
   requests are then served again (the first 8, unprofiled and then under
   torch.profiler), which gives the
   device time by class (the port's kernels, matmuls, the rest) and the
   device's busy share;
4b. speculative serving (``serving_spec``) — the same weights and requests
   with ``speculate_k=4`` on the paged and then the slot layout: each tick
   verifies every slot's pending token and up to 3 prompt-lookup
   proposals in one ``decode_step_verify`` (fp32 attention in plain torch,
   no paged decode) and samples [32,128256] with the argmax kernel; the
   same checks, the acceptance rate, how many streams equal the
   ``speculate_k=0`` run's (printed only: bf16), and one verify step by
   graph replay beside its bytes bound and the one-token step;
4a. slot serving (``serving_slot``) — the same weights and requests on the
   slot layout (8 rows of 1024 positions, ``decode_step_ragged``: fp32
   attention over the dense rows in plain torch, no paged decode), with
   the same checks (no profiled rerun); then one decode step timed by
   graph replay beside its bytes bound, and the share of it that the
   layers' dense attention takes;
4c. disaggregated serving, tenancy and serving faults, on the main path's
   weights: ``serving_disagg`` — a prefill engine (``role="prefill"``,
   replica 0) and a decode engine (``role="decode"``, replica 1) share the
   card and one params dict, each on its loop thread (both on the default
   stream), and the main path's 16 staggered requests move between them
   through a few lines of pump (``drain_ready_exports``,
   ``export_shipment``, ``import_shipment``, ``finish_export``): every
   request ends ``"length"`` on the decode engine and ``"migrated"`` on the
   prefill engine, every shipment verifies, a corrupt copy of the first is
   refused with the receiver unchanged and its clean resend decodes, the
   launches are exact (flash only on the prefill engine, every decode step
   on the decode engine, paged decode over imported blocks), both pools end
   empty with no chain pinned; printed: the shipments' bytes, export,
   verify and import times, TTFT, tokens/s beside the colocated main
   path's, streams equal to its (bf16, not checked). ``serving_tenants`` —
   the paged engine with ``gold:guaranteed:4,silver:standard:2,
   free:best_effort:1:0:4``, 24 requests at once: free admitted 4 times and
   refused 4 (QuotaExceeded, no shed), gold and silver admitted 4:2 within
   a quantum while both are backlogged, a gold deadline running out
   mid-decode (``"expired"``, partial tokens, blocks released), exact
   launches, TTFT per tenant. ``serving_faults`` — ``TORCHRT_FAULT``
   ``replica0:drop-stream@req2:4,replica0:slow-decode@every:4:0.05`` with
   every request a ``RequestJournal`` entry (the dropped stream resumed on
   the same engine as ``~r1`` to 32 tokens; stalled ticks' times beside the
   others'), then ``replica0:crash@tick8`` on the loop thread (the loop
   dies, ``alive`` False, the requests in flight fail with ServeFault, 8
   more submitted to the dead engine handed back by ``handback_queued``;
   the dead engine dropped, the card's memory back; a fresh engine serves
   the journal's resumptions and the handed-back requests). These paths'
   time, with ``disagg_exactness``, beside a 60 s budget;
4d. the replica fleet on the main path's weights (``serving_fleet``): a
   ``LocalReplicaFleet`` of a prefill and two decode replicas sharing one
   params dict serves the 16 staggered requests (each ends ``"length"``
   with 32 tokens, 16 migrated by the fleet's pump with no fallback, both
   decode replicas routed to, the launches exact summed per engine, the
   logits finite, every pool empty with no chain pinned; tokens/s and TTFT
   beside the colocated main path's and ``serving_disagg``'s hand pump);
   then two homogeneous replicas under ``replica0:crash@every:24`` with
   retries and a breaker (every request to its length, none failed,
   retries and a relaunch, the allocated memory back to its level before
   the fleet after the shutdown); then the ``Autoscaler`` over a
   one-replica fleet and a burst of 24 (a scale-up, every request done,
   idle ticks back to one replica and the memory to the one-replica level;
   each ``add_replica``'s time). Then (``fleet_exactness``) fp32 at those
   widths, 2 layers: a disaggregated fleet under a kill loop, a corrupt
   shipment and a crash mid-admit gives every stream equal to
   ``generate``'s and iterated plain ``forward``'s. Both beside a 45 s
   budget;
5. serving exactness — the same engine in fp32 at full width, cut to 2
   layers: its greedy tokens must equal iterated full ``forward`` calls
   through the plain versions; then (``slot_exactness``) the slot engine's
   greedy tokens must equal the paged engine's, the port's batched
   ``generate`` and iterated plain ``forward``; (``disagg_exactness``) the
   migrated streams of a prefill/decode pair must equal the colocated
   engine's, ``generate``'s and iterated plain ``forward``, a shipment's payload the cache's
   blocks bitwise, and a journaled drop-stream resumption the unfaulted
   stream; then (``spec_exactness``)
   on prompts of repeated segments, on both layouts, the ``speculate_k=4``
   engine's greedy streams must equal the ``speculate_k=0`` engine's, with
   more tokens accepted than slot verify ticks;
5c. windowed generation (``generate_window``) — Mistral-7B-v0.1's published
   config (vocab 32000, dim 4096, 32 layers, 32 query / 8 KV heads, ffn
   14336, window 4096) through the port's ``config_from_hf``, random bf16
   weights, ``generate`` on 4 prompts of 4608 tokens with 64 greedy new
   tokens: the rolling cache is [32, 4, 8, 4096, 128], prefill scatters and
   decode wraps, tokens in the vocabulary, logits finite, launch counts as
   the layer count says; prefill time and decode tokens/s; then runs
   with an ``eos_id`` that never fires alternating with runs without (the
   cost of the host's reads of the finished flag). Then
   (``window_exactness``) fp32 at those widths with the window cut to 64, 2
   layers: ``generate`` on 100-token prompts with 40 new tokens must equal
   iterated plain windowed ``forward``;
5d. yarn serving (``serving_qwen_yarn``) — Qwen2.5-7B-Instruct's published
   config (vocab 152064, dim 3584, 28 layers, 28 query / 4 KV heads: GQA
   group 7, ffn 18944, qkv bias, rope theta 1e6, yarn x4 over 32768, as its
   model card documents for long inputs) through ``config_from_hf``, random
   bf16 weights and biases, on the paged engine and the main path's
   requests, with the same checks and a decode step by graph replay; paged
   decode runs at G 7, argmax at V 152064. Then (``qwen_exactness``) fp32
   at those widths, 2 layers: the engine's greedy tokens must equal
   iterated plain ``forward``;
5e. longrope generation (``generate_longrope``) — Phi-3-mini-128k-
   instruct's widths (vocab 32064, dim 3072, 32 layers, 32 / 32 heads of
   dim 96, ffn 8192, longrope over 4096 pretrain positions, x32) through
   ``config_from_hf``, with deterministic placeholder factor lists (the
   published ones are not in the repository), random bf16 weights:
   ``generate`` on 4 prompts of 4608 tokens with 64 new, past 4096, so one
   table of the long factors serves prefill and decode; tokens, finite
   logits, launch counts, prefill time and decode tokens/s. Then
   (``longrope_exactness``) fp32, 2 layers: ``generate`` on prompts of 4100
   tokens equals iterated plain ``forward``;
5a. MoE serving (``serving_moe``) — Mixtral-8x7B-v0.1's published widths
   (vocab 32000, dim 4096, 32 query / 8 KV heads, ffn 14336, 8 experts
   top-2) through the port's ``mixtral_config_from_hf``, cut to 16 layers
   (23.5 B parameters, ~47 GB bf16; 32 layers do not fit in 80 GB), random
   bf16 weights from a seeded generator, on the serving main path's engine
   and requests, with the same checks and the profiled rerun; then one
   decode step of 8 rows timed by graph replay beside its bytes bound
   (lossless routing reads every weight);
5b. MoE exactness — fp32, the same widths cut to 2 layers: the engine's
   greedy tokens (lossless routing through the kernels) must equal iterated
   ``forward(plain=True)`` calls, which route with the capacity bound at
   ``capacity_factor = E / top_k`` (it never binds);
6. training main path — ``Trainer.fit`` of ``LlamaModule(LlamaConfig.
   small())`` (0.89 B parameters, full width and depth, bf16, per-layer
   remat, chunked loss) on ``SyntheticLMDataModule`` at batch 8 x 2048:
   one warm-up step, 10 measured steps, one step under torch.profiler,
   then validation. Every loss must be finite, the last below the first,
   and the launch counts must match the layer count; step time, tokens/s,
   MFU, peak memory and the profiled step's device time by class;
7. training exactness — fp32, the small widths cut to 2 layers, batch 2 x
   2048: the loss and every gradient through the kernels must match
   ``plain=True`` on the card, and three Trainer steps must give the same
   losses;
8. remat variants — the training main path's configuration under
   ``remat_policy="dots"`` and with remat off, 6 steps each: step time,
   peak memory and launch counts;
9. training, complete Trainer — ``Trainer.fit`` of ``LlamaConfig.small()``
   at full width and depth with fp32 master weights,
   ``precision="bf16-mixed"``, remat "dots", two micro-batches of 4 x 2048
   per update (``accumulate_grad_batches=2``), a global-norm clip,
   ``ThroughputMonitor`` and ``EarlyStopping``, through
   ``SingleDeviceStrategy``'s side-stream input pipeline: one warm-up
   update, 10 measured updates, one update under torch.profiler, then
   validation. Losses finite and falling, masters still fp32, bf16 tensors
   into ``training_step``, ``global_step`` counting micro-batches, launch
   counts per micro-batch as the main path's per step, a finite MFU from
   the callback; update time, tokens/s, MFU, peak memory and the profiled
   update's device time by class;
10. complete-Trainer exactness — fp32 masters, 2 layers, batch 2 x 2048:
   "dots" against "nothing" (1e-6), bf16-mixed through the kernels against
   the plain versions (``MIXED_TOL``), and an accumulation of two
   micro-batches of 1 against one update on the batch of 2 (1e-5);
11. MoE training (``train_moe``) — ``Trainer.fit`` of ``LlamaModule`` on
   Mixtral-8x7B widths through ``mixtral_config_from_hf`` (dim 4096, 32 / 8
   heads of 128, 8 experts of ffn 14336 top-2, vocab 32000) with the
   training values capacity factor 1.5 and ``moe_aux_weight`` 0.01, depth
   cut to 2 layers so that fp32 masters and AdamW fit on one 80 GB card,
   bf16-mixed, per-layer remat, batch 2 x 2048, 8 steps and one validation
   batch: finite losses, ``train_moe_aux`` and ``val_moe_aux`` logged, the
   exact launch counts; the median step, tokens/s and peak memory. Then
   (``moe_train_exactness``) fp32 at narrow widths, 2 layers: the loss, the
   auxiliary loss and every gradient on the card equal the CPU's;
12. the Ray strategies on one card (``train_ray_ddp``) — the training main
   path's model (``LlamaConfig.small()``, bf16, batch 8 x 2048, 6 steps)
   through ``RayStrategy(num_workers=1, use_gpu=True)``: a worker process,
   forked from the zygote (booted before the training phases), owns the
   card in an NCCL group of world size 1; then
   ``RayShardedStrategy(zero_stage=3)`` and ``HorovodRayStrategy`` the same
   way. The weights each run sends back equal a ``SingleDeviceStrategy``
   run of the same seed (bitwise, or within 2^-7 of a leaf's max); the step
   median beside the single-device one, the launcher's start-up and the
   weights' way back; the workers' launch counts;
13. two ranks on one card (``ray_two_ranks``) — two worker processes over
   gloo (NCCL refuses two ranks on one device), a narrow fp32 config, one
   AdamW step of 2 rows each: both ranks hold the same parameters, equal to
   one process stepping on the global batch of 4 within 1e-5; for
   ``RayStrategy`` and ``RayShardedStrategy`` at stages 1, 2 and 3; the
   first fit's workers boot as fresh interpreters, then the same fit and
   the others fork theirs from the zygote (``TORCHRT_ZYGOTE=1``, warm
   since before the training phases; warmed here when this phase runs
   alone), and both start-ups are printed. Beside
   the kernel checks, the kernels are held against their plain versions at
   these paths' shapes (RMSNorm [4096,4096] bf16 and flash q [2,32,2048,128]
   forward and backward, timed; the two-rank fp32 shapes, checked);
14. expert parallelism (``ray_ep``) — ``train_ray_ep``: Mixtral-8x7B
   widths cut to 1 layer (1.713 B parameters), capacity factor 1.5, aux
   weight 0.01, fp32 masters, bf16-mixed, AdamW, remat, batch 2 x 2048,
   4 steps and one validation batch, first in the main process twice (the
   reference, then one process that sums the experts in the ep run's
   order), then through ``RayStrategy(num_workers=2, mesh_spec=
   MeshSpec(axes={"ep": 2}))``: two workers, forked from the zygote, share
   the card over gloo, each holding 4 of the 8 experts; losses within 1e-3 relative of the
   reference's, the returned weights (every expert) against the ep-order
   run's: no element past 2^-7 of its leaf's max and each leaf's update
   within 1e-2 in norm (their gap to the reference printed beside the two
   references' own); every step of the worker beside the reference's, the ep
   collectives' host time in a profiled step, start-up, the experts'
   gather and the weights' way back; the workers' launches. Then
   ``ep_exactness``: fp32 at narrow widths, one SGD step at lr 1, {"ep": 2}
   at world 2, {"dp": 2, "ep": 2} at world 4 at stage 0 and ZeRO 3, and
   {"ep": 2} at capacity factor 1.5: each equal to one process on the
   global batch within 1e-5, their worker groups forked from the zygote.
   The kernel phase holds paged decode at its
   repaired shapes (G 16; head dims 80 and 96) and times flash at Qwen2.5's
   G 7;
15. the tune integration (``tune``) — ``tune_asha``: ``tune.run`` over lr
   in {3e-4, 1e-3, 0} with ``ASHAScheduler(grace_period=1,
   reduction_factor=2, max_t=4)``, two trials at a time
   (``resources_per_trial={"CPU": 2, "GPU": 0.5}``), each a trial process
   fitting the training path's model (``LlamaConfig.small()``, bf16, batch
   8 x 2048, 6 steps, a validation batch every 2) through
   ``RayStrategy(num_workers=1, use_gpu=True, resources_per_worker={"GPU":
   0.5})`` and reporting through ``TuneReportCallback``: every trial
   TERMINATED or STOPPED, finite rows, a TERMINATED trial's 3 rows and its
   worker's exact launches, the lr 0 trial started after both others'
   rung-1 reports and stopped by ASHA before its third; ``tune_pbt``: PBT
   over three narrow fp32 trials at once (``two_rank_config``, one worker
   each, a checkpoint and a report at every step through
   ``TuneReportCheckpointCallback``): some trial exploits a donor and its
   parameters after the restore equal the donor's checkpoint bitwise; the
   checkpoint's bytes and its way to the trial directory. After each
   sweep no process of it runs or holds the card and the card's used
   memory is back within 1 GiB; the phases' time beside their 150 s
   budget;
16. a Ray fit that survives a crash and a hang (``faults``; every worker
   group and relaunch forked from the zygote) — ``train_ray_faults``: the training path's model (``LlamaConfig.small()``,
   bf16, remat, AdamW, batch 8 x 2048, epochs of 4 steps, 8 steps) through
   ``RayStrategy(num_workers=1, use_gpu=True)``, first without a fault
   (the reference), then with ``max_failures=2, hang_timeout=10.0,
   heartbeat_interval=1.0``, a ``ModelCheckpoint`` at the first epoch's end
   (``every_n_epochs=2``) and
   ``TORCHRT_FAULT="rank0:crash@step5,rank0:hang@step7"`` fused: the crash
   relaunches the group from the step-4 checkpoint, the supervisor declares
   the hang, kills the group, and the relaunch resumes from it again.
   Exactly two relaunches, both fuses blown, ``global_step`` 8, the weights
   bitwise the reference's, the last group's exact launches; each fault's
   time to the next group's first step, the detection time beside
   ``hang_timeout``, the checkpoint's bytes and write time, the step median
   with heartbeats against the reference's. ``train_ray_zero_resume``:
   ``ray_two_ranks``' narrow fp32 config through
   ``RayShardedStrategy(num_workers=2, zero_stage=3, max_failures=1)`` over
   gloo on the card, ``rank1:crash@step3`` fused, a checkpoint at each
   2-step epoch's end: the weights bitwise those of an uninterrupted ZeRO-3
   fit of the same world, and the step-2 checkpoint's whole optimizer
   states (SGD with momentum: ``MomentumLlama``) within 1e-6 of a
   one-process fit's on the global batch. After the phase no worker process
   runs or holds the card and its used memory is back within 1 GiB; the
   phase's time beside its 150 s budget. In the tune and faults phases
   the tune queue and the heartbeat queue of every Ray path must be the
   native shared-memory ring and the trainer's payload a native store
   segment: a fallback to the actor queue fails the run;
17. elastic membership (``elastic``) — ``train_ray_elastic``: the training
   path's model (``LlamaConfig.small()``, bf16, remat, AdamW) through
   ``RayStrategy(num_workers=2, use_gpu=True, elastic=True, min_workers=1,
   max_failures=0, hang_timeout=10.0, heartbeat_interval=1.0)``, two
   workers forked from the zygote sharing the card over gloo at 4 x 2048
   rows each, 3 epochs of
   2 steps, ``TORCHRT_FAULT="rank1:crash@step3"`` fused: the group shrinks
   to the survivor without a relaunch and a spare forked from the zygote
   joins at the next epoch boundary from the survivor's handoff. The fit
   finishes with ``max_failures=0``; the worlds are {1, 2}; one survivor
   pid runs through every epoch; three processes in all; the last epoch at
   world 2; ``resizes == {"shrink": 1, "grow": 1}``; the members' weights
   bitwise equal; the weights within 2^-7 of a leaf's max of one process
   training the recorded global batches in order with the group's
   arithmetic (``elastic_replay``); RMSNorm and the three
   flash kernels launched in the workers; the heartbeat queue the ring.
   Printed: the crash to the survivor's first step at world 1, the spare's
   spawn, the handoff's bytes, write and read, the grow to the first step
   at world 2, the step median at each world. After the phase no worker
   or zygote process is left and the card's used memory is back within
   1 GiB; the phase's time beside its 90 s budget;
18. the replica group (``fleet``, run before ``elastic``, whose clean-up
   ends the zygote) — a ``ReplicaGroup`` of two
   ``ServeReplicaActor`` processes forked from the zygote, each building
   Llama-3-8B widths cut to 8 layers (bf16, a seeded generator, ~5.6 GB)
   with the main path's engine settings: 16 requests reach both replicas
   and ``check()`` finds them ok; replica 1 is SIGKILLed mid-decode,
   ``check()`` relaunches it, its requests resume to full length
   (``relaunches_total == 1``); each live actor's own launch counts exact
   for its prefills and decode steps; 8 more requests and a
   ``remove_replica()`` drop nothing; after the shutdown no process of the
   group is left and the card's used memory is back. Printed: the forked
   start-up, the kill to the relaunched replica's first beat, tokens/s,
   the phase's time beside a 45 s budget;
19. the ``kernels`` JSON line (launches from the main paths: serving,
   serving_slot, serving_spec, serving_spec_slot, serving_disagg,
   serving_tenants, serving_faults, serving_fleet, fleet_exactness,
   fleet, generate_window,
   serving_qwen_yarn, generate_longrope, serving_moe, training,
   training_complete, train_moe, train_ray_ddp, train_ray_zero3,
   train_ray_horovod, ray_two_ranks, train_ray_ep, ep_exactness, tune_asha,
   tune_pbt, train_ray_faults, train_ray_zero_resume, train_ray_elastic;
   the Ray and tune
   paths from the workers' counts, which each worker process keeps from 0
   and the launcher sums; a relaunched path's from its last group), the
   card line, and the final ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --phases kernels,ray_ep`` runs the named phases
alone and prints no result: a rehearsal of a phase.

Timings are printed beside the card's name and power limit; they are this
card's numbers, and the fields are described in PERF.md.
"""
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

try:  # the classes below ship to worker processes by reference
    from ray_lightning_tpu_torch.callbacks import Callback as _Callback
    from ray_lightning_tpu_torch.callbacks import (
        ModelCheckpoint as _ModelCheckpoint,
    )
    from ray_lightning_tpu_torch.models.llama import LlamaModule as _LlamaModule
    from ray_lightning_tpu_torch.tune import ASHAScheduler as _ASHAScheduler
except ImportError:  # a directory without the port: main() fails loudly
    _Callback = _ModelCheckpoint = _LlamaModule = _ASHAScheduler = object

T0 = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # dense tensor-core bf16
FP32_FLOPS = 67e12             # fp32 outside the tensor cores


def log(msg):
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3, cold=False, graph=True):
    """Mean device time of one call, from CUDA events around ``iters``
    calls. ``graph``: the calls are captured once in a CUDA graph and the
    events time its replay, so the time is the device's alone; otherwise
    they time back-to-back eager calls, which read the host's launch rate
    wherever a call takes the device less time than the host takes to issue
    it. Inputs stay hot in L2 where they fit. ``cold`` writes 64 MB before
    each call to evict L2 (for inputs the main path finds cold, as decode
    finds a layer's KV cache) and subtracts that write's own time, measured
    the same way."""
    if not cold:
        return _timed(torch, fn, iters, warmup, graph)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def flushed():
        flush.zero_()
        fn()

    return (_timed(torch, flushed, iters, warmup, graph)
            - _timed(torch, flush.zero_, iters, warmup, graph))


def _timed(torch, fn, iters, warmup, graph):
    # warm-up on a side stream, so allocations and library handles are made
    # before any capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()  # the first replay uploads the graph
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    torch.cuda.synchronize()
    # cuBLAS keeps a workspace for every stream it has run on (here the side
    # and the capture streams): free them, or they stay allocated and count
    # in the training path's peak memory
    torch._C._cuda_clearCublasWorkspaces()
    return start.elapsed_time(end) / iters


def bound(bytes_moved, flops, flop_rate):
    """Least time (ms) for the work: the larger of bytes over the HBM rate
    and operations over the peak rate for their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def within(a, b, atol, rtol):
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def _template_label(mangled, names):
    """``name<type,ints>`` from a mangled instantiation of one of ``names``
    (``f`` is float, ``13__nv_bfloat16`` bf16), else the mangled name."""
    import re

    m = re.search(r"(%s)I(f|13__nv_bfloat16)((?:L[ib]\d+E)*)E" % "|".join(names),
                  mangled)
    if not m:
        return mangled
    args = ["f32" if m.group(2) == "f" else "bf16",
            *re.findall(r"L[ib](\d+)E", m.group(3))]
    return f"{m.group(1)}<{','.join(args)}>"


# the sources whose registers and spills report_registers reads
PTXAS_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "paged_decode.cu",
                 "rmsnorm.cu", "argmax.cu")


def report_registers(usage_of):
    """Registers and spills (nvcc -Xptxas -v: ``usage_of[source]`` is
    ``kernels.resource_usage(source)``) of the flash kernels, one line
    each: the tensor-core (bf16) instantiations, two of the forward and four
    of the backward, must not spill; and of every instantiation of the paged
    decode (dtype x G x hd), RMSNorm and argmax kernels, one line per
    source: none may spill."""
    import re

    tc = {"flash_fwd.cu": 0, "flash_bwd.cu": 0}
    for source in tc:
        usage = usage_of[source]
        for mangled, u in sorted(usage.items()):
            m = re.search(r"(flash_\w*?_kernel_(?:bf16|f32))(?:ILi(\d+)E)?",
                          mangled)
            label = (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
                     if m else mangled)
            log(f"ptxas {label}: {u['registers']} registers, spill stores "
                f"{u['spill_stores']} B, spill loads {u['spill_loads']} B")
            if "kernel_bf16" in mangled:
                tc[source] += 1
                check(u["spill_stores"] == 0 and u["spill_loads"] == 0,
                      f"{label} spills registers")
    check(tc == {"flash_fwd.cu": 2, "flash_bwd.cu": 4},
          f"expected 2 bf16 forward and 4 bf16 backward instantiations, "
          f"found {tc}")
    # dtype x G x hd x (the cache at that width, or narrower: padded); dtype
    # x (5 vector lengths x (3 warps a row with w staged + 4 warps a row with
    # w in registers) + the scalar kernel)
    expect = {"paged_decode.cu": (("paged_decode_kernel",), 64),
              "rmsnorm.cu": (("rmsnorm_vec_kernel", "rmsnorm_scalar_kernel"), 42)}
    # the instantiations the main paths launch: decode (and hd 80/96 on the
    # 128-wide padded one), prefill, training
    main_path = ("paged_decode_kernel<bf16,4,128,0>",
                 "paged_decode_kernel<bf16,8,128,0>",
                 "paged_decode_kernel<bf16,4,128,1>",
                 "rmsnorm_vec_kernel<bf16,4,4,0>",
                 "rmsnorm_vec_kernel<bf16,16,1,1>", "rmsnorm_vec_kernel<bf16,8,1,1>")
    for source, (names, count) in expect.items():
        usage = {_template_label(k, names): u
                 for k, u in usage_of[source].items()}
        spills = [k for k, u in usage.items()
                  if u["spill_stores"] or u["spill_loads"]]
        regs = [u["registers"] for u in usage.values()]
        log(f"ptxas {source}: {len(usage)} instantiations, {min(regs)}-"
            f"{max(regs)} registers, spills in {spills or 'none'}; "
            + ", ".join(f"{k} {usage[k]['registers']} registers"
                        for k in main_path if k in usage))
        check(len(usage) == count,
              f"{source}: {len(usage)} instantiations, expected {count}")
        check(not spills, f"{source}: {spills} spill registers")
    # the argmax kernel: vector or element loads x with or without noise
    usage = {}
    for k, u in usage_of["argmax.cu"].items():
        m = re.search(r"argmax_kernelILb(\d)ELb(\d)E", k)
        usage[f"argmax_kernel<{'vec' if m and m.group(1) == '1' else 'elem'},"
              f"{'noise' if m and m.group(2) == '1' else 'greedy'}>"] = u
    log("ptxas argmax.cu: " + ", ".join(
        f"{k} {u['registers']} registers, spills {u['spill_stores']}/"
        f"{u['spill_loads']} B" for k, u in sorted(usage.items())))
    check(len(usage) == 4, f"argmax.cu: {len(usage)} instantiations, expected 4")
    check(not any(u["spill_stores"] or u["spill_loads"] for u in usage.values()),
          "argmax.cu spills registers")


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #
def check_rmsnorm(torch, F):
    from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    rows_out = {}
    # serving: a decode step's [8,4096] and a prefill's [512,4096];
    # training: every token of a batch of 8 x 2048 at dim 2048; generate on
    # Mistral-7B-v0.1: a decode step's [4,4096] and the prefill of 4
    # prompts of 4608 tokens, [18432,4096]; a verify step of 8 slots x 4
    # candidates, [32,4096]; Qwen2.5-7B's prefill and decode, [512,3584]
    # and [8,3584]; Phi-3-mini's prefill of 4 x 4608 and decode, [18432,3072]
    # and [4,3072]
    shapes = {"decode": (8, 4096), "prefill": (512, 4096),
              "training": (16384, 2048), "generate_decode": (4, 4096),
              "generate_prefill": (18432, 4096), "verify": (32, 4096),
              "qwen_prefill": (512, 3584), "qwen_decode": (8, 3584),
              "longrope_prefill": (18432, 3072), "longrope_decode": (4, 3072)}
    for name, (rows, dim) in shapes.items():
        x = torch.randn(rows, dim, generator=g, device="cuda").bfloat16()
        w = (1 + 0.1 * torch.randn(dim, generator=g, device="cuda")).bfloat16()
        got, want = rmsnorm(x, w, 1e-5), rmsnorm_plain(x, w, 1e-5)
        # both round one fp32 value to bf16; sums in another order can
        # move it by one bf16 ulp (2^-8 relative)
        check(within(got, want, 1e-2, 1e-2), f"rmsnorm [{rows},{dim}] vs plain")
        check(torch.equal(got, rmsnorm(x, w, 1e-5)),
              f"rmsnorm [{rows},{dim}]: two launches differ")
        err = max_err(got, want)
        lib = (time_ms(torch, lambda: F.rms_norm(x, (dim,), w, 1e-5))
               if hasattr(F, "rms_norm") else None)
        b, by = bound(2 * x.numel() * 2 + dim * 2, 4 * x.numel(), FP32_FLOPS)
        # a practical ceiling: torch's copy kernel moving x's bytes once each way
        y = torch.empty_like(x)
        copy = time_ms(torch, lambda: y.copy_(x))
        r = rows_out[name] = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: rmsnorm(x, w, 1e-5)),
            ms_eager=time_ms(torch, lambda: rmsnorm(x, w, 1e-5), graph=False),
            plain_ms=time_ms(torch, lambda: rmsnorm_plain(x, w, 1e-5)),
            bound_ms=b, bound_by=by, library_ms=lib, copy_ms=copy,
            shape=f"[{rows},{dim}] bf16",
        )
        lib_txt = f"{lib:.4f}" if lib is not None else "n/a"
        log(f"rmsnorm [{rows},{dim}] bf16: max_abs_err {err:.3g} (tol 1e-2 + "
            f"1e-2|ref|), bitwise repeatable; kernel_ms {r['ms']:.4f} (eager "
            f"{r['ms_eager']:.4f}) plain_ms {r['plain_ms']:.4f} "
            f"library_ms(F.rms_norm) {lib_txt} bound_ms {b:.5f} ({by}); "
            f"{b / r['ms']:.2%} of its bound; copy_ms(x's bytes through "
            f"Tensor.copy_) {copy:.4f}")
    # the practical floor of one launch: the same kernel on one 64-wide row,
    # by graph replay (the device's time alone)
    x = torch.randn(1, 64, generator=g, device="cuda").bfloat16()
    w = torch.ones(64, device="cuda").bfloat16()
    floor = time_ms(torch, lambda: rmsnorm(x, w, 1e-5))
    log(f"rmsnorm launch floor ([1,64] bf16, graph replay): {floor:.4f} ms; "
        f"the decode shape [8,4096] takes {rows_out['decode']['ms'] / floor:.2f}x"
        " it")
    out = dict(rows_out.pop("decode"))
    out["max_abs_err"] = max([out["max_abs_err"]]
                             + [r["max_abs_err"] for r in rows_out.values()])
    out.update({f"at_{name}_shape": r for name, r in rows_out.items()})
    out["launch_floor_ms"] = floor
    return out


def check_flash(torch, F):
    """The forward kernel against its plain version at the prefill shape,
    at odd ones (ragged S, a window, non-causal, GQA group 4 at head dim 64,
    fp32), at the windowed prefill of ``generate_window`` and at the
    training shape; timed at the prefill, the windowed and the training
    shapes."""
    from ray_lightning_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(2)
    bf, f32 = torch.bfloat16, torch.float32
    # bf16: the kernel rounds P to bf16 before P V (as the TPU kernel does)
    # and O is rounded to bf16: 2e-2 on O; lse is fp32 on both sides
    cases = [  # name, B, Hq, Hkv, S, head dim, dtype, causal, window, tol on O
        ("causal bf16", 1, 32, 8, 512, 128, bf, True, None, 2e-2),
        ("ragged 300 bf16", 1, 32, 8, 300, 128, bf, True, None, 2e-2),
        ("ragged 129 bf16", 1, 32, 8, 129, 128, bf, True, None, 2e-2),
        ("window 128 bf16", 1, 32, 8, 512, 128, bf, True, 128, 2e-2),
        ("non-causal bf16", 1, 32, 8, 512, 128, bf, False, None, 2e-2),
        ("group 4 hd 64 bf16", 2, 32, 8, 512, 64, bf, True, None, 2e-2),
        ("causal fp32", 1, 32, 8, 512, 128, f32, True, None, 1e-4),
        # serving_qwen_yarn's prefill: Qwen2.5-7B's 28 query / 4 KV heads
        ("qwen2.5 group 7 bf16", 1, 28, 4, 512, 128, bf, True, None, 2e-2),
    ]
    worst = 0.0
    main = None
    for name, B, hq, hkv, S, hd, dt, causal, window, tol_o in cases:
        q = torch.randn(B, hq, S, hd, generator=g, device="cuda").to(dt)
        k = torch.randn(B, hkv, S, hd, generator=g, device="cuda").to(dt)
        v = torch.randn(B, hkv, S, hd, generator=g, device="cuda").to(dt)
        o, lse = flash_attention(q, k, v, causal=causal, window=window)
        po, plse = flash_attention_plain(q, k, v, causal, None, window)
        check(within(o, po, tol_o, tol_o), f"flash {name}: O vs plain")
        check(within(lse, plse, 1e-4, 1e-4), f"flash {name}: lse vs plain")
        err = max(max_err(o, po), max_err(lse, plse))
        worst = max(worst, err)
        log(f"flash {name} q[{B},{hq},{S},{hd}] kv[{B},{hkv},{S},{hd}]: "
            f"max_abs_err {err:.3g} (tol {tol_o} on O, 1e-4 on lse)")
        if name == "causal bf16":
            kr = k.repeat_interleave(4, dim=1)
            vr = v.repeat_interleave(4, dim=1)
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=True))
            pairs = S * (S + 1) // 2
            nbytes = (q.numel() * 2 + k.numel() * 2 * 2 + q.numel() * 2
                      + 32 * S * 4)
            b, by = bound(nbytes, 4 * 32 * pairs * 128, BF16_FLOPS)
            main = dict(
                ms=time_ms(torch, lambda: flash_attention(q, k, v)),
                ms_eager=time_ms(torch, lambda: flash_attention(q, k, v),
                                 graph=False),
                plain_ms=time_ms(torch, lambda: flash_attention_plain(
                    q, k, v, True, None, None)),
                bound_ms=b, bound_by=by, library_ms=lib,
                shape="q[1,32,512,128] kv[1,8,512,128] bf16 causal",
            )
            log(f"flash causal bf16 S=512: kernel_ms {main['ms']:.4f} "
                f"(eager {main['ms_eager']:.4f}) plain_ms "
                f"{main['plain_ms']:.4f} library_ms(SDPA) {lib:.4f} "
                f"bound_ms {b:.5f} ({by}); {b / main['ms']:.2%} of its bound, "
                f"{main['ms'] / lib:.2f}x SDPA")
        if name == "qwen2.5 group 7 bf16":
            kr = k.repeat_interleave(7, dim=1)
            vr = v.repeat_interleave(7, dim=1)
            pairs = S * (S + 1) // 2
            nbytes = (q.numel() * 2 * 2 + k.numel() * 2 * 2 + hq * S * 4)
            b, by = bound(nbytes, 4 * hq * pairs * hd, BF16_FLOPS)
            main["at_qwen_group_7"] = dict(
                shape=f"q[{B},{hq},{S},{hd}] kv[{B},{hkv},{S},{hd}] bf16 causal "
                      "(serving_qwen_yarn's prefill, G 7)",
                max_abs_err=err,
                ms=time_ms(torch, lambda: flash_attention(q, k, v)),
                plain_ms=time_ms(torch, lambda: flash_attention_plain(
                    q, k, v, True, None, None)),
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, kr, vr, is_causal=True)),
                bound_ms=b, bound_by=by)
            r = main["at_qwen_group_7"]
            log(f"flash {name}: kernel_ms {r['ms']:.4f} plain_ms "
                f"{r['plain_ms']:.4f} library_ms(SDPA) {r['library_ms']:.4f} "
                f"bound_ms {b:.5f} ({by}); {b / r['ms']:.2%} of its bound")
            del kr, vr
        del q, k, v, o, lse, po, plse
    main["at_generate_prefill_shape"], err = check_flash_window(
        torch, F, g, 32, 8, 128, 4096, "generate_window")
    worst = max(worst, err)
    # generate_longrope's prefill: Phi-3-mini's 32 / 32 heads of dim 96
    # (the 128-wide instantiation with a partial head), its 262144-position
    # window past every prompt position
    main["at_longrope_prefill_shape"], err = check_flash_window(
        torch, F, g, 32, 32, 96, 262144, "generate_longrope")
    worst = max(worst, err)
    # the training path's shape: q [8,16,2048,128], kv [8,8,2048,128]
    q = torch.randn(8, 16, 2048, 128, generator=g, device="cuda").bfloat16()
    k = torch.randn(8, 8, 2048, 128, generator=g, device="cuda").bfloat16()
    v = torch.randn(8, 8, 2048, 128, generator=g, device="cuda").bfloat16()
    o, lse = flash_attention(q, k, v)
    po, plse = flash_attention_plain(q, k, v, True, None, None)
    check(within(o, po, 2e-2, 2e-2), "flash training shape: O vs plain")
    check(within(lse, plse, 1e-4, 1e-4), "flash training shape: lse vs plain")
    err = max(max_err(o, po), max_err(lse, plse))
    worst = max(worst, err)
    del po, plse
    kr, vr = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
    pairs = 8 * 16 * 2048 * 2049 // 2
    flops = 4 * pairs * 128
    b, by = bound(q.numel() * 2 * 2 + k.numel() * 2 * 2 + lse.numel() * 4,
                  flops, BF16_FLOPS)
    main["at_training_shape"] = dict(
        shape="q[8,16,2048,128] kv[8,8,2048,128] bf16 causal",
        ms=time_ms(torch, lambda: flash_attention(q, k, v), iters=10),
        ms_eager=time_ms(torch, lambda: flash_attention(q, k, v), iters=10,
                         graph=False),
        plain_ms=time_ms(torch, lambda: flash_attention_plain(
            q, k, v, True, None, None), iters=5, warmup=1),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=True), iters=10),
        bound_ms=b, bound_by=by, max_abs_err=err,
    )
    t = main["at_training_shape"]
    log(f"flash at the training shape {t['shape']}: max_abs_err {err:.3g} "
        f"kernel_ms {t['ms']:.4f} (eager {t['ms_eager']:.4f}) plain_ms "
        f"{t['plain_ms']:.3f} library_ms(SDPA) {t['library_ms']:.4f} "
        f"bound_ms {b:.4f} ({by})")
    log(f"flash fwd at the training shape: {flops / t['ms'] / 1e9:.1f} "
        f"TFLOP/s ({flops / 1e12:.4f} TFLOP in {t['ms']:.4f} ms), "
        f"{b / t['ms']:.2%} of its bound, {t['ms'] / t['library_ms']:.2f}x SDPA")
    del q, k, v, o, lse, kr, vr
    torch.cuda.empty_cache()
    main["max_abs_err"] = worst
    return main


def check_flash_window(torch, F, g, hq, hkv, hd, W, path):
    """The forward kernel at a ``generate`` path's prefill of 4 prompts of
    4608 tokens, causal with a window of ``W`` positions: Mistral-7B-v0.1's
    heads and window 4096 (``generate_window``: the band spans many tiles
    and the last 512 rows leave the first keys behind), Phi-3-mini's heads
    of dim 96 and window 262144 (``generate_longrope``: the band holds every
    position). The plain version runs a batch row at a time (its fp32
    scores for all four rows would take 11 GB); the library call is SDPA
    with the band as a boolean mask. Returns (the entry, its
    max_abs_err)."""
    from ray_lightning_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_plain,
    )

    B, S = 4, 4608
    q = torch.randn(B, hq, S, hd, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, hkv, S, hd, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, hkv, S, hd, generator=g, device="cuda").bfloat16()
    o, lse = flash_attention(q, k, v, causal=True, window=W)
    shape = f"q[{B},{hq},{S},{hd}] kv[{B},{hkv},{S},{hd}] bf16 causal window {W}"
    err = 0.0
    for b in range(B):
        r = slice(b, b + 1)
        po, plse = flash_attention_plain(q[r], k[r], v[r], True, None, W)
        check(within(o[r], po, 2e-2, 2e-2), f"flash {shape} row {b}: O vs plain")
        check(within(lse[r], plse, 1e-4, 1e-4),
              f"flash {shape} row {b}: lse vs plain")
        err = max(err, max_err(o[r], po), max_err(lse[r], plse))
        del po, plse
    torch.cuda.empty_cache()

    def plain_rows():
        for b in range(B):
            flash_attention_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1], True,
                                  None, W)

    i = torch.arange(S, device="cuda")
    band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < W)
    kr = k.repeat_interleave(hq // hkv, dim=1)
    vr = v.repeat_interleave(hq // hkv, dim=1)
    pairs = B * sum(min(t + 1, W) for t in range(S))
    flops = 4 * hq * pairs * hd
    b_ms, by = bound(q.numel() * 2 * 2 + k.numel() * 2 * 2 + lse.numel() * 4,
                     flops, BF16_FLOPS)
    entry = dict(
        shape=shape, max_abs_err=err,
        ms=time_ms(torch, lambda: flash_attention(q, k, v, window=W), iters=10),
        ms_eager=time_ms(torch, lambda: flash_attention(q, k, v, window=W),
                         iters=10, graph=False),
        plain_ms=time_ms(torch, plain_rows, iters=2, warmup=1, graph=False),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=band), iters=3, warmup=1, graph=False),
        bound_ms=b_ms, bound_by=by,
    )
    log(f"flash {shape} ({path}'s prefill): max_abs_err {err:.3g} "
        f"(tol 0.02 on O, 1e-4 on lse, each row against the plain version); "
        f"kernel_ms {entry['ms']:.4f} (eager {entry['ms_eager']:.4f}) "
        f"plain_ms (a row at a time) {entry['plain_ms']:.3f} "
        f"library_ms(SDPA, boolean band mask) {entry['library_ms']:.4f} "
        f"bound_ms {b_ms:.4f} ({by}); {b_ms / entry['ms']:.2%} of its bound, "
        f"{flops / entry['ms'] / 1e9:.1f} TFLOP/s")
    del q, k, v, o, lse, kr, vr, band
    torch.cuda.empty_cache()
    return entry, err


def check_flash_bwd(torch, F):
    """The dQ and dK/dV kernels against the plain backward on the same O and
    lse (the forward kernel's), at the training shape and at odd ones.
    Returns the two kernels' entries, timed at the training shape."""
    from ray_lightning_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32
    # fp32: sums in another order, 1e-4 of each gradient's max. bf16: both
    # sides round P and dS to bf16 before the products, from fp32 scores
    # summed in another order, so a rounding may fall the other way; two
    # bf16 ulps of the max (2^-7) bound that
    cases = [  # name, B, Hq, Hkv, S, head dim, dtype, causal, window
        ("training causal bf16", 8, 16, 8, 2048, 128, bf, True, None),
        ("ragged 300 bf16", 2, 16, 8, 300, 128, bf, True, None),
        ("ragged 129 bf16", 2, 16, 8, 129, 128, bf, True, None),
        ("window 128 bf16", 2, 16, 8, 512, 128, bf, True, 128),
        ("non-causal bf16", 2, 16, 8, 512, 128, bf, False, None),
        ("group 4 hd 64 bf16", 2, 32, 8, 512, 64, bf, True, None),
        ("causal fp32", 2, 16, 8, 512, 128, f32, True, None),
    ]
    worst = {"dq": 0.0, "dkv": 0.0}
    timed = None
    for name, B, hq, hkv, S, hd, dt, causal, window in cases:
        q = torch.randn(B, hq, S, hd, generator=g, device="cuda").to(dt)
        k = torch.randn(B, hkv, S, hd, generator=g, device="cuda").to(dt)
        v = torch.randn(B, hkv, S, hd, generator=g, device="cuda").to(dt)
        do = torch.randn(B, hq, S, hd, generator=g, device="cuda").to(dt)
        o, lse = flash_attention(q, k, v, causal=causal, window=window)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal, None, window)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, None,
                                         window)
        tol = 1e-4 if dt == f32 else 2.0 ** -7
        rel = []
        for gname, a, b in zip(("dq", "dk", "dv"), got, want):
            peak = float(b.float().abs().max())
            check(peak > 0, f"flash bwd {name}: plain {gname} is all zero")
            err = max_err(a, b)
            check(err <= tol * peak,
                  f"flash bwd {name}: {gname} max err {err:.3g} > {tol:.3g} "
                  f"x max {peak:.3g}")
            worst["dq" if gname == "dq" else "dkv"] = max(
                worst["dq" if gname == "dq" else "dkv"], err)
            rel.append(err / peak)
        log(f"flash bwd {name} q[{B},{hq},{S},{hd}] kv[{B},{hkv},{S},{hd}]: "
            f"max err / max |grad| dq {rel[0]:.3g} dk {rel[1]:.3g} dv "
            f"{rel[2]:.3g} (tol {tol:.3g})")
        if timed is None:
            timed = (q, k, v, o, lse, do, B, hq, S)
        else:
            del q, k, v, o, lse, do, got, want

    q, k, v, o, lse, do, B, hq, S = timed
    scale = 1.0 / 128 ** 0.5
    delta = (o.float() * do.float()).sum(dim=-1, keepdim=True)
    eager = {}
    for kname, fn in (("dq", flash_attention_bwd_dq),
                      ("dkv", flash_attention_bwd_dkv)):
        eager[kname] = time_ms(torch, lambda: fn(
            q, k, v, do, lse, delta, True, scale, None), iters=10, graph=False)
    dq_ms = time_ms(torch, lambda: flash_attention_bwd_dq(
        q, k, v, do, lse, delta, True, scale, None), iters=10)
    dkv_ms = time_ms(torch, lambda: flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, True, scale, None), iters=10)
    plain_ms = time_ms(torch, lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, True, scale, None), iters=5, warmup=1)
    # library yardstick: SDPA's backward over repeat-interleaved KV, as
    # its forward + backward minus its forward
    kr = k.repeat_interleave(2, dim=1).requires_grad_()
    vr = v.repeat_interleave(2, dim=1).requires_grad_()
    qr = q.detach().clone().requires_grad_()

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        torch.autograd.grad(out, (qr, kr, vr), do)

    lib_ms = (time_ms(torch, sdpa_fwd_bwd, iters=10)
              - time_ms(torch, sdpa_fwd, iters=10))
    del kr, vr, qr
    pairs = B * hq * S * (S + 1) // 2  # causal (row, key) pairs
    in_bytes = (q.numel() + k.numel() + v.numel() + do.numel()) * 2 \
        + 2 * lse.numel() * 4
    flops_dq, flops_dkv = 3 * 2 * pairs * 128, 4 * 2 * pairs * 128
    b_dq, by_dq = bound(in_bytes + q.numel() * 2, flops_dq, BF16_FLOPS)
    b_dkv, by_dkv = bound(in_bytes + 2 * k.numel() * 2, flops_dkv, BF16_FLOPS)
    shape = f"q[{B},{hq},{S},128] kv[{B},{hq // 2},{S},128] bf16 causal"
    common = dict(plain_ms=plain_ms, library_ms=lib_ms, shape=shape,
                  plain_and_library_compute="dq, dk and dv together")
    log(f"flash bwd at the training shape {shape}: dq kernel_ms {dq_ms:.4f} "
        f"(eager {eager['dq']:.4f}; bound {b_dq:.4f}, {by_dq}) dkv kernel_ms "
        f"{dkv_ms:.4f} (eager {eager['dkv']:.4f}; bound "
        f"{b_dkv:.4f}, {by_dkv}); plain backward (dq+dk+dv) {plain_ms:.3f} ms; "
        f"library_ms (SDPA backward, fwd+bwd minus fwd) {lib_ms:.3f}")
    for kname, ms, flops, b in (("dq", dq_ms, flops_dq, b_dq),
                                ("dkv", dkv_ms, flops_dkv, b_dkv)):
        log(f"flash bwd {kname} at the training shape: {flops / ms / 1e9:.1f} "
            f"TFLOP/s ({flops / 1e12:.4f} TFLOP in {ms:.4f} ms), "
            f"{b / ms:.2%} of its bound")
    log(f"flash bwd pair: {dq_ms + dkv_ms:.3f} ms, "
        f"{(dq_ms + dkv_ms) / lib_ms:.2f}x SDPA's backward")
    del timed, q, k, v, o, lse, do, delta
    torch.cuda.empty_cache()
    return (dict(common, max_abs_err=worst["dq"], ms=dq_ms,
                 ms_eager=eager["dq"], bound_ms=b_dq, bound_by=by_dq),
            dict(common, max_abs_err=worst["dkv"], ms=dkv_ms,
                 ms_eager=eager["dkv"], bound_ms=b_dkv, bound_by=by_dkv))


def check_paged(torch, F):
    """The paged decode kernel against its plain version at the serving
    path's layout (8 rows x 8 KV heads x G 4, hd 128, bs 16, 64 blocks a
    row, bf16 cache), timed with L2 flushed at two shapes: ragged positions
    (the test shape) and the full cache (every row at pos 1023); and at
    ``serving_qwen_yarn``'s layout (8 rows x 4 KV heads x G 7, which the
    wrapper pads to the G 8 instantiation) at the ragged positions; then at
    the repaired shapes, ragged: G 16 (8 rows x 8 KV heads, two launches of
    8 query heads) and head dims 80 and 96 (8 rows x 8 KV heads x G 4, on
    the 128-wide instantiation). A CUDA graph of one call, replayed with new
    positions written in place, must equal eager calls bitwise."""
    import numpy as np

    from ray_lightning_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    B, hd, bs, maxb = 8, 128, 16, 64
    n_blocks = B * maxb + 1
    g = torch.Generator(device="cuda").manual_seed(3)

    def layout(hkv, G, hd=hd):
        kc = torch.randn(n_blocks, hkv, bs, hd, generator=g, device="cuda").bfloat16()
        vc = torch.randn(n_blocks, hkv, bs, hd, generator=g, device="cuda").bfloat16()
        return torch.randn(B, hkv, G, hd, generator=g, device="cuda"), kc, vc

    q, kc, vc = layout(8, 4)
    rng = np.random.default_rng(3)
    perm = rng.permutation(np.arange(1, n_blocks))
    C = maxb * bs

    def tables_for(pos, free_last):
        tables = np.zeros((B, maxb), np.int32)  # trash-padded
        used = 0
        for b in range(B - 1 if free_last else B):  # a free slot: all trash
            need = int(pos[b]) // bs + 1
            tables[b, :need] = perm[used:used + need]
            used += need
        return torch.from_numpy(tables).cuda()

    def measure(name, pos, free_last, q, kc, vc):
        hkv, G, hd = q.shape[1], q.shape[2], q.shape[3]
        t_tab = tables_for(pos, free_last)
        t_pos = torch.from_numpy(pos).cuda()
        got = paged_decode_attention(q, kc, vc, t_tab, t_pos)
        want = paged_decode_attention_plain(q, kc, vc, t_tab, t_pos)
        # fp32 accumulation on both sides over <= 1024 positions
        check(within(got, want, 1e-4, 1e-4),
              f"paged decode G {G} {name} vs plain")
        check(torch.equal(got, paged_decode_attention(q, kc, vc, t_tab, t_pos)),
              f"paged decode G {G} {name}: two launches differ")
        err = max_err(got, want)
        # library yardstick: SDPA over the gathered, masked cache
        kk = kc[t_tab.long()].transpose(1, 2).reshape(B, hkv, C, hd).float()
        vv = vc[t_tab.long()].transpose(1, 2).reshape(B, hkv, C, hd).float()
        kk, vv = kk.repeat_interleave(G, dim=1), vv.repeat_interleave(G, dim=1)
        qq = q.reshape(B, hkv * G, 1, hd)
        mask = (torch.arange(C, device="cuda")[None, :] <= t_pos.long()[:, None])
        mask = mask[:, None, None, :]
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask), cold=True)
        del kk, vv
        positions = int((pos + 1).sum())
        # K and V of every position read, q read and the output written, the
        # table entries up to pos // bs and pos
        nbytes = (positions * hkv * hd * 2 * 2 + q.numel() * 4 * 2
                  + int((pos // bs + 1).sum()) * 4 + pos.nbytes)
        b, by = bound(nbytes, 4 * hkv * G * hd * positions, FP32_FLOPS)
        r = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: paged_decode_attention(
                q, kc, vc, t_tab, t_pos), cold=True),
            ms_eager=time_ms(torch, lambda: paged_decode_attention(
                q, kc, vc, t_tab, t_pos), cold=True, graph=False),
            plain_ms=time_ms(torch, lambda: paged_decode_attention_plain(
                q, kc, vc, t_tab, t_pos), cold=True),
            bound_ms=b, bound_by=by, library_ms=lib,
            shape=f"8 rows x {hkv} KV heads x G {G}, hd {hd}, bs 16, {name}, "
                  "bf16 cache",
        )
        warm = time_ms(torch, lambda: paged_decode_attention(
            q, kc, vc, t_tab, t_pos))
        log(f"paged decode G {G} hd {hd} {name} (times with L2 flushed; kernel_ms "
            f"{warm:.4f} with the cache hot in L2): max_abs_err {err:.3g} "
            f"(tol 1e-4), bitwise repeatable; kernel_ms {r['ms']:.4f} (eager "
            f"{r['ms_eager']:.4f}) plain_ms {r['plain_ms']:.4f} "
            f"library_ms(SDPA on gathered KV) {lib:.4f} bound_ms {b:.5f} "
            f"({by}, {nbytes / 1e6:.1f} MB); {b / r['ms']:.2%} of its bound, "
            f"{lib / r['ms']:.1f}x faster than SDPA")
        return r, t_tab, t_pos

    ragged = np.asarray([1000, 777, 512, 300, 128, 63, 16, 0], np.int32)
    out, _, _ = measure("pos up to 1000", ragged, True, q, kc, vc)
    full, t_tab, t_pos = measure("full cache (pos 1023)",
                                 np.full(B, C - 1, np.int32), False, q, kc, vc)
    out["at_full_cache"] = full
    qwen = layout(4, 7)
    out["at_group_7"], _, _ = measure("pos up to 1000", ragged, True, *qwen)
    del qwen
    # the repaired shapes: a group above 8, head dims between the
    # instantiated widths
    for key, shape in (("at_group_16", (8, 16)), ("at_head_dim_80", (8, 4, 80)),
                       ("at_head_dim_96", (8, 4, 96))):
        inputs = layout(*shape)
        out[key], _, _ = measure("pos up to 1000", ragged, True, *inputs)
        del inputs
    out["max_abs_err"] = max(out["max_abs_err"], full["max_abs_err"],
                             *(out[k]["max_abs_err"] for k in (
                                 "at_group_7", "at_group_16", "at_head_dim_80",
                                 "at_head_dim_96")))

    # one call captured in a CUDA graph, replayed with new positions
    static_pos = t_pos.clone()
    paged_decode_attention(q, kc, vc, t_tab, static_pos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = paged_decode_attention(q, kc, vc, t_tab, static_pos)
    for new in ([5, 64, 1023, 0, 300, 777, 63, 1000],
                [1023, 0, 65, 16, 15, 128, 512, 999]):
        static_pos.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(static_out, paged_decode_attention(
            q, kc, vc, t_tab, static_pos)),
            f"paged decode: graph replay at pos {new} differs from an eager call")
    del graph
    log("paged decode: one call captured in a CUDA graph and replayed at two "
        "new position vectors equals eager calls bitwise")
    return out


def check_argmax(torch):
    """The argmax kernel against its plain version (torch.argmax), bitwise,
    at the serving shape [8,128256] fp32, greedy and noisy, on rows with
    planted ties and on rows with planted NaNs (the first NaN wins). Timed
    greedy and noisy at batch 8, greedy at batch 1 and 64, each with L2
    flushed, beside its bytes bound at the HBM rate, and with L2 hot (as the
    sampler finds the logits the lm_head has just written; no bound: the
    bytes come from L2, whose rate the run does not measure), and greedy at
    batch 8 at every cluster size (chunks per row) the plan could pick,
    hot and flushed. At the MoE serving path's vocabulary, [8,32000], the
    plan's cluster is held too: bitwise on planted ties and NaNs, greedy
    and noisy, and timed the same way (``at_vocab_32000``); so are a verify
    step's [32,128256] (``at_verify_shape``) and ``serving_qwen_yarn``'s
    [8,152064] (``at_vocab_152064``), greedy."""
    from ray_lightning_tpu_torch.ops.paged_attention import (
        ARGMAX_MAX_CHUNKS,
        _launch_argmax,
        _sm_count,
        argmax_plan,
        blockwise_argmax,
        blockwise_argmax_plain,
        gumbel_noise,
    )

    B, V = 8, 128256
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = _sm_count(dev)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(B, V, generator=g, device="cuda")
    top = float(x.max()) + 1.0
    for row, cols in ((0, (5, 100000)), (1, (64000, 127000)),
                      (2, (0, V - 1)), (3, (4095, 4096, 4097))):
        x[row, list(cols)] = top  # planted ties: the first one must win
    nan = float("nan")
    x_nan = x.clone()
    x_nan[4, 100], x_nan[4, 100000] = top, nan    # a NaN chunks after the max
    x_nan[5, 3], x_nan[5, 90000] = nan, top       # a NaN before a larger number
    x_nan[6] = nan                                # all NaN
    x_nan[7, 64000], x_nan[7, 64001] = top, nan   # a NaN beside the max
    noise = gumbel_noise((B, V), g, torch.device("cuda"))
    errs = []
    for name, xx, nz in (("greedy", x, None), ("noisy", x, noise),
                         ("greedy with NaNs", x_nan, None),
                         ("noisy with NaNs", x_nan, noise)):
        got = blockwise_argmax(xx, nz)
        want = blockwise_argmax_plain(xx, nz)
        check(torch.equal(got, want), f"argmax {name} vs plain: "
              f"{got.tolist()} != {want.tolist()}")
        errs.append(max_err(got, want))
    check([int(t) for t in blockwise_argmax(x)[:4]] == [5, 64000, 0, 4095],
          "argmax keeps the first of tied maxima")
    for nz in (None, noise):
        check([int(t) for t in blockwise_argmax(x_nan, nz)[4:]]
              == [100000, 3, 0, 64001], "argmax returns a row's first NaN")
    first = blockwise_argmax(x_nan, noise)
    check(all(torch.equal(blockwise_argmax(x_nan, noise), first)
              for _ in range(10)), "argmax: ten calls differ")

    def timings(xx, nz, cold):
        lib = ((lambda: torch.argmax(xx, dim=-1)) if nz is None
               else (lambda: torch.argmax(xx + nz, dim=-1)))
        return dict(
            ms=time_ms(torch, lambda: blockwise_argmax(xx, nz), iters=100,
                       cold=cold),
            ms_eager=time_ms(torch, lambda: blockwise_argmax(xx, nz),
                             iters=100, cold=cold, graph=False),
            plain_ms=time_ms(torch, lambda: blockwise_argmax_plain(xx, nz),
                             cold=cold),
            library_ms=time_ms(torch, lib, cold=cold),
        )

    def measure(xx, nz):
        """Times with L2 flushed, which the HBM bytes bound holds, and the
        same times with L2 hot under ``l2_hot``."""
        rows = xx.shape[0]
        # x (and the noise) read once, the indices written; a compare per
        # element, and an add with the noise
        nbytes = xx.numel() * 4 * (1 if nz is None else 2) + rows * 4
        b, by = bound(nbytes, xx.numel() * (1 if nz is None else 2), FP32_FLOPS)
        return dict(**timings(xx, nz, cold=True), bound_ms=b, bound_by=by,
                    chunks=argmax_plan(rows, xx.shape[1], sms)["chunks"],
                    l2_hot=timings(xx, nz, cold=False))

    def show(label, r):
        hot = r["l2_hot"]
        log(f"argmax {label}: {r['chunks']} chunks a row (cluster of "
            f"{r['chunks']}); L2 flushed: kernel_ms {r['ms']:.4f} (eager "
            f"{r['ms_eager']:.4f}) plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
            f"({r['bound_by']}, HBM); {r['bound_ms'] / r['ms']:.1%} of its "
            f"bound, {r['library_ms'] / r['ms']:.1f}x faster than the library "
            f"call. L2 hot: kernel_ms {hot['ms']:.4f} (eager "
            f"{hot['ms_eager']:.4f}) plain_ms {hot['plain_ms']:.4f} library_ms "
            f"{hot['library_ms']:.4f}, {hot['library_ms'] / hot['ms']:.1f}x "
            f"faster than the library call")

    out = dict(max_abs_err=max(errs), shape="[8,128256] fp32 greedy, L2 flushed",
               **measure(x, None))
    out["noisy"] = measure(x, noise)
    for rows in (1, 64):
        xb = torch.randn(rows, V, generator=g, device="cuda")
        out[f"at_batch_{rows}"] = measure(xb, None)
        del xb
    # the MoE serving path's vocabulary (Mixtral's 32000)
    x32 = torch.randn(B, 32000, generator=g, device="cuda")
    top32 = float(x32.max()) + 1.0
    x32[0, [7, 31999]] = top32
    x32[1, [3999, 4000]] = top32  # a tie across the first chunk edge
    x32[2, 17], x32[2, 20000] = nan, top32
    x32[3] = nan
    noise32 = gumbel_noise((B, 32000), g, torch.device("cuda"))
    for nz in (None, noise32):
        got = blockwise_argmax(x32, nz)
        check(torch.equal(got, blockwise_argmax_plain(x32, nz)),
              f"argmax [8,32000] vs plain: {got.tolist()}")
        errs.append(max_err(got, blockwise_argmax_plain(x32, nz)))
    check([int(t) for t in blockwise_argmax(x32)[:4]] == [7, 3999, 17, 0],
          "argmax [8,32000]: first of tied maxima, first NaN")
    plan32 = argmax_plan(B, 32000, sms)
    check(plan32["chunks"] == 8 and plan32["chunk"] * 8 >= 32000,
          f"argmax plan at [8,32000]: {plan32}")
    # a verify step (8 slots x 4 candidates) and Qwen2.5's vocabulary, which
    # no chunk divides
    for key, (rows, vocab) in (("at_verify_shape", (32, 128256)),
                               ("at_vocab_152064", (8, 152064))):
        xv = torch.randn(rows, vocab, generator=g, device="cuda")
        topv = float(xv.max()) + 1.0
        plan = argmax_plan(rows, vocab, sms)
        xv[0, [plan["chunk"] - 1, plan["chunk"], vocab - 1]] = topv
        xv[1, 5], xv[1, vocab - 2] = nan, topv
        xv[2] = nan
        got = blockwise_argmax(xv)
        want = blockwise_argmax_plain(xv)
        check(torch.equal(got, want),
              f"argmax [{rows},{vocab}] vs plain: {got.tolist()}")
        check([int(t) for t in got[:3]] == [plan["chunk"] - 1, 5, 0],
              f"argmax [{rows},{vocab}]: first of tied maxima, first NaN")
        errs.append(max_err(got, want))
        out[key] = measure(xv.nan_to_num(), None)
        out[key]["plan"] = plan
        del xv
    out["max_abs_err"] = max(errs)
    out["at_vocab_32000"] = measure(torch.randn(B, 32000, generator=g,
                                                device="cuda"), None)
    out["at_vocab_32000"]["noisy"] = measure(x32.nan_to_num(), noise32)
    out["by_chunks"], out["by_chunks_flushed"] = (
        {c: time_ms(torch, lambda c=c: _launch_argmax(x, None, c), iters=100,
                    cold=cold)
         for c in range(1, ARGMAX_MAX_CHUNKS + 1)}
        for cold in (False, True))
    log(f"argmax [8,128256] fp32: bitwise equal to the plain version on "
        f"greedy and noisy rows with planted ties and planted NaNs (first "
        f"max, first NaN, all-NaN row), ten calls identical; {sms} SMs")
    show("[8,128256] greedy (library: torch.argmax)", out)
    show("[8,128256] noisy (library: torch.argmax(x + noise))", out["noisy"])
    show("[1,128256] greedy", out["at_batch_1"])
    show("[64,128256] greedy", out["at_batch_64"])
    log(f"argmax [8,32000]: bitwise equal to the plain version on planted "
        f"ties and NaNs, greedy and noisy; plan {plan32}")
    show("[8,32000] greedy (the MoE path's vocabulary)", out["at_vocab_32000"])
    show("[8,32000] noisy", out["at_vocab_32000"]["noisy"])
    log(f"argmax [32,128256] and [8,152064]: bitwise equal to the plain "
        f"version on planted ties and NaNs; plans "
        f"{out['at_verify_shape']['plan']}, {out['at_vocab_152064']['plan']}")
    show("[32,128256] greedy (a verify step)", out["at_verify_shape"])
    show("[8,152064] greedy (Qwen2.5's vocabulary)", out["at_vocab_152064"])
    for key, label in (("by_chunks", "L2 hot"), ("by_chunks_flushed", "L2 flushed")):
        log(f"argmax [8,128256] greedy by chunks a row (graph replay, {label}): "
            + ", ".join(f"{c}: {ms:.4f} ms" for c, ms in out[key].items()))
    return out


# --------------------------------------------------------------------- #
# phases 4 and 5: the serving path
# --------------------------------------------------------------------- #
def requests(rng, vocab, n, max_prompt, n_new, shared_len):
    shared = rng.integers(0, vocab, shared_len).tolist()
    out = []
    for i in range(n):
        length = int(rng.integers(max(4, max_prompt // 16), max_prompt + 1))
        if i % 3 == 0:
            tail = rng.integers(0, vocab, max(1, length - shared_len)).tolist()
            prompt = (shared + tail)[:max_prompt]
        else:
            prompt = rng.integers(0, vocab, length).tolist()
        out.append((prompt, n_new))
    return out


def serve(engine, reqs, first_wave):
    comps = [engine.submit(p, max_new_tokens=n) for p, n in reqs[:first_wave]]
    for _ in range(4):
        engine.step()
    comps += [engine.submit(p, max_new_tokens=n) for p, n in reqs[first_wave:]]
    engine.run_until_idle()
    return comps


# substrings of device kernel names, for the device-time breakdown
PORT_KERNEL_NAMES = {"rmsnorm_vec_kernel": "rmsnorm",
                     "rmsnorm_scalar_kernel": "rmsnorm",
                     "flash_fwd_kernel": "flash_fwd",
                     "flash_bwd_dq_kernel": "flash_bwd_dq",
                     "flash_bwd_dkv_kernel": "flash_bwd_dkv",
                     "paged_decode_": "paged_decode", "argmax_kernel": "argmax"}
MATMUL_NAMES = ("gemm", "gemv", "xmma", "cutlass", "splitk", "nvjet")


PROFILED_REQUESTS = 8  # of the 16: the profiler's cost grows with its events


def profile_run(torch, engine, reqs, label):
    """Where the main path's device time goes: the first
    ``PROFILED_REQUESTS`` of the requests served again, first unprofiled
    (timed), then under torch.profiler, each device event put in one class
    (each of the port's kernels, cuBLAS matmuls, everything else). The
    prefix cache is warm on these passes, which changes which blocks prefill
    writes, not what it computes. The busy share is that device time over
    the wall time of the unprofiled pass of the same requests."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    reqs = reqs[:PROFILED_REQUESTS]
    torch.cuda.synchronize()
    t = time.perf_counter()
    serve(engine, reqs, len(reqs) // 2)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve(engine, reqs, len(reqs) // 2)
        torch.cuda.synchronize()
    classes = collections.Counter()
    other = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        us = e.time_range.elapsed_us()
        low = e.name.lower()
        port = [v for k, v in PORT_KERNEL_NAMES.items() if k in e.name]
        if port:
            classes[port[0]] += us
        elif any(k in low for k in MATMUL_NAMES):
            classes["matmul"] += us
        else:
            classes["other"] += us
            other[e.name[:60]] += us
    busy_ms = sum(classes.values()) / 1e3
    if busy_ms == 0:
        log("profile: the profiler saw no device events; breakdown not measured")
        return
    log(f"profile of {len(reqs)} of {label}'s requests: device busy "
        f"{busy_ms:.1f} ms of "
        f"{wall_s * 1e3:.1f} ms wall ({busy_ms / (wall_s * 1e3):.1%} busy); "
        + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in classes.most_common()))
    log("profile, largest 'other' device events: " + "; ".join(
        f"{name} {us / 1e3:.1f} ms" for name, us in other.most_common(6)))


def main_engine_config(**kw):
    """The serving main path's engine settings (8 slots, prompts up to 512,
    1024 positions, paged blocks of 16), with ``kw`` over them."""
    from ray_lightning_tpu_torch.serving import EngineConfig

    return EngineConfig(**{**dict(num_slots=8, max_prompt_len=512,
                                  max_len=1024, block_size=16,
                                  kv_layout="paged"), **kw})


def launches_expected(L, prefills, steps):
    """The serving launches of ``prefills`` prefills and ``steps`` one-token
    paged decode steps (the main path's formula; the backward kernels
    belong to the training path)."""
    return {"rmsnorm": 2 * L * prefills + (2 * L + 1) * steps,
            "flash_fwd": L * prefills, "paged_decode": L * steps,
            "argmax": steps, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def serve_path(torch, card, cfg, params, label, layout="paged",
               speculate_k=0, profile=True):
    """The engine at full width (8 slots, prompts up to 512, 1024 positions;
    blocks of 16 on the paged layout) on the 16 staggered requests: every
    request completes with in-vocabulary tokens, every decode step's logits
    are finite, every serving kernel of the layout launches exactly as often
    as the layer count says (the slot layout attends its dense rows in plain
    torch: no paged decode; nor does a verify step, with ``speculate_k``,
    whose argmax runs on [8 x K, V]), and, with ``profile``, the requests
    are served again under torch.profiler. Returns (launch counts, the
    engine, tokens/s, the token streams)."""
    import numpy as np

    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.serving import InferenceEngine

    paged = layout == "paged"
    ecfg = main_engine_config(kv_layout=layout, speculate_k=speculate_k)
    engine = InferenceEngine(params, cfg, ecfg)
    kv_gib = sum(v.numel() * v.element_size()
                 for v in engine.pool.cache.values()) / 2**30
    log(f"{label}: {layout} KV pool {tuple(engine.pool.cache['k'].shape)} x2 = "
        f"{kv_gib:.2f} GiB")
    # warm-up request (cuBLAS handles, allocator), not part of the run
    serve(engine, [([1, 2, 3, 4], 2)], 1)
    finite = []
    sample = engine._sample

    rows = ecfg.num_slots * max(speculate_k, 1)

    def checked(logits):  # a device flag a step, read after the run
        check(tuple(logits.shape) == (rows, cfg.vocab_size),
              f"{label}: sampler input {tuple(logits.shape)}")
        finite.append(torch.isfinite(logits).all())
        return sample(logits)

    engine._sample = checked
    rng = np.random.default_rng(0)
    reqs = requests(rng, cfg.vocab_size, 16, 512, 32, 256)
    before = dict(engine.stats)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    comps = serve(engine, reqs, 8)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t
    counts = kernels.launch_counts()
    prefills = engine.stats["prefills"] - before["prefills"]
    steps = engine.stats["decode_steps"] - before["decode_steps"]
    tokens = engine.stats["tokens_out"] - before["tokens_out"]
    for comp, (prompt, n) in zip(comps, reqs):
        check(comp.done and comp.finish_reason == "length",
              f"{comp.request_id} did not complete ({comp.finish_reason})")
        check(len(comp.tokens) == n and all(0 <= t < cfg.vocab_size
                                            for t in comp.tokens),
              f"{comp.request_id}: bad tokens")
    engine._sample = sample
    check(len(finite) == steps and bool(torch.stack(finite).all()),
          f"{label}: a decode step's logits are not finite")
    one_token_paged = paged and not speculate_k
    for name in ("rmsnorm", "flash_fwd", "argmax") + (
            ("paged_decode",) if one_token_paged else ()):
        check(counts[name] > 0, f"kernel {name} was not launched on {label}")
    L = cfg.n_layers
    expect = launches_expected(L, prefills, steps)
    if not one_token_paged:
        expect["paged_decode"] = 0
    check(counts == expect, f"{label}: launch counts {counts} != {expect}")
    ttfts = sorted(c.ttft_s for c in comps)
    hits = (f"shared-prefix block hits {engine.pool.allocator.prefix_hits_total}; "
            if paged else "")
    spec = ""
    if speculate_k:
        ticks = engine.stats["spec_row_ticks"] - before["spec_row_ticks"]
        accepted = (engine.stats["accepted_tokens"]
                    - before["accepted_tokens"])
        spec = (f"speculate_k {speculate_k}: {accepted} tokens in {ticks} "
                f"slot verify ticks, {accepted / ticks:.3f} a slot a step; ")
    log(f"{label} on {card}: {len(comps)} requests ({prefills} prefills, "
        f"{steps} decode steps, {tokens} tokens) in {elapsed:.3f}s -> "
        f"{tokens / elapsed:.1f} tokens/s; TTFT median "
        f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms max {ttfts[-1] * 1e3:.1f} ms; "
        f"{spec}{hits}all {steps} decode steps' logits finite")
    log(f"{label} launches: {counts} (per prefill: rmsnorm {2 * L}, flash_fwd "
        f"{L}; per decode step: rmsnorm {2 * L + 1}, "
        f"{f'paged_decode {L}, ' if one_token_paged else ''}argmax 1"
        f"{f' at [{rows},{cfg.vocab_size}]' if speculate_k else ''})")
    if profile:
        profile_run(torch, engine, reqs, label)
    return counts, engine, tokens / elapsed, [c.tokens for c in comps]


def main_path(torch, card):
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.llama3_8b()
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params["layers"].values()) + \
        params["embed"].numel() + params["lm_head"].numel()
    log(f"llama3_8b: {n_params / 1e9:.2f} B params bf16 initialised in "
        f"{time.perf_counter() - t:.1f}s, {torch.cuda.memory_allocated() / 2**30:.1f} "
        "GiB allocated")
    counts, engine, paged_tps, streams = serve_path(torch, card, cfg, params,
                                                    "main path")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    by_path = {"serving": counts,
               "serving_slot": serving_slot(torch, card, cfg, params,
                                            paged_tps, streams)}
    by_path.update(serving_spec(torch, card, cfg, params, streams))
    t = time.perf_counter()
    by_path["serving_disagg"], pair_tps = serving_disagg(
        torch, card, cfg, params, paged_tps, streams)
    by_path["serving_tenants"] = serving_tenants(torch, card, cfg, params)
    by_path["serving_faults"] = serving_faults(torch, card, cfg, params,
                                               streams)
    disagg_s = time.perf_counter() - t
    t = time.perf_counter()
    by_path["serving_fleet"] = serving_fleet(torch, card, cfg, params,
                                             paged_tps, pair_tps, streams)
    fleet_s = time.perf_counter() - t
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return by_path, disagg_s, fleet_s


def serving_slot(torch, card, cfg, params, paged_tps, paged_streams):
    """The slot layout on the main path's weights and requests (8 rows of
    1024 positions, 1.0 GiB of bf16 K/V): the serving checks of
    ``serve_path``, then one decode step timed by graph replay beside its
    bytes bound, and the share of it that the plain-torch attention over
    the dense rows takes (the 32 layers' attention alone, replayed the same
    way on the same cache)."""
    from ray_lightning_tpu_torch.models.generation import dense_decode_attention

    # no profiled rerun (it took ~70 s of the script): the main path's
    # profile classifies the same layers
    counts, engine, tps, streams = serve_path(torch, card, cfg, params,
                                              "serving_slot", layout="slot",
                                              profile=False)
    same = sum(a == b for a, b in zip(streams, paged_streams))
    log(f"serving_slot on {card}: {tps:.1f} tokens/s beside the paged main "
        f"path's {paged_tps:.1f} in the same run; {same} of {len(streams)} "
        "greedy streams equal the paged path's (bf16; not checked: the "
        "attention sums in another order, and a near-tie of a random model's "
        "logits may fall the other way)")
    r = decode_step_time(torch, engine, cfg)
    n, C = engine.pool.num_slots, engine.pool.max_len
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((n, hkv, cfg.n_heads // hkv, hd), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    masked = (torch.arange(C, device="cuda")[None, :]
              > r["pos"][:, None])[:, None, None, :]
    cache = engine.pool.cache

    def attend():
        for i in range(cfg.n_layers):
            dense_decode_attention(q, cache["k"][i], cache["v"][i], masked)

    attn_ms = time_ms(torch, attend, iters=3, warmup=2)
    log(f"serving_slot decode step on {card} (8 rows, pos up to 1023): "
        f"{r['ms']:.3f} ms graph replay (eager {r['ms_eager']:.3f} ms) against "
        f"a {r['bound_ms']:.3f} ms bound ({r['bound_by']}: "
        f"{r['bytes'] / 1e9:.3f} GB = weights {r['weight_bytes'] / 1e9:.3f} "
        f"+ K/V {r['kv_bytes'] / 1e9:.4f}), {r['bound_ms'] / r['ms']:.1%} of "
        f"its bound; the dense fp32 attention of its {cfg.n_layers} layers "
        f"(over all {C} positions of every row) {attn_ms:.3f} ms by graph "
        f"replay, {attn_ms / r['ms']:.1%} of the step")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return counts


SPEC_K = 4  # candidates a slot verifies a step on the speculative paths


def serving_spec(torch, card, cfg, params, streams):
    """Self-speculative decoding on the main path's weights and requests:
    ``speculate_k=4`` on the paged and then the slot layout, with the
    serving checks of ``serve_path`` (a verify step launches RMSNorm 2L + 1
    times and argmax once at [32, 128256], and no paged decode); how many
    of the 16 streams equal the ``speculate_k=0`` main path's (printed, not
    checked: at bf16 a verify step's products over 32 rows may take other
    cuBLAS algorithms than the one-token step's 8, and a near-tie may then
    fall the other way); then one verify step of each layout by graph replay
    beside its bytes bound and beside the one-token step of the same
    layout; no profiled rerun (each took ~70 s of the script; the verify
    step's graph replay gives its device time). Returns the launch counts of
    both layouts."""
    by_path = {}
    for layout, path in (("paged", "serving_spec"), ("slot", "serving_spec_slot")):
        counts, engine, tps, got = serve_path(
            torch, card, cfg, params, path, layout=layout, speculate_k=SPEC_K,
            profile=False)
        same = sum(a == b for a, b in zip(got, streams))
        log(f"{path} on {card}: {same} of {len(streams)} greedy streams equal "
            "the speculate_k=0 main path's (bf16; not checked)")
        one = decode_step_time(torch, engine, cfg)
        ver = decode_step_time(torch, engine, cfg, k=SPEC_K)
        log(f"{path} verify step on {card} (8 rows x {SPEC_K} candidates, "
            f"the last at pos up to 1023): {ver['ms']:.3f} ms graph replay "
            f"(eager {ver['ms_eager']:.3f} ms) against a {ver['bound_ms']:.3f} "
            f"ms bound ({ver['bound_by']}: {ver['bytes'] / 1e9:.3f} GB), "
            f"{ver['bound_ms'] / ver['ms']:.1%} of its bound; the one-token "
            f"{layout} step {one['ms']:.3f} ms (eager {one['ms_eager']:.3f}) "
            f"against {one['bound_ms']:.3f} ms: a verify step costs "
            f"{ver['ms'] / one['ms']:.2f}x the one-token step and breaks even "
            f"at {ver['ms'] / one['ms']:.2f} tokens a slot a step")
        by_path[path] = counts
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return by_path


def repeating_requests(rng, vocab, n, seg_len, repeats, n_new):
    """Prompts of a random segment repeated ``repeats`` times and a random
    tail: prompt lookup finds their continuations in their own history."""
    out = []
    for i in range(n):
        seg = rng.integers(0, vocab, seg_len).tolist()
        tail = rng.integers(0, vocab, 1 + i % 3).tolist()
        out.append((seg * repeats + tail, n_new))
    return out


# --------------------------------------------------------------------- #
# phase 4c: disaggregated serving, tenancy and serving faults
# --------------------------------------------------------------------- #
DISAGG_BUDGET_S = 60.0  # the serving phase's new paths together
TENANT_SPECS = "gold:guaranteed:4,silver:standard:2,free:best_effort:1:0:4"
TENANT_DEADLINE_MS = 400.0  # the first gold request: runs out mid-decode
SERVE_FAULT_DROP = "replica0:drop-stream@req2:4,replica0:slow-decode@every:4:0.05"
SERVE_FAULT_CRASH = "replica0:crash@tick8"


def _add(total, counts):
    """Add one run's launch counts into a path's ``total``."""
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _median_max(xs):
    s = sorted(xs)
    return s[len(s) // 2], s[-1]


class _ShipmentPump:
    """A few lines of the fleet's pump: every ready export of ``src`` is
    read (``export_shipment``), verified on this thread, imported into
    ``dst`` once it has a free slot (a MigrationRejected import, the
    receiver at capacity, waits and is offered again: the slot stays parked
    on ``src``) and finished at ``src``. Times each step;
    ``corrupt_first`` first offers ``dst`` a bit-flipped copy of the first
    shipment, which must be refused with ``dst``'s occupancy and free
    blocks unchanged."""

    def __init__(self, src, dst, budgets, on_token=None,
                 corrupt_first=False):
        self.src, self.dst = src, dst
        self.budgets, self.on_token = budgets, on_token
        self.corrupt_first = corrupt_first
        self.comps, self.ships, self.pending = {}, {}, []
        self.export_s, self.verify_s, self.import_s = [], [], []
        self.corrupt = None
        self.rejected = 0  # imports refused for capacity, offered again

    def _offer_corrupt(self, rid, ship):
        from ray_lightning_tpu_torch.serving import ShipmentCorrupt
        from ray_lightning_tpu_torch.serving.migration import corrupt_copy

        occ = self.dst.pool.occupancy
        free = self.dst.pool.allocator.free_blocks
        try:
            self.dst.import_shipment(corrupt_copy(ship),
                                     max_new_tokens=self.budgets[rid])
            refused = False
        except ShipmentCorrupt:
            refused = True
        check(refused, f"{rid}: a corrupt copy was admitted")
        check(self.dst.pool.occupancy == occ
              and self.dst.pool.allocator.free_blocks == free,
              f"{rid}: the refused shipment moved the receiver (occupancy "
              f"{occ} -> {self.dst.pool.occupancy}, free blocks {free} -> "
              f"{self.dst.pool.allocator.free_blocks})")
        self.corrupt = (rid, occ, free)

    def run(self, want, timeout=300.0):
        from ray_lightning_tpu_torch.serving import (
            MigrationRejected,
            verify_shipment,
        )

        deadline = time.perf_counter() + timeout
        while len(self.comps) < want:
            check(time.perf_counter() < deadline,
                  f"pump: {len(self.comps)} of {want} shipments in {timeout}s")
            moved = False
            for rid in self.src.drain_ready_exports():
                t = time.perf_counter()
                ship = self.src.export_shipment(rid)
                t1 = time.perf_counter()
                nbytes = verify_shipment(ship, self.dst.kv_fingerprint())
                t2 = time.perf_counter()
                check(nbytes == ship.nbytes(), f"{rid}: verified {nbytes} "
                      "bytes")
                self.export_s.append(t1 - t)
                self.verify_s.append(t2 - t1)
                self.ships[rid] = ship
                self.pending.append(rid)
                moved = True
            waiting = []
            for rid in self.pending:
                if self.dst.pool.free_count == 0:
                    waiting.append(rid)
                    continue
                if self.corrupt_first and self.corrupt is None:
                    self._offer_corrupt(rid, self.ships[rid])
                t = time.perf_counter()
                try:
                    comp = self.dst.import_shipment(
                        self.ships[rid], max_new_tokens=self.budgets[rid],
                        request_id=rid, on_token=self.on_token)
                except MigrationRejected:
                    self.rejected += 1
                    waiting.append(rid)
                    continue
                self.import_s.append(time.perf_counter() - t)
                self.comps[rid] = comp
                self.src.finish_export(rid)
                moved = True
            self.pending = waiting
            if not moved:
                time.sleep(0.001)
        return self.comps


def serving_disagg(torch, card, cfg, params, colocated_tps, streams):
    """A prefill engine and a decode engine share the card and the main
    path's weights, each on its own loop thread (both on the default
    stream), with the main path's 16 staggered requests moved between them
    by a few lines of pump: every request ends ``"length"`` on the decode
    engine and ``"migrated"`` on the prefill engine, every shipment
    verifies, a corrupt copy of the first is refused with the receiver
    unchanged and its clean resend decodes, the launches are exact (every
    prefill on the prefill engine, every decode step on the decode engine,
    paged decode over imported blocks), every decode step's logits are
    finite and both pools end empty with no chain pinned. Printed: the
    shipments' bytes, export, verify and import times, TTFT, tokens/s
    beside the colocated main path's and the streams equal to its."""
    import numpy as np

    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.serving import InferenceEngine

    src = InferenceEngine(params, cfg, main_engine_config(role="prefill"),
                          replica_index=0)
    dst = InferenceEngine(params, cfg, main_engine_config(role="decode"),
                          replica_index=1)
    finite = []
    sample = dst._sample

    def checked(logits):  # on the decode engine's loop thread
        finite.append(torch.isfinite(logits).all())
        return sample(logits)

    dst._sample = checked
    src.start()
    dst.start()
    try:
        # warm-up pair (not part of the run)
        src.submit([1, 2, 3, 4], max_new_tokens=2, request_id="warm")
        _ShipmentPump(src, dst, {"warm": 2}).run(1)["warm"].result(120)
        deadline = time.perf_counter() + 60
        while ((src.pool.occupancy or dst.pool.occupancy)
               and time.perf_counter() < deadline):
            time.sleep(0.001)
        finite.clear()
        reqs = requests(np.random.default_rng(0), cfg.vocab_size, 16, 512, 32,
                        256)
        budgets = {f"d{i}": n for i, (_, n) in enumerate(reqs)}
        first = {}

        def on_token(rid, tok):
            first.setdefault(rid, time.perf_counter())

        pump = _ShipmentPump(src, dst, budgets, on_token, corrupt_first=True)
        before_src, before_dst = dict(src.stats), dict(dst.stats)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        src_comps = [src.submit(p, max_new_tokens=n, request_id=f"d{i}")
                     for i, (p, n) in enumerate(reqs[:8])]
        pump.run(4)
        src_comps += [src.submit(p, max_new_tokens=n, request_id=f"d{i + 8}")
                      for i, (p, n) in enumerate(reqs[8:])]
        comps = pump.run(16)
        got = [comps[f"d{i}"].result(timeout=300) for i in range(16)]
        elapsed = time.perf_counter() - t
        for c in src_comps:
            c.result(timeout=60)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        src.drain(timeout=60)
        dst.drain(timeout=60)
    dst._sample = sample
    for i, ((prompt, n), c) in enumerate(zip(reqs, src_comps)):
        d = comps[f"d{i}"]
        check(d.finish_reason == "length" and len(d.tokens) == n
              and all(0 <= x < cfg.vocab_size for x in d.tokens),
              f"serving_disagg d{i}: {d.finish_reason}, {len(d.tokens)} tokens")
        check(c.finish_reason == "migrated",
              f"serving_disagg d{i}: the prefill side ended {c.finish_reason}")
    prefills = src.stats["prefills"] - before_src["prefills"]
    steps = dst.stats["decode_steps"] - before_dst["decode_steps"]
    check(prefills == 16 and src.stats["decode_steps"] ==
          before_src["decode_steps"],
          f"serving_disagg: {prefills} prefills, the prefill engine decoded "
          f"{src.stats['decode_steps'] - before_src['decode_steps']} steps")
    check(dst.stats["prefills"] - before_dst["prefills"] == 16,
          "serving_disagg: the decode engine did not admit 16 shipments")
    expect = launches_expected(cfg.n_layers, prefills, steps)
    check(counts == expect, f"serving_disagg: launch counts {counts} != "
          f"{expect}")
    check(len(finite) == steps and bool(torch.stack(finite).all()),
          "serving_disagg: a decode step's logits are not finite")
    for name, eng in (("prefill", src), ("decode", dst)):
        st = eng.pool.allocator.stats()
        check(eng.pool.occupancy == 0 and st["chains_pinned"] == 0
              and st["blocks_used"] == 0,
              f"serving_disagg: the {name} pool ends with occupancy "
              f"{eng.pool.occupancy}, {st['chains_pinned']} chains pinned, "
              f"{st['blocks_used']} blocks used")
    sizes = [pump.ships[f"d{i}"].nbytes() for i in range(16)]
    block_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * 16 * cfg.head_dim
                   * params["embed"].element_size())
    check(all(s % block_bytes == 0 for s in sizes),
          f"serving_disagg: shipment sizes {sizes} not whole blocks of "
          f"{block_bytes} bytes")
    e2e = sorted(first[f"d{i}"] - src_comps[i].submitted_at for i in range(16))
    dttft = sorted(comps[f"d{i}"].ttft_s for i in range(16))
    same = sum(a == b for a, b in zip(got, streams))
    tokens = sum(len(g) for g in got)
    (em, ex), (vm, vx), (im, ix) = (_median_max(pump.export_s),
                                    _median_max(pump.verify_s),
                                    _median_max(pump.import_s))
    log(f"serving_disagg on {card}: prefill engine (role prefill, replica 0) "
        f"and decode engine (role decode, replica 1) on one card and one "
        f"params dict, each on its loop thread on the default stream; 16 "
        f"requests ({prefills} prefills on the prefill engine, {steps} decode "
        f"steps on the decode engine over imported blocks, {tokens} tokens) "
        f"in {elapsed:.3f}s -> {tokens / elapsed:.1f} tokens/s beside the "
        f"colocated main path's {colocated_tps:.1f}; TTFT submit -> first "
        f"token on the decode engine median {e2e[8] * 1e3:.1f} ms max "
        f"{e2e[-1] * 1e3:.1f} ms, the decode engine's own (import -> first "
        f"token) median {dttft[8] * 1e3:.1f} ms max {dttft[-1] * 1e3:.1f} ms; "
        f"{same} of 16 greedy streams equal the colocated main path's "
        "(bf16; not checked)")
    log(f"serving_disagg shipments on {card}: {block_bytes / 2**20:.2f} MiB a "
        f"block of 16 positions, {min(sizes) / 2**20:.1f}-"
        f"{max(sizes) / 2**20:.1f} MiB a request, {sum(sizes) / 2**20:.1f} MiB "
        f"in all, every one verified; export (gather, device to host, "
        f"checksums) median {em * 1e3:.1f} ms max {ex * 1e3:.1f} ms; verify "
        f"median {vm * 1e3:.1f} ms max {vx * 1e3:.1f} ms; import (the call: "
        f"the receiver's own verify and host staging on this thread, then its "
        f"loop's next tick: reservation, host to device) median "
        f"{im * 1e3:.1f} ms max {ix * 1e3:.1f} ms; a "
        f"corrupt copy of {pump.corrupt[0]} refused (ShipmentCorrupt) with the "
        f"receiver at occupancy {pump.corrupt[1]} and {pump.corrupt[2]} free "
        f"blocks before and after, its clean resend decoded; "
        f"{pump.rejected} imports refused for capacity and offered again; "
        f"launches {counts}")
    del src, dst, pump, comps, src_comps
    gc.collect()
    torch.cuda.empty_cache()
    return counts, tokens / elapsed


def serving_tenants(torch, card, cfg, params):
    """The main path's paged engine with three tenants (``TENANT_SPECS``):
    24 requests, 8 a tenant, submitted at once over the 8 slots with the
    main path's prompt mix and 32 new tokens. ``free``'s bucket holds 4
    admissions: its other 4 raise QuotaExceeded, never RequestShed; while
    gold and silver are both backlogged their admissions keep to 4:2 within
    one quantum (|gold - 2 x silver| <= 4 at every prefix); the first gold
    request, admitted at once, runs out of its deadline mid-decode and ends
    ``"expired"`` with its partial tokens and its blocks released; the
    launches are exact. Printed: TTFT median and max per tenant."""
    import numpy as np

    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.serving import (
        InferenceEngine,
        QuotaExceeded,
        RequestShed,
        TenantRegistry,
        parse_tenant_specs,
    )

    engine = InferenceEngine(params, cfg, main_engine_config())
    serve(engine, [([1, 2, 3, 4], 2)], 1)  # warm-up, not part of the run
    registry = TenantRegistry(parse_tenant_specs(TENANT_SPECS))
    engine.configure_tenants(registry)
    admitted = []
    tick = engine.scheduler.tick

    def recorded():
        plan = tick()
        admitted.extend(req.tenant for req, _ in plan.prefills)
        return plan

    engine.scheduler.tick = recorded
    reqs = requests(np.random.default_rng(0), cfg.vocab_size, 24, 512, 32, 256)
    tenants = ["gold"] + ["silver", "free", "gold"] * 7 + ["silver", "free"]
    before = dict(engine.stats)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    comps, refused = [], []
    for i, ((prompt, n), tenant) in enumerate(zip(reqs, tenants)):
        try:
            comps.append(engine.submit(
                prompt, max_new_tokens=n, request_id=f"{tenant}{i}",
                tenant=tenant,
                deadline_ms=TENANT_DEADLINE_MS if i == 0 else None))
        except QuotaExceeded as e:
            check(not isinstance(e, RequestShed),
                  "serving_tenants: a quota refusal counted as a shed")
            refused.append(f"{tenant}{i}")
    late = comps[0]
    expired_at = None
    while engine.scheduler.has_work():
        engine.step()
        if expired_at is None and late.done:
            expired_at = len(late.tokens)
            check(late.request_id not in engine.pool.allocator._allocs
                  and all(s.request_id != late.request_id
                          for s in engine.pool.slots),
                  "serving_tenants: the expired request kept its blocks")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(refused == [f"free{i}" for i, t in enumerate(tenants)
                      if t == "free"][4:],
          f"serving_tenants: refused {refused}")
    check(registry.admitted.get("free") == 4
          and registry.quota_rejected == {"free": 4}
          and engine.scheduler.admitted_by_tenant.get("free") == 4,
          f"serving_tenants: free admitted {registry.admitted}, refused "
          f"{registry.quota_rejected}")
    check(late.finish_reason == "expired" and 0 < len(late.tokens) < 32,
          f"serving_tenants: the deadline request ended {late.finish_reason} "
          f"with {len(late.tokens)} tokens")
    g = s = 0
    worst = 0
    for name in admitted:
        if g >= 8 or s >= 8:
            break  # one of the two queues is empty: no longer both backlogged
        g += name == "gold"
        s += name == "silver"
        worst = max(worst, abs(g - 2 * s))
    check(admitted[0] == "gold" and worst <= 4,
          f"serving_tenants: admissions {admitted} stray {worst} from 4:2")
    for c in comps[1:]:
        check(c.finish_reason == "length" and len(c.tokens) == 32,
              f"serving_tenants {c.request_id}: {c.finish_reason}")
    prefills = engine.stats["prefills"] - before["prefills"]
    steps = engine.stats["decode_steps"] - before["decode_steps"]
    expect = launches_expected(cfg.n_layers, prefills, steps)
    check(prefills == 20 and counts == expect,
          f"serving_tenants: {prefills} prefills, launches {counts} != {expect}")
    check(engine.pool.allocator.used_blocks == 0 and engine.pool.occupancy == 0,
          "serving_tenants: the pool does not end empty")
    per = []
    for tenant in ("gold", "silver", "free"):
        ttfts = sorted(c.ttft_s for c in comps
                       if c.tenant == tenant and c.ttft_s is not None)
        med, mx = _median_max(ttfts)
        per.append(f"{tenant} {len(ttfts)} requests: median {med * 1e3:.1f} "
                   f"ms max {mx * 1e3:.1f} ms")
    log(f"serving_tenants on {card}: {TENANT_SPECS!r}, 24 requests at once "
        f"over 8 slots: free admitted 4, refused 4 (QuotaExceeded, no shed); "
        f"admissions {''.join(t[0] for t in admitted)} (|gold - 2 x silver| "
        f"<= {worst} while both backlogged); {late.request_id}'s "
        f"{TENANT_DEADLINE_MS:.0f} ms deadline ran out after "
        f"{len(late.tokens)} tokens ('expired', blocks released); {prefills} "
        f"prefills, {steps} decode steps; TTFT " + "; ".join(per)
        + f"; launches {counts}")
    del engine, comps, late
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _journaled(journal, engine, entries, replica):
    """(Re)dispatch each entry to ``engine`` through the journal: prompt +
    delivered, the remaining budget, the entry's stream guard."""
    for entry in entries:
        rid, prompt, budget = journal.begin_attempt(entry, replica=replica)
        comp = engine.submit(prompt, max_new_tokens=budget, request_id=rid,
                             on_token=journal.stream_guard(entry, rid))
        journal.bind(entry, comp)


def serving_faults(torch, card, cfg, params, streams):
    """Serving faults on the main path's engine and requests, each request a
    RequestJournal entry. (1) ``SERVE_FAULT_DROP``: the 2nd admitted
    request's stream drops after 4 tokens; the journal resumes it on the
    same engine (prompt + delivered, the remaining budget, id ``~r1``) and
    its stream reaches 32 tokens; every 4th tick stalls 50 ms. (2)
    ``SERVE_FAULT_CRASH`` on a loop thread: the loop dies at tick 8,
    ``alive`` is False, every request in flight fails with ServeFault; 8
    more submitted to the dead engine are handed back by
    ``handback_queued``; the dead engine is dropped and the card's memory
    comes back; a fresh engine serves the journal's resumptions and the
    handed-back requests to 32 tokens each. Launches exact in each run."""
    import numpy as np

    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.runtime.faults import ServeFault
    from ray_lightning_tpu_torch.serving import InferenceEngine, RequestJournal

    L = cfg.n_layers
    reqs = requests(np.random.default_rng(0), cfg.vocab_size, 16, 512, 32, 256)
    total = {}

    # (1) drop-stream and slow-decode, stepped here
    restore = _fault_env(SERVE_FAULT_DROP)
    try:
        engine = InferenceEngine(params, cfg, main_engine_config(),
                                 replica_index=0)
        journal = RequestJournal()
        entries = [journal.open(p, n, request_id=f"f{i}")
                   for i, (p, n) in enumerate(reqs)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        ticks = {}

        def step():
            t = time.perf_counter()
            engine.step()
            ticks[engine._ticks] = time.perf_counter() - t

        _journaled(journal, engine, entries[:8], 0)
        for _ in range(4):
            step()
        _journaled(journal, engine, entries[8:], 0)
        while engine.scheduler.has_work():
            step()
        dropped = [e for e in entries
                   if e.attempt_completion.finish_reason == "error"]
        check(len(dropped) == 1,
              f"serving_faults: dropped streams {[e.request_id for e in dropped]}")
        cut = dropped[0].attempt_completion
        check(isinstance(cut.error, ServeFault) and len(cut.tokens) == 4,
              f"serving_faults: the drop after {len(cut.tokens)} tokens "
              f"({cut.error!r})")
        _journaled(journal, engine, dropped, 0)
        while engine.scheduler.has_work():
            step()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        restore()
    entry = dropped[0]
    check(entry.request_id == "f1" and entry.attempt_rid == "f1~r1"
          and entry.attempts == 2,
          f"serving_faults: resumed {entry.request_id} as {entry.attempt_rid}")
    for e in entries:
        c = e.attempt_completion
        check(c.finish_reason == "length" and len(e.delivered) == 32,
              f"serving_faults {e.request_id}: {c.finish_reason}, "
              f"{len(e.delivered)} tokens")
        journal.finish(e, "completed", finish_reason="length")
    prefills = engine.stats["prefills"]
    steps = engine.stats["decode_steps"]
    expect = launches_expected(L, prefills, steps)
    check(prefills == 17 and counts == expect,
          f"serving_faults drop: {prefills} prefills, launches {counts} != "
          f"{expect}")
    _add(total, counts)
    stalled = [v for k, v in ticks.items() if k % 4 == 0]
    others = [v for k, v in ticks.items() if k % 4]
    check(min(stalled) >= 0.05, f"serving_faults: a stalled tick took "
          f"{min(stalled) * 1e3:.1f} ms")
    same = entry.delivered == streams[1]
    log(f"serving_faults drop on {card}: {SERVE_FAULT_DROP!r}: f1's stream "
        f"dropped after 4 tokens (ServeFault), the journal resumed it as "
        f"f1~r1 (prompt + 4 delivered, budget 28) on the same engine and its "
        f"stream reached 32 tokens, equal to the unfaulted main path's: "
        f"{same} (bf16; not checked); journal {journal.stats()}; {prefills} "
        f"prefills, {steps} decode steps; the {len(stalled)} stalled ticks "
        f"median {_median(stalled) * 1e3:.1f} ms, the {len(others)} others "
        f"{_median(others) * 1e3:.1f} ms; launches {counts}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # (2) a crash at tick 8 on the loop thread
    torch.cuda.synchronize()
    base_alloc, base_mib = torch.cuda.memory_allocated(), _card_used_mib()
    restore = _fault_env(SERVE_FAULT_CRASH)
    try:
        engine = InferenceEngine(params, cfg, main_engine_config(),
                                 replica_index=0)
        journal = RequestJournal()
        entries = [journal.open(p, n, request_id=f"c{i}")
                   for i, (p, n) in enumerate(reqs)]
        kernels.reset_launch_counts()
        _journaled(journal, engine, entries[:8], 0)
        engine.start()
        deadline = time.perf_counter() + 120
        while engine.alive and time.perf_counter() < deadline:
            time.sleep(0.005)
    finally:
        restore()
    check(not engine.alive and isinstance(engine.failed, ServeFault),
          f"serving_faults crash: alive {engine.alive}, failed {engine.failed!r}")
    crash_counts = kernels.launch_counts()
    crashed_ticks = engine._ticks
    delivered = [len(e.delivered) for e in entries[:8]]
    for e in entries[:8]:
        c = e.attempt_completion
        check(c.finish_reason == "error" and isinstance(c.error, ServeFault),
              f"serving_faults crash {e.request_id}: {c.finish_reason}")
    _journaled(journal, engine, entries[8:], 0)  # a router that missed it
    back = engine.handback_queued()
    check([b["request_id"] for b in back] == [f"c{i}" for i in range(8, 16)]
          and all(e.attempt_completion.finish_reason == "cancelled"
                  for e in entries[8:]),
          f"serving_faults crash: handed back {[b['request_id'] for b in back]}")
    prefilled = engine.stats["prefills"]
    expect = launches_expected(L, prefilled, engine.stats["decode_steps"])
    check(crash_counts == expect, f"serving_faults crash: launches "
          f"{crash_counts} != {expect}")
    _add(total, crash_counts)
    # the journal's next attempts drop every reference to the dead engine
    pending = [(e, journal.begin_attempt(e, replica=1)) for e in entries]
    del engine, back, e, c
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after_alloc, after_mib = torch.cuda.memory_allocated(), _card_used_mib()
    check(after_alloc <= base_alloc + 64 * 2**20
          and after_mib <= base_mib + 1024,
          f"serving_faults crash: after dropping the dead engine {after_alloc} "
          f"bytes allocated ({base_alloc} before), {after_mib} MiB used on the "
          f"card ({base_mib} before)")
    engine = InferenceEngine(params, cfg, main_engine_config(), replica_index=1)
    kernels.reset_launch_counts()
    for e, (rid, prompt, budget) in pending:
        comp = engine.submit(prompt, max_new_tokens=budget, request_id=rid,
                             on_token=journal.stream_guard(e, rid))
        journal.bind(e, comp)
    engine.run_until_idle()
    torch.cuda.synchronize()
    fresh_counts = kernels.launch_counts()
    for e in entries:
        check(e.attempt_completion.finish_reason == "length"
              and len(e.delivered) == 32,
              f"serving_faults relaunch {e.request_id}: "
              f"{e.attempt_completion.finish_reason}, {len(e.delivered)} tokens")
        journal.finish(e, "completed", finish_reason="length")
    expect = launches_expected(L, engine.stats["prefills"],
                               engine.stats["decode_steps"])
    check(fresh_counts == expect, f"serving_faults relaunch: launches "
          f"{fresh_counts} != {expect}")
    _add(total, fresh_counts)
    same = sum(e.delivered == s for e, s in zip(entries, streams))
    log(f"serving_faults crash on {card}: {SERVE_FAULT_CRASH!r} on the loop "
        f"thread: the loop died at tick {crashed_ticks} after "
        f"{prefilled} prefills, alive False, the 8 requests in flight or "
        f"queued failed with ServeFault after {delivered} tokens; 8 more "
        f"submitted to the dead engine handed back ('cancelled'); the dead "
        f"engine dropped: {after_alloc / 2**30:.3f} GiB allocated "
        f"({base_alloc / 2**30:.3f} before), {after_mib} MiB used on the card "
        f"({base_mib} before); a fresh engine served the 8 resumptions and the "
        f"8 handed back to 32 tokens each ({same} of 16 equal the unfaulted "
        f"main path's; bf16, not checked); journal {journal.stats()}; "
        f"launches {crash_counts} then {fresh_counts}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return total


def disagg_exactness(torch):
    """fp32 at Llama-3-8B widths, 2 layers: a prefill and a decode engine,
    each on its loop thread, on 6 staggered requests: every migrated stream
    equals the colocated engine's, ``generate``'s and iterated plain
    ``forward``; a
    shipment's payload is bitwise the prefill engine's cache blocks; and
    under ``replica0:drop-stream@req2:4`` the journaled stream equals the
    unfaulted one."""
    import numpy as np

    from ray_lightning_tpu_torch.models.generation import generate
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        forward,
        init_params,
    )
    from ray_lightning_tpu_torch.serving import (
        EngineConfig,
        InferenceEngine,
        RequestJournal,
    )

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(6))
    kw = dict(num_slots=4, max_prompt_len=64, max_len=128, block_size=16,
              kv_layout="paged")
    reqs = requests(np.random.default_rng(6), cfg.vocab_size, 6, 64, 8, 32)
    colocated = [c.tokens for c in serve(
        InferenceEngine(params, cfg, EngineConfig(**kw)), reqs, 3)]
    plain = []
    for prompt, n in reqs:
        toks = list(prompt)
        for _ in range(n):
            logits = forward(params, torch.tensor([toks], device="cuda"), cfg,
                             plain=True)
            toks.append(int(torch.argmax(logits[0, -1].float())))
        plain.append(toks[len(prompt):])
    check(colocated == plain, f"disagg exactness: colocated {colocated} != "
          f"forward {plain}")
    generated = [generate(params, torch.tensor([p], device="cuda"), cfg,
                          n)[0, len(p):].tolist() for p, n in reqs]
    check(generated == plain, f"disagg exactness: generate {generated} != "
          f"forward {plain}")

    src = InferenceEngine(params, cfg, EngineConfig(role="prefill", **kw),
                          replica_index=0)
    dst = InferenceEngine(params, cfg, EngineConfig(role="decode", **kw),
                          replica_index=1)
    src.start()
    dst.start()
    try:
        budgets = {f"e{i}": n for i, (_, n) in enumerate(reqs)}
        # the first shipment's payload against the cache, before the pump
        src.submit(reqs[0][0], max_new_tokens=reqs[0][1], request_id="e0")
        deadline = time.perf_counter() + 60
        ready = []
        while not ready and time.perf_counter() < deadline:
            ready = src.drain_ready_exports()
            time.sleep(0.001)
        ship = src.export_shipment("e0")
        with src._work:
            blocks = list(src.pool._alloc_of[src._exports["e0"]["slot"]].blocks)
        for j in range(ship.num_blocks):
            for name, payload in (("k", ship.block_k), ("v", ship.block_v)):
                want = src.pool.cache[name][:, blocks[j]].cpu().numpy()
                check(np.array_equal(payload[j], want),
                      f"disagg exactness: block {j} {name} is not the cache's")
        pump = _ShipmentPump(src, dst, budgets)
        pump.comps["e0"] = dst.import_shipment(ship, max_new_tokens=reqs[0][1],
                                               request_id="e0")
        src.finish_export("e0")
        for i, (p, n) in enumerate(reqs[1:], 1):
            src.submit(p, max_new_tokens=n, request_id=f"e{i}")
        comps = pump.run(len(reqs))
        migrated = [comps[f"e{i}"].result(timeout=120) for i in range(len(reqs))]
    finally:
        src.drain(timeout=60)
        dst.drain(timeout=60)
    check(migrated == plain, f"disagg exactness: migrated {migrated} != "
          f"forward {plain}")

    restore = _fault_env("replica0:drop-stream@req2:4")
    try:
        engine = InferenceEngine(params, cfg, EngineConfig(**kw),
                                 replica_index=0)
        journal = RequestJournal()
        entries = [journal.open(p, n) for p, n in reqs]
        _journaled(journal, engine, entries, 0)
        engine.run_until_idle()
        dropped = [e for e in entries
                   if e.attempt_completion.finish_reason == "error"]
        check(len(dropped) == 1, f"disagg exactness: {len(dropped)} drops")
        _journaled(journal, engine, dropped, 0)
        engine.run_until_idle()
    finally:
        restore()
    got = [list(e.delivered) for e in entries]
    check(got == plain, f"disagg exactness: journaled {got} != {plain}")
    log(f"disagg exactness: fp32 llama3_8b widths, 2 layers: {len(plain)} "
        f"migrated greedy streams (prefill engine -> decode engine, each on "
        f"its loop thread) token-identical to the colocated engine's, "
        f"generate's and iterated plain forward; a shipment's {ship.num_blocks} blocks "
        f"bitwise the cache's; under drop-stream@req2:4 the journal's resumed "
        f"stream ({dropped[0].attempt_rid}) token-identical to the unfaulted")
    del params, src, dst, engine
    gc.collect()
    torch.cuda.empty_cache()


FLEET_BUDGET_S = 45.0  # serving_fleet and fleet_exactness together
# every incarnation of replica 0 dies at its 24th tick (no fuse)
FLEET_KILL_SPEC = "replica0:crash@every:24"
# fleet_exactness: the decode replica 1 dies every 6th tick (no fuse), the
# first shipment from the prefill replica is corrupted, and an incarnation
# of the decode replica 2 crashes while admitting its second
FLEET_EXACT_SPEC = ("replica1:crash@every:6,replica0:corrupt-shipment@req1,"
                    "replica2:crash-mid-admit@req2")
FLEET_SLACK = 128 * 2**20  # bytes; a KV pool of the main path is 1 GiB


def launches_consistent(L, counts):
    """Launch counts that some number of prefills and one-token paged decode
    steps explain exactly (``launches_expected`` of the prefills that
    flash's count gives and the steps that argmax's gives)."""
    prefills, rem = divmod(counts["flash_fwd"], L)
    return rem == 0 and counts == launches_expected(L, prefills,
                                                     counts["argmax"])


def _staggered(fleet, reqs, prefix, first_wave=8, started=4, timeout=300.0):
    """Submit ``reqs`` to the fleet in two waves, the second once
    ``started`` requests of the first have their first token; returns the
    journal entries."""
    entries = [fleet.submit(p, max_new_tokens=n, request_id=f"{prefix}{i}")
               for i, (p, n) in enumerate(reqs[:first_wave])]
    deadline = time.perf_counter() + timeout
    while sum(e.first_token_at is not None for e in entries) < started:
        check(time.perf_counter() < deadline,
              f"{prefix}: no first tokens in {timeout}s")
        time.sleep(0.002)
    entries += [fleet.submit(p, max_new_tokens=n,
                             request_id=f"{prefix}{i + first_wave}")
                for i, (p, n) in enumerate(reqs[first_wave:])]
    return entries


def _check_full(label, entries, reqs, vocab):
    for e, (_, n) in zip(entries, reqs):
        check(e.done and e.disposition == "completed"
              and e.finish_reason == "length" and len(e.tokens) == n
              and all(0 <= t < vocab for t in e.tokens),
              f"{label} {e.request_id}: {e.disposition}/{e.finish_reason}, "
              f"{len(e.tokens)} tokens")


def _allocated_after_gc(torch):
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def serving_fleet(torch, card, cfg, params, colocated_tps, pair_tps, streams):
    """The fleet (``LocalReplicaFleet``) on the main path's weights and
    engine settings, every replica sharing the one params dict. (1)
    Disaggregated, one prefill and two decode replicas: the main path's 16
    staggered requests each end ``"length"`` with 32 tokens, 16 migrate with
    no fallback, both decode replicas are routed to, the launches are exact
    summed per engine (prefills only on the prefill replica, every decode
    step on a decode replica), the logits are finite, and every pool ends
    empty with no chain pinned. (2) A kill loop: two homogeneous replicas
    under ``FLEET_KILL_SPEC`` with retries and a breaker: every request
    completes to its length, none fails, some retried and some replica
    relaunched, and after the shutdown the allocated memory is back to its
    level before the fleet. (3) The Autoscaler over a one-replica fleet and
    a burst of 24 requests of 16 tokens: at least one scale-up, every
    request completes, idle ticks drain the fleet back to one replica and
    the memory to the one-replica level. Printed: tokens/s and TTFT beside
    the colocated main path's and the hand pump's (``serving_disagg``), each
    ``add_replica``'s time, and how many disaggregated bf16 streams equal
    the colocated ones (not checked). The kill loop's streams are not
    compared: its prompts are cut to 480 tokens, and no unfaulted run of
    them is made (fp32 streams are held under faults in
    ``fleet_exactness``)."""
    import numpy as np

    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.serving import Autoscaler, LocalReplicaFleet

    L, V = cfg.n_layers, cfg.vocab_size
    ekw = dataclasses.asdict(main_engine_config())
    reqs = requests(np.random.default_rng(0), V, 16, 512, 32, 256)
    total = {}

    # (1) disaggregated
    fleet = LocalReplicaFleet(lambda: (params, cfg), engine_kwargs=ekw,
                              initial_replicas=3, prefill_replicas=1,
                              device="cuda")
    try:
        check(fleet.roles == {0: "prefill", 1: "decode", 2: "decode"},
              f"serving_fleet: roles {fleet.roles}")
        finite = []
        for eng in fleet._replicas.values():
            def checked(logits, sample=eng._sample):
                finite.append(torch.isfinite(logits).all())
                return sample(logits)

            eng._sample = checked
        fleet.submit([1, 2, 3, 4], max_new_tokens=2).result(timeout=120)
        deadline = time.perf_counter() + 60
        while any(e.pool.occupancy for e in fleet._replicas.values()):
            check(time.perf_counter() < deadline, "serving_fleet: warm-up")
            time.sleep(0.001)
        engines = dict(fleet._replicas)
        before = {i: dict(e.stats) for i, e in engines.items()}
        m0, routed0 = fleet.migration_stats.as_dict(), dict(fleet.routed_total)
        finite.clear()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        entries = _staggered(fleet, reqs, "f")
        for e in entries:
            e.result(timeout=300)
        elapsed = time.perf_counter() - t
        deadline = time.perf_counter() + 60
        while any(e.pool.occupancy for e in engines.values()):
            check(time.perf_counter() < deadline,
                  "serving_fleet: a pool did not empty")
            time.sleep(0.001)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        m = {k: v - m0[k] for k, v in fleet.migration_stats.as_dict().items()}
        routed = {i: fleet.routed_total[i] - routed0.get(i, 0)
                  for i in engines}
        transfer = sorted(fleet.migration_stats.transfer_ms[-16:])
        delta = {i: {k: engines[i].stats[k] - before[i][k]
                     for k in ("prefills", "decode_steps")} for i in engines}
        pools = {i: (e.pool.occupancy,
                     e.pool.allocator.stats()["chains_pinned"],
                     e.pool.allocator.stats()["blocks_used"])
                 for i, e in engines.items()}
    finally:
        fleet.shutdown()
    _check_full("serving_fleet", entries, reqs, V)
    check(m["migrated"] == 16 and m["fallbacks"] == 0 and m["corrupt"] == 0,
          f"serving_fleet: migration {m}")
    check(routed[1] >= 1 and routed[2] >= 1,
          f"serving_fleet: decode replicas routed {routed}")
    steps = delta[1]["decode_steps"] + delta[2]["decode_steps"]
    check(delta[0] == {"prefills": 16, "decode_steps": 0}
          and delta[1]["prefills"] + delta[2]["prefills"] == 16,
          f"serving_fleet: per-engine prefills and steps {delta}")
    expect = launches_expected(L, 16, steps)
    check(counts == expect, f"serving_fleet: launch counts {counts} != "
          f"{expect}")
    check(len(finite) == steps and bool(torch.stack(finite).all()),
          f"serving_fleet: {len(finite)} sampled steps of {steps}, or a "
          "decode step's logits are not finite")
    check(all(v == (0, 0, 0) for v in pools.values()),
          f"serving_fleet: pools (occupancy, chains pinned, blocks used) "
          f"{pools}")
    _add(total, counts)
    tokens = sum(len(e.tokens) for e in entries)
    ttfts = sorted(e.ttft_s for e in entries)
    same = sum(e.tokens == s for e, s in zip(entries, streams))
    log(f"serving_fleet disaggregated on {card}: LocalReplicaFleet(3 "
        f"replicas, prefill_replicas=1) on one params dict, each replica on "
        f"its loop thread, the pump serial; 16 requests (16 prefills on the "
        f"prefill replica, {steps} decode steps on the decode replicas: "
        f"{delta[1]['decode_steps']} and {delta[2]['decode_steps']}, routed "
        f"{routed}) in {elapsed:.3f}s -> {tokens / elapsed:.1f} tokens/s "
        f"beside the colocated main path's {colocated_tps:.1f} and the hand "
        f"pump's (serving_disagg) {pair_tps:.1f}; TTFT submit -> first token "
        f"median {ttfts[8] * 1e3:.1f} ms max {ttfts[-1] * 1e3:.1f} ms; "
        f"migration {m}, a shipment's send-verify-admit median "
        f"{transfer[len(transfer) // 2]:.1f} ms max {transfer[-1]:.1f} ms; "
        f"{same} of 16 greedy streams equal the colocated main path's (bf16; "
        f"not checked); launches {counts}")
    del fleet, entries, engines

    # (2) the kill loop
    kill_reqs = requests(np.random.default_rng(0), V, 16, 480, 32, 256)
    base = _allocated_after_gc(torch)
    restore = _fault_env(FLEET_KILL_SPEC)
    try:
        fleet = LocalReplicaFleet(lambda: (params, cfg), engine_kwargs=ekw,
                                  initial_replicas=2, max_retries=4,
                                  breaker_threshold=3, breaker_cooldown_s=1.0,
                                  device="cuda")
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t = time.perf_counter()
            entries = _staggered(fleet, kill_reqs, "k")
            for e in entries:
                e.result(timeout=300)
            elapsed = time.perf_counter() - t
            stats = fleet.stats()
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        finally:
            fleet.shutdown()
    finally:
        restore()
    _check_full("serving_fleet kill loop", entries, kill_reqs, V)
    check(stats["failed"] == 0 and stats["retries"] >= 1
          and stats["relaunches"] >= 1,
          f"serving_fleet kill loop: {stats}")
    check(launches_consistent(L, counts),
          f"serving_fleet kill loop: launch counts {counts}")
    _add(total, counts)
    tokens = sum(len(e.tokens) for e in entries)
    transitions = [(a, b) for _, a, b in fleet.breakers[0].transitions]
    del fleet, entries
    after = _allocated_after_gc(torch)
    check(after <= base + FLEET_SLACK,
          f"serving_fleet kill loop: {after} bytes allocated after the "
          f"shutdown, {base} before the fleet")
    log(f"serving_fleet kill loop on {card}: {FLEET_KILL_SPEC!r}, 2 "
        f"replicas, max_retries 4, breaker 3 / 1.0 s: 16 requests (prompts "
        f"up to 480 tokens, so that a resume fits the 512 prefill) "
        f"completed to 32 tokens in {elapsed:.3f}s -> {tokens / elapsed:.1f} "
        f"tokens/s; journal {stats['completed']} completed, "
        f"{stats['failed']} failed, {stats['retries']} retries, "
        f"{stats['relaunches']} relaunches, routed {stats['routed']}; "
        f"replica 0's breaker {transitions}; {after} bytes allocated after "
        f"the shutdown, {base} before the fleet; launches {counts}")

    # (3) the autoscaler
    # 16 new tokens a request: the burst is about scaling, not decoding
    burst = requests(np.random.default_rng(1), V, 24, 512, 16, 256)
    fleet = LocalReplicaFleet(lambda: (params, cfg), engine_kwargs=ekw,
                              initial_replicas=1, device="cuda")
    adds = []
    add_replica = fleet.add_replica

    def timed_add(*args, **kwargs):
        t = time.perf_counter()
        index = add_replica(*args, **kwargs)
        adds.append((index, time.perf_counter() - t))
        return index

    fleet.add_replica = timed_add
    scaler = Autoscaler(fleet, min_replicas=1, max_replicas=3, queue_high=2)
    try:
        fleet.submit([1, 2, 3, 4], max_new_tokens=2).result(timeout=120)
        one = _allocated_after_gc(torch)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        entries = [fleet.submit(p, max_new_tokens=n, request_id=f"a{i}")
                   for i, (p, n) in enumerate(burst[:12])]
        deadline = time.perf_counter() + 300
        peak = 1
        while not all(e.done for e in entries) or len(entries) < 24:
            check(time.perf_counter() < deadline,
                  "serving_fleet autoscaler: the burst did not finish")
            scaler.tick()
            peak = max(peak, fleet.num_replicas)
            if scaler.scale_ups and len(entries) < 24:
                entries += [fleet.submit(p, max_new_tokens=n,
                                         request_id=f"a{i + 12}")
                            for i, (p, n) in enumerate(burst[12:])]
            time.sleep(0.05)
        elapsed = time.perf_counter() - t
        while fleet.num_replicas > 1:
            check(time.perf_counter() < deadline,
                  f"serving_fleet autoscaler: {fleet.num_replicas} replicas "
                  "left after the burst")
            scaler.tick()
            time.sleep(0.05)
        for th in fleet._drain_threads:
            th.join(timeout=60)
        check(not fleet._draining, "serving_fleet autoscaler: a drain hung")
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        stats = fleet.stats()
        back = _allocated_after_gc(torch)
    finally:
        fleet.shutdown()
    _check_full("serving_fleet autoscaler", entries, burst, V)
    check(scaler.scale_ups >= 1 and scaler.scale_downs == scaler.scale_ups,
          f"serving_fleet autoscaler: {scaler.scale_ups} up, "
          f"{scaler.scale_downs} down")
    check(back <= one + FLEET_SLACK,
          f"serving_fleet autoscaler: {back} bytes allocated back at one "
          f"replica, {one} at one replica before")
    check(launches_consistent(L, counts),
          f"serving_fleet autoscaler: launch counts {counts}")
    _add(total, counts)
    tokens = sum(len(e.tokens) for e in entries)
    log(f"serving_fleet autoscaler on {card}: Autoscaler(min 1, max 3, "
        f"queue_high 2) over a one-replica fleet, 24 requests of 16 tokens "
        f"(12, then 12 after the first scale-up) in {elapsed:.3f}s -> "
        f"{tokens / elapsed:.1f} tokens/s, peak {peak} replicas, history "
        f"{[(round(h[0] - scaler.history[0][0], 3), h[1], h[2]) for h in scaler.history]}, "
        f"routed {stats['routed']}; each add_replica (a 1 GiB KV pool and "
        f"warmup) {[(i, round(s, 3)) for i, s in adds]} s; {back} bytes "
        f"allocated back at one replica ({one} before the burst); launches "
        f"{counts}")
    del fleet, entries
    gc.collect()
    torch.cuda.empty_cache()
    return total


def fleet_exactness(torch):
    """fp32 at Llama-3-8B widths, 2 layers: a disaggregated fleet (a prefill
    and two decode replicas) under ``FLEET_EXACT_SPEC`` (a kill loop on one
    decode replica, a corrupt shipment, crashes mid-admit on the other):
    every stream equals ``generate``'s and iterated plain ``forward``'s,
    none fails, the corrupt shipment is caught and replicas are relaunched.
    Returns the launch counts."""
    import numpy as np

    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.models.generation import generate
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        forward,
        init_params,
    )
    from ray_lightning_tpu_torch.serving import LocalReplicaFleet

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
    kw = dict(num_slots=4, max_prompt_len=64, max_len=128, block_size=16,
              kv_layout="paged")
    # prompts up to 56 tokens: a resumed prompt (+ 7 delivered) fits 64
    reqs = requests(np.random.default_rng(7), cfg.vocab_size, 6, 56, 8, 32)
    t = time.perf_counter()
    plain = []
    for prompt, n in reqs:
        toks = list(prompt)
        for _ in range(n):
            logits = forward(params, torch.tensor([toks], device="cuda"), cfg,
                             plain=True)
            toks.append(int(torch.argmax(logits[0, -1].float())))
        plain.append(toks[len(prompt):])
    generated = [generate(params, torch.tensor([p], device="cuda"), cfg,
                          n)[0, len(p):].tolist() for p, n in reqs]
    check(generated == plain, f"fleet exactness: generate {generated} != "
          f"forward {plain}")
    refs_s = time.perf_counter() - t
    t = time.perf_counter()
    restore = _fault_env(FLEET_EXACT_SPEC)
    try:
        fleet = LocalReplicaFleet(lambda: (params, cfg), engine_kwargs=kw,
                                  initial_replicas=3, prefill_replicas=1,
                                  max_retries=8, breaker_threshold=3,
                                  breaker_cooldown_s=0.5, device="cuda")
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            entries = [fleet.submit(p, max_new_tokens=n)
                       for p, n in reqs]
            got = [e.result(timeout=300) for e in entries]
            stats = fleet.stats()
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        finally:
            fleet.shutdown()
    finally:
        restore()
    fleet_s = time.perf_counter() - t
    check(got == plain, f"fleet exactness: streams {got} != forward {plain}")
    m = stats["migration"]
    check(stats["completed"] == len(reqs) and stats["failed"] == 0
          and m["corrupt"] >= 1 and stats["relaunches"] >= 1,
          f"fleet exactness: {stats}")
    check(launches_consistent(cfg.n_layers, counts),
          f"fleet exactness: launch counts {counts}")
    log(f"fleet exactness: fp32 llama3_8b widths, 2 layers, a prefill and "
        f"two decode replicas under {FLEET_EXACT_SPEC!r}: {len(reqs)} greedy "
        f"streams token-identical to generate's and iterated plain forward; "
        f"journal {stats['completed']} completed, {stats['failed']} failed, "
        f"{stats['retries']} retries, {stats['relaunches']} relaunches; "
        f"migration {m}; breakers' failures "
        f"{ {i: b.failures_total for i, b in fleet.breakers.items()} }; "
        f"the references {refs_s:.1f}s, the fleet's run {fleet_s:.1f}s; "
        f"launches {counts}")
    del params, fleet, entries
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def spec_exactness(torch):
    """fp32 at Llama-3-8B widths, 2 layers, both layouts: the
    ``speculate_k=4`` engine's greedy streams must equal the
    ``speculate_k=0`` engine's token for token, on prompts of repeated
    segments, and more tokens than verify steps must have been accepted
    (the multi-token path ran)."""
    import numpy as np

    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(11))
    reqs = repeating_requests(np.random.default_rng(11), cfg.vocab_size, 6, 8,
                              4, 24)
    for layout in ("paged", "slot"):
        streams, stats = {}, {}
        for k in (0, SPEC_K):
            engine = InferenceEngine(params, cfg, EngineConfig(
                num_slots=4, max_prompt_len=64, max_len=128, block_size=16,
                kv_layout=layout, speculate_k=k))
            streams[k] = [c.tokens for c in serve(engine, reqs, 3)]
            stats[k] = dict(engine.stats)
            del engine
        check(streams[SPEC_K] == streams[0],
              f"spec exactness ({layout}): speculate_k={SPEC_K} "
              f"{streams[SPEC_K]} != speculate_k=0 {streams[0]}")
        s = stats[SPEC_K]
        check(s["accepted_tokens"] > s["spec_row_ticks"],
              f"spec exactness ({layout}): {s['accepted_tokens']} tokens in "
              f"{s['spec_row_ticks']} slot ticks: no proposal was accepted")
        log(f"spec exactness: fp32 llama3_8b widths, 2 layers, {layout}: "
            f"{len(reqs)} greedy streams at speculate_k={SPEC_K} token-"
            f"identical to speculate_k=0; {s['accepted_tokens']} tokens in "
            f"{s['spec_row_ticks']} slot ticks "
            f"({s['accepted_tokens'] / s['spec_row_ticks']:.3f} a slot a step), "
            f"{s['decode_steps']} decode steps against {stats[0]['decode_steps']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# Qwen2.5-7B-Instruct's published config.json (the fields the importer
# reads), with the yarn scaling its model card documents for long inputs
QWEN25_7B = dict(
    vocab_size=152064, hidden_size=3584, intermediate_size=18944,
    num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
    max_position_embeddings=32768, rms_norm_eps=1e-6, rope_theta=1e6,
    sliding_window=131072, use_sliding_window=False, max_window_layers=28,
    tie_word_embeddings=False,
    rope_scaling={"type": "yarn", "factor": 4.0,
                  "original_max_position_embeddings": 32768},
)


def qwen_model(torch, dtype, seed, **fields):
    """Qwen2.5-7B-Instruct through ``config_from_hf`` (qkv bias: the
    importer reads it from the weights, so it is stated here), random
    weights from a seeded generator, the biases drawn too (init zeroes
    them)."""
    from types import SimpleNamespace

    from ray_lightning_tpu_torch.models.hf_import import config_from_hf
    from ray_lightning_tpu_torch.models.llama import init_params

    cfg = config_from_hf(SimpleNamespace(**dict(QWEN25_7B, **fields)),
                         dtype=dtype, attn_bias=True)
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, g)
    for name in ("bq", "bk", "bv"):
        b = params["layers"][name]
        b.copy_(0.5 * torch.randn(b.shape, generator=g, device="cuda"))
    return cfg, params


def serving_qwen_yarn(torch, card):
    """Qwen2.5-7B-Instruct at full width and depth (vocab 152064, dim 3584,
    28 layers, 28 query / 4 KV heads: GQA group 7, ffn 18944, qkv bias, rope
    theta 1e6 with yarn x4 over 32768), bf16, on the paged engine and the
    main path's 16 requests: paged decode runs at G 7 (padded to its G 8
    instantiation) and argmax at V 152064."""
    from ray_lightning_tpu_torch.ops.rope import rope_scaling_kind

    t = time.perf_counter()
    cfg, params = qwen_model(torch, torch.bfloat16, 12)
    torch.cuda.synchronize()
    n_params = sum(leaf.numel() for leaf in _leaves(params))
    n_bias = sum(params["layers"][n].numel() for n in ("bq", "bk", "bv"))
    check(n_params - n_bias == cfg.num_params()  # biases: not counted, as in JAX
          and cfg.n_heads // cfg.n_kv_heads == 7 and cfg.attn_bias
          and not cfg.sliding_window
          and rope_scaling_kind(cfg.rope_scaling) == "yarn",
          f"qwen2.5-7b config {cfg}, {n_params} parameters")
    log(f"qwen2.5-7b-instruct (yarn x4): {n_params / 1e9:.2f} B params bf16 "
        f"initialised in {time.perf_counter() - t:.1f}s")
    # no profiled rerun: the path's kernels and matmuls are the main
    # path's at other widths
    counts, engine, _, _ = serve_path(torch, card, cfg, params,
                                      "serving_qwen_yarn", profile=False)
    r = decode_step_time(torch, engine, cfg)
    log(f"serving_qwen_yarn decode step on {card} (8 rows, pos up to 1023): "
        f"{r['ms']:.3f} ms graph replay (eager {r['ms_eager']:.3f} ms) against "
        f"a {r['bound_ms']:.3f} ms bound ({r['bound_by']}: "
        f"{r['bytes'] / 1e9:.3f} GB), {r['bound_ms'] / r['ms']:.1%} of its bound")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def qwen_exactness(torch):
    """fp32 at Qwen2.5-7B widths, 2 layers: the paged engine's greedy
    tokens (paged decode at G 7, yarn tables) must equal iterated plain
    ``forward`` calls."""
    import numpy as np

    from ray_lightning_tpu_torch.models.llama import forward
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg, params = qwen_model(torch, torch.float32, 13, num_hidden_layers=2)
    engine = InferenceEngine(params, cfg, EngineConfig(
        num_slots=4, max_prompt_len=64, max_len=128, block_size=16,
        kv_layout="paged"))
    reqs = requests(np.random.default_rng(13), cfg.vocab_size, 6, 64, 8, 32)
    comps = serve(engine, reqs, 3)
    for comp, (prompt, n) in zip(comps, reqs):
        toks = list(prompt)
        for _ in range(n):
            logits = forward(params, torch.tensor([toks], device="cuda"), cfg,
                             plain=True)
            toks.append(int(torch.argmax(logits[0, -1].float())))
        check(comp.tokens == toks[len(prompt):],
              f"{comp.request_id}: engine {comp.tokens} != forward "
              f"{toks[len(prompt):]}")
    log(f"qwen exactness: fp32 qwen2.5-7b widths (G 7, qkv bias, yarn), 2 "
        f"layers: {len(comps)} greedy streams of the paged engine "
        "token-identical to iterated plain forward")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()


# Phi-3-mini-128k-instruct's published config.json (the fields the importer
# reads). Its 48-entry long/short factor lists are not in this repository:
# the lists below are deterministic placeholders of the published shape, so
# the tables' numbers differ from the published model's while every shape
# and all the work are its own.
PHI3_MINI_128K = dict(
    vocab_size=32064, hidden_size=3072, intermediate_size=8192,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
    max_position_embeddings=131072, original_max_position_embeddings=4096,
    rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=262144,
    tie_word_embeddings=False,
    rope_scaling={"type": "longrope",
                  "long_factor": [1.0 + 0.5 * i for i in range(48)],
                  "short_factor": [1.0 + 0.02 * i for i in range(48)]},
)


def phi3_config(torch, dtype, **fields):
    from types import SimpleNamespace

    from ray_lightning_tpu_torch.models.hf_import import config_from_hf

    return config_from_hf(SimpleNamespace(**dict(PHI3_MINI_128K, **fields)),
                          dtype=dtype)


def generate_longrope(torch, card):
    """``generate`` of Phi-3-mini-128k at full width and depth (vocab 32064,
    dim 3072, 32 layers, 32 / 32 heads of dim 96, ffn 8192, longrope over a
    4096-position pretrain context, placeholder factor lists), bf16: 4
    prompts of 4608 tokens and 64 greedy new tokens, past 4096, so one table
    of the long factors serves prefill and every decode step. Tokens in the
    vocabulary, every logit finite, the kernels launched as the layer count
    says (flash forward at head dim 96, RMSNorm at dim 3072)."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.models.generation import generate
    from ray_lightning_tpu_torch.models.llama import init_params
    from ray_lightning_tpu_torch.ops.rope import rope_scaling_kind

    cfg = phi3_config(torch, torch.bfloat16)
    scaling = dict(cfg.rope_scaling)
    check(cfg.head_dim == 96 and cfg.n_layers == 32
          and rope_scaling_kind(cfg.rope_scaling) == "longrope"
          and scaling["factor"] == 32.0
          and scaling["original_max_position_embeddings"] == 4096,
          f"phi-3 config {cfg}")
    log("generate_longrope: the published 48-entry long/short factor lists "
        "are not in this repository; the run uses deterministic placeholder "
        "lists of the same shape (long 1.0 + 0.5 i, short 1.0 + 0.02 i): the "
        "shapes and the work are Phi-3-mini-128k's, its numbers are not")
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(14))
    torch.cuda.synchronize()
    n_params = sum(leaf.numel() for leaf in _leaves(params))
    check(n_params == cfg.num_params(),
          f"{n_params} parameters, the config counts {cfg.num_params()}")
    log(f"phi-3-mini-128k: {n_params / 1e9:.2f} B params bf16 initialised in "
        f"{time.perf_counter() - t:.1f}s")
    B, P, new = 4, 4608, 64
    V, L = cfg.vocab_size, cfg.n_layers
    prompt = torch.randint(0, V, (B, P), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(15))
    generate(params, prompt, cfg, 2)  # warm-up at the run's shapes
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    with GenerationProbe(torch) as probe:
        out = generate(params, prompt, cfg, new)
    elapsed = time.perf_counter() - t
    counts = kernels.launch_counts()
    prefill_s, decode_s = probe.times_s()
    steps = len(probe.positions)
    kv_shape = (L, B, cfg.n_kv_heads, P + new, cfg.head_dim)
    check(probe.cache_shape == kv_shape,
          f"generate_longrope: cache {probe.cache_shape} != {kv_shape}")
    check(probe.positions == list(range(P, P + new - 1)),
          f"generate_longrope: decode positions {probe.positions[:3]}...")
    check(tuple(out.shape) == (B, P + new) and bool((out[:, :P] == prompt).all())
          and 0 <= int(out[:, P:].min()) and int(out[:, P:].max()) < V,
          "generate_longrope: bad output")
    check(probe.all_finite(), "generate_longrope: a step's logits are not finite")
    expect = {"rmsnorm": (2 * L + 1) * (1 + steps), "flash_fwd": L,
              "paged_decode": 0, "argmax": 0, "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0}
    check(counts == expect,
          f"generate_longrope: launch counts {counts} != {expect}")
    kv_gib = 2 * math.prod(kv_shape) * 2 / 2**30
    log(f"generate_longrope on {card}: phi-3-mini-128k, batch {B}, prompts of "
        f"{P} tokens (past the 4096 pretrain context: long factors), {new} "
        f"greedy new tokens in {elapsed:.3f}s: prefill {prefill_s * 1e3:.1f} ms "
        f"({B * P / prefill_s:.0f} prompt tokens/s); {steps} decode steps in "
        f"{decode_s:.3f}s -> {B * steps / decode_s:.1f} tokens/s "
        f"({decode_s / steps * 1e3:.2f} ms a step); cache {kv_shape} x2 = "
        f"{kv_gib:.2f} GiB bf16; all logits finite")
    log(f"generate_longrope launches: {counts} (rmsnorm {2 * L + 1} a forward, "
        f"flash_fwd {L} at the prefill)")
    del params, out
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def longrope_exactness(torch):
    """fp32 at Phi-3-mini widths, 2 layers: ``generate`` on two prompts of
    4100 tokens with 8 new tokens must equal iterated plain ``forward``
    calls: every sequence is past the 4096-position pretrain context, so
    both rotate with the long factors, generate's one table and each
    forward's own."""
    import numpy as np

    from ray_lightning_tpu_torch.models.generation import generate
    from ray_lightning_tpu_torch.models.llama import forward, init_params

    cfg = phi3_config(torch, torch.float32, num_hidden_layers=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(16))
    P, n_new = 4100, 8
    prompts = np.random.default_rng(16).integers(0, cfg.vocab_size, (2, P))
    got = generate(params, torch.from_numpy(prompts).cuda(), cfg,
                   n_new)[:, P:].tolist()
    plain = []
    for p in prompts.tolist():
        toks = list(p)
        for _ in range(n_new):
            logits = forward(params, torch.tensor([toks], device="cuda"), cfg,
                             plain=True)
            toks.append(int(torch.argmax(logits[0, -1].float())))
        plain.append(toks[P:])
    check(got == plain, f"longrope exactness: generate {got} != forward {plain}")
    log(f"longrope exactness: fp32 phi-3-mini widths (hd 96, longrope), 2 "
        f"layers: {len(plain)} greedy streams of generate past the 4096 "
        "pretrain context token-identical to iterated plain forward")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# Mixtral-8x7B-v0.1's published config.json (the fields the importer reads)
MIXTRAL_8X7B = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=1e6,
    sliding_window=None, num_local_experts=8, num_experts_per_tok=2,
    router_aux_loss_coef=0.02, tie_word_embeddings=False,
)
MOE_LAYERS = 16  # 23.5 B parameters, ~47 GB in bf16: 32 layers (93.4 GB) do not fit


def mixtral_config(torch, n_layers, dtype):
    from types import SimpleNamespace

    from ray_lightning_tpu_torch.models.hf_import import mixtral_config_from_hf

    hf = SimpleNamespace(**dict(MIXTRAL_8X7B, num_hidden_layers=n_layers))
    return mixtral_config_from_hf(hf, dtype=dtype)


# Mistral-7B-v0.1's published config.json (the fields the importer reads)
MISTRAL_7B = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=10000.0,
    sliding_window=4096, tie_word_embeddings=False,
)


def mistral_config(torch, dtype, **fields):
    from types import SimpleNamespace

    from ray_lightning_tpu_torch.models.hf_import import config_from_hf

    return config_from_hf(SimpleNamespace(**dict(MISTRAL_7B, **fields)),
                          dtype=dtype)


class GenerationProbe:
    """Records what ``generate`` does inside: the cache shape prefill gets,
    every decode step's position and logits, and CUDA events on the stream
    around the prefill. It adds no device sync and no device work to the
    run: the logits are checked for finiteness after it. Installed over the
    module's ``prefill`` and ``decode_step``, which ``generate`` looks up at
    each call."""

    def __init__(self, torch):
        from ray_lightning_tpu_torch.models import generation

        self.torch, self.gen = torch, generation
        self.real = (generation.prefill, generation.decode_step)
        self.cache_shape, self.positions, self.logits = None, [], []
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def prefill(self, params, prompt, cfg, cache, table):
        self.cache_shape = tuple(cache["k"].shape)
        self.events[0].record()
        logits, cache = self.real[0](params, prompt, cfg, cache, table)
        self.events[1].record()
        self.logits.append(logits)
        return logits, cache

    def decode_step(self, params, cache, token, pos, cfg, table):
        self.positions.append(int(pos))
        logits, cache = self.real[1](params, cache, token, pos, cfg, table)
        self.logits.append(logits)
        return logits, cache

    def __enter__(self):
        self.gen.prefill, self.gen.decode_step = self.prefill, self.decode_step
        return self

    def __exit__(self, *exc):
        self.gen.prefill, self.gen.decode_step = self.real
        self.events[2].record()
        self.torch.cuda.synchronize()

    def times_s(self):
        """(prefill, decode loop) seconds on the stream's timeline."""
        e = self.events
        return e[0].elapsed_time(e[1]) / 1e3, e[1].elapsed_time(e[2]) / 1e3

    def all_finite(self):
        return bool(self.torch.stack(
            [x.isfinite().all() for x in self.logits]).all())


def generate_window(torch, card):
    """``generate`` of Mistral-7B-v0.1 at full width and depth (its
    published config through the port's ``config_from_hf``, random bf16
    weights from a seeded generator): 4 prompts of 4608 tokens, past the
    4096-position window, and 64 greedy new tokens. The rolling cache is
    the window's length, so prefill scatters the prompt's last 4096
    positions to their slots and every decode step wraps; tokens in the
    vocabulary, every logit finite, the kernels launched as the layer count
    says (flash forward once a layer, RMSNorm 2L + 1 a forward; the sampler
    of ``generate`` is torch's, as JAX's is ``jnp.argmax``)."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.models.generation import (
        EOS_POLL_STEPS,
        decode_step,
        dense_decode_attention,
        generate,
        init_kv_cache,
    )
    from ray_lightning_tpu_torch.models.llama import init_params
    from ray_lightning_tpu_torch.ops.rope import rope_angles

    cfg = mistral_config(torch, torch.bfloat16)
    check(cfg.sliding_window == 4096 and cfg.n_layers == 32,
          f"mistral config {cfg}")
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
    torch.cuda.synchronize()
    n_params = sum(leaf.numel() for leaf in _leaves(params))
    check(n_params == cfg.num_params(),
          f"{n_params} parameters, the config counts {cfg.num_params()}")
    log(f"mistral-7b-v0.1: {n_params / 1e9:.2f} B params bf16 initialised in "
        f"{time.perf_counter() - t:.1f}s")
    B, P, new = 4, 4608, 64
    V, L, C = cfg.vocab_size, cfg.n_layers, cfg.sliding_window
    prompt = torch.randint(0, V, (B, P), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(8))
    # warm-up at the run's shapes (a prefill and one decode step), so that
    # no timed run pays for first allocations
    generate(params, prompt, cfg, 2)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    with GenerationProbe(torch) as probe:
        out = generate(params, prompt, cfg, new)
    elapsed = time.perf_counter() - t
    counts = kernels.launch_counts()
    prefill_s, decode_s = probe.times_s()
    steps = len(probe.positions)
    kv_shape = (L, B, cfg.n_kv_heads, C, cfg.head_dim)
    check(probe.cache_shape == kv_shape,
          f"generate_window: cache {probe.cache_shape} != {kv_shape}")
    check(P > C, "the prompt does not reach past the window: no scatter")
    check(probe.positions == list(range(P, P + new - 1))
          and min(probe.positions) >= C,
          f"generate_window: decode positions {probe.positions[:3]}...")
    check(tuple(out.shape) == (B, P + new) and bool((out[:, :P] == prompt).all())
          and 0 <= int(out[:, P:].min()) and int(out[:, P:].max()) < V,
          "generate_window: bad output")
    check(probe.all_finite(),
          "generate_window: a step's logits are not finite")
    expect = {"rmsnorm": (2 * L + 1) * (1 + steps), "flash_fwd": L,
              "paged_decode": 0, "argmax": 0, "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0}
    check(counts == expect,
          f"generate_window: launch counts {counts} != {expect}")
    kv_gib = 2 * math.prod(kv_shape) * 2 / 2**30
    log(f"generate_window on {card}: mistral-7b-v0.1, batch {B}, prompts of "
        f"{P} tokens, {new} greedy new tokens in {elapsed:.3f}s: prefill "
        f"{prefill_s * 1e3:.1f} ms ({B * P / prefill_s:.0f} prompt "
        f"tokens/s); {steps} decode steps in {decode_s:.3f}s -> "
        f"{B * steps / decode_s:.1f} tokens/s ({decode_s / steps * 1e3:.2f} ms "
        f"a step); rolling cache {kv_shape} x2 = {kv_gib:.2f} GiB bf16 "
        f"(C = window); prefill scattered the last {C} of {P} positions, "
        f"decode wrapped at positions {P}..{P + steps - 1}; all logits finite")
    log(f"generate_window launches: {counts} (rmsnorm {2 * L + 1} a forward, "
        f"flash_fwd {L} at the prefill)")
    # the same run with an eos_id that it never emits, between two more
    # runs without: generate then reads "has every row finished?" back to
    # the host every EOS_POLL_STEPS steps, and the gap is what that costs
    emitted = set(out[:, P:].flatten().tolist())
    eos = next(tok for tok in range(V) if tok not in emitted)
    step_ms = {"without eos_id": [], "with eos_id": []}
    for eos_id in (None, eos, None, eos):
        with GenerationProbe(torch) as again:
            again_out = generate(params, prompt, cfg, new, eos_id=eos_id)
        check(torch.equal(again_out, out) and len(again.positions) == steps,
              f"generate_window: a run with eos_id {eos_id} (never emitted) "
              "differs from the first")
        key = "without eos_id" if eos_id is None else "with eos_id"
        step_ms[key].append(again.times_s()[1] / steps * 1e3)
    log(f"generate_window decode on {card}, alternating runs without and "
        f"with eos_id {eos} (never emitted; the host reads the finished flag "
        f"every {EOS_POLL_STEPS} steps): ms a step "
        + "; ".join(f"{k} " + ", ".join(f"{x:.2f}" for x in v)
                    for k, v in step_ms.items()))
    # one decode step at the run's last position, by graph replay and
    # eagerly, and the dense attention of its layers alone (the cache holds
    # zeros: neither time depends on its contents)
    cache = init_kv_cache(cfg, B, P + new)
    table = rope_angles(P + new, cfg.head_dim, cfg.rope_theta,
                        scaling=cfg.rope_scaling, device="cuda")
    token, last = out[:, -1].contiguous(), P + new - 2

    def step():
        decode_step(params, cache, token, last, cfg, table)

    ms = time_ms(torch, step, iters=3, warmup=2)
    ms_eager = time_ms(torch, step, iters=3, warmup=1, graph=False)
    q = torch.randn((B, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                     cfg.head_dim), device="cuda")
    masked = torch.zeros((B, 1, 1, C), dtype=torch.bool, device="cuda")

    def attend():
        for i in range(L):
            dense_decode_attention(q, cache["k"][i], cache["v"][i], masked)

    attn_ms = time_ms(torch, attend, iters=3, warmup=2)
    weights = tree_bytes(params["layers"]) + tree_bytes(params["lm_head"])
    b, by = bound(weights + 2 * math.prod(kv_shape) * 2, 0, BF16_FLOPS)
    log(f"generate_window decode step on {card} (4 rows, all {C} slots "
        f"valid): {ms:.3f} ms graph replay (eager {ms_eager:.3f} ms) against "
        f"a {b:.3f} ms bound ({by}: weights and the rolling cache read once), "
        f"{b / ms:.1%} of its bound; the dense fp32 attention of its {L} "
        f"layers {attn_ms:.3f} ms by graph replay, {attn_ms / ms:.1%} of the "
        "step")
    del params, out, again_out, cache
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _leaves(tree):
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    return list(tree_leaves(tree))


def _paths(tree, prefix=""):
    """(key path, leaf) of a dict tree, in tree_leaves order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def decode_step_time(torch, engine, cfg, k=1):
    """One decode step of the full batch (8 rows at ragged positions up to
    1023) on the engine's params and pool, paged or slot, timed by the
    replay of a CUDA graph (the device's time alone) and eagerly (the host's
    launch rate included), beside its bytes bound: every weight read once
    (lossless routing runs every expert), the K/V of the attended positions
    read, the new positions' K/V written, the embedding rows and the fp32
    logits. With ``k`` > 1 the step is a ``decode_step_verify`` of k
    candidates a row, the last of them at position 1023 - 97 b."""
    from ray_lightning_tpu_torch.models.generation import (
        decode_step_paged,
        decode_step_ragged,
        decode_step_verify,
    )

    n = engine.pool.num_slots
    dev = engine.device
    pos_list = [1023 - 97 * b - (k - 1) for b in range(n)]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    token = torch.arange(n * k, dtype=torch.int32, device=dev).view(n, k) * 7 + 11
    tables = None
    if engine.engine_config.kv_layout == "paged":
        bs = engine.engine_config.block_size
        maxb = engine.engine_config.max_len // bs
        check(engine.pool.cache["k"].shape[1] > n * maxb,
              "the pool is too small for the decode timing's tables")
        tables = torch.arange(1, 1 + n * maxb, dtype=torch.int32,
                              device=dev).view(n, maxb)

    def step():
        if k > 1:
            decode_step_verify(engine.params, engine.pool.cache, token, pos,
                               cfg, engine._table, block_tables=tables)
        elif tables is not None:
            decode_step_paged(engine.params, engine.pool.cache, token[:, 0],
                              pos, tables, cfg, engine._table)
        else:
            decode_step_ragged(engine.params, engine.pool.cache, token[:, 0],
                               pos, cfg, engine._table)

    ms = time_ms(torch, step, iters=3, warmup=2)
    ms_eager = time_ms(torch, step, iters=3, warmup=1, graph=False)
    p = engine.params
    L, hkv, hd, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.dim
    kv_elt = engine.pool.cache["k"].element_size()
    weights = (tree_bytes(p["layers"]) + tree_bytes(p["lm_head"])
               + tree_bytes(p["final_norm"])
               + n * k * d * p["embed"].element_size())
    attended = sum(pp + k for pp in pos_list)  # the deepest query's span
    kv = attended * L * 2 * hkv * hd * kv_elt
    nbytes = (weights + kv + n * k * L * 2 * hkv * hd * kv_elt
              + n * k * cfg.vocab_size * 4)
    # products: 2 FLOP per weight element and row (every expert on every
    # row), plus q.k and p.v over each query's attended positions
    flops = 2 * n * k * (sum(t.numel() for t in _leaves(p["layers"]))
                         + p["lm_head"].numel()) \
        + sum(pp + i + 1 for pp in pos_list for i in range(k)) \
        * L * cfg.n_heads * hd * 4
    b, by = bound(nbytes, flops, BF16_FLOPS)
    return dict(ms=ms, ms_eager=ms_eager, bound_ms=b, bound_by=by,
                weight_bytes=weights, kv_bytes=kv, bytes=nbytes, flops=flops,
                pos=pos)


def serving_moe(torch, card):
    """The MoE serving path: Mixtral-8x7B widths (vocab 32000, dim 4096, 32
    query / 8 KV heads, ffn 14336, 8 experts top-2, rope theta 1e6) cut to
    16 layers, bf16, random weights from a seeded generator, through the
    paged engine on the main path's requests; then one decode step's
    device time beside its bytes bound."""
    from ray_lightning_tpu_torch.models.llama import init_params

    cfg = mixtral_config(torch, MOE_LAYERS, torch.bfloat16)
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(leaf.numel() for leaf in _leaves(params))
    check(n_params == cfg.num_params(),
          f"{n_params} parameters, the config counts {cfg.num_params()}")
    log(f"mixtral-8x7b widths, {cfg.n_layers} layers: {n_params / 1e9:.2f} B "
        f"params bf16 ({tree_bytes(params) / 1e9:.1f} GB, router fp32) "
        f"initialised in {time.perf_counter() - t:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    counts, engine, _, _ = serve_path(torch, card, cfg, params, "serving_moe")
    r = decode_step_time(torch, engine, cfg)
    log(f"serving_moe decode step on {card} (8 rows, pos up to 1023): "
        f"{r['ms']:.3f} ms graph replay (eager {r['ms_eager']:.3f} ms) against "
        f"a {r['bound_ms']:.3f} ms bound ({r['bound_by']}: "
        f"{r['bytes'] / 1e9:.3f} GB = weights {r['weight_bytes'] / 1e9:.3f} "
        f"+ K/V {r['kv_bytes'] / 1e9:.4f}; {r['flops'] / 1e12:.3f} TFLOP), "
        f"{r['bound_ms'] / r['ms']:.1%} of its bound")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def moe_exactness(torch):
    """The MoE engine in fp32 at Mixtral widths, cut to 2 layers: its greedy
    tokens (lossless routing, the kernels) must equal iterated full
    ``forward`` calls through the plain versions, which route with the
    capacity bound at ``capacity_factor = E / top_k``, where it never
    binds."""
    import numpy as np

    from ray_lightning_tpu_torch.models.llama import forward, init_params
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = mixtral_config(torch, 2, torch.float32)
    check(cfg.capacity_factor == cfg.n_experts / cfg.expert_top_k,
          f"capacity_factor {cfg.capacity_factor}")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(6))
    engine = InferenceEngine(params, cfg, EngineConfig(
        num_slots=4, max_prompt_len=64, max_len=128, block_size=16,
        kv_layout="paged"))
    reqs = requests(np.random.default_rng(6), cfg.vocab_size, 6, 64, 8, 32)
    comps = serve(engine, reqs, 3)
    for comp, (prompt, n) in zip(comps, reqs):
        toks = list(prompt)
        for _ in range(n):
            logits = forward(params, torch.tensor([toks], device="cuda"), cfg,
                             plain=True)
            toks.append(int(torch.argmax(logits[0, -1].float())))
        check(comp.tokens == toks[len(prompt):],
              f"{comp.request_id}: engine {comp.tokens} != forward "
              f"{toks[len(prompt):]}")
    log(f"moe exactness: fp32 mixtral-8x7b widths, 2 layers: {len(comps)} "
        "greedy streams (lossless routing, kernels) token-identical to "
        "iterated plain forward (capacity routing at E/top_k)")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()


def exactness(torch):
    import numpy as np

    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        forward,
        init_params,
    )
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(5))
    engine = InferenceEngine(params, cfg, EngineConfig(
        num_slots=4, max_prompt_len=64, max_len=128, block_size=16,
        kv_layout="paged"))
    reqs = requests(np.random.default_rng(5), cfg.vocab_size, 6, 64, 8, 32)
    comps = serve(engine, reqs, 3)
    for comp, (prompt, n) in zip(comps, reqs):
        toks = list(prompt)
        for _ in range(n):
            logits = forward(params, torch.tensor([toks], device="cuda"), cfg,
                             plain=True)
            toks.append(int(torch.argmax(logits[0, -1].float())))
        check(comp.tokens == toks[len(prompt):],
              f"{comp.request_id}: engine {comp.tokens} != forward "
              f"{toks[len(prompt):]}")
    log(f"exactness: fp32 llama3_8b widths, 2 layers: {len(comps)} greedy "
        "streams token-identical to iterated plain forward")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()


def slot_exactness(torch):
    """fp32 at Llama-3-8B widths, 2 layers, 6 prompts of 48 tokens and 8
    greedy new tokens: the slot engine's streams (staggered over 4 slots)
    must equal the paged engine's, the port's batched ``generate`` and
    iterated plain ``forward`` calls."""
    import numpy as np

    from ray_lightning_tpu_torch.models.generation import generate
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        forward,
        init_params,
    )
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(8))
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, (6, 48))
    n_new = 8
    reqs = [(p.tolist(), n_new) for p in prompts]
    streams = {}
    for layout in ("slot", "paged"):
        engine = InferenceEngine(params, cfg, EngineConfig(
            num_slots=4, max_prompt_len=64, max_len=128, block_size=16,
            kv_layout=layout))
        streams[layout] = [c.tokens for c in serve(engine, reqs, 3)]
        del engine
    streams["generate"] = generate(
        params, torch.from_numpy(prompts).cuda(), cfg, n_new)[:, 48:].tolist()
    plain = []
    for p in prompts.tolist():
        toks = list(p)
        for _ in range(n_new):
            logits = forward(params, torch.tensor([toks], device="cuda"), cfg,
                             plain=True)
            toks.append(int(torch.argmax(logits[0, -1].float())))
        plain.append(toks[48:])
    for name, got in streams.items():
        check(got == plain, f"slot exactness: {name} {got} != forward {plain}")
    log(f"slot exactness: fp32 llama3_8b widths, 2 layers: {len(plain)} greedy "
        "streams of the slot engine token-identical to the paged engine's, "
        "batched generate's and iterated plain forward")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def window_exactness(torch):
    """fp32 at Mistral-7B-v0.1 widths with the window cut to 64 (so each
    step's full forward is cheap), 2 layers: ``generate`` on two 100-token
    prompts with 40 new tokens (a 64-position cache that wraps) must equal
    iterated plain windowed ``forward`` calls."""
    import numpy as np

    from ray_lightning_tpu_torch.models.generation import generate
    from ray_lightning_tpu_torch.models.llama import forward, init_params

    cfg = mistral_config(torch, torch.float32, num_hidden_layers=2,
                         sliding_window=64)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(10))
    prompts = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 100))
    n_new = 40
    with GenerationProbe(torch) as probe:
        got = generate(params, torch.from_numpy(prompts).cuda(), cfg,
                       n_new)[:, 100:].tolist()
    check(probe.cache_shape[3] == 64 and max(probe.positions) >= 64,
          f"window exactness: cache {probe.cache_shape} did not roll")
    plain = []
    for p in prompts.tolist():
        toks = list(p)
        for _ in range(n_new):
            logits = forward(params, torch.tensor([toks], device="cuda"), cfg,
                             plain=True)
            toks.append(int(torch.argmax(logits[0, -1].float())))
        plain.append(toks[100:])
    check(got == plain, f"window exactness: generate {got} != forward {plain}")
    log(f"window exactness: fp32 mistral-7b-v0.1 widths, window 64, 2 layers: "
        f"{len(plain)} greedy streams of generate (cache {probe.cache_shape}, "
        "wrapping) token-identical to iterated plain windowed forward")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phases 6 to 10: the training paths
# --------------------------------------------------------------------- #
TRAIN_STEPS = 10  # measured steps, after one warm-up step
TRAIN_BATCH = 8
TRAIN_VAL_BATCHES = 2
VARIANT_STEPS = 5  # measured steps of the "dots" and no-remat lines
COMPLETE_UPDATES = 10  # measured updates of the complete-Trainer path
COMPLETE_ACCUM = 2  # micro-batches per update
COMPLETE_MICRO = 4  # rows of a micro-batch: 2 x 4 x 2048 tokens an update


def device_breakdown(torch, prof, wall_ms):
    """Device time of a profiled window by class (each port kernel, cuBLAS
    matmuls, the rest) and the idle share of ``wall_ms``."""
    import collections

    classes = collections.Counter()
    other = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        us = e.time_range.elapsed_us()
        port = [v for k, v in PORT_KERNEL_NAMES.items() if k in e.name]
        if port:
            classes[port[0]] += us
        elif any(k in e.name.lower() for k in MATMUL_NAMES):
            classes["matmul"] += us
        else:
            classes["other"] += us
            other[e.name[:60]] += us
    return classes, other


def step_clock(torch, profile_first=None, profile_count=1):
    """A callback that records a CUDA event at every step's start (no host
    sync) and each step's loss as a device tensor, and runs torch.profiler
    around ``profile_count`` steps from batch ``profile_first``; ``end`` is
    an event after the step before the profiled window."""
    from torch.profiler import ProfilerActivity, profile

    from ray_lightning_tpu_torch.callbacks import Callback

    last = None if profile_first is None else profile_first + profile_count - 1

    class StepClock(Callback):
        def __init__(self):
            self.starts, self.losses = [], []
            self.end = None
            self.prof = None
            self.prof_wall_ms = None

        def on_train_batch_start(self, trainer, module, batch, batch_idx):
            if batch_idx == profile_first:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.start()
                self._t = time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.starts.append(ev)

        def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
            self.losses.append(outputs["loss"])
            if profile_first is not None and batch_idx == profile_first - 1:
                self.end = torch.cuda.Event(enable_timing=True)
                self.end.record()
            if batch_idx == last:
                torch.cuda.synchronize()
                self.prof_wall_ms = (time.perf_counter() - self._t) * 1e3
                self.prof.stop()

    return StepClock()


def log_breakdown(torch, label, clock, unprofiled_ms=None):
    """The profiled window's device time by class and its idle share; with
    ``unprofiled_ms`` (the same work's median time without the profiler,
    from CUDA events), also that time's idle share, taking the profiled
    device time as the work's."""
    classes, other = device_breakdown(torch, clock.prof, clock.prof_wall_ms)
    busy_ms = sum(classes.values()) / 1e3
    if busy_ms == 0:
        log(f"{label}: the profiler saw no device events; breakdown not "
            "measured")
        return
    wall = clock.prof_wall_ms
    steady = ("" if unprofiled_ms is None else
              f"; unprofiled median {unprofiled_ms:.1f} ms, idle "
              f"{max(unprofiled_ms - busy_ms, 0.0):.1f} ms "
              f"({max(unprofiled_ms - busy_ms, 0.0) / unprofiled_ms:.1%})")
    log(f"{label}: wall {wall:.1f} ms, device busy {busy_ms:.1f} ms, idle "
        f"{max(wall - busy_ms, 0.0):.1f} ms "
        f"({max(wall - busy_ms, 0.0) / wall:.1%}){steady}; "
        + ", ".join(f"{k} {v / 1e3:.1f} ms ({v / 1e3 / wall:.1%})"
                    for k, v in classes.most_common()))
    log(f"{label}, largest 'other' device events: " + "; ".join(
        f"{name} {us / 1e3:.1f} ms" for name, us in other.most_common(8)))


def train_main_path(torch, card):
    """Trainer.fit of LlamaConfig.small() at batch 8 x 2048 in bf16 on the
    card: one warm-up step, TRAIN_STEPS measured steps, one profiled step,
    then the validation at the epoch's end (max_steps stops the epoch)."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        SyntheticLMDataModule,
    )

    cfg = LlamaConfig.small()
    total = TRAIN_STEPS + 2
    profiled = total - 1  # batch index of the profiled step
    clock = step_clock(torch, profiled)
    module = LlamaModule(cfg, lr=3e-4, warmup_steps=2, total_steps=total)
    dm = SyntheticLMDataModule(cfg, batch_size=TRAIN_BATCH,
                               n_train=TRAIN_BATCH * 32,
                               n_val=TRAIN_BATCH * TRAIN_VAL_BATCHES)
    trainer = Trainer(device="cuda", max_steps=total, logger=False,
                      enable_checkpointing=False, seed=0, callbacks=[clock])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    trainer.fit(module, datamodule=dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    counts = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    losses = [float(x) for x in clock.losses]
    check(len(losses) == total, f"{len(losses)} train steps, expected {total}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    val_loss = float(trainer.callback_metrics["val_loss"])
    check(math.isfinite(val_loss), f"val_loss {val_loss}")
    L, nv = cfg.n_layers, TRAIN_VAL_BATCHES
    expect = training_launches(L, total, nv)
    check(counts == expect, f"training launch counts {counts} != {expect}")

    # step i's time: from its start event to the next step's start event
    # (the device's time for the step, idle gaps included)
    starts = clock.starts[:profiled] + [clock.end]
    step_ms = [a.elapsed_time(b) for a, b in zip(starts[1:-1], starts[2:])]
    med = sorted(step_ms)[len(step_ms) // 2]
    tokens = TRAIN_BATCH * cfg.max_seq
    flops = cfg.flops_per_token() * tokens
    first_ms = starts[0].elapsed_time(starts[1])
    log(f"training main path on {card}: LlamaConfig.small() "
        f"({cfg.num_params() / 1e9:.3f} B params, bf16, remat, loss_chunks "
        f"{cfg.loss_chunks}) batch {TRAIN_BATCH} x {cfg.max_seq}; fit of "
        f"{total} steps + {nv} val batches in {fit_s:.1f}s; first step "
        f"{first_ms:.1f} ms; median step {med:.1f} ms over {len(step_ms)} "
        f"steps (min {min(step_ms):.1f}, max {max(step_ms):.1f}) -> "
        f"{tokens / (med / 1e3):.0f} tokens/s, MFU "
        f"{flops / (med / 1e3) / BF16_FLOPS:.2%} of 989 TFLOP/s "
        f"({cfg.flops_per_token():.4g} FLOP/token); peak memory "
        f"{peak_gib:.2f} GiB")
    log(f"training losses: {[round(x, 4) for x in losses]}; val_loss "
        f"{val_loss:.4f}")
    log(f"training launches: {counts} (per step: rmsnorm {4 * L + 1}, "
        f"flash_fwd {2 * L}, flash_bwd_dq {L}, flash_bwd_dkv {L}; per val "
        f"batch: rmsnorm {2 * L + 1}, flash_fwd {L})")
    log_breakdown(torch, "training profile of one step", clock)
    del trainer, module, clock
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def training_launches(L, steps, val_batches, remat=True):
    """Kernel launches of ``steps`` training micro-batches and
    ``val_batches`` validation batches of an L-layer model. With remat
    ("nothing" or "dots": the layer's norms and flash forward are
    recomputed, the projections are not kernels) each micro-batch runs
    every layer's two norms and its flash forward twice, the final norm
    (outside the remat region) once, and the two backward kernels once per
    layer; without remat the forward runs once. Validation runs the forward
    alone."""
    fwd = 2 if remat else 1
    return {"rmsnorm": (2 * fwd * L + 1) * steps + (2 * L + 1) * val_batches,
            "flash_fwd": fwd * L * steps + L * val_batches,
            "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps,
            "paged_decode": 0, "argmax": 0}


def remat_variants(torch, card):
    """The main path's bf16 configuration at batch 8 x 2048 under
    remat_policy="dots" and with remat off: one warm-up step and
    VARIANT_STEPS measured steps each, no validation; step time and peak
    memory beside the main path's per-layer remat."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        SyntheticLMDataModule,
    )

    out = {}
    for name, cfg in (
        ("remat dots", dataclasses.replace(LlamaConfig.small(),
                                           remat_policy="dots")),
        ("remat off", dataclasses.replace(LlamaConfig.small(), remat=False)),
    ):
        total = VARIANT_STEPS + 1
        clock = step_clock(torch)
        module = LlamaModule(cfg, lr=3e-4, warmup_steps=2, total_steps=total)
        dm = SyntheticLMDataModule(cfg, batch_size=TRAIN_BATCH,
                                   n_train=TRAIN_BATCH * 16)
        dm.setup("fit")
        trainer = Trainer(device="cuda", max_steps=total, logger=False,
                          enable_checkpointing=False, seed=0, callbacks=[clock])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        trainer.fit(module, train_dataloaders=dm.train_dataloader())
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(x) for x in clock.losses]
        check(len(losses) == total and all(math.isfinite(x) for x in losses),
              f"{name}: losses {losses}")
        expect = training_launches(cfg.n_layers, total, 0, remat=cfg.remat)
        check(counts == expect, f"{name}: launch counts {counts} != {expect}")
        starts = clock.starts + [end]
        step_ms = [a.elapsed_time(b) for a, b in zip(starts[1:-1], starts[2:])]
        med = sorted(step_ms)[len(step_ms) // 2]
        tokens = TRAIN_BATCH * cfg.max_seq
        log(f"training main path with {name} on {card}: LlamaConfig.small() "
            f"bf16 batch {TRAIN_BATCH} x {cfg.max_seq}: median step "
            f"{med:.1f} ms over {len(step_ms)} steps (min {min(step_ms):.1f}, "
            f"max {max(step_ms):.1f}) -> {tokens / (med / 1e3):.0f} tokens/s, "
            f"MFU {cfg.flops_per_token() * tokens / (med / 1e3) / BF16_FLOPS:.2%}"
            f"; peak memory {peak_gib:.2f} GiB; launches {counts}")
        out[name] = {"step_ms": med, "peak_gib": peak_gib}
        del trainer, module, clock
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_complete_path(torch, card):
    """The complete Trainer on the card: LlamaConfig.small() at full width
    and depth with fp32 master weights, precision="bf16-mixed", remat
    "dots", two micro-batches of 4 x 2048 per update, a global-norm clip,
    ThroughputMonitor and EarlyStopping, through SingleDeviceStrategy's
    side-stream input pipeline: one warm-up update, COMPLETE_UPDATES
    measured updates, one profiled update, then validation."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.callbacks import EarlyStopping, ThroughputMonitor
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.strategies import SingleDeviceStrategy
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(LlamaConfig.small(), dtype=torch.float32,
                              remat_policy="dots")
    k = COMPLETE_ACCUM
    updates = COMPLETE_UPDATES + 2  # warm-up, measured, profiled
    total = updates * k
    profiled = (updates - 1) * k  # batch index of the profiled update's start
    seen = set()

    class DtypeProbe(LlamaModule):
        """Records the dtypes of the tensors training_step receives (host
        metadata: no sync)."""

        def training_step(self, params, batch, batch_idx):
            seen.update(str(t.dtype) for t in tree_leaves(params))
            return super().training_step(params, batch, batch_idx)

    clock = step_clock(torch, profiled, k)
    throughput = ThroughputMonitor()
    stopper = EarlyStopping(monitor="val_loss", patience=3)
    module = DtypeProbe(cfg, lr=3e-4, warmup_steps=2, total_steps=updates)
    dm = SyntheticLMDataModule(cfg, batch_size=COMPLETE_MICRO,
                               n_train=COMPLETE_MICRO * 64,
                               n_val=COMPLETE_MICRO * TRAIN_VAL_BATCHES)
    trainer = Trainer(device="cuda", strategy=SingleDeviceStrategy(),
                      precision="bf16-mixed", accumulate_grad_batches=k,
                      gradient_clip_val=1.0, max_steps=total, logger=False,
                      enable_checkpointing=False, seed=0,
                      callbacks=[clock, throughput, stopper])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    trainer.fit(module, datamodule=dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    counts = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    losses = [float(x) for x in clock.losses]
    check(len(losses) == total, f"{len(losses)} micro-batches, expected {total}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(trainer.global_step == total,
          f"global_step {trainer.global_step} != {total} micro-batches")
    dtypes = {str(t.dtype) for t in tree_leaves(trainer.params)}
    check(dtypes == {"torch.float32"}, f"master weights are {dtypes} after fit")
    check(seen == {"torch.bfloat16"}, f"training_step received {seen}")
    val_loss = float(trainer.callback_metrics["val_loss"])
    check(math.isfinite(val_loss), f"val_loss {val_loss}")
    mfu_cb = float(trainer.callback_metrics["train_mfu"])
    check(math.isfinite(mfu_cb) and mfu_cb > 0,
          f"ThroughputMonitor train_mfu {mfu_cb}")
    L, nv = cfg.n_layers, TRAIN_VAL_BATCHES
    expect = training_launches(L, total, nv)
    check(counts == expect, f"complete-path launch counts {counts} != {expect}")

    # update u spans its k micro-batches: from the start event of its first
    # to the start of the next update's first (idle gaps included)
    starts = clock.starts[:profiled] + [clock.end]
    bounds = starts[::k]
    upd_ms = [a.elapsed_time(b) for a, b in zip(bounds[1:-1], bounds[2:])]
    med = sorted(upd_ms)[len(upd_ms) // 2]
    tokens = k * COMPLETE_MICRO * cfg.max_seq
    flops = cfg.flops_per_token() * tokens
    log(f"complete-Trainer training path on {card}: LlamaConfig.small() "
        f"({cfg.num_params() / 1e9:.3f} B params) with fp32 masters, "
        f"bf16-mixed, remat dots, {k} micro-batches of {COMPLETE_MICRO} x "
        f"{cfg.max_seq} per update, clip 1.0; fit of {total} micro-batches "
        f"+ {nv} val batches in {fit_s:.1f}s; median update {med:.1f} ms "
        f"over {len(upd_ms)} updates (min {min(upd_ms):.1f}, max "
        f"{max(upd_ms):.1f}) -> {tokens / (med / 1e3):.0f} tokens/s, MFU "
        f"{flops / (med / 1e3) / BF16_FLOPS:.2%} of 989 TFLOP/s; "
        f"ThroughputMonitor train_mfu {mfu_cb:.2%} (its step is a "
        f"micro-batch); peak memory {peak_gib:.2f} GiB")
    log(f"complete-path losses: {[round(x, 4) for x in losses]}; val_loss "
        f"{val_loss:.4f}; EarlyStopping wait {stopper.wait_count}")
    log(f"complete-path launches: {counts} (per micro-batch: rmsnorm "
        f"{4 * L + 1}, flash_fwd {2 * L}, flash_bwd_dq {L}, flash_bwd_dkv "
        f"{L}; per val batch: rmsnorm {2 * L + 1}, flash_fwd {L})")
    log_breakdown(torch, f"complete-path profile of one update ({k} "
                  "micro-batches)", clock, unprofiled_ms=med)
    del trainer, module, clock
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def train_exactness(torch):
    """fp32, the small widths cut to 2 layers, batch 2 x 2048, remat and the
    chunked loss: the loss and every gradient through the kernels against
    plain=True on the card, then three Trainer steps each way."""
    from ray_lightning_tpu_torch.callbacks import Callback
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        SyntheticLMDataModule,
        init_params,
        lm_loss,
    )
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(LlamaConfig.small(), n_layers=2,
                              dtype=torch.float32)
    check(cfg.remat and cfg.loss_chunks == 8, "exactness config")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
    leaves = list(tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(8))
    out = []
    for plain in (False, True):
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        loss, _ = lm_loss(params, tokens, cfg, plain=plain)
        loss.backward()
        out.append((loss.item(), [t.grad for t in leaves]))
    (loss_k, g_k), (loss_p, g_p) = out
    # fp32 on both sides; sums in another order: 1e-4 relative
    check(abs(loss_k - loss_p) <= 1e-4 * abs(loss_p),
          f"fp32 loss {loss_k} vs plain {loss_p}")
    worst = 0.0
    for a, b in zip(g_k, g_p):
        peak = float(b.abs().max())
        check(peak > 0, "a plain gradient leaf is all zero")
        rel = max_err(a, b) / peak
        worst = max(worst, rel)
        check(rel <= 1e-4, f"gradient leaf {tuple(a.shape)}: rel err {rel:.3g}")
    del params, leaves, out, g_k, g_p
    gc.collect()

    class PlainLlama(LlamaModule):
        def training_step(self, params, batch, batch_idx):
            loss, logs = lm_loss(params, self._tokens_of(batch), self.config,
                                 plain=True)
            self.log("train_loss", loss, on_step=True, on_epoch=True)
            self.log("train_ppl", logs["ppl"], on_step=True, on_epoch=False)
            return loss

    dm = SyntheticLMDataModule(cfg, batch_size=2, n_train=8)
    dm.setup("fit")
    traj = []
    for cls in (LlamaModule, PlainLlama):
        losses = []

        class Collect(Callback):
            def on_train_batch_end(self, trainer, module, outputs, batch, i):
                losses.append(float(outputs["loss"]))

        trainer = Trainer(device="cuda", max_steps=3, logger=False,
                          enable_checkpointing=False, seed=0,
                          callbacks=[Collect()])
        trainer.fit(cls(cfg, lr=1e-4, warmup_steps=0, total_steps=3),
                    train_dataloaders=dm.train_dataloader())
        traj.append(losses)
        del trainer
        gc.collect()
    check(len(traj[0]) == 3 and all(
        abs(a - b) <= 1e-4 * abs(b) for a, b in zip(*traj)),
        f"3-step trainer losses: kernels {traj[0]} vs plain {traj[1]}")
    check(traj[0][2] != traj[0][0], "the trainer steps changed nothing")
    log(f"training exactness: fp32 small widths, 2 layers, batch 2 x "
        f"{cfg.max_seq}, remat, loss_chunks 8: loss {loss_k:.6f} vs plain "
        f"{loss_p:.6f}; worst gradient leaf err {worst:.3g} of its max (tol "
        f"1e-4); 3 trainer steps: kernels {traj[0]} plain {traj[1]}")
    torch.cuda.empty_cache()


# bf16-mixed through the kernels against plain=True under the same cast:
# the loss and each gradient leaf within MIXED_TOL of its max. On an H100
# the worst leaf measured 0.0167 (embed), where the plain bf16 path itself
# is 0.017 off an fp32 run: the gradients of a whole model in bf16 differ
# by a few ulps (PERF.md). Beside it, the kernel path's error against fp32
# may be at most twice the plain path's.
MIXED_TOL = 2.0 ** -5


def complete_exactness(torch):
    """fp32 masters, the small widths cut to 2 layers, batch 2 x 2048, the
    chunked loss: (a) remat "dots" against "nothing" through the kernels,
    fp32 (the same kernels on the same inputs: bitwise expected, 1e-6
    relative the bound); (b) bf16-mixed (a bf16 view of the masters, the
    gradients on the masters) through the kernels against plain=True under
    the same cast (MIXED_TOL), and both against an fp32 plain run; (c) the
    Trainer with accumulate_grad_batches=2 over two micro-batches of 1 row
    against one update on the batch of 2 rows: the gradient each update
    applies and the parameters after it, 1e-5 relative to each leaf's
    max."""
    import numpy as np

    from ray_lightning_tpu_torch.core import DataLoader, DictDataset, Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        init_params,
        lm_loss,
    )
    from ray_lightning_tpu_torch.utils.precision import cast_floats
    from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(LlamaConfig.small(), n_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(17))
    leaves = list(tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(18))

    def loss_and_grads(run_cfg, mixed=False, plain=False):
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        view = cast_floats(params, torch.bfloat16) if mixed else params
        loss, _ = lm_loss(view, tokens, run_cfg, plain=plain)
        loss.backward()
        return float(loss), [t.grad.detach().clone() for t in leaves]

    names = (["embed"] + [f"layers.{k}" for k in params["layers"]]
             + ["final_norm", "lm_head"])

    def worst(a_grads, b_grads):
        """The largest gap of a leaf relative to its max, and the leaf."""
        out = (0.0, "")
        for name, a, b in zip(names, a_grads, b_grads):
            peak = float(b.abs().max())
            check(peak > 0, f"reference gradient {name} is all zero")
            out = max(out, (max_err(a, b) / peak, name))
        return out

    # (a) "dots" against "nothing"
    runs = {policy: loss_and_grads(dataclasses.replace(cfg, remat_policy=policy))
            for policy in ("nothing", "dots")}
    (ln, gn), (ld, gd) = runs["nothing"], runs["dots"]
    dots_gap = max(abs(ld - ln) / abs(ln), worst(gd, gn)[0])
    bitwise = ld == ln and all(torch.equal(a, b) for a, b in zip(gd, gn))
    log(f"complete exactness (a): remat dots vs nothing, fp32 through the "
        f"kernels: loss {ld:.7f} vs {ln:.7f}, worst relative gap {dots_gap:.3g}"
        f" (bitwise equal: {bitwise}; bound 1e-6)")
    check(dots_gap <= 1e-6, f"dots vs nothing gap {dots_gap:.3g}")

    # (b) bf16-mixed through the kernels against the plain versions
    lk, gk = loss_and_grads(cfg, mixed=True)
    lp, gp = loss_and_grads(cfg, mixed=True, plain=True)
    _, g32 = loss_and_grads(cfg, plain=True)
    mixed_loss_gap = abs(lk - lp) / abs(lp)
    mixed_gap, mixed_leaf = worst(gk, gp)
    check(all(g.dtype == torch.float32 for g in gk), "mixed grads not fp32")

    def rel(a, b):
        return max_err(a, b) / float(b.abs().max())

    log(f"complete exactness (b): bf16-mixed through the kernels vs plain: "
        f"loss {lk:.6f} vs {lp:.6f} ({mixed_loss_gap:.3g} relative); worst "
        f"gradient leaf {mixed_leaf} {mixed_gap:.3g} of its max (bound "
        f"{MIXED_TOL:.3g}); by leaf, kernels vs plain / kernels vs fp32 / "
        "plain vs fp32: " + ", ".join(
            f"{n} {rel(a, b):.3g}/{rel(a, c):.3g}/{rel(b, c):.3g}"
            for n, a, b, c in zip(names, gk, gp, g32)))
    check(mixed_loss_gap <= MIXED_TOL and mixed_gap <= MIXED_TOL,
          f"bf16-mixed kernels vs plain: loss {mixed_loss_gap:.3g}, "
          f"gradients {mixed_gap:.3g}")
    for n, a, b, c in zip(names, gk, gp, g32):
        check(rel(a, c) <= 2 * rel(b, c) + 1e-6,
              f"{n}: the kernels' bf16 error against fp32 {rel(a, c):.3g} "
              f"is over twice the plain versions' {rel(b, c):.3g}")
    host = tree_map(lambda t: t.detach().cpu(), params)
    del params, leaves, runs, gn, gd, gk, gp, g32
    gc.collect()

    # (c) accumulation of two micro-batches of 1 against a batch of 2
    applied = []

    class RecordingSGD(torch.optim.SGD):
        """SGD that keeps the gradient each step applies (after the
        Trainer's mean over the micro-batches)."""

        def step(self, closure=None):
            applied.append([p.grad.detach().clone()
                            for g in self.param_groups for p in g["params"]])
            return super().step(closure)

    class SGDLlama(LlamaModule):
        def configure_optimizers(self):
            return RecordingSGD(list(tree_leaves(self.params)), lr=1e-2)

    rows = tokens.cpu().numpy().astype(np.int32)
    after = []
    for accumulate, batch in ((2, 1), (1, 2)):
        module = SGDLlama(cfg)
        module.params = tree_map(lambda t: t.clone(), host)
        trainer = Trainer(device="cuda", accumulate_grad_batches=accumulate,
                          max_steps=2 // batch, logger=False,
                          enable_checkpointing=False, seed=0)
        trainer.fit(module, train_dataloaders=DataLoader(
            DictDataset(input_ids=rows), batch_size=batch))
        check(trainer.global_step == 2 // batch, "accumulation steps")
        after.append([t.detach().clone() for t in tree_leaves(trainer.params)])
        del trainer, module
        gc.collect()
    check(len(applied) == 2, f"{len(applied)} updates, expected one per run")
    grad_gap, grad_leaf = worst(applied[0], applied[1])
    param_gap, param_leaf = worst(after[0], after[1])
    log(f"complete exactness (c): accumulate 2 x 1 row vs one update on 2 "
        f"rows (SGD, fp32): the applied gradient's worst leaf gap "
        f"{grad_gap:.3g} of its max ({grad_leaf}), the parameters' "
        f"{param_gap:.3g} ({param_leaf}); bound 1e-5")
    check(grad_gap <= 1e-5 and param_gap <= 1e-5,
          f"accumulation gap: gradient {grad_gap:.3g}, parameters "
          f"{param_gap:.3g}")
    del applied, after, host
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phases 11 to 13: MoE training, the Ray strategies
# --------------------------------------------------------------------- #
MOE_TRAIN_STEPS = 8
MOE_TRAIN_BATCH = 2  # x 2048 tokens
MOE_TRAIN_LAYERS = 2  # fp32 masters and AdamW of 2 layers: ~57 GB
RAY_STEPS = 6  # training-path steps of each Ray run and its single-device twin
RAY_TWO_RANK_BATCH = 2  # rows per rank; the reference steps on 4


class StepTimes(_Callback):
    """Each training step's device time, from a CUDA event recorded at
    every step's start and one at the end of training, read once there.
    Module-level (imported from ``chip_smoke``, not ``__main__``) so that a
    worker process can unpickle it by reference; its ``step_ms`` come back
    to the main process through the callback states rank 0 returns."""

    def __init__(self):
        self.step_ms = []
        self._events = []

    def __getstate__(self):
        return {"step_ms": list(self.step_ms), "_events": []}

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._events.append(ev)

    def on_train_end(self, trainer, module):
        import torch

        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        evs = self._events + [end]
        self.step_ms = [a.elapsed_time(b) for a, b in zip(evs[:-1], evs[1:])]
        self._events = []

    def state_dict(self):
        return {"step_ms": self.step_ms}

    def load_state_dict(self, state):
        self.step_ms = list(state["step_ms"])


class RankParams(_Callback):
    """At the end of fit, every rank's parameters gathered over the process
    group: the largest gap between any rank's and rank 0's."""

    def __init__(self):
        self.max_gap = None

    def on_fit_end(self, trainer, module):
        import torch
        import torch.distributed as dist

        from ray_lightning_tpu_torch.utils.tree import tree_leaves

        dev = (trainer.device if dist.get_backend() == "nccl"
               else torch.device("cpu"))
        flat = torch.cat([t.detach().float().reshape(-1)
                          for t in tree_leaves(trainer.params)]).to(dev)
        parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, flat)
        self.max_gap = max(float((p - parts[0]).abs().max()) for p in parts)

    def state_dict(self):
        return {"max_gap": self.max_gap}

    def load_state_dict(self, state):
        self.max_gap = state["max_gap"]


class SGDLlama(_LlamaModule):
    """LlamaModule with plain SGD at ``lr``: the step moves each parameter
    by lr times its gradient, so two runs' parameters differ by lr times
    their gradients' difference. AdamW would divide each gradient by its own
    magnitude, and an element whose gradient sits at the rounding floor
    would move by a part of lr on a rounding difference."""

    def configure_optimizers(self):
        import torch

        from ray_lightning_tpu_torch.utils.tree import tree_leaves

        return torch.optim.SGD(list(tree_leaves(self.params)), lr=self.lr)


class MomentumLlama(_LlamaModule):
    """LlamaModule with SGD with momentum 0.9 at ``lr``: a per-element
    optimizer state (the momentum buffer) whose value after a few steps is
    a linear function of the gradients, so that two runs' states differ by
    their gradients' rounding. AdamW's moments would not: an element whose
    gradient sits at the rounding floor moves by a part of lr, and the next
    step's gradients then differ by more than rounding."""

    def configure_optimizers(self):
        import torch

        from ray_lightning_tpu_torch.utils.tree import tree_leaves

        return torch.optim.SGD(list(tree_leaves(self.params)), lr=self.lr,
                               momentum=0.9)


class GlobalBatchSampler:
    """The one-process reference of ``world`` ranks: at each step rank 0's
    batch, then rank 1's, ... (each rank's indices those of its
    ``DistributedSampler``: a strided slice of one seeded permutation)."""

    def __init__(self, n, world, batch, seed):
        self.n, self.world, self.batch, self.seed = n, world, batch, seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return (self.n // self.world) // self.batch * self.batch * self.world

    def __iter__(self):
        import numpy as np

        perm = np.random.default_rng(self.seed + self.epoch).permutation(self.n)
        per_rank = [perm[r::self.world] for r in range(self.world)]
        out = []
        for b in range(len(per_rank[0]) // self.batch):
            for r in range(self.world):
                out.extend(per_rank[r][b * self.batch:(b + 1) * self.batch])
        return iter([int(i) for i in out])


def _smoke_module():
    """This script imported under its own name, so that its callbacks
    pickle by reference (a worker imports ``chip_smoke`` from the main process's
    sys.path; ``__main__`` would be the worker's own boot module)."""
    import importlib

    return importlib.import_module("chip_smoke")


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def moe_train_config(torch, dtype, narrow=False):
    """Mixtral-8x7B widths through ``mixtral_config_from_hf``, cut to
    MOE_TRAIN_LAYERS layers, sequence 2048, capacity factor 1.5 and
    ``moe_aux_weight`` 0.01 (training values, where the importer sets the
    serving ones); ``narrow``: dim 1024, 8 query / 2 KV heads of 128, ffn
    1024, vocab 4096, sequence 256, 8 experts top-2 as published."""
    cfg = mixtral_config(torch, MOE_TRAIN_LAYERS, dtype)
    cfg = dataclasses.replace(cfg, max_seq=2048, capacity_factor=1.5,
                              moe_aux_weight=0.01)
    if narrow:
        cfg = dataclasses.replace(cfg, vocab_size=4096, dim=1024, n_heads=8,
                                  n_kv_heads=2, ffn_dim=1024, max_seq=256)
    return cfg


def train_moe(torch, card):
    """MoE training: Trainer.fit of LlamaModule on Mixtral-8x7B widths cut
    to 2 layers, fp32 masters under bf16-mixed, AdamW, per-layer remat,
    batch 2 x 2048, MOE_TRAIN_STEPS steps and one validation batch; losses
    finite, train_moe_aux and val_moe_aux logged, launch counts exact."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaModule,
        SyntheticLMDataModule,
    )

    cfg = moe_train_config(torch, torch.float32)
    check(cfg.n_experts == 8 and cfg.expert_top_k == 2 and cfg.dim == 4096
          and cfg.n_heads == 32 and cfg.n_kv_heads == 8 and cfg.ffn_dim == 14336
          and cfg.vocab_size == 32000 and cfg.remat, f"train_moe config {cfg}")
    tokens = MOE_TRAIN_BATCH * cfg.max_seq
    capacity = max(1, int(cfg.capacity_factor * cfg.expert_top_k * tokens
                          / cfg.n_experts))
    clock = _smoke_module().StepTimes()
    losses = []
    from ray_lightning_tpu_torch.callbacks import Callback

    class Losses(Callback):
        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            losses.append(outputs["loss"])

    module = LlamaModule(cfg, lr=3e-4, warmup_steps=2,
                         total_steps=MOE_TRAIN_STEPS)
    dm = SyntheticLMDataModule(cfg, batch_size=MOE_TRAIN_BATCH,
                               n_train=MOE_TRAIN_BATCH * MOE_TRAIN_STEPS,
                               n_val=MOE_TRAIN_BATCH)
    trainer = Trainer(device="cuda", precision="bf16-mixed",
                      max_steps=MOE_TRAIN_STEPS, logger=False,
                      enable_checkpointing=False, seed=0,
                      callbacks=[clock, Losses()])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    trainer.fit(module, datamodule=dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    counts = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    values = [float(x) for x in losses]
    check(len(values) == MOE_TRAIN_STEPS and all(math.isfinite(x)
                                                 for x in values),
          f"train_moe losses {values}")
    for name in ("train_moe_aux", "val_moe_aux", "val_loss"):
        check(name in trainer.callback_metrics and math.isfinite(
            float(trainer.callback_metrics[name])),
            f"train_moe: {name} not logged: {sorted(trainer.callback_metrics)}")
    expect = training_launches(cfg.n_layers, MOE_TRAIN_STEPS, 1)
    check(counts == expect, f"train_moe launch counts {counts} != {expect}")
    step_ms = clock.step_ms[1:-1]  # past the first; the last holds validation
    med = _median(step_ms)
    n_params = cfg.num_params()
    log(f"train_moe on {card}: Mixtral-8x7B widths cut to {cfg.n_layers} "
        f"layers ({n_params / 1e9:.3f} B params, fp32 masters, bf16-mixed, "
        f"remat, AdamW) batch {MOE_TRAIN_BATCH} x {cfg.max_seq}, capacity "
        f"factor {cfg.capacity_factor} ({capacity} tokens an expert of "
        f"{tokens}), moe_aux_weight {cfg.moe_aux_weight}; fit of "
        f"{MOE_TRAIN_STEPS} steps + 1 val batch in {fit_s:.1f}s; median step "
        f"{med:.1f} ms over {len(step_ms)} steps (min {min(step_ms):.1f}, max "
        f"{max(step_ms):.1f}; first {clock.step_ms[0]:.1f}) -> "
        f"{tokens / (med / 1e3):.0f} tokens/s; peak memory {peak_gib:.2f} GiB"
        f" (depth cut to {cfg.n_layers} of 32 layers so that AdamW fits on "
        "one 80 GB card)")
    log(f"train_moe losses {[round(x, 4) for x in values]}; train_moe_aux "
        f"{float(trainer.callback_metrics['train_moe_aux']):.5f} val_moe_aux "
        f"{float(trainer.callback_metrics['val_moe_aux']):.5f} val_loss "
        f"{float(trainer.callback_metrics['val_loss']):.4f}")
    L = cfg.n_layers
    log(f"train_moe launches: {counts} (per step: rmsnorm {4 * L + 1}, "
        f"flash_fwd {2 * L}, flash_bwd_dq {L}, flash_bwd_dkv {L}; per val "
        f"batch: rmsnorm {2 * L + 1}, flash_fwd {L})")
    del trainer, module, losses
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"step_ms": med, "tokens_per_s": tokens / (med / 1e3),
                    "peak_gib": peak_gib}


def moe_train_exactness(torch):
    """The MoE training loss and every gradient on the card (kernels)
    against the CPU (plain versions) from the same fp32 weights and tokens:
    Mixtral's head layout and experts at narrow widths (dim 1024, ffn 1024,
    vocab 4096), 2 layers, batch 2 x 256, capacity factor 1.5, remat. Loss
    and aux within 1e-5 relative, each gradient leaf within 1e-4 of its max
    (fp32 on both sides, sums in other orders)."""
    from ray_lightning_tpu_torch.models.llama import init_params, lm_loss
    from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = moe_train_config(torch, torch.float32, narrow=True)
    host = init_params(cfg, torch.Generator().manual_seed(21), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq),
                           generator=torch.Generator().manual_seed(22))
    out = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.to(dev).requires_grad_(True), host)
        loss, logs = lm_loss(params, tokens.to(dev), cfg)
        loss.backward()
        out[dev] = (loss.item(), logs["moe_aux"].item(),
                    [t.grad.detach().cpu() for t in tree_leaves(params)])
    (lk, ak, gk), (lc, ac, gc_) = out["cuda"], out["cpu"]
    check(abs(lk - lc) <= 1e-5 * abs(lc), f"moe loss card {lk} vs cpu {lc}")
    check(abs(ak - ac) <= 1e-5 * abs(ac), f"moe aux card {ak} vs cpu {ac}")
    worst = 0.0
    for a, b in zip(gk, gc_):
        peak = float(b.abs().max())
        check(peak > 0, "a cpu gradient leaf is all zero")
        worst = max(worst, max_err(a, b) / peak)
    check(worst <= 1e-4, f"moe gradients: worst leaf {worst:.3g} of its max")
    log(f"train_moe exactness: fp32, Mixtral layout at narrow widths, 2 "
        f"layers, batch 2 x {cfg.max_seq}, capacity factor 1.5: card loss "
        f"{lk:.7f} vs cpu {lc:.7f}, aux {ak:.7f} vs {ac:.7f} (1e-5 relative);"
        f" worst gradient leaf {worst:.3g} of its max (tol 1e-4), the router "
        "and experts included")
    del out, gk, gc_
    gc.collect()
    torch.cuda.empty_cache()


def _ray_run(torch, strategy, cfg, steps, batch, n_train, callbacks,
             module_params=None, lr=3e-4):
    """One Trainer.fit of LlamaModule on the card through ``strategy``:
    returns the trainer, the module, the wall time of fit."""
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaModule,
        SyntheticLMDataModule,
    )

    module = LlamaModule(cfg, lr=lr, warmup_steps=2, total_steps=steps)
    if module_params is not None:
        module.params = module_params
    dm = SyntheticLMDataModule(cfg, batch_size=batch, n_train=n_train,
                               n_val=batch)
    trainer = Trainer(device="cuda", strategy=strategy, max_steps=steps,
                      logger=False, enable_checkpointing=False, seed=0,
                      callbacks=callbacks)
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.fit(module, datamodule=dm)
    torch.cuda.synchronize()
    return trainer, module, time.perf_counter() - t


def _weights_gap(torch, got, want):
    """(bitwise, worst gap of a leaf relative to its max, elements that
    differ) between two parameter trees."""
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    bitwise, worst, differ, total = True, 0.0, 0, 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.detach().to(b.device), b.detach()
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"weights {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
        same = torch.equal(a, b)
        bitwise = bitwise and same
        if not same:
            worst = max(worst, max_err(a, b) / max(float(b.float().abs().max()),
                                                   1e-30))
            differ += int((a != b).sum())
        total += b.numel()
    return bitwise, worst, differ, total


# the Ray runs of the training path against its single-device run: bf16
# weights after RAY_STEPS AdamW steps. The kernels are deterministic, so
# the weights are expected bitwise; any gap must stay within 2 bf16 ulps of
# a leaf's max (2^-7)
RAY_BF16_TOL = 2.0 ** -7


def train_ray_ddp(torch, card):
    """The training main path's model (LlamaConfig.small(), bf16, batch 8 x
    2048) through RayStrategy(num_workers=1, use_gpu=True): one worker
    process owns the card and joins an NCCL group of world size 1; then
    RayShardedStrategy(zero_stage=3) and HorovodRayStrategy the same way.
    Each run's weights, back in the main process, against a SingleDeviceStrategy
    run of the same seed; the step median beside the single-device one; the
    launcher's start-up and the weights' way back. The three worker
    processes are forked from the zygote (warmed by ``main`` before the
    training phases)."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch import runtime as rt
    from ray_lightning_tpu_torch.models.llama import LlamaConfig
    from ray_lightning_tpu_torch.strategies import (
        HorovodRayStrategy,
        RayShardedStrategy,
        RayStrategy,
    )

    smoke = _smoke_module()
    if not rt.is_initialized():
        rt.init(resources={"GPU": float(torch.cuda.device_count())})
    rt.warm_zygote()
    cfg = LlamaConfig.small()
    n_train = TRAIN_BATCH * RAY_STEPS
    clock = smoke.StepTimes()
    kernels.reset_launch_counts()
    single, single_module, single_s = _ray_run(
        torch, None, cfg, RAY_STEPS, TRAIN_BATCH, n_train, [clock])
    single_counts = kernels.launch_counts()
    single_ms = _median(clock.step_ms[1:-1])
    want = single_module.params
    expect = training_launches(cfg.n_layers, RAY_STEPS, 1)
    check(single_counts == expect,
          f"single-device launch counts {single_counts} != {expect}")
    log(f"train_ray_ddp reference on {card}: SingleDeviceStrategy, "
        f"LlamaConfig.small() bf16 batch {TRAIN_BATCH} x {cfg.max_seq}, "
        f"{RAY_STEPS} steps + 1 val batch: fit {single_s:.1f}s, median step "
        f"{single_ms:.1f} ms over {len(clock.step_ms) - 2} steps")
    del single
    out, by_path = {}, {}
    for name, strategy in (
        ("train_ray_ddp", RayStrategy(num_workers=1, use_gpu=True,
                                      debug_collectives=True)),
        ("train_ray_zero3", RayShardedStrategy(num_workers=1, use_gpu=True,
                                               zero_stage=3)),
        ("train_ray_horovod", HorovodRayStrategy(num_workers=1, use_gpu=True)),
    ):
        clock = smoke.StepTimes()
        kernels.reset_launch_counts()
        with _zygote():
            trainer, module, fit_s = _ray_run(torch, strategy, cfg, RAY_STEPS,
                                              TRAIN_BATCH, n_train, [clock])
        main_counts = kernels.launch_counts()
        check(set(main_counts.values()) == {0},
              f"{name}: the main process launched kernels: {main_counts}")
        counts = trainer.worker_launch_counts
        check(counts == expect, f"{name} worker launch counts {counts} != "
              f"{expect}")
        launcher = strategy.launcher
        check(launcher.backend == "nccl", f"{name}: backend {launcher.backend}")
        check(trainer.global_step == RAY_STEPS, f"{name}: global_step "
              f"{trainer.global_step}")
        val = float(trainer.callback_metrics["val_loss"])
        check(math.isfinite(val), f"{name}: val_loss {val}")
        bitwise, gap, differ, total = _weights_gap(torch, module.params, want)
        check(gap <= RAY_BF16_TOL, f"{name}: weights {gap:.3g} of a leaf's "
              f"max from the single-device run (tol {RAY_BF16_TOL:.3g})")
        med = _median(clock.step_ms[1:-1])
        tm = launcher.timings
        log(f"{name} on {card}: {type(strategy).__name__}(num_workers=1, "
            f"use_gpu=True{', zero_stage=3' if 'zero' in name else ''}), one "
            f"worker process forked from the zygote on the card over "
            f"{launcher.backend} at world size 1: fit {fit_s:.1f}s (single device {single_s:.1f}s): "
            f"launcher start-up {tm['setup_s']:.2f}s, the stage in the worker "
            f"{tm['run_s']:.2f}s, weights back {tm['weights_s']:.2f}s "
            f"(rank 0 serialising {tm['collect_s']:.2f}s, the transfer "
            f"{tm['transfer_s']:.2f}s, the main process loading {tm['load_s']:.2f}s"
            f"); median step {med:.1f} ms vs single device {single_ms:.1f} ms "
            f"({med - single_ms:+.1f} ms a step); weights vs single device: "
            f"bitwise {bitwise}, {differ} of {total} elements differ, worst "
            f"{gap:.3g} of a leaf's max (tol {RAY_BF16_TOL:.3g}); val_loss "
            f"{val:.4f}; launches {counts}")
        out[name] = {"step_ms": med, "single_step_ms": single_ms,
                     "setup_s": tm["setup_s"], "weights_s": tm["weights_s"],
                     "fit_s": fit_s, "bitwise": bitwise}
        by_path[name] = counts
        del trainer, module
        gc.collect()
        torch.cuda.empty_cache()
    del want, single_module
    gc.collect()
    torch.cuda.empty_cache()
    return by_path, out


class _zygote:
    """``TORCHRT_ZYGOTE=1`` in this process while the block runs (when
    ``on``): the worker groups started there are forked from the zygote."""

    def __init__(self, on=True):
        self.on = on

    def __enter__(self):
        import os

        self.prev = os.environ.get("TORCHRT_ZYGOTE")
        if self.on:
            os.environ["TORCHRT_ZYGOTE"] = "1"

    def __exit__(self, *exc):
        import os

        if self.prev is None:
            os.environ.pop("TORCHRT_ZYGOTE", None)
        else:
            os.environ["TORCHRT_ZYGOTE"] = self.prev


def two_rank_config(torch):
    from ray_lightning_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=1024, dim=512, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_dim=1024, max_seq=256,
                       dtype=torch.float32, remat=False)


def ray_two_ranks(torch, card):
    """Two worker processes share the card over gloo (NCCL refuses two
    ranks on one device; each worker claims half a "GPU"), on a narrow fp32
    config, one SGD step at lr 1 of 2 rows each: both ranks must hold the
    same parameters, equal to one process stepping on the global batch of 4
    rows within 1e-5 (so the mean of the ranks' gradients equals the
    global batch's within 1e-5); for RayStrategy and RayShardedStrategy at
    stages 1, 2 and 3. (AdamW's first step is lr x g / (|g| + 1e-8): an
    element whose gradient is at the rounding floor moves by a part of lr
    on a rounding difference, which a one-step comparison cannot tell from
    a fault; train_ray_ddp holds AdamW bitwise.)"""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.core import DataLoader, Trainer
    from ray_lightning_tpu_torch.models.llama import SyntheticLMDataModule
    from ray_lightning_tpu_torch.strategies import (
        RayShardedStrategy,
        RayStrategy,
    )

    from ray_lightning_tpu_torch import runtime as rt

    smoke = _smoke_module()
    if not rt.is_initialized():
        rt.init(resources={"GPU": float(torch.cuda.device_count())})
    zygote = rt.warm_zygote()
    cfg = two_rank_config(torch)
    world, batch = 2, RAY_TWO_RANK_BATCH
    n_train = world * batch
    dm = SyntheticLMDataModule(cfg, batch_size=batch * world, n_train=n_train)
    dm.setup("fit")
    loader = DataLoader(dm.train_data, batch_size=batch * world,
                        drop_last=True,
                        sampler=smoke.GlobalBatchSampler(n_train, world, batch, 0))
    ref_module = smoke.SGDLlama(cfg, lr=1.0, warmup_steps=0, total_steps=1)
    ref = Trainer(device="cuda", max_steps=1, logger=False, seed=0,
                  enable_checkpointing=False)
    ref.fit(ref_module, train_dataloaders=loader)
    want = ref_module.params
    expect_one = training_launches(cfg.n_layers, 1, 0, remat=False)
    total_counts = {k: 0 for k in expect_one}
    rows = []
    start_ups = {}
    for name, strategy, forked in (
        ("ddp", RayStrategy(num_workers=2, use_gpu=True,
                            resources_per_worker={"GPU": 0.5}), False),
        # the same fit again, its workers forked from the zygote (warm since
        # main booted it, or warmed above), and the rest so too
        ("ddp_zygote", RayStrategy(num_workers=2, use_gpu=True,
                                   resources_per_worker={"GPU": 0.5}), True),
        ("zero1", RayShardedStrategy(num_workers=2, use_gpu=True, zero_stage=1,
                                     resources_per_worker={"GPU": 0.5}), True),
        ("zero2", RayShardedStrategy(num_workers=2, use_gpu=True, zero_stage=2,
                                     resources_per_worker={"GPU": 0.5}), True),
        ("zero3", RayShardedStrategy(num_workers=2, use_gpu=True, zero_stage=3,
                                     resources_per_worker={"GPU": 0.5}), True),
    ):
        ranks = smoke.RankParams()
        clock = smoke.StepTimes()
        module = smoke.SGDLlama(cfg, lr=1.0, warmup_steps=0, total_steps=1)
        trainer = Trainer(device="cuda", strategy=strategy, max_steps=1,
                          logger=False, seed=0, enable_checkpointing=False,
                          callbacks=[ranks, clock])
        dmr = SyntheticLMDataModule(cfg, batch_size=batch, n_train=n_train)
        dmr.setup("fit")
        t = time.perf_counter()
        with _zygote(forked):
            trainer.fit(module, train_dataloaders=dmr.train_dataloader())
        fit_s = time.perf_counter() - t
        launcher = strategy.launcher
        start_ups[name] = launcher.timings["setup_s"]
        check(launcher.backend == "gloo", f"two ranks {name}: backend "
              f"{launcher.backend}")
        check(ranks.max_gap == 0.0, f"two ranks {name}: the ranks' parameters "
              f"differ by {ranks.max_gap}")
        gap = max(max_err(a.detach().to(b.device), b.detach())
                  for a, b in zip(_leaves(module.params), _leaves(want)))
        check(gap <= 1e-5, f"two ranks {name}: {gap:.3g} from the global-batch "
              "step (tol 1e-5)")
        counts = trainer.worker_launch_counts
        check(counts == {k: 2 * v for k, v in expect_one.items()},
              f"two ranks {name}: launch counts {counts}")
        for k, v in counts.items():
            total_counts[k] += v
        rows.append(f"{name} gap {gap:.3g}, step {clock.step_ms[0]:.1f} ms, "
                    f"fit {fit_s:.1f}s (start-up {launcher.timings['setup_s']:.1f}s)")
        del trainer, module
        gc.collect()
    log(f"ray_two_ranks on {card}: 2 worker processes on one card over gloo, "
        f"fp32 dim {cfg.dim}, {cfg.n_layers} layers, {batch} x {cfg.max_seq} "
        f"rows each, one SGD step at lr 1: the ranks' parameters equal "
        f"bitwise, and "
        f"equal to one process on the global batch of {world * batch} within "
        "1e-5: " + "; ".join(rows) + f"; launches {total_counts}")
    log(f"ray_two_ranks start-up on {card}: the first fit's launcher start-up "
        f"(spawn, CUDA init, rendezvous) {start_ups['ddp']:.2f}s with fresh "
        f"interpreters, {start_ups['ddp_zygote']:.2f}s forked from the zygote "
        f"(its own boot {zygote.ready_s or float('nan'):.2f}s, overlapped "
        f"with earlier phases); zygote fits "
        + ", ".join(f"{k} {v:.2f}s" for k, v in start_ups.items()
                    if k != "ddp"))
    del want, ref_module, ref
    gc.collect()
    torch.cuda.empty_cache()
    return total_counts


RAY_EP_STEPS = 4  # steps of the ep run and of its references
RAY_EP_LAYERS = 1  # Mixtral-8x7B widths: 1.713 B parameters, fp32 masters
RAY_EP_LOSS_RTOL = 1e-3  # bf16-mixed: the experts' sum in another order
# the ep run's weights against the one-process run of the same arithmetic
# (``two_member_moe_ffn``): the ep run's sums, in the ep run's order, so
# the two agree to fp32 rounding, and each leaf's update (the weights less
# the initial ones) within RAY_EP_TWIN_UPDATE_RTOL of the reference's in
# norm; a missing or misplaced expert update parts them by about 1
RAY_EP_TWIN_TOL = 2.0 ** -7
RAY_EP_TWIN_UPDATE_RTOL = 1e-2


class EpCollectives(_Callback):
    """In a worker: one training step (``step``, a global step) under
    torch.profiler; its wall time and the host time of the step's ep
    collectives, the ``moe_ep_all_reduce`` spans of ``parallel/moe.py`` (a
    gloo all-reduce through a host copy: the copy out, the reduction, the
    copy back), with their count. Comes back with rank 0's callback
    states."""

    def __init__(self, step=2):
        self.step = step
        self.result = None
        self._prof = None
        self._t = None

    def __getstate__(self):
        return {"step": self.step, "result": self.result, "_prof": None,
                "_t": None}

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        import torch

        if trainer.global_step != self.step:
            return
        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t = time.perf_counter()

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        import torch

        if self._prof is None:
            return
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - self._t) * 1e3
        self._prof.__exit__(None, None, None)
        spans = [e for e in self._prof.key_averages()
                 if e.key == "moe_ep_all_reduce"]
        self.result = {"step_ms": wall_ms,
                       "ep_ms": sum(e.cpu_time_total for e in spans) / 1e3,
                       "ep_calls": sum(e.count for e in spans)}
        self._prof = None

    def state_dict(self):
        return {"result": self.result}

    def load_state_dict(self, state):
        self.result = state["result"]


class StepLosses(_Callback):
    """Each step's loss on this rank, back with rank 0's callback states."""

    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        self.losses.append(outputs["loss"])

    def on_train_end(self, trainer, module):
        self.losses = [float(x) for x in self.losses]

    def state_dict(self):
        return {"losses": [float(x) for x in self.losses]}

    def load_state_dict(self, state):
        self.losses = list(state["losses"])


class ShardedSGDLlama(SGDLlama):
    """The one-process reference of ``dp`` data-parallel ranks that route
    their own batches (``moe_ffn_local_experts`` routes the member's x):
    the loss of a step is the mean over the dp shards of the global batch,
    in GlobalBatchSampler's order, of ``lm_loss`` on each."""

    dp = 1

    def training_step(self, params, batch, batch_idx):
        import torch

        from ray_lightning_tpu_torch.models.llama import lm_loss

        parts = [lm_loss(params, t, self.config)[0]
                 for t in self._tokens_of(batch).chunk(self.dp)]
        return torch.stack(parts).mean()


def ep_config(torch, narrow=False):
    """Mixtral-8x7B widths through ``moe_train_config``, cut to
    RAY_EP_LAYERS layer (``narrow``: its 2-layer narrow widths)."""
    cfg = moe_train_config(torch, torch.float32, narrow=narrow)
    return cfg if narrow else dataclasses.replace(cfg, n_layers=RAY_EP_LAYERS)


def two_member_moe_ffn(torch):
    """``moe_ffn`` with the arithmetic of ``moe_ffn_local_experts`` at ep 2,
    in one process and with no collective: each of two members takes the
    input and the router through f (the backward sums the two members'
    cotangents, as gloo's all-reduce of two ranks does: a + b), runs
    ``member_share`` on its 4 experts' slices, and the two fp32 partial
    outputs are summed (g); the aux loss, equal on both, reaches each
    member's ScaleBwd with the loss's cotangent, as each member's own loss
    seeds it. The train_ray_ep reference that sums in the ep run's order."""
    from ray_lightning_tpu_torch.parallel.moe import member_share

    class Fork(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone(), x.clone()

        @staticmethod
        def backward(ctx, g0, g1):
            return g0 + g1

    class Join(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a0, a1):
            return a0.clone()

        @staticmethod
        def backward(ctx, g):
            return g, g

    def moe_ffn(params, x, top_k=2, capacity_factor=1.5, capacity=None):
        b, s, d = x.shape
        e = params["router"].shape[-1]
        half = e // 2
        t = b * s
        if capacity is None:
            capacity = max(1, int(capacity_factor * top_k * t / e))
        xts = Fork.apply(x.reshape(t, d))
        routers = Fork.apply(params["router"])
        outs, auxs = [], []
        for m in (0, 1):
            local = {k: v[m * half:(m + 1) * half]
                     for k, v in params.items() if k != "router"}
            out, aux = member_share(local, xts[m], routers[m], top_k,
                                    capacity, m * half, 2)
            outs.append(out)
            auxs.append(aux)
        out = outs[0] + outs[1]
        return out.reshape(b, s, d).to(x.dtype), Join.apply(*auxs)

    return moe_ffn


def _ep_gaps(torch, paths, got, want, init):
    """Per leaf of two runs' weights (leaf lists, ``got`` against ``want``,
    both from ``init``): (path, gap over the leaf's max, elements past
    RAY_EP_TWIN_TOL of the max, elements, ||got - want|| / ||want - init||,
    the update's gap in norm). Each leaf on the card, one at a time."""
    rows = []
    for path, a, b, w0 in zip(paths, got, want, init):
        a = a.detach().to("cuda", torch.float32)
        b = b.to("cuda", torch.float32)
        d = (a - b).abs()
        peak = max(float(b.abs().max()), 1e-30)
        upd = float(torch.linalg.vector_norm(b - w0.to("cuda", torch.float32)))
        rows.append((path, float(d.max()) / peak,
                     int((d > RAY_EP_TWIN_TOL * peak).sum()), b.numel(),
                     float(torch.linalg.vector_norm(d)) / max(upd, 1e-30)))
        del a, b, d
    return rows


def _gap_line(rows):
    past = sum(r[2] for r in rows)
    worst = max(rows, key=lambda r: r[1])
    return (f"{past} of {sum(r[3] for r in rows)} elements past "
            f"{RAY_EP_TWIN_TOL:.3g} of their leaf's max, worst {worst[1]:.3g} "
            f"({worst[0]}), the updates' gap in norm at most "
            f"{max(r[4] for r in rows):.3g}; by leaf (gap / max, past, update "
            "gap): " + ", ".join(f"{p} {g:.3g} {n} {u:.3g}"
                                 for p, g, n, _, u in rows))


def train_ray_ep(torch, card):
    """Expert parallelism at full width: Mixtral-8x7B widths cut to 1 layer
    (8 experts of ffn 14336, top-2, capacity factor 1.5, aux weight 0.01),
    fp32 masters, bf16-mixed, AdamW, remat, batch 2 x 2048, RAY_EP_STEPS
    steps and one validation batch. First two references in the main
    process: one process as it runs (``moe_ffn``), then one process that
    sums the experts as the ep run does (``two_member_moe_ffn``); then
    RayStrategy(num_workers=2, mesh_spec=MeshSpec(axes={"ep": 2})): two
    workers share the card over gloo, each holding 4 of the 8 experts, on
    the same batches. Checks: the losses within 1e-3 relative of the first
    reference's; the returned weights hold all 8 experts and agree with
    the second reference's (every element within RAY_EP_TWIN_TOL of its
    leaf's max, each leaf's update within RAY_EP_TWIN_UPDATE_RTOL in norm).
    Printed: the weights' gap to the first reference, and the two
    references' gap to each other (what the order of the sums alone does);
    every step time of the worker and of the reference with their medians,
    the ep collectives' host time in a profiled step, start-up, the gather
    and the weights' way back; the workers' launches, each one process's."""
    import statistics

    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.core import DataLoader, Trainer
    from ray_lightning_tpu_torch.models import llama
    from ray_lightning_tpu_torch.models.llama import (
        LlamaModule,
        SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.parallel.mesh import MeshSpec
    from ray_lightning_tpu_torch.strategies import RayStrategy

    smoke = _smoke_module()
    cfg = ep_config(torch)
    check(cfg.n_experts == 8 and cfg.dim == 4096 and cfg.ffn_dim == 14336
          and cfg.n_layers == RAY_EP_LAYERS and cfg.capacity_factor == 1.5
          and cfg.remat, f"train_ray_ep config {cfg}")
    batch, steps = MOE_TRAIN_BATCH, RAY_EP_STEPS
    n_train = batch * steps
    dm = SyntheticLMDataModule(cfg, batch_size=batch, n_train=n_train,
                               n_val=batch)
    dm.setup("fit")
    loader = DataLoader(dm.train_data, batch_size=batch, drop_last=True,
                        sampler=smoke.GlobalBatchSampler(n_train, 1, batch, 0))
    expect = training_launches(cfg.n_layers, steps, 1)
    init = []

    class InitialWeights(_Callback):
        def on_train_start(self, trainer, module):
            init.extend(t.detach().cpu().clone() for t in _leaves(module.params))

    def module():
        return LlamaModule(cfg, lr=3e-4, warmup_steps=2, total_steps=steps)

    def reference(moe_fn, callbacks=()):
        clock, losses = smoke.StepTimes(), smoke.StepLosses()
        trainer = Trainer(device="cuda", precision="bf16-mixed",
                          max_steps=steps, logger=False,
                          enable_checkpointing=False, seed=0,
                          callbacks=[clock, losses, *callbacks])
        ref_module = module()
        kept = llama.moe_ffn
        llama.moe_ffn = moe_fn
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        try:
            trainer.fit(ref_module, train_dataloaders=loader,
                        val_dataloaders=dm.val_dataloader())
            torch.cuda.synchronize()
        finally:
            llama.moe_ffn = kept
        counts = kernels.launch_counts()
        check(counts == expect, f"train_ray_ep reference launches {counts} "
              f"!= {expect}")
        out = {"losses": losses.losses, "step_ms": clock.step_ms,
               "s": time.perf_counter() - t,
               "peak": torch.cuda.max_memory_allocated() / 2**30,
               "val": float(trainer.callback_metrics["val_loss"]),
               "weights": [t.detach().cpu() for t in _leaves(ref_module.params)]}
        del trainer, ref_module
        gc.collect()
        torch.cuda.empty_cache()
        return out

    plain = reference(llama.moe_ffn, [InitialWeights()])
    twin = reference(two_member_moe_ffn(torch))

    # the last step is profiled: the timed steps (2-3) run unprofiled
    clock, losses = smoke.StepTimes(), smoke.StepLosses()
    ep = smoke.EpCollectives(step=steps - 1)
    strategy = RayStrategy(num_workers=2, use_gpu=True,
                           resources_per_worker={"GPU": 0.5},
                           mesh_spec=MeshSpec(axes={"ep": 2}))
    trainer = Trainer(device="cuda", strategy=strategy, precision="bf16-mixed",
                      max_steps=steps, logger=False, enable_checkpointing=False,
                      seed=0, callbacks=[clock, losses, ep])
    ep_module = module()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    with _zygote():  # both workers forked from the zygote
        trainer.fit(ep_module, datamodule=SyntheticLMDataModule(
            cfg, batch_size=batch, n_train=n_train, n_val=batch))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    main_counts = kernels.launch_counts()
    check(set(main_counts.values()) == {0},
          f"train_ray_ep: the main process launched kernels: {main_counts}")
    counts = trainer.worker_launch_counts
    check(counts == {k: 2 * v for k, v in expect.items()},
          f"train_ray_ep worker launches {counts}: each of 2 workers should "
          f"launch {expect}")
    launcher = strategy.launcher
    check(launcher.backend == "gloo", f"train_ray_ep backend {launcher.backend}")
    got = ep_module.params
    check(got["layers"]["moe"]["w_gate"].shape[1] == cfg.n_experts,
          "train_ray_ep: the returned weights lack experts: "
          f"{tuple(got['layers']['moe']['w_gate'].shape)}")
    paths = [p for p, _ in _paths(got)]
    vs_twin = _ep_gaps(torch, paths, _leaves(got), twin["weights"], init)
    vs_plain = _ep_gaps(torch, paths, _leaves(got), plain["weights"], init)
    refs_gap = _ep_gaps(torch, paths, twin["weights"], plain["weights"], init)
    # every step of each run: [1:-1] are the steps that run unprofiled and
    # without validation (the last holds both)
    ep_steps, ref_steps = clock.step_ms, plain["step_ms"]
    med = statistics.median(ep_steps[1:-1])
    ref_ms = statistics.median(ref_steps[1:-1])
    r, tm = ep.result, launcher.timings
    T, D = batch * cfg.max_seq, cfg.dim
    # a step, per layer: g's fp32 [T, D] sum in forward and again in the
    # remat recompute, f's bf16 [T, D] input cotangent and the router's
    ep_bytes = cfg.n_layers * (2 * T * D * 4 + T * D * 2 + D * cfg.n_experts * 2)
    n_params = cfg.num_params()
    expert_params = cfg.n_layers * 3 * cfg.n_experts * cfg.dim * cfg.ffn_dim
    log(f"train_ray_ep on {card}: Mixtral-8x7B widths cut to {cfg.n_layers} "
        f"layer ({n_params / 1e9:.3f} B params; each ep member "
        f"{expert_params / 2 / 1e9:.3f} B of experts and "
        f"{(n_params - expert_params) / 1e9:.3f} B of the rest), fp32 masters, "
        f"bf16-mixed, AdamW, remat, batch {batch} x {cfg.max_seq}, capacity "
        f"factor {cfg.capacity_factor}: RayStrategy(num_workers=2, "
        f"mesh_spec=MeshSpec(axes={{'ep': 2}})), 2 workers on one card over "
        f"{launcher.backend}: fit {fit_s:.1f}s (references in process "
        f"{plain['s']:.1f}s and {twin['s']:.1f}s, peak {plain['peak']:.2f} "
        f"GiB); start-up {tm['setup_s']:.2f}s, the stage {tm['run_s']:.2f}s, "
        f"weights back {tm['weights_s']:.2f}s (the experts' all-gather "
        f"{tm['gather_s']:.2f}s, rank 0 serialising {tm['collect_s']:.2f}s, "
        f"the transfer {tm['transfer_s']:.2f}s, loading {tm['load_s']:.2f}s)")
    log(f"train_ray_ep steps: worker median {med:.1f} ms over steps 2-"
        f"{steps - 1} (every step: "
        f"{', '.join(f'{x:.1f}' for x in ep_steps)} ms; the first warms up, "
        f"the last is profiled and holds validation) vs one process median "
        f"{ref_ms:.1f} ms (every step: "
        f"{', '.join(f'{x:.1f}' for x in ref_steps)} ms; the ep-order "
        f"reference: {', '.join(f'{x:.1f}' for x in twin['step_ms'])} ms)"
        + (f"; profiled step {r['step_ms']:.1f} ms with {r['ep_calls']} ep "
           f"all-reduces taking {r['ep_ms']:.1f} ms of host time "
           f"({ep_bytes / 2**20:.0f} MiB a step through host copies over "
           f"gloo, {ep_bytes / (r['ep_ms'] / 1e3) / 1e9:.2f} GB/s)"
           if r is not None else ""))
    log(f"train_ray_ep losses {losses.losses} vs reference {plain['losses']} "
        f"(rtol {RAY_EP_LOSS_RTOL}) and the ep-order reference "
        f"{twin['losses']}; val_loss "
        f"{float(trainer.callback_metrics.get('val_loss', float('nan'))):.6f} "
        f"vs {plain['val']:.6f} and {twin['val']:.6f}; worker launches "
        f"{counts} (2 x one process's)")
    log(f"train_ray_ep weights vs the ep-order reference (checked): "
        + _gap_line(vs_twin))
    log(f"train_ray_ep weights vs the one-process reference: "
        + _gap_line(vs_plain))
    log(f"train_ray_ep the ep-order reference vs the one-process reference "
        f"(the order of the sums alone): " + _gap_line(refs_gap))
    check(len(losses.losses) == steps and all(
        abs(a - b) <= RAY_EP_LOSS_RTOL * abs(b)
        for a, b in zip(losses.losses, plain["losses"])),
        f"train_ray_ep losses {losses.losses} vs reference {plain['losses']} "
        f"(rtol {RAY_EP_LOSS_RTOL})")
    for name in ("val_loss", "val_moe_aux", "train_moe_aux"):
        check(name in trainer.callback_metrics and math.isfinite(
            float(trainer.callback_metrics[name])), f"train_ray_ep: {name}")
    check(r is not None and r["ep_calls"] > 0,
          f"train_ray_ep: no ep collective in the profiled step: {r}")
    for path, rel, past, n, upd in vs_twin:
        check(past == 0 and upd <= RAY_EP_TWIN_UPDATE_RTOL,
              f"train_ray_ep: {path}: {past} of {n} elements past "
              f"{RAY_EP_TWIN_TOL:.3g} of the leaf's max (worst {rel:.3g}) and "
              f"the update {upd:.3g} from the ep-order reference's in norm "
              f"(tol {RAY_EP_TWIN_UPDATE_RTOL:g})")
    out = {"step_ms": med, "ref_step_ms": ref_ms, "ep_ms": r["ep_ms"],
           "ep_step_ms": r["step_ms"], "setup_s": tm["setup_s"],
           "gather_s": tm["gather_s"], "weights_s": tm["weights_s"],
           "fit_s": fit_s}
    del trainer, ep_module, got, plain, twin, init
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


def ep_exactness(torch, card):
    """Expert parallelism at narrow fp32 widths (Mixtral's layout, dim 1024,
    ffn 1024, 8 experts top-2, 2 layers), one SGD step at lr 1 on 2 rows of
    256 per dp rank, against one process on the global batch (the mean over
    its dp shards' losses: each dp rank routes its own batch): {"ep": 2} at
    world 2 and {"dp": 2, "ep": 2} at world 4 (four workers at 0.25 "GPU"
    each) at capacity factor E / top_k, the same mesh under ZeRO 3, and
    {"ep": 2} at capacity factor 1.5 (the routing is replicated over the
    ep group, so the drops are the reference's). Each run returns all 8
    experts, within 1e-5 of the reference."""
    from ray_lightning_tpu_torch.core import DataLoader, Trainer
    from ray_lightning_tpu_torch.models.llama import SyntheticLMDataModule
    from ray_lightning_tpu_torch.parallel.mesh import MeshSpec
    from ray_lightning_tpu_torch.strategies import (
        RayShardedStrategy,
        RayStrategy,
    )

    smoke = _smoke_module()
    base = ep_config(torch, narrow=True)
    no_drop = dataclasses.replace(base, capacity_factor=base.n_experts
                                  / base.expert_top_k)
    per_rank = RAY_TWO_RANK_BATCH
    total_counts, rows = None, []
    for name, cfg, spec, world, dp, zero in (
        ("ep2", no_drop, {"ep": 2}, 2, 1, 0),
        ("dp2_ep2", no_drop, {"dp": 2, "ep": 2}, 4, 2, 0),
        ("dp2_ep2_zero3", no_drop, {"dp": 2, "ep": 2}, 4, 2, 3),
        ("ep2_cf1.5", base, {"ep": 2}, 2, 1, 0),
    ):
        n_train = per_rank * dp
        dm = SyntheticLMDataModule(cfg, batch_size=per_rank, n_train=n_train)
        dm.setup("fit")
        loader = DataLoader(dm.train_data, batch_size=per_rank * dp,
                            drop_last=True, sampler=smoke.GlobalBatchSampler(
                                n_train, dp, per_rank, 0))
        ref_module = smoke.ShardedSGDLlama(cfg, lr=1.0, warmup_steps=0,
                                           total_steps=1)
        ref_module.dp = dp
        Trainer(device="cuda", max_steps=1, logger=False, seed=0,
                enable_checkpointing=False).fit(ref_module,
                                                train_dataloaders=loader)
        want = ref_module.params
        kw = dict(num_workers=world, use_gpu=True,
                  resources_per_worker={"GPU": 1.0 / world},
                  mesh_spec=MeshSpec(axes=spec))
        strategy = (RayShardedStrategy(zero_stage=zero, **kw) if zero
                    else RayStrategy(**kw))
        module = smoke.SGDLlama(cfg, lr=1.0, warmup_steps=0, total_steps=1)
        trainer = Trainer(device="cuda", strategy=strategy, max_steps=1,
                          logger=False, seed=0, enable_checkpointing=False)
        t = time.perf_counter()
        trainer.fit(module, train_dataloaders=dm.train_dataloader())
        fit_s = time.perf_counter() - t
        got = module.params
        check(got["layers"]["moe"]["w_gate"].shape[1] == cfg.n_experts,
              f"ep_exactness {name}: the returned weights lack experts")
        gap = max(max_err(a.detach().to(b.device), b.detach())
                  for a, b in zip(_leaves(got), _leaves(want)))
        check(gap <= 1e-5, f"ep_exactness {name}: {gap:.3g} from one process "
              "on the global batch (tol 1e-5)")
        counts = trainer.worker_launch_counts
        one = training_launches(cfg.n_layers, 1, 0, remat=cfg.remat)
        check(counts == {k: world * v for k, v in one.items()},
              f"ep_exactness {name}: launches {counts}")
        total_counts = ({k: total_counts[k] + v for k, v in counts.items()}
                        if total_counts else dict(counts))
        rows.append(f"{name} (world {world}, capacity factor "
                    f"{cfg.capacity_factor:g}{', ZeRO 3' if zero else ''}) gap "
                    f"{gap:.3g}, fit {fit_s:.1f}s")
        del trainer, module, ref_module, want, got
        gc.collect()
        torch.cuda.empty_cache()
    log(f"ep_exactness on {card}: fp32 Mixtral layout at dim {base.dim}, ffn "
        f"{base.ffn_dim}, {base.n_layers} layers, {per_rank} x {base.max_seq} "
        f"rows a dp rank, one SGD step at lr 1, workers sharing the card over "
        "gloo; every run returns all 8 experts and equals one process on the "
        "global batch within 1e-5: " + "; ".join(rows)
        + f"; launches {total_counts}")
    return total_counts


# --------------------------------------------------------------------- #
# phase 15: the tune integration
# --------------------------------------------------------------------- #
TUNE_ASHA_STEPS = 6  # steps of a tune_asha trial, a validation batch every 2
TUNE_ASHA_VAL_EVERY = 2
TUNE_ASHA_LRS = (3e-4, 1e-3, 0.0)  # the lr 0 trial starts third
# steps of a tune_pbt trial, a validation at each: 8 ran the phase past its
# budget (PBT kept exploiting the lagging trial until the others finished,
# each restart ~20 s), so cut to 4
TUNE_PBT_STEPS = 2
TUNE_PBT_BATCH = 2
TUNE_PBT_LRS = (3e-3, 1e-3, 0.0)
TUNE_PBT_PACE_S = 0.5  # after each validation, so that the reports interleave
TUNE_BARRIER_S = 60.0  # bound of the wait for every tune_pbt trial to start


class TuneClock(_Callback):
    """In a trial's worker: its pid at the start of fit, and the wall time
    at each validation's end, appended to ``clock.jsonl`` in the trial
    directory under ``tag``. One placed before the Tune callback and one
    after it bracket the checkpoint's serialisation and its ``put_queue``."""

    def __init__(self, trial_dir, tag):
        self.trial_dir, self.tag = trial_dir, tag

    def _write(self, **row):
        import os

        with open(os.path.join(self.trial_dir, "clock.jsonl"), "a") as f:
            f.write(json.dumps(dict(row, tag=self.tag, pid=os.getpid())) + "\n")

    def on_fit_start(self, trainer, module):
        import torch.distributed as dist

        self._write(event="fit_start", t=time.time(),
                    backend=dist.get_backend() if dist.is_initialized() else None)

    def on_validation_end(self, trainer, module):
        if not trainer.sanity_checking:
            self._write(event="validation_end", t=time.time(),
                        step=trainer.global_step)


class TuneBarrier(_Callback):
    """In a trial's worker, once its model is on the card: marks ``tag`` in
    ``directory`` and waits (at most TUNE_BARRIER_S) until ``n`` marks are
    there, so that trials that started seconds apart train together. A
    restarted trial finds its mark there and goes on."""

    def __init__(self, directory, tag, n):
        self.directory, self.tag, self.n = directory, tag, n

    def on_train_start(self, trainer, module):
        import os

        os.makedirs(self.directory, exist_ok=True)
        open(os.path.join(self.directory, self.tag), "w").close()
        deadline = time.monotonic() + TUNE_BARRIER_S
        while (len(os.listdir(self.directory)) < self.n
               and time.monotonic() < deadline):
            time.sleep(0.05)


class TunePace(_Callback):
    """Sleeps after each validation, once the Tune callback has reported."""

    def __init__(self, seconds):
        self.seconds = seconds

    def on_validation_end(self, trainer, module):
        if not trainer.sanity_checking:
            time.sleep(self.seconds)


class TuneRestoreCheck(_Callback):
    """At the start of training (``fit(ckpt_path=...)`` has restored the
    donor's checkpoint) writes whether the parameters equal the stream in
    the file, bitwise."""

    def __init__(self, ckpt_path, out_path):
        self.ckpt_path, self.out_path = ckpt_path, out_path

    def on_train_start(self, trainer, module):
        import torch

        from ray_lightning_tpu_torch.utils.serialization import load_state_stream
        from ray_lightning_tpu_torch.utils.tree import tree_leaves

        with open(self.ckpt_path, "rb") as f:
            want = list(tree_leaves(load_state_stream(f.read())["state_dict"]))
        got = [t.detach().cpu() for t in tree_leaves(trainer.params)]
        same = len(got) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
        with open(self.out_path, "w") as f:
            json.dump({"bitwise": same, "global_step": trainer.global_step}, f)


class RecordingASHA(_ASHAScheduler):
    """``ASHAScheduler`` that keeps every report's (trial, iteration) in
    arrival order and the iteration of each trial's first STOP."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.seen, self.stops = [], {}

    def on_result(self, trial_id, metrics, iteration):
        decision = super().on_result(trial_id, metrics, iteration)
        self.seen.append((trial_id, iteration))
        if decision[0] == "STOP":
            self.stops.setdefault(trial_id, iteration)
        return decision


def _trial_file(name, payload, append=False):
    """``payload`` as JSON in the trial directory (a line of it with
    ``append``: each incarnation of an exploited trial adds one)."""
    import os

    from ray_lightning_tpu_torch.tune.session import get_trial_session

    path = os.path.join(get_trial_session().trial_dir, name)
    with open(path, "a" if append else "w") as f:
        f.write(json.dumps(payload) + ("\n" if append else ""))


def tune_asha_trainable(config):
    """One tune_asha trial: LlamaConfig.small() (bf16, remat, batch 8 x
    2048, AdamW, warm-up 1) through RayStrategy(num_workers=1, use_gpu=True,
    resources_per_worker={"GPU": 0.5}), a validation batch every 2 steps, 6
    steps, val_loss reported by TuneReportCallback. Writes the workers'
    launch counts, the launcher's timings and backend to the trial
    directory (never as rows)."""
    import os

    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.strategies import RayStrategy
    from ray_lightning_tpu_torch.tune import TuneReportCallback
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    trial_dir = get_trial_session().trial_dir
    started = time.time()
    cfg = LlamaConfig.small()
    strategy = RayStrategy(num_workers=1, use_gpu=True,
                           resources_per_worker={"GPU": 0.5})
    module = LlamaModule(cfg, lr=config["lr"], warmup_steps=1,
                         total_steps=TUNE_ASHA_STEPS)
    dm = SyntheticLMDataModule(cfg, batch_size=TRAIN_BATCH,
                               n_train=TRAIN_BATCH * TUNE_ASHA_STEPS,
                               n_val=TRAIN_BATCH)
    trainer = Trainer(device="cuda", strategy=strategy,
                      max_steps=TUNE_ASHA_STEPS, logger=False,
                      enable_checkpointing=False, seed=0,
                      val_check_interval=TUNE_ASHA_VAL_EVERY,
                      limit_val_batches=1,
                      callbacks=[TuneReportCallback({"val_loss": "val_loss"}),
                                 TuneClock(trial_dir, "after")])
    _trial_file("trials.jsonl", {"pid": os.getpid(), "started": started},
                append=True)
    trainer.fit(module, datamodule=dm)
    _trial_file("finished.json", {
        "launches": trainer.worker_launch_counts,
        "timings": strategy.launcher.timings,
        "backend": strategy.launcher.backend,
        "transport": strategy.launcher.transport,
        "layers": cfg.n_layers, "steps": trainer.global_step})


def tune_pbt_trainable(config):
    """One tune_pbt trial: two_rank_config (fp32, 2 layers) through one
    worker on the card, a validation and its checkpoint at every step,
    TUNE_PBT_STEPS steps, through TuneReportCheckpointCallback; its worker
    first waits (bounded) for every trial of the sweep to reach training,
    and after each validation it paces. With ``__checkpoint_path__`` it resumes from the donor's
    checkpoint and checks the restore bitwise."""
    import os

    import torch

    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaModule,
        SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.strategies import RayStrategy
    from ray_lightning_tpu_torch.tune import TuneReportCheckpointCallback
    from ray_lightning_tpu_torch.tune.session import get_trial_session

    sess = get_trial_session()
    _trial_file("trials.jsonl", {"pid": os.getpid(), "started": time.time()},
                append=True)
    cfg = two_rank_config(torch)
    ckpt = config.get("__checkpoint_path__")
    callbacks = [TuneBarrier(config["barrier"], sess.trial_id, config["trials"]),
                 TuneClock(sess.trial_dir, "before"),
                 TuneReportCheckpointCallback({"val_loss": "val_loss"}),
                 TuneClock(sess.trial_dir, "after"),
                 TunePace(TUNE_PBT_PACE_S)]
    if ckpt:
        callbacks.append(TuneRestoreCheck(
            ckpt, os.path.join(sess.trial_dir, "restore.json")))
    strategy = RayStrategy(num_workers=1, use_gpu=True)
    module = LlamaModule(cfg, lr=config["lr"], warmup_steps=0,
                         total_steps=TUNE_PBT_STEPS)
    dm = SyntheticLMDataModule(cfg, batch_size=TUNE_PBT_BATCH,
                               n_train=TUNE_PBT_BATCH * TUNE_PBT_STEPS,
                               n_val=TUNE_PBT_BATCH)
    trainer = Trainer(device="cuda", strategy=strategy,
                      max_steps=TUNE_PBT_STEPS, logger=False,
                      enable_checkpointing=False, seed=0,
                      val_check_interval=1, limit_val_batches=1,
                      callbacks=callbacks)
    trainer.fit(module, datamodule=dm, ckpt_path=ckpt)
    _trial_file("finished.json", {
        "launches": trainer.worker_launch_counts,
        "backend": strategy.launcher.backend,
        "transport": strategy.launcher.transport,
        "steps": trainer.global_step})


def _compute_apps():
    """The pids of the processes that hold a context on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return sorted(int(x) for x in out.stdout.split() if x.strip().isdigit())


def _card_used_mib():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return int(out.stdout.split()[0])


def _alive(pid):
    """Whether ``pid`` still runs (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, IndexError):
        return False


def _read_json(path):
    import os

    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _read_lines(path):
    import os

    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def _sweep_pids(analysis):
    """Every trial process and worker a sweep's trials recorded."""
    import os

    pids = set()
    for t in analysis.trials:
        for name in ("trials.jsonl", "clock.jsonl"):
            pids.update(r["pid"] for r in _read_lines(
                os.path.join(t.logdir, name)))
    return sorted(pids)


def _apps_memory():
    """Each compute app's used memory on the card, MiB by pid."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    rows = [line.split(",") for line in out.stdout.splitlines() if "," in line]
    return {int(pid): int(mib) for pid, mib in rows
            if pid.strip().isdigit() and mib.strip().isdigit()}


def _card_clean(before_apps, before_mib, pids, label):
    """No process of the sweep on the card or alive, and the card's used
    memory back within 1 GiB: waits up to 30 s for the exits and for the
    card's memory to be released."""
    import os

    deadline = time.monotonic() + 30.0
    while True:
        apps = _compute_apps()
        left = [p for p in pids if _alive(p)]
        extra = sorted(set(apps) - set(before_apps))
        used = _card_used_mib()
        if (not left and not extra and used <= before_mib + 1024) or (
                time.monotonic() > deadline):
            break
        time.sleep(0.5)
    check(not left, f"{label}: processes of the sweep still run: {left}")
    check(not extra, f"{label}: processes of the sweep still hold the card: "
          f"{extra} (before {before_apps})")
    check(used <= before_mib + 1024, f"{label}: the card's used memory "
          f"{used} MiB, {before_mib} MiB before the sweep; by app "
          f"{_apps_memory()}")
    log(f"{label}: after the sweep the card's compute apps are {apps} "
        f"(before {before_apps}; this process {os.getpid()}); the sweep's "
        f"{len(pids)} processes (trials and workers) are gone; used memory "
        f"{used} MiB (before {before_mib})")


def _check_ring(transport, label, queues):
    """A Ray path's ``queues`` (of "tune_queue", "heartbeat_queue") must be
    the native ring and its payload a native store segment: a silent
    fallback to the actor queue or the Python store fails the run."""
    for q in queues:
        check(transport.get(q) == "shm", f"{label}: the {q} is "
              f"{transport.get(q)!r}, not the native ring")
    check(transport.get("payload") == "native-bytes", f"{label}: the payload "
          f"went through {transport.get('payload')!r}, not a native segment")


def _trial_errors(analysis, label):
    errored = [t for t in analysis.trials if t.status == "ERROR"]
    for t in errored:
        log(f"{label}: {t.trial_id} ERROR:\n{t.error}")
    check(not errored, f"{label}: {len(errored)} trial(s) ended in ERROR")


def tune_asha(torch, card, root):
    """ASHA over lr in {3e-4, 1e-3, 0} on the training path's model, two
    trials at a time on the card (each a trial process and one worker
    claiming half the card). Every trial TERMINATED or STOPPED, every
    val_loss finite, a TERMINATED trial's 3 rows and its workers' exact
    launches; the lr 0 trial starts after both others reported at rung 1
    and ASHA stops it before its third report; then nothing of the sweep
    is left on the card."""
    import os

    from ray_lightning_tpu_torch import tune
    from ray_lightning_tpu_torch.models.llama import LlamaConfig

    smoke = _smoke_module()
    gc.collect()
    torch.cuda.empty_cache()
    apps, used = _compute_apps(), _card_used_mib()
    scheduler = smoke.RecordingASHA(
        metric="val_loss", mode="min", grace_period=1, reduction_factor=2,
        max_t=4)
    t = time.perf_counter()
    start = time.time()
    analysis = tune.run(
        smoke.tune_asha_trainable,
        config={"lr": tune.grid_search(list(TUNE_ASHA_LRS))},
        metric="val_loss", mode="min", scheduler=scheduler,
        local_dir=root, name="tune_asha",
        resources_per_trial={"CPU": 2, "GPU": 0.5}, max_concurrent_trials=2)
    wall_s = time.perf_counter() - t
    _trial_errors(analysis, "tune_asha")
    check(analysis.queue_kind == "shm", f"tune_asha: the trials reported "
          f"through a {analysis.queue_kind!r} queue, not the native ring")
    cfg = LlamaConfig.small()
    n_val = TUNE_ASHA_STEPS // TUNE_ASHA_VAL_EVERY
    expect = training_launches(cfg.n_layers, TUNE_ASHA_STEPS, n_val)
    counts = {k: 0 for k in expect}
    rows = []
    by_lr = {}
    for trial in analysis.trials:
        check(trial.status in ("TERMINATED", "STOPPED"),
              f"tune_asha: {trial.trial_id} ended {trial.status}")
        values = [r["val_loss"] for r in trial.results]
        check(values and all(math.isfinite(v) for v in values),
              f"tune_asha: {trial.trial_id} val_loss {values}")
        info = _read_lines(os.path.join(trial.logdir, "trials.jsonl"))[0]
        events = _read_lines(os.path.join(trial.logdir, "clock.jsonl"))
        clock = [r for r in events if r["event"] == "validation_end"]
        backends = [r["backend"] for r in events if r["event"] == "fit_start"]
        first = (f"{clock[0]['t'] - info['started']:.1f}s after the trainable "
                 f"began, {clock[0]['t'] - start:.1f}s after the sweep began"
                 if clock else "no report timed")
        done = _read_json(os.path.join(trial.logdir, "finished.json"))
        if trial.status == "TERMINATED":
            check(len(trial.results) == n_val,
                  f"tune_asha: {trial.trial_id} has {len(trial.results)} rows")
            check(done is not None and done["launches"] == expect,
                  f"tune_asha: {trial.trial_id} worker launches "
                  f"{done and done['launches']} != {expect}")
            check(done["backend"] == "nccl", f"tune_asha: backend {done}")
            _check_ring(done["transport"], f"tune_asha {trial.trial_id}",
                        ["tune_queue"])
            for k, v in done["launches"].items():
                counts[k] += v
        by_lr[trial.config["lr"]] = trial
        tm = done["timings"] if done else {}
        rows.append(
            f"{trial.trial_id} lr {trial.config['lr']:g}: {trial.status}, "
            f"{len(trial.results)} rows, val_loss "
            f"{[round(v, 4) for v in values]}, first report {first}, worker "
            f"backend {backends}"
            + (f"; launcher start-up "
               f"{tm['setup_s']:.2f}s, the stage {tm['run_s']:.2f}s, weights "
               f"back {tm['weights_s']:.2f}s" if done else ""))
    zero = by_lr[0.0]
    stop_at = scheduler.stops.get(zero.trial_id)
    check(zero.status == "STOPPED" and stop_at is not None and stop_at < n_val,
          f"tune_asha: the lr 0 trial ended {zero.status}, stopped at "
          f"{stop_at}")
    order = scheduler.seen
    others = [t.trial_id for t in analysis.trials if t is not zero]
    first_zero = order.index((zero.trial_id, 1))
    check(all((o, 1) in order[:first_zero] for o in others),
          f"tune_asha: the lr 0 trial reported before the others' rung 1: "
          f"{order}")
    log(f"tune_asha on {card}: ASHA(grace 1, reduction 2, max_t 4) over lr "
        f"{list(TUNE_ASHA_LRS)}, LlamaConfig.small() ({cfg.n_layers} layers, "
        f"bf16, remat, AdamW) at batch {TRAIN_BATCH} x {cfg.max_seq}, "
        f"{TUNE_ASHA_STEPS} steps, a validation batch every "
        f"{TUNE_ASHA_VAL_EVERY}; two trials at a time on the card, each one "
        f"worker with half of it; the sweep {wall_s:.1f}s: " + "; ".join(rows)
        + f"; the lr 0 trial stopped by ASHA at rung {stop_at}; reports in "
        f"arrival order {order}; launches of the finished trials {counts}")
    _card_clean(apps, used, _sweep_pids(analysis), "tune_asha")
    return counts, wall_s


def tune_pbt(torch, card, root):
    """PBT over three narrow fp32 trials at once, each one worker on the
    card, a checkpoint and a report at every step: some trial exploits a
    donor and its first step starts from the donor's checkpointed weights,
    bitwise; the checkpoint's bytes and its way from ``put_queue`` to the
    trial directory; then nothing of the sweep is left on the card."""
    import os

    from ray_lightning_tpu_torch import tune

    smoke = _smoke_module()
    gc.collect()
    torch.cuda.empty_cache()
    apps, used = _compute_apps(), _card_used_mib()
    scheduler = tune.PopulationBasedTraining(
        metric="val_loss", mode="min", perturbation_interval=2,
        hyperparam_mutations={"lr": tune.loguniform(1e-4, 1e-1)},
        quantile_fraction=0.34, seed=0)
    t = time.perf_counter()
    analysis = tune.run(
        smoke.tune_pbt_trainable,
        config={"lr": tune.grid_search(list(TUNE_PBT_LRS)),
                "barrier": os.path.join(root, "pbt_barrier"),
                "trials": len(TUNE_PBT_LRS)},
        metric="val_loss", mode="min", scheduler=scheduler, local_dir=root,
        name="tune_pbt", resources_per_trial={"CPU": 1, "GPU": 0.3},
        max_concurrent_trials=len(TUNE_PBT_LRS))
    wall_s = time.perf_counter() - t
    _trial_errors(analysis, "tune_pbt")
    check(analysis.queue_kind == "shm", f"tune_pbt: the trials reported "
          f"through a {analysis.queue_kind!r} queue, not the native ring")
    cfg = two_rank_config(torch)
    counts = {}
    exploited, rows, ckpt_rows = [], [], []
    for trial in analysis.trials:
        check(trial.status == "TERMINATED",
              f"tune_pbt: {trial.trial_id} ended {trial.status}")
        values = [r["val_loss"] for r in trial.results]
        check(values and all(math.isfinite(v) for v in values),
              f"tune_pbt: {trial.trial_id} val_loss {values}")
        restored = _read_json(os.path.join(trial.logdir, "restore.json"))
        start_step = 0
        if "__checkpoint_path__" in trial.config:
            check(restored is not None and restored["bitwise"],
                  f"tune_pbt: {trial.trial_id} did not restore its donor's "
                  f"checkpoint bitwise: {restored}")
            exploited.append(trial)
            start_step = restored["global_step"]
        done = _read_json(os.path.join(trial.logdir, "finished.json"))
        check(done is not None, f"tune_pbt: {trial.trial_id} wrote no counts")
        _check_ring(done["transport"], f"tune_pbt {trial.trial_id}",
                    ["tune_queue"])
        # this incarnation's steps, each with a validation (a restore at
        # max_steps still runs one step, as the Trainer stops after a step)
        steps = done["steps"] - start_step
        expect = training_launches(cfg.n_layers, steps, steps, remat=False)
        check(steps >= 1 and done["launches"] == expect,
              f"tune_pbt: {trial.trial_id} launches {done['launches']} over "
              f"{steps} steps != {expect}")
        for k, v in done["launches"].items():
            counts[k] = counts.get(k, 0) + v
        donor = (trial.config["__checkpoint_path__"].split(os.sep)[-3]
                 if restored else None)
        rows.append(f"{trial.trial_id} lr {trial.config['lr']:.3g}"
                    + (f" (from {donor}'s step {start_step}, bitwise)"
                       if donor else "")
                    + f": {len(trial.results)} rows, last val_loss "
                    f"{values[-1]:.4f}")
        clock = _read_lines(os.path.join(trial.logdir, "clock.jsonl"))
        before = [r for r in clock if r["tag"] == "before"
                  and r["event"] == "validation_end"]
        after = [r for r in clock if r["tag"] == "after"
                 and r["event"] == "validation_end"]
        if (not exploited or exploited[-1] is not trial) and (
                len(trial.checkpoints) == len(before) == len(after)):
            # one incarnation: its checkpoints pair with its validations
            for c, b, a in zip(trial.checkpoints, before, after):
                ckpt_rows.append((os.path.getsize(c["path"]), a["t"] - b["t"],
                                  os.path.getmtime(c["path"]) - b["t"]))
    check(exploited, "tune_pbt: no trial exploited a donor")
    check(ckpt_rows, "tune_pbt: no checkpoint was timed")
    sizes = sorted({r[0] for r in ckpt_rows})
    send = sorted(r[1] for r in ckpt_rows)
    land = sorted(r[2] for r in ckpt_rows)
    log(f"tune_pbt on {card}: PBT(interval 2, quantile 0.34, seed 0) over lr "
        f"{list(TUNE_PBT_LRS)}, fp32 dim {cfg.dim}, {cfg.n_layers} layers, "
        f"batch {TUNE_PBT_BATCH} x {cfg.max_seq}, {TUNE_PBT_STEPS} steps, a "
        f"checkpoint and a report at each, three trials at once, each one "
        f"worker on the card; the sweep {wall_s:.1f}s: " + "; ".join(rows)
        + f"; {len(exploited)} exploit(s) restored bitwise; checkpoint "
        f"{sizes} bytes, {len(ckpt_rows)} timed from the validation's end: "
        f"to its file in the trial directory (serialised in the worker, "
        f"put_queue to the tune queue (the native ring; the 69 MB item "
        f"spilled into a store segment), drained by the trial process, "
        f"written) median {_median(land):.3f}s (max {land[-1]:.3f}); the "
        f"worker blocked (the checkpoint's and the report's put_queue) "
        f"median {_median(send):.3f}s (max {send[-1]:.3f}); launches "
        f"{counts}")
    _card_clean(apps, used, _sweep_pids(analysis), "tune_pbt")
    return counts, wall_s


def tune_phase(torch, card):
    """Both tune paths, in a directory of the checkout's build/ that is
    removed after; their time beside the 150 s budget."""
    import shutil
    import tempfile

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="tune_", dir=build)
    try:
        asha_counts, asha_s = tune_asha(torch, card, root)
        pbt_counts, pbt_s = tune_pbt(torch, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"tune phases on {card}: tune_asha {asha_s:.1f}s + tune_pbt "
        f"{pbt_s:.1f}s = {asha_s + pbt_s:.1f}s (budget 150 s)")
    return {"tune_asha": asha_counts, "tune_pbt": pbt_counts}


FAULT_EPOCH_STEPS = 4  # train_ray_faults: a checkpoint at each epoch's end
FAULT_STEPS = 8
FAULT_SPEC = "rank0:crash@step5,rank0:hang@step7"
FAULT_HANG_TIMEOUT, FAULT_BEAT = 10.0, 1.0
ZERO_RESUME_EPOCH_STEPS, ZERO_RESUME_STEPS = 2, 4
ZERO_RESUME_SPEC = "rank1:crash@step3"
ZERO_STATE_TOL = 1e-6  # absolute, on momentum buffers of ~1e-2
FAULTS_BUDGET_S = 150.0


class GroupClock(_Callback):
    """Appends ``{"pid", "wall", "step"}`` to ``path`` at the first training
    batch of each worker group (global rank 0): when each relaunched group
    took its first step, and every worker's pid."""

    def __init__(self, path):
        self.path = path
        self._seen = False

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        import os

        if self._seen or trainer.global_rank != 0:
            return
        self._seen = True
        with open(self.path, "a") as f:
            f.write(json.dumps({"pid": os.getpid(), "wall": time.time(),
                                "step": trainer.global_step}) + "\n")

    def on_fit_start(self, trainer, module):
        import os

        with open(self.path + ".pids", "a") as f:
            f.write(f"{os.getpid()}\n")


class TimedCheckpoint(_ModelCheckpoint):
    """ModelCheckpoint that appends each save's step, seconds (the gather,
    the device-to-host copies and the write) and file bytes to
    ``log_path``."""

    def __init__(self, log_path, **kwargs):
        super().__init__(**kwargs)
        self.log_path = log_path

    def _save(self, trainer, module):
        import os

        t = time.perf_counter()
        super()._save(trainer, module)
        if trainer.is_global_zero and self.best_model_path and os.path.exists(
                self.best_model_path):
            with open(self.log_path, "a") as f:
                f.write(json.dumps({
                    "step": trainer.global_step,
                    "s": time.perf_counter() - t,
                    "bytes": os.path.getsize(self.best_model_path)}) + "\n")


def _fault_env(spec, fuse_dir=None):
    """Set the fault spec and its fuse directory (None: no fuse, a spec
    fires at every match) for the workers or engines to come; returns a
    function that takes them away again."""
    import os

    os.environ["TORCHRT_FAULT"] = spec
    if fuse_dir is not None:
        os.environ["TORCHRT_FAULT_FUSE"] = fuse_dir

    def clear():
        os.environ.pop("TORCHRT_FAULT", None)
        os.environ.pop("TORCHRT_FAULT_FUSE", None)

    return clear


def _fault_fit(torch, strategy, cfg, steps, batch, epoch_steps, callbacks,
               lr=3e-4, warmup=2, module_cls=None, ckpt=None):
    """Trainer.fit of LlamaModule on the card through ``strategy``, epochs
    of ``epoch_steps`` steps of ``batch`` rows a rank and one validation
    batch each, with the ModelCheckpoint ``ckpt`` (None: none)."""
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaModule,
        SyntheticLMDataModule,
    )

    world = strategy.num_workers if strategy is not None else 1
    module = (module_cls or LlamaModule)(cfg, lr=lr, warmup_steps=warmup,
                                         total_steps=steps)
    dm = SyntheticLMDataModule(cfg, batch_size=batch,
                               n_train=batch * world * epoch_steps,
                               n_val=batch * world)
    trainer = Trainer(device="cuda", strategy=strategy, max_steps=steps,
                      logger=False, seed=0, enable_checkpointing=ckpt is not None,
                      callbacks=list(callbacks) + ([ckpt] if ckpt else []))
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.fit(module, datamodule=dm)
    torch.cuda.synchronize()
    return trainer, module, time.perf_counter() - t


def train_ray_faults(torch, card, root):
    """The training main path's model through RayStrategy(num_workers=1,
    use_gpu=True): a reference fit, then the same fit under a fused crash
    at step 5 and hang at step 7 with max_failures=2 and the hang
    supervisor; it must relaunch exactly twice and end bitwise on the
    reference's weights."""
    import os

    from ray_lightning_tpu_torch.models.llama import LlamaConfig
    from ray_lightning_tpu_torch.strategies import RayStrategy

    smoke = _smoke_module()
    cfg = LlamaConfig.small()
    ref_clock = smoke.StepTimes()
    ref, ref_module, ref_s = _fault_fit(
        torch, RayStrategy(num_workers=1, use_gpu=True), cfg, FAULT_STEPS,
        TRAIN_BATCH, FAULT_EPOCH_STEPS, [ref_clock])
    check(ref.global_step == FAULT_STEPS, f"train_ray_faults reference "
          f"global_step {ref.global_step}")
    want = [t.detach().clone() for t in _leaves(ref_module.params)]
    ref_ms = _median(ref_clock.step_ms[1:-1])
    del ref, ref_module
    gc.collect()
    torch.cuda.empty_cache()

    fuses = os.path.join(root, "fuses")
    groups = os.path.join(root, "groups.jsonl")
    saves = os.path.join(root, "saves.jsonl")
    clock = smoke.StepTimes()
    strategy = RayStrategy(num_workers=1, use_gpu=True, max_failures=2,
                           hang_timeout=FAULT_HANG_TIMEOUT,
                           heartbeat_interval=FAULT_BEAT)
    # a checkpoint at the first epoch's end only (every_n_epochs=2): the
    # relaunches resume from it; one at the last step would add a write
    ckpt = smoke.TimedCheckpoint(saves, dirpath=os.path.join(root, "ckpts"),
                                 every_n_epochs=2)
    clear = _fault_env(FAULT_SPEC, fuses)
    try:
        trainer, module, fit_s = _fault_fit(
            torch, strategy, cfg, FAULT_STEPS, TRAIN_BATCH, FAULT_EPOCH_STEPS,
            [clock, smoke.GroupClock(groups)], ckpt=ckpt)
    finally:
        clear()
    launcher = strategy.launcher
    _check_ring(launcher.transport, "train_ray_faults", ["heartbeat_queue"])
    failures = launcher.failures
    check([f["error"] for f in failures] == ["ActorError", "WorkerHangError"],
          f"train_ray_faults: relaunches {[(f['error'], f['message'][:200]) for f in failures]}")
    check(trainer.global_step == FAULT_STEPS,
          f"train_ray_faults: global_step {trainer.global_step}")
    marks = {}
    for name in ("rank0-crash-at5", "rank0-hang-at7"):
        path = os.path.join(fuses, name)
        check(os.path.exists(path), f"train_ray_faults: fuse {name} not blown")
        with open(path) as f:
            marks[name] = float(f.read())
    starts = _read_lines(groups)
    check([g["step"] for g in starts] == [0, 4, 4],
          f"train_ray_faults: groups started at steps {starts}")
    check(all("step=4" in f["resume"] for f in failures),
          f"train_ray_faults: resumed from {[f['resume'] for f in failures]}")
    got = list(_leaves(module.params))
    check(len(got) == len(want) and all(
        torch.equal(a.detach(), b) for a, b in zip(got, want)),
        "train_ray_faults: the faulted fit's weights differ from the "
        "reference's")
    counts = trainer.worker_launch_counts
    last = FAULT_STEPS - starts[-1]["step"]
    expect = training_launches(cfg.n_layers, last, 1)
    check(counts == expect, f"train_ray_faults: the last group's launches "
          f"{counts} != {expect}")
    crash_to_step = starts[1]["wall"] - marks["rank0-crash-at5"]
    hang_to_step = starts[2]["wall"] - marks["rank0-hang-at7"]
    detect = failures[1]["at"] - marks["rank0-hang-at7"]
    silence = failures[1]["silence"].get(0, float("nan"))
    check(detect <= FAULT_HANG_TIMEOUT + 2 * FAULT_BEAT,
          f"train_ray_faults: hang detected {detect:.2f}s after it began")
    written = _read_lines(saves)
    med = _median(clock.step_ms[1:-1])
    pids = [int(p) for p in open(groups + ".pids").read().split()]
    log(f"train_ray_faults on {card}: LlamaConfig.small() bf16 batch "
        f"{TRAIN_BATCH} x {cfg.max_seq}, epochs of {FAULT_EPOCH_STEPS} steps, "
        f"{FAULT_STEPS} steps, RayStrategy(num_workers=1, use_gpu=True, "
        f"max_failures=2, hang_timeout={FAULT_HANG_TIMEOUT}, "
        f"heartbeat_interval={FAULT_BEAT}) under {FAULT_SPEC!r}: 2 relaunches "
        f"({[f['error'] for f in failures]}), both from the step-4 "
        f"checkpoint; groups began at steps {[g['step'] for g in starts]}; "
        f"weights bitwise the reference's; fit {fit_s:.1f}s (reference "
        f"{ref_s:.1f}s)")
    log(f"train_ray_faults recovery on {card}: crash -> the next group's first "
        f"step {crash_to_step:.2f}s; hang -> detection {detect:.2f}s "
        f"(hang_timeout {FAULT_HANG_TIMEOUT}s, heartbeat {FAULT_BEAT}s; the "
        f"rank silent {silence:.2f}s at the trip) -> the next group's first "
        f"step {hang_to_step:.2f}s; the last group's launcher start-up "
        f"{launcher.timings['setup_s']:.2f}s, its longest gap between beats "
        f"{launcher.timings.get('max_beat_gap_s', float('nan')):.2f}s")
    log(f"train_ray_faults checkpoints on {card}: " + "; ".join(
        f"step {w['step']}: {w['bytes'] / 1e9:.3f} GB in {w['s']:.2f}s "
        f"({w['bytes'] / 1e9 / max(w['s'], 1e-9):.2f} GB/s)" for w in written)
        + f"; step median with heartbeats {med:.1f} ms over "
        f"{len(clock.step_ms) - 2} steps of the last group "
        f"({[round(x, 1) for x in clock.step_ms]}) vs the reference's "
        f"{ref_ms:.1f} ms without ({(med / ref_ms - 1) * 100:+.2f}%)")
    del trainer, module, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"crash_to_step_s": crash_to_step, "detect_s": detect,
                    "hang_to_step_s": hang_to_step, "pids": pids,
                    "step_ms": med, "ref_step_ms": ref_ms, "saves": written}


def train_ray_zero_resume(torch, card, root):
    """ray_two_ranks' narrow fp32 config through RayShardedStrategy(
    num_workers=2, zero_stage=3, max_failures=1) over gloo on the card, with
    SGD with momentum (``MomentumLlama``): rank 1 crashes at step 3 (fused),
    the group resumes from the step-2 checkpoint; the weights equal an
    uninterrupted ZeRO-3 fit's bitwise, and the step-2 checkpoint's whole
    optimizer states those of a one-process fit on the global batch within
    1e-6 (absolute; each state's gap relative to its largest element is
    printed too). (Under AdamW the two ranks and
    the one process part at the rounding floor after the first step, and
    their second-step states then differ by ~6e-5 of a state's max at stage
    0 as at stage 3: a CPU run of this config.)"""
    import os

    from ray_lightning_tpu_torch.core import DataLoader, Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaModule,
        SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.strategies import RayShardedStrategy

    smoke = _smoke_module()
    cfg = two_rank_config(torch)
    world, batch = 2, RAY_TWO_RANK_BATCH

    def strategy(max_failures=0):
        return RayShardedStrategy(num_workers=world, use_gpu=True,
                                  zero_stage=3, max_failures=max_failures,
                                  resources_per_worker={"GPU": 0.5})

    ref, ref_module, ref_s = _fault_fit(
        torch, strategy(), cfg, ZERO_RESUME_STEPS, batch,
        ZERO_RESUME_EPOCH_STEPS, [], lr=3e-3, warmup=0,
        module_cls=smoke.MomentumLlama)
    want = [t.detach().clone() for t in _leaves(ref_module.params)]
    del ref, ref_module

    groups = os.path.join(root, "zero_groups.jsonl")
    ckpt_dir = os.path.join(root, "zero_ckpts")
    zero = strategy(max_failures=1)
    clear = _fault_env(ZERO_RESUME_SPEC, os.path.join(root, "zero_fuses"))
    try:
        trainer, module, fit_s = _fault_fit(
            torch, zero, cfg, ZERO_RESUME_STEPS, batch,
            ZERO_RESUME_EPOCH_STEPS, [smoke.GroupClock(groups)], lr=3e-3,
            warmup=0, module_cls=smoke.MomentumLlama,
            ckpt=smoke.TimedCheckpoint(
                os.path.join(root, "zero_saves.jsonl"), dirpath=ckpt_dir,
                save_top_k=-1))
    finally:
        clear()
    _check_ring(zero.launcher.transport, "train_ray_zero_resume", [])
    failures = zero.launcher.failures
    check([f["error"] for f in failures] == ["ActorError"],
          f"train_ray_zero_resume: relaunches {failures}")
    check("step=2" in failures[0]["resume"],
          f"train_ray_zero_resume: resumed from {failures[0]['resume']}")
    check(trainer.global_step == ZERO_RESUME_STEPS,
          f"train_ray_zero_resume: global_step {trainer.global_step}")
    got = list(_leaves(module.params))
    check(all(torch.equal(a.detach(), b) for a, b in zip(got, want)),
          "train_ray_zero_resume: weights differ from the uninterrupted "
          "ZeRO-3 fit's")
    counts = trainer.worker_launch_counts
    last = ZERO_RESUME_STEPS - ZERO_RESUME_EPOCH_STEPS
    expect = {k: world * v for k, v in training_launches(
        cfg.n_layers, last, 1, remat=False).items()}
    check(counts == expect, f"train_ray_zero_resume: launches {counts} != "
          f"{expect}")

    # the one process on the global batch, for the step-2 states
    dm = SyntheticLMDataModule(cfg, batch_size=batch * world,
                               n_train=batch * world * ZERO_RESUME_EPOCH_STEPS)
    dm.setup("fit")
    loader = DataLoader(dm.train_data, batch_size=batch * world,
                        drop_last=True, sampler=smoke.GlobalBatchSampler(
                            dm.train_data.__len__(), world, batch, 0))
    one_module = smoke.MomentumLlama(cfg, lr=3e-3, warmup_steps=0,
                                    total_steps=ZERO_RESUME_STEPS)
    one = Trainer(device="cuda", max_steps=ZERO_RESUME_EPOCH_STEPS,
                  logger=False, seed=0, enable_checkpointing=False)
    one.fit(one_module, train_dataloaders=loader)
    one_state = one.optimizer.state_dict()
    (name,) = [n for n in os.listdir(ckpt_dir)
               if f"step={ZERO_RESUME_EPOCH_STEPS}." in n]
    saved = torch.load(os.path.join(ckpt_dir, name), map_location="cpu",
                       weights_only=True)
    check(saved["zero_stage"] == 3, f"zero_stage {saved.get('zero_stage')}")
    (states,) = saved["optimizer_states"]
    check(sorted(states["state"]) == sorted(one_state["state"]),
          "train_ray_zero_resume: the checkpoint's states cover other leaves")
    worst, worst_rel = 0.0, 0.0
    for idx, state in one_state["state"].items():
        for key, w in state.items():
            g = states["state"][idx][key]
            w = w.detach().cpu()
            if not w.dim():
                check(torch.equal(g, w), f"state {idx} {key}: {g} vs {w}")
                continue
            err = max_err(g, w)
            worst = max(worst, err)
            worst_rel = max(worst_rel, err / max(float(w.abs().max()), 1e-30))
    check(worst <= ZERO_STATE_TOL, f"train_ray_zero_resume: a state "
          f"{worst:.3g} from the one process's")
    start = _read_lines(groups)
    log(f"train_ray_zero_resume on {card}: fp32 dim {cfg.dim}, {cfg.n_layers} "
        f"layers, {world} ranks of {batch} x {cfg.max_seq} over gloo, ZeRO 3, "
        f"SGD with momentum 0.9, epochs of {ZERO_RESUME_EPOCH_STEPS} steps, "
        f"{ZERO_RESUME_STEPS} steps under {ZERO_RESUME_SPEC!r}: 1 relaunch "
        f"from the step-2 checkpoint (groups began at steps "
        f"{[g['step'] for g in start]}), weights bitwise the uninterrupted "
        f"fit's (fit {fit_s:.1f}s vs {ref_s:.1f}s); the checkpoint's whole "
        f"momentum buffers vs one process on the global batch: worst "
        f"{worst:.3g} (tol {ZERO_STATE_TOL}), {worst_rel:.3g} of a state's "
        f"max; launches {counts}")
    del trainer, module, got, want, one, one_module, saved
    gc.collect()
    torch.cuda.empty_cache()
    pids = [int(p) for p in open(groups + ".pids").read().split()]
    return counts, pids


def faults_phase(torch, card):
    """Both fault paths in a directory of the checkout's build/ that is
    removed after; then nothing of them is left on the card; the phase's
    time beside its budget."""
    import shutil
    import tempfile

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="faults_", dir=build)
    # this process's own context first (a rehearsal of this phase alone has
    # none yet), so that the apps before include it
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    apps, used = _compute_apps(), _card_used_mib()
    t = time.perf_counter()
    try:
        # every group and relaunch of both paths is forked from the zygote
        with _zygote():
            faults_counts, info = train_ray_faults(torch, card, root)
            zero_counts, zero_pids = train_ray_zero_resume(torch, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_s = time.perf_counter() - t
    _card_clean(apps, used, info["pids"] + zero_pids, "faults")
    log(f"faults phase on {card}: {phase_s:.1f}s (budget {FAULTS_BUDGET_S:.0f}"
        " s)")
    return {"train_ray_faults": faults_counts,
            "train_ray_zero_resume": zero_counts}


def check_new_path_shapes(torch, F, results):
    """The kernels at the shapes the new paths give them, against their
    plain versions: train_moe's RMSNorm [4096,4096] bf16 and flash q
    [2,32,2048,128] kv [2,8,2048,128] bf16 (forward and backward, timed
    beside their bounds, plain versions and SDPA); ray_two_ranks' fp32
    RMSNorm [512,512] and flash q [2,4,256,128] kv [2,2,256,128] (checked)."""
    from ray_lightning_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )
    from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain

    g = torch.Generator(device="cuda").manual_seed(31)
    # RMSNorm at train_moe's [4096,4096] bf16 (1e-2: one bf16 ulp either way)
    x = torch.randn(4096, 4096, generator=g, device="cuda").bfloat16()
    w = (1 + 0.1 * torch.randn(4096, generator=g, device="cuda")).bfloat16()
    got, want = rmsnorm(x, w, 1e-5), rmsnorm_plain(x, w, 1e-5)
    check(within(got, want, 1e-2, 1e-2), "rmsnorm [4096,4096] vs plain")
    b, by = bound(2 * x.numel() * 2 + 4096 * 2, 4 * x.numel(), FP32_FLOPS)
    r = dict(shape="[4096,4096] bf16 (train_moe)", max_abs_err=max_err(got, want),
             ms=time_ms(torch, lambda: rmsnorm(x, w, 1e-5)),
             plain_ms=time_ms(torch, lambda: rmsnorm_plain(x, w, 1e-5)),
             library_ms=time_ms(torch, lambda: F.rms_norm(x, (4096,), w, 1e-5))
             if hasattr(F, "rms_norm") else None, bound_ms=b, bound_by=by)
    results["rmsnorm"]["at_train_moe_shape"] = r
    log(f"rmsnorm at train_moe's [4096,4096] bf16: max_abs_err "
        f"{r['max_abs_err']:.3g} kernel_ms {r['ms']:.4f} plain_ms "
        f"{r['plain_ms']:.4f} library_ms {r['library_ms']} bound_ms {b:.5f} "
        f"({by})")
    # flash forward and backward at train_moe's shape
    B, hq, hkv, S, hd = 2, 32, 8, 2048, 128
    q = torch.randn(B, hq, S, hd, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, hkv, S, hd, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, hkv, S, hd, generator=g, device="cuda").bfloat16()
    do = torch.randn(B, hq, S, hd, generator=g, device="cuda").bfloat16()
    o, lse = flash_attention(q, k, v)
    po, plse = flash_attention_plain(q, k, v, True, None, None)
    check(within(o, po, 2e-2, 2e-2) and within(lse, plse, 1e-4, 1e-4),
          "flash at train_moe's shape vs plain")
    ferr = max(max_err(o, po), max_err(lse, plse))
    del po, plse
    kr, vr = k.repeat_interleave(4, dim=1), v.repeat_interleave(4, dim=1)
    pairs = B * hq * S * (S + 1) // 2
    fb, fby = bound((q.numel() * 2 + k.numel() * 2) * 2 + lse.numel() * 4,
                    4 * pairs * hd, BF16_FLOPS)
    shape = f"q[{B},{hq},{S},{hd}] kv[{B},{hkv},{S},{hd}] bf16 causal (train_moe)"
    results["flash_fwd"]["at_train_moe_shape"] = dict(
        shape=shape, max_abs_err=ferr,
        ms=time_ms(torch, lambda: flash_attention(q, k, v), iters=10),
        plain_ms=time_ms(torch, lambda: flash_attention_plain(
            q, k, v, True, None, None), iters=5, warmup=1),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=True), iters=10),
        bound_ms=fb, bound_by=fby)
    gotb = flash_attention_bwd(q, k, v, o, lse, do, True, None, None)
    wantb = flash_attention_bwd_plain(q, k, v, o, lse, do, True, None, None)
    errs = {}
    for gname, a, bb in zip(("dq", "dk", "dv"), gotb, wantb):
        peak = float(bb.float().abs().max())
        errs[gname] = max_err(a, bb)
        check(errs[gname] <= 2.0 ** -7 * peak,
              f"flash bwd at train_moe's shape: {gname} {errs[gname]:.3g}")
    del gotb, wantb
    scale = 1.0 / hd ** 0.5
    delta = (o.float() * do.float()).sum(dim=-1, keepdim=True)
    plain_bwd = time_ms(torch, lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, True, scale, None), iters=5, warmup=1)
    qr = q.detach().clone().requires_grad_()
    krg, vrg = kr.detach().requires_grad_(), vr.detach().requires_grad_()

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qr, krg, vrg, is_causal=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qr, krg, vrg, is_causal=True)
        torch.autograd.grad(out, (qr, krg, vrg), do)

    lib_bwd = (time_ms(torch, sdpa_fwd_bwd, iters=10)
               - time_ms(torch, sdpa_fwd, iters=10))
    in_bytes = (q.numel() + k.numel() + v.numel() + do.numel()) * 2 \
        + 2 * lse.numel() * 4
    for kname, fn, flops, out_bytes, err in (
            ("flash_bwd_dq", flash_attention_bwd_dq, 3 * 2 * pairs * hd,
             q.numel() * 2, errs["dq"]),
            ("flash_bwd_dkv", flash_attention_bwd_dkv, 4 * 2 * pairs * hd,
             2 * k.numel() * 2, max(errs["dk"], errs["dv"]))):
        bb, bby = bound(in_bytes + out_bytes, flops, BF16_FLOPS)
        results[kname]["at_train_moe_shape"] = dict(
            shape=shape, max_abs_err=err,
            ms=time_ms(torch, lambda: fn(q, k, v, do, lse, delta, True, scale,
                                         None), iters=10),
            plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=bb, bound_by=bby,
            plain_and_library_compute="dq, dk and dv together")
    f, dq, dkv = (results[n]["at_train_moe_shape"]
                  for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    log(f"flash at train_moe's shape {shape}: forward max_abs_err {ferr:.3g} "
        f"kernel_ms {f['ms']:.4f} plain_ms {f['plain_ms']:.3f} library_ms(SDPA)"
        f" {f['library_ms']:.4f} bound_ms {f['bound_ms']:.4f} "
        f"({f['bound_by']}); backward dq {dq['ms']:.4f} ms (bound "
        f"{dq['bound_ms']:.4f}), dkv {dkv['ms']:.4f} ms (bound "
        f"{dkv['bound_ms']:.4f}), plain backward {plain_bwd:.3f} ms, SDPA "
        f"backward {lib_bwd:.3f} ms; max err dq {errs['dq']:.3g} dk "
        f"{errs['dk']:.3g} dv {errs['dv']:.3g} (tol 2^-7 of each max)")
    del q, k, v, do, o, lse, kr, vr, qr, krg, vrg, delta
    # ray_two_ranks' fp32 shapes (1e-4: fp32 sums in other orders)
    cfg = two_rank_config(torch)
    x = torch.randn(RAY_TWO_RANK_BATCH * cfg.max_seq, cfg.dim, generator=g,
                    device="cuda")
    w = 1 + 0.1 * torch.randn(cfg.dim, generator=g, device="cuda")
    check(within(rmsnorm(x, w, 1e-5), rmsnorm_plain(x, w, 1e-5), 1e-5, 1e-5),
          "rmsnorm at ray_two_ranks' fp32 shape")
    hd = cfg.head_dim
    q = torch.randn(RAY_TWO_RANK_BATCH, cfg.n_heads, cfg.max_seq, hd,
                    generator=g, device="cuda")
    k = torch.randn(RAY_TWO_RANK_BATCH, cfg.n_kv_heads, cfg.max_seq, hd,
                    generator=g, device="cuda")
    v = torch.randn_like(k)
    do = torch.randn_like(q)
    o, lse = flash_attention(q, k, v)
    po, plse = flash_attention_plain(q, k, v, True, None, None)
    check(within(o, po, 1e-4, 1e-4) and within(lse, plse, 1e-4, 1e-4),
          "flash at ray_two_ranks' fp32 shape")
    for gname, a, bb in zip(("dq", "dk", "dv"),
                            flash_attention_bwd(q, k, v, o, lse, do, True,
                                                None, None),
                            flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      True, None, None)):
        check(max_err(a, bb) <= 1e-4 * float(bb.abs().max()),
              f"flash bwd {gname} at ray_two_ranks' fp32 shape")
    log(f"ray_two_ranks' shapes, fp32: rmsnorm [{x.shape[0]},{cfg.dim}] "
        f"(1e-5) and flash forward and backward q[{RAY_TWO_RANK_BATCH},"
        f"{cfg.n_heads},{cfg.max_seq},{hd}] kv[{RAY_TWO_RANK_BATCH},"
        f"{cfg.n_kv_heads},{cfg.max_seq},{hd}] (1e-4) equal their plain "
        "versions")
    del x, w, q, k, v, do, o, lse, po, plse
    torch.cuda.empty_cache()


ELASTIC_EPOCHS, ELASTIC_EPOCH_STEPS = 3, 2
ELASTIC_BATCH = 4  # rows of 2048 per worker
ELASTIC_SPEC = "rank1:crash@step3"  # the second step of epoch 1
ELASTIC_HANG_TIMEOUT, ELASTIC_BEAT = 10.0, 1.0
ELASTIC_LR = 3e-4
ELASTIC_BUDGET_S = 90.0


class ElasticProbe(_Callback):
    """In every process of the elastic fit: a line per epoch start (pid,
    epoch, step, world), a line per applied step (step, world, logical rank,
    pid, the step's wall-clock start and end around a device sync) with the
    step's batch as .npy, and the sha256 of the weights' bytes at the end of
    fit. The pids show which process lived through which resize, the
    batches let one process replay the group's global batches, the hashes
    hold the members bitwise equal."""

    def __init__(self, probe_dir):
        self.probe_dir = probe_dir
        self._t = None

    def __getstate__(self):
        return {"probe_dir": self.probe_dir, "_t": None}

    def _append(self, name, record):
        import os

        with open(os.path.join(self.probe_dir, name), "a") as f:
            f.write(json.dumps(record) + "\n")

    def on_train_epoch_start(self, trainer, module):
        import os

        self._append(f"probe_{os.getpid()}.jsonl", {
            "pid": os.getpid(), "epoch": trainer.current_epoch,
            "step": trainer.global_step, "world": trainer.world_size})

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        import torch

        torch.cuda.synchronize()
        self._t = time.time()

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        import os

        import numpy as np
        import torch

        torch.cuda.synchronize()
        end = time.time()
        step, rank = trainer.global_step, trainer.global_rank
        np.save(os.path.join(self.probe_dir, f"batch_s{step}_r{rank}.npy"),
                np.asarray(batch["input_ids"]))
        self._append(f"steps_{os.getpid()}.jsonl", {
            "step": step, "world": trainer.world_size, "rank": rank,
            "pid": os.getpid(), "start": self._t, "end": end})

    def on_fit_end(self, trainer, module):
        import hashlib
        import os

        import torch

        h = hashlib.sha256()
        for leaf in _leaves(trainer.params):
            h.update(leaf.detach().contiguous().view(-1).view(torch.uint8)
                     .cpu().numpy().data)
        with open(os.path.join(self.probe_dir, f"hash_{os.getpid()}"),
                  "w") as f:
            f.write(h.hexdigest())


def _elastic_batches(probe_dir):
    """The applied steps in order, each the union of its ranks' batches in
    rank order, and the step records."""
    import glob
    import os

    import numpy as np

    steps = {}
    for path in glob.glob(os.path.join(probe_dir, "steps_*.jsonl")):
        for r in _read_lines(path):
            steps.setdefault(r["step"], []).append(r)
    out = []
    for step in sorted(steps):
        recs = sorted(steps[step], key=lambda r: r["rank"])
        world = recs[0]["world"]
        check([r["rank"] for r in recs] == list(range(world))
              and all(r["world"] == world for r in recs),
              f"train_ray_elastic: step {step} records {recs}")
        out.append((step, world, np.concatenate([np.load(os.path.join(
            probe_dir, f"batch_s{step}_r{r['rank']}.npy")) for r in recs]),
            recs))
    return out


def train_ray_elastic(torch, card, root):
    """The training path's model (LlamaConfig.small(), bf16, remat, AdamW)
    through RayStrategy(num_workers=2, use_gpu=True, elastic=True,
    min_workers=1, max_failures=0): two workers share the card over gloo
    at 4 x 2048 rows each, 3 epochs of 2 steps, rank 1 crashed at step 3
    (fused). The group shrinks to the survivor, which re-runs epoch 1 at
    world 1, and a spare forked from the zygote joins at its end from the
    survivor's handoff. JAX's acceptance checks, then the weights against
    one process on the recorded global batches (2^-7 of a leaf's max;
    ``elastic_replay``)."""
    import os

    from ray_lightning_tpu_torch import runtime as rt
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.strategies import RayStrategy

    smoke = _smoke_module()
    cfg = LlamaConfig.small()
    world = 2
    probe = os.path.join(root, "probes")
    os.makedirs(probe)
    steps_total = ELASTIC_EPOCHS * ELASTIC_EPOCH_STEPS + 1  # one re-run step
    strategy = RayStrategy(num_workers=world, use_gpu=True, elastic=True,
                           min_workers=1, max_failures=0,
                           hang_timeout=ELASTIC_HANG_TIMEOUT,
                           heartbeat_interval=ELASTIC_BEAT,
                           resources_per_worker={"GPU": 0.5})
    module = LlamaModule(cfg, lr=ELASTIC_LR, warmup_steps=2,
                         total_steps=steps_total)
    dm = SyntheticLMDataModule(cfg, batch_size=ELASTIC_BATCH,
                               n_train=ELASTIC_BATCH * world
                               * ELASTIC_EPOCH_STEPS,
                               n_val=ELASTIC_BATCH * world)
    trainer = Trainer(device="cuda", strategy=strategy,
                      max_epochs=ELASTIC_EPOCHS, logger=False, seed=0,
                      limit_train_batches=ELASTIC_EPOCH_STEPS,
                      limit_val_batches=1, enable_checkpointing=False,
                      callbacks=[smoke.ElasticProbe(probe)])
    fuses = os.path.join(root, "fuses")
    os.environ["TORCHRT_ELASTIC_DIR"] = root  # the ledger and its handoffs
    clear = _fault_env(ELASTIC_SPEC, fuses)
    t = time.perf_counter()
    try:
        with _zygote():  # the first group forked too, as the spare is
            trainer.fit(module, datamodule=dm)
        zygote = rt.api._state.zygote
        zygote_pid, zygote_boot = zygote.pid, zygote.ready_s
    finally:
        clear()
        os.environ.pop("TORCHRT_ELASTIC_DIR", None)
        # the runtime and its zygote end with the phase
        rt.shutdown()
    fit_s = time.perf_counter() - t
    launcher = strategy.launcher
    _check_ring(launcher.transport, "train_ray_elastic", ["heartbeat_queue"])
    check(launcher.backend == "gloo", f"train_ray_elastic: backend "
          f"{launcher.backend}")
    check(launcher.failures == [], f"train_ray_elastic: relaunched "
          f"{launcher.failures}")
    check(trainer.current_epoch == ELASTIC_EPOCHS, f"train_ray_elastic: "
          f"ended at epoch {trainer.current_epoch}")
    el = launcher.elastic
    check(el["resizes"] == {"shrink": 1, "grow": 1},
          f"train_ray_elastic: resizes {el['resizes']}")
    with open(os.path.join(fuses, "rank1-crash-at3")) as f:
        crashed = float(f.read())
    records = []
    import glob

    for path in glob.glob(os.path.join(probe, "probe_*.jsonl")):
        records.extend(_read_lines(path))
    worlds = {r["world"] for r in records}
    check(worlds == {1, 2}, f"train_ray_elastic: worlds {records}")
    survivors = {r["pid"] for r in records if r["world"] == 1}
    check(len(survivors) == 1, f"train_ray_elastic: world-1 pids {records}")
    (survivor,) = survivors
    check(sorted({r["epoch"] for r in records if r["pid"] == survivor})
          == list(range(ELASTIC_EPOCHS)), f"train_ray_elastic: the survivor's "
          f"epochs {records}")
    last = [r for r in records if r["epoch"] == ELASTIC_EPOCHS - 1]
    check({r["world"] for r in last} == {2} and len({r["pid"] for r in last})
          == 2, f"train_ray_elastic: the last epoch {last}")
    pids = sorted({r["pid"] for r in records})
    check(len(pids) == 3, f"train_ray_elastic: {len(pids)} processes {pids}")
    hashes = {}
    for path in glob.glob(os.path.join(probe, "hash_*")):
        with open(path) as f:
            hashes[path] = f.read().strip()
    check(len(hashes) == 2 and len(set(hashes.values())) == 1,
          f"train_ray_elastic: the members' weights differ {hashes}")
    counts = trainer.worker_launch_counts
    for name in ("rmsnorm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(counts.get(name, 0) > 0, f"train_ray_elastic: {name} launched "
              f"{counts.get(name)} times in the workers")
    apps_clean = (pids, zygote_pid)

    batches = _elastic_batches(probe)
    check([w for _, w, _, _ in batches] == [2, 2, 2, 1, 1, 2, 2],
          f"train_ray_elastic: the applied steps' worlds "
          f"{[(s, w) for s, w, _, _ in batches]}")
    first_w1 = min((r["start"] for _, w, _, recs in batches if w == 1
                    for r in recs))
    logs = [r for log in el["worker_logs"] for r in (log or [])]
    shrink = next(r for r in logs if r["kind"] == "shrink")
    grow = next(r for r in logs if r["kind"] == "grow")
    join = next(r for r in logs if r["kind"] == "join")
    grow_step = max(s for s, w, _, _ in batches if w == 1) + 1
    first_w2 = min(r["start"] for s, w, _, recs in batches
                   if w == 2 and s >= grow_step for r in recs)
    step_s = {}
    for s, w, _, recs in batches:
        step_s.setdefault(w, []).append(max(r["end"] for r in recs)
                                        - min(r["start"] for r in recs))
    # the weights the launcher loaded onto this process's card, kept on the
    # host: the card must hold nothing of the fit when its memory is read
    weights = [t.detach().cpu() for t in _leaves(module.params)]
    del trainer, module
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "batches": batches, "weights": weights,
            "fit_s": fit_s, "crash_to_step_s": first_w1 - crashed,
            "grow_to_step_s": first_w2 - grow["wall"],
            "spare_spawn_s": launcher.timings.get("spare_spawn_s"),
            "zygote_boot_s": zygote_boot, "shrink": shrink, "grow": grow,
            "join": join, "step_s": step_s, "setup_s":
            launcher.timings["setup_s"], "clean": apps_clean,
            "events": el["events"]}


def elastic_replay(torch, batches):
    """One process on the card training the recorded global batches in
    order with the group's arithmetic: at each step every rank's rows in a
    forward and backward of their own, the gradients accumulated in the
    leaves (the bf16 sum the gloo all-reduce makes), divided by the step's
    world, then the module's AdamW and schedule. One backward over the
    global batch sums the head's contributions (the chunked loss gives it
    8 a rank) in another order, and AdamW turns that rounding into sign
    flips of near-zero gradients: a rehearsal measured 0.00962 of a leaf's
    max against it. Returns the parameter tree."""
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        lm_loss,
    )
    from ray_lightning_tpu_torch.utils.tree import tree_map

    module = LlamaModule(LlamaConfig.small(), lr=ELASTIC_LR, warmup_steps=2,
                         total_steps=len(batches))
    gen = torch.Generator(device="cuda").manual_seed(0)  # the fit's seed
    module.params = tree_map(lambda t: torch.nn.Parameter(t.detach().clone()),
                             module.init_params(gen, torch.device("cuda")))
    conf = module.configure_optimizers()
    opt, sched = conf["optimizer"], conf["lr_scheduler"]
    leaves = _leaves(module.params)
    for _, world, rows, _ in batches:
        tokens = torch.from_numpy(rows).cuda()
        for chunk in tokens.split(ELASTIC_BATCH):
            lm_loss(module.params, chunk, module.config)[0].backward()
        grads = [t.grad for t in leaves]
        if world > 1:
            torch._foreach_div_(grads, float(world))
        opt.step()
        sched.step()
        for t in leaves:
            t.grad = None
    return module.params


def elastic_phase(torch, card):
    """train_ray_elastic in a directory of the checkout's build/ that is
    removed after; then no worker or zygote process is left and the card's
    memory is back; the replay; the phase's time beside its budget."""
    import shutil
    import tempfile

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="elastic_", dir=build)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    apps, used = _compute_apps(), _card_used_mib()
    t = time.perf_counter()
    try:
        got = train_ray_elastic(torch, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    pids, zygote_pid = got["clean"]
    _card_clean(apps, used, pids + [zygote_pid], "elastic")
    want = elastic_replay(torch, got["batches"])
    bitwise, worst, differ, total = _weights_gap(
        torch, got["weights"], _leaves(want))
    by_leaf = ", ".join(
        f"{path} {max_err(a.float(), b.detach().float().cpu()) / max(float(b.detach().abs().max()), 1e-30):.3g}"
        for a, (path, b) in zip(got["weights"], _paths(want)))
    phase_s = time.perf_counter() - t
    shrink, grow, join = got["shrink"], got["grow"], got["join"]
    med = {w: _median(v) for w, v in got["step_s"].items()}
    log(f"train_ray_elastic on {card}: LlamaConfig.small() bf16 remat AdamW, "
        f"RayStrategy(num_workers=2, use_gpu=True, elastic=True, "
        f"min_workers=1, max_failures=0, hang_timeout={ELASTIC_HANG_TIMEOUT}, "
        f"heartbeat_interval={ELASTIC_BEAT}) over gloo at {ELASTIC_BATCH} x "
        f"2048 rows each, {ELASTIC_EPOCHS} epochs of {ELASTIC_EPOCH_STEPS} "
        f"steps under {ELASTIC_SPEC!r}: no relaunch, resizes "
        f"{{'shrink': 1, 'grow': 1}}, worlds {{1, 2}}, one survivor through "
        f"every epoch, 3 processes, the last epoch at world 2, the members' "
        f"weights bitwise equal (sha256), the weights vs one process on the "
        f"recorded global batches: {'bitwise' if bitwise else f'{differ} of {total} elements differ, worst {worst:.3g} of a leaf max'} "
        f"(tol 2^-7); fit {got['fit_s']:.1f}s (start-up {got['setup_s']:.2f}s)")
    log(f"train_ray_elastic recovery on {card}: crash -> the survivor's first "
        f"step at world 1 {got['crash_to_step_s']:.2f}s (shrink: resize "
        f"{shrink['resize_s']:.2f}s, rendezvous {shrink['reconnect_s']:.3f}s, "
        f"tier {shrink['tier']}); the spare forked from the zygote in "
        f"{got['spare_spawn_s']:.3f}s (the zygote's own boot "
        f"{got['zygote_boot_s']:.2f}s, at the launch); handoff "
        f"{grow['handoff_bytes'] / 1e9:.3f} GB written in "
        f"{grow['handoff_write_s']:.2f}s, read in {join['handoff_read_s']:.2f}s"
        f"; grow -> the first step at world 2 {got['grow_to_step_s']:.2f}s; "
        f"step median {med.get(2, float('nan')) * 1e3:.0f} ms at world 2 "
        f"({[round(x * 1e3) for x in got['step_s'].get(2, [])]}), "
        f"{med.get(1, float('nan')) * 1e3:.0f} ms at world 1 "
        f"({[round(x * 1e3) for x in got['step_s'].get(1, [])]}); the "
        f"workers' launches {got['counts']}")
    log(f"train_ray_elastic vs the replay by leaf (gap / leaf max): "
        f"{by_leaf}")
    log(f"elastic phase on {card}: {phase_s:.1f}s (budget "
        f"{ELASTIC_BUDGET_S:.0f} s)")
    check(worst <= RAY_BF16_TOL, f"train_ray_elastic: a leaf {worst:.3g} of "
          f"its max from the one-process replay (tol 2^-7)")
    counts = got["counts"]
    del got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_ray_elastic": counts}


FLEET_LAYERS = 8  # Llama-3-8B widths cut to 8 layers: ~5.6 GB a replica
FLEET_PHASE_BUDGET_S = 45.0


def fleet_builder(n_layers, seed):
    """A replica actor's ``(params, cfg)``: Llama-3-8B widths cut to
    ``n_layers``, bf16 weights from a seeded generator on the card (built in
    the actor, never shipped from this process)."""
    import torch

    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=n_layers)
    return init_params(cfg, torch.Generator(device="cuda").manual_seed(seed)), \
        cfg


def fleet_phase(torch, card):
    """A ``ReplicaGroup`` of two ``ServeReplicaActor`` processes, forked from
    the zygote, each building Llama-3-8B widths at ``FLEET_LAYERS`` layers
    from a seeded generator, on the main path's engine settings: 16 requests
    reach both replicas and ``check()`` finds both ok; one actor is
    SIGKILLed mid-decode, ``check()`` relaunches it, its requests resume to
    full length, ``relaunches_total == 1``; 8 more requests and a
    ``remove_replica()`` drop nothing; after the shutdown no process of the
    group is left and the card's used memory is back. Launches: the two
    live actors' own counts after the 16 requests, each exact for its
    prefills and decode steps. Printed: the forked start-up, the kill to
    the relaunched replica's first beat, tokens/s, the phase's time beside
    ``FLEET_PHASE_BUDGET_S``."""
    import functools
    import os
    import signal

    import numpy as np

    from ray_lightning_tpu_torch.models.llama import LlamaConfig
    from ray_lightning_tpu_torch.runtime.api import pid_exited
    from ray_lightning_tpu_torch.serving import ReplicaGroup

    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    apps, used = _compute_apps(), _card_used_mib()
    t_phase = time.perf_counter()
    builder = functools.partial(_smoke_module().fleet_builder, FLEET_LAYERS, 0)
    vocab = LlamaConfig.llama3_8b().vocab_size
    reqs = requests(np.random.default_rng(0), vocab, 16, 512, 32, 256)
    pids = []
    with _zygote():  # the actors, and the relaunch, forked from the zygote
        t = time.perf_counter()
        group = ReplicaGroup(builder,
                             engine_kwargs=dataclasses.asdict(
                                 main_engine_config()),
                             num_replicas=2, device="cuda",
                             heartbeat_interval=0.2, max_retries=3).start()
        start_s = time.perf_counter() - t
        pids += [h._pid for h in group.handles.values()]
        try:
            t = time.perf_counter()
            futures = [group.submit(p, max_new_tokens=n) for p, n in reqs]
            check({f.replica for f in futures} == {0, 1},
                  f"fleet: routed to {[f.replica for f in futures]}")
            victims = [f for f in futures if f.replica == 1]
            deadline = time.perf_counter() + 300
            while len(group._poll(1, victims[0].request_id)["tokens"]) < 2:
                check(time.perf_counter() < deadline,
                      "fleet: replica 1 produced no tokens")
                time.sleep(0.01)
            pid = group.handles[1]._pid
            t_kill = time.perf_counter()
            os.kill(pid, signal.SIGKILL)
            while not pid_exited(pid):
                check(time.perf_counter() - t_kill < 30,
                      f"fleet: pid {pid} outlived SIGKILL")
                time.sleep(0.01)
            verdict = group.check()
            relaunch_s = time.perf_counter() - t_kill
            check(verdict == {0: "ok", 1: "relaunched"},
                  f"fleet: check() after the kill {verdict}")
            pids.append(group.handles[1]._pid)
            health = group._supervisor.health
            while health.get(1) is None or health[1].last_beat is None:
                check(time.perf_counter() - t_kill < 120,
                      "fleet: the relaunched replica never beat")
                time.sleep(0.005)
            beat_s = time.perf_counter() - t_kill
            got = [f.result(timeout=300) for f in futures]
            elapsed = time.perf_counter() - t
            for (_, n), toks, f in zip(reqs, got, futures):
                check(len(toks) == n and all(0 <= x < vocab for x in toks),
                      f"fleet {f.request_id}: {len(toks)} tokens")
            check(group.relaunches_total == 1 and group.retries_total >= 1,
                  f"fleet: {group.relaunches_total} relaunches, "
                  f"{group.retries_total} retries")
            verdict2 = group.check()
            check(verdict2 == {0: "ok", 1: "ok"}, f"fleet: check() {verdict2}")
            counts, per_actor = {}, {}
            for i, h in group.handles.items():
                c = h.kernel_launches.remote().result(timeout=60)
                d = h.describe.remote().result(timeout=60)
                expect = launches_expected(FLEET_LAYERS, d["prefills"],
                                           d["decode_steps"])
                check(c == expect, f"fleet replica {i}: launches {c} != "
                      f"{expect}")
                per_actor[i] = (d["prefills"], d["decode_steps"])
                _add(counts, c)
            more = [group.submit(p, max_new_tokens=n) for p, n in reqs[:8]]
            removed = group.remove_replica()
            check(removed == 1 and group.num_replicas == 1,
                  f"fleet: remove_replica() -> {removed}")
            more_got = [f.result(timeout=300) for f in more]
            check(all(len(x) == n for x, (_, n) in zip(more_got, reqs)),
                  "fleet: a request of the removed replica was dropped")
            for th in group._drain_threads:
                th.join(timeout=120)
            check(list(group.handles) == [0],
                  f"fleet: replicas {list(group.handles)} after the removal")
        finally:
            group.shutdown()
    _card_clean(apps, used, pids, "fleet")
    tokens = sum(len(x) for x in got)
    phase_s = time.perf_counter() - t_phase
    log(f"fleet on {card}: ReplicaGroup of 2 ServeReplicaActors forked from "
        f"the zygote, llama3_8b widths at {FLEET_LAYERS} layers bf16 built in "
        f"each actor from a seeded generator, main path engine settings: "
        f"start-up {start_s:.2f}s (both actors: fork, weights, KV pool, "
        f"kernel libraries); 16 requests on both replicas, replica 1 "
        f"SIGKILLed mid-decode: check() relaunched it {relaunch_s:.2f}s after "
        f"the kill, its first beat {beat_s:.2f}s after; its requests resumed "
        f"({group.retries_total} retries), all 16 to 32 tokens in "
        f"{elapsed:.2f}s -> {tokens / elapsed:.1f} tokens/s across the kill; "
        f"remove_replica() drained replica 1 with 8 more requests, none "
        f"dropped; (prefills, decode steps) of the live actors {per_actor}, "
        f"their launches {counts}")
    log(f"fleet phase on {card}: {phase_s:.1f}s (budget "
        f"{FLEET_PHASE_BUDGET_S:.0f} s)")
    return counts


SMOKE_LIMIT_S = 1140.0  # by the script's own clock

# the phases of a run; ``--phases a,b`` runs those alone and prints no
# result (a rehearsal of new phases)
PHASES = ("kernels", "serving", "generation", "moe_serving", "training",
          "train_moe", "ray", "ray_two_ranks", "ray_ep", "tune", "faults",
          "fleet", "elastic")


# the phases whose worker groups (or replica actors) are forked from the
# zygote
RAY_PHASES = {"ray", "ray_two_ranks", "ray_ep", "tune", "faults", "elastic",
              "fleet"}


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=None,
                        help=f"comma-separated subset of {', '.join(PHASES)}")
    args = parser.parse_args(argv)
    only = args.phases.split(",") if args.phases else None
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import ray_lightning_tpu_torch
    from ray_lightning_tpu_torch import kernels

    # the port under test is the checkout's own, never an installed copy
    here = Path(__file__).resolve().parent
    check(Path(ray_lightning_tpu_torch.__file__).resolve().parent.parent == here,
          f"ray_lightning_tpu_torch imported from {ray_lightning_tpu_torch.__file__}, "
          f"not from the checkout at {here}")

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        "TF32 off for matmul and cuDNN")

    # the libraries' nvcc runs and the ptxas reports' all at once
    from concurrent.futures import ThreadPoolExecutor

    t = time.perf_counter()
    with ThreadPoolExecutor(len(PTXAS_SOURCES)) as pool:
        usage = {source: pool.submit(kernels.resource_usage, source)
                 for source in PTXAS_SOURCES}
        libs = kernels.build()
        usage = {source: f.result() for source, f in usage.items()}
    log(f"built {len(libs)} kernel libraries and their ptxas reports in "
        f"{time.perf_counter() - t:.1f}s: " + ", ".join(p.name for p in libs))
    report_registers(usage)

    phases = PHASES if only is None else only
    unknown = [p for p in phases if p not in PHASES]
    check(not unknown, f"unknown phases {unknown}; the phases are {PHASES}")
    if "kernels" in phases:
        results = {
            "rmsnorm": check_rmsnorm(torch, F),
            "flash_fwd": check_flash(torch, F),
            "paged_decode": check_paged(torch, F),
            "argmax": check_argmax(torch),
        }
        results["flash_bwd_dq"], results["flash_bwd_dkv"] = check_flash_bwd(
            torch, F)
        check(set(results) == {k.name for k in kernels.KERNELS},
              f"kernel checks {sorted(results)} do not cover every kernel")
        check_new_path_shapes(torch, F, results)
    by_path = {}
    if "serving" in phases:
        paths, new_s, fleet_s = main_path(torch, card)
        by_path.update(paths)
        exactness(torch)
        t = time.perf_counter()
        disagg_exactness(torch)
        new_s += time.perf_counter() - t
        log(f"serving phase's disaggregation paths (serving_disagg, "
            f"serving_tenants, serving_faults, disagg_exactness) on {card}: "
            f"{new_s:.1f}s (budget {DISAGG_BUDGET_S:.0f} s)")
        t = time.perf_counter()
        by_path["fleet_exactness"] = fleet_exactness(torch)
        fleet_s += time.perf_counter() - t
        log(f"serving phase's fleet paths (serving_fleet, fleet_exactness) "
            f"on {card}: {fleet_s:.1f}s (budget {FLEET_BUDGET_S:.0f} s)")
        slot_exactness(torch)
        spec_exactness(torch)
    if "generation" in phases:
        by_path["generate_window"] = generate_window(torch, card)
        window_exactness(torch)
        by_path["serving_qwen_yarn"] = serving_qwen_yarn(torch, card)
        qwen_exactness(torch)
        by_path["generate_longrope"] = generate_longrope(torch, card)
        longrope_exactness(torch)
    if "moe_serving" in phases:
        by_path["serving_moe"] = serving_moe(torch, card)
        moe_exactness(torch)
    if RAY_PHASES & set(phases):
        # the Ray phases fork their worker groups from the zygote: boot it
        # now, so that its imports overlap the training phases
        from ray_lightning_tpu_torch import runtime as rt

        if not rt.is_initialized():
            rt.init(resources={"GPU": float(torch.cuda.device_count())})
        rt.warm_zygote()
    if "training" in phases:
        by_path["training"] = train_main_path(torch, card)
        train_exactness(torch)
        remat_variants(torch, card)
        by_path["training_complete"] = train_complete_path(torch, card)
        complete_exactness(torch)
    if "train_moe" in phases:
        by_path["train_moe"], _ = train_moe(torch, card)
        moe_train_exactness(torch)
    if "ray" in phases:
        ray_paths, _ = train_ray_ddp(torch, card)
        by_path.update(ray_paths)
    if "ray_two_ranks" in phases:
        by_path["ray_two_ranks"] = ray_two_ranks(torch, card)
    if "ray_ep" in phases:
        by_path["train_ray_ep"], _ = train_ray_ep(torch, card)
        with _zygote():  # its worker groups are forked from the zygote
            by_path["ep_exactness"] = ep_exactness(torch, card)
    if "tune" in phases:
        by_path.update(tune_phase(torch, card))
    if "faults" in phases:
        by_path.update(faults_phase(torch, card))
    if "fleet" in phases:
        # before elastic, whose clean-up ends the zygote
        by_path["fleet"] = fleet_phase(torch, card)
    if "elastic" in phases:
        by_path.update(elastic_phase(torch, card))
    if only is not None:
        log(f"phases {phases} done in {time.perf_counter() - T0:.1f}s; a "
            "partial run prints no result")
        return 0

    total_s = time.perf_counter() - T0
    check(total_s <= SMOKE_LIMIT_S, f"the run took {total_s:.1f}s by its own "
          f"clock, past its {SMOKE_LIMIT_S:.0f} s (60 s under the 1200 s "
          "limit)")
    entries = []
    for k in kernels.KERNELS:
        r = results[k.name]
        launches = {path: c[k.name] for path, c in by_path.items()}
        check(sum(launches.values()) > 0,
              f"kernel {k.name} launched on no main path")
        entry = {
            "name": k.name, "route": "cuda",
            "source": f"ray_lightning_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        # the other shapes and measurements of the kernel's check
        entry.update({key: v for key, v in r.items() if key not in entry})
        entries.append(entry)
    log(f"done in {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
