#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, each raising on failure (the process then exits non-zero and
prints no result line):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: every kernel compiled from ``src/repro_torch/csrc`` by nvcc, with
   each kernel's registers and spills from ptxas (the flash kernel's bf16
   route at head dim 256 and the paged kernel's bf16 16-head instance at
   head dim 128 must not spill; its fp32 one is logged) and, where the
   toolkit has
   ``cuobjdump``, the count of tensor-core instructions (``HGMMA`` from
   wgmma, ``HMMA`` from mma.sync) in each kernel's SASS (every head-dim
   instance of the flash kernel's bf16 route and the chunked WKV6 kernels
   must have some);
3. kernels against their plain PyTorch versions at the serving paths'
   shapes, in bf16 and fp32, with times, bounds and the library yardstick:
   paged decode (K1; also at qwen3-moe's 16 q heads per kv head, the
   ``kMaxG`` instance, and starcoder2's 9), flash prefill (K2; also at
   qwen3-moe's 64 q / 4 kv heads, at head dim 128 with a window of 512
   and with llama4's window of 8192 at 10000 tokens, and at gemma2's head
   dim 256 with its window and softcap, to 6000 tokens, and at the
   hybrid's and the VLM's heads: hymba's 25 q / 5 kv heads of 64 with a
   window of 1024, llava's 56 q / 8 kv heads of 128; K1 also at llava's 7
   q heads per kv head; K2 also at a query offset, a serving rank's rows
   of the sequence, ``[flash-offset]``: hymba's heads with its window,
   qwen's 40 / 8 of 128, gemma2's 16 / 8 of 256 with a window and the
   softcap, each timed beside the offset-0 call over the whole sequence),
   WKV6 (K3), segment zero-fill (K4); K1 and K2 also at the
   reduced configs' head dims 8, 12 and 16, which the bindings zero-pad to
   the 64-wide instance.  WKV6 also runs on decays that RWKV6's own law
   gives (w = exp(-exp(dec)), dec over [-8, 5], down to w = 0) and on runs
   of strong decays followed by weak ones inside a chunk, at ragged
   lengths and head sizes 16-128, and at head sizes 8, 24, 48 and 96,
   which the binding pads to the next instance; and on a memory of
   thousands of tokens, logged against an fp64 run of the recurrence.  K4
   is timed beside ``x.narrow(0, lo, hi - lo).zero_()`` on the same buffer.
   Timed launches queue behind a sleep of the card, so the events time the
   card and not the host's enqueue; K1 is timed with the L2 cache flushed
   before each call (a decode step finds each layer's pages cold) and warm;
4. paged serving: ``ServingEngine`` serves 8 requests on full-width
   qwen2.5-32b (depth cut 64 -> 8 layers, random weights from a seeded
   generator), and the launch counts prove the path went through K1, K2;
5. card against CPU: the same small fp32 models (a qwen-style transformer,
   an RWKV6 and a gemma2 with heads of 256, a window and softcaps, and the
   reduced qwen2.5, gemma2, starcoder2, qwen3-moe, llama4-scout, hymba and
   llava configs at their own head dims of 16, 12 and 8) serve the same
   greedy requests on the card (kernels) and on the CPU (plain versions);
   a MoE stream may fork only where a routing row that the two choose
   otherwise, or the logits at the fork, are near a tie; then the reduced
   llava with a 4-patch prefix and the reduced whisper with its frames
   through the model-level prefill and decode steps, streams equal;
6. dense serving: ``ServingEngine`` serves 8 requests on rwkv6-3b at its
   full width and depth (32 layers), and the launch counts prove the path
   went through K3 and not K1 or K2; then the device time of one
   2048-token prefill by kernel (K3, GEMMs, the rest) and its idle share;
7. dense serving of a transformer: 8 requests (prompts to 6000 tokens) on
   gemma2-9b at its full width and depth (42 layers), every prefill layer
   through K2 at head dim 256 with its window and softcap, decode on the
   dense cache; the launch counts prove K2 ran once per prefill and layer
   and K1, K3, K4 never; then the device time of one 6000-token and one
   2048-token prefill by kernel (K2, GEMMs, the rest) and its idle share
   (``[gemma-prefill]`` lines);
8. the engine's other prefill modes on phase 4's model: a 4000-token
   prompt admitted under three decoding requests with chunked prefill
   (512-token budget; paged, beside monolithic, and dense), and the
   rebatching baseline beside incremental prefill in dense mode;
9. paged serving of a mixture of experts: phase 4's 8 requests on
   qwen3-moe-235b-a22b at its published widths (128 experts, top-8, 64 q
   / 4 kv heads of 128; depth cut 94 -> 8 layers), every decode step
   through K1 at 16 q heads per kv head and every full prefill through
   K2, with the copies each prefill dropped past the experts' capacity
   logged beside how far the router's input rows share one direction;
   layer 0's routing of 256 tokens in fp32 on the card and on the CPU
   (equal top-k where the margin is clear, equal drops); then the device
   time of one 2048-token prefill by kernel (K2,
   the expert GEMMs, routing with dispatch and combine, the other GEMMs,
   the rest; ``[moe-prefill]`` lines) and phase 4's decode window;
10. dense serving of a mixture of experts with windows: 8 requests
   (prompts to 10000 tokens) on llama4-scout-17b-a16e at its published
   widths (16 experts, sigmoid top-1, a shared expert, window 8192 on 3
   layers of 4; depth cut 48 -> 8 layers), every prefill layer through K2
   at head dim 128 (the 10000-token prompt past the window); K1, K3, K4
   never;
11. ``Server`` with user post-processors on phase 4's model and requests:
   once without post-processors (the plain streams), then inline and on
   the concurrent plane (2 workers, warm-pool watermark 2, heartbeats at
   30 s) with a sort on five requests, a flip on one, a custom op the
   Sentry must deny on one and one that raises.  Each run holds the good
   streams to the UDF applied to the plain ones, the bad requests to their
   errors, the UDFs to CUDA tensors, admission misses to the distinct
   (program, shape) pairs, the ledgers, K1 = decode steps x layers and
   K2 = full prefills x layers, and ``/metrics`` (127.0.0.1, ephemeral
   port) to the engine's, the controller's and the pool's counters; then
   cold against warm admission and verify against interpret mode for a
   sort on a 4096-token CUDA tensor (``[admission]`` line);
12. dense serving of the hybrid: phase 4's 8 requests on hymba-1.5b at its
   full width and depth (32 layers; attention and SSM heads in every
   layer), every prefill layer through K2 at head dim 64 with the window
   of 1024 on 29 layers, the SSM scan in plain PyTorch (any prompt
   length, where the reference's needs 64 to divide it); K1, K3, K4
   never; then one 2048-token prefill's device time split into K2, the
   SSM scan, the other GEMMs and the rest (``[hybrid-prefill]`` lines);
13. the VLM: llava-next-34b at its published widths (depth cut 60 -> 8
   layers) serves phase 4's 8 text requests in paged mode (K1 at 7 q
   heads per kv head, K2 at 56 / 8); then one model-level prefill of 576
   patch embeddings and 1472 text tokens, timed, and 32 greedy decode
   steps held to a teacher-forced forward over the same prefix;
14. the enc-dec model: whisper-tiny's full config through the model-level
   API (the reference's engine cannot serve it): B = 4 frames of 1500, a
   4-token prompt, 64 greedy decode steps, fp32 streams equal on the card
   and the CPU; bf16 encode and decode-step times.  No kernel lies on
   this path;
15. training (``Trainer``, the reference's training route: no kernel has a
   backward, so none may launch): (a) phase 5's widened small configs,
   one per family (gemma2 with window and softcaps, qwen3-moe, llava with
   patch embeddings, RWKV6, hymba at 64 tokens, whisper with frames), 3
   fp32 steps on the card and on the CPU from the same weights and
   batches, losses, gradient norms and parameters held to each other (the
   entries of the first AdamW update whose gradient sign differs between
   the two counted; the CPU run that takes the card's gradient on those
   held to the CPU tests' limits, its own run to wider ones), the
   card's step-0 gradient finite and non-zero on every leaf (the q/k/v
   projections named in the log), once more with ``accum_steps=2``; a
   failure at step 3 with checkpoints every 2 steps recovered on the card
   to the parameters of an uninterrupted run one step longer (the
   reference's replay); (b) gemma2-9b at its published widths, 8 of 42
   layers, bf16, 6 steps at global batch 4 of 1024 tokens: finite losses,
   a non-zero gradient on and a change in every leaf, 0 launches of
   K1-K4, the median step time, tokens/s, peak memory, then one profiled
   step's busy share and forward / backward / optimizer spans
   (``[train-profile]``); (c) a blocking checkpoint of its parameters,
   restored onto the card bitwise, the legacy loader's ``SegfaultError``
   on the same image, save and restore GB/s (``[train-ckpt]``); (d) the
   reference's remat policies (``build_model(cfg, remat=)``,
   ``[train-remat]``): (b)'s model from its weights and first batch,
   stepped once under ``"full"`` and 3 times under each of ``"dots"`` and
   ``"none"``, the step-0 loss equal to ``"full"``'s and every leaf's
   gradient within 1e-3 of it (relative L2), each policy's median step
   time, tokens/s and peak memory; hymba-1.5b and rwkv6-3b at their
   published widths, 1 of 32 layers, batch 1 of 2048 tokens, bf16: one
   step of hymba under ``"full"`` and ``"none"`` (gradients held to each
   other, the SSM scan keeping one state per 64-token chunk, not per
   token), one of RWKV6, each with its peak;
16. orchestration and replicas on phase 4's model: (a) a
   ``WorkloadOrchestrator`` on a 2-worker ``ServerlessScheduler`` over a
   ``ThreadExecutor``, with an ``ElasticAutoscaler`` (2..3 workers) ticked
   on its cadence, runs three lanes: decode (phase 4's engine, ServerConfig
   and 8 requests, paged), train (a ``TrainStepper`` over gemma2-9b at its
   published widths, 4 of 42 layers, bf16, global batch 2 of 1024 tokens,
   6 steps) and batch (8 jobs of host hashing between cooperative
   checkpoints and one small matmul on the card).  Each request completes
   once, the page and slot ledgers balance, greedy streams equal the
   engine's run alone (a fork only under ``CLEAR_MARGIN``), the train
   losses equal a direct run's within 1e-5, at least one batch job is
   preempted and every one succeeds, ``orchestrator_stats()`` matches the
   lanes, ``/metrics`` renders, and the peak stays under
   ``TRAIN_PEAK_LIMIT`` (``[orch]`` lines: decode rate and step times and
   the train step co-located and alone, preemptions, the autoscaler's
   decisions, the card's busy share); (b) a ``ReplicaSet`` of 2 engines
   over that model on one ``SimExecutor`` serves the 8 requests
   undisturbed, then under a loud ``kill_replica`` and a silent
   ``kill_mesh_member`` reaped by the heartbeat, each armed through
   ``FailureInjector.arm_replicas``: each request once, the ledgers,
   re-homed greedy streams against the undisturbed ones, K1/K2 = decode
   steps / full prefills x layers (``[replica]`` lines).  ``--phases
   1,2,16`` runs it alone;
17. tensor-parallel serving on the card (``repro_torch.launch.mesh``: shard
   worker processes in one gloo group, two ranks on ``cuda:0``; NCCL
   refuses two ranks on one GPU): (a) ``paged_attention_sharded`` over 2
   ranks at phase 3's K1 shapes (8 kv heads of 5 q, and qwen3-moe's 4 of
   16) bit-identical to the unsharded K1 and within TOL of the plain
   version, one K1 launch in each rank (``[tp-k1]``), and K2 in each rank
   at its share of qwen2.5-32b's heads (20 q / 4 kv of 128, 2048 tokens,
   causal) within TOL of the plain version, one launch each
   (``[tp-k2]``); (b) phase 4's model
   and 8 requests served paged by a no-mesh engine and by one on the
   2-rank mesh (20 q / 4 kv heads per rank): every request done, no live
   page after the drain, ``tp_shards`` 2, each rank's K1 = decode steps x
   layers and K2 = full prefills x layers and none in the controller, the
   logits of the two runs within ``TP_LOGIT_REL`` (relative L2) up to
   each greedy stream's first fork and a fork only where that difference
   can swap the top two; tokens/s, step p50 and each process's peak
   memory, two ranks time-sharing one card, not a TP speed
   (``[tp-serve]``); (c) a ``ReplicaSet`` of 2 replicas x 2 ranks (four
   workers) at full width and 2 layers against a whole-device set,
   undisturbed and under ``kill_replica`` and ``kill_mesh_member``, held
   as (b) (``[tp-replica]``); every mesh closed and no worker left
   (``[tp]``).  ``--phases 1,2,17`` runs it alone.

18. training on a mesh (``Trainer(mesh=)``: every rank a process of its
   own, gloo ranks on ``cuda:0``, parameters and AdamW moments stored
   split by the reference's rules; the training route, no kernel): (b)
   gemma2-9b at its published widths, 4 of 42 layers, bf16, global batch
   2 of 1024 tokens, 3 steps on (data=2, model=2) against one device on
   the card, each rank's resident parameters and moments against a
   quarter of the whole, its peak memory, the median step
   (``[mesh-train-dense]``); (d) the 1-layer cut saved from that mesh
   after 1 step by rank 0 and restored onto one device: each rank's
   shard of the restored parameters, moments and step count equal to the
   rank's at the save (digests), and the next 2 steps on one device
   equal to the mesh's (``[mesh-train-ckpt]``); (c) qwen3-moe-235b-a22b at
   its published widths, 1 of 94 layers, bf16, expert-parallel on
   (data=1, model=2): 64 experts a rank, the copies dropped past each
   rank's capacity, finite losses, peak memory (``[mesh-train-moe]``); (a)
   phase 15's small fp32 configs of gemma2, qwen3-moe, RWKV6, hymba and
   whisper (with its frames) and llama4-scout's reduced one, with a
   ragged loss mask, 3 steps on a 2 x 2 mesh on the card against the same
   mesh of CPU ranks (phase 15's limits) and, but for the MoE (capacity
   per shard), against one device on the card (``[mesh-train-small]``);
   (e) qwen2.5-32b at its published widths, 2 of 64 layers, bf16, global
   batch 2 of 1024 tokens, 3 steps on (data=1, model=3): its 40 q heads
   and 1024 tokens divide 3 neither, so attention runs sequence-parallel
   on a padded sequence, held against one device at (b)'s limits
   (``[mesh-train-sp]``); (f) rwkv6-3b and
   hymba-1.5b at their published widths, 1 of 32 layers each, bf16,
   global batch 2 of 1024 tokens, 3 steps on (data=1, model=2): RWKV6's
   recurrence on each rank's one row, hymba's query rows and halves of
   ``d_inner``, against one device at (b)'s limits and the first step's
   loss within 2e-4, each rank's parameters, moments and peak
   (``[mesh-train-split]``; peak lr 1e-3: at 3e-3 hymba's bf16 steps
   drift apart on any layout; both in one spawn of ranks); no rank left.
   The steps run the reference's training layout: weights gathered layer
   by layer, every family's work split over ``model``
   (``launch/steps.py``).  The ranks time-share one card: step times
   check the path and are not a data-parallel speed.  ``--phases
   1,2,18`` runs it alone; ``--mesh-cells dense,moe`` (of
   ``dense,moe,small,sp,split``) runs only those of its cells (a parent
   tree without the sequence-parallel layout cannot hold (e)'s ranks on
   one card).

19. the cost model and the dry run (``repro_torch.launch.hlo_cost``,
   ``launch/dryrun.py``): (a) phase 15's full-width gemma2-9b step (8
   layers, bf16, batch 4 of 1024) traced on fake CUDA tensors under the
   cost model: its FLOPs within 2 % of ``FlopCounterMode`` on the real
   step, its traced peak within 10 % of ``max_memory_allocated``, and its
   roofline bound on the H100 SXM datasheet constants beside the measured
   median step, the share at most 1.05 (``[cost-train]``); (b) phase 4's
   qwen2.5-32b (8 layers) decoding 4 lanes of 2048 tokens in paged mode:
   the plain step counted on the card's tensors, held the same way, and
   its bound beside the median of the kernel step, K1 once per layer
   (``[cost-decode]``); (c) gemma2-9b ``train_4k`` and whisper-tiny
   ``decode_32k`` dry-run as rank 0 of a fake world of 16 x 16: per-rank
   FLOPs, bytes, wire bytes by collective, the peak against 80 GB (a
   training cell that does not fit fails) and the useful-FLOP ratio
   (``[dryrun]``; host work alone, started at the lowest priority before
   phase 3 when other phases run too).
   ``--phases 1,2,19`` runs it alone.

20. serving on a mesh in the reference's serving layout, every family
   (``make_prefill_fn`` / ``make_decode_fn(shardings=, layout="seq")``:
   the weights at rest in the serving rules' shards, each layer's
   gathered where it runs, the prefill sequence-parallel over ``model``,
   each rank's window of the decode state), gloo ranks on ``cuda:0``,
   each cell against one device running the same weights, dtype (bf16)
   and prompt: (a) gemma2-9b at its published widths, 4 of 42 layers, on
   (data=2, model=2): 4 lanes of a 1280-token prompt into a cache of 2048
   (the prompt crosses the ranks' window boundary at 1024), then 64 greedy
   decode steps on rank 1's window; each rank runs K2 on 8 of the 16 heads
   at head dim 256 with window and softcap (``[mesh-serve-dense]``); (b)
   qwen2.5-32b, 2 of 64 layers, on (1, 3): its 40 heads, 1000 tokens and
   2048 rows divide 3 none, so attention splits by query rows on a padded
   sequence, each rank running K2 on its 334 rows at their offset (0, 334,
   668), and the cache stays whole (``[mesh-serve-sp]``); (c)
   qwen3-moe-235b-a22b, 1 of 94 layers, on (1, 2), its capacity factor
   raised so no copy is dropped on one device or on a shard, 64 experts a
   rank (``[mesh-serve-moe]``); (d) rwkv6-3b, 2 of 32 layers, on (1, 2):
   4 lanes of 1000 tokens, each rank running K3 on its 2 rows and keeping
   32 of each head's 64 value columns of the state (``[mesh-serve-rwkv]``);
   (e) hymba-1.5b, 4 of 32 layers (layer 1 has its window of 1024), on
   (1, 2): 4 lanes of 1500 tokens into 2048 rows, its 25 q / 5 kv heads
   dividing 2 neither (K2 at offsets 0 and 750), its ``d_inner`` split,
   its one-device run repeated in fp32 as a witness of bf16's own drift,
   to which the ranks' logits are held too (``[mesh-serve-hybrid]``); (f) whisper-tiny at full depth on (1, 2): 4
   lanes of 1500 frames and 60 tokens into 128 rows, its cross K/V split
   by heads, no kernel on the path (``[mesh-serve-audio]``); (d)-(f) 16
   steps; the cells of one mesh shape share one spawn of ranks.  Each
   rank's logits at every step, its greedy tokens (fed one
   device's) and its window of every decode-state leaf after the prefill
   and after the steps against one device's (``MESH_SERVE_LOGIT_REL``,
   ``MESH_SERVE_CACHE_REL``; a token may differ only where one device's
   top-2 margin is under twice the logit difference there; a logits row
   whose token took other experts is logged and left out of the logits
   limit); each rank's launches and K2's query offsets on a line of their
   own, its weights and peak memory beside one device's; a launch of a
   kernel off the cell's path, a rank that ran the plain route where one
   device ran the kernel, or a query-rows rank whose K2 offset is not its
   chunk's first position fails.  The ranks time-share one card: times
   check the path and are not a parallel speed.  ``--phases 1,2,20`` runs
   it alone; ``--mesh-serve-cells rwkv,hybrid,audio`` runs only those of
   its cells.

With all twenty, a summary follows: one ``{"kernels": [...]}`` line (each
kernel's launches summed over the phases that ran it), then the result
line.  ``--phases 1,2,3`` runs a subset and prints no result line (without
2, the kernels build at their first launch).  ``--src DIR`` imports
``repro_torch`` from another checkout's ``src/``, so one call can run the
same phases on a parent tree and on this one (``--phases 1,7 --src
checkout/parent/src``).  Imports nothing of JAX or of the reference
package ``repro``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel and
# of each whole step, one set for both: set in main from
# repro_torch.launch.hlo_cost (HBM_BW, PEAK_FLOPS by dtype)
HBM_BYTES_PER_S = None
PEAK_FLOPS = None
# kernel vs plain version, elementwise |out - ref| <= atol + rtol * |ref|.
# Both compute in fp32 and round once to the output dtype, so in bf16 they
# may differ by one bf16 ulp (at most 2**-7 * |ref|); in fp32 they differ by
# the order of sums over up to 4096 keys
TOL = {torch.bfloat16: (1e-5, 2.0 ** -7), torch.float32: (1e-5, 1e-4)}
# WKV6's final state is fp32 whatever the inputs' dtype, so it is held to
# the fp32 limit: both sides run the same fp32 recurrence in another order
# of sums, each token adds a few fp32 roundings of |S|, and a decay below
# 0.95 forgets them within ~20 tokens, so the carried error stays near 20
# ulps of |S|, far inside rtol 1e-4
SERVE_LAYERS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


# cycles per second that ``torch.cuda._sleep`` is given for a second of
# sleep: at or above the card's top SM clock, so the sleep is never short
SLEEP_CYCLES_PER_S = 2.0e9
# bytes written between K1 launches to evict the 50 MB L2 cache
FLUSH_BYTES = 256 * 2 ** 20


def _hold_card(fn, calls: int) -> None:
    """Keep the card busy (``torch.cuda._sleep``) for about twice the host's
    time to enqueue ``calls`` calls of ``fn``, so the timed launches queue
    up behind it and the events measure the card, not the host's enqueue."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(0.2, 2 * calls * host_s) * SLEEP_CYCLES_PER_S))


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card, from CUDA events, with the
    launches queued behind a sleep of the card (caches warm)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _hold_card(fn, iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_cold_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` with the L2 cache flushed before each
    call: a write of FLUSH_BYTES, then events around the call alone."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]

    def one(pair=None):
        flush.zero_()
        if pair:
            pair[0].record()
        fn()
        if pair:
            pair[1].record()

    _hold_card(one, iters)
    for pair in events:
        one(pair)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def tol_str(dtype) -> str:
    atol, rtol = TOL[dtype]
    return f"atol {atol:g} + rtol {rtol:g} * |ref|"


def _share(out, ref, dtype) -> float:
    """The largest share of the elementwise limit of ``TOL[dtype]``."""
    atol, rtol = TOL[dtype]
    return ((out.float() - ref.float()).abs()
            / (atol + rtol * ref.float().abs())).max().item()


def compare(out, ref, dtype, what: str) -> tuple:
    """Max |out - ref| and its largest share of the elementwise limit;
    raises past the limit."""
    err = (out.float() - ref.float()).abs().max().item()
    share = _share(out, ref, dtype)
    if not share <= 1.0:
        raise AssertionError(
            f"{what}: max|err| {err} exceeds {tol_str(dtype)} "
            f"({share:.3g} x the limit)")
    return err, share


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 1


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


# --------------------------------------------------------------- phase 2


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.build_seconds:.1f}s)")
    text = (lib.parent / "build.log").read_text()
    for line in text.splitlines():
        if ("registers" in line or "spill" in line or line.startswith("==")
                or "Compiling entry" in line or "wgmma" in line
                or "setmaxnreg" in line or "warning" in line):
            log(f"[build] {line.strip()}")
    check_register_use(ptxas_usage(text))
    log_tensor_core_instructions(lib)


# tensor-core instructions each of these kernels' SASS must hold: every
# instance of the flash kernel's bf16 route (wgmma; head dims 64, 128 and
# 256) and the chunked WKV6 (mma.sync)
TENSOR_CORE_KERNELS = {"flash_prefill_tcILi64E": "HGMMA",
                       "flash_prefill_tcILi128E": "HGMMA",
                       "flash_prefill_tcILi256E": "HGMMA",
                       "wkv6_chunk_state": "HMMA", "wkv6_chunk_out": "HMMA"}
# kernels that must not spill: K2's bf16 route at head dim 256, whose
# consumers hold O, S and P in the 240 registers `setmaxnreg` gives them,
# and K1's bf16 kMaxG instance at head dim 128 (qwen3-moe's 16 q heads per
# kv head, starcoder2's 9), which holds 16 heads' q and accumulators
NO_SPILL_KERNELS = {
    "flash_prefill_tcILi256E": "K2 bf16 hd 256",
    "paged_split_kernelI13__nv_bfloat16Li128ELi16E": "K1 bf16 hd 128 kMaxG"}
# kernels whose registers and spills are logged, not held: K1's fp32 kMaxG
# instance spills 16 bytes at head dim 128 and is faster so than with the
# spill removed by loading 2 rows a step (0.1103 against 0.1476 ms on
# an H100 80GB HBM3 at 700 W)
LOGGED_SPILL_KERNELS = {
    "paged_split_kernelIfLi128ELi16E": "K1 fp32 hd 128 kMaxG"}


def ptxas_usage(text: str) -> dict:
    """Registers and spill bytes of each kernel from ``ptxas -v`` output:
    {mangled name: {"registers", "spill_stores", "spill_loads"}}."""
    usage = {}
    name = None
    for line in text.splitlines():
        if "Compiling entry function '" in line:
            name = line.split("Compiling entry function '")[1].split("'")[0]
            usage[name] = {}
        elif name and "spill stores" in line:
            words = line.replace(",", " ").split()
            usage[name]["spill_stores"] = int(
                words[words.index("spill") - 2])
            usage[name]["spill_loads"] = int(words[-4])
        elif name and "Used" in line and "registers" in line:
            words = line.split()
            usage[name]["registers"] = int(words[words.index("Used") + 1])
    return usage


def check_register_use(usage: dict) -> None:
    """Logs the registers and spills of ``NO_SPILL_KERNELS`` and
    ``LOGGED_SPILL_KERNELS``; raises if one is missing from the log or one
    of the first spills."""
    for key, what in {**NO_SPILL_KERNELS, **LOGGED_SPILL_KERNELS}.items():
        found = [(n, u) for n, u in usage.items() if key in n]
        if not found:
            raise AssertionError(f"{what}: {key} not in the ptxas log")
        for name, u in found:
            log(f"[build] {what} ({name[:60]}...): {u.get('registers')} "
                f"registers at entry, spill stores {u.get('spill_stores')} "
                f"bytes, spill loads {u.get('spill_loads')} bytes")
            if key in NO_SPILL_KERNELS and (u.get("spill_stores") != 0
                                            or u.get("spill_loads") != 0):
                raise AssertionError(f"{what} spills: {u}")


def log_tensor_core_instructions(lib: Path) -> None:
    """The count of tensor-core instructions (HGMMA from wgmma, HMMA from
    mma.sync) in each kernel's SASS, where the toolkit has ``cuobjdump``;
    raises if a kernel of ``TENSOR_CORE_KERNELS`` has none of its kind."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("[build] cuobjdump not found: HGMMA/HMMA counts not printed")
        return
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    counts = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif name:
            for op in ("HGMMA", "HMMA"):      # neither name holds the other
                if op in line:
                    ops = counts.setdefault(name, {})
                    ops[op] = ops.get(op, 0) + 1
    for name, ops in sorted(counts.items()):
        log(f"[build] SASS {name}: " + ", ".join(
            f"{n} {op}" for op, n in sorted(ops.items())) + " instructions")
    for kernel, op in TENSOR_CORE_KERNELS.items():
        if not any(kernel in name and op in ops
                   for name, ops in counts.items()):
            raise AssertionError(f"no {op} in the SASS of {kernel}")


# --------------------------------------------------------------- phase 3


def _paged_case(B, K, G, hd, page, dtype, seed):
    """Ragged lens up to 4096 (row 1 dead), pages permuted over a pool."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 4097, (B,)).astype(np.int32)
    lens[0] = 4096
    lens[1] = 0
    W = -(-int(lens.max()) // page)
    need = [-(-int(n) // page) for n in lens]
    P = sum(need) + 8
    perm = rng.permutation(P)
    table = np.full((B, W), -1, np.int32)
    at = 0
    for b in range(B):
        table[b, :need[b]] = perm[at:at + need[b]]
        at += need[b]
    dev = "cuda"
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((B, K * G, hd), generator=g, device=dev).to(dtype)
    kp = torch.randn((P, page, K, hd), generator=g, device=dev).to(dtype)
    vp = torch.randn((P, page, K, hd), generator=g, device=dev).to(dtype)
    return q, kp, vp, torch.from_numpy(table).to(dev), \
        torch.from_numpy(lens).to(dev)


# (B, K, G): qwen2.5-32b's grouping at two batches (the main case first);
# qwen3-moe-235b's 16 q heads over each of 4 (the kMaxG instance at every
# head), starcoder2-7b's 9 (kMaxG, the heads past 9 skipped) and
# llava-next-34b's 7 over each of 8
PAGED_CASES = [(4, 8, 5), (8, 8, 5), (4, 4, 16), (4, 4, 9), (4, 8, 7)]


def check_paged() -> dict:
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    hd, page = 128, 16
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B, K, G in PAGED_CASES:
            q, kp, vp, table, lens = _paged_case(
                B, K, G, hd, page, dtype, seed=B if G == 5 else 1000 + G)
            scale = hd ** -0.5
            wide = torch.cat([table, torch.full_like(table, -1)], dim=1)
            run = lambda t=table: paged_attention(q, kp, vp, t, lens,
                                                  scale=scale)
            out = run()
            out2 = run(wide)
            ref = paged_attention_ref(q, kp, vp, table, lens, scale=scale)
            what = f"paged_attention {dtype} B={B} K={K} G={G}"
            err, share = compare(out, ref, dtype, what)
            if not torch.equal(out, out2):
                raise AssertionError(
                    f"{what}: widths {table.shape[1]} and {wide.shape[1]} "
                    "differ")
            if not torch.equal(out[1], torch.zeros_like(out[1])):
                raise AssertionError(f"{what}: dead row is not 0")
            warm_ms = time_ms(run)
            ms = time_cold_ms(run)
            plain_ms = time_ms(
                lambda: paged_attention_ref(q, kp, vp, table, lens,
                                            scale=scale), iters=5)
            live = int(lens.sum())
            isz = q.element_size()
            nbytes = (2 * live * K * hd * isz + 2 * q.numel() * isz
                      + table.numel() * 4 + lens.numel() * 4)
            flops = 4 * live * K * G * hd
            bms, by = bound(nbytes, flops, dtype)
            log(f"[paged_attention] {str(dtype)[6:]} B={B} K={K} G={G} "
                f"hd={hd} page={page} W={table.shape[1]} live_rows={live}: "
                f"max|err|={err:.3g} ({share:.3f} x {tol_str(dtype)}), "
                f"width W==2W bitwise, "
                f"dead row 0 | {ms:.4f} ms L2 flushed, {warm_ms:.4f} ms "
                f"warm, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
            if dtype == torch.bfloat16:
                rows[(B, K, G)] = {
                    "max_abs_err": err, "ms": ms, "warm_ms": warm_ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "shape": f"B={B} KG={K * G} K={K} hd={hd} page={page}"
                             f" W={table.shape[1]} live_rows={live} bf16",
                    "tol": tol_str(dtype)}
    log("[paged_attention] library: no single PyTorch call computes paged "
        "decode attention -> library_ms null")
    main = rows[PAGED_CASES[0]]
    main["library_ms"] = None
    # qwen3-moe's grouping, the kMaxG instance: its numbers ride along
    main["g16"] = rows[(4, 4, 16)]
    main["g7"] = rows[(4, 8, 7)]                 # llava-next-34b's grouping
    return main


def _window_mask(rows: torch.Tensor, Sk: int, window: int) -> torch.Tensor:
    """SDPA's boolean mask for the queries at positions ``rows`` over
    ``Sk`` keys: causal, and within ``window`` positions where it is set
    (key j seen by query i for i - window < j <= i, as K2's window)."""
    keys = torch.arange(Sk, device=rows.device)[None, :]
    mask = keys <= rows[:, None]
    if window:
        mask &= keys > rows[:, None] - window
    return mask


#: the library call timed beside a kernel must compute the same function:
#: in fp32 within ``TOL`` of the plain version elementwise (a window mask
#: off by one key moves a row by ~1e-3); in bf16, which rounds other
#: intermediates than the plain version, within this relative L2
LIBRARY_REL = 2e-2


def _same_function(out, ref, dtype, what: str) -> None:
    """Raises unless ``out`` (the library call's) is the plain version's
    function ``ref``: elementwise within ``TOL`` in fp32, within
    ``LIBRARY_REL`` (relative L2) in bf16."""
    err = (out.float() - ref.float()).abs().max().item()
    rel = ((out.float() - ref.float()).norm()
           / ref.float().norm().clamp_min(1e-30)).item()
    log(f"[flash-library] {what} {str(dtype)[6:]}: max|err| {err:.3g}, "
        f"relative L2 {rel:.3g} against the plain version")
    if dtype == torch.float32:
        compare(out, ref, dtype, what)
    elif not rel <= LIBRARY_REL:
        raise AssertionError(f"{what}: not the kernel's function (relative "
                             f"L2 {rel:.3g})")


def check_flash() -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention

    cases = [  # (S, H, K, hd, window, cap)
        (2048, 40, 8, 128, 0, 0.0),
        (1000, 40, 8, 128, 0, 0.0),
        (512, 8, 4, 64, 128, 50.0),
    ] + FLASH_MOE_CASES + FLASH_HD256_CASES + FLASH_SLICE_CASES
    main = None
    extra = {}
    for dtype in (torch.bfloat16, torch.float32):
        for S, H, K, hd, window, cap in cases:
            g = torch.Generator("cuda").manual_seed(S + H)
            G = H // K
            q = torch.randn((1, S, K, G, hd), generator=g, device="cuda").to(dtype)
            k = torch.randn((1, S, K, hd), generator=g, device="cuda").to(dtype)
            v = torch.randn((1, S, K, hd), generator=g, device="cuda").to(dtype)
            scale = hd ** -0.5
            run = lambda: flash_attention(q, k, v, window=window, scale=scale,
                                          logit_cap=cap, causal=True)
            out = run()
            plain = lambda: flash_plain(q, k, v, window, scale=scale,
                                        logit_cap=cap)
            ref = plain()
            err, share = compare(
                out.reshape(1, S, H, hd), ref, dtype,
                f"flash_attention {dtype} S={S} window={window} cap={cap}")
            ms = time_ms(run)
            plain_ms = time_ms(plain, iters=3)
            pairs = S * (S + 1) // 2 if not window else sum(
                min(i + 1, window) for i in range(S))
            isz = q.element_size()
            nbytes = (2 * q.numel() + 2 * k.numel()) * isz
            flops = 4 * pairs * H * hd
            bms, by = bound(nbytes, flops, dtype)
            lib_ms = None
            qt, kt, vt = (q.reshape(1, S, H, hd).transpose(1, 2),
                          k.transpose(1, 2), v.transpose(1, 2))
            if not window and not cap:
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=scale,
                    enable_gqa=True))
            elif not cap and (dtype == torch.bfloat16
                              or S * S * H * 4 <= PLAIN_SCORE_BYTES):
                # a window and no softcap: the same function as SDPA with
                # a boolean mask of the causal band (no call applies a cap),
                # held to the plain version in fp32, timed in bf16
                mask = _window_mask(torch.arange(S, device="cuda"), S,
                                    window)
                lib = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
                _same_function(lib().transpose(1, 2), ref, dtype,
                               f"sdpa with the window mask, S={S} "
                               f"window={window}")
                if dtype == torch.bfloat16:
                    lib_ms = time_ms(lib)
            log(f"[flash_attention] {str(dtype)[6:]} B=1 S={S} H={H} K={K} "
                f"hd={hd} window={window} cap={cap}: max|err|={err:.3g} "
                f"({share:.3f} x {tol_str(dtype)}) | {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s of the function), plain "
                f"{plain_ms:.4f} ms, "
                f"bound {bms:.4f} ms ({by}), sdpa "
                + (f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a"))
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                   "shape": f"B=1 S={S} H={H} K={K} hd={hd} causal"
                            + (f" window {window}" if window else "")
                            + " bf16",
                   "tol": tol_str(dtype)}
            if dtype == torch.bfloat16 and S == 10000:
                extra["w8192"] = row              # llama4's own window
            elif dtype == torch.bfloat16 and S == 2048:
                if (H, hd, window) == (40, 128, 0):
                    main = row
                elif (H, hd, window) == (64, 128, 0):
                    extra["h64"] = row            # qwen3-moe's heads
                elif (hd, window) == (256, 0):
                    extra["hd256"] = row
                elif (H, hd, window) == (40, 128, 512):
                    extra["w512"] = row           # llama4's kind of window
                elif (H, hd) == (25, 64):
                    extra["hymba"] = row
                elif (H, hd) == (56, 128):
                    extra["llava"] = row
    # qwen3-moe's heads, llama4's windows and gemma2/3's head dim: their
    # numbers ride along
    main.update(extra)
    return main


# K2 with a query offset, as a serving rank's query rows meet the gathered
# sequence (Sq, Sk, q_offset, H, K, hd, window, cap): hymba-1.5b's
# 25 q / 5 kv heads of 64 with its window of 1024, rank 1's 750 rows of
# phase 20's 1500-token prompt; qwen2.5-32b's 40 / 8 heads of 128, rank 2
# of 3 on 1000 tokens padded to 1002; gemma2-9b's 16 / 8 of 256 with a
# window of 512 and the softcap of 50.  No offset is a multiple of the
# tiles' rows (64 on the tensor-core route, 32 on the CUDA-core route)
FLASH_OFFSET_CASES = [(750, 1500, 750, 25, 5, 64, 1024, 0.0),
                      (334, 1002, 668, 40, 8, 128, 0, 0.0),
                      (1000, 2048, 1037, 16, 8, 256, 512, 50.0)]


def check_flash_offset() -> dict:
    """K2 at a query offset against its plain version (``q_offset`` of
    ``flash_attention_ref``), in bf16 and fp32, timed beside the offset-0
    call over the whole sequence (the one-device prefill, whose last Sq
    rows these are).  Returns the bf16 rows by case: ``offset`` (hymba's)
    and ``offset_hd128`` / ``offset_hd256``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    out_rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for Sq, Sk, off, H, K, hd, window, cap in FLASH_OFFSET_CASES:
            g = torch.Generator("cuda").manual_seed(Sq + off + hd)
            G = H // K
            q = torch.randn((1, Sk, K, G, hd), generator=g,
                            device="cuda").to(dtype)
            k = torch.randn((1, Sk, K, hd), generator=g, device="cuda").to(dtype)
            v = torch.randn((1, Sk, K, hd), generator=g, device="cuda").to(dtype)
            qo = q[:, off:off + Sq].contiguous()
            scale = hd ** -0.5
            kw = dict(window=window, scale=scale, logit_cap=cap, causal=True)
            run = lambda: flash_attention(qo, k, v, q_offset=off, **kw)
            full = lambda: flash_attention(q, k, v, **kw)
            plain = lambda: flash_attention_ref(
                qo.reshape(1, Sq, H, hd), k, v, window, scale=scale,
                logit_cap=cap, causal=True, q_offset=off)
            out = run()
            what = (f"flash_attention {str(dtype)[6:]} Sq={Sq} Sk={Sk} "
                    f"q_offset={off} H={H} K={K} hd={hd} window={window} "
                    f"cap={cap}")
            if out.shape != qo.shape:
                raise AssertionError(f"{what}: shape {tuple(out.shape)}")
            err, share = compare(out.reshape(1, Sq, H, hd), plain(), dtype,
                                 what)
            # the offset rows of the whole call are the same function
            whole = full()[:, off:off + Sq]
            err_whole, _ = compare(out, whole, dtype, what + " vs offset 0")
            ms = time_ms(run)
            full_ms = time_ms(full)
            plain_ms = time_ms(plain, iters=3)
            pairs = sum(min(i + 1, window) if window else i + 1
                        for i in range(off, off + Sq))
            # the K/V rows some query sees: from the first one's window
            # start to the last one's position
            lo = max(0, off - window + 1) if window else 0
            seen = min(off + Sq, Sk) - lo
            isz = q.element_size()
            nbytes = (2 * qo.numel() + 2 * seen * K * hd) * isz
            flops = 4 * pairs * H * hd
            bms, by = bound(nbytes, flops, dtype)
            lib_ms = None
            if not cap:
                # SDPA's causal mask is top-left aligned: an explicit mask
                # (of the causal band, with a window)
                mask = _window_mask(torch.arange(off, off + Sq,
                                                 device="cuda"), Sk, window)
                qt, kt, vt = (qo.reshape(1, Sq, H, hd).transpose(1, 2),
                              k.transpose(1, 2), v.transpose(1, 2))
                lib = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
                _same_function(lib().transpose(1, 2),
                               plain().reshape(1, Sq, H, hd), dtype,
                               f"sdpa with the mask, {what}")
                lib_ms = time_ms(lib)
            log(f"[flash-offset] {what}: max|err|={err:.3g} "
                f"({share:.3f} x {tol_str(dtype)}), against the offset-0 "
                f"call's rows {err_whole:.3g} | {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s of the function), the "
                f"offset-0 call over all {Sk} rows {full_ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), sdpa "
                + (f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a"))
            if dtype == torch.bfloat16:
                key = "offset" if hd == 64 else f"offset_hd{hd}"
                out_rows[key] = {
                    "max_abs_err": err, "ms": ms, "offset0_ms": full_ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_ms,
                    "shape": f"B=1 Sq={Sq} Sk={Sk} q_offset={off} H={H} "
                             f"K={K} hd={hd} causal"
                             + (f" window {window}" if window else "")
                             + (f" cap {cap:g}" if cap else "") + " bf16",
                    "tol": tol_str(dtype)}
    return out_rows


# the reduced configs' head dims under the kernels' smallest instance, which
# the bindings zero-pad up to 64: (K, G) of qwen2.5-32b-smoke (1, 5) and of
# starcoder2-7b-smoke (2, 3)
SMALL_HD_PAGED = [(1, 5, 16), (1, 5, 8), (2, 3, 12), (2, 3, 16)]
# (S, H, K, hd, window, cap): ragged lengths, gemma2-smoke's window 8 and
# softcap 50
SMALL_HD_FLASH = [(300, 5, 1, 16, 0, 0.0), (257, 10, 2, 8, 64, 50.0),
                  (200, 6, 2, 12, 0, 30.0), (130, 4, 2, 16, 8, 50.0)]


def check_small_head_dims() -> None:
    """K1 and K2 at head dims 8, 12 and 16 (zero-padded to the 64-wide
    instance and sliced back by the bindings) against their plain versions
    at the real head dim, in bf16 and fp32."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    for dtype in (torch.bfloat16, torch.float32):
        for K, G, hd in SMALL_HD_PAGED:
            q, kp, vp, table, lens = _paged_case(4, K, G, hd, 16, dtype,
                                                 seed=hd + G)
            scale = hd ** -0.5
            out = paged_attention(q, kp, vp, table, lens, scale=scale)
            ref = paged_attention_ref(q, kp, vp, table, lens, scale=scale)
            what = (f"paged_attention {str(dtype)[6:]} B=4 K={K} G={G} "
                    f"hd={hd}")
            if out.shape != q.shape:
                raise AssertionError(f"{what}: shape {tuple(out.shape)}")
            err, share = compare(out, ref, dtype, what)
            if not torch.equal(out[1], torch.zeros_like(out[1])):
                raise AssertionError(f"{what}: dead row is not 0")
            log(f"[small-hd] {what} (padded to 64): max|err|={err:.3g} "
                f"({share:.3f} x {tol_str(dtype)}), dead row 0")
        for S, H, K, hd, window, cap in SMALL_HD_FLASH:
            g = torch.Generator("cuda").manual_seed(S + hd)
            G = H // K
            q = torch.randn((1, S, K, G, hd), generator=g,
                            device="cuda").to(dtype)
            k = torch.randn((1, S, K, hd), generator=g, device="cuda").to(dtype)
            v = torch.randn((1, S, K, hd), generator=g, device="cuda").to(dtype)
            scale = hd ** -0.5
            out = flash_attention(q, k, v, window=window, scale=scale,
                                  logit_cap=cap, causal=True)
            ref = flash_attention_ref(q.reshape(1, S, H, hd), k, v, window,
                                      scale=scale, logit_cap=cap, causal=True)
            what = (f"flash_attention {str(dtype)[6:]} S={S} H={H} K={K} "
                    f"hd={hd} window={window} cap={cap}")
            if out.shape != q.shape:
                raise AssertionError(f"{what}: shape {tuple(out.shape)}")
            err, share = compare(out.reshape(1, S, H, hd), ref, dtype, what)
            log(f"[small-hd] {what} (padded to 64): max|err|={err:.3g} "
                f"({share:.3f} x {tol_str(dtype)})")


# qwen3-moe-235b's attention (64 q / 4 kv heads of 128), global, and
# llama4-scout's heads (40 q / 8 kv of 128) on the head-dim-128 route with
# a window of 512 at 2048 tokens and with its own window of 8192 at the
# 10000 tokens phase 10 serves (tiles skipped below the window)
FLASH_MOE_CASES = [(2048, 64, 4, 128, 0, 0.0), (2048, 40, 8, 128, 512, 0.0),
                   (10000, 40, 8, 128, 8192, 0.0)]
# the plain version's score matrix is formed one kv head at a time past
# this many bytes (40 heads at 10000 tokens take 16 GB in fp32)
PLAIN_SCORE_BYTES = 2 ** 32


def flash_plain(q, k, v, window, *, scale, logit_cap):
    """``flash_attention_ref`` on q (1, S, K, G, hd), causal, one kv head
    at a time where the whole score matrix would pass
    ``PLAIN_SCORE_BYTES``: (1, S, K·G, hd)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, S, K, G, hd = q.shape
    run = lambda q, k, v: flash_attention_ref(
        q.reshape(B, S, -1, hd), k, v, window, scale=scale,
        logit_cap=logit_cap, causal=True)
    if B * S * S * K * G * 4 <= PLAIN_SCORE_BYTES:
        return run(q, k, v)
    return torch.cat([run(q[:, :, h], k[:, :, h:h + 1], v[:, :, h:h + 1])
                      for h in range(K)], dim=2)
# gemma2-9b's attention (16 q / 8 kv heads of 256): global, and its window
# of 4096 with the softcap of 50, at 2048 tokens, at 6000 (where the window
# bites) and at 512 with a short window
FLASH_HD256_CASES = [(2048, 16, 8, 256, 0, 0.0), (2048, 16, 8, 256, 4096, 50.0),
                     (6000, 16, 8, 256, 4096, 50.0),
                     (512, 16, 8, 256, 128, 50.0)]
# hymba-1.5b's attention (25 q / 5 kv heads of 64) with its window of 1024,
# and llava-next-34b's (56 q / 8 kv heads of 128), global
FLASH_SLICE_CASES = [(2048, 25, 5, 64, 1024, 0.0), (2048, 56, 8, 128, 0, 0.0)]


def wkv6_decay(kind: str, shape, g) -> torch.Tensor:
    """fp32 decays w of ``shape`` (B, T, H, hd) on the card:

    * ``sigmoid``: w in (0.35, 0.95), the reference sweep's law;
    * ``law``: RWKV6's own, w = exp(-exp(dec)) with dec uniform over
      [-8, 5]: from w ~ 1 - 3e-4 down to w that underflows to exactly 0;
    * ``runs``: in each 64-token chunk, strong decays (dec ~ 5, w = 0) on
      its first (7 i) % 64 tokens, then weak ones (dec ~ -3.5, w ~ 0.95 to
      0.98) on the rest, so channel i turns from strong to weak at its own
      place in a chunk (channel 0 never decays strongly);
    * ``long``: w ~ 1 - 3e-4 (dec ~ -8) everywhere: a memory of thousands
      of tokens, carried from chunk to chunk (see ``wkv6_long_memory``).
    """
    if kind == "sigmoid":
        return torch.sigmoid(torch.randn(shape, generator=g, device="cuda")) \
            * 0.6 + 0.35
    jitter = torch.rand(shape, generator=g, device="cuda")
    if kind == "law":
        dec = jitter * 13.0 - 8.0
    elif kind == "long":
        dec = jitter - 8.5
    else:
        t = torch.arange(shape[1], device="cuda")[:, None] % 64
        edge = (torch.arange(shape[3], device="cuda") * 7)[None, :] % 64
        dec = torch.where(t < edge, 5.0, -3.5)[None, :, None, :] \
            + (jitter - 0.5)
    return torch.exp(-torch.exp(dec))


# (B, T, H, hd, decay): rwkv6-3b's prefills at 2048 and a ragged 300
# tokens, a batch of 4 and the 16-wide heads of the reduced config, and the
# 1024 and 512 of phase 6's first prompts, timed; then the decay hazards at
# ragged lengths and every head size, checked, and head sizes 8, 24, 48 and
# 96, which the binding pads to the next instance (w with ones), checked
WKV6_CASES = [(1, 2048, 40, 64, "sigmoid"), (1, 300, 40, 64, "sigmoid"),
              (4, 128, 40, 64, "sigmoid"), (2, 77, 4, 16, "sigmoid"),
              (1, 1024, 40, 64, "sigmoid"), (1, 512, 40, 64, "sigmoid")]
WKV6_DECAY_CASES = [
    (1, 2048, 40, 64, "law"), (1, 2048, 40, 64, "runs"),
    (1, 300, 40, 64, "law"), (4, 128, 40, 64, "runs"), (2, 77, 4, 16, "law"),
    (1, 1, 4, 64, "law"), (2, 17, 4, 16, "runs"), (1, 65, 8, 32, "runs"),
    (1, 63, 8, 32, "law"), (1, 200, 8, 128, "law"),
    (1, 200, 8, 128, "runs"), (1, 2048, 40, 64, "long"),
    (2, 300, 4, 16, "long"), (2, 300, 4, 8, "law"), (2, 77, 4, 24, "runs"),
    (1, 200, 8, 48, "law"), (1, 200, 8, 96, "runs")]
WKV6_DECAYS = ["sigmoid", "law", "runs", "long"]
WKV6_ROUTES = {torch.bfloat16: "chunked, tensor cores (wkv6_chunk_state, "
                               "wkv6_chunk_scan, wkv6_chunk_out)",
               torch.float32: "exact per-token (wkv6_kernel)"}


def wkv6_fp64(r, k, v, w, u, s0):
    """The per-token recurrence in float64: (state, y), both float64."""
    r, k, v, w = (x.double() for x in (r, k, v, w))
    u, S = u.double()[None, :, :, None], s0.double()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], S + u * kv))
        S = S * w[:, t, :, :, None] + kv
    return S, torch.stack(ys, dim=1)


def wkv6_long_memory(what, out, plain, exact) -> str:
    """A memory of thousands of tokens (w ~ 1 - 3e-4, |y| in the hundreds):
    the kernel and the plain version against the float64 recurrence (y
    rounded to the output dtype once, the state to fp32).  Logged, not
    held: on the outputs that cancel towards 0 every fp32 order of
    evaluation, the plain version's included, lies ~5e-5 from the fp64
    value, 5 x the atol of ``TOL``."""
    (state, y), (p_state, p_y), (x_state, x_y) = out, plain, exact
    x_y, x_state = x_y.to(y.dtype), x_state.float()
    shares = {"y": _share(y, x_y, y.dtype),
              "state": _share(state, x_state, torch.float32),
              "plain y": _share(p_y, x_y, y.dtype),
              "plain state": _share(p_state, x_state, torch.float32)}
    return (f"[wkv6] {what[5:]}: against the fp64 recurrence, not held, "
            f"shares of {tol_str(y.dtype)} (state "
            f"{tol_str(torch.float32)}): "
            + ", ".join(f"{name} {v:.3f}" for name, v in shares.items()))


def check_wkv6() -> dict:
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    main = None
    for dtype in (torch.bfloat16, torch.float32):
        log(f"[wkv6] {str(dtype)[6:]} route: {WKV6_ROUTES[dtype]}")
        for B, T, H, hd, decay in WKV6_CASES + WKV6_DECAY_CASES:
            g = torch.Generator("cuda").manual_seed(
                B * T + hd + 1000 * WKV6_DECAYS.index(decay))
            n = lambda *shape: torch.randn(shape, generator=g, device="cuda")
            r = n(B, T, H, hd).to(dtype)
            k = (n(B, T, H, hd) * 0.3).to(dtype)
            v = n(B, T, H, hd).to(dtype)
            w = wkv6_decay(decay, (B, T, H, hd), g)
            u = n(H, hd) * 0.2
            s0 = n(B, H, hd, hd) * 0.1
            run = lambda: wkv6(r, k, v, w, u, s0)
            state, y = run()
            what = f"wkv6 {dtype} B={B} T={T} H={H} hd={hd} decay {decay}"
            if decay == "long":
                log(wkv6_long_memory(what, (state, y),
                                     wkv6_ref(r, k, v, w, u, s0),
                                     wkv6_fp64(r, k, v, w, u, s0)))
                continue
            ref_state, ref_y = wkv6_ref(r, k, v, w, u, s0)
            err, share = compare(y, ref_y, dtype, what + " y")
            s_err, s_share = compare(state, ref_state, torch.float32,
                                     what + " state")
            checked = (f"[wkv6] {str(dtype)[6:]} B={B} T={T} H={H} hd={hd} "
                       f"decay {decay}: y max|err|={err:.3g} ({share:.3f} x "
                       f"{tol_str(dtype)}), state max|err|={s_err:.3g} "
                       f"({s_share:.3f} x {tol_str(torch.float32)})")
            if decay != "sigmoid":               # checked, not timed
                log(checked)
                continue
            ms = time_ms(run)
            plain_ms = time_ms(lambda: wkv6_ref(r, k, v, w, u, s0), iters=2,
                               warmup=1)
            isz = r.element_size()
            N = B * T * H * hd
            nbytes = (4 * N * isz + N * 4 + u.numel() * 4
                      + 2 * s0.numel() * 4)          # r,k,v,y; w; u; states
            # two fp32 FMAs per state element per token, on CUDA cores
            flops = 4 * B * T * H * hd * hd
            bms, by = bound(nbytes, flops, torch.float32)
            log(f"{checked} | {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by})")
            if dtype == torch.bfloat16 and T == 2048:
                main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": by,
                        "shape": f"B={B} T={T} H={H} hd={hd} bf16 r/k/v",
                        "tol": f"y {tol_str(dtype)}; state "
                               f"{tol_str(torch.float32)}"}
    log("[wkv6] library: no single PyTorch call computes the WKV6 "
        "recurrence -> library_ms null")
    main["library_ms"] = None
    return main


def check_segment_zero() -> dict:
    from repro_torch.kernels.segment_zero.ops import segment_zero
    from repro_torch.kernels.segment_zero.ref import segment_zero_ref

    N = 2 ** 26 + 777
    ranges = [(N // 3 + 1, 2 * N // 3 + 5), (0, 4099), (N - 1001, N),
              (777, 777), (-5, 3)]                  # middle, ends, empty
    bits = {torch.float32: torch.int32, torch.int32: torch.int32,
            torch.bfloat16: torch.int16}
    main = None
    g = torch.Generator("cuda").manual_seed(26)
    for dtype in (torch.float32, torch.int32, torch.bfloat16):
        if dtype == torch.int32:
            x = torch.randint(-2 ** 31, 2 ** 31 - 1, (N,), generator=g,
                              device="cuda", dtype=torch.int32)
        else:
            x = torch.randn((N,), generator=g, device="cuda").to(dtype)
        # a view 4 or 2 bytes past a 16-byte boundary: the scalar path
        cases = [(x, lo, hi) for lo, hi in ranges] + [(x[1:10008], 100, 9000)]
        for xs, lo, hi in cases:
            out = segment_zero(xs, lo, hi)
            ref = segment_zero_ref(xs, lo, hi)
            if not torch.equal(out.view(bits[dtype]), ref.view(bits[dtype])):
                raise AssertionError(
                    f"segment_zero {dtype} N={xs.numel()} [{lo}, {hi}): not "
                    "bitwise equal to the plain version")
        lo, hi = ranges[0]
        run = lambda: segment_zero(x, lo, hi)
        ms = time_ms(run)
        plain_ms = time_ms(lambda: segment_zero_ref(x, lo, hi), iters=5)
        # no single PyTorch call returns a new buffer with [lo, hi)
        # zeroed, so K4 has no library time; logged beside it, the
        # in-place zeroing of the segment (a narrow is a view), which
        # writes only the segment where K4 writes a new buffer of all N
        lib = x.clone()
        lib.narrow(0, lo, hi - lo).zero_()
        if not torch.equal(lib.view(bits[dtype]),
                           segment_zero(x, lo, hi).view(bits[dtype])):
            raise AssertionError(f"segment_zero {dtype}: narrow().zero_() "
                                 "disagrees with the kernel")
        lib_ms = time_ms(lambda: lib.narrow(0, lo, hi - lo).zero_())
        # reads the elements outside [lo, hi) once, writes all N once
        nbytes = (2 * N - (hi - lo)) * x.element_size()
        bms, by = bound(nbytes, 0, torch.float32)
        log(f"[segment_zero] {str(dtype)[6:]} N={N}: bitwise equal over "
            f"{len(cases)} ranges (middle, both ends, empty, out of range, "
            f"unaligned) | middle third: {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bms:.4f} ms ({by}), x.narrow(0, lo, hi - lo)"
            f".zero_() in place {lib_ms:.4f} ms")
        if dtype == torch.float32:
            main = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by, "library_ms": None,
                    "inplace_zero_ms": lib_ms,
                    "shape": f"N={N} float32, zero [{lo}, {hi})",
                    "tol": "bitwise"}
        del lib
    return main


# --------------------------------------------------------------- phase 4

#: phase 4's prompt lengths (the last shares the first's 512-token prefix)
SERVE_LENGTHS = [2048, 1000, 513, 300, 128, 64, 17, 1500]


def _serving_requests(vocab: int, lengths, seed: int = 0):
    """32 new tokens each; even requests greedy, odd ones temperature 0.8
    with top-k 50."""
    from repro_torch.runtime import Request

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]
    return [
        Request(prompt=p, max_new_tokens=32, request_id=i, seed=100 + i,
                temperature=0.0 if i % 2 == 0 else 0.8,
                top_k=0 if i % 2 == 0 else 50)
        for i, p in enumerate(prompts)
    ]


def _warm_up(engine) -> dict:
    """One request first: cuBLAS handles and matmul heuristics are set up on
    first use, which would otherwise land in the first requests' TTFT.
    Returns the engine's (cumulative) counters after it."""
    from repro_torch.runtime import Request

    engine.submit(Request(prompt=np.arange(64, dtype=np.int32),
                          max_new_tokens=2, request_id=99))
    engine.drain()
    engine.flush_prefix_cache()
    engine.reset_history()
    return engine.serving_stats()


def _drive(engine, reqs) -> dict:
    """Submit ``reqs`` and step until done: wall seconds, TTFT per request
    (from submit, host clock) and the host time and tokens of every step
    that ran no prefill."""
    t_submit = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    ttft = {}
    decode_steps_ms = []
    retire_steps_ms = []
    decode_tokens = 0
    while engine.has_work():
        before = sum(engine.prefill_counts().values())
        n_tok = sum(len(r.tokens) for r in reqs)
        t = time.perf_counter()
        retired = engine.step()
        dt = time.perf_counter() - t
        now = time.perf_counter()
        for r in reqs:
            if r.tokens and r.request_id not in ttft:
                ttft[r.request_id] = now - t_submit
        if retired:
            retire_steps_ms.append(dt * 1e3)
        if sum(engine.prefill_counts().values()) == before:
            decode_steps_ms.append(dt * 1e3)
            decode_tokens += sum(len(r.tokens) for r in reqs) - n_tok
    return {"wall": time.perf_counter() - t_submit,
            "ttft": sorted(ttft.values()), "steps_ms": decode_steps_ms,
            "tokens": decode_tokens, "retire_ms": retire_steps_ms}


def _check_outputs(reqs, vocab: int) -> None:
    for r in reqs:
        if r.error or len(r.tokens) != 32 or not all(
                0 <= t < vocab for t in r.tokens):
            raise AssertionError(
                f"request {r.request_id}: error={r.error} tokens={r.tokens}")


def _check_ledgers(engine, stats) -> None:
    if stats["kv_pages_allocated_total"] != stats["kv_pages_freed_total"]:
        raise AssertionError(f"page leak: {stats}")
    if engine.admission.slot_balance():
        raise AssertionError(f"slot leak: {engine.admission.slot_balance()}")


def _log_timings(tag: str, run: dict, peak: int, note: str) -> None:
    steps_ms, ttfts = run["steps_ms"], run["ttft"]
    decode_s = sum(steps_ms) / 1e3
    log(f"[{tag}] wall {run['wall']:.3f}s, decode {run['tokens']} tokens in "
        f"{decode_s:.3f}s = {run['tokens'] / decode_s:.1f} tokens/s over "
        f"{len(steps_ms)} decode-only steps (step p50 "
        f"{float(np.median(steps_ms)):.2f} ms, max "
        f"{max(steps_ms):.2f} ms), TTFT p50 "
        f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms, TTFT all ms "
        f"{[round(t * 1e3, 1) for t in ttfts]}, peak memory "
        f"{peak / 2**30:.2f} GiB{note}")


def _launch_counters():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.segment_zero import ops as sz_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops

    return {"paged_attention": pa_ops.paged_attention,
            "flash_attention": fa_ops.flash_attention,
            "wkv6": wkv_ops.wkv6, "segment_zero": sz_ops.segment_zero}


def _drive_counted(engine, reqs) -> tuple:
    """``_drive`` with every kernel's launch count set to 0 just before and
    read just after, and the peak device memory of the run."""
    counters = _launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    run = _drive(engine, reqs)
    launches = {name: fn.launches for name, fn in counters.items()}
    return run, launches, torch.cuda.max_memory_allocated()


def _model_on_card(cfg, tag: str, note: str):
    """``cfg``'s model on the card with random weights (seed 0), logged."""
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.parameters())
    n_bytes = sum(t.numel() * t.element_size() for t in model.parameters())
    log(f"[{tag}] {cfg.arch_id} d_model={cfg.d_model} H={cfg.num_heads} "
        f"K={cfg.num_kv_heads} hd={cfg.hd} vocab={cfg.vocab_size} "
        f"layers={cfg.num_layers}{note} {cfg.dtype}: {n_params / 1e9:.2f}B "
        f"params, {n_bytes / 1e9:.2f} GB, init "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    return model


def _serve_paged(model, cfg, tag: str, note: str, during=None) -> tuple:
    """Phase 4's run on ``model``: 8 requests (the 1500-token one sharing
    the 2048-token one's first 512 tokens through a parked prefix donor)
    in paged mode, after a warm-up request, under the context ``during``;
    holds the outputs, the ledgers and the launch counts (K1 = decode
    steps x layers, K2 = full prefills x layers, K3 = K4 = 0).  Returns
    (engine, launches)."""
    from repro_torch.runtime import ServerConfig, ServingEngine

    engine = ServingEngine(model, ServerConfig(
        max_batch=4, max_seq=4096, prefix_cache_seqs=4))
    if engine.kv_mode != "paged":
        raise AssertionError(f"{cfg.arch_id} served in {engine.kv_mode} "
                             "mode, not paged")
    reqs = _serving_requests(cfg.vocab_size, SERVE_LENGTHS)
    reqs[7].prompt[:512] = reqs[0].prompt[:512]   # a shared 512-token prefix
    base = _warm_up(engine)
    with during or contextlib.nullcontext():
        run, launches, peak = _drive_counted(engine, reqs)
    paged_n = launches["paged_attention"]
    flash_n = launches["flash_attention"]
    stats = engine.serving_stats()
    engine.flush_prefix_cache()
    stats_after = engine.serving_stats()

    _check_outputs(reqs, cfg.vocab_size)
    steps = stats["decode_steps_total"] - base["decode_steps_total"]
    shared = stats["prefix_hits_total"] - base["prefix_hits_total"]
    full_prefills = (stats["prefill_sequences_total"]["incremental"]
                     - base["prefill_sequences_total"]["incremental"] - shared)
    saved = (stats["prefix_prefill_tokens_saved_total"]
             - base["prefix_prefill_tokens_saved_total"])
    _check_ledgers(engine, stats_after)
    if paged_n != steps * cfg.num_layers:
        raise AssertionError(
            f"paged_attention launches {paged_n} != {steps} steps x "
            f"{cfg.num_layers} layers")
    if flash_n != full_prefills * cfg.num_layers:
        raise AssertionError(
            f"flash_attention launches {flash_n} != {full_prefills} full "
            f"prefills x {cfg.num_layers} layers")
    if launches["wkv6"] or launches["segment_zero"]:
        raise AssertionError(f"the paged path launched {launches}")
    if shared < 1:
        raise AssertionError("the shared 512-token prefix was not shared")
    pages = {k: stats_after[k] - base[k] for k in
             ("kv_pages_allocated_total", "kv_pages_freed_total")}
    log(f"[{tag}] 8 requests done, no error, kv_mode paged: decode steps "
        f"{steps}, full prefills {full_prefills}, prefix hits {shared} "
        f"({saved} tokens saved), "
        f"pages allocated {pages['kv_pages_allocated_total']} == freed "
        f"{pages['kv_pages_freed_total']} (the warm-up request's excluded)")
    log(f"[{tag}] launches: paged_attention {paged_n} = {steps} x "
        f"{cfg.num_layers} (G={cfg.num_heads // cfg.num_kv_heads}), "
        f"flash_attention {flash_n} = {full_prefills} x {cfg.num_layers}, "
        f"wkv6 0, segment_zero 0")
    _log_timings(tag, run, peak, note)
    return engine, launches


def _serve_dense(model, cfg, tag: str, kernel: str, max_seq: int, lengths,
                 note: str) -> tuple:
    """8 requests of ``lengths`` on ``model`` in dense mode after a
    warm-up request; holds the outputs, the ledgers and the launch counts
    (``kernel`` = full prefills x layers, every other kernel 0).  Returns
    (engine, launches)."""
    from repro_torch.runtime import ServerConfig, ServingEngine

    engine = ServingEngine(model, ServerConfig(max_batch=4, max_seq=max_seq))
    if engine.kv_mode != "dense":
        raise AssertionError(f"{cfg.arch_id} served in {engine.kv_mode} "
                             "mode, not dense")
    state = sum(t.numel() * t.element_size() for t in engine._state.values())
    log(f"[{tag}] kv_mode dense, decode state (max_batch 4, max_seq "
        f"{max_seq}) {state / 1e9:.2f} GB")
    reqs = _serving_requests(cfg.vocab_size, lengths)
    base = _warm_up(engine)
    run, launches, peak = _drive_counted(engine, reqs)
    stats = engine.serving_stats()

    _check_outputs(reqs, cfg.vocab_size)
    steps = stats["decode_steps_total"] - base["decode_steps_total"]
    full_prefills = (stats["prefill_sequences_total"]["incremental"]
                     - base["prefill_sequences_total"]["incremental"])
    pages = {k: stats[k] - base[k] for k in
             ("kv_pages_allocated_total", "kv_pages_freed_total")}
    _check_ledgers(engine, stats)
    want = dict.fromkeys(launches, 0)
    want[kernel] = full_prefills * cfg.num_layers
    if launches != want:
        raise AssertionError(
            f"the dense path launched {launches}, not {want} ({full_prefills}"
            f" full prefills x {cfg.num_layers} layers of {kernel})")
    log(f"[{tag}] 8 requests done, no error, kv_mode dense: decode steps "
        f"{steps}, full prefills {full_prefills}, pages allocated "
        f"{pages['kv_pages_allocated_total']} == freed "
        f"{pages['kv_pages_freed_total']} (the warm-up request's excluded)")
    log(f"[{tag}] launches: {kernel} {launches[kernel]} = {full_prefills} x "
        f"{cfg.num_layers}, " + ", ".join(
            f"{name} 0" for name in launches if name != kernel))
    _log_timings(tag, run, peak, note)
    return engine, launches


def phase_serving() -> dict:
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen2.5-32b"),
                              num_layers=SERVE_LAYERS)
    model = _model_on_card(cfg, "serve", " (of 64)")
    engine, launches = _serve_paged(model, cfg, "serve",
                                    f" [{SERVE_LAYERS}-layer depth cut]")
    profile_decode(engine, cfg, "profile")
    return launches


def profile_decode(engine, cfg, tag: str) -> None:
    """Device busy share, kernel time by name and the host sampler's time
    over 4 decode steps of a full batch (2 greedy, 2 top-k 50 requests
    with 512-token prompts), from ``torch.profiler``; after the launch
    counts were read."""
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.runtime.serve_loop as serve_loop
    from repro_torch.runtime import Request

    rng = np.random.default_rng(7)
    for i in range(4):
        engine.submit(Request(
            prompt=rng.integers(0, cfg.vocab_size, (512,)).astype(np.int32),
            max_new_tokens=16, request_id=100 + i, seed=i,
            temperature=0.0 if i % 2 == 0 else 0.8,
            top_k=0 if i % 2 == 0 else 50))
    engine.step()                              # admission, prefill, 1 token
    engine.step()
    torch.cuda.synchronize()
    sampler = serve_loop.sample_token
    sampler_s = [0.0]

    def timed_sampler(*args, **kwargs):
        t = time.perf_counter()
        out = sampler(*args, **kwargs)
        sampler_s[0] += time.perf_counter() - t
        return out

    serve_loop.sample_token = timed_sampler
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                engine.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        serve_loop.sample_token = sampler
    engine.drain()
    engine.flush_prefix_cache()
    # device-side events only: a host op's device time repeats its kernels'
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.key, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0),
        reverse=True)
    sampler_ms = sampler_s[0] * 1e3
    log(f"[{tag}] 4 decode steps at batch 4 (seq ~520), profiler on: "
        f"wall {wall_ms:.2f} ms, host sampler {sampler_ms:.2f} ms "
        f"({100 * sampler_ms / wall_ms:.1f}% of wall)")
    if not rows:
        log(f"[{tag}] the profiler saw no device time: busy share not "
            "measured")
        return
    busy_ms = sum(r[0] for r in rows)
    log(f"[{tag}] device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of wall), idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%")
    for ms, key, count in rows[:8]:
        log(f"[{tag}]   {ms:9.3f} ms  x{count:<5d} {key[:90]}")


# --------------------------------------------------------------- phase 5


def phase_card_vs_cpu() -> None:
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.runtime import Request, ServerConfig, ServingEngine

    cfg = dataclasses.replace(get_reduced("qwen2.5-32b"), d_model=256,
                              num_heads=4, num_kv_heads=2, d_ff=512,
                              dtype="float32")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (40, 17, 70)]
    # first-step logits: prefill (flash) and one decode step (paged)
    toks = torch.from_numpy(prompts[2][None])
    rows_c, logit_c = cpu.paged_prefill(toks)
    rows_g, logit_g = gpu.paged_prefill(toks.cuda())
    err = (logit_g.cpu() - logit_c).abs().max().item()
    if not torch.allclose(logit_g.cpu(), logit_c, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"card vs CPU prefill logits: max|err| {err}")
    streams = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        eng = ServingEngine(model, ServerConfig(max_batch=2, max_seq=128))
        reqs = [Request(prompt=p, max_new_tokens=8, request_id=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        streams[name] = [r.tokens for r in reqs]
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"card vs CPU greedy streams differ: {streams}")
    log(f"[card-vs-cpu] width-256 fp32 ({cfg.num_layers} layers, hd "
        f"{cfg.hd}, K={cfg.num_kv_heads}): prefill logits max|err| {err:.3g} "
        f"(tol 1e-3), greedy streams equal: {streams['cuda']}")
    _card_vs_cpu_rwkv()
    _card_vs_cpu_gemma2()
    _card_vs_cpu_reduced()
    _card_vs_cpu_model_level()


# the reduced configs as the launcher's ``--reduced`` serves them, head dims
# under the kernels' smallest instance: (arch, engine mode)
REDUCED_ARMS = [("qwen2.5-32b", "paged"), ("gemma2-9b", "dense"),
                ("starcoder2-7b", "paged"), ("qwen3-moe-235b-a22b", "paged"),
                ("llama4-scout-17b-a16e", "dense"), ("hymba-1.5b", "dense"),
                ("llava-next-34b", "paged")]
# a logit margin the card and the CPU cannot swap: the 1e-3 their fp32
# logits are held to
CLEAR_MARGIN = 1e-3


def _row_margins(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's smallest gap between adjacent values of its k + 1
    largest router logits: how near its top-k choice, or the order within
    it, is to a tie."""
    top = torch.topk(logits.float(), min(k + 1, logits.shape[-1]),
                     dim=-1).values
    return (top[:, :-1] - top[:, 1:]).min(dim=-1).values


@contextlib.contextmanager
def _spy_routing(record):
    """``record(x, routing, cfg, lossless)`` after every ``moe.route`` call
    inside the block (the engine and the model call it through the
    module)."""
    import repro_torch.models.moe as moe

    real = moe.route

    def spy(x, router_w, cfg, *, lossless=False):
        r = real(x, router_w, cfg, lossless=lossless)
        record(x, r, cfg, lossless)
        return r

    moe.route = spy
    try:
        yield
    finally:
        moe.route = real


def _replay(model, prompt, tokens, fork: int) -> tuple:
    """Replays a greedy stream on ``model`` (prefill, then a decode step per
    token) up to its token ``fork``: every routing on the way as (router
    logits, top_idx) on the CPU, and the logits at the fork."""
    routings = []
    dev = model.device
    record = lambda x, r, cfg, lossless: routings.append(
        (r.logits.float().cpu(), r.top_idx.cpu()))
    with _spy_routing(record):
        state, logits = model.prefill(
            torch.from_numpy(prompt[None]).to(dev),
            max_seq=len(prompt) + fork + 1)
        for t in tokens[:fork]:
            state, logits = model.decode_step(
                state, torch.tensor([t], dtype=torch.int32, device=dev))
    return routings, logits[0].float().cpu()


def _fork_margins(cpu, gpu, cfg, prompt, tokens, fork: int) -> tuple:
    """Replays the common prefix of a forked greedy stream on the CPU and
    on the card: (the routing rows whose top-k differ between them, the
    largest CPU router margin over those rows or None, the CPU's top-2
    logit margin at the fork)."""
    k = cfg.experts_per_token
    cpu_routes, logits = _replay(cpu, prompt, tokens, fork)
    gpu_routes, _ = _replay(gpu, prompt, tokens, fork)
    if len(cpu_routes) != len(gpu_routes):
        raise AssertionError(f"{cfg.arch_id}: {len(cpu_routes)} routings on "
                             f"the CPU, {len(gpu_routes)} on the card")
    rows, margins = 0, []
    for (lc, ic), (_, ig) in zip(cpu_routes, gpu_routes):
        differ = (ic != ig).any(dim=-1)
        if differ.any():
            rows += int(differ.sum())
            margins.append(_row_margins(lc[differ], k).max().item())
    top2 = torch.topk(logits, 2).values
    return rows, max(margins) if margins else None, (top2[0] - top2[1]).item()


def _card_vs_cpu_reduced() -> None:
    """qwen2.5-32b-smoke (paged: K1 and K2 at head dim 16, 5 q heads over
    1), gemma2-9b-smoke (dense: K2 at head dim 16 with its window of 8 and
    softcap of 50), starcoder2-7b-smoke (paged: K1 and K2 at head dim 12,
    3 q heads over each of 2), qwen3-moe-smoke (paged, 8 experts, top-2)
    and llama4-scout-smoke (dense, 4 experts, sigmoid top-1, a shared
    expert, window 16) at their own widths, fp32: greedy streams of prompts
    past the window equal on the card (through the bindings' zero-pad to
    the 64-wide instances) and on the CPU, or forking only at a near tie
    of the MoE routing or the logits (``_judge_fork``), and the card's
    launches counted."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.runtime import Request, ServerConfig, ServingEngine

    counters = _launch_counters()
    for arch, mode in REDUCED_ARMS:
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        cpu = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(4))
        gpu = build_model(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(12)
        prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
                   for n in (5, 23, 40, 11)]
        streams = {}
        for name, model in (("cpu", cpu), ("cuda", gpu)):
            eng = ServingEngine(model, ServerConfig(max_batch=2, max_seq=64))
            if eng.kv_mode != mode:
                raise AssertionError(f"{arch} served in {eng.kv_mode} mode")
            reqs = [Request(prompt=p, max_new_tokens=8, request_id=i)
                    for i, p in enumerate(prompts)]
            for fn in counters.values():
                fn.launches = 0
            for r in reqs:
                eng.submit(r)
            eng.drain()
            launches = {n: fn.launches for n, fn in counters.items()}  # card's last
            if any(r.error for r in reqs):
                raise AssertionError(f"{arch} on {name}: "
                                     f"{[r.error for r in reqs]}")
            streams[name] = [r.tokens for r in reqs]
        want_paged = mode == "paged"
        if not launches["flash_attention"] or \
                bool(launches["paged_attention"]) != want_paged:
            raise AssertionError(f"{arch} on the card launched {launches}")
        equal = streams["cpu"] == streams["cuda"]
        if not equal:
            _judge_fork(cpu, gpu, cfg, prompts, streams)
        log(f"[card-vs-cpu] {cfg.arch_id} fp32 at its own widths "
            f"({cfg.num_layers} layers, hd {cfg.hd}, H={cfg.num_heads} "
            f"K={cfg.num_kv_heads}, window {cfg.local_window}, softcap "
            f"{cfg.attn_logit_softcap}), {mode} mode: greedy streams "
            + ("equal " if equal else "fork at near ties only, card ")
            + f"{streams['cuda']}; card launches flash_attention "
            f"{launches['flash_attention']}, paged_attention "
            f"{launches['paged_attention']}")


def greedy_stream(model, tokens, n: int, **inputs) -> tuple:
    """The model-level API as the reference runs it: ``prefill`` of
    ``tokens`` (B, S) with ``inputs`` (patch embeddings, frames) into a
    cache of S + n, then greedy ``decode_step``s to n tokens.  Returns (the
    tokens (B, n), the logits each was chosen from (B, n, V) in fp32, both
    on the CPU, and the host ms of each decode step, the card
    synchronised)."""
    dev = model.device
    state, logits = model.prefill(
        tokens.to(dev), max_seq=tokens.shape[1] + n,
        **{k: v.to(dev) for k, v in inputs.items()})
    out, rows, steps_ms = [], [], []
    for i in range(n):
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok.cpu())
        rows.append(logits.float().cpu())
        if i == n - 1:
            break
        t = time.perf_counter()
        state, logits = model.decode_step(state, tok)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t) * 1e3)
    return torch.stack(out, dim=1), torch.stack(rows, dim=1), steps_ms


def _card_vs_cpu_model_level() -> None:
    """The modality inputs, through the model-level API as the reference
    runs them (its engine passes none): llava-next-34b-smoke (K2 at head
    dim 8 through the zero-pad) with a 4-patch prefix and whisper-tiny-smoke
    with 16 encoder frames, fp32, greedy streams of the same inputs equal on
    the card and on the CPU; whisper launches no kernel."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model

    counters = _launch_counters()
    for arch, key in (("llava-next-34b", "patch_embeds"),
                      ("whisper-tiny", "frames")):
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        cpu = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(5))
        gpu = build_model(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(13)
        n_in = cfg.num_patches if key == "patch_embeds" else cfg.encoder_len
        inputs = {key: torch.from_numpy(rng.standard_normal(
            (2, n_in, cfg.d_model)).astype(np.float32))}
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 20 if key == "patch_embeds" else 4)
        ).astype(np.int32))
        c_stream, c_logits, _ = greedy_stream(cpu, tokens, 8, **inputs)
        for fn in counters.values():
            fn.launches = 0
        g_stream, g_logits, _ = greedy_stream(gpu, tokens, 8, **inputs)
        launches = {n: fn.launches for n, fn in counters.items()}
        g_first, c_first = g_logits[:, 0], c_logits[:, 0]
        err = (g_first - c_first).abs().max().item()
        if not torch.allclose(g_first, c_first, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"card vs CPU {arch} prefill logits: "
                                 f"max|err| {err}")
        if not torch.equal(c_stream, g_stream):
            raise AssertionError(f"card vs CPU {arch} greedy streams differ:"
                                 f" cpu {c_stream.tolist()}, card "
                                 f"{g_stream.tolist()}")
        want = dict.fromkeys(launches, 0)
        if key == "patch_embeds":
            want["flash_attention"] = cfg.num_layers   # the prefill's layers
        if launches != want:
            raise AssertionError(f"{arch} on the card launched {launches}, "
                                 f"not {want}")
        log(f"[card-vs-cpu] {cfg.arch_id} fp32 model-level, {key} "
            f"{tuple(inputs[key].shape)}: prefill logits max|err| {err:.3g} "
            f"(tol 1e-3), 8 greedy decode steps equal "
            f"{g_stream.tolist()}; card launches {launches}")


def _judge_fork(cpu, gpu, cfg, prompts, streams) -> None:
    """Card and CPU streams differ: raises unless the model routes experts
    and, replaying each forked stream up to its first diverging token on
    both, every routing row whose top-k differs between them has a CPU
    router margin below ``CLEAR_MARGIN``, or no row differs and the CPU's
    top-2 logit margin at the fork is below it (a near tie that fp32 sums
    in another order can swap, as ROADMAP's parity rule allows for float
    models); logs every fork."""
    clear = []
    for i, (a, b) in enumerate(zip(streams["cpu"], streams["cuda"])):
        fork = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        if fork is None:
            continue
        if not cfg.is_moe:
            clear.append(i)
            continue
        rows, router, top2 = _fork_margins(cpu, gpu, cfg, prompts[i], a,
                                           fork)
        log(f"[card-vs-cpu] {cfg.arch_id} request {i} forks at token "
            f"{fork} (cpu {a[fork]}, card {b[fork]}): {rows} routing rows "
            f"choose other experts on the card, largest CPU router margin "
            f"among them {router}, top-2 logit margin {top2:.3g} (near a "
            f"tie below {CLEAR_MARGIN})")
        near = router < CLEAR_MARGIN if router is not None else \
            top2 < CLEAR_MARGIN
        if not near:
            clear.append(i)
    if clear:
        raise AssertionError(
            f"card vs CPU {cfg.arch_id} greedy streams differ at clear "
            f"margins (requests {clear}): {streams}")


def _card_vs_cpu_gemma2() -> None:
    """A width-512 fp32 gemma2 (2 layers, 2 q / 1 kv heads of 256, window
    64, softcaps 50 and 30): prefill through K2 at head dim 256 on the card
    and its plain version on the CPU, then dense serving of ~200-token
    prompts (the window bites) on both, decode on the dense cache."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.runtime import Request, ServerConfig, ServingEngine

    cfg = dataclasses.replace(get_reduced("gemma2-9b"), num_layers=2,
                              d_model=512, num_heads=2, num_kv_heads=1,
                              head_dim=256, d_ff=1024, local_window=64,
                              query_scale=256 ** -0.5, dtype="float32")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (200, 150, 230)]
    toks = torch.from_numpy(prompts[0][None])
    state_c, logit_c = cpu.prefill(toks, max_seq=256)
    state_g, logit_g = gpu.prefill(toks.cuda(), max_seq=256)
    err = (logit_g.cpu() - logit_c).abs().max().item()
    if not torch.allclose(logit_g.cpu(), logit_c, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"card vs CPU gemma2 prefill logits: max|err| "
                             f"{err}")
    # decode over the dense cache past the window: each step's logits
    step_err = 0.0
    for _ in range(4):
        tok = logit_c.argmax(-1).to(torch.int32)
        state_c, logit_c = cpu.decode_step(state_c, tok)
        state_g, logit_g = gpu.decode_step(state_g, tok.cuda())
        step_err = max(step_err, (logit_g.cpu() - logit_c).abs().max().item())
        if not torch.allclose(logit_g.cpu(), logit_c, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"card vs CPU gemma2 decode logits: max|err| "
                                 f"{step_err}")
    streams = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        eng = ServingEngine(model, ServerConfig(max_batch=2, max_seq=256))
        if eng.kv_mode != "dense":
            raise AssertionError(f"gemma2 served in {eng.kv_mode} mode")
        reqs = [Request(prompt=p, max_new_tokens=8, request_id=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        streams[name] = [r.tokens for r in reqs]
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(
            f"card vs CPU gemma2 greedy streams differ: {streams}")
    log(f"[card-vs-cpu] gemma2 width-512 fp32 ({cfg.num_layers} layers, hd "
        f"{cfg.hd}, H={cfg.num_heads} K={cfg.num_kv_heads}, window "
        f"{cfg.local_window}, softcaps {cfg.attn_logit_softcap}/"
        f"{cfg.final_logit_softcap}): prefill logits max|err| {err:.3g}, "
        f"4 decode steps' logits max|err| {step_err:.3g} (tol 1e-3), greedy "
        f"streams equal (dense mode): {streams['cuda']}")


def _card_vs_cpu_rwkv() -> None:
    """A width-256 fp32 RWKV6 (2 layers, heads of 64): prefill through K3
    on the card and the plain scan on the CPU, then dense serving."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.runtime import Request, ServerConfig, ServingEngine

    cfg = dataclasses.replace(get_reduced("rwkv6-3b"), num_layers=2,
                              d_model=256, num_heads=4, num_kv_heads=4,
                              d_ff=896, rwkv_head_size=64, dtype="float32")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (40, 17, 70)]
    toks = torch.from_numpy(prompts[2][None])
    state_c, logit_c = cpu.prefill(toks)
    state_g, logit_g = gpu.prefill(toks.cuda())
    err = (logit_g.cpu() - logit_c).abs().max().item()
    s_err = (state_g["wkv"].cpu() - state_c["wkv"]).abs().max().item()
    if not torch.allclose(logit_g.cpu(), logit_c, rtol=1e-3, atol=1e-3) or \
            not torch.allclose(state_g["wkv"].cpu(), state_c["wkv"],
                               rtol=1e-3, atol=1e-3):
        raise AssertionError(
            f"card vs CPU RWKV prefill: logits max|err| {err}, wkv state "
            f"max|err| {s_err}")
    streams = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        eng = ServingEngine(model, ServerConfig(max_batch=2, max_seq=128))
        reqs = [Request(prompt=p, max_new_tokens=8, request_id=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        streams[name] = [r.tokens for r in reqs]
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(
            f"card vs CPU RWKV greedy streams differ: {streams}")
    log(f"[card-vs-cpu] rwkv width-256 fp32 ({cfg.num_layers} layers, head "
        f"size {cfg.rwkv_head_size}): prefill logits max|err| {err:.3g}, "
        f"wkv state max|err| {s_err:.3g} (tol 1e-3), greedy streams equal "
        f"(dense mode): {streams['cuda']}")


# --------------------------------------------------------------- phase 6


def phase_rwkv_serving() -> dict:
    from repro_torch.configs import get_config

    cfg = get_config("rwkv6-3b")
    model = _model_on_card(cfg, "rwkv", f" (all), head size "
                           f"{cfg.rwkv_head_size}")
    engine, launches = _serve_dense(
        model, cfg, "rwkv", "wkv6", 4096,
        [2048, 1024, 512, 300, 128, 64, 17, 1500], " [full depth]")
    profile_decode(engine, cfg, "rwkv-profile")
    profile_prefill(model, cfg, "rwkv-prefill", ("K3 (wkv6)", "wkv6"),
                    T=2048, max_seq=4096)
    return launches


# substrings of the names of cuBLAS's GEMM kernels on this card
GEMM_KERNEL_KEYS = ("gemm", "nvjet", "xmma", "cutlass")


def _is_gemm(name: str) -> bool:
    return any(x in name.lower() for x in GEMM_KERNEL_KEYS)


# steps of a model (functions of one of its modules, by name) whose kernels
# a prefill's breakdown reports apart, and the group each one's device time
# goes to: the MoE block's (``[moe-prefill]``) and the hybrid's SSM scan
# (``[hybrid-prefill]``)
MOE_STEPS = ("repro_torch.models.moe",
             {"route": "routing, dispatch, combine",
              "dispatch": "routing, dispatch, combine",
              "expert_ffn": "expert FFN",
              "combine": "routing, dispatch, combine"})
HYBRID_STEPS = ("repro_torch.models.hybrid", {"ssm_scan": "SSM scan"})


@contextlib.contextmanager
def _step_ranges(steps):
    """A ``record_function`` range ``<module>.<step>`` around every call of
    each of ``steps``' functions (which the model calls through their
    module), so the profiler can tell their kernels apart."""
    import importlib

    from torch.profiler import record_function

    module_name, groups = steps
    module = importlib.import_module(module_name)
    prefix = module_name.rsplit(".", 1)[-1]
    real = {name: getattr(module, name) for name in groups}

    def ranged(name, fn):
        def call(*args, **kwargs):
            with record_function(f"{prefix}.{name}"):
                return fn(*args, **kwargs)
        return call

    for name, fn in real.items():
        setattr(module, name, ranged(name, fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)


def _range_kernels(event) -> list:
    """(name, µs) of every kernel launched under a host event."""
    out = [(k.name, k.duration) for k in event.kernels]
    for child in event.cpu_children:
        out += _range_kernels(child)
    return out


def _step_kernels(prof, steps) -> list:
    """(group, kernel name, ms) of every kernel under the ``steps``'
    ranges; the MoE expert FFN's GEMMs (``expert GEMMs``) apart from its
    elementwise kernels."""
    module_name, groups = steps
    prefix = module_name.rsplit(".", 1)[-1] + "."
    out = []
    for event in prof.events():
        step = event.name[len(prefix):] if event.name.startswith(prefix) \
            else None
        if step not in groups or \
                event.device_type != torch.autograd.DeviceType.CPU:
            continue
        for name, us in _range_kernels(event):
            group = groups[step]
            if group == "expert FFN":
                group = "expert GEMMs" if _is_gemm(name) else \
                    "expert FFN elementwise"
            out.append((group, name, us / 1e3))
    return out


def profile_prefill(model, cfg, tag: str, kernel: tuple, T: int,
                    max_seq: int, steps=None) -> None:
    """The device time of one T-token prefill (B=1, as the engines run it,
    into a cache of ``max_seq``) by kernel: ``kernel`` = (label, substring
    of its CUDA kernels' names), the GEMMs and the rest, with its idle
    share; with ``steps`` (``MOE_STEPS``, ``HYBRID_STEPS``), the kernels
    under those steps' ranges by their group (for the MoE block: the expert
    GEMMs, its routing, dispatch and combine, the expert FFN's elementwise
    kernels; for the hybrid: the SSM scan), each taken out of the GEMMs or
    the rest where it would otherwise count.  CUDA events and the host
    clock around one prefill without the profiler, then ``torch.profiler``
    around another; after the launch counts were read."""
    from torch.profiler import ProfilerActivity, profile, schedule

    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, T)).astype(np.int32)).cuda()
    run = lambda: model.prefill(tokens, max_seq=max_seq)
    run()                                      # same shapes: warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    span_ms = start.elapsed_time(end)
    # a warm-up step inside the profiler, then the recorded one: a window
    # that opens with the prefill can lose its first kernels
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof, \
            (_step_ranges(steps) if steps else contextlib.nullcontext()):
        run()
        torch.cuda.synchronize()
        prof.step()                            # the recorded step from here
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels and copies only: the step's own range and the steps' ranges
    # span the device too
    ranges = (steps[0].rsplit(".", 1)[-1] + ".",) if steps else ()
    rows = [(e.self_device_time_total / 1e3, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith(("ProfilerStep",) + ranges)]
    log(f"[{tag}] one {T}-token prefill, B=1, {cfg.num_layers} layers: "
        f"wall {wall_ms:.2f} ms, CUDA events first launch to last end "
        f"{span_ms:.2f} ms (no profiler)")
    if not rows:
        log(f"[{tag}] the profiler saw no device time: breakdown not "
            "measured")
        return
    label, key = kernel
    group_of = lambda name: (label if key in name else "GEMMs"
                             if _is_gemm(name) else "the rest")
    groups = {label: [0.0, 0], "GEMMs": [0.0, 0], "the rest": [0.0, 0]}
    for ms, name, count in rows:
        groups[group_of(name)][0] += ms
        groups[group_of(name)][1] += count
    busy_ms = sum(r[0] for r in rows)
    if steps:
        inner = {}
        for group, name, ms in _step_kernels(prof, steps):
            acc = inner.setdefault(group, [0.0, 0])
            acc[0] += ms
            acc[1] += 1
            groups[group_of(name)][0] -= ms     # counted here, not there
            groups[group_of(name)][1] -= 1
        if not inner:
            raise AssertionError(
                f"[{tag}] no kernel was attributed to the ranges of "
                f"{', '.join(steps[1])} of {steps[0]}")
        groups = {label: groups[label], **inner,
                  "other GEMMs": groups["GEMMs"],
                  "the rest": groups["the rest"]}
    log(f"[{tag}] T={T} profiler on: wall {prof_wall_ms:.2f} ms, device "
        f"busy {busy_ms:.3f} ms ({100 * busy_ms / prof_wall_ms:.1f}% of "
        f"wall), idle {100 * (1 - busy_ms / prof_wall_ms):.1f}%; "
        + ", ".join(f"{name} {ms:.3f} ms x{n} ({100 * ms / busy_ms:.1f}%)"
                    for name, (ms, n) in groups.items()))
    for ms, name, count in sorted(rows, reverse=True)[:10]:
        log(f"[{tag}]   {ms:9.3f} ms  x{count:<5d} {name[:90]}")


# --------------------------------------------------------------- phase 7


def phase_gemma_serving() -> dict:
    """gemma2-9b at its published widths and full depth (42 layers) in the
    engine's dense mode: every prefill layer through K2 at head dim 256
    with its window (4096, on alternate layers) and softcap (50); decode
    on the dense cache, in plain PyTorch as the reference's XLA."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import layer_windows

    cfg = get_config("gemma2-9b")
    model = _model_on_card(
        cfg, "gemma", f" (all), window {cfg.local_window} on "
        f"{int((layer_windows(cfg) > 0).sum())} layers, softcaps "
        f"{cfg.attn_logit_softcap}/{cfg.final_logit_softcap}")
    engine, launches = _serve_dense(
        model, cfg, "gemma", "flash_attention", 8192,
        [6000, 2048, 1000, 513, 300, 128, 17, 4500], " [full depth]")
    profile_decode(engine, cfg, "gemma-profile")
    # K2's share of a prefill: the longest prompt of the run and a shorter one
    for T in (6000, 2048):
        profile_prefill(model, cfg, "gemma-prefill",
                        ("K2 (flash)", "flash_prefill"), T=T, max_seq=8192)
    return launches


# --------------------------------------------------------------- phase 8

LONG_PROMPT = 4000
CHUNK = 512


def _long_prompt_run(engine, vocab: int) -> tuple:
    """Three short greedy requests decoding, then a LONG_PROMPT-token prompt
    admitted; returns the host ms of every step from its admission to its
    first token, its ``prefill_chunk`` trace notes, the launch counts
    (set to 0 just before, read just after) and the decode steps."""
    from repro_torch.runtime import Request

    rng = np.random.default_rng(9)
    short = [Request(prompt=rng.integers(0, vocab, (n,)).astype(np.int32),
                     max_new_tokens=48, request_id=i)
             for i, n in enumerate((64, 100, 200))]
    long = Request(prompt=rng.integers(0, vocab, (LONG_PROMPT,)).astype(
        np.int32), max_new_tokens=16, request_id=3)
    counters = _launch_counters()
    base = engine.serving_stats()
    for fn in counters.values():
        fn.launches = 0
    for r in short:
        engine.submit(r)
    while not all(r.tokens for r in short):
        engine.step()
    engine.submit(long)
    stall_ms = []
    while not long.tokens:
        t = time.perf_counter()
        engine.step()
        stall_ms.append((time.perf_counter() - t) * 1e3)
    engine.drain()
    launches = {name: fn.launches for name, fn in counters.items()}
    reqs = short + [long]
    for r in reqs:
        if r.error or len(r.tokens) != r.max_new_tokens or not all(
                0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"request {r.request_id}: error={r.error} "
                                 f"tokens={r.tokens}")
    stats = engine.serving_stats()
    engine.flush_prefix_cache()
    _check_ledgers(engine, engine.serving_stats())
    chunks = [ln for ln in engine.trace()
              if f" prefill_chunk req={long.request_id} " in ln]
    steps = stats["decode_steps_total"] - base["decode_steps_total"]
    return stall_ms, chunks, launches, steps


def phase_chunked_and_rebatching() -> dict:
    """qwen2.5-32b at phase 4's 8-layer depth cut: (a) paged with chunked
    prefill against monolithic, a 4000-token prompt admitted under three
    decoding requests; (b) dense with chunked prefill; (c) the rebatching
    baseline (``incremental=False``) beside incremental prefill in dense
    mode, on phase 4's 8 requests.  Returns the launches summed."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import ServerConfig, ServingEngine

    cfg = dataclasses.replace(get_config("qwen2.5-32b"),
                              num_layers=SERVE_LAYERS)
    L = cfg.num_layers
    model = build_model(cfg, device="cuda")
    model.init(torch.Generator("cuda").manual_seed(0))
    total = dict.fromkeys(_launch_counters(), 0)
    n_chunks = -(-LONG_PROMPT // CHUNK)
    stalls = {}
    for label, kv_mode, chunk in (("paged chunked", "paged", CHUNK),
                                  ("paged monolithic", "paged", 0),
                                  ("dense chunked", "dense", CHUNK)):
        engine = ServingEngine(model, ServerConfig(
            max_batch=4, max_seq=4096, kv_mode=kv_mode,
            prefill_chunk_tokens=chunk))
        _warm_up(engine)
        stall_ms, chunks, launches, steps = _long_prompt_run(
            engine, cfg.vocab_size)
        if chunk and len(chunks) != n_chunks:
            raise AssertionError(
                f"[{label}] {len(chunks)} prefill_chunk notes for the "
                f"{LONG_PROMPT}-token prompt, not {n_chunks}")
        first_chunks = sum(1 for ln in engine.trace()
                           if " prefill_chunk " in ln and " at=0" in ln)
        full = first_chunks if chunk else engine.serving_stats()[
            "prefill_sequences_total"]["incremental"] - 1   # the warm-up's
        want = {"paged_attention": steps * L if kv_mode == "paged" else 0,
                "flash_attention": full * L if kv_mode == "paged" else 0,
                "wkv6": 0, "segment_zero": 0}
        if launches != want:
            raise AssertionError(f"[{label}] launches {launches} != {want}")
        for name, n in launches.items():
            total[name] += n
        stalls[label] = max(stall_ms)
        log(f"[chunked] {label}: the {LONG_PROMPT}-token prompt took "
            f"{len(stall_ms)} steps to its first token ({len(chunks)} "
            f"prefill_chunk notes), max step during its prefill "
            f"{max(stall_ms):.2f} ms, steps "
            f"{[round(t, 1) for t in stall_ms]} ms; ledgers balance; "
            f"launches {launches}")
    log(f"[chunked] max decode step during the long prefill: paged chunked "
        f"{stalls['paged chunked']:.2f} ms vs monolithic "
        f"{stalls['paged monolithic']:.2f} ms, dense chunked "
        f"{stalls['dense chunked']:.2f} ms")

    for incremental in (True, False):
        label = "incremental" if incremental else "rebatching"
        engine = ServingEngine(model, ServerConfig(
            max_batch=4, max_seq=4096, kv_mode="dense",
            incremental=incremental))
        reqs = _serving_requests(cfg.vocab_size, SERVE_LENGTHS)
        base = _warm_up(engine)
        run, launches, peak = _drive_counted(engine, reqs)
        stats = engine.serving_stats()
        _check_outputs(reqs, cfg.vocab_size)
        _check_ledgers(engine, stats)
        kind = "incremental" if incremental else "full"
        prefills = (stats["prefill_sequences_total"][kind]
                    - base["prefill_sequences_total"][kind])
        want = {"paged_attention": 0, "flash_attention": prefills * L,
                "wkv6": 0, "segment_zero": 0}
        if launches != want:
            raise AssertionError(f"[{label}] launches {launches} != {want}")
        for name, n in launches.items():
            total[name] += n
        tokens = sum(len(r.tokens) for r in reqs)
        log(f"[rebatch] dense {label}: {prefills} {kind} prefills "
            f"({stats['prefill_tokens_total'][kind] - base['prefill_tokens_total'][kind]}"
            f" tokens), flash_attention {launches['flash_attention']} = "
            f"{prefills} x {L}; {tokens} tokens in {run['wall']:.3f}s = "
            f"{tokens / run['wall']:.1f} tokens/s end to end")
        _log_timings("rebatch", run, peak, f" [dense {label}, {L} layers]")
    return total


# ------------------------------------------------------------ phases 9, 10

MOE_LAYERS = 8


def _cos_to_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean cosine of x's rows (T, D) to their mean direction: near 0
    for independent random rows, 1 when every row points the same way."""
    import torch.nn.functional as F

    rows = F.normalize(x.float(), dim=-1)
    return (rows @ F.normalize(rows.mean(dim=0), dim=0)).mean()


@contextlib.contextmanager
def _drop_log(out: list):
    """Appends (copies routed, copies dropped by capacity, the router
    input's mean cosine to its mean row, the share of copies on the k
    busiest experts) of every capacity-bounded routing (one layer of a
    prefill) to ``out``; all but the first stay device tensors until they
    are read after the run."""
    def record(x, r, cfg, lossless):
        if not lossless:
            k = cfg.experts_per_token
            busiest = torch.topk(r.counts, k).values.sum() / r.keep.numel()
            out.append((r.keep.numel(), (~r.keep).sum(), _cos_to_mean(x),
                        busiest))

    with _spy_routing(record):
        yield


def _moe_layer0_check(model, cfg, T: int = 256) -> None:
    """Layer 0 of the full-width MoE model on T random tokens, up to its
    routing, in fp32 on the card (K2's fp32 route) and on the CPU (the
    plain attention): every row's top-k equal wherever the CPU's router
    margin is clear, and then the copies dropped equal.  Logs how far the
    rows share one direction (mean cosine to their mean row) in the
    embeddings, the attention output and the router's input, and the
    attention output's RMS against the embeddings'."""
    import repro_torch.models.moe as moe
    from repro_torch.models.attention import attention_block
    from repro_torch.models.common import rms_norm

    rng = np.random.default_rng(13)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, T)).astype(np.int32))
    p = model._layer_params(0)
    h0 = model._embed_inputs(tokens.to(model.device)).float()
    got = {}
    for dev in (model.device, "cpu"):
        f32 = lambda t: t.detach().to(dev, torch.float32)
        p32 = {n: f32(t) for n, t in p.items() if torch.is_tensor(t)}
        p32["attn"] = {n: f32(t) for n, t in p["attn"].items()}
        h = f32(h0)
        a = rms_norm(h, p32["ln1"], cfg.norm_eps, plus_one=cfg.post_norms)
        a = attention_block(a, p32["attn"], cfg, window=int(model.windows[0]),
                            rope_base=model._rope_base(0),
                            positions=torch.arange(T, device=dev))
        x = rms_norm(model._attn_residual(h, a, p32), p32["ln2"],
                     cfg.norm_eps, plus_one=cfg.post_norms)[0]
        r = moe.route(x, f32(p["moe"]["router"]), cfg)
        got[dev] = (h[0].cpu(), a[0].cpu(), x.cpu(), r.top_idx.cpu(),
                    r.keep.cpu(), r.logits.cpu())
    h, a, x, idx, keep, logits = got["cpu"]
    _, _, xg, idx_g, keep_g, _ = got[model.device]
    differ = (idx != idx_g).any(dim=-1)
    margin = (_row_margins(logits[differ], cfg.experts_per_token).max()
              .item() if differ.any() else None)
    rms = lambda t: t.pow(2).mean().sqrt().item()
    log(f"[moe] layer 0 of {T} tokens in fp32, card vs CPU: router input "
        f"max|diff| {(x - xg).abs().max().item():.3g}, {int(differ.sum())} "
        f"rows route otherwise (largest CPU router margin among them "
        f"{margin}; near a tie below {CLEAR_MARGIN}), copies dropped "
        f"{int((~keep).sum())} on the CPU, {int((~keep_g).sum())} on the "
        f"card, of {keep.numel()}; mean cosine to the mean row: embeddings "
        f"{_cos_to_mean(h):.3f}, attention output {_cos_to_mean(a):.3f}, "
        f"router input {_cos_to_mean(x):.3f}; RMS attention output "
        f"{rms(a):.4g} against embeddings {rms(h):.4g}")
    if margin is not None and margin >= CLEAR_MARGIN:
        raise AssertionError(f"layer 0 routes {int(differ.sum())} rows "
                             "otherwise on the card at a clear margin")
    if margin is None and not torch.equal(keep, keep_g):
        raise AssertionError("layer 0 drops other copies on the card")


def phase_moe_paged() -> dict:
    """qwen3-moe-235b-a22b at its published widths (128 experts, top-8,
    expert d_ff 1536, 64 q / 4 kv heads of 128), depth cut 94 -> 8
    layers, in paged mode on phase 4's requests: every decode step through
    K1 at 16 q heads per kv head (the kMaxG instance), every full prefill
    through K2, the expert products in ``torch.bmm`` over the reference's
    (E, C, D) layout (decode reads every expert, lossless); the copies
    each prefill dropped past capacity logged; then one 2048-token
    prefill's device time by kernel and phase 4's decode window."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                              num_layers=MOE_LAYERS)
    k, L = cfg.experts_per_token, cfg.num_layers
    model = _model_on_card(
        cfg, "moe", f" (of 94), {cfg.num_experts} experts top-{k}, expert "
        f"d_ff {cfg.expert_d_ff}, capacity factor {cfg.capacity_factor}")
    drops = []
    engine, launches = _serve_paged(model, cfg, "moe",
                                    f" [{MOE_LAYERS}-layer depth cut]",
                                    during=_drop_log(drops))
    if len(drops) % L:
        raise AssertionError(f"{len(drops)} prefill routings, not a "
                             f"multiple of {L} layers")
    for i in range(0, len(drops), L):
        routed = drops[i][0]
        dropped = [int(d[1]) for d in drops[i:i + L]]
        log(f"[moe] prefill {i // L}: {routed // k} tokens, {routed} copies "
            f"routed in each of {L} layers, {sum(dropped)} dropped by "
            f"capacity ({100 * sum(dropped) / (routed * L):.2f}%), by layer "
            f"{dropped}; router input's mean cosine to its mean row by "
            f"layer {[round(d[2].item(), 3) for d in drops[i:i + L]]}, "
            f"share of copies on the {k} busiest experts "
            f"{[round(d[3].item(), 3) for d in drops[i:i + L]]}")
    _moe_layer0_check(model, cfg)
    profile_prefill(model, cfg, "moe-prefill", ("K2 (flash)", "flash_prefill"),
                    T=2048, max_seq=2048, steps=MOE_STEPS)
    profile_decode(engine, cfg, "moe-profile")
    return launches


def phase_moe_dense() -> dict:
    """llama4-scout-17b-a16e at its published widths (16 experts, sigmoid
    top-1, a shared expert, expert d_ff 8192, 40 q / 8 kv heads of 128,
    window 8192 on layers 0-2 of each 4; text only), depth cut 48 -> 8
    layers, in dense mode: 8 requests, one of 10000 tokens so the window
    masks on the local layers, every prefill layer through K2 at head dim
    128; decode on the dense cache (plain PyTorch)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import layer_windows

    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              num_layers=MOE_LAYERS)
    model = _model_on_card(
        cfg, "llama4", f" (of 48), {cfg.num_experts} experts sigmoid "
        f"top-{cfg.experts_per_token} + {cfg.num_shared_experts} shared, "
        f"expert d_ff {cfg.expert_d_ff}, window {cfg.local_window} on "
        f"{int((layer_windows(cfg) > 0).sum())} layers")
    engine, launches = _serve_dense(
        model, cfg, "llama4", "flash_attention", 12288,
        [10000, 2048, 1000, 513, 300, 128, 17, 4500],
        f" [{MOE_LAYERS}-layer depth cut]")
    profile_decode(engine, cfg, "llama4-profile")
    return launches


# --------------------------------------------------------------- phase 11

#: the device of every tensor the sort post-processor received, trace
#: included (a module global: a closure cell would enter the admission
#: cache key)
_UDF_DEVICES: list = []


def _sort_udf(t):
    _UDF_DEVICES.append(t.device.type)
    return torch.sort(t).values


def _flip_udf(t):
    return torch.flip(t, (0,))


def _leak_udf(t):
    return torch.ops.seepp_smoke.leak(t)


def _raise_udf(t):
    raise ValueError("bad post-code")


def _register_leak() -> None:
    """A custom op with a fake registration: host code that the Sentry
    must deny (the counterpart of the reference's ``pure_callback``)."""
    @torch.library.custom_op("seepp_smoke::leak", mutates_args=())
    def leak(x: torch.Tensor) -> torch.Tensor:
        return x.clone()

    @leak.register_fake
    def _(x):
        return torch.empty_like(x)


def _scrape(url: str) -> dict:
    """``/metrics`` as {series: value}."""
    import urllib.request

    body = urllib.request.urlopen(url, timeout=10).read().decode()
    out = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def _check_metrics(srv, tag: str) -> None:
    """``/metrics`` on 127.0.0.1 (ephemeral port) against the engine's,
    the controller's and the pool's own counters."""
    pool = srv.pool
    tenant = "serving"
    t0 = time.perf_counter()      # let the refiller reach its watermark
    while (pool.idle_count(tenant) < pool.refill_target(tenant)
           and time.perf_counter() - t0 < 5):
        time.sleep(0.01)
    endpoint = srv.serve_metrics(port=0, host="127.0.0.1")
    got = _scrape(endpoint.url)
    stats = srv.engine.serving_stats()
    adm = srv.admission.stats()
    ps = pool.stats.as_dict()
    lab = '{tenant="serving"}'
    want = {
        "seepp_serving_decode_steps_total": stats["decode_steps_total"],
        "seepp_serving_tokens_total" + lab: stats["tokens_total"][tenant],
        "seepp_serving_admitted_total" + lab: stats["admitted_total"][tenant],
        "seepp_serving_completed_total" + lab:
            stats["completed_total"][tenant],
        "seepp_serving_kv_pages_allocated_total":
            stats["kv_pages_allocated_total"],
        "seepp_serving_kv_pages_freed_total": stats["kv_pages_freed_total"],
        "seepp_serving_prefix_hits_total": stats["prefix_hits_total"],
        "seepp_admission_cache_hit_total": adm["hits"],
        "seepp_admission_cache_miss_total": adm["misses"],
        "seepp_admission_denied_total": adm["denials"],
        "seepp_admission_cache_entries": adm["entries"],
        "seepp_pool_hit_total": ps["hits"],
        "seepp_pool_miss_total": ps["misses"],
        "seepp_pool_discard_total": ps["discards"],
        "seepp_pool_prewarm_total": ps["prewarmed"],
        "seepp_pool_refill_total": ps["refills"],
    }
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if bad:
        raise AssertionError(f"[{tag}] /metrics against the stats: {bad}")
    log(f"[{tag}] /metrics at {endpoint.url}: {len(got)} series; "
        f"{len(want)} serving/admission/pool counters equal the stats")


def _server_run(model, cfg, tag: str, posts, **server_kw) -> tuple:
    """Phase 4's requests (``posts[i]`` the i-th one's post-processor)
    through ``Server`` after a warm-up request; holds the ledgers and the
    launch counts (K1 = decode steps x layers, K2 = full prefills x
    layers, K3 = K4 = 0).  Returns (requests, run, launches, server
    counters, host ms spent in the engine's postprocess hook)."""
    from repro_torch.runtime import Server, ServerConfig

    gc.collect()               # the previous run's server and its pages
    srv = Server(model, ServerConfig(
        max_batch=4, max_seq=4096, prefix_cache_seqs=4, **server_kw))
    try:
        engine = srv.engine
        if engine.kv_mode != "paged":
            raise AssertionError(f"{tag}: kv_mode {engine.kv_mode}")
        reqs = _serving_requests(cfg.vocab_size, SERVE_LENGTHS)
        reqs[7].prompt[:512] = reqs[0].prompt[:512]
        for r, post in zip(reqs, posts):
            r.postprocess = post
        base = _warm_up(engine)
        hook = engine._postprocess
        post_s = [0.0]

        def timed_postprocess(r):
            t = time.perf_counter()
            hook(r)
            post_s[0] += time.perf_counter() - t

        engine._postprocess = timed_postprocess
        run, launches, peak = _drive_counted(engine, reqs)
        srv.drain()                      # joins the concurrent plane
        engine._postprocess = hook
        stats = engine.serving_stats()
        steps = stats["decode_steps_total"] - base["decode_steps_total"]
        shared = stats["prefix_hits_total"] - base["prefix_hits_total"]
        full_prefills = (stats["prefill_sequences_total"]["incremental"]
                         - base["prefill_sequences_total"]["incremental"]
                         - shared)
        if launches["paged_attention"] != steps * cfg.num_layers:
            raise AssertionError(
                f"{tag}: paged_attention launches "
                f"{launches['paged_attention']} != {steps} x "
                f"{cfg.num_layers}")
        if launches["flash_attention"] != full_prefills * cfg.num_layers:
            raise AssertionError(
                f"{tag}: flash_attention launches "
                f"{launches['flash_attention']} != {full_prefills} x "
                f"{cfg.num_layers}")
        if launches["wkv6"] or launches["segment_zero"]:
            raise AssertionError(f"{tag}: the paged path launched {launches}")
        _check_metrics(srv, tag)
        engine.flush_prefix_cache()
        _check_ledgers(engine, engine.serving_stats())
        counters = {"admission": srv.admission.stats(),
                    "pool": srv.pool.stats.as_dict(),
                    "cold": _mean_ms(srv, "admission.cold_seconds"),
                    "warm": _mean_ms(srv, "admission.warm_seconds")}
    finally:
        srv.close()
    log(f"[{tag}] decode steps {steps}, full prefills {full_prefills}, "
        f"prefix hits {shared}; launches: paged_attention "
        f"{launches['paged_attention']} = {steps} x {cfg.num_layers}, "
        f"flash_attention {launches['flash_attention']} = {full_prefills} "
        f"x {cfg.num_layers}, wkv6 0, segment_zero 0; pages allocated = "
        f"freed, slot ledger balanced")
    _log_timings(tag, run, peak, f" [{SERVE_LAYERS}-layer depth cut]")
    retire = run["retire_ms"]
    log(f"[{tag}] {len(retire)} retire steps: {[round(t, 2) for t in retire]}"
        f" ms; the postprocess hook {post_s[0] * 1e3:.2f} ms in all "
        f"({100 * post_s[0] * 1e3 / sum(retire):.1f}% of the retire steps' "
        f"host time)")
    return reqs, run, launches, counters


def _mean_ms(srv, name: str) -> tuple:
    """(count, mean ms) of a telemetry histogram over its tenants."""
    n = total = 0.0
    for (hist_name, _), hist in srv.telemetry.histograms().items():
        if hist_name == name:
            n += hist.count
            total += hist.sum
    return int(n), (1e3 * total / n if n else float("nan"))


def _check_postprocessed(tag: str, reqs, plain, counters, workers: bool):
    """Good requests: the UDF on the plain run's stream; the callback
    denied and the raise failed on their own requests; admission misses =
    the distinct (program, shape) pairs (+1 with workers: the scheduler
    retries the raising program once, and its trace fails again)."""
    for r, p in zip(reqs, plain):
        want = torch.tensor(p.tokens, dtype=torch.int32)
        if r.postprocess is _sort_udf:
            want = torch.sort(want).values
        elif r.postprocess is _flip_udf:
            want = torch.flip(want, (0,))
        elif r.postprocess is _leak_udf:
            if not (r.error or "").startswith("postprocess denied") \
                    or "seepp_smoke.leak" not in r.error:
                raise AssertionError(f"{tag}: the callback was not denied: "
                                     f"{r.error}")
            continue
        elif r.postprocess is _raise_udf:
            if not (r.error or "").startswith("postprocess failed") \
                    or "bad post-code" not in r.error:
                raise AssertionError(f"{tag}: the raise did not fail its "
                                     f"request: {r.error}")
            continue
        if r.error or r.tokens != want.tolist():
            raise AssertionError(
                f"{tag}: request {r.request_id} {r.error} {r.tokens} != "
                f"{want.tolist()}")
    adm = counters["admission"]
    distinct = 4                          # sort, flip, callback, raise at (32,)
    want = {"misses": distinct + (1 if workers else 0), "denials": 1,
            "hits": len(reqs) - distinct}
    if {k: adm[k] for k in want} != want:
        raise AssertionError(f"{tag}: admission {adm}, expected {want}")
    if not _UDF_DEVICES or set(_UDF_DEVICES) != {"cuda"}:
        raise AssertionError(f"{tag}: the UDF saw {set(_UDF_DEVICES)}")
    log(f"[{tag}] 6 post-processed streams equal the UDF on the plain run's"
        f" streams; callback denied, raise failed, the rest served; "
        f"admission {adm}; pool {counters['pool']}; the sort UDF saw only "
        f"CUDA tensors ({len(_UDF_DEVICES)} calls, traces included); "
        f"admission cold {counters['cold'][0]} x {counters['cold'][1]:.3f} "
        f"ms, warm {counters['warm'][0]} x {counters['warm'][1]:.4f} ms")


def _admission_costs() -> None:
    """Cold against warm admission of a sort UDF, and the sandbox's verify
    against interpret mode, on a 4096-token int32 CUDA tensor (host clock
    around a synchronized call, medians)."""
    from repro_torch.core import (
        AdmissionController, ModernEmulationPolicy, Sandbox)

    x = torch.randint(0, 152064, (4096,), dtype=torch.int32, device="cuda")
    pol = ModernEmulationPolicy()
    ctl = AdmissionController()

    def timed(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return float(np.median(out))

    fns = [(lambda: lambda t: torch.sort(t).values)() for _ in range(6)]
    it = iter(fns)
    cold = timed(lambda: ctl.admit(next(it), (x,), policy=pol), 5)
    warm = timed(lambda: ctl.admit(fns[0], (x,), policy=pol), 50)
    sort = fns[0]
    verify = Sandbox(policy=pol, admission=ctl, mode="verify")
    interp = Sandbox(policy=pol, admission=ctl, mode="interpret")
    if not torch.equal(verify.run(sort, x).value, interp.run(sort, x).value):
        raise AssertionError("interpret and verify disagree on the sort")
    v_ms = timed(lambda: verify.run(sort, x), 20)
    i_ms = timed(lambda: interp.run(sort, x), 20)
    plain_ms = timed(lambda: torch.sort(x), 20)
    log(f"[admission] sort UDF on a 4096-token int32 CUDA tensor: cold "
        f"admission {cold:.3f} ms, warm {warm * 1e3:.1f} us "
        f"({cold / warm:.0f} x); Sandbox.run verify {v_ms:.3f} ms, "
        f"interpret {i_ms:.3f} ms, torch.sort alone {plain_ms:.3f} ms "
        "(host clock, medians, synchronized)")


def phase_server() -> dict:
    """qwen2.5-32b at phase 4's 8-layer cut, paged, served through
    ``Server`` three times: without post-processors (the plain streams),
    with them inline, and on the concurrent plane (2 workers, warm pool
    watermark 2, heartbeats at 30 s).  Returns the launches summed."""
    from repro_torch.configs import get_config

    _register_leak()
    cfg = dataclasses.replace(get_config("qwen2.5-32b"),
                              num_layers=SERVE_LAYERS)
    model = _model_on_card(cfg, "server", " (of 64)")
    total = {}
    plain, _, launches, _ = _server_run(model, cfg, "server-plain",
                                        [None] * 8)
    _check_outputs(plain, cfg.vocab_size)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    # each retiring group of 4 has distinct programs, so no two cold
    # admissions of one program race on the workers
    posts = [_sort_udf, _flip_udf, _leak_udf, _raise_udf] + [_sort_udf] * 4
    for tag, kw in (("server-inline", {}),
                    ("server-workers", dict(workers=2, pool_watermark=2,
                                            heartbeat_timeout_s=30.0))):
        _UDF_DEVICES.clear()
        reqs, _, launches, counters = _server_run(model, cfg, tag, posts,
                                                  **kw)
        _check_postprocessed(tag, reqs, plain, counters, bool(kw))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    _admission_costs()
    return total


# --------------------------------------------------------------- phase 12


def phase_hybrid_serving() -> dict:
    """hymba-1.5b at its published widths and full depth (32 layers) in the
    engine's dense mode, on phase 4's prompt lengths (the reference's SSM
    scan refuses 1000, 513, 300 and 1500 tokens; the port's takes any):
    every prefill layer through K2 at head dim 64 (25 q / 5 kv heads, the
    window of 1024 on 29 layers) beside the SSM scan in plain PyTorch;
    decode on the dense cache and ``ssm_step``; K1, K3, K4 never.  Then
    phase 4's decode window and one 2048-token prefill's device time split
    into K2, the SSM scan, the other GEMMs and the rest
    (``[hybrid-prefill]`` lines)."""
    from repro_torch.configs import get_config
    from repro_torch.models.hybrid import hymba_windows

    cfg = get_config("hymba-1.5b")
    model = _model_on_card(
        cfg, "hybrid", f" (all), window {cfg.local_window} on "
        f"{int((hymba_windows(cfg) > 0).sum())} layers, SSM d_inner "
        f"{cfg.ssm_d_inner} state {cfg.ssm_state_size}")
    engine, launches = _serve_dense(model, cfg, "hybrid", "flash_attention",
                                    4096, SERVE_LENGTHS, " [full depth]")
    profile_decode(engine, cfg, "hybrid-profile")
    profile_prefill(model, cfg, "hybrid-prefill",
                    ("K2 (flash)", "flash_prefill"), T=2048, max_seq=4096,
                    steps=HYBRID_STEPS)
    return launches


# --------------------------------------------------------------- phase 13

VLM_LAYERS = 8
# the text that follows llava-next-34b's 576 patch embeddings in phase 13's
# prefill: 2048 rows in all
VLM_TEXT = 1472
VLM_DECODE = 32
# phase 13's hold of the decode to the teacher-forced forward: the
# relative L2 distance of each step's bf16 logits.  Both sides round every
# layer's attention and MLP outputs, the residual and the logits to bf16
# (2**-9 relative each), at other places (K2's tiles against one decode
# row over the dense cache; GEMMs of 2048 rows against 1): over 8 layers
# of ~4 such roundings, independent errors add to ~sqrt(64) * 2**-9 ~ 1.6 %,
# and 5 % leaves a factor of 3 for the layers' amplification.  A wrong
# position, cache row or prefix moves the logits by O(1).
VLM_REL_TOL = 0.05


def phase_vlm() -> dict:
    """llava-next-34b at its published widths (56 q / 8 kv heads of 128,
    d_ff 20480, untied unembedding), depth cut 60 -> 8 layers: (a) phase
    4's 8 text requests in paged mode, every decode step through K1 at 7 q
    heads per kv head and every full prefill through K2 at 56 / 8 (the
    engine passes no patch embeddings, as the reference's passes none);
    (b) the model-level API as the reference runs the prefix: one dense
    ``prefill`` of 576 seeded patch embeddings and 1472 text tokens, timed,
    then 32 greedy ``decode_step``s, each step's logits held to a
    teacher-forced ``forward`` over the same prefix and tokens within
    ``VLM_REL_TOL`` (its comment says why).  Returns the launches of (a)
    and of (b)'s prefill and decode steps."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("llava-next-34b"),
                              num_layers=VLM_LAYERS)
    model = _model_on_card(cfg, "llava", f" (of 60), {cfg.num_patches} "
                           "patches, untied unembedding")
    engine, launches = _serve_paged(model, cfg, "llava",
                                    f" [{VLM_LAYERS}-layer depth cut]")
    del engine
    gc.collect()

    g = torch.Generator("cuda").manual_seed(13)
    patches = torch.randn((1, cfg.num_patches, cfg.d_model), generator=g,
                          device="cuda").to(model.dtype)
    rng = np.random.default_rng(13)
    S = cfg.num_patches + VLM_TEXT
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S)).astype(
        np.int32)).cuda()
    model.prefill(tokens, max_seq=S, patch_embeds=patches)      # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    model.prefill(tokens, max_seq=S + VLM_DECODE, patch_embeds=patches)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    stream, got, steps_ms = greedy_stream(model, tokens, VLM_DECODE,
                                          patch_embeds=patches)
    counted = {n: fn.launches for n, fn in counters.items()}
    want = dict.fromkeys(counted, 0)
    want["flash_attention"] = cfg.num_layers             # the prefill's
    if counted != want:
        raise AssertionError(f"[llava] the prefix prefill and decode "
                             f"launched {counted}, not {want}")
    # the teacher-forced forward over the prefix and the greedy tokens
    # (not counted: it checks the path, it is not the path)
    full = torch.cat([tokens, stream[:, :-1].cuda()], dim=1)
    logits, _ = model.forward(full, patch_embeds=patches)
    want_rows = logits[0, S - 1:].float().cpu()
    got = got[0]
    rel = (got - want_rows).norm(dim=-1) / want_rows.norm(dim=-1)
    agree = int((got.argmax(-1) == want_rows.argmax(-1)).sum())
    if not bool((rel <= VLM_REL_TOL).all()):
        raise AssertionError(
            f"[llava] decode vs teacher-forced forward: relative L2 by step "
            f"{[round(x, 4) for x in rel.tolist()]} > {VLM_REL_TOL}")
    log(f"[llava] prefix prefill: {cfg.num_patches} patch embeddings + "
        f"{VLM_TEXT} text tokens (S={S}), B=1, {cfg.num_layers} layers: "
        f"{start.elapsed_time(end):.2f} ms CUDA events, wall {wall_ms:.2f} "
        f"ms; "
        f"{VLM_DECODE} greedy decode steps (dense cache), step p50 "
        f"{float(np.median(steps_ms)):.2f} ms; launches {counted}")
    log(f"[llava] decode vs teacher-forced forward over the same prefix: "
        f"logits relative L2 max {rel.max().item():.4g}, median "
        f"{rel.median().item():.4g} (tol {VLM_REL_TOL}); greedy token = "
        f"forward's argmax at {agree} of {VLM_DECODE} steps")
    for name, n in counted.items():
        launches[name] += n
    return launches


# --------------------------------------------------------------- phase 14

WHISPER_BATCH = 4
WHISPER_PROMPT = 4
WHISPER_DECODE = 64


def phase_whisper() -> dict:
    """whisper-tiny, the full config (4 + 4 layers, d_model 384, 6 heads of
    64, 1500 encoder frames, vocab 51865, 32776 learned positions through
    ``build_model``), through the model-level API as the reference runs it
    (its engine cannot serve the family): B = 4 seeded frames, a 4-token
    prompt, 64 greedy decode steps.  In fp32 the card's stream equals the
    CPU's, and no kernel launches (no TPU kernel lies on this path: the
    attention is ``blockwise_attn``, plain PyTorch as the reference's XLA);
    in bf16 the encode and the decode steps are timed."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("whisper-tiny")
    f32 = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.default_rng(14)
    frames = torch.from_numpy(rng.standard_normal(
        (WHISPER_BATCH, cfg.encoder_len, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT)).astype(np.int32))
    cpu = build_model(f32, device="cpu").init(torch.Generator().manual_seed(6))
    gpu = build_model(f32, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    g_stream, g_logits, _ = greedy_stream(gpu, tokens, WHISPER_DECODE,
                                          frames=frames)
    launches = {n: fn.launches for n, fn in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"[whisper] launched {launches}")
    c_stream, c_logits, _ = greedy_stream(cpu, tokens, WHISPER_DECODE,
                                          frames=frames)
    g_first, c_first = g_logits[:, 0], c_logits[:, 0]
    err = (g_first - c_first).abs().max().item()
    if not torch.allclose(g_first, c_first, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"[whisper] card vs CPU prefill logits: "
                             f"max|err| {err}")
    if not torch.equal(g_stream, c_stream):
        raise AssertionError(
            f"[whisper] card vs CPU fp32 greedy streams differ: cpu "
            f"{c_stream.tolist()}, card {g_stream.tolist()}")
    log(f"[whisper] {cfg.arch_id} fp32, B={WHISPER_BATCH}, "
        f"{cfg.encoder_len} frames, {WHISPER_PROMPT}-token prompt, "
        f"{WHISPER_DECODE} greedy decode steps: prefill logits max|err| "
        f"{err:.3g} (tol 1e-3), streams equal on card and CPU "
        f"(first row {g_stream[0, :16].tolist()}...); launches {launches}")
    del cpu, gpu
    gc.collect()
    model = _model_on_card(cfg, "whisper", f" + {cfg.encoder_layers} "
                           f"encoder layers, {cfg.encoder_len} frames")
    log(f"[whisper] learned target positions {model.max_target_positions}")
    frames_d = frames.cuda().to(model.dtype)
    model.encode(frames_d)                                # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 10
    start.record()
    for _ in range(reps):
        model.encode(frames_d)
    end.record()
    torch.cuda.synchronize()
    encode_ms = start.elapsed_time(end) / reps
    greedy_stream(model, tokens, 4, frames=frames_d)          # warm
    stream, _, steps_ms = greedy_stream(model, tokens, WHISPER_DECODE,
                                        frames=frames_d)
    if not bool(((stream >= 0) & (stream < cfg.vocab_size)).all()):
        raise AssertionError(f"[whisper] bf16 tokens out of range: {stream}")
    log(f"[whisper] bf16, B={WHISPER_BATCH}: encode of {cfg.encoder_len} "
        f"frames {encode_ms:.3f} ms (CUDA events, mean of {reps}); decode "
        f"step p50 {float(np.median(steps_ms)):.2f} ms, max "
        f"{max(steps_ms):.2f} ms over {WHISPER_DECODE} steps (host clock, "
        "synchronised)")
    return launches


# --------------------------------------------------------------- phase 15

# card against CPU, fp32, from the same weights and batches.  The step-0
# gradients are the well-conditioned comparison: every leaf within
# 1e-4 of its largest entry (cuBLAS and the CPU's BLAS sum in other
# orders; the CPU tests hold the port to the reference by the same
# limit), and the first loss within rtol 1e-5.  The 3-step runs drift
# further: AdamW's first update is about sign(g) * lr elementwise, so an
# entry whose gradient lies within fp32 noise of zero and has another sign
# on the card than on the CPU moves by +lr on one side and -lr on the
# other, and the runs then descend from points that differ.  On an H100
# 80GB HBM3 (700 W) the widened gemma2 and hymba drifted by up to 7.7e-5
# of a loss, 2.5e-3 of a gradient norm and 4.9e-3 of a leaf's update
# (relative L2), past the CPU tests' limits of 1e-4, 1e-3 and 5e-3.  So
# each cell counts those flipped entries of the first update, and the run
# held to the CPU tests' limits is the CPU's with its first update taking
# the card's gradient on them (every other entry its own); the CPU's own
# run is held to the wider limits of the unaligned drift
TRAIN_GRAD_REL, TRAIN_LOSS_RTOL0 = 1e-4, 1e-5
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_UPDATE_REL = 1e-4, 1e-3, 5e-3
TRAIN_UNALIGNED_RTOLS = (1e-3, 1e-2, 2e-2)
#: the full-width cell: gemma2-9b at its published widths, 8 of 42 layers,
#: bf16, global batch 4 of 1024 tokens, 6 steps of Trainer.run
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 6
#: peak device memory the full-width cell may reach
TRAIN_PEAK_LIMIT = 72e9


class _ModalityLM:
    """``SyntheticLM`` plus the seeded input a family's ``loss`` reads
    beside the tokens (llava's patch embeddings, whisper's frames), keyed
    by step as the tokens are."""

    def __init__(self, cfg, dc):
        from repro_torch.data import SyntheticLM

        self.base, self.cfg = SyntheticLM(dc), cfg

    def batch_at(self, step):
        b = self.base.batch_at(step)
        cfg = self.cfg
        key, n = {"vlm": ("patch_embeds", cfg.num_patches),
                  "audio": ("frames", cfg.encoder_len)}.get(
            cfg.family, (None, 0))
        if key:
            rng = np.random.default_rng(1000 + step)
            b[key] = rng.standard_normal(
                (b["tokens"].shape[0], n, cfg.d_model)).astype(np.float32)
        return b


def _train_cells():
    """(tag, config, sequence length): phase 5's widened small configs, one
    per family."""
    from repro_torch.configs import get_reduced

    rep = dataclasses.replace
    return [
        ("gemma2", rep(get_reduced("gemma2-9b"), num_layers=2, d_model=512,
                       num_heads=2, num_kv_heads=1, head_dim=256, d_ff=1024,
                       local_window=64, query_scale=256 ** -0.5,
                       dtype="float32"), 128),
        ("qwen3-moe", rep(get_reduced("qwen3-moe-235b-a22b"),
                          dtype="float32"), 32),
        ("llava", rep(get_reduced("llava-next-34b"), dtype="float32"), 32),
        ("rwkv6", rep(get_reduced("rwkv6-3b"), num_layers=2, d_model=256,
                      num_heads=4, num_kv_heads=4, d_ff=896,
                      rwkv_head_size=64, dtype="float32"), 64),
        ("hymba", rep(get_reduced("hymba-1.5b"), dtype="float32"), 64),
        ("whisper", rep(get_reduced("whisper-tiny"), dtype="float32"), 16),
    ]


def _train(model, cfg, seq: int, steps: int, *, accum: int = 1,
           batch: int = 4, ckpt_every: int = 10 ** 9, **kw):
    """``steps`` of ``Trainer.run`` on ``_ModalityLM`` batches from the
    module's weights (peak lr 3e-3, warmup 1 step: the first step moves a
    bf16 norm scale of 1.0 by more than half its ulp)."""
    from repro_torch.data import DataConfig, Loader
    from repro_torch.models.common import param_tree
    from repro_torch.optim import ScheduleConfig, adamw_init
    from repro_torch.runtime import Trainer, TrainerConfig

    dc = DataConfig(global_batch=batch, seq_len=seq,
                    vocab_size=cfg.vocab_size)
    loader = Loader(_ModalityLM(cfg, dc), dc)
    tr = Trainer(model, loader, TrainerConfig(
        total_steps=steps, accum_steps=accum, log_every=1,
        ckpt_every=ckpt_every,
        schedule=ScheduleConfig(peak_lr=3e-3, warmup_steps=1,
                                decay_steps=100)), **kw)
    params = param_tree(model)
    try:
        params, _ = tr.run(params, adamw_init(params))
    finally:
        loader.stop()
    return tr, params


@contextlib.contextmanager
def _first_update(hook):
    """``hook(gradient leaves)`` on the first AdamW update inside the block
    (``Trainer`` calls it through ``launch.steps``), before it runs:
    the hook may read the gradients or overwrite entries of them."""
    import repro_torch.launch.steps as steps
    from repro_torch.tree import tree_leaves

    real = steps.adamw_update
    calls = [0]

    def update(grads, *args, **kwargs):
        if not calls[0]:
            hook(tree_leaves(grads))
        calls[0] += 1
        return real(grads, *args, **kwargs)

    steps.adamw_update = update
    try:
        yield
    finally:
        steps.adamw_update = real


def _align_flips(card_grads, flips):
    """A ``_first_update`` hook for the CPU run: every entry whose gradient
    has another sign than the card's takes the card's value; counts them
    in ``flips`` with their largest |g| as a share of their leaf's."""
    def hook(leaves):
        for g, gc in zip(leaves, card_grads):
            flip = torch.sign(g) != torch.sign(gc)
            n = int(flip.sum())
            if n:
                flips["entries"] += n
                flips["share"] = max(flips["share"], (
                    g[flip].abs().max() / g.abs().max()).item())
                g[flip] = gc[flip].to(g.dtype)
    return hook


def _check_grads(named) -> list:
    """Raises unless every gradient is finite with a non-zero norm;
    returns (name, norm) of each, in leaf order."""
    names = [n for n, _ in named]
    norms = torch.stack([g.float().norm() for _, g in named]).tolist()
    bad = [(n, v) for n, v in zip(names, norms)
           if not (np.isfinite(v) and v > 0)]
    if bad:
        raise AssertionError(f"gradients zero or not finite: {bad[:8]}")
    return list(zip(names, norms))


def _step0_grads(model, cfg, seq: int) -> list:
    """(name, gradient) of every leaf for the first batch's loss on the
    model's device, each checked finite and non-zero."""
    from repro_torch.data import DataConfig
    from repro_torch.models.common import param_tree
    from repro_torch.runtime.train_loop import backward
    from repro_torch.tree import tree_flatten_with_path, tree_unflatten_like

    dc = DataConfig(global_batch=4, seq_len=seq, vocab_size=cfg.vocab_size)
    batch = {k: torch.from_numpy(v).to(model.device)
             for k, v in _ModalityLM(cfg, dc).batch_at(0).items()}
    tree = param_tree(model)
    flat = tree_flatten_with_path(tree)
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    loss, _ = model.loss(tree_unflatten_like(tree, leaves), batch)
    named = [(".".join(map(str, p)), g) for (p, _), g in zip(flat, backward(
        loss, leaves))]
    _check_grads(named)
    return named


def _attn_norms(norms: list) -> str:
    """The query/key/value projections' gradient norms, by name."""
    keys = ("attn.wq", "attn.wk", "attn.wv", "layers.wr", "layers.wk",
            "layers.wv")
    return ", ".join(f"{n} {v:.3g}" for n, v in norms
                     if n.endswith(keys)) or "none"


def _update_errors(got, want, start) -> float:
    """The largest leaf's |got - want| over |want - start| (relative L2)."""
    from repro_torch.checkpoint.ckpt import tree_to_records

    want = dict(tree_to_records(want))
    worst = 0.0
    for key, t in tree_to_records(got):
        ref = want[key].double()
        moved = (ref - start[key.replace("/", ".")].double()).norm().item()
        err = (t.double() - ref).norm().item()
        worst = max(worst, err / max(moved, 1e-30))
    return worst


def _train_card_vs_cpu(tag: str, cfg, seq: int, accum: int = 1) -> dict:
    """3 fp32 Trainer steps of ``cfg`` on the card and on the CPU from the
    same weights: losses, gradient norms and final parameters held to each
    other; the card's step-0 gradient finite and non-zero on every leaf;
    no kernel launched on the card.  Returns the card's launches."""
    from repro_torch.models import build_model

    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(21))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    grads = _step0_grads(gpu, cfg, seq)
    norms = [(n, g.norm().item()) for n, g in grads]
    grad_err = 0.0
    for (name, g), (_, ref) in zip(grads, _step0_grads(cpu, cfg, seq)):
        err = (g.cpu() - ref).abs().max().item() / ref.abs().max().item()
        grad_err = max(grad_err, err)
        if err > TRAIN_GRAD_REL:
            raise AssertionError(f"[train-card-vs-cpu] {tag}: step-0 "
                                 f"gradient of {name} off by {err:.3g} of "
                                 "its largest entry")
    del grads
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    card_grads = []
    t0 = time.perf_counter()
    with _first_update(lambda leaves: card_grads.extend(
            g.detach().cpu().clone() for g in leaves)):
        tr_g, p_g = _train(gpu, cfg, seq, 3, accum=accum)
    card_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"{tag} training launched {launches}")
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    loss_g = [r["loss"] for r in tr_g.metrics_log]
    gn_g = [r["gnorm"] for r in tr_g.metrics_log]
    if not (np.isfinite(loss_g + gn_g).all()):
        raise AssertionError(f"[train-card-vs-cpu] {tag}: losses {loss_g}, "
                             f"gnorms {gn_g}")
    flips = {"entries": 0, "share": 0.0}
    drift = {}
    for run, hook, (l_tol, g_tol, u_tol) in (
            ("cpu", None, TRAIN_UNALIGNED_RTOLS),
            ("cpu-aligned", _align_flips(card_grads, flips),
             (TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_UPDATE_REL))):
        cpu.load_state_dict(start)
        with _first_update(hook) if hook else contextlib.nullcontext():
            tr_c, p_c = _train(cpu, cfg, seq, 3, accum=accum)
        loss_c = [r["loss"] for r in tr_c.metrics_log]
        gn_c = [r["gnorm"] for r in tr_c.metrics_log]
        d = (rel(loss_g, loss_c), rel(gn_g, gn_c),
             _update_errors(p_g, p_c, start))
        drift[run] = d
        if not (abs(loss_g[0] - loss_c[0]) <= TRAIN_LOSS_RTOL0 * abs(loss_c[0])
                and d[0] <= l_tol and d[1] <= g_tol and d[2] <= u_tol):
            raise AssertionError(
                f"[train-card-vs-cpu] {tag} accum {accum} against {run}: "
                f"losses card {loss_g} cpu {loss_c}, gnorms card {gn_g} cpu "
                f"{gn_c}, worst leaf update error {d[2]:.3g} (limits "
                f"{l_tol:g}, {g_tol:g}, {u_tol:g}; {flips['entries']} "
                "flipped entries aligned)")
    n_entries = sum(g.numel() for g in card_grads)
    log(f"[train-card-vs-cpu] {tag} ({cfg.arch_id} at d_model "
        f"{cfg.d_model}, {cfg.num_layers} layers, seq {seq}, fp32, accum "
        f"{accum}): losses card {[round(x, 6) for x in loss_g]}; first "
        f"update's sign flips card vs CPU {flips['entries']} of {n_entries} "
        f"entries (largest |g| {flips['share']:.2g} of its leaf's); "
        + "; ".join(
            f"vs {run}: loss max rel {d[0]:.2g}, gnorm max rel {d[1]:.2g}, "
            f"worst leaf update error {d[2]:.2g}" for run, d in drift.items())
        + f" (limits aligned {TRAIN_LOSS_RTOL:g}/{TRAIN_GNORM_RTOL:g}/"
        f"{TRAIN_UPDATE_REL:g}, unaligned "
        f"{'/'.join(f'{x:g}' for x in TRAIN_UNALIGNED_RTOLS)}); card step-0 "
        f"gradients finite and non-zero on all {len(norms)} leaves "
        f"({_attn_norms(norms)}), within {grad_err:.2g} of the CPU's (tol "
        f"{TRAIN_GRAD_REL:g}); card {card_s:.2f}s, launches {launches}")
    return launches


def _train_recovery_card() -> None:
    """The widened gemma2 on the card: a ``FailureInjector`` failure at
    step 3 with ``ckpt_every=2`` restores step 2's checkpoint and replays
    step 2 on the next batch (the reference's recovery), so its 5-step run
    ends with the parameters of an uninterrupted 6-step run."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.gofer import Gofer
    from repro_torch.models import build_model
    from repro_torch.runtime import FailureInjector, HeartbeatMonitor

    tag, cfg, seq = _train_cells()[0]
    model = build_model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(22))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(Gofer.for_root("ckpt", d, write=True))
        tr, recovered = _train(
            model, cfg, seq, 5, ckpt_every=2, ckpt=ckpt,
            injector=FailureInjector(fail_at={3: ["host1"]}),
            monitor=HeartbeatMonitor(["host0", "host1"]))
        steps = ckpt.all_steps()
    if tr.restarts != 1 or steps != [2, 4, 5]:
        raise AssertionError(f"recovery: restarts {tr.restarts}, "
                             f"checkpoints {steps}")
    model.load_state_dict(start)
    _, straight = _train(model, cfg, seq, 6)
    cpu_start = {k: v.cpu() for k, v in start.items()}
    err = _update_errors(recovered, straight, cpu_start)
    from repro_torch.tree import tree_leaves

    bitwise = all(torch.equal(a, b) for a, b in
                  zip(tree_leaves(recovered), tree_leaves(straight)))
    if not bitwise and err > TRAIN_UNALIGNED_RTOLS[2]:
        raise AssertionError(f"recovered run vs uninterrupted: worst leaf "
                             f"update error {err:.3g}")
    log(f"[train-recovery] {tag} on the card: failure at step 3, restored "
        f"step 2 of checkpoints {steps}, 5 steps end equal to an "
        f"uninterrupted 6-step run ("
        + ("bit for bit)" if bitwise else f"worst leaf update error {err:.2g})"))


@contextlib.contextmanager
def _train_ranges(model, spans: dict):
    """``record_function`` ranges ``train.forward`` (the model's ``loss``),
    ``train.backward`` and ``train.optimizer`` around the trainer's steps,
    and CUDA events on the stream before and after each, appended to
    ``spans[name]`` as (start, end) pairs."""
    import repro_torch.launch.steps as steps
    from torch.profiler import record_function

    real = {"backward": steps.backward,
            "adamw_update": steps.adamw_update}

    def ranged(name, fn):
        def call(*args, **kwargs):
            with record_function(f"train.{name}"):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args, **kwargs)
                b.record()
            spans.setdefault(name, []).append((a, b))
            return out
        return call

    model.loss = ranged("forward", model.loss)
    steps.backward = ranged("backward", real["backward"])
    steps.adamw_update = ranged("optimizer", real["adamw_update"])
    try:
        yield
    finally:
        del model.loss
        steps.backward = real["backward"]
        steps.adamw_update = real["adamw_update"]


def _train_full_width() -> dict:
    """gemma2-9b at its published widths (d_model 3584, 16 q / 8 kv heads
    of 256, d_ff 14336, the tied 256000-token embedding, softcaps 50/30,
    window 4096 on every other layer), depth cut 42 -> 8 layers, bf16: 6
    steps of ``Trainer.run`` at global batch 4 of 1024 tokens.  Checks
    finite losses and norms, a finite non-zero gradient on every leaf and
    a change in every leaf at the first step, no kernel launched; logs the
    median step time of steps 1-5, tokens/s, the peak memory, then one
    more step under the profiler (busy share, device time of its forward,
    backward and optimizer spans) and a blocking checkpoint save and
    restore of the parameters."""
    import repro_torch.launch.steps as steps
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, Loader, SyntheticLM
    from repro_torch.models.common import param_tree
    from repro_torch.optim import ScheduleConfig, adamw_init
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    cfg = dataclasses.replace(get_config("gemma2-9b"),
                              num_layers=SERVE_LAYERS)
    model = _model_on_card(cfg, "train", f" (depth cut 42 -> {SERVE_LAYERS},"
                           " tied embedding)")
    dc = DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_S,
                    vocab_size=cfg.vocab_size)
    loader = Loader(SyntheticLM(dc), dc)
    trainer = Trainer(model, loader, TrainerConfig(
        total_steps=TRAIN_STEPS, log_every=1, ckpt_every=10 ** 9,
        schedule=ScheduleConfig(peak_lr=3e-3, warmup_steps=1,
                                decay_steps=100)))
    params = param_tree(model)
    opt = adamw_init(params)
    step_fn = trainer._step_fn
    real_update = steps.adamw_update
    times, first = [], {}

    def checked_update(grads, *args, **kwargs):
        if "grads" not in first:       # step 0: every leaf's gradient
            first["grads"] = _check_grads(
                [(".".join(map(str, p)), g)
                 for p, g in tree_flatten_with_path(grads)])
        return real_update(grads, *args, **kwargs)

    def timed_step(p, o, b):
        before = [t.clone() for t in tree_leaves(p)] if not times else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(p, o, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if len(times) == 1:            # the peak of steps 1.. from here
            torch.cuda.reset_peak_memory_stats()
        if before is not None:
            same = [n for (n, _), a, c in zip(first["grads"], before,
                                              tree_leaves(out[0]))
                    if torch.equal(a, c)]
            if same:
                raise AssertionError(f"leaves unchanged by step 0: {same}")
        return out

    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    trainer._step_fn = timed_step
    steps.adamw_update = checked_update
    try:
        params, opt = trainer.run(params, opt)
    finally:
        steps.adamw_update = real_update
        loader.stop()
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    rows = trainer.metrics_log
    if any(launches.values()):
        raise AssertionError(f"training launched {launches}")
    if not all(np.isfinite([r["loss"], r["gnorm"]]).all() for r in rows):
        raise AssertionError(f"non-finite training metrics: {rows}")
    if peak > TRAIN_PEAK_LIMIT:
        raise AssertionError(f"peak memory {peak / 1e9:.1f} GB")
    med = float(np.median(times[1:]))
    log(f"[train] gemma2-9b x{SERVE_LAYERS} layers bf16, B={TRAIN_B} "
        f"S={TRAIN_S}, {TRAIN_STEPS} steps: losses "
        f"{[round(r['loss'], 4) for r in rows]}, gnorms "
        f"{[round(r['gnorm'], 3) for r in rows]}, lr {rows[0]['lr']:.2e}")
    log(f"[train] step times {[round(t, 4) for t in times]} s; median of "
        f"steps 1-{TRAIN_STEPS - 1} {med * 1e3:.1f} ms, "
        f"{TRAIN_B * TRAIN_S / med:.0f} tokens/s; peak memory of steps "
        f"1-{TRAIN_STEPS - 1} {peak / 1e9:.2f} GB (max_memory_allocated); "
        f"step-0 gradients "
        f"finite and non-zero on all {len(first['grads'])} leaves "
        f"({_attn_norms(first['grads'])}), every leaf changed; launches "
        f"{launches}")
    _profile_train_step(model, trainer, params, opt, dc)
    _checkpoint_full_width(params)
    return launches


def _profile_train_step(model, trainer, params, opt, dc) -> None:
    """One more step (batch 6) under ``torch.profiler``, after a warm one
    (batch 7): wall time, device busy share, the CUDA-event spans of its
    forward, backward (with the layers' recomputation) and optimizer, and
    the kernels that take the most time."""
    from repro_torch.data import SyntheticLM
    from torch.profiler import ProfilerActivity, profile, schedule

    data = SyntheticLM(dc)
    batch = lambda i: {k: torch.from_numpy(v).cuda()
                       for k, v in data.batch_at(i).items()}
    spans: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof, \
            _train_ranges(model, spans):
        params, opt, _ = trainer._step_fn(params, opt, batch(7))
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        params, opt, _ = trainer._step_fn(params, opt, batch(6))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    split = {name: pairs[-1][0].elapsed_time(pairs[-1][1])
             for name, pairs in spans.items()}
    rows = [(e.self_device_time_total / 1e3, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith(("ProfilerStep", "train."))]
    log(f"[train-profile] one step, profiler on: wall {wall_ms:.1f} ms; "
        "CUDA-event spans " + ", ".join(
            f"{n} {ms:.1f} ms ({100 * ms / wall_ms:.1f}%)"
            for n, ms in split.items()))
    if not rows:
        log("[train-profile] the profiler saw no device time: busy share "
            "not measured")
        return
    busy = sum(r[0] for r in rows)
    gemm = sum(r[0] for r in rows if _is_gemm(r[1]))
    share = busy / wall_ms
    log(f"[train-profile] device busy {busy:.1f} ms ({100 * share:.1f}% of "
        f"wall), idle {100 * (1 - share):.1f}%; GEMMs {gemm:.1f} ms "
        f"({100 * gemm / busy:.1f}% of busy)")
    for ms, name, count in sorted(rows, reverse=True)[:8]:
        log(f"[train-profile]   {ms:9.3f} ms  x{count:<5d} {name[:90]}")


def _checkpoint_full_width(params) -> None:
    """A blocking ``CheckpointManager.save`` of ``{"params"}`` to a
    temporary directory, a restore onto the card held bitwise equal, and
    the legacy loader's ``SegfaultError`` on the same image."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager, load_tree
    from repro_torch.core.gofer import Gofer
    from repro_torch.core.loader import SegfaultError
    from repro_torch.tree import tree_leaves

    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(Gofer.for_root("ckpt", d, write=True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(TRAIN_STEPS, {"params": params}, blocking=True)
        save_s = time.perf_counter() - t0
        blob_bytes = mgr.save_log[-1]["bytes"]
        t0 = time.perf_counter()
        step, tree, _ = mgr.restore_latest({"params": params}, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        equal = all(torch.equal(a, b) for a, b in
                    zip(tree_leaves(tree["params"]), tree_leaves(params)))
        del tree
        if step != TRAIN_STEPS or not equal:
            raise AssertionError(f"restore of step {step} is not bitwise "
                                 "equal to the saved parameters")
        blob = mgr.gofer.read_bytes("ckpt", f"step_{TRAIN_STEPS:08d}.self")
        t0 = time.perf_counter()
        try:
            load_tree(blob, semantics="legacy")
        except SegfaultError as e:
            legacy = f"{type(e).__name__} in {time.perf_counter() - t0:.1f}s"
        else:
            raise AssertionError("the legacy loader restored the checkpoint")
        del blob
    log(f"[train-ckpt] {{params}} {nbytes / 1e9:.2f} GB in a "
        f"{blob_bytes / 1e9:.2f} GB SELF image: blocking save {save_s:.1f}s "
        f"({nbytes / 1e9 / save_s:.2f} GB/s, card to file), restore onto "
        f"the card {restore_s:.1f}s ({nbytes / 1e9 / restore_s:.2f} GB/s), "
        f"bitwise equal; legacy semantics: {legacy}")


#: part (d): (b)'s cell stepped under each remat policy, and the two
#: recurrent families at their published widths, one layer each, batch 1
#: of 2048 tokens (64-token chunks: 32 boundary states a scan)
REMAT_STEPS = 3
REMAT_GRAD_REL = 1e-3
#: bytes the memory allocated before a step may grow by over the steps
REMAT_GROWTH = 1e9
REMAT_SCAN_LAYERS, REMAT_SCAN_S = 1, 2048


def _remat_step(cfg, policy: str, batches, steps_n: int, ref=None,
                during=None) -> dict:
    """``steps_n`` steps of ``make_train_step`` on ``cfg``'s model built
    with ``remat=policy`` (random weights, seed 0) over ``batches``: the
    step-0 loss and gradients (held to ``ref``'s, a run under another
    policy, where given: the largest relative L2 of a leaf), the step
    times, the peak memory of steps 1.. (of step 0 for one step), the
    kernels' launches.  ``during``: a context for the steps."""
    import repro_torch.launch.steps as steps
    from repro_torch.models import build_model
    from repro_torch.models.common import param_tree
    from repro_torch.optim import ScheduleConfig, adamw_init
    from repro_torch.tree import tree_flatten_with_path

    model = build_model(cfg, device="cuda", remat=policy)
    model.init(torch.Generator("cuda").manual_seed(0))
    params = param_tree(model)
    opt = adamw_init(params)
    # as Trainer steps (b)'s cell: the state updated in place
    step = steps.make_train_step(model, ScheduleConfig(
        peak_lr=3e-3, warmup_steps=1, decay_steps=100), donate=True)
    out = {"policy": policy, "times": [], "before": []}
    real_update = steps.adamw_update

    def update(grads, *a, **kw):
        if "grads" not in out:
            named = [(".".join(map(str, p)), g)
                     for p, g in tree_flatten_with_path(grads)]
            _check_grads(named)
            if ref is None:
                out["grads"] = [(n, g.to("cpu")) for n, g in named]
            else:
                rels, out["equal"] = [], 0
                for (n, g), (_, w) in zip(named, ref["grads"]):
                    w = w.to(g.device)
                    out["equal"] += torch.equal(g, w)
                    rels.append((float((g.float() - w.float()).norm()
                                       / w.float().norm().clamp_min(1e-30)),
                                 n))
                out["grads"] = max(rels)
        return real_update(grads, *a, **kw)

    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    steps.adamw_update = update
    torch.cuda.reset_peak_memory_stats()
    try:
        with during or contextlib.nullcontext():
            for i in range(steps_n):
                torch.cuda.synchronize()
                out["before"].append(torch.cuda.memory_allocated())
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batches[i])
                torch.cuda.synchronize()
                out["times"].append(time.perf_counter() - t0)
                if i == 0:
                    out["loss"] = metrics["loss"].item()
                    if steps_n > 1:
                        torch.cuda.reset_peak_memory_stats()
    finally:
        steps.adamw_update = real_update
    out["peak"] = torch.cuda.max_memory_allocated()
    out["launches"] = {n: fn.launches for n, fn in counters.items()}
    if any(out["launches"].values()):
        raise AssertionError(f"{policy}: training launched "
                             f"{out['launches']}")
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"{policy}: step-0 loss {out['loss']}")
    # the state is updated in place: what a step leaves allocated (a
    # reference cycle holding its gradients, say) would pile up
    if max(out["before"]) > out["before"][0] + REMAT_GROWTH:
        raise AssertionError(f"{policy}: allocated before each step "
                             f"{out['before']}")
    del model, params, opt, step
    _free_card()
    return out


def _remat_against(tag: str, run: dict, ref: dict, tokens: int) -> None:
    """Logs ``run`` beside ``ref`` and fails where its step-0 loss or a
    gradient departs from ``ref``'s."""
    rel, leaf = run["grads"]
    med = float(np.median(run["times"][1:] or run["times"]))
    log(f"[train-remat] {tag} remat={run['policy']}: step-0 loss "
        f"{run['loss']:.6f} ({'equal to' if run['loss'] == ref['loss'] else 'against'} "
        f"{ref['policy']}'s {ref['loss']:.6f}); gradients against "
        f"{ref['policy']}'s: {run['equal']} of {len(ref['grads'])} leaves "
        f"bit-equal, largest relative L2 {rel:.3g} ({leaf}); step times "
        f"{[round(t, 4) for t in run['times']]} s, median "
        f"{med * 1e3:.1f} ms, {tokens / med:.0f} tokens/s; peak "
        f"{run['peak'] / 1e9:.2f} GB (max_memory_allocated"
        f"{' of steps 1..' if len(run['times']) > 1 else ''}; allocated "
        f"before each step {[round(b / 1e9, 2) for b in run['before']]} "
        "GB)")
    if not np.isclose(run["loss"], ref["loss"], rtol=1e-6, atol=0):
        raise AssertionError(f"{tag} remat={run['policy']}: step-0 loss "
                             f"{run['loss']} against {ref['loss']}")
    if rel > REMAT_GRAD_REL:
        raise AssertionError(f"{tag} remat={run['policy']}: gradient of "
                             f"{leaf} {rel:.3g} from {ref['policy']}'s")


@contextlib.contextmanager
def _scan_saves(record: list):
    """Each ``ssm_scan`` call of the hybrid inside the block run under a
    ``saved_tensors_hooks`` pair that records the (shape, bytes) of what
    autograd keeps for its backward (outside any layer checkpoint, whose
    own hooks would take the tensors first)."""
    import repro_torch.models.hybrid as hybrid

    real = hybrid.ssm_scan

    def pack(t):
        record.append((tuple(t.shape), t.numel() * t.element_size()))
        return t

    def scan(*a, **kw):
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return real(*a, **kw)

    hybrid.ssm_scan = scan
    try:
        yield
    finally:
        hybrid.ssm_scan = real


def _train_remat() -> dict:
    """Part (d): the remat policies on the card.  Returns the kernels'
    launches (none)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM

    t_start = time.perf_counter()
    total = {name: 0 for name in _launch_counters()}

    def batches(cfg, B, S, n):
        data = SyntheticLM(DataConfig(global_batch=B, seq_len=S,
                                      vocab_size=cfg.vocab_size))
        return [{k: torch.from_numpy(v).cuda()
                 for k, v in data.batch_at(i).items()} for i in range(n)]

    def add(run):
        for name, n in run["launches"].items():
            total[name] += n
        return run

    # gemma2-9b: (b)'s weights (seed 0) and batches
    cfg = dataclasses.replace(get_config("gemma2-9b"),
                              num_layers=SERVE_LAYERS)
    bs = batches(cfg, TRAIN_B, TRAIN_S, REMAT_STEPS)
    full = add(_remat_step(cfg, "full", bs, REMAT_STEPS))
    med = float(np.median(full["times"][1:]))
    log(f"[train-remat] gemma2-9b x{SERVE_LAYERS} layers bf16, "
        f"B={TRAIN_B} S={TRAIN_S} (depth cut 42 -> {SERVE_LAYERS}): "
        f"remat=full step-0 loss {full['loss']:.6f}; step times "
        f"{[round(t, 4) for t in full['times']]} s, median "
        f"{med * 1e3:.1f} ms, {TRAIN_B * TRAIN_S / med:.0f} tokens/s; peak "
        f"{full['peak'] / 1e9:.2f} GB (max_memory_allocated of steps 1..; "
        f"allocated before each step "
        f"{[round(b / 1e9, 2) for b in full['before']]} GB)")
    for policy in ("dots", "none"):
        run = add(_remat_step(cfg, policy, bs, REMAT_STEPS, ref=full))
        _remat_against(f"gemma2-9b x{SERVE_LAYERS}", run, full,
                       TRAIN_B * TRAIN_S)
    del full, bs

    # hymba-1.5b: the SSM scan's chunk checkpoints
    cfg = dataclasses.replace(get_config("hymba-1.5b"),
                              num_layers=REMAT_SCAN_LAYERS)
    bs = batches(cfg, 1, REMAT_SCAN_S, 1)
    full = add(_remat_step(cfg, "full", bs, 1))
    saved: list = []
    none = add(_remat_step(cfg, "none", bs, 1, ref=full,
                           during=_scan_saves(saved)))
    di = cfg.ssm_d_inner or 2 * cfg.d_model
    state = (1, di, cfg.ssm_state_size)
    state_bytes = 4 * math.prod(state)
    states = sum(1 for shape, _ in saved if shape == state)
    chunks = -(-REMAT_SCAN_S // 64)
    log(f"[train-remat] hymba-1.5b x{REMAT_SCAN_LAYERS} of 32 layers bf16, "
        f"B=1 S={REMAT_SCAN_S}: remat=full step {full['times'][0] * 1e3:.1f}"
        f" ms, peak {full['peak'] / 1e9:.2f} GB; the SSM scan under "
        f"remat=none kept {sum(b for _, b in saved) / 1e6:.2f} MB for its "
        f"backward in {len(saved)} tensors, {states} of them states "
        f"{state} ({states * state_bytes / 1e6:.2f} MB; one per 64-token "
        f"chunk: {chunks}, {chunks * state_bytes / 1e6:.2f} MB; one per "
        f"token would be {REMAT_SCAN_S * state_bytes / 1e6:.1f} MB)")
    _remat_against(f"hymba-1.5b x{REMAT_SCAN_LAYERS}", none, full,
                   REMAT_SCAN_S)
    if states != chunks:
        raise AssertionError(f"the SSM scan kept {states} states, not one "
                             f"per chunk ({chunks})")
    del full, none, bs

    # rwkv6-3b: the WKV6 scan's chunk checkpoints under the layer's
    cfg = dataclasses.replace(get_config("rwkv6-3b"),
                              num_layers=REMAT_SCAN_LAYERS)
    run = add(_remat_step(cfg, "full", batches(cfg, 1, REMAT_SCAN_S, 1), 1))
    log(f"[train-remat] rwkv6-3b x{REMAT_SCAN_LAYERS} of 32 layers bf16, "
        f"B=1 S={REMAT_SCAN_S}: one step {run['times'][0] * 1e3:.1f} ms, "
        f"loss {run['loss']:.6f}, peak {run['peak'] / 1e9:.2f} GB; part (d) "
        f"took {time.perf_counter() - t_start:.1f} s")
    return total


def phase_training() -> dict:
    """Card against CPU for each family (3 fp32 steps, one more run with
    ``accum_steps=2``), recovery on the card, full-width gemma2-9b
    training with its checkpoint, then the remat policies (part (d)).
    Returns the kernels' launches (none)."""
    total = {name: 0 for name in _launch_counters()}
    cells = _train_cells()
    runs = [(tag, cfg, seq, 1) for tag, cfg, seq in cells]
    runs.append(cells[0][:3] + (2,))
    for tag, cfg, seq, accum in runs:
        for name, n in _train_card_vs_cpu(tag, cfg, seq, accum).items():
            total[name] += n
    _train_recovery_card()
    _free_card()
    for name, n in _train_full_width().items():
        total[name] += n
    _free_card()
    for name, n in _train_remat().items():
        total[name] += n
    return total


# --------------------------------------------------------------- phase 16

#: the train lane: gemma2-9b at its published widths, 4 of 42 layers, bf16,
#: global batch 2 of 1024 tokens, 6 steps
ORCH_TRAIN_LAYERS, ORCH_TRAIN_B, ORCH_TRAIN_STEPS = 4, 2, 6
#: the train lane's losses against a direct run of the same seed, per step
ORCH_TRAIN_RTOL = 1e-5
#: batch jobs: each hashes ORCH_CHUNK_BYTES on the host (the hash drops the
#: GIL) ORCH_CHUNKS times, a cooperative checkpoint before each, then one
#: 256 x 256 bf16 matmul on the card
ORCH_JOBS, ORCH_CHUNKS, ORCH_CHUNK_BYTES = 8, 12, 4 * 2 ** 20
#: the replica set's virtual clock: a step, the heartbeat timeout, and
#: the kill, about halfway through the first requests' decode
REPLICA_STEP_S, REPLICA_HEARTBEAT_S, REPLICA_KILL_T = 0.01, 0.05, 0.15


@contextlib.contextmanager
def _greedy_rows(rows: dict):
    """Inside the block, every logits row the engine samples a greedy token
    from, by (request seed, token index): what a fork's margin is read
    from."""
    import repro_torch.runtime.serve_loop as serve_loop

    real = serve_loop.sample_token

    def spy(logits, **kw):
        if kw.get("temperature", 0.0) <= 0:
            rows[(kw["seed"], kw["index"])] = np.array(logits, np.float32)
        return real(logits, **kw)

    serve_loop.sample_token = spy
    try:
        yield
    finally:
        serve_loop.sample_token = real


def _judge_greedy(tag: str, want, got, rows: dict) -> str:
    """Greedy streams of ``got`` against ``want`` (same requests): raises
    unless each fork lies where ``want``'s top-2 logit margin at the fork
    is under ``CLEAR_MARGIN``; logs every fork and returns a summary."""
    forks, clear, greedy = [], [], 0
    for a, b in zip(want, got):
        if a.temperature > 0:
            continue
        greedy += 1
        j = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                  if x != y), None)
        if j is None:
            continue
        top2 = np.sort(rows[(a.seed, j)].astype(np.float64))[-2:]
        margin = top2[1] - top2[0]
        log(f"[{tag}] request {a.request_id} forks at token {j} (want "
            f"{a.tokens[j]}, got {b.tokens[j]}): top-2 logit margin "
            f"{margin:.3g} where it was sampled")
        forks.append(a.request_id)
        if margin >= CLEAR_MARGIN:
            clear.append(a.request_id)
    if clear:
        raise AssertionError(f"[{tag}] greedy streams fork at clear margins "
                             f"(requests {clear})")
    sampled = sum(a.tokens == b.tokens for a, b in zip(want, got)
                  if a.temperature > 0)
    return (f"{greedy - len(forks)} of {greedy} greedy streams equal"
            + (f", forks {forks} under {CLEAR_MARGIN}" if forks else "")
            + f"; {sampled} of {len(want) - greedy} sampled equal")


def _orch_requests(cfg):
    """Phase 4's 8 requests (the last sharing the first's 512-token
    prefix), two per tenant."""
    reqs = _serving_requests(cfg.vocab_size, SERVE_LENGTHS)
    reqs[7].prompt[:512] = reqs[0].prompt[:512]
    for r in reqs:
        r.tenant = f"t{r.request_id // 2}"
    return reqs


def _paged_counts(engine) -> tuple:
    """(decode steps, full prefills) of ``engine`` so far: a prefill that
    found a shared prefix runs the suffix without K2."""
    st = engine.serving_stats()
    return (st["decode_steps_total"],
            st["prefill_sequences_total"]["incremental"]
            - st["prefix_hits_total"])


def _paged_launch_check(tag, engines, launches, layers, bases=None) -> tuple:
    """K1 = decode steps x layers and K2 = full prefills x layers over
    ``engines`` since ``bases`` (their ``_paged_counts`` before the run),
    K3 = K4 = 0; returns (decode steps, full prefills)."""
    steps = prefills = 0
    for i, e in enumerate(engines):
        n_steps, n_prefills = _paged_counts(e)
        b_steps, b_prefills = bases[i] if bases else (0, 0)
        steps += n_steps - b_steps
        prefills += n_prefills - b_prefills
    want = {"paged_attention": steps * layers,
            "flash_attention": prefills * layers, "wkv6": 0,
            "segment_zero": 0}
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, want {want} "
                             f"({steps} decode steps, {prefills} full "
                             f"prefills x {layers} layers)")
    return steps, prefills


def _check_done_once(tag, engine_completed, reqs, vocab) -> None:
    ids = [r.request_id for r in engine_completed]
    if sorted(ids) != sorted(r.request_id for r in reqs):
        raise AssertionError(f"[{tag}] completed {sorted(ids)}, not each of "
                             f"{len(reqs)} requests exactly once")
    _check_outputs(reqs, vocab)


def _timed_steps(engine):
    """Wraps ``engine.step``: per call (host seconds, ran a prefill,
    tokens produced)."""
    real, out = engine.step, []

    tokens = lambda: sum(engine.serving_stats()["tokens_total"].values())

    def step():
        before = sum(engine.prefill_counts().values())
        n = tokens()
        t = time.perf_counter()
        done = real()
        dt = time.perf_counter() - t
        out.append((dt, sum(engine.prefill_counts().values()) != before,
                    tokens() - n))
        return done

    engine.step = step
    return out


def _decode_rate(steps) -> tuple:
    """(tokens/s, median ms, max ms) over the steps that ran no prefill."""
    dec = [(dt, n) for dt, pre, n in steps if not pre and n]
    s = sum(dt for dt, _ in dec)
    ms = [dt * 1e3 for dt, _ in dec]
    return sum(n for _, n in dec) / s, float(np.median(ms)), max(ms)


def _train_lane(tcfg, model, seed: int = 0):
    """A fresh ``Trainer`` (its own loader) at ``ORCH_TRAIN_*`` on ``model``
    from ``init_state(seed)``, and its stepper, whose ``step_once`` is
    timed: (trainer, stepper, step seconds)."""
    from repro_torch.data import DataConfig, Loader, SyntheticLM
    from repro_torch.optim import ScheduleConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    dc = DataConfig(global_batch=ORCH_TRAIN_B, seq_len=TRAIN_S,
                    vocab_size=tcfg.vocab_size)
    trainer = Trainer(model, Loader(SyntheticLM(dc), dc), TrainerConfig(
        total_steps=ORCH_TRAIN_STEPS, log_every=1, ckpt_every=10 ** 9,
        schedule=ScheduleConfig(peak_lr=3e-3, warmup_steps=1,
                                decay_steps=100)))
    stepper = trainer.stepper(*trainer.init_state(seed))
    real, times = stepper.step_once, []

    def step_once():
        t = time.perf_counter()
        row = real()
        times.append(time.perf_counter() - t)
        return row

    stepper.step_once = step_once
    return trainer, stepper, times


def _nondeterministic_ops(tcfg) -> str:
    """The ops PyTorch names as not deterministic on CUDA in one training
    step of the train lane's family (the reduced config, bf16), from
    ``use_deterministic_algorithms(warn_only=True)``."""
    import warnings

    from repro_torch.configs import get_reduced

    cfg = dataclasses.replace(get_reduced(tcfg.arch_id), dtype="bfloat16")
    from repro_torch.models import build_model

    model = build_model(cfg, device="cuda")
    trainer, stepper, _ = _train_lane(cfg, model)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            stepper.step_once()
    finally:
        torch.use_deterministic_algorithms(False)
        trainer.loader.stop()
    names = sorted({str(w.message).split(" does not have a deterministic")[0]
                    for w in caught if "deterministic" in str(w.message)})
    return "; ".join(names) or "none reported"


def _batch_job(j: int):
    import hashlib

    from repro_torch.core.tasks import checkpoint

    blob = bytes(range(256)) * (ORCH_CHUNK_BYTES // 256)

    def body():
        digest = b""
        for _ in range(ORCH_CHUNKS):
            checkpoint()
            digest = hashlib.sha256(blob + digest).digest()
        x = torch.full((256, 256), 1.0 + j, dtype=torch.bfloat16,
                       device="cuda")
        return (x @ x)[0, 0]

    return body


def _lanes(model, cfg, tcfg, tmodel, alone: dict) -> dict:
    """Part (a): decode, train and batch lanes on one 2-worker pool."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ServerlessScheduler, ThreadExecutor
    from repro_torch.core.metrics import MetricsRegistry
    from repro_torch.runtime import ElasticAutoscaler, WorkloadOrchestrator
    from repro_torch.runtime.elastic import AutoscalerConfig

    engine = alone["engine"]
    trainer, stepper, train_times = _train_lane(tcfg, tmodel)
    ex = ThreadExecutor()
    sched = ServerlessScheduler(workers=2, executor=ex)
    auto = ElasticAutoscaler(sched, serving=engine, cfg=AutoscalerConfig(
        min_workers=2, max_workers=3))
    orch = WorkloadOrchestrator(sched, serving=engine, stepper=stepper,
                                autoscaler=auto)
    steps = _timed_steps(engine)
    reqs = _orch_requests(cfg)
    base = [_paged_counts(engine)]
    counters = _launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    for r in reqs:
        engine.submit(r)
    jobs = [orch.submit_batch(_batch_job(j), name=f"batch{j}")
            for j in range(ORCH_JOBS)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        try:
            orch.drain(timeout=600)
            sched.drain(timeout=60)
        finally:
            sched.shutdown()
            trainer.loader.stop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    del engine.step                    # the class's again
    stats = engine.serving_stats()
    engine.flush_prefix_cache()
    stats_after = engine.serving_stats()

    _check_done_once("orch", engine.completed, reqs, cfg.vocab_size)
    _check_ledgers(engine, stats_after)
    dec_steps, prefills = _paged_launch_check("orch", [engine], launches,
                                              cfg.num_layers, base)
    streams = _judge_greedy("orch", alone["reqs"], reqs, alone["rows"])
    if peak > TRAIN_PEAK_LIMIT:
        raise AssertionError(f"[orch] peak {peak / 1e9:.2f} GB with both "
                             "lanes resident")
    # the train lane against the direct run of the same seed
    losses = [r["loss"] for r in trainer.metrics_log]
    want = alone["losses"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    if len(losses) != ORCH_TRAIN_STEPS or gap > ORCH_TRAIN_RTOL:
        raise AssertionError(f"[orch] train losses {losses} against the "
                             f"direct run's {want}")
    bitwise = losses == want
    # the batch lane and the orchestrator's books
    if not all(j.state == "done" for j in jobs):
        raise AssertionError(f"[orch] batch jobs {[(j.name, j.state) for j in jobs]}")
    for j, job in enumerate(jobs):
        rec = sched.record(job.task_id)
        value = float(rec.result.value)
        if value != 256 * (1.0 + j) ** 2:
            raise AssertionError(f"[orch] {job.name} returned {value}")
    ost = orch.orchestrator_stats()
    decode_recs = [r for r in sched.records()
                   if r.spec.tenant == orch.cfg.serving_tenant]
    done_recs = [r for r in decode_recs if r.state.name == "SUCCEEDED"]
    want_stats = {
        "train_steps": ORCH_TRAIN_STEPS, "serving_step_failures": 0,
        "train_step_failures": 0, "batch_jobs_submitted": ORCH_JOBS,
        "batch_jobs_done": ORCH_JOBS, "batch_jobs_failed": 0,
        "serving_steps": len(done_recs),
        "preemptions_total": sum(j.preemptions for j in jobs),
        "batch_resubmits_total": sum(j.resubmits for j in jobs),
        "workers_active": sched.active_worker_count()}
    off = {k: (ost[k], v) for k, v in want_stats.items() if ost[k] != v}
    engine_steps = sum(int(r.result.value) for r in done_recs)
    if off or engine_steps != len(steps) or stepper.step != ORCH_TRAIN_STEPS:
        raise AssertionError(f"[orch] stats {ost} off by {off}; engine "
                             f"steps {engine_steps} vs {len(steps)} timed")
    if ost["preemptions_total"] < 1:
        raise AssertionError("[orch] the decode lane preempted no batch job")
    reg = MetricsRegistry().register_orchestrator(orch).register_elastic(auto)
    text = reg.render()
    families = ("seepp_orchestrator_ticks_total",
                "seepp_orchestrator_serving_steps_total",
                "seepp_orchestrator_train_steps_total",
                "seepp_orchestrator_batch_jobs_done_total",
                "seepp_orchestrator_preemptions_total",
                "seepp_orchestrator_class_queue_depth",
                "seepp_elastic_workers_active",
                "seepp_elastic_decisions_total",
                "seepp_elastic_pool_healthy_devices")
    missing = [f for f in families if f not in text]
    if missing:
        raise AssertionError(f"[orch] /metrics lacks {missing}")
    dump = reg.dump()
    if dump["seepp_orchestrator_batch_jobs_done_total"][""] != ORCH_JOBS:
        raise AssertionError("[orch] /metrics batch jobs done "
                             f"{dump['seepp_orchestrator_batch_jobs_done_total']}")
    rows = [(e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = (f"{100 * sum(rows) / (wall * 1e3):.1f}% busy "
            f"({sum(rows):.1f} ms of device time in {wall * 1e3:.1f} ms)"
            if rows else "busy share not measured (the profiler saw no "
            "device time)")
    decisions = {}
    for d in auto.decisions:
        decisions[d.action] = decisions.get(d.action, 0) + 1
    rate, med, mx = _decode_rate(steps)
    a_rate, a_med, a_mx = alone["rate"]
    t_med = float(np.median(train_times[1:]))
    a_t_med = float(np.median(alone["train_times"][1:]))
    log(f"[orch] lanes on one pool (2 workers, autoscaler 2..3): 8 requests "
        f"done once each, {dec_steps} decode steps, {prefills} full "
        f"prefills, launches {launches}; pages allocated "
        f"{stats['kv_pages_allocated_total']} == freed "
        f"{stats_after['kv_pages_freed_total']} (cumulative), slot ledger "
        f"balanced; {streams} against the engine alone")
    log(f"[orch] train lane: {ORCH_TRAIN_STEPS} steps, losses "
        f"{[round(x, 5) for x in losses]}, largest relative gap to the "
        f"direct run {gap:.3g} (tol {ORCH_TRAIN_RTOL:g}), "
        + ("bit for bit" if bitwise else "not bit for bit: ops PyTorch "
           f"flags as not deterministic: {_nondeterministic_ops(tcfg)}")
        + f"; peak memory with both lanes {peak / 1e9:.2f} GB (limit "
        f"{TRAIN_PEAK_LIMIT / 1e9:.0f} GB)")
    log(f"[orch] batch lane: {ORCH_JOBS} jobs SUCCEEDED, preemptions "
        f"{ost['preemptions_total']}, resubmits "
        f"{ost['batch_resubmits_total']}; orchestrator_stats {ost}; "
        f"autoscaler decisions {decisions}; /metrics renders "
        f"{len(families)} families")
    log(f"[orch] decode {rate:.1f} tokens/s co-located vs {a_rate:.1f} "
        f"alone; decode step median {med:.2f} ms, max {mx:.2f} ms "
        f"co-located vs {a_med:.2f} / {a_mx:.2f} ms alone; train step median "
        f"{t_med * 1e3:.1f} ms co-located vs {a_t_med * 1e3:.1f} ms alone; "
        f"preemptions {ost['preemptions_total']}; autoscaler {decisions}; "
        f"card {busy} over the co-located window of {wall:.2f} s")
    return launches


def _decode_alone(model, cfg) -> dict:
    """Phase 4's requests on the engine alone, through the orchestrator's
    decode lane on the same pool shape: the reference streams, the greedy
    rows they were sampled from, and the decode rate."""
    from repro_torch.core import ServerlessScheduler, ThreadExecutor
    from repro_torch.runtime import (ServerConfig, ServingEngine,
                                     WorkloadOrchestrator)

    ex = ThreadExecutor()
    engine = ServingEngine(model, ServerConfig(
        max_batch=4, max_seq=4096, prefix_cache_seqs=4), executor=ex)
    if engine.kv_mode != "paged":
        raise AssertionError(f"served in {engine.kv_mode} mode, not paged")
    _warm_up(engine)
    sched = ServerlessScheduler(workers=2, executor=ex)
    orch = WorkloadOrchestrator(sched, serving=engine)
    steps = _timed_steps(engine)
    reqs, rows = _orch_requests(cfg), {}
    base = [_paged_counts(engine)]
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    for r in reqs:
        engine.submit(r)
    with _greedy_rows(rows):
        try:
            orch.drain(timeout=600)
        finally:
            sched.shutdown()
    launches = {name: fn.launches for name, fn in counters.items()}
    del engine.step                    # the class's again
    _check_done_once("orch-alone", engine.completed, reqs, cfg.vocab_size)
    _paged_launch_check("orch-alone", [engine], launches, cfg.num_layers,
                        base)
    engine.flush_prefix_cache()
    _check_ledgers(engine, engine.serving_stats())
    engine.reset_history()
    return {"engine": engine, "reqs": reqs, "rows": rows,
            "rate": _decode_rate(steps), "launches": launches}


def _replica_run(model, cfg, plan=None) -> tuple:
    """Part (b): phase 4's requests on a ``ReplicaSet`` of 2 engines over
    ``model`` on one ``SimExecutor``, under ``plan`` (armed through
    ``FailureInjector.arm_replicas``): (set, requests, launches, wall s,
    reap times on the virtual clock)."""
    from repro_torch.core.sim import SimExecutor
    from repro_torch.runtime import (FailureInjector, ReplicaSet,
                                     ServerConfig, ServingEngine)

    ex = SimExecutor(seed=0)
    engines = [ServingEngine(model, ServerConfig(
        max_batch=4, max_seq=4096, prefix_cache_seqs=4,
        step_time_s=REPLICA_STEP_S), executor=ex) for _ in range(2)]
    rs = ReplicaSet(engines, heartbeat_timeout_s=REPLICA_HEARTBEAT_S)
    reaps, real_reap = [], rs._reap

    def reap(idx):
        reaps.append((idx, ex.now()))
        return real_reap(idx)

    rs._reap = reap
    if plan:
        FailureInjector(**plan).arm_replicas(ex, rs)
    reqs = _orch_requests(cfg)
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        rs.submit(r)
    rs.drain(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    return rs, reqs, launches, wall, reaps


def _replicas(model, cfg) -> dict:
    rows = {}
    with _greedy_rows(rows):
        base_rs, base, launches, wall, _ = _replica_run(model, cfg)
    total = dict(launches)
    _paged_launch_check("replica", base_rs.replicas, launches,
                        cfg.num_layers)
    _check_done_once("replica", base_rs.completed, base, cfg.vocab_size)
    log(f"[replica] undisturbed: 2 replicas, requests "
        f"{[[r.request_id for r in e.completed] for e in base_rs.replicas]}"
        f", {sum(len(r.tokens) for r in base) / wall:.1f} tokens/s")
    for name, plan in (
            ("kill_replica", {"kill_replica_at_t": {REPLICA_KILL_T: [0]}}),
            ("kill_mesh_member",
             {"kill_mesh_member_at_t": {REPLICA_KILL_T: [0]}})):
        rs, reqs, launches, wall, reaps = _replica_run(model, cfg, plan)
        _check_done_once(f"replica {name}", rs.completed, reqs,
                         cfg.vocab_size)
        steps, prefills = _paged_launch_check(
            f"replica {name}", rs.replicas, launches, cfg.num_layers)
        for k, v in launches.items():
            total[k] += v
        survivor = rs.replicas[1]
        survivor.flush_prefix_cache()
        for i, e in enumerate(rs.replicas):
            if e.kv.pages_allocated != e.kv.pages_freed or \
                    e.admission.slot_balance() or e.kv.live_pages():
                raise AssertionError(
                    f"[replica {name}] replica {i}: pages allocated "
                    f"{e.kv.pages_allocated} freed {e.kv.pages_freed}, "
                    f"slots {e.admission.slot_balance()}")
        st = rs.replica_stats()
        if not rs.replicas[0].dead or st["rehomed_total"] < 1 or \
                st["orphaned"] or len(reaps) != 1:
            raise AssertionError(f"[replica {name}] {st}, reaps {reaps}")
        streams = _judge_greedy(f"replica {name}", base, reqs, rows)
        gap = reaps[0][1] - REPLICA_KILL_T
        log(f"[replica] {name} replica 0 at t={REPLICA_KILL_T}s: kills "
            f"{st['replica_kills']}, mesh kills {st['mesh_member_kills']}, "
            f"heartbeat reaps {st['heartbeat_reaps']}, re-homed "
            f"{st['rehomed_total']}, death to reap {gap:.3f}s on the virtual "
            f"clock (heartbeat timeout {REPLICA_HEARTBEAT_S}s); all 8 done "
            f"once; survivor pages allocated {survivor.kv.pages_allocated} "
            f"== freed {survivor.kv.pages_freed}; {streams} against the "
            f"undisturbed run (re-homed requests re-prefill prompt + "
            f"generated tokens); launches K1 {launches['paged_attention']} "
            f"= {steps} decode steps x {cfg.num_layers}, K2 "
            f"{launches['flash_attention']} = {prefills} full prefills x "
            f"{cfg.num_layers}; {sum(len(r.tokens) for r in reqs) / wall:.1f}"
            f" tokens/s ({wall:.2f}s wall)")
    return total


def phase_orchestration() -> dict:
    """Phase 16: (a) decode, train and batch lanes on one pool; (b) a
    two-replica set re-homing after a loud and a silent kill."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("qwen2.5-32b"),
                              num_layers=SERVE_LAYERS)
    model = _model_on_card(cfg, "orch", " (of 64)")
    tcfg = dataclasses.replace(get_config("gemma2-9b"),
                               num_layers=ORCH_TRAIN_LAYERS)
    tmodel = build_model(tcfg, device="cuda")
    alone = _decode_alone(model, cfg)
    total = dict(alone["launches"])
    trainer, stepper, times = _train_lane(tcfg, tmodel)
    try:
        while not stepper.done():
            stepper.step_once()
    finally:
        trainer.loader.stop()
    alone["losses"] = [r["loss"] for r in trainer.metrics_log]
    alone["train_times"] = times
    n_params = sum(t.numel() for t in tmodel.parameters())
    log(f"[orch] train lane {tcfg.arch_id} x{ORCH_TRAIN_LAYERS} layers bf16 "
        f"({n_params / 1e9:.2f}B params), B={ORCH_TRAIN_B} S={TRAIN_S}: "
        f"direct run losses {[round(x, 5) for x in alone['losses']]}, step "
        f"times {[round(t, 4) for t in times]} s")
    del trainer, stepper
    gc.collect()
    for name, n in _lanes(model, cfg, tcfg, tmodel, alone).items():
        total[name] += n
    del alone, tmodel
    _free_card()
    for name, n in _replicas(model, cfg).items():
        total[name] += n
    return total


# --------------------------------------------------------------- phase 17

# two ranks of each serving mesh on the one card (gloo: NCCL refuses two
# ranks on one GPU); the replica set's depth (its 4 workers hold ~20 GB)
TP_RANKS, TP_REPLICA_LAYERS = 2, 2
# the relative L2 distance allowed between a mesh engine's and a no-mesh
# engine's logits on the same inputs: bf16 partial products of wo summed
# over ranks round differently from one GEMM.  Sound runs on the H100 read
# at most 0.0152 (phase 4's model) and 0.0103 (the replica sets); with the
# wo sum dropped the same run reads 1.31, so 0.03 sits 2x above the one
# and 44x below the other
TP_LOGIT_REL = 3e-2


def _tp_mesh():
    from repro_torch.launch.mesh import make_serving_mesh

    return make_serving_mesh(["cuda:0"] * TP_RANKS)


def _tp_attention(mesh) -> None:
    """Part (a): ``paged_attention_sharded`` over the 2-rank mesh at phase
    3's K1 shapes (qwen2.5's 8 kv heads of 5, qwen3-moe's 4 of 16), bf16:
    bit-identical to the unsharded K1, within TOL of the plain version."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_sharded)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    hd, page, dtype = 128, 16, torch.bfloat16
    for B, K, G in ((4, 8, 5), (4, 4, 16)):
        q, kp, vp, table, lens = _paged_case(B, K, G, hd, page, dtype,
                                             seed=B if G == 5 else 1000 + G)
        scale = hd ** -0.5
        mesh.reset_counters()
        out = paged_attention_sharded(q, kp, vp, table, lens, scale=scale,
                                      mesh=mesh)
        ranks = [c["paged_attention"] for c in mesh.counters()]
        whole = paged_attention(q, kp, vp, table, lens, scale=scale)
        what = f"[tp-k1] B={B} K={K} G={G}"
        if not torch.equal(out, whole):
            raise AssertionError(f"{what}: sharded K1 differs from the "
                                 "unsharded K1")
        if ranks != [1] * TP_RANKS:
            raise AssertionError(f"{what}: K1 launches per rank {ranks}")
        err, share = compare(out, paged_attention_ref(
            q, kp, vp, table, lens, scale=scale), dtype, what)
        log(f"{what} hd={hd} bf16 over {TP_RANKS} ranks ({K // TP_RANKS} kv "
            f"heads each): bit-identical to the unsharded K1; against the "
            f"plain version max|err|={err:.3g} ({share:.3f} x "
            f"{tol_str(dtype)}); K1 launches per rank {ranks}")


def _tp_flash(mesh) -> None:
    """Part (a), K2: each rank runs K2 at its share of qwen2.5-32b's heads
    (a 2048-token causal prefill of 40 q / 8 kv heads of 128 over 2
    ranks: 20 / 4 each), bf16, as the prefills of part (b) run it; within
    TOL of the plain version, one K2 launch in each rank."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, S, K, G, hd, dtype = 1, 2048, 8, 5, 128, torch.bfloat16
    g = torch.Generator("cuda").manual_seed(S + K * G)
    q = torch.randn((B, S, K, G, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, K, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, K, hd), generator=g, device="cuda").to(dtype)
    kh, scale = K // TP_RANKS, hd ** -0.5
    heads = [slice(r * kh, (r + 1) * kh) for r in range(TP_RANKS)]
    mesh.reset_counters()
    outs = mesh.run("flash", [(q[:, :, h], k[:, :, h], v[:, :, h], 0,
                               scale, 0.0) for h in heads])
    ranks = [c["flash_attention"] for c in mesh.counters()]
    what = f"[tp-k2] B={B} S={S} H={kh * G} K={kh} hd={hd} bf16 causal"
    if ranks != [1] * TP_RANKS:
        raise AssertionError(f"{what}: K2 launches per rank {ranks}")
    for r, (h, out) in enumerate(zip(heads, outs)):
        if out.shape != q[:, :, h].shape:
            raise AssertionError(f"{what} rank {r}: shape "
                                 f"{tuple(out.shape)}")
        ref = flash_attention_ref(q[:, :, h].reshape(B, S, kh * G, hd),
                                  k[:, :, h], v[:, :, h], 0, scale=scale,
                                  causal=True)
        err, share = compare(out.reshape(B, S, kh * G, hd), ref, dtype,
                             f"{what} rank {r}")
        log(f"{what}, rank {r} (kv heads {h.start}-{h.stop - 1} of {K}): "
            f"against the plain version max|err|={err:.3g} ({share:.3f} x "
            f"{tol_str(dtype)}); K2 launches per rank {ranks}")


def _judge_tp(tag: str, want, got, rows_want: dict, rows_got: dict) -> str:
    """Greedy streams of a mesh run (``got``) against a no-mesh run's
    (``want``) on the same requests.  Up to each stream's first fork both
    ran on the same tokens, so their logits rows are compared there: the
    relative L2 distance must stay under ``TP_LOGIT_REL``, and a fork is
    allowed only where ``want``'s top-2 margin is under twice the largest
    logit difference at that row (a swap the difference can explain).
    Logs every fork; returns a summary."""
    worst, forks, clear, greedy = 0.0, [], [], 0
    for a, b in zip(want, got):
        if a.temperature > 0:
            continue
        greedy += 1
        j = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                  if x != y), None)
        for i in range(len(a.tokens) if j is None else j + 1):
            ra = rows_want[(a.seed, i)].astype(np.float64)
            rb = rows_got[(b.seed, i)].astype(np.float64)
            worst = max(worst, np.linalg.norm(ra - rb) / np.linalg.norm(ra))
        if j is None:
            continue
        ra = rows_want[(a.seed, j)].astype(np.float64)
        diff = np.abs(ra - rows_got[(b.seed, j)]).max()
        top2 = np.sort(ra)[-2:]
        margin = top2[1] - top2[0]
        log(f"[{tag}] request {a.request_id} forks at token {j} (want "
            f"{a.tokens[j]}, got {b.tokens[j]}): top-2 margin {margin:.3g}, "
            f"largest logit difference there {diff:.3g}")
        forks.append(a.request_id)
        if margin >= 2 * diff:
            clear.append(a.request_id)
    if worst > TP_LOGIT_REL or clear:
        raise AssertionError(
            f"[{tag}] logits {worst:.3g} apart in relative L2 (limit "
            f"{TP_LOGIT_REL:g}), forks at clear margins {clear}")
    sampled = sum(a.tokens == b.tokens for a, b in zip(want, got)
                  if a.temperature > 0)
    return (f"{greedy - len(forks)} of {greedy} greedy streams equal"
            + (f", forks {forks} within the logit difference"
               if forks else "")
            + f"; {sampled} of {len(want) - greedy} sampled equal; logits "
            f"at most {worst:.3g} apart (relative L2) before any fork")


def _tp_counts(tag, engine, mesh, base, layers) -> tuple:
    """Every rank of ``mesh`` launched K1 = decode steps x layers and K2 =
    full prefills x layers of ``engine`` since ``base`` (its
    ``_paged_counts``), K3 = K4 = 0: the launches summed over ranks."""
    steps, prefills = (n - b for n, b in zip(_paged_counts(engine), base))
    want = {"paged_attention": steps * layers,
            "flash_attention": prefills * layers, "wkv6": 0,
            "segment_zero": 0}
    ranks = mesh.counters()
    if any(c != want for c in ranks):
        raise AssertionError(f"[{tag}] launches per rank {ranks}, want "
                             f"{want} ({steps} decode steps, {prefills} "
                             f"full prefills x {layers} layers)")
    return {k: v * len(ranks) for k, v in want.items()}, steps, prefills


def _tp_serve(cfg, model, mesh) -> dict:
    """Part (b): phase 4's run on a no-mesh engine and on the 2-rank mesh
    over the same weights."""
    from repro_torch.runtime import ServerConfig, ServingEngine

    runs = {}
    for name in ("plain", "mesh"):
        engine = ServingEngine(model, ServerConfig(
            max_batch=4, max_seq=4096, prefix_cache_seqs=4),
            mesh=mesh if name == "mesh" else None)
        if engine.kv_mode != "paged":
            raise AssertionError(f"[tp-serve] {name}: {engine.kv_mode}")
        reqs = _orch_requests(cfg)
        _warm_up(engine)
        base = _paged_counts(engine)
        rows = {}
        if name == "mesh":
            mesh.reset_counters()
            mesh.memory(reset=True)
        with _greedy_rows(rows):
            run, launches, peak = _drive_counted(engine, reqs)
        engine.flush_prefix_cache()
        runs[name] = (engine, reqs, rows, run, launches, peak, base)
    engine, reqs, rows, run, launches, peak, base = runs["mesh"]
    _check_outputs(reqs, cfg.vocab_size)
    stats = engine.serving_stats()
    _check_ledgers(engine, stats)
    if engine.kv.live_pages() or stats["tp_shards"] != TP_RANKS:
        raise AssertionError(f"[tp-serve] live pages "
                             f"{engine.kv.live_pages()}, stats {stats}")
    if any(launches.values()):
        raise AssertionError(f"[tp-serve] the controller launched {launches}")
    total, steps, prefills = _tp_counts("tp-serve", engine, mesh, base,
                                        cfg.num_layers)
    if not steps or not prefills:
        raise AssertionError(f"[tp-serve] {steps} decode steps, {prefills} "
                             "full prefills on the mesh")
    plain = runs["plain"]
    verdict = _judge_tp("tp-serve", plain[1], reqs, plain[2], rows)
    ranks = [c["paged_attention"] for c in mesh.counters()]
    flash = [c["flash_attention"] for c in mesh.counters()]
    mem = mesh.memory()
    log(f"[tp-serve] {cfg.arch_id} x{cfg.num_layers} layers paged over "
        f"{TP_RANKS} ranks ({cfg.num_heads // TP_RANKS} q / "
        f"{cfg.num_kv_heads // TP_RANKS} kv heads each, G="
        f"{cfg.num_heads // cfg.num_kv_heads}): 8 requests done, tp_shards "
        f"{stats['tp_shards']}, live pages 0 after the drain; decode steps "
        f"{steps}, full prefills {prefills}; K1 launches per rank {ranks} = "
        f"{steps} x {cfg.num_layers}, K2 per rank {flash} = {prefills} x "
        f"{cfg.num_layers}; the controller launched none; {verdict}")
    note = (" -- two ranks time-sharing one card, gloo: not a TP speed")
    for name in ("plain", "mesh"):
        _, _, _, run, _, peak, _ = runs[name]
        _log_timings(f"tp-serve {name}", run, peak,
                     note if name == "mesh" else " (no mesh)")
    log(f"[tp-serve] mesh peak memory: controller {peak / 2**30:.2f} GiB, "
        f"ranks {[round(p / 2**30, 2) for _, p in mem]} GiB (allocated "
        f"{[round(a / 2**30, 2) for a, _ in mem]} GiB){note}")
    return total


def _tp_replica_run(model, cfg, meshes, plan=None) -> tuple:
    """Phase 4's requests on a ``ReplicaSet`` of 2 engines over ``model``
    on one ``SimExecutor`` (replica i on ``meshes[i]``, or whole-device
    with no meshes), under ``plan``: (set, requests, rows, launches, wall
    s)."""
    from repro_torch.core.sim import SimExecutor
    from repro_torch.runtime import (FailureInjector, ReplicaSet,
                                     ServerConfig, ServingEngine)

    ex = SimExecutor(seed=0)
    engines = [ServingEngine(model, ServerConfig(
        max_batch=4, max_seq=4096, prefix_cache_seqs=4,
        step_time_s=REPLICA_STEP_S), executor=ex,
        mesh=meshes[i] if meshes else None) for i in range(2)]
    rs = ReplicaSet(engines, heartbeat_timeout_s=REPLICA_HEARTBEAT_S)
    if plan:
        FailureInjector(**plan).arm_replicas(ex, rs)
    reqs, rows = _orch_requests(cfg), {}
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    for m in meshes:
        m.reset_counters()
    t0 = time.perf_counter()
    with _greedy_rows(rows):
        for r in reqs:
            rs.submit(r)
        rs.drain(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    return rs, reqs, rows, launches, wall


def _tp_replicas(cfg, model, meshes) -> dict:
    """Part (c): 2 replicas x 2 ranks on one card against a whole-device
    set, undisturbed and under both kills."""
    base_rs, base, base_rows, _, _ = _tp_replica_run(model, cfg, [])
    _check_done_once("tp-replica whole-device", base_rs.completed, base,
                     cfg.vocab_size)
    total = {name: 0 for name in _launch_counters()}
    for name, plan in (
            ("undisturbed", None),
            ("kill_replica", {"kill_replica_at_t": {REPLICA_KILL_T: [0]}}),
            ("kill_mesh_member",
             {"kill_mesh_member_at_t": {REPLICA_KILL_T: [0]}})):
        tag = f"tp-replica {name}"
        rs, reqs, rows, launches, wall = _tp_replica_run(model, cfg, meshes,
                                                         plan)
        _check_done_once(tag, rs.completed, reqs, cfg.vocab_size)
        if any(launches.values()):
            raise AssertionError(f"[{tag}] the controller launched "
                                 f"{launches}")
        counts = []
        for e, m in zip(rs.replicas, meshes):
            got, steps, prefills = _tp_counts(tag, e, m, (0, 0),
                                              cfg.num_layers)
            counts.append((steps, prefills))
            for k, v in got.items():
                total[k] += v
        if not sum(s for s, _ in counts) or not sum(p for _, p in counts):
            raise AssertionError(f"[{tag}] (decode steps, full prefills) "
                                 f"per replica {counts}")
        st = rs.replica_stats()
        for i, e in enumerate(rs.replicas):
            e.flush_prefix_cache()
            if e.kv.pages_allocated != e.kv.pages_freed or \
                    e.admission.slot_balance() or e.kv.live_pages():
                raise AssertionError(f"[{tag}] replica {i} ledgers")
        if [p["tp_shards"] for p in st["per_replica"]] != [TP_RANKS] * 2:
            raise AssertionError(f"[{tag}] {st}")
        if plan and (not rs.replicas[0].dead or st["rehomed_total"] < 1
                     or st["orphaned"]):
            raise AssertionError(f"[{tag}] {st}")
        verdict = _judge_tp(tag, base, reqs, base_rows, rows)
        log(f"[tp-replica] {name}: 2 replicas x {TP_RANKS} ranks "
            f"(4 workers on one card), all 8 done once, kills "
            f"{st['replica_kills']}, mesh kills {st['mesh_member_kills']}, "
            f"heartbeat reaps {st['heartbeat_reaps']}, re-homed "
            f"{st['rehomed_total']}, requests by replica "
            f"{[[r.request_id for r in e.completed] for e in rs.replicas]}; "
            f"per replica (decode steps, full prefills) {counts}, every "
            f"rank's K1/K2 = those x {cfg.num_layers}; {verdict} against "
            f"the whole-device set; "
            f"{sum(len(r.tokens) for r in reqs) / wall:.1f} tokens/s "
            f"({wall:.2f}s wall; two ranks time-sharing one card, gloo: "
            f"not a TP speed)")
        del rs
        gc.collect()
    return total


def phase_tensor_parallel() -> dict:
    """Phase 17: sharded K1 and K2, then qwen2.5-32b served paged over a
    2-rank mesh on the card, then a DP x TP replica set; every mesh
    closed."""
    import multiprocessing

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    mesh = _tp_mesh()
    meshes = []
    try:
        info = mesh.probe()
        log(f"[tp] mesh {mesh!r}: workers {info}, started in "
            f"{time.perf_counter() - t0:.1f}s")
        if any(p["jax_imported"] for p in info):
            raise AssertionError(f"[tp] a worker imported jax: {info}")
        _tp_attention(mesh)
        _tp_flash(mesh)
        cfg = dataclasses.replace(get_config("qwen2.5-32b"),
                                  num_layers=SERVE_LAYERS)
        model = _model_on_card(cfg, "tp-serve", " (of 64)")
        total = _tp_serve(cfg, model, mesh)
        mesh.close()
        del model
        _free_card()
        cfg = dataclasses.replace(cfg, num_layers=TP_REPLICA_LAYERS)
        model = _model_on_card(cfg, "tp-replica", " (of 64)")
        meshes = [_tp_mesh() for _ in range(2)]
        for k, v in _tp_replicas(cfg, model, meshes).items():
            total[k] += v
    finally:
        procs = [p for m in [mesh] + meshes for p in m.processes]
        for m in [mesh] + meshes:
            m.close()
    left = [p.pid for p in procs if p.is_alive()] + [
        p.pid for p in multiprocessing.active_children()
        if p.name.startswith("repro-torch-shard")]
    if left:
        raise AssertionError(f"[tp] shard workers left after close: {left}")
    log(f"[tp] {len(procs)} shard workers started and ended; none left")
    return total


# --------------------------------------------------------------- phase 18

# every mesh here is gloo ranks on the one card (NCCL refuses two ranks on
# one GPU), each rank a process this script starts and ends
#: (a): phase 15's small fp32 configs (and llama4-scout's reduced one) on a
#: 2 x 2 mesh, 3 steps
MESH_SMALL_SHAPE, MESH_SMALL_STEPS = (2, 2), 3
#: (b): gemma2-9b at its published widths, 4 of 42 layers (phase 16's train
#: lane), bf16, global batch 2 of 1024 tokens, 3 steps on (data=2, model=2)
#: (gloo moves ~10 GB a rank a step through the host: ~12 s a step)
MESH_DENSE_LAYERS, MESH_B, MESH_S, MESH_STEPS = 4, 2, 1024, 3
#: (c): qwen3-moe-235b-a22b at its published widths, 1 of 94 layers (both
#: ranks resident: ~7.5 GB of bf16 weights and ~30 GB of fp32 moments
#: across them, ~28 GB a rank with the gathered weights and gradients),
#: bf16, global batch 2 of 512 tokens, 3 steps on (data=1, model=2)
MESH_MOE_LAYERS, MESH_MOE_B, MESH_MOE_S, MESH_MOE_STEPS = 1, 2, 512, 3
#: (d): (b)'s model at 1 of 42 layers, 1 step on (b)'s mesh, saved, then
#: 2 more steps on the mesh and on one device from the checkpoint (the
#: second reads the restored moments and step count through the update).
#: Not (b)'s 4 layers: the SELF writer builds the image in host memory at
#: ~4.2x the tree's bytes (a 1 GiB tree peaks at 4.2 GiB on the CPU), so
#: (b)'s 17 GB of weights and moments would need ~70 GB of the host's
MESH_CKPT_LAYERS, MESH_CKPT_STEPS, MESH_CKPT_NEXT = 1, 1, 2
#: (e): qwen2.5-32b at its published widths, 2 of 64 layers, bf16, global
#: batch 2 of 1024 tokens, 3 steps on (data=1, model=3): neither its 40 q
#: heads nor the 1024 tokens divide 3 (sequence-parallel attention, the
#: sequence padded to 1026).  Each rank holds ~0.93 B of the ~3.2 B
#: parameters (the vocabulary and d_ff split over model) with their fp32
#: moments: ~11 GB a rank
MESH_SP_LAYERS, MESH_SP_B, MESH_SP_S, MESH_SP_STEPS = 2, 2, 1024, 3
#: (f): rwkv6-3b and hymba-1.5b at their published widths, 1 of 32 layers
#: each, bf16, global batch 2 of 1024 tokens, 3 steps on (data=1,
#: model=2): RWKV6's time mix on each rank's one row of the whole
#: sequence and its channel mix's d_ff of 8960 by halves; hymba's 25 q
#: heads by query rows, its d_inner of 3200 and d_ff of 5504 by halves.
#: Peak lr 1e-3, not (b)'s 3e-3: there hymba's bf16 steps are
#: ill-conditioned whatever the layout.  On an H100 (700 W,
#: experiments/mesh_train_conditioning.py) one device's bf16 gnorm spiked
#: to 6.97 at step 2 against fp32's 3.74 (0.865 apart); this mesh read
#: 4.52 there (0.352 from bf16's one device), the data-only (data=2,
#: model=1) 6.67 (0.065), while in fp32 the split read 3.4e-6 / 8.6e-4 of
#: one device's loss and gnorm.  At 1e-3 the split reads 6.2e-4 / 0.0147
#: and the data-only mesh 1.24e-4 / 0.0288, against bf16's own 0.0604
#: from fp32 on one device
MESH_SPLIT_ARCHS = ("rwkv6-3b", "hymba-1.5b")
MESH_SPLIT_LAYERS, MESH_SPLIT_B, MESH_SPLIT_S, MESH_SPLIT_STEPS = \
    1, 2, 1024, 3
MESH_SPLIT_LR = 1e-3
#: (f): the first step's loss against one device's, relative: one bf16
#: forward from equal weights, before any update can amplify a rounding.
#: Sound runs on the H100 (700 W) read 7.24e-6 (rwkv6-3b) and 3.14e-5
#: (hymba-1.5b); copies of src/ whose RWKV time mix lands on the wrong
#: rows, or whose hymba SSM drops the sum of xc @ w_B and xc @ w_C over
#: the ranks, read 7.04e-4 and 3.81e-3: the first passes (b)'s limits over
#: 3 steps (0.00394, 0.00994), the first step's loss catches both
MESH_SPLIT_LOSS0_RTOL = 2e-4
#: phase 18's cells, all run by default (``--mesh-cells``)
MESH_CELLS = ("dense", "moe", "small", "sp", "split")
#: (b): a mesh run's loss and gradient norm against one device's,
#: relative, the largest over the steps.  bf16 rounds each rank's
#: half-batch products where one device rounds the whole batch's, and
#: AdamW's normalised steps carry rounding-level sign flips of the gradient
#: into the weights.  Sound runs on the H100 read 0.00399 and 0.0123 over
#: 4 steps; a copy of src/ with the gradient reduction over the batch axes
#: dropped reads 0.0168 and 0.306.  The limits sit 2x and 2.4x above the
#: sound readings, 2.1x and 10x below the broken ones
MESH_LOSS_RTOL, MESH_GNORM_RTOL = 8e-3, 3e-2
#: (d): the 2 steps after the checkpoint on one device from it against the
#: mesh's own, loss and gradient norm, relative, the largest of the two.
#: Both start from equal values (the digests below); they differ only
#: where the mesh sums two half-batch bf16 gradients and one device takes
#: the whole batch's.  Sound runs on the H100 read 2.33e-5 and 6.78e-5; a
#: copy of src/ whose restore zeroes the moments reads 1.56e-3 and 7.7e-3
#: (and fails the digests).  The limits sit 4.3x and 4.4x above the sound
#: readings, 16x and 26x below the broken ones
MESH_CKPT_LOSS_RTOL, MESH_CKPT_GNORM_RTOL = 1e-4, 3e-4
#: seconds a rank may take to report before the phase fails (a rank that
#: dies is seen at once), and a collective's own timeout
MESH_TIMEOUT_S, MESH_COLLECTIVE_S = 900, 300

_SRC = str(ROOT / "src")


def _mesh_rank(rank, n, port, src, job, args, out) -> None:
    """One rank: joins the gloo group on the card, runs ``job(*args)`` and
    sends its result or its traceback."""
    import datetime
    import traceback

    sys.path.insert(0, src)
    try:
        import torch.distributed as dist

        torch.cuda.set_device(0)
        torch.set_num_threads(2)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=n,
            timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_S))
        try:
            result = job(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", result))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))


def _run_mesh(job, n: int, *args) -> list:
    """``job(*args)`` on ``n`` ranks: their results in rank order.  A rank
    that raises or dies fails the phase; every rank is ended before this
    returns."""
    import multiprocessing as mp
    import queue
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank, name=f"repro-torch-rank-{r}",
                         args=(r, n, port, _SRC, job, args, out), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    results, t0 = {}, time.perf_counter()
    try:
        while len(results) < n:
            try:
                rank, status, value = out.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead or time.perf_counter() - t0 > MESH_TIMEOUT_S:
                    raise AssertionError(
                        f"[mesh] ranks {dead or 'all'} of {job.__name__} "
                        f"died or gave no result (exit codes "
                        f"{[p.exitcode for p in procs]})") from None
                continue
            if status == "err":
                raise AssertionError(f"[mesh] rank {rank} of {job.__name__} "
                                     f"failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(n)]


class _RaggedLM(_ModalityLM):
    """``_ModalityLM`` with a seeded ragged loss mask: each row keeps its
    own share of the tokens, so the data shards' mask counts differ."""

    def batch_at(self, step):
        b = super().batch_at(step)
        rng = np.random.default_rng(2000 + step)
        B, S = b["tokens"].shape
        keep = rng.random((B, 1)) * 0.8 + 0.1
        b["loss_mask"] = (rng.random((B, S)) < keep).astype(np.float32)
        return b


def _mesh_trainer(model, mesh, steps, batch, seq, *, ragged=False,
                  start=0, ckpt=None, peak_lr=3e-3):
    """A ``Trainer`` (on ``mesh`` if given) over seeded batches, ``peak_lr``
    after a 1-step warmup, and its loader."""
    from repro_torch.data import DataConfig, Loader, SyntheticLM
    from repro_torch.optim import ScheduleConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    dc = DataConfig(global_batch=batch, seq_len=seq,
                    vocab_size=model.cfg.vocab_size)
    data = _RaggedLM(model.cfg, dc) if ragged else SyntheticLM(dc)
    loader = Loader(data, dc, start_step=start)
    tr = Trainer(model, loader, TrainerConfig(
        total_steps=steps, log_every=1, ckpt_every=10 ** 9,
        schedule=ScheduleConfig(peak_lr=peak_lr, warmup_steps=1,
                                decay_steps=100)), ckpt=ckpt, mesh=mesh)
    return tr, loader


def _curve(tr) -> list:
    return [(r["loss"], r["gnorm"]) for r in tr.metrics_log]


def _tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _whole_bytes(tree, shardings) -> int:
    """The bytes of the whole leaves whose shards are ``tree``."""
    from repro_torch.tree import tree_leaves

    return sum(int(np.prod(s.global_shape(tuple(t.shape)))) * t.element_size()
               for t, s in zip(tree_leaves(tree), tree_leaves(shardings)))


def _whole_numpy(tree, shardings) -> dict:
    """Every leaf gathered whole (a collective), by path, on the host."""
    from repro_torch.parallel.sharding import gather_leaf
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    return {"/".join(map(str, p)): gather_leaf(t, s).float().cpu().numpy()
            for (p, t), s in zip(tree_flatten_with_path(tree),
                                 tree_leaves(shardings))}


def _timed(tr, times: list) -> None:
    """Times each step of ``tr`` (synchronised) into ``times``."""
    step_fn = tr._step_fn

    def timed(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*a)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    tr._step_fn = timed


def _zero_counters() -> dict:
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def _job_small(cells, states) -> dict:
    """(a) in a rank: each cell on the 2 x 2 mesh on the card, then on the
    CPU, from the same weights: curves, launches, and on rank 0 the
    trained whole weights."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import param_tree
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import shard_tree
    from repro_torch.tree import tree_map

    out = {}
    for device in ("cuda", "cpu"):
        mesh = make_host_mesh(*MESH_SMALL_SHAPE, device=device)
        for tag, cfg, seq in cells:
            model = build_model(cfg, device=device)
            model.load_state_dict(states[tag])
            tr, loader = _mesh_trainer(model, mesh, MESH_SMALL_STEPS, 4, seq,
                                       ragged=True)
            params = tree_map(torch.clone, shard_tree(
                param_tree(model), tr.shardings["params"]))
            counters = _zero_counters()
            mesh.staged_bytes = 0
            params, _ = tr.run(params, adamw_init(params))
            launches = {k: fn.launches for k, fn in counters.items()}
            loader.stop()
            whole = _whole_numpy(params, tr.shardings["params"])
            out[f"{device}/{tag}"] = {
                "curve": _curve(tr), "launches": launches,
                "staged": mesh.staged_bytes,
                "params": whole if mesh.rank == 0 else None}
    return out


def _digest(t: torch.Tensor) -> tuple:
    """(sum x, sum x * w) in fp64 over ``t``'s elements in row-major order,
    w running 1 .. 65521 with the flat index: equal tensors give equal
    digests, and a changed, zeroed or misplaced element moves them."""
    flat = t.detach().contiguous().reshape(-1)
    s0 = torch.zeros((), dtype=torch.float64, device=t.device)
    s1 = torch.zeros_like(s0)
    for lo in range(0, flat.numel(), 1 << 24):
        x = flat[lo:lo + (1 << 24)].double()
        w = torch.arange(lo, lo + x.numel(), dtype=torch.float64,
                         device=t.device).remainder_(65521).add_(1)
        s0 += x.sum()
        s1 += (x * w).sum()
    return s0.item(), s1.item()


def _tree_digests(tree) -> dict:
    from repro_torch.tree import tree_flatten_with_path

    return {"/".join(map(str, p)): _digest(t)
            for p, t in tree_flatten_with_path(tree)}


def _job_dense(ckpt_dir: str) -> dict:
    """(b) and (d) in a rank: gemma2-9b's 4-layer cut on (2, 2), then its
    1-layer cut saved after 1 step, its shards' digests, and 2 more
    steps."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.gofer import Gofer
    from repro_torch.data import DataConfig, Loader, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model

    mesh = make_host_mesh(2, 2, device="cuda")
    cfg = dataclasses.replace(get_config("gemma2-9b"),
                              num_layers=MESH_DENSE_LAYERS)
    model = build_model(cfg, device="cuda")
    tr, loader = _mesh_trainer(model, mesh, MESH_STEPS, MESH_B, MESH_S)
    t0 = time.perf_counter()
    params, opt = tr.init_state(torch.Generator("cuda").manual_seed(0))
    sh = tr.shardings
    out = {"init_s": time.perf_counter() - t0,
           "p_bytes": _tree_bytes(params),
           "m_bytes": _tree_bytes(opt["mu"]) + _tree_bytes(opt["nu"]),
           "p_whole": _whole_bytes(params, sh["params"]),
           "m_whole": 2 * _whole_bytes(opt["mu"], sh["opt"]["mu"])}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times: list = []
    _timed(tr, times)
    counters = _zero_counters()
    mesh.staged_bytes = 0
    params, opt = tr.run(params, opt)
    loader.stop()
    out.update(curve=_curve(tr), times=times,
               launches={k: fn.launches for k, fn in counters.items()},
               staged=mesh.staged_bytes / MESH_STEPS,
               peak=torch.cuda.max_memory_allocated())
    del params, opt, tr, model
    gc.collect()
    torch.cuda.empty_cache()

    # (d): the 1-layer cut, saved from the mesh after 1 step
    cfg = dataclasses.replace(cfg, num_layers=MESH_CKPT_LAYERS)
    model = build_model(cfg, device="cuda")
    ckpt = CheckpointManager(Gofer.for_root("ckpt", ckpt_dir, write=True))
    tr, loader = _mesh_trainer(model, mesh, MESH_CKPT_STEPS, MESH_B, MESH_S,
                               ckpt=ckpt)
    params, opt = tr.init_state(torch.Generator("cuda").manual_seed(0))
    counters = _zero_counters()
    t0 = time.perf_counter()
    params, opt = tr.run(params, opt)         # the last step saves, blocking
    loader.stop()
    run_s = time.perf_counter() - t0
    from repro_torch.tree import tree_flatten_with_path

    saved = {"params": params, "opt": opt}
    digests = _tree_digests(saved)
    specs = {"/".join(map(str, p)): tuple(s.spec) for p, s in
             tree_flatten_with_path({"params": tr.shardings["params"],
                                     "opt": tr.shardings["opt"]})}
    dc = DataConfig(global_batch=MESH_B, seq_len=MESH_S,
                    vocab_size=cfg.vocab_size)
    tr.loader = Loader(SyntheticLM(dc), dc, start_step=MESH_CKPT_STEPS)
    tr.ckpt = None
    tr.cfg.total_steps = MESH_CKPT_STEPS + MESH_CKPT_NEXT
    params, opt = tr.run(params, opt, start_step=MESH_CKPT_STEPS)
    tr.loader.stop()
    out["ckpt"] = {"curve": _curve(tr)[-MESH_CKPT_NEXT:], "run_s": run_s,
                   "digests": digests, "specs": specs,
                   "coords": dict(mesh.coords),
                   "launches": {k: fn.launches
                                for k, fn in counters.items()},
                   "save": ckpt.save_log[-1] if ckpt.save_log else None,
                   "steps": ckpt.all_steps()}
    return out


def _job_moe() -> dict:
    """(c) in a rank: qwen3-moe's 1-layer cut on (1, 2), expert-parallel:
    its curve, its experts, the copies its routing dropped, its memory."""
    import repro_torch.models.moe as moe
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model

    mesh = make_host_mesh(1, 2, device="cuda")
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                              num_layers=MESH_MOE_LAYERS)
    model = build_model(cfg, device="cuda")
    tr, loader = _mesh_trainer(model, mesh, MESH_MOE_STEPS, MESH_MOE_B,
                               MESH_MOE_S)
    params, opt = tr.init_state(torch.Generator("cuda").manual_seed(0))
    out = {"experts": int(params["layers"]["moe"]["wg"].shape[1]),
           "p_bytes": _tree_bytes(params),
           "m_bytes": _tree_bytes(opt["mu"]) + _tree_bytes(opt["nu"]),
           "p_whole": _whole_bytes(params, tr.shardings["params"])}
    real, routed = moe.route, []

    def spy(x, *a, **kw):
        r = real(x, *a, **kw)
        routed.append((int(r.keep.numel()), int((~r.keep).sum())))
        return r

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times: list = []
    _timed(tr, times)
    counters = _zero_counters()
    mesh.staged_bytes = 0
    moe.route = spy
    try:
        params, opt = tr.run(params, opt)
    finally:
        moe.route = real
        loader.stop()
    out.update(curve=_curve(tr), times=times, routed=routed,
               launches={k: fn.launches for k, fn in counters.items()},
               staged=mesh.staged_bytes / MESH_MOE_STEPS,
               peak=torch.cuda.max_memory_allocated())
    return out


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _curve_drift(got, want) -> tuple:
    """(max loss rel, max gnorm rel) over the steps of two curves."""
    if len(got) != len(want):
        raise AssertionError(f"curves of {len(got)} and {len(want)} steps")
    return (max(_rel(g[0], w[0]) for g, w in zip(got, want)),
            max(_rel(g[1], w[1]) for g, w in zip(got, want)))


def _param_drift(got: dict, want: dict, start: dict) -> float:
    """The largest leaf's |got - want| over |want - start| (relative L2)."""
    worst = 0.0
    for key, ref in want.items():
        ref = ref.astype(np.float64)
        moved = np.linalg.norm(ref - start[key])
        worst = max(worst, np.linalg.norm(got[key] - ref) / max(moved, 1e-30))
    return worst


def _check_launches(tag: str, ranks) -> None:
    bad = [(r, x) for r, x in enumerate(ranks) if any(x.values())]
    if bad:
        raise AssertionError(f"[{tag}] kernels launched on the training "
                             f"route: {bad}")


def _mesh_small_cells():
    """(tag, config, seq): phase 15's gemma2, qwen3-moe, RWKV6, hymba and
    whisper cells, and llama4-scout's reduced config."""
    from repro_torch.configs import get_reduced

    cells = {tag: (tag, cfg, seq) for tag, cfg, seq in _train_cells()}
    scout = dataclasses.replace(get_reduced("llama4-scout-17b-a16e"),
                                dtype="float32")
    return [cells["gemma2"], cells["qwen3-moe"],
            ("llama4-scout", scout, 32), cells["rwkv6"], cells["hymba"],
            cells["whisper"]]


def _mesh_small() -> None:
    """(a) ``[mesh-train-small]``: the card's mesh against the CPU's mesh,
    and for every family but the MoE (capacity per shard) against one
    device on the card."""
    from repro_torch.models import build_model
    from repro_torch.models.common import param_tree
    from repro_torch.optim import adamw_init

    cells = _mesh_small_cells()
    states = {tag: build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(31)).state_dict()
        for tag, cfg, _ in cells}
    t0 = time.perf_counter()
    ranks = _run_mesh(_job_small, 4, cells, states)
    mesh_s = time.perf_counter() - t0
    l_tol, g_tol, u_tol = TRAIN_UNALIGNED_RTOLS
    for tag, cfg, seq in cells:
        card, cpu = ranks[0][f"cuda/{tag}"], ranks[0][f"cpu/{tag}"]
        _check_launches(f"mesh-train-small {tag}",
                        [r[f"cuda/{tag}"]["launches"] for r in ranks])
        curves = [card["curve"]] + [cpu["curve"]]
        if not np.isfinite(np.array(curves)).all():
            raise AssertionError(f"[mesh-train-small] {tag}: {curves}")
        start = {k.replace(".", "/"): v.double().numpy()
                 for k, v in states[tag].items()}
        pairs = {"cpu mesh": (cpu["curve"], cpu["params"])}
        if not cfg.is_moe:
            model = build_model(cfg, device="cuda")
            model.load_state_dict(states[tag])
            tr, loader = _mesh_trainer(model, None, MESH_SMALL_STEPS, 4, seq,
                                       ragged=True)
            params = param_tree(model)
            params, _ = tr.run(params, adamw_init(params))
            loader.stop()
            pairs["card, one device"] = (_curve(tr), {
                "/".join(k.split(".")): v.float().cpu().numpy()
                for k, v in model.state_dict().items()})
            del model, params, tr
        reads = []
        for what, (curve, params) in pairs.items():
            loss, gnorm = _curve_drift(card["curve"], curve)
            upd = _param_drift(card["params"], params, start)
            first = _rel(card["curve"][0][0], curve[0][0])
            reads.append(f"vs {what}: step-0 loss rel {first:.2g}, loss "
                         f"max rel {loss:.2g}, gnorm max rel {gnorm:.2g}, "
                         f"worst leaf update {upd:.2g}")
            if not (first <= TRAIN_LOSS_RTOL0 and loss <= l_tol
                    and gnorm <= g_tol and upd <= u_tol):
                raise AssertionError(
                    f"[mesh-train-small] {tag} on the card's 2 x 2 mesh "
                    f"{reads[-1]} (limits {TRAIN_LOSS_RTOL0:g}, {l_tol:g}, "
                    f"{g_tol:g}, {u_tol:g}); card {card['curve']}, other "
                    f"{curve}")
        log(f"[mesh-train-small] {tag} ({cfg.arch_id} at d_model "
            f"{cfg.d_model}, {cfg.num_layers} layers, seq {seq}, fp32, "
            f"ragged mask, 2 x 2 mesh of 4 gloo ranks on cuda:0, "
            f"{MESH_SMALL_STEPS} steps): losses "
            f"{[round(c[0], 6) for c in card['curve']]}; " + "; ".join(reads)
            + f"; {card['staged'] / 1e6:.1f} MB staged through the host on "
            "rank 0; launches 0 on every rank")
    log(f"[mesh-train-small] {len(cells)} cells x (card, CPU) on 4 ranks in "
        f"{mesh_s:.1f}s (limits: step-0 loss {TRAIN_LOSS_RTOL0:g}, then "
        f"phase 15's card-against-CPU {l_tol:g} / {g_tol:g} / {u_tol:g})")


def _one_device_dense(layers: int, steps: int, start: int = 0,
                      state=None, arch: str = "gemma2-9b",
                      batch: int = MESH_B, seq: int = MESH_S,
                      peak_lr: float = 3e-3) -> list:
    """``arch``'s ``layers``-layer cut (gemma2-9b's by default) trained on
    one device on the card from seed 0 (or from ``state``, a restored
    {"params", "opt"} at ``start``): its curve and step times."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model = build_model(cfg, device="cuda")
    tr, loader = _mesh_trainer(model, None, steps, batch, seq, start=start,
                               peak_lr=peak_lr)
    if state is None:
        params, opt = tr.init_state(torch.Generator("cuda").manual_seed(0))
    else:
        params, opt = state["params"], state["opt"]
    times: list = []
    _timed(tr, times)
    tr.run(params, opt, start_step=start)
    loader.stop()
    return _curve(tr), times


def _restore_one_device(ckpt_dir: str, ranks: list) -> tuple:
    """(d) on one device: the mesh's checkpoint restored onto the card,
    each mesh rank's shard of it cut out and digested, then the next
    steps.  Returns (curve, restore seconds, GB, digests that differ from
    the ranks', digests compared)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.gofer import Gofer
    from repro_torch.launch.mesh import MESH_AXES
    from repro_torch.models import build_model
    from repro_torch.models.common import param_tree
    from repro_torch.parallel.sharding import (
        AbstractMesh,
        NamedSharding,
        P,
        shard_tree,
    )
    from repro_torch.tree import tree_flatten_with_path, tree_unflatten_like

    cfg = dataclasses.replace(get_config("gemma2-9b"),
                              num_layers=MESH_CKPT_LAYERS)
    shapes = param_tree(build_model(cfg, device="meta"))
    step = torch.empty((), dtype=torch.int32, device="meta")
    like = {"params": shapes, "opt": {"mu": shapes, "nu": shapes,
                                      "step": step}}
    ckpt = CheckpointManager(Gofer.for_root("ckpt", ckpt_dir))
    t0 = time.perf_counter()
    got, tree, _ = ckpt.restore_latest(like, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if got != MESH_CKPT_STEPS:
        raise AssertionError(f"[mesh-train-ckpt] restored step {got}")
    gb = _tree_bytes(tree) / 1e9
    paths = ["/".join(map(str, p)) for p, _ in tree_flatten_with_path(tree)]
    differ, compared = [], 0
    for r, x in enumerate(ranks):
        ck = x["ckpt"]
        mesh = AbstractMesh((2, 2), MESH_AXES)
        mesh.coords = ck["coords"]
        local = shard_tree(tree, tree_unflatten_like(tree, [
            NamedSharding(mesh, P(*ck["specs"][p])) for p in paths]))
        for p, t in tree_flatten_with_path(local):
            key = "/".join(map(str, p))
            compared += 1
            if _digest(t) != ck["digests"][key]:
                differ.append(f"rank {r} {key}")
    curve, _ = _one_device_dense(MESH_CKPT_LAYERS,
                                 MESH_CKPT_STEPS + MESH_CKPT_NEXT,
                                 start=MESH_CKPT_STEPS, state=tree)
    return curve, restore_s, gb, differ, compared


def _mesh_dense() -> None:
    """(b) ``[mesh-train-dense]`` and (d) ``[mesh-train-ckpt]``."""
    import tempfile

    want, one_times = _one_device_dense(MESH_DENSE_LAYERS, MESH_STEPS)
    _free_card()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ranks = _run_mesh(_job_dense, 4, d)
        mesh_s = time.perf_counter() - t0
        r0 = ranks[0]
        _check_launches("mesh-train-dense", [r["launches"] for r in ranks])
        loss, gnorm = _curve_drift(r0["curve"], want)
        med = float(np.median(r0["times"][1:]))
        tokens = MESH_B * MESH_S
        log(f"[mesh-train-dense] gemma2-9b x{MESH_DENSE_LAYERS} layers bf16 "
            f"on (data=2, model=2), 4 gloo ranks on cuda:0, B={MESH_B} "
            f"S={MESH_S}, {MESH_STEPS} steps: losses "
            f"{[round(c[0], 4) for c in r0['curve']]} against one device's "
            f"{[round(c[0], 4) for c in want]}, gnorms "
            f"{[round(c[1], 3) for c in r0['curve']]} against "
            f"{[round(c[1], 3) for c in want]}: loss max rel {loss:.3g}, "
            f"gnorm max rel {gnorm:.3g} (limits {MESH_LOSS_RTOL:g}, "
            f"{MESH_GNORM_RTOL:g})")
        for r, x in enumerate(ranks):
            log(f"[mesh-train-dense] rank {r}: parameters "
                f"{x['p_bytes'] / 1e9:.3f} GB of {x['p_whole'] / 1e9:.3f} "
                f"({x['p_bytes'] / x['p_whole']:.3f}; 1/4 = 0.25), moments "
                f"{x['m_bytes'] / 1e9:.3f} GB of {x['m_whole'] / 1e9:.3f} "
                f"({x['m_bytes'] / x['m_whole']:.3f}); peak "
                f"(max_memory_allocated) {x['peak'] / 1e9:.2f} GB; step times "
                f"{[round(t, 3) for t in x['times']]} s; "
                f"{x['staged'] / 1e9:.2f} GB a step staged through the host")
        log(f"[mesh-train-dense] median step {med * 1e3:.1f} ms ({tokens / med:.0f} "
            f"tokens/s, four ranks time-sharing one card: not a "
            f"data-parallel speed) against one device's "
            f"{np.median(one_times[1:]) * 1e3:.1f} ms; launches 0 on every "
            f"rank; the spawn, init and run of (b) and (d) took "
            f"{mesh_s:.1f}s, (b)'s init_state {r0['init_s']:.1f}s")
        if not (np.isfinite(np.array(r0["curve"])).all()
                and loss <= MESH_LOSS_RTOL and gnorm <= MESH_GNORM_RTOL):
            raise AssertionError(
                f"[mesh-train-dense] the mesh's curve {r0['curve']} is off "
                f"one device's {want}")
        shares = [x["p_bytes"] / x["p_whole"] for x in ranks]
        if max(shares) > 0.3:
            raise AssertionError(f"[mesh-train-dense] ranks hold {shares} of "
                                 "the parameters")

        ck = r0["ckpt"]
        _check_launches("mesh-train-ckpt", [r["ckpt"]["launches"]
                                            for r in ranks])
        if ck["steps"] != [MESH_CKPT_STEPS] or ck["save"] is None:
            raise AssertionError(f"[mesh-train-ckpt] checkpoints "
                                 f"{ck['steps']}, save {ck['save']}")
        _free_card()
        curve, restore_s, gb, differ, compared = _restore_one_device(d,
                                                                     ranks)
    loss, gnorm = _curve_drift(curve, ck["curve"])
    log(f"[mesh-train-ckpt] gemma2-9b x{MESH_CKPT_LAYERS} layer bf16 on "
        f"(2, 2): {MESH_CKPT_STEPS} step, saved by rank 0 "
        f"({ck['save']['bytes'] / 1e9:.2f} GB SELF image in "
        f"{ck['save']['secs']:.1f}s; the step and the save "
        f"{ck['run_s']:.1f}s), restored onto one device "
        f"({gb:.2f} GB in {restore_s:.1f}s); the restored parameters, "
        f"moments and step count cut to each rank's shards: "
        f"{compared - len(differ)} of {compared} digests equal the ranks' "
        f"at the save{': differ ' + ', '.join(differ[:8]) if differ else ''}"
        f"; steps {MESH_CKPT_STEPS}..{MESH_CKPT_STEPS + MESH_CKPT_NEXT - 1} "
        f"on the mesh: losses {[round(c[0], 6) for c in ck['curve']]} gnorms "
        f"{[round(c[1], 5) for c in ck['curve']]}, on one device from the "
        f"checkpoint: losses {[round(c[0], 6) for c in curve]} gnorms "
        f"{[round(c[1], 5) for c in curve]} (max rel {loss:.3g} / "
        f"{gnorm:.3g}, limits {MESH_CKPT_LOSS_RTOL:g} / "
        f"{MESH_CKPT_GNORM_RTOL:g})")
    if differ:
        raise AssertionError(f"[mesh-train-ckpt] {len(differ)} restored "
                             "shards differ from the mesh's at the save")
    if not (loss <= MESH_CKPT_LOSS_RTOL and gnorm <= MESH_CKPT_GNORM_RTOL):
        raise AssertionError("[mesh-train-ckpt] the steps after the restore "
                             "are off the mesh's")


def _job_sp() -> dict:
    """(e) in a rank: qwen2.5-32b's 2-layer cut on (1, 3), its attention
    sequence-parallel: its curve, step times, memory and host bytes."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model

    mesh = make_host_mesh(1, 3, device="cuda")
    cfg = dataclasses.replace(get_config("qwen2.5-32b"),
                              num_layers=MESH_SP_LAYERS)
    model = build_model(cfg, device="cuda")
    tr, loader = _mesh_trainer(model, mesh, MESH_SP_STEPS, MESH_SP_B,
                               MESH_SP_S)
    params, opt = tr.init_state(torch.Generator("cuda").manual_seed(0))
    out = {"p_bytes": _tree_bytes(params),
           "p_whole": _whole_bytes(params, tr.shardings["params"])}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times: list = []
    _timed(tr, times)
    counters = _zero_counters()
    mesh.staged_bytes = 0
    params, opt = tr.run(params, opt)
    loader.stop()
    out.update(curve=_curve(tr), times=times,
               launches={k: fn.launches for k, fn in counters.items()},
               staged=mesh.staged_bytes / MESH_SP_STEPS,
               peak=torch.cuda.max_memory_allocated())
    return out


def _mesh_sp() -> None:
    """(e) ``[mesh-train-sp]``."""
    want, one_times = _one_device_dense(
        MESH_SP_LAYERS, MESH_SP_STEPS, arch="qwen2.5-32b", batch=MESH_SP_B,
        seq=MESH_SP_S)
    _free_card()
    t0 = time.perf_counter()
    ranks = _run_mesh(_job_sp, 3)
    mesh_s = time.perf_counter() - t0
    _check_launches("mesh-train-sp", [r["launches"] for r in ranks])
    r0 = ranks[0]
    loss, gnorm = _curve_drift(r0["curve"], want)
    for r, x in enumerate(ranks):
        log(f"[mesh-train-sp] rank {r}: parameters {x['p_bytes'] / 1e9:.3f} "
            f"GB of {x['p_whole'] / 1e9:.3f}; peak (max_memory_allocated) "
            f"{x['peak'] / 1e9:.2f} GB; step times "
            f"{[round(t, 3) for t in x['times']]} s; "
            f"{x['staged'] / 1e9:.2f} GB a step staged through the host")
    log(f"[mesh-train-sp] qwen2.5-32b x{MESH_SP_LAYERS} layers bf16 on "
        f"(data=1, model=3), 3 gloo ranks on cuda:0, B={MESH_SP_B} "
        f"S={MESH_SP_S} (40 q heads, 1024 tokens: neither divides 3), "
        f"{MESH_SP_STEPS} steps: losses "
        f"{[round(c[0], 4) for c in r0['curve']]} against one device's "
        f"{[round(c[0], 4) for c in want]}, gnorms "
        f"{[round(c[1], 3) for c in r0['curve']]} against "
        f"{[round(c[1], 3) for c in want]}: loss max rel {loss:.3g}, gnorm "
        f"max rel {gnorm:.3g} (limits {MESH_LOSS_RTOL:g}, "
        f"{MESH_GNORM_RTOL:g}); median step "
        f"{np.median(r0['times'][1:]) * 1e3:.1f} ms against one device's "
        f"{np.median(one_times[1:]) * 1e3:.1f} ms (three ranks time-sharing "
        f"one card); launches 0; {mesh_s:.1f}s with the spawn and init")
    if not (np.isfinite(np.array(r0["curve"])).all()
            and loss <= MESH_LOSS_RTOL and gnorm <= MESH_GNORM_RTOL):
        raise AssertionError(f"[mesh-train-sp] the mesh's curve "
                             f"{r0['curve']} is off one device's {want}")


def _job_split(arch: str) -> dict:
    """(f) in a rank: ``arch``'s 1-layer cut on (1, 2), its work split over
    ``model``: its curve, step times, resident bytes, memory and host
    bytes."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model

    mesh = make_host_mesh(1, 2, device="cuda")
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=MESH_SPLIT_LAYERS)
    model = build_model(cfg, device="cuda")
    tr, loader = _mesh_trainer(model, mesh, MESH_SPLIT_STEPS, MESH_SPLIT_B,
                               MESH_SPLIT_S, peak_lr=MESH_SPLIT_LR)
    params, opt = tr.init_state(torch.Generator("cuda").manual_seed(0))
    sh = tr.shardings
    out = {"p_bytes": _tree_bytes(params),
           "m_bytes": _tree_bytes(opt["mu"]) + _tree_bytes(opt["nu"]),
           "p_whole": _whole_bytes(params, sh["params"]),
           "m_whole": 2 * _whole_bytes(opt["mu"], sh["opt"]["mu"])}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times: list = []
    _timed(tr, times)
    counters = _zero_counters()
    mesh.staged_bytes = 0
    params, opt = tr.run(params, opt)
    loader.stop()
    out.update(curve=_curve(tr), times=times,
               launches={k: fn.launches for k, fn in counters.items()},
               staged=mesh.staged_bytes / MESH_SPLIT_STEPS,
               peak=torch.cuda.max_memory_allocated())
    return out


def _job_splits(archs) -> list:
    """(f) in a rank: :func:`_job_split` of each of ``archs`` in turn."""
    out = []
    for arch in archs:
        out.append(_job_split(arch))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _mesh_split() -> None:
    """(f) ``[mesh-train-split]``: each of ``MESH_SPLIT_ARCHS`` on (1, 2)
    against one device, the archs in one spawn of ranks."""
    ones = []
    for arch in MESH_SPLIT_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        want, one_times = _one_device_dense(
            MESH_SPLIT_LAYERS, MESH_SPLIT_STEPS, arch=arch,
            batch=MESH_SPLIT_B, seq=MESH_SPLIT_S, peak_lr=MESH_SPLIT_LR)
        ones.append((want, one_times, torch.cuda.max_memory_allocated()))
        _free_card()
    t0 = time.perf_counter()
    runs = _run_mesh(_job_splits, 2, MESH_SPLIT_ARCHS)
    mesh_s = time.perf_counter() - t0
    for i, (arch, (want, one_times, one_peak)) in enumerate(
            zip(MESH_SPLIT_ARCHS, ones)):
        ranks = [r[i] for r in runs]
        _check_launches(f"mesh-train-split {arch}",
                        [r["launches"] for r in ranks])
        r0 = ranks[0]
        loss, gnorm = _curve_drift(r0["curve"], want)
        first = _rel(r0["curve"][0][0], want[0][0])
        for r, x in enumerate(ranks):
            log(f"[mesh-train-split] {arch} rank {r}: parameters "
                f"{x['p_bytes'] / 1e9:.3f} GB of {x['p_whole'] / 1e9:.3f} "
                f"({x['p_bytes'] / x['p_whole']:.3f}), moments "
                f"{x['m_bytes'] / 1e9:.3f} GB of {x['m_whole'] / 1e9:.3f} "
                f"({x['m_bytes'] / x['m_whole']:.3f}); peak "
                f"(max_memory_allocated) {x['peak'] / 1e9:.2f} GB against "
                f"one device's {one_peak / 1e9:.2f}; step times "
                f"{[round(t, 3) for t in x['times']]} s; "
                f"{x['staged'] / 1e9:.2f} GB a step staged through the "
                f"host; launches {sum(x['launches'].values())}")
        log(f"[mesh-train-split] {arch} x{MESH_SPLIT_LAYERS} layer bf16 on "
            f"(data=1, model=2), 2 gloo ranks on cuda:0, B={MESH_SPLIT_B} "
            f"S={MESH_SPLIT_S}, {MESH_SPLIT_STEPS} steps at peak lr "
            f"{MESH_SPLIT_LR:g}: losses "
            f"{[round(c[0], 4) for c in r0['curve']]} against one device's "
            f"{[round(c[0], 4) for c in want]}, gnorms "
            f"{[round(c[1], 3) for c in r0['curve']]} against "
            f"{[round(c[1], 3) for c in want]}: step-0 loss rel "
            f"{first:.3g}, loss max rel {loss:.3g}, gnorm max rel "
            f"{gnorm:.3g} (limits {MESH_SPLIT_LOSS0_RTOL:g}, "
            f"{MESH_LOSS_RTOL:g}, {MESH_GNORM_RTOL:g}); median step "
            f"{np.median(r0['times'][1:]) * 1e3:.1f} ms against one "
            f"device's {np.median(one_times[1:]) * 1e3:.1f} ms (two ranks "
            f"time-sharing one card); launches 0; the spawn, init and "
            f"both archs' runs {mesh_s:.1f}s")
        if not (np.isfinite(np.array(r0["curve"])).all()
                and first <= MESH_SPLIT_LOSS0_RTOL
                and loss <= MESH_LOSS_RTOL and gnorm <= MESH_GNORM_RTOL):
            raise AssertionError(f"[mesh-train-split] {arch}: the mesh's "
                                 f"curve {r0['curve']} is off one "
                                 f"device's {want}")
        _free_card()


def _mesh_moe() -> None:
    """(c) ``[mesh-train-moe]``."""
    from repro_torch.configs import get_config

    E = get_config("qwen3-moe-235b-a22b").num_experts
    t0 = time.perf_counter()
    ranks = _run_mesh(_job_moe, 2)
    mesh_s = time.perf_counter() - t0
    _check_launches("mesh-train-moe", [r["launches"] for r in ranks])
    curve = ranks[0]["curve"]
    if not np.isfinite(np.array(curve)).all():
        raise AssertionError(f"[mesh-train-moe] curve {curve}")
    if [r["experts"] for r in ranks] != [E // 2] * 2:
        raise AssertionError(f"[mesh-train-moe] experts a rank "
                             f"{[r['experts'] for r in ranks]}")
    for r, x in enumerate(ranks):
        copies = sum(c for c, _ in x["routed"])
        dropped = sum(d for _, d in x["routed"])
        log(f"[mesh-train-moe] rank {r}: {x['experts']} of {E} experts; "
            f"{len(x['routed'])} routings (forward and recompute) of "
            f"{x['routed'][0][0]} copies each (its "
            f"{MESH_MOE_B * MESH_MOE_S // 2} tokens x k), {dropped} of "
            f"{copies} dropped past capacity ({100 * dropped / copies:.1f} "
            f"%); parameters {x['p_bytes'] / 1e9:.2f} GB of "
            f"{x['p_whole'] / 1e9:.2f}, moments {x['m_bytes'] / 1e9:.2f} "
            f"GB; peak {x['peak'] / 1e9:.2f} GB; step times "
            f"{[round(t, 3) for t in x['times']]} s; "
            f"{x['staged'] / 1e9:.2f} GB a step staged through the host")
    log(f"[mesh-train-moe] qwen3-moe-235b-a22b x{MESH_MOE_LAYERS} layer "
        f"bf16 on (data=1, model=2), B={MESH_MOE_B} S={MESH_MOE_S}: losses "
        f"{[round(c[0], 4) for c in curve]}, gnorms "
        f"{[round(c[1], 3) for c in curve]}, finite; median step "
        f"{np.median(ranks[0]['times'][1:]) * 1e3:.1f} ms (two ranks "
        f"time-sharing one card: not an expert-parallel speed); launches 0 "
        f"on both ranks; {mesh_s:.1f}s with the spawn and init")


def phase_mesh_training() -> dict:
    """Phase 18: training on a mesh of gloo ranks on the card — (b) dense
    at full width against one device, (d) its checkpoint across mesh
    shapes, (c) expert-parallel MoE at full width, (a) every family's
    small config against the CPU's mesh, (e) sequence-parallel attention
    at full width against one device, (f) RWKV6's and the hybrid's split
    at full width against one device; the cells of ``--mesh-cells``.
    Returns the launches (none)."""
    import multiprocessing

    runs = {"dense": _mesh_dense, "moe": _mesh_moe, "small": _mesh_small,
            "sp": _mesh_sp, "split": _mesh_split}
    for cell in MESH_CELLS:
        runs[cell]()
        _free_card()
    left = [p.pid for p in multiprocessing.active_children()
            if p.name.startswith("repro-torch-rank")]
    if left:
        raise AssertionError(f"[mesh] ranks left: {left}")
    log("[mesh] every rank started here has ended")
    return {name: 0 for name in _launch_counters()}


# ------------------------------------------------------------- phase 19

#: a whole-step bound above the measured step is a wrong count
COST_SHARE_MAX = 1.05
#: the cost model's FLOPs against torch's FlopCounterMode on the same step
COST_FLOP_REL = 0.02
#: the traced peak against torch.cuda.max_memory_allocated of the step
COST_PEAK_REL = 0.10
#: phase 4's decode batch and its longest prompt, in pages of 16 rows
COST_DECODE_B, COST_DECODE_S, COST_PAGE = 4, 2048, 16
#: the production cells phase 19 dry-runs as rank 0 of a fake world
DRYRUN_CELLS = (("gemma2-9b", "train_4k"), ("whisper-tiny", "decode_32k"))
_CARD = ""


def _median_step_ms(fn, steps: int) -> tuple:
    """(median ms, every ms) of ``fn`` on the host clock, each call ended
    by a synchronise (a step's time, its launches included)."""
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def _real_peak(fn) -> tuple:
    """(max_memory_allocated over one call of ``fn``, memory_allocated
    before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), base


def _judge_cost(tag: str, cost, fc_flops: float, real_peak: int,
                base: int, med_ms: float, times) -> dict:
    """Holds the count to FlopCounterMode and the traced peak to the real
    one, logs the roofline terms beside the measured step, and fails a
    bound above the measured time."""
    rf = cost.roofline()
    flop_rel = abs(cost.flops - fc_flops) / fc_flops
    peak_rel = abs(cost.peak_bytes - real_peak) / real_peak
    bound_ms = rf["step_s_lower_bound"] * 1e3
    share = bound_ms / med_ms
    log(f"[{tag}] {_CARD}: cost model {cost.flops:.4e} FLOPs "
        f"({ {d: f'{f:.3e}' for d, f in cost.flops_by_dtype.items()} }) vs "
        f"FlopCounterMode {fc_flops:.4e} on the real step: rel "
        f"{flop_rel:.2e} (limit {COST_FLOP_REL}); bytes {cost.bytes:.4e} "
        f"fused, {cost.bytes_eager:.4e} eager; {cost.ops} ops counted")
    log(f"[{tag}] peak: traced {cost.peak_bytes / 1e9:.3f} GB (resident "
        f"{cost.resident_bytes / 1e9:.3f} GB) vs max_memory_allocated "
        f"{real_peak / 1e9:.3f} GB (allocated before the step "
        f"{base / 1e9:.3f} GB): rel {peak_rel:.3f} (limit {COST_PEAK_REL})")
    log(f"[{tag}] roofline on H100 SXM datasheet constants: compute "
        f"{rf['compute_s'] * 1e3:.3f} ms, memory {rf['memory_s'] * 1e3:.3f} "
        f"ms -> bound {bound_ms:.3f} ms ({rf['dominant']}); measured median "
        f"{med_ms:.3f} ms of {[round(t, 3) for t in times]}; whole-step "
        f"roofline share {share:.3f} (limit {COST_SHARE_MAX})")
    if not flop_rel <= COST_FLOP_REL:
        raise AssertionError(f"[{tag}] FLOPs off FlopCounterMode by "
                             f"{flop_rel:.3g}")
    if not peak_rel <= COST_PEAK_REL:
        raise AssertionError(f"[{tag}] traced peak off the real one by "
                             f"{peak_rel:.3g}")
    if not share <= COST_SHARE_MAX:
        raise AssertionError(f"[{tag}] bound {bound_ms:.3f} ms above the "
                             f"measured {med_ms:.3f} ms: a wrong count")
    return {"bound_ms": bound_ms, "ms": med_ms, "share": share,
            "flops": cost.flops, "bytes": cost.bytes,
            "peak": cost.peak_bytes, "real_peak": real_peak}


def _cost_train() -> dict:
    """Phase 15's full-width cell (gemma2-9b, 8 of 42 layers, bf16, batch 4
    of 1024 tokens): its step traced on fake tensors of the card under the
    cost model, against FlopCounterMode and max_memory_allocated on the
    real step, and its bound against the measured median."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch.hlo_cost import analyze_graph
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import param_tree
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("gemma2-9b"),
                              num_layers=SERVE_LAYERS)
    model = _model_on_card(cfg, "cost-train",
                           f" (depth cut 42 -> {SERVE_LAYERS})")
    params = param_tree(model)
    opt = adamw_init(params)
    g = torch.Generator("cuda").manual_seed(1)
    seq = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1),
                        generator=g, device="cuda", dtype=torch.int32)
    batch = {"tokens": seq[:, :-1].contiguous(),
             "targets": seq[:, 1:].contiguous(),
             "loss_mask": torch.ones((TRAIN_B, TRAIN_S), device="cuda")}
    step = make_train_step(model, donate=True)      # as Trainer runs it
    t0 = time.perf_counter()
    with FakeTensorMode() as fm:
        fake = tree_map(fm.from_tensor, (params, opt, batch))
        cost, _ = analyze_graph(step, fake)
    log(f"[cost-train] fake trace of the step: {time.perf_counter() - t0:.1f}"
        " s on the host")
    step(params, opt, batch)                          # warm
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    real_peak, base = _real_peak(lambda: step(params, opt, batch))
    med, times = _median_step_ms(lambda: step(params, opt, batch), 3)
    return _judge_cost("cost-train", cost, fc.get_total_flops(), real_peak,
                       base, med, times)


def _cost_decode() -> dict:
    """Phase 4's model (qwen2.5-32b, 8 of 64 layers) decoding 4 lanes of
    2048 tokens in paged mode: the plain step (``impl="xla"``) counted on
    the card's tensors, against FlopCounterMode and max_memory_allocated on
    the same plain step; the bound against the median of the kernel step,
    K1 once per layer, which computes the same function."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch.hlo_cost import analyze_graph

    cfg = dataclasses.replace(get_config("qwen2.5-32b"),
                              num_layers=SERVE_LAYERS)
    model = _model_on_card(cfg, "cost-decode", " (of 64)")
    B, S, page = COST_DECODE_B, COST_DECODE_S, COST_PAGE
    W = -(-(S + 1) // page)
    pool = model.init_paged_state(B * W, page)
    table = torch.arange(B * W, dtype=torch.int32, device="cuda").reshape(B, W)
    g = torch.Generator("cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                            device="cuda", dtype=torch.int32)
    rows_at = torch.arange(S, device="cuda")
    for b in range(B):
        rows, _ = model.paged_prefill(prompts[b:b + 1])
        model.paged_write_prefill(pool, rows, table[b, rows_at // page],
                                  rows_at % page)
        del rows
    tokens = prompts[:, -1].contiguous()
    pos = torch.full((B,), S, dtype=torch.int32, device="cuda")

    def decode():
        return model.paged_decode_step(pool, tokens, table, pos)

    model.impl = "xla"
    try:
        decode()                                      # warm
        real_peak, base = _real_peak(decode)
        with FlopCounterMode(display=False) as fc:
            decode()
        cost, _ = analyze_graph(decode, resident=list(model.parameters())
                                + list(pool.values()) + [table, tokens, pos])
    finally:
        model.impl = "kernel"
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    steps = 10
    decode()
    med, times = _median_step_ms(decode, steps)
    launches = {n: fn.launches for n, fn in counters.items()}
    want = (steps + 1) * cfg.num_layers
    if launches["paged_attention"] != want or any(
            v for n, v in launches.items() if n != "paged_attention"):
        raise AssertionError(f"[cost-decode] launches {launches}, want K1 "
                             f"{want} alone")
    log(f"[cost-decode] B={B} lanes at {S} tokens, pages of {page}: K1 "
        f"launched {launches['paged_attention']} = {steps + 1} steps x "
        f"{cfg.num_layers} layers")
    out = _judge_cost("cost-decode", cost, fc.get_total_flops(), real_peak,
                      base, med, times)
    out["launches"] = launches
    return out


#: the dry run's processes, (arch, shape, Popen), and when they started
_DRYRUN: list = []
_DRYRUN_T0 = 0.0
_DRYRUN_OUT = ROOT / "experiments" / "dryrun_torch"     # the CLI's default


def _start_dryrun() -> None:
    """Starts each cell of DRYRUN_CELLS through ``python -m
    repro_torch.launch.dryrun`` (fake CUDA tensors on a fake world of 256:
    host work alone), in processes of their own side by side, once, at the
    lowest priority and on one thread each.  With phase 19 among others
    they start before phase 3 and take the cores the phases leave idle;
    phase 19 reads them."""
    global _DRYRUN_T0
    if _DRYRUN:
        return
    env = dict(os.environ, PYTHONPATH=_SRC, OMP_NUM_THREADS="1")
    _DRYRUN_T0 = time.perf_counter()
    _DRYRUN.extend((arch, shape, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(_DRYRUN_OUT)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT, preexec_fn=lambda: os.nice(19)))
        for arch, shape in DRYRUN_CELLS)


def _stop_dryrun() -> None:
    """Kills the dry run's processes that are still running."""
    for _, _, proc in _DRYRUN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _dryrun_cells() -> None:
    """Each cell of DRYRUN_CELLS through the dry run's CLI
    (:func:`_start_dryrun`, if not started yet), each JSON read back and
    logged."""
    out_dir = _DRYRUN_OUT
    _start_dryrun()
    runs = []
    try:
        for arch, shape, proc in _DRYRUN:
            out, err = proc.communicate(timeout=600)
            runs.append((arch, shape, proc.returncode, out, err))
    finally:
        _stop_dryrun()
    for arch, shape, rc, out, err in runs:
        if rc or "[ok]" not in out:
            raise AssertionError(f"[dryrun] {arch} {shape} failed:\n"
                                 f"{out[-3000:]}{err[-3000:]}")
        d = json.loads((out_dir / f"{arch}__{shape}__16x16.json").read_text())
        rf, mem = d["roofline"], d["memory"]
        colls = {k: f"{v['count']:.0f} x, {v['wire'] / 1e9:.3f} GB"
                 for k, v in d["collectives"].items()}
        log(f"[dryrun] {arch} {shape} 16x16 rank 0 of {d['chips']} "
            f"({d['device']} fake tensors, trace {d['compile_s']} s): "
            f"{d['hlo_flops_per_chip']:.4e} FLOPs, "
            f"{d['hlo_bytes_per_chip']:.4e} bytes, wire "
            f"{d['collective_wire_bytes_per_chip']:.4e} bytes {colls}; peak "
            f"{mem['peak_bytes'] / 1e9:.1f} GB of {mem['card_bytes'] / 1e9:.0f}"
            f" GB (fits {mem['fits']}); useful_flop_ratio "
            f"{rf['useful_flop_ratio']:.4f}; bound "
            f"{rf['step_s_lower_bound'] * 1e3:.1f} ms ({rf['dominant']}, H100 "
            f"SXM datasheet constants)")
        if d["kind"] == "train" and not mem["fits"]:
            raise AssertionError(f"[dryrun] {arch} {shape}: a rank's peak "
                                 f"{mem['peak_bytes'] / 1e9:.1f} GB does not "
                                 "fit the card")
    log(f"[dryrun] {len(runs)} cells in {time.perf_counter() - _DRYRUN_T0:.1f}"
        " s since they started")


def phase_cost_model() -> dict:
    """Phase 19: the cost model (``launch/hlo_cost.py``) on two steps of
    the card and the dry run (``launch/dryrun.py``) on two production
    cells.  No kernel but K1 in the decode step's timing."""
    train = _cost_train()
    _free_card()
    decode = _cost_decode()
    _free_card()
    _dryrun_cells()
    return decode["launches"]


# ------------------------------------------------------------- phase 20

#: phase 20's cells, all run by default (``--mesh-serve-cells``)
MESH_SERVE_CELLS = ("dense", "sp", "moe", "rwkv", "hybrid", "audio")
#: per cell: (arch, layers, (data, model), lanes, prompt tokens, max_seq,
#: greedy decode steps).  dense: the prompt crosses the ranks' window
#: boundary at 1024 and the steps land on rank 1's window; sp: neither the
#: 40 q heads, the 1000 tokens nor the 2048 rows divide 3 (the query-rows
#: split on a padded sequence, K2 at each rank's offset, the cache whole on
#: every rank); rwkv: each rank runs K3 on its 2 of the 4 rows and keeps
#: 32 of each head's 64 value columns of the state; hybrid: 4 layers, so
#: that layer 1 has the window of 1024, its 25 q and 5 kv heads dividing 2
#: neither (the query-rows split, K2 at each rank's offset) and its
#: ``d_inner`` of 3200 split; audio: whisper at full depth, the 1500
#: frames split, 6 heads (its cross K/V split by heads), the steps crossing
#: the ranks' window boundary at 64
MESH_SERVE = {
    "dense": ("gemma2-9b", 4, (2, 2), 4, 1280, 2048, 64),
    "sp": ("qwen2.5-32b", 2, (1, 3), 4, 1000, 2048, 16),
    "moe": ("qwen3-moe-235b-a22b", 1, (1, 2), 2, 512, 1024, 16),
    "rwkv": ("rwkv6-3b", 2, (1, 2), 4, 1000, 1024, 16),
    "hybrid": ("hymba-1.5b", 4, (1, 2), 4, 1500, 2048, 16),
    "audio": ("whisper-tiny", 4, (1, 2), 4, 60, 128, 16),
}
#: the kernel each cell's path runs (whisper's runs none: its attention is
#: the reference's plain blockwise route)
MESH_SERVE_KERNEL = {"dense": "flash_attention", "sp": "flash_attention",
                     "moe": "flash_attention", "rwkv": "wkv6",
                     "hybrid": "flash_attention", "audio": None}
#: the mesh's logits (relative L2, each step's rows) and each rank's window
#: of each decode-state leaf (relative L2, each layer) against one
#: device's, bf16.  Each rank rounds its partial products (its heads'
#: share of ``wo``, its slice of ``d_ff``) to bf16 before they are summed
#: over ``model``, where one device rounds each whole product once, so
#: neither is bit-equal (layer 0's cache, before any such sum, is).  Sound
#: runs on the H100 read 0.0547-0.056 (logits) and 0.0263-0.0289 (caches,
#: the deepest layer) for gemma2-9b x4, 0.00774 / 0.00522 for qwen2.5-32b
#: x2 and 0.00903 / 0 for qwen3-moe x1; copies of src/ whose decode
#: softmax is each rank's own, or whose cache write ignores the rank's
#: window, read 1.08 / 0.433 and 0.899 / 0.45.  The limits sit 1.8x and
#: 1.7x above the sound readings, 9x below the broken ones.  A logits row
#: whose token took other experts than on one device (a near tie of the
#: router, moved by that rounding) is logged and left out: one expert more
#: or less is a different sum, not a rounding
MESH_SERVE_LOGIT_REL, MESH_SERVE_CACHE_REL = 0.1, 0.05
#: hymba's logits limit against one device's bf16 run.  Its fp32 witness
#: (below) shows what moves it: at decode step 8 one device's own bf16
#: logits depart 0.210 from its fp32 run while the ranks' depart 0.035, so
#: the two bf16 runs read 0.233 apart there; at the other 16 steps one
#: device's bf16 departs 0.017-0.075 from fp32 and the ranks' 0.018-0.073
#: (the H100, the same each run).  Copies of src/ that drop K2's query
#: offset or the sum over ``model`` of the SSM's ``xc @ w_B`` /
#: ``xc @ w_C`` read 0.873 and 1.11.  The limit sits 1.7x above the sound
#: reading, 2.2x below the broken ones
MESH_SERVE_LOGIT_LIMIT = {"hybrid": 0.4}
#: the cells whose one-device run is repeated in fp32 (the same weights
#: upcast, the same prompt, fed the bf16 run's greedy tokens): how far bf16
#: alone moves each step's logits, logged beside each rank's distance to
#: that run, which is held to ``MESH_SERVE_LOGIT_REL`` (hymba: sound 0.073,
#: the copy without K2's query offset 0.873)
MESH_SERVE_FP32_WITNESS = ("hybrid",)


def _serve_cfg(cell: str):
    """The cell's config: published widths, cut in depth; the MoE's
    capacity factor raised to E / k, so that no copy is dropped on one
    device or on a shard and the two route alike."""
    from repro_torch.configs import get_config

    arch, layers = MESH_SERVE[cell][:2]
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if cfg.is_moe:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    return cfg


def _serve_model(cfg):
    from repro_torch.models import build_model

    return build_model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0))


def _serve_inputs(cfg, B: int) -> dict:
    """The prefill's inputs besides the prompt, on the CPU: whisper's
    seeded frames (B, 1500, D) in its dtype, else none."""
    if cfg.family != "audio":
        return {}
    g = torch.Generator().manual_seed(21)
    frames = torch.randn((B, cfg.encoder_len, cfg.d_model), generator=g)
    return {"frames": (frames * 0.5).to(getattr(torch, cfg.dtype))}


def _state_of(state) -> dict:
    """The decode state's leaves but ``pos``, copied to the CPU."""
    return {k: v.to("cpu", copy=True) for k, v in state.items() if k != "pos"}


def _serve_one_device(cell: str, path: str) -> dict:
    """The cell on one device (the same weights, dtype, prompt and frames):
    the prefill, then greedy decode steps, saved to ``path`` for the ranks
    (prompt, inputs, greedy tokens, each step's logits, the decode state
    after the prefill and after the steps).  Returns its kernel launches,
    peak memory and times."""
    _, _, _, B, S, max_seq, steps = MESH_SERVE[cell]
    cfg = _serve_cfg(cell)
    model = _serve_model(cfg)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=(
        torch.Generator().manual_seed(20)), dtype=torch.int32)
    inputs = _serve_inputs(cfg, B)
    counters = _zero_counters()
    routes: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _spy_routing(_route_log(routes)):
        t0 = time.perf_counter()
        state, logits = model.prefill(
            prompt.cuda(), max_seq=max_seq,
            **{k: v.cuda() for k, v in inputs.items()})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        state0 = _state_of(state)
        rows, stream, times = [logits.cpu()], [], []
        for _ in range(steps):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            stream.append(tok.cpu())
            t0 = time.perf_counter()
            state, logits = model.decode_step(state, tok)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            rows.append(logits.cpu())
    out = {"launches": {k: fn.launches for k, fn in counters.items()},
           "peak": torch.cuda.max_memory_allocated(),
           "prefill_s": t_prefill, "step_ms": float(np.median(times)) * 1e3}
    saved = {"prompt": prompt, "inputs": inputs,
             "stream": torch.stack(stream), "logits": torch.stack(rows),
             "state0": state0, "state1": _state_of(state),
             "routes": _logit_row_routes(routes, cfg.num_layers, B, S, 0, S)}
    if cell in MESH_SERVE_FP32_WITNESS:
        del state
        saved["logits32"] = _fp32_run(model, cfg, prompt, inputs,
                                      saved["stream"], max_seq)
        out["bf16_vs_fp32"] = [_rows_rel(r, w) for r, w in
                               zip(saved["logits"], saved["logits32"])]
    torch.save(saved, path)
    return out


def _fp32_run(model, cfg, prompt, inputs, stream, max_seq: int
              ) -> torch.Tensor:
    """The one-device run in fp32: ``model``'s weights upcast, the same
    prompt, fed ``stream`` (the bf16 run's greedy tokens).  Each step's
    logits (the prefill's first), on the CPU."""
    from repro_torch.models import build_model

    m32 = build_model(dataclasses.replace(cfg, dtype="float32"),
                      device="cuda")
    m32.load_state_dict({k: v.float() for k, v in
                         model.state_dict().items()})
    state, logits = m32.prefill(
        prompt.cuda(), max_seq=max_seq,
        **{k: v.float().cuda() for k, v in inputs.items()})
    rows = [logits.float().cpu()]
    for tok in stream:
        state, logits = m32.decode_step(state, tok.cuda())
        rows.append(logits.float().cpu())
    return torch.stack(rows)


def _rows_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The relative L2 distance of logits rows ``got`` to ``want``."""
    d = torch.linalg.norm(got.float() - want.float())
    return float(d / max(float(torch.linalg.norm(want.float())), 1e-30))


def _route_log(routes: list):
    """A ``_spy_routing`` recorder keeping each call's experts, sorted."""
    return lambda x, r, cfg, lossless: routes.append(
        torch.sort(r.top_idx, dim=-1).values.cpu())


def _logit_row_routes(routes: list, layers: int, lanes: int, S: int,
                      start: int, c: int) -> list:
    """The experts each logits row's token took, per layer: for the
    prefill, the last prompt token of each lane where this process routed
    it (the prefill's calls route ``lanes`` x ``c`` tokens from sequence
    row ``start``, or all S), else None; then each decode step's lanes.
    Empty for a model without experts."""
    if not routes:
        return []
    out = []
    pre = routes[:layers]
    T = pre[0].shape[0]
    n = S if T == lanes * S else c
    at = S - 1 - (0 if n == S else start)
    out.append(torch.stack([t.view(lanes, n, -1)[:, at] for t in pre])
               if 0 <= at < n else None)
    for i in range(layers, len(routes), layers):
        out.append(torch.stack(routes[i:i + layers]))
    return out


def _window_rel(got: torch.Tensor, want: torch.Tensor) -> list:
    """The relative L2 distance of each layer (dimension 0)."""
    g, w = got.float(), want.float()
    return [float(torch.linalg.norm(g[l] - w[l])
                  / max(float(torch.linalg.norm(w[l])), 1e-30))
            for l in range(w.shape[0])]


@contextlib.contextmanager
def k2_offsets(out: list):
    """Records the ``q_offset`` that K2's entry point (``ops.flash_attention``,
    through which every model reaches the kernel) hands on in the block: to
    the kernel's binding on the card, one launch each, or to its plain
    version on the CPU.  The serving-mesh tests' ranks record theirs with
    it too."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    names = ("flash_attention_cuda", "flash_attention_ref")
    real = {name: getattr(fa_ops, name) for name in names}

    def spy(fn):
        def call(*args, **kw):
            out.append(int(kw.get("q_offset", 0)))
            return fn(*args, **kw)
        return call

    for name in names:
        setattr(fa_ops, name, spy(real[name]))
    try:
        yield
    finally:
        for name in names:
            setattr(fa_ops, name, real[name])


def _job_serve(cell: str, path: str) -> dict:
    """A rank of the cell: the weights at rest in the serving rules'
    shards, the prefill and the decode steps (fed one device's greedy
    tokens) through ``make_prefill_fn`` / ``make_decode_fn(shardings=)``
    in the ``seq`` layout, held to one device's saved run: logits, greedy
    tokens and the rank's window of each decode-state leaf.  Returns its
    judgements, kernel launches (and K2's query offsets), peak memory and
    times."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_decode_fn, make_prefill_fn
    from repro_torch.models.common import param_tree
    from repro_torch.parallel.sharding import param_shardings, shard_tree
    from repro_torch.tree import tree_map

    _, _, (data, model_n), B, S, max_seq, steps = MESH_SERVE[cell]
    mesh = make_host_mesh(data, model_n, device="cuda")
    cfg = _serve_cfg(cell)
    model = _serve_model(cfg)
    full = param_tree(model)
    sh = param_shardings(full, mesh, mode="serve",
                         heads_divisible=cfg.num_heads % model_n == 0)
    params = tree_map(torch.clone, shard_tree(full, sh))
    p_bytes = _tree_bytes(params)
    p_whole = _tree_bytes(full)
    del full
    for t in model.parameters():          # only the shards stay
        t.data = torch.empty(0, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    ref = torch.load(path, mmap=True)
    prefill = make_prefill_fn(model, max_seq=max_seq, shardings=sh,
                              layout="seq")
    decode = make_decode_fn(model, shardings=sh, layout="seq",
                            max_seq=max_seq)
    counters = _zero_counters()
    mesh.staged_bytes = 0
    rows = B // data
    lo = mesh.coords["data"] * rows
    m = mesh.coords["model"]
    routes: list = []
    offsets: list = []
    batch = {"tokens": ref["prompt"].cuda(),
             **{k: v.cuda() for k, v in ref["inputs"].items()}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _spy_routing(_route_log(routes)), k2_offsets(offsets):
        t0 = time.perf_counter()
        state, logits = prefill(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        prefill_launches = {k: fn.launches for k, fn in counters.items()}
        pre = _state_of(state)
        got, times = [logits.float().cpu()], []
        for i in range(steps):
            t0 = time.perf_counter()
            state, logits = decode(params, state,
                                   ref["stream"][i][lo:lo + rows].cuda())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got.append(logits.float().cpu())
    post = _state_of(state)
    windows, state_rel = {}, {}
    for key, t in pre.items():
        # the rank's lanes, and where a dimension is split, its chunk
        whole = ref["state0"][key].shape
        spans = [(m * n if n < w else 0, (m + 1) * n if n < w else w)
                 for n, w in zip(t.shape[2:], whole[2:])]
        win = (slice(None), slice(lo, lo + rows),
               *(slice(a, b) for a, b in spans))
        windows[key] = spans
        state_rel[key] = (_window_rel(t, ref["state0"][key][win]),
                          _window_rel(post[key], ref["state1"][key][win]))
    w32 = ref.get("logits32")
    rel32 = [] if w32 is None else [_rows_rel(g, w32[i][lo:lo + rows])
                                    for i, g in enumerate(got)]
    c = -(-S // model_n)
    mine = _logit_row_routes(routes, cfg.num_layers, rows, S, m * c, c)
    flips = [(i, lo + b) for i, (r, w) in enumerate(zip(mine, ref["routes"]))
             if r is not None
             for b in range(rows) if not torch.equal(r[:, b], w[:, lo + b])]
    rel, forks, clear = [], 0, []
    for i, g in enumerate(got):
        w = ref["logits"][i][lo:lo + rows].float()
        rel.append([(float(torch.linalg.norm(g[b] - w[b])),
                     float(torch.linalg.norm(w[b]))) for b in range(rows)])
        for b in range(rows):
            if int(torch.argmax(g[b])) == int(torch.argmax(w[b])):
                continue
            forks += 1
            top2 = torch.topk(w[b], 2).values
            if float(top2[0] - top2[1]) >= 2 * float((g[b] - w[b]).abs()
                                                     .max()):
                clear.append((i, lo + b))
    return {"launches": {k: fn.launches for k, fn in counters.items()},
            "prefill_launches": prefill_launches,
            "k2_offsets": sorted(set(offsets)), "chunk": c,
            "peak": torch.cuda.max_memory_allocated(),
            "p_bytes": p_bytes, "p_whole": p_whole, "lanes": (lo, lo + rows),
            "windows": windows, "rel": rel, "flips": flips, "forks": forks,
            "clear": clear, "state_rel": state_rel, "rel32": rel32,
            "prefill_s": t_prefill,
            "step_ms": float(np.median(times)) * 1e3,
            "staged": mesh.staged_bytes}


def _logit_rel(x: dict, skip) -> list:
    """A rank's relative L2 distance of each step's logits rows to one
    device's (the prefill's first), the rows ``skip`` (step, lane) left
    out."""
    lo = x["lanes"][0]
    out = []
    for i, step in enumerate(x["rel"]):
        kept = [dw for b, dw in enumerate(step) if (i, lo + b) not in skip]
        d = sum(a * a for a, _ in kept) ** 0.5
        w = sum(b * b for _, b in kept) ** 0.5
        out.append(d / max(w, 1e-30) if kept else 0.0)
    return out


def _job_serve_cells(cells, paths) -> list:
    """A rank of each cell of ``cells`` (one mesh shape) in turn:
    :func:`_job_serve`'s results."""
    out = []
    for cell, path in zip(cells, paths):
        out.append(_job_serve(cell, path))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _mesh_serve(cells) -> dict:
    """Cells of one mesh shape: each on one device, then one spawn of
    ranks running them all against those runs, each cell judged.  Returns
    each kernel's launches summed over the ranks and cells."""
    import tempfile

    data, model_n = MESH_SERVE[cells[0]][2]
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, f"{cell}.pt") for cell in cells]
        ones = []
        t0 = time.perf_counter()
        for cell, path in zip(cells, paths):
            ones.append(_serve_one_device(cell, path))
            _free_card()
        t1 = time.perf_counter()
        runs = _run_mesh(_job_serve_cells, data * model_n, cells, paths)
        t2 = time.perf_counter()
    log(f"[mesh-serve] {', '.join(cells)} on (data={data}, model={model_n}):"
        f" one device {t1 - t0:.1f} s, the ranks {t2 - t1:.1f} s with the "
        f"spawn")
    out: dict = {}
    for i, (cell, one) in enumerate(zip(cells, ones)):
        for name, n in _judge_serve(cell, one, [r[i] for r in runs]).items():
            out[name] = out.get(name, 0) + n
    return out


def _judge_serve(cell: str, one: dict, ranks: list) -> dict:
    """Logs a cell's ranks against its one-device run and fails it past
    its limits.  Returns each kernel's launches summed over the ranks."""
    arch, layers, (data, model_n), B, S, max_seq, steps = MESH_SERVE[cell]
    kernel = MESH_SERVE_KERNEL[cell]
    tag = f"mesh-serve-{cell}"
    flips = sorted({f for x in ranks for f in x["flips"]})
    for x in ranks:
        x["logit_steps"] = _logit_rel(x, flips)
        x["logit_rel"] = max(x["logit_steps"])
        x["logit_rel_all"] = max(_logit_rel(x, []))
    for r, x in enumerate(ranks):
        lo, hi = x["lanes"]
        runs = {k: v for k, v in x["launches"].items() if v}
        log(f"[{tag}] rank {r}: launches {runs or 'none'} ("
            f"{ {k: v for k, v in x['prefill_launches'].items() if v} } in "
            f"the prefill); K2's query offsets {x['k2_offsets']}")
        state = "; ".join(
            f"{k} {x['windows'][k]} within "
            f"{[round(e, 4) for e in x['state_rel'][k][0]]} / "
            f"{[round(e, 4) for e in x['state_rel'][k][1]]}"
            for k in x["state_rel"])
        log(f"[{tag}] rank {r}: lanes [{lo}, {hi}); decode state (its "
            f"window past the lanes, relative L2 by layer to one device's "
            f"after the prefill / the steps): {state}; logits within "
            f"{x['logit_rel']:.3g} (by step, the prefill's first: "
            f"{[round(e, 4) for e in x['logit_steps']]}); "
            f"{x['forks']} greedy tokens of {(steps + 1) * (hi - lo)} differ, "
            f"{len(x['clear'])} at a clear margin; weights "
            f"{x['p_bytes'] / 1e9:.3f} GB of {x['p_whole'] / 1e9:.3f}; peak "
            f"(max_memory_allocated) {x['peak'] / 1e9:.2f} GB against one "
            f"device's {one['peak'] / 1e9:.2f}; prefill {x['prefill_s']:.2f}"
            f" s, decode step {x['step_ms']:.1f} ms (one device "
            f"{one['prefill_s']:.2f} s, {one['step_ms']:.1f} ms; ranks "
            f"time-sharing one card over gloo: not a parallel speed); "
            f"{x['staged'] / 1e9:.2f} GB staged through the host")
    if "bf16_vs_fp32" in one:
        log(f"[{tag}] fp32 witness (one device in fp32: the same weights "
            f"upcast, fed the same tokens; logits' relative L2 by step, the "
            f"prefill's first): one device's bf16 "
            f"{[round(e, 4) for e in one['bf16_vs_fp32']]}; "
            + "; ".join(f"rank {r}'s {[round(e, 4) for e in x['rel32']]}"
                        for r, x in enumerate(ranks))
            + f" (the ranks' limit {MESH_SERVE_LOGIT_REL:g})")
    worst = max(x["logit_rel"] for x in ranks)
    every = max(x["logit_rel_all"] for x in ranks)
    logit_limit = MESH_SERVE_LOGIT_LIMIT.get(cell, MESH_SERVE_LOGIT_REL)
    state = max(max(max(e) for e in pair) for x in ranks
                for pair in x["state_rel"].values())
    if flips:
        log(f"[{tag}] {len(flips)} of {(steps + 1) * B} logits rows come "
            f"from a token whose experts differ from one device's at a "
            f"layer (step, lane): {flips[:12]}; over every row the logits "
            f"are within {every:.3g}; the limit below holds the others")
    clear = [x["clear"] for x in ranks if x["clear"]]
    counts = {name: [x["launches"][name] for x in ranks]
              for name in ranks[0]["launches"]}
    log(f"[{tag}] {arch} x{layers} {_serve_cfg(cell).dtype} on "
        f"(data={data}, model={model_n}), "
        f"{data * model_n} gloo ranks on cuda:0, {B} lanes of {S} tokens "
        f"into {max_seq} rows (seq layout, serving rules), {steps} "
        f"greedy steps: logits within {worst:.3g}, decode state within "
        f"{state:.3g} of one device's (limits {logit_limit:g}, "
        f"{MESH_SERVE_CACHE_REL:g}); "
        + (f"{kernel} {counts[kernel]} a rank, one device "
           f"{one['launches'][kernel]}" if kernel else "no kernel on the "
           "path"))
    if worst > logit_limit or state > MESH_SERVE_CACHE_REL or clear:
        raise AssertionError(f"[{tag}] off one device: logits {worst:.3g}, "
                             f"decode state {state:.3g}, forks at clear "
                             f"margins {clear}")
    worst32 = max(max(x["rel32"], default=0.0) for x in ranks)
    if worst32 > MESH_SERVE_LOGIT_REL:
        raise AssertionError(f"[{tag}] logits {worst32:.3g} off one "
                             f"device's fp32 run (limit "
                             f"{MESH_SERVE_LOGIT_REL:g})")
    other = {k: v for k, v in counts.items() if k != kernel and any(v)}
    if other:
        raise AssertionError(f"[{tag}] kernels off the path launched: "
                             f"{other}")
    if kernel and one["launches"][kernel] and not all(counts[kernel]):
        raise AssertionError(f"[{tag}] {kernel} launches {counts[kernel]}: "
                             "a rank ran the plain route")
    cfg = _serve_cfg(cell)
    if kernel == "flash_attention" and cfg.num_heads % model_n and \
            one["launches"][kernel]:
        # the query-rows split: each rank's queries start at its chunk
        want = [[r * x["chunk"]] for r, x in enumerate(ranks)]
        got = [x["k2_offsets"] for x in ranks]
        if got != want:
            raise AssertionError(f"[{tag}] K2's query offsets {got}, the "
                                 f"ranks' chunks start at {want}")
    return {name: sum(v) for name, v in counts.items()}


def phase_mesh_serving() -> dict:
    """Phase 20: every family served on a mesh in the reference's serving
    layout, gloo ranks on ``cuda:0``, each cell of ``--mesh-serve-cells``
    against one device.  Returns each kernel's launches over the ranks."""
    import multiprocessing

    out = {name: 0 for name in _launch_counters()}
    groups: dict = {}                  # the cells of each mesh shape
    for cell in MESH_SERVE_CELLS:
        groups.setdefault(MESH_SERVE[cell][2], []).append(cell)
    for cells in groups.values():
        for name, n in _mesh_serve(cells).items():
            out[name] += n
        _free_card()
    left = [p.pid for p in multiprocessing.active_children()
            if p.name.startswith("repro-torch-rank")]
    if left:
        raise AssertionError(f"[mesh-serve] ranks left: {left}")
    log("[mesh-serve] every rank started here has ended")
    return out


def _free_card() -> None:
    """Frees what a serving phase left behind (its model and engine are
    garbage once it returns) and logs what stays allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[smoke] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        "after the phase")


# --------------------------------------------------------------- main


def main(argv=None) -> int:
    global MESH_CELLS, MESH_SERVE_CELLS
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,"
                            "19,20")
    ap.add_argument("--mesh-cells", default=",".join(MESH_CELLS),
                    help="phase 18's cells to run, of " + ",".join(MESH_CELLS))
    ap.add_argument("--mesh-serve-cells", default=",".join(MESH_SERVE_CELLS),
                    help="phase 20's cells to run, of "
                         + ",".join(MESH_SERVE_CELLS))
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="where to import repro_torch from (another "
                         "checkout's src/, to run its kernels and models "
                         "under these phases)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    MESH_CELLS = tuple(c for c in MESH_CELLS
                       if c in args.mesh_cells.split(","))
    MESH_SERVE_CELLS = tuple(c for c in MESH_SERVE_CELLS
                             if c in args.mesh_serve_cells.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    global _SRC
    _SRC = str(Path(args.src).resolve())
    sys.path.insert(0, _SRC)
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.launch import hlo_cost

    global HBM_BYTES_PER_S, PEAK_FLOPS, _CARD
    HBM_BYTES_PER_S, PEAK_FLOPS = hlo_cost.HBM_BW, hlo_cost.PEAK_FLOPS
    log(f"[smoke] repro_torch from {Path(repro_torch.__file__).parent}")
    _CARD = phase_device()
    if 2 in phases:          # otherwise the kernels build at first launch
        phase_build()
    if 19 in phases and phases - {1, 2, 19}:
        _start_dryrun()
    try:
        return _run_phases(phases)
    finally:
        _stop_dryrun()


def _run_phases(phases: set) -> int:
    """Phases 3-20 of ``phases``, then the summary lines with all of them.
    Returns the exit code."""
    results = {}
    if 3 in phases:
        t0 = time.perf_counter()
        results["paged_attention"] = check_paged()
        results["flash_attention"] = check_flash()
        results["flash_attention"].update(check_flash_offset())
        check_small_head_dims()
        results["wkv6"] = check_wkv6()
        results["segment_zero"] = check_segment_zero()
        log(f"[smoke] phase 3 took {time.perf_counter() - t0:.1f} s")
    # each kernel's launches on the serving paths, by phase (K1: phases 4,
    # 8, 9, 11, 13, 16, 17 and 19; K2: 4, 7, 8, 9, 10, 11, 12, 13, 16, 17
    # and 20, phases 17's and 20's summed over the ranks; K3: 6 and 20);
    # K4 is on no path, and the paths of phases 14, 15 and 18 have no kernel
    runs = {4: phase_serving, 5: phase_card_vs_cpu, 6: phase_rwkv_serving,
            7: phase_gemma_serving, 8: phase_chunked_and_rebatching,
            9: phase_moe_paged, 10: phase_moe_dense, 11: phase_server,
            12: phase_hybrid_serving, 13: phase_vlm, 14: phase_whisper,
            15: phase_training, 16: phase_orchestration,
            17: phase_tensor_parallel, 18: phase_mesh_training,
            19: phase_cost_model, 20: phase_mesh_serving}
    by_phase = {name: {} for name in _launch_counters()}
    for n, phase in runs.items():
        if n in phases:
            t0 = time.perf_counter()
            for name, count in (phase() or {}).items():
                if count:
                    by_phase[name][n] = count
            _free_card()
            log(f"[smoke] phase {n} took {time.perf_counter() - t0:.1f} s")
    if not set(range(3, 21)) <= phases:
        log(f"[smoke] phases {sorted(phases)} passed; no result line")
        return 0
    meta = {
        "paged_attention": (
            "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:102"),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:109"),
        "wkv6": (
            "src/repro_torch/csrc/wkv6.cu",
            "src/repro/kernels/wkv6/wkv6.py:71"),
        "segment_zero": (
            "src/repro_torch/csrc/segment_zero.cu",
            "src/repro/kernels/segment_zero/segment_zero.py:35"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_phase[name].values()),
            "launches_by_phase": by_phase[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "tol": r["tol"],
        })
        # K1: "ms" is with the L2 cache flushed, "warm_ms" warm, "g16" at
        # qwen3-moe's grouping, "g7" at llava's; K2: "h64" at qwen3-moe's
        # heads, "w512" with a window at head dim 128, "w8192" at llama4's
        # window and 10000 tokens, "hd256" at gemma2's head dim, "hymba"
        # at hymba's heads and window, "llava" at llava's heads, "offset"
        # (hymba's) and "offset_hd128" / "offset_hd256" at a query offset,
        # a serving rank's rows of the sequence; K4:
        # "inplace_zero_ms", narrow().zero_() (not the same function)
        for key in ("warm_ms", "g16", "g7", "h64", "w512", "w8192", "hd256",
                    "hymba", "llava", "offset", "offset_hd128",
                    "offset_hd256", "inplace_zero_ms"):
            if key in r:
                kernels[-1][key] = r[key]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
