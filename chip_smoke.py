#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. card: print the card's name and power limit (nvidia-smi);
2. build: compile every CUDA kernel of the serving and training paths from
   the sources in this checkout (nvcc, sm_90a, one process per source, each
   timed) into build/kernels/; the bf16 flash kernel's SASS must hold HGMMA
   (wgmma on the tensor cores) and UTMALDG (TMA loads);
3. kernels: hold each kernel against its plain PyTorch version on the card
   at its serving path's shapes (kNN: bit-equal at all six level shapes of
   the two buckets, on each bucket's calibrated grid; segment-sum: the
   65,536-point bucket, full width; flash attention: gemma2-9b prefill of
   2 x 4,608 tokens, with the 4,096 window and without, softcap 50, bf16
   through the wgmma kernel and f32 through the CUDA-core kernel; bf16 also
   per row, where the plain version with a key tile dropped must fail; f32
   per row logged; the same at head_dim 128: qwen3-moe-30b-a3b's prefill,
   2 x 4,608 tokens, H 32, KV 4, causal, no window or softcap, timed in
   both dtypes beside SDPA (causal, GQA: the same function) and, in bf16,
   ``flex_attention``; and, for correctness only at 640 tokens, GQA groups
   7 (yi) and 12 (starcoder2) and a window with a softcap, in both dtypes),
   and time each (f32 flash too, by CUDA events: its time,
   its bound at 67 TFLOP/s, its TFLOP/s, ``flex_attention`` compiled in
   f32, and its ``torch.profiler`` device time if a profile of 10 launches
   holds them all, else how many it held): the kernel's device
   time (``device_ms``, ``torch.profiler`` by kernel name), the wrapper's
   call on CUDA events (``call_ms``: host work plus kernels), the plain
   version, one library call for the same
   function (kNN: ``torch.topk``; segment-sum: ``index_add_``; flash:
   ``flex_attention`` with the softcap, compiled; SDPA without it beside) on
   events and by its device kernels (``library_device_ms``), and the bound
   (bytes over 3.35 TB/s, or flops over 67 TFLOP/s in f32 and 989 in bf16)
   with ``fraction_of_bound`` = bound / device time. The segment-sum
   backward kernel (training) is held bit-equal to its plain version, masked
   rows zero, at the shape of a training partition (65,536 points, 8
   partitions: one partition of sample 0), with
   ``torch.index_select(grad_out, 0, recv)`` times the edge mask as its
   yardstick; so is the gathers' backward (``gather_rows_backward``: the
   segment-sum kernel over the sender CSR, reading a column slice of an
   (E, 3 x 512) gradient in place), bit-equal to its plain version over
   both CSRs, its bound from the valid edges, with ``index_add_`` and
   ``index_put_(accumulate=True)`` (the sort-based path it replaces) as
   yardsticks, each CSR's longest and mean run logged, and the segment-sum
   forward timed at the same shape; these run after phase 8, before
   phase 9;
4. whole path: one 2,048-point request through the full-width model
   (``GNNConfig()``) on the card and on the CPU (plain versions), same
   params; edges must be equal and fields agree to 1e-4;
5. serve: ``GNNServer(GNNConfig(), (16384, 65536), max_batch=2)``, warmup
   plus 4 demo requests, latency reported per bucket; the launch counters
   must show 15 segment-sum and 3 kNN launches per request run, warmup
   included;
6. breakdown: where one 65,536-point request's time goes, and one row's
   time through each bucket's pipeline;
12. the serving engine at full width (after phase 6, same weights): (a) the
   4 requests of phase 5 through ``flush(async_mode=False)`` and
   ``flush(async_mode=True)`` of two servers, fields bit-equal to each
   other and to phase 5's, the first 65,536-point dispatch's event still
   pending when ``_dispatch`` returns (the host's lead over the card, the
   flush times, ``stage_report()`` and peak memory logged), and the
   operations one 16,384-point row queues on the card (``torch.profiler``)
   logged; (b) the auto ladder on the same traffic (ladder logged, fields
   bit-equal), then ``max_live_buckets=1``: evict and rebuild, bit-equal,
   no new calibration; (c) the background worker, ``start(deadline_s=0.05)``,
   the requests submitted from 2 threads in turn and collected with
   ``result(rid, timeout=...)``, bit-equal, ``health()`` alive, then not
   after ``stop()``, no waiter left; with telemetry on, every host stage
   histogram observed, ``compile``/``cache_load`` empty, the trace
   exported under build/ and removed; (d) on the 16,384-point bucket: a
   harvest corrupted in one row of 2 errors that request only (the other
   bit-equal), a ``bucket.build`` failure quarantines 16,384 and the
   65,536 bucket serves its batch (one fallback), and an expired request
   and one shed by admission (``max_queue_depth=1``) launch nothing; (e)
   15 segment-sum and 3 kNN launches per row run, and no other kernel,
   in every part;
13. rollouts at full width (last, after phase 11's profiled step; phase
   5's weights and seed,
   servers at both buckets, ``max_batch`` 2): (a) a fresh server's
   ``rollout(car 1, 16384, steps=1)`` bit-equal to phase 5's request 0,
   with 3 kNN and 15 segment-sum launches; (b) residual, 2 steps a flush,
   4 slots: fixed clouds rolled out 3, 5 and 8 steps in the 16,384 table, 2
   in the 65,536 table, and a 4-step 16,384 arrival after the first flush,
   each bit-equal to its solo run on a fresh server, the 5-step one to 5
   one-step rollouts chained through ``init_state``, step 5 unequal to step
   1; exactly 3 kNN launches per prefill and 15 segment-sum per lane-step
   advanced; prefill and lane-step seconds per bucket, steps/s, the slot
   tables' bytes and peak memory (beside phase 5's) logged; (c) state
   feedback (``rollout_state_feats``, 28 node inputs), residual, full width
   cut to one 2,048-point bucket, fresh ``torch.Generator`` weights: a
   FEEDBACK_STEPS-step rollout on the card and on the CPU must build equal
   edges and
   agree to 1e-4; (d) a ``rollout.generate`` raise fails the 16,384
   table's rollout (the table dropped) and leaves a 65,536 rollout in
   flight bit-equal to its solo run, a NaN ``rollout.insert`` aborts its
   own slot (the neighbour bit-equal to solo), a ``rollout.harvest``
   corruption is caught by the guard, and a queued rollout past its
   deadline and one rejected by admission launch nothing;
7. LLM whole path: gemma2-9b at full width cut to 2 layers (one local and
   one global), f32, initialised once on the card and copied to the CPU;
   2 requests of 128 tokens prefilled and decoded 4 steps on both; tokens
   must be equal and logits agree to LLM_ATOL;
8. LLM serve: ``repro_torch.launch.serve.serve`` of gemma2-9b at full
   width in bf16, 2 requests of 4,608 tokens (past the 4,096 window) and
   32 generated; flash attention must launch once per layer of the one
   prefill and never in decode; then where one prefill's time goes, and the
   profile must show those launches as the wgmma kernel.
19. the head_dim-128 decoders (after phase 8): (a) qwen3-moe-30b-a3b,
   deepseek-moe-16b (a dense first layer, then MoE with shared experts),
   starcoder2-15b (LayerNorm, a biased GELU MLP, GQA 12) and pixtral-12b
   (1,024 patch embeddings from a seed before the prompt) at full width cut
   to 2 layers, f32, in phase 7's form: tokens equal and logits within
   LLM_ATOL, the f32 flash kernel launched once per layer, and per MoE
   layer the routing decisions that differ between the card and the CPU on
   the card's inputs counted (a flip within ROUTE_TIE of a tie holds each
   MoE layer by its inputs instead; any other flip fails); (b)
   ``serve`` of qwen3-moe-30b-a3b at full width and depth in bf16, 2 x
   4,608 tokens and 32 generated, as phase 8: 48 flash launches in the
   prefill and none in decode, peak memory, ``prefill_s``, decode ms/token,
   and one profiled prefill and decode step split into attention, expert
   GEMMs, dispatch and combine, and the rest (the MoE layer's profiler
   marks), the prefill's 48 launches shown as the wgmma kernel.

9. training whole path: ``GNNConfig()`` at full width cut to 2
   message-passing layers and halo 2, a 2,048-point sample in 2 partitions;
   one optimizer step of ``launch.train.make_gnn_step_fn`` on the card and
   on the CPU from the same parameters: equal partition batches, the loss,
   every gradient leaf (the edge encoder's and edge MLPs' nonzero) and the
   updated parameters within the tolerances stated below;
10. training: ``train_gnn`` of ``GNNConfig()`` at full width (15 layers,
   hidden 512, remat) on 3 samples of 65,536 points in 8 partitions, 3
   steps, telemetry on, checkpointing every step into a temporary directory
   under build/ (removed at the end) and keeping 2 step-tagged files;
   finite losses; the launch counters must show 2 x 15 x 8 segment-sum
   forwards (forward and remat recompute), 15 x 8 backwards and 2 x 15 x 8
   gathers' backwards (``gather_rows``: senders and receivers) a step; the
   step-1 and step-2 files and the final one must exist (sizes and the
   ``checkpoint`` histogram's write seconds logged; step times from the
   ``step`` spans); then ``eval_gnn`` on the test sample (Table I metrics);
11. resume and serve from the checkpoint: ``train_gnn`` resumed from the
   step-2 file takes the last step again, and its loss and every parameter
   must be bit-equal to phase 10's (restore seconds logged; launches 2 x 15
   x 8, 15 x 8 and 2 x 15 x 8); ``GNNServer.from_checkpoint`` of the final
   file serves
   one 16,384-point demo request, whose fields must be bit-equal to those of
   a server built from phase 10's model and normalizers (15 segment-sum and
   3 kNN launches); the step-1 file resumed to step 1 must compare unequal
   to phase 10's model. Then one more training step profiled by kernel
   (after phase 11: a profile of a whole step makes torch.profiler drop
   later launches): it must hold no ``indexing_backward`` kernel (the
   gathers' backward runs the segment-sum kernel), and the time of the
   kernels launched under ``GatherRowsBackward`` is logged on a line of its
   own;
14. the ``graphx`` training-graph source (after phase 9, before phase 10):
   ``build_sample(cfg, 0, source="graphx")`` at phase 10's levels on the
   card must give the host cKDTree build's edge set and level tags, with 3
   kNN launches and no other kernel; both builds' seconds logged;
15. sharded serving and sharded rollouts at full width (after phase 13, on
   phase 5's weights and seed): (a) ``GNNServer(..., max_batch=2,
   shard_devices=4)`` (residual, 2 steps a flush, for (c)) serves phase 5's
   4 requests, each in 4 shards one after another with the ``geometric``
   planner as JAX serves them: fields within SHARD_ATOL of phase 5's on
   every point, exactly 3 x 4 kNN and 15 x 4 segment-sum launches a
   request, Nmax, replication, halo fraction, latency per bucket and peak
   memory logged; then a ``shard.plan`` raise rejects its request only, its
   batch neighbour bit-equal to its unfaulted run and the rejected request
   launching nothing; (c) that server's engine rolls out fixed clouds of car
   1 at 16,384 points for 3 steps and car 2 at 65,536 for 2, each within
   SHARD_ATOL of the unsharded engine's rollout, with 3 kNN launches per
   shard per flush and 15 segment-sum per shard per lane-step; state
   feedback at phase 13 (c)'s size and weights in 4 shards clamps
   ``steps_per_flush`` to 1 with its warning and must agree after
   FEEDBACK_STEPS steps with phase 13 (c)'s CPU and card runs; (b) 262,144 points of car 1,
   sampled as the server samples, planned with the ``graph`` planner in 8
   and in 4 shards and run through ``make_sharded_infer_fn`` at full width:
   the two agree within SHARD_ATOL on every point, 3 kNN and 15 segment-sum
   launches a shard; one shard's kNN is bit-equal to its plain version at
   its three level shapes and its segment-sum within SEG_ATOL at its edge
   count; Nmax, peak memory, host planning and run seconds logged, and the
   ``geometric`` plan's Nmax for the same request (not run);
16. multi-process training (last): (a) a one-rank NCCL group (a
   ``FileStore`` under build/, removed after) runs phase 9's step through
   ``make_gnn_step_fn(group=...)``: loss, grad norm, every gradient leaf
   and updated parameter bit-equal to phase 9's card step, one collective,
   phase 9's launches; the distributed-MGN baseline
   (``make_dmgn_grad_fn``) at W = 1 against the full-graph gradient of
   phase 9's sample, 2L + 1 collectives; (b) two ranks spawned on the one
   card (``gloo`` on CUDA tensors; time limits on the group and the join;
   a failing rank fails the phase): both schemes at phase 9's size against
   the full-graph card gradient within phase 9's tolerances (and the DDP
   update against phase 9's with its near-zero split), the ranks' results
   bit-equal, 1 and 2L + 1 collectives a step, segment-sum launches per
   rank those of its partitions (DDP 2L / L / 2L each; the baseline L
   forward, L backward, 3L gathers' backward); (c) ``train_gnn`` of phase
   10's config on the two ranks (4 partitions each) for 2 steps: losses
   within 1e-5 of phase 10's first two, 2 x 15 x 4 / 15 x 4 / 2 x 15 x 4
   launches a step per rank; peak memory, step seconds and the
   ``all_reduce`` seconds and bytes a step logged per rank;
17. cold start: (a) phase 5's server, right after serving, saves its deploy
   artifact (``save_artifact``; bytes and write seconds logged); (b) at the
   end, three restarted servers, each in a spawned process with a time
   limit, one after another: ``fresh`` (an empty build directory through
   ``compile_cache.enable``), ``warm`` (the same directory) and
   ``artifact`` (the same directory and ``GNNServer.from_artifact``), each
   serving phase 5's 4 requests, timed from spawn to car 2's result (its
   65,536-point batch runs after the 16,384 one), with its calibrations,
   compiles (``nvcc`` runs), cache loads and peak memory; (c) every child's
   fields bit-equal to phase 5's, 15 x 4 segment-sum and 3 x 4 kNN launches
   each, the artifact child with no calibration and no build, the warm
   child with no build, the fresh child building each library its path
   loads;
18. X-UNet3D (paper SVI) at full width (``UNetConfig()``: base 64, depth 3,
   attention gates), weights from a seeded ``torch.Generator``, cuDNN
   convolutions in f32 and none of the port's kernels: (a) the paper's
   800 x 304 x 224 grid (car 0's features, built on the host while phase
   17 runs) in 10 slabs with halo 40, seconds per slab and a pass, TFLOP/s
   from the convolutions' shapes, peak memory, a finite output; the
   layout's cost (one conv in NCDHW and in channels_last_3d) logged; (b)
   on 240 x 304 x 224 the 3-slab partitioned pass within UNET_PART_RTOL of
   the full pass's largest |value|, halo 4 beyond it, and
   ``find_receptive_halo``
   on a 96 x 64 x 64 window between 4 and 28; (c) card against CPU on 16 x
   32 x 32: forward, ``train_loss`` with continuity 0.05 and every
   gradient leaf within the tolerances below; (d) 3 steps of the example's
   Adam with continuity 0.05 on one owned slab (1, 80, 304, 224, 16):
   finite losses, step seconds and peak memory.

The GNN serving phases (3-6, 12) run inside one function, so their tensors are
freed before the LLM phases (the flash row of 3, then 7, 8 and 19), all but
phase 5's weights; the training phases (the backward row of 3, then 9, 14,
10 and 11) run in another, and phases 13 and 15 run last, on phase 5's weights,
each in a function of its own, then phase 16, 17 (b, c) and 18, each in its
own. It then
prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, "device":
{...}}`` line. It needs one card and imports nothing of JAX.
"""
from __future__ import annotations

import copy
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# flex_attention's yardstick compiles with inductor: in this process, with
# its caches inside the checkout's build directory
for _var, _sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / "build" / _sub))
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
BUCKETS = (16384, 65536)
# phase 5's requests: cars 1-4 at these sizes (request ids 0-3)
SERVE_SIZES = (16384, 65536, 16384, 65536)
WHOLE_PATH_POINTS = 2048
# phases 13 (c) and 15 (c): steps of the state-feedback rollout; 2 keep
# the feedback path while the whole script stays near half its time limit
# (the CPU run takes about 7 s a step at full width)
FEEDBACK_STEPS = 2
# Fields of one full-width request, card against CPU: the graphs are
# identical (asserted), but cuBLAS and the CPU BLAS sum the f32 products of
# 15 residual layers of width 512 in different orders, and the sin/cos of the
# features come from different libraries. Measured on an H100: 1.7e-6 max
# abs error on O(1) outputs, in three runs; 1e-4 leaves room for other BLAS
# builds and still fails on any real divergence.
WHOLE_PATH_ATOL = 1e-4
# Phase 15: sharded fields against unsharded ones (and 8 against 4 shards)
# on every point. Owned rows see the full graph's edges, so only the order
# of f32 sums differs (each shard's CSR and matmuls are smaller); the same
# 1e-4 as the whole path, which any missing halo edge exceeds (the CPU tests
# show 1.4e-3 with one hop fewer at 3 layers).
SHARD_ATOL = 1e-4
SHARD_DEVICES = 4                  # (a) and (c): the server's shard count
SHARDED_POINTS = 262144            # (b): four times the top bucket
SHARDED_SPLITS = (8, 4)
SEG_ATOL, SEG_RTOL = 1e-4, 1e-5
# kNN d2 against its plain version: bit-equal, the same rounded arithmetic
KNN_D2_ATOL = 0.0
# the kernel names the profiler shows for kNN and segment-sum
KNN_KERNEL = "knn_topk_kernel"
SEG_KERNEL = "segment_sum_kernel"
# flash attention against its plain version, elementwise |got - want| <=
# atol + rtol |want|. f32 sums in another order. bf16 is the tolerance of
# tests/test_kernels.py, with a relative part so that an output of 4 or more
# that rounds to its other bf16 neighbour (an ulp of 3.1e-2) passes.
FLASH_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-5, 0.0)}
# An output at the serve shape is about 0.03, so 2e-2 alone would pass a
# kernel that drops a 64-key tile of a row. bf16 is therefore also held per
# (row, head) to |got - want| / |want| over hd: the kernel rounds P to bf16
# before PV, beside the output's rounding, and takes tanh.approx and
# ex2.approx. Measured on an H100 at the serve shape: see PERF.md; the plain
# version with one key tile per row dropped must fail it.
FLASH_ROW_RTOL = 1e-2
KEY_TILE = 64    # the wgmma kernel's K/V tile
# the kernel names the profiler shows for the bf16 (wgmma) and f32 flash
# kernels
FLASH_WGMMA_KERNEL = "flash_wgmma_kernel"
FLASH_KERNEL_RE = re.compile(r"flash_(wgmma_)?kernel")
# calls timed of flex_attention compiled in f32, and profiled of the f32
# kernel
F32_REPS = 3
F32_PROFILE_REPS = 10
# SASS that shows the bf16 flash kernel runs on the tensor cores and TMA
FLASH_SASS = ("HGMMA", "UTMALDG")
# the segment-sum backward kernel's name in the profiler
SEG_BWD_KERNEL = "segment_sum_backward_kernel"
# the autograd node of the gathers h[senders], h[receivers] in the profiler,
# and PyTorch's sort-based backward of an indexing gather, which the
# training step must no longer launch
GATHER_BWD_NODE = "GatherRowsBackward"
INDEXING_BWD_KERNEL = "indexing_backward"
# Phase 10: the paper's model at full width on 65,536-point clouds (the
# paper's 2M-point levels do not fit a run of this script's length).
TRAIN_LEVELS, TRAIN_PARTITIONS = (16384, 32768, 65536), 8
TRAIN_STEPS, TRAIN_SAMPLES = 3, 3
# Phase 10 checkpoints every step and keeps the newest 2 step-tagged files
# (steps 1 and 2) beside the final one; phase 11 resumes from step 2
TRAIN_KEEP_CKPTS = 2
# Phase 9: full width, 2 layers, one small sample, card against CPU.
WHOLE_TRAIN_LEVELS, WHOLE_TRAIN_PARTITIONS, WHOLE_TRAIN_LAYERS = \
    (512, 1024, 2048), 2, 2
# One step, card against CPU: the loss to a relative 1e-5 (cuBLAS and the
# CPU BLAS sum the f32 products in other orders; 6.1e-8 measured on an
# H100); each gradient leaf to TRAIN_GRAD_RTOL of its own largest element
# (8.4e-7 measured); each updated parameter to TRAIN_PARAM_ATOL, except
# where the gradient is below TRAIN_NEAR_ZERO: Adam's update
# g / (|g| + 1e-8) turns the rounding of a small gradient into an update
# error of up to the learning rate, and the error falls with |g|^2 above
# eps, so there the bound is 2 lr_max (tests/test_torch_train.py makes the
# same split against JAX). With the split at 1e-7 the rest reached 8.5e-7
# on an H100; at 1e-6 it keeps a margin.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-5
TRAIN_PARAM_ATOL = 1e-6
TRAIN_NEAR_ZERO = 1e-6
# Phase 16: multi-process training. Two ranks share the one card through
# gloo; (c) trains phase 10's config for DIST_STEPS steps. The group's
# timeout bounds every rendezvous and collective, the join bounds the ranks.
DIST_WORLD, DIST_STEPS = 2, 2
DIST_GROUP_TIMEOUT = timedelta(seconds=180)
DIST_JOIN_TIMEOUT = 360
LLM_ARCH = "gemma2-9b"
LLM_BATCH, LLM_PROMPT, LLM_GEN = 2, 4608, 32
WHOLE_LLM_PROMPT, WHOLE_LLM_DECODE = 128, 4
# Logits of the 2-layer full-width gemma2, card against CPU, f32: cuBLAS and
# the CPU BLAS sum the products in different orders. Measured on an H100:
# 1.0e-5 on the prefill logits and 1.1e-4 on the decode logits, whose
# cache went through bf16 (pad_cache_to) on both sides.
LLM_ATOL = 5e-4
# Phase 3 at head_dim 128: the flash kernels at qwen3-moe-30b-a3b's prefill
# shape (B 2, S 4,608, H 32, KV 4; causal, no window, no softcap), timed,
# then for correctness only at HD128_SHORT_S tokens: the odd GQA groups of
# yi (56 / 8) and starcoder2 (48 / 4), and a window with a softcap.
MOE_ARCH = "qwen3-moe-30b-a3b"
HD128_SHORT_S = 640
HD128_SHORT_CASES = ((56, 8, None, None), (48, 4, None, None),
                     (32, 4, 128, 50.0))      # (H, KV, window, softcap)
# Phase 19 (a): the head_dim-128 decoders at full width, cut to 2 layers,
# f32, card against CPU (phase 7's form and LLM_ATOL). A routing decision
# (the k-th against the (k+1)-th router probability of a token) within
# ROUTE_TIE of a tie may flip between the two devices' f32 sums; a flip
# anywhere else is a fault.
DECODER_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-moe-16b", "starcoder2-15b",
                 "pixtral-12b")
ROUTE_TIE = 1e-6
# Phase 19 (b): the MoE layer's parts, as models/moe.py marks them for the
# profiler
MOE_MARKS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
             "moe.shared")
# Phase 17: cold start. Three child processes (fresh build directory, the
# same one warm, and the deploy artifact) each serve phase 5's 4 requests,
# timed from spawn to car 2's result; a child gets COLDSTART_TIMEOUT seconds.
COLDSTART_DIR = ROOT / "build" / "chip_smoke_coldstart"
COLDSTART_ARTIFACT = COLDSTART_DIR / "deploy.msgpack"
COLDSTART_KINDS = ("fresh", "warm", "artifact")
COLDSTART_TIMEOUT = 300
# Phase 18: X-UNet3D (paper SVI) at full width, UNetConfig(): (a) the
# paper's grid in its 10 slabs with halo 40; (b) the partitioned pass
# against the full pass on the first UNET_EQUIV_X planes, in 3 slabs, held
# to UNET_PART_RTOL of the full output's largest |value| (cuDNN picks its
# algorithm by shape, so a slab is not bit-equal to the whole), and the
# receptive-halo search on UNET_HALO_GRID; (c) card against CPU on
# UNET_WHOLE_GRID, forward UNET_ATOL, loss UNET_LOSS_RTOL, each gradient
# leaf UNET_GRAD_RTOL of its largest element; (d) UNET_TRAIN_STEPS Adam
# steps on one owned slab, UNET_TRAIN_X planes.
UNET_EQUIV_X, UNET_EQUIV_PARTS = 240, 3
UNET_PART_RTOL = 1e-4
UNET_HALO_GRID = (96, 64, 64)
UNET_WHOLE_GRID = (16, 32, 32)
UNET_ATOL, UNET_LOSS_RTOL, UNET_GRAD_RTOL = 1e-4, 1e-5, 1e-5
UNET_TRAIN_X, UNET_TRAIN_STEPS = 80, 3


def log(msg: str):
    print(msg, flush=True)


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` launches, each timed by
    CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_rows(averages):
    """``[(kernel name, ms, launches)]`` of the device kernels in a
    ``torch.profiler`` run's ``key_averages()``, by their self device time,
    longest first. A ``record_function`` mark's span on the device (a user
    annotation, idle gaps included) is not a kernel and is left out."""
    import torch
    rows = [(e.key, getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0.0), e.count)
            for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    return sorted(((k, us / 1e3, n) for k, us, n in rows),
                  key=lambda r: -r[1])


def profiled_rows(fn, reps: int):
    """``device_rows`` of a ``torch.profiler`` run over ``reps``
    back-to-back calls of ``fn``, after two unprofiled ones."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_rows(prof.key_averages())


def device_ms(fn, reps: int = 50, kernel=None) -> float:
    """Device milliseconds per call of ``fn``, from ``torch.profiler`` over
    ``reps`` back-to-back calls after two unprofiled ones: the self device
    time of the kernel whose name matches the regex ``kernel`` (one launch a
    call), or, with no ``kernel``, of every device kernel the calls launch.
    Each kernel counts as its mean time per launch held in the profile, times
    its launches per call: a profile that holds fewer launches than were made
    (seen with the flash kernels) still gives the time of a call."""
    import math

    rows = profiled_rows(fn, reps)
    seen = [r for r in rows if kernel is None or re.search(kernel, r[0])]
    launches = sum(n for *_, n in seen)
    if not seen or (kernel is not None and launches > reps):
        raise RuntimeError(
            f"device time: {launches} launches of {kernel!r} in {reps} "
            f"calls; the profile shows {[k[:80] for k, *_ in rows[:6]]}")
    short = [(k[:60], n) for k, _, n in seen if n % reps]
    if short:
        log(f"[kernels] note: launches held in a profile of {reps} calls "
            f"that are not a whole number per call: {short}")
    return sum(ms / n * math.ceil(n / reps) for _, ms, n in seen)


def timed_row(kernel_fn, kernel_re: str, plain_fn, library_fn, bound,
              reps: int = 50, plain_reps: int = 10) -> dict:
    """The timing columns of one kernel's row: the kernel's device time
    (``device_ms``, also ``ms``), the wrapper's call on CUDA events
    (``call_ms``: host work plus kernels), the plain version's and the
    library call's (``library_ms`` on events, ``library_device_ms`` the sum of
    its device kernels per call), and the bound."""
    row = dict(device_ms=device_ms(kernel_fn, reps, kernel_re),
               call_ms=time_cuda(kernel_fn, reps),
               plain_ms=time_cuda(plain_fn, plain_reps),
               library_ms=time_cuda(library_fn, reps),
               library_device_ms=device_ms(library_fn, reps),
               bound_ms=bound[0], bound_by=bound[1])
    row["ms"] = row["device_ms"]
    row["fraction_of_bound"] = row["bound_ms"] / row["device_ms"]
    return row


def log_row(kr: dict, library: str):
    log(f"[kernels] {kr['name']}: device {kr['device_ms']:.4f} ms, "
        f"{kr['fraction_of_bound']:.3f} of its bound {kr['bound_ms']:.4f} ms "
        f"by {kr['bound_by']}; call {kr['call_ms']:.4f} ms; plain "
        f"{kr['plain_ms']:.3f} ms; {library} device "
        f"{kr['library_device_ms']:.4f} ms, call {kr['library_ms']:.4f} ms; "
        f"max abs err {kr['max_abs_err']:.3g} | {kr['shape']}")


def knn_check(dev, card) -> dict:
    """Phase 3 for the kNN kernel: bit-equal to its plain version, and timed,
    at every level shape the server launches it at (3 levels of each bucket,
    on the bucket's calibrated grid and its calibration cloud). Returns the
    row of the largest shape, with every shape's under ``by_shape``."""
    import torch
    from repro_torch.core.graph_build import sample_surface
    from repro_torch.data import geometry as geo
    from repro_torch.graphx import hashgrid
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.launch.serve_gnn import _level_sizes

    verts, faces = geo.car_surface(geo.sample_params(0))
    by_shape = []
    for bucket in BUCKETS:
        ref_pts, _ = sample_surface(verts, faces, bucket,
                                    np.random.default_rng(0))
        for m in _level_sizes(bucket, 3):
            gspec = hashgrid.calibrate_spec(ref_pts[:m], 6, n_points=m)
            pts = torch.from_numpy(ref_pts[:m]).to(dev)
            cand, cvalid, _ = hashgrid.csr_candidate_lists(pts, m, gspec)
            cpos = pts[cand.long()]
            k = gspec.k
            args = (pts, cpos, cand, cvalid, k)
            ki, kd, km = knn_ops.topk_neighbors(*args)
            torch.cuda.synchronize()
            pi, pd, pm = knn_ref.topk_neighbors(*args)
            if not (torch.equal(ki, pi) and torch.equal(km, pm)):
                raise RuntimeError(f"knn_topk at N={m}: indices differ from "
                                   "the plain version")
            err = float((kd - pd).abs().max())
            if err > KNN_D2_ATOL:
                raise RuntimeError(f"knn_topk at N={m}: d2 error {err} > "
                                   f"{KNN_D2_ATOL}")
            d2_masked = torch.where(
                cvalid, ((cpos - pts[:, None, :]) ** 2).sum(-1), knn_ref.BIG)
            n_c = cand.shape[1]
            n_valid = int(cvalid.sum())
            n_bytes = m * 12 + m * n_c + n_valid * 12 + m * k * 4 + m * k * 8
            row = dict(
                bucket=bucket, n=m, c=n_c, valid_share=n_valid / (m * n_c),
                max_abs_err=err, **timed_row(
                    lambda: knn_ops.topk_neighbors(*args), KNN_KERNEL,
                    lambda: knn_ref.topk_neighbors(*args),
                    lambda: torch.topk(d2_masked, k, dim=1, largest=False),
                    bound_ms(n_bytes, 8.0 * n_valid)))
            by_shape.append(row)
            log(f"[kernels] knn_topk bucket {bucket} level N={m}: C={n_c}, "
                f"valid {row['valid_share']:.3f}, bound "
                f"{row['bound_ms']:.4f} ms by {row['bound_by']}, device "
                f"{row['device_ms']:.4f} ms ({row['fraction_of_bound']:.3f} "
                f"of the bound), call {row['call_ms']:.4f} ms, plain "
                f"{row['plain_ms']:.3f} ms, torch.topk device "
                f"{row['library_device_ms']:.4f} ms (call "
                f"{row['library_ms']:.4f} ms); bit-equal | {card}")
            del cpos, d2_masked
    top = dict(by_shape[-1])
    kr = dict(
        name="knn_topk", route="cuda",
        source="src/repro_torch/kernels/knn/csrc/knn_topk.cu",
        replaces="src/repro/kernels/knn/kernel.py:27",
        **{key: top[key] for key in (
            "max_abs_err", "ms", "device_ms", "call_ms", "plain_ms",
            "bound_ms", "bound_by", "fraction_of_bound", "library_ms",
            "library_device_ms")},
        library_note="torch.topk over the masked d2",
        shape=f"N={top['n']} C={top['c']} k=6, valid candidates "
              f"{top['valid_share']:.3f}",
        by_shape=by_shape)
    log_row(kr, "torch.topk")
    return kr


def gnn_phases(dev, card, reset_counts, read_counts, by_phase):
    """Phases 3 (GNN kernels) to 6 and 12; returns the two kernels' rows,
    and phase 5's config, weights, requests, results and peak memory for
    phase 13. Its other tensors, the server's included, are freed when it
    returns."""
    import torch
    from repro_torch.configs.base import GNNConfig
    from repro_torch.core.graph_build import sample_surface
    from repro_torch.data import geometry as geo
    from repro_torch.graphx import hashgrid
    from repro_torch.graphx.multiscale import (MultiscaleSpec,
                                               multiscale_edges)
    from repro_torch.graphx.pipeline import make_graph_forward, make_infer_fn
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.kernels.segment_agg import ref as seg_ref
    from repro_torch.launch.serve_gnn import (GNNServer, Request,
                                              _level_sizes)
    from repro_torch.models import meshgraphnet

    # the 65,536-point bucket's graph, as the server calibrates and builds it
    n_big = BUCKETS[-1]
    ref_verts, ref_faces = geo.car_surface(geo.sample_params(0))
    ref_pts, _ = sample_surface(ref_verts, ref_faces, n_big,
                                np.random.default_rng(0))
    levels = _level_sizes(n_big, 3)
    grids = tuple(hashgrid.calibrate_spec(ref_pts[:m], 6, n_points=m)
                  for m in levels)
    ms = MultiscaleSpec(levels, 6, grids)
    pts = torch.from_numpy(ref_pts).to(dev)

    # 3. kernels -----------------------------------------------------------
    reset_counts()
    kernels = [knn_check(dev, card)]

    senders, receivers, emask = multiscale_edges(pts, n_big, ms)
    n_e, d = receivers.numel(), GNNConfig().hidden
    g = torch.Generator().manual_seed(0)
    msg = torch.randn((n_e, d), generator=g).to(dev) * emask[:, None]
    prep = seg_ops.prepare(receivers, n_big, emask)
    so = seg_ops.segment_sum_prepared(prep, msg)
    torch.cuda.synchronize()
    sp = seg_ref.segment_sum_csr(msg, prep.perm, prep.row_ptr)
    torch.testing.assert_close(so, sp, atol=SEG_ATOL, rtol=SEG_RTOL)
    seg_err = float((so - sp).abs().max())
    recv_long = receivers.long()
    lib_err = float((so - torch.zeros_like(so).index_add_(
        0, recv_long, msg)).abs().max())
    e_valid = int(emask.sum())
    seg_bytes = e_valid * d * 4 + n_big * d * 4 + e_valid * 4 + \
        (n_big + 1) * 4
    kernels.append(dict(
        name="segment_sum", route="cuda",
        source="src/repro_torch/kernels/segment_agg/csrc/segment_sum.cu",
        replaces="src/repro/kernels/segment_agg/kernel.py:28",
        max_abs_err=seg_err,
        **timed_row(
            lambda: seg_ops.segment_sum_prepared(prep, msg),
            SEG_KERNEL, lambda: seg_ref.segment_sum_csr(
                msg, prep.perm, prep.row_ptr),
            lambda: torch.zeros_like(so).index_add_(0, recv_long, msg),
            bound_ms(seg_bytes, float(e_valid) * d), plain_reps=5),
        shape=f"E={n_e} N={n_big} D={d}, masked "
              f"{1 - e_valid / n_e:.3f}, max abs diff vs index_add_ "
              f"{lib_err:.3g}"))
    torch.cuda.synchronize()
    read_counts("kernel_check")
    log_row(kernels[-1], "index_add_")
    del msg, so, sp

    # 4. whole path: card against CPU, one full-width request ---------------
    reset_counts()
    cfg = GNNConfig()
    n_w = WHOLE_PATH_POINTS
    w_levels = _level_sizes(n_w, 3)
    w_ref, _ = sample_surface(ref_verts, ref_faces, n_w,
                              np.random.default_rng(0))
    w_ms = MultiscaleSpec(w_levels, cfg.k_neighbors, tuple(
        hashgrid.calibrate_spec(w_ref[:m], cfg.k_neighbors, n_points=m)
        for m in w_levels))
    verts, faces = geo.car_surface(geo.sample_params(1))
    w_pts, w_nrm = sample_surface(verts, faces, n_w,
                                  np.random.default_rng((0, 2)))
    model_cpu = meshgraphnet.init(torch.Generator().manual_seed(0), cfg,
                                  device="cpu")
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    e_gpu = multiscale_edges(torch.from_numpy(w_pts).to(dev), n_w, w_ms)
    e_cpu = multiscale_edges(torch.from_numpy(w_pts), n_w, w_ms)
    for a, b in zip(e_gpu, e_cpu):
        if not torch.equal(a.cpu(), b):
            raise RuntimeError("whole path: card and CPU built different "
                               "edge sets")
    infer = make_infer_fn(cfg, w_ms)
    t0 = time.perf_counter()
    out_gpu = infer(model_gpu, torch.from_numpy(w_pts).to(dev),
                    torch.from_numpy(w_nrm).to(dev), n_w).cpu()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_cpu = infer(model_cpu, torch.from_numpy(w_pts),
                    torch.from_numpy(w_nrm), n_w)
    t_cpu = time.perf_counter() - t0
    if out_gpu.shape != (n_w, cfg.node_out) or \
            not torch.isfinite(out_gpu).all():
        raise RuntimeError("whole path: bad output on the card")
    whole_err = float((out_gpu - out_cpu).abs().max())
    if whole_err > WHOLE_PATH_ATOL:
        raise RuntimeError(f"whole path: card vs CPU max abs error "
                           f"{whole_err} > {WHOLE_PATH_ATOL}")
    read_counts("whole_path")
    log(f"[whole_path] {n_w} points, hidden {cfg.hidden}, {cfg.n_mp_layers} "
        f"layers, E={w_ms.n_edges}: edges equal, fields max abs err "
        f"{whole_err:.3g} (atol {WHOLE_PATH_ATOL}); card {t_gpu:.3f} s "
        f"(first call), CPU {t_cpu:.2f} s")
    del model_cpu, model_gpu

    # 5. serve: the main path, counted --------------------------------------
    server = GNNServer(cfg, BUCKETS, max_batch=2, seed=0)
    reqs = []
    for i, n_req in enumerate(SERVE_SIZES):
        v, f = geo.car_surface(geo.sample_params(i + 1))
        reqs.append((v, f, n_req))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    server.warmup()
    t_warm = time.perf_counter() - t0
    results = server.serve(reqs)
    torch.cuda.synchronize()
    read_counts("serve")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = len(BUCKETS) * server.max_batch + len(reqs)
    want = {"segment_sum": cfg.n_mp_layers * rows,
            "knn_topk": len(ms.level_sizes) * rows}
    for name, n in want.items():
        got = by_phase[name]["serve"]
        if got != n:
            raise RuntimeError(f"serve: {name} launched {got} times, "
                               f"expected {n} ({rows} requests run)")
    if len(results) != len(reqs):
        raise RuntimeError(f"serve: {len(results)} results for "
                           f"{len(reqs)} requests")
    for r, (_, _, n_req) in zip(sorted(results, key=lambda r: r.request_id),
                                reqs):
        if r.bucket != n_req or r.fields.shape != (n_req, cfg.node_out) \
                or not np.isfinite(r.fields).all():
            raise RuntimeError(f"serve: bad result for request "
                               f"{r.request_id}")
    rep = server.stats.report()
    log(f"[serve] warmup {t_warm:.2f} s; served {rep['requests']} requests "
        f"in one flush | {rep['throughput_rps']:.3f} req/s | peak memory "
        f"{peak_gb:.2f} GB | launches segment_sum "
        f"{by_phase['segment_sum']['serve']}, knn_topk "
        f"{by_phase['knn_topk']['serve']} for {rows} requests run | {card}")
    # 2 requests per bucket: the mean is what an exact p50 of two is; the
    # histograms' p50 and p95 interpolate inside a ~23 % bucket. submit->
    # result includes the wait behind the flush's earlier (smaller-bucket)
    # batch; batch run (CUDA events around the batch) does not.
    for n, bb in rep["by_bucket"].items():
        log(f"[serve] bucket {n}: {bb['requests']} requests | "
            f"submit->result mean {bb['mean_ms']:.1f} ms (p50 "
            f"{bb['p50_ms']:.1f}, p95 {bb['p95_ms']:.1f}) | batch run mean "
            f"{bb['run_mean_ms']:.1f} ms (p50 {bb['run_p50_ms']:.1f}, p95 "
            f"{bb['run_p95_ms']:.1f})")

    # 17 (a). phase 5's server freezes its deploy artifact -------------------
    coldstart_save(server, card)

    # 6. breakdown of one 65,536-point request ------------------------------
    b = server._buckets[n_big]
    stage = {}
    t0 = time.perf_counter()
    req = Request(reqs[1][0], reqs[1][1], 1, n_big)
    p_np, n_np = server._sample(req, n_big)
    stage["sample_host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    server._check_cloud(b, p_np, 1)
    stage["check_cloud_host"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_d = torch.from_numpy(p_np).to(dev)
    n_d = torch.from_numpy(n_np).to(dev)
    torch.cuda.synchronize()
    stage["h2d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_d, r_d, m_d = multiscale_edges(p_d, n_big, b.ms)
    torch.cuda.synchronize()
    stage["graph_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fwd = make_graph_forward(cfg)
    out = fwd(server.params, p_d, n_d, s_d, r_d, m_d)
    torch.cuda.synchronize()
    stage["features_and_model"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out.cpu()
    stage["d2h"] = time.perf_counter() - t0
    seg_share = cfg.n_mp_layers * kernels[1]["device_ms"] / 1e3
    log("[breakdown] 65536-point request, seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in stage.items())
        + f"; of the model, segment_sum ~{seg_share:.4f} "
        f"({cfg.n_mp_layers} x its device time)")
    row_s = {}
    for n in BUCKETS:
        p_np, n_np = server._sample_reference(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server._buckets[n].infer(server.params,
                                 torch.from_numpy(p_np[None]).to(dev),
                                 torch.from_numpy(n_np[None]).to(dev), [n])
        torch.cuda.synchronize()
        row_s[n] = time.perf_counter() - t0
    log("[breakdown] one row through a bucket's pipeline, seconds: "
        + ", ".join(f"{n} points {t:.4f}" for n, t in row_s.items()))

    # 12. the serving engine ------------------------------------------------
    phase5 = {r.request_id: r for r in results}
    serve_engine(dev, card, cfg, server.params, reqs, phase5, reset_counts,
                 read_counts, by_phase)
    # what phase 13, at the end, needs of phase 5
    return kernels, dict(cfg=cfg, params=server.params, reqs=reqs,
                         phase5=phase5, peak5=peak_gb)


def _same_result(got, want, what: str):
    if got.error is not None or not (
            np.array_equal(got.points, want.points)
            and np.array_equal(got.fields, want.fields)):
        diff = (np.abs(got.fields - want.fields).max()
                if got.fields.shape == want.fields.shape else "shape")
        raise RuntimeError(f"engine: {what}: request {got.request_id} is not "
                           f"bit-equal to the reference (error {got.error!r}, "
                           f"max abs diff {diff})")


def serve_engine(dev, card, cfg, params, reqs, phase5, reset_counts,
                 read_counts, by_phase):
    """Phase 12 (see the module docstring): the rest of ``GNNServer`` on the
    card, on phase 5's weights and traffic (request ids 0-3: cars 1-4 at
    16,384, 65,536, 16,384, 65,536 points)."""
    import threading

    import torch
    from repro_torch.launch.serve_gnn import SERVE_STAGES, GNNServer
    from repro_torch.resilience import FAULTS

    t_phase = time.perf_counter()
    n_small, n_big = BUCKETS
    rows_total = 0

    def server(buckets=BUCKETS, c=cfg, **kw):
        return GNNServer(c, buckets, max_batch=2, seed=0, params=params, **kw)

    def counted(phase, rows):
        """Every kernel of the path launched per row run, no other."""
        nonlocal rows_total
        torch.cuda.synchronize()
        read_counts(phase)
        want = {name: 0 for name in by_phase}
        want.update(segment_sum=cfg.n_mp_layers * rows, knn_topk=3 * rows)
        got = {name: by_phase[name][phase] for name in by_phase}
        if got != want:
            raise RuntimeError(f"engine {phase}: launches {got}, expected "
                               f"{want} for {rows} rows")
        rows_total += rows
        reset_counts()

    # (a) sync against async ------------------------------------------------
    flushed = {}
    for mode, async_mode in (("sync", False), ("async", True)):
        srv = server()
        probe = {}
        orig_dispatch, orig_harvest = srv._dispatch, srv._harvest

        def dispatch(b, *a, probe=probe, orig=orig_dispatch):
            t0 = time.perf_counter()
            fl = orig(b, *a)
            if b.n_points == n_big and "fl" not in probe:
                probe.update(fl=fl, t_ret=time.perf_counter(),
                             dispatch_s=time.perf_counter() - t0,
                             pending=not fl.event.query())
            return fl

        def harvest(fl, probe=probe, orig=orig_harvest):
            if probe.get("fl") is fl and "lead_s" not in probe:
                fl.event.synchronize()
                probe["lead_s"] = time.perf_counter() - probe["t_ret"]
            return orig(fl)

        srv._dispatch, srv._harvest = dispatch, harvest
        for v, f, n in reqs:
            srv.submit(v, f, n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = srv.flush(async_mode=async_mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted(f"engine_{mode}", len(reqs))
        peak = torch.cuda.max_memory_allocated() / 1e9
        flushed[mode] = {r.request_id: r for r in res}
        if sorted(flushed[mode]) != [0, 1, 2, 3]:
            raise RuntimeError(f"engine {mode}: results "
                               f"{sorted(flushed[mode])}")
        for rid, r in flushed[mode].items():
            _same_result(r, phase5[rid], f"{mode} flush against phase 5")
        if not probe.get("pending"):
            raise RuntimeError(f"engine {mode}: the 65,536-point batch's "
                               "event was complete when _dispatch returned")
        stages = srv.stats.stage_report()
        log(f"[engine] (a) {mode} flush of 4 requests: {wall:.3f} s, peak "
            f"memory {peak:.2f} GB; first 65,536-point dispatch returned "
            f"after {probe['dispatch_s']:.4f} s with its event pending, the "
            f"card finished {probe['lead_s']:.4f} s later | {card}")
        log(f"[engine] (a) {mode} stages: " + "; ".join(
            f"{k} n={v['count']} mean {v['mean_ms']:.1f} ms total "
            f"{v['total_s']:.3f} s" for k, v in stages.items() if v["count"]))
        by_b = srv.stats.report()["by_bucket"]
        log(f"[engine] (a) {mode} by bucket: " + "; ".join(
            f"{n}: submit->result mean {b['mean_ms']:.1f} ms, batch run "
            f"mean {b['run_mean_ms']:.1f} ms" for n, b in by_b.items()))
        del srv, res
    for rid in range(4):
        _same_result(flushed["async"][rid], flushed["sync"][rid],
                     "async against sync")
    ref = flushed["sync"]

    # what one row puts on the card's launch queue (about 1,024 deep)
    from torch.profiler import ProfilerActivity, profile
    srv = server((n_small,))
    p_np, n_np = srv._sample_reference(n_small)
    row = (torch.from_numpy(p_np[None]).to(dev),
           torch.from_numpy(n_np[None]).to(dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        srv._buckets[n_small].infer(params, *row, [n_small])
        torch.cuda.synchronize()
    averages = prof.key_averages()
    on_card = sum(n for *_, n in device_rows(averages))
    api = {e.key: e.count for e in averages
           if re.match(r"cu(da)?(LaunchKernel|Memcpy|Memset)", e.key)}
    counted("engine_profile", 1)
    log(f"[engine] one {n_small}-point row: {on_card} operations on the "
        f"card in its profile; runtime calls {api}")
    del srv, row

    # (b) the auto ladder, then evict -> rebuild ---------------------------
    srv = server("auto")
    for v, f, n in reqs:
        srv.submit(v, f, n)
    res = srv.flush()
    counted("engine_auto", len(reqs))
    if srv.ladder() != BUCKETS:
        raise RuntimeError(f"engine auto: ladder {srv.ladder()}")
    for r in res:
        _same_result(r, ref[r.request_id], "auto ladder")
    rep = srv.stats.report()
    log(f"[engine] (b) auto ladder grown to {list(srv.ladder())} (grown "
        f"{rep['grown_buckets']}, misses {rep['bucket_misses']}, "
        f"calibrations {rep['bucket_calibrations']}); fields bit-equal")
    del srv, res
    srv = server("auto", c=cfg.replace(max_live_buckets=1))
    got = []
    for i in range(3):                  # 16,384, 65,536 (evicts), 16,384
        before = srv.stats.bucket_calibrations
        got += srv.serve([reqs[i]])
    rep = srv.stats.report()
    if (rep["bucket_evictions"], rep["bucket_misses"],
            rep["bucket_calibrations"]) != (2, 3, 2) \
            or before != rep["bucket_calibrations"]:
        raise RuntimeError(f"engine evict: {rep}")
    counted("engine_evict", 3)
    for r in got:
        _same_result(r, ref[r.request_id], "evict -> rebuild")
    log(f"[engine] (b) max_live_buckets=1: evictions "
        f"{rep['bucket_evictions']}, misses {rep['bucket_misses']}, "
        f"calibrations {rep['bucket_calibrations']} (none on the rebuild); "
        f"the rebuilt 16,384 bucket's fields bit-equal")
    del srv, got

    # (c) the background worker, telemetry on (f) --------------------------
    trace_dir = ROOT / "build" / f"chip_smoke_trace_{os.getpid()}"
    srv = server(c=cfg.replace(telemetry=True, trace_dir=str(trace_dir)))
    srv.start(deadline_s=0.05)
    turn = threading.Condition()
    state = {"next": 0}
    bg, errors = {}, []

    def client(k):
        try:
            mine = []
            for i in range(k, len(reqs), 2):
                with turn:
                    turn.wait_for(lambda: state["next"] == i, timeout=60)
                    mine.append(srv.submit(*reqs[i]))
                    state["next"] += 1
                    turn.notify_all()
            for rid in mine:
                bg[rid] = srv.result(rid, timeout=300)
        except Exception as e:          # raised below, in the main thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    alive = srv.health()["worker_alive"]
    srv.stop()
    health = srv.health()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"engine background: {errors or 'a client hung'}")
    if not alive or health["worker_alive"] or srv._waiting or srv._done:
        raise RuntimeError(f"engine background: alive {alive}, after stop "
                           f"{health}, waiting {srv._waiting}")
    counted("engine_background", len(reqs))
    if sorted(bg) != [0, 1, 2, 3]:
        raise RuntimeError(f"engine background: results {sorted(bg)}")
    for rid, r in bg.items():
        _same_result(r, ref[rid], "background worker")
    stages = srv.stats.stage_report()
    empty = [k for k in SERVE_STAGES[:5] if not stages[k]["count"]]
    if empty or stages["compile"]["count"] or stages["cache_load"]["count"]:
        raise RuntimeError(f"engine telemetry: stages {stages}")
    paths = srv.telemetry.export()
    spans = [json.loads(line) for line in open(paths["trace_jsonl"])]
    traced = {s["trace_id"] for s in spans if s["name"] == "request"}
    shutil.rmtree(trace_dir)
    if traced != {f"req-{rid}" for rid in range(4)}:
        raise RuntimeError(f"engine telemetry: request spans {traced}")
    log(f"[engine] (c) background worker: 4 requests from 2 threads in "
        f"{wall:.3f} s, batches {srv.stats.batch_sizes}, fields bit-equal; "
        f"alive {alive}, after stop {health['worker_alive']}; telemetry: "
        f"{len(spans)} spans, stages " + ", ".join(
            f"{k} {stages[k]['count']}" for k in SERVE_STAGES))
    del srv, bg

    # (d) resilience on the 16,384-point bucket ----------------------------
    shape, frac = (2, n_small, cfg.node_out), 1.0 / (n_small * cfg.node_out)
    seed = next(sd for sd in range(10_000) if [
        bool(m.any()) for m in
        np.random.default_rng((sd, 1)).random(shape) < frac] == [True, False])
    srv = server()
    rid0 = srv.submit(*reqs[0])
    rid1 = srv.submit(*reqs[1], timeout_s=1e-3)
    rid2 = srv.submit(*reqs[2])
    time.sleep(0.01)
    FAULTS.arm("serve.harvest", mode="corrupt", frac=frac, seed=seed)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = {r.request_id: r for r in srv.flush()}
    finally:
        FAULTS.reset()
    counted("engine_chaos", 2)
    if "deadline exceeded" not in (res[rid1].error or "") \
            or "nonfinite" not in (res[rid0].error or "") \
            or srv.stats.nonfinite_results != 1:
        raise RuntimeError(f"engine chaos: {res[rid0].error!r}, "
                           f"{res[rid1].error!r}")
    _same_result(res[rid2], ref[rid2], "the corrupt row's neighbour")
    del srv, res
    srv = server("auto")
    small = srv.submit(*reqs[0])            # grows 16,384, then 65,536
    expired = srv.submit(*reqs[1], timeout_s=1e-3)
    time.sleep(0.01)
    FAULTS.arm("bucket.build", nth=1, times=1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = {r.request_id: r for r in srv.flush()}
    finally:
        FAULTS.reset()
    counted("engine_quarantine", 1)
    rep = srv.stats.report()
    r = res[small]
    if r.error is not None or r.bucket != n_big \
            or not np.isfinite(r.fields).all() \
            or (rep["quarantined_buckets"], rep["bucket_fallbacks"],
                rep["timed_out_requests"]) != (1, 1, 1) \
            or sorted(srv._quarantined) != [n_small] \
            or res[expired].error is None:
        raise RuntimeError(f"engine quarantine: {r.error!r}, bucket "
                           f"{r.bucket}, {rep}")
    del srv, res
    srv = server((n_small,), max_queue_depth=1)
    srv.submit(*reqs[0])
    shed = srv.submit(*reqs[2])
    counted("engine_shed", 0)
    if "queue full" not in (srv._done[shed].error or "") \
            or srv.stats.rejected_overload != 1 or srv.pending() != 1:
        raise RuntimeError("engine admission: the second submit was not "
                           "shed")
    del srv
    log(f"[engine] (d) a harvest corrupted in row 0 of 2 (seed {seed}): "
        f"that request errors, its neighbour bit-equal; bucket.build on "
        f"{n_small}: quarantined, served by {n_big} (1 fallback); expired "
        f"and shed requests launched nothing")
    log(f"[engine] (e) {rows_total} rows run, each {cfg.n_mp_layers} "
        f"segment-sum and 3 kNN launches; phase 12 took "
        f"{time.perf_counter() - t_phase:.1f} s | {card}")


def _same_rollout(got, want, what: str):
    if got.error is not None or want.error is not None \
            or got.steps_done != want.steps_done or not (
                np.array_equal(got.points, want.points)
                and np.array_equal(got.fields, want.fields)):
        diff = (np.abs(got.fields - want.fields).max()
                if got.fields.shape == want.fields.shape else "shape")
        raise RuntimeError(f"rollout: {what}: rollout {got.rollout_id} is not "
                           f"bit-equal to the reference (errors {got.error!r}"
                           f", {want.error!r}; steps {got.steps_done}, "
                           f"{want.steps_done}; max abs diff {diff})")


def rollout_phase(dev, card, reset_counts, read_counts, by_phase, *, cfg,
                  params, reqs, phase5, peak5):
    """Phase 13 (see the module docstring): the transient-rollout engine at
    full width, on phase 5's weights (``params``) and seed."""
    import torch
    from repro_torch.core.graph_build import sample_surface
    from repro_torch.data import geometry as geo
    from repro_torch.graphx.pipeline import make_step_fn
    from repro_torch.launch.serve_gnn import GNNServer
    from repro_torch.models import meshgraphnet
    from repro_torch.resilience import FAULTS

    t_phase = time.perf_counter()
    n_small, n_big = BUCKETS
    verts, faces = reqs[0][:2]

    def server(c=cfg, buckets=BUCKETS, **kw):
        return GNNServer(c, buckets, max_batch=2, seed=0, params=params, **kw)

    def counted(part, prefills, lane_steps):
        """3 kNN launches per prefill, n_mp_layers segment-sum launches per
        lane-step advanced, and no other kernel."""
        torch.cuda.synchronize()
        read_counts(part)
        want = {name: 0 for name in by_phase}
        want.update(knn_topk=3 * prefills,
                    segment_sum=cfg.n_mp_layers * lane_steps)
        got = {name: by_phase[name][part] for name in by_phase}
        if got != want:
            raise RuntimeError(f"rollout {part}: launches {got}, expected "
                               f"{want} ({prefills} prefills, {lane_steps} "
                               "lane-steps)")
        reset_counts()

    def cloud(n, car):
        v, f = geo.car_surface(geo.sample_params(car))
        return sample_surface(v, f, n, np.random.default_rng((0, 100 + car)))

    # (a) T = 1 is single-shot serving -------------------------------------
    reset_counts()
    r = server().rollout(*reqs[0], steps=1)
    counted("rollout_t1", 1, 1)
    if r.rollout_id != 0 or r.bucket != n_small:
        raise RuntimeError(f"rollout T = 1: id {r.rollout_id}, bucket "
                           f"{r.bucket}")
    if not (np.array_equal(r.points, phase5[0].points)
            and np.array_equal(r.fields, phase5[0].fields)) \
            or r.error is not None or r.steps_done != 1:
        raise RuntimeError(f"rollout T = 1: not bit-equal to phase 5's "
                           f"request 0 (error {r.error!r})")
    log(f"[rollout] (a) a fresh server's rollout(car 1, {n_small}, steps=1) "
        "is bit-equal to phase 5's request 0, points and fields; 3 kNN, "
        f"{cfg.n_mp_layers} segment-sum launches")

    # (b) interleaving in two tables ---------------------------------------
    cfg_b = cfg.replace(rollout_integrator="residual",
                        rollout_steps_per_flush=2, rollout_slots=4)
    # (steps, bucket, cloud): three in the 16,384 table from the start, one
    # in the 65,536 table, and one 16,384 arrival after the first flush
    plan = [(3, n_small, cloud(n_small, 1)), (5, n_small, cloud(n_small, 2)),
            (8, n_small, cloud(n_small, 3)), (2, n_big, cloud(n_big, 2))]
    late = (4, n_small, cloud(n_small, 4))
    lane_total = sum(t for t, _, _ in plan) + late[0]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    srv = server(cfg_b)
    eng = srv.rollout_engine()
    t0 = time.perf_counter()
    rids = [eng.submit(verts, faces, n, steps=t, cloud=c) for t, n, c in plan]
    eng.generate()
    rids.append(eng.submit(verts, faces, late[1], steps=late[0],
                           cloud=late[2]))
    flushes = 1 + eng.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    table_bytes = eng.table_bytes()
    inter = [eng.result(rid) for rid in rids]
    if eng._c_steps.value != lane_total or eng._c_done.value != 5:
        raise RuntimeError(f"rollout interleaved: {eng._c_steps.value} "
                           f"steps, {eng._c_done.value} completed")
    counted("rollout_interleaved", 5, lane_total)
    stages = srv.stats.stage_report()
    del srv, eng
    solo = []
    for t, n, c in plan + [late]:
        solo.append(server(cfg_b).rollout(verts, faces, n, steps=t, cloud=c))
    counted("rollout_solo", 5, lane_total)
    for got, want in zip(inter, solo):
        _same_rollout(got, want, "interleaved against solo")
        if not np.isfinite(got.fields).all() or got.fields.shape != (
                got.bucket, cfg.node_out):
            raise RuntimeError(f"rollout: bad fields for {got.rollout_id}")
    # the 5-step rollout against 5 one-step rollouts chained by init_state
    t5, n5, c5 = plan[1]
    srv = server(cfg_b)
    state = np.zeros((n5, cfg.node_out), np.float32)
    chain = []
    for _ in range(t5):
        res = srv.rollout(verts, faces, n5, steps=1, cloud=c5,
                          init_state=state)
        chain.append(res)
        state = res.fields
    counted("rollout_chained", t5, t5)
    if any(r.error for r in chain) or not (
            np.array_equal(inter[1].points, chain[-1].points)
            and np.array_equal(inter[1].fields, chain[-1].fields)):
        raise RuntimeError("rollout: 5 steps are not bit-equal to 5 chained "
                           "single steps")
    if np.array_equal(chain[0].fields, chain[-1].fields):
        raise RuntimeError("rollout: the state did not evolve (step 5 equals "
                           "step 1)")
    # one prefill and two lane-steps per bucket, each synchronised
    step = make_step_fn(cfg_b)
    prefill_s, lane_s = {}, {}
    for n, c in ((n_small, plan[0][2]), (n_big, plan[3][2])):
        prefill, _ = srv.rollout_engine()._programs(n)
        pts, nrm = (torch.from_numpy(a).to(dev) for a in c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = prefill(pts, nrm, n)
        torch.cuda.synchronize()
        prefill_s[n] = time.perf_counter() - t0
        st = torch.zeros((n, cfg.node_out), device=dev)
        lane_s[n] = []
        for _ in range(2):
            t0 = time.perf_counter()
            st = step(params, graph, st)
            torch.cuda.synchronize()
            lane_s[n].append(time.perf_counter() - t0)
        del graph, st
    counted("rollout_timing", 2, 4)
    del srv
    log(f"[rollout] (b) {len(rids)} rollouts (3, 5, 8 steps and a 4-step "
        f"arrival after the first flush at {n_small}; 2 steps at {n_big}), "
        f"residual, {cfg_b.rollout_steps_per_flush} steps a flush, "
        f"{cfg_b.rollout_slots} slots: {flushes} flushes, {lane_total} "
        f"lane-steps in {wall:.3f} s ({lane_total / wall:.3f} steps/s, "
        f"prefills included); each bit-equal to its solo run on a fresh "
        f"server, the 5-step one to 5 chained single steps, and step 5 "
        f"differs from step 1; launches {cfg.n_mp_layers} segment-sum per "
        f"lane-step, 3 kNN per prefill | {card}")
    log(f"[rollout] (b) prefill s per bucket: " + ", ".join(
        f"{n} {t:.4f}" for n, t in prefill_s.items())
        + "; s per lane-step per bucket: " + ", ".join(
            f"{n} " + " / ".join(f"{t:.4f}" for t in ts)
            for n, ts in lane_s.items())
        + "; slot-table bytes: " + ", ".join(
            f"{n} {b}" for n, b in table_bytes.items())
        + f"; peak memory {peak:.2f} GB (phase 5: {peak5:.2f} GB) | {card}")
    log("[rollout] (b) stages: " + "; ".join(
        f"{k} n={v['count']} mean {v['mean_ms']:.1f} ms total "
        f"{v['total_s']:.3f} s" for k, v in stages.items() if v["count"]))

    # (c) state feedback, card against CPU ---------------------------------
    n_w = WHOLE_PATH_POINTS
    cfg_c = cfg.replace(rollout_state_feats=True,
                        rollout_integrator="residual")
    model_cpu = meshgraphnet.init(torch.Generator().manual_seed(0), cfg_c,
                                  device="cpu")
    models = {"card": copy.deepcopy(model_cpu).to(dev), "cpu": model_cpu}
    out = {}
    for where, d in (("card", dev), ("cpu", "cpu")):
        s_c = GNNServer(cfg_c, (n_w,), max_batch=2, seed=0,
                        params=models[where], device=d)
        t0 = time.perf_counter()
        res = s_c.rollout(verts, faces, n_w, steps=FEEDBACK_STEPS)
        secs = time.perf_counter() - t0
        tbl = s_c.rollout_engine()._tables[n_w]
        edges = [tbl.graph[k][0].cpu()
                 for k in ("senders", "receivers", "emask")]
        out[where] = (res, edges, secs)
        if where == "card":
            counted("rollout_card_cpu", 1, FEEDBACK_STEPS)
    (rg, eg, tg), (rc, ec, tc) = out["card"], out["cpu"]
    if any(not torch.equal(a, b) for a, b in zip(eg, ec)):
        raise RuntimeError("rollout card against CPU: different edge sets")
    if rg.error or rc.error or rg.steps_done != FEEDBACK_STEPS \
            or not np.isfinite(rg.fields).all() \
            or not np.array_equal(rg.points, rc.points):
        raise RuntimeError(f"rollout card against CPU: {rg.error!r}, "
                           f"{rc.error!r}")
    err = float(np.abs(rg.fields - rc.fields).max())
    if err > WHOLE_PATH_ATOL:
        raise RuntimeError(f"rollout card against CPU: max abs error {err} "
                           f"> {WHOLE_PATH_ATOL}")
    if not np.abs(rg.fields).max() > 0:
        raise RuntimeError("rollout card against CPU: zero state")
    log(f"[rollout] (c) state feedback ({cfg_c.node_in_eff} node inputs), "
        f"residual, full width at {n_w} points, {FEEDBACK_STEPS} steps: "
        "edges equal, "
        f"fields max abs err {err:.3g} (atol {WHOLE_PATH_ATOL}, largest "
        f"element {np.abs(rc.fields).max():.3f}); card {tg:.3f} s, CPU "
        f"{tc:.2f} s")
    # phase 15 (c) holds the sharded engine against both
    feedback = dict(card=rg.fields, cpu=rc.fields, points=rc.points)
    del models, model_cpu, out

    # (d) chaos on the card ------------------------------------------------
    small, big = plan[0], plan[3]
    reset_counts()
    srv = server(cfg_b)
    eng = srv.rollout_engine()
    FAULTS.arm("rollout.generate", nth=1, times=1)
    try:
        r_s = eng.submit(verts, faces, n_small, steps=2, cloud=small[2])
        r_b = eng.submit(verts, faces, n_big, steps=big[0], cloud=big[2])
        res_s, res_b = eng.result(r_s), eng.result(r_b)
    finally:
        FAULTS.reset()
    counted("rollout_chaos_generate", 2, big[0])
    if "generate flush failed" not in (res_s.error or "") \
            or res_s.steps_done != 0 or eng._tables[n_small].state is not None:
        raise RuntimeError(f"rollout chaos generate: {res_s.error!r}")
    _same_rollout(res_b, solo[3], "65,536 rollout beside a failed flush")
    before = eng._c_steps.value
    FAULTS.arm("rollout.insert", mode="corrupt", nth=1, times=1)
    try:
        r_bad = eng.submit(verts, faces, n_small, steps=small[0],
                           cloud=small[2])
        r_ok = eng.submit(verts, faces, n_small, steps=small[0],
                          cloud=small[2])
        res_bad, res_ok = eng.result(r_bad), eng.result(r_ok)
    finally:
        FAULTS.reset()
    # both lanes advance the first flush (2 steps), the poisoned one is
    # aborted at its harvest, the other takes its third step alone
    if eng._c_steps.value - before != 5:
        raise RuntimeError(f"rollout chaos insert: "
                           f"{eng._c_steps.value - before} lane-steps")
    counted("rollout_chaos_insert", 2, 5)
    if "nonfinite" not in (res_bad.error or ""):
        raise RuntimeError(f"rollout chaos insert: {res_bad.error!r}")
    _same_rollout(res_ok, solo[0], "the poisoned slot's neighbour")
    FAULTS.arm("rollout.harvest", mode="corrupt", nth=1, times=1)
    try:
        res_h = srv.rollout(verts, faces, n_small, steps=1, cloud=small[2])
    finally:
        FAULTS.reset()
    counted("rollout_chaos_harvest", 1, 1)
    if "nonfinite output" not in (res_h.error or ""):
        raise RuntimeError(f"rollout chaos harvest: {res_h.error!r}")
    rid = eng.submit(verts, faces, n_small, steps=100, timeout_s=1e-3)
    time.sleep(0.01)
    res_t = eng.result(rid)
    adm = server(cfg_b, max_queue_depth=1).rollout_engine()
    adm.submit(verts, faces, n_small, steps=2)
    res_r = adm.result(adm.submit(verts, faces, n_small, steps=2),
                       drive=False)
    counted("rollout_chaos_shed", 0, 0)
    if "timed out" not in (res_t.error or "") or res_t.steps_done != 0 \
            or "rejected" not in (res_r.error or "") \
            or adm._c_reject.value != 1:
        raise RuntimeError(f"rollout deadline / admission: {res_t.error!r}, "
                           f"{res_r.error!r}")
    aborted = eng._c_abort.value
    del srv, eng, adm
    log(f"[rollout] (d) a rollout.generate raise failed the {n_small} "
        f"table's rollout and dropped the table, the {n_big} rollout in "
        f"flight bit-equal to its solo run; a NaN rollout.insert aborted "
        f"its own slot, its neighbour bit-equal to solo; a rollout.harvest "
        f"corruption caught by the guard ({aborted:.0f} aborted); an "
        f"expired and a rejected rollout launched nothing")
    log(f"[rollout] phase 13 took {time.perf_counter() - t_phase:.1f} s | "
        f"{card}")
    return feedback


def _max_err(got, want, what: str) -> float:
    """Max abs difference of two same-shape finite field arrays, which must
    stay within SHARD_ATOL."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise RuntimeError(f"sharded: {what}: shape {got.shape} against "
                           f"{want.shape}, finite {np.isfinite(got).all()}")
    err = float(np.abs(got - want).max())
    if err > SHARD_ATOL:
        raise RuntimeError(f"sharded: {what}: max abs error {err} > "
                           f"{SHARD_ATOL}")
    return err


def _plan_stats(plan) -> str:
    """Nmax, the replication factor (members over points, ring nodes
    included) and the halo fraction (members not owned) of one plan."""
    from repro_torch.core.halo import HOP_PAD
    members = int((plan.hop < HOP_PAD).sum())
    return (f"Nmax {plan.spec.n_points}, level caps "
            f"{tuple(plan.spec.ms.level_sizes)}, replication "
            f"{members / plan.n_global:.3f}, halo fraction "
            f"{1 - int(plan.owned.sum()) / members:.3f}")


def sharded_phase(dev, card, reset_counts, read_counts, by_phase, *, cfg,
                  params, reqs, phase5, peak5, feedback):
    """Phase 15 (see the module docstring): sharded serving and sharded
    rollouts at full width, on phase 5's weights (``params``) and seed;
    ``feedback`` holds phase 13 (c)'s fields."""
    import torch
    from repro_torch.core.graph_build import sample_surface
    from repro_torch.data import geometry as geo
    from repro_torch.graphx import sharded
    from repro_torch.launch import shard_plan
    from repro_torch.launch.serve_gnn import GNNServer, Request, _level_sizes
    from repro_torch.models import meshgraphnet
    from repro_torch.resilience import FAULTS

    t_phase = time.perf_counter()
    n_small, n_big = BUCKETS
    p_a = SHARD_DEVICES
    layers, levels_n = cfg.n_mp_layers, 3

    def counted(part, shard_graphs, shard_steps):
        """3 kNN launches per shard graph built, n_mp_layers segment-sum
        launches per shard step, and no other kernel."""
        torch.cuda.synchronize()
        read_counts(part)
        want = {name: 0 for name in by_phase}
        want.update(knn_topk=levels_n * shard_graphs,
                    segment_sum=layers * shard_steps)
        got = {name: by_phase[name][part] for name in by_phase}
        if got != want:
            raise RuntimeError(f"sharded {part}: launches {got}, expected "
                               f"{want}")
        reset_counts()

    # (a) the server's sharded mode (geometric), as JAX serves it ----------
    cfg_a = cfg.replace(rollout_integrator="residual",
                        rollout_steps_per_flush=2)
    t0 = time.perf_counter()
    server = GNNServer(cfg_a, BUCKETS, max_batch=2, seed=0, params=params,
                       shard_devices=p_a)
    t_build = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    results = server.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    counted("sharded_serve", p_a * len(reqs), p_a * len(reqs))
    errs = {}
    for r in results:
        want = phase5[r.request_id]
        if r.error is not None or not np.array_equal(r.points, want.points):
            raise RuntimeError(f"sharded serve: request {r.request_id}: "
                               f"{r.error!r}")
        errs[r.request_id] = _max_err(r.fields, want.fields,
                                      f"request {r.request_id} against "
                                      "phase 5")
    rep = server.stats.report()
    stats = {}
    for n in BUCKETS:
        rid = next(i for i, q in enumerate(reqs) if q[2] == n)
        pts, nrm = server._sample(
            Request(reqs[rid][0], reqs[rid][1], rid, n), n)
        b = server._buckets[n]
        stats[n] = _plan_stats(sharded.plan_shards(
            pts, nrm, p_a, layers, b.ms.level_sizes, cfg.k_neighbors,
            method="geometric", spec=b.sspec))
    log(f"[sharded] (a) GNNServer(shard_devices={p_a}, max_batch=2), "
        f"geometric plans: phase 5's {len(reqs)} requests in {wall:.3f} s "
        f"(server built and calibrated in {t_build:.2f} s), fields against "
        f"phase 5 max abs err " + ", ".join(
            f"rid {k} {v:.3g}" for k, v in sorted(errs.items()))
        + f" (atol {SHARD_ATOL}); launches {levels_n} x {p_a} kNN and "
        f"{layers} x {p_a} segment-sum a request; peak memory {peak:.2f} GB "
        f"(phase 5: {peak5:.2f} GB) | {card}")
    for n, st in stats.items():
        bb = rep["by_bucket"][n]
        log(f"[sharded] (a) bucket {n}: {st}; submit->result mean "
            f"{bb['mean_ms']:.1f} ms, batch run mean {bb['run_mean_ms']:.1f} "
            f"ms | {card}")
    # a shard.plan raise rejects its request only; the request ids are
    # rewound so that the unfaulted run samples the same two clouds
    pair = [(reqs[0][0], reqs[0][1], n_small),
            (reqs[2][0], reqs[2][1], n_small)]
    first = server._next_id
    FAULTS.arm("shard.plan", mode="raise", nth=1, times=1)
    try:
        faulted = server.serve(pair)
    finally:
        FAULTS.reset()
    counted("sharded_chaos", p_a, p_a)
    server._next_id = first
    clean = sorted(server.serve(pair), key=lambda r: r.request_id)
    counted("sharded_chaos_clean", 2 * p_a, 2 * p_a)
    bad, good = sorted(faulted, key=lambda r: r.request_id)
    if "injected fault" not in (bad.error or "") or good.error is not None \
            or clean[1].request_id != good.request_id \
            or not np.array_equal(clean[1].fields, good.fields):
        raise RuntimeError(f"sharded chaos: {bad.error!r}, {good.error!r}")
    log(f"[sharded] (a) a shard.plan raise rejected request "
        f"{bad.request_id} only; its neighbour {good.request_id} is "
        f"bit-equal to its unfaulted run; the rejected request launched "
        f"nothing")

    # (c) sharded rollouts on (a)'s server ---------------------------------
    def cloud(n, car):
        v, f = geo.car_surface(geo.sample_params(car))
        return sample_surface(v, f, n, np.random.default_rng((0, 100 + car)))

    verts, faces = reqs[0][:2]
    plan_c = [(3, n_small, cloud(n_small, 1)), (2, n_big, cloud(n_big, 2))]
    eng = server.rollout_engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(verts, faces, n, steps=t, cloud=c)
            for t, n, c in plan_c]
    flushes = eng.run_until_complete()
    torch.cuda.synchronize()
    t_roll = time.perf_counter() - t0
    got = [eng.result(rid) for rid in rids]
    spf = eng.steps_per_flush
    graphs = sum(-(-t // spf) for t, _, _ in plan_c)
    counted("sharded_rollout", p_a * graphs,
            p_a * sum(t for t, _, _ in plan_c))
    del server, eng
    gc.collect()
    ref_srv = GNNServer(cfg_a, BUCKETS, max_batch=2, seed=0, params=params)
    roll_err = []
    for (t, n, c), g in zip(plan_c, got):
        w = ref_srv.rollout(verts, faces, n, steps=t, cloud=c)
        if g.error or w.error or g.steps_done != t:
            raise RuntimeError(f"sharded rollout: {g.error!r}, {w.error!r}")
        roll_err.append(_max_err(g.fields, w.fields,
                                 f"{t}-step rollout at {n}"))
    reset_counts()
    del ref_srv
    log(f"[sharded] (c) rollouts on (a)'s engine (residual, {spf} steps a "
        f"flush): 3 steps at {n_small} and 2 at {n_big} in {flushes} "
        f"flushes, {t_roll:.3f} s; against the unsharded engine max abs err "
        + " / ".join(f"{e:.3g}" for e in roll_err)
        + f"; launches 3 kNN per shard per flush, {layers} segment-sum per "
        f"shard per lane-step | {card}")
    # state feedback at phase 13 (c)'s size and weights: steps_per_flush
    # clamps to 1 with a warning, and a host halo exchange between flushes
    n_w = WHOLE_PATH_POINTS
    cfg_f = cfg.replace(rollout_state_feats=True,
                        rollout_integrator="residual",
                        rollout_steps_per_flush=2)
    model = meshgraphnet.init(torch.Generator().manual_seed(0), cfg_f,
                              device=dev)
    s_f = GNNServer(cfg_f, (n_w,), max_batch=2, seed=0, params=model,
                    shard_devices=p_a)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = s_f.rollout_engine()
    if eng.steps_per_flush != 1 or not any(
            "clamping" in str(w.message) for w in caught):
        raise RuntimeError("sharded rollout with state feedback: no clamp "
                           f"to one step a flush ({eng.steps_per_flush})")
    res = s_f.rollout(verts, faces, n_w, steps=FEEDBACK_STEPS)
    counted("sharded_feedback", FEEDBACK_STEPS * p_a, FEEDBACK_STEPS * p_a)
    if res.error or not np.array_equal(res.points, feedback["points"]):
        raise RuntimeError(f"sharded feedback: {res.error!r}")
    fb_cpu = _max_err(res.fields, feedback["cpu"], "feedback against the "
                      "CPU")
    fb_card = _max_err(res.fields, feedback["card"], "feedback against the "
                       "unsharded card")
    del s_f, eng, model
    log(f"[sharded] (c) state feedback at {n_w} points, {p_a} shards, "
        f"steps_per_flush clamped to 1 with the warning: {FEEDBACK_STEPS} "
        f"steps against "
        f"phase 13 (c)'s unsharded CPU run max abs err {fb_cpu:.3g}, its "
        f"card run {fb_card:.3g} (atol {SHARD_ATOL})")

    # (b) beyond the top bucket --------------------------------------------
    n_req = SHARDED_POINTS
    levels = _level_sizes(n_req, levels_n)
    pts, nrm = sample_surface(verts, faces, n_req,
                              np.random.default_rng((0, 1)))
    g = shard_plan.measure(pts, SHARDED_SPLITS[0], layers, levels,
                           cfg.k_neighbors, "geometric",
                           cfg.shard_pad_factor)
    log(f"[sharded] (b) {n_req} points, geometric plan in "
        f"{SHARDED_SPLITS[0]} shards (not run): Nmax {g['nmax']}, "
        f"{g['nmax_padded']} at the server's pad factor "
        f"{cfg.shard_pad_factor}; replication {g['replication']:.3f}, halo "
        f"width {g['halo_width']:.5f}; {g['seconds']:.2f} s on the host")
    fields, lines = {}, []
    for p in SHARDED_SPLITS:
        t0 = time.perf_counter()
        plan = sharded.plan_shards(pts, nrm, p, layers, levels,
                                   cfg.k_neighbors, method="graph")
        t_plan = time.perf_counter() - t0
        batch = plan.batch(dev)
        if p == SHARDED_SPLITS[0]:
            _shard_kernel_check(dev, card, plan, batch, cfg)
        infer = sharded.make_sharded_infer_fn(cfg, plan.spec, device=dev)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = infer(params, batch)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        counted(f"sharded_{p}", p, p)
        fields[p] = plan.gather(out.cpu().numpy())
        if fields[p].shape != (n_req, cfg.node_out) or \
                not np.isfinite(fields[p]).all():
            raise RuntimeError(f"sharded {n_req} in {p}: bad fields")
        del out, batch, infer
        lines.append(
            f"{p} shards: {_plan_stats(plan)}; host plan {t_plan:.2f} s; "
            f"request {t_run:.3f} s, {t_run / p:.3f} s a shard; peak "
            f"memory {peak:.2f} GB")
        del plan
    err = _max_err(fields[SHARDED_SPLITS[0]], fields[SHARDED_SPLITS[1]],
                   f"{n_req} points, {SHARDED_SPLITS[0]} against "
                   f"{SHARDED_SPLITS[1]} shards")
    for line in lines:
        log(f"[sharded] (b) {n_req} points, graph plan, full width: "
            f"{line} | {card}")
    log(f"[sharded] (b) {SHARDED_SPLITS[0]} against {SHARDED_SPLITS[1]} "
        f"shards: max abs err {err:.3g} (atol {SHARD_ATOL}) on every point; "
        f"{levels_n} kNN and {layers} segment-sum launches a shard")
    log(f"[sharded] phase 15 took {time.perf_counter() - t_phase:.1f} s | "
        f"{card}")


def _shard_kernel_check(dev, card, plan, batch, cfg):
    """One shard of a 262,144-point plan: the kNN kernel bit-equal to its
    plain version at the shard's three level shapes (its merged grids and
    valid counts), and the segment-sum kernel within SEG_ATOL of its plain
    version at the shard's edge count. At the finest level and at that
    edge count, each kernel, its plain version and its yardstick are timed
    by CUDA events only (after phase 13, torch.profiler may hold none of
    a kernel's launches)."""
    import torch
    from repro_torch.graphx import hashgrid, sharded
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.kernels.segment_agg import ref as seg_ref

    p = int(np.argmax(plan.level_counts[:, -1]))      # the largest shard
    ms = plan.spec.ms
    lane = {k: batch[k][p] for k in sharded._DEVICE_KEYS}
    counts = batch["level_counts"][p]
    shapes, timed = [], []
    for n_l, nv, g in zip(ms.level_sizes, counts, ms.grids):
        q = lane["points"][:n_l].contiguous()
        cand, cvalid, _ = hashgrid.csr_candidate_lists(q, int(nv), g)
        args = (q, q[cand.long()], cand, cvalid, g.k)
        ki, kd, km = knn_ops.topk_neighbors(*args)
        pi, pd, pm = knn_ref.topk_neighbors(*args)
        if not (torch.equal(ki, pi) and torch.equal(km, pm)
                and torch.equal(kd, pd)):
            raise RuntimeError(f"sharded kNN at N={n_l} (valid {nv}), "
                               f"C={g.neigh_cap}: differs from the plain "
                               "version")
        shapes.append(f"N={n_l} valid {int(nv)} C={g.neigh_cap}")
    # the finest level: q, args and cvalid are its
    d2 = torch.where(cvalid, ((args[1] - q[:, None, :]) ** 2).sum(-1),
                     knn_ref.BIG)
    n_valid = int(cvalid.sum())
    n_c, k = cand.shape[1], args[4]
    timed.append(("knn_topk", f"N={q.shape[0]} C={n_c}, valid candidates "
                  f"{n_valid / cand.numel():.3f}",
                  lambda: knn_ops.topk_neighbors(*args),
                  lambda: knn_ref.topk_neighbors(*args),
                  lambda: torch.topk(d2, k, dim=1, largest=False),
                  "torch.topk", bound_ms(q.shape[0] * (12 + n_c + 12 * k)
                                         + n_valid * 12, 8.0 * n_valid)))
    _, s, r, em = sharded._shard_edges(lane, counts, ms)
    n_e, d = r.numel(), cfg.hidden
    msg = torch.randn((n_e, d), generator=torch.Generator().manual_seed(0)
                      ).to(dev) * em[:, None]
    prep = seg_ops.prepare(r, plan.spec.n_points, em)
    so = seg_ops.segment_sum_prepared(prep, msg)
    sp = seg_ref.segment_sum_csr(msg, prep.perm, prep.row_ptr)
    torch.testing.assert_close(so, sp, atol=SEG_ATOL, rtol=SEG_RTOL)
    n_nodes, e_valid = plan.spec.n_points, int(em.sum())
    recv = r.long()
    timed.append(("segment_sum", f"E={n_e} N={n_nodes} D={d}",
                  lambda: seg_ops.segment_sum_prepared(prep, msg),
                  lambda: seg_ref.segment_sum_csr(msg, prep.perm,
                                                  prep.row_ptr),
                  lambda: torch.zeros_like(so).index_add_(0, recv, msg),
                  "index_add_",
                  bound_ms((e_valid + n_nodes) * d * 4 + e_valid * 4
                           + (n_nodes + 1) * 4, float(e_valid) * d)))
    for name, shape, kernel, plain, library, lib_name, bound in timed:
        ms_k = time_cuda(kernel, 20)
        log(f"[sharded] (b) {name} at the shard's shape {shape}: "
            f"{ms_k:.4f} ms (CUDA events, host work included), bound "
            f"{bound[0]:.4f} ms by {bound[1]} ({bound[0] / ms_k:.3f} of it); "
            f"plain {time_cuda(plain, 3, warmup=1):.3f} ms; {lib_name} "
            f"{time_cuda(library, 20):.4f} ms | {card}")
    del timed, d2
    log(f"[sharded] (b) shard {p}: kNN bit-equal to its plain version at "
        + ", ".join(shapes) + f"; segment-sum E={n_e} N={plan.spec.n_points} "
        f"D={d} (masked {1 - int(em.sum()) / n_e:.3f}) max abs err "
        f"{float((so - sp).abs().max()):.3g} against its plain version | "
        f"{card}")
    del msg, so, sp, prep


def _edge_keys(g):
    """A graph's (sender, receiver) pairs as sorted int64 keys, with their
    level tags in the same order: equal outputs mean equal edge sets."""
    key = g.senders.astype(np.int64) * g.n_nodes + g.receivers
    order = np.argsort(key, kind="stable")
    return key[order], g.level_of_edge[order]


def seg_backward_check(dev, cfg, ps) -> dict:
    """Phase 3 for the segment-sum backward kernel, at the shape of one
    training partition (partition 0 of ``ps``): bit-equal to its plain
    version, masked rows zero, and timed."""
    import torch
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.kernels.segment_agg import ref as seg_ref

    recv = torch.from_numpy(ps.stacked["receivers"][0]).to(dev)
    emask = torch.from_numpy(ps.stacked["edge_mask"][0]).to(dev)
    n_pad, e_pad = ps.stacked["node_feats"].shape[1], recv.numel()
    d = cfg.hidden
    prep = seg_ops.prepare(recv, n_pad, emask)
    g_out = torch.randn((n_pad, d),
                        generator=torch.Generator().manual_seed(0)).to(dev)
    got = seg_ops.segment_sum_backward(prep, g_out, e_pad)
    torch.cuda.synchronize()
    want = seg_ref.segment_sum_csr_backward(g_out, prep.perm, prep.row_ptr,
                                            e_pad)
    if not torch.equal(got, want):
        raise RuntimeError("segment_sum_backward: differs from the plain "
                           "version")
    masked = emask == 0
    if got[masked].any():
        raise RuntimeError("segment_sum_backward: a masked edge's row is "
                           "not zero")
    recv_long = recv.long()
    lib = torch.index_select(g_out, 0, recv_long) * emask[:, None]
    lib_err = float((got - lib).abs().max())
    n_bytes = e_pad * d * 4 + n_pad * d * 4 + e_pad * 4 + (n_pad + 1) * 4
    row = dict(
        name="segment_sum_backward", route="cuda",
        source="src/repro_torch/kernels/segment_agg/csrc/segment_sum.cu",
        replaces="src/repro/models/meshgraphnet.py:87",
        replaces_note="no TPU kernel: XLA's transpose of jax.ops.segment_sum "
                      "(a row gather); the kernel is the port's own",
        max_abs_err=float((got - want).abs().max()),
        **timed_row(
            lambda: seg_ops.segment_sum_backward(prep, g_out, e_pad),
            SEG_BWD_KERNEL,
            lambda: seg_ref.segment_sum_csr_backward(
                g_out, prep.perm, prep.row_ptr, e_pad),
            lambda: torch.index_select(g_out, 0, recv_long)
            * emask[:, None],
            bound_ms(n_bytes, 0.0), plain_reps=5),
        library_note="torch.index_select(grad_out, 0, recv) * edge_mask",
        shape=f"E={e_pad} N={n_pad} D={d}, masked "
              f"{float(masked.float().mean()):.3f}, max abs diff vs "
              f"index_select {lib_err:.3g}")
    log_row(row, "index_select")
    return row


def gather_rows_check(dev, cfg, ps) -> dict:
    """Phase 3 for the gathers' backward at the shape of one training
    partition (partition 0 of ``ps``): the segment-sum kernel over the sender
    CSR, reading its column slice of an (E, 3 D) gradient in place, held
    bit-equal to its plain version over both CSRs, and timed with the bound
    of the valid edges and two yardsticks: ``index_add_`` and today's
    sort-based ``index_put_(accumulate=True)``."""
    import torch
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.kernels.segment_agg import ref as seg_ref

    send, recv, emask = (torch.from_numpy(ps.stacked[k][0]).to(dev) for k in
                         ("senders", "receivers", "edge_mask"))
    n_pad, e_pad = ps.stacked["node_feats"].shape[1], send.numel()
    d = cfg.hidden
    csrs = {"senders": seg_ops.prepare(send, n_pad, emask),
            "receivers": seg_ops.prepare(recv, n_pad, emask)}
    runs = {}
    for name, csr in csrs.items():
        deg = (csr.row_ptr[1:] - csr.row_ptr[:-1]).float()
        runs[name] = (int(deg.max()), float(deg.mean()))
    log("[kernels] CSR runs at the training shape (longest, mean): "
        + ", ".join(f"{k} {m} / {a:.3f}" for k, (m, a) in runs.items()))
    # the gradient of torch.cat([h[send], h[recv], e]): masked rows zero, as
    # the edge mask makes them in the model
    wide = torch.randn((e_pad, 3 * d),
                       generator=torch.Generator().manual_seed(0)).to(dev) \
        * emask[:, None]
    slices = {"senders": wide[:, :d], "receivers": wide[:, d:2 * d]}
    err = 0.0
    for name, csr in csrs.items():
        g = slices[name]
        if g.stride() != (3 * d, 1) or seg_ops._float4_rows(g) is not g:
            raise RuntimeError(f"gather_rows_backward: the {name} slice "
                               f"(strides {g.stride()}) is not read in place")
        got = seg_ops.gather_rows_backward(csr, g)
        torch.cuda.synchronize()
        want = seg_ref.segment_sum_csr(g, csr.perm, csr.row_ptr)
        err = max(err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise RuntimeError(f"gather_rows_backward over the {name} CSR: "
                               f"differs from the plain version by {err}")
    prep, g = csrs["senders"], slices["senders"]
    send_long = send.long()
    got = seg_ops.gather_rows_backward(prep, g)

    def index_put():
        return torch.zeros((n_pad, d), device=dev).index_put_(
            (send_long,), g, accumulate=True)

    def index_add():
        return torch.zeros((n_pad, d), device=dev).index_add_(0, send_long, g)

    lib_err = max(float((got - f()).abs().max()) for f in (index_add,
                                                           index_put))
    valid = int(prep.row_ptr[-1])
    n_bytes = valid * d * 4 + n_pad * d * 4 + valid * 4 + (n_pad + 1) * 4
    bound = bound_ms(n_bytes, valid * d)
    row = dict(
        name="gather_rows_backward", route="cuda",
        source="src/repro_torch/kernels/segment_agg/csrc/segment_sum.cu",
        replaces="src/repro/models/meshgraphnet.py:129",
        replaces_note="no TPU kernel: XLA's transpose of the gathers "
                      "h[senders], h[receivers] (a scatter-add); the port "
                      "runs its segment-sum kernel (the port of _agg_kernel, "
                      "src/repro/kernels/segment_agg/kernel.py:28) over a "
                      "sender and a receiver CSR",
        max_abs_err=err,
        **timed_row(lambda: seg_ops.gather_rows_backward(prep, g),
                    SEG_KERNEL,
                    lambda: seg_ref.segment_sum_csr(g, prep.perm,
                                                    prep.row_ptr),
                    index_add, bound, plain_reps=5),
        library_note="torch.zeros(N, D).index_add_(0, send, grad)",
        index_put_device_ms=device_ms(index_put, 20),
        index_put_ms=time_cuda(index_put, 20),
        index_put_note="torch.zeros(N, D).index_put_((send,), grad, "
                       "accumulate=True): the sort-based indexing_backward "
                       "the training step ran before",
        runs={k: {"longest": m, "mean": a} for k, (m, a) in runs.items()},
        shape=f"E={e_pad} (valid {valid}) N={n_pad} D={d}, a column slice "
              f"of ({e_pad}, {3 * d}); max abs diff vs index_add_ / "
              f"index_put_ {lib_err:.3g}")
    log_row(row, "index_add_")
    log(f"[kernels] gather_rows_backward: index_put_(accumulate=True) "
        f"device {row['index_put_device_ms']:.4f} ms, call "
        f"{row['index_put_ms']:.4f} ms")
    # the aggregation (segment_sum_prepared, contiguous rows) at this shape
    msgs = slices["receivers"].contiguous()
    fwd_ms = device_ms(lambda: seg_ops.segment_sum_prepared(
        csrs["receivers"], msgs), 50, SEG_KERNEL)
    row["forward_at_this_shape"] = dict(device_ms=fwd_ms,
                                        bound_ms=bound[0],
                                        fraction_of_bound=bound[0] / fwd_ms)
    log(f"[kernels] segment_sum forward at the training shape: device "
        f"{fwd_ms:.4f} ms, {bound[0] / fwd_ms:.3f} of its bound "
        f"{bound[0]:.4f} ms by {bound[1]}")
    return row


def _near_zero_split(got, want, grads):
    """(max |got - want| where |grad| >= TRAIN_NEAR_ZERO, the same where
    below, share of elements below), over lists of CPU tensors."""
    far, near, n_near, n_all = 0.0, 0.0, 0, 0
    for g, w, gr in zip(got, want, grads):
        diff = (g - w).abs()
        nz = gr.abs() < TRAIN_NEAR_ZERO
        far = max(far, float(diff[~nz].max()) if (~nz).any() else 0.0)
        near = max(near, float(diff[nz].max()) if nz.any() else 0.0)
        n_near += int(nz.sum())
        n_all += nz.numel()
    return far, near, n_near / max(n_all, 1)


def whole_train_setup():
    """Phase 9's config, its one training sample (with the normalizers)
    and that sample's partition batch, and its Adam config; phase 16 runs
    the same step."""
    from repro_torch.configs.base import GNNConfig
    from repro_torch.data import pipeline as pipe
    from repro_torch.optim.adam import AdamConfig

    cfg = GNNConfig().replace(levels=WHOLE_TRAIN_LEVELS,
                              n_partitions=WHOLE_TRAIN_PARTITIONS,
                              n_mp_layers=WHOLE_TRAIN_LAYERS,
                              halo=WHOLE_TRAIN_LAYERS)
    train, _, ni, no = pipe.build_dataset(cfg, 2)
    [ps] = pipe.partition_samples(cfg, train, ni, no)
    return cfg, (train[0], ni, no), ps, AdamConfig(total_steps=10)


def whole_train_model(cfg):
    """Phase 9's weights, on the CPU."""
    import torch
    from repro_torch.models import meshgraphnet
    return meshgraphnet.init(torch.Generator().manual_seed(0), cfg,
                             device="cpu")


def train_whole_path(dev, card, reset_counts, read_counts, by_phase) -> dict:
    """Phase 9: one optimizer step at full width (2 layers), card against
    CPU, from the same parameters and the same partition batch. Returns
    the card's step (loss, grad norm, gradients, updated parameters) for
    phase 16."""
    import torch
    from repro_torch.launch.train import make_gnn_step_fn, prepare_gnn_batch
    from repro_torch.optim.adam import adam_init

    cfg, _, ps, opt_cfg = whole_train_setup()
    step = make_gnn_step_fn(cfg, opt_cfg)
    model_cpu = whole_train_model(cfg)
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    b_gpu = prepare_gnn_batch(ps, dev)
    b_cpu = prepare_gnn_batch(ps, "cpu")
    for k in b_cpu[0]:
        if not torch.equal(b_gpu[0][k].cpu(), b_cpu[0][k]):
            raise RuntimeError(f"train whole path: partition batch {k!r} "
                               "differs on the card")
    if not torch.equal(b_gpu[1].cpu(), b_cpu[1]):
        raise RuntimeError("train whole path: loss denominators differ")
    out = {}
    for name, model, batch in (("gpu", model_gpu, b_gpu),
                               ("cpu", model_cpu, b_cpu)):
        reset_counts()
        t0 = time.perf_counter()
        opt = adam_init([p for _, p in model.leaves()])
        opt, loss, gnorm, skipped = step(model, opt, *batch)
        loss = float(loss)
        out[name] = dict(
            loss=loss, gnorm=float(gnorm), skipped=skipped,
            s=time.perf_counter() - t0,
            names=[n for n, _ in model.leaves()],
            grads=[p.grad.detach().cpu() for _, p in model.leaves()],
            params=[p.detach().cpu() for _, p in model.leaves()])
        read_counts(f"train_whole_path_{name}")
    g, c = out["gpu"], out["cpu"]
    n_parts = ps.stacked["senders"].shape[0]
    want = {"segment_sum": 2 * cfg.n_mp_layers * n_parts,
            "segment_sum_backward": cfg.n_mp_layers * n_parts,
            "gather_rows_backward": 2 * cfg.n_mp_layers * n_parts}
    for name, n in want.items():
        got = by_phase[name]["train_whole_path_gpu"]
        if got != n:
            raise RuntimeError(f"train whole path: {name} launched {got} "
                               f"times on the card, expected {n}")
    if g["skipped"] or c["skipped"] or not np.isfinite(g["loss"]):
        raise RuntimeError(f"train whole path: step skipped or loss not "
                           f"finite (card {g['loss']}, CPU {c['loss']})")
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    if loss_rel > TRAIN_LOSS_RTOL:
        raise RuntimeError(f"train whole path: loss card {g['loss']} CPU "
                           f"{c['loss']}, relative {loss_rel} > "
                           f"{TRAIN_LOSS_RTOL}")
    worst = (0.0, "")
    for name, gg, gcpu in zip(c["names"], g["grads"], c["grads"]):
        scale = float(gcpu.abs().max())
        rel = float((gg - gcpu).abs().max()) / max(scale, 1e-30)
        if scale == 0.0 and name.startswith(("edge_encoder", "proc_edge")):
            raise RuntimeError(f"train whole path: gradient of {name} is "
                               "zero on the CPU")
        if not float(gg.abs().max()) > 0 and \
                name.startswith(("edge_encoder", "proc_edge")):
            raise RuntimeError(f"train whole path: gradient of {name} is "
                               "zero on the card: the aggregation detached")
        worst = max(worst, (rel, name))
    if worst[0] > TRAIN_GRAD_RTOL:
        raise RuntimeError(f"train whole path: gradient of {worst[1]} "
                           f"differs by {worst[0]} of its largest element "
                           f"> {TRAIN_GRAD_RTOL}")
    far, near, share = _near_zero_split(g["params"], c["params"], c["grads"])
    if far > TRAIN_PARAM_ATOL or near > 2 * opt_cfg.lr_max:
        raise RuntimeError(f"train whole path: updated params differ by "
                           f"{far} (limit {TRAIN_PARAM_ATOL}), near-zero "
                           f"gradients {near} (limit {2 * opt_cfg.lr_max})")
    n_pad, e_pad = ps.stacked["node_feats"].shape[1], \
        ps.stacked["senders"].shape[1]
    log(f"[train_whole_path] hidden {cfg.hidden}, {cfg.n_mp_layers} layers, "
        f"{max(cfg.levels)} points in {n_parts} partitions (N={n_pad} "
        f"E={e_pad} each): batches equal; loss card "
        f"{g['loss']:.8f} CPU {c['loss']:.8f} (relative {loss_rel:.3g}, "
        f"limit {TRAIN_LOSS_RTOL}); gnorm {g['gnorm']:.6f} / "
        f"{c['gnorm']:.6f}; worst gradient leaf {worst[1]} "
        f"{worst[0]:.3g} of its largest element (limit {TRAIN_GRAD_RTOL}); "
        f"updated params max abs err {far:.3g} (limit {TRAIN_PARAM_ATOL}), "
        f"{near:.3g} on the {share:.2%} with gradient below "
        f"{TRAIN_NEAR_ZERO}; launches segment_sum "
        f"{by_phase['segment_sum']['train_whole_path_gpu']}, backward "
        f"{by_phase['segment_sum_backward']['train_whole_path_gpu']}, "
        f"gathers' backward "
        f"{by_phase['gather_rows_backward']['train_whole_path_gpu']}; card "
        f"{g['s']:.3f} s (first step), CPU {c['s']:.2f} s | {card}")
    return g


def _same_params(a, b) -> bool:
    """Every parameter of the two models bit-equal."""
    import torch
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    return sorted(pa) == sorted(pb) and all(
        torch.equal(pa[k], pb[k]) for k in pa)


def resume_check(dev, card, cfg, ck, model, losses, norms, reset_counts,
                 read_counts, by_phase):
    """Phase 11: resume phase 10 from its step-2 checkpoint (bit-equal to
    the straight run), serve its final checkpoint (bit-equal to a server
    built from phase 10's model), and check that the step-1 checkpoint is
    told apart."""
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.base import GNNConfig
    from repro_torch.data import geometry as geo
    from repro_torch.launch.serve_gnn import GNNServer
    from repro_torch.launch.train import train_gnn

    t_phase = time.perf_counter()
    last = TRAIN_STEPS - 1
    p_last = ckpt.retained_path(ck, last)
    t0 = time.perf_counter()
    tree = ckpt.restore(p_last)
    restore_s = time.perf_counter() - t0
    del tree
    # resume: the last step again, from the checkpoint ---------------------
    reset_counts()
    t0 = time.perf_counter()
    m_res, l_res, _ = train_gnn(cfg, TRAIN_STEPS, TRAIN_SAMPLES, log_every=1,
                                resume=p_last, device=dev)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    read_counts("resume")
    n_parts = cfg.n_partitions
    want = {"segment_sum": 2 * cfg.n_mp_layers * n_parts,
            "segment_sum_backward": cfg.n_mp_layers * n_parts,
            "gather_rows_backward": 2 * cfg.n_mp_layers * n_parts}
    for name, n in want.items():
        if by_phase[name]["resume"] != n:
            raise RuntimeError(f"resume: {name} launched "
                               f"{by_phase[name]['resume']} times, expected "
                               f"{n} (one step)")
    if l_res != losses[last:]:
        raise RuntimeError(f"resume: loss {l_res} != the straight run's "
                           f"{losses[last:]}")
    if not _same_params(m_res, model):
        worst = max(float((a - b).detach().abs().max()) for a, b in
                    zip(m_res.parameters(), model.parameters()))
        raise RuntimeError(f"resume: parameters differ from the straight "
                           f"run's by up to {worst}")
    del m_res
    log(f"[resume] from {os.path.basename(p_last)} "
        f"({os.path.getsize(p_last)} bytes; restore alone {restore_s:.3f} "
        f"s): one step, loss {l_res[0]!r} bit-equal to the straight run's "
        f"step {last}, every parameter bit-equal; train_gnn with resume "
        f"{resume_s:.2f} s (data and partitioning included); launches "
        f"segment_sum {by_phase['segment_sum']['resume']}, backward "
        f"{by_phase['segment_sum_backward']['resume']}, gathers' backward "
        f"{by_phase['gather_rows_backward']['resume']} | {card}")

    # serve the final checkpoint, against a server of the model in memory --
    verts, faces = geo.car_surface(geo.sample_params(1))
    n = BUCKETS[0]
    reset_counts()
    t0 = time.perf_counter()
    srv = GNNServer.from_checkpoint(ck, GNNConfig(), (n,), max_batch=1)
    load_s = time.perf_counter() - t0
    [r_ck] = srv.serve([(verts, faces, n)])
    torch.cuda.synchronize()
    read_counts("serve_ckpt")
    want = {"segment_sum": GNNConfig().n_mp_layers, "knn_topk": 3}
    for name, k in want.items():
        if by_phase[name]["serve_ckpt"] != k:
            raise RuntimeError(f"serve from checkpoint: {name} launched "
                               f"{by_phase[name]['serve_ckpt']} times, "
                               f"expected {k}")
    ni, no = norms
    del srv
    mem = GNNServer(GNNConfig(), (n,), max_batch=1, params=model,
                    norm_in=(ni.mean, ni.std), norm_out=(no.mean, no.std))
    [r_mem] = mem.serve([(verts, faces, n)])
    del mem
    if r_ck.fields.shape != (n, GNNConfig().node_out) or \
            not np.isfinite(r_ck.fields).all():
        raise RuntimeError("serve from checkpoint: bad fields")
    if not (np.array_equal(r_ck.points, r_mem.points)
            and np.array_equal(r_ck.fields, r_mem.fields)):
        raise RuntimeError(
            f"serve from checkpoint: fields differ from the in-memory "
            f"server's by {np.abs(r_ck.fields - r_mem.fields).max()}")
    log(f"[serve_ckpt] GNNServer.from_checkpoint (load and calibrate "
        f"{load_s:.2f} s), one {n}-point request: fields bit-equal to the "
        f"server of phase 10's model; cp range [{r_ck.fields[:, 0].min():.3f}"
        f", {r_ck.fields[:, 0].max():.3f}]; launches segment_sum "
        f"{by_phase['segment_sum']['serve_ckpt']}, knn_topk "
        f"{by_phase['knn_topk']['serve_ckpt']}")

    # negative: the step-1 checkpoint, resumed to step 1, must differ ------
    p_first = ckpt.retained_path(ck, 1)
    m_neg, l_neg, _ = train_gnn(cfg, 1, TRAIN_SAMPLES, resume=p_first,
                                device=dev)
    if l_neg or _same_params(m_neg, model):
        raise RuntimeError("negative check: the step-1 checkpoint's "
                           "parameters compare equal to the final model's")
    worst = max(float((a - b).detach().abs().max()) for a, b in
                zip(m_neg.parameters(), model.parameters()))
    del m_neg
    log(f"[resume] negative check: {os.path.basename(p_first)} resumed to "
        f"step 1 differs from the final model (max abs {worst:.3g}), as it "
        f"must; phase 11 took {time.perf_counter() - t_phase:.1f} s | {card}")


def train_phases(dev, card, reset_counts, read_counts, by_phase):
    """The training kernels' rows (phase 3: the segment-sum backward and the
    gathers' backward), phases 9 to 11 and the profiled step; returns the
    rows and what phase 16 holds its runs against (phase 9's card step,
    phase 10's losses). Its tensors are freed when it returns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import GNNConfig
    from repro_torch.data import pipeline as pipe
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.train import (eval_gnn, make_gnn_step_fn,
                                          prepare_gnn_batch, train_gnn)
    from repro_torch.optim.adam import AdamConfig, adam_init
    from repro_torch.telemetry import Telemetry

    cfg = GNNConfig().replace(levels=TRAIN_LEVELS,
                              n_partitions=TRAIN_PARTITIONS)
    # 3. the backward kernel at one training partition's shape -------------
    t0 = time.perf_counter()
    s0 = pipe.build_sample(cfg, 0)
    parts0 = pipe.build_sample_partitions(cfg, s0)
    ps0 = pipe.partition_sample(cfg, s0, parts=parts0)
    log(f"[kernels] training partitions of sample 0 built on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    reset_counts()
    rows = [seg_backward_check(dev, cfg, ps0), gather_rows_check(dev, cfg, ps0)]
    torch.cuda.synchronize()
    read_counts("kernel_check")

    # 9. one step, card against CPU ----------------------------------------
    whole = train_whole_path(dev, card, reset_counts, read_counts, by_phase)

    # 14. the graphx training-graph source ---------------------------------
    reset_counts()
    t0 = time.perf_counter()
    sx = pipe.build_sample(cfg, 0, source="graphx", device=dev)
    torch.cuda.synchronize()
    t_graphx = time.perf_counter() - t0
    read_counts("graphx_source")
    got = {name: by_phase[name]["graphx_source"] for name in by_phase}
    want = {name: 0 for name in by_phase}
    want["knn_topk"] = len(cfg.levels)
    if got != want:
        raise RuntimeError(f"graphx source: launches {got}, expected {want}")
    t0 = time.perf_counter()
    sh = pipe.build_sample(cfg, 0, source="host")
    t_host = time.perf_counter() - t0
    kx, kh = _edge_keys(sx.graph), _edge_keys(sh.graph)
    if not (all(np.array_equal(a, b) for a, b in zip(kx, kh))
            and np.array_equal(sx.node_feats, sh.node_feats)
            and np.array_equal(sx.targets, sh.targets)):
        raise RuntimeError(f"graphx source: {sx.graph.n_edges} edges against "
                           f"the host's {sh.graph.n_edges}, not the same set")
    log(f"[graphx_source] build_sample(source='graphx') of sample 0 at "
        f"levels {cfg.levels} on the card: {sx.graph.n_edges} edges, the "
        f"host cKDTree build's edge set and level tags, 3 kNN launches; "
        f"graphx {t_graphx:.3f} s, host {t_host:.3f} s (both include the "
        f"surface sampling and features) | {card}")
    del sx, sh

    # 10. training at full width: the main path, counted --------------------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                                   dir=ROOT / "build"))
    try:
        ck = str(ck_dir / "train.msgpack")
        tel = Telemetry(enabled=True)
        reset_counts()
        model, losses, (train, test, ni, no) = train_gnn(
            cfg, TRAIN_STEPS, TRAIN_SAMPLES, ck, log_every=1,
            telemetry=tel, ckpt_every=1, keep_ckpts=TRAIN_KEEP_CKPTS,
            device=dev)
        torch.cuda.synchronize()
        read_counts("train")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_parts = cfg.n_partitions
        want = {"segment_sum": 2 * cfg.n_mp_layers * n_parts * TRAIN_STEPS,
                "segment_sum_backward":
                    cfg.n_mp_layers * n_parts * TRAIN_STEPS,
                "gather_rows_backward":
                    2 * cfg.n_mp_layers * n_parts * TRAIN_STEPS}
        for name, n in want.items():
            got = by_phase[name]["train"]
            if got != n:
                raise RuntimeError(f"train: {name} launched {got} times in "
                                   f"{TRAIN_STEPS} steps, expected {n}")
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
            raise RuntimeError(f"train: losses {losses}")
        hist = {k: tel.metrics.histogram(f"train_stage_{k}_seconds")
                for k in ("data", "partition", "checkpoint")}
        spans = tel.tracer.records()
        step_span = {r.attrs["it"]: r.duration_s for r in spans
                     if r.name == "step"}
        prep_span = {int(r.trace_id.split("-")[1]): r.duration_s
                     for r in spans if r.name == "prepare"}
        step_s = [step_span[i] - prep_span[i] for i in range(TRAIN_STEPS)]
        log(f"[train] GNNConfig() full width ({cfg.hidden} hidden, "
            f"{cfg.n_mp_layers} layers, remat {cfg.remat}), levels "
            f"{cfg.levels}, {n_parts} partitions, {len(train)} train / "
            f"{len(test)} test samples: host data {hist['data'].sum:.2f} s, "
            f"partition {hist['partition'].sum:.2f} s; steps (s): "
            + ", ".join(f"{t:.3f}" for t in step_s)
            + " (first, then warm); staging "
            + ", ".join(f"{prep_span[i]:.4f}" for i in range(TRAIN_STEPS))
            + f" s; losses {losses!r} (bit-exact); peak memory "
            f"{peak_gb:.2f} GB; launches segment_sum "
            f"{by_phase['segment_sum']['train']}, backward "
            f"{by_phase['segment_sum_backward']['train']}, gathers' "
            f"backward {by_phase['gather_rows_backward']['train']} | {card}")
        kept = [st for st, _ in ckpt.retained_steps(ck)]
        if kept != list(range(1, TRAIN_STEPS)) or not os.path.exists(ck):
            raise RuntimeError(f"train: checkpoints at steps {kept} and "
                               f"final {os.path.exists(ck)}; expected "
                               f"steps 1-{TRAIN_STEPS - 1} and the final")
        sizes = {os.path.basename(p): os.path.getsize(p)
                 for p in [q for _, q in ckpt.retained_steps(ck)] + [ck]}
        h = hist["checkpoint"]
        held = [r.duration_s for r in spans if r.name == "checkpoint"]
        log(f"[train] checkpoints (bytes): " + ", ".join(
            f"{k} {v}" for k, v in sizes.items())
            + f"; checkpoint stage: {h.count} writes, {h.sum:.3f} s in all, "
            f"min {h.snapshot()['min']:.3f} s, max "
            f"{h.snapshot()['max']:.3f} s (the last one on the loop's "
            "thread, the others on the writer's); the loop held in its "
            "checkpoint spans (s): " + ", ".join(f"{t:.3f}" for t in held)
            + " | " + card)

        t0 = time.perf_counter()
        metrics = eval_gnn(cfg, model, test, ni, no)
        eval_s = time.perf_counter() - t0
        if not all(np.isfinite(m["rel_l2"]) and np.isfinite(m["rel_l1"])
                   for k, m in metrics.items() if k != "force_r2"):
            raise RuntimeError(f"eval: {metrics}")
        log(f"[train] eval_gnn on {len(test)} test sample(s) in "
            f"{eval_s:.2f} s: " + json.dumps(metrics))

        # 11. resume, serve from the checkpoint, and a negative check ------
        # (before the profiled step: torch.profiler drops launches after a
        # profile of a whole step)
        resume_check(dev, card, cfg, ck, model, losses, (ni, no),
                     reset_counts, read_counts, by_phase)
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)

    # one more step, profiled by kernel (sample 0, a fresh Adam state) ------
    ps = pipe.partition_sample(cfg, s0, ni, no, parts=parts0)
    stacked, denom = prepare_gnn_batch(ps, dev)
    step = make_gnn_step_fn(cfg, AdamConfig(total_steps=TRAIN_STEPS))
    opt = adam_init([p for _, p in model.leaves()])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(model, opt, stacked, denom)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = device_rows(prof.key_averages())
    total = sum(ms for _, ms, _ in kernels)
    if not total > 0:
        raise RuntimeError("train breakdown: the profile shows no device time")
    sorting = [(k[:80], n) for k, _, n in kernels if INDEXING_BWD_KERNEL in k]
    if sorting:
        raise RuntimeError(f"train breakdown: the step still launches "
                           f"PyTorch's sort-based gather backward: {sorting}")
    gemm = sum(ms for k, ms, _ in kernels
               if re.search(r"gemm|gemv|nvjet|cutlass|xmma", k, re.I))
    seg = [(ms, n) for k, ms, n in kernels if SEG_KERNEL in k]
    seg_f, seg_n = sum(ms for ms, _ in seg), sum(n for _, n in seg)
    seg_b = sum(ms for k, ms, _ in kernels if SEG_BWD_KERNEL in k)
    # the gathers' backward launches the segment-sum kernel too: its share
    # is what ran under the GatherRowsBackward autograd nodes
    gather = [e for e in prof.events() if e.name == GATHER_BWD_NODE]
    gather_ms = sum(e.device_time_total for e in gather) / 1e3
    gather_n = sum(1 for e in gather for k in e.kernels
                   if SEG_KERNEL in k.name)
    log(f"[train_breakdown] one warm step (profiled, wall {wall:.3f} s): "
        f"device kernel time {total:.1f} ms in "
        f"{sum(n for *_, n in kernels)} launches ({total / 1e3 / wall:.1%} "
        f"of the wall), of which GEMMs {gemm:.1f} ms ({gemm / total:.1%}), "
        f"segment_sum_kernel {seg_f:.2f} ms in {seg_n} launches (the "
        f"aggregation and the gathers' backward), segment_sum_backward "
        f"{seg_b:.2f} ms, other {total - gemm - seg_f - seg_b:.1f} ms; no "
        f"{INDEXING_BWD_KERNEL} kernel")
    log(f"[train_breakdown] gathers' backward: {gather_ms:.2f} ms of device "
        f"time under {len(gather)} {GATHER_BWD_NODE} nodes, {gather_n} "
        f"segment_sum_kernel launches ({gather_ms / total:.2%} of the "
        f"step's device time) | {card}")
    for k, ms, n in kernels[:10]:
        log(f"[train_breakdown]   {ms:10.3f} ms  x{n:<5d} {k[:110]}")
    return rows, {"whole": whole, "train_losses": losses}


def _window_pairs(s: int, window) -> int:
    """Unmasked (query, key) pairs of one head under causal masking."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def row_rel_err(got, want):
    """|got - want| / |want| over the last dim (hd), one per (row, head)."""
    g, w = got.float(), want.float()
    return (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)


def plain_dropping_a_tile(qf, kf, vf, gs: int, window, cap: float):
    """A stand-in for a wrong kernel: the plain version (causal) with the
    first key tile of each row's range skipped wherever the row has keys in
    a later tile, as an off-by-one in the kernel's first tile would."""
    import math

    import torch
    s, hd = qf.shape[1:]
    i = torch.arange(s, device=qf.device)
    mask = i[:, None] >= i[None, :]
    if window is not None:
        mask &= (i[:, None] - i[None, :]) < window
    tile = i // KEY_TILE
    first = tile[None, :] == (mask.int().argmax(1) // KEY_TILE)[:, None]
    mask &= ~(first & (mask & ~first).any(1, keepdim=True))
    kr, vr = (t.repeat_interleave(gs, 0).float() for t in (kf, vf))
    sc = torch.einsum("hqd,hkd->hqk", qf.float(), kr) / math.sqrt(hd)
    if cap is not None:
        sc = cap * torch.tanh(sc / cap)
    sc = torch.where(mask, sc, -1e30)
    return torch.einsum("hqk,hkd->hqd", sc.softmax(-1), vr).to(qf.dtype)


def flex_yardstick(q, k, v, cap, window):
    """``flex_attention`` computing the kernel's function: the softcap (if
    any) as a ``score_mod`` (it gets the scaled score), causal and window as
    a block mask, GQA. q (B, H, S, hd), k and v (B, KV, S, hd). Returns the
    compiled call, its first output and the seconds of that first call
    (compile included). The port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        ok = q_idx >= kv_idx
        if window is not None:
            ok = ok & (q_idx - kv_idx < window)
        return ok

    s = q.shape[2]
    block_mask = create_block_mask(mask_mod, None, None, s, s,
                                   device=q.device)
    compiled = torch.compile(flex_attention)

    def call():
        return compiled(q, k, v,
                        score_mod=None if cap is None else score_mod,
                        block_mask=block_mask, enable_gqa=True)
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return call, out, time.perf_counter() - t0


def flash_check(dev, card) -> dict:
    """Phase 3 for the flash kernels: against their plain version at the
    serve phase's prefill shape, bf16 (wgmma kernel) and f32 (CUDA-core
    kernel), with the local window and without; in bf16 also the plain
    version, flex_attention (same function) and SDPA (no softcap) timed."""
    import math

    import torch
    from torch.nn import functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    cfg = get_config(LLM_ARCH)
    b, s = LLM_BATCH, LLM_PROMPT
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gs, cap = h // kvh, cfg.attn_softcap
    gen = torch.Generator(device=dev).manual_seed(0)
    base = [torch.randn((b, s, n, hd), generator=gen, device=dev)
            for n in (h, kvh, kvh)]
    errs, row_errs, by_window = {}, {}, {}
    for dname in ("bfloat16", "float32"):
        q, k, v = (t.to(getattr(torch, dname)) for t in base)
        qf, kf, vf = (t.transpose(1, 2).reshape(-1, s, hd).contiguous()
                      for t in (q, k, v))
        for window in (cfg.sliding_window, None):
            got = fa_ops.mha(q, k, v, causal=True, window=window,
                             softcap=cap)
            torch.cuda.synchronize()
            want = fa_ref.attention(qf, kf, vf, group_size=gs, causal=True,
                                    window=window, softcap=cap)
            want = want.reshape(b, h, s, hd).transpose(1, 2)
            if got.dtype != q.dtype or got.shape != q.shape:
                raise RuntimeError("flash_attention: bad output")
            diff = (got.float() - want.float()).abs()
            atol, rtol = FLASH_TOL[dname]
            err = float(diff.max())
            errs[f"{dname} window={window}"] = err
            if not bool((diff <= atol + rtol * want.float().abs()).all()):
                raise RuntimeError(
                    f"flash_attention {dname} window={window}: max abs "
                    f"error {err}, beyond {atol} + {rtol} |want|")
            del diff
            rows = row_rel_err(got, want)
            if dname == "float32":
                row_errs[f"float32 {window}"] = dict(
                    max=float(rows.max()), median=float(rows.median()))
            else:
                wrong = plain_dropping_a_tile(qf, kf, vf, gs, window, cap)
                wrong = row_rel_err(
                    wrong.reshape(b, h, s, hd).transpose(1, 2), want)
                e = row_errs[str(window)] = dict(
                    max=float(rows.max()), median=float(rows.median()),
                    tile_dropped_max=float(wrong.max()),
                    tile_dropped_median=float(wrong.median()))
                del wrong
                if not e["max"] <= FLASH_ROW_RTOL:
                    raise RuntimeError(
                        f"flash_attention bf16 window={window}: row relative "
                        f"error {e['max']} > {FLASH_ROW_RTOL}")
                if not e["tile_dropped_max"] > FLASH_ROW_RTOL:
                    raise RuntimeError(
                        f"flash_attention bf16 window={window}: the plain "
                        "version with one key tile per row dropped passes "
                        f"the row check ({e['tile_dropped_max']} <= "
                        f"{FLASH_ROW_RTOL}); it cannot fail a wrong kernel")
            del got, rows

            def kernel():
                return fa_ops.flash_attention(qf, kf, vf, group_size=gs,
                                              causal=True, window=window,
                                              softcap=cap)

            def plain():
                return fa_ref.attention(qf, kf, vf, group_size=gs,
                                        causal=True, window=window,
                                        softcap=cap)
            row = by_window.setdefault(str(window), {})
            row[f"{dname}_ms"] = time_cuda(kernel, 5)
            pairs = _window_pairs(s, window)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            if dname != "bfloat16":
                # the f32 kernel against its bound at the f32 peak, and
                # flex_attention compiled in f32 beside it, both by CUDA
                # events (the wrapper adds only an empty_like before its one
                # launch). A torch.profiler run may hold fewer launches than
                # were made (4-10 of 10 seen): its device time goes on the
                # row only if the profile holds every launch
                n_bytes = 4 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)
                flops = 4.0 * hd * pairs * b * h
                bound = bound_ms(n_bytes, flops, F32_FLOPS_PER_S)
                held = [(ms, n) for name, ms, n in
                        profiled_rows(kernel, F32_PROFILE_REPS)
                        if FLASH_KERNEL_RE.search(name)]
                n_held = sum(n for _, n in held)
                row.update(float32_bound_ms=bound[0],
                           float32_bound_by=bound[1],
                           float32_fraction_of_bound=bound[0]
                           / row["float32_ms"],
                           float32_tflops=flops / row["float32_ms"] / 1e9,
                           float32_profile_launches=n_held,
                           float32_device_ms=sum(ms for ms, _ in held)
                           / n_held if n_held == F32_PROFILE_REPS else None,
                           float32_plain_ms=time_cuda(plain, 3, warmup=1))
                flex, out, row["float32_flex_first_call_s"] = \
                    flex_yardstick(qt, kt, vt, cap, window)
                row["float32_flex_max_abs_err"] = float(
                    (out.transpose(1, 2) - want).abs().max())
                del out
                row["float32_flex_ms"] = time_cuda(flex, F32_REPS)
                del qt, kt, vt, want
                continue
            n_bytes = 2 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)
            bound = bound_ms(n_bytes, 4.0 * hd * pairs * b * h,
                             BF16_FLOPS_PER_S)
            i = torch.arange(s, device=dev)
            mask = i[:, None] >= i[None, :]
            if window is not None:
                mask &= (i[:, None] - i[None, :]) < window
            kr, vr = (t.repeat_interleave(gs, 1) for t in (kt, vt))
            row.update(
                device_ms=device_ms(kernel, 10, FLASH_WGMMA_KERNEL),
                call_ms=time_cuda(kernel, 10),
                plain_ms=time_cuda(plain, 3, warmup=1),
                sdpa_ms=time_cuda(lambda: F.scaled_dot_product_attention(
                    qt, kr, vr, attn_mask=mask, scale=1.0 / math.sqrt(hd)),
                    10),
                bound_ms=bound[0], bound_by=bound[1], pairs_per_head=pairs)
            row["fraction_of_bound"] = row["bound_ms"] / row["device_ms"]
            del kr, vr, mask
            flex, out, row["flex_first_call_s"] = flex_yardstick(
                qt, kt, vt, cap, window)
            row["flex_max_abs_err"] = float(
                (out.transpose(1, 2).float() - want.float()).abs().max())
            del out
            row["flex_ms"] = time_cuda(flex, 10)
            row["flex_device_ms"] = device_ms(flex, 10)
            del qt, kt, vt, want
    for w, row in by_window.items():
        row["faster_than_sdpa"] = row["call_ms"] < row["sdpa_ms"]
        log(f"[kernels] flash_attention window={w}: bf16 device "
            f"{row['device_ms']:.4f} ms, call {row['call_ms']:.4f} ms "
            f"(bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
            f"{row['fraction_of_bound']:.3f} of it; plain "
            f"{row['plain_ms']:.3f} ms; flex_attention device "
            f"{row['flex_device_ms']:.4f} ms, call {row['flex_ms']:.4f} "
            f"ms (first call {row['flex_first_call_s']:.1f} s, max abs err "
            f"vs plain {row['flex_max_abs_err']:.3g}); SDPA without softcap "
            f"{row['sdpa_ms']:.4f} ms, faster than SDPA: "
            f"{row['faster_than_sdpa']}); f32 {row['float32_ms']:.3f} ms "
            f"(events; bound {row['float32_bound_ms']:.3f} ms by "
            f"{row['float32_bound_by']}, "
            f"{row['float32_fraction_of_bound']:.3f} of it, "
            f"{row['float32_tflops']:.2f} TFLOP/s; the profile held "
            f"{row['float32_profile_launches']} of {F32_PROFILE_REPS} "
            f"launches, device {row['float32_device_ms']} ms; plain "
            f"{row['float32_plain_ms']:.3f} ms), flex_attention "
            f"f32 {row['float32_flex_ms']:.3f} ms "
            f"(events; first call "
            f"{row['float32_flex_first_call_s']:.1f} s, max abs err vs plain "
            f"{row['float32_flex_max_abs_err']:.3g}) "
            f"| B={b} S={s} H={h} KV={kvh} hd={hd}, "
            f"{row['pairs_per_head']} pairs per head | {card}")
    log(f"[kernels] flash_attention max abs err vs plain: " + ", ".join(
        f"{c} {e:.3g}" for c, e in errs.items()))
    log(f"[kernels] flash_attention bf16 row relative error (limit "
        f"{FLASH_ROW_RTOL}): " + "; ".join(
            f"window={w}: kernel max {e['max']:.3g} median {e['median']:.3g}, "
            f"plain with a key tile dropped max {e['tile_dropped_max']:.3g} "
            f"median {e['tile_dropped_median']:.3g}"
            for w, e in row_errs.items() if "float32" not in w))
    log("[kernels] flash_attention f32 row relative error: " + "; ".join(
        f"window={w.split()[1]}: max {e['max']:.3g} median "
        f"{e['median']:.3g}" for w, e in row_errs.items() if "float32" in w))

    def mean(key):
        return sum(r[key] for r in by_window.values()) / len(by_window)
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_wgmma.cu",
        float32_source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:30",
        max_abs_err=max(e for c, e in errs.items() if "bfloat16" in c),
        max_abs_err_by_case=errs, row_rel_err=row_errs,
        ms=mean("device_ms"), device_ms=mean("device_ms"),
        call_ms=mean("call_ms"), plain_ms=mean("plain_ms"),
        bound_ms=mean("bound_ms"), bound_by=by_window["None"]["bound_by"],
        fraction_of_bound=mean("bound_ms") / mean("device_ms"),
        library_ms=mean("flex_ms"), library_device_ms=mean("flex_device_ms"),
        library_note="flex_attention (torch.compile) with the tanh softcap "
                     "as score_mod and the causal and window block mask",
        sdpa_ms=mean("sdpa_ms"), float32_ms=mean("float32_ms"),
        float32_bound_ms=mean("float32_bound_ms"),
        float32_fraction_of_bound=mean("float32_bound_ms")
        / mean("float32_ms"),
        float32_tflops=mean("float32_tflops"),
        float32_plain_ms=mean("float32_plain_ms"),
        float32_library_ms=mean("float32_flex_ms"),
        by_window=by_window,
        shape=f"bf16 B={b} S={s} H={h} KV={kvh} hd={hd} softcap={cap}; "
              "ms and bounds are the mean of the local and the global "
              "layer, which the path runs equally often")


def _flash_case_check(got, want, dname: str, what: str, drop=None) -> dict:
    """Hold a flash output against the plain version's: elementwise at
    FLASH_TOL, and in bf16 per (row, head) at FLASH_ROW_RTOL, which the
    plain version with a key tile dropped (``drop()``) must fail."""
    diff = (got.float() - want.float()).abs()
    atol, rtol = FLASH_TOL[dname]
    err = dict(max_abs_err=float(diff.max()))
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise RuntimeError(f"flash_attention {what}: max abs error "
                           f"{err['max_abs_err']}, beyond {atol} + {rtol} "
                           "|want|")
    del diff
    rows = row_rel_err(got, want)
    err.update(row_max=float(rows.max()), row_median=float(rows.median()))
    if dname == "bfloat16":
        if not err["row_max"] <= FLASH_ROW_RTOL:
            raise RuntimeError(f"flash_attention {what}: row relative error "
                               f"{err['row_max']} > {FLASH_ROW_RTOL}")
        if drop is not None:
            wrong = float(row_rel_err(drop(), want).max())
            err["tile_dropped_max"] = wrong
            if not wrong > FLASH_ROW_RTOL:
                raise RuntimeError(
                    f"flash_attention {what}: the plain version with one key "
                    f"tile per row dropped passes the row check ({wrong} <= "
                    f"{FLASH_ROW_RTOL}); it cannot fail a wrong kernel")
    return err


def flash_check_hd128(dev, card) -> dict:
    """Phase 3 for the flash kernels at head_dim 128: against their plain
    version at qwen3-moe-30b-a3b's prefill shape (causal, no window, no
    softcap), bf16 (wgmma kernel) and f32 (CUDA-core kernel), each timed
    beside its bound, the plain version, ``flex_attention`` compiled and
    SDPA (the same function here: no softcap); then for correctness only,
    at a short S, yi's and starcoder2's GQA groups and a window with a
    softcap, in both dtypes."""
    import torch
    from torch.nn import functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    cfg = get_config(MOE_ARCH)
    hd = cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(1)

    def flat(t):
        return t.transpose(1, 2).reshape(-1, t.shape[1], hd).contiguous()

    def unflat(t, b, h):
        return t.reshape(b, h, -1, hd).transpose(1, 2)

    errs = {}
    b, s = LLM_BATCH, HD128_SHORT_S
    for h, kvh, window, cap in HD128_SHORT_CASES:
        base = [torch.randn((b, s, n, hd), generator=gen, device=dev)
                for n in (h, kvh, kvh)]
        for dname in ("bfloat16", "float32"):
            q, k, v = (t.to(getattr(torch, dname)) for t in base)
            qf, kf, vf = (flat(t) for t in (q, k, v))
            got = fa_ops.mha(q, k, v, causal=True, window=window,
                             softcap=cap)
            torch.cuda.synchronize()
            want = unflat(fa_ref.attention(qf, kf, vf, group_size=h // kvh,
                                           window=window, softcap=cap), b, h)
            what = (f"hd=128 {dname} S={s} H={h} KV={kvh} window={window} "
                    f"softcap={cap}")
            errs[what] = _flash_case_check(
                got, want, dname, what, lambda: unflat(plain_dropping_a_tile(
                    qf, kf, vf, h // kvh, window, cap), b, h))
        del base, q, k, v, qf, kf, vf, got, want

    b, s = LLM_BATCH, LLM_PROMPT
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    gs = h // kvh
    base = [torch.randn((b, s, n, hd), generator=gen, device=dev)
            for n in (h, kvh, kvh)]
    pairs = _window_pairs(s, None)
    flops = 4.0 * hd * pairs * b * h
    by_dtype = {}
    for dname in ("bfloat16", "float32"):
        q, k, v = (t.to(getattr(torch, dname)) for t in base)
        qf, kf, vf = (flat(t) for t in (q, k, v))
        got = fa_ops.mha(q, k, v, causal=True)
        torch.cuda.synchronize()
        if got.dtype != q.dtype or got.shape != q.shape:
            raise RuntimeError("flash_attention hd=128: bad output")
        want = unflat(fa_ref.attention(qf, kf, vf, group_size=gs), b, h)
        what = f"hd=128 {dname} B={b} S={s} H={h} KV={kvh}"
        errs[what] = _flash_case_check(
            got, want, dname, what, lambda: unflat(plain_dropping_a_tile(
                qf, kf, vf, gs, None, None), b, h))
        del got

        def kernel():
            return fa_ops.flash_attention(qf, kf, vf, group_size=gs)

        def plain():
            return fa_ref.attention(qf, kf, vf, group_size=gs)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        n_bytes = q.element_size() * (2 * b * s * h * hd + 2 * b * s * kvh
                                      * hd)
        sd = sdpa()
        row = dict(sdpa_max_abs_err=float(
            (sd.transpose(1, 2).float() - want.float()).abs().max()))
        del sd
        if dname == "bfloat16":
            bound = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
            row.update(device_ms=device_ms(kernel, 10, FLASH_WGMMA_KERNEL),
                       call_ms=time_cuda(kernel, 10),
                       plain_ms=time_cuda(plain, 3, warmup=1),
                       sdpa_ms=time_cuda(sdpa, 10),
                       sdpa_device_ms=device_ms(sdpa, 10),
                       bound_ms=bound[0], bound_by=bound[1])
            row["fraction_of_bound"] = row["bound_ms"] / row["device_ms"]
            flex, out, row["flex_first_call_s"] = flex_yardstick(
                qt, kt, vt, None, None)
            row["flex_max_abs_err"] = float(
                (out.transpose(1, 2).float() - want.float()).abs().max())
            del out
            row["flex_ms"] = time_cuda(flex, 10)
            row["flex_device_ms"] = device_ms(flex, 10)
        else:
            # event-timed, as the f32 row at hd 256 (a profile may hold
            # fewer launches than were made)
            bound = bound_ms(n_bytes, flops, F32_FLOPS_PER_S)
            held = [(ms, n) for name, ms, n in
                    profiled_rows(kernel, F32_PROFILE_REPS)
                    if FLASH_KERNEL_RE.search(name)]
            n_held = sum(n for _, n in held)
            row.update(ms=time_cuda(kernel, F32_REPS),
                       plain_ms=time_cuda(plain, 3, warmup=1),
                       sdpa_ms=time_cuda(sdpa, F32_REPS),
                       bound_ms=bound[0], bound_by=bound[1],
                       profile_launches=n_held,
                       device_ms=sum(ms for ms, _ in held) / n_held
                       if n_held == F32_PROFILE_REPS else None)
            row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
            row["tflops"] = flops / row["ms"] / 1e9
        by_dtype[dname] = row
        del q, k, v, qf, kf, vf, qt, kt, vt, want
    del base
    bf, f32 = by_dtype["bfloat16"], by_dtype["float32"]
    log(f"[kernels] flash_attention hd=128 ({MOE_ARCH} prefill, B={b} S={s} "
        f"H={h} KV={kvh}, causal, {pairs} pairs per head): bf16 device "
        f"{bf['device_ms']:.4f} ms, call {bf['call_ms']:.4f} ms (bound "
        f"{bf['bound_ms']:.4f} ms by {bf['bound_by']}, "
        f"{bf['fraction_of_bound']:.3f} of it; plain {bf['plain_ms']:.3f} "
        f"ms; SDPA device {bf['sdpa_device_ms']:.4f} ms, call "
        f"{bf['sdpa_ms']:.4f} ms; flex_attention device "
        f"{bf['flex_device_ms']:.4f} ms, call {bf['flex_ms']:.4f} ms, first "
        f"call {bf['flex_first_call_s']:.1f} s); f32 {f32['ms']:.3f} ms "
        f"(events; bound {f32['bound_ms']:.3f} ms by {f32['bound_by']}, "
        f"{f32['fraction_of_bound']:.3f} of it, {f32['tflops']:.2f} TFLOP/s; "
        f"the profile held {f32['profile_launches']} of {F32_PROFILE_REPS} "
        f"launches, device {f32['device_ms']} ms; plain "
        f"{f32['plain_ms']:.3f} ms; SDPA {f32['sdpa_ms']:.3f} ms) | {card}")
    log("[kernels] flash_attention hd=128 errors against the plain version: "
        + "; ".join(f"{c}: max abs {e['max_abs_err']:.3g}, row max "
                    f"{e['row_max']:.3g}"
                    + (f", tile dropped {e['tile_dropped_max']:.3g}"
                       if "tile_dropped_max" in e else "")
                    for c, e in errs.items()))
    return dict(
        shape=f"B={b} S={s} H={h} KV={kvh} hd={hd}, causal, no window, no "
              f"softcap ({MOE_ARCH} prefill)",
        max_abs_err=max(e["max_abs_err"] for c, e in errs.items()
                        if "bfloat16" in c),
        errors=errs, ms=bf["device_ms"], device_ms=bf["device_ms"],
        call_ms=bf["call_ms"], plain_ms=bf["plain_ms"],
        bound_ms=bf["bound_ms"], bound_by=bf["bound_by"],
        fraction_of_bound=bf["fraction_of_bound"],
        library_ms=bf["sdpa_ms"], library_device_ms=bf["sdpa_device_ms"],
        library_note="scaled_dot_product_attention(is_causal=True, "
                     "enable_gqa=True): the same function (no softcap)",
        flex_ms=bf["flex_ms"], flex_device_ms=bf["flex_device_ms"],
        float32_ms=f32["ms"], float32_device_ms=f32["device_ms"],
        float32_bound_ms=f32["bound_ms"],
        float32_fraction_of_bound=f32["fraction_of_bound"],
        float32_tflops=f32["tflops"], float32_plain_ms=f32["plain_ms"],
        float32_library_ms=f32["sdpa_ms"], by_dtype=by_dtype)


def llm_whole_path(dev):
    """Phase 7: gemma2-9b at full width, 2 layers, f32, card against CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pad_cache_to
    from repro_torch.models import registry
    from repro_torch.models.transformer import Transformer

    cfg = get_config(LLM_ARCH).replace(n_layers=2, dtype="float32")
    api = registry.get_model(cfg)
    model_gpu = api.init(seed=0, device=dev)
    model_cpu = Transformer(cfg, device="meta")
    model_cpu.load_state_dict({k: t.cpu() for k, t in
                               model_gpu.state_dict().items()}, assign=True)
    b, n = LLM_BATCH, WHOLE_LLM_PROMPT
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(b, n)).astype(np.int32))

    def run(model, device):
        t0 = time.perf_counter()
        logits, cache = api.prefill(model, {"tokens": prompts.to(device)})
        cache = pad_cache_to(cache, api.empty_cache(
            b, n + WHOLE_LLM_DECODE + 1, device=device))
        pre = logits.cpu()
        del logits
        toks, dec = [pre[:, -1].argmax(-1)], []
        for step in range(WHOLE_LLM_DECODE):
            logits, cache = api.decode(
                model, cache, {"tokens": toks[-1][:, None].to(device)},
                n + step)
            dec.append(logits.cpu())
            toks.append(dec[-1][:, -1].argmax(-1))
        return pre, torch.cat(dec, 1), torch.stack(toks, 1), \
            time.perf_counter() - t0

    g_pre, g_dec, g_tok, t_gpu = run(model_gpu, dev)
    c_pre, c_dec, c_tok, t_cpu = run(model_cpu, torch.device("cpu"))
    if g_pre.shape != (b, n, cfg.padded_vocab) or \
            not torch.isfinite(g_pre).all() or not torch.isfinite(g_dec).all():
        raise RuntimeError("llm whole path: bad logits on the card")
    if not torch.equal(g_tok, c_tok):
        raise RuntimeError(f"llm whole path: tokens differ, card "
                           f"{g_tok.tolist()} CPU {c_tok.tolist()}")
    pre_err = float((g_pre - c_pre).abs().max())
    dec_err = float((g_dec - c_dec).abs().max())
    if not max(pre_err, dec_err) <= LLM_ATOL:
        raise RuntimeError(f"llm whole path: logits differ, prefill "
                           f"{pre_err}, decode {dec_err} > {LLM_ATOL}")
    log(f"[llm_whole_path] {LLM_ARCH} width {cfg.d_model}, 2 layers, f32, "
        f"{b} x {n} tokens + {WHOLE_LLM_DECODE} decode steps: tokens equal "
        f"{g_tok.tolist()}; max abs err prefill logits {pre_err:.3g}, decode "
        f"logits {dec_err:.3g} (atol {LLM_ATOL}); card {t_gpu:.3f} s (first "
        f"call), CPU {t_cpu:.2f} s")


def llm_serve(dev, card, reset_counts, read_counts, by_phase):
    """Phase 8: gemma2-9b served at full width in bf16; then one prefill's
    time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pad_cache_to, serve
    from repro_torch.models import registry

    cfg = get_config(LLM_ARCH)
    api = registry.get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    param_gb = sum(p.numel() * p.element_size()
                   for p in params.parameters()) / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve(LLM_ARCH, False, LLM_BATCH, LLM_PROMPT, LLM_GEN,
                params=params, device=dev)
    torch.cuda.synchronize()
    read_counts("llm_serve")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = by_phase["flash_attention"]["llm_serve"]
    if launches != cfg.n_layers:
        raise RuntimeError(
            f"llm serve: flash attention launched {launches} times, expected "
            f"{cfg.n_layers}: once per layer in the one prefill call and "
            "never in decode")
    gen = out["generated"]
    if gen.shape != (LLM_BATCH, LLM_GEN) or \
            not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        raise RuntimeError(f"llm serve: bad tokens {gen.shape}")
    log(f"[llm_serve] {LLM_ARCH} full width ({n_params / 1e9:.3f} B params, "
        f"{param_gb:.2f} GB bf16, drawn on the card in {t_init:.2f} s), "
        f"{LLM_BATCH} requests x {LLM_PROMPT} prompt tokens + {LLM_GEN} "
        f"generated: prefill {out['prefill_s']:.4f} s, decode "
        f"{out['decode_s_per_token'] * 1e3:.3f} ms/token, "
        f"{out['tokens_per_s']:.2f} tokens/s, peak memory {peak_gb:.2f} GB "
        f"| flash launches {launches} ({cfg.n_layers} layers, 1 prefill, "
        f"0 in decode) | {card}")

    # where one prefill's and one warm decode step's time goes
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(LLM_BATCH, LLM_PROMPT)).astype(
            np.int32)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        logits, cache = api.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
    rows = _log_kernels("prefill", prof, time.perf_counter() - t0)
    n_wgmma = sum(n for k, _, n in rows if FLASH_WGMMA_KERNEL in k)
    n_flash = sum(n for k, _, n in rows if FLASH_KERNEL_RE.search(k))
    if not n_wgmma == n_flash == cfg.n_layers:
        raise RuntimeError(
            f"llm breakdown: the profiled prefill shows {n_wgmma} launches "
            f"of {FLASH_WGMMA_KERNEL} and {n_flash} of any flash kernel, "
            f"expected {cfg.n_layers} of the wgmma kernel")
    tok = logits[:, -1].argmax(-1)[:, None]
    del logits
    cache = pad_cache_to(cache, api.empty_cache(
        LLM_BATCH, LLM_PROMPT + LLM_GEN, device=dev))
    step_s = []
    for step in range(LLM_GEN - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.decode(params, cache, {"tokens": tok},
                                   LLM_PROMPT + step)
        tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    log(f"[llm_breakdown] decode steps, host clock, ms: first "
        f"{step_s[0] * 1e3:.3f}, median of the rest "
        f"{float(np.median(step_s[1:])) * 1e3:.3f}, min "
        f"{min(step_s) * 1e3:.3f}")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        api.decode(params, cache, {"tokens": tok}, LLM_PROMPT + LLM_GEN - 1)
        torch.cuda.synchronize()
    _log_kernels("decode step", prof, time.perf_counter() - t0)


def _route_flips(moe_gpu, moe_cpu, x_gpu, x_cpu, cfg_moe):
    """Routing decisions of one MoE call on the card against the CPU's on
    the same input (``x_cpu`` is ``x_gpu`` copied): (decisions, differing,
    the largest tie margin among the differing tokens, the tokens' flat
    indices). A decision is one of a token's top-k experts; a token's
    margin is its k-th minus its (k+1)-th router probability on the CPU."""
    import torch

    from repro_torch.models import moe as moe_lib
    k = cfg_moe.top_k
    _, idx_g, _ = moe_lib.route(moe_gpu, x_gpu, cfg_moe)
    _, idx_c, _ = moe_lib.route(moe_cpu, x_cpu, cfg_moe)
    idx_g = idx_g.cpu().reshape(-1, k).sort(-1).values
    idx_c = idx_c.reshape(-1, k).sort(-1).values
    # decisions the card made that the CPU did not, per token
    differ = (~(idx_g[:, :, None] == idx_c[:, None, :]).any(-1)).sum(-1)
    tokens = differ.nonzero().flatten()
    margin = 0.0
    if len(tokens) and k < cfg_moe.n_experts:
        probs = torch.softmax(x_cpu.float().reshape(-1, x_cpu.shape[-1])
                              @ moe_cpu.router.w.float(), -1)
        top = probs[tokens].sort(-1, descending=True).values
        margin = float((top[:, k - 1] - top[:, k]).max())
    return idx_c.numel(), int(differ.sum()), margin, tokens


def decoders_whole_path(dev, card, reset_counts, read_counts, by_phase):
    """Phase 19 (a): each head_dim-128 decoder of DECODER_ARCHS at full
    width, cut to 2 layers, in f32, initialised once on the card and copied
    to the CPU; 2 requests of 128 tokens (pixtral: after its 1,024 patch
    embeddings, random from a seed) prefilled and decoded 4 steps on both:
    tokens equal, logits within LLM_ATOL, the f32 flash kernel launched once
    per layer in the card's prefill, and per MoE layer the routing decisions
    that differ between the card and the CPU on the card's inputs counted.
    A flip within ROUTE_TIE of a tie switches the check to each MoE layer
    on the card's inputs, the flipped tokens left out; any other flip
    fails."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pad_cache_to
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import registry
    from repro_torch.models.transformer import Transformer

    for arch in DECODER_ARCHS:
        t_arch = time.perf_counter()
        cfg = get_config(arch).replace(n_layers=2, dtype="float32")
        api = registry.get_model(cfg)
        model_gpu = api.init(seed=0, device=dev)
        model_cpu = Transformer(cfg, device="meta")
        model_cpu.load_state_dict({k: t.cpu() for k, t in
                                   model_gpu.state_dict().items()},
                                  assign=True)
        b, n = LLM_BATCH, WHOLE_LLM_PROMPT
        n_prefix = cfg.n_frontend_tokens
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(b, n)).astype(np.int32))}
        if n_prefix:
            batch["prefix_embeds"] = torch.from_numpy(rng.normal(
                size=(b, n_prefix, cfg.d_model)).astype(np.float32))

        def run(model, device):
            moes = [m for m in model.modules()
                    if isinstance(m, moe_lib.MoE)]
            inputs = [[] for _ in moes]
            hooks = [m.register_forward_pre_hook(
                lambda mod, args, i=i: inputs[i].append(args[0].detach()))
                for i, m in enumerate(moes)]
            t0 = time.perf_counter()
            try:
                logits, cache = api.prefill(
                    model, {k: t.to(device) for k, t in batch.items()})
                cache = pad_cache_to(cache, api.empty_cache(
                    b, n_prefix + n + WHOLE_LLM_DECODE + 1, device=device))
                pre = logits.cpu()
                del logits
                toks, dec = [pre[:, -1].argmax(-1)], []
                for step in range(WHOLE_LLM_DECODE):
                    logits, cache = api.decode(
                        model, cache,
                        {"tokens": toks[-1][:, None].to(device)},
                        n_prefix + n + step)
                    dec.append(logits.cpu())
                    toks.append(dec[-1][:, -1].argmax(-1))
            finally:
                for hk in hooks:
                    hk.remove()
            return (pre, torch.cat(dec, 1), torch.stack(toks, 1),
                    time.perf_counter() - t0, moes, inputs)

        reset_counts()
        g_pre, g_dec, g_tok, t_gpu, g_moes, g_in = run(model_gpu, dev)
        torch.cuda.synchronize()
        read_counts(f"decoders_{arch}")
        c_pre, c_dec, c_tok, t_cpu, c_moes, _ = run(
            model_cpu, torch.device("cpu"))
        launches = by_phase["flash_attention"][f"decoders_{arch}"]
        if launches != cfg.n_layers:
            raise RuntimeError(
                f"decoders {arch}: flash attention launched {launches} times "
                f"on the card, expected {cfg.n_layers} (one prefill of "
                f"{cfg.n_layers} layers)")
        if g_pre.shape != (b, n_prefix + n, cfg.padded_vocab) or \
                not torch.isfinite(g_pre).all() or \
                not torch.isfinite(g_dec).all():
            raise RuntimeError(f"decoders {arch}: bad logits on the card")
        routing = []
        flipped = False
        for i, (mg, mc) in enumerate(zip(g_moes, c_moes)):
            calls = [_route_flips(mg, mc, xg, xg.cpu(), cfg.moe)
                     for xg in g_in[i]]
            dec_n = sum(c[0] for c in calls)
            diff_n = sum(c[1] for c in calls)
            margin = max(c[2] for c in calls)
            routing.append(f"MoE layer {i}: {diff_n} of {dec_n} decisions "
                           f"differ" + (f" (largest tie margin {margin:.3g})"
                                        if diff_n else ""))
            if diff_n:
                flipped = True
                if margin > ROUTE_TIE:
                    raise RuntimeError(
                        f"decoders {arch}: MoE layer {i}: {diff_n} routing "
                        f"decisions differ between the card and the CPU, "
                        f"one {margin:.3g} from a tie (> {ROUTE_TIE})")
        if flipped:
            # a near-tie flipped: hold each MoE layer by its card inputs,
            # the tokens routed differently left out, not by the end logits
            for i, (mg, mc) in enumerate(zip(g_moes, c_moes)):
                for xg in g_in[i]:
                    with torch.no_grad():
                        yg, _ = mg(xg)
                        yc, _ = mc(xg.cpu())
                    *_, tokens = _route_flips(mg, mc, xg, xg.cpu(), cfg.moe)
                    keep = torch.ones(yc.shape[0] * yc.shape[1],
                                      dtype=torch.bool)
                    keep[tokens] = False
                    err = float((yg.cpu().reshape(-1, yc.shape[-1])[keep]
                                 - yc.reshape(-1, yc.shape[-1])[keep])
                                .abs().max())
                    if not err <= LLM_ATOL:
                        raise RuntimeError(
                            f"decoders {arch}: MoE layer {i} on the card's "
                            f"inputs differs from the CPU by {err} > "
                            f"{LLM_ATOL} on the tokens routed alike")
            log(f"[decoders] {arch}: routing flipped at a near-tie; each "
                f"MoE layer held by its inputs within {LLM_ATOL}; "
                + "; ".join(routing) + f" | {card}")
        else:
            if not torch.equal(g_tok, c_tok):
                raise RuntimeError(f"decoders {arch}: tokens differ, card "
                                   f"{g_tok.tolist()} CPU {c_tok.tolist()}")
            pre_err = float((g_pre - c_pre).abs().max())
            dec_err = float((g_dec - c_dec).abs().max())
            if not max(pre_err, dec_err) <= LLM_ATOL:
                raise RuntimeError(
                    f"decoders {arch}: logits differ, prefill {pre_err}, "
                    f"decode {dec_err} > {LLM_ATOL}")
            log(f"[decoders] {arch} width {cfg.d_model}, 2 layers, f32, {b} "
                f"x {n} tokens" + (f" after {n_prefix} patch embeddings"
                                   if n_prefix else "")
                + f" + {WHOLE_LLM_DECODE} decode steps: tokens equal "
                f"{g_tok.tolist()}; max abs err prefill logits "
                f"{pre_err:.3g}, decode logits {dec_err:.3g} (atol "
                f"{LLM_ATOL}); f32 flash launches {launches}; "
                + ("; ".join(routing) if routing else "no MoE layer")
                + f"; card {t_gpu:.3f} s (first call), CPU {t_cpu:.2f} s; "
                f"{time.perf_counter() - t_arch:.1f} s in all | {card}")
        del model_gpu, model_cpu, g_in, g_moes, c_moes
        gc.collect()
        torch.cuda.empty_cache()


def _marked_ms(prof, marks) -> dict:
    """Device milliseconds of the kernels launched under each
    ``record_function`` mark of a ``torch.profiler`` run."""
    import torch
    out = {m: 0.0 for m in marks}
    for e in prof.events():
        if e.name in out and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name] += e.device_time_total / 1e3
    return out


def _log_moe_split(what: str, prof, rows):
    """One line of where a profiled MoE step's device time went: attention
    (the flash kernel), the expert GEMMs, dispatch and combine (routing
    included), the shared experts, and the rest."""
    marked = _marked_ms(prof, MOE_MARKS)
    total = sum(ms for _, ms, _ in rows)
    flash = sum(ms for k, ms, _ in rows if FLASH_KERNEL_RE.search(k))
    moves = marked["moe.route"] + marked["moe.dispatch"] + \
        marked["moe.combine"]
    rest = total - flash - marked["moe.experts"] - moves - \
        marked["moe.shared"]
    log(f"[moe_breakdown] one {what}: device {total:.3f} ms = attention "
        f"(flash) {flash:.3f} + expert GEMMs {marked['moe.experts']:.3f} + "
        f"dispatch and combine {moves:.3f} (route "
        f"{marked['moe.route']:.3f}, dispatch {marked['moe.dispatch']:.3f}, "
        f"combine {marked['moe.combine']:.3f}) + shared experts "
        f"{marked['moe.shared']:.3f} + the rest {rest:.3f} (projections, "
        "norms, rope, logits, copies)")
    return marked


def moe_serve(dev, card, reset_counts, read_counts, by_phase):
    """Phase 19 (b): qwen3-moe-30b-a3b served at full width and depth in
    bf16 (``serve``, as phase 8); then one prefill and one decode step
    profiled by kernel and by the MoE layer's parts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pad_cache_to, serve
    from repro_torch.models import registry

    cfg = get_config(MOE_ARCH)
    api = registry.get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in params.parameters())
    param_gb = sum(p.numel() * p.element_size()
                   for p in params.parameters()) / 1e9
    expert_gb = sum(p.numel() * p.element_size()
                    for name, p in params.named_parameters()
                    if ".moe.w_" in name) / 1e9
    # a decode step reads every weight but the embedding table's unused rows
    read_gb = param_gb - params.embed.table.numel() * \
        params.embed.table.element_size() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve(MOE_ARCH, False, LLM_BATCH, LLM_PROMPT, LLM_GEN,
                params=params, device=dev)
    torch.cuda.synchronize()
    read_counts("moe_serve")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = by_phase["flash_attention"]["moe_serve"]
    if launches != cfg.n_layers:
        raise RuntimeError(
            f"moe serve: flash attention launched {launches} times, expected "
            f"{cfg.n_layers}: once per layer in the one prefill call and "
            "never in decode")
    gen = out["generated"]
    if gen.shape != (LLM_BATCH, LLM_GEN) or \
            not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        raise RuntimeError(f"moe serve: bad tokens {gen.shape}")
    decode_floor_ms = read_gb / HBM_BYTES_PER_S * 1e12
    log(f"[moe_serve] {MOE_ARCH} full width and depth ({n_params / 1e9:.3f} "
        f"B params, {param_gb:.2f} GB bf16 of which experts "
        f"{expert_gb:.2f} GB, drawn on the card in {t_init:.2f} s, peak "
        f"{init_peak:.2f} GB while drawing), {LLM_BATCH} requests x "
        f"{LLM_PROMPT} prompt tokens + {LLM_GEN} generated: prefill "
        f"{out['prefill_s']:.4f} s, decode "
        f"{out['decode_s_per_token'] * 1e3:.3f} ms/token, "
        f"{out['tokens_per_s']:.2f} tokens/s, peak memory {peak_gb:.2f} GB "
        f"| flash launches {launches} ({cfg.n_layers} layers, 1 prefill, 0 "
        f"in decode) | a decode step reads every expert (capacity 1 a row "
        f"at S = 1): {read_gb:.2f} GB of weights, at least "
        f"{decode_floor_ms:.2f} ms at 3.35 TB/s | {card}")

    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(LLM_BATCH, LLM_PROMPT)).astype(
            np.int32)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        logits, cache = api.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = device_rows(prof.key_averages())
    n_wgmma = sum(n for k, _, n in rows if FLASH_WGMMA_KERNEL in k)
    n_flash = sum(n for k, _, n in rows if FLASH_KERNEL_RE.search(k))
    if not n_wgmma == n_flash == cfg.n_layers:
        raise RuntimeError(
            f"moe breakdown: the profiled prefill shows {n_wgmma} launches "
            f"of {FLASH_WGMMA_KERNEL} and {n_flash} of any flash kernel, "
            f"expected {cfg.n_layers} of the wgmma kernel")
    _log_kernels("prefill", prof, wall)
    _log_moe_split("prefill", prof, rows)
    tok = logits[:, -1].argmax(-1)[:, None]
    del logits
    cache = pad_cache_to(cache, api.empty_cache(
        LLM_BATCH, LLM_PROMPT + LLM_GEN, device=dev))
    for step in range(2):        # warm
        logits, cache = api.decode(params, cache, {"tokens": tok},
                                   LLM_PROMPT + step)
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        api.decode(params, cache, {"tokens": tok}, LLM_PROMPT + 2)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = _log_kernels("decode step", prof, wall)
    if any(FLASH_KERNEL_RE.search(k) for k, _, _ in rows):
        raise RuntimeError("moe breakdown: a decode step launched flash "
                           "attention")
    marked = _log_moe_split("decode step", prof, rows)
    log(f"[moe_breakdown] decode: the expert GEMMs read {expert_gb:.2f} GB "
        f"a step, at least {expert_gb / HBM_BYTES_PER_S * 1e12:.2f} ms at "
        f"3.35 TB/s; measured {marked['moe.experts']:.3f} ms of device "
        f"time, {expert_gb / max(marked['moe.experts'], 1e-9):.3f} TB/s "
        f"| {card}")


def _log_kernels(what: str, prof, wall_s: float, top: int = 8):
    """Device time by kernel from a ``torch.profiler`` run; returns
    ``[(kernel name, ms, launches)]``, longest first."""
    rows = device_rows(prof.key_averages())
    total = sum(ms for _, ms, _ in rows)
    flash = sum(ms for k, ms, _ in rows if FLASH_KERNEL_RE.search(k))
    gemm = sum(ms for k, ms, _ in rows
               if re.search(r"gemm|gemv|nvjet|cutlass|xmma", k, re.I))
    log(f"[llm_breakdown] one {what} (profiled, wall {wall_s * 1e3:.3f} "
        f"ms): device kernel time {total:.3f} ms in "
        f"{sum(n for *_, n in rows)} launches, of which flash attention "
        f"{flash:.3f} ms, GEMMs {gemm:.3f} ms, other "
        f"{total - flash - gemm:.3f} ms")
    for k, ms, n in rows[:top]:
        log(f"[llm_breakdown]   {ms:10.3f} ms  x{n:<5d} {k[:110]}")
    return rows


def _full_graph_batch(sample, dev):
    """A training sample's whole graph, normalized, as one batch on ``dev``
    (the full-graph loss of phase 16)."""
    import torch
    s, ni, no = sample
    g = s.graph
    arrays = {"node_feats": ni.encode(s.node_feats).astype(np.float32),
              "edge_feats": g.edge_feats, "senders": g.senders,
              "receivers": g.receivers,
              "targets": no.encode(s.targets).astype(np.float32),
              "loss_mask": np.ones(g.n_nodes, np.float32)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def _dmgn_shard(sample, world: int, rank: int, dev):
    """Rank ``rank``'s baseline shard of a sample's whole graph, labelled by
    the trainer's partitioner into ``world`` parts."""
    from repro_torch.core import distributed_mgn as dmgn
    from repro_torch.core import partitioning
    s, ni, no = sample
    g = s.graph
    labels = partitioning.partition(g.senders, g.receivers, g.n_nodes, world,
                                    positions=g.positions)
    shards = dmgn.prepare_dmgn_shards(
        g.senders, g.receivers, labels, world,
        ni.encode(s.node_feats).astype(np.float32), g.edge_feats,
        no.encode(s.targets).astype(np.float32))
    return dmgn.device_put_shards(shards, rank, dev), shards["meta"]


def _leaf_grads(model) -> list:
    return [p.grad.detach().cpu() for _, p in model.leaves()]


def _grad_err(got, want) -> tuple:
    """The worst leaf's max abs error over its own largest element, and
    its index."""
    worst = (0.0, -1)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max())
        worst = max(worst, (float((g - w).abs().max()) / max(scale, 1e-30),
                            i))
    return worst


def _seg_counts():
    from repro_torch.kernels.segment_agg import ops as seg_ops
    return {"segment_sum": seg_ops.segment_sum_prepared.launches,
            "segment_sum_backward": seg_ops.segment_sum_backward.launches,
            "gather_rows_backward": seg_ops.gather_rows.launches}


def _reset_seg_counts():
    from repro_torch.kernels.segment_agg import ops as seg_ops
    for fn in (seg_ops.segment_sum_prepared, seg_ops.segment_sum_backward,
               seg_ops.gather_rows):
        fn.launches = 0


def _dist_rank(rank: int, world: int, store: str, out_dir: str):
    """Phase 16 (b) and (c) in one of the ranks sharing the card (a spawned
    process): writes ``rank<r>.pt``, or its traceback to
    ``error_rank<r>.txt`` and fails."""
    import traceback
    try:
        _dist_rank_work(rank, world, store, Path(out_dir))
    except BaseException:
        (Path(out_dir) / f"error_rank{rank}.txt").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _dist_rank_work(rank: int, world: int, store: str, out: Path):
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import GNNConfig
    from repro_torch.core import distributed_mgn as dmgn
    from repro_torch.core.gradient_aggregation import all_reduce
    from repro_torch.launch.sharding import (init_process_group,
                                             shard_count_for, shard_range)
    from repro_torch.launch.train import (make_gnn_step_fn,
                                          prepare_gnn_batch, train_gnn)
    from repro_torch.optim.adam import adam_init
    from repro_torch.telemetry import Telemetry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    group = init_process_group(rank, world, f"file://{store}",
                               backend="gloo", device=dev,
                               timeout=DIST_GROUP_TIMEOUT)
    res = {}
    try:
        # (b) both schemes at phase 9's size ---------------------------------
        cfg, sample, ps, opt_cfg = whole_train_setup()
        n_parts = ps.stacked["senders"].shape[0]
        n_shards = shard_count_for(n_parts, world)
        model = whole_train_model(cfg).to(dev)
        step = make_gnn_step_fn(cfg, opt_cfg, group=group)
        opt = adam_init([p for _, p in model.leaves()])
        batch = prepare_gnn_batch(ps, dev, rank, n_shards)
        _reset_seg_counts()
        c0 = all_reduce.collectives
        opt, loss, gnorm, skipped = step(model, opt, *batch)
        torch.cuda.synchronize()
        res["ddp"] = dict(
            loss=float(loss), gnorm=float(gnorm), skipped=bool(skipped),
            grads=_leaf_grads(model),
            params=[p.detach().cpu() for _, p in model.leaves()],
            launches=_seg_counts(), parts=len(shard_range(n_parts, rank,
                                                          n_shards)),
            collectives=all_reduce.collectives - c0)
        del model, opt, batch, step
        model = whole_train_model(cfg).to(dev)
        shard, meta = _dmgn_shard(sample, world, rank, dev)
        _reset_seg_counts()
        c0 = all_reduce.collectives
        loss = dmgn.make_dmgn_grad_fn(group, ps.denom)(model, shard)
        torch.cuda.synchronize()
        res["dmgn"] = dict(loss=float(loss), grads=_leaf_grads(model),
                           launches=_seg_counts(), meta=meta,
                           collectives=all_reduce.collectives - c0)
        del model, shard

        # (c) train_gnn at phase 10's full width -----------------------------
        gc.collect()
        torch.cuda.empty_cache()
        cfg = GNNConfig().replace(levels=TRAIN_LEVELS,
                                  n_partitions=TRAIN_PARTITIONS)
        tel = Telemetry(enabled=True)
        torch.cuda.reset_peak_memory_stats()
        _reset_seg_counts()
        c0, b0, s0 = all_reduce.collectives, all_reduce.bytes, \
            all_reduce.seconds
        t0 = time.perf_counter()
        _, losses, _ = train_gnn(cfg, DIST_STEPS, TRAIN_SAMPLES,
                                 log_every=1, telemetry=tel,
                                 opt_total_steps=TRAIN_STEPS, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = tel.tracer.records()
        step_span = {r.attrs["it"]: r.duration_s for r in spans
                     if r.name == "step"}
        prep_span = {int(r.trace_id.split("-")[1]): r.duration_s
                     for r in spans if r.name == "prepare"}
        res["train"] = dict(
            losses=losses, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            step_s=[step_span[i] - prep_span[i] for i in range(DIST_STEPS)],
            data_s=tel.metrics.histogram("train_stage_data_seconds").sum,
            wall_s=wall, launches=_seg_counts(),
            collectives=all_reduce.collectives - c0,
            bytes=all_reduce.bytes - b0,
            all_reduce_s=all_reduce.seconds - s0)
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn_ranks(world: int, out_dir: Path, store: str):
    """Start ``world`` ranks (``spawn``), wait at most DIST_JOIN_TIMEOUT for
    them, and raise, with their tracebacks, if one failed or had to be
    killed; none is left running."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank,
                         args=(r, world, store, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_JOIN_TIMEOUT
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(30)
    codes = [p.exitcode for p in procs]
    if alive or any(c != 0 for c in codes):
        detail = "\n".join(f.read_text() for f in
                           sorted(out_dir.glob("error_rank*.txt")))
        raise RuntimeError(f"phase 16: ranks exited {codes}, {len(alive)} "
                           f"killed at the {DIST_JOIN_TIMEOUT} s limit\n"
                           f"{detail}")
    import torch
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(world)]


def dist_phase(dev, card, reset_counts, read_counts, by_phase, *, whole,
               train_losses):
    """Phase 16: multi-process training. (a) world size 1 through NCCL in
    this process: phase 9's step through ``make_gnn_step_fn(group=...)``
    bit-equal to phase 9's card step, and the baseline at W = 1 against the
    full-graph gradient; (b) two ranks sharing the card through ``gloo``,
    both schemes at phase 9's size against the full-graph gradient, with
    their collectives and per-rank launches; (c) ``train_gnn`` of phase
    10's config on the two ranks for DIST_STEPS steps, the losses against
    phase 10's."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import GNNConfig
    from repro_torch.core import distributed_mgn as dmgn
    from repro_torch.core.gradient_aggregation import all_reduce
    from repro_torch.launch.sharding import init_process_group
    from repro_torch.launch.train import make_gnn_step_fn, prepare_gnn_batch
    from repro_torch.models.meshgraphnet import loss_fn
    from repro_torch.optim.adam import adam_init

    t_phase = time.perf_counter()
    cfg, sample, ps, opt_cfg = whole_train_setup()
    n_layers, n_parts = cfg.n_mp_layers, ps.stacked["senders"].shape[0]
    # the full-graph gradient of phase 9's sample on the card
    model = whole_train_model(cfg).to(dev)
    full = loss_fn(model, _full_graph_batch(sample, dev), ps.denom)
    full.backward()
    full_loss, full_grads = full.item(), _leaf_grads(model)
    del model, full

    def hold(what, loss, grads):
        rel = abs(loss - full_loss) / abs(full_loss)
        err, i = _grad_err(grads, full_grads)
        if rel > TRAIN_LOSS_RTOL or err > TRAIN_GRAD_RTOL:
            raise RuntimeError(
                f"phase 16 {what}: loss {loss} against the full graph's "
                f"{full_loss} (relative {rel}), gradient leaf "
                f"{whole['names'][i]} off by {err} of its largest element")
        return f"loss relative {rel:.3g}, worst leaf {err:.3g}"

    # (a) world size 1 through NCCL --------------------------------------------
    store = ROOT / "build" / f"chip_smoke_dist_{os.getpid()}"
    store.unlink(missing_ok=True)
    try:
        group = init_process_group(0, 1, f"file://{store}", backend="nccl",
                                   device=dev, timeout=DIST_GROUP_TIMEOUT)
        try:
            model = whole_train_model(cfg).to(dev)
            step = make_gnn_step_fn(cfg, opt_cfg, group=group)
            opt = adam_init([p for _, p in model.leaves()])
            batch = prepare_gnn_batch(ps, dev, 0, 1)
            reset_counts()
            c0 = all_reduce.collectives
            opt, loss, gnorm, skipped = step(model, opt, *batch)
            torch.cuda.synchronize()
            read_counts("dist_w1_ddp")
            n_coll = all_reduce.collectives - c0
            grads = _leaf_grads(model)
            params = [p.detach().cpu() for _, p in model.leaves()]
            same = (float(loss) == whole["loss"]
                    and float(gnorm) == whole["gnorm"]
                    and not skipped and not whole["skipped"]
                    and all(torch.equal(a, b)
                            for a, b in zip(grads, whole["grads"]))
                    and all(torch.equal(a, b)
                            for a, b in zip(params, whole["params"])))
            if not same or n_coll != 1:
                raise RuntimeError(
                    f"phase 16 (a): the NCCL world-1 step is not bit-equal "
                    f"to phase 9's (loss {float(loss)!r} against "
                    f"{whole['loss']!r}) or made {n_coll} collectives")
            want = {"segment_sum": 2 * n_layers * n_parts,
                    "segment_sum_backward": n_layers * n_parts,
                    "gather_rows_backward": 2 * n_layers * n_parts}
            got = {k: by_phase[k]["dist_w1_ddp"] for k in want}
            if got != want:
                raise RuntimeError(f"phase 16 (a): launches {got}, "
                                   f"expected {want}")
            del model, opt, batch, step
            model = whole_train_model(cfg).to(dev)
            shard, meta = _dmgn_shard(sample, 1, 0, dev)
            reset_counts()
            c0 = all_reduce.collectives
            loss1 = dmgn.make_dmgn_grad_fn(group, ps.denom)(model, shard)
            torch.cuda.synchronize()
            read_counts("dist_w1_dmgn")
            n_coll1 = all_reduce.collectives - c0
            if n_coll1 != 2 * n_layers + 1:
                raise RuntimeError(f"phase 16 (a): the baseline made "
                                   f"{n_coll1} collectives")
            held = hold("(a) baseline W=1", float(loss1), _leaf_grads(model))
            del model, shard
        finally:
            dist.destroy_process_group()
    finally:
        store.unlink(missing_ok=True)
    log(f"[dist] (a) NCCL, world size 1: phase 9's step through "
        f"make_gnn_step_fn(group=...) bit-equal to phase 9's card step "
        f"(loss, grad norm, {len(grads)} gradient leaves, updated "
        f"parameters), 1 collective, launches "
        + ", ".join(f"{k} {v}" for k, v in got.items())
        + f"; the baseline at W=1 (B={meta['B']}) against the full-graph "
        f"gradient: {held}, {n_coll1} collectives | {card}")

    # (b) and (c): two ranks sharing the card through gloo ----------------------
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_",
                                    dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        ranks = _spawn_ranks(DIST_WORLD, out_dir, str(out_dir / "store"))
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    per_part = {"segment_sum": 2 * n_layers, "segment_sum_backward": n_layers,
                "gather_rows_backward": 2 * n_layers}
    per_dmgn = {"segment_sum": n_layers, "segment_sum_backward": n_layers,
                "gather_rows_backward": 3 * n_layers}
    lines = []
    for r, res in enumerate(ranks):
        ddp, dm = res["ddp"], res["dmgn"]
        want = {k: v * ddp["parts"] for k, v in per_part.items()}
        if ddp["launches"] != want or ddp["collectives"] != 1 \
                or dm["launches"] != per_dmgn \
                or dm["collectives"] != 2 * n_layers + 1 or ddp["skipped"]:
            raise RuntimeError(
                f"phase 16 (b) rank {r}: DDP launches {ddp['launches']} "
                f"(expected {want}), {ddp['collectives']} collectives; "
                f"baseline launches {dm['launches']} (expected {per_dmgn}), "
                f"{dm['collectives']} collectives")
        for k, v in {**{f"dist_w2_ddp_rank{r}": ddp["launches"]},
                     **{f"dist_w2_dmgn_rank{r}": dm["launches"]}}.items():
            for name, n in v.items():
                by_phase[name][k] = n
        lines.append(
            f"rank {r}: DDP {ddp['parts']} partition(s), "
            + hold(f"(b) DDP rank {r}", ddp["loss"], ddp["grads"])
            + f"; baseline (B={dm['meta']['B']}, Nmax={dm['meta']['Nmax']}, "
            f"Emax={dm['meta']['Emax']}) "
            + hold(f"(b) baseline rank {r}", dm["loss"], dm["grads"])
            + "; launches DDP " + ", ".join(
                f"{k} {v}" for k, v in ddp["launches"].items())
            + ", baseline " + ", ".join(
                f"{k} {v}" for k, v in dm["launches"].items()))
    r0, r1 = ranks
    for key in ("grads", "params"):
        if not all(torch.equal(a, b)
                   for a, b in zip(r0["ddp"][key], r1["ddp"][key])):
            raise RuntimeError(f"phase 16 (b): the two ranks' DDP {key} "
                               "differ")
    far, near, share = _near_zero_split(r0["ddp"]["params"],
                                        whole["params"], whole["grads"])
    if far > TRAIN_PARAM_ATOL or near > 2 * opt_cfg.lr_max:
        raise RuntimeError(f"phase 16 (b): DDP updated params differ from "
                           f"phase 9's by {far} (limit {TRAIN_PARAM_ATOL}), "
                           f"near-zero gradients {near}")
    for line in lines:
        log(f"[dist] (b) gloo, 2 ranks on one card, phase 9's size: {line}")
    log(f"[dist] (b) DDP updated params against phase 9's card step: max "
        f"abs err {far:.3g} (limit {TRAIN_PARAM_ATOL}), {near:.3g} on the "
        f"{share:.2%} with gradient below {TRAIN_NEAR_ZERO}; both ranks "
        f"bit-equal; collectives a step: DDP 1, baseline "
        f"{2 * n_layers + 1} (2L + 1) | {card}")

    want_losses = train_losses[:DIST_STEPS]
    for r, res in enumerate(ranks):
        t = res["train"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(t["losses"],
                                                       want_losses))
        per_rank = TRAIN_PARTITIONS // DIST_WORLD
        n_layers_full = GNNConfig().n_mp_layers
        want = {"segment_sum": 2 * n_layers_full * per_rank * DIST_STEPS,
                "segment_sum_backward": n_layers_full * per_rank * DIST_STEPS,
                "gather_rows_backward":
                    2 * n_layers_full * per_rank * DIST_STEPS}
        if rel > TRAIN_LOSS_RTOL or t["launches"] != want \
                or t["collectives"] != DIST_STEPS:
            raise RuntimeError(
                f"phase 16 (c) rank {r}: losses {t['losses']} against phase "
                f"10's {want_losses} (relative {rel}), launches "
                f"{t['launches']} (expected {want}), {t['collectives']} "
                "collectives")
        for name, n in t["launches"].items():
            by_phase[name][f"dist_w2_train_rank{r}"] = n
        log(f"[dist] (c) train_gnn full width ({TRAIN_PARTITIONS} partitions, "
            f"{per_rank} a rank), rank {r} of {DIST_WORLD} on one card: "
            f"losses {t['losses']!r} against phase 10's {want_losses!r} "
            f"(relative {rel:.3g}, limit {TRAIN_LOSS_RTOL}); steps (s): "
            + ", ".join(f"{x:.3f}" for x in t["step_s"])
            + f" (first, then warm); all_reduce "
            f"{t['all_reduce_s'] / DIST_STEPS:.4f} s and "
            f"{t['bytes'] // DIST_STEPS} bytes a step ({t['collectives']} "
            f"in {DIST_STEPS} steps); peak memory {t['peak_gb']:.2f} GB; "
            f"host data {t['data_s']:.2f} s; train_gnn {t['wall_s']:.2f} s; "
            "launches " + ", ".join(f"{k} {v}" for k, v in
                                     t["launches"].items()) + f" | {card}")
    log(f"[dist] phase 16 took {time.perf_counter() - t_phase:.1f} s (the "
        f"two ranks {spawn_s:.1f} s, spawn to join) | {card}")


def coldstart_save(server, card):
    """Phase 17 (a): phase 5's server, after serving cars 1-4, freezes
    itself into COLDSTART_ARTIFACT."""
    shutil.rmtree(COLDSTART_DIR, ignore_errors=True)
    COLDSTART_DIR.mkdir(parents=True)
    path = COLDSTART_ARTIFACT
    t0 = time.perf_counter()
    info = server.save_artifact(str(path))
    dt = time.perf_counter() - t0
    n_params = sum(p.numel() for p in server.params.parameters())
    log(f"[coldstart] (a) phase 5's server saved its deploy artifact: "
        f"{path.stat().st_size} bytes ({n_params} f32 parameters, "
        f"{4 * n_params} bytes) in {dt:.3f} s; live buckets "
        f"{info['buckets']}, ladder {info['ladder']} | {card}")


def _coldstart_child(kind: str, build_dir: str, artifact_path: str,
                     out_dir: str, t_spawn: float):
    """Phase 17 (b) in a spawned process: writes ``<kind>.pt``, or its
    traceback to ``error_<kind>.txt`` and fails."""
    import traceback
    try:
        _coldstart_child_work(kind, build_dir, artifact_path, Path(out_dir),
                              t_spawn)
    except BaseException:
        (Path(out_dir) / f"error_{kind}.txt").write_text(
            f"{kind}:\n{traceback.format_exc()}")
        raise


def _coldstart_child_work(kind: str, build_dir: str, artifact_path: str,
                          out: Path, t_spawn: float):
    """A restarted server: ``fresh`` and ``warm`` build one from phase 5's
    config and seed with ``compile_cache_dir=build_dir`` (empty for
    ``fresh``), ``artifact`` enables the same directory and restores the
    deploy artifact. Each serves phase 5's 4 requests (request ids 0-3, so
    the same sampled clouds); car 2's 65,536-point batch runs last, so the
    flush's end is its first result."""
    t_start = time.time()
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.ckpt import compile_cache
    from repro_torch.configs.base import GNNConfig
    from repro_torch.data import geometry as geo
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.launch.serve_gnn import GNNServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.init()
    t_import = time.time()
    reqs = [(*geo.car_surface(geo.sample_params(i + 1)), n)
            for i, n in enumerate(SERVE_SIZES)]
    if kind == "artifact":
        compile_cache.enable(build_dir)
        server = GNNServer.from_artifact(artifact_path)
    else:
        server = GNNServer(GNNConfig(compile_cache_dir=build_dir), BUCKETS,
                           max_batch=2, seed=0)
    torch.cuda.synchronize()
    t_built = time.time()
    knn_ops.topk_neighbors.launches = 0
    seg_ops.segment_sum_prepared.launches = 0
    results = server.serve(reqs)
    t_first = time.time()
    rep = server.stats.report()
    by_id = {r.request_id: r for r in results}
    res = dict(
        time_to_first_result_s=t_first - t_spawn,
        spawn_to_start_s=t_start - t_spawn, import_s=t_import - t_start,
        construct_s=t_built - t_import, serve_s=t_first - t_built,
        bucket_calibrations=rep["bucket_calibrations"],
        bucket_compiles=rep["bucket_compiles"],
        cache_loads=rep["cache_loads"],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches={"segment_sum": seg_ops.segment_sum_prepared.launches,
                  "knn_topk": knn_ops.topk_neighbors.launches},
        libraries=sorted(p.name for p in Path(build_dir).glob("*.so")))
    log(f"[coldstart] (b) {kind} child: " + json.dumps(res))
    res["fields"] = {rid: by_id[rid].fields for rid in sorted(by_id)}
    res["errors"] = [r.error for r in results if r.error is not None]
    torch.save(res, out / f"{kind}.pt")


def coldstart_phase(card, by_phase, phase5):
    """Phase 17 (b) and (c): three restarted servers, one after another,
    each in a spawned process with a time limit (a failing or overrunning
    child fails the phase): ``fresh`` (an empty build directory), ``warm``
    (the directory ``fresh`` filled) and ``artifact`` (the same directory
    and ``from_artifact``). All serve phase 5's fields bit for bit; the
    artifact child calibrates and builds nothing, the warm child builds
    nothing, the fresh child builds each library its path loads."""
    import multiprocessing as mp
    import torch
    from repro_torch.configs.base import GNNConfig
    n_layers = GNNConfig().n_mp_layers
    t_phase = time.perf_counter()
    build_dir = COLDSTART_DIR / "kernels"
    shutil.rmtree(build_dir, ignore_errors=True)
    build_dir.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    got = {}
    for kind in COLDSTART_KINDS:
        t_spawn = time.time()
        proc = ctx.Process(target=_coldstart_child,
                           args=(kind, str(build_dir), str(COLDSTART_ARTIFACT),
                                 str(COLDSTART_DIR), t_spawn))
        proc.start()
        proc.join(COLDSTART_TIMEOUT)
        if proc.is_alive():
            proc.kill()
            proc.join(30)
            raise RuntimeError(f"phase 17: the {kind} child was killed at "
                               f"the {COLDSTART_TIMEOUT} s limit")
        if proc.exitcode != 0:
            err = COLDSTART_DIR / f"error_{kind}.txt"
            raise RuntimeError(f"phase 17: the {kind} child exited "
                               f"{proc.exitcode}\n"
                               + (err.read_text() if err.exists() else ""))
        got[kind] = torch.load(COLDSTART_DIR / f"{kind}.pt",
                               weights_only=False)
    _coldstart_check(card, by_phase, phase5, got, n_layers)
    log(f"[coldstart] phase 17 took {time.perf_counter() - t_phase:.1f} s | "
        f"{card}")
    shutil.rmtree(COLDSTART_DIR, ignore_errors=True)


def _coldstart_check(card, by_phase, phase5, got, n_layers):
    """Phase 17 (c): the children's fields, launches, builds and loads."""
    rows = len(SERVE_SIZES)
    want_launches = {"segment_sum": n_layers * rows, "knn_topk": 3 * rows}
    for kind, res in got.items():
        if res["errors"] or sorted(res["fields"]) != sorted(phase5):
            raise RuntimeError(f"phase 17: {kind} child served "
                               f"{sorted(res['fields'])}, errors "
                               f"{res['errors']}")
        for rid, fields in res["fields"].items():
            if not np.array_equal(fields, phase5[rid].fields):
                raise RuntimeError(f"phase 17: the {kind} child's fields of "
                                   f"request {rid} are not bit-equal to "
                                   "phase 5's")
        if res["launches"] != want_launches:
            raise RuntimeError(f"phase 17: {kind} child launches "
                               f"{res['launches']}, expected {want_launches}")
        for name, n in res["launches"].items():
            by_phase[name][f"coldstart_{kind}"] = n
    fresh, warm, art = (got[k] for k in COLDSTART_KINDS)
    if art["bucket_calibrations"] or art["bucket_compiles"]:
        raise RuntimeError(f"phase 17: the artifact child calibrated "
                           f"{art['bucket_calibrations']} and built "
                           f"{art['bucket_compiles']} times")
    if warm["bucket_compiles"]:
        raise RuntimeError(f"phase 17: the warm child built "
                           f"{warm['bucket_compiles']} kernels")
    if not fresh["libraries"] or \
            fresh["bucket_compiles"] != len(fresh["libraries"]) or \
            fresh["cache_loads"]:
        raise RuntimeError(f"phase 17: the fresh child built "
                           f"{fresh['bucket_compiles']} and loaded "
                           f"{fresh['cache_loads']} kernels; its path's "
                           f"libraries: {fresh['libraries']}")
    if warm["cache_loads"] != len(fresh["libraries"]) or \
            art["cache_loads"] != len(fresh["libraries"]):
        raise RuntimeError(f"phase 17: cache loads warm "
                           f"{warm['cache_loads']}, artifact "
                           f"{art['cache_loads']}, expected "
                           f"{len(fresh['libraries'])}")
    for kind, res in got.items():
        log(f"[coldstart] (c) {kind}: time to first result (car 2, 65,536 "
            f"points, behind the 16,384 batch) {res['time_to_first_result_s']:.3f} s "
            f"from spawn (process start {res['spawn_to_start_s']:.3f}, "
            f"imports and CUDA init {res['import_s']:.3f}, server "
            f"{res['construct_s']:.3f}, serving 4 requests "
            f"{res['serve_s']:.3f}); calibrations "
            f"{res['bucket_calibrations']}, compiles "
            f"{res['bucket_compiles']}, cache loads {res['cache_loads']}, "
            f"peak memory {res['peak_gb']:.2f} GB; fields of requests 0-3 "
            f"bit-equal to phase 5's | {card}")
    log(f"[coldstart] the fresh child built {fresh['libraries']} | {card}")


def unet_flops(cfg, grid) -> float:
    """Operations (2 per multiply-add) of every convolution of one X-UNet3D
    forward pass over an (X, Y, Z) grid, from the shapes."""
    k3 = cfg.kernel_size ** 3
    ch = [cfg.base_channels * 2 ** i for i in range(cfg.depth)]
    vox = [grid[0] * grid[1] * grid[2] / 8 ** i for i in range(cfg.depth)]
    n = cfg.blocks_per_level
    f, cin = 0.0, cfg.in_channels
    for i in range(cfg.depth):
        f += 2 * k3 * (cin + (n - 1) * ch[i]) * ch[i] * vox[i]
        cin = ch[i]
    for i in reversed(range(cfg.depth - 1)):
        f += 2 * ch[i + 1] * ch[i] * vox[i]                # up conv
        if cfg.attention_gates:
            ci = max(ch[i] // 2, 1)
            f += 2 * (2 * ch[i] * ci + ci) * vox[i]
        f += 2 * k3 * (2 * ch[i] + (n - 1) * ch[i]) * ch[i] * vox[i]
    return f + 2 * ch[0] * cfg.out_channels * vox[0]


def _unet_grads(model) -> list:
    return [p.grad.detach().cpu().double() for _, p in model.leaves()]


def unet_features():
    """Phase 18's input: ``make_features`` of car 0 on the paper's grid
    (host numpy), with its seconds."""
    from repro_torch.configs.base import UNetConfig
    from repro_torch.launch import xunet_volume as xv
    t0 = time.perf_counter()
    pts, feats = xv.make_features(UNetConfig(), 0)
    return pts, feats, time.perf_counter() - t0


def unet_phase(dev, card, features):
    """Phase 18: X-UNet3D (paper SVI) at full width (``UNetConfig()``: base
    64, depth 3, k 3, attention gates, gelu), weights from a seeded
    ``torch.Generator``; no kernel of the port runs (cuDNN convolutions).
    ``features`` is :func:`unet_features`' result."""
    import torch
    from repro_torch.configs.base import UNetConfig
    from repro_torch.core import unet_halo
    from repro_torch.data import geometry as geo
    from repro_torch.launch import xunet_volume as xv
    from repro_torch.models import xunet3d
    from repro_torch.optim.adam import adam_init

    t_phase = time.perf_counter()
    cfg = UNetConfig()
    gx, gy, gz = cfg.grid
    align = 2 ** (cfg.depth - 1)
    model = xunet3d.init(torch.Generator().manual_seed(0), cfg)
    pts, feats, feat_s = features
    x = torch.from_numpy(feats).view(1, gx, gy, gz, cfg.in_channels)
    log(f"[xunet] make_features of car 0 on the {gx}x{gy}x{gz} grid (host "
        f"numpy, while phase 17 ran): {feats.nbytes} bytes in {feat_s:.2f} "
        f"s; receptive field {xunet3d.receptive_field(cfg)} voxels, halo "
        f"{cfg.halo}, {cfg.n_partitions} slabs")

    # layout: the model runs NCDHW (contiguous); the same 64 -> 64 conv in
    # channels_last_3d, on one owned slab's voxels
    w = torch.randn((64, 64, 3, 3, 3), device=dev) * 0.02
    a = torch.randn((1, 64, UNET_TRAIN_X, gy, gz), device=dev)
    a_cl = a.contiguous(memory_format=torch.channels_last_3d)
    conv_flops = 2 * 27 * 64 * 64 * UNET_TRAIN_X * gy * gz
    layout_ms = {name: time_cuda(lambda t=t: torch.nn.functional.conv3d(
        t, w, padding=1), reps=5)
        for name, t in (("ncdhw", a), ("channels_last_3d", a_cl),
                        ("ncdhw again", a))}
    log("[xunet] layout: conv3d 64->64, k 3, on (1, 64, "
        f"{UNET_TRAIN_X}, {gy}, {gz}): " + ", ".join(
            f"{k} {v:.3f} ms ({conv_flops / v / 1e9:.1f} TFLOP/s)"
            for k, v in layout_ms.items()) + f" | {card}")
    del w, a, a_cl

    # (a) the paper's grid in 10 slabs with halo 40 ------------------------
    parts = unet_halo.slab_partitions(gx, cfg.n_partitions, cfg.halo, align)
    flops = sum(unet_flops(cfg, (e.stop - e.start, gy, gz))
                for _, e, _ in parts)
    slab_s = []

    def run_slab(slab):
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = model.apply(slab.to(dev))
        torch.cuda.synchronize()
        slab_s.append(time.perf_counter() - t)
        return y

    # one pass: a second one took the first's time within 0.4 % on an H100
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = unet_halo.apply_partitioned(run_slab, x, cfg.n_partitions,
                                          cfg.halo, axis=1, align=align)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        finite = bool(torch.isfinite(out).all())
        if out.shape != (1, gx, gy, gz, cfg.out_channels) or not finite:
            raise RuntimeError(f"phase 18 (a): output {tuple(out.shape)}, "
                               f"finite {finite}")
        del out
    log(f"[xunet] (a) {gx}x{gy}x{gz} in {cfg.n_partitions} slabs, halo "
        f"{cfg.halo} (extended X {[e.stop - e.start for _, e, _ in parts]}):"
        f" {wall:.3f} s, {flops / 1e12:.1f} TFLOP, "
        f"{flops / wall / 1e12:.2f} TFLOP/s; per slab (s, copy in "
        "included): " + ", ".join(f"{t:.3f}" for t in slab_s)
        + f"; peak memory {peak:.2f} GB; output finite | {card}")

    # (b) the partitioned pass against the full pass -----------------------
    xb = x[:, :UNET_EQUIV_X]
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        full = model.apply(xb.to(dev))
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        full_peak = torch.cuda.max_memory_allocated() / 1e9
        scale = float(full.abs().max())
        errs = {}
        for halo in (cfg.halo, align):
            part = unet_halo.apply_partitioned(
                lambda s: model.apply(s.to(dev)), xb, UNET_EQUIV_PARTS, halo,
                axis=1, align=align)
            errs[halo] = float((part - full).abs().max())
            del part
        del full
    if errs[cfg.halo] > UNET_PART_RTOL * scale or \
            errs[align] <= UNET_PART_RTOL * scale:
        raise RuntimeError(f"phase 18 (b): partitioned against full, max abs "
                           f"err {errs} (limit {UNET_PART_RTOL} x {scale})")
    # a window of the grid around the car's middle, where the SDF varies
    xh = x[(slice(None),) + tuple(slice((g - h) // 2, (g - h) // 2 + h)
                                  for g, h in zip(cfg.grid, UNET_HALO_GRID))
           ].contiguous().to(dev)
    with torch.no_grad():
        tol = UNET_PART_RTOL * float(model.apply(xh).abs().max())
        halo = unet_halo.find_receptive_halo(
            model.apply, xh, axis=1, n_parts=2, align=align,
            max_halo=2 * cfg.halo, tol=tol)
    bound = -(-xunet3d.receptive_field(cfg) // align) * align
    if not align <= halo <= bound:
        raise RuntimeError(f"phase 18 (b): find_receptive_halo {halo}, "
                           f"expected {align}..{bound}")
    log(f"[xunet] (b) {UNET_EQUIV_X}x{gy}x{gz}: full pass "
        f"{full_s:.3f} s ({unet_flops(cfg, (UNET_EQUIV_X, gy, gz)) / 1e12:.1f} "
        f"TFLOP), peak {full_peak:.2f} GB; {UNET_EQUIV_PARTS} slabs, halo "
        f"{cfg.halo}: max abs err {errs[cfg.halo]:.3g} = "
        f"{errs[cfg.halo] / scale:.3g} of max |full| {scale:.4g} (limit "
        f"{UNET_PART_RTOL}); halo {align}: {errs[align] / scale:.3g} (must "
        f"exceed it); find_receptive_halo on {UNET_HALO_GRID}: {halo} "
        f"(analytic {xunet3d.receptive_field(cfg)}, bound {bound}) | {card}")

    # (c) card against CPU ---------------------------------------------------
    rng = np.random.default_rng(18)
    shape = (1, *UNET_WHOLE_GRID)
    xc = torch.from_numpy(rng.normal(size=(*shape, cfg.in_channels))
                          .astype(np.float32))
    yc = torch.from_numpy(rng.normal(size=(*shape, cfg.out_channels))
                          .astype(np.float32))
    m_cpu = xunet3d.init(torch.Generator().manual_seed(1), cfg, device="cpu")
    m_gpu = copy.deepcopy(m_cpu).to(dev)
    with torch.no_grad():
        fwd_err = float((m_gpu.apply(xc.to(dev)).cpu()
                         - m_cpu.apply(xc)).abs().max())
    losses = []
    for m, d in ((m_gpu, dev), (m_cpu, torch.device("cpu"))):
        loss = xunet3d.train_loss(m, {"inputs": xc.to(d),
                                      "targets": yc.to(d)}, 0.05)
        loss.backward()
        losses.append(float(loss.detach()))
    g_gpu, g_cpu = _unet_grads(m_gpu), _unet_grads(m_cpu)
    names = [n for n, _ in m_cpu.leaves()]
    rel = [float((a - b).abs().max() / b.abs().max())
           for a, b in zip(g_gpu, g_cpu)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    note = ""
    if max(rel) > UNET_GRAD_RTOL:
        # a leaf whose gradient f32 itself resolves only to a few 1e-5 (a
        # cancellation): held to the f64 gradient, no further than the CPU's
        # own f32 gradient (tests/test_torch_xunet.py makes the same rule)
        m64 = copy.deepcopy(m_cpu).double()
        for p in m64.parameters():
            p.grad = None
        xunet3d.train_loss(m64, {"inputs": xc.double(),
                                 "targets": yc.double()}, 0.05).backward()
        g64 = _unet_grads(m64)
        for i in range(len(rel)):
            if rel[i] <= UNET_GRAD_RTOL:
                continue
            e_gpu = float((g_gpu[i] - g64[i]).abs().max())
            e_cpu = float((g_cpu[i] - g64[i]).abs().max())
            lim = max(UNET_GRAD_RTOL * float(g64[i].abs().max()), e_cpu)
            if e_gpu > lim:
                raise RuntimeError(f"phase 18 (c): gradient {names[i]} card "
                                   f"vs CPU {rel[i]:.3g} relative; against "
                                   f"f64 card {e_gpu:.3g}, CPU {e_cpu:.3g}")
            note += (f"; {names[i]} held to f64: card {e_gpu:.3g}, CPU "
                     f"{e_cpu:.3g}")
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    if fwd_err > UNET_ATOL or loss_rel > UNET_LOSS_RTOL:
        raise RuntimeError(f"phase 18 (c): forward max abs err {fwd_err} "
                           f"(limit {UNET_ATOL}), loss relative {loss_rel} "
                           f"(limit {UNET_LOSS_RTOL})")
    log(f"[xunet] (c) card against CPU, full width on {UNET_WHOLE_GRID} "
        f"({unet_flops(cfg, UNET_WHOLE_GRID) / 1e9:.1f} GFLOP a forward): "
        f"forward max abs err {fwd_err:.3g} (limit {UNET_ATOL}); loss "
        f"{losses[0]:.8g} vs {losses[1]:.8g}, relative {loss_rel:.3g} "
        f"(limit {UNET_LOSS_RTOL}); gradients: worst leaf {names[worst]} "
        f"{rel[worst]:.3g} of its largest element (limit "
        f"{UNET_GRAD_RTOL}){note} | {card}")
    del m_cpu, m_gpu

    # (d) training at full width on one owned slab -------------------------
    n_slab = UNET_TRAIN_X * gy * gz
    targets = geo.volume_fields(pts[:n_slab], geo.sample_params(0))
    batch = {"inputs": x[:, :UNET_TRAIN_X].to(dev),
             "targets": torch.from_numpy(targets).view(
                 1, UNET_TRAIN_X, gy, gz, cfg.out_channels).to(dev)}
    del pts, feats, x, targets
    model = xunet3d.init(torch.Generator().manual_seed(0), cfg)
    step = xv.make_step_fn()
    opt = adam_init([p for _, p in model.leaves()])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for _ in range(UNET_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, loss = step(model, opt, batch)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"phase 18 (d): losses {losses}")
    fl = 3 * unet_flops(cfg, (UNET_TRAIN_X, gy, gz))
    log(f"[xunet] (d) training, batch (1, {UNET_TRAIN_X}, {gy}, {gz}, "
        f"{cfg.in_channels}), the example's Adam, continuity "
        f"{xv.CONTINUITY_WEIGHT}: losses {losses!r}; steps (s): "
        + ", ".join(f"{t:.3f}" for t in step_s)
        + f" (first, then warm; about {fl / 1e12:.1f} TFLOP a step, "
        f"{fl / min(step_s[1:]) / 1e12:.2f} TFLOP/s warm); peak memory "
        f"{peak:.2f} GB | {card}")
    log(f"[xunet] phase 18 took {time.perf_counter() - t_phase:.1f} s | "
        f"{card}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.segment_agg import ops as seg_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    counters = {"segment_sum": seg_ops.segment_sum_prepared,
                "segment_sum_backward": seg_ops.segment_sum_backward,
                "gather_rows_backward": seg_ops.gather_rows,
                "knn_topk": knn_ops.topk_neighbors,
                "flash_attention": fa_ops.mha}
    by_phase = {name: {} for name in counters}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts(phase):
        for name, fn in counters.items():
            by_phase[name][phase] = fn.launches

    # 1. card --------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} | "
        "allow_tf32: matmul False, cudnn False")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {len(_build.SOURCES)} kernels ({len(built)} compiled now, "
        f"in parallel) in {time.perf_counter() - t0:.2f} s -> "
        f"{_build.BUILD_DIR}")
    for name, c in built.items():
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                  c.log)}) or ["?"]
        spills = re.findall(r"(\d+) bytes spill (stores|loads)", c.log)
        log(f"[build] {name}: {c.seconds:.2f} s, {regs[0]}-{regs[-1]} "
            f"registers per thread over its kernels, spills: "
            f"{sum(int(n) for n, _ in spills)} bytes")
        for line in c.log.splitlines():
            if "warning" in line.lower():
                log(f"[build] {name}: {line.strip()}")
    sass = subprocess.run(
        [shutil.which("cuobjdump")
         or str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
         str(_build.library_path("flash_attention_wgmma"))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    found = {op: len(re.findall(rf"\b{op}\b", sass)) for op in FLASH_SASS}
    log(f"[build] flash_attention_wgmma SASS: " + ", ".join(
        f"{op} x{n}" for op, n in found.items()))
    if not all(found.values()):
        raise RuntimeError(f"flash_attention_wgmma: SASS lacks "
                           f"{[op for op, n in found.items() if not n]}")

    kernels, rollout_ctx = gnn_phases(dev, card, reset_counts, read_counts,
                                      by_phase)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[llm] GNN phases done and freed: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    # 3. (continued) the flash-attention kernels, at head_dim 256 and 128 ---
    reset_counts()
    flash_row = flash_check(dev, card)
    flash_row["hd128"] = flash_check_hd128(dev, card)
    kernels.append(flash_row)
    torch.cuda.synchronize()
    read_counts("flash_check")

    # 7. LLM whole path: card against CPU ------------------------------------
    reset_counts()
    llm_whole_path(dev)
    torch.cuda.synchronize()
    read_counts("llm_whole_path")
    n_layers = 2
    if by_phase["flash_attention"]["llm_whole_path"] != n_layers:
        raise RuntimeError(
            f"llm whole path: flash attention launched "
            f"{by_phase['flash_attention']['llm_whole_path']} times on the "
            f"card, expected {n_layers} (one prefill of {n_layers} layers)")

    # 8. LLM serve: the main path of the flash kernel, counted --------------
    llm_serve(dev, card, reset_counts, read_counts, by_phase)
    gc.collect()
    torch.cuda.empty_cache()

    # 19. the head_dim-128 decoders: (a) four at full width, 2 layers, card
    # against CPU; (b) qwen3-moe-30b-a3b served at full width and depth, the
    # main path of the flash kernels at head_dim 128, counted
    t0 = time.perf_counter()
    decoders_whole_path(dev, card, reset_counts, read_counts, by_phase)
    moe_serve(dev, card, reset_counts, read_counts, by_phase)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe] phase 19 took {time.perf_counter() - t0:.1f} s | {card}")

    # training, last: after its profile of a whole step (about 34,000
    # launches), torch.profiler held almost no launches of the later
    # flash-attention profiles in the same process
    rows, dist_ctx = train_phases(dev, card, reset_counts, read_counts,
                                  by_phase)
    kernels.extend(rows)
    gc.collect()
    torch.cuda.empty_cache()

    # 13. rollouts, last: after its tens of thousands of launches,
    # torch.profiler held none of the flash check's 10 launches in the same
    # process (PERF.md, section 6), and every later phase profiles
    feedback = rollout_phase(dev, card, reset_counts, read_counts,
                             by_phase, **rollout_ctx)
    gc.collect()
    torch.cuda.empty_cache()

    # 15. sharded serving and sharded rollouts, after phase 13 (whose state
    # feedback run it reuses), in a function of its own
    sharded_phase(dev, card, reset_counts, read_counts, by_phase,
                  feedback=feedback, **rollout_ctx)
    phase5 = rollout_ctx["phase5"]
    del feedback, rollout_ctx
    gc.collect()
    torch.cuda.empty_cache()

    # 16. multi-process training: NCCL at world size 1 in this process, then
    # two ranks sharing the card through gloo, in a function of its own
    dist_phase(dev, card, reset_counts, read_counts, by_phase, **dist_ctx)
    gc.collect()
    torch.cuda.empty_cache()

    # 17. cold start: three restarted servers in child processes, one after
    # another (fresh build directory, warm, deploy artifact); phase 18's
    # input is built on the host meanwhile (about 25 s of numpy)
    with ThreadPoolExecutor(1) as pool:
        unet_input = pool.submit(unet_features)
        coldstart_phase(card, by_phase, phase5)
        del phase5
        features = unet_input.result()

    # 18. X-UNet3D at full width: cuDNN convolutions, none of the port's
    # kernels
    reset_counts()
    unet_phase(dev, card, features)
    del features
    torch.cuda.synchronize()
    read_counts("xunet")
    launched = {name: by_phase[name]["xunet"] for name in by_phase
                if by_phase[name]["xunet"]}
    if launched:
        raise RuntimeError(f"phase 18 launched the port's kernels: {launched}")

    main_phase = {"segment_sum": "serve", "segment_sum_backward": "train",
                  "gather_rows_backward": "train",
                  "knn_topk": "serve", "flash_attention": "llm_serve"}
    for kr in kernels:
        kr["launches"] = by_phase[kr["name"]][main_phase[kr["name"]]]
        if "hd128" in kr:
            kr["hd128"]["launches"] = by_phase[kr["name"]]["moe_serve"]
        kr["launches_by_phase"] = by_phase[kr["name"]]
        kr["phases"] = [p for p, n in by_phase[kr["name"]].items() if n]
        kr["card"] = card
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
