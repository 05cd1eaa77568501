#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (built for an H100: the kernels target sm_90a) and
``nvcc``; imports no JAX. Phases, each printing its results:

1. the card (``nvidia-smi`` name and power limit) and the kernel builds,
   one ``nvcc`` per kernel source, started together, with ptxas's
   registers, shared memory and spills;
2. the flash-attention kernel against its plain version ``attention_ref``
   on the card, causal and not, fp32 (tolerance 3e-5) and bf16 (2e-2):
   the reference's kernel-test shapes plus the serving prefill's
   (8, 2048, 14, 64) and ragged (8, 2081, 14, 64), with kernel, plain and
   ``scaled_dot_product_attention`` times and the card's bound; then the
   main path's call, ``kernels.ops.flash_attention`` on the model layout
   with qwen2's 2 grouped KV heads at (8, 2081, 14, 64), checked and timed
   beside the (B*H, S, d) call, SDPA and the bound; and a rank's block of
   the queries (``q_offset``, the row split of a 16-rank "model" dim where
   the heads do not divide it) at that shape, fp32 and bf16, against the
   plain version's rows of that block;
3. qwen2-0.5b at full width in fp32 (TF32 off): prefill logits through the
   kernel against the plain path, and prefill -> decode teacher forcing
   against the full forward, both at 2e-3;
4. the first main path: qwen2-0.5b in bf16 at full width served by
   ``DecodeEngine`` (batch 8, prompt 2048 padded to 2081, 32 greedy
   steps), twice, with the kernels' launch counts read around each run,
   then device profiles of one prefill and of decode steps, and a
   profiler listing of the aten ops around the flash kernel in a layer's
   causal attention (only the output's allocation: no expand, transpose
   or copy of q, k, v or o);
5. the SSD chunked-scan kernel against its plain version
   ``ssd_chunked_ref`` on the card, fp32 (y within 2e-4) and bf16 (y within
   2e-2 of the fp32 plain result cast to bf16), the final state within 2e-4:
   the reference's kernel-test shapes, ragged lengths, jamba's state and
   chunk, and the serving prefills' (8, 2081, 32, 64, N 128, chunk 256) of
   mamba2-370m, also with slow decay (the state carried across whole
   chunks), and (8, 2081, 128, 64, N 16, chunk 64) of jamba-v0.1-52b, with
   kernel and plain times and the card's bound; then, at both serving
   prefills' shapes in fp32 and bf16, the scan split as a sequence-split
   prefill runs it (``SPLIT_CUTS``: 4 blocks of whole chunks, the last
   ragged): each block's states call, the carry of the blocks before it
   (``ssd_carry``, a nonzero initial state) and its output call, against
   ``ssd_chunked_ref`` on the whole sequence (y and the final state, the
   same tolerances), the chain's time beside the one-call kernel's;
6. mamba2-370m at full width in fp32 (TF32 off): prefill logits through the
   kernel against the plain path, and prefill -> 3 decode steps against
   the full forward, both at 2e-3;
7. the second main path: mamba2-370m in bf16 at full width served by
   ``DecodeEngine``, as in phase 4; then a sequence-split prefill's Mamba2
   layers: each of its 48 layers at (8, 2048) split into ``SPLIT_BLOCKS``
   sequence blocks as that many ranks run them (``ssm.apply_ssm_blocks``:
   the region a rank runs, its exchanges stacked in this process), the
   split scan's launches counted around the run, held to the one-call
   layer (``ssm.apply_ssm``) at 2e-2;
8. the RMSNorm forward and backward kernels against their plain version
   ``rmsnorm_ref`` under autograd on the card, fp32 (y and dx within 1e-5)
   and bf16 (2e-2), dgain within 1e-4 of its largest entry: the serving
   prefill's and decode's rows, the train steps' rows and small ragged
   ones, with kernel, plain and ``F.rms_norm`` times and the card's bound
   at the main path's (16384, 896) bf16;
9. one qwen2-0.5b train step at full width in fp32 (TF32 off, remat
   "full") through the RMSNorm kernels against one with the norm plain:
   loss, gradient norm, every gradient and the parameters after the step;
10. the third main path: ``profile_lm`` of qwen2-0.5b in bf16 at full width
   at (batch, seq) = (1, 512), (4, 1024), (8, 2048), each record printed as
   a JSON line with the kernels' launches counted around that call (a
   warm-up and the timed steps); the step's time on seeded random state
   against zeros; a device profile of one step; and one mamba2-370m record,
   full width at ``MAMBA_DEPTH`` layers (the first record's NSM, traced on
   card tensors, is held against a CPU trace beside phase 11's fits);
11. the fourth main path, the paper's experiment: every one of the 29 zoo
   CNNs' forward, loss and gradients at batch 8 on the card (TF32 off), in
   float64 and in fp32, against the CPU's float64 step (float64 within
   1e-10; fp32 within four times the CPU fp32 step's error or a floor, see
   ``ZOO_CHECK_FLOOR`` and ``ZOO_FP32_ALLOWANCE``), with a per-layer check
   of ``ZOO_LAYER_NETS`` under each cuDNN setting (``zoo_layer_check``), and
   a zoo step's NSM and FLOPs traced on card tensors against the CPU trace;
   then the corpus: the reference's default grid
   (``benchmarks/collect.py::zoo_grid``, 76 points), ``random_cnn`` seeds
   0-11, phase 10's four ``profile_lm`` records and the LMs of collect.py's
   lm_grid and random_grid (its eight ``LM_GRID_ARCHS`` reduced, MoE,
   hybrid, VLM and audio among them, and ``random_lm_config`` seeds 0-11,
   7 and 11 MoE), each printed as a JSON line: 112 records. Each record is
   what ``profile_zoo`` / ``profile_lm`` give, made in two parts: its
   fake-tensor trace (FLOPs, NSM) by ``core.profiler.TraceAhead``'s
   spawned worker processes, started after phase 1 so that they trace
   beside phases 2-10 and all end before phase 11's card work, and its
   timed steps on the card (``measure_point``) in phase 11; the corpus's
   wall time is printed beside what the same records cost serially. Then
   DNNAbacus fitted on those records as
   ``benchmarks/bench_mre.py`` (70/30 split, with the shape-inference and
   MLP baselines) and ``bench_unseen.py`` (zero-shot on the five unseen
   nets, NSM and graph embedding) do, its MREs printed as one JSON line,
   and the phase's wall time. The fits, phase 12's among them, run side by
   side in spawned worker processes, and phase 13, phase 12's chatglm3-6b,
   phase 10's NSM check and phase 15's in-process half run meanwhile;
12. the fifth main path, the online query: ``DNNAbacus.service()`` over a
   predictor fitted on every record but qwen2-0.5b's, with a fresh
   segment-log ``TraceStore`` under ``build/fleet`` that its cold queries
   write through to (one record a key), asked cold and warm
   about qwen2-0.5b at phase 10's points and chatglm3-6b, phi4-mini-3.8b,
   qwen2.5-32b and the MoE moonshot-v1-16b-a3b at (8, 2048), all four at
   full width cut to ``SERVICE_DEPTH`` layers for the script's time (one
   trace a key, identical warm answers at least 10x faster, each qwen2-0.5b record
   equal to phase 10's but for FLOPs, time and memory, every online FLOPs
   count 6 x active parameters x batch x seq), one JSON line a query with
   both FLOPs counts and, for qwen2-0.5b, the measured time and memory; and,
   run beside phase 11's fits, chatglm3-6b at full width, fp32 checks as
   phase 3 and bf16 served as phase 4 through the flash-attention (head_dim
   128, 16:1 grouped KV) and RMSNorm kernels, and its prefill's flash call
   timed beside SDPA and the bound;
13. the sixth main path, the MoE, hybrid, VLM and audio archs at full
   width (``PHASE13``), each with fp32 checks as phase 3 (cross-attention
   gates set to ``GATE``, stub patches or frames drawn on the card; MoE
   teacher forcing at a capacity of the whole group) and bf16 served as
   phase 4 with every kernel's launches counted (``serve_launches``) and
   the peak memory beside the card's: moonshot-v1-16b-a3b whole (48
   layers: 48 flash, 97 RMSNorm a prefill), arctic-480b, jamba-v0.1-52b and
   llama-3.2-vision-90b one period deep (jamba: 7 SSD calls a prefill), and
   whisper-tiny whole (its LayerNorm plain, its encoder's attention
   non-causal and plain); then moonshot's prefill flash call, 16 heads of
   128 over 16 KV heads, timed beside SDPA and the bound. It runs while
   phase 11's fits run in their worker processes;
14. the seventh main path, the serving fleet's loop around phase 12's
   service (``fleet_phase``): a ``ClusterFrontend`` over two in-process
   ``GatewayReplica``s and one ``RemoteReplica`` (``spawn_replica``, a
   ``python -m repro_torch.serve.rpc`` child), all over phase 12's trace
   store and one feedback store. Each replica answers phase 12's seven
   keys from the store (equal to phase 12's estimates, 0 traces), then one
   burst from ``FLEET_TENANTS`` through the frontend; the child reports no
   CUDA context. The qwen2-0.5b jobs are admitted on one ``Machine`` of the
   card's memory and run as phase 10's ``profile_lm`` calls (launches
   counted, each record equal to phase 10's but for time and memory), their
   measured costs reported (``report_completion``), the predictor refit on
   phase 12's records and the feedback and published as generation 1 to
   every replica, the RPC one over the wire; the keys are asked again
   (``{"refit": ...}``: generation 0's and 1's errors against the measured
   costs, and the calibration window), and a replica that sheds
   everything answers from the H100 floor; then the fleet's stats and the
   phase's wall time split;
15. the eighth main path, the training launcher: qwen2-0.5b in bf16 at
   full width and depth (24 layers, remat "full") at phase 10's (4, 1024).
   Its in-process half (``train_run``) runs beside phase 11's fits, where
   the card is free: a ``Trainer`` for ``TRAIN_STEPS`` steps with a
   checkpoint every ``TRAIN_CKPT_EVERY`` under ``build/train`` and one step
   call failing once (``FailureInjector``): exactly the injected retries,
   each step's batch equal to ``batch_at(step)`` and its kernel launches
   those of one train step (``step_launches``: the RMSNorm kernels on every
   norm); the last checkpoint restored bit for bit, bf16 leaves included,
   then deleted. After phase 14 (``train_phase``), with only the first
   checkpoint left, ``python -m repro_torch.launch.train --full-size
   --predict`` with phase 14's generation-1 predictor in a child process:
   the same estimate as the trace store gives, resumed at that checkpoint,
   its logged losses equal to the in-process run's bit for bit and its
   final checkpoint the in-process one's (each array's CRC-32 and size).
   Printed: each save's and restore's seconds and GB/s, the step times
   beside phase 10's, the estimate against the measured step and peak,
   stragglers, retries and the free disk (the phase needs
   ``TRAIN_DISK_CKPTS`` checkpoints of 6.9 GB);
16. the drift-scenario replay (``scenario_phase``), while phase 15's child
   trains: the composed scenario of ``benchmarks/bench_scenarios.py`` at its
   smoke size over the port's fleet of four in-process replicas (a kill, a
   resize to six, two publishes), every oracle of ``check_all`` holding
   and the schedule's digest equal in two children under other
   ``PYTHONHASHSEED``s;
17. the ninth main path, the sharded runtime. In a child process beside
   phase 11's fits, after phase 15's in-process half (``sharded_child``):
   the unsharded ``Trainer`` on qwen2-0.5b (bf16, full width and depth,
   ZeRO on) at phase 15's (4, 1024) and seed for ``SHARDED_STEPS`` steps,
   its final state kept on the host and freed from the card; then the same
   Trainer on a (1, 1) ``DeviceMesh`` over a one-rank NCCL group
   (``make_host_mesh``, ``make_sharder``, ``ShardingRules()``): DTensor
   state from ``state_shardings`` and batches from ``ShardedLoader``, each
   step's losses and the final state equal to the unsharded run's bit for
   bit, each step's RMSNorm launches those of one train step
   (``step_launches``: the kernels on each rank's rows through
   ``layers._rmsnorm_local``), its checkpoint restored onto the mesh bit for bit; then
   the int8 error-feedback all-reduce (``allreduce_compressed``) of the
   step's gradients over that one-rank group equal to
   ``ef_decompress(ef_compress(g))`` exactly with the residual ``x - q*s``,
   timed beside a plain ``all_reduce`` of the bf16 gradients (with one rank
   both time the local passes only: the quantisation against a copy).
   Beside phase 15's child and phase 16 (``dryrun_start`` /
   ``dryrun_finish``): ``repro_torch.launch.dryrun``'s ``main`` on
   qwen2-0.5b's train_4k cell under "dp" with ``--predict`` (phase 14's
   generation 1) on a fake 256-rank (16, 16) world, host only, at full
   width cut to ``DRYRUN_DEPTH`` of its 24 layers (the per-device terms
   scale with the layers), and ``repro_torch.analysis.report`` over its
   record: status ok, the model FLOPs per device 6 x (494,147,456 less
   the cut layers' ``QWEN_LAYER_PARAMS`` each) x 256 x 4096 / 256, a
   useful-FLOP fraction in (0.2, 1.05] and the data-parallel gradient's
   all-reduce carrying between 1 and ``GRAD_AR_MAX`` times the
   parameters' bf16 gradient bytes (every gradient reduced over "data"
   once; the tied table's two uses one by one);
18. the port's examples as a user runs them (``examples_phase``), beside
   phase 15's child after phase 16: ``examples/serve_lm_torch.py`` (the
   reduced qwen2-0.5b through ``DecodeEngine``: prefill and decode times,
   4 requests of 17 tokens) and ``examples/train_lm_torch.py --steps 20``
   (the ~100M-family qwen2 config through the ``Trainer``, the loss
   improving) as two child processes at once under ``build/examples``,
   each on this card (its first line names it), within 60 s of wall time.

Phase 11's CNN steps run none of the hand-written kernels (a CNN has no
attention, scan or RMSNorm; their launches are counted around the zoo corpus
and must be 0); its LM records' steps run the RMSNorm kernels, counted
around each ``profile_lm`` call. Nothing in phases 11, 12 and 14-16 is caught: a
record, a query, a step or a kernel that fails fails the run.
Phases 3, 6, 12 and 13 run their plain side with every kernel pinned plain;
phases 4, 7, 12, 13 and 14 count the RMSNorm kernel too (one launch a norm,
each prefill and each decode step), and phases 15 and 17 each train step's. Any
failed check raises, so the script exits nonzero without the final line; so
it does without a card, or away from the repository's sources.
The last lines are a JSON object of kernel results, the card's
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import zipfile
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
# phase 12's trace store and phase 14's fleet: made anew each run (build/ is
# not committed)
FLEET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "fleet")
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12   # fp32 outside the tensor cores
H100_HBM_BYTES_S = 3.35e12

KERNEL_SHAPES = [(1, 128, 1, 32), (2, 256, 4, 64), (1, 384, 3, 64), (2, 128, 2, 128),
                 (8, 2048, 14, 64), (8, 2081, 14, 64)]
MAIN_SHAPE = (8, 2081, 14, 64)  # serving prefill: prompt 2048 + 32 steps + 1
MAIN_KV_HEADS = 2  # qwen2-0.5b's grouped K/V, read unexpanded in the model layout
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
MODEL_TOL = 2e-3

# (b, l, h, p, n, chunk): the reference's SSD kernel-test shapes, ragged L
# (1, 67, 2081), jamba's N 16 / chunk 64, and the serving prefills of
# mamba2-370m and jamba-v0.1-52b (JAMBA_SSD_SHAPE, phase 13's)
SSD_SHAPES = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32), (1, 96, 1, 64, 32, 32),
              (2, 1, 4, 32, 16, 64), (2, 67, 4, 64, 64, 32), (2, 2081, 8, 64, 128, 256),
              (2, 300, 4, 64, 16, 64), (8, 2081, 32, 64, 128, 256),
              (8, 2081, 128, 64, 16, 64)]
SSD_MAIN = (8, 2081, 32, 64, 128, 256)  # mamba2-370m serving prefill: 32 heads, P 64, N 128
# shapes also run with slow decay (dt = softplus(draw - 4)), so the state
# carried across chunks reaches deep into each chunk and the final state
SSD_SLOW = (SSD_MAIN,)
SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}  # y; the fp32 final state holds to 2e-4
# the split scan at the serving prefills' length: 4 sequence blocks of whole
# chunks (of 256 and of 64), the last ragged
SPLIT_CUTS = (0, 512, 1024, 1536, 2081)
SPLIT_BLOCKS = 4  # phase 7's sequence-split layers: 2 chunks of 256 a block at 2048

# (rows, d_model) of the RMSNorm kernels: serving prefill (8 x 2081 rows) and
# decode (8) for qwen2 (896) and mamba2 (1024), the train steps of phase 10
# (512, 4096 and 16384 rows; 8192 for 8 x 1024) and small ragged rows
RMS_SHAPES = [(16648, 896), (16648, 1024), (8, 896), (8, 1024), (512, 896), (4096, 896),
              (8192, 896), (16384, 896), (1, 64), (7, 896), (300, 1024)]
RMS_MAIN = (16384, 896)  # the main path's rows: qwen2-0.5b train step at (8, 2048)
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # y and dx; dgain within 1e-4 of max |dgain|
DGAIN_TOL = 1e-4

# phase 9: one fp32 train step, kernel vs plain, at the CPU parity test's
# tolerances (tests/test_torch_train.py)
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, TRAIN_LR = 2, 256, 1e-3
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
# phase 10: the profiled points (batch, seq), the last the main one
PROFILE_POINTS = [(1, 512), (4, 1024), (8, 2048)]
PROFILE_STEPS = 3
QWEN_PARAMS = 494_147_456  # the reference's count for qwen2-0.5b
MAMBA_POINT = (2, 512)
# phase 10's mamba2-370m record at full width, cut to MAMBA_DEPTH of its 48
# layers for the script's time: the fake-tensor trace of the 48 took most of
# the record's 72.1 s (run C, PR 19; NVIDIA H100 80GB HBM3, 700 W)
MAMBA_DEPTH = 8

# phase 11: the reference's default profiling grid (benchmarks/collect.py's
# zoo_grid without BENCH_FULL, copied: the port imports nothing of benchmarks/)
FAST_NETS = ["lenet5", "alexnet", "squeezenet", "nin", "mobilenet_v1",
             "shufflenet_v2", "convmixer_lite", "vgg11", "resnet18",
             "wideresnet16_4", "densenet63"]
MID_NETS = ["vgg13", "vgg16", "resnet34", "se_resnet18", "mobilenet_v2",
            "shufflenet_v1", "googlenet", "preact_resnet18",
            "efficientnet_lite0", "resnext29", "inception_v3_lite",
            "se_resnet34", "stochastic_depth34", "resnet50"]
SLOW_NETS = ["vgg19", "resnet101", "resnet152", "preact_resnet152"]
ZOO_GRID = ([dict(name=n, batch=b, image=32) for n in FAST_NETS for b in (8, 32)]
            + [dict(name=n, batch=16, image=24) for n in FAST_NETS]
            + [dict(name=n, batch=16, image=32, optimizer="adam") for n in FAST_NETS]
            + [dict(name=n, batch=16, image=32) for n in MID_NETS]
            + [dict(name=n, batch=8, image=24) for n in MID_NETS]
            + [dict(name=n, batch=8, image=32) for n in SLOW_NETS])
RANDOM_CNN_SEEDS = range(12)  # collect.py's random_grid: batch 8 + 8 * (seed % 3), 32 px
# collect.py's lm_grid (its LM_ARCHS, copied) and random_grid's rand_lm seeds
# 0-11 (7 and 11 are MoE draws), reduced or drawn in fp32, each profiled at
# (2, 64) with steps=2
LM_GRID_ARCHS = ["qwen2-0.5b", "chatglm3-6b", "phi4-mini-3.8b", "mamba2-370m",
                 "whisper-tiny", "moonshot-v1-16b-a3b", "jamba-v0.1-52b",
                 "llama-3.2-vision-90b"]
RANDOM_LM_SEEDS = range(12)
LM_POINT = (2, 64)
LM_PROFILE_STEPS = 2
ZOO_PROFILE_STEPS = 2  # collect.py profiles with steps=2
ZOO_CHECK_BATCH = 8
# The zoo step on the card against the CPU's float64 step (gradient errors
# relative to the largest gradient). In float64 the card computes the same
# function: within 1e-10 (4.1e-12 seen, resnet152's logits). In fp32 the card
# may be four times as far from float64 as the CPU's fp32 step is, or
# ZOO_CHECK_FLOOR, well below TF32's ~1e-3 (fp32 rounding in the deep BN nets
# moves gradients by up to 6% on both devices, resnet152). Three nets' fp32
# gradients leave that rule on the card (H100 80GB HBM3, 700 W): alexnet
# 1.25e-2 against the CPU's 1.2e-6 and vgg19 1.01e-3 against 3.9e-6, both
# within the rule with cuDNN off; shufflenet_v1 5.13e-3 against 2.5e-6, and
# 4.4e-3 with cuDNN off too. The per-layer check (``zoo_layer_check``) names
# the op: in each net one BN output, within 1e-5 of the layer's largest
# output from zero, lands on the other side of zero from the float64 step's,
# so the ReLU after it passes (or stops) one gradient element that float64
# stops (or passes); every forward output stays within the rule. The CPU's
# fp32 step flips other such elements in other nets. cuDNN's deterministic
# algorithms and fp32 precision "ieee" change no digit. Each net has a named
# gradient allowance, and its step is rerun with cuDNN off: held to the
# rule, or again to the allowance where the second field is False.
ZOO_CHECK_F64_TOL = 1e-10
ZOO_CHECK_FACTOR = 4.0
ZOO_CHECK_FLOOR = 2e-5
ZOO_FP32_ALLOWANCE = {"alexnet": (2e-2, True), "vgg19": (2e-3, True),
                      "shufflenet_v1": (1e-2, False)}
# Queue C item 1: the per-layer check of these nets' fp32 step on the card
# under each cuDNN setting: (cuDNN on, deterministic algorithms, fp32
# precision "ieee" set explicitly)
ZOO_LAYER_NETS = ("alexnet", "vgg19", "shufflenet_v1")
ZOO_LAYER_SETTINGS = {"cudnn": (True, False, False),
                      "cudnn deterministic": (True, True, False),
                      "cudnn, fp32_precision ieee": (True, False, True),
                      "cudnn off": (False, False, False)}
IN_SAMPLE_MRE_MAX = 1.0  # the reference's tests/test_system.py bound

# phase 12: the online query. The service's predictor never sees qwen2-0.5b,
# whose phase 10 records are the truth for its answers at PROFILE_POINTS; the
# three dense configs and the MoE moonshot-v1-16b-a3b are asked about at
# (8, 2048) at full width, the FLOPs by the reference's online formula, 6 x
# active parameters x batch x seq. Warm queries must be 10x faster than cold
# at the median, the reference's target (benchmarks/bench_service.py).
# chatglm3-6b is then served through the flash-attention (head_dim 128, 16:1
# grouped KV) and RMSNorm kernels.
SERVICE_UNSEEN = "qwen2-0.5b"
SERVICE_ARCHS = ["chatglm3-6b", "phi4-mini-3.8b", "qwen2.5-32b", "moonshot-v1-16b-a3b"]
SERVICE_POINT = (8, 2048)
# depths of the asked-about configs cut for the script's time (full width,
# fewer layers): a cold query is a fake-tensor trace whose time grows with the
# layers (moonshot-v1-16b-a3b's 48 took 51.1 s, qwen2.5-32b's 64 46.9 s in run
# B, PR 18; the five keys of chatglm3-6b, phi4-mini-3.8b and qwen2-0.5b
# together 98.3 s); phase 14 answers whatever keys phase 12 stored
SERVICE_DEPTH = {"chatglm3-6b": 4, "phi4-mini-3.8b": 4, "qwen2.5-32b": 4,
                 "moonshot-v1-16b-a3b": 4}
WARM_SPEEDUP_MIN = 10.0
CHATGLM_ATTN_SHAPE = (8, 2081, 32, 128)  # chatglm3-6b's serving prefill: 32 heads of 128
# phase 13: the MoE, hybrid, VLM and audio archs at full width, each
# (arch, depth of the fp32 check, depth served in bf16, decode steps of the
# fp32 check), None for the config's own depth: moonshot-v1-16b-a3b served
# whole (48 layers), arctic-480b, jamba-v0.1-52b and llama-3.2-vision-90b cut
# to one period of their layer pattern (1, 8 and 5 layers), whisper-tiny whole
PHASE13 = [("moonshot-v1-16b-a3b", 2, None, 2), ("arctic-480b", 1, 1, 2),
           ("jamba-v0.1-52b", 8, 8, 3), ("llama-3.2-vision-90b", 5, 5, 2),
           ("whisper-tiny", None, None, 2)]
GATE = 0.5  # llama-3.2-vision's cross-attention gate in the checks and serving (0 at init)
MOONSHOT_ATTN_SHAPE = (8, 2081, 16, 128)  # its serving prefill: 16 heads of 128, 16 KV heads
JAMBA_SSD_SHAPE = (8, 2081, 128, 64, 16, 64)  # its serving prefill: 128 heads, P 64, N 16
SERVE_BATCH, PROMPT, STEPS = 8, 2048, 32
MODEL_CHECK_BATCH, MODEL_CHECK_SEQ = 2, 300  # ragged against the kernels' 32- and 64-row tiles
# phase 14: the serving fleet around phase 12's service. Two in-process
# gateway replicas and one RPC replica share phase 12's trace store and one
# feedback store; phase 12's keys come in one burst from FLEET_TENANTS,
# FLEET_REPEATS times each, and are answered from the store with no trace;
# the qwen2-0.5b jobs are admitted on one card and run as in phase 10, their
# measured costs reported, the predictor refit and published as generation 1.
# A burst's micro-batches run the ensembles over several rows at once, which
# moves an estimate by a few ulps against phase 12's one-row pass: the burst's
# estimates hold to FLEET_BATCH_RTOL, the one-query-a-tick answers exactly.
FLEET_TENANTS = ("tenant-a", "tenant-b", "tenant-c")
FLEET_REPEATS = 2
# the jobs admitted and run: phase 10's main point only, cut from its three
# for the script's time (each job is a ~21 s profile_lm call, and the refit
# takes ~37 s on the host: 1091 s of command with all three, on an NVIDIA
# H100 80GB HBM3 at 700 W)
FLEET_JOB_POINTS = [(8, 2048)]
FLEET_BATCH_RTOL = 1e-12
FLEET_STARTUP_TIMEOUT = 120.0  # seconds for the RPC child to import torch and listen
# phase 15: the training launcher on qwen2-0.5b (bf16, 24 layers, remat
# "full") at phase 10's (4, 1024), where its step took 0.3548 s (run B, PR
# 18; NVIDIA H100 80GB HBM3, 700 W). TRAIN_STEPS steps in process, a
# checkpoint every TRAIN_CKPT_EVERY (under TRAIN_DIR, removed at the end),
# the step calls of TRAIN_FAIL_CALLS failing once each; then the launcher
# resumed from the first checkpoint in a child process. A checkpoint of the
# state is 14 bytes a parameter (bf16 params, fp32 master, m and v): the
# phase needs the free disk of TRAIN_DISK_CKPTS of them.
TRAIN_POINT = (4, 1024)
TRAIN_STEPS = 6
TRAIN_CKPT_EVERY = 3
TRAIN_FAIL_CALLS = (2,)
TRAIN_DISK_CKPTS = 3
PHASE10_STEP_S = 0.3548
TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train")
TRAIN_CKPT_DIR = os.path.join(TRAIN_DIR, "ckpt")
TRAIN_CHILD_TIMEOUT = 600.0
# phase 18: the port's examples as a user runs them, children on the card
# beside phase 15's launcher child, both at once, within EXAMPLES_WALL_S
EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "examples")
EXAMPLES_WALL_S = 60.0
EXAMPLE_RUNS = {"serve_lm_torch.py": (), "train_lm_torch.py": ("--steps", "20")}
# phase 16: benchmarks/bench_scenarios.py's composed scenario at its smoke
# size (composed_spec(smoke=True), copied: the port imports nothing of
# benchmarks/), on its fleet of four in-process replicas, replayed as fast as
# possible; the schedule's digest also from children under these
# PYTHONHASHSEEDs (its HASH_SEEDS)
SCENARIO_HASH_SEEDS = (0, 4242)
SCENARIO_REPLICAS = 4
SCENARIO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "scenario")

# phase 17: the sharded runtime. The Trainer on a (1, 1) DeviceMesh (NCCL)
# at phase 15's point and seed for SHARDED_STEPS steps, in a child process
# (the parent forks fit workers and spawns RPC children, so no NCCL group
# lives in it), against the unsharded Trainer run first in the same child;
# the compressed all-reduce over that one-rank group timed COMPRESS_REPS
# times; and the dry run of qwen2-0.5b's train_4k cell ("dp") on a fake
# 256-rank (16, 16) world beside phase 15's child, at DRYRUN_DEPTH layers:
# torch 2.11 on the H100 machine's host traces the full 24 in 117-151 s, 12 in 65-75.
SHARDED_STEPS = 3
SHARDED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "sharded")
SHARDED_CHILD_TIMEOUT = 900.0
COMPRESS_REPS = 5
DRYRUN_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "dryrun.jsonl")
DRYRUN_CELL = ("qwen2-0.5b", "train_4k", "dp")
DRYRUN_TIMEOUT = 600.0
DRYRUN_DEVICES = 256
DRYRUN_DEPTH = 12
# a qwen2-0.5b layer: q and o 896 x 896, k and v 896 x 128, their biases
# 896 + 2 x 128, the MLP 3 x 896 x 4864, two norms 2 x 896
QWEN_LAYER_PARAMS = 14_912_384
DRYRUN_PARAMS = QWEN_PARAMS - (24 - DRYRUN_DEPTH) * QWEN_LAYER_PARAMS
# the dry run's all-reduce bytes over the gradients' (1.43 at 12 layers: the
# tied table is reduced once for each of its two uses)
GRAD_AR_MAX = 1.5
# the dry run's entry point, its config cut to DRYRUN_DEPTH layers
DRYRUN_MAIN = ("import dataclasses, sys\n"
               "import repro_torch.launch.dryrun as dr\n"
               "full = dr.get_config\n"
               "dr.get_config = lambda arch: dataclasses.replace(full(arch), "
               f"num_layers={DRYRUN_DEPTH})\n"
               "sys.exit(dr.main(sys.argv[1:]))\n")

DEVICE = "cuda"
SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's 1.98 GHz boost clock


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Device time of one call of ``fn``, by CUDA events around ``reps`` calls.
    The calls are queued behind a 10 ms spin of the card, so they run back to
    back and the host's time between launches, which for a call on a few MB
    exceeds the kernels' own, is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(bh: int, sq: int, sk: int, d: int, causal: bool, dtype_bytes: int,
                       peak_flops: float, kv_share: float = 1.0):
    """Least time for the work: 4*d FLOP per (query, key) pair the mask keeps,
    against q, k, v read once and o written once; ``kv_share`` is KV / H
    where grouped K/V are read unexpanded."""
    if causal:  # top-left aligned: query i keeps keys 0..min(i, sk-1)
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4.0 * d * pairs * bh
    nbytes = float(dtype_bytes) * bh * d * (2 * sq + 2 * sk * kv_share)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(torch, F, fa, kops, attention_ref):
    print("== phase 2: flash-attention kernel vs plain on the card")
    bhsd = None
    for (b, s, h, hd) in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                gen = torch.Generator(device=DEVICE).manual_seed(b * 1000 + s + hd)
                q, k, v = (torch.randn((b * h, s, hd), generator=gen, device=DEVICE)
                           .to(dtype) for _ in range(3))
                got = fa.flash_attention_bhsd(q, k, v, causal=causal)
                want = attention_ref(q, k, v, causal)
                torch.cuda.synchronize()
                name = str(dtype).replace("torch.", "")
                tol = TOL[name]
                diff = (got.float() - want.float()).abs()
                err = diff.max().item()
                excess = (diff - (tol + tol * want.float().abs())).max().item()
                check(excess <= 0, f"kernel {b, s, h, hd} {name} causal={causal}: "
                                   f"max abs err {err} over tol {tol}")
                ms = time_ms(torch, lambda: fa.flash_attention_bhsd(q, k, v, causal=causal))
                plain_ms = time_ms(torch, lambda: attention_ref(q, k, v, causal))
                q4, k4, v4 = (x.view(b, h, s, hd) for x in (q, k, v))
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal))
                peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
                bound, by = attention_bound_ms(b * h, s, s, hd, causal, q.element_size(), peak)
                print(f"kernel (b,s,h,hd)={b, s, h, hd} {name} causal={causal}: "
                      f"max_abs_err={err:.3e} (tol {tol}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"sdpa_ms={lib_ms:.4f} bound_ms={bound:.4f} ({by})")
                if (b, s, h, hd) == MAIN_SHAPE and dtype == torch.bfloat16 and causal:
                    bhsd = dict(ms=ms, library_ms=lib_ms)
                del q, k, v, got, want, diff
    check(bhsd is not None, "main-path flash-attention shape was not run")
    query_block_check(torch, kops, attention_ref)
    return model_layout_main(torch, F, kops, attention_ref, bhsd)


def query_block_check(torch, kops, attention_ref, shape=MAIN_SHAPE, kv=MAIN_KV_HEADS,
                      ranks: int = 16):
    """The kernel on a rank's block of the queries against whole grouped K/V,
    as a sharded prefill runs it where the heads do not divide the "model"
    dim (``causal_attention(q_offset=)``): the first, a middle and the last
    of ``ranks`` blocks at ``shape``, held against ``attention_ref``'s rows
    of that block on the whole queries (the plain version without the
    offset)."""
    b, s, h, hd = shape
    n = -(-s // ranks)
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=DEVICE).manual_seed(11)
        q = torch.randn((b, s, h, hd), generator=gen, device=DEVICE).to(dtype)
        k, v = (torch.randn((b, s, kv, hd), generator=gen, device=DEVICE).to(dtype)
                for _ in range(2))
        flat = [t.transpose(1, 2).reshape(b * h, s, hd)
                for t in (q, *(t.repeat_interleave(h // kv, dim=2) for t in (k, v)))]
        whole = attention_ref(*flat, True).reshape(b, h, s, hd).transpose(1, 2)
        name = str(dtype).replace("torch.", "")
        tol = TOL[name]
        for first in (0, (ranks // 2) * n, (ranks - 1) * n):
            block = q[:, first:first + n].contiguous()
            got = kops.flash_attention(block, k, v, causal=True, q_offset=first)
            want = whole[:, first:first + n]
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            check((diff - (tol + tol * want.float().abs())).max().item() <= 0,
                  f"query block {first}:{first + got.shape[1]} of {shape} {name}: "
                  f"max abs err {err} over tol {tol}")
            line = f"query block {first}:{first + got.shape[1]} of {shape} {name} causal " \
                   f"q_offset={first}: max_abs_err={err:.3e} (tol {tol})"
            if dtype == torch.bfloat16 and first == (ranks - 1) * n:
                ms = time_ms(torch, lambda: kops.flash_attention(block, k, v, causal=True,
                                                                 q_offset=first))
                line += f" ms={ms:.4f}"
            print(line)
        del q, k, v, flat, whole


def model_layout_main(torch, F, kops, attention_ref, bhsd, shape=MAIN_SHAPE, kv=MAIN_KV_HEADS):
    """A main path's call: ``kernels.ops.flash_attention`` on q (B, S, H, d)
    and grouped k/v (B, S, KV, d) as the model makes them, against
    ``attention_ref`` on K/V expanded to H heads; timed beside the (BH, S, d)
    kernel call (``bhsd``, where given), SDPA and the bound. At ``MAIN_SHAPE``
    its numbers are the kernel's entry in the ``kernels`` line."""
    b, s, h, hd = shape
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    q = torch.randn((b, s, h, hd), generator=gen, device=DEVICE).bfloat16()
    k, v = (torch.randn((b, s, kv, hd), generator=gen, device=DEVICE).bfloat16()
            for _ in range(2))
    got = kops.flash_attention(q, k, v, causal=True)
    expanded = [t.repeat_interleave(h // kv, dim=2) for t in (k, v)]
    flat = [t.transpose(1, 2).reshape(b * h, s, hd) for t in (q, *expanded)]
    want = attention_ref(*flat, True).reshape(b, h, s, hd).transpose(1, 2)
    torch.cuda.synchronize()
    tol = TOL["bfloat16"]
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    check((diff - (tol + tol * want.float().abs())).max().item() <= 0,
          f"model-layout kernel {shape} KV {kv}: max abs err {err} over tol {tol}")
    ms = time_ms(torch, lambda: kops.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: attention_ref(*flat, True))
    q4, k4, v4 = (t.view(b, h, s, hd) for t in flat)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    bound, by = attention_bound_ms(b * h, s, s, hd, True, 2, H100_BF16_FLOPS, kv / h)
    beside = (f" (B*H, S, d) ms={bhsd['ms']:.4f} sdpa_ms (B*H, S, d) "
              f"{bhsd['library_ms']:.4f}" if bhsd else "")
    print(f"shape {shape} bf16 causal, model layout with {kv} KV heads: "
          f"max_abs_err={err:.3e} (tol {tol}) ms={ms:.4f}{beside} sdpa_ms={lib_ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


def modality_inputs(torch, cfg, b: int, dtype, seed: int = 5) -> dict:
    """``cfg``'s stub memory on the card, drawn from ``seed``: image
    ``patches`` for a cross-attention config, audio ``frames`` for an
    encoder-decoder one (both frontends are stubs, as in the reference)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = {}
    if cfg.cross_every:
        out["patches"] = torch.randn((b, cfg.vision_seq, cfg.d_model), generator=gen,
                                     device=DEVICE).to(dtype)
    if cfg.is_encoder_decoder:
        out["frames"] = torch.randn((b, cfg.audio_seq, cfg.d_model), generator=gen,
                                    device=DEVICE).to(dtype)
    return out


def build_seeded(torch, build_model, cfg):
    """``cfg``'s model on the card from seed 0, with every cross-attention
    gate set to ``GATE`` (zero at init, which would hide the layer)."""
    model = build_model(cfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    with torch.no_grad():
        for layer in model.layers:
            if hasattr(layer, "gate_attn"):
                layer.gate_attn.fill_(GATE)
    return model


def model_check_phase(torch, label, cfg_full, build_model, all_plain, steps, depth=None):
    """``cfg_full`` at full width and ``depth`` layers (default: all) in fp32:
    prefill logits through the kernels against every kernel pinned plain,
    then prefill -> ``steps`` decode steps against the full forward, both at
    ``MODEL_TOL``. A sequence and one token are grouped differently, so with
    MoE teacher forcing holds only where no token is dropped: the model is
    rebuilt from the same seed with a capacity of the whole group (capacity
    factor E / k). The reference's test takes 8 at its reduced size; at
    arctic-480b's full width 8 leaves 64 slots of a 512-token group, fewer
    than an untrained router may send one expert."""
    depth = depth or cfg_full.num_layers
    print(f"== {label}: {cfg_full.name} full width, {depth} of {cfg_full.num_layers} layers, "
          f"fp32 (TF32 off): kernels vs plain, prefill -> {steps} decode steps")
    cfg = dataclasses.replace(cfg_full, dtype="float32", num_layers=depth)
    model = build_seeded(torch, build_model, cfg)
    b, s = MODEL_CHECK_BATCH, MODEL_CHECK_SEQ
    tokens = (torch.arange(b * s, device=DEVICE).reshape(b, s) * 7) % (cfg.vocab_size - 1)
    memory = modality_inputs(torch, cfg, b, torch.float32)
    with torch.no_grad():
        with all_plain():
            plain, _ = model.prefill({"tokens": tokens, **memory})
        kern, cache = model.prefill({"tokens": tokens, **memory})
        err = (kern - plain).abs().max().item()
        vocab_rows = -(-cfg.vocab_size // 256) * 256
        check(kern.shape == (b, 1, vocab_rows), f"prefill logits shape {tuple(kern.shape)}")
        check(bool(torch.isfinite(kern[..., :cfg.vocab_size]).all()), "non-finite logits")
        check(torch.allclose(kern, plain, atol=MODEL_TOL, rtol=MODEL_TOL),
              f"prefill kernel vs plain: max abs err {err}")
        print(f"prefill logits kernel vs plain: max_abs_err={err:.3e} (tol {MODEL_TOL})")
        if cfg.num_experts:
            del model, cache
            torch.cuda.empty_cache()
            cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
            model = build_seeded(torch, build_model, cfg)
            _, cache = model.prefill({"tokens": tokens, **memory})
            print(f"teacher forcing at capacity_factor {cfg.capacity_factor:.4g} = experts / "
                  f"top_k: a capacity of the whole group, no token dropped")

        nxt = (torch.arange(b * steps, device=DEVICE).reshape(b, steps) * 3 + 1) % cfg.vocab_size
        full, _ = model.forward({"tokens": torch.cat([tokens, nxt], dim=1), **memory})
        # self-attention caches get room for the steps (the engine's
        # prompt-sized cache has none); a cross layer's memory K/V and the
        # SSM state keep their shapes
        cache = [{n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, steps))
                  if n in ("k", "v") and t.shape[1] == s else t for n, t in c.items()}
                 for c in cache]
        for i in range(steps):
            step, cache = model.decode_step(
                cache, nxt[:, i:i + 1], torch.full((b,), s + i, dtype=torch.int32, device=DEVICE))
            err = (step[:, 0] - full[:, s + i]).abs().max().item()
            check(torch.allclose(step[:, 0], full[:, s + i], atol=MODEL_TOL, rtol=MODEL_TOL),
                  f"prefill -> decode step {i} vs forward: max abs err {err}")
            print(f"prefill -> decode step {i} vs forward (teacher forcing): "
                  f"max_abs_err={err:.3e} (tol {MODEL_TOL})")
    del model, cache
    torch.cuda.empty_cache()


def reset_counts(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(counters) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def serve_phase(torch, label, cfg, build_model, DecodeEngine, counters, expect, expect_decode):
    """Serve ``cfg`` in bf16 through ``DecodeEngine`` twice; ``counters`` maps a
    kernel's name to its wrapper module and counter, set to 0 just before the
    prefill and read just after it and after the decode steps; ``expect`` and
    ``expect_decode`` give each kernel's launches per prefill and over the
    decode steps. Returns the launch counts of the first run's prefill."""
    print(f"== {label} (main path): {cfg.name} bf16 full width, {cfg.num_layers} layers, "
          f"through DecodeEngine")
    model = build_seeded(torch, build_model, cfg)
    total = PROMPT + STEPS + 1
    prompts = ((torch.arange(SERVE_BATCH * total, device=DEVICE).reshape(SERVE_BATCH, total)
                * 13) % (cfg.vocab_size - 1))
    prompts[:, PROMPT:] = 0
    inputs = {"tokens": prompts, **modality_inputs(torch, cfg, SERVE_BATCH, model.dtype)}

    def serve_once():
        engine = DecodeEngine(model, batch=SERVE_BATCH, max_seq=total)
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        first = engine.prefill(inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = read_counts(counters)
        reset_counts(counters)
        out = engine.generate(first, STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        decode = read_counts(counters)
        check(decode == expect_decode, f"kernel launches over {STEPS} decode steps {decode}, "
                                       f"want {expect_decode}")
        print(f"kernel launches over the {STEPS} decode steps: {decode}")
        return out, launches, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / STEPS, engine

    runs, engine = [], None
    for i in range(2):
        engine = None  # drop the last run's cache so the peak below is this run's
        torch.cuda.reset_peak_memory_stats()
        out, launches, prefill_ms, decode_ms, engine = serve_once()
        peak = torch.cuda.max_memory_allocated()
        card_bytes = torch.cuda.get_device_properties(0).total_memory
        counts = " ".join(f"{name}_launches={n}" for name, n in launches.items())
        print(f"serve run {i}: prefill_ms={prefill_ms:.3f} decode_ms_per_token={decode_ms:.3f} "
              f"{counts} max_memory_allocated={peak} ({peak / 2**30:.3f} GiB, {peak / 1e9:.2f} "
              f"of the card's {card_bytes / 1e9:.2f} GB)")
        check(launches == expect, f"kernel launches per prefill {launches}, want {expect}")
        check(out.shape == (SERVE_BATCH, STEPS + 1), f"tokens shape {tuple(out.shape)}")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token out of vocab")
        runs.append((out, launches, prefill_ms, decode_ms))
    check(torch.equal(runs[0][0], runs[1][0]), "two serve runs gave different tokens")
    print(f"serve tokens deterministic over 2 runs; request 0: {runs[1][0][0].tolist()}")
    profile_device(torch, "prefill", lambda: model.prefill(inputs),
                   wall_ms=runs[1][2])
    last = runs[1][0][:, -1]
    profile_device(torch, "decode step", lambda: engine.step(last), wall_ms=runs[1][3], reps=4)
    del model, engine
    torch.cuda.empty_cache()
    return runs[0][1]


def attention_ops_listing(torch, cfg) -> None:
    """Phase 4's listing: every aten op that runs in a prefill layer's causal
    attention on the card, on q, k, v as the layer makes them (q (B, S, H, d),
    k and v with their KV heads). Only the output's allocation may run beside
    the kernel: no expand, transpose or copy of q, k, v or o."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import attention as tattn
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    b, s = SERVE_BATCH, PROMPT + STEPS + 1
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {name: (0.05 * torch.randn(shape, generator=gen, device=DEVICE)).bfloat16()
         for name, shape in (("wq", (d, h * hd)), ("wk", (d, kv * hd)), ("wv", (d, kv * hd)),
                             ("bq", (h * hd,)), ("bk", (kv * hd,)), ("bv", (kv * hd,)))}
    x = torch.randn((b, s, d), generator=gen, device=DEVICE).bfloat16()
    pos = torch.arange(s, device=DEVICE)[None, :]
    q = tattn._apply_rope(cfg, tattn._project_q(p, cfg, x), pos)
    k, v = tattn._project_kv(p, cfg, x, x.dtype)
    k = tattn._apply_rope(cfg, k, pos)
    tattn.causal_attention(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        o = tattn.causal_attention(q, k, v)
    ops = {e.key: e.count for e in prof.key_averages() if e.key.startswith("aten::")}
    print(f"causal attention of a prefill layer: q {tuple(q.shape)} stride {q.stride()}, "
          f"k/v {tuple(k.shape)} stride {k.stride()} -> o {tuple(o.shape)} stride "
          f"{o.stride()}; aten ops around the kernel: {ops}")
    check(set(ops) <= {"aten::empty_like", "aten::empty_strided", "aten::empty"},
          f"ops besides the output's allocation around the flash kernel: {ops}")
    check(k.shape[2] == kv and o.is_contiguous(), "K/V expanded or o not in the model layout")


def ssd_bound_ms(b, l, h, p, n, chunk, dtype_bytes):
    """Least time for the scan's work: C B^T over the causal pairs of each
    chunk once per batch row (B and C are shared by the heads), and per head
    the causal G x, C_t . S_prev (chunks after the first) and the state
    update; against x and y, B, C, dt, A and the final state moved once.
    C B^T takes B and C as they come, so bf16 inputs price it at the bf16
    tensor-core peak; the decay-weighted products take fp32 operands and
    the fp32 peak."""
    q = min(chunk, l)
    sizes = [min(q, l - c0) for c0 in range(0, l, q)]
    pairs = sum(m * (m + 1) // 2 for m in sizes)
    cb_flops = 2.0 * b * pairs * n
    decay_flops = 2.0 * b * h * (pairs * p + (2 * l - sizes[0]) * n * p)
    cb_peak = H100_BF16_FLOPS if dtype_bytes == 2 else H100_FP32_FLOPS
    nbytes = (float(dtype_bytes) * (2 * b * l * h * p + 2 * b * l * n)
              + 4.0 * (b * l * h + h + b * h * n * p))
    t_ops = (cb_flops / cb_peak + decay_flops / H100_FP32_FLOPS) * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ssd_phase(torch, ssd, ssd_chunked_ref):
    """Every SSD shape against the plain version; returns the bf16 entries of
    the two serving prefills' shapes, ``SSD_MAIN`` and ``JAMBA_SSD_SHAPE``."""
    print("== phase 5: SSD chunked-scan kernel vs plain on the card")
    main = {}
    cases = [(shape, slow) for shape in SSD_SHAPES
             for slow in ((False, True) if shape in SSD_SLOW else (False,))]
    for shape, slow in cases:
        b, l, h, p, n, chunk = shape
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=DEVICE).manual_seed(b * 1000 + l + n)

            def draw(*shp):
                return torch.randn(shp, generator=gen, device=DEVICE)
            xb = (0.5 * draw(b, l, h, p)).to(dtype)
            dt = torch.nn.functional.softplus(draw(b, l, h) - (4.0 if slow else 0.0))
            a_neg = -torch.exp(0.3 * draw(h))
            bm, cm = ((0.5 * draw(b, l, n)).to(dtype) for _ in range(2))
            y, state = ssd.ssd_scan_blhp(xb, dt, a_neg, bm, cm, chunk)
            yw, sw = ssd_chunked_ref(xb.float(), dt, a_neg, bm.float(), cm.float(), chunk)
            yw = yw.to(dtype)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "") + (" slow decay" if slow else "")
            tol = SSD_TOL[str(dtype).replace("torch.", "")]
            diff = (y.float() - yw.float()).abs()
            err = diff.max().item()
            excess = (diff - (tol + tol * yw.float().abs())).max().item()
            sdiff = (state - sw).abs()
            serr = sdiff.max().item()
            sexcess = (sdiff - (2e-4 + 2e-4 * sw.abs())).max().item()
            check(excess <= 0, f"ssd kernel {shape} {name}: y max abs err {err} over tol {tol}")
            check(sexcess <= 0, f"ssd kernel {shape} {name}: state max abs err {serr} "
                                f"over tol 2e-4")
            del yw, sw, diff, sdiff
            ms = time_ms(torch, lambda: ssd.ssd_scan_blhp(xb, dt, a_neg, bm, cm, chunk))
            plain_ms = time_ms(torch, lambda: ssd_chunked_ref(xb, dt, a_neg, bm, cm, chunk),
                               reps=3, warmup=1)
            bound, by = ssd_bound_ms(b, l, h, p, n, chunk, xb.element_size())
            print(f"ssd kernel (b,l,h,p,n,chunk)={shape} {name}: y max_abs_err={err:.3e} "
                  f"(tol {tol}) state max_abs_err={serr:.3e} (tol 2e-4) ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({by})")
            if shape in (SSD_MAIN, JAMBA_SSD_SHAPE) and dtype == torch.bfloat16 and not slow:
                main[shape] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=by, library_ms=None)
            del xb, dt, a_neg, bm, cm, y, state
    torch.cuda.empty_cache()
    return main


def split_chain(torch, ssd_states, ssd_output, ssd_carry, args, cuts, chunk):
    """y and the final state of the scan over ``args`` cut into sequence
    blocks at ``cuts``, as the ranks of a sequence split run it: each
    block's states call, the carry of the blocks before it, its output
    call from that state."""
    xb, dt, a_neg, bm, cm = args
    spans = list(zip(cuts, cuts[1:]))
    blocks = [tuple(t[:, u:v].contiguous() for t in (xb, dt, bm, cm)) for u, v in spans]
    first = [ssd_states(x, d, a_neg, b, chunk) for x, d, b, _ in blocks]
    finals = torch.stack([f for _, _, f in first])
    decays = torch.stack([d.prod(1) for _, d, _ in first])
    ys, final = [], None
    for k, ((x, d, b, c), res) in enumerate(zip(blocks, first)):
        y, final = ssd_output(x, d, a_neg, b, c, chunk, *res, ssd_carry(finals, decays, k))
        ys.append(y)
    return torch.cat(ys, 1), final


def ssd_split_phase(torch, ssd, ssd_chunked_ref, ssd_carry):
    """Phase 5's split scan at both serving prefills' shapes: the chain of
    ``SPLIT_CUTS`` blocks against ``ssd_chunked_ref`` on the whole sequence,
    timed beside the one-call kernel. Returns the bf16 entries by shape."""
    main = {}
    for shape in (SSD_MAIN, JAMBA_SSD_SHAPE):
        b, l, h, p, n, chunk = shape
        cuts = SPLIT_CUTS[:-1] + (l,)
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=DEVICE).manual_seed(b * 1000 + l + n + 7)

            def draw(*shp):
                return torch.randn(shp, generator=gen, device=DEVICE)
            # slow decay, so the carried state reaches deep into each block
            args = ((0.5 * draw(b, l, h, p)).to(dtype),
                    torch.nn.functional.softplus(draw(b, l, h) - 4.0),
                    -torch.exp(0.3 * draw(h)), (0.5 * draw(b, l, n)).to(dtype),
                    (0.5 * draw(b, l, n)).to(dtype))
            y, final = split_chain(torch, ssd.ssd_states_blhp, ssd.ssd_output_blhp, ssd_carry,
                                   args, cuts, chunk)
            yw, sw = ssd_chunked_ref(*(t.float() for t in args), chunk)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            tol = SSD_TOL[name]
            diff = (y.float() - yw.to(dtype).float()).abs()
            err = diff.max().item()
            excess = (diff - (tol + tol * yw.to(dtype).float().abs())).max().item()
            sdiff = (final - sw).abs()
            serr = sdiff.max().item()
            sexcess = (sdiff - (2e-4 + 2e-4 * sw.abs())).max().item()
            check(excess <= 0, f"split ssd {shape} {name}: y max abs err {err} over tol {tol}")
            check(sexcess <= 0, f"split ssd {shape} {name}: state max abs err {serr} over 2e-4")
            del yw, sw, diff, sdiff
            ms = time_ms(torch, lambda: split_chain(torch, ssd.ssd_states_blhp,
                                                    ssd.ssd_output_blhp, ssd_carry, args,
                                                    cuts, chunk))
            one_ms = time_ms(torch, lambda: ssd.ssd_scan_blhp(*args, chunk))
            plain_ms = time_ms(torch, lambda: ssd_chunked_ref(*args, chunk), reps=3, warmup=1)
            bound, by = ssd_bound_ms(b, l, h, p, n, chunk, args[0].element_size())
            print(f"ssd split kernel (b,l,h,p,n,chunk)={shape} {name}, blocks {cuts}: y "
                  f"max_abs_err={err:.3e} (tol {tol}) state max_abs_err={serr:.3e} (tol 2e-4) "
                  f"chain_ms={ms:.4f} one_call_ms={one_ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound:.4f} ({by})")
            if dtype == torch.bfloat16:
                main[shape] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=by, library_ms=None, one_call_ms=one_ms)
            del args, y, final
    torch.cuda.empty_cache()
    return main


def split_prefill_phase(torch, cfg, build_model, ssd):
    """Phase 7's sequence-split layers: every Mamba2 layer of ``cfg`` (bf16,
    full width, seed 0) at (``SERVE_BATCH``, ``PROMPT``) run as
    ``SPLIT_BLOCKS`` ranks of a sequence split run it
    (``ssm.apply_ssm_blocks``), with the split scan's launches set to 0
    just before and read just after; then each layer's output and cache
    against the one-call layer (``ssm.apply_ssm``) at 2e-2. Returns the
    launches."""
    from repro_torch.models import ssm
    print(f"== phase 7 (the sequence-split path): {cfg.name} bf16 full width, "
          f"{cfg.num_layers} Mamba2 layers at ({SERVE_BATCH}, {PROMPT}) over {SPLIT_BLOCKS} "
          f"sequence blocks")
    model = build_seeded(torch, build_model, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    x = torch.randn((SERVE_BATCH, PROMPT, cfg.d_model), generator=gen,
                    device=DEVICE).to(model.dtype)
    mixers = [{k: v for k, v in layer.mixer.items()} for layer in model.layers]
    with torch.no_grad():
        torch.cuda.synchronize()
        ssd.split_launches = 0
        t0 = time.perf_counter()
        split = [ssm.apply_ssm_blocks(p, cfg, x, SPLIT_BLOCKS) for p in mixers]
        torch.cuda.synchronize()
        split_s = time.perf_counter() - t0
        launches = ssd.split_launches
        t0 = time.perf_counter()
        whole = [ssm.apply_ssm(p, cfg, x, return_cache=True) for p in mixers]
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
    want = 2 * SPLIT_BLOCKS * len(mixers)
    check(launches == want, f"split scan launches {launches}, expected {want}")
    err = 0.0
    for i, ((y, cache), (yw, cw)) in enumerate(zip(split, whole)):
        for name, got, ref in [("y", y, yw)] + [(k, cache[k], cw[k]) for k in cw]:
            diff = (got.float() - ref.float()).abs()
            excess = (diff - (2e-2 + 2e-2 * ref.float().abs())).max().item()
            err = max(err, diff.max().item())
            check(excess <= 0, f"split layer {i} {name}: max abs err {diff.max().item()}")
    print(f"sequence-split layers: {launches} split-scan launches, max abs err {err:.3e} "
          f"(tol 2e-2) against the one-call layers; {split_s * 1e3:.1f} ms split, "
          f"{whole_s * 1e3:.1f} ms one-call, host clock")
    del model, split, whole, x
    torch.cuda.empty_cache()
    return launches


def rms_bound_ms(r: int, d: int, dtype_bytes: int, backward: bool):
    """Least time for the work: the forward reads x and gain and writes y
    (2 R D elements + 4 D bytes), about 4 FLOP an element; the backward reads
    x, dy and gain and writes dx and dgain (3 R D elements + 8 D bytes),
    about 8 FLOP an element, all at the fp32 rate."""
    nbytes = (3.0 if backward else 2.0) * r * d * dtype_bytes + (8.0 if backward else 4.0) * d
    flops = (8.0 if backward else 4.0) * r * d
    t_ops, t_bytes = flops / H100_FP32_FLOPS * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rmsnorm_phase(torch, F, rn, rmsnorm_ref):
    print("== phase 8: RMSNorm forward and backward kernels vs plain on the card")
    main = {}
    for (r, d) in RMS_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            tol = RMS_TOL[name]
            gen = torch.Generator(device=DEVICE).manual_seed(r * 7 + d)
            x = torch.randn((r, d), generator=gen, device=DEVICE).to(dtype)
            g = 1 + 0.1 * torch.randn((d,), generator=gen, device=DEVICE)
            dy = torch.randn((r, d), generator=gen, device=DEVICE).to(dtype)
            y, rstd = rn.rmsnorm_fwd(x, g)
            dx, dgain = rn.rmsnorm_bwd(x, g, rstd, dy)
            xr, gr = x.float().requires_grad_(True), g.clone().requires_grad_(True)
            want = rmsnorm_ref(xr, gr)
            want_dx, want_dg = torch.autograd.grad(want, (xr, gr), dy.float())
            torch.cuda.synchronize()
            errs = {}
            for what, got, ref in (("y", y, want.detach().to(dtype)),
                                   ("dx", dx, want_dx.to(dtype))):
                diff = (got.float() - ref.float()).abs()
                errs[what] = diff.max().item()
                excess = (diff - (tol + tol * ref.float().abs())).max().item()
                check(excess <= 0, f"rmsnorm {what} {(r, d)} {name}: max abs err {errs[what]} "
                                   f"over tol {tol}")
            scale = want_dg.abs().max().item()
            errs["dgain"] = (dgain - want_dg).abs().max().item()
            check(errs["dgain"] <= DGAIN_TOL * scale,
                  f"rmsnorm dgain {(r, d)} {name}: max abs err {errs['dgain']} over "
                  f"{DGAIN_TOL} x {scale}")
            del xr, gr, want, want_dx, want_dg
            print(f"rmsnorm (r,d)={r, d} {name}: y max_abs_err={errs['y']:.3e} (tol {tol}) "
                  f"dx max_abs_err={errs['dx']:.3e} (tol {tol}) dgain max_abs_err="
                  f"{errs['dgain']:.3e} (tol {DGAIN_TOL} x {scale:.3e})")
            if (r, d) == RMS_MAIN and dtype == torch.bfloat16:
                main = rmsnorm_times(torch, F, rn, rmsnorm_ref, x, g, dy, rstd, errs)
            del x, g, dy, y, rstd, dx, dgain
    torch.cuda.empty_cache()
    return main


def rmsnorm_times(torch, F, rn, rmsnorm_ref, x, g, dy, rstd, errs) -> dict:
    """Kernel, plain and ``F.rms_norm`` times, forward and backward, at the
    main shape, with the card's bound: the two kernels' entries of the
    ``kernels`` line."""
    r, d = x.shape
    xq, gq = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    yq = rmsnorm_ref(xq, gq)
    gl = g.to(x.dtype)  # F.rms_norm takes its weight in x's dtype
    xl, glr = x.clone().requires_grad_(True), gl.clone().requires_grad_(True)
    yl = F.rms_norm(xl, (d,), glr, 1e-6)
    calls = {  # (forward, backward) of the kernels, the plain version, F.rms_norm
        "kernel": (lambda: rn.rmsnorm_fwd(x, g), lambda: rn.rmsnorm_bwd(x, g, rstd, dy)),
        "plain": (lambda: rmsnorm_ref(x, g),
                  lambda: torch.autograd.grad(yq, (xq, gq), dy, retain_graph=True)),
        "rms_norm": (lambda: F.rms_norm(x, (d,), gl, 1e-6),
                     lambda: torch.autograd.grad(yl, (xl, glr), dy, retain_graph=True)),
    }
    ms = {k: [time_ms(torch, f) for f in fs] for k, fs in calls.items()}
    bounds = [rms_bound_ms(r, d, x.element_size(), backward=bw) for bw in (False, True)]
    main = {}
    for i, (kname, err) in enumerate((("rmsnorm_fwd", errs["y"]), ("rmsnorm_bwd", errs["dx"]))):
        print(f"  {kname} at {(r, d)} {str(x.dtype).replace('torch.', '')}: "
              f"ms={ms['kernel'][i]:.4f} plain_ms={ms['plain'][i]:.4f} "
              f"rms_norm_ms={ms['rms_norm'][i]:.4f} bound_ms={bounds[i][0]:.4f} "
              f"({bounds[i][1]})")
        main[kname] = dict(max_abs_err=err, ms=ms["kernel"][i], plain_ms=ms["plain"][i],
                           bound_ms=bounds[i][0], bound_by=bounds[i][1],
                           library_ms=ms["rms_norm"][i])
    return main


def adam_param_excess(torch, got, want, g_a, g_b, clip_a, clip_b, lr: float,
                      eps: float) -> float:
    """How far two parameters after one AdamW step (count 1) differ beyond
    1e-6 plus what their gradients' difference allows. The step moves a
    parameter by lr * u(g c) plus the same weight decay, with c the clip
    factor and u(g) = g / (|g| + eps), whose slope eps / (|g| + eps)^2 is
    largest at the smaller |g| of the two; where the two gradients differ
    in sign, u may differ by its whole range, 2."""
    a, b = g_a.float() * clip_a, g_b.float() * clip_b
    slope = eps / (torch.minimum(a.abs(), b.abs()) + eps) ** 2
    allowed = 1e-6 + lr * torch.where(a * b >= 0, (a - b).abs() * slope, 2.0)
    return ((got.float() - want.float()).abs() - allowed).max().item()


def train_check_phase(torch, cfg_full, build_model, use_impls, topt, tstep, counters):
    print(f"== phase 9: {cfg_full.name} full width, fp32 (TF32 off, remat full): one train "
          f"step through the RMSNorm kernels vs plain")
    cfg = dataclasses.replace(cfg_full, dtype="float32", remat="full")
    model = build_model(cfg, device=DEVICE)
    opt = topt.OptConfig(lr=TRAIN_LR, warmup_steps=1)
    state = tstep.init_state(model, opt, torch.Generator(device=DEVICE).manual_seed(0))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    b, s = TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ
    batch = {k: torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=DEVICE)
             for k in ("tokens", "labels")}
    step = tstep.make_train_step(model, opt)
    torch.cuda.synchronize()
    reset_counts(counters)
    new_k, m_k = step(state, batch)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    with use_impls(norm="plain"):
        new_p, m_p = step(state, batch)
        _, _, g_p = step.compute_grads(state["params"], batch)
    _, _, g_k = step.compute_grads(state["params"], batch)
    want = step_launches(cfg)
    print(f"kernel launches in the step: {launches}")
    check(launches == want, f"train step launches {launches}, want {want}")
    for key in ("loss", "grad_norm"):
        err = abs(m_k[key].item() - m_p[key].item())
        check(err <= LOSS_TOL * (1 + abs(m_p[key].item())), f"{key} kernel {m_k[key].item()} "
                                                            f"vs plain {m_p[key].item()}")
        print(f"{key}: kernel {m_k[key].item():.7f} plain {m_p[key].item():.7f} "
              f"abs_err={err:.3e} (tol {LOSS_TOL})")
    check(bool(torch.isfinite(m_k["loss"])), "non-finite loss")
    grad_rel = max(((g_k[k].float() - g_p[k].float()).abs().max()
                    / g_p[k].float().abs().max().clamp(min=1e-30)).item() for k in g_p)
    check(grad_rel <= GRAD_TOL, f"gradients kernel vs plain: {grad_rel} of a leaf's max")
    clip_k, clip_p = (min(1.0, opt.grad_clip / (m["grad_norm"].item() + 1e-9))
                      for m in (m_k, m_p))
    excess = max(adam_param_excess(torch, new_k["params"][k], new_p["params"][k], g_k[k], g_p[k],
                                   clip_k, clip_p, opt.lr, opt.eps) for k in g_p)
    check(excess <= 0, f"parameters after the step differ by {excess} beyond the tolerance")
    pmax = max((new_k["params"][k].float() - new_p["params"][k].float()).abs().max().item()
               for k in g_p)
    print(f"gradients: max abs err {grad_rel:.3e} of each leaf's max (tol {GRAD_TOL}); "
          f"parameters after the step: max abs err {pmax:.3e} (tol 1e-6 + lr x |d(g c)| x "
          f"eps / (min |g c| + eps)^2, or 2 lr where the signs differ; lr {opt.lr}, eps "
          f"{opt.eps}, clip c {clip_k:.6f} / {clip_p:.6f}); over {len(g_p)} tensors")
    del model, state, new_k, new_p, g_k, g_p
    torch.cuda.empty_cache()
    return launches


def rms_norms(cfg) -> int:
    """RMSNorms in one pass of ``cfg``'s decoder: one before each layer's
    mixer, one before its MLP where it has one, ``norm_x`` before an
    ``attn_cross`` layer's cross-attention, and the final norm; 0 for a
    LayerNorm config (whisper-tiny: LayerNorm runs plain, as in the
    reference). The SSM's gated norm is plain too."""
    if cfg.norm != "rmsnorm":
        return 0
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    return sum(1 + (mlp != "none") + (mixer == "attn_cross") for mixer, mlp in kinds) + 1


def serve_launches(cfg):
    """Each kernel's launches in a prefill and over the ``STEPS`` decode steps of
    ``cfg``: flash in every causal self-attention and the SSD scan in every
    SSM layer, in the prefill only (decode and cross-attention run plain),
    and every RMSNorm in the prefill and in each decode step."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    norms = rms_norms(cfg)
    prefill = {"flash_attention": sum(m in ("attn", "attn_cross") for m, _ in kinds),
               "ssd_scan": sum(m == "ssm" for m, _ in kinds), "rmsnorm_fwd": norms,
               "rmsnorm_bwd": 0}
    decode = {"flash_attention": 0, "ssd_scan": 0, "rmsnorm_fwd": norms * STEPS,
              "rmsnorm_bwd": 0}
    return prefill, decode


def step_launches(cfg) -> dict:
    """Each kernel's launches in one train step of ``cfg``: every RMSNorm
    forward (``rms_norms``), again in the remat recompute of each layer,
    and backward; attention and the SSD scan run plain in training."""
    norms = rms_norms(cfg)
    recompute = max(norms - 1, 0) if cfg.remat == "full" else 0
    return {"flash_attention": 0, "ssd_scan": 0, "rmsnorm_fwd": norms + recompute,
            "rmsnorm_bwd": norms}


def profile_record(torch, tprof, cfg, b: int, s: int, counters, steps: int = PROFILE_STEPS,
                   traced=None):
    """``profile_lm`` on the card at (b, s), checked and printed as one JSON
    line, with the kernels' launches counted over exactly that call: one
    warm-up and ``steps`` timed steps, each the launches of one step (the
    trace for FLOPs and the NSM runs every kernel plain). With ``traced``,
    the point's trace from the corpus's workers, only the card's part runs
    here (``measure_point``)."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts(counters)
    if traced is None:
        rec = tprof.profile_lm(cfg, b, s, steps=steps, device=DEVICE)
    else:
        rec = tprof.measure_point(tprof.CorpusPoint("lm", cfg, b, s), traced, steps=steps,
                                  device=DEVICE)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    check(rec.time_s > 0 and rec.mem_bytes > 0 and rec.flops > 0 and rec.nsm_edges,
          f"{cfg.name} record at {(b, s)} has a zero measurement or an empty NSM")
    per_step = step_launches(cfg)
    want = {k: (steps + 1) * n for k, n in per_step.items()}
    check(launches == want, f"{cfg.name} profile_lm at {(b, s)}: kernel launches {launches}, "
                            f"want {want} ({steps + 1} steps of {per_step})")
    print(json.dumps(dict(model=rec.model_name, batch=b, seq=s, time_s=rec.time_s,
                          mem_bytes=rec.mem_bytes, flops=rec.flops, params=rec.params,
                          nsm_pairs=len(rec.nsm_edges), nsm_edges=sum(rec.nsm_edges.values()),
                          platform=rec.platform, launches=launches,
                          wall_s=time.perf_counter() - t0)))
    torch.cuda.empty_cache()
    return rec, launches


def profile_phase(torch, cfg_full, mamba_full, build_model, tprof, tstep, topt, counters):
    """The profiled train step at full width: the records with the kernels'
    launches of each ``profile_lm`` call, zeros against random state, where
    the step's device time goes, and one mamba2 record (the first record's
    NSM is checked against a CPU trace beside phase 11's fits,
    ``nsm_cpu_check``). Returns the launches of the main point's call and
    the four records."""
    print(f"== phase 10 (main path): profile_lm, {cfg_full.name} bf16 full width")
    cfg = dataclasses.replace(cfg_full, dtype="bfloat16")
    runs = [profile_record(torch, tprof, cfg, b, s, counters) for (b, s) in PROFILE_POINTS]
    records = [rec for rec, _ in runs]
    check(all(rec.params == QWEN_PARAMS for rec in records),
          f"params {[rec.params for rec in records]}, want {QWEN_PARAMS}")
    per_step = step_launches(cfg)
    print(f"kernel launches per train step: {per_step} ({per_step['rmsnorm_bwd']} norms forward, "
          f"{per_step['rmsnorm_fwd'] - per_step['rmsnorm_bwd']} again in the remat recompute, "
          f"{per_step['rmsnorm_bwd']} backward), {PROFILE_STEPS + 1} steps a profile_lm call")

    # the same step on seeded random weights and tokens (the records time zeros)
    b, s = PROFILE_POINTS[-1]
    _, step, specs, bspec = tprof.lm_trace(cfg, b, s)
    zeros = tprof.zeros_like_specs((specs, bspec), DEVICE)
    opt = topt.OptConfig(lr=1e-3, keep_master=False)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    real = tstep.init_state(build_model(cfg, device=DEVICE), opt, gen)
    rand_batch = {k: torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=DEVICE,
                                   dtype=torch.int32) for k in ("tokens", "labels")}
    z = tprof.time_step(step, zeros, PROFILE_STEPS)
    r = tprof.time_step(step, (real, rand_batch), PROFILE_STEPS)
    print(f"train step at {(b, s)}: zeros {z['time_s'] * 1e3:.3f} ms, seeded random state "
          f"{r['time_s'] * 1e3:.3f} ms (random / zeros {r['time_s'] / z['time_s']:.4f}); "
          f"peak {z['mem_bytes']:.0f} / {r['mem_bytes']:.0f} B")
    profile_device(torch, f"train step {(b, s)}", lambda: step(real, rand_batch),
                   wall_ms=r["time_s"] * 1e3)
    del zeros, real, rand_batch
    torch.cuda.empty_cache()

    mamba = dataclasses.replace(mamba_full, dtype="bfloat16", num_layers=MAMBA_DEPTH)
    mamba_rec, _ = profile_record(torch, tprof, mamba, *MAMBA_POINT, counters)
    return runs[-1][1], records + [mamba_rec]


def nsm_cpu_check(tprof, cfg, record) -> None:
    """Phase 10's first record's NSM, traced on card tensors, against a trace
    on the CPU (run beside phase 11's fits: a host-bound trace)."""
    b0, s0 = record.batch_size, record.input_size
    t0 = time.perf_counter()
    _, step0, specs0, batch0 = tprof.lm_trace(cfg, b0, s0)
    cpu_edges = tprof.trace_step(step0, (specs0, batch0), device="cpu")["nsm_edges"]
    check(cpu_edges == record.nsm_edges, "NSM traced on card tensors differs from the CPU's")
    print(f"phase 10's NSM at {(b0, s0)} traced on card tensors equals the CPU trace "
          f"({len(cpu_edges)} pairs, {sum(cpu_edges.values()):.0f} edges; "
          f"{time.perf_counter() - t0:.1f} s)")


def bench_candidates(seed: int):
    """The reference's bounded AutoML pool (benchmarks/collect.py), copied."""
    from repro_torch.core.automl.models import (ExtraTreesRegressor, GradientBoostingRegressor,
                                                KNNRegressor, RandomForestRegressor,
                                                RidgeRegressor)
    return [
        RandomForestRegressor(n_trees=40, max_depth=16, max_features=0.6,
                              min_samples_leaf=1, seed=seed),
        ExtraTreesRegressor(n_trees=40, max_depth=16, seed=seed + 1),
        GradientBoostingRegressor(n_stages=160, learning_rate=0.08,
                                  max_depth=4, seed=seed + 2),
        RidgeRegressor(alpha=1.0),
        KNNRegressor(k=3),
    ]


def zoo_grads(torch, tprof, model, params, x, y, device, dtype):
    """fp32 or float64 logits, loss and gradients of one zoo step, as float64
    on the CPU."""
    leaves = {k: v.to(device, dtype).requires_grad_(True) for k, v in params.items()}
    logits = model.apply(leaves, x.to(device, dtype))
    loss = tprof._softmax_ce(logits, y.to(device))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return [t.detach().double().cpu() for t in (logits, loss, *grads)]


def zoo_errors(got, exact, scale) -> dict:
    """Max abs errors of logits and loss, and of the gradients over ``scale``."""
    def err(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))
    return {"logits": err(got[:1], exact[:1]), "loss": err(got[1:2], exact[1:2]),
            "grads": err(got[2:], exact[2:]) / scale}


def layer_op(m) -> str:
    """A zoo leaf layer's op, as the per-layer check names it."""
    kind = type(m).__name__
    if kind in ("Conv", "Depthwise"):
        return f"conv {m.k}x{m.k} stride {m.stride} groups {m.groups} ({m.cin}->{m.cout})"
    if kind in ("Pool", "Act"):
        return f"{kind.lower()} {m.kind}"
    return kind.lower()


def zoo_layer_step(torch, tprof, model, params, x, y, device, dtype):
    """One zoo step with every leaf layer's output kept: for each leaf layer
    in the order it ran, (name, op, output, the loss's gradient there, and
    its parameters' gradients), all float64 on the CPU."""
    leaves = {k: v.to(device, dtype).requires_grad_(True) for k, v in params.items()}
    ran = []
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: ran.append((n, m, o)))
             for n, m in model.net.named_modules() if not any(True for _ in m.children())]
    try:
        logits = model.apply(leaves, x.to(device, dtype))
    finally:
        for h in hooks:
            h.remove()
    loss = tprof._softmax_ce(logits, y.to(device))
    outs = [o for _, _, o in ran]
    grads = torch.autograd.grad(loss, outs + list(leaves.values()), allow_unused=True)
    pgrad = dict(zip(leaves, grads[len(outs):]))

    def cpu(t):
        return None if t is None else t.detach().double().cpu()
    return [(n, layer_op(m), cpu(o), cpu(g),
             {p: cpu(pgrad[p]) for p in (f"{n}.{k}" if n else k for k in m.specs)})
            for (n, m, o), g in zip(ran, grads)]


@contextlib.contextmanager
def cudnn_setting(torch, enabled: bool, deterministic: bool, ieee: bool):
    """cuDNN on or off, its algorithms deterministic or not, never
    benchmarked, TF32 off; with ``ieee`` the convolutions' and matrix
    products' fp32 precision is also set to "ieee" through torch's
    ``fp32_precision`` settings (restored on exit)."""
    with torch.backends.cudnn.flags(enabled=enabled, benchmark=False,
                                    deterministic=deterministic, allow_tf32=False):
        if not ieee:
            yield
            return
        knobs = (torch.backends.cudnn.conv, torch.backends.cuda.matmul)
        old = [k.fp32_precision for k in knobs]
        for k in knobs:
            k.fp32_precision = "ieee"
        try:
            yield
        finally:
            for k, v in zip(knobs, old):
                k.fp32_precision = v


def sign_flips(card, cpu32, exact) -> str:
    """How many of a layer's outputs sit on the other side of zero from the
    float64 step's, on the card and on the CPU in fp32, and how close to zero
    (relative to the output's largest entry) the card's flipped ones are."""
    flipped = (card > 0) != (exact > 0)
    far = (exact.abs()[flipped].max().item() / exact.abs().max().item()
           if flipped.any() else 0.0)
    return (f"{int(flipped.sum())} of its {exact.numel()} outputs change sign against float64 "
            f"on the card (within {far:.1e} of zero), "
            f"{int(((cpu32 > 0) != (exact > 0)).sum())} on the CPU in fp32")


def zoo_layer_check(torch, tprof, tzoo, name: str) -> None:
    """Queue C item 1's per-layer check: ``name``'s fp32 step on the card,
    layer by layer, against the CPU's float64 step, under each cuDNN
    setting. Each layer's output and the loss's gradient at that output are
    compared relative to their largest exact entry, its parameters'
    gradients relative to the largest exact parameter gradient (as the
    whole step's check), against max(``ZOO_CHECK_FACTOR`` x the CPU fp32
    step's error, ``ZOO_CHECK_FLOOR``). Printed: the first output that
    leaves that rule in forward order, and the first gradient that leaves
    it walking back from the loss, with its layer, op and the sign flips of
    that layer's output (informational; nothing is checked)."""
    model = tzoo.build_zoo_model(name)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    x = torch.randn((ZOO_CHECK_BATCH, 3, 32, 32), generator=gen)
    y = torch.randint(0, 10, (ZOO_CHECK_BATCH,), generator=gen)

    def run(device, dtype):
        return zoo_layer_step(torch, tprof, model, params, x, y, device, dtype)
    exact, cpu32 = run("cpu", torch.float64), run("cpu", torch.float32)
    scale = max(g.abs().max().item() for *_, own in exact for g in own.values())

    def rel(a, b, over=None):
        if a is None or b is None:
            return 0.0
        return (a - b).abs().max().item() / (over or max(b.abs().max().item(), 1e-300))

    def off(got, cpu_got, want, over=None):
        err, err32 = rel(got, want, over), rel(cpu_got, want, over)
        return err, err32, err > max(ZOO_CHECK_FACTOR * err32, ZOO_CHECK_FLOOR)
    for label, (enabled, deterministic, ieee) in ZOO_LAYER_SETTINGS.items():
        with cudnn_setting(torch, enabled, deterministic, ieee):
            card = run(DEVICE, torch.float32)
        layers = list(zip(card, cpu32, exact))  # (name, op, out, out grad, {param: grad})
        fwd_off, bwd_off, worst = None, None, (0.0, "")
        for (n, op, o, *_), (_, _, o32, *_), (_, _, oc, *_) in layers:
            err, err32, bad = off(o, o32, oc)
            if bad and fwd_off is None:
                fwd_off = f"{n} ({op}): output {err:.2e} (CPU fp32 {err32:.2e})"
        for (n, op, o, g, own), (_, _, o32, g32, own32), (_, _, oc, gc, ownc) in reversed(layers):
            for what, got, cpu_got, want, over in (
                    [("output gradient", g, g32, gc, None)]
                    + [(k, own[k], own32[k], ownc[k], scale) for k in own]):
                err, err32, bad = off(got, cpu_got, want, over)
                if over:
                    worst = max(worst, (err, f"{n} ({op}) {what}"))
                if bad and bwd_off is None:
                    bwd_off = (f"{n} ({op}): {what} {err:.2e} (CPU fp32 {err32:.2e}); "
                               f"{sign_flips(o, o32, oc)}")
        print(f"  {name} per layer, fp32 on the card with {label}: first output off the rule "
              f"(forward): {fwd_off or 'none'}; first gradient off the rule (back from the "
              f"loss): {bwd_off or 'none'}; largest parameter gradient error {worst[0]:.2e} of "
              f"max |g| {scale:.3e}, at {worst[1]}")


def zoo_check_phase(torch, tzoo, tprof):
    """Every zoo net's forward, loss and gradients on the card against the
    CPU's float64 step: the card's float64 step within ``ZOO_CHECK_F64_TOL``,
    its fp32 step within ``ZOO_CHECK_FACTOR`` times the CPU fp32 step's error
    or the floor, but for the gradients of ``ZOO_FP32_ALLOWANCE``'s nets,
    whose step is rerun with cuDNN off. Then one zoo step's NSM and FLOPs
    traced on card tensors against the CPU trace."""
    check(not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32),
          "TF32 is on for the zoo's fp32 check")
    print(f"== phase 11 (main path): the paper's experiment; the zoo's step at batch "
          f"{ZOO_CHECK_BATCH} on the card (TF32 off) against the CPU's float64 step")
    for name in tzoo.ZOO:
        model = tzoo.build_zoo_model(name)
        gen = torch.Generator().manual_seed(0)
        params = model.init(gen)
        x = torch.randn((ZOO_CHECK_BATCH, 3, 32, 32), generator=gen)
        y = torch.randint(0, 10, (ZOO_CHECK_BATCH,), generator=gen)

        def run(device, dtype):
            return zoo_grads(torch, tprof, model, params, x, y, device, dtype)
        t0 = time.perf_counter()
        exact = run("cpu", torch.float64)
        scale = max(g.abs().max().item() for g in exact[2:])
        card32, card64 = run(DEVICE, torch.float32), run(DEVICE, torch.float64)
        check(all(bool(torch.isfinite(t).all()) for t in card32), f"{name}: non-finite fp32 step")
        e32, e64 = zoo_errors(card32, exact, scale), zoo_errors(card64, exact, scale)
        cpu32 = zoo_errors(run("cpu", torch.float32), exact, scale)
        for part, err in e64.items():
            check(err <= ZOO_CHECK_F64_TOL, f"{name} float64 {part}: card err {err:.3e}")
        allowance, off_meets_rule = ZOO_FP32_ALLOWANCE.get(name, (None, True))

        def check32(errs, label, allowed):
            for part, err in errs.items():
                bound = max(ZOO_CHECK_FACTOR * cpu32[part], ZOO_CHECK_FLOOR)
                if part == "grads" and allowed:
                    bound = allowance
                check(err <= bound, f"{name} fp32 {part}{label}: card err {err:.3e}, CPU fp32 "
                                    f"err {cpu32[part]:.3e}, bound {bound:.1e}")
        print(f"{name}: vs float64 CPU, card float64 / card fp32 / CPU fp32: logits "
              f"{e64['logits']:.2e} / {e32['logits']:.2e} / {cpu32['logits']:.2e}, loss "
              f"{e64['loss']:.2e} / {e32['loss']:.2e} / {cpu32['loss']:.2e}, grads "
              f"{e64['grads']:.2e} / {e32['grads']:.2e} / {cpu32['grads']:.2e} of max |g| "
              f"{scale:.3e} ({time.perf_counter() - t0:.1f} s)")
        check32(e32, "", allowance is not None)
        if allowance is not None:
            with cudnn_setting(torch, enabled=False, deterministic=False, ieee=False):
                plain = zoo_errors(run(DEVICE, torch.float32), exact, scale)
            print(f"{name} fp32 on the card with cuDNN off: logits {plain['logits']:.2e}, "
                  f"loss {plain['loss']:.2e}, grads {plain['grads']:.2e}")
            check32(plain, " with cuDNN off", not off_meets_rule)
        if name in ZOO_LAYER_NETS:
            zoo_layer_check(torch, tprof, tzoo, name)
    model = tzoo.build_zoo_model("shufflenet_v1")
    step, init = tprof.zoo_train_step(model, "adam", 0.1)
    ps = model.param_shapes()
    args = (ps, init(ps), torch.empty(8, 3, 32, 32, device="meta"),
            torch.empty(8, dtype=torch.int64, device="meta"))
    on_card = tprof.trace_step(step, args, device=DEVICE)
    on_cpu = tprof.trace_step(step, args, device="cpu")
    check(on_card == on_cpu, "shufflenet_v1 step's NSM or FLOPs traced on card tensors differ")
    print(f"shufflenet_v1 adam step NSM and FLOPs traced on card tensors equal the CPU trace "
          f"({len(on_cpu['nsm_edges'])} pairs, {on_cpu['flops']:.0f} FLOPs)")
    torch.cuda.empty_cache()


def record_line(rec, wall_s: float) -> str:
    return json.dumps(dict(net=rec.model_name, family=rec.family, batch=rec.batch_size,
                           image=rec.input_size, optimizer=rec.optimizer, time_s=rec.time_s,
                           mem_bytes=rec.mem_bytes, flops=rec.flops, params=rec.params,
                           layers=rec.layers, nsm_pairs=len(rec.nsm_edges), wall_s=wall_s))


def check_record(rec) -> None:
    check(rec.time_s > 0 and rec.mem_bytes > 0 and rec.flops > 0 and bool(rec.nsm_edges),
          f"record {rec.model_name} {rec.batch_size} {rec.input_size}: a zero measurement or "
          f"an empty NSM")


def corpus_points(tprof, trand, get_config, reduced_config) -> list:
    """Phase 11's corpus as ``CorpusPoint``s, in its records' order: the
    reference's default zoo grid, the random CNNs (collect.py's random_grid:
    batch 8 + 8 * (seed % 3), 32 px), then the LMs at ``LM_POINT``."""
    point = tprof.CorpusPoint
    cfgs = ([reduced_config(get_config(a)) for a in LM_GRID_ARCHS]
            + [trand.random_lm_config(seed) for seed in RANDOM_LM_SEEDS])
    return ([point("zoo", c["name"], c["batch"], c["image"], c.get("optimizer", "sgd"))
             for c in ZOO_GRID]
            + [point("rand_cnn", seed, 8 + 8 * (seed % 3), 32) for seed in RANDOM_CNN_SEEDS]
            + [point("lm", cfg, *LM_POINT) for cfg in cfgs])


def trace_workers() -> int:
    """The corpus's trace workers: half the host's cores, the other half
    left to this process, which drives the card meanwhile."""
    return max(1, (os.cpu_count() or 2) // 2)


def corpus_phase(torch, tzoo, tprof, points, traced, counters):
    """The corpus's CNNs on the card: the reference's default zoo grid and the
    random CNNs, each record the card's part of a ``profile_zoo`` call (a
    warm-up step and the timed steps, ``measure_point``) built with its
    trace from the workers, with the kernels' launches counted around all
    of them. Returns the records and the card's seconds for them."""
    cnn = [(p, t) for p, t in zip(points, traced) if p.kind != "lm"]
    print(f"== phase 11: the corpus, {len(ZOO_GRID)} zoo points and {len(RANDOM_CNN_SEEDS)} "
          f"random CNNs profiled on the card")
    records, card_s = [], 0.0
    torch.cuda.synchronize()
    reset_counts(counters)
    for p, t in cnn:
        t0 = time.perf_counter()
        rec = tprof.measure_point(p, t, steps=ZOO_PROFILE_STEPS, device=DEVICE)
        check_record(rec)
        records.append(rec)
        card_s += time.perf_counter() - t0
        print(record_line(rec, time.perf_counter() - t0))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    check(not any(launches.values()), f"the zoo's steps launched a hand-written kernel: "
                                      f"{launches}")
    print(f"kernel launches over the corpus's CNN steps: {launches}")
    check(set(tzoo.ZOO) <= {r.model_name for r in records}, "a zoo net has no record")
    torch.cuda.empty_cache()
    return records, card_s


def lm_corpus_phase(torch, tprof, points, traced, counters):
    """The corpus's LMs on the card, as collect.py's lm_grid and random_grid
    profile them: each ported arch of ``LM_ARCHS`` reduced, and the dense
    and SSM draws of ``random_lm_config``, fp32 at ``LM_POINT``, each the
    card's part of a ``profile_lm`` call built with its trace from the
    workers, its RMSNorm launches counted. Returns the records and the
    card's seconds for them."""
    print(f"== phase 11: the corpus's LMs, {len(LM_GRID_ARCHS)} reduced archs and "
          f"{len(RANDOM_LM_SEEDS)} random LMs profiled on the card at {LM_POINT}")
    records, card_s = [], 0.0
    for p, t in zip(points, traced):
        if p.kind == "lm":
            t0 = time.perf_counter()
            records.append(profile_record(torch, tprof, p.model, p.batch, p.size, counters,
                                          steps=LM_PROFILE_STEPS, traced=t)[0])
            card_s += time.perf_counter() - t0
    for rec in records:
        check_record(rec)
    return records, card_s


def experiment_phase(np, records, tzoo, meanwhile):
    """DNNAbacus on the card's records, as the reference's bench_mre.py and
    bench_unseen.py fit it, its MREs printed as one JSON line; fitted with
    phase 12's predictor beside them, which is returned with the records it
    was fitted on. ``meanwhile`` (phase 13, phase 12's chatglm3-6b, phase
    10's NSM check and phase 15's in-process half) runs in this process while
    the fits run in theirs."""
    from repro_torch.core.baselines import MLPBaseline, shape_inference_memory
    from repro_torch.core.features import design_matrix, mre, targets
    print(f"== phase 11: DNNAbacus fitted on the card's {len(records)} records")
    for rec in records:
        check_record(rec)
    cnn = [r for r in records if r.family in ("cnn", "rand_cnn")]

    def corr(a, b):
        return float(np.corrcoef(np.log(a), np.log(b))[0, 1])
    t = [r.time_s for r in cnn]
    print(json.dumps({"cnn_corpus_log_correlations": {
        "time_vs_layers": corr(t, [r.layers for r in cnn]),
        "time_vs_flops": corr(t, [r.flops for r in cnn]),
        "mem_vs_params": corr([r.mem_bytes for r in cnn], [r.params for r in cnn])}}))
    rng = np.random.default_rng(0)
    idx = rng.permutation(len(records))
    ntr = int(0.7 * len(records))
    train = [records[i] for i in idx[:ntr]]
    test = [records[i] for i in idx[ntr:]]
    unseen = [r for r in records if r.model_name in tzoo.UNSEEN]
    seen = [r for r in records if r.model_name not in tzoo.UNSEEN]
    check({r.model_name for r in unseen} == set(tzoo.UNSEEN), "an unseen net has no record")
    # phase 12's predictor: every record but qwen2-0.5b's, the model it is asked about
    unqueried = [r for r in records if r.model_name != SERVICE_UNSEEN]
    t0 = time.perf_counter()
    models, waited = fit_predictors({"split": ("nsm", train), "nsm": ("nsm", seen),
                                     "ge": ("ge", seen), "service": ("nsm", unqueried)},
                                    records, meanwhile)
    print(f"4 DNNAbacus fits in {time.perf_counter() - t0:.1f} s, one worker process each "
          f"(split {len(train)}, seen {len(seen)}, seen {len(seen)}, service {len(unqueried)} "
          f"records); {waited:.1f} s of it waited for after the work beside them")
    for k, model in models.items():
        t_all, m_all = model.predict(records)
        check(bool(np.isfinite(t_all).all() and np.isfinite(m_all).all()
                   and (t_all > 0).all() and (m_all > 0).all()),
              f"a {k} prediction is not finite and positive")
    ab = models["split"]
    ev_train, ev = ab.evaluate(train), ab.evaluate(test)
    check(ev_train["time_mre"] < IN_SAMPLE_MRE_MAX and ev_train["mem_mre"] < IN_SAMPLE_MRE_MAX,
          f"in-sample MRE {ev_train} not below {IN_SAMPLE_MRE_MAX}")

    t_true, m_true = targets(test)
    si_mem = np.array([shape_inference_memory(r) for r in test])
    x_train, x_test = design_matrix(train, ab.nsm_feat), design_matrix(test, ab.nsm_feat)
    tt, mt = targets(train)
    mlp_t = MLPBaseline(seed=0, device=DEVICE).fit(x_train, tt).predict(x_test)
    mlp_m = MLPBaseline(seed=0, device=DEVICE).fit(x_train, mt).predict(x_test)
    t_pred, _ = ab.predict(test)
    out = {
        "abacus_time_mre_test": ev["time_mre"], "abacus_mem_mre_test": ev["mem_mre"],
        "abacus_time_mre_train": ev_train["time_mre"], "abacus_mem_mre_train": ev_train["mem_mre"],
        "shapeinfer_mem_mre": mre(si_mem, m_true),
        "mlp_time_mre": mre(mlp_t, t_true), "mlp_mem_mre": mre(mlp_m, m_true),
        "n_train": len(train), "n_test": len(test),
    }
    by_net = {}
    for n in sorted({r.model_name for r in test}):
        sel = [i for i, r in enumerate(test) if r.model_name == n]
        by_net[n] = mre(t_pred[sel], t_true[sel])
    out["time_mre_by_net"] = by_net
    for rep in ("nsm", "ge"):
        evu = models[rep].evaluate(unseen)
        out[f"unseen_time_mre[{rep}]"] = evu["time_mre"]
        out[f"unseen_mem_mre[{rep}]"] = evu["mem_mre"]
    out["n_seen"], out["n_unseen"] = len(seen), len(unseen)
    print(json.dumps({"mre": out}))
    return models["service"], unqueried


def service_queries(get_config):
    """Phase 12's queries: qwen2-0.5b at ``PROFILE_POINTS``, then
    ``SERVICE_ARCHS`` at ``SERVICE_POINT``, cut to ``SERVICE_DEPTH``."""
    def cut(cfg):
        return dataclasses.replace(cfg, num_layers=SERVICE_DEPTH.get(cfg.name, cfg.num_layers))
    return ([(get_config(SERVICE_UNSEEN), b, s) for b, s in PROFILE_POINTS]
            + [(cut(get_config(arch)), *SERVICE_POINT) for arch in SERVICE_ARCHS])


def service_phase(torch, np, abacus, qwen_records, get_config):
    """Phase 12: the online query. ``abacus`` was fitted on every corpus record
    but qwen2-0.5b's, whose phase 10 records (``qwen_records``, one per
    ``PROFILE_POINTS``) are the truth for its answers. Cold queries through
    ``abacus.service()`` over a fresh segment-log ``TraceStore`` under
    ``FLEET_DIR`` (one trace a key, each written through to the store), the
    same queries warm (cache hits, identical estimates, ``WARM_SPEEDUP_MIN``
    times faster at the median), ``predict_config`` against ``predict_one``,
    each qwen2-0.5b record of the service against phase 10's (equal but for
    FLOPs, time and memory), and one JSON line a query. Returns the cold
    estimates, in ``service_queries`` order."""
    from repro_torch.core.predictor import HBM_PER_DEVICE
    from repro_torch.serve.trace_store import SegmentTraceStore
    print(f"== phase 12 (main path): the online query through DNNAbacus.service(), fitted "
          f"without {SERVICE_UNSEEN}")
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    svc = abacus.service(store=SegmentTraceStore(os.path.join(FLEET_DIR, "traces")))
    check(svc.store is not None, "the service did not take the trace store")
    queries = service_queries(get_config)
    keys = {svc.cache_key(*q) for q in queries}
    cold, cold_times = [], []
    for cfg, b, s in queries:
        t0 = time.perf_counter()
        cold.append(svc.predict_one(cfg, b, s))
        cold_times.append(time.perf_counter() - t0)
        print(f"cold query {cfg.name} {(b, s)}: {cold_times[-1]:.2f} s", flush=True)
    traced = svc.stats.traces
    check(traced == len(keys) and svc.stats.misses == len(keys),
          f"{traced} traces and {svc.stats.misses} misses for {len(keys)} distinct keys")
    check(svc.store.stats.writes == len(keys) and len(svc.store) == len(keys),
          f"trace store {svc.store.info()} after {len(keys)} cold keys")
    again, warm = [], []
    for cfg, b, s in queries:
        t0 = time.perf_counter()
        again.append(svc.predict_one(cfg, b, s))
        warm.append(time.perf_counter() - t0)
    check(svc.stats.traces == traced and svc.stats.hits == len(queries),
          f"warm queries traced again: {svc.stats.as_dict()}")
    check(again == cold, "warm estimates differ from cold ones")
    speedup = float(np.median(cold_times) / np.median(warm))
    print(f"cold median {np.median(cold_times):.3f} s, warm median {np.median(warm) * 1e3:.3f} ms: "
          f"warm {speedup:.0f}x faster; service {svc.cache_info()}")
    check(speedup >= WARM_SPEEDUP_MIN, f"warm queries only {speedup:.1f}x faster than cold")
    cfg, b, s = queries[-1]
    check(abacus.predict_config(cfg, b, s) == svc.predict_one(cfg, b, s),
          "predict_config and predict_one disagree")

    for (cfg, b, s), est, cold_s, warm_s in zip(queries, cold, cold_times, warm):
        rec = svc.cached_record(svc.cache_key(cfg, b, s))
        traced_flops = rec.extra["traced_flops"]
        offline = dataclasses.replace(rec, flops=traced_flops, extra=None)
        t_off, m_off = (float(v[0]) for v in abacus.predict([offline]))
        line = dict(model=cfg.name, layers=cfg.num_layers, batch=b, seq=s, time_s=est["time_s"],
                    memory_bytes=est["memory_bytes"], admitted=est["admitted"],
                    flops_online=rec.flops, flops_traced=traced_flops,
                    offline_time_s=t_off, offline_memory_bytes=m_off,
                    param_bytes_bf16=2 * rec.params, cold_s=cold_s, warm_s=warm_s)
        for v in (est["time_s"], est["memory_bytes"], t_off, m_off):
            check(bool(np.isfinite(v)) and v > 0, f"{cfg.name} {(b, s)}: estimate {v}")
        formula = 6.0 * cfg.active_param_count() * b * s
        check(rec.flops == formula, f"{cfg.name} {(b, s)}: online FLOPs {rec.flops}, want 6 x "
                                    f"active params x batch x seq = {formula}")
        line.update(active_params=cfg.active_param_count())
        check(est["admitted"] == (est["memory_bytes"] <= HBM_PER_DEVICE),
              f"{cfg.name} {(b, s)}: admitted {est['admitted']} at {est['memory_bytes']} bytes")
        if cfg.name == SERVICE_UNSEEN:
            truth = qwen_records[PROFILE_POINTS.index((b, s))]
            blank = dict(flops=0.0, time_s=0.0, mem_bytes=0.0, extra=None)
            check(dataclasses.replace(rec, **blank) == dataclasses.replace(truth, **blank),
                  f"{cfg.name} {(b, s)}: the service's record differs from profile_lm's")
            check(traced_flops == truth.flops,
                  f"{cfg.name} {(b, s)}: traced FLOPs {traced_flops} vs profile_lm {truth.flops}")
            line.update(measured_time_s=truth.time_s, measured_mem_bytes=truth.mem_bytes,
                        time_rel_err=abs(est["time_s"] - truth.time_s) / truth.time_s,
                        mem_rel_err=abs(est["memory_bytes"] - truth.mem_bytes) / truth.mem_bytes,
                        offline_time_rel_err=abs(t_off - truth.time_s) / truth.time_s,
                        offline_mem_rel_err=abs(m_off - truth.mem_bytes) / truth.mem_bytes)
        print(json.dumps({"query": line}))
    print(f"{SERVICE_UNSEEN}'s service records equal profile_lm's at {PROFILE_POINTS} but for "
          f"FLOPs, time and memory (NSM and traced FLOPs included); trace store "
          f"{svc.store.info()}")
    return cold


def impl_switches():
    """The three kernels' impl switches as this thread sees them."""
    from repro_torch.models import attention, layers, ssm
    return (attention.get_attention_impl(), ssm.get_ssd_impl(), layers.get_norm_impl())


def fleet_estimates(replica, queries):
    """One replica's answers to ``queries``, one query a tick, each timed."""
    out, times = [], []
    for cfg, b, s in queries:
        t0 = time.perf_counter()
        out.append(replica.submit(cfg, b, s).result(600))
        times.append(time.perf_counter() - t0)
    return out, times


def same_estimate(got, want, rtol: float = 0.0) -> bool:
    """An estimate against another: the same model, verdict and budget, and
    time and memory within ``rtol`` (0: equal)."""
    if (got["model"], got["admitted"], got["hbm_budget"]) != \
            (want["model"], want["admitted"], want["hbm_budget"]):
        return False
    return all(abs(got[k] - want[k]) <= rtol * abs(want[k]) for k in ("time_s", "memory_bytes"))


def fleet_phase(torch, np, abacus, cold, seed_records, qwen_records, get_config, tprof,
                counters):
    """Phase 14: the serving fleet's loop around phase 12's service. ``abacus``
    and ``cold`` are phase 12's predictor and cold estimates (in
    ``service_queries`` order), ``seed_records`` the records it was fitted on,
    ``qwen_records`` phase 10's truth at ``PROFILE_POINTS``. Builds a
    ``ClusterFrontend`` over two in-process ``GatewayReplica``s and one
    ``RemoteReplica`` spawned by ``spawn_replica``, all over phase 12's trace
    store and one feedback store; answers phase 12's keys from the store
    (each replica one query a tick, equal to phase 12's estimates; then one
    burst through the frontend from several tenants) with no trace
    fleet-wide; admits the qwen2-0.5b jobs on the card (``AdmissionController``
    on one ``Machine`` of the card's memory) and runs them as phase 10 does,
    each record equal to phase 10's but for time and memory; reports their
    measured costs; refits and publishes generation 1 to every replica; asks
    again; and answers one query from the H100 floor through a replica that
    sheds everything. Returns generation 1's predictor."""
    from repro_torch.core.predictor import DNNAbacus
    from repro_torch.serve import (ClusterFrontend, GatewayReplica, SegmentFeedbackStore,
                                   SegmentTraceStore)
    from repro_torch.serve.prediction_service import trace_query
    from repro_torch.serve.rpc import spawn_replica
    print("== phase 14 (main path): the serving fleet around phase 12's service: stores, "
          "gateway, admission, refit, cluster, RPC replica")
    t_start = time.perf_counter()
    traces, feedback = os.path.join(FLEET_DIR, "traces"), os.path.join(FLEET_DIR, "feedback")
    predictor = os.path.join(FLEET_DIR, "predictor")
    abacus.save(predictor)
    replicas = [GatewayReplica(name, DNNAbacus.load(predictor), store=SegmentTraceStore(traces),
                               feedback=SegmentFeedbackStore(os.path.join(feedback, "replicas")),
                               tracer=trace_query)
                for name in ("r0", "r1")]
    # the child and the stubs' local handles open the stores by backend name
    backend = os.environ.get("REPRO_STORE_BACKEND")
    os.environ["REPRO_STORE_BACKEND"] = "segment"
    t0 = time.perf_counter()
    try:
        remote = spawn_replica("r2", predictor, trace_root=traces,
                               feedback_root=os.path.join(feedback, "replicas"),
                               startup_timeout=FLEET_STARTUP_TIMEOUT)
    finally:
        if backend is None:
            os.environ.pop("REPRO_STORE_BACKEND")
        else:
            os.environ["REPRO_STORE_BACKEND"] = backend
    t_rpc = time.perf_counter() - t0
    print(f"RPC replica r2 (pid {remote.proc.pid}) ready in {t_rpc:.2f} s")
    fleet = ClusterFrontend(replicas=replicas + [remote], feedback_root=feedback,
                            store_backend="segment")
    fleet.start()
    try:
        return fleet_loop(torch, np, fleet, remote, abacus, cold, seed_records, qwen_records,
                          get_config, tprof, counters, t_start, t_rpc)
    finally:
        fleet.stop()
        remote.shutdown()


def fleet_loop(torch, np, fleet, remote, abacus, cold, seed_records, qwen_records, get_config,
               tprof, counters, t_start, t_rpc):
    """Phase 14 on a started fleet (``fleet_phase``); returns generation 1's
    predictor."""
    from repro_torch.analysis.roofline import floor_estimate
    from repro_torch.core.predictor import HBM_PER_DEVICE
    from repro_torch.core.scheduler import Machine
    from repro_torch.serve import AdmissionController, GatewayReplica, Query
    queries = service_queries(get_config)
    qwen_queries = queries[:len(PROFILE_POINTS)]
    job_queries = [q for q in qwen_queries if q[1:] in FLEET_JOB_POINTS]
    check(len(job_queries) == len(FLEET_JOB_POINTS), f"a job point is not in {PROFILE_POINTS}")

    def traces_fleet_wide():
        return sum(p["traces"] for p in fleet.server_info()["per_replica"].values())

    # 1. every replica answers phase 12's keys from the store, one query a tick
    t0 = time.perf_counter()
    hit_times = {}
    for replica in fleet.replicas:
        got, hit_times[replica.name] = fleet_estimates(replica, queries)
        for (cfg, b, s), est, want in zip(queries, got, cold):
            check(same_estimate(est, want), f"{replica.name} {cfg.name} {(b, s)}: {est} differs "
                                            f"from phase 12's {want}")
            check(est["admitted"] == (est["memory_bytes"] <= HBM_PER_DEVICE),
                  f"{replica.name} {cfg.name} {(b, s)}: admitted {est['admitted']}")
        info = replica.server_info()
        check(info["traces"] == 0 and info["store_hits"] == len(queries),
              f"{replica.name} traced or missed the store: {info}")
    # 2. one burst through the frontend, several tenants, several times each
    burst = [(q, tenant) for _ in range(FLEET_REPEATS) for tenant in FLEET_TENANTS
             for q in queries]
    t_burst = time.perf_counter()
    futs = [fleet.submit(cfg, b, s, tenant=tenant) for (cfg, b, s), tenant in burst]
    answers = [f.result(600) for f in futs]
    t_burst = time.perf_counter() - t_burst
    for ((cfg, b, s), _), est in zip(burst, answers):
        want = cold[queries.index((cfg, b, s))]
        check(same_estimate(est, want, FLEET_BATCH_RTOL),
              f"burst {cfg.name} {(b, s)}: {est} differs from phase 12's {want}")
    check(traces_fleet_wide() == 0, f"the fleet traced: {fleet.server_info()['fleet']}")
    proc = remote.process_info()
    check(proc["cuda_initialized"] is False, f"the RPC replica initialised CUDA: {proc}")
    check(not proc["modules"]["jax"] and not proc["modules"]["repro"],
          f"the RPC replica imported JAX or the reference: {proc}")
    t_hits = time.perf_counter() - t0
    medians = ", ".join(f"{name} {np.median(t) * 1e3:.3f} ms (max {max(t) * 1e3:.3f})"
                        for name, t in hit_times.items())
    print(f"store hits: {len(fleet.replicas)} replicas x {len(queries)} keys, each answer equal "
          f"to phase 12's, one query a tick, median {medians}; burst of {len(burst)} queries "
          f"from {len(FLEET_TENANTS)} tenants in {t_burst * 1e3:.1f} ms; 0 traces fleet-wide; "
          f"RPC child {proc}")

    # 3. admit the qwen2-0.5b jobs on one card
    total = torch.cuda.get_device_properties(0).total_memory
    ctl = AdmissionController(fleet, [Machine("h100", hbm_bytes=total)])
    verdicts = ctl.admit([Query(cfg, b, s, tenant=FLEET_TENANTS[i % len(FLEET_TENANTS)])
                          for i, (cfg, b, s) in enumerate(job_queries)])
    print(json.dumps({"admission": [v.as_dict() for v in verdicts],
                      "cluster": ctl.cluster_state()}))
    admitted = [(v, q) for v, q in zip(verdicts, job_queries) if v.admitted]
    check(bool(admitted), "no qwen2-0.5b job was admitted")

    # 4. run the admitted jobs on the card, as phase 10 does
    t0 = time.perf_counter()
    measured = {}
    for v, (cfg, b, s) in admitted:
        rec, _ = profile_record(torch, tprof, dataclasses.replace(cfg, dtype="bfloat16"), b, s,
                                counters)
        truth = qwen_records[PROFILE_POINTS.index((b, s))]
        blank = dict(time_s=0.0, mem_bytes=0.0)
        check(dataclasses.replace(rec, **blank) == dataclasses.replace(truth, **blank),
              f"job {v.job_id}: its record differs from phase 10's but for time and memory")
        check(impl_switches() == (None, None, None),
              f"the impl switches are {impl_switches()} after job {v.job_id}'s trace")
        measured[(b, s)] = (rec.time_s, rec.mem_bytes)
    t_jobs = time.perf_counter() - t0

    # 5. report, refit on phase 12's records and the feedback, publish
    for v, (cfg, b, s) in admitted:
        out = ctl.report_completion(v.job_id, time_s=measured[(b, s)][0],
                                    mem_bytes=measured[(b, s)][1])
        check(out["observed"], f"job {v.job_id}'s completion was not observed: {out}")
    check(ctl.cluster_state()["resident_jobs"] == 0, "a job's reservation was not released")
    refitter = fleet.make_refitter(seed_records=seed_records, min_observations=1)
    t0 = time.perf_counter()
    gen = refitter.refit_now(force=True)
    check(gen is not None and gen.number == 1 and gen.n_feedback == len(admitted),
          f"refit gave {gen and gen.summary()}")
    t_refit = refitter.last_refit_s
    # each replica adopts at its next tick boundary
    deadline = time.monotonic() + 60.0
    while True:
        gens = {r.name: r.service.generation for r in fleet.replicas}
        if set(gens.values()) == {1} or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    t_publish = time.perf_counter() - t0 - t_refit
    check(set(gens.values()) == {1}, f"generation 1 not adopted everywhere: {gens}")

    # 6. ask again: generation 1 everywhere, the same answer from every replica
    again = {r.name: fleet_estimates(r, qwen_queries)[0] for r in fleet.replicas}
    for i, (cfg, b, s) in enumerate(qwen_queries):
        ests = [again[name][i] for name in sorted(again)]
        check(all(e["generation"] == 1 for e in ests), f"{cfg.name} {(b, s)}: {ests}")
        check(all(same_estimate(e, ests[0]) for e in ests),
              f"{cfg.name} {(b, s)}: replicas disagree: {ests}")
    errors = {}
    for i, (cfg, b, s) in enumerate(qwen_queries):
        if (b, s) not in measured:
            continue
        t_true, m_true = measured[(b, s)]
        g0, g1 = cold[i], again["r0"][i]
        errors[f"{b}x{s}"] = {
            "measured_time_s": t_true, "measured_mem_bytes": m_true,
            "gen0_time_rel_err": abs(g0["time_s"] - t_true) / t_true,
            "gen0_mem_rel_err": abs(g0["memory_bytes"] - m_true) / m_true,
            "gen1_time_rel_err": abs(g1["time_s"] - t_true) / t_true,
            "gen1_mem_rel_err": abs(g1["memory_bytes"] - m_true) / m_true}
    stats = fleet.stats()
    print(json.dumps({"refit": {"generation": gen.summary(), "errors": errors,
                                "calibration": stats["calibration"]}}))

    # 7. the shed path: a replica that sheds everything answers from the H100 floor
    shed = GatewayReplica("shed", abacus, shed_watermark=0).start()
    try:
        cfg, b, s = qwen_queries[-1]
        est = shed.submit(cfg, b, s).result(60)
    finally:
        shed.stop()
    floor = floor_estimate(cfg, b, s)
    check({k: est[k] for k in floor} == floor and est["degraded"] is True
          and est["admitted"] == (est["memory_bytes"] <= HBM_PER_DEVICE)
          and shed.service.stats.traces == 0, f"shed answer {est}, floor {floor}")
    print(f"shed query {cfg.name} {(b, s)} answered from the H100 floor: {json.dumps(est)}")

    # 8. the rest
    info = fleet.server_info()
    print(json.dumps({"fleet_stats": {k: stats[k] for k in ("replicas", "fleet", "generations",
                                                              "overload", "refit", "publisher",
                                                              "feedback")},
                      "fleet_server_info": info["fleet"]}))
    lines = fleet.metrics_text().splitlines()
    print(f"merged metrics_text: {len(lines)} lines")
    print(f"phase 14 wall time {time.perf_counter() - t_start:.1f} s: store-hit queries "
          f"{t_hits:.2f} s, jobs {t_jobs:.1f} s, refit {t_refit:.2f} s, publish "
          f"{t_publish:.3f} s, RPC start-up {t_rpc:.2f} s")
    return gen.abacus


def same_bits(torch, a, b) -> bool:
    """Two tensors equal bit for bit (NaNs included): dtype, shape and bytes."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def state_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(state_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def train_run(torch, get_config, build_model, counters) -> dict:
    """Phase 15's in-process half, run beside phase 11's fits (the card is
    free there): qwen2-0.5b at full width and depth through the ``Trainer``
    for ``TRAIN_STEPS`` steps with checkpoints under ``TRAIN_CKPT_DIR`` and
    the step calls of ``TRAIN_FAIL_CALLS`` failing once; each step's batch
    checked against ``batch_at`` and its kernel launches against one train
    step's; the last checkpoint restored bit for bit, then deleted, so that
    only the first is left for the launcher (``train_phase``). Returns what
    ``train_phase`` compares and prints."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.ft.runtime import FailureInjector
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import LoopConfig, Trainer
    cfg = get_config("qwen2-0.5b")
    b, s = TRAIN_POINT
    print(f"== phase 15 (main path), its in-process half, beside phase 11's fits: the Trainer "
          f"on {cfg.name} {cfg.dtype} full width and depth ({cfg.num_layers} layers, remat "
          f"{cfg.remat}) at {TRAIN_POINT}, checkpoints, a failed step retried")
    check(cfg.dtype == "bfloat16" and cfg.remat == "full", f"{cfg.name}: {cfg.dtype}, {cfg.remat}")
    t_start = time.perf_counter()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    os.makedirs(TRAIN_CKPT_DIR)
    free = shutil.disk_usage(TRAIN_DIR).free
    model = build_model(cfg, device=DEVICE)
    opt_cfg = topt.OptConfig()
    nbytes = state_bytes(tstep.state_shapes(model, opt_cfg))
    print(f"free disk {free} B; a checkpoint of the train state {nbytes} B")
    check(free >= TRAIN_DISK_CKPTS * nbytes,
          f"{free} B free under {TRAIN_DIR}: phase 15 needs {TRAIN_DISK_CKPTS} checkpoints' "
          f"worth, {TRAIN_DISK_CKPTS * nbytes} B")

    trainer = Trainer(model, opt_cfg, LoopConfig(steps=TRAIN_STEPS, batch=b, seq=s,
                                                 ckpt_every=TRAIN_CKPT_EVERY, log_every=1,
                                                 ckpt_dir=TRAIN_CKPT_DIR))
    per_step, step_fn = step_launches(cfg), trainer.runner.step_fn
    seen = []

    def checked_step(state, batch):
        i = int(state["step"])
        want = trainer.source.batch_at(i)
        for k in ("tokens", "labels"):
            check(bool((batch[k].cpu().numpy() == want[k]).all()) and batch[k].dtype == torch.int32,
                  f"step {i}: the loader's {k} differ from batch_at({i})")
        before = read_counts(counters)
        out = step_fn(state, batch)
        launches = {k: n - before[k] for k, n in read_counts(counters).items()}
        check(launches == per_step, f"step {i}: kernel launches {launches}, want {per_step}")
        seen.append(i)
        return out
    injector = FailureInjector(fail_on_calls=TRAIN_FAIL_CALLS)
    trainer.runner.step_fn = injector.wrap(checked_step)
    saves, real_save = [], ckpt.save

    def timed_save(d, step, state, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_save(d, step, state, **kw)
        saves.append((step, time.perf_counter() - t0))
        return out
    ckpt.save = timed_save
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    try:
        log = trainer.run()
    finally:
        ckpt.save = real_save
    t_run = time.perf_counter() - t0
    launches = read_counts(counters)
    check(launches == {k: TRAIN_STEPS * n for k, n in per_step.items()},
          f"the Trainer's kernel launches {launches}, want {TRAIN_STEPS} steps of {per_step}")
    peak = torch.cuda.max_memory_allocated()
    runner = trainer.runner
    check(runner.retries == len(TRAIN_FAIL_CALLS),
          f"{runner.retries} retries for {len(TRAIN_FAIL_CALLS)} injected failures")
    check(seen == list(range(TRAIN_STEPS)) and [r["step"] for r in log] == seen,
          f"steps run {seen}, logged {[r['step'] for r in log]}")
    check(all(math.isfinite(r["loss"]) for r in log), f"losses {[r['loss'] for r in log]}")
    saved = [st for st, _ in saves]
    check(saved == list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS + 1, TRAIN_CKPT_EVERY))
          and ckpt.all_steps(TRAIN_CKPT_DIR) == saved,
          f"saves {saves}, on disk {ckpt.all_steps(TRAIN_CKPT_DIR)}")
    times = [r["step_time_s"] for r in log]
    print(json.dumps({"train": [{k: r[k] for k in ("step", "loss", "grad_norm", "lr",
                                                   "step_time_s")} for r in log]}))
    print(f"{TRAIN_STEPS} steps in {t_run:.2f} s: step_time_s {[round(t, 4) for t in times]}, "
          f"median {statistics.median(times[1:]):.4f} s after the first, against phase 10's "
          f"{PHASE10_STEP_S} s (run B, PR 18); peak {peak} B; retries {runner.retries}, "
          f"stragglers {runner.stragglers} (no prediction: the running median's); kernel "
          f"launches {launches}, {per_step} each step")
    for step, sec in saves:
        print(f"save of step {step}: {sec:.2f} s, {nbytes / sec / 1e9:.2f} GB/s")

    # the last checkpoint restored bit for bit, its arrays' CRC-32s kept for the
    # child's, then deleted: only the first is left
    final = trainer.state
    del trainer, model
    torch.cuda.empty_cache()
    like = tstep.state_shapes(build_model(cfg, device="meta"), opt_cfg)
    t0 = time.perf_counter()
    restored = ckpt.restore(TRAIN_CKPT_DIR, TRAIN_STEPS, like, device=DEVICE)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    flat_final, flat_back = ckpt._flatten(final), ckpt._flatten(restored)
    check(set(flat_final) == set(flat_back), "the restored state's keys differ")
    bad = [k for k, v in flat_final.items() if not same_bits(torch, flat_back[k], v)]
    check(not bad, f"restored leaves differ from the final state: {bad[:5]}")
    dtypes = sorted({ckpt.dtype_name(v.dtype) for v in flat_final.values()})
    print(f"restore of step {TRAIN_STEPS}: {t_restore:.2f} s, {nbytes / t_restore / 1e9:.2f} GB/s; "
          f"{len(flat_final)} leaves ({', '.join(dtypes)}) equal to the final state bit for bit")
    del final, restored, flat_final, flat_back
    torch.cuda.empty_cache()
    last = os.path.join(TRAIN_CKPT_DIR, f"step_{TRAIN_STEPS:08d}")
    written = npz_members(last)
    shutil.rmtree(last)
    check(ckpt.all_steps(TRAIN_CKPT_DIR) == [TRAIN_CKPT_EVERY],
          f"left {ckpt.all_steps(TRAIN_CKPT_DIR)}")
    wall = time.perf_counter() - t_start
    print(f"phase 15's in-process half {wall:.1f} s: the run {t_run:.1f} s (saves "
          f"{sum(sec for _, sec in saves):.1f}), restore {t_restore:.1f} s")
    return dict(log=log, peak=peak, written=written, median_s=statistics.median(times[1:]),
                stragglers=runner.stragglers, wall_s=wall)


def train_phase(torch, abacus1, get_config, run: dict, meanwhile=None):
    """Phase 15's launcher half, after phase 14: ``abacus1``, phase 14's
    generation-1 predictor, is saved for the launcher and asked about the
    job through phase 12's trace store (no trace); with only the first
    checkpoint of ``train_run`` left, ``python -m repro_torch.launch.train
    --full-size --predict`` resumes in a child process, which must print
    that estimate, log the in-process run's losses bit for bit and write its
    final checkpoint (each array's CRC-32 and size, ``run["written"]``).
    ``meanwhile`` (phase 16) runs here while the child trains."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.serve import PredictionService, SegmentTraceStore
    from repro_torch.train.loop import LoopConfig
    cfg = get_config("qwen2-0.5b")
    b, s = TRAIN_POINT
    print(f"== phase 15 (main path): the training launcher, crash and resume of {cfg.name} at "
          f"{TRAIN_POINT} through launch.train --predict with generation 1")
    t_start = time.perf_counter()
    predictor = os.path.join(TRAIN_DIR, "abacus")
    abacus1.save(predictor)
    svc = PredictionService(abacus1, store=SegmentTraceStore(os.path.join(FLEET_DIR, "traces")))
    est = svc.predict_one(cfg, b, s)
    check(svc.stats.traces == 0, f"the job's estimate traced: {svc.stats.as_dict()}")
    abacus_line = (f"[abacus] predicted step time {est['time_s']*1e3:.1f} ms, "
                   f"peak memory {est['memory_bytes']/2**30:.2f} GiB")
    print(f"generation 1's estimate {est['time_s']:.4f} s, {est['memory_bytes']:.0f} B against "
          f"the in-process run's median step {run['median_s']:.4f} s and peak {run['peak']} B")
    resume = TRAIN_CKPT_EVERY
    check(ckpt.all_steps(TRAIN_CKPT_DIR) == [resume], f"left {ckpt.all_steps(TRAIN_CKPT_DIR)}")
    child_log = os.path.join(TRAIN_DIR, "child_log.jsonl")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", cfg.name, "--full-size",
           "--batch", str(b), "--seq", str(s), "--steps", str(TRAIN_STEPS), "--ckpt-dir",
           TRAIN_CKPT_DIR, "--predict", "--predictor-path", predictor, "--log", child_log]
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    out_path, err_path = (os.path.join(TRAIN_DIR, f"child.{ext}") for ext in ("out", "err"))
    t0 = time.perf_counter()
    with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
        proc = subprocess.Popen(cmd, env=env, stdout=out_f, stderr=err_f)
    try:
        if meanwhile is not None:
            meanwhile()
        t1 = time.perf_counter()
        proc.wait(timeout=TRAIN_CHILD_TIMEOUT)
        t_wait = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    t_child = time.perf_counter() - t0
    with open(out_path) as f_out, open(err_path) as f_err:
        lines, err = f_out.read().splitlines(), f_err.read()
    check(proc.returncode == 0, f"the launcher exited {proc.returncode}: {err[-4000:]}")
    print(f"launcher child ({t_child:.1f} s, {t_wait:.1f} s of it waited for after the work "
          f"beside it): " + " | ".join(ln for ln in lines if not ln.startswith("{")))
    check(lines[0] == abacus_line, f"the child's estimate {lines[0]!r}, want {abacus_line!r}")
    child = [json.loads(ln) for ln in lines if ln.startswith("{")]
    print(json.dumps({"train_child": child}))
    with open(child_log) as f:
        check([json.loads(ln) for ln in f] == child, "the --log file differs from stdout")
    # the launcher logs every 5th step and the last: a run from step 0 would log
    # step 0, one resumed at 3 logs step 5 only
    every = LoopConfig().log_every  # the launcher's
    want = [r for r in run["log"] if r["step"] >= resume and (r["step"] % every == 0
                                                              or r["step"] == TRAIN_STEPS - 1)]
    check([r["step"] for r in child] == [r["step"] for r in want],
          f"the child logged steps {[r['step'] for r in child]}, want {[r['step'] for r in want]} "
          f"(resumed at {resume})")
    for got, ref in zip(child, want):
        check(all(got[k] == ref[k] for k in ("loss", "ce", "aux", "grad_norm", "lr")),
              f"step {got['step']}: the child's {got} differs from the in-process {ref}")
    check(ckpt.all_steps(TRAIN_CKPT_DIR) == [resume, TRAIN_STEPS],
          f"{ckpt.all_steps(TRAIN_CKPT_DIR)}")
    theirs = npz_members(os.path.join(TRAIN_CKPT_DIR, f"step_{TRAIN_STEPS:08d}"))
    check(theirs == run["written"], "the child's final checkpoint differs from the in-process "
          f"one: {sorted(k for k in run['written'] if theirs.get(k) != run['written'][k])[:5]}")
    print(f"the child resumed at step {resume}: its logged losses {[r['loss'] for r in child]} "
          f"equal the in-process run's, and each of its final checkpoint's {len(theirs)} "
          f"arrays the in-process one's (CRC-32 and size)")
    shutil.rmtree(TRAIN_DIR)
    print(f"phase 15 wall time {time.perf_counter() - t_start:.1f} s: the child {t_child:.1f} s "
          f"with phase 16 beside it (the in-process half took {run['wall_s']:.1f} s beside "
          f"phase 11's fits)")


def sharded_phase() -> float:
    """Phase 17's card half: ``sharded_child`` in a child process (no NCCL
    group in this one), its output printed here. Returns its wall time."""
    print("== phase 17 (main path): the sharded Trainer on a (1, 1) DeviceMesh (NCCL) against "
          "the unsharded one, the elastic restore and the compressed all-reduce, in a child")
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--sharded-child"],
                          env=env, capture_output=True, text=True,
                          timeout=SHARDED_CHILD_TIMEOUT)
    print(proc.stdout, end="")
    check(proc.returncode == 0, f"phase 17's child exited {proc.returncode}: "
          f"{proc.stderr[-4000:]}")
    wall = time.perf_counter() - t0
    print(f"phase 17's card half {wall:.1f} s")
    return wall


def sharded_child() -> int:
    """Phase 17's card half, in its own process: see the module docstring."""
    import torch
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rn.LIBRARY.load()  # built by the parent into build/, loaded from there
    counters = {"rmsnorm_fwd": (rn, "fwd_launches"), "rmsnorm_bwd": (rn, "bwd_launches")}
    sharded_run(torch, get_config, build_model, counters)
    return 0


def sharded_run(torch, get_config, build_model, counters) -> None:
    """The unsharded Trainer, then the sharded one on a (1, 1) mesh, from one
    seed and one batch stream; the checkpoint and the compressed all-reduce."""
    import torch.distributed as dist

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import LoopConfig, Trainer
    cfg = get_config("qwen2-0.5b")
    b, s = TRAIN_POINT
    loop = LoopConfig(steps=SHARDED_STEPS, batch=b, seq=s, log_every=1, zero=True)
    opt_cfg = topt.OptConfig()
    per_step = {k: step_launches(cfg)[k] for k in counters}
    t_start = time.perf_counter()

    def run(trainer, label):
        step_fn, seen = trainer.runner.step_fn, []

        def counted(state, batch):
            before = read_counts(counters)
            out = step_fn(state, batch)
            launches = {k: n - before[k] for k, n in read_counts(counters).items()}
            check(launches == per_step, f"{label} step {len(seen)}: launches {launches}, "
                  f"want {per_step}")
            seen.append(batch)
            return out
        trainer.runner.step_fn = counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        t0 = time.perf_counter()
        log = trainer.run()
        torch.cuda.synchronize()
        launches = read_counts(counters)
        check(launches == {k: SHARDED_STEPS * n for k, n in per_step.items()},
              f"{label}: launches {launches}, want {SHARDED_STEPS} steps of {per_step}")
        return log, seen, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    plain = Trainer(build_model(cfg, device=DEVICE), opt_cfg, loop)
    log0, _, t_plain, peak0 = run(plain, "unsharded")
    want = {k: v.cpu() for k, v in ckpt._flatten(plain.state).items()}
    del plain
    torch.cuda.empty_cache()

    mesh = make_host_mesh(1, 1, device=DEVICE)
    check(dist.get_backend() == ("nccl" if DEVICE == "cuda" else "gloo"),
          f"the mesh's group runs {dist.get_backend()}")
    model = build_model(cfg, device=DEVICE, sharder=shd.make_sharder(mesh))
    trainer = Trainer(model, opt_cfg, loop, mesh=mesh, rules=shd.ShardingRules())
    log1, batches, t_sharded, peak1 = run(trainer, "sharded")
    from torch.distributed.tensor import DTensor
    state = trainer.state
    flat = ckpt._flatten(state)
    check(all(isinstance(v, DTensor) for v in flat.values())
          and all(isinstance(t, DTensor) for bt in batches for t in bt.values()),
          "the sharded run's state or batches are not all DTensors")
    keys = ("loss", "ce", "aux", "grad_norm", "lr")
    for r0, r1 in zip(log0, log1):
        check(all(r0[k] == r1[k] for k in keys),
              f"step {r1['step']}: sharded {[r1[k] for k in keys]} != unsharded "
              f"{[r0[k] for k in keys]}")
    bad = [k for k, v in flat.items() if not same_bits(torch, v.full_tensor().cpu(), want[k])]
    check(not bad, f"the sharded final state differs from the unsharded one: {bad[:5]}")
    del want
    print(json.dumps({"sharded_train": [{k: r[k] for k in ("step",) + keys + ("step_time_s",)}
                                        for r in log1]}))
    print(f"{SHARDED_STEPS} steps each on {cfg.name} {cfg.dtype} at {TRAIN_POINT}: unsharded "
          f"{t_plain:.2f} s (peak {peak0} B), on the {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"mesh {t_sharded:.2f} s (peak {peak1} B), step_time_s "
          f"{[round(r['step_time_s'], 4) for r in log0]} against "
          f"{[round(r['step_time_s'], 4) for r in log1]}; losses and all {len(flat)} leaves of "
          f"the final state equal bit for bit; RMSNorm launches {per_step} each step")

    # the checkpoint of the sharded state, restored onto the mesh
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(SHARDED_DIR, SHARDED_STEPS, state)
    t_save = time.perf_counter() - t0
    like = tstep.state_shapes(build_model(cfg, device="meta"), opt_cfg)
    t0 = time.perf_counter()
    back = ckpt.restore(SHARDED_DIR, SHARDED_STEPS, like, trainer.state_sh)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    flat_back = ckpt._flatten(back)
    bad = [k for k, v in flat.items()
           if not (isinstance(flat_back[k], DTensor)
                   and tuple(flat_back[k].placements) == tuple(v.placements)
                   and same_bits(torch, flat_back[k].to_local(), v.to_local()))]
    check(not bad, f"restored leaves differ: {bad[:5]}")
    dtypes = sorted({ckpt.dtype_name(v.dtype) for v in flat.values()})
    print(f"checkpoint of the sharded state: save {t_save:.2f} s, restore onto the mesh "
          f"{t_restore:.2f} s; {len(flat)} leaves ({', '.join(dtypes)}) equal bit for bit")
    del back, flat_back
    shutil.rmtree(SHARDED_DIR)

    # the compressed all-reduce of the step's gradients over the one-rank group
    batch = batches[-1]
    _, _, grads = trainer.step_fn.compute_grads(state["params"], batch)
    local = {k: g.to_local() for k, g in grads.items()}
    del grads, trainer, state, flat
    torch.cuda.empty_cache()
    group = mesh.get_group("data")
    ef = comp.ef_init(local)
    mean, residual = comp.allreduce_compressed(local, ef, group)
    packed, resid_want = comp.ef_compress(local, ef)
    exact = comp.ef_decompress(packed)
    bad = [k for k in local if not same_bits(torch, mean[k], exact[k])]
    check(not bad, f"the one-rank compressed mean differs from ef_decompress(ef_compress(g)): "
          f"{bad[:5]}")
    bad = [k for k in local if not same_bits(torch, residual[k], resid_want[k])
           or not same_bits(torch, residual[k], local[k].float() + ef[k]
                            - packed.q[k].float() * packed.scale[k])]
    check(not bad, f"the residual differs from x - q*s: {bad[:5]}")
    del mean, residual, packed, resid_want, exact

    def compressed():
        comp.allreduce_compressed(local, ef, group)

    def plain_allreduce():
        for g in local.values():
            dist.all_reduce(g.clone(), group=group)
    t_comp, t_ar = (time_ms(torch, fn, reps=COMPRESS_REPS, warmup=1)
                    for fn in (compressed, plain_allreduce))
    nbytes = sum(g.numel() * g.element_size() for g in local.values())
    print(json.dumps({"compressed_allreduce": {
        "ranks": dist.get_world_size(group), "leaves": len(local), "grad_bytes": nbytes,
        "ms": t_comp, "plain_allreduce_ms": t_ar,
        "note": "one rank: both time local passes only (the int8 quantisation and "
                "decompression against a copy of the bf16 gradients), no link"}}))
    print(f"compressed all-reduce of {len(local)} gradients ({nbytes} B) over "
          f"{dist.get_world_size(group)} rank: {t_comp:.3f} ms against a plain all_reduce's "
          f"{t_ar:.3f} ms (one rank: the quantisation pass only); the mean equals "
          f"ef_decompress(ef_compress(g)) and the residual x - q*s exactly")
    dist.destroy_process_group()
    print(f"phase 17's child: {time.perf_counter() - t_start:.1f} s")


def dryrun_start(predictor: str):
    """Phase 17's host half, started: ``repro_torch.launch.dryrun``'s
    ``main`` on ``DRYRUN_CELL`` cut to ``DRYRUN_DEPTH`` layers, on a fake
    256-rank world with ``--predict``."""
    arch, shape, scheme = DRYRUN_CELL
    print(f"== phase 17: the dry run of {arch} {shape} ({scheme}), {DRYRUN_DEPTH} of 24 "
          f"layers, on a fake {DRYRUN_DEVICES}-rank (16, 16) world with generation 1's "
          f"estimate, beside phase 15's child")
    if os.path.exists(DRYRUN_OUT):
        os.remove(DRYRUN_OUT)
    stores = os.path.join(os.path.dirname(DRYRUN_OUT), "dryrun_stores")
    shutil.rmtree(stores, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-c", DRYRUN_MAIN, "--arch", arch, "--shape", shape,
           "--scheme", scheme, "--predict", "--predictor-path", predictor,
           "--trace-store", os.path.join(stores, "traces"),
           "--feedback-store", os.path.join(stores, "feedback"), "--out", DRYRUN_OUT]
    return dict(proc=subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True),
                t0=time.perf_counter(), stores=stores)


def dryrun_finish(proc, t0: float, stores: str) -> float:
    """Phase 17's host half, waited for and checked; its record printed and
    read by ``repro_torch.analysis.report``. Returns its wall time."""
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the dry run exited {proc.returncode}: {err[-4000:]}")
    print(out, end="")
    with open(DRYRUN_OUT) as f:
        (rec,) = [json.loads(line) for line in f]
    arch, shape, scheme = DRYRUN_CELL
    want_mflops = 6 * DRYRUN_PARAMS * 256 * 4096 / DRYRUN_DEVICES
    colls = rec.get("collectives", {})
    grad_bytes = 2 * DRYRUN_PARAMS  # bf16; the fp32 norm scales add 0.01%
    # the record keeps the reference's keys (a count by kind): an all-reduce
    # is weighted 2x and every other kind 1x, so the weighted bytes less the
    # raw ones are the all-reduces' bytes
    ar_bytes = rec["collective_weighted_bytes"] - rec["collective_bytes"]
    check(rec["status"] == "ok" and rec["devices"] == DRYRUN_DEVICES, f"dry run record {rec}")
    check(rec["model_flops_per_device"] == want_mflops,
          f"model FLOPs per device {rec['model_flops_per_device']}, want {want_mflops}")
    check(0.2 < rec["useful_flop_fraction"] <= 1.05,
          f"useful FLOP fraction {rec['useful_flop_fraction']}")
    check(grad_bytes <= ar_bytes <= GRAD_AR_MAX * grad_bytes,
          f"all-reduce bytes {ar_bytes} against the gradients' {grad_bytes}: {colls}")
    check("abacus_time_s" in rec and "abacus_error" not in rec,
          f"no estimate on the record: {rec.get('abacus_error')}")
    keys = ("flops_per_device", "bytes_per_device", "collective_bytes",
            "collective_weighted_bytes", "t_compute_s", "t_memory_s", "t_collective_s",
            "bottleneck", "mfu_bound", "useful_flop_fraction", "model_flops_per_device",
            "peak_hbm_gib", "argument_gib", "temp_gib", "abacus_time_s", "abacus_memory_gib",
            "abacus_generation", "lower_s", "compile_s")
    print(json.dumps({"dryrun": {"arch": arch, "shape": shape, "scheme": scheme,
                                 "layers": DRYRUN_DEPTH,
                                 "devices": rec["devices"],
                                 "collectives": {k: v["count"] for k, v in colls.items()},
                                 "all_reduce_bytes": ar_bytes, "grad_bytes": grad_bytes,
                                 **{k: rec.get(k) for k in keys}}}))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    table = subprocess.run([sys.executable, "-m", "repro_torch.analysis.report", DRYRUN_OUT],
                           env=env, capture_output=True, text=True, timeout=120)
    check(table.returncode == 0 and f"| {arch} | {shape} | {scheme} |" in table.stdout,
          f"the report failed: {table.stderr[-2000:]}")
    print(table.stdout, end="")
    shutil.rmtree(stores, ignore_errors=True)
    print(f"phase 17's dry run {wall:.1f} s (trace {rec['lower_s']} s, analysis "
          f"{rec['compile_s']} s), host only")
    return wall


def npz_members(path) -> dict:
    """``{array name: (CRC-32, size)}`` of a checkpoint's ``arrays.npz``, from
    the zip's directory (each member holds an array's ``.npy`` header and
    bytes)."""
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as zf:
        return {i.filename: (i.CRC, i.file_size) for i in zf.infolist()}


def composed_spec():
    """``benchmarks/bench_scenarios.py``'s ``composed_spec(smoke=True)``, copied:
    every fault class in one schedule."""
    from repro_torch.scenarios import (FaultSpec, ProfileSwap, ScenarioSpec, TenantSpec,
                                       TrafficSpec)
    return ScenarioSpec(
        name="composed", seed=20250808, duration_s=6.0,
        tenants=[
            TenantSpec(name="batch", weight=2.0, n_configs=5,
                       dots=(8.0, 48.0), time_drift=3.0, mem_drift=1.5,
                       observe_fraction=0.6),
            TenantSpec(name="interactive", weight=1.0, n_configs=3,
                       dots=(12.0, 36.0), batches=(2, 4), seqs=(32,),
                       time_drift=0.8, mem_drift=1.0,
                       observe_fraction=0.4),
        ],
        traffic=TrafficSpec(base_rate=60.0, burst_amplitude=0.9, burst_period_s=4.0),
        churn_rate=2.0,
        swaps=[ProfileSwap(t=3.0, tenant="batch", time_drift=2.0, mem_drift=1.2)],
        faults=[FaultSpec(t=1.5, kind="publish"),
                FaultSpec(t=2.5, kind="kill", target="r1"),
                FaultSpec(t=4.0, kind="resize", n=6),
                FaultSpec(t=5.0, kind="publish")])


def scenario_phase():
    """Phase 16: the composed drift scenario over the port's fleet: the
    schedule's digest equal here and in children under other hash seeds, then
    the replay on ``SCENARIO_REPLICAS`` in-process replicas with every oracle
    of ``check_all`` holding."""
    from repro_torch.scenarios import (ScenarioRunner, check_all, failed, fit_abacus, generate,
                                       scenario_trace, schedule_digest,
                                       schedule_digest_subprocess)
    from repro_torch.serve import ClusterFrontend
    print("== phase 16: the composed drift scenario (bench_scenarios' smoke spec) over the "
          f"port's fleet of {SCENARIO_REPLICAS} in-process replicas")
    t_start = time.perf_counter()
    spec = composed_spec()
    sched = generate(spec)
    local = schedule_digest(spec)
    with ThreadPoolExecutor(len(SCENARIO_HASH_SEEDS)) as pool:
        children = list(pool.map(lambda hs: schedule_digest_subprocess(spec, hs),
                                 SCENARIO_HASH_SEEDS))
    t_digest = time.perf_counter() - t_start
    check(all(d == local for d in children),
          f"schedule digest {local} here, {children} under PYTHONHASHSEED {SCENARIO_HASH_SEEDS}")
    print(f"schedule {local[:16]}: {len(sched)} events {sched.counts()}, the same digest in "
          f"children under PYTHONHASHSEED {SCENARIO_HASH_SEEDS} ({t_digest:.1f} s)")
    shutil.rmtree(SCENARIO_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    fleet = ClusterFrontend(fit_abacus(), n_replicas=SCENARIO_REPLICAS,
                            trace_root=os.path.join(SCENARIO_DIR, "traces"),
                            feedback_root=os.path.join(SCENARIO_DIR, "fb"),
                            tracer=scenario_trace)
    fleet.start()
    try:
        result = ScenarioRunner(fleet, sched, time_scale=0.0).run()
    finally:
        fleet.stop()
    t_replay = time.perf_counter() - t0
    oracles = check_all(result)
    for r in oracles:
        print(f"oracle {r.name}: {'ok' if r.ok else 'FAILED'} ({r.detail})")
    bad = failed(oracles)
    check(not bad, f"oracles failed: {[(r.name, r.detail) for r in bad]}")
    check(result.stats_after["replicas"] == 6, f"{result.stats_after['replicas']} replicas, want 6")
    print(json.dumps({"scenario": {"ground": result.ground,
                                   "resolved": len(result.resolved_outcomes()),
                                   "replicas": result.stats_after["replicas"],
                                   "generations": sorted(result.generations),
                                   "replay_wall_s": result.wall_s}}))
    shutil.rmtree(SCENARIO_DIR, ignore_errors=True)
    print(f"phase 16 wall time {time.perf_counter() - t_start:.1f} s: digests {t_digest:.1f} s, "
          f"fleet and replay {t_replay:.1f} s")


def examples_phase(torch) -> None:
    """Phase 18: ``EXAMPLE_RUNS`` as child processes at once, each in
    ``EXAMPLES_DIR``, within ``EXAMPLES_WALL_S``: each exits 0, names this
    card on its first line and prints its example's lines."""
    print("== phase 18: the port's examples on the card, as child processes: "
          + ", ".join(" ".join((k,) + v) for k, v in EXAMPLE_RUNS.items()))
    t0 = time.perf_counter()
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    os.makedirs(EXAMPLES_DIR)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    here = os.path.dirname(os.path.abspath(__file__))
    procs = {name: subprocess.Popen([sys.executable, os.path.join(here, "examples", name), *args],
                                    cwd=EXAMPLES_DIR, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, args in EXAMPLE_RUNS.items()}
    out = {}
    try:
        for name, proc in procs.items():
            left = max(0.1, EXAMPLES_WALL_S - (time.perf_counter() - t0))
            out[name] = proc.communicate(timeout=left)
    except subprocess.TimeoutExpired:
        check(False, f"phase 18's examples ran past {EXAMPLES_WALL_S:.0f} s")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    card = torch.cuda.get_device_name(0)
    for name, proc in procs.items():
        stdout, stderr = out[name]
        check(proc.returncode == 0, f"{name} exited {proc.returncode}: {stderr[-4000:]}")
        lines = stdout.splitlines()
        check(lines[:1] == [f"device: {card}"], f"{name} ran on {lines[:1]}, not {card}")
        print(f"{name}: " + " | ".join(lines))
    serve = out["serve_lm_torch.py"][0]
    check("arch=qwen2-0.5b (reduced) batch=4" in serve
          and re.search(r"^prefill: [\d.]+ ms, decode: [\d.]+ ms/token$", serve, re.M)
          and [len(t.split(",")) for t in re.findall(r"^  request \d: \[(.*)\]$", serve, re.M)]
          == [17] * 4, "serve_lm_torch.py's lines")
    loss = re.search(r"^loss ([\d.]+) -> ([\d.]+) over 20 steps \(retries=0\)$",
                     out["train_lm_torch.py"][0], re.M)
    check(loss is not None and float(loss[2]) < float(loss[1]), "train_lm_torch.py's loss line")
    shutil.rmtree(EXAMPLES_DIR)
    print(f"phase 18 wall time {wall:.1f} s")


def new_archs_phase(torch, F, kops, attention_ref, get_config, build_model, all_plain,
                    DecodeEngine, counters):
    """Phase 13: the MoE, hybrid, VLM and audio archs of ``PHASE13`` at full
    width, each checked in fp32 (``model_check_phase``) and served in bf16
    with its kernels' launches counted (``serve_phase``, ``serve_launches``),
    then moonshot-v1-16b-a3b's prefill flash call timed. Returns each arch's
    prefill launches and the flash call's entry of the ``kernels`` line."""
    print("== phase 13 (main path): the MoE, hybrid, VLM and audio archs at full width, on "
          "the card while phase 11's fits run on the host")
    t0 = time.perf_counter()
    launches = {}
    for arch, check_depth, serve_depth, steps in PHASE13:
        t = time.perf_counter()
        cfg = get_config(arch)
        model_check_phase(torch, "phase 13", cfg, build_model, all_plain, steps, check_depth)
        served = dataclasses.replace(cfg, num_layers=serve_depth or cfg.num_layers)
        launches[arch] = serve_phase(torch, "phase 13", served, build_model, DecodeEngine,
                                     counters, *serve_launches(served))
        print(f"phase 13 {arch}: {time.perf_counter() - t:.1f} s")
    moonshot = get_config("moonshot-v1-16b-a3b")
    flash = model_layout_main(torch, F, kops, attention_ref, None, MOONSHOT_ATTN_SHAPE,
                              moonshot.num_kv_heads)
    print(f"phase 13 wall time {time.perf_counter() - t0:.1f} s")
    return launches, flash


def fit_worker_start() -> None:
    """A fit worker's start: the port's sources on its path, numpy's BLAS on
    one thread (the fits run side by side)."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, SRC)


def fit_predictor(representation: str, fit_on, records):
    """One DNNAbacus fit on ``fit_on`` with the bounded pool, in a worker
    process: its ``to_dict``, and whether the ``to_dict``/``from_dict``
    round trip predicts ``records`` identically."""
    from repro_torch.core.predictor import DNNAbacus
    ab = DNNAbacus(representation=representation, seed=0).fit(
        fit_on, candidate_factory=bench_candidates)
    d = json.loads(json.dumps(ab.to_dict()))
    (t, m), (t_back, m_back) = ab.predict(records), DNNAbacus.from_dict(d).predict(records)
    return d, bool((t_back == t).all() and (m_back == m).all())


def fit_predictors(jobs: dict, records, meanwhile):
    """``{name: (representation, records to fit on)}`` -> ``{name: DNNAbacus}``,
    fitted side by side, one spawned process each (the fits are numpy and
    single-threaded, and take minutes one after another), and the seconds
    spent waiting for them after ``meanwhile()``, which runs here while they
    do."""
    from repro_torch.core.predictor import DNNAbacus
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(jobs), mp_context=ctx, initializer=fit_worker_start) as pool:
        futures = {k: pool.submit(fit_predictor, rep, fit_on, records)
                   for k, (rep, fit_on) in jobs.items()}
        meanwhile()
        t0 = time.perf_counter()
        fitted = {k: f.result() for k, f in futures.items()}
        waited = time.perf_counter() - t0
    for k, (_, same) in fitted.items():
        check(same, f"the {k} predictor's to_dict/from_dict round trip changes its predictions")
    return {k: DNNAbacus.from_dict(d) for k, (d, _) in fitted.items()}, waited


def profile_device(torch, label: str, fn, wall_ms: float, reps: int = 1):
    """Where the device time of ``fn`` goes: kernels by name, and the aten ops
    that launched them, against a wall time measured unprofiled
    (informational; nothing is checked)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type != DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    launches = sum(e.count for e in kernels) / reps
    print(f"{label} profile: kernel time {busy:.3f} ms in {launches:.0f} launches per call; "
          f"against the timed {wall_ms:.3f} ms wall the device is busy "
          f"{100 * busy / wall_ms:.1f}%")
    for title, rows in (("kernels", kernels), ("ops", ops)):
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"  {title}: {e.self_device_time_total / 1e3 / reps:9.3f} ms  "
                  f"x{e.count / reps:<6g} {e.key[:80]}")


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import profiler as tprof
    from repro_torch.core import randomgen as trand
    from repro_torch.core import zoo as tzoo
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import attention_ref, rmsnorm_ref
    from repro_torch.models import build_model
    from repro_torch.models.api import use_impls
    from repro_torch.models.ssm import ssd_carry, ssd_chunked_ref
    from repro_torch.serve.engine import DecodeEngine
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep

    # fp32 stays fp32: no TF32 in matrix products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print("== phase 1: device and build")
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libraries = {"flash_attention": fa.LIBRARY, "ssd_scan": ssd.LIBRARY, "rmsnorm": rn.LIBRARY}
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, together
        for fut in [pool.submit(lib.load) for lib in libraries.values()]:
            fut.result()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name, lib in libraries.items():
        print(f"{name}: {lib.path().name}")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")
    points = corpus_points(tprof, trand, get_config, reduced_config)
    ahead = tprof.TraceAhead(points, DEVICE, trace_workers())
    print(f"phase 11's corpus: {len(points)} records traced ahead in {ahead.workers} spawned "
          f"worker processes ({os.cpu_count()} cores), beside phases 2-10")
    # each kernel's launch counter: its wrapper module and the counter's name
    counters = {"flash_attention": (fa, "launches"), "ssd_scan": (ssd, "launches"),
                "rmsnorm_fwd": (rn, "fwd_launches"), "rmsnorm_bwd": (rn, "bwd_launches")}

    def all_plain():
        return use_impls(attention="plain", ssd="plain", norm="plain")

    flash_main = kernel_phase(torch, F, fa, kops, attention_ref)
    qwen = get_config("qwen2-0.5b")
    model_check_phase(torch, "phase 3", qwen, build_model, all_plain, steps=1)
    qwen_launches = serve_phase(torch, "phase 4", qwen, build_model, DecodeEngine, counters,
                                *serve_launches(qwen))
    attention_ops_listing(torch, qwen)

    ssd_main = ssd_phase(torch, ssd, ssd_chunked_ref)
    check(set(ssd_main) == {SSD_MAIN, JAMBA_SSD_SHAPE}, "a main-path SSD shape was not run")
    split_main = ssd_split_phase(torch, ssd, ssd_chunked_ref, ssd_carry)
    mamba = get_config("mamba2-370m")
    model_check_phase(torch, "phase 6", mamba, build_model, all_plain, steps=3)
    mamba_launches = serve_phase(torch, "phase 7", mamba, build_model, DecodeEngine, counters,
                                 *serve_launches(mamba))
    split_launches = split_prefill_phase(torch, mamba, build_model, ssd)

    rms_main = rmsnorm_phase(torch, F, rn, rmsnorm_ref)
    check(set(rms_main) == {"rmsnorm_fwd", "rmsnorm_bwd"}, "main-path RMSNorm shape was not run")
    train_check_phase(torch, qwen, build_model, use_impls, topt, tstep, counters)
    profile_launches, lm_records = profile_phase(torch, qwen, mamba, build_model, tprof, tstep,
                                                 topt, counters)

    t11 = time.perf_counter()
    traced = ahead.results()  # every worker ends here, before phase 11's card work
    waited = time.perf_counter() - t11
    trace_s = sum(t["trace_s"] for t in traced)
    print(f"phase 11: the corpus's {len(traced)} traces took {trace_s:.1f} s in "
          f"{ahead.workers} workers, {waited:.1f} s of it waited for here")
    zoo_check_phase(torch, tzoo, tprof)
    t_corpus = time.perf_counter()
    cnn_records, cnn_s = corpus_phase(torch, tzoo, tprof, points, traced, counters)
    lm_corpus, lm_s = lm_corpus_phase(torch, tprof, points, traced, counters)
    records = cnn_records + lm_records + lm_corpus
    t_fit = time.perf_counter()
    corpus_wall = waited + t_fit - t_corpus
    print(f"phase 11 corpus wall time {corpus_wall:.1f} s ({waited:.1f} s waiting for the "
          f"trace workers, then the card's part of its {len(traced)} records "
          f"{cnn_s + lm_s:.1f} s); serially the same records cost {trace_s + cnn_s + lm_s:.1f} "
          f"s (traces {trace_s:.1f} s, the card's part {cnn_s + lm_s:.1f} s)")
    new_archs = {}

    chatglm = get_config("chatglm3-6b")

    def meanwhile():  # while the fits run in their processes
        new_archs["launches"], new_archs["flash"] = new_archs_phase(
            torch, F, kops, attention_ref, get_config, build_model, all_plain, DecodeEngine,
            counters)
        t0 = time.perf_counter()
        print(f"== phase 12: {chatglm.name} at full width, checked and served beside the fits")
        model_check_phase(torch, "phase 12", chatglm, build_model, all_plain, steps=1)
        serve_phase(torch, "phase 12", chatglm, build_model, DecodeEngine, counters,
                    *serve_launches(chatglm))
        model_layout_main(torch, F, kops, attention_ref, None, CHATGLM_ATTN_SHAPE,
                          chatglm.num_kv_heads)
        new_archs["chatglm_s"] = time.perf_counter() - t0
        nsm_cpu_check(tprof, dataclasses.replace(qwen, dtype="bfloat16"), lm_records[0])
        new_archs["train"] = train_run(torch, get_config, build_model, counters)
        new_archs["sharded"] = sharded_phase()
    service_abacus, service_records = experiment_phase(np, records, tzoo, meanwhile)
    t_end = time.perf_counter()
    print(f"phase 11 wall time {t_end - t11:.1f} s ({len(records)} records): checks "
          f"{t_corpus - t11 - waited:.1f} s, corpus {corpus_wall:.1f} s, fits with phase 13, "
          f"phase 12's {chatglm.name}, phase 10's NSM check and phase 15's in-process half "
          f"beside them {t_end - t_fit:.1f} s")

    cold = service_phase(torch, np, service_abacus, lm_records[:len(PROFILE_POINTS)],
                         get_config)
    print(f"phase 12 wall time {time.perf_counter() - t_end:.1f} s of queries "
          f"({chatglm.name}'s {new_archs['chatglm_s']:.1f} s ran beside the fits)")

    abacus1 = fleet_phase(torch, np, service_abacus, cold, service_records,
                          lm_records[:len(PROFILE_POINTS)], get_config, tprof, counters)
    dryrun = {}

    def beside_the_launcher():  # phases 16, 17's dry run and 18 while the launcher trains
        started = dryrun_start(os.path.join(TRAIN_DIR, "abacus"))
        scenario_phase()
        examples_phase(torch)
        dryrun["wall_s"] = dryrun_finish(**started)
    train_phase(torch, abacus1, get_config, new_archs["train"], meanwhile=beside_the_launcher)
    print(f"phase 17 wall time: the sharded child {new_archs['sharded']:.1f} s beside phase 11's "
          f"fits, the dry run {dryrun['wall_s']:.1f} s beside phase 15's child")

    # each kernel at its main shape, and flash and the SSD scan also at
    # phase 13's: launches are those of the main path's call at that shape
    # (a prefill; phase 10's qwen2-0.5b profile_lm call for RMSNorm)
    flash_source = "src/repro_torch/kernels/csrc/flash_attention.cu"
    ssd_source = "src/repro_torch/kernels/csrc/ssd_scan.cu"
    rms_source = "src/repro_torch/kernels/csrc/rmsnorm.cu"
    moonshot, jamba = "moonshot-v1-16b-a3b", "jamba-v0.1-52b"
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        dict(name="flash_attention", route="cuda", source=flash_source,
             replaces="src/repro/kernels/flash_attention.py:32",
             launches=qwen_launches["flash_attention"], shape=f"qwen2-0.5b {MAIN_SHAPE}",
             **flash_main),
        dict(name=f"flash_attention ({moonshot})", route="cuda", source=flash_source,
             replaces="src/repro/kernels/flash_attention.py:32",
             launches=new_archs["launches"][moonshot]["flash_attention"],
             shape=f"{moonshot} {MOONSHOT_ATTN_SHAPE}", **new_archs["flash"]),
        dict(name="ssd_scan", route="cuda", source=ssd_source,
             replaces="src/repro/kernels/ssd_scan.py:24",
             launches=mamba_launches["ssd_scan"], shape=f"mamba2-370m {SSD_MAIN}",
             **ssd_main[SSD_MAIN]),
        dict(name=f"ssd_scan ({jamba})", route="cuda", source=ssd_source,
             replaces="src/repro/kernels/ssd_scan.py:24",
             launches=new_archs["launches"][jamba]["ssd_scan"],
             shape=f"{jamba} {JAMBA_SSD_SHAPE}", **ssd_main[JAMBA_SSD_SHAPE]),
        dict(name="ssd_scan split (states + output calls)", route="cuda", source=ssd_source,
             replaces="src/repro/kernels/ssd_scan.py:24", launches=split_launches,
             shape=f"mamba2-370m {SSD_MAIN}, blocks {SPLIT_CUTS}", **split_main[SSD_MAIN]),
        dict(name="rmsnorm_fwd", route="cuda", source=rms_source,
             replaces="src/repro/kernels/rmsnorm.py:18",
             launches=profile_launches["rmsnorm_fwd"], shape=f"qwen2-0.5b {RMS_MAIN}",
             **rms_main["rmsnorm_fwd"]),
        dict(name="rmsnorm_bwd", route="cuda", source=rms_source,
             replaces="src/repro/kernels/rmsnorm.py:18",
             launches=profile_launches["rmsnorm_bwd"], shape=f"qwen2-0.5b {RMS_MAIN}",
             **rms_main["rmsnorm_bwd"]),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--sharded-child"]:  # phase 17's card half, spawned by sharded_phase
        sys.exit(sharded_child())
    sys.exit(main())
