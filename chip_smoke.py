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
   beside the (B*H, S, d) call, SDPA and the bound;
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
   chunk, and the serving prefill's (8, 2081, 32, 64, N 128, chunk 256),
   the last also with slow decay (the state carried across whole chunks),
   with kernel and plain times and the card's bound;
6. mamba2-370m at full width in fp32 (TF32 off): prefill logits through the
   kernel against the plain path, and prefill -> 3 decode steps against
   the full forward, both at 2e-3;
7. the second main path: mamba2-370m in bf16 at full width served by
   ``DecodeEngine``, as in phase 4;
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
   warm-up and the timed steps); the NSM traced on card tensors against
   the CPU trace; the step's time on seeded random state against zeros; a
   device profile of one step; and one mamba2-370m record;
11. the fourth main path, the paper's experiment: every one of the 29 zoo
   CNNs' forward, loss and gradients at batch 8 on the card (TF32 off), in
   float64 and in fp32, against the CPU's float64 step (float64 within
   1e-10; fp32 within four times the CPU fp32 step's error or a floor, see
   ``ZOO_CHECK_FLOOR`` and ``ZOO_FP32_ALLOWANCE``), with a per-layer check
   of ``ZOO_LAYER_NETS`` under each cuDNN setting (``zoo_layer_check``), and
   a zoo step's NSM and FLOPs traced on card tensors against the CPU trace;
   then the corpus, ``profile_zoo`` on the card over the reference's
   default grid (``benchmarks/collect.py::zoo_grid``, 76 points),
   ``random_cnn`` seeds 0-11, phase 10's four ``profile_lm`` records and
   the LMs of collect.py's lm_grid and random_grid (``LM_GRID_ARCHS``
   reduced, ``random_lm_config`` of ``RANDOM_LM_SEEDS``), each printed as a
   JSON line; then DNNAbacus fitted on those records as
   ``benchmarks/bench_mre.py`` (70/30 split, with the shape-inference and
   MLP baselines) and ``bench_unseen.py`` (zero-shot on the five unseen
   nets, NSM and graph embedding) do, its MREs printed as one JSON line,
   and the phase's wall time. The fits, phase 12's among them, run side by
   side in spawned worker processes;
12. the fifth main path, the online query: ``DNNAbacus.service()`` over a
   predictor fitted on every record but qwen2-0.5b's, asked cold and warm
   about qwen2-0.5b at phase 10's points and chatglm3-6b, phi4-mini-3.8b
   and qwen2.5-32b at (8, 2048) (one trace a key, identical warm answers at
   least 10x faster, each qwen2-0.5b record equal to phase 10's but for
   FLOPs, time and memory), one JSON line a query with both FLOPs counts
   and, for qwen2-0.5b, the measured time and memory; then chatglm3-6b at
   full width, fp32 checks as phase 3 and bf16 served as phase 4 through the
   flash-attention (head_dim 128, 16:1 grouped KV) and RMSNorm kernels, and
   its prefill's flash call timed beside SDPA and the bound.

Phase 11's CNN steps run none of the hand-written kernels (a CNN has no
attention, scan or RMSNorm; their launches are counted around the zoo corpus
and must be 0); its LM records' steps run the RMSNorm kernels, counted
around each ``profile_lm`` call. Nothing in phases 11 and 12 is caught: a
record, a query or a kernel that fails fails the run.
Phases 3, 6 and 12 run their plain side with every kernel pinned plain;
phases 4, 7 and 12 count the RMSNorm kernel too (one launch a norm, each
prefill and each decode step). Any failed check raises, so the script exits
nonzero without the final line; so it does without a card, or away from the
repository's sources.
The last lines are a JSON object of kernel results, the card's
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
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
# (1, 67, 2081), jamba's N 16 / chunk 64, and the serving prefill's
SSD_SHAPES = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32), (1, 96, 1, 64, 32, 32),
              (2, 1, 4, 32, 16, 64), (2, 67, 4, 64, 64, 32), (2, 2081, 8, 64, 128, 256),
              (2, 300, 4, 64, 16, 64), (8, 2081, 32, 64, 128, 256)]
SSD_MAIN = (8, 2081, 32, 64, 128, 256)  # mamba2-370m serving prefill: 32 heads, P 64, N 128
# shapes also run with slow decay (dt = softplus(draw - 4)), so the state
# carried across chunks reaches deep into each chunk and the final state
SSD_SLOW = (SSD_MAIN,)
SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}  # y; the fp32 final state holds to 2e-4

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
# collect.py's lm_grid (LM_ARCHS the port builds) and random_grid's rand_lm
# seeds 0-11 but the MoE draws 7 and 11 (no MoE layer is ported), reduced or
# drawn in fp32, each profiled at (2, 64) with steps=2
LM_GRID_ARCHS = ["qwen2-0.5b", "chatglm3-6b", "phi4-mini-3.8b", "mamba2-370m"]
RANDOM_LM_SEEDS = [0, 1, 2, 3, 4, 5, 6, 8, 9, 10]
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
# three dense configs are asked about at (8, 2048) at full width. Warm
# queries must be 10x faster than cold at the median, the reference's target
# (benchmarks/bench_service.py). chatglm3-6b is then served through the
# flash-attention (head_dim 128, 16:1 grouped KV) and RMSNorm kernels.
SERVICE_UNSEEN = "qwen2-0.5b"
SERVICE_ARCHS = ["chatglm3-6b", "phi4-mini-3.8b", "qwen2.5-32b"]
SERVICE_POINT = (8, 2048)
WARM_SPEEDUP_MIN = 10.0
CHATGLM_ATTN_SHAPE = (8, 2081, 32, 128)  # chatglm3-6b's serving prefill: 32 heads of 128
SERVE_BATCH, PROMPT, STEPS = 8, 2048, 32
MODEL_CHECK_BATCH, MODEL_CHECK_SEQ = 2, 300  # ragged against the kernels' 32- and 64-row tiles
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
    return model_layout_main(torch, F, kops, attention_ref, bhsd)


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


def model_check_phase(torch, label, cfg_full, build_model, all_plain, steps):
    print(f"== {label}: {cfg_full.name} full width, fp32 (TF32 off): kernels vs plain, "
          f"prefill -> {steps} decode steps")
    cfg = dataclasses.replace(cfg_full, dtype="float32")
    model = build_model(cfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    b, s = MODEL_CHECK_BATCH, MODEL_CHECK_SEQ
    tokens = (torch.arange(b * s, device=DEVICE).reshape(b, s) * 7) % (cfg.vocab_size - 1)
    with torch.no_grad():
        with all_plain():
            plain, _ = model.prefill({"tokens": tokens})
        kern, cache = model.prefill({"tokens": tokens})
        err = (kern - plain).abs().max().item()
        vocab_rows = -(-cfg.vocab_size // 256) * 256
        check(kern.shape == (b, 1, vocab_rows), f"prefill logits shape {tuple(kern.shape)}")
        check(bool(torch.isfinite(kern[..., :cfg.vocab_size]).all()), "non-finite logits")
        check(torch.allclose(kern, plain, atol=MODEL_TOL, rtol=MODEL_TOL),
              f"prefill kernel vs plain: max abs err {err}")
        print(f"prefill logits kernel vs plain: max_abs_err={err:.3e} (tol {MODEL_TOL})")

        nxt = (torch.arange(b * steps, device=DEVICE).reshape(b, steps) * 3 + 1) % cfg.vocab_size
        full, _ = model.forward({"tokens": torch.cat([tokens, nxt], dim=1)})
        # attention caches get room for the steps (the engine's prompt-sized
        # cache has none); the SSM state has no sequence axis
        cache = [{n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, steps)) if n in ("k", "v") else t
                  for n, t in c.items()} for c in cache]
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
    print(f"== {label} (main path): {cfg.name} bf16 full width through DecodeEngine")
    model = build_model(cfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    total = PROMPT + STEPS + 1
    prompts = ((torch.arange(SERVE_BATCH * total, device=DEVICE).reshape(SERVE_BATCH, total)
                * 13) % (cfg.vocab_size - 1))
    prompts[:, PROMPT:] = 0

    def serve_once():
        engine = DecodeEngine(model, batch=SERVE_BATCH, max_seq=total)
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        first = engine.prefill({"tokens": prompts})
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
        counts = " ".join(f"{name}_launches={n}" for name, n in launches.items())
        print(f"serve run {i}: prefill_ms={prefill_ms:.3f} decode_ms_per_token={decode_ms:.3f} "
              f"{counts} max_memory_allocated={peak} ({peak / 2**30:.3f} GiB)")
        check(launches == expect, f"kernel launches per prefill {launches}, want {expect}")
        check(out.shape == (SERVE_BATCH, STEPS + 1), f"tokens shape {tuple(out.shape)}")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token out of vocab")
        runs.append((out, launches, prefill_ms, decode_ms))
    check(torch.equal(runs[0][0], runs[1][0]), "two serve runs gave different tokens")
    print(f"serve tokens deterministic over 2 runs; request 0: {runs[1][0][0].tolist()}")
    profile_device(torch, "prefill", lambda: model.prefill({"tokens": prompts}),
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
    print("== phase 5: SSD chunked-scan kernel vs plain on the card")
    main = None
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
            if shape == SSD_MAIN and dtype == torch.bfloat16 and not slow:
                main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            bound_by=by, library_ms=None)
            del xb, dt, a_neg, bm, cm, y, state
    torch.cuda.empty_cache()
    return main


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


def step_launches(cfg) -> dict:
    """Each kernel's launches in one train step of ``cfg``: every RMSNorm
    forward (one before a layer's mixer, one before its MLP where it has
    one, and the final norm), again in the remat recompute of each layer,
    and backward; attention and the SSD scan run plain in training."""
    norms = sum(1 + (cfg.layer_kind(i)[1] != "none") for i in range(cfg.num_layers)) + 1
    recompute = norms - 1 if cfg.remat == "full" else 0
    return {"flash_attention": 0, "ssd_scan": 0, "rmsnorm_fwd": norms + recompute,
            "rmsnorm_bwd": norms}


def profile_record(torch, tprof, cfg, b: int, s: int, counters, steps: int = PROFILE_STEPS):
    """``profile_lm`` on the card at (b, s), checked and printed as one JSON
    line, with the kernels' launches counted over exactly that call: one
    warm-up and ``steps`` timed steps, each the launches of one step (the
    trace for FLOPs and the NSM runs every kernel plain)."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts(counters)
    rec = tprof.profile_lm(cfg, b, s, steps=steps, device=DEVICE)
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
    launches of each ``profile_lm`` call, their NSM against a CPU trace,
    zeros against random state, where the step's device time goes, and one
    mamba2 record. Returns the launches of the main point's call and the
    four records."""
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
    b0, s0 = PROFILE_POINTS[0]
    _, step0, specs0, batch0 = tprof.lm_trace(cfg, b0, s0)
    cpu_edges = tprof.trace_step(step0, (specs0, batch0), device="cpu")["nsm_edges"]
    check(cpu_edges == records[0].nsm_edges, "NSM traced on card tensors differs from the CPU's")
    print(f"NSM at {(b0, s0)} traced on card tensors equals the CPU trace "
          f"({len(cpu_edges)} pairs, {sum(cpu_edges.values()):.0f} edges)")

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

    mamba_rec, _ = profile_record(torch, tprof, dataclasses.replace(mamba_full, dtype="bfloat16"),
                                  *MAMBA_POINT, counters)
    return runs[-1][1], records + [mamba_rec]


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


def corpus_phase(torch, tzoo, tprof, trand, counters):
    """The corpus on the card: the reference's default zoo grid and the random
    CNNs, each a ``profile_zoo`` call (a trace, a warm-up step and the timed
    steps), with the kernels' launches counted around all of them."""
    print(f"== phase 11: the corpus, {len(ZOO_GRID)} zoo points and {len(RANDOM_CNN_SEEDS)} "
          f"random CNNs profiled on the card")
    records = []
    torch.cuda.synchronize()
    reset_counts(counters)
    for combo in ZOO_GRID:
        t0 = time.perf_counter()
        rec = tprof.profile_zoo(combo["name"], batch=combo["batch"], image=combo["image"],
                                optimizer=combo.get("optimizer", "sgd"),
                                steps=ZOO_PROFILE_STEPS, device=DEVICE)
        check_record(rec)
        records.append(rec)
        print(record_line(rec, time.perf_counter() - t0))
    for seed in RANDOM_CNN_SEEDS:
        t0 = time.perf_counter()
        rec = tprof.profile_zoo_model(trand.random_cnn(seed), batch=8 + 8 * (seed % 3), image=32,
                                      steps=ZOO_PROFILE_STEPS, family="rand_cnn", device=DEVICE)
        check_record(rec)
        records.append(rec)
        print(record_line(rec, time.perf_counter() - t0))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    check(not any(launches.values()), f"the zoo's steps launched a hand-written kernel: "
                                      f"{launches}")
    print(f"kernel launches over the corpus's CNN steps: {launches}")
    check(set(tzoo.ZOO) <= {r.model_name for r in records}, "a zoo net has no record")
    torch.cuda.empty_cache()
    return records


def lm_corpus_phase(torch, tprof, trand, get_config, reduced_config, counters):
    """The corpus's LMs on the card, as collect.py's lm_grid and random_grid
    profile them: each ported arch of ``LM_ARCHS`` reduced, and the dense
    and SSM draws of ``random_lm_config``, fp32 at ``LM_POINT``, each a
    ``profile_lm`` call whose RMSNorm launches are counted."""
    print(f"== phase 11: the corpus's LMs, {len(LM_GRID_ARCHS)} reduced archs and "
          f"{len(RANDOM_LM_SEEDS)} random LMs profiled on the card at {LM_POINT}")
    cfgs = ([reduced_config(get_config(a)) for a in LM_GRID_ARCHS]
            + [trand.random_lm_config(seed) for seed in RANDOM_LM_SEEDS])
    records = [profile_record(torch, tprof, cfg, *LM_POINT, counters, steps=LM_PROFILE_STEPS)[0]
               for cfg in cfgs]
    for rec in records:
        check_record(rec)
    return records


def experiment_phase(np, records, tzoo):
    """DNNAbacus on the card's records, as the reference's bench_mre.py and
    bench_unseen.py fit it, its MREs printed as one JSON line; fitted with
    phase 12's predictor beside them, which is returned."""
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
    models = fit_predictors({"split": ("nsm", train), "nsm": ("nsm", seen), "ge": ("ge", seen),
                             "service": ("nsm", unqueried)}, records)
    print(f"4 DNNAbacus fits in {time.perf_counter() - t0:.1f} s, one worker process each "
          f"(split {len(train)}, seen {len(seen)}, seen {len(seen)}, service {len(unqueried)} "
          f"records)")
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
    return models["service"]


def service_phase(torch, np, abacus, qwen_records, get_config):
    """Phase 12: the online query. ``abacus`` was fitted on every corpus record
    but qwen2-0.5b's, whose phase 10 records (``qwen_records``, one per
    ``PROFILE_POINTS``) are the truth for its answers. Cold queries through
    ``abacus.service()`` (one trace a key), the same queries warm (cache hits,
    identical estimates, ``WARM_SPEEDUP_MIN`` times faster at the median),
    ``predict_config`` against ``predict_one``, each qwen2-0.5b record of the
    service against phase 10's (equal but for FLOPs, time and memory), and
    one JSON line a query."""
    from repro_torch.core.predictor import HBM_PER_DEVICE
    print(f"== phase 12 (main path): the online query through DNNAbacus.service(), fitted "
          f"without {SERVICE_UNSEEN}")
    svc = abacus.service()
    queries = ([(get_config(SERVICE_UNSEEN), b, s) for b, s in PROFILE_POINTS]
               + [(get_config(arch), *SERVICE_POINT) for arch in SERVICE_ARCHS])
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
        line = dict(model=cfg.name, batch=b, seq=s, time_s=est["time_s"],
                    memory_bytes=est["memory_bytes"], admitted=est["admitted"],
                    flops_online=rec.flops, flops_traced=traced_flops,
                    offline_time_s=t_off, offline_memory_bytes=m_off,
                    param_bytes_bf16=2 * rec.params, cold_s=cold_s, warm_s=warm_s)
        for v in (est["time_s"], est["memory_bytes"], t_off, m_off):
            check(bool(np.isfinite(v)) and v > 0, f"{cfg.name} {(b, s)}: estimate {v}")
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
          f"FLOPs, time and memory (NSM and traced FLOPs included)")


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


def fit_predictors(jobs: dict, records) -> dict:
    """``{name: (representation, records to fit on)}`` -> ``{name: DNNAbacus}``,
    fitted side by side, one spawned process each (the fits are numpy and
    single-threaded, and take minutes one after another)."""
    from repro_torch.core.predictor import DNNAbacus
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(jobs), mp_context=ctx, initializer=fit_worker_start) as pool:
        futures = {k: pool.submit(fit_predictor, rep, fit_on, records)
                   for k, (rep, fit_on) in jobs.items()}
        fitted = {k: f.result() for k, f in futures.items()}
    for k, (_, same) in fitted.items():
        check(same, f"the {k} predictor's to_dict/from_dict round trip changes its predictions")
    return {k: DNNAbacus.from_dict(d) for k, (d, _) in fitted.items()}


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
    from repro_torch.models.ssm import ssd_chunked_ref
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
    # each kernel's launch counter: its wrapper module and the counter's name
    counters = {"flash_attention": (fa, "launches"), "ssd_scan": (ssd, "launches"),
                "rmsnorm_fwd": (rn, "fwd_launches"), "rmsnorm_bwd": (rn, "bwd_launches")}

    def all_plain():
        return use_impls(attention="plain", ssd="plain", norm="plain")

    flash_main = kernel_phase(torch, F, fa, kops, attention_ref)
    qwen = get_config("qwen2-0.5b")
    norms = 2 * qwen.num_layers + 1  # two a layer and the final norm
    model_check_phase(torch, "phase 3", qwen, build_model, all_plain, steps=1)
    qwen_launches = serve_phase(
        torch, "phase 4", qwen, build_model, DecodeEngine, counters,
        {"flash_attention": qwen.num_layers, "ssd_scan": 0, "rmsnorm_fwd": norms,
         "rmsnorm_bwd": 0},
        {"flash_attention": 0, "ssd_scan": 0, "rmsnorm_fwd": norms * STEPS, "rmsnorm_bwd": 0})
    attention_ops_listing(torch, qwen)

    ssd_main = ssd_phase(torch, ssd, ssd_chunked_ref)
    check(ssd_main is not None, "main-path SSD shape was not run")
    mamba = get_config("mamba2-370m")
    model_check_phase(torch, "phase 6", mamba, build_model, all_plain, steps=3)
    mamba_norms = mamba.num_layers + 1  # one a layer and the final norm
    mamba_launches = serve_phase(
        torch, "phase 7", mamba, build_model, DecodeEngine, counters,
        {"flash_attention": 0, "ssd_scan": mamba.num_layers, "rmsnorm_fwd": mamba_norms,
         "rmsnorm_bwd": 0},
        {"flash_attention": 0, "ssd_scan": 0, "rmsnorm_fwd": mamba_norms * STEPS,
         "rmsnorm_bwd": 0})

    rms_main = rmsnorm_phase(torch, F, rn, rmsnorm_ref)
    check(set(rms_main) == {"rmsnorm_fwd", "rmsnorm_bwd"}, "main-path RMSNorm shape was not run")
    train_check_phase(torch, qwen, build_model, use_impls, topt, tstep, counters)
    profile_launches, lm_records = profile_phase(torch, qwen, mamba, build_model, tprof, tstep,
                                                 topt, counters)

    t11 = time.perf_counter()
    zoo_check_phase(torch, tzoo, tprof)
    t_corpus = time.perf_counter()
    records = (corpus_phase(torch, tzoo, tprof, trand, counters) + lm_records
               + lm_corpus_phase(torch, tprof, trand, get_config, reduced_config, counters))
    t_fit = time.perf_counter()
    service_abacus = experiment_phase(np, records, tzoo)
    t_end = time.perf_counter()
    print(f"phase 11 wall time {t_end - t11:.1f} s ({len(records)} records): checks "
          f"{t_corpus - t11:.1f} s, corpus {t_fit - t_corpus:.1f} s, fits {t_end - t_fit:.1f} s")

    service_phase(torch, np, service_abacus, lm_records[:len(PROFILE_POINTS)], get_config)
    t_queries = time.perf_counter()
    chatglm = get_config("chatglm3-6b")
    model_check_phase(torch, "phase 12", chatglm, build_model, all_plain, steps=1)
    chatglm_norms = 2 * chatglm.num_layers + 1
    serve_phase(
        torch, "phase 12", chatglm, build_model, DecodeEngine, counters,
        {"flash_attention": chatglm.num_layers, "ssd_scan": 0, "rmsnorm_fwd": chatglm_norms,
         "rmsnorm_bwd": 0},
        {"flash_attention": 0, "ssd_scan": 0, "rmsnorm_fwd": chatglm_norms * STEPS,
         "rmsnorm_bwd": 0})
    model_layout_main(torch, F, kops, attention_ref, None, CHATGLM_ATTN_SHAPE,
                      chatglm.num_kv_heads)
    print(f"phase 12 wall time {time.perf_counter() - t_end:.1f} s: queries "
          f"{t_queries - t_end:.1f} s, chatglm3-6b {time.perf_counter() - t_queries:.1f} s")

    rms_source = "src/repro_torch/kernels/csrc/rmsnorm.cu"
    print(json.dumps({"kernels": [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:32",
             launches=qwen_launches["flash_attention"], **flash_main),
        dict(name="ssd_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:24",
             launches=mamba_launches["ssd_scan"], **ssd_main),
        dict(name="rmsnorm_fwd", route="cuda", source=rms_source,
             replaces="src/repro/kernels/rmsnorm.py:18",
             launches=profile_launches["rmsnorm_fwd"], **rms_main["rmsnorm_fwd"]),
        dict(name="rmsnorm_bwd", route="cuda", source=rms_source,
             replaces="src/repro/kernels/rmsnorm.py:18",
             launches=profile_launches["rmsnorm_bwd"], **rms_main["rmsnorm_bwd"]),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
