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
   device profile of one step; and one mamba2-370m record.

Phases 3 and 6 run their plain side with every kernel pinned plain; phases
4 and 7 count the RMSNorm kernel too (one launch a norm, each prefill and
each decode step). Any failed check raises, so the script exits nonzero without the final
line; so it does without a card, or away from the repository's sources.
The last lines are a JSON object of kernel results, the card's
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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


def model_layout_main(torch, F, kops, attention_ref, bhsd):
    """The main path's call: ``kernels.ops.flash_attention`` on q (B, S, H, d)
    and grouped k/v (B, S, KV, d) as the model makes them, against
    ``attention_ref`` on K/V expanded to H heads; timed beside the (BH, S, d)
    kernel call, SDPA and the bound. Its numbers are the kernel's entry in
    the ``kernels`` line."""
    b, s, h, hd = MAIN_SHAPE
    kv = MAIN_KV_HEADS
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
          f"model-layout kernel {MAIN_SHAPE} KV {kv}: max abs err {err} over tol {tol}")
    ms = time_ms(torch, lambda: kops.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: attention_ref(*flat, True))
    q4, k4, v4 = (t.view(b, h, s, hd) for t in flat)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    bound, by = attention_bound_ms(b * h, s, s, hd, True, 2, H100_BF16_FLOPS, kv / h)
    print(f"main shape {MAIN_SHAPE} bf16 causal, model layout with {kv} KV heads: "
          f"max_abs_err={err:.3e} (tol {tol}) ms={ms:.4f} (B*H, S, d) ms={bhsd['ms']:.4f}"
          f" sdpa_ms={lib_ms:.4f} (same call {bhsd['library_ms']:.4f}) "
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


def profile_record(torch, tprof, cfg, b: int, s: int, counters):
    """``profile_lm`` on the card at (b, s), checked and printed as one JSON
    line, with the kernels' launches counted over exactly that call: one
    warm-up and ``PROFILE_STEPS`` timed steps, each the launches of one step
    (the trace for FLOPs and the NSM runs every kernel plain)."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts(counters)
    rec = tprof.profile_lm(cfg, b, s, steps=PROFILE_STEPS, device=DEVICE)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    check(rec.time_s > 0 and rec.mem_bytes > 0 and rec.flops > 0 and rec.nsm_edges,
          f"{cfg.name} record at {(b, s)} has a zero measurement or an empty NSM")
    per_step = step_launches(cfg)
    want = {k: (PROFILE_STEPS + 1) * n for k, n in per_step.items()}
    check(launches == want, f"{cfg.name} profile_lm at {(b, s)}: kernel launches {launches}, "
                            f"want {want} ({PROFILE_STEPS + 1} steps of {per_step})")
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
    mamba2 record. Returns the launches of the main point's call."""
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

    profile_record(torch, tprof, dataclasses.replace(mamba_full, dtype="bfloat16"),
                   *MAMBA_POINT, counters)
    return runs[-1][1]


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
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core import profiler as tprof
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
    profile_launches = profile_phase(torch, qwen, mamba, build_model, tprof, tstep, topt,
                                     counters)

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
