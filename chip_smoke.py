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
   ``scaled_dot_product_attention`` times and the card's bound;
3. qwen2-0.5b at full width in fp32 (TF32 off): prefill logits through the
   kernel against the plain path, and prefill -> decode teacher forcing
   against the full forward, both at 2e-3;
4. the first main path: qwen2-0.5b in bf16 at full width served by
   ``DecodeEngine`` (batch 8, prompt 2048 padded to 2081, 32 greedy
   steps), twice, with the kernels' launch counts read around each run,
   then device profiles of one prefill and of decode steps;
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
   ``DecodeEngine``, as in phase 4.

Any failed check raises, so the script exits nonzero without the final
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

SERVE_BATCH, PROMPT, STEPS = 8, 2048, 32
MODEL_CHECK_BATCH, MODEL_CHECK_SEQ = 2, 300  # ragged against the kernels' 32- and 64-row tiles
DEVICE = "cuda"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(bh: int, sq: int, sk: int, d: int, causal: bool, dtype_bytes: int,
                       peak_flops: float):
    """Least time for the work: 4*d FLOP per (query, key) pair the mask keeps,
    against q, k, v read once and o written once."""
    if causal:  # top-left aligned: query i keeps keys 0..min(i, sk-1)
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4.0 * d * pairs * bh
    nbytes = float(dtype_bytes) * bh * d * (2 * sq + 2 * sk)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(torch, F, fa, attention_ref):
    print("== phase 2: flash-attention kernel vs plain on the card")
    main = None
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
                    main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                bound_by=by, library_ms=lib_ms)
                del q, k, v, got, want, diff
    return main


def model_check_phase(torch, label, cfg_full, build_model, set_impl, steps):
    print(f"== {label}: {cfg_full.name} full width, fp32 (TF32 off): kernel vs plain, "
          f"prefill -> {steps} decode steps")
    cfg = dataclasses.replace(cfg_full, dtype="float32")
    model = build_model(cfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    b, s = MODEL_CHECK_BATCH, MODEL_CHECK_SEQ
    tokens = (torch.arange(b * s, device=DEVICE).reshape(b, s) * 7) % (cfg.vocab_size - 1)
    with torch.no_grad():
        set_impl("plain")
        try:
            plain, _ = model.prefill({"tokens": tokens})
        finally:
            set_impl(None)
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


def serve_phase(torch, label, cfg, build_model, DecodeEngine, counters, expect):
    """Serve ``cfg`` in bf16 through ``DecodeEngine`` twice; ``counters`` maps a
    kernel's name to its wrapper module, whose ``launches`` are set to 0 just
    before each run and read just after; ``expect`` gives each kernel's
    launches per prefill. Returns the launch counts of the first run."""
    print(f"== {label} (main path): {cfg.name} bf16 full width through DecodeEngine")
    model = build_model(cfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    total = PROMPT + STEPS + 1
    prompts = ((torch.arange(SERVE_BATCH * total, device=DEVICE).reshape(SERVE_BATCH, total)
                * 13) % (cfg.vocab_size - 1))
    prompts[:, PROMPT:] = 0

    def serve_once():
        engine = DecodeEngine(model, batch=SERVE_BATCH, max_seq=total)
        torch.cuda.synchronize()
        for mod in counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        first = engine.prefill({"tokens": prompts})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = {name: mod.launches for name, mod in counters.items()}
        out = engine.generate(first, STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import build_model
    from repro_torch.models.attention import set_attention_impl
    from repro_torch.models.ssm import set_ssd_impl, ssd_chunked_ref
    from repro_torch.serve.engine import DecodeEngine

    # fp32 stays fp32: no TF32 in matrix products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print("== phase 1: device and build")
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels = {"flash_attention": fa, "ssd_scan": ssd}
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source, together
        for fut in [pool.submit(mod.LIBRARY.load) for mod in kernels.values()]:
            fut.result()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name, mod in kernels.items():
        print(f"{name}: {mod.LIBRARY.path().name}")
        for line in mod.LIBRARY.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    flash_main = kernel_phase(torch, F, fa, attention_ref)
    check(flash_main is not None, "main-path flash-attention shape was not run")
    qwen = get_config("qwen2-0.5b")
    model_check_phase(torch, "phase 3", qwen, build_model, set_attention_impl, steps=1)
    qwen_launches = serve_phase(torch, "phase 4", qwen, build_model, DecodeEngine, kernels,
                                {"flash_attention": qwen.num_layers, "ssd_scan": 0})

    ssd_main = ssd_phase(torch, ssd, ssd_chunked_ref)
    check(ssd_main is not None, "main-path SSD shape was not run")
    mamba = get_config("mamba2-370m")
    model_check_phase(torch, "phase 6", mamba, build_model, set_ssd_impl, steps=3)
    mamba_launches = serve_phase(torch, "phase 7", mamba, build_model, DecodeEngine, kernels,
                                 {"flash_attention": 0, "ssd_scan": mamba.num_layers})

    print(json.dumps({"kernels": [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:32",
             launches=qwen_launches["flash_attention"], **flash_main),
        dict(name="ssd_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:24",
             launches=mamba_launches["ssd_scan"], **ssd_main),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
