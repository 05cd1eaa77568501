#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (built for an H100: the kernel targets sm_90a) and
``nvcc``; imports no JAX. Phases, each printing its results:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. the flash-attention kernel against its plain version ``attention_ref``
   on the card, causal and not, fp32 (tolerance 3e-5) and bf16 (2e-2):
   the reference's kernel-test shapes plus the serving prefill's
   (8, 2048, 14, 64) and ragged (8, 2081, 14, 64), with kernel, plain and
   ``scaled_dot_product_attention`` times and the card's bound;
3. qwen2-0.5b at full width in fp32 (TF32 off): prefill logits through the
   kernel against the plain path, and prefill -> decode teacher forcing
   against the full forward, both at 2e-3;
4. the main path: qwen2-0.5b in bf16 at full width served by
   ``DecodeEngine`` (batch 8, prompt 2048 padded to 2081, 32 greedy
   steps), twice, with the kernel's launch count read around each run,
   then device profiles of one prefill and of decode steps.

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

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12   # fp32 outside the tensor cores
H100_HBM_BYTES_S = 3.35e12

KERNEL_SHAPES = [(1, 128, 1, 32), (2, 256, 4, 64), (1, 384, 3, 64), (2, 128, 2, 128),
                 (8, 2048, 14, 64), (8, 2081, 14, 64)]
MAIN_SHAPE = (8, 2081, 14, 64)  # serving prefill: prompt 2048 + 32 steps + 1
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
MODEL_TOL = 2e-3

SERVE_BATCH, PROMPT, STEPS = 8, 2048, 32
MODEL_CHECK_BATCH, MODEL_CHECK_SEQ = 2, 300  # ragged against the 32- and 64-row tiles
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


def model_check_phase(torch, cfg_full, build_model, set_attention_impl):
    print("== phase 3: qwen2-0.5b full width, fp32 (TF32 off): kernel vs plain, "
          "prefill -> decode")
    cfg = dataclasses.replace(cfg_full, dtype="float32")
    model = build_model(cfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    b, s = MODEL_CHECK_BATCH, MODEL_CHECK_SEQ
    tokens = (torch.arange(b * s, device=DEVICE).reshape(b, s) * 7) % (cfg.vocab_size - 1)
    with torch.no_grad():
        set_attention_impl("plain")
        try:
            plain, _ = model.prefill({"tokens": tokens})
        finally:
            set_attention_impl(None)
        kern, cache = model.prefill({"tokens": tokens})
        err = (kern - plain).abs().max().item()
        vocab_rows = -(-cfg.vocab_size // 256) * 256
        check(kern.shape == (b, 1, vocab_rows), f"prefill logits shape {tuple(kern.shape)}")
        check(bool(torch.isfinite(kern[..., :cfg.vocab_size]).all()), "non-finite logits")
        check(torch.allclose(kern, plain, atol=MODEL_TOL, rtol=MODEL_TOL),
              f"prefill kernel vs plain: max abs err {err}")
        print(f"prefill logits kernel vs plain: max_abs_err={err:.3e} (tol {MODEL_TOL})")

        tok_next = torch.full((b, 1), 3, dtype=torch.long, device=DEVICE)
        full, _ = model.forward({"tokens": torch.cat([tokens, tok_next], dim=1)})
        grown = [{n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 1)) for n, t in c.items()}
                 for c in cache]
        step, _ = model.decode_step(grown, tok_next,
                                    torch.full((b,), s, dtype=torch.int32, device=DEVICE))
        err = (step[:, 0] - full[:, -1]).abs().max().item()
        check(torch.allclose(step[:, 0], full[:, -1], atol=MODEL_TOL, rtol=MODEL_TOL),
              f"prefill -> decode vs forward: max abs err {err}")
        print(f"prefill -> decode vs forward (teacher forcing): max_abs_err={err:.3e} "
              f"(tol {MODEL_TOL})")
    del model, cache, grown
    torch.cuda.empty_cache()


def serve_phase(torch, cfg, build_model, DecodeEngine, fa):
    print("== phase 4 (main path): qwen2-0.5b bf16 full width through DecodeEngine")
    model = build_model(cfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    total = PROMPT + STEPS + 1
    prompts = ((torch.arange(SERVE_BATCH * total, device=DEVICE).reshape(SERVE_BATCH, total)
                * 13) % (cfg.vocab_size - 1))
    prompts[:, PROMPT:] = 0

    def serve_once():
        engine = DecodeEngine(model, batch=SERVE_BATCH, max_seq=total)
        torch.cuda.synchronize()
        fa.launches = 0
        t0 = time.perf_counter()
        first = engine.prefill({"tokens": prompts})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = engine.generate(first, STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return out, fa.launches, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / STEPS, engine

    runs, engine = [], None
    for i in range(2):
        engine = None  # drop the last run's cache so the peak below is this run's
        torch.cuda.reset_peak_memory_stats()
        out, launches, prefill_ms, decode_ms, engine = serve_once()
        peak = torch.cuda.max_memory_allocated()
        print(f"serve run {i}: prefill_ms={prefill_ms:.3f} decode_ms_per_token={decode_ms:.3f} "
              f"flash_launches={launches} max_memory_allocated={peak} "
              f"({peak / 2**30:.3f} GiB)")
        check(launches == cfg.num_layers,
              f"flash-attention launches per prefill {launches}, want {cfg.num_layers}")
        check(out.shape == (SERVE_BATCH, STEPS + 1), f"tokens shape {tuple(out.shape)}")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token out of vocab")
        runs.append((out, launches, prefill_ms, decode_ms))
    check(torch.equal(runs[0][0], runs[1][0]), "two serve runs gave different tokens")
    print(f"serve tokens deterministic over 2 runs; request 0: {runs[1][0][0].tolist()}")
    profile_device(torch, "prefill", lambda: model.prefill({"tokens": prompts}),
                   wall_ms=runs[1][2])
    last = runs[1][0][:, -1]
    profile_device(torch, "decode step", lambda: engine.step(last), wall_ms=runs[1][3], reps=4)
    return runs[0][1]


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
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import build_model
    from repro_torch.models.attention import set_attention_impl
    from repro_torch.serve.engine import DecodeEngine

    # fp32 stays fp32: no TF32 in matrix products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print("== phase 1: device and build")
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    fa.build()
    print(f"flash-attention kernel built in {time.perf_counter() - t0:.2f} s "
          f"({fa.library_path().name})")
    for line in fa.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    main_case = kernel_phase(torch, F, fa, attention_ref)
    check(main_case is not None, "main-path kernel shape was not run")
    cfg = get_config("qwen2-0.5b")
    model_check_phase(torch, cfg, build_model, set_attention_impl)
    launches = serve_phase(torch, cfg, build_model, DecodeEngine, fa)

    print(json.dumps({"kernels": [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:32", launches=launches,
        **main_case)]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
