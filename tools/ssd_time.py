"""Time the SSD scan kernel on the card at the two serving prefills' shapes.

    python tools/ssd_time.py [--reps 20]

Times one call of ``ssd_scan_blhp`` (bf16) at mamba2-370m's and
jamba-v0.1-52b's serving prefill, with CUDA events over ``--reps`` calls
after a warm-up (as ``chip_smoke.py``'s ``time_ms``), and, where the
package has them, the sequence-split chain of ``chip_smoke.SPLIT_CUTS``
blocks. It imports ``repro_torch`` from ``PYTHONPATH``, so pointing that
at another checkout's ``src`` times that checkout's kernel (its library
is built under that checkout's ``build/``): run two checkouts in turns in
one session (A, B, B, A) to compare them on one card. Prints one JSON line
with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

SHAPES = {"mamba2-370m": (8, 2081, 32, 64, 128, 256),
          "jamba-v0.1-52b": (8, 2081, 128, 64, 16, 64)}
CUTS = (0, 512, 1024, 1536, 2081)
SPIN_CYCLES = 20_000_000


def time_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import ssm

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    split = hasattr(ssd, "ssd_states_blhp")
    out = {"card": card, "package": os.path.dirname(ssd.__file__), "ms": {}}
    for name, (b, l, h, p, n, chunk) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(l + n)

        def draw(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        xb = (0.5 * draw(b, l, h, p)).bfloat16()
        dt = torch.nn.functional.softplus(draw(b, l, h) - 4.0)
        a_neg = -torch.exp(0.3 * draw(h))
        bm, cm = ((0.5 * draw(b, l, n)).bfloat16() for _ in range(2))
        row = {"one_call": time_ms(torch, lambda: ssd.ssd_scan_blhp(xb, dt, a_neg, bm, cm,
                                                                     chunk), args.reps)}
        if split:
            def chain():
                spans = list(zip(CUTS, CUTS[1:]))
                blocks = [tuple(t[:, u:v].contiguous() for t in (xb, dt, bm, cm))
                          for u, v in spans]
                first = [ssd.ssd_states_blhp(x, d, a_neg, bb, chunk) for x, d, bb, _ in blocks]
                finals = torch.stack([f for _, _, f in first])
                decays = torch.stack([d.prod(1) for _, d, _ in first])
                for k, ((x, d, bb, c), res) in enumerate(zip(blocks, first)):
                    ssd.ssd_output_blhp(x, d, a_neg, bb, c, chunk, *res,
                                        ssm.ssd_carry(finals, decays, k))
            row["split_chain"] = time_ms(torch, chain, args.reps)
        out["ms"][name] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
