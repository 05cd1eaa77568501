"""Serving example on the PyTorch port: batched prefill + greedy decode with
the KV engine, on the CUDA card (``--device cpu`` asks for the CPU).

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch jamba-v0.1-52b]
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import build_model, card_unless_asked
from repro_torch.serve.engine import DecodeEngine


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args()
    device = card_unless_asked(args.device, "pass --device cpu")
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")

    cfg = reduced_config(get_config(args.arch))
    model = build_model(cfg, device=device)
    model.init(torch.Generator(device).manual_seed(0))
    total = args.prompt_len + args.steps + 1
    engine = DecodeEngine(model, batch=args.batch, max_seq=total)

    prompts = (torch.arange(args.batch * total, dtype=torch.int32, device=device)
               .reshape(args.batch, total) * 13) % (cfg.vocab_size - 1)
    prompts[:, args.prompt_len:] = 0

    with torch.no_grad():
        t0 = time.perf_counter()
        first = engine.prefill({"tokens": prompts})
        sync(device)
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = engine.generate(first, args.steps)
        sync(device)
        t_decode = time.perf_counter() - t0
    print(f"arch={args.arch} (reduced) batch={args.batch}")
    print(f"prefill: {t_prefill*1e3:.1f} ms, decode: "
          f"{t_decode/args.steps*1e3:.1f} ms/token")
    for i in range(args.batch):
        print(f"  request {i}: {out[i].tolist()}")


if __name__ == "__main__":
    main()
