"""End-to-end training on the PyTorch port: ~100M-parameter LM for a
few hundred steps, on the CUDA card (``--device cpu`` asks for the CPU).

Uses the port's production stack — data pipeline, AdamW with ZeRO state,
atomic checkpoints, fault-tolerant step runner. The model is a scaled
qwen2-family config of ~100M params.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
"""

import argparse
import dataclasses
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, card_unless_asked
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import LoopConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="artifacts/torch/train_lm_ckpt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args()
    device = card_unless_asked(args.device, "pass --device cpu")
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")

    # ~100M params: qwen2 family at width 512 / 8 layers / 16k vocab
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b"), name="qwen2-100m", num_layers=8,
        d_model=512, num_heads=8, num_kv_heads=2, head_dim=64, d_ff=2048,
        vocab_size=16384, dtype="float32", remat="none",
        tie_embeddings=True)
    model = build_model(cfg, device=device)
    print(f"params: {model.param_count()/1e6:.1f}M")

    trainer = Trainer(
        model, opt_lib.OptConfig(lr=1e-3, warmup_steps=50,
                                 decay_steps=args.steps),
        LoopConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                   ckpt_every=100, ckpt_dir=args.ckpt_dir, log_every=20))
    log = trainer.run()
    trainer.write_log("artifacts/torch/train_lm_log.jsonl")
    first, last = log[0]["loss"], log[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"(retries={trainer.runner.retries})")
    assert last < first, "loss did not improve"


if __name__ == "__main__":
    main()
