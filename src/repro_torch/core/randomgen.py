"""Random model generator (paper §3.1: 5,500 randomly generated networks).

Port of ``repro.core.randomgen``: the same numpy draws give the same
structures. Two grammars, deterministic in seed:
  - random CNNs: staged conv nets sampling kernel sizes, widths, depthwise
    vs dense convs, residual/fire/inception-lite blocks, pooling points;
  - random transformers: StackModel configs sampling width/depth/heads/
    ff-multiplier/family (dense or MoE or SSM).
"""

from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import zoo as Z


def random_cnn(seed: int) -> Z.ZooModel:
    rng = np.random.default_rng(seed)
    layers: List[Z.Recipe] = []
    width = int(rng.choice([16, 24, 32, 48, 64]))
    layers.append(Z.cbr(width, int(rng.choice([3, 5]))))
    stages = rng.integers(1, 4)
    for s in range(stages):
        blocks = rng.integers(1, 4)
        for _ in range(blocks):
            kind = rng.choice(["conv", "conv1", "dw", "res", "fire"])
            if kind == "conv":
                layers.append(Z.cbr(width, int(rng.choice([3, 5]))))
            elif kind == "conv1":
                layers.append(Z.cbr(width, 1))
            elif kind == "dw":
                layers.append(Z.Seq.of(Z.Depthwise.of(3), Z.BN.of(), Z.Act.of(),
                                       Z.Conv.of(width, 1), Z.BN.of(), Z.Act.of()))
            elif kind == "res":
                layers.append(Z.basic_block(width))
            else:
                layers.append(Z.fire(max(8, width // 4), width // 2,
                                     width // 2))
        if s < stages - 1:
            layers.append(Z.Pool.of("max", 2))
            width = min(256, width * 2)
    layers += [Z.GlobalAvg.of(), Z.Dense.of(10)]
    return Z.ZooModel(f"rand_cnn_{seed}", Z.Seq.of(*layers).build(3), 3)


def random_lm_config(seed: int) -> ModelConfig:
    rng = np.random.default_rng(seed + 10_000)
    d = int(rng.choice([64, 128, 192, 256]))
    heads = int(rng.choice([2, 4, 8]))
    family = rng.choice(["dense", "dense", "moe", "ssm"])
    kw = dict(
        name=f"rand_lm_{seed}",
        family=str(family),
        num_layers=int(rng.integers(1, 7)),
        d_model=d,
        num_heads=heads,
        num_kv_heads=int(rng.choice([1, heads])),
        head_dim=int(rng.choice([16, 32])),
        d_ff=int(d * rng.choice([2, 3, 4])),
        vocab_size=int(rng.choice([256, 512, 1024])),
        dtype="float32",
        remat="none",
    )
    if family == "moe":
        kw.update(num_experts=int(rng.choice([2, 4, 8])), top_k=2,
                  moe_group_size=64)
    if family == "ssm":
        kw.update(d_ff=0, num_heads=0, num_kv_heads=0, head_dim=0,
                  ssm_state=int(rng.choice([8, 16])), ssm_head_dim=16,
                  ssm_chunk=16, sub_quadratic=True)
    return ModelConfig(**kw)
