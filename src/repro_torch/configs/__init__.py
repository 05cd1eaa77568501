"""Architecture registry of the port: ``get_config(arch_id)``.

A copy of ``repro.configs`` restricted to the architectures whose layer
kinds the port builds so far: dense attention with GQA, QKV bias, full or
ChatGLM's "2d" partial RoPE and tied embeddings (qwen2-0.5b, chatglm3-6b,
phi4-mini-3.8b, qwen2.5-32b), and Mamba2 SSD (mamba2-370m). The other arch
files arrive with the slices that port their layer kinds (see ROADMAP.md,
Queue A: MoE, hybrid, cross-attention, encoder). ``reduced_config`` shrinks
a config to a CPU-runnable smoke-test size while preserving the layer
pattern.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable

_MODULES = {
    "chatglm3-6b": "chatglm3_6b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen2-0.5b": "qwen2_0_5b",
    "mamba2-370m": "mamba2_370m",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; ported: "
                       f"{list(_MODULES)} (dense attention and Mamba2 SSD layers; no MoE, hybrid, "
                       f"cross-attention or encoder yet)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig, dtype: str = "float32") -> ModelConfig:
    """Shrink to smoke-test size, preserving the periodic layer pattern."""
    period = cfg.period
    heads = min(cfg.num_heads, 4) or cfg.num_heads
    kv = min(cfg.num_kv_heads, heads) or cfg.num_kv_heads
    if heads and kv:
        kv = max(1, min(kv, heads))
        while heads % kv:
            kv -= 1
    repl = dict(
        num_layers=period * min(2, cfg.num_periods),
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16 if heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        vision_seq=16,
        audio_seq=32,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssm_chunk=16,
        moe_group_size=64,
        dtype=dtype,
        remat="none",
    )
    if cfg.num_experts:
        repl["num_experts"] = min(cfg.num_experts, 4)
        repl["top_k"] = min(cfg.top_k, 2)
    if cfg.encoder_layers:
        repl["encoder_layers"] = 2
    return dataclasses.replace(cfg, **repl)


__all__ = ["get_config", "list_archs", "reduced_config", "ModelConfig",
           "ShapeConfig", "SHAPES", "shape_applicable"]
