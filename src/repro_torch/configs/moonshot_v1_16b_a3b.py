"""Moonshot (Moonlight) 16B-A3B — MoE 64 experts top-6, every layer.

[hf:moonshotai/Moonlight-16B-A3B; hf]. 48L, d_model 2048, 16 heads
(kv=16 -> MHA), expert d_ff 1408; ~3B active parameters per token.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    top_k=6,
)
