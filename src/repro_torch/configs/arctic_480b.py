"""Snowflake Arctic 480B — 128-expert top-2 MoE with parallel dense residual.

[hf:Snowflake/snowflake-arctic-base; hf]. 35L, d_model 7168, 56 heads
GQA kv=8; every layer: MoE (128e, d_ff 4864) + dense FFN residual branch.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    top_k=2,
    dense_residual=True,
)
