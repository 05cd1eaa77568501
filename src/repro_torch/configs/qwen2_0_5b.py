"""Qwen2-0.5B — dense, GQA kv=2, QKV bias, tied embeddings.

[arXiv:2407.10671; hf]. 24L, d_model 896, 14 heads, d_ff 4864.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
)
