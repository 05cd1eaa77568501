"""Phi-4-mini 3.8B — dense, RoPE + SwiGLU + GQA kv=8, tied embeddings.

[arXiv:2412.08905; hf]. 32L, d_model 3072, 24 heads, d_ff 8192,
200k vocab.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
)
