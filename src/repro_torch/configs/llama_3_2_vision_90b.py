"""Llama-3.2-Vision 90B backbone — cross-attention image layers every 5th.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. 100L, d_model 8192,
64 heads GQA kv=8, d_ff 28672. The vision frontend is a stub per the
assignment: ``input_specs()`` provides (B, vision_seq, d_model)
precomputed patch embeddings consumed by gated cross-attention layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_every=5,
    cross_offset=3,
    vision_seq=1600,
)
