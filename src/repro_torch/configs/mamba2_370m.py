"""Mamba2-370M — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]. 48L, d_model 1024, d_inner 2048
(expand 2), 32 SSD heads of dim 64, state 128, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
    sub_quadratic=True,
)
