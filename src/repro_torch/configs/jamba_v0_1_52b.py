"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]. Period-8 pattern: attention at layer index 4 of
each block of 8, Mamba elsewhere; MoE MLP on odd layers. Mamba-1 state
size 16 realized with SSD blocks (see DESIGN.md hardware-adaptation notes).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=64,  # bounds the (B,chunks,Q,Q,H) SSD decay tensor (Q linear)
    sub_quadratic=True,
)
