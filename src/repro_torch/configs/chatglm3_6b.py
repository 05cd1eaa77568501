"""ChatGLM3-6B — dense, 2d (partial) RoPE, GQA kv=2, QKV bias.

[arXiv:2406.12793; hf]. 28L, d_model 4096, 32 heads, d_ff 13696.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    qkv_bias=True,
    rope_style="2d",
)
