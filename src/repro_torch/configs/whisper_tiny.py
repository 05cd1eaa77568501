"""Whisper-tiny backbone — encoder-decoder; conv frontend is a stub.

[arXiv:2212.04356; unverified]. 4 encoder + 4 decoder layers, d_model
384, 6 heads (MHA), d_ff 1536, LayerNorm. ``input_specs()`` provides
(B, audio_seq, d_model) precomputed frame embeddings (frontend stub).
Rotary positions replace Whisper's learned/sinusoidal embeddings — a
cost-neutral adaptation noted in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    audio_seq=1500,
)
