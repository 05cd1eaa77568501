"""Model / run configuration dataclasses and the layer-pattern abstraction.

Every assigned architecture is expressed as a ``ModelConfig``. Heterogeneous
stacks (Jamba's 1:7 attn:mamba interleave, Llama-vision's cross-attention
every 5th layer, MoE-every-2nd-layer) are described by a *periodic layer
pattern*: the stack is ``num_layers = period * num_periods`` layers, the
pattern lists the (mixer, mlp) kind for each layer inside one period. The
JAX reference stacks parameters across periods; this copy of its config
module keeps the same fields and pattern logic so the two packages read
one configuration identically.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

# Mixer kinds: "attn" (causal self-attention), "cross" (cross-attention to
# stub-embedded modality memory), "ssm" (Mamba2 SSD). MLP kinds: "dense",
# "moe", "moe_dense" (MoE plus parallel dense residual branch — Arctic).
LayerKind = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # MoE MLP on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    moe_group_size: int = 512     # tokens per dispatch group

    # --- attention ---
    qkv_bias: bool = False
    rope_style: str = "full"      # full | 2d (ChatGLM partial rotary on half dims)
    rope_theta: float = 10_000.0
    attn_every: int = 1           # attention on layers where i % attn_every == attn_offset
    attn_offset: int = 0          # (non-attention layers are SSM)

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- VLM ---
    cross_every: int = 0          # cross-attn mixer on layers where i % cross_every == cross_offset
    cross_offset: int = 0
    vision_seq: int = 1600        # stub patch-embedding count

    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    audio_seq: int = 1500         # stub frame-embedding count

    # --- misc ---
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"           # none | dots | full
    logits_softcap: float = 0.0
    sub_quadratic: bool = False   # True iff long_500k decode is supported

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.num_heads))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def layer_kind(self, i: int) -> LayerKind:
        """(mixer, mlp) kind of decoder layer ``i``."""
        if self.cross_every and i % self.cross_every == self.cross_offset:
            mixer = "cross"
        elif self.attn_every > 1:
            mixer = "attn" if i % self.attn_every == self.attn_offset else "ssm"
        elif self.family == "ssm":
            mixer = "ssm"
        else:
            mixer = "attn"
        if self.num_experts and i % self.moe_every == self.moe_offset:
            mlp = "moe_dense" if self.dense_residual else "moe"
        elif self.family == "ssm":
            mlp = "none"  # Mamba2 blocks have no separate MLP
        else:
            mlp = "dense"
        return (mixer, mlp)

    @property
    def period(self) -> int:
        """Length of the repeating layer pattern."""
        p = 1
        if self.cross_every:
            p = math.lcm(p, self.cross_every)
        if self.attn_every > 1:
            p = math.lcm(p, self.attn_every)
        if self.num_experts:
            p = math.lcm(p, self.moe_every)
        # Find the smallest period consistent with layer_kind.
        while self.num_layers % p != 0:
            p += 1
        return p

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    def pattern(self) -> List[LayerKind]:
        kinds = [self.layer_kind(i) for i in range(self.num_layers)]
        p = self.period
        for i in range(self.num_layers):
            assert kinds[i] == kinds[i % p], (
                f"layer pattern of {self.name} is not periodic with period {p}")
        return kinds[:p]

    # convenience for feature extraction / MODEL_FLOPS ------------------
    def param_count(self) -> int:
        from repro_torch.models import api
        return api.build_model(self, device="meta").param_count()

    def active_param_count(self) -> int:
        from repro_torch.models import api
        return api.build_model(self, device="meta").param_count(active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell is runnable, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k requires sub-quadratic sequence mixing; "
                       f"{cfg.name} is pure full-attention (see DESIGN.md)")
    return True, ""
