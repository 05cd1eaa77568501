"""Model FLOPs and kernel calls of the GLM decoder (``reference/glm.py``),
from a configuration file and the shapes of the work: the matrix products
the model needs, causal attention on its kept pairs only."""

from perfbench.roofline import flash


def _per_token(cfg) -> float:
    d, h, kv, hd, f = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                       cfg["head_dim"], cfg["d_ff"])
    proj = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    return 2.0 * proj * cfg["num_layers"]


def prefill_flops(cfg, b: int, l: int) -> float:
    """One prefill of (b, l): every layer on every token, the logits of the
    last position only."""
    attn = cfg["num_layers"] * flash.flops(b, l, cfg["num_heads"], cfg["head_dim"])
    return _per_token(cfg) * b * l + attn + 2.0 * b * cfg["d_model"] * cfg["vocab_size"]


def train_flops(cfg, b: int, s: int) -> float:
    """One train step of (b, s): forward and backward (three times the
    forward's products), the logits of every position; remat not counted."""
    attn = cfg["num_layers"] * flash.flops(b, s, cfg["num_heads"], cfg["head_dim"])
    fwd = _per_token(cfg) * b * s + attn + 2.0 * b * s * cfg["d_model"] * cfg["vocab_size"]
    return 3.0 * fwd


def flash_calls(cfg, b: int, l: int):
    """The causal attention calls of one prefill: (b, sq, sk, heads, kv_heads, d)."""
    return [(b, l, l, cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"])] * cfg["num_layers"]


def ssd_calls(cfg, b: int, l: int):
    return []


def norm_rows(cfg, b: int, s: int):
    """(normalisations a forward needs, their rows, width): two a layer and
    the final one, all over every token."""
    return 2 * cfg["num_layers"] + 1, b * s, cfg["d_model"]
