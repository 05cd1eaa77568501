"""Model FLOPs and kernel calls of the Mamba-2 model (``reference/mamba2.py``),
from a configuration file and the shapes of the work: the projections, the
SSD scan's products (``ssd.flops``) and the tied unembedding. The
depthwise convolution and the elementwise gating are not matrix products
and are not counted."""

from perfbench.roofline import ssd


def _dims(cfg):
    d = cfg["d_model"]
    di = cfg["ssm_expand"] * d
    return d, di, cfg["ssm_state"], di // cfg["ssm_head_dim"], cfg["ssm_head_dim"]


def _forward(cfg, b: int, l: int, logit_rows: int) -> float:
    d, di, n, h, p = _dims(cfg)
    proj = 2.0 * b * l * (d * (2 * di + 2 * n + h) + di * d)
    scan = ssd.flops(b, l, h, p, n, cfg["ssm_chunk"])
    return cfg["num_layers"] * (proj + scan) + 2.0 * logit_rows * d * cfg["vocab_size"]


def prefill_flops(cfg, b: int, l: int) -> float:
    """One prefill of (b, l): the logits of the last position only."""
    return _forward(cfg, b, l, b)


def train_flops(cfg, b: int, s: int) -> float:
    """One train step: three times the forward's products; remat not counted."""
    return 3.0 * _forward(cfg, b, s, b * s)


def flash_calls(cfg, b: int, l: int):
    return []


def ssd_calls(cfg, b: int, l: int):
    """The scan calls of one prefill: (b, l, heads, head_dim, state, chunk)."""
    d, di, n, h, p = _dims(cfg)
    return [(b, l, h, p, n, cfg["ssm_chunk"])] * cfg["num_layers"]


def norm_rows(cfg, b: int, s: int):
    """(normalisations a forward needs, their rows, width): one a block and
    the final one, over every token (the gated norm inside the mixer runs
    no kernel of its own and is not counted)."""
    return cfg["num_layers"] + 1, b * s, cfg["d_model"]
