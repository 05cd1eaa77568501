"""Per-device matrix-product FLOPs of the dry-run cells against the
reference's (``slow``): every one of the 40 reduced cells at most
1 + ``DOT_RTOL`` times the reference's, and three repaired cells closer:
jamba-v0.1-52b's train cell under "sp"
and llama-3.2-vision-90b's and moonshot-v1-16b-a3b's under "dp", reduced,
batch 16, seq 64, against the reference's ``_lower_cell`` compiled for 16
fake host devices (a child process with ``XLA_FLAGS``, as
``test_reduced_cell_dot_flops_equal_the_references`` runs its cells).

jamba is held within ``DOT_RTOL`` = 5% of the reference, which counts
529,891,328.

Under "dp" the microbatches (8 rows for moonshot, 4 for llama-vision)
split over the 4 ranks of "data" only, so the 4 "model" ranks of a data
rank hold the same rows. The port gives each of them a share of every
product there: the attention heads (``attention._per_shard``), the
sequence of the projections and the unembedding
(``sharding.sequence_split_product``), and moonshot's experts
(``models.moe.compute_split``). Every product then runs 1/16 of the
microbatch's product on each device, but moonshot's routing (three
products at 1/4 on each "model" rank, by design). GSPMD repeats some
products instead. So each count is held exactly to the reference's, less
the products GSPMD repeats and plus those the port repeats, each written
out below (``tools/dot_table.py`` prints both sides group by group, and the
reference's compiled dots give the shares), and never above the
reference's by more than 5%: moonshot 92,536,832 against 271,712,256,
llama-vision 191,365,120 against 317,194,240.
"""

import pytest

pytest.importorskip("torch")

from _dryrun_cells import ARCHS, BATCH, DEVICES, SEQ, dot_flops  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch.dryrun import TRAIN_ACCUM  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import padded_vocab  # noqa: E402
from test_torch_dryrun import DOT_RTOL  # noqa: E402

DATA = 4  # the (4, 4) mesh: ("data", "model")
MOONSHOT_DP = ("moonshot-v1-16b-a3b", "dp")
VISION_DP = ("llama-3.2-vision-90b", "dp")
OURS = 1 / DEVICES  # a product's share on a device where no rank repeats it


def _whole(arch):
    """The reduced arch's config, its microbatch's rows, and the FLOPs of
    one product of each kind on a whole microbatch."""
    cfg = reduced_config(get_config(arch))
    d, h, hd, v = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim, padded_vocab(cfg.vocab_size)
    rows = BATCH // TRAIN_ACCUM[arch]
    tokens = rows * SEQ
    return cfg, rows, {
        "attn": 2 * rows * h * SEQ * SEQ * hd,  # a score or context product
        "proj": 2 * tokens * d * h * hd,         # a q/k/v/o projection product
        "wo": 2 * tokens * cfg.d_ff * d,         # an MLP output projection product
        "unembed": 2 * tokens * d * v,           # an unembedding product
        "router": 2 * tokens * d * max(cfg.num_experts, 1)}


def _moonshot_dp_offset() -> int:
    """The port's count less the reference's in moonshot's "dp" cell."""
    cfg, rows, whole = _whole(MOONSHOT_DP[0])
    layers, accum = cfg.num_layers, TRAIN_ACCUM[MOONSHOT_DP[0]]
    tokens, gs = rows * SEQ, cfg.moe_group_size
    one_hot = 2 * (tokens // gs) * gs * cfg.num_experts * moe.capacity(cfg, gs) * cfg.d_model
    # GSPMD runs the dispatch and combine whole on every device (forward,
    # and both of the combine's gradients), the dispatch's gradient on a
    # quarter, one projection's input gradient and one of the six attention
    # score and context products on an eighth, and the three unembedding
    # products on an eighth
    gspmd = (layers * accum * (one_hot * ((1 + 1 / 4 + 1 + 2) - 5 * OURS)
                               + (whole["proj"] + whole["attn"]) * (1 / 8 - OURS))
             + accum * whole["unembed"] * 3 * (1 / 8 - OURS))
    # the port routes a data rank's tokens on every "model" rank (three
    # products at 1/4; the reference's compiled step keeps two of the
    # router's three, at 1/16)
    port = layers * accum * whole["router"] * (3 / DATA - 2 * OURS)
    offset = port - gspmd
    assert offset == int(offset)
    return int(offset)


def _vision_dp_offset() -> int:
    """The port's count less the reference's in llama-vision's "dp" cell:
    the port repeats no product; GSPMD runs these on a quarter of the
    devices (the microbatch's rows whole on each data rank)."""
    cfg, rows, whole = _whole(VISION_DP[0])
    accum, periods = TRAIN_ACCUM[VISION_DP[0]], cfg.num_layers // cfg.period
    kinds = cfg.pattern()
    selfs = sum(k[0] == "attn" for k in kinds)
    dense = sum(k[1] == "dense" for k in kinds)
    # in each period: three of the four self-attention layers (their two
    # forward and four backward score and context products), every dense
    # MLP's input gradient of its output projection, and four projection
    # input gradients; and the unembedding's forward and input gradient
    gspmd = (accum * periods * (whole["attn"] * 6 * (selfs - 1) + whole["wo"] * dense
                                + whole["proj"] * 4) * (1 / 4 - OURS)
             + accum * whole["unembed"] * 2 * (1 / 4 - OURS))
    assert gspmd == int(gspmd)
    return -int(gspmd)


OFFSETS = {MOONSHOT_DP: _moonshot_dp_offset, VISION_DP: _vision_dp_offset}


@pytest.mark.slow
@pytest.mark.parametrize("arch,scheme", [("jamba-v0.1-52b", "sp"), VISION_DP, MOONSHOT_DP])
def test_repaired_cell_dot_flops_equal_the_references(arch, scheme, tmp_path):
    got, want = dot_flops((arch, scheme, "train"), tmp_path)
    if (arch, scheme) in OFFSETS:
        offset = OFFSETS[arch, scheme]()
        assert got == want + offset, (got, want, offset)
        assert got <= (1 + DOT_RTOL) * want, (got, want)
    else:
        assert abs(got - want) / want < DOT_RTOL, (got, want)


# all 40 reduced cells: each arch's prefill and decode under "sp" (the scheme
# ``sweep.scheme_for`` gives every serve cell) and its train cell under "sp"
# and "dp"
EVERY_CELL = ([(a, "sp", k) for a in ARCHS for k in ("prefill", "decode")]
              + [(a, s, "train") for a in ARCHS for s in ("sp", "dp")])


@pytest.mark.slow
@pytest.mark.parametrize("cell", EVERY_CELL, ids="-".join)
def test_every_reduced_cell_dot_flops_within_the_references(cell, tmp_path):
    """No device of any cell multiplies more than 1 + ``DOT_RTOL`` times the
    reference's count (some run fewer: GSPMD repeats products the port
    splits, see the "dp" cells above)."""
    got, want = dot_flops(cell, tmp_path)
    assert got <= (1 + DOT_RTOL) * want, (cell, got, want)
