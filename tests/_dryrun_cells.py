"""The dry run's reduced cells, one fake (4, 4) world each, for the
``test_torch_dryrun_cells*.py`` files (split so that ``--dist loadfile``
spreads the slow cells over workers).

A cell is (arch, scheme, kind) at batch 16, seq 64, bf16, with the arch's
``TRAIN_ACCUM`` microbatches for a train cell (``_torch_dist.dryrun_cells``).
``check_cell`` holds its record to what
``test_dryrun_cells_of_reduced_cells_on_a_fake_4x4_world`` holds its cells
to: status ``ok`` with the reference's record keys, 16 devices, the
scheme, a peak at least the arguments, a bottleneck, and for a train cell
a gradient all-reduce or reduce-scatter. ``REPAIRED`` are the cells the
port could not trace before microbatches were laid out evenly and DTensor
was helped with a rank's single row (``train/step.py::_block_layout``,
``distributed/sharding.py``: ``Sharder.layout``, ``grad_in_layout``,
``sequence_split_product``); their useful-FLOP fraction is held in
(0.2, 1.05] too.

``IDLE`` are the "dp" train cells whose microbatches have fewer rows than
the 16 ranks (the archs with ``TRAIN_ACCUM`` > 1): the rows split over
"data" only and leave "model" idle. ``check_shares`` holds each of their
attention score and context products, unembedding products and Mamba2
projections (jamba's ``ssm_proj``) to at most 1/16 of the largest such
product on a whole microbatch, read from the same trace as
``check_cell``'s record (``traced``: one fake world a cell and process).
The SSD scan's products are left out: its C·Bᵀ (``bctn,bcsn->bcts``) has
no head dim to split, so it runs at 1/4 on a data rank's row, by design
(``tests/test_torch_ssm_dp.py`` holds each projection's own share).
"""

from _torch_dist import run_world
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.launch import sweep
from repro_torch.launch.dryrun import TRAIN_ACCUM
from repro_torch.models.layers import padded_vocab
from test_torch_dryrun import _reference_record_keys

BATCH, SEQ = 16, 64
DEVICES = 16
CELL_TIMEOUT_S = 900
ARCHS = list_archs()
IDLE = [(a, "dp", "train") for a in ARCHS if TRAIN_ACCUM.get(a, 1) > 1]
# each arch's train cell under the sweep's scheme, and the two "dp" train
# cells the reference lowers that the port could not trace
SWEEP_TRAIN = [(a, sweep.scheme_for(a, "train_4k"), "train") for a in ARCHS]
REPAIRED = [("jamba-v0.1-52b", "sp", "train"), ("moonshot-v1-16b-a3b", "dp", "train"),
            ("llama-3.2-vision-90b", "dp", "train")]
TIER1 = SWEEP_TRAIN + [c for c in REPAIRED if c not in SWEEP_TRAIN]
# every other cell (``slow``): prefill and decode under "sp", and train
# under "sp" and "dp", for every arch
OTHERS = ([(a, "sp", k) for a in ARCHS for k in ("prefill", "decode")]
          + [(a, s, "train") for a in ARCHS for s in ("sp", "dp")
             if (a, s, "train") not in TIER1])
# the files' shares, by the seconds a cell takes on a CPU (jamba's train cells
# ~160 s each, llama-3.2-vision's and arctic's 20-60 s, the others 5-25 s)
SLOW_ARCHS = ("jamba-v0.1-52b", "llama-3.2-vision-90b", "arctic-480b")
JAMBA = [c for c in TIER1 + OTHERS if c[0] == "jamba-v0.1-52b" and c[2] == "train"]
LARGE = [c for c in TIER1 if c[0] in SLOW_ARCHS and c not in JAMBA]
SMALL = [c for c in TIER1 if c not in JAMBA + LARGE]
SERVE = [c for c in OTHERS if c[2] != "train"]
TRAIN = [c for c in OTHERS if c[2] == "train" and c not in JAMBA]
FILES = (SMALL, LARGE, JAMBA, SERVE, TRAIN)


def params(cells):
    """``cells`` as pytest parameters, each one of ``OTHERS`` marked slow."""
    import pytest

    return [pytest.param(c, id="-".join(c), marks=[pytest.mark.slow] if c in OTHERS else [])
            for c in cells]


_TRACED = {}


def traced(cell, tmp_path):
    """The cell's dry-run record and, for an ``IDLE`` cell, its traced
    step's products by group; traced once a process."""
    if cell not in _TRACED:
        if cell in IDLE:
            out = run_world("dryrun_cell_products", 16, tmp_path, fake=True, cell=list(cell),
                            batch=BATCH, seq=SEQ, timeout=CELL_TIMEOUT_S)
        else:
            rec, = run_world("dryrun_cells", 16, tmp_path, fake=True, cells=[list(cell)],
                             batch=BATCH, seq=SEQ, timeout=CELL_TIMEOUT_S)
            out = {"record": rec}
        _TRACED[cell] = out
    return _TRACED[cell]


def whole_products(arch):
    """The FLOPs of one self-attention score or context product, one
    cross-attention one, one unembedding product and one Mamba2 z, x or out
    projection (the largest of the block's) on a whole microbatch of the
    reduced ``arch`` (bf16, (BATCH, SEQ), ``TRAIN_ACCUM``)."""
    cfg = reduced_config(get_config(arch))
    rows, h, hd = BATCH // TRAIN_ACCUM[arch], cfg.num_heads, cfg.resolved_head_dim
    out = {"attn": 2 * rows * h * SEQ * SEQ * hd,
           "unembed": 2 * rows * SEQ * cfg.d_model * padded_vocab(cfg.vocab_size)}
    if cfg.cross_every:
        out["cross"] = 2 * rows * h * SEQ * cfg.vision_seq * hd
    if any(kind == "ssm" for kind, _ in cfg.pattern()):
        out["ssm_proj"] = 2 * rows * SEQ * cfg.d_model * cfg.d_inner
    return out


def check_shares(cell, tmp_path):
    """No attention, unembedding or Mamba2 projection product of an
    ``IDLE`` cell runs above 1/16 of its largest product on a whole
    microbatch on a device: no "model" rank repeats another's."""
    products = traced(cell, tmp_path)["products"]
    for group, whole in whole_products(cell[0]).items():
        for way in ("fwd", "bwd"):
            got = products.get(f"{group}/{way}")
            assert got and got["count"] > 0, (cell, group, way, products)
            assert got["max"] * DEVICES <= whole, (cell, group, way, got, whole)


def check_cell(cell, tmp_path):
    arch, scheme, kind = cell
    rec = traced(cell, tmp_path)["record"]
    keys = _reference_record_keys()
    assert rec["status"] == "ok" and set(rec) == keys, (cell, rec.get("reason"), set(rec) ^ keys)
    assert rec["devices"] == 16 and rec["scheme"] == scheme
    assert rec["peak_hbm_gib"] >= rec["argument_gib"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    if kind == "train":
        colls = rec["collectives"]
        assert colls.get("all-reduce", {}).get("count", 0) + \
            colls.get("reduce-scatter", {}).get("count", 0) > 0, colls
    if cell in REPAIRED:
        assert 0.2 < rec["useful_flop_fraction"] <= 1.05, rec
    return rec
