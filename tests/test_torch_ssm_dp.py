"""The Mamba2 block's projections on one rank of a fake (4, 4) world.

One SSM block of the reduced jamba-v0.1-52b (bf16) on a microbatch of its
reduced "dp" train cell (batch 16 over ``TRAIN_ACCUM`` 4: 4 rows of 64
tokens), forward and backward, traced on one rank as a train step's layer
runs it (``_torch_dist.ssm_layer_products``: the residual stream laid out
by the "acts" constraint, the pre-norm, the weights made whole for compute
by the sharder). Its six projections (z, x, B, C, dt and out) and their
twelve gradients are ``tools/dot_table.py``'s ``ssm_proj`` group.

Under "dp" the 4 rows split over "data" only and leave the 4 "model" ranks
of a data rank with the same row. Every projection must still run 1/16 of
its product on the whole microbatch on a device (its rank's row and a
quarter of its sequence), not 1/4 (the row's whole sequence on each of the
4 ranks). Under "sp" the weights of z, x, dt and out split over their
features and B's and C's products over the sequence: 1/16 too, with the
same dims as before "dp" was split (a quarter of the features of a whole
row). Each trace takes ~12 s.
"""

import pytest

pytest.importorskip("torch")

from _dryrun_cells import BATCH, DEVICES, SEQ  # noqa: E402
from _torch_dist import run_world  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch.dryrun import TRAIN_ACCUM  # noqa: E402

ARCH = "jamba-v0.1-52b"
ROWS = BATCH // TRAIN_ACCUM[ARCH]
MODEL = 4  # the "model" ranks of the (4, 4) mesh


def _expected(scheme):
    """The block's forward products as (FLOPs, dims sorted) on one rank: z
    and x, dt, B and C, out; each at 1/16 of its product on the microbatch,
    whose ``ROWS`` rows split over the 4 "data" ranks (one row each)."""
    cfg = reduced_config(get_config(ARCH))
    d, di, h, n = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    tokens = ROWS * SEQ
    whole = {"zx": 2 * tokens * d * di, "dt": 2 * tokens * d * h, "bc": 2 * tokens * d * n,
             "out": 2 * tokens * di * d}
    row, quarter = SEQ, SEQ // MODEL  # a rank's tokens: its row whole, or a quarter of it
    if scheme == "dp":  # the row's sequence split over "model", the weights whole
        dims = {"zx": (quarter, d, di), "dt": (quarter, d, h), "bc": (quarter, d, n),
                "out": (quarter, di, d)}
    else:  # the weights split over "model" by their features; B and C by the sequence
        dims = {"zx": (row, d, di // MODEL), "dt": (row, d, h // MODEL),
                "bc": (quarter, d, n), "out": (row, di // MODEL, d)}
    kinds = ("zx", "zx", "dt", "bc", "bc", "out")
    return sorted((whole[k] / DEVICES, sorted(dims[k])) for k in kinds)


@pytest.mark.parametrize("scheme", ["dp", "sp"])
def test_every_ssm_projection_runs_a_sixteenth_of_the_microbatch(scheme, tmp_path):
    out = run_world("ssm_layer_products", DEVICES, tmp_path, fake=True, arch=ARCH,
                    scheme=scheme, rows=ROWS, seq=SEQ, timeout=300)
    got = {way: sorted((r["flops"], sorted(r["sig"][1])) for r in out["products"]
                       if r["way"] == way and not r["sig"][0])
           for way in ("fwd", "bwd")}
    assert all(r["sig"][0] == [] for r in out["products"]), out["products"]
    want = _expected(scheme)
    assert got["fwd"] == want, (scheme, got["fwd"], want)
    # each projection's input and weight gradients: its dims again, twice
    assert got["bwd"] == sorted(want + want), (scheme, got["bwd"])
