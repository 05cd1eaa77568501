"""Per-device matrix-product FLOPs of the three repaired dry-run cells
against the reference's (``slow``): jamba-v0.1-52b's train cell under "sp"
and llama-3.2-vision-90b's and moonshot-v1-16b-a3b's under "dp", reduced,
batch 16, seq 64, against the reference's ``_lower_cell`` compiled for 16
fake host devices (a child process with ``XLA_FLAGS``, as
``test_reduced_cell_dot_flops_equal_the_references`` runs its cells).

jamba and llama-vision are held within ``DOT_RTOL`` = 5% of the reference,
which counts 529,891,328 and 317,194,240.

moonshot's two microbatches of 8 rows split over the 4 ranks of "data"
only. Its experts' weights, FSDP-split over "model" on their expert dim,
stay split for compute, so each of the 4 "model" ranks routes its data
rank's tokens and dispatches to, serves and combines only its own expert
(``models.moe.expert_split``). Every MoE product but the router's then
runs 1/16 of the microbatch's product on each device, where GSPMD runs the
dispatch and combine products whole on all 16 (the dispatch's gradient on
a quarter) and divides the experts' products as the port does. The rest
of the step differs as well: the port runs the attention scores and context
and the unembedding on a data rank's rows on every "model" rank (ROADMAP
Queue C item 21). So the count is held exactly to the reference's, less
the products GSPMD repeats and plus those the port repeats, each written
out below (``tools/moe_dot_table.py`` prints both sides group by group):
149,159,936 against 271,712,256, and never above the reference's by more
than 5%.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from _dryrun_cells import BATCH, CELL_TIMEOUT_S, SEQ  # noqa: E402
from _torch_dist import SRC, run_world  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch.dryrun import TRAIN_ACCUM  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from test_torch_dryrun import _REFERENCE_DOTS, DOT_RTOL  # noqa: E402

DEVICES, DATA = 16, 4  # the (4, 4) mesh: ("data", "model")
MOONSHOT_DP = ("moonshot-v1-16b-a3b", "dp")


def _moonshot_dp_offset() -> int:
    """The port's count less the reference's in moonshot's "dp" cell. Each
    product is a share of the microbatch's whole product on a device: the
    port's 1/16, or 1/4 where it runs a data rank's rows on every "model"
    rank."""
    arch, scheme = MOONSHOT_DP
    cfg = reduced_config(get_config(arch))
    d, e, h, hd, v = cfg.d_model, cfg.num_experts, cfg.num_heads, cfg.head_dim, cfg.vocab_size
    layers, accum = cfg.num_layers, TRAIN_ACCUM[arch]
    rows = BATCH // accum
    tokens = rows * SEQ
    groups, gs = tokens // cfg.moe_group_size, cfg.moe_group_size
    cap = moe.capacity(cfg, gs)
    one_hot = 2 * groups * gs * e * cap * d      # a dispatch or combine product, whole
    router = 2 * tokens * d * e                  # a router product, whole
    attn = 2 * rows * h * SEQ * SEQ * hd         # a score or context product, whole
    proj = 2 * tokens * d * h * hd               # a q/k/v/o projection product, whole
    unembed = 2 * tokens * d * v                 # an unembedding product, whole
    ours = 1 / DEVICES
    # GSPMD runs the dispatch and combine whole on every device (forward,
    # and both of the combine's gradients), the dispatch's gradient on a
    # quarter, and one projection's input gradient on an eighth
    gspmd = layers * accum * (one_hot * ((1 + 1 / 4 + 1 + 2) - 5 * ours) + proj * (1 / 8 - ours))
    # the port routes a data rank's tokens on every "model" rank (three
    # products at 1/4; the reference's compiled step keeps two of the
    # router's three, at 1/16), and runs the six score and context products
    # at 1/4 (the reference: five at 1/16, one at 1/8) and the three
    # unembedding products at 1/4 (the reference: at 1/8)
    port = (layers * accum * (router * (3 / DATA - 2 * ours) + attn * (6 / DATA - 5 * ours - 1 / 8))
            + accum * unembed * 3 * (1 / DATA - 1 / 8))
    offset = port - gspmd
    assert offset == int(offset)
    return int(offset)


@pytest.mark.slow
@pytest.mark.parametrize("arch,scheme", [("jamba-v0.1-52b", "sp"),
                                         ("llama-3.2-vision-90b", "dp"), MOONSHOT_DP])
def test_repaired_cell_dot_flops_equal_the_references(arch, scheme, tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=16"}
    ref = subprocess.run([sys.executable, "-c", _REFERENCE_DOTS, arch, scheme, str(BATCH),
                          str(SEQ)], env=env, capture_output=True, text=True, timeout=900)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])["dot_flops"]
    got = run_world("dot_flops_cell", 16, tmp_path, fake=True, arch=arch, scheme=scheme,
                    batch=BATCH, seq=SEQ, timeout=CELL_TIMEOUT_S)["dot_flops"]
    if (arch, scheme) == MOONSHOT_DP:
        assert got == want + _moonshot_dp_offset(), (got, want, _moonshot_dp_offset())
        assert got <= (1 + DOT_RTOL) * want, (got, want)
    else:
        assert abs(got - want) / want < DOT_RTOL, (got, want)
