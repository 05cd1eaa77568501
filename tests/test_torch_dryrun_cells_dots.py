"""Per-device matrix-product FLOPs of two repaired dry-run cells against
the reference's (``slow``): jamba-v0.1-52b's train cell under "sp" and
llama-3.2-vision-90b's under "dp", reduced, batch 16, seq 64, each within
``DOT_RTOL`` = 5% of the reference's ``_lower_cell`` compiled for 16 fake
host devices (a child process with ``XLA_FLAGS``, as
``test_reduced_cell_dot_flops_equal_the_references`` runs its cells). The
reference counts 529,891,328 and 317,194,240.

moonshot-v1-16b-a3b's "dp" train cell, also repaired, is not held here:
its two microbatches of 8 rows split over the 4 ranks of "data" only, and
the port repeats each rank's MoE layer (routing, dispatch, experts) on the
4 ranks of "model", where GSPMD repeats the dispatch on all 16 and splits
the experts: 330,039,296 against the reference's 271,712,256 (``ROADMAP.md``,
Queue C item 20)."""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from _dryrun_cells import BATCH, CELL_TIMEOUT_S, SEQ  # noqa: E402
from _torch_dist import SRC, run_world  # noqa: E402
from test_torch_dryrun import _REFERENCE_DOTS, DOT_RTOL  # noqa: E402


@pytest.mark.slow
@pytest.mark.parametrize("arch,scheme", [("jamba-v0.1-52b", "sp"),
                                         ("llama-3.2-vision-90b", "dp")])
def test_repaired_cell_dot_flops_equal_the_references(arch, scheme, tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=16"}
    ref = subprocess.run([sys.executable, "-c", _REFERENCE_DOTS, arch, scheme, str(BATCH),
                          str(SEQ)], env=env, capture_output=True, text=True, timeout=900)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])["dot_flops"]
    got = run_world("dot_flops_cell", 16, tmp_path, fake=True, arch=arch, scheme=scheme,
                    batch=BATCH, seq=SEQ, timeout=CELL_TIMEOUT_S)["dot_flops"]
    assert abs(got - want) / want < DOT_RTOL, (got, want)
