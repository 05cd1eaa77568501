"""The dry run's full-size cells against the reference's: the sweep's cells
(``launch.sweep``) at full width and full shape on the production mesh of a
fake world, traced ``ok``, with their matrix-product FLOPs a device within
``DOT_RTOL`` of the reference's ``_lower_cell`` compiled for 512 host
devices. Both halves run as ``tools/dot_table.py --shape`` does, side by
side: the port's trace in one child process, the reference's compile in
another.

Tier-1 traces each cell cut to one layer (``--layers``), as phase 17 cuts
its cell, one cell a fault repaired at full size (none shows at the reduced
cells' widths, heads and batch):

- chatglm3-6b ``prefill_32k``: the untied embedding's output, split over
  d_model, reached the MLP's up projection, where DTensor gathered the
  weight rather than the 32 x 32768 rows and left the hidden partial; the
  rows then merged their batch and sequence splits into a strided shard
  that the down projection's ``mm`` cannot take (``layers._norm`` makes
  the normalised dim whole first);
- qwen2-0.5b ``prefill_32k``: 14 heads do not divide the 16 "model" ranks,
  and every rank ran all of attention; the query rows now split there
  against whole K/V (``attention._per_shard``, ``sharding.split_idle``'s
  ``spill``), 12.9x the reference's products before;
- qwen2.5-32b ``train_4k`` ("sp", 4 microbatches): 40 heads over 16 ranks,
  whose context gradient came back split over the features and could not
  be viewed as heads (``sharding.split_ready_grad``), and whose whole
  context had each rank take all of ``wo``'s gradient
  (``sharding.split_like_weight``); its peak is held at most the
  reference's too, which the microbatches' whole-parameter fp32
  accumulators exceeded (``train.step``);
- moonshot-v1-16b-a3b ``train_4k`` ("sp", 2 microbatches): its peak at
  most the reference's (26.89 GiB against 10.94 before: the accumulators,
  and the label's logit taken on the whole vocab, ``layers._gold``);
- moonshot-v1-16b-a3b ``decode_32k``: a decode step writes and reads each
  rank's block of the cache's sequence (``attention._cache_write``,
  ``_cache_product``, ``_softmax``); where DTensor's own select and
  einsum gathered the cache (2 GiB a layer) or repeated its products on
  every rank of the sequence split, as torch 2.11's did, the peak and the
  products exceed the reference's.

- mamba2-370m ``prefill_32k``: the SSD scan's C·Bᵀ has no head dim, and
  the head-split region ran all of it on each of 16 "model" ranks (the
  ``ssd`` group 1.455x the reference's); a prefill's Mamba2 block now runs
  on the residual's sequence shards, the scan's state passed between the
  ranks (``ssm._apply_ssm_split``), and the group equals the reference's;
- jamba-v0.1-52b ``long_500k``: one row decodes against a 524288-position
  cache, and every "data" rank read the whole of its "model" rank's block
  (``attn`` 1.88x the reference's); the reads now split over "data" too
  (``attention._idle_split``).

``slow``: every runnable cell of the sweep, both meshes, at full depth
(minutes and up to ~9 GB of host memory a cell), ``ok``, and within
``DOT_RTOL``.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from _torch_dist import SRC  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402
from test_torch_dryrun import DOT_RTOL  # noqa: E402

TOOL = os.path.join(os.path.dirname(SRC), "tools", "dot_table.py")
CUT_TIMEOUT_S = 600
FULL_TIMEOUT_S = 3000  # the sweep's own


def both_sides(tmp_path, arch, shape, multi_pod=False, layers=None):
    """(the port's, the reference's) ``tools/dot_table.py --json`` of the
    cell, the two halves run side by side."""
    args = ["--arch", arch, "--shape", shape] + (["--multi-pod"] if multi_pod else []) \
        + (["--layers", str(layers)] if layers else [])
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    out, procs = {}, {}
    for side in ("port", "reference"):
        out[side] = tmp_path / f"{side}.json"
        procs[side] = subprocess.Popen(
            [sys.executable, TOOL, *args, f"--{side}-only", "--json", str(out[side])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    timeout = CUT_TIMEOUT_S if layers else FULL_TIMEOUT_S
    logs = {}
    try:
        for side, p in procs.items():
            logs[side] = p.communicate(timeout=timeout)[0]
    finally:
        for p in procs.values():
            p.kill()
    for side, p in procs.items():
        assert p.returncode == 0, f"{side} of {arch} {shape}:\n{logs[side][-3000:]}"
    port, ref = (json.loads(out[s].read_text()) for s in ("port", "reference"))
    return port, ref


def _check(port, ref, cell):
    got, want = sum(port["port"].values()), sum(ref["reference"].values())
    assert abs(got - want) <= DOT_RTOL * want, (cell, got, want, port["port"], ref["reference"])
    return got, want


@pytest.mark.parametrize("arch,shape", [("chatglm3-6b", "prefill_32k"),
                                        ("qwen2-0.5b", "prefill_32k")])
def test_full_width_prefill_cell_traces_within_the_references_products(arch, shape, tmp_path):
    port, ref = both_sides(tmp_path, arch, shape, layers=1)
    _check(port, ref, (arch, shape))
    attn = ("attn/fwd",)
    assert [port["port"].get(k) for k in attn] == [ref["reference"].get(k) for k in attn]


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "moonshot-v1-16b-a3b"])
def test_full_width_train_cell_traces_within_the_references(arch, tmp_path):
    port, ref = both_sides(tmp_path, arch, "train_4k", layers=1)
    _check(port, ref, (arch, "train_4k"))
    assert port["port_live"]["peak_hbm_gib"] <= ref["reference_live"]["peak_hbm_gib"], \
        (port["port_live"], ref["reference_live"])


def test_full_width_decode_cell_traces_within_the_references(tmp_path):
    port, ref = both_sides(tmp_path, "moonshot-v1-16b-a3b", "decode_32k", layers=1)
    _check(port, ref, ("moonshot-v1-16b-a3b", "decode_32k"))
    assert port["port_live"]["peak_hbm_gib"] <= ref["reference_live"]["peak_hbm_gib"], \
        (port["port_live"], ref["reference_live"])


def test_full_width_mamba2_prefill_runs_the_scan_on_sequence_shards(tmp_path):
    port, ref = both_sides(tmp_path, "mamba2-370m", "prefill_32k", layers=1)
    _check(port, ref, ("mamba2-370m", "prefill_32k"))
    got, want = port["port"]["ssd/fwd"], ref["reference"]["ssd/fwd"]
    assert abs(got - want) <= 0.01 * want, (got, want)


def test_full_width_batch_one_decode_splits_its_cache_reads(tmp_path):
    port, ref = both_sides(tmp_path, "jamba-v0.1-52b", "long_500k", layers=8)
    _check(port, ref, ("jamba-v0.1-52b", "long_500k"))
    assert port["port"]["attn/fwd"] <= ref["reference"]["attn/fwd"], \
        (port["port"], ref["reference"])


FULL = [pytest.param(a, s, mp, id=f"{a}-{s}-{'multi' if mp else 'single'}",
                     marks=pytest.mark.slow)
        for a, s, mp, ok, _ in sweep.cells([False, True]) if ok]


@pytest.mark.parametrize("arch,shape,multi_pod", FULL)
def test_full_size_cell_traces_within_the_references_products(arch, shape, multi_pod,
                                                              tmp_path):
    port, ref = both_sides(tmp_path, arch, shape, multi_pod)
    _check(port, ref, (arch, shape, multi_pod))
