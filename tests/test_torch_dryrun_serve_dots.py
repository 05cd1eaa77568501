"""Per-device matrix-product FLOPs of the dry run's serve cells held exactly
to the reference's (``_dryrun_cells.dot_flops``: reduced, bf16, batch 16,
seq 64, "sp", a fake (4, 4) ``("data", "model")`` world on the port's side
and 16 fake host devices on the reference's).

- decode of the MoE archs: one group of 16 tokens spans the four "data"
  ranks, and each rank routes, dispatches and combines its own share of it
  (``models.moe._spanning``); arctic-480b's experts keep their FSDP split of
  d_model over "data" for compute (``moe.compute_split``);
- whisper-tiny's untied embedding leaves its output split over d_model,
  which its LayerNorm makes whole first (``layers._norm``), so both decoder
  layers split their products over "model" as the reference does;
- mamba2-370m's prefill runs each Mamba2 block on the residual's sequence
  shards (``models.ssm._apply_ssm_split``): each "model" rank takes the
  SSD scan's C·Bᵀ of its own chunk alone, where the head-split region ran
  all of it on every rank (+196,608 a device).

Every product runs at the reference's share, so no offset is written out.
arctic-480b's, moonshot-v1-16b-a3b's and whisper-tiny's decode cells and
mamba2-370m's prefill are tier-1 (~10-30 s each); jamba-v0.1-52b's decode
and whisper-tiny's prefill are ``slow``.
"""

import pytest

pytest.importorskip("torch")

from _dryrun_cells import dot_flops  # noqa: E402


@pytest.mark.parametrize("cell", [
    ("arctic-480b", "sp", "decode"), ("moonshot-v1-16b-a3b", "sp", "decode"),
    ("whisper-tiny", "sp", "decode"), ("mamba2-370m", "sp", "prefill"),
    pytest.param(("jamba-v0.1-52b", "sp", "decode"), marks=pytest.mark.slow),
    pytest.param(("whisper-tiny", "sp", "prefill"), marks=pytest.mark.slow),
], ids="-".join)
def test_serve_cell_dot_flops_equal_the_references(cell, tmp_path):
    got, want = dot_flops(cell, tmp_path)
    assert got == want, (cell, got, want)
