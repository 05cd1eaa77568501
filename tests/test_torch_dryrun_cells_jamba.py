"""jamba-v0.1-52b's train cells of the dry run on a fake (4, 4) world,
reduced (``_dryrun_cells``): under the sweep's "sp" (tier-1; its four
microbatches leave each rank one row, and the SSM projections' gradients
once met DTensor as a strided shard it could not multiply) and under "dp"
(``slow``), and under "dp" the shares of its attention and unembedding
products (``IDLE``; ``slow``). Each takes ~160 s here."""

import pytest

pytest.importorskip("torch")

from _dryrun_cells import IDLE, JAMBA, check_cell, check_shares, params  # noqa: E402


@pytest.mark.parametrize("cell", params(JAMBA))
def test_reduced_jamba_train_cell_traces_on_a_fake_4x4_world(cell, tmp_path):
    check_cell(cell, tmp_path)


@pytest.mark.parametrize("cell", params([c for c in JAMBA if c in IDLE]))
def test_idle_model_ranks_repeat_no_attention_or_unembedding(cell, tmp_path):
    check_shares(cell, tmp_path)
