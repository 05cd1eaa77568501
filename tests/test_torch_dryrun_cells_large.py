"""The dry run's train cells of arctic-480b and llama-3.2-vision-90b on a
fake (4, 4) world, reduced (``_dryrun_cells``): under the sweep's "sp" and,
for llama-3.2-vision-90b, under "dp" (tier-1; its four microbatches of 4
rows on 16 ranks once failed in a view), and arctic's and the other archs'
remaining train cells under ``slow``; and the attention and unembedding
shares of the "dp" cells among them whose "model" ranks hold the same rows
(``IDLE``: llama-3.2-vision-90b's in tier-1, arctic-480b's and
qwen2.5-32b's under ``slow``)."""

import pytest

pytest.importorskip("torch")

from _dryrun_cells import IDLE, LARGE, TRAIN, check_cell, check_shares, params  # noqa: E402


@pytest.mark.parametrize("cell", params(LARGE + TRAIN))
def test_reduced_train_cell_traces_on_a_fake_4x4_world(cell, tmp_path):
    check_cell(cell, tmp_path)


@pytest.mark.parametrize("cell", params([c for c in LARGE + TRAIN if c in IDLE]))
def test_idle_model_ranks_repeat_no_attention_or_unembedding(cell, tmp_path):
    check_shares(cell, tmp_path)
