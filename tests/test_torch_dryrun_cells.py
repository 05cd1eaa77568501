"""Every cell of the port's dry run on a fake (4, 4) world, reduced
(``_dryrun_cells``): each arch's train cell under the sweep's scheme, and
moonshot-v1-16b-a3b's and llama-3.2-vision-90b's train cells under "dp"
(tier-1); prefill and decode under "sp" and the other train cells under
``slow``. This file holds the quick train cells and the prefill and decode
cells; ``test_torch_dryrun_cells_large.py`` and ``_jamba.py`` the slow
archs' train cells, ``_dots.py`` the repaired cells' matrix-product FLOPs
against the reference's. Each file holds its ``IDLE`` cells' attention and
unembedding products to their 1/16 share from the same trace.
"""

import pytest

pytest.importorskip("torch")

from _dryrun_cells import (ARCHS, FILES, IDLE, OTHERS, REPAIRED, SERVE,  # noqa: E402
                           SMALL, TIER1, check_cell, check_shares, params)


def test_the_files_hold_every_cell_once():
    cells = [c for f in FILES for c in f]
    assert len(cells) == len(set(cells)) == len(TIER1) + len(OTHERS) == 4 * len(ARCHS)
    assert set(cells) == set(TIER1) | set(OTHERS) and set(REPAIRED) <= set(TIER1)
    assert set(IDLE) <= set(cells) and len(IDLE) == 5


@pytest.mark.parametrize("cell", params(SMALL + SERVE))
def test_reduced_cell_traces_on_a_fake_4x4_world(cell, tmp_path):
    check_cell(cell, tmp_path)


@pytest.mark.parametrize("cell", params([c for c in SMALL + SERVE if c in IDLE]))
def test_idle_model_ranks_repeat_no_attention_or_unembedding(cell, tmp_path):
    check_shares(cell, tmp_path)
