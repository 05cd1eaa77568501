"""Shared fixtures of the benchmark's own tests (run them from the root of
the repo: ``PYTHONPATH=src python -m pytest -q perfbench/tests``).

``small`` makes a cell of ``BENCHMARK.json`` with its configuration cut to
a CPU-sized model of the same family and its mix to short prompts or
batches; everything else (the kind's driver, the reference, the limits)
is the cell's own. ``card`` skips a test where no CUDA card is present,
decided inside the test."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from perfbench.lib.cell import Cell, benchmark  # noqa: E402
from perfbench.lib.context import Context  # noqa: E402

CUT = {"glm": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                   vocab_size=512),
       # rounding grows with depth through the recurrence: at 16 layers the
       # control's cache error passes the cell's limit, as at 48 on the card
       "mamba2": dict(num_layers=16, d_model=64, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
                      vocab_size=512)}
CELLS = tuple(w["name"] for w in benchmark()["workloads"])
# the train mix, which no cell runs yet (PERF.md, Open questions): its
# driver and reference are held to the port here all the same
TRAIN = ("mamba2-370m", "train-b8s2k")


def small_cell(name, dtype: str = "bfloat16") -> Cell:
    """A cut copy of the cell ``name``, or of (configuration, mix)."""
    cell = Cell.of(*name) if isinstance(name, tuple) else Cell(name)
    cell.config = dict(cell.config, **CUT[cell.config["reference"]], dtype=dtype)
    tr = dict(cell.traffic, token_ids_below=500)
    if tr["kind"] == "prefill":
        tr["lengths"] = {"dist": "log_uniform", "min": 8, "max": 64, "count": 5}
    else:
        tr.update(batch=4, seq=32, row_block=2)
    cell.traffic = tr
    return cell


def small_run(name, seed: int = 3, dtype: str = "bfloat16", fault: str = None,
              seconds: float = 0.2):
    """A cut cell set up, run for ``seconds`` and released on the CPU."""
    cell = small_cell(name, dtype)
    run = cell.kind.Run(Context(cell, seed, torch.device("cpu"), fault))
    run.setup()
    win = run.window(seconds)
    run.release()
    return cell, run, win


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only on the card")
    return torch.device("cuda", 0)
