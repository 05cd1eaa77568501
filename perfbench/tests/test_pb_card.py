"""On the card only: each cell's run, short, as the driver starts it, and
in a directory that holds only the benchmark (no program): that one fails
without a result."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench.lib.cell import BENCH, ROOT, benchmark

CELLS = [w["name"] for w in benchmark()["workloads"]]


def _run(cwd, name, trace):
    cmd = [sys.executable, "perfbench/run.py", "--workload", name, "--seed", "2147483999",
           "--seconds", "2", "--trace", str(trace)]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=1200)


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_of_each_cell_is_correct(card, name, trace):
    res = _run(ROOT, name, trace)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert all(v["value"] <= 105 for k, v in out["metrics"].items() if "roofline" in k)
    else:
        assert "setup_s" in out["metrics"]


def test_without_the_program_a_run_fails(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path, CELLS[0], 0)
    assert res.returncode != 0 and res.stdout.strip() == ""
