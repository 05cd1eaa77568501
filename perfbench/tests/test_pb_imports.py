"""What the benchmark loads and reads: no JAX and no JAX package anywhere
in a run, nothing of the program in the reference, nothing of the old
``benchmarks/`` or of ``chip_smoke.py``; without a card no result."""

import ast
import json
import os
import subprocess
import sys

from perfbench.lib.cell import BENCH, ROOT

FOREIGN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FOREIGN, (path, tops & FOREIGN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] in {"torch", "math", "typing", "__future__", "perfbench"}, \
                (path, mod)
            if mod.startswith("perfbench"):
                assert mod.startswith("perfbench.reference"), (path, mod)


def test_nothing_reads_the_old_benchmarks_or_the_smoke_script():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "chip_smoke" not in text and "benchmarks/" not in text, path


CHILD = r"""
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "repro"}:
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src", sys.argv[2]]
from conftest import small_run
from perfbench.run import foreign_modules
for name in sys.argv[3:]:
    _, run, _ = small_run(name, seconds=0.05)
    run.judge()
print(json.dumps(foreign_modules()))
"""


def test_no_jax_module_is_loaded_after_a_run_of_each_cell():
    names = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
    res = subprocess.run([sys.executable, "-c", CHILD, str(ROOT), str(BENCH / "tests"), *names],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_without_a_card_a_run_fails_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "mamba2-370m.prefill-b16-1k8k", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=env)
    assert res.returncode != 0 and res.stdout.strip() == ""
