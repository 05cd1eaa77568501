"""A cell of the benchmark and the files that make it, found by name.

``BENCHMARK.json`` names the cell; its ``config`` is
``perfbench/configs/<config>.json``, its ``traffic`` is
``perfbench/traffic/<traffic>.json``, whose ``kind`` is the driver
``perfbench/kinds/<kind>.py``; the configuration's ``reference`` is the
plain model ``perfbench/reference/<reference>.py`` and its model FLOPs
``perfbench/roofline/model_<reference>.py``; the cell's limits are
``perfbench/limits/<workload>.json``; each per-layer metric is the reader
``perfbench/metrics/<metric>.py``. A later cell, configuration, mix, kind
or metric adds files; it edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def load_file(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one workload's run reads, by name."""

    def __init__(self, workload: str, bench: Dict = None):
        bench = bench if bench is not None else benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"workload {workload!r} not in BENCHMARK.json: {sorted(cells)}")
        self.bench = bench
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self._load(ROOT / configs[self.workload["config"]]["file"], self.workload["traffic"])
        self.limits = load_json(BENCH / "limits" / f"{workload}.json")["limits"]

    @classmethod
    def of(cls, config: str, traffic: str) -> "Cell":
        """A configuration under a mix that ``BENCHMARK.json`` need not hold
        (no limits, no metrics): the files by their names alone."""
        cell = cls.__new__(cls)
        cell.bench, cell.name, cell.limits = {"end_to_end": [], "per_layer": []}, None, {}
        cell.workload = {"name": None, "config": config, "traffic": traffic, "chips": 1}
        cell._load(BENCH / "configs" / f"{config}.json", traffic)
        return cell

    def _load(self, config_file: Path, traffic: str):
        self.config = load_json(config_file)
        self.traffic = load_json(BENCH / "traffic" / f"{traffic}.json")
        self.kind = importlib.import_module(f"perfbench.kinds.{self.traffic['kind']}")
        self.reference = importlib.import_module(f"perfbench.reference.{self.config['reference']}")
        self.model_flops = importlib.import_module(
            f"perfbench.roofline.model_{self.config['reference']}")

    def end_to_end(self):
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        """(metric entry, reader module) of each per-layer metric this cell reports."""
        out = []
        for m in self.bench["per_layer"]:
            if self.name in m.get("workloads", [self.name]):
                out.append((m, load_file(BENCH / "metrics" / f"{m['name']}.py",
                                         f"perfbench_metric_{m['name'].replace('.', '_')}")))
        return out
