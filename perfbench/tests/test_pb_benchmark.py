"""``BENCHMARK.json`` against the contract's rules, and every cell's files
found by name."""

import json
import re

import pytest

from perfbench.lib import cell as cell_lib
from perfbench.lib.cell import BENCH, ROOT, Cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|head|expand|"
                   r"experts_per_tok|top_k|width|d_model|d_ff)", re.I)
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH_JSON = cell_lib.benchmark()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths():
    b = BENCH_JSON
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in b["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in b["paths"])
            assert (ROOT / word).exists()
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_a_full_check_fits_its_time_with_24_cells():
    rs = BENCH_JSON["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    b = BENCH_JSON
    metrics = b["end_to_end"] + b["per_layer"]
    for group in (b["configs"], b["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m for m in b["end_to_end"] if m["name"] == "setup_s"][0]["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in BENCH_JSON["workloads"]])
def test_every_cell_reports_what_it_must(name):
    cell = Cell(name)
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cell.per_layer()
    assert layer
    for m, _ in layer:
        assert m["moves"] in e2e, (name, m["name"])
    assert any("mfu" in m["name"] for m, _ in layer)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH_JSON["workloads"]])
def test_every_cells_files_are_found_by_name(name):
    cell = Cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["name"] == cell.workload["traffic"]
    for attr in ("Run",):
        assert hasattr(cell.kind, attr)
    for attr in ("layout", "prefill"):
        assert hasattr(cell.reference, attr)
    for attr in ("prefill_flops", "train_flops", "flash_calls", "ssd_calls", "norm_rows"):
        assert hasattr(cell.model_flops, attr)
    assert cell.limits
    for _, reader in cell.per_layer():
        assert callable(reader.read)
    source = [c for c in BENCH_JSON["configs"] if c["name"] == cell.workload["config"]][0]
    assert source["source"] == cell.config["source"]
    assert source["reduced"] == cell.config["reduced"]


def test_every_metric_has_its_reader_and_every_reader_a_metric():
    readers = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in BENCH_JSON["per_layer"]}


def test_limits_lie_between_their_readings():
    for w in BENCH_JSON["workloads"]:
        with open(BENCH / "limits" / f"{w['name']}.json") as f:
            limits = json.load(f)["limits"]
        assert limits
        for num, lim in limits.items():
            assert lim["lower"] < lim["limit"] < lim["upper"], (w["name"], num, lim)
