"""The port's dry run (repro_torch.launch.dryrun, .sweep, .analysis.hlo,
.roofline, .report) on the CPU.

- The cost model on traced graphs (the reference's HLO analyzer cases in
  ``tests/test_sharding.py``): nine chained 64x64 matmuls within 2% of
  9 x 2 x 64^3 FLOPs; a collective in a Python loop of 7 counted 7 times
  with its result bytes; a 4-way column-sharded matmul counted at the
  rank's local 131,072 FLOPs (``FlopCounterMode`` around DTensor code
  counts the global op as well: 655,360). Fake-world traces run in a child
  process (``_torch_dist.run_world``).
- ``dryrun_cell`` of reduced cells on a fake (4, 4) world (``CELLS``:
  qwen2-0.5b, mamba2-370m and moonshot-v1-16b-a3b train cells under "dp" or
  "sp", prefill and decode cells under "sp"): status ``ok`` with the
  reference's record keys; a train cell's useful-FLOP fraction in
  (0.2, 1.05] and a gradient collective.
- ``sweep.cells`` and ``report.table`` equal the reference's on the same
  JSONL.
- ``slow``: a reduced cell's per-device matrix-product FLOPs within
  ``DOT_RTOL`` = 5% of the reference's ``_lower_cell`` on 16 fake host
  devices (a child process with ``XLA_FLAGS``; ``_REFERENCE_DOTS`` takes
  the cell's kind as a fifth argument, train by default).
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from _torch_dist import SRC, run_world  # noqa: E402
from repro.analysis import report as jreport  # noqa: E402
from repro.analysis import roofline as jrl  # noqa: E402
from repro.launch import sweep as jsweep  # noqa: E402
from repro_torch.analysis import hlo, report  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402

DOT_RTOL = 0.05
GRAD_AR_MAX = 1.5
BATCH, SEQ = 16, 64
# the seven reduced cells trace one after another in one process: ~45 s
# alone, several times that beside the suite's other workers (the one-cell
# worlds of ``_dryrun_cells`` allow the same)
CELLS_TIMEOUT_S = 900


def test_graph_analyzer_chained_matmul_flops_exact():
    def f(x):
        for _ in range(9):
            x = x @ x
        return x
    with FakeTensorMode():
        x = torch.empty(64, 64)
    cost = hlo.analyze_graph(make_fx(f, tracing_mode="fake")(x))
    expect = 9 * 2 * 64 ** 3
    assert abs(cost.flops - expect) / expect < 0.02
    assert cost.coll_counts == {} and cost.bytes == 9 * 3 * 64 * 64 * 4


def test_collectives_in_a_loop_and_a_sharded_matmul_count_per_rank(tmp_path):
    out = run_world("fake_trace_checks", 4, tmp_path, fake=True)
    assert out["loop_counts"] == {"all-gather": 7.0}, out["loop_counts"]
    assert out["loop_bytes"] == 7 * 32 * 16 * 4  # each all-gather's (32, 16) fp32 result
    assert out["loop_stats"] == {"all-gather": {"count": 7, "bytes": 7 * 32 * 16 * 4.0,
                                                "weighted": 7 * 32 * 16 * 4.0}}
    assert out["mm_flops"] == 2 * 32 * 32 * 64 == 131_072 and out["mm_colls"] == {}
    # a collective whose result reaches no output is traced, and the dry
    # run's dead-code pass removes it; the output comes from the rank's ops
    assert out["dead_before"]["all-gather"]["count"] == 1, out["dead_before"]
    assert out["dead_after"] == {} and out["dead_output_from"] == ["call_function"]
    assert "aten.mul.Tensor" in out["dead_ops"], out["dead_ops"]
    assert not any("_c10d_functional" in op for op in out["dead_ops"]), out["dead_ops"]


def _reference_record_keys():
    roof = jrl.Roofline(1.0, 1.0, 0.0, 0.0, {}, 1.0, 1.0, 0.0, 0.0)
    return {"arch", "shape", "multi_pod", "devices", "status", "scheme", "lower_s",
            "compile_s", *roof.summary(1.0)}


# what the port's records add: the matrix products' FLOPs a device, the
# count that compares with the reference's dots, and the host's peak memory
PORT_KEYS = {"dot_flops_per_device", "host_rss_gib"}


CELLS = [["qwen2-0.5b", "dp", "train"], ["qwen2-0.5b", "sp", "train"],
         ["mamba2-370m", "dp", "train"], ["moonshot-v1-16b-a3b", "sp", "train"],
         ["qwen2-0.5b", "sp", "prefill"], ["mamba2-370m", "sp", "prefill"],
         ["qwen2-0.5b", "sp", "decode"]]


def test_dryrun_cells_of_reduced_cells_on_a_fake_4x4_world(tmp_path):
    recs = run_world("dryrun_cells", 16, tmp_path, fake=True, cells=CELLS, batch=BATCH, seq=SEQ,
                     timeout=CELLS_TIMEOUT_S)
    keys = _reference_record_keys() | PORT_KEYS
    for (arch, scheme, kind), rec in zip(CELLS, recs):
        assert rec["status"] == "ok" and set(rec) == keys, (arch, set(rec) ^ keys)
        assert 0 < rec["dot_flops_per_device"] <= rec["flops_per_device"], rec
        assert rec["host_rss_gib"] > 0
        assert rec["devices"] == 16 and rec["scheme"] == scheme
        assert rec["peak_hbm_gib"] >= rec["argument_gib"] > 0
        assert rec["bottleneck"] in ("compute", "memory", "collective")
        if kind == "train":
            assert 0.2 < rec["useful_flop_fraction"] <= 1.05, rec
            assert rec["collectives"].get("all-reduce", {}).get("count", 0) + \
                rec["collectives"].get("reduce-scatter", {}).get("count", 0) > 0


def test_traced_step_runs_from_the_shards_to_the_new_state(tmp_path):
    """The traced step of a reduced qwen2-0.5b train cell ("dp") reads its
    state and batch shards and returns the new state: no graph constant,
    no op whose result goes unused, and the data-parallel gradient's
    all-reduce carries between 1 and ``GRAD_AR_MAX`` = 1.5 times the
    parameters' gradient bytes (the tied table's two uses are reduced one
    by one: about 1.3)."""
    out = run_world("traced_cell", 16, tmp_path, fake=True, arch="qwen2-0.5b", scheme="dp",
                    batch=BATCH, seq=SEQ)
    assert out["get_attr"] == 0 and out["unused_ops"] == 0, out
    assert out["output_from"] == ["call_function"], out["output_from"]
    ar = out["collectives"]["all-reduce"]["bytes"]
    assert out["grad_bytes"] <= ar <= GRAD_AR_MAX * out["grad_bytes"], (ar, out["grad_bytes"])


def test_dp_experts_stay_split_through_the_traced_step(tmp_path):
    """moonshot-v1-16b-a3b's reduced "dp" train cell, whose microbatches of
    8 rows split over "data" only: no collective makes an expert weight
    whole (the experts stay split over "model" for compute), and each
    layer's ``wi`` and ``wo`` gradients are reduce-scattered once, into
    their ZeRO shards (split over "model" on the experts and over "data" on
    the next dim), not again over "model" nor once per optimizer use."""
    from repro_torch.configs import get_config, reduced_config

    cfg = reduced_config(get_config("moonshot-v1-16b-a3b"))
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    colls = run_world("collectives_cell", 16, tmp_path, fake=True, arch=cfg.name, scheme="dp",
                      batch=BATCH, seq=SEQ)
    whole = ([e, d, 2, f], [e, f, d])
    assert not [c for c in colls if c[1] in whole], colls
    zero = ([e // 4, d // 4, 2, f], [e // 4, f // 4, d])
    for shape in zero:
        assert [c for c in colls if c[1] == shape] == [["reduce-scatter", shape]] * cfg.num_layers


def test_sweep_cells_and_report_table_equal_the_reference(tmp_path):
    for meshes in ([False], [False, True]):
        assert sweep.cells(meshes) == jsweep.cells(meshes)
    assert sweep.TRAIN_SCHEME == jsweep.TRAIN_SCHEME and sweep.SHAPE_ORDER == jsweep.SHAPE_ORDER
    path = tmp_path / "dryrun.jsonl"
    recs = []
    for i, (arch, shape) in enumerate([("qwen2-0.5b", "train_4k"), ("mamba2-370m", "train_4k"),
                                       ("qwen2-0.5b", "decode_32k")]):
        roof = rl.Roofline(1e12 * (i + 1), 3e11, 1e9, 2e9 * (i + 1), {}, 2**33, 2**30, 0, 2**32)
        recs.append({"arch": arch, "shape": shape, "multi_pod": False, "status": "ok",
                     "scheme": "dp", **roof.summary(5e11)})
    recs.append({"arch": "qwen2-0.5b", "shape": "long_500k", "multi_pod": False,
                 "status": "skipped", "reason": "full attention"})
    recs.append({"arch": "qwen2-0.5b", "shape": "train_4k", "multi_pod": True, "status": "ok",
                 **recs[0]})
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\nnot json\n")
    assert report.table(str(path)) == jreport.table(str(path))
    assert sweep.done_keys(str(path)) == jsweep.done_keys(str(path))


_REFERENCE_DOTS = r"""
import dataclasses, json, sys
import numpy as np
import repro.launch.dryrun as d
import jax
from jax.sharding import Mesh
from repro.analysis import hlo
from repro.configs import get_config, reduced_config
from repro.configs.base import ShapeConfig
from repro.distributed import sharding as shd

arch, scheme, batch, seq = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
kind = sys.argv[5] if len(sys.argv) > 5 else "train"
cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="bfloat16")
d.get_config = lambda a: cfg
d.SHAPES = {"train_4k": ShapeConfig("train_4k", seq, batch, kind)}
mesh = Mesh(np.array(jax.devices()[:16]).reshape(4, 4), ("data", "model"))
_, lowered = d._lower_cell(arch, "train_4k", mesh, shd.ShardingRules(), scheme=scheme)


class Dots(hlo.HloCostModel):
    def _instr_cost(self, instr, comp, env, top_level):
        c = super()._instr_cost(instr, comp, env, top_level)
        if instr.op in ("dot", "convolution", "while", "fusion", "call", "custom-call",
                        "conditional", "async-start"):
            return c
        return hlo.Cost(coll_bytes=c.coll_bytes)


print(json.dumps({"dot_flops": Dots(lowered.compile().as_text()).total().flops}))
"""


@pytest.mark.slow
@pytest.mark.parametrize("arch,scheme", [("qwen2-0.5b", "dp"), ("mamba2-370m", "dp")])
def test_reduced_cell_dot_flops_equal_the_references(arch, scheme, tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=16"}
    ref = subprocess.run([sys.executable, "-c", _REFERENCE_DOTS, arch, scheme, str(BATCH),
                          str(SEQ)], env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])["dot_flops"]
    got = run_world("dot_flops_cell", 16, tmp_path, fake=True, arch=arch, scheme=scheme,
                    batch=BATCH, seq=SEQ)["dot_flops"]
    assert abs(got - want) / want < DOT_RTOL, (got, want)
