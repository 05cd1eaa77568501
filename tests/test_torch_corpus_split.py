"""The corpus traced ahead of its timing (``repro_torch.core.profiler``:
``CorpusPoint``, ``TraceAhead``, ``trace_point``, ``measure_point``), on the
CPU.

``chip_smoke.py`` phase 11 makes each corpus record in two parts: its
fake-tensor trace (FLOPs, NSM) in spawned worker processes while the card
runs earlier phases, and its timed steps on the card. Here the workers
trace with ``device="cpu"`` and the timing is the one stand-in below (a
measurement raises away from the card); every record must equal the
in-process ``profile_zoo`` / ``profile_zoo_model`` / ``profile_lm`` record
field for field but ``time_s`` and ``mem_bytes``. The points: three zoo
nets (lenet5; resnet18 with BN, under Adam; shufflenet_v1 with grouped
convolutions, under momentum), one ``random_cnn`` and one reduced LM, and
every worker has exited once the traces are returned.
"""

import dataclasses
import multiprocessing

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import profiler as tprof  # noqa: E402
from repro_torch.core import randomgen as trand  # noqa: E402

CorpusPoint = tprof.CorpusPoint
LM = reduced_config(get_config("qwen2-0.5b"))
POINTS = [CorpusPoint("zoo", "lenet5", 4, 32),
          CorpusPoint("zoo", "resnet18", 2, 32, "adam"),
          CorpusPoint("zoo", "shufflenet_v1", 2, 24, "momentum"),
          CorpusPoint("rand_cnn", 5, 3, 32),
          CorpusPoint("lm", LM, 2, 16)]
MEASURED = {"time_s": 0.25, "mem_bytes": 1024.0}


def _in_process(point):
    if point.kind == "zoo":
        return tprof.profile_zoo(point.model, batch=point.batch, image=point.size,
                                 optimizer=point.optimizer, steps=2, device="cpu")
    if point.kind == "rand_cnn":
        return tprof.profile_zoo_model(trand.random_cnn(point.model), batch=point.batch,
                                       image=point.size, steps=2, family="rand_cnn",
                                       device="cpu")
    return tprof.profile_lm(point.model, point.batch, point.size, steps=2, device="cpu")


def _fields(rec):
    out = dataclasses.asdict(rec)
    return {k: v for k, v in out.items() if k not in ("time_s", "mem_bytes")}


def test_records_traced_in_a_worker_equal_the_in_process_records(monkeypatch):
    monkeypatch.setattr(tprof, "measure_step",
                        lambda step, args, steps=3, device="cuda": dict(MEASURED))
    ahead = tprof.TraceAhead(POINTS, device="cpu", workers=2)
    traced = ahead.results()
    assert not multiprocessing.active_children()
    assert all(t["trace_s"] > 0 for t in traced)
    for point, t in zip(POINTS, traced):
        split = tprof.measure_point(point, t, steps=2, device="cpu")
        whole = _in_process(point)
        assert _fields(split) == _fields(whole), point
        assert (split.time_s, split.mem_bytes) == (MEASURED["time_s"], MEASURED["mem_bytes"])
        assert split.flops > 0 and split.nsm_edges, point


def test_a_point_of_an_unknown_kind_raises():
    with pytest.raises(ValueError, match="kind"):
        tprof.trace_point(CorpusPoint("gan", "x", 1, 8), device="cpu")
