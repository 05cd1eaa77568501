"""The port's store engines, trace store and feedback store.

The reference's suites ``test_kvstore``, ``test_trace_store`` and
``test_store_engines`` run against the port's copies, bound by
``_torch_parity.port_suite``: each test below that carries a suite's name
is that suite's test, run on ``repro_torch.serve``. Two of them are
replaced by port versions under the same name: the second-process warm
start (its child binds the port) and the engines' lockstep run (four
engines, the reference's two and the port's two). Beside them: each
package opens the other's directories; the port's trace store serves a
record the reference traced as a miss; and the segment engine's compact
race, repaired in the port, stays repaired under stress.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from _hypo import given, settings, st  # noqa: E402
from _torch_parity import port_suite, suite_tests  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import bench_kvstore as bk  # noqa: E402

from repro.serve import feedback_store as ref_fb  # noqa: E402
from repro.serve import kvstore as ref_kv  # noqa: E402
from repro.serve import trace_store as ref_ts  # noqa: E402
from repro_torch.core.features import PLATFORM_TORCH_CUDA  # noqa: E402
from repro_torch.serve import feedback_store as port_fb  # noqa: E402
from repro_torch.serve import kvstore as port_kv  # noqa: E402
from repro_torch.serve import trace_store as port_ts  # noqa: E402
from repro_torch.serve.prediction_service import PredictionService  # noqa: E402

KV, TS, SE = (port_suite(name) for name in
              ("test_kvstore", "test_trace_store", "test_store_engines"))
PS = port_suite("test_prediction_service")
globals().update(suite_tests(KV, TS, SE))


@pytest.fixture(params=("json", "segment"))
def store_engine(request, monkeypatch):
    """conftest's ``store_engine`` on the port's bindings of the suites."""
    if request.param == "segment":
        SE.patch_segment(monkeypatch)
    return request.param


# -- port versions of two suite tests ----------------------------------------


def test_populated_store_from_real_second_process(tmp_path):
    """A process boots against a store another process filled: the child
    binds the port as the parent does."""
    tests = os.path.dirname(os.path.abspath(__file__))
    code = f"""
import sys
sys.path.insert(0, {os.path.join(tests, "..", "src")!r})
sys.path.insert(0, {tests!r})
from _torch_parity import port_suite
P = port_suite("test_prediction_service")
from repro_torch.serve.prediction_service import PredictionService, config_fingerprint
from repro_torch.serve.trace_store import TraceStore
svc = PredictionService(P._abacus(), tracer=P._counting_tracer([]),
                        store=TraceStore({str(tmp_path)!r}))
svc.predict_one(P._fake_cfg(), 2, 32)
print(config_fingerprint(P._fake_cfg()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    fp_child = out.stdout.strip().splitlines()[-1]
    calls = []
    svc = PredictionService(PS._abacus(), tracer=PS._counting_tracer(calls),
                            store=port_ts.TraceStore(str(tmp_path)))
    assert svc.cache_key(PS._fake_cfg(), 2, 32)[0] == fp_child
    est = svc.predict_one(PS._fake_cfg(), 2, 32)
    assert calls == []
    assert np.isfinite(est["time_s"]) and np.isfinite(est["memory_bytes"])


class _PortTagJson(bk._TagValues, port_kv.JsonFileStore):
    """``bench_kvstore.TagJsonStore`` on the port's JSON engine."""

    def __init__(self, root, clock=None):
        super().__init__(root)
        self._bench_clock = clock

    def put_raw(self, key, raw):
        path = super().put_raw(key, raw)
        if self._bench_clock is not None:
            t = float(self._bench_clock())
            os.utime(path, (t, t))
        return path


class _PortTagSeg(bk._TagValues, port_kv.SegmentLogStore):
    """``bench_kvstore.TagSegStore`` on the port's segment engine."""

    def __init__(self, root, clock=None, segment_bytes=None):
        super().__init__(root, segment_bytes=segment_bytes)
        if clock is not None:
            self._clock = clock


ENGINES = {"ref-json": lambda root, clock: bk.TagJsonStore(root, clock=clock),
           "ref-segment": lambda root, clock: bk.TagSegStore(root, clock=clock,
                                                             segment_bytes=2 << 10),
           "port-json": lambda root, clock: _PortTagJson(root, clock=clock),
           "port-segment": lambda root, clock: _PortTagSeg(root, clock=clock,
                                                           segment_bytes=2 << 10)}
OTHER = {"ref-json": "port-json", "ref-segment": "port-segment",
         "port-json": "ref-json", "port-segment": "ref-segment"}


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 10_000), st.integers(20, 80))
def test_engines_agree_on_randomized_op_scripts(seed, n_ops):
    """``bench_kvstore.gen_ops`` scripts applied in lockstep to four
    engines, the reference's JSON and segment engines and the port's: every
    op result and every content digest is equal across all four, and each
    package reopens the other's directories to the same digest."""
    ops = bk.gen_ops(np.random.default_rng(seed), int(n_ops))
    with tempfile.TemporaryDirectory() as root:
        clocks = {name: {"t": 1000.0} for name in ENGINES}

        def pair(name, engine):
            clock = clocks[name]
            return tuple(ENGINES[engine](os.path.join(root, name, side),
                                         lambda c=clock: c["t"])
                         for side in "ab")

        pairs = {name: pair(name, name) for name in ENGINES}
        for i, op in enumerate(ops):
            results = {name: bk.apply_op(p, op, clocks[name])
                       for name, p in pairs.items()}
            assert len({repr(r) for r in results.values()}) == 1, (i, op, results)
            if (i + 1) % 16 == 0:
                digests = {tuple(bk.store_digest(s) for s in p) for p in pairs.values()}
                assert len(digests) == 1, (i, op)
        digests = {tuple(bk.store_digest(s) for s in p) for p in pairs.values()}
        assert len(digests) == 1
        # each package opens the other's directories
        for name in ENGINES:
            reopened = pair(name, OTHER[name])
            assert tuple(bk.store_digest(s) for s in reopened) in digests


# -- the two packages over one directory --------------------------------------


@pytest.mark.parametrize("backend", ("json", "segment"))
def test_each_package_opens_the_others_trace_and_feedback_stores(tmp_path, backend):
    """One on-disk layout: the reference reads the port's trace records
    and feedback whole, and the port reads the reference's feedback and
    raw trace values (its trace records are the guard's, below)."""
    key, other = ("ab" * 8, 2, 32), ("cd" * 8, 4, 64)
    port = port_ts.make_trace_store(str(tmp_path / "t"), backend)
    rec = TS._record()
    port.put(key, rec)
    ref = ref_ts.make_trace_store(str(tmp_path / "t"), backend)
    got = ref.get(key)
    assert got is not None and got.platform == PLATFORM_TORCH_CUDA
    assert port_ts.record_to_json(rec) == ref_ts.record_to_json(got)
    ref.put(other, dataclasses.replace(got, platform=0))
    assert port.get_raw(other) == ref.get_raw(other)
    assert port.raw_snapshot() == ref.raw_snapshot()

    pf = port_fb.make_feedback_store(str(tmp_path / "f"), backend)
    rf = ref_fb.make_feedback_store(str(tmp_path / "f"), backend)
    pf.add(key, 1.5, 3e9, ts=1.0)
    rf.add(key, 2.5, 4e9, ts=2.0)
    rf.add(other, 0.5, 1e9, ts=3.0)
    assert port_fb.make_feedback_store(str(tmp_path / "f"), backend).snapshot() == \
        ref_fb.make_feedback_store(str(tmp_path / "f"), backend).snapshot()
    assert port_kv.SCHEMA_VERSION == ref_kv.SCHEMA_VERSION
    assert port_kv.STORE_BACKENDS.keys() == ref_kv.STORE_BACKENDS.keys()


@pytest.mark.parametrize("backend", ("json", "segment"))
def test_platform_guard_serves_a_reference_record_as_a_miss(tmp_path, backend):
    """A record the reference traced (platform 0) under the key a port
    query asks for is a miss, never a hit: the port's service re-traces
    and writes its own record over it, and compaction drops a foreign
    record that is left."""
    cfg, calls = PS._fake_cfg(), []
    tracer = PS._counting_tracer(calls)
    key = PredictionService(PS._abacus(), tracer=tracer).cache_key(cfg, 2, 32)
    ref = ref_ts.make_trace_store(str(tmp_path), backend)
    ref.put(key, dataclasses.replace(tracer(cfg, 2, 32), platform=0))
    ref.put(("ee" * 8, 8, 64), ref.get(key))
    calls.clear()

    store = port_ts.make_trace_store(str(tmp_path), backend)
    assert store.get(key) is None
    assert store.stats.misses == 1 and store.stats.corrupt == 0 and store.stats.hits == 0
    svc = PredictionService(PS._abacus(), tracer=tracer, store=store)
    est = svc.predict_one(cfg, 2, 32)
    assert calls == [(cfg.name, 2, 32)] and np.isfinite(est["time_s"])
    assert svc.stats.store_hits == 0 and svc.stats.traces == 1
    assert store.get(key).platform == PLATFORM_TORCH_CUDA
    out = store.compact()
    assert out["stale_schema"] == 1 and out["kept"] == 1
    assert set(store.keys()) == {key}


# -- the segment engine's compact race, repaired in the port -----------------

RACE_TESTS = ((KV, "test_feedback_compact_is_safe_under_concurrent_readers"),
              (KV, "test_base_compact_is_safe_under_concurrent_readers"),
              (TS, "test_compact_is_safe_under_concurrent_readers"))


@pytest.mark.parametrize("suite,name", RACE_TESTS, ids=[n for _, n in RACE_TESTS])
def test_compact_race_passes_twenty_times_in_a_row(suite, name, tmp_path, monkeypatch):
    """The suites' compact-under-readers tests, twenty runs in a row on
    the port's segment engine (on the reference's they flaked)."""
    SE.patch_segment(monkeypatch)
    for i in range(20):
        getattr(suite, name)(tmp_path / f"run{i}")


def test_no_live_record_is_missed_while_another_instance_compacts(tmp_path):
    """Compaction that drops nothing, over and over in one instance,
    while readers in another instance (each a separate index) read every
    key: every read finds its record. A rescan that listed segments the
    compaction then retired used to build an index without them."""
    keys = [("ab" * 8, batch, 32) for batch in range(2, 66, 2)]
    store = port_ts.SegmentTraceStore(str(tmp_path), segment_bytes=4 << 10)
    for key in keys:
        store.put(key, TS._record(batch=key[1]))
    stop, errors, reads = threading.Event(), [], [0]

    def hammer():
        reader = port_ts.SegmentTraceStore(str(tmp_path), segment_bytes=4 << 10)
        while not stop.is_set():
            for key in keys:
                try:
                    rec = reader.get(key)
                    assert rec is not None and rec.batch_size == key[1], key
                    reads[0] += 1
                except BaseException as e:  # pragma: no cover
                    errors.append(e)
                    return

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    for _ in range(30):
        assert store.compact()["kept"] == len(keys)
    stop.set()
    for t in threads:
        t.join(30)
    assert not errors, errors[:1]
    assert reads[0] > 0
    assert all(store.get(key) is not None for key in keys)


def test_a_record_still_being_written_is_not_truncated_as_torn(tmp_path):
    """A writer instance stopped halfway through an append holds its
    segment: another instance's open leaves the half-written tail alone
    (the reference truncated it, and the writer's second half then landed
    past the cut), and once the writer finishes both instances read the
    record."""
    key, late = ("ab" * 8, 2, 32), ("cd" * 8, 4, 32)
    writer = port_ts.SegmentTraceStore(str(tmp_path))
    writer.put(key, TS._record())
    halfway, resume = threading.Event(), threading.Event()

    def hook(site):
        if site == "append_mid":
            halfway.set()
            resume.wait(10)

    writer._crash_hook = hook
    t = threading.Thread(target=writer.put, args=(late, TS._record(batch=4)))
    t.start()
    assert halfway.wait(10)
    reader = port_ts.SegmentTraceStore(str(tmp_path))
    assert reader.get(key) is not None and reader.get(late) is None
    assert reader.torn_truncated == 0
    resume.set()
    t.join(10)
    assert writer.get(late) is not None
    assert reader.get(late) is not None and reader.get(key) is not None
    assert port_ts.SegmentTraceStore(str(tmp_path)).raw_snapshot() == writer.raw_snapshot()
