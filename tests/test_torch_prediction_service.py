"""The port's PredictionService and trace_query against the reference's.

The contracts of ``tests/test_prediction_service.py`` run against both
packages' services (the ``pkg`` fixture binds one package's modules): trace
cache, in-flight dedup, LRU, fingerprints, batched queries and scheduling,
with a counting tracer. Then the two packages side by side: equal configs
give equal fingerprints; the port's ``trace_query`` record equals the
reference's in every field but the NSM (whose names lie within the
reference's), the platform tag and the traced FLOPs it keeps in ``extra``;
a predictor fitted in the reference and carried across by
``to_dict``/``from_dict`` gives the same estimates through both services;
and the port's service refuses a ``store``.
"""

import dataclasses
import functools
import importlib
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypo import given, settings, st  # noqa: E402
from _torch_parity import torch_cfg  # noqa: E402

OPS = ["dot", "add", "tanh", "exp", "conv", "max", "mul", "weird_op",
       "unseen1", "unseen2"]
GIB = 2**30
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _bind(root: str) -> types.SimpleNamespace:
    """One package's service and what its tests need, by the same names."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    ps, sched, configs = mod("serve.prediction_service"), mod("core.scheduler"), mod("configs")
    return types.SimpleNamespace(
        root=root, ProfileRecord=mod("core.features").ProfileRecord,
        NSMFeaturizer=mod("core.nsm").NSMFeaturizer, DNNAbacus=mod("core.predictor").DNNAbacus,
        RidgeRegressor=mod("core.automl.models").RidgeRegressor, Machine=sched.Machine,
        jobs_from_estimates=sched.jobs_from_estimates, schedule_jobs=sched.schedule_jobs,
        PredictionService=ps.PredictionService, Query=ps.Query,
        config_fingerprint=ps.config_fingerprint, trace_query=ps.trace_query,
        get_config=configs.get_config, reduced_config=configs.reduced_config)


@pytest.fixture(params=["repro", "repro_torch"])
def pkg(request):
    return _bind(request.param)


def _random_edges(rng, n_edges: int):
    return {(OPS[int(rng.integers(len(OPS)))],
             OPS[int(rng.integers(len(OPS)))]): float(rng.integers(1, 50))
            for _ in range(n_edges)}


def _records(pkg, n=40, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        batch = int(rng.choice([2, 4, 8]))
        edges = _random_edges(rng, 6)
        recs.append(pkg.ProfileRecord(
            model_name=f"m{i}", family="dense", batch_size=batch,
            input_size=32, channels=16, learning_rate=1e-3, epoch=1,
            optimizer="adamw", layers=4, flops=batch * 1e8,
            params=10_000, nsm_edges=edges,
            time_s=batch * 0.01, mem_bytes=batch * 1e6))
    return recs


def _abacus(pkg, seed=0):
    return pkg.DNNAbacus(seed=seed).fit(_records(pkg, seed=seed),
                                        candidate_factory=lambda s: [pkg.RidgeRegressor()])


def _fake_cfg(name="fake", batch_sens=1.0):
    """Duck-typed stand-in for ModelConfig (fingerprint uses vars())."""

    class _Cfg:
        def __init__(self):
            self.name = name
            self.family = "dense"
            self.num_layers = 4
            self.d_model = 16
            self.batch_sens = batch_sens

    return _Cfg()


def _counting_tracer(pkg, calls):
    def tracer(cfg, batch, seq):
        calls.append((cfg.name, batch, seq))
        rng = np.random.default_rng(batch * 1000 + seq)
        return pkg.ProfileRecord(
            model_name=cfg.name, family=cfg.family, batch_size=batch,
            input_size=seq, channels=16, learning_rate=1e-3, epoch=1,
            optimizer="adamw", layers=cfg.num_layers, flops=batch * seq * 1e6,
            params=10_000, nsm_edges=_random_edges(rng, 5))
    return tracer


# -- vectorized NSM featurization parity --------------------------------------


def _naive_matrix(feat, edges) -> np.ndarray:
    """The original O(E*V) implementation, kept as the parity oracle."""
    def idx(op):
        try:
            return feat.vocab.index(op)
        except ValueError:
            return len(feat.vocab) - 1

    v = len(feat.vocab)
    m = np.zeros((v, v), np.float64)
    for (a, b), n in edges.items():
        m[idx(a), idx(b)] += n
    return m


def test_vectorized_matrix_bitmatches_naive(pkg):
    @settings(max_examples=25, deadline=None)
    @given(st.integers(0, 10_000), st.integers(0, 40))
    def prop(seed, n_edges):
        rng = np.random.default_rng(seed)
        fit_dicts = [_random_edges(rng, 8) for _ in range(4)]
        feat = pkg.NSMFeaturizer(max_vocab=6).fit(fit_dicts)
        edges = _random_edges(rng, n_edges)
        naive = _naive_matrix(feat, edges)
        np.testing.assert_array_equal(feat.matrix(edges), naive)
        np.testing.assert_array_equal(
            feat.vector(edges),
            np.log1p(np.concatenate([naive.reshape(-1), naive.sum(0), naive.sum(1)])))
    prop()


def test_featurizer_index_rebuilds_after_vocab_swap(pkg):
    feat = pkg.NSMFeaturizer(max_vocab=4).fit([{("dot", "add"): 1.0}])
    assert feat.matrix({("dot", "add"): 2.0}).sum() == 2.0
    feat.vocab = ["tanh", "exp", "<other>"]  # as DNNAbacus.load does
    m2 = feat.matrix({("tanh", "exp"): 3.0})
    assert m2[0, 1] == 3.0 and m2.shape == (3, 3)


def test_batched_vectors_match_single(pkg):
    rng = np.random.default_rng(7)
    dicts = [_random_edges(rng, 5) for _ in range(6)]
    feat = pkg.NSMFeaturizer(max_vocab=5).fit(dicts)
    batched = feat.vectors(dicts)
    assert batched.shape == (6, feat.dim)
    for i, d in enumerate(dicts):
        np.testing.assert_array_equal(batched[i], feat.vector(d))


# -- trace cache ---------------------------------------------------------------


def test_second_query_hits_cache_no_retrace(pkg):
    calls = []
    svc = pkg.PredictionService(_abacus(pkg), tracer=_counting_tracer(pkg, calls))
    cfg = _fake_cfg()
    e1 = svc.predict_one(cfg, 2, 32)
    assert len(calls) == 1
    e2 = svc.predict_one(cfg, 2, 32)
    assert len(calls) == 1  # cache hit: no second trace
    assert e1["time_s"] == e2["time_s"]
    assert e1["memory_bytes"] == e2["memory_bytes"]
    svc.predict_one(cfg, 4, 32)
    assert len(calls) == 2  # new (batch) key -> one new trace
    info = svc.cache_info()
    assert info["hits"] == 1 and info["misses"] == 2 and info["entries"] == 2


def test_concurrent_identical_queries_trace_once(pkg):
    calls = []
    base = _counting_tracer(pkg, calls)

    def slow_tracer(cfg, batch, seq):
        time.sleep(0.05)
        return base(cfg, batch, seq)

    svc = pkg.PredictionService(_abacus(pkg), tracer=slow_tracer)
    cfg = _fake_cfg()
    results = []

    def worker():
        results.append(svc.predict_one(cfg, 2, 32))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1  # in-flight dedup: a burst pays one trace
    assert len(results) == 8
    assert len({r["time_s"] for r in results}) == 1


def test_fingerprint_is_content_addressed(pkg):
    cfg = pkg.reduced_config(pkg.get_config("qwen2-0.5b"))
    twin = dataclasses.replace(cfg)  # distinct object, equal content
    assert cfg is not twin
    assert pkg.config_fingerprint(cfg) == pkg.config_fingerprint(twin)
    other = dataclasses.replace(cfg, num_layers=cfg.num_layers + 1)
    assert pkg.config_fingerprint(cfg) != pkg.config_fingerprint(other)


class _GnarlyCfg:
    """Config with every field shape json.dumps(default=str) mangles."""

    def __init__(self):
        self.name = "gnarly"
        self.pattern = (("attn", "dense"), ("ssm", "moe"))  # nested tuples
        self.tags = {"b", "a", "c"}                 # set: hash-seed order
        self.table = {("k", 1): 2.0, ("k", 0): 1.0}  # non-str dict keys
        self.opt = object()                          # id()-bearing repr


def _fields_cfg(**fields):
    class _C:
        def __init__(self):
            for k, v in fields.items():
                setattr(self, k, v)
    return _C()


def test_fingerprint_canonicalizes_nested_payloads(pkg):
    fp = pkg.config_fingerprint
    assert fp(_GnarlyCfg()) == fp(_GnarlyCfg())
    # tuples and lists must NOT collide into one cache entry
    assert fp(_fields_cfg(x=(1, 2))) != fp(_fields_cfg(x=[1, 2]))
    assert fp(_fields_cfg(x=[1, 2])) != fp(_fields_cfg(x=[1, 2, 3]))


class _Act:
    """A callable instance: fingerprinted by its attributes."""

    def __init__(self, scale):
        self.scale = scale

    def __call__(self, x):
        return x * self.scale


def test_fingerprint_numpy_and_callable_fields(pkg):
    fp = pkg.config_fingerprint
    # multi-element ndarrays fingerprint, and neither collide with the
    # equivalent list nor with a bare scalar
    arr = fp(_fields_cfg(w=np.array([256, 512])))
    assert arr == fp(_fields_cfg(w=np.array([256, 512])))
    assert arr != fp(_fields_cfg(w=[256, 512]))
    assert fp(_fields_cfg(w=np.array([2]))) != fp(_fields_cfg(w=2))
    assert fp(_fields_cfg(w=np.float32(2.0))) == fp(_fields_cfg(w=2.0))
    # functools.partial: by (func, args, kwargs), never its id()-bearing repr
    p1 = fp(_fields_cfg(act=functools.partial(max, 1)))
    assert p1 == fp(_fields_cfg(act=functools.partial(max, 1)))
    assert p1 != fp(_fields_cfg(act=functools.partial(max, 2)))
    a1 = fp(_fields_cfg(act=_Act(2.0)))
    assert a1 == fp(_fields_cfg(act=_Act(2.0)))
    assert a1 != fp(_fields_cfg(act=_Act(3.0)))


_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
from {root}.serve.prediction_service import config_fingerprint

class _GnarlyCfg:
    def __init__(self):
        self.name = "gnarly"
        self.pattern = (("attn", "dense"), ("ssm", "moe"))
        self.tags = {{"b", "a", "c"}}
        self.table = {{("k", 1): 2.0, ("k", 0): 1.0}}
        self.opt = object()

print(config_fingerprint(_GnarlyCfg()))
"""


def test_fingerprint_stable_across_processes(pkg):
    """Child interpreters with other hash seeds fingerprint the gnarly config
    (sets, nested tuples, plain objects) as this one does."""
    fps = set()
    for seed in ("0", "1", "12345"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        out = subprocess.run([sys.executable, "-c", _CHILD.format(root=pkg.root), SRC],
                             capture_output=True, text=True, env=env, check=True)
        fps.add(out.stdout.strip())
    assert fps == {pkg.config_fingerprint(_GnarlyCfg())}


def test_lru_eviction_bounds_cache(pkg):
    calls = []
    svc = pkg.PredictionService(_abacus(pkg), max_cache_entries=2,
                                tracer=_counting_tracer(pkg, calls))
    cfg = _fake_cfg()
    for batch in (2, 4, 8):
        svc.predict_one(cfg, batch, 32)
    assert svc.cache_info()["entries"] == 2
    assert svc.stats.evictions == 1
    svc.predict_one(cfg, 2, 32)  # evicted -> re-traced
    assert len(calls) == 4


# -- batched prediction --------------------------------------------------------


def test_predict_many_matches_looped_predict_one(pkg):
    ab = _abacus(pkg)
    svc = pkg.PredictionService(ab, tracer=_counting_tracer(pkg, []))
    queries = [pkg.Query(_fake_cfg(n), b, 32) for n in ("a", "b", "c") for b in (2, 4)]
    many = svc.predict_many(queries)
    fresh = pkg.PredictionService(ab, tracer=_counting_tracer(pkg, []))
    looped = [fresh.predict_one(q.cfg, q.batch, q.seq) for q in queries]
    assert len(many) == len(queries)
    for e_many, e_loop in zip(many, looped):
        np.testing.assert_allclose(e_many["time_s"], e_loop["time_s"])
        np.testing.assert_allclose(e_many["memory_bytes"], e_loop["memory_bytes"])


def test_predict_many_accepts_tuples_and_empty(pkg):
    svc = pkg.PredictionService(_abacus(pkg), tracer=_counting_tracer(pkg, []))
    assert svc.predict_many([]) == []
    ests = svc.predict_many([(_fake_cfg(), 2, 32)])
    assert np.isfinite(ests[0]["time_s"])
    assert np.isfinite(ests[0]["memory_bytes"])


def test_predict_config_goes_through_service_cache(pkg):
    """DNNAbacus.predict_config shares the service's trace cache."""
    ab = _abacus(pkg)
    calls = []
    ab._service = pkg.PredictionService(ab, tracer=_counting_tracer(pkg, calls))
    cfg = _fake_cfg()
    e1 = ab.predict_config(cfg, 2, 32)
    e2 = ab.predict_config(cfg, 2, 32)
    assert len(calls) == 1
    assert e1["time_s"] == e2["time_s"]
    assert "hbm_budget" in e1


# -- scheduling bridge ---------------------------------------------------------


def test_service_schedules_predicted_jobs(pkg):
    svc = pkg.PredictionService(_abacus(pkg), tracer=_counting_tracer(pkg, []))
    queries = [pkg.Query(_fake_cfg(n), b, 32) for n in ("a", "b", "c") for b in (2, 4)]
    machines = [pkg.Machine("m1", 11 * GIB), pkg.Machine("m2", 24 * GIB)]
    span, assign = svc.schedule(queries, machines, plan="ga", time_scale=50,
                                mem_pad=GIB // 4, generations=10, seed=0)
    assert np.isfinite(span)
    assert len(assign) == len(queries)
    assert set(assign) <= {0, 1}


def test_schedule_jobs_dispatch_and_unknown_plan(pkg):
    jobs = pkg.jobs_from_estimates(["j1", "j2"], [1.0, 2.0], [GIB, GIB],
                                   time_scale=10, mem_pad=0.5 * GIB)
    assert jobs[0].time_s == 10.0 and jobs[0].mem_bytes == 1.5 * GIB
    machines = [pkg.Machine("m1", 4 * GIB)]
    span, _ = pkg.schedule_jobs(jobs, machines, plan="optimal")
    assert span == 30.0
    with pytest.raises(ValueError):
        pkg.schedule_jobs(jobs, machines, plan="nope")


# -- end-to-end with the real tracer (reduced LM config) -----------------------


def test_predict_many_equals_predict_config_real_trace(pkg):
    ab = _abacus(pkg)
    cfg = pkg.reduced_config(pkg.get_config("qwen2-0.5b"))
    queries = [pkg.Query(cfg, 2, 32), pkg.Query(cfg, 4, 32)]
    many = ab.service().predict_many(queries)
    looped = [ab.predict_config(cfg, 2, 32), ab.predict_config(cfg, 4, 32)]
    for e_many, e_loop in zip(many, looped):
        np.testing.assert_allclose(e_many["time_s"], e_loop["time_s"])
        np.testing.assert_allclose(e_many["memory_bytes"], e_loop["memory_bytes"])
    # the looped predict_config calls hit the predict_many traces
    assert ab.service().cache_info()["misses"] == 2


# -- the two packages side by side ---------------------------------------------

REF, PORT = "repro", "repro_torch"


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m", "chatglm3-6b",
                                  "phi4-mini-3.8b", "qwen2.5-32b"])
def test_fingerprints_agree_across_packages(arch):
    ref, port = _bind(REF), _bind(PORT)
    for make in (lambda p: p.get_config(arch), lambda p: p.reduced_config(p.get_config(arch))):
        jcfg, tcfg = make(ref), make(port)
        assert ref.config_fingerprint(jcfg) == port.config_fingerprint(tcfg)
        assert port.config_fingerprint(torch_cfg(jcfg)) == port.config_fingerprint(tcfg)
    assert ref.config_fingerprint(_GnarlyCfg()) == port.config_fingerprint(_GnarlyCfg())


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
def test_trace_query_record_matches_the_reference(arch):
    from repro_torch.core import profiler as tprof
    from repro_torch.core.features import PLATFORM_TORCH_CUDA
    ref, port = _bind(REF), _bind(PORT)
    jcfg = ref.reduced_config(ref.get_config(arch))
    want = ref.trace_query(jcfg, 2, 32)
    got = port.trace_query(torch_cfg(jcfg), 2, 32)
    # FLOPs included: both carry the online formula 6 * active params * B * S
    skip = {"nsm_edges", "platform", "extra"}
    for f in dataclasses.fields(got):
        if f.name not in skip:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (want.platform, got.platform) == (0, PLATFORM_TORCH_CUDA)
    assert want.extra is None
    # the traced count the port keeps beside it is the offline rig's
    _, step, specs, batch = tprof.lm_trace(torch_cfg(jcfg), 2, 32)
    offline = tprof.trace_step(step, (specs, batch))
    assert got.extra == {"traced_flops": offline["flops"]}
    assert got.nsm_edges == offline["nsm_edges"]
    # the NSM's operator names lie within the reference's (see
    # tests/test_torch_nsm_profiler.py for mamba2's two of its own)
    own = {"concatenate", "integer_pow"} if arch == "mamba2-370m" else set()
    ref_ops = {op for pair in want.nsm_edges for op in pair}
    port_ops = {op for pair in got.nsm_edges for op in pair}
    assert port_ops - ref_ops == own and len(port_ops & ref_ops) >= 30


def test_carried_predictor_gives_the_same_estimates_through_both_services():
    ref, port = _bind(REF), _bind(PORT)
    jab = _abacus(ref)
    tab = port.DNNAbacus.from_dict(jab.to_dict())
    queries = [(_fake_cfg(n), b, s) for n in ("a", "b") for b, s in ((2, 32), (8, 64))]
    budget = 16 * GIB
    ests = {}
    for p, ab in ((ref, jab), (port, tab)):
        svc = p.PredictionService(ab, hbm_budget=budget, tracer=_counting_tracer(p, []))
        ests[p.root] = svc.predict_many(queries)
    assert ests[REF] == ests[PORT]


def test_port_service_refuses_a_store():
    port = _bind(PORT)
    ab = _abacus(port)
    with pytest.raises(NotImplementedError, match="item 18"):
        port.PredictionService(ab, store=object())
    with pytest.raises(NotImplementedError, match="item 18"):
        ab.service(store=object())
    svc = ab.service()
    with pytest.raises(NotImplementedError, match="item 18"):
        ab.service(store=object())
    assert ab.service() is svc and svc.store is None


def test_service_is_made_once_and_not_carried():
    port = _bind(PORT)
    ab = _abacus(port)
    assert ab._service is None
    svc = ab.service()
    assert ab.service() is svc and svc.abacus is ab
    assert port.DNNAbacus.from_dict(ab.to_dict())._service is None
    assert ab.refit(_records(port, seed=1))._service is None
    keys = ("entries", "est_entries", "store_entries", "generation", "hits", "misses",
            "evictions", "store_hits", "traces", "store_errors", "est_hits", "adopts", "queries")
    assert tuple(svc.cache_info()) == keys
    assert tuple(_abacus(_bind(REF)).service().cache_info()) == keys
