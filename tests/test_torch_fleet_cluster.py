"""The port's cluster fabric and RPC replicas.

The reference's suites ``test_cluster``, ``test_reshard`` and ``test_rpc``
run against the port's copies, bound by ``_torch_parity.port_suite``: each
test below that carries a suite's name is that suite's test, run on
``repro_torch.serve``, its spawned replicas ``python -m
repro_torch.serve.rpc`` children. The two chaos tests that wait out
heartbeat deaths (tens of seconds each) run under ``-m slow``. Beside them:
``synthetic_trace`` gives the reference's records but for the platform
tag; one predictor fitted in the reference and carried across by
``to_dict`` gives identical verdicts through both packages' fleets; and a
JAX-blocked process spawns a port replica and gets an answer, with neither
process holding JAX, the reference or a CUDA context.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import port_suite, suite_tests  # noqa: E402

import test_prediction_service as ref_suite  # noqa: E402
from repro.core.automl.models import RandomForestRegressor  # noqa: E402
from repro.core.features import record_to_json as ref_json  # noqa: E402
from repro.core.predictor import DNNAbacus as RefAbacus  # noqa: E402
from repro.serve import cluster as ref_cluster  # noqa: E402
from repro.serve import refit as ref_refit  # noqa: E402
from repro.serve import rpc as ref_rpc  # noqa: E402
from repro_torch.core.features import PLATFORM_TORCH_CUDA, record_to_json  # noqa: E402
from repro_torch.core.predictor import DNNAbacus  # noqa: E402
from repro_torch.serve import cluster, refit, rpc  # noqa: E402

CLUSTER, RESHARD, RPC = (port_suite(name) for name in
                         ("test_cluster", "test_reshard", "test_rpc"))
PS = port_suite("test_prediction_service")
globals().update(suite_tests(CLUSTER, RESHARD, RPC))

# the chaos tests that wait for heartbeat deaths: ~40 s and ~35 s
for _name in ("test_killed_replica_is_excluded_and_fleet_heals",
              "test_dead_replica_stats_fallback_is_stamped_stale"):
    globals()[_name] = pytest.mark.slow(globals()[_name])

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_synthetic_trace_is_the_reference_s_but_for_the_platform():
    for cfg in (PS._fake_cfg("a"), PS._fake_cfg("job0007"), RPC._DcCfg()):
        for batch, seq in ((2, 32), (8, 2048)):
            port = rpc.synthetic_trace(cfg, batch, seq)
            ref = ref_rpc.synthetic_trace(cfg, batch, seq)
            assert port.platform == PLATFORM_TORCH_CUDA and ref.platform == 0
            assert record_to_json(dataclasses.replace(port, platform=0)) == ref_json(ref)


def test_reference_fitted_predictor_gives_identical_verdicts_through_both_fleets(tmp_path):
    """A forest fitted in the reference, carried into the port by
    ``to_dict``, drives a three-replica fleet in each package over one
    burst from several tenants (``synthetic_trace`` on both sides, each
    fleet with its own stores): equal verdicts key for key, again when
    answered from the caches, and again after both fleets publish, as
    generation 1, a second forest fitted in the reference and carried
    across the same way."""
    fac = lambda s: [RandomForestRegressor(n_trees=10, seed=s)]  # noqa: E731
    ref_ab, ref_gen1 = (RefAbacus(seed=seed).fit(ref_suite._records(seed=seed),
                                                 candidate_factory=fac) for seed in (0, 1))
    port_ab, port_gen1 = (DNNAbacus.from_dict(json.loads(json.dumps(ab.to_dict())))
                          for ab in (ref_ab, ref_gen1))
    queries = [(PS._fake_cfg(f"job{i:03d}"), 2 ** (1 + i % 3), 32 * (1 + i % 2))
               for i in range(18)]
    tenants = ["ta", "tb", "tc"]

    def burst(fleet):
        futs = [fleet.submit(cfg, b, s, tenant=tenants[i % 3])
                for i, (cfg, b, s) in enumerate(queries)]
        return [RPC._verdict(f.result(60)) for f in futs]

    with ref_cluster.ClusterFrontend(ref_ab, n_replicas=3, tracer=ref_rpc.synthetic_trace,
                                     trace_root=str(tmp_path / "ref" / "t"),
                                     feedback_root=str(tmp_path / "ref" / "f")) as ref_fleet, \
            cluster.ClusterFrontend(port_ab, n_replicas=3, tracer=rpc.synthetic_trace,
                                    trace_root=str(tmp_path / "port" / "t"),
                                    feedback_root=str(tmp_path / "port" / "f")) as port_fleet:
        want = burst(ref_fleet)
        assert burst(port_fleet) == want
        assert burst(port_fleet) == burst(ref_fleet) == want
        assert ref_fleet.publish_generation(ref_refit.ModelGeneration(1, ref_gen1))
        assert port_fleet.publish_generation(refit.ModelGeneration(1, port_gen1))
        gen1 = burst(ref_fleet)
        assert burst(port_fleet) == gen1 != want
        assert {v[-1] for v in gen1} == {1}
        # the telemetry the fleets report has the same shape, key for key
        assert _shape(port_fleet.stats()) == _shape(ref_fleet.stats())
        assert _shape(port_fleet.server_info()) == _shape(ref_fleet.server_info())
        assert _metric_names(port_fleet.metrics_text()) == _metric_names(ref_fleet.metrics_text())
    assert all(np.isfinite(v[1]) for v in want)


def _shape(d):
    """The nested keys of a stats dict (values differ by timing)."""
    if isinstance(d, dict):
        return {str(k): _shape(v) for k, v in d.items()}
    return None


def _metric_names(text):
    return sorted({line.split("{")[0].split(" ")[0] for line in text.splitlines()
                   if line and not line.startswith("#")})


def test_rpc_replica_spawned_from_a_jax_blocked_process(tmp_path):
    """A process that cannot import JAX or the reference fits a port
    predictor, spawns one ``python -m repro_torch.serve.rpc`` child with
    ``synthetic_trace`` and gets its answer; the child reports no JAX, no
    reference and no CUDA context."""
    code = textwrap.dedent(f"""
        import json, math, sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None  # any import of these raises ImportError
        from repro_torch.core.automl.models import RidgeRegressor
        from repro_torch.core.predictor import DNNAbacus
        from repro_torch.serve.rpc import spawn_replica, synthetic_trace

        class Cfg:
            name, family, num_layers, d_model = "wire", "dense", 4, 64

        recs = []
        for i in range(12):
            rec = synthetic_trace(Cfg(), 2 + i % 4, 32 * (1 + i % 3))
            rec.time_s, rec.mem_bytes = 0.01 * (1 + i), 1e6 * (1 + i)
            recs.append(rec)
        ab = DNNAbacus(seed=0).fit(recs, candidate_factory=lambda s: [RidgeRegressor()])
        path = {str(tmp_path / "predictor")!r}
        ab.save(path)
        rep = spawn_replica("r0", path, tracer="repro_torch.serve.rpc:synthetic_trace",
                            trace_root={str(tmp_path / "t")!r})
        try:
            est = rep.predict_one(Cfg(), 4, 64, timeout=60)
            info = rep.process_info()
        finally:
            rep.shutdown()
        assert math.isfinite(est["time_s"]) and est["admitted"] in (True, False), est
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print(json.dumps(info))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert info["modules"] == {"torch": True, "jax": False, "repro": False}
    assert info["cuda_initialized"] is False and info["pid"] > 0
