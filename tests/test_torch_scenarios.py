"""The port's drift-scenario replays (repro_torch.scenarios) on its fleet.

The reference's suites ``test_scenarios`` and ``test_overload`` run against
the port's copies, bound by ``_torch_parity.port_suite``: each test below
that carries a suite's name is that suite's test, run on
``repro_torch.scenarios``, ``repro_torch.serve`` and ``repro_torch.obs``,
with its ``slow`` and ``scenario`` marks. Beside them, with no tolerance:

- a schedule is the reference's byte for byte (so its digest is too) for
  the suites' specs, the overload spec and the benchmark's composed spec;
- the port's digest child runs with JAX and the reference blocked;
- a server replay of one schedule answers every query with the reference's
  estimates. The port's records carry ``PLATFORM_TORCH_CUDA`` where the
  reference's carry 0: a feature constant over every record, which no tree
  of the scenario predictor's forest splits on.
"""

import dataclasses
import os
import sys

import pytest

pytest.importorskip("torch")

from _torch_parity import port_suite, suite_tests  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import repro.scenarios as jscen  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.scenarios as tscen  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from benchmarks.bench_scenarios import composed_spec  # noqa: E402

SCEN, OVER = port_suite("test_scenarios"), port_suite("test_overload")
globals().update(suite_tests(SCEN, OVER))


def _spec_dicts():
    small = [SCEN._small_spec(seed=s).to_dict() for s in (0, 3, 17, 4242)]
    churn = SCEN._small_spec(seed=21, churn_rate=3.0).to_dict()
    return small + [churn, tscen.tenant_overload_spec(True).to_dict(),
                    tscen.tenant_overload_spec(False).to_dict(),
                    composed_spec(True).to_dict(), composed_spec(False).to_dict()]


@pytest.mark.parametrize("i", range(9))
def test_schedule_bytes_and_digest_equal_the_references(i):
    d = _spec_dicts()[i]
    ours, ref = tscen.ScenarioSpec.from_dict(d), jscen.ScenarioSpec.from_dict(d)
    assert ours.to_dict() == ref.to_dict() == d
    assert tscen.generate(ours).to_jsonl() == jscen.generate(ref).to_jsonl()
    assert tscen.schedule_digest(ours) == jscen.schedule_digest(ref)


def test_overload_spec_is_the_references():
    for smoke in (True, False):
        assert tscen.tenant_overload_spec(smoke).to_dict() == \
            jscen.tenant_overload_spec(smoke).to_dict()


def test_digest_child_needs_no_jax(tmp_path, monkeypatch):
    """The port's digest child, with ``jax``, ``jaxlib`` and ``repro`` made
    unimportable by a ``sitecustomize`` ahead of everything on its path but
    the sources, gives the digest of this process (and of the reference)."""
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(
        "import sys\nfor name in ('jax', 'jaxlib', 'repro'):\n    sys.modules[name] = None\n")
    monkeypatch.setenv("PYTHONPATH", str(blocker))
    spec = tscen.ScenarioSpec.from_dict(composed_spec(True).to_dict())
    want = jscen.schedule_digest(jscen.ScenarioSpec.from_dict(spec.to_dict()))
    assert tscen.schedule_digest(spec) == want
    assert tscen.schedule_digest_subprocess(spec, 7) == want


def test_fit_records_carry_the_ports_platform():
    from repro_torch.core.features import PLATFORM_TORCH_CUDA
    cfg = tscen.config_from_payload({"name": "x", "dots": 9.0})
    assert tscen.scenario_trace(cfg, 2, 32).platform == PLATFORM_TORCH_CUDA
    assert {r.platform for r in tscen.fit_records()} == {PLATFORM_TORCH_CUDA}
    for ours, theirs in zip(tscen.fit_records(seed=3), jscen.fit_records(seed=3)):
        assert dataclasses.asdict(ours) == dict(dataclasses.asdict(theirs),
                                                platform=PLATFORM_TORCH_CUDA)


def _replay(pkg_scen, pkg_serve, spec_dict):
    abacus = pkg_scen.fit_abacus()
    svc = pkg_serve.PredictionService(abacus, tracer=pkg_scen.scenario_trace)
    with pkg_serve.AbacusServer(svc) as srv:
        return pkg_scen.ScenarioRunner(
            srv, pkg_scen.generate(pkg_scen.ScenarioSpec.from_dict(spec_dict))).run()


def test_server_replay_estimates_equal_the_references():
    spec = SCEN._small_spec(seed=31).to_dict()
    ours, ref = _replay(tscen, tserve, spec), _replay(jscen, jserve, spec)
    assert ours.ground == ref.ground
    assert sorted(ours.outcomes) == sorted(ref.outcomes)
    keys = ("ok", "time_s", "mem_bytes", "model", "generation", "admitted", "degraded")
    for i, o in ours.outcomes.items():
        assert {k: o.get(k) for k in keys} == {k: ref.outcomes[i].get(k) for k in keys}, i
    assert not tscen.failed(tscen.check_all(ours))
