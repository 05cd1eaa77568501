"""Port parity: DNNAbacus (repro_torch.core.predictor), the baselines
(repro_torch.core.baselines) and the scheduler (repro_torch.core.scheduler).

The records are ``tests/test_predictor_sched.py``'s synthetic ones. The same
records give bit-identical predictions from both packages, for every
representation, and the ``to_dict`` JSON crosses between them both ways.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import one_torch_thread  # noqa: E402,F401
from repro.core import baselines as jb  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core.automl import models as jm  # noqa: E402
from repro.core.features import ProfileRecord as JRecord  # noqa: E402
from repro.core.predictor import DNNAbacus as JAbacus  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import predictor as tp  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core.automl import models as tm  # noqa: E402
from repro_torch.core.features import ProfileRecord, design_matrix, targets  # noqa: E402


def _synthetic_records(cls, n=120, seed=0):
    """Records whose targets follow a known law of the features + NSM."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        batch = int(rng.choice([8, 16, 32, 64]))
        image = int(rng.choice([24, 32, 48]))
        layers = int(rng.integers(4, 40))
        convs = float(rng.integers(4, 60))
        flops = batch * image ** 2 * convs * 1e6
        time_s = flops / 5e10 * (1 + 0.1 * (batch < 16))
        mem = 1e6 * convs + 4.0 * batch * image * image * 64
        edges = {("conv", "add"): convs, ("add", "max"): convs,
                 ("max", "conv"): convs - 1, ("dot", "add"): 2.0}
        recs.append(cls(
            model_name=f"m{i}", family="cnn" if i % 3 else "dense", batch_size=batch,
            input_size=image, channels=3, learning_rate=0.1, epoch=1,
            optimizer=("sgd", "adam")[i % 2], layers=layers, flops=flops,
            params=int(convs * 1e5), nsm_edges=edges, time_s=time_s, mem_bytes=mem))
    return recs


def _factory(mod):
    def make(seed):
        return [mod.RandomForestRegressor(n_trees=12, max_depth=12, seed=seed),
                mod.GradientBoostingRegressor(n_stages=40, seed=seed),
                mod.RidgeRegressor()]
    return make


def _pair(rep, n=40):
    port_recs, ref_recs = _synthetic_records(ProfileRecord, n), _synthetic_records(JRecord, n)
    port = tp.DNNAbacus(representation=rep, seed=3).fit(port_recs[:30],
                                                        candidate_factory=_factory(tm))
    ref = JAbacus(representation=rep, seed=3).fit(ref_recs[:30], candidate_factory=_factory(jm))
    return port, ref, port_recs, ref_recs


def _same_predictions(port, ref, port_recs, ref_recs):
    for (pt, pm), (rt, rm) in zip([port.predict(port_recs)], [ref.predict(ref_recs)]):
        assert (pt == rt).all() and (pm == rm).all()


@pytest.mark.parametrize("rep", ["nsm", "ge", "none"])
def test_abacus_bit_identical_and_json_crosses(rep, tmp_path):
    port, ref, port_recs, ref_recs = _pair(rep)
    _same_predictions(port, ref, port_recs, ref_recs)
    assert port.evaluate(port_recs[30:]) == ref.evaluate(ref_recs[30:])
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())
    # a reference predictor loaded by the port, and the port's by the reference
    _same_predictions(tp.DNNAbacus.from_dict(ref.to_dict()), ref, port_recs, ref_recs)
    _same_predictions(port, JAbacus.from_dict(port.to_dict()), port_recs, ref_recs)
    port.save(str(tmp_path / "ab"))
    _same_predictions(JAbacus.load(str(tmp_path / "ab")), ref, port_recs, ref_recs)


def test_abacus_refit_bit_identical():
    port, ref, port_recs, ref_recs = _pair("nsm")
    new_port, new_ref = port.refit(port_recs[10:]), ref.refit(ref_recs[10:])
    assert new_port is not port and new_port.time_model is not port.time_model
    _same_predictions(new_port, new_ref, port_recs, ref_recs)
    _same_predictions(port, ref, port_recs, ref_recs)  # the original is untouched
    assert json.dumps(new_port.to_dict()) == json.dumps(new_ref.to_dict())


def test_hbm_budget_and_unported_service(tmp_path):
    """The service fronts the predictor at the card's budget, and takes the
    port's persistent trace store (unported until the serving fleet) once:
    an attached store is never swapped out."""
    from repro_torch.serve.trace_store import SegmentTraceStore
    assert tp.HBM_PER_DEVICE == 85_017_493_504  # one H100 80GB HBM3's total memory
    ab = tp.DNNAbacus()
    svc = ab.service()
    assert svc.hbm_budget == tp.HBM_PER_DEVICE and ab.service() is svc and svc.store is None
    store = SegmentTraceStore(str(tmp_path / "a"))
    assert ab.service(store=store) is svc and svc.store is store
    assert ab.service(store=SegmentTraceStore(str(tmp_path / "b"))).store is store


def test_shape_inference_memory_equal():
    for pr, rr in zip(_synthetic_records(ProfileRecord, 12), _synthetic_records(JRecord, 12)):
        assert tb.shape_inference_memory(pr) == jb.shape_inference_memory(rr)


def _reference_init(seed, sizes):
    """The reference MLPBaseline's initial weights (its jax.random draw)."""
    key = jax.random.key(seed)
    out = []
    for i in range(len(sizes) - 1):
        key, k = jax.random.split(key)
        w = jax.random.normal(k, (sizes[i], sizes[i + 1])) * (1.0 / np.sqrt(sizes[i]))
        out.append((np.asarray(w), np.zeros(sizes[i + 1], np.float32)))
    return out


# Both fit by 400 full-batch fp32 Adam steps (the default); from the same
# initial weights the port's predictions stay within 1e-5 of the reference's,
# relative (4e-7 seen).
MLP_RTOL = 1e-5


@pytest.mark.parametrize("target", ["time", "mem"])
def test_mlp_baseline_matches_reference_from_the_same_weights(target):
    recs = _synthetic_records(ProfileRecord, 60)
    x = design_matrix(recs)
    y = targets(recs)[0 if target == "time" else 1]
    ref = jb.MLPBaseline(seed=2).fit(x[:45], y[:45])
    sizes = [x.shape[1], *ref.hidden, 1]
    port = tb.MLPBaseline(seed=2, device="cpu").fit(
        x[:45], y[:45], init=_reference_init(2, sizes))
    np.testing.assert_allclose(port.predict(x), ref.predict(x), rtol=MLP_RTOL)
    own = tb.MLPBaseline(seed=2, device="cpu").fit(x[:45], y[:45])
    pred = own.predict(x[45:])
    assert np.isfinite(pred).all() and (pred > 0).all()


def test_mlp_baseline_runs_on_the_card_by_default():
    assert tb.MLPBaseline().device.type == "cuda"


GIB = 2**30


def _jobs(mod, n=10, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Job(f"j{i}", float(rng.uniform(5, 80)), float(rng.uniform(1, 8) * GIB))
            for i in range(n)]


def test_scheduler_equal_makespans_and_assignments():
    machines = {m: [m.Machine("m1", 11 * GIB), m.Machine("m2", 24 * GIB)]
                for m in (tsched, jsched)}
    jobs = {m: _jobs(m) for m in (tsched, jsched)}
    for fn, kw in (("schedule_optimal", {}), ("schedule_random", {"trials": 20, "seed": 1}),
                   ("schedule_ga", {"generations": 15, "seed": 1})):
        got = getattr(tsched, fn)(jobs[tsched], machines[tsched], **kw)
        want = getattr(jsched, fn)(jobs[jsched], machines[jsched], **kw)
        assert got[0] == want[0], fn
        assert list(np.asarray(got[1])) == list(np.asarray(want[1])), fn
    assign = [i % 2 for i in range(10)]
    assert tsched.makespan(assign, jobs[tsched], machines[tsched]) == \
        jsched.makespan(assign, jobs[jsched], machines[jsched])
