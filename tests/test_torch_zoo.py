"""Port parity: the zoo's structure (repro_torch.core.zoo), the random CNNs
(repro_torch.core.randomgen), single layers, the rig's optimizers and the
zoo's records (repro_torch.core.profiler).

Whole networks against the reference are in ``tests/test_torch_zoo_nets.py``
and ``tests/test_torch_zoo_mobile.py``; the NSM and FLOPs of a zoo step in
``tests/test_torch_zoo_nsm.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import close, jax_paths, one_torch_thread, zoo_jax_params  # noqa: E402,F401
from repro.core import profiler as jprof  # noqa: E402
from repro.core import randomgen as jrand  # noqa: E402
from repro.core import zoo as jzoo  # noqa: E402
from repro.core.features import ProfileRecord as JRecord  # noqa: E402
from repro.core.features import record_to_json as jax_record_to_json  # noqa: E402
from repro.models.module import ParamSpec as JSpec  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import profiler as tprof  # noqa: E402
from repro_torch.core import randomgen as trand  # noqa: E402
from repro_torch.core import zoo as tzoo  # noqa: E402
from repro_torch.core.features import PLATFORM_TORCH_CUDA, record_to_json  # noqa: E402


def _ref_shapes(model):
    """{reference path: parameter shape} of a reference ZooModel."""
    spec_tree, _ = model.net.spec(model.cin)
    return {k: tuple(v.shape) for k, v in jax_paths(jax.tree.map(
        lambda ps: np.empty(ps.shape, np.float32), spec_tree,
        is_leaf=lambda a: isinstance(a, JSpec))).items()}


def _same_structure(port, ref):
    """Every reference parameter has its port parameter, of the same shape
    (conv weights HWIO -> OIHW), and the layer counts are equal."""
    shapes = _ref_shapes(ref)
    paths = port.ref_paths()
    assert set(paths) == set(shapes)
    specs = port.param_specs()
    assert len(specs) == len(paths)
    for path, shape in shapes.items():
        want = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape
        assert specs[paths[path]].shape == want, path
    assert port.param_count() == sum(int(np.prod(s)) for s in shapes.values())
    assert port.layer_count() == ref.layer_count()


def test_zoo_lists_equal():
    assert list(tzoo.ZOO) == list(jzoo.ZOO) and len(tzoo.ZOO) == 29
    assert tzoo.UNSEEN == jzoo.UNSEEN and tzoo.LIGHTWEIGHT == jzoo.LIGHTWEIGHT


@pytest.mark.parametrize("name", list(jzoo.ZOO))
def test_zoo_net_structure_equal(name):
    for image in (32, 24):
        _same_structure(tzoo.build_zoo_model(name, image=image),
                        jzoo.build_zoo_model(name, image=image))


@pytest.mark.parametrize("seed", range(24))
def test_random_cnn_same_structure(seed):
    port, ref = trand.random_cnn(seed), jrand.random_cnn(seed)
    assert port.name == ref.name
    _same_structure(port, ref)


def test_random_lm_config_equal_and_moe_raises():
    """Every random LM draw equals the reference's and builds, the MoE ones
    (seeds 7 and 11 of collect.py's random grid) included, with the
    reference's parameter counts, total and active."""
    from repro.configs.base import ModelConfig as JConfig
    from repro.models import build_model as jax_build
    from repro_torch.models import build_model
    kinds = set()
    for seed in range(12):
        cfg = trand.random_lm_config(seed)
        jcfg = jrand.random_lm_config(seed)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert isinstance(cfg, ModelConfig) and not isinstance(cfg, JConfig)
        kinds.add(cfg.family)
        model = build_model(cfg, device="meta")
        for active in (False, True):
            assert model.param_count(active) == jax_build(jcfg).param_count(active) > 0
    assert {"moe", "dense", "ssm"} <= kinds
    assert [trand.random_lm_config(s).family for s in (7, 11)] == ["moe", "moe"]


@pytest.mark.parametrize("size,k,stride,pads", [
    (32, 3, 2, (0, 1)), (31, 3, 2, (1, 1)), (32, 1, 2, (0, 0)), (32, 2, 2, (0, 0)),
    (16, 3, 1, (1, 1)), (4, 5, 1, (2, 2)), (8, 3, 2, (0, 1))])
def test_same_padding_is_xlas(size, k, stride, pads):
    assert tzoo._same_pads(size, k, stride) == pads


# single layers where a straight translation would differ, at even and odd
# sizes: (port recipe, reference layer)
_LAYERS = {
    "conv_s2_same": (tzoo.Conv.of(6, 3, 2), jzoo.Conv(6, 3, 2)),
    "conv_s2_5x5": (tzoo.Conv.of(6, 5, 2), jzoo.Conv(6, 5, 2)),
    "depthwise_s2": (tzoo.Depthwise.of(3, 2), jzoo.Depthwise(3, 2)),
    "grouped": (tzoo.Conv.of(8, 3, 1, groups=4), jzoo.Conv(8, 3, 1, groups=4)),
    "conv_valid_bias": (tzoo.Conv.of(6, 5, bias=True, pad="VALID"),
                        jzoo.Conv(6, 5, bias=True, pad="VALID")),
    "max_same": (tzoo.Pool.of("max", 3, 1, "SAME"), jzoo.Pool("max", 3, 1, "SAME")),
    "max_s2_same": (tzoo.Pool.of("max", 3, 2, "SAME"), jzoo.Pool("max", 3, 2, "SAME")),
    "avg_s2_same": (tzoo.Pool.of("avg", 3, 2, "SAME"), jzoo.Pool("avg", 3, 2, "SAME")),
    "avg_valid": (tzoo.Pool.of("avg", 2), jzoo.Pool("avg", 2)),
    "bn": (tzoo.BN.of(), jzoo.BN()),
    "shuffle": (tzoo.Shuffle.of(4), jzoo.Shuffle(4)),
    "se": (tzoo.SE.of(), jzoo.SE()),
    "relu6": (tzoo.Act.of("relu6"), jzoo.Act("relu6")),
    "flatten_dense": (tzoo.Seq.of(tzoo.Flatten.of(5), tzoo.Dense.of(7)),
                      jzoo.Seq(jzoo.Flatten(5), jzoo.Dense(7))),
}


@pytest.mark.parametrize("name", list(_LAYERS))
def test_layer_matches_reference(name):
    recipe, layer = _LAYERS[name]
    for size in ((5,) if name == "flatten_dense" else (9, 8)):
        ref = jzoo.ZooModel(name, jzoo.Seq(layer), 8)
        ref.net.spec(8)
        port = tzoo.ZooModel(name, tzoo.Seq.of(recipe).build(8), 8)
        params = zoo_jax_params(ref, seed=size)
        x = np.random.default_rng(size).standard_normal((2, size, size, 8)).astype(np.float32)
        want = ref.apply(jax.tree.map(lambda a: a.astype(np.float32), params), x)
        got = port.apply(tzoo.zoo_params_from_jax(port, jax_paths(params)),
                         torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        if got.dim() == 4:
            got = got.permute(0, 2, 3, 1)
        assert tuple(got.shape) == tuple(want.shape)
        close(got, want, 1e-5)


def test_params_from_jax_checks_keys_and_shapes():
    ref, port = jzoo.build_zoo_model("lenet5"), tzoo.build_zoo_model("lenet5")
    flat = jax_paths(zoo_jax_params(ref))
    assert set(tzoo.zoo_params_from_jax(port, flat)) == set(port.param_specs())
    with pytest.raises(KeyError, match="missing"):
        tzoo.zoo_params_from_jax(port, {k: v for k, v in flat.items() if k != "0/w"})
    with pytest.raises(ValueError, match="shape"):
        tzoo.zoo_params_from_jax(port, {**flat, "0/w": flat["0/w"][:1]})


def test_init_is_seeded_and_scaled():
    model = tzoo.build_zoo_model("resnet18")
    a = model.init(torch.Generator().manual_seed(0))
    b = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["layers.0.layers.0.w"]  # the stem conv: 3x3 over 3 channels
    assert w.shape == (64, 3, 3, 3) and abs(w.std().item() * 27 ** 0.5 - 1) < 0.15
    assert torch.equal(a["layers.0.layers.1.g"], torch.ones(64))
    x = torch.randn(2, 3, 32, 32)
    assert model.apply(a, x).shape == (2, 10)


_OPT_SHAPES = {"a": (3, 4), "b": (5,)}


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam", "adamw"])
def test_make_optimizer_two_steps_match_reference(kind):
    rng = np.random.default_rng(0)
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in _OPT_SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in _OPT_SHAPES.items()}
             for _ in range(2)]
    jinit, jupdate = jprof.make_optimizer(kind, 0.05)
    tinit, tupdate = tprof.make_optimizer(kind, 0.05)
    jp, js = {k: jnp.asarray(v) for k, v in p.items()}, None
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    js, ts = jinit(jp), tinit(tp)
    for g in grads:
        jp, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = tupdate({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
    for k in p:
        close(tp[k], jp[k], 1e-6)
    if kind in ("adam", "adamw"):
        assert int(ts["t"]) == int(js["t"]) == 2 and ts["t"].dtype == torch.int32
    with pytest.raises(ValueError):
        tprof.make_optimizer("lamb", 0.1)


def test_zoo_train_step_updates_like_reference():
    """One sgd step of lenet5 from the same weights: the new parameters."""
    ref, port = jzoo.build_zoo_model("lenet5"), tzoo.build_zoo_model("lenet5")
    params = jax.tree.map(lambda a: a.astype(np.float32), zoo_jax_params(ref))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4)
    jstep, jinit = jprof.zoo_train_step(ref, "momentum", 0.1)
    want, _ = jstep(params, jinit(params), x, jnp.asarray(y, jnp.int32))
    tstep, tinit = tprof.zoo_train_step(port, "momentum", 0.1)
    tp = tzoo.zoo_params_from_jax(port, jax_paths(params))
    got, state = tstep(tp, tinit(tp), torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                       torch.from_numpy(y))
    paths = port.ref_paths()
    for path, arr in jax_paths(want).items():
        close(got[paths[path]], arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr, 1e-5)
    assert set(state["m"]) == set(tp)


def test_zoo_record_field_mapping_matches_reference():
    name, batch, image = "resnext29", 8, 24
    ref, port = jzoo.build_zoo_model(name, image=image), tzoo.build_zoo_model(name, image=image)
    edges = {("conv", "add"): 3.0}
    kw = dict(flops=2.5e9, nsm_edges=edges, time_s=0.01, mem_bytes=1e9)
    got = tprof.zoo_record(port, batch, image, lr=0.1, optimizer="adam", **kw)
    n_params = sum(int(np.prod(s)) for s in _ref_shapes(ref).values())
    want = JRecord(model_name=name, family="cnn", batch_size=batch, input_size=image,
                   channels=3, learning_rate=0.1, epoch=1, optimizer="adam",
                   layers=ref.layer_count(), params=n_params, platform=PLATFORM_TORCH_CUDA,
                   **kw)
    assert record_to_json(got) == jax_record_to_json(want)
    assert (got.si_vector() == want.si_vector()).all()
    assert got.platform == PLATFORM_TORCH_CUDA


def test_zoo_measurement_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        tprof.profile_zoo("lenet5", batch=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tprof.profile_zoo_model(trand.random_cnn(0), batch=2, device="cpu")
