"""Port parity: the NSM and FLOPs of a zoo train step (repro_torch.core.nsm,
repro_torch.core.profiler), in the manner of ``tests/test_torch_nsm_profiler.py``.

Each aten op a zoo step emits that the port renames is held against the
reference's ``nsm_of_fn`` on the same layer written in JAX: pooling and its
transpose, the ReLU / ReLU6 / tanh / swish gradients, BN's variance,
grouped and strided convolutions and the channel shuffle. A whole zoo
step's operator names lie within the reference's. FLOPs: a layer's step
and a net's forward equal the convolutions and matrix products of the
reference's HLO; a net's step equals the per-layer count, and the
reference's HLO less the zeros XLA convolves in strided or VALID input
gradients.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import one_torch_thread  # noqa: E402,F401
from repro.analysis import hlo as jhlo  # noqa: E402
from repro.core import nsm as jnsm  # noqa: E402
from repro.core import profiler as jprof  # noqa: E402
from repro.core import zoo as jzoo  # noqa: E402
from repro_torch.core import profiler as tprof  # noqa: E402
from repro_torch.core import zoo as tzoo  # noqa: E402
from repro_torch.core.nsm import nsm_of_fn, trace as nsm_trace  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._pytree import tree_map  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

C = 8


def _built(recipe):
    return tzoo.Seq.of(recipe).build(C)


def _ref(layer):
    seq = jzoo.Seq(layer)
    spec_tree, _ = seq.spec(C)
    params = jax.tree.map(lambda ps: jnp.ones(ps.shape), spec_tree,
                          is_leaf=lambda a: isinstance(a, jzoo.ParamSpec))
    return seq, params


def _port_fn(recipe, grad):
    """(function of (x, params), params as ``meta`` tensors)."""
    model = tzoo.ZooModel("t", _built(recipe), C)

    def fwd(x, params):
        return model.apply(params, torch.tanh(x))

    def bwd(x, params):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(torch.sin(fwd(x, params)).sum(), x)[0]
    return (bwd if grad else fwd), model.param_shapes()


def _ref_fn(layer, grad):
    seq, params = _ref(layer)

    def fwd(x):
        return seq.apply(params, jnp.tanh(x))
    return jax.grad(lambda x: jnp.sum(jnp.sin(fwd(x)))) if grad else fwd


def _edges(recipe, layer, grad, size=8):
    fn, params = _port_fn(recipe, grad)
    port = nsm_of_fn(fn, torch.empty(2, C, size, size, device="meta"), params)
    ref = jnsm.nsm_of_fn(_ref_fn(layer, grad), jax.ShapeDtypeStruct((2, size, size, C),
                                                                      jnp.float32))
    return port, ref


def _names(edges):
    return {op for pair in edges for op in pair}


# (name, port recipe, reference layer, names the port adds to the reference's)
_LAYERS = [
    ("max_pool", tzoo.Pool.of("max", 2), jzoo.Pool("max", 2), set()),
    ("max_pool_same", tzoo.Pool.of("max", 3, 1, "SAME"), jzoo.Pool("max", 3, 1, "SAME"), set()),
    ("avg_pool", tzoo.Pool.of("avg", 2), jzoo.Pool("avg", 2), set()),
    ("avg_pool_same", tzoo.Pool.of("avg", 3, 1, "SAME"), jzoo.Pool("avg", 3, 1, "SAME"), set()),
    ("relu", tzoo.Act.of("relu"), jzoo.Act("relu"), set()),
    ("relu6", tzoo.Act.of("relu6"), jzoo.Act("relu6"), set()),
    ("tanh", tzoo.Act.of("tanh"), jzoo.Act("tanh"), set()),
    ("swish", tzoo.Act.of("swish"), jzoo.Act("swish"), set()),
    ("global_avg", tzoo.GlobalAvg.of(), jzoo.GlobalAvg(), set()),
    ("conv", tzoo.Conv.of(C, 3), jzoo.Conv(C, 3), set()),
    ("grouped_conv", tzoo.Conv.of(C, 3, groups=4), jzoo.Conv(C, 3, groups=4), set()),
    ("depthwise", tzoo.Depthwise.of(3), jzoo.Depthwise(3), set()),
    # the autograd derivative of rsqrt is rsqrt(x) ** 3 (``integer_pow``);
    # JAX divides. The forward's counts differ too: ``jnp.var`` converts its
    # input and guards its divisor (a select on N - ddof > 0), and the port
    # broadcasts the scale by two unsqueezes
    ("bn", tzoo.BN.of(), jzoo.BN(), {"integer_pow"}),
    # uneven SAME padding goes through an explicit ``pad`` (XLA pads inside
    # the window op)
    ("avg_pool_s2_same", tzoo.Pool.of("avg", 3, 2, "SAME"), jzoo.Pool("avg", 3, 2, "SAME"),
     {"pad"}),
    ("conv_s2_same", tzoo.Conv.of(C, 3, 2), jzoo.Conv(C, 3, 2), {"pad"}),
    # torch's reshape of the transposed view copies it (``clone``: the
    # reference's ``identity``), where XLA's reshape moves the data itself
    ("shuffle", tzoo.Shuffle.of(2), jzoo.Shuffle(2), {"identity"}),
]


@pytest.mark.parametrize("name,recipe,layer,own", _LAYERS, ids=[t[0] for t in _LAYERS])
def test_layer_nsm_against_the_reference(name, recipe, layer, own):
    """Forward: the port's edges equal the reference's where the port adds
    no operator (BN aside, see above). Gradient: the port's names lie within
    the reference's and the listed ones (the counts differ: autograd's
    ``convolution_backward`` is one node where JAX reverses the kernel and
    convolves twice, and a sum's transpose expands)."""
    fwd, jfwd = _edges(recipe, layer, grad=False)
    own_fwd = own - {"integer_pow"}  # a derivative's
    if not own and name != "bn":
        assert fwd == jfwd
    assert _names(fwd) - _names(jfwd) == own_fwd
    bwd, jbwd = _edges(recipe, layer, grad=True)
    assert _names(bwd) - _names(jbwd) <= own
    assert sum(bwd.values()) > sum(fwd.values())


def test_pool_names_are_the_references():
    fwd, _ = _edges(tzoo.Pool.of("max", 2), jzoo.Pool("max", 2), grad=True)
    assert {"reduce_window_max", "select_and_scatter_add"} <= _names(fwd)
    fwd, _ = _edges(tzoo.Pool.of("avg", 2), jzoo.Pool("avg", 2), grad=True)
    assert ("pad", "reduce_window_sum") in fwd and ("reduce_window_sum", "div") in fwd


def _zoo_trace(model, batch, image, optimizer="sgd"):
    step, init = tprof.zoo_train_step(model, optimizer, 0.1)
    ps = model.param_shapes()
    return tprof.trace_step(step, (ps, init(ps), torch.empty(batch, 3, image, image, device="meta"),
                                   torch.empty(batch, dtype=torch.int64, device="meta")))


def _ref_step(name, batch, image, optimizer="sgd"):
    model = jzoo.build_zoo_model(name, image=image)
    spec_tree, _ = model.net.spec(3)
    params = jax.tree.map(lambda ps: jax.ShapeDtypeStruct(ps.shape, jnp.float32), spec_tree,
                          is_leaf=lambda a: isinstance(a, jzoo.ParamSpec))
    step, init = jprof.zoo_train_step(model, optimizer, 0.1)
    opt = jax.eval_shape(init, params)
    return model, step, (params, opt, jax.ShapeDtypeStruct((batch, image, image, 3), jnp.float32),
                         jax.ShapeDtypeStruct((batch,), jnp.int32))


@pytest.mark.parametrize("name,optimizer", [("lenet5", "adam"), ("shufflenet_v1", "sgd"),
                                            ("mobilenet_v2", "momentum"),
                                            ("efficientnet_lite0", "adamw")])
def test_zoo_step_names_within_the_reference(name, optimizer):
    """A zoo train step's operator names lie within the reference's. With BN
    the port adds one, ``integer_pow`` (autograd's rsqrt derivative);
    lenet5 has no BN."""
    _, step, args = _ref_step(name, 2, 32, optimizer)
    ref = _names(jnsm.nsm_of_fn(step, *args))
    port = _names(_zoo_trace(tzoo.build_zoo_model(name), 2, 32, optimizer)["nsm_edges"])
    own = set() if name == "lenet5" else {"integer_pow"}
    assert port - ref == own
    assert len(port & ref) >= 20


def test_zoo_step_nsm_deterministic_and_batch_free():
    model = tzoo.build_zoo_model("squeezenet")
    a = _zoo_trace(model, 2, 32)["nsm_edges"]
    assert a == _zoo_trace(model, 2, 32)["nsm_edges"]
    assert a == _zoo_trace(model, 8, 32)["nsm_edges"]  # the graph, not its sizes


class _DotsOnly(jhlo.HloCostModel):
    """The reference's HLO cost model charging matrix products and
    convolutions only, the operations ``FlopCounterMode`` counts."""
    _KEEP = ("dot", "convolution", "fusion", "call", "custom-call", "while", "conditional",
             "async-start")

    def _instr_cost(self, instr, comp, env, top_level):
        cost = super()._instr_cost(instr, comp, env, top_level)
        if instr.op not in self._KEEP:
            cost.flops = 0.0
        return cost


def _lowered_products(fn, *args):
    """FLOPs of the matrix products and convolutions of ``fn``'s HLO as JAX
    lowers it, before XLA's CPU passes. Those passes rewrite a grouped
    convolution's weight gradient as a dense convolution, ``groups`` times
    the products, so the compiled module charges products the function does
    not make."""
    from jax._src.lib import xla_client
    module = jax.jit(fn).lower(*args).compiler_ir("hlo").as_hlo_module()
    return _DotsOnly(module.to_string(xla_client._xla.HloPrintOptions())).total().flops


# (name, port recipe, reference layer): stride 1, SAME padding
_FLOP_LAYERS = [
    ("conv", tzoo.Conv.of(C, 3), jzoo.Conv(C, 3)),
    ("grouped_conv", tzoo.Conv.of(C, 3, groups=4), jzoo.Conv(C, 3, groups=4)),
    ("grouped_1x1", tzoo.Conv.of(C, 1, groups=4), jzoo.Conv(C, 1, groups=4)),
    ("depthwise", tzoo.Depthwise.of(3), jzoo.Depthwise(3)),
]


@pytest.mark.parametrize("name,recipe,layer", _FLOP_LAYERS, ids=[t[0] for t in _FLOP_LAYERS])
def test_layer_step_flops_equal_the_reference_hlo(name, recipe, layer):
    """A layer's forward, input gradient and weight gradient: at stride 1
    with SAME padding XLA convolves no zeros, and the port's count equals
    the products of the reference's HLO for the same function. torch's own
    formula charges a grouped weight gradient ``groups`` forwards' worth."""
    model = tzoo.ZooModel("t", _built(recipe), C)

    def step(params, x):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = torch.sin(model.apply(leaves, x)).sum()
            return torch.autograd.grad(out, [x, *leaves.values()])
    args = (model.param_shapes(), torch.empty(2, C, 8, 8, device="meta"))
    got = tprof.trace_step(step, args)["flops"]
    seq, params = _ref(layer)
    ref = jax.grad(lambda p, x: jnp.sum(jnp.sin(seq.apply(p, x))), argnums=(0, 1))
    assert got == _lowered_products(ref, params, jnp.ones((2, 8, 8, C)))
    fake_mode = FakeTensorMode()
    with fake_mode:
        fake = tree_map(lambda t: torch.empty(t.shape), args)
    graph = nsm_trace(step, *fake)
    with fake_mode, FlopCounterMode(display=False) as torch_own:
        graph(*fake)
    groups = model.net.layers[0].groups
    assert torch_own.get_total_flops() == got + (groups - 1) * got / 3


def _layer_flops(model, batch, image):
    """Per conv or Dense layer: (forward FLOPs, input positions over output
    positions), from a forward on ``meta`` tensors."""
    rows = []

    def hook(mod, inputs, out):
        if isinstance(mod, tzoo.Conv):
            grow = inputs[0].shape[-2] * inputs[0].shape[-1] / (out.shape[-2] * out.shape[-1])
            rows.append((2 * out.numel() * mod.k * mod.k * mod.cin // mod.groups, grow))
        elif isinstance(mod, tzoo.Dense):
            rows.append((2 * out.numel() * mod.cin, 1))
    handles = [m.register_forward_hook(hook) for m in model.net.modules()
               if isinstance(m, (tzoo.Conv, tzoo.Dense))]
    model.net(torch.empty(batch, 3, image, image, device="meta"))
    for h in handles:
        h.remove()
    return rows


# lenet5: VALID convs and Dense; mobilenet_v1: depthwise; resnext29: grouped
# and strided; shufflenet_v1: grouped 1x1s, the shuffle and stride-2 SAME
# average pooling
FLOP_NETS = ["lenet5", "mobilenet_v1", "resnext29", "shufflenet_v1"]


@pytest.mark.parametrize("name", FLOP_NETS)
def test_zoo_flops_equal_the_reference_hlo_and_the_layer_count(name):
    """The forward's FLOPs equal the convolutions and matrix products of the
    reference's compiled forward. The step's are the forward, each layer's
    weight gradient and each layer's input gradient but the stem's, each
    one forward's worth. The reference's step HLO (as lowered, see
    ``_lowered_products``) charges that and the zeros XLA convolves: the
    input gradient of a strided or VALID convolution convolves the dilated
    or zero-bordered map, one product a position of the layer's input (the
    ``grow`` of ``_layer_flops``; lenet5: 921,600 FLOPs, the second conv's
    5x5 full convolution)."""
    batch, image = 2, 32
    model = tzoo.build_zoo_model(name)
    jmodel, step, args = _ref_step(name, batch, image)
    fwd_hlo = jax.jit(jmodel.apply).lower(args[0], args[2]).compile().as_text()
    rows = _layer_flops(model, batch, image)
    fwd = sum(f for f, _ in rows)
    assert fwd == _DotsOnly(fwd_hlo).total().flops
    got = _zoo_trace(model, batch, image)["flops"]
    assert got == 2 * fwd + sum(f for f, _ in rows[1:])
    zeros = sum(f * (grow - 1) for f, grow in rows[1:])
    assert _lowered_products(step, *args) == got + zeros
    if name == "lenet5":
        assert zeros == 921_600


def test_zoo_trace_needs_no_card_and_measuring_raises():
    model = tzoo.build_zoo_model("nin")
    assert _zoo_trace(model, 2, 24)["flops"] > 0
    step, init = tprof.zoo_train_step(model, "sgd", 0.1)
    ps = model.param_shapes()
    with pytest.raises(RuntimeError, match="CUDA card"):
        tprof.measure_step(step, (ps, init(ps), torch.empty(2, 3, 24, 24, device="meta"),
                                  torch.empty(2, dtype=torch.int64, device="meta")), device="cpu")
