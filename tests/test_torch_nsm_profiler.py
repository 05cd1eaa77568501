"""Port parity: the NSM (repro_torch.core.nsm), the record mapping and the
FLOP count of the profiled train step (repro_torch.core.profiler).

Every NSM contract of ``tests/test_nsm.py`` is checked against the
reference: the same function written with ``jnp`` goes through
``repro.core.nsm.nsm_of_fn`` and the port's edges must equal its edges, so
the canonical names are the reference's primitives. The reference walks
jaxprs and multiplies a scanned layer body by its trip count; the port walks
``make_fx`` aten graphs, where loops unroll, so the port's loops are held
against the reference's scans. For a whole reduced train step the port's
operator names must lie within the reference's. FLOPs: ``FlopCounterMode``
over the step's graph equals the matrix products of the reference's
compiled HLO.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hypo import given, settings, st  # noqa: E402

from _torch_parity import torch_cfg  # noqa: E402
from repro.analysis import hlo as jhlo  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core import nsm as jnsm  # noqa: E402
from repro.core import profiler as jprof  # noqa: E402
from repro.core.features import record_to_json as jax_record_to_json  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import profiler as tprof  # noqa: E402
from repro_torch.core.features import PLATFORM_TORCH_CUDA, record_to_json  # noqa: E402
from repro_torch.core.nsm import NSMFeaturizer, nsm_of_fn  # noqa: E402

F = torch.nn.functional


def _x(*shape):
    return torch.empty(shape, device="meta")


def _edges(torch_fn, jax_fn, *shapes):
    """(port, reference) edges of twin functions at the same float32 shapes."""
    port = nsm_of_fn(torch_fn, *[_x(*s) for s in shapes])
    ref = jnsm.nsm_of_fn(jax_fn, *[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])
    return port, ref


# --- the reference's NSM contracts, each against the reference ------------------

def test_chain_counts():
    """A sequential chain of K distinct ops yields exactly K-1 edges."""
    port, ref = _edges(lambda x: torch.sin(torch.exp(torch.tanh(x))),
                       lambda x: jnp.sin(jnp.exp(jnp.tanh(x))), (4,))
    assert port == ref == {("tanh", "exp"): 1.0, ("exp", "sin"): 1.0}


def test_fanout_counts_each_consumer():
    def f(x):
        a = torch.tanh(x)
        return torch.exp(a) + torch.sin(a)

    def g(x):
        a = jnp.tanh(x)
        return jnp.exp(a) + jnp.sin(a)
    port, ref = _edges(f, g, (4,))
    assert port == ref and len(port) == 4


def test_loop_of_layers_counts_every_iteration():
    """The port's unrolled loop of 7 against the reference's scan of 7."""
    def f(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x

    def g(x, w):
        y, _ = jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x, None, length=7)
        return y
    port, ref = _edges(f, g, (4, 8), (8, 8))
    assert port == ref
    assert port[("dot", "tanh")] == 7.0 and port[("tanh", "dot")] == 6.0


def test_transparent_ops():
    """What has no operator in the reference (autograd's ``detach``,
    ``alias`` and ``t``, ``flip``, tuple indexing) passes edges through, as
    the reference's call-like primitives do."""
    def f(x):
        a = torch.tanh(x).detach().t().flip(0)
        return torch.sin(torch.max(torch.exp(torch.ops.aten.alias(a)), 0)[0])

    def g(x):
        return jnp.sin(jnp.max(jax.jit(jnp.exp)(jnp.tanh(x)), 0))
    port, ref = _edges(f, g, (4, 3))
    assert port == ref == {("tanh", "exp"): 1.0, ("exp", "reduce_max"): 1.0,
                           ("reduce_max", "sin"): 1.0}


def test_canonical_names():
    port, ref = _edges(lambda x, w: (x @ w).reshape(-1).to(torch.bfloat16),
                       lambda x, w: (x @ w).reshape(-1).astype(jnp.bfloat16), (4, 8), (8, 8))
    assert port == ref == {("dot", "reshape"): 1.0, ("reshape", "convert"): 1.0}


# (name, port function, reference twin): the other aten ops the port renames
_TWINS = [
    ("clamp_min_max", lambda x, w: torch.clamp(torch.clamp(torch.tanh(x), min=0.0), max=0.5).exp(),
     lambda x, w: jnp.exp(jnp.minimum(jnp.maximum(jnp.tanh(x), 0.0), 0.5))),
    ("maximum", lambda x, w: torch.maximum(torch.tanh(x), torch.sin(x)),
     lambda x, w: jnp.maximum(jnp.tanh(x), jnp.sin(x))),
    ("norm", lambda x, w: torch.rsqrt(torch.tanh(x).square().mean(-1, keepdim=True) + 1e-6).exp(),
     lambda x, w: jnp.exp(jax.lax.rsqrt(jnp.mean(jnp.square(jnp.tanh(x)), -1, keepdims=True)
                                        + 1e-6))),
    ("integer_pow", lambda x, w: (torch.tanh(x) ** 3).exp(),
     lambda x, w: jnp.exp(jnp.tanh(x) ** 3)),
    ("pow", lambda x, w: (torch.tanh(x) ** 2.5).exp(), lambda x, w: jnp.exp(jnp.tanh(x) ** 2.5)),
    ("where", lambda x, w: torch.where(torch.tanh(x) > 0, torch.exp(x), torch.sin(x)),
     lambda x, w: jnp.where(jnp.tanh(x) > 0, jnp.exp(x), jnp.sin(x))),
    ("sigmoid", lambda x, w: torch.sigmoid(torch.tanh(x)).exp(),
     lambda x, w: jnp.exp(jax.nn.sigmoid(jnp.tanh(x)))),
    ("silu", lambda x, w: F.silu(torch.tanh(x)).exp(),
     lambda x, w: jnp.exp(jax.nn.silu(jnp.tanh(x)))),
    ("softplus", lambda x, w: F.softplus(torch.tanh(x)).exp(),
     lambda x, w: jnp.exp(jax.nn.softplus(jnp.tanh(x)))),
    ("rsub_reciprocal_neg", lambda x, w: torch.exp(1 - 1.0 / -torch.tanh(x)),
     lambda x, w: jnp.exp(1 - 1.0 / -jnp.tanh(x))),
    ("cat_stack", lambda x, w: torch.cat([torch.tanh(x), torch.exp(x)], 1).sin(),
     lambda x, w: jnp.sin(jnp.concatenate([jnp.tanh(x), jnp.exp(x)], 1))),
    ("permute_unsqueeze_expand", lambda x, w: torch.tanh(x).T[None].expand(2, 8, 4).exp(),
     lambda x, w: jnp.exp(jnp.broadcast_to(jnp.tanh(x).T[None], (2, 8, 4)))),
    ("select_slice_squeeze", lambda x, w: torch.tanh(x)[:, 0].exp() + torch.tanh(x)[:, 1:2].squeeze(1),
     lambda x, w: jnp.exp(jnp.tanh(x)[:, 0]) + jnp.tanh(x)[:, 1:2].squeeze(1)),
    ("sum_amax_cumsum", lambda x, w: torch.cumsum(torch.tanh(x), 1).sum(-1) + torch.exp(x).amax(-1),
     lambda x, w: jnp.cumsum(jnp.tanh(x), 1).sum(-1) + jnp.exp(x).max(-1)),
    ("clone_identity", lambda x, w: torch.tanh(x).clone().exp(),
     lambda x, w: jnp.exp(jnp.array(jnp.tanh(x), copy=True))),
]


@pytest.mark.parametrize("name,f,g", _TWINS, ids=[t[0] for t in _TWINS])
def test_canonical_names_equal_the_reference(name, f, g):
    port, ref = _edges(f, g, (4, 8), (8, 8))
    assert port == ref


# twins where the reference adds operators of its own: ``jnp.clip`` converts
# its bounds, ``jnp.pad`` its pad value, ``jnp.take`` clamps its indices
_WITHIN = [
    ("clip", lambda x, i: torch.clamp(torch.tanh(x), 0.0, 1.0) * 2,
     lambda x, i: jnp.clip(jnp.tanh(x), 0.0, 1.0) * 2),
    ("pad", lambda x, i: F.pad(torch.tanh(x), (2, 0)).exp(),
     lambda x, i: jnp.exp(jnp.pad(jnp.tanh(x), ((0, 0), (2, 0))))),
    ("embedding", lambda x, i: F.embedding(i, torch.tanh(x)).exp(),
     lambda x, i: jnp.exp(jnp.take(jnp.tanh(x), i, axis=0))),
]


@pytest.mark.parametrize("name,f,g", _WITHIN, ids=[t[0] for t in _WITHIN])
def test_canonical_names_within_the_reference(name, f, g):
    """The port's edges are among the reference's, with equal counts."""
    port = nsm_of_fn(f, _x(4, 8), torch.empty(3, dtype=torch.int64, device="meta"))
    ref = jnsm.nsm_of_fn(g, jax.ShapeDtypeStruct((4, 8), jnp.float32),
                         jax.ShapeDtypeStruct((3,), jnp.int32))
    assert len(port) >= 2 and all(ref.get(pair) == n for pair, n in port.items())


def test_top_k_named_as_the_reference():
    """The MoE router's top-k (a stable sort and a slice) is one ``top_k``,
    as ``jax.lax.top_k``; its gradient's scatter is a ``scatter-add``, and
    the gradient's operator names lie within the reference's but for the
    slice's transpose, a ``pad`` (as JAX transposes a slice)."""
    from repro_torch.models import moe as tmoe

    def f(x):
        return tmoe.top_k(torch.tanh(x), 2)[0].exp()

    def g(x):
        return jnp.exp(jax.lax.top_k(jnp.tanh(x), 2)[0])

    def grad(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(f(x).sum(), x)[0]
    port, ref = _edges(f, g, (4, 8))
    assert port == ref == {("tanh", "top_k"): 1.0, ("top_k", "exp"): 1.0}
    port = nsm_of_fn(grad, _x(4, 8))
    ref = jnsm.nsm_of_fn(jax.grad(lambda x: g(x).sum()), jax.ShapeDtypeStruct((4, 8), jnp.float32))
    ops = {op for pair in port for op in pair}
    assert {"top_k", "scatter-add"} <= ops <= {op for pair in ref for op in pair} | {"pad"}


def test_grad_graph_has_more_edges():
    def loss(w, x):
        return torch.tanh(x @ w).sum()

    def grad(w, x):
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(loss(w, x), w)[0]

    def jloss(w, x):
        return jnp.sum(jnp.tanh(x @ w))
    fwd, jfwd = _edges(loss, jloss, (8, 8), (4, 8))
    bwd, jbwd = _edges(grad, jax.grad(jloss), (8, 8), (4, 8))
    assert fwd == jfwd
    assert sum(bwd.values()) > sum(fwd.values())
    assert {op for pair in bwd for op in pair} <= {op for pair in jbwd for op in pair}


def test_featurizer_fixed_dim_and_other_bucket():
    e1 = {("dot", "tanh"): 3.0, ("tanh", "dot"): 2.0}
    e2 = {("conv", "max"): 5.0}
    f = NSMFeaturizer(max_vocab=3).fit([e1, e2])
    want = jnsm.NSMFeaturizer(max_vocab=3).fit([e1, e2])
    assert f.vocab == want.vocab and len(f.vocab) == 3 and f.vocab[-1] == "<other>"
    v1 = f.vector(e1)
    assert v1.shape == (3 * 3 + 6,)
    assert (v1 == want.vector(e1)).all()
    unseen = f.vector({("weird", "op"): 1.0})
    assert unseen.sum() > 0  # lands in <other>


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 5), st.integers(2, 9))
def test_property_depth_scaling(width, depth):
    """Stacking the same block d times scales every edge count by ~d."""
    def block(x):
        return torch.tanh(x * 2.0 + 1.0)

    def deep(x):
        for _ in range(depth):
            x = block(x)
        return x

    e1 = nsm_of_fn(block, _x(width))
    ed = nsm_of_fn(deep, _x(width))
    for pair, n in e1.items():
        assert ed[pair] >= n * depth - depth  # boundary edges differ by <=1/iter


@settings(max_examples=15, deadline=None)
@given(st.integers(2, 6), st.integers(1, 8))
def test_property_loop_linear(length, width):
    def f(x):
        for _ in range(length):
            x = torch.tanh(x) * 1.5
        return x
    e = nsm_of_fn(f, _x(width))
    assert e[("tanh", "mul")] == length
    assert all(v >= 0 and float(v).is_integer() for v in e.values())


# --- the profiled train step ----------------------------------------------------

def _trace(cfg, b=2, s=32):
    model, step, state, batch = tprof.lm_trace(cfg, b, s)
    return tprof.trace_step(step, (state, batch))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
def test_step_nsm_nonempty_and_scales_with_depth(arch):
    base = reduced_config(get_config(arch))
    shallow = _trace(dataclasses.replace(base, num_layers=2))["nsm_edges"]
    deep = _trace(dataclasses.replace(base, num_layers=4))["nsm_edges"]
    assert shallow and ("dot", "reshape") in shallow
    assert all(deep.get(pair, 0.0) >= n for pair, n in shallow.items())
    assert sum(deep.values()) > 1.5 * sum(shallow.values())


def _dot_flops(cfg, b, s):
    """Analytic FLOPs of the forward's matrix products: the layers', the
    unembedding's and the layers' MLP down projections' (plain attention
    computes every (query, key) pair)."""
    t, d, f = b * s, cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    vocab = -(-cfg.vocab_size // 256) * 256
    layer = (2 * t * d * h * hd + 2 * 2 * t * d * kv * hd + 2 * t * h * hd * d
             + 2 * t * d * 2 * f + 2 * t * f * d + 2 * 2 * b * h * s * s * hd)
    return cfg.num_layers * layer, 2 * t * d * vocab, cfg.num_layers * 2 * t * f * d


@pytest.mark.parametrize("remat", ["none", "full"])
def test_step_flops_equal_the_analytic_count(remat):
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-0.5b")), remat=remat)
    layers, head, down = _dot_flops(cfg, 2, 32)
    # forward, then backward's two products per forward product, then the
    # remat recompute of every layer up to the last product whose inputs the
    # backward needs: all but the MLP's down projection (checkpoint stops early)
    want = 3 * (layers + head) + (layers - down if remat == "full" else 0)
    assert _trace(cfg)["flops"] == want


def _one_period(arch):
    """The reference's reduced config, cut to one period of its layer pattern
    where a period holds more than one layer (jamba's 8 hold every kind it
    has): the trace and compile times scale with depth."""
    jcfg = jax_reduced(jax_get_config(arch))
    return dataclasses.replace(jcfg, num_layers=jcfg.period) if jcfg.period > 1 else jcfg


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


def _hlo_products_check(arch):
    """The port's count equals the matrix products of the reference's
    compiled step. SSM layers: the reference's three-operand
    einsum contracts C B^T by the decay as a dot of length 1 (2 FLOP a
    product, forward and both backward products), which the port multiplies
    elementwise. Prints the reference's full HLO count (elementwise ops
    charged one FLOP an element) beside it for PERF.md (run with -s)."""
    b, s = 2, 32
    jcfg = _one_period(arch)
    _, step, state_sds, batch = jprof.lm_trace(jcfg, b, s)
    hlo = jax.jit(step).lower(state_sds, batch).compile().as_text()
    port = _trace(torch_cfg(jcfg), b, s)["flops"]
    want = _DotsOnly(hlo).total().flops
    ssm_layers = sum(jcfg.layer_kind(i)[0] == "ssm" for i in range(jcfg.num_layers))
    q = jcfg.ssm_chunk
    want -= ssm_layers * 3 * 2 * b * (s // q) * q * q * jcfg.ssm_heads
    full = jhlo.analyze_text(hlo).flops
    print(f"reduced {arch} train step {(b, s)}: port FlopCounterMode {port:.0f}, reference HLO "
          f"products {_DotsOnly(hlo).total().flops:.0f}, all ops {full:.0f} "
          f"(ratio all/port {full / port:.3f})")
    assert port == want


def test_step_flops_beside_the_reference_hlo_count():
    _hlo_products_check("qwen2-0.5b")


def test_step_flops_beside_the_reference_hlo_count_mamba2():
    _hlo_products_check("mamba2-370m")


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b", "jamba-v0.1-52b",
                                  "llama-3.2-vision-90b"])
def test_step_flops_beside_the_reference_hlo_count_moe_hybrid_vlm(arch):
    """The MoE dispatch, expert and combine einsums, the hybrid stack and
    the cross-attention: the port's count equals the reference's compiled
    matrix products (jamba's SSM layers as mamba2's)."""
    _hlo_products_check(arch)


def test_step_flops_whisper_equal_the_reference_hlo_count():
    """whisper-tiny's decoder never reads the encoder (its pattern has no
    ``attn_cross`` layer): XLA drops the encoder from the compiled step, and
    the port's step skips it, so the port's count equals the reference's
    compiled matrix products."""
    _hlo_products_check("whisper-tiny")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m", "moonshot-v1-16b-a3b",
                                  "arctic-480b", "jamba-v0.1-52b", "llama-3.2-vision-90b",
                                  "whisper-tiny"])
def test_step_nsm_names_within_the_reference(arch):
    """The operator names of a reduced train step lie within the
    reference's for the same config. mamba2 has two of its own: the chunk
    loop stacks its states (``concatenate``), where the reference's scan
    stacks them with no operator, and autograd differentiates rsqrt as
    ``rsqrt(x) ** 3`` (``integer_pow``), where JAX divides (jamba's
    reference has both elsewhere). The MoE router's sort and its
    gradient's scatter are named ``top_k`` and ``scatter-add``."""
    jcfg = _one_period(arch)
    _, step, state_sds, batch = jprof.lm_trace(jcfg, 2, 32)
    ref = {op for pair in jnsm.nsm_of_fn(step, state_sds, batch) for op in pair}
    port = {op for pair in _trace(torch_cfg(jcfg))["nsm_edges"] for op in pair}
    own = {"concatenate", "integer_pow"} if arch == "mamba2-370m" else set()
    assert port - ref == own
    assert len(port & ref) >= 30


def test_lm_record_field_mapping_matches_jax():
    jcfg = jax_reduced(jax_get_config("qwen2-0.5b"))
    from repro.models import build_model as jax_build
    edges = {("dot", "tanh"): 3.0}
    kw = dict(flops=1.5e9, nsm_edges=edges, lr=2e-3, optimizer="adamw", time_s=0.25,
              mem_bytes=3e9, platform=PLATFORM_TORCH_CUDA)
    want = jprof.lm_record(jcfg, jax_build(jcfg), 4, 128, **kw)
    tcfg = torch_cfg(jcfg)
    model, _, _, _ = tprof.lm_trace(tcfg, 4, 128)
    got = tprof.lm_record(tcfg, model, 4, 128, **kw)
    assert record_to_json(got) == jax_record_to_json(want)
    assert (got.si_vector() == want.si_vector()).all()


def test_measurement_needs_the_card():
    cfg = reduced_config(get_config("qwen2-0.5b"))
    _, step, state, batch = tprof.lm_trace(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tprof.measure_step(step, (state, batch), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tprof.profile_lm(cfg, 1, 8, device="cpu")
