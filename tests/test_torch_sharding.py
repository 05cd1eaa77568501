"""The port's sharding resolution (repro_torch.distributed.sharding, .zero)
against the reference's.

- The cases of ``tests/test_sharding.py`` run against both packages through
  the ``pkg`` fixture (the HLO analyzer's cases are ported in
  ``tests/test_torch_dryrun.py``).
- All ten archs at full size, on the 16x16 and 2x16x16 meshes (duck-typed:
  axis names and shape), under all four schemes, with ZeRO on and off (and
  the giant archs' FSDP parameters): the port's ``state_shardings`` gives
  each parameter and moment the spec that the reference's functions
  (``resolve_spec`` after ``fsdp_axes`` / ``zero_axes``) give the same leaf,
  and, for every leaf whose stacked layer dim the reference leaves
  unsharded, the reference's own ``state_shardings`` spec minus that dim;
  ``make_sharder`` gives every activation the reference's spec.
- ``placements`` and ``distribute`` on a (2, 2) mesh of a fake world (a
  child process), and a dim split over mesh axes out of the mesh's order
  raises.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _hypo import given, settings, st  # noqa: E402
from _torch_dist import run_world  # noqa: E402
from _torch_parity import torch_cfg  # noqa: E402
import repro.distributed.sharding as jshd  # noqa: E402
import repro.distributed.zero as jzero  # noqa: E402
import repro.train.step as jstep  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
import repro_torch.distributed.sharding as tshd  # noqa: E402
import repro_torch.distributed.zero as tzero  # noqa: E402
from repro_torch.launch.dryrun import FSDP_PARAMS, NO_MASTER  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.module import port_names  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402


class FakeMesh:
    """Duck-typed mesh: axis names + shape only (resolve_spec needs those)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESH = FakeMesh((16, 16), ("data", "model"))
MESH3 = FakeMesh((2, 16, 16), ("pod", "data", "model"))
NORM_TOL = 1e-6


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    shd, zero = (jshd, jzero) if request.param == "jax" else (tshd, tzero)
    return types.SimpleNamespace(ShardingRules=shd.ShardingRules, resolve_spec=shd.resolve_spec,
                                 DEFAULT_RULES=shd.DEFAULT_RULES, zero=zero,
                                 STRICT=shd.ShardingRules())


# -- the reference's cases, on both packages ----------------------------------


def test_divisible_dims_shard(pkg):
    spec = pkg.resolve_spec(("embed", "mlp"), (1024, 4096), MESH, pkg.STRICT)
    assert tuple(spec) == (None, "model")


def test_non_divisible_falls_back(pkg):
    spec = pkg.resolve_spec(("batch", "seq", "heads", "head_dim"),
                            (32, 64, 14, 64), MESH, pkg.STRICT)
    assert tuple(spec) == ("data",)


def test_pad_tolerance_admits_40_heads(pkg):
    rules = pkg.ShardingRules(pad_tolerance=4 / 3)
    spec = pkg.resolve_spec(("batch", "seq", "heads", "head_dim"), (256, 64, 40, 64), MESH, rules)
    assert tuple(spec) == ("data", None, "model")
    spec = pkg.resolve_spec(("batch", "seq", "kv_heads", "head_dim"), (256, 64, 2, 64), MESH, rules)
    assert tuple(spec) == ("data",)


def test_axis_used_once_first_wins(pkg):
    spec = pkg.resolve_spec(("experts", "embed", None, "mlp"), (64, 1024, 2, 4096), MESH,
                            pkg.STRICT)
    assert tuple(spec) == ("model",)


def test_pod_axis_only_on_multipod(pkg):
    assert tuple(pkg.resolve_spec(("batch", "seq"), (256, 64), MESH, pkg.STRICT)) == ("data",)
    assert tuple(pkg.resolve_spec(("batch", "seq"), (256, 64), MESH3, pkg.STRICT)) == \
        (("pod", "data"),)


def test_batch_of_one_replicates(pkg):
    assert tuple(pkg.resolve_spec(("batch", "seq"), (1, 2048), MESH, pkg.STRICT)) == ()


def test_zero_axes_add_data_shard(pkg):
    axes = {"w": (None, "embed", "mlp")}
    shapes = {"w": jax.ShapeDtypeStruct((4, 1024, 4096), jnp.float32)}
    out = pkg.zero.zero_axes(axes, shapes, MESH, pkg.STRICT)
    assert out["w"] == (None, "zero", "mlp")
    spec = pkg.resolve_spec(out["w"], (4, 1024, 4096), MESH, pkg.zero.zero_rules(pkg.STRICT))
    assert tuple(spec) == (None, "data", "model")


def test_zero_skips_indivisible(pkg):
    out = pkg.zero.zero_axes({"w": (None, None)},
                             {"w": jax.ShapeDtypeStruct((3, 7), jnp.float32)}, MESH, pkg.STRICT)
    assert out["w"] == (None, None)


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_property_resolve_never_uneven(which):
    shd = jshd if which == "jax" else tshd

    @settings(max_examples=30, deadline=None)
    @given(st.integers(1, 4096), st.integers(1, 4096))
    def check(d0, d1):
        spec = shd.resolve_spec(("mlp", "vocab"), (d0, d1), MESH, shd.ShardingRules())
        sizes = {"data": 16, "model": 16}
        for dim, s in zip((d0, d1), tuple(spec) + (None,) * 2):
            if s is not None:
                n = sizes[s] if isinstance(s, str) else int(np.prod([sizes[a] for a in s]))
                assert dim % n == 0
    check()


# -- all ten archs, against the reference ---------------------------------------


class _Spec:
    """Stands in for the reference's NamedSharding (which needs real devices)."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


def _nested_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_nested_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _stacked(key):
    return key.split("/")[0] in ("layers", "encoder")


def _reference_on_leaves(axes, shapes, mesh, scheme, zero, fsdp):
    """The reference's state_shardings composition on the given (unstacked)
    leaves: {key: (param spec, moment spec)}."""
    rules = jshd.scheme_rules(scheme, jshd.ShardingRules())
    if scheme == "dp":
        axes = jshd.fsdp_axes(axes, shapes, mesh)
    if fsdp:
        axes = jzero.zero_axes(axes, shapes, mesh, rules)
        rules = jzero.zero_rules(rules)
    zaxes = jzero.zero_axes(axes, shapes, mesh, rules) if zero else axes
    zrules = jzero.zero_rules(rules) if zero else rules
    return {k: (tuple(jshd.resolve_spec(axes[k], shapes[k].shape, mesh, rules)),
                tuple(jshd.resolve_spec(zaxes[k], shapes[k].shape, mesh, zrules)))
            for k in axes}


@pytest.mark.parametrize("arch", list_archs())
def test_state_shardings_equal_the_reference_for_every_arch(arch, monkeypatch):
    monkeypatch.setattr(jshd, "NamedSharding", _Spec)
    monkeypatch.setattr(jstep, "NamedSharding", _Spec)
    jcfg = jax_get_config(arch)
    tcfg = torch_cfg(jcfg)
    jm = jax_build(jcfg)
    tm = build_model(tcfg, device="meta")
    jaxes, jshapes = _nested_flat(jm.param_axes()), _nested_flat(jm.init_shape())
    # the reference's leaves without the stacked layer dim: the port's leaves
    uaxes = {k: a[1:] if _stacked(k) else a for k, a in jaxes.items()}
    ushapes = {k: jax.ShapeDtypeStruct(s.shape[1:] if _stacked(k) else s.shape, s.dtype)
               for k, s in jshapes.items()}
    assert {n for k in jaxes for n in port_names(k, tcfg)} == set(tm.param_axes())
    fsdp = arch in FSDP_PARAMS
    layer_split = 0
    for mesh in (MESH, MESH3):
        for scheme in tshd.SCHEMES:
            for zero in (True, False):
                opt_j = jopt.OptConfig(keep_master=arch not in NO_MASTER)
                opt_t = topt.OptConfig(keep_master=arch not in NO_MASTER)
                mine = tstep.state_shardings(tm, opt_t, mesh, scheme=scheme, zero=zero,
                                             fsdp_params=fsdp)
                want = _reference_on_leaves(uaxes, ushapes, mesh, scheme, zero, fsdp)
                ref = jstep.state_shardings(jm, opt_j, mesh, scheme=scheme, zero=zero,
                                            fsdp_params=fsdp)
                rp, rm = _nested_flat(ref["params"]), _nested_flat(ref["opt"]["m"])
                assert bool(ref["opt"]["master"]) == bool(mine["opt"]["master"])
                for key in jaxes:
                    for name in port_names(key, tcfg):
                        got = (tuple(mine["params"][name].spec),
                               tuple(mine["opt"]["m"][name].spec))
                        assert got == want[key], (arch, scheme, zero, name)
                        assert tuple(mine["opt"]["v"][name].spec) == got[1]
                        for g, r in zip(got, (rp[key].spec, rm[key].spec)):
                            if _stacked(key) and r and r[0] is not None:
                                layer_split += 1  # the reference splits the layer dim
                            else:
                                assert g == (r[1:] if _stacked(key) else r), (key, name)
    # the reference splits a stacked layer dim only where the period count
    # divides an axis (24-layer qwen2-0.5b: never)
    if arch == "qwen2-0.5b":
        assert layer_split == 0


def _act_shapes(cfg):
    b, s = 256, 4096
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    e = max(cfg.num_experts, 1)
    return {"acts": (b, s, cfg.d_model), "acts_qkv": (b, s, h, hd), "acts_kv": (b, s, kv, hd),
            "acts_kv_repl": (b, s, h, hd), "moe_disp": (512, 2048, e, 64),
            "moe_xe": (512, e, 64, cfg.d_model), "decode_scores": (128, h, 1, 32768),
            "decode_scores5": (128, kv, h // max(kv, 1), 1, 32768),
            "logits": (b, s, cfg.vocab_size), "unknown": (b, s)}


@pytest.mark.parametrize("arch", list_archs())
def test_make_sharder_equals_the_reference(arch, monkeypatch):
    monkeypatch.setattr(jshd, "NamedSharding", _Spec)
    cfg = jax_get_config(arch)
    for mesh in (MESH, MESH3):
        for scheme in tshd.SCHEMES:
            js, ts = jshd.make_sharder(mesh, None, scheme), tshd.make_sharder(mesh, None, scheme)
            for name, shape in _act_shapes(cfg).items():
                r, m = js(name, shape), ts(name, shape)
                assert (r is None) == (m is None), (name, scheme)
                if r is not None:
                    assert tuple(m.spec) == r.spec, (arch, name, scheme)
    assert jshd.make_sharder(None) is None and tshd.make_sharder(None) is None


# -- DTensor placements -------------------------------------------------------------


def test_placements_give_the_local_shapes_on_a_fake_world(tmp_path):
    out = run_world("placements_local_shapes", 4, tmp_path, fake=True)
    assert out["dm"] == {"placements": ["S(0)", "S(1)"], "local": [4, 3], "global": [8, 6]}
    assert out["md"] == {"placements": ["S(1)", "S(0)"], "local": [4, 3], "global": [8, 6]}
    # ("data", "model") on one dim: split over both, data major
    assert out["both"] == {"placements": ["S(0)", "S(0)"], "local": [2, 6], "global": [8, 6]}
    assert out["none"] == {"placements": ["R", "R"], "local": [8, 6], "global": [8, 6]}
    assert out["col"] == {"placements": ["R", "S(1)"], "local": [8, 3], "global": [8, 6]}


def test_axes_out_of_the_mesh_order_raise():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    from torch.distributed.tensor import Replicate, Shard
    assert tshd.placements(tshd.P(("pod", "data"), "model"), mesh) == (Shard(0), Shard(0),
                                                                        Shard(1))
    assert tshd.placements(tshd.P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's dim order"):
        tshd.placements(tshd.P(("data", "pod")), mesh)


def test_rmsnorm_kernel_runs_on_each_ranks_rows_with_the_gain_gradient_summed(tmp_path):
    """A gloo world of 4: rows stay split when even (8) and uneven (7), and
    are made whole with a warning where a rank would hold none (3); the
    output and both gradients equal plain RMSNorm's within ``NORM_TOL`` =
    1e-6 (the gain's gradient is each rank's part, summed)."""
    out = run_world("rmsnorm_rows", 4, tmp_path)
    for n, split in (("8", True), ("7", True), ("3", False)):
        r = out[n]
        assert r["placements"] == (["S(0)", "R"] if split else ["R", "R"]), (n, r)
        assert r["warned"] == (0 if split else 1), (n, r)
        assert max(r["y"], r["dx"], r["dgain"]) <= NORM_TOL, (n, r)
    assert out["refused"] is True


def test_rmsnorm_layout_is_the_same_through_the_kernel_and_plain(tmp_path):
    """A gloo world of (2, 2): RMSNorm of x split over rows and features
    leaves the same layout through the kernels' wrapper as through the plain
    path: a decode step's one token keeps its feature split (the projections
    contract their share of it), a prefill's four tokens make the features
    whole; the output and x's gradient equal plain RMSNorm's within
    ``NORM_TOL``."""
    out = run_world("norm_layouts", 4, tmp_path)
    for s, want in (("1", ["S(0)", "S(2)"]), ("4", ["S(0)", "R"])):
        for path in ("plain", "kernel"):
            r = out[f"{s} {path}"]
            assert r["placements"] == want, (s, path, r)
            assert max(r["y"], r["dx"]) <= NORM_TOL, (s, path, r)
