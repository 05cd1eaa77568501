"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU and data crosses as numpy arrays.
"""

import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _pytest.fixtures import FixtureFunctionDefinition

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# fp32 layers hold to 1e-5, bf16 to 2e-2 (the reference kernel tests' value),
# whole models and the engine to 2e-3 (tests/test_kernels.py model level).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Autouse where imported: the module's torch CPU ops run on one thread.
    Under pytest-xdist every worker's intra-op pool wants every core, and
    the pools' spinning threads slow a zoo net's float64 step some
    sixteenfold (shufflenet_v1, six workers on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randn(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def both(x, dtype="float32"):
    """numpy float32 -> (jax array, torch tensor) in ``dtype``; bf16 rounds
    to nearest even in both."""
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(np.array(x)).to(TORCH[dtype])


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol):
    np.testing.assert_allclose(np32(got), np32(want), atol=tol, rtol=tol)


def jax_flat(tree):
    """JAX param tree -> {"a/b/c": float32 numpy}, the input of params_from_jax."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(p.key for p in path): np32(leaf) for path, leaf in leaves}


def port_model(cfg, jax_params):
    """The port's model on the CPU, carrying the JAX package's weights."""
    from repro_torch.models import build_model
    from repro_torch.models.module import params_from_jax
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax_flat(jax_params)))
    return model


def torch_cfg(jax_cfg):
    """The port's ModelConfig with the same field values."""
    import dataclasses
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**dataclasses.asdict(jax_cfg))


# --- the CNN zoo ------------------------------------------------------------

def jax_paths(tree):
    """JAX param tree of lists and dicts -> {"3/0/f/1/g": numpy}, the input
    of ``zoo_params_from_jax``."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def zoo_jax_params(jax_model, seed=0):
    """The reference's parameter tree for ``jax_model`` drawn with numpy in
    float64: kernels normal over sqrt(fan-in), BN scales 1 + 0.1 normal and
    every bias and shift 0.1 normal (non-zero, so that each is exercised)."""
    from repro.models.module import ParamSpec
    spec_tree, _ = jax_model.net.spec(jax_model.cin)
    rng = np.random.default_rng(seed)

    def draw(ps):
        z = rng.standard_normal(ps.shape)
        if ps.init == "ones":
            return 1.0 + 0.1 * z
        if ps.init == "zeros":
            return 0.1 * z
        return z / np.sqrt(np.prod(ps.shape[:-1]))
    return jax.tree.map(draw, spec_tree, is_leaf=lambda a: isinstance(a, ParamSpec))


# Logits and loss of one fp32 forward hold to 1e-4 (2.4e-5 seen, mobilenet_v2).
# Gradients are compared in float64 on both sides, within 1e-9 of the
# largest gradient (9.5e-14 seen, mobilenet_v2): in fp32 the deep BN nets'
# gradients at batch 4 differ by percents of the largest one between the
# packages, as far as JAX's own fp32 gradients are from its float64 ones, so
# fp32 cannot tell a fault from rounding there. convmixer_lite's gradients
# are compared in fp32, within 1e-4 of the largest (8.9e-7 seen): XLA's
# float64 9x9 depthwise convolution on the CPU takes ~50 s.
# The deepest nets' fp32 logits are 4.4e-4 (resnet101) and 1.2e-3
# (resnet152) apart between the packages, the rounding of 100+ BN layers:
# their forward is compared in float64, within 1e-9.
ZOO_FWD_TOL = {"float32": 1e-4, "float64": 1e-9}
ZOO_GRAD_TOL = {"float64": 1e-9, "float32": 1e-4}


def zoo_parity(name, batch=4, image=32, grad_dtype="float64", fwd_dtype="float32"):
    """Hold the port's zoo net ``name`` against the reference's, weights
    carried across: logits and loss in ``fwd_dtype``, gradients in
    ``grad_dtype``."""
    from repro.core import profiler as jprof
    from repro.core import zoo as jzoo
    from repro_torch.core import profiler as tprof
    from repro_torch.core import zoo as tzoo

    jm, tm = jzoo.build_zoo_model(name, image=image), tzoo.build_zoo_model(name, image=image)
    p64 = zoo_jax_params(jm)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((batch, image, image, 3))
    y = rng.integers(0, 10, batch)
    xt, yt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(y)

    def jloss(p, x, y):
        logits = jm.apply(p, x)
        return jprof._softmax_ce(logits, y), logits
    p32 = jax.tree.map(lambda a: a.astype(np.float32), p64)
    wide = fwd_dtype == "float64"
    with jax.enable_x64(wide):
        pf, xf = (p64, x) if wide else (p32, x.astype(np.float32))
        jl, jlogits = jax.jit(jloss)(pf, xf, y)
        jl, jlogits = np.asarray(jl), np.asarray(jlogits)
    dt = torch.float64 if wide else torch.float32
    logits = tm.apply(tzoo.zoo_params_from_jax(tm, jax_paths(pf), dt), xt.to(dt))
    for got, want in ((logits, jlogits), (tprof._softmax_ce(logits, yt), jl)):
        np.testing.assert_allclose(got.detach().double().numpy(), want,
                                   atol=ZOO_FWD_TOL[fwd_dtype], rtol=ZOO_FWD_TOL[fwd_dtype])

    with jax.enable_x64(grad_dtype == "float64"):
        pg = p64 if grad_dtype == "float64" else p32
        xg = x if grad_dtype == "float64" else x.astype(np.float32)
        jg = jax_paths(jax.jit(jax.grad(lambda p, x, y: jloss(p, x, y)[0]))(pg, xg, y))
    dt = torch.float64 if grad_dtype == "float64" else torch.float32
    tp = {k: v.requires_grad_(True)
          for k, v in tzoo.zoo_params_from_jax(tm, jax_paths(pg), dt).items()}
    loss = tprof._softmax_ce(tm.apply(tp, xt.to(dt)), yt)
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    scale = max(np.abs(g).max() for g in jg.values())
    for path, name_ in tm.ref_paths().items():
        want = jg[path].transpose(3, 2, 0, 1) if jg[path].ndim == 4 else jg[path]
        err = np.abs(grads[name_].double().numpy() - want).max() / scale
        assert err <= ZOO_GRAD_TOL[grad_dtype], (name, path, err)


# -- the reference's suites, bound to the port ---------------------------------

SUITES = os.path.dirname(os.path.abspath(__file__))


def port_suite(name: str) -> types.ModuleType:
    """The reference suite ``tests/<name>.py``, bound to the port.

    The suite's source runs as module ``_port_<name>`` with every ``repro.``
    module path read as ``repro_torch.`` (its imports, and the ``module:attr``
    specs it hands to spawned replicas) and every import of another suite
    read as that suite's port binding, so its tests and helpers find the
    port's classes where they find the reference's. Line numbers are the
    source's. ``ProfileRecord`` is rebound to stamp ``PLATFORM_TORCH_CUDA``
    unless a platform is given: the suites' records stand for the port's
    traces, and the port's trace store serves no other platform. The
    reference's files are read, never changed.
    """
    modname = f"_port_{name}"
    if modname in sys.modules:
        return sys.modules[modname]
    path = os.path.join(SUITES, f"{name}.py")
    with open(path) as f:
        src = f.read()
    for dep in sorted(set(re.findall(r"^\s*(?:from|import) (test_\w+)", src, re.M))):
        port_suite(dep)
    src = re.sub(r"\brepro\.(?=[a-z_])", "repro_torch.", src)
    src = re.sub(r"^(\s*)from (test_\w+) import", r"\1from _port_\2 import", src, flags=re.M)
    src = re.sub(r"^(\s*)import (test_\w+)[ \t]*$", r"\1import _port_\2 as \2", src, flags=re.M)
    mod = types.ModuleType(modname)
    mod.__file__ = path
    sys.modules[modname] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    if "ProfileRecord" in vars(mod):
        mod.ProfileRecord = _stamped(mod.ProfileRecord)
    return mod


def _stamped(record_cls):
    from repro_torch.core.features import PLATFORM_TORCH_CUDA

    def make(*args, **kwargs):
        kwargs.setdefault("platform", PLATFORM_TORCH_CUDA)
        return record_cls(*args, **kwargs)
    return make


def suite_tests(*mods: types.ModuleType) -> dict:
    """The tests and fixtures of the bound suites, to be collected where
    they are bound (``globals().update(suite_tests(...))``)."""
    out = {}
    for mod in mods:
        for name, obj in vars(mod).items():
            if (name.startswith("test_") and callable(obj)) or isinstance(
                    obj, FixtureFunctionDefinition):
                out[name] = obj
    return out
