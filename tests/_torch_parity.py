"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU and data crosses as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# fp32 layers hold to 1e-5, bf16 to 2e-2 (the reference kernel tests' value),
# whole models and the engine to 2e-3 (tests/test_kernels.py model level).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_TOL = 2e-3


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
