"""Port parity: the RMSNorm op, its plain version and ``apply_norm``'s impl
switch against the JAX reference.

On the CPU ``repro_torch.kernels.ops.rmsnorm`` takes the plain version
``rmsnorm_ref`` under autograd; both are held against the reference's
Pallas kernel in interpret mode (``repro.kernels.ops.rmsnorm``) and its
oracle ``ref.rmsnorm_ref`` at the reference's tolerances, 1e-5 (fp32) and
2e-2 (bf16), and so is the gradient: dx at the same tolerances, dgain (an
fp32 sum over rows) within 1e-4 of its largest entry. The CUDA kernels
themselves run only on the card (``tests/test_torch_cuda_kernel.py``,
``chip_smoke.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import TOL, both, close, np32, randn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.api import use_impls  # noqa: E402

# the reference's sweep (tests/test_kernels.py), then ragged rows and leading dims
SHAPES = [(64, 128), (256, 64), (32, 512), (7, 896), (3, 5, 64), (2, 37, 1024)]
DGAIN_TOL = 1e-4


def _gain(d):
    return (1 + 0.1 * randn(21, (d,))).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas_interpret(shape, dtype):
    xj, xt = both(randn(20, shape), dtype)
    g = _gain(shape[-1])
    want = jops.rmsnorm(xj, jnp.asarray(g), interpret=True)
    got = tops.rmsnorm(xt, torch.from_numpy(g))
    assert got.shape == shape and got.dtype == xt.dtype
    close(got, want, TOL[dtype])
    close(tref.rmsnorm_ref(xt, torch.from_numpy(g)), jref.rmsnorm_ref(xj, jnp.asarray(g)),
          TOL[dtype])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_gradient_matches_jax(shape, dtype):
    xj, xt = both(randn(22, shape), dtype)
    dyj, dyt = both(randn(23, shape), dtype)
    g = _gain(shape[-1])

    def jloss(x, gain):
        return jnp.sum(jref.rmsnorm_ref(x, gain).astype(jnp.float32) * dyj.astype(jnp.float32))
    want_dx, want_dg = jax.grad(jloss, argnums=(0, 1))(xj, jnp.asarray(g))

    xt.requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    tops.rmsnorm(xt, gt).backward(dyt)
    assert xt.grad.dtype == xt.dtype and gt.grad.dtype == torch.float32
    close(xt.grad, want_dx, TOL[dtype])
    scale = float(np.abs(np32(want_dg)).max())
    np.testing.assert_allclose(np32(gt.grad), np32(want_dg), atol=DGAIN_TOL * scale, rtol=0)


@pytest.mark.parametrize("impl", [None, "plain"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm_under_each_impl(impl, kind, dtype):
    xj, xt = both(randn(24, (2, 9, 64)), dtype)
    p = {"scale": _gain(64)}
    if kind == "layernorm":
        p["bias"] = randn(25, (64,), 0.1)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, xj)
    with use_impls(norm=impl):
        assert TL.get_norm_impl() == impl
        got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, xt)
    close(got, want, TOL[dtype])


def test_norm_impl_cuda_on_cpu_raises_and_layernorm_stays_plain():
    x = torch.zeros(2, 64)
    with use_impls(norm="cuda"):
        with pytest.raises(ValueError, match="card only"):
            TL.apply_norm({"scale": torch.ones(64)}, x)
        y = TL.apply_norm({"scale": torch.ones(64), "bias": torch.zeros(64)}, x)
    assert torch.equal(y, x) and TL.get_norm_impl() is None
    with pytest.raises(ValueError, match="norm impl"):
        TL.set_norm_impl("pallas")


def test_use_impls_restores_every_switch():
    from repro_torch.models import attention, ssm
    attention.set_attention_impl("plain")
    try:
        with use_impls(ssd="plain", norm="plain"):
            assert (attention.get_attention_impl(), ssm.get_ssd_impl(), TL.get_norm_impl()) == \
                ("plain", "plain", "plain")
            with pytest.raises(RuntimeError):
                with use_impls(attention=None):
                    assert attention.get_attention_impl() is None
                    raise RuntimeError("inside")
            assert attention.get_attention_impl() == "plain"
        assert (ssm.get_ssd_impl(), TL.get_norm_impl()) == (None, None)
    finally:
        attention.set_attention_impl(None)
