"""The port's int8 error-feedback compression (repro_torch.distributed
.compression) against the reference's.

- The reference's three tests (``tests/test_compression.py``) on both
  packages through the ``pkg`` fixture, on the same numpy-seeded gradients;
  the single-device all-reduce runs in a one-rank gloo world for the port
  (a child process) and under ``shard_map`` for the reference.
- ``ef_compress`` equals the reference's bit for bit: payloads, scales and
  residuals (``torch.round`` and ``jnp.round`` both round half to even).
- ``allreduce_compressed`` over a gloo world of four CPU processes equals
  the mean computed here from each rank's payload and scale, within
  ``ALLREDUCE_RTOL`` = 1e-6 relative (gloo sums the scales in its own order).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_dist import run_world  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402

ALLREDUCE_RTOL = 1e-6


def _normal(seed, shape, scale):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    if request.param == "jax":
        return types.SimpleNamespace(comp=jcomp, arr=jnp.asarray,
                                     norm=lambda x: float(jnp.linalg.norm(x)),
                                     zeros=jnp.zeros_like, int8=jnp.int8)
    return types.SimpleNamespace(comp=tcomp, arr=torch.from_numpy,
                                 norm=lambda x: float(torch.linalg.norm(x)),
                                 zeros=torch.zeros_like, int8=torch.int8)


def test_quantize_roundtrip_small_error(pkg):
    g = {"w": pkg.arr(_normal(0, (64, 64), 0.1))}
    ef = pkg.comp.ef_init(g)
    comp, ef = pkg.comp.ef_compress(g, ef)
    out = pkg.comp.ef_decompress(comp)
    assert pkg.norm(out["w"] - g["w"]) / pkg.norm(g["w"]) < 0.02
    assert comp.q["w"].dtype == pkg.int8


def test_error_feedback_accumulates_to_truth(pkg):
    g = {"w": pkg.arr(_normal(1, (32,), 0.05))}
    ef = pkg.comp.ef_init(g)
    acc = pkg.zeros(g["w"])
    n = 20
    for _ in range(n):
        comp, ef = pkg.comp.ef_compress(g, ef)
        acc = acc + pkg.comp.ef_decompress(comp)["w"]
    assert pkg.norm(acc / n - g["w"]) / pkg.norm(g["w"]) < 5e-3


def test_allreduce_compressed_single_device(pkg, tmp_path):
    g = _normal(2, (16, 16), 0.1)
    if pkg.comp is jcomp:
        mesh = make_host_mesh(1, 1)
        gj = {"w": jnp.asarray(g)}

        def f(g, ef):
            return jcomp.allreduce_compressed(g, ef, "data")
        out, _ = jax.jit(jcomp.shard_map(f, mesh=mesh, in_specs=(P(), P()),
                                         out_specs=(P(), P())))(gj, jcomp.ef_init(gj))
        out = np.asarray(out["w"])
    else:
        out = np.asarray(run_world("compressed_allreduce", 1, tmp_path, seed=2)["w"])
    assert np.linalg.norm(out - g) / np.linalg.norm(g) < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_compress_equals_the_reference_bit_for_bit(dtype):
    grads = {"a": _normal(3, (64, 32), 0.1), "b": _normal(4, (7,), 3.0),
             "c": np.zeros((5,), np.float32)}
    ef = {"a": _normal(5, (64, 32), 1e-3), "b": _normal(6, (7,), 1e-2),
          "c": np.zeros((5,), np.float32)}
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                        torch.float32)
    jc, je = jcomp.ef_compress({k: jnp.asarray(v, jd) for k, v in grads.items()},
                               {k: jnp.asarray(v) for k, v in ef.items()})
    tc, te = tcomp.ef_compress({k: torch.from_numpy(v).to(td) for k, v in grads.items()},
                               {k: torch.from_numpy(v) for k, v in ef.items()})
    for k in grads:
        assert np.array_equal(np.asarray(jc.q[k]), tc.q[k].numpy()), k
        assert np.asarray(jc.scale[k]).tobytes() == tc.scale[k].numpy().tobytes(), k
        assert np.asarray(je[k]).tobytes() == te[k].numpy().tobytes(), k
        assert np.asarray(jcomp.ef_decompress(jc)[k]).tobytes() == \
            tcomp.ef_decompress(tc)[k].numpy().tobytes()


def test_allreduce_compressed_over_four_ranks_is_the_mean_of_the_payloads(tmp_path):
    world, seed = 4, 10
    out = run_world("compressed_allreduce", world, tmp_path, seed=seed)
    for k, shape, off in (("w", (16, 8), 0), ("b", (8,), 100)):
        qs, scales = [], []
        for r in range(world):
            g = {k: torch.from_numpy(_normal(seed + off + r, shape, 0.1))}
            comp, _ = tcomp.ef_compress(g, tcomp.ef_init(g))
            qs.append(comp.q[k].to(torch.int32))
            scales.append(comp.scale[k])
        want = (sum(qs).float() * (sum(scales) / world) / world).numpy()
        np.testing.assert_allclose(np.asarray(out[k], np.float32), want,
                                   rtol=ALLREDUCE_RTOL, atol=0)
