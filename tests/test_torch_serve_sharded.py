"""The port's sharded serve path on a CPU world of four gloo processes.

A (2, 2) ``("data", "model")`` mesh under "sp", the scheme of every serve
cell of the dry run; the reduced config in fp32, its weights drawn by the
JAX package's ``init`` and carried across (``params_from_jax``); the
parameters laid out by ``engine.param_shardings`` (arctic-480b's FSDP-split
over "data" too, as the dry run serves it), a prefill of ``BATCH`` = 4
prompts of ``SEQ`` = 8 tokens through ``make_prefill_step``, its cache grown
by ``STEPS`` = 2 slots and laid out by ``cache_shardings``, then two decode
steps of the next tokens through ``make_decode_step``
(``_torch_dist.sharded_serve``). Each step's logits are held to the
unsharded port's within ``LOGIT_TOL`` = 1e-5 (the ranks sum in another
order) and to the reference's ``prefill`` and ``decode_step`` within
``MODEL_TOL`` = 2e-3, the model tests' tolerance.

In the MoE archs one group spans the two "data" ranks, in prefill (32
tokens, 16 a rank) and in decode (4 tokens, 2 a rank): each rank routes
its own tokens and only the top-k choices are gathered
(``models.moe._spanning``); the worker counts the MoE layer calls that take
that path. whisper-tiny's untied embedding leaves its output split over
d_model, which its LayerNorm makes whole first. moonshot-v1-16b-a3b is
tier-1 (~20 s); whisper-tiny and arctic-480b (whose experts keep their
d_model split over "data" for compute) are ``slow``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_dist import grown_cache, run_world, serve_inputs  # noqa: E402
from _torch_parity import MODEL_TOL, jax_flat, port_model, torch_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402

LOGIT_TOL = 1e-5
BATCH, SEQ, STEPS = 4, 8, 2


def _unsharded_and_reference(cfg, jm, params):
    """Each step's logits from the port's unsharded model and from the
    reference, on ``serve_inputs``."""
    inputs = serve_inputs(cfg, BATCH, SEQ, STEPS)
    tokens = inputs.pop("tokens")
    tm = port_model(torch_cfg(cfg), params)
    mine, ref = [], []
    with torch.no_grad():
        logits, cache = tm.prefill({**{k: torch.from_numpy(v) for k, v in inputs.items()},
                                    "tokens": torch.from_numpy(tokens[:, :SEQ])})
        mine.append(logits)
        cache = grown_cache(cache, SEQ, STEPS,
                            lambda a, n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, n)))
        for n in range(STEPS):
            nxt = torch.from_numpy(tokens[:, SEQ + n:SEQ + n + 1])
            logits, cache = tm.decode_step(cache, nxt,
                                           torch.full((BATCH,), SEQ + n, dtype=torch.int32))
            mine.append(logits)
    logits, jcache = jm.prefill(params, {**{k: jnp.asarray(v) for k, v in inputs.items()},
                                         "tokens": jnp.asarray(tokens[:, :SEQ])})
    ref.append(logits)

    def grow(path, a):  # the reference stacks a layer's cache over periods: (P, B, S, ..)
        name = getattr(path[-1], "key", None)
        return jnp.pad(a, [(0, 0), (0, 0), (0, STEPS)] + [(0, 0)] * (a.ndim - 3)) \
            if name in ("k", "v") and a.shape[2] == SEQ else a
    jcache = jax.tree_util.tree_map_with_path(grow, jcache)
    for n in range(STEPS):
        nxt = jnp.asarray(tokens[:, SEQ + n:SEQ + n + 1])
        logits, jcache = jm.decode_step(params, jcache, nxt, jnp.full((BATCH,), SEQ + n, jnp.int32))
        ref.append(logits)
    return [t.numpy() for t in mine], [np.asarray(t) for t in ref]


@pytest.mark.parametrize("arch", [
    "moonshot-v1-16b-a3b",
    pytest.param("whisper-tiny", marks=pytest.mark.slow),
    pytest.param("arctic-480b", marks=pytest.mark.slow),
])
def test_sharded_serve_equals_the_unsharded_and_reference(arch, tmp_path):
    cfg = jax_reduced(jax_get_config(arch))
    jm = jax_build(cfg)
    params = jm.init(jax.random.key(0))
    npz = str(tmp_path / "weights.npz")
    np.savez(npz, **{k.replace("/", "|"): v for k, v in jax_flat(params).items()})
    mine, ref = _unsharded_and_reference(cfg, jm, params)
    out = run_world("sharded_serve", 4, tmp_path, timeout=180, arch=arch, npz=npz, batch=BATCH,
                    seq=SEQ, steps=STEPS, data=2, model_par=2)
    got = [np.asarray(t, np.float32) for t in out["logits"]]
    assert len(got) == len(mine) == len(ref) == 1 + STEPS
    for i, (g, m, r) in enumerate(zip(got, mine, ref)):
        np.testing.assert_allclose(g, m, rtol=LOGIT_TOL, atol=LOGIT_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(g, r, rtol=MODEL_TOL, atol=MODEL_TOL, err_msg=f"step {i}")
    moe_layers = sum(mlp.startswith("moe") for _, mlp in cfg.pattern()) * cfg.num_periods
    assert out["spanning"] == moe_layers * (1 + STEPS), out["spanning"]
