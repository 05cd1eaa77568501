"""Port parity: repro_torch DecodeEngine vs the JAX reference engine."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import port_model, torch_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve.engine import DecodeEngine as JaxEngine  # noqa: E402
from repro_torch.serve.engine import DecodeEngine  # noqa: E402

B, S, STEPS = 2, 16, 4


@pytest.fixture(scope="module")
def setup():
    cfg = jax_reduced(jax_get_config("qwen2-0.5b"))
    jm = jax_build(cfg)
    params = jm.init(jax.random.key(1))
    # the engines decode against a cache sized by prefill; pad inputs (as
    # tests/test_serving.py does)
    tokens = np.pad(np.arange(B * S, dtype=np.int32).reshape(B, S) % 50,
                    ((0, 0), (0, STEPS + 1)))
    return cfg, jm, params, port_model(torch_cfg(cfg), params), tokens


def test_generate_matches_jax_tokens(setup):
    cfg, jm, params, tm, tokens = setup
    jeng = JaxEngine(jm, params, batch=B, max_seq=S + STEPS + 1)
    want = np.asarray(jeng.generate(jeng.prefill({"tokens": jnp.asarray(tokens)}), STEPS))
    eng = DecodeEngine(tm, batch=B, max_seq=S + STEPS + 1)
    got = eng.generate(eng.prefill({"tokens": torch.from_numpy(tokens)}), STEPS)
    assert got.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_keeps_reference_cache_semantics(setup):
    """prefill swaps in a prompt-sized cache; decode positions run past it."""
    cfg, _, _, tm, tokens = setup
    eng = DecodeEngine(tm, batch=B, max_seq=64)
    assert eng.cache[0]["k"].shape[1] == 64
    first = eng.prefill({"tokens": torch.from_numpy(tokens)})
    assert eng.cache[0]["k"].shape[1] == tokens.shape[1]
    before = [c["k"].clone() for c in eng.cache]
    out = eng.generate(first, STEPS)
    assert eng.pos.tolist() == [tokens.shape[1] + STEPS] * B
    assert all(torch.equal(b, c["k"]) for b, c in zip(before, eng.cache))
    again = DecodeEngine(tm, batch=B, max_seq=64)
    assert torch.equal(again.generate(again.prefill({"tokens": torch.from_numpy(tokens)}),
                                      STEPS), out)
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
