"""Port parity of the dense configs the port builds beyond qwen2-0.5b:
chatglm3-6b (QKV bias, "2d" partial RoPE, 16:1 grouped KV), phi4-mini-3.8b
(tied embeddings) and qwen2.5-32b (QKV bias), each reduced and held against
the JAX reference with its weights carried across by ``params_from_jax``;
full-width parameter counts against the reference's."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import MODEL_TOL, close, port_model, torch_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCHS = ["chatglm3-6b", "phi4-mini-3.8b", "qwen2.5-32b"]
B, S = 2, 24


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = jax_reduced(jax_get_config(request.param))
    jm = jax_build(cfg)
    params = jm.init(jax.random.key(0))
    return cfg, jm, params, port_model(torch_cfg(cfg), params)


def _tokens(vocab, s=S):
    t = (np.arange(B * s, dtype=np.int32).reshape(B, s) * 7) % (vocab - 1)
    return jnp.asarray(t), torch.from_numpy(t)


def test_registry_lists_the_dense_configs():
    assert set(ARCHS) <= set(list_archs())
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))


def test_forward_and_loss_match_jax(pair):
    cfg, jm, params, tm = pair
    tj, tt = _tokens(cfg.vocab_size)
    want, _ = jm.forward(params, {"tokens": tj})
    with torch.no_grad():
        got, _ = tm.forward({"tokens": tt})
    close(got, want, MODEL_TOL)
    want_loss, _ = jm.loss(params, {"tokens": tj, "labels": (tj + 1) % cfg.vocab_size})
    got_loss, _ = tm.loss({"tokens": tt, "labels": (tt + 1) % cfg.vocab_size})
    close(got_loss, want_loss, MODEL_TOL)


def test_prefill_and_decode_match_jax(pair):
    cfg, jm, params, tm = pair
    tj, tt = _tokens(cfg.vocab_size)
    want, jcache = jm.prefill(params, {"tokens": tj})
    with torch.no_grad():
        got, tcache = tm.prefill({"tokens": tt})
    close(got, want, MODEL_TOL)

    def grow(a):
        return jnp.pad(a, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])
    jgrown = jax.tree.map(grow, jcache)
    tgrown = [{n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1)) for n, a in c.items()}
              for c in tcache]
    nxt = np.full((B, 1), 3, np.int32)
    pos = np.full((B,), S, np.int32)
    want, _ = jm.decode_step(params, jgrown, jnp.asarray(nxt), jnp.asarray(pos))
    with torch.no_grad():
        got, _ = tm.decode_step(tgrown, torch.from_numpy(nxt), torch.from_numpy(pos))
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count(arch):
    want = jax_build(jax_get_config(arch)).param_count()
    cfg = get_config(arch)
    assert build_model(cfg, device="meta").param_count() == want
    assert cfg.param_count() == want
    assert cfg.active_param_count() == want


def test_reduced_configs_agree():
    for arch in ARCHS:
        assert (dataclasses.asdict(reduced_config(get_config(arch)))
                == dataclasses.asdict(jax_reduced(jax_get_config(arch))))
