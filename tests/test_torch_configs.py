"""Port parity of the dense configs the port builds beyond qwen2-0.5b:
chatglm3-6b (QKV bias, "2d" partial RoPE, 16:1 grouped KV), phi4-mini-3.8b
(tied embeddings) and qwen2.5-32b (QKV bias), each reduced and held against
the JAX reference with its weights carried across by ``params_from_jax``;
the registry of all ten archs, and full-width parameter counts, total and
active, against the reference's (the MoE, hybrid, VLM and audio archs'
models are held in tests/test_torch_hybrid.py)."""

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


# the reference's counts (repro.models.api.build_model(cfg).param_count(),
# total and active_only=True)
FULL_COUNTS = {
    "moonshot-v1-16b-a3b": (28_057_995_264, 3_974_301_696),
    "arctic-480b": (476_850_275_328, 15_584_314_368),
    "jamba-v0.1-52b": (51_460_000_640, 11_999_988_608),
    "llama-3.2-vision-90b": (87_666_794_516, 87_666_794_516),
    "whisper-tiny": (58_799_616, 58_799_616),
}


def test_registry_lists_all_ten_archs():
    from repro.configs import list_archs as jax_list_archs
    assert list_archs() == jax_list_archs() and len(list_archs()) == 10
    for arch in list_archs():
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", list(FULL_COUNTS))
def test_full_config_param_counts_match_the_reference(arch):
    total, active = FULL_COUNTS[arch]
    model = build_model(get_config(arch), device="meta")
    assert model.param_count() == total
    assert model.param_count(active_only=True) == active
    jm = jax_build(jax_get_config(arch))
    assert (jm.param_count(), jm.param_count(active_only=True)) == (total, active)
    cfg = get_config(arch)
    assert (cfg.param_count(), cfg.active_param_count()) == (total, active)


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
    for arch in list_archs():
        assert (dataclasses.asdict(reduced_config(get_config(arch)))
                == dataclasses.asdict(jax_reduced(jax_get_config(arch))))
