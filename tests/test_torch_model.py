"""Port parity: repro_torch StackModel (reduced qwen2-0.5b) vs the JAX reference,
with the JAX weights carried across by ``params_from_jax``."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import MODEL_TOL, TOL, close, port_model, torch_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.module import flatten  # noqa: E402

B, S = 2, 24


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    cfg = jax_reduced(jax_get_config("qwen2-0.5b"), dtype=request.param)
    jm = jax_build(cfg)
    params = jm.init(jax.random.key(0))
    tcfg = torch_cfg(cfg)
    return request.param, cfg, jm, params, tcfg, port_model(tcfg, params)


def _tokens(vocab, s=S):
    t = (np.arange(B * s, dtype=np.int32).reshape(B, s) * 7) % (vocab - 1)
    return jnp.asarray(t), torch.from_numpy(t)


def _tol(dtype):
    return MODEL_TOL if dtype == "float32" else TOL["bfloat16"]


def test_forward_matches_jax(pair):
    dtype, cfg, jm, params, _, tm = pair
    tj, tt = _tokens(cfg.vocab_size)
    want, _ = jm.forward(params, {"tokens": tj})
    with torch.no_grad():
        got, aux = tm.forward({"tokens": tt})
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(aux) == 0.0
    close(got, want, _tol(dtype))


def test_loss_matches_jax(pair):
    dtype, cfg, jm, params, _, tm = pair
    tj, tt = _tokens(cfg.vocab_size)
    mask = (np.arange(S)[None, :] < np.array([[S], [S // 2]])).astype(np.float32)
    want, wm = jm.loss(params, {"tokens": tj, "labels": (tj + 1) % cfg.vocab_size,
                                "mask": jnp.asarray(mask)})
    got, gm = tm.loss({"tokens": tt, "labels": (tt + 1) % cfg.vocab_size,
                       "mask": torch.from_numpy(mask)})
    close(got, want, _tol(dtype))
    close(gm["ce"], wm["ce"], _tol(dtype))


def test_prefill_and_decode_match_jax(pair):
    dtype, cfg, jm, params, _, tm = pair
    tj, tt = _tokens(cfg.vocab_size)
    want, jcache = jm.prefill(params, {"tokens": tj})
    got, tcache = tm.prefill({"tokens": tt})
    assert got.shape == (B, 1, 512) and len(tcache) == cfg.num_layers
    close(got, want, _tol(dtype))
    for i, c in enumerate(tcache):
        assert c["k"].shape == (B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
        for n in ("k", "v"):
            close(c[n], jcache["L0"][n][i], _tol(dtype))

    # one decode step at pos S on the cache grown by one slot
    def grow(a):
        return jnp.pad(a, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])
    jgrown = jax.tree.map(grow, jcache)
    tgrown = [{n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1)) for n, a in c.items()}
              for c in tcache]
    nxt = np.full((B, 1), 3, np.int32)
    pos = np.full((B,), S, np.int32)
    want, jnew = jm.decode_step(params, jgrown, jnp.asarray(nxt), jnp.asarray(pos))
    got, tnew = tm.decode_step(tgrown, torch.from_numpy(nxt), torch.from_numpy(pos))
    close(got, want, _tol(dtype))
    for i, c in enumerate(tnew):
        close(c["k"], jnew["L0"]["k"][i], _tol(dtype))


def test_prefill_decode_teacher_forcing():
    """decode_step at position S equals the forward logits at S (fp32)."""
    cfg = reduced_config(get_config("qwen2-0.5b"))
    tm = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    _, tt = _tokens(cfg.vocab_size)
    nxt = torch.full((B, 1), 3)
    with torch.no_grad():
        full, _ = tm.forward({"tokens": torch.cat([tt, nxt], dim=1)})
    _, cache = tm.prefill({"tokens": tt})
    cache = [{n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1)) for n, a in c.items()}
             for c in cache]
    step, _ = tm.decode_step(cache, nxt, torch.full((B,), S, dtype=torch.int32))
    close(step[:, 0], full[:, -1], MODEL_TOL)


def test_param_spec_matches_jax():
    cfg = jax_reduced(jax_get_config("qwen2-0.5b"))
    leaves = jax.tree_util.tree_flatten_with_path(jax_build(cfg).init_shape())[0]
    want = {"/".join(p.key for p in path): leaf.shape for path, leaf in leaves}
    got = {k: ps.shape for k, ps in flatten(build_model(torch_cfg(cfg), device="meta")
                                            .param_spec()).items()}
    assert got == want


def test_full_config_param_count():
    cfg = get_config("qwen2-0.5b")
    assert cfg.param_count() == 494_147_456
    assert cfg.param_count() == jax_build(jax_get_config("qwen2-0.5b")).param_count()
    assert cfg.active_param_count() == cfg.param_count()


def test_unported_layer_kind_raises():
    # SSM layers are ported (tests/test_torch_ssm.py); MoE layers are not yet
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-0.5b")), num_experts=4,
                              top_k=2)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 5"):
        build_model(cfg, device="cpu")


def test_init_is_seeded_and_finite():
    cfg = reduced_config(get_config("qwen2-0.5b"))
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    _, tt = _tokens(cfg.vocab_size)
    with torch.no_grad():
        logits, _ = a.forward({"tokens": tt})
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()


def test_build_model_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(reduced_config(get_config("qwen2-0.5b")))
