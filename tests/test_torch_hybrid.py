"""Port parity of the MoE, hybrid, cross-attention and encoder-decoder
stacks: moonshot-v1-16b-a3b (MoE), arctic-480b (MoE + dense residual),
jamba-v0.1-52b (SSM + attention, dense and MoE MLPs), llama-3.2-vision-90b
(gated cross-attention to stub patches) and whisper-tiny (encoder over stub
frames), each reduced, and the ``attn_cross`` layer kind, held against the
JAX reference with its weights carried across by ``params_from_jax``.

A cross layer's output is scaled by ``tanh(gate_attn)``, zero at init, so
the gates are set non-zero on both sides. Models hold to 2e-3 (fp32), as
``tests/test_torch_model.py``; the train step to ``tests/test_torch_train.py``'s
tolerances. The five dense and SSM archs join the sweep under ``slow``, the
port's counterpart of ``tests/test_archs_smoke.py``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from _torch_parity import MODEL_TOL, TOL, close, jax_flat, np32, port_model, torch_cfg  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.stack import StackModel as JaxStack  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.module import flatten, params_from_jax  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

NEW_ARCHS = ["moonshot-v1-16b-a3b", "arctic-480b", "jamba-v0.1-52b", "llama-3.2-vision-90b",
             "whisper-tiny"]
EARLIER_ARCHS = ["qwen2-0.5b", "chatglm3-6b", "phi4-mini-3.8b", "qwen2.5-32b", "mamba2-370m"]
# the ten-arch sweep: the earlier five run in tier-2 (their own files hold them in tier-1)
SWEEP = NEW_ARCHS + [pytest.param(a, marks=pytest.mark.slow) for a in EARLIER_ARCHS]
B, S = 2, 24  # S differs from the reduced vision_seq (16) and audio_seq (32)
LOSS_TOL, GRAD_TOL, OPT_TOL, LR = 1e-5, 1e-4, 1e-6, 1e-3


def _gated(params):
    """The JAX tree with every cross layer's gate set to 0.5 + 0.1 j."""
    def leaf(path, x):
        if any(getattr(k, "key", None) == "gate_attn" for k in path):
            return 0.5 + 0.1 * jnp.arange(x.shape[0], dtype=x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


def _batch(cfg, s=S, seed=0):
    """(jax batch, torch batch): tokens and labels, and the config's stub
    memory (``patches`` or ``frames``) drawn with numpy."""
    rng = np.random.default_rng(seed)
    tok = (np.arange(B * s, dtype=np.int32).reshape(B, s) * 7) % (cfg.vocab_size - 1)
    arrays = {"tokens": tok, "labels": (tok + 1) % cfg.vocab_size}
    if cfg.cross_every:
        arrays["patches"] = rng.standard_normal((B, cfg.vision_seq, cfg.d_model), np.float32)
    if cfg.is_encoder_decoder:
        arrays["frames"] = rng.standard_normal((B, cfg.audio_seq, cfg.d_model), np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _setup(cfg):
    jm = jax_build(cfg)
    params = _gated(jm.init(jax.random.key(0)))
    return jm, params, port_model(torch_cfg(cfg), params)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def pair(request):
    cfg = jax_reduced(jax_get_config(request.param))
    return (cfg, *_setup(cfg))


def test_registry_builds_the_new_archs():
    for arch in NEW_ARCHS:
        cfg = get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(arch))
        assert (dataclasses.asdict(reduced_config(cfg))
                == dataclasses.asdict(jax_reduced(jax_get_config(arch))))
        model = build_model(reduced_config(cfg), device="meta")
        assert [layer.kind for layer in model.layers] == cfg.pattern() * min(2, cfg.num_periods)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_spec_matches_jax(arch):
    cfg = jax_reduced(jax_get_config(arch))
    leaves = jax.tree_util.tree_flatten_with_path(jax_build(cfg).init_shape())[0]
    want = {"/".join(p.key for p in path): leaf.shape for path, leaf in leaves}
    got = {k: ps.shape for k, ps in flatten(build_model(torch_cfg(cfg), device="meta")
                                            .param_spec()).items()}
    assert got == want


def test_forward_loss_and_aux_match_jax(pair):
    cfg, jm, params, tm = pair
    bj, bt = _batch(cfg)
    want, want_aux = jm.forward(params, bj)
    with torch.no_grad():
        got, got_aux = tm.forward(bt)
    close(got, want, MODEL_TOL)
    close(got_aux, want_aux, MODEL_TOL)
    assert (float(got_aux) > 0) == bool(cfg.num_experts)
    want_loss, wm = jm.loss(params, bj)
    with torch.no_grad():
        got_loss, gm = tm.loss(bt)
    close(got_loss, want_loss, MODEL_TOL)
    for k in ("ce", "aux"):
        close(gm[k], wm[k], MODEL_TOL)


def _grow_jax(cache):
    """The reference's cache (stacked over periods) grown as ``_grow``."""
    def grow(a):
        if a.ndim >= 3 and a.shape[2] == S:
            return jnp.pad(a, [(0, 0), (0, 0), (0, 1)] + [(0, 0)] * (a.ndim - 3))
        return a
    return jax.tree.map(grow, cache)


def _grow(cache, s=S):
    """The port's cache with one more slot where its sequence axis is the
    prompt's (a cross layer's memory K/V and the SSM state keep theirs)."""
    return [{n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1))
             if n in ("k", "v") and a.shape[1] == s else a for n, a in c.items()}
            for c in cache]


def test_prefill_and_decode_match_jax(pair):
    cfg, jm, params, tm = pair
    bj, bt = _batch(cfg)
    del bj["labels"], bt["labels"]
    want, jcache = jm.prefill(params, bj)
    got, tcache = tm.prefill(bt)
    close(got, want, MODEL_TOL)
    period = cfg.period
    for i, c in enumerate(tcache):
        jc = jcache[f"L{i % period}"]
        assert set(c) == set(jc)
        for n in c:
            close(c[n], jc[n][i // period], MODEL_TOL)
    nxt = np.full((B, 1), 3, np.int32)
    pos = np.full((B,), S, np.int32)
    want, jnew = jm.decode_step(params, _grow_jax(jcache), jnp.asarray(nxt), jnp.asarray(pos))
    got, tnew = tm.decode_step(_grow(tcache), torch.from_numpy(nxt), torch.from_numpy(pos))
    close(got, want, MODEL_TOL)
    for i, c in enumerate(tnew):
        for n in c:
            close(c[n], jnew[f"L{i % period}"][n][i // period], MODEL_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_decode_teacher_forcing(arch):
    """Prefill on S tokens, then decode steps at S, S + 1 equal the forward
    logits there (fp32). MoE at capacity_factor 8, as the reference's test:
    a full sequence and one token are grouped differently, so only a
    capacity that drops nothing makes them the same function."""
    cfg = reduced_config(get_config(arch))
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    tm = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    for layer in tm.layers:
        if hasattr(layer, "gate_attn"):
            layer.gate_attn.data.fill_(0.8)
    _, bt = _batch(cfg, S + 2)
    del bt["labels"]
    with torch.no_grad():
        full, _ = tm.forward(bt)
    cache = tm.prefill({**bt, "tokens": bt["tokens"][:, :S]})[1]
    for n in range(2):
        step, cache = tm.decode_step(_grow(cache, S + n), bt["tokens"][:, S + n:S + n + 1],
                                     torch.full((B,), S + n, dtype=torch.int32))
        close(step[:, 0], full[:, S + n], MODEL_TOL)


@pytest.mark.parametrize("arch", SWEEP)
def test_train_step_matches_jax(arch):
    """One AdamW step: loss and gradient norm within 1e-5, every gradient
    within 1e-4 of its leaf's largest, and the port's optimizer fed JAX's
    gradients gives JAX's parameters (tests/test_torch_train.py's rule).
    whisper's encoder gets zero gradients in both: no layer reads it."""
    cfg = jax_reduced(jax_get_config(arch))
    jm, params, tm = _setup(cfg)
    tcfg = torch_cfg(cfg)
    opt_j, opt_t = jopt.OptConfig(lr=LR, warmup_steps=1), topt.OptConfig(lr=LR, warmup_steps=1)
    bj, bt = _batch(cfg)
    sj = {"params": params, "opt": jopt.init_opt_state(opt_j, params),
          "step": jnp.zeros((), jnp.int32)}
    _, mj = jax.jit(jstep.make_train_step(jm, opt_j))(sj, bj)
    step = tstep.make_train_step(tm, opt_t)
    pt = {k: v.detach() for k, v in tm.named_parameters()}
    st = {"params": pt, "opt": topt.init_opt_state(opt_t, pt),
          "step": torch.zeros((), dtype=torch.int32)}
    new_t, mt = step(st, bt)
    assert set(mt) == set(mj)
    close(mt["loss"], mj["loss"], LOSS_TOL)
    close(mt["grad_norm"], mj["grad_norm"], LOSS_TOL)

    jtree = jax.jit(jax.grad(lambda p: jm.loss(p, bj)[0]))(params)
    jgrads = params_from_jax(tcfg, jax_flat(jtree))
    _, _, gt = step.compute_grads(pt, bt)
    assert gt.keys() == jgrads.keys()
    for k, want in jgrads.items():
        scale = float(np.abs(np32(want)).max())
        np.testing.assert_allclose(np32(gt[k]), np32(want), atol=GRAD_TOL * (scale or 1.0),
                                   rtol=0, err_msg=k)
        if k.startswith(("encoder.", "enc_norm.")):
            assert scale == 0.0 and not gt[k].any(), k
    theirs, _, _ = topt.apply_updates(opt_t, pt, jgrads, st["opt"])
    want = params_from_jax(tcfg, jax_flat(jopt.apply_updates(opt_j, params, jtree, sj["opt"])[0]))
    for k in want:
        close(theirs[k], want[k], OPT_TOL)
    mine, _, _ = topt.apply_updates(opt_t, pt, gt, st["opt"])
    for k in want:
        close(new_t["params"][k], mine[k], OPT_TOL)


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-tiny"])
def test_remat_gradients_equal_none(arch, remat):
    """Selective ("dots": matrix products kept) and full recompute give the
    gradients of no recompute: the same function, evaluated again."""
    cfg = reduced_config(get_config(arch))
    model = build_model(dataclasses.replace(cfg, remat="none"), device="cpu")
    model.init(torch.Generator().manual_seed(3))
    other = build_model(dataclasses.replace(cfg, remat=remat), device="cpu")
    other.load_state_dict(model.state_dict())
    _, bt = _batch(cfg)
    opt = topt.OptConfig()
    params = {k: v.detach() for k, v in model.named_parameters()}
    loss, _, want = tstep.make_train_step(model, opt).compute_grads(params, bt)
    got_loss, _, got = tstep.make_train_step(other, opt).compute_grads(params, bt)
    assert float(got_loss) == float(loss)
    for k in want:
        np.testing.assert_allclose(np32(got[k]), np32(want[k]), atol=1e-7, rtol=1e-6, err_msg=k)


class _CountOps(TorchDispatchMode):
    """Records every aten op that runs inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_remat_dots_saves_only_unbatched_products():
    """Under "dots" the backward recomputes the layer's elementwise ops and
    batched products but no unbatched one: counted by the ops the
    checkpointed region runs again."""
    cfg = dataclasses.replace(reduced_config(get_config("moonshot-v1-16b-a3b")), num_layers=1)
    counts = {}
    for remat in ("none", "dots", "full"):
        model = build_model(dataclasses.replace(cfg, remat=remat), device="cpu")
        model.init(torch.Generator().manual_seed(0))
        _, bt = _batch(cfg)
        with _CountOps() as c:
            model.loss(bt)[0].backward()
        counts[remat] = {op: c.ops.count(op) for op in (torch.ops.aten.mm.default,
                                                        torch.ops.aten.bmm.default)}
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert counts["dots"][mm] == counts["none"][mm] < counts["full"][mm]
    assert counts["none"][bmm] < counts["dots"][bmm] == counts["full"][bmm]


def test_encode_matches_jax():
    cfg = jax_reduced(jax_get_config("whisper-tiny"))
    jm, params, tm = _setup(cfg)
    bj, bt = _batch(cfg)
    want = jm._encode(params, bj["frames"])
    with torch.no_grad():
        got = tm._encode(bt["frames"])
    assert got.shape == (B, cfg.audio_seq, cfg.d_model)
    close(got, want, TOL["float32"])


class _JaxAttnCross(jbase.ModelConfig):
    def layer_kind(self, i):
        return ("attn_cross", "dense")


class _PortAttnCross(tbase.ModelConfig):
    def layer_kind(self, i):
        return ("attn_cross", "dense")


def test_attn_cross_matches_jax():
    """``attn_cross`` (self-attention, then cross-attention to the
    encoder's output), which no registered config's pattern holds: both
    models' pattern set to it over reduced whisper-tiny."""
    fields = dataclasses.asdict(jax_reduced(jax_get_config("whisper-tiny")))
    jcfg, tcfg = _JaxAttnCross(**fields), _PortAttnCross(**fields)
    jm = JaxStack(jcfg)
    assert jm.pattern == [("attn_cross", "dense")]
    params = jm.init(jax.random.key(4))
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(tcfg, jax_flat(params)))
    assert [type(layer).__name__ for layer in tm.layers] == ["AttnCrossLayer"] * tcfg.num_layers
    bj, bt = _batch(jcfg)
    want, _ = jm.forward(params, bj)
    with torch.no_grad():
        got, _ = tm.forward(bt)
    close(got, want, MODEL_TOL)
    del bj["labels"], bt["labels"]
    want, jcache = jm.prefill(params, bj)
    got, tcache = tm.prefill(bt)
    close(got, want, MODEL_TOL)
    assert tcache[0]["xk"].shape == (B, jcfg.audio_seq, jcfg.num_kv_heads, jcfg.resolved_head_dim)
    nxt, pos = np.full((B, 1), 5, np.int32), np.full((B,), S, np.int32)
    want, _ = jm.decode_step(params, _grow_jax(jcache), jnp.asarray(nxt), jnp.asarray(pos))
    got, tnew = tm.decode_step(_grow(tcache), torch.from_numpy(nxt), torch.from_numpy(pos))
    close(got, want, MODEL_TOL)
    assert tnew[0]["xk"] is tcache[0]["xk"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_is_seeded_and_finite(arch):
    cfg = reduced_config(get_config(arch))
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    _, bt = _batch(cfg)
    with torch.no_grad():
        logits, aux = a.forward(bt)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all() and torch.isfinite(aux)
