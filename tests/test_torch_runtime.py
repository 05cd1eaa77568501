"""The port's training runtime (repro_torch.data, .ckpt, .ft, .train.loop,
.launch.train) against the JAX reference's, on the CPU.

- Token sources: ``batch_at`` equal to the reference's, byte for byte; the
  reference's data tests (``tests/test_predictor_sched.py``) run against the
  port through ``_torch_parity.port_suite``.
- Checkpoints: the cases of ``tests/test_ckpt_ft.py`` rewritten for torch
  (that file imports JAX itself, so it cannot be bound; its elastic-
  resharding case runs on a four-process world in
  ``tests/test_torch_distributed_step.py``); bf16 and fp32 leaves
  round-trip bit for bit; the files' layout is the reference's; a bf16
  checkpoint the reference wrote restores in the port bit for bit, while the
  reference's own ``restore`` raises on it.
- The runner and the Trainer: the reference's fault-tolerance cases, and a
  crash-resume whose losses equal an uninterrupted run's bit for bit.
- Across packages: the port's Trainer resumed from the JAX Trainer's
  checkpoint (``state_from_jax``) matches the JAX Trainer's continued run,
  losses within ``RESUME_RTOL`` = 1e-4 relative and gradient norms within
  1e-3 relative (reduced qwen2-0.5b, fp32, 2 layers: the two packages' fp32
  steps sum in another order; one step's loss agrees to 1e-5 in
  ``tests/test_torch_train.py``).
- The launcher with ``--device cpu``: ``--predict`` prints the estimate and
  hands its time to the straggler detector; a predicted OOM returns 2
  before anything is built.
- On a one-rank mesh (``one_rank_world``: a gloo group of this process
  alone, in memory, destroyed after the test): the loader's DTensor
  batches, a restore onto the mesh, the Trainer's losses equal to the
  unsharded Trainer's bit for bit, and the launcher's ``--data 2`` clamped
  to (1, 1).
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.distributed.tensor import Replicate  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import port_suite, torch_cfg  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.distributed.sharding import NamedSharding, P  # noqa: E402
from repro_torch.ft.runtime import (FailureInjector, FTConfig, StepFailure,  # noqa: E402
                                    StepRunner)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.loop import LoopConfig, Trainer  # noqa: E402

RESUME_RTOL = 1e-4
GNORM_RTOL = 1e-3

@pytest.fixture
def one_rank_world():
    """A (1, 1) mesh over a gloo group of this process alone (an in-memory
    store, no port), destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    assert not dist.is_initialized()
    try:
        yield lambda: make_host_mesh(1, 1, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


SCHED = port_suite("test_predictor_sched")
test_synthetic_data_deterministic_in_step = SCHED.test_synthetic_data_deterministic_in_step
test_loader_resumes_at_step = SCHED.test_loader_resumes_at_step


# -- token sources -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 1234])
def test_synthetic_batches_equal_the_reference(seed):
    for vocab, batch, seq in ((1000, 4, 16), (151936, 2, 64)):
        ours = tdata.SyntheticLM(vocab, batch, seq, seed)
        ref = jdata.SyntheticLM(vocab, batch, seq, seed)
        for step in (0, 1, 7, 1000):
            a, b = ours.batch_at(step), ref.batch_at(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                assert a[k].tobytes() == b[k].tobytes()


def test_memmap_batches_equal_the_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(0).integers(0, 2 ** 16, 5000).astype(np.uint16).tofile(path)
    for seed in (0, 5):
        ours, ref = tdata.MemmapLM(path, 3, 32, seed=seed), jdata.MemmapLM(path, 3, 32, seed=seed)
        for step in (0, 2, 9):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert all(a[k].tobytes() == b[k].tobytes() for k in ("tokens", "labels"))


def test_loader_gives_int32_tensors_in_order_and_close_stops_it(one_rank_world):
    src = tdata.SyntheticLM(1000, 2, 8, seed=1)
    loader = tdata.ShardedLoader(src, None, start_step=3, prefetch=2, device="cpu")
    for step in (3, 4, 5):
        b = next(loader)
        assert b["tokens"].dtype == torch.int32 and b["tokens"].device.type == "cpu"
        assert np.array_equal(b["tokens"].numpy(), src.batch_at(step)["tokens"])
        assert loader.step == step + 1
    loader.close()
    assert not loader._thread.is_alive()
    mesh = one_rank_world()
    sharded = tdata.ShardedLoader(src, tstep.batch_shardings(mesh, src.batch_at(0)),
                                  start_step=3)
    b = next(sharded)
    sharded.close()
    assert b["tokens"].placements == (Replicate(), Replicate())
    assert b["tokens"].dtype == torch.int32 and b["tokens"].device.type == "cpu"
    assert np.array_equal(b["tokens"].full_tensor().numpy(), src.batch_at(3)["tokens"])


# -- checkpoints ---------------------------------------------------------------

def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros(4)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.reshape(-1).numpy().view(np.uint8)


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, _state(1.5))
    assert ckpt.latest_step(d) == 7
    out = ckpt.restore(d, 7, _state())
    np.testing.assert_array_equal(out["params"]["w"].numpy(), np.full((4, 4), 1.5))
    assert int(out["step"]) == 7 and out["step"].shape == ()


def test_atomicity_no_partial_dirs(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state())
    ckpt.save(d, 2, _state())
    names = set(os.listdir(d))
    assert not any(n.startswith(".tmp") for n in names)
    assert ckpt.all_steps(d) == [1, 2]


def test_gc_keeps_last_k(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(1, 6):
        ckpt.save(d, s, _state(), keep=2)
    assert ckpt.all_steps(d) == [4, 5]


def test_restore_missing_key_raises(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError):
        ckpt.restore(d, 1, {"a": torch.zeros(2), "b": torch.zeros(3)})


def test_restore_casts_dtype(tmp_path, one_rank_world):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w": torch.ones((2, 2), dtype=torch.float32)})
    out = ckpt.restore(d, 1, {"w": torch.empty((2, 2), dtype=torch.bfloat16, device="meta")},
                       device="cpu")
    assert out["w"].dtype == torch.bfloat16 and bool((out["w"] == 1).all())
    mesh = one_rank_world()
    out = ckpt.restore(d, 1, {"w": torch.empty((2, 2), dtype=torch.bfloat16, device="meta")},
                       shardings={"w": NamedSharding(mesh, P())})
    assert out["w"].placements == (Replicate(), Replicate())
    assert out["w"].dtype == torch.bfloat16 and bool((out["w"].full_tensor() == 1).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_leaves_round_trip_bit_for_bit(tmp_path, dtype):
    """Every bit pattern of the dtype's width, NaNs and infinities among them,
    comes back as written, beside fp32 and int32 leaves."""
    n = 2 ** 16
    pattern = np.arange(n, dtype=np.uint16) if dtype == torch.bfloat16 else \
        np.random.default_rng(0).integers(0, 2 ** 32, n, dtype=np.uint32)
    raw = torch.from_numpy(pattern.view(np.int16 if dtype == torch.bfloat16 else np.int32))
    state = {"params": {"x": raw.view(dtype).reshape(256, 256), "y": torch.randn(3, 5)},
             "opt": {"count": torch.tensor(3, dtype=torch.int32)},
             "step": torch.tensor(3, dtype=torch.int32)}
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, state)
    with open(os.path.join(d, "step_00000003", "index.json")) as f:
        index = json.load(f)
    want = "bfloat16" if dtype == torch.bfloat16 else "float32"
    assert index["keys"]["params|x"] == {"shape": [256, 256], "dtype": want}
    for like, device in ((state, None), (_meta(state), "cpu")):
        out = ckpt._flatten(ckpt.restore(d, 3, like, device=device))
        for k, t in ckpt._flatten(state).items():
            assert out[k].dtype == t.dtype and out[k].shape == t.shape
            assert np.array_equal(_bits(out[k]), _bits(t)), k


def _twin_states():
    """The same small state in both packages: a bf16 weight, fp32 leaves, int32 scalars."""
    rng = np.random.default_rng(0)
    w, b, m = (rng.standard_normal(s).astype(np.float32) for s in ((4, 6), (6,), (4, 6)))
    jstate = {"params": {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b)},
              "opt": {"m": {"w": jnp.asarray(m)}, "count": jnp.asarray(5, jnp.int32)},
              "step": jnp.asarray(5, jnp.int32)}
    tstate = {"params": {"w": torch.from_numpy(w).bfloat16(), "b": torch.from_numpy(b)},
              "opt": {"m": {"w": torch.from_numpy(m)}, "count": torch.tensor(5, dtype=torch.int32)},
              "step": torch.tensor(5, dtype=torch.int32)}
    return jstate, tstate


def test_checkpoint_files_have_the_reference_layout(tmp_path):
    jstate, tstate = _twin_states()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jd, 5, jstate)
    ckpt.save(td, 5, tstate)
    for d in (jd, td):
        assert sorted(os.listdir(d)) == ["step_00000005"]
        assert sorted(os.listdir(os.path.join(d, "step_00000005"))) == ["arrays.npz", "index.json"]
    idx = [json.load(open(os.path.join(d, "step_00000005", "index.json"))) for d in (jd, td)]
    assert idx[0] == idx[1]
    assert list(idx[1]["keys"]) == ["opt|count", "opt|m|w", "params|b", "params|w", "step"]
    assert idx[1]["keys"]["params|w"]["dtype"] == "bfloat16"
    with np.load(os.path.join(jd, "step_00000005", "arrays.npz")) as zj, \
            np.load(os.path.join(td, "step_00000005", "arrays.npz")) as zt:
        assert zj.files == zt.files
        for k in zj.files:
            assert zj[k].shape == zt[k].shape and zj[k].dtype.itemsize == zt[k].dtype.itemsize
            assert zj[k].dtype.kind == zt[k].dtype.kind and zj[k].tobytes() == zt[k].tobytes(), k
        assert zt["params|w"].dtype.kind == "V"  # bf16 bits, as the reference writes them


def test_reference_bf16_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate = _twin_states()
    d = str(tmp_path / "ck")
    jckpt.save(d, 5, jstate)
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore(d, 5, jstate)  # the reference cannot cast its own V2 leaf
    out = ckpt._flatten(ckpt.restore(d, 5, _meta(tstate), device="cpu"))
    for k, t in ckpt._flatten(tstate).items():
        assert out[k].dtype == t.dtype and np.array_equal(_bits(out[k]), _bits(t)), k
    jw = np.asarray(jstate["params"]["w"]).view(np.uint16)
    assert np.array_equal(out["params|w"].view(torch.int16).numpy().view(np.uint16), jw)


# -- fault tolerance -----------------------------------------------------------

def test_runner_retries_transient_failures():
    inj = FailureInjector(fail_on_calls=(1, 2))
    fn = inj.wrap(lambda x: x + 1)
    runner = StepRunner(fn, FTConfig(max_retries=2))
    assert runner(41) == 42
    assert runner.retries == 2


def test_runner_gives_up_after_max_retries():
    inj = FailureInjector(fail_on_calls=(1, 2, 3, 4))
    runner = StepRunner(inj.wrap(lambda x: x), FTConfig(max_retries=1))
    with pytest.raises(StepFailure):
        runner(1)


def test_straggler_detection_with_prediction():
    import time
    flags = []

    def slow_then_fast(x):
        time.sleep(0.05 if len(flags) == 0 and not slow_then_fast.done else 0)
        slow_then_fast.done = True
        return x
    slow_then_fast.done = False
    runner = StepRunner(slow_then_fast, FTConfig(straggler_factor=2.0),
                        predicted_step_s=0.005,
                        on_straggler=lambda i, dt: flags.append(dt))
    runner(1)   # slow step -> flagged
    runner(1)
    assert runner.stragglers >= 1 and len(flags) >= 1


# -- the Trainer ---------------------------------------------------------------

def _cpu_model(dtype="float32"):
    return build_model(reduced_config(get_config("qwen2-0.5b"), dtype=dtype), device="cpu")


def test_trainer_resumes_after_simulated_crash(tmp_path):
    """Kill training mid-run; a fresh Trainer resumes from the checkpoint, and
    its losses equal an uninterrupted run's bit for bit."""
    model = _cpu_model()

    def lc(d):
        return LoopConfig(steps=6, batch=2, seq=32, ckpt_every=2, ckpt_dir=d, log_every=1)
    whole = Trainer(model, topt.OptConfig(), lc(str(tmp_path / "whole"))).run()
    d = str(tmp_path / "ck")
    Trainer(model, topt.OptConfig(), lc(d)).run(steps=4)  # "crash" after 4 steps (ckpts at 2, 4)
    assert ckpt.latest_step(d) == 4
    t2 = Trainer(model, topt.OptConfig(), lc(d))
    log = t2.run()  # resumes at 4, finishes 6
    assert [r["step"] for r in log] == [4, 5]
    assert ckpt.latest_step(d) == 6
    assert [(r["loss"], r["grad_norm"]) for r in log] == \
        [(r["loss"], r["grad_norm"]) for r in whole[4:]]


def test_trainer_retries_an_injected_failure_and_writes_the_last_step_once(tmp_path, monkeypatch,
                                                                           one_rank_world):
    """A failed step call is retried from the same state (the losses equal a
    run without the failure), and a last step that is a multiple of
    ``ckpt_every`` is written once, not a second time after the loop."""
    model = _cpu_model("bfloat16")
    saves = []
    real_save = ckpt.save
    monkeypatch.setattr(ckpt, "save",
                        lambda d, s, st, **kw: saves.append(s) or real_save(d, s, st, **kw))
    lc = LoopConfig(steps=4, batch=2, seq=16, ckpt_every=2, log_every=1,
                    ckpt_dir=str(tmp_path / "a"))
    clean = Trainer(model, topt.OptConfig(), lc).run()
    t = Trainer(model, topt.OptConfig(), dataclasses.replace(lc, ckpt_dir=str(tmp_path / "b")))
    inj = FailureInjector(fail_on_calls=(2,))
    t.runner.step_fn = inj.wrap(t.runner.step_fn)
    log = t.run()
    assert t.runner.retries == 1 and inj.calls == 5
    assert [r["loss"] for r in log] == [r["loss"] for r in clean]
    assert saves == [2, 4, 2, 4]  # the reference writes [2, 4, 4] each run
    assert ckpt.all_steps(str(tmp_path / "b")) == [2, 4]
    restored = ckpt._flatten(ckpt.restore(str(tmp_path / "b"), 4, t.state))
    for k, v in ckpt._flatten(t.state).items():
        assert restored[k].dtype == v.dtype and np.array_equal(_bits(restored[k]), _bits(v)), k
    # on a one-rank mesh: DTensor state and batches, the same losses bit for bit
    sharded = Trainer(model, topt.OptConfig(), dataclasses.replace(lc, ckpt_dir=None),
                      mesh=one_rank_world())
    assert [r["loss"] for r in sharded.run()] == [r["loss"] for r in clean]
    assert all(v.placements == (Replicate(), Replicate())
               for v in sharded.state["params"].values())


def test_port_trainer_resumes_from_the_jax_trainers_checkpoint(tmp_path):
    """The JAX Trainer runs 4 steps with checkpoints; the port's Trainer starts
    from its step-4 checkpoint through ``state_from_jax`` and matches the JAX
    Trainer's continued run at steps 4-5."""
    from repro.models import build_model as jax_build
    from repro.train import optimizer as jopt
    from repro.train.loop import LoopConfig as JLoopConfig, Trainer as JTrainer

    jcfg = jax_reduced(jax_get_config("qwen2-0.5b"))
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jlc = JLoopConfig(steps=6, batch=2, seq=32, ckpt_every=2, ckpt_dir=jd, log_every=1)
    JTrainer(jax_build(jcfg), jopt.OptConfig(), jlc).run(steps=4)
    assert jckpt.latest_step(jd) == 4
    cfg = torch_cfg(jcfg)
    state = tstep.state_from_jax(cfg, ckpt.read_arrays(jd, 4))
    assert int(state["step"]) == 4 and int(state["opt"]["count"]) == 4
    assert state["opt"]["master"] == {}  # an fp32 model keeps no master copy
    ckpt.save(td, 4, state)
    port = Trainer(build_model(cfg, device="cpu"), topt.OptConfig(),
                   LoopConfig(steps=6, batch=2, seq=32, ckpt_every=2, ckpt_dir=td, log_every=1))
    got = port.run()
    want = JTrainer(jax_build(jcfg), jopt.OptConfig(), jlc).run()  # resumes at 4
    assert [r["step"] for r in got] == [r["step"] for r in want] == [4, 5]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RESUME_RTOL, atol=0)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=GNORM_RTOL, atol=0)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)


def test_state_from_jax_keeps_the_fp32_state_of_a_bf16_model():
    """A bf16 model's parameters come back bf16; its moments and master stay
    fp32, with every value as written (bf16 parameters cross exactly)."""
    from repro.models import build_model as jax_build
    from repro.train import optimizer as jopt
    from repro.train import step as jstep

    jcfg = jax_reduced(jax_get_config("qwen2-0.5b"), dtype="bfloat16")
    jstate = jstep.init_state(jax_build(jcfg), jopt.OptConfig(), jax.random.key(0))
    jstate["opt"]["m"] = jax.tree.map(lambda x: x + 0.25, jstate["opt"]["m"])
    arrays = {k: ckpt.from_numpy(np.array(v), str(v.dtype))
              for k, v in jckpt._flatten(jstate).items()}
    state = tstep.state_from_jax(torch_cfg(jcfg), arrays)
    model = build_model(torch_cfg(jcfg), device="meta")
    like = tstep.state_shapes(model, topt.OptConfig())
    flat, flat_like = ckpt._flatten(state), ckpt._flatten(like)
    assert set(flat) == set(flat_like)
    for k, t in flat.items():
        assert t.dtype == flat_like[k].dtype and t.shape == flat_like[k].shape, k
    assert state["opt"]["master"] and all(t.dtype == torch.float32
                                          for t in state["opt"]["master"].values())
    wq = np.asarray(jstate["params"]["layers"]["L0"]["mixer"]["wq"]).view(np.uint16)
    assert np.array_equal(state["params"]["layers.1.mixer.wq"].view(torch.int16).numpy()
                          .view(np.uint16), wq[1])
    assert bool((state["opt"]["m"]["embed.table"] == 0.25).all())


# -- the launcher --------------------------------------------------------------

def _launcher_abacus(path: str, mem_per_token: float) -> None:
    """A DNNAbacus fitted on traces of reduced qwen2-0.5b with made-up costs
    (1 ms and ``mem_per_token`` bytes a token), saved at ``path``."""
    from repro_torch.core.automl.models import RidgeRegressor
    from repro_torch.core.predictor import DNNAbacus
    from repro_torch.serve.prediction_service import trace_query
    cfg = reduced_config(get_config("qwen2-0.5b"))
    recs = [dataclasses.replace(trace_query(cfg, b, s), time_s=1e-3 * b * s,
                                mem_bytes=mem_per_token * b * s)
            for b, s in ((1, 16), (2, 16), (2, 32), (4, 32))]
    DNNAbacus().fit(recs * 3, candidate_factory=lambda seed: [RidgeRegressor()]).save(path)


@pytest.fixture
def trainers(monkeypatch):
    """Every Trainer the launcher builds."""
    import repro_torch.train.loop as loop
    made = []

    class Recorded(loop.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    monkeypatch.setattr(loop, "Trainer", Recorded)
    return made


def test_launcher_predicts_and_hands_the_time_to_the_straggler_detector(tmp_path, capsys,
                                                                        trainers):
    from repro_torch.core.predictor import DNNAbacus
    from repro_torch.launch.train import main
    path = str(tmp_path / "abacus")
    _launcher_abacus(path, 1e6)
    d = str(tmp_path / "ck")
    rc = main(["--arch", "qwen2-0.5b", "--steps", "3", "--batch", "2", "--seq", "32",
               "--ckpt-dir", d, "--predict", "--predictor-path", path, "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    est = DNNAbacus.load(path).service().predict_one(reduced_config(get_config("qwen2-0.5b")),
                                                     2, 32)
    assert out[0] == (f"[abacus] predicted step time {est['time_s']*1e3:.1f} ms, "
                      f"peak memory {est['memory_bytes']/2**30:.2f} GiB")
    (trainer,) = trainers
    assert trainer.runner.predicted == est["time_s"] == trainer.cfg.predicted_step_s
    assert trainer.device == torch.device("cpu")
    logs = [json.loads(line) for line in out[1:-1]]
    assert [r["step"] for r in logs] == [0, 2] and ckpt.latest_step(d) == 3
    assert out[-1].startswith("final loss: ") and "retries=0" in out[-1]


def test_launcher_refuses_a_predicted_oom_before_building(tmp_path, capsys, trainers):
    from repro_torch.launch.train import main
    path = str(tmp_path / "abacus")
    _launcher_abacus(path, 1e13)
    rc = main(["--arch", "qwen2-0.5b", "--steps", "3", "--batch", "2", "--seq", "32",
               "--predict", "--predictor-path", path, "--device", "cpu"])
    assert rc == 2 and trainers == []
    captured = capsys.readouterr()
    assert captured.out.startswith("[abacus] predicted step time")
    assert "[abacus] REFUSED: predicted OOM" in captured.err


def test_launcher_needs_the_card_unless_asked_for_the_cpu(monkeypatch, capsys, one_rank_world):
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--arch", "qwen2-0.5b", "--steps", "1"])
    # a data axis of 2 in a lone process: the mesh clamps to the one-rank world
    assert main(["--arch", "qwen2-0.5b", "--data", "2", "--steps", "2", "--batch", "2",
                 "--seq", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[mesh] {'data': 1, 'model': 1} over 1 rank(s) on cpu" in out
    assert "final loss: " in out


def test_loader_thread_does_not_outlive_the_trainer(tmp_path):
    before = threading.active_count()
    Trainer(_cpu_model(), topt.OptConfig(), LoopConfig(steps=2, batch=1, seq=8)).run()
    assert threading.active_count() == before
