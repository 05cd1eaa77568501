"""The port's boundaries: no JAX inside it (every module imports, and the
serving, train-step, profiler-trace, zoo and predictor paths run), the card
by default, and chip_smoke.py refusing to run without a card or without the
repository."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONSTARTUP", None)
    return env


def test_port_imports_and_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None  # any import of these raises ImportError
        import torch
        import repro_torch
        mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for m in mods:
            importlib.import_module(m)
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.models import build_model
        from repro_torch.serve.engine import DecodeEngine
        for arch in ("qwen2-0.5b", "mamba2-370m"):
            cfg = reduced_config(get_config(arch))
            model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
            eng = DecodeEngine(model, batch=1, max_seq=12)
            out = eng.generate(eng.prefill({"tokens": torch.zeros(1, 12, dtype=torch.long)}), 3)
            assert out.shape == (1, 4)
            from repro_torch.core import profiler
            from repro_torch.train import optimizer, step
            _, fn, specs, batch = profiler.lm_trace(cfg, 1, 8)
            assert profiler.trace_step(fn, (specs, batch))["nsm_edges"]
            train = step.make_train_step(model, optimizer.OptConfig())
            state = step.init_state(model, optimizer.OptConfig(), torch.Generator().manual_seed(0))
            tok = torch.zeros(1, 8, dtype=torch.long)
            _, metrics = train(state, {"tokens": tok, "labels": tok})
            assert torch.isfinite(metrics["loss"])
        from repro_torch.core import profiler, randomgen, zoo
        from repro_torch.core.automl.models import RidgeRegressor
        from repro_torch.core.predictor import DNNAbacus
        recs = []
        for i, net in enumerate((zoo.build_zoo_model("lenet5"), randomgen.random_cnn(1))):
            step, init = profiler.zoo_train_step(net, "adam", 0.1)
            ps = net.param_shapes()
            x = torch.empty(2, 3, 32, 32, device="meta")
            y = torch.empty(2, dtype=torch.int64, device="meta")
            tr = profiler.trace_step(step, (ps, init(ps), x, y))
            recs.append(profiler.zoo_record(net, 2, 32, time_s=1.0 + i, mem_bytes=2.0 + i, **tr))
        ab = DNNAbacus().fit(recs * 3, candidate_factory=lambda seed: [RidgeRegressor()])
        assert (ab.predict(recs)[0] > 0).all()
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print("ok", len(mods))
    """)
    res = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card(tmp_path, where):
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":  # a directory with chip_smoke.py and nothing else
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
