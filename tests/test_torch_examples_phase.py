"""``chip_smoke.py``'s phase 18 on the CPU: the launcher that runs each of the
port's examples in its child and then prints the kernels' launch counters,
and the checks of each example's output, held against canned transcripts.

- ``EXAMPLE_LAUNCHER`` runs ``serve_lm_torch.py --device cpu`` (small) with
  ``jax``, ``jaxlib`` and ``repro`` blocked: the example's own lines come
  out as a direct run prints them, then one counter line, every count 0
  (the CPU takes the kernels' plain versions), with the run's wall time; a
  failing example fails the child and prints no counter line.
- ``check_example`` accepts a well-formed transcript of each example and
  rejects a missing section, an unpublished generation, GA outside
  [optimal, random mean], a first line naming another device, launch
  counts other than the derived ones (a nonzero flash count in a train
  run, a run that fell to the plain norm), and a run past its wall bound.
- ``EXAMPLE_LAUNCHES`` equals what the examples' configs give through
  ``serve_launches`` / ``step_launches``, each config caught where the
  example builds its model.
"""

import json
import os
import re
import runpy
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import repro_torch.models  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402

CARD = "NVIDIA H100 80GB HBM3"
SERVE_ARGS = ("--device", "cpu", "--batch", "2", "--prompt-len", "8", "--steps", "4")


def _env(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.mkdir(exist_ok=True)
    (blocker / "sitecustomize.py").write_text(
        "import sys\nfor name in ('jax', 'jaxlib', 'repro'):\n    sys.modules[name] = None\n")
    return {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocker), os.path.join(ROOT, "src")])}


def _timeless(lines):
    return [re.sub(r"[\d.]+ ms", "_ ms", line) for line in lines]


def test_launcher_prints_the_example_then_zero_counts(tmp_path):
    env = _env(tmp_path)
    (tmp_path / "direct").mkdir()
    (tmp_path / "launched").mkdir()
    direct = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "serve_lm_torch.py"),
                             *SERVE_ARGS], cwd=tmp_path / "direct", env=env,
                            capture_output=True, text=True, timeout=600)
    launched = subprocess.run(cs.example_command("serve_lm_torch.py", SERVE_ARGS),
                              cwd=tmp_path / "launched", env=env, capture_output=True, text=True,
                              timeout=600)
    assert direct.returncode == 0, direct.stderr[-3000:]
    assert launched.returncode == 0, launched.stderr[-3000:]
    lines = launched.stdout.splitlines()
    assert lines[0] == "device: cpu"
    assert len(lines) == len(direct.stdout.splitlines()) + 1 == 6, launched.stdout
    assert _timeless(lines[:-1]) == _timeless(direct.stdout.splitlines())
    last = json.loads(lines[-1])
    assert last["launches"] == dict.fromkeys(cs.EXAMPLE_COUNTERS, 0)
    assert set(last) == {"launches", "wall_s"} and 0 < last["wall_s"] < 600


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is available here")
def test_launcher_fails_with_its_example(tmp_path):
    out = subprocess.run(cs.example_command("serve_lm_torch.py", ("--steps", "1")),
                         cwd=tmp_path, env=_env(tmp_path), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0
    assert "pass --device cpu" in out.stderr, out.stderr[-2000:]
    assert "launches" not in out.stdout


def test_phase_runs_the_four_examples_as_a_user_does():
    assert set(cs.EXAMPLE_RUNS) == set(cs.EXAMPLE_LAUNCHES) == set(cs.EXAMPLE_LINES) \
        == set(cs.EXAMPLE_WALL_S) == {"serve_lm_torch.py", "train_lm_torch.py",
                                      "quickstart_torch.py", "predict_and_schedule_torch.py"}
    assert not [a for args in cs.EXAMPLE_RUNS.values() for a in args if a.startswith("--device")]
    assert cs.EXAMPLE_WALL_S["serve_lm_torch.py"] == cs.EXAMPLE_WALL_S["train_lm_torch.py"] \
        == 60.0
    cmd = cs.example_command("quickstart_torch.py")
    assert cmd[1:3] == ["-c", cs.EXAMPLE_LAUNCHER]
    assert cmd[3] == os.path.join(ROOT, "examples", "quickstart_torch.py")


class _Built(Exception):
    pass


def _model_config(monkeypatch, name, *args):
    """The config ``examples/<name>`` builds its model from, run as its user
    runs it with ``args`` (on the CPU), caught at its ``build_model`` call."""
    def build(cfg, **kwargs):
        raise _Built(cfg)
    monkeypatch.setattr(repro_torch.models, "build_model", build)
    monkeypatch.setattr(sys, "argv", [name, *args, "--device", "cpu"])
    monkeypatch.setattr(sys, "path", list(sys.path))  # the example puts "src" first
    with pytest.raises(_Built) as built:
        runpy.run_path(os.path.join(ROOT, "examples", name), run_name="__main__")
    return built.value.args[0]


def test_derived_launches_are_the_configs(monkeypatch):
    serve = _model_config(monkeypatch, "serve_lm_torch.py", *cs.EXAMPLE_RUNS["serve_lm_torch.py"])
    prefill, decode = cs.serve_launches(serve, steps=16)  # serve_lm_torch.py's --steps
    assert cs.EXAMPLE_LAUNCHES["serve_lm_torch.py"] == {
        "ssd_scan_split": 0, **{k: prefill[k] + decode[k] for k in prefill}}
    train_args = cs.EXAMPLE_RUNS["train_lm_torch.py"]
    train = _model_config(monkeypatch, "train_lm_torch.py", *train_args)
    assert train.name == "qwen2-100m" and train_args == ("--steps", "20")
    quickstart = reduced_config(get_config("qwen2-0.5b"))  # quickstart_torch.py's, 10 steps
    for name, cfg, steps in (("train_lm_torch.py", train, 20),
                             ("quickstart_torch.py", quickstart, 10)):
        step = cs.step_launches(cfg)
        assert cs.EXAMPLE_LAUNCHES[name] == {"ssd_scan_split": 0,
                                             **{k: steps * n for k, n in step.items()}}


def _counter_line(name, wall_s=12.5, **change):
    return json.dumps({"launches": {**cs.EXAMPLE_LAUNCHES[name], **change}, "wall_s": wall_s})


TRANSCRIPTS = {
    "serve_lm_torch.py": f"""device: {CARD}
arch=qwen2-0.5b (reduced) batch=4
prefill: 5377.5 ms, decode: 28.7 ms/token
""" + "".join(f"  request {i}: [{', '.join(['133'] * 17)}]\n" for i in range(4)),
    "train_lm_torch.py": f"""device: {CARD}
params: 38.8M
loss 9.686 -> 5.394 over 20 steps (retries=0)
""",
    "quickstart_torch.py": f"""device: {CARD}
== profiling a few CNN training configs ==
""" + "".join(f"  {n:12s} b={b:3d}  {1.5:8.1f} ms  {20.25:8.1f} MiB\n"
              for n in ("lenet5", "squeezenet", "nin") for b in (8, 16, 32)) + """\
== fitting DNNAbacus ==
  unseen config: predicted 2.1 ms (measured 2.0 ms), 30.2 MiB (measured 31.0)
== training reduced qwen2-0.5b for 10 steps ==
  step   0 loss 6.2752
  step   3 loss 6.2764
  step   6 loss 6.2619
  step   9 loss 6.2459
done.
""",
    "predict_and_schedule_torch.py": f"""device: {CARD}
== collecting profiles ==
""" + "".join(f"  {n} b={b}: {b // 4} ms\n" for n in ("lenet5", "squeezenet", "nin",
                                                      "mobilenet_v1", "shufflenet_v2")
              for b in (8, 16, 32, 64)) + """\
predictor saved to artifacts/torch/abacus.json
== makespans ==
  optimal :     285.4 s
  random  :     343.2 s (mean of 100)
  GA      :     285.6 s (16.8% better than random)
  GA generations to best: 18
  assignment: [0, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 1, 1, 0, 0, 1]
== admission control (AbacusServer gateway) ==
  qwen2-0.5b: 76.3 ms, 0.00 GiB, admitted=True
  qwen2-0.5b: 78.4 ms, 0.01 GiB, admitted=True
  cold 3921 ms -> warm 2.1 ms (server {'running': True})
== streaming admission (AdmissionController) ==
  wave0 qwen2-0.5b#0: system2
  wave0 qwen2-0.5b#1: system1
  wave1 qwen2-0.5b#2: system2
  wave1 qwen2-0.5b#3: system2
  wave1 qwen2-0.5b#4: system1
  cluster makespan 0.0 s, 0 resident jobs (all completions reported)
== online refit (feedback -> new generation) ==
  pre-refit window: time_mre=0.667 drift=-0.667
  generation 1 published (fit on 36 records, 4 observations, refit 15741 ms); service now at generation 1
  windowed time-MRE: generation 0 = 0.667 -> generation 1 = 0.000 (6532.4x better)
== multi-host fabric (ClusterFrontend, 2 replicas) ==
  qwen2-0.5b b=2 s=32 -> r1 (fingerprint 41d396c0...)
  qwen2-0.5b b=4 s=32 -> r1 (fingerprint 41d396c0...)
  [r1] qwen2-0.5b: 228.8 ms, 0.24 GiB (generation 1)
  [r1] qwen2-0.5b: 235.0 ms, 0.28 GiB (generation 1)
  fleet: 2 served across 2 replicas, generations=[1]
""",
}


def _workdir(tmp_path, saved=True):
    if saved:
        (tmp_path / "artifacts" / "torch").mkdir(parents=True)
        (tmp_path / "artifacts" / "torch" / "abacus.json").write_text("{}")
    return str(tmp_path)


def _transcript(name, **change):
    return TRANSCRIPTS[name] + _counter_line(name, **change) + "\n"


@pytest.mark.parametrize("name", sorted(TRANSCRIPTS))
def test_check_example_accepts_a_well_formed_run(tmp_path, name):
    assert cs.check_example(name, _transcript(name), CARD, _workdir(tmp_path)) \
        == {"launches": cs.EXAMPLE_LAUNCHES[name], "wall_s": 12.5}


def _drop(line):
    return lambda text: "".join(t for t in text.splitlines(True) if not t.startswith(line))


def _replace(old, new):
    def edit(text):
        assert old in text
        return text.replace(old, new)
    return edit


GA_BELOW_OPTIMAL = _replace("  GA      :     285.6 s", "  GA      :     285.3 s")
GA_ABOVE_RANDOM = _replace("  GA      :     285.6 s", "  GA      :     343.3 s")
NO_GENERATION = _replace(
    "  generation 1 published (fit on 36 records, 4 observations, refit 15741 ms); service now "
    "at generation 1\n  windowed time-MRE: generation 0 = 0.667 -> generation 1 = 0.000 "
    "(6532.4x better)\n",
    "  no generation published within 60 s (refit state: {})\n")

BROKEN = {
    "serve, a request missing": ("serve_lm_torch.py", _drop("  request 3")),
    "serve, no decode line": ("serve_lm_torch.py", _drop("prefill:")),
    "train, no loss line": ("train_lm_torch.py", _drop("loss ")),
    "train, a retry": ("train_lm_torch.py", _replace("(retries=0)", "(retries=1)")),
    "quickstart, a profile missing": ("quickstart_torch.py", _drop("  nin          b= 32")),
    "quickstart, no unseen config": ("quickstart_torch.py", _drop("  unseen config")),
    "quickstart, a step missing": ("quickstart_torch.py", _drop("  step   6")),
    "quickstart, a nan loss": ("quickstart_torch.py",
                               _replace("step   9 loss 6.2459", "step   9 loss nan")),
    "quickstart, no done": ("quickstart_torch.py", _drop("done.")),
    "predict, a profile missing": ("predict_and_schedule_torch.py", _drop("  nin b=64")),
    "predict, no refit section": ("predict_and_schedule_torch.py",
                                  _drop("== online refit (feedback -> new generation) ==")),
    "predict, no fleet section": ("predict_and_schedule_torch.py",
                                  _drop("== multi-host fabric")),
    "predict, no generation in 60 s": ("predict_and_schedule_torch.py", NO_GENERATION),
    "predict, GA below the optimum": ("predict_and_schedule_torch.py", GA_BELOW_OPTIMAL),
    "predict, GA above the random mean": ("predict_and_schedule_torch.py", GA_ABOVE_RANDOM),
    "predict, a replica at generation 0": (
        "predict_and_schedule_torch.py",
        _replace("generations=[1]", "generations=[0, 1]")),
    "predict, an answer at generation 0": (
        "predict_and_schedule_torch.py",
        _replace("0.28 GiB (generation 1)", "0.28 GiB (generation 0)")),
    "predict, not saved": ("predict_and_schedule_torch.py",
                           _drop("predictor saved to artifacts/torch/abacus.json")),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_check_example_rejects_a_broken_run(tmp_path, case):
    name, edit = BROKEN[case]
    with pytest.raises(RuntimeError, match="check failed"):
        cs.check_example(name, edit(TRANSCRIPTS[name]) + _counter_line(name) + "\n", CARD,
                         _workdir(tmp_path))


def test_check_example_rejects_a_predictor_not_written(tmp_path):
    with pytest.raises(RuntimeError, match="abacus.json"):
        cs.check_example("predict_and_schedule_torch.py",
                         _transcript("predict_and_schedule_torch.py"), CARD,
                         _workdir(tmp_path, saved=False))


@pytest.mark.parametrize("name", sorted(TRANSCRIPTS))
def test_check_example_rejects_another_device(tmp_path, name):
    text = _transcript(name).replace(f"device: {CARD}", "device: cpu", 1)
    with pytest.raises(RuntimeError, match="ran on"):
        cs.check_example(name, text, CARD, _workdir(tmp_path))


@pytest.mark.parametrize("name", sorted(TRANSCRIPTS))
def test_check_example_rejects_no_counter_line(tmp_path, name):
    with pytest.raises(RuntimeError, match="no launch counters"):
        cs.check_example(name, TRANSCRIPTS[name], CARD, _workdir(tmp_path))


WRONG_COUNTS = {
    "train, flash in a step": ("train_lm_torch.py", dict(flash_attention=1)),
    "quickstart, flash in a step": ("quickstart_torch.py", dict(flash_attention=20)),
    "quickstart, the scan in a step": ("quickstart_torch.py", dict(ssd_scan=10)),
    "train, the norm fell plain": ("train_lm_torch.py", dict(rmsnorm_fwd=0, rmsnorm_bwd=0)),
    "serve, attention fell plain": ("serve_lm_torch.py", dict(flash_attention=0)),
    "serve, decode norms fell plain": ("serve_lm_torch.py", dict(rmsnorm_fwd=5)),
    "predict, a launch": ("predict_and_schedule_torch.py", dict(rmsnorm_fwd=1)),
}


@pytest.mark.parametrize("case", sorted(WRONG_COUNTS))
def test_check_example_rejects_other_launch_counts(tmp_path, case):
    name, change = WRONG_COUNTS[case]
    with pytest.raises(RuntimeError, match="kernel launches"):
        cs.check_example(name, _transcript(name, **change), CARD, _workdir(tmp_path))


@pytest.mark.parametrize("name", sorted(TRANSCRIPTS))
def test_check_example_rejects_a_run_past_its_bound(tmp_path, name):
    text = _transcript(name, wall_s=cs.EXAMPLE_WALL_S[name] + 0.1)
    with pytest.raises(RuntimeError, match="past its"):
        cs.check_example(name, text, CARD, _workdir(tmp_path))
