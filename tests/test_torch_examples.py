"""The port's four examples (``examples/*_torch.py``), each run with
``--device cpu`` in a child process whose ``jax``, ``jaxlib`` and ``repro``
are made unimportable by a ``sitecustomize`` ahead of the sources on its
path, from a scratch working directory (what they write goes under its
``artifacts/torch/``).

- ``serve_lm_torch.py --batch 2 --prompt-len 8 --steps 4``: the reduced
  qwen2-0.5b served through the port's ``DecodeEngine``, its prefill and
  decode times, one line of ``steps + 1`` tokens a request;
- ``train_lm_torch.py --steps 4 --batch 2 --seq 32``: the ~100M-family
  qwen2 config through the port's ``Trainer``; the loss improves and the
  final checkpoint and the log are written;
- ``quickstart_torch.py`` and ``predict_and_schedule_torch.py`` (``slow``:
  ~45 s and ~4 min on an 8-core CPU): profile on the host, fit, predict,
  train; and profile, fit, schedule, admit, report and refit.

Beside them: no example names ``jax`` or ``repro`` in an import, and an
example asked for no device refuses to run where CUDA is missing rather
than fall back to the CPU.
"""

import ast
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart_torch.py", "serve_lm_torch.py", "train_lm_torch.py",
            "predict_and_schedule_torch.py")


def _run(tmp_path, example, *args, timeout=600):
    blocker = tmp_path / "blocker"
    blocker.mkdir(exist_ok=True)
    (blocker / "sitecustomize.py").write_text(
        "import sys\nfor name in ('jax', 'jaxlib', 'repro'):\n    sys.modules[name] = None\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocker), os.path.join(ROOT, "src")])}
    return subprocess.run([sys.executable, os.path.join(ROOT, "examples", example), *args],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _ok(out):
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[0] == "device: cpu", out.stdout[:200]
    return out.stdout


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_imports_no_jax_and_nothing_of_repro(example):
    with open(os.path.join(ROOT, "examples", example)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro")], names


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is available here")
def test_an_example_asked_for_no_device_needs_the_card(tmp_path):
    out = _run(tmp_path, "serve_lm_torch.py", "--steps", "1")
    assert out.returncode != 0
    assert "pass --device cpu" in out.stderr, out.stderr[-2000:]


def test_serve_lm_on_the_cpu(tmp_path):
    stdout = _ok(_run(tmp_path, "serve_lm_torch.py", "--batch", "2", "--prompt-len", "8",
                      "--steps", "4", "--device", "cpu"))
    assert "arch=qwen2-0.5b (reduced) batch=2" in stdout
    assert re.search(r"^prefill: [\d.]+ ms, decode: [\d.]+ ms/token$", stdout, re.M), stdout
    tokens = re.findall(r"^  request (\d): \[([\d, ]+)\]$", stdout, re.M)
    assert [i for i, _ in tokens] == ["0", "1"], stdout
    assert all(len(t.split(",")) == 4 + 1 for _, t in tokens)


def test_train_lm_on_the_cpu(tmp_path):
    stdout = _ok(_run(tmp_path, "train_lm_torch.py", "--steps", "4", "--batch", "2", "--seq",
                      "32", "--device", "cpu"))
    assert "params: 38.8M" in stdout
    first, last = map(float, re.search(r"^loss ([\d.]+) -> ([\d.]+) over 4 steps \(retries=0\)$",
                                       stdout, re.M).groups())
    assert last < first
    assert (tmp_path / "artifacts/torch/train_lm_log.jsonl").exists()
    assert os.listdir(tmp_path / "artifacts/torch/train_lm_ckpt")


@pytest.mark.slow
def test_quickstart_on_the_cpu(tmp_path):
    stdout = _ok(_run(tmp_path, "quickstart_torch.py", "--device", "cpu"))
    assert len(re.findall(r"^  (lenet5|squeezenet|nin) +b= *\d+ +[\d.]+ ms +[\d.]+ MiB$",
                          stdout, re.M)) == 9, stdout
    assert re.search(r"^  unseen config: predicted [\d.]+ ms \(measured [\d.]+ ms\)", stdout,
                     re.M), stdout
    assert len(re.findall(r"^  step +\d+ loss [\d.]+$", stdout, re.M)) == 4, stdout
    assert stdout.rstrip().endswith("done.")


@pytest.mark.slow
def test_predict_and_schedule_on_the_cpu(tmp_path):
    stdout = _ok(_run(tmp_path, "predict_and_schedule_torch.py", "--device", "cpu",
                      timeout=900))
    assert len(re.findall(r"^  \w+ b=\d+: \d+ ms$", stdout, re.M)) == 20, stdout
    assert "predictor saved to artifacts/torch/cpu/abacus.json" in stdout
    assert (tmp_path / "artifacts/torch/cpu/abacus.json").exists()
    for head in ("== makespans ==", "== admission control (AbacusServer gateway) ==",
                 "== streaming admission (AdmissionController) ==",
                 "== online refit (feedback -> new generation) ==",
                 "== multi-host fabric (ClusterFrontend, 2 replicas) =="):
        assert head in stdout, head
    assert re.search(r"^  GA      : +[\d.]+ s", stdout, re.M), stdout
    assert re.search(r"^  generation 1 published", stdout, re.M), stdout
    assert "fleet: 2 served across 2 replicas" in stdout
