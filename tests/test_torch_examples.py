"""The port's training entry points as a user runs them, on the CPU, as
subprocesses: ``examples/train_oracle_torch.py`` trains the Oracle for a
few steps and answers a BaS COUNT with it, and the training launcher
(``python -m repro_torch.launch.train``) started twice resumes from its
own checkpoint."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(argv, timeout=300):
    # two threads a process: the test runner's workers share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_oracle_example_runs_on_the_cpu():
    out = _run(["examples/train_oracle_torch.py", "--device", "cpu", "--steps", "3",
                "--batch", "4", "--max-len", "48", "--budget", "200"])
    assert "trained 3 steps" in out
    assert "BaS with learned Oracle: COUNT ~=" in out


def test_train_launcher_resumes_from_its_checkpoint(tmp_path):
    base = ["-m", "repro_torch.launch.train", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    first = _run(base + ["--steps", "3"])
    assert "resumed" not in first and "done at step 3" in first
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    second = _run(base + ["--steps", "5"])
    assert f"resumed at step 3 from {tmp_path}" in second
    assert "done at step 5" in second
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
