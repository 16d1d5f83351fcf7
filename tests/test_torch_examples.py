"""The port's quickstart, mixed-pattern serving and training examples run on
the CPU at a small size, as the JAX package's CI runs its examples: each
exits 0 and prints its last line; the training example's loss is printed,
finite, and falls over its few steps.  The serving example splits every dispatch's K
over two CPU shards (``--devices 2``) and checks its own windows: every
request solved, the warm window analyzing nothing, the fresh service
loading every plan from disk."""
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,args,last", [
    ("quickstart_torch.py", ["--device", "cpu", "--n", "400"], "OK"),
    ("mixed_pattern_serving_torch.py",
     ["--requests", "9", "--batch-size", "4", "--devices", "2",
      "--device", "cpu", "--scale", "0.5"], "MIXED_PATTERN_SERVING_OK"),
    ("train_lm_torch.py",
     ["--device", "cpu", "--steps", "4"], "OK"),
])
def test_torch_example_runs(script, args, last, tmp_path):
    if "--requests" in args:
        args = args + ["--cache-dir", str(tmp_path / "plans")]
    if script.startswith("train_"):
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                       script), *args],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == last
    if script.startswith("train_"):                 # "loss: a → b over n"
        line = next(ln for ln in out.stdout.splitlines()
                    if ln.startswith("loss:"))
        first, last_loss = (float(w) for w in line.split()[1:4:2])
        assert np.isfinite([first, last_loss]).all() and last_loss < first
