"""The port's quickstart and mixed-pattern serving examples run on the CPU
at a small size, as the JAX package's CI runs its examples: each exits 0
and prints its last line.  The serving example splits every dispatch's K
over two CPU shards (``--devices 2``) and checks its own windows: every
request solved, the warm window analyzing nothing, the fresh service
loading every plan from disk."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,args,last", [
    ("quickstart_torch.py", ["--device", "cpu", "--n", "400"], "OK"),
    ("mixed_pattern_serving_torch.py",
     ["--requests", "9", "--batch-size", "4", "--devices", "2",
      "--device", "cpu", "--scale", "0.5"], "MIXED_PATTERN_SERVING_OK"),
])
def test_torch_example_runs(script, args, last, tmp_path):
    if "--requests" in args:
        args = args + ["--cache-dir", str(tmp_path / "plans")]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                       script), *args],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == last
