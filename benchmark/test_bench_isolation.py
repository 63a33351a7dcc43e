"""What the benchmark's process loads: nothing of JAX or of the JAX package
(top-level names compared whole, since ``muscato_tpu_torch`` begins with
``muscato_tpu``), and a reference that loads nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from benchmark.bench_testing import HERE, ROOT, tiny_copy
from benchmark.harness import runner


def _child(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tmp_path):
    root, bench, cell = tiny_copy(tmp_path, reads=1500, shift=50)
    got = _child(
        "import io, json, sys, time\n"
        "from benchmark.harness import runner\n"
        f"rc = runner.run({root!r}, {cell!r}, 5, 0.2, True, t_start=time.perf_counter(),\n"
        f"               device='cpu', bench_dir={bench!r}, out=io.StringIO())\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps(dict(rc=rc, tops=tops)))\n")
    assert got["rc"] == 0
    assert "muscato_tpu_torch" in got["tops"]
    assert not set(got["tops"]) & set(runner.FORBIDDEN)


def test_the_reference_loads_nothing_of_either_package():
    got = _child("import json, sys\nimport benchmark.harness.reference\n"
                 "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not set(got) & {*runner.FORBIDDEN, "muscato_tpu_torch"}
    with open(os.path.join(HERE, "harness", "reference.py")) as f:
        tree = ast.parse(f.read())
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert imported <= {"__future__", "math", "numpy", "torch"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "muscato_tpu_torch.engine", object())
    monkeypatch.setitem(sys.modules, "muscato_tpux", object())
    assert "muscato_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "muscato_tpu.ops", object())
    assert "muscato_tpu" in runner.forbidden_modules()
