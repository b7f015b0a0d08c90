"""What a run may load: nothing of JAX or of the JAX package in the run's
process, and nothing of the program in the reference."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

from wsnbench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _python(code: str, cwd=ROOT, timeout=600):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_a_run_loads_no_jax_nor_the_jax_package():
    """A whole tiny run of every cell, the way the harness loads it, then
    the loaded modules' top-level names compared whole (``repro_torch``
    begins with ``repro``)."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'src')\n"
        "import torch\n"
        "from wsnbench import harness, run, control\n"
        "from wsnbench.tests.tiny import CELLS, tiny_cell, run_tiny\n"
        "for c in CELLS:\n"
        "    out = run_tiny(tiny_cell(c), seconds=0.05)\n"
        "    assert out['correct'], (c, out['checks'])\n"
        "    cell = harness.find_cell(c)\n"
        "    for m in cell.metrics(False) + cell.metrics(True):\n"
        "        harness.metric_reader(cell, m['name'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_modules())\n")
    res = _python(code)
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = eval(res.stdout.splitlines()[-2])
    assert "repro_torch" in loaded and "torch" in loaded
    assert not FORBIDDEN & set(loaded), FORBIDDEN & set(loaded)
    assert res.stdout.splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    ref = ROOT / "wsnbench" / "reference"
    allowed = {"__future__", "contextlib", "dataclasses", "statistics",
               "typing", "torch", "wsnbench"}
    for path in sorted(ref.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
                if node.module == "wsnbench":
                    assert all(a.name == "reference" for a in node.names)
            for n in names:
                top = n.split(".")[0]
                assert top in allowed, (path.name, n)
                if top == "wsnbench":
                    assert n.startswith("wsnbench.reference"), (path.name, n)
    res = _python("import sys\n"
                  "import wsnbench.reference.fleet, wsnbench.reference.pim\n"
                  "import wsnbench.reference.band\n"
                  "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(eval(res.stdout.splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"repro_torch"}), loaded


def test_no_result_without_a_card():
    res = _python("import sys; sys.argv = ['run', '--workload', "
                  "'flat-stream', '--seed', '1', '--seconds', '1', "
                  "'--trace', '0']\n"
                  "from wsnbench import run\n"
                  "import torch\n"
                  "torch.cuda.is_available = lambda: False\n"
                  "sys.exit(run.main())\n")
    assert res.returncode != 0 and res.stdout == ""
    assert "needs 1 CUDA card" in res.stderr


def test_no_result_in_a_folder_of_the_benchmark_alone(tmp_path):
    """BENCHMARK.json and the files under its paths, and nothing else:
    the program is missing, so the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "wsnbench", tmp_path / "wsnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\n"
            "sys.argv = ['run', '--workload', 'flat-stream', '--seed', '1',"
            " '--seconds', '1', '--trace', '0']\n"
            "import torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "from wsnbench import run\n"
            "sys.exit(run.main())\n")
    res = _python(code, cwd=tmp_path)
    assert res.returncode != 0 and res.stdout == ""
    assert "repro_torch" in res.stderr
