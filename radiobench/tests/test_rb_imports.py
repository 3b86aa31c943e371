"""Nothing the benchmark imports is JAX or the JAX package, compared by
the top-level name as a whole (the port's name begins with the JAX
package's), and the references import nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from radiobench import run

HERE = Path(__file__).resolve().parents[1]


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not imported(path) & set(run.FORBIDDEN), path


def test_references_import_nothing_of_the_port():
    for path in (HERE / "reference").glob("*.py"):
        assert imported(path) <= {"__future__", "contextlib", "math",
                                  "numpy", "torch", "radiobench"}, path
        assert "grbaz_tpu_torch" not in path.read_text()


def test_top_level_names_compared_whole(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "grbaz_tpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "grbaz_tpu.ops", sys)
    assert run.forbidden_modules() == ["grbaz_tpu"]


def test_a_run_loads_no_jax():
    """A whole run in a fresh interpreter leaves none of them loaded."""
    code = (
        "import time, torch\n"
        "from radiobench import manifest, run\n"
        "t = dict(loop='closed', streams=1, block=4096, ring=2,"
        " warmup_blocks=1, checks=1)\n"
        "res, _ = run.run_cell(manifest.cell('rtl_fm.replay'), 3, 0.3, False,"
        " torch.device('cpu'), time.perf_counter(), traffic=t)\n"
        "print(res['correct'], run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "[]"]
