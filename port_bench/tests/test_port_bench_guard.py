"""The import guard, the sources' imports, and the runs that must print no result."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from port_bench import guard

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden(["hifigan_tpu_torch", "hifigan_tpu_torch.models", "jaxtyping",
                            "flaxen", "torch", "port_bench"]) == []
    assert guard.forbidden(["hifigan_tpu.x"]) == ["hifigan_tpu"]
    assert guard.forbidden(["jax.numpy", "jaxlib", "flax.linen", "hifigan_tpu"]) == [
        "flax", "hifigan_tpu", "jax", "jaxlib"]


def test_guard_fails_on_an_imported_jax_package_module():
    """A process that imports ``hifigan_tpu.x`` is caught by whole name."""
    code = ("import sys, types; sys.path.insert(0, %r)\n"
            "sys.modules['hifigan_tpu.x'] = types.ModuleType('hifigan_tpu.x')\n"
            "import hifigan_tpu_torch.config\n"
            "from port_bench import guard; print(guard.forbidden())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "['hifigan_tpu']"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_the_jax_package_or_bench():
    for path in PKG.rglob("*.py"):
        found = _imports(path) & {"jax", "jaxlib", "flax", "hifigan_tpu", "bench"}
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        assert "hifigan_tpu_torch" not in _imports(path), path
    for path in (PKG / "costs").rglob("*.py"):
        assert "hifigan_tpu_torch" not in _imports(path), path


def _run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "port_bench/run.py", "--workload", "v1_serve_b1",
                           "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def _printed_result(out: str) -> bool:
    lines = out.strip().splitlines()
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except ValueError:
        return False


def test_run_without_a_card_fails_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and not _printed_result(out.stdout)


def test_run_without_the_program_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PKG, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not _printed_result(out.stdout)
