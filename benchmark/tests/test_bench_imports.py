"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Top-level module names are compared
whole: the port's name begins with the JAX package's."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark import harness

BENCH = harness.ROOT / "benchmark"


def _imports(path) -> set:
    """Top-level names of the modules a file imports (relative imports as '.')."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(harness.FOREIGN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = _imports(path)
        assert "sgpt_tpu_torch" not in names and "benchmark" not in names, path
        assert names <= {".", "__future__", "contextlib", "hashlib", "math", "typing", "torch"}, \
            (path, names)


def test_a_process_that_loads_every_module_of_a_run_holds_no_jax():
    """Imports what a run imports (the harness, every driver, every metric
    reader and the program's modules the drivers use) in a fresh process,
    which then lists every loaded module of a foreign top-level name."""
    code = f"""
import sys, json
sys.path.insert(0, {str(harness.ROOT)!r})
from benchmark import harness, roofline, tracing, control, sweep
import benchmark.drivers.encode, benchmark.drivers.rerank, benchmark.drivers.search
from pathlib import Path
for p in Path({str(BENCH / 'metrics')!r}).glob('[a-z]*.py'):
    harness.reader(p.stem)
import sgpt_tpu_torch.encoder, sgpt_tpu_torch.crossencoder, sgpt_tpu_torch.serving
import sgpt_tpu_torch.index, sgpt_tpu_torch.models.hf_loader, sgpt_tpu_torch.ops.mips
print(json.dumps(harness.foreign_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_foreign_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sgpt_tpu_fake_probe", object())
    assert "sgpt_tpu_fake_probe" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "sgpt_tpu.fake_probe", object())
    assert "sgpt_tpu.fake_probe" in harness.foreign_modules()
