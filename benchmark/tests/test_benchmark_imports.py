"""What the benchmark loads, and that it needs a card."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "vidtome_tpu"}

_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
before = set(sys.modules)
import benchmark.run as run
from benchmark.harness import check, inputs, program, trace, weights
import benchmark.calibrate
from benchmark.counts import peaks, shapes
import importlib, pathlib
for p in sorted(pathlib.Path({root!r}, "benchmark", "metrics").glob("*.py")):
    importlib.import_module("benchmark.metrics." + p.stem)
import vidtome_torch.pipeline.generator, vidtome_torch.pipeline.inverter
import vidtome_torch.core.merge, vidtome_torch.models.registry
print(json.dumps(sorted(set(sys.modules) - before)))
"""


def test_nothing_loaded_is_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(ROOT))],
        capture_output=True, text=True, cwd=ROOT / "benchmark", timeout=300,
        check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in loaded}
    assert "vidtome_torch" in tops and "benchmark" in tops
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from benchmark import run

    monkeypatch.setitem(sys.modules, "vidtome_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxfoo", object())
    found = run.forbidden_modules()
    assert "vidtome_tpu_like" not in found and "jaxfoo" not in found
    monkeypatch.setitem(sys.modules, "vidtome_tpu.core", object())
    assert "vidtome_tpu" in run.forbidden_modules()


@pytest.mark.parametrize("path", sorted(
    (ROOT / "benchmark" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & (FORBIDDEN | {"vidtome_torch"}), names


def test_harness_refuses_to_run_without_a_card():
    """No CUDA device here: the harness exits non-zero and prints no
    result; it does not fall back to the CPU."""
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sd15-exact-cb-32f", "--seed", "3", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
