"""The port imports neither JAX nor anything of the JAX package: no module
of ``vidtome_torch`` and not ``chip_smoke.py``, not even the JAX package's
JAX-free config and I/O modules (the port has its own).

A scan of the sources (not of ``sys.modules``: JAX may already be loaded in
the test process)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "vidtome_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vidtome_tpu")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_has_sources():
    assert len(PORT_FILES) >= 15


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)
