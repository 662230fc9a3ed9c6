"""Nothing the harness imports is JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import core

HERE = Path(core.HERE)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("folder", ["reference", "gen"])
def test_reference_and_generators_import_nothing_of_the_port(folder):
    for path in sorted((HERE / folder).glob("*.py")):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in core.FORBIDDEN + ("peritext_tpu_torch", "torch"), (path, name)


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in sorted(HERE.rglob("*.py")):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in core.FORBIDDEN, (path, name)


def test_what_a_run_loads():
    """Every module a run imports, the port's entries included, loads
    neither JAX nor the JAX package."""
    code = ("import sys; import portbench.run, portbench.control, portbench.knee; "
            "import portbench.drivers.epochs, portbench.drivers.sweep, portbench.drivers.serve; "
            "import peritext_tpu_torch, peritext_tpu_torch.ops.universe, peritext_tpu_torch.parallel.stream, "
            "peritext_tpu_torch.runtime.serve, peritext_tpu_torch.ops.encode; "
            "from portbench import core; print(','.join(core.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=core.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "peritext_tpu_torch_lookalike", sys)
    assert "peritext_tpu_torch_lookalike" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "peritext_tpu.ops", sys)
    assert "peritext_tpu.ops" in core.forbidden_modules()
