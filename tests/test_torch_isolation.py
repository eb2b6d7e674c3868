"""Import isolation of the PyTorch port: ``src/repro_torch/`` and
``chip_smoke.py`` import neither JAX nor the JAX package, and the port's
serving and analytics modules import with ``jax`` blocked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.serve, repro_torch.serve.engine, repro_torch.launch.serve\n"
            "import repro_torch.core.engine, repro_torch.data, repro_torch.launch.analytics\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
