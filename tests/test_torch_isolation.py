"""Import isolation of the PyTorch port: ``src/repro_torch/``,
``chip_smoke.py`` and ``decode_turns.py`` import neither JAX nor the JAX
package, and the port's
serving (sharded store and distribution layer included), analytics,
sharding, multipod, mesh and checkpoint modules import with ``jax``
blocked.  The port reads no setting from the environment."""
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
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
            + [ROOT / "chip_smoke.py", ROOT / "decode_turns.py"])


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


def _environment_reads(path: Path):
    """Lines of ``path`` that reach the process environment:
    ``os.environ`` or ``os.getenv``, or either imported from ``os``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if (isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv")
                and isinstance(node.value, ast.Name) and node.value.id == "os"):
            yield node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module == "os" and any(
                a.name in ("environ", "getenv") for a in node.names):
            yield node.lineno


def test_port_reads_no_environment():
    """Serving modes are constructor arguments and CLI flags: no module
    of the port reads the environment but the kernel build, which finds
    the CUDA toolkit through ``CUDA_HOME``."""
    build = ROOT / "src" / "repro_torch" / "kernels" / "build.py"
    assert list(_environment_reads(build))          # the scan sees a read
    reads = {str(p.relative_to(ROOT)): lines
             for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
             if p != build and (lines := list(_environment_reads(p)))}
    assert reads == {}


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.serve, repro_torch.serve.engine, repro_torch.serve.session\n"
            "import repro_torch.launch.serve, repro_torch.data.edits\n"
            "import repro_torch.serve.shard_store, repro_torch.distributed.compression\n"
            "import repro_torch.distributed.fault, repro_torch.distributed.transport\n"
            "import repro_torch.core.engine, repro_torch.data, repro_torch.launch.analytics\n"
            "import repro_torch.distributed.sharding, repro_torch.distributed.multipod\n"
            "import repro_torch.launch.mesh, repro_torch.train.checkpoint\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
