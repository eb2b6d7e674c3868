"""The benchmark's own tests: ``python -m pytest -q bench/tests`` from the
root of the repository (the tier-1 suite, ``tests/``, does not collect
them).  Tests marked ``gpu`` need the card and skip elsewhere."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
