"""``bench/run.py`` prints no result where it must not run."""
import shutil
import subprocess
import sys

from bench import core


def run(cwd, *extra):
    return subprocess.run([sys.executable, "bench/run.py", "--workload", "paper-cov90",
                           "--seed", str(2**31 + 1), "--seconds", "1", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    # this test's machine has no CUDA card, or the run is refused for another
    # reason before it starts; either way nothing is printed as a result
    import torch

    if torch.cuda.is_available():
        return
    p = run(core.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    shutil.copy(core.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(core.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "cannot be imported" in p.stderr
