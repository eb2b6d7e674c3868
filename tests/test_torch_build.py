"""The port's CUDA build on the CPU: what ``kernels/build.py`` hands ``nvcc``
and how it names a library, without compiling anything.

The one-pass kernels share device helpers through ``kernels/csrc/*.cuh``:
every quoted include of a source must resolve there, ``nvcc`` must be given
that directory, and a library's name must change when a shared header does
(a stale build is never loaded after an edit to the header).
"""
import re
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402


@pytest.mark.parametrize("src", build.sources(), ids=lambda p: p.stem)
def test_quoted_includes_resolve_in_the_shared_directory(src):
    for name in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M):
        assert (build.INCLUDE_DIR / name).is_file(), f"{src.name} includes {name}"


@pytest.mark.parametrize("stem", ["linreg_stats", "nb_stats", "logreg_sgd"])
def test_one_pass_kernels_share_the_header(stem):
    src = next(p for p in build.sources() if p.stem == stem)
    assert '#include "onepass.cuh"' in src.read_text()
    assert "void stage_span" not in src.read_text()        # defined once, in the header
    assert "unsigned ticket_add" not in src.read_text()


def test_nvcc_is_given_the_shared_directory(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    cmd = build._nvcc_cmd(tmp_path / "k.cu", tmp_path / "k.so")
    assert cmd[0] == "nvcc" and cmd[-1] == str(tmp_path / "k.cu")
    i = cmd.index("-I")
    assert cmd[i + 1] == str(build.INCLUDE_DIR)
    assert "arch=compute_90a,code=sm_90a" in cmd


def test_library_name_follows_source_and_shared_headers(monkeypatch, tmp_path):
    include = tmp_path / "csrc"
    shutil.copytree(build.INCLUDE_DIR, include)
    monkeypatch.setattr(build, "INCLUDE_DIR", include)
    src = tmp_path / "k.cu"
    src.write_text('#include "onepass.cuh"\n')
    first = build.library_path(src)
    assert first == build.library_path(src) and first.name.startswith("k-")
    header = include / "onepass.cuh"
    header.write_text(header.read_text() + "// edited\n")
    second = build.library_path(src)
    assert second != first
    src.write_text(src.read_text() + "// edited\n")
    assert build.library_path(src) not in (first, second)
