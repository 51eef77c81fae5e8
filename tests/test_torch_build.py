"""The kernel library's name follows everything its build reads
(ops/_build.py): an edited header must not load a stale library. No nvcc
is needed: the path is a hash of the files, computed without building.
"""

import os

import pytest

from uniprot_kmer_based_clustering_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("not a source\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("edited", ["common.cuh", "a.cu"])
def test_library_path_follows_sources_and_headers(csrc, edited):
    before = _build.library_path()
    assert _build.library_path() == before
    (csrc / edited).write_text((csrc / edited).read_text() + "// v2\n")
    after = _build.library_path()
    assert after != before
    assert os.path.dirname(after) == _build.BUILD_DIR


def test_only_cu_files_are_compiled(csrc):
    """Headers are hashed but not handed to nvcc as translation units;
    other files are neither."""
    assert [os.path.basename(p) for p in _build._sources()] == ["a.cu"]
    before = _build.library_path()
    (csrc / "notes.txt").write_text("edited\n")
    assert _build.library_path() == before


def test_package_sources_include_the_shared_header():
    names = {os.path.basename(p) for p in _build._hashed_files()}
    assert {"stats_common.cuh", "stats_epilogue.cu", "popcount_sweep.cu",
            "tri_mxu.cu"} <= names
    assert "ukc_tri_mxu_sweep" in _build._SIGNATURES
