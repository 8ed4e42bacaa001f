"""The CUDA build's staleness rule (dusk_plonk_torch/ops/_build.py): the
library is rebuilt whenever the build key -- a digest of the compiler
flags and every csrc source and header -- differs from the key stored
beside it.  No compiler runs here: the sources are copied into a
temporary directory and the library is a placeholder file."""

import shutil

import pytest

from dusk_plonk_torch.ops import _build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "LIB_PATH", str(lib))
    monkeypatch.setattr(_build, "KEY_PATH", str(lib) + ".key")
    return csrc, lib


def test_key_covers_sources_headers_and_flags(tree, monkeypatch):
    csrc, _ = tree
    key = _build.build_key()
    assert key == _build.build_key()
    header = csrc / "ec.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build.build_key()
    assert edited != key
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build.build_key() != edited


def test_stale_until_the_key_matches(tree):
    csrc, lib = tree
    assert _build._stale()                       # no library yet
    lib.write_bytes(b"")
    assert _build._stale()                       # no key beside it
    (csrc.parent / "lib.so.key").write_text(_build.build_key())
    assert not _build._stale()
    src = csrc / "ec_combine.cu"
    src.write_text(src.read_text() + "\n")
    assert _build._stale()                       # a source changed
