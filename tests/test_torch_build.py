"""The port's kernel build cache: a library is named by a hash of its
source, of every csrc/ header the source includes, and of the flags, so
an edit to a shared header rebuilds every kernel that includes it. (No
nvcc needed: only the names are computed here.)"""

import shutil

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    _build,
)


def test_sources_name_their_headers():
    for name in ("flash_fwd", "flash_bwd"):
        files = _build.source_files(name)
        assert files[0] == _build.SOURCES[name]
        assert {"keep_mask.cuh", "flash_tile.cuh"} <= set(files)
    # The tensor-core header is shared by K1 and K2/K3, not by the fold.
    assert "mma_bf16.cuh" in _build.source_files("flash_fwd")
    assert "mma_bf16.cuh" in _build.source_files("flash_bwd")
    assert "mma_bf16.cuh" not in _build.source_files("fold")


def test_editing_a_shared_header_renames_every_library_using_it(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    assert before == {name: _build.library_path(name) for name in _build.SOURCES}

    header = csrc / "keep_mask.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert after["flash_fwd"] != before["flash_fwd"]
    assert after["flash_bwd"] != before["flash_bwd"]

    # A source's own edit renames that library only.
    src = csrc / "flash_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {name: _build.library_path(name) for name in _build.SOURCES}
    assert again["flash_fwd"] == after["flash_fwd"]
    assert again["flash_bwd"] != after["flash_bwd"]


def test_editing_the_tensor_core_header_renames_the_forward_library(tmp_path, monkeypatch):
    """Renames the forward library and, since K2 and K3 include the
    header too, the backward library; the fold's stays."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    header = csrc / "mma_bf16.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert after["flash_fwd"] != before["flash_fwd"]
    assert after["flash_bwd"] != before["flash_bwd"]
    assert after["fold"] == before["fold"]
