"""``kernels/_build.py`` keys a kernel library on everything that builds it:
the source, the ``csrc`` headers it includes and the flags, so that an edit
to any of them builds afresh instead of loading a stale library. Runs
without nvcc: only the library's name is computed."""

import os
import shutil

import pytest

from consistent__style_transfer_torch.kernels import _build


def _csrc_copy(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    (csrc / "unrelated.cuh").write_text("// included by no source\n")
    return csrc


def test_library_path_follows_included_headers_only(tmp_path):
    csrc = _csrc_copy(tmp_path)
    before = _build.library_path("decode_step", str(csrc))
    assert before == _build.library_path("decode_step")  # same content, same name
    (csrc / "unrelated.cuh").write_text("// edited\n")
    assert _build.library_path("decode_step", str(csrc)) == before
    with open(csrc / "hopper_ptx.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("decode_step", str(csrc)) != before


def test_local_headers_are_transitive_and_skip_system_headers(tmp_path):
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n#include "b.cuh"\n#include "cuda_bf16.h"\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n  #  include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text('#include "b.cuh"\n')  # a cycle ends
    (tmp_path / "d.cuh").write_text("// not included\n")
    headers = _build.local_headers(str(tmp_path / "a.cu"), str(tmp_path))
    assert [os.path.basename(p) for p in headers] == ["b.cuh", "c.cuh"]


@pytest.mark.parametrize("name", ["decode_step", "sinkhorn"])
def test_library_path_follows_source_flags(monkeypatch, name):
    before = _build.library_path(name)
    monkeypatch.setitem(_build.SOURCE_FLAGS, name, (*_build.SOURCE_FLAGS.get(name, ()), "-lm"))
    assert _build.library_path(name) != before
