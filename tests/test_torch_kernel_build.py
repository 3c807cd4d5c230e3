"""Which kernel library a source maps to (``_kernels._target``): the name
hashes the ``.cu`` source and every ``csrc/*.cuh`` header, so an edited
header rebuilds every library and an edited source only its own. Nothing is
compiled here."""

import pytest

from ray_tpu_torch import _kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text('#include "common.cuh"\nint b;\n')
    (tmp_path / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    return tmp_path


def _targets(csrc):
    return {src.name: _kernels._target(src) for src in sorted(csrc.glob("*.cu"))}


def test_target_names_carry_the_source_stem(csrc):
    names = _targets(csrc)
    assert names["a.cu"].name.startswith("a-") and names["a.cu"].suffix == ".so"
    assert names["a.cu"].parent == _kernels.BUILD_DIR
    assert names == _targets(csrc)  # stable while nothing changes


@pytest.mark.parametrize("edit", ["change", "add"])
def test_a_header_edit_renames_every_target(csrc, edit):
    before = _targets(csrc)
    if edit == "change":
        (csrc / "common.cuh").write_text("#pragma once\n// edited\n")
    else:
        (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _targets(csrc)
    assert all(after[n] != before[n] for n in before)


def test_a_source_edit_renames_only_its_own_target(csrc):
    before = _targets(csrc)
    (csrc / "a.cu").write_text('#include "common.cuh"\nint a = 1;\n')
    after = _targets(csrc)
    assert after["a.cu"] != before["a.cu"]
    assert after["b.cu"] == before["b.cu"]
