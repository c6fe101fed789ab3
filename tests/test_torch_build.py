"""The build of the port's CUDA kernels, as far as it runs without ``nvcc``:
what a library's file name hashes, and the compiler's command line."""

import shutil

import pytest

from reductive_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy)
    return copy


@pytest.mark.parametrize("name", _build.SOURCES)
def test_the_target_of_the_package_is_that_of_an_equal_copy(csrc_copy, name):
    src, lib = _build._target(name, csrc_copy)
    assert src == csrc_copy / f"{name}.cu"
    assert lib == _build._target(name)[1]
    assert lib.parent == _build._BUILD and lib.name.startswith(f"lib{name}_")


@pytest.mark.parametrize("name", _build.SOURCES)
def test_an_edited_header_changes_every_target(csrc_copy, name):
    before = _build._target(name, csrc_copy)[1]
    headers = sorted(csrc_copy.glob("*.cuh"))
    assert headers, "the package has a header that its sources include"
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = _build._target(name, csrc_copy)[1]
    assert after != before
    # A new header counts too, and so does its name.
    (csrc_copy / "new.cuh").write_text("// edited\n")
    third = _build._target(name, csrc_copy)[1]
    assert third not in (before, after)
    (csrc_copy / "new.cuh").rename(csrc_copy / "renamed.cuh")
    assert _build._target(name, csrc_copy)[1] not in (before, after, third)


def test_an_edited_source_changes_its_own_target_only(csrc_copy):
    before = {name: _build._target(name, csrc_copy)[1] for name in _build.SOURCES}
    path = csrc_copy / "stats.cu"
    path.write_text(path.read_text() + "\n// edited\n")
    after = {name: _build._target(name, csrc_copy)[1] for name in _build.SOURCES}
    assert [name for name in _build.SOURCES if after[name] != before[name]] == ["stats"]


def test_nvcc_is_given_the_include_path_of_the_sources(monkeypatch, tmp_path):
    started = []

    class Process:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            started.append(cmd)

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build, "_BUILD", tmp_path / "_build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Process)
    name, lib, tmp, proc = _build._start_build("stats", False)
    assert proc is not None and len(started) == 1
    cmd = started[0]
    assert cmd[cmd.index("-I") + 1] == str(_build._CSRC)
    assert cmd[-1] == str(_build._CSRC / "stats.cu") and cmd[cmd.index("-o") + 1] == str(tmp)
    assert "arch=compute_90a,code=sm_90a" in cmd


# Each source with what its earlier design had and the shared routine replaced:
# the statistics kernel's scan over every code in every thread, the encode's
# chain of FMAs over rows kept in registers.
@pytest.mark.parametrize("name,gone", [("stats", "scan_tile"), ("encode", "xr[r]")],
                         ids=["stats.cu", "encode.cu"])
def test_the_statistics_source_includes_the_assignment_header(name, gone):
    text = (_build._CSRC / f"{name}.cu").read_text()
    assert '#include "assign_tile.cuh"' in text
    assert (_build._CSRC / "assign_tile.cuh").exists()
    # One routine assigns a row tile and flags its rows in both kernels.
    for routine in ("copy_rows<", "assign_rows<", "flag_row<"):
        assert f"assign_tile::{routine}" in text
    assert gone not in text
