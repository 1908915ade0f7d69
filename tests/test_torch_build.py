"""The port's kernel build (``pygpr_torch/ops/_build.py``) on the CPU: which
inputs name a built library.  Nothing here needs ``nvcc``."""

import re
import shutil

import pytest

from pygpr_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_build`` reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", _build.SOURCES)
def test_library_path_follows_source_and_headers(name, csrc_copy):
    """Editing the source or a shared header gives another library name, so
    a stale library is never loaded; the same files give the same name."""
    first = _build.library_path(name)
    assert _build.library_path(name) == first
    header = csrc_copy / "small_chol.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = _build.library_path(name)
    assert after_header != first
    src = csrc_copy / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path(name) not in (first, after_header)


def test_sources_include_only_headers_of_csrc():
    """Every quoted include of a source is a header in ``csrc/`` (which the
    library's hash covers); the rest are the toolkit's."""
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert "small_chol.cuh" in headers
    for name in _build.SOURCES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        for inc in re.findall(r'#include\s+"([^"]+)"', text):
            assert inc in headers, (name, inc)


@pytest.mark.parametrize("mode", ["k2", "k3", "k6"])
def test_compare_calls_the_entry_the_source_keeps(mode):
    """K2, K3 and K6 keep their C entries across redesigns, so
    ``python -m pygpr_torch.bench.compare`` calls an earlier version of each
    by the entry the current source declares."""
    from pygpr_torch.bench import compare

    name, want = compare.OLD_ENTRIES[mode]
    source = (_build.CSRC / f"{compare.SOURCES[mode]}.cu").read_text()
    assert compare.entry_types(source, name) == want


@pytest.mark.parametrize("mode", ["k3", "k6"])
def test_compare_exits_without_a_card(mode, tmp_path, capsys):
    """The card-only comparison fails, and builds nothing, where there is
    no CUDA device."""
    import torch

    from pygpr_torch.bench import compare

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would build and time")
    assert compare.main(["--kernel", mode, "--old", str(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())
