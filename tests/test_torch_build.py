"""The inputs of the port's kernel build (``kubeflow_tpu_torch/ops/_build.py``).

Each library's file name carries a hash of its source, every shared header
and the flags, so that an edited source or header is rebuilt. These tests pin
that every file in ``csrc/`` is an input of the build and that the name moves
with the bytes. No compiler is needed.

The port is imported inside the tests, as in the other port tests.
"""

import shutil

import pytest


def _build():
    from kubeflow_tpu_torch.ops import _build

    return _build


def test_every_header_is_hashed():
    b = _build()
    headers = sorted(p.name for p in b.CSRC.glob("*.cuh"))
    assert headers == sorted(b.HEADERS)


def test_every_source_is_built():
    b = _build()
    sources = sorted(p.name for p in b.CSRC.glob("*.cu"))
    assert sources == sorted(b.KERNELS.values())
    for name, source in b.KERNELS.items():
        assert f"{name}_launch" in (b.CSRC / source).read_text()


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """_build with CSRC pointed at a copy of csrc/ in tmp_path."""
    b = _build()
    copy = tmp_path / "csrc"
    shutil.copytree(b.CSRC, copy)
    monkeypatch.setattr(b, "CSRC", copy)
    return b, copy


def test_library_path_is_stable(csrc_copy):
    b, _ = csrc_copy
    first = {name: b.library_path(name) for name in b.KERNELS}
    assert first == {name: b.library_path(name) for name in b.KERNELS}
    assert len(set(first.values())) == len(first)
    assert all(p.parent == b.BUILD_DIR for p in first.values())


@pytest.mark.parametrize("header", ["flash_common.cuh", "hopper_gemm.cuh"])
def test_library_path_follows_header_bytes(csrc_copy, header):
    b, copy = csrc_copy
    before = {name: b.library_path(name) for name in b.KERNELS}
    with open(copy / header, "a") as fh:
        fh.write("\n// edited\n")
    after = {name: b.library_path(name) for name in b.KERNELS}
    # every library hashes every header: each one is rebuilt
    assert all(after[name] != before[name] for name in b.KERNELS)


def test_library_path_follows_source_bytes(csrc_copy):
    b, copy = csrc_copy
    before = {name: b.library_path(name) for name in b.KERNELS}
    with open(copy / b.KERNELS["gmm"], "a") as fh:
        fh.write("\n// edited\n")
    after = {name: b.library_path(name) for name in b.KERNELS}
    assert after["gmm"] != before["gmm"]
    assert {n: p for n, p in after.items() if n != "gmm"} == {
        n: p for n, p in before.items() if n != "gmm"}
