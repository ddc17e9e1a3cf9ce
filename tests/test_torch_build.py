"""The inputs of the port's kernel build (``kubeflow_tpu_torch/ops/_build.py``).

Each library's file name carries a hash of its source, every shared header
and the flags, so that an edited source or header is rebuilt. These tests pin
that every file in ``csrc/`` is an input of the build and that the name moves
with the bytes. No compiler is needed.

The port is imported inside the tests, as in the other port tests.
"""

import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

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


def test_sass_guard_covers_every_kernel():
    """chip_smoke.py's SASS guard (wgmma and TMA loads in the compiled
    library) names every kernel the build makes, so a new kernel cannot land
    on an older tensor-core path unnoticed. chip_smoke is loaded by path; it
    imports torch only inside its phases."""
    b = _build()
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(b.KERNELS) <= set(smoke.HOPPER_KERNELS)


def test_kernel_ab_refuses_without_a_card():
    """kernel_ab.py, which times kernel variants, fails where no CUDA card
    is visible instead of timing anything on the CPU."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "kernel_ab.py", "flash_bwd_dq", "variant.cu"],
        capture_output=True, text=True, timeout=120, cwd=root,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device is visible" in out.stderr
    assert out.stdout == ""


def test_snapshot_ab_refuses_without_a_card():
    """snapshot_ab.py, which times the snapshot loader on a 7B written on
    the card, fails where no CUDA card is visible and prints nothing."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "snapshot_ab.py", str(root)],
        capture_output=True, text=True, timeout=120, cwd=root,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device is visible" in out.stderr
    assert out.stdout == ""


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


def _c_fields(header: str, struct: str) -> list[tuple[str, str]]:
    """(name, C type) of each field of ``struct`` in ``header``, in order;
    a declaration of several names gives each the declaration's type."""
    bodies = re.findall(rf"struct {struct} {{(.*?)\n}};", header, re.S)
    assert len(bodies) == 1, f"struct {struct} defined {len(bodies)} times"
    fields = []
    for decl in re.sub(r"//[^\n]*", "", bodies[0]).split(";"):
        if not decl.strip():
            continue
        first, *more = decl.replace("*", " * ").split(",")
        words = first.split()
        ctype = " ".join(words[:-1]).replace(" *", "*")
        fields += [(name.strip(), ctype) for name in (words[-1], *more)]
    return fields


@pytest.mark.parametrize("struct", ["TensorRef", "FlashArgs"])
def test_flash_ctypes_mirror_the_header(struct):
    """The ctypes structures the flash wrappers pass to the kernels hold the
    same fields, in the same order and of the same C types, as the structs
    in flash_common.cuh."""
    import ctypes

    from kubeflow_tpu_torch.ops import flash_attention as fa

    b = _build()
    header = (b.CSRC / "flash_common.cuh").read_text()
    ctypes_of = {"void*": ctypes.c_void_p, "float*": ctypes.c_void_p,
                 "long long": ctypes.c_longlong, "int": ctypes.c_int,
                 "float": ctypes.c_float, "TensorRef": fa._TensorRef}
    mirror = {"TensorRef": fa._TensorRef, "FlashArgs": fa._FlashArgs}[struct]
    fields = _c_fields(header, struct)
    assert [n for n, _ in fields] == [n for n, _ in mirror._fields_]
    assert [ctypes_of[t] for _, t in fields] == [t for _, t in mirror._fields_]
