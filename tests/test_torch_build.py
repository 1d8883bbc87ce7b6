"""The port's kernel build, as far as a machine without nvcc can hold it:
every file under ``dbcsr_tpu_torch/csrc/`` is compiled or hashed into the
library's name and ships as package data, an edited header changes the
name (so a stale library cannot load), and the wrappers' 16-byte alignment
rule for tile stores (the kernels copy with ``cp.async`` and 128-bit loads);
every product kernel source launches through the one routine choice of
``tile_kernel.cuh``, and the sub-tile grid of the design it replaced is gone;
the eps filter's two kernels (``block_filter.cu``) are the only others.
"""
import fnmatch
import os
import re
import shutil

import pytest
import torch

from dbcsr_tpu_torch import _build
from dbcsr_tpu_torch.mm.kernels import check_cuda_operands, check_store_alignment

try:
    import tomllib
except ImportError:  # Python < 3.11
    tomllib = None

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the sources of the product kernels; the two other sources hold the eps
#: filter's kernels and the tensor refold's, which multiply nothing
FILTER_SOURCE = "block_filter.cu"
REFOLD_SOURCE = "block_refold.cu"
PRODUCT_SOURCES = [s for s in _build._SOURCES if s not in (FILTER_SOURCE, REFOLD_SOURCE)]


def test_every_csrc_file_is_built_or_hashed():
    files = sorted(os.listdir(_build._CSRC))
    assert files, "csrc/ is empty"
    assert sorted(_build._SOURCES + _build._HEADERS) == files
    assert all(f.endswith(".cu") for f in _build._SOURCES)
    assert all(f.endswith(".cuh") for f in _build._HEADERS)
    # the headers of the redesigned kernels are among them
    assert {"tile_product.cuh", "tile_ring.cuh", "tile_product_f32.cuh",
            "tile_mma_f64.cuh", "tile_kernel.cuh"} <= set(_build._HEADERS)


def _csrc_text(name):
    with open(os.path.join(_build._CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("name", PRODUCT_SOURCES)
def test_every_kernel_source_launches_through_tile_kernel(name):
    """Each ``.cu`` defines one extern "C" stack product, describes it as a
    Job struct and launches it with ``launch_tile_kernel``, which picks the
    routine from the input type and the tile edge; none has a ``__global__``
    kernel or a ``<<<...>>>`` launch of its own."""
    text = _csrc_text(name)
    assert '#include "tile_kernel.cuh"' in text
    assert len(re.findall(r'extern "C" int dbcsr_torch_\w+_matmul\w*\(', text)) == 1
    assert len(re.findall(r"\blaunch_tile_kernel<", text)) == 1
    assert "__global__" not in text and "<<<" not in text
    code = re.sub(r"//[^\n]*", "", text)
    assert not re.search(r"\btile_run\w*\s*<|\btile_run\w*\s*\(", code), (
        "a kernel source names a device routine: tile_kernel.cuh chooses it")
    job = re.findall(r"\b(\w+Job)\b", code)
    assert job, "no Job"
    if name not in ("stack_matmul.cu", "stack_matmul_f64.cu"):  # StackJob is tile_kernel.cuh's
        assert re.search(r"struct %s\b" % job[0], code)


def test_the_sub_tile_grid_is_gone():
    """The design the pipelined routines replaced cut a C tile into
    sub-tiles of 64 (``SubTile``, ``tile_grid``) and ran ``tile_run`` on each
    at every tile edge; now ``tile_run`` serves whole tiles of T <= 32 and is
    called from ``tile_kernel.cuh`` alone."""
    for name in sorted(os.listdir(_build._CSRC)):
        text = _csrc_text(name)
        assert "SubTile" not in text and "tile_grid" not in text, name
        code = re.sub(r"//[^\n]*", "", text)
        callers = re.findall(r"\btile_run<", code)
        assert len(callers) == (1 if name == "tile_kernel.cuh" else 0), name
    kernel = _csrc_text("tile_kernel.cuh")
    assert "static_assert(T <= 32" in kernel
    assert "if constexpr (T < 64)" in kernel
    # the routine's own kernels are the only __global__ products of the
    # library; the filter's two kernels and the refold's are the only other
    # __global__s
    globals_ = [n for n in sorted(os.listdir(_build._CSRC)) if "__global__" in _csrc_text(n)]
    assert globals_ == [FILTER_SOURCE, REFOLD_SOURCE, "tile_kernel.cuh"]


@pytest.mark.skipif(tomllib is None, reason="tomllib needs Python 3.11")
def test_every_csrc_file_is_package_data():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]["dbcsr_tpu_torch"]
    for name in os.listdir(_build._CSRC):
        assert any(fnmatch.fnmatch(f"csrc/{name}", pat) for pat in data), name


@pytest.mark.parametrize("name", sorted(os.listdir(_build._CSRC)))
def test_editing_a_file_changes_the_library_name(name, tmp_path, monkeypatch):
    """One byte more in any source or header, on a copy of csrc/, gives
    another ``_library_path()``."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy)
    monkeypatch.setattr(_build, "_CSRC", str(copy))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    before = _build._library_path()
    assert before == _build._library_path()  # stable for unchanged files
    with open(copy / name, "ab") as f:
        f.write(b"\n")
    after = _build._library_path()
    assert after != before and os.path.dirname(after) == str(tmp_path / "_build")


def test_flags_enter_the_library_name(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    before = _build._library_path()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DX=1",))
    assert _build._library_path() != before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_store_alignment_rule(dtype):
    """A contiguous view that starts off a 16-byte boundary is refused; the
    same tiles at the start of a tensor pass."""
    tile = 16
    flat = torch.zeros(3 * tile * tile + 8, dtype=dtype)
    good = flat[: 3 * tile * tile].view(3, tile, tile)
    check_store_alignment(good, good, "test")
    shift = 1 if dtype != torch.bfloat16 else 2  # 8 bytes (float64), 4 (float32, bf16)
    bad = flat[shift: shift + 3 * tile * tile].view(3, tile, tile)
    assert bad.is_contiguous() and bad.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        check_store_alignment(bad, good, "test")
    with pytest.raises(ValueError, match="16-byte"):
        check_store_alignment(good, bad, "test")
    with pytest.raises(ValueError, match="contiguous"):
        check_store_alignment(good.transpose(1, 2), good, "test")


def test_cuda_checks_refuse_cpu_tensors_before_anything_else():
    """On the CPU the wrappers never reach the CUDA checks (they run the
    plain versions); called directly, the checks name the device."""
    a = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        check_cuda_operands(a, a, (), "test", (torch.float32,))


def test_complex_kernels_are_built_and_hashed():
    """KC1 (complex64) and KC2 (complex128): their sources are compiled into
    the library, their routines' headers enter its name, and each entry
    point has a ctypes signature and a wrapper that names it."""
    from dbcsr_tpu_torch.mm.c_stack import COMPLEX_DTYPES

    assert {"stack_matmul_c64.cu", "stack_matmul_c128.cu"} <= set(_build._SOURCES)
    assert {"tile_product_c64.cuh", "tile_mma_c128.cuh"} <= set(_build._HEADERS)
    with open(_build.__file__) as f:
        build_py = f.read()
    for src, entry in (("stack_matmul_c64.cu", COMPLEX_DTYPES[torch.complex64]),
                       ("stack_matmul_c128.cu", COMPLEX_DTYPES[torch.complex128])):
        assert f'extern "C" int {entry}(' in _csrc_text(src)
        assert f"lib.{entry}" in build_py
    kernel = _csrc_text("tile_kernel.cuh")
    for header in ("tile_product_c64.cuh", "tile_mma_c128.cuh"):
        assert f'#include "{header}"' in kernel


def test_filter_kernels_are_built_and_named_apart_from_the_products():
    """``block_filter.cu`` holds the eps filter's two kernels and their entry
    points, each with a ctypes signature; it launches no product routine,
    and no kernel name of it matches the benchmark's product-kernel pattern
    (``\\btile_\\w*kernel\\b``), so its time counts with the tile ops."""
    assert FILTER_SOURCE in _build._SOURCES
    text = _csrc_text(FILTER_SOURCE)
    code = re.sub(r"//[^\n]*", "", text)
    assert "launch_tile_kernel" not in code
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", code)
    assert sorted(kernels) == ["block_sumsq_kernel", "keep_blocks_kernel"]
    assert not any(re.search(r"\btile_\w*kernel\b", k) for k in kernels)
    with open(_build.__file__) as f:
        build_py = f.read()
    for entry in ("dbcsr_torch_block_sumsq", "dbcsr_torch_keep_blocks"):
        assert len(re.findall(r'extern "C" int %s\(' % entry, text)) == 1
        assert f"lib.{entry}.argtypes" in build_py


def test_refold_kernel_is_built_and_named_apart_from_the_products():
    """``block_refold.cu`` holds the tensor refold's kernel and its entry
    point, with a ctypes signature; it launches no product routine, and its
    kernel name does not match the benchmark's product-kernel pattern
    (``\\btile_\\w*kernel\\b``), so ``kernel.ms`` stays the products' time."""
    assert REFOLD_SOURCE in _build._SOURCES
    text = _csrc_text(REFOLD_SOURCE)
    code = re.sub(r"//[^\n]*", "", text)
    assert "launch_tile_kernel" not in code and "tile_kernel.cuh" not in code
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", code)
    assert kernels == ["block_refold_kernel"]
    assert not re.search(r"\btile_\w*kernel\b", kernels[0])
    with open(_build.__file__) as f:
        build_py = f.read()
    assert len(re.findall(r'extern "C" int dbcsr_torch_block_refold\(', text)) == 1
    assert "lib.dbcsr_torch_block_refold.argtypes" in build_py
