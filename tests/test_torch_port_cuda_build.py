"""The kernel build and load path of ``bigdl_tpu_torch/ops/_cuda.py``,
driven on the CPU by a stand-in for ``nvcc`` that compiles a C stub
exporting the kernels' C symbols.  The real CUDA build and launches run
on the card in ``chip_smoke.py``."""

import os
import shutil
import stat

import pytest

from bigdl_tpu_torch.ops import _cuda
from bigdl_tpu_torch.ops import attention as TA

STUB_C = """
int bigdl_flash_fwd(void) { return 0; }
int bigdl_paged_decode(void) { return 0; }
int bigdl_conv_bn_1x1(void) { return 0; }
int bigdl_conv_bn_kxk(void) { return 0; }
int bigdl_flash_bwd_dq(void) { return 0; }
int bigdl_flash_bwd_dkv(void) { return 0; }
int bigdl_fused_adam(void) { return 0; }
const char* bigdl_error_string(int code) { return "stub error"; }
"""

FAKE_NVCC = """#!/bin/sh
# stand-in for nvcc: compile the C stub to the file named after -o
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo "$@" >> "{log}"
exec cc -shared -fPIC -o "$out" "{stub}"
"""


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    """Private build dir, source copies and library cache."""
    if shutil.which("cc") is None:
        pytest.skip("no C compiler for the nvcc stand-in")
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    stub = tmp_path / "stub.c"
    stub.write_text(STUB_C)
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log, stub=stub))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("BIGDL_TORCH_NVCC", str(nvcc))
    monkeypatch.setenv("BIGDL_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_cuda, "CSRC", str(csrc))
    monkeypatch.setattr(_cuda, "_libs", {})
    return tmp_path


def test_build_compiles_each_source_once_and_loads(isolated):
    assert _cuda.build() > 0.0
    calls = (isolated / "nvcc.log").read_text().splitlines()
    assert len(calls) == 7
    for call in calls:
        assert "arch=compute_90a,code=sm_90a" in call and "-O3" in call
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in calls) == [
        "conv_bn_1x1.cu", "conv_bn_kxk.cu", "flash_bwd_dkv.cu",
        "flash_bwd_dq.cu", "flash_fwd.cu", "fused_adam.cu", "paged_decode.cu"]
    built = sorted(os.listdir(isolated / "build"))
    assert [b.split("-")[0] for b in built] == [
        "conv_bn_1x1", "conv_bn_kxk", "flash_bwd_dkv", "flash_bwd_dq",
        "flash_fwd", "fused_adam", "paged_decode"]
    assert all(b.endswith(".so") for b in built)
    assert set(_cuda._libs) == {"flash_fwd", "paged_decode", "conv_bn_1x1",
                                "conv_bn_kxk", "flash_bwd_dq",
                                "flash_bwd_dkv", "fused_adam"}
    for name in ("conv_bn_1x1", "conv_bn_kxk", "flash_bwd_dq",
                 "flash_bwd_dkv", "fused_adam"):
        sym, argtypes = _cuda._SIGNATURES[name]
        assert getattr(_cuda._libs[name], sym).argtypes == argtypes
    # a second build finds every library and compiles nothing
    assert _cuda.build() == 0.0
    assert len((isolated / "nvcc.log").read_text().splitlines()) == 7


def test_edited_source_gets_a_new_library(isolated):
    _cuda.build(["paged_decode"])
    before = set(os.listdir(isolated / "build"))
    with open(isolated / "csrc" / "paged_decode.cu", "a") as f:
        f.write("\n// edited\n")
    assert _cuda.build(["paged_decode"]) > 0.0
    assert len(set(os.listdir(isolated / "build")) - before) == 1


def test_launch_error_codes_raise_with_the_cuda_message(isolated):
    _cuda.build(["flash_fwd"])
    lib = _cuda._libs["flash_fwd"]
    _cuda._check(lib, "flash_fwd", 0)
    with pytest.raises(RuntimeError, match="flash_fwd kernel launch failed: "
                                           "stub error"):
        _cuda._check(lib, "flash_fwd", 9)


def test_conv_bn_sources_build_alone_and_rebuild_when_edited(isolated):
    _cuda.build(["conv_bn_1x1", "conv_bn_kxk"])
    assert set(_cuda._libs) == {"conv_bn_1x1", "conv_bn_kxk"}
    before = set(os.listdir(isolated / "build"))
    with open(isolated / "csrc" / "conv_bn_kxk.cu", "a") as f:
        f.write("\n// edited\n")
    assert _cuda.build(["conv_bn_1x1", "conv_bn_kxk"]) > 0.0
    new = set(os.listdir(isolated / "build")) - before
    assert [n.split("-")[0] for n in new] == ["conv_bn_kxk"]


def test_conv_bn_shared_header_edit_rebuilds_both_conv_bn_kernels(isolated):
    _cuda.build()
    before = set(os.listdir(isolated / "build"))
    with open(isolated / "csrc" / "conv_bn_common.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _cuda.build() > 0.0
    new = set(os.listdir(isolated / "build")) - before
    assert sorted(n.split("-")[0] for n in new) == ["conv_bn_1x1",
                                                    "conv_bn_kxk"]
    # the bf16 kernels' shared GEMM and epilogue reach exactly these two
    before = set(os.listdir(isolated / "build"))
    with open(isolated / "csrc" / "conv_bn_mma.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _cuda.build() > 0.0
    new = set(os.listdir(isolated / "build")) - before
    assert sorted(n.split("-")[0] for n in new) == ["conv_bn_1x1",
                                                    "conv_bn_kxk"]


def test_flash_bwd_sources_build_once_and_rebuild_when_edited(isolated):
    names = ["flash_bwd_dq", "flash_bwd_dkv"]
    assert _cuda.build(names) > 0.0
    assert set(_cuda._libs) == set(names)
    assert _cuda.build(names) == 0.0
    assert len((isolated / "nvcc.log").read_text().splitlines()) == 2
    before = set(os.listdir(isolated / "build"))
    with open(isolated / "csrc" / "flash_bwd_dkv.cu", "a") as f:
        f.write("\n// edited\n")
    assert _cuda.build(names) > 0.0
    new = set(os.listdir(isolated / "build")) - before
    assert [n.split("-")[0] for n in new] == ["flash_bwd_dkv"]


def test_flash_shared_header_edit_rebuilds_every_flash_kernel(isolated):
    _cuda.build()
    before = set(os.listdir(isolated / "build"))
    with open(isolated / "csrc" / "flash_common.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _cuda.build() > 0.0
    new = set(os.listdir(isolated / "build")) - before
    assert sorted(n.split("-")[0] for n in new) == [
        "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd"]
    # the flash tensor-core header: exactly the three kernels that
    # include it (the forward too, since its bf16 kernel went onto the
    # tensor cores)
    before = set(os.listdir(isolated / "build"))
    with open(isolated / "csrc" / "flash_mma.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _cuda.build() > 0.0
    new = set(os.listdir(isolated / "build")) - before
    assert sorted(n.split("-")[0] for n in new) == [
        "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd"]


def test_mma_header_edit_rebuilds_every_tensor_core_kernel(isolated):
    """``mma_common.cuh`` (cp.async, ldmatrix, mma.sync) reaches the
    three flash kernels through ``flash_mma.cuh`` and both conv kernels
    through ``conv_bn_mma.cuh``; the decode kernel does not include
    it."""
    _cuda.build()
    before = set(os.listdir(isolated / "build"))
    with open(isolated / "csrc" / "mma_common.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _cuda.build() > 0.0
    new = set(os.listdir(isolated / "build")) - before
    assert sorted(n.split("-")[0] for n in new) == [
        "conv_bn_1x1", "conv_bn_kxk", "flash_bwd_dkv", "flash_bwd_dq",
        "flash_fwd"]


def test_header_reached_only_through_a_header_rebuilds_its_dependents(
        isolated):
    csrc = isolated / "csrc"
    (csrc / "inner.cuh").write_text("// inner\n")
    with open(csrc / "flash_mma.cuh", "a") as f:
        f.write('\n#include "inner.cuh"\n')
    _cuda.build()
    before = set(os.listdir(isolated / "build"))
    with open(csrc / "inner.cuh", "a") as f:
        f.write("// edited\n")
    assert _cuda.build() > 0.0
    new = set(os.listdir(isolated / "build")) - before
    assert sorted(n.split("-")[0] for n in new) == [
        "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd"]


def test_header_include_cycles_are_followed_once(isolated):
    csrc = isolated / "csrc"
    (csrc / "inner.cuh").write_text('#include "flash_mma.cuh"\n')
    with open(csrc / "flash_mma.cuh", "a") as f:
        f.write('\n#include "inner.cuh"\n')
    text = (csrc / "flash_bwd_dq.cu").read_bytes()
    assert _cuda._headers(text) == ["flash_common.cuh", "flash_mma.cuh",
                                    "mma_common.cuh", "inner.cuh"]
    path = _cuda._lib_path("flash_bwd_dq")
    (csrc / "inner.cuh").write_text('#include "flash_mma.cuh"\n// edited\n')
    assert _cuda._lib_path("flash_bwd_dq") != path


def test_flash_tiles_match_the_plain_versions():
    header = open(os.path.join(_cuda.CSRC, "flash_common.cuh")).read()
    assert f"constexpr int BQ = {TA.BLOCK_Q};" in header
    assert f"constexpr int BK = {TA.BLOCK_K};" in header
    for src in ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu"):
        text = open(os.path.join(_cuda.CSRC, src)).read()
        assert '#include "flash_common.cuh"' in text
        assert "constexpr int BQ" not in text and "to_f32(float" not in text


def test_flash_bwd_sources_share_the_tensor_core_header():
    """Both backward sources take their ldmatrix, mma.sync, cp.async and
    hi/lo helpers from ``flash_mma.cuh`` (the generic ones through it
    from ``mma_common.cuh``), and keep an f32 and a bf16 kernel each."""
    header = open(os.path.join(_cuda.CSRC, "flash_mma.cuh")).read()
    assert '#include "mma_common.cuh"' in header
    assert "to_a_split" in header and "asm" not in header
    common = open(os.path.join(_cuda.CSRC, "mma_common.cuh")).read()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in common
    assert "ldmatrix.sync.aligned.m8n8.x4.trans" in common
    assert "cp.async.cg.shared.global" in common
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        text = open(os.path.join(_cuda.CSRC, f"{name}.cu")).read()
        assert '#include "flash_mma.cuh"' in text
        assert f"{name}_f32_kernel" in text and f"{name}_bf16_kernel" in text
        assert "asm" not in text and "wgmma/TMA come" not in text


@pytest.mark.parametrize("name", ["flash_fwd", "conv_bn_kxk",
                                  "conv_bn_1x1"])
def test_bf16_forward_kernels_share_the_mma_helpers(name):
    """The tensor-core forward kernels reach ``mma_common.cuh`` (the
    flash forward through ``flash_mma.cuh``, both convs through
    ``conv_bn_mma.cuh``), carry no PTX of their own, and keep their f32
    kernel beside the bf16 one.  The shared header defines no dtype
    conversions and includes neither of the two headers that do, so the
    conv sources can include it beside ``conv_bn_common.cuh``; the two
    bf16 convs take their GEMM step and epilogue from ``conv_bn_mma.cuh``
    and keep no copy of them."""
    text = open(os.path.join(_cuda.CSRC, f"{name}.cu")).read()
    assert "mma_common.cuh" in _cuda._headers(text.encode())
    assert f"{name}_f32_kernel" in text and f"{name}_bf16_kernel" in text
    assert "asm" not in text
    common = open(os.path.join(_cuda.CSRC, "mma_common.cuh")).read()
    assert "#include \"" not in common
    assert "float to_f32(" not in common and "constexpr int" not in common
    if name.startswith("conv_bn"):
        assert '#include "conv_bn_mma.cuh"' in text
        assert "mma_stage<" in text and "store_y_and_stats(" in text
        assert "mma_bf16(" not in text and "ldsm_x4" not in text
        assert "__shfl_xor_sync" not in text


def test_conv_bn_tiles_match_the_kernels_pixel_tile():
    header = open(os.path.join(_cuda.CSRC, "conv_bn_common.cuh")).read()
    assert f"constexpr int BN = {_cuda.CONV_BN_TILE_P};" in header
    for src in ("conv_bn_1x1.cu", "conv_bn_kxk.cu"):
        text = open(os.path.join(_cuda.CSRC, src)).read()
        assert '#include "conv_bn_common.cuh"' in text
        assert "constexpr int BN" not in text
    assert [_cuda.conv_bn_tiles(p) for p in (49, 64, 65, 3136)] == \
        [1, 1, 2, 49]
    # the bf16 kernels (kxk and 1x1) tile the pixels flattened across
    # samples, with the one pixel tile of their shared header
    mma = open(os.path.join(_cuda.CSRC, "conv_bn_mma.cuh")).read()
    assert f"constexpr int TN = {_cuda.CONV_MMA_TILE_P};" in mma
    for src in ("conv_bn_1x1.cu", "conv_bn_kxk.cu"):
        text = open(os.path.join(_cuda.CSRC, src)).read()
        assert '#include "conv_bn_mma.cuh"' in text
        assert "constexpr int TN" not in text
    assert [_cuda.conv_mma_tiles(p) for p in (3 * 49, 32 * 49, 32 * 3136)] \
        == [2, 13, 784]


def test_failed_compile_raises_with_the_compiler_output(isolated):
    (isolated / "nvcc").write_text("#!/bin/sh\necho 'error: boom' && exit 3\n")
    with pytest.raises(RuntimeError, match="(?s)nvcc exit 3.*error: boom"):
        _cuda.build(["flash_fwd"])
    assert "flash_fwd" not in _cuda._libs
