"""The kernel build and load path of ``bigdl_tpu_torch/ops/_cuda.py``,
driven on the CPU by a stand-in for ``nvcc`` that compiles a C stub
exporting the kernels' C symbols.  The real CUDA build and launches run
on the card in ``chip_smoke.py``."""

import os
import shutil
import stat

import pytest

from bigdl_tpu_torch.ops import _cuda

STUB_C = """
int bigdl_flash_fwd(void) { return 0; }
int bigdl_paged_decode(void) { return 0; }
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
    assert len(calls) == 2
    for call in calls:
        assert "arch=compute_90a,code=sm_90a" in call and "-O3" in call
    built = sorted(os.listdir(isolated / "build"))
    assert [b.split("-")[0] for b in built] == ["flash_fwd", "paged_decode"]
    assert all(b.endswith(".so") for b in built)
    assert set(_cuda._libs) == {"flash_fwd", "paged_decode"}
    # a second build finds both libraries and compiles nothing
    assert _cuda.build() == 0.0
    assert len((isolated / "nvcc.log").read_text().splitlines()) == 2


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


def test_failed_compile_raises_with_the_compiler_output(isolated):
    (isolated / "nvcc").write_text("#!/bin/sh\necho 'error: boom' && exit 3\n")
    with pytest.raises(RuntimeError, match="(?s)nvcc exit 3.*error: boom"):
        _cuda.build(["flash_fwd"])
    assert "flash_fwd" not in _cuda._libs
