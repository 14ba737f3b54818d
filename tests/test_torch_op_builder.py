"""The CUDA op builder's log round trip (``deepspeed_tpu_torch.ops.
op_builder``), on the CPU with a stub compiler.

``chip_smoke.py`` gates every kernel instantiation on ptxas's register
and spill report, read from the nvcc log that ``build_all`` returns.  A
library built by another process (a test run first) must give the same
log: the builder keeps it beside the library and returns it for a cached
build.  The stub ``nvcc`` (a script under a temporary ``CUDA_HOME``)
writes a fake library at ``-o`` and prints a ptxas-style report, and
counts its runs, so the test needs no CUDA toolchain.
"""

import os
import stat
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402

STUB = """#!/bin/sh
out=""
src=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
  src="$a"
done
echo run >> "{runs}"
name=$(basename "$src" .cu)
echo "ptxas info    : Compiling entry function '_Z6kernel_$name' for 'sm_90a'"
echo "ptxas info    : Function properties for _Z6kernel_$name"
echo "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
echo "ptxas info    : Used 42 registers, used 1 barriers"
printf 'not a library' > "$out"
"""


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    runs = tmp_path / "runs"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(STUB.format(runs=runs))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(op_builder, "BUILD_DIR", str(tmp_path / "build"))
    return runs


def _runs(path):
    return len(path.read_text().splitlines()) if path.exists() else 0


def test_cached_build_returns_the_log_of_the_build(stub_nvcc):
    first = op_builder.build_all()
    assert set(first) == set(op_builder.ALL_OPS)
    assert _runs(stub_nvcc) == len(op_builder.ALL_OPS)
    for name, b in op_builder.ALL_OPS.items():
        assert "Used 42 registers" in first[name]
        assert os.path.exists(b.so_path())
        with open(b.log_path()) as f:
            assert f.read() == first[name]
    # a second process finds every library built: no compiler run, and
    # the same logs, so the spill gate reads the same instantiations
    cached = op_builder.build_all()
    assert _runs(stub_nvcc) == len(op_builder.ALL_OPS)
    assert cached == first
    usage = chip_smoke.ptxas_usage(cached)
    assert len(usage) == len(op_builder.ALL_OPS)
    assert all(e["spill"] == "0 bytes stack frame, 0 bytes spill stores, "
               "0 bytes spill loads" and "42 registers" in e["usage"]
               for e in usage)


def test_a_library_without_its_log_returns_an_empty_log(stub_nvcc):
    b = op_builder.ALL_OPS["int8_matmul"]
    log = b.finish_build(b.start_build())
    assert "Used 42 registers" in log
    os.remove(b.log_path())
    assert b.start_build() is None          # cached: nothing is compiled
    assert b.finish_build(None) == ""
    assert _runs(stub_nvcc) == 1


def test_no_temporary_file_is_left_beside_the_library(stub_nvcc):
    op_builder.build_all()
    left = sorted(os.listdir(op_builder.BUILD_DIR))
    assert not [f for f in left if f.endswith(".tmp")]
    assert len(left) == 2 * len(op_builder.ALL_OPS)   # .so and .so.log
