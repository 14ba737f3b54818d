"""CUDA op build system: compile the port's ``.cu`` sources with ``nvcc``
on first use, cache by a hash of the source, bind with ``ctypes``.

Counterpart of ``deepspeed_tpu/ops/op_builder/__init__.py`` (the g++ +
ctypes builder for the host ops): each source has a plain C interface,
so no PyTorch header is compiled and a build takes seconds.  Libraries
land in ``build/`` at the repository root (listed in ``.gitignore``),
named ``<op>_<hash>.so``, the hash over the flags, the source and every
header it includes with quotes, so an edited source or shared header
rebuilds.  nvcc's log (``-Xptxas -v``: registers and spills per kernel)
is kept beside each library as ``<op>_<hash>.so.log``, written before
the library is moved into place, so a cached build returns the same log
as the process that built it.  There is no fallback: without a CUDA device or without
``nvcc``, :meth:`load` raises :class:`OpBuilderError`.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

_PKG = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG)), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


class OpBuilderError(RuntimeError):
    pass


def find_nvcc():
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``, or nvcc on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc")


class CUDAOpBuilder:
    """Compile-and-load for one ``.cu`` translation unit with a C ABI."""

    NAME = None       # registry key, also the library's file stem
    SOURCE = None     # path under the package's ops/ directory

    _loaded = {}

    def source_path(self):
        return os.path.join(_PKG, self.SOURCE)

    def build_inputs(self):
        """The source, then every file it includes with quotes (``#include
        "x.cuh"``, resolved beside the including file), transitively."""
        out, todo = [], [self.source_path()]
        while todo:
            path = todo.pop(0)
            if path in out:
                continue
            out.append(path)
            with open(path) as f:
                todo += [os.path.join(os.path.dirname(path), name)
                         for name in _INCLUDE.findall(f.read())]
        return out

    def so_path(self):
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in self.build_inputs():
            with open(path, "rb") as f:
                h.update(f.read())
        return os.path.join(BUILD_DIR, f"{self.NAME}_{h.hexdigest()[:16]}.so")

    def _check_toolchain(self):
        import torch
        if not torch.cuda.is_available():
            raise OpBuilderError(
                f"{self.NAME}: no CUDA device is visible; the kernel runs "
                "only on the card (CPU tensors take the plain PyTorch "
                "version in the op's wrapper)")
        nvcc = find_nvcc()
        if nvcc is None:
            raise OpBuilderError(f"{self.NAME}: nvcc not found (set "
                                 "CUDA_HOME or put nvcc on PATH)")
        return nvcc

    def log_path(self):
        """nvcc's log of the library at :meth:`so_path`."""
        return self.so_path() + ".log"

    def start_build(self):
        """Start ``nvcc`` for this op unless its library exists; returns
        the running process (or None) so several builds overlap."""
        nvcc = self._check_toolchain()
        so = self.so_path()
        if os.path.exists(so):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, self.source_path()]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.cmd, proc.tmp, proc.so = cmd, tmp, so
        return proc

    def finish_build(self, proc):
        """Wait for :meth:`start_build`'s process; returns nvcc's log, or
        for a library that was already built (``proc`` None) the log kept
        beside it ("" when it has none)."""
        if proc is None:
            try:
                with open(self.log_path()) as f:
                    return f.read()
            except FileNotFoundError:
                return ""
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise OpBuilderError(f"building {self.NAME} failed:\n"
                                 f"{' '.join(proc.cmd)}\n{log}")
        # the log first, each by an atomic rename: a library in place
        # always has its log beside it
        tmp_log = f"{proc.so}.log.{os.getpid()}.tmp"
        with open(tmp_log, "w") as f:
            f.write(log)
        os.replace(tmp_log, proc.so + ".log")
        os.replace(proc.tmp, proc.so)
        return log

    def load(self):
        """The bound ``ctypes.CDLL``, building it first if needed."""
        if self.NAME in CUDAOpBuilder._loaded:
            return CUDAOpBuilder._loaded[self.NAME]
        self.finish_build(self.start_build())
        lib = ctypes.CDLL(self.so_path())
        self._annotate(lib)
        CUDAOpBuilder._loaded[self.NAME] = lib
        return lib

    def _annotate(self, lib):
        """Set argtypes/restype of every exported function."""
        raise NotImplementedError


_p, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong


class DecodeAttentionBuilder(CUDAOpBuilder):
    NAME = "decode_attention"
    SOURCE = os.path.join("attention", "csrc", "decode_attention.cu")

    def _annotate(self, lib):
        lib.paged_decode_fwd.argtypes = [
            _p, _p, _p, _p, _p, _p,             # q k v out table positions
            _i, _i, _i, _i, _i, _i, _i,         # slots kv_h group d ps maxp
                                                # pages_per_split
            _f, _i, _p]                         # scale dtype stream
        lib.paged_decode_fwd.restype = _i
        lib.paged_decode_quant_fwd.argtypes = [
            _p, _p, _p, _p, _p, _p,             # q k v k_scale v_scale out
            _p, _p,                             # table positions
            _i, _i, _i, _i, _i, _i, _i,         # slots kv_h group d ps maxp
                                                # pages_per_split
            _f, _i, _i, _p]                     # scale dtype storage stream
        lib.paged_decode_quant_fwd.restype = _i
        lib.decode_fwd.argtypes = [
            _p, _p, _p, _p, _p,                 # q k v out bias
            _ll, _ll, _ll,                      # bias strides b, h, key
            _i, _i, _i, _i, _i,                 # b max_len kv_h group d
            _i, _f, _i, _p]                     # split_keys scale dtype
                                                # stream
        lib.decode_fwd.restype = _i


class FlashAttentionBuilder(CUDAOpBuilder):
    NAME = "flash_attention"
    SOURCE = os.path.join("attention", "csrc", "flash_attention.cu")

    def _annotate(self, lib):
        tail = [_p, _i, _i, _i, _i, _i,          # strides b h lq lk d
                _i, _f, _i, _p]                  # causal scale dtype stream
        lib.flash_fwd.argtypes = [_p, _p, _p, _p, _p] + tail  # q k v o lse
        lib.flash_bwd_dq.argtypes = [_p] * 7 + tail  # q k v do lse delta dq
        lib.flash_bwd_dkv.argtypes = [_p] * 8 + tail  # ... dk dv
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = _i


class BlockSparseAttentionBuilder(CUDAOpBuilder):
    NAME = "block_sparse_attention"
    SOURCE = os.path.join("attention", "csrc", "block_sparse.cu")

    def _annotate(self, lib):
        tail = [_p, _p, _p, _p, _p,     # strides row_ptr cols fmask order
                _i, _i, _i, _i, _i,     # b h len d layout_heads
                _i, _i, _i, _i,         # n_rows tile fine causal
                _f, _i, _p]             # scale dtype stream
        lib.sparse_fwd.argtypes = [_p] * 5 + tail     # q k v o lse
        lib.sparse_bwd_dq.argtypes = [_p] * 7 + tail  # q k v do lse delta dq
        lib.sparse_bwd_dkv.argtypes = [_p] * 8 + tail  # ... dk dv
        for fn in (lib.sparse_fwd, lib.sparse_bwd_dq, lib.sparse_bwd_dkv):
            fn.restype = _i


class Int8MatmulBuilder(CUDAOpBuilder):
    NAME = "int8_matmul"
    SOURCE = os.path.join("quant", "csrc", "int8_matmul.cu")

    def _annotate(self, lib):
        lib.int8_matmul_fwd.argtypes = [
            _p, _p, _p, _p,                     # x q scale out
            _i, _i, _i, _i, _i, _i, _p]         # m k n group splits dtype
                                                # stream
        lib.int8_matmul_fwd.restype = _i


ALL_OPS = {b.NAME: b for b in (DecodeAttentionBuilder(),
                               FlashAttentionBuilder(),
                               BlockSparseAttentionBuilder(),
                               Int8MatmulBuilder())}


def build_all():
    """Build every op's library, all ``nvcc`` processes started together;
    returns ``{name: nvcc log}``."""
    procs = {name: b.start_build() for name, b in ALL_OPS.items()}
    logs, errors = {}, []
    for name, proc in procs.items():      # wait for every process first
        try:
            logs[name] = ALL_OPS[name].finish_build(proc)
        except OpBuilderError as e:
            errors.append(str(e))
    if errors:
        raise OpBuilderError("\n".join(errors))
    return logs
