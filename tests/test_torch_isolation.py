"""The PyTorch port stands alone: it imports neither jax nor anything of
``deepspeed_tpu`` (nor ``transformers`` or ``safetensors``, which the
card's machine may lack), its entry points refuse to drop to the CPU silently,
and its kernel builder refuses to run without a card."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2, gpt2_tiny
from deepspeed_tpu_torch.models.llama import Llama, llama_tiny
from deepspeed_tpu_torch.ops import op_builder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deepspeed_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(name):
    return name.split(".")[0] in ("jax", "deepspeed_tpu", "transformers",
                                  "safetensors")


def test_importing_every_module_loads_no_jax():
    """Nor ``transformers`` or ``safetensors``: HF ingestion and the
    checkpoints read their formats themselves."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepspeed_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax',"
        " 'deepspeed_tpu', 'transformers', 'safetensors')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules"
        " if k.startswith('deepspeed_tpu_torch')]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 36


def test_no_source_imports_jax_or_the_jax_package():
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}:{node.lineno} imports {bad}"
    assert not _forbidden("deepspeed_tpu_torch.models")   # the scan's own
    assert _forbidden("deepspeed_tpu.serving")            # rule, checked
    assert _forbidden("safetensors.torch") and _forbidden("transformers")


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(Llama(llama_tiny()))
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.init_inference(Llama(llama_tiny()),
                                           device="cuda")
    with pytest.raises(ValueError, match="paged_kernel='force'"):
        deepspeed_tpu_torch.init_inference(Llama(llama_tiny()),
                                           device="cpu", paged_kernel="force")
    eng = deepspeed_tpu_torch.init_inference(Llama(llama_tiny()),
                                             device="cpu")
    assert eng.device.type == "cpu"
    assert next(eng.module.parameters()).device.type == "cpu"


def test_initialize_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = {"train_micro_batch_size_per_gpu": 1}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=GPT2(gpt2_tiny()),
                                       config=config)
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=GPT2(gpt2_tiny()),
                                       config=config, device="cuda")
    eng, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=GPT2(gpt2_tiny()), config=config, device="cpu")
    assert eng.device.type == "cpu" and loader is None and sched is None
    assert opt is eng.optimizer
    assert next(eng.module.parameters()).device.type == "cpu"


def test_op_builder_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builder = op_builder.DecodeAttentionBuilder()
    assert os.path.exists(builder.source_path())
    assert builder.so_path().startswith(os.path.join(REPO, "build"))
    with pytest.raises(op_builder.OpBuilderError, match="no CUDA device"):
        builder.load()
    with pytest.raises(op_builder.OpBuilderError, match="no CUDA device"):
        op_builder.build_all()


def test_flash_builder_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builder = op_builder.FlashAttentionBuilder()
    assert os.path.exists(builder.source_path())
    assert builder.so_path().startswith(os.path.join(REPO, "build"))
    assert op_builder.ALL_OPS["flash_attention"].SOURCE == builder.SOURCE
    with pytest.raises(op_builder.OpBuilderError, match="no CUDA device"):
        builder.load()


def test_int8_matmul_builder_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builder = op_builder.Int8MatmulBuilder()
    assert os.path.exists(builder.source_path())
    assert builder.so_path().startswith(os.path.join(REPO, "build"))
    assert set(op_builder.ALL_OPS) == {"decode_attention", "flash_attention",
                                       "block_sparse_attention",
                                       "int8_matmul"}
    with pytest.raises(op_builder.OpBuilderError, match="no CUDA device"):
        builder.load()


def test_block_sparse_builder_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builder = op_builder.BlockSparseAttentionBuilder()
    assert os.path.exists(builder.source_path())
    assert builder.so_path().startswith(os.path.join(REPO, "build"))
    assert op_builder.ALL_OPS["block_sparse_attention"].SOURCE == \
        builder.SOURCE
    with pytest.raises(op_builder.OpBuilderError, match="no CUDA device"):
        builder.load()


def test_so_path_hashes_every_file_the_build_reads(tmp_path):
    """An edit to the source or to any header it includes with quotes
    (transitively) names another library, so it is rebuilt."""
    (tmp_path / "inc").mkdir()
    files = {"op.cu": '#include "inc/a.cuh"\n#include <cuda_runtime.h>\n',
             "inc/a.cuh": '#pragma once\n#include "b.cuh"\n',
             "inc/b.cuh": "// b\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text)

    class Builder(op_builder.CUDAOpBuilder):
        NAME = "probe"
        SOURCE = str(tmp_path / "op.cu")

    builder = Builder()
    assert builder.build_inputs() == [str(tmp_path / n) for n in files]
    seen = {builder.so_path()}
    for name in files:
        (tmp_path / name).write_text(files[name] + "// edited\n")
        seen.add(builder.so_path())
    assert len(seen) == 1 + len(files)
    for b in (op_builder.FlashAttentionBuilder(),
              op_builder.BlockSparseAttentionBuilder()):
        assert [os.path.basename(f) for f in b.build_inputs()][1:] == \
            ["flash_kernels.cuh"]


@pytest.mark.parametrize("module", ["ops.attention.block_sparse",
                                    "ops.sparse_attention",
                                    "ops.sparse_attention.sparsity_config"])
def test_sparse_modules_import_without_jax_or_a_built_library(module):
    """Importing a block-sparse module, and a CPU forward and backward
    through it, touch neither jax, nor the JAX package, nor the op
    builder's library."""
    code = (
        "import sys, ctypes\n"
        "loaded = []\n"
        "cdll = ctypes.CDLL\n"
        "ctypes.CDLL = lambda *a, **k: (loaded.append(a), cdll(*a, **k))[1]\n"
        f"import deepspeed_tpu_torch.{module} as mod\n"
        "import torch\n"
        "from deepspeed_tpu_torch.ops import sparse_attention as sa\n"
        "q = torch.randn(1, 128, 2, 32, requires_grad=True)\n"
        "cfg = sa.BigBirdSparsityConfig(2, block=32)\n"
        "sa.SparseSelfAttention(cfg)(q, q, q).sum().backward()\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'deepspeed_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert not [a for a in loaded if 'build' in str(a)], loaded\n"
        "from deepspeed_tpu_torch.ops import op_builder\n"
        "assert not op_builder.CUDAOpBuilder._loaded\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("module", ["ops.quant.quantizer",
                                    "ops.quant.kernels", "ops.quant.kv",
                                    "ops.quant.qdense"])
def test_quant_modules_import_without_jax_triton_or_a_built_library(module):
    """Importing a quant module on a box with no card touches neither
    jax, nor the JAX package, nor triton, nor the op builder's library;
    a CPU call of its kernel wrapper does not either."""
    code = (
        "import sys, ctypes\n"
        "loaded = []\n"
        "cdll = ctypes.CDLL\n"
        "ctypes.CDLL = lambda *a, **k: (loaded.append(a), cdll(*a, **k))[1]\n"
        f"import deepspeed_tpu_torch.{module} as mod\n"
        "import torch\n"
        "from deepspeed_tpu_torch.ops.quant import kernels, quantizer\n"
        "q, s = quantizer.quantize(torch.ones(64, 8), group_size=32)\n"
        "kernels.int8_matmul(torch.ones(2, 64), q, s)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'deepspeed_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert not [a for a in loaded if 'build' in str(a)], loaded\n"
        "from deepspeed_tpu_torch.ops import op_builder\n"
        "assert not op_builder.CUDAOpBuilder._loaded\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("module", ["serving.prefix_cache",
                                    "serving.sampling",
                                    "serving.sampling.grammar",
                                    "serving.sampling.params",
                                    "serving.sampling.pipeline",
                                    "serving.sampling.prng"])
def test_policy_and_prefix_modules_import_without_jax(module):
    """The prefix cache and the decoding-policy modules are the port's
    own copies: importing one, then drawing a sampled token and walking
    a grammar on the CPU, loads neither jax nor the JAX package nor a
    built library."""
    code = (
        "import sys, ctypes\n"
        "loaded = []\n"
        "cdll = ctypes.CDLL\n"
        "ctypes.CDLL = lambda *a, **k: (loaded.append(a), cdll(*a, **k))[1]\n"
        f"import deepspeed_tpu_torch.{module} as mod\n"
        "import torch\n"
        "from deepspeed_tpu_torch.serving import sampling as s\n"
        "from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache\n"
        "from deepspeed_tpu_torch.serving.page_manager import PagePool\n"
        "keys = s.prng.as_key(s.request_key(7))[None]\n"
        "s.sample_processed(torch.randn(1, 16), keys, 3, torch.ones(1))\n"
        "g = s.compile_grammar({'regex': 'ab+'}, 256)\n"
        "g.advance(97)\n"
        "assert g.token_mask()[98]\n"
        "PrefixCache(PagePool(4, 2)).match([1, 2, 3])\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'deepspeed_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert not [a for a in loaded if 'build' in str(a)], loaded\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_fp16_training_imports_without_jax_or_a_built_library():
    """The loss scaler and an fp16 train step on the CPU touch neither
    jax, nor the JAX package, nor the op builder's library; the fp16
    engine, like every entry point, needs a card or ``device="cpu"``."""
    code = (
        "import sys, ctypes\n"
        "loaded = []\n"
        "cdll = ctypes.CDLL\n"
        "ctypes.CDLL = lambda *a, **k: (loaded.append(a), cdll(*a, **k))[1]\n"
        "import torch\n"
        "import deepspeed_tpu_torch as dt\n"
        "from deepspeed_tpu_torch.models.gpt2 import GPT2, gpt2_tiny\n"
        "from deepspeed_tpu_torch.runtime.fp16 import loss_scaler\n"
        "cfg = {'train_micro_batch_size_per_gpu': 1,\n"
        "       'fp16': {'enabled': True}}\n"
        "eng = dt.initialize(model=GPT2(gpt2_tiny(dtype='float16')),\n"
        "                    config=cfg, device='cpu')[0]\n"
        "ids = torch.randint(0, 256, (1, 16))\n"
        "eng.train_batch(batches=[{'input_ids': ids}])\n"
        "assert eng.loss_scale == 65536.0 and eng.skipped_steps == 0\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'deepspeed_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert not [a for a in loaded if 'build' in str(a)], loaded\n"
        "torch.cuda.is_available = lambda: False\n"
        "try:\n"
        "    dt.initialize(model=GPT2(gpt2_tiny(dtype='float16')),\n"
        "                  config=cfg)\n"
        "except RuntimeError as e:\n"
        "    assert \"device='cpu'\" in str(e), e\n"
        "else:\n"
        "    raise AssertionError('no card and no device: must raise')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
