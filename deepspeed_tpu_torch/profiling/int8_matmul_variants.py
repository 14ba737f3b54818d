"""How ``int8_matmul_fwd``'s time depends on its two tiling constants.

    python -m deepspeed_tpu_torch.profiling.int8_matmul_variants \
        [--block-n 32,64,128] [--unroll 4,8] [--dtype bfloat16] [--seed 0]

Builds ``ops/quant/csrc/int8_matmul.cu`` once per (output columns per
block, weight rows in flight per lane) pair, with the two ``constexpr``
values replaced in a copy of the source under ``build/``, checks each
variant against ``int8_matmul_plain`` and times it at the Llama-2-7B
projection shapes (group 64; m = 1, 4 and 64) under CUDA-graph replay
over four rotated weights, so a call does not find its weight in L2.
Prints the card's name and power limit, then one JSON object per shape
with the microseconds of every variant.  The kernel that serves is the
one in the source as committed; this tool only says what another choice
of constants would cost.  Needs a CUDA device and ``nvcc``.
"""

import argparse
import ctypes
import json
import os
import subprocess

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.quant import kernels, quantizer

SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def build(block_n, unroll):
    """The library of one variant (``build/variants/``)."""
    builder = op_builder.Int8MatmulBuilder()
    with open(builder.source_path()) as f:
        src = f.read()
    for name, value in (("kBlockN", block_n), ("kUnroll", unroll)):
        head, sep, tail = src.partition(f"constexpr int {name} = ")
        if not sep:
            raise SystemExit(f"int8_matmul.cu no longer defines {name}")
        src = head + sep + str(value) + tail[tail.index(";"):]
    out_dir = os.path.join(op_builder.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.join(out_dir, f"int8_matmul_{block_n}_{unroll}")
    with open(stem + ".cu", "w") as f:
        f.write(src)
    flags = [f for f in op_builder.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    return stem + ".so", subprocess.Popen(
        [op_builder.find_nvcc(), *flags, "-o", stem + ".so", stem + ".cu"])


def time_us(calls, reps=10):
    """Device microseconds per call, one pass of ``calls`` captured in a
    CUDA graph and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in calls:
            f()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (reps * len(calls))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--block-n", default="32,64,128")
    ap.add_argument("--unroll", default="4,8")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_matmul_variants: needs a CUDA device")
    dtype = getattr(torch, args.dtype)
    variants = [(int(b), int(u)) for b in args.block_n.split(",")
                for u in args.unroll.split(",")]
    builds = [build(b, u) for b, u in variants]
    libs = {}
    for key, (so, proc) in zip(variants, builds):
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for variant {key}")
        lib = ctypes.CDLL(so)
        op_builder.Int8MatmulBuilder()._annotate(lib)
        libs[key] = lib
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stream = torch.cuda.current_stream
    for k, n in SHAPES:
        sets = [quantizer.quantize(
            (torch.randn(k, n, generator=gen, device=dev) * 0.02).to(dtype),
            group_size=64) for _ in range(4)]
        for m in (1, 4, 64):
            x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            want = kernels.int8_matmul_plain(x, *sets[0]).float()
            out = torch.empty(m, n, dtype=dtype, device=dev)
            row = {}
            for key, lib in libs.items():
                def call(q, scale, lib=lib):
                    err = lib.int8_matmul_fwd(
                        x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                        out.data_ptr(), m, k, n, 64,
                        kernels._KERNEL_DTYPES[dtype],
                        stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"variant {key}: cudaError {err}")
                call(*sets[0])
                torch.cuda.synchronize()
                err = ((out.float() - want).abs() /
                       want.abs().clamp(min=1.0)).max().item()
                if not err < TOL[dtype]:
                    raise SystemExit(f"variant {key} at m{m} k{k} n{n}: "
                                     f"error {err} vs plain")
                row[f"block_n {key[0]}, unroll {key[1]}"] = round(
                    time_us([lambda s=s: call(*s) for s in sets]), 2)
            print(json.dumps({"dtype": args.dtype, "m": m, "k": k, "n": n,
                              "us": row}), flush=True)


if __name__ == "__main__":
    main()
