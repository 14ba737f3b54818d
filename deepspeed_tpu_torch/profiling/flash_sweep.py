"""The bf16 flash forward against SDPA and its bound, over lengths.

    python -m deepspeed_tpu_torch.profiling.flash_sweep \
        [--lengths 512,1024,2048,4096,8192,16384] [--head-dims 64,128] \
        [--tokens 16384] [--heads-64 12] [--heads-128 32] [--seed 0]

For every head dim, length and causal flag: ``flash_fwd`` (the
hand-written kernel) and SDPA on the same bf16 [b, l, h, d] inputs, both
by CUDA-graph replay over two rotated input sets (cold L2 when they
exceed it), beside the bound max(4 d x attended pairs / 989 TFLOP/s,
(q, k, v, o) bytes + lse / 3.35 TB/s).  The batch is ``--tokens`` /
length (at least 1), so every length does about the same work when not
causal; heads are GPT-2's 12 at d 64 and Llama-2-7B's 32 at d 128 by
default.  Prints the card's name and power limit, then one JSON object
per case with the kernel's share of its bound and its ratio to SDPA.
Needs a CUDA device; it does not run anywhere else.
"""

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.profiling.paged_decode_sweep import (
    HBM_BYTES_PER_S, time_ms)

BF16_FLOPS = 989e12                # dense tensor-core peak


def attended_pairs(l, causal):
    return l * (l + 1) // 2 if causal else l * l


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lengths", default="512,1024,2048,4096,8192,16384")
    ap.add_argument("--head-dims", default="64,128")
    ap.add_argument("--tokens", type=int, default=16384)
    ap.add_argument("--heads-64", type=int, default=12)
    ap.add_argument("--heads-128", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_sweep: no CUDA device")

    from deepspeed_tpu_torch.ops.attention import flash as fl
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"gpu": smi}), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for d in (int(x) for x in args.head_dims.split(",")):
        h = args.heads_64 if d <= 64 else args.heads_128
        for l in (int(x) for x in args.lengths.split(",")):
            b = max(1, args.tokens // l)
            sets = [tuple(torch.randn(b, l, h, d, generator=g, device=dev)
                          .to(torch.bfloat16) for _ in range(3))
                    for _ in range(2)]
            for causal in (True, False):
                ms = time_ms([lambda s=s: fl.flash_fwd(*s, causal=causal)
                              for s in sets])
                sdpa_ms = time_ms([
                    lambda s=s: F.scaled_dot_product_attention(
                        *(x.transpose(1, 2) for x in s), is_causal=causal)
                    for s in sets])
                flops = 4 * d * b * h * attended_pairs(l, causal)
                n_bytes = 4 * b * l * h * d * 2 + b * h * l * 4
                bound = max(flops / BF16_FLOPS, n_bytes / HBM_BYTES_PER_S)
                print(json.dumps({
                    "head_dim": d, "heads": h, "batch": b, "length": l,
                    "causal": causal, "kernel_ms": ms, "sdpa_ms": sdpa_ms,
                    "bound_ms": bound * 1e3,
                    "bound_by": "operations" if flops / BF16_FLOPS >=
                    n_bytes / HBM_BYTES_PER_S else "bytes",
                    "bound_share": bound * 1e3 / ms,
                    "vs_sdpa": ms / sdpa_ms,
                    "tflops": flops / ms / 1e9}), flush=True)
            del sets
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
