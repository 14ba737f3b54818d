"""Times of the flash and dense-decode attention kernels, for A/B runs.

    python deepspeed_tpu_torch/profiling/kernel_times.py [--label NAME]

Times, by CUDA-graph replay over two rotated bf16 input sets (cold L2):
``decode_fwd`` at the Llama-2-7B generate cache (1 x 256 keys, 32 heads,
d 128, position 215), ``flash_fwd`` at GPT-2 training (b 8 h 12 l 1024
d 64 causal), b 1 h 12 l 4096 and Llama-2-7B heads (b 1 h 32 l 2048 d
128), and the backward (``flash_bwd``: the delta pre-pass and the
dq / dkv pair) at all three. It imports
``deepspeed_tpu_torch`` from the Python path, so running it as a file
with ``PYTHONPATH`` set to another checkout times that checkout's kernels
(run parent, change, change, parent in one call to compare two commits
on one card). Prints one JSON object with the card's name and power
limit. Needs a CUDA device.
"""

import argparse
import json
import subprocess

import torch

from deepspeed_tpu_torch.profiling.paged_decode_sweep import time_ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.attention import decode as dec
    from deepspeed_tpu_torch.ops.attention import flash as fl

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    out = {"label": args.label, "gpu": smi,
           "package": deepspeed_tpu_torch.__file__}

    bias = torch.where(torch.arange(256, device=dev) <= 215, 0.0,
                       torch.finfo(torch.float32).min)[None, None, None, :]
    sets = [tuple(torch.randn(*s, generator=g, device=dev).to(bf16)
                  for s in ((1, 1, 32, 128), (1, 256, 32, 128),
                            (1, 256, 32, 128))) for _ in range(2)]
    out["decode_fwd_7b_generate"] = time_ms(
        [lambda s=s: dec.decode_attention(*s, bias=bias) for s in sets])

    for name, b, l, h, d in (("a", 8, 1024, 12, 64), ("b", 1, 4096, 12, 64),
                             ("e", 1, 2048, 32, 128)):
        sets = [tuple(torch.randn(b, l, h, d, generator=g, device=dev)
                      .to(bf16) for _ in range(4)) for _ in range(2)]
        out[f"flash_fwd_{name}"] = time_ms(
            [lambda s=s: fl.flash_fwd(*s[:3], causal=True) for s in sets])
        bwd = []
        for q, k, v, do in sets:
            o, lse = fl.flash_fwd(q, k, v, causal=True)
            bwd.append((q, k, v, o, lse, do))
        out[f"flash_bwd_{name}"] = time_ms(
            [lambda a=a: fl.flash_bwd(*a, causal=True) for a in bwd])
        del sets, bwd
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
