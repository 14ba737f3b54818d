"""Times of the decode, int8 dequant-matmul and flash kernels, for A/B runs.

    python deepspeed_tpu_torch/profiling/kernel_times.py [--label NAME]

Times, by CUDA-graph replay over rotated input sets (cold L2), bf16 unless
said otherwise:
``decode_fwd`` at the Llama-2-7B generate cache (1 x 256 keys, 32 heads,
d 128, position 215), at Falcon-7B heads (1 x 256 keys, 71 heads over 1,
d 64) and at 8 x 1024 keys of 7B heads; ``paged_decode_fwd`` at the 7B
serve batch (4 slots at positions 0, 7, 100, 231, pages of 16);
``int8_matmul_fwd`` at the four Llama-2-7B projection shapes (k x n 4096
x 4096, 4096 x 11008, 11008 x 4096, 4096 x 32000; group 64) for m = 1,
4 and 64, and in fp32 (the serving oracle) at 4096 x 4096 for m = 4 and
64; ``flash_fwd`` at GPT-2 training (b 8 h 12 l 1024 d 64
causal), b 1 h 12 l 4096 and Llama-2-7B heads (b 1 h 32 l 2048 d 128),
and the backward (``flash_bwd``: the delta pre-pass and the dq / dkv
pair) at all three. It imports ``deepspeed_tpu_torch`` from the Python
path, so running it as a file with ``PYTHONPATH`` set to another
checkout times that checkout's kernels (run parent, change, change,
parent in one call to compare two commits on one card). Prints one JSON
object with the card's name and power limit. Needs a CUDA device.
"""

import argparse
import json
import subprocess

import torch

from deepspeed_tpu_torch.profiling.paged_decode_sweep import time_ms


def decode_times(dec, g, dev):
    """``decode_fwd`` at three dense caches, ``paged_decode_fwd`` at the
    7B serve batch."""
    bf16, neg = torch.bfloat16, torch.finfo(torch.float32).min
    out = {}
    for name, b, max_len, h, kv_h, d, rot in (
            ("decode_fwd_7b_generate", 1, 256, 32, 32, 128, 2),
            ("decode_fwd_falcon_mqa", 1, 256, 71, 1, 64, 8),
            ("decode_fwd_7b_8x1024", 8, 1024, 32, 32, 128, 2)):
        pos = torch.tensor([215] if b == 1 else
                           [1023 - 100 * i for i in range(b)], device=dev)
        bias = torch.where(torch.arange(max_len, device=dev)[None] <=
                           pos[:, None], 0.0, neg)[:, None, None, :]
        sets = [tuple(torch.randn(*s, generator=g, device=dev).to(bf16)
                      for s in ((b, 1, h, d), (b, max_len, kv_h, d),
                                (b, max_len, kv_h, d))) for _ in range(rot)]
        out[name] = time_ms(
            [lambda s=s: dec.decode_attention(*s, bias=bias) for s in sets])
    positions = [0, 7, 100, 231]
    slots, ps, maxp = len(positions), 16, 231 // 16 + 1
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    sets = []
    for _ in range(8):
        pools = [torch.randn(slots * maxp + 1, ps, 32, 128, generator=g,
                             device=dev).to(bf16) for _ in range(2)]
        pt = torch.randperm(slots * maxp + 1, generator=g, device=dev)[
            :slots * maxp].reshape(slots, maxp).to(torch.int32)
        sets.append((torch.randn(slots, 1, 32, 128, generator=g,
                                 device=dev).to(bf16), *pools, pt))
    out["paged_decode_fwd_7b_serve"] = time_ms(
        [lambda s=s: dec.paged_decode_attention(*s, pos) for s in sets])
    return out


def int8_matmul_times(qk, tq, g, dev):
    """``int8_matmul_fwd`` bf16 at the 7B projections, m = 1, 4, 64; fp32
    at 4096 x 4096, m = 4, 64."""
    out = {}
    for dtype, shapes, ms in (
            (torch.bfloat16, ((4096, 4096), (4096, 11008), (11008, 4096),
                              (4096, 32000)), (1, 4, 64)),
            (torch.float32, ((4096, 4096),), (4, 64))):
        tag = "" if dtype == torch.bfloat16 else "fp32_"
        for k, n in shapes:
            weights = [tq.quantize(torch.randn(k, n, generator=g, device=dev)
                                   .to(dtype) * 0.02, group_size=64)
                       for _ in range(4)]
            for m in ms:
                xs = [torch.randn(m, k, generator=g, device=dev).to(dtype)
                      for _ in weights]
                out[f"int8_matmul_fwd_{tag}m{m}_k{k}_n{n}"] = time_ms(
                    [lambda x=x, w=w: qk.int8_matmul(x, *w)
                     for x, w in zip(xs, weights)])
            del weights
            torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.attention import decode as dec
    from deepspeed_tpu_torch.ops.attention import flash as fl
    from deepspeed_tpu_torch.ops.quant import kernels as qk
    from deepspeed_tpu_torch.ops.quant import quantizer as tq

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    out = {"label": args.label, "gpu": smi,
           "package": deepspeed_tpu_torch.__file__}
    out.update(decode_times(dec, g, dev))
    out.update(int8_matmul_times(qk, tq, g, dev))

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
