"""Paged decode attention against one slot's position on the card.

    python -m deepspeed_tpu_torch.profiling.paged_decode_sweep \
        [--heads 32] [--kv-heads 32] [--head-dim 128] [--page-size 16] \
        [--positions 0,63,127,128,255,1023] [--dtype bfloat16] [--seed 0]

One slot of Llama-2-7B heads (by default) at each position: the time of
``paged_decode_attention`` (the hand-written kernel) and of SDPA over the
same keys gathered to a contiguous buffer, both by CUDA-graph replay over
eight rotated pools (cold L2), with the bandwidth bound, the number of
splits the kernel cuts the slot into and the keys per split.  The
positions straddle the split and tile boundaries, so the differences
read the cost of one more tile and of a merge.  Prints one JSON object
per position and, first, the card's name and power limit.  Needs a CUDA
device; it does not run anywhere else.
"""

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3


def time_ms(calls, reps=10):
    """Per-call device time of ``calls`` replayed as one CUDA graph."""
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
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=32)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--positions", default="0,63,127,128,255,1023")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("paged_decode_sweep: no CUDA device")

    from deepspeed_tpu_torch.ops.attention import decode as dec
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"gpu": smi}), flush=True)
    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    h, kv_h, d, ps = args.heads, args.kv_heads, args.head_dim, args.page_size
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for position in (int(x) for x in args.positions.split(",")):
        maxp = position // ps + 1
        pos = torch.tensor([position], dtype=torch.int32, device=dev)
        sets = []
        for _ in range(8):
            q = torch.randn(1, 1, h, d, generator=g, device=dev).to(dtype)
            kp, vp = (torch.randn(maxp + 1, ps, kv_h, d, generator=g,
                                  device=dev).to(dtype) for _ in range(2))
            pt = torch.randperm(maxp + 1, generator=g, device=dev)[:maxp] \
                .reshape(1, maxp).to(torch.int32)
            kf, vf = (dec.gather_pages(x, pt.long())[:, :position + 1]
                      for x in (kp, vp))
            sets.append((q, kp, vp, pt, kf, vf))
        ms = time_ms([lambda s=s: dec.paged_decode_attention(*s[:4], pos)
                      for s in sets])
        sdpa_ms = time_ms([lambda s=s: F.scaled_dot_product_attention(
            s[0].transpose(1, 2), s[4].transpose(1, 2), s[5].transpose(1, 2),
            enable_gqa=kv_h != h) for s in sets])
        n_bytes = 2 * (position + 1) * kv_h * d * kp.element_size()
        pps = dec.pages_per_split(ps, maxp)
        print(json.dumps({
            "position": position, "heads": h, "kv_heads": kv_h,
            "head_dim": d, "page_size": ps, "dtype": args.dtype,
            "splits": -(-(position + 1) // (pps * ps)),
            "split_keys": pps * ps, "kernel_ms": ms, "sdpa_ms": sdpa_ms,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}), flush=True)


if __name__ == "__main__":
    main()
