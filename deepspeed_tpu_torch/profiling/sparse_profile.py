"""Block-sparse against dense attention on the card, by sequence length
(the port's counterpart of ``benchmarks/ring_bench.py``'s sparse sweep).

    python -m deepspeed_tpu_torch.profiling.sparse_profile \
        [--seqs 8192,16384,32768] [--heads 12] [--head-dim 64] \
        [--reps 3] [--backward] [--seed 0]

For each length: the dense flash kernels (causal, as the sweep runs every
layout), then BigBird and BSLongformer at block 128 (window 3) and block
512 (window 1), one global block, all lower-triangular, through
``flash_attention(..., sparsity_config=)`` in bf16 on [1, len, heads,
head_dim].  Each row prints the layout's density, the forward ms (and
forward + backward with ``--backward``) from CUDA events, the ratio of
the dense flash kernel's time to it, the same ratio for SDPA with the
layout expanded to a boolean mask (timed here only), and the density
ceiling 0.5 / density (causal dense visits about half the square).  The
first line names the card and its power limit.  Needs a CUDA device; it
does not run anywhere else.
"""

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.attention import block_sparse as bs
from deepspeed_tpu_torch.ops.attention.flash import flash_attention


def configs(h):
    return [
        ("bigbird", sa.BigBirdSparsityConfig(
            h, block=128, num_random_blocks=1, num_sliding_window_blocks=3,
            num_global_blocks=1)),
        ("bigbird_b512", sa.BigBirdSparsityConfig(
            h, block=512, num_random_blocks=1, num_sliding_window_blocks=1,
            num_global_blocks=1)),
        ("longformer", sa.BSLongformerSparsityConfig(
            h, block=128, num_sliding_window_blocks=3,
            global_block_indices=[0])),
        ("longformer_b512", sa.BSLongformerSparsityConfig(
            h, block=512, num_sliding_window_blocks=1,
            global_block_indices=[0])),
    ]


def sdpa_mask(layout, block, length, heads, causal, device):
    """SDPA's boolean mask [1, H, L, L] for a block layout: its entries,
    and the causal mask when ``causal`` (the port never calls SDPA; it is
    the yardstick)."""
    mask = bs._element_mask(layout, block, length, heads, device)
    if causal:
        mask = mask & torch.ones(length, length, dtype=torch.bool,
                                 device=device).tril()
    return mask


def event_ms(fn, reps):
    """Per-call time of ``fn`` on the card: CUDA events around ``reps``
    calls after one warm-up (the host enqueues far ahead of ms-long
    kernels)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timings(attend, q, k, v, do, reps, backward):
    """{"fwd": ms[, "fwd_bwd": ms]} of ``attend(q, k, v)`` -> [b, l, h, d]."""
    def fwd():
        with torch.no_grad():
            attend(q, k, v)
    out = {"fwd": event_ms(fwd, reps)}
    if backward:
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]

        def fwd_bwd():
            for t in leaves:
                t.grad = None
            attend(*leaves).backward(do)
        out["fwd_bwd"] = event_ms(fwd_bwd, reps)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seqs", default="8192,16384,32768")
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--backward", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sparse_profile: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"gpu": smi, "torch": torch.__version__}), flush=True)
    dev = torch.device("cuda")
    h, d = args.heads, args.head_dim
    for L in (int(s) for s in args.seqs.split(",") if s):
        g = torch.Generator(device=dev).manual_seed(args.seed + L)
        q, k, v, do = (torch.randn(1, L, h, d, generator=g,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(4))
        dense = timings(lambda *t: flash_attention(*t, causal=True),
                        q, k, v, do, args.reps, args.backward)
        print(json.dumps({"metric": "dense_flash", "seq": L, "ms": dense}),
              flush=True)
        for name, cfg in configs(h):
            layout = np.tril(np.asarray(cfg.make_layout(L)))
            density = float(layout.mean())
            sparse = timings(lambda *t, c=cfg: flash_attention(
                *t, causal=True, sparsity_config=c), q, k, v, do, args.reps,
                args.backward)
            mask = sdpa_mask(layout, cfg.block, L, h, True, dev)
            sdpa = timings(lambda *t: F.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in t), attn_mask=mask)
                .transpose(1, 2), q, k, v, do, args.reps, args.backward)
            del mask
            torch.cuda.empty_cache()
            print(json.dumps({
                "metric": f"sparse_flash_{name}", "seq": L,
                "block": cfg.block, "layout_density": density, "ms": sparse,
                "dense_flash_over_sparse": {
                    k_: dense[k_] / sparse[k_] for k_ in sparse},
                "sdpa_mask_ms": sdpa,
                "sdpa_mask_over_sparse": {
                    k_: sdpa[k_] / sparse[k_] for k_ in sparse},
                "density_ceiling": 0.5 / density}), flush=True)


if __name__ == "__main__":
    main()
