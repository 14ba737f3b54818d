"""Where a GPT-2 train step's time goes on the card.

    python -m deepspeed_tpu_torch.profiling.train_profile \
        [--layers 12] [--batch 8] [--seq 1024] [--dtype bfloat16] \
        [--seed 0]

Builds GPT-2 small at full width (``--layers`` cuts depth) through
``deepspeed_tpu_torch.initialize`` with the config ``bench.py`` trains
(AdamW lr 1e-4, weight decay 0.01, ZeRO stage 1, gas 1; ``--dtype
float16`` turns on the ``fp16`` section, dynamic loss scaling with its
overflow check and masked update), seeded random
weights and batches, takes two warm-up steps, times one unprofiled step
on the host clock and profiles one more with ``torch.profiler`` (CPU +
CUDA activities).  Prints one JSON object: the host-clock step, the
device time of the profiled step summed over its kernels, the device's
busy and idle shares of the unprofiled step (the profiler slows the
host, not the kernels), kernels launched per step, device time by
category (cuBLAS GEMMs, the three flash kernels, elementwise,
reductions, optimizer, copies and casts) and the kernels with the most
device time.  Needs a CUDA device; it does not run anywhere else.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

# kernel-name fragments -> category, first match wins
CATEGORIES = (
    ("flash_fwd", ("flash_fwd_wgmma_kernel", "flash_fwd_kernel")),
    ("flash_bwd_dq", ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel")),
    ("flash_bwd_dkv", ("flash_bwd_dkv_wgmma_kernel",
                       "flash_bwd_dkv_kernel")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "splitk")),
    ("optimizer", ("multi_tensor_apply", "foreach")),
    ("copies_casts", ("memcpy", "memset", "copy_kernel", "cat_")),
    ("reductions", ("reduce", "softmax", "norm", "scan")),
    ("elementwise", ("elementwise",)),
)


def category(name):
    low = name.lower()
    for cat, frags in CATEGORIES:
        if any(f in low for f in frags):
            return cat
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2, gpt2_small

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = gpt2_small(num_layers=args.layers, max_seq_len=args.seq,
                     dtype=args.dtype)
    config = {"train_micro_batch_size_per_gpu": args.batch,
              "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "bf16": {"enabled": args.dtype == "bfloat16"},
              "fp16": {"enabled": args.dtype == "float16"},
              "zero_optimization": {"stage": 1},
              "steps_per_print": 1000000}
    engine = deepspeed_tpu_torch.initialize(model=GPT2(cfg), config=config,
                                            seed=args.seed)[0]
    rng = np.random.default_rng(args.seed)
    batch = {"input_ids": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (args.batch, args.seq)), device="cuda")}
    for _ in range(2):                                   # warm-up
        engine.train_batch(batches=[batch])
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine.train_batch(batches=[batch])
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.train_batch(batches=[batch])
        profiled_ms = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("train_profile: the profiler recorded no device "
                         "kernels")
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_cat = {}
    for e in kernels:
        cat = by_cat.setdefault(category(e.key), {"ms": 0.0, "launches": 0})
        cat["ms"] += e.self_device_time_total / 1e3
        cat["launches"] += e.count
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    n_params = sum(p.numel() for p in engine.module.parameters())
    tokens = args.batch * args.seq
    flops = tokens * (6 * n_params +
                      12 * cfg.num_layers * cfg.hidden_size * args.seq)
    print(json.dumps({
        "gpu": smi, "model": "gpt2-small", "layers": args.layers,
        "dtype": args.dtype, "batch": args.batch, "seq": args.seq,
        "params": n_params,
        "step_ms": wall_ms, "profiled_step_ms": profiled_ms,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "kernel_launches_per_step": sum(e.count for e in kernels),
        "tokens_per_s": tokens / wall_ms * 1e3,
        "mfu_vs_989_tflops": flops / (wall_ms / 1e3) / 989e12,
        "device_ms_by_category": {k: v for k, v in sorted(
            by_cat.items(), key=lambda kv: -kv[1]["ms"])},
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "ms": e.self_device_time_total / 1e3}
                        for e in top],
    }), flush=True)


if __name__ == "__main__":
    main()
