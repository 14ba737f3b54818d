"""Where a serving decode step's time goes on the card.

    python -m deepspeed_tpu_torch.profiling.decode_profile \
        [--layers 32] [--batch 4] [--context 128] [--horizon 8] \
        [--dtype bfloat16|float32|int8] [--kv-dtype int8|fp8|...] \
        [--graph | --eager] [--verify-k 1,2,4,8] [--policy] [--seed 0]

Builds Llama-2-7B at full width (``--layers`` cuts depth) with seeded
random weights, fills ``--batch`` slots of a paged pool to ``--context``
tokens, and profiles one ``decode_multi`` horizon with ``torch.profiler``
(CPU + CUDA activities) after a warm-up horizon: replayed from its CUDA
graph (``--graph``; the warm-up captures it), launched eagerly
(``--eager``, the ``enable_cuda_graph=False`` twin over the same module
and pools), or both, one after the other (the default).  ``--dtype
int8`` serves int8 weights with bf16 compute (``int8_matmul_kernel``
then takes the GEMMs' place among the kernels); ``--kv-dtype``
defaults to the compute dtype (``int8`` / ``fp8`` pools read through
the quantized ``decode_kernel`` instantiations, paged walk).  Prints
one JSON object:
the host-clock step time of an unprofiled horizon, the device time per
step summed over the profiled horizon's kernels, the device's busy and
idle shares of the unprofiled step (the profiler slows the host, not
the kernels), kernels launched per step, the weight bytes a step must
read over the card's memory rate, and the kernels with the most device
time, per mode, with the graph launches per step and the device time
of one horizon between CUDA events.  ``--verify-k`` profiles, per mode,
a 1-step horizon and then one speculative ``verify_multi`` round per
listed K (every slot proposing K drafts, so K+1 columns a slot) over the
same pools, each as one "step": what a verify round costs against a
decode step (``verify_over_step``).  ``--policy`` profiles, beside each
greedy dispatch, its decoding-policy twin over the same pools
(``decode_multi_policy`` / ``verify_multi_policy``) with every slot
sampled — temperature 0.8, top-k 50, top-p 0.95, the three history
penalties over token counts — and reports ``policy_over_greedy``, the
ratio of their device times between CUDA events.  Needs a CUDA device;
it does not run anywhere else.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3


def profile_mode(engine, dispatch, horizon):
    """Host and device time of one ``dispatch()`` on ``engine`` (a
    horizon of ``horizon`` steps, or one verify round with ``horizon``
    1), after a warm-up dispatch, which captures a graph engine's
    bucket."""
    from torch.profiler import ProfilerActivity, profile

    dispatch()[0].cpu()                             # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    dispatch()[0].cpu()
    wall_ms = (time.monotonic() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    dispatch()
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        dispatch()[0].cpu()
        profiled_ms = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("decode_profile: the profiler recorded no device "
                         "kernels")
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "step_ms": wall_ms / horizon,
        "profiled_step_ms": profiled_ms / horizon,
        "device_ms_per_step": device_ms / horizon,
        "event_ms_per_step": start.elapsed_time(end) / horizon,
        "device_busy_share": device_ms / wall_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "kernel_launches_per_step": launches / horizon,
        "graph_launches_per_step": 1.0 / horizon if engine.cuda_graphs
        else 0.0,
        "captures": engine.serving_decode_multi_capture_count() +
        engine.serving_verify_capture_count(),
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "ms_per_step": e.self_device_time_total / 1e3 /
                         horizon} for e in top]}


def policy_lanes(batch, vocab, seed):
    """Every slot sampled: temperature 0.8, top-k 50, top-p 0.95,
    repetition 1.1, presence 0.2, frequency 0.1 over random token
    counts, the grammar mask all-allowed."""
    from deepspeed_tpu_torch.serving.sampling import request_key
    rng = np.random.default_rng(seed)
    return dict(keys=np.stack([request_key(seed + i) for i in range(batch)]),
                tok_base=np.zeros(batch, np.int32),
                temps=np.full(batch, 0.8, np.float32),
                top_ks=np.full(batch, 50, np.int32),
                top_ps=np.full(batch, 0.95, np.float32),
                rep_pens=np.full(batch, 1.1, np.float32),
                pres_pens=np.full(batch, 0.2, np.float32),
                freq_pens=np.full(batch, 0.1, np.float32),
                counts=rng.integers(0, 2, (batch, vocab)).astype(np.int32),
                mask=np.ones((batch, vocab), bool))


def with_ratio(res, greedy):
    """``res`` with its device time over the greedy dispatch's."""
    res["policy_over_greedy"] = res["event_ms_per_step"] / \
        greedy["event_ms_per_step"]
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=128)
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--kv-dtype", default=None)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--graph", action="store_true",
                      help="only the replayed horizon")
    mode.add_argument("--eager", action="store_true",
                      help="only the eager horizon")
    ap.add_argument("--verify-k", default=None,
                    help="comma-separated K: profile a 1-step horizon and "
                    "one verify round per K")
    ap.add_argument("--policy", action="store_true",
                    help="also profile the decoding-policy twins")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile: needs a CUDA device")

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import Llama, llama2_7b

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = llama2_7b(num_layers=args.layers)
    kv_dtype = args.kv_dtype or \
        ("bfloat16" if args.dtype == "int8" else args.dtype)
    model = Llama(cfg, device="cuda")
    kw = dict(dtype=args.dtype, kv_cache_dtype=kv_dtype)
    engine = deepspeed_tpu_torch.init_inference(model, **kw).init_params(
        args.seed)
    modes = ["graph"] if args.graph else ["eager"] if args.eager \
        else ["graph", "eager"]
    engines = {"graph": engine, "eager": deepspeed_tpu_torch.init_inference(
        model, enable_cuda_graph=False, **kw)}
    ks = [int(k) for k in args.verify_k.split(",")] if args.verify_k \
        else []
    ps = 16
    maxp = -(-(args.context + max([args.horizon] + [k + 1 for k in ks]))
             // ps)
    pools = engine.init_paged_cache(args.batch * maxp, ps)
    table = np.arange(args.batch * maxp, dtype=np.int32).reshape(
        args.batch, maxp)
    call = dict(toks=np.zeros(args.batch, np.int32),
                active=np.ones(args.batch, bool), page_table=table,
                lengths=np.full(args.batch, args.context, np.int32),
                pools=pools, horizon=args.horizon,
                budgets=np.full(args.batch, args.horizon, np.int32),
                eos_ids=np.full(args.batch, -1, np.int32))
    lanes = policy_lanes(args.batch, cfg.vocab_size, args.seed)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in (*model.parameters(), *model.buffers()))
    out = {"gpu": smi, "model": "llama2-7b", "layers": args.layers,
           "dtype": args.dtype, "kv_dtype": kv_dtype, "batch": args.batch,
           "context": args.context, "horizon": args.horizon,
           "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3}
    for name in modes:
        eng = engines[name]
        if not ks:
            out[name] = profile_mode(
                eng, lambda: eng.decode_multi(**call), args.horizon)
            if args.policy:
                out[name + "_policy"] = with_ratio(profile_mode(
                    eng, lambda: eng.decode_multi_policy(**call, **lanes),
                    args.horizon), out[name])
            continue
        one = dict(call, horizon=1,
                   budgets=np.ones(args.batch, np.int32))
        res = out[name] = {"horizon_1": profile_mode(
            eng, lambda: eng.decode_multi(**one), 1)}
        rng = np.random.default_rng(args.seed)
        for k in ks:
            verify = dict(
                {n: call[n] for n in ("toks", "active", "page_table",
                                      "lengths", "pools", "eos_ids")},
                drafts=rng.integers(0, cfg.vocab_size, (args.batch, k))
                .astype(np.int32),
                widths=np.full(args.batch, k, np.int32),
                budgets=np.full(args.batch, k + 1, np.int32))
            r = res[f"verify_k{k}"] = profile_mode(
                eng, lambda: eng.verify_multi(**verify), 1)
            r["verify_over_step"] = r["event_ms_per_step"] / \
                res["horizon_1"]["event_ms_per_step"]
            if args.policy:
                res[f"verify_policy_k{k}"] = with_ratio(profile_mode(
                    eng, lambda: eng.verify_multi_policy(**verify, **lanes),
                    1), r)
        if args.policy:
            res["horizon_1_policy"] = with_ratio(profile_mode(
                eng, lambda: eng.decode_multi_policy(**one, **lanes), 1),
                res["horizon_1"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
