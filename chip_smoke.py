#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (deepspeed_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each of which must pass (any failure exits nonzero):

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serve and train paths from the
     sources in the checkout (one nvcc per source, all started together,
     sm_90a; into build/), printing ptxas's registers and spills for
     each kernel instantiation (nvcc's log is kept beside each library,
     so a library built earlier reports the same lines); no
     instantiation of the bf16 or fp16 flash forward
     (flash_fwd_wgmma_kernel) or of the bf16 or fp16 backward pair
     (flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel; dense and
     sparse walk, d 32 / 64 / 128), of the decode kernel (paged and dense
     walk) or of int8_matmul_kernel may spill, and each has its fp16
     instantiations;
  3. decode kernel phase: each decode kernel against its plain PyTorch
     version on the card, fp32, bf16 and fp16, at the serving path's shapes
     (Llama-2-7B heads, a 128-bucketed dense cache, GQA at Llama-2-70B
     head widths, and the dense cache at Falcon-7B's MQA heads, 71 over
     1, d 64: five 16-head tiles; the dense cache also at 8 x 1024 and at
     max_len 200, a last tile cut short, each with its split count and
     share of its bound), and at 32 slots x ~1024 keys for 7B heads,
     70B heads and Falcon-7B's MQA heads (71 over 1 kv head, d 64), with
     its time, the plain version's, SDPA's over the same (gathered) K/V,
     the bandwidth bound and the kernel's share of it; the paged shapes
     again over int8 and fp8 pools (paged_decode_quant_fwd; SDPA then
     runs on the gathered, dequantized buffers); ptxas's registers and
     spills of the paged kernel instantiations;
  3b. int8_matmul kernel phase: int8_matmul_fwd against its plain
     version at the Llama-2-7B projection shapes, m = 4 (decode), 64
     (prefill chunk) and 1, group 64, bf16, fp16 and fp32, with its time, the
     plain version's, the bound, and F.linear on the FLOAT weight of the
     same shape (the layer this one replaces; no single PyTorch call
     computes the quantized function), each with its k split (the
     blocks of a cluster); fp32 batch invariance: a row of an m = 1 or
     m = 4 call equals that row of an m = 64 call bit for bit (a gate),
     and the same check in bf16 and fp16 (printed);
  4. flash kernel phase: flash_fwd and the flash_bwd_dq / flash_bwd_dkv
     pair against their plain versions (o, lse, dq, dk, dv), fp32, bf16
     and fp16, at (a) GPT-2 small training, b 8 h 12 l 1024 d 64 causal,
     (b) b 1 l 4096, (c) q 512 / k 1024 causal, (d) non-causal l 1024,
     (e) Llama-2-7B heads, b 1 h 32 l 2048 d 128; each kernel's time,
     the plain versions', SDPA's forward and forward+backward, and the
     bound max(flops / peak, bytes / 3.35 TB/s), with the forward's
     share of its bound and its ratio to SDPA's forward, and the
     backward's (the delta pre-pass and the pair) share of its bound and
     its ratio to SDPA's backward;
  4b. block-sparse kernel phase: sparse_fwd and the sparse_bwd_dq /
     sparse_bwd_dkv pair against their plain versions (o, lse, dq, dk,
     dv), bf16, fp16 and fp32, at b 1 l 4096 h 12 d 64 over six layouts
     (the fp16 pass counts its own launches):
     BigBird and BSLongformer bidirectional (block 128), Fixed
     unidirectional with a layout per head (4 global patterns), Variable
     bidirectional with random blocks, Fixed unidirectional at block 32
     (the fine-bit path), and the dense config, whose outputs must also
     match the dense flash kernels; each kernel's time, the plain
     versions', SDPA's with the layout expanded to a boolean mask, and
     the bound;
  4c. sparse attention phase, the block-sparse slice at full width:
     SparseSelfAttention forward and backward at b 1 l 16384 h 12 d 64
     bf16 (BERT-base / GPT-2-small heads) for BigBird and BSLongformer
     bidirectional and Fixed unidirectional; two runs must be bit-equal
     and head 0 must match the plain versions; density, ms forward and
     forward + backward beside the dense flash kernels, SDPA with the
     expanded mask, and the bound;
  5. serve phase, fp32: full Llama-2-7B (32 layers, seeded random
     weights) through init_inference + ServingScheduler, more requests
     than slots, with the defaults: every decode horizon replayed from a
     CUDA graph captured once per horizon bucket, and horizons chained
     off the device carries while membership is frozen (overlap); every
     request's greedy tokens must equal its own generate() tokens, at
     least one horizon must be chained, and every serve phase fails when
     a scheduler's captures exceed its horizon buckets;
  6e. speculative decoding, fp32, on phase 5's engine: four prompts of
     one token repeated (over which even random weights loop, so the
     n-gram drafter hits), then phase 5's requests, served (a) with spec_decode="ngram", spec_k=8,
     twice on one scheduler, (b) with a DraftModelDrafter over a second
     fp32 engine of the same module (self-draft: nearly every draft
     accepted), (c) with a DraftModelDrafter over a 2-layer model at
     Llama-2-7B width with its own seeded weights (most drafts rejected,
     so rollbacks cross page boundaries); every request must equal its
     own generate() tokens (a mismatch prints the top-2 logit margin at
     the first divergent token), each run must dispatch verify rounds
     and contain no drafter fault (spec_degraded 0), (a) and (b) must
     accept drafts, every page of the target and the draft pools must
     come back, and verify captures must stay within the spec-K buckets
     and be 0 in (a)'s second run; verify ms per round (CUDA events) and
     the acceptance are printed;
  6f. prefix cache and decoding policies, fp32, on phase 5's engine
     (which must hold no policy graph yet: greedy serving captures
     none): (a) six requests over a 96-token shared prefix, the donor
     first, the tails ending inside its donated pages (copy-on-write)
     or unique (full-page hits), on one prefix-cache scheduler: every
     token equals generate(), hits > 0, copies > 0, at most one
     copy_page graph, every page back after a full drain; (b) the same
     over int8 pools: the streams with the cache equal those without,
     and each copied page's four leaves equal the source bit for bit;
     (c) phase 5's requests as a mixed batch (greedy rows, sampled rows
     at T 0.8, top-k 50, top-p 0.95 with the three history penalties,
     one JSON-schema row): the greedy rows equal generate(), the streams
     are identical across two fresh schedulers, horizons 1 and 8 and a
     20-page pool that evicts, the grammar output is valid and complete,
     policy captures stay within each scheduler's buckets; then the
     motif prompts beside a sampled row with spec_decode="ngram": a
     policy verify round must carry drafts; (d) after phases 6 and 6b,
     the mixed batch twice on one bf16 and one int8 / int8 scheduler
     beside the same requests all greedy (tokens/s, run-to-run identity
     and agreement printed; grammar validity checked); the launches of
     paged_decode_fwd (a, c, bf16 d), paged_decode_quant_fwd (b, int8 d)
     and int8_matmul_fwd (int8 d) must be > 0;
  6. serve phase, bf16: the same requests on the eager twin
     (enable_cuda_graph=False, overlap=False), then twice on one graph
     scheduler: the first run captures, the second is the steady one;
     tokens/s, ms per step, TTFT p50 / p90 and TBT of both engines, the
     captures and their seconds, the chained horizons (at least one),
     the token agreement of the graph run with the eager twin and with
     fp32 are printed (the step-time breakdown is
     deepspeed_tpu_torch/profiling/decode_profile.py); then the same
     requests and the motif prompts with spec_decode="ngram" on the
     graph engine, twice, against the same requests without spec:
     agreement, tokens/s, acceptance and verify ms per round printed,
     not asserted (a verify's multi-row GEMMs and plain attention round
     differently from the decode kernels in bf16);
  6b. serve phase, the main quantized configuration: dtype="int8"
     (int8 weights, group 64, bf16 compute) with kv_cache_dtype="int8",
     the same requests, the resident module quantized in place, run as
     phase 6 runs them (eager twin, then one graph scheduler twice);
     tokens/s, step and first-token times; the two graph runs must give
     identical tokens; the spec run of phase 6 follows on this engine;
     summary()'s kv_pool_bytes_total must equal the leaves' bytes and
     (num_pages + 1) x kv_page_bytes; on the live pools after the run
     the quantized paged kernel must equal its plain version; agreement
     with generate() and the fp32 run is printed, not asserted (random
     weights make near-ties common); one 200-token sequence is
     teacher-forced through chunked prefill into float32 pools and into
     int8 pools and the largest boundary-logit difference is held under
     KV_LOGIT_DELTA_CEILING; then two requests over fp8 pools
     (ServingScheduler(kv_dtype="fp8"));
  6c. serve phase, int8 weights with fp32 compute and float32 KV
     (dtype="float32", quant enabled; weights drawn again from the
     seed): every request's tokens must equal its own generate() tokens;
  6d. serve phase, grouped heads: Llama-2-70B widths (64 heads over 8 kv
     heads) at 2 layers, bf16, a few short requests over bfloat16 and
     over int8 pools, so both paged kernels launch at group 8 on a
     serving path;
  6g. GPT-2 family serving: decode_fwd against its plain version at
     GPT-2 small heads (12 x 64) without and with ALiBi, BLOOM-560m heads
     (16 x 64) with ALiBi and GPT-J heads (16 x 256), paged_decode_fwd /
     paged_decode_quant_fwd at GPT-J heads; then, with seeded random
     weights and configs written here after their public config.json:
     (a) GPT-2 small fp32 through graph + overlap serving, an n-gram spec
     run over the motif prompts and a prefix-cache run, each token-exact
     against generate(); (b) GPT-2 small bf16 (a serve smoke reading)
     and int8 weights over int8 KV on the same module (two runs
     identical, teacher-forced logit delta under KV_LOGIT_DELTA_CEILING);
     (c) BLOOM-560m, Pythia-160m, OPT-125m and GPT-J-6B width at 2 layers
     served token-exact against generate() in fp32, BLOOM's paged decode
     (ALiBi) launching decode_fwd and no paged kernel; (d) GPT-Neo-125M
     generate() past its 256-token window equal to a full forward's
     argmax, and its scheduler refused (local windows over pools, as in
     the JAX model); decode_fwd, paged_decode_fwd, paged_decode_quant_fwd
     and int8_matmul_fwd must each launch in the phase;
  6h. HF ingestion: two save_pretrained-layout directories written here
     without transformers or safetensors, from seeded weights, with
     config.json copied from the public files: Llama-2-7B width (2 of
     32 layers) as bf16 safetensors over two shards with an index, and
     GPT-2 small (full) as fp32 pytorch_model.bin with Conv1D names;
     each through init_inference(<dir>, dtype="float32"): every
     ingested weight equal to the file's after the layout map, graph +
     overlap serving token-exact against generate() over phase 5's
     requests; the Llama directory again with dtype="int8" and int8 KV,
     two runs identical; ingest seconds and GB/s; paged_decode_fwd,
     paged_decode_quant_fwd, int8_matmul_fwd and decode_fwd must each
     launch in the phase;
  6i. fp16 serving at full width: Llama-2-70B heads at 2 layers over
     fp16 and int8 pools (rows 2 and 2q at fp16); Llama-2-7B, 32 layers,
     phase 5's seeded weights (drawn in fp32, cast to fp16), through
     init_inference(dtype="float16", kv_cache_dtype="float16") and graph
     + overlap serving of phase 5's requests, twice on one scheduler:
     the two runs identical, every logit finite (a non-finite one names
     the first layer that overflowed), a 200-token teacher-forced
     prefill's boundary logits within FP16_LOGIT_DELTA_CEILING of the
     fp32 engine's, agreement with fp16 generate() printed; then fp16
     compute over int8 weights and int8 KV (two runs identical);
     OPT-125m (full) and BLOOM-560m (2 layers, ALiBi through decode_fwd
     alone) in fp16, two runs identical; a "torch_dtype": "float16"
     safetensors directory (Llama-2-7B width, 2 layers) through
     init_inference(<dir>, dtype="float16"), its weights equal to the
     files;
  7. train phase, fp32 oracle: GPT-2 small width at 2 layers, batch 2 x
     1024, one step through the flash kernels and one through the plain
     reference attention from the same weights; the loss, the global
     grad norm and the attention projections' gradients must agree;
  8. train phase, bf16: full GPT-2 small (124M parameters, batch 8 x
     1024) through initialize + train_batch with bench.py's config,
     3 warm-up and 10 timed steps, then a gas-4 window at micro batch 2;
     losses must be finite and fall; tokens/s, ms/step, peak memory and
     MFU are printed (the step breakdown is
     deepspeed_tpu_torch/profiling/train_profile.py);
  8b. checkpoints of phase 8's engine: save, two more steps; a fresh
     engine loads and takes the same two steps (losses, masters and
     moments equal bit for bit); an async save followed at once by a
     step leaves the pre-step masters in the files; verify_checkpoint
     passes, a flipped byte fails it and raises CheckpointCorrupt at
     load; init_inference(checkpoint=) serves the saved weights with
     logits equal to an fp32 module of them and, in bf16, to the
     training module's own; save / async-return / load seconds and
     bytes;
  8f. fp16 training: phase 8's GPT-2 small with "fp16": {"enabled":
     true} (dynamic, initial_scale_power 16), 3 warm-up and 10 timed
     steps, losses finite and falling, loss scale, skipped steps,
     tokens/s, ms/step, peak memory and MFU beside phase 8's bf16; a
     checkpoint save / load round trip (losses, masters, moments, count
     and scaler bit-equal to the uninterrupted run); then a run from
     initial_scale_power 32: its first steps overflow, each skipped
     step leaves masters, moments and count bit-equal, the scale follows
     the reference rule (hysteresis 2, then halving) and the run then
     trains;
  9. the launch count of every kernel over its path, CUDA-graph replays
     included (decode kernels over
     phases 5-6e, the quantized paged kernel and int8_matmul_fwd over
     phases 6b-6c (int8_matmul_fwd also in 6b's verify rounds), the grouped instantiations over 6d, flash kernels
     over phase 8, block-sparse kernels over phase 4c; each must be > 0;
     ``launches_6f`` counts phase 6f's, ``launches_6g`` phase 6g's,
     ``launches_6h`` phase 6h's, ``launches_8b`` phase 8b's; the flash
     kernels must launch in 8b); each kernel's fp16 numbers beside its
     bf16 ones and ``launches_fp16``, its float16 launches (rows 1-3q and
     12 in 6i, the flash kernels in 8f, the block-sparse kernels in 4b's
     fp16 pass), each > 0.

Each line of output is one JSON object; the last is
{"ok": true, "device": {...}}.  TF32 is off for matmuls and cuDNN so
the fp32 phase is a true fp32 oracle.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # dense tensor-core peak, bf16 and fp16
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
# kernel vs plain version, max abs error (int8_matmul: relative above
# magnitude 1).  fp16 keeps 10 mantissa bits against bf16's 7, so one
# rounding of a value near 1 is 2^-11 against 2^-8: the same number of
# roundings (P, the operands of each product, the output) that bf16's
# 3e-2 allows come to 3e-2 / 8 = 3.75e-3 in fp16, taken as 4e-3.
TOL = {"float32": 1e-4, "bfloat16": 3e-2, "float16": 4e-3}
# largest |logit(float32 pools) - logit(int8 pools)| over the boundary
# rows of a teacher-forced 200-token prefill, bf16 compute over int8
# weights, seeded random Llama-2-7B weights: the first measurement on the
# card read 0.618 at a largest |logit| of 6.03 (PERF.md; random weights
# amplify a perturbation through 32 layers, and the float32-pool run also
# attends in float32 where the int8-pool run attends in bf16).  The
# ceiling is 2.4 times that: a row scaled wrongly moves logits by their
# whole magnitude.
KV_LOGIT_DELTA_CEILING = 1.5
# largest |logit(fp16 engine, fp16 pools) - logit(fp32 engine, fp32
# pools)| over the boundary rows of the same teacher-forced 200-token
# prefill, seeded random Llama-2-7B weights (phase 6i): the first reading
# on the card was 0.0528 at a largest |logit| of 5.89 (PERF.md).  The
# ceiling is 2.4 times that, as for KV_LOGIT_DELTA_CEILING: a kernel that
# is wrong in fp16 moves logits by their whole magnitude.
FP16_LOGIT_DELTA_CEILING = 0.13


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(n_bytes, n_flops, dtype_name):
    peak = BF16_FLOPS if dtype_name in ("bfloat16", "float16") \
        else FP32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def time_ms(torch, calls, reps=10):
    """Per-call device time of ``calls`` (zero-argument callables, one per
    rotated input set so successive calls do not find their data in L2):
    one pass over them is captured in a CUDA graph and replayed, so the
    host's launch overhead is not in the number."""
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


def sdpa_inputs(q, k, v):
    """[b, l, h, d] -> SDPA's [b, h, l, d] views (no copies)."""
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def ptxas_usage(logs):
    """ptxas -v's report per kernel instantiation: the mangled entry name
    with its registers and spill line."""
    out, entry, spill = [], None, ""
    for log in logs.values():
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln.strip()
            elif "spill" in ln:
                spill = ln.strip()
            elif "registers" in ln and entry is not None:
                out.append({"kernel": entry, "usage": ln.strip(),
                            "spill": spill})
                entry = None
    return out


# ------------------------------------------------------------ kernel phase


def paged_case(torch, dec, name, h, kv_h, d, ps, positions, dtype,
               rotations, seed, kv_name=None):
    """One paged-decode shape: check the kernel against the plain version
    and time kernel / plain / SDPA over ``rotations`` copies of the pool.
    ``kv_name`` ("int8" / "fp8") quantizes the pools per row, which sends
    the call to ``paged_decode_quant_fwd``."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.quant import kv as kvq
    dev = torch.device("cuda")
    slots = len(positions)
    maxp = (max(positions) // ps) + 1
    num_pages = slots * maxp + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    sets = []
    for _ in range(rotations):
        q = torch.randn(slots, 1, h, d, generator=g, device=dev).to(dtype)
        kp = torch.randn(num_pages, ps, kv_h, d, generator=g,
                         device=dev).to(dtype)
        vp = torch.randn(num_pages, ps, kv_h, d, generator=g,
                         device=dev).to(dtype)
        pt = torch.randperm(num_pages, generator=g, device=dev)[
            :slots * maxp].reshape(slots, maxp).to(torch.int32)
        scales = {}
        if kv_name is not None:
            kp, scales["k_scale"] = kvq.quantize_kv_rows(kp, kv_name)
            vp, scales["v_scale"] = kvq.quantize_kv_rows(vp, kv_name)
        sets.append((q, kp, vp, pt, scales))
    q, kp, vp, pt, scales = sets[0]
    got = dec.paged_decode_attention(q, kp, vp, pt, pos, **scales)
    want = dec.paged_decode_attention_plain(q, kp, vp, pt, pos, **scales)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    dtype_name = str(dtype).replace("torch.", "")
    if not err < TOL[dtype_name]:
        fail(f"{name}: kernel vs plain max abs err {err} >= "
             f"{TOL[dtype_name]}")
    # SDPA over the pages gathered to contiguous buffers, dequantized
    # where the pool is quantized (gather and dequantize untimed)
    lib_sets = []
    for q_, kp_, vp_, pt_, sc_ in sets:
        kf, vf = kvq.paged_gather(dict(k_pages=kp_, v_pages=vp_, **sc_),
                                  pt_.long(), dtype)
        mask = (torch.arange(kf.shape[1], device=dev)[None, :] <=
                pos.long()[:, None])[:, None, None, :]
        lib_sets.append((*sdpa_inputs(q_, kf, vf), mask))
    ms = time_ms(torch, [
        lambda s=s: dec.paged_decode_attention(*s[:4], pos, **s[4])
        for s in sets])
    plain_ms = time_ms(torch, [
        lambda s=s: dec.paged_decode_attention_plain(*s[:4], pos, **s[4])
        for s in sets])
    library_ms = time_ms(torch, [
        lambda a=a: F.scaled_dot_product_attention(
            a[0], a[1], a[2], attn_mask=a[3], enable_gqa=kv_h != h)
        for a in lib_sets])
    item = q.element_size()
    live = sum(p + 1 for p in positions)
    # a live row costs its payload, plus one f32 scale when quantized
    row_bytes = d * kp.element_size() + (4 if kv_name else 0)
    n_bytes = 2 * live * kv_h * row_bytes + 2 * q.numel() * item + \
        pt.numel() * 4 + slots * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * live * h * d, dtype_name)
    out = {"phase": "kernel",
           "kernel": "paged_decode_quant_fwd" if kv_name else
           "paged_decode_fwd", "kv_dtype": kv_name or dtype_name,
           "case": name,
           "dtype": dtype_name, "slots": slots, "heads": h, "kv_heads": kv_h,
           "head_dim": d, "page_size": ps, "positions": list(positions),
           "max_abs_err": err, "tol": TOL[dtype_name], "kernel_ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / ms, "bytes": n_bytes}
    emit(out)
    return out


def rel_err(got, want):
    """max |got - want| / max(1, |want|): absolute below magnitude 1,
    relative above it (one bf16 rounding of an output of magnitude 4 is
    already 0.03 absolute)."""
    want = want.float()
    return ((got.float() - want).abs() / want.abs().clamp(min=1.0)) \
        .max().item()


def int8_matmul_case(torch, kern, tq, m, k, n, group, dtype, rotations,
                     seed):
    """One int8_matmul shape: kernel against plain (by :func:`rel_err`)
    and kernel / plain / float-layer times over ``rotations`` weights."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    dtype_name = str(dtype).replace("torch.", "")
    sets = []
    for _ in range(rotations):
        x = torch.randn(m, k, generator=g, device=dev).to(dtype)
        w = torch.randn(k, n, generator=g, device=dev) * 0.02
        q, scale = tq.quantize(w.to(dtype), group_size=group)
        # the float layer this one replaces: nn.Linear's [out, in] weight
        sets.append((x, q, scale, w.t().contiguous().to(dtype)))
        del w
    x, q, scale, _ = sets[0]
    got = kern.int8_matmul(x, q, scale)
    want = kern.int8_matmul_plain(x, q, scale)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    abs_err = (got.float() - want.float()).abs().max().item()
    label = f"int8_matmul m{m} k{k} n{n} {dtype_name}"
    if not err < TOL[dtype_name]:
        fail(f"{label}: kernel vs plain error {err} >= {TOL[dtype_name]}")
    ms = time_ms(torch, [lambda s=s: kern.int8_matmul(*s[:3]) for s in sets])
    plain_ms = time_ms(torch, [lambda s=s: kern.int8_matmul_plain(*s[:3])
                               for s in sets])
    float_ms = time_ms(torch, [lambda s=s: F.linear(s[0], s[3])
                               for s in sets])
    item = x.element_size()
    n_bytes = k * n + 4 * (k // group) * n + (m * k + m * n) * item
    b_ms, b_by = bound_ms(n_bytes, 2 * m * k * n, dtype_name)
    splits = kern.k_splits(k, n, group)
    out = {"phase": "int8_matmul_kernel", "kernel": "int8_matmul_fwd",
           "dtype": dtype_name, "m": m, "k": k, "n": n, "group": group,
           "n_splits": splits, "cluster": [splits, 1, 1],
           "blocks": splits * -(-n // kern.BLOCK_N) * -(-m // 64),
           "max_rel_err": err, "max_abs_err": abs_err,
           "tol": TOL[dtype_name], "kernel_ms": ms, "plain_ms": plain_ms,
           "float_linear_ms": float_ms, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": n_bytes,
           "share_of_memory_rate": n_bytes / HBM_BYTES_PER_S * 1e3 / ms}
    emit(out)
    return out


def batch_invariance(torch, kern, tq, seed, dtype_name="float32"):
    """Row i of an m-row call must equal, bit for bit, the same row
    computed alone (m = 1), in a decode-sized batch (m = 4) and in a
    second run — the scheduler (m = slots or chunk) and generate() (m = 1
    or prompt length) must see one arithmetic.  A gate in fp32 (the
    serving oracle); printed in bf16."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(64, 4096, generator=g, device=dev).to(
        getattr(torch, dtype_name))
    q, scale = tq.quantize(
        torch.randn(4096, 4096, generator=g, device=dev) * 0.02,
        group_size=64)
    full = kern.int8_matmul(x, q, scale)
    checks = {"rerun": torch.equal(full, kern.int8_matmul(x, q, scale))}
    for rows in ((0, 1), (0, 4), (37, 38), (13, 20)):
        part = kern.int8_matmul(x[rows[0]:rows[1]].contiguous(), q, scale)
        checks[f"rows {rows[0]}:{rows[1]}"] = torch.equal(
            part, full[rows[0]:rows[1]])
    torch.cuda.synchronize()
    emit({"phase": "int8_matmul_batch_invariance", "dtype": dtype_name,
          "k": 4096, "n": 4096, "bitwise_equal": checks})
    if dtype_name == "float32" and not all(checks.values()):
        fail(f"int8_matmul is not batch invariant in fp32: {checks}")


def dense_case(torch, dec, name, b, h, kv_h, d, max_len, positions, dtype,
               rotations, seed, alibi=False):
    """One dense-walk shape of ``decode_fwd`` against its plain version,
    timed beside SDPA; ``alibi`` adds BLOOM's slope x key-position term
    to the validity mask (the bias is then [b, h, 1, max_len])."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.models.gpt2 import alibi_slopes
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.tensor(positions, device=dev)
    bias = torch.where(torch.arange(max_len, device=dev)[None, :] <=
                       pos[:, None], 0.0, torch.finfo(torch.float32).min)
    bias = bias[:, None, None, :]          # [b, 1, 1, max_len], broadcast
    if alibi:
        bias = bias + alibi_slopes(h).to(dev)[None, :, None, None] * \
            torch.arange(max_len, device=dev)[None, None, None, :]
    sets = []
    for _ in range(rotations):
        sets.append(tuple(
            torch.randn(*shape, generator=g, device=dev).to(dtype)
            for shape in ((b, 1, h, d), (b, max_len, kv_h, d),
                          (b, max_len, kv_h, d))))
    q, k, v = sets[0]
    got = dec.decode_attention(q, k, v, bias=bias)
    want = dec.decode_attention_plain(q, k, v, bias=bias)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    dtype_name = str(dtype).replace("torch.", "")
    if not err < TOL[dtype_name]:
        fail(f"{name}: kernel vs plain max abs err {err} >= "
             f"{TOL[dtype_name]}")
    ms = time_ms(torch, [lambda s=s: dec.decode_attention(*s, bias=bias)
                         for s in sets])
    plain_ms = time_ms(torch, [
        lambda s=s: dec.decode_attention_plain(*s, bias=bias) for s in sets])
    lib_bias = bias.to(dtype)
    library_ms = time_ms(torch, [
        lambda s=s: F.scaled_dot_product_attention(
            *sdpa_inputs(*s), attn_mask=lib_bias,
            enable_gqa=kv_h != h) for s in sets])
    item = q.element_size()
    n_bytes = 2 * b * max_len * kv_h * d * item + 2 * q.numel() * item + \
        bias.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * b * max_len * h * d, dtype_name)
    split_keys = dec.dense_split_keys(max_len)
    out = {"phase": "kernel", "kernel": "decode_fwd", "case": name,
           "alibi": alibi,
           "dtype": dtype_name, "batch": b, "heads": h, "kv_heads": kv_h,
           "head_dim": d, "max_len": max_len, "positions": list(positions),
           "split_keys": split_keys, "n_splits": -(-max_len // split_keys),
           "max_abs_err": err, "tol": TOL[dtype_name], "kernel_ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
           "bound_by": b_by, "share_of_bound": b_ms / ms, "bytes": n_bytes}
    emit(out)
    return out


def attended_pairs(lq, lk, causal):
    """(query, key) pairs the inputs need: query i sees keys
    j <= i + lk - lq when causal."""
    if not causal:
        return lq * lk
    return sum(min(lk, max(0, i + lk - lq + 1)) for i in range(lq))


def flash_case(torch, fl, name, b, lq, lk, h, d, causal, dtype, rotations,
               seed):
    """One flash shape: the forward kernel and the backward pair against
    their plain versions, then kernel / plain / SDPA times and bounds."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    dtype_name = str(dtype).replace("torch.", "")
    sets = []
    for _ in range(rotations):
        q, k, v, do = (torch.randn(b, n, h, d, generator=g,
                                   device=dev).to(dtype)
                       for n in (lq, lk, lk, lq))
        sets.append((q, k, v, do))
    q, k, v, do = sets[0]
    o, lse = fl.flash_fwd(q, k, v, causal=causal)
    o_p, lse_p = fl.flash_fwd_plain(q, k, v, causal=causal)
    grads = fl.flash_bwd(q, k, v, o_p, lse_p, do, causal=causal)
    grads_p = fl.flash_bwd_plain(q, k, v, o_p, lse_p, do, causal=causal)
    torch.cuda.synchronize()
    live = lse_p > fl.NEG_INF / 2
    if not torch.equal(lse[~live], lse_p[~live]):
        fail(f"{name} {dtype_name}: fully masked rows must give lse = "
             "NEG_INF")
    errs = {"o": (o.float() - o_p.float()).abs().max().item(),
            "lse": (lse[live] - lse_p[live]).abs().max().item()}
    for label, got, want in zip(("dq", "dk", "dv"), grads, grads_p):
        errs[label] = (got.float() - want.float()).abs().max().item()
    bad = {k_: e for k_, e in errs.items() if not e < TOL[dtype_name]}
    if bad:
        fail(f"{name} {dtype_name}: kernel vs plain max abs err {bad} >= "
             f"{TOL[dtype_name]}")

    # per-set forward results and backward inputs (untimed)
    bwd_in = []
    for q_, k_, v_, do_ in sets:
        o_, lse_ = fl.flash_fwd(q_, k_, v_, causal=causal)
        bwd_in.append((fl._bwd_inputs(q_, k_, v_, o_, lse_, do_, None),
                       (q_, k_, v_, o_, lse_, do_)))
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ms = {
        "fwd": time_ms(torch, [
            lambda s=s: fl.flash_fwd(*s[:3], causal=causal) for s in sets]),
        "bwd_dq": time_ms(torch, [
            lambda a=a: fl._launch_bwd("flash_bwd_dq", *a[0], (dq,), causal,
                                       None) for a in bwd_in]),
        "bwd_dkv": time_ms(torch, [
            lambda a=a: fl._launch_bwd("flash_bwd_dkv", *a[0], (dk, dv),
                                       causal, None) for a in bwd_in]),
        "bwd": time_ms(torch, [
            lambda a=a: fl.flash_bwd(*a[1], causal=causal) for a in bwd_in]),
        "plain_fwd": time_ms(torch, [
            lambda s=s: fl.flash_fwd_plain(*s[:3], causal=causal)
            for s in sets]),
        "plain_bwd": time_ms(torch, [
            lambda a=a: fl.flash_bwd_plain(*a[1], causal=causal)
            for a in bwd_in]),
    }
    # SDPA, timed here only (the port never calls it): is_causal is
    # top-left aligned, so an offset case passes the bottom-right mask
    mask = None
    if causal and lq != lk:
        mask = (torch.arange(lk, device=dev)[None, :] <=
                torch.arange(lq, device=dev)[:, None] + (lk - lq))
    kw = dict(attn_mask=mask, is_causal=causal and mask is None)
    ms["sdpa_fwd"] = time_ms(torch, [
        lambda s=s: F.scaled_dot_product_attention(*sdpa_inputs(*s[:3]), **kw)
        for s in sets])
    # forward + backward through autograd, captured whole in the graph
    leaves = [x.detach().clone().requires_grad_() for x in sets[0][:3]]
    do_t = sets[0][3].transpose(1, 2)
    ms["sdpa_fwd_bwd"] = time_ms(torch, [
        lambda: F.scaled_dot_product_attention(
            *sdpa_inputs(*leaves), **kw).backward(do_t)])

    pairs = b * h * attended_pairs(lq, lk, causal)
    item = q.element_size()
    rows_q, rows_k, stats = b * lq * h * d, b * lk * h * d, b * h * lq * 4
    bound = {
        "fwd": bound_ms((2 * rows_q + 2 * rows_k) * item + stats,
                        4 * pairs * d, dtype_name),
        # dq alone: S, dP and dS.K; dk/dv alone: S, dP, P^T.dO and dS^T.Q
        "bwd_dq": bound_ms((3 * rows_q + 2 * rows_k) * item + 2 * stats,
                           6 * pairs * d, dtype_name),
        "bwd_dkv": bound_ms((2 * rows_q + 4 * rows_k) * item + 2 * stats,
                            8 * pairs * d, dtype_name),
        # the pair as one fused function: five products
        "bwd": bound_ms((3 * rows_q + 4 * rows_k) * item + 2 * stats,
                        10 * pairs * d, dtype_name)}
    out = {"phase": "flash_kernel", "case": name, "dtype": dtype_name,
           "batch": b, "q_len": lq, "k_len": lk, "heads": h, "head_dim": d,
           "causal": causal, "max_abs_err": errs, "tol": TOL[dtype_name],
           "ms": ms, "bound_ms": {k_: v_[0] for k_, v_ in bound.items()},
           "bound_by": {k_: v_[1] for k_, v_ in bound.items()},
           "sdpa_bwd_ms": ms["sdpa_fwd_bwd"] - ms["sdpa_fwd"],
           "fwd_bound_share": bound["fwd"][0] / ms["fwd"],
           "fwd_vs_sdpa": ms["fwd"] / ms["sdpa_fwd"]}
    out["bwd_bound_share"] = bound["bwd"][0] / ms["bwd"]
    out["bwd_vs_sdpa"] = ms["bwd"] / out["sdpa_bwd_ms"]
    emit(out)
    return out


def layout_pairs(layout, block, causal, heads):
    """(query, key) pairs a block layout [H, n, n] lets through over
    ``heads`` heads; causal layouts are lower-triangular, and their
    diagonal blocks hold block * (block + 1) / 2 pairs."""
    diag = int(sum(layout[h].trace() for h in range(layout.shape[0])))
    full = int(layout.sum()) - (diag if causal else 0)
    pairs = full * block * block + \
        (diag * block * (block + 1) // 2 if causal else 0)
    return pairs * (heads if layout.shape[0] == 1 else 1)


def sparse_case(torch, bs, fl, name, cfg, causal, dtype, rotations, seed,
                b=1, L=4096, h=12, d=64):
    """One block-sparse layout at [b, L, h, d]: the forward kernel and the
    backward pair against their plain versions (by :func:`rel_err`), for
    the dense config against the dense flash kernels too, then kernel /
    plain / SDPA times and bounds."""
    import numpy as np
    import torch.nn.functional as F

    from deepspeed_tpu_torch.profiling.sparse_profile import sdpa_mask
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    dtype_name = str(dtype).replace("torch.", "")
    layout = np.asarray(cfg.make_layout(L))
    if causal:
        layout = np.tril(layout)
    block = int(cfg.block)
    index = bs.SparseIndex(layout, block=block)
    layout_t = torch.as_tensor(layout, device=dev)
    sets = [tuple(torch.randn(b, L, h, d, generator=g, device=dev).to(dtype)
                  for _ in range(4)) for _ in range(rotations)]
    q, k, v, do = sets[0]
    plain_kw = dict(block=block, causal=causal)
    o, lse = bs.sparse_fwd(q, k, v, index, causal=causal)
    o_p, lse_p = bs.sparse_fwd_plain(q, k, v, layout_t, **plain_kw)
    grads = bs.sparse_bwd(q, k, v, o_p, lse_p, do, index, causal=causal)
    grads_p = bs.sparse_bwd_plain(q, k, v, o_p, lse_p, do, layout_t,
                                  **plain_kw)
    torch.cuda.synchronize()
    label = f"sparse {name} {dtype_name}"
    live = lse_p > fl.NEG_INF / 2
    if not torch.equal(lse[~live], lse_p[~live]):
        fail(f"{label}: rows with no active key must give lse = NEG_INF")
    pairs = {"o": (o, o_p), "lse": (lse[live], lse_p[live]),
             **dict(zip(("dq", "dk", "dv"), zip(grads, grads_p)))}
    errs = {k_: rel_err(*t) for k_, t in pairs.items()}
    abs_errs = {k_: (t[0].float() - t[1].float()).abs().max().item()
                for k_, t in pairs.items()}
    bad = {k_: e for k_, e in errs.items() if not e < TOL[dtype_name]}
    if bad:
        fail(f"{label}: kernel vs plain error {bad} >= {TOL[dtype_name]}")
    out = {"phase": "sparse_kernel", "case": name, "config": type(cfg).__name__,
           "dtype": dtype_name, "batch": b, "len": L, "heads": h,
           "head_dim": d, "block": block, "causal": causal,
           "layout_heads": int(layout.shape[0]),
           "density": float(layout.mean()), "index_tile": index.tile,
           "max_rel_err": errs, "max_abs_err": abs_errs,
           "tol": TOL[dtype_name]}
    if name == "dense":
        o_f, lse_f = fl.flash_fwd(q, k, v, causal=causal)
        grads_f = fl.flash_bwd(q, k, v, o_p, lse_p, do, causal=causal)
        torch.cuda.synchronize()
        vs = {"o": (o, o_f), "lse": (lse, lse_f),
              **dict(zip(("dq", "dk", "dv"), zip(grads, grads_f)))}
        out["vs_dense_flash_rel_err"] = {k_: rel_err(*t)
                                         for k_, t in vs.items()}
        out["vs_dense_flash_bit_equal"] = all(torch.equal(*t)
                                              for t in vs.values())
        bad = {k_: e for k_, e in out["vs_dense_flash_rel_err"].items()
               if not e < TOL[dtype_name]}
        if bad:
            fail(f"{label}: the dense config disagrees with the dense flash "
                 f"kernels: {bad}")

    bwd_in = []
    for q_, k_, v_, do_ in sets:
        o_, lse_ = bs.sparse_fwd(q_, k_, v_, index, causal=causal)
        bwd_in.append((fl._bwd_inputs(q_, k_, v_, o_, lse_, do_, None),
                       (q_, k_, v_, o_, lse_, do_)))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ms = {
        "fwd": time_ms(torch, [
            lambda s=s: bs.sparse_fwd(*s[:3], index, causal=causal)
            for s in sets]),
        "bwd_dq": time_ms(torch, [
            lambda a=a: bs._launch("sparse_bwd_dq", index, a[0], (dq,),
                                   causal, None) for a in bwd_in]),
        "bwd_dkv": time_ms(torch, [
            lambda a=a: bs._launch("sparse_bwd_dkv", index, a[0], (dk, dv),
                                   causal, None) for a in bwd_in]),
        "bwd": time_ms(torch, [
            lambda a=a: bs.sparse_bwd(*a[1], index, causal=causal)
            for a in bwd_in]),
        "plain_fwd": time_ms(torch, [
            lambda s=s: bs.sparse_fwd_plain(*s[:3], layout_t, **plain_kw)
            for s in sets]),
        "plain_bwd": time_ms(torch, [
            lambda a=a: bs.sparse_bwd_plain(*a[1], layout_t, **plain_kw)
            for a in bwd_in]),
    }
    # SDPA with the layout expanded to a boolean mask, timed here only
    mask = sdpa_mask(layout_t, block, L, h, causal, dev)
    ms["sdpa_fwd"] = time_ms(torch, [
        lambda s=s: F.scaled_dot_product_attention(*sdpa_inputs(*s[:3]),
                                                   attn_mask=mask)
        for s in sets])
    leaves = [x.detach().clone().requires_grad_() for x in sets[0][:3]]
    do_t = sets[0][3].transpose(1, 2)
    ms["sdpa_fwd_bwd"] = time_ms(torch, [
        lambda: F.scaled_dot_product_attention(
            *sdpa_inputs(*leaves), attn_mask=mask).backward(do_t)])
    del mask

    n_pairs = b * layout_pairs(layout, block, causal, h)
    item = q.element_size()
    rows, stats = b * L * h * d, b * h * L * 4
    bound = {
        "fwd": bound_ms(4 * rows * item + stats, 4 * n_pairs * d,
                        dtype_name),
        "bwd_dq": bound_ms(5 * rows * item + 2 * stats, 6 * n_pairs * d,
                           dtype_name),
        "bwd_dkv": bound_ms(6 * rows * item + 2 * stats, 8 * n_pairs * d,
                            dtype_name),
        "bwd": bound_ms(7 * rows * item + 2 * stats, 10 * n_pairs * d,
                        dtype_name)}
    out.update({"pairs": n_pairs, "ms": ms,
                "bound_ms": {k_: v_[0] for k_, v_ in bound.items()},
                "bound_by": {k_: v_[1] for k_, v_ in bound.items()},
                "sdpa_bwd_ms": ms["sdpa_fwd_bwd"] - ms["sdpa_fwd"],
                "fwd_bound_share": bound["fwd"][0] / ms["fwd"],
                "fwd_vs_sdpa": ms["fwd"] / ms["sdpa_fwd"]})
    emit(out)
    return out


def sparse_kernel_configs(sa, h=12):
    """Phase 4b's layouts: (name, config, causal)."""
    return [
        ("bigbird", sa.BigBirdSparsityConfig(
            h, block=128, num_random_blocks=1, num_sliding_window_blocks=3,
            num_global_blocks=1), False),
        ("bslongformer", sa.BSLongformerSparsityConfig(
            h, block=128, num_sliding_window_blocks=3,
            global_block_indices=[0]), False),
        ("fixed_per_head", sa.FixedSparsityConfig(
            h, block=128, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional", different_layout_per_head=True,
            num_different_global_patterns=4), True),
        ("variable", sa.VariableSparsityConfig(
            h, block=128, num_random_blocks=2, local_window_blocks=[4],
            global_block_indices=[0]), False),
        ("fixed_block32", sa.FixedSparsityConfig(
            h, block=32, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional"), True),
        ("dense", sa.DenseSparsityConfig(h, block=128), False),
    ]


def sparse_attention_phase(torch, sa, bs, fl, seed, L=16384, h=12, d=64):
    """Phase 4c: SparseSelfAttention forward and backward at [1, L, h, d]
    bf16 for three configs.  Returns the block-sparse launch counts of
    the two driven runs of each config (the timing runs come after)."""
    import numpy as np
    import torch.nn.functional as F

    from deepspeed_tpu_torch.profiling.sparse_profile import (sdpa_mask,
                                                              timings)
    dev = torch.device("cuda")
    configs = [
        ("bigbird", sa.BigBirdSparsityConfig(
            h, block=128, num_random_blocks=1, num_sliding_window_blocks=3,
            num_global_blocks=1)),
        ("bslongformer", sa.BSLongformerSparsityConfig(
            h, block=128, num_sliding_window_blocks=3,
            global_block_indices=[0])),
        ("fixed_unidirectional", sa.FixedSparsityConfig(
            h, block=128, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional")),
    ]
    counts = dict.fromkeys(bs.launch_counts(), 0)
    for i, (name, cfg) in enumerate(configs):
        module = sa.SparseSelfAttention(cfg)
        causal = cfg.attention == "unidirectional"
        g = torch.Generator(device=dev).manual_seed(seed + i)
        q, k, v, do = (torch.randn(1, L, h, d, generator=g,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(4))
        bs.reset_launch_counts()
        runs = []
        for _ in range(2):
            with torch.no_grad():
                o = module(q, k, v)
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            module(*leaves).backward(do)
            runs.append([o] + [t.grad for t in leaves])
        torch.cuda.synchronize()
        for key_, n in bs.launch_counts().items():
            counts[key_] += n
        bit_equal = all(torch.equal(a, b_) for a, b_ in zip(*runs))
        finite = all(bool(torch.isfinite(t).all()) for t in runs[0])
        shapes = [tuple(t.shape) for t in runs[0]]

        # head 0 against the plain versions (the loss is a sum over heads,
        # so head 0's gradients depend on head 0 alone)
        layout = np.asarray(cfg.make_layout(L))
        if causal:
            layout = np.tril(layout)
        h0 = [x[:, :, :1] for x in (q, k, v, do)]
        o_p, lse_p = bs.sparse_fwd_plain(*h0[:3], layout, block=128,
                                         causal=causal)
        grads_p = bs.sparse_bwd_plain(*h0[:3], o_p, lse_p, h0[3], layout,
                                      block=128, causal=causal)
        errs = {lbl: rel_err(got[:, :, :1], want) for lbl, got, want in zip(
            ("o", "dq", "dk", "dv"), runs[0], (o_p, *grads_p))}
        del o_p, lse_p, grads_p, runs

        # times from CUDA events (the host enqueues far ahead of these
        # ms-long kernels); SDPA with the expanded mask is timed only here
        mask = sdpa_mask(layout, 128, L, h, causal, dev)
        ms = {}
        for label, attend in (
                ("sparse", module),
                ("dense_flash",
                 lambda *t: fl.flash_attention(*t, causal=causal)),
                ("sdpa_mask", lambda *t: F.scaled_dot_product_attention(
                    *sdpa_inputs(*t), attn_mask=mask).transpose(1, 2))):
            got = timings(attend, q, k, v, do, reps=3, backward=True)
            ms[f"{label}_fwd"], ms[f"{label}_fwd_bwd"] = \
                got["fwd"], got["fwd_bwd"]
        del mask
        torch.cuda.empty_cache()

        n_pairs = layout_pairs(layout, 128, causal, h)
        dense_pairs = h * attended_pairs(L, L, causal)
        rows, stats = L * h * d * 2, h * L * 4
        res = {"phase": "sparse_attention", "config": name,
               "sparsity_config": type(cfg).__name__, "batch": 1, "len": L,
               "heads": h, "head_dim": d, "dtype": "bfloat16",
               "causal": causal, "block": 128,
               "density": float(layout.mean()), "pairs": n_pairs,
               "ms": ms,
               "bound_fwd_ms": bound_ms(4 * rows + stats, 4 * n_pairs * d,
                                        "bfloat16")[0],
               "bound_fwd_bwd_ms": bound_ms(
                   8 * rows + 2 * stats, 14 * n_pairs * d, "bfloat16")[0],
               "dense_bound_fwd_ms": bound_ms(
                   4 * rows + stats, 4 * dense_pairs * d, "bfloat16")[0],
               "speedup_fwd_vs_dense_flash":
                   ms["dense_flash_fwd"] / ms["sparse_fwd"],
               "speedup_fwd_bwd_vs_dense_flash":
                   ms["dense_flash_fwd_bwd"] / ms["sparse_fwd_bwd"],
               "two_runs_bit_equal": bit_equal, "finite": finite,
               "shapes": shapes, "head0_vs_plain_rel_err": errs,
               "tol": TOL["bfloat16"]}
        emit(res)
        if not (bit_equal and finite and
                shapes == [(1, L, h, d)] * 4 and
                all(e < TOL["bfloat16"] for e in errs.values())):
            fail(f"sparse attention {name}: bit-equal {bit_equal}, finite "
                 f"{finite}, shapes {shapes}, head 0 vs plain {errs}")
    return counts


# ------------------------------------------------------------- train phase


def train_batches(torch, seed, n, batch, seq, vocab):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [{"input_ids": torch.randint(0, vocab, (batch, seq), generator=g,
                                        device="cuda")} for _ in range(n)]


def train_oracle(torch, fl, deepspeed_tpu_torch, seed):
    """fp32, GPT-2 small width at 2 layers, batch 2 x 1024: one step
    through the flash kernels and one through the plain reference
    attention, from the same weights and batch.  At initialisation the
    loss hardly depends on attention, so the attention projections'
    gradients (which pass through the backward kernels) are compared
    too."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2, gpt2_small
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "steps_per_print": 1000000}
    batch = train_batches(torch, seed + 1, 1, 2, 1024, 50257)[0]
    out = {}
    for impl in ("flash", "reference"):
        fl.reset_launch_counts()
        engine = deepspeed_tpu_torch.initialize(
            model=GPT2(gpt2_small(num_layers=2, attn_impl=impl)),
            config=config, seed=seed)[0]
        loss = float(engine.backward(engine.forward(batch)).detach())
        grads = {n: p.grad.clone() for n, p in
                 engine.module.named_parameters() if ".attn." in n}
        engine.step()
        out[impl] = (loss, engine.get_global_grad_norm(), grads,
                     sum(fl.launch_counts().values()))
        del engine
    (lf, gf, grf, nf), (lr_, gr, grr, nr) = out["flash"], out["reference"]
    attn_err = max(((grf[n] - grr[n]).abs().max() /
                    grr[n].abs().max()).item() for n in grr)
    tol = {"loss_abs": 1e-4, "grad_norm_rel": 1e-4, "attn_grad_rel": 1e-4}
    res = {"phase": "train_fp32_oracle", "model": "gpt2-small width",
           "layers": 2, "batch": 2, "seq": 1024,
           "loss_flash": lf, "loss_reference": lr_,
           "grad_norm_flash": gf, "grad_norm_reference": gr,
           "attn_grad_max_rel_err": attn_err,
           "flash_launches": nf, "reference_flash_launches": nr, "tol": tol}
    emit(res)
    if nf != 6 or nr != 0:
        fail(f"the flash step launched {nf} flash kernels (want 6: 2 "
             f"layers x fwd/dq/dkv), the reference step {nr} (want 0)")
    if not (abs(lf - lr_) < tol["loss_abs"] and
            abs(gf - gr) < tol["grad_norm_rel"] * abs(gr) and
            attn_err < tol["attn_grad_rel"]):
        fail("fp32 train step through the flash kernels disagrees with "
             "the reference attention")


def train_bf16(torch, deepspeed_tpu_torch, seed):
    """Full GPT-2 small in bf16 over fp32 masters with bench.py's config:
    3 warm-up steps and 10 timed steps cycling 2 seeded batches, then a
    gas-4 window at micro batch 2.  Returns (the phase line, the first
    engine, its config, the 2 batches): phase 8b continues that
    engine."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2, gpt2_small
    batch, seq = 8, 1024
    cfg = gpt2_small(dtype="bfloat16")
    config = {"train_micro_batch_size_per_gpu": batch,
              "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "bf16": {"enabled": True},
              "zero_optimization": {"stage": 1},
              "steps_per_print": 1000000}
    torch.cuda.reset_peak_memory_stats()
    engine = deepspeed_tpu_torch.initialize(model=GPT2(cfg), config=config,
                                            seed=seed)[0]
    n_params = sum(p.numel() for p in engine.module.parameters())
    data = train_batches(torch, seed + 2, 2, batch, seq, cfg.vocab_size)
    losses = [engine.train_batch(batches=[data[i % 2]], sync=False)
              for i in range(3)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i in range(3, 13):
        losses.append(engine.train_batch(batches=[data[i % 2]], sync=False))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    tokens_per_s = 10 * batch * seq / wall
    flops_per_token = 6 * n_params + 12 * cfg.num_layers * \
        cfg.hidden_size * seq
    engine8 = engine            # phase 8b's checkpoints continue it

    config4 = dict(config, train_micro_batch_size_per_gpu=2,
                   gradient_accumulation_steps=4)
    engine = deepspeed_tpu_torch.initialize(model=GPT2(cfg), config=config4,
                                            seed=seed)[0]
    window = [{"input_ids": x["input_ids"][i:i + 2]}
              for x in data[:1] for i in range(0, batch, 2)]
    gas4 = [engine.train_batch(batches=window)]      # warm-up window
    torch.cuda.synchronize()
    t0 = time.monotonic()
    gas4.append(engine.train_batch(batches=window))
    torch.cuda.synchronize()
    gas4_wall = time.monotonic() - t0
    del engine
    torch.cuda.empty_cache()
    res = {"phase": "train_bf16", "model": "gpt2-small", "params": n_params,
           "layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "heads": cfg.num_heads, "vocab": cfg.vocab_size, "batch": batch,
           "seq": seq, "zero_stage": 1, "losses": losses,
           "timed_steps": 10, "ms_per_step": wall * 1e3 / 10,
           "tokens_per_s": tokens_per_s,
           "mfu_vs_989_tflops": tokens_per_s * flops_per_token / BF16_FLOPS,
           "max_memory_allocated_bytes": peak,
           "gas4_micro2_losses": gas4, "gas4_window_ms": gas4_wall * 1e3,
           "gas4_tokens_per_s": batch * seq / gas4_wall}
    emit(res)
    if not all(math.isfinite(x) for x in losses + gas4):
        fail(f"non-finite bf16 training loss: {losses} {gas4}")
    # the last step (i = 12) sees batch 0 again, as the first did
    if not losses[12] < losses[0]:
        fail(f"bf16 loss on batch 0 did not fall: {losses[0]} -> "
             f"{losses[12]}")
    return res, engine8, config, data


# ------------------------------------------------------------- serve phase


def make_requests(seed, vocab):
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = [16, 200, 57, 128, 33, 90]
    max_new = [32, 16, 24, 32, 20, 28]
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths], \
        max_new


def count_chains(sched):
    """Wrap ``sched._try_chain``; the returned list collects its results
    (True: a horizon was chained off the previous one's device carries)."""
    results = []
    inner = sched._try_chain

    def counted():
        ok = inner()
        results.append(ok)
        return ok
    sched._try_chain = counted
    return results


def run_mix(torch, sched, prompts, max_new, drained=True):
    """Submit the requests to ``sched`` and run it to idle; every request
    must finish and, when ``drained``, every page come back (a prefix
    cache keeps its pages).  Returns (tokens, wall s)."""
    reqs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_new)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = sched.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for r in reqs:
        if r.state != "finished":
            fail(f"request {r.rid} ended {r.state}: {r.error}")
    if drained and sched.kv.pool.pages_in_use:
        fail(f"{sched.kv.pool.pages_in_use} pages leaked")
    return [got[r.rid] for r in reqs], wall


def serve(torch, engine, prompts, max_new, sched_kwargs):
    """One fresh scheduler over the requests.  Returns (tokens, scheduler,
    wall s); ``sched.chains`` lists its ``_try_chain`` results and
    ``sched.captures`` the horizon graphs the engine captured for it."""
    from deepspeed_tpu_torch.serving import ServingScheduler
    before = engine.serving_decode_multi_capture_count()
    sched = ServingScheduler(engine, **sched_kwargs)
    sched.chains = count_chains(sched)
    got, wall = run_mix(torch, sched, prompts, max_new)
    sched.captures = engine.serving_decode_multi_capture_count() - before
    if sched.captures > len(sched.horizon_buckets):
        fail(f"{sched.captures} horizon graphs captured for one scheduler, "
             f"over its {len(sched.horizon_buckets)} buckets")
    return got, sched, wall


def serve_numbers(s, wall, steps):
    """The serve metrics of one run from its scheduler's summary."""
    return {"serve_s": round(wall, 3), "tokens": s["tokens_emitted"],
            "tokens_per_s": s["tokens_emitted"] / wall, "steps": steps,
            "ms_per_step": wall * 1e3 / steps,
            "ttft_ms_p50": s["ttft_ms_p50"], "ttft_ms_p90": s["ttft_ms_p90"],
            "tpot_ms_p50": s["tpot_ms_p50"], "tbt_ms_p50": s["tbt_ms_p50"],
            "tbt_ms_p90": s["tbt_ms_p90"],
            "horizon_wait_frac": s.get("horizon_wait_frac"),
            "preemptions": s["preemptions"]}


def graph_and_eager(torch, engine, eager, prompts, max_new, sched_kwargs):
    """The request mix on the eager twin (``enable_cuda_graph=False``,
    ``overlap=False``) after a warm-up request, then twice on ONE graph
    scheduler (graphs and overlap, the defaults): the first run captures,
    the second is the steady one.  Fails when the captures exceed the
    scheduler's buckets or no horizon was chained.  Returns (steady
    tokens, first-run tokens, eager tokens, the numbers to print, the
    graph scheduler)."""
    from deepspeed_tpu_torch.serving import ServingScheduler
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics
    barrier = dict(sched_kwargs, overlap=False)
    serve(torch, eager, [prompts[0]], [4], barrier)          # warm-up
    got_e, sched_e, wall_e = serve(torch, eager, prompts, max_new, barrier)
    c0 = engine.serving_decode_multi_capture_count()
    t0 = engine.serving_decode_multi_capture_seconds()
    sched = ServingScheduler(engine, **sched_kwargs)
    chains = count_chains(sched)
    first, wall1 = run_mix(torch, sched, prompts, max_new)
    c1 = engine.serving_decode_multi_capture_count()
    sched.metrics = ServingMetrics()          # the steady run's own
    steps0, n_chains = sched.step_idx, sum(chains)
    got, wall2 = run_mix(torch, sched, prompts, max_new)
    captures = engine.serving_decode_multi_capture_count() - c0
    out = {"graph_steady": serve_numbers(sched.metrics.summary(wall2), wall2,
                                         sched.step_idx - steps0),
           "graph_first_run": {"serve_s": round(wall1, 3),
                               "tokens_per_s": sum(map(len, first)) / wall1},
           "eager_twin": serve_numbers(sched_e.summary(), wall_e,
                                       sched_e.step_idx),
           "captures": captures, "horizon_buckets": sched.horizon_buckets,
           "captures_in_steady_run":
           engine.serving_decode_multi_capture_count() - c1,
           "capture_s": round(engine.serving_decode_multi_capture_seconds()
                              - t0, 3),
           "chained_horizons": sum(chains),
           "chained_horizons_steady_run": sum(chains) - n_chains,
           "steady_equals_first_run": got == first,
           "agreement_with_eager_twin": agreement(got, got_e)}
    if captures > len(sched.horizon_buckets) or not sum(chains):
        fail(f"graph scheduler: {captures} captures for "
             f"{len(sched.horizon_buckets)} buckets, {sum(chains)} chained "
             "horizons")
    return got, first, got_e, out, sched


# ------------------------------------------------- speculative decoding


def motif_requests(seed, vocab):
    """Four prompts of one random token repeated 128 times, to be
    submitted first, so they fill the 4 slots together.  Every position
    of such a context holds the same values, so even a model with random
    weights emits runs of one token, loops that prompt lookup drafts; on
    random text a random model does not repeat itself, and prompt lookup
    finds nothing to propose.  A round needs proposals from half the
    running slots, which random requests beside them would not give."""
    import numpy as np
    rng = np.random.default_rng(seed + 100)
    return [np.full(128, t, np.int32)
            for t in rng.integers(0, vocab, 4)], [24, 28, 24, 28]


def generated(engine, prompts, max_new):
    return [[int(t) for t in engine.generate(p[None], max_new_tokens=m)[
        0, len(p):]] for p, m in zip(prompts, max_new)]


def check_exact(engine, label, prompts, got, want):
    """Fails unless every stream equals its generate() tokens, after
    printing each mismatch with the top-2 logit margin of a full forward
    at its first divergent token (a near-tie reads small)."""
    import numpy as np
    exact = [g == w for g, w in zip(got, want)]
    if all(exact):
        return exact
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next((t for t, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        ids = np.concatenate([prompts[i], np.asarray(w[:j], np.int32)])
        top = engine.forward(ids[None])[0, -1].float().topk(2).values
        emit({"mismatch": i, "phase": label, "first_divergence": j,
              "top2_logit_margin": float(top[0] - top[1]),
              "serve": g, "generate": w})
    fail(f"{label}: serving is not token-exact against generate()")


def spec_serve(torch, engine, prompts, max_new, sched_kwargs, drafter=None,
               runs=1):
    """``runs`` runs of the requests on ONE spec scheduler (n-gram, or
    ``drafter``; spec_k 8).  Fails when a run leaves a request unfinished
    or a page allocated (target pool and draft pool), contains a drafter
    fault (spec_degraded: a kernel error inside a drafter must not hide
    there), or captures more verify graphs than the spec-K buckets (a
    later run: any).  Returns (tokens of each run, the numbers of each
    run, the scheduler)."""
    import numpy as np

    from deepspeed_tpu_torch.serving import ServingScheduler
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics
    kw = dict(spec_decode="ngram") if drafter is None else \
        dict(spec_drafter=drafter)
    sched = ServingScheduler(engine, spec_k=8, **kw, **sched_kwargs)
    events = []
    verify = engine.verify_multi

    def timed(*args, **kwargs):
        # each round's device time, between CUDA events on its stream
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = verify(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out
    engine.verify_multi = timed
    tokens, numbers = [], []
    try:
        for run in range(runs):
            c0 = engine.serving_verify_capture_count()
            s0 = engine.serving_verify_capture_seconds()
            sched.metrics = ServingMetrics()
            events.clear()
            steps = sched.step_idx
            got, wall = run_mix(torch, sched, prompts, max_new)
            s = sched.metrics.summary(wall)
            ms = [a.elapsed_time(b) for a, b in events]
            captures = engine.serving_verify_capture_count() - c0
            numbers.append({
                "serve_s": round(wall, 3), "tokens": s["tokens_emitted"],
                "tokens_per_s": s["tokens_emitted"] / wall,
                "steps": sched.step_idx - steps,
                **{k: s[k] for k in s if k.startswith("spec_")},
                "verify_captures": captures,
                "verify_capture_s": round(
                    engine.serving_verify_capture_seconds() - s0, 3),
                "verify_rounds": len(ms),
                "verify_ms_per_round_mean": float(np.mean(ms)) if ms
                else None,
                "verify_ms_per_round_median": float(np.median(ms)) if ms
                else None})
            tokens.append(got)
            bound = len(sched.spec_k_buckets) if run == 0 else 0
            if s["spec_degraded"] or captures > bound:
                fail(f"spec serve run {run}: {s['spec_degraded']} degraded "
                     f"({list(sched.metrics.spec_degrade_log)}), "
                     f"{captures} verify captures (bound {bound})")
            if drafter is not None and drafter.kv.pool.pages_in_use:
                fail(f"{drafter.kv.pool.pages_in_use} draft pages leaked")
    finally:
        del engine.verify_multi
    return tokens, numbers, sched


def serve_spec_fp32(torch, deepspeed_tpu_torch, engine, model, prompts,
                    max_new, want, motif, motif_new, sched_kwargs, seed):
    """Phase 6e on phase 5's fp32 engine: n-gram, self-draft and a
    2-layer draft over the requests and the motif prompts, each
    token-exact against generate()."""
    from deepspeed_tpu_torch.models.llama import Llama, llama2_7b
    from deepspeed_tpu_torch.serving import DraftModelDrafter
    t_phase = time.monotonic()
    prompts, max_new = motif + prompts, motif_new + max_new
    want = generated(engine, motif, motif_new) + want
    draft_kwargs = {k: sched_kwargs[k] for k in (
        "num_slots", "num_pages", "page_size", "max_pages_per_slot",
        "prefill_chunk")}
    out = {}
    runs, numbers, _ = spec_serve(torch, engine, prompts, max_new,
                                  sched_kwargs, runs=2)
    for got in runs:
        check_exact(engine, "spec ngram", prompts, got, want)
    out["ngram"] = {"first_run": numbers[0], "steady_run": numbers[1]}
    self_eng = deepspeed_tpu_torch.init_inference(
        model, dtype="float32", kv_cache_dtype="float32",
        max_out_tokens=512)
    small = Llama(llama2_7b(num_layers=2), device="cuda")
    small_eng = deepspeed_tpu_torch.init_inference(
        small, dtype="float32", kv_cache_dtype="float32",
        max_out_tokens=512).init_params(seed + 11)
    for name, eng in (("self_draft", self_eng), ("small_draft", small_eng)):
        drafter = DraftModelDrafter(eng, **draft_kwargs)
        runs, numbers, _ = spec_serve(torch, engine, prompts, max_new,
                                      sched_kwargs, drafter=drafter)
        check_exact(engine, f"spec {name}", prompts, runs[0], want)
        out[name] = numbers[0]
    emit({"phase": "serve_fp32_spec", "model": "llama2-7b",
          "requests": len(prompts), "spec_k": 8,
          "draft_model": "llama2-7b width, 2 layers", **out,
          "phase_s": round(time.monotonic() - t_phase, 3)})
    runs = (out["ngram"]["first_run"], out["ngram"]["steady_run"],
            out["self_draft"], out["small_draft"])
    if not (all(r["spec_dispatches"] > 0 for r in runs) and
            out["ngram"]["first_run"]["spec_accepted_tokens"] > 0 and
            out["self_draft"]["spec_accepted_tokens"] > 0):
        fail("spec serve: a run dispatched no verify round, or n-gram or "
             "self-draft accepted no draft")
    del self_eng, small_eng, small
    torch.cuda.empty_cache()


def spec_against_plain(torch, engine, prompts, max_new, plain, sched_kwargs,
                       label):
    """The n-gram spec runs (two on one scheduler) on a graph engine
    against the same requests without spec (``plain``: their tokens on
    that engine): agreement, tokens/s, acceptance and verify ms printed,
    not asserted.  Returns the numbers."""
    runs, numbers, _ = spec_serve(torch, engine, prompts, max_new,
                                  sched_kwargs, runs=2)
    out = {"phase": label, "first_run": numbers[0], "steady_run": numbers[1],
           "agreement_with_plain": agreement(runs[1], plain),
           "runs_identical": runs[0] == runs[1]}
    emit(out)
    return out


def agreement(got, want):
    """Per request, the share of positions with the same token."""
    return [sum(1 for a, b in zip(x, y) if a == b) / len(y)
            for x, y in zip(got, want)]


# ------------------------------------- prefix cache and decoding policies

# the mixed batch of phase 6f (c): greedy rows, sampled rows with the
# three history penalties, and one JSON-schema row
SAMPLED_POLICY = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.95,
                      repetition_penalty=1.1, presence_penalty=0.2,
                      frequency_penalty=0.1)
JSON_SCHEMA = {"json_schema": {"type": "object", "properties": {
    "id": {"type": "integer"}, "ok": {"type": "boolean"}}}}


def prefix_requests(seed, vocab):
    """A 96-token shared prefix (6 pages of 16) and tails: the donor's
    40-token tail, prompts ending inside its donated pages (a partly
    matched page: copy-on-write), the donor's whole prompt again, and
    two unique tails (full-page hits only).  The donor goes first."""
    import numpy as np
    rng = np.random.default_rng(seed + 200)
    prefix = rng.integers(0, vocab, 96).astype(np.int32)
    tail = rng.integers(0, vocab, 40).astype(np.int32)
    tails = [tail, tail[:10], tail[:25], tail,
             rng.integers(0, vocab, 7).astype(np.int32),
             rng.integers(0, vocab, 30).astype(np.int32)]
    return [np.concatenate([prefix, t]) for t in tails], \
        [12, 10, 14, 9, 16, 11]


def cached_serve(torch, engine, prompts, max_new, sched_kwargs, copies=None):
    """The donor alone, then the rest, on ONE prefix-cache scheduler.
    Returns (tokens, scheduler summary, cached pages before the drain,
    page-copy captures); fails unless every page comes back after a full
    drain of the cache.  ``copies`` collects, per ``copy_page``, whether
    every leaf of the destination page equals the source bit for bit."""
    from deepspeed_tpu_torch.serving import ServingScheduler
    sched = ServingScheduler(engine, prefix_cache=True, **sched_kwargs)
    inner = engine.copy_page

    def checked(pools, src, dst):
        out = inner(pools, src, dst)
        copies.append(all(torch.equal(t[dst].view(torch.uint8),
                                      t[src].view(torch.uint8))
                          for layer in pools["layers"]
                          for t in layer.values()))
        return out
    if copies is not None:
        engine.copy_page = checked
    c0 = engine.serving_page_copy_capture_count()
    try:
        first, _ = run_mix(torch, sched, prompts[:1], max_new[:1],
                           drained=False)
        rest, wall = run_mix(torch, sched, prompts[1:], max_new[1:],
                             drained=False)
    finally:
        if copies is not None:
            del engine.copy_page
    s = sched.summary()
    cached = sched.kv.pool.pages_in_use
    if cached != sched.prefix_cache.cached_pages:
        fail(f"prefix cache: {cached} pages in use, "
             f"{sched.prefix_cache.cached_pages} cached")
    sched.prefix_cache.evict(10 ** 6)
    if sched.kv.pool.pages_in_use:
        fail(f"prefix cache: {sched.kv.pool.pages_in_use} pages leaked")
    return first + rest, s, cached, \
        engine.serving_page_copy_capture_count() - c0, wall


def submit_policy_mix(sched, prompts, max_new, grammar=True):
    """Request i: greedy when i % 3 == 0, else SAMPLED_POLICY with seed
    i; the last one a JSON-schema row (sampled) when ``grammar``."""
    reqs = []
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        kw = dict(seed=i, sampling=None if i % 3 == 0 else SAMPLED_POLICY)
        if grammar and i == len(prompts) - 1:
            kw.update(grammar=JSON_SCHEMA, eos_token_id=2,
                      sampling=SAMPLED_POLICY)
            m = max(m, 40)
        reqs.append(sched.submit(p, max_new_tokens=m, **kw))
    return reqs


def policy_serve(torch, engine, prompts, max_new, sched_kwargs, sched=None,
                 grammar=True):
    """The mixed batch on ``sched`` (a fresh one by default).  Fails when
    a request does not finish, a page stays in use, or a grammar output
    is not valid.  Returns (tokens, scheduler, wall s)."""
    from deepspeed_tpu_torch.serving import ServingScheduler
    if sched is None:
        sched = ServingScheduler(engine, **sched_kwargs)
        sched.chains = count_chains(sched)
    c0 = engine.serving_capture_count("decode_multi_policy")
    reqs = submit_policy_mix(sched, prompts, max_new, grammar)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = sched.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    captures = engine.serving_capture_count("decode_multi_policy") - c0
    if captures > len(sched.horizon_buckets):
        fail(f"{captures} policy horizon graphs captured for one "
             f"scheduler, over its {len(sched.horizon_buckets)} buckets")
    for r in reqs:
        if r.state != "finished":
            fail(f"policy request {r.rid} ended {r.state}: {r.error}")
        if r.grammar is not None and not (r.grammar.done and
                                          r.grammar.accepts(r.out_tokens)):
            fail(f"grammar output not valid: {r.out_tokens}")
    if sched.kv.pool.pages_in_use:
        fail(f"policy serve: {sched.kv.pool.pages_in_use} pages leaked")
    return [got[r.rid] for r in reqs], sched, wall


def policy_spec_rounds(torch, engine, prompts, max_new, sched_kwargs):
    """The motif prompts (greedy: random weights loop over them, so
    prompt lookup proposes) beside a sampled row, with
    spec_decode="ngram": the rounds run ``verify_multi_policy``.  Returns
    (policy verify rounds that carried drafts, numbers)."""
    import numpy as np

    from deepspeed_tpu_torch.serving import ServingScheduler
    sched = ServingScheduler(engine, spec_decode="ngram", spec_k=8,
                             **sched_kwargs)
    rounds = []
    inner = engine.verify_multi_policy

    def counted(*args, widths, **kw):
        rounds.append(int(np.asarray(widths).sum()))
        return inner(*args, widths=widths, **kw)
    engine.verify_multi_policy = counted
    try:
        reqs = [sched.submit(p, max_new_tokens=m, seed=i,
                             sampling=SAMPLED_POLICY if i == 3 else None)
                for i, (p, m) in enumerate(zip(prompts, max_new))]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        sched.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        del engine.verify_multi_policy
    s = sched.summary()
    if any(r.state != "finished" for r in reqs) or \
            sched.kv.pool.pages_in_use or s["spec_degraded"]:
        fail(f"sampled spec serve: states {[r.state for r in reqs]}, "
             f"{sched.kv.pool.pages_in_use} pages, "
             f"{s['spec_degraded']} degraded")
    return sum(1 for w in rounds if w), {
        "serve_s": round(wall, 3), "policy_verify_rounds": len(rounds),
        **{k: s[k] for k in ("spec_dispatches", "spec_draft_tokens",
                             "spec_accepted_tokens", "policy_dispatches")}}


def serve_prefix_and_policy_fp32(torch, dec, engine, prompts, max_new,
                                 want, motif, motif_new, sched_kwargs, seed):
    """Phase 6f on phase 5's fp32 engine: (a) prefix caching, (b) the
    same over int8 pools, (c) the mixed greedy / sampled / grammar batch
    and sampled n-gram spec rounds.  Returns the launch counts of the
    phase."""
    from deepspeed_tpu_torch.ops.quant import kernels as qk
    t_phase = time.monotonic()
    dec_before = dec.launch_counts()
    if engine.serving_capture_count("decode_multi_policy") or \
            engine.serving_capture_count("verify_policy"):
        fail("greedy-only serving (phases 5 and 6e) captured a policy graph")
    out = {}
    # (a) fp32 prefix caching, token-exact against generate()
    pre, pre_new = prefix_requests(seed, engine.module.cfg.vocab_size)
    pre_want = generated(engine, pre, pre_new)
    got, s, cached, copy_captures, wall = cached_serve(
        torch, engine, pre, pre_new, sched_kwargs)
    check_exact(engine, "prefix cache fp32", pre, got, pre_want)
    out["fp32"] = {k: s[k] for k in s if k.startswith("prefix")}
    out["fp32"].update(serve_s=round(wall, 3), cached_pages=cached,
                       prefill_tokens_saved=s["prefill_tokens_saved"],
                       copy_page_captures=copy_captures)
    if not (s["prefix_hits"] > 0 and s["prefix_cow_copies"] > 0) or \
            copy_captures > 1:
        fail(f"prefix cache fp32: {s['prefix_hits']} hits, "
             f"{s['prefix_cow_copies']} copies, {copy_captures} captures")
    # (b) int8 pools: cache on equals cache off, copies bit for bit
    q_before = {**dec.launch_counts(), **qk.launch_counts()}
    kv8 = dict(sched_kwargs, kv_dtype="int8")
    copies = []
    got8, s8, _, _, wall8 = cached_serve(torch, engine, pre, pre_new, kv8,
                                         copies)
    off8, _, _ = serve(torch, engine, pre, pre_new, kv8)
    q_after = {**dec.launch_counts(), **qk.launch_counts()}
    out["int8_pools"] = {"serve_s": round(wall8, 3),
                         "prefix_hits": s8["prefix_hits"],
                         "prefix_cow_copies": s8["prefix_cow_copies"],
                         "copies_bitwise": copies,
                         "cache_on_equals_off": got8 == off8,
                         "agreement_with_fp32_pools": agreement(got8, got),
                         "paged_decode_quant_fwd_launches":
                         q_after["paged_decode_quant_fwd"] -
                         q_before["paged_decode_quant_fwd"]}
    if got8 != off8 or not copies or not all(copies) or \
            out["int8_pools"]["paged_decode_quant_fwd_launches"] <= 0:
        fail(f"prefix cache over int8 pools: {out['int8_pools']}")
    # (c) the mixed batch: greedy rows equal generate(), sampled streams
    # equal across two runs, horizons 1 and 8 and an evicting pool
    runs = {}
    for name, kw in (("h8", {}), ("h8_again", {}),
                     ("h1", dict(decode_horizon_steps=1)),
                     ("evict", dict(num_pages=20, max_pages_per_slot=16))):
        got_c, sched, wall_c = policy_serve(torch, engine, prompts, max_new,
                                            dict(sched_kwargs, **kw))
        sc = sched.summary()
        runs[name] = (got_c, {"serve_s": round(wall_c, 3),
                              "tokens_per_s": sc["tokens_emitted"] / wall_c,
                              "preemptions": sc["preemptions"],
                              "policy_dispatches": sc["policy_dispatches"],
                              "chained_horizons": sum(sched.chains)})
    greedy = [i for i in range(len(prompts) - 1) if i % 3 == 0]
    check_exact(engine, "policy mix greedy rows",
                [prompts[i] for i in greedy],
                [runs["h8"][0][i] for i in greedy],
                [want[i] for i in greedy])
    same = {name: r[0] == runs["h8"][0] for name, r in runs.items()}
    if not all(same.values()) or not runs["evict"][1]["preemptions"]:
        fail(f"sampled streams differ across schedules {same}, or the "
             f"small pool evicted nothing ({runs['evict'][1]})")
    n_rounds, spec = policy_spec_rounds(torch, engine, motif + prompts[:1],
                                        motif_new + max_new[:1],
                                        sched_kwargs)
    if not n_rounds:
        fail(f"no sampled n-gram spec round carried drafts: {spec}")
    out["policy_mix"] = {name: r[1] for name, r in runs.items()}
    out["policy_mix"]["streams_equal_across_schedules"] = same
    out["policy_spec"] = spec
    out["policy_captures"] = {
        k: engine.serving_capture_count(k)
        for k in ("decode_multi_policy", "verify_policy", "copy_page")}
    counts = {k: v - dec_before[k] for k, v in dec.launch_counts().items()}
    counts.update({k: q_after[k] - q_before[k] for k in qk.launch_counts()})
    emit({"phase": "serve_fp32_prefix_policy", "model": "llama2-7b", **out,
          "launches": counts, "phase_s": round(time.monotonic() - t_phase,
                                                3)})
    if counts["paged_decode_fwd"] <= 0 or \
            counts["paged_decode_quant_fwd"] <= 0:
        fail(f"phase 6f launches {counts}")
    return counts


def policy_beside_greedy(torch, dec, engine, prompts, max_new, sched_kwargs,
                         label):
    """Phase 6f (d) on a bf16 or int8 / int8 engine whose earlier serving
    was greedy (so it must hold no policy graph yet): the mixed batch
    twice on one scheduler beside the same requests all greedy; tokens/s,
    run-to-run identity and agreement printed, grammar validity checked.
    Returns the launch counts of the policy runs."""
    from deepspeed_tpu_torch.ops.quant import kernels as qk
    from deepspeed_tpu_torch.serving import ServingScheduler
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics
    if engine.serving_capture_count("decode_multi_policy") or \
            engine.serving_capture_count("verify_policy"):
        fail(f"{label}: greedy-only serving captured a policy graph")
    before = {**dec.launch_counts(), **qk.launch_counts()}
    sched = ServingScheduler(engine, **sched_kwargs)
    first, _, _ = policy_serve(torch, engine, prompts, max_new,
                               sched_kwargs, sched)
    sched.metrics = ServingMetrics()
    again, _, wall = policy_serve(torch, engine, prompts, max_new,
                                  sched_kwargs, sched)
    counts = {k: v - before[k] for k, v in
              {**dec.launch_counts(), **qk.launch_counts()}.items()}
    s = sched.metrics.summary(wall)
    # the same requests all greedy, the steady (second) run likewise
    greedy_sched = ServingScheduler(engine, **sched_kwargs)
    run_mix(torch, greedy_sched, prompts, max_new)
    greedy_sched.metrics = ServingMetrics()
    greedy, wall_g = run_mix(torch, greedy_sched, prompts, max_new)
    rows = [i for i in range(len(prompts) - 1) if i % 3 == 0]
    emit({"phase": label, "policy_serve_s": round(wall, 3),
          "policy_tokens_per_s": s["tokens_emitted"] / wall,
          "greedy_serve_s": round(wall_g, 3),
          "greedy_tokens_per_s":
          greedy_sched.metrics.summary()["tokens_emitted"] / wall_g,
          "policy_dispatches": s["policy_dispatches"],
          "policy_captures": engine.serving_capture_count(
              "decode_multi_policy"),
          "two_runs_identical": first == again,
          "greedy_rows_agree_with_greedy_serve": agreement(
              [again[i] for i in rows], [greedy[i] for i in rows]),
          "launches": counts})
    return counts


def live_pool_check(torch, dec, sched, dtype, heads, label, seed,
                    positions=(0, 7, 100, 231)):
    """On the pools a serving run has just written (layer 0): one paged
    decode call of the kernel against its plain version (by
    :func:`rel_err`), through a page table over the pool's first pages.
    Callers read the run's launch counts before this comparison."""
    layer = sched.pools["layers"][0]
    ps = layer["k_pages"].shape[1]
    maxp = max(positions) // ps + 1
    if len(positions) * maxp > sched.kv.pool.num_pages:
        fail(f"{label}: positions {positions} need more pages than the pool")
    dev = layer["k_pages"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(len(positions), 1, heads, layer["k_pages"].shape[3],
                    generator=g, device=dev).to(dtype)
    pt = torch.arange(len(positions) * maxp, device=dev,
                      dtype=torch.int32).reshape(len(positions), maxp)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    scales = {k: layer[k] for k in ("k_scale", "v_scale") if k in layer}
    got = dec.paged_decode_attention(q, layer["k_pages"], layer["v_pages"],
                                     pt, pos, **scales)
    want = dec.paged_decode_attention_plain(
        q, layer["k_pages"], layer["v_pages"], pt, pos, **scales)
    torch.cuda.synchronize()
    # a served model's values are not unit-scale: one bf16 rounding of an
    # output of magnitude 4 is 0.03 absolute, so the error is relative
    # above magnitude 1 (rel_err)
    err = rel_err(got, want)
    dtype_name = str(dtype).replace("torch.", "")
    written = float(layer["k_pages"][:len(positions) * maxp].float().abs()
                    .max())
    if not err < TOL[dtype_name] or not written > 0:
        fail(f"{label}: kernel vs plain on the live pools: error {err} "
             f"(tolerance {TOL[dtype_name]}), max |payload| {written}")
    return err


def teacher_forced_logits(engine, seq, kv_dtype, sched_kwargs):
    """``seq`` teacher-forced through chunked prefill into fresh
    ``kv_dtype`` pools: the boundary logits of each chunk, as fp32."""
    import numpy as np

    from deepspeed_tpu_torch.serving import PagedKVManager
    chunk, ps = sched_kwargs["prefill_chunk"], sched_kwargs["page_size"]
    pools = engine.init_paged_cache(sched_kwargs["num_pages"], ps,
                                    kv_dtype=kv_dtype)
    kvm = PagedKVManager(sched_kwargs["num_pages"], ps,
                         sched_kwargs["num_slots"],
                         sched_kwargs["max_pages_per_slot"])
    if not kvm.ensure_capacity(0, len(seq)):
        fail("teacher-forced run: the pool cannot hold the sequence")
    lengths = np.zeros(sched_kwargs["num_slots"], np.int32)
    rows = []
    for c0 in range(0, len(seq), chunk):
        n = min(chunk, len(seq) - c0)
        ids = np.zeros((1, chunk), np.int32)
        ids[0, :n] = seq[c0:c0 + n]
        logits, pools = engine.prefill_into_slots(
            ids, 0, n, kvm.table, lengths, pools)
        lengths[0] += n
        rows.append(logits.float())
    return rows


def logit_deltas(rows, ref):
    """(largest |difference| of each boundary row, the share of rows whose
    argmax agrees, the largest |logit| of ``ref``)."""
    deltas = [(a - b).abs().max().item() for a, b in zip(rows, ref)]
    same = [int(a.argmax()) == int(b.argmax()) for a, b in zip(rows, ref)]
    return deltas, sum(same) / len(same), \
        max(b.abs().max().item() for b in ref)


def teacher_forced_delta(engine, seq, sched_kwargs):
    """The same token stream teacher-forced through chunked prefill into
    float32 pools and into int8 pools: the largest difference of any
    boundary logit (the oracle of the JAX package's
    test_int8_teacher_forced_logit_delta_pinned), and the share of
    chunks whose argmax agrees."""
    return logit_deltas(
        teacher_forced_logits(engine, seq, "int8", sched_kwargs),
        teacher_forced_logits(engine, seq, "float32", sched_kwargs))


def serve_quantized(torch, deepspeed_tpu_torch, dec, model, prompts, max_new,
                    motif, motif_new, sched_kwargs, got32, seed):
    """Phase 6b: dtype="int8" + kv_cache_dtype="int8" on the resident
    (bf16) module, quantized in place; then fp8 pools on the same
    engine.  Returns (tokens, launch counts of the phase)."""
    import numpy as np

    from deepspeed_tpu_torch.ops.quant import kernels as qk
    dec.reset_launch_counts()
    qk.reset_launch_counts()
    t0 = time.monotonic()
    engine = deepspeed_tpu_torch.init_inference(
        model, dtype="int8", kv_cache_dtype="int8", max_out_tokens=512)
    torch.cuda.synchronize()
    quantize_s = time.monotonic() - t0
    eager = deepspeed_tpu_torch.init_inference(
        model, dtype="int8", kv_cache_dtype="int8", max_out_tokens=512,
        enable_cuda_graph=False)
    got, again, got_e, runs, sched = graph_and_eager(
        torch, engine, eager, prompts, max_new, sched_kwargs)
    del eager
    plain_motif, _, _ = serve(torch, engine, motif, motif_new, sched_kwargs)
    spec_against_plain(torch, engine, motif + prompts, motif_new + max_new,
                       plain_motif + got, sched_kwargs,
                       "serve_int8_weights_int8_kv_spec")
    q_policy = policy_beside_greedy(torch, dec, engine, prompts, max_new,
                                    sched_kwargs,
                                    "serve_int8_weights_int8_kv_policy")
    if q_policy["paged_decode_quant_fwd"] <= 0 or \
            q_policy["int8_matmul_fwd"] <= 0:
        fail(f"int8 / int8 policy serve launches {q_policy}")
    s = sched.summary()
    leaves = sum(t.numel() * t.element_size()
                 for layer in sched.pools["layers"] for t in layer.values())
    page_bytes = engine.kv_page_bytes(sched_kwargs["page_size"])
    want = [[int(t) for t in engine.generate(p[None], max_new_tokens=m)[
        0, len(p):]] for p, m in zip(prompts, max_new)]
    counts = {**dec.launch_counts(), **qk.launch_counts()}
    live_err = live_pool_check(torch, dec, sched, torch.bfloat16,
                               model.cfg.num_heads, "int8 KV", seed + 7)
    seq = np.random.default_rng(seed + 8).integers(
        0, model.cfg.vocab_size, 200).astype(np.int32)
    deltas, argmax_agree, logit_scale = teacher_forced_delta(
        engine, seq, sched_kwargs)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters()) + \
        sum(b.numel() * b.element_size() for b in model.buffers())
    emit({"phase": "serve_int8_weights_int8_kv", "compute": "bfloat16",
          "group_size": engine._config.quant.group_size,
          "quantize_s": round(quantize_s, 3), **runs["graph_steady"],
          **runs, "weight_dtype": s["weight_dtype"],
          "kv_dtype": s["kv_dtype"],
          "kv_pool_bytes_total": s["kv_pool_bytes_total"],
          "kv_page_bytes": page_bytes, "weight_bytes": weight_bytes,
          "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
          "paged_attention": s["paged_attention"],
          "two_runs_identical": got == again,
          "agreement_with_generate": agreement(got, want),
          "agreement_with_fp32": agreement(got, got32),
          "live_pool_kernel_vs_plain_err": live_err,
          "teacher_forced_logit_delta_max": max(deltas),
          "teacher_forced_logit_deltas": deltas,
          "teacher_forced_argmax_agreement": argmax_agree,
          "teacher_forced_logit_scale": logit_scale,
          "logit_delta_ceiling": KV_LOGIT_DELTA_CEILING,
          "launches": counts})
    if (s["weight_dtype"], s["kv_dtype"]) != ("int8", "int8") or \
            s["paged_attention"]["path"] != "kernel":
        fail(f"quantized serve ran as {s['weight_dtype']} weights, "
             f"{s['kv_dtype']} KV, {s['paged_attention']}")
    if not (s["kv_pool_bytes_total"] == leaves ==
            (sched_kwargs["num_pages"] + 1) * page_bytes):
        fail(f"kv_pool_bytes_total {s['kv_pool_bytes_total']} != leaves "
             f"{leaves} or (pages + 1) x kv_page_bytes {page_bytes}")
    if got != again:
        fail("two int8 serving runs gave different tokens")
    if not max(deltas) < KV_LOGIT_DELTA_CEILING:
        fail(f"teacher-forced int8-KV logit delta {max(deltas)} >= "
             f"{KV_LOGIT_DELTA_CEILING}")

    # fp8 pools on the same engine, two requests
    dec.reset_launch_counts()
    qk.reset_launch_counts()
    fp8_kwargs = dict(sched_kwargs, kv_dtype="fp8")
    got8, sched8, wall8 = serve(torch, engine, prompts[:2], max_new[:2],
                                fp8_kwargs)
    again8, _, _ = serve(torch, engine, prompts[:2], max_new[:2], fp8_kwargs)
    fp8_counts = {**dec.launch_counts(), **qk.launch_counts()}
    err8 = live_pool_check(torch, dec, sched8, torch.bfloat16,
                           model.cfg.num_heads, "fp8 KV", seed + 9)
    s8 = sched8.summary()
    emit({"phase": "serve_int8_weights_fp8_kv", "serve_s": round(wall8, 3),
          "tokens": s8["tokens_emitted"],
          "tokens_per_s": s8["tokens_emitted"] / wall8,
          "kv_dtype": s8["kv_dtype"],
          "kv_pool_bytes_total": s8["kv_pool_bytes_total"],
          "two_runs_identical": got8 == again8,
          "captures": sched8.captures,
          "chained_horizons": sum(sched8.chains),
          "agreement_with_int8_kv": agreement(got8, got[:2]),
          "live_pool_kernel_vs_plain_err": err8,
          "launches": fp8_counts})
    if s8["kv_dtype"] != "fp8" or got8 != again8 or \
            fp8_counts["paged_decode_quant_fwd"] <= 0:
        fail(f"fp8 KV serve: kv_dtype {s8['kv_dtype']}, identical "
             f"{got8 == again8}, launches {fp8_counts}")
    for name in counts:
        counts[name] += fp8_counts[name]
    counts["policy"] = q_policy
    return got, counts


def serve_int8_fp32(torch, deepspeed_tpu_torch, dec, model, prompts, max_new,
                    sched_kwargs, seed):
    """Phase 6c: int8 weights, fp32 compute, float32 KV — the oracle
    mode.  The weights are drawn again from the seed in fp32, then
    quantized; serving must equal generate() token for token."""
    from deepspeed_tpu_torch.ops.quant import kernels as qk
    dec.reset_launch_counts()
    qk.reset_launch_counts()
    engine = deepspeed_tpu_torch.init_inference(
        model, dtype="float32", quant={"enabled": True},
        kv_cache_dtype="float32", max_out_tokens=512)
    engine.init_params(seed)
    t0 = time.monotonic()
    want = [[int(t) for t in engine.generate(p[None], max_new_tokens=m)[
        0, len(p):]] for p, m in zip(prompts, max_new)]
    gen_s = time.monotonic() - t0
    got, sched, wall = serve(torch, engine, prompts, max_new, sched_kwargs)
    counts = {**dec.launch_counts(), **qk.launch_counts()}
    exact = [g == w for g, w in zip(got, want)]
    s = sched.summary()
    emit({"phase": "serve_int8_weights_fp32", "compute": "float32",
          "kv_dtype": s["kv_dtype"], "weight_dtype": s["weight_dtype"],
          "generate_s": round(gen_s, 3), "serve_s": round(wall, 3),
          "tokens_per_s": s["tokens_emitted"] / wall,
          "preemptions": s["preemptions"], "captures": sched.captures,
          "chained_horizons": sum(sched.chains),
          "token_exact_vs_generate": exact, "launches": counts})
    if not sum(sched.chains):
        fail("int8-weight fp32 serve: no horizon was chained")
    if not all(exact):
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                emit({"mismatch": i, "serve": g, "generate": w})
        fail("int8-weight fp32 serving is not token-exact against "
             "generate()")
    return got, counts


def serve_grouped(torch, deepspeed_tpu_torch, dec, seed, dtype="bfloat16"):
    """Phase 6d: Llama-2-70B widths (64 query heads over 8 kv heads) at 2
    layers, ``dtype`` compute (bf16; fp16 in phase 6i): a few short
    requests over pools of that dtype and over int8 pools, so
    paged_decode_fwd and paged_decode_quant_fwd launch at group 8 on a
    serving path.  Returns the launch counts of the two runs."""
    import numpy as np

    from deepspeed_tpu_torch.models.llama import Llama, llama2_70b
    cfg = llama2_70b(num_layers=2)
    engine = deepspeed_tpu_torch.init_inference(
        Llama(cfg, device="cuda"), dtype=dtype, kv_cache_dtype=dtype,
        max_out_tokens=256).init_params(seed)
    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (12, 70, 33)]
    max_new = [12, 8, 10]
    sched_kwargs = dict(num_slots=2, num_pages=32, page_size=16,
                        max_pages_per_slot=8, prefill_chunk=32,
                        decode_horizon_steps=4)
    out = {}
    for kv in (dtype, "int8"):
        dec.reset_launch_counts()
        got, sched, wall = serve(torch, engine, prompts, max_new,
                                 dict(sched_kwargs, kv_dtype=kv))
        counts = dec.launch_counts()
        s = sched.summary()
        err = live_pool_check(torch, dec, sched, getattr(torch, dtype),
                              cfg.num_heads, f"grouped {kv} KV", seed + 11,
                              positions=(0, 7, 60, 100))
        emit({"phase": "serve_grouped", "model": "llama2-70b widths",
              "dtype": dtype, "layers": 2, "heads": cfg.num_heads,
              "kv_heads": cfg.num_kv_heads, "kv_dtype": s["kv_dtype"],
              "requests": len(prompts), "tokens": s["tokens_emitted"],
              "serve_s": round(wall, 3),
              "paged_attention": s["paged_attention"],
              "captures": sched.captures,
              "chained_horizons": sum(sched.chains),
              "live_pool_kernel_vs_plain_err": err,
              "launches": counts})
        if s["kv_dtype"] != kv or \
                [len(g) for g in got] != max_new:
            fail(f"grouped serve over {kv} pools: kv_dtype {s['kv_dtype']}, "
                 f"{[len(g) for g in got]} tokens")
        out[kv] = counts
    return out[dtype]["paged_decode_fwd"], \
        out["int8"]["paged_decode_quant_fwd"]


# ------------------------------------------------ GPT-2 family serving
#
# Each configuration names its public config; the weights are seeded
# random.  GPT-J-6B runs at its full width with 2 of its 28 layers.
GPT2_FAMILY = {
    # HF gpt2 config.json: n_embd 768, n_layer 12, n_head 12, vocab 50257
    "gpt2-small": dict(vocab_size=50257, hidden_size=768, num_layers=12,
                       num_heads=12, max_seq_len=1024),
    # bigscience/bloom-560m config.json: hidden 1024, n_layer 24, n_head
    # 16, vocab 250880, ALiBi, word_embeddings_layernorm
    "bloom-560m": dict(vocab_size=250880, hidden_size=1024, num_layers=24,
                       num_heads=16, max_seq_len=2048, pos_embed="none",
                       use_alibi=True, embed_layernorm=True),
    # EleutherAI/pythia-160m config.json: hidden 768, 12 layers, 12 heads,
    # rotary_pct 0.25, use_parallel_residual, untied, hidden_act gelu,
    # vocab 50304
    "pythia-160m": dict(vocab_size=50304, hidden_size=768, num_layers=12,
                        num_heads=12, max_seq_len=2048, pos_embed="none",
                        rotary_dim=16, parallel_residual=True,
                        tie_embeddings=False, activation="gelu_exact"),
    # facebook/opt-125m config.json: hidden 768, 12 layers, 12 heads, ffn
    # 3072, relu, learned positions at index + 2, vocab 50272
    "opt-125m": dict(vocab_size=50272, hidden_size=768, num_layers=12,
                     num_heads=12, max_seq_len=2048, activation="relu",
                     pos_offset=2),
    # EleutherAI/gpt-neo-125M config.json: hidden 768, 12 layers, 12
    # heads, attention_types [[global, local], 6], window_size 256
    "gpt-neo-125m": dict(vocab_size=50257, hidden_size=768, num_layers=12,
                         num_heads=12, max_seq_len=2048, qkv_bias=False,
                         attn_windows=(0, 256) * 6),
    # EleutherAI/gpt-j-6b config.json: n_embd 4096, n_head 16 (d 256),
    # rotary_dim 64 (rotate every two), parallel residual off one
    # LayerNorm, unbiased attention, untied biased head, vocab 50400;
    # 2 of its 28 layers
    "gpt-j-6b (2 layers)": dict(
        vocab_size=50400, hidden_size=4096, num_layers=2, num_heads=16,
        max_seq_len=2048, pos_embed="none", rotary_dim=64,
        rotary_interleaved=True, parallel_residual=True, single_ln=True,
        attn_bias=False, tie_embeddings=False, lm_head_bias=True),
}


def gpt2_family_kernels(torch, dec):
    """Row 1 at GPT-2 small heads without and with ALiBi, at BLOOM-560m
    heads with ALiBi and at GPT-J's d 256; row 3 (float and int8 pools)
    at GPT-J's heads; fp32 and bf16, each against its plain version."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for key, h, d, alibi in (("gpt2", 12, 64, False),
                                 ("gpt2_alibi", 12, 64, True),
                                 ("bloom_alibi", 16, 64, True),
                                 ("gptj_d256", 16, 256, False)):
            out[(key, dn)] = dense_case(
                torch, dec, f"{key} heads {h} x {d} generate cache", 1, h, h,
                d, 256, [215], dtype, rotations=8, seed=60, alibi=alibi)
        for kv_name in (None, "int8"):
            out[("gptj_paged", kv_name, dn)] = paged_case(
                torch, dec, "gpt-j heads (16 x 256) serve batch", 16, 16,
                256, 16, [0, 7, 100, 231], dtype, rotations=4, seed=61,
                kv_name=kv_name)
    return out


def family_engine(torch, deepspeed_tpu_torch, name, seed, **kw):
    from deepspeed_tpu_torch.models.gpt2 import GPT2, GPTConfig
    model = GPT2(GPTConfig(**{**GPT2_FAMILY[name], **kw.pop("cfg", {})}),
                 device="cuda")
    engine = deepspeed_tpu_torch.init_inference(
        model, max_out_tokens=512, **{"dtype": "float32",
                                      "kv_cache_dtype": "float32", **kw})
    return engine.init_params(seed)


def family_serve(torch, dec, engine, name, prompts, max_new, sched_kwargs):
    """generate() then a graph + overlap scheduler over the requests;
    fails unless the streams are token-exact.  Returns the phase line
    (with the decode launches of the serve run alone)."""
    t0 = time.monotonic()
    want = generated(engine, prompts, max_new)
    gen_s = time.monotonic() - t0
    before = dec.launch_counts()
    got, sched, wall = serve(torch, engine, prompts, max_new, sched_kwargs)
    counts = {k: v - before[k] for k, v in dec.launch_counts().items()}
    check_exact(engine, f"serve_gpt2_family {name}", prompts, got, want)
    cfg = engine.module.cfg
    return {"phase": "serve_gpt2_family", "model": name,
            "layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "heads": cfg.num_heads, "vocab": cfg.vocab_size,
            "params": sum(p.numel() for p in engine.module.parameters()),
            "requests": len(prompts), "generate_s": round(gen_s, 3),
            "serve_s": round(wall, 3), "captures": sched.captures,
            "chained_horizons": sum(sched.chains),
            "token_exact_vs_generate": True,
            "serve_launches": counts}


def serve_gpt2_family(torch, deepspeed_tpu_torch, dec, qk, seed,
                      sched_kwargs):
    """Phase 6g.  Returns the launch counts of the phase (every count is
    set to 0 at its start and read at its end)."""
    import numpy as np

    from deepspeed_tpu_torch.serving import ServingScheduler
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics
    t_phase = time.monotonic()
    dec.reset_launch_counts()
    qk.reset_launch_counts()
    prompts, max_new = make_requests(seed, 50257)
    # (a) GPT-2 small, fp32: graphs + overlap, an n-gram spec run, a
    # prefix-cache run, each token-exact against generate()
    engine = family_engine(torch, deepspeed_tpu_torch, "gpt2-small", seed)
    line = family_serve(torch, dec, engine, "gpt2-small", prompts, max_new,
                        sched_kwargs)
    motif, motif_new = motif_requests(seed, 50257)
    toks, numbers, _ = spec_serve(torch, engine, motif, motif_new,
                                  sched_kwargs)
    check_exact(engine, "serve_gpt2_family gpt2-small ngram", motif,
                toks[0], generated(engine, motif, motif_new))
    if not numbers[0]["spec_dispatches"]:
        fail(f"gpt2-small n-gram serve dispatched no verify: {numbers[0]}")
    pre, pre_new = prefix_requests(seed, 50257)
    got, s, _, _, _ = cached_serve(torch, engine, pre[:3], pre_new[:3],
                                   sched_kwargs)
    check_exact(engine, "serve_gpt2_family gpt2-small prefix", pre[:3],
                got, generated(engine, pre[:3], pre_new[:3]))
    if not s["prefix_hits"]:
        fail(f"gpt2-small prefix cache: no hit ({s})")
    line.update(spec=numbers[0], prefix_hits=s["prefix_hits"],
                prefill_tokens_saved=s["prefill_tokens_saved"])
    emit(line)
    del engine
    # (b) GPT-2 small in bf16: a serve smoke reading (the steady second
    # run of one graph scheduler), then int8 weights (group 64) over
    # int8 KV on the same module, quantized in place: two runs identical
    # and the teacher-forced int8-KV logit delta under its ceiling
    engine = family_engine(torch, deepspeed_tpu_torch, "gpt2-small", seed,
                           dtype="bfloat16", kv_cache_dtype="bfloat16",
                           cfg=dict(dtype=torch.bfloat16))
    model = engine.module
    sched = ServingScheduler(engine, **sched_kwargs)
    first, _ = run_mix(torch, sched, prompts, max_new)
    sched.metrics = ServingMetrics()
    steps0 = sched.step_idx
    again, wall = run_mix(torch, sched, prompts, max_new)
    emit({"phase": "serve_gpt2_family_bf16", "model": "gpt2-small",
          **serve_numbers(sched.metrics.summary(wall), wall,
                          sched.step_idx - steps0),
          "steady_equals_first_run": again == first})
    del engine, sched
    engine = deepspeed_tpu_torch.init_inference(
        model, dtype="int8", kv_cache_dtype="int8", max_out_tokens=512)
    sched = ServingScheduler(engine, **sched_kwargs)
    first, _ = run_mix(torch, sched, prompts, max_new)
    again, wall = run_mix(torch, sched, prompts, max_new)
    seq = np.random.default_rng(seed + 8).integers(0, 50257, 200).astype(
        np.int32)
    deltas, argmax_agree, logit_scale = teacher_forced_delta(
        engine, seq, sched_kwargs)
    emit({"phase": "serve_gpt2_family_int8_weights_int8_kv",
          "model": "gpt2-small", "compute": "bfloat16",
          "two_runs_identical": again == first, "serve_s": round(wall, 3),
          "teacher_forced_max_logit_delta": max(deltas),
          "teacher_forced_argmax_agreement": argmax_agree,
          "largest_logit": logit_scale,
          "ceiling": KV_LOGIT_DELTA_CEILING})
    if again != first or not max(deltas) < KV_LOGIT_DELTA_CEILING:
        fail(f"gpt2-small int8 / int8: runs identical {again == first}, "
             f"logit delta {max(deltas)}")
    del engine, sched, model
    torch.cuda.empty_cache()
    # (c) BLOOM-560m, Pythia-160m, OPT-125m and GPT-J-6B width, fp32:
    # served token-exact against generate(); BLOOM's ALiBi paged decode
    # runs decode_fwd over the gathered pages and no paged kernel
    for name in ("bloom-560m", "pythia-160m", "opt-125m",
                 "gpt-j-6b (2 layers)"):
        engine = family_engine(torch, deepspeed_tpu_torch, name, seed)
        line = family_serve(torch, dec, engine, name, prompts[:3],
                            max_new[:3], sched_kwargs)
        counts = line["serve_launches"]
        emit(line)
        if name == "bloom-560m" and (
                counts["decode_fwd"] <= 0 or counts["paged_decode_fwd"] or
                counts["paged_decode_quant_fwd"]):
            fail(f"bloom-560m paged decode launches {counts}: ALiBi over "
                 "pools must run decode_fwd and no paged kernel")
        del engine
        torch.cuda.empty_cache()
    # (d) GPT-Neo-125M: generate() past its 256-token window, held
    # against a full forward's argmax (no cache, the plain local-window
    # attention); a scheduler over its pools is refused
    engine = family_engine(torch, deepspeed_tpu_torch, "gpt-neo-125m", seed)
    prompt = np.random.default_rng(seed + 9).integers(0, 50257, 250).astype(
        np.int32)
    out = engine.generate(prompt[None], max_new_tokens=24)[0]
    logits = engine.forward(out[None, :-1])[0, len(prompt) - 1:]
    forced = [int(t) for t in logits.float().argmax(-1)]
    check_exact(engine, "serve_gpt2_family gpt-neo-125m generate vs "
                "forward", [prompt], [[int(t) for t in out[len(prompt):]]],
                [forced])
    try:
        ServingScheduler(engine, **sched_kwargs)
    except NotImplementedError as e:
        refusal = str(e)
    else:
        fail("gpt-neo-125m: the scheduler accepted local windows over pools")
    emit({"phase": "serve_gpt2_family", "model": "gpt-neo-125m",
          "generate_tokens": len(out), "window": 256,
          "generate_equals_forward_argmax": True,
          "scheduler_refused": refusal})
    del engine
    torch.cuda.empty_cache()
    total = {**dec.launch_counts(), **qk.launch_counts()}
    emit({"phase": "serve_gpt2_family_done", "launches": total,
          "phase_s": round(time.monotonic() - t_phase, 3)})
    missing = [k for k in ("decode_fwd", "paged_decode_fwd",
                           "paged_decode_quant_fwd", "int8_matmul_fwd")
               if total.get(k, 0) <= 0]
    if missing:
        fail(f"phase 6g: {missing} never launched ({total})")
    return total


# ------------------------------------------------- HF ingestion (6h)
#
# Each config.json is copied by hand from the public file; the weights are
# seeded random, written by this package (no transformers, no
# safetensors).  Llama-2-7B is cut to 2 of its 32 layers.
LLAMA2_7B_HF = {
    # meta-llama/Llama-2-7b-hf config.json (num_hidden_layers cut 32 -> 2;
    # torch_dtype: the bf16 written here)
    "architectures": ["LlamaForCausalLM"], "bos_token_id": 1,
    "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 11008,
    "max_position_embeddings": 4096, "model_type": "llama",
    "num_attention_heads": 32, "num_hidden_layers": 2,
    "num_key_value_heads": 32, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 32000}
GPT2_HF = {
    # openai-community/gpt2 config.json
    "activation_function": "gelu_new", "architectures": ["GPT2LMHeadModel"],
    "attn_pdrop": 0.1, "bos_token_id": 50256, "embd_pdrop": 0.1,
    "eos_token_id": 50256, "initializer_range": 0.02,
    "layer_norm_epsilon": 1e-05, "model_type": "gpt2", "n_ctx": 1024,
    "n_embd": 768, "n_head": 12, "n_layer": 12, "n_positions": 1024,
    "resid_pdrop": 0.1, "summary_activation": None,
    "summary_first_dropout": 0.1, "summary_proj_to_labels": True,
    "summary_type": "cls_index", "summary_use_proj": True,
    "task_specific_params": {"text-generation": {"do_sample": True,
                                                 "max_length": 50}},
    "vocab_size": 50257}
# the port's Llama names -> HF's (nn.Linear is [out, in] in both)
LLAMA_LAYER_NAMES = {
    "input_norm.scale": "input_layernorm.weight",
    "post_attn_norm.scale": "post_attention_layernorm.weight",
    "attn.wq.weight": "self_attn.q_proj.weight",
    "attn.wk.weight": "self_attn.k_proj.weight",
    "attn.wv.weight": "self_attn.v_proj.weight",
    "attn.wo.weight": "self_attn.o_proj.weight",
    "mlp.w_gate.weight": "mlp.gate_proj.weight",
    "mlp.w_up.weight": "mlp.up_proj.weight",
    "mlp.w_down.weight": "mlp.down_proj.weight"}
# the port's GPT-2 names -> HF's (Conv1D: [in, out], so transposed)
GPT2_LAYER_NAMES = {"attn.qkv": "attn.c_attn", "attn.proj": "attn.c_proj",
                    "mlp.fc_in": "mlp.c_fc", "mlp.fc_out": "mlp.c_proj",
                    "ln_1": "ln_1", "ln_2": "ln_2"}


def hf_name(family, name):
    """(HF state dict name, transposed) of a port state_dict name."""
    if family == "llama":
        top = {"embed_tokens.weight": "model.embed_tokens.weight",
               "norm.scale": "model.norm.weight",
               "lm_head.weight": "lm_head.weight"}
        if name in top:
            return top[name], False
        _, i, rest = name.split(".", 2)
        return f"model.layers.{i}.{LLAMA_LAYER_NAMES[rest]}", False
    if name in ("wte", "wpe"):
        return f"transformer.{name}.weight", False
    if name.startswith("ln_f."):
        return f"transformer.{name}", False
    _, i, rest = name.split(".", 2)
    module, leaf = rest.rsplit(".", 1)
    conv = leaf == "weight" and module != "ln_1" and module != "ln_2"
    return f"transformer.h.{i}.{GPT2_LAYER_NAMES[module]}.{leaf}", conv


def hf_weights(torch, family, cfg, seed, dtype):
    """Seeded random HF state dict (host tensors, ``dtype``): normal 0.02
    for the matrices, 1 + normal 0.02 for norm scales, normal 0.02 for
    biases, drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape, base=0.0):
        return (base + 0.02 * torch.randn(*shape, generator=g,
                                          device="cuda")).to(dtype).cpu()
    if family == "llama":
        e, m, v = cfg["hidden_size"], cfg["intermediate_size"], \
            cfg["vocab_size"]
        sd = {"model.embed_tokens.weight": w(v, e),
              "model.norm.weight": w(e, base=1.0),
              "lm_head.weight": w(v, e)}
        for i in range(cfg["num_hidden_layers"]):
            h = f"model.layers.{i}."
            sd[h + "input_layernorm.weight"] = w(e, base=1.0)
            sd[h + "post_attention_layernorm.weight"] = w(e, base=1.0)
            for n in "qkvo":
                sd[h + f"self_attn.{n}_proj.weight"] = w(e, e)
            sd[h + "mlp.gate_proj.weight"] = w(m, e)
            sd[h + "mlp.up_proj.weight"] = w(m, e)
            sd[h + "mlp.down_proj.weight"] = w(e, m)
        return sd
    e, v = cfg["n_embd"], cfg["vocab_size"]
    sd = {"transformer.wte.weight": w(v, e),
          "transformer.wpe.weight": w(cfg["n_positions"], e),
          "transformer.ln_f.weight": w(e, base=1.0),
          "transformer.ln_f.bias": w(e)}
    for i in range(cfg["n_layer"]):
        h = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[h + ln + ".weight"] = w(e, base=1.0)
            sd[h + ln + ".bias"] = w(e)
        for name, n_in, n_out in (("attn.c_attn", e, 3 * e),
                                  ("attn.c_proj", e, e),
                                  ("mlp.c_fc", e, 4 * e),
                                  ("mlp.c_proj", 4 * e, e)):
            sd[h + name + ".weight"] = w(n_in, n_out)       # Conv1D
            sd[h + name + ".bias"] = w(n_out)
    return sd


def hf_ingest(torch, deepspeed_tpu_torch, dec, qk, seed, sched_kwargs,
              smi, workdir):
    """Phase 6h: two HF directories written here, ingested on the card
    (``init_inference(<dir>)``), each weight equal to what was written,
    graph + overlap serving token-exact against ``generate()``; the
    Llama directory again with int8 weights over int8 KV, two runs
    identical.  Returns the launch counts of the phase."""
    from deepspeed_tpu_torch.module_inject.hf_weights import save_hf_dir
    from deepspeed_tpu_torch.serving import ServingScheduler
    t_phase = time.monotonic()
    dec.reset_launch_counts()
    qk.reset_launch_counts()
    for family, cfg, fmt, shards, dtype, label in (
            ("llama", LLAMA2_7B_HF, "safetensors", 2, torch.bfloat16,
             "llama2-7b width"),
            ("gpt2", GPT2_HF, "bin", 1, torch.float32, "gpt2-small")):
        path = os.path.join(workdir, family)
        sd = hf_weights(torch, family, cfg, seed, dtype)
        t0 = time.monotonic()
        save_hf_dir(path, cfg, sd, fmt=fmt, shards=shards)
        write_s = time.monotonic() - t0
        files = sorted(f for f in os.listdir(path) if f != "config.json")
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in files)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        engine = deepspeed_tpu_torch.init_inference(
            path, dtype="float32", kv_cache_dtype="float32",
            max_out_tokens=512)
        torch.cuda.synchronize()
        ingest_s = time.monotonic() - t0
        unequal = []
        for name, t in engine.module.state_dict().items():
            src, transposed = hf_name(family, name)
            want = sd[src].t() if transposed else sd[src]
            if not torch.equal(t.cpu(), want.float()):
                unequal.append(name)
        if unequal or len(engine.module.state_dict()) != len(sd):
            fail(f"6h {label}: ingested weights differ from the files: "
                 f"{unequal[:5]} ({len(engine.module.state_dict())} leaves "
                 f"for {len(sd)} written)")
        prompts, max_new = make_requests(seed, cfg["vocab_size"])
        want = generated(engine, prompts, max_new)
        got, sched, wall = serve(torch, engine, prompts, max_new,
                                 sched_kwargs)
        check_exact(engine, f"hf_ingest {label}", prompts, got, want)
        line = {"phase": "hf_ingest", "model": label, "format": fmt,
                "files": files, "bytes": nbytes, "file_dtype":
                str(dtype).replace("torch.", ""),
                "layers": cfg.get("num_hidden_layers", cfg.get("n_layer")),
                "cut": "2 of 32 layers" if family == "llama" else None,
                "write_s": round(write_s, 3), "ingest_s": round(ingest_s, 3),
                "ingest_gb_per_s": nbytes / ingest_s / 1e9,
                "weights_equal_files": True, "token_exact_vs_generate": True,
                "serve_s": round(wall, 3), "captures": sched.captures,
                "chained_horizons": sum(sched.chains), "gpu": smi}
        del engine, sched
        torch.cuda.empty_cache()
        if family == "llama":
            # int8 weights over int8 KV, from the same directory
            engine = deepspeed_tpu_torch.init_inference(
                path, dtype="int8", kv_cache_dtype="int8", max_out_tokens=512)
            sched = ServingScheduler(engine, **sched_kwargs)
            first, _ = run_mix(torch, sched, prompts, max_new)
            again, wall8 = run_mix(torch, sched, prompts, max_new)
            line.update(int8_two_runs_identical=again == first,
                        int8_serve_s=round(wall8, 3),
                        int8_agreement_with_fp32=agreement(again, got))
            if again != first:
                fail("6h llama int8 / int8: two runs differ")
            del engine, sched
            torch.cuda.empty_cache()
        emit(line)
        del sd
    total = {**dec.launch_counts(), **qk.launch_counts()}
    emit({"phase": "hf_ingest_done", "launches": total,
          "phase_s": round(time.monotonic() - t_phase, 3)})
    missing = [k for k in ("paged_decode_fwd", "paged_decode_quant_fwd",
                           "int8_matmul_fwd", "decode_fwd")
               if total.get(k, 0) <= 0]
    if missing:
        fail(f"phase 6h: {missing} never launched ({total})")
    return total


# ------------------------------------------------- checkpoints (8b)


def train_checkpoints(torch, deepspeed_tpu_torch, fl, engine, config, data,
                      seed, smi, workdir):
    """Phase 8b on phase 8's bf16 engine: save, two more steps; a fresh
    engine loads and takes the same two steps (losses, masters and
    moments equal); an async save followed at once by a step leaves the
    pre-step masters in the files; verify_checkpoint passes and a
    flipped byte raises CheckpointCorrupt; init_inference(checkpoint=)
    serves the saved weights with the training module's logits.
    Returns the flash launch counts of the phase."""
    from deepspeed_tpu_torch.checkpoint.engine import (CheckpointCorrupt,
                                                       verify_checkpoint)
    from deepspeed_tpu_torch.models.gpt2 import GPT2, gpt2_small
    t_phase = time.monotonic()
    fl.reset_launch_counts()
    run = os.path.join(workdir, "run")

    def state(e):
        return [p.detach() for p in e.module.parameters()] + \
            e.optimizer.mu + e.optimizer.nu

    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine.save_checkpoint(run, tag="saved")
    save_s = time.monotonic() - t0
    tag = os.path.join(run, "saved")
    nbytes = sum(os.path.getsize(os.path.join(tag, f))
                 for f in os.listdir(tag))
    want = [engine.train_batch(batches=[data[i % 2]]) for i in range(2)]
    fresh = deepspeed_tpu_torch.initialize(
        model=GPT2(gpt2_small(dtype="bfloat16")), config=config,
        seed=seed + 5)[0]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fresh.load_checkpoint(run)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    # the saved weights served: an fp32 engine against an fp32 module of
    # the loaded masters, a bf16 engine against the training module itself
    ids = data[0]["input_ids"][:2]
    twin = GPT2(gpt2_small(), device="cuda")
    twin.load_state_dict(fresh.module.state_dict())
    served = {}
    for dtype, module, ref in (("float32", GPT2(gpt2_small()), twin),
                               ("bfloat16",
                                GPT2(gpt2_small(dtype="bfloat16")),
                                fresh.module)):
        inf = deepspeed_tpu_torch.init_inference(
            module, checkpoint=run, dtype=dtype)
        with torch.no_grad():
            served[dtype] = bool(torch.equal(
                inf.forward(ids.cpu().numpy()), ref(ids)))
        del inf
    del twin
    got = [fresh.train_batch(batches=[data[i % 2]]) for i in range(2)]
    resumed_equal = got == want and all(
        torch.equal(a, b) for a, b in zip(state(engine), state(fresh)))
    # async: the save returns once the state is on the host; the step
    # after it must not reach the files
    before = [p.detach().clone() for p in engine.module.parameters()]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine.save_checkpoint(run, tag="async", async_save=True)
    async_return_s = time.monotonic() - t0
    engine.train_batch(batches=[data[0]])
    engine.wait_checkpoint()
    async_total_s = time.monotonic() - t0
    fresh.load_checkpoint(run, tag="async")
    pre_step = all(torch.equal(a, b) for a, b in
                   zip(fresh.module.parameters(), before)) and not all(
        torch.equal(a, b) for a, b in
        zip(fresh.module.parameters(), engine.module.parameters()))
    ok, problems = verify_checkpoint(tag)
    shard = [f for f in os.listdir(tag) if f.startswith("shards")][0]
    with open(os.path.join(tag, shard), "r+b") as f:
        f.seek(os.path.getsize(os.path.join(tag, shard)) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    bad_ok, bad_problems = verify_checkpoint(tag)
    try:
        fresh.load_checkpoint(run, tag="saved")
        caught = False
    except CheckpointCorrupt:
        caught = True
    counts = fl.launch_counts()
    emit({"phase": "train_checkpoint", "model": "gpt2-small",
          "dtype": "bfloat16 over fp32 masters", "checkpoint_bytes": nbytes,
          "save_s": round(save_s, 3), "save_gb_per_s": nbytes / save_s / 1e9,
          "async_return_s": round(async_return_s, 3),
          "async_total_s": round(async_total_s, 3),
          "load_s": round(load_s, 3), "load_gb_per_s": nbytes / load_s / 1e9,
          "losses_after_save": want, "losses_after_resume": got,
          "resume_equal": resumed_equal, "async_files_pre_step": pre_step,
          "verify_ok": ok, "corrupt_verify_ok": bad_ok,
          "corrupt_problems": bad_problems[:2],
          "corruption_raises": caught, "served_logits_equal": served,
          "launches": counts, "gpu": smi,
          "phase_s": round(time.monotonic() - t_phase, 3)})
    if not (resumed_equal and pre_step and ok and not bad_ok and caught
            and all(served.values())):
        fail(f"phase 8b: resume equal {resumed_equal}, async pre-step "
             f"{pre_step}, verify {ok} / corrupt {bad_ok} {problems}, "
             f"corruption raised {caught}, served equal {served}")
    del fresh
    return counts


# ---------------------------------------------------- fp16 serving (6i)


def first_nonfinite_layer(torch, engine, ids):
    """The index of the first decoder layer whose output holds a
    non-finite value in a no-cache forward of ``ids`` (None: all are
    finite), and whether the logits are."""
    blocks = getattr(engine.module, "layers", None) or engine.module.h
    bad = []

    def hook(i):
        def fn(_mod, _inp, out):
            x = out[0] if isinstance(out, tuple) else out
            if not bad and not bool(torch.isfinite(x).all()):
                bad.append(i)
        return fn
    handles = [b.register_forward_hook(hook(i)) for i, b in enumerate(blocks)]
    logits = engine.forward(ids)
    for h in handles:
        h.remove()
    return (bad[0] if bad else None), bool(torch.isfinite(logits).all())


def serve_twice(torch, engine, prompts, max_new, sched_kwargs):
    """Two runs of the requests on one graph + overlap scheduler: (first
    tokens, second tokens, the second run's numbers)."""
    from deepspeed_tpu_torch.serving import ServingScheduler
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics
    sched = ServingScheduler(engine, **sched_kwargs)
    chains = count_chains(sched)
    first, _ = run_mix(torch, sched, prompts, max_new)
    sched.metrics = ServingMetrics()
    steps0 = sched.step_idx
    again, wall = run_mix(torch, sched, prompts, max_new)
    return first, again, dict(
        serve_numbers(sched.metrics.summary(wall), wall,
                      sched.step_idx - steps0),
        chained_horizons=sum(chains), kv_dtype=sched.summary()["kv_dtype"])


def serve_fp16(torch, deepspeed_tpu_torch, dec, qk, seed, prompts, max_new,
               sched_kwargs, smi, workdir):
    """Phase 6i: float16 on the serving path at full width.  Returns the
    phase's float16 launch counts and those of the group-8 runs (paged
    float, paged quantized)."""
    import numpy as np

    from deepspeed_tpu_torch.models.llama import Llama, llama2_7b
    from deepspeed_tpu_torch.module_inject.hf_weights import save_hf_dir
    f16 = torch.float16
    t_phase = time.monotonic()
    # Llama-2-70B heads at 2 layers over fp16 and int8 pools: rows 2 and
    # 2q (group 8) at fp16
    grouped = serve_grouped(torch, deepspeed_tpu_torch, dec, seed,
                            dtype="float16")
    torch.cuda.empty_cache()
    dec.reset_launch_counts()
    qk.reset_launch_counts()
    # (a) Llama-2-7B, 32 layers, phase 5's weights: drawn in fp32 by the
    # same seed, then the module cast to fp16 in place
    model = Llama(llama2_7b(), device="cuda")
    e32 = deepspeed_tpu_torch.init_inference(
        model, dtype="float32", kv_cache_dtype="float32", max_out_tokens=512)
    e32.init_params(seed)
    seq = np.random.default_rng(seed + 8).integers(
        0, model.cfg.vocab_size, 200).astype(np.int32)
    ref = teacher_forced_logits(e32, seq, "float32", sched_kwargs)
    del e32
    engine = deepspeed_tpu_torch.init_inference(
        model, dtype="float16", kv_cache_dtype="float16", max_out_tokens=512)
    torch.cuda.empty_cache()
    layer, finite = first_nonfinite_layer(torch, engine, prompts[1][None])
    rows = teacher_forced_logits(engine, seq, "float16", sched_kwargs)
    finite = finite and all(bool(torch.isfinite(r).all()) for r in rows)
    if layer is not None or not finite:
        fail(f"6i: seeded Llama-2-7B overflows float16: first non-finite "
             f"layer {layer}, logits finite {finite}")
    deltas, argmax_agree, scale = logit_deltas(rows, ref)
    t0 = time.monotonic()
    want = generated(engine, prompts, max_new)
    gen_s = time.monotonic() - t0
    first, again, numbers = serve_twice(torch, engine, prompts, max_new,
                                        sched_kwargs)
    counts16 = {**dec.launch_counts(f16), **qk.launch_counts(f16)}
    emit({"phase": "serve_fp16", "model": "llama2-7b", "layers": 32,
          "dtype": "float16", **numbers, "generate_s": round(gen_s, 3),
          "two_runs_identical": first == again,
          "agreement_with_generate": agreement(again, want),
          "teacher_forced_logit_delta_vs_fp32_max": max(deltas),
          "teacher_forced_logit_deltas_vs_fp32": deltas,
          "teacher_forced_argmax_agreement": argmax_agree,
          "teacher_forced_logit_scale": scale,
          "logit_delta_ceiling": FP16_LOGIT_DELTA_CEILING,
          "first_nonfinite_layer": layer, "launches_fp16": counts16})
    if first != again or not max(deltas) < FP16_LOGIT_DELTA_CEILING:
        fail(f"6i fp16: two runs identical {first == again}, logit delta "
             f"{max(deltas)} (ceiling {FP16_LOGIT_DELTA_CEILING})")
    del engine
    torch.cuda.empty_cache()

    # (b) fp16 compute over int8 weights (quantized in place) and int8 KV
    engine = deepspeed_tpu_torch.init_inference(
        model, dtype="float16", quant={"enabled": True},
        kv_cache_dtype="int8", max_out_tokens=512)
    first8, again8, numbers8 = serve_twice(torch, engine, prompts, max_new,
                                           sched_kwargs)
    rows8 = teacher_forced_logits(engine, seq, "int8", sched_kwargs)
    deltas8, agree8, _ = logit_deltas(rows8, ref)
    emit({"phase": "serve_fp16_int8_weights_int8_kv", "model": "llama2-7b",
          "compute": "float16", **numbers8,
          "two_runs_identical": first8 == again8,
          "agreement_with_fp16": agreement(again8, again),
          "teacher_forced_logit_delta_vs_fp32_max": max(deltas8),
          "teacher_forced_argmax_agreement": agree8,
          "logits_finite": all(bool(torch.isfinite(r).all())
                               for r in rows8)})
    if first8 != again8:
        fail("6i fp16 over int8 weights and int8 KV: two runs differ")
    del engine, model
    torch.cuda.empty_cache()

    # (c) OPT-125m at full depth and BLOOM-560m at 2 layers (ALiBi over
    # pools: the gathered pages through decode_fwd)
    for name, cut in (("opt-125m", {}), ("bloom-560m", {"num_layers": 2})):
        before = dec.launch_counts(f16)
        engine = family_engine(torch, deepspeed_tpu_torch, name, seed,
                               dtype="float16", kv_cache_dtype="float16",
                               cfg={"dtype": "float16", **cut})
        fam_prompts, fam_new = make_requests(seed, engine.module.cfg
                                             .vocab_size)
        layer, finite = first_nonfinite_layer(torch, engine,
                                              fam_prompts[1][None])
        if layer is not None or not finite:
            fail(f"6i {name}: float16 overflow, first non-finite layer "
                 f"{layer}")
        want = generated(engine, fam_prompts, fam_new)
        first, again, numbers = serve_twice(torch, engine, fam_prompts,
                                            fam_new, sched_kwargs)
        launched = {k: v - before[k]
                    for k, v in dec.launch_counts(f16).items()}
        emit({"phase": "serve_fp16_gpt2_family", "model": name,
              "layers": engine.module.cfg.num_layers, "dtype": "float16",
              **numbers, "two_runs_identical": first == again,
              "agreement_with_generate": agreement(again, want),
              "launches_fp16": launched})
        if first != again:
            fail(f"6i {name} fp16: two runs differ")
        if name.startswith("bloom") and (launched["decode_fwd"] <= 0 or
                                         launched["paged_decode_fwd"]):
            fail(f"6i BLOOM over pools must run decode_fwd alone: "
                 f"{launched}")
        del engine
        torch.cuda.empty_cache()

    # (d) a float16 safetensors directory, config.json saying so
    path = os.path.join(workdir, "llama_fp16")
    cfg = dict(LLAMA2_7B_HF, torch_dtype="float16")
    sd = hf_weights(torch, "llama", cfg, seed, f16)
    save_hf_dir(path, cfg, sd, fmt="safetensors", shards=2)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine = deepspeed_tpu_torch.init_inference(
        path, dtype="float16", kv_cache_dtype="float16", max_out_tokens=512)
    torch.cuda.synchronize()
    ingest_s = time.monotonic() - t0
    unequal = [n for n, t in engine.module.state_dict().items()
               if not torch.equal(t.cpu(), sd[hf_name("llama", n)[0]])]
    hf_prompts, hf_new = make_requests(seed, cfg["vocab_size"])
    want = generated(engine, hf_prompts, hf_new)
    first, again, numbers = serve_twice(torch, engine, hf_prompts, hf_new,
                                        sched_kwargs)
    emit({"phase": "serve_fp16_hf_dir", "model": "llama2-7b width",
          "layers": 2, "file_dtype": "float16", "torch_dtype": "float16",
          "ingest_s": round(ingest_s, 3), "weights_equal_files": not unequal,
          **numbers, "two_runs_identical": first == again,
          "agreement_with_generate": agreement(again, want)})
    if unequal or first != again:
        fail(f"6i fp16 HF directory: weights differ {unequal[:4]}, two "
             f"runs identical {first == again}")
    del engine, sd
    torch.cuda.empty_cache()
    counts = {**dec.launch_counts(), **qk.launch_counts()}
    counts16 = {**dec.launch_counts(f16), **qk.launch_counts(f16)}
    emit({"phase": "serve_fp16_done", "launches": counts,
          "launches_fp16": counts16, "launches_fp16_group_8": grouped,
          "gpu": smi, "phase_s": round(time.monotonic() - t_phase, 3)})
    return counts16, grouped


# ---------------------------------------------------- fp16 training (8f)


def reference_scale(scale, overflows, hysteresis=2, window=1000,
                    min_scale=1.0):
    """The loss scale after each step of ``overflows``, by the reference's
    rule written out on the host: an overflow spends one hysteresis and,
    once none is left, halves the scale (not below ``min_scale``) and
    refills it; ``window`` good steps in a row double it and refill it."""
    out, hyst, good = [], hysteresis, 0
    for ovf in overflows:
        if ovf:
            hyst -= 1
            good = 0
            if hyst <= 0:
                scale, hyst = max(scale / 2, min_scale), hysteresis
        else:
            good += 1
            if good % window == 0:
                scale, good, hyst = scale * 2, 0, hysteresis
        out.append(scale)
    return out


def train_fp16(torch, deepspeed_tpu_torch, fl, seed, bf16_line, smi,
               workdir):
    """Phase 8f: full GPT-2 small in float16 over fp32 masters with
    bench.py's config and ``"fp16": {"enabled": true}`` (dynamic,
    initial_scale_power 16), as phase 8 runs bf16; then a run from
    initial_scale_power 32 through its overflows; then a checkpoint
    round trip.  Returns the float16 flash launches of the phase."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2, gpt2_small
    t_phase = time.monotonic()
    fl.reset_launch_counts()
    batch, seq = 8, 1024
    cfg = gpt2_small(dtype="float16")
    config = {"train_micro_batch_size_per_gpu": batch,
              "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "fp16": {"enabled": True, "initial_scale_power": 16},
              "zero_optimization": {"stage": 1},
              "steps_per_print": 1000000}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = deepspeed_tpu_torch.initialize(model=GPT2(cfg), config=config,
                                            seed=seed)[0]
    n_params = sum(p.numel() for p in engine.module.parameters())
    data = train_batches(torch, seed + 2, 2, batch, seq, cfg.vocab_size)
    losses = [engine.train_batch(batches=[data[i % 2]], sync=False)
              for i in range(3)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i in range(3, 13):
        losses.append(engine.train_batch(batches=[data[i % 2]], sync=False))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    tokens_per_s = 10 * batch * seq / wall
    flops_per_token = 6 * n_params + 12 * cfg.num_layers * \
        cfg.hidden_size * seq
    line = {"phase": "train_fp16", "model": "gpt2-small", "params": n_params,
            "batch": batch, "seq": seq, "zero_stage": 1, "losses": losses,
            "loss_scale": engine.loss_scale,
            "skipped_steps": engine.skipped_steps, "timed_steps": 10,
            "ms_per_step": wall * 1e3 / 10, "tokens_per_s": tokens_per_s,
            "mfu_vs_989_tflops": tokens_per_s * flops_per_token / BF16_FLOPS,
            "max_memory_allocated_bytes": peak,
            "bf16_ms_per_step": bf16_line["ms_per_step"],
            "bf16_tokens_per_s": bf16_line["tokens_per_s"],
            "bf16_mfu_vs_989_tflops": bf16_line["mfu_vs_989_tflops"],
            "bf16_max_memory_allocated_bytes":
            bf16_line["max_memory_allocated_bytes"], "gpu": smi}
    emit(line)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[12] < losses[0]:
        fail(f"fp16 training losses not finite or not falling: {losses}")

    # a checkpoint round trip of this engine: two steps after the save
    # equal two steps of a fresh engine that loads it
    run = os.path.join(workdir, "fp16")
    engine.save_checkpoint(run, tag="saved")
    want = [engine.train_batch(batches=[data[i % 2]]) for i in range(2)]
    fresh = deepspeed_tpu_torch.initialize(model=GPT2(cfg), config=config,
                                           seed=seed + 5)[0]
    fresh.load_checkpoint(run)
    got = [fresh.train_batch(batches=[data[i % 2]]) for i in range(2)]

    def state(e):
        return [p.detach() for p in e.module.parameters()] + \
            e.optimizer.mu + e.optimizer.nu + [
                e.optimizer.count, e.scaler.loss_scale, e.scaler.good_steps,
                e.scaler.hysteresis, e._skipped]
    resumed = got == want and all(
        torch.equal(a, b) for a, b in zip(state(engine), state(fresh)))
    del engine, fresh
    torch.cuda.empty_cache()

    # from 2^32 the first steps overflow: each skipped step leaves the
    # masters, moments and count bit for bit, and the scale follows the
    # reference rule until the run trains
    over = dict(config, fp16={"enabled": True, "initial_scale_power": 32})
    engine = deepspeed_tpu_torch.initialize(model=GPT2(cfg), config=over,
                                            seed=seed)[0]
    flags, scales, kept, trained = [], [], True, []
    for i in range(64):
        before = [t.clone() for t in state(engine)[:-4]]
        loss = engine.train_batch(batches=[data[i % 2]])
        ovf = bool(engine._last_metrics["overflow"])
        flags.append(ovf)
        scales.append(engine.loss_scale)
        if ovf:
            kept = kept and all(torch.equal(a, b) for a, b in
                                zip(before, state(engine)[:-4]))
        else:
            trained.append((i, loss))
        del before
        if len(trained) == 6:
            break
    want_scales = reference_scale(2.0 ** 32, flags)
    # the trained steps' losses on the first trained step's batch fall
    same = [x for j, x in trained if trained and j % 2 == trained[0][0] % 2]
    falls = len(trained) == 6 and \
        all(math.isfinite(x) for _, x in trained) and same[-1] < same[0]
    counts16 = fl.launch_counts(torch.float16)
    emit({"phase": "train_fp16_overflow", "initial_scale": 2.0 ** 32,
          "steps": len(flags), "skipped": sum(flags),
          "overflow_flags": flags, "loss_scales": scales,
          "reference_scales": want_scales, "skipped_state_bit_equal": kept,
          "trained_losses": [x for _, x in trained],
          "resume_equal": resumed, "losses_after_save": want,
          "losses_after_resume": got, "launches_fp16": counts16,
          "phase_s": round(time.monotonic() - t_phase, 3)})
    del engine
    torch.cuda.empty_cache()
    if not (flags[0] and kept and scales == want_scales and falls and
            resumed):
        fail(f"phase 8f: first step overflowed {flags[0]}, skipped state "
             f"kept {kept}, scales follow the rule "
             f"{scales == want_scales}, then trained {falls}, resume "
             f"equal {resumed}")
    return counts16


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is visible; this script runs on the card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import deepspeed_tpu_torch
    except ImportError as e:
        fail(f"the deepspeed_tpu_torch package is not beside this script "
             f"({e})")
    from deepspeed_tpu_torch.models.llama import Llama, llama2_7b
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.attention import decode as dec
    from deepspeed_tpu_torch.ops.attention import flash as fl
    from deepspeed_tpu_torch.ops.quant import kernels as qk
    from deepspeed_tpu_torch.ops.quant import quantizer as tq

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gpu, power = [s.strip() for s in smi.split(",")]
    emit({"gpu": gpu, "power_limit": power,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.monotonic()
    logs = op_builder.build_all()
    ptxas = ptxas_usage(logs)
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "ops": sorted(logs), "ptxas": ptxas})
    # the decode kernel (paged and dense walk) and int8_matmul: no spill
    decode_ptxas = {walk: [e for e in ptxas
                           if "decode_kernel" in e["kernel"] and
                           walk in e["kernel"]]
                    for walk in ("PagedWalk", "DenseWalk")}
    emit({"phase": "ptxas_paged_decode",
          "instantiations": decode_ptxas["PagedWalk"]})
    emit({"phase": "ptxas_dense_decode",
          "instantiations": decode_ptxas["DenseWalk"]})
    int8_ptxas = [e for e in ptxas if "int8_matmul_kernel" in e["kernel"]]
    emit({"phase": "ptxas_int8_matmul", "instantiations": int8_ptxas})
    checked = decode_ptxas["PagedWalk"] + decode_ptxas["DenseWalk"] + \
        int8_ptxas
    spilled = [e["kernel"] for e in checked
               if "0 bytes spill stores, 0 bytes spill loads" not in
               e["spill"]]
    # the fp16 instantiations: mangled names carry __half ("6__half")
    half = {k: [e for e in v if "6__half" in e["kernel"]]
            for k, v in (("paged", decode_ptxas["PagedWalk"]),
                         ("dense", decode_ptxas["DenseWalk"]),
                         ("int8", int8_ptxas))}
    if not all((decode_ptxas["PagedWalk"], decode_ptxas["DenseWalk"],
                int8_ptxas, *half.values())) or spilled:
        fail(f"a decode or int8_matmul instantiation spills (or none was "
             f"built, fp16 included: "
             f"{ {k: len(v) for k, v in half.items()} }): {spilled}")
    fwd_ptxas = [e for e in ptxas if "flash_fwd_wgmma_kernel" in e["kernel"]]
    emit({"phase": "ptxas_flash_fwd", "instantiations": fwd_ptxas})
    spilled = [e["kernel"] for e in fwd_ptxas
               if "0 bytes spill stores, 0 bytes spill loads" not in
               e["spill"]]
    n_half = sum("6__half" in e["kernel"] for e in fwd_ptxas)
    if len(fwd_ptxas) != 12 or n_half != 6 or spilled:
        fail(f"the bf16 / fp16 flash forward spills (or not all 12 of its "
             f"instantiations, 6 fp16, were built): {spilled}, "
             f"{len(fwd_ptxas)} built, {n_half} fp16")
    # the bf16 and fp16 backward pair: dq and dkv kernels, d 32 / 64 /
    # 128, dense and sparse walk
    bwd_ptxas = [e for e in ptxas
                 if "flash_bwd_dq_wgmma_kernel" in e["kernel"] or
                 "flash_bwd_dkv_wgmma_kernel" in e["kernel"]]
    emit({"phase": "ptxas_flash_bwd", "instantiations": bwd_ptxas})
    spilled = [e["kernel"] for e in bwd_ptxas
               if "0 bytes spill stores, 0 bytes spill loads" not in
               e["spill"]]
    n_half = sum("6__half" in e["kernel"] for e in bwd_ptxas)
    if len(bwd_ptxas) != 24 or n_half != 12 or spilled:
        fail(f"the bf16 / fp16 flash backward spills (or not all 24 of its "
             f"instantiations, 12 fp16, were built): {spilled}, "
             f"{len(bwd_ptxas)} built, {n_half} fp16")

    # ---- kernel phase: the serving path's shapes
    serve_pos = [0, 7, 100, 231]          # ragged: 0, mid-page, 200+ tokens
    long_pos = [1023 - 29 * i for i in range(32)]    # 32 slots x ~1024
    long_cases = (("llama2-7b 32 slots x 1024", 32, 32, 128),
                  ("llama2-70b heads (GQA 64/8) 32 slots x 1024", 64, 8,
                   128),
                  ("falcon-7b heads (MQA 71/1) 32 slots x 1024", 71, 1, 64))
    results = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        results[("paged", dn)] = paged_case(
            torch, dec, "llama2-7b serve batch", 32, 32, 128, 16, serve_pos,
            dtype, rotations=8, seed=1)
        paged_case(torch, dec, "llama2-70b heads (GQA 64/8)", 64, 8, 128,
                   16, serve_pos, dtype, rotations=8, seed=2)
        for i, (name, h, kv_h, d) in enumerate(long_cases):
            paged_case(torch, dec, name, h, kv_h, d, 16, long_pos, dtype,
                       rotations=2, seed=3 + 10 * i)
        results[("dense", dn)] = dense_case(
            torch, dec, "llama2-7b generate cache", 1, 32, 32, 128, 256,
            [215], dtype, rotations=8, seed=4)
        results[("dense_8x1024", dn)] = dense_case(
            torch, dec, "llama2-7b batch 8 x 1024", 8, 32, 32, 128, 1024,
            [1023 - 100 * i for i in range(8)], dtype, rotations=2, seed=5)
        results[("dense_200", dn)] = dense_case(
            torch, dec, "llama2-7b max_len 200", 4, 32, 32, 128, 200,
            [0, 63, 150, 199], dtype, rotations=8, seed=7)
        results[("dense_mqa", dn)] = dense_case(
            torch, dec, "falcon-7b heads (MQA 71/1) generate cache", 1, 71,
            1, 64, 256, [215], dtype, rotations=8, seed=6)
        for kv_name in ("int8", "fp8"):
            results[("paged_quant", kv_name, dn)] = paged_case(
                torch, dec, "llama2-7b serve batch", 32, 32, 128, 16,
                serve_pos, dtype, rotations=8, seed=1, kv_name=kv_name)
            results[("paged_quant_gqa", kv_name, dn)] = paged_case(
                torch, dec, "llama2-70b heads (GQA 64/8)", 64, 8, 128, 16,
                serve_pos, dtype, rotations=8, seed=2, kv_name=kv_name)
            for i, (name, h, kv_h, d) in enumerate(long_cases):
                paged_case(torch, dec, name, h, kv_h, d, 16, long_pos,
                           dtype, rotations=2, seed=3 + 10 * i,
                           kv_name=kv_name)
    torch.cuda.empty_cache()

    # ---- int8_matmul kernel phase: the Llama-2-7B projections
    batch_invariance(torch, qk, tq, seed=6)
    batch_invariance(torch, qk, tq, seed=6, dtype_name="bfloat16")
    batch_invariance(torch, qk, tq, seed=6, dtype_name="float16")
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for k, n in ((4096, 4096), (4096, 11008), (11008, 4096),
                     (4096, 32000)):
            for m in (4, 64, 1):
                results[("int8_matmul", dn, m, k, n)] = int8_matmul_case(
                    torch, qk, tq, m, k, n, 64, dtype, rotations=4,
                    seed=7 + m)
            torch.cuda.empty_cache()

    # ---- flash kernel phase: the training path's shapes
    flash_results = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for name, b, lq, lk, h, d, causal in (
                ("a gpt2-small train", 8, 1024, 1024, 12, 64, True),
                ("b long tiled", 1, 4096, 4096, 12, 64, True),
                ("c offset q512/k1024", 2, 512, 1024, 12, 64, True),
                ("d non-causal", 2, 1024, 1024, 12, 64, False),
                ("e llama2-7b heads", 1, 2048, 2048, 32, 128, True)):
            flash_results[(name[0], dn)] = flash_case(
                torch, fl, name, b, lq, lk, h, d, causal, dtype,
                rotations=2, seed=10 + ord(name[0]))
            torch.cuda.empty_cache()

    # ---- block-sparse kernel phase, then the block-sparse slice
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.attention import block_sparse as bs
    sparse_results = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        if dtype == torch.float16:
            bs.reset_launch_counts()     # the fp16 pass's own launches
        for i, (name, cfg, causal) in enumerate(sparse_kernel_configs(sa)):
            sparse_results[(name, dn)] = sparse_case(
                torch, bs, fl, name, cfg, causal, dtype, rotations=2,
                seed=40 + i)
            torch.cuda.empty_cache()
        if dtype == torch.float16:
            sparse_fp16 = bs.launch_counts(torch.float16)
    sparse_counts = sparse_attention_phase(torch, sa, bs, fl, args.seed)
    torch.cuda.empty_cache()

    # ---- serve phase, fp32 (the token-exact oracle run)
    dec.reset_launch_counts()
    t0 = time.monotonic()
    model = Llama(llama2_7b(), device="cuda")
    engine = deepspeed_tpu_torch.init_inference(
        model, dtype="float32", kv_cache_dtype="float32",
        max_out_tokens=512)
    engine.init_params(args.seed)
    build_s = time.monotonic() - t0
    prompts, max_new = make_requests(args.seed, model.cfg.vocab_size)
    sched_kwargs = dict(num_slots=4, num_pages=64, page_size=16,
                        max_pages_per_slot=16, prefill_chunk=64,
                        decode_horizon_steps=8)
    logits = engine.forward(prompts[0][None])
    if logits.shape != (1, len(prompts[0]), model.cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        fail(f"forward logits bad: shape {tuple(logits.shape)}")
    want = []
    t0 = time.monotonic()
    for p, m in zip(prompts, max_new):
        out = engine.generate(p[None], max_new_tokens=m)
        want.append([int(t) for t in out[0, len(p):]])
    gen_s = time.monotonic() - t0
    got32, sched32, wall32 = serve(torch, engine, prompts, max_new,
                                   sched_kwargs)
    exact = [g == w for g, w in zip(got32, want)]
    emit({"phase": "serve_fp32", "model": "llama2-7b", "layers": 32,
          "params": sum(p.numel() for p in model.parameters()),
          "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
          "max_new": max_new, "slots": sched_kwargs["num_slots"],
          "model_build_s": round(build_s, 3), "generate_s": round(gen_s, 3),
          "serve_s": round(wall32, 3),
          "preemptions": sched32.metrics.preemptions,
          "captures": sched32.captures,
          "horizon_buckets": sched32.horizon_buckets,
          "capture_s": round(engine.serving_decode_multi_capture_seconds(),
                             3),
          "chained_horizons": sum(sched32.chains),
          "token_exact_vs_generate": exact})
    if not engine.cuda_graphs or not sum(sched32.chains):
        fail(f"fp32 serve: graphs {engine.cuda_graphs}, "
             f"{sum(sched32.chains)} chained horizons")
    if not all(exact):
        for i, (g, w) in enumerate(zip(got32, want)):
            if g != w:
                emit({"mismatch": i, "serve": g, "generate": w})
        fail("fp32 serving is not token-exact against generate()")

    # ---- speculative decoding, fp32, while phase 5's engine lives
    motif, motif_new = motif_requests(args.seed, model.cfg.vocab_size)
    serve_spec_fp32(torch, deepspeed_tpu_torch, engine, model, prompts,
                    max_new, want, motif, motif_new, sched_kwargs, args.seed)

    # ---- prefix cache and decoding policies, fp32, on the same engine
    f_counts = serve_prefix_and_policy_fp32(
        torch, dec, engine, prompts, max_new, want, motif, motif_new,
        sched_kwargs, args.seed)

    # ---- serve phase, bf16 (the same module, cast in place): the eager
    # twin, then one graph scheduler twice (the second run is steady)
    engine = deepspeed_tpu_torch.init_inference(
        model, dtype="bfloat16", kv_cache_dtype="bfloat16",
        max_out_tokens=512)
    eager = deepspeed_tpu_torch.init_inference(
        model, dtype="bfloat16", kv_cache_dtype="bfloat16",
        max_out_tokens=512, enable_cuda_graph=False)
    got16, first16, _, runs, sched16 = graph_and_eager(
        torch, engine, eager, prompts, max_new, sched_kwargs)
    emit({"phase": "serve_bf16", **runs["graph_steady"], **runs,
          "agreement_with_fp32": agreement(got16, got32)})
    motif16, _, _ = serve(torch, engine, motif, motif_new, sched_kwargs)
    spec_against_plain(torch, engine, motif + prompts, motif_new + max_new,
                       motif16 + got16, sched_kwargs, "serve_bf16_spec")
    bf16_policy = policy_beside_greedy(torch, dec, engine, prompts, max_new,
                                       sched_kwargs, "serve_bf16_policy")
    if bf16_policy["paged_decode_fwd"] <= 0:
        fail(f"bf16 policy serve launches {bf16_policy}")
    counts = dec.launch_counts()
    del engine, eager, sched32, sched16, logits
    torch.cuda.empty_cache()

    # ---- quantized serve phases (6b-6d), each with its own counts
    got_q, q_counts = serve_quantized(
        torch, deepspeed_tpu_torch, dec, model, prompts, max_new, motif,
        motif_new, sched_kwargs, got32, args.seed)
    got_q32, q32_counts = serve_int8_fp32(
        torch, deepspeed_tpu_torch, dec, model, prompts, max_new,
        sched_kwargs, args.seed)
    emit({"phase": "quantized_agreement",
          "int8_fp32_vs_float_fp32": agreement(got_q32, got32),
          "int8_bf16_int8kv_vs_int8_fp32": agreement(got_q, got_q32)})
    del model
    torch.cuda.empty_cache()
    grouped_float, grouped_quant = serve_grouped(
        torch, deepspeed_tpu_torch, dec, args.seed)
    torch.cuda.empty_cache()

    # ---- GPT-2 family serving (6g): row 1 and row 3 at its heads, then
    # its configurations served, with the phase's own launch counts
    family_kernels = gpt2_family_kernels(torch, dec)
    torch.cuda.empty_cache()
    g_counts = serve_gpt2_family(torch, deepspeed_tpu_torch, dec, qk,
                                 args.seed, sched_kwargs)
    torch.cuda.empty_cache()

    # ---- HF ingestion (6h): two directories written here, ingested and
    # served, with the phase's own launch counts
    with tempfile.TemporaryDirectory() as workdir:
        h_counts = hf_ingest(torch, deepspeed_tpu_torch, dec, qk, args.seed,
                             sched_kwargs, smi, workdir)
    torch.cuda.empty_cache()

    # ---- fp16 serving (6i): Llama-2-7B at full depth, fp16 over int8,
    # OPT-125m, BLOOM-560m, an fp16 HF directory; the float16 launches
    with tempfile.TemporaryDirectory() as workdir:
        i_counts, i_grouped = serve_fp16(
            torch, deepspeed_tpu_torch, dec, qk, args.seed, prompts, max_new,
            sched_kwargs, smi, workdir)
    torch.cuda.empty_cache()

    # ---- train phases: the fp32 oracle, then the bf16 main path, then
    # checkpoints of that engine (8b, with the phase's own flash counts)
    train_oracle(torch, fl, deepspeed_tpu_torch, args.seed)
    torch.cuda.empty_cache()
    fl.reset_launch_counts()
    bf16_line, engine8, config8, data8 = train_bf16(
        torch, deepspeed_tpu_torch, args.seed)
    counts.update(fl.launch_counts())
    with tempfile.TemporaryDirectory() as workdir:
        c_counts = train_checkpoints(torch, deepspeed_tpu_torch, fl, engine8,
                                     config8, data8, args.seed, smi, workdir)
    del engine8, data8
    torch.cuda.empty_cache()
    # ---- fp16 training (8f), with the phase's float16 flash launches
    with tempfile.TemporaryDirectory() as workdir:
        f16_counts = train_fp16(torch, deepspeed_tpu_torch, fl, args.seed,
                                bf16_line, smi, workdir)
    torch.cuda.empty_cache()

    kernels = []
    for name, key, source, replaces in (
            ("paged_decode_fwd", "paged",
             "deepspeed_tpu_torch/ops/attention/csrc/decode_attention.cu",
             "deepspeed_tpu/ops/attention/decode.py:471"),
            ("decode_fwd", "dense",
             "deepspeed_tpu_torch/ops/attention/csrc/decode_attention.cu",
             "deepspeed_tpu/ops/attention/decode.py:104")):
        r = results[(key, "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    kernels[0]["also_replaces"] = "deepspeed_tpu/ops/attention/decode.py:411"
    kernels[1]["mqa_71_1_ms"] = results[("dense_mqa", "bfloat16")]["kernel_ms"]
    kernels[1]["batch_8x1024_ms"] = \
        results[("dense_8x1024", "bfloat16")]["kernel_ms"]
    kernels[1]["max_len_200_ms"] = \
        results[("dense_200", "bfloat16")]["kernel_ms"]
    kernels[0]["launches_group_8_serve"] = grouped_float
    # launches in phase 6f: prefix caching and the policy bodies (fp32 and
    # bf16); decode_fwd through generate(), the oracle
    kernels[0]["launches_6f"] = f_counts["paged_decode_fwd"] + \
        bf16_policy["paged_decode_fwd"]
    kernels[1]["launches_6f"] = f_counts["decode_fwd"]
    # the quantized paged kernel: group 1 over the 7B quantized serve
    # phases, group 8 over the grouped serve; int8 pools, bf16 compute
    source = "deepspeed_tpu_torch/ops/attention/csrc/decode_attention.cu"
    for key, label, launches, replaces in (
            ("paged_quant", "paged_decode_quant_fwd",
             q_counts["paged_decode_quant_fwd"],
             "deepspeed_tpu/ops/attention/decode.py:471 (quantized body "
             ":171)"),
            ("paged_quant_gqa", "paged_decode_quant_fwd (group 8)",
             grouped_quant,
             "deepspeed_tpu/ops/attention/decode.py:411 (quantized=True)")):
        r = results[(key, "int8", "bfloat16")]
        r8 = results[(key, "fp8", "bfloat16")]
        kernels.append({
            "name": label, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"], r8["max_abs_err"]),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "fp8_ms": r8["kernel_ms"]})
    kernels[2]["launches_6f"] = f_counts["paged_decode_quant_fwd"] + \
        q_counts["policy"]["paged_decode_quant_fwd"]
    # phase 6g: the GPT-2 family's launches, and row 1 / row 3 at its
    # heads (bf16): GPT-2 small 12 x 64 without and with ALiBi, BLOOM-560m
    # 16 x 64 with ALiBi, GPT-J 16 x 256 (float and int8 pools for row 3)
    for i, name in ((0, "paged_decode_fwd"), (1, "decode_fwd"),
                    (2, "paged_decode_quant_fwd")):
        kernels[i]["launches_6g"] = g_counts[name]
    for key in ("gpt2", "gpt2_alibi", "bloom_alibi", "gptj_d256"):
        kernels[1][f"{key}_heads_ms"] = \
            family_kernels[(key, "bfloat16")]["kernel_ms"]
    kernels[0]["gptj_d256_ms"] = \
        family_kernels[("gptj_paged", None, "bfloat16")]["kernel_ms"]
    kernels[2]["gptj_d256_ms"] = \
        family_kernels[("gptj_paged", "int8", "bfloat16")]["kernel_ms"]
    # int8_matmul_fwd at the decode shape of the 7B serve phase (m = 4
    # slots, k = n = 4096, bf16); no single PyTorch call computes the
    # quantized function, so library_ms is null and the float layer's
    # F.linear time stands beside it
    r = results[("int8_matmul", "bfloat16", 4, 4096, 4096)]
    kernels.append({
        "name": "int8_matmul_fwd", "route": "cuda",
        "source": "deepspeed_tpu_torch/ops/quant/csrc/int8_matmul.cu",
        "replaces": "deepspeed_tpu/ops/quant/kernels.py:122",
        "launches": q_counts["int8_matmul_fwd"] +
        q32_counts["int8_matmul_fwd"],
        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "float_linear_ms": r["float_linear_ms"],
        "launches_6f": q_counts["policy"]["int8_matmul_fwd"],
        "launches_6g": g_counts["int8_matmul_fwd"]})
    # the flash kernels at shape (a), bf16: the train phase's shape; the
    # plain and SDPA times of the backward cover the pair (dq, dk, dv)
    r = flash_results[("a", "bfloat16")]
    source = "deepspeed_tpu_torch/ops/attention/csrc/flash_attention.cu"

    def bwd_by_shape(key):
        # one kernel of the pair per bf16 shape; SDPA's backward and the
        # pair's (the whole flash_bwd) time cover dq, dk and dv
        return {k_[0]: {"ms": f["ms"][key], "bound_ms": f["bound_ms"][key],
                        "pair_ms": f["ms"]["bwd"],
                        "sdpa_bwd_ms": f["sdpa_bwd_ms"]}
                for k_, f in flash_results.items() if k_[1] == "bfloat16"}
    for name, key, errs, replaces, extra in (
            ("flash_fwd", "fwd", ("o", "lse"),
             "deepspeed_tpu/ops/attention/flash.py:242",
             {"also_replaces": "deepspeed_tpu/ops/attention/flash.py:260",
              "by_shape": {
                  key[0]: {"ms": f["ms"]["fwd"],
                           "sdpa_ms": f["ms"]["sdpa_fwd"],
                           "bound_ms": f["bound_ms"]["fwd"]}
                  for key, f in flash_results.items()
                  if key[1] == "bfloat16"}}),
            ("flash_bwd_dq", "bwd_dq", ("dq",),
             "deepspeed_tpu/ops/attention/flash.py:463",
             {"also_replaces": "deepspeed_tpu/ops/attention/flash.py:442 "
              "(with flash_bwd_dkv)", "by_shape": bwd_by_shape("bwd_dq")}),
            ("flash_bwd_dkv", "bwd_dkv", ("dk", "dv"),
             "deepspeed_tpu/ops/attention/flash.py:479",
             {"also_replaces": "deepspeed_tpu/ops/attention/flash.py:442 "
              "(with flash_bwd_dq)", "by_shape": bwd_by_shape("bwd_dkv")})):
        fwd = key == "fwd"
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"][e] for e in errs),
            "ms": r["ms"][key],
            "plain_ms": r["ms"]["plain_fwd" if fwd else "plain_bwd"],
            "bound_ms": r["bound_ms"][key], "bound_by": r["bound_by"][key],
            "library_ms": r["ms"]["sdpa_fwd"] if fwd else r["sdpa_bwd_ms"],
            **extra})
        if not fwd:
            kernels[-1]["plain_and_library_cover"] = "dq, dk and dv"
    # the block-sparse kernels at BigBird bidirectional, block 128, bf16,
    # b 1 l 4096 h 12 d 64 (phase 4b); launches over phase 4c
    r = sparse_results[("bigbird", "bfloat16")]
    source = "deepspeed_tpu_torch/ops/attention/csrc/block_sparse.cu"
    for name, key, errs, replaces in (
            ("sparse_fwd", "fwd", ("o", "lse"),
             "deepspeed_tpu/ops/attention/block_sparse.py:203"),
            ("sparse_bwd_dq", "bwd_dq", ("dq",),
             "deepspeed_tpu/ops/attention/block_sparse.py:338"),
            ("sparse_bwd_dkv", "bwd_dkv", ("dk", "dv"),
             "deepspeed_tpu/ops/attention/block_sparse.py:365")):
        fwd = key == "fwd"
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sparse_counts[name],
            "max_abs_err": max(r["max_abs_err"][e] for e in errs),
            "ms": r["ms"][key],
            "plain_ms": r["ms"]["plain_fwd" if fwd else "plain_bwd"],
            "bound_ms": r["bound_ms"][key], "bound_by": r["bound_by"][key],
            "library_ms": r["ms"]["sdpa_fwd"] if fwd else r["sdpa_bwd_ms"]})
        if not fwd:
            kernels[-1]["plain_and_library_cover"] = "dq, dk and dv"
    # phases 6h (HF ingestion) and 8b (checkpoints): their own launches
    for k in kernels:
        if k["name"] in h_counts:
            k["launches_6h"] = h_counts[k["name"]]
        if k["name"] in c_counts:
            k["launches_8b"] = c_counts[k["name"]]
    # float16: each row's fp16 numbers beside its bf16 ones (the same
    # shape, so the same bound bytes), and its fp16 launches: rows 1-3q
    # and 12 in phase 6i, rows 4-8 in 8f, rows 9-11 in 4b's fp16 pass
    def decode_fp16(r):
        return {"ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "library_ms": r.get("library_ms"), "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "max_abs_err": r["max_abs_err"]}

    def tiled_fp16(r, key, errs):
        fwd = key == "fwd"
        return {"ms": r["ms"][key],
                "plain_ms": r["ms"]["plain_fwd" if fwd else "plain_bwd"],
                "library_ms": r["ms"]["sdpa_fwd"] if fwd
                else r["sdpa_bwd_ms"],
                "bound_ms": r["bound_ms"][key],
                "bound_by": r["bound_by"][key],
                "max_abs_err": max(r["max_abs_err"][e] for e in errs)}
    r16 = results[("int8_matmul", "float16", 4, 4096, 4096)]
    fp16 = {
        "paged_decode_fwd": (decode_fp16(results[("paged", "float16")]),
                             i_counts["paged_decode_fwd"]),
        "decode_fwd": (decode_fp16(results[("dense", "float16")]),
                       i_counts["decode_fwd"]),
        "paged_decode_quant_fwd": (
            decode_fp16(results[("paged_quant", "int8", "float16")]),
            i_counts["paged_decode_quant_fwd"]),
        "paged_decode_quant_fwd (group 8)": (
            decode_fp16(results[("paged_quant_gqa", "int8", "float16")]),
            i_grouped[1]),
        "int8_matmul_fwd": (dict(decode_fp16(r16), library_ms=None,
                                 float_linear_ms=r16["float_linear_ms"]),
                            i_counts["int8_matmul_fwd"])}
    for name, key, errs in (("flash_fwd", "fwd", ("o", "lse")),
                            ("flash_bwd_dq", "bwd_dq", ("dq",)),
                            ("flash_bwd_dkv", "bwd_dkv", ("dk", "dv"))):
        fp16[name] = (tiled_fp16(flash_results[("a", "float16")], key, errs),
                      f16_counts[name])
        sparse = "sparse" + name[len("flash"):]
        fp16[sparse] = (tiled_fp16(sparse_results[("bigbird", "float16")],
                                   key, errs), sparse_fp16[sparse])
    for k in kernels:
        k["fp16"], k["launches_fp16"] = fp16[k["name"]]
    kernels[0]["launches_fp16_group_8"] = i_grouped[0]
    emit({"kernels": kernels})
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    missing += [f"{k['name']} (fp16)" for k in kernels
                if k["launches_fp16"] <= 0]
    if i_grouped[0] <= 0:
        missing.append("paged_decode_fwd (fp16, group 8)")
    missing += [f"{k['name']} (8b)" for k in kernels
                if k.get("launches_8b", 1) <= 0]
    if grouped_float <= 0:
        missing.append("paged_decode_fwd (group 8)")
    if missing:
        fail(f"kernels never launched on their main paths: "
             f"{missing}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
