"""The GPT-2 family's kernel launches on the card: ``decode_fwd`` (row 1)
with an ALiBi bias at GPT-2 small and BLOOM-560m heads and at GPT-J's
head_dim 256, ``paged_decode_fwd`` (row 3) at head_dim 256, ALiBi over
pools through the gathered pages and ``decode_fwd`` (never a paged
kernel, never the plain version), and a BLOOM-like tiny model served
with CUDA graphs token-exact against its own ``generate()``.  Every
kernel is held against its plain PyTorch version: fp32 atol 1e-4, bf16
3e-2 (relative above magnitude 1), the tolerances of ``chip_smoke.py``.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; run them on the card with ``python -m pytest
tests/test_torch_gpt2_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.attention import decode as tdec
from deepspeed_tpu_torch.ops.quant import kv as kvq
from deepspeed_tpu_torch.serving import ServingScheduler

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


def _err(got, want):
    return ((got.float() - want.float()).abs() /
            want.float().abs().clamp_min(1)).max().item()


def _alibi(h, k_len, device):
    return tgpt2.alibi_slopes(h).to(device)[None, :, None, None] * \
        torch.arange(k_len, device=device)[None, None, None, :]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d,alibi", [(12, 64, False), (12, 64, True),
                                       (16, 64, True), (16, 256, False),
                                       (16, 256, True)])
def test_decode_fwd_with_alibi_and_d256(cuda, h, d, alibi, dtype):
    b, max_len = 3, 384
    g = torch.Generator(device=cuda).manual_seed(h + d)
    q = torch.randn(b, 1, h, d, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(b, max_len, h, d, generator=g,
                        device=cuda).to(dtype) for _ in range(2))
    pos = torch.tensor([0, 130, 383], device=cuda)
    bias = torch.where(torch.arange(max_len, device=cuda)[None, :] <=
                       pos[:, None], 0.0, torch.finfo(torch.float32).min)
    bias = bias[:, None, None, :]
    if alibi:
        bias = bias + _alibi(h, max_len, cuda)
    tdec.reset_launch_counts()
    got = tdec.decode_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert tdec.launch_counts()["decode_fwd"] == 1
    want = tdec.decode_attention_plain(q, k, v, bias=bias)
    assert _err(got, want) < TOL[dtype]


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_at_head_dim_256(cuda, dtype, kv):
    """GPT-J heads (16 of 256) over float and int8 pools of 16-row pages,
    positions across page and split boundaries."""
    h, d, ps, positions = 16, 256, 16, [0, 15, 64, 200]
    slots, maxp = len(positions), max(positions) // ps + 1
    num_pages = slots * maxp + 1
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(slots, 1, h, d, generator=g, device=cuda).to(dtype)
    kp, vp = (torch.randn(num_pages, ps, h, d, generator=g,
                          device=cuda).to(dtype) for _ in range(2))
    scales = {}
    if kv:
        kp, scales["k_scale"] = kvq.quantize_kv_rows(kp, kv)
        vp, scales["v_scale"] = kvq.quantize_kv_rows(vp, kv)
    pt = (1 + torch.randperm(num_pages - 1, generator=g, device=cuda)[
        :slots * maxp]).reshape(slots, maxp).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    tdec.reset_launch_counts()
    got = tdec.paged_decode_attention(q, kp, vp, pt, pos, **scales)
    torch.cuda.synchronize()
    name = "paged_decode_quant_fwd" if kv else "paged_decode_fwd"
    assert tdec.launch_counts()[name] == 1
    want = tdec.paged_decode_attention_plain(q, kp, vp, pt, pos, **scales)
    assert _err(got, want) < TOL[dtype]


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alibi_over_pools_launches_decode_fwd(cuda, dtype, kv):
    """BLOOM-560m heads (16 of 64): the bias sends the call to the
    gathered pages and ``decode_fwd``; no paged kernel launches."""
    h, d, ps, positions = 16, 64, 16, [3, 40, 127, 90]
    slots, maxp = len(positions), 8
    num_pages = slots * maxp + 1
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(slots, 1, h, d, generator=g, device=cuda).to(dtype)
    kp, vp = (torch.randn(num_pages, ps, h, d, generator=g,
                          device=cuda).to(dtype) for _ in range(2))
    scales = {}
    if kv:
        kp, scales["k_scale"] = kvq.quantize_kv_rows(kp, kv)
        vp, scales["v_scale"] = kvq.quantize_kv_rows(vp, kv)
    pt = torch.arange(slots * maxp, device=cuda,
                      dtype=torch.int32).reshape(slots, maxp)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    alibi = _alibi(h, maxp * ps, cuda)
    tdec.reset_launch_counts()
    got = tdec.paged_decode_attention(q, kp, vp, pt, pos, bias=alibi,
                                      **scales)
    torch.cuda.synchronize()
    assert tdec.launch_counts() == {"paged_decode_fwd": 0,
                                    "paged_decode_quant_fwd": 0,
                                    "decode_fwd": 1}
    want = tdec.paged_decode_attention_plain(q, kp, vp, pt, pos, bias=alibi,
                                             **scales)
    assert _err(got, want) < TOL[dtype]


def test_bloom_like_serving_with_graphs_equals_generate(cuda):
    """A BLOOM-like tiny model (ALiBi, embedding LayerNorm; heads of 32)
    served with CUDA graphs and overlap is token-exact against its own
    ``generate()`` in fp32; the paged decode ran ``decode_fwd`` and no
    paged kernel."""
    cfg = tgpt2.gpt2_tiny(hidden_size=128, pos_embed="none", use_alibi=True,
                          embed_layernorm=True)
    eng = deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(cfg, device=cuda), dtype="float32",
        kv_cache_dtype="float32", max_out_tokens=128).init_params(0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 30, 17)]
    max_new = [12, 9, 14]
    want = [[int(t) for t in eng.generate(p[None], max_new_tokens=m)[
        0, len(p):]] for p, m in zip(prompts, max_new)]
    sched = ServingScheduler(eng, num_slots=2, num_pages=16, page_size=8,
                             max_pages_per_slot=8, prefill_chunk=8)
    tdec.reset_launch_counts()
    reqs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_new)]
    got = sched.run()
    counts = tdec.launch_counts()
    assert [got[r.rid] for r in reqs] == want
    assert eng.cuda_graphs and eng.serving_decode_multi_capture_count() > 0
    assert counts["decode_fwd"] > 0
    assert counts["paged_decode_fwd"] == counts["paged_decode_quant_fwd"] \
        == 0
    assert sched.kv.pool.pages_in_use == 0


def test_bloom_like_policy_and_prefix_graphs(cuda):
    """The other graph bodies over a GPT-2-family module: sampled requests
    (the policy bodies) give the same streams on two schedulers, and a
    prefix-cache scheduler whose hits copy a partly matched page
    (``copy_page``) serves the greedy requests token-exact against
    ``generate()``."""
    cfg = tgpt2.gpt2_tiny(hidden_size=128, pos_embed="none", use_alibi=True,
                          embed_layernorm=True)
    eng = deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(cfg, device=cuda), dtype="float32",
        kv_cache_dtype="float32", max_out_tokens=128).init_params(1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (9, 21)]
    sampled = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.95)
    streams = []
    for _ in range(2):
        sched = ServingScheduler(eng, num_slots=2, num_pages=16,
                                 page_size=8, max_pages_per_slot=8,
                                 prefill_chunk=8)
        reqs = [sched.submit(p, max_new_tokens=12, sampling=sampled,
                             seed=7 + i) for i, p in enumerate(prompts)]
        got = sched.run()
        streams.append([got[r.rid] for r in reqs])
    assert streams[0] == streams[1]
    assert eng.serving_capture_count("decode_multi_policy") > 0
    prefix = rng.integers(0, 256, 20).astype(np.int32)
    shared = [np.concatenate([prefix, t]) for t in
              (rng.integers(0, 256, 6), rng.integers(0, 256, 3))]
    want = [[int(t) for t in eng.generate(p[None], max_new_tokens=8)[
        0, len(p):]] for p in shared]
    sched = ServingScheduler(eng, num_slots=2, num_pages=16, page_size=8,
                             max_pages_per_slot=8, prefill_chunk=8,
                             prefix_cache=True)
    got = []
    for p in shared:
        r = sched.submit(p, max_new_tokens=8)
        got.append(sched.run()[r.rid])
    assert got == want
    s = sched.summary()
    assert s["prefix_hits"] > 0
    assert eng.serving_page_copy_capture_count() >= 1
