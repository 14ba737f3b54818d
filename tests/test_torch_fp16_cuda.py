"""The float16 instantiations of every hand-written kernel on the card,
and float16 serving and training through them.

Each kernel is held against its plain PyTorch version at float16: the
paged decode kernels over float16, int8 and fp8 pools (MHA and GQA), the
dense walk ``decode_fwd`` with and without ALiBi up to head_dim 256,
``int8_matmul_fwd`` on the tensor-core and the FMA paths and with a
ragged n, the flash forward and backward pair at head_dim 32 / 64 / 128,
and the block-sparse kernels.  Tolerance 4e-3 (absolute, relative above
magnitude 1), ``chip_smoke.py``'s ``TOL["float16"]``: float16 rounds at
2^-11 where bf16 rounds at 2^-8, so bf16's 3e-2 scaled by 1/8.  Then a
float16 Llama engine serves through graphs token-exact against its own
``generate()`` with float16 kernels launched, and an fp16 GPT-2 engine
trains through the flash kernels, skipping a forced overflow with its
state bit for bit.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; run them on the card with ``python -m pytest
tests/test_torch_fp16_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.llama import Llama, llama_tiny
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.attention import block_sparse as tbs
from deepspeed_tpu_torch.ops.attention import decode as tdec
from deepspeed_tpu_torch.ops.attention import flash as tflash
from deepspeed_tpu_torch.ops.quant import kernels as tkern
from deepspeed_tpu_torch.ops.quant import kv as kvq
from deepspeed_tpu_torch.ops.quant import quantizer as tq
from deepspeed_tpu_torch.serving import ServingScheduler

F16 = torch.float16
TOL = 4e-3

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


def _randn(g, *shape, device):
    return torch.randn(*shape, generator=g, device=device).to(F16)


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
@pytest.mark.parametrize("h,kv_h,d", [(32, 32, 128), (64, 8, 128),
                                      (12, 12, 64)])
def test_paged_decode_fp16(cuda, h, kv_h, d, kv):
    g = torch.Generator(device=cuda).manual_seed(h + d)
    ps, positions = 16, [0, 7, 100, 231]
    slots, maxp = len(positions), 231 // 16 + 1
    n_pages = slots * maxp + 1
    q = _randn(g, slots, 1, h, d, device=cuda)
    kp, vp = (_randn(g, n_pages, ps, kv_h, d, device=cuda) for _ in range(2))
    pt = torch.randperm(n_pages, generator=g, device=cuda)[
        :slots * maxp].reshape(slots, maxp).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    scales = {}
    if kv is not None:
        kp, scales["k_scale"] = kvq.quantize_kv_rows(kp, kv)
        vp, scales["v_scale"] = kvq.quantize_kv_rows(vp, kv)
    tdec.reset_launch_counts()
    got = tdec.paged_decode_attention(q, kp, vp, pt, pos, **scales)
    want = tdec.paged_decode_attention_plain(q, kp, vp, pt, pos, **scales)
    torch.cuda.synchronize()
    assert got.dtype == F16 and _err(got, want) < TOL
    name = "paged_decode_quant_fwd" if kv else "paged_decode_fwd"
    assert tdec.launch_counts(F16)[name] == 1


@pytest.mark.parametrize("h,kv_h,d,alibi", [(32, 32, 128, False),
                                            (16, 16, 64, True),
                                            (71, 1, 64, False),
                                            (16, 16, 256, True)])
def test_dense_decode_fp16(cuda, h, kv_h, d, alibi):
    g = torch.Generator(device=cuda).manual_seed(h * d)
    b, max_len = 3, 200
    q = _randn(g, b, 1, h, d, device=cuda)
    k, v = (_randn(g, b, max_len, kv_h, d, device=cuda) for _ in range(2))
    pos = torch.tensor([0, 63, 199], device=cuda)
    bias = torch.where(torch.arange(max_len, device=cuda)[None, :] <=
                       pos[:, None], 0.0, torch.finfo(torch.float32).min)
    bias = bias[:, None, None, :]
    if alibi:
        bias = bias + tgpt2.alibi_slopes(h).to(cuda)[None, :, None, None] * \
            torch.arange(max_len, device=cuda)[None, None, None, :]
    tdec.reset_launch_counts()
    got = tdec.decode_attention(q, k, v, bias=bias)
    want = tdec.decode_attention_plain(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert _err(got, want) < TOL
    assert tdec.launch_counts(F16)["decode_fwd"] == 1


@pytest.mark.parametrize("m,k,n,group", [(1, 4096, 4096, 64),
                                         (4, 4096, 11008, 64),
                                         (64, 11008, 4096, 64),
                                         (4, 512, 1000, 64),
                                         (4, 512, 512, 8)])
def test_int8_matmul_fp16(cuda, m, k, n, group):
    g = torch.Generator(device=cuda).manual_seed(m + n)
    x = _randn(g, m, k, device=cuda)
    w = torch.randn(k, n, generator=g, device=cuda) * 0.02
    q, scale = tq.quantize(w.to(F16), group_size=group)
    tkern.reset_launch_counts()
    got = tkern.int8_matmul(x, q, scale)
    want = tkern.int8_matmul_plain(x, q, scale)
    torch.cuda.synchronize()
    assert got.dtype == F16 and _err(got, want) < TOL
    assert tkern.launch_counts(F16)["int8_matmul_fwd"] == 1
    # batch invariance: a row alone equals the row in the batch
    row = tkern.int8_matmul(x[:1].contiguous(), q, scale)
    assert torch.equal(row, got[:1])


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("lq,lk,causal", [(256, 256, True),
                                          (200, 328, True),
                                          (192, 192, False)])
def test_flash_fp16(cuda, d, lq, lk, causal):
    g = torch.Generator(device=cuda).manual_seed(d + lq)
    b, h = 2, 4
    q, do = (_randn(g, b, lq, h, d, device=cuda) for _ in range(2))
    k, v = (_randn(g, b, lk, h, d, device=cuda) for _ in range(2))
    tflash.reset_launch_counts()
    o, lse = tflash.flash_fwd(q, k, v, causal=causal)
    o_p, lse_p = tflash.flash_fwd_plain(q, k, v, causal=causal)
    grads = tflash.flash_bwd(q, k, v, o_p, lse_p, do, causal=causal)
    grads_p = tflash.flash_bwd_plain(q, k, v, o_p, lse_p, do, causal=causal)
    torch.cuda.synchronize()
    live = lse_p > tflash.NEG_INF / 2
    assert _err(o, o_p) < TOL and _err(lse[live], lse_p[live]) < TOL
    for got, want in zip(grads, grads_p):
        assert got.dtype == F16 and _err(got, want) < TOL
    assert tflash.launch_counts(F16) == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                         "flash_bwd_dkv": 1}


def test_block_sparse_fp16(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    L, h, d, block = 1024, 4, 64, 64
    cfg = sa.BigBirdSparsityConfig(h, block=block, num_random_blocks=1,
                                   num_sliding_window_blocks=3,
                                   num_global_blocks=1)
    layout = np.asarray(cfg.make_layout(L))
    index = tbs.SparseIndex(layout, block=block)
    layout_t = torch.as_tensor(layout, device=cuda)
    q, k, v, do = (_randn(g, 1, L, h, d, device=cuda) for _ in range(4))
    tbs.reset_launch_counts()
    o, lse = tbs.sparse_fwd(q, k, v, index, causal=False)
    o_p, lse_p = tbs.sparse_fwd_plain(q, k, v, layout_t, block=block,
                                      causal=False)
    grads = tbs.sparse_bwd(q, k, v, o_p, lse_p, do, index, causal=False)
    grads_p = tbs.sparse_bwd_plain(q, k, v, o_p, lse_p, do, layout_t,
                                   block=block, causal=False)
    torch.cuda.synchronize()
    assert _err(o, o_p) < TOL
    for got, want in zip(grads, grads_p):
        assert _err(got, want) < TOL
    assert all(n == 1 for n in tbs.launch_counts(F16).values())


@pytest.mark.parametrize("kv", ["float16", "int8"])
def test_fp16_llama_serves_through_graphs(cuda, kv):
    eng = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny(), device="cuda"), dtype="float16",
        kv_cache_dtype=kv)
    eng.init_params(0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 19, 9)]
    tdec.reset_launch_counts()
    sched = ServingScheduler(eng, num_slots=2, num_pages=12, page_size=8,
                             max_pages_per_slot=6, prefill_chunk=8)
    reqs = [sched.submit(p, max_new_tokens=8) for p in prompts]
    got = sched.run()
    name = "paged_decode_fwd" if kv == "float16" else "paged_decode_quant_fwd"
    assert tdec.launch_counts(F16)[name] > 0 and eng.cuda_graphs
    runs = [got[r.rid] for r in reqs]
    if kv == "float16":
        assert runs == [[int(t) for t in eng.generate(p[None],
                                                      max_new_tokens=8)[
            0, len(p):]] for p in prompts]
        assert tdec.launch_counts(F16)["decode_fwd"] > 0
    else:
        again = ServingScheduler(eng, num_slots=2, num_pages=12,
                                 page_size=8, max_pages_per_slot=6,
                                 prefill_chunk=8)
        reqs2 = [again.submit(p, max_new_tokens=8) for p in prompts]
        got2 = again.run()
        assert runs == [got2[r.rid] for r in reqs2]


def test_fp16_training_skips_a_forced_overflow(cuda):
    def loss_fn(module, batch):
        return tgpt2.gpt2_loss_fn(module(batch["input_ids"]), batch) * \
            batch["factor"][0]

    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "gradient_clipping": 1.0, "fp16": {"enabled": True}}
    eng = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2(tgpt2.gpt2_tiny(dtype="float16", attn_impl="flash",
                                         hidden_size=128, num_heads=2)),
        config=config, loss_fn=loss_fn)[0]
    rng = np.random.default_rng(0)
    tflash.reset_launch_counts()
    losses = []
    for i, factor in enumerate([1.0, 1.0, float("inf"), 1.0]):
        batch = {"input_ids": rng.integers(0, 256, (2, 128)),
                 "factor": np.full((2,), factor, np.float32)}
        before = [p.detach().clone() for p in eng.module.parameters()] + \
            [m.clone() for m in eng.optimizer.mu + eng.optimizer.nu]
        losses.append(eng.train_batch(batches=[batch]))
        after = list(eng.module.parameters()) + \
            eng.optimizer.mu + eng.optimizer.nu
        same = all(torch.equal(a, b) for a, b in zip(before, after))
        assert same == (i == 2) == bool(eng._last_metrics["overflow"])
    assert eng.skipped_steps == 1 and int(eng.optimizer.count) == 3
    assert eng.loss_scale == 65536.0
    assert np.isfinite([losses[i] for i in (0, 1, 3)]).all()
    counts = tflash.launch_counts(F16)
    assert all(n > 0 for n in counts.values()), counts
