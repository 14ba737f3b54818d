"""Decode-attention parity of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode (``force_kernel=True``),
the way ``tests/unit/test_serving.py`` runs them.  Inputs are made with
numpy from a seed and handed to both.  Tolerance: atol 1e-5 in fp32
(the two sum the same products in different orders).

Tests marked ``cuda`` hold the hand-written kernels against the plain
versions on the card and skip where there is none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import decode as jdec
from deepspeed_tpu_torch.ops.attention import decode as tdec
from deepspeed_tpu_torch.ops.attention.reference import (
    apply_rotary_emb, mha_reference)

ATOL = 1e-5


def _paged_inputs(seed, slots, h, kv_h, d, ps, maxp, num_pages):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(slots, 1, h, d)).astype(np.float32)
    kp = rng.normal(size=(num_pages, ps, kv_h, d)).astype(np.float32)
    vp = rng.normal(size=(num_pages, ps, kv_h, d)).astype(np.float32)
    pt = rng.integers(0, num_pages, (slots, maxp)).astype(np.int32)
    # position 0, mid-page, a page boundary, and the full table
    pos = np.array([0, ps // 2 + 1, ps, ps * maxp - 1][:slots], np.int32)
    return q, kp, vp, pt, pos


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("h,kv_h", [(4, 4), (4, 2), (8, 2), (32, 1),
                                    (64, 2), (64, 1)])
def test_paged_decode_matches_jax_kernel(h, kv_h, ps):
    """MHA, GQA up to group 32 and MQA (kv_heads 1, group 32 and 64): every
    group the CUDA kernels take, against the JAX GQA kernel."""
    args = _paged_inputs(0, 4, h, kv_h, 16, ps, 3, 10)
    want = jdec.paged_decode_attention(*map(jnp.asarray, args),
                                       force_kernel=True)
    got = tdec.paged_decode_attention(*map(torch.from_numpy, args))
    assert got.shape == (4, 1, h, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("h,kv_h", [(4, 4), (4, 2), (64, 2), (8, 1)])
def test_dense_decode_matches_jax_kernel(h, kv_h):
    """MHA, GQA, group 32 (two of the CUDA kernel's 16-head tiles) and
    MQA, against the JAX kernel, which takes every group."""
    rng = np.random.default_rng(1)
    b, d, max_len = 2, 16, 128
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(b, max_len, kv_h, d)).astype(np.float32)
    v = rng.normal(size=(b, max_len, kv_h, d)).astype(np.float32)
    pos = np.array([5, 100])
    mask = np.where(np.arange(max_len)[None, :] <= pos[:, None], 0.0,
                    np.finfo(np.float32).min).astype(np.float32)
    # the validity mask plus a per-head additive term (ALiBi-like)
    bias = (mask[:, None, None, :] +
            0.1 * rng.normal(size=(b, h, 1, max_len))).astype(np.float32)
    for bi in (mask[:, None, None, :], bias):
        want = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), bias=jnp.asarray(bi),
                                     force_kernel=True)
        got = tdec.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                    bias=torch.from_numpy(bi))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_multi_token_decode_attention_matches_jax():
    """Several query tokens (prefill into a cache) take the plain path
    on every device, as in the JAX package."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(1, 5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 32, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 32, 2, 16)).astype(np.float32)
    pos = np.arange(3, 8)
    bias = np.where(np.arange(32)[None, :] <= pos[:, None], 0.0,
                    np.finfo(np.float32).min)[None, None].astype(np.float32)
    want = jdec.decode_attention(*map(jnp.asarray, (q, k, v)),
                                 bias=jnp.asarray(bias))
    got = tdec.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_reference_ops_match_jax():
    from deepspeed_tpu.ops.attention import reference as jref
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = (np.arange(7)[None, :] + np.array([[0], [40]])).astype(np.int32)
    np.testing.assert_allclose(
        apply_rotary_emb(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jref.apply_rotary_emb(jnp.asarray(x), jnp.asarray(pos))),
        atol=ATOL)
    q, k, v = (rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
               for _ in range(3))
    np.testing.assert_allclose(
        mha_reference(*map(torch.from_numpy, (q, k, v))).numpy(),
        np.asarray(jref.mha_reference(*map(jnp.asarray, (q, k, v)))),
        atol=ATOL)


def test_gather_and_repeat_kv_match_jax():
    rng = np.random.default_rng(4)
    pages = rng.normal(size=(6, 4, 2, 8)).astype(np.float32)
    pt = rng.integers(0, 6, (3, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        tdec.gather_pages(torch.from_numpy(pages),
                          torch.from_numpy(pt).long()).numpy(),
        np.asarray(jdec.gather_pages(jnp.asarray(pages), jnp.asarray(pt))))
    x = rng.normal(size=(2, 5, 2, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tdec._repeat_kv(torch.from_numpy(x), 3).numpy(),
        np.asarray(jdec._repeat_kv(jnp.asarray(x), 3)))


def test_cpu_tensors_take_the_plain_version_without_launching():
    tdec.reset_launch_counts()
    args = _paged_inputs(5, 2, 4, 2, 16, 8, 2, 4)
    tdec.paged_decode_attention(*map(torch.from_numpy, args))
    assert tdec.launch_counts() == {"paged_decode_fwd": 0,
                                    "paged_decode_quant_fwd": 0,
                                    "decode_fwd": 0}
    dec = tdec.paged_kernel_decision(device_type="cpu", num_heads=4,
                                     num_kv_heads=2, head_dim=16)
    assert dec["path"] == "reference"


@pytest.mark.parametrize("kw,needle", [
    (dict(num_heads=6, num_kv_heads=4, head_dim=16), "multiple"),
    (dict(num_heads=4, num_kv_heads=2, head_dim=12), "head_dim"),
    (dict(num_heads=4, num_kv_heads=2, head_dim=512), "head_dim"),
    (dict(num_heads=4, num_kv_heads=2, head_dim=16,
          dtype=torch.float64), "dtype"),
])
def test_cuda_decision_refuses_what_the_kernel_does_not_take(kw, needle):
    """On a CUDA tensor the rule is kernel or refusal — never the plain
    version."""
    dec = tdec.paged_kernel_decision(device_type="cuda", **kw)
    assert dec["path"] == "unsupported" and needle in dec["reason"]
    ok = tdec.paged_kernel_decision(device_type="cuda", num_heads=64,
                                    num_kv_heads=8, head_dim=128,
                                    dtype=torch.bfloat16)
    assert ok["path"] == "kernel"


@pytest.mark.parametrize("kw", [
    dict(num_heads=64, num_kv_heads=2, dtype=torch.bfloat16),     # group 32
    dict(num_heads=64, num_kv_heads=1, dtype=torch.float32),      # MQA
    dict(num_heads=64, num_kv_heads=4, dtype=torch.bfloat16,
         storage_dtype=torch.int8),                               # group 16
    dict(num_heads=32, num_kv_heads=1, dtype=torch.bfloat16,
         storage_dtype=torch.int8),                               # MQA int8
])
def test_cuda_decision_takes_every_group(kw):
    """No group ceiling: the paged kernels tile the group in 16-row
    tiles, so every group the JAX kernel takes runs on the card."""
    dec = tdec.paged_kernel_decision(device_type="cuda", head_dim=128, **kw)
    assert dec["path"] == "kernel", dec


@pytest.mark.parametrize("ps", [1, 8, 16, 24, 32, 100, 128, 512])
def test_split_is_whole_pages_and_at_most_max_splits(ps):
    """A split holds at least SPLIT_KEYS keys in whole pages, a slot has
    at most MAX_SPLITS of them, and no smaller split would do."""
    for max_pages in (1, 7, 16, 64, 513):
        pps = tdec.pages_per_split(ps, max_pages)
        n_splits = -(-max_pages // pps)
        assert pps * ps >= tdec.SPLIT_KEYS and n_splits <= tdec.MAX_SPLITS
        assert (pps - 1) * ps < tdec.SPLIT_KEYS or \
            -(-max_pages // (pps - 1)) > tdec.MAX_SPLITS


@pytest.mark.parametrize("max_len", [1, 63, 64, 65, 150, 200, 256, 1024,
                                     4096, 4097, 100000])
def test_dense_split_is_whole_tiles_from_max_len_alone(max_len):
    """The dense walk's split: whole SPLIT_KEYS-key tiles, at most
    MAX_SPLITS of them, the smallest such, and a function of max_len
    alone (the signature takes nothing else: not the batch, the bias or
    a position)."""
    sk = tdec.dense_split_keys(max_len)
    n_splits = -(-max_len // sk)
    assert sk % tdec.SPLIT_KEYS == 0 and 1 <= n_splits <= tdec.MAX_SPLITS
    assert sk == tdec.SPLIT_KEYS or \
        -(-max_len // (sk - tdec.SPLIT_KEYS)) > tdec.MAX_SPLITS
    import inspect
    assert list(inspect.signature(tdec.dense_split_keys).parameters) == \
        ["max_len"]


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


def split_positions(ps, maxp):
    """Positions around the first split boundary of the paged kernels
    (one key short of a full split, a full split, one key into the
    second), position 0, the table's last key and one past the table
    (clamped)."""
    sk = tdec.pages_per_split(ps, maxp) * ps
    assert maxp * ps > sk + 1
    return [0, sk - 2, sk - 1, sk, maxp * ps - 1, maxp * ps + 7]


def poisoned_paged_inputs(cuda, h, kv_h, d, ps, dtype, seed=0):
    """q, pools, a page table and positions on the card, plus the pools
    with page 0 set to NaN: live keys never use page 0, and every table
    entry past a slot's position is 0 (unallocated), so a kernel that
    reads past the position returns NaN."""
    maxp = 3 * -(-tdec.SPLIT_KEYS // ps) + 1
    pos = split_positions(ps, maxp)
    slots, num_pages = len(pos), len(pos) * maxp + 1
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(slots, 1, h, d, device=cuda, generator=g).to(dtype)
    kp, vp = (torch.randn(num_pages, ps, kv_h, d, device=cuda,
                          generator=g).to(dtype) for _ in range(2))
    pt = (1 + torch.randperm(num_pages - 1, device=cuda, generator=g)[
        :slots * maxp]).reshape(slots, maxp).to(torch.int32)
    for i, p in enumerate(pos):
        pt[i, p // ps + 1:] = 0
    pos = torch.tensor(pos, device=cuda, dtype=torch.int32)
    kp_nan, vp_nan = kp.clone(), vp.clone()
    kp_nan[0] = float("nan")
    vp_nan[0] = float("nan")
    return q, (kp, vp), (kp_nan, vp_nan), pt, pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("h,kv_h,d,ps", [
    (32, 32, 128, 16),     # group 1 (Llama-2-7B heads)
    (4, 2, 64, 8),         # group 2
    (64, 8, 128, 16),      # group 8 (Llama-2-70B heads)
    (32, 2, 128, 32),      # group 16
    (64, 2, 64, 16),       # group 32: two 16-row tiles
    (64, 1, 128, 16),      # MQA
    (8, 8, 40, 32),        # head_dim 40: padded to the mma depth
    (24, 2, 256, 8),       # group 12, head_dim 256
    (16, 1, 256, 16)])
def test_paged_kernel_matches_plain_on_card(cuda, h, kv_h, d, ps, dtype,
                                            atol):
    q, pools, poisoned, pt, pos = poisoned_paged_inputs(cuda, h, kv_h, d,
                                                        ps, dtype)
    before = tdec.launch_counts()["paged_decode_fwd"]
    got = tdec.paged_decode_attention(q, *poisoned, pt, pos)
    torch.cuda.synchronize()
    assert tdec.launch_counts()["paged_decode_fwd"] == before + 1
    want = tdec.paged_decode_attention_plain(q, *pools, pt, pos)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() < atol


@pytest.mark.cuda
@pytest.mark.parametrize("kv_name", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv_h", [(32, 32), (64, 8), (64, 1)])
def test_paged_kernel_is_batch_invariant_on_card(cuda, h, kv_h, dtype,
                                                 kv_name):
    """A slot's output is the same bits alone and inside a 32-slot batch,
    and two runs are bit-equal: splits are merged in a fixed order and no
    sum is taken with atomics."""
    from deepspeed_tpu_torch.ops.quant import kv as tkv
    d, ps, maxp, slots = 128, 16, 72, 32
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(slots, 1, h, d, device=cuda, generator=g).to(dtype)
    kp, vp = (torch.randn(slots * maxp, ps, kv_h, d, device=cuda,
                          generator=g) for _ in range(2))
    scales = {}
    if kv_name is None:
        kp, vp = kp.to(dtype), vp.to(dtype)
    else:
        kp, scales["k_scale"] = tkv.quantize_kv_rows(kp, kv_name)
        vp, scales["v_scale"] = tkv.quantize_kv_rows(vp, kv_name)
    pt = torch.randperm(slots * maxp, device=cuda, generator=g).reshape(
        slots, maxp).to(torch.int32)
    pos = torch.randint(0, maxp * ps, (slots,), device=cuda, generator=g,
                        dtype=torch.int32)
    sk = tdec.pages_per_split(ps, maxp) * ps
    pos[:3] = torch.tensor([0, sk - 1, sk], dtype=torch.int32)
    full = tdec.paged_decode_attention(q, kp, vp, pt, pos, **scales)
    assert torch.equal(full, tdec.paged_decode_attention(q, kp, vp, pt, pos,
                                                         **scales))
    for i in (0, 1, 2, 5, 31):
        alone = tdec.paged_decode_attention(
            q[i:i + 1].contiguous(), kp, vp, pt[i:i + 1].contiguous(),
            pos[i:i + 1].contiguous(), **scales)
        assert torch.equal(alone[0], full[i]), i
    want = tdec.paged_decode_attention_plain(q, kp, vp, pt, pos, **scales)
    atol = 1e-4 if dtype == torch.float32 else 3e-2
    assert (full.float() - want.float()).abs().max().item() < atol


@pytest.mark.cuda
@pytest.mark.parametrize("kv_name", [None, "int8"])
def test_paged_kernel_graph_replay_equals_eager_on_card(cuda, kv_name):
    """The host never reads the positions: a CUDA graph captured once
    replays the same bits as the eager call, after new positions too."""
    from deepspeed_tpu_torch.ops.quant import kv as tkv
    q, pools, _, pt, pos = poisoned_paged_inputs(cuda, 64, 8, 128, 16,
                                                 torch.bfloat16, seed=3)
    kp, vp = pools
    scales = {}
    if kv_name is not None:
        kp, scales["k_scale"] = tkv.quantize_kv_rows(kp.float(), kv_name)
        vp, scales["v_scale"] = tkv.quantize_kv_rows(vp.float(), kv_name)
    name = "paged_decode_quant_fwd" if scales else "paged_decode_fwd"
    eager = tdec.paged_decode_attention(q, kp, vp, pt, pos, **scales)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tdec.paged_decode_attention(q, kp, vp, pt, pos, **scales)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tdec.paged_decode_attention(q, kp, vp, pt, pos, **scales)
    before = tdec.launch_counts()[name]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    pos.copy_(pos.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, tdec.paged_decode_attention(q, kp, vp, pt, pos,
                                                        **scales))
    assert tdec.launch_counts()[name] == before + 1   # replays: no wrapper


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("h,kv_h,d", [
    (32, 1, 64),       # group 32: two 16-head tiles
    (71, 1, 64),       # Falcon-7B MQA: five tiles, the last of 7 heads
    (64, 2, 128)])     # group 32 over two kv heads
def test_dense_kernel_takes_every_group_on_card(cuda, h, kv_h, d, dtype,
                                                atol):
    """No group ceiling: a group above 16 is tiled over the grid, each
    tile reading its query heads' rows of q, the bias and the output."""
    b, max_len = 3, 256
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(b, 1, h, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, max_len, kv_h, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, max_len, kv_h, d, device=cuda, generator=g).to(dtype)
    pos = torch.tensor([0, 130, 255], device=cuda)
    mask = torch.where(torch.arange(max_len, device=cuda)[None] <=
                       pos[:, None], 0.0, torch.finfo(torch.float32).min)
    for bias in (mask[:, None, None, :],
                 mask[:, None, None, :] + 0.1 * torch.randn(
                     b, h, 1, max_len, device=cuda, generator=g)):
        before = tdec.launch_counts()["decode_fwd"]
        got = tdec.decode_attention(q, k, v, bias=bias)
        want = tdec.decode_attention_plain(q, k, v, bias=bias)
        torch.cuda.synchronize()
        assert tdec.launch_counts()["decode_fwd"] == before + 1
        assert (got.float() - want.float()).abs().max().item() < atol


@pytest.mark.cuda
def test_mqa_generate_on_card_equals_cpu(cuda):
    """generate() of an MQA Llama (32 query heads over one kv head) runs
    the dense decode kernel on the card and gives the CPU run's tokens,
    in fp32."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import Llama, llama_tiny
    cfg = dict(num_heads=32, num_kv_heads=1, hidden_size=1024)
    cpu = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny(**cfg)), dtype="float32", kv_cache_dtype="float32",
        device="cpu")
    cpu.init_params(0)
    card = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny(**cfg)), dtype="float32", kv_cache_dtype="float32",
        device="cuda")
    card.set_params({k: v for k, v in cpu.module.state_dict().items()})
    ids = np.random.default_rng(5).integers(0, 256, (2, 9))
    tdec.reset_launch_counts()
    got = card.generate(ids, max_new_tokens=12)
    assert tdec.launch_counts()["decode_fwd"] > 0
    np.testing.assert_array_equal(got, cpu.generate(ids, max_new_tokens=12))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("h,kv_h", [(32, 32), (8, 2)])
def test_dense_kernel_matches_plain_on_card(cuda, h, kv_h, dtype, atol):
    b, d, max_len = 3, 128, 256
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(b, 1, h, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, max_len, kv_h, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, max_len, kv_h, d, device=cuda, generator=g).to(dtype)
    pos = torch.tensor([0, 77, 255], device=cuda)
    mask = torch.where(torch.arange(max_len, device=cuda)[None] <=
                       pos[:, None], 0.0, torch.finfo(torch.float32).min)
    for bias in (mask[:, None, None, :],
                 mask[:, None, None, :] + 0.1 * torch.randn(
                     b, h, 1, max_len, device=cuda, generator=g)):
        got = tdec.decode_attention(q, k, v, bias=bias)
        want = tdec.decode_attention_plain(q, k, v, bias=bias)
        assert (got.float() - want.float()).abs().max().item() < atol


def dense_inputs(cuda, b, h, kv_h, d, max_len, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, 1, h, d, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(b, max_len, kv_h, d, device=cuda,
                        generator=g).to(dtype) for _ in range(2))
    return q, k, v, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("max_len", [1, 63, 150, 200, 1024, 4096])
def test_dense_kernel_every_max_len_on_card(cuda, max_len, dtype, atol):
    """Any max_len runs: a last tile cut short, one to four splits; a
    broadcast bias and a per-head one.  Sequence 2 is fully masked: the
    kernel, like the TPU kernel, writes zeros there (a dead row), where
    the plain softmax spreads evenly over the masked keys."""
    b, h, kv_h, d = 3, 32, 8, 128
    q, k, v, g = dense_inputs(cuda, b, h, kv_h, d, max_len, dtype, seed=7)
    pos = torch.tensor([0, max_len - 1, -1], device=cuda)
    mask = torch.where(torch.arange(max_len, device=cuda)[None] <=
                       pos[:, None], 0.0, torch.finfo(torch.float32).min)
    for bias in (mask[:, None, None, :],
                 mask[:, None, None, :] + 0.5 * torch.randn(
                     b, h, 1, max_len, device=cuda, generator=g)):
        before = tdec.launch_counts()["decode_fwd"]
        got = tdec.decode_attention(q, k, v, bias=bias)
        torch.cuda.synchronize()
        assert tdec.launch_counts()["decode_fwd"] == before + 1
        want = tdec.decode_attention_plain(q, k, v, bias=bias)
        assert torch.isfinite(got).all()
        assert (got[:2].float() - want[:2].float()).abs().max().item() < atol
        assert torch.equal(got[2], torch.zeros_like(got[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv_h,d,max_len", [(32, 32, 128, 256),
                                              (71, 1, 64, 1024)])
def test_dense_kernel_is_batch_invariant_on_card(cuda, h, kv_h, d, max_len,
                                                 dtype):
    """Row i of a b = 3 call equals the b = 1 call of that sequence bit for
    bit, and two runs are bit-equal: the split comes from max_len alone
    and the splits merge in a fixed order."""
    q, k, v, g = dense_inputs(cuda, 3, h, kv_h, d, max_len, dtype, seed=8)
    bias = torch.where(torch.arange(max_len, device=cuda)[None] <=
                       torch.tensor([5, max_len // 2, max_len - 1],
                                    device=cuda)[:, None], 0.0,
                       torch.finfo(torch.float32).min)[:, None, None, :]
    full = tdec.decode_attention(q, k, v, bias=bias)
    assert torch.equal(full, tdec.decode_attention(q, k, v, bias=bias))
    for i in range(3):
        alone = tdec.decode_attention(
            q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
            v[i:i + 1].contiguous(), bias=bias[i:i + 1])
        assert torch.equal(alone[0], full[i]), i


@pytest.mark.cuda
def test_dense_kernel_graph_replay_equals_eager_on_card(cuda):
    """The host reads nothing of the bias or the cache: a CUDA graph
    captured once replays the eager call's bits, after a new bias too."""
    q, k, v, g = dense_inputs(cuda, 2, 32, 8, 128, 200, torch.bfloat16,
                              seed=9)
    pos = torch.tensor([17, 199], device=cuda)
    bias = torch.where(torch.arange(200, device=cuda)[None] <=
                       pos[:, None], 0.0, torch.finfo(torch.float32).min)
    bias = bias[:, None, None, :].contiguous()
    eager = tdec.decode_attention(q, k, v, bias=bias)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tdec.decode_attention(q, k, v, bias=bias)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tdec.decode_attention(q, k, v, bias=bias)
    before = tdec.launch_counts()["decode_fwd"]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    bias.copy_(bias.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, tdec.decode_attention(q, k, v, bias=bias))
    assert tdec.launch_counts()["decode_fwd"] == before + 1  # no wrapper
