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
@pytest.mark.parametrize("h,kv_h", [(4, 4), (4, 2), (8, 2)])
def test_paged_decode_matches_jax_kernel(h, kv_h, ps):
    args = _paged_inputs(0, 4, h, kv_h, 16, ps, 3, 10)
    want = jdec.paged_decode_attention(*map(jnp.asarray, args),
                                       force_kernel=True)
    got = tdec.paged_decode_attention(*map(torch.from_numpy, args))
    assert got.shape == (4, 1, h, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("h,kv_h", [(4, 4), (4, 2)])
def test_dense_decode_matches_jax_kernel(h, kv_h):
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
    (dict(num_heads=64, num_kv_heads=2, head_dim=16), "group"),
    (dict(num_heads=4, num_kv_heads=2, head_dim=12), "head_dim"),
    (dict(num_heads=4, num_kv_heads=2, head_dim=512), "head_dim"),
    (dict(num_heads=4, num_kv_heads=2, head_dim=16,
          dtype=torch.float16), "dtype"),
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


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("h,kv_h,d,ps", [(32, 32, 128, 16), (64, 8, 128, 16),
                                         (4, 2, 64, 8), (8, 8, 40, 32),
                                         (16, 1, 256, 16)])
def test_paged_kernel_matches_plain_on_card(cuda, h, kv_h, d, ps, dtype,
                                            atol):
    slots, maxp, num_pages = 5, 9, 40
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(slots, 1, h, d, device=cuda, generator=g).to(dtype)
    kp = torch.randn(num_pages, ps, kv_h, d, device=cuda,
                     generator=g).to(dtype)
    vp = torch.randn(num_pages, ps, kv_h, d, device=cuda,
                     generator=g).to(dtype)
    pt = torch.randint(0, num_pages, (slots, maxp), device=cuda,
                       generator=g, dtype=torch.int32)
    pos = torch.tensor([0, ps // 2, ps, 3 * ps + 5, maxp * ps - 1],
                       device=cuda, dtype=torch.int32)
    before = tdec.launch_counts()["paged_decode_fwd"]
    got = tdec.paged_decode_attention(q, kp, vp, pt, pos)
    torch.cuda.synchronize()
    assert tdec.launch_counts()["paged_decode_fwd"] == before + 1
    want = tdec.paged_decode_attention_plain(q, kp, vp, pt, pos)
    assert (got.float() - want.float()).abs().max().item() < atol


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
