"""Flash-attention parity of the PyTorch port against the JAX package.

On the CPU the port's ``flash_attention`` runs its plain versions through
the same ``autograd.Function`` that launches the kernels on the card; the
JAX side runs its Pallas kernels in interpret mode, as
``tests/unit/ops/test_flash_attention.py`` does, and its custom VJP
through ``jax.vjp`` with a random output cotangent (and a random lse
cotangent where ``with_lse`` is on).  Inputs are made with numpy from a
seed and handed to both.

Tolerances: atol 2e-5 on o, lse, dq, dk and dv in fp32 (the same
products summed in other orders, over at most 512 keys); atol 2e-2 in
bf16 (operands and p rounded to bf16 at the same points on both sides,
the roundings of the outputs differ by an ulp).  Tests marked ``cuda``
hold the kernels against the plain versions on the card at 1e-4 (fp32)
and 3e-2 (bf16), and skip where there is none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import flash as jflash
from deepspeed_tpu_torch.ops.attention import flash as tflash

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, lq, lk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, lk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, lk, h, d)).astype(np.float32)
    do = rng.normal(size=(b, lq, h, d)).astype(np.float32)
    dlse = rng.normal(size=(b, h, lq)).astype(np.float32)
    return q, k, v, do, dlse


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(
        x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _jax_side(q, k, v, do, dlse, *, causal, block, with_lse, dtype):
    def f(q_, k_, v_):
        return jflash.flash_attention(q_, k_, v_, causal=causal,
                                      block_q=block, block_k=block,
                                      with_lse=True)
    args = [jnp.asarray(x, JNP[dtype]) for x in (q, k, v)]
    (o, lse), vjp = jax.vjp(f, *args)
    cot_lse = jnp.asarray(dlse) if with_lse else jnp.zeros_like(lse)
    grads = vjp((jnp.asarray(do, JNP[dtype]), cot_lse))
    return (o, lse) + tuple(grads)


def _port_side(q, k, v, do, dlse, *, causal, with_lse, dtype):
    ts = [torch.tensor(x, dtype=TORCH[dtype], requires_grad=True)
          for x in (q, k, v)]
    o, lse = tflash.flash_attention(*ts, causal=causal, with_lse=True)
    cots = [torch.tensor(do, dtype=TORCH[dtype])]
    outs = [o]
    if with_lse:
        outs.append(lse)
        cots.append(torch.tensor(dlse))
    torch.autograd.backward(outs, cots)
    return (o, lse) + tuple(t.grad for t in ts)


# (name, lq, lk, causal, block, with_lse, dtype): block is the JAX
# kernel's tiling, which decides the Pallas kernel the JAX side runs
CASES = [
    # row 4 (+ row 6 chunked): whole-sequence causal block, 2 column chunks
    ("row4_1blk_causal_chunked", 512, 512, True, None, False, "float32"),
    # rows 5, 7, 8: the tiled forward and the dq / dkv backward pair
    ("rows578_tiled_causal", 256, 256, True, 128, False, "float32"),
    # row 6 with one chunk: the fused single-block backward
    ("row6_fused_1chunk", 128, 128, True, None, False, "float32"),
    ("non_causal_tiled", 256, 256, False, 128, False, "float32"),
    # causal offset k_len - q_len = 128 > 0
    ("causal_offset", 128, 256, True, 128, False, "float32"),
    # the lse cotangent folded into delta, tiled and fused
    ("lse_cotangent_tiled", 256, 256, True, 128, True, "float32"),
    ("lse_cotangent_fused", 128, 128, True, None, True, "float32"),
    ("bf16_tiled", 256, 256, True, 128, True, "bfloat16"),
    # q_len > k_len causal: the first 128 query rows see no key
    ("fully_masked_rows", 256, 128, True, 128, True, "float32"),
]


@pytest.mark.parametrize("name,lq,lk,causal,block,with_lse,dtype", CASES,
                         ids=[c[0] for c in CASES])
def test_flash_matches_jax_pallas(name, lq, lk, causal, block, with_lse,
                                  dtype):
    inputs = _inputs(sum(map(ord, name)), 1, lq, lk, 2, 16)
    want = _jax_side(*inputs, causal=causal, block=block, with_lse=with_lse,
                     dtype=dtype)
    got = _port_side(*inputs, causal=causal, with_lse=with_lse, dtype=dtype)
    for label, w, g in zip(("o", "lse", "dq", "dk", "dv"), want, got):
        assert g.shape == w.shape, label
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL[dtype],
                                   err_msg=label)
    if name == "fully_masked_rows":
        o, lse, dq = (_np(x) for x in got[:3])
        dead = lq - lk
        assert not o[:, :dead].any() and not dq[:, :dead].any()
        assert (lse[:, :, :dead] == tflash.NEG_INF).all()


def test_flash_attention_with_lse_on_bh_layout_matches_jax():
    q, k, v, do, dlse = _inputs(7, 1, 128, 128, 3, 16)
    to3 = [np.ascontiguousarray(x[0].transpose(1, 0, 2))
           for x in (q, k, v, do)]
    dl3 = dlse[0][..., None]

    def f(q_, k_, v_):
        return jflash.flash_attention_with_lse(q_, k_, v_, causal=True,
                                               scale=0.25, block=128)
    (o, lse), vjp = jax.vjp(f, *map(jnp.asarray, to3[:3]))
    want = (o, lse) + tuple(vjp((jnp.asarray(to3[3]), jnp.asarray(dl3))))
    ts = [torch.tensor(x, requires_grad=True) for x in to3[:3]]
    to, tl = tflash.flash_attention_with_lse(*ts, causal=True, scale=0.25)
    torch.autograd.backward([to, tl], [torch.tensor(to3[3]),
                                       torch.tensor(dl3)])
    for w, g in zip(want, (to, tl) + tuple(t.grad for t in ts)):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL["float32"])


def test_plain_versions_agree_with_the_autograd_function():
    """flash_fwd_plain / flash_bwd_plain are the functions the wrappers
    run on the CPU; their backward equals autograd through the plain
    forward (the gradient of o and of lse)."""
    q, k, v, do, dlse = (torch.from_numpy(x) for x in
                         _inputs(3, 2, 40, 70, 2, 8))
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = tflash.flash_fwd_plain(*ts, causal=True, scale=0.3)
    torch.autograd.backward([o, lse], [do, dlse])
    o2, lse2 = tflash.flash_fwd_plain(q, k, v, causal=True, scale=0.3)
    grads = tflash.flash_bwd_plain(q, k, v, o2, lse2, do, dlse, causal=True,
                                   scale=0.3)
    for want, got in zip((t.grad for t in ts), grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_cpu_tensors_take_the_plain_versions_without_launching():
    tflash.reset_launch_counts()
    q, k, v, do, dlse = (torch.from_numpy(x) for x in
                         _inputs(4, 1, 64, 64, 2, 16))
    q.requires_grad_()
    tflash.flash_attention(q, k, v).sum().backward()
    assert tflash.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                      "flash_bwd_dkv": 0}


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (CPU tensors take the plain versions, "
                    "tested above)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,lq,lk,h,d,causal", [
    (2, 200, 200, 3, 64, True), (1, 100, 300, 2, 64, True),
    (1, 300, 100, 2, 32, True), (1, 129, 257, 2, 128, False),
    (1, 512, 1024, 4, 128, True)])
def test_kernels_match_plain_versions_on_the_card(cuda, b, lq, lk, h, d,
                                                  causal, dtype):
    tol = {"float32": 1e-4, "bfloat16": 3e-2}[dtype]
    q, k, v, do, dlse = (torch.from_numpy(x).to(cuda) for x in
                         _inputs(5, b, lq, lk, h, d))
    q, k, v, do = (x.to(TORCH[dtype]) for x in (q, k, v, do))
    tflash.reset_launch_counts()
    o, lse = tflash.flash_fwd(q, k, v, causal=causal)
    o2, lse2 = tflash.flash_fwd_plain(q, k, v, causal=causal)
    got = tflash.flash_bwd(q, k, v, o2, lse2, do, dlse, causal=causal)
    want = tflash.flash_bwd_plain(q, k, v, o2, lse2, do, dlse, causal=causal)
    torch.cuda.synchronize()
    assert tflash.launch_counts() == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                      "flash_bwd_dkv": 1}
    assert (o.float() - o2.float()).abs().max().item() < tol
    live = lse2 > tflash.NEG_INF / 2
    assert torch.equal(lse[~live], lse2[~live])
    assert (lse[live] - lse2[live]).abs().max().item() < tol
    for g, w in zip(got, want):
        assert (g.float() - w.float()).abs().max().item() < tol


@pytest.mark.cuda
def test_autograd_on_strided_views_launches_the_kernels(cuda):
    """GPT-2 splits a fused qkv projection: q/k/v are strided views that
    the kernels read without a copy."""
    qkv = torch.randn(2, 256, 3 * 4 * 64, device=cuda, requires_grad=True)
    q, k, v = (t.view(2, 256, 4, 64) for t in qkv.split(256, dim=-1))
    tflash.reset_launch_counts()
    tflash.flash_attention(q, k, v).square().sum().backward()
    g_kernel = qkv.grad.clone()
    qkv.grad = None
    o, _ = tflash.flash_fwd_plain(q, k, v)
    o.square().sum().backward()
    torch.cuda.synchronize()
    assert tflash.launch_counts() == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                      "flash_bwd_dkv": 1}
    assert (g_kernel - qkv.grad).abs().max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kw,needle", [
    (dict(d=48), "head_dim"), (dict(dtype=torch.float64), "dtype")])
def test_kernel_refuses_what_it_does_not_take(cuda, kw, needle):
    d, dtype = kw.get("d", 64), kw.get("dtype", torch.float32)
    q = torch.zeros(1, 16, 2, d, device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match=needle):
        tflash.flash_fwd(q, q, q)


# ------------------------------------------- the bf16 forward's operands


def _qkv_split(b=2, l=96, h=4, d=64):
    qkv = torch.zeros(b, l, 3 * h * d, dtype=torch.bfloat16)
    return tuple(t.view(b, l, h, d) for t in qkv.split(h * d, dim=-1))


def _tma_case(name):
    """One [b, l, h, d] bf16 operand per case, on the CPU (the rule only
    reads shapes, strides and the base address)."""
    base = torch.zeros(2, 96, 4, 64, dtype=torch.bfloat16)
    if name == "contiguous":
        return base
    if name == "qkv_split_views":
        return _qkv_split()[1]
    if name == "heads_transposed":       # [b, h, l, d] seen as [b, l, h, d]
        return torch.zeros(2, 4, 96, 64, dtype=torch.bfloat16).transpose(1, 2)
    if name == "misaligned_base":        # 8 bytes past an aligned address
        flat = torch.zeros(2 * 96 * 4 * 64 + 4, dtype=torch.bfloat16)
        return flat[4:].view(2, 96, 4, 64)
    if name == "head_stride_off_16_bytes":   # heads 68 elements apart
        return torch.zeros(2, 96, 4, 68, dtype=torch.bfloat16)[..., :64]
    if name == "size_one_dims_any_stride":   # b = h = 1: their strides
        return torch.zeros(1, 96, 1, 64, dtype=torch.bfloat16).as_strided(
            (1, 96, 1, 64), (3, 64, 5, 1))
    raise KeyError(name)


TMA_CASES = [("contiguous", True), ("qkv_split_views", True),
             ("heads_transposed", False), ("misaligned_base", False),
             ("head_stride_off_16_bytes", False),
             ("size_one_dims_any_stride", True)]


@pytest.mark.parametrize("name,ok", TMA_CASES, ids=[c[0] for c in TMA_CASES])
def test_tma_rule_decides_which_operands_go_in_without_a_copy(name, ok):
    t = _tma_case(name)
    assert tflash.tma_ok(t.shape, t.stride(), t.data_ptr(),
                         t.element_size()) is ok
    # what the bf16 forward is handed: the operand itself, or a copy
    # that the rule takes, with the same values
    q, _, _ = tflash._tma_operands(t, t, t)
    assert (q is t) is ok
    assert tflash.tma_ok(q.shape, q.stride(), q.data_ptr(),
                         q.element_size())
    assert torch.equal(q, t)


def test_fp32_operands_are_never_copied():
    """The fp32 forward reads rows through three strides, not TMA."""
    t = torch.zeros(2, 4, 96, 64).transpose(1, 2)
    assert all(x is t for x in tflash._tma_operands(t, t, t))


# --------------------------------------------- the bf16 forward on the card


def _card_inputs(cuda, seed, b, lq, lk, h, d, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(b, n, h, d, device=cuda, generator=g).to(dtype)
                 for n in (lq, lk, lk))


def _check_fwd(q, k, v, causal, tol):
    o, lse = tflash.flash_fwd(q, k, v, causal=causal)
    o2, lse2 = tflash.flash_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert o.shape == o2.shape and lse.shape == lse2.shape
    assert (o.float() - o2.float()).abs().max().item() < tol
    live = lse2 > tflash.NEG_INF / 2
    assert torch.equal(lse[~live], lse2[~live])       # exactly NEG_INF
    assert not o[~live.transpose(1, 2)].any()         # and o = 0 there
    if live.any():
        assert (lse[live] - lse2[live]).abs().max().item() < tol
    return o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("length", [1, 63, 65, 1000, 4097])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_ragged_lengths_on_card(cuda, length, causal, dtype, tol):
    """Lengths off the 64-row tile: the TMA boxes zero-fill past the end
    and the mask covers the ragged key tile."""
    q, k, v = _card_inputs(cuda, length, 1, length, length, 2, 64, dtype)
    _check_fwd(q, k, v, causal, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("lq,lk", [(100, 300), (64, 1024), (300, 100),
                                   (256, 64)])
def test_forward_offsets_and_dead_rows_on_card(cuda, lq, lk, d, dtype, tol):
    """Causal with lq < lk (query i sees keys <= i + lk - lq) and lq > lk
    (the first lq - lk rows see no key: lse NEG_INF, o 0), at every head
    dim: 64-byte swizzle at d 32, two boxes a tile at d 128."""
    q, k, v = _card_inputs(cuda, d + lq, 2, lq, lk, 3, d, dtype)
    _check_fwd(q, k, v, True, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["qkv_split_views", "heads_transposed",
                                    "head_stride_off_16_bytes",
                                    "misaligned_base"])
def test_forward_takes_any_strided_operand_on_card(cuda, layout):
    """The split views of a fused qkv projection go to TMA in place;
    operands the TMA rule refuses are copied first; all agree with the
    plain version."""
    b, l, h, d = 2, 300, 4, 64
    g = torch.Generator(device=cuda).manual_seed(9)
    if layout == "qkv_split_views":
        qkv = torch.randn(b, l, 3 * h * d, device=cuda, generator=g)
        q, k, v = (t.view(b, l, h, d) for t in
                   qkv.to(torch.bfloat16).split(h * d, dim=-1))
    elif layout == "heads_transposed":
        q, k, v = (torch.randn(b, h, l, d, device=cuda, generator=g).to(
            torch.bfloat16).transpose(1, 2) for _ in range(3))
    elif layout == "head_stride_off_16_bytes":
        q, k, v = (torch.randn(b, l, h, d + 4, device=cuda, generator=g).to(
            torch.bfloat16)[..., :d] for _ in range(3))
    else:
        q, k, v = (torch.randn(b * l * h * d + 4, device=cuda, generator=g)
                   .to(torch.bfloat16)[4:].view(b, l, h, d)
                   for _ in range(3))
    ok = tflash.tma_ok(q.shape, q.stride(), q.data_ptr(), q.element_size())
    assert ok is (layout == "qkv_split_views")
    before = tflash.launch_counts()["flash_fwd"]
    _check_fwd(q, k, v, True, 3e-2)
    assert tflash.launch_counts()["flash_fwd"] == before + 1


@pytest.mark.cuda
def test_forward_two_runs_bit_equal_and_graph_replay_equals_eager(cuda):
    """No atomics, no order that depends on the schedule: two runs give
    the same bits; the tensor maps are built on the host at capture, so
    a replayed CUDA graph gives the eager bits, after new inputs too."""
    q, k, v = _card_inputs(cuda, 11, 2, 1000, 1000, 4, 128)
    o1, lse1 = tflash.flash_fwd(q, k, v)
    o2, lse2 = tflash.flash_fwd(q, k, v)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tflash.flash_fwd(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, lse = tflash.flash_fwd(q, k, v)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(o, o1) and torch.equal(lse, lse1)
    for t, new in zip((q, k, v), _card_inputs(cuda, 12, 2, 1000, 1000, 4,
                                              128)):
        t.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    o3, lse3 = tflash.flash_fwd(q, k, v)
    assert torch.equal(o, o3) and torch.equal(lse, lse3)


# ------------------------------------------- the bf16 backward's host rules


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_delta_prepass_takes_exact_fp32_products(dtype):
    """The delta pre-pass multiplies do and o in fp32 without fp32 copies
    of either (addcmul onto a one-element fp32 zero): the same bits as
    casting both first, [b, h, lq] contiguous."""
    g = torch.Generator().manual_seed(8)
    o, do = (torch.randn(2, 33, 3, 64, generator=g).to(dtype)
             for _ in range(2))
    dlse = torch.randn(2, 3, 33, generator=g)
    got = tflash._delta(o, do, dlse)
    want = (do.float() * o.float()).sum(-1).transpose(1, 2) - dlse
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, want)


def test_backward_operands_follow_the_tma_rule():
    """q, k, v and do go through the forward's copy rule: an operand that
    TMA cannot read in place (a head-transposed do) is copied, the split
    views of a fused qkv are not."""
    q, k, v = _qkv_split()
    do = torch.zeros(2, 4, 96, 64, dtype=torch.bfloat16).transpose(1, 2)
    got = tflash._tma_operands(q, k, v, do)
    assert [x is t for x, t in zip(got, (q, k, v, do))] == [True] * 3 + \
        [False]
    assert all(tflash.tma_ok(x.shape, x.stride(), x.data_ptr(),
                             x.element_size()) for x in got)
    assert torch.equal(got[3], do)


# -------------------------------------------- the bf16 backward on the card


def _check_bwd(cuda, seed, b, lq, lk, h, d, causal, dtype, tol, do=None):
    """The backward pair against its plain version on one input set (the
    plain forward's o / lse, a random lse cotangent); returns the grads."""
    q, k, v = _card_inputs(cuda, seed, b, lq, lk, h, d, dtype)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    if do is None:
        do = torch.randn(b, lq, h, d, device=cuda, generator=g).to(dtype)
    dlse = torch.randn(b, h, lq, device=cuda, generator=g)
    o, lse = tflash.flash_fwd_plain(q, k, v, causal=causal)
    before = tflash.launch_counts()
    got = tflash.flash_bwd(q, k, v, o, lse, do, dlse, causal=causal)
    want = tflash.flash_bwd_plain(q, k, v, o, lse, do, dlse, causal=causal)
    torch.cuda.synchronize()
    after = tflash.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == w.shape and x.dtype == w.dtype, name
        assert torch.isfinite(x.float()).all(), name
        assert (x.float() - w.float()).abs().max().item() < tol, name
    dead = ~(lse > tflash.NEG_INF / 2)          # [b, h, lq]
    assert not got[0][dead.transpose(1, 2)].any()  # dead rows: dq = 0
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("length", [1, 63, 65, 1000, 4097])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_ragged_lengths_on_card(cuda, length, causal, dtype, tol):
    """Lengths off the 64-row tile: TMA zero-fills the ragged tile's Q /
    dO / K / V, the padded lse marks the rows past q_len dead, and the
    key mask covers the ragged key tile."""
    _check_bwd(cuda, length, 1, length, length, 2, 64, causal, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("lq,lk", [(100, 300), (64, 1024), (300, 100),
                                   (256, 64)])
def test_backward_offsets_and_dead_rows_on_card(cuda, lq, lk, d, dtype, tol):
    """Causal with lq < lk and lq > lk (the first lq - lk query rows see
    no key: zero dq, no share of dk / dv), at every head dim: 64-byte
    swizzle at d 32, two boxes a tile and dkv's in-order walk at d 128."""
    _check_bwd(cuda, d + lq, 2, lq, lk, 3, d, True, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_head_dims_on_card(cuda, d, causal):
    _check_bwd(cuda, d, 2, 777, 777, 4, d, causal, torch.bfloat16, 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["qkv_split_views", "do_heads_transposed",
                                    "do_misaligned_base"])
def test_backward_takes_any_strided_operand_on_card(cuda, layout):
    """The split views of a fused qkv projection go to TMA in place
    (through autograd, as GPT-2 calls it); a do that the TMA rule refuses
    is copied first; all agree with the plain version."""
    b, l, h, d = 2, 300, 4, 64
    g = torch.Generator(device=cuda).manual_seed(13)
    if layout == "qkv_split_views":
        qkv = torch.randn(b, l, 3 * h * d, device=cuda, generator=g).to(
            torch.bfloat16).requires_grad_()
        q, k, v = (t.view(b, l, h, d) for t in qkv.split(h * d, dim=-1))
        do = torch.randn(b, l, h, d, device=cuda, generator=g).to(
            torch.bfloat16)
        before = tflash.launch_counts()
        tflash.flash_attention(q, k, v).backward(do)
        o, lse = tflash.flash_fwd_plain(q, k, v)
        want = torch.cat([x.reshape(b, l, h * d) for x in
                          tflash.flash_bwd_plain(q, k, v, o, lse, do)], -1)
        torch.cuda.synchronize()
        after = tflash.launch_counts()
        assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
        assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
        assert (qkv.grad.float() - want.float()).abs().max().item() < 3e-2
        return
    if layout == "do_heads_transposed":
        do = torch.randn(b, h, l, d, device=cuda, generator=g).to(
            torch.bfloat16).transpose(1, 2)
    else:
        do = (torch.randn(b * l * h * d + 4, device=cuda, generator=g)
              .to(torch.bfloat16)[4:].view(b, l, h, d))
    assert not tflash.tma_ok(do.shape, do.stride(), do.data_ptr(),
                             do.element_size())
    _check_bwd(cuda, 14, b, l, l, h, d, True, torch.bfloat16, 3e-2, do=do)


@pytest.mark.cuda
def test_backward_two_runs_bit_equal_and_graph_replay_equals_eager(cuda):
    """No atomics: every block writes its own rows, each sum in the walk's
    order, so two runs give the same bits; the tensor maps are built on
    the host at capture, so a replayed CUDA graph gives the eager bits,
    after new inputs too."""
    q, k, v = _card_inputs(cuda, 21, 2, 1000, 1000, 4, 64)
    do = _card_inputs(cuda, 22, 2, 1000, 1000, 4, 64)[0]
    o, lse = tflash.flash_fwd(q, k, v)
    g1 = tflash.flash_bwd(q, k, v, o, lse, do)
    g2 = tflash.flash_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tflash.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gg = tflash.flash_bwd(q, k, v, o, lse, do)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(gg, g1))
    new = _card_inputs(cuda, 23, 2, 1000, 1000, 4, 64)
    for t, n in zip((q, k, v), new):
        t.copy_(n)
    o2, lse2 = tflash.flash_fwd(q, k, v)
    o.copy_(o2)
    lse.copy_(lse2)
    graph.replay()
    torch.cuda.synchronize()
    g3 = tflash.flash_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(gg, g3))
