"""Block-sparse attention parity of the PyTorch port against the JAX package.

On the CPU the port's path (``flash_attention(..., sparsity_config=)``,
``SparseSelfAttention``, ``make_sparse_op``) runs its plain versions
through the same ``autograd.Function`` that launches the kernels on the
card; the JAX side runs its Pallas kernels in interpret mode, as
``tests/unit/ops/test_sparse_attention.py`` does, and its custom VJP
through ``jax.vjp`` with a random output cotangent.  Inputs are made with
numpy from a seed and handed to both.  Layouts and ``build_csr``'s step
arrays must be bit-equal.

Tolerances: atol 2e-5 on o and lse, 5e-5 on dq, dk and dv in fp32 (the
same products summed in other orders over at most 512 keys); 2e-2 in bf16
(operands and p rounded to bf16 at the same points, outputs an ulp
apart).  Tests marked ``cuda`` hold the kernels against the plain
versions on the card at 1e-4 (fp32) and 3e-2 (bf16), and skip where there
is none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.attention import block_sparse as jbs
from deepspeed_tpu.ops.attention import flash as jflash
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.attention import block_sparse as tbs
from deepspeed_tpu_torch.ops.attention import flash as tflash

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfg(pkg, name, h, block, **extra):
    """One SparsityConfig by name, from the JAX package's module or the
    port's (``pkg``), with the JAX oracle test's options."""
    kw = {
        "fixed": ("FixedSparsityConfig",
                  dict(num_local_blocks=2, num_global_blocks=1)),
        "bigbird": ("BigBirdSparsityConfig",
                    dict(num_random_blocks=1, num_sliding_window_blocks=1,
                         num_global_blocks=1)),
        "bslongformer": ("BSLongformerSparsityConfig",
                         dict(num_sliding_window_blocks=1,
                              global_block_indices=[0])),
        "local": ("LocalSlidingWindowSparsityConfig",
                  dict(num_sliding_window_blocks=2)),
        "variable": ("VariableSparsityConfig",
                     dict(num_random_blocks=1, local_window_blocks=[1, 2],
                          global_block_indices=[0])),
        "dense": ("DenseSparsityConfig", {}),
    }[name]
    return getattr(pkg, kw[0])(h, block=block, **{**kw[1], **extra})


def _inputs(seed, b, L, h, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, L, h, d)).astype(np.float32)
            for _ in range(4)]          # q, k, v, do


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to3(x):
    b, L, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, L, d)


def _from3(x, b):
    bh, L, d = x.shape
    return np.asarray(x, np.float32).reshape(b, bh // b, L, d) \
        .transpose(0, 2, 1, 3)


def _jax_op(layout, *, causal, scale, block, h, factor, q, k, v, do,
            dtype="float32"):
    """(o, dq, dk, dv) of the JAX package's make_sparse_op (interpret
    mode) on [b, L, h, d] numpy inputs, in that layout."""
    op = jbs.make_sparse_op(layout, causal=causal, scale=scale, block=block,
                            num_heads=h, interpret=True, factor=factor)
    args = [jnp.asarray(_to3(x), JNP[dtype]) for x in (q, k, v)]
    o, vjp = jax.vjp(op, *args)
    grads = vjp(jnp.asarray(_to3(do), JNP[dtype]))
    b = q.shape[0]
    return [_from3(_np(t), b) for t in (o, *grads)]


def _port_op(op, q, k, v, do, dtype="float32"):
    ts = [torch.tensor(x, dtype=TORCH[dtype], requires_grad=True)
          for x in (q, k, v)]
    o = op(*ts)
    o.backward(torch.tensor(do, dtype=TORCH[dtype]))
    return [_np(t) for t in (o, *(t.grad for t in ts))]


def _assert_close(got, want, atols, labels=("o", "dq", "dk", "dv")):
    for label, g, w, atol in zip(labels, got, want, atols):
        assert g.shape == w.shape, label
        np.testing.assert_allclose(g, w, atol=atol, err_msg=label)


# ------------------------------------------------------------------ layouts


LAYOUT_CASES = [
    ("dense", {}),
    ("fixed", {}),
    ("fixed", dict(attention="unidirectional")),
    ("fixed", dict(num_local_blocks=4, num_global_blocks=2,
                   horizontal_global_attention=True)),
    ("fixed", dict(num_local_blocks=4, different_layout_per_head=True,
                   num_different_global_patterns=4)),
    ("variable", dict(seed=3, num_random_blocks=2)),
    ("variable", dict(attention="unidirectional", local_window_blocks=[1, 3],
                      global_block_indices=[1, 5],
                      global_block_end_indices=[3, 7],
                      horizontal_global_attention=True,
                      different_layout_per_head=True)),
    ("bigbird", dict(seed=7, num_random_blocks=2,
                     num_sliding_window_blocks=3)),
    ("bigbird", dict(attention="unidirectional", different_layout_per_head=True,
                     num_global_blocks=2)),
    ("bslongformer", dict(num_sliding_window_blocks=3,
                          global_block_indices=[0, 4],
                          global_block_end_indices=[2, 6],
                          attention="unidirectional")),
    ("local", {}),
    ("local", dict(attention="bidirectional", num_sliding_window_blocks=3)),
]


@pytest.mark.parametrize("name,kw", LAYOUT_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYOUT_CASES)])
def test_layouts_bit_equal_to_jax(name, kw):
    for L in (256, 1024, 2048):
        for block in (16, 64, 128):
            want = _cfg(jsa, name, 4, block, **kw).make_layout(L)
            got = _cfg(tsa, name, 4, block, **kw).make_layout(L)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want), (L, block)
    with pytest.raises(ValueError, match="not divisible"):
        _cfg(tsa, name, 4, 128, **kw).make_layout(200)


def _ragged_layout(seed, H=3, n=8):
    """Random per-head densities, some empty rows, heads of unequal
    step counts (so build_csr pads)."""
    rng = np.random.default_rng(seed)
    layout = (rng.random((H, n, n)) < rng.random((H, 1, 1))).astype(np.int32)
    layout[:, 1] = 0
    layout[0, 5] = 0
    return layout


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_build_csr_bit_equal_to_jax(factor):
    layout = _ragged_layout(factor)
    want = jbs.build_csr(layout, factor)
    got = tbs.build_csr(layout, factor)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert (got[4] == 0).any()        # placeholders or padding exist


def test_kernel_index_is_build_csr_without_placeholders():
    """The CSR the kernels walk holds build_csr's live steps, per layout
    head and row, for the layout and its transpose; tiles start heaviest
    first, each once."""
    layout = _ragged_layout(5, n=12)
    for block, factor in ((32, 1), (64, 2), (128, 1)):
        index = tbs.SparseIndex(layout, block=block, factor=factor)
        kf = index.tile // block
        for walk, lay in ((index.walk, layout),
                          (index.walk_t, layout.transpose(0, 2, 1))):
            row, col, _, _, run, fmask = jbs.build_csr(lay, kf)
            live = run == 1
            assert np.array_equal(walk["cols"], col[live])
            assert np.array_equal(walk["fmask"], fmask[live])
            counts = np.diff(walk["row_ptr"]).reshape(3, index.n_rows)
            for h in range(3):
                assert np.array_equal(counts[h], np.bincount(
                    row[h][live[h]], minlength=index.n_rows))
            n_tiles = -(-index.seq_len // 64)
            for h in range(3):
                order = walk["order"][h]
                assert sorted(order) == list(range(n_tiles))
                weight = counts[h][order * 64 // index.tile]
                assert (np.diff(weight) <= 0).all()


def test_layout_to_bias_equal():
    layout = _cfg(tsa, "bigbird", 2, 16).make_layout(128)
    want = np.asarray(jsa.layout_to_bias(layout, 128, 16))
    got = tsa.layout_to_bias(layout, 128, 16)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------------ forward


ORACLE_CASES = [("fixed", True), ("fixed", False), ("bigbird", False),
                ("bslongformer", False), ("local", True), ("variable", False),
                ("dense", True)]


@pytest.mark.parametrize("name,causal", ORACLE_CASES,
                         ids=[f"{n}-{'causal' if c else 'bidir'}"
                              for n, c in ORACLE_CASES])
def test_forward_matches_jax_pallas(name, causal):
    """o through ``flash_attention(..., sparsity_config=)`` on both sides
    and lse through the kernels' wrappers, at the JAX oracle test's
    configs (h 2, L 512, block 128)."""
    h, L, block, d = 2, 512, 128, 16
    q, k, v, _ = _inputs(sum(map(ord, name)) + causal, 1, L, h, d)
    want = jflash.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=causal,
                                  sparsity_config=_cfg(jsa, name, h, block))
    cfg = _cfg(tsa, name, h, block)
    got = tflash.flash_attention(*map(torch.tensor, (q, k, v)),
                                 causal=causal, sparsity_config=cfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL["float32"])

    layout = np.asarray(cfg.make_layout(L))
    if causal:
        layout = np.tril(layout)
    scale = d ** -0.5
    _, lse_j = jbs._sparse_fwd(
        *(jnp.asarray(_to3(x)) for x in (q, k, v)),
        tuple(jnp.asarray(a) for a in jbs.build_csr(layout)), scale=scale,
        block=block, causal=causal, num_heads=h, interpret=True)
    o_t, lse_t = tbs.sparse_fwd(*map(torch.tensor, (q, k, v)),
                                tbs.SparseIndex(layout, block=block),
                                causal=causal, scale=scale)
    np.testing.assert_allclose(_np(o_t), _np(got), atol=0)
    np.testing.assert_allclose(lse_t.numpy(),
                               np.asarray(lse_j)[..., 0].reshape(1, h, L),
                               atol=ATOL["float32"])


def test_empty_rows_and_columns_match_jax():
    """Rows with no active key give o = 0, lse = NEG_INF and zero dq;
    columns no query reaches give zero dk / dv, as in the JAX kernels."""
    h, L, block, d = 2, 256, 64, 16
    layout = np.ones((h, 4, 4), np.int32)
    layout[0, 1] = 0                   # head 0: query block 1 sees nothing
    layout[1, :, 2] = 0                # head 1: key block 2 is never seen
    q, k, v, do = _inputs(11, 1, L, h, d)
    want = _jax_op(layout, causal=False, scale=0.25, block=block, h=h,
                   factor=1, q=q, k=k, v=v, do=do)
    op = tbs.make_sparse_op(layout, causal=False, scale=0.25, block=block,
                            num_heads=h)
    got = _port_op(op, q, k, v, do)
    _assert_close(got, want, [2e-5, 5e-5, 5e-5, 5e-5])
    o, dq, dk, dv = got
    dead = slice(64, 128)
    assert not o[:, dead, 0].any() and not dq[:, dead, 0].any()
    assert not dk[:, 128:192, 1].any() and not dv[:, 128:192, 1].any()
    _, lse = tbs.sparse_fwd(*map(torch.tensor, (q, k, v)), op.index,
                            causal=False, scale=0.25)
    assert (lse[0, 0, dead] == tflash.NEG_INF).all()
    assert (lse[0, 1] > tflash.NEG_INF / 2).all()


# ---------------------------------------------------------------- gradients


GRAD_CASES = [
    ("fixed_causal", "fixed", True, 2, {}),
    ("bigbird_bidir", "bigbird", False, 2, {}),
    ("per_head_layouts", "fixed", True, 4,
     dict(different_layout_per_head=True, num_different_global_patterns=2)),
]


@pytest.mark.parametrize("label,name,causal,h,kw", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_gradients_match_jax_pallas(label, name, causal, h, kw):
    """o, dq, dk, dv under a random cotangent, through the public entry
    points (``flash_attention`` with a sparsity config) on both sides."""
    L, block, d = 512, 128, 16
    q, k, v, do = _inputs(sum(map(ord, label)), 1, L, h, d)
    jcfg = _cfg(jsa, name, h, block, **kw)

    def f(q_, k_, v_):
        return jflash.flash_attention(q_, k_, v_, causal=causal,
                                      sparsity_config=jcfg)
    o, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = [_np(o)] + [_np(g) for g in vjp(jnp.asarray(do))]
    tcfg = _cfg(tsa, name, h, block, **kw)
    got = _port_op(lambda *t: tflash.flash_attention(
        *t, causal=causal, sparsity_config=tcfg), q, k, v, do)
    _assert_close(got, want, [2e-5, 5e-5, 5e-5, 5e-5])


def test_make_sparse_op_factor4_matches_jax_and_factor1():
    """The JAX package's coarse-tile test (BigBird, block 64, factor 4):
    the port's factor-4 op equals the JAX factor-4 op and its own
    factor-1 op, forward and gradients."""
    h, d, L, blk = 2, 32, 512, 64
    cfg = tsa.BigBirdSparsityConfig(num_heads=h, block=blk,
                                    num_random_blocks=1,
                                    num_sliding_window_blocks=3,
                                    num_global_blocks=1)
    layout = np.tril(np.asarray(cfg.make_layout(L)))
    kw = dict(causal=True, scale=0.125, block=blk)
    q, k, v, do = _inputs(3, 2, L, h, d)
    want = _jax_op(layout, h=h, factor=4, q=q, k=k, v=v, do=do, **kw)
    op4 = tbs.make_sparse_op(layout, num_heads=h, factor=4, **kw)
    assert op4.index.tile == 256
    got4 = _port_op(op4, q, k, v, do)
    got1 = _port_op(tbs.make_sparse_op(layout, num_heads=h, factor=1, **kw),
                    q, k, v, do)
    _assert_close(got4, want, [2e-5, 5e-5, 5e-5, 5e-5])
    _assert_close(got4, got1, [2e-5, 5e-5, 5e-5, 5e-5])


@pytest.mark.parametrize("block", [16, 32])
def test_small_blocks_match_jax_pallas(block):
    """Blocks below the kernels' 64-token tile (walked as 64-token cells
    with fine bits on the card), through SparseSelfAttention."""
    h, L, d = 2, 256, 16
    kw = dict(num_random_blocks=1, num_sliding_window_blocks=3,
              num_global_blocks=1, seed=block)
    q, k, v, do = _inputs(block, 1, L, h, d)
    jcfg = jsa.BigBirdSparsityConfig(h, block=block, **kw)
    o, vjp = jax.vjp(jsa.SparseSelfAttention(jcfg),
                     *map(jnp.asarray, (q, k, v)))
    want = [_np(o)] + [_np(g) for g in vjp(jnp.asarray(do))]
    module = tsa.SparseSelfAttention(tsa.BigBirdSparsityConfig(
        h, block=block, **kw))
    got = _port_op(module, q, k, v, do)
    _assert_close(got, want, [2e-5, 5e-5, 5e-5, 5e-5])
    index = tbs.SparseIndex(jcfg.make_layout(L), block=block)
    assert index.tile == 64 and (index.walk["fmask"] > 1).any()


def test_bf16_matches_jax_pallas():
    h, L, block, d = 2, 512, 128, 16
    q, k, v, do = _inputs(21, 1, L, h, d)
    layout = np.asarray(_cfg(tsa, "bigbird", h, block).make_layout(L))
    want = _jax_op(layout, causal=False, scale=0.25, block=block, h=h,
                   factor=1, q=q, k=k, v=v, do=do, dtype="bfloat16")
    op = tbs.make_sparse_op(layout, causal=False, scale=0.25, block=block,
                            num_heads=h)
    got = _port_op(op, q, k, v, do, dtype="bfloat16")
    _assert_close(got, want, [ATOL["bfloat16"]] * 4)


# ------------------------------------------------------- wrapper and cache


def test_sparse_self_attention_infers_causal_from_the_config():
    h, L, d = 2, 256, 16
    q, k, v, _ = _inputs(8, 1, L, h, d)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    for cfg, causal in (
            (tsa.LocalSlidingWindowSparsityConfig(
                h, block=64, num_sliding_window_blocks=2), True),
            (tsa.BigBirdSparsityConfig(h, block=64), False),
            (tsa.FixedSparsityConfig(h, block=64,
                                     attention="unidirectional"), True),
            (tsa.DenseSparsityConfig(h, block=64), False)):
        module = tsa.SparseSelfAttention(cfg)
        assert isinstance(module, torch.nn.Module)
        got = module(tq, tk, tv)
        want = tflash.flash_attention(tq, tk, tv, causal=causal,
                                      sparsity_config=cfg)
        assert torch.equal(got, want), type(cfg).__name__
        assert torch.equal(module(tq, tk, tv, causal=not causal),
                           tflash.flash_attention(tq, tk, tv,
                                                  causal=not causal,
                                                  sparsity_config=cfg))
    # the dense config, bidirectional, is plain dense attention
    dense = tsa.SparseSelfAttention(tsa.DenseSparsityConfig(h, block=64))
    np.testing.assert_allclose(
        dense(tq, tk, tv).numpy(),
        tflash.flash_attention(tq, tk, tv, causal=False).numpy(), atol=1e-6)
    jwant = jsa.SparseSelfAttention(jsa.LocalSlidingWindowSparsityConfig(
        h, block=64, num_sliding_window_blocks=2))(
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(
        tsa.SparseSelfAttention(tsa.LocalSlidingWindowSparsityConfig(
            h, block=64, num_sliding_window_blocks=2))(tq, tk, tv).numpy(),
        _np(jwant), atol=ATOL["float32"])


def test_op_cache_is_bounded_and_keyed_by_config_shape_and_device(
        monkeypatch):
    monkeypatch.setattr(tbs, "_OP_CACHE", {})
    monkeypatch.setattr(tbs, "_OP_CACHE_MAX", 2)
    q = torch.zeros(1, 128, 2, 16)
    cfgs = [tsa.FixedSparsityConfig(2, block=32, num_local_blocks=n)
            for n in (1, 2, 4)]
    tbs.sparse_flash_attention(q, q, q, cfgs[0], causal=True)
    (key, op), = tbs._OP_CACHE.items()
    assert key == (tbs._config_key(cfgs[0]), 128, 2, True, 0.25,
                   torch.device("cpu"))
    tbs.sparse_flash_attention(q, q, q, cfgs[0], causal=True)
    assert tbs._OP_CACHE[key] is op                    # looked up, not rebuilt
    tbs.sparse_flash_attention(q, q, q, cfgs[0], causal=False)
    tbs.sparse_flash_attention(q, q, q, cfgs[1], causal=True)
    assert len(tbs._OP_CACHE) == 2 and key not in tbs._OP_CACHE
    tbs.sparse_flash_attention(q, q, q, cfgs[2], causal=True, scale=0.5)
    assert [k[0] for k in tbs._OP_CACHE] == [tbs._config_key(cfgs[1]),
                                             tbs._config_key(cfgs[2])]
    assert list(tbs._OP_CACHE)[-1][4] == 0.5
    # equal configs built separately share one entry
    tbs.sparse_flash_attention(q, q, q, tsa.FixedSparsityConfig(
        2, block=32, num_local_blocks=4), causal=True, scale=0.5)
    assert len(tbs._OP_CACHE) == 2


@pytest.mark.parametrize("case", ["non_square", "seq_not_divisible",
                                  "with_lse", "unsupported_block",
                                  "layout_heads"])
def test_error_paths(case):
    cfg = tsa.FixedSparsityConfig(2, block=64)
    q = torch.zeros(1, 128, 2, 16)
    if case == "non_square":
        with pytest.raises(AssertionError, match="square"):
            tflash.flash_attention(q, torch.zeros(1, 192, 2, 16),
                                   torch.zeros(1, 192, 2, 16),
                                   sparsity_config=cfg)
    elif case == "seq_not_divisible":
        q = torch.zeros(1, 100, 2, 16)
        with pytest.raises(ValueError, match="not divisible"):
            tflash.flash_attention(q, q, q, sparsity_config=cfg)
    elif case == "with_lse":
        with pytest.raises(AssertionError, match="with_lse"):
            tflash.flash_attention(q, q, q, with_lse=True,
                                   sparsity_config=cfg)
    elif case == "unsupported_block":
        for block, factor in ((48, 1), (8, 1), (32, 3), (16, 8)):
            with pytest.raises(ValueError, match=f"block {block}"):
                tbs.make_sparse_op(np.ones((1, 4, 4)), causal=True,
                                   scale=None, block=block, num_heads=2,
                                   factor=factor)
        with pytest.raises(ValueError, match="block 48"):
            tsa.SparseSelfAttention(tsa.FixedSparsityConfig(
                2, block=48))(torch.zeros(1, 96, 2, 16),
                              torch.zeros(1, 96, 2, 16),
                              torch.zeros(1, 96, 2, 16))
    else:
        with pytest.raises(ValueError, match="layout heads"):
            tbs.make_sparse_op(np.ones((3, 2, 2)), causal=True, scale=None,
                               block=64, num_heads=2)


def test_cpu_tensors_take_the_plain_versions_without_launching():
    tbs.reset_launch_counts()
    q = torch.randn(1, 256, 2, 32, requires_grad=True)
    cfg = tsa.BSLongformerSparsityConfig(2, block=32)
    tsa.SparseSelfAttention(cfg)(q, q, q).square().sum().backward()
    assert q.grad.abs().sum() > 0
    assert tbs.launch_counts() == {"sparse_fwd": 0, "sparse_bwd_dq": 0,
                                   "sparse_bwd_dkv": 0}


def test_plain_backward_agrees_with_autograd_through_the_plain_forward():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(9, 2, 192, 2, 8))
    layout = _ragged_layout(2, H=2, n=6)
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    o, _ = tbs.sparse_fwd_plain(*ts, layout, block=32, causal=True,
                                scale=0.3)
    o.backward(do)
    o2, lse2 = tbs.sparse_fwd_plain(q, k, v, layout, block=32, causal=True,
                                    scale=0.3)
    grads = tbs.sparse_bwd_plain(q, k, v, o2, lse2, do, layout, block=32,
                                 causal=True, scale=0.3)
    for want, got in zip((t.grad for t in ts), grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (CPU tensors take the plain versions, "
                    "tested above)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = [
    # (label, config name, h, L, block, d, causal, factor, config options)
    ("bigbird128_bidir", "bigbird", 3, 1024, 128, 64, False, 1, {}),
    ("fixed_per_head_causal", "fixed", 4, 1024, 128, 64, True, 1,
     dict(num_local_blocks=4, different_layout_per_head=True,
          num_different_global_patterns=4)),
    ("variable_bidir_d32", "variable", 2, 768, 64, 32, False, 1, {}),
    ("block16_causal_d128", "bigbird", 2, 528, 16, 128, True, 1, {}),
    ("block32_bidir", "bslongformer", 2, 480, 32, 64, False, 1, {}),
    ("factor4_causal", "bigbird", 2, 1024, 64, 64, True, 4, {}),
    ("dense_causal", "dense", 2, 384, 128, 64, True, 1, {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,name,h,L,block,d,causal,factor,kw",
                         CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernels_match_plain_versions_on_the_card(cuda, label, name, h, L,
                                                  block, d, causal, factor,
                                                  kw, dtype):
    tol = {"float32": 1e-4, "bfloat16": 3e-2}[dtype]
    layout = np.asarray(_cfg(tsa, name, h, block, **kw).make_layout(L))
    if causal:
        layout = np.tril(layout)
    index = tbs.SparseIndex(layout, block=block, factor=factor)
    q, k, v, do = (torch.from_numpy(x).to(cuda, TORCH[dtype])
                   for x in _inputs(5, 2, L, h, d))
    tbs.reset_launch_counts()
    o, lse = tbs.sparse_fwd(q, k, v, index, causal=causal)
    o2, lse2 = tbs.sparse_fwd_plain(q, k, v, layout, block=block,
                                    causal=causal)
    got = tbs.sparse_bwd(q, k, v, o2, lse2, do, index, causal=causal)
    want = tbs.sparse_bwd_plain(q, k, v, o2, lse2, do, layout, block=block,
                                causal=causal)
    torch.cuda.synchronize()
    assert tbs.launch_counts() == {"sparse_fwd": 1, "sparse_bwd_dq": 1,
                                   "sparse_bwd_dkv": 1}
    assert (o.float() - o2.float()).abs().max().item() < tol
    live = lse2 > tflash.NEG_INF / 2
    assert torch.equal(lse[~live], lse2[~live])
    assert (lse[live] - lse2[live]).abs().max().item() < tol
    for g, w in zip(got, want):
        assert (g.float() - w.float()).abs().max().item() < tol


@pytest.mark.cuda
def test_autograd_on_strided_views_launches_the_kernels(cuda):
    qkv = torch.randn(2, 512, 3 * 4 * 64, device=cuda, requires_grad=True)
    q, k, v = (t.view(2, 512, 4, 64) for t in qkv.split(256, dim=-1))
    cfg = tsa.BigBirdSparsityConfig(4, block=64, different_layout_per_head=True)
    tbs.reset_launch_counts()
    tsa.SparseSelfAttention(cfg)(q, k, v).square().sum().backward()
    g_kernel = qkv.grad.clone()
    qkv.grad = None
    o, _ = tbs.sparse_fwd_plain(q, k, v, cfg.make_layout(512), block=64,
                                causal=False)
    o.square().sum().backward()
    torch.cuda.synchronize()
    assert tbs.launch_counts() == {"sparse_fwd": 1, "sparse_bwd_dq": 1,
                                   "sparse_bwd_dkv": 1}
    assert (g_kernel - qkv.grad).abs().max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_dense_config_equals_the_dense_flash_kernels(cuda, causal):
    q, k, v, do = (torch.from_numpy(x).to(cuda, torch.bfloat16)
                   for x in _inputs(6, 1, 1024, 2, 64))
    index = tbs.SparseIndex(np.tril(np.ones((1, 8, 8))) if causal
                            else np.ones((1, 8, 8)), block=128)
    o, lse = tbs.sparse_fwd(q, k, v, index, causal=causal)
    o2, lse2 = tflash.flash_fwd(q, k, v, causal=causal)
    grads = tbs.sparse_bwd(q, k, v, o, lse, do, index, causal=causal)
    grads2 = tflash.flash_bwd(q, k, v, o2, lse2, do, causal=causal)
    torch.cuda.synchronize()
    for a, b in zip((o, lse, *grads), (o2, lse2, *grads2)):
        assert (a.float() - b.float()).abs().max().item() < 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_config_forward_bit_equal_to_flash_fwd(cuda, causal, block):
    """sparse_fwd and flash_fwd are the same bf16 forward under two
    walks: over a dense layout they give the same bits, with the layout's
    fine bits (block 16, every tile masked) or without (block 128)."""
    L = 1008 if block == 16 else 1024
    q, k, v, _ = (torch.from_numpy(x).to(cuda, torch.bfloat16)
                  for x in _inputs(8, 2, L, 3, 128))
    n = -(-L // block)
    layout = np.ones((1, n, n))
    index = tbs.SparseIndex(np.tril(layout) if causal else layout,
                            block=block)
    o, lse = tbs.sparse_fwd(q, k, v, index, causal=causal)
    o2, lse2 = tflash.flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,needle", [
    (dict(d=48), "head_dim"), (dict(dtype=torch.float64), "dtype")])
def test_kernel_refuses_what_it_does_not_take(cuda, kw, needle):
    d, dtype = kw.get("d", 64), kw.get("dtype", torch.float32)
    q = torch.zeros(1, 128, 2, d, device=cuda, dtype=dtype)
    index = tbs.SparseIndex(np.ones((1, 2, 2)), block=64)
    with pytest.raises(ValueError, match=needle):
        tbs.sparse_fwd(q, q, q, index, causal=True)
