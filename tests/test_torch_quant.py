"""Quantization parity of the PyTorch port against the JAX package:
weight-only group quantization (``quantize`` / ``dequantize`` /
``QTensor``), the ``int8_matmul`` function and the ``QDense`` layer over
it, the quantized paged KV storage (``ops/quant/kv.py``) and paged decode
attention over int8 / fp8 pools.

Inputs are made with numpy from a seed and handed to both packages.  On
the CPU the port runs its plain versions; the JAX side runs its Pallas
kernels in interpret mode (``int8_matmul`` does so by default off the
TPU, ``quant_matmul(impl="pallas")``, ``paged_decode_attention(...,
force_kernel=True)``).  Quantized payloads (``q``, int8 and fp8 KV rows)
must be BIT-equal and scales exactly equal (atol 0: both sides divide
the same fp32 absmax by the same constant); products are compared to a
tolerance stated at each test, because the two sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import decode as jdec
from deepspeed_tpu.ops.quant import kernels as jkern
from deepspeed_tpu.ops.quant import kv as jkv
from deepspeed_tpu.ops.quant import quantizer as jq
from deepspeed_tpu_torch.models.llama import Llama, llama_tiny
from deepspeed_tpu_torch.ops.attention import decode as tdec
from deepspeed_tpu_torch.ops.quant import kernels as tkern
from deepspeed_tpu_torch.ops.quant import kv as tkv
from deepspeed_tpu_torch.ops.quant import quantizer as tq
from deepspeed_tpu_torch.ops.quant.qdense import QDense, quant_matmul

FP8 = pytest.mark.skipif(not (jkv.fp8_supported() and tkv.fp8_supported()),
                         reason="needs float8_e4m3fn in jax and torch")
KV_NAMES = ["int8", pytest.param("fp8", marks=FP8)]


def _weights(seed, n_in, n_out, zero_group=None):
    w = np.random.default_rng(seed).normal(size=(n_in, n_out)) \
        .astype(np.float32)
    if zero_group is not None:
        w[zero_group[0]:zero_group[1], :3] = 0.0
    return w


# ------------------------------------------------------ weight quantizer


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n_in,group", [(256, 32), (256, 64), (256, 128),
                                        (200, 128), (130, 64), (48, 128)])
def test_quantize_bit_equal_to_jax(n_in, group, bits):
    """Divisible groups, a trailing partial group (200 = 128 + 72,
    130 = 64 + 64 + 2), fewer rows than one group, and an all-zero group
    (scale 1.0): q bit-equal, scale exactly equal."""
    w = _weights(0, n_in, 24, zero_group=(0, min(group, n_in)))
    jq_, js = jq.quantize(jnp.asarray(w), bits=bits, group_size=group)
    q, s = tq.quantize(torch.from_numpy(w), bits=bits, group_size=group)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (n_in, 24) and s.shape == (-(-n_in // group), 24)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (s[0, :3] == 1.0).all() and (q[:min(group, n_in), :3] == 0).all()
    assert int(q.abs().max()) <= (127 if bits == 8 else 8)
    back = tq.dequantize(q, s, torch.float32, group_size=group)
    want = jq.dequantize(jq_, js, jnp.float32, group_size=group)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))


def test_quantize_of_bfloat16_weights_matches_jax():
    """The engine casts to the compute dtype first, then quantizes."""
    w = _weights(1, 128, 16)
    jq_, js = jq.quantize(jnp.asarray(w).astype(jnp.bfloat16), group_size=64)
    q, s = tq.quantize(torch.from_numpy(w).to(torch.bfloat16), group_size=64)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    got = tq.dequantize(q, s)                     # default dtype: bfloat16
    want = jq.dequantize(jq_, js)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_dequantize_error_paths_and_bits():
    w = torch.from_numpy(_weights(2, 130, 8))
    q, s = tq.quantize(w, group_size=64)          # groups [64, 64, 2]
    assert s.shape[0] == 3
    with pytest.raises(ValueError, match="trailing partial group"):
        tq.dequantize(q, s, torch.float32)
    with pytest.raises(ValueError, match="trailing partial group"):
        jq.dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
    for bad in (32, 200):
        with pytest.raises(ValueError, match="inconsistent"):
            tq.dequantize(q, s, torch.float32, group_size=bad)
    with pytest.raises(ValueError, match="bits=3"):
        tq.quantize(w, bits=3)
    assert tq.QTensor(q, s, torch.float32, 8, 64).dequant().shape == (130, 8)


def test_qtensor_nbytes_counts_the_scale_rows():
    w = _weights(3, 200, 32)
    q, s = tq.quantize(torch.from_numpy(w), group_size=128)
    qt = tq.QTensor(q, s, torch.float32, 8, 128)
    jqt = jq.QTensor(*jq.quantize(jnp.asarray(w), group_size=128),
                     jnp.float32, 8, 128)
    assert qt.nbytes == jqt.nbytes == 200 * 32 + 2 * 32 * 4
    assert tuple(qt.shape) == tuple(jqt.shape) == (200, 32)
    assert "bits=8" in repr(qt)


def test_quantize_tree_sweeps_qdense_layers_only():
    model = Llama(llama_tiny())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tq.quantize_tree(model, bits=8, group_size=32,
                     predicate=lambda name, layer: "mlp" not in name)
    assert model.layers[0].attn.wq.quantized and model.lm_head.quantized
    assert not model.layers[0].mlp.w_up.quantized          # predicate skip
    assert model.embed_tokens.weight.dtype == torch.float32
    kern = model.layers[1].attn.wo.kernel
    assert isinstance(kern, tq.QTensor) and kern.group_size == 32
    q, s = tq.quantize(before["layers.1.attn.wo.weight"].t(), group_size=32)
    assert torch.equal(kern.q, q) and torch.equal(kern.scale, s)
    assert model.layers[1].attn.wo.weight is None
    tq.quantize_tree(model, group_size=32)                 # the rest
    assert all(m.quantized for m in model.modules() if isinstance(m, QDense))
    assert "layers.0.mlp.w_up.q" in model.state_dict()
    tq.dequantize_tree(model)
    after = dict(model.named_parameters())
    assert list(after) == list(before)           # same names, same order
    assert (after["lm_head.weight"] - before["lm_head.weight"]).abs().max() \
        <= before["lm_head.weight"].abs().max() / 127.0
    assert torch.equal(after["norm.scale"], before["norm.scale"])


# ----------------------------------------------------------- int8_matmul


@pytest.mark.parametrize("m,k,n,g,bn", [
    (16, 256, 128, 128, None), (3, 128, 64, 128, None),
    (4, 4800, 512, 32, 512), (8, 768, 4800, 128, None),
    (1, 512, 384, 64, 256), (5, 256, 128, 32, None)])
def test_int8_matmul_plain_matches_jax_kernel_fp32(m, k, n, g, bn):
    """The shapes of the JAX package's own kernel tests (odd m, awkward
    n).  fp32: rtol 1e-5 of the output scale (atol 1e-5 * max|ref|): both
    sum the same exact products, in different orders."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q, s = tq.quantize(torch.from_numpy(_weights(5, k, n)), group_size=g)
    want = np.asarray(jkern.int8_matmul(jnp.asarray(x), jnp.asarray(q.numpy()),
                                        jnp.asarray(s.numpy()), block_n=bn))
    got = tkern.int8_matmul(torch.from_numpy(x), q, s)
    assert got.shape == (m, n) and got.dtype == torch.float32
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=tol)
    oracle = torch.from_numpy(x) @ tq.dequantize(q, s, torch.float32)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-5,
                               atol=tol)
    assert torch.equal(got, tkern.int8_matmul_plain(torch.from_numpy(x), q, s))


@pytest.mark.parametrize("m,k,n,g", [(4, 256, 128, 64), (7, 512, 96, 128)])
def test_int8_matmul_plain_matches_jax_kernel_bf16(m, k, n, g):
    """bf16: atol 2e-2 (one bf16 rounding of an output of magnitude ~2;
    the fp32 accumulators agree far closer)."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(m, k)) / np.sqrt(k) * 8).astype(np.float32)
    q, s = tq.quantize(torch.from_numpy(_weights(7, k, n)), group_size=g)
    want = jkern.int8_matmul(jnp.asarray(x).astype(jnp.bfloat16),
                             jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
    got = tkern.int8_matmul(torch.from_numpy(x).to(torch.bfloat16), q, s)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2)


@pytest.mark.parametrize("k,n,g", [(4096, 4096, 64), (4096, 11008, 64),
                                   (11008, 4096, 64), (4096, 32000, 64),
                                   (11008, 37, 64), (384, 100, 32),
                                   (64, 64, 64), (256, 8192, 16)])
def test_k_splits_from_k_n_g_alone(k, n, g):
    """The kernel's split of k: 1-8 blocks of equal whole-group shares,
    none empty, enough column tiles x splits to fill the card where the
    groups allow, and a function of (k, n, G) alone (not of m)."""
    import inspect
    splits = tkern.k_splits(k, n, g)
    groups, tiles = k // g, -(-n // tkern.BLOCK_N)
    per = -(-groups // splits)
    assert 1 <= splits <= tkern.MAX_K_SPLITS and splits <= groups
    assert (splits - 1) * per < groups               # no empty split
    # a layer with a column tile for every SM is not split; else short of
    # the target only where the shares are already as small as
    # MAX_K_SPLITS blocks allow
    if tiles >= tkern.NUM_SMS:
        assert splits == 1
    else:
        assert tiles * splits >= tkern.TARGET_BLOCKS or \
            per == -(-groups // min(groups, tkern.MAX_K_SPLITS))
    assert list(inspect.signature(tkern.k_splits).parameters) == \
        ["k", "n", "group"]
    if (k, n) == (4096, 4096):
        assert splits == 8 and tiles * splits == 256


def test_int8_matmul_refuses_bad_shapes_and_counts_no_cpu_launch():
    x = torch.zeros(2, 128)
    q, s = tq.quantize(torch.from_numpy(_weights(8, 128, 16)), group_size=64)
    tkern.reset_launch_counts()
    tkern.int8_matmul(x, q, s)
    assert tkern.launch_counts() == {"int8_matmul_fwd": 0}
    with pytest.raises(ValueError, match="do not agree"):
        tkern.int8_matmul(torch.zeros(2, 64), q, s)
    with pytest.raises(ValueError, match="do not agree"):   # trailing group
        tkern.int8_matmul(torch.zeros(2, 130),
                          *tq.quantize(torch.zeros(130, 8), group_size=64))
    with pytest.raises(ValueError, match="int8"):
        tkern.int8_matmul(x, q.float(), s)


# ---------------------------------------------------------------- QDense


@pytest.mark.parametrize("k,g", [(128, 32), (100, 64)])
def test_qdense_qtensor_matches_jax_quant_matmul(k, g):
    """A ``QDense`` holding a ``QTensor`` against the JAX
    ``quant_matmul(impl="pallas")``, bias after; k = 100 with G = 64 is
    the trailing-group route (``x @ dequant`` on both sides).  fp32,
    rtol/atol 2e-5 (the JAX package's own bound for this layer)."""
    # imported here: this module pulls in flax, which a machine that runs
    # only the tests marked ``cuda`` may lack
    from deepspeed_tpu.ops.quant.qdense import quant_matmul as \
        jax_quant_matmul
    rng = np.random.default_rng(9)
    w = rng.standard_normal((k, 96)).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    jqt = jq.QTensor(*jq.quantize(jnp.asarray(w), group_size=g),
                     jnp.float32, 8, g)
    want = jax_quant_matmul(jnp.asarray(x), jqt, impl="pallas") + b

    layer = QDense(k, 96, use_bias=True)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T))
        layer.bias.copy_(torch.from_numpy(b))
    float_out = layer(torch.from_numpy(x))
    layer.quantize_(bits=8, group_size=g)
    assert layer.quantized and layer.weight is None
    np.testing.assert_array_equal(layer.q.numpy(), np.asarray(jqt.q))
    np.testing.assert_array_equal(layer.scale.numpy(), np.asarray(jqt.scale))
    got = layer(torch.from_numpy(x))
    assert got.shape == (2, 5, 96)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    assert (got - float_out).abs().max() < 0.5     # int8 error, not garbage
    qt = layer.kernel
    np.testing.assert_allclose(
        quant_matmul(torch.from_numpy(x), qt).numpy() + b, np.asarray(want),
        rtol=2e-5, atol=2e-5)
    layer.dequantize_()
    assert not layer.quantized
    np.testing.assert_array_equal(
        layer.weight.detach().numpy().T,
        np.asarray(jqt.dequant()))


def test_qdense_float_branch_is_unchanged_by_the_quant_buffers():
    layer = QDense(32, 8)
    assert set(layer.state_dict()) == {"weight"}
    x = torch.randn(3, 32, generator=torch.Generator().manual_seed(0))
    assert torch.equal(layer(x), torch.nn.functional.linear(x, layer.weight))
    with pytest.raises(ValueError, match="QTensor of shape"):
        layer.set_qtensor_(tq.QTensor(torch.zeros(8, 32, dtype=torch.int8),
                                      torch.ones(1, 32), torch.float32, 8,
                                      8))


# ------------------------------------------------------ quantized KV rows


@pytest.mark.parametrize("name", KV_NAMES)
def test_quantize_kv_rows_bit_equal_to_jax(name):
    """Per token row per kv head; an all-zero row takes scale 1.0.  The
    payload is compared as raw bytes, the scale exactly."""
    rng = np.random.default_rng(10)
    x = (rng.normal(size=(5, 3, 2, 16)) *
         rng.uniform(0.01, 30, size=(5, 3, 2, 1))).astype(np.float32)
    x[1, 2, 0] = 0.0
    jq_, js = jkv.quantize_kv_rows(jnp.asarray(x), name)
    q, s = tkv.quantize_kv_rows(torch.from_numpy(x), name)
    assert q.dtype == tkv.kv_storage_dtype(name) and s.shape == (5, 3, 2, 1)
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(jq_).view(np.uint8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[1, 2, 0, 0] == 1.0
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = tkv.dequantize_kv_rows(q, s, dtype)
        want = jkv.dequantize_kv_rows(jq_, js, jdtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    assert tkv.kv_qmax(name) == jkv.kv_qmax(name)
    assert tkv.is_quantized_kv(name) and not tkv.is_quantized_kv("float32")
    assert not tkv.is_quantized_kv(torch.int8)


@pytest.mark.parametrize("name", KV_NAMES + ["float32"])
def test_paged_write_and_gather_match_jax_with_dropped_rows(name):
    """Rows written through a page table, two of them dropped (the JAX
    out-of-range id ``num_pages`` with ``mode="drop"`` = the port's sink
    page), then gathered back dequantized: every usable page's payload
    bytes and scales equal the JAX pools', and the gathers agree."""
    num_pages, ps, kv_h, d = 5, 4, 2, 16
    dt = jnp.float32 if name == "float32" else name
    tdt = torch.float32 if name == "float32" else name
    jlayer = jkv.paged_pool_layer(num_pages, ps, kv_h, d, dt)
    tlayer = tkv.paged_pool_layer(num_pages, ps, kv_h, d, tdt)
    assert set(tlayer) == set(jlayer)
    assert tlayer["k_pages"].shape[0] == num_pages + 1      # + the sink
    assert tkv.kv_dtype_name(tlayer) == jkv.kv_dtype_name(jlayer) == name
    rng = np.random.default_rng(11)
    k = rng.normal(size=(6, kv_h, d)).astype(np.float32)
    v = rng.normal(size=(6, kv_h, d)).astype(np.float32)
    pages = np.array([3, 3, num_pages, 0, 4, num_pages], np.int32)
    offs = np.array([0, 1, 2, 3, 0, 1], np.int32)
    jlayer = jkv.paged_write(jlayer, jnp.asarray(pages), jnp.asarray(offs),
                             jnp.asarray(k), jnp.asarray(v))
    out = tkv.paged_write(tlayer, torch.from_numpy(pages).long(),
                          torch.from_numpy(offs).long(),
                          torch.from_numpy(k), torch.from_numpy(v))
    assert out is tlayer                                    # in place
    for key, leaf in tlayer.items():
        raw = leaf[:num_pages]
        if leaf.element_size() == 1:
            raw = raw.view(torch.uint8)
            want = np.asarray(jlayer[key]).view(np.uint8)
        else:
            want = np.asarray(jlayer[key])
        np.testing.assert_array_equal(raw.numpy(), want)
    pt = np.array([[3, 0], [4, 1]], np.int32)
    jk, jv = jkv.paged_gather(jlayer, jnp.asarray(pt), jnp.float32)
    tk, tv = tkv.paged_gather(tlayer, torch.from_numpy(pt).long(),
                              torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tkv.sink_page(tlayer) == num_pages


@pytest.mark.parametrize("name", KV_NAMES + ["bfloat16"])
def test_kv_page_bytes_equals_the_leaves_per_usable_page(name):
    dt = torch.bfloat16 if name == "bfloat16" else name
    jdt = jnp.bfloat16 if name == "bfloat16" else name
    layers = [tkv.paged_pool_layer(6, 8, 2, 16, dt) for _ in range(3)]
    per_page = sum(t[0].numel() * t.element_size()
                   for layer in layers for t in layer.values())
    assert tkv.kv_page_bytes(3, 2, 16, 8, dt) == per_page == \
        jkv.kv_page_bytes(3, 2, 16, 8, jdt)
    with pytest.raises(ValueError, match="unknown kv dtype"):
        tkv.kv_page_bytes(3, 2, 16, 8, "int4")
    with pytest.raises(ValueError, match="unknown quantized kv dtype"):
        tkv.kv_storage_dtype("int4")


# ------------------------------------- paged decode over quantized pools


@pytest.mark.parametrize("name", KV_NAMES)
@pytest.mark.parametrize("h,kv_h", [(4, 4), (4, 2), (8, 2), (64, 4),
                                    (64, 1)])
def test_paged_decode_quantized_matches_jax_kernel(h, kv_h, name):
    """The plain version with scale pools against the JAX quantized
    Pallas kernels in interpret mode: ``_paged_decode_kernel_quant``
    (MHA, h == kv_h) and ``_paged_decode_kernel_gqa(quantized=True)``,
    up to group 16 and MQA (group 64), every group the CUDA kernel takes;
    ragged positions 0, mid-page, a page boundary and the full table.
    fp32 compute, atol 1e-5 (same products, different summation order)."""
    slots, d, ps, maxp, num_pages = 4, 16, 8, 3, 10
    rng = np.random.default_rng(12)
    q = rng.normal(size=(slots, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(num_pages, ps, kv_h, d)).astype(np.float32)
    v = rng.normal(size=(num_pages, ps, kv_h, d)).astype(np.float32)
    pt = rng.integers(0, num_pages, (slots, maxp)).astype(np.int32)
    pos = np.array([0, ps // 2 + 1, ps, ps * maxp - 1], np.int32)
    kq, ks = tkv.quantize_kv_rows(torch.from_numpy(k), name)
    vq, vs = tkv.quantize_kv_rows(torch.from_numpy(v), name)
    jkq, jks = jkv.quantize_kv_rows(jnp.asarray(k), name)
    jvq, jvs = jkv.quantize_kv_rows(jnp.asarray(v), name)
    want = jdec.paged_decode_attention(
        jnp.asarray(q), jkq, jvq, jnp.asarray(pt), jnp.asarray(pos),
        force_kernel=True, k_scale=jks, v_scale=jvs)
    got = tdec.paged_decode_attention(
        torch.from_numpy(q), kq, vq, torch.from_numpy(pt),
        torch.from_numpy(pos), k_scale=ks, v_scale=vs)
    assert got.shape == (slots, 1, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # and the dequantized pools through the float path give the same
    deq = tdec.paged_decode_attention(
        torch.from_numpy(q), tkv.dequantize_kv_rows(kq, ks, torch.float32),
        tkv.dequantize_kv_rows(vq, vs, torch.float32),
        torch.from_numpy(pt), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), deq.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="come together"):
        tdec.paged_decode_attention(
            torch.from_numpy(q), kq, vq, torch.from_numpy(pt),
            torch.from_numpy(pos), k_scale=ks)


@pytest.mark.parametrize("kw,needle", [
    (dict(head_dim=24, storage_dtype=torch.int8), "multiple of 16"),
    (dict(head_dim=12), "multiple of 8"),
    (dict(head_dim=128, storage_dtype=torch.uint8), "storage dtype"),
])
def test_cuda_decision_depends_on_the_storage_dtype(kw, needle):
    """16-byte loads: head_dim % 8 for 2- and 4-byte elements, % 16 for a
    1-byte payload; a CUDA tensor the kernel does not take is refused,
    never sent to the plain version."""
    base = dict(device_type="cuda", num_heads=32, num_kv_heads=32,
                dtype=torch.bfloat16)
    dec = tdec.paged_kernel_decision(**{**base, **kw})
    assert dec["path"] == "unsupported" and needle in dec["reason"]
    ok = tdec.paged_kernel_decision(**base, head_dim=24)
    assert ok["path"] == "kernel"
    okq = tdec.paged_kernel_decision(**base, head_dim=128,
                                     storage_dtype=torch.int8)
    assert okq["path"] == "kernel" and "quantized" in okq["reason"]
    cpu = tdec.paged_kernel_decision(**{**base, "device_type": "cpu"},
                                     head_dim=24, storage_dtype=torch.int8)
    assert cpu["path"] == "reference"


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("m,k,n,g", [(1, 256, 64, 64), (4, 4096, 4096, 64),
                                     (5, 512, 200, 128), (64, 1024, 328, 32),
                                     (9, 384, 100, 64), (3, 64, 37, 64),
                                     (1, 11008, 37, 64), (64, 11008, 200, 32),
                                     (4, 480, 96, 48), (5, 400, 128, 40),
                                     (3, 256, 64, 8)])
def test_int8_matmul_kernel_matches_plain_on_card(cuda, m, k, n, g, dtype,
                                                  tol):
    """|kernel - plain| / max(1, |plain|) under the tolerance; n that is
    no multiple of 16 takes the ring's bound-checked loads, k = 11008
    splits unevenly, a group of 48 ends inside a stage, and groups of 40
    and 8 (no multiple of the mma's depth) take the FMA body in bf16."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, k, device=cuda, generator=gen).to(dtype)
    w = torch.randn(k, n, device=cuda, generator=gen) * 0.02
    q, s = tq.quantize(w, group_size=g)
    before = tkern.launch_counts()["int8_matmul_fwd"]
    got = tkern.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert tkern.launch_counts()["int8_matmul_fwd"] == before + 1
    want = tkern.int8_matmul_plain(x, q, s).float()
    err = ((got.float() - want).abs() / want.abs().clamp(min=1.0)).max()
    assert err.item() < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("k,n", [(11008, 4096), (4096, 11008)])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 200])
def test_int8_matmul_kernel_7b_shapes_on_card(cuda, m, k, n, dtype, tol):
    """Llama-2-7B's MLP shapes, group 64, at decode, prefill-chunk and
    larger m (200: four 64-row tiles, the last of 8 rows)."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, k, device=cuda, generator=gen).to(dtype)
    q, s = tq.quantize(torch.randn(k, n, device=cuda, generator=gen) * 0.02,
                       group_size=64)
    got = tkern.int8_matmul(x, q, s)
    want = tkern.int8_matmul_plain(x, q, s).float()
    err = ((got.float() - want).abs() / want.abs().clamp(min=1.0)).max()
    assert err.item() < tol


@pytest.mark.cuda
def test_int8_k_splits_run_on_card(cuda):
    """Split counts the host picks (1, 2, 3, 4, 6 and 8 blocks a cluster)
    launch and agree with the plain version."""
    seen = set()
    for n in (32768, 16384, 8192, 4096, 512, 128):
        for k in (4096, 384):
            splits = tkern.k_splits(k, n, 64)
            seen.add(splits)
            gen = torch.Generator(device=cuda).manual_seed(n + k)
            x = torch.randn(4, k, device=cuda, generator=gen).to(
                torch.bfloat16)
            q, s = tq.quantize(torch.randn(k, n, device=cuda, generator=gen),
                               group_size=64)
            got = tkern.int8_matmul(x, q, s).float()
            want = tkern.int8_matmul_plain(x, q, s).float()
            err = ((got - want).abs() / want.abs().clamp(min=1.0)).max()
            assert err.item() < 3e-2, (k, n, splits)
    assert seen >= {1, 2, 3, 4, 6, 8}, seen


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel_is_batch_invariant_on_card(cuda, dtype):
    """A row's result does not depend on m, on its place in the batch or
    on the run: one arithmetic for every m (fp32 FMAs; bf16 the same
    mma chain, whatever the number of 8-row blocks)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(64, 4096, device=cuda, generator=gen).to(dtype)
    q, s = tq.quantize(torch.randn(4096, 512, device=cuda, generator=gen),
                       group_size=64)
    full = tkern.int8_matmul(x, q, s)
    assert torch.equal(full, tkern.int8_matmul(x, q, s))
    for rows in (slice(0, 1), slice(0, 4), slice(7, 8), slice(13, 20),
                 slice(37, 38), slice(40, 57)):
        part = tkern.int8_matmul(x[rows].contiguous(), q, s)
        assert torch.equal(part, full[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("h,kv_h,d,ps", [(32, 32, 128, 16), (64, 8, 128, 16),
                                         (4, 2, 64, 8), (8, 8, 48, 32),
                                         (8, 1, 256, 16), (64, 4, 128, 16),
                                         (64, 2, 64, 16), (64, 1, 128, 32)])
def test_paged_quant_kernel_matches_plain_on_card(cuda, h, kv_h, d, ps, name,
                                                  dtype, atol):
    """Groups 1 to 32 and MQA; positions 0, around the first split
    boundary of the kernel, the table's last key and one past it; page 0
    (every unallocated table entry past a position) holds NaN payload and
    scales in the kernel's pools, so a read past the position shows."""
    maxp = 3 * -(-tdec.SPLIT_KEYS // ps) + 1
    sk = tdec.pages_per_split(ps, maxp) * ps
    pos = [0, sk - 2, sk - 1, sk, maxp * ps - 1, maxp * ps + 7]
    slots, num_pages = len(pos), len(pos) * maxp + 1
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(slots, 1, h, d, device=cuda, generator=gen).to(dtype)
    kq, ks = tkv.quantize_kv_rows(
        torch.randn(num_pages, ps, kv_h, d, device=cuda, generator=gen), name)
    vq, vs = tkv.quantize_kv_rows(
        torch.randn(num_pages, ps, kv_h, d, device=cuda, generator=gen), name)
    pt = (1 + torch.randperm(num_pages - 1, device=cuda, generator=gen)[
        :slots * maxp]).reshape(slots, maxp).to(torch.int32)
    for i, p in enumerate(pos):
        pt[i, p // ps + 1:] = 0
    pos = torch.tensor(pos, device=cuda, dtype=torch.int32)
    ks_nan, vs_nan = ks.clone(), vs.clone()
    ks_nan[0] = float("nan")
    vs_nan[0] = float("nan")
    before = tdec.launch_counts()["paged_decode_quant_fwd"]
    got = tdec.paged_decode_attention(q, kq, vq, pt, pos, k_scale=ks_nan,
                                      v_scale=vs_nan)
    torch.cuda.synchronize()
    assert tdec.launch_counts()["paged_decode_quant_fwd"] == before + 1
    want = tdec.paged_decode_attention_plain(q, kq, vq, pt, pos, k_scale=ks,
                                             v_scale=vs)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() < atol
