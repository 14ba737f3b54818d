"""Llama parity of the PyTorch port against the JAX model at
``llama_tiny`` size (2 layers, GQA 4/2, fp32).

The JAX ``Llama`` is initialised from a seed, its param tree unboxed to
numpy and carried into the port with ``llama_params_from_jax``; both then
see the same numpy inputs.  Tolerance: atol 1e-4 on fp32 logits (two
layers of matmuls and softmax summed in different orders).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.models import llama as tllama

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jmodel = jllama.Llama(jllama.llama_tiny())
    boxed = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = flax.core.meta.unbox(boxed)["params"]
    tmodel = tllama.Llama(tllama.llama_tiny())
    tmodel.load_state_dict(tllama.llama_params_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return jmodel, params, tmodel.eval()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_weight_carry_covers_every_parameter(models):
    jmodel, params, tmodel = models
    n_jax = sum(np.size(x) for x in jax.tree.leaves(params))
    n_port = sum(p.numel() for p in tmodel.parameters())
    assert n_jax == n_port
    np.testing.assert_array_equal(
        _np(tmodel.layers[1].attn.wq.weight),
        np.asarray(params["layers_1"]["attn"]["wq"]["kernel"]).T)


@torch.no_grad()
def test_no_cache_forward_logits(models):
    jmodel, params, tmodel = models
    ids = np.random.default_rng(0).integers(0, 256, (2, 13)).astype(np.int32)
    want = jmodel.apply({"params": params}, jnp.asarray(ids))
    got = tmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@torch.no_grad()
def test_dense_cache_prefill_then_decode_logits(models):
    jmodel, params, tmodel = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (2, 9)).astype(np.int32)
    jcache = jllama.init_kv_cache(jllama.llama_tiny(), 2, max_len=128,
                                  dtype=jnp.float32)
    tcache = tllama.init_kv_cache(cfg, 2, max_len=128, dtype=torch.float32)
    jl, jcache = jmodel.apply({"params": params}, jnp.asarray(ids),
                              cache=jcache)
    tl, tcache = tmodel(torch.from_numpy(ids).long(), cache=tcache)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jcache = jmodel.apply({"params": params}, jnp.asarray(tok),
                                  cache=jcache)
        tl, tcache = tmodel(torch.from_numpy(tok).long(), cache=tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    assert tcache["layers"][0]["index"] == 12


@torch.no_grad()
def test_paged_chunked_prefill_then_decode_logits(models):
    """Two slots prefill in chunks (one of them across a page boundary
    and a mid-page chunk end), then decode together; a third, vacant
    slot rides along inactive.  K/V rows land in the pages the table
    names and nowhere else."""
    jmodel, params, tmodel = models
    cfg = tmodel.cfg
    ps, maxp, num_pages, chunk = 8, 4, 9, 8
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (11, 5)]
    pt = np.zeros((3, maxp), np.int32)
    pt[0, :3] = [2, 5, 7]
    pt[1, :2] = [1, 6]
    jpools = jllama.init_paged_kv_cache(jllama.llama_tiny(), num_pages, ps,
                                        dtype=jnp.float32)
    tpools = tllama.init_paged_kv_cache(cfg, num_pages, ps,
                                        dtype=torch.float32)
    lengths = np.zeros(3, np.int32)
    for slot, prompt in enumerate(prompts):
        for start in range(0, len(prompt), chunk):
            piece = prompt[start:start + chunk]
            ids = np.zeros((1, chunk), np.int32)
            ids[0, :len(piece)] = piece
            jl, jc = jmodel.apply(
                {"params": params}, jnp.asarray(ids),
                cache=dict(jpools, page_table=jnp.asarray(pt),
                           lengths=jnp.asarray(lengths),
                           slot=jnp.int32(slot),
                           n_valid=jnp.int32(len(piece))))
            jpools = {"layers": jc["layers"]}
            tl, tc = tmodel(
                torch.from_numpy(ids).long(),
                cache=dict(tpools, page_table=torch.from_numpy(pt),
                           lengths=torch.from_numpy(lengths), slot=slot,
                           n_valid=len(piece)))
            np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
            np.testing.assert_array_equal(_np(tc["lengths"]),
                                          np.asarray(jc["lengths"]))
            lengths = _np(tc["lengths"]).copy()
    active = np.array([True, True, False])
    toks = np.array([3, 7, 0], np.int32)
    for _ in range(4):
        jl, jc = jmodel.apply(
            {"params": params}, jnp.asarray(toks)[:, None],
            cache=dict(jpools, page_table=jnp.asarray(pt),
                       lengths=jnp.asarray(lengths),
                       active=jnp.asarray(active)))
        jpools = {"layers": jc["layers"]}
        tl, tc = tmodel(torch.from_numpy(toks).long()[:, None],
                        cache=dict(tpools, page_table=torch.from_numpy(pt),
                                   lengths=torch.from_numpy(lengths),
                                   active=torch.from_numpy(active)))
        np.testing.assert_allclose(_np(tl)[active], np.asarray(jl)[active],
                                   atol=ATOL)
        lengths = _np(tc["lengths"]).copy()
        np.testing.assert_array_equal(lengths, np.asarray(jc["lengths"]))
        toks = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    # the port's pools hold the JAX pools' rows (its extra last page is
    # the drop sink), so inactive and padded writes went nowhere else
    for jl_, tl_ in zip(jpools["layers"], tpools["layers"]):
        np.testing.assert_allclose(_np(tl_["k_pages"])[:num_pages],
                                   np.asarray(jl_["k_pages"]), atol=ATOL)
        np.testing.assert_allclose(_np(tl_["v_pages"])[:num_pages],
                                   np.asarray(jl_["v_pages"]), atol=ATOL)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32)
    want = jllama.RMSNorm(1e-5).apply({"params": {"scale": scale}},
                                      jnp.asarray(x))
    norm = tllama.RMSNorm(64, 1e-5)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


@torch.no_grad()
def test_flash_no_cache_logits_match_jax_flash(models):
    """attn_impl="flash" on both sides: the JAX Pallas kernel in
    interpret mode, the port's flash path (its plain version on the
    CPU)."""
    _, params, tmodel = models
    jflash = jllama.Llama(jllama.llama_tiny(attn_impl="flash"))
    tflash = tllama.Llama(tllama.llama_tiny(attn_impl="flash"))
    tflash.load_state_dict(tmodel.state_dict())
    ids = np.random.default_rng(5).integers(0, 256, (2, 16)).astype(np.int32)
    want = jflash.apply({"params": params}, jnp.asarray(ids))
    got = tflash(torch.from_numpy(ids).long())
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@torch.no_grad()
def test_kernel_inject_serves_a_fresh_auto_module(models):
    """``kernel_inject=True`` (``replace_with_kernel_inject``): the engine
    serves a fresh module with ``attn_impl="auto"`` and the caller's
    weights; the caller's module keeps its config, dtype and values."""
    jmodel, params, tmodel = models
    model = tllama.Llama(tllama.llama_tiny(attn_impl="reference"))
    model.load_state_dict(tmodel.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    engines = [deepspeed_tpu_torch.init_inference(
        model, dtype=dtype, device="cpu", kernel_inject=True)
        for dtype in ("bfloat16", "float32")]
    for eng in engines:
        assert eng.module is not model
        assert eng.module.cfg.attn_impl == "auto"
    assert model.cfg.attn_impl == "reference"
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k
    ids = np.random.default_rng(6).integers(0, 256, (2, 13)).astype(np.int32)
    want = jmodel.apply({"params": params}, jnp.asarray(ids))
    np.testing.assert_allclose(_np(engines[1].forward(ids)), np.asarray(want),
                               atol=ATOL)
