"""GPT-2-family parity of the PyTorch port's model against the JAX
``GPT2`` at ``gpt2_tiny`` size (2 layers, hidden 64, 4 heads of 16,
vocab 256), fp32, for six variants of the config:

* ``gpt2``  — learned positions, tied head (HF GPT-2);
* ``bloom`` — ALiBi, embedding LayerNorm, no position table (BLOOM);
* ``gptj``  — interleaved partial rotary (8 of 16 dims), parallel
  residual off one LayerNorm, unbiased attention, an untied head with a
  bias (GPT-J);
* ``neox``  — NeoX partial rotary (4 of 16), parallel residual, exact
  GELU, an untied unbiased head (GPT-NeoX / Pythia);
* ``opt``   — ReLU, positions stored at index + 2 (OPT);
* ``neo``   — a global and a local (window 8) layer, unbiased qkv
  (GPT-Neo).

The JAX model is initialised, then every leaf is redrawn from a seeded
numpy generator (biases and LayerNorm parameters non-trivial), carried
into the port with ``gpt2_params_from_jax``, and both sides see the
same numpy inputs: the forward without a cache, the dense cache of
``generate()`` (prefill then decode), and the paged pools over float32
and int8 (chunked prefill of two slots, continuous-batch decode with a
vacant slot, a ``widths`` verify round).  The JAX functions are jitted.
GPT-Neo's local window is refused over pools, as in the JAX model
(``tests/test_torch_train.py::test_local_windows_over_pools_are_refused``),
so its paged case is not run.

Tolerance: atol 1e-4 on fp32 logits, as in ``tests/test_torch_llama.py``
(two layers of matmuls and softmax summed in different orders).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.attention import reference as tref

ATOL = 1e-4
VARIANTS = {
    "gpt2": {},
    "bloom": dict(pos_embed="none", use_alibi=True, embed_layernorm=True),
    "gptj": dict(pos_embed="none", rotary_dim=8, rotary_interleaved=True,
                 parallel_residual=True, single_ln=True, attn_bias=False,
                 tie_embeddings=False, lm_head_bias=True),
    "neox": dict(pos_embed="none", rotary_dim=4, parallel_residual=True,
                 activation="gelu_exact", tie_embeddings=False),
    "opt": dict(activation="relu", pos_offset=2),
    "neo": dict(qkv_bias=False, attn_windows=(0, 8)),
}
PAGED = [v for v in VARIANTS if v != "neo"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small CPU ops: beside
    the other test workers, torch's thread pool spends far more time
    waiting for cores than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomized(params, seed):
    """Every leaf redrawn: LayerNorm scales 1 + N(0, 0.1), biases
    N(0, 0.1), kernels and embeddings N(0, 0.15)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        std, mean = {"scale": (0.1, 1.0), "bias": (0.1, 0.0)}.get(
            name, (0.15, 0.0))
        return (mean + std * rng.standard_normal(np.shape(x))).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def jax_variant(name, seed=0):
    """(JAX config, jitted apply, randomized numpy params) of a variant."""
    cfg = jgpt2.gpt2_tiny(**VARIANTS[name])
    model = jgpt2.GPT2(cfg)
    boxed = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = randomized(jax.tree.map(
        np.asarray, flax.core.meta.unbox(boxed)["params"]), seed)

    @jax.jit
    def apply(p, ids, cache=None):
        return model.apply({"params": p}, ids, cache=cache)
    return cfg, apply, params


def port_variant(name, params):
    model = tgpt2.GPT2(tgpt2.gpt2_tiny(**VARIANTS[name]))
    model.load_state_dict(tgpt2.gpt2_params_from_jax(params), strict=True)
    return model.eval()


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    jcfg, apply, params = jax_variant(request.param)
    return request.param, jcfg, apply, params, port_variant(request.param,
                                                            params)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_weight_carry_covers_every_leaf(variant):
    name, _, _, params, model = variant
    state = tgpt2.gpt2_params_from_jax(params)
    leaves = jax.tree.leaves(params)
    assert len(leaves) == len(state) == len(model.state_dict())
    assert sum(np.size(x) for x in leaves) == \
        sum(p.numel() for p in model.parameters())
    layer = params["h_1"]
    np.testing.assert_array_equal(_np(model.h[1].attn.qkv.weight),
                                  layer["attn"]["qkv"]["kernel"].T)
    cfg = model.cfg
    assert ("bias" in layer["attn"]["qkv"]) == \
        (model.h[1].attn.qkv.bias is not None)
    assert ("bias" in layer["attn"]["proj"]) == \
        (model.h[1].attn.proj.bias is not None)
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    assert ("ln_2" in layer) == hasattr(model.h[1], "ln_2")
    if "wpe" in params:
        assert params["wpe"].shape[0] == cfg.max_seq_len + cfg.pos_offset
    if name == "gptj":
        np.testing.assert_array_equal(_np(model.lm_head.bias),
                                      params["lm_head"]["bias"])
    if name == "bloom":
        np.testing.assert_array_equal(_np(model.ln_embed.weight),
                                      params["ln_embed"]["scale"])


@torch.no_grad()
def test_no_cache_logits_match_jax(variant):
    _, _, apply, params, model = variant
    ids = np.random.default_rng(0).integers(0, 256, (2, 13)).astype(np.int32)
    want = apply(params, jnp.asarray(ids))
    got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@torch.no_grad()
def test_dense_cache_prefill_then_decode_logits(variant):
    """Prefill 9 tokens then decode 4 (positions past the Neo window of
    8), both sides over a 128-position float32 cache."""
    _, jcfg, apply, params, model = variant
    ids = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(np.int32)
    jcache = jgpt2.init_kv_cache(jcfg, 2, max_len=128, dtype=jnp.float32)
    tcache = tgpt2.init_kv_cache(model.cfg, 2, max_len=128,
                                 dtype=torch.float32)
    jl, jcache = apply(params, jnp.asarray(ids), jcache)
    tl, tcache = model(torch.from_numpy(ids).long(), cache=tcache)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jcache = apply(params, jnp.asarray(tok), jcache)
        tl, tcache = model(torch.from_numpy(tok).long(), cache=tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    assert tcache["layers"][0]["index"] == 13


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("name", PAGED)
@torch.no_grad()
def test_paged_prefill_decode_and_verify_logits(name, kv):
    """Two slots prefill in chunks of 8 (one across a page boundary and a
    mid-page chunk end), decode three steps beside a vacant slot, then
    one ``widths`` verify round (3 columns, slot widths 3 / 1 / 0); the
    logits of every live row, the lengths, and the pools (the port's last
    page is the drop sink) agree with the JAX model's."""
    jcfg, apply, params = jax_variant(name)
    model = port_variant(name, params)
    ps, maxp, num_pages, chunk = 8, 4, 9, 8
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (11, 5)]
    pt = np.zeros((3, maxp), np.int32)
    pt[0, :3] = [2, 5, 7]
    pt[1, :2] = [1, 6]
    dtype = kv if kv == "int8" else jnp.float32
    jpools = jgpt2.init_paged_kv_cache(jcfg, num_pages, ps, dtype=dtype)
    tpools = tgpt2.init_paged_kv_cache(
        model.cfg, num_pages, ps, dtype=kv if kv == "int8" else torch.float32)
    lengths = np.zeros(3, np.int32)

    def step(ids, **keys):
        jl, jc = apply(params, jnp.asarray(ids), dict(
            jpools, page_table=jnp.asarray(pt), lengths=jnp.asarray(lengths),
            **{k: jnp.asarray(v) for k, v in keys.items()}))
        tl, tc = model(torch.from_numpy(ids).long(), cache=dict(
            tpools, page_table=torch.from_numpy(pt),
            lengths=torch.from_numpy(lengths),
            **{k: v if isinstance(v, int) else torch.from_numpy(v)
               for k, v in keys.items()}))
        np.testing.assert_array_equal(_np(tc["lengths"]),
                                      np.asarray(jc["lengths"]))
        return np.asarray(jl), _np(tl), {"layers": jc["layers"]}, \
            _np(tc["lengths"]).copy()

    for slot, prompt in enumerate(prompts):
        for start in range(0, len(prompt), chunk):
            piece = prompt[start:start + chunk]
            ids = np.zeros((1, chunk), np.int32)
            ids[0, :len(piece)] = piece
            jl, tl, jpools, lengths = step(ids, slot=slot,
                                           n_valid=len(piece))
            np.testing.assert_allclose(tl, jl, atol=ATOL)
    active = np.array([True, True, False])
    toks = np.array([3, 7, 0], np.int32)
    for _ in range(3):
        jl, tl, jpools, lengths = step(toks[:, None], active=active)
        np.testing.assert_allclose(tl[active], jl[active], atol=ATOL)
        toks = jl[:, 0].argmax(-1).astype(np.int32)
    widths = np.array([3, 1, 0], np.int32)
    ids = np.concatenate([toks[:, None], rng.integers(0, 256, (3, 2))],
                         axis=1).astype(np.int32)
    jl, tl, jpools, _ = step(ids, widths=widths)
    for s, w in enumerate(widths):
        np.testing.assert_allclose(tl[s, :w], jl[s, :w], atol=ATOL)
    for jl_, tl_ in zip(jpools["layers"], tpools["layers"]):
        for leaf in tl_:
            got = _np(tl_[leaf])[:num_pages]
            want = np.asarray(jl_[leaf])
            if kv == "int8" and leaf.endswith("pages"):
                # a row's int8 rounding may differ by one step where the
                # two sides' fp32 K/V differ in the last bit
                assert np.abs(got.astype(np.int32) -
                              want.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, atol=ATOL)


def test_alibi_slopes_match_jax():
    """Power-of-two head counts and the interleaved closed form of the
    others (BLOOM-176B has 112 heads), bit for bit."""
    for h in (1, 4, 12, 16, 32, 112):
        np.testing.assert_array_equal(_np(tgpt2.alibi_slopes(h)),
                                      np.asarray(jgpt2.alibi_slopes(h)))


@pytest.mark.parametrize("interleaved", [False, True])
def test_partial_rotary_matches_jax(interleaved):
    from deepspeed_tpu.ops.attention import reference as jref
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5))
    want = jref.apply_partial_rotary(jnp.asarray(x), jnp.asarray(pos), 8,
                                     base=10000.0, interleaved=interleaved)
    got = tref.apply_partial_rotary(torch.from_numpy(x),
                                    torch.from_numpy(pos), 8,
                                    interleaved=interleaved)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(_np(got)[..., 8:], x[..., 8:])
