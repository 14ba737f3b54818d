"""GPT-2-family serving through the port's engine and scheduler at
``gpt2_tiny`` size, fp32, for the six variants of
``tests/test_torch_gpt2_serving.py`` (their weights, redrawn from a seed,
are the JAX model's, carried with ``gpt2_params_from_jax``).

Oracles: greedy ``generate()`` token-exact against the JAX engine's
``generate()`` (the JAX scheduler's runs race, ROADMAP.md Queue C, so
they are no oracle here); the port's ``ServingScheduler`` token-exact
against the port's own ``generate()`` with recompute preemption, with
n-gram and self-draft speculative rounds and with prefix-cache hits,
every page back after the run; int8 weights (``quant``, group 32) where
the port's ``q`` / ``scale`` equal the JAX ``QTensor`` leaves bit for bit
and ``load_quantized_params_from_jax`` carries a quantized tree.  ALiBi
over pools takes the JAX route (gathered pages, then the dense kernel),
which the dispatch rule reports.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.quant import QTensor as JaxQTensor
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.attention import decode as tdec
from deepspeed_tpu_torch.serving import DraftModelDrafter, ServingScheduler
from test_torch_gpt2_serving import VARIANTS, jax_variant

EVICT = dict(num_slots=3, num_pages=4, page_size=8, max_pages_per_slot=4,
             prefill_chunk=8)
ROOMY = dict(num_slots=3, num_pages=24, page_size=8, max_pages_per_slot=8,
             prefill_chunk=8)
QUANT = {"enabled": True, "group_size": 32}
SERVED = [v for v in VARIANTS if v != "neo"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small CPU ops: beside
    the other test workers, torch's thread pool spends far more time
    waiting for cores than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_engine(name, params, **kw):
    eng = deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(tgpt2.gpt2_tiny(**VARIANTS[name])), dtype="float32",
        kv_cache_dtype="float32", device="cpu", **kw)
    return eng.set_params(tgpt2.gpt2_params_from_jax(params))


def jax_engine(jcfg, params, **kw):
    eng = deepspeed_tpu.init_inference(
        model=jgpt2.GPT2(jcfg), dtype="float32", kv_cache_dtype="float32",
        mesh={"data": 1, "model": 1}, **kw)
    return eng.set_params(params)


def generated(engine, prompts, max_new):
    return [[int(t) for t in engine.generate(p[None], max_new_tokens=m)[
        0, len(p):]] for p, m in zip(prompts, max_new)]


def served(sched, prompts, max_new):
    reqs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_new)]
    got = sched.run()
    assert all(r.state == "finished" for r in reqs)
    return [got[r.rid] for r in reqs]


@pytest.fixture(scope="module", params=list(VARIANTS))
def engines(request):
    jcfg, _, params = jax_variant(request.param, seed=1)
    return request.param, jcfg, params, port_engine(request.param, params)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, n).astype(np.int32)
            for n in (5, 11, 19, 7)], [10, 6, 9, 12]


def test_generate_token_exact_vs_jax_engine(engines):
    """Two prompts of 10 tokens, 14 new each (past the Neo window of 8),
    batched on both sides."""
    name, jcfg, params, teng = engines
    ids = np.random.default_rng(3).integers(0, 256, (2, 10)).astype(
        np.int32)
    want = np.asarray(jax_engine(jcfg, params).generate(
        ids, max_new_tokens=14))
    got = teng.generate(ids, max_new_tokens=14)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["evict", "ngram", "draft", "prefix"])
def test_scheduler_token_exact_vs_generate(engines, prompts, mode):
    """Paged continuous batching of every paged variant equals
    ``generate()``: over a 4-page pool that preempts, with n-gram and
    self-draft spec rounds over prompts that repeat themselves, and with
    prefix-cache hits over a shared 16-token prefix (donor first)."""
    name, _, params, teng = engines
    if name not in SERVED:
        with pytest.raises(NotImplementedError, match="local attn_windows"):
            ServingScheduler(teng, **ROOMY)
        return
    ps, mn = prompts
    kw = dict(EVICT if mode == "evict" else ROOMY)
    if mode in ("ngram", "draft"):
        # one step a dispatch, and a prompt of 100 distinct tokens: prompt
        # lookup finds the last token often even where random weights do
        # not repeat themselves
        rng = np.random.default_rng(7)
        base = rng.integers(0, 256, 3).astype(np.int32)
        ps = [np.tile(base, 5), np.tile(base[::-1], 4),
              rng.permutation(256)[:100].astype(np.int32)]
        mn = [12, 10, 12]
        kw.update(spec_k=4, decode_horizon_steps=1, num_pages=48,
                  max_pages_per_slot=16)
        if mode == "ngram":
            kw["spec_decode"] = "ngram"
        else:
            kw["spec_drafter"] = DraftModelDrafter(
                port_engine(name, params), num_slots=kw["num_slots"],
                num_pages=48, page_size=8)
    if mode == "prefix":
        prefix = np.random.default_rng(8).integers(0, 256, 16).astype(
            np.int32)
        ps = [np.concatenate([prefix, p]) for p in ps[:3]]
        mn = mn[:3]
        kw["prefix_cache"] = True
    sched = ServingScheduler(teng, **kw)
    if mode == "prefix":
        got = served(sched, ps[:1], mn[:1]) + served(sched, ps[1:], mn[1:])
    else:
        got = served(sched, ps, mn)
    assert got == generated(teng, ps, mn)
    s = sched.summary()
    if mode == "evict":
        assert s["preemptions"] > 0
    elif mode == "prefix":
        assert s["prefix_hits"] > 0 and s["prefill_tokens_saved"] >= 16
        sched.prefix_cache.evict(10 ** 6)
    else:
        assert s["spec_dispatches"] > 0 and s["spec_draft_tokens"] > 0
        if mode == "draft":
            assert kw["spec_drafter"].kv.pool.pages_in_use == 0
    assert sched.kv.pool.pages_in_use == 0


def test_int8_pools_serve_deterministically(engines, prompts):
    """Over int8 pools (payload and scale leaves) two schedulers emit the
    same streams, finish every request and give every page back (the
    pools' logits are held against the JAX model's in
    ``tests/test_torch_gpt2_serving.py``)."""
    name, _, _, teng = engines
    ps, mn = prompts
    if name not in SERVED:
        with pytest.raises(NotImplementedError, match="local attn_windows"):
            ServingScheduler(teng, kv_dtype="int8", **ROOMY)
        return
    runs = []
    for _ in range(2):
        sched = ServingScheduler(teng, kv_dtype="int8", **ROOMY)
        layer = sched.pools["layers"][0]
        assert layer["k_pages"].dtype == torch.int8 and "k_scale" in layer
        runs.append(served(sched, ps, mn))
        assert sched.kv.pool.pages_in_use == 0
    assert runs[0] == runs[1]
    assert [len(r) for r in runs[0]] == mn


def test_sampled_streams_invariant_under_eviction(engines, prompts):
    """The decoding-policy bodies over a GPT-2-family module: every
    sampled request draws from its own seeded stream, so its tokens are
    the same over a roomy pool and over a 4-page pool that preempts; the
    greedy rows beside them equal ``generate()``."""
    name, _, _, teng = engines
    if name not in SERVED:
        with pytest.raises(NotImplementedError, match="local attn_windows"):
            ServingScheduler(teng, **EVICT)
        return
    ps, mn = prompts
    policies = [None, dict(do_sample=True, temperature=0.8, top_k=50),
                dict(do_sample=True, temperature=1.1, top_p=0.9,
                     repetition_penalty=1.3), None]
    runs = []
    for kw in (ROOMY, EVICT):
        sched = ServingScheduler(teng, **kw)
        reqs = [sched.submit(p, max_new_tokens=m, sampling=pol,
                             seed=100 + i)
                for i, (p, m, pol) in enumerate(zip(ps, mn, policies))]
        got = sched.run()
        runs.append([got[r.rid] for r in reqs])
        assert sched.kv.pool.pages_in_use == 0
    assert runs[0] == runs[1] and sched.summary()["preemptions"] > 0
    want = generated(teng, ps, mn)
    assert [runs[0][i] for i in (0, 3)] == [want[i] for i in (0, 3)]


@pytest.mark.parametrize("name", ["gpt2", "gptj"])
def test_int8_weights_equal_the_jax_quantization(name, prompts):
    """Every GPT-2 ``QDense`` (qkv, proj, fc_in, fc_out and an untied
    lm_head) quantizes the same floats to the JAX ``QTensor``'s q and
    scale bit for bit; the tied head, embeddings and LayerNorms stay
    float; a quantized JAX tree loads as it is; greedy tokens equal the
    JAX int8 engine's."""
    jcfg, _, params = jax_variant(name, seed=2)
    jeng = jax_engine(jcfg, params, quant=QUANT)
    teng = port_engine(name, params, quant=QUANT)
    layers = dict(teng.module.named_modules())
    kernels = dict(tgpt2._dense_layers(jeng.params))
    assert len(kernels) == 8 + (name == "gptj")
    for lname, node in kernels.items():
        leaf, layer = node["kernel"], layers[lname]
        assert isinstance(leaf, JaxQTensor), lname
        assert layer.quantized and layer.weight is None
        np.testing.assert_array_equal(layer.q.numpy(), np.asarray(leaf.q))
        np.testing.assert_array_equal(layer.scale.numpy(),
                                      np.asarray(leaf.scale))
        assert ("bias" in node) == (layer.bias is not None)
    assert not any(isinstance(jeng.params[k], JaxQTensor)
                   for k in ("wte",) + (("wpe",) if "wpe" in params else ()))
    other = port_engine(name, params, quant=QUANT)
    tgpt2.load_quantized_params_from_jax(other.module, jax.tree.map(
        lambda x: x, jeng.params, is_leaf=lambda x: isinstance(
            x, JaxQTensor)))
    for (n, a), (_, b) in zip(other.module.state_dict().items(),
                              teng.module.state_dict().items()):
        assert torch.equal(a, b), n
    ps, mn = prompts
    want = generated(jeng, ps[:2], mn[:2])
    assert generated(teng, ps[:2], mn[:2]) == want
    assert generated(other, ps[:2], mn[:2]) == want
    model = tgpt2.GPT2(tgpt2.gpt2_tiny(**VARIANTS[name]))
    mixed = dict(params, h_0=dict(params["h_0"], attn=dict(
        params["h_0"]["attn"], qkv=jeng.params["h_0"]["attn"]["qkv"])))
    tgpt2.load_quantized_params_from_jax(model, mixed)
    assert model.h[0].attn.qkv.quantized and \
        not model.h[0].attn.proj.quantized
    with pytest.raises(ValueError, match="float kernel"):
        tgpt2.load_quantized_params_from_jax(other.module, params)


def test_alibi_over_pools_takes_the_gathered_dense_route():
    """The dispatch rule, as data: on a CUDA tensor an ALiBi bias over
    pools goes to ``decode_fwd`` over the gathered pages (the load rule is
    then the compute dtype's, so a quantized pool at head_dim 24 runs),
    never to the plain version; a CPU tensor runs the plain version and
    launches nothing."""
    base = dict(device_type="cuda", num_heads=16, num_kv_heads=16,
                dtype=torch.bfloat16)
    dec = tdec.paged_kernel_decision(head_dim=64, has_bias=True, **base)
    assert dec["path"] == "kernel" and "decode_fwd" in dec["reason"]
    assert tdec.paged_kernel_decision(
        head_dim=24, storage_dtype=torch.int8, **base)["path"] == \
        "unsupported"
    dec = tdec.paged_kernel_decision(head_dim=24, storage_dtype=torch.int8,
                                     has_bias=True, **base)
    assert dec["path"] == "kernel" and "dequantized" in dec["reason"]
    assert tdec.paged_kernel_decision(
        head_dim=264, has_bias=True, **base)["path"] == "unsupported"
    cpu = tdec.paged_kernel_decision(**{**base, "device_type": "cpu"},
                                     head_dim=64, has_bias=True)
    assert cpu["path"] == "reference"
    eng = deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(tgpt2.gpt2_tiny(**VARIANTS["bloom"])), device="cpu",
        dtype="float32").init_params(0)
    assert eng.paged_kernel_decision()["path"] == "reference"
    # the bias reaches the plain version: rows attend as slope x key
    # position over the gathered pages
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 16)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.normal(size=(5, 8, 4, 16)).astype(
        np.float32)) for _ in range(2))
    pt = torch.tensor([[3, 1], [0, 4]], dtype=torch.int32)
    pos = torch.tensor([9, 4], dtype=torch.int32)
    alibi = tgpt2.alibi_slopes(4)[None, :, None, None] * \
        torch.arange(16.0)[None, None, None, :]
    tdec.reset_launch_counts()
    got = tdec.paged_decode_attention(q, kp, vp, pt, pos, bias=alibi)
    assert not any(tdec.launch_counts().values())
    k_full, v_full = tdec.gather_pages(kp, pt.long()), \
        tdec.gather_pages(vp, pt.long())
    mask = torch.arange(16)[None, :] <= pos[:, None].long()
    bias = torch.where(mask, 0.0, torch.finfo(torch.float32).min)[
        :, None, None, :] + alibi
    want = tdec.decode_attention_plain(q, k_full, v_full, bias=bias)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, tdec.paged_decode_attention(q, kp, vp, pt,
                                                            pos))


def test_engine_serves_gpt2_and_refuses_other_modules():
    """init_params draws the flax initializers of the GPT-2 family;
    page bytes count one kv head per query head; a module of another
    family raises naming the HF-ingestion route."""
    cfg = tgpt2.gpt2_tiny(**VARIANTS["gptj"])
    e1, e2 = (deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(cfg), dtype="float32", device="cpu").init_params(3)
        for _ in range(2))
    for (n, a), (_, b) in zip(e1.module.state_dict().items(),
                              e2.module.state_dict().items()):
        assert torch.equal(a, b), n
    m = e1.module
    assert torch.equal(m.h[0].ln_1.weight, torch.ones(64))
    assert not m.lm_head.bias.any() and m.h[0].attn.qkv.bias is None
    assert abs(float(m.lm_head.weight.std()) - 0.02) < 3e-3
    # K and V, 2 layers, 8 rows, 4 heads of 16, bf16 (the default)
    assert e1.kv_page_bytes(8) == 2 * 2 * 8 * 4 * 16 * 2
    with pytest.raises(NotImplementedError, match="from_hf"):
        deepspeed_tpu_torch.init_inference(torch.nn.Linear(2, 2),
                                           device="cpu")
