"""Quantized serving of the PyTorch port against the JAX package at
``llama_tiny`` size (2 layers, GQA 4/2): weight-only int8 (``quant``,
group size 32) and int8 / fp8 paged KV, fp32 compute.

Both engines start from the same float weights (the JAX engine's seeded
init, carried across with ``llama_params_from_jax``) and each quantizes
on its own side: the port's ``q`` / ``scale`` must equal the JAX
``QTensor`` leaves bit for bit, prefill boundary logits agree within
1e-4 (fp32; the JAX CPU path multiplies by the dequantized weight, the
port sums group partials, so the sums differ in order), and the
continuous-batching schedulers emit the same tokens, with eviction
forced too.  The JAX engine stages copies of its host arrays, as
``tests/test_torch_serving.py`` does (ROADMAP.md Queue C).
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.config import \
    DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.models.llama import Llama as JaxLlama
from deepspeed_tpu.models.llama import llama_tiny as jax_llama_tiny
from deepspeed_tpu.ops.quant import QTensor as JaxQTensor
from deepspeed_tpu.ops.quant.kv import fp8_supported
from deepspeed_tpu.serving import ServingScheduler as JaxScheduler
from deepspeed_tpu.serving.page_manager import PagedKVManager
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.models.llama import (Llama, llama_params_from_jax,
                                              llama_tiny,
                                              load_quantized_params_from_jax)
from deepspeed_tpu_torch.ops.quant.qdense import QDense
from deepspeed_tpu_torch.ops.quant.quantizer import dequantize_tree
from deepspeed_tpu_torch.serving import ServingScheduler

QUANT = {"enabled": True, "group_size": 32}
EVICT = dict(num_slots=3, num_pages=4, page_size=8, max_pages_per_slot=4,
             prefill_chunk=8)
ROOMY = dict(num_slots=3, num_pages=16, page_size=8, max_pages_per_slot=8,
             prefill_chunk=8)
FP8 = pytest.mark.skipif(
    not (fp8_supported() and hasattr(torch, "float8_e4m3fn")),
    reason="needs float8_e4m3fn in jax and torch")


def _jax_engine(**kw):
    eng = deepspeed_tpu.init_inference(
        model=JaxLlama(jax_llama_tiny()), dtype="float32",
        mesh={"data": 1, "model": 1}, **kw)
    stage = eng._stage_host_inputs
    eng._stage_host_inputs = lambda triples: stage(
        [(np.array(x) if isinstance(x, np.ndarray) else x, dt, sh)
         for x, dt, sh in triples])
    return eng


def _port_engine(floats, **kw):
    eng = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny()), dtype="float32", device="cpu", **kw)
    return eng.set_params(llama_params_from_jax(floats))


@pytest.fixture(scope="module")
def engines():
    """(float tree, JAX int8 + int8-KV engine, its port counterpart)."""
    jfloat = _jax_engine(kv_cache_dtype="float32")
    jfloat.init_params()
    floats = jax.tree.map(np.asarray, jfloat.params)
    jeng = _jax_engine(quant=QUANT, kv_cache_dtype="int8")
    jeng.init_params()                    # the same seed, then quantized
    teng = _port_engine(floats, quant=QUANT, kv_cache_dtype="int8")
    return floats, jeng, teng


def _generate(engine, prompts, max_new):
    return [[int(t) for t in engine.generate(p[None], max_new_tokens=m)[
        0, len(p):]] for p, m in zip(prompts, max_new)]


def _serve(sched, prompts, max_new):
    reqs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_new)]
    got = sched.run()
    return [got[r.rid] for r in reqs]


def _requests(seed, lens, max_new):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens], \
        list(max_new)


def _jax_kernels(tree):
    """{port layer name: JAX kernel leaf} of every projection."""
    out = {"lm_head": tree["lm_head"]["kernel"]}
    for i in range(2):
        for group, names in (("attn", ("wq", "wk", "wv", "wo")),
                             ("mlp", ("w_gate", "w_up", "w_down"))):
            for name in names:
                out[f"layers.{i}.{group}.{name}"] = \
                    tree[f"layers_{i}"][group][name]["kernel"]
    return out


# ------------------------------------------------------------ the weights


def test_port_quantizes_the_same_floats_to_the_jax_qtensors(engines):
    """Every ``QDense`` (lm_head included) holds the JAX ``QTensor``'s q
    and scale bit for bit; the embedding and the norms stay float."""
    _, jeng, teng = engines
    layers = dict(teng.module.named_modules())
    kernels = _jax_kernels(jeng.params)
    assert len(kernels) == 15
    for name, leaf in kernels.items():
        assert isinstance(leaf, JaxQTensor), name
        layer = layers[name]
        assert layer.quantized and layer.weight is None
        np.testing.assert_array_equal(layer.q.numpy(), np.asarray(leaf.q))
        np.testing.assert_array_equal(layer.scale.numpy(),
                                      np.asarray(leaf.scale))
        assert (layer.bits, layer.group_size, layer.qdtype) == \
            (8, 32, torch.float32)
        assert layer.kernel.nbytes == leaf.nbytes
    assert not isinstance(jeng.params["embed_tokens"], JaxQTensor)
    assert teng.module.embed_tokens.weight.dtype == torch.float32
    assert [n for n, _ in teng.module.named_parameters()] == [
        "embed_tokens.weight", "layers.0.input_norm.scale",
        "layers.0.post_attn_norm.scale", "layers.1.input_norm.scale",
        "layers.1.post_attn_norm.scale", "norm.scale"]
    assert teng.weight_dtype_name == jeng.weight_dtype_name == "int8"


def test_jax_quantized_tree_loads_into_the_port(engines):
    """The bridge for a tree that already holds ``QTensor`` leaves: the
    JAX engine's own quantized weights, loaded as they are, give the
    tokens of the port's own quantization."""
    floats, jeng, teng = engines
    other = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny()), dtype="float32", quant=QUANT,
        kv_cache_dtype="float32", device="cpu")
    load_quantized_params_from_jax(other.module, jeng.params)
    for (name, a), (_, b) in zip(other.module.named_buffers(),
                                 teng.module.named_buffers()):
        assert torch.equal(a, b), name
    prompts, max_new = _requests(3, (5, 11), (8, 6))
    assert _generate(other, prompts, max_new) == \
        _generate(teng, prompts, max_new)
    mixed = dict(floats, lm_head=jeng.params["lm_head"])
    model = Llama(llama_tiny())
    load_quantized_params_from_jax(model, mixed)
    assert model.lm_head.quantized and not model.layers[0].attn.wq.quantized
    with pytest.raises(ValueError, match="float kernel"):
        load_quantized_params_from_jax(other.module, floats)


# --------------------------------------------------- logits and the tokens


def test_prefill_boundary_logits_match_jax(engines):
    """One 40-token sequence teacher-forced through chunked prefill into
    int8 pools on both sides (the shape of the JAX package's
    ``test_int8_teacher_forced_logit_delta_pinned``): every boundary
    logit row within 1e-4, and the port's int8-pool logits within the JAX
    package's own pinned ceiling (0.5) of its float32-pool logits."""
    _, jeng, teng = engines
    seq = np.random.default_rng(42).integers(0, 256, 40).astype(np.int32)
    cfg = dict(num_pages=8, page_size=8, num_slots=2, max_pages_per_slot=6)
    runs = {}
    for label, eng, kvd in (("jax", jeng, "int8"), ("port", teng, "int8"),
                            ("port_f32", teng, "float32")):
        pools = eng.init_paged_cache(cfg["num_pages"], cfg["page_size"],
                                     kv_dtype=kvd)
        kvm = PagedKVManager(cfg["num_pages"], cfg["page_size"],
                             cfg["num_slots"], cfg["max_pages_per_slot"])
        assert kvm.ensure_capacity(0, len(seq))
        lengths = np.zeros(cfg["num_slots"], np.int32)
        rows = []
        for c0 in range(0, len(seq), 8):
            ids = np.zeros((1, 8), np.int32)
            n = min(8, len(seq) - c0)
            ids[0, :n] = seq[c0:c0 + n]
            logits, pools = eng.prefill_into_slots(
                ids, 0, n, np.array(kvm.table), np.array(lengths), pools)
            lengths[0] += n
            rows.append(np.asarray(logits, np.float32))
        runs[label] = np.stack(rows)
    np.testing.assert_allclose(runs["port"], runs["jax"], atol=1e-4)
    assert np.abs(runs["port"] - runs["port_f32"]).max() < 0.5
    assert (runs["port"].argmax(-1) == runs["jax"].argmax(-1)).all()


@pytest.mark.parametrize("sched_kw", [EVICT, ROOMY], ids=["evict", "roomy"])
def test_scheduler_int8_token_exact_vs_jax(engines, sched_kw):
    """int8 weights + int8 KV: the port's scheduler emits the JAX
    scheduler's tokens; the 4-page pool forces recompute preemption."""
    _, jeng, teng = engines
    prompts, max_new = _requests(1, (12, 7, 12), (10, 12, 8))
    want = _serve(JaxScheduler(jeng, **sched_kw), prompts, max_new)
    tsched = ServingScheduler(teng, **sched_kw)
    assert _serve(tsched, prompts, max_new) == want
    if sched_kw is EVICT:
        assert tsched.metrics.preemptions > 0, \
            "pool was sized to force eviction; none happened"
    assert tsched.kv.pool.pages_in_use == 0
    layer = tsched.pools["layers"][0]
    assert set(layer) == {"k_pages", "v_pages", "k_scale", "v_scale"}
    assert layer["k_pages"].dtype == torch.int8
    assert layer["k_scale"].shape == (sched_kw["num_pages"] + 1, 8, 2, 1)


@pytest.mark.parametrize("kv", [pytest.param("fp8", marks=FP8), "int8",
                                "float32"])
def test_scheduler_kv_dtype_per_scheduler_vs_jax(engines, kv):
    """``kv_dtype=`` overrides the engine's kv dtype for one scheduler,
    on both sides; deterministic across two runs."""
    _, jeng, teng = engines
    prompts, max_new = _requests(2, (5, 11, 20, 9), (8, 6, 5, 7))
    want = _serve(JaxScheduler(jeng, kv_dtype=kv, **ROOMY), prompts,
                  max_new)
    first = ServingScheduler(teng, kv_dtype=kv, **ROOMY)
    got = _serve(first, prompts, max_new)
    assert got == want
    assert got == _serve(ServingScheduler(teng, kv_dtype=kv, **ROOMY),
                         prompts, max_new)
    assert first.summary()["kv_dtype"] == first.kv_dtype_name == kv


def test_int8_weights_with_float_kv_equal_generate(engines):
    """Weight-only int8 with float32 KV is exact arithmetic on one set of
    weights: the port's serving equals its own ``generate()`` — and the
    JAX package's — token for token, with eviction forced."""
    floats, jeng, _ = engines
    teng = _port_engine(floats, quant=QUANT, kv_cache_dtype="float32")
    prompts, max_new = _requests(4, (12, 7, 12), (10, 12, 8))
    want = _generate(teng, prompts, max_new)
    sched = ServingScheduler(teng, **EVICT)
    assert _serve(sched, prompts, max_new) == want
    assert sched.metrics.preemptions > 0
    assert want == _generate(jeng, prompts, max_new)
    s = sched.summary()
    assert (s["weight_dtype"], s["kv_dtype"]) == ("int8", "float32")


def test_generate_dense_cache_is_float32_under_quantized_kv(engines):
    """A quantized kv dtype applies to the paged pools only: ``generate``
    stays the float32 oracle."""
    floats, _, teng = engines
    ref = _port_engine(floats, quant=QUANT, kv_cache_dtype="float32")
    prompts, max_new = _requests(5, (9, 17), (12, 12))
    assert _generate(teng, prompts, max_new) == \
        _generate(ref, prompts, max_new)


def test_bf16_compute_int8_serving_is_deterministic(engines):
    """``dtype="int8"``: bf16 compute over int8 weights and int8 KV.  Two
    runs give the same tokens; bf16 agreement with fp32 is not asserted."""
    floats, _, _ = engines
    eng = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny()), dtype="int8", kv_cache_dtype="int8",
        quant={"group_size": 32}, device="cpu")
    eng.set_params(llama_params_from_jax(floats))
    assert eng.dtype == torch.bfloat16 and eng.kv_dtype == "int8"
    assert eng.module.lm_head.qdtype == torch.bfloat16
    assert eng.module.embed_tokens.weight.dtype == torch.bfloat16
    prompts, max_new = _requests(6, (5, 11, 20), (6, 6, 6))
    got = _serve(ServingScheduler(eng, **ROOMY), prompts, max_new)
    assert got == _serve(ServingScheduler(eng, **ROOMY), prompts, max_new)
    assert all(len(g) == 6 for g in got)


# ------------------------------------------------------ config and surface


def test_config_knobs_are_independent():
    c = DeepSpeedInferenceConfig(dtype="int8")
    assert (c.dtype, c.quant.enabled, c.quant.group_size, c.quant.num_bits,
            c.kv_cache_dtype) == ("bfloat16", True, 64, 8, "bfloat16")
    c = DeepSpeedInferenceConfig(dtype="torch.int8", quant={"group_size": 32})
    assert c.quant.enabled and c.quant.group_size == 32
    c = DeepSpeedInferenceConfig(dtype="fp32", quant={"enabled": True})
    assert (c.dtype, c.quant.enabled) == ("float32", True)
    c = DeepSpeedInferenceConfig(kv_cache_dtype="int8")
    assert (c.dtype, c.quant.enabled, c.kv_cache_dtype) == \
        ("bfloat16", False, "int8")
    for alias in ("fp8", "float8", "float8_e4m3fn", "torch.float8_e4m3fn"):
        assert DeepSpeedInferenceConfig(
            kv_cache_dtype=alias).kv_cache_dtype == "fp8"
    assert DeepSpeedInferenceConfig(kv_cache_dtype="bf16").kv_cache_dtype \
        == "bfloat16"
    for bad in (dict(kv_cache_dtype="int4"), dict(dtype="int4"),
                dict(quant={"num_bits": 3}), dict(quant={"bogus": 1})):
        with pytest.raises(ValueError):
            DeepSpeedInferenceConfig(**bad)
    jc = JaxInferenceConfig(dtype="int8")
    assert (jc.dtype, jc.quant.enabled, jc.quant.group_size) == \
        ("bfloat16", True, 64)


def test_init_paged_cache_kv_dtype_names(engines):
    _, jeng, teng = engines
    for name, dtype in (("float32", torch.float32), ("int8", torch.int8),
                        (None, torch.int8), (torch.bfloat16, torch.bfloat16)):
        pools = teng.init_paged_cache(4, 8, kv_dtype=name)
        assert pools["layers"][0]["k_pages"].dtype == dtype
        assert len(pools["layers"]) == 2
    with pytest.raises(ValueError, match="unsupported kv_dtype 'int4'"):
        teng.init_paged_cache(4, 8, kv_dtype="int4")
    with pytest.raises(ValueError, match="unsupported kv_dtype"):
        jeng.init_paged_cache(4, 8, kv_dtype="int4")
    with pytest.raises(ValueError, match="unsupported kv_dtype"):
        ServingScheduler(teng, kv_dtype="int4", **ROOMY)
    for kv in ("int8", "fp8", "float32", "bfloat16", None):
        assert teng.kv_page_bytes(8, kv_dtype=kv) == \
            jeng.kv_page_bytes(8, kv_dtype=kv)
    assert teng.kv_page_bytes(8) == 2 * 2 * 8 * 2 * (16 + 4)


def test_summary_reports_dtypes_and_pool_bytes(engines):
    _, _, teng = engines
    sched = ServingScheduler(teng, **ROOMY)
    s = sched.summary()
    leaves = sum(t.numel() * t.element_size()
                 for layer in sched.pools["layers"] for t in layer.values())
    assert s["kv_pool_bytes_total"] == leaves == \
        (ROOMY["num_pages"] + 1) * teng.kv_page_bytes(ROOMY["page_size"])
    assert (s["kv_dtype"], s["weight_dtype"]) == ("int8", "int8")
    assert s["paged_attention"]["path"] == "reference"
    dec = teng.paged_kernel_decision(pools=sched.pools)
    assert dec == teng.paged_kernel_decision()


def test_cpu_engine_still_refuses_a_forced_kernel():
    with pytest.raises(ValueError, match="paged_kernel='force'"):
        deepspeed_tpu_torch.init_inference(
            Llama(llama_tiny()), dtype="int8", kv_cache_dtype="int8",
            device="cpu", paged_kernel="force")


def test_init_params_requantizes_and_restores_the_parameter_order():
    """``init_params`` on a quantized engine draws fresh floats in the
    module's original parameter order (so a seed gives the same weights
    quantized or not), then quantizes; a float engine refuses a module
    that still holds int8 weights."""
    model = Llama(llama_tiny())
    names = [n for n, _ in model.named_parameters()]
    qeng = deepspeed_tpu_torch.init_inference(
        model, dtype="float32", quant=QUANT, kv_cache_dtype="float32",
        device="cpu")
    assert all(m.quantized for m in model.modules() if isinstance(m, QDense))
    qeng.init_params(7)
    q_first = model.lm_head.q.clone()
    qeng.init_params(7)
    assert torch.equal(model.lm_head.q, q_first)
    kept = qeng.init_params(7, quantize=False)
    assert kept is qeng and not model.lm_head.quantized
    assert [n for n, _ in model.named_parameters()] == names
    feng = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny()), dtype="float32", kv_cache_dtype="float32",
        device="cpu").init_params(7)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              feng.module.named_parameters()):
        assert torch.equal(a, b), n
    qeng.init_params(7)
    with pytest.raises(ValueError, match="holds int8 weights"):
        deepspeed_tpu_torch.init_inference(model, dtype="float32",
                                           device="cpu")
    dequantize_tree(model)
    deepspeed_tpu_torch.init_inference(model, dtype="float32", device="cpu")
