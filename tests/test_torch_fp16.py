"""float16 serving in the port against the JAX package at ``llama_tiny``
and ``gpt2_tiny`` size, on the CPU.

Both engines compute in float16 from the same weights (the JAX engine's
seeded fp32 init, carried with ``llama_params_from_jax`` /
``gpt2_params_from_jax``).  The JAX paged attention runs its Pallas
kernels in interpret mode (``paged_kernel="force"``) where the pools are
float16 or int8; the port runs its plain versions (CPU tensors).
Oracles: teacher-forced boundary logits of a 40-token chunked prefill
into float16, int8 and bfloat16 pools, and with int8 weights, within
2e-3 of the JAX engine's and with the same argmax (the logits are below
1 in magnitude, where one float16 rounding is at most 4.9e-4: 2e-3 is
four roundings of the summed differences); no-cache forward logits
likewise; the port's scheduler token-exact against its own
``generate()``; the kernel decisions take float16 on a CUDA device; an
HF directory saved in float16 serves at ``dtype="float16"``.
"""

import os

os.environ.setdefault("USE_TF", "0")         # transformers without TF

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.models import gpt2 as jgpt2  # noqa: E402
from deepspeed_tpu.models.llama import Llama as JaxLlama  # noqa: E402
from deepspeed_tpu.models.llama import \
    llama_tiny as jax_llama_tiny  # noqa: E402
from deepspeed_tpu.serving.page_manager import PagedKVManager  # noqa: E402
from deepspeed_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from deepspeed_tpu_torch.models.llama import (  # noqa: E402
    Llama, llama_params_from_jax, llama_tiny)
from deepspeed_tpu_torch.ops.attention import decode as tdec  # noqa: E402
from deepspeed_tpu_torch.ops.attention import flash as tflash  # noqa: E402
from deepspeed_tpu_torch.ops.quant import kernels as tkern  # noqa: E402
from deepspeed_tpu_torch.serving import ServingScheduler  # noqa: E402

ATOL = 2e-3
QUANT = {"enabled": True, "group_size": 32}
JAX_MESH = {"data": 1, "model": 1}
ROOMY = dict(num_slots=3, num_pages=16, page_size=8, max_pages_per_slot=8,
             prefill_chunk=8)
EVICT = dict(num_slots=3, num_pages=4, page_size=8, max_pages_per_slot=4,
             prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def floats():
    """The JAX engine's seeded llama_tiny weights (fp32 numpy tree)."""
    eng = deepspeed_tpu.init_inference(
        model=JaxLlama(jax_llama_tiny()), dtype="float32",
        kv_cache_dtype="float32", mesh=JAX_MESH)
    eng.init_params()
    return jax.tree.map(np.asarray, eng.params)


def _jax_llama(kv, quant=None):
    kw = {"quant": quant} if quant else {}
    eng = deepspeed_tpu.init_inference(
        model=JaxLlama(jax_llama_tiny()), dtype="float16",
        kv_cache_dtype=kv, mesh=JAX_MESH,
        paged_kernel="force" if kv in ("float16", "int8") else "auto", **kw)
    eng.init_params()                     # the fixture's seed
    return eng


def _port_llama(floats, kv, quant=None):
    kw = {"quant": quant} if quant else {}
    eng = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny()), dtype="float16", kv_cache_dtype=kv,
        device="cpu", **kw)
    return eng.set_params(llama_params_from_jax(floats))


def teacher_forced(engine, kv, seq, page_size=8, chunk=8):
    """Boundary logits of ``seq`` prefilled chunk by chunk into fresh
    ``kv`` pools (the shape of the JAX package's logit-delta tests)."""
    pools = engine.init_paged_cache(8, page_size, kv_dtype=kv)
    kvm = PagedKVManager(8, page_size, 2, 6)
    assert kvm.ensure_capacity(0, len(seq))
    lengths = np.zeros(2, np.int32)
    rows = []
    for c0 in range(0, len(seq), chunk):
        ids = np.zeros((1, chunk), np.int32)
        n = min(chunk, len(seq) - c0)
        ids[0, :n] = seq[c0:c0 + n]
        logits, pools = engine.prefill_into_slots(
            ids, 0, n, np.array(kvm.table), np.array(lengths), pools)
        lengths[0] += n
        rows.append(np.asarray(logits, np.float32))
    return np.stack(rows)


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


SEQ = np.random.default_rng(42).integers(0, 256, 40).astype(np.int32)


@pytest.mark.parametrize("kv,quant", [
    ("float16", None), ("int8", None), ("bfloat16", None),
    ("float16", QUANT)], ids=["fp16_pools", "int8_pools", "bf16_pools",
                              "int8_weights"])
def test_llama_prefill_logits_match_jax(floats, kv, quant):
    jeng, teng = _jax_llama(kv, quant), _port_llama(floats, kv, quant)
    assert teng.dtype == torch.float16
    _close(teacher_forced(teng, kv, SEQ), teacher_forced(jeng, kv, SEQ))
    ids = SEQ[None, :20]
    got = teng.forward(ids)
    assert got.dtype == torch.float16
    _close(got.float().numpy(), np.asarray(jeng.forward(ids), np.float32))


def _served(sched, prompts, max_new):
    reqs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_new)]
    got = sched.run()
    return [got[r.rid] for r in reqs]


@pytest.mark.parametrize("kv", ["float16", "int8"])
def test_llama_scheduler_equals_generate(floats, kv):
    """fp16 compute over fp16 / int8 pools: the scheduler (recompute
    preemption forced by a 4-page pool) emits each request's own
    ``generate()`` tokens over fp16 pools, and two runs agree over int8
    pools (``generate()`` keeps a float dense cache there)."""
    teng = _port_llama(floats, kv)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 11, 9)]
    max_new = [8, 6, 7]
    got = _served(ServingScheduler(teng, **EVICT), prompts, max_new)
    if kv == "float16":
        want = [[int(t) for t in teng.generate(p[None], max_new_tokens=m)[
            0, len(p):]] for p, m in zip(prompts, max_new)]
        assert got == want
    else:
        assert got == _served(ServingScheduler(teng, **EVICT), prompts,
                              max_new)


@pytest.mark.parametrize("variant", ["gpt2", "bloom"])
def test_gpt2_family_logits_match_jax(variant):
    """GPT-2 and BLOOM (ALiBi over pools: the gathered dense route) at
    float16 over float16 pools, against the JAX engine."""
    kw = {"bloom": dict(use_alibi=True, embed_layernorm=True,
                        pos_embed="none")}.get(variant, {})
    jcfg = jgpt2.gpt2_tiny(dtype=jnp.float16, **kw)
    jeng = deepspeed_tpu.init_inference(
        model=jgpt2.GPT2(jcfg), dtype="float16", kv_cache_dtype="float16",
        mesh=JAX_MESH)
    jeng.init_params()
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), jeng.params)
    teng = deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(tgpt2.gpt2_tiny(dtype="float16", **kw)), dtype="float16",
        kv_cache_dtype="float16", device="cpu")
    teng.set_params(tgpt2.gpt2_params_from_jax(params))
    _close(teacher_forced(teng, "float16", SEQ),
           teacher_forced(jeng, "float16", SEQ))
    ids = SEQ[None, :20]
    _close(teng.forward(ids).float().numpy(),
           np.asarray(jeng.forward(ids), np.float32))


def test_cuda_decisions_take_float16():
    """The dispatch rule on a CUDA device: float16 goes to a kernel (every
    decode walk, the int8 kernel, flash and sparse), never to a plain
    version; float64 is still refused."""
    for storage, bias in ((None, False), (torch.int8, False), (None, True)):
        d = tdec.paged_kernel_decision(
            device_type="cuda", num_heads=32, num_kv_heads=8, head_dim=128,
            dtype=torch.float16, storage_dtype=storage, has_bias=bias)
        assert d["path"] == "kernel", d
    d = tdec.paged_kernel_decision(
        device_type="cuda", num_heads=32, num_kv_heads=8, head_dim=128,
        dtype=torch.float64)
    assert d["path"] == "unsupported" and "float16" in d["reason"]
    assert tdec._KERNEL_DTYPES[torch.float16] == 2
    assert tflash._KERNEL_DTYPES[torch.float16] == 2
    assert tkern._KERNEL_DTYPES[torch.float16] == 2
    # the TMA copy rule covers float16 as it does bfloat16: a transposed
    # view is copied, a fused-qkv split view is read in place
    base = torch.zeros(2, 4, 96, 64, dtype=torch.float16).transpose(1, 2)
    qkv = torch.zeros(2, 96, 3 * 4 * 64, dtype=torch.float16)
    split = qkv.view(2, 96, 3, 4, 64)[:, :, 0]
    got = tflash._tma_operands(base, split)
    assert got[0].is_contiguous() and got[0].data_ptr() != base.data_ptr()
    assert got[1].data_ptr() == split.data_ptr()


def test_launch_counts_by_dtype():
    """The launch counters keep a count per compute dtype beside the
    total (``chip_smoke.py``'s fp16 launch gate reads them); a CPU
    tensor launches nothing."""
    from deepspeed_tpu_torch.ops import launch_counter
    c = launch_counter.LaunchCounter("a", "b")
    c.add("a", torch.float16)
    c.add("a", torch.bfloat16)
    with launch_counter.recording() as rec:
        c.add("b", torch.float16)
    launch_counter.replay(rec)
    launch_counter.replay(rec)
    assert c.counts() == {"a": 2, "b": 2}
    assert c.counts(torch.float16) == {"a": 1, "b": 2}
    assert c.counts(torch.float32) == {"a": 0, "b": 0}
    c.reset()
    assert c.counts(torch.float16) == {"a": 0, "b": 0}
    tdec.reset_launch_counts()
    q = torch.randn(2, 1, 4, 16).half()
    k = torch.randn(2, 8, 2, 16).half()
    tdec.decode_attention(q, k, k, bias=torch.zeros(2, 1, 1, 8))
    assert tdec.launch_counts(torch.float16) == dict.fromkeys(
        ("paged_decode_fwd", "paged_decode_quant_fwd", "decode_fwd"), 0)


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_float16_hf_directory_serves(family, tmp_path):
    """``save_pretrained`` of an HF model cast to float16 (its config says
    ``"torch_dtype": "float16"``) serves through ``init_inference(<dir>,
    dtype="float16")``: the logits of the HF model's own float32 forward
    over the same float16 weights, within 5e-3 (the port computes in
    float16), and the scheduler equals ``generate()``."""
    import json

    from test_torch_module_inject import hf_logits, hf_model
    hf = hf_model(family).half()
    hf.save_pretrained(str(tmp_path))
    # the key of the public config.json files (newer transformers write
    # "dtype" beside or instead of it)
    with open(tmp_path / "config.json") as f:
        written = json.load(f)
    written.pop("dtype", None)
    written["torch_dtype"] = "float16"
    with open(tmp_path / "config.json", "w") as f:
        json.dump(written, f)
    eng = deepspeed_tpu_torch.init_inference(
        str(tmp_path), dtype="float16", kv_cache_dtype="float16",
        device="cpu")
    assert eng.dtype == torch.float16
    ids = np.random.default_rng(0).integers(3, 120, (2, 12)).astype(np.int32)
    want = hf_logits(hf.float(), ids)
    got = eng.forward(ids)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-3)
    prompts = [ids[0, :7], ids[1, :4]]
    served = _served(ServingScheduler(eng, **ROOMY), prompts, [6, 6])
    assert served == [[int(t) for t in eng.generate(p[None],
                                                    max_new_tokens=6)[
        0, len(p):]] for p in prompts]


@pytest.mark.parametrize("spelling", ["float16", "fp16", "half",
                                      torch.float16])
def test_every_float16_spelling_serves_in_float16(floats, spelling):
    """``dtype`` and ``kv_cache_dtype`` take each name of float16 (and
    the torch dtype itself); the JAX default ``kv_cache_dtype`` stays
    bfloat16, so float16 compute over bf16 pools unless it is named."""
    eng = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny()), dtype=spelling, kv_cache_dtype=spelling,
        device="cpu").set_params(llama_params_from_jax(floats))
    assert eng.dtype == eng.kv_dtype == torch.float16
    pools = eng.init_paged_cache(4, 8)
    assert pools["layers"][0]["k_pages"].dtype == torch.float16
    default = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny()), dtype=spelling, device="cpu")
    assert default.kv_dtype == torch.bfloat16


def test_spec_prefix_cache_and_policies_run_in_float16(floats):
    """The serving features are dtype-generic: at float16 over float16
    pools, n-gram speculative rounds and prefix-cache hits stay
    token-exact against ``generate()``, every page comes back, and a
    sampled policy's streams are the same across two fresh schedulers."""
    teng = _port_llama(floats, "float16")
    motif = np.array([21, 22, 23, 24, 25], np.int32)
    prompts = [np.tile(motif, 3), np.tile(motif[::-1], 4)]
    want = [[int(t) for t in teng.generate(p[None], max_new_tokens=24)[
        0, len(p):]] for p in prompts]
    sched = ServingScheduler(teng, spec_decode="ngram", spec_k=4,
                             decode_horizon_steps=8, prefix_cache=True,
                             **ROOMY)
    assert _served(sched, prompts, [24, 24]) == want
    again = [sched.submit(p, max_new_tokens=24) for p in prompts]
    got = sched.run()
    assert [got[r.rid] for r in again] == want
    assert sched.metrics.spec_dispatches > 0
    assert any(r.cached_prefix_tokens > 0 for r in again)
    sched.prefix_cache.evict(10 ** 6)
    assert sched.kv.pool.pages_in_use == 0

    def sampled():
        s = ServingScheduler(teng, **ROOMY)
        reqs = [s.submit(p, max_new_tokens=8, seed=7 + i,
                         sampling={"do_sample": True, "temperature": 0.8,
                                   "top_k": 20, "top_p": 0.9})
                for i, p in enumerate(prompts)]
        out = s.run()
        return [out[r.rid] for r in reqs]
    first = sampled()
    assert first == sampled() and all(len(t) == 8 for t in first)
