"""Greedy serving of the PyTorch port against the JAX package at
``llama_tiny`` size (2 layers, GQA 4/2, fp32): ``generate`` and the
continuous-batching ``ServingScheduler`` must emit exactly the JAX
package's tokens, with eviction forced, and hand every page back.

The JAX engine is built as the existing serving tests build it
(``mesh={"data": 1, "model": 1}``); its weights are carried into the
port with ``llama_params_from_jax``.  The JAX engine stages copies of
its host arrays here: its scheduler hands numpy arrays it mutates right
after (``lengths``, the page table) to asynchronous dispatches, and on
the CPU backend ``device_put`` may alias them, which makes its eviction
runs nondeterministic (ROADMAP.md Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.engine import _sample_tokens as jax_sample
from deepspeed_tpu.models.llama import Llama as JaxLlama
from deepspeed_tpu.models.llama import llama_tiny as jax_llama_tiny
from deepspeed_tpu.serving import ServingScheduler as JaxScheduler
from deepspeed_tpu_torch.inference.engine import _sample_tokens
from deepspeed_tpu_torch.models.llama import (Llama, llama_params_from_jax,
                                              llama_tiny)
from deepspeed_tpu_torch.serving import (PagedKVManager, PagePool,
                                         PagePoolExhausted, QueueFull,
                                         ServingScheduler)
from deepspeed_tpu_torch.serving.scheduler import _UNPORTED

EVICT = dict(num_slots=3, num_pages=4, page_size=8, max_pages_per_slot=4,
             prefill_chunk=8)


@pytest.fixture(scope="module")
def engines():
    jeng = deepspeed_tpu.init_inference(
        model=JaxLlama(jax_llama_tiny()), dtype="float32",
        kv_cache_dtype="float32", mesh={"data": 1, "model": 1})
    jeng.init_params()
    stage = jeng._stage_host_inputs
    jeng._stage_host_inputs = lambda triples: stage(
        [(np.array(x) if isinstance(x, np.ndarray) else x, dt, sh)
         for x, dt, sh in triples])
    teng = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny()), dtype="float32", kv_cache_dtype="float32",
        device="cpu")
    teng.set_params(llama_params_from_jax(
        jax.tree.map(np.asarray, jeng.params)))
    return jeng, teng


def _generate(engine, prompts, max_new):
    return [[int(t) for t in engine.generate(p[None], max_new_tokens=m)[
        0, len(p):]] for p, m in zip(prompts, max_new)]


def _serve(sched, prompts, max_new):
    reqs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_new)]
    got = sched.run()
    return [got[r.rid] for r in reqs]


def test_generate_token_exact_vs_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 11, 20)]
    max_new = [8, 6, 40]
    assert _generate(teng, prompts, max_new) == \
        _generate(jeng, prompts, max_new)
    batch = rng.integers(0, 256, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(teng.generate(batch, max_new_tokens=5),
                                  jeng.generate(batch, max_new_tokens=5))


def test_scheduler_token_exact_vs_jax_under_forced_eviction(engines):
    """Shaped like the JAX package's
    ``test_continuous_batching_oracle_with_eviction_gqa``: a 4-page pool
    forces recompute preemption mid-flight."""
    jeng, teng = engines
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (12, 7, 12)]
    max_new = [10, 12, 8]
    want = _generate(jeng, prompts, max_new)
    jsched = JaxScheduler(jeng, **EVICT)
    assert _serve(jsched, prompts, max_new) == want
    tsched = ServingScheduler(teng, **EVICT)
    assert _serve(tsched, prompts, max_new) == want
    assert tsched.metrics.preemptions > 0, \
        "pool was sized to force eviction; none happened"
    assert tsched.kv.pool.pages_in_use == 0
    assert tsched.metrics.completed == 3


def test_scheduler_mixed_lengths_more_requests_than_slots(engines):
    jeng, teng = engines
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (5, 11, 5, 20, 11, 5)]
    max_new = [8, 6, 10, 4, 12, 5]
    want = _generate(teng, prompts, max_new)
    streamed = {}
    sched = ServingScheduler(teng, num_slots=3, num_pages=16, page_size=16,
                             max_pages_per_slot=8, prefill_chunk=8)
    reqs = [sched.submit(p, max_new_tokens=m,
                         on_token=lambda r, t: streamed.setdefault(
                             r.rid, []).append(t))
            for p, m in zip(prompts, max_new)]
    got = sched.run()
    for r, w in zip(reqs, want):
        assert got[r.rid] == w and streamed[r.rid] == w
    assert want == _generate(jeng, prompts, max_new)
    assert want == _serve(JaxScheduler(jeng, num_slots=3, num_pages=16,
                                       page_size=16, max_pages_per_slot=8,
                                       prefill_chunk=8), prompts, max_new)
    assert sched.kv.pool.pages_in_use == 0
    s = sched.summary()
    assert s["completed"] == 6 and s["tokens_emitted"] == sum(max_new)
    assert s["paged_attention"]["path"] == "reference"


def test_greedy_ties_go_to_the_lowest_id(engines):
    _, teng = engines
    logits = np.array([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0],
                       [-1.0, -2.0, 7.0, 7.0]], np.float32)
    want = [1, 0, 2]
    assert _sample_tokens(torch.from_numpy(logits)).tolist() == want
    assert np.asarray(jax_sample(jnp.asarray(logits), None, False, 1.0, 0,
                                 1.0)).tolist() == want
    assert teng.sample_from_logits(list(torch.from_numpy(logits))) == want
    assert teng.sample_from_logits(torch.from_numpy(logits[0])) == 1


def test_eos_stops_the_stream(engines):
    _, teng = engines
    prompt = np.arange(5, dtype=np.int32)
    eos = int(teng.generate(prompt[None], max_new_tokens=1)[0, -1])
    sched = ServingScheduler(teng, num_slots=2, num_pages=8, page_size=8,
                             max_pages_per_slot=4, prefill_chunk=8)
    req = sched.submit(prompt, max_new_tokens=16, eos_token_id=eos)
    assert sched.run()[req.rid] == [eos]
    out = teng.generate(prompt[None], max_new_tokens=4, eos_token_id=eos)
    assert out[0, 5:].tolist() == [eos] * 4


def test_cancel_backpressure_and_oversize(engines):
    _, teng = engines
    sched = ServingScheduler(teng, num_slots=1, num_pages=4, page_size=8,
                             max_pages_per_slot=4, prefill_chunk=8,
                             max_queue=2)
    with pytest.raises(ValueError, match="per-slot capacity"):
        sched.submit(np.zeros(40, np.int32), max_new_tokens=8)
    keep = sched.submit(np.zeros(4, np.int32), max_new_tokens=6)
    victim = sched.submit(np.ones(4, np.int32), max_new_tokens=6)
    with pytest.raises(QueueFull):
        sched.submit(np.zeros(4, np.int32), max_new_tokens=2)
    sched.step()
    victim.cancel()
    got = sched.run()
    assert victim.state == "cancelled" and victim.rid not in got
    assert len(got[keep.rid]) == 6
    assert sched.metrics.cancelled == 1 and sched.kv.pool.pages_in_use == 0
    expired = sched.submit(np.zeros(4, np.int32), max_new_tokens=2,
                           deadline_s=0.0)
    ok = sched.submit(np.zeros(4, np.int32), max_new_tokens=2)
    got = sched.run()
    assert expired.state == "shed" and "deadline" in expired.error
    assert expired.rid not in got and len(got[ok.rid]) == 2
    assert sched.metrics.shed == 1 and sched.metrics.failed == 0


@pytest.mark.parametrize("kwargs", [
    dict(mem_telemetry=True), dict(tracer=object()),
    dict(tenancy=object()), dict(online_tuner=True)])
def test_unported_scheduler_options_raise(engines, kwargs):
    _, teng = engines
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServingScheduler(teng, num_slots=1, num_pages=4, page_size=8,
                         **kwargs)


def test_scheduler_takes_the_jax_defaults_explicitly(engines):
    """The JAX scheduler's own defaults, passed by name, build a working
    scheduler (ROADMAP.md Queue C2); spec_k with spec off is accepted."""
    _, teng = engines
    sched = ServingScheduler(teng, num_slots=2, num_pages=8, page_size=8,
                             max_pages_per_slot=4, prefill_chunk=8,
                             monitor=None, top_k=0, top_p=1.0, spec_k=8,
                             spec_decode=None, spec_drafter=None)
    prompt = np.arange(5, dtype=np.int32)
    req = sched.submit(prompt, max_new_tokens=4)
    want = [int(t) for t in teng.generate(prompt[None], max_new_tokens=4)[
        0, 5:]]
    assert sched.run()[req.rid] == want
    assert sched.spec_mode == "off" and sched.spec_k_buckets == [1, 2, 4, 8]


@pytest.mark.parametrize("kwargs,item", [
    (dict(top_k=40), None), (dict(top_p=0.9), None),
    (dict(monitor=object()), "A10")])
def test_non_default_sampling_and_monitor_options_name_their_item(
        engines, kwargs, item):
    """Sampling defaults (ROADMAP.md Queue A6) are ported; the monitor
    (A10) still raises naming its item."""
    _, teng = engines
    if item is None:
        sched = ServingScheduler(teng, num_slots=1, num_pages=4,
                                 page_size=8, **kwargs)
        assert sched.default_sampling.is_greedy
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue {item}"):
        ServingScheduler(teng, num_slots=1, num_pages=4, page_size=8,
                         **kwargs)


A4_A6_SCHEDULER = [dict(prefix_cache=True), dict(prefix_cache_pages=8),
                   dict(prefix_cache=True, prefix_cache_pages=3),
                   dict(do_sample=True), dict(temperature=0.7),
                   dict(do_sample=True, temperature=0.7, top_k=5,
                        top_p=0.9), dict(do_sample=True, seed=11)]


@pytest.mark.parametrize("kwargs", A4_A6_SCHEDULER)
def test_a4_and_a6_scheduler_options_run(engines, kwargs):
    """The prefix cache (Queue A4) and the sampling defaults (A6) build a
    scheduler that serves; ``seed``, ``sampling`` and ``grammar`` run on
    submit."""
    _, teng = engines
    sched = ServingScheduler(teng, num_slots=2, num_pages=8, page_size=8,
                             max_pages_per_slot=4, prefill_chunk=8,
                             **kwargs)
    assert (sched.prefix_cache is not None) == bool(
        kwargs.get("prefix_cache"))
    reqs = [sched.submit(np.arange(5, dtype=np.int32), max_new_tokens=4),
            sched.submit(np.arange(6, dtype=np.int32), max_new_tokens=4,
                         seed=3, sampling={"do_sample": True}),
            sched.submit(np.arange(4, dtype=np.int32), max_new_tokens=12,
                         grammar={"regex": "[a-c]{3}"})]
    got = sched.run()
    assert all(r.state == "finished" for r in reqs)
    assert [len(got[r.rid]) for r in reqs] == [4, 4, 3]


@pytest.mark.parametrize("key", sorted(_UNPORTED))
def test_every_remaining_unported_option_names_its_item(engines, key):
    _, teng = engines
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md {_UNPORTED[key].split(' (')[0]}"):
        ServingScheduler(teng, num_slots=1, num_pages=4, page_size=8,
                         **{key: object()})
    assert "A4" not in _UNPORTED[key] and "A6" not in _UNPORTED[key]


INERT = [("min_out_tokens", 1, 2), ("min_tokens", 1, 3),
         ("max_batch_size", 1, 4), ("replace_method", "auto", "layers"),
         ("triangular_masking", True, False), ("return_tuple", True, False)]


@pytest.mark.parametrize("field,default,other", INERT,
                         ids=[f[0] for f in INERT])
def test_inert_config_fields_accept_the_jax_default(field, default, other):
    """Fields the JAX config accepts and no JAX code reads (ROADMAP.md
    Queue C3): the JAX default is accepted, another value raises."""
    eng = deepspeed_tpu_torch.init_inference(Llama(llama_tiny()),
                                             device="cpu", **{field: default})
    assert eng._config.min_out_tokens == 1
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue C3"):
        deepspeed_tpu_torch.init_inference(Llama(llama_tiny()),
                                           device="cpu", **{field: other})


@pytest.mark.parametrize("kwargs", [
    dict(mesh={"data": 1, "model": 1}),
    dict(tensor_parallel={"tp_size": 2})])
def test_unported_config_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        deepspeed_tpu_torch.init_inference(Llama(llama_tiny()),
                                           device="cpu", **kwargs)


def test_unported_request_options_raise(engines):
    _, teng = engines
    sched = ServingScheduler(teng, num_slots=1, num_pages=4, page_size=8,
                             prefix_cache=False, spec_decode="off")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A10"):
        sched.submit(np.zeros(3, np.int32), sample_offset=3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A10"):
        sched.submit(np.zeros(3, np.int32), tenant="acme")
    # sampled generate (Queue A6) runs now
    out = teng.generate(np.zeros((1, 3), np.int32), max_new_tokens=4,
                        do_sample=True)
    assert out.shape == (1, 7)
    with pytest.raises(TypeError):
        sched.submit(np.zeros(3, np.int32), colour="blue")
    with pytest.raises(TypeError):
        ServingScheduler(teng, num_slots=1, num_pages=4, page_size=8,
                         colour="blue")
    with pytest.raises(ValueError, match="unknown inference config"):
        deepspeed_tpu_torch.init_inference(Llama(llama_tiny()),
                                           device="cpu", colour="blue")


def test_page_pool_alloc_free_invariants():
    pool = PagePool(num_pages=8, page_size=16)
    a = pool.allocate(3)
    b = pool.allocate(2)
    assert len(set(a) | set(b)) == 5 and pool.peak_in_use == 5
    pool.free(a)
    c = pool.allocate(6)
    assert pool.free_pages == 0 and not pool.can_allocate(1)
    with pytest.raises(PagePoolExhausted):
        pool.allocate(1)
    pool.free(b + c)
    assert pool.pages_in_use == 0 and pool.total_allocs == 11
    with pytest.raises(ValueError):   # double free
        pool.free([a[0]])
    assert [pool.pages_for_tokens(n) for n in (1, 16, 17, 64)] == \
        [1, 1, 2, 4]


def test_kv_manager_growth_and_release():
    kv = PagedKVManager(num_pages=6, page_size=4, num_slots=3,
                        max_pages_per_slot=4)
    assert kv.ensure_capacity(0, 5) and kv.ensure_capacity(1, 9)
    assert set(kv.table[0][:2]) == set(kv._slot_pages[0])
    assert (kv.table[0][2:] == 0).all()
    assert not kv.ensure_capacity(2, 8)      # fails softly, leaks nothing
    assert kv.slot_page_count(2) == 0
    with pytest.raises(ValueError):
        kv.ensure_capacity(0, 17)
    kv.release_slot(0)
    kv.release_slot(1)
    assert kv.pool.pages_in_use == 0


def test_decode_step_matches_one_step_horizon_and_page_bytes(engines):
    """``decode_step`` is ``decode_multi`` at horizon 1; ``kv_page_bytes``
    prices one page of every layer's pools (the sink page aside)."""
    from deepspeed_tpu_torch.ops.quant.kv import kv_page_bytes
    _, teng = engines
    cfg = teng.module.cfg
    pools = teng.init_paged_cache(6, 8)
    table = np.array([[1, 2], [3, 4], [0, 0]], np.int32)
    lengths = np.array([5, 9, 0], np.int32)
    active = np.array([True, True, False])
    toks = np.array([7, 11, 0], np.int32)
    pools_b = {"layers": [{k: v.clone() for k, v in layer.items()}
                          for layer in pools["layers"]]}
    step, _ = teng.decode_step(toks, active, table, lengths, pools)
    block, valid, *_ = teng.decode_multi(
        toks, active, table, lengths, pools_b, horizon=1,
        budgets=np.array([4, 4, 0], np.int32),
        eos_ids=np.full(3, -1, np.int32))
    assert step[:2].tolist() == block[:2, 0].tolist()
    assert valid[:, 0].tolist() == active.tolist()
    per_page = sum(t[0].numel() * t.element_size()
                   for layer in pools["layers"] for t in layer.values())
    assert kv_page_bytes(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 8,
                         torch.float32) == per_page
