"""The prefix cache of the PyTorch port (``serving/prefix_cache.py``,
``InferenceEngine.copy_page`` and the scheduler's A4 paths) against the
JAX package on the CPU at ``llama_tiny`` size (fp32).

* The port's ``PrefixCache`` makes the JAX one's decisions on the same
  trace of donations, matches, shares and evictions.
* Greedy serving with full-page and copy-on-write hits is token-exact
  against the JAX engine's ``generate()`` (the engine, not the JAX
  scheduler, whose prefix-cache oracle fails from run to run: ROADMAP.md
  Queue C), at horizons 1 and 8, with overlap on and off, under cache
  pressure, after preemption and beside n-gram spec decoding.
* ``copy_page`` moves every leaf of a page, a quantized pool's scale
  rows included, bit for bit; after a drain every page comes back.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import (Llama, llama_params_from_jax,
                                              llama_tiny)
from deepspeed_tpu_torch.serving import PagePool, ServingScheduler
from deepspeed_tpu_torch.serving.prefix_cache import (FingerprintMatcher,
                                                      PrefixCache,
                                                      prefix_digest)

CFG = dict(num_slots=3, num_pages=32, page_size=8, max_pages_per_slot=10,
           prefill_chunk=8)
PS = CFG["page_size"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small CPU ops: beside
    the other test workers, torch's thread pool spends far more time
    waiting for cores than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.models.llama import Llama as JaxLlama
    from deepspeed_tpu.models.llama import llama_tiny as jax_llama_tiny
    jeng = deepspeed_tpu.init_inference(
        model=JaxLlama(jax_llama_tiny()), dtype="float32",
        kv_cache_dtype="float32", mesh={"data": 1, "model": 1})
    jeng.init_params()
    teng = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny()), dtype="float32", kv_cache_dtype="float32",
        device="cpu")
    teng.set_params(llama_params_from_jax(
        jax.tree.map(np.asarray, jeng.params)))
    return jeng, teng


_GENERATED = {}


def _want(jeng, prompts, max_new):
    """The JAX engine's greedy ``generate()`` tokens per request."""
    out = []
    for p, m in zip(prompts, max_new):
        key = (p.tobytes(), m)
        if key not in _GENERATED:
            _GENERATED[key] = [int(t) for t in jeng.generate(
                p[None], max_new_tokens=m)[0, len(p):]]
        out.append(_GENERATED[key])
    return out


def _serve(sched, prompts, max_new):
    reqs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_new)]
    got = sched.run()
    return reqs, [got[r.rid] for r in reqs]


# ------------------------------------------------ the host-only index


def _trace(mod):
    """One trace of cache operations on a pool of 12 pages of 4 tokens;
    returns every observable decision."""
    pool = mod.PagePool(12, 4)
    cache = mod.PrefixCache(pool, max_pages=6)
    seen = []
    toks = list(range(100, 120))
    donor = pool.allocate(5)
    seen.append(cache.insert(toks, donor))            # 5 pages cached
    seen.append(cache.insert(toks[:8] + [7] * 8, pool.allocate(4)))
    for probe, limit in ((toks, 19), (toks[:10], 9), (toks[:6] + [1], 7),
                         ([5] * 9, 8), (toks[:8] + [7] * 3, 11)):
        full, pnode, plen = cache.match(probe, limit=limit)
        seen.append(([n.page for n in full],
                     None if pnode is None else pnode.page, plen))
    full, _, _ = cache.match(toks, limit=12)
    shared = cache.acquire(full)
    pool.share(shared)
    seen.append((cache.reclaimable_pages(), cache.evict(3),
                 cache.cached_pages, pool.pages_in_use))
    pool.free(shared)
    fp = cache.fingerprint()
    seen.append((sorted(fp["digests"]), cache.prefix_len(toks, limit=19)))
    seen.append((cache.reclaimable_pages(), cache.evict(100),
                 pool.pages_in_use, cache.evicted_pages,
                 cache.donated_pages, cache.pages_shared))
    return seen


def test_prefix_cache_decisions_equal_jax():
    import deepspeed_tpu.serving.page_manager as jpm
    import deepspeed_tpu.serving.prefix_cache as jpc

    class Jax:
        PagePool, PrefixCache = jpm.PagePool, jpc.PrefixCache

    class Port:
        PrefixCache = PrefixCache
        PagePool = PagePool
    assert _trace(Port) == _trace(Jax)
    for ns in (None, "tenant-a", ("t", 3)):
        assert prefix_digest([1, 2, 3], ns=ns) == \
            jpc.prefix_digest([1, 2, 3], ns=ns)
    m = FingerprintMatcher()
    pool = PagePool(4, 2)
    cache = PrefixCache(pool)
    cache.insert([1, 2, 3, 4, 5], pool.allocate(2))
    m.update(cache.fingerprint())
    assert m.match_len([1, 2, 3, 4, 9]) == 4


# ---------------------------------------------------- greedy serving


@pytest.fixture(scope="module")
def hit_mix():
    """A donor of 5 full pages and 3 tokens; a full hit with a COW tail,
    a hit of exactly 4 pages, a partial first page, and a miss."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, 43).astype(np.int32)
    other = rng.integers(0, 256, 30).astype(np.int32)
    prompts = [base, base.copy(), base[:33].copy(),
               np.concatenate([base[:5], other[:10]]), other]
    return prompts, [6, 5, 4, 7, 3]


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "barrier"])
@pytest.mark.parametrize("horizon", [1, 8])
def test_cache_hits_token_exact_vs_jax_generate(engines, hit_mix, horizon,
                                                overlap):
    jeng, teng = engines
    prompts, max_new = hit_mix
    want = _want(jeng, prompts, max_new)
    sched = ServingScheduler(teng, decode_horizon_steps=horizon,
                             overlap=overlap, prefix_cache=True, **CFG)
    reqs, got = _serve(sched, prompts[:1], max_new[:1])
    assert got == want[:1] and reqs[0].cached_prefix_tokens == 0
    assert sched.prefix_cache.cached_pages == (43 + 6 - 1) // PS
    reqs, got = _serve(sched, prompts[1:], max_new[1:])
    assert got == want[1:]
    # the match is capped at len(prompt) - 1: one token is prefilled
    assert [r.cached_prefix_tokens for r in reqs] == [42, 32, 5, 0]
    s = sched.summary()
    assert s["prefix_cow_copies"] == 2 and s["prefix_hits"] == 3
    assert s["prefill_tokens_saved"] == 79 and s["prefix_lookups"] == 5
    # cached pages are capacity, not a leak
    in_use = sched.kv.pool.pages_in_use
    assert in_use == sched.prefix_cache.cached_pages
    assert sched.prefix_cache.evict(10 ** 6) == in_use
    assert sched.kv.pool.pages_in_use == 0


def test_cache_pressure_drains_before_preempting(engines):
    """A warm cache and a hostage allocation squeeze the pool: admissions
    and growth drain cached pages instead of preempting, and the output
    stays token-exact."""
    jeng, teng = engines
    rng = np.random.default_rng(11)
    warm = [rng.integers(0, 256, 43).astype(np.int32) for _ in range(2)]
    fresh = [rng.integers(0, 256, 33).astype(np.int32) for _ in range(2)]
    sched = ServingScheduler(teng, prefix_cache=True, **CFG)
    _serve(sched, warm, [4, 4])
    assert sched.prefix_cache.cached_pages > 0
    hostage = sched.kv.pool.allocate(sched.kv.pool.free_pages - 2)
    _, got = _serve(sched, fresh, [6, 6])
    assert got == _want(jeng, fresh, [6, 6])
    s = sched.summary()
    assert s["cache_evictions"] > 0
    assert s["preemptions"] == 0 and s["shed"] == 0
    sched.kv.pool.free(hostage)
    sched.prefix_cache.evict(10 ** 6)
    assert sched.kv.pool.pages_in_use == 0


def test_donation_after_preemption_keys_the_true_sequence(engines):
    """A preempted request's prompt holds its emitted tokens; donation
    keys on ``orig_prompt + out_tokens``, so every cached chain spells a
    prefix of a served sequence, and the donor's prompt hits it."""
    jeng, teng = engines
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 256, 43).astype(np.int32) for _ in range(2)]
    want = _want(jeng, prompts, [10, 10])
    sched = ServingScheduler(teng, prefix_cache=True, **CFG)
    hostage = sched.kv.pool.allocate(CFG["num_pages"] - 8)
    _, got = _serve(sched, prompts, [10, 10])
    assert sched.metrics.preemptions > 0, "the pool was sized to preempt"
    assert got == want
    seqs = [[int(t) for t in p] + w for p, w in zip(prompts, want)]

    def walk(node, path):
        for key, child in node.children.items():
            chain = path + list(key)
            assert any(chain == s[:len(chain)] for s in seqs)
            walk(child, chain)
    walk(sched.prefix_cache._root, [])
    reqs, got = _serve(sched, prompts[:1], [10])
    assert got == want[:1] and reqs[0].cached_prefix_tokens > 0
    sched.kv.pool.free(hostage)
    sched.prefix_cache.evict(10 ** 6)
    assert sched.kv.pool.pages_in_use == 0


def test_spec_donates_only_accepted_tokens(engines):
    """The JAX ``test_spec_donates_only_accepted_tokens_to_prefix_cache``:
    after n-gram spec rounds (rollbacks included) the cached chain spells
    the request's true tokens over its full pages only, and the same
    prompt served again hits it and stays exact."""
    jeng, teng = engines
    motif = np.array([21, 22, 23, 24, 25], np.int32)
    prompt = np.tile(motif, 3)
    want = _want(jeng, [prompt], [30])[0]
    sched = ServingScheduler(teng, decode_horizon_steps=8,
                             spec_decode="ngram", spec_k=8,
                             prefix_cache=True, **CFG)
    reqs, got = _serve(sched, [prompt], [30])
    assert got == [want]
    assert sched.metrics.spec_dispatches > 0
    seq = [int(t) for t in prompt] + want
    node, depth = sched.prefix_cache._root, 0
    while node.children:
        assert len(node.children) == 1
        key, node = next(iter(node.children.items()))
        assert key == tuple(seq[depth * PS:(depth + 1) * PS])
        depth += 1
    assert depth == (len(seq) - 1) // PS
    reqs, got = _serve(sched, [prompt], [30])
    assert got == [want] and reqs[0].cached_prefix_tokens > 0
    sched.prefix_cache.evict(10 ** 6)
    assert sched.kv.pool.pages_in_use == 0


def test_spec_reserve_counts_reclaimable_pages(engines):
    """A spec round under a warm cache: the K bucket does not shrink while
    cached pages can cover the round, and serving stays exact."""
    jeng, teng = engines
    motif = np.array([31, 32, 33, 34], np.int32)
    prompts = [np.tile(motif, 4), np.tile(motif[::-1], 4)]
    want = _want(jeng, prompts, [20, 20])
    sched = ServingScheduler(teng, spec_decode="ngram", spec_k=8,
                             prefix_cache=True, **CFG)
    rng = np.random.default_rng(3)
    _serve(sched, [rng.integers(0, 256, 40).astype(np.int32)
                   for _ in range(3)], [8, 8, 8])
    hostage = sched.kv.pool.allocate(sched.kv.pool.free_pages - 1)
    assert sched._reclaimable() > 0
    _, got = _serve(sched, prompts, [20, 20])
    assert got == want
    assert sched.metrics.cache_evictions > 0
    assert sched.metrics.preemptions == 0
    sched.kv.pool.free(hostage)


# ------------------------------------------------------------ copy_page


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_copy_page_moves_every_leaf(engines, kv):
    _, teng = engines
    pools = teng.init_paged_cache(12, PS, kv_dtype=kv)
    g = torch.Generator().manual_seed(0)
    for layer in pools["layers"]:
        for t in layer.values():
            raw = t.view(torch.uint8)
            raw.copy_(torch.randint(0, 256, raw.shape, generator=g,
                                    dtype=torch.uint8))
    names = sorted(pools["layers"][0])
    assert names == (["k_pages", "k_scale", "v_pages", "v_scale"]
                     if kv == "int8" else ["k_pages", "v_pages"])
    before = [{k: t.clone() for k, t in layer.items()}
              for layer in pools["layers"]]
    assert teng.copy_page(pools, 4, 9) is pools
    for old, layer in zip(before, pools["layers"]):
        for k, t in layer.items():
            assert torch.equal(t[9].view(torch.uint8),
                               old[k][4].view(torch.uint8)), k
            keep = [i for i in range(t.shape[0]) if i != 9]
            assert torch.equal(t[keep].view(torch.uint8),
                               old[k][keep].view(torch.uint8)), k
    assert teng.serving_page_copy_capture_count() == 0


def test_int8_pools_cache_on_equals_cache_off():
    """int8 KV: a copied page keeps its own scales, so the streams with
    the cache on equal the streams with it off."""
    teng = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny()), dtype="float32", kv_cache_dtype="int8",
        device="cpu").init_params(5)
    rng = np.random.default_rng(19)
    base = rng.integers(0, 256, 37).astype(np.int32)
    prompts = [base, base.copy(), np.concatenate([base[:21], base[:9]]),
               base[:26].copy()]
    max_new = [9, 7, 8, 6]
    runs = []
    for cache in (False, True):
        sched = ServingScheduler(teng, prefix_cache=cache, **CFG)
        got = [_serve(sched, [p], [m])[1][0]
               for p, m in zip(prompts, max_new)]
        runs.append(got)
        if cache:
            s = sched.summary()
            assert s["prefix_hits"] >= 2 and s["prefix_cow_copies"] >= 2
    assert runs[0] == runs[1]


def test_prefix_cache_pages_caps_retention(engines):
    _, teng = engines
    sched = ServingScheduler(teng, prefix_cache=True, prefix_cache_pages=2,
                             **CFG)
    rng = np.random.default_rng(23)
    _serve(sched, [rng.integers(0, 256, 40).astype(np.int32)], [4])
    assert sched.prefix_cache.cached_pages == 2
    assert sched.kv.pool.pages_in_use == 2
