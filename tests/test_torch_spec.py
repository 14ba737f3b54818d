"""Speculative decoding of the PyTorch port against the JAX package at
``llama_tiny`` size (2 layers, GQA 4/2, fp32).

``verify_multi`` must return the JAX engine's seven outputs exactly, and
write the same K/V rows, over float32 pools (within 1e-5) and int8 pools
(the dequantized rows within one quantization step of the row), with
mixed draft widths, an inactive slot, an EOS inside the emitted stream
and a budget that ends mid-row.  Spec serving — the n-gram drafter, a
perfect drafter, an always-wrong one, a 1-layer draft model, the target
as its own draft, eviction forced — must be token-exact against both
packages' ``generate()`` and against spec-off, and hand every page of
both pools back; the n-gram run's spec counters must equal the JAX
scheduler's.  The JAX engine stages copies of its host arrays, as
``tests/test_torch_serving.py`` does (ROADMAP.md Queue C).

The ``cuda`` cases hold the verify CUDA graph against the eager round
on the card and skip here.  The JAX engines are imported inside the
fixture: the card's machine has no flax, and its run collects this file.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import (Llama, llama_params_from_jax,
                                              llama_tiny)
from deepspeed_tpu_torch.ops.quant.kv import dequantize_kv_rows
from deepspeed_tpu_torch.serving import (Drafter, DraftModelDrafter,
                                         NgramDrafter, PagedKVManager,
                                         ServingScheduler)

CFG = dict(num_slots=3, num_pages=24, page_size=8, max_pages_per_slot=8,
           prefill_chunk=8)
# float K/V rows of the two packages: the same fp32 projections
KV_ATOL = 1e-5


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


_GENERATED = {}


def _want(engines, prompts, max_new, eos=None):
    """Per request, greedy ``generate()`` tokens (cut after ``eos``),
    equal in both packages."""
    out = []
    for p, m in zip(prompts, max_new):
        key = (p.tobytes(), m)
        if key not in _GENERATED:
            got = [[int(t) for t in eng.generate(p[None], max_new_tokens=m)[
                0, len(p):]] for eng in engines]
            assert got[0] == got[1], "port generate() diverged from JAX"
            _GENERATED[key] = got[0]
        toks = _GENERATED[key]
        if eos is not None and eos in toks:
            toks = toks[:toks.index(eos) + 1]
        out.append(toks)
    return out


def _serve(engine, prompts, max_new, eos=None, sched=None, **kw):
    sched = sched or ServingScheduler(engine, decode_horizon_steps=8,
                                      **{**CFG, **kw})
    reqs = [sched.submit(p, max_new_tokens=m, eos_token_id=eos)
            for p, m in zip(prompts, max_new)]
    got = sched.run()
    return sched, [got.get(r.rid) for r in reqs]


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


class OracleDrafter(Drafter):
    """Proposes the target's own greedy continuation (full acceptance)."""

    name = "oracle"

    def __init__(self, streams):
        self.streams = streams        # rid -> greedy stream

    def propose(self, items):
        out = {}
        for slot, req, k in items:
            i = len(req.out_tokens)
            out[slot] = self.streams[req.rid][i:i + k]
        return out


class WrongDrafter(OracleDrafter):
    """Every draft misses the greedy argmax by one token id."""

    name = "wrong"

    def propose(self, items):
        return {s: [(t + 1) % 256 for t in d]
                for s, d in super().propose(items).items()}


# ------------------------------------------------------------ verify_multi


def _verify_case(engines, kv, k):
    """Both engines prefill the same four slots into fresh ``kv`` pools,
    then verify one round: slot 0 proposes the greedy continuation (width
    K, an EOS set on its second emitted token when K > 1), slot 1 one
    right then wrong drafts (width min(2, K), budget 2: the budget ends
    the row), slot 2 is inactive, slot 3 proposes nothing (width 0).
    Slot 0 starts at 7 tokens, so its writes straddle the page boundary
    at 8.  Returns {package: (outputs as numpy, pools)}."""
    jeng, teng = engines
    slots, ps, num_pages, maxp = 4, 8, 16, 4
    prompts = _prompts(30, (7, 13, 5, 3))
    streams = _want(engines, prompts, [k + 1] * 4)
    kvm = PagedKVManager(num_pages, ps, slots, maxp)
    for s, p in enumerate(prompts):
        assert kvm.ensure_capacity(s, len(p) + k + 1)
    table = np.array(kvm.table)
    drafts = np.zeros((slots, k), np.int32)
    drafts[0] = streams[0][1:k + 1]
    drafts[1] = [(t + 1) % 256 for t in streams[1][1:k + 1]]
    drafts[1, 0] = streams[1][1]
    widths = np.array([k, min(2, k), k, 0], np.int32)
    active = np.array([True, True, False, True])
    budgets = np.array([8, 2, 8, 8], np.int32)
    eos = np.full(slots, -1, np.int32)
    if k > 1:
        eos[0] = streams[0][2]
    toks = np.array([st[0] for st in streams], np.int32)
    out = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        pools = eng.init_paged_cache(num_pages, ps, kv_dtype=kv)
        lengths = np.zeros(slots, np.int32)
        for s, p in enumerate(prompts):
            ids = np.zeros((1, 16), np.int32)
            ids[0, :len(p)] = p
            _, pools = eng.prefill_into_slots(ids, s, len(p), table,
                                              np.array(lengths), pools)
            lengths[s] = len(p)
        res = eng.verify_multi(toks, drafts, active, table, lengths, pools,
                               widths=widths, budgets=budgets, eos_ids=eos,
                               emitted=np.zeros(slots, np.int32))
        out[name] = ([np.asarray(t) for t in res[:7]], res[7])
    return out, num_pages


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_verify_multi_matches_jax(engines, kv, k):
    out, num_pages = _verify_case(engines, kv, k)
    (jres, jpools), (tres, tpools) = out["jax"], out["port"]
    for i, (a, b) in enumerate(zip(jres, tres)):
        np.testing.assert_array_equal(b, a, err_msg=f"output {i}")
    toks, valid, _, active_end, lengths_end, _, accepted = tres
    assert accepted[0] == min(k, 2) and not valid[2].any()
    assert valid[3].sum() == 1 and accepted[3] == 0
    assert lengths_end[1] == 13 + 2                  # the budget cut
    if k > 1:
        assert valid[0].sum() == 2 and not active_end[0], "EOS missed"
    # the written K/V rows (the port's last page is its drop sink)
    for jl, tl in zip(jpools["layers"], tpools["layers"]):
        for name in ("k", "v"):
            t_pages = tl[f"{name}_pages"][:num_pages]
            j_pages = np.asarray(jl[f"{name}_pages"])
            if kv == "float32":
                np.testing.assert_allclose(t_pages.numpy(), j_pages,
                                           atol=KV_ATOL)
                continue
            t_scale = tl[f"{name}_scale"][:num_pages]
            j_scale = np.asarray(jl[f"{name}_scale"])
            t_rows = dequantize_kv_rows(t_pages, t_scale,
                                        torch.float32).numpy()
            j_rows = j_pages.astype(np.float32) * j_scale
            # one quantization step of the row: its scale
            step = np.maximum(t_scale.numpy(), j_scale) * (1 + 1e-6)
            assert (np.abs(t_rows - j_rows) <= step).all()


def test_verify_on_the_cpu_captures_nothing(engines):
    _, teng = engines
    _verify_case(engines, "float32", 2)
    assert teng.serving_verify_capture_count() == 0
    assert teng.serving_verify_capture_seconds() == 0.0


# -------------------------------------------------------- scheduler streams


@pytest.mark.parametrize("k", [2, 4])
def test_spec_ngram_token_exact(engines, k):
    """Spec on (n-gram) equals generate() and spec-off, with an EOS
    inside a verify round and budgets ending mid-round; a repeated motif
    makes the drafter hit."""
    _, teng = engines
    motif = np.array([11, 12, 13, 14, 15, 16], np.int32)
    prompts = _prompts(4, (9, 5, 9, 6)) + [np.tile(motif, 3)]
    max_new = [12, 6, 10, 14, 20]
    base = _want(engines, prompts, max_new)
    eos = base[0][3]
    want = _want(engines, prompts, max_new, eos=eos)
    off_sched, off = _serve(teng, prompts, max_new, eos=eos)
    sched, on = _serve(teng, prompts, max_new, eos=eos,
                       spec_decode="ngram", spec_k=k)
    assert off == want and on == want
    assert sched.spec_k_buckets[-1] == k and sched.spec_mode == "ngram"
    assert sched.metrics.spec_dispatches > 0
    assert sched.metrics.spec_accepted > 0
    assert sched.kv.pool.pages_in_use == 0 == off_sched.kv.pool.pages_in_use


def test_spec_counters_equal_jax(engines):
    """The n-gram drafter is stateless, so both schedulers make the same
    proposals, rounds and rollbacks."""
    from deepspeed_tpu.serving import ServingScheduler as JaxScheduler
    jeng, teng = engines
    motif = np.array([21, 22, 23, 24], np.int32)
    prompts = _prompts(6, (7, 10)) + [np.tile(motif, 4)]
    max_new = [16, 12, 18]
    want = _want(engines, prompts, max_new)
    keys = ("spec_dispatches", "spec_draft_tokens", "spec_accepted_tokens",
            "spec_rollbacks", "spec_rollback_tokens")
    summaries = []
    for sched in (JaxScheduler(jeng, decode_horizon_steps=8,
                               spec_decode="ngram", spec_k=4, **CFG),
                  ServingScheduler(teng, decode_horizon_steps=8,
                                   spec_decode="ngram", spec_k=4, **CFG)):
        _, got = _serve(None, prompts, max_new, sched=sched)
        assert got == want
        assert sched.kv.pool.pages_in_use == 0
        summaries.append({k_: sched.metrics.summary()[k_] for k_ in keys})
    assert summaries[1] == summaries[0]
    assert summaries[1]["spec_dispatches"] > 0
    assert summaries[1]["spec_accepted_tokens"] > 0


def test_always_wrong_drafter_rolls_back_across_pages(engines):
    """Every draft rejected: each round emits only the correction token
    and rolls its written K/V back (rounds straddle page boundaries: 8
    tokens a page); adaptive K falls to 1; the stream stays exact."""
    _, teng = engines
    prompts = _prompts(7, (6, 9))
    max_new = [26, 26]
    want = _want(engines, prompts, max_new)
    streams = {}
    sched = ServingScheduler(teng, decode_horizon_steps=8,
                             spec_drafter=WrongDrafter(streams), spec_k=8,
                             **CFG)
    reqs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_new)]
    streams.update({r.rid: w for r, w in zip(reqs, want)})
    got = sched.run()
    assert [got[r.rid] for r in reqs] == want
    assert all(r._spec_k == 1 for r in reqs)
    m = sched.metrics
    assert m.spec_acceptance_rate() == 0.0
    assert m.spec_rollbacks > 0 and m.spec_rollback_tokens > 0
    assert sched.kv.pool.pages_in_use == 0


def test_adaptive_k_shrinks_to_one_and_grows_back(engines):
    """Wrong drafts for the first 10 tokens, perfect ones after: a
    request's K falls to the smallest bucket and climbs back to spec_k;
    the perfect drafter alone keeps K at the cap."""
    _, teng = engines
    prompts = _prompts(8, (6, 9))
    max_new = [40, 40]
    want = _want(engines, prompts, max_new)
    streams = {}

    class Turning(OracleDrafter):
        name = "turning"

        def propose(self, items):
            out = super().propose(items)
            for s, req, _ in items:
                if len(req.out_tokens) < 10:
                    out[s] = [(t + 1) % 256 for t in out[s]]
            return out

    trails = {}
    for drafter in (Turning(streams), OracleDrafter(streams)):
        sched = ServingScheduler(teng, decode_horizon_steps=8,
                                 spec_drafter=drafter, spec_k=8, **CFG)
        trail = trails[drafter.name] = []
        update = sched._update_spec_k

        def spy(req, proposed, accepted, update=update, trail=trail):
            update(req, proposed, accepted)
            trail.append(req._spec_k)
        sched._update_spec_k = spy
        reqs = [sched.submit(p, max_new_tokens=m)
                for p, m in zip(prompts, max_new)]
        streams.update({r.rid: w for r, w in zip(reqs, want)})
        got = sched.run()
        assert [got[r.rid] for r in reqs] == want
        assert all(r._spec_k == 8 for r in reqs)
        assert sched.kv.pool.pages_in_use == 0
    assert 1 in trails["turning"], trails["turning"]
    assert set(trails["oracle"]) == {8}
    assert sched.metrics.spec_acceptance_rate() > 0.9
    assert sched.metrics.spec_mean_accepted() > 2.0


def test_draft_model_drafter_token_exact(engines):
    """A 1-layer seeded draft model on its own paged pool: exact, and
    both pools drain."""
    _, teng = engines
    draft_eng = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny(num_layers=1)), dtype="float32",
        kv_cache_dtype="float32", device="cpu").init_params(1)
    drafter = DraftModelDrafter(draft_eng, num_slots=CFG["num_slots"],
                                num_pages=24, page_size=8,
                                max_pages_per_slot=8, prefill_chunk=8)
    prompts = _prompts(0, (5, 9, 7))
    max_new = [20, 14, 16]
    want = _want(engines, prompts, max_new)
    sched, on = _serve(teng, prompts, max_new, spec_decode="draft",
                       spec_drafter=drafter, spec_k=4)
    assert on == want
    assert sched.metrics.spec_dispatches > 0
    assert sched.metrics.spec_degraded == 0
    assert sched.kv.pool.pages_in_use == 0
    assert drafter.kv.pool.pages_in_use == 0, "draft pool leaked pages"


def test_target_as_draft_keeps_the_written_watermark(engines):
    """Full acceptance: the draft scan never writes K/V for its last
    proposal, so the verified boundary passes the written watermark by
    one; ``_written`` must never claim that hole.  The target drafting
    for itself accepts every draft."""
    _, teng = engines
    audited = []

    class Audit(DraftModelDrafter):
        def on_verified(self, slot, req, n_emitted, n_accepted):
            watermark = int(self.lengths[slot])
            super().on_verified(slot, req, n_emitted, n_accepted)
            audited.append((int(self._written[slot]), watermark))

    drafter = Audit(teng, num_slots=CFG["num_slots"], num_pages=24,
                    page_size=8, max_pages_per_slot=8, prefill_chunk=8)
    prompts = _prompts(5, (6, 8, 11))
    max_new = [24, 20, 17]
    want = _want(engines, prompts, max_new)
    sched, on = _serve(teng, prompts, max_new, spec_decode="draft",
                       spec_drafter=drafter, spec_k=4)
    assert on == want
    assert sched.metrics.spec_acceptance_rate() == 1.0
    assert audited and all(w <= mark for w, mark in audited)
    assert drafter.kv.pool.pages_in_use == 0


def test_draft_pool_smaller_than_the_target_degrades_to_no_proposal(engines):
    _, teng = engines
    draft_eng = deepspeed_tpu_torch.init_inference(
        Llama(llama_tiny(num_layers=1)), dtype="float32",
        kv_cache_dtype="float32", device="cpu").init_params(2)
    # draft slots hold 16 tokens; the requests run well past that
    drafter = DraftModelDrafter(draft_eng, num_slots=CFG["num_slots"],
                                num_pages=8, page_size=8,
                                max_pages_per_slot=2, prefill_chunk=8)
    prompts = _prompts(13, (5, 7))
    max_new = [30, 30]
    want = _want(engines, prompts, max_new)
    sched, on = _serve(teng, prompts, max_new, spec_decode="draft",
                       spec_drafter=drafter, spec_k=4)
    assert on == want
    assert sched.metrics.spec_degraded == 0, \
        list(sched.metrics.spec_degrade_log)
    assert sched.kv.pool.pages_in_use == 0
    assert drafter.kv.pool.pages_in_use == 0


def test_spec_eviction_under_pressure(engines):
    """The K bucket shrinks first, then preempt-the-youngest runs; the
    preempted request comes back token-exact through re-prefill."""
    _, teng = engines
    prompts = _prompts(0, (5, 9, 5))
    max_new = [50, 50, 50]
    want = _want(engines, prompts, max_new)
    sched = ServingScheduler(teng, decode_horizon_steps=8,
                             spec_decode="ngram", spec_k=8, **CFG)
    hostage = sched.kv.pool.allocate(15)    # 9 pages left, 18+ needed
    _, got = _serve(teng, prompts, max_new, sched=sched)
    assert got == want
    assert sched.metrics.preemptions > 0
    assert sched.kv.pool.pages_in_use == 15
    sched.kv.pool.free(hostage)


def test_drafter_exception_degrades_one_request(engines):
    _, teng = engines
    prompts = _prompts(3, (6, 8))
    max_new = [14, 14]
    want = _want(engines, prompts, max_new)

    class Faulty(NgramDrafter):
        bad_rid = None

        def propose(self, items):
            if any(req.rid == self.bad_rid for _, req, _ in items):
                raise RuntimeError("drafter exploded")
            return super().propose(items)

    drafter = Faulty()
    sched = ServingScheduler(teng, decode_horizon_steps=8,
                             spec_drafter=drafter, spec_k=4, **CFG)
    reqs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_new)]
    drafter.bad_rid = reqs[0].rid
    got = sched.run()
    assert [got[r.rid] for r in reqs] == want
    assert all(r.state == "finished" for r in reqs)
    assert sched.metrics.spec_degraded >= 1 and reqs[0]._spec_off
    assert not reqs[1]._spec_off
    assert sched.kv.pool.pages_in_use == 0


def test_numpy_array_drafts_are_accepted(engines):
    _, teng = engines
    motif = np.array([11, 12, 13, 14, 15, 16], np.int32)
    prompts = [np.tile(motif, 4)]
    want = _want(engines, prompts, [24])

    class NumpyNgram(NgramDrafter):
        def propose(self, items):
            return {s: np.asarray(d, np.int64)
                    for s, d in super().propose(items).items()}

    sched, got = _serve(teng, prompts, [24], spec_drafter=NumpyNgram(),
                        spec_k=4)
    assert got == want
    assert sched.metrics.spec_degraded == 0
    assert sched.metrics.spec_accepted > 0


def test_minority_proposer_rides_the_plain_horizon(engines):
    """Proposals for 1 of 3 running slots: no verify round, only plain
    horizons, token-exact."""
    _, teng = engines
    prompts = _prompts(11, (6, 7, 8))
    max_new = [16, 16, 16]
    want = _want(engines, prompts, max_new)
    streams = {}

    class OneSlot(OracleDrafter):
        def propose(self, items):
            return super().propose([min(items, key=lambda i: i[1].rid)])

    sched = ServingScheduler(teng, decode_horizon_steps=8,
                             spec_drafter=OneSlot(streams), spec_k=8, **CFG)
    reqs = [sched.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_new)]
    streams.update({r.rid: w for r, w in zip(reqs, want)})
    got = sched.run()
    assert [got[r.rid] for r in reqs] == want
    assert sched.metrics.spec_dispatches == 0
    assert sched.kv.pool.pages_in_use == 0


@pytest.mark.parametrize("kw", [{}, {"spec_drafter": NgramDrafter()}])
def test_unknown_spec_mode_rejected_even_with_a_drafter(engines, kw):
    _, teng = engines
    with pytest.raises(ValueError, match="unknown spec_decode"):
        ServingScheduler(teng, spec_decode="ngarm", **kw, **CFG)


def test_draft_mode_needs_a_drafter(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="spec_drafter"):
        ServingScheduler(teng, spec_decode="draft", **CFG)


def test_spec_off_wins_over_a_supplied_drafter(engines):
    _, teng = engines
    prompts = _prompts(3, (6,))
    want = _want(engines, prompts, [10])
    sched, got = _serve(teng, prompts, [10], spec_decode="off",
                        spec_drafter=NgramDrafter(), spec_k=4)
    assert got == want
    assert sched.spec_mode == "off" and sched._spec is None
    assert sched.summary()["spec_decode"] == "off"
    assert sched.metrics.spec_dispatches == 0


def test_truncate_slot_never_frees_shared_pages():
    """A dropped page another holder still references keeps that
    reference; exclusively held pages recycle; the boundary page stays."""
    kv = PagedKVManager(num_pages=8, page_size=4, num_slots=2,
                        max_pages_per_slot=6)
    assert kv.ensure_capacity(0, 20)            # 5 pages
    pages = list(kv._slot_pages[0])
    shared = pages[3]
    kv.pool.share([shared])                     # a second holder
    assert kv.truncate_slot(0, 9) == 2          # keep ceil(9 / 4) = 3
    assert kv._slot_pages[0] == pages[:3]
    assert list(kv.table[0, :3]) == pages[:3]
    assert not kv.table[0, 3:].any()
    assert kv.pool.ref_count(shared) == 1
    assert kv.pool.ref_count(pages[4]) == 0
    assert kv.pool.free_pages == 8 - 4
    assert kv.truncate_slot(0, 0) == 3
    assert kv.pool.free_pages == 7 and kv.pool.ref_count(shared) == 1
    kv.pool.free([shared])
    assert kv.pool.free_pages == 8


def test_page_pool_share_and_free_reject_atomically():
    kv = PagedKVManager(num_pages=4, page_size=4, num_slots=1,
                        max_pages_per_slot=4)
    assert kv.ensure_capacity(0, 8)
    held = list(kv._slot_pages[0])
    free_id = next(p for p in range(4) if p not in held)
    with pytest.raises(ValueError, match="not currently allocated"):
        kv.pool.share([held[0], free_id])
    assert kv.pool.ref_count(held[0]) == 1 and kv.pool.total_shares == 0
    with pytest.raises(ValueError, match="double free"):
        kv.pool.free([held[0], held[0]])
    assert kv.pool.ref_count(held[0]) == 1
    assert kv.release_slot(0) == 2 and kv.pool.free_pages == 4


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels "
                    "have no CPU or interpret mode")
    return torch.device("cuda")


# head_dim 32: a whole number of 16-byte loads of every pool dtype
CARD_CFG = dict(hidden_size=128, num_heads=4, num_kv_heads=2,
                intermediate_size=256, num_layers=2)
SLOTS, PAGES, PS, MAXP = 4, 24, 8, 6


def _twins(cuda, dtype="float32", kv="float32", seed=0):
    model = Llama(llama_tiny(**CARD_CFG), device=cuda)
    kw = dict(dtype=dtype, kv_cache_dtype=kv, max_out_tokens=128)
    graph = deepspeed_tpu_torch.init_inference(model, **kw).init_params(seed)
    eager = deepspeed_tpu_torch.init_inference(model, enable_cuda_graph=False,
                                               **kw)
    return graph, eager


def _filled_pools(engine, seed):
    from deepspeed_tpu_torch.ops.quant.kv import paged_write
    pools = engine.init_paged_cache(PAGES, PS)
    cfg = engine.module.cfg
    g = torch.Generator(device=engine.device).manual_seed(seed)
    ids = torch.arange(PAGES, device=engine.device)[:, None].expand(PAGES, PS)
    offs = torch.arange(PS, device=engine.device)[None].expand(PAGES, PS)
    for layer in pools["layers"]:
        k, v = (torch.randn(PAGES, PS, cfg.num_kv_heads, cfg.head_dim,
                            generator=g, device=engine.device)
                for _ in range(2))
        paged_write(layer, ids, offs, k, v)
    return pools


def _clone(pools):
    return {"layers": [{k: t.clone() for k, t in layer.items()}
                       for layer in pools["layers"]]}


def _pools_equal(a, b):
    """Every page but the sink, which takes the warm-up's rows."""
    return all(torch.equal(x[:-1], y[:-1])
               for la, lb in zip(a["layers"], b["layers"])
               for x, y in zip(la.values(), lb.values()))


def _verify_inputs(seed, k):
    rng = np.random.default_rng(seed)
    table = rng.permutation(PAGES)[:SLOTS * MAXP].reshape(SLOTS, MAXP)
    return dict(toks=rng.integers(0, 256, SLOTS).astype(np.int32),
                drafts=rng.integers(0, 256, (SLOTS, k)).astype(np.int32),
                active=np.array([True, True, False, True]),
                page_table=table.astype(np.int32),
                lengths=np.array([3, 15, 0, 30], np.int32),
                widths=np.array([k, min(1, k), k, 0], np.int32),
                budgets=np.array([8, 3, 0, 8], np.int32),
                eos_ids=np.full(SLOTS, -1, np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_replayed_verify_equals_eager_for_every_k_bucket(cuda, kv):
    graph, eager = _twins(cuda, kv=kv)
    pools_g = _filled_pools(graph, seed=1)
    pools_e = _clone(pools_g)
    # a replayed decode horizon first, on the same pools
    x = _verify_inputs(9, 1)
    del x["drafts"], x["widths"]
    out_g = graph.decode_multi(**x, pools=pools_g, horizon=4)
    out_e = eager.decode_multi(**x, pools=pools_e, horizon=4)
    assert all(torch.equal(a, b) for a, b in zip(out_g[:6], out_e[:6]))
    for k in (1, 2, 4, 8, 4):        # the last replays a captured bucket
        x = _verify_inputs(10 + k, k)
        out_g = graph.verify_multi(**x, pools=pools_g)
        out_e = eager.verify_multi(**x, pools=pools_e)
        assert all(torch.equal(a, b) for a, b in zip(out_g[:7], out_e[:7]))
        assert _pools_equal(pools_g, pools_e), k
    assert graph.serving_verify_capture_count() == 4
    assert eager.serving_verify_capture_count() == 0


@pytest.mark.cuda
def test_verify_graphs_die_with_their_pools_and_follow_weights(cuda):
    graph, eager = _twins(cuda)
    x = _verify_inputs(20, 2)
    for i in range(2):
        pools = graph.init_paged_cache(PAGES, PS)
        graph.verify_multi(**x, pools=pools)
        graph.verify_multi(**x, pools=pools)       # a replay
        assert graph.serving_verify_capture_count() == i + 1
        leaf = weakref.ref(next(iter(pools["layers"][0].values())))
        del pools
        gc.collect()
        assert leaf() is None and not graph._graphs
    pools_g = _filled_pools(graph, seed=3)
    pools_e = _clone(pools_g)
    graph.verify_multi(**x, pools=pools_g)
    eager.verify_multi(**x, pools=pools_e)
    # another engine recasts the module: the weights move (the old
    # tensors are held, so the new ones lie at other addresses)
    old = [t.detach() for t in graph.module.parameters()]
    deepspeed_tpu_torch.init_inference(
        graph.module, dtype="bfloat16", kv_cache_dtype="bfloat16",
        enable_cuda_graph=False)
    eager = deepspeed_tpu_torch.init_inference(
        graph.module, dtype="float32", kv_cache_dtype="float32",
        max_out_tokens=128, enable_cuda_graph=False)
    got = graph.verify_multi(**x, pools=pools_g)
    want = eager.verify_multi(**x, pools=pools_e)
    assert graph.serving_verify_capture_count() == 4
    assert all(torch.equal(a, b) for a, b in zip(got[:7], want[:7]))
    assert _pools_equal(pools_g, pools_e)
    del old


@pytest.mark.cuda
@pytest.mark.parametrize("drafter", ["ngram", "self"])
def test_spec_serving_on_graphs_is_token_exact(cuda, drafter):
    """Verify rounds and replayed decode horizons on one pool set: every
    stream equals generate(); verify captures stay within the K buckets
    and a second run on the scheduler captures nothing."""
    graph, _ = _twins(cuda)
    motif = np.array([11, 12, 13, 14, 15, 16], np.int32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (5, 9, 12)] + [np.tile(motif, 3)]
    max_new = [14, 9, 20, 22]
    want = [[int(t) for t in graph.generate(p[None], max_new_tokens=m)[
        0, len(p):]] for p, m in zip(prompts, max_new)]
    kw = dict(spec_decode="ngram") if drafter == "ngram" else dict(
        spec_drafter=DraftModelDrafter(graph, num_slots=3, num_pages=PAGES,
                                       page_size=PS, max_pages_per_slot=MAXP,
                                       prefill_chunk=8))
    sched = ServingScheduler(graph, num_slots=3, num_pages=PAGES,
                             page_size=PS, max_pages_per_slot=MAXP,
                             prefill_chunk=8, spec_k=4, **kw)
    for run in range(2):
        before = graph.serving_verify_capture_count()
        _, got = _serve(None, prompts, max_new, sched=sched)
        assert got == want
        assert sched.kv.pool.pages_in_use == 0
        captured = graph.serving_verify_capture_count() - before
        if run == 0:
            assert 1 <= captured <= len(sched.spec_k_buckets)
        else:
            assert captured == 0, "the steady run captured"

    assert sched.metrics.spec_dispatches > 0
    assert sched.metrics.spec_degraded == 0
    assert graph.serving_decode_multi_capture_count() >= 1
