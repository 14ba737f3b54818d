"""Per-request sampling and grammar policies on the PyTorch port's
``ServingScheduler``, held against the JAX package on the CPU at
``llama_tiny`` size (fp32) by a teacher-forced oracle.

The JAX scheduler is not the oracle: it aliases host arrays it mutates
into asynchronous dispatches (ROADMAP.md Queue C), and its sampled
eviction oracle fails from run to run.  Instead, for every request the
port served, the JAX model's full forward over prompt + output gives the
logits of every emitted position; the JAX ``process_logits`` with the
request's lanes, the token counts of its history and its grammar mask
(from the JAX ``TokenDFA``, equal to the port's in every state visited),
then ``sample_processed`` on the request's key at that position must
give the port's token.  Inside a speculative round the JAX
``accept_or_resample`` decides the drafted columns.  This holds at
horizons 1 and 8, with overlap on and off, under forced eviction, with
the prefix cache and with n-gram spec decoding.

The ``cuda`` cases hold the policy graphs against the eager bodies on
the card and skip here.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import (Llama, llama_params_from_jax,
                                              llama_tiny)
from deepspeed_tpu_torch.serving import Drafter, ServingScheduler
from deepspeed_tpu_torch.serving.sampling import request_key

VOCAB = 256
EOS = 255
CFG = dict(num_slots=3, num_pages=40, page_size=8, max_pages_per_slot=12,
           prefill_chunk=8)
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.95)
PENALIZED = dict(do_sample=True, temperature=1.1, top_p=0.9,
                 repetition_penalty=1.3, presence_penalty=0.5,
                 frequency_penalty=0.3)
POLICIES = [None, SAMPLED, PENALIZED, dict(repetition_penalty=1.5),
            dict(do_sample=True, temperature=0.6, top_k=8)]
GRAMMARS = [{"regex": "[a-f]{2,6}(x|yz)"},
            {"json_schema": {"type": "object", "properties": {
                "id": {"type": "integer"},
                "tag": {"type": "string", "maxLength": 4}}}}]


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


def _prompts(seed, lens, prefix=None):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 200, n).astype(np.int32) for n in lens]
    if prefix is not None:
        out = [np.concatenate([prefix, p]) for p in out]
    return out


def _submit_mix(sched, prompts, max_new, grammar=True, policies=POLICIES):
    """Requests cycling over ``policies`` (seeded per request); with
    ``grammar`` the last two carry GRAMMARS (and EOS) and a budget of at
    least 36 tokens, which holds the longest output either admits."""
    reqs = []
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        kw = dict(sampling=policies[i % len(policies)], seed=1000 + i)
        if grammar and i >= len(prompts) - 2:
            kw.update(grammar=GRAMMARS[i - len(prompts) + 2],
                      eos_token_id=EOS, sampling=SAMPLED)
            m = max(m, 36)
        reqs.append(sched.submit(p, max_new_tokens=m, **kw))
    return reqs


def _log_rounds(engine, sched):
    """Record every policy verify round: rid -> [(position, drafts)]."""
    rounds = {}
    inner = engine.verify_multi_policy

    def logged(toks, drafts, active, *a, widths, tok_base, **kw):
        for s in np.flatnonzero(active):
            rounds.setdefault(sched.slot_req[s].rid, []).append(
                (int(tok_base[s]), [int(t) for t in drafts[s][:widths[s]]]))
        return inner(toks, drafts, active, *a, widths=widths,
                     tok_base=tok_base, **kw)
    engine.verify_multi_policy = logged
    return rounds


class Oracle:
    """The teacher-forced JAX oracle (see the module docstring)."""

    def __init__(self, jeng):
        import jax
        import jax.numpy as jnp

        from deepspeed_tpu.serving.sampling import grammar as jg
        from deepspeed_tpu.serving.sampling import pipeline as jp
        self.jeng, self.jnp, self.jg = jeng, jnp, jg
        # jitted once: the eager chain dispatches op by op, per token
        self.process = jax.jit(jp.process_logits)
        self.sample = jax.jit(jp.sample_processed)
        self.accept = jax.jit(jp.accept_or_resample)
        self.masks_checked = 0
        self.draft_columns = 0

    def logits(self, seq):
        ids = np.zeros((1, 128), np.int32)      # one jit shape: causal
        ids[0, :len(seq)] = seq
        return np.asarray(self.jeng.forward(ids))[0]

    def check(self, req, rounds=()):
        jnp = self.jnp
        sp = req.sampling
        out = req.out_tokens
        seq = req.orig_prompt + out
        assert len(seq) <= 128
        logits = self.logits(seq)
        lanes = dict(
            temps=np.float32([sp.staged_temperature]),
            top_ks=np.int32([0 if sp.is_greedy else sp.top_k]),
            top_ps=np.float32([1.0 if sp.is_greedy else sp.top_p]),
            rep_pens=np.float32([sp.repetition_penalty]),
            pres_pens=np.float32([sp.presence_penalty]),
            freq_pens=np.float32([sp.frequency_penalty]))
        key = request_key(req.seed)[None]
        ref = port = None
        if req.grammar is not None:
            ref = self.jg.compile_grammar(req.grammar.spec, VOCAB,
                                          eos_token_id=req.eos_token_id)
            port = req.grammar.fresh()
        starts = {base: d for base, d in rounds}
        live = None                              # (base, drafts) of a round
        for n, tok in enumerate(out):
            counts = np.bincount(np.asarray(req.orig_prompt + out[:n]),
                                 minlength=VOCAB)[None].astype(np.int32)
            mask = np.ones((1, VOCAB), bool)
            if ref is not None:
                mask[0] = ref.token_mask()
                np.testing.assert_array_equal(port.token_mask(), mask[0])
                self.masks_checked += 1
            x = self.process(jnp.asarray(logits[len(req.orig_prompt)
                                                - 1 + n][None]),
                             jnp.asarray(counts), jnp.asarray(mask),
                             **{k: jnp.asarray(v) for k, v in lanes.items()})
            if n in starts:
                live = (n, starts[n])
            want = None
            if live is not None and n - live[0] < len(live[1]):
                d = live[1][n - live[0]]
                acc, fallback = self.accept(
                    x, jnp.int32([d]), key, jnp.int32(n), lanes["temps"])
                self.draft_columns += 1
                want = d if bool(acc[0]) else int(fallback[0])
                if not bool(acc[0]):
                    live = None
            if want is None:
                live = None
                want = int(self.sample(x, key, jnp.int32(n),
                                       lanes["temps"])[0])
            assert tok == want, (f"rid {req.rid} token {n}: port {tok}, "
                                 f"oracle {want} ({sp!r})")
            if ref is not None:
                ref.advance(tok)
                port.advance(tok)
        if ref is not None:
            assert req.grammar.done and ref.done, "grammar left open"
            assert req.grammar.accepts(out), (req.grammar.spec, out)
            assert ref.accepts(out)


def _serve(teng, prompts, max_new, grammar=True, spec=False,
           policies=POLICIES, **kw):
    sched = ServingScheduler(teng, **{**CFG, **kw})
    rounds = _log_rounds(teng, sched) if spec else {}
    try:
        reqs = _submit_mix(sched, prompts, max_new, grammar, policies)
        got = sched.run()
    finally:
        if spec:
            del teng.verify_multi_policy
    for r in reqs:
        assert r.state == "finished", (r.rid, r.state, r.error)
        assert got[r.rid] == r.out_tokens
    return sched, reqs, rounds


# ------------------------------------------------ the teacher-forced oracle


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "barrier"])
@pytest.mark.parametrize("horizon", [1, 8])
def test_teacher_forced_oracle(engines, horizon, overlap):
    """A mixed batch (greedy, sampled, penalized, penalized greedy, two
    grammars) over more requests than slots."""
    jeng, teng = engines
    prompts = _prompts(horizon + 10 * overlap, (5, 17, 9, 23, 12, 6, 8))
    max_new = [20, 14, 30, 9, 25, 30, 40]
    sched, reqs, _ = _serve(teng, prompts, max_new,
                            decode_horizon_steps=horizon, overlap=overlap)
    oracle = Oracle(jeng)
    for r in reqs:
        oracle.check(r)
    assert oracle.masks_checked > 0
    assert sched.metrics.policy_dispatches > 0
    assert sched.kv.pool.pages_in_use == 0


def test_teacher_forced_oracle_under_forced_eviction(engines):
    jeng, teng = engines
    prompts = _prompts(3, (12, 7, 12, 5))
    max_new = [24, 26, 20, 30]
    sched, reqs, _ = _serve(teng, prompts, max_new, num_pages=6,
                            max_pages_per_slot=6, decode_horizon_steps=8)
    assert sched.metrics.preemptions > 0, "the pool was sized to evict"
    oracle = Oracle(jeng)
    for r in reqs:
        oracle.check(r)
    assert sched.kv.pool.pages_in_use == 0


def test_teacher_forced_oracle_with_prefix_cache(engines):
    """Shared 20-token prefix, tails ending mid-page: later requests hit
    the donated pages, full and copied-on-write."""
    jeng, teng = engines
    prefix = _prompts(4, (20,))[0]
    prompts = _prompts(5, (3, 9, 5, 12, 2, 6), prefix=prefix)
    max_new = [10, 12, 16, 8, 14, 12]
    sched, reqs, _ = _serve(teng, prompts, max_new, prefix_cache=True,
                            decode_horizon_steps=8)
    s = sched.summary()
    assert s["prefix_hits"] > 0 and s["prefix_cow_copies"] > 0, s
    oracle = Oracle(jeng)
    for r in reqs:
        oracle.check(r)
    sched.prefix_cache.evict(10 ** 6)
    assert sched.kv.pool.pages_in_use == 0


class ArgmaxDrafter(Drafter):
    """Proposes the port model's argmax after the history, repeated: the
    first column is often accepted at low temperature, the repeats are
    mostly rejected, so both paths of the rejection sampler run."""

    name = "argmax"
    supports_sampling = True

    def __init__(self, engine):
        self.engine = engine

    def propose(self, items):
        out = {}
        for slot, req, k in items:
            hist = np.asarray(req.orig_prompt + req.out_tokens, np.int32)
            top = int(self.engine.forward(hist[None])[0, -1].argmax())
            out[slot] = [top] * k
        return out


SPEC_POLICIES = [dict(do_sample=True, temperature=0.1),
                 None, dict(do_sample=True, temperature=0.3, top_p=0.9),
                 SAMPLED, PENALIZED]


@pytest.mark.parametrize("drafter", ["ngram", "argmax"])
def test_teacher_forced_oracle_with_spec(engines, drafter):
    """Sampled rows verify by rejection sampling (``verify_multi_policy``)
    and grammar rows ride the rounds undrafted.  The n-gram drafter
    proposes on repetitive prompts, which low-temperature rows keep
    looping; the argmax drafter proposes for every row."""
    jeng, teng = engines
    motif = np.array([11, 12, 13, 14, 15, 16, 17], np.int32)
    prompts = [np.tile(motif, 3), np.tile(motif[:4], 5),
               np.tile(motif[2:], 4)] + _prompts(6, (7, 9, 6))
    max_new = [24, 30, 20, 18, 16, 22]
    kw = dict(spec_decode="ngram") if drafter == "ngram" else dict(
        spec_drafter=ArgmaxDrafter(teng))
    sched, reqs, rounds = _serve(teng, prompts, max_new, spec=True,
                                 policies=SPEC_POLICIES, spec_k=4,
                                 decode_horizon_steps=8, **kw)
    assert sched.metrics.spec_dispatches > 0
    assert sched.metrics.spec_accepted > 0
    assert any(d for rs in rounds.values() for _, d in rs), \
        "no policy verify round carried a draft"
    oracle = Oracle(jeng)
    for r in reqs:
        oracle.check(r, rounds.get(r.rid, ()))
    assert oracle.draft_columns > 0
    assert sched.kv.pool.pages_in_use == 0
    assert sched.metrics.spec_degraded == 0


# ------------------------------------------------- invariance in the port


def test_sampled_streams_invariant_across_schedules(engines):
    """A request's stream is a function of (params, seed, prompt): the
    horizon, overlap, eviction and the prefix cache change nothing."""
    _, teng = engines
    prefix = _prompts(7, (16,))[0]
    prompts = _prompts(8, (5, 11, 4, 9), prefix=prefix)
    max_new = [18, 22, 15, 20]
    runs = []
    for kw in (dict(decode_horizon_steps=1),
               dict(decode_horizon_steps=8),
               dict(decode_horizon_steps=8, overlap=False),
               dict(decode_horizon_steps=4, num_pages=8,
                    max_pages_per_slot=8),
               dict(decode_horizon_steps=8, prefix_cache=True)):
        _, reqs, _ = _serve(teng, prompts, max_new, grammar=False, **kw)
        runs.append([r.out_tokens for r in reqs])
    assert all(r == runs[0] for r in runs[1:])


def test_greedy_rows_of_a_mixed_batch_equal_generate(engines):
    jeng, teng = engines
    prompts = _prompts(9, (6, 13, 8, 10, 7))
    max_new = [12, 10, 14, 9, 11]
    _, reqs, _ = _serve(teng, prompts, max_new, grammar=False,
                        decode_horizon_steps=8)
    for i, (r, p, m) in enumerate(zip(reqs, prompts, max_new)):
        if POLICIES[i % len(POLICIES)] is None:
            want = [int(t) for t in jeng.generate(p[None], max_new_tokens=m)[
                0, len(p):]]
            assert r.out_tokens == want


def test_greedy_traffic_takes_no_policy_path(engines):
    """The JAX ``test_greedy_traffic_rides_legacy_signatures``: greedy
    requests under a greedy default never run a policy body — with
    overlap, spec decoding or the prefix cache — and stay token-exact."""
    _, teng = engines
    calls = []
    names = ("decode_multi_policy", "verify_multi_policy",
             "sample_from_logits_policy")
    for name in names:
        inner = getattr(teng, name)
        setattr(teng, name, lambda *a, _f=inner, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    try:
        prompts = _prompts(10, (6, 9, 14)) + [np.tile(
            np.array([3, 4, 5], np.int32), 5)]
        max_new = [10, 12, 8, 16]
        want = [[int(t) for t in teng.generate(p[None], max_new_tokens=m)[
            0, len(p):]] for p, m in zip(prompts, max_new)]
        for kw in (dict(), dict(spec_decode="ngram"),
                   dict(prefix_cache=True)):
            sched = ServingScheduler(teng, **{**CFG, **kw})
            reqs = [sched.submit(p, max_new_tokens=m,
                                 sampling=dict(do_sample=False), seed=3)
                    for p, m in zip(prompts, max_new)]
            got = sched.run()
            assert [got[r.rid] for r in reqs] == want
            assert sched.metrics.policy_dispatches == 0
            assert sched._tok_counts is None
    finally:
        for name in names:
            del teng.__dict__[name]
    assert calls == []


class GreedyOnlyDrafter(Drafter):
    """Proposes the last token again, without ``supports_sampling``."""

    name = "greedy-only"

    def propose(self, items):
        return {s: [r.out_tokens[-1]] * k for s, r, k in items}


def test_drafter_without_sampling_support(engines):
    """Under a sampled default the drafter is off, with the reason; under
    a greedy default it drafts only for the greedy requests."""
    _, teng = engines
    sched = ServingScheduler(teng, do_sample=True, temperature=0.9,
                             spec_drafter=GreedyOnlyDrafter(), **CFG)
    assert sched.spec_mode == "off (drafter lacks supports_sampling)"
    asked = []
    drafter = GreedyOnlyDrafter()
    inner = drafter.propose
    drafter.propose = lambda items: (asked.extend(
        r.rid for _, r, _ in items), inner(items))[1]
    sched = ServingScheduler(teng, spec_drafter=drafter, **CFG)
    prompts = _prompts(11, (6, 7))
    greedy = sched.submit(prompts[0], max_new_tokens=12)
    sampled = sched.submit(prompts[1], max_new_tokens=12, sampling=SAMPLED)
    sched.run()
    assert greedy.rid in asked and sampled.rid not in asked
    assert greedy.state == sampled.state == "finished"


def test_sampled_default_and_explicit_greedy_request(engines):
    """A sampled scheduler default applies to every request that does not
    override it; an explicitly greedy request stays argmax-exact on the
    policy path."""
    _, teng = engines
    prompts = _prompts(12, (6, 9))
    sched = ServingScheduler(teng, do_sample=True, temperature=0.9,
                             top_k=40, **CFG)
    a = sched.submit(prompts[0], max_new_tokens=10, seed=5)
    g = sched.submit(prompts[1], max_new_tokens=10,
                     sampling=dict(do_sample=False))
    sched.run()
    assert a.sampling.label() == "T=0.9,k=40" and g.sampling.is_greedy
    want = [int(t) for t in teng.generate(prompts[1][None],
                                          max_new_tokens=10)[0, 9:]]
    assert g.out_tokens == want
    s = sched.summary()
    assert s["decoding_policy"] == "T=0.9,k=40"
    assert s["sampled_requests"] == 1 and s["policy_dispatches"] > 0
    # the same seed gives the same stream on a fresh scheduler, also as
    # the scheduler's default seed
    again = ServingScheduler(teng, do_sample=True, temperature=0.9,
                             top_k=40, seed=5, **CFG)
    b = again.submit(prompts[0], max_new_tokens=10)
    again.run()
    assert b.seed == 5 and b.out_tokens == a.out_tokens


def test_grammar_counters_and_bad_specs(engines):
    _, teng = engines
    sched = ServingScheduler(teng, **CFG)
    with pytest.raises(ValueError):
        sched.submit(np.arange(4, dtype=np.int32), grammar={"nope": 1})
    with pytest.raises(ValueError, match="unknown sampling params"):
        sched.submit(np.arange(4, dtype=np.int32), sampling={"topk": 3})
    with pytest.raises(ValueError):
        ServingScheduler(teng, top_p=0.0, **CFG)
    r = sched.submit(np.arange(4, dtype=np.int32), max_new_tokens=30,
                     grammar=GRAMMARS[0], eos_token_id=EOS)
    sched.run()
    assert r.state == "finished" and r.grammar.accepts(r.out_tokens)
    s = sched.summary()
    assert s["grammar_requests"] == 1 and s["grammar_violations"] == 0
    assert sched.metrics.horizons and set(sched.metrics.horizons) == {1}


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels "
                    "have no CPU or interpret mode")
    return torch.device("cuda")


CARD_CFG = dict(hidden_size=128, num_heads=4, num_kv_heads=2,
                intermediate_size=256, num_layers=2)


def _card_twins(cuda, dtype="float32", kv="float32"):
    model = Llama(llama_tiny(**CARD_CFG), device=cuda)
    kw = dict(dtype=dtype, kv_cache_dtype=kv, max_out_tokens=128)
    graph = deepspeed_tpu_torch.init_inference(model, **kw).init_params(0)
    eager = deepspeed_tpu_torch.init_inference(model, enable_cuda_graph=False,
                                               **kw)
    return graph, eager


def _policy_lanes(slots, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3, (slots, VOCAB)).astype(np.int32)
    mask = rng.random((slots, VOCAB)) < 0.8
    mask[0] = True
    return dict(keys=np.stack([request_key(seed + i) for i in range(slots)]),
                tok_base=rng.integers(0, 40, slots).astype(np.int32),
                temps=np.float32([0.0, 0.8, 1.0, 0.6][:slots]),
                top_ks=np.int32([0, 50, 0, 8][:slots]),
                top_ps=np.float32([1.0, 0.95, 0.9, 1.0][:slots]),
                rep_pens=np.float32([1.0, 1.2, 1.0, 1.5][:slots]),
                pres_pens=np.float32([0.0, 0.5, 0.2, 0.0][:slots]),
                freq_pens=np.float32([0.0, 0.3, 0.0, 0.1][:slots]),
                counts=counts, mask=mask)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_policy_graphs_replay_equal_eager(cuda, kv):
    """``decode_multi_policy`` (with a chained continuation off its
    device carries, counts included) and ``verify_multi_policy`` replayed
    from graphs equal the eager bodies bit for bit; new lanes replay the
    same graphs."""
    graph, eager = _card_twins(cuda, kv=kv)
    slots, pages, ps, maxp = 4, 24, 8, 6
    rng = np.random.default_rng(1)
    table = rng.permutation(pages)[:slots * maxp].reshape(
        slots, maxp).astype(np.int32)
    base = dict(toks=rng.integers(0, VOCAB, slots).astype(np.int32),
                active=np.array([True, True, False, True]),
                page_table=table,
                lengths=np.array([3, 15, 0, 20], np.int32),
                budgets=np.array([12, 5, 0, 12], np.int32),
                eos_ids=np.full(slots, -1, np.int32))
    pools = {e: e.init_paged_cache(pages, ps) for e in (graph, eager)}
    for seed in (2, 3):
        lanes = _policy_lanes(slots, seed)
        outs = {e: e.decode_multi_policy(**base, pools=pools[e], horizon=4,
                                         **lanes) for e in (graph, eager)}
        assert all(torch.equal(a, b) for a, b in
                   zip(outs[graph][:7], outs[eager][:7]))
        chained = {}
        for e, o in outs.items():
            chained[e] = e.decode_multi_policy(
                o[2], o[3], table, o[4], pools[e], horizon=4,
                budgets=base["budgets"], eos_ids=base["eos_ids"],
                emitted=o[5], **dict(lanes, counts=o[6]))
        assert all(torch.equal(a, b) for a, b in
                   zip(chained[graph][:7], chained[eager][:7]))
        drafts = rng.integers(0, VOCAB, (slots, 4)).astype(np.int32)
        widths = np.array([4, 1, 4, 0], np.int32)
        ver = {e: e.verify_multi_policy(
            base["toks"], drafts, base["active"], table, base["lengths"],
            pools[e], widths=widths, budgets=base["budgets"],
            eos_ids=base["eos_ids"], **lanes) for e in (graph, eager)}
        assert all(torch.equal(a, b) for a, b in
                   zip(ver[graph][:8], ver[eager][:8]))
    assert graph.serving_capture_count("decode_multi_policy") == 1
    assert graph.serving_capture_count("verify_policy") == 1
    assert graph.serving_capture_count("decode_multi") == 0


@pytest.mark.cuda
def test_policy_serving_on_graphs_and_greedy_captures_no_policy_graph(cuda):
    """Greedy serving captures no policy graph; a mixed batch serves the
    eager twin's streams, and a second run captures nothing."""
    graph, eager = _card_twins(cuda)
    prompts = _prompts(13, (5, 9, 12, 7))
    max_new = [14, 9, 20, 12]
    sched = ServingScheduler(graph, **CFG)
    for p, m in zip(prompts, max_new):
        sched.submit(p, max_new_tokens=m)
    sched.run()
    assert graph.serving_capture_count("decode_multi_policy") == 0
    assert graph.serving_capture_count("verify_policy") == 0

    def run(engine, sched=None):
        sched = sched or ServingScheduler(engine, **CFG)
        reqs = _submit_mix(sched, prompts, max_new)
        got = sched.run()
        assert sched.kv.pool.pages_in_use == 0
        return sched, [got[r.rid] for r in reqs]
    sched, first = run(graph)
    _, want = run(eager)
    assert first == want
    before = graph.serving_decode_multi_capture_count()
    _, second = run(graph, sched)
    assert second == first
    assert graph.serving_decode_multi_capture_count() == before


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "int8", "fp8"])
def test_copy_page_graph_moves_every_leaf(cuda, kv):
    """One ``copy_page`` graph per pool set; every leaf of the copied
    page (a quantized pool's scale rows too) equals the source bit for
    bit, and no other page changes."""
    graph, _ = _card_twins(cuda, kv=kv)
    pools = graph.init_paged_cache(16, 8)
    g = torch.Generator(device=cuda).manual_seed(0)
    for layer in pools["layers"]:
        for t in layer.values():
            t.view(torch.uint8).copy_(torch.randint(
                0, 256, t.view(torch.uint8).shape, generator=g,
                device=cuda, dtype=torch.uint8))
    for src, dst in ((3, 9), (9, 1), (0, 15)):
        before = [{k: t.clone() for k, t in layer.items()}
                  for layer in pools["layers"]]
        assert graph.copy_page(pools, src, dst) is pools
        for old, layer in zip(before, pools["layers"]):
            for k, t in layer.items():
                assert torch.equal(t[dst].view(torch.uint8),
                                   old[k][src].view(torch.uint8))
                keep = [i for i in range(t.shape[0]) if i != dst]
                assert torch.equal(t[keep].view(torch.uint8),
                                   old[k][keep].view(torch.uint8))
    assert graph.serving_page_copy_capture_count() == 1
