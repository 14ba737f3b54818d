"""Overlapped decode horizons of the PyTorch port's ``ServingScheduler``
against the JAX package at ``llama_tiny`` size (2 layers, GQA 4/2, fp32).

With ``overlap=True`` (the default of both packages) the scheduler
chains horizon k+1 off horizon k's device carries and harvests k while
k+1 runs.  The port must emit exactly the JAX scheduler's tokens (also
with ``overlap=True``), its own ``overlap=False`` tokens and
``generate()``'s, under forced eviction, over more requests than slots
and with EOS landing inside a horizon; chaining must really happen; a
cancel, a failing token callback and a live deadline must take the paths
the JAX scheduler's overlap design gives them.  The JAX engine stages
copies of its host arrays, as ``tests/test_torch_serving.py`` does
(ROADMAP.md Queue C).  The CUDA-graph half of the design runs only on the
card (``tests/test_torch_graphs.py``).
"""

import jax
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import Llama as JaxLlama
from deepspeed_tpu.models.llama import llama_tiny as jax_llama_tiny
from deepspeed_tpu.serving import ServingScheduler as JaxScheduler
from deepspeed_tpu_torch.models.llama import (Llama, llama_params_from_jax,
                                              llama_tiny)
from deepspeed_tpu_torch.ops import launch_counter
from deepspeed_tpu_torch.serving import ServingScheduler

EVICT = dict(num_slots=3, num_pages=4, page_size=8, max_pages_per_slot=4,
             prefill_chunk=8)
ROOMY = dict(num_slots=3, num_pages=16, page_size=8, max_pages_per_slot=8,
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


def _generate(engine, prompts, max_new, eos=None):
    """Per-request generate() streams, cut after the first ``eos``."""
    out = []
    for p, m in zip(prompts, max_new):
        toks = [int(t) for t in engine.generate(p[None], max_new_tokens=m)[
            0, len(p):]]
        if eos is not None and eos in toks:
            toks = toks[:toks.index(eos) + 1]
        out.append(toks)
    return out


def _serve(sched, prompts, max_new, eos=None):
    reqs = [sched.submit(p, max_new_tokens=m, eos_token_id=eos)
            for p, m in zip(prompts, max_new)]
    got = sched.run()
    return [got[r.rid] for r in reqs]


def _count_chains(sched):
    """Wrap ``sched._try_chain``; the returned list collects its
    results."""
    results = []
    inner = sched._try_chain

    def counted():
        ok = inner()
        results.append(ok)
        return ok
    sched._try_chain = counted
    return results


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


def _three_ways(engines, prompts, max_new, kw, eos=None):
    """(JAX overlap, port overlap, port overlap=False) tokens, the port's
    overlapped scheduler and the chained dispatches of (JAX, port), each
    counted by wrapping the scheduler's ``_try_chain``."""
    jeng, teng = engines
    jsched = JaxScheduler(jeng, overlap=True, **kw)
    jchains = _count_chains(jsched)
    jax_got = _serve(jsched, prompts, max_new, eos)
    sched = ServingScheduler(teng, **kw)
    assert sched.overlap
    chains = _count_chains(sched)
    port = _serve(sched, prompts, max_new, eos)
    barrier = _serve(ServingScheduler(teng, overlap=False, **kw), prompts,
                     max_new, eos)
    return jax_got, port, barrier, sched, (sum(jchains), sum(chains))


def test_overlap_token_exact_vs_jax_under_forced_eviction(engines):
    _, teng = engines
    prompts = _prompts(1, (12, 7, 12))
    max_new = [10, 12, 8]
    want = _generate(teng, prompts, max_new)
    jax_got, port, barrier, sched, chains = _three_ways(
        engines, prompts, max_new, EVICT)
    assert port == jax_got == barrier == want
    assert chains[0] == chains[1], chains
    assert sched.metrics.preemptions > 0, \
        "pool was sized to force eviction; none happened"
    assert sched.kv.pool.pages_in_use == 0 and not sched._inflight


def test_overlap_more_requests_than_slots(engines):
    _, teng = engines
    prompts = _prompts(2, (5, 11, 5, 20, 11, 5))
    max_new = [8, 6, 10, 4, 12, 5]
    want = _generate(teng, prompts, max_new)
    jax_got, port, barrier, sched, chains = _three_ways(
        engines, prompts, max_new, dict(ROOMY, num_pages=24))
    assert port == jax_got == barrier == want
    assert chains[0] == chains[1] > 0, chains
    s = sched.summary()
    assert s["completed"] == 6 and s["tokens_emitted"] == sum(max_new)
    assert sched.metrics.horizon_tokens == sum(max_new) - len(prompts)
    assert sched.kv.pool.pages_in_use == 0


def _mid_horizon_eos(stream, lo=2):
    """A token whose first occurrence in ``stream`` is at index >= lo and
    at least two before its end: an EOS that lands inside a horizon."""
    for k in range(lo, len(stream) - 2):
        if stream.index(stream[k]) == k:
            return stream[k], k
    raise AssertionError(f"no mid-stream eos candidate in {stream}")


@pytest.mark.parametrize("horizon", [4, 8])
def test_overlap_mid_horizon_eos(engines, horizon):
    """An EOS sampled inside a horizon freezes its slot there, and the
    horizons chained after the last admission stay token-exact (the
    shape of the JAX package's
    ``test_horizon_oracle_token_exact_with_mid_horizon_eos``).  The EOS
    is taken from past the first horizons, so both schedulers chain
    before it lands."""
    _, teng = engines
    prompts = _prompts(4, (9, 5, 9, 5))
    max_new = [20, 6, 16, 3]
    base = _generate(teng, prompts, max_new)
    eos, k = _mid_horizon_eos(base[0], lo=10)
    want = _generate(teng, prompts, max_new, eos=eos)
    assert want[0] == base[0][:k + 1]
    kw = dict(ROOMY, decode_horizon_steps=horizon)
    jax_got, port, barrier, sched, chains = _three_ways(
        engines, prompts, max_new, kw, eos=eos)
    assert port == jax_got == barrier == want
    assert chains[0] == chains[1] > 0, chains
    assert all(h in sched.horizon_buckets for h in sched.metrics.horizons)
    assert sched.kv.pool.pages_in_use == 0


def test_chaining_happens_and_stays_token_exact(engines):
    """Two long requests and nothing waiting: membership freezes, so
    horizons chain off the device carries, in the port as in the JAX
    scheduler, and both give ``generate()``'s tokens."""
    jeng, teng = engines
    prompts = _prompts(5, (6, 7))
    max_new = [30, 26]
    want = _generate(teng, prompts, max_new)
    jsched = JaxScheduler(jeng, overlap=True, decode_horizon_steps=4,
                          **ROOMY)
    jchains = _count_chains(jsched)
    assert _serve(jsched, prompts, max_new) == want
    sched = ServingScheduler(teng, decode_horizon_steps=4, **ROOMY)
    chains = _count_chains(sched)
    assert _serve(sched, prompts, max_new) == want
    assert sum(chains) == sum(jchains) >= 4, (chains, jchains)
    assert not sched._inflight and not sched._zombies
    assert sched.kv.pool.pages_in_use == 0


def test_cancel_mid_horizon_honored_at_next_boundary(engines):
    """A cancel while a horizon is in flight: the tokens that horizon
    made past the cancel are dropped at its harvest, pages recycle, and
    the other request stays token-exact (the JAX package's test of the
    same name)."""
    _, teng = engines
    prompts = _prompts(3, (5, 5))
    want = _generate(teng, prompts, [10, 10])
    sched = ServingScheduler(teng, decode_horizon_steps=4, **ROOMY)
    keep = sched.submit(prompts[0], max_new_tokens=10)
    victim = sched.submit(prompts[1], max_new_tokens=10)
    sched.step()     # admit + prefill + first token + horizon dispatched
    assert sched._inflight, "overlap must leave the horizon in flight"
    assert len(victim.out_tokens) == 1   # the prefill-boundary token
    victim.cancel()
    got = sched.run()
    assert victim.state == "cancelled" and victim.rid not in got
    assert len(victim.out_tokens) == 1, \
        "tokens generated mid-horizon after cancel must be dropped"
    assert got[keep.rid] == want[0]
    assert sched.kv.pool.pages_in_use == 0, "cancel leaked pages"
    assert sched.metrics.cancelled == 1


def test_failing_callback_under_a_chained_horizon_defers_the_pages(
        engines):
    """A token callback fails while a chained horizon still runs its
    slot: the request fails at once, its pages stay held until that
    horizon is harvested, the next chained horizon freezes the slot on
    the device, and the other request stays token-exact."""
    _, teng = engines
    prompts = _prompts(6, (5, 6))
    max_new = [20, 20]
    want = _generate(teng, prompts, max_new)

    def fail_at_sixth(req, tok):
        if len(req.out_tokens) == 6:
            raise RuntimeError("client went away")

    sched = ServingScheduler(teng, decode_horizon_steps=4, **ROOMY)
    chains = _count_chains(sched)
    bad = sched.submit(prompts[0], max_new_tokens=20,
                       on_token=fail_at_sixth)
    good = sched.submit(prompts[1], max_new_tokens=20)
    sched.step()     # prefill both, first tokens, horizon 1 in flight
    sched.step()     # chain horizon 2, harvest 1 (tokens 2-5)
    assert chains == [True] and bad.state == "running"
    sched.step()     # chain horizon 3, harvest 2: the sixth token fails
    assert chains == [True, True]
    assert bad.state == "failed" and "client went away" in bad.error
    slot = next(iter(sched._zombies))
    assert sched._zombies == {slot} and sched.slot_req[slot] is None
    assert sched.kv.slot_page_count(slot) > 0, \
        "pages released while a chained horizon may still write them"
    assert sched._inflight[-1]["release_after"] == {slot}
    sched.step()     # chain horizon 4 (slot frozen), harvest 3: release
    assert chains == [True, True, True]
    assert not sched._zombies and sched.kv.slot_page_count(slot) == 0
    assert bad.out_tokens == want[0][:6]
    got = sched.run()
    assert got[good.rid] == want[1] and bad.rid not in got
    assert sched.metrics.failed == 1 and sched.kv.pool.pages_in_use == 0


def test_live_deadline_forces_the_barrier_path(engines):
    """A request with a deadline keeps every step a barrier step (a
    chained horizon could not honor the deadline at its boundary); the
    tokens do not change."""
    _, teng = engines
    prompts = _prompts(5, (6, 7))
    max_new = [30, 26]
    sched = ServingScheduler(teng, decode_horizon_steps=4, **ROOMY)
    chains = _count_chains(sched)
    reqs = [sched.submit(p, max_new_tokens=m, deadline_s=600.0)
            for p, m in zip(prompts, max_new)]
    got = sched.run()
    assert [got[r.rid] for r in reqs] == _generate(teng, prompts, max_new)
    assert chains and not any(chains)
    assert sched.kv.pool.pages_in_use == 0


def test_enable_cuda_graph_needs_a_card():
    with pytest.raises(ValueError, match="enable_cuda_graph=True"):
        deepspeed_tpu_torch.init_inference(Llama(llama_tiny()),
                                           device="cpu",
                                           enable_cuda_graph=True)
    for value in (None, False):
        eng = deepspeed_tpu_torch.init_inference(
            Llama(llama_tiny()), device="cpu", enable_cuda_graph=value)
        assert not eng.cuda_graphs
        assert eng.serving_decode_multi_capture_count() == 0


def test_launch_counter_counts_replays_not_captures():
    """What a recording collects counts only when it is replayed; other
    launches count at once."""
    a = launch_counter.LaunchCounter("x", "y")
    a.add("x")
    with launch_counter.recording() as rec:
        a.add("x")
        a.add("y")
        a.add("y")
    assert a.counts() == {"x": 1, "y": 0}
    for _ in range(3):
        launch_counter.replay(rec)
    assert a.counts() == {"x": 4, "y": 6}
    a.reset()
    assert a.counts() == {"x": 0, "y": 0}
