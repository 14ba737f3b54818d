"""CUDA-graph decode horizons of the PyTorch port on the card.

A CUDA engine captures ``decode_multi`` once per horizon bucket and
replays it; ``enable_cuda_graph=False`` runs the same loop eagerly.  The
replay must give the eager run's bits — tokens, validity, carries and
the pools it wrote — over fp32 and bf16, float, int8 and fp8 pools and
int8 weights, fresh and chained; captures stay within the horizon
buckets under slot churn; every replay counts its kernels' launches;
host arrays the caller mutates right after a dispatch never reach the
horizon in flight; a graph dies with its pools; and weights another
engine replaces over the same module are never replayed from their old
addresses.  Every test needs the card (marker ``cuda``); this
file imports no JAX.
"""

import gc
import itertools
import weakref

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import Llama, llama_tiny
from deepspeed_tpu_torch.ops.attention import decode as tdec
from deepspeed_tpu_torch.ops.quant import kernels as tqk
from deepspeed_tpu_torch.serving import ServingScheduler

# head_dim 32: a whole number of 16-byte loads of every pool dtype
CFG = dict(hidden_size=128, num_heads=4, num_kv_heads=2,
           intermediate_size=256, num_layers=2)
SLOTS, PAGES, PS, MAXP = 4, 24, 8, 6

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels "
                    "have no CPU or interpret mode")
    return torch.device("cuda")


def _twins(cuda, dtype, kv, quant=False, seed=0):
    """(graph engine, eager engine) over ONE module with seeded weights."""
    model = Llama(llama_tiny(**CFG), device=cuda)
    kw = dict(dtype=dtype, kv_cache_dtype=kv, max_out_tokens=128)
    if quant:
        kw["quant"] = {"enabled": True, "group_size": 32}
    graph = deepspeed_tpu_torch.init_inference(model, **kw).init_params(seed)
    eager = deepspeed_tpu_torch.init_inference(model, enable_cuda_graph=False,
                                               **kw)
    assert graph.cuda_graphs and not eager.cuda_graphs
    return graph, eager


def _filled_pools(engine, seed):
    """Pools with every page written through ``paged_write`` (the serving
    path's own quantize-on-write for int8 / fp8)."""
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


def _inputs(seed):
    rng = np.random.default_rng(seed)
    table = rng.permutation(PAGES)[:SLOTS * MAXP].reshape(SLOTS, MAXP)
    return dict(toks=rng.integers(0, 256, SLOTS).astype(np.int32),
                active=np.array([True, True, False, True]),
                page_table=table.astype(np.int32),
                lengths=np.array([3, 17, 0, 30], np.int32),
                budgets=np.array([8, 3, 0, 8], np.int32),
                eos_ids=np.full(SLOTS, -1, np.int32))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[:6], b[:6]))


def _pools_equal(a, b):
    """Every page but the sink (the last), which takes dropped rows: a
    graph's warm-up writes its all-inactive rows there."""
    return all(torch.equal(x[:-1], y[:-1])
               for la, lb in zip(a["layers"], b["layers"])
               for x, y in zip(la.values(), lb.values()))


CONFIGS = [("float32", "float32", False), ("bfloat16", "bfloat16", False),
           ("bfloat16", "int8", False), ("bfloat16", "fp8", False),
           ("int8", "int8", False), ("float32", "float32", True)]


@pytest.mark.parametrize("dtype,kv,quant", CONFIGS)
def test_replayed_horizon_equals_eager_bit_for_bit(cuda, dtype, kv, quant):
    graph, eager = _twins(cuda, dtype, kv, quant)
    pools_g = _filled_pools(graph, seed=1)
    pools_e = _clone(pools_g)
    x = _inputs(2)
    for h in (4, 8, 4):          # a replay of a bucket already captured
        out_g = graph.decode_multi(**x, pools=pools_g, horizon=h)
        out_e = eager.decode_multi(**x, pools=pools_e, horizon=h)
        assert _equal(out_g, out_e), (dtype, kv, quant, h)
        assert _pools_equal(pools_g, pools_e)
        x["lengths"] = out_e[4].cpu().numpy()
        x["toks"] = out_e[2].cpu().numpy()
    assert graph.serving_decode_multi_capture_count() == 2
    assert eager.serving_decode_multi_capture_count() == 0


@pytest.mark.parametrize("dtype,kv", [("float32", "float32"),
                                      ("bfloat16", "int8")])
def test_chained_replay_equals_eager_chain(cuda, dtype, kv):
    """A horizon dispatched off the previous one's device carries, with a
    slot frozen by ``keep``, replays the eager chain's bits."""
    graph, eager = _twins(cuda, dtype, kv)
    pools_g = _filled_pools(graph, seed=3)
    pools_e = _clone(pools_g)
    x = _inputs(4)
    keep = np.array([True, False, True, True])
    outs = {}
    for name, eng, pools in (("graph", graph, pools_g),
                             ("eager", eager, pools_e)):
        first = eng.decode_multi(**x, pools=pools, horizon=4)
        second = eng.decode_multi(
            first[2], first[3], x["page_table"], first[4], pools,
            horizon=4, budgets=x["budgets"], eos_ids=x["eos_ids"],
            emitted=first[5], keep=keep)
        outs[name] = (first, second)
    for a, b in zip(outs["graph"], outs["eager"]):
        assert _equal(a, b)
    assert not outs["graph"][1][1][1].any(), "the frozen slot emitted"
    assert _pools_equal(pools_g, pools_e)


def test_captures_bounded_by_buckets_under_slot_churn(cuda):
    """Mixed lengths, joins and retirements: fp32 serving on the graph
    engine equals ``generate()``, and captures stay within the bucket
    set; the eager twin serves the same tokens without capturing."""
    graph, eager = _twins(cuda, "float32", "float32", seed=5)
    rng = np.random.default_rng(6)
    work = [(rng.integers(0, 256, n).astype(np.int32), m)
            for n, m in [(5, 4), (9, 9), (5, 2), (9, 7), (5, 11), (9, 3),
                         (12, 14)]]
    got = {}
    for name, eng in (("graph", graph), ("eager", eager)):
        sched = ServingScheduler(eng, num_slots=3, num_pages=PAGES,
                                 page_size=PS, max_pages_per_slot=MAXP,
                                 prefill_chunk=8, decode_horizon_steps=8,
                                 overlap=name == "graph")
        reqs = [sched.submit(p, max_new_tokens=m) for p, m in work]
        out = sched.run()
        got[name] = [out[r.rid] for r in reqs]
        assert sched.kv.pool.pages_in_use == 0
    assert 1 <= graph.serving_decode_multi_capture_count() <= \
        len(sched.horizon_buckets)
    want = [[int(t) for t in graph.generate(p[None], max_new_tokens=m)[
        0, len(p):]] for p, m in work]
    assert got["graph"] == got["eager"] == want


def test_launch_counters_grow_on_every_replay(cuda):
    graph, _ = _twins(cuda, "int8", "int8")
    pools = _filled_pools(graph, seed=7)
    x = _inputs(8)
    graph.decode_multi(**x, pools=pools, horizon=2)    # capture + replay
    steps = []
    for _ in range(3):
        before = {**tdec.launch_counts(), **tqk.launch_counts()}
        graph.decode_multi(**x, pools=pools, horizon=2)
        after = {**tdec.launch_counts(), **tqk.launch_counts()}
        steps.append({k: after[k] - before[k] for k in after})
    assert steps[0] == steps[1] == steps[2]
    cfg = graph.module.cfg
    assert steps[0]["paged_decode_quant_fwd"] == 2 * cfg.num_layers
    # wq, wk, wv, wo, w_gate, w_up, w_down per layer, and lm_head
    assert steps[0]["int8_matmul_fwd"] == 2 * (7 * cfg.num_layers + 1)


def test_host_arrays_mutated_after_dispatch_do_not_reach_the_horizon(cuda):
    """The dispatch returns while the device is busy (a queued sleep);
    the caller then overwrites its arrays in place.  The horizon must
    still read the values of the call."""
    graph, eager = _twins(cuda, "float32", "float32")
    pools_g = _filled_pools(graph, seed=9)
    pools_e = _clone(pools_g)
    x = _inputs(10)
    want = eager.decode_multi(**{k: v.copy() for k, v in x.items()},
                              pools=pools_e, horizon=4)
    # capture over these pools: every slot inactive, the sink alone written
    graph.decode_multi(**dict(x, active=np.zeros(SLOTS, bool)),
                       pools=pools_g, horizon=4)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)          # the device is busy ~25 ms
    got = graph.decode_multi(**x, pools=pools_g, horizon=4)
    host = graph.copy_to_host_async(got[0], got[1])
    for v in x.values():
        v[...] = np.flip(v) if v.dtype != bool else ~v
    toks, valid = host.wait()
    assert np.array_equal(toks, want[0].cpu().numpy())
    assert np.array_equal(valid, want[1].cpu().numpy())
    assert _equal(got, want) and _pools_equal(pools_g, pools_e)


def test_graphs_die_with_their_pools(cuda):
    """Schedulers serving in turn from one engine: the engine keeps no
    pool alive, a pool set's graphs go when its pools do, and the next
    set captures anew."""
    graph, _ = _twins(cuda, "bfloat16", "bfloat16")
    x = _inputs(11)
    for i in range(3):
        pools = graph.init_paged_cache(PAGES, PS)
        graph.decode_multi(**x, pools=pools, horizon=1)
        graph.decode_multi(**x, pools=pools, horizon=1)   # a replay
        assert len(graph._graphs) == 1
        assert graph.serving_decode_multi_capture_count() == i + 1
        leaf = weakref.ref(next(iter(pools["layers"][0].values())))
        del pools
        gc.collect()
        assert leaf() is None, "the engine kept a dropped pool set alive"
        assert not graph._graphs


def _weights(engine):
    """Every weight tensor of the engine's module (its storage held)."""
    return [t.detach() for t in itertools.chain(engine.module.parameters(),
                                                engine.module.buffers())]


@pytest.mark.parametrize("change", ["requantize", "recast"])
def test_replay_follows_weights_another_engine_replaced(cuda, change):
    """A second engine over the same module replaces its weights after
    the first engine captured: ``requantize`` draws and quantizes new
    int8 weights, ``recast`` casts the module to bf16 and back to fp32.
    The old tensors are held, so the replaced ones lie at other
    addresses.
    The first engine must capture again rather than replay the old
    addresses, and equal an eager engine over the new weights."""
    dtype = "int8" if change == "requantize" else "float32"
    graph, eager = _twins(cuda, dtype, dtype)
    pools_g = _filled_pools(graph, seed=12)
    pools_e = _clone(pools_g)
    x = _inputs(13)
    graph.decode_multi(**x, pools=pools_g, horizon=4)
    eager.decode_multi(**x, pools=pools_e, horizon=4)
    assert _pools_equal(pools_g, pools_e)
    old = _weights(graph)
    if change == "requantize":
        eager.init_params(seed=1)
    else:
        deepspeed_tpu_torch.init_inference(
            graph.module, dtype="bfloat16", kv_cache_dtype="bfloat16",
            enable_cuda_graph=False)
        eager = deepspeed_tpu_torch.init_inference(
            graph.module, dtype="float32", kv_cache_dtype="float32",
            max_out_tokens=128, enable_cuda_graph=False)
    assert [t.data_ptr() for t in old] != \
        [t.data_ptr() for t in _weights(graph)]
    got = graph.decode_multi(**x, pools=pools_g, horizon=4)
    want = eager.decode_multi(**x, pools=pools_e, horizon=4)
    assert graph.serving_decode_multi_capture_count() == 2
    assert _equal(got, want) and _pools_equal(pools_g, pools_e)
    del old
