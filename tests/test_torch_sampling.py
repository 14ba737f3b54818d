"""The decoding-policy pieces of the PyTorch port against the JAX package
on the CPU: the threefry PRNG bit for bit, the logit pipeline (masks
exact, values within 1e-6, tokens equal), the grammar masks, sampled
``generate`` / ``sample_from_logits`` token for token, and the ported
distribution checks of ``accept_or_resample``
(``tests/unit/test_sampling_oracle.py:69-140``).

``jax_threefry_partitionable`` is pinned: the port reproduces the
partitionable layout, so a JAX release that changed it must fail here.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import (Llama, llama_params_from_jax,
                                              llama_tiny)
from deepspeed_tpu_torch.serving.sampling import (GrammarConstraintError,
                                                  SamplingParams,
                                                  compile_grammar, pipeline,
                                                  prng, request_key)

# relative tolerance of processed logit values (masks compare exactly)
VALUE_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small CPU ops: beside
    the other test workers, torch's thread pool spends far more time
    waiting for cores than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Jitted:
    """The JAX functions under test, each jitted once: a ``vmap`` or an
    eager chain would trace again on every call."""

    def __init__(self, jax, jp):
        self.bits = jax.jit(jax.random.bits, static_argnums=1)
        self.uniform = jax.jit(
            lambda k, shape, lo: jax.random.uniform(k, shape, minval=lo),
            static_argnums=1)
        self.categorical = jax.jit(jax.random.categorical)
        self.vcategorical = jax.jit(jax.vmap(jax.random.categorical))
        self.process = jax.jit(jp.process_logits)
        self.sample = jax.jit(jp.sample_processed)
        self.bonus = jax.jit(jp.bonus_sample)
        self.accept = jax.jit(jp.accept_or_resample)


@pytest.fixture(scope="module")
def jax_mods():
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.serving.sampling import grammar as jg
    from deepspeed_tpu.serving.sampling import pipeline as jp
    return jax, jnp, _Jitted(jax, jp), jg


def _pinned(jax):
    assert jax.config.jax_threefry_partitionable, \
        "the port implements the partitionable threefry layout"


# ------------------------------------------------------------------ prng

SEEDS = [0, 1, 12345, 2 ** 31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_bitwise(jax_mods, seed):
    jax = jax_mods[0]
    _pinned(jax)
    jk = jax.random.PRNGKey(seed)
    tk = prng.as_key(np.asarray(jk))
    assert np.array_equal(np.asarray(jk), request_key(seed))
    for n in (0, 1, 5, 977, 2 ** 31 + 3, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(tk, n).numpy(),
            np.asarray(jax.random.fold_in(jk, n)).astype(np.int64))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(
            prng.split(tk, num).numpy(),
            np.asarray(jax.random.split(jk, num)).astype(np.int64))
    # per-row keys and indices (the pipeline's vmapped fold)
    keys = np.stack([request_key(seed + i) for i in range(5)])
    idx = np.array([0, 3, 9, 2 ** 20, 7], np.uint32)
    want = jax.vmap(jax.random.fold_in)(keys, idx)
    got = prng.fold_in(prng.as_key(keys), torch.from_numpy(idx.astype(
        np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (4, 32000)])
def test_bits_and_uniform_bitwise(jax_mods, shape):
    jax, _, j = jax_mods[:3]
    _pinned(jax)
    tiny = np.finfo(np.float32).tiny
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        tk = prng.as_key(np.asarray(jk))
        np.testing.assert_array_equal(
            prng.bits(tk, shape).numpy(),
            np.asarray(j.bits(jk, shape)).astype(np.int64))
        np.testing.assert_array_equal(
            prng.uniform(tk, shape).numpy(),
            np.asarray(j.uniform(jk, shape, 0.0)))
        np.testing.assert_array_equal(
            prng.uniform(tk, shape, tiny, 1.0).numpy(),
            np.asarray(j.uniform(jk, shape, tiny)))


def test_gumbel_agrees_to_the_log_rounding(jax_mods):
    """``torch.log`` and XLA's log round differently in the last place,
    so the Gumbel noise is not bitwise: the uniform under it is (above),
    and so are the draws (below).  The largest relative gap is printed;
    one ulp of the inner log near u = 1 moves the outer one most."""
    jax = jax_mods[0]
    worst = 0.0
    for seed in range(4):
        jk = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.gumbel(jk, (4, 32000)))
        got = prng.gumbel(prng.as_key(np.asarray(jk)), (4, 32000)).numpy()
        worst = max(worst, float((np.abs(got - want) /
                                  np.maximum(1.0, np.abs(want))).max()))
    print(f"gumbel: largest relative gap to jax {worst:.3g}")
    assert worst < 1e-3


@pytest.mark.parametrize("vocab", [6, 256, 32000])
def test_categorical_token_exact(jax_mods, vocab):
    jax, jnp, j = jax_mods[:3]
    _pinned(jax)
    rng = np.random.default_rng(vocab)
    for t in range(25):
        logits = (rng.normal(size=(4, vocab)) * 3).astype(np.float32)
        logits[1, rng.integers(0, vocab, vocab // 3)] = -np.inf
        jk = jax.random.PRNGKey(t)
        # one key for the batch (generate's draw) ...
        np.testing.assert_array_equal(
            prng.categorical(prng.as_key(np.asarray(jk)),
                             torch.from_numpy(logits)).numpy(),
            np.asarray(j.categorical(jk, jnp.asarray(logits))))
        # ... and a key per row (the pipeline's)
        keys = np.stack([request_key(100 * t + i) for i in range(4)])
        np.testing.assert_array_equal(
            prng.categorical(prng.as_key(keys),
                             torch.from_numpy(logits)).numpy(),
            np.asarray(j.vcategorical(jnp.asarray(keys),
                                      jnp.asarray(logits))))


# -------------------------------------------------------------- pipeline

S = 6


def _lanes(kind, vocab, rng):
    """Per-slot lanes with one processor switched on (``kind``), or all
    of them at once ("all"); slot 0 stays greedy everywhere."""
    lanes = dict(
        counts=np.zeros((S, vocab), np.int32),
        mask=np.ones((S, vocab), bool),
        temps=np.array([0.0] + [1.0] * (S - 1), np.float32),
        top_ks=np.zeros(S, np.int32), top_ps=np.ones(S, np.float32),
        rep_pens=np.ones(S, np.float32), pres_pens=np.zeros(S, np.float32),
        freq_pens=np.zeros(S, np.float32))
    counts = (rng.integers(0, 4, (S, vocab)) *
              (rng.random((S, vocab)) < 0.05)).astype(np.int32)
    on = {"mask": dict(mask=rng.random((S, vocab)) < 0.7),
          "repetition": dict(counts=counts, rep_pens=np.array(
              [1.0, 1.3, 0.7, 1.1, 2.0, 1.0], np.float32)),
          "presence": dict(counts=counts, pres_pens=np.array(
              [0.0, 0.5, 1.5, 0.1, 0.0, 0.3], np.float32)),
          "frequency": dict(counts=counts, freq_pens=np.array(
              [0.0, 0.2, 0.7, 0.3, 0.1, 0.0], np.float32)),
          "temperature": dict(temps=np.array(
              [0.0, 0.5, 0.8, 1.0, 1.3, 2.0], np.float32)),
          "top_k": dict(top_ks=np.array([0, 1, 5, 50, vocab, 3 * vocab],
                                        np.int32)),
          "top_p": dict(top_ps=np.array([1.0, 0.1, 0.5, 0.9, 0.95, 0.999],
                                        np.float32))}
    if kind == "all":
        for part in on.values():
            lanes.update(part)
        lanes["mask"][0] = True
    else:
        lanes.update(on[kind])
    return lanes


KINDS = ["mask", "repetition", "presence", "frequency", "temperature",
         "top_k", "top_p", "all"]


def _near_top_p(x_pre, top_ps):
    """Lanes whose top-p decision rests on a cumulative mass within 1e-6
    of top_p: lane l is kept iff the mass of the lanes above it is below
    top_p (float64 here), so an ulp of either package's softmax or
    cumsum can flip it."""
    near = np.zeros(x_pre.shape, bool)
    for r in np.flatnonzero(top_ps < 1.0):
        x = x_pre[r].astype(np.float64)
        fin = np.isfinite(x)
        p = np.where(fin, np.exp(x - x[fin].max()), 0.0)
        p /= p.sum()
        order = np.argsort(-x, kind="stable")
        above = np.cumsum(p[order]) - p[order]
        near[r, order] = np.abs(above - top_ps[r]) < 1e-6
    return near


@pytest.mark.parametrize("vocab", [256, 32000])
@pytest.mark.parametrize("kind", KINDS)
def test_process_logits_matches_jax(jax_mods, kind, vocab):
    """Masks (the -inf lanes) equal exactly and values within 1e-6.  The
    lanes whose top-p decision rests on a mass within 1e-6 of top_p are
    counted and printed, with how many of them the two packages decide
    differently; no other lane may differ."""
    _, jnp, j = jax_mods[:3]
    rng = np.random.default_rng(KINDS.index(kind) * 1000 + vocab)
    near = flipped = 0
    for _ in range(6):
        logits = (rng.normal(size=(S, vocab)) * 3).astype(np.float32)
        lanes = _lanes(kind, vocab, rng)
        want = np.asarray(j.process(
            jnp.asarray(logits), **{k: jnp.asarray(v)
                                    for k, v in lanes.items()}))
        t_lanes = {k: torch.from_numpy(v) for k, v in lanes.items()}
        got = pipeline.process_logits(torch.from_numpy(logits),
                                      **t_lanes).numpy()
        pre = pipeline.process_logits(
            torch.from_numpy(logits),
            **dict(t_lanes, top_ps=torch.ones(S))).numpy()
        boundary = _near_top_p(pre, lanes["top_ps"])
        differ = np.isfinite(got) != np.isfinite(want)
        assert not (differ & ~boundary).any(), \
            f"{int((differ & ~boundary).sum())} lanes masked differently"
        near += int(boundary.sum())
        flipped += int(differ.sum())
        both = np.isfinite(got) & np.isfinite(want)
        np.testing.assert_array_equal(got[~np.isfinite(want) & ~differ],
                                      want[~np.isfinite(want) & ~differ])
        scale = np.maximum(1.0, np.abs(want[both]))
        assert (np.abs(got[both] - want[both]) <= VALUE_RTOL * scale).all()
        # the greedy slot passes bit-exact when its lanes are no-ops
        if kind not in ("mask", "repetition", "presence", "frequency",
                        "all"):
            np.testing.assert_array_equal(got[0], logits[0])
    print(f"{kind} vocab {vocab}: {near} lanes within 1e-6 of top_p, "
          f"{flipped} masked differently")


@pytest.mark.parametrize("vocab", [256, 32000])
def test_samplers_token_exact(jax_mods, vocab):
    """``sample_processed``, ``accept_or_resample`` and ``bonus_sample``
    draw the JAX package's tokens from the same processed logits."""
    _, jnp, j = jax_mods[:3]
    rng = np.random.default_rng(vocab + 1)
    for trial in range(10):
        logits = (rng.normal(size=(S, vocab)) * 3).astype(np.float32)
        lanes = _lanes("all", vocab, rng)
        x = np.array(j.process(
            jnp.asarray(logits), **{k: jnp.asarray(v)
                                    for k, v in lanes.items()}))
        keys = np.stack([request_key(trial * S + i) for i in range(S)])
        idx = rng.integers(0, 500, S).astype(np.int32)
        temps = lanes["temps"]
        xt, kt = torch.from_numpy(x), prng.as_key(keys)
        it, tt = torch.from_numpy(idx), torch.from_numpy(temps)
        np.testing.assert_array_equal(
            pipeline.sample_processed(xt, kt, it, tt).numpy(),
            np.asarray(j.sample(jnp.asarray(x), keys, idx, temps)))
        np.testing.assert_array_equal(
            pipeline.bonus_sample(xt, kt, it, tt).numpy(),
            np.asarray(j.bonus(jnp.asarray(x), keys, idx, temps)))
        # drafts: the argmax, an allowed lane and a masked-out lane
        draft = np.array([int(np.argmax(x[s])) if s % 3 == 0 else
                          int(rng.integers(0, vocab)) for s in range(S)],
                         np.int32)
        acc_j, fb_j = j.accept(jnp.asarray(x), draft, keys, idx, temps)
        acc_t, fb_t = pipeline.accept_or_resample(
            xt, torch.from_numpy(draft), kt, it, tt)
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
        np.testing.assert_array_equal(fb_t.numpy(), np.asarray(fb_j))


# ----------------------------------------- distribution checks (ported)

N_TRIALS = 4096
TOL = 0.04          # > 5 binomial sigma at N = 4096


def _target(vocab, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=2.0, size=vocab).astype(np.float32)
    p = np.exp(logits - logits.max())
    return logits, p / p.sum()


def _batch(logits, n):
    x = torch.from_numpy(np.tile(logits[None], (n, 1)))
    keys = prng.as_key(np.stack([request_key(s) for s in range(n)]))
    return x, keys, torch.ones(n)


def _freqs(tokens, vocab):
    return np.bincount(np.asarray(tokens), minlength=vocab) / len(tokens)


def test_direct_sampling_matches_target_distribution():
    vocab = 6
    logits, p = _target(vocab, 0)
    x, keys, temps = _batch(logits, N_TRIALS)
    toks = pipeline.sample_processed(x, keys, 0, temps)
    assert np.abs(_freqs(toks, vocab) - p).max() < TOL


def test_rejection_sampling_distribution_exact_any_draft():
    vocab = 6
    logits, p = _target(vocab, 1)
    x, keys, temps = _batch(logits, N_TRIALS)
    for d in (int(np.argmax(p)), int(np.argmin(p)), 0, vocab - 1):
        draft = torch.full((N_TRIALS,), d, dtype=torch.int32)
        accept, fallback = pipeline.accept_or_resample(x, draft, keys, 0,
                                                       temps)
        accept = accept.numpy()
        toks = np.where(accept, d, fallback.numpy())
        assert np.abs(_freqs(toks, vocab) - p).max() < TOL, d
        assert abs(accept.mean() - p[d]) < TOL, d
        assert d not in toks[~accept]


def test_rejection_sampling_composes_with_processing():
    vocab, n = 8, N_TRIALS
    logits, _ = _target(vocab, 2)
    lanes = dict(counts=torch.zeros((n, vocab), dtype=torch.int32),
                 mask=torch.ones((n, vocab), dtype=torch.bool),
                 temps=torch.full((n,), 0.7), top_ks=torch.full(
                     (n,), 4, dtype=torch.int32), top_ps=torch.ones(n),
                 rep_pens=torch.ones(n), pres_pens=torch.zeros(n),
                 freq_pens=torch.zeros(n))
    x = pipeline.process_logits(torch.from_numpy(np.tile(logits, (n, 1))),
                                **lanes)
    row = x[0].numpy()
    p = np.where(np.isfinite(row),
                 np.exp(row - row[np.isfinite(row)].max()), 0.0)
    p /= p.sum()
    keys = prng.as_key(np.stack([request_key(s) for s in range(n)]))
    d = int(np.argsort(p)[-2])
    accept, fallback = pipeline.accept_or_resample(
        x, torch.full((n,), d, dtype=torch.int32), keys, 3, lanes["temps"])
    toks = np.where(accept.numpy(), d, fallback.numpy())
    assert np.abs(_freqs(toks, vocab) - p).max() < TOL
    assert set(np.unique(toks)) <= set(np.flatnonzero(p > 0))


def test_rejection_sampling_greedy_rows_token_exact():
    vocab = 6
    logits, p = _target(vocab, 3)
    x, keys, _ = _batch(logits, 64)
    temps = torch.zeros(64)
    best = int(np.argmax(p))
    for d in range(vocab):
        accept, fallback = pipeline.accept_or_resample(
            x, torch.full((64,), d, dtype=torch.int32), keys, 0, temps)
        assert bool((accept == (d == best)).all())
        assert bool((fallback == best).all())


# --------------------------------------------------------------- grammar

GRAMMARS = [{"regex": "[a-c]+x"},
            {"regex": "(ab|cd){1,3}[0-9]?"},
            {"json_schema": {"type": "object", "properties": {
                "name": {"type": "string", "maxLength": 6},
                "age": {"type": "integer"},
                "ok": {"type": "boolean"}}}},
            {"response_format": "json_object"}]


@pytest.mark.parametrize("spec", GRAMMARS, ids=lambda s: next(iter(s)))
def test_grammar_masks_equal_jax(jax_mods, spec):
    """Walk each grammar along random allowed tokens: the port's mask and
    its acceptance equal the JAX cursor's in every state visited."""
    jg = jax_mods[3]
    vocab, eos = 300, 299
    port = compile_grammar(spec, vocab, eos_token_id=eos)
    ref = jg.compile_grammar(spec, vocab, eos_token_id=eos)
    rng = np.random.default_rng(7)
    for _ in range(8):
        a, b = port.fresh(), ref.fresh()
        for _ in range(40):
            m = a.token_mask()
            np.testing.assert_array_equal(m, b.token_mask())
            assert (a.accepting, a.done) == (b.accepting, b.done)
            if a.done or not m.any():
                break
            tok = int(rng.choice(np.flatnonzero(m)))
            a.advance(tok)
            b.advance(tok)
    with pytest.raises(GrammarConstraintError):
        compile_grammar({"nope": 1}, vocab)


def test_sampling_params_validate_like_jax():
    with pytest.raises(ValueError, match="unknown sampling params"):
        SamplingParams.from_dict({"nope": 1})
    for bad in (dict(temperature=-1), dict(top_p=0.0), dict(top_k=-2),
                dict(repetition_penalty=0.0)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    sp = SamplingParams.from_dict({"temperature": 0.7},
                                  defaults=SamplingParams(do_sample=True))
    assert not sp.is_greedy and sp.label() == "T=0.7"
    assert SamplingParams(do_sample=True, temperature=0).is_greedy


# ------------------------------------------------------- sampled generate


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


def _reseed(engines, seed):
    import jax
    jeng, teng = engines
    jeng._rng = jax.random.PRNGKey(seed)
    teng._rng = prng.as_key(request_key(seed))


POLICIES = [dict(temperature=1.0), dict(temperature=0.8, top_k=50),
            dict(temperature=0.7, top_p=0.9),
            dict(temperature=1.3, top_k=20, top_p=0.95)]


@pytest.mark.parametrize("policy", POLICIES,
                         ids=lambda p: ",".join(f"{k}={v}"
                                                for k, v in p.items()))
def test_sampled_generate_token_exact_vs_jax(engines, policy):
    """Several calls in a row from one seed: each call splits the
    engine's key as the JAX engine does, so every call matches."""
    jeng, teng = engines
    _reseed(engines, 11)
    rng = np.random.default_rng(5)
    for n, m, b in ((5, 12, 1), (11, 1, 1), (7, 20, 2), (20, 33, 1)):
        ids = rng.integers(0, 256, (b, n)).astype(np.int32)
        want = jeng.generate(ids, max_new_tokens=m, do_sample=True, **policy)
        got = teng.generate(ids, max_new_tokens=m, do_sample=True, **policy)
        np.testing.assert_array_equal(got, want)
    # an EOS fills the rest of the row, as in the JAX scan
    ids = rng.integers(0, 256, (2, 6)).astype(np.int32)
    first = teng.generate(ids, max_new_tokens=3, do_sample=True, **policy)
    _reseed(engines, 11)
    eos = int(first[0, 7])
    want = jeng.generate(ids, max_new_tokens=10, do_sample=True,
                         eos_token_id=eos, **policy)
    got = teng.generate(ids, max_new_tokens=10, do_sample=True,
                        eos_token_id=eos, **policy)
    np.testing.assert_array_equal(got, want)


def test_sample_from_logits_token_exact_vs_jax(engines):
    jeng, teng = engines
    _reseed(engines, 4)
    rng = np.random.default_rng(9)
    for policy in [dict()] + POLICIES:
        rows = (rng.normal(size=(3, 256)) * 2).astype(np.float32)
        want = jeng.sample_from_logits(rows, do_sample=bool(policy),
                                       **policy)
        got = teng.sample_from_logits(torch.from_numpy(rows),
                                      do_sample=bool(policy), **policy)
        assert got == want
        assert teng.sample_from_logits(torch.from_numpy(rows[0])) == \
            int(np.argmax(rows[0]))
        jeng.sample_from_logits(rows[0])            # keep the keys in step


def test_sample_from_logits_policy_token_exact_vs_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(10)
    vocab = 256
    lanes = _lanes("all", vocab, rng)
    rows = (rng.normal(size=(S, vocab)) * 2).astype(np.float32)
    keys = np.stack([request_key(40 + i) for i in range(S)])
    idx = rng.integers(0, 50, S).astype(np.int32)
    args = [keys, idx, lanes["temps"], lanes["top_ks"], lanes["top_ps"],
            lanes["rep_pens"], lanes["pres_pens"], lanes["freq_pens"],
            lanes["counts"], lanes["mask"]]
    want = jeng.sample_from_logits_policy(list(rows), *args)
    got = teng.sample_from_logits_policy(
        [torch.from_numpy(r) for r in rows], *args)
    assert got == want
