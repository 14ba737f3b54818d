"""Iteration-level (continuous-batching) scheduler — the core of
``deepspeed_tpu/serving/scheduler.py`` on the PyTorch engine.

Orca (OSDI '22) scheduling over the paged KV cache: requests join and
leave the running batch at token granularity.  Each barrier ``step()``:

  1. sweeps cancellations and expired deadlines,
  2. admits waiting requests into free slots (the pool must hold the
     whole prompt; a deadline the request cannot meet sheds it now),
  3. advances every prefilling slot by ONE prompt chunk (chunked
     prefill), sampling the first token of slots that finish,
  4. dispatches ONE fused decode horizon over the running slots — up to
     ``decode_horizon_steps`` tokens per slot in one ``decode_multi``
     call, with token feedback, EOS and budget freezing on the device —
     whose token block is harvested (emit, retire, record) when the
     host copy started at dispatch has landed.

Horizons are quantized to power-of-two buckets and shrink when the
largest remaining budget, the tightest deadline or pool pressure make a
full one wasteful.  Every running slot's pages for the whole horizon are
reserved before the dispatch.  When the pool runs dry the youngest
running request is preempted (recompute: its pages recycle and it
re-queues at the head with its emitted tokens folded into the prompt).

**Overlap** (``overlap=True``, the default, as in the JAX package).  One
horizon stays in flight: when membership is provably frozen (nothing
waiting, nothing prefilling, no cancel or deadline live, some budget
left, the next horizon's pages free without eviction), ``step()``
dispatches horizon k+1 straight off horizon k's device carries (token,
active, lengths, emitted), then harvests k while the device runs k+1.
Any other case takes the barrier path: drain what is in flight, apply
the host's authoritative state, dispatch fresh.  A request closed while
a chained horizon still runs its slot (a failing token callback, a
cancel or a deadline found at harvest) leaves at once, but its pages are
released only when that horizon is harvested: the device may still be
writing them.  ``overlap=False`` harvests each horizon in the step that
dispatched it.

**Speculative decoding** (``spec_decode="ngram"`` or ``"draft"`` with
``spec_drafter=``, ``serving/spec_decode.py``).  A step with a drafter
asks it for up to K tokens per running slot (K adapts per request over
the ``spec_k`` buckets) and, when proposers are at least half the batch,
dispatches ONE ``verify_multi`` round instead of a horizon: every slot
writes K/V for its token and drafts, the longest greedy-matching prefix
plus the target's bonus token is emitted, and the harvest rolls each
slot's pages back to its emitted length (``truncate_slot``).  Under
pool pressure the K bucket shrinks before any eviction.  Spec steps are
barrier steps: nothing chains while a drafter is configured.  A drafter
that raises degrades that request to plain decode (sticky); the round
and the loop go on.

**Prefix cache** (``prefix_cache=True``, ``serving/prefix_cache.py``).
Finished requests donate their full pages to a radix index keyed by
exact token ids.  Admission longest-prefix matches each prompt (capped
at ``len(prompt) - 1``, so at least one token is prefilled and gives the
boundary logits): matched full pages are shared read-only into the
slot's table (``PagePool`` refcounts), a partly matched page is copied
into a fresh private page on the device (``engine.copy_page``,
copy-on-write), and chunked prefill resumes at the cached boundary.
Cached pages are reclaimable capacity: under pool pressure the LRU
pages only the cache holds drain before any request is preempted, and
admission, horizon and spec-K reservation and chaining count them as
free.  Admission (and so every copy) happens on barrier steps only.

**Decoding policy** (``serving/sampling/``).  Every request carries a
``SamplingParams`` (temperature, top-k, top-p, repetition / presence /
frequency penalties; the scheduler's ``do_sample`` / ``temperature`` /
``top_k`` / ``top_p`` are the default), a ``seed`` (the scheduler's by
default) keying its
position-indexed threefry stream (token ``n`` draws from
``fold_in(key, n)``, so preemption, chaining and the horizon change
nothing), and optionally a grammar (regex / JSON schema) compiled on the
host to a per-state token mask.  A batch with any such request runs the
policy bodies (``decode_multi_policy`` / ``verify_multi_policy``), every
knob a per-slot lane, so any mix replays one graph per bucket; a greedy
batch under a greedy default keeps the greedy bodies and captures no
policy graph.  A grammar slot pins the horizon to 1 (its mask is a host
function of the tokens emitted so far), never chains and never drafts;
sampled slots verify by leftover-probability rejection sampling when the
drafter opts in (``supports_sampling``).

Failure policy: an error attributable to one request (its prefill, its
token callback, its drafter) fails that request only (a drafter's only
degrades its speculation); load the system cannot serve is shed (state
``shed``), distinct from errors; ``req.cancel()`` is honored at the next
horizon boundary; terminal requests move to a bounded ``completed``
history.

Not in this port yet (each raises ``NotImplementedError`` naming its
ROADMAP.md item when asked for): tenancy, tracing, memory telemetry,
the monitor, handoff (``sample_offset`` too), drain and the online
tuner.
"""

import json
import time
from collections import deque

import numpy as np

from deepspeed_tpu_torch.ops.quant.kv import kv_dtype_name
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.page_manager import (PagedKVManager,
                                                      PagePoolExhausted,
                                                      default_page_size)
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache
from deepspeed_tpu_torch.serving.sampling import (GREEDY,
                                                  GrammarConstraintError,
                                                  SamplingParams,
                                                  compile_grammar,
                                                  request_key)
from deepspeed_tpu_torch.serving.spec_decode import NgramDrafter

WAITING, PREFILL, RUNNING, FINISHED = "waiting", "prefill", "running", \
    "finished"
CANCELLED, FAILED, SHED = "cancelled", "failed", "shed"
TERMINAL = frozenset((FINISHED, CANCELLED, FAILED, SHED))

# JAX-scheduler options the port does not run yet -> ROADMAP.md item; an
# option passed with an "off" value (None, False, 0 or "off") is accepted
_UNPORTED = {
    "tenancy": "Queue A10 (tenancy)",
    "tenant": "Queue A10 (tenancy)",
    "adapter": "Queue A10 (tenancy)",
    "seq_parallel_threshold": "Queue A10 (sequence-parallel prefill)",
    "prefill_reserve_frac": "Queue A10 (sequence-parallel prefill)",
    "monitor": "Queue A10 (serving telemetry)",
    "tracer": "Queue A10 (serving telemetry)",
    "trace_ctx": "Queue A10 (serving telemetry)",
    "mem_telemetry": "Queue A10 (serving telemetry)",
    "audit_every": "Queue A10 (serving telemetry)",
    "comm_telemetry": "Queue A10 (serving telemetry)",
    "compile_watchdog": "Queue A10 (serving telemetry)",
    "online_tuner": "Queue A10 (online tuner)",
    "tuned_from": "Queue A10 (online tuner)",
    "shared_pool": "Queue A10 (disaggregated serving)",
    "pools_ref": "Queue A10 (disaggregated serving)",
    "on_handoff": "Queue A10 (disaggregated serving)",
    "handoff": "Queue A10 (disaggregated serving)",
    "sample_offset": "Queue A10 (disaggregated serving)",
}


def _pow2_buckets(top):
    """Power-of-two buckets 1, 2, 4, ... capped at ``top`` (included)."""
    buckets, b = {1}, 1
    while b < top:
        b = min(b * 2, top)
        buckets.add(b)
    return sorted(buckets)


def _floor_bucket(buckets, n):
    """Largest bucket <= n (the smallest, 1, when none is)."""
    return max([b for b in buckets if b <= n], default=1)


def _reject_unported(where, options):
    for key, value in options.items():
        if key not in _UNPORTED:
            raise TypeError(f"{where}() got an unexpected argument {key!r}")
        if value not in (None, False, 0, "off"):
            raise NotImplementedError(
                f"{where}({key}=...) is not ported to the PyTorch package "
                f"yet: see ROADMAP.md {_UNPORTED[key]}")


class QueueFull(RuntimeError):
    """Backpressure: the waiting queue is at max_queue."""


class Request:
    """One generation request flowing through the scheduler."""

    _next_id = 0

    def __init__(self, prompt, max_new_tokens, eos_token_id=None,
                 on_token=None, rid=None, deadline_s=None):
        if rid is None:
            rid = Request._next_id
            Request._next_id += 1
        self.rid = rid
        self.orig_prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        self.prompt = list(self.orig_prompt)   # grows on preemption
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.on_token = on_token
        self.out_tokens = []
        self.state = WAITING
        self.prefill_pos = 0
        self.cached_prefix_tokens = 0   # prefix-cache reuse at last admit
        # decoding policy (serving/sampling/): the params, the PRNG seed
        # (token n draws from fold_in(PRNGKey(seed), sample_offset + n);
        # sample_offset stays 0 until handoff is ported) and the grammar
        # cursor
        self.sampling = GREEDY
        self.seed = 0
        self.sample_offset = 0
        self.grammar = None          # GrammarConstraint cursor or None
        self.error = None            # reason string for failed/shed
        self.cancelled = False
        self.t_submit = time.monotonic()
        self.deadline = None if deadline_s is None \
            else self.t_submit + float(deadline_s)
        self.t_admit = None
        self.t_first = None
        self.t_last = None
        # speculative decoding, per request: the adaptive K (None: the
        # scheduler's spec_k), the acceptance EWMA and the sticky degrade
        self._spec_k = None
        self._spec_accept = None
        self._spec_off = False

    @property
    def remaining_new(self):
        return self.max_new_tokens - len(self.out_tokens)

    def cancel(self):
        """Request cancellation, honored at the next step boundary."""
        self.cancelled = True

    def past_deadline(self, now):
        return self.deadline is not None and now > self.deadline

    def _finished_by(self, tok):
        return (self.eos_token_id is not None and
                tok == self.eos_token_id) or self.remaining_new <= 0


class ServingScheduler:
    """Continuous-batching serving loop over an ``InferenceEngine``."""

    def __init__(self, engine, *, num_slots=8, num_pages=64, page_size=None,
                 max_pages_per_slot=None, prefill_chunk=16, max_queue=256,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 seed=0, completed_history=4096, decode_horizon_steps=8,
                 overlap=True, prefix_cache=False, prefix_cache_pages=None,
                 spec_decode=None, spec_k=8, spec_drafter=None,
                 kv_dtype=None, **options):
        _reject_unported("ServingScheduler", options)
        # the scheduler-wide decoding policy every request defaults to;
        # a greedy default keeps greedy batches on the greedy bodies
        self.default_sampling = SamplingParams(
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            top_p=top_p)
        self._default_greedy = self.default_sampling.is_greedy
        self.default_seed = int(seed)   # a request without seed= keys on it
        if page_size is None:
            page_size = default_page_size()
        if max_pages_per_slot is None:
            max_pages_per_slot = -(-num_pages // 2) or 1
        self.engine = engine
        self.num_slots = int(num_slots)
        self.prefill_chunk = int(prefill_chunk)
        self.max_queue = int(max_queue)
        self.kv = PagedKVManager(num_pages, page_size, num_slots,
                                 max_pages_per_slot)
        # radix prefix cache over pages donated by finished requests;
        # its pages are reclaimable capacity (LRU-drained under pressure)
        self.prefix_cache = PrefixCache(
            self.kv.pool, max_pages=prefix_cache_pages) \
            if prefix_cache else None
        # kv_dtype overrides the engine's configured kv_cache_dtype for
        # THIS scheduler's pools: a float name or "int8" / "fp8"
        self.pools = engine.init_paged_cache(num_pages, page_size,
                                             kv_dtype=kv_dtype)
        self.lengths = np.zeros(num_slots, np.int32)
        self.last_tok = np.zeros(num_slots, np.int32)
        self.slot_req = [None] * num_slots
        self.waiting = deque()
        self.requests = {}           # rid -> LIVE request only
        self.completed = deque(maxlen=int(completed_history))
        self._collect = None         # active run()'s result accumulator
        self.metrics = ServingMetrics()
        self.step_idx = 0
        # admission feasibility uses the median of a recent window: one
        # slow warm-up step must not shed serviceable requests
        self._step_window = deque(maxlen=16)
        self._tok_window = deque(maxlen=32)   # per-token wall time
        self._eos_ids = np.full(num_slots, -1, np.int32)
        # per-slot policy mirrors, staged into the policy bodies' lanes
        # (greedy slots carry the no-op encodings, sampling/params.py)
        self._samp_temps = np.zeros(num_slots, np.float32)
        self._samp_topk = np.zeros(num_slots, np.int32)
        self._samp_topp = np.ones(num_slots, np.float32)
        self._samp_rep = np.ones(num_slots, np.float32)
        self._samp_pres = np.zeros(num_slots, np.float32)
        self._samp_freq = np.zeros(num_slots, np.float32)
        self._samp_keys = np.zeros((num_slots, 2), np.uint32)
        self._tok_counts = None      # lazy [num_slots, vocab] int32
        self._grammar_masks = None   # lazy [num_slots, vocab] bool
        self._grammar_cache = {}     # (spec json, eos) -> prototype cursor
        self._wall_s = None
        self.overlap = bool(overlap)
        self._inflight = deque()     # dispatched horizons, FIFO, depth <= 2
        self._zombies = set()        # slots closed host-side while a
                                     # chained horizon still runs them
        self._chain_budgets = None   # budgets baseline of the live chain
        self.decode_horizon_steps = max(1, int(decode_horizon_steps))
        self.horizon_buckets = _pow2_buckets(self.decode_horizon_steps)
        # speculative decoding: a drafter proposes up to K tokens per
        # slot and ONE verify_multi round scores them
        self.spec_k = max(1, int(spec_k))
        self.spec_k_buckets = _pow2_buckets(self.spec_k)
        self._spec = None
        self.spec_mode = "off"
        if spec_decode not in (None, False, "off", "ngram", "draft"):
            # validated whether or not a drafter is passed: a typo must
            # not slip through beside a custom drafter
            raise ValueError(f"unknown spec_decode mode {spec_decode!r}; "
                             "pick 'ngram', 'draft' (+spec_drafter) or "
                             "'off'")
        if spec_decode in ("off", False):
            pass              # an explicit off wins over a passed drafter
        elif spec_drafter is not None:
            self._spec = spec_drafter
            self.spec_mode = spec_decode or getattr(spec_drafter, "name",
                                                    "custom")
        elif spec_decode == "ngram":
            self._spec = NgramDrafter()
            self.spec_mode = "ngram"
        elif spec_decode == "draft":
            raise ValueError(
                "spec_decode='draft' needs a spec_drafter="
                "DraftModelDrafter(...) carrying the draft engine")
        # a drafter without lossless sampled verification loses only its
        # sampled slots' proposals; under a sampled default that is every
        # slot, so speculation is off, with the reason in spec_mode
        if self._spec is not None and not self._default_greedy and \
                not getattr(self._spec, "supports_sampling", False):
            self._spec = None
            self.spec_mode = "off (drafter lacks supports_sampling)"

    # ------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens=32, eos_token_id=None,
               on_token=None, deadline_s=None, sampling=None, seed=None,
               grammar=None, **options):
        """Queue a request; raises :class:`QueueFull` at max_queue.
        ``deadline_s`` is a relative budget: a request that cannot finish
        inside it is shed instead of served late.

        Decoding policy, per request: ``sampling`` is a
        :class:`~deepspeed_tpu_torch.serving.sampling.SamplingParams` or
        a wire dict over the scheduler's default; ``seed`` keys the
        request's position-keyed stream (the scheduler's ``seed``, 0 by
        default, when omitted: deterministic and replayable);
        ``grammar`` is a constraint spec (``{"regex": ...}``
        / ``{"json_schema": ...}`` / ``{"response_format":
        "json_object"}``) compiled on the host to a per-step mask over
        the byte vocabulary.  A bad spec or param raises here."""
        _reject_unported("submit", options)
        if len(self.waiting) >= self.max_queue:
            raise QueueFull(f"waiting queue at max_queue={self.max_queue}")
        need = len(np.asarray(prompt).reshape(-1)) + int(max_new_tokens)
        cap = min(self.kv.max_tokens_per_slot(),
                  self.kv.pool.num_pages * self.kv.page_size)
        if need > cap:
            raise ValueError(
                f"request of {need} tokens exceeds per-slot capacity {cap} "
                "(min(max_pages_per_slot, num_pages) * page_size)")
        req = Request(prompt, max_new_tokens, eos_token_id, on_token,
                      deadline_s=deadline_s)
        self._apply_policy(req, sampling, seed, grammar)
        if req.max_new_tokens <= 0:
            self._finalize(req, FINISHED)
            return req
        self.requests[req.rid] = req
        self.waiting.append(req)
        return req

    # ------------------------------------------------- decoding policy
    def _apply_policy(self, req, sampling, seed, grammar):
        """Attach the per-request decoding policy at intake (the JAX
        ``_apply_policy``): a bad spec is rejected before any page is
        held."""
        req.sampling = SamplingParams.from_dict(
            sampling, defaults=self.default_sampling)
        req.seed = self.default_seed if seed is None else int(seed)
        if grammar is not None:
            req.grammar = self._compile_grammar(grammar, req.eos_token_id)
        if self._req_needs_policy(req):
            self.metrics.record_policy_request(
                sampled=not req.sampling.is_greedy,
                grammar=req.grammar is not None)

    def _compile_grammar(self, spec, eos_token_id):
        """Spec dict -> a fresh cursor.  The DFA and its per-state token
        masks are cached per (spec, eos), so requests sharing a schema
        share one :class:`TokenDFA`; each request gets its own cursor."""
        if hasattr(spec, "token_mask"):     # a pre-built cursor
            return spec
        key = (json.dumps(spec, sort_keys=True),
               None if eos_token_id is None else int(eos_token_id))
        proto = self._grammar_cache.get(key)
        if proto is None:
            proto = compile_grammar(spec, self._vocab_size(),
                                    eos_token_id=eos_token_id)
            self._grammar_cache[key] = proto
        return proto.fresh()

    def _vocab_size(self):
        return int(self.engine.module.cfg.vocab_size)

    @staticmethod
    def _req_needs_policy(req):
        return req.sampling.needs_policy or req.grammar is not None

    def _batch_needs_policy(self, slots):
        """A dispatch takes the policy bodies when any of its requests
        samples, penalizes or is constrained, or the default is sampled
        (its explicitly greedy rows are argmax-exact there too)."""
        return (not self._default_greedy) or any(
            self._req_needs_policy(self.slot_req[s]) for s in slots)

    def _ensure_policy_tables(self):
        if self._tok_counts is None:
            v = self._vocab_size()
            self._tok_counts = np.zeros((self.num_slots, v), np.int32)
            self._grammar_masks = np.ones((self.num_slots, v), bool)

    def _seed_slot_policy(self, slot, req):
        """Stage one admitted request's policy into the slot mirrors;
        its counts come from its true history ``orig_prompt +
        out_tokens`` (after a preemption the prompt already holds the
        emitted tokens)."""
        if not (self._req_needs_policy(req) or
                self._tok_counts is not None):
            return
        self._ensure_policy_tables()
        sp = req.sampling
        self._samp_temps[slot] = sp.staged_temperature
        self._samp_topk[slot] = 0 if sp.is_greedy else sp.top_k
        self._samp_topp[slot] = 1.0 if sp.is_greedy else sp.top_p
        self._samp_rep[slot] = sp.repetition_penalty
        self._samp_pres[slot] = sp.presence_penalty
        self._samp_freq[slot] = sp.frequency_penalty
        self._samp_keys[slot] = request_key(req.seed)
        v = self._tok_counts.shape[1]
        hist = np.asarray(req.orig_prompt + req.out_tokens, np.int64)
        hist = hist[(hist >= 0) & (hist < v)]
        self._tok_counts[slot] = np.bincount(hist, minlength=v)[:v]
        self._grammar_masks[slot] = True if req.grammar is None \
            else req.grammar.token_mask()

    def _policy_args(self, running):
        """The staged per-slot lanes one policy dispatch takes;
        ``tok_base`` is each request's position base, so the body's fold
        index ``tok_base + emitted`` is the token's absolute position in
        the request's stream."""
        self._ensure_policy_tables()
        base = np.zeros(self.num_slots, np.int32)
        for s in running:
            req = self.slot_req[s]
            base[s] = req.sample_offset + len(req.out_tokens)
        return dict(keys=self._samp_keys, tok_base=base,
                    temps=self._samp_temps, top_ks=self._samp_topk,
                    top_ps=self._samp_topp, rep_pens=self._samp_rep,
                    pres_pens=self._samp_pres, freq_pens=self._samp_freq,
                    counts=self._tok_counts, mask=self._grammar_masks)

    def _note_emitted(self, slot, req, tok):
        """Policy bookkeeping of one delivered token: the count mirror and
        the grammar cursor.  A grammar rejection raises into the caller's
        per-request containment."""
        if self._tok_counts is not None and \
                0 <= tok < self._tok_counts.shape[1]:
            self._tok_counts[slot, tok] += 1
        if req.grammar is not None and not req.grammar.finished:
            try:
                req.grammar.advance(tok)
            except GrammarConstraintError:
                self.metrics.record_grammar_violation(self.step_idx,
                                                      req.rid)
                raise

    @staticmethod
    def _grammar_finished(req):
        """A constrained request finishes when its cursor is done (eos
        consumed, or no continuation left), with or without an eos."""
        return req.grammar is not None and req.grammar.done

    # --------------------------------------------------------- accounting
    def _emit(self, req, tok):
        now = time.monotonic()
        tok = int(tok)
        req.out_tokens.append(tok)
        if req.t_first is None:
            req.t_first = now
            self.metrics.record_first_token(now - req.t_submit)
        else:
            self.metrics.record_token(now - req.t_last)
        req.t_last = now
        if req.on_token is not None:
            req.on_token(req, tok)

    def _finalize(self, req, state, reason=None):
        req.state = state
        if reason is not None:
            req.error = reason
        self.requests.pop(req.rid, None)
        self.completed.append(req)
        self.metrics.record_terminal(state)

    def _spec_release(self, slot, req):
        """Drop any drafter state of a vacated slot (every terminal and
        preemption path funnels through here, so a stateful drafter —
        the draft model's private KV pages — cannot leak)."""
        if self._spec is not None and req is not None:
            try:
                self._spec.on_release(slot, req)
            except Exception:   # a broken drafter must not break retire
                pass

    def _vacate(self, slot, donate=False):
        req = self.slot_req[slot]
        self._spec_release(slot, req)
        if donate and self.prefix_cache is not None:
            self._donate_pages(slot, req)
        else:
            self.kv.release_slot(slot)
        self.slot_req[slot] = None
        self.lengths[slot] = 0

    def _donate_pages(self, slot, req):
        """Retirement hands the slot's FULL pages to the prefix cache (the
        JAX ``_donate_pages``).  The true sequence is ``orig_prompt +
        out_tokens`` (after a preemption ``prompt`` already holds emitted
        tokens).  The last token was never fed back, so its K/V was never
        written: only pages inside the first ``len - 1`` tokens are
        donated — after a spec round that is the accepted tokens only,
        never a rejected draft's rows.  Pages the cache declines
        (duplicate chains, its cap) and the partial tail are freed."""
        seq = req.orig_prompt + req.out_tokens
        n_full = max(0, len(seq) - 1) // self.kv.page_size
        pages = self.kv.take_slot_pages(slot)
        keep, tail = pages[:n_full], pages[n_full:]
        leftover = self.prefix_cache.insert(seq, keep) if keep else []
        self.kv.pool.free(leftover + tail)

    def _retire(self, slot):
        req = self.slot_req[slot]
        self._vacate(slot, donate=True)
        self._finalize(req, FINISHED)
        if self._collect is not None:
            self._collect[req.rid] = list(req.out_tokens)

    def _close_slot(self, slot, state, reason):
        """Terminal removal of a live slot for cancel/shed/fail."""
        req = self.slot_req[slot]
        self._vacate(slot)
        self._finalize(req, state, reason)

    def _preempt_youngest(self, protect=None):
        """Evict the most recently admitted live request (recompute
        preemption), re-queueing it at the queue head.  Returns the freed
        slot or None if there was nothing to evict."""
        candidates = [s for s in range(self.num_slots)
                      if self.slot_req[s] is not None and s != protect]
        if not candidates:
            candidates = [protect] if protect is not None and \
                self.slot_req[protect] is not None else []
        if not candidates:
            return None
        victim = max(candidates, key=lambda s: self.slot_req[s].t_admit)
        req = self.slot_req[victim]
        self._vacate(victim)
        req.state = WAITING
        req.prompt = req.orig_prompt + req.out_tokens
        req.prefill_pos = 0
        self.waiting.appendleft(req)
        self.metrics.record_preemption()
        return victim

    def _reclaim_cached(self, n_pages, protect=frozenset()):
        """Drain up to ``n_pages`` pages only the prefix cache holds (LRU)
        back to the free list.  Returns the pages freed (0 with the cache
        off, empty, or pinned by live sharers)."""
        if self.prefix_cache is None or n_pages <= 0:
            return 0
        freed = self.prefix_cache.evict(n_pages, protect)
        if freed:
            self.metrics.record_cache_eviction(freed)
        return freed

    def _reclaimable(self, protect=frozenset()):
        """Pages a drain of the prefix cache could free right now."""
        return 0 if self.prefix_cache is None else \
            self.prefix_cache.reclaimable_pages(protect)

    def _grow_or_evict(self, slot, target_len):
        """``ensure_capacity`` with the reclaim policy behind it: pages
        only the prefix cache holds drain first (reclaimable capacity,
        not live state), then the youngest request is preempted.
        Returns False when ``slot`` itself was preempted; raises
        :class:`PagePoolExhausted` when nothing is left to drain or
        evict."""
        while not self.kv.ensure_capacity(slot, target_len):
            # the whole known shortfall in one batched drain
            short = self.kv.pages_needed(slot, target_len) - \
                self.kv.pool.free_pages
            if self._reclaim_cached(max(1, short)):
                continue
            victim = self._preempt_youngest(protect=slot)
            if victim is None:
                raise PagePoolExhausted(
                    f"cannot grow slot {slot} to {target_len} tokens: "
                    "pool exhausted with no evictable request")
            if victim == slot:
                return False
        return True

    # ----------------------------------------------------- failure policy
    def _estimated_service_steps(self, req):
        """Iterations this request still needs if admitted now: remaining
        prefill chunks + one horizon per ``decode_horizon_steps`` tokens
        (optimistic, so shedding only fires on hopeless requests).  The
        tokens a prefix-cache hit would skip are not priced."""
        pending = max(0, len(req.prompt) - req.prefill_pos)
        if self.prefix_cache is not None and req.prefill_pos == 0 \
                and pending > 1:
            full, _, plen = self.prefix_cache.match(
                req.prompt, limit=len(req.prompt) - 1)
            pending = max(1, pending - len(full) * self.kv.page_size
                          - plen)
        prefill = -(-pending // self.prefill_chunk)
        horizons = -(-max(1, req.remaining_new) // self.decode_horizon_steps)
        return prefill + horizons

    def _step_s_estimate(self):
        if len(self._step_window) < 2:
            return None
        return float(np.median(self._step_window))

    def _infeasible(self, req, now):
        est = self._step_s_estimate()
        if req.deadline is None or est is None:
            return False
        return now + self._estimated_service_steps(req) * est > req.deadline

    def _sweep(self, now):
        """Step-boundary honoring of cancellations and deadlines."""
        for slot in range(self.num_slots):
            req = self.slot_req[slot]
            if req is None:
                continue
            if req.cancelled:
                self._close_slot(slot, CANCELLED, "cancelled")
            elif req.past_deadline(now):
                self._close_slot(slot, SHED, "deadline expired mid-flight")
        if any(r.cancelled or r.past_deadline(now) for r in self.waiting):
            keep = deque()
            for req in self.waiting:
                if req.cancelled:
                    self._finalize(req, CANCELLED, "cancelled")
                elif req.past_deadline(now):
                    self._finalize(req, SHED, "deadline expired in queue")
                else:
                    keep.append(req)
            self.waiting = keep

    # -------------------------------------------------------------- step
    def step(self):
        """One scheduler iteration; returns True if any work remains.

        With a horizon in flight and ``overlap`` on, the next horizon is
        chained first when membership is frozen (:meth:`_try_chain`),
        then the oldest one is harvested.  Otherwise this is a barrier
        step: everything in flight is harvested, then the boundary work
        (sweep, admit, prefill) runs on authoritative host state and one
        fresh horizon is dispatched."""
        self.step_idx += 1
        t_step = time.monotonic()
        t_wait, pulled = 0.0, 0
        chained = False
        if self._inflight:
            if self.overlap:
                chained = self._try_chain()
            w, n = self._harvest()
            t_wait += w
            pulled += n
        if not chained:
            # barrier: membership may change below, so nothing may stay
            # in flight (its page-table snapshot would go stale and an
            # eviction could hand its pages to another slot)
            while self._inflight:
                w, n = self._harvest()
                t_wait += w
                pulled += n
            now = time.monotonic()
            self._sweep(now)
            self._admit(now)
            self._prefill()
            self._dispatch()
            if not self.overlap and self._inflight:
                w, n = self._harvest()
                t_wait += w
                pulled += n
        dt = time.monotonic() - t_step
        self._step_window.append(dt)
        if pulled:
            self._tok_window.append(dt / pulled)
        n_running = sum(r is not None for r in self.slot_req)
        self.metrics.record_step(
            queue_depth=len(self.waiting),
            page_utilization=self.kv.utilization(),
            device_wait_s=t_wait, host_s=max(0.0, dt - t_wait))
        return bool(self.waiting) or n_running > 0 or bool(self._inflight)

    def _admit(self, now):
        for slot in range(self.num_slots):
            if self.slot_req[slot] is not None or slot in self._zombies:
                continue
            req = None
            while self.waiting:
                req = self.waiting[0]
                if not self._infeasible(req, now):
                    break
                self.waiting.popleft()
                self._finalize(
                    req, SHED,
                    f"deadline infeasible at admission (needs "
                    f"~{self._estimated_service_steps(req)} steps at "
                    f"{self._step_s_estimate() * 1e3:.1f} ms/step)")
                req = None
            if req is None:
                break
            hit, protect = None, frozenset()
            need = self.kv.pool.pages_for_tokens(len(req.prompt))
            if self.prefix_cache is not None:
                # longest-prefix match, capped at len(prompt) - 1 so at
                # least one prompt token is prefilled (the boundary
                # logits the first token comes from)
                hit = self.prefix_cache.match(req.prompt,
                                              limit=len(req.prompt) - 1)
                need -= len(hit[0])
                protect = frozenset(id(n) for n in hit[0] + (
                    [hit[1]] if hit[1] is not None else []))
            # admission control: the UNIQUE part of the prompt must fit
            # now; matched full pages are shared, and pages only the
            # cache holds count as capacity (drained with the match
            # protected), after checking the drain can cover it
            short = need - self.kv.pool.free_pages
            if short > 0 and (short > self._reclaimable(protect) or
                              self._reclaim_cached(short, protect) < short):
                break
            self.waiting.popleft()
            self.slot_req[slot] = req
            req.state = PREFILL
            req.t_admit = now
            self._eos_ids[slot] = -1 if req.eos_token_id is None \
                else int(req.eos_token_id)
            self._seed_slot_policy(slot, req)
            self.lengths[slot] = 0
            req.cached_prefix_tokens = 0
            if hit is not None:
                try:
                    self._attach_prefix(slot, req, hit)
                except Exception as e:   # the attach and its device copy
                    # are this request's work: fail it, not admission
                    self._close_slot(slot, FAILED,
                                     f"{type(e).__name__}: {e}")

    def _attach_prefix(self, slot, req, hit):
        """Map a matched cached chain into the admitted slot (the JAX
        ``_attach_prefix``): full pages are shared read-only, a partly
        matched page is copied on the device into a fresh PRIVATE page
        (copy-on-write: the slot will append into it, and the cached
        original must stay unchanged for its other readers).  Prefill
        resumes at the cached boundary, ``lengths[slot]`` giving the
        positions."""
        full_nodes, pnode, plen = hit
        cached = 0
        if full_nodes:
            self.kv.attach_prefix(slot,
                                  self.prefix_cache.acquire(full_nodes))
            cached = len(full_nodes) * self.kv.page_size
        if pnode is not None and self.kv.pool.can_allocate(1):
            page = self.kv.pool.allocate(1)[0]
            # adopted BEFORE the device copy: if the copy raises, closing
            # the slot releases the page instead of leaking it
            self.kv.adopt_page(slot, page)
            self.pools = self.engine.copy_page(self.pools, pnode.page, page)
            self.prefix_cache.touch(pnode)
            self.prefix_cache.cow_copies += 1
            cached += plen
        if cached:
            self.prefix_cache.tokens_reused += cached
            self.lengths[slot] = cached
            req.prefill_pos = cached
            req.cached_prefix_tokens = cached
        # one lookup per admission, counted once the outcome is known
        self.prefix_cache.lookups += 1
        self.prefix_cache.hits += bool(cached)
        self.metrics.record_prefix(cached, len(req.prompt))

    def _prefill(self):
        """One prompt chunk per prefilling slot (contained per request);
        slots finishing their prompt sample their first token in ONE
        batched device call."""
        finishing = []
        for slot in range(self.num_slots):
            req = self.slot_req[slot]
            if req is None or req.state != PREFILL:
                continue
            try:
                chunk = req.prompt[req.prefill_pos:
                                   req.prefill_pos + self.prefill_chunk]
                n_valid = len(chunk)
                if not self._grow_or_evict(slot, req.prefill_pos + n_valid):
                    continue      # self-preempted: back in the queue
                ids = np.zeros((1, self.prefill_chunk), np.int32)
                ids[0, :n_valid] = chunk
                logits, self.pools = self.engine.prefill_into_slots(
                    ids, slot, n_valid, self.kv.table, self.lengths,
                    self.pools)
                self.lengths[slot] += n_valid
                req.prefill_pos += n_valid
                if req.prefill_pos == len(req.prompt):
                    finishing.append((slot, req, logits))
            except PagePoolExhausted as e:
                self._close_slot(slot, SHED, f"page capacity: {e}")
            except Exception as e:   # containment: fail one, not all
                self._close_slot(slot, FAILED, f"{type(e).__name__}: {e}")
        # a later slot's growth may have evicted an earlier finishing slot
        finishing = [(s, r, lg) for s, r, lg in finishing
                     if self.slot_req[s] is r and r.state == PREFILL]
        if not finishing:
            return
        rows = [lg for _, _, lg in finishing]
        sl = [s for s, _, _ in finishing]
        if self._batch_needs_policy(sl):
            # the first token under the decoding policy: the pipeline
            # and position-keyed stream of the policy horizons (token n
            # of the request draws from fold_in(key, sample_offset + n))
            self._ensure_policy_tables()
            idx = np.array([r.sample_offset + len(r.out_tokens)
                            for _, r, _ in finishing], np.int32)
            toks = self.engine.sample_from_logits_policy(
                rows, self._samp_keys[sl], idx, self._samp_temps[sl],
                self._samp_topk[sl], self._samp_topp[sl],
                self._samp_rep[sl], self._samp_pres[sl],
                self._samp_freq[sl], self._tok_counts[sl],
                self._grammar_masks[sl])
        else:
            toks = self.engine.sample_from_logits(rows)
        for (slot, req, _), tok in zip(finishing, toks):
            try:
                self._emit(req, tok)
                self._note_emitted(slot, req, tok)
            except Exception as e:
                self._close_slot(slot, FAILED, f"{type(e).__name__}: {e}")
                continue
            if req._finished_by(tok) or self._grammar_finished(req):
                self._retire(slot)
            else:
                self.last_tok[slot] = tok
                req.state = RUNNING
                if req.grammar is not None:
                    self._grammar_masks[slot] = req.grammar.token_mask()

    # -------------------------------------------------- horizon decode
    def _pick_horizon(self, running, now):
        """Largest useful horizon bucket: capped by the largest remaining
        budget and by the tightest live deadline.  A grammar slot pins the
        batch to horizon 1: its mask is a host function of the tokens
        emitted so far, so one staged mask covers one step."""
        if any(self.slot_req[s].grammar is not None for s in running):
            return 1
        h = min(self.decode_horizon_steps,
                max(self.slot_req[s].remaining_new for s in running))
        deadlines = [self.slot_req[s].deadline for s in running
                     if self.slot_req[s].deadline is not None]
        if deadlines and self._tok_window:
            per_tok = float(np.median(self._tok_window))
            if per_tok > 0:
                h = max(1, min(h, int((min(deadlines) - now) / per_tok)))
        return _floor_bucket(self.horizon_buckets, h)

    def _reserve(self, running, horizon):
        """Reserve every running slot's pages for the whole horizon; under
        pool pressure the horizon shrinks bucket by bucket before any
        eviction runs (pages only the prefix cache holds count as free).
        Returns (horizon, surviving slots)."""
        reclaimable = None           # one tree walk, and only when needed
        while horizon > 1:
            need = sum(self.kv.pages_needed(
                s, int(self.lengths[s]) +
                min(horizon, self.slot_req[s].remaining_new))
                for s in running)
            avail = self.kv.pool.free_pages
            if need > avail:
                if reclaimable is None:
                    reclaimable = self._reclaimable()
                avail += reclaimable
            if need <= avail:
                break
            horizon = _floor_bucket(self.horizon_buckets, horizon - 1)
        kept = []
        for slot in running:
            req = self.slot_req[slot]
            if req is None or req.state != RUNNING:
                continue   # evicted by an earlier slot's growth
            budget = min(horizon, req.remaining_new)
            try:
                if self._grow_or_evict(slot,
                                       int(self.lengths[slot]) + budget):
                    kept.append(slot)
            except PagePoolExhausted as e:
                self._close_slot(slot, SHED, f"page capacity: {e}")
            except Exception as e:
                self._close_slot(slot, FAILED, f"{type(e).__name__}: {e}")
        return horizon, [s for s in kept if self.slot_req[s] is not None
                         and self.slot_req[s].state == RUNNING]

    # --------------------------------------------- speculative decoding
    def _spec_bucket(self, k):
        """Smallest spec-K bucket >= k (captures stay bounded by the
        bucket set, like horizons)."""
        for b in self.spec_k_buckets:
            if b >= k:
                return b
        return self.spec_k_buckets[-1]

    def _update_spec_k(self, req, proposed, accepted):
        """Per-request adaptive K: an EWMA of the per-round acceptance
        fraction; shrink a bucket when drafts mostly miss (each rejected
        column is wasted verify work and a rolled-back KV write), grow
        back toward ``spec_k`` when they mostly hit."""
        if proposed <= 0:
            return
        rate = accepted / proposed
        prev = req._spec_accept
        req._spec_accept = rate if prev is None else 0.5 * prev + 0.5 * rate
        k = self.spec_k if req._spec_k is None else req._spec_k
        if req._spec_accept < 0.35:
            k = max(1, k // 2)
        elif req._spec_accept > 0.75:
            k = min(self.spec_k, max(1, k) * 2)
        req._spec_k = self._spec_bucket(k)

    def _collect_drafts(self, running):
        """Ask the drafter for proposals, with per-request containment:
        an exception degrades THAT request to normal decode (sticky via
        ``_spec_off``) without touching the loop or its peers."""
        items = []
        for slot in running:
            req = self.slot_req[slot]
            if req._spec_off:
                continue
            if req.grammar is not None:
                # a draft column's validity depends on the mask after the
                # one before it: the slot rides the round as a width-0
                # one-token decode under its fresh mask
                continue
            if not req.sampling.is_greedy and \
                    not getattr(self._spec, "supports_sampling", False):
                # a drafter that has not opted into lossless sampled
                # verification loses this slot's proposals, not the round
                continue
            # never draft past the request's budget (the bonus token
            # supplies the last one) or the slot's page table
            k = min(self.spec_k if req._spec_k is None else req._spec_k,
                    req.remaining_new - 1,
                    self.kv.max_tokens_per_slot() - int(self.lengths[slot])
                    - 1)
            if k > 0:
                items.append((slot, req, k))
        if not items:
            return {}
        try:
            drafts = self._spec.propose(items)
        except Exception:
            # the batch call hides WHICH request blew up: propose item
            # by item so the offenders degrade and their peers keep
            # their drafts
            drafts = {}
            for item in items:
                try:
                    drafts.update(self._spec.propose([item]))
                except Exception as e:
                    item[1]._spec_off = True
                    self.metrics.record_spec_degrade(
                        self.step_idx, item[1].rid,
                        f"{type(e).__name__}: {e}")
        out = {}
        for s, _, _ in items:
            # no truthiness on a proposal: a numpy array would raise
            # here, outside the containment above
            d = drafts.get(s)
            out[s] = [int(t) for t in d] if d is not None and len(d) else []
        return out

    def _dispatch_spec(self, running):
        """One draft / verify round over the running slots.  Returns True
        when a verify was dispatched (or the round consumed the step by
        closing slots); False falls back to the plain horizon."""
        drafts = self._collect_drafts(running)
        proposing = [s for s in running if drafts.get(s)]
        # a verify round runs every non-proposing slot as a one-token
        # decode: when proposers are a minority the plain horizon
        # produces more.  Abandoned proposals are safe to drop (the
        # n-gram drafter is stateless; DraftModelDrafter._sync truncates
        # draft KV that was never verified)
        if not proposing or 2 * len(proposing) < len(running):
            return False
        k = self._spec_bucket(max(len(d) for d in drafts.values()))
        # a verify writes widths[s] + 1 positions (the rollback releases
        # the surplus): shrink the K bucket before any eviction runs
        reclaimable = None
        while k > 1:
            need = sum(self.kv.pages_needed(
                s, int(self.lengths[s]) + min(len(drafts.get(s, ())), k)
                + 1) for s in running)
            avail = self.kv.pool.free_pages
            if need > avail:
                if reclaimable is None:
                    reclaimable = self._reclaimable()
                avail += reclaimable
            if need <= avail:
                break
            k = _floor_bucket(self.spec_k_buckets, k - 1)
        kept = []
        for slot in running:
            req = self.slot_req[slot]
            if req is None or req.state != RUNNING:
                continue       # evicted by an earlier slot's growth
            w = min(len(drafts.get(slot, ())), k)
            try:
                if self._grow_or_evict(slot,
                                       int(self.lengths[slot]) + w + 1):
                    kept.append(slot)
            except PagePoolExhausted as e:
                self._close_slot(slot, SHED, f"page capacity: {e}")
            except Exception as e:
                self._close_slot(slot, FAILED, f"{type(e).__name__}: {e}")
        running = [s for s in kept if self.slot_req[s] is not None and
                   self.slot_req[s].state == RUNNING]
        if not running:
            return True
        draft_arr = np.zeros((self.num_slots, k), np.int32)
        widths = np.zeros(self.num_slots, np.int32)
        active = np.zeros(self.num_slots, bool)
        budgets = np.zeros(self.num_slots, np.int32)
        for s in running:
            d = drafts.get(s, [])[:k]
            draft_arr[s, :len(d)] = d
            widths[s] = len(d)
            active[s] = True
            budgets[s] = self.slot_req[s].remaining_new
        self._chain_budgets = budgets
        args = (self.last_tok, draft_arr, active, self.kv.table,
                self.lengths, self.pools)
        kw = dict(widths=widths, budgets=budgets, eos_ids=self._eos_ids)
        if self._batch_needs_policy(running):
            out = self.engine.verify_multi_policy(
                *args, **kw, **self._policy_args(running))
            self.metrics.record_policy_dispatch()
            out = out[:7] + out[8:]   # counts_end: the host mirror rules
        else:
            out = self.engine.verify_multi(*args, **kw)
        toks, valid, tok_end, active_end, lengths_end, emitted_end, \
            accepted, self.pools = out
        self._inflight.append({
            "spec": True, "slots": list(running),
            "reqs": {s: self.slot_req[s] for s in running},
            "horizon": k + 1,
            "widths": {s: int(widths[s]) for s in running},
            "host": self.engine.copy_to_host_async(toks, valid, accepted),
            "tok_end": tok_end, "active_end": active_end,
            "lengths_end": lengths_end, "emitted_end": emitted_end,
            "policy": None, "release_after": set()})
        return True

    def _dispatch(self):
        """Reserve pages and dispatch one speculative round or one fused
        horizon over every running slot.  The batched dispatch is shared
        work: an error there is not one request's and propagates."""
        running = [s for s in range(self.num_slots)
                   if self.slot_req[s] is not None and
                   self.slot_req[s].state == RUNNING]
        if not running:
            return
        if self._spec is not None and self._dispatch_spec(running):
            return
        horizon, running = self._reserve(
            running, self._pick_horizon(running, time.monotonic()))
        if not running:
            return
        active = np.zeros(self.num_slots, bool)
        active[running] = True
        budgets = np.zeros(self.num_slots, np.int32)
        for s in running:
            budgets[s] = self.slot_req[s].remaining_new
        # budgets baseline of any chained continuation: the device's
        # `emitted` carry counts from THIS dispatch
        self._chain_budgets = budgets
        args = (self.last_tok, active, self.kv.table, self.lengths,
                self.pools)
        kw = dict(horizon=horizon, budgets=budgets, eos_ids=self._eos_ids)
        pol = None
        if self._batch_needs_policy(running):
            pol = self._policy_args(running)
            out = self.engine.decode_multi_policy(*args, **kw, **pol)
            self.metrics.record_policy_dispatch()
        else:
            out = self.engine.decode_multi(*args, **kw)
        self._commit_dispatch(out, running, horizon,
                              {s: self.slot_req[s] for s in running}, pol)

    def _commit_dispatch(self, out, running, horizon, reqs, policy=None):
        if policy is not None:
            # the policy body returns the counts carry before the pools:
            # a chained continuation takes IT (the device's truth
            # mid-chain), not the host mirror
            policy = dict(policy, counts=out[6])
            out = out[:6] + out[7:]
        toks, valid, tok_end, active_end, lengths_end, emitted_end, \
            self.pools = out
        self._inflight.append({
            "slots": list(running), "reqs": reqs, "horizon": horizon,
            # per-slot bound on this horizon's length advance: it sizes
            # the NEXT chained reservation (the real advance is known
            # only at harvest)
            "max_advance": {s: int(min(horizon, reqs[s].remaining_new))
                            for s in running},
            # the host copy starts now, so the harvest one horizon later
            # rarely waits for it
            "host": self.engine.copy_to_host_async(toks, valid),
            "tok_end": tok_end, "active_end": active_end,
            "lengths_end": lengths_end, "emitted_end": emitted_end,
            "policy": policy, "release_after": set()})

    def _try_chain(self):
        """Dispatch the next horizon straight off the in-flight horizon's
        device carries, with no host round trip, when membership is
        provably frozen: nothing waiting or prefilling, no cancel or
        deadline live, some budget left after the in-flight horizon, and
        the next horizon's worst-case page growth fits in FREE pages.  A
        chained dispatch never evicts: the device may still be writing a
        victim's pages.  Returns True when it dispatched."""
        prev = self._inflight[-1]
        if self._spec is not None or prev.get("spec"):
            # spec rounds need the host's token history (the drafter
            # reads out_tokens) and a host-side rollback per verify:
            # every spec step is a barrier step by design
            return False
        if self.waiting:
            return False
        live = [r for r in self.slot_req if r is not None]
        if any(r.state == PREFILL for r in live):
            return False
        if any(r.cancelled or r.deadline is not None for r in live):
            return False
        cont = [s for s in prev["slots"]
                if self.slot_req[s] is prev["reqs"][s] and
                prev["reqs"][s].state == RUNNING and
                s not in self._zombies]
        if not cont:
            return False
        if any(prev["reqs"][s].grammar is not None for s in cont):
            # a grammar slot's next mask depends on the in-flight tokens
            return False
        if all(prev["reqs"][s].remaining_new - prev["max_advance"][s] <= 0
               for s in cont):
            # the in-flight horizon exhausts every budget: a chained one
            # would run over frozen slots only
            return False
        # remaining_new is an upper bound here (the in-flight tokens are
        # not appended yet): horizon sizing and the page reservation only
        # over-provision
        horizon = _floor_bucket(
            self.horizon_buckets,
            min(self.decode_horizon_steps,
                max(prev["reqs"][s].remaining_new for s in cont)))
        targets, need = {}, 0
        for s in cont:
            req = prev["reqs"][s]
            cap = len(req.orig_prompt) + req.max_new_tokens
            targets[s] = min(int(self.lengths[s]) + prev["max_advance"][s]
                             + horizon, cap)
            need += self.kv.pages_needed(s, targets[s])
        short = need - self.kv.pool.free_pages
        # a chained dispatch never evicts a live slot (the device may
        # still be writing its pages), but pages only the cache holds are
        # read by no live row of the horizon in flight, and the next
        # horizon runs after it in stream order: draining them is safe
        # (after checking the drain can cover the shortfall)
        if short > 0 and (short > self._reclaimable() or
                          self._reclaim_cached(short) < short):
            return False
        for s in cont:
            if not self.kv.ensure_capacity(s, targets[s]):
                return False
        keep = None
        if self._zombies:
            # freeze slots closed host-side while the in-flight horizon
            # still had them active
            keep = np.ones(self.num_slots, bool)
            keep[list(self._zombies)] = False
        args = (prev["tok_end"], prev["active_end"], self.kv.table,
                prev["lengths_end"], self.pools)
        kw = dict(horizon=horizon, budgets=self._chain_budgets,
                  eos_ids=self._eos_ids, emitted=prev["emitted_end"],
                  keep=keep)
        pol = prev["policy"]
        if pol is not None:
            # membership is frozen, so the staged lanes are unchanged;
            # tok_base stays the chain start's (the `emitted` carry keeps
            # the stream's positions) and counts is the device carry
            out = self.engine.decode_multi_policy(*args, **kw, **pol)
            self.metrics.record_policy_dispatch()
        else:
            out = self.engine.decode_multi(*args, **kw)
        self._commit_dispatch(out, cont, horizon,
                              {s: prev["reqs"][s] for s in cont}, pol)
        return True

    def _harvest(self):
        """Pull the oldest in-flight horizon's token block and run the
        bookkeeping: emit, retire, honor cancellations, deadlines and
        callback failures found at this boundary, and release the pages
        parked on this horizon.  Returns (device_wait_s, tokens
        delivered)."""
        rec = self._inflight.popleft()
        t0 = time.monotonic()
        toks, valid, *accepted = rec["host"].wait()
        wait = time.monotonic() - t0
        now = time.monotonic()
        pulled = 0
        for slot in rec["slots"]:
            req = rec["reqs"][slot]
            if req.state in TERMINAL or self.slot_req[slot] is not req:
                continue       # closed at an earlier boundary
            if req.cancelled:
                # tokens past the cancel are dropped
                self._close_slot_or_defer(slot, CANCELLED, "cancelled")
                continue
            if req.past_deadline(now):
                self._close_slot_or_defer(slot, SHED,
                                          "deadline expired mid-flight")
                continue
            n = int(valid[slot].sum())
            if n and req.t_last is not None:
                self.metrics.record_tbt(now - req.t_last)
            for i in range(rec["horizon"]):
                if not valid[slot, i]:
                    continue
                tok = int(toks[slot, i])
                try:
                    self._emit(req, tok)
                    pulled += 1
                    # a grammar rejection of a delivered token fails this
                    # request (the device mask should make it impossible)
                    self._note_emitted(slot, req, tok)
                except Exception as e:  # per-request callback fault
                    self._close_slot_or_defer(
                        slot, FAILED, f"{type(e).__name__}: {e}")
                    break
                if req._finished_by(tok) or self._grammar_finished(req):
                    # the device froze the slot at this same token, so a
                    # chained horizon only reads its pages: release now
                    # (a grammar cursor with no continuation finishes the
                    # request without an eos)
                    self._retire(slot)
                    break
            if self.slot_req[slot] is req and req.state == RUNNING and \
                    req.grammar is not None:
                # the next (barrier, horizon-1) dispatch's mask
                self._grammar_masks[slot] = req.grammar.token_mask()
            if self.slot_req[slot] is req and req.state == RUNNING:
                self.lengths[slot] += n
                if n:
                    self.last_tok[slot] = int(toks[slot][valid[slot]][-1])
        if rec.get("spec"):
            self._harvest_spec(rec, valid, accepted[0])
        for slot in rec["release_after"]:
            self.kv.release_slot(slot)
            self.lengths[slot] = 0
            self._zombies.discard(slot)
        if rec.get("spec"):
            self.metrics.record_spec_wait(wait)
        else:
            self.metrics.record_horizon(rec["horizon"], pulled, wait)
        return wait, pulled

    def _harvest_spec(self, rec, valid, accepted):
        """Spec-round epilogue: roll the KV back to the emitted boundary
        (``truncate_slot``: pages written for rejected drafts recycle),
        feed the drafter its acceptance outcome, adapt each request's K,
        and record the round.  Runs after the shared emit / retire loop,
        so ``lengths`` already counts only emitted tokens and
        ``out_tokens`` is current."""
        proposed = acc_total = rollbacks = rollback_tokens = 0
        for slot in rec["slots"]:
            req = rec["reqs"][slot]
            w = rec["widths"][slot]
            n = int(valid[slot].sum())
            acc = int(accepted[slot])
            proposed += w
            acc_total += acc
            discard = max(0, (w + 1) - n)
            if discard:
                rollbacks += 1
                rollback_tokens += discard
            self._update_spec_k(req, w, acc)
            if self.slot_req[slot] is req and req.state == RUNNING:
                # a live slot: release the pages past the emitted
                # boundary (a retired slot's went at retire)
                self.kv.truncate_slot(slot, int(self.lengths[slot]))
                if self._spec is not None:
                    try:
                        self._spec.on_verified(slot, req, n, acc)
                    except Exception as e:   # containment, as ever
                        req._spec_off = True
                        self.metrics.record_spec_degrade(
                            self.step_idx, req.rid,
                            f"{type(e).__name__}: {e}")
        self.metrics.record_spec(
            proposed=proposed, accepted=acc_total, emitted=int(valid.sum()),
            rollbacks=rollbacks, rollback_tokens=rollback_tokens,
            slot_rounds=sum(1 for s in rec["slots"] if rec["widths"][s] > 0))

    def _close_slot_or_defer(self, slot, state, reason):
        """Terminal removal found at a horizon boundary.  While a chained
        horizon still runs this slot the device may be writing its pages:
        close the request now (state, metrics, history) and hold the
        pages until that horizon is harvested."""
        if not self._inflight:
            self._close_slot(slot, state, reason)
            return
        req = self.slot_req[slot]
        self._spec_release(slot, req)
        self.slot_req[slot] = None
        self._finalize(req, state, reason)
        self._zombies.add(slot)
        self._inflight[-1]["release_after"].add(slot)

    def run(self, max_steps=100000):
        """Drive step() until idle; returns {rid: generated tokens} for
        requests that FINISHED during (or before) this call."""
        self._collect = {r.rid: list(r.out_tokens) for r in self.completed
                         if r.state == FINISHED}
        t0 = time.monotonic()
        try:
            for _ in range(max_steps):
                if not self.step():
                    break
        finally:
            results, self._collect = self._collect, None
        self._wall_s = time.monotonic() - t0
        return results

    @property
    def kv_dtype_name(self):
        """The pools' kv dtype, read from the live leaves (what is
        allocated, not what was configured)."""
        return kv_dtype_name(self.pools["layers"][0])

    def _prefix_summary(self):
        pc = self.prefix_cache
        return {f"prefix_{k}": 0 if pc is None else getattr(pc, k)
                for k in ("tokens_reused", "pages_shared", "cached_pages",
                          "cow_copies", "donated_pages", "evicted_pages")}

    def summary(self):
        """Metrics summary of the last run() plus the pool's peak, the
        weight and kv dtypes, the pools' bytes (every leaf, scale leaves
        and sink pages included), the default decoding policy and the
        prefix cache's own counters."""
        out = self.metrics.summary(wall_s=self._wall_s)
        out.update(steps=self.step_idx, pool_pages=self.kv.pool.num_pages,
                   pool_peak_pages=self.kv.pool.peak_in_use,
                   paged_attention=self.engine.paged_kernel_decision(
                       pools=self.pools),
                   kv_dtype=self.kv_dtype_name,
                   weight_dtype=self.engine.weight_dtype_name,
                   spec_decode=self.spec_mode,
                   decoding_policy=self.default_sampling.label(),
                   prefix_cache=self.prefix_cache is not None,
                   **self._prefix_summary(),
                   kv_pool_bytes_total=sum(
                       t.numel() * t.element_size()
                       for layer in self.pools["layers"]
                       for t in layer.values()))
        return out
