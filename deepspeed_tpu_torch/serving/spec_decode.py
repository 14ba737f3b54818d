"""Speculative decoding: pluggable drafters for draft/verify serving —
the port's copy of ``deepspeed_tpu/serving/spec_decode.py``.

Speculative decoding (Leviathan et al., "Fast Inference from
Transformers via Speculative Decoding") converts K cheap *draft* tokens
plus ONE fused target-model *verify* dispatch into up to K+1 accepted
tokens.  The scheduler (``serving/scheduler.py``, ``spec_decode=...``)
collects proposals from a :class:`Drafter`, scores them with
``InferenceEngine.verify_multi`` — a teacher-forced batched forward
over the paged cache, replayed from a CUDA graph per K bucket on the
card — accepts the longest greedy-matching prefix plus the target's
one bonus/correction token, and rolls the KV back past the rejection
point (``PagedKVManager.truncate_slot``).  Because the bonus token is
exactly what sequential greedy decode would have produced, drafter
quality only changes SPEED, never output: serving stays token-exact vs
``generate()`` with any drafter, including an adversarially wrong one.

Two stock drafters:

* :class:`NgramDrafter` — model-free prompt-lookup drafting: propose the
  continuation that followed the most recent earlier occurrence of the
  request's current token suffix inside its own prompt + output
  history.  Zero extra FLOPs and no state to manage — suited to
  summarization / extraction / code traffic, whose outputs quote their
  inputs.

* :class:`DraftModelDrafter` — a smaller model of the same architecture
  running on its OWN paged KV slots (its own ``PagedKVManager`` +
  pools, slot-aligned with the target scheduler) through a second
  ``InferenceEngine``.  Proposals come from one fused ``decode_multi``
  over the draft cache; the draft cache is kept coherent with the
  *verified* sequence by lazy teacher-forced sync (the same
  chunked-prefill primitive that seeds it) and rolled back alongside
  the target after each verify.

The drafter API is deliberately forgiving: ``propose`` may return fewer
tokens than asked (or none — the slot then rides the verify dispatch as
a plain one-token decode), and any exception it raises is contained by
the scheduler (that request degrades to normal decode; the loop never
dies).  ``supports_sampling`` is the drafter's opt-in to lossless
sampled verification (``verify_multi_policy``): a drafter without it
loses its sampled slots' proposals, never the round.
"""

import numpy as np

from deepspeed_tpu_torch.serving.page_manager import PagedKVManager


class Drafter:
    """Interface the scheduler drives.

    ``propose(items)`` with ``items = [(slot, req, k), ...]`` returns
    ``{slot: [draft token ids]}`` with at most ``k`` tokens per slot
    (fewer — including zero — is always legal).  ``on_verified`` /
    ``on_release`` are lifecycle hooks for stateful drafters; the
    scheduler calls ``on_release`` on EVERY slot-exit path (retire,
    fail, shed, cancel, preemption), so per-slot state cannot leak.
    """

    name = "custom"

    # Capability flag of lossless sampled verification
    # (``verify_multi_policy``): the stock drafters opt in; a drafter
    # without it drafts for greedy requests only.
    supports_sampling = False

    def propose(self, items):
        raise NotImplementedError

    def on_verified(self, slot, req, n_emitted, n_accepted):
        """After a verify harvest: ``n_emitted`` tokens (accepted drafts
        + the bonus token) were appended to ``req.out_tokens``."""

    def on_release(self, slot, req):
        """The slot was vacated (any terminal or preemption path)."""


class NgramDrafter(Drafter):
    """Prompt-lookup / n-gram drafting: match the sequence's trailing
    n-gram against its own earlier history and propose what followed
    the most recent match.

    The suffix length tried runs ``max_ngram`` down to ``min_ngram`` —
    longer matches are more specific, so they are preferred; the MOST
    RECENT earlier occurrence wins (recency tracks the current
    generation regime, e.g. a degenerate repetition loop or a quoted
    span).  ``window`` caps how far back the scan looks so per-proposal
    host cost stays O(window * max_ngram) regardless of sequence
    length.  Completely stateless: history is re-derived from
    ``req.orig_prompt + req.out_tokens`` (NOT ``req.prompt``, which
    folds emitted tokens back in after a preemption and would
    double-count them)."""

    name = "ngram"
    supports_sampling = True

    def __init__(self, max_ngram=3, min_ngram=1, window=1024):
        self.max_ngram = int(max_ngram)
        self.min_ngram = max(1, int(min_ngram))
        self.window = int(window)

    def _propose_one(self, req, k):
        hist = req.orig_prompt + req.out_tokens
        if len(hist) < self.min_ngram + 1:
            return []
        lo = max(0, len(hist) - self.window)
        for m in range(min(self.max_ngram, len(hist) - 1),
                       self.min_ngram - 1, -1):
            pat = hist[-m:]
            # most recent occurrence first: recency tracks the current
            # generation regime (a repetition loop, a quoted span)
            for i in range(len(hist) - m - 1, lo - 1, -1):
                if hist[i:i + m] != pat:
                    continue
                # literal continuation, extended CYCLICALLY past the end
                # of history: the match distance IS the period of the
                # repeating regime, so wrapping drafts the loop's next
                # lap — this is what fills the whole K budget on the
                # degenerate repeats that make spec decode pay (a wrong
                # extrapolation merely gets rejected: speed, not
                # correctness, is at stake)
                period = (len(hist) - m) - i
                cont = []
                for j in range(k):
                    idx = i + m + j
                    while idx >= len(hist):
                        idx -= period
                    cont.append(hist[idx])
                return cont
        return []

    def propose(self, items):
        return {slot: self._propose_one(req, k) for slot, req, k in items}


class DraftModelDrafter(Drafter):
    """Draft-model drafting over a private paged KV cache.

    ``engine`` is an :class:`InferenceEngine` wrapping a SMALLER config
    of the same architecture (params already set).  Each scheduler slot
    maps 1:1 to a draft slot; the draft cache must hold KV for exactly
    the *verified* sequence prefix, which three pieces maintain:

    * ``_written[slot]`` — positions whose KV is KNOWN to match the true
      sequence (``req.orig_prompt + req.out_tokens``).
    * **lazy sync** — before proposing, any gap between ``_written`` and
      ``len(seq) - 1`` (the last emitted token's KV is pending, same
      invariant as the target cache) is teacher-forced in via the
      chunked-prefill primitive, and any unverified draft KV left by a
      round whose verify never harvested (spec fallback, fault degrade)
      is truncated first.  This one mechanism covers initial prompt
      prefill, catch-up after normal-decode interludes, and recovery
      from abandoned rounds.
    * **rollback** — ``on_verified`` truncates the draft chain to the
      newly verified boundary, releasing draft pages past it.

    Proposals for all requesting slots run as ONE fused
    ``decode_multi`` over the draft table (per-slot ``budgets`` carry
    the per-slot K, so one dispatch serves mixed Ks); the draft engine's
    captures are bounded by its horizon bucket set like the target's.
    Draft-pool pressure degrades gracefully: a slot whose draft pages
    cannot grow simply proposes nothing this round."""

    name = "draft"
    supports_sampling = True

    def __init__(self, engine, *, num_slots, num_pages, page_size,
                 max_pages_per_slot=None, prefill_chunk=32):
        self.engine = engine
        if max_pages_per_slot is None:
            max_pages_per_slot = -(-num_pages // 2) or 1
        self.kv = PagedKVManager(num_pages, page_size, num_slots,
                                 max_pages_per_slot)
        self.pools = engine.init_paged_cache(num_pages, page_size)
        self.num_slots = int(num_slots)
        self.lengths = np.zeros(num_slots, np.int32)
        self.prefill_chunk = int(prefill_chunk)
        self._written = np.zeros(num_slots, np.int64)

    def _sync(self, slot, req):
        """Bring the draft cache to the verified boundary; returns False
        when draft pages cannot grow (degrade: no proposal)."""
        seq = req.orig_prompt + req.out_tokens
        target = len(seq) - 1
        written = int(self._written[slot])
        if int(self.lengths[slot]) > written:
            # unverified draft KV from a round that was never harvested
            self.kv.truncate_slot(slot, written)
            self.lengths[slot] = written
        if target > self.kv.max_tokens_per_slot():
            # the verified stream has outgrown the draft slot's table
            # (a draft pool sized smaller than the target's): drafting
            # is impossible from here on — degrade to no proposal
            # rather than let ensure_capacity raise its config error
            return False
        pos = written
        while pos < target:
            # stop at the target: the last token's KV is the draft
            # scan's to write.  (The JAX package's chunk runs on to the
            # chunk size and writes it twice, which misaligns every
            # proposal after the first.)
            chunk = seq[pos:min(pos + self.prefill_chunk, target)]
            n = len(chunk)
            if not self.kv.ensure_capacity(slot, pos + n):
                self._written[slot] = pos
                return False
            ids = np.zeros((1, self.prefill_chunk), np.int32)
            ids[0, :n] = chunk
            _, self.pools = self.engine.prefill_into_slots(
                ids, slot, n, self.kv.table, self.lengths, self.pools)
            self.lengths[slot] += n
            pos += n
        self._written[slot] = target
        return True

    def propose(self, items):
        out = {slot: [] for slot, _, _ in items}
        batch = []
        for slot, req, k in items:
            if not self._sync(slot, req):
                continue
            # cap K against the POST-sync length: _sync just advanced
            # the slot to the verified boundary, and a cap computed
            # from the stale pre-sync length could push
            # ensure_capacity past max_pages_per_slot (which raises
            # the config error, sticky-degrading the request)
            k = min(int(k),
                    self.kv.max_tokens_per_slot() - int(self.lengths[slot])
                    - 1)
            if k <= 0:
                continue
            # the draft scan writes k positions starting at lengths
            if not self.kv.ensure_capacity(slot,
                                           int(self.lengths[slot]) + k):
                continue
            batch.append((slot, req, k))
        if not batch:
            return out
        toks = np.zeros(self.num_slots, np.int32)
        active = np.zeros(self.num_slots, bool)
        budgets = np.zeros(self.num_slots, np.int32)
        eos_ids = np.full(self.num_slots, -1, np.int32)
        for slot, req, k in batch:
            toks[slot] = req.out_tokens[-1] if req.out_tokens \
                else req.prompt[-1]
            active[slot] = True
            budgets[slot] = k
            if req.eos_token_id is not None:
                # stop drafting past an eos the draft model itself emits
                eos_ids[slot] = int(req.eos_token_id)
        horizon = 1
        while horizon < max(k for _, _, k in batch):
            horizon *= 2
        blk, valid, _, _, _, _, self.pools = self.engine.decode_multi(
            toks, active, self.kv.table, self.lengths, self.pools,
            horizon=horizon, budgets=budgets, eos_ids=eos_ids)
        blk, valid = self.engine.copy_to_host_async(blk, valid).wait()
        for slot, req, k in batch:
            n = int(valid[slot].sum())
            out[slot] = [int(t) for t in blk[slot][valid[slot]]][:k]
            self.lengths[slot] += n
            if n:
                # the fed token (seq's last) was written at the verified
                # boundary — that one position IS verified
                self._written[slot] += 1
        return out

    def on_verified(self, slot, req, n_emitted, n_accepted):
        # accepted drafts are now part of the true sequence: the draft
        # KV for them is valid; everything past rolls back with the
        # target (draft pages past the boundary recycle).  The draft
        # scan never wrote KV for its LAST proposed token (emitted, KV
        # pending, like any decode) — on full acceptance the verified
        # boundary passes that hole by one, so cap at the written
        # watermark and let _sync teacher-force the gap next round.
        boundary = len(req.orig_prompt) + len(req.out_tokens) - 1
        valid = min(boundary, int(self.lengths[slot]))
        self._written[slot] = valid
        self.kv.truncate_slot(slot, valid)
        self.lengths[slot] = valid

    def on_release(self, slot, req):
        self.kv.release_slot(slot)
        self.lengths[slot] = 0
        self._written[slot] = 0
