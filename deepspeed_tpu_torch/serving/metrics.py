"""Serving observability — the counters the scheduler core records
(counterpart of ``ServingMetrics`` in ``deepspeed_tpu/serving/metrics.py``).

TTFT / per-token latency / horizon-burst gaps, the per-step queue and
pool gauges, and per harvested horizon the tokens delivered and the time
the host waited on the device.  Latency samples are durations from
``time.monotonic()``.
Terminal outcomes are counted distinctly (completed / failed / shed /
cancelled).  Speculative rounds count their draft tokens, acceptances,
emitted tokens, rollbacks and contained drafter faults.  The prefix
cache counts its admission lookups, hits, reused (prefill-saved) tokens
and drained pages, and the decoding-policy subsystem its sampled and
grammar intakes, policy dispatches and grammar violations.  The
tenancy and memory-telemetry counters, and the monitor event sink, come
with their subsystems (ROADMAP.md Queue A10).
"""

from collections import deque

import numpy as np


_COUNTER = {"finished": "completed", "failed": "failed", "shed": "shed",
            "cancelled": "cancelled"}


def _percentile(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if values else 0.0


class ServingMetrics:
    """Aggregates per-request latency samples and per-step gauges."""

    def __init__(self):
        self.ttft_s = []              # submit -> first token, per request
        self.tpot_s = []              # inter-token gaps, per token
        self.tbt_s = []               # horizon-boundary gaps, per request
        self.completed = 0
        self.failed = 0               # per-request error, contained
        self.shed = 0                 # deadline/capacity load shedding
        self.cancelled = 0
        self.preemptions = 0
        self.tokens_emitted = 0
        self.page_util = []           # pool utilization per step
        self.queue_depths = []
        self.horizons = []            # fused decode horizon per harvest
        self.horizon_tokens = 0       # tokens those harvests delivered
        self.horizon_wait_s = 0.0     # harvest time blocked on the device
        self.device_wait_s = 0.0      # step time blocked on the device
        self.host_s = 0.0             # step time doing host bookkeeping
        # speculative decoding (draft/verify rounds)
        self.spec_dispatches = 0       # verify_multi rounds harvested
        self.spec_proposed = 0         # draft tokens scored (sum widths)
        self.spec_accepted = 0         # drafts the target's argmax matched
        self.spec_emitted = 0          # tokens a verify round produced
        self.spec_rollbacks = 0        # rounds that discarded written KV
        self.spec_rollback_tokens = 0  # KV positions rolled back
        self.spec_slot_rounds = 0      # (slot, round) pairs that proposed
        self.spec_degraded = 0         # drafter faults contained
        self.spec_degrade_log = deque(maxlen=64)  # (step, rid, reason)
        self.spec_wait_s = 0.0         # harvest time blocked on verifies
        # prefix cache (admission-time KV reuse)
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefill_tokens_saved = 0  # == cached prefix tokens reused
        self.cache_evictions = 0       # cached pages drained under pressure
        # decoding-policy subsystem (serving/sampling/)
        self.sampled_requests = 0      # intakes with a sampled policy
        self.grammar_requests = 0      # intakes carrying a grammar
        self.policy_dispatches = 0     # dispatches on the policy bodies
        self.grammar_violations = 0    # grammar cursor rejected a token
        self.grammar_violation_log = deque(maxlen=64)  # (step, rid)

    def record_step(self, *, queue_depth, page_utilization,
                    device_wait_s, host_s):
        self.page_util.append(page_utilization)
        self.queue_depths.append(queue_depth)
        self.device_wait_s += device_wait_s
        self.host_s += host_s

    def record_tbt(self, gap_s):
        """Gap between one request's consecutive token deliveries (fused
        horizons deliver tokens in bursts)."""
        self.tbt_s.append(gap_s)

    def record_horizon(self, horizon, tokens, device_wait_s):
        """One fused decode horizon was harvested: its step count, the
        tokens it delivered, and how long the host blocked waiting for
        the device (0 when the overlapped copy had already landed)."""
        self.horizons.append(horizon)
        self.horizon_tokens += tokens
        self.horizon_wait_s += device_wait_s

    def record_spec(self, *, proposed, accepted, emitted, rollbacks,
                    rollback_tokens, slot_rounds=0):
        """One speculative draft/verify round was harvested: ``proposed``
        draft tokens were scored in one dispatch, ``accepted`` matched
        the target's argmax, ``emitted`` tokens came out (accepted
        prefixes + one bonus token per live slot), and
        ``rollback_tokens`` KV positions written for rejected drafts
        were rolled back across ``rollbacks`` slots."""
        self.spec_dispatches += 1
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self.spec_emitted += emitted
        self.spec_rollbacks += rollbacks
        self.spec_rollback_tokens += rollback_tokens
        self.spec_slot_rounds += slot_rounds

    def record_spec_degrade(self, step, rid=None, reason=None):
        """A drafter exception was contained: the request degraded to
        normal decode.  The which / why goes into ``spec_degrade_log``
        (bounded)."""
        self.spec_degraded += 1
        self.spec_degrade_log.append((step, rid, reason))

    def record_spec_wait(self, device_wait_s):
        """Host time blocked pulling a verify round's results."""
        self.spec_wait_s += device_wait_s

    def spec_acceptance_rate(self):
        return self.spec_accepted / self.spec_proposed \
            if self.spec_proposed else 0.0

    def spec_mean_accepted(self):
        """Mean accepted draft tokens per proposing slot per round (what sets
        the speedup: each slot-round costs ~one shared target
        forward and yields mean_accepted + 1 tokens)."""
        return self.spec_accepted / self.spec_slot_rounds \
            if self.spec_slot_rounds else 0.0

    def record_prefix(self, cached_tokens, prompt_tokens):
        """One admission-time prefix-cache lookup: ``cached_tokens`` of
        the ``prompt_tokens``-long prompt came from cached pages (0: a
        miss).  Every cached token is a prefill token not computed."""
        self.prefix_lookups += 1
        if cached_tokens > 0:
            self.prefix_hits += 1
            self.prefill_tokens_saved += cached_tokens

    def record_cache_eviction(self, pages):
        """Cached pages drained back to the free list under pool pressure
        (reclaim, not failure)."""
        self.cache_evictions += pages

    def record_policy_request(self, *, sampled, grammar):
        """One intake carried a non-greedy decoding policy: it samples or
        penalizes (``sampled``) and / or is grammar-constrained."""
        self.sampled_requests += bool(sampled)
        self.grammar_requests += bool(grammar)

    def record_policy_dispatch(self):
        """One dispatch ran a policy body (``decode_multi_policy`` /
        ``verify_multi_policy``) instead of the greedy one."""
        self.policy_dispatches += 1

    def record_grammar_violation(self, step, rid=None):
        """The host grammar cursor rejected a token the device emitted;
        the device mask should make this impossible, so each one is a
        fault (the request fails)."""
        self.grammar_violations += 1
        self.grammar_violation_log.append((step, rid))

    def record_first_token(self, ttft_s):
        self.ttft_s.append(ttft_s)
        self.tokens_emitted += 1

    def record_token(self, gap_s):
        self.tpot_s.append(gap_s)
        self.tokens_emitted += 1

    def record_terminal(self, state):
        """A request left the loop: ``finished``, ``failed``, ``shed`` or
        ``cancelled``."""
        setattr(self, _COUNTER[state], getattr(self, _COUNTER[state]) + 1)

    def record_preemption(self):
        self.preemptions += 1

    def summary(self, wall_s=None):
        pct = {f"{name}_ms_p{q}": round(_percentile(vals, q) * 1e3, 3)
               for name, vals in (("ttft", self.ttft_s),
                                  ("tpot", self.tpot_s),
                                  ("tbt", self.tbt_s))
               for q in (50, 90, 99)}
        busy = self.device_wait_s + self.host_s
        out = {
            "completed": self.completed,
            "failed": self.failed,
            "shed": self.shed,
            "cancelled": self.cancelled,
            "tokens_emitted": self.tokens_emitted,
            "preemptions": self.preemptions,
            **pct,
            "horizon_mean": round(float(np.mean(self.horizons)), 3)
            if self.horizons else 0.0,
            "device_wait_frac": round(self.device_wait_s / busy, 4)
            if busy > 0 else 0.0,
            "page_util_mean": round(float(np.mean(self.page_util)), 4)
            if self.page_util else 0.0,
            "page_util_peak": round(float(np.max(self.page_util)), 4)
            if self.page_util else 0.0,
            "queue_depth_peak": int(np.max(self.queue_depths))
            if self.queue_depths else 0,
            "spec_dispatches": self.spec_dispatches,
            "spec_draft_tokens": self.spec_proposed,
            "spec_accepted_tokens": self.spec_accepted,
            "spec_acceptance_rate": round(self.spec_acceptance_rate(), 4),
            "spec_mean_accepted": round(self.spec_mean_accepted(), 3),
            "spec_rollbacks": self.spec_rollbacks,
            "spec_rollback_tokens": self.spec_rollback_tokens,
            "spec_degraded": self.spec_degraded,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": round(
                self.prefix_hits / self.prefix_lookups, 4)
            if self.prefix_lookups else 0.0,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "cache_evictions": self.cache_evictions,
            "sampled_requests": self.sampled_requests,
            "grammar_requests": self.grammar_requests,
            "policy_dispatches": self.policy_dispatches,
            "grammar_violations": self.grammar_violations,
        }
        out["horizon_wait_s"] = round(self.horizon_wait_s, 6)
        out["spec_wait_s"] = round(self.spec_wait_s, 6)
        if wall_s:
            out["tokens_per_sec"] = round(self.tokens_emitted / wall_s, 3)
            # the share of the run the host spent blocked on the device
            out["horizon_wait_frac"] = round(self.horizon_wait_s / wall_s, 4)
        return out
