"""Serving observability — the counters the scheduler core records
(counterpart of ``ServingMetrics`` in ``deepspeed_tpu/serving/metrics.py``).

TTFT / per-token latency / horizon-burst gaps, the per-step queue and
pool gauges, and per harvested horizon the tokens delivered and the time
the host waited on the device.  Latency samples are durations from
``time.monotonic()``.
Terminal outcomes are counted distinctly (completed / failed / shed /
cancelled).  The prefix-cache,
speculative, tenancy and memory-telemetry counters, and the monitor
event sink, come with their subsystems (ROADMAP.md Queue A).
"""

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
        }
        out["horizon_wait_s"] = round(self.horizon_wait_s, 6)
        if wall_s:
            out["tokens_per_sec"] = round(self.tokens_emitted / wall_s, 3)
            # the share of the run the host spent blocked on the device
            out["horizon_wait_frac"] = round(self.horizon_wait_s / wall_s, 4)
        return out
