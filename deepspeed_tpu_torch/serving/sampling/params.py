"""Per-request decoding-policy parameters — the port's own copy of
``deepspeed_tpu/serving/sampling/params.py`` (numpy only).

:class:`SamplingParams` is the host-side description of ONE request's
decoding policy: greedy/sampled, temperature, top-k, top-p, and the
three history penalties (repetition / presence / frequency over the
request's prompt+output token counts).  It is deliberately a plain
value object — the device never sees it.  At dispatch the scheduler
*stages* every running request's params into per-slot device arrays
(one f32/i32 lane per knob), so a mixed greedy/sampled/penalized batch
runs through ONE captured graph per horizon/K bucket: the params are
graph inputs, never baked into a capture.

The staged no-op encodings are part of the contract (the pipeline's
identity guarantees key on them):

* greedy            -> ``temperature = 0.0`` (do_sample folds in)
* top-k off         -> ``top_k = 0``
* top-p off         -> ``top_p = 1.0``
* penalties off     -> ``repetition=1.0, presence=0.0, frequency=0.0``

A request whose params are all no-ops and that carries no grammar
constraint rides the greedy ``decode_multi`` / ``verify_multi`` bodies
untouched (token-exact, capture-count-exact against greedy serving).
"""

import numpy as np

_WIRE_KEYS = ("do_sample", "temperature", "top_k", "top_p",
              "repetition_penalty", "presence_penalty",
              "frequency_penalty")


class SamplingParams:
    """One request's decoding policy (see module docstring)."""

    __slots__ = _WIRE_KEYS

    def __init__(self, do_sample=False, temperature=1.0, top_k=0,
                 top_p=1.0, repetition_penalty=1.0, presence_penalty=0.0,
                 frequency_penalty=0.0):
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.repetition_penalty = float(repetition_penalty)
        self.presence_penalty = float(presence_penalty)
        self.frequency_penalty = float(frequency_penalty)
        self.validate()

    # ------------------------------------------------------ validation
    def validate(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.repetition_penalty <= 0:
            raise ValueError(f"repetition_penalty must be > 0, "
                             f"got {self.repetition_penalty}")

    # ------------------------------------------------------ properties
    @property
    def is_greedy(self):
        """THE greedy contract: ``do_sample=False`` OR ``temperature ==
        0`` is deterministic fp32 argmax, ties to the lowest id."""
        return not self.do_sample or self.temperature == 0.0

    @property
    def has_penalties(self):
        return (self.repetition_penalty != 1.0 or
                self.presence_penalty != 0.0 or
                self.frequency_penalty != 0.0)

    @property
    def needs_policy(self):
        """True when this request cannot ride the legacy greedy
        signature: it samples, or penalizes its history."""
        return not self.is_greedy or self.has_penalties

    # ----------------------------------------------------- staging
    @property
    def staged_temperature(self):
        """The per-slot temperature lane: 0.0 IS the greedy encoding
        (the device pipeline treats ``temp <= 0`` as argmax)."""
        return 0.0 if self.is_greedy else self.temperature

    # ---------------------------------------------------------- wire
    def to_dict(self):
        return {k: getattr(self, k) for k in _WIRE_KEYS}

    @classmethod
    def from_dict(cls, d, defaults=None):
        """Build from a wire dict (unknown keys rejected — a typo'd
        knob silently ignored would serve an unintended policy).
        ``defaults`` (a SamplingParams) fills the omitted keys."""
        if d is None:
            return defaults if defaults is not None else cls()
        if isinstance(d, SamplingParams):
            return d
        unknown = set(d) - set(_WIRE_KEYS)
        if unknown:
            raise ValueError(f"unknown sampling params: {sorted(unknown)}"
                             f"; valid: {list(_WIRE_KEYS)}")
        base = defaults.to_dict() if defaults is not None else {}
        base.update(d)
        return cls(**base)

    def label(self):
        if self.is_greedy and not self.has_penalties:
            return "greedy"
        parts = []
        if not self.is_greedy:
            parts.append(f"T={self.temperature:g}")
            if self.top_k:
                parts.append(f"k={self.top_k}")
            if self.top_p < 1.0:
                parts.append(f"p={self.top_p:g}")
        if self.repetition_penalty != 1.0:
            parts.append(f"rep={self.repetition_penalty:g}")
        if self.presence_penalty != 0.0:
            parts.append(f"pres={self.presence_penalty:g}")
        if self.frequency_penalty != 0.0:
            parts.append(f"freq={self.frequency_penalty:g}")
        return ",".join(parts) or "greedy"

    def __repr__(self):
        return f"SamplingParams({self.label()})"

    def __eq__(self, other):
        return isinstance(other, SamplingParams) and \
            self.to_dict() == other.to_dict()


GREEDY = SamplingParams()


def request_key(seed):
    """The per-request PRNG key as raw threefry key data (host-side,
    no device op): the threefry key of ``seed``, the uint32 pair
    ``[seed >> 32, seed & 0xffffffff]`` (``sampling/prng.py``).  Token ``n`` of the request is
    drawn from ``fold_in(key, sample_offset + n)`` — position-keyed, so
    replay after preemption or replica failover redraws NOTHING (served
    tokens are folded into the prompt) and the continuation is
    reproducible on any replica holding the same params."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    dtype=np.uint32)
