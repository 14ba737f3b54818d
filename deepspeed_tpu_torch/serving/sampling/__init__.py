"""Decoding-policy subsystem (counterpart of
``deepspeed_tpu/serving/sampling``): the per-slot on-device logit
pipeline, lossless speculative sampling and grammar-constrained
generation.

* :mod:`params`   — per-request :class:`SamplingParams` and the staged
  per-slot no-op encodings that keep mixed batches on one captured graph
  per horizon / K bucket.
* :mod:`pipeline` — the processor chain (grammar mask -> penalties ->
  temperature -> top-k -> top-p -> sample) and leftover-probability
  rejection sampling for speculative verification, on torch tensors.
* :mod:`prng`     — threefry-2x32, bit for bit ``jax.random``'s
  partitionable stream, so the port draws the JAX package's tokens.
* :mod:`grammar`  — host-compiled regex / JSON-schema -> char DFA ->
  per-state token bitmask, with replayable per-request cursors.
"""

from deepspeed_tpu_torch.serving.sampling.grammar import (  # noqa: F401
    CharDFA, GrammarConstraint, GrammarConstraintError, RegexError,
    TokenDFA, byte_vocab, compile_grammar, json_schema_to_regex,
    json_value_regex)
from deepspeed_tpu_torch.serving.sampling.params import (  # noqa: F401
    GREEDY, SamplingParams, request_key)
from deepspeed_tpu_torch.serving.sampling.pipeline import (  # noqa: F401
    accept_or_resample, bonus_sample, fold_keys, process_logits,
    sample_processed)

__all__ = [
    "SamplingParams", "GREEDY", "request_key",
    "process_logits", "sample_processed", "accept_or_resample",
    "bonus_sample", "fold_keys",
    "CharDFA", "TokenDFA", "GrammarConstraint", "GrammarConstraintError",
    "RegexError", "byte_vocab", "compile_grammar", "json_schema_to_regex",
    "json_value_regex",
]
