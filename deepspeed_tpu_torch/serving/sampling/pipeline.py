"""On-device per-slot logit pipeline — the port's counterpart of
``deepspeed_tpu/serving/sampling/pipeline.py``, in torch.

Every function here is a plain function of device tensors with no host
sync, so it runs inside the engine's CUDA-graph bodies
(``decode_multi_policy`` / ``verify_multi_policy``) and the
prefill-boundary sampler.  Policy parameters are per-slot TENSORS, never
Python values baked into a capture: a mixed greedy / sampled / penalized
/ grammar-constrained batch replays one graph per horizon / K bucket,
and a new temperature or top-p never captures again.

Processor chain order (the JAX package's contract):

    fp32 cast -> grammar mask -> repetition/presence/frequency penalties
              -> temperature -> top-k -> top-p
              -> sample (argmax where temp == 0, else categorical)

The grammar mask applies first so that top-k / top-p truncate within
the allowed lanes; sort order puts -inf lanes past every finite lane and
the cutoff always keeps the top lane, so a masked row never loses its
last allowed token.

No-op encodings leave untouched rows bit-exact: ``temp=0`` (greedy),
``top_k=0``, ``top_p=1.0``, ``rep=1.0``, ``pres=0.0``, ``freq=0.0``,
``mask=all-True``.  Each gate is a ``torch.where`` on the original lane,
so a greedy row's logits pass the whole chain unchanged and its argmax
ties to the lowest token id (``torch.argmax`` returns the first maximal
index), the greedy contract of ``decode_multi``.

Top-p: sort descending, softmax, cumsum, ``cutoff_idx = sum(cum <
top_p)`` (the smallest set whose mass reaches top_p; the boundary token
is kept), then drop every lane strictly below the cutoff logit, so ties
at the cutoff are all kept.

PRNG: each slot carries a threefry key (``sampling/prng.py``, a
``[slots, 2]`` tensor) and an absolute token index; token ``n`` draws
from ``fold_in(key, n)``, bit for bit the JAX package's stream, so the
stream does not depend on batching, chaining, preemption or the horizon.
"""

import torch

from deepspeed_tpu_torch.serving.sampling import prng

NEG_INF = float("-inf")


def fold_keys(keys, idx):
    """Per-slot ``fold_in``: keys [slots, 2], idx an int or [slots]
    integer tensor -> folded keys [slots, 2]."""
    return prng.fold_in(keys, idx)


def softmax(x):
    """``jax.nn.softmax``'s arithmetic: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _take(x, idx):
    return torch.gather(x, -1, idx.long()[:, None])[:, 0]


def process_logits(logits, counts, mask, temps, top_ks, top_ps,
                   rep_pens, pres_pens, freq_pens):
    """The full per-slot processor chain; fp32 logits ready for argmax /
    categorical.

    logits  [slots, vocab]  any float dtype (cast to fp32 here)
    counts  [slots, vocab]  int32   prompt + output token counts
    mask    [slots, vocab]  bool    grammar allowed-token mask
    temps / top_ps / rep_pens / pres_pens / freq_pens [slots] float32
    top_ks  [slots] int32
    """
    x = logits.float()
    vocab = x.shape[-1]
    x = torch.where(mask, x, NEG_INF)
    seen = counts > 0
    # repetition penalty (CTRL): divide positive logits, multiply
    # negative ones, on tokens present in prompt + output
    rp = rep_pens[:, None]
    penalized = torch.where(x > 0, x / rp, x * rp)
    x = torch.where(seen & (rp != 1.0), penalized, x)
    # presence / frequency penalties (OpenAI semantics)
    x = x - pres_pens[:, None] * seen.float()
    x = x - freq_pens[:, None] * counts.float()
    # temperature; 0 encodes greedy (the lane stays as it is)
    t = temps[:, None]
    x = torch.where(t > 0, x / torch.where(t > 0, t, 1.0), x)
    # top-k, k <= 0 is the no-op
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    k = top_ks.clamp(0, vocab)
    kth = _take(sorted_desc, (k - 1).clamp(min=0))[:, None]
    x = torch.where((k > 0)[:, None] & (x < kth), NEG_INF, x)
    # top-p over the post-top-k distribution
    sorted_p = torch.sort(x, dim=-1, descending=True).values
    cum = torch.cumsum(softmax(sorted_p), dim=-1)
    cutoff_idx = (cum < top_ps[:, None]).sum(dim=-1)
    cutoff = _take(sorted_p, cutoff_idx.clamp(max=vocab - 1))[:, None]
    return torch.where((top_ps < 1.0)[:, None] & (x < cutoff), NEG_INF, x)


def sample_processed(x, keys, tok_idx, temps):
    """One token per slot from processed fp32 logits: greedy rows
    (``temps <= 0``) take the argmax (ties to the lowest id), sampled
    rows draw ``categorical(fold_in(key, tok_idx))``."""
    sampled = prng.categorical(fold_keys(keys, tok_idx), x)
    greedy = torch.argmax(x, dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled)


def accept_or_resample(x, draft, keys, tok_idx, temps):
    """One column of lossless speculative verification.  The drafters
    propose point masses (``p_draft(d) = 1``), so leftover-probability
    rejection sampling accepts ``d`` with probability ``p_target(d)``
    and on rejection resamples the residual (``p_target`` with ``d``
    zeroed, renormalized), which reproduces ``p_target`` exactly for
    any proposal.  Greedy rows keep the token-exact rule: accept iff
    ``argmax == d``, and the correction is the argmax.

    The two draws come from sub-folds of the position key:
    ``fold_in(fold_in(key, n), 0)`` for the accept uniform, ``(.., 1)``
    for the resample.  Returns ``(accept [slots] bool, fallback [slots]
    int32)``."""
    kcol = fold_keys(keys, tok_idx)
    ku = fold_keys(kcol, 0)
    kr = fold_keys(kcol, 1)
    p_draft_tok = _take(softmax(x), draft)
    u = prng.uniform(ku)
    greedy_tok = torch.argmax(x, dim=-1)
    greedy_row = temps <= 0.0
    accept = torch.where(greedy_row, greedy_tok == draft, u < p_draft_tok)
    lane = torch.arange(x.shape[-1], device=x.device)
    x_res = torch.where(lane[None, :] == draft.long()[:, None], NEG_INF, x)
    resampled = prng.categorical(kr, x_res)
    fallback = torch.where(greedy_row, greedy_tok, resampled)
    return accept, fallback.to(torch.int32)


def bonus_sample(x, keys, tok_idx, temps):
    """The bonus column (every draft accepted): the next token from the
    full target distribution, on the ``fold_in(key, n)`` stream the
    horizon would have drawn it from."""
    return sample_processed(x, keys, tok_idx, temps).to(torch.int32)
