"""Plain PyTorch attention (counterpart of ``deepspeed_tpu/ops/attention/reference.py``).

The correctness oracles for the hand-written kernels: the same
``[batch, len, heads, head_dim]`` layout and the same numerics as the
JAX references — fp32 logits and softmax statistics whatever the input
dtype, probabilities cast to the value dtype before the PV product.
"""

import torch


def causal_mask(q_len, k_len, dtype=torch.float32, offset=0, device=None):
    """Additive causal mask; query i attends to keys <= i + offset."""
    q_idx = torch.arange(q_len, device=device)[:, None]
    k_idx = torch.arange(k_len, device=device)[None, :]
    return torch.where(k_idx <= q_idx + offset, 0.0,
                       torch.finfo(dtype).min).to(dtype)


def mha_reference(q, k, v, *, causal=True, bias=None, scale=None):
    """Multi-head attention over ``[b, len, heads, d]`` tensors with an
    optional additive ``bias`` broadcastable to ``[b, heads, q_len, k_len]``."""
    q_len, d = q.shape[1], q.shape[3]
    k_len = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        logits = logits + causal_mask(q_len, k_len, offset=k_len - q_len,
                                      device=q.device)
    weights = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def apply_rotary_emb(x, positions, *, base=10000.0):
    """Rotary position embeddings on ``[b, len, heads, d]``, rotate-half
    convention, angles in fp32 (``deepspeed_tpu/ops/attention/reference.py:68``)."""
    half = x.shape[-1] // 2
    freq = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                        device=x.device) / half))
    angles = positions[..., None].float() * freq          # [b, l, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def apply_rotary_emb_interleaved(x, positions, *, base=10000.0):
    """GPT-J's rotate-every-two convention: the pairs are (x[2i], x[2i+1])
    instead of (x[i], x[i + half])
    (``deepspeed_tpu/ops/attention/reference.py:83``)."""
    half = x.shape[-1] // 2
    freq = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                        device=x.device) / half))
    angles = positions[..., None].float() * freq
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


def apply_partial_rotary(x, positions, rotary_dim, *, base=10000.0,
                         interleaved=False):
    """Rotary on the first ``rotary_dim`` features only (GPT-J
    ``rotary_dim``, GPT-NeoX ``rotary_pct``); the rest pass through
    (``deepspeed_tpu/ops/attention/reference.py:99``)."""
    fn = apply_rotary_emb_interleaved if interleaved else apply_rotary_emb
    return torch.cat([fn(x[..., :rotary_dim], positions, base=base),
                      x[..., rotary_dim:]], dim=-1)
