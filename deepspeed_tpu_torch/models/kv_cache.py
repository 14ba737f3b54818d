"""Attention over the serving caches, shared by the port's models.

The JAX package repeats these branches in ``models/llama.py`` and
``models/gpt2.py``; here both models call them.  Caches are dicts of
tensors updated IN PLACE (the JAX models returned new arrays): a dense
layer dict carries ``k`` / ``v`` buffers [b, max_len, kv_heads, d] and a
Python ``index``; a paged layer carries the pools of ``ops/quant/kv.py``
(whose last page is the drop sink): two float leaves, or four when the
pool is quantized (int8 / fp8 payload plus per-row scale pools), beside
the ``page_table`` and one of ``slot`` / ``n_valid`` (chunked prefill of
one slot), ``widths`` (speculative verify) or ``active``
(continuous-batch decode).  Over float pools attention runs in the
pools' dtype (the query is cast to it); over quantized pools in the
query's dtype, to which K/V dequantize.  ``extra`` is an additive fp32
term over the keys, [1, heads, 1, keys] (ALiBi).
"""

import torch

from deepspeed_tpu_torch.ops.attention.decode import (decode_attention,
                                                      paged_decode_attention)
from deepspeed_tpu_torch.ops.quant.kv import (paged_gather,
                                              paged_pool_layer, paged_write,
                                              sink_page)


def cache_bias(k_len, positions, window=0, extra=None):
    """Additive fp32 bias [b, 1 or heads, l, k_len]: key j is visible to a
    query at absolute position p iff j <= p (and j > p - window for a
    local layer), plus ``extra``."""
    k_pos = torch.arange(k_len, device=positions.device)[None, None, :]
    mask = k_pos <= positions[:, :, None]
    if window > 0:
        mask &= k_pos > positions[:, :, None] - window
    bias = torch.where(mask, 0.0, torch.finfo(torch.float32).min)[:, None]
    return bias if extra is None else bias + extra


def dense_cache_attention(q, k, v, cache, positions, window=0, extra=None):
    """Append k/v at ``cache["index"]`` and attend over the buffer (one
    query token on a CUDA tensor: ``decode_fwd``).  Returns (out, the
    layer's new cache dict)."""
    index, l = cache["index"], q.shape[1]
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, index:index + l] = k.to(k_cache.dtype)
    v_cache[:, index:index + l] = v.to(v_cache.dtype)
    bias = cache_bias(k_cache.shape[1], positions, window, extra)
    # q may be a view of a fused projection: the kernel takes it
    # contiguous
    out = decode_attention(q.to(k_cache.dtype).contiguous(), k_cache,
                           v_cache, bias=bias)
    return out, {"k": k_cache, "v": v_cache, "index": index + l}


def paged_cache_attention(q, k, v, positions, cache, extra=None):
    """The three paged branches (module docstring); returns the attention
    output [b, l, heads, d]."""
    b, l = q.shape[:2]
    pt = cache["page_table"]
    ps, max_pages = cache["k_pages"].shape[1], pt.shape[1]
    attn_dtype = q.dtype if "k_scale" in cache else cache["k_pages"].dtype
    q = q.to(attn_dtype).contiguous()
    sink = sink_page(cache)
    if "slot" in cache:                  # chunked prefill (b == 1)
        slot, n_valid = cache["slot"], cache["n_valid"]
        pos = positions[0]
        valid = torch.arange(l, device=q.device) < n_valid
        # padded rows past n_valid land in the sink; their table index is
        # clamped (JAX clamps out-of-range gathers)
        page_ids = torch.where(
            valid, pt[slot, (pos // ps).clamp(max=max_pages - 1)], sink)
        paged_write(cache, page_ids, pos % ps, k[0], v[0])
        k_slot, v_slot = paged_gather(cache, pt[slot][None], attn_dtype)
        return decode_attention(
            q, k_slot, v_slot,
            bias=cache_bias(max_pages * ps, positions, extra=extra))
    if "widths" in cache:                # speculative verify (l == K+1)
        # column j of slot s writes position lengths[s] + j when
        # j < widths[s] (0 for inactive slots); the rest land in the sink,
        # their table index clamped.  Every column then attends causally
        # over the slot's gathered pages: K+1 query rows take the plain
        # attention, as in the JAX package (models/llama.py:167-187 there)
        write = torch.arange(l, device=q.device)[None, :] < \
            cache["widths"][:, None]
        rows = torch.arange(b, device=q.device)[:, None]
        page_ids = torch.where(
            write, pt[rows, (positions // ps).clamp(max=max_pages - 1)],
            sink)
        paged_write(cache, page_ids, positions % ps, k, v)
        k_all, v_all = paged_gather(cache, pt, attn_dtype)
        return decode_attention(
            q, k_all, v_all,
            bias=cache_bias(max_pages * ps, positions, extra=extra))
    pos = positions[:, 0]                # continuous-batch decode (l == 1)
    rows = torch.arange(b, device=q.device)
    page_ids = torch.where(
        cache["active"], pt[rows, (pos // ps).clamp(max=max_pages - 1)],
        sink)
    paged_write(cache, page_ids, pos % ps, k[:, 0], v[:, 0])
    return paged_decode_attention(
        q, cache["k_pages"], cache["v_pages"], pt, pos,
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        bias=extra)


def init_kv_cache(cfg, batch_size, max_len=None, dtype=torch.bfloat16,
                  device=None):
    """Empty dense KV cache (the ``generate()`` workspace), sized to the
    config's kv heads."""
    max_len = max_len or cfg.max_seq_len
    shape = (batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device),
                        "index": 0} for _ in range(cfg.num_layers)]}


def init_paged_kv_cache(cfg, num_pages, page_size, dtype=torch.bfloat16,
                        device=None):
    """Per-layer paged KV pools sized to the config's kv heads (GQA pools
    stay grouped through the paged kernel).  ``dtype`` is a torch float
    dtype or a quantized kv-dtype name ("int8" / "fp8": payload pools
    plus per-row f32 scale pools, ``ops/quant/kv.py``)."""
    return {"layers": [paged_pool_layer(num_pages, page_size,
                                        cfg.num_kv_heads, cfg.head_dim,
                                        dtype, device=device)
                       for _ in range(cfg.num_layers)]}
