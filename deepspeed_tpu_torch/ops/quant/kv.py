"""Paged KV-cache storage, float and quantized pools (counterpart of
``deepspeed_tpu/ops/quant/kv.py``).

A float pool layer holds two tensors, ``k_pages`` and ``v_pages``, of
shape ``[num_pages + 1, page_size, kv_heads, head_dim]``.  A quantized
layer (``"int8"`` or ``"fp8"`` = e4m3) holds FOUR leaves: the payload
pools in int8 / ``float8_e4m3fn`` plus ``k_scale`` / ``v_scale``
``[num_pages + 1, page_size, kv_heads, 1]`` float32 — a parallel pool
indexed by the same page ids, one scale per written KV vector (per token
row per kv head).  Numerics: symmetric absmax, ``scale = max|x| / qmax``
(127 for int8, 448 for fp8), ``q = cast(x / scale)`` (round + clip for
int8, a dtype cast for fp8), ``dequant = q * scale``, all scale math in
fp32.

The extra last page is the *drop sink*: the JAX package writes rows it
wants discarded to the out-of-range page id ``num_pages`` with
``.at[].set(mode="drop")``; ``index_put_`` has no drop mode, so here
those rows land in the sink, which no page table ever names and no read
touches.  Masking the rows away instead would need their count on the
host — a device sync per layer per decode step.  All four leaves of a
quantized layer carry the sink, and a row's payload and scale are written
with the SAME page ids, so they are atomic per row.

The pools are updated in place (JAX returned new arrays).  The
quantize-on-write and the gather-dequantize are plain tensor ops, as they
are jnp ops in the JAX package; the kernel that reads quantized pools
without dequantizing them in memory is ``paged_decode_quant_fwd``
(``ops/attention/decode.py``).  Payload pools are indexed through an
int8 view (bit-preserving): indexed writes and gathers of float8 tensors
are not supported everywhere, only the cast itself goes through
``torch.float8_e4m3fn``.
"""

import torch

from deepspeed_tpu_torch.ops.attention.decode import gather_pages

__all__ = ["KV_QUANT_DTYPES", "is_quantized_kv", "kv_dtype_name",
           "kv_storage_dtype", "kv_qmax", "quantize_kv_rows",
           "dequantize_kv_rows", "paged_pool_layer", "sink_page",
           "paged_write", "paged_gather", "kv_page_bytes", "fp8_supported"]

# accepted quantized kv_dtype spellings (the float spellings live in
# inference.engine.DTYPES); "fp8" is e4m3
KV_QUANT_DTYPES = ("int8", "fp8")

_QMAX = {"int8": 127.0, "fp8": 448.0}


def fp8_supported():
    """True when this torch build ships float8_e4m3fn."""
    return hasattr(torch, "float8_e4m3fn")


def is_quantized_kv(dtype):
    """True for the string names of quantized KV dtypes ("int8"/"fp8");
    torch dtypes and float names are the float pool path."""
    return isinstance(dtype, str) and dtype in KV_QUANT_DTYPES


def kv_qmax(name):
    return _QMAX[name]


def kv_storage_dtype(name):
    """Storage dtype for a quantized KV pool, validating runtime support."""
    if name == "int8":
        return torch.int8
    if name == "fp8":
        if not fp8_supported():
            raise ValueError(
                "kv_dtype='fp8' needs a torch build with float8_e4m3fn; "
                "this build has none — use 'int8'")
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quantized kv dtype {name!r}; "
                     f"expected one of {KV_QUANT_DTYPES}")


def _qname(storage_dtype):
    return "int8" if storage_dtype == torch.int8 else "fp8"


def kv_dtype_name(layer):
    """Canonical kv-dtype name of one pool layer dict (the live truth:
    what is allocated, not what was configured)."""
    dt = layer["k_pages"].dtype
    if "k_scale" in layer:
        return _qname(dt)
    return str(dt).replace("torch.", "")


def quantize_kv_rows(x, name):
    """Per-row symmetric quantization of KV vectors: ``x [..., d]`` ->
    ``(q [..., d] storage-dtype, scale [..., 1] f32)``."""
    qmax = _QMAX[name]
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax, 1.0)
    y = xf / scale
    if name == "int8":
        q = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        q = y.to(kv_storage_dtype(name))
    return q, scale


def dequantize_kv_rows(q, scale, dtype):
    """``q [..., d] * scale [..., 1]`` -> ``[..., d]`` in ``dtype``."""
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def paged_pool_layer(num_pages, page_size, kv_heads, head_dim, dtype,
                     device=None):
    """One layer's pool leaves (``num_pages`` usable pages + the sink):
    two float pools, or four leaves (int8/fp8 payload + f32 scale pools)
    when ``dtype`` is a quantized kv-dtype name."""
    shape = (num_pages + 1, page_size, kv_heads, head_dim)
    if not is_quantized_kv(dtype):
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    st = kv_storage_dtype(dtype)
    scale_shape = shape[:3] + (1,)
    return {"k_pages": torch.zeros(shape, dtype=st, device=device),
            "v_pages": torch.zeros(shape, dtype=st, device=device),
            "k_scale": torch.zeros(scale_shape, dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(scale_shape, dtype=torch.float32,
                                   device=device)}


def sink_page(layer):
    """The page id whose writes are dropped (== the JAX ``num_pages``)."""
    return layer["k_pages"].shape[0] - 1


def paged_write(layer, page_ids, offsets, k_new, v_new):
    """Write K/V rows through the page table, in place, quantizing iff
    the layer carries scale pools.  ``page_ids`` / ``offsets`` have any
    index shape X; ``k_new``/``v_new`` are ``X + (kv_heads, head_dim)``.
    Rows whose page id is the sink are dropped; a row's payload and
    scale go to the same ids.  Returns ``layer``."""
    k_pages, v_pages = layer["k_pages"], layer["v_pages"]
    if "k_scale" not in layer:
        k_pages[page_ids, offsets] = k_new.to(k_pages.dtype)
        v_pages[page_ids, offsets] = v_new.to(v_pages.dtype)
        return layer
    name = _qname(k_pages.dtype)
    for new, pages, scales in ((k_new, k_pages, layer["k_scale"]),
                               (v_new, v_pages, layer["v_scale"])):
        q, s = quantize_kv_rows(new, name)
        pages.view(torch.int8)[page_ids, offsets] = q.view(torch.int8)
        scales[page_ids, offsets] = s
    return layer


def paged_gather(pools, page_table, dtype):
    """Per-slot contiguous K/V buffers ``[slots, max_pages * page_size,
    kv_heads, head_dim]`` gathered through the page table, in ``dtype``;
    quantized pools gather payload AND scales (the scales ride the same
    page ids) and dequantize."""
    if "k_scale" not in pools:
        return (gather_pages(pools["k_pages"], page_table).to(dtype),
                gather_pages(pools["v_pages"], page_table).to(dtype))
    out = []
    for pages, scales in ((pools["k_pages"], pools["k_scale"]),
                          (pools["v_pages"], pools["v_scale"])):
        q = gather_pages(pages.view(torch.int8), page_table).view(pages.dtype)
        out.append(dequantize_kv_rows(q, gather_pages(scales, page_table),
                                      dtype))
    return tuple(out)


def kv_page_bytes(num_layers, kv_heads, head_dim, page_size, dtype):
    """Exact bytes one KV page costs across ALL layers (K + V payload
    plus, for quantized dtypes, the f32 scale rows); the sink page is one
    such page of fixed overhead per pool."""
    if is_quantized_kv(dtype):
        per_row = head_dim * kv_storage_dtype(dtype).itemsize + 4
    elif isinstance(dtype, str):
        raise ValueError(f"unknown kv dtype {dtype!r}; pass a torch dtype "
                         f"or one of {KV_QUANT_DTYPES}")
    else:
        per_row = head_dim * dtype.itemsize
    return 2 * int(num_layers) * int(page_size) * int(kv_heads) * per_row
