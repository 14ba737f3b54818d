"""Single-token decode attention over dense and paged KV caches
(counterpart of ``deepspeed_tpu/ops/attention/decode.py``).

Three entry points of one hand-written CUDA kernel body for Hopper live
in ``csrc/decode_attention.cu`` (its header note names the TPU kernels
they replace, their bound and the design): ``paged_decode_fwd`` (paged
MHA, GQA and MQA, any group), ``paged_decode_quant_fwd`` (the same over
int8 / fp8 pools with per-row scale pools, dequantized in shared memory)
and ``decode_fwd`` (a dense cache + an additive bias: the kernel's dense
walk).  Each sequence's keys are cut into splits of whole 64-key tiles
(:func:`pages_per_split` for the paged pools, :func:`dense_split_keys`
for a dense cache) walked by blocks of their own and merged in split
order inside the same launch (the splits of a sequence are one thread
block cluster).  Each public function here has a plain PyTorch version
beside it.

The dispatch rule is the tensor's device: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises — there is no
fallback from the card to the plain version, and the TPU-only
``page_size % 128`` gate does not carry over (any page size works).
Each wrapper counts its launches (:func:`launch_counts`) so a run can
show that the main path went through the kernels.
"""

import torch

from deepspeed_tpu_torch.ops.attention.reference import mha_reference
from deepspeed_tpu_torch.ops.launch_counter import LaunchCounter

NEG_INF = -1e30   # masked-score floor, as ops/attention/flash.py:42

_LAUNCHES = LaunchCounter("paged_decode_fwd", "paged_decode_quant_fwd",
                          "decode_fwd")
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_QUANT_STORAGE = {torch.int8: 1}          # + float8_e4m3fn: 2, where built
if hasattr(torch, "float8_e4m3fn"):
    _QUANT_STORAGE[torch.float8_e4m3fn] = 2
MAX_HEAD_DIM = 256
SPLIT_KEYS = 64        # keys per split, at least: one tile of the kernel
MAX_SPLITS = 4         # splits of a sequence: one thread block cluster


def launch_counts(dtype=None):
    """Kernel launches since the last :func:`reset_launch_counts`
    (CUDA-graph replays included, ``ops/launch_counter.py``); with
    ``dtype``, those of that compute dtype's instantiation."""
    return _LAUNCHES.counts(dtype)


def reset_launch_counts():
    _LAUNCHES.reset()


def pages_per_split(page_size, max_pages):
    """Pages per split of the paged kernels: the fewest whole pages that
    hold :data:`SPLIT_KEYS` keys, more where the page table's width
    (``max_pages``) would otherwise give over :data:`MAX_SPLITS` splits
    (a slot's splits merge inside one thread block cluster).  It depends
    on the page size and the table's width, never on the batch or the
    positions, so a slot's output bits do not depend on the batch."""
    return max(-(-SPLIT_KEYS // page_size), -(-max_pages // MAX_SPLITS))


def dense_split_keys(max_len):
    """Keys per split of the dense walk (``decode_fwd``): whole
    :data:`SPLIT_KEYS`-key tiles, the fewest that give at most
    :data:`MAX_SPLITS` splits of ``max_len`` keys.  It depends on the
    cache's length alone — never on the batch, the bias or a position —
    so a sequence's output bits do not depend on the batch and the call
    is CUDA-graph safe."""
    tiles = -(-max(1, max_len) // SPLIT_KEYS)
    return -(-tiles // MAX_SPLITS) * SPLIT_KEYS


def _lib():
    from deepspeed_tpu_torch.ops.op_builder import DecodeAttentionBuilder
    return DecodeAttentionBuilder().load()


def _repeat_kv(x, n_rep):
    """[b, l, kv_h, d] -> [b, l, kv_h * n_rep, d]; query head
    ``kv * n_rep + r`` reads kv head ``kv``."""
    if n_rep == 1:
        return x
    b, l, h, d = x.shape
    return x[:, :, :, None].expand(b, l, h, n_rep, d).reshape(
        b, l, h * n_rep, d)


def gather_pages(pages, page_table):
    """[num_pages, page_size, kv_h, d] gathered through [slots, maxp] ->
    [slots, maxp * page_size, kv_h, d].  Unallocated table entries point
    at page 0; the caller's validity mask covers those positions."""
    g = pages[page_table]
    s, mp, ps, h, d = g.shape
    return g.reshape(s, mp * ps, h, d)


def paged_kernel_decision(*, device_type, num_heads, num_kv_heads,
                          head_dim, dtype=None, storage_dtype=None,
                          has_bias=False):
    """The paged-attention dispatch rule, as data: ``{"path": "kernel" |
    "reference" | "unsupported", "reason": str}``.  A CPU tensor runs
    the plain version; a CUDA tensor runs the kernel when its shapes
    and dtypes fit, and is otherwise refused (``"unsupported"`` — the
    caller raises; it never falls back).  ``dtype`` is the compute dtype
    (the query's); ``storage_dtype`` the pools' payload dtype when it
    differs (int8 / float8_e4m3fn of a quantized pool).  Every group
    (``num_heads / num_kv_heads``, MQA included) runs.  The kernels
    load 16 bytes per thread, so ``head_dim`` must be a whole number of
    16-byte loads of the STORAGE dtype: a multiple of 8 for 2- and
    4-byte elements, of 16 for a 1-byte payload.

    ``has_bias`` (an additive bias such as ALiBi) takes the JAX route
    (``deepspeed_tpu/ops/attention/decode.py:542-545``, ``:730-746``):
    the slots' pages are gathered into contiguous buffers, dequantized
    to the compute dtype where the pool is quantized, and the dense
    kernel ``decode_fwd`` attends over them with the bias; the paged
    kernels compute only the positional mask.  The load rule is then
    the compute dtype's."""
    if device_type == "cpu":
        return {"path": "reference",
                "reason": "CPU tensors run the plain PyTorch version"}
    if device_type != "cuda":
        return {"path": "unsupported",
                "reason": f"no decode kernel for device {device_type!r}"}
    group = num_heads // num_kv_heads if num_kv_heads else 0
    quantized = storage_dtype is not None and storage_dtype != dtype
    # elements in one 16-byte load of the type the kernel reads
    per_load = 16 if quantized and not has_bias else 8
    if not num_kv_heads or num_heads % num_kv_heads:
        reason = (f"num_heads={num_heads} is not a multiple of "
                  f"num_kv_heads={num_kv_heads}")
    elif quantized and storage_dtype not in _QUANT_STORAGE:
        reason = (f"storage dtype {storage_dtype} (quantized pools hold "
                  "int8 or float8_e4m3fn)")
    elif head_dim % per_load or head_dim > MAX_HEAD_DIM:
        reason = (f"head_dim={head_dim} must be a multiple of {per_load} "
                  + ("(16-byte loads of a 1-byte payload) "
                     if per_load == 16 else "") +
                  f"and at most {MAX_HEAD_DIM}")
    elif dtype is not None and dtype not in _KERNEL_DTYPES:
        reason = (f"dtype {dtype} (the kernels take float32, bfloat16 "
                  "and float16)")
    elif has_bias:
        pools = "dequantized " if quantized else ""
        return {"path": "kernel",
                "reason": "CUDA tensor with an additive bias (ALiBi): the "
                          f"slots' pages gathered {pools}into contiguous "
                          "buffers, then the hand-written dense kernel "
                          f"decode_fwd, group {group}"}
    else:
        what = "quantized-pool kernel" if quantized else "kernel"
        return {"path": "kernel",
                "reason": f"CUDA tensor: hand-written {what}, group {group}"}
    return {"path": "unsupported", "reason": "decode kernel: " + reason}


def _check_cuda(name, q, k, v, *extra):
    """Device, contiguity and 16-byte alignment of q/k/v (the kernels
    load 16 bytes per thread) and one dtype for k and v; ``extra``
    tensors: device and contiguity."""
    for t in (q, k, v, *extra):
        if t.device != q.device:
            raise ValueError(f"{name}: every tensor must be on {q.device}, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if k.dtype != v.dtype:
        raise ValueError(f"{name}: k/v dtypes differ ({k.dtype} vs "
                         f"{v.dtype})")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: q/k/v must be 16-byte aligned")


def _raise_if_failed(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ---------------------------------------------------------------- paged


def _gathered(q, k_pages, v_pages, page_table, positions, k_scale, v_scale,
              bias):
    """Each slot's pages gathered into contiguous ``[slots, max_pages *
    page_size, kv_heads, d]`` buffers (a quantized pool's payload and
    scales dequantized to ``q.dtype``) and the additive fp32 bias over
    them: keys past the position masked, plus ``bias`` when given — the
    JAX gather path (``decode.py:730-746``)."""
    page_table = page_table.long()
    if k_scale is not None:
        from deepspeed_tpu_torch.ops.quant.kv import paged_gather
        k_full, v_full = paged_gather(
            {"k_pages": k_pages, "v_pages": v_pages, "k_scale": k_scale,
             "v_scale": v_scale}, page_table, q.dtype)
    else:
        k_full = gather_pages(k_pages, page_table)
        v_full = gather_pages(v_pages, page_table)
    k_pos = torch.arange(k_full.shape[1], device=q.device)
    mask = k_pos[None, None, None, :] <= positions.long()[:, None, None, None]
    full_bias = torch.where(mask, 0.0, torch.finfo(torch.float32).min)
    if bias is not None:
        full_bias = full_bias + bias.float()
    return k_full, v_full, full_bias


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, positions,
                                 *, scale=None, k_scale=None, v_scale=None,
                                 bias=None):
    """Plain version of :func:`paged_decode_attention`: gather each
    slot's pages into a contiguous buffer (a quantized pool's payload
    and scales, dequantized to ``q.dtype``), mask keys past the
    position, add ``bias``, and run the dense plain attention — the JAX
    gather fallback (``decode.py:730-746``)."""
    k_full, v_full, full_bias = _gathered(q, k_pages, v_pages, page_table,
                                          positions, k_scale, v_scale, bias)
    return decode_attention_plain(q, k_full, v_full, bias=full_bias,
                                  scale=scale)


def paged_decode_attention(q, k_pages, v_pages, page_table, positions, *,
                           scale=None, k_scale=None, v_scale=None,
                           bias=None):
    """Attention of ``q`` [slots, 1, heads, d] over a paged cache: pools
    ``k_pages``/``v_pages`` [num_pages, page_size, kv_heads, d] read
    through ``page_table`` [slots, max_pages]; keys at positions
    ``<= positions[slot]`` are live (the current token's K/V must already
    be written).  ``k_scale``/``v_scale`` ([num_pages, page_size,
    kv_heads, 1] f32) mark a QUANTIZED pool (int8 / fp8 payload,
    ``ops/quant/kv.py``): a CUDA tensor then launches
    ``paged_decode_quant_fwd``, which dequantizes to ``q.dtype`` in
    shared memory.  ``bias`` (broadcastable to [slots, heads, 1,
    max_pages * page_size], e.g. ALiBi) is an extra additive term: as in
    the JAX package the slots' pages are then gathered (and dequantized)
    into contiguous buffers and a CUDA tensor launches the dense kernel
    ``decode_fwd`` over them (:func:`paged_kernel_decision`).  Returns
    [slots, 1, heads, d]."""
    slots, l, h, d = q.shape
    if l != 1:
        raise ValueError(f"paged decode takes one query token, got {l}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("paged_decode_attention: k_scale and v_scale come "
                         "together")
    decision = paged_kernel_decision(
        device_type=q.device.type, num_heads=h,
        num_kv_heads=k_pages.shape[2], head_dim=d, dtype=q.dtype,
        storage_dtype=k_pages.dtype if quantized else None,
        has_bias=bias is not None)
    if decision["path"] == "reference":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, positions, scale=scale,
            k_scale=k_scale, v_scale=v_scale, bias=bias)
    if decision["path"] != "kernel":
        raise ValueError(decision["reason"])
    if not quantized and k_pages.dtype != q.dtype:
        raise ValueError(f"paged_decode_attention: q is {q.dtype} but the "
                         f"float pools hold {k_pages.dtype}")
    if bias is not None:
        k_full, v_full, full_bias = _gathered(
            q, k_pages, v_pages, page_table, positions, k_scale, v_scale,
            bias)
        return decode_attention(q, k_full, v_full, bias=full_bias,
                                scale=scale)
    page_table = page_table.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    scales = (k_scale, v_scale) if quantized else ()
    _check_cuda("paged_decode_attention", q, k_pages, v_pages, page_table,
                positions, *scales)
    num_pages, page_size, kv_h, _ = k_pages.shape
    if v_pages.shape != k_pages.shape or page_table.shape[0] != slots or \
            positions.shape != (slots,):
        raise ValueError("paged_decode_attention: inconsistent shapes "
                         f"q {tuple(q.shape)} pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} table "
                         f"{tuple(page_table.shape)} positions "
                         f"{tuple(positions.shape)}")
    if num_pages * page_size >= 2 ** 31:
        raise ValueError("paged_decode_attention: the kernels index pool "
                         "rows with int32: num_pages * page_size must be "
                         f"below 2**31, got {num_pages} x {page_size}")
    for t in scales:
        if t.shape != (num_pages, page_size, kv_h, 1) or \
                t.dtype != torch.float32:
            raise ValueError("paged_decode_attention: a scale pool must be "
                             f"float32 {(num_pages, page_size, kv_h, 1)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    out = torch.empty_like(q)
    if slots == 0:
        return out
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    max_pages = page_table.shape[1]
    shape_args = (slots, kv_h, h // kv_h, d, page_size, max_pages,
                  pages_per_split(page_size, max_pages), scale,
                  _KERNEL_DTYPES[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if quantized:
        name = "paged_decode_quant_fwd"
        err = _lib().paged_decode_quant_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
            page_table.data_ptr(), positions.data_ptr(), *shape_args,
            _QUANT_STORAGE[k_pages.dtype], stream)
    else:
        name = "paged_decode_fwd"
        err = _lib().paged_decode_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(), page_table.data_ptr(), positions.data_ptr(),
            *shape_args, stream)
    _raise_if_failed(name, err)
    _LAUNCHES.add(name, q.dtype)
    return out


# ---------------------------------------------------------------- dense


def decode_attention_plain(q, k_cache, v_cache, *, bias, scale=None):
    """Plain version of :func:`decode_attention`: expand a grouped cache
    to the query heads and run :func:`mha_reference` with the bias."""
    h, d = q.shape[2], q.shape[3]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    rep = h // k_cache.shape[2]
    return mha_reference(q, _repeat_kv(k_cache, rep), _repeat_kv(v_cache, rep),
                         causal=False, bias=bias, scale=scale)


def decode_attention(q, k_cache, v_cache, *, bias, scale=None):
    """Attention of ``q`` [b, l, heads, d] over a cache buffer
    [b, max_len, kv_heads, d] with an additive ``bias`` broadcastable to
    [b, heads, l, max_len] carrying the validity mask.

    One query token (``l == 1``) on a CUDA tensor launches ``decode_fwd``,
    the decode kernel's dense walk: it reads a grouped cache natively
    (any group, MQA included: a block takes up to 16 query heads of a kv
    head), splits the keys by :func:`dense_split_keys` and takes the bias
    through its strides (a broadcast bias is never materialised).
    Several query tokens (prefill into a cache) run the plain attention
    on any device, as in the JAX package, where no TPU kernel serves
    that case."""
    b, l, h, d = q.shape
    kv_h, max_len = k_cache.shape[2], k_cache.shape[1]
    if l != 1 or q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, bias=bias,
                                      scale=scale)
    decision = paged_kernel_decision(
        device_type=q.device.type, num_heads=h, num_kv_heads=kv_h,
        head_dim=d, dtype=q.dtype)
    if decision["path"] != "kernel":
        raise ValueError(decision["reason"])
    bias = bias.to(torch.float32).expand(b, h, 1, max_len)
    _check_cuda("decode_attention", q, k_cache, v_cache)
    if k_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: q is {q.dtype} but the cache "
                         f"holds {k_cache.dtype}")
    if bias.device != q.device:
        raise ValueError(f"decode_attention: bias must be on {q.device}")
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != b:
        raise ValueError("decode_attention: inconsistent shapes q "
                         f"{tuple(q.shape)} caches {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)}")
    out = torch.empty_like(q)
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    sb, sh, _, sk = bias.stride()
    err = _lib().decode_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        bias.data_ptr(), sb, sh, sk, b, max_len, kv_h, h // kv_h, d,
        dense_split_keys(max_len), scale, _KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed("decode_fwd", err)
    _LAUNCHES.add("decode_fwd", q.dtype)
    return out
