"""Flash attention, forward and backward (counterpart of
``deepspeed_tpu/ops/attention/flash.py``).

Three hand-written CUDA kernels for Hopper live in
``csrc/flash_attention.cu`` (its header note names the TPU kernels they
replace, their bound and the design): ``flash_fwd`` (o and the row
logsumexp), and the FlashAttention-2 backward pair ``flash_bwd_dq`` /
``flash_bwd_dkv``, which recompute p from the saved logsumexp.  Each has
a plain PyTorch version beside it (:func:`flash_fwd_plain`,
:func:`flash_bwd_plain`) with the same inputs, outputs and numerics.

In bf16 and fp16 all three are Hopper kernels (TMA, ``wgmma``): the backward pair
loads each block's own tiles once, keeps the tiles it walks in a TMA
ring, and makes p and ds in registers; the wrapper hands it q, k, v and
do by :func:`tma_ok`'s copy rule.  Neither kernel of the pair uses
atomics, so two runs give the same bits.

The dispatch rule is PR 1's (``decode.py``): a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises.  Block sizes are
the kernel's own choice: the JAX ``block_q`` / ``block_k`` arguments and
its ``seq % block == 0`` assert are TPU tiling, so any length works and
neither argument exists here.  Each wrapper counts its launches
(:func:`launch_counts`).

Semantics, on ``[batch, len, heads, head_dim]`` tensors: fp32 scores
``(q . k) * scale`` (``scale`` defaults to ``1/sqrt(d)``), causal query
``i`` sees keys ``j <= i + (k_len - q_len)``, masked scores are
``NEG_INF = -1e30``; a fully masked row gives ``o = 0``, ``lse =
NEG_INF`` and zero gradients; p is cast to the value dtype before P.V,
and p / ds to the operand dtype before the dV / dK / dQ products.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops.launch_counter import LaunchCounter

NEG_INF = -1e30   # masked-score floor (flash.py:42), not -inf

_LAUNCHES = LaunchCounter("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (32, 64, 128)


def launch_counts(dtype=None):
    """Kernel launches since the last :func:`reset_launch_counts`
    (CUDA-graph replays included, ``ops/launch_counter.py``); with
    ``dtype``, those of that dtype's instantiation."""
    return _LAUNCHES.counts(dtype)


def reset_launch_counts():
    _LAUNCHES.reset()


def _lib():
    from deepspeed_tpu_torch.ops.op_builder import FlashAttentionBuilder
    return FlashAttentionBuilder().load()


def _scale(scale, d):
    return float(scale) if scale is not None else 1.0 / (d ** 0.5)


def _scores(q, k, causal, scale, mask=None):
    """fp32 [b, h, lq, lk] scores with the boolean ``mask`` (broadcast to
    them; False = masked) and then the causal mask applied."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        qi = torch.arange(lq, device=q.device)[:, None]
        kj = torch.arange(lk, device=q.device)[None, :]
        s = torch.where(kj <= qi + (lk - lq), s, NEG_INF)
    return s


def _delta(o, do, dlse):
    """sum(do * o) over the head dim, minus the lse cotangent:
    [b, h, lq] fp32 (``flash.py:429-434``).  The products are taken in
    fp32 (exact for bf16 inputs) by one pass over do and o as they are:
    addcmul onto a one-element fp32 zero promotes to fp32 without fp32
    copies of either."""
    zero = torch.zeros(1, dtype=torch.float32, device=do.device)
    delta = torch.addcmul(zero, do, o).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


# ------------------------------------------------------------ plain versions


def flash_fwd_plain(q, k, v, *, causal=True, scale=None, mask=None):
    """Plain version of :func:`flash_fwd`: (o [b, lq, h, d] in q's dtype,
    lse [b, h, lq] fp32).  ``mask``: an optional boolean score mask
    broadcast to [b, h, lq, lk] (the block-sparse plain versions')."""
    scale = _scale(scale, q.shape[-1])
    s = _scores(q, k, causal, scale, mask)
    m = s.amax(-1, keepdim=True)
    live = m > NEG_INF / 2
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)                  # dead row -> zeros
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = acc / l.squeeze(-1).transpose(1, 2)[..., None]
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_bwd_plain(q, k, v, o, lse, do, dlse=None, *, causal=True,
                    scale=None, mask=None):
    """Plain version of :func:`flash_bwd`: (dq, dk, dv) in the input
    dtypes, recomputing p from ``lse`` (``_bwd_p_ds``, ``flash.py:98``)
    under the same optional ``mask`` as :func:`flash_fwd_plain`."""
    scale = _scale(scale, q.shape[-1])
    s = _scores(q, k, causal, scale, mask)
    lse = lse.float()[..., None]
    p = torch.where(lse > NEG_INF / 2, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - _delta(o, do, dlse)[..., None]) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------- kernels


def _check_cuda(name, q, k, v, *extra):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no flash kernel for device "
                         f"{q.device.type!r}")
    b, lq, h, d = q.shape
    if k.ndim != 4 or k.shape[0] != b or k.shape[2:] != (h, d) or \
            v.shape != k.shape:
        raise ValueError(f"{name}: inconsistent shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} (the kernels take "
                         "float32, bfloat16 and float16)")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim={d} (the kernels take "
                         f"{HEAD_DIMS})")
    if b * h > 65535:
        raise ValueError(f"{name}: batch * heads = {b * h} > 65535")
    for t in (k, v, *extra):
        if t.device != q.device:
            raise ValueError(f"{name}: every tensor must be on {q.device}, "
                             f"got one on {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: dtypes differ ({q.dtype} vs "
                             f"{t.dtype})")


def _rows(x):
    """``x`` with a unit head-dim stride (the kernels read rows through
    the other three strides, so split/transposed views need no copy)."""
    return x if x.stride(-1) == 1 else x.contiguous()


def tma_ok(shape, strides, data_ptr, elem_size):
    """Whether the 16-bit kernels' tensor maps read a ``[b, len, heads,
    d]`` operand with these element ``strides`` in place: TMA wants a
    16-byte aligned base, a unit head-dim stride, and for every other
    dim with more than one entry a stride that is a whole number of 16
    bytes; the map orders its dims (d, head, position, batch), so each
    such stride must also clear the extent of the dims inside it (the
    split views of a fused qkv projection do; a [b, h, l, d] tensor
    transposed to [b, l, h, d] does not)."""
    if strides[-1] != 1 or data_ptr % 16:
        return False
    inner = shape[-1]                  # elements the inner dims span
    for dim in (2, 1, 0):
        if shape[dim] == 1:
            continue
        if (strides[dim] * elem_size) % 16 or strides[dim] < inner:
            return False
        inner = strides[dim] * shape[dim]
    return True


def _tma_operands(*ts):
    """The ``[b, len, heads, d]`` operands (q, k, v, and do for the
    backward) as the kernels read them: unit head-dim strides, and for
    bf16 and fp16 (read by TMA) a contiguous copy of an operand that
    :func:`tma_ok` refuses.  A copy, not a fallback: the kernel runs."""
    ts = tuple(_rows(t) for t in ts)
    if ts[0].dtype == torch.float32:
        return ts
    return tuple(
        t if tma_ok(t.shape, t.stride(), t.data_ptr(), t.element_size())
        else t.contiguous() if not t.is_contiguous() else t.clone()
        for t in ts)


def _strides(*ts):
    flat = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * 12)(*flat, *([0] * (12 - len(flat))))


def _raise_if_failed(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def flash_fwd(q, k, v, *, causal=True, scale=None):
    """(o [b, lq, h, d], lse [b, h, lq] fp32) of ``q`` [b, lq, h, d] over
    ``k``/``v`` [b, lk, h, d]."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, scale=scale)
    _check_cuda("flash_fwd", q, k, v)
    q, k, v = _tma_operands(q, k, v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    o = torch.empty(b, lq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    if lk == 0:                        # no key: every row is dead
        return o.zero_(), lse.fill_(NEG_INF)
    strides = _strides(q, k, v)
    err = _lib().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), ctypes.addressof(strides), b, h, lq, lk, d,
        int(causal), _scale(scale, d), _KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed("flash_fwd", err)
    _LAUNCHES.add("flash_fwd", q.dtype)
    return o, lse


def _bwd_inputs(q, k, v, o, lse, do, dlse, name="flash_bwd"):
    """The backward kernels' checked inputs: (q, k, v, do) as
    :func:`_tma_operands` gives them, lse and the delta pre-pass
    ``sum(do * o) - dlse`` as contiguous fp32 [b, h, lq] (plain tensor
    code, as in the JAX package)."""
    _check_cuda(name, q, k, v, o, do)
    q, k, v, do = _tma_operands(q, k, v, do)
    b, lq, h, _ = q.shape
    lse = lse.float().contiguous()
    delta = _delta(o, do, dlse)
    if lse.shape != (b, h, lq) or delta.shape != (b, h, lq):
        raise ValueError(f"{name}: lse {tuple(lse.shape)} / delta "
                         f"{tuple(delta.shape)} must be [{b}, {h}, {lq}]")
    return q, k, v, do, lse, delta


def _launch_bwd(name, q, k, v, do, lse, delta, outs, causal, scale):
    """One backward kernel (``flash_bwd_dq`` into ``outs = (dq,)``,
    ``flash_bwd_dkv`` into ``(dk, dv)``) on :func:`_bwd_inputs`."""
    b, lq, h, d = q.shape
    strides = _strides(q, k, v, do)
    err = getattr(_lib(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
        ctypes.addressof(strides), b, h, lq, k.shape[1], d, int(causal),
        _scale(scale, d), _KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed(name, err)
    _LAUNCHES.add(name, q.dtype)


def flash_bwd(q, k, v, o, lse, do, dlse=None, *, causal=True, scale=None):
    """(dq, dk, dv) of :func:`flash_fwd` for the output cotangent ``do``
    and the (optional) logsumexp cotangent ``dlse`` [b, h, lq]: the
    delta pre-pass, then ``flash_bwd_dq`` and ``flash_bwd_dkv``."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, dlse, causal=causal,
                               scale=scale)
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, o, lse, do, dlse)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    if q.shape[1] == 0 or k.shape[1] == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    args = (q, k, v, do, lse, delta)
    _launch_bwd("flash_bwd_dq", *args, (dq,), causal, scale)
    _launch_bwd("flash_bwd_dkv", *args, (dk, dv), causal, scale)
    return dq, dk, dv


# ---------------------------------------------------------------- autograd


class FlashAttentionFn(torch.autograd.Function):
    """(o, lse) with gradients through both (the custom VJP of
    ``flash.py:502-528``): forward is :func:`flash_fwd`, backward
    :func:`flash_bwd` with the lse cotangent folded into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, dlse, causal=ctx.causal,
                               scale=ctx.scale)
        return dq, dk, dv, None, None


ATTN_IMPLS = ("auto", "reference", "flash")


def resolve_attn_impl(attn_impl, device):
    """A model's ``attn_impl`` for a tensor on ``device``: ``"auto"`` ->
    ``"flash"`` on a CUDA tensor, ``"reference"`` on a CPU one (where
    the flash path would run its plain version anyway); ``"ring"`` /
    ``"ulysses"`` (sequence parallelism) raise."""
    if attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} (sequence parallelism) is not ported "
            "to the PyTorch package yet: see ROADMAP.md Queue A10")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; pick one of "
                         f"{ATTN_IMPLS}")
    if attn_impl == "auto":
        return "flash" if device.type == "cuda" else "reference"
    return attn_impl


def flash_attention(q, k, v, *, causal=True, scale=None, with_lse=False,
                    sparsity_config=None):
    """Flash attention on ``[batch, len, heads, head_dim]`` inputs
    (``flash.py:558``): returns o, or (o, lse [b, h, q_len]) with
    ``with_lse``; differentiable in both.  ``sparsity_config``
    (``ops/sparse_attention``) routes to the block-sparse kernels
    (``block_sparse.sparse_flash_attention``), which return o alone."""
    if sparsity_config is not None:
        assert not with_lse, "with_lse is not supported on the sparse path"
        from deepspeed_tpu_torch.ops.attention.block_sparse import \
            sparse_flash_attention
        return sparse_flash_attention(q, k, v, sparsity_config,
                                      causal=causal, scale=scale)
    o, lse = FlashAttentionFn.apply(q, k, v, bool(causal), scale)
    return (o, lse) if with_lse else o


def flash_attention_with_lse(q3, k3, v3, *, causal, scale):
    """``[batch*heads, len, d]`` flash attention returning (o, lse
    [bh, len, 1]), differentiable in both (``flash.py:531``)."""
    o, lse = FlashAttentionFn.apply(q3[:, :, None], k3[:, :, None],
                                    v3[:, :, None], bool(causal), scale)
    return o[:, :, 0], lse.reshape(q3.shape[0], q3.shape[1], 1)
