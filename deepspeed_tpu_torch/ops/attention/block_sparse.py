"""Block-sparse flash attention, forward and backward (counterpart of
``deepspeed_tpu/ops/attention/block_sparse.py``).

Three hand-written CUDA kernels for Hopper live in ``csrc/block_sparse.cu``
(its header note names the TPU kernels they replace, their bound and the
design): ``sparse_fwd`` (o and the row logsumexp) and the FlashAttention-2
backward pair ``sparse_bwd_dq`` / ``sparse_bwd_dkv``.  They are the flash
tile kernels (``csrc/flash_kernels.cuh``) walking only a layout's active
blocks.  Each has a plain PyTorch version beside it
(:func:`sparse_fwd_plain`, :func:`sparse_bwd_plain`): ``flash.py``'s plain
versions with the layout expanded to a score mask.

A layout is ``[H, n, n]`` blocks of ``block`` tokens, ``H`` 1 or the
number of heads (``ops/sparse_attention/sparsity_config.py``).
:class:`SparseIndex` compiles it once into what the kernels walk: per
layout head, CSR rows of the active blocks at a tile granularity ``T =
max(64, block * factor)`` with the fine cells of each packed into bits
(:func:`build_csr`'s steps without its placeholders), the same for the
transposed layout (the dk / dv walk), and the order in which query tiles
start (heaviest rows first).  Blocks 16 and 32 run on 64-token tiles with
fine bits; a block above 64 must be a multiple of 64.  ``factor`` > 1
coarsens the walk as in the JAX package; the attention function does not
change with it.

The dispatch rule is ``flash.py``'s: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.  Semantics on ``[batch, len,
heads, head_dim]`` tensors: ``flash.py``'s, with the entries of inactive
blocks masked to ``NEG_INF`` before the causal mask; a row with no active
key gives ``o = 0``, ``lse = NEG_INF`` and zero gradients.
"""

import ctypes

import numpy as np
import torch

from deepspeed_tpu_torch.ops.attention.flash import (
    _KERNEL_DTYPES, _bwd_inputs, _check_cuda, _tma_operands,
    _raise_if_failed, _scale, _strides, flash_bwd_plain, flash_fwd_plain)
from deepspeed_tpu_torch.ops.launch_counter import LaunchCounter

_LAUNCHES = LaunchCounter("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")
TILE = 64            # the kernels' rows per tile (flash_kernels.cuh kBQ)


def launch_counts(dtype=None):
    """Kernel launches since the last :func:`reset_launch_counts`
    (CUDA-graph replays included, ``ops/launch_counter.py``); with
    ``dtype``, those of that dtype's instantiation."""
    return _LAUNCHES.counts(dtype)


def reset_launch_counts():
    _LAUNCHES.reset()


def _lib():
    from deepspeed_tpu_torch.ops.op_builder import BlockSparseAttentionBuilder
    return BlockSparseAttentionBuilder().load()


# ------------------------------------------------------------------ layouts


def _fine_bits(fine, factor):
    """``fine`` [..., n, m] bool -> int64 [..., n / factor, m / factor]:
    each coarse cell's fine cells packed row-major (bit r * factor + c),
    0 where the cell is inactive."""
    *lead, n, m = fine.shape
    cells = fine.reshape(*lead, n // factor, factor, m // factor, factor)
    weights = (1 << np.arange(factor * factor, dtype=np.int64)).reshape(
        factor, factor)
    return (cells.swapaxes(-3, -2) * weights).sum((-2, -1))


def build_csr(layout, factor=1):
    """layout [H, n_rows, n_cols] -> per-head ragged step arrays
    (``block_sparse.py:55``, bit-equal).

    Returns (row, col, first, last, run, fmask), each [H, S] int32 with
    S = max over heads of (nnz + empty-row placeholders). Steps walk the
    layout row-major; ``first``/``last`` flag each row's boundary steps,
    ``run`` is 0 on placeholder and padding steps (padding re-points at
    the head's last block).  ``factor`` > 1 walks a (factor x
    factor)-coarser grid, one step per coarse cell holding any active
    fine cell, its fine activity packed into ``fmask`` (bit r * factor +
    c; 1 when ``factor`` is 1)."""
    H, n_rows, n_cols = layout.shape
    assert n_rows % factor == 0 and n_cols % factor == 0, \
        (layout.shape, factor)
    assert factor * factor <= 31, "fmask bits must fit an int32"
    bits = _fine_bits(np.asarray(layout, bool), factor)
    heads = []
    for h in range(H):
        steps = []   # (row, col, first, last, run, fmask)
        for r in range(bits.shape[1]):
            idx = np.nonzero(bits[h, r])[0]
            if len(idx) == 0:
                steps.append((r, 0, 1, 1, 0, 0))
                continue
            n = len(idx)
            steps += [(r, int(c), int(t == 0), int(t == n - 1), 1,
                       int(bits[h, r, c])) for t, c in enumerate(idx)]
        heads.append(np.array(steps, np.int32))
    S = max(len(s) for s in heads)
    out = np.zeros((6, H, S), np.int32)
    for h, arr in enumerate(heads):
        out[:, h, :len(arr)] = arr.T
        if len(arr) < S:    # pad: re-point at the last block, all flags 0
            out[0, h, len(arr):] = arr[-1, 0]
            out[1, h, len(arr):] = arr[-1, 1]
    return tuple(out)


def tile_geometry(block, factor=1):
    """(T, T // block): the kernels' index granularity for a layout of
    ``block`` walked ``factor`` blocks at a time, and the fine cells per
    side of a T x T cell.  Raises ValueError for what the kernels do not
    take."""
    block, factor = int(block), int(factor)
    coarse = block * factor
    if block <= 0 or factor <= 0 or \
            (coarse % TILE if coarse >= TILE else TILE % coarse):
        raise ValueError(
            f"block {block} x factor {factor}: the block-sparse kernels take "
            "blocks of 16 or 32, or multiples of 64, walked in multiples of "
            "64 tokens")
    tile = max(TILE, coarse)
    if (tile // block) ** 2 > 31:
        raise ValueError(f"block {block} x factor {factor}: "
                         f"{(tile // block) ** 2} fine cells per tile do not "
                         "fit the 31 bits of a cell's mask")
    return tile, tile // block


def _walk(fine, kf, block, length):
    """The kernels' index of a fine layout padded to a multiple of ``kf``:
    build_csr's live steps as CSR (row_ptr over (layout head, row), cols,
    fmask) and each head's ``length / 64`` own tiles by descending row
    population."""
    row, col, _, _, run, fmask = build_csr(fine, kf)
    H, n_rows = fine.shape[0], fine.shape[1] // kf
    live = run == 1
    counts = np.stack([np.bincount(row[h][live[h]], minlength=n_rows)
                       for h in range(H)])
    n_tiles = -(-length // TILE)
    weight = counts[:, np.arange(n_tiles) * TILE // (kf * block)]
    return {"row_ptr": np.concatenate([[0], np.cumsum(counts)]),
            "cols": col[live], "fmask": fmask[live],
            "order": np.argsort(-weight, axis=1, kind="stable")}


class SparseIndex:
    """A layout [H, n, n] of ``block``-token blocks compiled for the
    kernels (see the module note), with its device copies cached."""

    def __init__(self, layout, *, block, factor=1):
        layout = np.asarray(layout)
        if layout.ndim != 3 or layout.shape[1] != layout.shape[2]:
            raise ValueError(f"layout {layout.shape}: want [heads, n, n] "
                             "(sparse layouts are square)")
        self.layout = (layout != 0).astype(np.int32)
        self.block, self.factor = int(block), int(factor)
        self.tile, kf = tile_geometry(block, factor)
        n = layout.shape[1]
        pad = -n % kf
        fine = np.pad(self.layout, ((0, 0), (0, pad), (0, pad)))
        self.n_rows = (n + pad) // kf
        self.walk = _walk(fine, kf, self.block, self.seq_len)
        self.walk_t = _walk(fine.transpose(0, 2, 1), kf, self.block,
                            self.seq_len)
        self._on = {}

    @property
    def heads(self):
        return self.layout.shape[0]

    @property
    def seq_len(self):
        return self.layout.shape[1] * self.block

    def on(self, device):
        """The index as int32 tensors on ``device`` (made once per device,
        so a call does no host work and no host sync)."""
        if device not in self._on:
            self._on[device] = tuple(
                {k: torch.as_tensor(np.ascontiguousarray(v, np.int32),
                                    device=device) for k, v in w.items()}
                for w in (self.walk, self.walk_t))
        return self._on[device]


# ------------------------------------------------------------ plain versions


def _element_mask(layout, block, length, heads, device):
    """The layout's blocks (numpy, or a tensor already on ``device``)
    expanded to a [1, H, L, L] bool score mask (H = 1 broadcasts over the
    heads)."""
    m = torch.as_tensor(layout, device=device) != 0
    if m.ndim != 3 or m.shape[0] not in (1, heads) or \
            m.shape[1] * block != length or m.shape[2] * block != length:
        raise ValueError(f"layout {tuple(m.shape)} of block {block} does not "
                         f"cover {heads} heads x {length} tokens")
    return m.repeat_interleave(block, 1).repeat_interleave(block, 2)[None]


def sparse_fwd_plain(q, k, v, layout, *, block, causal, scale=None,
                     factor=1):
    """Plain version of :func:`sparse_fwd`: (o [b, L, h, d] in q's dtype,
    lse [b, h, L] fp32) of ``q``/``k``/``v`` [b, L, h, d] under
    ``layout`` [H, L / block, L / block].  ``factor`` is only checked:
    the function does not depend on it."""
    tile_geometry(block, factor)
    mask = _element_mask(layout, block, q.shape[1], q.shape[2], q.device)
    return flash_fwd_plain(q, k, v, causal=causal, scale=scale, mask=mask)


def sparse_bwd_plain(q, k, v, o, lse, do, layout, *, block, causal,
                     scale=None, factor=1):
    """Plain version of :func:`sparse_bwd`: (dq, dk, dv) in the input
    dtypes, p recomputed from ``lse`` under the same mask."""
    tile_geometry(block, factor)
    mask = _element_mask(layout, block, q.shape[1], q.shape[2], q.device)
    return flash_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale,
                           mask=mask)


# ----------------------------------------------------------------- kernels


def _check_index(name, q, k, index):
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"{name}: sparse layouts are square (q_len "
                         f"{q.shape[1]}, k_len {k.shape[1]})")
    if q.shape[1] != index.seq_len or index.heads not in (1, q.shape[2]):
        raise ValueError(f"{name}: the layout ({index.heads} heads x "
                         f"{index.seq_len} tokens) does not fit q "
                         f"{tuple(q.shape)}")


def _launch(name, index, tensors, outs, causal, scale):
    """One kernel over ``tensors`` (q, k, v[, do, lse, delta]) into
    ``outs``; the dkv kernel walks the transposed layout's index."""
    q = tensors[0]
    b, L, h, d = q.shape
    walk, walk_t = index.on(q.device)
    if name == "sparse_bwd_dkv":
        walk = walk_t
    strides = _strides(*(t for t in tensors if t.ndim == 4))
    err = getattr(_lib(), name)(
        *(t.data_ptr() for t in tensors), *(t.data_ptr() for t in outs),
        ctypes.addressof(strides),
        *(walk[k].data_ptr() for k in ("row_ptr", "cols", "fmask", "order")),
        b, h, L, d, index.heads, index.n_rows, index.tile, index.block,
        int(causal), _scale(scale, d), _KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed(name, err)
    _LAUNCHES.add(name, q.dtype)


def sparse_fwd(q, k, v, index, *, causal, scale=None):
    """(o [b, L, h, d], lse [b, h, L] fp32) of ``q``/``k``/``v`` [b, L, h,
    d] under the layout of ``index`` (a :class:`SparseIndex`)."""
    if q.device.type == "cpu":
        return sparse_fwd_plain(q, k, v, index.layout, block=index.block,
                                causal=causal, scale=scale,
                                factor=index.factor)
    _check_cuda("sparse_fwd", q, k, v)
    _check_index("sparse_fwd", q, k, index)
    q, k, v = _tma_operands(q, k, v)
    b, L, h, d = q.shape
    o = torch.empty(b, L, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, L, dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    _launch("sparse_fwd", index, (q, k, v), (o, lse), causal, scale)
    return o, lse


def sparse_bwd(q, k, v, o, lse, do, index, *, causal, scale=None):
    """(dq, dk, dv) of :func:`sparse_fwd` for the output cotangent ``do``:
    the delta pre-pass, then ``sparse_bwd_dq`` and ``sparse_bwd_dkv``."""
    if q.device.type == "cpu":
        return sparse_bwd_plain(q, k, v, o, lse, do, index.layout,
                                block=index.block, causal=causal,
                                scale=scale, factor=index.factor)
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, o, lse, do, None,
                                          name="sparse_bwd")
    _check_index("sparse_bwd", q, k, index)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    args = (q, k, v, do, lse, delta)
    _launch("sparse_bwd_dq", index, args, (dq,), causal, scale)
    _launch("sparse_bwd_dkv", index, args, (dk, dv), causal, scale)
    return dq, dk, dv


# ---------------------------------------------------------------- autograd


class BlockSparseAttentionFn(torch.autograd.Function):
    """o with gradients (the custom VJP of ``block_sparse.py:381-414``):
    forward is :func:`sparse_fwd`, backward :func:`sparse_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, index, causal, scale):
        o, lse = sparse_fwd(q, k, v, index, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.index, ctx.causal, ctx.scale = index, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = sparse_bwd(q, k, v, o, lse, do, ctx.index,
                                causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def make_sparse_op(layout, *, causal, scale, block, num_heads, factor=1):
    """A differentiable ``op(q, k, v) -> o`` on [b, L, num_heads, d]
    tensors over ``layout`` [1 or num_heads, L / block, L / block]
    (``block_sparse.py:381``); the compiled index is ``op.index``.
    ``factor`` > 1 walks (block * factor)-sized cells with exact fine
    masks: the same function, other steps."""
    index = SparseIndex(layout, block=block, factor=factor)
    if index.heads not in (1, num_heads):
        raise ValueError(f"layout heads {index.heads} must be 1 or "
                         f"num_heads ({num_heads})")

    def op(q, k, v):
        if q.shape[2] != num_heads:
            raise ValueError(f"q has {q.shape[2]} heads, the op "
                             f"{num_heads}")
        return BlockSparseAttentionFn.apply(q, k, v, index, bool(causal),
                                            scale)

    op.index = index
    return op


_OP_CACHE = {}
_OP_CACHE_MAX = 64


def _config_key(cfg):
    def freeze(v):
        return tuple(v) if isinstance(v, (list, tuple)) else v
    return (type(cfg).__name__,) + tuple(
        (k, freeze(v)) for k, v in sorted(cfg.__dict__.items()))


def sparse_flash_attention(q, k, v, sparsity_config, *, causal=True,
                           scale=None):
    """Block-sparse attention on [batch, len, heads, head_dim] inputs,
    pattern from a SparsityConfig (``ops/sparse_attention``).  Ops, with
    their index on the inputs' device, are cached per (config, length,
    heads, causal, scale, device), at most 64, the oldest dropped first,
    so a repeated call does only the lookup."""
    b, q_len, h, d = q.shape
    assert q.shape[1] == k.shape[1], "sparse layouts are square"
    scale = _scale(scale, d)
    key = (_config_key(sparsity_config), q_len, h, bool(causal), scale,
           q.device)
    op = _OP_CACHE.get(key)
    if op is None:
        layout = np.asarray(sparsity_config.make_layout(q_len))
        if causal:
            layout = np.tril(layout)
        assert layout.shape[0] in (1, h), (layout.shape, h)
        if len(_OP_CACHE) >= _OP_CACHE_MAX:
            _OP_CACHE.pop(next(iter(_OP_CACHE)))
        op = make_sparse_op(layout, causal=causal, scale=scale,
                            block=int(sparsity_config.block), num_heads=h)
        if q.device.type == "cuda":
            op.index.on(q.device)
        _OP_CACHE[key] = op
    return op(q, k, v)
