"""int8 dequant-matmul for weight-only quantized serving (counterpart of
``deepspeed_tpu/ops/quant/kernels.py``).

``int8_matmul(x [m, k], q [k, n] int8, scale [k/G, n] f32) -> [m, n]``
in ``x.dtype``: per group of G contraction rows an UNSCALED product of
``x`` with ``q`` converted to ``x.dtype`` (exact), accumulated in fp32,
times the group's scale row, summed over the groups in fp32 and cast.
The scale multiplies the ``[m, n]`` partial product once per group, not
the weights — that is the function's arithmetic, and
:func:`int8_matmul_plain` repeats it step by step.

The hand-written CUDA kernel for Hopper is ``csrc/int8_matmul.cu`` (its
header note names the TPU kernel it replaces, its bound and the design):
a producer warp keeps int8 weight tiles in flight by TMA, bf16 and fp16
run on the tensor cores, and k is split by whole groups over the blocks of a
thread block cluster (:func:`k_splits`), merged in split order.  The
weight stays int8 in device memory and is never materialised
dequantized.  The dispatch rule is the tensor's device: a CPU tensor
runs the plain version, a CUDA tensor launches the kernel or raises.
The wrapper counts its launches (:func:`launch_counts`).
"""

import torch

from deepspeed_tpu_torch.ops.launch_counter import LaunchCounter

_LAUNCHES = LaunchCounter("int8_matmul_fwd")
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
BLOCK_N = 128          # output columns of a block of the kernel
MAX_K_SPLITS = 8       # blocks of a thread block cluster
NUM_SMS = 132          # the H100 SXM's streaming multiprocessors
TARGET_BLOCKS = 256    # about two blocks for each of them


def launch_counts(dtype=None):
    """Kernel launches since the last :func:`reset_launch_counts`
    (CUDA-graph replays included, ``ops/launch_counter.py``); with
    ``dtype``, those of that dtype's instantiation."""
    return _LAUNCHES.counts(dtype)


def reset_launch_counts():
    _LAUNCHES.reset()


def k_splits(k, n, group):
    """Blocks that share a column tile's k in the kernel: none where the
    column tiles alone give each SM one (:data:`NUM_SMS`), else the
    fewest (a power of two, at most :data:`MAX_K_SPLITS`) that put
    :data:`TARGET_BLOCKS` blocks on the card; then as few as cut the
    ``k // group`` groups into equal whole-group shares with none
    empty.  It depends on (k, n, G) alone, never on m, so a row's result
    does not depend on how many rows share the call."""
    groups = k // group
    tiles = -(-n // BLOCK_N)
    splits = 1
    while tiles < NUM_SMS and splits < MAX_K_SPLITS and \
            tiles * splits < TARGET_BLOCKS:
        splits *= 2
    per = -(-groups // min(splits, groups))
    return -(-groups // per)


def _lib():
    from deepspeed_tpu_torch.ops.op_builder import Int8MatmulBuilder
    return Int8MatmulBuilder().load()


def _check_shapes(x, q, scale):
    if x.ndim != 2 or q.ndim != 2 or scale.ndim != 2:
        raise ValueError("int8_matmul takes x [m, k], q [k, n], scale "
                         f"[k/G, n]; got {tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(scale.shape)}")
    (m, k), (k2, n), (groups, n2) = x.shape, q.shape, scale.shape
    if k != k2 or n != n2 or groups == 0 or k % groups:
        raise ValueError(
            f"int8_matmul: x {tuple(x.shape)}, q {tuple(q.shape)} and scale "
            f"{tuple(scale.shape)} do not agree (k must be a whole number "
            "of groups; a trailing partial group goes through "
            "x @ dequantize)")
    if q.dtype != torch.int8:
        raise ValueError(f"int8_matmul: q must be int8, got {q.dtype}")
    return m, k, n, k // groups


def int8_matmul_plain(x, q, scale):
    """Plain version of :func:`int8_matmul`, the kernel's arithmetic step
    by step: per group ``x_g @ q_g.to(x.dtype)`` accumulated in fp32,
    times ``scale[g]``, summed in group order, cast to ``x.dtype``."""
    m, k, n, group = _check_shapes(x, q, scale)
    groups = k // group
    xg = x.reshape(m, groups, group).transpose(0, 1).float()  # [g, m, G]
    wg = q.reshape(groups, group, n).to(x.dtype).float()      # exact
    part = torch.bmm(xg, wg)                                  # [g, m, n]
    part = part * scale.float()[:, None, :]
    acc = torch.zeros(m, n, dtype=torch.float32, device=x.device)
    for g in range(groups):
        acc = acc + part[g]
    return acc.to(x.dtype)


def int8_matmul(x, q, scale):
    """``x [m, k] @ dequant(q [k, n] int8, scale [k/G, n])`` -> ``[m, n]``
    in ``x.dtype``.  Oracle: ``x @ dequantize(q, scale)``."""
    m, k, n, group = _check_shapes(x, q, scale)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"int8_matmul: dtype {x.dtype} (the kernel takes "
                         "float32, bfloat16 and float16)")
    if scale.dtype != torch.float32:
        raise ValueError(f"int8_matmul: scale must be float32, got "
                         f"{scale.dtype}")
    for t in (x, q, scale):
        if t.device != x.device:
            raise ValueError(f"int8_matmul: every tensor must be on "
                             f"{x.device}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("int8_matmul: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("int8_matmul: inputs must be 16-byte aligned")
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    err = _lib().int8_matmul_fwd(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, k, n, group, k_splits(k, n, group), _KERNEL_DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul_fwd launch failed: cudaError {err}")
    _LAUNCHES.add("int8_matmul_fwd", x.dtype)
    return out
