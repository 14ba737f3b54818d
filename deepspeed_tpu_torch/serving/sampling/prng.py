"""Threefry-2x32 counter-based random numbers on torch tensors — the
port's counterpart of the pieces of ``jax.random`` the JAX package's
samplers use (``fold_in``, ``split``, ``bits``, ``uniform``, ``gumbel``,
``categorical``), bit for bit with JAX's partitionable threefry
(``jax_threefry_partitionable``, the default since jax 0.5):

* a key is two uint32 words, here a ``[..., 2]`` int64 tensor holding
  them (``jax.random.PRNGKey(seed)`` is ``[seed >> 32, seed & M]``,
  ``params.request_key``);
* ``fold_in(key, n)`` is ``threefry2x32(key, (0, n))``;
* ``split(key, num)[i]`` is ``threefry2x32(key, (0, i))``;
* ``bits(key, shape)`` at flat index ``i`` of ``shape`` is ``x0 ^ x1``
  of ``threefry2x32(key, (i >> 32, i & M))``;
* ``uniform`` takes the top 23 bits as a mantissa of [1, 2), minus 1,
  then ``max(minval, f * (maxval - minval) + minval)`` in float32;
* ``categorical(key, logits)`` is
  ``argmax(logits - log(-log(uniform(tiny, 1))))``.

CUDA tensors lack most uint32 arithmetic, so every word is an int64
masked to 32 bits after each add and shift; the float bit cast goes
through an int32 view.  Nothing here reads a host value or keeps
generator state: the functions run inside a CUDA graph body, and a key
is plain data that a replay reads afresh.
"""

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000
TINY_F32 = float(np.finfo(np.float32).tiny)


def as_key(key, device=None):
    """A numpy / torch uint32 pair (or ``[..., 2]`` batch) -> the int64
    tensor form the functions here take."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device or key.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64),
                           device=device)


def _rotl(v, r):
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds: ``key`` [..., 2] and
    the counter words ``x0`` / ``x1`` (int64 holding uint32, broadcast
    against ``key[..., 0]``) -> the two output words."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def fold_in(key, data):
    """``jax.random.fold_in``: ``key`` [..., 2], ``data`` an int or an
    integer tensor broadcast against the key's batch -> [..., 2].  An
    int stays a Python scalar: no host-to-device copy, which a CUDA
    graph capture refuses."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
        y0, y1 = threefry2x32(key, torch.zeros_like(data), data)
    else:
        y0, y1 = threefry2x32(key, 0, int(data) & MASK)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key, num=2):
    """``jax.random.split``: [..., 2] -> [..., num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., None, :], torch.zeros_like(i), i)
    return torch.stack((y0, y1), dim=-1)


def bits(key, shape):
    """``jax.random.bits`` (32-bit) of ``shape`` for each key of the
    batch: [..., 2] -> [..., *shape] int64 holding uint32."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., None, :], i >> 32, i & MASK)
    return (y0 ^ y1).reshape(tuple(key.shape[:-1]) + shape)


def uniform(key, shape=(), minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32: [..., 2] -> [..., *shape]."""
    b = bits(key, shape)
    f = ((b >> 9) | _ONE_F32_BITS).to(torch.int32).view(torch.float32)
    f = f - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(f * span + lo, lo)


def gumbel(key, shape):
    """``jax.random.gumbel`` (its default "low" mode), float32."""
    return -torch.log(-torch.log(uniform(key, shape, TINY_F32, 1.0)))


def categorical(key, logits):
    """``jax.random.categorical`` over the last axis: one draw per row of
    ``logits`` [..., vocab].  ``key`` [..., 2] covers a prefix of the
    row dims: a single key draws every row from one stream (JAX's
    ``categorical(key, logits)``), a key per row draws each from its own
    (``vmap(categorical)(keys, logits)``)."""
    shape = logits.shape[key.ndim - 1:]
    return torch.argmax(gumbel(key, shape) + logits, dim=-1)
