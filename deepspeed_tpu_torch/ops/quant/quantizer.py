"""Symmetric group quantization for weight-only int8/int4 serving
(counterpart of ``deepspeed_tpu/ops/quant/quantizer.py``).

Weights quantize per group along the contraction (input) axis: a kernel
``[in, out]`` with group size G stores ``q`` int8 ``[in, out]`` and
scales ``[ceil(in/G), out]`` float32 — each group of (up to) G input
rows shares one scale per output column.  A non-divisible ``in`` gets a
short TRAILING group whose scale covers only the real rows.  Symmetric:
``q = clip(round(x / s), -qmax-1, qmax)``, ``s = max|x| / qmax`` (1.0
where the group is all zero).  ``torch.round`` rounds half to even, as
``jnp.round`` does, and the division ``x / s`` is kept (not a multiply
by a reciprocal), so ``q`` and ``s`` are bit-equal to the JAX package's.
int4 is carried as the JAX code has it: int8 storage, qmax 7.

The orientation is the JAX one (``[in, out]``, the transpose of
``nn.Linear.weight``): the scale rows and the ``int8_matmul`` kernel
read ``q`` with the output columns contiguous.  The JAX tree sweep
(``quantize_tree`` / ``dequantize_tree``) is a sweep over a module's
``QDense`` layers here; a layer's name plays the part of the tree path.
"""

import torch


class QTensor:
    """Quantized weight: ``(q int8, scale f32)`` with the dtype the
    weight dequantizes to.  ``group_size`` is carried because with a
    trailing partial group the grouping is not derivable from the
    shapes alone."""

    def __init__(self, q, scale, dtype=torch.bfloat16, bits=8,
                 group_size=None):
        self.q = q
        self.scale = scale
        self.dtype = dtype
        self.bits = bits
        self.group_size = group_size

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self):
        """True storage footprint: the int8 payload AND the scale rows."""
        return self.q.numel() * self.q.element_size() + \
            self.scale.numel() * self.scale.element_size()

    def dequant(self):
        return dequantize(self.q, self.scale, self.dtype,
                          group_size=self.group_size)

    def __repr__(self):
        return f"QTensor(shape={tuple(self.q.shape)}, bits={self.bits})"


def quantize(x, *, bits=8, group_size=128):
    """``[in, out]`` float -> ``(q int8 [in, out], scale f32
    [ceil(in/G), out])``.  A non-divisible ``in`` quantizes with a short
    trailing group (the zero padding used for the reshape cannot raise
    any |x| max, and the padded rows are sliced off the returned q)."""
    if bits not in (8, 4):
        raise ValueError(f"bits={bits} (int8 / int4 symmetric)")
    n_in, n_out = x.shape
    qmax = 2.0 ** (bits - 1) - 1
    groups = -(-n_in // group_size)
    pad = groups * group_size - n_in
    xf = x.to(torch.float32)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
    g = xf.reshape(groups, group_size, n_out)
    absmax = g.abs().amax(dim=1, keepdim=True)               # [G, 1, out]
    scale = torch.where(absmax > 0, absmax / qmax, 1.0)
    q = torch.clamp(torch.round(g / scale), -qmax - 1, qmax).to(torch.int8)
    q = q.reshape(groups * group_size, n_out)
    if pad:
        q = q[:n_in]
    return q.contiguous(), scale[:, 0, :].contiguous()


def dequantize(q, scale, dtype=torch.bfloat16, group_size=None):
    """Inverse of :func:`quantize`.  ``group_size`` is required when the
    quantization used a trailing partial group (in % G != 0).  Omitted,
    it falls back to the exact-divisible inference (in // groups) and
    raises on ambiguity rather than silently mis-grouping."""
    n_in, n_out = q.shape
    groups = scale.shape[0]
    if group_size is None:
        if n_in % groups != 0:
            raise ValueError(
                f"dequantize: {groups} scale rows do not evenly divide "
                f"{n_in} input rows — this tensor was quantized with a "
                "trailing partial group; pass group_size=")
        group_size = n_in // groups
    pad = groups * group_size - n_in
    if pad < 0 or pad >= group_size:
        raise ValueError(
            f"dequantize: group_size={group_size} inconsistent with "
            f"q rows {n_in} / {groups} scale rows")
    qf = q.to(torch.float32)
    if pad:
        qf = torch.nn.functional.pad(qf, (0, 0, 0, pad))
    g = qf.reshape(groups, group_size, n_out)
    out = (g * scale[:, None, :]).reshape(groups * group_size, n_out)
    if pad:
        out = out[:n_in]
    return out.to(dtype)


def _eligible(leaf):
    """2-D floating kernels quantize (the contraction dim need not
    divide by the group size); degenerate single-row kernels stay
    float — one scale per element saves nothing."""
    return leaf.ndim == 2 and leaf.shape[0] > 1 and leaf.is_floating_point()


def _qdense_layers(module):
    from deepspeed_tpu_torch.ops.quant.qdense import QDense
    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, QDense)]


def quantize_tree(module, *, bits=8, group_size=128, predicate=None):
    """Quantize, in place and layer by layer, every eligible ``QDense``
    weight of ``module`` (the JAX sweep over ``kernel`` leaves; there the
    predicate sees a tree path, here the layer's qualified name).  The
    peak is the float module plus one layer's int8 copy.  Returns
    ``module``."""
    for name, layer in _qdense_layers(module):
        if layer.quantized or not _eligible(layer.weight.t()):
            continue
        if predicate is None or predicate(name, layer):
            layer.quantize_(bits=bits, group_size=group_size)
    return module


def dequantize_tree(module):
    """Materialize every quantized ``QDense`` weight of ``module`` back
    to a float weight, in place.  Returns ``module``."""
    for _, layer in _qdense_layers(module):
        if layer.quantized:
            layer.dequantize_()
    return module
