"""Dense layer of the serving models, float or weight-only int8
(counterpart of ``deepspeed_tpu/ops/quant/qdense.py``).

ONE module for both regimes; what the layer holds decides.  A float
``weight`` gives ``y = x @ W^T (+ b)`` with the input cast to the
layer's dtype first — the numerics of the flax ``QDense`` float branch
(``promote_dtype`` then ``dot_general``, ``qdense.py:89-96``).  The
weight is stored in PyTorch's ``[out, in]`` layout; the flax ``kernel``
is ``[in, out]`` (``models/llama.py`` ``llama_params_from_jax``
transposes it).

After :meth:`QDense.quantize_` the layer holds the JAX ``QTensor``
instead, in the JAX orientation: ``q`` int8 ``[in, out]`` and ``scale``
float32 ``[ceil(in/G), out]`` as buffers (``weight`` is ``None``), and
the forward is :func:`quant_matmul`: leading dims flattened to m, the
``int8_matmul`` kernel, the bias after.  ``[in, out]`` with the output
columns contiguous is also the layout the kernel reads (threads along
n), so there is no second storage layout.  There is no ``impl`` knob:
the tensor's device decides between the kernel and its plain version
(``ops/quant/kernels.py``).  A trailing partial group (``in % G != 0``)
has no whole-group blocking and goes through ``x @ dequant`` as in the
JAX package (``qdense.py:52-56``), where that product is outside the
Pallas kernel too.
"""

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.quant.kernels import int8_matmul
from deepspeed_tpu_torch.ops.quant.quantizer import QTensor, quantize


def quant_matmul(x, qt):
    """``x [..., k] @ dequant(qt) -> [..., n]``."""
    k = x.shape[-1]
    trailing = k % qt.scale.shape[0] != 0 or (
        qt.group_size is not None and
        qt.group_size * qt.scale.shape[0] != k)
    if trailing:
        return x @ qt.dequant().to(x.dtype)
    lead = x.shape[:-1]
    y = int8_matmul(x.reshape(-1, k), qt.q, qt.scale)
    return y.reshape(*lead, y.shape[-1])


class QDense(nn.Linear):
    def __init__(self, in_features, out_features, use_bias=False, *,
                 dtype=None, device=None):
        super().__init__(in_features, out_features, bias=use_bias,
                         dtype=dtype, device=device)
        # the QTensor's leaves; buffers, so they move with the module
        # and travel in its state_dict
        self.register_buffer("q", None)
        self.register_buffer("scale", None)
        self.bits = self.group_size = self.qdtype = None

    @property
    def quantized(self):
        return self.q is not None

    @property
    def kernel(self):
        """The layer's weight as the JAX tree holds it: a
        :class:`QTensor` when quantized, else the float ``[in, out]``
        view of ``weight``."""
        if self.quantized:
            return QTensor(self.q, self.scale, self.qdtype, self.bits,
                           self.group_size)
        return self.weight.t()

    @torch.no_grad()
    def set_qtensor_(self, qt):
        """Hold ``qt`` (leaves on this layer's device) in place of the
        float weight."""
        if tuple(qt.q.shape) != (self.in_features, self.out_features):
            raise ValueError(f"QTensor of shape {tuple(qt.q.shape)} for a "
                             f"layer [{self.in_features}, "
                             f"{self.out_features}]")
        device = self.q.device if self.quantized else self.weight.device
        self.q = qt.q.to(device=device, dtype=torch.int8).contiguous()
        self.scale = qt.scale.to(device=device,
                                 dtype=torch.float32).contiguous()
        self.bits, self.group_size, self.qdtype = \
            qt.bits, qt.group_size, qt.dtype
        self.weight = None
        return self

    @torch.no_grad()
    def quantize_(self, *, bits=8, group_size=128):
        """Quantize the float weight in place; it dequantizes to (and
        the layer computes in) the dtype the weight had."""
        q, scale = quantize(self.weight.t(), bits=bits,
                            group_size=group_size)
        return self.set_qtensor_(QTensor(q, scale, self.weight.dtype, bits,
                                         group_size))

    @torch.no_grad()
    def dequantize_(self):
        """Back to a float weight (the dequantized values)."""
        w = self.kernel.dequant().t().contiguous()
        self.q = self.scale = None
        self.bits = self.group_size = self.qdtype = None
        self.weight = nn.Parameter(w, requires_grad=False)
        return self

    def forward(self, x):
        if not self.quantized:
            return F.linear(x.to(self.weight.dtype), self.weight, self.bias)
        y = quant_matmul(x.to(self.qdtype), self.kernel)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
