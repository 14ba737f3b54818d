"""Block-sparse attention (counterpart of
``deepspeed_tpu/ops/sparse_attention/``; reference
``deepspeed/ops/sparse_attention/``: Triton SDD/DSD/DDS matmuls + sparse
softmax + SparsityConfig patterns; here the patterns drive the
block-sparse CUDA kernels of ``ops/attention/block_sparse.py``).
"""

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (  # noqa: F401
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, LocalSlidingWindowSparsityConfig, SparsityConfig,
    VariableSparsityConfig)


class SparseSelfAttention(nn.Module):
    """Counterpart of the reference ``SparseSelfAttention`` module
    (sparse_self_attention.py): q/k/v [b, l, h, d] -> context, with the
    pattern from ``sparsity_config``.  ``causal=None`` reads the config's
    ``attention`` ("unidirectional" is causal; a config without one, such
    as DenseSparsityConfig, is bidirectional)."""

    def __init__(self, sparsity_config, attn_mask_mode="add", scale=None):
        super().__init__()
        self.sparsity_config = sparsity_config
        self.attn_mask_mode = attn_mask_mode
        self.scale = scale

    def forward(self, q, k, v, causal=None):
        from deepspeed_tpu_torch.ops.attention.flash import flash_attention
        if causal is None:
            causal = self.sparsity_config.__dict__.get(
                "attention", "bidirectional") == "unidirectional"
        return flash_attention(q, k, v, causal=causal, scale=self.scale,
                               sparsity_config=self.sparsity_config)


def layout_to_bias(layout, seq_len, block, dtype=torch.float32):
    """Dense additive bias from a block layout (the masked oracle of the
    tests): [H, n, n] blocks -> [1, H, L, L] with the float32 minimum on
    inactive entries."""
    mask = np.repeat(np.repeat(np.asarray(layout), block, 1), block, 2)
    bias = np.where(mask > 0, 0.0, float(np.finfo(np.float32).min))
    return torch.as_tensor(bias[None], dtype=dtype)
