"""Sparsity pattern configs -> block layouts (a copy of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``: numpy only,
layouts bit-equal to the JAX package's).

Reference: ``deepspeed/ops/sparse_attention/sparsity_config.py`` —
``SparsityConfig`` :10, ``Fixed`` :95, ``Variable`` :239, ``BigBird``
:411, ``BSLongformer``, ``LocalSlidingWindow``; consumed there by Triton
block-sparse matmuls, here by the block-sparse CUDA kernels
(``ops/attention/block_sparse.py``).

A layout is an int32 array ``[layout_heads, num_blocks, num_blocks]``
(1 = attend). ``block`` is the block granularity: the kernels visit only
the key tiles of a query tile's active blocks, so compute and K/V
traffic scale with the layout's density.
"""

import numpy as np


class SparsityConfig:
    """Base: dense layout; subclasses carve structure out of it."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    @property
    def layout_heads(self):
        return self.num_heads if self.different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} not divisible by "
                             f"block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.layout_heads, n, n), np.int32)

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks active (reference ``DenseSparsityConfig``)."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed pattern (reference :95 / the original Sparse Transformer):
    rows are grouped into non-overlapping local windows of
    ``num_local_blocks``; each row attends within its window, and the
    last ``num_global_blocks`` columns of every window are global —
    attended by everyone (and, with ``horizontal_global_attention``,
    attending to everyone)."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        assert attention in ("unidirectional", "bidirectional")
        assert num_global_blocks <= num_local_blocks
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("num_different_global_patterns > 1 needs "
                             "different_layout_per_head=True")
        assert num_local_blocks % num_global_blocks == 0
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"num_different_global_patterns "
                f"({num_different_global_patterns}) cannot exceed "
                f"num_local_blocks/num_global_blocks "
                f"({num_local_blocks // num_global_blocks}): the rotated "
                "global slice would leave the window (reference asserts "
                "the same bound)")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        L, G = self.num_local_blocks, self.num_global_blocks
        for h in range(layout.shape[0]):
            # local windows
            for w0 in range(0, n, L):
                w1 = min(w0 + L, n)
                layout[h, w0:w1, w0:w1] = 1
            # global columns: the pattern can differ per head (reference
            # num_different_global_patterns rotates which sub-slice of
            # the window is global)
            pat = h % self.num_different_global_patterns
            for w0 in range(0, n, L):
                g1 = min(w0 + L, n) - pat * G
                g0 = max(g1 - G, 0)
                layout[h, :, g0:g1] = 1
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Variable pattern (reference :239): custom local window sizes,
    explicit global block index ranges, plus random blocks."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False,
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        assert attention in ("unidirectional", "bidirectional")
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices \
            if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None:
            assert len(global_block_end_indices) == \
                len(self.global_block_indices)
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = np.random.default_rng(self.seed)
        for h in range(layout.shape[0]):
            # local windows of varying width; the last width repeats
            w0 = 0
            i = 0
            while w0 < n:
                w = self.local_window_blocks[
                    min(i, len(self.local_window_blocks) - 1)]
                w1 = min(w0 + w, n)
                layout[h, w0:w1, w0:w1] = 1
                w0, i = w1, i + 1
            # globals
            for j, g0 in enumerate(self.global_block_indices):
                if g0 >= n:
                    continue
                g1 = g0 + 1 if self.global_block_end_indices is None \
                    else min(self.global_block_end_indices[j], n)
                layout[h, :, g0:g1] = 1
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = 1
            # random blocks: unidirectional rows sample from their own
            # causal range so tril doesn't silently drop them
            for r in range(self.num_random_blocks):
                for q in range(n):
                    hi = q + 1 if self.attention == "unidirectional" else n
                    layout[h, q, rng.integers(0, hi)] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (reference :411): sliding window + random blocks + global
    first/last blocks."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        assert attention in ("unidirectional", "bidirectional")
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        W, G = self.num_sliding_window_blocks, self.num_global_blocks
        rng = np.random.default_rng(self.seed)
        half = W // 2
        for h in range(layout.shape[0]):
            for q in range(n):
                lo, hi = max(0, q - half), min(n, q + half + 1)
                layout[h, q, lo:hi] = 1
            layout[h, :, :G] = 1       # global: first blocks as columns
            layout[h, :G, :] = 1       # ...and as rows
            layout[h, :, n - G:] = 1
            layout[h, n - G:, :] = 1
            for q in range(n):
                for r in range(self.num_random_blocks):
                    hi = q + 1 if self.attention == "unidirectional" else n
                    layout[h, q, rng.integers(0, hi)] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer (reference): sliding window + explicit
    global block indices (rows and columns)."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices \
            if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        half = self.num_sliding_window_blocks // 2
        for h in range(layout.shape[0]):
            for q in range(n):
                lo, hi = max(0, q - half), min(n, q + half + 1)
                layout[h, q, lo:hi] = 1
            for j, g0 in enumerate(self.global_block_indices):
                if g0 >= n:
                    continue
                g1 = g0 + 1 if self.global_block_end_indices is None \
                    else min(self.global_block_end_indices[j], n)
                layout[h, :, g0:g1] = 1
                layout[h, g0:g1, :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding window (reference ``LocalSlidingWindowSparsityConfig``)."""

    def __init__(self, num_heads, block=128, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block, different_layout_per_head=False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        half = self.num_sliding_window_blocks // 2
        for q in range(n):
            if self.attention == "unidirectional":
                lo = max(0, q - self.num_sliding_window_blocks + 1)
                layout[0, q, lo:q + 1] = 1
            else:
                lo, hi = max(0, q - half), min(n, q + half + 1)
                layout[0, q, lo:hi] = 1
        return layout
