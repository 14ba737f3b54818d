from deepspeed_tpu_torch.ops.attention.block_sparse import (  # noqa: F401
    BlockSparseAttentionFn, SparseIndex, build_csr, make_sparse_op,
    sparse_bwd, sparse_bwd_plain, sparse_flash_attention, sparse_fwd,
    sparse_fwd_plain)
from deepspeed_tpu_torch.ops.attention.decode import (  # noqa: F401
    decode_attention, decode_attention_plain, gather_pages, launch_counts,
    paged_decode_attention, paged_decode_attention_plain,
    paged_kernel_decision, reset_launch_counts)
from deepspeed_tpu_torch.ops.attention.flash import (  # noqa: F401
    flash_attention, flash_attention_with_lse, flash_bwd, flash_bwd_plain,
    flash_fwd, flash_fwd_plain)
from deepspeed_tpu_torch.ops.attention.reference import (  # noqa: F401
    apply_rotary_emb, causal_mask, mha_reference)
