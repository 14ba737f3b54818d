"""HF-model ingestion (counterpart of ``deepspeed_tpu/module_inject/``).

A policy maps a whole HF architecture (config + state dict) onto the
port's native ``GPT2`` (every GPT-2-family variant) or ``Llama`` and its
``state_dict`` names; the engine then casts and places the weights leaf
by leaf.  ``hf_config`` and ``hf_weights`` read ``config.json``,
safetensors and ``.bin`` files without ``transformers`` or
``safetensors``.
"""

from deepspeed_tpu_torch.module_inject.replace_module import (  # noqa: F401
    from_hf, load_hf_state_dict, replace_transformer_layer)
from deepspeed_tpu_torch.module_inject.replace_policy import (  # noqa: F401
    POLICIES, policy_for)
