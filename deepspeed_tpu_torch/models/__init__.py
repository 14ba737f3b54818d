from deepspeed_tpu_torch.models.gpt2 import (GPT2, GPTConfig,  # noqa: F401
                                             gpt2_loss_fn,
                                             gpt2_params_from_jax,
                                             gpt2_small, gpt2_tiny)
from deepspeed_tpu_torch.models.llama import (Llama, LlamaConfig,  # noqa: F401
                                              llama2_7b, llama2_70b,
                                              llama_params_from_jax,
                                              llama_tiny)
