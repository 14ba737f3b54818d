"""The checkpoint names of a module's weights: the JAX param tree's
keystrs under ``.params`` (``.params['h_0']['attn']['qkv']['kernel']``,
flax ``[in, out]`` kernels), from the models' inverse weight bridges
(``models/gpt2.py`` ``gpt2_jax_path``, ``models/llama.py``
``llama_jax_path``), so a checkpoint written by either package carries
the same names and layouts."""

from deepspeed_tpu_torch.checkpoint.engine import keystr
from deepspeed_tpu_torch.models.gpt2 import GPT2, gpt2_jax_path
from deepspeed_tpu_torch.models.llama import llama_jax_path

PARAMS = ".params"


def jax_leaf_names(module):
    """``{state_dict name: (leaf name under .params, transposed)}`` of a
    float ``GPT2`` or ``Llama``, in ``state_dict`` order."""
    path_of = gpt2_jax_path if isinstance(module, GPT2) else llama_jax_path
    out = {}
    for name, t in module.state_dict().items():
        path, transposed = path_of(name, t.ndim)
        out[name] = (keystr(path), transposed)
    return out

