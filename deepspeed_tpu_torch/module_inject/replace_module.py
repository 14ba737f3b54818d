"""HF checkpoint -> native module + state dict (counterpart of
``deepspeed_tpu/module_inject/replace_module.py``).

:func:`from_hf` takes an HF model instance (by duck type: a ``config``
with a ``model_type`` and a ``state_dict()``) or a ``save_pretrained``
directory, picks the policy for its ``model_type`` (falling back to the
AutoTP structural policy for an unknown llama-shaped decoder, as the JAX
``from_hf`` does at ``:77-118``), builds the module on the ``meta``
device and returns it with a :class:`LazyStateDict` whose leaves are
built one at a time, in the files' dtypes: the engine casts each to its
dtype on its device (``InferenceEngine.set_params``), so a 7B-width
directory is never held as a second full host copy.  Neither
``transformers`` nor ``safetensors`` is imported.
"""

import collections.abc
import os

from deepspeed_tpu_torch.module_inject.hf_config import load_hf_config
from deepspeed_tpu_torch.module_inject.hf_weights import (  # noqa: F401
    load_hf_state_dict)
from deepspeed_tpu_torch.module_inject.policy import AutoTPPolicy
from deepspeed_tpu_torch.module_inject.replace_policy import policy_for
from deepspeed_tpu_torch.utils.logging import logger


class LazyStateDict(collections.abc.Mapping):
    """``{port state_dict name: tensor}`` whose tensors are built when
    read (``policy.Leaf``); :meth:`shape` answers without building."""

    def __init__(self, leaves):
        self._leaves = dict(leaves)

    def __getitem__(self, name):
        return self._leaves[name].build()

    def __iter__(self):
        return iter(self._leaves)

    def __len__(self):
        return len(self._leaves)

    def shape(self, name):
        return self._leaves[name].shape


def is_hf_model(obj):
    """An HF ``PreTrainedModel`` by duck type."""
    return hasattr(getattr(obj, "config", None), "model_type") and \
        callable(getattr(obj, "state_dict", None))


def from_hf(model_or_path, dtype=None, hf_config=None, device="meta"):
    """Ingest an HF model: ``(native module, LazyStateDict)``.

    ``model_or_path`` is an HF model instance or a ``save_pretrained``
    directory; ``dtype`` the compute dtype of a GPT-2-family module
    (float32 by default); ``hf_config`` overrides the model's config.
    The module is built on ``device`` (``meta``: no memory until the
    engine materializes it)."""
    if isinstance(model_or_path, (str, os.PathLike)):
        path = os.fspath(model_or_path)
        cfg = load_hf_config(hf_config if hf_config is not None else path)
        sd = load_hf_state_dict(path)
    elif is_hf_model(model_or_path):
        cfg = load_hf_config(hf_config if hf_config is not None
                             else model_or_path.config)
        sd = {k: v.detach() for k, v in model_or_path.state_dict().items()}
    else:
        raise ValueError(f"from_hf takes an HF model or a save_pretrained "
                         f"directory, got {type(model_or_path).__name__}")
    try:
        pol = policy_for(cfg)
        module = pol.build_module(cfg, dtype=dtype, device=device)
        leaves = pol.convert(cfg, sd)
    except ValueError as policy_err:
        if AutoTPPolicy.discover(sd) is None:
            raise policy_err
        logger.warning(
            f"no policy for model_type={getattr(cfg, 'model_type', None)!r}; "
            "using the AutoTP structural fallback (llama-shaped decoder "
            "discovered)")
        module, leaves = AutoTPPolicy.ingest(cfg, sd, dtype=dtype,
                                             device=device)
    state = LazyStateDict(leaves)
    _check_structure(module, state)
    return module, state


def _check_structure(module, state):
    """The converted names and shapes must be exactly the module's
    ``state_dict`` (JAX ``_check_structure``, ``:121-148``)."""
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    have = {k: state.shape(k) for k in state}
    if set(want) != set(have):
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        raise ValueError(f"converted params do not match the native module: "
                         f"missing={missing} extra={extra}")
    for name, shape in want.items():
        if have[name] != shape:
            raise ValueError(f"shape mismatch for {name}: converted "
                             f"{have[name]} vs module {shape}")


def replace_transformer_layer(model, dtype=None, **_):
    """The reference's name (``replace_module.py:274``): converts a whole
    HF model instead of swapping layers in place."""
    return from_hf(model, dtype=dtype)

