"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

It keeps the JAX package's user-facing surface and module layout
(``deepspeed_tpu/<path>`` -> ``deepspeed_tpu_torch/<path>``) and imports
neither jax nor anything of ``deepspeed_tpu``.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; with no card and
no explicit CPU request they raise.  ROADMAP.md lists what is ported.
"""

from deepspeed_tpu_torch.utils.logging import log_dist, logger  # noqa: F401

__version__ = "0.1.0"


def initialize(args=None, model=None, optimizer=None, training_data=None,
               lr_scheduler=None, config=None, config_params=None,
               loss_fn=None, seed=0, device=None):
    """Build a training engine (``deepspeed_tpu.initialize``).

    ``model`` is a native :class:`~deepspeed_tpu_torch.models.gpt2.GPT2`;
    ``config`` a dict or JSON path (``config_params`` and
    ``args.deepspeed_config`` are the older spellings); ``loss_fn(module,
    batch) -> scalar`` defaults to next-token cross-entropy; ``seed``
    draws the initial weights; ``device`` is ``None`` (the CUDA device:
    raises when no card is visible) or ``"cpu"``.  Returns ``(engine,
    optimizer, None, lr_scheduler)``: there is no training dataloader
    yet (ROADMAP.md Queue A15), nor a client optimizer (Queue A18)."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if optimizer is not None:
        raise NotImplementedError(
            "a client optimizer is not ported to the PyTorch package yet: "
            "see ROADMAP.md Queue A18 (the other optimizers)")
    if training_data is not None:
        raise NotImplementedError(
            "training_data is not ported to the PyTorch package yet: see "
            "ROADMAP.md Queue A15 (the dataloader)")
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if model is None or config is None:
        raise ValueError("deepspeed_tpu_torch.initialize needs a model and "
                         "a config")
    engine = DeepSpeedEngine(model, config, loss_fn=loss_fn,
                             lr_scheduler=lr_scheduler, seed=seed,
                             device=device)
    return engine, engine.optimizer, None, engine.lr_scheduler


def init_inference(model=None, config=None, **kwargs):
    """Build an inference engine (``deepspeed_tpu.init_inference``).

    ``model`` is a native :class:`~deepspeed_tpu_torch.models.llama.Llama`
    or :class:`~deepspeed_tpu_torch.models.gpt2.GPT2` (any variant of the
    GPT-2 family's config), or an HF model instance or ``save_pretrained``
    directory, which ``module_inject.from_hf`` ingests (its weights reach
    the engine as ``params``, cast and placed leaf by leaf).  ``config``
    is a
    :class:`~deepspeed_tpu_torch.inference.config.DeepSpeedInferenceConfig`,
    a dict or a JSON path; ``kwargs`` override its fields (``device``,
    ``dtype``, ``checkpoint``, ...).  ``params=`` loads a state dict."""
    import os

    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import DTYPES, InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import GPT2
    from deepspeed_tpu_torch.models.llama import Llama
    from deepspeed_tpu_torch.module_inject.replace_module import (from_hf,
                                                                  is_hf_model)

    params = kwargs.pop("params", None)
    if isinstance(config, DeepSpeedInferenceConfig):
        config = config.model_dump()
    elif isinstance(config, str):
        import json
        with open(config) as f:
            config = json.load(f)
    cfg = DeepSpeedInferenceConfig(**{**(config or {}), **kwargs})
    if not isinstance(model, (Llama, GPT2)) and (
            isinstance(model, (str, os.PathLike)) or is_hf_model(model)):
        # HF ingestion (the JAX init_inference, deepspeed_tpu/__init__.py:
        # 78-91): the module computes in the engine's dtype (bf16 under
        # dtype="int8")
        model, hf_params = from_hf(model, dtype=DTYPES[cfg.dtype])
        if params is None:
            params = hf_params
    return InferenceEngine(model, cfg, params=params)
