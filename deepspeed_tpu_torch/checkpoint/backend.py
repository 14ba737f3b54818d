"""Pluggable checkpoint backends (counterpart of
``deepspeed_tpu/checkpoint/backend.py``).

``{"checkpoint_engine": {"type": "npz"}}`` (the default) is the native
chunked format of ``checkpoint/engine.py``; ``{"type":
"package.module:ClassName", "params": {...}}`` names a
:class:`CheckpointEngine` subclass, which the training engine saves and
loads through and the inference engine reads ``.params`` through.
``save`` may return a writer with ``wait()`` (the engine's
``wait_checkpoint`` joins it).
"""

import abc
import importlib
import os

from deepspeed_tpu_torch.utils.logging import logger


class CheckpointEngine(abc.ABC):
    """The backend contract the engines save and load through."""

    def __init__(self, params=None):
        self.params = dict(params or {})

    def create(self, tag):
        """Hook before a save of ``tag`` begins."""

    @abc.abstractmethod
    def save(self, path, state, client_state=None, async_write=False,
             on_done=None, transposed=()):
        """Persist ``state`` (``{leaf name: tensor}``) and ``client_state``
        under ``path``; returns None or a writer exposing ``wait()``."""

    @abc.abstractmethod
    def load(self, path, target):
        """``(state, client_state)`` for the leaves of ``target``
        (``{name: tensor or shape}``)."""

    def load_subtree(self, path, target, prefix):
        """The leaves ``prefix + name`` for each name of ``target``
        (the inference engine reads ``.params``)."""
        raise NotImplementedError

    def consolidate_16bit(self, path, out_name, dtype):
        """The gathered 16-bit weights file beside the checkpoint at
        ``path`` (``gather_16bit_weights_on_model_save``)."""
        from deepspeed_tpu_torch.checkpoint.engine import consolidate
        consolidate(path, os.path.join(path, out_name), dtype=dtype)

    def commit(self, tag):
        """Hook after the save of ``tag`` is durable."""


class NpzCheckpointEngine(CheckpointEngine):
    """The native chunked npz format (``checkpoint/engine.py``)."""

    def save(self, path, state, client_state=None, async_write=False,
             on_done=None, transposed=()):
        from deepspeed_tpu_torch.checkpoint.engine import save_state
        return save_state(path, state, client_state, async_write=async_write,
                          on_done=on_done, transposed=transposed)

    def load(self, path, target):
        from deepspeed_tpu_torch.checkpoint.engine import load_state
        return load_state(path, target)

    def load_subtree(self, path, target, prefix):
        from deepspeed_tpu_torch.checkpoint.engine import load_subtree
        return load_subtree(path, target, prefix=prefix)


def get_checkpoint_engine(section):
    """``checkpoint_engine`` config section -> backend instance."""
    section = dict(section or {})
    kind = section.get("type", "npz")
    params = section.get("params") or {}
    if kind in ("npz", "native", "default"):
        return NpzCheckpointEngine(params)
    if ":" not in kind:
        raise ValueError(
            f"checkpoint_engine.type {kind!r}: use 'npz' or a "
            "'package.module:ClassName' path to a CheckpointEngine "
            "subclass")
    mod_name, cls_name = kind.split(":", 1)
    cls = getattr(importlib.import_module(mod_name), cls_name)
    engine = cls(params)
    if not isinstance(engine, CheckpointEngine):
        raise ValueError(f"{kind} is not a CheckpointEngine")
    logger.info(f"checkpoint engine: {kind}")
    return engine
