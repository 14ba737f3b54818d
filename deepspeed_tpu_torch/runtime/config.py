"""Training config (counterpart of ``deepspeed_tpu/runtime/config.py``,
``config_utils.py``, ``constants.py`` and ``zero/config.py``).

The same JSON keys for the sections this port runs — the batch sizes
(``train_batch_size = micro * gas * world``, resolved as
``_resolve_batch_parameters``, ``config.py:279``), ``optimizer``,
``scheduler``, ``bf16`` (or the older ``bfloat16``), ``fp16`` (dynamic or
static loss scaling; with ``bf16`` both on it raises, as the JAX config
does), ``data_types`` (its ``grad_accum_dtype`` is read by nothing, in
the JAX package either), ``gradient_clipping``,
``gradient_predivide_factor``, ``steps_per_print``,
``zero_optimization.stage`` 0 or 1, ``mesh.data`` 1, ``checkpoint`` and
``checkpoint_engine``.  The port trains
on one device: at world size 1, ZeRO stage 1 shards the optimizer state
over one rank, the same math as stage 0 (as in the JAX engine on a
1-device mesh).  A section the JAX package runs but the port does not
raises ``NotImplementedError`` naming its ROADMAP.md item when it turns
something on; an unknown key raises ``ValueError``.  Nothing is accepted
and ignored.
"""

import json
import os
from typing import Optional

from pydantic import BaseModel, ConfigDict, Field

# JAX-package sections the port does not run yet -> ROADMAP.md item
UNPORTED_SECTIONS = {
    "activation_checkpointing": "Queue A13 (activation checkpointing)",
    "progressive_layer_drop": "Queue A16 (PLD and random-LTD)",
    "data_efficiency": "Queue A16 (PLD and random-LTD)",
    "curriculum_learning": "Queue A15 (the dataloader)",
    "dataloader_drop_last": "Queue A15 (the dataloader)",
    "compression_training": "Queue A17 (compression and MoQ)",
    "eigenvalue": "Queue A17 (compression and MoQ)",
    "zero_allow_untested_optimizer": "Queue A18 (the other optimizers)",
    "prescale_gradients": "Queue A12 (ZeRO over torch.distributed)",
    "sparse_gradients": "Queue A12 (ZeRO over torch.distributed)",
    "communication_data_type": "Queue A12 (ZeRO over torch.distributed)",
    "disable_allgather": "Queue A12 (ZeRO over torch.distributed)",
    "comms_logger": "Queue A12 (ZeRO over torch.distributed)",
    "aio": "Queue A12 (ZeRO over torch.distributed)",
    "elasticity": "Queue A10 (elasticity)",
    "autotuning": "Queue A10 (autotuning)",
    "flops_profiler": "Queue A10 (training telemetry)",
    "monitor": "Queue A10 (training telemetry)",
    "tensorboard": "Queue A10 (training telemetry)",
    "wandb": "Queue A10 (training telemetry)",
    "csv_monitor": "Queue A10 (training telemetry)",
    "wall_clock_breakdown": "Queue A10 (training telemetry)",
    "memory_breakdown": "Queue A10 (training telemetry)",
    "dump_state": "Queue A10 (training telemetry)",
    "matmul_precision": "Queue A10 (TF32 matmul precision)",
}
ZERO_ITEM = "Queue A12 (ZeRO over torch.distributed)"


def _unported(what, item):
    return NotImplementedError(f"{what} is not ported to the PyTorch "
                               f"package yet: see ROADMAP.md {item}")


def _turns_on(value):
    """A section is off when falsy or ``{"enabled": false, ...}``."""
    if isinstance(value, dict) and "enabled" in value:
        return bool(value["enabled"])
    return bool(value)


class _Section(BaseModel):
    model_config = ConfigDict(extra="forbid", populate_by_name=True)


class OptimizerConfig(_Section):
    type: Optional[str] = None
    params: dict = {}


class SchedulerConfig(_Section):
    type: Optional[str] = None
    params: dict = {}


class Bf16Config(_Section):
    enabled: bool = False


class Fp16Config(_Section):
    """``fp16`` (the JAX ``Fp16Config``, ``runtime/config.py:28-43``):
    ``loss_scale`` 0 is dynamic scaling from ``2 **
    initial_scale_power``; ``consecutive_hysteresis`` is the key the JAX
    scaler reads from the section (``loss_scaler.py:46``).  ``auto_cast``
    is accepted as the JAX config accepts it; nothing reads it there."""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0
    consecutive_hysteresis: bool = False

    @property
    def dynamic_loss_scale(self):
        return self.loss_scale == 0

    @property
    def initial_dynamic_scale(self):
        return 2 ** self.initial_scale_power if self.dynamic_loss_scale \
            else self.loss_scale


class DataTypesConfig(_Section):
    """``data_types`` (JAX ``:50-51``): accepted; no reader of
    ``grad_accum_dtype`` exists in the JAX runtime either, so gradients
    accumulate in fp32 whatever it says."""
    grad_accum_dtype: Optional[str] = None


class ZeroConfig(BaseModel):
    """``zero_optimization``: ``stage`` 0 or 1 and
    ``stage3_gather_16bit_weights_on_model_save`` (a 16-bit weights file
    beside each checkpoint); every other key (stage 2/3, offload,
    bucketing and overlap knobs) belongs to multi-GPU ZeRO."""
    model_config = ConfigDict(extra="allow", populate_by_name=True)
    stage: int = Field(0, ge=0, le=3)
    gather_16bit_weights_on_model_save: bool = Field(
        False, alias="stage3_gather_16bit_weights_on_model_save")

    def model_post_init(self, _ctx):
        if self.stage >= 2:
            raise _unported(f"zero_optimization.stage={self.stage}",
                            ZERO_ITEM)
        for key, value in (self.model_extra or {}).items():
            if _turns_on(value):
                raise _unported(f"zero_optimization.{key}", ZERO_ITEM)


class CheckpointConfig(_Section):
    """``checkpoint`` (the JAX ``CheckpointConfig``, ``runtime/config.py:
    87-92``): ``async_save`` is the default of ``save_checkpoint``'s
    ``async_save``; ``tag_validation`` has nothing to compare on one
    process (every value is valid); universal checkpoints and the
    multi-node write options are not ported."""
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write_pipeline: bool = False
    async_save: bool = False

    def model_post_init(self, _ctx):
        if self.tag_validation.lower() not in ("ignore", "warn", "fail"):
            raise ValueError(f"checkpoint.tag_validation "
                             f"{self.tag_validation!r}: pick Ignore, Warn or "
                             "Fail")
        if self.load_universal:
            raise _unported("checkpoint.load_universal",
                            "Queue A10 (universal checkpoints)")
        for key in ("use_node_local_storage", "parallel_write_pipeline"):
            if getattr(self, key):
                raise _unported(f"checkpoint.{key}", ZERO_ITEM)


class CheckpointEngineConfig(_Section):
    """``checkpoint_engine``: ``{"type": "npz"}`` or a
    ``"package.module:Class"`` backend with its ``params``
    (``checkpoint/backend.py``)."""
    type: str = "npz"
    params: dict = {}


class MeshConfig(_Section):
    """One device: ``data`` 1 (or -1, all of the one device), the other
    axes 1."""
    data: int = -1
    model: int = 1
    pipe: int = 1
    expert: int = 1
    sequence: int = 1

    def model_post_init(self, _ctx):
        if self.data not in (1, -1):
            raise _unported(f"mesh.data={self.data}", ZERO_ITEM)
        for axis in ("model", "pipe", "expert", "sequence"):
            if getattr(self, axis) != 1:
                raise _unported(f"mesh.{axis}={getattr(self, axis)}",
                                "Queue A10 (model, pipeline, expert and "
                                "sequence parallelism)")


def _no_duplicate_keys(pairs):
    out = {}
    for key, value in pairs:
        if key in out:
            raise ValueError(f"duplicate key {key!r} in the config file")
        out[key] = value
    return out


class DeepSpeedConfig(BaseModel):
    """Parse and validate a training config; :meth:`load` takes a dict,
    a JSON path or None."""
    model_config = ConfigDict(extra="allow", populate_by_name=True)

    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    optimizer: OptimizerConfig = Field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = Field(default_factory=SchedulerConfig)
    bf16: Bf16Config = Field(default_factory=Bf16Config, alias="bfloat16")
    fp16: Fp16Config = Field(default_factory=Fp16Config)
    data_types: DataTypesConfig = Field(default_factory=DataTypesConfig)
    gradient_clipping: float = 0.0
    gradient_predivide_factor: float = 1.0
    steps_per_print: int = 10
    zero_optimization: ZeroConfig = Field(default_factory=ZeroConfig)
    mesh: MeshConfig = Field(default_factory=MeshConfig)
    checkpoint: CheckpointConfig = Field(default_factory=CheckpointConfig)
    checkpoint_engine: CheckpointEngineConfig = Field(
        default_factory=CheckpointEngineConfig)

    @classmethod
    def load(cls, config):
        if isinstance(config, cls):
            return config
        if isinstance(config, (str, os.PathLike)):
            with open(config) as f:
                config = json.load(f, object_pairs_hook=_no_duplicate_keys)
        if config is not None and not isinstance(config, dict):
            raise ValueError(f"expected a config dict or JSON path, got "
                             f"{type(config).__name__}")
        return cls(**(config or {}))

    def model_post_init(self, _ctx):
        for key, value in (self.model_extra or {}).items():
            if key not in UNPORTED_SECTIONS:
                raise ValueError(f"unknown training config key {key!r}")
            if _turns_on(value):
                raise _unported(f"training config section {key!r}",
                                UNPORTED_SECTIONS[key])
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")
        self._resolve_batch_parameters()

    def _resolve_batch_parameters(self):
        """Fill the missing batch sizes, then check
        ``train == micro * gas * world``."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        dp = 1                                  # one device
        if all(x is not None for x in (train, micro, gas)):
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * dp)
        elif train is not None and gas is not None:
            micro = train // (dp * gas)
        elif micro is not None and gas is not None:
            train = micro * gas * dp
        elif train is not None:
            gas, micro = 1, train // dp
        elif micro is not None:
            train, gas = micro * dp, 1
        else:
            raise ValueError("Either train_batch_size or "
                             "train_micro_batch_size_per_gpu needs to be "
                             "provided")
        if not (train > 0 and micro > 0 and gas > 0) or \
                train != micro * gas * dp:
            raise ValueError(
                "Check batch related parameters. train_batch_size is not "
                "equal to micro_batch_per_device * gradient_acc_step * "
                f"world_size {train} != {micro} * {gas} * {dp}")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas

    @property
    def zero_optimization_stage(self):
        return self.zero_optimization.stage

    @property
    def precision_dtype(self):
        if self.fp16.enabled:
            return "float16"
        return "bfloat16" if self.bf16.enabled else "float32"
