"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``).

The same pydantic surface for the fields this port runs — ``dtype``,
``quant``, ``kv_cache_dtype``, ``max_out_tokens``, ``paged_kernel``,
``replace_with_kernel_inject``, ``enable_cuda_graph``, ``checkpoint``,
``checkpoint_engine`` and ``tensor_parallel`` (tp_size 1) — plus
``device``.  The two
quantization knobs are independent, as in the JAX config
(``inference/config.py:86-107``): ``dtype="int8"`` means int8 WEIGHTS
with bfloat16 compute (it sets ``quant.enabled``);
``quant={"enabled": True}`` beside a float ``dtype`` keeps that compute
dtype; ``kv_cache_dtype="int8"|"fp8"`` quantizes the paged KV pools and
is not weight quantization.  A field the JAX
package accepts but the port does not run yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` item; any other
unknown field raises ``ValueError``.  The five fields the JAX config
accepts and no JAX code reads (``min_out_tokens`` / ``min_tokens``,
``max_batch_size``, ``replace_method``, ``triangular_masking``,
``return_tuple``) are accepted at the JAX defaults and refused with
``NotImplementedError`` at any other value.  Nothing else is accepted
and ignored.
"""

from typing import Any, Dict, Optional

from pydantic import BaseModel, ConfigDict, Field, field_validator

from deepspeed_tpu_torch.ops.quant.kv import KV_QUANT_DTYPES

# JAX-package config fields the port does not run yet -> ROADMAP.md item
UNPORTED_FIELDS = {
    "mesh": "Queue A10 (multi-GPU serving)",
    "mesh_dcn": "Queue A10 (multi-GPU serving)",
    "moe": "Queue A10 (MoE serving)",
    "zero": "Queue A10 (ZeRO-Inference offload)",
}

# JAX-package config fields no JAX code reads: accepted at these (the JAX)
# defaults only
INERT_FIELDS = {"min_out_tokens": 1, "max_batch_size": 1,
                "replace_method": "auto", "triangular_masking": True,
                "return_tuple": True}
_INERT_ITEM = "Queue C3 (config fields the reference accepts and ignores)"

_DTYPE_ALIASES = {"half": "float16", "fp16": "float16", "bf16": "bfloat16",
                  "float": "float32", "fp32": "float32"}
_KV_ALIASES = dict(_DTYPE_ALIASES, float8="fp8", float8_e4m3fn="fp8")
FLOAT_DTYPES = ("float32", "bfloat16", "float16")


class DeepSpeedTPConfig(BaseModel):
    model_config = ConfigDict(extra="forbid")
    tp_size: int = 1


class QuantizationConfig(BaseModel):
    """Weight-only group quantization (``ops/quant/quantizer.py``)."""
    model_config = ConfigDict(extra="forbid")
    enabled: bool = False
    num_bits: int = 8
    group_size: int = 64


def _unported(what, item):
    return NotImplementedError(f"{what} is not ported to the PyTorch "
                               f"package yet: see ROADMAP.md {item}")


class DeepSpeedInferenceConfig(BaseModel):
    model_config = ConfigDict(extra="allow", populate_by_name=True)

    dtype: str = "bfloat16"
    quant: QuantizationConfig = Field(default_factory=QuantizationConfig)
    kv_cache_dtype: str = "bfloat16"
    max_out_tokens: int = Field(1024, alias="max_tokens")
    min_out_tokens: int = Field(1, alias="min_tokens")
    max_batch_size: int = 1
    replace_method: str = "auto"
    triangular_masking: bool = True
    return_tuple: bool = True
    tensor_parallel: DeepSpeedTPConfig = Field(
        default_factory=DeepSpeedTPConfig, alias="tp")
    # "auto": a CUDA tensor launches the hand-written kernel, a CPU
    # tensor runs the plain PyTorch version; "force": the kernel is
    # required, so a CPU engine is refused (ops/attention/decode.py)
    paged_kernel: str = "auto"
    # "kernel injection": serve a fresh copy of the model whose
    # attn_impl is "auto" (the flash kernels on a CUDA tensor), never
    # touching the caller's module (inference/engine.py:170-178)
    replace_with_kernel_inject: bool = Field(False, alias="kernel_inject")
    # decode horizons as CUDA graphs (inference/engine.py decode_multi):
    # None replays graphs on a CUDA engine and runs eagerly on the CPU
    # (the counterpart of XLA always compiling); True demands graphs, so
    # a CPU engine is refused; False launches eagerly on the card too
    enable_cuda_graph: Optional[bool] = None
    # a training checkpoint to serve: a path or {"checkpoint_dir": path}
    # (InferenceEngine.load_checkpoint), read through checkpoint_engine
    # ({"type": "npz"} or a "pkg.mod:Class" backend, checkpoint/backend.py)
    checkpoint: Optional[Any] = None
    checkpoint_engine: Dict[str, Any] = Field(default_factory=dict)
    # None -> CUDA (raises when no card is visible); "cpu" runs the
    # plain PyTorch versions of the kernels on the host
    device: Optional[Any] = None

    @field_validator("dtype", "kv_cache_dtype", mode="before")
    @classmethod
    def _dtype_name(cls, value):
        """A dtype object (``torch.float16``) stands for its name."""
        return value if isinstance(value, str) else str(value)

    def model_post_init(self, _ctx):
        for key in self.model_extra or {}:
            if key in UNPORTED_FIELDS:
                raise _unported(f"inference config field {key!r}",
                                UNPORTED_FIELDS[key])
            raise ValueError(f"unknown inference config field {key!r}")
        for key, default in INERT_FIELDS.items():
            if getattr(self, key) != default:
                raise _unported(f"inference config field {key}="
                                f"{getattr(self, key)!r} (only {default!r} "
                                "is accepted)", _INERT_ITEM)
        if self.tensor_parallel.tp_size != 1:
            raise _unported(f"tensor_parallel.tp_size="
                            f"{self.tensor_parallel.tp_size}",
                            UNPORTED_FIELDS["mesh"])
        name = str(self.dtype).lower().replace("torch.", "")
        name = _DTYPE_ALIASES.get(name, name)
        if name == "int8":
            # int8 weight quantization with half-precision compute
            self.quant.enabled = True
            name = "bfloat16"
        if name not in FLOAT_DTYPES:
            raise ValueError(f"unsupported dtype {name!r}; pick one of "
                             f"{FLOAT_DTYPES + ('int8',)}")
        object.__setattr__(self, "dtype", name)
        if self.quant.num_bits not in (8, 4) or self.quant.group_size < 1:
            raise ValueError(f"unsupported quant section {self.quant}: "
                             "num_bits is 8 or 4, group_size at least 1")
        kv = str(self.kv_cache_dtype).lower().replace("torch.", "")
        kv = _KV_ALIASES.get(kv, kv)
        if kv not in FLOAT_DTYPES + KV_QUANT_DTYPES:
            raise ValueError(f"unsupported kv_cache_dtype {kv!r}; pick one "
                             f"of {FLOAT_DTYPES + KV_QUANT_DTYPES}")
        object.__setattr__(self, "kv_cache_dtype", kv)
        if self.paged_kernel not in ("auto", "force"):
            raise ValueError(
                f"unsupported paged_kernel {self.paged_kernel!r}; pick "
                "'auto' or 'force' (the port has no reference pin: CPU "
                "tensors run the plain version, CUDA tensors the kernel)")
