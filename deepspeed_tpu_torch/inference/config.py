"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``).

The same pydantic surface for the fields this port runs — ``dtype``,
``kv_cache_dtype``, ``max_out_tokens``, ``paged_kernel``,
``replace_with_kernel_inject`` and ``tensor_parallel`` (tp_size 1) —
plus ``device``.  A field the JAX
package accepts but the port does not run yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` item; any other
unknown field raises ``ValueError``.  Nothing is accepted and ignored.
"""

from typing import Any, Optional

from pydantic import BaseModel, ConfigDict, Field

# JAX-package config fields the port does not run yet -> ROADMAP.md item
UNPORTED_FIELDS = {
    "quant": "Queue A2 (weight-only int8 serving, kernel B7)",
    "enable_cuda_graph": "Queue A5 (overlap and CUDA-graph horizons)",
    "mesh": "Queue A10 (multi-GPU serving)",
    "mesh_dcn": "Queue A10 (multi-GPU serving)",
    "moe": "Queue A10 (MoE serving)",
    "checkpoint": "Queue A8 (checkpoint and HF ingestion)",
    "checkpoint_engine": "Queue A8 (checkpoint and HF ingestion)",
    "zero": "Queue A10 (ZeRO-Inference offload)",
}

_DTYPE_ALIASES = {"half": "float16", "fp16": "float16", "bf16": "bfloat16",
                  "float": "float32", "fp32": "float32"}
FLOAT_DTYPES = ("float32", "bfloat16", "float16")


class DeepSpeedTPConfig(BaseModel):
    model_config = ConfigDict(extra="forbid")
    tp_size: int = 1


def _unported(what, item):
    return NotImplementedError(f"{what} is not ported to the PyTorch "
                               f"package yet: see ROADMAP.md {item}")


class DeepSpeedInferenceConfig(BaseModel):
    model_config = ConfigDict(extra="allow", populate_by_name=True)

    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"
    max_out_tokens: int = Field(1024, alias="max_tokens")
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
    # None -> CUDA (raises when no card is visible); "cpu" runs the
    # plain PyTorch versions of the kernels on the host
    device: Optional[Any] = None

    def model_post_init(self, _ctx):
        for key in self.model_extra or {}:
            if key in UNPORTED_FIELDS:
                raise _unported(f"inference config field {key!r}",
                                UNPORTED_FIELDS[key])
            raise ValueError(f"unknown inference config field {key!r}")
        if self.tensor_parallel.tp_size != 1:
            raise _unported(f"tensor_parallel.tp_size="
                            f"{self.tensor_parallel.tp_size}",
                            UNPORTED_FIELDS["mesh"])
        for field, item in (("dtype", "Queue A2 (weight-only int8 serving,"
                             " kernel B7)"),
                            ("kv_cache_dtype", "Queue A1 (quantized paged "
                             "KV, kernel B6)")):
            name = str(getattr(self, field)).lower().replace("torch.", "")
            name = _DTYPE_ALIASES.get(name, name)
            if name in ("int8", "fp8", "float8", "float8_e4m3fn"):
                raise _unported(f"{field}={name!r}", item)
            if name not in FLOAT_DTYPES:
                raise ValueError(f"unsupported {field} {name!r}; pick one "
                                 f"of {FLOAT_DTYPES}")
            object.__setattr__(self, field, name)
        if self.paged_kernel not in ("auto", "force"):
            raise ValueError(
                f"unsupported paged_kernel {self.paged_kernel!r}; pick "
                "'auto' or 'force' (the port has no reference pin: CPU "
                "tensors run the plain version, CUDA tensors the kernel)")
