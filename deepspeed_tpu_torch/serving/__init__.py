"""Continuous-batching serving over a paged KV cache (the scheduler core
of ``deepspeed_tpu/serving``)."""

from deepspeed_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from deepspeed_tpu_torch.serving.page_manager import (  # noqa: F401
    PagedKVManager, PagePool, PagePoolExhausted, default_page_size)
from deepspeed_tpu_torch.serving.scheduler import (  # noqa: F401
    CANCELLED, FAILED, FINISHED, SHED, QueueFull, Request, ServingScheduler)
from deepspeed_tpu_torch.serving.spec_decode import (  # noqa: F401
    Drafter, DraftModelDrafter, NgramDrafter)
