from deepspeed_tpu_torch.ops.quant.kernels import (  # noqa: F401
    int8_matmul, int8_matmul_plain)
from deepspeed_tpu_torch.ops.quant.kv import (  # noqa: F401
    KV_QUANT_DTYPES, dequantize_kv_rows, is_quantized_kv, kv_dtype_name,
    kv_page_bytes, paged_gather, paged_pool_layer, paged_write,
    quantize_kv_rows, sink_page)
from deepspeed_tpu_torch.ops.quant.qdense import (  # noqa: F401
    QDense, quant_matmul)
from deepspeed_tpu_torch.ops.quant.quantizer import (  # noqa: F401
    QTensor, dequantize, dequantize_tree, quantize, quantize_tree)
