"""Quantized frozen backbone (port of `repro.quant`): the QTensor leaf,
per-channel symmetric int8 / fp8 quantization of the backbone's matmul
projections, and `qdense`, which routes a QTensor weight through the
dequant-matmul kernel (`kernels/quant.py`), and the activation-statistics
calibration pass (`calibrate`) whose statistics pick each leaf's clip.
Serving consumes it as `ServeEngine(..., quant="int8")`, QPEFT training as
`train.steps.make_state(..., quant=..., quant_stats=...)`."""
from repro_torch.quant.calibrate import calibrate, collect_stats
from repro_torch.quant.qtensor import (
    QTensor,
    QUANT_MODES,
    QUANT_PATTERNS,
    dequantize_tree,
    fake_quantize,
    is_qtensor,
    qdense,
    quant_summary,
    quantization_error,
    quantize,
    quantize_owned,
    quantize_tree,
)

__all__ = [
    "QTensor",
    "QUANT_MODES",
    "QUANT_PATTERNS",
    "calibrate",
    "collect_stats",
    "dequantize_tree",
    "fake_quantize",
    "is_qtensor",
    "qdense",
    "quant_summary",
    "quantization_error",
    "quantize",
    "quantize_owned",
    "quantize_tree",
]
