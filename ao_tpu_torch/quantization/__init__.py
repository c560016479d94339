from ao_tpu_torch.quantization.configs import (
    FqnToConfig, Int4WeightOnlyConfig, Int8DynamicActivationInt4WeightConfig,
)
from ao_tpu_torch.quantization.primitives import MappingType, ZeroPointDomain, compute_error
from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
from ao_tpu_torch.quantization.quantize import default_filter, quantize_, quantize_params

__all__ = [
    "FqnToConfig",
    "Int4Array",
    "Int4WeightOnlyConfig",
    "Int8DynamicActivationInt4WeightConfig",
    "MappingType",
    "ZeroPointDomain",
    "compute_error",
    "default_filter",
    "quantize_",
    "quantize_params",
]
