from ao_tpu_torch.quantization.configs import (
    Float8DynamicActivationFloat8WeightConfig, Float8DynamicActivationInt4WeightConfig,
    Float8StaticActivationFloat8WeightConfig, Float8WeightOnlyConfig, FqnToConfig,
    Int4WeightOnlyConfig, Int8DynamicActivationInt4WeightConfig,
    Int8DynamicActivationInt8WeightConfig, Int8StaticActivationInt8WeightConfig,
    Int8WeightOnlyConfig, NF4WeightOnlyConfig,
)
from ao_tpu_torch.quantization.granularity import (
    Granularity, PerAxis, PerBlock, PerGroup, PerRow, PerTensor, PerToken, get_block_size,
)
from ao_tpu_torch.quantization.primitives import MappingType, ZeroPointDomain, compute_error
from ao_tpu_torch.quantization.qarrays.float8 import Float8Array
from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
from ao_tpu_torch.quantization.qarrays.int8 import Int8Array
from ao_tpu_torch.quantization.qarrays.mx import MXArray
from ao_tpu_torch.quantization.qarrays.nf4 import NF4Array
from ao_tpu_torch.quantization.qarrays.nvfp4 import NVFP4Array
from ao_tpu_torch.quantization.quantize import default_filter, quantize_, quantize_params

__all__ = [
    "Float8Array",
    "Float8DynamicActivationFloat8WeightConfig",
    "Float8DynamicActivationInt4WeightConfig",
    "Float8StaticActivationFloat8WeightConfig",
    "Float8WeightOnlyConfig",
    "FqnToConfig",
    "Granularity",
    "Int4Array",
    "Int4WeightOnlyConfig",
    "Int8Array",
    "Int8DynamicActivationInt4WeightConfig",
    "Int8DynamicActivationInt8WeightConfig",
    "Int8StaticActivationInt8WeightConfig",
    "Int8WeightOnlyConfig",
    "MXArray",
    "MXDynamicActivationMXWeightConfig",
    "MXWeightOnlyConfig",
    "MappingType",
    "NF4Array",
    "NF4WeightOnlyConfig",
    "NVFP4Array",
    "NVFP4DynamicActivationNVFP4WeightConfig",
    "NVFP4WeightOnlyConfig",
    "PerAxis",
    "PerBlock",
    "PerGroup",
    "PerRow",
    "PerTensor",
    "PerToken",
    "ZeroPointDomain",
    "compute_error",
    "default_filter",
    "get_block_size",
    "quantize_",
    "quantize_params",
]

# the MX and NVFP4 configs (imported last: prototype.mx imports the
# containers above)
from ao_tpu_torch.prototype.mx import (  # noqa: E402
    MXDynamicActivationMXWeightConfig, MXWeightOnlyConfig,
    NVFP4DynamicActivationNVFP4WeightConfig, NVFP4WeightOnlyConfig,
)
