"""ao_tpu_torch — the PyTorch and CUDA port of ``ao_tpu`` for NVIDIA Hopper.

The JAX package ``ao_tpu`` is the reference; this package keeps its module
paths, names and data model (nested-dict params, (K, N) weights, the same
quantized containers), and runs its hot ops through kernels written by hand
for sm_90a (``ops/hopper``, sources in ``csrc``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from ao_tpu_torch.core.config import AOBaseConfig
from ao_tpu_torch.quantization.configs import (
    Float8DynamicActivationFloat8WeightConfig, Float8DynamicActivationInt4WeightConfig,
    Float8StaticActivationFloat8WeightConfig, Float8WeightOnlyConfig, FqnToConfig,
    Int4WeightOnlyConfig, Int8DynamicActivationInt4WeightConfig,
    Int8DynamicActivationInt8WeightConfig, Int8StaticActivationInt8WeightConfig,
    Int8WeightOnlyConfig, NF4WeightOnlyConfig,
)
from ao_tpu_torch.prototype.mx import (
    MXDynamicActivationMXWeightConfig, MXWeightOnlyConfig,
    NVFP4DynamicActivationNVFP4WeightConfig, NVFP4WeightOnlyConfig,
)
from ao_tpu_torch.quantization.granularity import (
    PerAxis, PerBlock, PerGroup, PerRow, PerTensor, PerToken,
)
from ao_tpu_torch.quantization.primitives import MappingType, ZeroPointDomain, compute_error
from ao_tpu_torch.quantization.qarrays.float8 import Float8Array
from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
from ao_tpu_torch.quantization.qarrays.int8 import Int8Array
from ao_tpu_torch.quantization.qarrays.mx import MXArray
from ao_tpu_torch.quantization.qarrays.nf4 import NF4Array
from ao_tpu_torch.quantization.qarrays.nvfp4 import NVFP4Array
from ao_tpu_torch.quantization.quantize import quantize_, quantize_params
from ao_tpu_torch.ops.linear import linear
from ao_tpu_torch.models import llama, sam, vit
from ao_tpu_torch.serving.decode import generate
from ao_tpu_torch.serving.engine import Engine, Request, ServeConfig
from ao_tpu_torch.serving.kvcache import QuantKVCache, init_quant_kv_caches
from ao_tpu_torch.serving.paged import PageAllocator, PagedKVPool
from ao_tpu_torch.sparsity import (
    BlockSparseArray, BlockSparseWeightConfig, SemiSparseWeightConfig, Sparse24Array,
    Sparse24Int4Array, Sparse24Int4WeightConfig, WandaSparseConfig, sparsify_,
)

__all__ = [
    "AOBaseConfig",
    "BlockSparseArray",
    "BlockSparseWeightConfig",
    "Engine",
    "Float8Array",
    "Float8DynamicActivationFloat8WeightConfig",
    "Float8DynamicActivationInt4WeightConfig",
    "Float8StaticActivationFloat8WeightConfig",
    "Float8WeightOnlyConfig",
    "FqnToConfig",
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
    "PageAllocator",
    "PagedKVPool",
    "PerAxis",
    "PerBlock",
    "PerGroup",
    "PerRow",
    "PerTensor",
    "PerToken",
    "QuantKVCache",
    "Request",
    "SemiSparseWeightConfig",
    "ServeConfig",
    "Sparse24Array",
    "Sparse24Int4Array",
    "Sparse24Int4WeightConfig",
    "WandaSparseConfig",
    "ZeroPointDomain",
    "compute_error",
    "generate",
    "init_quant_kv_caches",
    "linear",
    "llama",
    "quantize_",
    "quantize_params",
    "sam",
    "sparsify_",
    "vit",
]
