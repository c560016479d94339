from ao_tpu_torch.quantization.qarrays.base import QuantizedArray, get_qarray_class
from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec, KernelPreference
from ao_tpu_torch.quantization.qarrays.float8 import Float8Array
from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
from ao_tpu_torch.quantization.qarrays.int8 import Int8Array
from ao_tpu_torch.quantization.qarrays.mx import MXArray
from ao_tpu_torch.quantization.qarrays.nf4 import NF4Array
from ao_tpu_torch.quantization.qarrays.nvfp4 import NVFP4Array

__all__ = ["ActQuantSpec", "Float8Array", "Int4Array", "Int8Array", "KernelPreference",
           "MXArray", "NF4Array", "NVFP4Array", "QuantizedArray", "get_qarray_class"]
