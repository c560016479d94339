from ao_tpu_torch.quantization.qarrays.base import QuantizedArray, get_qarray_class
from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec, KernelPreference
from ao_tpu_torch.quantization.qarrays.float8 import Float8Array
from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
from ao_tpu_torch.quantization.qarrays.int8 import Int8Array

__all__ = ["ActQuantSpec", "Float8Array", "Int4Array", "Int8Array", "KernelPreference",
           "QuantizedArray", "get_qarray_class"]
