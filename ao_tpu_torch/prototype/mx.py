"""MX / NVFP4 inference workflow configs.

PyTorch port of ``ao_tpu/prototype/mx.py``: MX weight-only and dynamic
MX-activation configs over ``MXArray``, NVFP4 weight-only and dynamic
NVFP4-activation configs over ``NVFP4Array``, each with its registered
handler.
"""

from __future__ import annotations

import dataclasses

import torch

from ao_tpu_torch.core.config import AOBaseConfig
from ao_tpu_torch.core.registry import register_quantize_handler
from ao_tpu_torch.quantization.qarrays.mx import MXArray
from ao_tpu_torch.quantization.qarrays.nvfp4 import NVFP4Array


@dataclasses.dataclass
class MXWeightOnlyConfig(AOBaseConfig):
    elem_dtype: str = "float8_e4m3fn"  # fp8 / fp6 / fp4 element dtypes
    scale_mode: str = "floor"
    version: int = 1


@register_quantize_handler(MXWeightOnlyConfig)
def _mx_wo_transform(weight: torch.Tensor, config: MXWeightOnlyConfig):
    return MXArray.from_hp(weight, elem_dtype=config.elem_dtype, scale_mode=config.scale_mode)


@dataclasses.dataclass
class MXDynamicActivationMXWeightConfig(AOBaseConfig):
    """MXFP8 / MXFP6 / MXFP4 activations x weights."""

    activation_dtype: str = "float8_e4m3fn"
    weight_dtype: str = "float8_e4m3fn"
    scale_mode: str = "floor"
    version: int = 1


@register_quantize_handler(MXDynamicActivationMXWeightConfig)
def _mx_dyn_transform(weight: torch.Tensor, config: MXDynamicActivationMXWeightConfig):
    return MXArray.from_hp(weight, elem_dtype=config.weight_dtype,
                           act_elem_dtype=config.activation_dtype, scale_mode=config.scale_mode)


@dataclasses.dataclass
class NVFP4WeightOnlyConfig(AOBaseConfig):
    use_per_tensor_scale: bool = True
    version: int = 1


@register_quantize_handler(NVFP4WeightOnlyConfig)
def _nvfp4_wo_transform(weight: torch.Tensor, config: NVFP4WeightOnlyConfig):
    return NVFP4Array.from_hp(weight, per_tensor=config.use_per_tensor_scale)


@dataclasses.dataclass
class NVFP4DynamicActivationNVFP4WeightConfig(AOBaseConfig):
    use_per_tensor_scale: bool = True
    version: int = 1


@register_quantize_handler(NVFP4DynamicActivationNVFP4WeightConfig)
def _nvfp4_dyn_transform(weight: torch.Tensor, config: NVFP4DynamicActivationNVFP4WeightConfig):
    return NVFP4Array.from_hp(weight, per_tensor=config.use_per_tensor_scale, act_quant=True)
