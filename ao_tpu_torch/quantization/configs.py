"""Inference workflow configs — the user API surface.

PyTorch port of ``ao_tpu/quantization/configs.py`` up to ``FqnToConfig``:
int4 weight-only, W4A8 and fp8-activation int4; int8 weight-only, dynamic
and static int8 activations; fp8 weight-only, dynamic fp8 activations
(PerRow, PerTensor, PerBlock) and static fp8 activations; NF4 weight-only.
Each config has a registered handler ``(weight, config) -> QuantizedArray``.
The MX and NVFP4 configs are in ``ao_tpu_torch/prototype/mx.py``.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Dict, Optional, Tuple

import torch

from ao_tpu_torch.core.config import AOBaseConfig
from ao_tpu_torch.core.registry import register_quantize_handler
from ao_tpu_torch.quantization import primitives as P
from ao_tpu_torch.quantization.granularity import (
    Granularity, PerAxis, PerBlock, PerGroup, PerRow, PerTensor, get_block_size,
)
from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec, canon_dtype
from ao_tpu_torch.quantization.qarrays.float8 import Float8Array
from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
from ao_tpu_torch.quantization.qarrays.int8 import Int8Array
from ao_tpu_torch.quantization.qarrays.nf4 import NF4Array


def _weight_block_size(shape, granularity: Optional[Granularity]) -> Tuple[int, ...]:
    """Map a granularity onto the (K, N) weight layout: "per channel" or
    "per row" in the reference's terms is one scale per *output* channel,
    axis -1 (N) here, so the block covers all of K. (ref: ao_tpu
    configs.py:37)"""
    rank = len(shape)
    if isinstance(granularity, PerAxis):
        # an explicit axis maps as it is (PerAxis(0) on an embedding table
        # (V, D): per-row scales)
        return get_block_size(shape, granularity)
    if isinstance(granularity, PerRow) or granularity is None:
        return (1,) * (rank - 2) + (shape[-2], 1)
    if isinstance(granularity, PerTensor):
        return tuple(shape)
    if isinstance(granularity, PerGroup):
        return (1,) * (rank - 2) + (granularity.group_size, 1)
    if isinstance(granularity, PerBlock):
        return get_block_size(shape, granularity)
    raise ValueError(f"unsupported weight granularity {granularity}")


@dataclasses.dataclass
class Int4WeightOnlyConfig(AOBaseConfig):
    """(ref: ao_tpu configs.py:65)"""

    group_size: int = 128
    # qparams algorithm: "tinygemm" (float-zp asymmetric) | "hqq" | "minmax_int"
    int4_choose_qparams_algorithm: str = "tinygemm"
    version: int = 1


def _skip_indivisible(weight, group_size, cfg_name):
    """Skip (with a warning) rather than raise when K doesn't divide into
    groups, as the reference does."""
    if weight.ndim < 2 or weight.shape[-2] % group_size:
        warnings.warn(
            f"{cfg_name}: skipping weight {tuple(weight.shape)} — K not a "
            f"multiple of group_size={group_size}"
        )
        return True
    return False


@register_quantize_handler(Int4WeightOnlyConfig)
def _int4_wo_transform(weight: torch.Tensor, config: Int4WeightOnlyConfig):
    if _skip_indivisible(weight, config.group_size, "Int4WeightOnlyConfig"):
        return weight
    algo = config.int4_choose_qparams_algorithm
    if algo == "hqq":
        return Int4Array.from_hp(
            weight, group_size=config.group_size, algorithm="hqq",
            zero_point_domain=P.ZeroPointDomain.FLOAT,
        )
    if algo == "tinygemm":
        return Int4Array.from_hp(
            weight, group_size=config.group_size,
            zero_point_domain=P.ZeroPointDomain.FLOAT,
        )
    if algo == "minmax_int":
        return Int4Array.from_hp(
            weight, group_size=config.group_size,
            zero_point_domain=P.ZeroPointDomain.INT,
            mapping_type=P.MappingType.ASYMMETRIC,
        )
    raise ValueError(algo)


@dataclasses.dataclass
class Float8DynamicActivationInt4WeightConfig(AOBaseConfig):
    """fp8 dynamic per-token activations x int4 groupwise weights.
    (ref: ao_tpu configs.py:114; the activation is held to its fp8 values
    and the dot runs the int4 weight-only path, as in the reference)"""

    group_size: int = 128
    version: int = 1


@register_quantize_handler(Float8DynamicActivationInt4WeightConfig)
def _fp8_int4_transform(weight: torch.Tensor, config: Float8DynamicActivationInt4WeightConfig):
    if _skip_indivisible(weight, config.group_size, "Float8DynamicActivationInt4WeightConfig"):
        return weight
    return Int4Array.from_hp(
        weight, group_size=config.group_size,
        zero_point_domain=P.ZeroPointDomain.FLOAT,
        act_quant=ActQuantSpec(dtype="float8_e4m3fn", granularity="per_token"),
    )


@dataclasses.dataclass
class Int8DynamicActivationInt4WeightConfig(AOBaseConfig):
    """int8 dynamic per-token activations x int4 groupwise weights (W4A8).
    (ref: ao_tpu configs.py:137; the weights take the two-plane "magic8"
    layout, whose planes feed the s8 tensor cores directly,
    ops/hopper/int4_matmul.py)"""

    group_size: int = 128
    version: int = 1


@register_quantize_handler(Int8DynamicActivationInt4WeightConfig)
def _int8_int4_transform(weight: torch.Tensor, config: Int8DynamicActivationInt4WeightConfig):
    if _skip_indivisible(weight, config.group_size, "Int8DynamicActivationInt4WeightConfig"):
        return weight
    return Int4Array.from_hp(
        weight, group_size=config.group_size,
        zero_point_domain=P.ZeroPointDomain.FLOAT,
        act_quant=ActQuantSpec(dtype="int8", granularity="per_token", symmetric=True),
    )


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Int8WeightOnlyConfig(AOBaseConfig):
    """(ref: ao_tpu configs.py:168)"""

    granularity: Optional[Granularity] = None  # default: per output channel
    version: int = 1


@register_quantize_handler(Int8WeightOnlyConfig)
def _int8_wo_transform(weight: torch.Tensor, config: Int8WeightOnlyConfig):
    bs = _weight_block_size(weight.shape, config.granularity)
    return Int8Array.from_hp(weight, bs, P.MappingType.SYMMETRIC)


@dataclasses.dataclass
class Int8DynamicActivationInt8WeightConfig(AOBaseConfig):
    """int8 per-token dynamic activations x int8 per-channel weights (W8A8).
    (ref: ao_tpu configs.py:182)"""

    granularity: Optional[Granularity] = None
    act_symmetric: bool = True
    version: int = 1


@register_quantize_handler(Int8DynamicActivationInt8WeightConfig)
def _int8_dyn_transform(weight: torch.Tensor, config: Int8DynamicActivationInt8WeightConfig):
    bs = _weight_block_size(weight.shape, config.granularity)
    spec = ActQuantSpec(dtype="int8", symmetric=config.act_symmetric, granularity="per_token")
    return Int8Array.from_hp(weight, bs, P.MappingType.SYMMETRIC, act_quant=spec)


@dataclasses.dataclass
class Int8StaticActivationInt8WeightConfig(AOBaseConfig):
    """A static per-tensor activation scale from calibration.
    (ref: ao_tpu configs.py:202)"""

    act_scale: Optional[float] = None
    act_zero_point: Optional[int] = None
    granularity: Optional[Granularity] = None
    version: int = 1


@register_quantize_handler(Int8StaticActivationInt8WeightConfig)
def _int8_static_transform(weight: torch.Tensor, config: Int8StaticActivationInt8WeightConfig):
    if config.act_scale is None:
        raise ValueError("act_scale required (run calibration first)")
    bs = _weight_block_size(weight.shape, config.granularity)
    return Int8Array.from_hp(
        weight, bs, P.MappingType.SYMMETRIC,
        act_scale=torch.tensor(config.act_scale, dtype=torch.float32, device=weight.device),
        act_zero_point=(
            torch.tensor(config.act_zero_point, dtype=torch.int32, device=weight.device)
            if config.act_zero_point is not None else None),
    )


# ---------------------------------------------------------------------------
# float8
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Float8WeightOnlyConfig(AOBaseConfig):
    """(ref: ao_tpu configs.py:231)"""

    granularity: Optional[Granularity] = None
    float8_dtype: str = "float8_e4m3fn"
    version: int = 1


@register_quantize_handler(Float8WeightOnlyConfig)
def _fp8_wo_transform(weight: torch.Tensor, config: Float8WeightOnlyConfig):
    bs = _weight_block_size(weight.shape, config.granularity)
    return Float8Array.from_hp(weight, bs, canon_dtype(config.float8_dtype))


@dataclasses.dataclass
class Float8DynamicActivationFloat8WeightConfig(AOBaseConfig):
    """fp8 dynamic activations x fp8 weights. granularity:
      * PerRow (default): per-token activation scales x per-output-channel
        weight scales
      * PerTensor: one scale each
      * PerBlock((128, 128)): DeepSeek-style 1 x 128 activation and
        128 x 128 weight blocks
    (ref: ao_tpu configs.py:249)"""

    granularity: Optional[Granularity] = None
    float8_dtype: str = "float8_e4m3fn"
    activation_value_lb: Optional[float] = None
    activation_value_ub: Optional[float] = None
    version: int = 1


@register_quantize_handler(Float8DynamicActivationFloat8WeightConfig)
def _fp8_dyn_transform(weight: torch.Tensor, config: Float8DynamicActivationFloat8WeightConfig):
    g = config.granularity
    if isinstance(g, PerBlock):
        bs = get_block_size(weight.shape, g)
        act_gran = f"per_group:{bs[-2]}"  # 1 x blockK activation scales
    elif isinstance(g, PerTensor):
        bs = tuple(weight.shape)
        act_gran = "per_tensor"
    else:  # PerRow, the default
        bs = _weight_block_size(weight.shape, PerRow())
        act_gran = "per_token"
    spec = ActQuantSpec(dtype=config.float8_dtype, granularity=act_gran,
                        value_lb=config.activation_value_lb,
                        value_ub=config.activation_value_ub)
    return Float8Array.from_hp(weight, bs, canon_dtype(config.float8_dtype), act_quant=spec)


@dataclasses.dataclass
class Float8StaticActivationFloat8WeightConfig(AOBaseConfig):
    """A static per-tensor fp8 activation scale from calibration.
    (ref: ao_tpu configs.py:283)"""

    act_scale: Optional[float] = None
    granularity: Optional[Granularity] = None
    float8_dtype: str = "float8_e4m3fn"
    version: int = 1


@register_quantize_handler(Float8StaticActivationFloat8WeightConfig)
def _fp8_static_transform(weight: torch.Tensor,
                          config: Float8StaticActivationFloat8WeightConfig):
    if config.act_scale is None:
        raise ValueError("act_scale required (run calibration first)")
    bs = _weight_block_size(weight.shape, config.granularity)
    return Float8Array.from_hp(
        weight, bs, canon_dtype(config.float8_dtype),
        act_scale=torch.tensor(config.act_scale, dtype=torch.float32, device=weight.device),
    )


@dataclasses.dataclass
class NF4WeightOnlyConfig(AOBaseConfig):
    """4-bit NormalFloat (QLoRA). (ref: ao_tpu configs.py:391)"""

    block_size: int = 64
    scaler_block_size: int = 256
    version: int = 1


@register_quantize_handler(NF4WeightOnlyConfig)
def _nf4_transform(weight: torch.Tensor, config: NF4WeightOnlyConfig):
    return NF4Array.from_hp(weight, config.block_size, config.scaler_block_size)


# ---------------------------------------------------------------------------
# per-path routing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FqnToConfig(AOBaseConfig):
    """Route configs per parameter path, with regex support and ``_default``.

    Precedence: exact path > regex match > ``_default``.
    (ref: ao_tpu configs.py:316)
    """

    fqn_to_config: Dict[str, Optional[AOBaseConfig]] = dataclasses.field(
        default_factory=dict
    )
    version: int = 1

    def lookup(self, fqn: str) -> Optional[AOBaseConfig]:
        if fqn in self.fqn_to_config:
            return self.fqn_to_config[fqn]
        for pat, cfg in self.fqn_to_config.items():
            if pat == "_default":
                continue
            if pat.startswith("re:") and re.fullmatch(pat[3:], fqn):
                return cfg
        return self.fqn_to_config.get("_default")
