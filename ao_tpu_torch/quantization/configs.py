"""Inference workflow configs — the user API surface.

PyTorch port of the int4 part of ``ao_tpu/quantization/configs.py``
(``Int4WeightOnlyConfig``, ``Int8DynamicActivationInt4WeightConfig``,
``FqnToConfig``). Each config has a registered handler
``(weight, config) -> QuantizedArray``.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Dict, Optional

import torch

from ao_tpu_torch.core.config import AOBaseConfig
from ao_tpu_torch.core.registry import register_quantize_handler
from ao_tpu_torch.quantization import primitives as P
from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec
from ao_tpu_torch.quantization.qarrays.int4 import Int4Array


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
