"""Int8Array — int8 weights (weight-only, or with dynamic or static int8
activations).

PyTorch port of ``ao_tpu/quantization/qarrays/int8.py``. Weights are (K, N)
(= (in, out)); MoE stacks experts as (E, K, N). ``block_size`` is
rank-matched: per output channel (K, 1), groupwise (g, 1) along the
contraction dim. qdata and qparams are the reference's bit for bit; qdata is
stored column-major (``common.col_major``: same logical shape and values),
so the int8 GEMMs take it with no copy per call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ao_tpu_torch.quantization import primitives as P
from ao_tpu_torch.quantization.qarrays.base import QuantizedArray, meta, qarray_dataclass
from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec, col_major


@qarray_dataclass
class Int8Array(QuantizedArray):
    qdata: torch.Tensor  # int8, the hp weight's shape, stored column-major
    scale: torch.Tensor  # f32, rank-preserved reduced shape
    zero_point: Optional[torch.Tensor]  # int32, or None (symmetric)
    # static activation qparams from calibration (or None)
    act_scale: Optional[torch.Tensor]
    act_zero_point: Optional[torch.Tensor]
    # AWQ/SmoothQuant per-K-channel activation pre-scale (or None)
    act_pre_scale: Optional[torch.Tensor]
    block_size: Tuple[int, ...] = meta(default=())
    act_quant: Optional[ActQuantSpec] = meta(default=None)
    _shape: Tuple[int, ...] = meta(default=())
    _dequant_dtype: str = meta(default="bfloat16")

    QDATA_COL_MAJOR = True

    @classmethod
    def from_hp(
        cls,
        hp: torch.Tensor,
        block_size: Tuple[int, ...],
        mapping_type: P.MappingType = P.MappingType.SYMMETRIC,
        act_quant: Optional[ActQuantSpec] = None,
        act_scale: Optional[torch.Tensor] = None,
        act_zero_point: Optional[torch.Tensor] = None,
        act_pre_scale: Optional[torch.Tensor] = None,
        dequant_dtype: str = "bfloat16",
    ) -> "Int8Array":
        scale, zp = P.choose_qparams_affine(hp, mapping_type, block_size, target_dtype="int8")
        q = P.quantize_affine(hp, block_size, scale, zp, quant_min=-128, quant_max=127,
                              output_dtype=torch.int8)
        if mapping_type is not P.MappingType.ASYMMETRIC:
            zp = None  # the symmetric zero point is the constant mid point 0
        return cls(
            qdata=col_major(q),
            scale=scale,
            zero_point=zp,
            act_scale=act_scale,
            act_zero_point=act_zero_point,
            act_pre_scale=act_pre_scale,
            block_size=tuple(block_size),
            act_quant=act_quant,
            _shape=tuple(hp.shape),
            _dequant_dtype=dequant_dtype,
        )

    def dequantize(self, output_dtype=None) -> torch.Tensor:
        out_dtype = output_dtype or self.dtype
        return P.dequantize_affine(self.qdata, self.block_size, self.scale, self.zero_point,
                                   output_dtype=out_dtype)
