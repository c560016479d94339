"""Float8Array — fp8 (e4m3 / e5m2) weights with blockwise scales.

PyTorch port of ``ao_tpu/quantization/qarrays/float8.py``. Scales keep the
rank-preserved reduced shape of ``block_size``: PerTensor (1, 1); per output
channel ("rowwise" in torchao's terms: one scale per column of the (K, N)
weight) (1, N); DeepSeek-style blockwise (K/128, N/128) for weights and
(M, K/128) for activations. qdata and scales are the reference's bit for
bit; qdata is stored column-major (``common.col_major``), the layout
``torch._scaled_mm`` and the blockwise kernel K17 read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ao_tpu_torch.quantization import primitives as P
from ao_tpu_torch.quantization.qarrays.base import QuantizedArray, meta, qarray_dataclass
from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec, col_major


@qarray_dataclass
class Float8Array(QuantizedArray):
    qdata: torch.Tensor  # fp8, the hp weight's shape, stored column-major
    scale: torch.Tensor  # f32, rank-preserved
    act_scale: Optional[torch.Tensor]  # static (calibrated) activation scale, or None
    act_pre_scale: Optional[torch.Tensor]  # AWQ/SmoothQuant per-K pre-scale
    block_size: Tuple[int, ...] = meta(default=())
    act_quant: Optional[ActQuantSpec] = meta(default=None)
    _shape: Tuple[int, ...] = meta(default=())
    _dequant_dtype: str = meta(default="bfloat16")

    QDATA_COL_MAJOR = True

    @property
    def float8_dtype(self) -> torch.dtype:
        return self.qdata.dtype

    @classmethod
    def from_hp(
        cls,
        hp: torch.Tensor,
        block_size: Tuple[int, ...],
        float8_dtype=torch.float8_e4m3fn,
        act_quant: Optional[ActQuantSpec] = None,
        act_scale: Optional[torch.Tensor] = None,
        act_pre_scale: Optional[torch.Tensor] = None,
        value_lb: Optional[float] = None,
        value_ub: Optional[float] = None,
        dequant_dtype: str = "bfloat16",
    ) -> "Float8Array":
        scale = P.choose_scale_float8(hp, block_size, float8_dtype, value_lb=value_lb,
                                      value_ub=value_ub)
        q = P.quantize_float8(hp, block_size, scale, float8_dtype)
        return cls(
            qdata=col_major(q),
            scale=scale,
            act_scale=act_scale,
            act_pre_scale=act_pre_scale,
            block_size=tuple(block_size),
            act_quant=act_quant,
            _shape=tuple(hp.shape),
            _dequant_dtype=dequant_dtype,
        )

    def dequantize(self, output_dtype=None) -> torch.Tensor:
        out_dtype = output_dtype or self.dtype
        return P.dequantize_float8(self.qdata, self.block_size, self.scale,
                                   output_dtype=out_dtype)
