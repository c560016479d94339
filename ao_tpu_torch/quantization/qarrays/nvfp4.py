"""NVFP4Array — fp4 e2m1 with fp8-e4m3 block scales (block 16) and an
optional f32 per-tensor scale (two-level scaling).

PyTorch port of ``ao_tpu/quantization/qarrays/nvfp4.py``, bit for bit. A 2-D
weight blocked along K with K % 64 == 0 keeps its codes as "fp4 magic"
int32 words (K/8, N) and its block scales pre-packed as int32 pair-words
(K/32, N), the operands of the Hopper kernel K14; other shapes keep
split-half bytes and raw e4m3 scales (K/16, N).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ao_tpu_torch.quantization import primitives as P
from ao_tpu_torch.quantization.qarrays.base import QuantizedArray, meta, qarray_dataclass
from ao_tpu_torch.quantization.qarrays.fp4 import (
    F4_E2M1_MAX, decode_fp4_e2m1, encode_fp4_e2m1, pack_fp4, pack_fp4_magic,
    pack_nvfp4_scale_pairs, unpack_fp4, unpack_fp4_magic, unpack_nvfp4_scale_pairs,
)

NVFP4_BLOCK = 16
_E4M3_MAX = 448.0


def nvfp4_quantize(
    x: torch.Tensor,
    block_size: Tuple[int, ...],
    per_tensor: bool = True,
    fixed_per_tensor_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Returns (codes (unpacked uint8), block scale fp8-e4m3, per-tensor scale).

    Two levels: total_scale = block_scale(e4m3) * per_tensor_scale(f32);
    block_scale = amax_block / 6 / per_tensor_scale, rounded by the e4m3
    cast. A calibrated ``fixed_per_tensor_scale`` overrides the
    amax-derived one."""
    xf = x.to(torch.float32)
    amax = P.block_reduce(xf, block_size, "absmax")
    if fixed_per_tensor_scale is not None:
        pts = fixed_per_tensor_scale.to(torch.float32)
    elif per_tensor:
        pts = torch.clamp(torch.amax(torch.abs(xf)) / (_E4M3_MAX * F4_E2M1_MAX), min=1e-12)
    else:
        pts = None
    bs = amax / F4_E2M1_MAX
    if pts is not None:
        bs = bs / pts
    bs_e4m3 = torch.clamp(bs, 1e-12, _E4M3_MAX).to(torch.float8_e4m3fn)
    total = bs_e4m3.to(torch.float32)
    if pts is not None:
        total = total * pts
    v = P.apply_blockwise(
        xf, block_size,
        lambda xb, s: torch.clamp(xb / torch.clamp(s, min=1e-12), -F4_E2M1_MAX, F4_E2M1_MAX),
        total)
    return encode_fp4_e2m1(v), bs_e4m3, pts


@qarray_dataclass
class NVFP4Array(QuantizedArray):
    qdata: torch.Tensor  # fp4 magic words int32 (K/8, N), or split-half bytes uint8 (K/2, N)
    scale: torch.Tensor  # int32 pair-words (K/32, N) with magic, else e4m3 (K/16, N)
    per_tensor_scale: Optional[torch.Tensor]  # f32 scalar () or None
    act_per_tensor_scale: Optional[torch.Tensor]  # calibrated activation scale or None
    block_size: Tuple[int, ...] = meta(default=())
    act_quant: bool = meta(default=False)  # dynamic nvfp4 activation quant
    _shape: Tuple[int, ...] = meta(default=())
    _dequant_dtype: str = meta(default="bfloat16")

    @classmethod
    def from_hp(
        cls,
        hp: torch.Tensor,
        block_dim: int = -2,
        per_tensor: bool = True,
        act_quant: bool = False,
        act_per_tensor_scale: Optional[torch.Tensor] = None,
        fixed_per_tensor_scale: Optional[torch.Tensor] = None,
        dequant_dtype: str = "bfloat16",
    ) -> "NVFP4Array":
        rank = hp.ndim
        block_dim = block_dim % rank
        if hp.shape[block_dim] % NVFP4_BLOCK != 0:
            raise ValueError(f"dim {block_dim} not divisible by 16")
        block_size = tuple(NVFP4_BLOCK if i == block_dim else 1 for i in range(rank))
        codes, bscale, pts = nvfp4_quantize(hp, block_size, per_tensor,
                                            fixed_per_tensor_scale=fixed_per_tensor_scale)
        if rank == 2 and block_dim == rank - 2 and hp.shape[-2] % 64 == 0:
            qdata = pack_fp4_magic(codes)
            bscale = pack_nvfp4_scale_pairs(bscale)
        else:
            qdata = pack_fp4(codes, NVFP4_BLOCK, axis=block_dim)
        return cls(
            qdata=qdata,
            scale=bscale,
            per_tensor_scale=pts,
            act_per_tensor_scale=act_per_tensor_scale,
            block_size=block_size,
            act_quant=act_quant,
            _shape=tuple(hp.shape),
            _dequant_dtype=dequant_dtype,
        )

    @property
    def layout(self) -> str:
        return "magic" if self.qdata.dtype == torch.int32 else "halves"

    def unpack(self) -> torch.Tensor:
        """e2m1 codes 0..15, logical shape."""
        if self.layout == "magic":
            return unpack_fp4_magic(self.qdata)
        return unpack_fp4(self.qdata, NVFP4_BLOCK, axis=self.block_size.index(NVFP4_BLOCK))

    def block_scale_e4m3(self) -> torch.Tensor:
        """The (K/16, N) e4m3 block scales, unpacked from pair-words if so stored."""
        if self.scale.dtype == torch.int32:
            return unpack_nvfp4_scale_pairs(self.scale)
        return self.scale

    def dequantize(self, output_dtype=None) -> torch.Tensor:
        out_dtype = output_dtype or self.dtype
        v = decode_fp4_e2m1(self.unpack(), torch.float32)
        scale_f = self.block_scale_e4m3().to(torch.float32)
        if self.per_tensor_scale is not None:
            scale_f = scale_f * self.per_tensor_scale
        out = P.apply_blockwise(v, self.block_size, lambda vb, s: vb * s, scale_f)
        return out.to(out_dtype)
