"""MXArray — OCP Microscaling formats (MXFP8 / MXFP6 / MXFP4, e8m0 scales).

PyTorch port of ``ao_tpu/quantization/qarrays/mx.py``. The e8m0 scales are
stored as their biased-exponent uint8 byte with the rank-preserved reduced
shape, as in the reference; a byte b decodes to 2^(b - 127).

Element dtypes:
  * float8_e4m3fn / float8_e5m2 — native fp8 tensors
  * float4_e2m1fn — packed codes: the "fp4 magic" int32 words (K/8, N) for
    a 2-D weight blocked along K with K % 128 == 0 (the Hopper kernel K14
    reads them), else split-half bytes (group 32)
  * float6_e2m3 / float6_e3m2 — 6-bit codes packed 4 values in 3 bytes
    along the block dim (qarrays/fp6.py)
Block size: 32 along the contraction dim (the OCP MX spec).

Powers of two are exact here on every device (``fp4.exp2_int``,
``fp4.floor_log2``, and the "even" mode's log2 in float64), where the
reference's ``exp2`` and ``floor(log2(.))`` round on some backends: the
codes are the reference's wherever its own arithmetic is exact.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ao_tpu_torch.quantization import primitives as P
from ao_tpu_torch.quantization.qarrays.base import QuantizedArray, meta, qarray_dataclass
from ao_tpu_torch.quantization.qarrays.fp4 import (
    F4_E2M1_MAX, decode_fp4_e2m1, encode_fp4_e2m1, exp2_int, floor_log2, pack_fp4,
    pack_fp4_magic, unpack_fp4, unpack_fp4_magic,
)
from ao_tpu_torch.quantization.qarrays.fp6 import decode_fp6, encode_fp6, pack_fp6, unpack_fp6

MX_BLOCK = 32


def e8m0_decode(scale_u8: torch.Tensor) -> torch.Tensor:
    """Biased-exponent uint8 (the e8m0 byte) -> f32 2^(byte - 127), exactly
    (byte 0 is the subnormal 2^-127)."""
    return exp2_int(scale_u8.to(torch.int32) - 127)


_ELEM_MAX = {
    "float8_e4m3fn": 448.0,
    "float8_e5m2": 57344.0,
    "float6_e2m3": 7.5,
    "float6_e3m2": 28.0,
    "float4_e2m1fn": F4_E2M1_MAX,
}

# largest power of two <= elem max
_ELEM_MAX_POW2 = {
    "float8_e4m3fn": 8,
    "float8_e5m2": 15,
    "float6_e2m3": 2,
    "float6_e3m2": 4,
    "float4_e2m1fn": 2,
}


def _snap_fp6(x: torch.Tensor, elem_dtype: str) -> torch.Tensor:
    """Round to the fp6 grid (e2m3 or e3m2) in f32."""
    mant = 3 if elem_dtype == "float6_e2m3" else 2
    ebits = 2 if elem_dtype == "float6_e2m3" else 3
    bias = 2 ** (ebits - 1) - 1
    a = torch.clamp(torch.abs(x), max=_ELEM_MAX[elem_dtype])
    # normals: round the mantissa at 2^floor(log2 a); below min_normal the
    # same formula gives the subnormal step min_normal * 2^-mant
    min_normal = 2.0 ** (1 - bias)
    e = floor_log2(torch.clamp(a, min=min_normal))
    step = exp2_int(e - mant)
    snapped = torch.round(a / step) * step
    return torch.where(x < 0, -snapped, snapped)


def _ceil_log2(a: torch.Tensor) -> torch.Tensor:
    """ceil(log2(a)) for positive finite f32 ``a``, exactly."""
    m, e = torch.frexp(a)
    return (e - (m == 0.5).to(e.dtype)).to(torch.float32)


def to_mx(
    x: torch.Tensor,
    block_size: Tuple[int, ...],
    elem_dtype: str = "float8_e4m3fn",
    scale_mode: str = "floor",  # "floor" | "rceil" | "even"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (qdata, e8m0 scale as biased-exponent uint8); fp4 qdata are
    unpacked codes (the caller packs). "rceil" rounds the scale up so no
    element overflows; "even" rounds the exponent to nearest even."""
    xf = x.to(torch.float32)
    amax = P.block_reduce(xf, block_size, "absmax")
    emax = _ELEM_MAX[elem_dtype]
    if scale_mode == "floor":
        shared_exp = floor_log2(torch.clamp(amax, min=1e-30)) - _ELEM_MAX_POW2[elem_dtype]
    elif scale_mode == "even":
        # float64 keeps round(log2) exact at every f32 input
        shared_exp = torch.round(torch.log2(torch.clamp(amax, min=1e-30).double())).float()
        shared_exp = shared_exp - _ELEM_MAX_POW2[elem_dtype]
    elif scale_mode == "rceil":
        shared_exp = _ceil_log2(torch.clamp(amax / emax, min=1e-30))
    else:
        raise ValueError(scale_mode)
    shared_exp = torch.clamp(shared_exp, -127.0, 127.0)
    scale_e8m0 = (shared_exp + 127.0).to(torch.uint8)
    scale_f = exp2_int(shared_exp)

    v = P.apply_blockwise(xf, block_size, lambda xb, s: torch.clamp(xb / s, -emax, emax), scale_f)
    if elem_dtype in ("float8_e4m3fn", "float8_e5m2"):
        q = v.to(getattr(torch, elem_dtype))
    elif elem_dtype == "float4_e2m1fn":
        q = encode_fp4_e2m1(v)
    else:  # fp6 on the grid, in an e4m3 container
        q = _snap_fp6(v, elem_dtype).to(torch.float8_e4m3fn)
    return q, scale_e8m0


@qarray_dataclass
class MXArray(QuantizedArray):
    qdata: torch.Tensor  # fp8, packed fp6 bytes, fp4 magic words or split-half bytes
    scale: torch.Tensor  # e8m0 as biased-exponent uint8, rank-preserved shape
    elem_dtype: str = meta(default="float8_e4m3fn")
    block_size: Tuple[int, ...] = meta(default=())
    act_elem_dtype: Optional[str] = meta(default=None)  # dynamic activation quant
    scale_mode: str = meta(default="floor")
    _shape: Tuple[int, ...] = meta(default=())
    _dequant_dtype: str = meta(default="bfloat16")

    @classmethod
    def from_hp(
        cls,
        hp: torch.Tensor,
        elem_dtype: str = "float8_e4m3fn",
        block_dim: int = -2,
        act_elem_dtype: Optional[str] = None,
        scale_mode: str = "floor",
        dequant_dtype: str = "bfloat16",
    ) -> "MXArray":
        rank = hp.ndim
        block_dim = block_dim % rank
        if hp.shape[block_dim] % MX_BLOCK != 0:
            raise ValueError(f"dim {block_dim} of {tuple(hp.shape)} not divisible by MX block 32")
        block_size = tuple(MX_BLOCK if i == block_dim else 1 for i in range(rank))
        q, scale = to_mx(hp, block_size, elem_dtype, scale_mode)
        if elem_dtype in ("float6_e2m3", "float6_e3m2"):
            q = pack_fp6(encode_fp6(q.to(torch.float32), elem_dtype), axis=block_dim)
        if elem_dtype == "float4_e2m1fn":
            if rank == 2 and block_dim == rank - 2 and hp.shape[-2] % 128 == 0:
                q = pack_fp4_magic(q)
            else:
                q = pack_fp4(q, MX_BLOCK, axis=block_dim)
        return cls(
            qdata=q,
            scale=scale,
            elem_dtype=elem_dtype,
            block_size=block_size,
            act_elem_dtype=act_elem_dtype,
            scale_mode=scale_mode,
            _shape=tuple(hp.shape),
            _dequant_dtype=dequant_dtype,
        )

    @property
    def layout(self) -> str:
        return "magic" if self.qdata.dtype == torch.int32 else "halves"

    def values(self) -> torch.Tensor:
        """The element values before the block scales, f32, logical shape."""
        block_dim = self.block_size.index(MX_BLOCK)
        if self.elem_dtype == "float4_e2m1fn":
            if self.layout == "magic":
                codes = unpack_fp4_magic(self.qdata)
            else:
                codes = unpack_fp4(self.qdata, MX_BLOCK, axis=block_dim)
            return decode_fp4_e2m1(codes, torch.float32)
        if self.elem_dtype in ("float6_e2m3", "float6_e3m2") and self.qdata.dtype == torch.uint8:
            return decode_fp6(unpack_fp6(self.qdata, axis=block_dim), self.elem_dtype,
                              torch.float32)
        return self.qdata.to(torch.float32)

    def dequantize(self, output_dtype=None) -> torch.Tensor:
        out_dtype = output_dtype or self.dtype
        out = P.apply_blockwise(self.values(), self.block_size, lambda v, s: v * s,
                                e8m0_decode(self.scale))
        return out.to(out_dtype)
