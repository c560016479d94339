"""fp6 (e2m3 / e3m2) encode/decode with 4-codes-in-3-bytes packing.

PyTorch port of ``ao_tpu/quantization/qarrays/fp6.py``, bit for bit. A code
is sign(1) | exponent | mantissa, 6 bits:
  e2m3: 1 + 2 + 3, bias 1 — values 0..7.5, min normal 1.0
  e3m2: 1 + 3 + 2, bias 3 — values 0..28,  min normal 0.25
"""

from __future__ import annotations

import torch

from ao_tpu_torch.quantization.qarrays.fp4 import exp2_int, floor_log2

_FMT = {
    # elem_dtype: (ebits, mbits, bias, max)
    "float6_e2m3": (2, 3, 1, 7.5),
    "float6_e3m2": (3, 2, 3, 28.0),
}


def encode_fp6(x: torch.Tensor, elem_dtype: str) -> torch.Tensor:
    """f32 values (already on the fp6 grid) -> uint8 6-bit codes."""
    ebits, mbits, bias, fmax = _FMT[elem_dtype]
    xf = x.to(torch.float32)
    s = (xf < 0) | ((xf == 0) & torch.signbit(xf))
    a = torch.clamp(torch.abs(xf), max=fmax)
    min_normal = 2.0 ** (1 - bias)
    e = torch.clamp(floor_log2(torch.clamp(a, min=min_normal / 2.0)) + float(bias),
                    0.0, float(2 ** ebits - 1))
    # below min_normal the exponent field is 0
    e = torch.where(a < min_normal, torch.zeros_like(e), e)
    pow2 = exp2_int(torch.clamp(e, min=1.0) - bias)
    m = torch.where(e > 0, (a / pow2 - 1.0) * (2.0 ** mbits), a / min_normal * (2.0 ** mbits))
    m = torch.clamp(torch.round(m), 0.0, 2.0 ** mbits - 1)
    return ((s.to(torch.uint8) << (ebits + mbits)) | (e.to(torch.uint8) << mbits)
            | m.to(torch.uint8))


def decode_fp6(code: torch.Tensor, elem_dtype: str, dtype=torch.float32) -> torch.Tensor:
    ebits, mbits, bias, _ = _FMT[elem_dtype]
    c = code.to(torch.int32)
    s = (c >> (ebits + mbits)) & 1
    e = (c >> mbits) & (2 ** ebits - 1)
    m = (c & (2 ** mbits - 1)).to(torch.float32)
    min_normal = 2.0 ** (1 - bias)
    mag = torch.where(e > 0, exp2_int(e - bias) * (1.0 + m / (2.0 ** mbits)),
                      min_normal * m / (2.0 ** mbits))
    return torch.where(s == 1, -mag, mag).to(dtype)


def pack_fp6(codes: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """uint8 6-bit codes -> packed bytes: 4 codes in 3 bytes along ``axis``
    (its length a multiple of 4)."""
    axis = axis % codes.ndim
    k = codes.shape[axis]
    if k % 4 != 0:
        raise ValueError(f"axis length {k} must be a multiple of 4")
    shape = tuple(codes.shape)
    c = codes.to(torch.int32).reshape(shape[:axis] + (k // 4, 4) + shape[axis + 1:])
    c0, c1, c2, c3 = c.unbind(dim=axis + 1)
    b0 = (c0 | (c1 << 6)) & 0xFF
    b1 = ((c1 >> 2) | (c2 << 4)) & 0xFF
    b2 = ((c2 >> 4) | (c3 << 2)) & 0xFF
    packed = torch.stack([b0, b1, b2], dim=axis + 1).to(torch.uint8)
    return packed.reshape(shape[:axis] + (3 * k // 4,) + shape[axis + 1:])


def unpack_fp6(packed: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`pack_fp6`."""
    axis = axis % packed.ndim
    kb = packed.shape[axis]
    shape = tuple(packed.shape)
    b = packed.to(torch.int32).reshape(shape[:axis] + (kb // 3, 3) + shape[axis + 1:])
    b0, b1, b2 = b.unbind(dim=axis + 1)
    c0 = b0 & 0x3F
    c1 = ((b0 >> 6) | (b1 << 2)) & 0x3F
    c2 = ((b1 >> 4) | (b2 << 4)) & 0x3F
    c3 = (b2 >> 2) & 0x3F
    codes = torch.stack([c0, c1, c2, c3], dim=axis + 1).to(torch.uint8)
    return codes.reshape(shape[:axis] + (4 * kb // 3,) + shape[axis + 1:])
