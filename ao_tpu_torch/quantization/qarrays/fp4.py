"""fp4 (e2m1) encode/decode and nibble packing.

PyTorch port of ``ao_tpu/quantization/qarrays/fp4.py``, bit for bit. e2m1
is sign(1) exponent(2) mantissa(1); its positive values are 0, 0.5, 1, 1.5,
2, 3, 4, 6. Codes are computed arithmetically from the bit layout, as in
the reference. Three packings:

* split-half bytes (``pack_fp4``): the group-local int4 layout;
* "fp4 magic" int32 words (K/8, N) (``pack_fp4_magic``): plane j holds
  logical rows [jK/4, (j+1)K/4); word row r holds plane rows 2r and 2r + 1
  at bits 4j and 16 + 4j, with the em field's 0 and 1 swapped. It is the
  int4 "magic" layout with one super-group of four groups of K/4 rows, so
  a word's plane j is two consecutive K rows of one column: one register
  of a ``mma.sync`` fragment (ops/hopper/fp4_matmul.py);
* NVFP4 scale pair-words (``pack_nvfp4_scale_pairs``): the bytes of e4m3
  scale rows 2r and 2r + 1 at bits 0 and 16 of int32 word row r.
"""

from __future__ import annotations

import torch

from ao_tpu_torch.quantization.qarrays.int4 import pack_int4, unpack_int4

F4_E2M1_MAX = 6.0


def floor_log2(a: torch.Tensor) -> torch.Tensor:
    """floor(log2(a)) for positive finite f32 ``a``, exactly, as f32.

    ``torch.frexp`` gives a = m * 2^e with m in [0.5, 1), so the floor is
    e - 1 for every input, where a rounded f32 ``log2`` reaches the next
    integer just below a power of two."""
    return (torch.frexp(a)[1] - 1).to(torch.float32)


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """2^e in f32 for integer-valued ``e``, exactly, from its bits on any
    device: f32's subnormals down to 2^-149, inf from 2^128 on."""
    ei = e.to(torch.int32)
    normal = torch.clamp(ei + 127, 1, 255).bitwise_left_shift(23).view(torch.float32)
    sub = torch.ones_like(ei).bitwise_left_shift(torch.clamp(ei + 149, 0, 22)).view(torch.float32)
    return torch.where(ei >= -126, normal, sub)


def encode_fp4_e2m1(x: torch.Tensor) -> torch.Tensor:
    """f32/bf16 -> uint8 4-bit e2m1 codes, values clamped to ±6, rounded to
    nearest even (the reference's arithmetic snap)."""
    xf = x.to(torch.float32)
    a = torch.clamp(torch.abs(xf), max=F4_E2M1_MAX)
    # 1 mantissa bit, exponent bias 1: the grid step at exponent e is
    # 2^(e-1); the same formula below 1.0 gives the subnormal step 0.5
    e = floor_log2(torch.clamp(a, min=1.0))
    step = exp2_int(e - 1.0)
    snapped = torch.round(a / step) * step
    v = torch.where(xf < 0, -snapped, snapped)
    v = torch.where((xf == 0) & torch.signbit(xf), torch.full_like(v, -0.0), v)
    s = (v < 0) | ((v == 0) & torch.signbit(v))
    a = torch.abs(v)
    # exponent field: a in [0, .5] is subnormal (e = 0); else floor(log2 a) + 1
    e = torch.clamp(floor_log2(torch.clamp(a, min=0.25)) + 1.0, 0.0, 3.0)
    # mantissa bit: normals a / 2^(e-1) in {1, 1.5}; subnormals a in {0, .5}
    pow2 = exp2_int(torch.clamp(e - 1.0, min=0.0))
    mbit = torch.where(e > 0, (a / pow2 - 1.0) * 2.0, a * 2.0)
    mbit = torch.clamp(torch.round(mbit), 0.0, 1.0)
    return (s.to(torch.uint8) << 3) | (e.to(torch.uint8) << 1) | mbit.to(torch.uint8)


def decode_fp4_e2m1(code: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 4-bit e2m1 codes -> float, exactly."""
    c = code.to(torch.int32)
    s = (c >> 3) & 1
    e = (c >> 1) & 3
    m = (c & 1).to(torch.float32)
    mag = torch.where(e > 0, exp2_int(e - 1) * (1.0 + 0.5 * m), 0.5 * m)
    return torch.where(s == 1, -mag, mag).to(dtype)


def pack_fp4(codes: torch.Tensor, group_size: int, axis: int = -2) -> torch.Tensor:
    return pack_int4(codes, group_size, axis=axis)


def unpack_fp4(packed: torch.Tensor, group_size: int, axis: int = -2) -> torch.Tensor:
    return unpack_int4(packed, group_size, axis=axis)


def _remap_fp4_magic(codes: torch.Tensor) -> torch.Tensor:
    """Swap the e2m1 em field's 0 and 1 (self-inverse, sign kept)."""
    c = codes.to(torch.int32)
    em = c & 0x7
    out = torch.where(em == 0, c | 1, torch.where(em == 1, c & 0xE, c))
    return out.to(torch.uint8)


def pack_fp4_magic(codes: torch.Tensor) -> torch.Tensor:
    """e2m1 codes (K, N) uint8 -> int32 (K/8, N) "fp4 magic" words."""
    k, n = codes.shape
    if k % 8 != 0:
        raise ValueError(f"K={k} must be a multiple of 8")
    planes = _remap_fp4_magic(codes).to(torch.int32).reshape(4, k // 8, 2, n)
    word = torch.zeros((k // 8, n), dtype=torch.int32, device=codes.device)
    for j in range(4):
        for h in range(2):
            word = word | (planes[j, :, h] << (4 * j + 16 * h))
    return word


def unpack_fp4_magic(word: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_fp4_magic`; e2m1 codes (K, N) uint8."""
    kw, n = word.shape
    planes = [torch.stack([(word >> (4 * j + 16 * h)) & 0xF for h in range(2)],
                          dim=1).reshape(2 * kw, n) for j in range(4)]
    return _remap_fp4_magic(torch.cat(planes, dim=0))


def pack_nvfp4_scale_pairs(scale_e4m3: torch.Tensor) -> torch.Tensor:
    """e4m3 block scales (K/16, N) -> int32 pair-words (K/32, N)."""
    kb, n = scale_e4m3.shape
    if kb % 2 != 0:
        raise ValueError(f"scale rows {kb} must be even")
    sb = scale_e4m3.view(torch.uint8).to(torch.int32)
    return sb[0::2] | (sb[1::2] << 16)


def unpack_nvfp4_scale_pairs(sw: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nvfp4_scale_pairs` -> e4m3 (K/16, N)."""
    kw, n = sw.shape
    b = torch.stack([sw & 0xFF, (sw >> 16) & 0xFF], dim=1)  # (K/32, 2, N)
    return b.reshape(2 * kw, n).to(torch.uint8).view(torch.float8_e4m3fn)
