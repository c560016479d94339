"""Affine and float8 quantization primitives — functional and blockwise, on
tensors.

PyTorch port of the integer and float8 subsets of
``ao_tpu/quantization/primitives.py`` (min/max affine, the tinygemm
float-zero-point variant, and the float8 scale / quantize / dequantize).
Every function
keeps the reference's order of float32 operations, so qparams and quantized
values are bit-identical to the JAX package's: ``torch.round`` and
``jnp.round`` both round half to even.

``block_size`` has the same rank as the input; scales and zero points keep
the reduced shape ``s // b`` per dim, so broadcasting across blocks is a
reshape.
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence, Tuple

import torch


class MappingType(enum.Enum):
    SYMMETRIC = "symmetric"
    SYMMETRIC_NO_CLIPPING_ERR = "symmetric_no_clipping_err"
    ASYMMETRIC = "asymmetric"


class ZeroPointDomain(enum.Enum):
    INT = "int"  # dq = (q - zp) * scale
    FLOAT = "float"  # tinygemm: dq = (q - mid_point) * scale + zp
    NONE = "none"  # dq = q * scale


# Integer ranges for sub-byte / int dtypes used as *logical* targets.
_DTYPE_RANGES = {
    "int1": (-1, 0),
    "int2": (-2, 1),
    "int3": (-4, 3),
    "int4": (-8, 7),
    "int5": (-16, 15),
    "int6": (-32, 31),
    "int7": (-64, 63),
    "int8": (-128, 127),
    "uint1": (0, 1),
    "uint2": (0, 3),
    "uint3": (0, 7),
    "uint4": (0, 15),
    "uint5": (0, 31),
    "uint6": (0, 63),
    "uint7": (0, 127),
    "uint8": (0, 255),
    "int16": (-(2**15), 2**15 - 1),
    "int32": (-(2**31), 2**31 - 1),
}

_FLOAT8_MAX = {
    "float8_e4m3fn": 448.0,
    "float8_e5m2": 57344.0,
}

EPS = 1.1920928955078125e-07  # float32 machine eps, torch.finfo(torch.float32).eps


def dtype_range(dtype) -> Tuple[int, int]:
    """Return (quant_min, quant_max) for a logical integer dtype name or a
    torch integer dtype."""
    name = dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")
    if name in _DTYPE_RANGES:
        return _DTYPE_RANGES[name]
    raise ValueError(f"no integer range for dtype {name}")


def float_dtype_max(dtype) -> float:
    """Largest finite value of a float dtype (a torch dtype or its name):
    448 for e4m3fn, 57344 for e5m2. (ref: ao_tpu primitives.py:77)"""
    name = dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")
    if name in _FLOAT8_MAX:
        return _FLOAT8_MAX[name]
    return float(torch.finfo(getattr(torch, name)).max)


# ---------------------------------------------------------------------------
# Blockwise reshaping helpers
# ---------------------------------------------------------------------------


def _check_block(shape: Sequence[int], block_size: Sequence[int]) -> None:
    if len(shape) != len(block_size):
        raise ValueError(f"block_size {block_size} rank != input rank {shape}")
    for s, b in zip(shape, block_size):
        if s % b != 0:
            raise ValueError(f"shape {tuple(shape)} not divisible by block {tuple(block_size)}")


def blocked_shape(shape: Sequence[int], block_size: Sequence[int]) -> Tuple[int, ...]:
    """Interleaved 2N-dim shape: (s0//b0, b0, s1//b1, b1, ...)."""
    out = []
    for s, b in zip(shape, block_size):
        out.extend((s // b, b))
    return tuple(out)


def scale_shape(shape: Sequence[int], block_size: Sequence[int]) -> Tuple[int, ...]:
    """The rank-preserved shape of one qparam per block."""
    return tuple(s // b for s, b in zip(shape, block_size))


def to_blocks(x: torch.Tensor, block_size: Sequence[int]) -> torch.Tensor:
    """Reshape to 2N dims so block axes are the odd dims (1, 3, 5, ...)."""
    _check_block(x.shape, block_size)
    return x.reshape(blocked_shape(x.shape, block_size))


def _expand(qparam: torch.Tensor) -> torch.Tensor:
    """Insert singleton block axes so a scale of shape (s0//b0, ...) broadcasts
    against the 2N-dim blocked view."""
    shape = []
    for d in qparam.shape:
        shape.extend((d, 1))
    return qparam.reshape(shape)


def block_reduce(x: torch.Tensor, block_size: Sequence[int], op: str) -> torch.Tensor:
    """Reduce each block to a scalar: the result has shape (s // b per dim)."""
    xb = to_blocks(x, block_size)
    axes = tuple(range(1, xb.ndim, 2))
    if op == "min":
        return torch.amin(xb, dim=axes)
    if op == "max":
        return torch.amax(xb, dim=axes)
    if op == "absmax":
        return torch.amax(torch.abs(xb), dim=axes)
    if op == "sum":
        return torch.sum(xb, dim=axes)
    if op == "mean":
        return torch.mean(xb, dim=axes)
    raise ValueError(op)


def apply_blockwise(x: torch.Tensor, block_size, fn, *qparams) -> torch.Tensor:
    """Apply ``fn(x_blocked, *expanded_qparams)`` elementwise over blocks and
    reshape back."""
    xb = to_blocks(x, block_size)
    expanded = [_expand(q) for q in qparams]
    out = fn(xb, *expanded)
    return out.reshape(x.shape)


def _resolve_range(target_dtype, quant_min, quant_max):
    if quant_min is None or quant_max is None:
        qmin, qmax = dtype_range(target_dtype)
        quant_min = qmin if quant_min is None else quant_min
        quant_max = qmax if quant_max is None else quant_max
    return quant_min, quant_max


# ---------------------------------------------------------------------------
# choose_qparams / quantize / dequantize (integer affine)
# ---------------------------------------------------------------------------


def choose_qparams_affine(
    x: torch.Tensor,
    mapping_type: MappingType,
    block_size: Sequence[int],
    target_dtype: str = "int8",
    quant_min: Optional[int] = None,
    quant_max: Optional[int] = None,
    eps: float = EPS,
    scale_dtype=torch.float32,
    zero_point_dtype=torch.int32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise affine qparams. Returns (scale, zero_point) with the
    rank-preserved shape (s // b per dim). (ref: ao_tpu primitives.py:155)"""
    quant_min, quant_max = _resolve_range(target_dtype, quant_min, quant_max)

    x = x.to(torch.float32)
    min_val = block_reduce(x, block_size, "min")
    max_val = block_reduce(x, block_size, "max")
    # include zero in the range (preserve_zero)
    min_val_neg = torch.clamp_max(min_val, 0.0)
    max_val_pos = torch.clamp_min(max_val, 0.0)

    if mapping_type in (MappingType.SYMMETRIC, MappingType.SYMMETRIC_NO_CLIPPING_ERR):
        if mapping_type is MappingType.SYMMETRIC:
            amax = torch.maximum(-min_val_neg, max_val_pos)
            scale = amax / ((quant_max - quant_min) / 2.0)
        else:
            # scale chosen so that neither end clips
            smin = min_val_neg / quant_min if quant_min != 0 else torch.zeros_like(min_val_neg)
            smax = max_val_pos / quant_max if quant_max != 0 else torch.zeros_like(max_val_pos)
            scale = torch.maximum(smin, smax)
        scale = torch.clamp_min(scale, eps)
        mid = (quant_max + quant_min + 1) // 2
        zero_point = torch.full(scale.shape, mid, dtype=zero_point_dtype, device=x.device)
    elif mapping_type is MappingType.ASYMMETRIC:
        scale = (max_val_pos - min_val_neg) / float(quant_max - quant_min)
        scale = torch.clamp_min(scale, eps)
        zero_point = quant_min - torch.round(min_val_neg / scale)
        zero_point = torch.clamp(zero_point, quant_min, quant_max).to(zero_point_dtype)
    else:
        raise ValueError(mapping_type)
    return scale.to(scale_dtype), zero_point


def quantize_affine(
    x: torch.Tensor,
    block_size: Sequence[int],
    scale: torch.Tensor,
    zero_point: Optional[torch.Tensor] = None,
    quant_min: int = -128,
    quant_max: int = 127,
    output_dtype=torch.int8,
) -> torch.Tensor:
    """q = clamp(round(x / scale) + zp).  (ref: ao_tpu primitives.py:207)"""
    x = x.to(torch.float32)

    def _q(xb, s, *zp):
        inv = 1.0 / s
        v = torch.round(xb * inv)
        if zp:
            v = v + zp[0].to(torch.float32)
        return torch.clamp(v, quant_min, quant_max)

    qparams = (scale,) if zero_point is None else (scale, zero_point)
    out = apply_blockwise(x, block_size, _q, *qparams)
    return out.to(output_dtype)


def dequantize_affine(
    q: torch.Tensor,
    block_size: Sequence[int],
    scale: torch.Tensor,
    zero_point: Optional[torch.Tensor] = None,
    output_dtype=torch.float32,
) -> torch.Tensor:
    """dq = (q - zp) * scale.  (ref: ao_tpu primitives.py:231)"""

    def _dq(qb, s, *zp):
        v = qb.to(torch.float32)
        if zp:
            v = v - zp[0].to(torch.float32)
        return v * s.to(torch.float32)

    qparams = (scale,) if zero_point is None else (scale, zero_point)
    out = apply_blockwise(q, block_size, _dq, *qparams)
    return out.to(output_dtype)


# ---------------------------------------------------------------------------
# tinygemm variant: float zero-point domain (int4 weight-only classic layout)
# ---------------------------------------------------------------------------


def choose_qparams_affine_tinygemm(
    x: torch.Tensor,
    block_size: Sequence[int],
    target_dtype: str = "int4",
    quant_min: Optional[int] = None,
    quant_max: Optional[int] = None,
    eps: float = EPS,
    scale_dtype=torch.bfloat16,
    zero_point_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric qparams with FLOAT zero-point domain:
    dq = (q - mid_point) * scale + zero_point. (ref: ao_tpu primitives.py:256)
    """
    quant_min, quant_max = _resolve_range(target_dtype, quant_min, quant_max)
    x = x.to(torch.float32)
    min_val = block_reduce(x, block_size, "min")
    max_val = block_reduce(x, block_size, "max")
    scale = torch.clamp_min((max_val - min_val) / float(quant_max - quant_min), eps)
    mid_point = (quant_max + quant_min + 1) / 2.0
    zero_point = min_val + scale * mid_point
    return scale.to(scale_dtype), zero_point.to(zero_point_dtype)


def quantize_affine_tinygemm(
    x, block_size, scale, zero_point, quant_min=-8, quant_max=7, output_dtype=torch.int8
):
    """q = clamp(round((x - (zp - scale*mid)) / scale)).
    (ref: ao_tpu primitives.py:283)"""
    mid_point = (quant_max + quant_min + 1) / 2.0

    def _q(xb, s, zp):
        s32 = s.to(torch.float32)
        min_val = zp.to(torch.float32) - s32 * mid_point
        v = torch.round((xb.to(torch.float32) - min_val) / s32) + float(quant_min)
        return torch.clamp(v, quant_min, quant_max)

    out = apply_blockwise(x, block_size, _q, scale, zero_point)
    return out.to(output_dtype)


def dequantize_affine_tinygemm(
    q, block_size, scale, zero_point, quant_min=-8, quant_max=7, output_dtype=torch.float32
):
    """dq = (q - mid_point) * scale + zp  with q shifted back to unsigned mid."""
    mid_point = (quant_max + quant_min + 1) / 2.0

    def _dq(qb, s, zp):
        v = qb.to(torch.float32) - float(quant_min) - mid_point
        return v * s.to(torch.float32) + zp.to(torch.float32)

    out = apply_blockwise(q, block_size, _dq, scale, zero_point)
    return out.to(output_dtype)


# ---------------------------------------------------------------------------
# float8
# ---------------------------------------------------------------------------


def _float8_torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def choose_scale_float8(
    x: torch.Tensor,
    block_size: Sequence[int],
    float8_dtype=torch.float8_e4m3fn,
    value_lb: Optional[float] = None,
    value_ub: Optional[float] = None,
) -> torch.Tensor:
    """scale = max(amax, eps) / max_pos per block, with optional lower and
    upper clamps on amax. (ref: ao_tpu primitives.py:324)"""
    amax = block_reduce(x.to(torch.float32), block_size, "absmax")
    if value_lb is not None:
        amax = torch.clamp_min(amax, value_lb)
    if value_ub is not None:
        amax = torch.clamp_max(amax, value_ub)
    return torch.clamp_min(amax, EPS) / float_dtype_max(float8_dtype)


def quantize_float8(
    x: torch.Tensor, block_size: Sequence[int], scale: torch.Tensor,
    float8_dtype=torch.float8_e4m3fn,
) -> torch.Tensor:
    """clip(x / scale, +-max_pos) cast to the float8 type (round to nearest
    even, as JAX's cast). (ref: ao_tpu primitives.py:342)"""
    max_pos = float_dtype_max(float8_dtype)

    def _q(xb, s):
        v = xb.to(torch.float32) / s.to(torch.float32)
        return torch.clamp(v, -max_pos, max_pos)

    out = apply_blockwise(x, block_size, _q, scale)
    return out.to(_float8_torch_dtype(float8_dtype))


def dequantize_float8(
    q: torch.Tensor, block_size: Sequence[int], scale: torch.Tensor,
    output_dtype=torch.float32,
) -> torch.Tensor:
    """q * scale in f32, cast to ``output_dtype``. (ref: ao_tpu primitives.py:358)"""

    def _dq(qb, s):
        return qb.to(torch.float32) * s.to(torch.float32)

    out = apply_blockwise(q, block_size, _dq, scale)
    return out.to(output_dtype)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def compute_error(ref: torch.Tensor, actual: torch.Tensor) -> torch.Tensor:
    """SQNR in dB, the core numerical-testing metric.
    (ref: ao_tpu primitives.py:426)"""
    ref = ref.to(torch.float32)
    actual = actual.to(torch.float32)
    num = torch.linalg.norm(ref)
    den = torch.linalg.norm(ref - actual)
    return 20.0 * torch.log10(num / torch.clamp_min(den, 1e-20))
