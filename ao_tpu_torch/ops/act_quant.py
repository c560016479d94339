"""Dynamic activation quantization (on the fly, inside the forward).

PyTorch port of ``ao_tpu/ops/act_quant.py``: the quantize of an activation
before an int8- or fp8-activation linear (per token, per tensor, or per group
of the last dim), and producer-side quantization (``silu_mul_quant``,
``gelu_quant``, ``norm_modulate_quant``), which emits the gated-MLP, GELU or
LayerNorm output as int8 qdata and per-token scales so that the
high-precision activation never goes to device memory. The producer kernels
are in ``ops/hopper/fused_act.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ao_tpu_torch.quantization import primitives as P
from ao_tpu_torch.quantization.qarrays.base import qarray_dataclass
from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec, canon_dtype


@qarray_dataclass
class QuantizedActivation:
    """A pre-quantized activation (producer quantization): int8 qdata and a
    per-token f32 scale. ``ops.linear`` consumes it directly on the
    int8-activation weight paths, skipping the standalone quantize."""

    qdata: torch.Tensor  # (..., K) int8
    scale: torch.Tensor  # (..., 1) f32 per token

    @property
    def shape(self):
        return tuple(self.qdata.shape)

    @property
    def ndim(self):
        return self.qdata.ndim

    @property
    def dtype(self):
        """Logical (dequantized) activation dtype, as in the reference."""
        return torch.bfloat16


def producer_quant_ok(w) -> bool:
    """True when a weight leaf can consume a producer-quantized activation:
    an int8 per-token symmetric dynamic-activation spec and no act_pre_scale
    (AWQ/SmoothQuant pre-scales multiply the activation before it is
    quantized, which the producer kernels do not do)."""
    aq = getattr(w, "act_quant", None)
    # an NVFP4Array's act_quant is a flag, not a spec: the reference reads
    # its .dtype and raises (ROADMAP Queue 3)
    return (isinstance(aq, ActQuantSpec) and aq.dtype == "int8" and aq.symmetric
            and aq.granularity == "per_token"
            and getattr(w, "act_pre_scale", None) is None)


def _row_quant(y: torch.Tensor):
    """Per-row symmetric int8 of f32 ``y``: scale = max(amax, 1e-8) / 127,
    q = clip(round(y / scale), -127, 127). Returns (q int8, scale (..., 1))."""
    amax = torch.amax(torch.abs(y), dim=-1, keepdim=True)
    sc = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(y / sc), -127, 127).to(torch.int8)
    return q, sc


def silu_mul_quant(a, b, act: str = "silu") -> QuantizedActivation:
    """Gated-MLP product (silu(a)*b SwiGLU, or gelu(a)*b GeGLU with
    ``act="gelu"``) + per-token int8 quantize in one pass: the kernel K12s
    (``ops/hopper/fused_act.py``) where the reference takes its Pallas
    kernel and ``fused_act.takes`` allows, else the plain version (the
    reference's XLA form)."""
    from ao_tpu_torch.ops import kernels
    from ao_tpu_torch.ops.hopper import fused_act

    if (tuple(a.shape) == tuple(b.shape) and fused_act.takes(tuple(a.shape))
            and kernels.use_kernel(a)):
        q, s = fused_act.silu_mul_quant(a, b, act=act)
    else:
        q, s = fused_act.silu_mul_quant_plain(a, b, act=act)
    return QuantizedActivation(qdata=q, scale=s)


def gelu_quant(y) -> QuantizedActivation:
    """tanh-GELU + per-token int8 quantize in one pass: the kernel K12g
    (``ops/hopper/fused_act.py``) where the reference takes its Pallas
    kernel and ``fused_act.takes`` allows, else the plain version (the
    reference's XLA form)."""
    from ao_tpu_torch.ops import kernels
    from ao_tpu_torch.ops.hopper import fused_act

    if fused_act.takes(tuple(y.shape)) and kernels.use_kernel(y):
        q, s = fused_act.gelu_quant(y)
    else:
        q, s = fused_act.gelu_quant_plain(y)
    return QuantizedActivation(qdata=q, scale=s)


def norm_modulate_quant(h, shift, smod, eps) -> QuantizedActivation:
    """LayerNorm (no affine) + modulate (y * (1 + smod) + shift, per batch
    row) + per-token int8 quantize in one pass: the kernel K12n where the
    reference takes its Pallas kernel and ``fused_act.takes`` allows, else
    the plain version (the reference's XLA form). h (B, T, D); shift, smod
    (B, D)."""
    from ao_tpu_torch.ops import kernels
    from ao_tpu_torch.ops.hopper import fused_act

    if fused_act.takes(tuple(h.shape)) and kernels.use_kernel(h):
        q, s = fused_act.norm_modulate_quant(h, shift, smod, eps)
    else:
        q, s = fused_act.norm_modulate_quant_plain(h, shift, smod, eps)
    return QuantizedActivation(qdata=q, scale=s)


def act_block_size(shape, spec: ActQuantSpec):
    rank = len(shape)
    if spec.granularity == "per_token":
        return (1,) * (rank - 1) + (shape[-1],)
    if spec.granularity == "per_tensor":
        return tuple(shape)
    g = spec.group_size()
    if g is not None:
        return (1,) * (rank - 1) + (g,)
    raise ValueError(spec.granularity)


def quantize_activation(
    x: torch.Tensor, spec: ActQuantSpec
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Returns (q, scale, zero_point); the scale keeps the rank, reduced
    over each block. Bit-identical to the reference (ref: ao_tpu
    act_quant.py:141); fp8 has no zero point."""
    bs = act_block_size(tuple(x.shape), spec)
    if spec.dtype.startswith("float8"):
        dt = canon_dtype(spec.dtype)
        scale = P.choose_scale_float8(x, bs, dt, value_lb=spec.value_lb, value_ub=spec.value_ub)
        return P.quantize_float8(x, bs, scale, dt), scale, None
    if spec.dtype == "int8":
        mt = P.MappingType.SYMMETRIC if spec.symmetric else P.MappingType.ASYMMETRIC
        scale, zp = P.choose_qparams_affine(x, mt, bs, target_dtype="int8")
        q = P.quantize_affine(x, bs, scale, zp, -128, 127, torch.int8)
        if spec.symmetric:
            zp = None
        return q, scale, zp
    raise ValueError(f"unsupported activation dtype {spec.dtype}")
