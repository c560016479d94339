"""`ao_tpu_torch.ops.linear` — the single compute entry point for linears.

PyTorch port of the plain linear and the int8, int4, float8, MX, NVFP4 and
NF4 branches of ``ao_tpu/ops/linear.py``, and its sparse ones (2:4, 2:4
with int4 values, block-sparse through K18): int8 weight-only, dynamic and
static int8 activations (W8A8); int4 weight-only, W4A8 (int8 dynamic
activations x int4 weights) and fp8 activations x int4 weights; fp8
weight-only, dynamic and static fp8 activations; MX weights (fp4 through
K14) with optional dynamic MX activations; NVFP4 weights (K14) with
optional dynamic NVFP4 activations; NF4 weights (K15). y = x @ W (+ b), with W either a plain tensor
(K, N) or a QuantizedArray, and x a tensor or a producer-quantized
``QuantizedActivation``; each container's implementation consults
:mod:`ao_tpu_torch.ops.kernels` for its backend. The ``frozen_weight_ste``
backward comes with a later slice of the port; everything here runs under
``torch.no_grad``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ao_tpu_torch.ops import kernels
from ao_tpu_torch.ops.act_quant import QuantizedActivation, quantize_activation
from ao_tpu_torch.ops.dispatch import implements, lookup
from ao_tpu_torch.ops.hopper.int4_matmul import (
    affine_qparams, int4_magic8_requant_int8, int4_w4a8_matmul, takes_requant, takes_w4a8,
)
from ao_tpu_torch.quantization import primitives as P
from ao_tpu_torch.quantization.qarrays.base import QuantizedArray
from ao_tpu_torch.quantization.qarrays.float8 import Float8Array
from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
from ao_tpu_torch.quantization.qarrays.fp4 import decode_fp4_e2m1
from ao_tpu_torch.quantization.qarrays.int8 import Int8Array
from ao_tpu_torch.quantization.qarrays.mx import MX_BLOCK, MXArray, e8m0_decode, to_mx
from ao_tpu_torch.quantization.qarrays.nf4 import NF4_CODEBOOK, NF4Array
from ao_tpu_torch.quantization.qarrays.nvfp4 import NVFP4_BLOCK, NVFP4Array, nvfp4_quantize
from ao_tpu_torch.sparsity.blocksparse import BlockSparseArray
from ao_tpu_torch.sparsity.sparse24 import Sparse24Array, Sparse24Int4Array


def linear(x, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[..., n] = sum_k x[..., k] * W[k, n] + b[n]."""
    if isinstance(w, QuantizedArray):
        return lookup("linear", type(w))(x, w, b)
    if isinstance(x, QuantizedActivation):
        # a producer-quantized activation meeting an unquantized weight
        # (mixed FqnToConfig): dequantize it
        x = (x.qdata.to(torch.float32) * x.scale).to(w.dtype)
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _flatten_batch(x: torch.Tensor):
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, x.shape[-1]), lead


def _unflatten_batch(y: torch.Tensor, lead):
    return y.reshape(*lead, y.shape[-1])


def _maybe_bias(y, b):
    return y if b is None else y + b.to(y.dtype)


@implements("linear", Int8Array)
def _int8_linear(x, w: Int8Array, b):
    """(ref: ao_tpu ops/linear.py:132) Weight-only: ``int8_wo_matmul`` (K10).
    With an activation spec or a static activation scale: the int8
    activation (quantized here, or by its producer, as the SwiGLU gate of a
    W8A8 MLP's prefill is by K12s) into ``int8_dynamic_matmul``."""
    if isinstance(x, QuantizedActivation):
        if w.act_pre_scale is not None:
            raise ValueError(
                "producer-quantized activation cannot apply this weight's "
                "act_pre_scale (AWQ/SmoothQuant): quantize after scaling")
        qx, lead = _flatten_batch(x.qdata)
        y = kernels.int8_dynamic_matmul(qx, x.scale.reshape(-1, 1), None, w.qdata, w.scale,
                                        w.zero_point, w.block_size, out_dtype=torch.bfloat16)
        return _unflatten_batch(_maybe_bias(y, b), lead)
    x2, lead = _flatten_batch(x)
    if w.act_pre_scale is not None:
        x2 = x2 * w.act_pre_scale.to(x2.dtype)
    if w.act_quant is None and w.act_scale is None:
        y = kernels.int8_wo_matmul(x2, w.qdata, w.scale, w.zero_point, w.block_size)
    else:
        if w.act_scale is not None:
            # static (calibrated) per-tensor activation scale
            sx = w.act_scale.reshape(1, 1)
            zx = None if w.act_zero_point is None else w.act_zero_point.reshape(1, 1)
            qx = P.quantize_affine(x2, tuple(x2.shape), sx, zx, -128, 127, torch.int8)
        else:
            qx, sx, zx = quantize_activation(x2, w.act_quant)
        y = kernels.int8_dynamic_matmul(qx, sx, zx, w.qdata, w.scale, w.zero_point,
                                        w.block_size, out_dtype=x.dtype)
    return _unflatten_batch(_maybe_bias(y.to(x.dtype), b), lead)


@implements("linear", Float8Array)
def _float8_linear(x, w: Float8Array, b):
    """(ref: ao_tpu ops/linear.py:296) Weight-only: dequantize + matmul.
    With a static activation scale, or a dynamic activation spec: the fp8
    activation into ``fp8_dynamic_matmul`` (``torch._scaled_mm`` rowwise,
    K17 blockwise)."""
    x2, lead = _flatten_batch(x)
    if w.act_pre_scale is not None:
        x2 = x2 * w.act_pre_scale.to(x2.dtype)
    if w.act_scale is not None:
        # static (calibrated) per-tensor activation scale; the reference
        # clips at e4m3's 448 whatever the weight's fp8 type
        sx = w.act_scale.reshape(1, 1).to(torch.float32)
        qx = torch.clamp(x2.to(torch.float32) / sx, -448.0, 448.0).to(w.qdata.dtype)
        y = kernels.fp8_dynamic_matmul(qx, sx, w.qdata, w.scale, w.block_size, out_dtype=x.dtype)
    elif w.act_quant is None:
        y = kernels.fp8_wo_matmul(x2, w.qdata, w.scale, w.block_size)
    else:
        qx, sx, _ = quantize_activation(x2, w.act_quant)
        y = kernels.fp8_dynamic_matmul(qx, sx, w.qdata, w.scale, w.block_size, out_dtype=x.dtype)
    return _unflatten_batch(_maybe_bias(y.to(x.dtype), b), lead)


def _requant_scale(w: Int4Array):
    """Per-group (s, b) of w = u*s + b in f32, and the per-channel int8
    scale s8 (1, N) found analytically: |w| over a group's 16 grid points is
    largest at an endpoint, max(|b|, |15s + b|), so no reduction over the
    dequantized weight is needed (ref: ops/linear.py:226-235)."""
    sg, bg = affine_qparams(w.scale, w.zero_point, w.zero_point_domain)
    bound = torch.maximum(torch.abs(bg), torch.abs(15.0 * sg + bg))
    s8 = torch.amax(bound, dim=0, keepdim=True) / 127.0
    return sg, bg, torch.clamp_min(s8, 1e-12)


@implements("linear", Int4Array)
def _int4_linear(x, w: Int4Array, b):
    pre_q = isinstance(x, QuantizedActivation)
    if pre_q:
        if w.act_pre_scale is not None:
            raise ValueError(
                "producer-quantized activation cannot apply this weight's "
                "act_pre_scale (AWQ/SmoothQuant): quantize after scaling")
        x2, lead = _flatten_batch(x.qdata)
    else:
        x2, lead = _flatten_batch(x)
        if w.act_pre_scale is not None:
            x2 = x2 * w.act_pre_scale.to(x2.dtype)
    if w.act_quant is not None:
        if pre_q:
            qx, sx, zx = x2, x.scale.reshape(-1, 1), None
        else:
            qx, sx, zx = quantize_activation(x2, w.act_quant)
        if w.act_quant.dtype == "int8" and x2.shape[0] > kernels.W4A8_REQUANT_ABOVE_M:
            # prefill W4A8: requantize the int4 weight to per-channel int8
            # in one pass, then one int8 GEMM
            sg, bg, s8 = _requant_scale(w)
            if (w.layout == "magic8" and takes_requant(x2.shape[1], w.qdata.shape[-1], w.group_size)
                    and kernels.use_kernel(x2)):
                qw8 = int4_magic8_requant_int8(w.qdata, sg, bg, s8, w.group_size)
            else:
                w_dq = w.dequantize(torch.float32)
                qw8 = torch.clamp(torch.round(w_dq / s8), -127, 127).to(torch.int8)
            y = kernels.int8_dynamic_matmul(qx, sx, zx, qw8, s8, None, (x2.shape[1], 1),
                                            out_dtype=x.dtype)
            return _unflatten_batch(_maybe_bias(y.to(x.dtype), b), lead)
        if (w.act_quant.dtype == "int8" and zx is None and w.layout == "magic8"
                and takes_w4a8(x2.shape[1], w.qdata.shape[-1], w.group_size)
                and kernels.use_kernel(x2)):
            # W4A8 proper: int8 activations x magic8 int4 planes on the s8
            # tensor cores, exact integer dots, per-token scale in the epilogue
            y = int4_w4a8_matmul(qx, sx, w.qdata, w.scale, w.zero_point, w.group_size,
                                 w.zero_point_domain)
            return _unflatten_batch(_maybe_bias(y.to(x.dtype), b), lead)
        # q/dq fallback (fp8 activations, the "torch" backend, asymmetric or
        # other layouts): the activation is held to its quantized values, the
        # dot runs the weight-only int4 path
        x2 = qx.to(torch.float32) * sx
        if zx is not None:
            x2 = x2 - (zx * sx)
        x2 = x2.to(x.dtype)
    y = kernels.int4_wo_matmul(
        x2, w.qdata, w.scale, w.zero_point, w.group_size, w.zero_point_domain,
        layout=w.layout,
    )
    return _unflatten_batch(_maybe_bias(y.to(x.dtype), b), lead)


# ---------------------------------------------------------------------------
# MX (MXFP8 / MXFP6 / MXFP4) and NVFP4
# ---------------------------------------------------------------------------


@implements("linear", MXArray)
def _mx_linear(x, w: MXArray, b):
    """(ref: ao_tpu ops/linear.py:326) With an activation element type the
    activation is fake-quantized to MX along K (block 32) first; then
    ``kernels.mxfp4_wo_matmul`` (K14 for a fp4-magic weight)."""
    x2, lead = _flatten_batch(x)
    if w.act_elem_dtype is not None:
        bs = (1, MX_BLOCK)
        qx, sx = to_mx(x2, bs, w.act_elem_dtype, w.scale_mode)
        if w.act_elem_dtype == "float4_e2m1fn":
            vx = decode_fp4_e2m1(qx, torch.float32)
        else:
            vx = qx.to(torch.float32)
        x2 = P.apply_blockwise(vx, bs, lambda v, s: v * s, e8m0_decode(sx)).to(x.dtype)
    y = kernels.mxfp4_wo_matmul(x2, w)
    return _unflatten_batch(_maybe_bias(y.to(x.dtype), b), lead)


@implements("linear", NVFP4Array)
def _nvfp4_linear(x, w: NVFP4Array, b):
    """(ref: ao_tpu ops/linear.py:372) With ``act_quant`` the activation is
    fake-quantized to NVFP4 along K (block 16, its own per-tensor scale or
    the calibrated one) first; then ``kernels.nvfp4_wo_matmul`` (K14)."""
    x2, lead = _flatten_batch(x)
    if w.act_quant:
        bs = (1, NVFP4_BLOCK)
        codes, bscale, pts = nvfp4_quantize(x2, bs, per_tensor=True,
                                            fixed_per_tensor_scale=w.act_per_tensor_scale)
        total = bscale.to(torch.float32)
        if pts is not None:
            total = total * pts
        x2 = P.apply_blockwise(decode_fp4_e2m1(codes, torch.float32), bs, lambda v, s: v * s,
                               total).to(x.dtype)
    y = kernels.nvfp4_wo_matmul(x2, w)
    return _unflatten_batch(_maybe_bias(y.to(x.dtype), b), lead)


# ---------------------------------------------------------------------------
# NF4 and other 16-entry codebooks
# ---------------------------------------------------------------------------

_NF4_LUT = {}  # device -> the NF4 codebook in bf16, as K15 reads it


def _nf4_lut(device: torch.device) -> torch.Tensor:
    lut = _NF4_LUT.get(device)
    if lut is None:
        lut = _NF4_LUT[device] = NF4_CODEBOOK.to(device).to(torch.bfloat16)
    return lut


def try_lut4_linear(x2, word, scalers, codebook, group_size):
    """The fused-LUT route of the magic-layout 16-entry-codebook containers
    (ref: ao_tpu ops/linear.py:435): 2- and 3-bit codebooks are padded to 16
    entries (their codes never reach the pad). Returns the (M, N) bf16
    product, or None where K15 does not take the call (the caller
    dequantizes and multiplies)."""
    cb = torch.as_tensor(codebook, device=x2.device)
    if cb.shape[-1] < 16:
        cb = torch.nn.functional.pad(cb, (0, 16 - cb.shape[-1]))
    return kernels.lut4_wo_matmul(x2, word, scalers, cb, group_size)


@implements("linear", NF4Array)
def _nf4_linear(x, w: NF4Array, b):
    """(ref: ao_tpu ops/linear.py:456) A magic-layout weight goes through
    the LUT kernel K15 with the scalers dequantized from int8 (per call, as
    the reference does); otherwise dequantize + one matmul."""
    x2, lead = _flatten_batch(x)
    if w.layout == "magic":
        y = try_lut4_linear(x2, w.qdata, w._scalers(), _nf4_lut(x2.device), w.block_size[0])
        if y is not None:
            return _unflatten_batch(_maybe_bias(y.to(x.dtype), b), lead)
    y = torch.matmul(x2, w.dequantize(x2.dtype))
    return _unflatten_batch(_maybe_bias(y.to(x.dtype), b), lead)


# ---------------------------------------------------------------------------
# Sparse
# ---------------------------------------------------------------------------


@implements("linear", Sparse24Int4Array)
def _sparse24_int4_linear(x, w: Sparse24Int4Array, b):
    """(ref: ao_tpu ops/linear.py:483) Dequantize and decompress, then one
    matmul, as the reference does (its TPU has no sparse matrix unit)."""
    y = x @ w.dequantize(x.dtype)
    return y if b is None else y + b


@implements("linear", Sparse24Array)
def _sparse24_linear(x, w: Sparse24Array, b):
    """(ref: ao_tpu ops/linear.py:493) Decompress, then one matmul."""
    x2, lead = _flatten_batch(x)
    y = torch.matmul(x2, w.dequantize(x2.dtype))
    return _unflatten_batch(_maybe_bias(y.to(x.dtype), b), lead)


@implements("linear", BlockSparseArray)
def _blocksparse_linear(x, w: BlockSparseArray, b):
    """(ref: ao_tpu ops/linear.py:501) ``kernels.bsr_matmul``: K18 on the
    card, the ragged route elsewhere."""
    x2, lead = _flatten_batch(x)
    y = kernels.bsr_matmul(x2, w)
    return _unflatten_batch(_maybe_bias(y.to(x.dtype), b), lead)
