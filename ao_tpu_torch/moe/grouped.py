"""Grouped (ragged) matmul over stacked expert weights, quantized-aware.

PyTorch port of ``ao_tpu/moe/grouped.py``. y[t] = x[t] @ W[e(t)], where
e(t) is the expert owning row t: the rows come sorted by expert and
``group_sizes[e]`` counts expert e's rows (they sum to T, what
``moe.layer.dispatch`` gives). Each quantized container has its branch, in
the reference's order; the int4 "magic" and "magic8" stacks take the
hand-written kernel K13 (``ops/hopper/grouped_matmul.py``) where its
``takes`` allows: the magic form at any T on CUDA tensors, the magic8 form
(and either on the CPU, through K13's plain versions) at
T <= ``kernels.GROUPED_KERNEL_MAX_T`` rows, the reference's gate; every
other case dequantizes and runs the ragged dot.

The reference gates its TPU kernel at 256 rows because that kernel sums E
masked dense products (E T K N multiply-adds); the port's row tiles multiply
only each expert's own rows, so on the card the magic form keeps K13 at
prefill row counts too. The magic8 form keeps the gate: above it the
reference's fallback multiplies the unquantized activations, a different
function from K13's int8 one.

The ragged dot (the reference's ``jax.lax.ragged_dot``, an XLA product
outside any Pallas kernel) is ``torch._grouped_mm`` over the offsets
``cumsum(group_sizes)`` (int32) for float operands: one call that reads the
offsets on the device, so the MoE decode route never waits on the host.
PyTorch 2.11 on the H100 takes bf16 and f32 operands (row- or column-major
expert stacks) and returns the operands' dtype only (it refuses
``out_dtype=float32`` for bf16), so a bf16 product is rounded to bf16 once,
where the reference keeps f32 until its caller's cast; the CPU build takes
bf16, fp16 and f32. It takes no integer operands: the int8 x int8 dot of
dynamic int8 experts loops over the experts with ``torch._int_mm`` (exact
int32 sums, as the reference's), reading the offsets on the host once. The
fp8 x fp8 dot runs as an f32 ``_grouped_mm`` of the upcast values (fp8
products are exact in f32, and the sums are f32, as the reference's).

The straight-through backward of the quantized branches
(``frozen_grouped_ste``) comes with the training slice: the port is
inference only, under ``torch.no_grad``.
"""

from __future__ import annotations

import torch

from ao_tpu_torch.ops import kernels
from ao_tpu_torch.ops.act_quant import quantize_activation
from ao_tpu_torch.ops.dispatch import implements, lookup
from ao_tpu_torch.ops.hopper import grouped_matmul as k13
# (E,) group sizes -> (T,) int32 expert id per (sorted) row, on the device
from ao_tpu_torch.ops.hopper.grouped_matmul import expert_ids as token_expert_ids
from ao_tpu_torch.quantization.qarrays.base import QuantizedArray
from ao_tpu_torch.quantization.qarrays.float8 import Float8Array
from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
from ao_tpu_torch.quantization.qarrays.int8 import Int8Array
from ao_tpu_torch.quantization.qarrays.mx import MXArray
from ao_tpu_torch.quantization.qarrays.nvfp4 import NVFP4Array


def ragged_dot(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x (T, K) @ w (E, K, N) by groups of rows: (T, N), int32 for int8
    operands, else x's dtype (see the module doc)."""
    if x.dtype == torch.int8:
        out = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.int32, device=x.device)
        lo = 0
        for e, n in enumerate(group_sizes.tolist()):
            if n:
                out[lo:lo + n] = kernels._int_mm(x[lo:lo + n], w[e])
            lo += n
        return out
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    return torch._grouped_mm(x, w.to(x.dtype), offs=offs)


def grouped_matmul(x: torch.Tensor, w, group_sizes: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x (T, K) sorted by expert; w (E, K, N) plain or QuantizedArray;
    group_sizes (E,) int32. Returns (T, N)."""
    if isinstance(w, QuantizedArray):
        return lookup("grouped_matmul", type(w))(x, w, group_sizes, out_dtype)
    return ragged_dot(x, w, group_sizes).to(out_dtype or x.dtype)


def _is_per_expert_rowwise(scale_shape, w_shape) -> bool:
    e, _, n = w_shape
    return tuple(scale_shape) == (e, 1, n)


def _epilogue_scale(y, scale, group_sizes):
    """y (T, N) f32; scale (E, 1, N); returns y * scale[e(t)]."""
    ids = token_expert_ids(group_sizes, y.shape[0])
    return y * scale[:, 0, :].to(y.dtype)[ids]


def _check_3d(w) -> None:
    if w.ndim != 3:
        raise ValueError(f"grouped_matmul needs (E, K, N) weights, got {w.shape}")


@implements("grouped_matmul", Int8Array)
def _int8_grouped(x, w: Int8Array, group_sizes, out_dtype):
    out_dtype = out_dtype or x.dtype
    _check_3d(w)
    if w.act_pre_scale is not None:
        x = x * w.act_pre_scale.to(x.dtype)
    rowwise = _is_per_expert_rowwise(w.scale.shape, w.shape)
    if rowwise and w.zero_point is None and w.act_quant is None:
        # weight-only: hp act x int8 qdata, per-expert scale epilogue
        y = ragged_dot(x, w.qdata, group_sizes).to(torch.float32)
        return _epilogue_scale(y, w.scale, group_sizes).to(out_dtype)
    if rowwise and w.zero_point is None and w.act_quant is not None:
        # dynamic int8 act: int8 x int8 -> int32
        qx, sx, zx = quantize_activation(x, w.act_quant)
        acc = ragged_dot(qx, w.qdata, group_sizes).to(torch.float32)
        if zx is not None:
            # per-token asymmetric act: correction term -zx * colsum(Wq[e])
            ids = token_expert_ids(group_sizes, acc.shape[0])
            colsum = torch.sum(w.qdata.to(torch.int32), dim=1).to(torch.float32)  # (E, N)
            acc = acc - zx.reshape(-1, 1).to(torch.float32) * colsum[ids]
        y = acc * sx.reshape(-1, 1).to(torch.float32)
        return _epilogue_scale(y, w.scale, group_sizes).to(out_dtype)
    # general fallback: dequantize experts then ragged dot
    return ragged_dot(x, w.dequantize(x.dtype), group_sizes).to(out_dtype)


@implements("grouped_matmul", Float8Array)
def _fp8_grouped(x, w: Float8Array, group_sizes, out_dtype):
    out_dtype = out_dtype or x.dtype
    _check_3d(w)
    if w.act_pre_scale is not None:
        x = x * w.act_pre_scale.to(x.dtype)
    rowwise = _is_per_expert_rowwise(w.scale.shape, w.shape)
    if rowwise and w.act_quant is None:
        y = ragged_dot(x, w.qdata, group_sizes).to(torch.float32)
        return _epilogue_scale(y, w.scale, group_sizes).to(out_dtype)
    if rowwise and w.act_quant is not None:
        # fp8 act x fp8 weight, f32 products and sums
        qx, sx, _ = quantize_activation(x, w.act_quant)
        acc = ragged_dot(qx.to(torch.float32), w.qdata, group_sizes)
        y = acc * sx.reshape(-1, 1).to(torch.float32)
        return _epilogue_scale(y, w.scale, group_sizes).to(out_dtype)
    return ragged_dot(x, w.dequantize(x.dtype), group_sizes).to(out_dtype)


def k13_takes_rows(t: int, layout: str, on_cuda: bool) -> bool:
    """Whether K13 takes T routed rows of an int4 ``layout`` stack: the
    magic form at any T on CUDA tensors, else T <= GROUPED_KERNEL_MAX_T
    (the reference's gate; see the module doc)."""
    return t <= kernels.GROUPED_KERNEL_MAX_T or (layout == "magic" and on_cuda)


@implements("grouped_matmul", Int4Array)
def _int4_grouped(x, w: Int4Array, group_sizes, out_dtype):
    """int4 grouped: magic / magic8 expert stacks take K13 where its
    ``takes`` allows, at decode row counts (T <= GROUPED_KERNEL_MAX_T) and,
    for the magic form on CUDA tensors, at any T; the fallback dequantizes
    before the ragged dot, on the unquantized x (the reference's W4A8
    prefill fallback does not quantize the activations)."""
    out_dtype = out_dtype or x.dtype
    _check_3d(w)
    if w.act_pre_scale is not None:
        x = x * w.act_pre_scale.to(x.dtype)
    t = x.shape[0]
    k, n = w.shape[-2], w.shape[-1]
    if (k13_takes_rows(t, w.layout, x.is_cuda) and w.layout in ("magic", "magic8")
            and k13.takes(k, n, w.group_size, w.layout) and kernels.use_kernel(x)):
        aq = w.act_quant
        if (w.layout == "magic8" and aq is not None and aq.dtype == "int8"
                and aq.symmetric):
            qx, sx, zx = quantize_activation(x, aq)
            if zx is None:
                return k13.int4_grouped_w4a8(qx, sx, w.qdata, w.scale, w.zero_point,
                                             group_sizes, w.group_size,
                                             w.zero_point_domain).to(out_dtype)
        if w.layout == "magic":
            return k13.int4_grouped_magic(x, w.qdata, w.scale, w.zero_point, group_sizes,
                                          w.group_size, w.zero_point_domain).to(out_dtype)
    return ragged_dot(x, w.dequantize(x.dtype), group_sizes).to(out_dtype)


@implements("grouped_matmul", MXArray)
def _mx_grouped(x, w: MXArray, group_sizes, out_dtype):
    return ragged_dot(x, w.dequantize(x.dtype), group_sizes).to(out_dtype or x.dtype)


@implements("grouped_matmul", NVFP4Array)
def _nvfp4_grouped(x, w: NVFP4Array, group_sizes, out_dtype):
    return ragged_dot(x, w.dequantize(x.dtype), group_sizes).to(out_dtype or x.dtype)
