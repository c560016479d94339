"""Kernel backend selection + the plain PyTorch implementations of the hot ops.

PyTorch port of ``ao_tpu/ops/kernels.py`` for int8 (weight-only and
dynamic-activation), int4 weight-only and float8 weights, and the routes of
the 4-bit float, codebook and block-sparse weights that the reference takes
in ``ao_tpu/ops/linear.py`` (MXFP4 and NVFP4 through K14, 16-entry LUTs such
as NF4 through K15, BSR through K18).

Backends:
  * "auto"  — the hand-written kernel (ops/hopper) wherever the reference
              would take its Pallas kernel; the kernel's wrapper launches it
              on a CUDA tensor and runs its plain version on a CPU tensor
  * "cuda"  — as "auto", but a CPU tensor is refused
  * "torch" — plain PyTorch everywhere: dequantize, then ``torch.matmul``
              (the reference's "xla" and "emulated" backends)

The backend is process state, set with ``set_backend`` or the ``backend``
context manager, as in the reference.
"""

from __future__ import annotations

import contextlib

import torch

from ao_tpu_torch.quantization import primitives as P

_BACKENDS = ("auto", "cuda", "torch")
_BACKEND = "auto"

# Largest M the int4 kernels take (ao_tpu/ops/kernels.py:179): above it the
# plain path dequantizes once and calls torch.matmul, as the reference
# leaves that case to XLA. Below it a magic-layout weight takes K1 where
# ``int4_matmul.takes`` allows and a split-half weight K11 where
# ``int4_matmul.takes_halves`` allows; every other shape takes dequantize +
# matmul, as the reference falls back from its kernels on UnsupportedShape.
INT4_KERNEL_MAX_M = 1024

# W4A8 (int8 activations x int4 weights, ops/linear.py): above this M the
# prefill route requantizes the int4 weight to per-channel int8 (K4) and
# runs one int8 GEMM; at or below it the W4A8 matmul (K3) takes the call
# (the reference's gate, ao_tpu/ops/linear.py:209).
W4A8_REQUANT_ABOVE_M = 512

# Largest M the int8 weight-only kernel K10 takes (the reference's gate,
# ao_tpu/ops/kernels.py:82); above it one torch.matmul over the int8 weight
# cast to x's dtype, the reference's XLA path.
INT8_KERNEL_MAX_M = 1024

# Largest M the fp4 kernel K14 and the LUT kernel K15 take (the reference's
# gates, ao_tpu/ops/linear.py:351,388,440); above it, and for shapes their
# ``takes`` refuses, dequantize + one torch.matmul, as the reference does.
FP4_KERNEL_MAX_M = 1024
LUT4_KERNEL_MAX_M = 1024

# Largest row count T the MoE grouped kernel K13 takes (the reference's gate,
# ao_tpu/moe/grouped.py:200): at or below it an int4 "magic" or "magic8"
# expert stack goes to K13 where ``grouped_matmul.takes`` allows, above it
# (prefill) the experts are dequantized for one ragged dot; on CUDA tensors
# a "magic" stack takes K13 at any T (moe/grouped.py says why).
GROUPED_KERNEL_MAX_T = 256

# torch._int_mm on the card takes M > 16 only: smaller M is padded with rows
# of zeros up to this many (a multiple of 8); K and N go up to multiples of 8
INT_MM_MIN_ROWS = 32


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {name!r}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


@contextlib.contextmanager
def backend(name: str):
    prev = _BACKEND
    set_backend(name)
    try:
        yield
    finally:
        set_backend(prev)


def use_kernel(x: torch.Tensor) -> bool:
    """Whether the hot op on ``x`` goes to a kernel wrapper."""
    if _BACKEND == "torch":
        return False
    if _BACKEND == "cuda" and x.device.type != "cuda":
        raise ValueError("backend 'cuda' runs the kernels on CUDA tensors only")
    return True


def _is_col_major(w: torch.Tensor) -> bool:
    return w.ndim == 2 and w.t().is_contiguous()


# ---------------------------------------------------------------------------
# int8 weight-only
# ---------------------------------------------------------------------------


def int8_wo_matmul(x, qw, sw, zw, wbs):
    """x (M, K) hp; qw int8 (K, N); sw the rank-preserved scale
    (ref: ao_tpu kernels.py:77). A symmetric per-output-column weight takes
    K10 at M <= 1024 within its limits (2-D x, K and N multiples of 128,
    the column-major weight ``Int8Array`` stores); otherwise the scale
    applies after one matmul over the weight cast to x's dtype. Other
    granularities dequantize, then one matmul."""
    from ao_tpu_torch.ops.hopper import int8_matmul as k10

    k, n = qw.shape[-2], qw.shape[-1]
    if zw is None and tuple(sw.shape) == (1, n):
        if (x.ndim == 2 and x.shape[0] <= INT8_KERNEL_MAX_M and k10.takes(k, n)
                and _is_col_major(qw) and use_kernel(x)):
            return k10.int8_wo_matmul(x, qw, sw)
        y = torch.matmul(x, qw.to(x.dtype))
        return y * sw.reshape(1, n).to(y.dtype)
    w_dq = P.dequantize_affine(qw, wbs, sw, zw, output_dtype=x.dtype)
    return torch.matmul(x, w_dq)


# ---------------------------------------------------------------------------
# int8 dynamic-activation x int8 weight
# ---------------------------------------------------------------------------


def _int_mm(qx, qw):
    """``torch._int_mm`` (int32 out) within the card's limits: M > 16 and K,
    N multiples of 8. On the card, rows, K and columns of zeros pad the
    operands up to them (a decode step's M = batch, SAM's 4-wide IoU head)
    and are sliced off; the sums are exact either way."""
    m, k = qx.shape
    n = qw.shape[1]
    if qx.device.type != "cuda":
        return torch._int_mm(qx, qw)
    pm = INT_MM_MIN_ROWS - m if m <= 16 else 0
    pk, pn = -k % 8, -n % 8
    if pm or pk:
        qx = torch.nn.functional.pad(qx, (0, pk, 0, pm))
    if pk or pn:  # padded through its transpose: column-major, as Int8Array keeps it
        qw = torch.nn.functional.pad(qw.t(), (0, pk, 0, pn)).t()
    y = torch._int_mm(qx, qw)
    return y[:m, :n] if (pm or pn) else y


def int8_dynamic_matmul(qx, sx, zx, qw, sw, zw, wbs, out_dtype=torch.bfloat16):
    """Integer matmul with int32 accumulation (ref: ao_tpu kernels.py:109).

    y = (qx - zx) @ (qw - zw) * sx * sw
      = [qx@qw - zx*colsum(qw) - rowsum(qx)*zw + K*zx*zw] * sx * sw

    The per-channel, per-token core is ``torch._int_mm`` (int32 out), on the
    card and on the CPU; on the card it needs M > 16 and K, N multiples of
    8 (``_int_mm`` pads to them), and cuBLAS runs it as the "TN" int8 GEMM
    when ``qw`` is column-major
    (what the requant kernel writes and ``Int8Array`` stores). Per-group
    weight scales fall back to dequantize + f32 matmul, as the reference
    does.
    """
    m, k = qx.shape
    n = qw.shape[-1]
    per_channel_w = tuple(sw.shape) == (1, n) or sw.numel() == 1
    per_token_x = tuple(sx.shape) == (m, 1) or sx.numel() == 1
    if not (per_channel_w and per_token_x):
        x_dq = P.dequantize_affine(
            qx, (1, k) if tuple(sx.shape) == (m, 1) else (m, k), sx, zx,
            output_dtype=torch.float32,
        )
        w_dq = P.dequantize_affine(qw, wbs, sw, zw, output_dtype=torch.float32)
        return torch.matmul(x_dq, w_dq).to(out_dtype)

    acc = _int_mm(qx, qw).to(torch.float32)
    if zx is not None:
        colsum_w = torch.sum(qw.to(torch.int32), dim=0, keepdim=True).to(torch.float32)
        # zx is per token (M, 1) or a static per-tensor (1, 1); the
        # reference's reshape(m, 1) refuses the latter (ROADMAP Queue 3)
        acc = acc - zx.reshape(-1, 1).to(torch.float32) * colsum_w
    if zw is not None:
        rowsum_x = torch.sum(qx.to(torch.int32), dim=1, keepdim=True).to(torch.float32)
        zw_f = zw.reshape(1, -1).to(torch.float32)
        acc = acc - rowsum_x * zw_f
        if zx is not None:
            acc = acc + k * zx.reshape(-1, 1).to(torch.float32) * zw_f
    y = acc * sx.reshape(-1, 1).to(torch.float32) * sw.reshape(1, -1).to(torch.float32)
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# int4 weight-only (groupwise)
# ---------------------------------------------------------------------------


def int4_wo_matmul(x, packed, scale, zp, group_size, zp_domain, layout=None):
    """x (M, K); packed uint8 (K/2, N) split-half layout or int32 (K/8, N)
    magic/magic8 layout; scale/zp (K/g, N). Returns (M, N): bf16 from the
    kernel routes (K1 magic, K11 split-half), x.dtype from the plain route."""
    if layout is None:
        layout = "magic" if packed.dtype == torch.int32 else "halves"
    from ao_tpu_torch.ops.hopper import int4_matmul as k1

    if (layout == "magic" and packed.ndim == 2 and x.ndim == 2
            and x.shape[0] <= INT4_KERNEL_MAX_M
            and k1.takes(8 * packed.shape[0], packed.shape[1], group_size) and use_kernel(x)):
        return k1.int4_wo_magic(x, packed, scale, zp, group_size, zp_domain)
    if (layout == "halves" and packed.ndim == 2 and x.ndim == 2
            and x.shape[0] <= INT4_KERNEL_MAX_M
            and k1.takes_halves(x.shape[1], packed.shape[1], group_size) and use_kernel(x)):
        # K11: the split-half layout (K/g % 4 != 0, as ViT-B's dim 768 has)
        return k1.int4_wo_matmul(x, packed, scale, zp, group_size, zp_domain)
    return _int4_wo_matmul_torch(x, packed, scale, zp, group_size, zp_domain, layout)


def _int4_wo_matmul_torch(x, packed, scale, zp, group_size, zp_domain, layout):
    """Dequantize to x.dtype, then one ``torch.matmul``
    (ref: ao_tpu kernels.py:198 ``_int4_wo_matmul_xla``)."""
    from ao_tpu_torch.quantization.qarrays.int4 import (
        unpack_int4, unpack_int4_magic, unpack_int4_magic8,
    )

    bs = (group_size, 1)
    if layout == "magic":
        u = unpack_int4_magic(packed, group_size).to(torch.int32) - 8
    elif layout == "magic8":
        u = unpack_int4_magic8(packed, group_size).to(torch.int32) - 8
    else:
        u = unpack_int4(packed, group_size, axis=-2).to(torch.int32) - 8
    if zp_domain is P.ZeroPointDomain.FLOAT:
        w_dq = P.dequantize_affine_tinygemm(u, bs, scale, zp, -8, 7, output_dtype=x.dtype)
    else:
        w_dq = P.dequantize_affine(u, bs, scale, zp, output_dtype=x.dtype)
    return torch.matmul(x, w_dq)


# ---------------------------------------------------------------------------
# float8
# ---------------------------------------------------------------------------


def fp8_wo_matmul(x, qw, sw, wbs):
    """fp8 weight-only: dequantize to x's dtype, then one matmul
    (ref: ao_tpu kernels.py:278)."""
    w_dq = P.dequantize_float8(qw, wbs, sw, output_dtype=x.dtype)
    return torch.matmul(x, w_dq)


def _scaled_mm_takes(qx, qw) -> bool:
    """What ``torch._scaled_mm`` takes with rowwise scales: CUDA tensors
    (PyTorch 2.11's CPU build takes per-tensor scales only), e4m3 operands
    (cuBLAS has no e5m2 x e5m2 product), K and N multiples of 16, qx
    row-major and qw column-major."""
    k, n = qw.shape
    return (qx.device.type == "cuda" and qx.dtype == qw.dtype == torch.float8_e4m3fn
            and k % 16 == 0 and n % 16 == 0 and qx.is_contiguous() and _is_col_major(qw))


def fp8_dynamic_matmul(qx, sx, qw, sw, wbs, out_dtype=torch.bfloat16):
    """fp8 activations x fp8 weights (ref: ao_tpu kernels.py:282).

    * rowwise scales (sx (M, 1) or (1, 1), sw (1, N) or (1, 1)): on the
      card one ``torch._scaled_mm`` with f32 accumulation and bf16 out (the
      reference's ``dot_general`` outside any Pallas kernel), a single scale
      on one side only broadcast to rowwise; on the CPU, and for operands
      it does not take (e5m2), the same product in f32 with the same
      epilogue, as the reference computes it;
    * DeepSeek blockwise scales (sx (M, K/128), sw (K/128, N/128)): the
      kernel K17 (``ops/hopper/fp8_matmul.py``) within its limits, outside
      the "torch" backend; on the card "auto" takes it, as the H100 has fp8
      tensor cores (the reference's "auto" keeps its kernel opt-in on TPUs
      without them, ao_tpu/ops/kernels.py:14-18);
    * otherwise the emulated path: dequantize both sides in f32, one matmul.
    """
    from ao_tpu_torch.ops.hopper import fp8_matmul as k17

    m, k = qx.shape
    n = qw.shape[-1]
    rowwise = tuple(sx.shape) in ((m, 1), (1, 1)) and tuple(sw.shape) in ((1, n), (1, 1))
    if rowwise:
        sxf, swf = sx.to(torch.float32), sw.to(torch.float32)
        if not _scaled_mm_takes(qx, qw):
            acc = torch.matmul(qx.to(torch.float32), qw.to(torch.float32))
            return (acc * sxf.reshape(-1, 1) * swf.reshape(1, -1)).to(out_dtype)
        if sxf.numel() != 1 or swf.numel() != 1:
            sxf = sxf.reshape(-1, 1).expand(m, 1).contiguous()
            swf = swf.reshape(1, -1).expand(1, n).contiguous()
        y = torch._scaled_mm(qx, qw, scale_a=sxf, scale_b=swf, out_dtype=torch.bfloat16)
        return y.to(out_dtype)
    if use_kernel(qx) and k17.takes(qx, sx, qw, sw):
        return k17.fp8_blockwise_matmul(qx, sx, qw, sw).to(out_dtype)
    xbs = tuple(qx.shape[i] // sx.shape[i] for i in range(qx.ndim))
    x_dq = P.dequantize_float8(qx, xbs, sx, output_dtype=torch.float32)
    w_dq = P.dequantize_float8(qw, wbs, sw, output_dtype=torch.float32)
    return torch.matmul(x_dq, w_dq).to(out_dtype)


# ---------------------------------------------------------------------------
# fp4 (MXFP4, NVFP4) and 16-entry LUT (NF4) weight-only
# ---------------------------------------------------------------------------


def mxfp4_wo_matmul(x, w):
    """x (M, K) @ an MXArray w (ref: ao_tpu/ops/linear.py:350-364): K14
    takes an e2m1 weight in the fp4-magic layout at M <= 1024 within its
    ``takes``; any other element type, layout or shape dequantizes to x's
    dtype, then one matmul. Returns bf16 from K14, x.dtype otherwise."""
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14

    k, n = w.shape[-2], w.shape[-1]
    if (w.elem_dtype == "float4_e2m1fn" and w.layout == "magic" and x.ndim == 2
            and x.shape[0] <= FP4_KERNEL_MAX_M and k14.takes(k, n) and use_kernel(x)):
        return k14.mxfp4_wo_matmul(x, w.qdata, w.scale)
    return torch.matmul(x, w.dequantize(x.dtype))


def nvfp4_wo_matmul(x, w):
    """x (M, K) @ an NVFP4Array w (ref: ao_tpu/ops/linear.py:388-403): K14
    takes a fp4-magic weight at M <= 1024 within its ``takes`` (raw e4m3
    scales, as an older checkpoint may hold them, are packed to pair-words
    first, as the reference's wrapper does); otherwise dequantize to x's
    dtype, then one matmul."""
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14
    from ao_tpu_torch.quantization.qarrays.fp4 import pack_nvfp4_scale_pairs

    k, n = w.shape[-2], w.shape[-1]
    if (w.layout == "magic" and x.ndim == 2 and x.shape[0] <= FP4_KERNEL_MAX_M
            and k14.takes(k, n) and use_kernel(x)):
        sw = w.scale if w.scale.dtype == torch.int32 else pack_nvfp4_scale_pairs(w.scale)
        return k14.nvfp4_wo_matmul(x, w.qdata, sw, w.per_tensor_scale)
    return torch.matmul(x, w.dequantize(x.dtype))


def lut4_wo_matmul(x, word, scalers, codebook, group_size):
    """x (M, K) @ (codebook[codes] * scalers) over magic-layout code words
    (K/8, N) (ref: ao_tpu/ops/linear.py:435-453): K15 at M <= 1024 within
    its ``takes``. Returns the (M, N) bf16 product, or None where the
    kernel does not take the call (the caller dequantizes and multiplies)."""
    from ao_tpu_torch.ops.hopper import lut4_matmul as k15

    k, n = 8 * word.shape[0], word.shape[1]
    n_luts = 0 if codebook.ndim == 1 else codebook.shape[0]
    if (x.ndim != 2 or x.shape[0] > LUT4_KERNEL_MAX_M
            or not k15.takes(k, n, group_size, n_luts) or not use_kernel(x)):
        return None
    return k15.lut4_wo_magic(x, word, scalers, codebook, group_size)


# ---------------------------------------------------------------------------
# block-sparse (BSR)
# ---------------------------------------------------------------------------


def bsr_matmul(x2, w):
    """x2 (M, K) @ a BlockSparseArray w (ref: ao_tpu/ops/linear.py:501-522).
    On a CUDA tensor outside "torch", K18 at any M where
    ``bsr_matmul.takes`` allows (bf16 out), as the H100 is the kind of chip
    the reference keeps its kernel for; on a CPU tensor, under "torch" and
    for block sizes K18 refuses, the ragged route
    (``BlockSparseArray.matmul``, x.dtype out), the reference's "auto"."""
    from ao_tpu_torch.ops.hopper import bsr_matmul as k18

    k, n = w.shape
    if use_kernel(x2) and x2.device.type == "cuda" and k18.takes(w.blocksize, k, n):
        return k18.bsr_matmul(x2, w)
    return w.matmul(x2)
