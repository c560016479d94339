"""Kernel backend selection + the plain PyTorch implementations of the hot ops.

PyTorch port of the int4 weight-only and int8-activation parts of
``ao_tpu/ops/kernels.py``.

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

# Largest M the int4 kernel takes (ao_tpu/ops/kernels.py:179): above it the
# plain path dequantizes once and calls torch.matmul, as the reference
# leaves that case to XLA. This gate and the layout are the whole route
# rule, decided before the call: a magic-layout weight whose shape the
# kernel does not take (int4_matmul.check_shapes) makes the kernel's
# wrapper raise, on the card and on the CPU alike, and the caller picks
# the "torch" backend for it. The decode-attention route in models/llama.py
# follows the same rule.
INT4_KERNEL_MAX_M = 1024

# W4A8 (int8 activations x int4 weights, ops/linear.py): above this M the
# prefill route requantizes the int4 weight to per-channel int8 (K4) and
# runs one int8 GEMM; at or below it the W4A8 matmul (K3) takes the call
# (the reference's gate, ao_tpu/ops/linear.py:209).
W4A8_REQUANT_ABOVE_M = 512


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


# ---------------------------------------------------------------------------
# int8 dynamic-activation x int8 weight
# ---------------------------------------------------------------------------


def int8_dynamic_matmul(qx, sx, zx, qw, sw, zw, wbs, out_dtype=torch.bfloat16):
    """Integer matmul with int32 accumulation (ref: ao_tpu kernels.py:109).

    y = (qx - zx) @ (qw - zw) * sx * sw
      = [qx@qw - zx*colsum(qw) - rowsum(qx)*zw + K*zx*zw] * sx * sw

    The per-channel, per-token core is ``torch._int_mm`` (int32 out), on the
    card and on the CPU; on the card it needs M > 16 and K, N multiples of
    8, and cuBLAS runs it as the "TN" int8 GEMM when ``qw`` is column-major
    (what the requant kernel writes). Per-group weight scales fall back to
    dequantize + f32 matmul, as the reference does.
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

    acc = torch._int_mm(qx, qw).to(torch.float32)
    if zx is not None:
        colsum_w = torch.sum(qw.to(torch.int32), dim=0, keepdim=True).to(torch.float32)
        acc = acc - zx.reshape(m, 1).to(torch.float32) * colsum_w
    if zw is not None:
        rowsum_x = torch.sum(qx.to(torch.int32), dim=1, keepdim=True).to(torch.float32)
        zw_f = zw.reshape(1, -1).to(torch.float32)
        acc = acc - rowsum_x * zw_f
        if zx is not None:
            acc = acc + k * zx.reshape(m, 1).to(torch.float32) * zw_f
    y = acc * sx.reshape(-1, 1).to(torch.float32) * sw.reshape(1, -1).to(torch.float32)
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# int4 weight-only (groupwise)
# ---------------------------------------------------------------------------


def int4_wo_matmul(x, packed, scale, zp, group_size, zp_domain, layout=None):
    """x (M, K); packed uint8 (K/2, N) split-half layout or int32 (K/8, N)
    magic/magic8 layout; scale/zp (K/g, N). Returns (M, N): bf16 from the
    kernel route, x.dtype from the plain route."""
    if layout is None:
        layout = "magic" if packed.dtype == torch.int32 else "halves"
    from ao_tpu_torch.ops.hopper import int4_matmul as k1

    if (layout == "magic" and packed.ndim == 2 and x.shape[0] <= INT4_KERNEL_MAX_M
            and use_kernel(x)):
        return k1.int4_wo_magic(x, packed, scale, zp, group_size, zp_domain)
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
