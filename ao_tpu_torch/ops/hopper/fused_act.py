"""K12 (SwiGLU part): gated-MLP activation + per-token int8 quantize, on Hopper.

Counterpart of ``ao_tpu/ops/pallas/fused_act.py::silu_mul_quant_pallas``
(kernel ``_silu_mul_quant_kernel``). The CUDA source is ``ao_tpu_torch/csrc/
fused_act.cu``; its header says what bounds the kernel on the H100 and how
the design meets it. The file's other kernels (``gelu_quant_pallas``,
``norm_modulate_quant_pallas``) are not ported yet.

``silu_mul_quant`` runs the kernel on CUDA tensors and its plain PyTorch
version, ``silu_mul_quant_plain``, on CPU tensors, and raises ValueError on
either for a shape the kernel does not take.
"""

from __future__ import annotations

import ctypes

import torch

from ao_tpu_torch.ops.act_quant import _row_quant
from ao_tpu_torch.ops.hopper import build

ACTS = ("silu", "gelu")
MAX_D = 57344  # the kernel keeps a row's f32 gate in 4*D bytes of shared memory

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("fused_act")
        lib.ao_silu_mul_quant.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.ao_silu_mul_quant.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_shapes(a: torch.Tensor, b: torch.Tensor, act: str) -> None:
    """Raise ValueError for inputs the kernel does not take: a and b of one
    shape (B, T, D), D % 128 == 0 (the reference's rule) and D <= MAX_D."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if a.ndim != 3 or tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"silu_mul_quant takes a and b of one shape (B, T, D), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    d = a.shape[-1]
    if d % 128 or d > MAX_D:
        raise ValueError(f"D={d} must be a multiple of 128 and at most {MAX_D}")


def silu_mul_quant_plain(a, b, act: str = "silu"):
    """The kernel's function in plain PyTorch: y = act(a) * b in f32, then
    the per-row int8 quantize of ``ops/act_quant._row_quant``. Returns
    (q int8, scale f32 (..., 1))."""
    af = a.to(torch.float32)
    if act == "silu":
        g = af * torch.sigmoid(af)
    else:
        g = torch.nn.functional.gelu(af, approximate="tanh")
    return _row_quant(g * b.to(torch.float32))


def _launch(a, b, act: str):
    dev = a.device
    if a.dtype not in (torch.bfloat16, torch.float32) or b.dtype != a.dtype:
        raise ValueError(f"silu_mul_quant kernel takes bf16 or f32 a and b of one dtype, "
                         f"got {a.dtype} and {b.dtype}")
    for name, t in (("a", a), ("b", b)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"silu_mul_quant: {name} must be contiguous, 16-byte aligned "
                             f"and on {dev}")
    bb, t, d = a.shape
    q = torch.empty((bb, t, d), dtype=torch.int8, device=dev)
    scale = torch.empty((bb, t, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_silu_mul_quant(
            a.data_ptr(), b.data_ptr(), q.data_ptr(), scale.data_ptr(), bb * t, d,
            ACTS.index(act), int(a.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"silu_mul_quant kernel launch failed: CUDA error {err}")
    silu_mul_quant.launches += 1
    return q, scale


def silu_mul_quant(a, b, act: str = "silu"):
    """Gated-MLP product (silu(a)*b SwiGLU, or tanh-gelu(a)*b GeGLU with
    ``act="gelu"``) + per-token int8 quantize. a, b (B, T, D). Returns
    (q int8 (B, T, D), scale f32 (B, T, 1)): the kernel on CUDA tensors,
    its plain version on CPU tensors."""
    check_shapes(a, b, act)
    if a.device.type == "cpu":
        return silu_mul_quant_plain(a, b, act)
    if a.device.type != "cuda":
        raise ValueError(f"silu_mul_quant runs on cuda or cpu tensors, not {a.device}")
    return _launch(a, b, act)


silu_mul_quant.launches = 0  # kernel launches (not plain-version calls)


def traffic(shape):
    """(bytes, operations) the function needs on bf16 inputs: a and b read
    once, q (int8) and one f32 scale per row written once; about 8 f32
    operations per value (gate, product, |y|, max, division, round, clip)."""
    bb, t, d = shape
    rows = bb * t
    return rows * d * 5 + rows * 4, 8 * rows * d
