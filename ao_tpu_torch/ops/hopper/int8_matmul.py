"""K10: the int8 weight-only matmul of ``ao_tpu/ops/pallas/int8_matmul.py``,
on Hopper.

``int8_wo_matmul`` computes y (M, N) bf16 = (x (M, K) @ q (K, N) int8) * s
(1, N) f32, the per-output-column symmetric weight of
``Int8WeightOnlyConfig`` (``int8_wo_matmul_pallas``, kernel ``_kernel``);
CUDA source ``ao_tpu_torch/csrc/int8_matmul.cu``, whose header says what
bounds it on the H100 and how the design meets it. The weight is the
column-major (K, N) tensor that ``Int8Array`` stores (``col_major``), which
the kernel reads as (N, K) rows. The wrapper runs the kernel on a CUDA
tensor and its plain PyTorch version (``int8_wo_matmul_plain``) on a CPU
tensor, and raises ValueError on either for a shape the kernel does not
take.
"""

from __future__ import annotations

import ctypes

import torch

from ao_tpu_torch.ops.hopper import build
from ao_tpu_torch.ops.hopper.int4_matmul import _check_operands, _sm_count, _split_units

UNIT = 128  # K and N multiple; K units of a decode split

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("int8_matmul")
        lib.ao_int8_wo.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ao_int8_wo.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def takes(k: int, n: int) -> bool:
    """Whether the kernel takes a (K, N) weight: both multiples of 128."""
    return k % UNIT == 0 and n % UNIT == 0


def check_shapes(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise ValueError for shapes the kernel does not take; the wrapper
    applies it on every device, so the CPU refuses what the card would."""
    if x.ndim != 2 or qw.ndim != 2:
        raise ValueError("int8_wo_matmul takes 2-D x (M, K) and an int8 weight (K, N)")
    (m, k), (kw, n) = x.shape, qw.shape
    if k != kw:
        raise ValueError(f"K mismatch: x {tuple(x.shape)}, weight {tuple(qw.shape)}")
    if not takes(k, n):
        raise ValueError(f"K={k} and N={n} must be multiples of {UNIT}")
    if qw.dtype != torch.int8 or tuple(scale.shape) != (1, n):
        raise ValueError(f"int8_wo_matmul takes an int8 weight with a (1, {n}) per-column "
                         f"scale, got {qw.dtype} and {tuple(scale.shape)}")


def int8_wo_matmul_plain(x, qw, scale) -> torch.Tensor:
    """The kernel's function in plain PyTorch, f32 (M, N): x rounded to bf16
    as the kernel takes it, (x @ q) in f32 (every product exact), times the
    per-column scale."""
    xf = x.to(torch.bfloat16).to(torch.float32)
    return (xf @ qw.to(torch.float32)) * scale.reshape(1, -1).to(torch.float32)


def pick_splits(m: int, k: int, n: int, sm_count: int):
    """(splits, K units per split) of a launch: decode (M <= 16) splits K in
    128-wide units until about four 4-warp blocks per SM are in flight."""
    if m > 16:
        return 1, k // UNIT
    return _split_units(k // UNIT, n // 128, sm_count)


def _launch(x, qw, scale) -> torch.Tensor:
    dev = x.device
    m, k = x.shape
    n = qw.shape[1]
    wt = qw.t()  # the column-major (K, N) weight as (N, K) rows
    s = scale.reshape(n)
    _check_operands("int8_wo_matmul", dev, (
        ("x", x, torch.bfloat16, (m, k)),
        ("weight (stored column-major)", wt, torch.int8, (n, k)),
        ("scale", s, torch.float32, (n,))))
    splits, ups = pick_splits(m, k, n, _sm_count(dev))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_int8_wo(x.data_ptr(), wt.data_ptr(), s.data_ptr(), out.data_ptr(),
                                None if ws is None else ws.data_ptr(), m, k, n, splits, ups,
                                stream)
    if err != 0:
        raise RuntimeError(f"int8_wo_matmul kernel launch failed: CUDA error {err}")
    int8_wo_matmul.launches += 1
    return out


def int8_wo_matmul(x, qw, scale) -> torch.Tensor:
    """x (M, K); qw int8 (K, N), column-major on the card; scale (1, N) f32.
    Returns (M, N) bf16: the kernel on a CUDA tensor, its plain version on a
    CPU tensor."""
    check_shapes(x, qw, scale)
    x = x.to(torch.bfloat16)
    if x.device.type == "cpu":
        return int8_wo_matmul_plain(x, qw, scale).to(torch.bfloat16)
    if x.device.type != "cuda":
        raise ValueError(f"int8_wo_matmul runs on cuda or cpu tensors, not {x.device}")
    return _launch(x.contiguous(), qw, scale.to(torch.float32))


int8_wo_matmul.launches = 0  # kernel launches (not plain-version calls)


def traffic(m: int, k: int, n: int):
    """(bytes, flops) the function needs: x bf16 and the int8 weight read
    once, the f32 scale read once, the bf16 output written once."""
    return m * k * 2 + k * n + n * 4 + m * n * 2, 2 * m * k * n
