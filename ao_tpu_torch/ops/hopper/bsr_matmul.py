"""K18: the block-sparse (BSR) matmul of ``ao_tpu/ops/pallas/bsr_matmul.py``,
on Hopper.

``bsr_matmul(x, w)`` computes y (M, N) bf16 = x (M, K) @ w, w a
``BlockSparseArray`` (K, N) of b x b blocks sorted by (column, row)
(``bsr_matmul_pallas``, kernel ``_kernel``); CUDA source
``ao_tpu_torch/csrc/bsr_matmul.cu``, whose header says what bounds it on the
H100 and how the design meets it. x and the values are cast to bf16, as the
reference's wrapper casts them; the products are summed in f32 and rounded
once. The wrapper runs the kernel on a CUDA tensor and its plain PyTorch
version (``bsr_matmul_plain``, the container's ragged ``matmul``) on a CPU
tensor, and raises ValueError on either for a shape the kernel does not take.
"""

from __future__ import annotations

import ctypes

import torch

from ao_tpu_torch.ops.hopper import build
from ao_tpu_torch.ops.hopper.int4_matmul import _check_operands

BLOCKSIZES = (32, 64, 128)  # the kernel's compiled block sizes
MAX_COL_BLOCKS = 65535  # N / b: the grid's second dimension

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("bsr_matmul")
        lib.ao_bsr_matmul.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.ao_bsr_matmul.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def takes(blocksize: int, k: int, n: int) -> bool:
    """Whether the kernel takes a (K, N) weight of ``blocksize`` blocks: b
    in 32, 64, 128 (the TPU kernel takes multiples of 128 only), K and N
    multiples of b, at most 65535 column blocks."""
    return (blocksize in BLOCKSIZES and k % blocksize == 0 and n % blocksize == 0
            and n // blocksize <= MAX_COL_BLOCKS)


def check_shapes(x: torch.Tensor, w) -> None:
    """Raise ValueError for shapes the kernel does not take; the wrapper
    applies it on every device, so the CPU refuses what the card would."""
    k, n = w.shape
    if x.ndim != 2 or x.shape[1] != k or x.shape[0] < 1:
        raise ValueError(f"bsr_matmul takes 2-D x (M >= 1, {k}), got {tuple(x.shape)}")
    if not takes(w.blocksize, k, n):
        raise ValueError(f"bsr_matmul takes blocksize in {BLOCKSIZES} dividing K={k} and "
                         f"N={n}, got {w.blocksize}")


def bsr_matmul_plain(x: torch.Tensor, w) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x and the values rounded to
    bf16, each live block's product in f32, summed per output column block,
    rounded to bf16 once (``BlockSparseArray.matmul`` on a bf16 x)."""
    return w.matmul(x.to(torch.bfloat16))


def _launch(x: torch.Tensor, w) -> torch.Tensor:
    dev = x.device
    m, k = x.shape
    n = w.shape[1]
    b = w.blocksize
    vals = w.values.to(torch.bfloat16).contiguous()  # a copy only for an f32 container
    nnz = vals.shape[0]
    _check_operands("bsr_matmul", dev, (
        ("x", x, torch.bfloat16, (m, k)),
        ("values", vals, torch.bfloat16, (nnz, b, b)),
        ("row_indices", w.row_indices, torch.int32, (nnz,)),
        ("col_indices", w.col_indices, torch.int32, (nnz,))))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_bsr_matmul(x.data_ptr(), vals.data_ptr(), w.row_indices.data_ptr(),
                                   w.col_indices.data_ptr(), out.data_ptr(), m, k, n, nnz, b,
                                   stream)
    if err != 0:
        raise RuntimeError(f"bsr_matmul kernel launch failed: CUDA error {err}")
    bsr_matmul.launches += 1
    return out


def bsr_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x (M, K); w a BlockSparseArray (K, N) sorted by (column, row), as
    ``from_hp`` builds it. Returns (M, N) bf16: the kernel on a CUDA tensor,
    its plain version on a CPU tensor."""
    check_shapes(x, w)
    x = x.to(torch.bfloat16)
    if x.device.type == "cpu":
        return bsr_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_matmul runs on cuda or cpu tensors, not {x.device}")
    return _launch(x.contiguous(), w)


bsr_matmul.launches = 0  # kernel launches (not plain-version calls)


def traffic(m: int, k: int, n: int, b: int, nnz: int):
    """(bytes, flops) the function needs (the reference's cost model,
    ``bsr_matmul.py:72-76``): x and the live blocks read once in bf16, the
    bf16 output written once; two operations per multiply-add of each live
    block."""
    return nnz * b * b * 2 + m * k * 2 + m * n * 2, 2 * m * b * b * nnz
