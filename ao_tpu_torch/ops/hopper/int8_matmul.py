"""K10: the int8 weight-only matmul of ``ao_tpu/ops/pallas/int8_matmul.py``,
on Hopper.

``int8_wo_matmul`` computes y (M, N) bf16 = (x (M, K) @ q (K, N) int8) * s
(1, N) f32, the per-output-column symmetric weight of
``Int8WeightOnlyConfig`` (``int8_wo_matmul_pallas``, kernel ``_kernel``);
CUDA source ``ao_tpu_torch/csrc/int8_matmul.cu`` (its prefill form on the
shared wgmma mainloop of ``csrc/mixed_gemm.cuh``), whose header says what
bounds it on the H100 and how the design meets it; ``pick_tiles`` chooses
its tiles and K split. The weight is the column-major (K, N) tensor that
``Int8Array`` stores (``col_major``), which the kernel reads as (N, K)
rows. The wrapper runs the kernel on a CUDA tensor and its plain PyTorch
version (``int8_wo_matmul_plain``) on a CPU tensor, and raises ValueError
on either for a shape the kernel does not take. ``int8_decode_mirror``
repeats the kernel's integer decode of a weight byte in PyTorch, so a CPU
test can hold it to the plain cast.
"""

from __future__ import annotations

import ctypes

import torch

from ao_tpu_torch.ops.hopper import build
from ao_tpu_torch.ops.hopper import fp4_matmul
from ao_tpu_torch.ops.hopper.int4_matmul import _check_operands, _sm_count, _split_units

UNIT = 128  # K and N multiple; K units of a decode split
GEMV_MAX_M = 16  # the decode kernel's rows; above them the mainloop's tiles
K_STAGE = 64  # K values per stage of the mainloop
# the mainloop's tiles (BM, BN) without a fold (csrc/mixed_gemm.cuh: launch)
MAINLOOP_TILES = ((256, 128), (128, 128), (64, 128), (128, 64), (64, 64))

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("int8_matmul")
        lib.ao_int8_wo.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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


def int8_decode_mirror(q: torch.Tensor) -> torch.Tensor:
    """The kernel's decode of int8 weights (``i8x2_bf16x2``, csrc/
    int8_matmul.cu) in PyTorch integer ops, one value of a bf16x2 at a
    time: the byte ^ 0x80 in the low byte of the f32 2^23 (one byte_perm),
    minus 2^23 + 128 (exact), then the f32 -> bf16 rounding of
    cvt.rn.bf16x2.f32."""
    u = (q.to(torch.int32) & 0xFF) ^ 0x80
    f = (u | 0x4B000000).view(torch.float32) - 8388736.0
    return f.to(torch.bfloat16)


def pick_splits(m: int, k: int, n: int, sm_count: int):
    """(splits, K units per split) of a decode launch (M <= 16): K split in
    128-wide units until about four 4-warp blocks per SM are in flight."""
    return _split_units(k // UNIT, n // 128, sm_count)


def mainloop_per(k: int, splits: int) -> int:
    """Stages of 64 K values a split of a prefill launch runs when asked for
    ``splits`` (balanced: ceil(stages / splits))."""
    return -(-(k // K_STAGE) // splits)


def candidate_tiles(m: int, k: int, n: int):
    """Every (bm, bn, splits) the mainloop takes for K10 at this shape: a
    tile of MAINLOOP_TILES whose BN divides N, and each split count a launch
    runs as asked (every split at least one stage)."""
    stages = k // K_STAGE
    splits = [sp for sp in range(1, stages + 1) if -(-stages // mainloop_per(k, sp)) == sp]
    return tuple((bm, bn, sp) for bm, bn in MAINLOOP_TILES if n % bn == 0 for sp in splits)


def pick_tiles(m: int, k: int, n: int, sm_count: int):
    """(bm, bn, splits, per) of a launch. M <= 16: the decode kernel (bm 16,
    bn 128), ``per`` 128-wide units a split (``pick_splits``). Larger M:
    K14's mainloop tiles (``fp4_matmul.pick_tiles``: BM 64 / 128 / 256 by M,
    BN 128, K split in stages of 64 until the CTAs fill three quarters of
    the card's CTA slots), ``per`` stages a split: the stage and the tiles
    are the same mainloop's."""
    if m <= GEMV_MAX_M:
        return (GEMV_MAX_M, UNIT) + pick_splits(m, k, n, sm_count)
    return fp4_matmul.pick_tiles(m, k, n, sm_count)


def launch_tiles(m: int, k: int, n: int, sm_count: int, tiles=None):
    """What a launch at (M, K, N) runs: (bm, bn, splits, per), ``pick_tiles``'s
    or, above M = 16, ``tiles`` (bm, bn, splits), which must be one of
    ``candidate_tiles``."""
    if tiles is None or m <= GEMV_MAX_M:
        return pick_tiles(m, k, n, sm_count)
    if tuple(tiles) not in candidate_tiles(m, k, n):
        raise ValueError(f"int8_wo_matmul: tiles {tiles} are not the mainloop's at {(m, k, n)}")
    bm, bn, splits = tiles
    return bm, bn, splits, mainloop_per(k, splits)


def _launch(x, qw, scale, tiles=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; ``tiles`` (bm, bn, splits)
    overrides ``pick_tiles`` above M = 16 (``launch_tiles``)."""
    dev = x.device
    m, k = x.shape
    n = qw.shape[1]
    wt = qw.t()  # the column-major (K, N) weight as (N, K) rows
    s = scale.reshape(n)
    _check_operands("int8_wo_matmul", dev, (
        ("x", x, torch.bfloat16, (m, k)),
        ("weight (stored column-major)", wt, torch.int8, (n, k)),
        ("scale", s, torch.float32, (n,))))
    bm, bn, splits, per = launch_tiles(m, k, n, _sm_count(dev), tiles)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_int8_wo(x.data_ptr(), wt.data_ptr(), s.data_ptr(), out.data_ptr(),
                                None if ws is None else ws.data_ptr(), m, k, n, bm, bn, splits,
                                per, stream)
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
