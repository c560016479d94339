"""K17: the blockwise-scaled fp8 matmul of ``ao_tpu/ops/pallas/fp8_matmul.py``,
on Hopper.

``fp8_blockwise_matmul`` computes the DeepSeek-style product
y (M, N) bf16 = sum over 128-wide k-blocks kb of
(qx[:, kb] @ qw[kb, :]) * sx[:, kb] * sw[kb, n / 128], with qx e4m3 (M, K)
and per-(row, k-block) scales sx (M, K/128), qw e4m3 (K, N) and
per-(k-block, n-block) scales sw (K/128, N/128)
(``fp8_blockwise_matmul_pallas``, kernel ``_kernel``); CUDA source
``ao_tpu_torch/csrc/fp8_matmul.cu`` (its prefill form a TMA-fed fp8 wgmma
ring, ``csrc/tma_ring.cuh``), whose header says what bounds it on the H100
and how the design meets it; ``pick_tiles`` chooses its tiles and K split.
The weight is the column-major (K, N) tensor that ``Float8Array`` stores.
The wrapper runs the kernel on a CUDA tensor and its plain PyTorch version
(``fp8_blockwise_matmul_plain``) on a CPU tensor, and raises ValueError on
either for what the kernel does not take. ``fp8_block_fold_mirror``
repeats the prefill kernel's stage order and promotion in PyTorch, so a
CPU test can hold it to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ao_tpu_torch.ops.hopper import build
from ao_tpu_torch.ops.hopper.int4_matmul import _check_operands, _sm_count, _split_units

BLK = 128  # k-block, and the weight's n-block
GEMV_MAX_M = 16  # the decode kernel's rows; above them the prefill kernel's tiles
PREFILL_BM = 128  # qx rows of a prefill CTA (two consumer warpgroups)
PREFILL_BN = (128, 64)  # its weight columns, widest first

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("fp8_matmul")
        lib.ao_fp8_blockwise.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.ao_fp8_blockwise.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def takes(qx: torch.Tensor, sx: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor) -> bool:
    """Whether the kernel takes these operands: 2-D e4m3 qx (M, K) and qw
    (K, N) with K and N multiples of 128, sx (M, K/128) and sw
    (K/128, N/128); any M (the reference's limits, fp8_matmul.py:112-121,
    and e4m3, the type of the kernel's tensor-core instruction)."""
    if qx.ndim != 2 or qw.ndim != 2:
        return False
    (m, k), (kw, n) = qx.shape, qw.shape
    return (k == kw and k % BLK == 0 and n % BLK == 0
            and qx.dtype == qw.dtype == torch.float8_e4m3fn
            and tuple(sx.shape) == (m, k // BLK) and tuple(sw.shape) == (k // BLK, n // BLK))


def fp8_blockwise_matmul_plain(qx, sx, qw, sw) -> torch.Tensor:
    """The kernel's function in plain PyTorch, f32 (M, N), with no fp8
    arithmetic: the fp8 values are taken exactly in f32; per k-block, the
    f32 product of the block (exact products) times sx[:, kb] times the
    block's row of sw repeated over its 128 columns, summed over blocks."""
    m, k = qx.shape
    n = qw.shape[1]
    xf, wf = qx.to(torch.float32), qw.to(torch.float32)
    swe = sw.to(torch.float32).repeat_interleave(BLK, dim=1)  # (K/128, N)
    acc = torch.zeros((m, n), dtype=torch.float32, device=qx.device)
    for kb in range(k // BLK):
        part = xf[:, kb * BLK:(kb + 1) * BLK] @ wf[kb * BLK:(kb + 1) * BLK]
        acc = acc + part * sx[:, kb:kb + 1].to(torch.float32) * swe[kb]
    return acc


def fp8_block_fold_mirror(qx, sx, qw, sw) -> torch.Tensor:
    """The prefill kernel's arithmetic in PyTorch, f32 (M, N): per k-block,
    its four k32 steps summed into a fresh f32 set tmp (exact products),
    then acc = fma(tmp, sx[:, kb] * sw[kb, n / 128], acc): the scales'
    product rounded to f32 once, the fused multiply-add emulated in f64,
    where the f32 product is exact (the sum's rounding to f32 matches the
    FMA's but at a double-rounding tie)."""
    m, k = qx.shape
    n = qw.shape[1]
    xf, wf = qx.to(torch.float32), qw.to(torch.float32)
    swe = sw.to(torch.float32).repeat_interleave(BLK, dim=1)  # (K/128, N)
    acc = torch.zeros((m, n), dtype=torch.float32, device=qx.device)
    for kb in range(k // BLK):
        tmp = torch.zeros((m, n), dtype=torch.float32, device=qx.device)
        for kk in range(kb * BLK, (kb + 1) * BLK, 32):
            tmp = tmp + xf[:, kk:kk + 32] @ wf[kk:kk + 32]
        f = sx[:, kb:kb + 1].to(torch.float32) * swe[kb]
        acc = (tmp.double() * f.double() + acc.double()).to(torch.float32)
    return acc


def pick_splits(m: int, k: int, n: int, sm_count: int):
    """(splits, k-blocks per split) of a decode launch (M <= 16): K split by
    whole k-blocks until about four 4-warp blocks per SM are in flight."""
    return _split_units(k // BLK, n // 128, sm_count)


def candidate_tiles(m: int, k: int, n: int):
    """Every (bm, bn, splits) the prefill kernel takes at this shape: 128
    rows by PREFILL_BN columns, and each split count a launch runs as asked
    (ceil(k-blocks / splits) a split, every split at least one)."""
    kbs = k // BLK
    splits = [sp for sp in range(1, kbs + 1) if -(-kbs // -(-kbs // sp)) == sp]
    return tuple((PREFILL_BM, bn, sp) for bn in PREFILL_BN for sp in splits)


def pick_tiles(m: int, k: int, n: int, sm_count: int):
    """(bm, bn, splits, per) of a launch. M <= 16: the decode kernel (bm 16,
    bn 128), ``per`` k-blocks a split (``pick_splits``). Larger M: the
    prefill kernel, one CTA an SM, 128 rows by BN = 128 columns, or 64 where
    128 leaves more than a quarter of the SMs idle (M = 1024, N = 1024: 64
    CTAs at 128, 128 at 64); where 64 does too, K is split in whole k-blocks
    until the CTAs fill three quarters of the SMs, as far as K allows (a
    split costs a second pass over f32 partials)."""
    if m <= GEMV_MAX_M:
        return (GEMV_MAX_M, 128) + pick_splits(m, k, n, sm_count)
    kbs = k // BLK
    want = -(-3 * sm_count // 4)
    rows = -(-m // PREFILL_BM)
    for bn in PREFILL_BN:
        if rows * (n // bn) >= want:
            return PREFILL_BM, bn, 1, kbs
    ctas = rows * (n // bn)
    need = -(-want // ctas)  # splits that fill the card
    per = -(-kbs // need)  # balanced splits, unless rounding leaves too few
    if -(-kbs // per) < need:
        per = max(1, kbs // need)
    return PREFILL_BM, bn, -(-kbs // per), per


def launch_tiles(m: int, k: int, n: int, sm_count: int, tiles=None):
    """What a launch at (M, K, N) runs: (bm, bn, splits, per), ``pick_tiles``'s
    or, above M = 16, ``tiles`` (bm, bn, splits), which must be one of
    ``candidate_tiles``."""
    if tiles is None or m <= GEMV_MAX_M:
        return pick_tiles(m, k, n, sm_count)
    if tuple(tiles) not in candidate_tiles(m, k, n):
        raise ValueError(
            f"fp8_blockwise_matmul: tiles {tiles} are not the prefill kernel's at {(m, k, n)}")
    bm, bn, splits = tiles
    return bm, bn, splits, -(-(k // BLK) // splits)


def _launch(qx, sx, qw, sw, tiles=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; ``tiles`` (bm, bn, splits)
    overrides ``pick_tiles`` above M = 16 (``launch_tiles``)."""
    dev = qx.device
    m, k = qx.shape
    n = qw.shape[1]
    wt = qw.t()  # the column-major (K, N) weight as (N, K) rows
    _check_operands("fp8_blockwise_matmul", dev, (
        ("qx", qx, torch.float8_e4m3fn, (m, k)),
        ("sx", sx, torch.float32, (m, k // BLK)),
        ("weight (stored column-major)", wt, torch.float8_e4m3fn, (n, k)),
        ("sw", sw, torch.float32, (k // BLK, n // BLK))))
    bm, bn, splits, per = launch_tiles(m, k, n, _sm_count(dev), tiles)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_fp8_blockwise(qx.data_ptr(), sx.data_ptr(), wt.data_ptr(), sw.data_ptr(),
                                      out.data_ptr(), None if ws is None else ws.data_ptr(), m, k,
                                      n, bm, bn, splits, per, stream)
    if err < 0:
        raise RuntimeError(f"fp8_blockwise_matmul: cuTensorMapEncodeTiled failed (CUresult "
                           f"{-err}); no kernel was launched")
    if err != 0:
        raise RuntimeError(f"fp8_blockwise_matmul kernel launch failed: CUDA error {err}")
    fp8_blockwise_matmul.launches += 1
    return out


def fp8_blockwise_matmul(qx, sx, qw, sw) -> torch.Tensor:
    """qx e4m3 (M, K) with sx (M, K/128) f32; qw e4m3 (K, N), column-major on
    the card, with sw (K/128, N/128) f32. Returns (M, N) bf16: the kernel on
    a CUDA tensor, its plain version on a CPU tensor."""
    if not takes(qx, sx, qw, sw):
        raise ValueError(
            f"fp8_blockwise_matmul takes e4m3 qx (M, K) and qw (K, N) with K, N multiples of "
            f"{BLK}, sx (M, K/{BLK}) and sw (K/{BLK}, N/{BLK}); got qx {qx.dtype} "
            f"{tuple(qx.shape)}, qw {qw.dtype} {tuple(qw.shape)}, sx {tuple(sx.shape)}, "
            f"sw {tuple(sw.shape)}")
    if qx.device.type == "cpu":
        return fp8_blockwise_matmul_plain(qx, sx, qw, sw).to(torch.bfloat16)
    if qx.device.type != "cuda":
        raise ValueError(f"fp8_blockwise_matmul runs on cuda or cpu tensors, not {qx.device}")
    return _launch(qx.contiguous(), sx.to(torch.float32).contiguous(), qw,
                   sw.to(torch.float32).contiguous())


fp8_blockwise_matmul.launches = 0  # kernel launches (not plain-version calls)


def traffic(m: int, k: int, n: int):
    """(bytes, fp8 operations) the function needs: qx and the weight 1 B per
    value, sx and sw f32 read once, the bf16 output written once."""
    nbytes = m * k + k * n + (m * (k // BLK) + (k // BLK) * (n // BLK)) * 4 + m * n * 2
    return nbytes, 2 * m * k * n
