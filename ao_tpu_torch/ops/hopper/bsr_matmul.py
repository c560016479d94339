"""K18: the block-sparse (BSR) matmul of ``ao_tpu/ops/pallas/bsr_matmul.py``,
on Hopper.

``bsr_matmul(x, w)`` computes y (M, N) bf16 = x (M, K) @ w, w a
``BlockSparseArray`` (K, N) of b x b blocks sorted by (column, row)
(``bsr_matmul_pallas``, kernel ``_kernel``); CUDA source
``ao_tpu_torch/csrc/bsr_matmul.cu``, whose header says what bounds it on the
H100 and how the design meets it: a TMA-fed ring of stages into wgmma, one
persistent CTA an SM walking (128-row tile, column) items, columns outer,
or, where those items are too few to fill the card, the CTAs of a cluster
splitting a column's run (``launch_plan``; ``schedule`` mirrors the walk).
x and the values are cast to bf16, as the reference's wrapper casts them;
the products are summed in f32 and rounded once. The wrapper runs the
kernel on a CUDA tensor and its plain PyTorch version
(``bsr_matmul_plain``, the container's ragged ``matmul``) on a CPU tensor,
and raises ValueError on either for a shape the kernel does not take.

What the kernel needs of a weight beyond the container, built on its device
once and kept beside it (never as a field of the container): the values in
bf16 (a copy only for an f32 container), each column's run of blocks as an
(N/b + 1) prefix of ``col_indices`` and the values' tensor map.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch

from ao_tpu_torch.ops.hopper import build
from ao_tpu_torch.ops.hopper.int4_matmul import _sm_count

BLOCKSIZES = (32, 64, 128)  # the kernel's compiled block sizes
MAX_COL_BLOCKS = 65535  # N / b the kernel takes
TILE_ROWS = 128  # rows of x an item: two consumer warpgroups of 64
# CTAs of a cluster that may split a column's run, by b: the peers' f32
# partials must fit the ring (b = 64 runs two CTAs an SM, with three stages)
MAX_SPLIT = {32: 4, 64: 2, 128: 4}
SMS = 132  # the H100's SMs

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("bsr_matmul")
        lib.ao_bsr_matmul.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.ao_bsr_matmul.restype = ctypes.c_int
        lib.ao_bsr_values_map.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int]
        lib.ao_bsr_values_map.restype = ctypes.c_int
        lib.ao_bsr_matmul_max_split.argtypes = [ctypes.c_int]
        for fn in (lib.ao_bsr_matmul_max_split, lib.ao_bsr_matmul_tile_rows,
                   lib.ao_bsr_matmul_map_bytes):
            fn.restype = ctypes.c_int
        got = {b: lib.ao_bsr_matmul_max_split(b) for b in BLOCKSIZES}
        if got != MAX_SPLIT or lib.ao_bsr_matmul_tile_rows() != TILE_ROWS:
            raise RuntimeError(f"bsr_matmul.cu: splits {got} and tile rows "
                               f"{lib.ao_bsr_matmul_tile_rows()}, not {MAX_SPLIT}, {TILE_ROWS}")
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


class BsrPlan(NamedTuple):
    splits: int   # CTAs of a cluster splitting one item's run (1: no cluster)
    ctas: int     # CTAs of the launch: at splits > 1, items * splits
    m_tiles: int  # 128-row tiles of x
    items: int    # (row tile, column) items, column c's tiles c m_tiles .. + m_tiles - 1


@functools.lru_cache(maxsize=256)
def launch_plan(m: int, n: int, b: int, nnz: int, sms: int = SMS, splits=None) -> BsrPlan:
    """K18's launch at x (M, K) over a (K, N) weight of ``nnz`` b x b
    blocks, from shapes only: up to two CTAs an SM (at most one an item)
    walking the items (at b <= 64 two fit an SM, at b = 128 the second
    wave starts as the first ends); where the items are fewer than half the
    SMs, clusters of 2 or 4 CTAs split each item's run, as long as the mean
    run (``nnz / (N / b)`` blocks) gives each rank two blocks or more: at
    runs of 2 a split cost more than it saved (PERF.md). ``splits`` given
    is taken as it is (``kernel_tiles.py time K18`` sweeps it)."""
    m_tiles = -(-m // TILE_ROWS)
    items = m_tiles * (n // b)
    if splits is None:
        splits = 1
        while (splits < MAX_SPLIT[b] and items * splits * 2 <= sms
               and 4 * splits * (n // b) <= nnz):
            splits *= 2
    if splits not in (1, 2, 4) or splits > MAX_SPLIT[b]:
        raise ValueError(f"bsr_matmul: splits must be 1, 2 or 4 (at most {MAX_SPLIT[b]} at "
                         f"b = {b}), got {splits}")
    ctas = items * splits if splits > 1 else min(items, 2 * sms)
    return BsrPlan(splits, ctas, m_tiles, items)


def column_runs(col_indices: torch.Tensor, n_cols: int) -> torch.Tensor:
    """The (n_cols + 1) int32 prefix of the sorted ``col_indices``: column
    c's blocks are [runs[c], runs[c + 1]), on col_indices' device."""
    want = torch.arange(n_cols + 1, dtype=col_indices.dtype, device=col_indices.device)
    return torch.searchsorted(col_indices.contiguous(), want, out_int32=True)


def schedule(plan: BsrPlan, runs):
    """The kernel's walk in Python: (cta, rank, item, column, first row,
    first block, end block) for each item each CTA takes, in its order. CTA
    j is rank j % splits of cluster j // splits, which walks items j //
    splits, + ctas / splits, ...; rank r takes blocks [lo + r per, lo + (r +
    1) per) of the item's column's run [lo, hi), per = ceil((hi - lo) /
    splits), clipped to hi."""
    out = []
    clusters = plan.ctas // plan.splits
    for cta in range(plan.ctas):
        rank, cid = cta % plan.splits, cta // plan.splits
        for t in range(cid, plan.items, clusters):
            c, mi = divmod(t, plan.m_tiles)
            lo, hi = int(runs[c]), int(runs[c + 1])
            per = -(-(hi - lo) // plan.splits)
            a = min(lo + rank * per, hi)
            out.append((cta, rank, t, c, mi * TILE_ROWS, a, min(a + per, hi)))
    return out


def bsr_matmul_plain(x: torch.Tensor, w) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x and the values rounded to
    bf16, each live block's product in f32, summed per output column block,
    rounded to bf16 once (``BlockSparseArray.matmul`` on a bf16 x)."""
    return w.matmul(x.to(torch.bfloat16))


class _Weight(NamedTuple):
    values: object        # a weak reference to the container's values
    rows: torch.Tensor
    cols: torch.Tensor
    copy: object          # the values' bf16 copy (an f32 container), else None
    runs: torch.Tensor    # column_runs of cols
    vmap: object          # the values' tensor map (ctypes buffer)
    vmap_ptr: int
    nnz: int


_WEIGHTS = {}  # id(values) -> _Weight, dropped with the values


def _weight(w, dev) -> _Weight:
    """What the kernel keeps of ``w`` (module doc), built once per weight."""
    key = id(w.values)
    st = _WEIGHTS.get(key)
    if (st is not None and st.values() is w.values and st.rows is w.row_indices
            and st.cols is w.col_indices):
        return st
    b = w.blocksize
    k, n = w.shape
    copy = None if w.values.dtype == torch.bfloat16 else w.values.to(torch.bfloat16)
    vals = (w.values if copy is None else copy).contiguous()
    if copy is None and vals is not w.values:
        copy = vals
    nnz = vals.shape[0]
    for name, t, dt, shape in (("values", vals, torch.bfloat16, (nnz, b, b)),
                               ("row_indices", w.row_indices, torch.int32, (nnz,)),
                               ("col_indices", w.col_indices, torch.int32, (nnz,))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"bsr_matmul: {name} must be a contiguous {dt} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"bsr_matmul: {name} must be 16-byte aligned")
    lib = _lib()
    vmap = ctypes.create_string_buffer(lib.ao_bsr_matmul_map_bytes())
    with torch.cuda.device(dev):
        runs = column_runs(w.col_indices, n // b)
        err = lib.ao_bsr_values_map(ctypes.addressof(vmap), vals.data_ptr(), nnz, b)
    if err != 0:
        raise RuntimeError(f"bsr_matmul: the values' tensor map failed: "
                           f"{'CUresult ' + str(-err) if err < 0 else 'CUDA error ' + str(err)}")
    st = _Weight(weakref.ref(w.values), w.row_indices, w.col_indices, copy, runs, vmap,
                 ctypes.addressof(vmap), nnz)
    _WEIGHTS[key] = st
    weakref.finalize(w.values, _WEIGHTS.pop, key, None)
    return st


def _launch(x: torch.Tensor, w, plan: BsrPlan = None) -> torch.Tensor:
    """One launch of K18 at ``plan`` (by default ``launch_plan``'s)."""
    dev = x.device
    m, k = x.shape
    n = w.shape[1]
    b = w.blocksize
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"bsr_matmul: x must be a contiguous, 16-byte aligned bf16 tensor, "
                         f"got {x.dtype}")
    st = _weight(w, dev)
    plan = plan or launch_plan(m, n, b, st.nnz, _sm_count(dev))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    args = (x.data_ptr(), st.vmap_ptr, st.rows.data_ptr(), st.runs.data_ptr(), out.data_ptr(),
            m, k, n, b, plan.splits, plan.ctas, torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():  # the launch goes to the current device
        err = _lib().ao_bsr_matmul(*args)
    else:
        with torch.cuda.device(dev):
            err = _lib().ao_bsr_matmul(*args)
    if err != 0:
        raise RuntimeError(f"bsr_matmul kernel launch failed: "
                           f"{'CUresult ' + str(-err) if err < 0 else 'CUDA error ' + str(err)}")
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
