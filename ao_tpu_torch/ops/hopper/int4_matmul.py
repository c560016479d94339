"""The int4 matmul kernels of ``ao_tpu/ops/pallas/int4_matmul.py``, on Hopper.

* K1 ``int4_wo_magic``: int4 weight-only matmul over the "magic" layout
  (``int4_wo_magic_pallas``, kernel ``_magic_kernel``); CUDA source
  ``ao_tpu_torch/csrc/int4_matmul.cu``, its prefill form (M > 16) on the
  shared wgmma mainloop with a per-group f32 fold (``csrc/mixed_gemm.cuh``,
  ``csrc/magic_op.cuh``; shared with K15). ``launch_tiles`` says what a
  launch runs: the decode kernel's K split (``pick_splits``) or the
  mainloop's tiles (``pick_tiles``, the tuned tile cache first). The
  ``magic_*`` functions mirror the mainloop's step order and fold in
  PyTorch, for the CPU tests.
* K3 ``int4_w4a8_matmul``: int8 activations times magic8 int4 weights on
  the s8 tensor cores, f32 out (``int4_w4a8_matmul_pallas``, kernel
  ``_w4a8_kernel``); CUDA source ``ao_tpu_torch/csrc/int4_w4a8.cu``.
* K4 ``int4_magic8_requant_int8``: magic8 words to per-channel int8 for the
  prefill int8 GEMM (``int4_magic8_requant_int8_pallas``, kernel
  ``_requant_kernel``); same CUDA source as K3.
* K11 ``int4_wo_matmul``: int4 weight-only matmul over the uint8 split-half
  layout (``int4_wo_matmul_pallas``, kernels ``_kernel`` and
  ``_kernel_twoplane``); same CUDA source as K1, on the shared wgmma
  mainloop of ``csrc/mixed_gemm.cuh``. ``takes_halves`` says which shapes it
  takes; ``pick_tiles_halves`` chooses its tiles, the tuned tile cache
  (``ops/hopper/autotune.py``) first.

The headers of the CUDA sources say what bounds each kernel on the H100 and
how the design meets it. Each wrapper runs its kernel on a CUDA tensor and
its plain PyTorch version (``*_plain``) on a CPU tensor, and raises
ValueError on either for a shape the kernel does not take.

K1 takes the qparams in the reference wrapper's transport form (s and
b2 = b + 8s in bf16, x in bf16). For bf16 tinygemm qparams (what
``Int4WeightOnlyConfig`` makes) the kernel takes the scale and zero point as
they are and forms b2 itself, with the same roundings, so a call on the
main path runs no elementwise pass on the host's behalf. K3 takes s and b
of w = u*s + b in bf16; for bf16 tinygemm qparams (what
``Int8DynamicActivationInt4WeightConfig`` makes) those are the scale and
zero point themselves.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ao_tpu_torch.ops.hopper import build
from ao_tpu_torch.quantization import primitives as P
from ao_tpu_torch.quantization.qarrays.int4 import (
    unpack_int4, unpack_int4_magic, unpack_int4_magic8,
)

_LIB = None
_LIB_W4A8 = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("int4_matmul")
        fn = lib.ao_int4_wo_magic
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ao_int4_wo_halves.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        lib.ao_int4_wo_halves.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _lib_w4a8():
    global _LIB_W4A8
    if _LIB_W4A8 is None:
        lib = build.load("int4_w4a8")
        lib.ao_int4_w4a8.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.ao_int4_w4a8.restype = ctypes.c_int
        lib.ao_int4_magic8_requant.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.ao_int4_magic8_requant.restype = ctypes.c_int
        _LIB_W4A8 = lib
    return _LIB_W4A8


def _check_operands(kernel: str, dev, operands) -> None:
    """Each (name, tensor, dtype, shape) must be a contiguous, 16-byte
    aligned tensor of that dtype and shape on ``dev``."""
    for name, t, dt, shape in operands:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {dt} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")


GROUP_SIZES = (16, 32, 64, 128)  # the kernel's compiled group sizes


def check_shapes(x: torch.Tensor, word: torch.Tensor, group_size: int) -> None:
    """Raise ValueError for shapes the kernel does not take (the magic
    layout itself guarantees K % (4g) == 0). The wrapper applies it on
    every device, so the CPU refuses what the card would."""
    if x.ndim != 2 or word.ndim != 2:
        raise ValueError("int4_wo_magic takes 2-D x (M, K) and words (K/8, N)")
    k, (kw, n), g = x.shape[1], word.shape, group_size
    if k != 8 * kw:
        raise ValueError(f"K mismatch {k} vs packed {kw}*8")
    if g not in GROUP_SIZES or n % 32 or k % (4 * g):
        raise ValueError(f"N={n} must be a multiple of 32, g={g} one of {GROUP_SIZES} "
                         f"and K={k} a multiple of 4g")


def affine_qparams(scale, zp, zp_domain):
    """(s, b) in f32 with u*s + b = the dequantized weight, u the nibble
    0..15, for either zero-point domain (the reference wrappers'
    int4_matmul.py:411-425 and :572-582, and ops/linear.py:226-232)."""
    s = scale.to(torch.float32)
    if zp_domain is P.ZeroPointDomain.FLOAT:
        b = zp.to(torch.float32)
    elif zp is None:
        b = -8.0 * s
    else:
        b = -(8.0 + zp.to(torch.float32)) * s
    return s, b


def transport_qparams(scale, zp, zp_domain):
    """(s, b2) in bf16 with q*s + b2 = the dequantized weight, q = u - 8."""
    s, b = affine_qparams(scale, zp, zp_domain)
    return s.to(torch.bfloat16), (b + 8.0 * s).to(torch.bfloat16)


def int4_wo_magic_plain(x, word, s, b2, group_size: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, f32 out (M, N): per group G,
    acc += s[G] * (x_G @ q_G) then acc += sum(x_G) * b2[G], in f32."""
    g = group_size
    q = unpack_int4_magic(word, g).to(torch.float32) - 8.0
    xf = x.to(torch.float32)
    m, k = xf.shape
    acc = torch.zeros((m, word.shape[1]), dtype=torch.float32, device=x.device)
    for grp in range(k // g):
        xg = xf[:, grp * g:(grp + 1) * g]
        acc = acc + s[grp].to(torch.float32) * (xg @ q[grp * g:(grp + 1) * g])
        acc = acc + xg.sum(dim=1, keepdim=True) * b2[grp].to(torch.float32)
    return acc


_SM_COUNT = {}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def _split_units(units: int, n_blocks: int, sm_count: int):
    """(splits, units per split): split ``units`` whole K units until about
    four 4-warp blocks per SM are in flight."""
    splits = max(1, min(units, -(-4 * sm_count // n_blocks)))
    per = -(-units // splits)
    return -(-units // per), per


GEMV_MAX_M = 16  # the decode kernels' rows; above them the mainloop's tiles
GEMV_RUN_ROWS = 16  # word rows of K1's finer decode run (two k16 steps, all four planes)


def pick_splits(m: int, k: int, n: int, group_size: int, sm_count: int):
    """(splits, runs per split, word rows per run) for K1's decode kernel
    (M <= 16): K split into runs of word rows until about four 4-warp blocks
    per SM are in flight. A run is a whole super-group of 4g K rows (g/2
    word rows); where those leave fewer blocks than SMs (4096x1024 at g =
    128: 8 super-groups, 64 blocks), runs of GEMV_RUN_ROWS word rows with
    all four planes, each folding its part of a group."""
    g = group_size
    nsuper = k // (4 * g)
    n_blocks = -(-n // 128)
    splits, per = _split_units(nsuper, n_blocks, sm_count)
    if n_blocks * splits < sm_count and g // 2 > GEMV_RUN_ROWS:
        splits, per = _split_units(nsuper * (g // 2 // GEMV_RUN_ROWS), n_blocks, sm_count)
        return splits, per, GEMV_RUN_ROWS
    return splits, per, g // 2


# K1's and K15's prefill (M > 16) on the mainloop (csrc/mixed_gemm.cuh with
# MagicOp, csrc/magic_op.cuh): tiles (BM, BN); K in units of 64 word rows
# (512 K values, 8 stages of 64), which a K split never cuts
MAGIC_TILES = ((128, 128), (64, 128))
MAGIC_UNIT_K = 512
MAGIC_STAGE_K = 64


def magic_units(k: int) -> int:
    """The mainloop's units over K (a ragged last one at K % 512)."""
    return -(-k // MAGIC_UNIT_K)


def magic_launched_splits(k: int, splits: int) -> int:
    """The splits a launch runs when asked for ``splits``: ceil(units /
    splits) whole units each, so possibly fewer."""
    units = magic_units(k)
    return -(-units // -(-units // splits))


def magic_stages_per_split(k: int, splits: int) -> int:
    """Stages of 64 K values a split of a prefill launch runs: whole units."""
    return MAGIC_UNIT_K // MAGIC_STAGE_K * -(-magic_units(k) // splits)


def magic_ctas_per_sm(bm: int, bn: int) -> int:
    """CTAs of a fold tile an SM holds: one at (128, 128) (acc and tmp, 64
    f32 each a thread), two at (64, 128)."""
    return 1 if (bm, bn) == (128, 128) else 2


@functools.lru_cache(maxsize=None)
def candidate_tiles_magic(m: int, k: int, n: int):
    """Every (bm, bn, splits) the mainloop takes for K1 or K15 at this
    shape: MAGIC_TILES (a ragged last tile of columns where BN does not
    divide N) and each split count a launch runs as asked. No tuner times
    them (the reference has none); a cached entry is taken if it is one."""
    units = magic_units(k)
    splits = [sp for sp in range(1, units + 1) if magic_launched_splits(k, sp) == sp]
    return tuple((bm, bn, sp) for bm, bn in MAGIC_TILES for sp in splits)


def pick_tiles_magic(m: int, k: int, n: int, sm_count: int):
    """(bm, bn, splits) for a prefill launch of K1 or K15: BM = 64 rows of x
    up to M = 64, else 128, by BN = 128 weight columns; K split into whole
    units until the CTAs fill three quarters of the card's CTA slots (a
    split costs a second pass), as far as K's units allow."""
    bm, bn = (64 if m <= 64 else 128), 128
    units = magic_units(k)
    ctas = -(-m // bm) * -(-n // bn)
    want = -(-3 * sm_count * magic_ctas_per_sm(bm, bn) // 4)
    need = -(-want // ctas)  # splits that fill the card
    per = -(-units // need)  # balanced splits, unless rounding leaves too few
    if -(-units // per) < need:
        per = max(1, units // need)
    return bm, bn, magic_launched_splits(k, -(-units // per))


def pick_tiles(m: int, k: int, n: int, group_size: int, sm_count: int):
    """(bm, bn, splits) for a K1 prefill launch (M > 16). A tuned entry of
    the tile cache under the reference's key (``autotune.lookup_tuned(
    "int4_wo_magic", m, k, n, 0)``, as ``_pick_tn_magic`` asks) comes first,
    if ``candidate_tiles_magic`` lists it; else ``pick_tiles_magic``."""
    from ao_tpu_torch.ops.hopper.autotune import lookup_tuned

    tuned = lookup_tuned("int4_wo_magic", m, k, n, 0)
    if tuned is not None and tuple(tuned) in candidate_tiles_magic(m, k, n):
        return tuple(tuned)
    return pick_tiles_magic(m, k, n, sm_count)


def launch_tiles(m: int, k: int, n: int, group_size: int, sm_count: int, tiles=None):
    """What a K1 launch at (M, K, N) runs: (bm, bn, splits, per, run_rows).
    M <= 16: the decode kernel (bm 16, bn 128), ``per`` runs of ``run_rows``
    word rows a split (``pick_splits``). Larger M: the mainloop's tiles
    (``tiles``, one of ``candidate_tiles_magic``, or ``pick_tiles``'s),
    ``per`` stages of 64 K a split, run_rows 0."""
    if m <= GEMV_MAX_M:
        return (GEMV_MAX_M, 128) + pick_splits(m, k, n, group_size, sm_count)
    if tiles is None:
        tiles = pick_tiles(m, k, n, group_size, sm_count)
    elif tuple(tiles) not in candidate_tiles_magic(m, k, n):
        raise ValueError(f"int4_wo_magic: tiles {tiles} are not the mainloop's at {(m, k, n)}")
    bm, bn, splits = tiles
    return bm, bn, splits, magic_stages_per_split(k, splits), 0


def magic_step(s: int, kk: int, group_size: int):
    """Step ``kk`` of mainloop stage ``s`` over a magic layout of group g, as
    MagicOp reads it (csrc/magic_op.cuh: ``group_of``, ``unit_row``): K values
    k = 64 s + 16 kk .. + 15 in plain K order, which are group k / g, plane
    (k / g) % 4 of the words of rows ``row`` .. ``row`` + 7. Returns (group,
    row), row counted from word row 0 (units of 64 rows)."""
    g = group_size
    k = MAGIC_STAGE_K * s + 16 * kk
    ku = k % MAGIC_UNIT_K
    return k // g, k // MAGIC_UNIT_K * 64 + ku // (4 * g) * (g // 2) + ku % g // 2


def magic_fold_mirror(x, word, group_size: int, value, fold) -> torch.Tensor:
    """The prefill kernels' arithmetic in PyTorch, f32 (M, N): step by step
    in plain K order, each k16 step's weights decoded from the words as the
    kernel reads them (``magic_step``: word rows row + p, plane j, halves h
    are the step's K pair (2p, 2p + 1)) through ``value(u, group)`` (the
    exact bf16 value of nibble u, as f32), the group's steps summed into tmp
    and folded by ``fold(acc, tmp, group)`` after its last step."""
    g = group_size
    m, k = x.shape
    xf = x.to(torch.bfloat16).to(torch.float32)
    p = torch.arange(8)
    acc = torch.zeros((m, word.shape[1]), dtype=torch.float32)
    for step in range(k // 16):
        grp, row = magic_step(step // 4, step % 4, g)
        words = word[row + p].to(torch.int64)  # (8, N)
        u = torch.stack([(words >> (4 * (grp % 4) + 16 * h)) & 15 for h in (0, 1)], dim=1)
        part = xf[:, 16 * step:16 * step + 16] @ value(u.reshape(16, -1), grp)
        first = (16 * step) % g == 0
        tmp = part if first else tmp + part
        if (16 * step + 16) % g == 0:
            acc = fold(acc, tmp, grp)
    return acc


def int4_wo_magic_mirror(x, word, s, b2, group_size: int, raw_zp: bool = False) -> torch.Tensor:
    """K1's prefill arithmetic through ``magic_fold_mirror``: q = u - 8,
    then per group acc += s * tmp + sum(x_G) * b2 in f32, with the x sums
    of the pre-pass. With ``raw_zp`` b2 holds the tinygemm zero point and
    b2 = bf16(zp + 8s) is formed as the kernel's bias_of does."""
    g = group_size
    xs = x.to(torch.bfloat16).to(torch.float32).reshape(x.shape[0], -1, g).sum(-1)
    sf = s.to(torch.float32)
    bf = (8.0 * sf + b2.to(torch.float32)).to(torch.bfloat16) if raw_zp else b2
    bf = bf.to(torch.float32)
    return magic_fold_mirror(
        x, word, g, lambda u, grp: (u - 8).to(torch.float32),
        lambda acc, tmp, grp: acc + sf[grp] * tmp + xs[:, grp:grp + 1] * bf[grp])


def _launch(x, word, s, b2, group_size: int, raw_zp: bool = False, tiles=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; ``b2`` is the tinygemm zero point
    when ``raw_zp``; ``tiles`` (bm, bn, splits) overrides ``pick_tiles``
    (``launch_tiles``)."""
    dev = x.device
    m, k = x.shape
    n = word.shape[1]
    g = group_size
    _check_operands("int4_wo_magic", dev, (
        ("x", x, torch.bfloat16, (m, k)),
        ("word", word, torch.int32, (k // 8, n)),
        ("scale", s, torch.bfloat16, (k // g, n)),
        ("bias", b2, torch.bfloat16, (k // g, n))))
    bm, bn, splits, per, run_rows = launch_tiles(m, k, n, g, _sm_count(dev), tiles)
    xs = None  # the mainloop's row sums of x per group
    if m > GEMV_MAX_M:
        xs = torch.empty((k // g, -(-m // 4) * 4), dtype=torch.float32, device=dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_int4_wo_magic(
            x.data_ptr(), word.data_ptr(), s.data_ptr(), b2.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), None if xs is None else xs.data_ptr(), m, k, n,
            g, bm, bn, splits, per, run_rows, int(raw_zp), stream)
    if err != 0:
        raise RuntimeError(f"int4_wo_magic kernel launch failed: CUDA error {err}")
    int4_wo_magic.launches += 1
    return out


def int4_wo_magic(x, word, scale, zp, group_size: int, zp_domain) -> torch.Tensor:
    """x (M, K); word int32 (K/8, N) magic layout; scale/zp (K/g, N).
    Returns (M, N) bf16: the kernel on a CUDA tensor, its plain version on
    a CPU tensor."""
    check_shapes(x, word, group_size)
    x = x.to(torch.bfloat16)
    if x.device.type == "cpu":
        s, b2 = transport_qparams(scale, zp, zp_domain)
        return int4_wo_magic_plain(x, word, s, b2, group_size).to(torch.bfloat16)
    if x.device.type != "cuda":
        raise ValueError(f"int4_wo_magic runs on cuda or cpu tensors, not {x.device}")
    if (zp_domain is P.ZeroPointDomain.FLOAT and scale.dtype == torch.bfloat16
            and zp is not None and zp.dtype == torch.bfloat16):
        return _launch(x, word, scale, zp, group_size, raw_zp=True)
    s, b2 = transport_qparams(scale, zp, zp_domain)
    return _launch(x, word, s, b2, group_size)


int4_wo_magic.launches = 0  # kernel launches (not plain-version calls)


def traffic(m: int, k: int, n: int, group_size: int):
    """(bytes, flops) the function needs: each input read once (x bf16,
    words 0.5 B per weight, s and b2 bf16), the output written once."""
    ng = k // group_size
    nbytes = m * k * 2 + k * n // 2 + 2 * ng * n * 2 + m * n * 2
    return nbytes, 2 * m * k * n


# ---------------------------------------------------------------------------
# K3: W4A8 matmul (int8 x, magic8 int4 W, f32 out)
# ---------------------------------------------------------------------------

W4A8_GROUP_SIZES = (32, 64, 128)  # K3's and K4's compiled group sizes


def check_shapes_w4a8(xq: torch.Tensor, word: torch.Tensor, group_size: int) -> None:
    """Raise ValueError for shapes K3 does not take: the reference's rule
    (N % 128 == 0, K/g even, g % 8 == 0) and the compiled group sizes."""
    if xq.ndim != 2 or word.ndim != 2:
        raise ValueError("int4_w4a8_matmul takes 2-D xq (M, K) and words (K/8, N)")
    k, (kw, n), g = xq.shape[1], word.shape, group_size
    if k != 8 * kw:
        raise ValueError(f"K mismatch {k} vs packed {kw}*8")
    if g not in W4A8_GROUP_SIZES or n % 128 or k % (2 * g):
        raise ValueError(f"N={n} must be a multiple of 128, g={g} one of {W4A8_GROUP_SIZES} "
                         f"and K={k} a multiple of 2g")


def w4a8_qparams(scale, zp, zp_domain):
    """(s, b) of ``affine_qparams`` in bf16, K3's transport form."""
    s, b = affine_qparams(scale, zp, zp_domain)
    return s.to(torch.bfloat16), b.to(torch.bfloat16)


def int4_w4a8_matmul_plain(xq, sx, word, s, b, group_size: int) -> torch.Tensor:
    """K3's function in plain PyTorch, f32 (M, N): per group G,
    acc += s[G] * dot(x_G, u_G) then acc += sum(x_G) * b[G], in f32 (the
    dot of int8 and 0..15 values over a group is exact in f32), then
    acc * sx."""
    g = group_size
    u = unpack_int4_magic8(word, g).to(torch.float32)
    xf = xq.to(torch.float32)
    m, k = xf.shape
    acc = torch.zeros((m, word.shape[1]), dtype=torch.float32, device=xq.device)
    for grp in range(k // g):
        xg = xf[:, grp * g:(grp + 1) * g]
        acc = acc + s[grp].to(torch.float32) * (xg @ u[grp * g:(grp + 1) * g])
        acc = acc + xg.sum(dim=1, keepdim=True) * b[grp].to(torch.float32)
    return acc * sx.reshape(m, 1).to(torch.float32)


W4A8_MAX_CLUSTER = 8  # CTAs of a portable thread-block cluster: K3's K splits
W4A8_K_WARPS = (1, 2, 4, 8)  # warps along K a K3 CTA (of one warp of 32 columns)


def w4a8_plan(m: int, k: int, n: int, group_size: int, sm_count: int):
    """(warps along K, splits, group pairs a warp) of a K3 launch. K (K / 2g
    group pairs) is cut into slices until about 16 warps an SM are in
    flight over the N / 32 warps of columns (times the 32-row tiles above
    M = 16); a CTA (one warp of columns) takes 4, 2 or 1 of them as warps
    along K, the most that divides them (1 above 16 rows), and the cluster
    of its splits along K the rest, at most W4A8_MAX_CLUSTER CTAs. Llama-3-8B
    at M = 8: wq / wo (4, 4, 1), wk / wv (4, 4, 1), w1 / w3 (4, 1, 4), w2
    (2, 7, 4), the lm_head (1, 1, 16); on the H100 each within noise of the
    fastest plan of kernel_tiles.py time K3 but wk / wv's (2, 8, 1), 5 %."""
    pairs = k // (2 * group_size)
    col_warps = n // 32 * (1 if m <= 16 else -(-m // 32))
    most = (1 if m > 16 else 4) * W4A8_MAX_CLUSTER
    slices = max(1, min(pairs, 16 * sm_count // col_warps, most))
    per = -(-pairs // slices)
    slices = -(-pairs // per)
    wk = 1 if m > 16 else next((w for w in (4, 2, 1) if slices % w == 0
                                and slices // w <= W4A8_MAX_CLUSTER), 4)
    return wk, -(-slices // wk), per


def _launch_w4a8(xq, sx, word, s, b, group_size: int, plan=None) -> torch.Tensor:
    """Launch K3 on CUDA tensors: one kernel, no workspace. ``plan``
    (warps along K, splits, pairs a warp) overrides ``w4a8_plan``."""
    dev = xq.device
    m, k = xq.shape
    n = word.shape[1]
    ng = k // group_size
    _check_operands("int4_w4a8_matmul", dev, (
        ("xq", xq, torch.int8, (m, k)),
        ("sx", sx, torch.float32, (m, 1)),
        ("word", word, torch.int32, (k // 8, n)),
        ("scale", s, torch.bfloat16, (ng, n)),
        ("bias", b, torch.bfloat16, (ng, n))))
    wk, splits, spp = plan or w4a8_plan(m, k, n, group_size, _sm_count(dev))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib_w4a8().ao_int4_w4a8(
            xq.data_ptr(), sx.data_ptr(), word.data_ptr(), s.data_ptr(), b.data_ptr(),
            out.data_ptr(), m, k, n, group_size, wk, splits, spp, stream)
    if err != 0:
        raise RuntimeError(f"int4_w4a8_matmul kernel launch failed: CUDA error {err}")
    int4_w4a8_matmul.launches += 1
    return out


def int4_w4a8_matmul(xq, sx, word, scale, zp, group_size: int, zp_domain) -> torch.Tensor:
    """xq int8 (M, K), symmetric per token with f32 scale sx (M, 1); word
    int32 (K/8, N) magic8 layout; scale/zp (K/g, N). Returns f32 (M, N),
    already scaled by sx: the kernel on a CUDA tensor, its plain version on
    a CPU tensor."""
    check_shapes_w4a8(xq, word, group_size)
    sx = sx.reshape(-1, 1).to(torch.float32)
    if (zp_domain is P.ZeroPointDomain.FLOAT and scale.dtype == torch.bfloat16
            and zp is not None and zp.dtype == torch.bfloat16):
        s, b = scale, zp  # the transport form already: no host-side pass
    else:
        s, b = w4a8_qparams(scale, zp, zp_domain)
    if xq.device.type == "cpu":
        return int4_w4a8_matmul_plain(xq, sx, word, s, b, group_size)
    if xq.device.type != "cuda":
        raise ValueError(f"int4_w4a8_matmul runs on cuda or cpu tensors, not {xq.device}")
    return _launch_w4a8(xq, sx, word, s, b, group_size)


int4_w4a8_matmul.launches = 0  # kernel launches (not plain-version calls)


def traffic_w4a8(m: int, k: int, n: int, group_size: int):
    """(bytes, int8 operations) K3 needs: xq int8 and sx f32 read once,
    words 0.5 B per weight, s and b bf16, the f32 output written once."""
    ng = k // group_size
    nbytes = m * k + m * 4 + k * n // 2 + 2 * ng * n * 2 + m * n * 4
    return nbytes, 2 * m * k * n


# ---------------------------------------------------------------------------
# K4: magic8 -> per-channel int8 requantization (prefill W4A8 feeder)
# ---------------------------------------------------------------------------


def check_shapes_requant(word: torch.Tensor, group_size: int) -> None:
    """Raise ValueError for shapes K4 does not take: 256 K rows and 64
    columns per block, the compiled group sizes."""
    if word.ndim != 2:
        raise ValueError("int4_magic8_requant_int8 takes 2-D words (K/8, N)")
    (kw, n), g = word.shape, group_size
    if g not in W4A8_GROUP_SIZES or n % 64 or (8 * kw) % 256:
        raise ValueError(f"N={n} must be a multiple of 64, K={8 * kw} of 256 and "
                         f"g={g} one of {W4A8_GROUP_SIZES}")


def requant_rows(scale, bias, s8):
    """(a, b) = scale / s8 and bias / s8 per group in f32, as the reference
    wrapper forms them (int4_matmul.py:705-707): one reciprocal, two
    multiplies."""
    inv = 1.0 / s8.to(torch.float32)
    return ((scale.to(torch.float32) * inv).contiguous(),
            (bias.to(torch.float32) * inv).contiguous())


def int4_magic8_requant_int8_plain(word, a, b, group_size: int) -> torch.Tensor:
    """K4's function in plain PyTorch: int8 (K, N) = clip(round(u*a + b),
    -127, 127) with a and b of the row's group; the multiply and the add
    are two roundings, as in the kernel."""
    u = unpack_int4_magic8(word, group_size).to(torch.float32)
    v = u * a.repeat_interleave(group_size, dim=0) + b.repeat_interleave(group_size, dim=0)
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def _launch_requant(word, a, b, group_size: int) -> torch.Tensor:
    dev = word.device
    kw, n = word.shape
    k = 8 * kw
    ng = k // group_size
    _check_operands("int4_magic8_requant_int8", dev, (
        ("word", word, torch.int32, (kw, n)),
        ("a", a, torch.float32, (ng, n)),
        ("b", b, torch.float32, (ng, n))))
    out_t = torch.empty((n, k), dtype=torch.int8, device=dev)  # q8 transposed
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib_w4a8().ao_int4_magic8_requant(
            word.data_ptr(), a.data_ptr(), b.data_ptr(), out_t.data_ptr(), k, n, group_size,
            stream)
    if err != 0:
        raise RuntimeError(f"int4_magic8_requant_int8 kernel launch failed: CUDA error {err}")
    int4_magic8_requant_int8.launches += 1
    return out_t.t()


def int4_magic8_requant_int8(word, scale, bias, s8, group_size: int) -> torch.Tensor:
    """magic8 words (K/8, N) + per-group dequant params w = u*scale + bias
    ((K/g, N) each) + per-channel int8 scale s8 (1, N) -> int8 (K, N) with
    w ~ q8 * s8. On a CUDA tensor the kernel writes q8 column-major (the
    (K, N) view of an (N, K) tensor), the layout torch._int_mm takes as its
    B operand; on a CPU tensor the plain version returns it row-major."""
    check_shapes_requant(word, group_size)
    a, b = requant_rows(scale, bias, s8)
    if word.device.type == "cpu":
        return int4_magic8_requant_int8_plain(word, a, b, group_size)
    if word.device.type != "cuda":
        raise ValueError(f"int4_magic8_requant_int8 runs on cuda or cpu tensors, not {word.device}")
    return _launch_requant(word, a, b, group_size)


int4_magic8_requant_int8.launches = 0  # kernel launches (not plain-version calls)


def traffic_requant(k: int, n: int, group_size: int):
    """(bytes, operations) K4 needs: words 0.5 B per weight, a and b f32
    per group, the int8 output written once; two f32 operations per weight."""
    ng = k // group_size
    return k * n // 2 + 2 * ng * n * 4 + k * n, 2 * k * n


# ---------------------------------------------------------------------------
# K11: int4 weight-only matmul over the uint8 split-half layout
# ---------------------------------------------------------------------------


def takes_halves(k: int, n: int, group_size: int) -> bool:
    """Whether K11 takes a split-half (K/2, N) weight: the reference
    wrapper's rule (N % 128 == 0, K/2 a multiple of g/2) and the kernel's
    16 byte rows per step (g % 32 == 0). ``kernels.int4_wo_matmul`` asks it
    before the call; the wrapper's own check asks it too."""
    g = group_size
    return g >= 32 and g % 32 == 0 and k % g == 0 and n % 128 == 0


def int4_wo_matmul_plain(x, packed, s, b, group_size: int) -> torch.Tensor:
    """K11's function in plain PyTorch, f32 (M, N): each weight
    bf16(u * s + b) (a multiply and an add in f32, two roundings), then x
    in bf16 times those weights with f32 sums."""
    g = group_size
    u = unpack_int4(packed, g, axis=-2).to(torch.float32)
    rep = lambda t: t.to(torch.float32).repeat_interleave(g, dim=0)  # noqa: E731
    w = (u * rep(s) + rep(b)).to(torch.bfloat16)
    return x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)


# K11's tiles (BM, BN) on the mainloop (csrc/mixed_gemm.cuh::launch), and the
# K splits the tile cache's candidates may take
HALVES_TILES = ((128, 128), (64, 128), (128, 64), (64, 64), (256, 128))
HALVES_SPLITS = (1, 2, 3, 4, 6, 8)
HALVES_STAGE_BYTES = 32  # byte rows (64 K values) per stage


def halves_stages(k: int) -> int:
    """K11's stages of 32 byte rows over K/2 (a ragged last one at K/2 %
    32 == 16)."""
    return -(-(k // 2) // HALVES_STAGE_BYTES)


def launched_splits(k: int, splits: int) -> int:
    """The splits a K11 launch runs when asked for ``splits``: whole stages
    each, ceil(stages / splits) a split, so possibly fewer."""
    stages = halves_stages(k)
    return -(-stages // -(-stages // splits))


@functools.lru_cache(maxsize=None)
def candidate_tiles_halves(m: int, k: int, n: int, group_size: int):
    """Every (bm, bn, splits) K11 takes at this shape: the mainloop's tiles
    whose BN divides N, and each of HALVES_SPLITS up to K's stages; the
    tile cache's tuner times them and the picker takes a cached entry only
    if it is one of them."""
    if not takes_halves(k, n, group_size):
        return ()
    stages = halves_stages(k)
    return tuple((bm, bn, sp) for bm, bn in HALVES_TILES if n % bn == 0
                 for sp in HALVES_SPLITS if sp <= stages)


def pick_tiles_halves(m: int, k: int, n: int, group_size: int, sm_count: int):
    """(bm, bn, splits) for a K11 launch. A tuned entry of the tile cache
    (``autotune.lookup_tuned("int4_wo_matmul", m, k, n, g)``) comes first,
    if ``candidate_tiles_halves`` lists it, as the reference's ``_pick_tiles``
    does. Otherwise (128, 128), then (64, 128), whichever first puts at
    least half as many CTAs as SMs in flight unsplit: K11's K is short (768
    at ViT-B, 12 stages), so a fat CTA that runs its stages back to back
    beats twice as many thin ones (on the H100 ``autotune_int4`` keeps
    these tiles at both of ViT-B's shapes; PERF.md). Else (64, 128)
    with the fewest of HALVES_SPLITS that reach it, or the most K's stages
    allow."""
    from ao_tpu_torch.ops.hopper.autotune import lookup_tuned

    cands = candidate_tiles_halves(m, k, n, group_size)
    tuned = lookup_tuned("int4_wo_matmul", m, k, n, group_size)
    if tuned is not None and tuple(tuned) in cands:
        return tuple(tuned)
    want = -(-sm_count // 2)
    for bm in (128, 64):
        if -(-m // bm) * (n // 128) >= want:
            return bm, 128, 1
    ctas = -(-m // 64) * (n // 128)
    splits = [sp for bm, bn, sp in cands if (bm, bn) == (64, 128)]
    return 64, 128, next((sp for sp in splits if ctas * launched_splits(k, sp) >= want),
                         splits[-1])


def _launch_halves(x, packed, s, b, group_size: int, raw: bool, tiles=None) -> torch.Tensor:
    """Launch K11 on CUDA tensors; ``s`` and ``b`` are the bf16 tinygemm
    scale and zero point when ``raw``, else f32. ``tiles`` (bm, bn, splits),
    one of ``candidate_tiles_halves``, overrides ``pick_tiles_halves``."""
    dev = x.device
    m, k = x.shape
    n = packed.shape[1]
    qdt = torch.bfloat16 if raw else torch.float32
    _check_operands("int4_wo_matmul", dev, (
        ("x", x, torch.bfloat16, (m, k)),
        ("packed", packed, torch.uint8, (k // 2, n)),
        ("scale", s, qdt, (k // group_size, n)),
        ("bias", b, qdt, (k // group_size, n))))
    if tiles is None:
        tiles = pick_tiles_halves(m, k, n, group_size, _sm_count(dev))
    elif tuple(tiles) not in candidate_tiles_halves(m, k, n, group_size):
        raise ValueError(f"int4_wo_matmul: tiles {tiles} are not K11's at {(m, k, n)}")
    bm, bn, splits = tiles
    per = -(-halves_stages(k) // splits)
    splits = launched_splits(k, splits)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_int4_wo_halves(x.data_ptr(), packed.data_ptr(), s.data_ptr(),
                                       b.data_ptr(), out.data_ptr(),
                                       None if ws is None else ws.data_ptr(), m, k, n,
                                       group_size, int(raw), bm, bn, splits, per, stream)
    if err != 0:
        raise RuntimeError(f"int4_wo_matmul kernel launch failed: CUDA error {err}")
    int4_wo_matmul.launches += 1
    return out


def int4_wo_matmul(x, packed, scale, zp, group_size: int, zp_domain) -> torch.Tensor:
    """x (M, K); packed uint8 (K/2, N) split-half layout; scale/zp (K/g, N).
    Returns (M, N) bf16: K11 on a CUDA tensor, its plain version on a CPU
    tensor; ValueError on either for a shape the kernel does not take."""
    if x.ndim != 2 or packed.ndim != 2:
        raise ValueError("int4_wo_matmul takes 2-D x (M, K) and packed bytes (K/2, N)")
    k, (kp, n) = x.shape[1], packed.shape
    if k != 2 * kp or not takes_halves(k, n, group_size):
        raise ValueError(f"int4_wo_matmul takes K = 2 * K/2 ({k} vs {kp}), N % 128 == 0 "
                         f"(N={n}), g % 32 == 0 and K % g == 0 (g={group_size})")
    x = x.to(torch.bfloat16)
    if x.device.type == "cpu":
        s, b = affine_qparams(scale, zp, zp_domain)
        return int4_wo_matmul_plain(x, packed, s, b, group_size).to(torch.bfloat16)
    if x.device.type != "cuda":
        raise ValueError(f"int4_wo_matmul runs on cuda or cpu tensors, not {x.device}")
    if (zp_domain is P.ZeroPointDomain.FLOAT and scale.dtype == torch.bfloat16
            and zp is not None and zp.dtype == torch.bfloat16):
        return _launch_halves(x, packed, scale, zp, group_size, raw=True)
    s, b = affine_qparams(scale, zp, zp_domain)
    return _launch_halves(x, packed, s.contiguous(), b.contiguous(), group_size, raw=False)


int4_wo_matmul.launches = 0  # kernel launches (not plain-version calls)


def traffic_halves(m: int, k: int, n: int, group_size: int):
    """(bytes, flops) K11 needs on the main path: x bf16 read once, the
    weight 0.5 B per value, scale and zero point bf16, the bf16 output
    written once; 2 M K N flops."""
    ng = k // group_size
    return m * k * 2 + k * n // 2 + 2 * ng * n * 2 + m * n * 2, 2 * m * k * n
