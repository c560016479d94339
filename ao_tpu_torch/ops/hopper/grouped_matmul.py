"""The MoE grouped int4 kernels of ``ao_tpu/ops/pallas/grouped_matmul.py``, on Hopper.

K13 in its two forms, over (E, K/8, N) expert stacks whose token rows come
sorted by expert (``group_sizes[e]`` rows each, in expert order):

* ``int4_grouped_magic``: bf16 x times the "magic" stack, bf16 out
  (``int4_grouped_magic_pallas``, kernel ``_grouped_magic_kernel``);
* ``int4_grouped_w4a8``: int8 per-token symmetric x times the "magic8"
  stack, f32 out already scaled by sx (``int4_grouped_w4a8_pallas``, kernel
  ``_grouped_w4a8_kernel``).

CUDA source ``ao_tpu_torch/csrc/grouped_matmul.cu``; its header says what
bounds the kernels on the H100 and how the design meets it. The TPU kernel
takes each row's expert id; these take the group sizes themselves, which the
kernels turn into row ranges on the device. The rows must cover all T rows
(``sum(group_sizes) == T``, what ``moe.layer.dispatch`` gives).

The magic form runs one of two kernels: at T <= ``DECODE_MAX_T`` rows the
decode kernel, its K split summed in a cluster (``decode_plan``); above, row
tiles of ``pick_bm`` rows of one expert each on the shared wgmma mainloop,
which the kernel finds from the group sizes on the device (``tile_plan``
mirrors that schedule).

Each wrapper runs its kernel on a CUDA tensor and its plain PyTorch version
(``*_plain``, the TPU kernel's masked sum over experts of K1's or K3's plain
version) on a CPU tensor, and raises ValueError on either for a shape
``takes`` refuses. The transport of the qparams is K1's and K3's
(``int4_matmul.transport_qparams``, ``w4a8_qparams``): for bf16 tinygemm
qparams the kernels take the scale and zero point as they are.
"""

from __future__ import annotations

import ctypes

import torch

from ao_tpu_torch.ops.hopper import build
from ao_tpu_torch.ops.hopper import int4_matmul as k1
from ao_tpu_torch.quantization import primitives as P

MAGIC_GROUP_SIZES = k1.GROUP_SIZES  # the magic form's compiled group sizes, K1's
W4A8_GROUP_SIZES = k1.W4A8_GROUP_SIZES  # the W4A8 form's, K3's
DECODE_MAX_T = 16  # the magic form's decode kernel takes up to this many rows
ROW_TILES = (64, 128)  # the row-tile kernel's tiles of x rows (BM)
MAX_CLUSTER = 8  # CTAs of a portable thread-block cluster: the decode's K splits

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("grouped_matmul")
        lib.ao_int4_grouped_magic.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        lib.ao_int4_grouped_magic.restype = ctypes.c_int
        lib.ao_int4_grouped_w4a8.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.ao_int4_grouped_w4a8.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def takes(k: int, n: int, group_size: int, layout: str) -> bool:
    """Whether K13 takes an (E, K/8, N) stack in ``layout``: the reference
    wrappers' UnsupportedShape rules (grouped_matmul.py:190-200 magic:
    N % 128, K/g % 4, (g/2) % 8; :330-340 magic8: N % 128, K/g even,
    g % 8) narrowed to the compiled group sizes. ``moe.grouped`` asks it
    before the call and takes the ragged fallback where it says no."""
    g = group_size
    if n % 128 or g <= 0 or k % g:
        return False
    if layout == "magic":
        return g in MAGIC_GROUP_SIZES and (k // g) % 4 == 0
    if layout == "magic8":
        return g in W4A8_GROUP_SIZES and (k // g) % 2 == 0
    return False


def _check(name: str, x, word3, group_sizes, group_size: int, layout: str) -> None:
    if x.ndim != 2 or word3.ndim != 3 or group_sizes.ndim != 1:
        raise ValueError(f"{name} takes x (T, K), words (E, K/8, N) and group sizes (E,)")
    (e, kw, n), k = word3.shape, x.shape[1]
    if k != 8 * kw or group_sizes.shape[0] != e:
        raise ValueError(f"{name}: K={k} vs packed {kw}*8, or {group_sizes.shape[0]} group "
                         f"sizes for {e} experts")
    if not takes(k, n, group_size, layout):
        raise ValueError(f"{name} does not take K={k}, N={n}, g={group_size} ({layout}): "
                         f"see grouped_matmul.takes")


def expert_ids(group_sizes: torch.Tensor, total: int) -> torch.Tensor:
    """(E,) group sizes -> (T,) int32 expert id of each sorted row, on the
    device (``output_size`` spares ``repeat_interleave`` its host read)."""
    e = group_sizes.shape[0]
    return torch.repeat_interleave(
        torch.arange(e, dtype=torch.int32, device=group_sizes.device), group_sizes.long(),
        output_size=total)


def int4_grouped_magic_plain(x, word3, s3, b23, group_sizes, group_size: int) -> torch.Tensor:
    """The magic form in plain PyTorch, f32 (T, N): the TPU kernel's masked
    sum over experts of K1's plain version, ``1[e(t) = e] * (x[t] @ W_e)``,
    with s and b2 in K1's transport form."""
    ids = expert_ids(group_sizes, x.shape[0])[:, None]
    out = torch.zeros((x.shape[0], word3.shape[2]), dtype=torch.float32, device=x.device)
    for e in range(word3.shape[0]):
        y = k1.int4_wo_magic_plain(x, word3[e], s3[e], b23[e], group_size)
        out = out + torch.where(ids == e, y, 0.0)
    return out


def int4_grouped_w4a8_plain(xq, sx, word3, s3, b3, group_sizes, group_size: int) -> torch.Tensor:
    """The W4A8 form in plain PyTorch, f32 (T, N): the masked sum over
    experts of K3's plain version (exact group dots, then s, b and sx in
    f32)."""
    ids = expert_ids(group_sizes, xq.shape[0])[:, None]
    out = torch.zeros((xq.shape[0], word3.shape[2]), dtype=torch.float32, device=xq.device)
    for e in range(word3.shape[0]):
        y = k1.int4_w4a8_matmul_plain(xq, sx, word3[e], s3[e], b3[e], group_size)
        out = out + torch.where(ids == e, y, 0.0)
    return out


def _raw_tinygemm(scale, zp, zp_domain) -> bool:
    return (zp_domain is P.ZeroPointDomain.FLOAT and scale.dtype == torch.bfloat16
            and zp is not None and zp.dtype == torch.bfloat16)


def tile_plan(group_sizes, bm: int):
    """The row-tile kernel's schedule, as its ``row_tile`` computes it on the
    device: for each CTA j of the grid's T // bm + E row tiles, (expert,
    first row, the expert's end row) of the j-th tile of bm rows in expert
    order (each expert's tiles from its first row on), or None for a
    surplus CTA, which exits at once."""
    sizes = [int(v) for v in group_sizes]
    t, plan, lo = sum(sizes), [], 0
    for e, n in enumerate(sizes):
        n = max(0, min(n, t - lo))
        plan += [(e, lo + i * bm, lo + n) for i in range(-(-n // bm))]
        lo += n
    ctas = t // bm + len(sizes)
    return plan + [None] * (ctas - len(plan))


def pick_bm(t: int, e: int) -> int:
    """Row tile of the magic form above DECODE_MAX_T rows: 128 rows where
    the experts own 128 rows each on average, else 64 (a 128-row tile runs
    one CTA an SM, a 64-row one two). On the H100 at Mixtral's widths
    (kernel_tiles.py time K13) 64 is 1.5x faster at T = 256, the two are
    level at T = 1024 (within 5 % either way) and 128 is 8-12 % faster at
    2048."""
    return 128 if t >= 128 * e else 64


def decode_plan(k: int, n: int, e: int, group_size: int, sm_count: int):
    """(splits, super-groups per split) of the magic form's decode kernel:
    K (K / 4g super-groups) split into up to MAX_CLUSTER ranks of a cluster
    until the (N/128) x E blocks, times the splits, put about four 4-warp
    blocks on every SM. At Mixtral's widths and E = 8 w_gate / w_up (896
    blocks) stay whole and w_down (256) splits in three, the fastest of
    one to seven on the H100 (kernel_tiles.py time K13)."""
    nsg = k // (4 * group_size)
    blocks = n // 128 * e
    splits = max(1, min(MAX_CLUSTER, nsg, -(-4 * sm_count // blocks)))
    per = -(-nsg // splits)
    return -(-nsg // per), per


def _launch_magic(x, word3, s3, b23, group_sizes, group_size: int, raw_zp: bool,
                  plan=None) -> torch.Tensor:
    """Launch the magic form on CUDA tensors. ``plan`` overrides the picks:
    (splits, per) of the decode kernel at T <= DECODE_MAX_T, else the row
    tile (64 or 128)."""
    dev = x.device
    t, k = x.shape
    e, _, n = word3.shape
    g = group_size
    ng = k // g
    k1._check_operands("int4_grouped_magic", dev, (
        ("x", x, torch.bfloat16, (t, k)),
        ("word", word3, torch.int32, (e, k // 8, n)),
        ("scale", s3, torch.bfloat16, (e, ng, n)),
        ("bias", b23, torch.bfloat16, (e, ng, n)),
        ("group_sizes", group_sizes, torch.int32, (e,))))
    xs, bm, splits, per = None, 0, 1, 1
    if t <= DECODE_MAX_T:
        splits, per = plan or decode_plan(k, n, e, g, k1._sm_count(dev))
    else:
        bm = plan or pick_bm(t, e)
        if bm not in ROW_TILES:
            raise ValueError(f"int4_grouped_magic: row tile {bm} is not one of {ROW_TILES}")
        xs = torch.empty((ng, (t // bm + e) * bm), dtype=torch.float32, device=dev)
    out = torch.empty((t, n), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_int4_grouped_magic(
            x.data_ptr(), word3.data_ptr(), s3.data_ptr(), b23.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), None if xs is None else xs.data_ptr(), t, k, n, e, g, int(raw_zp), bm,
            splits, per, stream)
    if err != 0:
        raise RuntimeError(f"int4_grouped_magic kernel launch failed: CUDA error {err}")
    int4_grouped_magic.launches += 1
    return out


def int4_grouped_magic(x, word3, scale3, zp3, group_sizes, group_size: int,
                       zp_domain) -> torch.Tensor:
    """x (T, K) sorted by expert; word3 int32 (E, K/8, N) magic layout;
    scale3/zp3 (E, K/g, N); group_sizes (E,) int32. Returns (T, N) bf16,
    ``x[t] @ deq(W[e(t)])``: the kernel on a CUDA tensor, its plain version
    on a CPU tensor."""
    _check("int4_grouped_magic", x, word3, group_sizes, group_size, "magic")
    x = x.to(torch.bfloat16)
    if x.device.type == "cpu":
        s, b2 = k1.transport_qparams(scale3, zp3, zp_domain)
        return int4_grouped_magic_plain(x, word3, s, b2, group_sizes,
                                        group_size).to(torch.bfloat16)
    if x.device.type != "cuda":
        raise ValueError(f"int4_grouped_magic runs on cuda or cpu tensors, not {x.device}")
    gs = group_sizes.to(torch.int32)
    if _raw_tinygemm(scale3, zp3, zp_domain):
        return _launch_magic(x, word3, scale3, zp3, gs, group_size, raw_zp=True)
    s, b2 = k1.transport_qparams(scale3, zp3, zp_domain)
    return _launch_magic(x, word3, s, b2, gs, group_size, raw_zp=False)


int4_grouped_magic.launches = 0  # kernel launches (not plain-version calls)


def _launch_w4a8(xq, sx, word3, s3, b3, group_sizes, group_size: int) -> torch.Tensor:
    dev = xq.device
    t, k = xq.shape
    e, _, n = word3.shape
    ng = k // group_size
    k1._check_operands("int4_grouped_w4a8", dev, (
        ("xq", xq, torch.int8, (t, k)),
        ("sx", sx, torch.float32, (t, 1)),
        ("word", word3, torch.int32, (e, k // 8, n)),
        ("scale", s3, torch.bfloat16, (e, ng, n)),
        ("bias", b3, torch.bfloat16, (e, ng, n)),
        ("group_sizes", group_sizes, torch.int32, (e,))))
    out = torch.empty((t, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_int4_grouped_w4a8(
            xq.data_ptr(), sx.data_ptr(), word3.data_ptr(), s3.data_ptr(), b3.data_ptr(),
            group_sizes.data_ptr(), out.data_ptr(), t, k, n, e, group_size, stream)
    if err != 0:
        raise RuntimeError(f"int4_grouped_w4a8 kernel launch failed: CUDA error {err}")
    int4_grouped_w4a8.launches += 1
    return out


def int4_grouped_w4a8(xq, sx, word3, scale3, zp3, group_sizes, group_size: int,
                      zp_domain) -> torch.Tensor:
    """xq (T, K) int8, symmetric per token with f32 scale sx (T, 1), sorted
    by expert; word3 int32 (E, K/8, N) magic8 layout; scale3/zp3
    (E, K/g, N); group_sizes (E,) int32. Returns f32 (T, N) already scaled
    by sx: the kernel on a CUDA tensor, its plain version on a CPU tensor."""
    _check("int4_grouped_w4a8", xq, word3, group_sizes, group_size, "magic8")
    sx = sx.reshape(-1, 1).to(torch.float32)
    if _raw_tinygemm(scale3, zp3, zp_domain):
        s, b = scale3, zp3  # the transport form already: no host-side pass
    else:
        s, b = k1.w4a8_qparams(scale3, zp3, zp_domain)
    if xq.device.type == "cpu":
        return int4_grouped_w4a8_plain(xq, sx, word3, s, b, group_sizes, group_size)
    if xq.device.type != "cuda":
        raise ValueError(f"int4_grouped_w4a8 runs on cuda or cpu tensors, not {xq.device}")
    return _launch_w4a8(xq, sx, word3, s, b, group_sizes.to(torch.int32), group_size)


int4_grouped_w4a8.launches = 0  # kernel launches (not plain-version calls)


def traffic(t: int, k: int, n: int, group_size: int, active: int, w4a8: bool = False):
    """(bytes, operations) one call needs when ``active`` experts own a row:
    each of their words (0.5 B per weight) and bf16 s and b2 read once, x
    (bf16, or int8 with its f32 sx) read once, the output (bf16, or f32)
    written once; 2 T K N multiply-adds' operations."""
    ng = k // group_size
    weights = active * (k * n // 2 + 2 * ng * n * 2)
    if w4a8:
        return weights + t * k + t * 4 + t * n * 4, 2 * t * k * n
    return weights + t * k * 2 + t * n * 2, 2 * t * k * n
