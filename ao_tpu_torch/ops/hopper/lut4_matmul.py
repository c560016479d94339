"""K15: the 16-entry-LUT weight-only matmul of ``ao_tpu/ops/pallas/lut4_matmul.py``,
on Hopper.

``lut4_wo_magic`` computes y (M, N) bf16 = x (M, K) @ (lut[codes] * scalers):
the codes in the int4 magic layout (K/8, N) with group g, f32 per-group
scalers (K/g, N) applied after each group's products, and one shared (16,)
codebook or (L, 16) codebooks over row blocks of K/L rows
(``lut4_wo_magic_pallas``, kernel ``_lut4_kernel``). The codebooks are
rounded to bf16, as the reference's kernel reads them, and passed as a
device tensor at run time. CUDA source ``ao_tpu_torch/csrc/lut4_matmul.cu``
(its decode form, M <= 16, on K1's weight-stream decode mainloop,
``csrc/gemv_mainloop.cuh``, with K1's plan ``int4_matmul.gemv_plan``; its
prefill form on K1's wgmma mainloop with the per-group fold,
``csrc/magic_op.cuh``, with the tiles ``launch_tiles`` gives), whose header
says what bounds it on the H100 and how the design meets it.
The wrapper runs the kernel on a CUDA tensor and its plain PyTorch version
(``lut4_wo_magic_plain``) on a CPU tensor, and raises ValueError on either
for a shape the kernel does not take (``takes``).
"""

from __future__ import annotations

import ctypes

import torch

from ao_tpu_torch.ops.hopper import build
from ao_tpu_torch.ops.hopper import int4_matmul as k1
from ao_tpu_torch.ops.hopper.int4_matmul import _check_operands, _sm_count
from ao_tpu_torch.quantization.qarrays.int4 import unpack_int4_magic

GROUP_SIZES = (16, 32, 64, 128)  # the kernel's compiled group sizes
MAX_LUTS = 256  # (L, 16) codebooks the decode form holds in shared memory

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("lut4_matmul")
        lib.ao_lut4_wo.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.ao_lut4_wo.restype = ctypes.c_int
        lib.ao_lut4_wo_gemv.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p]
        lib.ao_lut4_wo_gemv.restype = ctypes.c_int
        if lib.ao_lut4_max_luts() != MAX_LUTS:
            raise RuntimeError("lut4_matmul.cu and its wrapper disagree on the most codebooks")
        _LIB = lib
    return _LIB


def groups_per_lut(k: int, group_size: int, n_luts: int):
    """Groups per codebook of (L, 16) codebooks over K rows (0: one shared
    codebook), or None where the row blocks do not align with the groups."""
    if n_luts == 0:
        return 0
    if k % n_luts or (k // n_luts) % group_size:
        return None
    return k // n_luts // group_size


def takes(k: int, n: int, group_size: int, n_luts: int = 0) -> bool:
    """Whether K15 takes a (K, N) magic-layout weight with group g and
    ``n_luts`` (L, 16) codebooks (0: one shared (16,) codebook): g one of
    GROUP_SIZES, K a multiple of 4g, N of 32, at most MAX_LUTS codebooks
    whose row blocks are whole groups."""
    return (group_size in GROUP_SIZES and k % (4 * group_size) == 0 and n % 32 == 0
            and n_luts <= MAX_LUTS and groups_per_lut(k, group_size, n_luts) is not None)


def _n_luts(codebook: torch.Tensor) -> int:
    return 0 if codebook.ndim == 1 else codebook.shape[0]


def check_shapes(x, word, scalers, codebook, group_size: int) -> None:
    """Raise ValueError for operands the kernel does not take; the wrapper
    applies it on every device, so the CPU refuses what the card would."""
    if x.ndim != 2 or word.ndim != 2:
        raise ValueError("lut4_wo_magic takes 2-D x (M, K) and magic words (K/8, N)")
    (m, k), (kw, n), g = x.shape, word.shape, group_size
    if k != 8 * kw or word.dtype != torch.int32:
        raise ValueError(f"K mismatch or not int32 words: x {tuple(x.shape)}, word "
                         f"{tuple(word.shape)} {word.dtype}")
    if codebook.shape[-1] != 16 or codebook.ndim not in (1, 2):
        raise ValueError(f"codebook must be (16,) or (L, 16), got {tuple(codebook.shape)}")
    if not takes(k, n, g, _n_luts(codebook)):
        raise ValueError(f"K={k}, N={n}, g={g} and {_n_luts(codebook)} codebooks: g must be one "
                         f"of {GROUP_SIZES}, K a multiple of 4g, N of 32, at most {MAX_LUTS} "
                         f"codebooks over whole groups")
    if tuple(scalers.shape) != (k // g, n):
        raise ValueError(f"scalers must be ({k // g}, {n}), got {tuple(scalers.shape)}")


def lut4_wo_magic_plain(x, word, scalers, codebook, group_size: int) -> torch.Tensor:
    """K15 in plain PyTorch, f32 (M, N): per group G, acc += s[G] *
    (x_G @ lut[u_G]) in f32 (x in bf16, the bf16-rounded codebook; every
    product exact)."""
    g = group_size
    u = unpack_int4_magic(word, g).to(torch.int64)
    k, n = u.shape
    cb = codebook.to(torch.bfloat16).to(torch.float32).reshape(-1, 16)
    gpl = groups_per_lut(k, g, _n_luts(codebook))
    xf = x.to(torch.bfloat16).to(torch.float32)
    s = scalers.to(torch.float32)
    acc = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    for grp in range(k // g):
        table = cb[0 if gpl == 0 else grp // gpl]
        acc = acc + s[grp] * (xf[:, grp * g:(grp + 1) * g] @ table[u[grp * g:(grp + 1) * g]])
    return acc


def lut4_wo_magic_mirror(x, word, scalers, codebook, group_size: int) -> torch.Tensor:
    """K15's prefill arithmetic through ``int4_matmul.magic_fold_mirror``:
    each nibble's bf16 codebook entry, then per group acc += s * tmp in
    f32."""
    g = group_size
    k = x.shape[1]
    cb = codebook.to(torch.bfloat16).to(torch.float32).reshape(-1, 16)
    gpl = groups_per_lut(k, g, _n_luts(codebook))
    s = scalers.to(torch.float32)
    return k1.magic_fold_mirror(x, word, g, lambda u, grp: cb[0 if gpl == 0 else grp // gpl][u],
                                lambda acc, tmp, grp: acc + s[grp] * tmp)


def lut4_wo_magic_gemv_mirror(x, word, scalers, codebook, group_size: int, plan) -> torch.Tensor:
    """K15's decode arithmetic through ``int4_matmul.gemv_mirror``: each
    nibble's bf16 codebook entry, then per group acc += s * tmp in f32."""
    g = group_size
    k = x.shape[1]
    cb = codebook.to(torch.bfloat16).to(torch.float32).reshape(-1, 16)
    gpl = groups_per_lut(k, g, _n_luts(codebook))
    s = scalers.to(torch.float32)
    return k1.gemv_mirror(x, word, g, plan, lambda u, grp: cb[0 if gpl == 0 else grp // gpl][u],
                          lambda acc, tmp, grp: acc + s[grp] * tmp)


def launch_tiles(m: int, k: int, n: int, group_size: int, sm_count: int):
    """What a K15 prefill launch (M > 16) at (M, K, N) runs: (bm, bn,
    splits, per), K1's tiles (``int4_matmul.pick_tiles_magic``) and ``per``
    stages of 64 K a split. The decode form (M <= 16) runs
    ``int4_matmul.gemv_plan``'s plan."""
    if m <= k1.GEMV_MAX_M:
        raise ValueError(f"lut4_wo_magic: M={m} runs the decode form (gemv_plan), not tiles")
    bm, bn, splits = k1.pick_tiles_magic(m, k, n, sm_count)
    return bm, bn, splits, k1.magic_stages_per_split(k, splits)


def gemv_tables(n_luts: int):
    """(pairs, bytes) of the decode form's codebooks in shared memory: one
    codebook (NF4's shared one) as a table of 256 bf16 pairs, 1 KB (a word's
    four planes from four loads), held 16 times over (its lanes' loads
    spread over the banks); (L, 16) codebooks each as its 16 entries, 32
    bytes."""
    luts = max(n_luts, 1)
    return (True, 16 * 1024) if luts == 1 else (False, 32 * luts)


def _launch(x, word, scalers, lut, group_size: int, plan=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors. M <= 16: the decode form, one
    kernel, ``plan`` (wn, wk, cluster, stages) overriding
    ``int4_matmul.gemv_plan``; above, the prefill's tiles."""
    dev = x.device
    m, k = x.shape
    n = word.shape[1]
    g = group_size
    n_luts = _n_luts(lut)
    gpl = groups_per_lut(k, g, n_luts)
    _check_operands("lut4_wo_magic", dev, (
        ("x", x, torch.bfloat16, (m, k)),
        ("word", word, torch.int32, (k // 8, n)),
        ("scalers", scalers, torch.float32, (k // g, n)),
        ("codebook", lut, torch.bfloat16, tuple(lut.shape))))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if m <= k1.GEMV_MAX_M:
            pairs, setup = gemv_tables(n_luts)
            checked = k1.checked_gemv_plan(m, k, n, g, _sm_count(dev), plan and tuple(plan),
                                           setup)
            if checked is None:
                raise ValueError(f"lut4_wo_magic: plan {plan} is not the decode form's at "
                                 f"{(m, k, n, g)}")
            wn, wk, cluster, stages = checked
            err = _lib().ao_lut4_wo_gemv(
                x.data_ptr(), word.data_ptr(), scalers.data_ptr(), lut.data_ptr(),
                out.data_ptr(), m, k, n, g, max(n_luts, 1), gpl, int(pairs), wn, wk, cluster,
                stages, stream)
        else:
            bm, bn, splits, per = launch_tiles(m, k, n, g, _sm_count(dev))
            ws = (torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1
                  else None)
            err = _lib().ao_lut4_wo(
                x.data_ptr(), word.data_ptr(), scalers.data_ptr(), lut.data_ptr(),
                out.data_ptr(), None if ws is None else ws.data_ptr(), m, k, n, g, gpl, bm, bn,
                splits, per, stream)
    if err < 0:
        raise RuntimeError(f"lut4_wo_magic: libcuda refused a tensor map (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"lut4_wo_magic kernel launch failed: CUDA error {err}")
    lut4_wo_magic.launches += 1
    return out


def lut4_wo_magic(x, word, scalers, codebook, group_size: int) -> torch.Tensor:
    """x (M, K); word int32 (K/8, N) magic layout over the code nibbles;
    scalers (K/g, N); codebook (16,) or (L, 16), on x's device (a bf16
    codebook is read as it is). Returns (M, N) bf16: the kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    check_shapes(x, word, scalers, codebook, group_size)
    x = x.to(torch.bfloat16)
    if x.device.type == "cpu":
        return lut4_wo_magic_plain(x, word, scalers, codebook, group_size).to(torch.bfloat16)
    if x.device.type != "cuda":
        raise ValueError(f"lut4_wo_magic runs on cuda or cpu tensors, not {x.device}")
    return _launch(x.contiguous(), word, scalers.to(torch.float32).contiguous(),
                   codebook.to(torch.bfloat16).contiguous(), group_size)


lut4_wo_magic.launches = 0  # kernel launches (not plain-version calls)


def traffic(m: int, k: int, n: int, group_size: int):
    """(bytes, flops) the function needs: x bf16 and the codes (0.5 B per
    weight) read once, the f32 scalers read once, the bf16 output written
    once (the 16-entry codebook is negligible)."""
    return m * k * 2 + k * n // 2 + k // group_size * n * 4 + m * n * 2, 2 * m * k * n
