"""K14: the fp4 (e2m1) weight-only matmul of ``ao_tpu/ops/pallas/fp4_matmul.py``,
on Hopper.

* ``mxfp4_wo_matmul``: x (M, K) @ MXFP4 weight — fp4-magic codes (K/8, N)
  int32 and e8m0 bytes (K/32, N) uint8 (``mxfp4_wo_matmul_pallas``, kernel
  ``_mx_kernel``);
* ``nvfp4_wo_matmul``: x (M, K) @ NVFP4 weight — fp4-magic codes and e4m3
  scale pair-words (K/32, N) int32, then the f32 per-tensor scale on the
  bf16 output (``nvfp4_wo_matmul_pallas``, kernel ``_nv_kernel``).

One CUDA source, ``ao_tpu_torch/csrc/fp4_matmul.cu`` (its prefill form on the
shared wgmma mainloop of ``csrc/mixed_gemm.cuh``), whose header says what
bounds it on the H100 and how the design meets it; ``pick_tiles`` chooses
its tiles and K split. Each wrapper runs the
kernel on a CUDA tensor and its plain PyTorch version (``*_plain``) on a CPU
tensor, and raises ValueError on either for a shape the kernel does not
take (``takes``). The plain versions decode the codes and scales to the
values ``dequantize()`` uses, run one bf16 ``torch.matmul`` and, for NVFP4,
multiply its bf16 output by the per-tensor scale in f32, as the reference
path does. ``fp4_decode_mirror`` repeats the kernel's integer decode of codes
and scale bytes in PyTorch, so a CPU test can hold it to the plain decode.
"""

from __future__ import annotations

import ctypes

import torch

from ao_tpu_torch.ops.hopper import build
from ao_tpu_torch.ops.hopper.int4_matmul import _check_operands, _sm_count, _split_units
from ao_tpu_torch.quantization.qarrays.fp4 import (
    decode_fp4_e2m1, unpack_fp4_magic, unpack_nvfp4_scale_pairs,
)
from ao_tpu_torch.quantization.qarrays.mx import e8m0_decode

K_UNIT = 256  # K per unit of the kernel: four planes of 64 rows
N_BLOCK = 128  # columns per block
MX, NV = 0, 1  # the kernel's two kinds
GEMV_MAX_M = 16  # the decode kernel's rows; above them the mainloop's tiles
K_STAGE = 64  # K values per stage of the mainloop (8 word rows)

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("fp4_matmul")
        lib.ao_fp4_wo.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.ao_fp4_wo.restype = ctypes.c_int
        if (lib.ao_fp4_k_unit(), lib.ao_fp4_n_block()) != (K_UNIT, N_BLOCK):
            raise RuntimeError("fp4_matmul.cu and its wrapper disagree on the K unit or N block")
        _LIB = lib
    return _LIB


def takes(k: int, n: int) -> bool:
    """Whether K14 takes a (K, N) fp4-magic weight: K a multiple of 256 (four
    planes of 64-row steps) and N of 128."""
    return k % K_UNIT == 0 and n % N_BLOCK == 0


def check_shapes(x: torch.Tensor, word: torch.Tensor, scale: torch.Tensor, scale_dtype) -> None:
    """Raise ValueError for operands the kernel does not take; the wrapper
    applies it on every device, so the CPU refuses what the card would."""
    if x.ndim != 2 or word.ndim != 2:
        raise ValueError("fp4 matmul takes 2-D x (M, K) and fp4-magic words (K/8, N)")
    (m, k), (kw, n) = x.shape, word.shape
    if k != 8 * kw or word.dtype != torch.int32:
        raise ValueError(f"K mismatch or not int32 words: x {tuple(x.shape)}, word "
                         f"{tuple(word.shape)} {word.dtype}")
    if not takes(k, n):
        raise ValueError(f"K={k} must be a multiple of {K_UNIT} and N={n} of {N_BLOCK}")
    if scale.dtype != scale_dtype or tuple(scale.shape) != (k // 32, n):
        raise ValueError(f"the scales must be {scale_dtype} ({k // 32}, {n}), got "
                         f"{scale.dtype} {tuple(scale.shape)}")


def _weight(word: torch.Tensor, block_scale: torch.Tensor, block: int) -> torch.Tensor:
    """The decoded codes times their block scales, in bf16 (exact: an e2m1
    value has 2 significant bits, the scales at most 4)."""
    v = decode_fp4_e2m1(unpack_fp4_magic(word), torch.float32)
    return (v * block_scale.repeat_interleave(block, dim=0)).to(torch.bfloat16)


def mxfp4_wo_matmul_plain(x, word, scale_u8) -> torch.Tensor:
    """K14 (MX) in plain PyTorch, bf16 (M, N): x in bf16 @ the exactly
    decoded weight, one bf16 matmul."""
    w = _weight(word, e8m0_decode(scale_u8), 32)
    return torch.matmul(x.to(torch.bfloat16), w)


def nvfp4_wo_matmul_plain(x, word, scale_words, per_tensor_scale) -> torch.Tensor:
    """K14 (NV) in plain PyTorch, bf16 (M, N): the bf16 matmul over the
    weight scaled by its e4m3 block scales, then times the per-tensor scale
    in f32."""
    s = unpack_nvfp4_scale_pairs(scale_words).to(torch.float32)
    y = torch.matmul(x.to(torch.bfloat16), _weight(word, s, 16))
    if per_tensor_scale is None:
        return y
    return (y.to(torch.float32) * per_tensor_scale.to(torch.float32)).to(torch.bfloat16)


def fp4_decode_mirror(codes: torch.Tensor, scale_bytes: torch.Tensor, kind: int) -> torch.Tensor:
    """The kernel's decode of stored fp4-magic codes (em field 0 and 1
    swapped, 0..15) times their block scale bytes (e8m0 for MX, e4m3fn for
    NV), broadcast against each other, in bf16: the integer steps of
    ``fp4_pair`` and ``mx_scale2`` / ``nv_scale_pair`` (csrc/fp4_matmul.cu)
    on one half of a bf16x2, then the bf16 product mul.rn.bf16x2 computes
    (exact, so any correct rounding gives it)."""
    t = codes.to(torch.int32)
    z = t & 7
    v = z * 64 + (0x3F00 if kind == MX else 0x7B00)
    keep = torch.where((((z ^ 1) + 0x7F) & 0x80) != 0, 0xFFFF, 0)  # prmt's sign replicate
    bits = (v & keep) | ((t << 12) & 0x8000)
    b = scale_bytes.to(torch.int32)
    if kind == MX:
        sbits = torch.where(b == 0, 0x0040, b << 7)
    else:
        m = b & 0x7F
        nan = torch.where(((m + 1) & 0x80) != 0, 0x7FC0, 0)  # prmt's sign replicate
        sbits = (m << 4) | ((b & 0x80) << 8) | nan

    def as_bf16(u):
        return (u - ((u & 0x8000) << 1)).to(torch.int16).view(torch.bfloat16)

    return as_bf16(bits) * as_bf16(sbits)


def ctas_per_sm(bm: int) -> int:
    """CTAs of the mainloop an SM holds at once: one at BM = 256 (128
    accumulators a thread), two below (128 registers a thread)."""
    return 1 if bm == 256 else 2


def pick_tiles(m: int, k: int, n: int, sm_count: int):
    """(bm, bn, splits, per): the tiles and K split for (M, K, N). M <= 16
    takes the decode kernel (bm 16, bn 128), whose split of K by whole units
    of 256 (``per`` units a split) aims at about four 4-warp blocks per SM.
    Larger M takes the wgmma mainloop: BM = 64 rows of x up to M = 64, 128
    up to 512, 256 above (measured fastest at M = 1024 on the H100), by BN =
    128 weight columns, and splits K by whole stages of 64 (``per`` stages a
    split) until the CTAs fill three quarters of the card's CTA slots (a
    split costs a second pass), as far as K's stages allow."""
    if m <= GEMV_MAX_M:
        splits, ups = _split_units(k // K_UNIT, n // N_BLOCK, sm_count)
        return GEMV_MAX_M, N_BLOCK, splits, ups
    bm, bn = (64 if m <= 64 else 128 if m <= 512 else 256), 128
    stages = k // K_STAGE
    ctas = -(-m // bm) * (n // bn)
    want = -(-3 * sm_count * ctas_per_sm(bm) // 4)
    need = -(-want // ctas)  # splits that fill the card
    per = -(-stages // need)  # balanced splits, unless rounding leaves too few
    if -(-stages // per) < need:
        per = max(1, stages // need)
    return bm, bn, -(-stages // per), per


def _launch(kind: int, x, word, scale, pts, name: str) -> torch.Tensor:
    dev = x.device
    m, k = x.shape
    n = word.shape[1]
    operands = [("x", x, torch.bfloat16, (m, k)), ("word", word, torch.int32, (k // 8, n)),
                ("scale", scale, torch.uint8 if kind == MX else torch.int32, (k // 32, n))]
    if pts is not None:
        operands.append(("per_tensor_scale", pts, torch.float32, ()))
    _check_operands(name, dev, operands)
    bm, bn, splits, per = pick_tiles(m, k, n, _sm_count(dev))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_fp4_wo(kind, x.data_ptr(), word.data_ptr(), scale.data_ptr(),
                               None if pts is None else pts.data_ptr(), out.data_ptr(),
                               None if ws is None else ws.data_ptr(), m, k, n, bm, bn, splits,
                               per, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _x_operand(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {x.device}")
    return x.to(torch.bfloat16)


def mxfp4_wo_matmul(x, word, scale_u8) -> torch.Tensor:
    """x (M, K); word int32 (K/8, N) fp4-magic; scale_u8 (K/32, N) e8m0
    bytes. Returns (M, N) bf16: the kernel on a CUDA tensor, its plain
    version on a CPU tensor."""
    check_shapes(x, word, scale_u8, torch.uint8)
    x = _x_operand(x, "mxfp4_wo_matmul")
    if x.device.type == "cpu":
        return mxfp4_wo_matmul_plain(x, word, scale_u8)
    out = _launch(MX, x.contiguous(), word, scale_u8, None, "mxfp4_wo_matmul")
    mxfp4_wo_matmul.launches += 1
    return out


mxfp4_wo_matmul.launches = 0  # kernel launches (not plain-version calls)


def nvfp4_wo_matmul(x, word, scale_words, per_tensor_scale=None) -> torch.Tensor:
    """x (M, K); word int32 (K/8, N) fp4-magic; scale_words int32 (K/32, N)
    e4m3 pair-words; per_tensor_scale an f32 scalar or None. Returns (M, N)
    bf16: the kernel on a CUDA tensor, its plain version on a CPU tensor."""
    check_shapes(x, word, scale_words, torch.int32)
    x = _x_operand(x, "nvfp4_wo_matmul")
    if x.device.type == "cpu":
        return nvfp4_wo_matmul_plain(x, word, scale_words, per_tensor_scale)
    pts = None if per_tensor_scale is None else per_tensor_scale.to(torch.float32).reshape(())
    out = _launch(NV, x.contiguous(), word, scale_words, pts, "nvfp4_wo_matmul")
    nvfp4_wo_matmul.launches += 1
    return out


nvfp4_wo_matmul.launches = 0  # kernel launches (not plain-version calls)


def traffic(m: int, k: int, n: int, kind: int):
    """(bytes, flops) the function needs: x bf16 and the codes (0.5 B per
    weight) read once, the scales as stored (MX one byte per 32 weights, NV
    a 4-byte pair-word per 32), the bf16 output written once."""
    scale_bytes = k // 32 * n * (1 if kind == MX else 4)
    return m * k * 2 + k * n // 2 + scale_bytes + m * n * 2, 2 * m * k * n
