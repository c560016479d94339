"""K14: the fp4 (e2m1) weight-only matmul of ``ao_tpu/ops/pallas/fp4_matmul.py``,
on Hopper.

* ``mxfp4_wo_matmul``: x (M, K) @ MXFP4 weight — fp4-magic codes (K/8, N)
  int32 and e8m0 bytes (K/32, N) uint8 (``mxfp4_wo_matmul_pallas``, kernel
  ``_mx_kernel``);
* ``nvfp4_wo_matmul``: x (M, K) @ NVFP4 weight — fp4-magic codes and e4m3
  scale pair-words (K/32, N) int32, then the f32 per-tensor scale on the
  bf16 output (``nvfp4_wo_matmul_pallas``, kernel ``_nv_kernel``).

One CUDA source, ``ao_tpu_torch/csrc/fp4_matmul.cu``, whose header says what
bounds it on the H100 and how the design meets it: its decode form (M <=
16) on K1's and K15's weight-stream mainloop (``csrc/gemv_mainloop.cuh``,
one kernel a call, the plan ``gemv_plan``, the summation order
``fp4_wo_gemv_mirror``), its prefill form on the shared wgmma mainloop of
``csrc/mixed_gemm.cuh`` (``pick_tiles`` chooses its tiles and K split).
Each wrapper runs the
kernel on a CUDA tensor and its plain PyTorch version (``*_plain``) on a CPU
tensor, and raises ValueError on either for a shape the kernel does not
take (``takes``). The plain versions decode the codes and scales to the
values ``dequantize()`` uses, run one bf16 ``torch.matmul`` and, for NVFP4,
multiply its bf16 output by the per-tensor scale in f32, as the reference
path does. ``fp4_decode_mirror`` (the prefill's) and ``fp4_gemv_decode_mirror``
(the decode form's) repeat the kernel's integer decodes of codes and scale
bytes in PyTorch, so a CPU test can hold them to the plain decode.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ao_tpu_torch.ops.hopper import build
from ao_tpu_torch.ops.hopper import int4_matmul as k1
from ao_tpu_torch.ops.hopper.int4_matmul import _check_operands, _sm_count
from ao_tpu_torch.quantization.qarrays.fp4 import (
    decode_fp4_e2m1, unpack_fp4_magic, unpack_nvfp4_scale_pairs,
)
from ao_tpu_torch.quantization.qarrays.mx import e8m0_decode

K_UNIT = 256  # K per unit of the kernel: four planes of 64 rows, a decode slab
N_BLOCK = 128  # columns per block
MX, NV = 0, 1  # the kernel's two kinds
GEMV_MAX_M = 16  # the decode form's rows; above them the mainloop's tiles
K_STAGE = 64  # K values per stage of the mainloop (8 word rows)

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("fp4_matmul")
        lib.ao_fp4_wo.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.ao_fp4_wo.restype = ctypes.c_int
        lib.ao_fp4_wo_gemv.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.ao_fp4_wo_gemv.restype = ctypes.c_int
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
    return _as_bf16(bits) * _as_bf16(_scale_bits(scale_bytes, kind))


def fp4_gemv_decode_mirror(codes: torch.Tensor, scale_bytes: torch.Tensor,
                           kind: int) -> torch.Tensor:
    """The decode form's decode (csrc/fp4_matmul.cu ``fp4_planes`` and
    ``mx_scale2_byte`` / ``nv_scale_pair``) of stored codes times their block
    scale bytes, as ``fp4_decode_mirror``: each value's low and high byte
    looked up by its em field in the prmt tables, its sign on the high
    byte's top bit; the e8m0 byte e as max(e << 7, 0x0040)."""
    t = codes.to(torch.int64)
    em = t & 7
    tables = ((0xC0800000, 0xC0804000),  # the prmt tables (kL0, kL1), (kH0, kH1)
              (0x3F3F003F, 0x40404040) if kind == MX else (0x7B7B007B, 0x7C7C7C7C))
    lo, hi = (torch.tensor([(w >> (8 * i)) & 0xFF for w in pair for i in range(4)])[em]
              for pair in tables)
    bits = lo | ((hi | ((t & 8) << 4)) << 8)
    b = scale_bytes.to(torch.int32)
    sbits = torch.maximum(b << 7, torch.tensor(0x0040)) if kind == MX else _scale_bits(b, kind)
    return _as_bf16(bits) * _as_bf16(sbits)


def _scale_bits(scale_bytes: torch.Tensor, kind: int) -> torch.Tensor:
    """The bf16 bits of each block scale byte as the kernel decodes it:
    ``mx_scale2``'s e8m0 (byte 0 the subnormal 2^-127) or one half of
    ``nv_scale_pair``'s e4m3 (times 2^-120, NaN bytes NaN)."""
    b = scale_bytes.to(torch.int32)
    if kind == MX:
        return torch.where(b == 0, 0x0040, b << 7)
    m = b & 0x7F
    nan = torch.where(((m + 1) & 0x80) != 0, 0x7FC0, 0)  # prmt's sign replicate
    return (m << 4) | ((b & 0x80) << 8) | nan


def _as_bf16(u: torch.Tensor) -> torch.Tensor:
    """bf16 values of 16-bit patterns held in int32."""
    return (u - ((u & 0x8000) << 1)).to(torch.int16).view(torch.bfloat16)


def ctas_per_sm(bm: int) -> int:
    """CTAs of the mainloop an SM holds at once: one at BM = 256 (128
    accumulators a thread), two below (128 registers a thread)."""
    return 1 if bm == 256 else 2


def gemv_setup(kind: int) -> int:
    """The decode form's shared tables (``Fp4Gemv::setup_bytes``): the code
    tables, and a decoded scale row for each of up to 8 warps."""
    return 16 + 8 * 512


def stage_q(kind: int) -> int:
    """The bytes a column of a decode stage's block scales: four planes' two
    rows of e8m0 bytes (MX) or pair-words (NV) (``Fp4Gemv::kStageQ``)."""
    return 8 * (1 if kind == MX else 4)


def gemv_plan_ok(m: int, k: int, n: int, kind: int, plan) -> bool:
    """Whether the decode form takes ``plan`` (wn, wk, cluster, stages) at
    (M, K, N): K1's check at g = K/4 (one super-group, slabs of 256 K), with
    the stages' block scales in its shared memory."""
    return takes(k, n) and k1.gemv_plan_ok(m, k, n, k // 4, plan, gemv_setup(kind),
                                           stage_q(kind))


def gemv_plan(m: int, k: int, n: int, sm_count: int):
    """(wn, wk, cluster, stages) of a decode launch (M <= 16): K1's
    ``gemv_plan`` at g = K/4 (its K/256 slabs are K1's at g = 128), except
    where CTAs of two warps along N and two along K (each warp one 32-row
    scale block of a slab) fit one an SM in a cluster of 2-8 that leaves
    each at most 8 slabs: then those, one CTA an SM where K1's plan puts two
    on some SMs. Measured on the H100 (``kernel_tiles.py time K14``,
    PERF.md): Llama-3-8B at M = 8 takes (2, 2, 2, 4) / (2, 2, 8, 3) / (4, 1,
    2, 4) / (4, 1, 7, 4) / (4, 1, 1, 2) at wq-wo / wk-wv / w1-w3 / w2 /
    lm_head, the fastest plan or within 3 % of it for both kinds (K1's
    own: 6-7 % slower at wq-wo)."""
    wn, wk, cluster, stages = k1.gemv_plan(m, k, n, k // 4, sm_count)
    if n // (32 * wn) >= 2 * sm_count:  # the lm_head: one CTA a tile
        return wn, wk, cluster, stages
    slabs, tiles = k // K_UNIT, n // 64
    fits = [c for c in range(2, k1.GEMV_MAX_CLUSTER + 1)
            if tiles * c <= sm_count and slabs % c == 0 and slabs // c <= 8]
    if n % 64 == 0 and fits:
        c = max(fits)
        return 2, 2, c, max(2, min(4, slabs // c + 1))
    return wn, wk, cluster, stages


@functools.lru_cache(maxsize=None)
def checked_gemv_plan(m: int, k: int, n: int, kind: int, sm_count: int, plan=None):
    """A decode launch's plan: ``plan`` (a tuple) or ``gemv_plan``'s, or None
    where ``gemv_plan_ok`` refuses it; cached, since every linear of each
    decode step asks for it."""
    plan = plan or gemv_plan(m, k, n, sm_count)
    return plan if gemv_plan_ok(m, k, n, kind, plan) else None


def gemv_candidates(m: int, k: int, n: int, kind: int, stages=(2, 3, 4, 6)):
    """Every plan the decode form takes at (M, K, N) with ``stages`` ring
    stages (``int4_matmul.gemv_candidates`` at g = K/4): what ``kernel_tiles.py
    time K14`` sweeps and the card's tests run."""
    return k1.gemv_candidates(m, k, n, k // 4, gemv_setup(kind), stages, stage_q(kind))


GEMV_CHAINS = 2  # the mainloop's kChains: plane j's mma into chain j % 2


def gemv_steps(wk: int, w: int) -> range:
    """The k16 steps of a slab (0..3) warp w of ``wk`` along K takes: a run
    of 4 / wk, so both steps of a 32-row scale block fall to one warp where
    wk <= 2 (the mainloop's order for an Op with block scales)."""
    run = 4 // wk
    return range(w * run, (w + 1) * run)


def fp4_wo_gemv_mirror(x, word, scale, pts, kind: int, plan) -> torch.Tensor:
    """The decode form's summation order in PyTorch, bf16 (M, N): cluster
    rank r of ``plan`` walks slabs of 256 K [r per, (r + 1) per); warp w
    along K of its CTA takes the slab's k16 steps ``gemv_steps(wk, w)``
    (plane rows 64 s + 16 q .. + 15), each step's plane j added to f32 chain
    j % 2 (no fold); a warp's chains in order, then the warps' sums, then
    the ranks'; then the epilogue, NVFP4's bf16 output times ``pts`` in f32.
    The weights are the plain version's exact bf16 values."""
    _, wk, cluster, _ = plan
    m, k = x.shape
    if kind == MX:
        w = _weight(word, e8m0_decode(scale), 32)
    else:
        w = _weight(word, unpack_nvfp4_scale_pairs(scale).to(torch.float32), 16)
    wf, xf = w.to(torch.float32), x.to(torch.bfloat16).to(torch.float32)
    slabs, per, kq = k // K_UNIT, k1.gemv_per(k, k // 4, cluster), k // 4
    out = torch.zeros((m, word.shape[1]), dtype=torch.float32)
    for r in range(cluster):
        cta = torch.zeros_like(out)
        for wi in range(wk):
            chains = [torch.zeros_like(out) for _ in range(GEMV_CHAINS)]
            for s in range(r * per, min((r + 1) * per, slabs)):
                for q in gemv_steps(wk, wi):
                    for j in range(4):
                        k0 = j * kq + 64 * s + 16 * q
                        chains[j % GEMV_CHAINS] += xf[:, k0:k0 + 16] @ wf[k0:k0 + 16]
            acc = torch.zeros_like(out)
            for c in chains:
                acc = acc + c
            cta = cta + acc
        out = out + cta
    y = out.to(torch.bfloat16)
    if kind == NV and pts is not None:
        y = (y.to(torch.float32) * pts.to(torch.float32)).to(torch.bfloat16)
    return y


def pick_tiles(m: int, k: int, n: int, sm_count: int):
    """(bm, bn, splits, per): the prefill's tiles and K split for (M, K, N),
    M > 16 (M <= 16 runs the decode form, ``gemv_plan``). The wgmma
    mainloop: BM = 64 rows of x up to M = 64, 128
    up to 512, 256 above (measured fastest at M = 1024 on the H100), by BN =
    128 weight columns, and splits K by whole stages of 64 (``per`` stages a
    split) until the CTAs fill three quarters of the card's CTA slots (a
    split costs a second pass), as far as K's stages allow."""
    if m <= GEMV_MAX_M:
        raise ValueError(f"fp4 matmul: M={m} runs the decode form (gemv_plan), not tiles")
    bm, bn = (64 if m <= 64 else 128 if m <= 512 else 256), 128
    stages = k // K_STAGE
    ctas = -(-m // bm) * (n // bn)
    want = -(-3 * sm_count * ctas_per_sm(bm) // 4)
    need = -(-want // ctas)  # splits that fill the card
    per = -(-stages // need)  # balanced splits, unless rounding leaves too few
    if -(-stages // per) < need:
        per = max(1, stages // need)
    return bm, bn, -(-stages // per), per


def _launch(kind: int, x, word, scale, pts, name: str, plan=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors. M <= 16: the decode form, one
    kernel, ``plan`` (wn, wk, cluster, stages) overriding ``gemv_plan``;
    above, the prefill's tiles from ``pick_tiles``."""
    dev = x.device
    m, k = x.shape
    n = word.shape[1]
    operands = [("x", x, torch.bfloat16, (m, k)), ("word", word, torch.int32, (k // 8, n)),
                ("scale", scale, torch.uint8 if kind == MX else torch.int32, (k // 32, n))]
    if pts is not None:
        operands.append(("per_tensor_scale", pts, torch.float32, ()))
    _check_operands(name, dev, operands)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    pts_ptr = None if pts is None else pts.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if m <= GEMV_MAX_M:
            checked = checked_gemv_plan(m, k, n, kind, _sm_count(dev), plan and tuple(plan))
            if checked is None:
                raise ValueError(f"{name}: plan {plan} is not the decode form's at {(m, k, n)}")
            wn, wk, cluster, stages = checked
            err = _lib().ao_fp4_wo_gemv(kind, x.data_ptr(), word.data_ptr(), scale.data_ptr(),
                                        pts_ptr, out.data_ptr(), m, k, n, wn, wk, cluster, stages,
                                        stream)
        else:
            bm, bn, splits, per = pick_tiles(m, k, n, _sm_count(dev))
            ws = (torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1
                  else None)
            err = _lib().ao_fp4_wo(kind, x.data_ptr(), word.data_ptr(), scale.data_ptr(),
                                   pts_ptr, out.data_ptr(), None if ws is None else ws.data_ptr(),
                                   m, k, n, bm, bn, splits, per, stream)
    if err < 0:
        raise RuntimeError(f"{name}: libcuda refused a tensor map (CUresult {-err})")
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
