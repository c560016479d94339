"""K12: producer-side per-token int8 quantize kernels, on Hopper.

Counterparts of ``ao_tpu/ops/pallas/fused_act.py``:

* K12s ``silu_mul_quant``: gated-MLP activation (``silu_mul_quant_pallas``,
  kernel ``_silu_mul_quant_kernel``);
* K12g ``gelu_quant``: tanh-GELU (``gelu_quant_pallas``, kernel
  ``_gelu_quant_kernel``); 4 warps a row up to GELU_WARP_MAX_D values,
  one block a row above (``gelu_form``);
* K12n ``norm_modulate_quant``: LayerNorm with no affine, then
  y * (1 + smod) + shift per batch row (``norm_modulate_quant_pallas``,
  kernel ``_ln_mod_quant_kernel``); one warp a row up to NORM_WARP_MAX_D
  values, one block a row above (``norm_form``).

The CUDA source is ``ao_tpu_torch/csrc/fused_act.cu``; its notes say what
bounds the kernels on the H100 and how the design meets it. Each wrapper
runs its kernel on CUDA tensors and its plain PyTorch version (``*_plain``)
on CPU tensors, and raises ValueError on either for a shape the kernel does
not take; ``takes`` says which shapes those are.
"""

from __future__ import annotations

import ctypes

import torch

from ao_tpu_torch.ops.act_quant import _row_quant
from ao_tpu_torch.ops.hopper import build

ACTS = ("silu", "gelu")
MAX_D = 57344  # the kernel keeps a row's f32 gate in 4*D bytes of shared memory
# K12n's rows up to this width take one warp a row (8 chunks of 8 values a
# lane in registers), wider rows one block a row (the row in shared memory)
NORM_WARP_MAX_D = 2048
NORM_FORMS = ("warp", "block")
# K12g's rows up to this width take 4 warps a row (at most 3 chunks of 8
# values a lane in registers), wider rows one block a row
GELU_WARP_MAX_D = 3072
GELU_FORMS = ("warps", "block")

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("fused_act")
        lib.ao_silu_mul_quant.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.ao_silu_mul_quant.restype = ctypes.c_int
        lib.ao_gelu_quant.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.ao_gelu_quant.restype = ctypes.c_int
        lib.ao_norm_modulate_quant.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [
            ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.ao_norm_modulate_quant.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_shapes(a: torch.Tensor, b: torch.Tensor, act: str) -> None:
    """Raise ValueError for inputs the kernel does not take: a and b of one
    shape (B, T, D), D % 128 == 0 (the reference's rule) and D <= MAX_D."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if a.ndim != 3 or tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"silu_mul_quant takes a and b of one shape (B, T, D), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not takes(tuple(a.shape)):
        raise ValueError(f"D={a.shape[-1]} must be a multiple of 128 and at most {MAX_D}")


def silu_mul_quant_plain(a, b, act: str = "silu"):
    """The kernel's function in plain PyTorch: y = act(a) * b in f32, then
    the per-row int8 quantize of ``ops/act_quant._row_quant``. Returns
    (q int8, scale f32 (..., 1))."""
    af = a.to(torch.float32)
    if act == "silu":
        g = af * torch.sigmoid(af)
    else:
        g = torch.nn.functional.gelu(af, approximate="tanh")
    return _row_quant(g * b.to(torch.float32))


def _launch(a, b, act: str):
    dev = a.device
    if a.dtype not in (torch.bfloat16, torch.float32) or b.dtype != a.dtype:
        raise ValueError(f"silu_mul_quant kernel takes bf16 or f32 a and b of one dtype, "
                         f"got {a.dtype} and {b.dtype}")
    for name, t in (("a", a), ("b", b)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"silu_mul_quant: {name} must be contiguous, 16-byte aligned "
                             f"and on {dev}")
    bb, t, d = a.shape
    q = torch.empty((bb, t, d), dtype=torch.int8, device=dev)
    scale = torch.empty((bb, t, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_silu_mul_quant(
            a.data_ptr(), b.data_ptr(), q.data_ptr(), scale.data_ptr(), bb * t, d,
            ACTS.index(act), int(a.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"silu_mul_quant kernel launch failed: CUDA error {err}")
    silu_mul_quant.launches += 1
    return q, scale


def silu_mul_quant(a, b, act: str = "silu"):
    """Gated-MLP product (silu(a)*b SwiGLU, or tanh-gelu(a)*b GeGLU with
    ``act="gelu"``) + per-token int8 quantize. a, b (B, T, D). Returns
    (q int8 (B, T, D), scale f32 (B, T, 1)): the kernel on CUDA tensors,
    its plain version on CPU tensors."""
    check_shapes(a, b, act)
    if a.device.type == "cpu":
        return silu_mul_quant_plain(a, b, act)
    if a.device.type != "cuda":
        raise ValueError(f"silu_mul_quant runs on cuda or cpu tensors, not {a.device}")
    return _launch(a, b, act)


silu_mul_quant.launches = 0  # kernel launches (not plain-version calls)


def traffic(shape):
    """(bytes, operations) the function needs on bf16 inputs: a and b read
    once, q (int8) and one f32 scale per row written once; about 8 f32
    operations per value (gate, product, |y|, max, division, round, clip)."""
    bb, t, d = shape
    rows = bb * t
    return rows * d * 5 + rows * 4, 8 * rows * d


# ---------------------------------------------------------------------------
# K12g and K12n
# ---------------------------------------------------------------------------

_DTYPES = (torch.bfloat16, torch.float32)


def takes(shape) -> bool:
    """Whether K12s, K12g and K12n take an input of ``shape``: (B, T, D)
    with D % 128 == 0 (the reference's rule) and D <= MAX_D (the row in
    shared memory). Their routes (``ops/act_quant.py``) ask it before the
    call and take the plain version otherwise, as the reference falls back
    to its XLA form."""
    return len(shape) == 3 and shape[-1] % 128 == 0 and shape[-1] <= MAX_D


def _check_input(name: str, x: torch.Tensor) -> None:
    if not takes(tuple(x.shape)):
        raise ValueError(f"{name} takes (B, T, D) with D a multiple of 128 and at most {MAX_D}, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name} takes bf16 or f32, got {x.dtype}")


def gelu_quant_plain(y):
    """K12g's function in plain PyTorch: tanh-GELU in f32, then the per-row
    int8 quantize. Returns (q int8, scale f32 (..., 1))."""
    return _row_quant(torch.nn.functional.gelu(y.to(torch.float32), approximate="tanh"))


def gelu_form(d: int) -> str:
    """K12g's kernel for rows of ``d`` values (D % 128 == 0): "warps", up
    to GELU_WARP_MAX_D; "block", one block of 256 threads a row, above."""
    return "warps" if d <= GELU_WARP_MAX_D else "block"


def _launch_gelu(y, form=None):
    """One launch of K12g in ``form`` (by default ``gelu_form``'s), checked
    before anything runs: a "warps" launch above GELU_WARP_MAX_D raises
    ValueError on any device."""
    dev = y.device
    b, t, d = y.shape
    form = form or gelu_form(d)
    if form not in GELU_FORMS or (form == "warps" and d > GELU_WARP_MAX_D):
        raise ValueError(f"gelu_quant: no {form!r} kernel at D={d}")
    if not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError("gelu_quant: y must be contiguous and 16-byte aligned")
    q = torch.empty((b, t, d), dtype=torch.int8, device=dev)
    scale = torch.empty((b, t, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_gelu_quant(y.data_ptr(), q.data_ptr(), scale.data_ptr(), b * t, d,
                                   int(y.dtype == torch.float32), int(form == "warps"),
                                   stream)
    if err != 0:
        raise RuntimeError(f"gelu_quant kernel launch failed: CUDA error {err}")
    gelu_quant.launches += 1
    return q, scale


def gelu_quant(y):
    """tanh-GELU + per-token int8 quantize. y (B, T, D) bf16 or f32. Returns
    (q int8 (B, T, D), scale f32 (B, T, 1)): the kernel on a CUDA tensor,
    its plain version on a CPU tensor."""
    _check_input("gelu_quant", y)
    if y.device.type == "cpu":
        return gelu_quant_plain(y)
    if y.device.type != "cuda":
        raise ValueError(f"gelu_quant runs on cuda or cpu tensors, not {y.device}")
    return _launch_gelu(y)


gelu_quant.launches = 0  # kernel launches (not plain-version calls)


def norm_modulate_quant_plain(h, shift, smod, eps: float):
    """K12n's function in plain PyTorch, the reference's XLA form: LayerNorm
    (no affine) in f32, then y * (1 + smod[b]) + shift[b], then the per-row
    int8 quantize. h (B, T, D); shift, smod (B, D). Returns (q int8,
    scale f32 (B, T, 1))."""
    xf = h.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * (1.0 + smod[:, None, :].to(torch.float32)) + shift[:, None, :].to(torch.float32)
    return _row_quant(y)


def norm_form(d: int) -> str:
    """K12n's kernel for rows of ``d`` values (D % 128 == 0): "warp", one
    warp a row, up to NORM_WARP_MAX_D; "block", one block of 256 threads a
    row, above."""
    return "warp" if d <= NORM_WARP_MAX_D else "block"


def _mod_rows(name: str, m: torch.Tensor, b: int, d: int) -> int:
    """The batch stride of a (B, D) modulation with contiguous rows (0 for
    one row broadcast over the batch)."""
    if tuple(m.shape) != (b, d) or m.stride(1) != 1 or m.dtype not in _DTYPES:
        raise ValueError(f"norm_modulate_quant: {name} must be ({b}, {d}) bf16 or f32 with "
                         f"contiguous rows, got {m.dtype} {tuple(m.shape)} strides {m.stride()}")
    return m.stride(0)


def _launch_norm(h, shift, smod, eps: float, form=None):
    """One launch of K12n in ``form`` (by default ``norm_form``'s), checked
    before anything runs: a warp launch above NORM_WARP_MAX_D raises
    ValueError on any device."""
    dev = h.device
    b, t, d = h.shape
    form = form or norm_form(d)
    if form not in NORM_FORMS or (form == "warp" and d > NORM_WARP_MAX_D):
        raise ValueError(f"norm_modulate_quant: no {form!r} kernel at D={d}")
    if not h.is_contiguous() or h.data_ptr() % 16:
        raise ValueError("norm_modulate_quant: h must be contiguous and 16-byte aligned")
    if shift.dtype != smod.dtype:
        smod = smod.to(shift.dtype)
    stride = _mod_rows("shift", shift, b, d)
    # the warp kernel reads the modulation in 16-byte loads: rows that are
    # not 16-byte aligned are copied, as are two different batch strides
    if _mod_rows("smod", smod, b, d) != stride or any(
            (m.data_ptr() | stride * m.element_size()) % 16 for m in (shift, smod)):
        shift, smod = (m.clone(memory_format=torch.contiguous_format) for m in (shift, smod))
        stride = d
    for name, m in (("shift", shift), ("smod", smod)):
        if m.device != dev:
            raise ValueError(f"norm_modulate_quant: {name} must be on {dev}")
    q = torch.empty((b, t, d), dtype=torch.int8, device=dev)
    scale = torch.empty((b, t, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_norm_modulate_quant(
            h.data_ptr(), shift.data_ptr(), smod.data_ptr(), stride, q.data_ptr(),
            scale.data_ptr(), b * t, t, d, float(eps), int(h.dtype == torch.float32),
            int(shift.dtype == torch.float32), int(form == "warp"), stream)
    if err != 0:
        raise RuntimeError(f"norm_modulate_quant kernel launch failed: CUDA error {err}")
    norm_modulate_quant.launches += 1
    return q, scale


def norm_modulate_quant(h, shift, smod, eps: float):
    """LayerNorm (no affine) + modulate + per-token int8 quantize. h (B, T,
    D) bf16 or f32; shift, smod (B, D) (a broadcast row, stride 0, is read
    as it is). Returns (q int8 (B, T, D), scale f32 (B, T, 1)): the kernel
    on CUDA tensors, its plain version on CPU tensors."""
    _check_input("norm_modulate_quant", h)
    if h.device.type == "cpu":
        return norm_modulate_quant_plain(h, shift, smod, eps)
    if h.device.type != "cuda":
        raise ValueError(f"norm_modulate_quant runs on cuda or cpu tensors, not {h.device}")
    return _launch_norm(h, shift, smod, eps)


norm_modulate_quant.launches = 0  # kernel launches (not plain-version calls)


def traffic_gelu(shape):
    """(bytes, operations) of K12g on bf16 input: y read once, q and one f32
    scale per row written once; about 12 f32 operations per value (the
    tanh-GELU, |y|, max, division, round, clip)."""
    b, t, d = shape
    return b * t * d * 3 + b * t * 4, 12 * b * t * d


def traffic_norm(shape, mod_rows: int):
    """(bytes, operations) of K12n on bf16 input and modulation: h read once,
    the ``mod_rows`` distinct rows of shift and smod (1 for a row broadcast
    over the batch) read once, q and one f32 scale per row written once;
    about 12 f32 operations per value."""
    b, t, d = shape
    return b * t * d * 3 + b * t * 4 + 2 * mod_rows * d * 2, 12 * b * t * d
