"""Paged decode attention on Hopper: K9 over bf16, int8, fp8 and int4 page
pools.

Counterpart of ``ao_tpu/ops/pallas/paged_attention.py::paged_decode_attention``
(``_make_kernel``, ``_impl``) in its three modes, over the raw tensors of
``serving/paged.py::PagedKVPool``: pages (P, page_size, Hkv, D) bf16, int8
or e4m3, or (P, page_size, Hkv, D/8) int32 "ch4" words for int4; scales
(P, Hkv, page_size) f32 for the quantized pools; a (B, max_pages) int32
block table of page ids and lengths (B,), the new token counted.
``serving/paged.py::paged_attention`` dispatches here by the pool's dtype.

Three wrappers, one kernel (``csrc/paged_attention.cu`` on the decode
mainloop it shares with K2, ``csrc/decode_mainloop.cuh``, whose header says
what bounds it and how it is built), each with its own launch count:
``paged_decode_attention`` ("fp", bf16 pools),
``paged_decode_attention_vec8`` (int8 and fp8 e4m3 pools) and
``paged_decode_attention_int4``. Each runs the kernel on CUDA tensors, one
launch at ``launch_plan``'s split from static shapes, and its plain PyTorch
version (``paged_decode_attention_plain``) on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ao_tpu_torch.ops.hopper import build
from ao_tpu_torch.ops.hopper.decode_attention import (MAX_SPLIT, SLAB, DecodePlan,
                                                      _check_library, check_plan, plan_for)

# bytes of a stored row of one kv head, by pool dtype
_ROW_BYTES = {torch.bfloat16: 2 * 128, torch.int8: 128, torch.float8_e4m3fn: 128, torch.int32: 64}

_NEG = -0.7 * float(torch.finfo(torch.float32).max)  # the reference's mask value

# what paged_attention.cu takes (checked against the library when it loads);
# known here so that the CPU refuses the same shapes as the card
HEAD_DIM = 128
MAX_GROUP = 8


def takes(head_dim: int, group: int) -> bool:
    """Whether K9 takes this head_dim and this many query heads per kv head.
    The paged decode route of ``serving/paged.py`` and the wrappers' own
    checks both ask it."""
    return head_dim == HEAD_DIM and 1 <= group <= MAX_GROUP


def launch_plan(q_shape, pool_shape, max_pages: int, pool_dtype=torch.bfloat16,
                **kw) -> DecodePlan:
    """K9's launch at q (B, H, D) over pools (P, page_size, Hkv, *) of
    ``pool_dtype`` with a (B, max_pages) block table: the decode mainloop's
    ``plan_for`` over T = max_pages * page_size positions."""
    return plan_for(q_shape[0] * pool_shape[2], max_pages * pool_shape[1],
                    _ROW_BYTES[pool_dtype], **kw)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("paged_attention")
        fn = lib.ao_paged_attention
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _check_library(lib, "paged_attention.cu", "ao_paged_attention",
                       (("slab", SLAB), ("max_group", MAX_GROUP), ("head_dim", HEAD_DIM),
                        ("max_split", MAX_SPLIT)))
        _LIB = lib
    return _LIB


# the kernel's mode argument, and the pool storage, of each pool dtype
_MODE = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2, torch.int32: 3}
_NAME = {"fp": "bf16 (K9 \"fp\")", "vec8": "int8 / fp8 (K9 \"vec8\")",
         "int4": "int4 (K9 \"int4\")"}
_STORAGE = {"fp": (torch.bfloat16,), "vec8": (torch.int8, torch.float8_e4m3fn),
            "int4": (torch.int32,)}


def paged_decode_attention_plain(q, k_pages, v_pages, block_table, lengths, sm_scale: float,
                                 k_scale=None, v_scale=None, plan=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, to its roundings at ``plan``
    (by default ``launch_plan``'s): q (B, H, D) rounded to bf16; each
    sequence's K and V rows (and, for a quantized pool, their scales)
    gathered through the block table, rows at or past lengths zeroed (never
    read as data) and their scores masked to _NEG; s = q . K * sm_scale
    (* ks). Positions go in slabs of SLAB, walked as the kernel walks them:
    CTA r of a stream takes tiles [r tiles, (r + 1) tiles) of ``plan.rows``
    positions and its warp w the slab w of each, while the slab starts below
    lengths[b]. A slab gives bf16(exp(s - m_run) (* vs)) . V and the f32 sum
    of exp(s - m_run), m_run the running max of its warp's walk up to it,
    each scaled by exp(m_run - the max over the stream); out = the scaled
    products / max(the scaled sums, 1e-30), f32 (B, H, D); 0 for lengths
    <= 0."""
    from ao_tpu_torch.serving.kvcache import stored_values

    b, h, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    max_pages = block_table.shape[1]
    t = max_pages * ps
    g = h // hkv
    plan = check_plan(plan or launch_plan(q.shape, k_pages.shape, max_pages, k_pages.dtype),
                      t, _ROW_BYTES[k_pages.dtype])
    warps = plan.rows // SLAB
    pad = plan.splits * plan.tiles * plan.rows - t
    table = block_table.long()
    valid = torch.arange(t, device=q.device)[None, :] < lengths.reshape(b, 1)  # (B, T)

    def rows(pages):
        x = stored_values(pages[table]).reshape(b, t, hkv, d)
        return torch.where(valid[:, :, None, None], x, torch.zeros_like(x))

    def scales(scale):  # (P, Hkv, ps) -> (B, Hkv, 1, T), 0 past lengths
        x = scale[table].transpose(1, 2).reshape(b, hkv, t)
        return torch.where(valid[:, None, :], x, torch.zeros_like(x))[:, :, None, :]

    def walk(x):  # (..., T + pad) -> (..., splits, warps, tiles, SLAB): each warp's walk
        x = x.reshape(*x.shape[:-1], plan.splits, plan.tiles, warps, SLAB)
        return x.transpose(-3, -2)

    qf = q.to(torch.bfloat16).to(torch.float32).reshape(b, hkv, g, d)
    s = torch.einsum("bngd,btnd->bngt", qf, rows(k_pages)) * sm_scale
    if k_scale is not None:
        s = s * scales(k_scale)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG))
    s = walk(torch.nn.functional.pad(s, (0, pad), value=_NEG))  # (B, Hkv, G, S, W, tiles, SLAB)
    # the slabs the kernel walks: those starting below the length
    starts = walk(torch.arange(t + pad, device=q.device))[..., 0]  # (S, W, tiles)
    ran = (starts[None] < lengths.clamp(max=t).reshape(b, 1, 1, 1))[:, None, None]
    mx = torch.where(ran, s.amax(dim=-1), torch.full_like(s[..., 0], -torch.inf))
    m_run = torch.cummax(mx, dim=-1).values
    top = mx.flatten(-3).amax(dim=-1)[..., None, None, None]  # (B, Hkv, G, 1, 1, 1)
    w = torch.where(ran, torch.exp(m_run - top), torch.zeros_like(m_run))
    p = torch.where(ran[..., None], torch.exp(s - m_run[..., None]), torch.zeros_like(s))
    pv = p
    if v_scale is not None:
        vs = torch.nn.functional.pad(scales(v_scale), (0, pad))
        pv = pv * walk(vs)
    pw = pv.to(torch.bfloat16).to(torch.float32) * w[..., None]
    pw = pw.transpose(-3, -2).reshape(b, hkv, g, t + pad)[..., :t]
    out = torch.einsum("bngt,btnd->bngd", pw, rows(v_pages))
    l = (p.sum(dim=-1) * w).flatten(-3).sum(dim=-1, keepdim=True)
    return (out / l.clamp_min(1e-30)).reshape(b, h, d)


def _check(mode, q, k_pages, k_scale, v_pages, v_scale, block_table, lengths):
    """Raise ValueError for what the kernel does not take, on the card and
    on the CPU alike; returns q as bf16, the table and lengths as int32."""
    name = f"paged_decode_attention {_NAME[mode]}"
    if q.ndim != 3 or k_pages.ndim != 4 or block_table.ndim != 2:
        raise ValueError(f"{name}: q must be (B, H, D), the pools (P, page_size, Hkv, *) and "
                         f"the block table (B, max_pages), got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(block_table.shape)}")
    b, h, d = q.shape
    n_pages, ps, hkv = k_pages.shape[:3]
    if d != HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim {HEAD_DIM}, got {d}")
    if h % hkv or not takes(d, h // hkv):
        raise ValueError(f"{name}: H={h} must be a multiple of Hkv={hkv} with at most "
                         f"{MAX_GROUP} query heads per kv head")
    dev = q.device
    row = d // 8 if mode == "int4" else d
    dt = k_pages.dtype if k_pages.dtype in _STORAGE[mode] else _STORAGE[mode][0]
    want = [("k_pages", k_pages, dt, (n_pages, ps, hkv, row)),
            ("v_pages", v_pages, dt, (n_pages, ps, hkv, row))]
    if mode != "fp":
        want += [("k_scale", k_scale, torch.float32, (n_pages, hkv, ps)),
                 ("v_scale", v_scale, torch.float32, (n_pages, hkv, ps))]
    for what, x, dtype, shape in want:
        if x is None or x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            got = None if x is None else f"{x.dtype} {tuple(x.shape)} on {x.device}"
            raise ValueError(f"{name}: {what} must be a contiguous {dtype} {shape} on {dev}, "
                             f"got {got}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    if block_table.shape[0] != b or lengths.numel() != b:
        raise ValueError(f"{name}: the block table and lengths need B={b} rows, "
                         f"got {tuple(block_table.shape)}, {tuple(lengths.shape)}")
    if block_table.device != dev or lengths.device != dev:
        raise ValueError(f"{name}: the block table and lengths must be on {dev}")
    if ps % 8:
        raise ValueError(f"{name}: the kernel takes page_size % 8 == 0, got {ps}")
    return (q.to(torch.bfloat16).contiguous(), block_table.to(torch.int32).contiguous(),
            lengths.reshape(b).to(torch.int32).contiguous())


def _launch(q, k_pages, k_scale, v_pages, v_scale, block_table, lengths, sm_scale: float,
            plan=None) -> torch.Tensor:
    """One launch of the kernel in the mode of the pools' dtype (k_scale and
    v_scale None for bf16 pools) at ``plan`` (by default ``launch_plan``'s)."""
    lib = _lib()
    dev = q.device
    b, h, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    max_pages = block_table.shape[1]
    plan = check_plan(plan or launch_plan(q.shape, k_pages.shape, max_pages, k_pages.dtype),
                      max_pages * ps, _ROW_BYTES[k_pages.dtype])
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    mode = _MODE[k_pages.dtype]
    ks = 0 if k_scale is None else k_scale.data_ptr()
    vs = 0 if v_scale is None else v_scale.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ao_paged_attention(
            mode, q.data_ptr(), k_pages.data_ptr(), ks, v_pages.data_ptr(), vs,
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h, hkv, ps, max_pages,
            plan.splits, plan.tiles, plan.rows, plan.stages, sm_scale, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed (mode {mode}): "
                           f"CUDA error {err}")
    _WRAPPERS[mode].launches += 1
    return out


def _attention(mode, q, k_pages, k_scale, v_pages, v_scale, block_table, lengths, sm_scale):
    q, block_table, lengths = _check(mode, q, k_pages, k_scale, v_pages, v_scale, block_table,
                                     lengths)
    sm_scale = float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, block_table, lengths, sm_scale,
                                            k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu tensors, not {q.device}")
    return _launch(q, k_pages, k_scale, v_pages, v_scale, block_table, lengths, sm_scale)


def paged_decode_attention(q, k_pages, v_pages, block_table, lengths, *,
                           sm_scale=None) -> torch.Tensor:
    """K9 "fp": single-token decode attention over bf16 page pools: q (B, H,
    D); k_pages, v_pages (P, page_size, Hkv, D); block_table (B, max_pages)
    page ids; lengths (B,) valid positions. Returns (B, H, D) f32: the
    kernel on CUDA tensors, its plain version on CPU tensors."""
    return _attention("fp", q, k_pages, None, v_pages, None, block_table, lengths, sm_scale)


def paged_decode_attention_vec8(q, k_pages, k_scale, v_pages, v_scale, block_table, lengths, *,
                                sm_scale=None) -> torch.Tensor:
    """K9 "vec8": as ``paged_decode_attention`` over int8 or fp8 e4m3 pools
    (P, page_size, Hkv, D) with scales (P, Hkv, page_size) f32."""
    return _attention("vec8", q, k_pages, k_scale, v_pages, v_scale, block_table, lengths,
                      sm_scale)


def paged_decode_attention_int4(q, k_pages, k_scale, v_pages, v_scale, block_table, lengths, *,
                                sm_scale=None) -> torch.Tensor:
    """K9 "int4": as ``paged_decode_attention`` over int4 pools of "ch4"
    words (P, page_size, Hkv, D/8) int32 with scales (P, Hkv, page_size)
    f32."""
    return _attention("int4", q, k_pages, k_scale, v_pages, v_scale, block_table, lengths,
                      sm_scale)


# the wrapper of each kernel mode, whose count a launch raises
_WRAPPERS = {0: paged_decode_attention, 1: paged_decode_attention_vec8,
             2: paged_decode_attention_vec8, 3: paged_decode_attention_int4}
for _wrapper in (paged_decode_attention, paged_decode_attention_vec8,
                 paged_decode_attention_int4):
    _wrapper.launches = 0  # kernel launches (not plain-version calls)


def traffic(q_shape, pool_shape, max_pages, lengths, dtype_name: str = "bf16"):
    """(bytes, flops) the function needs for these lengths: q (bf16), the K
    and V rows of the valid positions (2 B per value for bf16, 1 B for int8
    and fp8, half a byte for int4) with, for a quantized pool, their two f32
    scales, and the block-table entries of their pages read once, lengths
    read, the f32 output written once; 4 flops per valid position, query
    head and channel."""
    b, h, d = q_shape
    ps, hkv = pool_shape[1], pool_shape[2]
    valid = [min(max(int(x), 0), max_pages * ps) for x in lengths]
    pages = sum(-(-n // ps) for n in valid)
    per_vector = {"bf16": 2 * d, "int4": d // 2 + 4}.get(dtype_name, d + 4)
    nbytes = (b * h * d * 2 + 2 * sum(valid) * hkv * per_vector + pages * 4 + b * 4
              + b * h * d * 4)
    return nbytes, 4 * sum(valid) * h * d
