"""Single-query decode attention on Hopper: K2 over a bf16 cache, and K5,
K6, K7 and K2v over the quantized caches of ``serving/kvcache.py``.

Counterparts of ``ao_tpu/ops/pallas/decode_attention.py::decode_attention``:

* K2 (``decode_attention.cu``): the bf16 "tokens" branch, ``_tok_kernel`` in
  mode "fp".
* K5 (``decode_attention.cu``, ``decode_attention_int8``): the int8 cache
  in the reference's "i8" semantics (``_kt_kernel``): q quantized to int8
  per (batch, kv-head group), exact int8 dots for the scores.
* K6 (``decode_attention.cu``, ``decode_attention_fp8``): the fp8 e4m3
  cache (``_f8_kernel``, and the fp8 form of ``_tok_kernel`` "vec8"): bf16 q
  over e4m3 K and V converted exactly in the kernel.
* K7 (``decode_attention.cu``, ``decode_attention_int4``): the int4 cache
  (``_ck4_kernel`` and ``_int4_kernel``) in the port's channel-packed
  "ch4" layout.
* K2v (``decode_attention.cu``, ``decode_attention_vec8``): the bf16-q
  "vec8" form of ``_tok_kernel`` over an int8 or fp8 e5m2 "tokens" cache,
  K6's function over those storage types.

K2, K2v, K5, K6 and K7 run on the decode mainloop shared with K9
(``csrc/decode_mainloop.cuh``, whose header says what bounds it and how it
is built): one launch a call, no workspace, ``launch_plan`` /
``launch_plan_quant`` choosing the CTAs a stream (one cluster), the
positions a tile and the depth of each warp's ring from static shapes. K2v's
128-byte rows are converted to bf16 exactly in shared memory; K6's e4m3
rows and K7's 64-byte ch4 rows go from the ring straight into mma fragments
("direct": no bf16 slab; ``tests/test_torch_tiles.py`` mirrors the lanes'
maps), and so do K5's int8 rows, K as stored into integer mma's against q
quantized to int8 in each warp. Every wrapper runs its kernel on CUDA
tensors and its plain PyTorch version (``decode_attention_plain``,
``decode_attention_quant_plain``) on CPU tensors, and counts its launches. ``decode_attention`` dispatches on the
cache's dtype and layout and on the mode the caller asks for. ``lengths``
is per row, so K2 also serves the serving engine's slot layout, whose rows
sit at their own positions; the paged layout's decode attention is K9
(``paged_attention.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ao_tpu_torch.ops.hopper import build

_NEG = -0.7 * float(torch.finfo(torch.float32).max)  # the reference's mask value

# what decode_attention.cu (K2, K2v, K5, K6, K7) takes (checked against the
# library when it loads); known here so that the routes and the CPU refuse
# the same shapes as the card
HEAD_DIM = 128
MAX_GROUP = 8
# the quantized kinds' plain version: positions per split
CHUNK = 64
# the decode mainloop (K2, K2v, K5, K6, K7, K9): positions a warp takes at a time
# (one k16 step of p . V), the CTAs of a stream (a portable cluster), the
# positions a tile (16 a warp: four or eight warps) and the slabs of a warp's
# cp.async ring (K5's, K6's and K7's "direct" ring: three, the depth it is
# built at)
SLAB = 16
MAX_SPLIT = 8
SMS = 132  # the H100's SMs, which one launch's CTAs fill once
SMEM_MAX = 232448  # shared memory a block can have on the H100 (227 KB)
SPLITS = (1, 2, 4, 8)
TILE_ROWS = (64, 128)
STAGES = (3, 4)
DIRECT_STAGES = (3,)
ROW_BYTES = 2 * HEAD_DIM  # a bf16 row of one kv head; converted rows are 128 or 64


class DecodePlan(NamedTuple):
    splits: int  # CTAs of one (batch row, kv head) stream: one cluster
    rows: int    # positions a tile; warp w takes the 16-position slab w of each
    stages: int  # slabs in each warp's cp.async ring
    tiles: int   # tiles a CTA walks: CTA r takes tiles [r tiles, (r + 1) tiles)


def smem_bytes(rows: int, stages: int, row_bytes: int = ROW_BYTES, direct: bool = False) -> int:
    """Shared memory of a CTA at ``rows`` positions a tile and ``stages``
    slabs a warp's ring over stored rows of ``row_bytes``, as
    ``csrc/decode_mainloop.cuh``'s Layout: a warp's stages of 16 K and 16 V
    rows (and, for converted rows, their 32 f32 scales), its bf16 slab of K
    and V for K2v's and K9's converted rows (none for K5's, K6's and K7's
    ``direct`` rows), then the cluster merge's receive area."""
    quant = row_bytes != ROW_BYTES
    stage = 2 * SLAB * row_bytes + (2 * SLAB * 4 if quant else 0)
    slab = 2 * SLAB * ROW_BYTES if quant and not direct else 0
    return rows // SLAB * (stages * stage + slab) + 4 * (MAX_GROUP * HEAD_DIM
                                                         + 2 * MAX_SPLIT * MAX_GROUP)


def plan_for(streams: int, t: int, row_bytes: int = ROW_BYTES, splits=None, rows=None,
             stages=None, direct: bool = False) -> DecodePlan:
    """The decode mainloop's launch for ``streams`` (batch row, kv head)
    streams of ``t`` positions stored in rows of ``row_bytes`` (bf16: 256;
    int8 and fp8: 128, int4: 64, converted in the kernel: in a bf16 slab,
    or for K5, K6 and K7, ``direct``, straight into mma fragments); any of
    ``splits``, ``rows`` and ``stages`` given is taken as it is
    (``kernel_tiles.py time K2`` sweeps them). From static shapes only,
    never the lengths: the CTAs of a stream split its tiles evenly, a CTA
    stopping at its stream's length."""
    quant = row_bytes != ROW_BYTES
    # converted rows take a slab about twice as long as bf16 rows: above
    # generate's T = 256 eight warps a CTA walk half as many slabs each;
    # direct rows at every T (kernel_tiles.py time K5 / K6 / K7, PERF.md)
    rows = rows or (128 if direct or (quant and t > 256) else 64)
    # K5, K6 and K7 (kernel_tiles.py time K5 / K6 / K7, PERF.md): three stages
    stages = stages or (3 if direct or not quant else 4)
    n_tiles = max(-(-t // rows), 1)
    if splits is None:
        # at most one CTA an SM, and at least four tiles a CTA (two for K2v's
        # and K9's converted rows), so that the cluster's merge pays
        min_tiles = 2 if quant and not direct else 4
        splits = 1
        while (splits < MAX_SPLIT and streams * 2 * splits <= SMS
               and n_tiles >= min_tiles * 2 * splits):
            splits *= 2
    return check_plan(DecodePlan(splits, rows, stages, -(-n_tiles // splits)), t, row_bytes,
                      direct)


def check_plan(plan: DecodePlan, t: int, row_bytes: int = ROW_BYTES,
               direct: bool = False) -> DecodePlan:
    """Raise ValueError unless the decode mainloop takes ``plan`` over rows of
    ``row_bytes`` (``direct``: K5's, K6's and K7's) at a ring it builds, whose
    shared memory fits a block, and its CTAs cover all ``t`` positions of a
    stream."""
    if plan.splits not in SPLITS or plan.rows not in TILE_ROWS \
            or plan.stages not in (DIRECT_STAGES if direct else STAGES) \
            or smem_bytes(plan.rows, plan.stages, row_bytes, direct) > SMEM_MAX \
            or plan.splits * plan.tiles * plan.rows < t:
        raise ValueError(f"not a plan of the decode mainloop for T={t}: {plan}")
    return plan


def launch_plan(q_shape, cache_shape, **kw) -> DecodePlan:
    """K2's launch at q (B, H, D) over a (B, T, Hkv, D) cache (``plan_for``)."""
    return plan_for(q_shape[0] * cache_shape[2], cache_shape[1], **kw)


def launch_plan_vec8(q_shape, cache_shape, **kw) -> DecodePlan:
    """K2v's launch at q (B, H, D) over a (B, T, Hkv, D) int8 or e5m2 cache:
    ``plan_for`` over rows of 128 bytes."""
    return launch_plan_quant("v8", q_shape, cache_shape, **kw)


# the stored row bytes of K5 ("i8": int8), K6 ("f8": e4m3) and K7 ("i4":
# ch4), converted straight into mma fragments (K5's K rows taken as they
# are), and of each kind on the decode mainloop with whether it is (K2v's
# "v8" rows go through a bf16 slab)
DIRECT_KINDS = {"i8": HEAD_DIM, "f8": HEAD_DIM, "i4": HEAD_DIM // 2}
_RING = {"v8": (HEAD_DIM, False), **{k: (rb, True) for k, rb in DIRECT_KINDS.items()}}


def launch_plan_quant(kind: str, q_shape, cache_shape, **kw) -> DecodePlan:
    """The launch of K2v ("v8"), K5 ("i8"), K6 ("f8") or K7 ("i4") at q (B,
    H, D) over a (B, T, Hkv, *) cache: ``plan_for`` over rows of 128, 128,
    128 and 64 bytes, K5's, K6's and K7's straight into mma fragments."""
    row_bytes, direct = _RING[kind]
    return plan_for(q_shape[0] * cache_shape[2], cache_shape[1], row_bytes, direct=direct, **kw)


def takes(head_dim: int, group: int) -> bool:
    """Whether the decode attention kernels take this head_dim and this many
    query heads per kv head. The single-token decode route of
    ``models/llama.py`` and the wrappers' own checks both ask it."""
    return head_dim == HEAD_DIM and 1 <= group <= MAX_GROUP


def _check_library(lib, source: str, prefix: str, wants) -> None:
    for name, want in wants:
        getattr(lib, f"{prefix}_{name}").argtypes = []
        getattr(lib, f"{prefix}_{name}").restype = ctypes.c_int
        if getattr(lib, f"{prefix}_{name}")() != want:
            raise RuntimeError(f"{source}: {prefix}_{name} is not {want}")


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("decode_attention")
        fn = lib.ao_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.ao_decode_attention_vec8
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _check_library(lib, "decode_attention.cu", "ao_decode_attention",
                       (("slab", SLAB), ("max_group", MAX_GROUP), ("head_dim", HEAD_DIM),
                        ("max_split", MAX_SPLIT)))
        _LIB = lib
    return _LIB


def decode_attention_plain(q, k_cache, v_cache, lengths, sm_scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q (B, H, D) rounded to bf16 as
    the kernel takes it; K/V (B, T, Hkv, D); f32 scores masked to _NEG at
    positions >= lengths; softmax; f32 out (B, H, D)."""
    b, h, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qf = q.to(torch.bfloat16).to(torch.float32).reshape(b, hkv, g, d)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    s = torch.einsum("bngd,btnd->bngt", qf, kf) * sm_scale
    mask = torch.arange(t, device=q.device)[None, :] < lengths.reshape(b, 1)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bngt,btnd->bngd", p, vf).reshape(b, h, d)


def _launch(q, k_cache, v_cache, lengths, sm_scale: float, plan=None) -> torch.Tensor:
    """One launch of K2 at ``plan`` (by default ``launch_plan``'s)."""
    lib = _lib()
    dev = q.device
    b, h, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    if d != HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes head_dim {HEAD_DIM}, got {d}")
    if not takes(d, h // hkv):
        raise ValueError(f"decode_attention kernel takes at most {MAX_GROUP} query heads per "
                         f"kv head, got {h // hkv}")
    for name, x, dt, shape in (("q", q, torch.bfloat16, (b, h, d)),
                               ("k_cache", k_cache, torch.bfloat16, (b, t, hkv, d)),
                               ("v_cache", v_cache, torch.bfloat16, (b, t, hkv, d)),
                               ("lengths", lengths, torch.int32, (b,))):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"decode_attention: {name} must be a contiguous {dt} {shape} on {dev}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte aligned")
    plan = check_plan(plan or launch_plan((b, h, d), (b, t, hkv, d)), t)
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ao_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, h, hkv, t, plan.splits, plan.tiles, plan.rows, plan.stages,
            sm_scale, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


def decode_attention(q, k_cache, v_cache, lengths, *, k_scale=None, v_scale=None,
                     sm_scale=None, k_layout: str = "tokens", mode=None) -> torch.Tensor:
    """Single-step decode attention: q (B, H, D); lengths (B,) valid
    positions. Returns (B, H, D) f32: the kernel on CUDA tensors, its plain
    version on CPU tensors.

    * bf16 cache, no scales: k_cache/v_cache (B, T, Hkv, D), K2.
    * quantized cache (``serving/kvcache.py``), with k_scale/v_scale
      (B, Hkv, T) f32: int8 "tokens" with ``mode="i8"`` (K5), fp8 e4m3
      "tokens" (K6), int4 "ch4" (K7), int8 "tokens" without a mode or fp8
      e5m2 "tokens" (K2v)."""
    if k_scale is not None or v_scale is not None:
        kind = _quant_kind(k_cache.dtype, k_layout, mode)
        return _QUANT_WRAPPERS[kind](q, k_cache, k_scale, v_cache, v_scale, lengths,
                                     sm_scale=sm_scale)
    if k_layout != "tokens" or mode is not None:
        raise ValueError(f"a cache without scales is the bf16 tokens form, got layout "
                         f"{k_layout!r}, mode {mode!r}")
    b, h, d = q.shape
    if k_cache.ndim != 4 or k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != d:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    hkv = k_cache.shape[2]
    if h % hkv:
        raise ValueError(f"H={h} not a multiple of Hkv={hkv}")
    sm_scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    q = q.to(torch.bfloat16)
    lengths = lengths.reshape(b).to(torch.int32).contiguous()
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, not {q.device}")
    return _launch(q, k_cache, v_cache, lengths, sm_scale)


decode_attention.launches = 0  # kernel launches (not plain-version calls)


def traffic(q_shape, cache_shape, lengths):
    """(bytes, flops) the function needs for these lengths: q (bf16) and the
    K and V rows of the valid positions read once, lengths read, the f32
    output written once."""
    b, h, d = q_shape
    t, hkv = cache_shape[1], cache_shape[2]
    valid = sum(min(max(int(x), 0), t) or t for x in lengths)
    nbytes = b * h * d * 2 + 2 * valid * hkv * d * 2 + b * 4 + b * h * d * 4
    return nbytes, 4 * valid * h * d


# ---------------------------------------------------------------------------
# K5, K6, K7, K2v: quantized caches

# the storage type of each kind and its mode of ao_decode_attention_vec8
# (K2v 0 / 1, K6 2, K7 3, K5 4)
_KIND_MODE = {"i8": {torch.int8: 4}, "f8": {torch.float8_e4m3fn: 2}, "i4": {torch.int32: 3},
              "v8": {torch.int8: 0, torch.float8_e5m2: 1}}
_KIND_NAME = {"i8": "int8 (K5)", "f8": "fp8 e4m3 (K6)", "i4": "int4 (K7)",
              "v8": "int8 / fp8 e5m2 bf16-q (K2v)"}

def _quant_kind(dtype, layout: str, mode) -> str:
    """Which kernel computes attention over a quantized cache of ``dtype`` in
    ``layout`` for the caller's ``mode``."""
    if layout == "ch4" and dtype == torch.int32:
        return "i4"
    if layout == "tokens" and dtype == torch.float8_e4m3fn:
        return "f8"
    if layout == "tokens" and dtype == torch.int8:
        # mode="i8": q quantized to int8 (K5); otherwise the bf16-q form (K2v)
        return "i8" if mode == "i8" else "v8"
    if layout == "tokens" and dtype == torch.float8_e5m2:
        return "v8"
    raise ValueError(f"no decode attention kernel for a {dtype} cache in layout {layout!r}")


def quantize_q_plain(qf: torch.Tensor):
    """K5's q quantize: qf (B, Hkv, G, D) f32 -> (qi (B, Hkv, G, D) f32
    integers, qs (B, Hkv) f32), per (batch row, kv head) group as the
    reference quantizes it: qs = max(max |q|, 1e-8) / 127, qi =
    clip(round(q / qs), +-127), IEEE division, ties to even."""
    qs = qf.abs().amax(dim=(2, 3)).clamp_min(1e-8) / 127.0
    return torch.round(qf / qs[..., None, None]).clamp_(-127, 127), qs


def decode_attention_quant_plain(kind: str, q, k, k_scale, v, v_scale, lengths,
                                 sm_scale: float) -> torch.Tensor:
    """K5 ("i8"), K6 ("f8"), K7 ("i4") or K2v ("v8") in plain PyTorch, to the
    kernels' roundings: q (B, H, D) rounded to bf16; for "i8" q quantized
    per (batch, kv head) to int8 (``quantize_q_plain``), s = dot(qi, K) * ks
    * (qs * sm_scale) (the integer dot is exact in f32); otherwise s =
    dot(q, K) * sm_scale * ks. Masked to _NEG at positions >= lengths
    (lengths >= 1), whose values and scales are never read. Positions go in
    splits of CHUNK: a split that starts below lengths[b] (every split, for
    lengths <= 0) gives sum bf16(exp(s - m_split) * vs) * V and the f32 sum
    of exp(s - m_split), each scaled by exp(m_split - the max over those
    splits); out = the scaled products / max(the scaled sums, 1e-30), f32
    (B, H, D). (The kernels on the decode mainloop round bf16(p * vs)
    against each warp's running max instead: the same function to bf16's
    rounding of p.)"""
    from ao_tpu_torch.serving.kvcache import stored_values

    b, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    nsplit = -(-t // CHUNK)
    lens = lengths.reshape(b, 1)
    read = (torch.arange(t, device=q.device)[None, :] < lens) | (lens < 1)  # (B, T)
    kf, vf = (torch.where(read[:, :, None, None], x, torch.zeros_like(x))
              for x in (stored_values(k), stored_values(v)))
    qf = q.to(torch.bfloat16).to(torch.float32).reshape(b, hkv, g, d)
    ks, vs = (torch.where(read[:, None, :], x, torch.zeros_like(x))[:, :, None, :]
              for x in (k_scale, v_scale))
    if kind == "i8":
        qi, qs = quantize_q_plain(qf)
        s = torch.einsum("bngd,btnd->bngt", qi, kf) * ks * (qs * sm_scale)[..., None, None]
    else:
        s = torch.einsum("bngd,btnd->bngt", qf, kf) * sm_scale * ks
    mask = torch.arange(t, device=q.device)[None, :] < lens
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG))
    # the last split's positions past T do not exist: p = 0 there
    pad = nsplit * CHUNK - t
    s = torch.nn.functional.pad(s, (0, pad), value=-torch.inf).reshape(b, hkv, g, nsplit, CHUNK)
    m = s.amax(dim=-1)  # (B, Hkv, G, nsplit)
    p = torch.exp(s - m[..., None])
    # the splits the kernels run: those starting below the length, or all
    ran = (torch.arange(nsplit, device=q.device) * CHUNK)[None, :] < lens
    ran = (ran | (lens < 1))[:, None, None, :]
    top = torch.where(ran, m, torch.full_like(m, -torch.inf)).amax(dim=-1, keepdim=True)
    w = torch.where(ran, torch.exp(m - top), torch.zeros_like(m))
    pv = (p.flatten(-2)[..., :t] * vs).to(torch.bfloat16).to(torch.float32)
    pv = torch.nn.functional.pad(pv, (0, pad)).reshape(b, hkv, g, nsplit, CHUNK)
    pw = (pv * w[..., None]).flatten(-2)[..., :t]
    acc = torch.einsum("bngt,btnd->bngd", pw, vf)
    l = (p.sum(dim=-1) * w).sum(dim=-1, keepdim=True)
    return (acc / l.clamp_min(1e-30)).reshape(b, h, d)


def _check_quant(kind, q, k, k_scale, v, v_scale, lengths):
    """Raise ValueError for what the kernel does not take, on the card and
    on the CPU alike; returns q as a contiguous, 16-byte aligned bf16 tensor
    (the kernels read it in 16-byte loads: a view that starts elsewhere is
    copied) and lengths as int32 (B,)."""
    name = f"decode_attention {_KIND_NAME[kind]}"
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"{name}: q must be (B, H, D) and the caches (B, T, Hkv, *), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if d != HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim {HEAD_DIM}, got {d}")
    if h % hkv or not takes(d, h // hkv):
        raise ValueError(f"{name}: H={h} must be a multiple of Hkv={hkv} with at most "
                         f"{MAX_GROUP} query heads per kv head")
    row = d // 8 if kind == "i4" else d
    dev = q.device
    storage = k.dtype if k.dtype in _KIND_MODE[kind] else next(iter(_KIND_MODE[kind]))
    for what, x, dt, shape in (("k_cache", k, storage, (b, t, hkv, row)),
                               ("v_cache", v, storage, (b, t, hkv, row)),
                               ("k_scale", k_scale, torch.float32, (b, hkv, t)),
                               ("v_scale", v_scale, torch.float32, (b, hkv, t))):
        if x is None or x.device != dev or x.dtype != dt or tuple(x.shape) != shape \
                or not x.is_contiguous():
            got = None if x is None else f"{x.dtype} {tuple(x.shape)} on {x.device}"
            raise ValueError(f"{name}: {what} must be a contiguous {dt} {shape} on {dev}, "
                             f"got {got}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    if lengths.numel() != b:
        raise ValueError(f"{name}: lengths must have B={b} entries, got {lengths.numel()}")
    q = q.to(torch.bfloat16).contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    return q, lengths.reshape(b).to(torch.int32).contiguous()


def _quant_attention(kind, q, k, k_scale, v, v_scale, lengths, sm_scale):
    q, lengths = _check_quant(kind, q, k, k_scale, v, v_scale, lengths)
    sm_scale = float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return decode_attention_quant_plain(kind, q, k, k_scale, v, v_scale, lengths, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, not {q.device}")
    return _launch_quant(kind, q, k, k_scale, v, v_scale, lengths, sm_scale)


def _launch_quant(kind, q, k, k_scale, v, v_scale, lengths, sm_scale: float,
                  plan=None) -> torch.Tensor:
    """One launch of K2v ("v8"), K5, K6 or K7 on the decode mainloop at
    ``plan`` (by default ``launch_plan_quant``'s). The plan is checked
    before anything runs, so a plan the kernel does not build raises
    ValueError on any device."""
    dev = q.device
    b, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    mode = _KIND_MODE[kind][k.dtype]
    row_bytes, direct = _RING[kind]
    plan = check_plan(plan or launch_plan_quant(kind, (b, h, d), (b, t, hkv, d)), t, row_bytes,
                      direct)
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_decode_attention_vec8(
            mode, q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h, hkv, t, plan.splits,
            plan.tiles, plan.rows, plan.stages, sm_scale, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention {_KIND_NAME[kind]} kernel launch failed: "
                           f"CUDA error {err}")
    _QUANT_WRAPPERS[kind].launches += 1
    return out


def decode_attention_int8(q, k, k_scale, v, v_scale, lengths, *, sm_scale=None):
    """K5: q (B, H, D) over an int8 "tokens" cache, k/v (B, T, Hkv, D) int8
    with scales (B, Hkv, T) f32, in the reference's "i8" semantics (see
    ``decode_attention_quant_plain``). Returns (B, H, D) f32."""
    return _quant_attention("i8", q, k, k_scale, v, v_scale, lengths, sm_scale)


def decode_attention_fp8(q, k, k_scale, v, v_scale, lengths, *, sm_scale=None):
    """K6: q (B, H, D) over an fp8 e4m3 "tokens" cache, k/v (B, T, Hkv, D)
    with scales (B, Hkv, T) f32. Returns (B, H, D) f32."""
    return _quant_attention("f8", q, k, k_scale, v, v_scale, lengths, sm_scale)


def decode_attention_int4(q, k, k_scale, v, v_scale, lengths, *, sm_scale=None):
    """K7: q (B, H, D) over an int4 "ch4" cache, k/v (B, T, Hkv, D/8) int32
    words of channel nibbles with scales (B, Hkv, T) f32. Returns (B, H, D)
    f32."""
    return _quant_attention("i4", q, k, k_scale, v, v_scale, lengths, sm_scale)


def decode_attention_vec8(q, k, k_scale, v, v_scale, lengths, *, sm_scale=None):
    """K2v: q (B, H, D) in bf16 over an int8 or fp8 e5m2 "tokens" cache, k/v
    (B, T, Hkv, D) with scales (B, Hkv, T) f32 (K6's function over those
    storage types). Returns (B, H, D) f32."""
    return _quant_attention("v8", q, k, k_scale, v, v_scale, lengths, sm_scale)


_QUANT_WRAPPERS = {"i8": decode_attention_int8, "f8": decode_attention_fp8,
                   "i4": decode_attention_int4, "v8": decode_attention_vec8}
for _wrapper in _QUANT_WRAPPERS.values():
    _wrapper.launches = 0  # kernel launches (not plain-version calls)


def traffic_quant(kind: str, q_shape, cache_shape, lengths):
    """(bytes, operations) of K5, K6, K7 or K2v for these lengths: q (bf16), the K
    and V rows of the valid positions (1 B per value, int4 half a byte) and
    their two f32 scales read once, lengths read, the f32 output written
    once; 4 operations per valid position, query head and channel (the
    scores' and p.V's multiply-adds)."""
    b, h, d = q_shape
    t, hkv = cache_shape[1], cache_shape[2]
    valid = sum(min(max(int(x), 0), t) or t for x in lengths)
    row = d // 2 if kind == "i4" else d
    nbytes = b * h * d * 2 + 2 * valid * hkv * (row + 4) + b * 4 + b * h * d * 4
    return nbytes, 4 * valid * h * d
