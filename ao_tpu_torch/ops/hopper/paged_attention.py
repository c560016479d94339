"""Paged decode attention on Hopper: K9 over a bf16 page pool.

Counterpart of ``ao_tpu/ops/pallas/paged_attention.py::paged_decode_attention``
in mode "fp" (``_make_kernel``, ``_impl``), over the raw page tensors of
``serving/paged.py::PagedKVPool``: k_pages, v_pages (P, page_size, Hkv, D)
bf16, a (B, max_pages) int32 block table of page ids and lengths (B,), the
new token counted. ``serving/paged.py::paged_attention`` dispatches here.

``paged_decode_attention`` runs the kernel (``csrc/paged_attention.cu``,
whose header says what bounds it and how it splits over positions) on CUDA
tensors and its plain PyTorch version on CPU tensors, and counts its
launches. Still to port: the reference's "vec8" (int8, fp8 pools) and
"int4" modes, with the quantized pools themselves.
"""

from __future__ import annotations

import ctypes

import torch

from ao_tpu_torch.ops.hopper import build

_NEG = -0.7 * float(torch.finfo(torch.float32).max)  # the reference's mask value

# what paged_attention.cu takes (checked against the library when it loads);
# known here so that the CPU refuses the same shapes as the card
HEAD_DIM = 128
MAX_GROUP = 8
CHUNK = 64

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("paged_attention")
        fn = lib.ao_paged_attention
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name, want in (("ao_paged_attention_chunk", CHUNK),
                           ("ao_paged_attention_max_group", MAX_GROUP),
                           ("ao_paged_attention_head_dim", HEAD_DIM)):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
            if getattr(lib, name)() != want:
                raise RuntimeError(f"paged_attention.cu: {name} is not {want}")
        _LIB = lib
    return _LIB


def paged_decode_attention_plain(q, k_pages, v_pages, block_table, lengths,
                                 sm_scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, to its roundings: q (B, H, D)
    rounded to bf16; each sequence's K and V rows gathered through the block
    table, rows at or past lengths zeroed (never read as data) and their
    scores masked to _NEG. Positions go in splits of CHUNK; a split that
    starts below lengths[b] gives bf16(exp(s - m_split)) . V and the f32 sum
    of exp(s - m_split), each scaled by exp(m_split - max over those splits);
    out = the scaled products / max(the scaled sums, 1e-30), f32 (B, H, D);
    0 for lengths <= 0."""
    b, h, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    t = block_table.shape[1] * ps
    g = h // hkv
    nsplit = -(-t // CHUNK)
    valid = torch.arange(t, device=q.device)[None, :] < lengths.reshape(b, 1)  # (B, T)

    def rows(pages):
        x = pages[block_table.long()].reshape(b, t, hkv, d).to(torch.float32)
        return torch.where(valid[:, :, None, None], x, torch.zeros_like(x))

    qf = q.to(torch.bfloat16).to(torch.float32).reshape(b, hkv, g, d)
    s = torch.einsum("bngd,btnd->bngt", qf, rows(k_pages)) * sm_scale
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG))
    s = torch.nn.functional.pad(s, (0, nsplit * CHUNK - t), value=_NEG)
    s = s.reshape(b, hkv, g, nsplit, CHUNK)
    m = s.amax(dim=-1)  # (B, Hkv, G, nsplit)
    p = torch.exp(s - m[..., None])
    # the splits the kernel runs: those starting below the length
    ran = (torch.arange(nsplit, device=q.device) * CHUNK)[None, :] < lengths.reshape(b, 1)
    ran = ran[:, None, None, :]
    top = torch.where(ran, m, torch.full_like(m, -torch.inf)).amax(dim=-1, keepdim=True)
    w = torch.where(ran, torch.exp(m - top), torch.zeros_like(m))
    pw = (p.to(torch.bfloat16).to(torch.float32) * w[..., None]).flatten(-2)[..., :t]
    pv = torch.einsum("bngt,btnd->bngd", pw, rows(v_pages))
    l = (p.sum(dim=-1) * w).sum(dim=-1, keepdim=True)
    return (pv / l.clamp_min(1e-30)).reshape(b, h, d)


def _check(q, k_pages, v_pages, block_table, lengths):
    """Raise ValueError for what the kernel does not take, on the card and
    on the CPU alike; returns q as bf16, the table and lengths as int32."""
    if q.ndim != 3 or k_pages.ndim != 4 or block_table.ndim != 2:
        raise ValueError(f"paged_decode_attention: q must be (B, H, D), the pools (P, page_size, "
                         f"Hkv, D) and the block table (B, max_pages), got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(block_table.shape)}")
    b, h, d = q.shape
    n_pages, ps, hkv = k_pages.shape[:3]
    if d != HEAD_DIM:
        raise ValueError(f"paged_decode_attention: the kernel takes head_dim {HEAD_DIM}, got {d}")
    if h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"paged_decode_attention: H={h} must be a multiple of Hkv={hkv} with at "
                         f"most {MAX_GROUP} query heads per kv head")
    dev = q.device
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if x.device != dev or x.dtype != torch.bfloat16 or tuple(x.shape) != (n_pages, ps, hkv, d) \
                or not x.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be a contiguous bf16 "
                             f"{(n_pages, ps, hkv, d)} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if block_table.shape[0] != b or lengths.numel() != b:
        raise ValueError(f"paged_decode_attention: the block table and lengths need B={b} rows, "
                         f"got {tuple(block_table.shape)}, {tuple(lengths.shape)}")
    if block_table.device != dev or lengths.device != dev:
        raise ValueError(f"paged_decode_attention: the block table and lengths must be on {dev}")
    return (q.to(torch.bfloat16).contiguous(), block_table.to(torch.int32).contiguous(),
            lengths.reshape(b).to(torch.int32).contiguous())


def _launch(q, k_pages, v_pages, block_table, lengths, sm_scale: float) -> torch.Tensor:
    lib = _lib()
    dev = q.device
    b, h, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    max_pages = block_table.shape[1]
    g = h // hkv
    nsplit = -(-(max_pages * ps) // CHUNK)
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    o_part = torch.empty((b, hkv, nsplit, g, d), dtype=torch.float32, device=dev)
    m_part = torch.empty((b, hkv, nsplit, g), dtype=torch.float32, device=dev)
    l_part = torch.empty((b, hkv, nsplit, g), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ao_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
            l_part.data_ptr(), b, h, hkv, ps, max_pages, nsplit, sm_scale, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, block_table, lengths, *,
                           sm_scale=None) -> torch.Tensor:
    """Single-token decode attention over bf16 page pools: q (B, H, D);
    k_pages, v_pages (P, page_size, Hkv, D); block_table (B, max_pages) page
    ids; lengths (B,) valid positions. Returns (B, H, D) f32: the kernel on
    CUDA tensors, its plain version on CPU tensors."""
    q, block_table, lengths = _check(q, k_pages, v_pages, block_table, lengths)
    sm_scale = float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, block_table, lengths, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu tensors, not {q.device}")
    return _launch(q, k_pages, v_pages, block_table, lengths, sm_scale)


paged_decode_attention.launches = 0  # kernel launches (not plain-version calls)


def traffic(q_shape, pool_shape, max_pages, lengths):
    """(bytes, flops) the function needs for these lengths: q (bf16), the K
    and V rows of the valid positions and the block-table entries of their
    pages read once, lengths read, the f32 output written once; 4 flops per
    valid position, query head and channel."""
    b, h, d = q_shape
    ps, hkv = pool_shape[1], pool_shape[2]
    valid = [min(max(int(x), 0), max_pages * ps) for x in lengths]
    pages = sum(-(-n // ps) for n in valid)
    nbytes = (b * h * d * 2 + 2 * sum(valid) * hkv * d * 2 + pages * 4 + b * 4
              + b * h * d * 4)
    return nbytes, 4 * sum(valid) * h * d
