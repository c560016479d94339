"""Flash attention for prefill on Hopper: K8.

Counterpart of ``ao_tpu/ops/pallas/flash_attention.py::flash_attention``
(``_kernel``), in the layout of the port's model: q (B, Sq, H, D) as the
projections give it and K, V read in place from the (B, Sk, Hkv, D) bf16
cache with grouped-query heads (query head n reads kv head n // G), where
the reference takes (B, H, S, D) with K and V repeated over the G heads.
The causal mask is the reference's, top-left aligned: query row i, counted
from 0, sees cache rows 0..i, also when Sq < Sk.

``flash_attention`` runs the kernel (``csrc/flash_attention.cu`` on the
shared attention mainloop ``csrc/attn_mainloop.cuh``, whose headers say
what bounds it) on CUDA tensors and its plain PyTorch version on CPU
tensors, and counts its launches. q is taken in bf16, as every attention
kernel of the port takes it. ``launch_plan`` says what a launch on the
mainloop runs: the cache rows its tensor maps cover and its CTAs in launch
order.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from ao_tpu_torch.ops.hopper import build

_MASK = -0.7 * float(torch.finfo(torch.float32).max)  # the reference's mask value

# what flash_attention.cu takes, its keys per tile of the online softmax,
# which the plain version's roundings follow, and its query rows a CTA
# (checked against the library when it loads)
HEAD_DIM = 128
BLOCK_K = 64
BLOCK_Q = 64


def takes(head_dim: int, group: int) -> bool:
    """Whether K8 takes this head_dim and this many query heads per kv head
    (any group). The ``use_flash`` route of ``models/llama.py`` and the
    wrapper's own check both ask it."""
    return head_dim == HEAD_DIM and group >= 1


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("flash_attention")
        fn = lib.ao_flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for name, want in (("ao_flash_attention_head_dim", HEAD_DIM),
                           ("ao_flash_attention_block_k", BLOCK_K),
                           ("ao_flash_attention_block_q", BLOCK_Q)):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
            if getattr(lib, name)() != want:
                raise RuntimeError(f"flash_attention.cu: {name} is not {want}")
        _LIB = lib
    return _LIB


def kv_rows(sq: int, sk: int, causal: bool) -> int:
    """The cache rows the kernel's tensor maps cover: causally min(Sq, Sk),
    so the rows past Sq, which a prefill has not written, are never read."""
    return min(sq, sk) if causal else sk


class LaunchPlan(NamedTuple):
    block_q: int   # query rows a CTA
    kv_len: int    # cache rows the tensor maps cover
    ctas: List[Tuple[int, int, int, int]]  # (first row, batch row, head, key tiles), launch order


def launch_plan(q_shape, kv_shape, causal: bool, block_q: int = BLOCK_Q) -> LaunchPlan:
    """What a launch on the attention mainloop runs at these shapes, with
    ``block_q`` query rows a CTA (K16 picks its own), as
    ``csrc/attn_mainloop.cuh`` orders it: CTA i takes head i % H, batch row
    (i / H) % B and the query tile counted from the last, so the heaviest
    causal tiles start first; causally a CTA loads the 64-key tiles up to
    its last row."""
    b, sq, h, _ = q_shape
    kv_len = kv_rows(sq, kv_shape[1], causal)
    n_qt = -(-sq // block_q)
    ctas = []
    for i in range(n_qt * h * b):
        q0 = (n_qt - 1 - i // h // b) * block_q
        end = min(kv_len, q0 + block_q, sq) if causal else kv_len
        ctas.append((q0, i // h % b, i % h, -(-end // BLOCK_K)))
    return LaunchPlan(block_q, kv_len, ctas)


def flash_attention_plain(q, k, v, causal: bool, sm_scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, to its roundings: q (B, Sq,
    H, D) rounded to bf16; K, V (B, Sk, Hkv, D); f32 scores, masked to _MASK
    where the key lies past the query row (top-left causal). Keys go in tiles
    of BLOCK_K with a running row max m_j (the max over tiles 0..j); tile j
    contributes bf16(exp(s - m_j)) . V and the f32 sum of exp(s - m_j), each
    scaled by exp(m_j - m_last); out = the scaled products / the scaled
    sums, bf16 (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    nt = -(-sk // BLOCK_K)
    qf = q.to(torch.bfloat16).to(torch.float32).reshape(b, sq, hkv, h // hkv, d)
    s = torch.einsum("bqngd,bknd->bngqk", qf, k.to(torch.float32)) * sm_scale
    if causal:
        cols = torch.arange(sk, device=q.device)
        rows = torch.arange(sq, device=q.device)
        s = torch.where(cols[None, :] <= rows[:, None], s, torch.full_like(s, _MASK))
    # keys past Sk (the last tile's tail) are no keys at all: exp(-inf) = 0
    s = torch.nn.functional.pad(s, (0, nt * BLOCK_K - sk), value=-torch.inf)
    s = s.reshape(*s.shape[:-1], nt, BLOCK_K)
    m = torch.cummax(s.amax(dim=-1), dim=-1).values  # (B, Hkv, G, Sq, nt)
    p = torch.exp(s - m[..., None])
    w = torch.exp(m - m[..., -1:])
    pw = (p.to(torch.bfloat16).to(torch.float32) * w[..., None]).flatten(-2)[..., :sk]
    pv = torch.einsum("bngqk,bknd->bqngd", pw, v.to(torch.float32))
    l = (p.sum(dim=-1) * w).sum(dim=-1)  # (B, Hkv, G, Sq)
    out = pv / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, h, d).to(torch.bfloat16)


def _check(q, k, v):
    """Raise ValueError for what the kernel does not take, on the card and
    on the CPU alike; returns q as a contiguous bf16 tensor."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B, Sq, H, D) and K, V (B, Sk, Hkv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv or sq < 1 or sk < 1:
        raise ValueError(f"flash_attention: K, V {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not takes(d, h // hkv):
        raise ValueError(f"flash_attention: the kernel takes head_dim {HEAD_DIM}, got {d}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != torch.bfloat16 or not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous bf16 tensor on "
                             f"{q.device}, got {x.dtype} on {x.device}")
    return q.to(torch.bfloat16).contiguous()


def _launch(q, k, v, causal: bool, sm_scale: float) -> torch.Tensor:
    lib = _lib()
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kv_len = kv_rows(sq, sk, causal)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ao_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     b, sq, sk, h, hkv, kv_len, sm_scale, int(causal), stream)
    if err < 0:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed (CUresult {-err}); "
                           f"q, K and V must be 16-byte aligned")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, sm_scale=None) -> torch.Tensor:
    """Prefill attention: q (B, Sq, H, D), K and V (B, Sk, Hkv, D) bf16 with
    H a multiple of Hkv. Returns (B, Sq, H, D) bf16: the kernel on CUDA
    tensors, its plain version on CPU tensors."""
    q = _check(q, k, v)
    sm_scale = float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    return _launch(q, k, v, causal, sm_scale)


flash_attention.launches = 0  # kernel launches (not plain-version calls)


def traffic(q_shape, kv_shape, causal: bool = True):
    """(bytes, flops) the function needs: q and the K and V rows it attends
    to (bf16) read once, the bf16 output written once; 4 * D flops per
    (query, key) pair the mask keeps, for every query head. Causally (top-left
    aligned) row i keeps min(i + 1, Sk) keys, so only the first min(Sq, Sk)
    cache rows are needed."""
    b, sq, h, d = q_shape
    sk, hkv = kv_shape[1], kv_shape[2]
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    kv_rows = min(sq, sk) if causal else sk
    nbytes = 2 * b * sq * h * d * 2 + 2 * b * kv_rows * hkv * d * 2
    return nbytes, 4 * b * h * d * pairs
