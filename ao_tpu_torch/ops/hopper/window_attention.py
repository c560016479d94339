"""Windowed / global attention with the decomposed rel-pos bias on Hopper: K16.

Counterpart of ``ao_tpu/ops/pallas/window_attention.py::window_bias_attention``
(kernels ``_kernel_heads`` and ``_kernel_single``): for q, k, v (G, T, nh, hd)
over a square grid of T = side^2 tokens and the decomposed terms rel_h,
rel_w (G, nh, T, side),

    s = q . k^T * scale + rel_h[.., q, k // side] + rel_w[.., q, k % side]
    out = softmax(s over the T keys) . v,  (G, T, nh * hd) bf16.

The CUDA source ``csrc/window_attention.cu`` says what bounds the kernel and
how its design meets it: a streamed online softmax over 64-key tiles on the
shared attention mainloop (``csrc/attn_mainloop.cuh``), so it takes the
global layers' side 64 (T = 4096), which the TPU kernel refuses for lack of
VMEM. ``window_bias_attention`` runs the kernel on CUDA tensors
and its plain PyTorch version on CPU tensors; ``takes(side, head_dim)`` says
which shapes the kernel takes, and the route in ``models/sam.py`` asks it
before the call. q, k, v and the rel terms are taken in bf16, as the
reference's kernel takes them.
"""

from __future__ import annotations

import ctypes

import torch

from ao_tpu_torch.ops.hopper import build

# what window_attention.cu takes, its keys per tile of the online softmax,
# which the plain version's roundings follow, and its query rows a CTA
# (checked against the library when it loads)
HEAD_DIM = 64
MAX_SIDE = 64
BLOCK_K = 64
BLOCK_Q = 128


def takes(side: int, head_dim: int) -> bool:
    """Whether K16 takes a grid of ``side`` x ``side`` tokens at this head
    dim: head_dim 64 (SAM-B and SAM-L), any side up to 64 (image 1024 at
    patch 16)."""
    return head_dim == HEAD_DIM and 1 <= side <= MAX_SIDE


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("window_attention")
        fn = lib.ao_window_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name, want in (("ao_window_attention_head_dim", HEAD_DIM),
                           ("ao_window_attention_max_side", MAX_SIDE),
                           ("ao_window_attention_block_k", BLOCK_K),
                           ("ao_window_attention_block_q", BLOCK_Q)):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
            if getattr(lib, name)() != want:
                raise RuntimeError(f"window_attention.cu: {name} is not {want}")
        _LIB = lib
    return _LIB


def window_bias_attention_plain(q, k, v, rel_h, rel_w, side: int, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, to its roundings: q, k, v and
    the rel terms in bf16; f32 scores (s * scale + rel_h) + rel_w; keys in
    tiles of BLOCK_K with a running row max m_j (the max over tiles 0..j);
    tile j contributes bf16(exp(s - m_j)) . v and the f32 sum of
    exp(s - m_j), each scaled by exp(m_j - m_last); out = the scaled
    products / the scaled sums, bf16 (G, T, nh * hd). Windows go in chunks
    that keep each chunk's (T, T) scores near 256 MB."""
    g, t, nh, hd = q.shape
    nt = -(-t // BLOCK_K)
    cols = torch.arange(t, device=q.device)
    f = lambda x: x.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    out = torch.empty((g, t, nh * hd), dtype=torch.bfloat16, device=q.device)
    chunk = max(1, (256 << 20) // (nh * t * t * 4))
    for g0 in range(0, g, chunk):
        sl = slice(g0, g0 + chunk)
        s = torch.einsum("bqhd,bkhd->bhqk", f(q[sl]), f(k[sl])) * scale
        s = (s + f(rel_h[sl])[..., cols // side]) + f(rel_w[sl])[..., cols % side]
        s = torch.nn.functional.pad(s, (0, nt * BLOCK_K - t), value=-torch.inf)
        s = s.reshape(*s.shape[:-1], nt, BLOCK_K)
        m = torch.cummax(s.amax(dim=-1), dim=-1).values  # (b, nh, T, nt)
        p = torch.exp(s - m[..., None])
        w = torch.exp(m - m[..., -1:])
        pw = (p.to(torch.bfloat16).to(torch.float32) * w[..., None]).flatten(-2)[..., :t]
        l = (p.sum(dim=-1) * w).sum(dim=-1)  # (b, nh, T)
        o = torch.einsum("bhqk,bkhd->bqhd", pw, f(v[sl])) / l.transpose(1, 2)[..., None]
        out[sl] = o.reshape(o.shape[0], t, nh * hd).to(torch.bfloat16)
        del s, p, pw
    return out


def _check(q, k, v, rel_h, rel_w, side: int):
    """Raise ValueError for what the kernel does not take, on the card and
    on the CPU alike."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"window_bias_attention: q, k, v must be one (G, T, nh, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    g, t, nh, hd = q.shape
    if t != side * side:
        raise ValueError(f"window_bias_attention: T={t} != side^2={side * side}")
    if not takes(side, hd):
        raise ValueError(f"window_bias_attention: the kernel takes head_dim {HEAD_DIM} and a "
                         f"side up to {MAX_SIDE}, got head_dim {hd}, side {side}")
    for name, r in (("rel_h", rel_h), ("rel_w", rel_w)):
        if tuple(r.shape) != (g, nh, t, side):
            raise ValueError(f"window_bias_attention: {name} must be {(g, nh, t, side)}, "
                             f"got {tuple(r.shape)}")


def _launch(q, k, v, rel_h, rel_w, side: int, scale: float) -> torch.Tensor:
    g, t, nh, hd = q.shape
    dev = q.device
    args = [x.to(torch.bfloat16).contiguous() for x in (q, k, v, rel_h, rel_w)]
    for x in args:
        if x.device != dev:
            raise ValueError(f"window_bias_attention: every operand must be on {dev}")
    out = torch.empty((g, t, nh * hd), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ao_window_attention(*(x.data_ptr() for x in args), out.data_ptr(), g, t,
                                         side, nh, float(scale), stream)
    if err < 0:
        raise RuntimeError(f"window_bias_attention: cuTensorMapEncodeTiled failed (CUresult "
                           f"{-err}); q, k and v must be 16-byte aligned")
    if err != 0:
        raise RuntimeError(f"window_bias_attention kernel launch failed: CUDA error {err}")
    window_bias_attention.launches += 1
    return out


def window_bias_attention(q, k, v, rel_h, rel_w, *, side: int, scale: float) -> torch.Tensor:
    """q, k, v (G, T, nh, hd) with T == side * side; rel_h, rel_w (G, nh, T,
    side). Returns (G, T, nh * hd) bf16: the kernel on CUDA tensors, its
    plain version on CPU tensors."""
    _check(q, k, v, rel_h, rel_w, side)
    if q.device.type == "cpu":
        return window_bias_attention_plain(q, k, v, rel_h, rel_w, side, scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_bias_attention runs on cuda or cpu tensors, not {q.device}")
    return _launch(q, k, v, rel_h, rel_w, side, scale)


window_bias_attention.launches = 0  # kernel launches (not plain-version calls)


def traffic(g: int, t: int, nh: int, hd: int, side: int):
    """(bytes, flops) the function needs: q, k, v and the rel terms (bf16)
    read once, the bf16 output written once; 4 * hd flops per (query, key)
    pair of every head."""
    nbytes = 4 * g * t * nh * hd * 2 + 2 * g * nh * t * side * 2
    return nbytes, 4 * g * nh * t * t * hd
