"""Paged KV cache: a page pool per layer and block tables, with bf16, int8,
fp8 (e4m3) or int4 pages.

PyTorch port of ``ao_tpu/serving/paged.py``. Memory for a sequence is
allocated page by page as it grows, so ``max_seq`` reserves no device
memory per slot.

Device state per layer, one pool for K and one for V, updated in place:

* ``PagedKVPool.pages``: (num_pages, page_size, Hkv, D) bf16, int8 or
  e4m3; for int4 (num_pages, page_size, Hkv, D/8) int32 in the slot
  cache's "ch4" form (``serving/kvcache.py``): 8 channel nibbles u = q + 8
  per word, so a token's append is a whole-word store. The reference packs
  8 tokens per word along the page instead and merges nibbles into words
  (read-modify-write); the values are the same.
* ``PagedKVPool.scale`` (quantized pools): (num_pages, Hkv, page_size) f32,
  one scale per cached vector, head-major so that K9's 64 positions of one
  kv head inside a page read their scales as one contiguous run. The
  reference keeps (num_pages, page_size, Hkv, 1).

Quantization is the reference's ``_quant`` bit for bit; ``gather``
dequantizes as the reference's does. Sequence state, shared across layers:
a block table (max_seqs, max_pages) int32 of page ids and lengths
(max_seqs,) int32. Page 0 is the null page: block-table entries a sequence
has not claimed stay 0, in bounds.

The host-side :class:`PageAllocator` hands out and reclaims page ids.
``paged_attention`` runs K9 (``ops/hopper/paged_attention.py``) in the
pool's mode on CUDA tensors ("fp" for bf16, "vec8" for int8 and fp8,
"int4") and the reference's gather path elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ao_tpu_torch.serving.kvcache import _STORAGE, _pack_channels, quantize_vectors, stored_values

_QUANTIZED = ("int8", "float8_e4m3fn", "int4")  # the reference's pool dtypes besides bf16


class PageAllocator:
    """Host-side free list of page ids (page 0 is reserved as the null
    page so block-table entries not yet claimed stay in bounds)."""

    def __init__(self, num_pages: int):
        self.free: List[int] = list(range(num_pages - 1, 0, -1))

    def alloc(self) -> int:
        if not self.free:
            raise RuntimeError("KV page pool exhausted")
        return self.free.pop()

    def release(self, pages: List[int]) -> None:
        for p in pages:
            if p != 0:
                self.free.append(p)


@dataclasses.dataclass(eq=False)
class PagedKVPool:
    """One layer's K or V page pool, written in place."""

    pages: torch.Tensor  # (P, page_size, Hkv, D), int4: (P, page_size, Hkv, D/8) int32
    scale: Optional[torch.Tensor] = None  # (P, Hkv, page_size) f32, quantized pools
    page_size: int = 16
    dtype_name: str = "bf16"

    @classmethod
    def create(cls, num_pages: int, page_size: int, n_kv_heads: int, head_dim: int,
               dtype_name: str = "bf16", device="cuda") -> "PagedKVPool":
        if dtype_name == "bf16":
            return cls(pages=torch.zeros((num_pages, page_size, n_kv_heads, head_dim),
                                         dtype=torch.bfloat16, device=device),
                       page_size=page_size)
        if dtype_name not in _QUANTIZED:
            hint = (" (an e5m2 cache is a slot cache, serving/kvcache.py)"
                    if dtype_name == "float8_e5m2" else "")
            raise ValueError(f"page pool dtype must be bf16 or one of {_QUANTIZED}, "
                             f"got {dtype_name!r}{hint}")
        row = head_dim
        if dtype_name == "int4":
            if page_size % 8:
                raise ValueError(f"int4 pages need page_size % 8 == 0, got {page_size}")
            if head_dim % 8:
                raise ValueError(f"int4 pages need head_dim % 8 == 0, got {head_dim}")
            row = head_dim // 8
        return cls(pages=torch.zeros((num_pages, page_size, n_kv_heads, row),
                                     dtype=_STORAGE[dtype_name], device=device),
                   scale=torch.zeros((num_pages, n_kv_heads, page_size), dtype=torch.float32,
                                     device=device),
                   page_size=page_size, dtype_name=dtype_name)

    def _quant(self, x: torch.Tensor):
        """x (..., Hkv, D) → (stored values, scale (..., Hkv, 1) f32 or None):
        the reference's ``_quant``; int4 values as packed "ch4" words."""
        if self.dtype_name == "bf16":
            return x.to(torch.bfloat16), None
        q, s = quantize_vectors(x, self.dtype_name)
        return (_pack_channels(q) if self.dtype_name == "int4" else q), s

    def append_token(self, x: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor) -> "PagedKVPool":
        """Write one new token per sequence, in place: x (B, Hkv, D);
        block_table (B, max_pages); lengths (B,) = positions BEFORE this
        token. Returns the pool."""
        lengths = lengths.long()
        page_ids = torch.gather(block_table.long(), 1, (lengths // self.page_size)[:, None])[:, 0]
        offs = lengths % self.page_size
        q, s = self._quant(x)
        self.pages[page_ids, offs] = q
        if s is not None:
            self.scale[page_ids, :, offs] = s[..., 0]
        return self

    def write_prompt(self, x: torch.Tensor, page_ids: torch.Tensor) -> "PagedKVPool":
        """Bulk-write a prefill, in place: x (n_pages * page_size, Hkv, D)
        padded; page_ids (n_pages,) destination pages. Returns the pool."""
        n, ps = page_ids.shape[0], self.page_size
        q, s = self._quant(x)
        page_ids = page_ids.long()
        self.pages[page_ids] = q.reshape(n, ps, *q.shape[1:])
        if s is not None:
            self.scale[page_ids] = s.reshape(n, ps, -1).transpose(1, 2)
        return self

    def gather(self, block_table_row: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
        """Materialize the (..., max_pages * page_size, Hkv, D) values of the
        pages of a (..., max_pages) block-table row, dequantized as the
        reference's ``gather``: (value * scale) in f32, cast to
        ``out_dtype``."""
        row = block_table_row.long()
        x = stored_values(self.pages[row])  # (..., mp, ps, Hkv, D)
        if self.scale is not None:
            x = x * self.scale[row].transpose(-1, -2)[..., None]
        *lead, mp, ps, hkv, d = x.shape
        return x.reshape(*lead, mp * ps, hkv, d).to(out_dtype)


def paged_decode_attention_reference(q: torch.Tensor, k_pool: PagedKVPool, v_pool: PagedKVPool,
                                     block_table: torch.Tensor, lengths: torch.Tensor,
                                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """The reference's gather path: every sequence's pages gathered into a
    dense (T, Hkv, D) f32 cache (``gather``, dequantized), then decode
    attention in f32 over q as given, masked to -1e30 at positions >=
    lengths. Returns (B, H, D) f32."""
    b, h, d = q.shape
    hkv = k_pool.pages.shape[2]
    g = h // hkv
    sm = sm_scale if sm_scale is not None else d ** -0.5
    kk, vv = (torch.repeat_interleave(pool.gather(block_table, torch.float32), g, dim=2)
              for pool in (k_pool, v_pool))  # (B, T, H, D)
    s = torch.einsum("bhd,bthd->bht", q.to(torch.float32), kk) * sm
    mask = torch.arange(s.shape[-1], device=q.device)[None, None, :] < lengths.reshape(b, 1, 1)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bthd->bhd", p, vv)


def paged_attention(q, k_pool: PagedKVPool, v_pool: PagedKVPool, block_table, lengths,
                    sm_scale=None) -> torch.Tensor:
    """Dispatching entry: K9 in the pool's mode on CUDA tensors outside the
    "torch" backend, for the shapes K9 takes (H a multiple of Hkv,
    ``paged_attention.takes``: head_dim 128 and at most 8 query heads per
    kv head; page_size % 8 == 0); the reference's gather path elsewhere, as
    after the reference's UnsupportedShape. The reference also needs
    page_size % 128 for a quantized pool (a TPU lane rule); K9 takes every
    page_size % 8 == 0."""
    from ao_tpu_torch.ops import kernels
    from ao_tpu_torch.ops.hopper import paged_attention as k9

    b, h, d = q.shape
    hkv, ps = k_pool.pages.shape[2], k_pool.page_size
    if (q.device.type == "cuda" and kernels.get_backend() != "torch"
            and ps % 8 == 0 and h % hkv == 0 and k9.takes(d, h // hkv)):
        if k_pool.scale is None:
            return k9.paged_decode_attention(q, k_pool.pages, v_pool.pages, block_table, lengths,
                                             sm_scale=sm_scale)
        wrapper = (k9.paged_decode_attention_int4 if k_pool.dtype_name == "int4"
                   else k9.paged_decode_attention_vec8)
        return wrapper(q, k_pool.pages, k_pool.scale, v_pool.pages, v_pool.scale, block_table,
                       lengths, sm_scale=sm_scale)
    return paged_decode_attention_reference(q, k_pool, v_pool, block_table, lengths,
                                            sm_scale=sm_scale)
