"""Paged KV cache: a page pool per layer and block tables, bf16 pages.

PyTorch port of ``ao_tpu/serving/paged.py``. Memory for a sequence is
allocated page by page as it grows, so ``max_seq`` reserves no device
memory per slot.

Device state per layer: ``PagedKVPool.pages`` (num_pages, page_size, Hkv,
D) bf16, one pool for K and one for V, updated in place. Sequence state,
shared across layers: a block table (max_seqs, max_pages) int32 of page ids
and lengths (max_seqs,) int32. Page 0 is the null page: block-table entries
a sequence has not claimed stay 0, in bounds.

The host-side :class:`PageAllocator` hands out and reclaims page ids.
``paged_attention`` runs K9 (``ops/hopper/paged_attention.py``) on CUDA
tensors and the reference's gather path elsewhere. The int8, fp8 and int4
pools come with the quantized-pool slice of the port, with K9's "vec8" and
"int4" modes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

_QUANTIZED = ("int8", "float8_e4m3fn", "int4")


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
    """One layer's K or V page pool (bf16), written in place."""

    pages: torch.Tensor  # (P, page_size, Hkv, D)
    page_size: int = 16

    @classmethod
    def create(cls, num_pages: int, page_size: int, n_kv_heads: int, head_dim: int,
               dtype_name: str = "bf16", device="cuda") -> "PagedKVPool":
        if dtype_name in _QUANTIZED:
            raise NotImplementedError(
                f"{dtype_name} page pools come with the quantized-pool slice of the port "
                "(K9's \"vec8\" and \"int4\" modes)")
        if dtype_name != "bf16":
            raise ValueError(f"page pool dtype must be bf16 or one of {_QUANTIZED}, "
                             f"got {dtype_name!r}")
        return cls(pages=torch.zeros((num_pages, page_size, n_kv_heads, head_dim),
                                     dtype=torch.bfloat16, device=device),
                   page_size=page_size)

    def append_token(self, x: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor) -> "PagedKVPool":
        """Write one new token per sequence, in place: x (B, Hkv, D);
        block_table (B, max_pages); lengths (B,) = positions BEFORE this
        token. Returns the pool."""
        lengths = lengths.long()
        page_ids = torch.gather(block_table.long(), 1, (lengths // self.page_size)[:, None])[:, 0]
        self.pages[page_ids, lengths % self.page_size] = x.to(torch.bfloat16)
        return self

    def write_prompt(self, x: torch.Tensor, page_ids: torch.Tensor) -> "PagedKVPool":
        """Bulk-write a prefill, in place: x (n_pages * page_size, Hkv, D)
        padded; page_ids (n_pages,) destination pages. Returns the pool."""
        n = page_ids.shape[0]
        self.pages[page_ids.long()] = x.reshape(n, self.page_size, *x.shape[1:]).to(torch.bfloat16)
        return self

    def gather(self, block_table_row: torch.Tensor) -> torch.Tensor:
        """Materialize one sequence's (max_pages * page_size, Hkv, D) bf16
        rows."""
        x = self.pages[block_table_row.long()]
        mp, ps, hkv, d = x.shape
        return x.reshape(mp * ps, hkv, d)


def paged_decode_attention_reference(q: torch.Tensor, k_pool: PagedKVPool, v_pool: PagedKVPool,
                                     block_table: torch.Tensor, lengths: torch.Tensor,
                                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """The reference's gather path: every sequence's pages gathered into a
    dense (T, Hkv, D) f32 cache, then decode attention in f32 over q as
    given, masked to -1e30 at positions >= lengths. Returns (B, H, D) f32."""
    b, h, d = q.shape
    hkv = k_pool.pages.shape[2]
    g = h // hkv
    sm = sm_scale if sm_scale is not None else d ** -0.5
    kk, vv = (torch.repeat_interleave(
        pool.pages[block_table.long()].to(torch.float32).reshape(b, -1, hkv, d), g, dim=2)
        for pool in (k_pool, v_pool))  # (B, T, H, D)
    s = torch.einsum("bhd,bthd->bht", q.to(torch.float32), kk) * sm
    mask = torch.arange(s.shape[-1], device=q.device)[None, None, :] < lengths.reshape(b, 1, 1)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bthd->bhd", p, vv)


def paged_attention(q, k_pool: PagedKVPool, v_pool: PagedKVPool, block_table, lengths,
                    sm_scale=None) -> torch.Tensor:
    """Dispatching entry: K9 on CUDA tensors, inside the reference's route
    (head_dim % 128 == 0, page_size % 8 == 0, H a multiple of Hkv) and
    outside the "torch" backend; the reference's gather path elsewhere. A
    shape inside the route that K9 does not take makes its wrapper raise."""
    from ao_tpu_torch.ops import kernels

    b, h, d = q.shape
    hkv, ps = k_pool.pages.shape[2], k_pool.page_size
    if (q.device.type == "cuda" and kernels.get_backend() != "torch"
            and d % 128 == 0 and ps % 8 == 0 and h % hkv == 0):
        from ao_tpu_torch.ops.hopper.paged_attention import paged_decode_attention

        return paged_decode_attention(q, k_pool.pages, v_pool.pages, block_table, lengths,
                                      sm_scale=sm_scale)
    return paged_decode_attention_reference(q, k_pool, v_pool, block_table, lengths,
                                            sm_scale=sm_scale)
