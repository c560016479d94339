"""Quantized KV cache (int8 / fp8 / int4) with per-token-per-head scales.

PyTorch port of ``ao_tpu/serving/kvcache.py``. One layer's K or V cache is
a ``QuantKVCache``: quantized ``qdata`` and f32 scales (B, Hkv, T), one per
cached vector, stored head-major so a decode kernel's 64-position chunk of
one kv head reads its scales as one contiguous run. The numbers are the
reference's bit for bit (``quantize_values``, ``dequantize``):

* ``scale = max(amax over D, 1e-8) / qmax``;
* int8: ``clip(round(x / scale), -127, 127)``;
* fp8: ``clip(x / scale, -qmax, qmax)`` cast to the fp8 type;
* int4: ``clip(round(x / scale), -8, 7) + 8``, an unsigned nibble u;
* ``dequantize()``: ``(value * scale)`` in f32, cast to the output type.

Storage layouts are the port's own (the reference's "kt", "ktp"/"ptok" and
"ck4"/"ptok4" transpose, parity-permute and plane-permute for the TPU's
matrix unit and fold 2^60/2^120 into the fp8 scales; none of that is
carried over):

* ``"tokens"`` (int8, fp8): qdata (B, T, Hkv, D), the reference's own
  tokens layout. A token's D-vector of one head is one contiguous row.
* ``"ch4"`` (int4): qdata (B, T, Hkv, D/8) int32, 8 *channel* nibbles per
  word, channel 8w+o at bits [4o, 4o+4) of word w (the reference's
  ``_kv_shift`` geometry, which "ck4" applies to channels). ``(w >> 4j) &
  0x000F000F | 0x43004300`` is then bf16x2 (128+u) of channels j and j+4,
  the int4 weight kernels' decode, and a decode write is one row with no
  read-modify-write.

The fp8 e5m2 cache (qmax 57344) is stored like e4m3, in "tokens".

``update`` writes in place, at a scalar index or at per-row (B,) indices
(the serving engine's slots), and returns the cache itself;
``insert_slot`` copies a batch-1 prefill cache into one row.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

# the cache dtypes a decode attention kernel serves
_QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0, "float8_e5m2": 57344.0, "int4": 7.0}

_STORAGE = {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn,
            "float8_e5m2": torch.float8_e5m2, "int4": torch.int32}

# the port's layout for each cache dtype
_LAYOUTS = {"int8": "tokens", "float8_e4m3fn": "tokens", "float8_e5m2": "tokens", "int4": "ch4"}

# the reference's TPU layouts, which the port stores in _LAYOUTS instead
_REFERENCE_LAYOUTS = ("kt", "ktp", "ptok", "ck4", "ptok4")


@functools.lru_cache(maxsize=None)
def _nibble_shifts(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """[0, 4, ..., 28] on ``device``, made once: a decode step copies nothing
    from the host."""
    return torch.arange(0, 32, 4, dtype=dtype, device=device)


def _clamped_cols(starts: torch.Tensor, s_tok: int, t: int):
    """(rows, cols, keep) of per-row s-token windows at ``starts`` (B,),
    the reference's deterministic clamp (``kvcache.py::_clamped_cols``):
    positions past t-1 collapse onto t-1 and, among tokens that collide,
    only the last is written (``keep``)."""
    cols = (starts.long()[:, None]
            + torch.arange(s_tok, device=starts.device)[None]).clamp_(max=t - 1)
    keep = torch.ones_like(cols, dtype=torch.bool)
    keep[:, :-1] = cols[:, 1:] != cols[:, :-1]
    rows = torch.arange(cols.shape[0], device=starts.device)[:, None].expand_as(cols)
    return rows, cols, keep


def quantize_vectors(x: torch.Tensor, dtype_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) → (q, scale), one scale per D-vector, the reference's
    ``quantize_values`` and its page pools' ``_quant`` bit for bit: q in
    the storage type of ``dtype_name`` (int4: unsigned nibbles in int32),
    scale (..., 1) f32."""
    qmax = _QMAX[dtype_name]
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / qmax
    v = xf / scale
    if dtype_name == "int8":
        q = torch.round(v).clamp_(-127, 127).to(torch.int8)
    elif dtype_name == "int4":
        q = (torch.round(v).clamp_(-8, 7) + 8).to(torch.int32)
    else:
        q = v.clamp_(-qmax, qmax).to(_STORAGE[dtype_name])
    return q, scale


@dataclasses.dataclass(eq=False)
class QuantKVCache:
    """One layer's K or V cache: quantized qdata + (B, Hkv, T) f32 scales."""

    qdata: torch.Tensor
    scale: torch.Tensor
    dtype_name: str = "int8"
    layout: str = "tokens"

    @classmethod
    def create(cls, batch: int, max_seq: int, n_kv_heads: int, head_dim: int,
               dtype_name: str = "int8", layout: str = None,
               device="cuda") -> "QuantKVCache":
        """An all-zero cache on ``device`` in the port's layout for
        ``dtype_name`` (``_LAYOUTS``); ``layout`` may name it, and a
        reference layout name raises ValueError."""
        if dtype_name not in _QMAX:
            raise ValueError(f"KV cache dtype must be one of {tuple(_QMAX)}, got {dtype_name!r}")
        want = _LAYOUTS[dtype_name]
        if layout is not None and layout != want:
            if layout in _REFERENCE_LAYOUTS:
                raise ValueError(
                    f"layout {layout!r} is the reference's TPU layout; the port stores "
                    f"{dtype_name} caches in its {want!r} layout")
            raise ValueError(f"{dtype_name} KV caches use the {want!r} layout, got {layout!r}")
        if dtype_name == "int4":
            if max_seq % 8:
                raise ValueError(f"int4 KV cache needs max_seq % 8 == 0, got {max_seq}")
            if head_dim % 8:
                raise ValueError(f"int4 KV cache needs head_dim % 8 == 0, got {head_dim}")
            shape = (batch, max_seq, n_kv_heads, head_dim // 8)
        else:
            shape = (batch, max_seq, n_kv_heads, head_dim)
        return cls(
            qdata=torch.zeros(shape, dtype=_STORAGE[dtype_name], device=device),
            scale=torch.zeros((batch, n_kv_heads, max_seq), dtype=torch.float32, device=device),
            dtype_name=dtype_name,
            layout=want,
        )

    @property
    def max_seq(self) -> int:
        return self.scale.shape[2]

    def quantize_values(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, H, D) → (q, scale): q (B, S, H, D) in the storage type
        (int4: unsigned nibbles in int32), scale (B, S, H, 1) f32."""
        return quantize_vectors(x, self.dtype_name)

    def update(self, x: torch.Tensor, index) -> "QuantKVCache":
        """Write x (B, S, H, D) in place at positions [index, index + S) of
        every batch row, or, for a (B,) tensor ``index``, of row b at
        [index[b], index[b] + S) with the reference's clamp at the last
        position (``_clamped_cols``); returns the cache."""
        q, scale = self.quantize_values(x)
        if self.dtype_name == "int4":
            q = _pack_channels(q)  # whole words: a write is a store, no read-modify-write
        sh = scale[..., 0]  # (B, S, H)
        if isinstance(index, torch.Tensor) and index.ndim == 1:
            rows, cols, keep = _clamped_cols(index.to(self.qdata.device), x.shape[1],
                                             self.max_seq)
            if x.shape[1] > 1:  # drop the tokens a later one of their row overwrites
                rows, cols, q, sh = rows[keep], cols[keep], q[keep], sh[keep]
            self.qdata[rows, cols] = q
            self.scale[rows, :, cols] = sh
            return self
        index = int(index)
        s = x.shape[1]
        if index < 0 or index + s > self.max_seq:
            raise ValueError(f"cache window [{index}, {index + s}) outside the cache of "
                             f"{self.max_seq}")
        self.qdata[:, index:index + s] = q
        self.scale[:, :, index:index + s] = sh.transpose(1, 2)
        return self

    def insert_slot(self, other: "QuantKVCache", slot: int) -> "QuantKVCache":
        """Copy ``other``'s (batch 1) rows [0, other.max_seq) into batch row
        ``slot``, in place (the engine's prefill: scratch to pool); returns
        the cache. The two share the port's layout, so no translation."""
        if (type(other) is not type(self) or other.dtype_name != self.dtype_name
                or other.layout != self.layout):
            raise ValueError(f"cannot insert a {other.dtype_name} {other.layout!r} cache into a "
                             f"{self.dtype_name} {self.layout!r} one")
        t = other.max_seq
        self.qdata[slot, :t] = other.qdata[0]
        self.scale[slot, :, :t] = other.scale[0]
        return self

    def dequantize(self, out_dtype=torch.bfloat16) -> torch.Tensor:
        """→ (B, T, Hkv, D) values in ``out_dtype``."""
        sc = self.scale.transpose(1, 2)[..., None]  # (B, T, H, 1)
        return (stored_values(self.qdata) * sc).to(out_dtype)


def _pack_channels(u: torch.Tensor) -> torch.Tensor:
    """Nibbles (..., D) int32 → (..., D/8) int32 words, channel 8w+o at
    bits [4o, 4o+4) of word w."""
    shifts = _nibble_shifts(u.device, torch.int64)
    words = (u.reshape(*u.shape[:-1], -1, 8).to(torch.int64) << shifts).sum(dim=-1)
    return words.to(torch.int32)  # the top nibble wraps into the sign bit


def stored_values(qdata: torch.Tensor) -> torch.Tensor:
    """The values a quantized cache or page pool stores, unscaled, as f32
    (..., D): int8 integers and fp8 (or bf16) values as they are, int4 "ch4"
    words (int32) as their nibbles minus 8."""
    if qdata.dtype == torch.int32:
        return (_unpack_channels(qdata) - 8).to(torch.float32)
    return qdata.to(torch.float32)


def _unpack_channels(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_channels`: (..., D/8) words → (..., D) int32
    nibbles 0..15."""
    u = (words[..., None] >> _nibble_shifts(words.device, torch.int32)) & 0xF
    return u.reshape(*words.shape[:-1], -1)


def init_quant_kv_caches(cfg, batch: int, max_seq: int, dtype_name: str = "int8",
                         device="cuda") -> list:
    """Per-layer [(K cache, V cache)] for ``models/llama.py::forward``, in
    the port's layout for ``dtype_name``, on ``device``."""
    return [
        (QuantKVCache.create(batch, max_seq, cfg.n_kv_heads, cfg.head_dim, dtype_name,
                             device=device),
         QuantKVCache.create(batch, max_seq, cfg.n_kv_heads, cfg.head_dim, dtype_name,
                             device=device))
        for _ in range(cfg.n_layers)
    ]
