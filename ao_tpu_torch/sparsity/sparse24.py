"""2:4 semi-structured sparsity.

PyTorch port of the inference half of ``ao_tpu/sparsity/sparse24.py``: the
prune / compress / decompress functions and the two compressed containers.
Layout (weights (K, N), groups of 4 along K):

  values: (K/2, N)  — the two kept values per group, in ascending position
  meta:   (K/4, N) uint8 — idx0 | (idx1 << 2), idx0 < idx1 in {0..3}

Every argsort is stable, as ``jnp.argsort`` is, so groups with ties keep
the reference's positions. The reference multiplies by bool masks, which
XLA computes as a select in f32 and as a product in bf16 (``times_mask``), so
a pruned position of a bf16 group whose two kept values are negative
dequantizes to -0.0 and an f32 one to +0.0; the port does the same, and
``dequantize`` is bit for bit.
``ops/linear.py`` dequantizes these and runs one ``torch.matmul``, as the
reference does (its TPU has no sparse matrix unit). The runtime-sparsified
training linears (``semi_sparse_linear``, ``semi_sparse_activation_linear``)
come with the training slice of the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ao_tpu_torch.quantization import primitives as P
from ao_tpu_torch.quantization.qarrays.base import QuantizedArray, meta, qarray_dataclass


def top2_mask(score: torch.Tensor, dim: int) -> torch.Tensor:
    """True at the two largest of every 4 along ``dim`` (ties to the later
    position, as the reference's double argsort ranks them)."""
    order = torch.argsort(score, dim=dim, stable=True)  # ascending
    ranks = torch.argsort(order, dim=dim, stable=True)
    return ranks >= 2


def times_mask(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The reference's ``v * mask`` (a bool mask) as XLA computes it on the
    CPU: a select in f32 (a masked-out position is +0.0), a product in bf16
    (a masked-out negative value gives -0.0)."""
    if v.dtype == torch.bfloat16:
        return v * mask
    return torch.where(mask, v, 0)


def prune_2to4(w: torch.Tensor) -> torch.Tensor:
    """Magnitude-prune to 2:4 along axis -2: zero the 2 smallest |w| in
    every contiguous group of 4. Returns the dense pruned weight."""
    k = w.shape[-2]
    if k % 4 != 0:
        raise ValueError(f"K={k} must be a multiple of 4")
    shape = w.shape
    wg = w.reshape(shape[:-2] + (k // 4, 4) + shape[-1:])
    return times_mask(wg, top2_mask(torch.abs(wg), -2)).reshape(shape)


def compress_2to4(w_pruned: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense 2:4-pruned (K, N) -> (values (K/2, N), meta (K/4, N) uint8)."""
    k, n = w_pruned.shape[-2], w_pruned.shape[-1]
    shape = w_pruned.shape
    wg = w_pruned.reshape(shape[:-2] + (k // 4, 4, n))
    # positions of the kept elements: sort by (is_zero, position), the first
    # two entries are the kept ones (zeros by position in a sparser group)
    pos = torch.arange(4, device=wg.device).reshape((1,) * (wg.ndim - 2) + (4, 1))
    order = torch.argsort(torch.where(wg != 0, pos, pos + 4), dim=-2, stable=True)
    idx0, idx1 = order[..., 0:1, :], order[..., 1:2, :]
    lo, hi = torch.minimum(idx0, idx1), torch.maximum(idx0, idx1)
    v0 = torch.take_along_dim(wg, lo, dim=-2)
    v1 = torch.take_along_dim(wg, hi, dim=-2)
    values = torch.cat([v0, v1], dim=-2).reshape(shape[:-2] + (k // 2, n))
    mb = (lo | (hi << 2)).to(torch.uint8).reshape(shape[:-2] + (k // 4, n))
    return values, mb


def decompress_2to4(values: torch.Tensor, mb: torch.Tensor) -> torch.Tensor:
    """Inverse of compress: (K/2, N) + meta -> dense (K, N)."""
    kq, n = mb.shape[-2], mb.shape[-1]
    shape = mb.shape
    vals = values.reshape(shape[:-2] + (kq, 2, n))
    v0, v1 = vals[..., 0, :], vals[..., 1, :]
    lo = (mb & 0x3).to(torch.int32)
    hi = ((mb >> 2) & 0x3).to(torch.int32)
    out = torch.zeros(shape[:-2] + (kq, 4, n), dtype=values.dtype, device=values.device)
    for p in range(4):
        out[..., p, :] = (times_mask(v0, lo == p) + times_mask(v1, hi == p)).to(values.dtype)
    return out.reshape(shape[:-2] + (kq * 4, n))


def prune_2to4_lastdim(x: torch.Tensor) -> torch.Tensor:
    """Keep the 2 largest-|x| of every 4 along the LAST axis."""
    shape = x.shape
    if shape[-1] % 4:
        raise ValueError(f"last dim {shape[-1]} not a multiple of 4")
    g = x.reshape(*shape[:-1], shape[-1] // 4, 4)
    return torch.where(top2_mask(torch.abs(g), -1), g, 0).reshape(shape)


@qarray_dataclass
class Sparse24Array(QuantizedArray):
    """2:4 compressed weight."""

    values: torch.Tensor  # (K/2, N)
    metadata: torch.Tensor  # (K/4, N) uint8
    _shape: Tuple[int, ...] = meta(default=())
    _dequant_dtype: str = meta(default="bfloat16")

    @classmethod
    def from_hp(cls, hp: torch.Tensor, dequant_dtype: str = "bfloat16"):
        values, mb = compress_2to4(prune_2to4(hp.to(torch.float32)))
        return cls(values=values.to(getattr(torch, dequant_dtype)), metadata=mb,
                   _shape=tuple(hp.shape), _dequant_dtype=dequant_dtype)

    def dequantize(self, output_dtype=None):
        return decompress_2to4(self.values, self.metadata).to(output_dtype or self.dtype)


def _unpack_nibbles(packed: torch.Tensor, rows: int) -> torch.Tensor:
    """(R/2, N) uint8 of two 4-bit fields (low first along R) -> (R, N)."""
    return torch.stack([packed & 0xF, packed >> 4], dim=1).reshape(rows, packed.shape[-1])


@qarray_dataclass
class Sparse24Int4Array(QuantizedArray):
    """2:4-pruned weight with int4-quantized kept values, both compressed
    (3/8 byte per element): the marlin-sparse analog."""

    qdata: torch.Tensor  # (K/4, N) uint8 — two kept 4-bit codes per group of 4
    metadata: torch.Tensor  # (K/8, N) uint8 — two groups' 2x2-bit positions
    scale: torch.Tensor  # (K/g, N) bf16
    zero_point: torch.Tensor  # (K/g, N) bf16 (tinygemm float domain)
    group_size: int = meta(default=128)
    _shape: Tuple[int, ...] = meta(default=())
    _dequant_dtype: str = meta(default="bfloat16")

    @classmethod
    def from_hp(cls, hp: torch.Tensor, group_size: int = 128,
                dequant_dtype: str = "bfloat16") -> "Sparse24Int4Array":
        k, n = hp.shape
        g = group_size
        if k % max(g, 8) or g % 8:
            raise ValueError(f"K={k} needs K%{max(g, 8)}==0 and g%8==0")
        values, mb = compress_2to4(prune_2to4(hp.to(torch.float32)))  # (K/2, N), (K/4, N)
        # per-(g, 1) qparams of the original groups == per-(g/2, 1) groups of
        # the compressed rows (each group of g keeps exactly g/2 rows, in order)
        block = (g // 2, 1)
        scale, zp = P.choose_qparams_affine_tinygemm(values, block, quant_min=0, quant_max=15)
        codes = P.quantize_affine_tinygemm(values, block, scale, zp, 0, 15).to(torch.uint8)
        return cls(
            qdata=codes[0::2] | (codes[1::2] << 4),  # code pairs along K: (K/4, N)
            metadata=mb[0::2] | (mb[1::2] << 4),  # metadata pairs: (K/8, N)
            scale=scale, zero_point=zp, group_size=g, _shape=(k, n),
            _dequant_dtype=dequant_dtype,
        )

    def dequantize(self, output_dtype=None):
        k, n = self._shape
        codes = _unpack_nibbles(self.qdata, k // 2)
        vals = P.dequantize_affine_tinygemm(codes, (self.group_size // 2, 1), self.scale,
                                            self.zero_point, 0, 15, output_dtype=torch.float32)
        mb = _unpack_nibbles(self.metadata, k // 4)
        return decompress_2to4(vals, mb).to(output_dtype or self.dtype)
