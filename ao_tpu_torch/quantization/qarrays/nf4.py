"""NF4Array — 4-bit NormalFloat (QLoRA) with double-quantized scalers.

PyTorch port of ``ao_tpu/quantization/qarrays/nf4.py``, bit for bit.

Layout: (K, N) weights, blocks of ``block_size`` rows along K. The code
nibbles are packed in the int4 "magic" layout (K/8, N) with group
``block_size`` (the operand of the Hopper LUT kernel K15) when K/block_size
% 4 == 0 and K % 128 == 0, else as split-half bytes. Scalers are
double-quantized: the per-block absmax, centred on its mean, is quantized to
int8 against one absmax factor per ``scaler_block_size`` scalers.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ao_tpu_torch.quantization import primitives as P
from ao_tpu_torch.quantization.qarrays.base import QuantizedArray, meta, qarray_dataclass
from ao_tpu_torch.quantization.qarrays.int4 import (
    pack_int4, pack_int4_magic, unpack_int4, unpack_int4_magic,
)

# the QLoRA NF4 codebook (public constants)
NF4_CODEBOOK = torch.tensor(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=torch.float32,
)
_MIDPOINTS = (NF4_CODEBOOK[1:] + NF4_CODEBOOK[:-1]) / 2.0  # (15,)

_WINDOW = 32


def _nearest_code(xn: torch.Tensor) -> torch.Tensor:
    """Index of the nearest codebook entry: the count of midpoints below x.
    A binary search, not a broadcast against the 15 midpoints, whose (..., 15)
    intermediate would need 15x the weight's memory (the lm_head alone has
    525 M weights)."""
    mid = _MIDPOINTS.to(xn.device)
    return torch.searchsorted(mid, xn.contiguous(), side="left").to(torch.uint8)


def _mean_f32(a: torch.Tensor) -> torch.Tensor:
    """Mean of a 2-D f32 tensor, summed in the reference's order: every axis
    longer than 32 is cut into windows of 32 (zero-padded evenly at both
    ends), each window summed one element after another in row-major order,
    until no axis is longer than 32; the rest is summed in row-major order,
    then multiplied by f32(1/n). The same sum as the reference's, so the
    scalers' mean, and every quantized scaler, are its bits."""
    n = a.numel()
    while max(a.shape) > _WINDOW:
        pads, wins = [], []
        for d in a.shape:
            p = (-d) % _WINDOW if d > _WINDOW else 0
            pads.append((p // 2, p - p // 2))
            wins.append(_WINDOW if d > _WINDOW else d)
        a = F.pad(a, (*pads[1], *pads[0]))
        (r, c), (w0, w1) = a.shape, wins
        blocks = a.reshape(r // w0, w0, c // w1, w1)
        acc = torch.zeros((r // w0, c // w1), dtype=torch.float32, device=a.device)
        for i in range(w0):
            for j in range(w1):
                acc = acc + blocks[:, i, :, j]
        a = acc
    total = torch.zeros((), dtype=torch.float32, device=a.device)
    for v in a.reshape(-1):
        total = total + v
    return total * torch.tensor(1.0 / n, dtype=torch.float32, device=a.device)


@qarray_dataclass
class NF4Array(QuantizedArray):
    qdata: torch.Tensor  # uint8 (K/2, N) split-half, or int32 (K/8, N) magic
    quantized_scalers: torch.Tensor  # int8 (ceil(K/bs * N / sbs), sbs), zero-padded
    quantization_factor: torch.Tensor  # f32 (blocks, 1), one per scaler block
    scaler_mean: torch.Tensor  # f32 scalar ()
    block_size: Tuple[int, ...] = meta(default=())
    scaler_block_size: int = meta(default=256)
    _shape: Tuple[int, ...] = meta(default=())
    _dequant_dtype: str = meta(default="bfloat16")

    @property
    def layout(self) -> str:
        return "magic" if self.qdata.dtype == torch.int32 else "halves"

    def to_layout(self, layout: str) -> "NF4Array":
        """Repack the codes between the split-half and magic layouts."""
        if layout == self.layout:
            return self
        codes = self.unpack()
        if layout == "halves":
            return self.replace(qdata=pack_int4(codes, self.block_size[0], axis=-2))
        if layout == "magic":
            return self.replace(qdata=pack_int4_magic(codes, self.block_size[0]))
        raise ValueError(layout)

    @classmethod
    def from_hp(
        cls,
        hp: torch.Tensor,
        block_size: int = 64,
        scaler_block_size: int = 256,
        dequant_dtype: str = "bfloat16",
    ) -> "NF4Array":
        if hp.ndim != 2:
            raise ValueError("NF4 weights must be 2-D (K, N)")
        k, n = hp.shape
        if k % block_size != 0:
            raise ValueError(f"K={k} not divisible by block_size={block_size}")
        nblocks = k // block_size
        w = hp.to(torch.float32)
        bs_tuple = (block_size, 1)
        scaler = torch.clamp(P.block_reduce(w, bs_tuple, "absmax"), min=1e-12)  # (K/bs, N)

        # double quantization of the scalers
        mean = _mean_f32(scaler)
        flat = (scaler - mean).reshape(-1)
        total = flat.shape[0]
        sbs = scaler_block_size
        pad = (-total) % sbs
        if pad:
            flat = F.pad(flat, (0, pad))
        blocks = flat.reshape(-1, sbs)
        qfac = torch.clamp(torch.amax(torch.abs(blocks), dim=1, keepdim=True), min=1e-12) / 127.0
        qs = torch.clamp(torch.round(blocks / qfac), -127, 127).to(torch.int8)

        # the values are quantized against the dequantized scalers
        dq_scaler = (qs.to(torch.float32) * qfac).reshape(-1)[:total].reshape(nblocks, n) + mean
        dq_scaler = torch.clamp(dq_scaler, min=1e-12)
        xn = P.apply_blockwise(w, bs_tuple, lambda wb, s: wb / s, dq_scaler)
        codes = _nearest_code(torch.clamp(xn, -1.0, 1.0))
        if nblocks % 4 == 0 and k % 128 == 0:
            qdata = pack_int4_magic(codes, block_size)
        else:
            qdata = pack_int4(codes, block_size, axis=-2)
        return cls(
            qdata=qdata,
            quantized_scalers=qs,
            quantization_factor=qfac,
            scaler_mean=mean,
            block_size=bs_tuple,
            scaler_block_size=sbs,
            _shape=(k, n),
            _dequant_dtype=dequant_dtype,
        )

    def _scalers(self) -> torch.Tensor:
        """The f32 (K/bs, N) scalers, dequantized from int8."""
        k, n = self.shape
        nblocks = k // self.block_size[0]
        dq = self.quantized_scalers.to(torch.float32) * self.quantization_factor
        return dq.reshape(-1)[: nblocks * n].reshape(nblocks, n) + self.scaler_mean

    def unpack(self) -> torch.Tensor:
        """uint8 code values 0..15, logical (K, N)."""
        if self.layout == "magic":
            return unpack_int4_magic(self.qdata, self.block_size[0])
        return unpack_int4(self.qdata, self.block_size[0], axis=-2)

    def dequantize(self, output_dtype=None) -> torch.Tensor:
        out_dtype = output_dtype or self.dtype
        codes = self.unpack().to(torch.int64)
        vals = NF4_CODEBOOK.to(codes.device)[codes]
        out = P.apply_blockwise(vals, self.block_size, lambda v, s: v * s, self._scalers())
        return out.to(out_dtype)
