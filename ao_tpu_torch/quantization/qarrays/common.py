"""Shared specs for quantized arrays.

PyTorch port of ``ao_tpu/quantization/qarrays/common.py``. Linear weights
are stored **(in_features, out_features) = (K, N)**, as in the reference,
not torch's usual (out, in): groupwise quantization groups along axis 0, the
contraction dim, and params carry across the two packages unchanged.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class KernelPreference(enum.Enum):
    """Which backend computes the hot op for a quantized array.

    The reference's PALLAS maps to CUDA (hand-written Hopper kernels); its
    XLA and EMULATED backends both map to TORCH, the plain PyTorch path.
    """

    AUTO = "auto"  # the kernel on a CUDA tensor, its plain version on the CPU
    CUDA = "cuda"
    TORCH = "torch"


@dataclasses.dataclass(frozen=True)
class ActQuantSpec:
    """Static description of how to quantize activations on the fly.
    (ref: ao_tpu qarrays/common.py:33)"""

    dtype: str = "int8"  # "int8" | "float8_e4m3fn" | "float8_e5m2"
    symmetric: bool = True
    # "per_token" (one scale per row), "per_tensor", or "per_group:<g>"
    granularity: str = "per_token"
    value_lb: Optional[float] = None
    value_ub: Optional[float] = None

    def group_size(self) -> Optional[int]:
        if self.granularity.startswith("per_group:"):
            return int(self.granularity.split(":", 1)[1])
        return None


def canon_dtype(name: str) -> torch.dtype:
    """The torch dtype of a dtype name of the reference's configs and
    activation specs. (ref: ao_tpu qarrays/common.py:68; torch has no int4
    dtype, so "int4" is not a name here)"""
    return {
        "int8": torch.int8,
        "float8_e4m3fn": torch.float8_e4m3fn,
        "float8_e5m2": torch.float8_e5m2,
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
    }[name]


def col_major(q: torch.Tensor) -> torch.Tensor:
    """The same values with the last two dims stored column-major: a (K, N)
    weight keeps its logical shape and holds each column's K values
    contiguously, the "TN" layout that the int8 and fp8 GEMMs (cuBLAS's
    ``torch._int_mm`` and ``torch._scaled_mm``, and the kernels K10 and K17)
    read without a copy per call."""
    if q.ndim < 2 or q.transpose(-1, -2).is_contiguous():
        return q
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)
