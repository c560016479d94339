"""Granularity lattice for quantization schemes.

PyTorch port of ``ao_tpu/quantization/granularity.py``. Granularities are
frozen dataclasses that resolve to a ``block_size`` tuple with the same rank
as the tensor being quantized; scales and zero points then have shape
``tuple(s // b for s, b in zip(shape, block_size))``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Granularity:
    """Base class for all quantization granularities."""


@dataclasses.dataclass(frozen=True)
class PerTensor(Granularity):
    """One scale for the whole tensor."""


@dataclasses.dataclass(frozen=True)
class PerAxis(Granularity):
    """One scale per index of ``axis``; all other dims are reduced."""

    axis: int = 0


@dataclasses.dataclass(frozen=True)
class PerGroup(Granularity):
    """Groupwise along the last dim: one scale per ``group_size`` elements."""

    group_size: int = 128


@dataclasses.dataclass(frozen=True)
class PerRow(Granularity):
    """One scale per row (all dims except ``dim`` reduced)."""

    dim: int = -1


@dataclasses.dataclass(frozen=True)
class PerToken(Granularity):
    """One scale per token: reduces only the last dim (activations)."""


@dataclasses.dataclass(frozen=True)
class PerBlock(Granularity):
    """Explicit block shape, e.g. (1, 128) activations / (128, 128) weights
    for DeepSeek-style blockwise fp8."""

    block_size: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "block_size", tuple(self.block_size))


def get_block_size(shape: Sequence[int], granularity: Granularity) -> Tuple[int, ...]:
    """Resolve a granularity to a rank-matched block_size for ``shape``.
    (ref: ao_tpu granularity.py:68)"""
    shape = tuple(shape)
    rank = len(shape)
    if isinstance(granularity, PerTensor):
        return shape
    if isinstance(granularity, PerAxis):
        axis = granularity.axis % rank
        return tuple(1 if i == axis else s for i, s in enumerate(shape))
    if isinstance(granularity, PerGroup):
        g = granularity.group_size
        if shape[-1] % g != 0:
            raise ValueError(f"last dim {shape[-1]} not divisible by group_size {g}")
        return (1,) * (rank - 1) + (g,)
    if isinstance(granularity, PerRow):
        dim = granularity.dim % rank
        return tuple(s if i == dim else 1 for i, s in enumerate(shape))
    if isinstance(granularity, PerToken):
        return (1,) * (rank - 1) + (shape[-1],)
    if isinstance(granularity, PerBlock):
        bs = granularity.block_size
        if len(bs) != rank:
            # trailing-aligned block sizes, e.g. (1, 128) on a 3-D activation
            if len(bs) < rank:
                bs = (1,) * (rank - len(bs)) + tuple(bs)
            else:
                raise ValueError(f"block_size {bs} rank > tensor rank {rank}")
        for s, b in zip(shape, bs):
            if s % b != 0:
                raise ValueError(f"shape {shape} not divisible by block {bs}")
        return tuple(bs)
    raise NotImplementedError(f"unknown granularity {granularity!r}")
