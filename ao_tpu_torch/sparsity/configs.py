"""Sparsity configs + ``sparsify_``.

PyTorch port of ``ao_tpu/sparsity/configs.py``: 2:4 (``SemiSparseWeightConfig``),
2:4 with int4 kept values (``Sparse24Int4WeightConfig``), block-sparse
(``BlockSparseWeightConfig``, whose linears take the hand-written kernel K18
on the card) and Wanda (``WandaSparseConfig``, observe / convert), each with
its handler in the port's registry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ao_tpu_torch.algorithms.observe import ObservedArray
from ao_tpu_torch.core.config import AOBaseConfig
from ao_tpu_torch.core.registry import register_quantize_handler
from ao_tpu_torch.quantization.quantize import quantize_
from ao_tpu_torch.sparsity.blocksparse import BlockSparseArray
from ao_tpu_torch.sparsity.sparse24 import Sparse24Array, Sparse24Int4Array, top2_mask


@dataclasses.dataclass
class SemiSparseWeightConfig(AOBaseConfig):
    version: int = 1


@register_quantize_handler(SemiSparseWeightConfig)
def _semi_sparse_transform(weight, config: SemiSparseWeightConfig):
    return Sparse24Array.from_hp(weight)


@dataclasses.dataclass
class Sparse24Int4WeightConfig(AOBaseConfig):
    """2:4 prune + int4-quantize the kept values, both compressed: the
    marlin-sparse analog at 3/8 byte per element."""

    group_size: int = 128
    version: int = 1


@register_quantize_handler(Sparse24Int4WeightConfig)
def _sparse24_int4_transform(weight, config: Sparse24Int4WeightConfig):
    return Sparse24Int4Array.from_hp(weight, config.group_size)


@dataclasses.dataclass
class BlockSparseWeightConfig(AOBaseConfig):
    blocksize: int = 64
    keep_fraction: Optional[float] = None
    version: int = 1


@register_quantize_handler(BlockSparseWeightConfig)
def _block_sparse_transform(weight, config: BlockSparseWeightConfig):
    return BlockSparseArray.from_hp(weight, config.blocksize, config.keep_fraction)


@dataclasses.dataclass
class WandaSparseConfig(AOBaseConfig):
    """Wanda pruning: score = |W| * ||x||_2 per input channel, pruned to 2:4
    by score. Two steps, like the PTQ algorithms: "observe" wraps each
    weight in an ObservedArray, calibration forwards record sum(x^2) per
    input channel, "convert" prunes."""

    step: str = "observe"
    version: int = 1


@register_quantize_handler(WandaSparseConfig)
def _wanda_transform(weight, config: WandaSparseConfig):
    if config.step == "observe":
        if isinstance(weight, ObservedArray):
            return weight
        return ObservedArray.wrap(weight, "wanda")
    if config.step == "convert":
        if not isinstance(weight, ObservedArray):
            return weight
        w = weight.weight.to(torch.float32)
        score = torch.abs(w) * weight.stats.act_l2[:, None]
        # 2:4 prune by score, keep the original values
        k = w.shape[-2]
        mask = top2_mask(score.reshape(k // 4, 4, -1), -2).reshape(w.shape)
        return Sparse24Array.from_hp(torch.where(mask, w, 0.0))
    raise ValueError(config.step)


def sparsify_(params, config: AOBaseConfig, filter_fn=None):
    """The same tree walk as ``quantize_``."""
    return quantize_(params, config, filter_fn)
