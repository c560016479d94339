"""Sparsity: 2:4, 2:4 with int4 values, block-sparse (BSR) and Wanda.

PyTorch port of ``ao_tpu/sparsity`` apart from ``supermask.py`` and the
runtime-sparsified training linears, which come with the training slice.
"""

from ao_tpu_torch.sparsity.blocksparse import BlockSparseArray
from ao_tpu_torch.sparsity.configs import (
    BlockSparseWeightConfig, SemiSparseWeightConfig, Sparse24Int4WeightConfig,
    WandaSparseConfig, sparsify_,
)
from ao_tpu_torch.sparsity.sparse24 import Sparse24Array, Sparse24Int4Array

__all__ = ["BlockSparseArray", "BlockSparseWeightConfig", "SemiSparseWeightConfig",
           "Sparse24Array", "Sparse24Int4Array", "Sparse24Int4WeightConfig",
           "WandaSparseConfig", "sparsify_"]
