"""Block-sparse (BSR) weights.

PyTorch port of ``ao_tpu/sparsity/blocksparse.py``. Layout for a (K, N)
weight with block size b:

  values:      (nnz, b, b)
  row_indices: (nnz,) int32 — block row (along K / b)
  col_indices: (nnz,) int32 — block column (along N / b)

``from_hp`` selects the blocks on the host in numpy with the reference's
arithmetic, so the kept set, its order and its padding are bit-identical to
the reference's, ties included. ``matmul`` is the ragged route (the
reference's ``ragged_dot_general``) and the plain version of the
hand-written kernel K18 (``ops/hopper/bsr_matmul.py``), which
``ops/linear.py`` takes on CUDA tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ao_tpu_torch.quantization.qarrays.base import QuantizedArray, meta, qarray_dataclass


@qarray_dataclass
class BlockSparseArray(QuantizedArray):
    values: torch.Tensor  # (nnz, b, b)
    row_indices: torch.Tensor  # (nnz,) int32
    col_indices: torch.Tensor  # (nnz,) int32
    blocksize: int = meta(default=64)
    _shape: Tuple[int, ...] = meta(default=())
    _dequant_dtype: str = meta(default="bfloat16")

    @classmethod
    def from_hp(cls, hp: torch.Tensor, blocksize: int = 64, keep_fraction: float = None,
                dequant_dtype: str = "bfloat16"):
        """Keep the blocks with the largest Frobenius norms; ``keep_fraction``
        None keeps every block with a nonzero (the exact BSR of a pre-pruned
        weight). The result lands on ``hp``'s device."""
        k, n = hp.shape
        b = blocksize
        if k % b or n % b:
            raise ValueError(f"shape {tuple(hp.shape)} not divisible by block {b}")
        w = hp.detach().to("cpu", torch.float32).numpy()
        blocks = w.reshape(k // b, b, n // b, b).transpose(0, 2, 1, 3)
        norms = np.linalg.norm(blocks, axis=(2, 3))
        if keep_fraction is None:
            keep = norms > 0
        else:
            nkeep = max(1, int(round(keep_fraction * norms.size)))
            thresh = np.partition(norms.ravel(), -nkeep)[-nkeep]
            keep = norms >= thresh
        rows, cols = np.nonzero(keep)
        vals = blocks[rows, cols]
        # the kernel's invariants: every output column block present (an
        # empty one padded with a zero block at row 0) and the blocks sorted
        # by (col, row), so each column's blocks form one contiguous run
        missing = np.setdiff1d(np.arange(n // b), np.unique(cols))
        if missing.size:
            rows = np.concatenate([rows, np.zeros_like(missing)])
            cols = np.concatenate([cols, missing])
            vals = np.concatenate([vals, np.zeros((missing.size, b, b), vals.dtype)])
        order = np.lexsort((rows, cols))
        rows, cols, vals = rows[order], cols[order], vals[order]
        dev = hp.device
        return cls(
            values=torch.from_numpy(np.ascontiguousarray(vals)).to(
                dev, getattr(torch, dequant_dtype)),
            row_indices=torch.from_numpy(rows.astype(np.int32)).to(dev),
            col_indices=torch.from_numpy(cols.astype(np.int32)).to(dev),
            blocksize=b,
            _shape=(k, n),
            _dequant_dtype=dequant_dtype,
        )

    @property
    def nnz_blocks(self) -> int:
        return self.values.shape[0]

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x (M, K) @ this (K, N), over the live blocks only: x's row blocks
        gathered by ``row_indices``, each block's product in f32 (the values
        cast to x's dtype first, as the reference does), summed per output
        column block (``index_add_`` over ``col_indices``), cast to x's
        dtype once."""
        m, k = x.shape
        _, n = self.shape
        b = self.blocksize
        xb = x.reshape(m, k // b, b)[:, self.row_indices.long()]  # (M, nnz, b)
        rhs = self.values.to(x.dtype).to(torch.float32)
        prod = torch.bmm(xb.transpose(0, 1).to(torch.float32), rhs)  # (nnz, M, b)
        y = torch.zeros((n // b, m, b), dtype=torch.float32, device=x.device)
        y.index_add_(0, self.col_indices.long(), prod)
        return y.transpose(0, 1).reshape(m, n).to(x.dtype)

    def dequantize(self, output_dtype=None):
        k, n = self.shape
        b = self.blocksize
        dense = torch.zeros((k // b, n // b, b, b), dtype=self.values.dtype,
                            device=self.values.device)
        dense[self.row_indices.long(), self.col_indices.long()] = self.values
        out = dense.permute(0, 2, 1, 3).reshape(k, n)
        return out.to(output_dtype or self.dtype)
