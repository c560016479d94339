"""Calibration observers: weight wrappers that record activation statistics.

PyTorch port of ``ao_tpu/algorithms/observe.py``. The params tree holds
``ObservedArray`` leaves whose ``stats`` is a plain Python accumulator;
calibration forwards run eagerly through ``ops.linear`` (and the MoE
``grouped_matmul``), which update it, and ``quantize_`` / ``sparsify_`` with
``step="convert"`` then read it. The grouped branch's product is the ragged
dot of ``moe/grouped.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ao_tpu_torch.moe.grouped import ragged_dot
from ao_tpu_torch.ops.dispatch import implements
from ao_tpu_torch.quantization.qarrays.base import QuantizedArray, meta, qarray_dataclass

class StatsAccumulator:
    """Mutable per-weight statistics store (compared by identity)."""

    def __init__(self, kind: str):
        self.kind = kind
        self.n = 0
        self.hessian: Optional[torch.Tensor] = None  # (K, K) for gptq
        self.abs_sum: Optional[torch.Tensor] = None  # (K,) for awq
        self.abs_max: Optional[torch.Tensor] = None  # (K,) for smoothquant
        self.amax: Optional[torch.Tensor] = None  # scalar act amax (static quant)
        self.sample: Optional[torch.Tensor] = None  # first activation batch
        self.sq_sum: Optional[torch.Tensor] = None  # (K,) sum of x^2 for wanda
        self.hess_sum: Optional[torch.Tensor] = None  # (E, K, K) for grouped gptq
        self.h_count: Optional[torch.Tensor] = None  # (E,) rows seen per expert

    @property
    def act_l2(self) -> torch.Tensor:
        if self.sq_sum is None:
            raise ValueError("no wanda statistics collected")
        return torch.sqrt(self.sq_sum)

    def update(self, x2d: torch.Tensor) -> None:
        """x2d: (M, K) activation batch (already flattened)."""
        m = x2d.shape[0]
        xf = x2d.to(torch.float32)
        if self.kind == "gptq":
            # running mean of 2 x^T x
            h = 2.0 * (xf.T @ xf)
            if self.hessian is None:
                self.hessian = h / m
            else:
                tot = self.n + m
                self.hessian = self.hessian * (self.n / tot) + h / tot
        elif self.kind == "awq":
            s = torch.sum(torch.abs(xf), dim=0)
            self.abs_sum = s if self.abs_sum is None else self.abs_sum + s
            if self.sample is None:
                self.sample = x2d[: min(64, m)]
        elif self.kind == "smoothquant":
            mx = torch.amax(torch.abs(xf), dim=0)
            self.abs_max = mx if self.abs_max is None else torch.maximum(self.abs_max, mx)
        elif self.kind == "wanda":
            # running sum of squares per input channel
            sq = torch.sum(xf * xf, dim=0)
            self.sq_sum = sq if self.sq_sum is None else self.sq_sum + sq
        elif self.kind == "static":
            mx = torch.amax(torch.abs(xf))
            self.amax = mx if self.amax is None else torch.maximum(self.amax, mx)
            if self.sample is None:  # kept for the MSE observer
                self.sample = x2d[: min(256, m)]
        else:
            raise ValueError(self.kind)
        self.n += m

    def update_grouped(self, x_sorted: torch.Tensor, group_sizes: torch.Tensor,
                       n_experts: int) -> None:
        """Per-expert Hessian accumulation for MoE weights: x_sorted (T, K)
        is sorted by expert, ``group_sizes`` (E,) counts each expert's rows;
        adds 2 x_e^T x_e (E, K, K) and the counts. Calibration is eager: the
        sizes are read on the host."""
        if self.kind != "gptq":
            raise ValueError("grouped observation only implemented for gptq")
        xf = x_sorted.to(torch.float32)
        k = xf.shape[1]
        h = torch.zeros((len(group_sizes), k, k), dtype=torch.float32, device=xf.device)
        lo = 0
        for e, cnt in enumerate(group_sizes.tolist()):
            xe = xf[lo:lo + cnt]
            h[e] = 2.0 * (xe.T @ xe)
            lo += cnt
        counts = group_sizes.to(torch.float32)
        if self.hess_sum is None:
            self.hess_sum, self.h_count = h, counts
        else:
            self.hess_sum, self.h_count = self.hess_sum + h, self.h_count + counts

    @property
    def grouped_hessian(self) -> torch.Tensor:
        """(E, K, K) mean Hessians."""
        if self.hess_sum is None:
            raise ValueError("no grouped gptq statistics collected")
        cnt = torch.clamp_min(self.h_count, 1.0)
        return self.hess_sum / cnt[:, None, None]


@qarray_dataclass
class ObservedArray(QuantizedArray):
    """High-precision weight + stats accumulator; forwards run in hp."""

    weight: torch.Tensor
    stats: StatsAccumulator = meta(default=None)
    _shape: tuple = meta(default=())
    _dequant_dtype: str = meta(default="bfloat16")

    @classmethod
    def wrap(cls, weight: torch.Tensor, kind: str) -> "ObservedArray":
        return cls(weight=weight, stats=StatsAccumulator(kind), _shape=tuple(weight.shape),
                   _dequant_dtype=str(weight.dtype).removeprefix("torch."))

    def dequantize(self, output_dtype=None):
        return self.weight.to(output_dtype or self.weight.dtype)


@implements("grouped_matmul", ObservedArray)
def _observed_grouped(x, w: ObservedArray, group_sizes, out_dtype):
    if w.stats.kind == "gptq":
        w.stats.update_grouped(x, group_sizes, w.weight.shape[0])
    else:
        # awq / smoothquant / wanda / static statistics are per input
        # channel and expert-agnostic: the plain update applies
        w.stats.update(x)
    return ragged_dot(x, w.weight.to(x.dtype), group_sizes).to(out_dtype or x.dtype)


@implements("linear", ObservedArray)
def _observed_linear(x, w: ObservedArray, b):
    x2 = x.reshape(-1, x.shape[-1])
    w.stats.update(x2)
    y = torch.matmul(x2, w.weight.to(x.dtype))
    y = y.reshape(*x.shape[:-1], y.shape[-1])
    return y if b is None else y + b.to(y.dtype)
