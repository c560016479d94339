"""Reference MoE layer: top-k router + dropless sort-based dispatch +
grouped (quantized) expert FFNs.

PyTorch port of ``ao_tpu/moe/layer.py``: argsort by expert id and per-expert
group sizes feed ``grouped_matmul``, with no capacity dropping. Nothing from
the router to ``combine`` reads a device value on the host: the group sizes
are a ``scatter_add_`` into zeros (``torch.bincount`` would read the max on
the host), each sorted row's token is ``order // k``, and the expert kernels
(K13) and the ragged dot take the group sizes on the device. So a decode
step's MoE FFN never waits on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ao_tpu_torch.moe.grouped import grouped_matmul


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dim: int = 256
    ffn_dim: int = 512
    n_experts: int = 8
    top_k: int = 2
    # router softmax over all experts then renormalize over the top-k
    norm_topk: bool = True


def init_moe_params(generator: torch.Generator, cfg: MoEConfig, device="cuda",
                    dtype=torch.float32) -> Dict[str, Any]:
    """Random params from ``generator`` (which must live on ``device``),
    with the reference's keys, shapes and scales: each drawn in f32, then
    cast to ``dtype`` (llama's MoE branch casts them all to the model's
    dtype, as the reference does) before the next is drawn. The numbers
    differ from ``jax.random``'s."""
    d, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts

    def normal(scale, *shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * scale).to(dtype)

    return {
        "router": normal(0.02, d, e),
        # gated FFN per expert, weights stored (E, K, N)
        "w_gate": normal(d ** -0.5, e, d, f),
        "w_up": normal(d ** -0.5, e, d, f),
        "w_down": normal(f ** -0.5, e, f, d),
    }


def route(x2: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig):
    """x2 (T, D) -> (topk_weights (T, k) f32, topk_idx (T, k) int32)."""
    logits = x2.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk:
        topw = topw / torch.sum(topw, dim=-1, keepdim=True)
    return topw, topi.to(torch.int32)


def dispatch(x2: torch.Tensor, topk_idx: torch.Tensor, n_experts: int):
    """Replicate each token top_k times and sort by destination expert.

    Returns (xs (T*k, D) sorted, order (T*k,) permutation, group_sizes (E,)
    int32). ``order[i]`` is the flat (token, slot) index that landed at
    sorted position i; token id = order // k. The sort is stable, as the
    reference's ``jnp.argsort(stable=True)``."""
    k = topk_idx.shape[1]
    flat_expert = topk_idx.reshape(-1).long()  # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    group_sizes = torch.zeros(n_experts, dtype=torch.int32, device=x2.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert, dtype=torch.int32))
    xs = x2[order // k]  # the reference's repeat(x2, k)[order]
    return xs, order, group_sizes


def combine(ys: torch.Tensor, order: torch.Tensor, topk_weights: torch.Tensor) -> torch.Tensor:
    """Weighted scatter-add of expert outputs back to token rows. Each token
    gets its top-k rows added into zeros: for top-2 the sum 0 + a + b does
    not depend on the order of the adds, so it is exact and deterministic;
    with top-k > 2 on CUDA, ``index_add_``'s atomics would make it depend
    on the order."""
    t, k = topk_weights.shape
    w = topk_weights.reshape(-1)[order].to(ys.dtype)  # (T*k,)
    ys = ys * w[:, None]
    out = torch.zeros((t, ys.shape[-1]), dtype=ys.dtype, device=ys.device)
    return out.index_add_(0, order // k, ys)


def moe_forward(params: Dict[str, Any], x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x (..., D) -> (..., D). Expert weights may be QuantizedArrays."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, cfg.dim)
    topw, topi = route(x2, params["router"], cfg)
    xs, order, gs = dispatch(x2, topi, cfg.n_experts)
    g = grouped_matmul(xs, params["w_gate"], gs)
    u = grouped_matmul(xs, params["w_up"], gs)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    ys = grouped_matmul(h, params["w_down"], gs)
    y = combine(ys, order, topw)
    return y.reshape(*lead, cfg.dim).to(x.dtype)
