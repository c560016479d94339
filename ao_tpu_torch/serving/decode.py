"""Autoregressive decode loop: one prefill, then greedy single-token steps.

PyTorch port of ``ao_tpu/serving/decode.py::generate``. The reference runs
the whole generation as one jitted program with ``lax.scan``; here a Python
loop runs ``num_steps - 1`` decode steps with static shapes against a cache
updated in place: bf16, or with ``kv_quant`` ("int8", "float8_e4m3fn",
"int4") the quantized caches of ``serving/kvcache.py``. Capturing the step
in a CUDA graph is later work, as are sampling (``temperature > 0``) and
the flash-attention prefill.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ao_tpu_torch.models import resolve_model


@torch.no_grad()
def generate(
    params: Any,
    prompt: torch.Tensor,  # (B, S) int
    cfg,
    num_steps: int,
    max_seq: int,
    kv_quant: Optional[str] = None,
    use_flash: bool = False,
    temperature: float = 0.0,  # 0 = greedy
) -> torch.Tensor:
    """Greedy generation on ``prompt``'s device; returns (B, num_steps)
    int32 tokens, the first one predicted by the prefill."""
    if temperature != 0.0:
        raise NotImplementedError("sampling comes with a later slice of the port")
    if use_flash:
        raise NotImplementedError("flash-attention prefill comes with a later slice of the port")
    model = resolve_model(cfg)
    b, s = prompt.shape
    if s + num_steps - 1 > max_seq:
        raise ValueError(f"prompt {s} + {num_steps - 1} steps do not fit max_seq={max_seq}")
    dev = prompt.device
    if kv_quant:
        from ao_tpu_torch.serving.kvcache import init_quant_kv_caches

        caches = init_quant_kv_caches(cfg, b, max_seq, kv_quant, device=dev)
    else:
        caches = model.init_kv_caches(cfg, b, max_seq, device=dev)

    # prefill
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    logits, caches = model.forward(params, prompt, cfg, positions=positions,
                                   kv_caches=caches, cache_index=0)
    # torch.argmax, like jnp.argmax, returns the first maximum
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    toks = [tok]
    for i in range(num_steps - 1):
        idx = s + i
        pos = torch.full((b, 1), idx, dtype=torch.int32, device=dev)
        logits, caches = model.forward(params, tok[:, None], cfg, positions=pos,
                                       kv_caches=caches, cache_index=idx)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1)
