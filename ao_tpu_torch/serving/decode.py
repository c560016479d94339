"""Autoregressive decode loop: one prefill, then single-token steps, greedy
or sampled.

PyTorch port of ``ao_tpu/serving/decode.py::generate``. The reference runs
the whole generation as one jitted program with ``lax.scan``; here a Python
loop runs ``num_steps - 1`` decode steps with static shapes against a cache
updated in place: bf16, or with ``kv_quant`` ("int8", "float8_e4m3fn",
"float8_e5m2", "int4") the quantized caches of ``serving/kvcache.py``. With
``use_flash`` the prefill's attention runs the flash-attention kernel (K8)
on the card.
Sampling (``temperature > 0``, ``top_k``, ``top_p``) goes through
``serving/sampling.py``. Capturing the step in a CUDA graph is later work.
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
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Generation on ``prompt``'s device, greedy by default or sampled with
    temperature / top-k / top-p; returns (B, num_steps) int32 tokens, the
    first one predicted by the prefill.

    Sampled picks draw from ``generator``, by default one seeded 0 on the
    prompt's device (the reference's ``rng`` defaults to ``PRNGKey(0)``).
    The reference folds the step index into its key (``fold_in``); the port
    draws every step from the same generator in turn, so a seed repeats its
    tokens but never gives JAX's."""
    from ao_tpu_torch.serving.sampling import sample_logits

    model = resolve_model(cfg)
    b, s = prompt.shape
    if s + num_steps - 1 > max_seq:
        raise ValueError(f"prompt {s} + {num_steps - 1} steps do not fit max_seq={max_seq}")
    dev = prompt.device
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def pick(logits):
        # torch.argmax, like jnp.argmax, returns the first maximum
        return sample_logits(logits, generator, temperature, top_k, top_p)

    if kv_quant:
        from ao_tpu_torch.serving.kvcache import init_quant_kv_caches

        caches = init_quant_kv_caches(cfg, b, max_seq, kv_quant, device=dev)
    else:
        caches = model.init_kv_caches(cfg, b, max_seq, device=dev)

    # prefill
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    logits, caches = model.forward(params, prompt, cfg, positions=positions,
                                   kv_caches=caches, cache_index=0, use_flash=use_flash)
    tok = pick(logits[:, -1])
    toks = [tok]
    for i in range(num_steps - 1):
        idx = s + i
        pos = torch.full((b, 1), idx, dtype=torch.int32, device=dev)
        logits, caches = model.forward(params, tok[:, None], cfg, positions=pos,
                                       kv_caches=caches, cache_index=idx)
        tok = pick(logits[:, -1])
        toks.append(tok)
    return torch.stack(toks, dim=1)
