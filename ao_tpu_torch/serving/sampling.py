"""Token sampling: temperature, min-p, top-k and top-p (nucleus), and the
context penalties.

PyTorch port of ``ao_tpu/serving/sampling.py``. The filters keep the
reference's order and semantics: min-p on the temperature-scaled
distribution, then top-k, then top-p over the top-k-filtered mass; a greedy
row (temperature 0) is ``torch.argmax``, which, like ``jnp.argmax``,
returns the first maximum.

Draws take an explicit ``torch.Generator`` on the logits' device and pick
by the Gumbel-max rule over the filtered logits, the distribution
``jax.random.categorical`` samples. The random streams differ from
``jax.random``'s, so a sampled token cannot equal JAX's for the same seed:
what the two packages share is the filtered distribution
(``filtered_logits``) and every greedy pick.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _gumbel_pick(lf: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(lf) (rows (..., V), -inf excluded):
    argmax of lf plus Gumbel noise. Returns int32 (...)."""
    u = torch.rand(lf.shape, generator=generator, device=lf.device, dtype=torch.float32)
    noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(lf + noise, dim=-1).to(torch.int32)


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None, min_p: Optional[float] = None) -> torch.Tensor:
    """Sampled token ids (...,) int32 from raw logits (..., V); temperature
    0 is greedy (and draws nothing). Every row takes the same parameters
    through ``sample_logits_batched``; no top-p is a top-p of +inf, which
    keeps every token (1 may drop those whose mass is below f32's
    resolution of the cumulative sum)."""
    lead, v = logits.shape[:-1], logits.shape[-1]
    n = logits[..., 0].numel()
    out = sample_logits_batched(
        logits.reshape(n, v), generator, np.full(n, temperature, np.float32),
        np.full(n, top_k or 0, np.int32), np.full(n, np.inf if top_p is None else top_p, np.float32),
        np.full(n, min_p, np.float32) if min_p else None)
    return out.reshape(lead)


def filtered_logits(logits: torch.Tensor, temps, top_ks, top_ps, min_ps=None) -> torch.Tensor:
    """The temperature-scaled logits (B, V) f32 of ``sample_logits_batched``
    with every filter applied: -inf outside each row's kept set. Rows with
    temperature 0 are scaled by 1. The per-row parameters are tensors on
    the logits' device."""
    lf = logits.to(torch.float32)
    v = lf.shape[-1]
    lt = lf / torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    if min_ps is not None:
        probs_full = torch.softmax(lt, dim=-1)
        pmax = probs_full.amax(dim=-1, keepdim=True)
        lt = torch.where(probs_full < min_ps[:, None] * pmax, -torch.inf, lt)
    srt = torch.sort(lt, dim=-1, descending=True).values
    k = torch.where(top_ks > 0, top_ks, torch.full_like(top_ks, v)).long()
    kth = torch.gather(srt, -1, (k.clamp(1, v) - 1)[:, None])
    lt = torch.where(lt < kth, -torch.inf, lt)
    srt_k = torch.where(torch.arange(v, device=lf.device)[None] < k[:, None], srt, -torch.inf)
    probs = torch.softmax(srt_k, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cut_i = ((cum - probs) < top_ps[:, None]).sum(dim=-1, keepdim=True) - 1
    cutoff = torch.gather(srt_k, -1, cut_i.clamp(0, v - 1))
    return torch.where(lt < cutoff, -torch.inf, lt)


def sample_logits_batched(logits: torch.Tensor, generator: Optional[torch.Generator], temps,
                          top_ks, top_ps, min_ps=None) -> torch.Tensor:
    """Per-row sampling (a continuous batch mixes greedy and sampled
    requests in one step): logits (B, V); temps (B,), 0 → greedy for that
    row; top_ks (B,) int, 0 → no top-k; top_ps (B,), 1 → no top-p; min_ps
    (B,) or None, 0 → no min-p. Returns (B,) int32.

    The per-row parameters are host arrays (the engine keeps them in
    numpy). When every row is greedy the sort and the draw are skipped, as
    the reference's ``lax.cond`` skips them, and that check reads no device
    value."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not (np.asarray(temps) > 0).any():
        return greedy
    dev = logits.device
    temps, top_ks, top_ps = (torch.as_tensor(x, device=dev) for x in (temps, top_ks, top_ps))
    temps, top_ps = temps.to(torch.float32), top_ps.to(torch.float32)
    if min_ps is not None:
        min_ps = torch.as_tensor(min_ps, device=dev).to(torch.float32)
    sampled = _gumbel_pick(filtered_logits(logits, temps, top_ks, top_ps, min_ps), generator)
    return torch.where(temps > 0, sampled, greedy)


def apply_penalties(logits: torch.Tensor, rep_pens: torch.Tensor, freq_pens: torch.Tensor,
                    pres_pens: torch.Tensor, prompt_pres: torch.Tensor,
                    out_counts: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Context penalties on raw logits (B, V), applied before temperature
    (greedy rows see them too):

    - repetition (HF semantics): tokens in the prompt (``prompt_pres`` > 0)
      or the output so far (``out_counts`` > 0) get positive logits divided
      and negative ones multiplied by ``rep_pens``;
    - frequency and presence (OpenAI semantics): subtract
      ``freq_pens * count`` and ``pres_pens * (count > 0)`` over the output;
    - an additive per-request logit ``bias`` (B, V).

    The defaults (1, 0, 0) make this an identity. Returns f32 (B, V)."""
    lf = logits.to(torch.float32)
    ctx = (prompt_pres > 0) | (out_counts > 0)
    rp = rep_pens[:, None].to(torch.float32)
    lf = torch.where(ctx, torch.where(lf > 0, lf / rp, lf * rp), lf)
    oc = out_counts.to(torch.float32)
    lf = lf - freq_pens[:, None].to(torch.float32) * oc
    lf = lf - pres_pens[:, None].to(torch.float32) * (oc > 0).to(torch.float32)
    if bias is not None:
        lf = lf + bias.to(torch.float32)
    return lf
