"""Llama-architecture model, functional PyTorch.

PyTorch port of the dense branches of ``ao_tpu/models/llama.py``. Params
are the reference's nested dicts of tensors (weights stored (in, out)), and
every matmul goes through ``ao_tpu_torch.ops.linear``, so any leaf may be a
QuantizedArray. The forward supports the full-sequence forward (prefill,
eval) and decode with an external KV cache, updated in place: bf16 tensors
at a scalar index or at a per-slot (vector) index, the quantized
``QuantKVCache`` pairs of ``serving/kvcache.py`` (int8, fp8, int4) at a
scalar index, or the bf16 ``PagedKVPool`` pages of ``serving/paged.py``
with ``cache_index=(block_table, lengths)``. With ``use_flash`` the
prefill's attention runs the flash-attention kernel (K8) on the card. With
``n_experts > 0`` the MLP is the top-k routed expert FFN of ``ao_tpu_torch.moe``
(the Mixtral / Qwen3-MoE family), int4 experts through the grouped kernel
K13.

The quantized SDPA and SpinQuant's online Hadamard come with later slices
of the port and raise NotImplementedError here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ao_tpu_torch.moe.layer import MoEConfig, init_moe_params, moe_forward
from ao_tpu_torch.ops import kernels, linear
from ao_tpu_torch.ops.act_quant import producer_quant_ok, silu_mul_quant
from ao_tpu_torch.ops.hopper import decode_attention as k2
from ao_tpu_torch.ops.hopper import flash_attention as k8


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # HF-style rope_scaling as a tuple of (key, value) pairs; only the
    # "llama3" rope_type is modeled
    rope_scaling: Optional[Tuple[Tuple[str, Any], ...]] = None
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # attention compute dtype: "bf16" | "int8" | "float8_e4m3fn"
    sdpa: str = "bf16"
    sdpa_rotate: bool = False
    n_experts: int = 0
    top_k_experts: int = 2
    norm_topk_experts: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    qk_head_dim: Optional[int] = None
    sm_scale: Optional[float] = None
    attn_softcap: Optional[float] = None
    # force the plain masked attention path
    force_xla_attention: bool = False

    @property
    def head_dim(self) -> int:
        return self.qk_head_dim or self.dim // self.n_heads


# Common shapes for parity with reference benchmarks.
LLAMA3_8B = LlamaConfig(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                        n_kv_heads=8, ffn_dim=14336)
LLAMA_TINY = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                         n_kv_heads=2, ffn_dim=512, tie_embeddings=True)


def _check_supported(cfg: LlamaConfig) -> None:
    if cfg.sdpa != "bf16":
        raise NotImplementedError("quantized SDPA comes with the attention slice of the port")


def _moe_config(cfg: LlamaConfig) -> MoEConfig:
    return MoEConfig(dim=cfg.dim, ffn_dim=cfg.ffn_dim, n_experts=cfg.n_experts,
                     top_k=cfg.top_k_experts, norm_topk=cfg.norm_topk_experts)


def _normal(generator: torch.Generator, device, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)


def _dense(generator: torch.Generator, device, dtype, fan_in: int, fan_out: int) -> torch.Tensor:
    return (_normal(generator, device, fan_in, fan_out) * (fan_in ** -0.5)).to(dtype)


def init_layer(cfg: LlamaConfig, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """One decoder layer's random params from ``generator``, as
    ``init_params`` makes each of them (a caller can build a deep model one
    layer at a time, quantizing each before the next)."""
    _check_supported(cfg)

    def dense(fan_in, fan_out):
        return _dense(generator, device, cfg.dtype, fan_in, fan_out)

    def ones(n):
        return torch.ones((n,), dtype=cfg.dtype, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=cfg.dtype, device=device)

    d, hd = cfg.dim, cfg.head_dim
    attn = {
        "wq": dense(d, cfg.n_heads * hd),
        "wk": dense(d, cfg.n_kv_heads * hd),
        "wv": dense(d, cfg.n_kv_heads * hd),
        "wo": dense(cfg.n_heads * hd, d),
    }
    if cfg.qkv_bias:
        attn["bq"] = zeros(cfg.n_heads * hd)
        attn["bk"] = zeros(cfg.n_kv_heads * hd)
        attn["bv"] = zeros(cfg.n_kv_heads * hd)
    if cfg.qk_norm:
        attn["q_norm"] = ones(hd)
        attn["k_norm"] = ones(hd)
    if cfg.n_experts > 0:
        # every MoE param, the router too, drawn in f32 and cast to
        # cfg.dtype, as in the reference
        mlp_params = init_moe_params(generator, _moe_config(cfg), device=device,
                                     dtype=cfg.dtype)
    else:
        mlp_params = {
            "w1": dense(d, cfg.ffn_dim),   # gate
            "w3": dense(d, cfg.ffn_dim),   # up
            "w2": dense(cfg.ffn_dim, d),   # down
        }
    return {"attn": attn, "mlp": mlp_params, "ln1": ones(d), "ln2": ones(d)}


def init_params(cfg: LlamaConfig, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Random params from ``generator`` (which must live on ``device``),
    with the reference's shapes, scales and keys (an MoE layer's ``router``
    (D, E), ``w_gate`` / ``w_up`` (E, D, F) and ``w_down`` (E, F, D)). The
    numbers differ from ``jax.random``'s; tests carry the reference's params
    across with ``ao_tpu_torch.weights.params_from_numpy``."""
    _check_supported(cfg)
    d = cfg.dim
    layers = [init_layer(cfg, generator, device) for _ in range(cfg.n_layers)]
    params = {
        "embed": _normal(generator, device, cfg.vocab_size, d).to(cfg.dtype) * 0.02,
        "layers": layers,
        "norm": torch.ones((d,), dtype=cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense(generator, device, cfg.dtype, d, cfg.vocab_size)
    return params


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_freqs(cfg: LlamaConfig, device="cuda") -> torch.Tensor:
    hd = cfg.head_dim
    freqs = 1.0 / (
        cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)
    )
    rs = dict(cfg.rope_scaling) if cfg.rope_scaling else None
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        # Llama-3.1 frequency-dependent scaling: long wavelengths divide by
        # `factor`, short ones stay, the band between interpolates
        factor = rs["factor"]
        low = rs.get("low_freq_factor", 1.0)
        high = rs.get("high_freq_factor", 4.0)
        orig = rs.get("original_max_position_embeddings", 8192)
        wavelen = 2.0 * math.pi / freqs
        low_wl = orig / low
        high_wl = orig / high
        smooth = (orig / wavelen - low) / (high - low)
        interp = (1 - smooth) * freqs / factor + smooth * freqs
        freqs = torch.where(
            wavelen > low_wl, freqs / factor,
            torch.where(wavelen < high_wl, freqs, interp),
        )
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S)."""
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _flash_route(cfg: LlamaConfig, x: torch.Tensor, sq: int, sk: int) -> bool:
    """Whether ``use_flash`` takes the flash-attention kernel: the
    reference's gate (no softcap, default sm_scale, not
    ``force_xla_attention``, and the shapes its kernel does not refuse,
    ``flash_attention.py:135-138``), narrowed to the head_dim K8 takes
    (``flash_attention.takes``), on a CUDA tensor outside the "torch"
    backend. Outside it the einsum path runs, as after the reference's
    UnsupportedShape."""
    return (cfg.attn_softcap is None and cfg.sm_scale is None and not cfg.force_xla_attention
            and k8.takes(cfg.head_dim, cfg.n_heads // cfg.n_kv_heads)
            and sk % 128 == 0 and sq >= 8
            and sq % min(128, sq) == 0 and x.device.type == "cuda"
            and kernels.get_backend() != "torch")


def attention(
    layer: Dict[str, Any],
    x: torch.Tensor,
    cfg: LlamaConfig,
    positions: torch.Tensor,
    freqs: torch.Tensor,
    mask: Optional[torch.Tensor],
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index=None,
    use_flash: bool = False,
):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = linear(x, layer["wq"], layer.get("bq")).reshape(b, s, h, hd)
    k = linear(x, layer["wk"], layer.get("bk")).reshape(b, s, kvh, hd)
    v = linear(x, layer["wv"], layer.get("bv")).reshape(b, s, kvh, hd)

    if "q_norm" in layer:  # Qwen3 per-head RMSNorm before RoPE
        q = rms_norm(q, layer["q_norm"], cfg.norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.norm_eps)

    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    sm_scale = cfg.sm_scale if cfg.sm_scale is not None else hd ** -0.5

    new_cache = None
    ck = cv = None
    sk = s
    if kv_cache is not None:
        from ao_tpu_torch.serving.kvcache import QuantKVCache
        from ao_tpu_torch.serving.paged import PagedKVPool

        ck, cv = kv_cache  # (B, T, kvh, hd) bf16 tensors, QuantKVCache or PagedKVPool
        if isinstance(ck, PagedKVPool):
            # paged decode (S == 1): cache_index = (block_table, lengths),
            # lengths the positions before this token; a quantized pool
            # quantizes the token as it appends it, and K9 runs in the
            # pool's mode
            from ao_tpu_torch.serving.paged import paged_attention

            if s != 1:
                raise ValueError(f"paged caches take single-token decode steps, got S={s}")
            block_table, lengths = cache_index
            ck.append_token(k[:, 0], block_table, lengths)
            cv.append_token(v[:, 0], block_table, lengths)
            out = paged_attention(q[:, 0], ck, cv, block_table, lengths + 1,
                                  sm_scale=hd ** -0.5)
            out = out.to(x.dtype).reshape(b, 1, h * hd)
            return linear(out, layer["wo"]), (ck, cv)
        quant = isinstance(ck, QuantKVCache)
        if not (quant or isinstance(ck, torch.Tensor)):
            raise TypeError(f"unsupported KV cache {type(ck).__name__}")
        # the cache is updated in place; the reference returns an updated
        # copy, and forward returns the same objects
        if quant:
            ck.update(k, cache_index)  # scalar, or per-slot (B,) positions
            cv.update(v, cache_index)
            sk = ck.max_seq
        elif isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
            # continuous batching: each row writes its S-token window at its
            # own position, clamped at the last row
            sk = ck.shape[1]
            cols = (cache_index.long()[:, None]
                    + torch.arange(s, device=ck.device)[None]).clamp_(max=sk - 1)
            rows = torch.arange(b, device=ck.device)[:, None]
            ck[rows, cols] = k.to(ck.dtype)
            cv[rows, cols] = v.to(cv.dtype)
        else:
            idx = int(cache_index)
            sk = ck.shape[1]
            if idx < 0 or idx + s > sk:
                raise ValueError(f"cache window [{idx}, {idx + s}) outside the cache of {sk}")
            ck[:, idx:idx + s] = k.to(ck.dtype)
            cv[:, idx:idx + s] = v.to(cv.dtype)
        new_cache = (ck, cv)

        if (s == 1 and k2.takes(hd, h // kvh) and cfg.attn_softcap is None
                and not cfg.force_xla_attention and x.device.type == "cuda"
                and kernels.get_backend() != "torch"):
            # single-token decode: the flash-decoding kernel reads the cache
            # in place (ops/hopper/decode_attention.py) over each row's
            # length: K2 for bf16, K5 (int8, in the reference's "i8"
            # q-quantized form, as its default int8 "kt" K cache), K6
            # (fp8 e4m3), K7 (int4) or K2v (fp8 e5m2) for a quantized
            # cache. The route is the reference's, narrowed to the shapes
            # the kernels take (``decode_attention.takes``: head_dim 128,
            # at most 8 query heads per kv head); the rest take the einsum
            # path below, as after the reference's UnsupportedShape
            lengths = positions[:, 0] + 1
            if quant:
                out = k2.decode_attention(q[:, 0], ck.qdata, cv.qdata, lengths,
                                          k_scale=ck.scale, v_scale=cv.scale, sm_scale=sm_scale,
                                          k_layout=ck.layout,
                                          mode="i8" if ck.dtype_name == "int8" else None)
            else:
                out = k2.decode_attention(q[:, 0], ck, cv, lengths, sm_scale=sm_scale)
            out = out.to(x.dtype).reshape(b, 1, h * hd)
            return linear(out, layer["wo"]), new_cache

    if use_flash and _flash_route(cfg, x, s, sk):
        # the prefill's attention: K8 reads the bf16 cache (or the fresh K
        # and V) in place, causal and top-left aligned, valid when the
        # query positions start at 0 as in the reference; a quantized cache
        # goes through its dequantized values
        if ck is None:
            kf, vf = k.to(torch.bfloat16), v.to(torch.bfloat16)
        elif isinstance(ck, torch.Tensor):
            kf, vf = ck, cv
        else:
            kf, vf = ck.dequantize(torch.bfloat16), cv.dequantize(torch.bfloat16)
        out = k8.flash_attention(q, kf, vf, causal=True)
        return linear(out.to(x.dtype).reshape(b, s, h * hd), layer["wo"]), new_cache

    if ck is not None:
        if isinstance(ck, torch.Tensor):
            k, v = ck.to(x.dtype), cv.to(x.dtype)
        else:
            k, v = ck.dequantize(x.dtype), cv.dequantize(x.dtype)

    # GQA: repeat kv heads
    if kvh != h:
        rep = h // kvh
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)

    q = q.transpose(1, 2)  # (B, H, S, Dh)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32)
    scores = scores * sm_scale
    if cfg.attn_softcap:
        c = cfg.attn_softcap
        scores = torch.tanh(scores / c) * c
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return linear(out, layer["wo"]), new_cache


def mlp(layer: Dict[str, Any], x: torch.Tensor, cfg=None) -> torch.Tensor:
    if "router" in layer:  # MoE FFN (Mixtral-style)
        return moe_forward(layer, x, _moe_config(cfg))
    if "r4" in layer:
        raise NotImplementedError("SpinQuant's online Hadamard comes with the PTQ slice of the port")
    a, bq = linear(x, layer["w1"]), linear(x, layer["w3"])
    w2 = layer["w2"]
    if producer_quant_ok(w2) and x.shape[-2] > 1:
        # prefill with an int8-activation w2 (W4A8): the SwiGLU gate comes
        # out as int8 qdata and per-token scales in one pass (K12,
        # ops/hopper/fused_act.py), so the standalone quantize never
        # re-reads it. Decode (S == 1) keeps the plain path, as the
        # reference does: the activations are tiny, and w2's linear
        # quantizes them per token before K3
        return linear(silu_mul_quant(a, bq), w2)
    h = a * torch.sigmoid(a) * bq
    return linear(h, w2)


@torch.no_grad()
def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,  # (B, S) int
    cfg: LlamaConfig,
    positions: Optional[torch.Tensor] = None,
    kv_caches: Optional[list] = None,
    cache_index=None,
    use_flash: bool = False,
) -> Tuple[torch.Tensor, Optional[list]]:
    """Returns (logits (B, S, V) f32, kv_caches or None). The caches are
    updated in place and returned."""
    from ao_tpu_torch.ops.embedding import embedding as embedding_op

    _check_supported(cfg)
    b, s = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    x = embedding_op(params["embed"], tokens, out_dtype=cfg.dtype)
    freqs = rope_freqs(cfg, device=dev)

    if kv_caches is None:
        # causal mask over the local sequence
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))[None, None]
        new_caches = None
    else:
        from ao_tpu_torch.serving.paged import PagedKVPool

        c0 = kv_caches[0][0]
        if isinstance(c0, PagedKVPool):
            mask = None  # paged attention masks by each sequence's length
        else:
            # attend over cache positions <= current; a QuantKVCache's
            # capacity comes from its scale rows
            t = c0.max_seq if hasattr(c0, "max_seq") else c0.shape[1]
            key_pos = torch.arange(t, dtype=torch.int32, device=dev)[None, None, None, :]
            mask = key_pos <= positions[:, None, :, None]
        new_caches = []

    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        attn_out, new_c = attention(
            layer["attn"], h, cfg, positions, freqs, mask,
            kv_cache=None if kv_caches is None else kv_caches[i],
            cache_index=cache_index,
            use_flash=use_flash,
        )
        x = x + attn_out
        h = rms_norm(x, layer["ln2"], cfg.norm_eps)
        x = x + mlp(layer["mlp"], h, cfg)
        if new_caches is not None:
            new_caches.append(new_c)

    x = rms_norm(x, params["norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        from ao_tpu_torch.quantization.qarrays.base import QuantizedArray

        emb = params["embed"]
        if isinstance(emb, QuantizedArray):
            logits = linear(x, emb.dequantize(cfg.dtype).T)
        else:
            logits = linear(x, emb.T)
    else:
        logits = linear(x, params["lm_head"])
    return logits.to(torch.float32), new_caches


def init_kv_caches(cfg: LlamaConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16, device="cuda") -> list:
    """Per-layer (K, V) caches (B, T, Hkv, D); bf16 even for an f32 model,
    as in the reference."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return [
        (torch.zeros(shape, dtype=dtype, device=device),
         torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.n_layers)
    ]
