"""Vision Transformer, functional PyTorch.

PyTorch port of ``ao_tpu/models/vit.py``: a patch-embed convolution and an
encoder stack whose every matmul goes through ``ao_tpu_torch.ops.linear`` and
every convolution through ``ops.conv``, so ``quantize_`` applies directly.
Params are the reference's nested dicts of tensors (weights stored (in,
out)); the patch-embed weight is HWIO and 4-D, so ``quantize_``'s default
filter skips it. Under ``Int4WeightOnlyConfig(group_size=128)`` ViT-B's
768-wide inputs have 6 groups, which ``Int4Array.from_hp`` packs in the
split-half layout (K / g % 4 != 0): those linears take the int4 split-half
kernel K11 on the card, the 3072-wide w2 (24 groups, the magic layout) K1.
Attention is the plain einsum, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ao_tpu_torch.ops import linear
from ao_tpu_torch.ops.conv import conv2d


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    n_classes: int = 1000
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


VIT_L16 = ViTConfig(dim=1024, n_layers=24, n_heads=16, mlp_dim=4096)
VIT_B16 = ViTConfig()
VIT_TINY = ViTConfig(image_size=32, patch_size=8, dim=64, n_layers=2, n_heads=4, mlp_dim=128,
                     n_classes=10, dtype=torch.float32)


def init_params(cfg: ViTConfig, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Random params from ``generator`` (which must live on ``device``),
    with the reference's shapes, scales and keys. The numbers differ from
    ``jax.random``'s; tests carry the reference's params across with
    ``ao_tpu_torch.weights.params_from_numpy``."""

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)

    def dense(fan_in, fan_out):
        return (normal(fan_in, fan_out) * (fan_in ** -0.5)).to(cfg.dtype)

    def ln():
        return {"scale": torch.ones((d,), dtype=cfg.dtype, device=device),
                "bias": torch.zeros((d,), dtype=cfg.dtype, device=device)}

    d, p = cfg.dim, cfg.patch_size
    patch_k = normal(p, p, cfg.in_channels, d) * ((p * p * cfg.in_channels) ** -0.5)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": ln(),
            "attn": {"wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d), "wo": dense(d, d)},
            "ln2": ln(),
            "mlp": {"w1": dense(d, cfg.mlp_dim),
                    "b1": torch.zeros((cfg.mlp_dim,), dtype=cfg.dtype, device=device),
                    "w2": dense(cfg.mlp_dim, d),
                    "b2": torch.zeros((d,), dtype=cfg.dtype, device=device)},
        })
    return {
        "patch_embed": {"kernel": patch_k.to(cfg.dtype),
                        "bias": torch.zeros((d,), dtype=cfg.dtype, device=device)},
        "cls_token": torch.zeros((1, 1, d), dtype=cfg.dtype, device=device),
        "pos_embed": (normal(1, cfg.n_patches + 1, d) * 0.02).to(cfg.dtype),
        "layers": layers,
        "ln_f": ln(),
        "head": {"proj": dense(d, cfg.n_classes)},
    }


def layernorm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    """LayerNorm with the reference's arithmetic: moments and affine in f32,
    the result in x's dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)).to(x.dtype)


def proj(x, p, w: str, b: str):
    """``linear`` through ``p[w]``, plus ``p[b]`` where the params have it."""
    y = linear(x, p[w])
    if b in p:  # biases present when imported from HF checkpoints
        y = y + p[b].to(y.dtype)
    return y


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default is
    the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def _attention(p, x, cfg: ViTConfig):
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = proj(x, p, "wq", "bq").reshape(b, t, h, hd)
    k = proj(x, p, "wk", "bk").reshape(b, t, h, hd)
    v = proj(x, p, "wv", "bv").reshape(b, t, h, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    a = torch.softmax(s * (hd ** -0.5), dim=-1).to(x.dtype)
    dt = torch.promote_types(a.dtype, v.dtype)  # jnp.einsum's promotion
    o = torch.einsum("bhqk,bkhd->bqhd", a.to(dt), v.to(dt)).reshape(b, t, d)
    return proj(o, p, "wo", "bo")


@torch.no_grad()
def forward(params: Dict[str, Any], images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """images (N, H, W, C) -> class logits (N, n_classes) f32."""
    pe = params["patch_embed"]
    x = conv2d(images.to(cfg.dtype), pe["kernel"], stride=cfg.patch_size, padding="VALID",
               bias=pe["bias"])
    n = x.shape[0]
    x = x.reshape(n, -1, cfg.dim)
    cls = params["cls_token"].expand(n, 1, cfg.dim)
    x = torch.cat([cls.to(x.dtype), x], dim=1)
    x = x + params["pos_embed"].to(x.dtype)
    for lp in params["layers"]:
        x = x + _attention(lp["attn"], layernorm(x, lp["ln1"], cfg.norm_eps), cfg)
        h = layernorm(x, lp["ln2"], cfg.norm_eps)
        h = gelu(linear(h, lp["mlp"]["w1"]) + lp["mlp"]["b1"])
        x = x + linear(h, lp["mlp"]["w2"]) + lp["mlp"]["b2"]
    x = layernorm(x, params["ln_f"], cfg.norm_eps)
    return proj(x[:, 0], params["head"], "proj", "bias").to(torch.float32)
