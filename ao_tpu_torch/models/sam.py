"""SAM-class promptable segmentation model, functional PyTorch.

PyTorch port of ``ao_tpu/models/sam.py``: the ViTDet image encoder (patch
convolution, windowed and global blocks with the decomposed relative-position
bias, convolution neck), the point and box prompt encoders, and the two-way
mask decoder with its upscaler and hypernetwork heads. Params are the
reference's nested dicts (linear weights stored (in, out)); every matmul goes
through ``ao_tpu_torch.ops.linear`` and every convolution through
``ops.conv``, so ``quantize_`` applies to the whole pipeline.

Routes, decided before each call as in the reference:

* Encoder attention with a rel-pos table takes the windowed attention kernel
  K16 (``ops/hopper/window_attention.py``) on a CUDA tensor outside the
  "torch" backend where ``window_attention.takes(side, head_dim)`` allows:
  the windowed layers and, unlike the TPU kernel, the global ones (side 64
  at image 1024). Elsewhere the reference's einsum form runs.
* With int8 dynamic-activation weights (W8A8) on an MLP, its LayerNorm and
  GELU emit int8 directly (K12n ``norm_modulate_quant``, K12g
  ``gelu_quant``), as does the LayerNorm before a global layer's q, k, v.

The residual stream stays window-partitioned across consecutive windowed
layers, as in the reference; the padded windows' rows are real keys there,
their normed branch multiplied by the pad mask.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ao_tpu_torch.models.vit import gelu, layernorm as _layernorm, proj as _proj
from ao_tpu_torch.ops import kernels, linear
from ao_tpu_torch.ops.act_quant import gelu_quant, norm_modulate_quant, producer_quant_ok
from ao_tpu_torch.ops.conv import conv2d, conv_transpose2d
from ao_tpu_torch.ops.hopper import window_attention as k16


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    image_size: int = 1024
    patch_size: int = 16
    in_channels: int = 3
    # image encoder (ViT-det)
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_ratio: int = 4
    window_size: int = 14
    global_attn_layers: Tuple[int, ...] = (2, 5, 8, 11)
    use_rel_pos: bool = True
    neck_dim: int = 256
    # mask decoder
    decoder_layers: int = 2
    decoder_heads: int = 8
    decoder_mlp_mult: int = 8
    n_mask_tokens: int = 4
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


SAM_B = SAMConfig()
SAM_L = SAMConfig(dim=1024, n_layers=24, n_heads=16, global_attn_layers=(5, 11, 17, 23))
SAM_TINY = SAMConfig(image_size=64, patch_size=8, dim=64, n_layers=2, n_heads=4, window_size=4,
                     global_attn_layers=(1,), neck_dim=32, decoder_heads=4, dtype=torch.float32)


def init_params(cfg: SAMConfig, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Random params from ``generator`` (which must live on ``device``),
    with the reference's shapes, scales and keys; the rel-pos tables are
    zero, the ViTDet default, as in the reference. The numbers differ from
    ``jax.random``'s; tests carry the reference's params across with
    ``ao_tpu_torch.weights.params_from_numpy``."""
    dt = cfg.dtype

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)

    def dense(fan_in, fan_out):
        return (normal(fan_in, fan_out) * (fan_in ** -0.5)).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ln(n):
        return {"scale": torch.ones((n,), dtype=dt, device=device), "bias": zeros(n)}

    def attn(q_dim, kv_dim, inner):
        return {"wq": dense(q_dim, inner), "bq": zeros(inner), "wk": dense(kv_dim, inner),
                "bk": zeros(inner), "wv": dense(kv_dim, inner), "bv": zeros(inner),
                "wo": dense(inner, q_dim), "bo": zeros(q_dim)}

    def mlp(dim, hidden, out):
        return {"w1": dense(dim, hidden), "b1": zeros(hidden), "w2": dense(hidden, out),
                "b2": zeros(out)}

    def mlp3(dim, hidden, out):
        return {"w1": dense(dim, hidden), "b1": zeros(hidden), "w2": dense(hidden, hidden),
                "b2": zeros(hidden), "w3": dense(hidden, out), "b3": zeros(out)}

    d, nd, p = cfg.dim, cfg.neck_dim, cfg.patch_size
    patch_k = normal(p, p, cfg.in_channels, d) * ((p * p * cfg.in_channels) ** -0.5)
    layers = []
    for i in range(cfg.n_layers):
        lp = {"ln1": ln(d), "attn": attn(d, d, d), "ln2": ln(d),
              "mlp": mlp(d, cfg.mlp_ratio * d, d)}
        if cfg.use_rel_pos:
            # the table spans the layer's attention extent (window or grid)
            span = cfg.grid if i in cfg.global_attn_layers else cfg.window_size
            lp["attn"]["rel_pos_h"] = zeros(2 * span - 1, cfg.head_dim)
            lp["attn"]["rel_pos_w"] = zeros(2 * span - 1, cfg.head_dim)
        layers.append(lp)
    decoder = [{"self_attn": attn(nd, nd, nd), "ln1": ln(nd),
                "cross_t2i": attn(nd, nd, nd // 2), "ln2": ln(nd),
                "mlp": mlp(nd, cfg.decoder_mlp_mult * nd, nd), "ln3": ln(nd),
                "cross_i2t": attn(nd, nd, nd // 2), "ln4": ln(nd)}
               for _ in range(cfg.decoder_layers)]
    n_tok = 1 + cfg.n_mask_tokens  # iou token + mask tokens
    return {
        "patch_embed": {"kernel": patch_k.to(dt), "bias": zeros(d)},
        "pos_embed": (normal(1, cfg.grid, cfg.grid, d) * 0.02).to(dt),
        "layers": layers,
        "neck": {
            "conv1": {"kernel": dense(d, nd).reshape(1, 1, d, nd)},
            "ln1": ln(nd),
            "conv2": {"kernel": (normal(3, 3, nd, nd) * ((9 * nd) ** -0.5)).to(dt)},
            "ln2": ln(nd),
        },
        "prompt": {
            # 5 rows: [not-a-point, neg point, pos point, box TL, box BR]
            "point_embed": (normal(5, nd) * 0.02).to(dt),
            # random-Fourier positional encoding matrix (frozen at init)
            "pe_gaussian": normal(2, nd // 2),
            "no_mask_embed": (normal(1, nd) * 0.02).to(dt),
        },
        "decoder": {
            "tokens": (normal(n_tok, nd) * 0.02).to(dt),
            "layers": decoder,
            "final_t2i": attn(nd, nd, nd // 2),
            "ln_final": ln(nd),
            "up1": {"kernel": (normal(2, 2, nd, nd // 4) * ((4 * nd) ** -0.5)).to(dt),
                    "bias": zeros(nd // 4)},
            "up_ln": ln(nd // 4),
            "up2": {"kernel": (normal(2, 2, nd // 4, nd // 8) * (nd ** -0.5)).to(dt),
                    "bias": zeros(nd // 8)},
            "hyper_mlps": [mlp3(nd, nd, nd // 8) for _ in range(cfg.n_mask_tokens)],
            "iou_head": mlp3(nd, nd, cfg.n_mask_tokens),
        },
    }


def _rel_pos_terms(q: torch.Tensor, p, side: int):
    """Decomposed rel-pos partial terms: q (B, S*S, nh, hd) -> rel_h, rel_w
    (B, nh, S*S, side) f32 (rel_h[..., t, ky] pairs query row t with key
    row ky; rel_w with key column kx): bf16 products, exact in f32, summed in
    f32, as the reference's einsums with an f32 accumulator."""
    b, hd = q.shape[0], q.shape[-1]
    ar = torch.arange(side, device=q.device)
    idx = ar[:, None] - ar[None, :] + side - 1  # table row (side-1) + (qi - ki)
    rh = p["rel_pos_h"][idx].to(torch.float32)
    rw = p["rel_pos_w"][idx].to(torch.float32)
    rq = q.reshape(b, side, side, -1, hd).to(torch.float32)
    rel_h = torch.einsum("byxnc,ykc->bnyxk", rq, rh)
    rel_w = torch.einsum("byxnc,xkc->bnyxk", rq, rw)
    nh = rel_h.shape[1]
    return (rel_h.reshape(b, nh, side * side, side), rel_w.reshape(b, nh, side * side, side))


def _rel_pos_bias(q: torch.Tensor, attn: torch.Tensor, p, side: int) -> torch.Tensor:
    """attn (B, nh, S*S, S*S) logits plus the decomposed rel-pos bias. The
    reference expands rel_h and rel_w with 0/1 matrices on its matrix unit
    (bias = rel_h @ Eh + rel_w @ Ew); indexing by key row and column is the
    same sum, exactly."""
    rel_h, rel_w = _rel_pos_terms(q, p, side)
    cols = torch.arange(side * side, device=q.device)
    return attn + (rel_h[..., cols // side] + rel_w[..., cols % side])


def _k16_route(q: torch.Tensor, side: int, head_dim: int) -> bool:
    """Whether encoder attention takes K16: a CUDA tensor outside the
    "torch" backend, at a side and head_dim the kernel takes (the reference
    asks ``on_tpu()`` and falls back on its kernel's UnsupportedShape)."""
    return (q.device.type == "cuda" and kernels.get_backend() != "torch"
            and k16.takes(side, head_dim))


def _mha(p, q_in, k_in, n_heads: int, v_in=None, rel_side: Optional[int] = None):
    """Multi-head attention through quantizable linears; q_in (B, Q, Dq),
    k_in (B, K, Dkv), v defaults to k_in (pass v_in when keys carry a
    positional term the values must not); optional decomposed rel-pos over a
    square grid."""
    if v_in is None:
        v_in = k_in
    b, tq, _ = q_in.shape
    tk = k_in.shape[1]
    q = _proj(q_in, p, "wq", "bq")
    k = _proj(k_in, p, "wk", "bk")
    v = _proj(v_in, p, "wv", "bv")
    inner = q.shape[-1]
    hd = inner // n_heads
    q = q.reshape(b, tq, n_heads, hd)
    k = k.reshape(b, tk, n_heads, hd)
    v = v.reshape(b, tk, n_heads, hd)
    rel = rel_side is not None and "rel_pos_h" in p
    if rel and tq == tk and _k16_route(q, rel_side, hd):
        rel_h, rel_w = _rel_pos_terms(q, p, rel_side)
        o = k16.window_bias_attention(q, k, v, rel_h, rel_w, side=rel_side, scale=hd ** -0.5)
        return _proj(o.to(q_in.dtype), p, "wo", "bo")
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * (hd ** -0.5)
    if rel:
        s = _rel_pos_bias(q, s, p, rel_side)
    a = torch.softmax(s, dim=-1).to(q_in.dtype)
    dt = torch.promote_types(a.dtype, v.dtype)  # jnp.einsum's promotion
    o = torch.einsum("bhqk,bkhd->bqhd", a.to(dt), v.to(dt)).reshape(b, tq, inner)
    return _proj(o, p, "wo", "bo")


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, w*w, C) with H, W divisible by w."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def _window_merge(x: torch.Tensor, w: int, b: int, h: int, wd: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(b, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, c)


def _modulation(ln_p, rows: int):
    """A LayerNorm affine as the producer kernels' modulation: shift = bias,
    smod = scale - 1 (in the params' dtype, as the reference rounds it),
    each one row broadcast over ``rows`` batch rows (stride 0)."""
    d = ln_p["scale"].shape[0]
    return ln_p["bias"][None].expand(rows, d), (ln_p["scale"] - 1.0)[None].expand(rows, d)


def _mlp(xin: torch.Tensor, lp, cfg: SAMConfig) -> torch.Tensor:
    w1, w2 = lp["mlp"]["w1"], lp["mlp"]["w2"]
    if producer_quant_ok(w1) and producer_quant_ok(w2):
        # producer-side quantize: the affine LN is a modulation with
        # smod = scale - 1 and shift = bias; GELU emits int8 directly
        shp = tuple(xin.shape)
        x3 = xin.reshape(shp[0], -1, shp[-1])
        shift, smod = _modulation(lp["ln2"], shp[0])
        qa = norm_modulate_quant(x3, shift, smod, cfg.norm_eps)
        up = linear(qa, w1) + lp["mlp"]["b1"]
        out = linear(gelu_quant(up), w2) + lp["mlp"]["b2"]
        return xin + out.reshape(shp[:-1] + (out.shape[-1],))
    hmid = _layernorm(xin, lp["ln2"], cfg.norm_eps)
    hmid = gelu(linear(hmid, w1) + lp["mlp"]["b1"])
    return xin + linear(hmid, w2) + lp["mlp"]["b2"]


@torch.no_grad()
def encode_image(params: Dict[str, Any], images: torch.Tensor, cfg: SAMConfig) -> torch.Tensor:
    """images (N, H, W, C) -> image embedding (N, grid, grid, neck_dim)."""
    pe = params["patch_embed"]
    x = conv2d(images.to(cfg.dtype), pe["kernel"], stride=cfg.patch_size, padding="VALID",
               bias=pe["bias"])
    x = x + params["pos_embed"].to(x.dtype)
    b, h, w, d = x.shape
    ws = cfg.window_size
    pad_h, pad_w = (-h) % ws, (-w) % ws
    hp, wp = h + pad_h, w + pad_w
    vmask = None
    if pad_h or pad_w:
        # pad rows enter later windows only as keys and values, through their
        # normed branch, which this mask zeroes (the reference's numerics)
        v2d = ((torch.arange(hp, device=x.device) < h)[:, None]
               & (torch.arange(wp, device=x.device) < w)[None, :])
        vmask = _window_partition(v2d[None, :, :, None].expand(b, hp, wp, 1).to(cfg.dtype), ws)

    layers = params["layers"]
    glb = set(cfg.global_attn_layers)
    i, n_layers = 0, len(layers)
    while i < n_layers:
        if i in glb:
            lp = layers[i]
            if producer_quant_ok(lp["attn"]["wq"]):
                # global layers have no pad mask: LN emits int8 straight into
                # the three q, k, v linears
                shift, smod = _modulation(lp["ln1"], b)
                xa = norm_modulate_quant(x.reshape(b, h * w, d), shift, smod, cfg.norm_eps)
            else:
                xa = _layernorm(x, lp["ln1"], cfg.norm_eps).reshape(b, h * w, d)
            xa = _mha(lp["attn"], xa, xa, cfg.n_heads, rel_side=h)
            x = x + xa.reshape(b, h, w, d)
            x = _mlp(x, lp, cfg)
            i += 1
            continue
        # a run of windowed layers [i, j): one partition, one merge
        xw = F.pad(x, (0, 0, 0, pad_w, 0, pad_h)) if (pad_h or pad_w) else x
        xw = _window_partition(xw, ws)  # (b*nw, ws*ws, d)
        while i < n_layers and i not in glb:
            lp = layers[i]
            xa = _layernorm(xw, lp["ln1"], cfg.norm_eps)
            if vmask is not None:
                xa = xa * vmask
            xa = _mha(lp["attn"], xa, xa, cfg.n_heads, rel_side=ws)
            xw = xw + xa
            xw = _mlp(xw, lp, cfg)
            i += 1
        x = _window_merge(xw, ws, b, hp, wp)[:, :h, :w]
    nk = params["neck"]
    x = conv2d(x, nk["conv1"]["kernel"], stride=1, padding="SAME")
    x = _layernorm(x, nk["ln1"], cfg.norm_eps)
    x = conv2d(x, nk["conv2"]["kernel"], stride=1, padding="SAME")
    return _layernorm(x, nk["ln2"], cfg.norm_eps)


def _point_pe(prompt, coords: torch.Tensor, image_size: int) -> torch.Tensor:
    """Random-Fourier positional encoding of (x, y) pixel coords (shifted to
    pixel centers, the original's convention)."""
    norm = (coords.to(torch.float32) + 0.5) / image_size * 2.0 - 1.0
    proj = norm @ prompt["pe_gaussian"] * (2.0 * math.pi)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def encode_points(params: Dict[str, Any], coords: torch.Tensor, labels: torch.Tensor,
                  cfg: SAMConfig) -> torch.Tensor:
    """coords (N, P, 2) pixel xy; labels (N, P) in {-1 pad, 0 neg, 1 pos,
    2 box-TL, 3 box-BR} -> sparse prompt embeddings (N, P, neck_dim)."""
    prompt = params["prompt"]
    pe = _point_pe(prompt, coords, cfg.image_size).to(cfg.dtype)
    emb = prompt["point_embed"].to(cfg.dtype)[labels.long() + 1]
    # padding points keep only their label embedding (no position)
    pe = torch.where((labels == -1)[..., None], 0.0, pe)
    return pe + emb


def encode_boxes(params: Dict[str, Any], boxes: torch.Tensor, cfg: SAMConfig) -> torch.Tensor:
    """boxes (N, B, 4) pixel (x1, y1, x2, y2) -> embeddings (N, 2B, nd):
    each box becomes its two corner points with the TL / BR label types."""
    n, nb, _ = boxes.shape
    corners = boxes.reshape(n, nb * 2, 2)
    labels = torch.tensor([2, 3], dtype=torch.int32, device=boxes.device).repeat(n, nb)
    return encode_points(params, corners, labels, cfg)


def _grid_pe(params, cfg: SAMConfig, device) -> torch.Tensor:
    g = cfg.grid
    # patch centers; -0.5 cancels _point_pe's pixel-center shift
    xs = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) * cfg.patch_size - 0.5
    gx, gy = torch.meshgrid(xs, xs, indexing="xy")
    coords = torch.stack([gx, gy], dim=-1).reshape(1, g * g, 2)
    return _point_pe(params["prompt"], coords, cfg.image_size)


def _mlp3(t, mp):
    # the original's output MLPs use ReLU (the encoder and upscaler GELU)
    t = torch.relu(linear(t, mp["w1"]) + mp["b1"])
    t = torch.relu(linear(t, mp["w2"]) + mp["b2"])
    return linear(t, mp["w3"]) + mp["b3"]


@torch.no_grad()
def decode_masks(params: Dict[str, Any], image_embed: torch.Tensor, sparse_prompt: torch.Tensor,
                 cfg: SAMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-way transformer decode: image_embed (N, g, g, nd), sparse_prompt
    (N, P, nd) -> (mask logits (N, n_mask_tokens, 4g, 4g) f32, IoU
    predictions (N, n_mask_tokens) f32)."""
    dec = params["decoder"]
    prompt = params["prompt"]
    n, g, _, nd = image_embed.shape
    base = dec["tokens"].to(image_embed.dtype)
    tokens = torch.cat([base[None].expand(n, *base.shape), sparse_prompt], dim=1)
    # dense prompt: with no mask input, the learned no-mask embedding is
    # added to every image-embedding position
    src = image_embed.reshape(n, g * g, nd)
    src = src + prompt["no_mask_embed"].to(src.dtype)
    img_pe = _grid_pe(params, cfg, src.device).to(src.dtype)
    eps, heads = cfg.norm_eps, cfg.decoder_heads

    q = tokens
    qpe = tokens  # query PE = the initial token embeddings, re-added per layer
    for li, lp in enumerate(dec["layers"]):
        if li == 0:
            # first layer: self-attention replaces the queries (no PE, no
            # residual: the original's skip_first_layer_pe)
            q = _mha(lp["self_attn"], q, q, heads)
        else:
            sq = q + qpe
            q = q + _mha(lp["self_attn"], sq, sq, heads, v_in=q)
        q = _layernorm(q, lp["ln1"], eps)
        q = _layernorm(q + _mha(lp["cross_t2i"], q + qpe, src + img_pe, heads, v_in=src),
                       lp["ln2"], eps)
        hid = torch.relu(linear(q, lp["mlp"]["w1"]) + lp["mlp"]["b1"])
        q = _layernorm(q + linear(hid, lp["mlp"]["w2"]) + lp["mlp"]["b2"], lp["ln3"], eps)
        src = _layernorm(src + _mha(lp["cross_i2t"], src + img_pe, q + qpe, heads, v_in=q),
                         lp["ln4"], eps)
    q = _layernorm(q + _mha(dec["final_t2i"], q + qpe, src + img_pe, heads, v_in=src),
                   dec["ln_final"], eps)

    iou_tok = q[:, 0]
    mask_toks = q[:, 1:1 + cfg.n_mask_tokens]
    img = src.reshape(n, g, g, nd)
    up = conv_transpose2d(img, dec["up1"]["kernel"], stride=2, bias=dec["up1"]["bias"])
    up = gelu(_layernorm(up, dec["up_ln"], eps))
    up = gelu(conv_transpose2d(up, dec["up2"]["kernel"], stride=2, bias=dec["up2"]["bias"]))
    hyper = [_mlp3(mask_toks[:, i], mp) for i, mp in enumerate(dec["hyper_mlps"])]
    hyper_w = torch.stack(hyper, dim=1)  # (N, n_masks, nd/8)
    dt = torch.promote_types(hyper_w.dtype, up.dtype)
    masks = torch.einsum("nmc,nhwc->nmhw", hyper_w.to(dt), up.to(dt)).to(torch.float32)
    iou = _mlp3(iou_tok, dec["iou_head"])
    return masks, iou.to(torch.float32)


@torch.no_grad()
def forward(params: Dict[str, Any], images: torch.Tensor, coords: torch.Tensor,
            labels: torch.Tensor, cfg: SAMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole pipeline: images + point prompts -> (mask logits, IoU)."""
    emb = encode_image(params, images, cfg)
    sparse = encode_points(params, coords, labels, cfg)
    return decode_masks(params, emb, sparse, cfg)
