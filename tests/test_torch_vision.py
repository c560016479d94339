"""The vision slice of the port against the JAX package, on the same numpy
inputs: convolutions, ViT and SAM, and the plain versions of their kernels.

* ``ops/conv.py``: ``conv2d`` and ``conv_transpose2d`` (``jax.lax``'s
  convention, not torch's) on random, non-symmetric kernels.
* K11 (int4 split-half matmul), K12n / K12g (LayerNorm-modulate and GELU
  with a per-token int8 quantize) and K16 (windowed attention with the
  decomposed rel-pos bias): the port's plain versions against the Pallas
  kernels in interpret mode, each kernel called alone and waited for.
* ``models/vit.py`` (VIT_TINY in f32 and under int4-WO, group 32: the
  split-half layout) and ``models/sam.py`` (a tiny SAM whose grid is no
  multiple of its window, so the pad mask runs, with its rel-pos tables
  filled) against the JAX package's CPU (XLA) path, both backends.

The CUDA kernels themselves run only on the card (tests/test_torch_kernels_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ao_tpu
from ao_tpu.models import sam as jsam
from ao_tpu.models import vit as jvit
from ao_tpu.ops import act_quant as jact
from ao_tpu.ops import conv as jconv
from ao_tpu.ops.pallas.fused_act import gelu_quant_pallas, norm_modulate_quant_pallas
from ao_tpu.ops.pallas.int4_matmul import int4_wo_matmul_pallas
from ao_tpu.ops.pallas.window_attention import window_bias_attention as jwindow_attention
from ao_tpu.quantization.primitives import ZeroPointDomain as JZPD
from ao_tpu.quantization.qarrays.int4 import Int4Array as JInt4Array

import ao_tpu_torch
from ao_tpu_torch.models import sam as tsam
from ao_tpu_torch.models import vit as tvit
from ao_tpu_torch.ops import act_quant as tact
from ao_tpu_torch.ops import conv as tconv
from ao_tpu_torch.ops import kernels as tkernels
from ao_tpu_torch.ops.hopper import fused_act as k12
from ao_tpu_torch.ops.hopper import int4_matmul as k11
from ao_tpu_torch.ops.hopper import window_attention as k16
from ao_tpu_torch.ops.linear import linear as tlinear
from ao_tpu_torch.quantization.primitives import compute_error

from torch_port_helpers import jax_to_torch, jax_tree_to_numpy, torch_from_np


def _sqnr(a, b):
    return float(compute_error(torch.as_tensor(np.asarray(a, np.float32)),
                               torch.as_tensor(np.asarray(b, np.float32))))


def _lsb_diff(got, ref):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    return int(d.max()), float((d > 0).mean())


# ---------------------------------------------------------------------------
# ops/conv.py
# ---------------------------------------------------------------------------

CONV_CASES = [  # (H, W, kernel, stride, padding)
    (9, 10, 3, 1, "SAME"), (10, 11, 3, 2, "SAME"), (16, 16, 4, 4, "VALID"),
    (7, 9, 2, 2, "SAME"), (8, 8, 3, 2, ((1, 2), (0, 1))),
]


@pytest.mark.parametrize("fn", ["conv2d", "conv_transpose2d"])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"{c[0]}x{c[1]}k{c[2]}s{c[3]}")
def test_conv_matches_jax(fn, case):
    h, w, k, s, pad = case
    rng = np.random.default_rng(k * 10 + s)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    kern = rng.standard_normal((k, k, 3, 5)).astype(np.float32)  # no symmetry to hide a flip
    bias = rng.standard_normal(5).astype(np.float32)
    ref = np.asarray(getattr(jconv, fn)(jnp.asarray(x), jnp.asarray(kern), stride=s,
                                        padding=pad, bias=jnp.asarray(bias)))
    got = getattr(tconv, fn)(torch.from_numpy(x), torch.from_numpy(kern), stride=s, padding=pad,
                             bias=torch.from_numpy(bias))
    assert got.shape == ref.shape and got.dtype == torch.float32
    # the same f32 products; the two libraries sum them in other orders
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_conv_transpose_is_not_torchs_convention():
    """torch's conv_transpose2d flips the kernel; on a non-symmetric kernel
    it gives another result than JAX's and the port's."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 2)).astype(np.float32))
    kern = torch.from_numpy(rng.standard_normal((2, 2, 2, 3)).astype(np.float32))
    ours = tconv.conv_transpose2d(x, kern, stride=2)
    torchs = torch.nn.functional.conv_transpose2d(
        x.permute(0, 3, 1, 2), kern.permute(2, 3, 0, 1), stride=2).permute(0, 2, 3, 1)
    flipped = torch.nn.functional.conv_transpose2d(
        x.permute(0, 3, 1, 2), kern.flip(0, 1).permute(2, 3, 0, 1), stride=2).permute(0, 2, 3, 1)
    assert ours.shape == torchs.shape == (1, 8, 8, 3)
    assert not torch.allclose(ours, torchs, atol=1e-3)
    torch.testing.assert_close(ours, flipped, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K11: int4 split-half matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,g,domain", [
    (8, 256, 128, 32, JZPD.FLOAT),    # M <= 64: the TPU's two-plane kernel
    (100, 384, 256, 128, JZPD.FLOAT),  # its tile kernel; K/g = 3
    (40, 192, 128, 64, JZPD.INT),
])
def test_k11_plain_matches_pallas_interpret(m, k, n, g, domain):
    rng = np.random.default_rng(m + k)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    qj = JInt4Array.from_hp(jnp.asarray(w), group_size=g, zero_point_domain=domain,
                            layout="halves")
    qt = jax_to_torch(qj)
    assert qt.layout == "halves" and qt.qdata.dtype == torch.uint8
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = int4_wo_matmul_pallas(x, qj.qdata, qj.scale, qj.zero_point, g,
                                    qj.zero_point_domain).block_until_ready()
    got = k11.int4_wo_matmul(torch_from_np(x), qt.qdata, qt.scale, qt.zero_point, g,
                             qt.zero_point_domain)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    sqnr = _sqnr(np.asarray(ref.astype(jnp.float32)), got.float().numpy())
    # the same bf16 weights and x, f32 sums in another order, bf16 out: the
    # JAX suite's bound for the kernel (tests/test_pallas_interpret.py)
    assert sqnr >= 45, f"K11 plain vs Pallas: {sqnr:.2f} dB"
    assert k11.int4_wo_matmul.launches == 0


def test_k11_route_and_refusals():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 192)).astype(np.float32))
    for n, taken in ((256, True), (200, False)):  # N % 128: ViT's 1000-class head is refused
        w = torch.from_numpy((rng.standard_normal((192, n)) * 0.05).astype(np.float32))
        qa = ao_tpu_torch.quantize_({"w1": w}, ao_tpu_torch.Int4WeightOnlyConfig(group_size=64))
        qa = qa["w1"]
        assert qa.layout == "halves"  # K/g = 3
        assert k11.takes_halves(192, n, 64) is taken
        with tkernels.backend("torch"):
            plain = tlinear(x, qa)
        got = tlinear(x, qa)
        # the kernel route's plain version rounds x and each weight to bf16
        assert _sqnr(plain.numpy(), got.numpy()) >= (35 if taken else 200)
    assert not k11.takes_halves(192, 256, 16)  # g % 32
    assert not k11.takes_halves(200, 256, 32)  # K % g
    with pytest.raises(ValueError, match="N % 128"):
        k11.int4_wo_matmul(x.to(torch.bfloat16), torch.zeros((96, 200), dtype=torch.uint8),
                           torch.ones((3, 200)), torch.zeros((3, 200)), 64, JZPD.FLOAT)
    assert k11.int4_wo_matmul.launches == 0


# ---------------------------------------------------------------------------
# K12n and K12g: producer-side int8 quantize
# ---------------------------------------------------------------------------


def _modulated_input(seed, b=2, t=100, d=256):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    h = jax.random.normal(ks[0], (b, t, d), jnp.bfloat16)  # ragged T: the TPU pads rows
    sh = jax.random.normal(ks[1], (b, d), jnp.float32) * 0.1  # a row per batch row
    sm = jax.random.normal(ks[2], (b, d), jnp.float32) * 0.1
    return h, sh, sm


def _check_codes(q, s, qr, sr, what):
    worst, frac = _lsb_diff(q.numpy(), qr)
    # XLA's CPU mean sums in windows of 32 and torch's in another order (one
    # ulp of the moments), and jit may divide by 127 as a multiply by its
    # reciprocal: a code at a rounding tie moves by one, on under 1 %
    assert worst <= 1 and frac < 0.01, f"{what} q: max {worst} LSB on {frac:.4%}"
    rel = float(np.max(np.abs(s.numpy() - np.asarray(sr)) / np.asarray(sr)))
    assert rel <= 1e-5, f"{what} scales: max relative difference {rel:.3g}"


def test_k12n_plain_matches_pallas_interpret_and_xla():
    h, sh, sm = _modulated_input(0)
    with pltpu.force_tpu_interpret_mode():
        qr, sr = norm_modulate_quant_pallas(h, sh, sm, 1e-6)
        qr = qr.block_until_ready()
    q, s = k12.norm_modulate_quant(torch_from_np(h), torch_from_np(sh), torch_from_np(sm), 1e-6)
    assert q.dtype == torch.int8 and q.shape == (2, 100, 256) and s.shape == (2, 100, 1)
    _check_codes(q, s, qr, sr, "K12n vs Pallas")
    xla = jact.norm_modulate_quant(h, sh, sm, 1e-6)  # the JAX package's CPU path
    _check_codes(q, s, xla.qdata, xla.scale, "K12n vs XLA")
    # a broadcast modulation row (stride 0), as SAM passes its LayerNorm affine
    one = torch_from_np(sh[:1]).expand(2, 256)
    q1, _ = k12.norm_modulate_quant(torch_from_np(h), one, torch_from_np(sm[:1]).expand(2, 256),
                                    1e-6)
    qc, _ = k12.norm_modulate_quant(torch_from_np(h), one.contiguous(),
                                    torch_from_np(sm[:1]).expand(2, 256).contiguous(), 1e-6)
    assert torch.equal(q1, qc)
    assert k12.norm_modulate_quant.launches == 0


@pytest.mark.parametrize("t", [64, 100])
def test_k12g_plain_matches_pallas_interpret_and_xla(t):
    y = jax.random.normal(jax.random.PRNGKey(t), (2, t, 128), jnp.bfloat16) * 2
    with pltpu.force_tpu_interpret_mode():
        qr, sr = gelu_quant_pallas(y)
        qr = qr.block_until_ready()
    q, s = k12.gelu_quant(torch_from_np(y))
    assert q.dtype == torch.int8 and q.shape == (2, t, 128) and s.shape == (2, t, 1)
    _check_codes(q, s, qr, sr, "K12g vs Pallas")
    xla = jact.gelu_quant(y)
    _check_codes(q, s, xla.qdata, xla.scale, "K12g vs XLA")
    assert k12.gelu_quant.launches == 0


def test_producers_route_and_refusals():
    h, sh, sm = _modulated_input(1, t=8, d=96)  # D % 128 != 0: the kernels refuse
    th, tsh, tsm = torch_from_np(h), torch_from_np(sh), torch_from_np(sm)
    assert not k12.takes((2, 8, 96)) and k12.takes((2, 8, 256))
    for backend in ("auto", "torch"):
        with tkernels.backend(backend):
            qa = tact.norm_modulate_quant(th, tsh, tsm, 1e-6)
            qg = tact.gelu_quant(th)
        want = k12.norm_modulate_quant_plain(th, tsh, tsm, 1e-6)
        assert torch.equal(qa.qdata, want[0]) and torch.equal(qa.scale, want[1])
        assert torch.equal(qg.qdata, k12.gelu_quant_plain(th)[0])
    with pytest.raises(ValueError, match="multiple of 128"):
        k12.gelu_quant(th)
    with pytest.raises(ValueError, match="multiple of 128"):
        k12.norm_modulate_quant(th, tsh, tsm, 1e-6)


# ---------------------------------------------------------------------------
# K16: windowed attention with the decomposed rel-pos bias
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", [4, 6])  # T = 16 and 36: one key tile, ragged
def test_k16_plain_matches_pallas_interpret(side):
    g, nh, hd = 2, 2, 64
    t = side * side
    kq, kk, kv, kh, kw = jax.random.split(jax.random.PRNGKey(side), 5)
    q = jax.random.normal(kq, (g, t, nh, hd), jnp.bfloat16)
    k = jax.random.normal(kk, (g, t, nh, hd), jnp.bfloat16)
    v = jax.random.normal(kv, (g, t, nh, hd), jnp.bfloat16)
    # non-zero rel terms, scaled as tests/test_pallas_tpu.py scales them: a
    # kernel that dropped the bias would fail here
    rh = jax.random.normal(kh, (g, nh, t, side), jnp.float32) * 0.3
    rw = jax.random.normal(kw, (g, nh, t, side), jnp.float32) * 0.3
    with pltpu.force_tpu_interpret_mode():
        ref = jwindow_attention(q, k, v, rh, rw, side=side, scale=hd ** -0.5).block_until_ready()
    args = [torch_from_np(a) for a in (q, k, v, rh, rw)]
    got = k16.window_bias_attention(*args, side=side, scale=hd ** -0.5)
    assert got.dtype == torch.bfloat16 and got.shape == (g, t, nh * hd)
    ref = np.asarray(ref.astype(jnp.float32))
    sqnr = _sqnr(ref, got.float().numpy())
    # the JAX suite's bound for the kernel (tests/test_pallas_tpu.py)
    assert sqnr >= 35, f"K16 plain vs Pallas: {sqnr:.2f} dB"
    nobias = k16.window_bias_attention(*args[:3], torch.zeros_like(args[3]),
                                       torch.zeros_like(args[4]), side=side, scale=hd ** -0.5)
    assert _sqnr(ref, nobias.float().numpy()) < 20  # the bias matters at this scale
    assert k16.window_bias_attention.launches == 0


def test_k16_refusals():
    q = torch.zeros((1, 16, 2, 32))
    r = torch.zeros((1, 2, 16, 4))
    assert k16.takes(64, 64) and k16.takes(14, 64)
    assert not k16.takes(65, 64) and not k16.takes(14, 32)
    with pytest.raises(ValueError, match="head_dim"):
        k16.window_bias_attention(q, q, q, r, r, side=4, scale=1.0)
    q = torch.zeros((1, 15, 2, 64))
    with pytest.raises(ValueError, match="side"):
        k16.window_bias_attention(q, q, q, r, r, side=4, scale=1.0)


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

TCFG_VIT = tvit.VIT_TINY
JCFG_VIT = jvit.VIT_TINY


def _to_jax(tree):
    """The port's params as the JAX package's (f32 leaves as they are):
    random params from the port's init, made without JAX's slow eager init."""
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.numpy())
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return [_to_jax(v) for v in tree]


@pytest.fixture(scope="module")
def vit_tiny():
    jp = _to_jax(tvit.init_params(TCFG_VIT, torch.Generator().manual_seed(0), device="cpu"))
    images = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    fwd = jax.jit(lambda p, x: jvit.forward(p, x, JCFG_VIT))
    return jp, images, fwd


def test_vit_f32_matches_jax(vit_tiny):
    jp, images, fwd = vit_tiny
    ref = np.asarray(fwd(jp, jnp.asarray(images)))
    tp = jax_to_torch(jp)
    for backend in ("auto", "torch"):
        with tkernels.backend(backend):
            got = tvit.forward(tp, torch.from_numpy(images), TCFG_VIT)
        assert got.dtype == torch.float32 and got.shape == (2, 10)
        # the same f32 arithmetic; sums in other orders
        assert _sqnr(ref, got.numpy()) >= 100


def test_vit_int4_wo_matches_jax(vit_tiny):
    jp, images, fwd = vit_tiny
    jq = ao_tpu.quantize_(jp, ao_tpu.Int4WeightOnlyConfig(group_size=32))
    tq = ao_tpu_torch.quantize_(jax_to_torch(jp), ao_tpu_torch.Int4WeightOnlyConfig(group_size=32))
    layouts = {key: tq["layers"][0][part][key].layout
               for part, key in (("attn", "wq"), ("mlp", "w1"), ("mlp", "w2"))}
    # dim 64, group 32: K/g = 2 -> split-half (w1 is the one K11 takes, N = 128)
    assert layouts == {"wq": "halves", "w1": "halves", "w2": "magic"}
    assert tq["head"]["proj"].layout == "halves"
    ref = np.asarray(fwd(jq, jnp.asarray(images)))
    for backend, need in (("torch", 100), ("auto", 30)):
        with tkernels.backend(backend):
            got = tvit.forward(tq, torch.from_numpy(images), TCFG_VIT)
        # "torch" dequantizes as JAX's XLA path does; "auto" takes the
        # kernels' plain versions (K11 for w1, K1 for w2), which round x and
        # the weights to bf16 (measured 126.5 and 48.5 dB)
        assert _sqnr(ref, got.numpy()) >= need, backend
    assert k11.int4_wo_matmul.launches == 0


# ---------------------------------------------------------------------------
# SAM: a grid no multiple of its window, rel-pos tables filled
# ---------------------------------------------------------------------------

JCFG_SAM = dataclasses.replace(jsam.SAM_TINY, image_size=80)  # grid 10, window 4: padded
TCFG_SAM = dataclasses.replace(tsam.SAM_TINY, image_size=80)
REL_SCALE = 0.3  # the rel-pos terms come out about this large, as the JAX suite scales them


def _fill_rel_pos(params, seed):
    """init_params zero-initialises the rel-pos tables (the ViTDet
    default), which would hide a dropped bias: fill them from a seed."""
    rng = np.random.default_rng(seed)
    layers = []
    for lp in params["layers"]:
        attn = dict(lp["attn"])
        for key in ("rel_pos_h", "rel_pos_w"):
            shape = attn[key].shape
            attn[key] = jnp.asarray((rng.standard_normal(shape) * REL_SCALE
                                     * shape[-1] ** -0.5).astype(np.float32))
        layers.append(dict(lp, attn=attn))
    return dict(params, layers=layers)


@pytest.fixture(scope="module")
def sam_tiny():
    tp = tsam.init_params(TCFG_SAM, torch.Generator().manual_seed(0), device="cpu")
    jp = _fill_rel_pos(_to_jax(tp), 1)
    rng = np.random.default_rng(2)
    images = rng.standard_normal((2, 80, 80, 3)).astype(np.float32)
    coords = rng.uniform(0, 80, (2, 3, 2)).astype(np.float32)
    labels = np.array([[1, 0, -1], [1, 1, 0]], np.int32)
    fwd = jax.jit(lambda p, x, c, l: jsam.forward(p, x, c, l, JCFG_SAM))
    return jp, (images, coords, labels), fwd


def _sam_inputs(inputs, scale=1.0):
    images, coords, labels = inputs
    return (images * scale, coords, labels)


def test_sam_f32_matches_jax(sam_tiny):
    jp, inputs, fwd = sam_tiny
    ref = [np.asarray(a) for a in fwd(jp, *map(jnp.asarray, inputs))]
    assert ref[0].shape == (2, 4, 40, 40) and ref[1].shape == (2, 4)
    tp = jax_to_torch(jp)
    for backend in ("auto", "torch"):
        with tkernels.backend(backend):
            got = tsam.forward(tp, *map(torch.from_numpy, inputs), TCFG_SAM)
        for what, r, t in zip(("masks", "iou"), ref, got):
            assert t.dtype == torch.float32 and tuple(t.shape) == r.shape
            # the same f32 arithmetic; sums in other orders (measured
            # 120.7 dB masks, 118.4 IoU)
            assert _sqnr(r, t.numpy()) >= 80, (backend, what)
    # the rel-pos tables matter: zero them and the masks move
    zeroed = tsam.init_params(TCFG_SAM, torch.Generator().manual_seed(0), device="cpu")
    masks0, _ = tsam.forward(zeroed, *map(torch.from_numpy, inputs), TCFG_SAM)
    assert _sqnr(ref[0], masks0.numpy()) < 40  # measured 24.1 dB


def test_sam_boxes_match_jax(sam_tiny):
    jp, _, _ = sam_tiny
    boxes = np.array([[[4.0, 8.0, 40.0, 60.0]], [[0.0, 0.0, 79.0, 79.0]]], np.float32)
    ref = np.asarray(jsam.encode_boxes(jp, jnp.asarray(boxes), JCFG_SAM))
    got = tsam.encode_boxes(jax_to_torch(jp), torch.from_numpy(boxes), TCFG_SAM)
    assert got.shape == (2, 2, 32)
    assert _sqnr(ref, got.numpy()) >= 100


def test_sam_w8a8_matches_jax(sam_tiny):
    jp, inputs, fwd = sam_tiny
    jq = ao_tpu.quantize_(jp, ao_tpu.Int8DynamicActivationInt8WeightConfig())
    tq = jax_to_torch(jq)
    assert tact.producer_quant_ok(tq["layers"][0]["mlp"]["w1"])
    ref = [np.asarray(a) for a in fwd(jq, *map(jnp.asarray, inputs))]
    nudged = [np.asarray(a) for a in fwd(jq, *map(jnp.asarray, _sam_inputs(inputs, 1 + 2 ** -8)))]
    for backend in ("auto", "torch"):
        with tkernels.backend(backend):
            got = tsam.forward(tq, *map(torch.from_numpy, inputs), TCFG_SAM)
        for what, r, n, t in zip(("masks", "iou"), ref, nudged, got):
            # past the int8 activation quantizers a one-ulp difference is a
            # whole step: JAX's own floor under a nudge of one bf16 rounding
            # of the images, less 3 dB, and 30 dB where that floor is higher
            # (measured: floors 34.6 / 28.3 dB, the port 33.3 / 28.4)
            need = min(30.0, _sqnr(r, n) - 3.0)
            assert _sqnr(r, t.numpy()) >= need, (backend, what, need)
    assert k12.norm_modulate_quant.launches == 0 and k12.gelu_quant.launches == 0


# ---------------------------------------------------------------------------
# params_from_numpy
# ---------------------------------------------------------------------------


def _assert_carried(a, t):
    """Every array of the numpy tree ``a`` equals its tensor in ``t``, bit
    for bit (a quantized container field by field)."""
    if isinstance(a, np.ndarray):
        b = t.contiguous()
        if b.dtype == torch.bfloat16:
            b, a = b.view(torch.int16), a.view(np.int16)
        assert tuple(b.shape) == a.shape and np.array_equal(b.numpy(), a), "not bit for bit"
    elif isinstance(a, dict) and "__qarray__" in a:
        assert type(t).__name__ == a["__qarray__"]
        for name, v in t.data_fields().items():
            assert (v is None) == (a[name] is None), name
            if v is not None:
                _assert_carried(a[name], v)
    elif isinstance(a, dict):
        assert set(a) == set(t)
        for key in a:
            _assert_carried(a[key], t[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(t)
        for x, y in zip(a, t):
            _assert_carried(x, y)


@pytest.mark.parametrize("model", ["vit", "sam"])
def test_params_from_numpy_carries_vision_trees(model, vit_tiny, sam_tiny):
    jp = (vit_tiny if model == "vit" else sam_tiny)[0]
    config = (ao_tpu.Int4WeightOnlyConfig(group_size=32) if model == "vit"
              else ao_tpu.Int8DynamicActivationInt8WeightConfig())
    for tree in (jp, ao_tpu.quantize_(jp, config)):
        _assert_carried(jax_tree_to_numpy(tree), jax_to_torch(tree))
