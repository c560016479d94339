"""W4A8 (int8 dynamic activations x int4 weights): the port against the JAX
package on the same numpy inputs.

* K3 (W4A8 matmul), K4 (magic8 -> int8 requant) and K12 (SwiGLU + int8
  quant): the port's plain versions against the Pallas kernels in interpret
  mode, each kernel called alone and waited for before anything else runs.
* Bit for bit, with no reduction across values: the per-token activation
  quantize, and ``quantize_`` under ``Int8DynamicActivationInt4WeightConfig``.
* The linear on both routes (M <= 512: K3; M > 512: K4 + the int8 GEMM) and
  the producer-quantized MLP against the JAX package's CPU (XLA) path.

The CUDA kernels themselves run only on the card (tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ao_tpu
from ao_tpu.models import llama as jllama
from ao_tpu.ops import act_quant as jact
from ao_tpu.ops import kernels as jkernels
from ao_tpu.ops import linear as jlinear
from ao_tpu.ops.pallas.fused_act import silu_mul_quant_pallas
from ao_tpu.ops.pallas.int4_matmul import (
    int4_magic8_requant_int8_pallas, int4_w4a8_matmul_pallas,
)
from ao_tpu.quantization.primitives import ZeroPointDomain as JZPD
from ao_tpu.quantization.qarrays.common import ActQuantSpec as JSpec
from ao_tpu.quantization.qarrays.int4 import Int4Array as JInt4Array

import ao_tpu_torch
from ao_tpu_torch.models import llama as tllama
from ao_tpu_torch.ops import act_quant as tact
from ao_tpu_torch.ops import kernels as tkernels
from ao_tpu_torch.ops.hopper import fused_act as k12
from ao_tpu_torch.ops.hopper import int4_matmul as k34
from ao_tpu_torch.ops.linear import _requant_scale, linear as tlinear
from ao_tpu_torch.quantization.primitives import compute_error
from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec as TSpec

from torch_port_helpers import assert_bit_equal, jax_to_torch, torch_from_np

SPEC = JSpec(dtype="int8", granularity="per_token", symmetric=True)


def _sqnr(a, b):
    return float(compute_error(torch.as_tensor(np.asarray(a, np.float32)),
                               torch.as_tensor(np.asarray(b, np.float32))))


def _w4a8_weight(k, n, g, seed, domain=JZPD.FLOAT):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    qj = JInt4Array.from_hp(jnp.asarray(w), group_size=g, zero_point_domain=domain,
                            act_quant=SPEC)
    assert qj.layout == "magic8"
    return qj, jax_to_torch(qj)


def _lsb_diff(got, ref):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("domain", [JZPD.FLOAT, JZPD.INT])
def test_k3_plain_matches_pallas_interpret(domain):
    m, k, n, g = 8, 256, 128, 32
    qj, qt = _w4a8_weight(k, n, g, seed=1, domain=domain)
    x = np.random.default_rng(2).standard_normal((m, k)).astype(np.float32)
    xq, sx, _ = jact.quantize_activation(jnp.asarray(x), SPEC)
    with pltpu.force_tpu_interpret_mode():
        ref = int4_w4a8_matmul_pallas(xq, sx, qj.qdata, qj.scale, qj.zero_point, g,
                                      qj.zero_point_domain).block_until_ready()
    got = k34.int4_w4a8_matmul(torch_from_np(xq), torch_from_np(sx), qt.qdata, qt.scale,
                               qt.zero_point, g, qt.zero_point_domain)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    sqnr = _sqnr(ref, got.numpy())
    # the same exact integer dots and bf16 qparams, f32 sums in another
    # order: the JAX suite's bound for the kernel
    assert sqnr >= 45, f"K3 plain vs Pallas: {sqnr:.2f} dB"


def test_k4_plain_matches_pallas_interpret():
    k, n, g = 512, 256, 64
    qj, qt = _w4a8_weight(k, n, g, seed=3)
    sg, bg, s8 = _requant_scale(qt)
    with pltpu.force_tpu_interpret_mode():
        ref = int4_magic8_requant_int8_pallas(
            qj.qdata, jnp.asarray(sg.numpy()), jnp.asarray(bg.numpy()), jnp.asarray(s8.numpy()),
            g).block_until_ready()
    got = k34.int4_magic8_requant_int8(qt.qdata, sg, bg, s8, g)
    assert got.dtype == torch.int8 and got.shape == (k, n)
    worst, frac = _lsb_diff(got.numpy(), ref)
    # the multiply and the add may contract into one rounding on the JAX
    # side: the JAX suite's bound, at most 1 LSB on under 1 % of elements
    assert worst <= 1 and frac < 0.01, f"K4 plain vs Pallas: max {worst} LSB on {frac:.4%}"


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_k12_plain_matches_pallas_interpret(act):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((1, 32, 256)).astype(np.float32)
    b = rng.standard_normal((1, 32, 256)).astype(np.float32)
    ab, bb = jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        qr, sr = silu_mul_quant_pallas(ab, bb, act=act)
        qr = qr.block_until_ready()
    q, s = k12.silu_mul_quant(torch_from_np(ab), torch_from_np(bb), act=act)
    assert q.dtype == torch.int8 and q.shape == (1, 32, 256) and s.shape == (1, 32, 1)
    worst, frac = _lsb_diff(q.numpy(), qr)
    assert worst <= 1 and frac < 0.01, f"K12 q: max {worst} LSB on {frac:.4%}"
    rel = float(np.max(np.abs(s.numpy() - np.asarray(sr)) / np.asarray(sr)))
    assert rel <= 1e-6, f"K12 scales: max relative difference {rel:.3g}"


@pytest.mark.parametrize("symmetric", [True, False])
def test_quantize_activation_bit_exact(symmetric):
    x = (np.random.default_rng(5).standard_normal((2, 3, 64)) * 3).astype(np.float32)
    jq, js, jz = jact.quantize_activation(jnp.asarray(x), JSpec(symmetric=symmetric))
    tq, ts, tz = tact.quantize_activation(torch.from_numpy(x), TSpec(symmetric=symmetric))
    assert_bit_equal(jq, tq)
    assert_bit_equal(js, ts)
    if symmetric:
        assert jz is None and tz is None
    else:
        assert_bit_equal(jz, tz)


def test_quantize_config_bit_exact_and_carried():
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    jq = ao_tpu.quantize_({"w1": jnp.asarray(w)},
                          ao_tpu.Int8DynamicActivationInt4WeightConfig(group_size=32))["w1"]
    tq = ao_tpu_torch.quantize_({"w1": torch.from_numpy(w)},
                                ao_tpu_torch.Int8DynamicActivationInt4WeightConfig(group_size=32))["w1"]
    carried = jax_to_torch(jq)  # params_from_numpy
    for got in (tq, carried):
        assert got.layout == "magic8" and got._layout == "magic8"
        assert got.act_quant == TSpec(dtype="int8", granularity="per_token", symmetric=True)
        assert got.zero_point_domain is ao_tpu_torch.ZeroPointDomain.FLOAT
        for field in ("qdata", "scale", "zero_point"):
            assert_bit_equal(getattr(jq, field), getattr(got, field))


@pytest.mark.parametrize("m", [8, 544])  # K3's route and the requant route (M > 512)
def test_int4_linear_matches_jax(m):
    k, n, g = 256, 128, 32
    qj, qt = _w4a8_weight(k, n, g, seed=7)
    x = np.random.default_rng(8).standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(jlinear(jnp.asarray(x), qj))
    for backend in ("auto", "torch"):
        with tkernels.backend(backend):
            got = tlinear(torch.from_numpy(x), qt)
        assert got.dtype == torch.float32 and got.shape == (m, n)
        sqnr = _sqnr(ref, got.numpy())
        # the same quantized activation and weight; the routes differ in the
        # order of f32 sums (and, for M > 512, by 1 LSB of a requantized
        # weight where the multiply-add rounds differently)
        assert sqnr >= 40, f"{backend} linear at M={m}: {sqnr:.2f} dB"
    assert k34.int4_w4a8_matmul.launches == 0 and k34.int4_magic8_requant_int8.launches == 0


def test_int8_dynamic_matmul_zero_points_bit_exact():
    rng = np.random.default_rng(9)
    qx = rng.integers(-128, 128, (24, 64)).astype(np.int8)
    qw = rng.integers(-128, 128, (64, 32)).astype(np.int8)
    sx = rng.random((24, 1)).astype(np.float32)
    zx = rng.integers(-5, 5, (24, 1)).astype(np.int32)
    sw = rng.random((1, 32)).astype(np.float32)
    zw = rng.integers(-3, 3, (1, 32)).astype(np.int32)
    ref = jkernels.int8_dynamic_matmul(*(jnp.asarray(a) for a in (qx, sx, zx, qw, sw, zw)),
                                       (64, 1), out_dtype=jnp.float32)
    got = tkernels.int8_dynamic_matmul(*(torch.from_numpy(a) for a in (qx, sx, zx, qw, sw, zw)),
                                       (64, 1), out_dtype=torch.float32)
    assert_bit_equal(ref, got)


def test_mlp_producer_quant_matches_jax():
    cfg = jllama.LlamaConfig(vocab_size=512, dim=256, n_layers=1, n_heads=2, n_kv_heads=1,
                             ffn_dim=512, dtype=jnp.bfloat16)
    rng = np.random.default_rng(10)
    layer = {key: jnp.asarray((rng.standard_normal(shape) * 0.05).astype(np.float32))
             for key, shape in (("w1", (256, 512)), ("w3", (256, 512)), ("w2", (512, 256)))}
    jl = ao_tpu.quantize_(layer, ao_tpu.Int8DynamicActivationInt4WeightConfig(group_size=32))
    tl = jax_to_torch(jl)
    assert tact.producer_quant_ok(tl["w2"])
    x = jnp.asarray(rng.standard_normal((2, 16, 256)).astype(np.float32)).astype(jnp.bfloat16)
    ref = jax.jit(lambda p, h: jllama.mlp(p, h, cfg))(jl, x)
    k12.silu_mul_quant.launches = 0
    got = tllama.mlp(tl, torch_from_np(x))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 256)
    sqnr = _sqnr(np.asarray(ref.astype(jnp.float32)), got.float().numpy())
    # JAX dequantizes the int8 gate to bf16 and multiplies in bf16 on the
    # CPU; the port's K3 route keeps exact integer dots
    assert sqnr >= 35, f"producer-quant mlp: {sqnr:.2f} dB"
    assert k12.silu_mul_quant.launches == 0


def test_quantized_activation_and_guards():
    rng = np.random.default_rng(11)
    _, qt = _w4a8_weight(256, 128, 32, seed=11)
    a = torch.from_numpy(rng.standard_normal((1, 4, 256)).astype(np.float32))
    qa = tact.silu_mul_quant(a, a)
    assert qa.dtype == torch.bfloat16 and qa.shape == (1, 4, 256) and qa.ndim == 3
    # an unquantized weight dequantizes a producer-quantized activation
    w = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32)).to(torch.bfloat16)
    y = tlinear(qa, w)
    want = (qa.qdata.float() * qa.scale).to(torch.bfloat16) @ w
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)
    # a quantized linear takes it directly; its output dtype is bf16
    assert tlinear(qa, qt).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="act_pre_scale"):
        tlinear(qa, qt.replace(act_pre_scale=torch.ones(256)))
    assert not tact.producer_quant_ok(qt.replace(act_pre_scale=torch.ones(256)))
    # fp8 activation specs quantize (bit for bit against JAX in
    # tests/test_torch_int8_fp8.py); they have no zero point
    q8, s8, z8 = tact.quantize_activation(a, TSpec(dtype="float8_e4m3fn"))
    assert q8.dtype == torch.float8_e4m3fn and s8.shape == (1, 4, 1) and z8 is None
    # the GELU and LayerNorm producers run (against JAX in
    # tests/test_torch_vision.py): per-token int8 and an f32 scale per row
    for qa in (tact.gelu_quant(a), tact.norm_modulate_quant(a, a[:, 0], a[:, 0], 1e-6)):
        assert qa.qdata.dtype == torch.int8 and qa.qdata.shape == (1, 4, 256)
        assert qa.scale.dtype == torch.float32 and qa.scale.shape == (1, 4, 1)


def test_kernel_shape_rules():
    word = torch.zeros((32, 128), dtype=torch.int32)  # K = 256
    xq = torch.zeros((8, 256), dtype=torch.int8)
    sx = torch.ones((8, 1))
    s = torch.ones((8, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one of"):
        k34.int4_w4a8_matmul(xq, sx, word, s, s, 16, ao_tpu_torch.ZeroPointDomain.FLOAT)
    with pytest.raises(ValueError, match="multiple of 128"):
        k34.check_shapes_w4a8(xq, word[:, :96], 32)
    with pytest.raises(ValueError, match="K mismatch"):
        k34.check_shapes_w4a8(xq[:, :128], word, 32)
    with pytest.raises(ValueError, match="of 256"):
        k34.check_shapes_requant(word[:16], 32)
    with pytest.raises(ValueError, match="multiple of 64"):
        k34.check_shapes_requant(word[:, :96], 32)
    a = torch.zeros((1, 4, 200))
    with pytest.raises(ValueError, match="multiple of 128"):
        k12.silu_mul_quant(a, a)
    with pytest.raises(ValueError, match="act"):
        k12.silu_mul_quant(a[..., :128], a[..., :128], act="relu")
    with pytest.raises(ValueError, match="one shape"):
        k12.silu_mul_quant(a[0, :, :128], a[0, :, :128])
    with tkernels.backend("cuda"), pytest.raises(ValueError, match="CUDA tensors"):
        tact.silu_mul_quant(a[..., :128], a[..., :128])
