"""The int4 weight-only, W4A8 and SwiGLU-quantize routes at shapes their
kernels refuse: each route asks its kernel's ``takes`` before the call and
falls back as the reference does on ``UnsupportedShape`` (dequantize +
matmul for K1, the q/dq path for K3, dequantize + requantize for K4, the
plain gate for K12s), so the port returns the reference's values there.
Both packages take the same numpy inputs on their default backends; each
``takes`` agrees with its wrapper's own refusal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu
from ao_tpu.ops import act_quant as jact
from ao_tpu.ops import linear as jlinear

import ao_tpu_torch
from ao_tpu_torch.ops import act_quant as tact
from ao_tpu_torch.ops.hopper import fused_act as k12
from ao_tpu_torch.ops.hopper import int4_matmul as k1
from ao_tpu_torch.ops.linear import linear as tlinear
from ao_tpu_torch.quantization.primitives import compute_error

from torch_port_helpers import jax_to_torch, torch_from_np

# (K, N, g) that K1 refuses: N % 32 (a vocabulary of 200, 48 or 16 columns)
# or g = 256; and that K3 (N % 128, K % 2g, g <= 128) or K4 (N % 64, K % 256)
# refuse; (384, 128, 64) K3 takes and K4 refuses
WO_SHAPES = [(1024, 200, 128), (512, 48, 128), (256, 16, 64), (1024, 128, 256)]
W4A8_SHAPES = [(512, 96, 128), (384, 128, 64), (1024, 128, 256), (512, 160, 128)]
ROWS = [8, 520]  # decode (K1, K3) and above W4A8's requant gate (K4)


def _sqnr(a, b):
    return float(compute_error(torch.as_tensor(np.asarray(a, np.float32)),
                               torch.as_tensor(np.asarray(b, np.float32))))


def _weights(config, k, n, g, seed):
    w = (np.random.default_rng(seed).standard_normal((k, n)) * 0.02).astype(np.float32)
    jw = ao_tpu.quantize_({"w1": jnp.asarray(w)}, getattr(ao_tpu, config)(group_size=g))["w1"]
    return jw, jax_to_torch(jw)


def _launches():
    return (k1.int4_wo_magic.launches, k1.int4_w4a8_matmul.launches,
            k1.int4_magic8_requant_int8.launches, k12.silu_mul_quant.launches)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("config,shape",
                         [("Int4WeightOnlyConfig", s) for s in WO_SHAPES]
                         + [("Float8DynamicActivationInt4WeightConfig", WO_SHAPES[0])])
def test_int4_weight_routes_fall_back_like_the_reference(config, shape, m):
    k, n, g = shape
    jw, tw = _weights(config, k, n, g, seed=k + n + g)
    assert tw.layout == "magic" and not k1.takes(k, n, g)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(jlinear(jnp.asarray(x), jw))
    before = _launches()
    got = tlinear(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and got.shape == (m, n)  # dequantize + matmul in x's dtype
    # the same dequantized weight and f32 matmul (the fp8 activation held to
    # its quantized values on both sides): only the order of f32 sums differs
    sqnr = _sqnr(ref, got.numpy())
    assert sqnr >= 100, f"{config} {shape} M={m}: {sqnr:.2f} dB"
    assert _launches() == before == (0, 0, 0, 0)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("shape", W4A8_SHAPES)
def test_w4a8_routes_fall_back_like_the_reference(shape, m):
    k, n, g = shape
    jw, tw = _weights("Int8DynamicActivationInt4WeightConfig", k, n, g, seed=k + n + g + 1)
    assert tw.layout == "magic8" and not k1.takes_requant(k, n, g)
    assert k1.takes_w4a8(k, n, g) == (shape == (384, 128, 64))
    x = np.random.default_rng(m + 1).standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(jlinear(jnp.asarray(x), jw))
    got = tlinear(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    # test_torch_w4a8.py::test_int4_linear_matches_jax's bound: the same
    # quantized activation and weight, other orders of f32 sums
    sqnr = _sqnr(ref, got.numpy())
    assert sqnr >= 40, f"W4A8 {shape} M={m}: {sqnr:.2f} dB"
    assert _launches() == (0, 0, 0, 0)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_silu_mul_quant_falls_back_like_the_reference(act):
    rng = np.random.default_rng(12)
    a, b = (jnp.asarray(rng.standard_normal((1, 16, 200)).astype(np.float32))
            .astype(jnp.bfloat16) for _ in range(2))
    assert not k12.takes((1, 16, 200))
    ref = jact.silu_mul_quant(a, b, act=act)
    got = tact.silu_mul_quant(torch_from_np(a), torch_from_np(b), act=act)
    assert got.qdata.shape == (1, 16, 200) and got.scale.shape == (1, 16, 1)
    # test_torch_w4a8.py::test_k12_plain_matches_pallas_interpret's bounds
    d = np.abs(got.qdata.numpy().astype(np.int32) - np.asarray(ref.qdata, np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, f"{act}: max {d.max()} LSB"
    rs = np.asarray(ref.scale)
    assert float(np.max(np.abs(got.scale.numpy() - rs) / rs)) <= 1e-6
    assert _launches() == (0, 0, 0, 0)


def _refuses(check) -> bool:
    try:
        check()
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("kernel", ["K1", "K3", "K4", "K12s"])
def test_takes_agrees_with_the_wrappers_refusal(kernel):
    seen = set()
    for k in (128, 256, 384, 512, 1024):
        for n in (16, 32, 48, 64, 96, 128, 160, 200, 256):
            for g in (8, 16, 32, 64, 128, 256):
                word = torch.zeros((k // 8, n), dtype=torch.int32)
                if kernel == "K1":
                    ok = k1.takes(k, n, g)
                    refused = _refuses(lambda: k1.check_shapes(torch.zeros((1, k)), word, g))
                elif kernel == "K3":
                    ok = k1.takes_w4a8(k, n, g)
                    refused = _refuses(lambda: k1.check_shapes_w4a8(
                        torch.zeros((1, k), dtype=torch.int8), word, g))
                elif kernel == "K4":
                    ok = k1.takes_requant(k, n, g)
                    refused = _refuses(lambda: k1.check_shapes_requant(word, g))
                else:
                    a = torch.zeros((1, 2, n + k))
                    ok = k12.takes(tuple(a.shape))
                    refused = _refuses(lambda: k12.check_shapes(a, a, "silu"))
                assert ok != refused, f"{kernel} at K={k} N={n} g={g}"
                seen.add(ok)
    assert seen == {True, False}
    with pytest.raises(ValueError):
        k12.check_shapes(torch.zeros((1, 2, 128)), torch.zeros((1, 2, 256)), "silu")
    assert ao_tpu_torch.ZeroPointDomain.FLOAT is not None
