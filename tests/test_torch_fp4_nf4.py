"""4-bit float and codebook weights (MXFP4, NVFP4, NF4, with MXFP8 / MXFP6):
the port against the JAX package on the same numpy inputs.

* Bit for bit: e2m1 encode / decode on all 16 codes and on random f32; the
  fp4-magic and NVFP4 scale pair packings; the fp6 codes and packing;
  ``to_mx`` bytes and codes for fp4, both fp8 and both fp6 types in the three
  scale modes; ``nvfp4_quantize``; NF4's codes, quantized scalers, factors
  and mean; ``quantize_`` under every new config and ``dequantize()`` of
  every container, and the carry-over by ``params_from_numpy``.
* Where the reference's own arithmetic rounds (JAX's CPU ``exp2`` is not
  exact at most integer exponents, and ``floor(log2(x))`` is one low at some
  exact powers of two), the port computes exact powers of two: it is held to
  a float64 numpy evaluation of the same formula, and the values that differ
  from JAX's are counted and held to one step.
* SQNR: the plain versions of K14 and K15 (the "auto" route on the CPU)
  against JAX's Pallas kernels in interpret mode, at the JAX suite's bounds
  (tests/test_pallas_interpret.py); ``linear`` of every new config, the
  split-half layouts included, on both backends against JAX's.
* ``generate`` on a tiny f32 config: MXFP4, NVFP4 and NF4 weight-only give
  JAX's greedy tokens; NVFP4 with dynamic fp4 activations is held to JAX's
  logits at a stated bound.
* ``takes``: what K14 and K15 refuse takes the dequantize-and-matmul route.

The CUDA kernels themselves run only on the card (tests/test_torch_kernels_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ao_tpu
from ao_tpu.models import llama as jllama
from ao_tpu.ops import act_quant as jact
from ao_tpu.ops import kernels as jkernels
from ao_tpu.ops import linear as jlinear
from ao_tpu.prototype import mx as jpmx
from ao_tpu.quantization.qarrays import fp4 as jfp4
from ao_tpu.quantization.qarrays import fp6 as jfp6
from ao_tpu.quantization.qarrays import mx as jmx
from ao_tpu.quantization.qarrays import nf4 as jnf4
from ao_tpu.quantization.qarrays import nvfp4 as jnv
from ao_tpu.serving.decode import generate as jgenerate

import ao_tpu_torch
from ao_tpu_torch.models import llama as tllama
from ao_tpu_torch.ops import kernels as tkernels
from ao_tpu_torch.ops.hopper import fp4_matmul as k14
from ao_tpu_torch.ops.hopper import lut4_matmul as k15
from ao_tpu_torch.ops.linear import linear as tlinear
from ao_tpu_torch.quantization.qarrays import fp4 as tfp4
from ao_tpu_torch.quantization.qarrays import fp6 as tfp6
from ao_tpu_torch.quantization.qarrays import mx as tmx
from ao_tpu_torch.quantization.qarrays import nf4 as tnf4
from ao_tpu_torch.quantization.qarrays import nvfp4 as tnv

from torch_port_helpers import assert_bit_equal, jax_to_torch, torch_from_np, torch_to_numpy


def _sqnr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-300)))


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.itemsize > 1 else a.view(np.uint8)


# ---------------------------------------------------------------------------
# exact powers of two

def test_exp2_and_floor_log2_are_exact():
    """The port's helpers against float64 numpy: 2^e at every integer from
    2^-149 to inf, floor(log2) at every power of two and beside it."""
    e = np.arange(-149, 130, dtype=np.float32)
    with np.errstate(over="ignore"):
        want = np.exp2(e.astype(np.float64)).astype(np.float32)  # inf from 128 on
    got = tfp4.exp2_int(torch.from_numpy(e)).numpy()
    assert np.array_equal(_bits(want), _bits(got))
    p = np.exp2(np.arange(-126, 128, dtype=np.float64)).astype(np.float32)
    near = np.concatenate([p, np.nextafter(p, np.float32(0)), np.nextafter(p, np.float32(np.inf))])
    rnd = np.abs(np.random.default_rng(0).standard_normal(4096).astype(np.float32)) + 1e-20
    a = np.concatenate([near[np.isfinite(near)], rnd])
    got = tfp4.floor_log2(torch.from_numpy(a)).numpy()
    assert np.array_equal(got, np.floor(np.log2(a.astype(np.float64))).astype(np.float32))


# ---------------------------------------------------------------------------
# e2m1, the fp4 packings, fp6

def test_e2m1_codes_bit_exact():
    codes = np.arange(16, dtype=np.uint8)
    assert_bit_equal(jfp4.decode_fp4_e2m1(jnp.asarray(codes)),
                     tfp4.decode_fp4_e2m1(torch.from_numpy(codes)))
    grid = np.asarray(jfp4.decode_fp4_e2m1(jnp.asarray(codes)))
    mids = (grid[1:8] + grid[:7]) / 2  # ties between neighbours
    x = np.concatenate([
        grid, mids, -mids, [0.0, -0.0, 6.5, -7.0, 100.0, 1e-8, -1e-8],
        np.nextafter(np.float32([2.0, 4.0, 1.0]), np.float32(0)),
        np.random.default_rng(1).standard_normal(4096) * 3,
    ]).astype(np.float32)
    want = jfp4.encode_fp4_e2m1(jnp.asarray(x))
    got = tfp4.encode_fp4_e2m1(torch.from_numpy(x))
    assert_bit_equal(want, got)
    assert_bit_equal(jfp4.decode_fp4_e2m1(want), tfp4.decode_fp4_e2m1(got))


@pytest.mark.parametrize("k,n", [(256, 128), (64, 40)])
def test_fp4_packings_bit_exact(k, n):
    rng = np.random.default_rng(k + n)
    codes = rng.integers(0, 16, (k, n)).astype(np.uint8)
    jw = jfp4.pack_fp4_magic(jnp.asarray(codes))
    tw = tfp4.pack_fp4_magic(torch.from_numpy(codes))
    assert_bit_equal(jw, tw)
    assert np.array_equal(tfp4.unpack_fp4_magic(tw).numpy(), codes)
    assert_bit_equal(jfp4.pack_fp4(jnp.asarray(codes), 32), tfp4.pack_fp4(torch.from_numpy(codes), 32))
    scale = (rng.random((k // 16, n)) * 40).astype(ml_dtypes.float8_e4m3fn)
    js = jfp4.pack_nvfp4_scale_pairs(jnp.asarray(scale))
    ts = tfp4.pack_nvfp4_scale_pairs(torch_from_np(scale))
    assert_bit_equal(js, ts)
    assert_bit_equal(jfp4.unpack_nvfp4_scale_pairs(js), tfp4.unpack_nvfp4_scale_pairs(ts))


@pytest.mark.parametrize("elem", ["float6_e2m3", "float6_e3m2"])
def test_fp6_codes_and_packing_bit_exact(elem):
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 64, (64, 24)).astype(np.uint8)
    jv = jfp6.decode_fp6(jnp.asarray(codes), elem)
    tv = tfp6.decode_fp6(torch.from_numpy(codes), elem)
    assert_bit_equal(jv, tv)
    assert_bit_equal(jfp6.encode_fp6(jv, elem), tfp6.encode_fp6(tv, elem))
    jp = jfp6.pack_fp6(jnp.asarray(codes))
    tp = tfp6.pack_fp6(torch.from_numpy(codes))
    assert_bit_equal(jp, tp)
    assert np.array_equal(tfp6.unpack_fp6(tp).numpy(), codes)


# ---------------------------------------------------------------------------
# to_mx: the port against float64 numpy, and what differs from JAX

MX_ELEMS = ["float4_e2m1fn", "float8_e4m3fn", "float8_e5m2", "float6_e2m3", "float6_e3m2"]
MX_MODES = ["floor", "rceil", "even"]


def _mx_data():
    """(512, 48) f32: 32 columns at weight scale (block amax 0.02-0.5) and 16
    columns of 32-row blocks whose amax is an exact power of two or the f32
    just below one, from 2^49 down across the formula's 1e-30 floor (no
    subnormal inputs: JAX's CPU arithmetic flushes them to zero)."""
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((512, 48)) * 0.05).astype(np.float32)
    exps = [13, 15, 26, 27, 30, 31, 49, 0, 2, -3, -90, -99, -100, -101]
    targets = []
    for e in exps:
        p = np.float32(2.0 ** e)
        targets += [p, np.nextafter(p, np.float32(0))]
    blocks = [(b, c) for c in range(32, 48) for b in range(16)]
    for i, (b, c) in enumerate(blocks):
        t = targets[i % len(targets)]
        r = (rng.uniform(-0.9, 0.9, 32) * np.float64(t)).astype(np.float32)
        r[i % 32] = t if i % 2 else -t
        w[32 * b:32 * (b + 1), c] = r
    return w


def _np_encode_fp4(v):
    """encode_fp4_e2m1's formula in float64 numpy (v already on f32 values)."""
    xf = v.astype(np.float64)
    a = np.minimum(np.abs(xf), 6.0)
    step = np.exp2(np.floor(np.log2(np.maximum(a, 1.0))) - 1.0)
    a = np.round(a / step) * step
    e = np.clip(np.floor(np.log2(np.maximum(a, 0.25))) + 1.0, 0.0, 3.0)
    pow2 = np.exp2(np.maximum(e - 1.0, 0.0))
    mbit = np.clip(np.round(np.where(e > 0, (a / pow2 - 1.0) * 2.0, a * 2.0)), 0, 1)
    return ((np.signbit(xf).astype(np.uint8) << 3) | (e.astype(np.uint8) << 1)
            | mbit.astype(np.uint8))


def _np_snap_fp6(v, elem):
    mant = 3 if elem == "float6_e2m3" else 2
    bias = 1 if elem == "float6_e2m3" else 3
    a = np.minimum(np.abs(v.astype(np.float64)), tmx._ELEM_MAX[elem])
    step = np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** (1 - bias)))) - mant)
    snapped = np.round(a / step) * step
    return np.where(v < 0, -snapped, snapped).astype(np.float32)


def _np_to_mx(w, elem, mode):
    """to_mx's formula in float64 numpy, (32, 1) blocks: (codes, bytes)."""
    k, n = w.shape
    blocks = w.reshape(k // 32, 32, n)
    amax = np.max(np.abs(blocks), axis=1)
    tiny = np.float32(1e-30)
    if mode == "floor":
        se = np.floor(np.log2(np.maximum(amax, tiny).astype(np.float64))) - tmx._ELEM_MAX_POW2[elem]
    elif mode == "even":
        se = np.round(np.log2(np.maximum(amax, tiny).astype(np.float64))) - tmx._ELEM_MAX_POW2[elem]
    else:
        q = np.maximum(amax / np.float32(tmx._ELEM_MAX[elem]), tiny)  # f32, as the formula
        se = np.ceil(np.log2(q.astype(np.float64)))
    se = np.clip(se, -127, 127)
    scale = np.exp2(se).astype(np.float32)  # exact, 2^-127 an f32 subnormal
    emax = np.float32(tmx._ELEM_MAX[elem])
    v = np.clip(blocks / scale[:, None, :], -emax, emax).reshape(k, n)
    if elem.startswith("float8"):
        codes = v.astype(getattr(ml_dtypes, elem))
    elif elem == "float4_e2m1fn":
        codes = _np_encode_fp4(v)
    else:
        codes = _np_snap_fp6(v, elem).astype(ml_dtypes.float8_e4m3fn)
    return codes, (se + 127).astype(np.uint8)


def _grid(elem):
    """Every finite value of the element type, sorted (+0 and -0 as one)."""
    if elem == "float4_e2m1fn":
        v = np.asarray(jfp4.decode_fp4_e2m1(jnp.arange(16)))
    elif elem.startswith("float6"):
        v = np.asarray(jfp6.decode_fp6(jnp.arange(64), elem))
    else:
        v = np.arange(256, dtype=np.uint8).view(getattr(ml_dtypes, elem)).astype(np.float64)
    return np.unique(v[np.isfinite(v)].astype(np.float64))


def _code_steps(a, b, elem):
    """|difference| of two code arrays in steps of the element's grid."""
    def values(c):
        if elem == "float4_e2m1fn":
            return np.asarray(jfp4.decode_fp4_e2m1(jnp.asarray(c)), np.float64)
        return np.asarray(c).astype(np.float64)

    grid = _grid(elem)
    return np.abs(np.searchsorted(grid, values(a)) - np.searchsorted(grid, values(b)))


# How many of the 768 e8m0 bytes of ``_mx_data`` differ from JAX's (0.9, on
# the CPU), and how many codes of the blocks whose bytes agree. "floor": 92
# bytes, one exponent off: 65 blocks whose amax is an exact power of two
# (2^13, 2^15, 2^26, 2^27, 2^30, 2^31, 2^49), where JAX's floor(log2) is one
# low, and 27 whose amax is the f32 just below a power of two (2^-3, 2^-90,
# 2^-99), where its rounded f32 log2 reaches the power; the float64 formula
# and the port are exact. "rceil", MXFP4: 18 codes one grid step off, where
# JAX's exp2(se) is not a power of two (|se| > 12) and x / scale crosses a
# rounding boundary.
MX_JAX_DIFFS = {(elem, mode): (92, 0) if mode == "floor" else (0, 0)
                for elem in MX_ELEMS for mode in MX_MODES}
MX_JAX_DIFFS[("float4_e2m1fn", "rceil")] = (0, 18)


@pytest.mark.parametrize("mode", MX_MODES)
@pytest.mark.parametrize("elem", MX_ELEMS)
def test_to_mx_exact_and_counted_against_jax(elem, mode):
    w = _mx_data()
    tq, ts = tmx.to_mx(torch.from_numpy(w), (32, 1), elem, mode)
    nq, ns = _np_to_mx(w, elem, mode)
    assert np.array_equal(ts.numpy(), ns)
    assert np.array_equal(_bits(torch_to_numpy(tq)), _bits(nq))
    # e8m0 decode: the exact power of two for every byte
    dec = tmx.e8m0_decode(torch.arange(256, dtype=torch.uint8)).numpy()
    with np.errstate(over="ignore"):
        exact = np.exp2(np.arange(256.0) - 127).astype(np.float32)  # byte 255: inf
    assert np.array_equal(_bits(dec), _bits(exact))

    jq, js = jmx.to_mx(jnp.asarray(w), (32, 1), elem, mode)
    jq, js = np.asarray(jq), np.asarray(js)
    bad_bytes = js != ns
    assert np.all(np.abs(js.astype(np.int64) - ns.astype(np.int64))[bad_bytes] == 1)
    agree = np.repeat(~bad_bytes, 32, axis=0)
    steps = _code_steps(jq, torch_to_numpy(tq), elem)
    assert np.all(steps[agree] <= 1), int(steps[agree].max())
    counts = (int(bad_bytes.sum()), int((steps[agree] > 0).sum()))
    print(f"{elem} {mode}: bytes one exponent off, codes one step off: {counts}")
    assert counts == MX_JAX_DIFFS[(elem, mode)]
    # the weight-scale columns: MXFP4's exponents (-9 to -3) are exact in JAX
    if elem == "float4_e2m1fn":
        assert not bad_bytes[:, :32].any() and not (steps[:, :32] > 0).any()


# ---------------------------------------------------------------------------
# quantize_ under every new config, dequantize(), carry-over

def _configs(mod, prototype):
    return {
        "MXFP4-WO": prototype.MXWeightOnlyConfig(elem_dtype="float4_e2m1fn"),
        "MXFP8-WO": prototype.MXWeightOnlyConfig(),
        "MXFP6-WO": prototype.MXWeightOnlyConfig(elem_dtype="float6_e2m3", scale_mode="even"),
        "MX-dyn-fp4": prototype.MXDynamicActivationMXWeightConfig(
            activation_dtype="float4_e2m1fn", weight_dtype="float4_e2m1fn"),
        "MX-dyn-fp8": prototype.MXDynamicActivationMXWeightConfig(),
        "NVFP4-WO": prototype.NVFP4WeightOnlyConfig(),
        "NVFP4-WO-no-pts": prototype.NVFP4WeightOnlyConfig(use_per_tensor_scale=False),
        "NVFP4-dyn": prototype.NVFP4DynamicActivationNVFP4WeightConfig(),
        "NF4-WO": mod.NF4WeightOnlyConfig(),
    }


CONFIG_IDS = list(_configs(ao_tpu, jpmx))
# (K, N) of each case: the magic layouts (K = 256) and the split-half ones
# (MX fp4 at K = 96, NVFP4 at K = 48, NF4 at K = 192: K/64 = 3 groups)
SHAPES = {"magic": (256, 256), "halves-mx": (96, 64), "halves-nv": (48, 64),
          "halves-nf4": (192, 64)}


def _weight(k, n, seed=2):
    return (np.random.default_rng(seed).standard_normal((k, n)) * 0.05).astype(np.float32)


def _halves_shape(key):
    return SHAPES["halves-mx" if key.startswith("MX") else
                  "halves-nv" if key.startswith("NV") else "halves-nf4"]


@pytest.fixture(scope="module")
def quantized():
    """{(id, layout): (JAX's container, the port's from quantize_, JAX's
    carried across)}"""
    jc, tc = _configs(ao_tpu, jpmx), _configs(ao_tpu_torch, ao_tpu_torch)
    out = {}
    for key in CONFIG_IDS:
        for layout in ("magic", "halves"):
            if layout == "halves" and key in NO_FP4_PACKING:
                continue
            w = _weight(*(SHAPES["magic"] if layout == "magic" else _halves_shape(key)))
            jq = ao_tpu.quantize_({"w1": jnp.asarray(w)}, jc[key])["w1"]
            tq = ao_tpu_torch.quantize_({"w1": torch.from_numpy(w)}, tc[key])["w1"]
            out[(key, layout)] = (jq, tq, jax_to_torch(jq), w)
    return out


NO_FP4_PACKING = ("MXFP8-WO", "MXFP6-WO", "MX-dyn-fp8")  # one layout, ids "magic"
CASES = [(key, layout) for key in CONFIG_IDS for layout in ("magic", "halves")
         if not (layout == "halves" and key in NO_FP4_PACKING)]


@pytest.mark.parametrize("key,layout", CASES)
def test_quantize_config_bit_exact_and_carried(quantized, key, layout):
    jq, tq, carried, _ = quantized[(key, layout)]
    for got in (tq, carried):
        assert type(got).__name__ == type(jq).__name__
        assert got.meta_fields() == {k: tuple(v) if isinstance(v, list) else v
                                     for k, v in jq.meta_fields().items()}
        if key not in NO_FP4_PACKING:
            assert got.layout == layout
        for field, want in jq.data_fields().items():
            have = getattr(got, field)
            assert (want is None) == (have is None), field
            if want is not None:
                assert_bit_equal(want, have)
        deq = got.dequantize(torch.float32).numpy()
        if key == "MXFP8-WO" or key == "MX-dyn-fp8":
            # e4m3 shared exponents about -12 to -14, where JAX's exp2 rounds
            # (its scale is not a power of two): the port's values are the
            # codes times the exact power of two, JAX's within 2 ulp of them
            v = got.values().numpy().reshape(-1, 32, deq.shape[1])
            exact = (v * np.exp2(got.scale.numpy().astype(np.float64) - 127)[:, None, :])
            assert np.array_equal(deq, exact.reshape(deq.shape).astype(np.float32))
            ref = np.asarray(jq.dequantize(jnp.float32))
            ulp = np.spacing(np.abs(deq))
            assert np.all(np.abs(ref - deq) <= 2 * ulp)
        else:
            assert_bit_equal(jq.dequantize(jnp.float32), got.dequantize(torch.float32))


# ---------------------------------------------------------------------------
# linear, the plain versions against the Pallas kernels

# the "torch" route against JAX's emulated path keeps f32; "auto" runs the
# kernels' plain versions, which take x in bf16 and round the product to
# bf16 (K14, K15)
LINEAR_DB = {"torch": 100.0, "auto": 45.0}
X = (np.random.default_rng(3).standard_normal((8, 256))).astype(np.float32)


@pytest.mark.parametrize("key,layout", CASES)
def test_linear_matches_jax(quantized, key, layout):
    jq, _, tq, w = quantized[(key, layout)]
    x = X[:, :w.shape[0]]
    ref = np.asarray(jlinear(jnp.asarray(x), jq))
    for c in (k14.mxfp4_wo_matmul, k14.nvfp4_wo_matmul, k15.lut4_wo_magic):
        c.launches = 0
    for backend, need in LINEAR_DB.items():
        with tkernels.backend(backend):
            got = tlinear(torch.from_numpy(x), tq)
        assert got.shape == (8, w.shape[1]) and got.dtype == torch.float32
        sqnr = _sqnr(ref, got.float().numpy())
        assert sqnr >= need, f"{key} {layout}, {backend}: {sqnr:.2f} dB"
    assert k14.mxfp4_wo_matmul.launches == k14.nvfp4_wo_matmul.launches == 0
    assert k15.lut4_wo_magic.launches == 0


@pytest.fixture(scope="module")
def interpret_weights():
    """K = 1024: the reference's MXFP4 kernel needs K % 1024 (its uint8
    scale tiles); at smaller K its linear takes the emulated path."""
    w = _weight(1024, 256, seed=5)
    cfgs = _configs(ao_tpu, jpmx)
    # jitted, for time: the containers only need to be JAX's
    return {key: jax.jit(functools.partial(ao_tpu.quantize_, config=cfgs[key]))(
        {"w1": jnp.asarray(w)})["w1"] for key in ("MXFP4-WO", "NVFP4-WO", "NF4-WO")}


@pytest.mark.parametrize("key,need", [("MXFP4-WO", 60.0), ("NVFP4-WO", 35.0), ("NF4-WO", 40.0)])
def test_k14_k15_plain_match_pallas_interpret(interpret_weights, key, need):
    """The plain versions of K14 and K15 (the "auto" route on the CPU)
    against JAX's linear through its Pallas kernels in interpret mode, each
    called alone and waited for, at the JAX suite's bounds."""
    jq = interpret_weights[key]
    assert jq.layout == "magic"
    xb = jnp.asarray(np.random.default_rng(6).standard_normal((8, 1024))).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode(), jkernels.backend("pallas"):
        ref = np.asarray(jlinear(xb, jq).block_until_ready().astype(jnp.float32))
    got = tlinear(torch_from_np(xb), jax_to_torch(jq))
    assert got.dtype == torch.bfloat16
    sqnr = _sqnr(ref, got.float().numpy())
    assert sqnr > need, f"{key} plain vs Pallas: {sqnr:.2f} dB"


def test_kernels_take_and_refuse():
    """``takes`` states K14's and K15's own limits (not the TPU's K % 1024
    for MXFP4); a weight they refuse takes dequantize + matmul on every
    backend, with no launch and no error."""
    assert k14.takes(4096, 14336) and k14.takes(14336, 4096) and k14.takes(4096, 128256)
    assert k14.takes(256, 128) and not k14.takes(384, 128) and not k14.takes(512, 192)
    assert k15.takes(4096, 14336, 64) and k15.takes(1024, 1056, 64)
    assert not k15.takes(512, 256, 48) and not k15.takes(448, 256, 64)
    assert not k15.takes(512, 256, 64, n_luts=3) and k15.takes(512, 256, 64, n_luts=8)
    assert not k15.takes(8192, 256, 16, n_luts=512)
    x = torch.zeros((8, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 256"):
        k14.mxfp4_wo_matmul(x, torch.zeros((16, 128), dtype=torch.int32),
                            torch.zeros((4, 128), dtype=torch.uint8))
    with pytest.raises(ValueError, match="one of"):
        k15.lut4_wo_magic(x, torch.zeros((16, 128), dtype=torch.int32),
                          torch.zeros((3, 128)), tnf4.NF4_CODEBOOK, 48)
    # magic layouts outside the kernels: MX K = 384, NVFP4 K = 192, NF4 N = 200
    cases = [(ao_tpu_torch.MXWeightOnlyConfig(elem_dtype="float4_e2m1fn"), (384, 128)),
             (ao_tpu_torch.NVFP4WeightOnlyConfig(), (192, 128)),
             (ao_tpu_torch.NF4WeightOnlyConfig(), (256, 200))]
    for cfg, (k, n) in cases:
        w = torch.from_numpy(_weight(k, n, seed=9))
        qa = ao_tpu_torch.quantize_({"w1": w}, cfg)["w1"]
        assert qa.layout == "magic"
        xk = torch.from_numpy(X[:, :k] if k <= 256 else np.tile(X, (1, 2))[:, :k])
        want = xk @ qa.dequantize(torch.float32)
        got = tlinear(xk, qa)
        assert _sqnr(want.numpy(), got.numpy()) > 100
    assert k14.mxfp4_wo_matmul.launches == k14.nvfp4_wo_matmul.launches == 0
    assert k15.lut4_wo_magic.launches == 0


# ---------------------------------------------------------------------------
# generate on a tiny f32 config

JCFG = jllama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=1024, tie_embeddings=False, dtype=jnp.float32)
TCFG = tllama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=1024, tie_embeddings=False, dtype=torch.float32)
B, S, STEPS, MAX_SEQ = 2, 8, 6, 16
GEN_IDS = ("MXFP4-WO", "NVFP4-WO", "NF4-WO", "NVFP4-dyn")
FLOOR_MARGIN_DB = 3.0


@pytest.fixture(scope="module")
def tiny():
    jp = jllama.init_params(jax.random.PRNGKey(1), JCFG)
    prompt = np.random.default_rng(5).integers(0, JCFG.vocab_size, (B, S)).astype(np.int32)
    jc = _configs(ao_tpu, jpmx)
    # jitted, for time: these containers only need to be JAX's, and the port
    # takes them over bit for bit (quantize_'s own bits are held above)
    return {key: jax.jit(functools.partial(ao_tpu.quantize_, config=jc[key]))(jp)
            for key in GEN_IDS}, prompt


def _producer_quant_ok_fixed(w):
    """The reference's ``producer_quant_ok`` reads ``act_quant.dtype`` and
    raises on an NVFP4Array, whose act_quant is a flag, so its llama cannot
    run NVFP4 weights (ROADMAP Queue 3); the port asks for a spec first.
    JAX's tokens and logits are taken with this predicate in its place."""
    from ao_tpu.quantization.qarrays.common import ActQuantSpec

    aq = getattr(w, "act_quant", None)
    return (isinstance(aq, ActQuantSpec) and aq.dtype == "int8" and aq.symmetric
            and aq.granularity == "per_token" and getattr(w, "act_pre_scale", None) is None)


@pytest.mark.parametrize("key", GEN_IDS)
def test_generate_matches_jax(tiny, key, monkeypatch):
    jparams, prompt = tiny
    jp = jparams[key]
    tp = jax_to_torch(jp)
    if key.startswith("NVFP4"):
        # JAX's llama asks it of every MLP's w2, so its forward raises
        with pytest.raises(AttributeError, match="dtype"):
            jact.producer_quant_ok(jp["layers"][0]["mlp"]["w2"])
        monkeypatch.setattr(jact, "producer_quant_ok", _producer_quant_ok_fixed)
    if key != "NVFP4-dyn":
        want = np.asarray(jgenerate(jp, jnp.asarray(prompt), JCFG, STEPS, MAX_SEQ))
        for backend in ("torch", "auto"):
            with tkernels.backend(backend):
                got = ao_tpu_torch.generate(tp, torch.from_numpy(prompt), TCFG, STEPS, MAX_SEQ)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        return
    fwd = jax.jit(lambda p, t: jllama.forward(p, t, JCFG)[0])
    ref = np.asarray(fwd(jp, jnp.asarray(prompt)))
    nudged = np.asarray(fwd(dict(jp, embed=jp["embed"] * (1 + 2 ** -8)), jnp.asarray(prompt)))
    # the fp4 activation quantizer turns bf16-level route differences into
    # whole steps: JAX's own floor under a nudge of one bf16 rounding, less
    # 3 dB, as chip_smoke.py holds such routes
    need = min(30.0, _sqnr(ref, nudged) - FLOOR_MARGIN_DB)
    for backend in ("torch", "auto"):
        with tkernels.backend(backend):
            got, _ = tllama.forward(tp, torch.from_numpy(prompt), TCFG)
            toks = ao_tpu_torch.generate(tp, torch.from_numpy(prompt), TCFG, 2, MAX_SEQ)
        sqnr = _sqnr(ref, got.numpy())
        assert sqnr >= need, f"{key}, {backend}: {sqnr:.2f} dB < {need:.2f}"
        assert toks.shape == (B, 2) and bool(((toks >= 0) & (toks < TCFG.vocab_size)).all())


# ---------------------------------------------------------------------------
# NF4 details

@pytest.mark.parametrize("shape", [(256, 256), (4096, 64)])
def test_nf4_scalers_mean_and_layouts(shape):
    """The scalers' mean is summed in the reference's order, so every
    quantized scaler and code is its bits; ``to_layout`` repacks both ways."""
    w = _weight(*shape, seed=shape[0])
    jq = jnf4.NF4Array.from_hp(jnp.asarray(w))
    tq = tnf4.NF4Array.from_hp(torch.from_numpy(w))
    for field in ("qdata", "quantized_scalers", "quantization_factor", "scaler_mean"):
        assert_bit_equal(getattr(jq, field), getattr(tq, field))
    halves = tq.to_layout("halves")
    assert_bit_equal(jq.to_layout("halves").qdata, halves.qdata)
    assert torch.equal(halves.to_layout("magic").qdata, tq.qdata)
    assert_bit_equal(jq._scalers(), tq._scalers())


def test_nvfp4_quantize_bit_exact():
    x = (np.random.default_rng(8).standard_normal((16, 256)) * 2).astype(np.float32)
    for fixed in (None, np.float32(0.004)):
        jc, js, jp = jnv.nvfp4_quantize(jnp.asarray(x), (1, 16), True,
                                        None if fixed is None else jnp.asarray(fixed))
        tc, ts, tp = tnv.nvfp4_quantize(torch.from_numpy(x), (1, 16), True,
                                        None if fixed is None else torch.tensor(fixed))
        assert_bit_equal(jc, tc)
        assert_bit_equal(js, ts)
        assert_bit_equal(jp, tp)
