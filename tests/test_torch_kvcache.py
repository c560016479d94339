"""The quantized KV cache (``serving/kvcache.py``) and the plain versions of
K5, K6, K7 and K2v against the JAX package, on the same numpy inputs.

The port stores its caches in layouts of its own ("tokens" for int8 and
fp8, "ch4" for int4), so the caches are compared through
``quantize_values`` and ``dequantize()``, never through their raw bytes;
the JAX side uses the layouts ``init_quant_kv_caches`` picks, with and
without a parity/plane window. The kernels' plain versions are held against
the Pallas kernels in interpret mode, the JAX side over caches in the
reference's layouts, and against an f64 attention over the dequantized
cache at the JAX suite's bounds (``tests/test_pallas_interpret.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ao_tpu.models import llama as jllama
from ao_tpu.ops.pallas.decode_attention import decode_attention as jax_decode_attention
from ao_tpu.serving.kvcache import QuantKVCache as JaxCache
from ao_tpu.serving.kvcache import init_quant_kv_caches as jax_init_caches

from ao_tpu_torch.ops.hopper import decode_attention as da
from ao_tpu_torch.quantization.primitives import compute_error
from ao_tpu_torch.serving.kvcache import QuantKVCache, init_quant_kv_caches

from torch_port_helpers import torch_from_np, torch_to_numpy

KV_DTYPES = ("int8", "float8_e4m3fn", "int4")
CACHE_DTYPES = KV_DTYPES + ("float8_e5m2",)  # e5m2: slot caches only, through K2v
B, HKV, D = 2, 2, 128


def _windows(rng, prefill):
    """A prefill of ``prefill`` tokens at 0, then two single-token steps."""
    return [(0, rng.standard_normal((B, prefill, HKV, D)).astype(np.float32) * 3),
            (prefill, rng.standard_normal((B, 1, HKV, D)).astype(np.float32)),
            (prefill + 1, rng.standard_normal((B, 1, HKV, D)).astype(np.float32) * 0.01)]


def _assert_values_equal(jcache, tcache):
    for out in (jnp.float32, jnp.bfloat16):
        want = np.asarray(jcache.dequantize(out))
        got = torch_to_numpy(tcache.dequantize(getattr(torch, jnp.dtype(out).name)))
        # equal values: an unwritten int4 position is (0 - 8) * 0 = -0.0
        # here and +0.0 where the reference pads with u = 8
        np.testing.assert_array_equal(got.astype(np.float32), want.astype(np.float32))


@pytest.mark.parametrize("max_seq", [64, 40])  # with a parity/plane window, and without
@pytest.mark.parametrize("dtype_name", CACHE_DTYPES)
def test_cache_equals_jax(dtype_name, max_seq):
    cfg = jllama.LlamaConfig(n_layers=1, n_heads=HKV, n_kv_heads=HKV, dim=HKV * D)
    rng = np.random.default_rng(max_seq)
    for jcache in jax_init_caches(cfg, B, max_seq, dtype_name)[0]:  # the K and the V layout
        tcache = QuantKVCache.create(B, max_seq, HKV, D, dtype_name, device="cpu")
        assert tcache.layout == ("ch4" if dtype_name == "int4" else "tokens")
        for index, x in _windows(rng, 9):
            jq, js = jcache.quantize_values(jnp.asarray(x))
            tq, ts = tcache.quantize_values(torch.from_numpy(x))
            assert np.array_equal(np.asarray(jq).view(np.uint8), tq.view(torch.uint8).numpy())
            assert np.array_equal(np.asarray(js), ts.numpy())
            jcache = jcache.update(jnp.asarray(x), index)
            assert tcache.update(torch.from_numpy(x), index) is tcache
        assert tcache.max_seq == jcache.max_seq == max_seq
        _assert_values_equal(jcache, tcache)


# per-slot windows: (start of each row, S); S = 3 at 62 and 63 straddles the
# end of a 64-row cache, so the clamp's collisions show
VECTOR_WINDOWS = {1: [[9, 63], [10, 0], [63, 20]], 3: [[62, 9], [5, 63], [0, 61]]}


@pytest.mark.parametrize("s_tok", [1, 3])
@pytest.mark.parametrize("max_seq", [64, 40])
@pytest.mark.parametrize("dtype_name", CACHE_DTYPES)
def test_vector_update_equals_jax(dtype_name, max_seq, s_tok):
    """Per-slot (B,) indices: each row's window at its own position, past
    the last row clamped onto it with only the last colliding token kept,
    as the reference's ``_clamped_cols``; scales at the same columns."""
    cfg = jllama.LlamaConfig(n_layers=1, n_heads=HKV, n_kv_heads=HKV, dim=HKV * D)
    rng = np.random.default_rng(100 * max_seq + s_tok)
    for jcache in jax_init_caches(cfg, B, max_seq, dtype_name)[0]:
        tcache = QuantKVCache.create(B, max_seq, HKV, D, dtype_name, device="cpu")
        x = rng.standard_normal((B, 9, HKV, D)).astype(np.float32)
        jcache = jcache.update(jnp.asarray(x), 0)
        tcache.update(torch.from_numpy(x), 0)
        for starts in VECTOR_WINDOWS[s_tok]:
            starts = np.minimum(np.array(starts, np.int32), max_seq - 1)
            x = rng.standard_normal((B, s_tok, HKV, D)).astype(np.float32) * 2
            jcache = jcache.update(jnp.asarray(x), jnp.asarray(starts))
            assert tcache.update(torch.from_numpy(x), torch.from_numpy(starts)) is tcache
        _assert_values_equal(jcache, tcache)


@pytest.mark.parametrize("dtype_name", CACHE_DTYPES)
def test_insert_slot_equals_jax(dtype_name):
    """A batch-1 prefill cache copied into one slot of the pool: rows [0,
    16) of slot 1, the other rows and slots untouched."""
    cfg = jllama.LlamaConfig(n_layers=1, n_heads=HKV, n_kv_heads=HKV, dim=HKV * D)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 64, HKV, D)).astype(np.float32)
    p = rng.standard_normal((1, 16, HKV, D)).astype(np.float32) * 4
    jpools = jax_init_caches(cfg, 3, 64, dtype_name)[0]
    jscratch = jax_init_caches(cfg, 1, 16, dtype_name)[0]
    for jpool, jscr in zip(jpools, jscratch):
        tpool = QuantKVCache.create(3, 64, HKV, D, dtype_name, device="cpu")
        tscr = QuantKVCache.create(1, 16, HKV, D, dtype_name, device="cpu")
        jpool = jpool.update(jnp.asarray(x), 0).insert_slot(jscr.update(jnp.asarray(p), 0), 1)
        tpool.update(torch.from_numpy(x), 0)
        assert tpool.insert_slot(tscr.update(torch.from_numpy(p), 0), 1) is tpool
        _assert_values_equal(jpool, tpool)
        np.testing.assert_array_equal(tpool.dequantize(torch.float32)[1, :16].numpy(),
                                      tscr.dequantize(torch.float32)[0].numpy())


def test_cache_checks():
    with pytest.raises(ValueError, match="reference's TPU layout.*'tokens'"):
        QuantKVCache.create(B, 64, HKV, D, "int8", layout="kt", device="cpu")
    with pytest.raises(ValueError, match="'ch4'"):
        QuantKVCache.create(B, 64, HKV, D, "int4", layout="ck4", device="cpu")
    with pytest.raises(ValueError, match="max_seq % 8"):
        QuantKVCache.create(B, 44, HKV, D, "int4", device="cpu")
    with pytest.raises(ValueError, match="KV cache dtype"):
        QuantKVCache.create(B, 64, HKV, D, "float16", device="cpu")
    assert QuantKVCache.create(B, 64, HKV, D, "float8_e5m2", device="cpu").qdata.dtype \
        == torch.float8_e5m2
    c = QuantKVCache.create(B, 16, HKV, D, "int8", device="cpu")
    # a vector index writes each row at its own position
    assert c.update(torch.ones((B, 1, HKV, D)), torch.tensor([3, 4])) is c
    assert c.scale[0, :, 3].tolist() == c.scale[1, :, 4].tolist() == [float(torch.tensor(1 / 127))] * HKV
    assert not c.scale[0, :, 4].any() and not c.scale[1, :, 3].any()
    with pytest.raises(ValueError, match="cannot insert"):
        c.insert_slot(QuantKVCache.create(1, 8, HKV, D, "float8_e4m3fn", device="cpu"), 0)
    with pytest.raises(ValueError, match="outside the cache"):
        c.update(torch.zeros((B, 2, HKV, D)), 15)
    cfg = jllama.LlamaConfig(n_layers=3, n_heads=4, n_kv_heads=HKV, dim=4 * D)
    caches = init_quant_kv_caches(cfg, B, 32, "float8_e4m3fn", device="cpu")
    assert len(caches) == 3 and all(c.qdata.dtype == torch.float8_e4m3fn for kv in caches
                                    for c in kv)


# -- K5, K6, K7: plain versions against the Pallas kernels -------------------

T, H = 128, 8
LENGTHS = np.array([128, 77], np.int32)
# (dtype, the reference's K and V layouts, the port's mode, the JAX suite's
# bound against f64 attention over the dequantized cache)
KERNELS = {
    "int8": ("kt", "tokens", "i8", 25.0),
    "float8_e4m3fn": ("ktp", "ptok", None, 30.0),
    "int4": ("ck4", "ptok4", None, 25.0),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((B, H, D)).astype(np.float32)).astype(jnp.bfloat16)
    k = rng.standard_normal((B, T, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, HKV, D)).astype(np.float32)
    return q, k, v


def _port_caches(dtype_name, k, v):
    return [QuantKVCache.create(B, T, HKV, D, dtype_name, device="cpu").update(
        torch.from_numpy(x), 0) for x in (k, v)]


def _f64_attention(q, k, v, lengths, sm_scale):
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    rep = q.shape[1] // k.shape[2]
    kf, vf = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    s = np.einsum("bhd,bthd->bht", q, kf) * sm_scale
    s = np.where(np.arange(k.shape[1])[None, None, :] < lengths[:, None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bht,bthd->bhd", p / p.sum(-1, keepdims=True), vf)


def _sqnr(ref, got):
    return float(compute_error(torch.tensor(np.asarray(ref, np.float32)), got.float()))


@pytest.mark.parametrize("dtype_name", KV_DTYPES)
def test_plain_matches_pallas_interpret(dtype_name):
    k_layout, v_layout, mode, _ = KERNELS[dtype_name]
    q, k, v = _inputs(11)
    ck = JaxCache.create(B, T, HKV, D, dtype_name, layout=k_layout).update(jnp.asarray(k), 0)
    cv = JaxCache.create(B, T, HKV, D, dtype_name, layout=v_layout).update(jnp.asarray(v), 0)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_decode_attention(q, ck.qdata, cv.qdata, jnp.asarray(LENGTHS), k_scale=ck.scale,
                                   v_scale=cv.scale, sm_scale=D ** -0.5,
                                   k_layout=k_layout).block_until_ready()
    tk, tv = _port_caches(dtype_name, k, v)
    got = da.decode_attention(torch_from_np(q), tk.qdata, tv.qdata, torch.from_numpy(LENGTHS),
                              k_scale=tk.scale, v_scale=tv.scale, sm_scale=D ** -0.5,
                              k_layout=tk.layout, mode=mode)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    # the same function: one softmax over T against the kernel's online one
    # (another max at each bf16 rounding of p * vs), f32 sums in another order
    assert _sqnr(np.asarray(ref), got) >= 40


@pytest.mark.parametrize("dtype_name", KV_DTYPES)
def test_plain_matches_f64_attention(dtype_name):
    _, _, mode, bound = KERNELS[dtype_name]
    q, k, v = _inputs(12)
    tk, tv = _port_caches(dtype_name, k, v)
    got = da.decode_attention(torch_from_np(q), tk.qdata, tv.qdata, torch.from_numpy(LENGTHS),
                              k_scale=tk.scale, v_scale=tv.scale, k_layout=tk.layout, mode=mode)
    ref = _f64_attention(np.asarray(q.astype(jnp.float32)), tk.dequantize(torch.float32).numpy(),
                         tv.dequantize(torch.float32).numpy(), LENGTHS, D ** -0.5)
    # the JAX suite's bound for the kernel: K5 quantizes q to int8, and every
    # kernel rounds p * vs to bf16
    assert _sqnr(ref, got) >= bound


@pytest.mark.parametrize("dtype_name", KV_DTYPES)
def test_wrappers_check_and_count(dtype_name):
    _, _, mode, _ = KERNELS[dtype_name]
    q, k, v = _inputs(13)
    tk, tv = _port_caches(dtype_name, k, v)
    qt, lengths = torch_from_np(q), torch.from_numpy(LENGTHS)
    wrapper = {"int8": da.decode_attention_int8, "float8_e4m3fn": da.decode_attention_fp8,
               "int4": da.decode_attention_int4}[dtype_name]
    before = wrapper.launches
    want = da.decode_attention(qt, tk.qdata, tv.qdata, lengths, k_scale=tk.scale,
                               v_scale=tv.scale, k_layout=tk.layout, mode=mode)
    got = wrapper(qt, tk.qdata, tk.scale, tv.qdata, tv.scale, lengths)
    assert torch.equal(got, want) and wrapper.launches == before  # the CPU runs no kernel
    # shapes the kernel does not take raise on the CPU as on the card
    with pytest.raises(ValueError, match="head_dim 128"):
        wrapper(qt[..., :64], tk.qdata, tk.scale, tv.qdata, tv.scale, lengths)
    with pytest.raises(ValueError, match="at most 8 query heads"):
        wrapper(torch.cat([qt] * 3, dim=1)[:, :18], tk.qdata, tk.scale, tv.qdata, tv.scale,
                lengths)
    with pytest.raises(ValueError, match="v_scale must be"):
        wrapper(qt, tk.qdata, tk.scale, tv.qdata, tv.scale[:, :, :64], lengths)
    nbytes, ops = da.traffic_quant({"int8": "i8", "float8_e4m3fn": "f8", "int4": "i4"}[dtype_name],
                                   (B, H, D), tuple(tk.qdata.shape), LENGTHS)
    row = D // 2 if dtype_name == "int4" else D
    valid = int(LENGTHS.sum())
    assert nbytes == B * H * D * 2 + 2 * valid * HKV * (row + 4) + B * 4 + B * H * D * 4
    assert ops == 4 * valid * H * D


def test_dispatch_refuses_what_it_does_not_take():
    q, k, v = _inputs(14)
    tk, tv = _port_caches("int8", k, v)
    args = (torch_from_np(q), tk.qdata, tv.qdata, torch.from_numpy(LENGTHS))
    # an int8 tokens cache without mode="i8" takes the bf16-q form (K2v)
    got = da.decode_attention(*args, k_scale=tk.scale, v_scale=tv.scale)
    k5 = da.decode_attention(*args, k_scale=tk.scale, v_scale=tv.scale, mode="i8")
    assert torch.equal(got, da.decode_attention_vec8(args[0], tk.qdata, tk.scale, tv.qdata,
                                                     tv.scale, args[3]))
    assert not torch.equal(got, k5)
    # K2v takes int8 and e5m2, the same storage type for K and V
    with pytest.raises(ValueError, match="v_cache must be"):
        da.decode_attention_vec8(args[0], tk.qdata, tk.scale, tv.qdata.view(torch.float8_e5m2),
                                 tv.scale, args[3])
    # the reference's layout names are not the port's
    with pytest.raises(ValueError, match="no decode attention kernel"):
        da.decode_attention(*args, k_scale=tk.scale, v_scale=tv.scale, k_layout="kt", mode="i8")
    with pytest.raises(ValueError, match="bf16 tokens form"):
        da.decode_attention(*args, k_layout="ch4")


# -- K2v: the bf16-q "vec8" form over int8 and e5m2 tokens caches ------------

K2V_DTYPES = ("int8", "float8_e5m2")
K2V_F64_DB = 30.0  # the JAX suite's bound for the e4m3 form (K6): bf16 q, bf16(p * vs)


@pytest.mark.parametrize("dtype_name", K2V_DTYPES)
def test_k2v_plain_matches_pallas_interpret(dtype_name):
    """K2v's plain version against the Pallas ``_tok_kernel`` in mode "vec8"
    (``decode_attention`` over tokens caches with scales), in interpret
    mode, and against an f64 attention over the dequantized cache."""
    q, k, v = _inputs(15)
    ck, cv = (JaxCache.create(B, T, HKV, D, dtype_name, layout="tokens").update(jnp.asarray(x), 0)
              for x in (k, v))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_decode_attention(q, ck.qdata, cv.qdata, jnp.asarray(LENGTHS), k_scale=ck.scale,
                                   v_scale=cv.scale, sm_scale=D ** -0.5,
                                   k_layout="tokens").block_until_ready()
    tk, tv = _port_caches(dtype_name, k, v)
    before = da.decode_attention_vec8.launches
    got = da.decode_attention(torch_from_np(q), tk.qdata, tv.qdata, torch.from_numpy(LENGTHS),
                              k_scale=tk.scale, v_scale=tv.scale, sm_scale=D ** -0.5,
                              k_layout=tk.layout)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    assert da.decode_attention_vec8.launches == before  # the CPU runs no kernel
    # the same function: one softmax over T against the kernel's online one
    # (another max at each bf16 rounding of p * vs), f32 sums in another order
    assert _sqnr(np.asarray(ref), got) >= 40
    f64 = _f64_attention(np.asarray(q.astype(jnp.float32)), tk.dequantize(torch.float32).numpy(),
                         tv.dequantize(torch.float32).numpy(), LENGTHS, D ** -0.5)
    assert _sqnr(f64, got) >= K2V_F64_DB


@pytest.mark.parametrize("dtype_name", K2V_DTYPES)
def test_k2v_plain_never_reads_past_lengths(dtype_name):
    """NaN (an fp8 0x7F, an int8 -1 scale NaN) at positions at or past
    lengths changes no output bit of the plain version."""
    q, k, v = _inputs(16)
    tk, tv = _port_caches(dtype_name, k, v)
    qt, lengths = torch_from_np(q), torch.from_numpy(LENGTHS)
    got = da.decode_attention_vec8(qt, tk.qdata, tk.scale, tv.qdata, tv.scale, lengths)
    n = int(LENGTHS[1])
    for c in (tk, tv):
        if dtype_name != "int8":
            c.qdata.view(torch.uint8)[1, n:] = 0x7F
        c.scale[1, :, n:] = float("nan")
    again = da.decode_attention_vec8(qt, tk.qdata, tk.scale, tv.qdata, tv.scale, lengths)
    assert torch.equal(again, got)
    nbytes, ops = da.traffic_quant("v8", (B, H, D), tuple(tk.qdata.shape), LENGTHS)
    valid = int(LENGTHS.sum())
    assert nbytes == B * H * D * 2 + 2 * valid * HKV * (D + 4) + B * 4 + B * H * D * 4
    assert ops == 4 * valid * H * D
