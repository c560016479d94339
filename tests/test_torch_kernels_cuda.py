"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (marker ``cuda``) and skips
without one. The tests directory's conftest imports JAX, which a GPU machine
may not have; this file imports neither, so on the card it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

import ao_tpu_torch
from ao_tpu_torch.models import llama
from ao_tpu_torch.ops import kernels
from ao_tpu_torch.ops.hopper import decode_attention as k2
from ao_tpu_torch.ops.hopper import flash_attention as k8
from ao_tpu_torch.ops.hopper import fp8_matmul as k17
from ao_tpu_torch.ops.hopper import fused_act as k12
from ao_tpu_torch.ops.hopper import int4_matmul as k1
from ao_tpu_torch.ops.hopper import int8_matmul as k10
from ao_tpu_torch.ops.hopper import paged_attention as k9
from ao_tpu_torch.ops.linear import _requant_scale
from ao_tpu_torch.quantization.primitives import ZeroPointDomain, compute_error
from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec
from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
from ao_tpu_torch.serving.kvcache import QuantKVCache

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


# K1 at the decode kernel's and the mainloop's edges: (M, K, N, g, domain)
MAGIC_CASES = [
    (1, 512, 128, 32, "tinygemm"),
    (8, 1024, 256, 128, "tinygemm"),
    (8, 1024, 1056, 64, "minmax_int"),  # N a multiple of 32 but not of 128
    (8, 4096, 1024, 128, "tinygemm"),   # the decode's runs of 16 word rows
    (17, 512, 96, 32, "tinygemm"),      # M across two m16 tiles, a ragged edge
    (16, 512, 128, 16, "tinygemm"),     # two n8 tiles of batch rows
    (17, 1024, 160, 16, "minmax_int"),  # the mainloop at g = 16: four groups a stage
    (40, 2048, 512, 128, "minmax_int"),
    (100, 1024, 800, 64, "tinygemm"),   # N % 64 == 32: a ragged last tile of columns
    (128, 2048, 1056, 128, "minmax_int"),  # K split in units, ragged N
    (200, 512, 256, 32, "tinygemm"),
    (64, 512, 128, 16, "minmax_int"),
    (513, 1536, 256, 32, "tinygemm"),   # g = 32: two groups a stage; a ragged unit count
    (1024, 1024, 384, 128, "tinygemm"),  # prefill-sized M, N not a multiple of 128
    (1024, 4096, 1024, 128, "tinygemm"),  # K split at prefill-sized M
]
# every mainloop tile and split at one shape: (M, K, N, g)
MAGIC_TILE_CASE = (200, 1536, 800, 64)


def _int4_magic_operands(dev, m, k, n, g, domain):
    gen = torch.Generator(device=dev).manual_seed(m * 7 + n + g)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    zpd = ZeroPointDomain.FLOAT if domain == "tinygemm" else ZeroPointDomain.INT
    qa = Int4Array.from_hp(w, group_size=g, zero_point_domain=zpd)
    assert qa.layout == "magic"
    return qa, torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("m,k,n,g,domain", MAGIC_CASES)
def test_int4_wo_magic_matches_plain(dev, m, k, n, g, domain):
    qa, x = _int4_magic_operands(dev, m, k, n, g, domain)
    before = k1.int4_wo_magic.launches
    got = k1.int4_wo_magic(x, qa.qdata, qa.scale, qa.zero_point, g, qa.zero_point_domain)
    torch.cuda.synchronize()
    assert k1.int4_wo_magic.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    s, b2 = k1.transport_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    ref = k1.int4_wo_magic_plain(x, qa.qdata, s, b2, g)
    # same arithmetic, f32 sums in another order, bf16 output: the JAX
    # suite's bound for the int4 kernel
    assert float(compute_error(ref, got)) >= 45


def test_int4_wo_magic_every_tile(dev):
    """Every (bm, bn, splits) of the mainloop at one shape with a ragged
    last tile of columns and three units of K, against the plain version."""
    m, k, n, g = MAGIC_TILE_CASE
    qa, x = _int4_magic_operands(dev, m, k, n, g, "tinygemm")
    s, b2 = k1.transport_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    ref = k1.int4_wo_magic_plain(x, qa.qdata, s, b2, g)
    tiles = k1.candidate_tiles_magic(m, k, n)
    assert len(tiles) == 6
    for t in tiles:
        got = k1._launch(x, qa.qdata, qa.scale, qa.zero_point, g, raw_zp=True, tiles=t)
        torch.cuda.synchronize()
        assert float(compute_error(ref, got)) >= 45, t
    with pytest.raises(ValueError, match="not the mainloop's"):
        k1._launch(x, qa.qdata, qa.scale, qa.zero_point, g, raw_zp=True, tiles=(256, 128, 1))


def test_int4_wo_magic_refuses_what_it_does_not_take(dev):
    qa = Int4Array.from_hp(torch.randn((512, 128), device=dev), group_size=32)
    x = torch.randn((8, 512), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        k1.int4_wo_magic(x, qa.qdata.t().contiguous().t(), qa.scale, qa.zero_point, 32,
                         qa.zero_point_domain)
    with pytest.raises(ValueError, match="multiple of 32"):
        k1.int4_wo_magic(x, qa.qdata[:, :100], qa.scale[:, :100], qa.zero_point[:, :100], 32,
                         qa.zero_point_domain)


# the five (K, N) of Llama-3-8B's linears: wq / wo, wk / wv, w1 / w3, w2, lm_head
GEMV_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("k,n", GEMV_KN)
def test_int4_wo_magic_decode_form_at_llama_widths(dev, m, k, n):
    """K1's decode form (one kernel on the weight-stream mainloop) at every
    decode width of the int4-WO path, against the plain version."""
    qa, x = _int4_magic_operands(dev, m, k, n, 128, "tinygemm")
    s, b2 = k1.transport_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    ref = k1.int4_wo_magic_plain(x, qa.qdata, s, b2, 128)

    def run():
        return k1.int4_wo_magic(x, qa.qdata, qa.scale, qa.zero_point, 128, qa.zero_point_domain)

    got = run()
    torch.cuda.synchronize()
    assert float(compute_error(ref, got)) >= 45
    assert _device_kernels(run) == 1


@pytest.mark.parametrize("m,k,n,g", [(8, 2048, 512, 128), (16, 1024, 256, 32), (5, 512, 96, 16)])
def test_int4_wo_magic_every_decode_plan(dev, m, k, n, g):
    """Every plan of the decode form (warps along N and K, cluster, stages,
    slab rows) at one shape, against the plain version; a plan it does not
    take is refused before the launch."""
    qa, x = _int4_magic_operands(dev, m, k, n, g, "minmax_int")
    s, b2 = k1.transport_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    ref = k1.int4_wo_magic_plain(x, qa.qdata, s, b2, g)
    plans = k1.gemv_candidates(m, k, n, g, stages=(2, 3, 5))
    assert len(plans) >= 9
    for plan in plans:
        got = k1._launch(x, qa.qdata, s, b2, g, plan=plan)
        torch.cuda.synchronize()
        assert float(compute_error(ref, got)) >= 45, plan
    before = k1.int4_wo_magic.launches
    with pytest.raises(ValueError, match="not the decode form's"):
        k1._launch(x, qa.qdata, s, b2, g, plan=(3, 1, 1, 3))
    assert k1.int4_wo_magic.launches == before


F3_WO = [(1024, 200, 128), (512, 48, 128), (256, 16, 64), (1024, 128, 256)]
F3_W4A8 = [(512, 96, 128), (384, 128, 64), (1024, 128, 256), (512, 160, 128)]


@pytest.mark.parametrize("m", [8, 520])
@pytest.mark.parametrize("config,shape",
                         [("Int4WeightOnlyConfig", s) for s in F3_WO]
                         + [("Float8DynamicActivationInt4WeightConfig", F3_WO[0])]
                         + [("Int8DynamicActivationInt4WeightConfig", s) for s in F3_W4A8])
def test_f3_shapes_fall_back_and_launch_no_refusing_kernel(dev, config, shape, m):
    """The shapes K1, K3 and K4 refuse: the route falls back as the
    reference does (the "torch" backend's values) and launches none of
    them; (384, 128, 64) at M = 8 is K3's."""
    from ao_tpu_torch.ops.linear import linear
    from ao_tpu_torch.quantization.quantize import quantize_

    k, n, g = shape
    gen = torch.Generator(device=dev).manual_seed(k + n + g + m)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    qw = quantize_({"w1": w}, getattr(ao_tpu_torch, config)(group_size=g))["w1"]
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    counters = (k1.int4_wo_magic, k1.int4_w4a8_matmul, k1.int4_magic8_requant_int8)
    before = [c.launches for c in counters]
    got = linear(x, qw)
    torch.cuda.synchronize()
    k3 = int(config.startswith("Int8") and shape == (384, 128, 64) and m == 8)
    assert [c.launches - b for c, b in zip(counters, before)] == [0, k3, 0]
    with kernels.backend("torch"):
        ref = linear(x, qw)
    assert got.shape == ref.shape == (m, n)
    assert float(compute_error(ref.float(), got.float())) >= (40 if k3 else 60)


def test_silu_mul_quant_at_a_refused_width_launches_no_kernel(dev):
    from ao_tpu_torch.ops import act_quant

    gen = torch.Generator(device=dev).manual_seed(5)
    a, b = (torch.randn((2, 8, 200), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    before = k12.silu_mul_quant.launches
    got = act_quant.silu_mul_quant(a, b)
    torch.cuda.synchronize()
    assert k12.silu_mul_quant.launches == before
    q, sc = k12.silu_mul_quant_plain(a, b)
    assert torch.equal(got.qdata, q) and torch.equal(got.scale, sc)


@pytest.mark.parametrize("b,h,hkv,t,lengths", [
    (2, 4, 2, 128, [100, 37]),
    (3, 8, 1, 100, [1, 100, 64]),    # G = 8, T not a multiple of the chunk
    (2, 4, 4, 192, [0, 65]),         # G = 1; length 0 masks every position
    (8, 32, 8, 256, [1, 256, 17, 64, 65, 128, 200, 255]),
])
def test_decode_attention_matches_plain(dev, b, h, hkv, t, lengths):
    gen = torch.Generator(device=dev).manual_seed(b * 100 + t)
    q = torch.randn((b, h, 128), generator=gen, device=dev).to(torch.bfloat16)
    kc = torch.randn((b, t, hkv, 128), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((b, t, hkv, 128), generator=gen, device=dev).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = k2.decode_attention.launches
    got = k2.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert k2.decode_attention.launches == before + 1
    ref = k2.decode_attention_plain(q, kc, vc, lens, 128 ** -0.5)
    # f32 scores, softmax and sums in both; the kernel merges its warps' and
    # CTAs' online softmaxes and rounds p to bf16 (the TPU kernel's own
    # rounding), the plain version takes one f32 softmax over T
    assert got.dtype == torch.float32 and float(compute_error(ref, got)) >= 40


QUANT_WRAPPERS = {"int8": (k2.decode_attention_int8, "i8"),
                  "float8_e4m3fn": (k2.decode_attention_fp8, "f8"),
                  "int4": (k2.decode_attention_int4, "i4")}
K2V_DTYPES = ("int8", "float8_e5m2")


def _plans(row_bytes):
    """The decode mainloop's (splits, rows, stages) whose ring fits a block
    over stored rows of ``row_bytes``."""
    return [(sp, rows, st) for sp in k2.SPLITS for rows in k2.TILE_ROWS for st in k2.STAGES
            if k2.smem_bytes(rows, st, row_bytes) <= k2.SMEM_MAX]


def _quant_cache(dev, dtype_name, b, t, hkv, gen, scale=1.0):
    x = torch.randn((b, t, hkv, 128), generator=gen, device=dev) * scale
    return QuantKVCache.create(b, t, hkv, 128, dtype_name, device=dev).update(x, 0)


@pytest.mark.parametrize("dtype_name", list(QUANT_WRAPPERS))
@pytest.mark.parametrize("b,h,hkv,t,lengths", [
    (2, 8, 2, 128, [128, 77]),
    (3, 8, 1, 104, [1, 104, 64]),    # G = 8, T not a multiple of the chunk
    (2, 4, 4, 192, [0, 65]),         # G = 1; length 0 masks every position
    (8, 32, 8, 256, [1, 256, 17, 64, 65, 128, 200, 255]),
])
def test_decode_attention_quant_matches_plain(dev, dtype_name, b, h, hkv, t, lengths):
    wrapper, kind = QUANT_WRAPPERS[dtype_name]
    gen = torch.Generator(device=dev).manual_seed(b * 100 + t)
    q = torch.randn((b, h, 128), generator=gen, device=dev).to(torch.bfloat16)
    ck = _quant_cache(dev, dtype_name, b, t, hkv, gen, scale=2.0)
    cv = _quant_cache(dev, dtype_name, b, t, hkv, gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = wrapper.launches
    got = wrapper(q, ck.qdata, ck.scale, cv.qdata, cv.scale, lens)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = k2.decode_attention_quant_plain(kind, q, ck.qdata, ck.scale, cv.qdata, cv.scale, lens,
                                          128 ** -0.5)
    # the same roundings (K5: the same int8 q, exact integer dots); the
    # kernel rounds p * vs to bf16 against each warp's running max, the
    # plain version against each chunk's
    sqnr = float(compute_error(ref, got))
    assert got.dtype == torch.float32 and sqnr >= 40, f"{dtype_name}: {sqnr:.2f} dB"


@pytest.mark.parametrize("dtype_name", list(QUANT_WRAPPERS))
def test_decode_attention_quant_refuses_on_the_card(dev, dtype_name):
    wrapper, _ = QUANT_WRAPPERS[dtype_name]
    gen = torch.Generator(device=dev).manual_seed(1)
    ck = _quant_cache(dev, dtype_name, 2, 64, 2, gen)
    q = torch.randn((2, 4, 128), generator=gen, device=dev)
    lens = torch.tensor([3, 64], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim 128"):
        wrapper(q[..., :64], ck.qdata, ck.scale, ck.qdata, ck.scale, lens)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(q, ck.qdata, ck.scale.transpose(1, 2).contiguous().transpose(1, 2), ck.qdata,
                ck.scale, lens)


@pytest.mark.parametrize("dtype_name", K2V_DTYPES)
@pytest.mark.parametrize("b,h,hkv,t,lengths", [
    (2, 8, 2, 128, [128, 77]),
    (3, 8, 1, 104, [1, 104, 64]),    # G = 8, T not a multiple of the chunk
    (2, 4, 4, 192, [0, 65]),         # G = 1; length 0 attends over every position
    (8, 32, 8, 256, [1, 256, 17, 64, 65, 128, 200, 255]),
])
def test_k2v_matches_plain(dev, dtype_name, b, h, hkv, t, lengths):
    """K2v over int8 and e5m2 tokens caches: >= 40 dB against its plain
    version; NaN bytes and scales at or past lengths change no output bit."""
    gen = torch.Generator(device=dev).manual_seed(b * 100 + t + 7)
    q = torch.randn((b, h, 128), generator=gen, device=dev).to(torch.bfloat16)
    ck = _quant_cache(dev, dtype_name, b, t, hkv, gen, scale=2.0)
    cv = _quant_cache(dev, dtype_name, b, t, hkv, gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = k2.decode_attention_vec8.launches
    got = k2.decode_attention(q, ck.qdata, cv.qdata, lens, k_scale=ck.scale, v_scale=cv.scale)
    torch.cuda.synchronize()
    assert k2.decode_attention_vec8.launches == before + 1
    ref = k2.decode_attention_quant_plain("v8", q, ck.qdata, ck.scale, cv.qdata, cv.scale, lens,
                                          128 ** -0.5)
    sqnr = float(compute_error(ref, got))
    assert got.dtype == torch.float32 and sqnr >= 40, f"{dtype_name}: {sqnr:.2f} dB"
    for i, n in enumerate(lengths):
        if n >= 1:
            for c in (ck, cv):
                c.qdata.view(torch.uint8)[i, n:] = 0x7F  # e5m2 NaN
                c.scale[i, :, n:] = float("nan")
    again = k2.decode_attention_vec8(q, ck.qdata, ck.scale, cv.qdata, cv.scale, lens)
    torch.cuda.synchronize()
    assert k2.decode_attention_vec8.launches == before + 2
    assert torch.equal(again, got)


def test_k2v_refuses_on_the_card(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    ck = _quant_cache(dev, "float8_e5m2", 2, 64, 2, gen)
    q = torch.randn((2, 4, 128), generator=gen, device=dev)
    lens = torch.tensor([3, 64], dtype=torch.int32, device=dev)
    before = k2.decode_attention_vec8.launches
    with pytest.raises(ValueError, match="head_dim 128"):
        k2.decode_attention_vec8(q[..., :64], ck.qdata, ck.scale, ck.qdata, ck.scale, lens)
    with pytest.raises(ValueError, match="v_cache must be"):
        k2.decode_attention_vec8(q, ck.qdata, ck.scale, ck.qdata.view(torch.int8), ck.scale, lens)
    assert k2.decode_attention_vec8.launches == before


@pytest.mark.parametrize("dtype_name", K2V_DTYPES)
def test_k2v_decodes_every_code_exactly(dev, dtype_name):
    """K2v's bf16 decode of the stored bytes: two sequences of length 1 (q
    0, so p = 1; scales 1) whose K and V rows at position 0 hold every int8
    / e5m2 byte give those values as their output, bit for bit the plain
    decode's. The e5m2 codes of exponent 31 (inf and NaN: 0x7C-0x7F,
    0xFC-0xFF), which the cache's quantizer never writes below a length,
    come out finite."""
    from ao_tpu_torch.serving.kvcache import stored_values

    ck, cv = (QuantKVCache.create(2, 16, 1, 128, dtype_name, device=dev) for _ in range(2))
    codes = torch.arange(256, dtype=torch.uint8).reshape(2, 128).to(dev)
    for c in (ck, cv):
        c.qdata.view(torch.uint8)[:, 0, 0] = codes
        c.scale.fill_(1.0)
    q = torch.zeros((2, 1, 128), device=dev, dtype=torch.bfloat16)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    got = k2.decode_attention_vec8(q, ck.qdata, ck.scale, cv.qdata, cv.scale, lens)[:, 0]
    want = stored_values(cv.qdata[:, 0, 0]).to(torch.float32)
    exact = torch.isfinite(want)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[exact], want[exact])
    assert int((~exact).sum()) == (8 if dtype_name == "float8_e5m2" else 0)


K2V_TS = (256, 1024, 4096)


def _k2v_lengths(t):
    # 0 and negative (every position masked: the mean of vs V over all T),
    # 1, a slab and a tile +- 1, T - 1, T and past T (every position valid)
    return [0, -3, 1, 17, 129, t - 1, t, t + 5]


@pytest.mark.parametrize("dtype_name", K2V_DTYPES)
@pytest.mark.parametrize("splits,rows,stages", _plans(k2.HEAD_DIM))
def test_k2v_every_plan(dev, dtype_name, splits, rows, stages):
    """K2v at each plan of the decode mainloop over 128-byte rows, at T =
    256, 1024 and 4096 with lengths 0, negative, 1, ..., T and past T, and
    NaN bytes and scales at or past every length: >= 40 dB against the
    plain version, the same bits over three calls, one device kernel a
    call."""
    b, h, hkv = 8, 32, 8
    for t in K2V_TS:
        lengths = _k2v_lengths(t)
        gen = torch.Generator(device=dev).manual_seed(t + splits * 10 + rows + stages)
        q = torch.randn((b, h, 128), generator=gen, device=dev).to(torch.bfloat16)
        ck = _quant_cache(dev, dtype_name, b, t, hkv, gen, scale=2.0)
        cv = _quant_cache(dev, dtype_name, b, t, hkv, gen)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        args = (q, ck.qdata, ck.scale, cv.qdata, cv.scale, lens)
        ref = k2.decode_attention_quant_plain("v8", *args, 128 ** -0.5)
        for i, n in enumerate(lengths):
            if n >= 1:
                for c in (ck, cv):
                    c.qdata.view(torch.uint8)[i, n:] = 0x7F  # e5m2 NaN
                    c.scale[i, :, n:] = float("nan")
        plan = k2.launch_plan_vec8(q.shape, ck.qdata.shape, splits=splits, rows=rows,
                                   stages=stages)
        before = k2.decode_attention_vec8.launches
        got = _repeats(lambda: k2._launch_quant("v8", *args, 128 ** -0.5, plan))
        assert k2.decode_attention_vec8.launches == before + 3
        assert bool(torch.isfinite(got).all())
        sqnr = float(compute_error(ref, got))
        assert sqnr >= 40, f"{dtype_name} T={t} {plan}: {sqnr:.2f} dB"
    assert _device_kernels(lambda: k2._launch_quant("v8", *args, 128 ** -0.5, plan)) == 1


# K6 (fp8 e4m3), K7 (int4 "ch4") and K5 (int8, q quantized to int8) on the
# decode mainloop, rows converted straight into mma fragments ("direct")
K67_DTYPES = {"float8_e4m3fn": "f8", "int4": "i4", "int8": "i8"}


def _direct_plans(kind):
    """The (splits, rows, stages) of K6's or K7's ring that the kernel builds."""
    return [(sp, rows, st) for sp in k2.SPLITS for rows in k2.TILE_ROWS
            for st in k2.DIRECT_STAGES
            if k2.smem_bytes(rows, st, k2.DIRECT_KINDS[kind], direct=True) <= k2.SMEM_MAX]


def _allocations(fn) -> int:
    """The caching allocator's allocations one call of ``fn`` makes, after a
    warm call."""
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    fn()
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["allocation.all.allocated"] - before


def _poison_past(caches, lengths):
    """Bytes at or past each length set to 0x7F (an e4m3 NaN; int4 nibbles
    7 and 15) and their scales to NaN: none of it may reach the output."""
    for i, n in enumerate(lengths):
        if n >= 1:
            for c in caches:
                c.qdata.view(torch.uint8)[i, n:] = 0x7F
                c.scale[i, :, n:] = float("nan")


def _check_k67(dev, dtype_name, b, h, hkv, t, lengths, plan_kw=None, seed=0, q_offset=0):
    """K6, K7 or K5 at one shape and plan against its plain version: >= 40 dB,
    poison past the lengths unread, three calls the same bits, one device
    kernel and one allocation (the output) a call; with ``q_offset``, q a
    view that many elements into its buffer, called through the wrapper
    (which copies a q off a 16-byte boundary)."""
    kind = K67_DTYPES[dtype_name]
    wrapper = QUANT_WRAPPERS[dtype_name][0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, 128), generator=gen, device=dev).to(torch.bfloat16)
    if q_offset:
        q = torch.cat([q.new_zeros(q_offset), q.flatten()])[q_offset:].view(b, h, 128)
    ck = _quant_cache(dev, dtype_name, b, t, hkv, gen, scale=2.0)
    cv = _quant_cache(dev, dtype_name, b, t, hkv, gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    args = (q, ck.qdata, ck.scale, cv.qdata, cv.scale, lens)
    ref = k2.decode_attention_quant_plain(kind, *args, 128 ** -0.5)
    _poison_past((ck, cv), lengths)
    plan = k2.launch_plan_quant(kind, q.shape, ck.qdata.shape, **(plan_kw or {}))
    if q_offset:
        run = lambda: wrapper(*args, sm_scale=128 ** -0.5)  # noqa: E731
    else:
        run = lambda: k2._launch_quant(kind, *args, 128 ** -0.5, plan)  # noqa: E731
    before = wrapper.launches
    got = _repeats(run)
    assert wrapper.launches == before + 3
    assert bool(torch.isfinite(got).all())
    sqnr = float(compute_error(ref, got))
    assert sqnr >= 40, f"{dtype_name} T={t} {plan}: {sqnr:.2f} dB"
    return run


@pytest.mark.parametrize("dtype_name,splits,rows,stages", [
    (dtype_name, *plan) for dtype_name, kind in K67_DTYPES.items()
    for plan in _direct_plans(kind)])
def test_k6_k7_every_plan(dev, dtype_name, splits, rows, stages):
    """K6 / K7 / K5 at each plan of their ring (direct) at T = 256, 1024 and 4096
    with lengths 0, negative, 1, ..., T and past T, NaN bytes and scales past
    every length: >= 40 dB against the plain version, the same bits over
    three calls, one device kernel and no allocation but the output's."""
    for t in K2V_TS:
        run = _check_k67(dev, dtype_name, 8, 32, 8, t, _k2v_lengths(t),
                         dict(splits=splits, rows=rows, stages=stages),
                         seed=t + splits * 10 + rows + stages)
    assert _device_kernels(run) == 1
    assert _allocations(run) == 1


@pytest.mark.parametrize("dtype_name", list(K67_DTYPES))
@pytest.mark.parametrize("b,h,hkv,t,lengths", [
    (2, 8, 8, 104, [-2, 104]),        # G = 1, T not a multiple of 16 (int4: of 8)
    (3, 16, 2, 72, [0, 1, 71]),       # G = 8
    (2, 32, 8, 1000, [999, 3]),       # T not a multiple of 64
    (8, 32, 8, 1024, [1, 1024, 128, 129, 700, 64, 65, 1000]),  # the slot engine's
])
def test_k6_k7_groups_and_ragged_t(dev, dtype_name, b, h, hkv, t, lengths):
    """K6 / K7 / K5 at their default plan: G = 1 and 8, T not a multiple of
    the slab or the tile, lengths 0 / negative / 1 / T."""
    for splits in (None, 1):
        run = _check_k67(dev, dtype_name, b, h, hkv, t, lengths,
                         {} if splits is None else dict(splits=splits), seed=b + t)
    assert _device_kernels(run) == 1
    assert _allocations(run) == 1


@pytest.mark.parametrize("dtype_name", list(K67_DTYPES))
def test_k6_k7_take_a_q_off_16_bytes(dev, dtype_name):
    """A contiguous q view off a 16-byte boundary (the kernels read q in
    16-byte loads) through the wrapper: its aligned copy gives the plain
    version's output at >= 40 dB; two device operations a call, q's copy
    and the kernel."""
    run = _check_k67(dev, dtype_name, 2, 32, 8, 200, [150, 200], q_offset=3)
    assert _device_kernels(run) == 2


@pytest.mark.parametrize("dtype_name", list(K67_DTYPES))
def test_k6_k7_decode_every_code_exactly(dev, dtype_name):
    """K6's / K7's / K5's conversion of V in registers and the output's
    channel order: sequences of length 1 (q 0, so p = 1; scales 1) whose V
    row at position 0 holds every e4m3 or int8 byte or every int4 nibble in
    every channel give those values as their output, bit for bit the plain
    decode's; the two e4m3 NaN codes (0x7F, 0xFF), which the cache's
    quantizer never writes, come out finite."""
    from ao_tpu_torch.serving.kvcache import stored_values

    kind = K67_DTYPES[dtype_name]
    nb = 16 if kind == "i4" else 2
    ck, cv = (QuantKVCache.create(nb, 16, 1, 128, dtype_name, device=dev) for _ in range(2))
    if kind != "i4":
        codes = torch.arange(256, dtype=torch.uint8).reshape(2, 128)
    else:  # nibble u of channel c in row i: (c + i) % 16
        u = (torch.arange(128)[None, :] + torch.arange(16)[:, None]) % 16
        codes = (u[:, 0::2] | (u[:, 1::2] << 4)).to(torch.uint8)  # channel 2i low, 2i + 1 high
    for c in (ck, cv):
        c.qdata.view(torch.uint8)[:, 0, 0] = codes.to(dev)
        c.scale.fill_(1.0)
    q = torch.zeros((nb, 1, 128), device=dev, dtype=torch.bfloat16)
    lens = torch.ones(nb, dtype=torch.int32, device=dev)
    got = k2._launch_quant(kind, q, ck.qdata, ck.scale, cv.qdata, cv.scale, lens,
                           128 ** -0.5)[:, 0]
    want = stored_values(cv.qdata[:, 0, 0]).to(torch.float32)
    exact = torch.isfinite(want)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[exact], want[exact])
    assert int((~exact).sum()) == (2 if kind == "f8" else 0)


@pytest.mark.parametrize("b,h,hkv,t,lengths", [
    (2, 8, 2, 128, [128, 77]),
    (3, 8, 1, 104, [1, 104, 64]),    # G = 8, T not a multiple of the slab
    (2, 4, 4, 192, [0, 65]),         # G = 1; length 0 masks every position
    (8, 32, 8, 1024, [1, 1024, 128, 129, 700, 64, 65, 1000]),  # the slot engine's
])
def test_k5_poison_past_the_lengths_changes_no_bit(dev, b, h, hkv, t, lengths):
    """K5 through its wrapper: >= 40 dB against its plain version, and
    0x7F bytes and NaN scales at or past every length change no output bit;
    one device kernel and one allocation (the output) a call."""
    gen = torch.Generator(device=dev).manual_seed(b * 100 + t + 5)
    q = torch.randn((b, h, 128), generator=gen, device=dev).to(torch.bfloat16)
    ck = _quant_cache(dev, "int8", b, t, hkv, gen, scale=2.0)
    cv = _quant_cache(dev, "int8", b, t, hkv, gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    args = (q, ck.qdata, ck.scale, cv.qdata, cv.scale, lens)
    before = k2.decode_attention_int8.launches
    got = k2.decode_attention(q, ck.qdata, cv.qdata, lens, k_scale=ck.scale, v_scale=cv.scale,
                              mode="i8")
    torch.cuda.synchronize()
    assert k2.decode_attention_int8.launches == before + 1
    ref = k2.decode_attention_quant_plain("i8", *args, 128 ** -0.5)
    sqnr = float(compute_error(ref, got))
    assert bool(torch.isfinite(got).all()) and sqnr >= 40, f"{sqnr:.2f} dB"
    _poison_past((ck, cv), lengths)
    run = lambda: k2.decode_attention_int8(*args)  # noqa: E731
    assert torch.equal(_repeats(run), got)
    assert _device_kernels(run) == 1
    assert _allocations(run) == 1


def test_fp8_cast_matches_cpu(dev):
    # the cache's fp8 quantize on the card gives the CPU's bits (the CPU's
    # equal JAX's, tests/test_torch_kvcache.py)
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = (torch.randn((1 << 20,), generator=gen) * 200).clamp(-448, 448)
    x[:4] = torch.tensor([448.0, -448.0, 0.0, 2.0 ** -10])
    got = x.to(dev).to(torch.float8_e4m3fn).view(torch.uint8).cpu()
    assert torch.equal(got, x.to(torch.float8_e4m3fn).view(torch.uint8))
    # and e5m2's
    y = x * 128
    got = y.to(dev).to(torch.float8_e5m2).view(torch.uint8).cpu()
    assert torch.equal(got, y.to(torch.float8_e5m2).view(torch.uint8))


@pytest.mark.parametrize("kv_quant", list(QUANT_WRAPPERS) + ["float8_e5m2"])
def test_generate_kv_quant_goes_through_its_kernel(dev, kv_quant):
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=1024, tie_embeddings=False)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    qparams = ao_tpu_torch.quantize_(params, ao_tpu_torch.Int4WeightOnlyConfig(group_size=32))
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), device=dev, dtype=torch.int32)
    counters = [k1.int4_wo_magic, k2.decode_attention, k2.decode_attention_vec8] + [
        w for w, _ in QUANT_WRAPPERS.values()]
    for c in counters:
        c.launches = 0
    toks = ao_tpu_torch.generate(qparams, prompt, cfg, num_steps=5, max_seq=16, kv_quant=kv_quant)
    torch.cuda.synchronize()
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    want = {id(c): 0 for c in counters}
    want[id(k1.int4_wo_magic)] = (7 * cfg.n_layers + 1) * 5
    kernel = QUANT_WRAPPERS[kv_quant][0] if kv_quant in QUANT_WRAPPERS \
        else k2.decode_attention_vec8
    want[id(kernel)] = cfg.n_layers * 4
    assert [c.launches for c in counters] == [want[id(c)] for c in counters]


def test_generate_goes_through_both_kernels(dev):
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=1024, tie_embeddings=False)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    qparams = ao_tpu_torch.quantize_(params, ao_tpu_torch.Int4WeightOnlyConfig(group_size=32))
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), device=dev, dtype=torch.int32)
    k1.int4_wo_magic.launches = 0
    k2.decode_attention.launches = 0
    toks = ao_tpu_torch.generate(qparams, prompt, cfg, num_steps=5, max_seq=16)
    torch.cuda.synchronize()
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    assert k1.int4_wo_magic.launches == (7 * cfg.n_layers + 1) * 5
    assert k2.decode_attention.launches == cfg.n_layers * 4
    # the "torch" backend takes no kernel
    with kernels.backend("torch"):
        ao_tpu_torch.generate(qparams, prompt, cfg, num_steps=2, max_seq=16)
    assert k1.int4_wo_magic.launches == (7 * cfg.n_layers + 1) * 5


W4A8_SPEC = ActQuantSpec(dtype="int8", granularity="per_token", symmetric=True)


def _w4a8_weight(dev, k, n, g, domain, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    zpd = ZeroPointDomain.FLOAT if domain == "tinygemm" else ZeroPointDomain.INT
    qa = Int4Array.from_hp(w, group_size=g, zero_point_domain=zpd, act_quant=W4A8_SPEC)
    assert qa.layout == "magic8"
    return qa, gen


@pytest.mark.parametrize("m,k,n,g,domain", [
    (1, 512, 128, 32, "tinygemm"),
    (8, 1024, 256, 128, "tinygemm"),
    (8, 1024, 1024, 64, "minmax_int"),
    (16, 512, 128, 32, "tinygemm"),      # two n8 tiles of batch rows
    (40, 2048, 512, 128, "minmax_int"),  # 32-row blocks along M, a ragged edge
    (200, 512, 256, 32, "tinygemm"),
])
def test_int4_w4a8_matches_plain(dev, m, k, n, g, domain):
    from ao_tpu_torch.ops.act_quant import quantize_activation

    qa, gen = _w4a8_weight(dev, k, n, g, domain, seed=m * 7 + n)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    xq, sx, _ = quantize_activation(x, W4A8_SPEC)
    before = k1.int4_w4a8_matmul.launches
    got = k1.int4_w4a8_matmul(xq, sx, qa.qdata, qa.scale, qa.zero_point, g, qa.zero_point_domain)
    torch.cuda.synchronize()
    assert k1.int4_w4a8_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    s, b = k1.w4a8_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    ref = k1.int4_w4a8_matmul_plain(xq, sx, qa.qdata, s, b, g)
    # exact integer dots in both; f32 sums of the groups in another order
    sqnr = float(compute_error(ref, got))
    assert sqnr >= 45, f"K3 vs plain: {sqnr:.2f} dB"


def _device_kernels(fn) -> int:
    """The device kernels one call of ``fn`` runs, as torch.profiler counts
    them (``utils/timing.device_kernels``: an empty profile taken again, then
    the nodes of a CUDA graph captured from one call)."""
    from ao_tpu_torch.utils.timing import device_kernels

    return device_kernels(fn)


LLAMA_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]


@pytest.mark.parametrize("k,n", LLAMA_KN)
def test_int4_w4a8_one_launch_at_each_llama_plan(dev, k, n):
    """K3 at Llama-3-8B's widths and M = 1, 8 and 16, each at its
    ``w4a8_plan`` (a K split of up to 8 CTAs summed in their cluster): 45
    dB against the plain version, one device kernel a call, no workspace,
    and the same bits on a second call."""
    from ao_tpu_torch.ops.act_quant import quantize_activation

    qa, gen = _w4a8_weight(dev, k, n, 128, "tinygemm", seed=k + n)
    s, b = k1.w4a8_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    for m in (1, 8, 16):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        xq, sx, _ = quantize_activation(x, W4A8_SPEC)
        run = lambda: k1._launch_w4a8(xq, sx, qa.qdata, qa.scale, qa.zero_point, 128)  # noqa: E731
        got, again = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"M={m}: two calls differ"
        ref = k1.int4_w4a8_matmul_plain(xq, sx, qa.qdata, s, b, 128)
        sqnr = float(compute_error(ref, got))
        assert sqnr >= 45, f"K3 M={m} K={k} N={n} {k1.w4a8_plan(m, k, n, 128, 132)}: {sqnr:.2f} dB"
        assert _device_kernels(run) == 1


@pytest.mark.parametrize("plan", [(1, 1, 8), (1, 8, 1), (1, 4, 2), (1, 3, 3), (2, 4, 1),
                                  (8, 1, 1), (4, 2, 1), (2, 2, 3), (2, 1, 4)])
def test_int4_w4a8_every_cta_width_and_split(dev, plan):
    """K3 at 1-8 warps along K in a CTA (M = 5 only: above 16 rows a CTA has
    one) and K splits of 1-8 (uneven ones, and a last CTA with an idle
    warp, too) at M = 5 and 40 (32-row tiles along grid.y) over 8 group
    pairs."""
    from ao_tpu_torch.ops.act_quant import quantize_activation

    qa, gen = _w4a8_weight(dev, 2048, 256, 128, "minmax_int", seed=sum(plan))
    s, b = k1.w4a8_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    for m in (5, 40) if plan[0] == 1 else (5,):
        x = torch.randn((m, 2048), generator=gen, device=dev).to(torch.bfloat16)
        xq, sx, _ = quantize_activation(x, W4A8_SPEC)
        got = k1._launch_w4a8(xq, sx, qa.qdata, s, b, 128, plan)
        again = k1._launch_w4a8(xq, sx, qa.qdata, s, b, 128, plan)
        torch.cuda.synchronize()
        ref = k1.int4_w4a8_matmul_plain(xq, sx, qa.qdata, s, b, 128)
        assert float(compute_error(ref, got)) >= 45 and torch.equal(got, again)
    with pytest.raises(RuntimeError, match="CUDA error"):
        k1._launch_w4a8(xq, sx, qa.qdata, s, b, 128, (1, 9, 1))  # a cluster of 9


# K4 at the five Llama widths at g = 128 (the W4A8 prefill's), at g = 32
# and 64, and at small shapes (a single slab, N % 128 == 64)
REQUANT_CASES = ([(512, 256, 64), (1024, 1024, 128), (512, 128, 32), (768, 320, 32)]
                 + [(k, n, 128) for k, n in LLAMA_KN]
                 + [(4096, 4096, 32), (4096, 4096, 64), (14336, 4096, 64), (4096, 1024, 32)])


@pytest.mark.parametrize("k,n,g", REQUANT_CASES)
def test_requant_matches_plain_and_feeds_int_mm(dev, k, n, g):
    """K4 at its plan equals its plain version bit for bit, writes q8
    column-major, feeds torch._int_mm as its B operand, runs as one device
    kernel, and a second launch gives the same bits."""
    qa, gen = _w4a8_weight(dev, k, n, g, "tinygemm", seed=k + n)
    sg, bg, s8 = _requant_scale(qa)
    before = k1.int4_magic8_requant_int8.launches
    got = k1.int4_magic8_requant_int8(qa.qdata, sg, bg, s8, g)
    torch.cuda.synchronize()
    assert k1.int4_magic8_requant_int8.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == (k, n) and got.stride() == (1, k)
    a, b = k1.requant_rows(sg, bg, s8)
    ref = k1.int4_magic8_requant_int8_plain(qa.qdata, a, b, g)
    diff = (got.int() - ref.int()).abs()
    # the same two f32 roundings per value: equal, bit for bit
    assert int(diff.max()) == 0, f"K4 vs plain: {int((diff > 0).sum())} values differ"
    run = lambda: k1._launch_requant(qa.qdata, a, b, g)  # noqa: E731
    assert torch.equal(run(), got)
    assert _device_kernels(run) == 1
    xq = torch.randint(-127, 128, (32, k), generator=gen, device=dev, dtype=torch.int8)
    # the column-major q8 is the B operand the int8 GEMM takes on the card;
    # f64 sums of int8 products are exact here
    want = (xq.double() @ ref.double()).int()
    assert torch.equal(torch._int_mm(xq, got), want)


@pytest.mark.parametrize("g", [32, 64, 128])
def test_requant_at_ties_and_clips(dev, g):
    """K4 over random words (every nibble) with a and b that put u * a + b
    on half-integers (ties, rounded to even) and past +-127 (clipped): bit
    for bit the plain version."""
    k, n = 1024, 448
    gen = torch.Generator(device=dev).manual_seed(g)
    word = torch.randint(-2 ** 31, 2 ** 31 - 1, (k // 8, n), generator=gen, device=dev,
                         dtype=torch.int32)
    ng = k // g
    a = torch.randint(-40, 41, (ng, n), generator=gen, device=dev).float() * 0.5
    b = torch.randint(-300, 301, (ng, n), generator=gen, device=dev).float() * 0.5
    a[0] = torch.randn((n,), generator=gen, device=dev) * 20  # arbitrary f32 products
    ref = k1.int4_magic8_requant_int8_plain(word, a, b, g)
    v = (k1.unpack_int4_magic8(word, g).float() * a.repeat_interleave(g, 0)
         + b.repeat_interleave(g, 0))
    # ties, and clips on both sides, are there
    assert bool(((v - v.floor()) == 0.5).any()) and bool((v > 127.5).any())
    assert bool((v < -127.5).any())
    got = k1._launch_requant(word, a, b, g)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape,act,dtype", [
    ((1, 32, 256), "silu", torch.bfloat16),
    ((2, 7, 1024), "gelu", torch.bfloat16),
    ((8, 128, 14336), "silu", torch.bfloat16),
    ((3, 5, 512), "silu", torch.float32),
])
def test_silu_mul_quant_matches_plain(dev, shape, act, dtype):
    gen = torch.Generator(device=dev).manual_seed(shape[-1])
    a = torch.randn(shape, generator=gen, device=dev).to(dtype)
    b = torch.randn(shape, generator=gen, device=dev).to(dtype)
    before = k12.silu_mul_quant.launches
    q, s = k12.silu_mul_quant(a, b, act=act)
    torch.cuda.synchronize()
    assert k12.silu_mul_quant.launches == before + 1
    assert q.dtype == torch.int8 and q.shape == shape and s.shape == shape[:2] + (1,)
    qr, sr = k12.silu_mul_quant_plain(a, b, act=act)
    d = (q.int() - qr.int()).abs()
    frac = float((d > 0).float().mean())
    # expf and the sigmoid's division round otherwise than PyTorch's
    assert int(d.max()) <= 1 and frac < 0.01, f"K12 q: {frac:.4%} differ"
    rel = float(((s - sr).abs() / sr).max())
    assert rel <= 1e-6, f"K12 scales: max relative difference {rel:.3g}"


def test_generate_w4a8_goes_through_its_kernels(dev):
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=1024, tie_embeddings=False)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    wparams = ao_tpu_torch.quantize_(
        params, ao_tpu_torch.Int8DynamicActivationInt4WeightConfig(group_size=32))
    # B * S = 544 > 512: the prefill takes the requant route
    prompt = torch.randint(0, cfg.vocab_size, (2, 272), device=dev, dtype=torch.int32)
    counters = (k1.int4_wo_magic, k1.int4_w4a8_matmul, k1.int4_magic8_requant_int8,
                k12.silu_mul_quant, k2.decode_attention)
    for c in counters:
        c.launches = 0
    toks = ao_tpu_torch.generate(wparams, prompt, cfg, num_steps=5, max_seq=280)
    torch.cuda.synchronize()
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    n_lin = 7 * cfg.n_layers + 1
    assert [c.launches for c in counters] == [0, n_lin * 4, n_lin, cfg.n_layers,
                                              cfg.n_layers * 4]


# K8's cases: (B, Sq, Sk, H, Hkv, causal)
FLASH_CASES = [
    (1, 128, 128, 4, 2, True),
    (1, 128, 128, 4, 2, False),
    (2, 128, 256, 4, 2, True),      # Sq < Sk: top-left aligned, the cache rows past Sq unseen
    (2, 13, 128, 8, 8, True),       # a ragged query tile
    (1, 200, 200, 4, 1, False),     # a ragged key tile
    (1, 200, 200, 4, 1, True),      # a ragged query tile, causal
    (2, 200, 200, 4, 1, False),     # a ragged key tile; NaN in the next batch row's K, V
    (8, 128, 256, 32, 8, True),     # generate(use_flash=True)
    (1, 512, 512, 32, 8, True),     # the engine's largest bucket
]


@pytest.mark.parametrize("b,sq,sk,h,hkv,causal", FLASH_CASES)
def test_flash_attention_matches_plain(dev, b, sq, sk, h, hkv, causal):
    gen = torch.Generator(device=dev).manual_seed(sq * 7 + sk)
    q = torch.randn((b, sq, h, 128), generator=gen, device=dev).to(torch.bfloat16)
    kc = torch.randn((b, sk, hkv, 128), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((b, sk, hkv, 128), generator=gen, device=dev).to(torch.bfloat16)
    before = k8.flash_attention.launches
    got = k8.flash_attention(q, kc, vc, causal=causal)
    torch.cuda.synchronize()
    assert k8.flash_attention.launches == before + 1
    ref = k8.flash_attention_plain(q, kc, vc, causal, 128 ** -0.5)
    # f32 scores and sums in both, bf16 p and output; the kernel rounds p
    # against its running max per 64-key tile, as the plain version does
    sqnr = float(compute_error(ref.float(), got.float()))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape and sqnr >= 40, f"{sqnr:.2f} dB"
    if causal and sq < sk:
        # rows past Sq of the cache never reach the output
        vc[:, sq:] = float("nan")
        kc[:, sq:] = float("nan")
        again = k8.flash_attention(q, kc, vc, causal=True)
        assert torch.equal(again, got)
    if b > 1 and not causal:
        # the last key tile runs past Sk: the tensor maps zero-fill it and
        # never read the next batch row's keys
        kc[1:], vc[1:] = float("nan"), float("nan")
        again = k8.flash_attention(q, kc, vc, causal=False)
        torch.cuda.synchronize()
        assert torch.isfinite(again[0]).all()
        assert torch.equal(again[0], k8.flash_attention(q[:1], kc[:1], vc[:1], causal=False)[0])


@pytest.mark.parametrize("kernel", ["K8", "K16"])
def test_attention_raises_when_no_tensor_map(dev, monkeypatch, kernel):
    """A tensor map libcuda refuses (here: q's base not 16-byte aligned)
    makes the C function return minus the CUresult before any launch, and
    the wrapper raise; nothing falls back."""
    import ctypes

    from ao_tpu_torch.ops.hopper import window_attention as k16

    x = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16, device=dev)
    buf = torch.zeros(x.numel() + 8, dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    if kernel == "K8":
        err = k8._lib().ao_flash_attention(buf.data_ptr() + 2, x.data_ptr(), x.data_ptr(),
                                           out.data_ptr(), 1, 64, 64, 2, 2, 64, 0.1, 1,
                                           ctypes.c_void_p(0))
        mod, name, fn = k8, "ao_flash_attention", k8.flash_attention
        call = lambda: k8.flash_attention(x, x, x)  # noqa: E731
    else:
        xw = x[..., :64].contiguous()  # T = 64: side 8
        rel = torch.zeros((1, 2, 64, 8), dtype=torch.bfloat16, device=dev)
        err = k16._lib().ao_window_attention(buf.data_ptr() + 2, xw.data_ptr(), xw.data_ptr(),
                                             rel.data_ptr(), rel.data_ptr(), out.data_ptr(), 1,
                                             64, 8, 2, 0.1, ctypes.c_void_p(0))
        mod, name, fn = k16, "ao_window_attention", k16.window_bias_attention
        call = lambda: k16.window_bias_attention(xw, xw, xw, rel, rel, side=8,  # noqa: E731
                                                 scale=0.1)
    assert err < 0

    class Refusing:
        pass

    setattr(Refusing, name, staticmethod(lambda *args: -1))
    monkeypatch.setattr(mod, "_lib", lambda: Refusing)
    before = fn.launches
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
        call()
    assert fn.launches == before


def test_flash_attention_refuses_on_the_card(dev):
    q = torch.randn((1, 64, 4, 128), device=dev, dtype=torch.bfloat16)
    kc = torch.randn((1, 128, 2, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 128"):
        k8.flash_attention(q[..., :64], kc[..., :64], kc[..., :64])
    with pytest.raises(ValueError, match="bf16"):
        k8.flash_attention(q, kc.float(), kc)


def _paged_inputs(dev, gen, b, h, hkv, ps, max_pages, n_pages):
    q = torch.randn((b, h, 128), generator=gen, device=dev).to(torch.bfloat16)
    kp = torch.randn((n_pages, ps, hkv, 128), generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn((n_pages, ps, hkv, 128), generator=gen, device=dev).to(torch.bfloat16)
    # every sequence's pages scattered over the pool, page 0 (null) unused
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(n_pages)) + 1
    table = perm[:b * max_pages].reshape(b, max_pages).to(torch.int32).to(dev)
    return q, kp, vp, table


@pytest.mark.parametrize("b,h,hkv,ps,max_pages,lengths", [
    (2, 4, 2, 128, 3, [300, 150]),
    (8, 32, 8, 128, 8, [1, 1024, 128, 129, 700, 64, 65, 1000]),  # 1 and a full last page
    (3, 8, 1, 8, 20, [1, 160, 77]),       # page_size 8, G = 8
    (2, 4, 4, 24, 5, [0, 120]),           # page_size 24; length 0 gives 0
])
def test_paged_attention_matches_plain(dev, b, h, hkv, ps, max_pages, lengths):
    gen = torch.Generator(device=dev).manual_seed(ps * 10 + max_pages)
    q, kp, vp, table = _paged_inputs(dev, gen, b, h, hkv, ps, max_pages, b * max_pages + 3)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    # block-table entries past each sequence's pages are the null page 0,
    # which holds NaN here: it must never be read as data
    for i, n in enumerate(lengths):
        table[i, -(-n // ps):] = 0
    kp[0], vp[0] = float("nan"), float("nan")
    before = k9.paged_decode_attention.launches
    got = k9.paged_decode_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert k9.paged_decode_attention.launches == before + 1
    ref = k9.paged_decode_attention_plain(q, kp, vp, table, lens, 128 ** -0.5)
    assert bool(torch.isfinite(got).all())
    # the same roundings; the kernel rounds p against its warp's running max
    sqnr = float(compute_error(ref, got))
    assert got.dtype == torch.float32 and sqnr >= 40, f"{sqnr:.2f} dB"
    for i, n in enumerate(lengths):
        if n <= 0:
            assert float(got[i].abs().max()) == 0.0
    # the same as K2 over the gathered dense cache
    if all(n >= 1 for n in lengths):
        t = max_pages * ps
        dense_k = torch.nan_to_num(kp[table.long()].reshape(b, t, hkv, 128))
        dense_v = torch.nan_to_num(vp[table.long()].reshape(b, t, hkv, 128))
        k2_out = k2.decode_attention_plain(q, dense_k, dense_v, lens, 128 ** -0.5)
        assert float(compute_error(k2_out, got)) >= 40


QUANT_POOLS = {"int8": k9.paged_decode_attention_vec8,
               "float8_e4m3fn": k9.paged_decode_attention_vec8,
               "int4": k9.paged_decode_attention_int4}


@pytest.mark.parametrize("dtype_name", list(QUANT_POOLS))
@pytest.mark.parametrize("b,h,hkv,ps,max_pages,lengths", [
    (2, 4, 2, 128, 3, [300, 150]),
    (8, 32, 8, 128, 8, [1, 1024, 128, 129, 700, 64, 65, 1000]),  # 1 and a full last page
    (3, 8, 1, 8, 20, [1, 160, 77]),       # page_size 8 (the reference's kernel: % 128), G = 8
    (2, 4, 4, 24, 5, [0, 120]),           # page_size 24; length 0 gives 0
])
def test_paged_attention_quant_matches_plain(dev, dtype_name, b, h, hkv, ps, max_pages,
                                             lengths):
    """K9 "vec8" (int8, fp8) and "int4" over pools written by write_prompt,
    pages shuffled, the null page and every row past lengths NaN (0x7F
    bytes, NaN scales): >= 40 dB against the plain version, finite, and the
    same bits as before the NaN went in."""
    from ao_tpu_torch.serving.paged import PagedKVPool

    wrapper = QUANT_POOLS[dtype_name]
    gen = torch.Generator(device=dev).manual_seed(ps * 10 + max_pages + 1)
    n_pages = b * max_pages + 3
    q = torch.randn((b, h, 128), generator=gen, device=dev).to(torch.bfloat16)
    pools = []
    for scale in (2.0, 1.0):
        pool = PagedKVPool.create(n_pages, ps, hkv, 128, dtype_name, device=dev)
        pool.write_prompt(torch.randn((n_pages * ps, hkv, 128), generator=gen, device=dev) * scale,
                          torch.arange(n_pages, device=dev))
        pools.append(pool)
    kp, vp = pools
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(n_pages)) + 1
    table = perm[:b * max_pages].reshape(b, max_pages).to(torch.int32).to(dev)
    for i, n in enumerate(lengths):
        table[i, -(-n // ps):] = 0
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    args = (q, kp.pages, kp.scale, vp.pages, vp.scale, table, lens)
    before = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = k9.paged_decode_attention_plain(q, kp.pages, vp.pages, table, lens, 128 ** -0.5,
                                          kp.scale, vp.scale)
    assert bool(torch.isfinite(got).all())
    sqnr = float(compute_error(ref, got))
    assert got.dtype == torch.float32 and sqnr >= 40, f"{dtype_name}: {sqnr:.2f} dB"
    for i, n in enumerate(lengths):
        if n <= 0:
            assert float(got[i].abs().max()) == 0.0
    # NaN in the null page and past every length, in the pages and scales
    for pool in (kp, vp):
        raw = pool.pages.view(torch.uint8)
        raw[0], pool.scale[0] = 0x7F, float("nan")
        for i, n in enumerate(lengths):
            pos = torch.arange(max(n, 0), -(-n // ps) * ps, device=dev)  # the last page's tail
            page, off = table[i, pos // ps].long(), pos % ps
            raw[page, off] = 0x7F
            pool.scale[page, :, off] = float("nan")
    again = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(again, got)


def test_paged_attention_quant_refuses_on_the_card(dev):
    from ao_tpu_torch.serving.paged import PagedKVPool

    kp = PagedKVPool.create(9, 16, 2, 128, "int4", device=dev)
    q = torch.randn((2, 4, 128), device=dev, dtype=torch.bfloat16)
    table = torch.ones((2, 4), dtype=torch.int32, device=dev)
    lens = torch.tensor([5, 60], dtype=torch.int32, device=dev)
    before = k9.paged_decode_attention_int4.launches
    with pytest.raises(ValueError, match="head_dim 128"):
        k9.paged_decode_attention_int4(q[..., :64], kp.pages, kp.scale, kp.pages, kp.scale,
                                       table, lens)
    with pytest.raises(ValueError, match="k_scale must be"):
        k9.paged_decode_attention_int4(q, kp.pages, kp.scale.transpose(1, 2).contiguous(),
                                       kp.pages, kp.scale, table, lens)
    with pytest.raises(ValueError, match="k_pages must be"):
        k9.paged_decode_attention_vec8(q, kp.pages, kp.scale, kp.pages, kp.scale, table, lens)
    assert k9.paged_decode_attention_int4.launches == before


def test_paged_attention_refuses_on_the_card(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    q, kp, vp, table = _paged_inputs(dev, gen, 2, 4, 2, 16, 4, 9)
    lens = torch.tensor([5, 60], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim 128"):
        k9.paged_decode_attention(q[..., :64], kp[..., :64], vp[..., :64], table, lens)
    with pytest.raises(ValueError, match="at most 8"):
        k9.paged_decode_attention(q.repeat(1, 5, 1), kp[:, :, :1].contiguous(),
                                  vp[:, :, :1].contiguous(), table, lens)


# the decode mainloop (K2, K9) at every plan it is built for: CTAs a stream
# (one cluster), positions a tile, slabs a warp's ring
DECODE_PLANS = _plans(k2.ROW_BYTES)
# lengths 0, 1, a tile of either size +- 1 and T - 1 and T, over T = 200 (not
# a multiple of either tile)
DECODE_T = 200
DECODE_LENGTHS = [0, 1, 31, 33, 63, 65, DECODE_T - 1, DECODE_T]


def _repeats(fn, n=3):
    """``fn()`` n times; asserts every output the same bits as the first."""
    outs = [fn() for _ in range(n)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    return outs[0]


@pytest.mark.parametrize("splits,rows,stages", DECODE_PLANS)
def test_decode_attention_every_plan(dev, splits, rows, stages):
    """K2 at each plan: G = 8, T not a multiple of the tile, lengths 0 (the
    mean of V over all T), 1, tile +- 1 and T; >= 40 dB against the plain
    version, the same bits over three calls, one device kernel a call."""
    b, h, hkv, t = len(DECODE_LENGTHS), 16, 2, DECODE_T
    gen = torch.Generator(device=dev).manual_seed(splits * 100 + rows + stages)
    q = torch.randn((b, h, 128), generator=gen, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((b, t, hkv, 128), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    plan = k2.launch_plan(q.shape, kc.shape, splits=splits, rows=rows, stages=stages)
    got = _repeats(lambda: k2._launch(q, kc, vc, lens, 128 ** -0.5, plan))
    ref = k2.decode_attention_plain(q, kc, vc, lens, 128 ** -0.5)
    assert bool(torch.isfinite(got).all())
    sqnr = float(compute_error(ref, got))
    assert sqnr >= 40, f"{plan}: {sqnr:.2f} dB"
    mean_v = vc[0].float().mean(dim=0)  # length 0: every position masked, all T weigh alike
    assert float(compute_error(mean_v.repeat_interleave(h // hkv, dim=0), got[0])) >= 40
    assert _device_kernels(lambda: k2._launch(q, kc, vc, lens, 128 ** -0.5, plan)) == 1


def _nan_pools(dev, dtype_name, b, hkv, ps, lengths, gen):
    """(q, k pool, v pool, table, lengths) for K9 over pools of ``dtype_name``
    (bf16 or one write_prompt takes): every sequence's pages shuffled over
    the pool, table entries past its pages 0 (the null page), and NaN (bf16
    NaN, or 0x7F bytes, an e4m3 NaN, with NaN scales) in the null page and
    in every row at or past each length."""
    from ao_tpu_torch.serving.paged import PagedKVPool

    max_pages = -(-max(lengths) // ps)
    n_pages = b * max_pages + 2
    pools = []
    for scale in (2.0, 1.0):
        pool = PagedKVPool.create(n_pages, ps, hkv, 128, dtype_name, device=dev)
        pool.write_prompt(torch.randn((n_pages * ps, hkv, 128), generator=gen, device=dev) * scale,
                          torch.arange(n_pages, device=dev))
        pools.append(pool)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(n_pages)) + 1
    table = perm[:b * max_pages].reshape(b, max_pages).to(torch.int32).to(dev)
    for i, n in enumerate(lengths):
        table[i, -(-n // ps):] = 0
    for pool in pools:
        raw = pool.pages if dtype_name == "bf16" else pool.pages.view(torch.uint8)
        nan = float("nan") if dtype_name == "bf16" else 0x7F
        raw[0] = nan
        if pool.scale is not None:
            pool.scale[0] = float("nan")
        for i, n in enumerate(lengths):
            pos = torch.arange(max(n, 0), -(-n // ps) * ps, device=dev)  # the last page's tail
            page, off = table[i, pos // ps].long(), pos % ps
            raw[page, off] = nan
            if pool.scale is not None:
                pool.scale[page, :, off] = float("nan")
    q = torch.randn((b, 16, 128), generator=gen, device=dev).to(torch.bfloat16)
    return q, pools[0], pools[1], table, torch.tensor(lengths, dtype=torch.int32, device=dev)


K9_MODES = {"bf16": k9.paged_decode_attention, "int8": k9.paged_decode_attention_vec8,
            "float8_e4m3fn": k9.paged_decode_attention_vec8,
            "int4": k9.paged_decode_attention_int4}
K9_STORAGE = {"bf16": torch.bfloat16, "int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn,
              "int4": torch.int32}


def _k9_case(dev, dtype_name, ps, plan_kw, seed):
    hkv = 2
    t = -(-DECODE_T // ps) * ps
    lengths = DECODE_LENGTHS[:-2] + [t - 1, t]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, kp, vp, table, lens = _nan_pools(dev, dtype_name, len(lengths), hkv, ps, lengths, gen)
    plan = k9.launch_plan(q.shape, kp.pages.shape, table.shape[1], kp.pages.dtype, **plan_kw)
    args = (q, kp.pages, kp.scale, vp.pages, vp.scale, table, lens, 128 ** -0.5, plan)
    before = K9_MODES[dtype_name].launches
    got = _repeats(lambda: k9._launch(*args))
    assert K9_MODES[dtype_name].launches == before + 3
    ref = k9.paged_decode_attention_plain(q, kp.pages, vp.pages, table, lens, 128 ** -0.5,
                                          kp.scale, vp.scale, plan)
    assert bool(torch.isfinite(got).all()) and float(got[0].abs().max()) == 0.0
    sqnr = float(compute_error(ref, got))
    assert sqnr >= 40, f"{dtype_name} page_size {ps} {plan}: {sqnr:.2f} dB"
    return args


@pytest.mark.parametrize("dtype_name,splits,rows,stages",
                         [(dt,) + plan for dt, pages in K9_STORAGE.items()
                          for plan in _plans(k9._ROW_BYTES[pages])])
def test_paged_attention_every_plan(dev, dtype_name, splits, rows, stages):
    """K9 in each mode at each plan over pages of 8 and 128 rows: NaN in the
    null page and past every length never reaches the output, length 0
    gives 0, >= 40 dB against the plain version at the same plan, the same
    bits over three calls, one device kernel a call."""
    for ps in (8, 128):
        args = _k9_case(dev, dtype_name, ps, dict(splits=splits, rows=rows, stages=stages),
                        seed=ps + splits * 10 + rows + stages)
    assert _device_kernels(lambda: k9._launch(*args)) == 1


@pytest.mark.parametrize("dtype_name", ["int8", "float8_e4m3fn", "int4"])
def test_paged_attention_decodes_every_code_exactly(dev, dtype_name):
    """K9's bf16 decode of the stored values, exact for every code: two
    sequences of length 1 (p = 1, v scale 1) whose V rows hold every int8 /
    e4m3 byte (the e4m3 NaN codes 0x7F, 0xFF set to 0) or every int4 nibble
    at every channel of a word give those values as their output, bit for
    bit the plain decode's."""
    from ao_tpu_torch.serving.kvcache import stored_values
    from ao_tpu_torch.serving.paged import PagedKVPool

    ps = 8
    kp, vp = (PagedKVPool.create(3, ps, 1, 128, dtype_name, device=dev) for _ in range(2))
    if dtype_name == "int4":  # word i: nibble o of word i is (i + o) % 16
        words = [sum(((i + o) % 16) << (4 * o) for o in range(8)) for i in range(16)]
        rows = torch.tensor(words, dtype=torch.int64).to(torch.int32).reshape(1, 16)
        rows = torch.cat([rows, rows.roll(8, dims=1)])
    else:
        codes = torch.arange(256, dtype=torch.uint8)
        if dtype_name == "float8_e4m3fn":
            codes[[0x7F, 0xFF]] = 0
        rows = codes.reshape(2, 128)
    for pool in (kp, vp):
        pool.pages[1:3, 0, 0] = rows.to(dev).view(pool.pages.dtype)
        pool.scale.fill_(1.0)
    q = torch.zeros((2, 1, 128), device=dev, dtype=torch.bfloat16)
    table = torch.tensor([[1], [2]], dtype=torch.int32, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    got = K9_MODES[dtype_name](q, kp.pages, kp.scale, vp.pages, vp.scale, table, lens)
    want = stored_values(vp.pages[1:3, 0, 0]).to(torch.float32)
    assert torch.equal(got[:, 0], want.to(dev))


@pytest.mark.parametrize("ps", [16, 24, 64])
@pytest.mark.parametrize("dtype_name", list(K9_MODES))
def test_paged_attention_page_sizes(dev, dtype_name, ps):
    """K9 at its default plan over pages of 16, 24 (a slab across two
    pages) and 64 rows."""
    _k9_case(dev, dtype_name, ps, {}, seed=ps)


def _small_int4_model(dev):
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=1024, tie_embeddings=False)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    return cfg, ao_tpu_torch.quantize_(params, ao_tpu_torch.Int4WeightOnlyConfig(group_size=32))


def test_generate_use_flash_goes_through_k8(dev):
    cfg, qparams = _small_int4_model(dev)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), device=dev, dtype=torch.int32)
    counters = (k1.int4_wo_magic, k2.decode_attention, k8.flash_attention,
                k9.paged_decode_attention)
    for c in counters:
        c.launches = 0
    # Sq = 8 rows against the cache's 128: the flash route (top-left causal)
    toks = ao_tpu_torch.generate(qparams, prompt, cfg, num_steps=5, max_seq=128, use_flash=True)
    torch.cuda.synchronize()
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    assert [c.launches for c in counters] == [(7 * cfg.n_layers + 1) * 5, cfg.n_layers * 4,
                                              cfg.n_layers, 0]


@pytest.mark.parametrize("kv_quant,paged", [
    ("int8", False), ("float8_e4m3fn", False), ("int4", False), ("float8_e5m2", False),
    ("int8", True), ("float8_e4m3fn", True), ("int4", True)])
def test_engine_kv_quant_goes_through_its_kernels(dev, kv_quant, paged):
    """The quantized KV engine's schedule: K8 per bucketed prefill (over the
    quantized scratch's values in slots, the bf16 scratch in pages), K1 per
    forward, and per decode step and layer K5 / K6 / K7 / K2v (slots) or K9
    "vec8" / "int4" (pages)."""
    cfg, qparams = _small_int4_model(dev)
    layout = dict(kv_layout="paged", page_size=128) if paged else {}
    eng = ao_tpu_torch.Engine(qparams, cfg, ao_tpu_torch.ServeConfig(
        max_batch=2, max_seq=256, prefill_buckets=(128,), kv_quant=kv_quant, **layout))
    gen = torch.Generator().manual_seed(1)
    for n in (10, 20, 200):
        eng.submit(torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist(), 4)
    counters = {"k1": k1.int4_wo_magic, "k8": k8.flash_attention,
                "k5": k2.decode_attention_int8, "k6": k2.decode_attention_fp8,
                "k7": k2.decode_attention_int4, "k2v": k2.decode_attention_vec8,
                "k2": k2.decode_attention, "k9": k9.paged_decode_attention,
                "k9v": k9.paged_decode_attention_vec8, "k9i": k9.paged_decode_attention_int4}
    for c in counters.values():
        c.launches = 0
    done = eng.run()
    torch.cuda.synchronize()
    steps = eng.stats()["steps"]
    assert [len(r.generated) for r in done] == [4, 4, 4]
    decode = {"int8": "k9v", "float8_e4m3fn": "k9v", "int4": "k9i"}[kv_quant] if paged else \
        {"int8": "k5", "float8_e4m3fn": "k6", "int4": "k7", "float8_e5m2": "k2v"}[kv_quant]
    want = {name: 0 for name in counters}
    want.update(k1=(7 * cfg.n_layers + 1) * (2 + 2 + steps), k8=cfg.n_layers * 2)
    want[decode] = cfg.n_layers * steps
    assert {name: c.launches for name, c in counters.items()} == want


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_engine_goes_through_its_kernels(dev, paged):
    cfg, qparams = _small_int4_model(dev)
    layout = dict(kv_layout="paged", page_size=128) if paged else {}
    eng = ao_tpu_torch.Engine(qparams, cfg, ao_tpu_torch.ServeConfig(
        max_batch=2, max_seq=256, prefill_buckets=(128,), **layout))
    gen = torch.Generator().manual_seed(1)
    # two bucketed prefills and one of 200 tokens in two chunks of 128; more
    # requests than slots
    for n in (10, 20, 200):
        eng.submit(torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist(), 4)
    counters = (k1.int4_wo_magic, k2.decode_attention, k8.flash_attention,
                k9.paged_decode_attention)
    for c in counters:
        c.launches = 0
    done = eng.run()
    torch.cuda.synchronize()
    steps = eng.stats()["steps"]
    assert [len(r.generated) for r in done] == [4, 4, 4]
    decode = cfg.n_layers * steps
    assert [c.launches for c in counters] == [(7 * cfg.n_layers + 1) * (2 + 2 + steps),
                                              0 if paged else decode, cfg.n_layers * 2,
                                              decode if paged else 0]


def test_event_timing_agrees_with_the_profiler(dev):
    """The CUDA-event timing that ``cuda_time_ms`` falls back to when the
    profiler's records come back incomplete measures what the profiler does:
    one 4096^3 bf16 matmul (about 0.1 ms) within a factor of 1.5."""
    from ao_tpu_torch.utils import timing

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((4096, 4096), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((4096, 4096), generator=gen, device=dev).to(torch.bfloat16)
    prof_ms = timing.cuda_time_ms(lambda: a @ b, iters=10)
    scratch = torch.zeros(timing.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    event_ms = timing._event_ms(lambda: a @ b, scratch, 10)
    assert 0 < prof_ms and 0 < event_ms
    assert prof_ms / 1.5 < event_ms < prof_ms * 1.5


# ---------------------------------------------------------------------------
# K10 and K17: int8 and fp8 weights


def _int8_weight(dev, k, n, seed):
    from ao_tpu_torch.quantization.qarrays.int8 import Int8Array

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    return Int8Array.from_hp(w, (k, 1)), gen


# K10 at the decode kernel's and the mainloop's edges: (M, K, N)
INT8_CASES = [
    (1, 256, 128),
    (8, 4096, 1024),    # split K over 32 units
    (8, 512, 384),
    (13, 1024, 256),    # two n8 tiles of batch rows, a ragged edge
    (17, 512, 256),     # the mainloop, one ragged 64-row tile, K split in stages
    (200, 1024, 512),
    (1024, 1024, 384),  # prefill-sized M
    (100, 1024, 384),   # a ragged 128-row tile, N = 384
    (40, 128, 256),     # K = 128: two stages
    (100, 14336, 256),  # K = 14336: the ring's slots reused 45 times
    (1024, 4096, 1024),  # Llama-3-8B's wk / wv at generate's prefill: K split in 4
    (1024, 4096, 4096),  # its wq / wo
]
# every mainloop tile, unsplit and in three splits, at one shape: (M, K, N)
INT8_TILE_CASE = (200, 1024, 384)


@pytest.mark.parametrize("m,k,n", INT8_CASES)
def test_int8_wo_matmul_matches_plain(dev, m, k, n):
    qa, gen = _int8_weight(dev, k, n, seed=m * 7 + n)
    assert qa.qdata.stride() == (1, k)  # stored column-major
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    before = k10.int8_wo_matmul.launches
    got = k10.int8_wo_matmul(x, qa.qdata, qa.scale)
    torch.cuda.synchronize()
    assert k10.int8_wo_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    ref = k10.int8_wo_matmul_plain(x, qa.qdata, qa.scale)
    # exact products, f32 sums in another order, bf16 out: the JAX suite's
    # bound for the int8 kernel
    sqnr = float(compute_error(ref, got))
    assert sqnr >= 45, f"K10 vs plain: {sqnr:.2f} dB"


def test_int8_wo_matmul_every_tile(dev):
    m, k, n = INT8_TILE_CASE
    qa, gen = _int8_weight(dev, k, n, seed=5)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    ref = k10.int8_wo_matmul_plain(x, qa.qdata, qa.scale)
    for bm, bn in k10.MAINLOOP_TILES:
        for splits in (1, 3):
            got = k10._launch(x, qa.qdata, qa.scale, tiles=(bm, bn, splits))
            torch.cuda.synchronize()
            sqnr = float(compute_error(ref, got))
            assert sqnr >= 45, f"K10 tiles {(bm, bn, splits)}: {sqnr:.2f} dB"


def test_int8_wo_matmul_refuses_on_the_card(dev):
    qa, _ = _int8_weight(dev, 512, 256, seed=1)
    x = torch.randn((8, 512), device=dev, dtype=torch.bfloat16)
    before = k10.int8_wo_matmul.launches
    with pytest.raises(ValueError, match="multiples of 128"):
        k10.int8_wo_matmul(x[:, :448], qa.qdata[:448], qa.scale)
    with pytest.raises(ValueError, match="column-major"):
        k10.int8_wo_matmul(x, qa.qdata.contiguous(), qa.scale)
    with pytest.raises(ValueError, match="per-column"):
        k10.int8_wo_matmul(x, qa.qdata, qa.scale[:, :128])
    assert k10.int8_wo_matmul.launches == before


def _fp8_block_operands(dev, m, k, n, seed):
    from ao_tpu_torch.ops.act_quant import quantize_activation
    from ao_tpu_torch.quantization.qarrays.float8 import Float8Array

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    qa = Float8Array.from_hp(w, (128, 128))
    x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(torch.bfloat16)
    qx, sx, _ = quantize_activation(x, ActQuantSpec(dtype="float8_e4m3fn",
                                                    granularity="per_group:128"))
    return qx, sx, qa


# K17 at the decode kernel's and the prefill kernel's edges: (M, K, N)
FP8_BLOCK_CASES = [
    (1, 256, 128),
    (8, 4096, 1024),    # split K over 32 k-blocks
    (8, 512, 384),
    (13, 1024, 256),    # two n8 tiles of batch rows
    (17, 512, 256),     # the prefill kernel, a ragged 128-row tile, BN 64, K split
    (100, 1024, 512),
    (1024, 512, 256),   # prefill-sized M
    (17, 512, 384),     # N = 384
    (200, 1024, 384),   # a ragged second row tile
    (40, 128, 256),     # K = 128: one k-block, one stage
    (300, 14336, 256),  # K = 14336: 112 k-blocks through the ring's slots
    (1024, 4096, 1024),  # Llama-3-8B's wk / wv at generate's prefill (BN 64)
    (1024, 4096, 4096),  # its wq / wo
]
# every prefill tile, unsplit and in three splits, at one shape: (M, K, N)
FP8_BLOCK_TILE_CASE = (200, 1024, 384)


@pytest.mark.parametrize("m,k,n", FP8_BLOCK_CASES)
def test_fp8_blockwise_matches_plain(dev, m, k, n):
    qx, sx, qa = _fp8_block_operands(dev, m, k, n, seed=m * 3 + n)
    assert qa.qdata.stride() == (1, k) and sx.shape == (m, k // 128)
    before = k17.fp8_blockwise_matmul.launches
    got = k17.fp8_blockwise_matmul(qx, sx, qa.qdata, qa.scale)
    torch.cuda.synchronize()
    assert k17.fp8_blockwise_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    ref = k17.fp8_blockwise_matmul_plain(qx, sx, qa.qdata, qa.scale)
    # exact fp8 products and the same per-block promotion; f32 sums in
    # another order, bf16 out (the JAX suite's bound is > 30 dB)
    sqnr = float(compute_error(ref, got))
    assert sqnr > 30, f"K17 vs plain: {sqnr:.2f} dB"


def test_fp8_blockwise_every_tile(dev):
    m, k, n = FP8_BLOCK_TILE_CASE
    qx, sx, qa = _fp8_block_operands(dev, m, k, n, seed=6)
    ref = k17.fp8_blockwise_matmul_plain(qx, sx, qa.qdata, qa.scale)
    for bn in k17.PREFILL_BN:
        for splits in (1, 3):
            got = k17._launch(qx, sx, qa.qdata, qa.scale, tiles=(k17.PREFILL_BM, bn, splits))
            torch.cuda.synchronize()
            sqnr = float(compute_error(ref, got))
            assert sqnr > 30, f"K17 tiles {(k17.PREFILL_BM, bn, splits)}: {sqnr:.2f} dB"


def test_fp8_blockwise_raises_when_no_tensor_map(dev, monkeypatch):
    """A tensor map libcuda refuses (here: qx's rows 16-byte aligned,
    its base not) makes the C function return minus the CUresult before any
    launch, and the wrapper raise; nothing falls back."""
    import ctypes

    qx, sx, qa = _fp8_block_operands(dev, 64, 256, 128, seed=7)
    buf = torch.zeros(qx.numel() + 16, dtype=torch.uint8, device=dev)
    out = torch.empty((64, 128), dtype=torch.bfloat16, device=dev)
    wt = qa.qdata.t()
    err = k17._lib().ao_fp8_blockwise(buf.data_ptr() + 1, sx.data_ptr(), wt.data_ptr(),
                                      qa.scale.data_ptr(), out.data_ptr(), None, 64, 256, 128,
                                      128, 128, 1, 2, ctypes.c_void_p(0))
    assert err < 0

    class Refusing:
        @staticmethod
        def ao_fp8_blockwise(*args):
            return -1

    monkeypatch.setattr(k17, "_lib", lambda: Refusing)
    before = k17.fp8_blockwise_matmul.launches
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
        k17.fp8_blockwise_matmul(qx, sx, qa.qdata, qa.scale)
    assert k17.fp8_blockwise_matmul.launches == before


def test_fp8_blockwise_refuses_on_the_card(dev):
    qx, sx, qa = _fp8_block_operands(dev, 8, 512, 256, seed=2)
    before = k17.fp8_blockwise_matmul.launches
    with pytest.raises(ValueError, match="e4m3"):
        k17.fp8_blockwise_matmul(qx.view(torch.float8_e5m2), sx, qa.qdata, qa.scale)
    with pytest.raises(ValueError, match="sw"):
        k17.fp8_blockwise_matmul(qx, sx, qa.qdata, qa.scale[:, :1])
    with pytest.raises(ValueError, match="column-major"):
        k17.fp8_blockwise_matmul(qx, sx, qa.qdata.contiguous(), qa.scale)
    assert k17.fp8_blockwise_matmul.launches == before


@pytest.mark.parametrize("m", [8, 40])
def test_scaled_mm_rowwise_and_int_mm_at_decode(dev, m):
    """The library GEMMs of the W8A8 and fp8 rowwise routes at decode (M = 8)
    and above: torch._scaled_mm with per-token and per-column scales over
    the column-major weight, and torch._int_mm with zero rows padded below
    M = 17, each equal to the same route on the CPU up to bf16 rounding
    (int8: exactly)."""
    from ao_tpu_torch.ops.act_quant import quantize_activation
    from ao_tpu_torch.quantization.qarrays.float8 import Float8Array

    gen = torch.Generator(device=dev).manual_seed(m)
    k, n = 512, 384
    w = torch.randn((k, n), generator=gen, device=dev) * 0.05
    x = torch.randn((m, k), generator=gen, device=dev)
    qa = Float8Array.from_hp(w, (k, 1))
    qx, sx, _ = quantize_activation(x, ActQuantSpec(dtype="float8_e4m3fn"))
    got = kernels.fp8_dynamic_matmul(qx, sx, qa.qdata, qa.scale, qa.block_size)
    ref = kernels.fp8_dynamic_matmul(qx.cpu(), sx.cpu(), qa.qdata.cpu(), qa.scale.cpu(),
                                     qa.block_size)
    assert got.dtype == torch.bfloat16 and float(compute_error(ref, got.cpu())) >= 45
    q8 = ao_tpu_torch.quantize_({"w1": w}, ao_tpu_torch.Int8DynamicActivationInt8WeightConfig())
    q8 = q8["w1"]
    xq, sx8, _ = quantize_activation(x, q8.act_quant)
    got = kernels.int8_dynamic_matmul(xq, sx8, None, q8.qdata, q8.scale, None, q8.block_size,
                                      out_dtype=torch.float32)
    ref = kernels.int8_dynamic_matmul(xq.cpu(), sx8.cpu(), None, q8.qdata.cpu(),
                                      q8.scale.cpu(), None, q8.block_size,
                                      out_dtype=torch.float32)
    assert torch.equal(got.cpu(), ref)


INT8_FP8_CONFIGS = {
    "int8-WO": lambda: ao_tpu_torch.Int8WeightOnlyConfig(),
    "W8A8": lambda: ao_tpu_torch.Int8DynamicActivationInt8WeightConfig(),
    "fp8-row": lambda: ao_tpu_torch.Float8DynamicActivationFloat8WeightConfig(),
    "fp8-block": lambda: ao_tpu_torch.Float8DynamicActivationFloat8WeightConfig(
        granularity=ao_tpu_torch.PerBlock((128, 128))),
}


@pytest.mark.parametrize("name", list(INT8_FP8_CONFIGS))
def test_generate_int8_fp8_go_through_their_kernels(dev, name):
    """int8-WO: K10 on every linear of every forward (M <= 1024); W8A8: the
    library int8 GEMM, K12s for each prefill SwiGLU gate; fp8 rowwise: the
    library fp8 GEMM; fp8 blockwise: K17 on every linear. K2 at every
    decode step; the "torch" backend's tokens on the same weights."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=1024, tie_embeddings=False)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    qparams = ao_tpu_torch.quantize_(params, INT8_FP8_CONFIGS[name]())
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), device=dev, dtype=torch.int32)
    counters = {"k10": k10.int8_wo_matmul, "k17": k17.fp8_blockwise_matmul,
                "k12": k12.silu_mul_quant, "k2": k2.decode_attention, "k1": k1.int4_wo_magic}
    for c in counters.values():
        c.launches = 0
    toks = ao_tpu_torch.generate(qparams, prompt, cfg, num_steps=5, max_seq=16)
    torch.cuda.synchronize()
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    n_lin = 7 * cfg.n_layers + 1
    want = dict(k10=0, k17=0, k12=0, k2=cfg.n_layers * 4, k1=0)
    want.update({"int8-WO": dict(k10=n_lin * 5), "W8A8": dict(k12=cfg.n_layers),
                 "fp8-row": {}, "fp8-block": dict(k17=n_lin * 5)}[name])
    assert {key: c.launches for key, c in counters.items()} == want
    logits, _ = llama.forward(qparams, prompt, cfg)
    with kernels.backend("torch"):
        plain, _ = llama.forward(qparams, prompt, cfg)
    # bf16-level route differences; past an activation quantizer (W8A8, fp8)
    # they turn into whole steps, so the bound there is chip_smoke.py's
    # floor for such routes
    need = 30 if name == "int8-WO" else 20
    assert float(compute_error(plain, logits)) >= need


# ---------------------------------------------------------------------------
# F1: attention shapes outside the kernels take the einsum and gather paths

F1_CONFIGS = {
    "head_dim256": dict(n_heads=4, n_kv_heads=2, qk_head_dim=256),
    "group16": dict(n_heads=16, n_kv_heads=1, qk_head_dim=128),
}


@pytest.mark.parametrize("name", list(F1_CONFIGS))
def test_f1_shapes_outside_the_kernels_decode_like_torch(dev, name):
    """A head_dim 256 model and one with 16 query heads per kv head decode on
    the card through generate (bf16 and int8 KV) and a paged decode step,
    with no decode attention kernel launched, and match the "torch" backend:
    equal greedy tokens, and paged-step logits at >= 30 dB. A flash-route
    prefill takes K8 for the 16-head group (K8 takes any group) and the
    einsum path for head_dim 256, at >= 30 dB."""
    from ao_tpu_torch.serving.paged import PagedKVPool

    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, ffn_dim=1024,
                            tie_embeddings=False, **F1_CONFIGS[name])
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), device=dev, dtype=torch.int32)
    attn = (k2.decode_attention, k2.decode_attention_int8, k9.paged_decode_attention,
            k8.flash_attention)
    for c in attn:
        c.launches = 0
    for kv in (None, "int8"):
        got = ao_tpu_torch.generate(params, prompt, cfg, num_steps=6, max_seq=32, kv_quant=kv)
        with kernels.backend("torch"):
            want = ao_tpu_torch.generate(params, prompt, cfg, num_steps=6, max_seq=32,
                                         kv_quant=kv)
        assert torch.equal(got, want), f"{name}, {kv or 'bf16'} KV"

    def paged_step():
        pools = [tuple(PagedKVPool.create(5, 16, cfg.n_kv_heads, cfg.head_dim, "bf16",
                                          device=dev) for _ in range(2))
                 for _ in range(cfg.n_layers)]
        table = torch.tensor([[1, 3], [2, 4]], dtype=torch.int32, device=dev)
        for i in range(2):
            scratch = llama.init_kv_caches(cfg, 1, 32, device=dev)
            llama.forward(params, prompt[i:i + 1], cfg, kv_caches=scratch, cache_index=0)
            for (kp, vp), (sk, sv) in zip(pools, scratch):
                kp.write_prompt(sk[0, :32], table[i])
                vp.write_prompt(sv[0, :32], table[i])
        lens = torch.full((2,), 16, dtype=torch.int32, device=dev)
        logits, _ = llama.forward(params, prompt[:, -1:], cfg, positions=lens[:, None],
                                  kv_caches=pools, cache_index=(table, lens))
        return logits

    got = paged_step()
    with kernels.backend("torch"):
        want = paged_step()
    assert float(compute_error(want, got)) >= 30
    assert [c.launches for c in attn] == [0, 0, 0, 0]

    def flash_prefill():
        caches = llama.init_kv_caches(cfg, 2, 128, device=dev)
        return llama.forward(params, prompt, cfg, kv_caches=caches, cache_index=0,
                             use_flash=True)[0]

    got = flash_prefill()
    with kernels.backend("torch"):
        want = flash_prefill()
    assert float(compute_error(want, got)) >= 30
    assert k8.flash_attention.launches == (cfg.n_layers if name == "group16" else 0)


# ---------------------------------------------------------------------------
# K14 (MXFP4, NVFP4) and K15 (16-entry LUT) weight-only matmuls

FP4_SHAPES = [
    (1, 256, 128),
    (8, 4096, 1024),    # split K over 16 units
    (8, 512, 384),
    (13, 1024, 256),    # two n8 tiles of batch rows, a ragged edge
    (17, 512, 256),     # the tile kernel, a ragged 64-row block
    (100, 1024, 512),
    (1024, 1024, 384),  # prefill-sized M
]
# the mainloop's tile edges: ragged 64- and 128-row tiles against one to 24
# column tiles, a K of one 256-row unit, and the K split at M = 1024
FP4_SHAPES += [(m, 512, n) for m in (17, 100, 788, 1024) for n in (128, 384, 1024, 3072)]
FP4_SHAPES += [(100, 256, 384), (1024, 4096, 1024)]


def _fp4_weight(dev, kind, k, n, seed):
    """A random bf16 weight with two columns of zeros (all-zero blocks) and
    one column 3e-5 of the rest (for NVFP4: subnormal e4m3 block scales)."""
    from ao_tpu_torch.quantization.qarrays.mx import MXArray
    from ao_tpu_torch.quantization.qarrays.nvfp4 import NVFP4Array

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((k, n), generator=gen, device=dev) * 0.05
    w[:, 3] = 0.0
    w[:, n - 1] = 0.0
    w[:, 5] *= 3e-5
    w = w.to(torch.bfloat16)
    qa = (MXArray.from_hp(w, elem_dtype="float4_e2m1fn") if kind == "mx"
          else NVFP4Array.from_hp(w))
    assert qa.layout == "magic"
    return qa, gen


def _fp4_call(k14, kind, x, qa, plain=False):
    if kind == "mx":
        fn = k14.mxfp4_wo_matmul_plain if plain else k14.mxfp4_wo_matmul
        return fn(x, qa.qdata, qa.scale)
    fn = k14.nvfp4_wo_matmul_plain if plain else k14.nvfp4_wo_matmul
    return fn(x, qa.qdata, qa.scale, qa.per_tensor_scale)


@pytest.mark.parametrize("kind", ["mx", "nv"])
@pytest.mark.parametrize("m,k,n", FP4_SHAPES)
def test_fp4_wo_matmul_matches_plain(dev, kind, m, k, n):
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14

    qa, gen = _fp4_weight(dev, kind, k, n, seed=m * 5 + n)
    if kind == "nv":
        sub = qa.block_scale_e4m3()[:, 5].view(torch.uint8)
        subnormal = ((sub & 0x78) == 0) & ((sub & 0x07) != 0)
        assert float(subnormal.float().mean()) > 0.5, "column 5 should have subnormal scales"
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    counter = k14.mxfp4_wo_matmul if kind == "mx" else k14.nvfp4_wo_matmul
    before = counter.launches
    got = _fp4_call(k14, kind, x, qa)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    ref = _fp4_call(k14, kind, x, qa, plain=True)
    # the same exact bf16 weights, f32 sums in another order, one bf16
    # rounding (NVFP4: two, around the per-tensor scale): the JAX suite's
    # bounds, MXFP4 > 60 dB, NVFP4 > 35 dB
    need = 60 if kind == "mx" else 35
    sqnr = float(compute_error(ref, got))
    assert sqnr > need, f"K14 {kind} vs plain: {sqnr:.2f} dB"
    # zero blocks give exact zeros, not the denormal residue of the TPU's
    # zero-code construction
    assert bool((got[:, 3] == 0).all()) and bool((got[:, n - 1] == 0).all())
    # the column of subnormal scales on its own (NVFP4) or tiny powers of two
    # (MX): decoded exactly, it agrees with the plain version
    col = float(compute_error(ref[:, 5].float(), got[:, 5].float()))
    assert col > need, f"K14 {kind} column 5 vs plain: {col:.2f} dB"


@pytest.mark.parametrize("kind", ["mx", "nv"])
@pytest.mark.parametrize("m,k,n", [shape for shape in FP4_SHAPES if shape[0] <= 16])
def test_fp4_wo_matmul_every_decode_plan(dev, kind, m, k, n):
    """K14's decode form at every plan of ``gemv_candidates`` (warps along N
    and K, cluster, stages), against the plain version at the card's bounds,
    zero blocks exact; a plan it does not take is refused before the
    launch."""
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14

    qa, gen = _fp4_weight(dev, kind, k, n, seed=m * 3 + k + n)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    ref = _fp4_call(k14, kind, x, qa, plain=True)
    code = k14.MX if kind == "mx" else k14.NV
    pts = None if kind == "mx" else qa.per_tensor_scale.to(torch.float32).reshape(())
    need = 60 if kind == "mx" else 35
    plans = k14.gemv_candidates(m, k, n, code, stages=(2, 3, 5))
    assert len(plans) >= 3
    for plan in plans:
        got = k14._launch(code, x, qa.qdata, qa.scale, pts, "fp4", plan=plan)
        torch.cuda.synchronize()
        assert float(compute_error(ref, got)) > need, plan
        assert bool((got[:, 3] == 0).all()) and bool((got[:, n - 1] == 0).all()), plan
    with pytest.raises(ValueError, match="not the decode form's"):
        k14._launch(code, x, qa.qdata, qa.scale, pts, "fp4", plan=(3, 1, 1, 3))


@pytest.mark.parametrize("kind", ["mx", "nv"])
@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("k,n", GEMV_KN)
def test_fp4_wo_matmul_decode_form_at_llama_widths(dev, kind, m, k, n):
    """K14's decode form at every decode width of the MXFP4-WO and NVFP4-WO
    paths: one device kernel a call, no workspace, against the plain
    version."""
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14

    qa, gen = _fp4_weight(dev, kind, k, n, seed=m + k + n)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    ref = _fp4_call(k14, kind, x, qa, plain=True)

    def run():
        return _fp4_call(k14, kind, x, qa)

    got = run()
    torch.cuda.synchronize()
    assert float(compute_error(ref, got)) > (60 if kind == "mx" else 35)
    assert _allocations(run) == 1  # the output: no f32 workspace
    assert _device_kernels(run) == 1


@pytest.mark.parametrize("kind", ["mx", "nv"])
@pytest.mark.parametrize("m", [8, 256, 1, 16], ids=["decode", "mainloop", "decode1", "decode16"])
def test_fp4_decode_every_code_and_scale_byte(dev, kind, m):
    """Column n of a (256, 256) weight has scale byte n in every block, its
    rows cycle through all 16 codes, and x is the identity's first m rows:
    out[r, n] is the decoded weight at (r, n), exactly, bf16 subnormals
    (MX bytes 0 and 1) included. A column with a weight that decodes to inf
    or NaN (MX bytes 253-255, NV 0x7F and 0xFF) is NaN (0 x inf in the
    sums)."""
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14
    from ao_tpu_torch.quantization.qarrays.fp4 import (
        decode_fp4_e2m1, pack_fp4_magic, pack_nvfp4_scale_pairs)
    from ao_tpu_torch.quantization.qarrays.mx import e8m0_decode

    k = n = 256
    codes = ((torch.arange(k)[:, None] * 7 + torch.arange(n)[None, :]) % 16).to(torch.uint8)
    word = pack_fp4_magic(codes).to(dev)
    byte = torch.arange(n, dtype=torch.uint8)
    x = torch.eye(k, dtype=torch.bfloat16, device=dev)[:m].contiguous()
    if kind == "mx":
        scale = byte[None, :].expand(k // 32, n).contiguous().to(dev)
        got = k14.mxfp4_wo_matmul(x, word, scale)
        s = e8m0_decode(byte)
    else:
        e4m3 = byte[None, :].expand(k // 16, n).contiguous().view(torch.float8_e4m3fn)
        scale = pack_nvfp4_scale_pairs(e4m3).to(dev)
        got = k14.nvfp4_wo_matmul(x, word, scale)
        s = byte.view(torch.float8_e4m3fn).to(torch.float32)
    torch.cuda.synchronize()
    want = (decode_fp4_e2m1(codes) * s[None, :]).to(torch.bfloat16).to(dev)
    nan_cols = ~torch.isfinite(want).all(dim=0)
    want = want[:m]
    assert bool(got[:, nan_cols].isnan().all())
    assert torch.equal(got[:, ~nan_cols], want[:, ~nan_cols])


def test_fp4_wo_matmul_refuses_on_the_card(dev):
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14

    qa, _ = _fp4_weight(dev, "mx", 512, 256, seed=3)
    x = torch.randn((8, 512), device=dev, dtype=torch.bfloat16)
    before = k14.mxfp4_wo_matmul.launches
    with pytest.raises(ValueError, match="multiple of 256"):
        k14.mxfp4_wo_matmul(x[:, :384], qa.qdata[:48], qa.scale[:12])
    with pytest.raises(ValueError, match="scales"):
        k14.mxfp4_wo_matmul(x, qa.qdata, qa.scale.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        k14.mxfp4_wo_matmul(x, qa.qdata.t().contiguous().t(), qa.scale)
    assert k14.mxfp4_wo_matmul.launches == before


def _lut4_operands(dev, k, n, g, n_luts, seed):
    from ao_tpu_torch.quantization.qarrays.int4 import pack_int4_magic

    gen = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, 16, (k, n), generator=gen, device=dev, dtype=torch.int32)
    codes[:, 2] = 7  # the NF4 codebook's 0.0: an exact zero column
    word = pack_int4_magic(codes.to(torch.uint8), g)
    scalers = torch.rand((k // g, n), generator=gen, device=dev) * 0.1 + 0.01
    if n_luts == 0:
        from ao_tpu_torch.quantization.qarrays.nf4 import NF4_CODEBOOK

        cb = NF4_CODEBOOK.to(dev)
    else:
        cb = torch.randn((n_luts, 16), generator=gen, device=dev)
        cb[:, 7] = 0.0
    return word, scalers, cb, gen


# K15 at the decode kernel's and the mainloop's edges: (M, K, N, g)
LUT4_CASES = [
    (1, 256, 128, 64),
    (8, 4096, 1024, 64),    # split K over 16 super-groups
    (8, 1024, 1056, 64),    # N a multiple of 32, not of 128
    (13, 1024, 256, 32),
    (17, 512, 256, 64),     # the mainloop's smallest M
    (100, 1024, 800, 64),   # N % 64 == 32: a ragged last tile of columns
    (128, 2048, 1056, 128),  # K split in units, ragged N, a group over two stages
    (200, 1024, 512, 128),
    (513, 1536, 256, 32),   # g = 32: two groups a stage
    (1024, 1024, 384, 16),  # prefill-sized M, g = 16: four groups a stage
    (1024, 4096, 1024, 64),  # K split at prefill-sized M
]


@pytest.mark.parametrize("n_luts", [0, 4], ids=["shared", "per-row-block"])
@pytest.mark.parametrize("m,k,n,g", LUT4_CASES)
def test_lut4_wo_magic_matches_plain(dev, n_luts, m, k, n, g):
    from ao_tpu_torch.ops.hopper import lut4_matmul as k15

    word, scalers, cb, gen = _lut4_operands(dev, k, n, g, n_luts, seed=m * 3 + n + g)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    before = k15.lut4_wo_magic.launches
    got = k15.lut4_wo_magic(x, word, scalers, cb, g)
    torch.cuda.synchronize()
    assert k15.lut4_wo_magic.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    ref = k15.lut4_wo_magic_plain(x, word, scalers, cb, g)
    # the bf16 codebook entries exactly, f32 sums in another order, bf16
    # out: the JAX suite's bound for NF4 is > 40 dB
    sqnr = float(compute_error(ref, got))
    assert sqnr > 40, f"K15 vs plain: {sqnr:.2f} dB"
    assert bool((got[:, 2] == 0).all())


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("k,n", GEMV_KN)
def test_lut4_wo_magic_decode_form_at_llama_widths(dev, m, k, n):
    """K15's decode form at every decode width of the NF4-WO path (block
    64, the shared NF4 codebook), against the plain version."""
    from ao_tpu_torch.ops.hopper import lut4_matmul as k15

    word, scalers, cb, gen = _lut4_operands(dev, k, n, 64, 0, seed=m + k + n)
    cb = cb.to(torch.bfloat16)  # as the NF4 linear passes it: the call is the kernel alone
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    ref = k15.lut4_wo_magic_plain(x, word, scalers, cb, 64)

    def run():
        return k15.lut4_wo_magic(x, word, scalers, cb, 64)

    got = run()
    torch.cuda.synchronize()
    assert float(compute_error(ref, got)) > 40
    assert bool((got[:, 2] == 0).all())
    assert _device_kernels(run) == 1


@pytest.mark.parametrize("n_luts", [0, 4, 16], ids=["shared", "4-codebooks", "16-codebooks"])
def test_lut4_wo_magic_every_decode_plan(dev, n_luts):
    from ao_tpu_torch.ops.hopper import lut4_matmul as k15

    m, k, n, g = 8, 2048, 512, 64
    word, scalers, cb, gen = _lut4_operands(dev, k, n, g, n_luts, seed=n_luts + 9)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    ref = k15.lut4_wo_magic_plain(x, word, scalers, cb, g)
    lut = cb.to(torch.bfloat16).contiguous()
    assert k15.gemv_tables(n_luts)[0] == (n_luts == 0)  # pair tables: one codebook only
    plans = k1.gemv_candidates(m, k, n, g, k15.gemv_tables(n_luts)[1], stages=(2, 4))
    assert len(plans) >= 9
    for plan in plans:
        got = k15._launch(x, word, scalers, lut, g, plan=plan)
        torch.cuda.synchronize()
        assert float(compute_error(ref, got)) > 40, plan


def test_lut4_wo_magic_refuses_on_the_card(dev):
    from ao_tpu_torch.ops.hopper import lut4_matmul as k15

    word, scalers, cb, _ = _lut4_operands(dev, 512, 256, 64, 0, seed=4)
    x = torch.randn((8, 512), device=dev, dtype=torch.bfloat16)
    before = k15.lut4_wo_magic.launches
    with pytest.raises(ValueError, match="one of"):
        k15.lut4_wo_magic(x, word, scalers, cb, 48)
    with pytest.raises(ValueError, match="codebooks"):
        k15.lut4_wo_magic(x, word, scalers, torch.zeros((3, 16), device=dev), 64)
    with pytest.raises(ValueError, match="scalers"):
        k15.lut4_wo_magic(x, word, scalers[:4], cb, 64)
    assert k15.lut4_wo_magic.launches == before


FP4_NF4_CONFIGS = {
    "MXFP4-WO": (lambda: ao_tpu_torch.MXWeightOnlyConfig(elem_dtype="float4_e2m1fn"), "k14mx"),
    "NVFP4-WO": (lambda: ao_tpu_torch.NVFP4WeightOnlyConfig(), "k14nv"),
    "NVFP4-dyn": (lambda: ao_tpu_torch.NVFP4DynamicActivationNVFP4WeightConfig(), "k14nv"),
    "NF4-WO": (lambda: ao_tpu_torch.NF4WeightOnlyConfig(), "k15"),
}


@pytest.mark.parametrize("name", list(FP4_NF4_CONFIGS))
def test_generate_fp4_nf4_go_through_their_kernels(dev, name):
    """Every linear of every forward (M <= 1024) through K14 or K15, K2 at
    every decode step; the logits near the "torch" backend's on the same
    weights."""
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14
    from ao_tpu_torch.ops.hopper import lut4_matmul as k15

    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=1024, tie_embeddings=False)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    make, kernel = FP4_NF4_CONFIGS[name]
    qparams = ao_tpu_torch.quantize_(params, make())
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), device=dev, dtype=torch.int32)
    counters = {"k14mx": k14.mxfp4_wo_matmul, "k14nv": k14.nvfp4_wo_matmul,
                "k15": k15.lut4_wo_magic, "k2": k2.decode_attention, "k1": k1.int4_wo_magic}
    for c in counters.values():
        c.launches = 0
    toks = ao_tpu_torch.generate(qparams, prompt, cfg, num_steps=5, max_seq=16)
    torch.cuda.synchronize()
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    want = dict(k14mx=0, k14nv=0, k15=0, k2=cfg.n_layers * 4, k1=0)
    want[kernel] = (7 * cfg.n_layers + 1) * 5
    assert {key: c.launches for key, c in counters.items()} == want
    logits, _ = llama.forward(qparams, prompt, cfg)
    with kernels.backend("torch"):
        plain, _ = llama.forward(qparams, prompt, cfg)
        emb = qparams["embed"]
        nudged, _ = llama.forward(dict(qparams, embed=(emb.float() * (1 + 2 ** -8)).to(emb.dtype)),
                                  prompt, cfg)
    # bf16-level route differences; past NVFP4-dyn's fp4 activation
    # quantizer they turn into whole steps, so there the bound is
    # chip_smoke.py's: within 3 dB of the plain route's own floor under a
    # nudge of one bf16 rounding
    need = 30.0
    if name == "NVFP4-dyn":
        need = min(need, float(compute_error(plain, nudged)) - 3.0)
    assert float(compute_error(plain, logits)) >= need


# ---------------------------------------------------------------------------
# The vision slice: K11, K12n, K12g, K16 and the SAM / ViT routes
# ---------------------------------------------------------------------------


HALVES_CASES = [
    (8, 768, 768, 128, "tinygemm"),
    (788, 768, 3072, 128, "tinygemm"),  # ViT-B's w1 at batch 4
    (100, 256, 128, 32, "minmax_int"),  # the f32 (s, b) transport
    (1, 384, 256, 64, "tinygemm"),
    (70, 192, 384, 64, "tinygemm"),     # M across two row blocks, a ragged edge
    (788, 768, 768, 128, "tinygemm"),   # ViT-B's wq / wk / wv / wo at batch 4
    (788, 768, 768, 128, "minmax_int"),
    (100, 512, 384, 32, "tinygemm"),    # two groups a stage
    (100, 512, 384, 32, "minmax_int"),
    (100, 512, 384, 256, "tinygemm"),
    (100, 512, 384, 256, "minmax_int"),
    (13, 96, 128, 32, "tinygemm"),      # a ragged last stage (K/2 = 48 byte rows)
    (40, 576, 128, 96, "tinygemm"),     # runs of 16 byte rows in groups of 48
    (8, 768, 768, 128, "minmax_int"),   # the K split
]
HALVES_TILE_CASES = [(100, 768, 384, 128), (300, 512, 256, 64)]


@pytest.mark.parametrize("m,k,n,g,domain", HALVES_CASES)
def test_int4_wo_halves_matches_plain(dev, m, k, n, g, domain):
    gen = torch.Generator(device=dev).manual_seed(m + n)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    zpd = ZeroPointDomain.FLOAT if domain == "tinygemm" else ZeroPointDomain.INT
    qa = Int4Array.from_hp(w, group_size=g, zero_point_domain=zpd, layout="halves")
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    before = k1.int4_wo_matmul.launches
    got = k1.int4_wo_matmul(x, qa.qdata, qa.scale, qa.zero_point, g, qa.zero_point_domain)
    torch.cuda.synchronize()
    assert k1.int4_wo_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    s, b = k1.affine_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    ref = k1.int4_wo_matmul_plain(x, qa.qdata, s, b, g)
    # the same bf16 weights, f32 sums in another order, bf16 output: the JAX
    # suite's bound for the kernel
    assert float(compute_error(ref, got)) >= 45


@pytest.mark.parametrize("m,k,n,g", HALVES_TILE_CASES)
def test_int4_wo_halves_every_candidate_tile(dev, m, k, n, g):
    gen = torch.Generator(device=dev).manual_seed(m)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    qa = Int4Array.from_hp(w, group_size=g, layout="halves")
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    s, b = k1.affine_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    ref = k1.int4_wo_matmul_plain(x, qa.qdata, s, b, g)
    for tiles in k1.candidate_tiles_halves(m, k, n, g):
        got = k1._launch_halves(x, qa.qdata, qa.scale, qa.zero_point, g, True, tiles)
        torch.cuda.synchronize()
        assert float(compute_error(ref, got)) >= 45, tiles


def test_autotune_int4_stores_a_candidate(dev, tmp_path, monkeypatch):
    from ao_tpu_torch.ops.hopper import autotune

    monkeypatch.setenv("AO_TPU_NATIVE_CACHE", str(tmp_path))
    monkeypatch.setattr(autotune, "_CACHE", None)
    m, k, n, g = HALVES_TILE_CASES[0]
    best, us = autotune.autotune_int4(m, k, n, g, iters=2)
    assert best in k1.candidate_tiles_halves(m, k, n, g) and us > 0
    assert tuple(autotune.lookup_tuned("int4_wo_matmul", m, k, n, g)) == best
    assert k1.pick_tiles_halves(m, k, n, g, 132) == best


def test_int4_wo_halves_refuses_on_the_card(dev):
    qa = Int4Array.from_hp(torch.randn((384, 256), device=dev), group_size=128, layout="halves")
    x = torch.randn((8, 384), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="N % 128"):
        k1.int4_wo_matmul(x, qa.qdata[:, :200], qa.scale[:, :200], qa.zero_point[:, :200], 128,
                          qa.zero_point_domain)
    with pytest.raises(ValueError, match="contiguous"):
        k1.int4_wo_matmul(x, qa.qdata.t().contiguous().t(), qa.scale, qa.zero_point, 128,
                          qa.zero_point_domain)
    # the route asks takes_halves first: the 1000-wide head takes dequantize + matmul
    head = Int4Array.from_hp(torch.randn((768, 1000), device=dev), group_size=128)
    assert head.layout == "halves"
    before = k1.int4_wo_matmul.launches
    y = ao_tpu_torch.linear(torch.randn((4, 768), device=dev, dtype=torch.bfloat16), head)
    assert y.shape == (4, 1000) and k1.int4_wo_matmul.launches == before


def _lsb_ok(got, ref):
    d = (got.int() - ref.int()).abs()
    return int((d > 1).sum()) == 0 and float((d > 0).float().mean()) < 0.01


@pytest.mark.parametrize("shape,dtype,broadcast", [
    ((10, 196, 768), torch.bfloat16, True),   # SAM-B's windowed MLP LN, its affine as a row
    ((2, 1024, 768), torch.bfloat16, False),  # a global layer's rows, a row per batch row
    ((2, 100, 256), torch.float32, False),
    ((3, 45, 1152), torch.bfloat16, True),    # DiT-XL's width: a predicated last chunk a lane
    ((2, 37, 2048), torch.float32, False),    # the widest rows of one warp
    ((2, 29, 3072), torch.bfloat16, True),    # one block a row
])
def test_norm_modulate_quant_matches_plain(dev, shape, dtype, broadcast):
    b, t, d = shape
    gen = torch.Generator(device=dev).manual_seed(t)
    h = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
    rows = 1 if broadcast else b
    shift = (torch.randn((rows, d), generator=gen, device=dev) * 0.1).to(dtype).expand(b, d)
    smod = (torch.randn((rows, d), generator=gen, device=dev) * 0.1).to(dtype).expand(b, d)
    before = k12.norm_modulate_quant.launches
    q, s = k12.norm_modulate_quant(h, shift, smod, 1e-6)
    torch.cuda.synchronize()
    assert k12.norm_modulate_quant.launches == before + 1
    qr, sr = k12.norm_modulate_quant_plain(h, shift, smod, 1e-6)
    assert q.shape == shape and s.shape == (b, t, 1)
    # moments summed in another order: at most 1 LSB on under 1 % of codes
    assert _lsb_ok(q, qr)
    assert float(((s - sr).abs() / sr).max()) <= 1e-5


# K12n's two kernels at each width: one warp a row up to 2048 values, one
# block a row at any width; bf16 / f32 h and modulation, a stride-0 and a
# per-batch modulation, T not a multiple of the 8 rows of a warp kernel's CTA
K12N_FORM_CASES = [(d, hd, md, bc) for d in (768, 1152, 2048, 3072)
                   for hd, md, bc in ((torch.bfloat16, torch.bfloat16, True),
                                      (torch.bfloat16, torch.float32, False),
                                      (torch.float32, torch.bfloat16, False),
                                      (torch.float32, torch.float32, True))]


@pytest.mark.parametrize("d,h_dtype,mod_dtype,broadcast", K12N_FORM_CASES)
def test_norm_modulate_quant_each_form(dev, d, h_dtype, mod_dtype, broadcast):
    """K12n's warp kernel (D <= 2048) and block kernel against the plain
    version: at most 1 LSB on under 1 % of codes, scales within 1e-5, one
    device kernel a call; a modulation row off a 16-byte boundary is copied
    by the wrapper and gives the same bits; a warp launch above 2048 values
    raises."""
    b, t = 3, 45
    gen = torch.Generator(device=dev).manual_seed(d + t)
    h = (torch.randn((b, t, d), generator=gen, device=dev) * 2 + 0.5).to(h_dtype)
    rows = 1 if broadcast else b
    shift, smod = ((torch.randn((rows, d), generator=gen, device=dev) * 0.1).to(mod_dtype)
                   .expand(b, d) for _ in range(2))
    qr, sr = k12.norm_modulate_quant_plain(h, shift, smod, 1e-6)
    forms = ("warp", "block") if d <= k12.NORM_WARP_MAX_D else ("block",)
    for form in forms:
        before = k12.norm_modulate_quant.launches
        q, s = k12._launch_norm(h, shift, smod, 1e-6, form)
        torch.cuda.synchronize()
        assert k12.norm_modulate_quant.launches == before + 1
        assert _lsb_ok(q, qr), form
        assert float(((s - sr).abs() / sr).max()) <= 1e-5, form
        assert _device_kernels(lambda: k12._launch_norm(h, shift, smod, 1e-6, form)) == 1
        # the same rows off a 16-byte boundary: copied, the same bits
        off = [torch.cat([m.new_zeros(1), m.reshape(-1)])[1:].view(b, d) for m in (shift, smod)]
        assert off[0].data_ptr() % 16
        q2, s2 = k12._launch_norm(h, *off, 1e-6, form)
        assert torch.equal(q2, q) and torch.equal(s2, s)
    if d > k12.NORM_WARP_MAX_D:
        with pytest.raises(ValueError, match="no 'warp' kernel"):
            k12._launch_norm(h, shift, smod, 1e-6, "warp")


def _gelu_ok(q, s, qr, sr):
    """K12g against its plain version: codes at most 1 LSB off on under 1 %
    of values, scales within 1e-6 (chip_smoke.py's K12_SCALE_RTOL)."""
    return _lsb_ok(q, qr) and float(((s - sr).abs() / sr).max()) <= 1e-6


@pytest.mark.parametrize("shape,dtype", [
    ((10, 196, 3072), torch.bfloat16),  # SAM-B's windowed MLP
    ((100, 196, 3072), torch.bfloat16),  # all of SAM-B's windowed MLP rows
    ((4, 4096, 3072), torch.bfloat16),   # SAM-B's global MLP rows
    ((2, 1024, 3072), torch.bfloat16),
    ((3, 45, 3072), torch.float32),
    ((3, 50, 128), torch.float32),
    ((2, 33, 5120), torch.bfloat16),     # above the warp kernel: one block a row
])
def test_gelu_quant_matches_plain(dev, shape, dtype):
    """K12g through its wrapper (the form ``gelu_form`` picks) against the
    plain version, one device kernel a call."""
    gen = torch.Generator(device=dev).manual_seed(shape[1])
    y = (torch.randn(shape, generator=gen, device=dev) * 2).to(dtype)
    before = k12.gelu_quant.launches
    q, s = k12.gelu_quant(y)
    torch.cuda.synchronize()
    assert k12.gelu_quant.launches == before + 1
    qr, sr = k12.gelu_quant_plain(y)
    assert _gelu_ok(q, s, qr, sr), k12.gelu_form(shape[-1])
    assert _device_kernels(lambda: k12.gelu_quant(y)) == 1


@pytest.mark.parametrize("d", [128, 384, 768, 1152, 1536, 2944, 3072, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_quant_each_form(dev, d, dtype):
    """K12g's warps kernel (D <= 3072 at 1, 2 and 3 chunks a lane;
    predicated last chunks at 128, 384, 1152 and 2944; 37 rows, so a CTA's
    second row is past the end) and block kernel against the plain version,
    the same codes and scales from both, one device kernel a call; a warps
    launch above 3072 values raises."""
    gen = torch.Generator(device=dev).manual_seed(d)
    y = (torch.randn((1, 37, d), generator=gen, device=dev) * 2 + 0.5).to(dtype)
    qr, sr = k12.gelu_quant_plain(y)
    qb, sb = k12._launch_gelu(y, "block")
    assert _gelu_ok(qb, sb, qr, sr)
    if d <= k12.GELU_WARP_MAX_D:
        q, s = k12._launch_gelu(y, "warps")
        assert torch.equal(q, qb) and torch.equal(s, sb)
        assert _device_kernels(lambda: k12._launch_gelu(y, "warps")) == 1
    else:
        with pytest.raises(ValueError, match="no 'warps' kernel"):
            k12._launch_gelu(y, "warps")


def _bf16_sweep(dev):
    """Every finite bf16 value (65280), in the order of their bit patterns."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return x[torch.isfinite(x.float())].to(dev)


def test_gelu_quant_every_bf16_value(dev):
    """K12g over every finite bf16 input (NaN and +-inf left out): in rows of
    128 values in bit-pattern order (one sign and exponent a row: codes over
    the whole range), through the warps and the block kernel; and each value
    in a row of 3072 of its own, where the row's scale, max(|GELU(x)|, 1e-8)
    / 127, is the kernel's GELU value. The counts of codes and scales that
    differ are printed; codes at most 1 LSB off on under 1 %, scales within
    1e-6."""
    x = _bf16_sweep(dev)
    assert x.numel() == 65280
    for name, y, forms in (("binade rows", x.view(1, 510, 128), ("warps", "block")),
                           ("a row a value", x[None, :, None].expand(1, -1, 3072).contiguous(),
                            ("warps",))):
        qr, sr = k12.gelu_quant_plain(y)
        for form in forms:
            q, s = k12._launch_gelu(y, form)
            torch.cuda.synchronize()
            rel = (s - sr).abs() / sr
            print(f"K12g {form}, {name}: {int((q != qr).sum())} codes differ, "
                  f"{int((rel > 0).sum())} scales differ, the most by {float(rel.max()):.3g}")
            assert _gelu_ok(q, s, qr, sr), (name, form)


def test_producers_refuse_on_the_card(dev):
    h = torch.randn((2, 8, 96), device=dev)
    with pytest.raises(ValueError, match="multiple of 128"):
        k12.gelu_quant(h)
    with pytest.raises(ValueError, match="multiple of 128"):
        k12.norm_modulate_quant(h, h[:, 0], h[:, 0], 1e-6)
    h = torch.randn((2, 8, 128), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        k12.gelu_quant(h.transpose(0, 1).contiguous().transpose(0, 1))


# K16's cases: (G, side, nh, padded rows)
WINDOW_CASES = [
    (10, 14, 12, 0),   # SAM-B's windows
    (4, 14, 12, 40),   # padded windows: their last rows' k and v are those of zeros
    (1, 64, 12, 0),    # a global layer at image 1024 (T = 4096)
    (3, 5, 2, 0),      # T = 25: one ragged key tile, one ragged query tile
    (2, 32, 4, 0),
]


@pytest.mark.parametrize("g,side,nh,pad_rows", WINDOW_CASES)
def test_window_attention_matches_plain(dev, g, side, nh, pad_rows):
    from ao_tpu_torch.ops.hopper import window_attention as k16

    t, hd = side * side, 64
    gen = torch.Generator(device=dev).manual_seed(g * 100 + side)
    q, k, v = (torch.randn((g, t, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    if pad_rows:
        k[:, -pad_rows:] = 0
        v[:, -pad_rows:] = 0
    rh, rw = (torch.randn((g, nh, t, side), generator=gen, device=dev) * 0.3 for _ in range(2))
    before = k16.window_bias_attention.launches
    got = k16.window_bias_attention(q, k, v, rh, rw, side=side, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert k16.window_bias_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (g, t, nh * hd)
    ref = k16.window_bias_attention_plain(q, k, v, rh, rw, side, hd ** -0.5)
    # the JAX suite's bound for the kernel (tests/test_pallas_tpu.py)
    assert float(compute_error(ref.float(), got.float())) >= 35
    nobias = k16.window_bias_attention_plain(q, k, v, 0 * rh, 0 * rw, side, hd ** -0.5)
    assert float(compute_error(nobias.float(), got.float())) < 30  # the bias is applied
    if g > 1 and t % 64:
        # the last key tile runs past T: the tensor maps zero-fill it and
        # never read the next window's keys
        k[1:], v[1:] = float("nan"), float("nan")
        again = k16.window_bias_attention(q, k, v, rh, rw, side=side, scale=hd ** -0.5)
        torch.cuda.synchronize()
        assert torch.isfinite(again[0]).all()
        assert torch.equal(again[0], k16.window_bias_attention(
            q[:1], k[:1], v[:1], rh[:1], rw[:1], side=side, scale=hd ** -0.5)[0])


def test_window_attention_refuses_on_the_card(dev):
    from ao_tpu_torch.ops.hopper import window_attention as k16

    q = torch.zeros((1, 16, 2, 32), device=dev, dtype=torch.bfloat16)
    r = torch.zeros((1, 2, 16, 4), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        k16.window_bias_attention(q, q, q, r, r, side=4, scale=1.0)
    q = torch.zeros((1, 65 * 65, 1, 64), device=dev, dtype=torch.bfloat16)
    r = torch.zeros((1, 1, 65 * 65, 65), device=dev)
    with pytest.raises(ValueError, match="side"):
        k16.window_bias_attention(q, q, q, r, r, side=65, scale=1.0)


def _fill_rel_pos(params, gen, scale=0.3):
    """SAM's init zeroes the rel-pos tables; fill them so that a dropped
    bias shows (the terms come out about ``scale`` large)."""
    for lp in params["layers"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            tab = lp["attn"][key]
            lp["attn"][key] = (torch.randn(tab.shape, generator=gen, device=tab.device)
                               * scale * tab.shape[-1] ** -0.5).to(tab.dtype)
    return params


def test_sam_w8a8_two_layers_go_through_their_kernels(dev):
    """A 2-layer SAM at SAM-B's widths (one windowed, one global layer,
    image 448: 2 x 2 windows of 14 and a 28 x 28 global grid) under W8A8:
    K16 per encoder layer, K12n per MLP and before the global layer's q, k,
    v, K12g per MLP; masks and IoU near the "torch" backend's."""
    import dataclasses

    from ao_tpu_torch.models import sam
    from ao_tpu_torch.ops.hopper import window_attention as k16

    cfg = dataclasses.replace(sam.SAM_B, image_size=448, n_layers=2, global_attn_layers=(1,))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = _fill_rel_pos(sam.init_params(cfg, gen, device=dev), gen)
    qparams = ao_tpu_torch.quantize_(params, ao_tpu_torch.Int8DynamicActivationInt8WeightConfig())
    images = torch.randn((2, 448, 448, 3), generator=gen, device=dev)
    coords = torch.rand((2, 2, 2), generator=gen, device=dev) * 448
    labels = torch.tensor([[1, 0], [1, 1]], dtype=torch.int32, device=dev)
    counters = {"k16": k16.window_bias_attention, "k12n": k12.norm_modulate_quant,
                "k12g": k12.gelu_quant}
    for c in counters.values():
        c.launches = 0
    masks, iou = sam.forward(qparams, images, coords, labels, cfg)
    torch.cuda.synchronize()
    assert {key: c.launches for key, c in counters.items()} == dict(k16=2, k12n=3, k12g=2)
    assert masks.shape == (2, 4, 112, 112) and iou.shape == (2, 4)
    assert bool(torch.isfinite(masks).all()) and bool(torch.isfinite(iou).all())
    with kernels.backend("torch"):
        plain = sam.forward(qparams, images, coords, labels, cfg)
        nudged = sam.forward(qparams, images * (1 + 2 ** -8), coords, labels, cfg)
    for got, want, nud in zip((masks, iou), plain, nudged):
        # past the int8 activation quantizers: within 3 dB of the plain
        # route's own floor under a nudge of one bf16 rounding of the images
        need = min(30.0, float(compute_error(want, nud)) - 3.0)
        assert float(compute_error(want, got)) >= need


def test_vit_int4_two_layers_go_through_their_kernels(dev):
    """A 2-layer ViT-B under int4-WO (group 128): K11 for wq, wk, wv, wo and
    w1 (768 wide: 6 groups, the split-half layout), K1 for w2 (24 groups,
    magic), the 1000-class head dequantized; logits near the "torch"
    backend's."""
    import dataclasses

    from ao_tpu_torch.models import vit

    cfg = dataclasses.replace(vit.VIT_B16, n_layers=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = vit.init_params(cfg, gen, device=dev)
    qparams = ao_tpu_torch.quantize_(params, ao_tpu_torch.Int4WeightOnlyConfig(group_size=128))
    images = torch.randn((2, 224, 224, 3), generator=gen, device=dev)
    k1.int4_wo_matmul.launches = k1.int4_wo_magic.launches = 0
    logits = vit.forward(qparams, images, cfg)
    torch.cuda.synchronize()
    assert (k1.int4_wo_matmul.launches, k1.int4_wo_magic.launches) == (10, 2)
    assert logits.shape == (2, 1000) and logits.dtype == torch.float32
    with kernels.backend("torch"):
        plain = vit.forward(qparams, images, cfg)
    assert float(compute_error(plain, logits)) >= 30


# ---------------------------------------------------------------------------
# K13: the MoE grouped int4 kernels
# ---------------------------------------------------------------------------


def _routing(dev, kind, t, e, gen):
    """Group sizes (E,) int32 summing to T: a top-2 routing of T/2 random
    tokens ("top2"), every row to one expert and the others empty ("one"),
    rows spread with an empty expert in the middle ("gap"), or 12 rows in
    expert 0 and the rest in the last ("twelve": an expert of 9-16 rows at
    decode)."""
    if kind == "top2":
        logits = torch.randn((t // 2, e), generator=gen, device=dev)
        idx = torch.topk(logits, 2, dim=-1).indices.reshape(-1)
        return torch.zeros(e, dtype=torch.int32, device=dev).scatter_add_(
            0, idx, torch.ones_like(idx, dtype=torch.int32))
    gs = torch.zeros(e, dtype=torch.int32, device=dev)
    if kind == "one":
        gs[e // 2] = t
    elif kind == "twelve":
        gs[0], gs[e - 1] = 12, t - 12
    else:
        gs[0], gs[e - 1] = t // 2, t - t // 2
    return gs


def _grouped_weight(dev, e, k, n, g, domain, act_quant, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.randn((e, k, n), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    zpd = ZeroPointDomain.FLOAT if domain == "tinygemm" else ZeroPointDomain.INT
    return Int4Array.from_hp(w, group_size=g, zero_point_domain=zpd, act_quant=act_quant), gen


GROUPED_CASES = [
    (16, 8, 512, 256, 128, "tinygemm", "top2"),   # Mixtral's decode rows: each expert <= 8
    (16, 8, 512, 256, 128, "tinygemm", "one"),    # every row in one expert, the rest empty
    (16, 8, 2048, 128, 128, "tinygemm", "twelve"),  # an expert of 12 rows: two n8 tiles
    (8, 4, 256, 128, 32, "minmax_int", "gap"),    # 8-row tiles, an int zero point
    (256, 8, 1024, 384, 64, "tinygemm", "top2"),  # the engine's 128-token bucket
    (256, 8, 512, 128, 128, "tinygemm", "one"),   # 256 rows of one expert
    (300, 4, 512, 128, 16, "tinygemm", "top2"),   # g = 16, T not a multiple of a row tile
    (1024, 8, 512, 256, 128, "tinygemm", "top2"),  # the engine's 512 bucket: ragged last tiles
    (1024, 8, 1024, 384, 32, "minmax_int", "gap"),
    (1024, 8, 512, 128, 64, "tinygemm", "one"),
    (2048, 8, 512, 256, 128, "tinygemm", "top2"),  # generate's prefill: 128-row tiles
    (2048, 8, 512, 128, 64, "minmax_int", "gap"),
    (2048, 8, 512, 128, 128, "tinygemm", "one"),  # sixteen tiles of one expert
]


@pytest.mark.parametrize("t,e,k,n,g,domain,routing", GROUPED_CASES)
def test_grouped_magic_matches_plain(dev, t, e, k, n, g, domain, routing):
    from ao_tpu_torch.ops.hopper import grouped_matmul as k13

    qa, gen = _grouped_weight(dev, e, k, n, g, domain, None, seed=t + n + g)
    assert qa.layout == "magic"
    x = torch.randn((t, k), generator=gen, device=dev).to(torch.bfloat16)
    gs = _routing(dev, routing, t, e, gen)
    before = k13.int4_grouped_magic.launches
    got = k13.int4_grouped_magic(x, qa.qdata, qa.scale, qa.zero_point, gs, g,
                                 qa.zero_point_domain)
    torch.cuda.synchronize()
    assert k13.int4_grouped_magic.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (t, n)
    s, b2 = k1.transport_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    ref = k13.int4_grouped_magic_plain(x, qa.qdata, s, b2, gs, g)
    assert bool(ref.abs().amax(dim=1).gt(0).all()) and bool(got.abs().amax(dim=1).gt(0).all())
    # K1's arithmetic per expert, f32 sums in another order, bf16 out: the
    # JAX suite's bound for the grouped kernel
    sqnr = float(compute_error(ref, got))
    assert sqnr >= 45, f"K13 magic vs plain: {sqnr:.2f} dB"


@pytest.mark.parametrize("t,e,k,n,g,domain,routing", GROUPED_CASES)
def test_grouped_w4a8_matches_plain(dev, t, e, k, n, g, domain, routing):
    from ao_tpu_torch.ops.act_quant import quantize_activation
    from ao_tpu_torch.ops.hopper import grouped_matmul as k13

    g = max(g, 32)  # K3's compiled group sizes start at 32
    qa, gen = _grouped_weight(dev, e, k, n, g, domain, W4A8_SPEC, seed=t + n + g)
    assert qa.layout == "magic8"
    x = torch.randn((t, k), generator=gen, device=dev).to(torch.bfloat16)
    xq, sx, _ = quantize_activation(x, W4A8_SPEC)
    gs = _routing(dev, routing, t, e, gen)
    before = k13.int4_grouped_w4a8.launches
    got = k13.int4_grouped_w4a8(xq, sx, qa.qdata, qa.scale, qa.zero_point, gs, g,
                                qa.zero_point_domain)
    torch.cuda.synchronize()
    assert k13.int4_grouped_w4a8.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (t, n)
    s, b = k1.w4a8_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    ref = k13.int4_grouped_w4a8_plain(xq, sx, qa.qdata, s, b, gs, g)
    assert bool(ref.abs().amax(dim=1).gt(0).all()) and bool(got.abs().amax(dim=1).gt(0).all())
    # the same int8 activations on both sides: exact integer dots, f32 sums
    # of the groups in another order
    sqnr = float(compute_error(ref, got))
    assert sqnr >= 45, f"K13 w4a8 vs plain: {sqnr:.2f} dB"


def _magic_case(dev, t, e, k, n, g, domain, routing, seed):
    from ao_tpu_torch.ops.hopper import grouped_matmul as k13

    qa, gen = _grouped_weight(dev, e, k, n, g, domain, None, seed=seed)
    x = torch.randn((t, k), generator=gen, device=dev).to(torch.bfloat16)
    gs = _routing(dev, routing, t, e, gen)
    s, b2 = k1.transport_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    return qa, x, gs, s, b2, k13.int4_grouped_magic_plain(x, qa.qdata, s, b2, gs, g)


@pytest.mark.parametrize("t,routing,plan", [
    (16, "top2", None), (16, "twelve", None), (300, "top2", 64), (300, "top2", 128),
    (1024, "gap", 64), (1024, "top2", 128), (2048, "top2", 128), (2048, "top2", 64),
])
def test_grouped_magic_keeps_to_each_experts_rows(dev, t, routing, plan):
    """With every row outside expert e set to +-inf, expert e's rows still
    match the plain version and are finite: no tile of another expert
    stores into them, and no row of another expert reaches them (the row
    tiles zero-fill past an expert's last row, the decode reads only its
    own), at either row tile."""
    from ao_tpu_torch.ops.hopper import grouped_matmul as k13

    qa, x, gs, s, b2, ref = _magic_case(dev, t, 8, 512, 256, 128, "tinygemm", routing, seed=t)
    ends = torch.cumsum(gs, 0).tolist()
    inf = torch.where(torch.arange(x.shape[0], device=dev) % 2 == 0, float("inf"),
                      float("-inf")).to(torch.bfloat16)[:, None].expand_as(x)
    checked = 0
    for e, (hi, n_rows) in enumerate(zip(ends, gs.tolist())):
        if not n_rows:
            continue
        lo = hi - n_rows
        own = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
        own[lo:hi] = True
        poisoned = torch.where(own[:, None], x, inf)
        got = k13._launch_magic(poisoned, qa.qdata, qa.scale, qa.zero_point, gs, 128, True,
                                plan)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got[lo:hi]).all()), f"expert {e}: rows not finite"
        sqnr = float(compute_error(ref[lo:hi], got[lo:hi]))
        assert sqnr >= 45, f"expert {e}: {sqnr:.2f} dB"
        checked += 1
    assert checked >= 2


@pytest.mark.parametrize("t,k,plan", [(16, 2048, (1, 4)), (16, 2048, (2, 2)),
                                      (16, 2048, (4, 1)), (8, 4096, (8, 1)),
                                      (16, 4096, (3, 3))])
def test_grouped_magic_decode_splits_are_repeatable(dev, t, k, plan):
    """The decode kernel at each K split (a cluster of up to 8 CTAs, summed
    in rank order inside the launch): the plain version's function at 45
    dB, with large row sums of x (a mean 8 standard deviations off zero,
    against which the 128 + u offset's f32 cancellation is held), and the
    same bits on a second run."""
    from ao_tpu_torch.ops.hopper import grouped_matmul as k13

    qa, x, gs, s, b2, _ = _magic_case(dev, t, 8, k, 256, 128, "tinygemm", "top2", seed=k + t)
    x = (x.float() + 8.0).to(torch.bfloat16)
    ref = k13.int4_grouped_magic_plain(x, qa.qdata, s, b2, gs, 128)
    got = k13._launch_magic(x, qa.qdata, qa.scale, qa.zero_point, gs, 128, True, plan)
    again = k13._launch_magic(x, qa.qdata, qa.scale, qa.zero_point, gs, 128, True, plan)
    torch.cuda.synchronize()
    assert float(compute_error(ref, got)) >= 45
    assert torch.equal(got, again)


def test_grouped_routes_magic_above_256_rows_and_magic8_not(dev):
    """On CUDA tensors a magic expert stack takes K13 at 320 rows (above the
    reference's gate of 256); a magic8 (W4A8) stack there takes the ragged
    fallback on the unquantized activations, as the reference does."""
    from ao_tpu_torch.moe import grouped_matmul
    from ao_tpu_torch.ops.hopper import grouped_matmul as k13

    t = 320
    assert t > kernels.GROUPED_KERNEL_MAX_T
    for act_quant, counter in ((None, k13.int4_grouped_magic), (W4A8_SPEC, k13.int4_grouped_w4a8)):
        qa, gen = _grouped_weight(dev, 4, 512, 256, 64, "tinygemm", act_quant, seed=7)
        x = torch.randn((t, 512), generator=gen, device=dev).to(torch.bfloat16)
        gs = _routing(dev, "top2", t, 4, gen)
        before = (k13.int4_grouped_magic.launches, k13.int4_grouped_w4a8.launches)
        y = grouped_matmul(x, qa, gs)
        torch.cuda.synchronize()
        after = (k13.int4_grouped_magic.launches, k13.int4_grouped_w4a8.launches)
        want = (before[0] + 1, before[1]) if act_quant is None else before
        assert after == want and y.shape == (t, 256)
        with kernels.backend("torch"):
            ref = grouped_matmul(x, qa, gs)
        assert float(compute_error(ref, y)) >= 35


def test_grouped_refuses_on_the_card(dev):
    from ao_tpu_torch.ops.hopper import grouped_matmul as k13

    qa, gen = _grouped_weight(dev, 2, 256, 96, 32, "tinygemm", None, seed=1)  # N % 128 != 0
    x = torch.randn((4, 256), generator=gen, device=dev).to(torch.bfloat16)
    gs = torch.tensor([2, 2], dtype=torch.int32, device=dev)
    assert not k13.takes(256, 96, 32, "magic")
    with pytest.raises(ValueError, match="does not take"):
        k13.int4_grouped_magic(x, qa.qdata, qa.scale, qa.zero_point, gs, 32,
                               qa.zero_point_domain)
    # the grouped matmul takes the ragged fallback for it instead
    from ao_tpu_torch.moe import grouped_matmul

    before = k13.int4_grouped_magic.launches
    y = grouped_matmul(x, qa, gs)
    assert k13.int4_grouped_magic.launches == before and y.shape == (4, 96)


def _moe_llama(dev, config):
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=4,
                            ffn_dim=1024, tie_embeddings=False, n_experts=4, top_k_experts=2)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    return cfg, ao_tpu_torch.quantize_(params, config)


@pytest.mark.parametrize("name", ["int4-WO", "W4A8"])
def test_moe_generate_goes_through_k13(dev, name):
    """A 2-layer MoE llama (4 experts, top-2) under int4-WO or W4A8: K13 for
    w_gate, w_up and w_down at every decode step (T = 2 x 2 rows) and, for
    int4-WO's magic stacks, at the prefill too (T = 2 x 80 x 2 = 320 > 256:
    the row tiles), where W4A8 takes the ragged fallback; K1 or K3 / K4 for
    the attention linears and the lm_head; the prefill's and one decode
    step's logits near the "torch" backend's."""
    from ao_tpu_torch.moe import layer as moe_layer
    from ao_tpu_torch.ops.hopper import grouped_matmul as k13

    config = (ao_tpu_torch.Int4WeightOnlyConfig(group_size=32) if name == "int4-WO" else
              ao_tpu_torch.Int8DynamicActivationInt4WeightConfig(group_size=32))
    cfg, qparams = _moe_llama(dev, config)
    prompt = torch.randint(0, cfg.vocab_size, (2, 80), device=dev, dtype=torch.int32)
    counters = (k13.int4_grouped_magic, k13.int4_grouped_w4a8, k1.int4_wo_magic,
                k1.int4_w4a8_matmul, k1.int4_magic8_requant_int8, k2.decode_attention)
    for c in counters:
        c.launches = 0
    toks = ao_tpu_torch.generate(qparams, prompt, cfg, num_steps=5, max_seq=96)
    torch.cuda.synchronize()
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    n_lin, n_exp, steps = 4 * cfg.n_layers + 1, 3 * cfg.n_layers, 5
    if name == "int4-WO":
        want = [n_exp * steps, 0, n_lin * steps, 0, 0, cfg.n_layers * (steps - 1)]
    else:  # 160 prefill rows <= 512: K3 at the prefill too
        want = [0, n_exp * (steps - 1), 0, n_lin * steps, 0, cfg.n_layers * (steps - 1)]
    assert [c.launches for c in counters] == want

    def two_steps(p):  # the prefill, then one decode step (K13) over its cache
        caches = llama.init_kv_caches(cfg, 2, 96, device=dev)
        l0, caches = llama.forward(p, prompt, cfg, kv_caches=caches, cache_index=0)
        l1, _ = llama.forward(p, toks[:, :1], cfg,
                              positions=torch.full((2, 1), 80, dtype=torch.int32, device=dev),
                              kv_caches=caches, cache_index=80)
        return l0, l1

    # the router's top-2 is a discrete decision that a bf16-level difference
    # can flip at a near tie, so every run takes the plain route's experts,
    # weighted by its own router probabilities (as chip_smoke.py's RoutePin)
    route, routes = moe_layer.route, []

    def record(x2, w, mcfg):
        out = route(x2, w, mcfg)
        routes.append(out[1])
        return out

    def replay(calls):
        def pinned(x2, w, mcfg):
            topi = next(calls)
            topw = torch.softmax(x2.float() @ w.float(), dim=-1).gather(-1, topi.long())
            return topw / topw.sum(dim=-1, keepdim=True) if mcfg.norm_topk else topw, topi
        return pinned

    emb = qparams["embed"]
    try:
        with kernels.backend("torch"):
            moe_layer.route = record
            plain = two_steps(qparams)
            moe_layer.route = replay(iter(routes))
            nudged = two_steps(dict(qparams, embed=(emb.float() * (1 + 2 ** -8)).to(emb.dtype)))
        moe_layer.route = replay(iter(routes))
        got = two_steps(qparams)
    finally:
        moe_layer.route = route
    for want_logits, nud, logits in zip(plain, nudged, got):
        # W4A8's int8 activation quantizers turn bf16-level route differences
        # into whole steps: there the bound is within 3 dB of the plain
        # route's own floor under a nudge of one bf16 rounding
        need = 30.0
        if name == "W4A8":
            need = min(need, float(compute_error(want_logits, nud)) - 3.0)
        assert bool(torch.isfinite(logits).all())
        assert float(compute_error(want_logits, logits)) >= need


def test_moe_decode_forward_never_syncs(dev):
    """The MoE FFN at a decode shape (8 tokens, top-2) reads nothing on the
    host, with int4 experts (K13) and with bf16 experts (the ragged dot)."""
    from ao_tpu_torch.moe.layer import moe_forward

    cfg, qparams = _moe_llama(dev, ao_tpu_torch.Int4WeightOnlyConfig(group_size=32))
    plain = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    x = torch.randn((8, 1, cfg.dim), device=dev).to(torch.bfloat16)
    mcfg = llama._moe_config(cfg)
    for layer in (qparams["layers"][0]["mlp"], plain["layers"][0]["mlp"]):
        moe_forward(layer, x, mcfg)  # first calls may load the kernel library
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = moe_forward(layer, x, mcfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert y.shape == x.shape and bool(torch.isfinite(y).all())


# ---------------------------------------------------------------------------
# K18: the block-sparse (BSR) matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,b,keep", [
    (3152, 1024, 4096, 64, 0.1),   # ViT-L's w1 at the BSR path's config
    (3152, 4096, 1024, 64, 0.1),   # its w2
    (3152, 1024, 4096, 128, 0.5),
    (64, 1024, 1024, 128, 0.25),   # the JAX suite's shapes
    (1, 512, 640, 128, 0.5),
    (200, 1024, 4096, 64, None),   # every block of a dense weight
    (13, 256, 384, 32, 0.4),       # b = 32, a ragged M tile
    (65, 512, 256, 64, 0.01),      # one live block: the other columns are padding
    (300, 4096, 512, 128, None),   # a column's run of 32 blocks: longer than the ring
])
def test_bsr_matmul_matches_plain(dev, m, k, n, b, keep):
    from ao_tpu_torch.ops.hopper import bsr_matmul as k18
    from ao_tpu_torch.sparsity.blocksparse import BlockSparseArray

    gen = torch.Generator(device=dev).manual_seed(m + n + b)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
    bw = BlockSparseArray.from_hp(w, b, keep)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    before = k18.bsr_matmul.launches
    got = k18.bsr_matmul(x, bw)
    torch.cuda.synchronize()
    assert k18.bsr_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    ref = k18.bsr_matmul_plain(x, bw)
    # both sum the block products in f32 and round once: K1's bound
    assert float(compute_error(ref, got)) >= 45
    # the columns that hold only a padding block come out exactly zero
    dq = bw.dequantize(torch.float32)
    empty = dq.reshape(k, n // b, b).abs().sum((0, 2)) == 0
    assert bool((got.reshape(m, n // b, b)[:, empty] == 0).all())


def _bsr_case(dev, m, k, n, b, keep, seed=0):
    from ao_tpu_torch.sparsity.blocksparse import BlockSparseArray

    gen = torch.Generator(device=dev).manual_seed(m + n + b + seed)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
    return (BlockSparseArray.from_hp(w, b, keep),
            torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16))


@pytest.mark.parametrize("m,k,n,b,keep,picked", [
    (64, 1024, 1024, 128, 0.25, 1),   # the JAX suite's shapes: runs of 2 blocks
    (1, 512, 640, 128, 0.5, 1),
    (64, 4096, 1024, 128, None, 4),   # runs of 32: each rank takes 8
    (1, 4096, 1024, 128, 0.25, 4),
    (16, 2048, 4096, 64, 0.5, 2),     # b = 64 splits in two at most
])
def test_bsr_matmul_split_plans(dev, m, k, n, b, keep, picked):
    """K18 at M = 64, 16 and 1, where the items are fewer than the SMs, at
    each cluster split it takes: >= 45 dB against the plain version, padding
    columns exactly 0, the same bits over three calls; ``launch_plan``
    splits the runs of 8 blocks or more and not those of 2."""
    from ao_tpu_torch.ops.hopper import bsr_matmul as k18

    bw, x = _bsr_case(dev, m, k, n, b, keep)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert k18.launch_plan(m, n, b, bw.nnz_blocks, sms).splits == picked
    ref = k18.bsr_matmul_plain(x, bw)
    empty = bw.dequantize(torch.float32).reshape(k, n // b, b).abs().sum((0, 2)) == 0
    for splits in [s for s in (1, 2, 4) if s <= k18.MAX_SPLIT[b]]:
        plan = k18.launch_plan(m, n, b, bw.nnz_blocks, sms, splits=splits)
        got = _repeats(lambda: k18._launch(x, bw, plan))
        sqnr = float(compute_error(ref, got))
        assert sqnr >= 45, f"{plan}: {sqnr:.2f} dB"
        assert bool((got.reshape(m, n // b, b)[:, empty] == 0).all())


@pytest.mark.parametrize("m,k,n,b,keep", [
    (200, 1024, 512, 64, 0.3), (13, 256, 384, 32, 0.4), (64, 1024, 1024, 128, 0.25)])
def test_bsr_matmul_reads_no_row_past_m(dev, m, k, n, b, keep):
    """x as the first M rows of a larger tensor whose other rows are NaN:
    the output is finite and the same bits as over a copy of x alone."""
    from ao_tpu_torch.ops.hopper import bsr_matmul as k18

    bw, x = _bsr_case(dev, m, k, n, b, keep, seed=1)
    big = torch.full((m + 130, k), float("nan"), dtype=torch.bfloat16, device=dev)
    big[:m] = x
    got = k18.bsr_matmul(big[:m], bw)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, k18.bsr_matmul(x.clone(), bw))


@pytest.mark.parametrize("m,k,n,b,keep", [
    (3152, 1024, 4096, 64, 0.1), (64, 1024, 1024, 128, 0.25), (200, 1024, 4096, 64, None)])
def test_bsr_matmul_one_kernel_same_bits(dev, m, k, n, b, keep):
    """K18 is one device kernel a call (the weight's column runs and tensor
    map built by the first), and two calls give the same bits."""
    from ao_tpu_torch.ops.hopper import bsr_matmul as k18

    bw, x = _bsr_case(dev, m, k, n, b, keep, seed=2)
    _repeats(lambda: k18.bsr_matmul(x, bw), n=2)
    assert _device_kernels(lambda: k18.bsr_matmul(x, bw)) == 1


def test_bsr_matmul_f32_container_and_refusals(dev):
    from ao_tpu_torch.ops.hopper import bsr_matmul as k18
    from ao_tpu_torch.sparsity.blocksparse import BlockSparseArray

    w = torch.randn((256, 256), device=dev)
    x = torch.randn((8, 256), device=dev)
    bw32 = BlockSparseArray.from_hp(w, 64, 0.5, dequant_dtype="float32")
    got = k18.bsr_matmul(x, bw32)  # x and the values cast to bf16, as the reference does
    assert float(compute_error(k18.bsr_matmul_plain(x, bw32), got)) >= 45
    b16 = BlockSparseArray.from_hp(w, 16)
    with pytest.raises(ValueError, match="blocksize"):
        k18.bsr_matmul(x, b16)
    # the route asks ``takes`` before the call: b = 16 takes the ragged route
    before = k18.bsr_matmul.launches
    y = ao_tpu_torch.linear(x, b16)
    assert k18.bsr_matmul.launches == before and y.dtype == torch.float32
    assert float(compute_error(x @ b16.dequantize(torch.float32), y)) >= 100
    with pytest.raises(ValueError, match="2-D x"):
        k18.bsr_matmul(x[:, :128], bw32)


def test_vit_l_bsr_two_layers_go_through_k18(dev):
    """A 2-layer ViT-L/16 with block-sparse MLPs (b = 64, 10 % of the
    blocks): one K18 launch per MLP linear; logits near the ragged route's."""
    import dataclasses

    from ao_tpu_torch.models import vit
    from ao_tpu_torch.ops.hopper import bsr_matmul as k18

    cfg = dataclasses.replace(vit.VIT_L16, n_layers=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = vit.init_params(cfg, gen, device=dev)
    sp = ao_tpu_torch.sparsify_(params, ao_tpu_torch.BlockSparseWeightConfig(64, 0.1),
                                lambda fqn, leaf: fqn.endswith(("mlp.w1", "mlp.w2")))
    images = torch.randn((2, 224, 224, 3), generator=gen, device=dev)
    k18.bsr_matmul.launches = 0
    logits = vit.forward(sp, images, cfg)
    torch.cuda.synchronize()
    assert k18.bsr_matmul.launches == 4
    assert logits.shape == (2, 1000) and logits.dtype == torch.float32
    with kernels.backend("torch"):
        plain = vit.forward(sp, images, cfg)
    assert k18.bsr_matmul.launches == 4
    assert float(compute_error(plain, logits)) >= 30
