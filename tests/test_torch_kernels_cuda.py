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
from ao_tpu_torch.ops.hopper import fused_act as k12
from ao_tpu_torch.ops.hopper import int4_matmul as k1
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


@pytest.mark.parametrize("m,k,n,g,domain", [
    (1, 512, 128, 32, "tinygemm"),
    (8, 1024, 256, 128, "tinygemm"),
    (8, 1024, 1056, 64, "minmax_int"),  # N a multiple of 32 but not of 128
    (17, 512, 96, 32, "tinygemm"),      # M across two m16 tiles, a ragged edge
    (16, 512, 128, 16, "tinygemm"),     # two n8 tiles of batch rows
    (40, 2048, 512, 128, "minmax_int"),
    (200, 512, 256, 32, "tinygemm"),
    (64, 512, 128, 16, "minmax_int"),
    (1024, 1024, 384, 128, "tinygemm"),  # prefill-sized M, N not a multiple of 128
])
def test_int4_wo_magic_matches_plain(dev, m, k, n, g, domain):
    gen = torch.Generator(device=dev).manual_seed(m * 7 + n)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    zpd = ZeroPointDomain.FLOAT if domain == "tinygemm" else ZeroPointDomain.INT
    qa = Int4Array.from_hp(w, group_size=g, zero_point_domain=zpd)
    assert qa.layout == "magic"
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
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


def test_int4_wo_magic_refuses_what_it_does_not_take(dev):
    qa = Int4Array.from_hp(torch.randn((512, 128), device=dev), group_size=32)
    x = torch.randn((8, 512), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        k1.int4_wo_magic(x, qa.qdata.t().contiguous().t(), qa.scale, qa.zero_point, 32,
                         qa.zero_point_domain)
    with pytest.raises(ValueError, match="multiple of 32"):
        k1.int4_wo_magic(x, qa.qdata[:, :100], qa.scale[:, :100], qa.zero_point[:, :100], 32,
                         qa.zero_point_domain)


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
    # f32 scores, softmax and sums in both; the kernel merges per-chunk
    # partial softmaxes, the plain version takes one softmax over T
    assert got.dtype == torch.float32 and float(compute_error(ref, got)) >= 40


QUANT_WRAPPERS = {"int8": (k2.decode_attention_int8, "i8"),
                  "float8_e4m3fn": (k2.decode_attention_fp8, "f8"),
                  "int4": (k2.decode_attention_int4, "i4")}


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
    # kernel merges per-chunk softmaxes, each with its own max at the bf16
    # rounding of p * vs
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


def test_fp8_cast_matches_cpu(dev):
    # the cache's fp8 quantize on the card gives the CPU's bits (the CPU's
    # equal JAX's, tests/test_torch_kvcache.py)
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = (torch.randn((1 << 20,), generator=gen) * 200).clamp(-448, 448)
    x[:4] = torch.tensor([448.0, -448.0, 0.0, 2.0 ** -10])
    got = x.to(dev).to(torch.float8_e4m3fn).view(torch.uint8).cpu()
    assert torch.equal(got, x.to(torch.float8_e4m3fn).view(torch.uint8))


@pytest.mark.parametrize("kv_quant", list(QUANT_WRAPPERS))
def test_generate_kv_quant_goes_through_its_kernel(dev, kv_quant):
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=1024, tie_embeddings=False)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    qparams = ao_tpu_torch.quantize_(params, ao_tpu_torch.Int4WeightOnlyConfig(group_size=32))
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), device=dev, dtype=torch.int32)
    counters = [k1.int4_wo_magic, k2.decode_attention] + [w for w, _ in QUANT_WRAPPERS.values()]
    for c in counters:
        c.launches = 0
    toks = ao_tpu_torch.generate(qparams, prompt, cfg, num_steps=5, max_seq=16, kv_quant=kv_quant)
    torch.cuda.synchronize()
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    want = {id(c): 0 for c in counters}
    want[id(k1.int4_wo_magic)] = (7 * cfg.n_layers + 1) * 5
    want[id(QUANT_WRAPPERS[kv_quant][0])] = cfg.n_layers * 4
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


@pytest.mark.parametrize("k,n,g", [(512, 256, 64), (1024, 1024, 128), (512, 128, 32),
                                   (4096, 1024, 128)])
def test_requant_matches_plain_and_feeds_int_mm(dev, k, n, g):
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
    xq = torch.randint(-127, 128, (32, k), generator=gen, device=dev, dtype=torch.int8)
    # the column-major q8 is the B operand the int8 GEMM takes on the card
    want = (xq.cpu().long() @ ref.cpu().long()).int()
    assert torch.equal(torch._int_mm(xq, got).cpu(), want)


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
