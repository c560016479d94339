"""The port's MoE FFN (``ao_tpu_torch.moe``) and MoE llama against the JAX
package's, on the same numpy inputs, on the CPU.

* ``route``, ``dispatch`` and ``combine`` on f32 inputs: top-k indices, the
  sort order and the group sizes equal JAX's, the weights within 1e-6
  relative, ``combine`` bit for bit for top-2.
* ``grouped_matmul`` over plain experts and over Int8 (weight-only,
  dynamic int8), Float8 (weight-only, dynamic fp8), Int4, MXFP4 and NVFP4
  expert stacks made by JAX and carried across by ``params_from_numpy``:
  held to JAX's output at 40 dB and to the high-precision reference at the
  JAX suite's own bounds (tests/test_moe.py); ``dequantize()`` of each
  carried container equals JAX's bit for bit.
* The plain versions of K13 (the "auto" route on the CPU) against JAX's
  Pallas kernels in interpret mode, on tests/test_pallas_interpret.py's
  cases, and the T > 256 fallback against JAX's "xla" route.
* The tiny MoE llama of tests/test_moe_llama.py (f32): forward logits,
  greedy ``generate`` tokens and the slot ``Engine``'s tokens against
  JAX's; a wider one (every expert stack taken by K13) under int4-WO and
  W4A8 at stated bounds.

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
from ao_tpu.moe import grouped as jgrouped
from ao_tpu.moe import layer as jlayer
from ao_tpu.ops import kernels as jkernels
from ao_tpu.prototype import mx as jpmx
from ao_tpu.quantization.qarrays.common import ActQuantSpec as JActQuantSpec
from ao_tpu.quantization.qarrays.float8 import Float8Array as JFloat8Array
from ao_tpu.quantization.qarrays.int4 import Int4Array as JInt4Array
from ao_tpu.quantization.qarrays.int8 import Int8Array as JInt8Array
from ao_tpu.serving.decode import generate as jgenerate
from ao_tpu.serving.engine import Engine as JEngine
from ao_tpu.serving.engine import ServeConfig as JServeConfig

import ao_tpu_torch
from ao_tpu_torch.models import llama as tllama
from ao_tpu_torch.moe import grouped as tgrouped
from ao_tpu_torch.moe import layer as tlayer
from ao_tpu_torch.ops import kernels as tkernels
from ao_tpu_torch.ops.hopper import grouped_matmul as k13
from ao_tpu_torch.quantization.primitives import compute_error

from torch_port_helpers import assert_bit_equal, jax_to_torch, torch_from_np


def _sqnr(ref, got) -> float:
    ref = torch.from_numpy(np.asarray(ref, np.float32)) if not torch.is_tensor(ref) else ref
    got = torch.from_numpy(np.asarray(got, np.float32)) if not torch.is_tensor(got) else got
    return float(compute_error(ref.float(), got.float()))


# ---------------------------------------------------------------------------
# route, dispatch, combine
# ---------------------------------------------------------------------------

MCFG_J = jlayer.MoEConfig(dim=64, ffn_dim=96, n_experts=4, top_k=2)
MCFG_T = tlayer.MoEConfig(dim=64, ffn_dim=96, n_experts=4, top_k=2)


def test_route_dispatch_combine_match_jax():
    rng = np.random.default_rng(0)
    x2 = rng.standard_normal((24, 64)).astype(np.float32)
    router = (rng.standard_normal((64, 4)) * 0.02).astype(np.float32)
    jw, ji = jlayer.route(jnp.asarray(x2), jnp.asarray(router), MCFG_J)
    tw, ti = tlayer.route(torch.from_numpy(x2), torch.from_numpy(router), MCFG_T)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)

    jxs, jorder, jgs = jlayer.dispatch(jnp.asarray(x2), ji, 4)
    txs, torder, tgs = tlayer.dispatch(torch.from_numpy(x2), ti, 4)
    np.testing.assert_array_equal(np.asarray(jorder), torder.numpy())
    np.testing.assert_array_equal(np.asarray(jgs), tgs.numpy())
    assert tgs.dtype == torch.int32 and int(tgs.sum()) == 48
    np.testing.assert_array_equal(np.asarray(jxs), txs.numpy())

    ys = rng.standard_normal((48, 64)).astype(np.float32)
    jy = jlayer.combine(jnp.asarray(ys), jorder, jw)
    ty = tlayer.combine(torch.from_numpy(ys), torder, torch.from_numpy(np.asarray(jw)))
    # top-2 from zeros: 0 + a + b in either order, bit for bit
    assert_bit_equal(jy, ty)


def test_moe_forward_matches_jax():
    params = jlayer.init_moe_params(jax.random.PRNGKey(0), MCFG_J)
    x = np.random.default_rng(1).standard_normal((3, 8, 64)).astype(np.float32)
    jy = jlayer.moe_forward(params, jnp.asarray(x), MCFG_J)
    ty = tlayer.moe_forward(jax_to_torch(params), torch.from_numpy(x), MCFG_T)
    assert ty.shape == (3, 8, 64) and ty.dtype == torch.float32
    assert _sqnr(jy, ty) >= 100  # f32 throughout; sums in another order
    gen = torch.Generator().manual_seed(0)
    tp = tlayer.init_moe_params(gen, MCFG_T, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in params.items()}


# ---------------------------------------------------------------------------
# grouped_matmul per container
# ---------------------------------------------------------------------------


def _mk(seed=0, t=96, k=64, n=48, e=4):
    """tests/test_moe.py's shapes from a numpy seed: x (T, K), w (E, K, N)
    * 0.1, random group sizes summing to T."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, k)).astype(np.float32)
    w = (rng.standard_normal((e, k, n)) * 0.1).astype(np.float32)
    gs = np.floor(rng.dirichlet(np.ones(e)) * t).astype(np.int32)
    gs[0] += t - gs.sum()
    return x, w, gs


def _ref_grouped(x, w, gs):
    ids = np.repeat(np.arange(w.shape[0]), gs)
    return np.einsum("tk,tkn->tn", x.astype(np.float64), w.astype(np.float64)[ids])


_AQ8 = JActQuantSpec("int8")
CONTAINERS = {
    # name: (JAX container maker, bound against the f64 reference: the JAX
    # suite's, tests/test_moe.py:57-96, where it has one)
    "plain": (lambda w: w, 35),
    "int8-WO": (lambda w: JInt8Array.from_hp(w, block_size=(1, w.shape[1], 1)), 25),
    "int8-dyn": (lambda w: JInt8Array.from_hp(w, block_size=(1, w.shape[1], 1),
                                              act_quant=_AQ8), 20),
    "fp8-WO": (lambda w: JFloat8Array.from_hp(w, block_size=(1, w.shape[1], 1)), 20),
    "fp8-dyn": (lambda w: JFloat8Array.from_hp(w, block_size=(1, w.shape[1], 1),
                                               act_quant=JActQuantSpec("float8_e4m3fn")), 20),
    "int4": (lambda w: JInt4Array.from_hp(w, group_size=32), 12),
    # fp4 elements (one e2m1 step is up to a third of its value): the int4
    # bound less 2 dB
    "mxfp4": (lambda w: ao_tpu.quantize_({"w": w}, jpmx.MXWeightOnlyConfig(
        elem_dtype="float4_e2m1fn"))["w"], 10),
    "nvfp4": (lambda w: ao_tpu.quantize_({"w": w}, jpmx.NVFP4WeightOnlyConfig())["w"], 10),
}


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_grouped_matmul_matches_jax(name):
    make, bound = CONTAINERS[name]
    x, w, gs = _mk()
    jw = jax.jit(make)(jnp.asarray(w))  # jitted: JAX's eager ops compile one by one
    assert name == "plain" or type(jw).__name__ != "ArrayImpl", name
    jy = np.asarray(jax.jit(jgrouped.grouped_matmul)(jnp.asarray(x), jw, jnp.asarray(gs)))
    tw = jax_to_torch(jw)
    if name != "plain":
        assert_bit_equal(jax.jit(lambda a: a.dequantize(jnp.float32))(jw),
                         tw.dequantize(torch.float32))
    ty = tgrouped.grouped_matmul(torch.from_numpy(x), tw, torch.from_numpy(gs))
    assert ty.shape == jy.shape and ty.dtype == torch.float32
    # f32 activations: the same quantizers, f32 products summed in another
    # order
    assert _sqnr(jy, ty) >= 40, name
    ref = _ref_grouped(x, w, gs)
    assert _sqnr(ref, ty) > bound, name


_CARRY = {
    "int4-magic": lambda w: JInt4Array.from_hp(w, group_size=32),
    "int4-magic8": lambda w: JInt4Array.from_hp(w, group_size=32, act_quant=JActQuantSpec(
        dtype="int8", granularity="per_token", symmetric=True)),
    "int8": lambda w: JInt8Array.from_hp(w, block_size=(1, w.shape[1], 1)),
    "fp8": lambda w: JFloat8Array.from_hp(w, block_size=(1, w.shape[1], 1)),
}


@pytest.mark.parametrize("name", list(_CARRY))
def test_expert_stacks_carry_bit_for_bit(name):
    """(E, K, N) containers through ``params_from_numpy``: the int4 magic
    and magic8 words (E, K/8, N) as they are, int8 and fp8 qdata with each
    expert column-major; the data fields and ``dequantize()`` equal JAX's."""
    w = (np.random.default_rng(3).standard_normal((3, 128, 256)) * 0.1).astype(np.float32)
    jw = jax.jit(_CARRY[name])(jnp.asarray(w))
    tw = jax_to_torch(jw)
    assert tw.shape == (3, 128, 256) and type(tw).__name__ == type(jw).__name__
    if name.startswith("int4"):
        assert tw.layout == jw.layout == name.split("-")[1]
        assert tuple(tw.qdata.shape) == (3, 16, 256)
    else:
        assert tw.qdata.transpose(-1, -2).is_contiguous()  # each expert column-major
    for field, v in jw.data_fields().items():
        if v is not None:
            assert_bit_equal(v, getattr(tw, field))
    assert_bit_equal(jax.jit(lambda a: a.dequantize(jnp.float32))(jw),
                     tw.dequantize(torch.float32))


def test_grouped_matmul_all_rows_in_one_expert():
    """tests/test_moe.py::test_jit_and_empty_groups: every row on expert 0."""
    x, w, _ = _mk()
    gs = np.array([96, 0, 0, 0], np.int32)
    ty = tgrouped.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs))
    assert _sqnr(x.astype(np.float64) @ w[0].astype(np.float64), ty) > 35


# ---------------------------------------------------------------------------
# K13's plain versions against JAX's Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

E, T, GK, GN, G = 3, 8, 256, 128, 32  # tests/test_pallas_interpret.py's cases


def _k13_setup(act_quant=None):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((E, GK, GN)) * 0.02).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((T, GK)).astype(np.float32), jnp.bfloat16)
    qa = jax.jit(lambda a: JInt4Array.from_hp(a, group_size=G, act_quant=act_quant))(
        jnp.asarray(w))
    return x, qa


def _jax_pallas(x, qa, gs):
    with pltpu.force_tpu_interpret_mode(), jkernels.backend("pallas"):
        y = jgrouped.grouped_matmul(x, qa, gs)
        return np.asarray(jax.block_until_ready(y).astype(jnp.float32))


@pytest.mark.parametrize("gs,bound", [([3, 1, 4], 45), ([0, 8, 0], 45)])
def test_k13_magic_plain_matches_pallas(gs, bound):
    x, qa = _k13_setup()
    assert qa.layout == "magic"
    gs = np.asarray(gs, np.int32)
    ref = _jax_pallas(x, qa, jnp.asarray(gs))
    before = k13.int4_grouped_magic.launches
    got = tgrouped.grouped_matmul(torch_from_np(x), jax_to_torch(qa), torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16 and k13.int4_grouped_magic.launches == before
    sqnr = _sqnr(ref, got)
    assert sqnr >= bound, sqnr


def test_k13_w4a8_plain_matches_pallas():
    spec = JActQuantSpec(dtype="int8", granularity="per_token", symmetric=True)
    x, qa = _k13_setup(spec)
    assert qa.layout == "magic8"
    gs = np.asarray([2, 5, 1], np.int32)
    ref = _jax_pallas(x, qa, jnp.asarray(gs))
    got = tgrouped.grouped_matmul(torch_from_np(x), jax_to_torch(qa), torch.from_numpy(gs))
    # the same int8 activations on both sides: the JAX suite's bound for its
    # kernel against the unquantized route, met here with room
    sqnr = _sqnr(ref, got)
    assert sqnr >= 35, sqnr


def test_k13_large_t_falls_back_as_xla():
    """T > 256 takes the ragged fallback, as JAX's "xla" route: dequantize to
    bf16, one bf16 product with f32 sums, bf16 out."""
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((2, GK, GN)) * 0.02).astype(np.float32)
    qa = jax.jit(lambda a: JInt4Array.from_hp(a, group_size=G))(jnp.asarray(w))
    x = jnp.asarray(rng.standard_normal((512, GK)).astype(np.float32), jnp.bfloat16)
    gs = np.asarray([300, 212], np.int32)
    with jkernels.backend("xla"):
        ref = np.asarray(jax.jit(jgrouped.grouped_matmul)(x, qa, jnp.asarray(gs)),
                         np.float32)
    before = k13.int4_grouped_magic.launches
    got = tgrouped.grouped_matmul(torch_from_np(x), jax_to_torch(qa), torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16 and k13.int4_grouped_magic.launches == before
    # the same bf16 operands; f32 sums in another order may round a value
    # to the neighbouring bf16 (2^-8 relative)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -8, atol=2 ** -8)


def test_takes_mirrors_the_reference_rules():
    assert k13.takes(4096, 14336, 128, "magic") and k13.takes(14336, 4096, 128, "magic8")
    assert not k13.takes(256, 96, 32, "magic")      # N % 128
    assert not k13.takes(64, 128, 32, "magic")      # K/g = 2: not a multiple of 4
    assert k13.takes(64, 128, 32, "magic8")         # K/g = 2: even
    assert not k13.takes(512, 128, 16, "magic8")    # g = 16: K3's sizes start at 32
    assert not k13.takes(512, 128, 32, "halves")


# ---------------------------------------------------------------------------
# MoE llama
# ---------------------------------------------------------------------------

JCFG = jllama.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=96, tie_embeddings=True, dtype=jnp.float32,
                          n_experts=4, top_k_experts=2)
TCFG = tllama.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=96, tie_embeddings=True, dtype=torch.float32,
                          n_experts=4, top_k_experts=2)
# every expert stack taken by K13 (N % 128, K/32 a multiple of 4)
JWIDE = jllama.LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
                           ffn_dim=256, tie_embeddings=True, dtype=jnp.float32,
                           n_experts=4, top_k_experts=2)
TWIDE = tllama.LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
                           ffn_dim=256, tie_embeddings=True, dtype=torch.float32,
                           n_experts=4, top_k_experts=2)


# JAX's side jitted: its eager ops compile one by one, several times slower
_jinit = jax.jit(jllama.init_params, static_argnums=1)


@pytest.fixture(scope="module")
def tiny():
    jp = _jinit(jax.random.PRNGKey(0), JCFG)
    return jp, jax_to_torch(jp)


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_moe_llama_forward_and_generate_match_jax(tiny):
    jp, tp = tiny
    toks = _tokens(2, 8, 128)
    jlog, _ = jax.jit(jllama.forward, static_argnums=2)(jp, jnp.asarray(toks), JCFG)
    tlog, _ = tllama.forward(tp, torch.from_numpy(toks), TCFG)
    assert tlog.shape == (2, 8, 128)
    assert _sqnr(jlog, tlog) >= 60
    prompt = _tokens(2, 5, 128, seed=1)
    jt = np.asarray(jgenerate(jp, jnp.asarray(prompt), JCFG, 6, max_seq=32))
    tt = ao_tpu_torch.generate(tp, torch.from_numpy(prompt), TCFG, num_steps=6, max_seq=32)
    np.testing.assert_array_equal(jt, tt.numpy())


def test_moe_llama_engine_matches_jax(tiny):
    """tests/test_engine.py::TestMoEServing's config; the port's engine at
    decode_steps_per_call=1 (its multi-step decode is not ported)."""
    jp, tp = tiny
    prompts = [[3, 17, 42, 9], [5, 1], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16]]
    jeng = JEngine(jp, JCFG, JServeConfig(max_batch=2, max_seq=64, prefill_buckets=(8,),
                                          decode_steps_per_call=3))
    teng = ao_tpu_torch.Engine(tp, TCFG, ao_tpu_torch.ServeConfig(
        max_batch=2, max_seq=64, prefill_buckets=(8,), decode_steps_per_call=1), device="cpu")
    for p in prompts:
        jeng.submit(p, 6)
        teng.submit(p, 6)
    jdone = sorted((r.uid, r.generated) for r in jeng.run())
    tdone = sorted((r.uid, r.generated) for r in teng.run())
    assert tdone == jdone and len(tdone) == len(prompts)


@pytest.fixture(scope="module")
def wide():
    jp = _jinit(jax.random.PRNGKey(1), JWIDE)
    out = {"f32": (jp, jax_to_torch(jp))}
    for name, cfg in (("int4-WO", ao_tpu.Int4WeightOnlyConfig(group_size=32)),
                      ("W4A8", ao_tpu.Int8DynamicActivationInt4WeightConfig(group_size=32))):
        jq = jax.jit(lambda p: ao_tpu.quantize_(p, cfg))(jp)
        out[name] = (jq, jax_to_torch(jq))
    return out


def _two_steps(fwd, init_caches, params, cfg, toks, tensor):
    """Logits of a prefill of S - 1 tokens into a KV cache and of one decode
    step."""
    b, s = toks.shape[0], toks.shape[1] - 1
    caches = init_caches(cfg, b, 16)
    l0, caches = fwd(params, tensor(toks[:, :s]), cfg, positions=tensor(
        np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))), kv_caches=caches, cache_index=0)
    l1, _ = fwd(params, tensor(toks[:, s:]), cfg, positions=tensor(
        np.full((b, 1), s, np.int32)), kv_caches=caches, cache_index=s)
    return l0, l1


def _jax_two_steps(params, toks):
    two = jax.jit(lambda p, t: _two_steps(jllama.forward, jllama.init_kv_caches, p, JWIDE, t,
                                          jnp.asarray))
    return [np.asarray(v, np.float32) for v in two(params, toks)]


def _torch_two_steps(params, toks):
    init = lambda c, b, t: tllama.init_kv_caches(c, b, t, device="cpu")  # noqa: E731
    return [v.numpy() for v in _two_steps(tllama.forward, init, params, TWIDE, toks,
                                          torch.from_numpy)]


# the port's kernel route (K13's and K1's / K3's plain versions) against
# JAX's XLA route: the int4-WO kernels round each linear's input, s, b2 and
# output to bf16 where JAX keeps f32 (about 40 dB after two layers, as the
# dense int4-WO route in test_torch_llama.py); W4A8 quantizes every linear's
# input to int8 per token, where JAX's CPU route takes its fallback for the
# experts and multiplies them unquantized
WIDE_BOUNDS = {"int4-WO": 38, "W4A8": 30}
# the plain routes of both packages: dequantize, then f32 products; under
# W4A8 both quantize every linear's input to int8 per token, which turns a
# last-bit f32 difference (XLA's fused jit against PyTorch's eager ops) into
# a whole step: 40 dB for one linear (test_torch_w4a8.py), less 5 dB for the
# two layers' quantizers compounding
PLAIN_BOUNDS = {"int4-WO": 60, "W4A8": 35}
NEAR_TIE = 2e-3  # router probability gap between the k-th and (k+1)-th expert


def _spy_routes(monkeypatch, log):
    """Record each ``route`` call's top-k sets and the gap between the k-th
    and (k+1)-th largest probability of each token."""
    orig = tlayer.route

    def spy(x2, router_w, cfg):
        topw, topi = orig(x2, router_w, cfg)
        probs = torch.softmax(x2.float() @ router_w.float(), dim=-1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        log.append((torch.sort(topi, dim=-1).values, top[:, -2] - top[:, -1]))
        return topw, topi

    monkeypatch.setattr(tlayer, "route", spy)


@pytest.mark.parametrize("name", ["int4-WO", "W4A8"])
def test_moe_llama_quantized_experts_match_jax(wide, name, monkeypatch):
    """A prefill of 6 tokens and one decode step of the wide MoE llama.

    The kernel route's bf16 roundings can flip a router decision where the
    k-th and (k+1)-th probabilities nearly tie (it does at this input: the
    decode step's second token at layer 2, at a gap of 5.6e-4 under int4-WO
    and 1.4e-3 under W4A8; ROADMAP Queue 3). A flipped token's later layers
    run another expert, so the logits are held at the bound on the tokens
    routed alike in both routes (44 / 42 dB int4-WO, 36 / 35 dB W4A8 at the
    prefill / decode), and a token routed otherwise must be at a near-tie.
    The plain routes route alike (97 / 85 dB int4-WO, 41 / 40 dB W4A8)."""
    jp, tp = wide[name]
    toks = _tokens(2, 7, 256, seed=2)
    jl = _jax_two_steps(jp, toks)
    counters = (k13.int4_grouped_magic, k13.int4_grouped_w4a8)
    before = [c.launches for c in counters]
    plain_routes, kernel_routes = [], []
    _spy_routes(monkeypatch, plain_routes)
    with tkernels.backend("torch"):
        plain = _torch_two_steps(tp, toks)
    _spy_routes(monkeypatch, kernel_routes)
    got = _torch_two_steps(tp, toks)
    assert [c.launches for c in counters] == before  # plain versions on the CPU
    # per call (2 layers x prefill, decode): tokens routed otherwise
    flipped = [(~(a == b).all(dim=-1), ga) for (a, ga), (b, _) in zip(plain_routes,
                                                                    kernel_routes)]
    for moved, gap in flipped:
        assert bool((gap[moved] < NEAR_TIE).all()), (name, gap[moved])
    for i in range(2):
        assert _sqnr(jl[i], plain[i]) >= PLAIN_BOUNDS[name], (name, i)
        rows = [fl[0].reshape(2, -1) for fl in flipped[2 * i:2 * i + 2]]  # this step's layers
        same = ~torch.stack(rows).any(dim=0).any(dim=-1)  # batch rows never routed otherwise
        assert bool(same.any()), name
        sqnr = _sqnr(jl[i][same.numpy()], got[i][same.numpy()])
        assert sqnr >= WIDE_BOUNDS[name], (name, i, sqnr)
    # the quantized experts stay near the f32 model's
    jf = _jax_two_steps(wide["f32"][0], toks)
    assert _sqnr(jf[0], got[0]) >= 10, name
