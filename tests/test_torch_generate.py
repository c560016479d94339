"""The port's greedy ``generate`` against the JAX package's, on a tiny config
with head_dim 128, params carried across by ``params_from_numpy``: equal
tokens over 8 steps in f32, int4 weight-only and W4A8, and in f32 and int4
weight-only over each quantized KV cache (``kv_quant`` int8, fp8 e4m3,
fp8 e5m2, int4; the kernel route of int4 weight-only over an int4 cache is held to
JAX's logits instead, see the test). The W4A8 case has a prompt of 2 x 272
tokens, so its prefill linears (M = 544 > 512) take the requant route and
its decode linears the W4A8 matmul's. On the CPU the kernels' launch
counters stay at 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu
from ao_tpu.models import llama as jllama
from ao_tpu.serving.decode import generate as jgenerate

import ao_tpu_torch
from ao_tpu_torch.models import llama as tllama
from ao_tpu_torch.ops import kernels as tkernels
from ao_tpu_torch.ops.hopper.decode_attention import (
    decode_attention, decode_attention_fp8, decode_attention_int4, decode_attention_int8,
    decode_attention_vec8,
)
from ao_tpu_torch.ops.hopper.fused_act import silu_mul_quant
from ao_tpu_torch.ops.hopper.int4_matmul import (
    int4_magic8_requant_int8, int4_w4a8_matmul, int4_wo_magic,
)
from ao_tpu_torch.quantization.primitives import compute_error

from torch_port_helpers import jax_to_torch

JCFG = jllama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=1024, tie_embeddings=False, dtype=jnp.float32)
TCFG = tllama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=1024, tie_embeddings=False, dtype=torch.float32)
B, S, STEPS, MAX_SEQ = 2, 8, 8, 16
S_W4A8, MAX_SEQ_W4A8 = 272, 280  # B * S = 544 > 512: the requant route at prefill
KERNELS = (decode_attention, decode_attention_int8, decode_attention_fp8, decode_attention_int4,
           decode_attention_vec8,
           int4_wo_magic, int4_w4a8_matmul, int4_magic8_requant_int8, silu_mul_quant)
KV_QUANT = ("int8", "float8_e4m3fn", "int4", "float8_e5m2")


@pytest.fixture(scope="module")
def setup():
    jp = jllama.init_params(jax.random.PRNGKey(1), JCFG)
    jq = ao_tpu.quantize_(jp, ao_tpu.Int4WeightOnlyConfig(group_size=32))
    jw = ao_tpu.quantize_(jp, ao_tpu.Int8DynamicActivationInt4WeightConfig(group_size=32))
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, JCFG.vocab_size, (B, S)).astype(np.int32)
    prompt_w4a8 = rng.integers(0, JCFG.vocab_size, (B, S_W4A8)).astype(np.int32)
    return {"f32": (jp, jax_to_torch(jp), prompt, MAX_SEQ),
            "int4": (jq, jax_to_torch(jq), prompt, MAX_SEQ),
            "w4a8": (jw, jax_to_torch(jw), prompt_w4a8, MAX_SEQ_W4A8)}


@pytest.mark.parametrize(
    "kind,kv_quant",
    [pytest.param(kind, None, id=kind) for kind in ("f32", "int4", "w4a8")]
    + [pytest.param(kind, kv, id=f"{kind}-{kv}") for kind in ("f32", "int4") for kv in KV_QUANT])
def test_greedy_tokens_equal_jax(setup, kind, kv_quant):
    jp, tp, prompt, max_seq = setup[kind]
    want = np.asarray(jgenerate(jp, jnp.asarray(prompt), JCFG, STEPS, max_seq,
                                kv_quant=kv_quant))
    for kern in KERNELS:
        kern.launches = 0
    # the plain route on both sides: JAX's XLA path on the CPU and the
    # port's "torch" backend compute the same f32 arithmetic (a quantized
    # cache: the same bits through quantize and dequantize, then the
    # masked einsum)
    with tkernels.backend("torch"):
        got = ao_tpu_torch.generate(tp, torch.from_numpy(prompt), TCFG, STEPS, max_seq,
                                    kv_quant=kv_quant)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel route runs the kernels' plain versions on the CPU. For int4
    # it rounds each linear's input, qparams and output to bf16 where JAX's
    # CPU path keeps f32 (about 43 dB on the logits, test_torch_llama.py);
    # for W4A8 it takes exact integer dots (K3) and rounds the requantized
    # weight's multiply-add twice (K4) where JAX dequantizes. On this seeded
    # config no greedy choice is close enough to a tie for that to flip a
    # token, so the tokens are held to JAX's exactly. An int4 cache is the
    # exception: its 16 levels turn the bf16 roundings of K and V into
    # whole-nibble flips (prefill logits against JAX's: 42 dB over a bf16
    # cache, 37 int8, 31 fp8, 22 int4), which flip most greedy tokens of
    # this random model, so there the route's logits are held to JAX's; so
    # does e5m2's two-bit mantissa (26 dB), which flips a token at step 2
    auto = ao_tpu_torch.generate(tp, torch.from_numpy(prompt), TCFG, STEPS, max_seq,
                                 kv_quant=kv_quant)
    assert auto.dtype == torch.int32 and auto.shape == (B, STEPS)
    if kind == "int4" and kv_quant in KV_LOGITS_DB:
        for step, (jl, tl) in enumerate(_two_step_logits(jp, tp, prompt, max_seq, kv_quant)):
            sqnr = float(compute_error(torch.from_numpy(np.array(jl)), tl))
            assert sqnr >= KV_LOGITS_DB[kv_quant], f"step {step}: {sqnr:.2f} dB"
    else:
        np.testing.assert_array_equal(auto.numpy(), want)
    assert all(kern.launches == 0 for kern in KERNELS)


# measured at prefill on this config: int4 21.6 dB, e5m2 26.2 dB
KV_LOGITS_DB = {"int4": 18.0, "float8_e5m2": 23.0}


def _two_step_logits(jp, tp, prompt, max_seq, kv_quant):
    """[(JAX's, the port's default route's) logits] of the prefill and of one
    decode step over a quantized cache, the decode step fed JAX's token."""
    from ao_tpu.serving.kvcache import init_quant_kv_caches

    b, s = prompt.shape
    jc = init_quant_kv_caches(JCFG, b, max_seq, kv_quant)
    tc = ao_tpu_torch.init_quant_kv_caches(TCFG, b, max_seq, kv_quant, device="cpu")
    jpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    j0, jc = jllama.forward(jp, jnp.asarray(prompt), JCFG, positions=jpos, kv_caches=jc,
                            cache_index=0)
    t0, tc = tllama.forward(tp, torch.from_numpy(prompt), TCFG,
                            positions=torch.arange(s, dtype=torch.int32).expand(b, s),
                            kv_caches=tc, cache_index=0)
    tok = np.asarray(jnp.argmax(j0[:, -1], axis=-1)).astype(np.int32)[:, None]
    j1, _ = jllama.forward(jp, jnp.asarray(tok), JCFG, positions=jnp.full((b, 1), s, jnp.int32),
                           kv_caches=jc, cache_index=s)
    t1, _ = tllama.forward(tp, torch.from_numpy(tok), TCFG,
                           positions=torch.full((b, 1), s, dtype=torch.int32), kv_caches=tc,
                           cache_index=s)
    return [(j0, t0), (j1, t1)]


def test_generate_checks():
    tp = jax_to_torch(jllama.init_params(jax.random.PRNGKey(2), JCFG))
    prompt = torch.zeros((1, S), dtype=torch.int32)
    # sampling runs (serving/sampling.py); its tokens are the vocabulary's
    toks = ao_tpu_torch.generate(tp, prompt, TCFG, 2, MAX_SEQ, temperature=0.7)
    assert toks.dtype == torch.int32 and toks.shape == (1, 2)
    assert bool(((toks >= 0) & (toks < TCFG.vocab_size)).all())
    # the flash-attention prefill over a quantized cache runs; on the CPU it
    # takes the einsum path, as the reference's does off the TPU
    np.testing.assert_array_equal(
        ao_tpu_torch.generate(tp, prompt, TCFG, 3, MAX_SEQ, kv_quant="int8", use_flash=True),
        ao_tpu_torch.generate(tp, prompt, TCFG, 3, MAX_SEQ, kv_quant="int8"))
    # what a quantized cache still refuses: an int4 cache whose max_seq
    # does not hold whole words of 8 positions
    with pytest.raises(ValueError, match="max_seq % 8"):
        ao_tpu_torch.generate(tp, prompt, TCFG, 2, MAX_SEQ + 4, kv_quant="int4")
    with pytest.raises(ValueError, match="max_seq"):
        ao_tpu_torch.generate(tp, prompt, TCFG, MAX_SEQ, MAX_SEQ)
