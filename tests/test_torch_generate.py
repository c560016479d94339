"""The port's greedy ``generate`` against the JAX package's, on a tiny config
with head_dim 128, params carried across by ``params_from_numpy``: equal
tokens over 8 steps in f32, int4 weight-only and W4A8. The W4A8 case has a
prompt of 2 x 272 tokens, so its prefill linears (M = 544 > 512) take the
requant route and its decode linears the W4A8 matmul's. On the CPU the
kernels' launch counters stay at 0.
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
from ao_tpu_torch.ops.hopper.decode_attention import decode_attention
from ao_tpu_torch.ops.hopper.fused_act import silu_mul_quant
from ao_tpu_torch.ops.hopper.int4_matmul import (
    int4_magic8_requant_int8, int4_w4a8_matmul, int4_wo_magic,
)

from torch_port_helpers import jax_to_torch

JCFG = jllama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=1024, tie_embeddings=False, dtype=jnp.float32)
TCFG = tllama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=1024, tie_embeddings=False, dtype=torch.float32)
B, S, STEPS, MAX_SEQ = 2, 8, 8, 16
S_W4A8, MAX_SEQ_W4A8 = 272, 280  # B * S = 544 > 512: the requant route at prefill
KERNELS = (decode_attention, int4_wo_magic, int4_w4a8_matmul, int4_magic8_requant_int8,
           silu_mul_quant)


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


@pytest.mark.parametrize("kind", ["f32", "int4", "w4a8"])
def test_greedy_tokens_equal_jax(setup, kind):
    jp, tp, prompt, max_seq = setup[kind]
    want = np.asarray(jgenerate(jp, jnp.asarray(prompt), JCFG, STEPS, max_seq))
    for kern in KERNELS:
        kern.launches = 0
    # the plain route on both sides: JAX's XLA path on the CPU and the
    # port's "torch" backend compute the same f32 arithmetic
    with tkernels.backend("torch"):
        got = ao_tpu_torch.generate(tp, torch.from_numpy(prompt), TCFG, STEPS, max_seq)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel route runs the kernels' plain versions on the CPU. For int4
    # it rounds each linear's input, qparams and output to bf16 where JAX's
    # CPU path keeps f32 (about 43 dB on the logits, test_torch_llama.py);
    # for W4A8 it takes exact integer dots (K3) and rounds the requantized
    # weight's multiply-add twice (K4) where JAX dequantizes. On this seeded
    # config no greedy choice is close enough to a tie for that to flip a
    # token, so the tokens are held to JAX's exactly
    auto = ao_tpu_torch.generate(tp, torch.from_numpy(prompt), TCFG, STEPS, max_seq)
    assert auto.dtype == torch.int32 and auto.shape == (B, STEPS)
    np.testing.assert_array_equal(auto.numpy(), want)
    assert all(kern.launches == 0 for kern in KERNELS)


def test_generate_checks():
    tp = jax_to_torch(jllama.init_params(jax.random.PRNGKey(2), JCFG))
    prompt = torch.zeros((1, S), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="sampling"):
        ao_tpu_torch.generate(tp, prompt, TCFG, 2, MAX_SEQ, temperature=0.7)
    with pytest.raises(NotImplementedError, match="quantized KV"):
        ao_tpu_torch.generate(tp, prompt, TCFG, 2, MAX_SEQ, kv_quant="int8")
    with pytest.raises(ValueError, match="max_seq"):
        ao_tpu_torch.generate(tp, prompt, TCFG, MAX_SEQ, MAX_SEQ)
