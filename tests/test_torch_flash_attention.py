"""K8 (flash attention for prefill): the port's plain version against the
JAX package's Pallas kernel in interpret mode and an f64 reference, on the
same numpy inputs. JAX takes (B, H, S, D) with K and V repeated over the
query heads; the port takes q (B, Sq, H, D) and the un-repeated GQA cache
(B, Sk, Hkv, D). The model's ``use_flash`` route and ``generate(use_flash=
True)`` meet JAX's too. The CUDA kernel itself runs only on the card (cuda
marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ao_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention

from ao_tpu_torch.ops.hopper import flash_attention as k8
from ao_tpu_torch.quantization.primitives import compute_error

from torch_port_helpers import torch_from_np

H, HKV, D = 4, 2, 128


def _inputs(seed, b, sq, sk):
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16)

    return bf16(b, sq, H, D), bf16(b, sk, HKV, D), bf16(b, sk, HKV, D)


def _f64_reference(q, k, v, causal):
    """Softmax attention in float64 numpy over the bf16 values, top-left
    causal; (B, Sq, H, D)."""
    q, k, v = (np.asarray(a.astype(jnp.float32), np.float64) for a in (q, k, v))
    sq, sk = q.shape[1], k.shape[1]
    kf, vf = np.repeat(k, H // HKV, axis=2), np.repeat(v, H // HKV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kf) * D ** -0.5
    if causal:
        s = np.where(np.arange(sk)[None, :] <= np.arange(sq)[:, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vf)


def _sqnr(a, b):
    return float(compute_error(torch.tensor(np.asarray(a, np.float32)),
                               torch.tensor(np.asarray(b, np.float32))))


@pytest.mark.parametrize("sq,sk,causal", [(128, 128, True), (128, 128, False), (128, 256, True)],
                         ids=["causal", "full", "causal-sq<sk"])
def test_plain_matches_pallas_interpret(sq, sk, causal):
    q, k, v = _inputs(sq + sk, 1, sq, sk)
    jq, jk, jv = (jnp.transpose(a, (0, 2, 1, 3)) for a in (q, k, v))
    jk, jv = jnp.repeat(jk, H // HKV, axis=1), jnp.repeat(jv, H // HKV, axis=1)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_attention(jq, jk, jv, causal=causal).block_until_ready()
    ref = np.asarray(jnp.transpose(ref, (0, 2, 1, 3)).astype(jnp.float32))
    got = k8.flash_attention(torch_from_np(q), torch_from_np(k), torch_from_np(v), causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (1, sq, H, D)
    got = got.float().numpy()
    # both round p to bf16 before p.V (the Pallas kernel against its
    # running max per 128-key block, the plain version, as K8, per 64-key
    # tile) and the output to bf16
    assert _sqnr(ref, got) >= 40
    # the JAX suite's bound against f32 attention
    assert _sqnr(_f64_reference(q, k, v, causal), got) >= 30


def test_causal_mask_is_top_left():
    """With Sq < Sk, query row i sees cache rows 0..i only: rows past Sq
    change nothing."""
    q, k, v = _inputs(7, 2, 16, 128)
    args = [torch_from_np(a).clone() for a in (q, k, v)]
    got = k8.flash_attention(*args)
    args[2][:, 16:] = 1e4
    args[1][:, 16:] = -1e4
    assert torch.equal(k8.flash_attention(*args), got)
    # row 0 attends to key 0 alone: its output is V[0], rounded to bf16
    rep = args[2][:, 0].repeat_interleave(H // HKV, dim=1)
    assert torch.equal(got[:, 0], rep)


def test_wrapper_checks_counter_and_traffic():
    q, k, v = _inputs(3, 1, 64, 128)
    qt, kt, vt = torch_from_np(q), torch_from_np(k), torch_from_np(v)
    with pytest.raises(ValueError, match="head_dim 128"):
        k8.flash_attention(qt[..., :64], kt[..., :64], vt[..., :64])
    with pytest.raises(ValueError, match="bf16"):
        k8.flash_attention(qt, kt.float(), vt)
    with pytest.raises(ValueError, match="do not fit"):
        k8.flash_attention(qt[:, :, :3], kt, vt)
    k8.flash_attention(qt.float(), kt, vt)  # q is taken in bf16
    assert k8.flash_attention.launches == 0
    nbytes, flops = k8.traffic((1, 64, H, D), (1, 128, HKV, D))
    # causally only the cache rows up to the last query row are needed
    assert nbytes == 2 * 64 * H * D * 2 + 2 * 64 * HKV * D * 2
    assert flops == 4 * H * D * (64 * 65 // 2)
    assert k8.traffic((1, 64, H, D), (1, 128, HKV, D), causal=False) == (
        2 * 64 * H * D * 2 + 2 * 128 * HKV * D * 2, 4 * H * D * 64 * 128)
    # causal pairs are capped at Sk, not the reference's 0.5 * Sq * Sk
    assert k8.traffic((1, 256, H, D), (1, 128, HKV, D))[1] == 4 * H * D * (
        128 * 129 // 2 + 128 * 128)


def test_generate_use_flash_matches_jax():
    """``generate(use_flash=True)``: on the CPU both packages take the
    einsum path after the cache update, and give the same greedy tokens."""
    import jax

    from ao_tpu.models import llama as jllama
    from ao_tpu.serving.decode import generate as jgenerate

    import ao_tpu_torch
    from ao_tpu_torch.models import llama as tllama

    from torch_port_helpers import jax_to_torch

    jcfg = jllama.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                              ffn_dim=512, tie_embeddings=False, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                              ffn_dim=512, tie_embeddings=False, dtype=torch.float32)
    jp = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    prompt = np.random.default_rng(3).integers(0, 256, (2, 8)).astype(np.int32)
    want = np.asarray(jgenerate(jp, jnp.asarray(prompt), jcfg, 6, 16, use_flash=True))
    got = ao_tpu_torch.generate(jax_to_torch(jp), torch.from_numpy(prompt), tcfg, 6, 16,
                                use_flash=True)
    np.testing.assert_array_equal(got.numpy(), want)
