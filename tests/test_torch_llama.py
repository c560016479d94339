"""The port's Llama forward against the JAX package's, on a tiny config with
head_dim 128, params carried across by ``params_from_numpy``: a prefill
into the KV cache and one decode step, in f32 and int4 weight-only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu
from ao_tpu.models import llama as jllama

import ao_tpu_torch
from ao_tpu_torch.models import llama as tllama
from ao_tpu_torch.ops import kernels as tkernels
from ao_tpu_torch.quantization.primitives import compute_error

from torch_port_helpers import jax_to_torch

# every K/g (512/32, 1024/32) is a multiple of 4: all linears take the magic layout
JCFG = jllama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=1024, tie_embeddings=False, dtype=jnp.float32)
TCFG = tllama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=1024, tie_embeddings=False, dtype=torch.float32)
B, S, T = 2, 8, 16


@pytest.fixture(scope="module")
def models():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    jq = ao_tpu.quantize_(jp, ao_tpu.Int4WeightOnlyConfig(group_size=32))
    return {"f32": (jp, jax_to_torch(jp)), "int4": (jq, jax_to_torch(jq))}


def _tokens():
    rng = np.random.default_rng(0)
    return rng.integers(0, JCFG.vocab_size, (B, S + 1)).astype(np.int32)


def _jax_prefill_and_step(params, toks):
    caches = jllama.init_kv_caches(JCFG, B, T)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    l0, caches = jllama.forward(params, jnp.asarray(toks[:, :S]), JCFG, positions=pos,
                                kv_caches=caches, cache_index=0)
    l1, _ = jllama.forward(params, jnp.asarray(toks[:, S:]), JCFG,
                           positions=jnp.full((B, 1), S, jnp.int32), kv_caches=caches,
                           cache_index=S)
    return np.asarray(l0), np.asarray(l1)


def _torch_prefill_and_step(params, toks):
    caches = tllama.init_kv_caches(TCFG, B, T, device="cpu")
    t = torch.from_numpy(toks)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    l0, caches = tllama.forward(params, t[:, :S], TCFG, positions=pos, kv_caches=caches,
                                cache_index=0)
    assert caches[0][0].dtype == torch.bfloat16  # bf16 caches even for an f32 model
    l1, _ = tllama.forward(params, t[:, S:], TCFG, positions=torch.full((B, 1), S, dtype=torch.int32),
                           kv_caches=caches, cache_index=S)
    return l0.numpy(), l1.numpy()


def _sqnr(a, b):
    return float(compute_error(torch.tensor(a), torch.tensor(b)))


@pytest.mark.parametrize("kind", ["f32", "int4"])
def test_forward_matches_jax_plain_paths(models, kind):
    """The plain routes of both packages: the JAX package's XLA path on the
    CPU and the port's "torch" backend (dequantize, then matmul)."""
    jp, tp = models[kind]
    j0, j1 = _jax_prefill_and_step(jp, _tokens())
    with tkernels.backend("torch"):
        t0, t1 = _torch_prefill_and_step(tp, _tokens())
    assert t0.shape == (B, S, JCFG.vocab_size) and t1.shape == (B, 1, JCFG.vocab_size)
    # f32 everywhere but the bf16 KV cache; a last-bit f32 difference in k or
    # v may flip one bf16 rounding of a cached value (2^-9 relative)
    assert _sqnr(j0, t0) >= 60
    assert _sqnr(j1, t1) >= 60


def test_forward_int4_kernel_route_matches_jax(models):
    """The port's kernel route (its kernels' plain versions on the CPU)
    against the JAX package's CPU path. The JAX side runs its XLA path,
    not the Pallas kernels in interpret mode: a whole eager forward with
    dozens of interpreted kernels can deadlock JAX's CPU dispatch against
    the interpreter's callbacks. The kernels themselves meet the Pallas
    kernels in interpret mode in test_torch_int4_matmul.py and
    test_torch_decode_attention.py."""
    jp, tp = models["int4"]
    j0, j1 = _jax_prefill_and_step(jp, _tokens())
    t0, t1 = _torch_prefill_and_step(tp, _tokens())
    # the kernel route rounds each linear's input, s, b2 and output to bf16
    # (2^-9 relative) where the XLA path keeps f32: about 43 dB after two
    # layers, so 38 dB leaves room for the order of f32 sums
    assert _sqnr(j0, t0) >= 38
    assert _sqnr(j1, t1) >= 38


def test_forward_without_cache_and_decode_consistency(models):
    jp, tp = models["f32"]
    toks = torch.from_numpy(_tokens()[:, :S])
    full, caches = tllama.forward(tp, toks, TCFG)
    assert caches is None and full.shape == (B, S, JCFG.vocab_size)
    jfull, _ = jllama.forward(jp, jnp.asarray(toks.numpy()), JCFG)
    assert _sqnr(np.asarray(jfull), full.numpy()) >= 100


def test_unported_branches_raise():
    import dataclasses

    # the MoE FFN is ported: the reference's keys and shapes, the router
    # drawn in f32 and cast to the model's dtype (f32 here)
    moe = tllama.init_params(dataclasses.replace(TCFG, n_layers=1, n_experts=4),
                             torch.Generator().manual_seed(0), "cpu")["layers"][0]["mlp"]
    assert {k: (tuple(v.shape), v.dtype) for k, v in moe.items()} == {
        "router": ((512, 4), torch.float32), "w_gate": ((4, 512, 1024), torch.float32),
        "w_up": ((4, 512, 1024), torch.float32), "w_down": ((4, 1024, 512), torch.float32)}
    with pytest.raises(NotImplementedError, match="quantized SDPA"):
        tllama.init_params(dataclasses.replace(TCFG, sdpa="int8"), torch.Generator(), "cpu")
    gen = torch.Generator().manual_seed(0)
    p = tllama.init_params(dataclasses.replace(TCFG, n_layers=1), gen, device="cpu")
    assert p["layers"][0]["attn"]["wq"].shape == (512, 512) and "lm_head" in p
    # a per-slot (vector) cache index runs over a bf16 cache and over a
    # QuantKVCache, each row writing at its own position
    cfg1 = dataclasses.replace(TCFG, n_layers=1)
    caches = tllama.init_kv_caches(cfg1, B, T, device="cpu")
    logits, _ = tllama.forward(p, torch.zeros((B, 1), dtype=torch.int32), cfg1,
                               positions=torch.zeros((B, 1), dtype=torch.int32),
                               kv_caches=caches, cache_index=torch.zeros(B, dtype=torch.int32))
    assert logits.shape == (B, 1, TCFG.vocab_size) and bool(caches[0][0][:, 0].any())
    qcaches = ao_tpu_torch.init_quant_kv_caches(cfg1, B, T, "int8", device="cpu")
    pos = torch.arange(B, dtype=torch.int32)
    qlogits, _ = tllama.forward(p, torch.zeros((B, 1), dtype=torch.int32), cfg1,
                                positions=pos[:, None], kv_caches=qcaches, cache_index=pos)
    assert qlogits.shape == (B, 1, TCFG.vocab_size)
    written = qcaches[0][0].scale.amax(dim=1) > 0  # (B, T)
    assert written.sum() == B and all(bool(written[i, i]) for i in range(B))
    assert ao_tpu_torch.models.llama is tllama


def test_rope_llama3_scaling_matches():
    rs = (("rope_type", "llama3"), ("factor", 8.0), ("low_freq_factor", 1.0),
          ("high_freq_factor", 4.0), ("original_max_position_embeddings", 8192))
    import dataclasses

    jf = jllama.rope_freqs(dataclasses.replace(JCFG, rope_scaling=rs))
    tf = tllama.rope_freqs(dataclasses.replace(TCFG, rope_scaling=rs), device="cpu")
    np.testing.assert_allclose(np.asarray(jf), tf.numpy(), rtol=1e-6)


@pytest.mark.parametrize("kind", ["f32", "int4"])
def test_per_slot_decode_matches_jax(models, kind):
    """A decode step whose rows write and attend at their own positions
    (a vector ``cache_index``, the serving engine's slot layout) against
    JAX's, after a prefill."""
    jp, tp = models[kind]
    toks = _tokens()
    pos = np.array([S, 5], np.int32)  # row 1 rewrites position 5 and attends to 0..5
    cur = toks[np.arange(B), pos][:, None]
    caches = jllama.init_kv_caches(JCFG, B, T)
    _, caches = jllama.forward(jp, jnp.asarray(toks[:, :S]), JCFG, kv_caches=caches,
                               cache_index=0)
    j1, _ = jllama.forward(jp, jnp.asarray(cur), JCFG, positions=jnp.asarray(pos[:, None]),
                           kv_caches=caches, cache_index=jnp.asarray(pos))
    # the plain route on both sides, as in test_forward_matches_jax_plain_paths
    with tkernels.backend("torch"):
        tcaches = tllama.init_kv_caches(TCFG, B, T, device="cpu")
        _, tcaches = tllama.forward(tp, torch.from_numpy(toks[:, :S]), TCFG, kv_caches=tcaches,
                                    cache_index=0)
        t1, _ = tllama.forward(tp, torch.from_numpy(cur), TCFG,
                               positions=torch.from_numpy(pos[:, None]), kv_caches=tcaches,
                               cache_index=torch.from_numpy(pos))
    assert _sqnr(np.asarray(j1), t1.numpy()) >= 60
