"""K2 (decode attention, bf16 tokens cache): the port's plain version against
the JAX package's Pallas kernel in interpret mode and an f32 reference, on
the same numpy inputs. The CUDA kernel itself runs only on the card (cuda
marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ao_tpu.ops.pallas.decode_attention import decode_attention as jax_decode_attention

from ao_tpu_torch.ops.hopper import decode_attention as k2
from ao_tpu_torch.quantization.primitives import compute_error

from torch_port_helpers import torch_from_np

B, T, H, HKV, D = 2, 128, 4, 2, 128


def _inputs(seed, b=B, t=T, h=H, hkv=HKV, d=D):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((b, h, d)).astype(np.float32)).astype(jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((b, t, hkv, d)).astype(np.float32)).astype(jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, t, hkv, d)).astype(np.float32)).astype(jnp.bfloat16)
    return q, k, v


def _f32_reference(q, k, v, lengths, sm_scale):
    """Softmax attention in float64 numpy over the bf16 values."""
    q, k, v = (np.asarray(a.astype(jnp.float32), np.float64) for a in (q, k, v))
    b, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    kf = np.repeat(k, rep, axis=2)
    vf = np.repeat(v, rep, axis=2)
    s = np.einsum("bhd,bthd->bht", q, kf) * sm_scale
    mask = np.arange(t)[None, None, :] < np.asarray(lengths)[:, None, None]
    s = np.where(mask, s, -0.7 * np.finfo(np.float32).max)
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bht,bthd->bhd", p, vf)


def _sqnr(a, b):
    return float(compute_error(torch.tensor(np.asarray(a, np.float32)),
                               torch.tensor(np.asarray(b, np.float32))))


def test_plain_matches_pallas_interpret():
    q, k, v = _inputs(2)
    lengths = np.array([100, 37], np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_decode_attention(q, k, v, jnp.asarray(lengths), sm_scale=D ** -0.5,
                                   block_t=128).block_until_ready()
    got = k2.decode_attention(torch_from_np(q), torch_from_np(k), torch_from_np(v),
                              torch.from_numpy(lengths), sm_scale=D ** -0.5)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    # the Pallas kernel rounds p to bf16 before p.V; the port keeps f32 p:
    # the JAX suite's bound for this kernel against its f32 reference
    assert _sqnr(np.asarray(ref), got.numpy()) >= 30


@pytest.mark.parametrize("lengths", [[100, 37], [1, 128], [0, 64]])
def test_plain_matches_f32_reference(lengths):
    q, k, v = _inputs(3)
    got = k2.decode_attention(torch_from_np(q), torch_from_np(k), torch_from_np(v),
                              torch.tensor(lengths, dtype=torch.int32))
    ref = _f32_reference(q, k, v, lengths, D ** -0.5)
    # f32 against f64 over the same bf16 values: f32 rounding only
    assert _sqnr(ref, got.numpy()) >= 100


def test_wrapper_checks_and_counter():
    q, k, v = _inputs(4)
    qt, kt, vt = torch_from_np(q), torch_from_np(k), torch_from_np(v)
    lengths = torch.tensor([5, 6], dtype=torch.int32)
    # scales over an int8 tokens cache without mode="i8" ask for the bf16-q
    # form (the reference's "vec8", K2v), whose wrapper refuses scales that
    # are not (B, Hkv, T)
    with pytest.raises(ValueError, match="K2v.*k_scale must be"):
        k2.decode_attention(qt, kt.to(torch.int8), vt.to(torch.int8), lengths,
                            k_scale=torch.ones(1), v_scale=torch.ones(1))
    with pytest.raises(ValueError, match="not a multiple"):
        k2.decode_attention(qt[:, :3], kt, vt, lengths)
    k2.decode_attention(qt, kt, vt, lengths)
    assert k2.decode_attention.launches == 0
    nbytes, flops = k2.traffic(tuple(qt.shape), tuple(kt.shape), [5, 6])
    assert nbytes == B * H * D * 2 + 2 * 11 * HKV * D * 2 + B * 4 + B * H * D * 4
    assert flops == 4 * 11 * H * D

