"""The paged KV cache: the port's ``PagedKVPool`` and ``PageAllocator``
against the JAX package's bit for bit, K9's plain version (paged decode
attention over a bf16 pool) against the JAX package's Pallas kernel in
interpret mode and its gather reference, and a paged decode step of the
model against JAX's, on the same numpy inputs. The CUDA kernel itself runs
only on the card (cuda marker).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ao_tpu.ops.pallas.paged_attention import paged_decode_attention as jax_paged_attention
from ao_tpu.serving import paged as jpaged

from ao_tpu_torch.ops import kernels as tkernels
from ao_tpu_torch.ops.hopper import paged_attention as k9
from ao_tpu_torch.quantization.primitives import compute_error
from ao_tpu_torch.serving import paged as tpaged

from torch_port_helpers import assert_bit_equal, torch_from_np

B, H, HKV, D, PS, N_PAGES = 2, 4, 2, 128, 128, 6
TABLE = np.array([[0, 2, 4], [1, 3, 5]], np.int32)
LENGTHS = np.array([300, 150], np.int32)


def _pools(seed):
    """(JAX's, the port's) K and V bf16 pools with the same random pages,
    and q (B, H, D) bf16."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        pages = jnp.asarray(rng.standard_normal((N_PAGES, PS, HKV, D)).astype(np.float32))
        jp = dataclasses.replace(jpaged.PagedKVPool.create(N_PAGES, PS, HKV, D),
                                 pages=pages.astype(jnp.bfloat16))
        tp = tpaged.PagedKVPool.create(N_PAGES, PS, HKV, D, device="cpu")
        tp.pages.copy_(torch_from_np(jp.pages))
        out.append((jp, tp))
    q = jnp.asarray(rng.standard_normal((B, H, D)).astype(np.float32)).astype(jnp.bfloat16)
    return out, q


def _sqnr(a, b):
    return float(compute_error(torch.tensor(np.asarray(a, np.float32)),
                               torch.tensor(np.asarray(b, np.float32))))


def test_plain_matches_pallas_interpret():
    ((jk, tk), (jv, tv)), q = _pools(5)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_paged_attention(q, jk, jv, jnp.asarray(TABLE),
                                  jnp.asarray(LENGTHS)).block_until_ready()
    got = k9.paged_decode_attention(torch_from_np(q), tk.pages, tv.pages,
                                    torch.from_numpy(TABLE), torch.from_numpy(LENGTHS))
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    # both round p to bf16 before p.V, the Pallas kernel against its running
    # max per page, the plain version (as K9) against its split's max
    assert _sqnr(np.asarray(ref), got.numpy()) >= 40
    # the JAX suite's bound against the gather reference (f32 q, f32 p)
    jref = jpaged.paged_decode_attention_reference(q, jk, jv, jnp.asarray(TABLE),
                                                   jnp.asarray(LENGTHS))
    assert _sqnr(np.asarray(jref), got.numpy()) >= 25
    # the port's gather reference is JAX's, in f32
    tref = tpaged.paged_decode_attention_reference(torch_from_np(q), tk, tv,
                                                   torch.from_numpy(TABLE),
                                                   torch.from_numpy(LENGTHS))
    assert _sqnr(np.asarray(jref), tref.numpy()) >= 100


def test_plain_never_reads_past_lengths():
    """Positions at or past lengths, and the null page a block-table row
    ends in, never reach the output; lengths 0 gives 0."""
    ((_, tk), (_, tv)), q = _pools(6)
    q = torch_from_np(q)
    table = torch.tensor([[3, 2, 4], [1, 5, 0]], dtype=torch.int32)
    lengths = torch.tensor([200, 0], dtype=torch.int32)
    got = k9.paged_decode_attention(q, tk.pages, tv.pages, table, lengths)
    table[0, 2] = 0
    tk.pages[0], tv.pages[0] = float("nan"), float("nan")
    tk.pages[2, 72:], tv.pages[2, 72:] = float("nan"), float("nan")
    again = k9.paged_decode_attention(q, tk.pages, tv.pages, table, lengths)
    assert torch.equal(again, got) and float(got[1].abs().max()) == 0.0


def test_pool_ops_bit_equal_jax():
    """append_token, write_prompt and gather: the same pages as JAX's."""
    rng = np.random.default_rng(7)
    ps, n_pages, b = 8, 9, 3
    jk = jpaged.PagedKVPool.create(n_pages, ps, HKV, 16)
    tk = tpaged.PagedKVPool.create(n_pages, ps, HKV, 16, device="cpu")
    x = rng.standard_normal((2 * ps, HKV, 16)).astype(np.float32)
    ids = np.array([4, 7], np.int32)
    jk = jk.write_prompt(jnp.asarray(x), jnp.asarray(ids))
    assert tk.write_prompt(torch.from_numpy(x), torch.from_numpy(ids)) is tk
    assert_bit_equal(jk.pages, tk.pages)
    table = np.array([[4, 7, 0], [2, 0, 0], [5, 6, 1]], np.int32)
    for lengths in ([13, 0, 17], [14, 1, 18], [15, 7, 16]):
        tok = rng.standard_normal((b, HKV, 16)).astype(np.float32)
        jk = jk.append_token(jnp.asarray(tok), jnp.asarray(table), jnp.asarray(lengths))
        assert tk.append_token(torch.from_numpy(tok), torch.from_numpy(table),
                               torch.tensor(lengths, dtype=torch.int32)) is tk
    assert_bit_equal(jk.pages, tk.pages)
    for row in table:
        got = tk.gather(torch.from_numpy(row))
        assert_bit_equal(jk.gather(jnp.asarray(row), jnp.bfloat16), got)
        assert_bit_equal(jk.gather(jnp.asarray(row), jnp.float32), got.to(torch.float32))


def test_allocator_and_pool_checks():
    ja, ta = jpaged.PageAllocator(5), tpaged.PageAllocator(5)
    seq = [ja.alloc() for _ in range(3)]
    assert [ta.alloc() for _ in range(3)] == seq
    ja.release([seq[1], 0])
    ta.release([seq[1], 0])
    assert ta.free == ja.free and ta.alloc() == ja.alloc()
    ta.alloc()
    with pytest.raises(RuntimeError, match="exhausted"):
        ta.alloc()
    for name in ("int8", "float8_e4m3fn", "int4"):
        with pytest.raises(NotImplementedError, match="quantized-pool slice"):
            tpaged.PagedKVPool.create(4, 8, 2, 16, name, device="cpu")
    with pytest.raises(ValueError, match="bf16"):
        tpaged.PagedKVPool.create(4, 8, 2, 16, "float16", device="cpu")


def test_wrapper_checks_counter_and_traffic():
    ((_, tk), (_, tv)), q = _pools(8)
    qt, table = torch_from_np(q), torch.from_numpy(TABLE)
    lengths = torch.from_numpy(LENGTHS)
    with pytest.raises(ValueError, match="head_dim 128"):
        k9.paged_decode_attention(qt[..., :64], tk.pages[..., :64], tv.pages[..., :64], table,
                                  lengths)
    with pytest.raises(ValueError, match="at most 8"):
        k9.paged_decode_attention(qt.repeat(1, 5, 1), tk.pages, tv.pages, table, lengths)
    with pytest.raises(ValueError, match="bf16"):
        k9.paged_decode_attention(qt, tk.pages.float(), tv.pages, table, lengths)
    with pytest.raises(ValueError, match="B=2 rows"):
        k9.paged_decode_attention(qt, tk.pages, tv.pages, table[:1], lengths)
    k9.paged_decode_attention(qt, tk.pages, tv.pages, table, lengths)
    assert k9.paged_decode_attention.launches == 0
    nbytes, flops = k9.traffic((B, H, D), tuple(tk.pages.shape), 3, [300, 150])
    assert nbytes == B * H * D * 2 + 2 * 450 * HKV * D * 2 + (3 + 2) * 4 + B * 4 + B * H * D * 4
    assert flops == 4 * 450 * H * D
    # the dispatch takes the gather reference on the CPU, and K9's route
    # otherwise only on CUDA tensors
    with tkernels.backend("torch"):
        a = tpaged.paged_attention(qt, tk, tv, table, lengths)
    b = tpaged.paged_attention(qt, tk, tv, table, lengths)
    assert torch.equal(a, b) and k9.paged_decode_attention.launches == 0


def test_paged_decode_step_matches_jax():
    """A prefill written into pages, then one paged decode step of the model
    (head_dim 128) against JAX's: both take the gather path on the CPU."""
    from ao_tpu.models import llama as jllama

    from ao_tpu_torch.models import llama as tllama

    from torch_port_helpers import jax_to_torch

    jcfg = jllama.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                              ffn_dim=512, tie_embeddings=False, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                              ffn_dim=512, tie_embeddings=False, dtype=torch.float32)
    jp = jllama.init_params(jax.random.PRNGKey(5), jcfg)
    tp = jax_to_torch(jp)
    rng = np.random.default_rng(5)
    ps, s = 8, np.array([11, 13])
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    table = np.array([[3, 1, 0], [2, 4, 0]], np.int32)
    jforward = jax.jit(jllama.forward, static_argnames=("cfg",))

    jpools = [(jpaged.PagedKVPool.create(6, ps, 1, 128), jpaged.PagedKVPool.create(6, ps, 1, 128))
              for _ in range(2)]
    tpools = [(tpaged.PagedKVPool.create(6, ps, 1, 128, device="cpu"),
               tpaged.PagedKVPool.create(6, ps, 1, 128, device="cpu")) for _ in range(2)]
    for i in range(2):  # each sequence's prefill through a scratch cache, into its pages
        n_pg = -(-int(s[i]) // ps)
        jc = jllama.init_kv_caches(jcfg, 1, n_pg * ps)
        _, jc = jforward(jp, jnp.asarray(toks[i:i + 1, :n_pg * ps]), cfg=jcfg, kv_caches=jc,
                         cache_index=0)
        tc = tllama.init_kv_caches(tcfg, 1, n_pg * ps, device="cpu")
        _, tc = tllama.forward(tp, torch.from_numpy(toks[i:i + 1, :n_pg * ps]), tcfg,
                               kv_caches=tc, cache_index=0)
        ids = table[i, :n_pg]
        jpools = [(kp.write_prompt(sk[0], jnp.asarray(ids)), vp.write_prompt(sv[0], jnp.asarray(ids)))
                  for (kp, vp), (sk, sv) in zip(jpools, jc)]
        for (kp, vp), (sk, sv) in zip(tpools, tc):
            kp.write_prompt(sk[0], torch.from_numpy(ids))
            vp.write_prompt(sv[0], torch.from_numpy(ids))
    cur = toks[np.arange(2), s][:, None]
    jl, _ = jforward(jp, jnp.asarray(cur), cfg=jcfg, positions=jnp.asarray(s[:, None]),
                     kv_caches=jpools, cache_index=(jnp.asarray(table), jnp.asarray(s)))
    tl, tpools = tllama.forward(tp, torch.from_numpy(cur), tcfg,
                                positions=torch.from_numpy(s[:, None].astype(np.int32)),
                                kv_caches=tpools, cache_index=(torch.from_numpy(table),
                                                               torch.from_numpy(s.astype(np.int32))))
    assert tl.shape == (2, 1, 256)
    assert _sqnr(np.asarray(jl), tl.numpy()) >= 60
    with pytest.raises(ValueError, match="single-token"):
        tllama.forward(tp, torch.from_numpy(toks[:, :2]), tcfg, kv_caches=tpools,
                       cache_index=(torch.from_numpy(table), torch.from_numpy(s.astype(np.int32))))
