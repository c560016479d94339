"""The paged KV cache: the port's ``PagedKVPool`` (bf16, int8, fp8 e4m3 and
int4 pools) and ``PageAllocator`` against the JAX package's bit for bit (the
quantized pools through ``gather``: the port stores int4 pages and the
scales in layouts of its own), K9's plain version in its three modes ("fp",
"vec8", "int4") against the JAX package's Pallas kernel in interpret mode
and its gather reference, and a paged decode step of the model against
JAX's, on the same numpy inputs. The CUDA kernel itself runs only on the
card (cuda marker).
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
    # max per page, the plain version (as K9) against its warp's running max
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
    for name, dt, row in (("int8", torch.int8, 16), ("float8_e4m3fn", torch.float8_e4m3fn, 16),
                          ("int4", torch.int32, 2)):
        pool = tpaged.PagedKVPool.create(4, 8, 2, 16, name, device="cpu")
        assert pool.pages.dtype == dt and pool.pages.shape == (4, 8, 2, row)
        assert pool.scale.shape == (4, 2, 8) and pool.dtype_name == name
    with pytest.raises(ValueError, match="bf16"):
        tpaged.PagedKVPool.create(4, 8, 2, 16, "float16", device="cpu")
    # the reference's refusals: int4 at page_size % 8; e5m2 is a slot cache
    with pytest.raises(ValueError, match="page_size % 8"):
        tpaged.PagedKVPool.create(4, 12, 2, 16, "int4", device="cpu")
    with pytest.raises(ValueError, match="slot cache"):
        tpaged.PagedKVPool.create(4, 8, 2, 16, "float8_e5m2", device="cpu")


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


# -- quantized pools and K9 "vec8" / "int4" ----------------------------------

QUANT = ("int8", "float8_e4m3fn", "int4")


@pytest.mark.parametrize("dtype_name", QUANT)
def test_quantized_pool_ops_bit_equal_jax(dtype_name):
    """write_prompt and append_token (the reference's ``_quant``), then
    ``gather`` in f32 and bf16: JAX's values bit for bit."""
    rng = np.random.default_rng(17)
    ps, n_pages, b, d = 8, 9, 3, 16
    jk = jpaged.PagedKVPool.create(n_pages, ps, HKV, d, dtype_name)
    tk = tpaged.PagedKVPool.create(n_pages, ps, HKV, d, dtype_name, device="cpu")
    x = rng.standard_normal((2 * ps, HKV, d)).astype(np.float32) * 3
    x[3] = 0.0  # an all-zero vector: the scale's 1e-8 floor
    ids = np.array([4, 7], np.int32)
    jk = jk.write_prompt(jnp.asarray(x), jnp.asarray(ids))
    assert tk.write_prompt(torch.from_numpy(x), torch.from_numpy(ids)) is tk
    table = np.array([[4, 7, 0], [2, 0, 0], [5, 6, 1]], np.int32)
    for lengths in ([13, 0, 17], [14, 1, 18], [15, 7, 16]):
        tok = rng.standard_normal((b, HKV, d)).astype(np.float32)
        jk = jk.append_token(jnp.asarray(tok), jnp.asarray(table), jnp.asarray(lengths))
        assert tk.append_token(torch.from_numpy(tok), torch.from_numpy(table),
                               torch.tensor(lengths, dtype=torch.int32)) is tk
    for row in table:
        assert_bit_equal(jk.gather(jnp.asarray(row), jnp.float32),
                         tk.gather(torch.from_numpy(row), torch.float32))
        assert_bit_equal(jk.gather(jnp.asarray(row), jnp.bfloat16),
                         tk.gather(torch.from_numpy(row)))
    # the whole table at once: the rows' gathers stacked
    assert torch.equal(tk.gather(torch.from_numpy(table), torch.float32),
                       torch.stack([tk.gather(torch.from_numpy(r), torch.float32) for r in table]))


def _quant_pools(seed, dtype_name, ps, n_pages, b, h):
    """(JAX's, the port's) K and V quantized pools written by write_prompt
    from the same random values on every page, and q (B, H, D) bf16."""
    rng = np.random.default_rng(seed)
    out = []
    for scale in (2.0, 1.0):
        x = rng.standard_normal((n_pages * ps, HKV, D)).astype(np.float32) * scale
        ids = np.arange(n_pages, dtype=np.int32)
        jp = jpaged.PagedKVPool.create(n_pages, ps, HKV, D, dtype_name).write_prompt(
            jnp.asarray(x), jnp.asarray(ids))
        tp = tpaged.PagedKVPool.create(n_pages, ps, HKV, D, dtype_name, device="cpu")
        tp.write_prompt(torch.from_numpy(x), torch.from_numpy(ids))
        out.append((jp, tp))
    q = jnp.asarray(rng.standard_normal((b, h, D)).astype(np.float32)).astype(jnp.bfloat16)
    return out, q


def _k9(tk, tv, q, table, lengths):
    wrapper = k9.paged_decode_attention_int4 if tk.dtype_name == "int4" \
        else k9.paged_decode_attention_vec8
    return wrapper(q, tk.pages, tk.scale, tv.pages, tv.scale, table, lengths)


@pytest.mark.parametrize("dtype_name", QUANT)
def test_quantized_plain_matches_pallas_interpret(dtype_name):
    """K9 "vec8" / "int4" at page_size 128, the reference's quantized route:
    the plain version against the Pallas kernel in interpret mode, and
    against the JAX gather reference at the JAX suite's bound
    (``tests/test_pallas_interpret.py``)."""
    ((jk, tk), (jv, tv)), q = _quant_pools(9, dtype_name, PS, N_PAGES, B, H)
    table = np.array([[3, 2, 5], [1, 4, 0]], np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_paged_attention(q, jk, jv, jnp.asarray(table),
                                  jnp.asarray(LENGTHS)).block_until_ready()
    got = _k9(tk, tv, torch_from_np(q), torch.from_numpy(table), torch.from_numpy(LENGTHS))
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    # both round p * vs to bf16 before p.V, the Pallas kernel against its
    # running max per page, the plain version (as K9) against its warp's running max
    assert _sqnr(np.asarray(ref), got.numpy()) >= 40
    jref = jpaged.paged_decode_attention_reference(q, jk, jv, jnp.asarray(table),
                                                   jnp.asarray(LENGTHS))
    assert _sqnr(np.asarray(jref), got.numpy()) >= 25


@pytest.mark.parametrize("dtype_name", QUANT)
def test_quantized_plain_matches_gather_reference(dtype_name):
    """At page_size 8, which the reference's kernel refuses for quantized
    pools (its gather path serves it) and the port's K9 takes: the plain
    version against JAX's gather reference, and the port's gather
    reference against JAX's."""
    ps, n_pages, b, h = 8, 40, 3, 8
    ((jk, tk), (jv, tv)), q = _quant_pools(10, dtype_name, ps, n_pages, b, h)
    rng = np.random.default_rng(10)
    table = rng.permutation(np.arange(1, n_pages)).astype(np.int32)[:b * 12].reshape(b, 12)
    lengths = np.array([96, 1, 57], np.int32)
    for i, n in enumerate(lengths):
        table[i, -(-n // ps):] = 0
    args = (jnp.asarray(table), jnp.asarray(lengths))
    jref = jpaged.paged_decode_attention_reference(q, jk, jv, *args)
    got = _k9(tk, tv, torch_from_np(q), torch.from_numpy(table), torch.from_numpy(lengths))
    assert _sqnr(np.asarray(jref), got.numpy()) >= 25
    tref = tpaged.paged_decode_attention_reference(torch_from_np(q), tk, tv,
                                                   torch.from_numpy(table),
                                                   torch.from_numpy(lengths))
    assert _sqnr(np.asarray(jref), tref.numpy()) >= 100
    # the dispatch takes the gather reference on the CPU
    assert torch.equal(tpaged.paged_attention(torch_from_np(q), tk, tv, torch.from_numpy(table),
                                              torch.from_numpy(lengths)), tref)


@pytest.mark.parametrize("dtype_name", QUANT)
def test_quantized_plain_never_reads_past_lengths(dtype_name):
    """NaN in the values (an fp8 0x7F) and scales of positions at or past
    lengths, and in the null page a block-table row ends in, never reaches
    the output; lengths 0 gives 0."""
    ((_, tk), (_, tv)), q = _quant_pools(11, dtype_name, PS, N_PAGES, B, H)
    q = torch_from_np(q)
    table = torch.tensor([[3, 2, 4], [1, 5, 0]], dtype=torch.int32)
    lengths = torch.tensor([200, 0], dtype=torch.int32)
    got = _k9(tk, tv, q, table, lengths)
    table[0, 2] = 0
    for pool in (tk, tv):
        raw = pool.pages.view(torch.uint8)
        raw[0], raw[2, 72:] = 0x7F, 0x7F  # fp8 NaN; any bytes for int8 and int4
        pool.scale[0], pool.scale[2, :, 72:] = float("nan"), float("nan")
    again = _k9(tk, tv, q, table, lengths)
    assert torch.equal(again, got) and float(got[1].abs().max()) == 0.0
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("dtype_name", QUANT)
def test_quantized_wrappers_check_and_count(dtype_name):
    ((_, tk), (_, tv)), q = _quant_pools(12, dtype_name, PS, N_PAGES, B, H)
    qt, table, lengths = torch_from_np(q), torch.from_numpy(TABLE), torch.from_numpy(LENGTHS)
    wrapper = k9.paged_decode_attention_int4 if dtype_name == "int4" \
        else k9.paged_decode_attention_vec8
    before = wrapper.launches
    wrapper(qt, tk.pages, tk.scale, tv.pages, tv.scale, table, lengths)
    assert wrapper.launches == before  # the CPU runs no kernel
    with pytest.raises(ValueError, match="head_dim 128"):
        wrapper(qt[..., :64], tk.pages, tk.scale, tv.pages, tv.scale, table, lengths)
    with pytest.raises(ValueError, match="v_scale must be"):
        wrapper(qt, tk.pages, tk.scale, tv.pages, tv.scale[:, :, :64], table, lengths)
    with pytest.raises(ValueError, match="k_scale must be"):
        wrapper(qt, tk.pages, None, tv.pages, tv.scale, table, lengths)
    with pytest.raises(ValueError, match="k_pages must be"):
        k9.paged_decode_attention_vec8(qt, tk.pages.float(), tk.scale, tv.pages, tv.scale, table,
                                       lengths)
    nbytes, flops = k9.traffic((B, H, D), tuple(tk.pages.shape), 3, [300, 150], dtype_name)
    row = D // 2 if dtype_name == "int4" else D
    assert nbytes == B * H * D * 2 + 2 * 450 * HKV * (row + 4) + (3 + 2) * 4 + B * 4 \
        + B * H * D * 4
    assert flops == 4 * 450 * H * D
