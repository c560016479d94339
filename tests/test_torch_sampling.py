"""Sampling: the port's ``serving/sampling.py`` against the JAX package's on
the same numpy logits. Greedy picks and the context penalties are equal bit
for bit; sampled picks come from other random streams, so they are held to
JAX's by their support: every token JAX draws over 4096 keys lies in the
port's kept set (``filtered_logits``), and every kept token of probability
above 1e-3 is among JAX's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ao_tpu.serving import sampling as jsampling

from ao_tpu_torch.serving import sampling as tsampling

V = 64
N_KEYS = 4096


def _logits(seed, b):
    return (np.random.default_rng(seed).standard_normal((b, V)) * 2.0).astype(np.float32)


def _jax_draws(logits, temps, top_ks, top_ps, min_ps):
    """(N_KEYS, B) tokens of JAX's batched sampler, one key each."""
    keys = jax.random.split(jax.random.PRNGKey(0), N_KEYS)
    draw = jax.vmap(lambda k: jsampling.sample_logits_batched(
        jnp.asarray(logits), k, jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps),
        jnp.asarray(min_ps)))
    return np.asarray(draw(keys))


ROWS = dict(  # per row: greedy, temperature only, top-k, top-p, min-p, all four
    temps=np.array([0.0, 0.8, 1.0, 1.3, 0.7, 0.9], np.float32),
    top_ks=np.array([0, 0, 5, 0, 0, 12], np.int32),
    top_ps=np.array([1.0, 1.0, 1.0, 0.8, 1.0, 0.9], np.float32),
    min_ps=np.array([0.0, 0.0, 0.0, 0.0, 0.05, 0.02], np.float32),
)


def test_greedy_rows_equal_jax():
    logits = _logits(0, 6)
    args = [ROWS[k] for k in ("temps", "top_ks", "top_ps", "min_ps")]
    want = np.asarray(jsampling.sample_logits_batched(
        jnp.asarray(logits), jax.random.PRNGKey(1), *map(jnp.asarray, args)))
    gen = torch.Generator().manual_seed(1)
    got = tsampling.sample_logits_batched(torch.from_numpy(logits), gen, *args)
    assert got.dtype == torch.int32 and got.shape == (6,)
    greedy = ROWS["temps"] == 0
    np.testing.assert_array_equal(got.numpy()[greedy], want[greedy])
    # every row greedy: no draw at all (the generator is untouched), the
    # first maximum as jnp.argmax picks it
    tied = logits.copy()
    tied[:, 7] = tied[:, 3] = tied.max() + 1
    zeros = np.zeros(6, np.float32)
    state = gen.get_state()
    got = tsampling.sample_logits_batched(torch.from_numpy(tied), gen, zeros,
                                          np.zeros(6, np.int32), np.ones(6, np.float32))
    want = jsampling.sample_logits_batched(jnp.asarray(tied), jax.random.PRNGKey(1),
                                           jnp.asarray(zeros), jnp.zeros(6, jnp.int32),
                                           jnp.ones(6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 3).all() and torch.equal(gen.get_state(), state)


def test_top_k_1_and_min_p_1_are_argmax():
    logits = torch.from_numpy(_logits(1, 6))
    argmax = torch.argmax(logits, dim=-1).to(torch.int32)
    gen = torch.Generator().manual_seed(2)
    ones = np.ones(6, np.float32)
    for _ in range(8):
        assert torch.equal(tsampling.sample_logits_batched(
            logits, gen, ones, np.ones(6, np.int32), ones), argmax)
        assert torch.equal(tsampling.sample_logits_batched(
            logits, gen, ones, np.zeros(6, np.int32), ones, ones), argmax)
        assert torch.equal(tsampling.sample_logits(logits, gen, 0.9, top_k=1), argmax)
        assert torch.equal(tsampling.sample_logits(logits, gen, 0.9, min_p=1.0), argmax)


def test_sampled_rows_have_jax_support():
    logits = _logits(2, 6)
    args = [ROWS[k] for k in ("temps", "top_ks", "top_ps", "min_ps")]
    draws = _jax_draws(logits, *args)
    kept = tsampling.filtered_logits(torch.from_numpy(logits),
                                     *(torch.from_numpy(a) for a in args))
    probs = torch.softmax(kept, dim=-1).numpy()
    kept = torch.isfinite(kept).numpy()
    for row in range(1, 6):  # row 0 is greedy
        seen = set(draws[:, row].tolist())
        assert seen <= set(np.flatnonzero(kept[row]).tolist()), row
        assert set(np.flatnonzero(probs[row] > 1e-3).tolist()) <= seen, row
    # the filters cut: top-k 5 keeps 5 tokens, top-p and min-p fewer than V
    assert kept[2].sum() == 5 and kept[3].sum() < V and kept[4].sum() < V
    # the port's own draws stay in the kept set
    gen = torch.Generator().manual_seed(3)
    for _ in range(64):
        tok = tsampling.sample_logits_batched(torch.from_numpy(logits), gen, *args).numpy()
        assert all(kept[r, tok[r]] for r in range(6))


def test_sample_logits_has_jax_support():
    logits = _logits(3, 1)[0] * 0.5
    keys = jax.random.split(jax.random.PRNGKey(4), N_KEYS)
    want = set(np.asarray(jax.vmap(lambda k: jsampling.sample_logits(
        jnp.asarray(logits), k, 1.2, top_k=6, top_p=0.9))(keys)).tolist())
    gen = torch.Generator().manual_seed(4)
    got = set(tsampling.sample_logits(torch.from_numpy(logits).expand(N_KEYS, V), gen, 1.2,
                                      top_k=6, top_p=0.9).tolist())
    assert got == want and 1 < len(got) <= 6


def test_apply_penalties_bit_equal_jax():
    rng = np.random.default_rng(5)
    b = 4
    logits = _logits(5, b)
    rep = np.array([1.0, 1.3, 0.8, 1.1], np.float32)
    freq = np.array([0.0, 0.5, 0.25, 0.1], np.float32)
    pres = np.array([0.0, 0.7, 1.5, 0.3], np.float32)
    prompt_pres = (rng.random((b, V)) < 0.2).astype(np.int8)
    out_counts = rng.integers(0, 4, (b, V)).astype(np.int32)
    bias = (rng.standard_normal((b, V)) * (rng.random((b, V)) < 0.1)).astype(np.float32)
    for with_bias in (False, True):
        jargs = [jnp.asarray(a) for a in (logits, rep, freq, pres, prompt_pres, out_counts)]
        targs = [torch.from_numpy(a) for a in (logits, rep, freq, pres, prompt_pres, out_counts)]
        want = np.asarray(jsampling.apply_penalties(*jargs, jnp.asarray(bias) if with_bias
                                                    else None))
        got = tsampling.apply_penalties(*targs, torch.from_numpy(bias) if with_bias else None)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def tiny_model():
    from ao_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=96, dim=64, n_layers=1, n_heads=4, n_kv_heads=2,
                            ffn_dim=128, tie_embeddings=True, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return params, cfg


def test_generate_sampling_repeats_for_a_seed(tiny_model):
    import ao_tpu_torch

    params, cfg = tiny_model
    prompt = torch.randint(0, cfg.vocab_size, (3, 5), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)

    def run(generator=None, **kw):
        return ao_tpu_torch.generate(params, prompt, cfg, 8, 16, temperature=1.0,
                                     generator=generator, **kw)

    a = run(torch.Generator().manual_seed(7), top_k=20, top_p=0.95)
    assert a.shape == (3, 8) and a.dtype == torch.int32
    assert torch.equal(a, run(torch.Generator().manual_seed(7), top_k=20, top_p=0.95))
    # no generator: one seeded 0 on the prompt's device
    assert torch.equal(run(), run(torch.Generator().manual_seed(0)))
    assert not torch.equal(run(torch.Generator().manual_seed(8)), run())
    greedy = ao_tpu_torch.generate(params, prompt, cfg, 8, 16)
    assert torch.equal(run(top_k=1), greedy)
