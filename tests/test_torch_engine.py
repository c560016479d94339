"""The port's serving ``Engine`` against the JAX package's, on
``tests/test_engine.py``'s tiny config (dim 64, head_dim 16, two layers), in
f32 and int4 weight-only (group 32), in both KV layouts (page_size 8), with
bucket (8,) and max_seq 64: the greedy tokens of every request, their
finish reasons and ``stats()`` equal JAX's, under the default backend and
the "torch" one. The scenario has more requests than slots, staggered
submission, prompts longer than the bucket (chunked prefill), an eos stop,
a stop sequence and two cancellations. The same scenario runs over the
quantized KV caches (``kv_quant``) in f32 in both layouts. The JAX engines
run their XLA path on the CPU, once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu
from ao_tpu.models import llama as jllama
from ao_tpu.serving.engine import Engine as JEngine
from ao_tpu.serving.engine import ServeConfig as JServeConfig

import ao_tpu_torch
from ao_tpu_torch.models import llama as tllama
from ao_tpu_torch.ops import kernels as tkernels
from ao_tpu_torch.serving.engine import Engine, ServeConfig

from torch_port_helpers import jax_to_torch

JCFG = jllama.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=128, tie_embeddings=True, dtype=jnp.float32)
TCFG = tllama.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=128, tie_embeddings=True, dtype=torch.float32)
MAX_BATCH, MAX_SEQ, BUCKETS, PAGE = 2, 64, (8,), 8

_rng = np.random.default_rng(4)
# (prompt, max_new_tokens): more requests than slots; two prompts longer
# than the bucket take the chunked prefill
REQUESTS = [(list(map(int, _rng.integers(0, 128, n))), m)
            for n, m in ((3, 6), (2, 9), (4, 5), (12, 7), (1, 8), (5, 6), (20, 4), (6, 10))]
FIRST = 2  # submitted before the first two steps, the rest after them
CANCEL_AT = {4: (5,), 6: (3,)}  # after step i, cancel these uids (queued, in flight)


def _layout(paged):
    return dict(kv_layout="paged", page_size=PAGE) if paged else {}


def _drive(engine, stop=None):
    """Submit REQUESTS (the first FIRST, two steps, then the rest, the
    request ``stop`` names with its stop sequence), cancel per CANCEL_AT,
    run to the end; returns [(uid, tokens, finish reason)] and stats()."""
    def submit(uid):
        prompt, m = REQUESTS[uid]
        seq = stop[1] if stop is not None and stop[0] == uid else None
        assert engine.submit(prompt, m, stop=seq) == uid

    for uid in range(FIRST):
        submit(uid)
    steps = 0
    for _ in range(2):
        engine.step()
        steps += 1
    for uid in range(FIRST, len(REQUESTS)):
        submit(uid)
    done = []
    while engine._queue or any(s is not None for s in engine._slots):
        engine.step()
        steps += 1
        for uid in CANCEL_AT.get(steps, ()):
            assert engine.cancel(uid)
        done += engine.run(max_steps=0)
    done += engine.run(max_steps=0)
    assert not engine.cancel(0)  # finished: unknown to cancel
    return sorted((r.uid, list(r.generated), r.finish_reason) for r in done), engine.stats()


def _choose_stops(tokens):
    """From the greedy tokens of a run without stops: an eos id that request
    0 generates first at some index >= 1 (so it stops there), and a stop
    sequence of request 1's tokens 1..2 that holds no eos."""
    t0, t1 = tokens[0], tokens[1]
    for j in range(1, len(t0)):
        eos = t0[j]
        if eos not in t0[:j] and eos not in t1[:3]:
            return eos, (1, t1[1:3])
    raise AssertionError(f"no eos candidate in {t0}")


@pytest.fixture(scope="module")
def runs():
    """Per (weights, layout): the stop settings and JAX's results."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    jq = ao_tpu.quantize_(jp, ao_tpu.Int4WeightOnlyConfig(group_size=32))
    out = {}
    for kind, params in (("f32", jp), ("int4", jq)):
        tp = jax_to_torch(params)
        # the stop settings come from the port's own greedy tokens without
        # them (the comparison below holds them to JAX's)
        with tkernels.backend("torch"):
            free, _ = _drive(Engine(tp, TCFG, ServeConfig(MAX_BATCH, MAX_SEQ,
                                                          prefill_buckets=BUCKETS),
                                    device="cpu"))
        eos, stop = _choose_stops([toks for _, toks, _ in free])
        for paged in (False, True):
            eng = JEngine(params, JCFG, JServeConfig(MAX_BATCH, MAX_SEQ, eos_id=eos,
                                                     prefill_buckets=BUCKETS, **_layout(paged)))
            out[kind, paged] = (tp, free, eos, stop, _drive(eng, stop=stop))
    return out


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
@pytest.mark.parametrize("kind", ["f32", "int4"])
def test_engine_matches_jax(runs, kind, paged, backend):
    tp, free, eos, stop, (want, want_stats) = runs[kind, paged]
    with tkernels.backend(backend):
        eng = Engine(tp, TCFG, ServeConfig(MAX_BATCH, MAX_SEQ, eos_id=eos,
                                           prefill_buckets=BUCKETS, **_layout(paged)),
                     device="cpu")
        got, stats = _drive(eng, stop=stop)
    assert got == want
    assert stats == want_stats
    reasons = {uid: reason for uid, _, reason in got}
    # the eos stop, and the stop sequence trimmed from the output
    assert reasons[0] == "stop" and got[0][1] == free[0][1][:free[0][1].index(eos) + 1]
    assert reasons[1] == "stop" and got[1][1] == free[1][1][:1]
    assert reasons[3] == reasons[5] == "cancelled"
    assert "length" in reasons.values()


KV_QUANT = [("int8", False), ("int8", True), ("float8_e4m3fn", False),
            ("float8_e4m3fn", True), ("int4", False), ("int4", True), ("float8_e5m2", False)]
# the cases whose greedy tokens may leave JAX's at a near-tie (see below)
KV_NEAR_TIE = {("int4", True)}
KV_LOGITS_DB = 40.0  # logits up to the first differing token (int4 paged: 45.8 dB)
NEAR_TIE = 0.1  # JAX's logit gap at a flip, as a share of the std of its logits row (0.04)


@pytest.fixture(scope="module")
def kv_runs(runs):
    """Per (kv_quant, layout): JAX's results of the f32 engine over that
    quantized KV cache, with the f32 run's stop settings, and the logits of
    its every pick (recorded from inside its jitted programs)."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    _, _, eos, stop, _ = runs["f32", False]
    out = {}
    for kv, paged in KV_QUANT:
        eng = JEngine(jp, JCFG, JServeConfig(MAX_BATCH, MAX_SEQ, kv_quant=kv, eos_id=eos,
                                             prefill_buckets=BUCKETS, **_layout(paged)))
        picks, pick2 = [], eng._pick2

        def record(logits, *args, _picks=picks, _pick2=pick2, **kw):
            jax.debug.callback(lambda x: _picks.append(np.asarray(x)), logits, ordered=True)
            return _pick2(logits, *args, **kw)

        eng._pick2 = record
        out[kv, paged] = _drive(eng, stop=stop), picks
    return out


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("kv_quant,paged", KV_QUANT,
                         ids=[f"{kv}-{'paged' if p else 'slots'}" for kv, p in KV_QUANT])
def test_engine_kv_quant_matches_jax(runs, kv_runs, kv_quant, paged, backend):
    """The quantized KV in each layout: a slot engine prefills into a
    quantized scratch cache and copies it into its slot, a paged engine
    prefills into a bf16 scratch and quantizes it into its pages, as JAX's
    do; so the port is held to JAX per layout.

    The logits of every pick, on the rows that decode, are JAX's within
    KV_LOGITS_DB up to the first token that differs. Where none differs
    (every case but int4 paged), the greedy tokens, finish reasons and
    stats() are JAX's. The port quantizes as the reference's code reads,
    amax / qmax (bit for bit with JAX outside jit, test_torch_paged.py);
    JAX's jitted engine computes amax * (1 / qmax), a scale one ulp off,
    and an int4 cache turns such ulps into whole steps: on int4 pages a
    token flips at a near-tie (JAX's two logits 0.04 std apart), and the
    engines part from there. A flip elsewhere, or not at a near-tie,
    fails."""
    tp, _, eos, stop, _ = runs["f32", False]
    (want, want_stats), jax_picks = kv_runs[kv_quant, paged]
    with tkernels.backend(backend):
        eng = Engine(tp, TCFG, ServeConfig(MAX_BATCH, MAX_SEQ, kv_quant=kv_quant, eos_id=eos,
                                           prefill_buckets=BUCKETS, **_layout(paged)),
                     device="cpu")
        picks, pick = [], eng._pick

        def record(logits, samp):
            rows = eng.active.copy() if logits.shape[0] > 1 else np.ones(1, bool)
            picks.append((logits.float().numpy().copy(), rows))
            return pick(logits, samp)

        eng._pick = record
        got, stats = _drive(eng, stop=stop)
    assert len(picks) >= len(want) and len(jax_picks) >= len(want)
    err = ref = 0.0
    flip = None
    for i, (j, (t, rows)) in enumerate(zip(jax_picks, picks)):
        j, t = j[rows], t[rows]  # idle lanes decode garbage in both
        err, ref = err + float(((j - t) ** 2).sum()), ref + float((j ** 2).sum())
        a, b = j.argmax(-1), t.argmax(-1)
        if (a != b).any():
            r = int(np.nonzero(a != b)[0][0])
            flip = (i, float(j[r, a[r]] - j[r, b[r]]) / float(j[r].std()))
            break
    assert 10 * np.log10(ref / max(err, 1e-30)) >= KV_LOGITS_DB
    if flip is None:
        assert got == want
        assert stats == want_stats
        assert {reason for _, _, reason in got} >= {"cancelled", "length"}
    else:
        assert (kv_quant, paged) in KV_NEAR_TIE, f"token flip at pick {flip[0]}"
        assert flip[1] <= NEAR_TIE, f"not a near-tie: gap {flip[1]:.3f} std"


@pytest.mark.parametrize("kind", ["f32", "int4"])
def test_slot_and_paged_engines_agree(runs, kind):
    tp, _, eos, stop, _ = runs[kind, False]
    results = []
    for paged in (False, True):
        eng = Engine(tp, TCFG, ServeConfig(MAX_BATCH, MAX_SEQ, eos_id=eos, prefill_buckets=BUCKETS,
                                           **_layout(paged)), device="cpu")
        results.append(_drive(eng, stop=stop)[0])
    assert results[0] == results[1]


def test_finished_slot_writes_to_the_null_page(runs):
    """A finished slot keeps decoding as a masked lane. The reference leaves
    its block-table row pointing at the pages it released
    (``ao_tpu/serving/engine.py`` ``_finish``), so with the queue empty its
    writes land in a page that another request grows into, and JAX's paged
    engine leaves its own slot engine's tokens. The port points the row at
    the null page: its paged tokens stay the slot layout's and JAX's."""
    tp = runs["f32", False][0]
    reqs = [([3, 17, 42], 4), ([5, 6, 7, 8, 9], 30)]

    def drive(eng):
        for p, m in reqs:
            eng.submit(p, m)
        return [r.generated for r in eng.run()]

    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    want = drive(JEngine(jp, JCFG, JServeConfig(MAX_BATCH, MAX_SEQ, prefill_buckets=BUCKETS)))
    eng = Engine(tp, TCFG, ServeConfig(MAX_BATCH, MAX_SEQ, prefill_buckets=BUCKETS,
                                       **_layout(True)), device="cpu")
    assert drive(eng) == want
    assert not eng._table_host.any() and eng.stats()["pages_free"] == eng.stats()["pages_total"]


def test_engine_sampling_overrides_and_seed(runs):
    """Per-request sampling overrides: a greedy request beside a sampled one
    keeps its greedy tokens; the same seed repeats the sampled tokens."""
    tp = runs["f32", False][0]
    prompt = REQUESTS[0][0]

    def drive(seed, greedy_too=True):
        eng = Engine(tp, TCFG, ServeConfig(MAX_BATCH, MAX_SEQ, prefill_buckets=BUCKETS,
                                           temperature=1.0, top_k=16, top_p=0.9, seed=seed),
                     device="cpu")
        eng.submit(prompt, 8)
        if greedy_too:
            eng.submit(prompt, 8, temperature=0.0)
        return [r.generated for r in eng.run()]

    a, b = drive(0), drive(0)
    assert a == b and all(len(t) == 8 and all(0 <= x < 128 for x in t) for t in a)
    greedy = Engine(tp, TCFG, ServeConfig(MAX_BATCH, MAX_SEQ, prefill_buckets=BUCKETS),
                    device="cpu")
    greedy.submit(prompt, 8)
    assert a[1] == greedy.run()[0].generated
    assert any(drive(seed, greedy_too=False)[0] != a[0] for seed in (1, 2, 3))


def test_engine_checks():
    tp = jax_to_torch(jllama.init_params(jax.random.PRNGKey(0), JCFG))

    def engine(**kw):
        return Engine(tp, TCFG, ServeConfig(MAX_BATCH, MAX_SEQ, prefill_buckets=BUCKETS, **kw),
                      device="cpu")

    for kw, what in (({"prefix_cache": True}, "prefix"),
                     ({"decode_steps_per_call": 2}, "multi-step"),
                     ({"spec_draft": 2}, "speculative"), ({"penalties": True}, "penalties"),
                     ({"logprobs": 2}, "logprob")):
        with pytest.raises(NotImplementedError, match=what):
            engine(**kw)
    # the quantized KV in both layouts; e5m2 only in slots (the reference
    # fails later, on a KeyError in its page pool)
    assert engine(kv_quant="int8").caches[0][0].dtype_name == "int8"
    assert engine(kv_quant="int4", kv_layout="paged", page_size=8).caches[0][0].dtype_name \
        == "int4"
    with pytest.raises(ValueError, match="slot layout only"):
        engine(kv_quant="float8_e5m2", kv_layout="paged", page_size=8)
    with pytest.raises(ValueError, match="KV cache dtype"):
        engine(kv_quant="float16")
    with pytest.raises(NotImplementedError, match="LoRA"):
        Engine(tp, TCFG, ServeConfig(), lora_adapters={"a": {}}, device="cpu")
    with pytest.raises(ValueError, match="penalties=True"):
        engine(repetition_penalty=1.2)
    with pytest.raises(ValueError, match="multiples of page_size"):
        engine(kv_layout="paged", page_size=16)
    eng = engine()
    with pytest.raises(NotImplementedError, match="logprob"):
        eng.submit([1, 2], 4, logprobs=1)
    with pytest.raises(NotImplementedError, match="logit bias"):
        eng.submit([1, 2], 4, logit_bias={3: 1.0})
    with pytest.raises(ValueError, match="penalties=True"):
        eng.submit([1, 2], 4, repetition_penalty=1.1)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit([1, 2], 4, lora="a")
    with pytest.raises(ValueError, match="stop must be"):
        eng.submit([1, 2], 4, stop=[[]])
    eng.submit(list(range(100)), 4)
    with pytest.raises(ValueError, match="max_seq"):
        eng.step()
    # two requests of two pages each in a pool of two free pages
    pool = Engine(tp, TCFG, ServeConfig(2, 32, prefill_buckets=(16,), kv_layout="paged",
                                        page_size=8, num_pages=3), device="cpu")
    pool.submit([1, 2, 3], 4)
    pool.submit([4, 5, 6], 4)
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.run()
    assert ao_tpu_torch.Engine is Engine and ao_tpu_torch.ServeConfig is ServeConfig
