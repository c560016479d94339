"""The sparsity slice of the port against the JAX package, on the same numpy
inputs.

* ``sparsity/sparse24.py``: prune / compress / decompress (ties, all-negative
  groups and their signed zeros), ``Sparse24Array`` and ``Sparse24Int4Array``,
  bit for bit.
* ``sparsity/blocksparse.py``: ``BlockSparseArray.from_hp`` (kept set,
  padding, order, ties) and ``dequantize`` bit for bit; its ragged
  ``matmul``, the plain version of K18, against the Pallas kernel in
  interpret mode (called alone and waited for) and against JAX's ragged
  route.
* ``ops/linear.py``'s sparse branches, the configs through ``sparsify_``
  (Wanda's observe / convert over ``algorithms/observe.py``), the observers'
  five kinds, and a tiny ViT under BSR and 2:4 against JAX's jitted forward.

The CUDA kernel K18 runs only on the card (tests/test_torch_kernels_cuda.py).
The JAX side is jitted wherever it is not a Pallas interpret call or an
eager calibration step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ao_tpu
from ao_tpu.algorithms import observe as jobserve
from ao_tpu.models import vit as jvit
from ao_tpu.moe.grouped import grouped_matmul as jgrouped_matmul
from ao_tpu.ops import linear as jlinear
from ao_tpu.ops.pallas.bsr_matmul import bsr_matmul_pallas
from ao_tpu.sparsity import blocksparse as jbs
from ao_tpu.sparsity import sparse24 as j24

import ao_tpu_torch
from ao_tpu_torch.algorithms import observe as tobserve
from ao_tpu_torch.models import vit as tvit
from ao_tpu_torch.moe.grouped import grouped_matmul as tgrouped_matmul
from ao_tpu_torch.ops import kernels as tkernels
from ao_tpu_torch.ops.hopper import bsr_matmul as k18
from ao_tpu_torch.ops.linear import linear as tlinear
from ao_tpu_torch.quantization.primitives import compute_error
from ao_tpu_torch.sparsity import blocksparse as tbs
from ao_tpu_torch.sparsity import sparse24 as t24
from ao_tpu_torch.weights import params_from_numpy

from torch_port_helpers import assert_bit_equal, jax_to_torch, jax_tree_to_numpy, torch_from_np


def _sqnr(a, b):
    return float(compute_error(torch.as_tensor(np.asarray(a, np.float32)),
                               torch.as_tensor(np.asarray(b, np.float32))))


def _weight_with_ties(k=32, n=8, seed=0):
    """Random (K, N) f32 with groups of 4 that tie ([1, 1, 1, 1], all zero,
    one nonzero, a kept -0.0) and groups whose two largest are negative."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    w[0:4, 0] = 1.0
    w[4:8, 0] = [-1.0, -2.0, 0.5, 0.25]
    w[8:12, 0] = [0.5, -3.0, -2.5, 0.25]
    w[0:4, 1] = 0.0
    w[4:8, 1] = [0.0, 0.0, 3.0, 0.0]
    w[8:12, 1] = [-0.0, 0.0, 0.0, -0.0]
    w[12:16, 1] = [2.0, -2.0, 2.0, -2.0]
    return w


def _assert_fields_equal(ja, ta, names):
    for name in names:
        assert_bit_equal(getattr(ja, name), getattr(ta, name))


# ---------------------------------------------------------------------------
# sparse24.py
# ---------------------------------------------------------------------------

_jprune = jax.jit(j24.prune_2to4)
_jcompress = jax.jit(j24.compress_2to4)
_jdecompress = jax.jit(j24.decompress_2to4)
_jprune_last = jax.jit(j24.prune_2to4_lastdim)
_jdequant = jax.jit(lambda a: a.dequantize())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["2d", "stacked"])
def test_prune_compress_decompress_bit_exact(dtype, lead):
    w = np.broadcast_to(_weight_with_ties(), lead + (32, 8)).copy()
    w[..., 16:20, 2] = [-1.0, -0.5, 0.25, 0.125]  # a second all-negative kept pair
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jp, tp = _jprune(jw), t24.prune_2to4(tw)
    assert_bit_equal(jp, tp)
    # ties keep the later positions, as jnp.argsort (stable) ranks them
    np.testing.assert_array_equal(np.asarray(jp, np.float32)[(0,) * len(lead)][0:4, 0],
                                  [0, 0, 1, 1])
    (jv, jm), (tv, tm) = _jcompress(jp), t24.compress_2to4(tp)
    assert_bit_equal(jv, tv)
    assert_bit_equal(jm, tm)
    jd, td = _jdecompress(jv, jm), t24.decompress_2to4(tv, tm)
    assert_bit_equal(jd, td)
    col = td.to(torch.float32)[(0,) * len(lead)][4:8, 0]
    # XLA multiplies by a bool mask as a product in bf16 and as a select in
    # f32: the pruned zeros of the group [-1, -2, ...] carry the sign in bf16
    assert col.tolist() == [-1.0, -2.0, 0.0, 0.0]
    assert torch.signbit(col).tolist() == [True, True, dtype == "bfloat16", dtype == "bfloat16"]


def test_prune_2to4_lastdim_bit_exact():
    x = _weight_with_ties(32, 8, seed=1).T.copy()  # the tied groups along the last axis
    assert_bit_equal(_jprune_last(jnp.asarray(x)), t24.prune_2to4_lastdim(torch.from_numpy(x)))
    with pytest.raises(ValueError, match="multiple of 4"):
        t24.prune_2to4_lastdim(torch.zeros((2, 6)))
    with pytest.raises(ValueError, match="multiple of 4"):
        t24.prune_2to4(torch.zeros((6, 2)))


@pytest.mark.parametrize("dequant_dtype", ["bfloat16", "float32"])
def test_sparse24_array_bit_exact(dequant_dtype):
    w = _weight_with_ties(64, 16, seed=2)
    ja = jax.jit(lambda x: j24.Sparse24Array.from_hp(x, dequant_dtype))(jnp.asarray(w))
    ta = t24.Sparse24Array.from_hp(torch.from_numpy(w), dequant_dtype)
    _assert_fields_equal(ja, ta, ("values", "metadata"))
    assert ta.shape == (64, 16) and ta.dtype == getattr(torch, dequant_dtype)
    assert_bit_equal(_jdequant(ja), ta.dequantize())
    # carried across from JAX, bit for bit, and dequantized alike
    assert_bit_equal(_jdequant(ja), jax_to_torch(ja).dequantize())


@pytest.mark.parametrize("g", [32, 64])
def test_sparse24_int4_array_bit_exact(g):
    w = np.random.default_rng(g).standard_normal((256, 64)).astype(np.float32)
    w[4:8, 0] = [-1.0, -2.0, 0.5, 0.25]
    # eager: under jit XLA multiplies by 1/15 for the division by 15 of the
    # qparams, which moves a zero point by an ulp now and then
    ja = j24.Sparse24Int4Array.from_hp(jnp.asarray(w), g)
    ta = t24.Sparse24Int4Array.from_hp(torch.from_numpy(w), g)
    _assert_fields_equal(ja, ta, ("qdata", "metadata", "scale", "zero_point"))
    assert ta.qdata.shape == (64, 64) and ta.metadata.shape == (32, 64)
    assert ta.nbytes - ta.scale.nbytes - ta.zero_point.nbytes == 256 * 64 * 3 // 8
    assert_bit_equal(_jdequant(ja), ta.dequantize())
    assert_bit_equal(_jdequant(ja), jax_to_torch(ja).dequantize())
    with pytest.raises(ValueError, match="g%8"):
        t24.Sparse24Int4Array.from_hp(torch.from_numpy(w), 12)


# ---------------------------------------------------------------------------
# blocksparse.py
# ---------------------------------------------------------------------------


def _block_weight(k, n, b, seed):
    """Random (K, N) with some all-zero blocks, duplicated blocks (tied
    norms) and an all-zero column strip (a padding block)."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * 0.05
    w[:b, b:2 * b] = 0.0
    w[b:2 * b, :b] = w[:b, :b]  # the same norm twice
    w[:, -b:] = 0.0  # an empty column strip
    return w


@pytest.mark.parametrize("keep", [None, 0.5, 0.3, 1e-3], ids=["nonzero", "half", "tie", "one"])
def test_blocksparse_from_hp_and_dequantize_bit_exact(keep):
    b = 16
    w = _block_weight(64, 96, b, seed=3)
    if keep == 0.3:
        # tied norms straddle the threshold: ">=" keeps both copies
        w[2 * b:3 * b, 2 * b:3 * b] = w[:b, :b] * 1.5
        w[3 * b:4 * b, 3 * b:4 * b] = w[:b, :b] * 1.5
    ja = jbs.BlockSparseArray.from_hp(jnp.asarray(w), b, keep)
    ta = tbs.BlockSparseArray.from_hp(torch.from_numpy(w), b, keep)
    _assert_fields_equal(ja, ta, ("values", "row_indices", "col_indices"))
    assert ta.nnz_blocks == ja.nnz_blocks and ta.shape == (64, 96)
    cols = ta.col_indices.tolist()
    assert cols == sorted(cols) and set(cols) == set(range(96 // b))  # every column present
    assert_bit_equal(_jdequant(ja), ta.dequantize())
    assert_bit_equal(jax.jit(lambda a: a.dequantize(jnp.float32))(ja),
                     ta.dequantize(torch.float32))
    if keep == 1e-3:
        live = int((ta.values.to(torch.float32).abs().sum((1, 2)) > 0).sum())
        assert live == 1 and ta.nnz_blocks == 96 // b  # one block and five padding blocks


def test_blocksparse_refuses_what_jax_refuses():
    """The default filter picks a ViT's 1000-class head; 1000 % 64 makes
    both packages' from_hp raise."""
    w = np.zeros((128, 1000), np.float32)
    cfg_j = ao_tpu.BlockSparseWeightConfig(blocksize=64)
    cfg_t = ao_tpu_torch.BlockSparseWeightConfig(blocksize=64)
    with pytest.raises(ValueError, match="not divisible by block 64"):
        ao_tpu.sparsify_({"head": {"proj": jnp.asarray(w)}}, cfg_j)
    with pytest.raises(ValueError, match="not divisible by block 64"):
        ao_tpu_torch.sparsify_({"head": {"proj": torch.from_numpy(w)}}, cfg_t)


def test_k18_plain_matches_pallas_interpret():
    """The JAX suite's interpret case (tests/test_pallas_interpret.py:624):
    256^2, b = 128, keep 0.5, M = 8, and its bound."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((256, 256)) * 0.05).astype(np.float32)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    jw = jbs.BlockSparseArray.from_hp(jnp.asarray(w), blocksize=128, keep_fraction=0.5)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = bsr_matmul_pallas(jx, jw).block_until_ready()
    tw = jax_to_torch(jw)
    got = k18.bsr_matmul(torch_from_np(np.asarray(jx)), tw)
    assert got.dtype == torch.bfloat16 and got.shape == (8, 256)
    assert k18.bsr_matmul.launches == 0
    # the TPU kernel rounds its bf16 tile once per block, the plain version
    # once: the JAX suite's bound for the kernel
    assert _sqnr(np.asarray(ref, np.float32), got.to(torch.float32).numpy()) > 30


@pytest.mark.parametrize("b", [64, 128])
@pytest.mark.parametrize("m", [1, 13])
def test_k18_plain_matches_jax_ragged(b, m):
    rng = np.random.default_rng(b + m)
    w = (rng.standard_normal((256, 384)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    jw = jbs.BlockSparseArray.from_hp(jnp.asarray(w), blocksize=b, keep_fraction=0.4)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jax.jit(lambda a, v: a.matmul(v))(jw, jx), np.float32)
    got = k18.bsr_matmul(torch_from_np(np.asarray(jx)), jax_to_torch(jw))
    # both sum the block products in f32 and round once
    assert _sqnr(ref, got.to(torch.float32).numpy()) >= 45


def test_k18_route_and_refusals():
    w = tbs.BlockSparseArray.from_hp(torch.randn((64, 64)), blocksize=16)
    x = torch.randn((4, 64))
    assert not k18.takes(16, 64, 64) and k18.takes(32, 64, 96) and not k18.takes(64, 64, 96)
    assert k18.takes(64, 1024, 4096) and k18.takes(128, 512, 640)
    with pytest.raises(ValueError, match="blocksize"):
        k18.bsr_matmul(x, w)
    with pytest.raises(ValueError, match="2-D x"):
        k18.bsr_matmul(x[:, :32], tbs.BlockSparseArray.from_hp(torch.randn((64, 64)), 32))
    # the route asks ``takes`` first: b = 16 takes the ragged route in x's dtype
    for name in ("auto", "torch"):
        with tkernels.backend(name):
            y = tlinear(x, w)
        assert y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), (x @ w.dequantize(torch.float32)).numpy(),
                                   rtol=1e-5, atol=1e-5)
    with tkernels.backend("cuda"), pytest.raises(ValueError, match="CUDA tensors only"):
        tlinear(x, w)
    assert k18.bsr_matmul.launches == 0


# ---------------------------------------------------------------------------
# linear, per container, against JAX's linear
# ---------------------------------------------------------------------------


def _linear_case(seed, k, n, m, dtype):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    return w, jnp.asarray(x).astype(dtype)


_jlinear = jax.jit(jlinear)


@pytest.mark.parametrize("kind,bound", [
    ("sparse24", 25.0), ("sparse24_int4", 18.0), ("blocksparse", 30.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_matches_jax(kind, bound, dtype):
    """The JAX suite's bounds (tests/test_sparsity.py; the BSR kernel's 30 dB
    from tests/test_pallas_tpu.py), held between the two packages' linears
    and between the port's and the pruned dense product."""
    w, jx = _linear_case(5, 256, 128, 4, dtype)
    jw = {"sparse24": lambda: jax.jit(j24.Sparse24Array.from_hp)(jnp.asarray(w)),
          "sparse24_int4": lambda: jax.jit(lambda v: j24.Sparse24Int4Array.from_hp(v, 32))(
              jnp.asarray(w)),
          "blocksparse": lambda: jbs.BlockSparseArray.from_hp(jnp.asarray(w), 64, 0.5)}[kind]()
    jb = jnp.asarray(np.linspace(-1, 1, 128, dtype=np.float32)).astype(dtype)
    ref = np.asarray(_jlinear(jx, jw, jb), np.float32)
    tx, tw, tb = torch_from_np(np.asarray(jx)), jax_to_torch(jw), torch_from_np(np.asarray(jb))
    got = tlinear(tx, tw, tb)
    assert got.shape == (2, 4, 128) and got.dtype == getattr(torch, dtype)
    assert _sqnr(ref, got.to(torch.float32).numpy()) > bound
    dense = np.asarray(jx, np.float32) @ np.asarray(_jdequant(jw), np.float32) + np.asarray(
        jb, np.float32)
    assert _sqnr(dense, got.to(torch.float32).numpy()) > bound
    if dtype == "float32":
        # the same f32 arithmetic on bit-equal weights, sums in other orders
        assert _sqnr(ref, got.numpy()) > 100


# ---------------------------------------------------------------------------
# configs, sparsify_, observers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["semi", "int4", "block"])
def test_sparsify_configs_match_jax(name):
    w = np.random.default_rng(6).standard_normal((256, 64)).astype(np.float32)
    cfgs = {"semi": ("SemiSparseWeightConfig", {}, ("values", "metadata")),
            "int4": ("Sparse24Int4WeightConfig", {"group_size": 32},
                     ("qdata", "metadata", "scale", "zero_point")),
            "block": ("BlockSparseWeightConfig", {"blocksize": 32, "keep_fraction": 0.5},
                      ("values", "row_indices", "col_indices"))}
    cls, kw, fields = cfgs[name]
    jcfg = getattr(ao_tpu, cls)(**kw)
    jsparsify = (lambda p: ao_tpu.sparsify_(p, jcfg))
    if name == "semi":  # BSR selects on the host; int4 eagerly (see above)
        jsparsify = jax.jit(jsparsify)
    jp = jsparsify({"wq": jnp.asarray(w), "norm": jnp.ones((64,))})
    tp = ao_tpu_torch.sparsify_({"wq": torch.from_numpy(w), "norm": torch.ones((64,))},
                                getattr(ao_tpu_torch, cls)(**kw))
    assert type(tp["wq"]).__name__ == type(jp["wq"]).__name__
    assert isinstance(tp["norm"], torch.Tensor)
    _assert_fields_equal(jp["wq"], tp["wq"], fields)


def _wanda_inputs():
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((128, 64)) * 0.05).astype(np.float32)
    x = rng.standard_normal((32, 128)).astype(np.float32)
    x[:, :8] *= 10.0  # some high-activation channels
    return w, x


def test_wanda_observe_convert_matches_jax():
    """Convert with JAX's own sum of squares carried across gives JAX's
    masks exactly; the port's own observe (its f32 sums in torch's order)
    gives them except in groups whose 2nd and 3rd scores tie to 1e-6."""
    w, x = _wanda_inputs()
    jcfg, tcfg = (ao_tpu.WandaSparseConfig, ao_tpu_torch.WandaSparseConfig)
    jobs = ao_tpu.sparsify_({"wq": jnp.asarray(w)}, jcfg(step="observe"))
    jlinear(jnp.asarray(x), jobs["wq"])  # eager: the accumulator is Python state
    jsp = ao_tpu.sparsify_(jobs, jcfg(step="convert"))["wq"]
    jsq = np.asarray(jobs["wq"].stats.sq_sum)

    tobs = ao_tpu_torch.sparsify_({"wq": torch.from_numpy(w)}, tcfg(step="observe"))
    assert isinstance(tobs["wq"], tobserve.ObservedArray)
    assert ao_tpu_torch.sparsify_(tobs, tcfg(step="observe"))["wq"] is tobs["wq"]
    y = tlinear(torch.from_numpy(x), tobs["wq"])
    np.testing.assert_allclose(y.numpy(), x @ w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tobs["wq"].stats.sq_sum.numpy(), jsq, rtol=1e-5)

    carried = tobserve.ObservedArray.wrap(torch.from_numpy(w), "wanda")
    carried.stats.sq_sum = torch.from_numpy(jsq.copy())
    tsp = ao_tpu_torch.sparsify_({"wq": carried}, tcfg(step="convert"))["wq"]
    assert isinstance(tsp, t24.Sparse24Array)
    _assert_fields_equal(jsp, tsp, ("values", "metadata"))

    own = ao_tpu_torch.sparsify_(tobs, tcfg(step="convert"))["wq"]
    jmask = np.asarray(_jdequant(jsp), np.float32) != 0
    tmask = own.dequantize(torch.float32).numpy() != 0
    score = np.sort((np.abs(w) * np.sqrt(jsq)[:, None]).reshape(32, 4, 64), axis=1)
    near_tie = np.abs(score[:, 2] - score[:, 1]) <= 1e-6 * np.abs(score[:, 2])
    differs = (jmask != tmask).reshape(32, 4, 64).any(axis=1)
    assert not (differs & ~near_tie).any()
    # wanda beats plain magnitude pruning on the output, as in the JAX suite
    ref = x @ w
    e_wanda = _sqnr(ref, x @ own.dequantize(torch.float32).numpy())
    e_mag = _sqnr(ref, x @ t24.prune_2to4(torch.from_numpy(w)).numpy())
    assert e_wanda > e_mag


@pytest.mark.parametrize("kind", ["gptq", "awq", "smoothquant", "wanda", "static"])
def test_stats_accumulator_matches_jax(kind):
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((m, 16)).astype(np.float32) for m in (5, 300)]
    ja, ta = jobserve.StatsAccumulator(kind), tobserve.StatsAccumulator(kind)
    for x in xs:
        ja.update(jnp.asarray(x))
        ta.update(torch.from_numpy(x))
    assert ta.n == ja.n == 305
    for name in ("hessian", "abs_sum", "abs_max", "amax", "sq_sum", "sample"):
        jv, tv = getattr(ja, name), getattr(ta, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tobserve.StatsAccumulator("nope").update(torch.zeros((1, 4)))


def test_observed_grouped_matches_jax():
    """The MoE branch: per-expert Hessians for gptq (an expert with no
    rows included), the plain update otherwise; the product is the ragged
    dot."""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((3, 16, 8)).astype(np.float32)
    x = rng.standard_normal((10, 16)).astype(np.float32)
    gs = np.array([4, 0, 6], np.int32)
    for kind in ("gptq", "awq"):
        jw = jobserve.ObservedArray.wrap(jnp.asarray(w), kind)
        tw = tobserve.ObservedArray.wrap(torch.from_numpy(w), kind)
        jy = jgrouped_matmul(jnp.asarray(x), jw, jnp.asarray(gs))
        ty = tgrouped_matmul(torch.from_numpy(x), tw, torch.from_numpy(gs))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        if kind == "gptq":
            np.testing.assert_allclose(tw.stats.grouped_hessian.numpy(),
                                       np.asarray(jw.stats.grouped_hessian), rtol=1e-5,
                                       atol=1e-5)
        else:
            np.testing.assert_allclose(tw.stats.abs_sum.numpy(), np.asarray(jw.stats.abs_sum),
                                       rtol=1e-5)


def test_params_from_numpy_refuses_observed_state():
    jobs = ao_tpu.sparsify_({"wq": jnp.ones((8, 4))}, ao_tpu.WandaSparseConfig())
    with pytest.raises(ValueError, match="calibration state"):
        params_from_numpy(jax_tree_to_numpy(jobs), device="cpu")


# ---------------------------------------------------------------------------
# ViT tiny under BSR and 2:4
# ---------------------------------------------------------------------------

TCFG_VIT = tvit.VIT_TINY
JCFG_VIT = jvit.VIT_TINY


def _mlp_only(fqn, leaf):
    return fqn.endswith(("mlp.w1", "mlp.w2"))


@pytest.fixture(scope="module")
def vit_tiny():
    """The port's random init carried to JAX (f32), as the vision tests do."""
    def to_jax(tree):
        if isinstance(tree, torch.Tensor):
            return jnp.asarray(tree.numpy())
        if isinstance(tree, dict):
            return {k: to_jax(v) for k, v in tree.items()}
        return [to_jax(v) for v in tree]

    jp = to_jax(tvit.init_params(TCFG_VIT, torch.Generator().manual_seed(0), device="cpu"))
    images = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    fwd = jax.jit(lambda p, x: jvit.forward(p, x, JCFG_VIT))
    return jp, images, fwd


@pytest.mark.parametrize("name", ["bsr", "2:4"])
def test_vit_tiny_sparse_matches_jax(vit_tiny, name):
    jp, images, fwd = vit_tiny
    if name == "bsr":  # b = 32 on the 64 / 128 widths, the MLPs only
        jsp = ao_tpu.sparsify_(jp, ao_tpu.BlockSparseWeightConfig(32, 0.5), _mlp_only)
        tsp = ao_tpu_torch.sparsify_(jax_to_torch(jp),
                                     ao_tpu_torch.BlockSparseWeightConfig(32, 0.5), _mlp_only)
        assert isinstance(tsp["layers"][1]["mlp"]["w2"], tbs.BlockSparseArray)
        assert isinstance(tsp["layers"][0]["attn"]["wq"], torch.Tensor)
    else:
        jsp = jax.jit(lambda p: ao_tpu.sparsify_(p, ao_tpu.SemiSparseWeightConfig()))(jp)
        tsp = ao_tpu_torch.sparsify_(jax_to_torch(jp), ao_tpu_torch.SemiSparseWeightConfig())
        assert isinstance(tsp["head"]["proj"], t24.Sparse24Array)
    ref = np.asarray(fwd(jsp, jnp.asarray(images)))
    for backend in ("auto", "torch"):
        with tkernels.backend(backend):
            got = tvit.forward(tsp, torch.from_numpy(images), TCFG_VIT)
        assert got.dtype == torch.float32 and got.shape == (2, 10)
        assert _sqnr(ref, got.numpy()) >= 40, backend
    assert k18.bsr_matmul.launches == 0
