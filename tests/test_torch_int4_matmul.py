"""K1 (int4 weight-only magic matmul): the port's plain version against the
JAX package's Pallas kernel in interpret mode and its XLA path, on the same
numpy inputs. The CUDA kernel itself runs only on the card (cuda marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ao_tpu.ops import kernels as jkernels
from ao_tpu.ops import linear as jlinear
from ao_tpu.ops.pallas.int4_matmul import int4_wo_magic_pallas
from ao_tpu.quantization.primitives import ZeroPointDomain as JZPD
from ao_tpu.quantization.qarrays.int4 import Int4Array as JInt4Array

from ao_tpu_torch.ops import kernels as tkernels
from ao_tpu_torch.ops.hopper import int4_matmul as k1
from ao_tpu_torch.ops.linear import linear as tlinear
from ao_tpu_torch.quantization.primitives import ZeroPointDomain as TZPD
from ao_tpu_torch.quantization.primitives import compute_error

from torch_port_helpers import jax_to_torch, torch_from_np

K, N, G = 256, 128, 32


def _inputs(m, seed=0, domain="tinygemm"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    zpd = JZPD.FLOAT if domain == "tinygemm" else JZPD.INT
    qj = JInt4Array.from_hp(jnp.asarray(w), group_size=G, zero_point_domain=zpd)
    assert qj.layout == "magic"
    return x, qj, jax_to_torch(qj)


def _sqnr(a, b):
    return float(compute_error(torch.as_tensor(np.asarray(a, np.float32)),
                               torch.as_tensor(np.asarray(b, np.float32))))


@pytest.mark.parametrize("domain", ["tinygemm", "minmax_int"])
@pytest.mark.parametrize("m", [8, 64])
def test_plain_matches_pallas_interpret(m, domain):
    x, qj, qt = _inputs(m, seed=m, domain=domain)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        # wait for the interpreted kernel before anything else is dispatched
        ref = int4_wo_magic_pallas(xb, qj.qdata, qj.scale, qj.zero_point, G,
                                   qj.zero_point_domain).block_until_ready()
    got = k1.int4_wo_magic(torch_from_np(np.asarray(xb)), qt.qdata, qt.scale, qt.zero_point, G,
                           qt.zero_point_domain)
    assert got.dtype == torch.bfloat16 and got.shape == (m, N)
    # the same arithmetic (bf16 x and qparams, f32 group sums, bf16 out): the
    # JAX suite's bound for the kernel against its emulated path
    assert _sqnr(np.asarray(ref.astype(jnp.float32)), got.float().numpy()) >= 45


@pytest.mark.parametrize("domain", ["tinygemm", "minmax_int"])
def test_plain_f32_matches_xla_path(domain):
    x, qj, qt = _inputs(8, seed=3, domain=domain)
    ref = jkernels._int4_wo_magic_xla_permuted(
        jnp.asarray(x), qj.qdata, qj.scale, qj.zero_point, G, qj.zero_point_domain)
    s = qt.scale.float()
    if qt.zero_point_domain is TZPD.FLOAT:
        b = qt.zero_point.float()
    else:
        b = -(8.0 + qt.zero_point.float()) * s
    got = k1.int4_wo_magic_plain(torch.from_numpy(x), qt.qdata, s, b + 8.0 * s, G)
    # all in f32: the two differ only in the order of f32 roundings
    assert _sqnr(np.asarray(ref), got.numpy()) >= 100


def test_linear_matches_jax_pallas_linear():
    x, qj, qt = _inputs(16, seed=5)
    x3 = x.reshape(2, 8, K)
    with pltpu.force_tpu_interpret_mode(), jkernels.backend("pallas"):
        # one jitted program, waited for before anything else is dispatched
        ref = jax.jit(jlinear)(jnp.asarray(x3), qj).block_until_ready()
    got = tlinear(torch.from_numpy(x3), qt)
    assert got.shape == (2, 8, N) and got.dtype == torch.float32
    assert _sqnr(np.asarray(ref), got.numpy()) >= 45


def test_backend_gate_and_torch_path():
    x, qj, qt = _inputs(8, seed=6)
    xt = torch.from_numpy(x)
    ref = tkernels._int4_wo_matmul_torch(xt, qt.qdata, qt.scale, qt.zero_point, G,
                                         qt.zero_point_domain, "magic")
    jref = jkernels._int4_wo_matmul_xla(jnp.asarray(x), qj.qdata, qj.scale, qj.zero_point, G,
                                        qj.zero_point_domain, "magic")
    assert _sqnr(np.asarray(jref), ref.numpy()) >= 100
    with tkernels.backend("torch"):
        y = tkernels.int4_wo_matmul(xt, qt.qdata, qt.scale, qt.zero_point, G,
                                    qt.zero_point_domain, "magic")
    assert y.dtype == torch.float32 and torch.equal(y, ref)
    y_auto = tkernels.int4_wo_matmul(xt, qt.qdata, qt.scale, qt.zero_point, G,
                                     qt.zero_point_domain, "magic")
    assert y_auto.dtype == torch.bfloat16  # the kernel route (its plain version here)
    big = torch.zeros((tkernels.INT4_KERNEL_MAX_M + 1, K))
    y_big = tkernels.int4_wo_matmul(big, qt.qdata, qt.scale, qt.zero_point, G,
                                    qt.zero_point_domain, "magic")
    assert y_big.dtype == torch.float32  # above the M gate: dequantize + matmul
    with tkernels.backend("cuda"), pytest.raises(ValueError, match="CUDA tensors"):
        tkernels.int4_wo_matmul(xt, qt.qdata, qt.scale, qt.zero_point, G,
                                qt.zero_point_domain, "magic")
    assert k1.int4_wo_magic.launches == 0


@pytest.mark.parametrize("m,k,n", [(8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336),
                                   (8, 14336, 4096), (8, 4096, 128256), (1024, 4096, 14336)])
def test_pick_splits_covers_k(m, k, n):
    if m > 16:  # the mainloop: whole units of 512 K values a split
        _, _, splits = k1.pick_tiles_magic(m, k, n, 132)
        units, per = k1.magic_units(k), -(-k1.magic_units(k) // splits)
    else:  # the decode form: a cluster of CTAs along K, slabs of word rows each
        wn, wk, splits, stages = k1.gemv_plan(m, k, n, 128, 132)
        units, per = k // (8 * k1.gemv_rows(128)), k1.gemv_per(k, 128, splits)
        assert k1.gemv_plan_ok(m, k, n, 128, (wn, wk, splits, stages))
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < units <= splits * per


def test_shape_checks():
    w = torch.zeros((K // 8, N), dtype=torch.int32)
    with pytest.raises(ValueError, match="K mismatch"):
        k1.check_shapes(torch.zeros((8, K + 8)), w, G)
    with pytest.raises(ValueError, match="multiple of 32"):
        k1.check_shapes(torch.zeros((8, K)), w[:, :100], G)


def test_kernel_shape_rule_routes_other_group_sizes_to_torch():
    """A magic-layout g the kernel does not take: the route asks
    ``int4_matmul.takes`` and falls back to dequantize + matmul, as the
    reference falls back from its kernel, with the reference's values; the
    wrapper itself still refuses the shape, on the CPU as on the card."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((1024, 128)) * 0.02).astype(np.float32)
    qj = JInt4Array.from_hp(jnp.asarray(w), group_size=256)
    qt = jax_to_torch(qj)
    assert qt.layout == "magic" and not k1.takes(1024, 128, 256)
    x = rng.standard_normal((8, 1024)).astype(np.float32)
    ref = jkernels.int4_wo_matmul(jnp.asarray(x), qj.qdata, qj.scale, qj.zero_point, 256,
                                  qj.zero_point_domain, "magic")
    xt = torch.from_numpy(x)
    y = tkernels.int4_wo_matmul(xt, qt.qdata, qt.scale, qt.zero_point, 256,
                                qt.zero_point_domain, "magic")
    assert y.dtype == torch.float32  # dequantize + matmul, not the kernel's bf16
    # both dequantize in f32 and multiply in f32: they differ only in the
    # order of f32 roundings (test_backend_gate_and_torch_path's bound)
    assert _sqnr(np.asarray(ref), y.numpy()) >= 100
    with pytest.raises(ValueError, match="one of"):
        k1.check_shapes(xt, qt.qdata, 256)
    with tkernels.backend("torch"):
        y_torch = tkernels.int4_wo_matmul(xt, qt.qdata, qt.scale, qt.zero_point, 256,
                                          qt.zero_point_domain, "magic")
    assert torch.equal(y, y_torch)
    assert k1.int4_wo_magic.launches == 0
