"""Helpers shared by the ``test_torch_*`` files: carry inputs between the
JAX package and its PyTorch port as numpy arrays.

Importing this module caps torch at one intra-op thread. The suite runs in
six worker processes on an 8-core machine, each also running XLA's CPU
thread pool, and torch's pool of one thread a core in each worker
oversubscribed the cores: the port's test files took 496 s on 6 workers
with it, 194 s with one thread (one case, ``test_torch_fp4_nf4.py::
test_generate_matches_jax[MXFP4-WO]``, 172 s against 3.6 s alone). The
tests' shapes are tiny, so a second thread buys nothing."""

import dataclasses

import jax
import numpy as np
import torch

from ao_tpu.quantization.qarrays.base import QuantizedArray as JaxQuantizedArray
from ao_tpu_torch.weights import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)


def jax_tree_to_numpy(tree):
    """The JAX package's params as the numpy tree ``params_from_numpy``
    takes: arrays become ``np.ndarray``, quantized containers become
    ``{"__qarray__": name, **data_fields, **meta_fields}``."""
    if isinstance(tree, JaxQuantizedArray):
        out = {"__qarray__": type(tree).__name__}
        for k, v in tree.data_fields().items():
            out[k] = None if v is None else np.asarray(v)
        out.update(tree.meta_fields())
        return out
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_tree_to_numpy(v) for v in tree)
    if isinstance(tree, jax.Array):
        return np.asarray(tree)
    return tree


def jax_to_torch(tree):
    """A JAX params tree (or array) as the port's, on the CPU, bit for bit."""
    return params_from_numpy(jax_tree_to_numpy(tree), device="cpu")


def torch_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Exact numpy copy of a CPU tensor in C order (bf16 and fp8 as their
    ml_dtypes types)."""
    import ml_dtypes

    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy().view(getattr(ml_dtypes, str(t.dtype)[6:]))
    return t.numpy()


def assert_bit_equal(jax_array, torch_tensor):
    a = np.asarray(jax_array)
    b = torch_to_numpy(torch_tensor)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype.itemsize == b.dtype.itemsize, (a.dtype, b.dtype)
    av = a.view(f"u{a.dtype.itemsize}") if a.dtype.itemsize > 1 else a.view(np.uint8)
    bv = b.view(f"u{b.dtype.itemsize}") if b.dtype.itemsize > 1 else b.view(np.uint8)
    bad = np.count_nonzero(av != bv)
    assert bad == 0, f"{bad} of {a.size} elements differ in their bits"


def torch_from_np(a):
    return tensor_from_numpy(np.asarray(a), device="cpu")


def dataclass_fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
