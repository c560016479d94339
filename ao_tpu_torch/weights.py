"""Carry params across from the JAX package, bit for bit.

``params_from_numpy(tree, device)`` takes the JAX package's params tree as
numpy: plain leaves are ``np.ndarray`` (bf16 and fp8 arrive as the
``ml_dtypes`` bfloat16, float8_e4m3fn and float8_e5m2 dtypes that
``np.asarray`` gives those ``jax.Array``s), and each quantized container
arrives as
``{"__qarray__": "Int4Array", **data_fields as np.ndarray, **meta_fields}``.
An ``Int8Array``'s or ``Float8Array``'s qdata is stored column-major, as
their ``from_hp`` stores it (same values, same logical shape; an MoE
expert stack (E, K, N) each expert column-major). An ``Int4Array``'s
"magic" and "magic8" words, 2-D or (E, K/8, N), carry as they are. The 4-bit
float and codebook containers carry as they are: ``MXArray``'s e8m0 bytes
as uint8, ``NVFP4Array``'s scale pair-words as int32 (raw e4m3 in the
split-half layout), ``NF4Array``'s int8 quantized scalers with their f32
factors and mean. The sparse containers carry as they are:
``BlockSparseArray``'s values and int32 block indices, ``Sparse24Array``'s
values and uint8 metadata, ``Sparse24Int4Array``'s packed codes, metadata
and bf16 qparams. An ``ObservedArray`` is calibration state (a Python
accumulator of activation statistics), not a weight: it is refused, and a
tree is carried before ``observe`` or after ``convert``.
The conversion from ``jax.Array`` to numpy happens on the caller's side;
this module imports no JAX.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np
import torch

from ao_tpu_torch.quantization import primitives as P
from ao_tpu_torch.quantization.qarrays.base import get_qarray_class
from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec, col_major

# dtypes that travel as their raw bits: (numpy view, torch dtype)
_BITS = {"bfloat16": (np.int16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
         "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """Exact copy of ``a`` on ``device``; bf16 and fp8 travel as their raw
    bits."""
    a = np.array(a, order="C", copy=True)  # writable, owned by the tensor
    if a.dtype.name in _BITS:
        view, dtype = _BITS[a.dtype.name]
        return torch.from_numpy(a.view(view)).view(dtype).to(device)
    return torch.from_numpy(a).to(device)


def _meta_value(name: str, v: Any) -> Any:
    if name == "zero_point_domain":
        if isinstance(v, P.ZeroPointDomain):
            return v
        return P.ZeroPointDomain(v.value if isinstance(v, enum.Enum) else v)
    # an ActQuantSpec, or NVFP4Array's flag
    if name == "act_quant" and v is not None and not isinstance(v, (ActQuantSpec, bool)):
        fields = v if isinstance(v, dict) else dataclasses.asdict(v)
        return ActQuantSpec(**fields)
    if isinstance(v, list):
        return tuple(v)
    return v


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Return the port's params for a numpy params tree (see module doc)."""
    if isinstance(tree, np.ndarray):
        return tensor_from_numpy(tree, device)
    if isinstance(tree, dict) and "__qarray__" in tree:
        if tree["__qarray__"] == "ObservedArray":
            raise ValueError("an ObservedArray is calibration state and is not carried: "
                             "carry the tree before observe or after convert")
        cls = get_qarray_class(tree["__qarray__"])
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in tree:
                continue
            v = tree[f.name]
            if f.metadata.get("ao_static"):
                kwargs[f.name] = _meta_value(f.name, v)
            else:
                kwargs[f.name] = None if v is None else tensor_from_numpy(np.asarray(v), device)
        if cls.QDATA_COL_MAJOR:
            kwargs["qdata"] = col_major(kwargs["qdata"])
        return cls(**kwargs)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tree
