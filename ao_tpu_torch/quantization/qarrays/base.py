"""QuantizedArray: quantized weight containers as frozen dataclasses.

PyTorch port of ``ao_tpu/quantization/qarrays/base.py``. A quantized weight
is a frozen dataclass of plain tensors (qdata, scale, zero_point, ...) plus
static metadata. Compute enters through the dispatching entry points
(``ao_tpu_torch.ops.linear``), which pick a hand-written kernel or the plain
PyTorch path by container type, as the reference does.

Subclasses declare::

    @qarray_dataclass
    class Int4Array(QuantizedArray):
        qdata: torch.Tensor
        scale: torch.Tensor
        zero_point: Optional[torch.Tensor]       # data fields = tensors
        block_size: tuple = meta()               # metadata = static fields
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Type

import torch

_QARRAY_REGISTRY: Dict[str, Type["QuantizedArray"]] = {}


def meta(**kwargs):
    """Mark a dataclass field as static metadata."""
    md = dict(kwargs.pop("metadata", {}) or {})
    md["ao_static"] = True
    return dataclasses.field(metadata=md, **kwargs)


class QuantizedArray:
    """Base for all quantized array containers (not a dataclass itself)."""

    # qdata kept column-major (``common.col_major``) by from_hp and by
    # ``weights.params_from_numpy``
    QDATA_COL_MAJOR = False

    # -- to be provided by subclasses -------------------------------------
    def dequantize(self, output_dtype=torch.bfloat16) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def from_hp(cls, hp: torch.Tensor, **kwargs) -> "QuantizedArray":
        raise NotImplementedError

    # -- common api --------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape  # set as metadata by subclasses

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        """Logical (dequantized) dtype."""
        return getattr(torch, self._dequant_dtype)

    @property
    def nbytes(self) -> int:
        return sum(
            v.numel() * v.element_size()
            for v in self.data_fields().values()
            if isinstance(v, torch.Tensor)
        )

    def data_fields(self) -> Dict[str, Any]:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if not f.metadata.get("ao_static")
        }

    def meta_fields(self) -> Dict[str, Any]:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.metadata.get("ao_static")
        }

    def replace(self, **updates) -> "QuantizedArray":
        return dataclasses.replace(self, **updates)

    def __repr__(self):
        fields = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                fields.append(f"{f.name}={v.dtype}{list(v.shape)}")
            else:
                fields.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(fields)})"


def qarray_dataclass(cls):
    """Decorator: make ``cls`` a frozen dataclass and register it by name.
    Equality stays identity: tensor fields have no truth value."""
    cls = dataclasses.dataclass(frozen=True, repr=False, eq=False)(cls)
    _QARRAY_REGISTRY[cls.__name__] = cls
    return cls


def get_qarray_class(name: str) -> Type[QuantizedArray]:
    return _QARRAY_REGISTRY[name]
