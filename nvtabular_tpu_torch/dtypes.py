"""Framework-agnostic dtype model.

A copy of ``nvtabular_tpu/dtypes.py`` (the port imports nothing from the JAX
package). Internally everything maps to a numpy dtype; torch tensors map
through ``table.torch_to_numpy_dtype``, so one canonical representation serves
the host (numpy) and device (torch) paths.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional, Tuple, Union

import numpy as np


class ElementType(Enum):
    Int = "int"
    UInt = "uint"
    Float = "float"
    Bool = "bool"
    String = "string"
    DateTime = "datetime"
    Object = "object"
    Unknown = "unknown"


@dataclass(frozen=True)
class Dimension:
    """One dimension of a column shape: fixed, bounded, or unknown."""

    min: int = 0
    max: Optional[int] = None

    @property
    def is_fixed(self) -> bool:
        return self.max is not None and self.min == self.max

    @property
    def is_bounded(self) -> bool:
        return self.max is not None

    def to_tuple(self):
        return (self.min, self.max)


@dataclass(frozen=True)
class Shape:
    """Column shape. ``dims=None`` means unknown; scalar columns are 1-D
    (the row dimension); list columns are 2-D with a ragged/fixed inner dim."""

    dims: Optional[Tuple[Dimension, ...]] = None

    @classmethod
    def scalar(cls) -> "Shape":
        return cls((Dimension(),))

    @classmethod
    def list(cls, min_len: int = 0, max_len: Optional[int] = None) -> "Shape":
        return cls((Dimension(), Dimension(min_len, max_len)))

    @property
    def is_list(self) -> bool:
        return self.dims is not None and len(self.dims) > 1

    @property
    def is_ragged(self) -> bool:
        if not self.is_list:
            return False
        inner = self.dims[1]
        return not inner.is_fixed

    @property
    def is_fixed(self) -> bool:
        return self.dims is not None and all(d.is_fixed for d in self.dims[1:])

    def with_value_count(self, min_len: int, max_len: Optional[int]) -> "Shape":
        return Shape((Dimension(), Dimension(min_len, max_len)))

    def as_tuple(self):
        if self.dims is None:
            return None
        return tuple(d.to_tuple() for d in self.dims)


_NP_TO_ELEMENT = {
    "i": ElementType.Int,
    "u": ElementType.UInt,
    "f": ElementType.Float,
    "b": ElementType.Bool,
    "M": ElementType.DateTime,
    "U": ElementType.String,
    "S": ElementType.String,
    "O": ElementType.Object,
}


@dataclass(frozen=True)
class DType:
    """A logical element dtype, convertible to numpy/torch."""

    name: str
    element_type: ElementType
    element_size: Optional[int] = None  # bits
    signed: Optional[bool] = None

    @property
    def numpy_dtype(self) -> Optional[np.dtype]:
        if self.element_type == ElementType.String:
            return np.dtype("O")
        if self.element_type in (ElementType.Object, ElementType.Unknown):
            return np.dtype("O") if self.element_type == ElementType.Object else None
        return np.dtype(self.name)

    def to_numpy(self) -> Optional[np.dtype]:
        return self.numpy_dtype

    @property
    def is_integer(self) -> bool:
        return self.element_type in (ElementType.Int, ElementType.UInt)

    @property
    def is_float(self) -> bool:
        return self.element_type == ElementType.Float

    @property
    def is_string(self) -> bool:
        return self.element_type == ElementType.String

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_float or self.element_type == ElementType.Bool

    def __repr__(self):
        return f"DType({self.name})"


def _mk(name, et, size, signed=None):
    return DType(name, et, size, signed)


int8 = _mk("int8", ElementType.Int, 8, True)
int16 = _mk("int16", ElementType.Int, 16, True)
int32 = _mk("int32", ElementType.Int, 32, True)
int64 = _mk("int64", ElementType.Int, 64, True)
uint8 = _mk("uint8", ElementType.UInt, 8, False)
uint16 = _mk("uint16", ElementType.UInt, 16, False)
uint32 = _mk("uint32", ElementType.UInt, 32, False)
uint64 = _mk("uint64", ElementType.UInt, 64, False)
float16 = _mk("float16", ElementType.Float, 16)
bfloat16 = _mk("bfloat16", ElementType.Float, 16)
float32 = _mk("float32", ElementType.Float, 32)
float64 = _mk("float64", ElementType.Float, 64)
boolean = _mk("bool", ElementType.Bool, 8)
string = _mk("string", ElementType.String, None)
datetime64ns = _mk("datetime64[ns]", ElementType.DateTime, 64)
datetime64us = _mk("datetime64[us]", ElementType.DateTime, 64)
datetime64s = _mk("datetime64[s]", ElementType.DateTime, 64)
unknown = _mk("unknown", ElementType.Unknown, None)

_BY_NAME = {
    d.name: d
    for d in [
        int8, int16, int32, int64,
        uint8, uint16, uint32, uint64,
        float16, bfloat16, float32, float64,
        boolean, string, datetime64ns, datetime64us, datetime64s, unknown,
    ]
}
_BY_NAME["str"] = string
_BY_NAME["object"] = string
_BY_NAME["boolean"] = boolean


DTypeLike = Union[DType, str, np.dtype, type, None]


def normalize(dtype: DTypeLike) -> DType:
    """Coerce any dtype-like (numpy dtype, python type, string, DType) to DType."""
    if dtype is None:
        return unknown
    if isinstance(dtype, DType):
        return dtype
    if isinstance(dtype, str):
        if dtype in _BY_NAME:
            return _BY_NAME[dtype]
        dtype = np.dtype(dtype)
    if dtype in (int,):
        return int64
    if dtype in (float,):
        return float64
    if dtype in (bool,):
        return boolean
    if dtype in (str, bytes, object):
        return string
    # bfloat16 can arrive as a numpy "void"-registered extension dtype
    name = getattr(dtype, "name", None) or str(dtype)
    if name == "bfloat16":
        return bfloat16
    npd = np.dtype(dtype)
    if npd.kind == "M":
        return _BY_NAME.get(npd.name, datetime64ns)
    et = _NP_TO_ELEMENT.get(npd.kind, ElementType.Unknown)
    if et == ElementType.String or npd.kind == "O":
        return string
    key = npd.name
    if key in _BY_NAME:
        return _BY_NAME[key]
    return DType(key, et, npd.itemsize * 8, npd.kind == "i")


def to_numpy(dtype: DTypeLike) -> np.dtype:
    d = normalize(dtype).numpy_dtype
    if d is None:
        raise TypeError(f"dtype {dtype!r} has no numpy equivalent")
    return d
