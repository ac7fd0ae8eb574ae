"""SQL data types of the PyTorch engine, each with its torch plane dtype.

Counterpart of ``spark_rapids_tpu/types.py``, cut to the types this engine
carries on the card: bool, int8/16/32/64, float32/64, date (int32 days
since the epoch), timestamp (int64 microseconds since the epoch, UTC)
and UTF-8 strings (offsets + bytes, or dictionary codes + vocabulary).
The class names, singletons and ``common_type`` widening rules are the
same as the JAX package's, so plans and results line up, and so are the
type signatures that plan tagging checks (``TypeSig``, ``Sigs``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


class DataType:
    """Base of the closed SQL type set."""

    #: numpy dtype of the primary plane (host side), None for strings
    np_dtype: Optional[np.dtype] = None
    #: torch dtype of the primary plane (device side), None for strings
    torch_dtype: Optional[torch.dtype] = None

    def __repr__(self) -> str:
        return self.__class__.__name__.replace("Type", "").lower()

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self))

    @property
    def is_numeric(self) -> bool:
        return isinstance(self, (IntegralType, FractionalType))

    @property
    def is_integral(self) -> bool:
        return isinstance(self, IntegralType)


class BooleanType(DataType):
    np_dtype = np.dtype(np.bool_)
    torch_dtype = torch.bool


class IntegralType(DataType):
    pass


class Int8Type(IntegralType):
    np_dtype = np.dtype(np.int8)
    torch_dtype = torch.int8


class Int16Type(IntegralType):
    np_dtype = np.dtype(np.int16)
    torch_dtype = torch.int16


class Int32Type(IntegralType):
    np_dtype = np.dtype(np.int32)
    torch_dtype = torch.int32


class Int64Type(IntegralType):
    np_dtype = np.dtype(np.int64)
    torch_dtype = torch.int64


class FractionalType(DataType):
    pass


class Float32Type(FractionalType):
    np_dtype = np.dtype(np.float32)
    torch_dtype = torch.float32


class Float64Type(FractionalType):
    np_dtype = np.dtype(np.float64)
    torch_dtype = torch.float64


class DateType(DataType):
    """Days since epoch, int32 (Spark DateType semantics)."""
    np_dtype = np.dtype(np.int32)
    torch_dtype = torch.int32


class TimestampType(DataType):
    """Microseconds since the epoch, UTC, int64 (Spark TimestampType)."""
    np_dtype = np.dtype(np.int64)
    torch_dtype = torch.int64


class StringType(DataType):
    """UTF-8 strings: int32 offsets + uint8 bytes, or dictionary-encoded
    as int32 codes into a small vocabulary (the default upload layout)."""


BOOLEAN = BooleanType()
INT8 = Int8Type()
INT16 = Int16Type()
INT32 = Int32Type()
INT64 = Int64Type()
FLOAT32 = Float32Type()
FLOAT64 = Float64Type()
DATE = DateType()
TIMESTAMP = TimestampType()
STRING = StringType()


@dataclasses.dataclass(frozen=True, eq=True)
class StructField:
    name: str
    dtype: DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: tuple

    @property
    def names(self):
        return [f.name for f in self.fields]

    @property
    def types(self):
        return [f.dtype for f in self.fields]

    def __len__(self):
        return len(self.fields)


_NUMERIC_ORDER = [INT8, INT16, INT32, INT64, FLOAT32, FLOAT64]


def common_type(a: DataType, b: DataType) -> DataType:
    """Numeric widening for binary expressions (the same rules as the JAX
    package's ``types.common_type`` for the types carried here)."""
    if a == b:
        return a
    if a in _NUMERIC_ORDER and b in _NUMERIC_ORDER:
        return _NUMERIC_ORDER[max(_NUMERIC_ORDER.index(a),
                                  _NUMERIC_ORDER.index(b))]
    raise TypeError(f"no common type for {a!r} and {b!r}")


def from_arrow(at) -> DataType:
    """Map a pyarrow type to this engine's type set."""
    import pyarrow as pa
    if pa.types.is_boolean(at):
        return BOOLEAN
    if pa.types.is_int8(at):
        return INT8
    if pa.types.is_int16(at):
        return INT16
    if pa.types.is_int32(at):
        return INT32
    if pa.types.is_int64(at):
        return INT64
    if pa.types.is_float32(at):
        return FLOAT32
    if pa.types.is_float64(at):
        return FLOAT64
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return STRING
    if pa.types.is_dictionary(at) and (pa.types.is_string(at.value_type)
                                       or pa.types.is_large_string(
                                           at.value_type)):
        return STRING
    if pa.types.is_date32(at):
        return DATE
    if pa.types.is_timestamp(at):
        return TIMESTAMP
    raise NotImplementedError(f"arrow type {at} is not supported yet")


def to_arrow(dtype: DataType):
    import pyarrow as pa
    return {
        BOOLEAN: pa.bool_(), INT8: pa.int8(), INT16: pa.int16(),
        INT32: pa.int32(), INT64: pa.int64(), FLOAT32: pa.float32(),
        FLOAT64: pa.float64(), STRING: pa.string(), DATE: pa.date32(),
        TIMESTAMP: pa.timestamp("us"),
    }[dtype]


# ---------------------------------------------------------------------------
# TypeSig: set algebra over supported types (the JAX package's
# ``types.TypeSig``, after the reference's TypeChecks.scala). The tags of
# the types the port does not carry yet ("NULL", "DECIMAL64", the nested
# ones) stay in the signatures, so those types can be added without
# rewriting them; no port type maps to them yet, and the element types of
# nested columns are checked once the port has them.
# ---------------------------------------------------------------------------

_BASE_ORDER = [
    "NULL", "BOOLEAN", "INT8", "INT16", "INT32", "INT64", "FLOAT32",
    "FLOAT64", "DECIMAL64", "STRING", "DATE", "TIMESTAMP", "ARRAY",
    "STRUCT", "MAP",
]

_TAGS = {BooleanType: "BOOLEAN", Int8Type: "INT8", Int16Type: "INT16",
         Int32Type: "INT32", Int64Type: "INT64", Float32Type: "FLOAT32",
         Float64Type: "FLOAT64", StringType: "STRING", DateType: "DATE",
         TimestampType: "TIMESTAMP"}


def _tag_of(dtype: DataType) -> str:
    try:
        return _TAGS[type(dtype)]
    except KeyError:
        raise TypeError(f"unknown dtype {dtype!r}") from None


class TypeSig:
    """An immutable set of type tags."""

    def __init__(self, tags=()):
        self.tags = frozenset(tags)

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.tags | other.tags)

    def nested(self) -> "TypeSig":
        """The same set, allowed inside arrays, structs and maps too."""
        return TypeSig(self.tags | {"ARRAY", "STRUCT", "MAP"})

    def reason_not_supported(self, dtype: DataType) -> Optional[str]:
        if _tag_of(dtype) in self.tags:
            return None
        return f"{dtype!r} is not supported"

    def __repr__(self):
        ordered = [t for t in _BASE_ORDER if t in self.tags]
        return "TypeSig(" + "+".join(ordered) + ")"


class Sigs:
    """The named combinations of the JAX package (and TypeChecks.scala)."""
    INTEGRAL = TypeSig(["INT8", "INT16", "INT32", "INT64"])
    FP = TypeSig(["FLOAT32", "FLOAT64"])
    NUMERIC = INTEGRAL + FP + TypeSig(["DECIMAL64"])
    COMMON = NUMERIC + TypeSig(["BOOLEAN", "STRING", "DATE", "TIMESTAMP",
                                "NULL"])
