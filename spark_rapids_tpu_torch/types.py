"""SQL data types of the PyTorch engine, each with its torch plane dtype.

Counterpart of ``spark_rapids_tpu/types.py``, cut to the types this engine
carries on the card: bool, int8/16/32/64, float32/64, date (int32 days
since the epoch), timestamp (int64 microseconds since the epoch, UTC),
DECIMAL64 (unscaled int64 values, precision at most 18), UTF-8 strings
(offsets + bytes, or dictionary codes + vocabulary), arrays (int32
offsets + a child column), structs (one child column per field, at the
row capacity) and maps (int32 offsets + key and value child columns),
and the NULL type (an int8 zero plane, every row invalid).
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
        return isinstance(self, (IntegralType, FractionalType, DecimalType))

    @property
    def is_integral(self) -> bool:
        return isinstance(self, IntegralType)


class NullType(DataType):
    """The type of an untyped NULL: an int8 carrier plane, every row
    invalid."""
    np_dtype = np.dtype(np.int8)
    torch_dtype = torch.int8


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


@dataclasses.dataclass(frozen=True, eq=True)
class DecimalType(DataType):
    """A decimal as its unscaled value in an int64 plane (DECIMAL64):
    precision at most MAX_INT64_PRECISION digits. Arithmetic rescales
    explicitly in the expressions, as in the JAX package."""
    precision: int = 10
    scale: int = 0

    np_dtype = np.dtype(np.int64)
    torch_dtype = torch.int64
    MAX_INT64_PRECISION = 18

    def __repr__(self) -> str:
        return f"decimal({self.precision},{self.scale})"


class StringType(DataType):
    """UTF-8 strings: int32 offsets + uint8 bytes, or dictionary-encoded
    as int32 codes into a small vocabulary (the default upload layout)."""


@dataclasses.dataclass(frozen=True, eq=True)
class ArrayType(DataType):
    """An array column: int32 offsets (capacity + 1) and a child column
    holding every row's elements back to back."""
    element: DataType = dataclasses.field(default_factory=Int32Type)
    contains_null: bool = True

    def __repr__(self) -> str:
        return f"array<{self.element!r}>"


NULL = NullType()
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


@dataclasses.dataclass(frozen=True, eq=True)
class StructType(DataType):
    """A struct column: one child column per field at the row capacity,
    and the struct's own row validity (a null row may have valid
    children)."""
    fields: tuple = ()

    def __repr__(self) -> str:
        inner = ",".join(f"{f.name}:{f.dtype!r}" for f in self.fields)
        return f"struct<{inner}>"

    def field_names(self):
        return [f.name for f in self.fields]


@dataclasses.dataclass(frozen=True, eq=True)
class MapType(DataType):
    """A map column: int32 offsets (capacity + 1) and key and value child
    columns of the same element capacity."""
    key: DataType = dataclasses.field(default_factory=StringType)
    value: DataType = dataclasses.field(default_factory=StringType)

    def __repr__(self) -> str:
        return f"map<{self.key!r},{self.value!r}>"


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
    package's ``types.common_type`` for the types carried here). Two
    decimals meet at the larger scale and integer digits, capped at 18
    digits; a decimal and an integer take the decimal; a decimal and a
    float take FLOAT64."""
    if a == b:
        return a
    if isinstance(a, DecimalType) and isinstance(b, DecimalType):
        scale = max(a.scale, b.scale)
        precision = min(max(a.precision - a.scale, b.precision - b.scale)
                        + scale, DecimalType.MAX_INT64_PRECISION)
        return DecimalType(precision, scale)
    if isinstance(a, DecimalType) and b.is_integral:
        return a
    if isinstance(b, DecimalType) and a.is_integral:
        return b
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        return FLOAT64
    if a in _NUMERIC_ORDER and b in _NUMERIC_ORDER:
        return _NUMERIC_ORDER[max(_NUMERIC_ORDER.index(a),
                                  _NUMERIC_ORDER.index(b))]
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
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
    if pa.types.is_decimal(at):
        if at.precision > DecimalType.MAX_INT64_PRECISION:
            raise NotImplementedError(
                f"{at}: decimals carry at most "
                f"{DecimalType.MAX_INT64_PRECISION} digits (DECIMAL64)")
        return DecimalType(at.precision, at.scale)
    if pa.types.is_null(at):
        return NULL
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return ArrayType(from_arrow(at.value_type))
    if pa.types.is_struct(at):
        return StructType(tuple(StructField(f.name, from_arrow(f.type))
                                for f in at))
    if pa.types.is_map(at):
        return MapType(from_arrow(at.key_type), from_arrow(at.item_type))
    raise NotImplementedError(f"arrow type {at} is not supported yet")


def to_arrow(dtype: DataType):
    import pyarrow as pa
    if isinstance(dtype, DecimalType):
        return pa.decimal128(dtype.precision, dtype.scale)
    if isinstance(dtype, ArrayType):
        return pa.list_(to_arrow(dtype.element))
    if isinstance(dtype, StructType):
        return pa.struct([pa.field(f.name, to_arrow(f.dtype))
                          for f in dtype.fields])
    if isinstance(dtype, MapType):
        return pa.map_(to_arrow(dtype.key), to_arrow(dtype.value))
    return {
        BOOLEAN: pa.bool_(), INT8: pa.int8(), INT16: pa.int16(),
        INT32: pa.int32(), INT64: pa.int64(), FLOAT32: pa.float32(),
        FLOAT64: pa.float64(), STRING: pa.string(), DATE: pa.date32(),
        TIMESTAMP: pa.timestamp("us"), NULL: pa.null(),
    }[dtype]


# ---------------------------------------------------------------------------
# TypeSig: set algebra over supported types (the JAX package's
# ``types.TypeSig``, after the reference's TypeChecks.scala).
# ---------------------------------------------------------------------------

_BASE_ORDER = [
    "NULL", "BOOLEAN", "INT8", "INT16", "INT32", "INT64", "FLOAT32",
    "FLOAT64", "DECIMAL64", "STRING", "DATE", "TIMESTAMP", "ARRAY",
    "STRUCT", "MAP",
]

_TAGS = {NullType: "NULL", BooleanType: "BOOLEAN", Int8Type: "INT8",
         Int16Type: "INT16", Int32Type: "INT32", Int64Type: "INT64",
         Float32Type: "FLOAT32", Float64Type: "FLOAT64", DecimalType: "DECIMAL64",
         StringType: "STRING", DateType: "DATE", TimestampType: "TIMESTAMP",
         ArrayType: "ARRAY", StructType: "STRUCT", MapType: "MAP"}


def _tag_of(dtype: DataType) -> str:
    try:
        return _TAGS[type(dtype)]
    except KeyError:
        raise TypeError(f"unknown dtype {dtype!r}") from None


class TypeSig:
    """An immutable set of type tags, and the set allowed inside an array,
    a struct or a map (``nested_sig``; none unless ``nested()`` made the
    signature)."""

    def __init__(self, tags=(), nested: Optional["TypeSig"] = None):
        self.tags = frozenset(tags)
        self.nested_sig = nested

    def __add__(self, other: "TypeSig") -> "TypeSig":
        nested = self.nested_sig or other.nested_sig
        if self.nested_sig and other.nested_sig:
            nested = self.nested_sig + other.nested_sig
        return TypeSig(self.tags | other.tags, nested)

    def nested(self) -> "TypeSig":
        """The same set, allowed inside arrays, structs and maps too."""
        return TypeSig(self.tags | {"ARRAY", "STRUCT", "MAP"}, nested=self)

    def supports(self, dtype: DataType) -> bool:
        if _tag_of(dtype) not in self.tags:
            return False
        inner = self.nested_sig or TypeSig()
        if isinstance(dtype, ArrayType):
            return inner.supports(dtype.element)
        if isinstance(dtype, StructType):
            return all(inner.supports(f.dtype) for f in dtype.fields)
        if isinstance(dtype, MapType):
            return inner.supports(dtype.key) and inner.supports(dtype.value)
        return True

    def reason_not_supported(self, dtype: DataType) -> Optional[str]:
        if self.supports(dtype):
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
