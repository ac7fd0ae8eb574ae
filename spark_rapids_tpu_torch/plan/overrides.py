"""Plan tagging and conversion: logical plan nodes -> physical operators.

Counterpart of ``spark_rapids_tpu/plan/overrides.py``. Every plan node is
wrapped in a ``SparkPlanMeta`` and tagged with the reasons it cannot run
on the device, by the JAX package's rules: type signatures of each
expression and aggregate (``EXPR_RULES``, ``AGG_RULES``, under the JAX
package's rule names, so the per-operator keys
spark.rapids.sql.expression.<rule name> and spark.rapids.sql.exec.<plan
node> match), the float and incompatible-op switches, the partition
context outside a projection (``PROJECT_ONLY_EXPRS``) and the window
rules (``_tag_window``). Conversion is bottom-up: a node without reasons
becomes its device operator, a node with reasons a ``CpuFallbackExec``
over the CPU backend, so one operator runs on the host and the rest of
the plan stays on the card. ``explain`` prints the placement report in
the JAX package's layout (``*`` on the device, ``!`` on the CPU with an
``@`` line per reason), and spark.rapids.sql.test.enabled turns any
fallback not allowed by spark.rapids.sql.test.allowedNonTpu into an
error (``_assert_on_tpu``). The tags decide at plan time and nothing else
does: no device operator falls back when it fails.

The device operators: in-memory, Parquet and cached scans, ranges,
unions, generates (explode and posexplode, plain and outer), expands
(one projection per batch, or stacked where stage fusion takes them into
a fused stage or an aggregate's absorbed chain), projections
and filters (a filter that reads the partition context, such as
``sample``'s ``rand``, over its input collected into one partition), hash
and round-robin repartition, the hash aggregate with its tiny-bucket,
packed (scatter, segsum, sort) and sort routes (segmented aggregates such
as percentile take a hash exchange of raw rows by key first; others over
several partitions collect and aggregate once, or run partial -> collect
-> final when the input's estimate is above 64M rows or unknown), sort (a
range exchange first over several partitions), limit and TopN, window
functions (a hash exchange on the partition keys, or a collect when there
are none, below ``WindowExec``), equi-joins of every type, broadcast,
shuffled or adaptive (``exec/adaptive.py``) as the JAX package plans them,
non-equi joins (``BroadcastNestedLoopJoinExec``) and cross joins
(``CartesianProductExec``).
"""
from __future__ import annotations

import copy
import dataclasses
from functools import reduce
from typing import Callable, Dict, List, Optional, Type

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import adaptive as AQ
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import array_ops as AO
from spark_rapids_tpu_torch.expr import complex as CX
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import cpu_functions as CF
from spark_rapids_tpu_torch.expr import datetime as DT
from spark_rapids_tpu_torch.expr import hof as H
from spark_rapids_tpu_torch.expr import json_functions as JF
from spark_rapids_tpu_torch.expr import math as MA
from spark_rapids_tpu_torch.expr import misc as MX
from spark_rapids_tpu_torch.expr import strings as S
from spark_rapids_tpu_torch.expr import tzdb
from spark_rapids_tpu_torch.io.parquet_pruning import split_conjuncts
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.plan.cost import apply_cost_optimizer
from spark_rapids_tpu_torch.types import Sigs, TypeSig

PORT_TAG_DIFFERENCES = """Where the port's tags differ from the JAX package's.

A tag of the JAX package the port drops: a filter that reads the
partition context (``sample``'s ``rand``, ``spark_partition_id()``) stays
on the device, over its input collected into one partition, and keeps the
rows the JAX package's CPU filter keeps (``PROJECT_ONLY_EXPRS``). The
partition context in an aggregate, a join, a sort or a window goes to the
CPU, as in the JAX package.
"""


# ---------------------------------------------------------------------------
# Expression rules (the JAX package's registrations, for the port's
# classes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExprRule:
    name: str
    input_sig: TypeSig
    result_sig: TypeSig
    doc: str = ""
    extra: Optional[Callable] = None


EXPR_RULES: Dict[Type, ExprRule] = {}


def expr_rule(cls: Type, input_sig: TypeSig = Sigs.COMMON,
              result_sig: TypeSig = Sigs.COMMON, doc: str = "",
              extra=None):
    EXPR_RULES[cls] = ExprRule(cls.__name__, input_sig, result_sig, doc,
                               extra)


_NUM = Sigs.NUMERIC + TypeSig(["NULL"])
_NUMDT = _NUM + TypeSig(["DATE", "TIMESTAMP", "BOOLEAN"])
#: column references, aliases and null tests pass nested columns through
_NESTED_OK = Sigs.COMMON.nested()

expr_rule(E.BoundRef, _NESTED_OK, _NESTED_OK, "column reference")
expr_rule(E.Literal, Sigs.COMMON, Sigs.COMMON, "literal value")
expr_rule(E.Alias, _NESTED_OK, _NESTED_OK, "named expression")
expr_rule(E.NullOf, Sigs.COMMON, Sigs.COMMON, "typed null")
expr_rule(E.SparkPartitionID, Sigs.COMMON, Sigs.COMMON,
          "spark_partition_id()")
expr_rule(E.MonotonicallyIncreasingID, Sigs.COMMON, Sigs.COMMON,
          "monotonically_increasing_id()")
expr_rule(E.Add, _NUM, _NUM, "addition")
expr_rule(E.Subtract, _NUM, _NUM, "subtraction")
expr_rule(E.Multiply, _NUM, _NUM, "multiplication")
expr_rule(E.Divide, _NUM, _NUM, "division (double result)")
expr_rule(E.IntegralDivide, _NUM, _NUM, "integral division")
expr_rule(E.Remainder, _NUM, _NUM, "modulo")
expr_rule(E.UnaryMinus, _NUM, _NUM, "negation")
expr_rule(E.Abs, _NUM, _NUM, "absolute value")


def _no_string_order(e) -> Optional[str]:
    if any(isinstance(c.data_type(), T.StringType) for c in e.children):
        return "string ordering comparison not supported on device"
    return None


expr_rule(E.EqualTo, Sigs.COMMON, Sigs.COMMON, "equality")
expr_rule(E.EqualNullSafe, Sigs.COMMON, Sigs.COMMON, "null-safe equality")
expr_rule(E.LessThan, _NUMDT, _NUMDT, "less than", extra=_no_string_order)
expr_rule(E.LessThanOrEqual, _NUMDT, _NUMDT, "<=", extra=_no_string_order)
expr_rule(E.GreaterThan, _NUMDT, _NUMDT, ">", extra=_no_string_order)
expr_rule(E.GreaterThanOrEqual, _NUMDT, _NUMDT, ">=",
          extra=_no_string_order)
expr_rule(E.And, Sigs.COMMON, Sigs.COMMON, "logical AND (Kleene)")
expr_rule(E.Or, Sigs.COMMON, Sigs.COMMON, "logical OR (Kleene)")
expr_rule(E.Not, Sigs.COMMON, Sigs.COMMON, "logical NOT")
expr_rule(E.IsNull, _NESTED_OK, Sigs.COMMON, "null test")
expr_rule(E.IsNotNull, _NESTED_OK, Sigs.COMMON, "not-null test")
expr_rule(E.IsNaN, _NUM, _NUM, "NaN test")
expr_rule(E.In, Sigs.COMMON, Sigs.COMMON, "IN literal list")
expr_rule(E.If, Sigs.COMMON, Sigs.COMMON, "conditional")
expr_rule(E.CaseWhen, Sigs.COMMON, Sigs.COMMON, "CASE WHEN")
expr_rule(E.Coalesce, Sigs.COMMON, Sigs.COMMON, "coalesce")
for _cls in (E.KnownNotNull, E.KnownFloatingPointNormalized,
             E.NormalizeNaNAndZero, E.AtLeastNNonNulls):
    expr_rule(_cls, Sigs.COMMON, Sigs.COMMON, _cls.__name__)


# Cast: only the device-implemented matrix (reference GpuCast type matrix)
_CASTABLE_FIXED = (T.BooleanType, T.Int8Type, T.Int16Type, T.Int32Type,
                   T.Int64Type, T.Float32Type, T.Float64Type, T.DateType,
                   T.TimestampType, T.DecimalType)


def _cast_check(e) -> Optional[str]:
    """The JAX package's rule: every fixed-width cast, boolean, integer,
    date and timestamp to string, and string to integer, float, date and
    timestamp run on the device (``expr/strings.cast_string_device``)."""
    src = e.children[0].data_type()
    dst = e.to
    if isinstance(src, T.StringType) and isinstance(dst, T.StringType):
        return None
    if isinstance(src, _CASTABLE_FIXED) and isinstance(dst, _CASTABLE_FIXED):
        return None
    if isinstance(dst, T.StringType):
        if isinstance(src, (T.BooleanType, T.DateType, T.TimestampType)) \
                or src.is_integral:
            return None
        return f"cast {src!r} -> string not supported on device"
    if isinstance(src, T.StringType):
        if dst.is_integral or isinstance(dst, (T.Float32Type, T.Float64Type,
                                               T.DateType, T.TimestampType)):
            return None
        return f"cast string -> {dst!r} not supported on device"
    if isinstance(src, T.NullType):
        return None
    return f"cast {src!r} -> {dst!r} not supported on device"


expr_rule(E.Cast, Sigs.COMMON, Sigs.COMMON, "cast", extra=_cast_check)

expr_rule(S.StringLength, Sigs.COMMON, Sigs.COMMON, "character length")
expr_rule(S.Upper, Sigs.COMMON, Sigs.COMMON, "uppercase (ASCII)")
expr_rule(S.Lower, Sigs.COMMON, Sigs.COMMON, "lowercase (ASCII)")
expr_rule(S.Substring, Sigs.COMMON, Sigs.COMMON, "substring")
expr_rule(S.ConcatStrings, Sigs.COMMON, Sigs.COMMON, "string concat")
expr_rule(S.StartsWith, Sigs.COMMON, Sigs.COMMON, "prefix match")
expr_rule(S.EndsWith, Sigs.COMMON, Sigs.COMMON, "suffix match")
expr_rule(S.Contains, Sigs.COMMON, Sigs.COMMON, "substring match")


def _like_check(e) -> Optional[str]:
    if not e.supported_on_tpu():
        return (f"LIKE pattern {e.pattern!r} does not transpile to device "
                f"kernels (reference RegexParser reject strategy)")
    return None


expr_rule(S.Like, Sigs.COMMON, Sigs.COMMON, "SQL LIKE", extra=_like_check)
expr_rule(S._StringEquals, Sigs.COMMON, Sigs.COMMON, "string equality")
expr_rule(S._AndExpr, Sigs.COMMON, Sigs.COMMON, "internal AND")

def _rlike_check(e):
    if not e.supported_on_tpu():
        return (f"regex {e.pattern!r} outside the device NFA subset: "
                f"{e._nfa_err} (reference RegexParser reject strategy)")
    return None


expr_rule(S.RLike, Sigs.COMMON, Sigs.COMMON,
          "Java regex match (bit-parallel device NFA)", extra=_rlike_check)


def _extract_check(e):
    if not e.supported_on_tpu():
        return (f"regexp_extract pattern {e.pattern!r} outside the tagged "
                f"device NFA subset: {e._nfa_err} (reference RegexParser "
                f"reject strategy)")
    return None


expr_rule(S.RegexpExtract, Sigs.COMMON, Sigs.COMMON,
          "regex capture extract (tagged device NFA; rejects fall back)",
          extra=_extract_check)


def _replace_check(e):
    if not e.supported_on_tpu():
        return (f"regexp_replace pattern {e.pattern!r} outside the device "
                f"replace subset: {e._nfa_err} (reference RegexParser "
                f"reject strategy)")
    return None


expr_rule(S.RegexpReplace, Sigs.COMMON, Sigs.COMMON,
          "regex replace-all (tagged device NFA span scan + byte "
          "splice; backrefs and rejects fall back)",
          extra=_replace_check)
for _cls in (S.Trim, S.LTrim, S.RTrim, S.InitCap, S.Ascii, S.InStr,
             S.StringRepeat, S.OctetLength, S.BitLength, S.Left, S.Right,
             S.Chr):
    expr_rule(_cls, Sigs.COMMON, Sigs.COMMON, _cls.__name__.lower())


expr_rule(MA.Murmur3Hash, Sigs.COMMON, Sigs.COMMON,
          "Spark murmur3 hash (seed 42), bit-parity with CPU Spark")
expr_rule(MX.XxHash64, Sigs.COMMON, Sigs.COMMON,
          "xxhash64 (Spark-compatible, seed 42)",
          extra=lambda e: None if e.supported_on_tpu()
          else "xxhash64 over string/nested columns runs on CPU")
expr_rule(MX.Rand, Sigs.COMMON, Sigs.COMMON,
          "rand([seed]) — splitmix64 stream (distribution-equivalent to "
          "Spark's XORShift, stream differs; documented)")
for _cls in (MA.Sqrt, MA.Exp, MA.Log, MA.Log10, MA.Log2, MA.Sin, MA.Cos,
             MA.Tan, MA.Asin, MA.Acos, MA.Atan, MA.Sinh, MA.Cosh, MA.Tanh,
             MA.Ceil, MA.Floor, MA.Pow, MA.Round, MA.Signum, MA.Atan2,
             MA.Greatest, MA.Least, MA.Cbrt, MA.Cot, MA.Sec, MA.Csc,
             MA.ToDegrees, MA.ToRadians, MA.Expm1, MA.Log1p, MA.Rint,
             MA.Hypot, MA.NaNvl):
    expr_rule(_cls, _NUM, _NUM, _cls.__name__.lower())
expr_rule(MA.Factorial, _NUM, _NUM, "factorial (null outside [0, 20])")
expr_rule(MA.BitwiseCount, _NUM, _NUM, "bit_count")
expr_rule(MA.BitwiseGet, _NUM, _NUM, "getbit")
expr_rule(MA.BRound, _NUM, _NUM, "bround (HALF_EVEN)")
expr_rule(MA.Logarithm, Sigs.COMMON, Sigs.COMMON, "log(base, expr)")
expr_rule(MA.WidthBucket, Sigs.COMMON, Sigs.COMMON, "width_bucket")
for _cls in (MA.Acosh, MA.Asinh, MA.Atanh, MA.Pmod, MA.UnaryPositive):
    expr_rule(_cls, Sigs.COMMON, Sigs.COMMON, _cls.__name__.lower())
for _cls in (MA.BitwiseAnd, MA.BitwiseOr, MA.BitwiseXor, MA.BitwiseNot,
             MA.ShiftLeft, MA.ShiftRight, MA.ShiftRightUnsigned):
    expr_rule(_cls, _NUM, _NUM, _cls.__name__.lower())

# datetime
for _cls in (DT.Year, DT.Month, DT.DayOfMonth, DT.Hour, DT.Minute, DT.Second,
             DT.DayOfWeek, DT.DateAdd, DT.DateSub, DT.DateDiff, DT.LastDay,
             DT.Quarter, DT.DayOfYear, DT.WeekOfYear, DT.AddMonths,
             DT.UnixTimestampFromTs, DT.TimestampSeconds):
    expr_rule(_cls, _NUMDT, _NUMDT, _cls.__name__.lower())


def _trunc_check(e):
    if not e.supported_on_tpu():
        return f"trunc format {e.fmt!r} not supported on device"
    return None


expr_rule(DT.TruncDate, _NUMDT, _NUMDT, "trunc(date, fmt)", extra=_trunc_check)
expr_rule(DT.FromUtcTimestamp, Sigs.COMMON, Sigs.COMMON,
          "from_utc_timestamp (IANA transition table on device)",
          extra=lambda e: None if e.supported_on_tpu()
          else f"unknown timezone {e.zone!r}")
expr_rule(DT.ToUtcTimestamp, Sigs.COMMON, Sigs.COMMON,
          "to_utc_timestamp (IANA transition table on device)",
          extra=lambda e: None if e.supported_on_tpu()
          else f"unknown timezone {e.zone!r}")
expr_rule(DT.MakeDate, Sigs.COMMON, Sigs.COMMON, "make_date")
expr_rule(DT.NextDay, Sigs.COMMON, Sigs.COMMON, "next_day")
expr_rule(DT.MonthsBetween, Sigs.COMMON, Sigs.COMMON, "months_between")
for _cls in (DT.UnixDate, DT.DateFromUnixDate, DT.UnixMicros,
             DT.UnixMillis, DT.UnixSeconds, DT.TimestampMillis,
             DT.TimestampMicros, DT.WeekDay, DT.TruncTimestamp):
    expr_rule(_cls, Sigs.COMMON, Sigs.COMMON, _cls.__name__.lower())

expr_rule(MX.HiveHash, Sigs.COMMON, Sigs.COMMON, "hive hash")
expr_rule(MX.Crc32, Sigs.COMMON, Sigs.COMMON, "crc32")
for _mcls in MX.MISC_CPU_FUNCTIONS:
    expr_rule(_mcls, Sigs.COMMON, _NESTED_OK,
              f"{_mcls.name} (CPU tier)",
              extra=lambda e: f"{e.name} runs on CPU (no device kernel yet)")

# CPU-only row functions: registered so tagging gives a clear reason and
# the enclosing operator falls back
for _cls in CF.ALL_CPU_FUNCTIONS:
    expr_rule(_cls, Sigs.COMMON, Sigs.COMMON,
              f"{_cls.name} (CPU; no device kernel yet)",
              extra=lambda e: f"{e.name} runs on CPU (no device kernel yet)")

# UDFs (reference RapidsUDF SPI / row-based UDF bridge / udf-compiler)
from spark_rapids_tpu_torch.sql import udf as UDF  # noqa: E402

expr_rule(UDF.PythonRowUDF, Sigs.COMMON, Sigs.COMMON,
          "opaque python row UDF (CPU)",
          extra=lambda e: f"python UDF {e.name!r} runs on CPU "
                          f"(use torch_udf for device execution)")
expr_rule(UDF.TorchColumnarUDF, Sigs.COMMON, Sigs.COMMON,
          "columnar torch UDF (runs on the batch's device)")


def _cpu_tier(doc):
    return lambda e: doc


for _cls, _doc in ((CF.FindInSet, "find_in_set"),
                   (CF.Levenshtein, "levenshtein"),
                   (CF.Base64Encode, "base64"), (CF.UnBase64, "unbase64"),
                   (CF.FormatString, "format_string"), (CF.Elt, "elt"),
                   (CF.Soundex, "soundex"), (CF.Sha1, "sha1"),
                   (CF.HexStr, "hex"), (CF.Unhex, "unhex"), (CF.Bin, "bin"),
                   (CF.Conv, "conv"), (CF.UrlEncode, "url_encode"),
                   (CF.UrlDecode, "url_decode"),
                   (CF.Luhncheck, "luhn_check")):
    expr_rule(_cls, Sigs.COMMON, Sigs.COMMON, _doc,
              extra=_cpu_tier(f"{_doc} runs on CPU"))
expr_rule(CF.RegexpExtractAll, _NESTED_OK, _NESTED_OK, "regexp_extract_all",
          extra=_cpu_tier("regexp_extract_all runs on CPU"))
expr_rule(CF.JsonTuple, _NESTED_OK, _NESTED_OK, "json_tuple",
          extra=_cpu_tier("json_tuple runs on CPU"))
expr_rule(CF.StructsToJson, _NESTED_OK, _NESTED_OK, "to_json",
          extra=_cpu_tier("to_json runs on CPU"))

# JSON functions (reference GpuGetJsonObject / GpuJsonToStructs): the host
# parse tier, with a visible fallback
for _jcls in JF.JSON_FUNCTIONS:
    expr_rule(_jcls, Sigs.COMMON, _NESTED_OK,
              f"{_jcls.name} (host JSON parse)",
              extra=lambda e: f"{e.name} runs on CPU (host JSON parse)")

# higher-order functions (lambdas over arrays and maps, expr/hof.py); a
# lambda body's own expressions are tagged with the function's node
expr_rule(H.LambdaVar, Sigs.COMMON, Sigs.COMMON, "lambda parameter")
expr_rule(H.ArrayTransform, _NESTED_OK, _NESTED_OK,
          "transform(array, lambda)")
expr_rule(H.ArrayFilter, _NESTED_OK, _NESTED_OK, "filter(array, lambda)")
expr_rule(H.ArrayExists, _NESTED_OK, Sigs.COMMON, "exists(array, lambda)")
expr_rule(H.ArrayForAll, _NESTED_OK, Sigs.COMMON, "forall(array, lambda)")
expr_rule(H.TransformKeys, _NESTED_OK, _NESTED_OK,
          "transform_keys(map, lambda)")
expr_rule(H.TransformValues, _NESTED_OK, _NESTED_OK,
          "transform_values(map, lambda)")
expr_rule(H.MapFilter, _NESTED_OK, _NESTED_OK, "map_filter(map, lambda)")
expr_rule(H.ZipWith, _NESTED_OK, _NESTED_OK, "zip_with(a, b, lambda)")
expr_rule(H.ArrayAggregate, _NESTED_OK, Sigs.COMMON,
          "aggregate(array, zero, merge[, finish]) — CPU fold",
          extra=lambda e: "aggregate() sequential lambda fold runs on CPU")


# complex types (complexTypeExtractors / complexTypeCreator /
# collectionOperations, and the generator markers)

def _primitive_elements_only(what: str):
    def check(e: E.Expression) -> Optional[str]:
        dt = e.children[0].data_type()
        inner = dt.element if isinstance(dt, T.ArrayType) else dt.key
        if isinstance(inner, (T.ArrayType, T.StructType, T.MapType)):
            return f"{what} over nested element types runs on CPU"
        return None
    return check


def _create_array_check(e: E.Expression) -> Optional[str]:
    if isinstance(e.data_type().element, (T.StringType, T.ArrayType,
                                          T.StructType, T.MapType,
                                          T.NullType)):
        return "array() of non-fixed-width elements runs on CPU"
    return None


expr_rule(CX.Size, _NESTED_OK, Sigs.COMMON, "size(array|map)")
expr_rule(CX.GetArrayItem, _NESTED_OK, _NESTED_OK, "array[ordinal]")
expr_rule(CX.ElementAt, _NESTED_OK, _NESTED_OK, "element_at(array|map, k)",
          extra=lambda e: (_primitive_elements_only("map key lookup")(e)
                           if isinstance(e.children[0].data_type(), T.MapType)
                           else None))
expr_rule(CX.GetMapValue, _NESTED_OK, _NESTED_OK, "map[key]",
          extra=_primitive_elements_only("map key lookup"))
expr_rule(CX.GetStructField, _NESTED_OK, _NESTED_OK, "struct field access")
expr_rule(CX.ArrayContains, _NESTED_OK, Sigs.COMMON, "array_contains",
          extra=_primitive_elements_only("array_contains"))
expr_rule(CX.CreateArray, Sigs.COMMON, _NESTED_OK, "array(...)",
          extra=_create_array_check)
expr_rule(CX.MapKeys, _NESTED_OK, _NESTED_OK, "map_keys")
expr_rule(CX.MapValues, _NESTED_OK, _NESTED_OK, "map_values")
expr_rule(CX.Stack, Sigs.COMMON, Sigs.COMMON,
          "stack(n, ...) (lowered to a union of projections)")


def _device_only_if_supported(what: str):
    return lambda e: None if e.supported_on_tpu() \
        else f"{what} over string/nested elements runs on CPU"


# array collection operations (array_ops.py)
expr_rule(AO.ArrayMin, _NESTED_OK, Sigs.COMMON, "array_min",
          extra=_device_only_if_supported("array_min"))
expr_rule(AO.ArrayMax, _NESTED_OK, Sigs.COMMON, "array_max",
          extra=_device_only_if_supported("array_max"))
expr_rule(AO.ArrayPosition, _NESTED_OK, Sigs.COMMON, "array_position")
expr_rule(AO.ArrayRemove, _NESTED_OK, _NESTED_OK, "array_remove")
expr_rule(AO.Slice, _NESTED_OK, _NESTED_OK, "slice")
expr_rule(AO.SortArray, _NESTED_OK, _NESTED_OK, "sort_array",
          extra=_device_only_if_supported("sort_array"))
expr_rule(AO.Flatten, _NESTED_OK, _NESTED_OK, "flatten")
expr_rule(AO.ArrayDistinct, _NESTED_OK, _NESTED_OK,
          "array_distinct (string elements dedup by 64-bit hash)")
expr_rule(AO.ArrayUnion, _NESTED_OK, _NESTED_OK, "array_union")
expr_rule(AO.ArrayIntersect, _NESTED_OK, _NESTED_OK, "array_intersect")
expr_rule(AO.ArrayExcept, _NESTED_OK, _NESTED_OK, "array_except")
expr_rule(AO.ArraysOverlap, _NESTED_OK, Sigs.COMMON, "arrays_overlap")
expr_rule(AO.MapEntries, _NESTED_OK, _NESTED_OK, "map_entries")
for _cls, _doc in ((AO.ArrayRepeat, "array_repeat"),
                   (AO.ArraysZip, "arrays_zip"), (AO.MapConcat, "map_concat"),
                   (AO.MapFromArrays, "map_from_arrays")):
    expr_rule(_cls, _NESTED_OK, _NESTED_OK, _doc,
              extra=_cpu_tier(f"{_doc} runs on CPU"))
expr_rule(AO.ArrayJoin, _NESTED_OK, Sigs.COMMON, "array_join",
          extra=_cpu_tier("array_join runs on CPU"))
expr_rule(AO.StrToMap, Sigs.COMMON, _NESTED_OK, "str_to_map",
          extra=_cpu_tier("str_to_map runs on CPU"))


AGG_RULES: Dict[Type, ExprRule] = {}


def agg_rule(cls, input_sig=_NUMDT, doc="", extra=None):
    AGG_RULES[cls] = ExprRule(cls.__name__, input_sig, Sigs.COMMON, doc,
                              extra)


def _no_string_input(fn) -> Optional[str]:
    if any(isinstance(c.data_type(), T.StringType) for c in fn.children):
        return f"{type(fn).__name__} over strings not supported on device"
    return None


def _primitive_input_only(what: str):
    def check(fn) -> Optional[str]:
        if any(isinstance(c.data_type(), (T.ArrayType, T.StructType,
                                          T.MapType))
               for c in fn.children):
            return f"{what} over nested inputs runs on CPU"
        return None
    return check


def _minmax_by_check(what: str):
    def check(fn) -> Optional[str]:
        r = _primitive_input_only(what)(fn)
        if r:
            return r
        # the device's ordering key for strings is an equality hash, not
        # order-faithful
        if isinstance(fn.children[1].data_type(), T.StringType):
            return f"{what} ordered by a string column runs on CPU"
        return None
    return check


agg_rule(A.Sum, _NUM, "sum")
agg_rule(A.Count, Sigs.COMMON, "count non-null")
agg_rule(A.CountAll, Sigs.COMMON, "count(*)")
agg_rule(A.Min, _NUMDT, "min", extra=_no_string_input)
agg_rule(A.Max, _NUMDT, "max", extra=_no_string_input)
agg_rule(A.Average, _NUM, "avg")
agg_rule(A.First, _NUMDT, "first", extra=_no_string_input)
agg_rule(A.Last, _NUMDT, "last", extra=_no_string_input)
agg_rule(A.StddevSamp, _NUM, "stddev_samp")
agg_rule(A.StddevPop, _NUM, "stddev_pop")
agg_rule(A.VarianceSamp, _NUM, "var_samp")
agg_rule(A.VariancePop, _NUM, "var_pop")
agg_rule(A.MinBy, Sigs.COMMON, "min_by", extra=_minmax_by_check("min_by"))
agg_rule(A.MaxBy, Sigs.COMMON, "max_by", extra=_minmax_by_check("max_by"))
agg_rule(A.CollectList, Sigs.COMMON, "collect_list",
         extra=_primitive_input_only("collect_list"))
agg_rule(A.CollectSet, Sigs.COMMON, "collect_set",
         extra=_primitive_input_only("collect_set"))
agg_rule(A.Percentile, _NUM, "percentile (exact)")
agg_rule(A.ApproxPercentile, _NUM,
         "approx_percentile (computed exactly on this engine)")


# ---------------------------------------------------------------------------
# Expression tagging
# ---------------------------------------------------------------------------

#: expressions that read the partition context only a projection threads
#: (and, in the port, a filter over one partition)
PROJECT_ONLY_EXPRS = (E.SparkPartitionID, E.MonotonicallyIncreasingID,
                      MX.Rand)
_PARTITION_CONTEXT_NODES = ("Project", "Filter")


_UTC_NAMES = ("UTC", "Etc/UTC", "GMT", "Etc/GMT", "Z", "+00:00")

#: expressions whose result depends on the session timezone when an input
#: (or the output) is a TIMESTAMP; DATE inputs are timezone-free
_TZ_SENSITIVE = (
    DT.Year, DT.Month, DT.DayOfMonth, DT.Hour, DT.Minute, DT.Second,
    DT.DayOfWeek, DT.LastDay, DT.Quarter, DT.DayOfYear, DT.WeekOfYear,
    DT.AddMonths, DT.TruncDate, DT.UnixTimestampFromTs,
    CF.DateFormat, CF.ToDateFmt, CF.FromUnixtime,
)


def _check_session_timezone(e: E.Expression, conf, where: str) -> None:
    """A non-UTC session timezone must never silently give UTC answers
    (reference GpuOverrides nonUTC tagging). A zone of the IANA database
    was localized already (``localize_plan``); an unknown zone is refused
    on a timezone-sensitive expression, with the JAX package's message:
    the CPU backend evaluates in UTC too, so there is nothing to fall back
    to."""
    tz = conf.get(C.SESSION_TIMEZONE)
    if tz in _UTC_NAMES or tzdb.is_valid_zone(tz):
        return
    if not isinstance(e, _TZ_SENSITIVE):
        return
    types = [e.data_type()] + [c.data_type() for c in e.children]
    always = isinstance(e, (DT.Hour, DT.Minute, DT.Second,
                            CF.FromUnixtime, CF.ToDateFmt))
    if always or any(isinstance(t, T.TimestampType) for t in types):
        raise E.SparkException(
            f"{where}: {type(e).__name__} with spark.sql.session.timeZone="
            f"{tz!r} is not supported (this engine evaluates timestamps in "
            f"UTC only); set the session timezone to UTC")


def _localize_node_fn(tz: str):
    """The per-node rewrite of timezone localization, for ONE bottom-up
    ``transform`` over an expression tree (applying the whole-tree rewrite
    at every node would wrap localized children again and shift
    timestamps twice). Field extraction and formatting of a timestamp
    read it through ``FromUtcTimestamp``; ``from_unixtime`` shifts its
    seconds through the timestamp domain; a cast of a timestamp to a date
    or a string reads the local time, and a cast of a date or a string to
    a timestamp is wrapped in ``ToUtcTimestamp``."""
    def is_ts(x):
        return isinstance(x.data_type(), T.TimestampType)

    def f(node):
        if isinstance(node, _TZ_SENSITIVE) and not isinstance(
                node, DT.UnixTimestampFromTs):
            if any(is_ts(c) for c in node.children):
                return node.with_children(
                    [DT.FromUtcTimestamp(c, tz) if is_ts(c) else c
                     for c in node.children])
            if isinstance(node, CF.FromUnixtime):
                sec = node.children[0]
                shifted = DT.UnixTimestampFromTs(
                    DT.FromUtcTimestamp(DT.TimestampSeconds(sec), tz))
                return node.with_children([shifted] + node.children[1:])
            return node
        if isinstance(node, E.Cast):
            src, dst = node.children[0].data_type(), node.to
            if isinstance(src, T.TimestampType) and isinstance(
                    dst, (T.DateType, T.StringType)):
                return node.with_children(
                    [DT.FromUtcTimestamp(node.children[0], tz)])
            if isinstance(dst, T.TimestampType) and isinstance(
                    src, (T.DateType, T.StringType)):
                return DT.ToUtcTimestamp(node, tz)
        return node

    return f


def localize_expr(e: E.Expression, tz: str) -> E.Expression:
    """An expression rewritten for a session in zone ``tz``: its TIMESTAMP
    operands shifted through the zone's transition table where the session
    zone matters (field extraction, formatting and parsing, date <->
    timestamp casts), so every datetime expression stays a plain UTC
    computation (reference: the GpuTimeZoneDB rewrite inside each datetime
    kernel; here one plan-level rule)."""
    return H.bind_lambda_types(e).transform(_localize_node_fn(tz))


def localize_plan(plan: P.PlanNode, conf) -> P.PlanNode:
    """The plan with every expression localized (``localize_expr``) when
    the session timezone is a zone of the IANA database other than UTC;
    the plan itself otherwise. The JAX package rewrites the DataFrame's
    plan in place, so its second collect of one DataFrame shifts every
    timestamp again; here the nodes with expressions are copied and the
    DataFrame's plan stays as it was. A cached relation is the one node
    kept: it is returned as it is once it holds its batches, and before
    that its input is localized from the original (kept aside), so it
    materializes in the zone of the session that runs it first."""
    tz = conf.get(C.SESSION_TIMEZONE)
    if tz in _UTC_NAMES or not tzdb.is_valid_zone(tz):
        return plan  # tagging refuses an unknown zone
    node_f = _localize_node_fn(tz)

    def fix(e):
        return H.bind_lambda_types(e).transform(node_f)

    def fix_orders(orders):
        return [dataclasses.replace(o, expr=fix(o.expr)) for o in orders]

    done: Dict[int, P.PlanNode] = {}

    def walk(n: P.PlanNode) -> P.PlanNode:
        if id(n) in done:
            return done[id(n)]
        if isinstance(n, P.CachedRelation):
            if n.materialized is None:
                if not hasattr(n, "unlocalized_children"):
                    n.unlocalized_children = list(n.children)
                n.children = [walk(c) for c in n.unlocalized_children]
            done[id(n)] = n
            return n
        q = copy.copy(n)
        q.children = [walk(c) for c in n.children]
        if isinstance(n, P.Project):
            q.exprs = [fix(e) for e in n.exprs]
        elif isinstance(n, P.Filter):
            q.condition = fix(n.condition)
        elif isinstance(n, P.Aggregate):
            q.group_exprs = [fix(e) for e in n.group_exprs]
            # transform() visits every node once bottom-up: pass the NODE
            # function (the tree-level fix would wrap twice)
            q.aggs = [a.transform(node_f) for a in n.aggs]
        elif isinstance(n, P.Expand):
            q.projections = [[fix(e) for e in row] for row in n.projections]
        elif isinstance(n, P.Join):
            q.left_keys = [fix(e) for e in n.left_keys]
            q.right_keys = [fix(e) for e in n.right_keys]
            if n.condition is not None:
                q.condition = fix(n.condition)
        elif isinstance(n, P.Sort):
            q.orders = fix_orders(n.orders)
        elif isinstance(n, P.WindowNode):
            from spark_rapids_tpu_torch.expr.window import (
                WindowExpr, WindowSpec,
            )
            q.window_exprs = [
                WindowExpr(fix(w.fn), WindowSpec(
                    [fix(e) for e in w.spec.partition_exprs],
                    fix_orders(w.spec.order_specs), w.spec.frame))
                for w in n.window_exprs]
        elif isinstance(n, P.Generate):
            q.generator = fix(n.generator)
        done[id(n)] = q
        return q

    return walk(plan)


def tag_expression(e: E.Expression, conf, reasons: List[str],
                   where: str) -> None:
    _check_session_timezone(e, conf, where)
    rule = EXPR_RULES.get(type(e))
    if rule is None:
        reasons.append(f"{where}: expression {type(e).__name__} is not "
                       f"supported on GPU")
        return
    if where not in _PARTITION_CONTEXT_NODES \
            and isinstance(e, PROJECT_ONLY_EXPRS):
        reasons.append(
            f"{where}: {rule.name} only evaluates in projection context "
            f"(partition id / row base are threaded by ProjectExec)")
    key = f"spark.rapids.sql.expression.{rule.name}"
    if not conf.is_op_enabled(key):
        reasons.append(f"{where}: expression {rule.name} disabled by {key}")
    r = rule.result_sig.reason_not_supported(e.data_type())
    if r:
        reasons.append(f"{where}: {rule.name} output {r}")
    for ch in e.children:
        r = rule.input_sig.reason_not_supported(ch.data_type())
        if r:
            reasons.append(f"{where}: {rule.name} input {r}")
    if rule.extra is not None:
        r = rule.extra(e)
        if r:
            reasons.append(f"{where}: {r}")
    for ch in e.children:
        tag_expression(ch, conf, reasons, where)


_FLOAT_ORDER_AGGS = (A.Sum, A.Average, A.VarianceSamp, A.VariancePop,
                     A.StddevSamp, A.StddevPop)


def tag_agg(fn: A.AggFunction, conf, reasons: List[str], where: str) -> None:
    rule = AGG_RULES.get(type(fn))
    if rule is None:
        reasons.append(f"{where}: aggregate {type(fn).__name__} is not "
                       f"supported on GPU")
        return
    if not conf.get(C.IMPROVED_FLOAT_OPS) \
            and isinstance(fn, _FLOAT_ORDER_AGGS):
        for ch in fn.children:
            if isinstance(ch.data_type(), (T.Float32Type, T.Float64Type)):
                reasons.append(
                    f"{where}: float {rule.name} accumulates in a "
                    f"different order than CPU Spark (ULP-level diffs) — "
                    f"disabled by spark.rapids.sql.improvedFloatOps."
                    f"enabled=false")
    if isinstance(fn, A.CollectSet) and not conf.get(C.INCOMPAT_ENABLED):
        for ch in fn.children:
            if isinstance(ch.data_type(), T.StringType):
                reasons.append(
                    f"{where}: collect_set over strings dedups by 64-bit "
                    f"double-hash on device — disabled by spark.rapids."
                    f"sql.incompatibleOps.enabled=false")
    if rule.extra is not None:
        r = rule.extra(fn)
        if r:
            reasons.append(f"{where}: {r}")
    for ch in fn.children:
        tag_expression(ch, conf, reasons, where)
        r = rule.input_sig.reason_not_supported(ch.data_type())
        if r:
            reasons.append(f"{where}: {rule.name} input {r}")


# ---------------------------------------------------------------------------
# Plan metas
# ---------------------------------------------------------------------------

_NESTED_TYPES = (T.ArrayType, T.StructType, T.MapType)


def _has_list_like(dt: T.DataType) -> bool:
    if isinstance(dt, (T.ArrayType, T.MapType)):
        return True
    if isinstance(dt, T.StructType):
        return any(_has_list_like(f.dtype) for f in dt.fields)
    return False


class SparkPlanMeta:
    """A plan node with its tagging and conversion (reference RapidsMeta /
    SparkPlanMeta)."""

    def __init__(self, plan: P.PlanNode, conf):
        self.plan = plan
        self.conf = conf
        self.children = [SparkPlanMeta(c, conf) for c in plan.children]
        self.reasons: List[str] = []

    # -- tagging -------------------------------------------------------------
    def tag_for_tpu(self) -> None:
        for c in self.children:
            c.tag_for_tpu()
        name = type(self.plan).__name__
        key = f"spark.rapids.sql.exec.{name}"
        if not self.conf.is_op_enabled(key):
            self.reasons.append(f"{name} disabled by {key}")
        if not self.conf.get(C.SQL_ENABLED):
            self.reasons.append("spark.rapids.sql.enabled is false")
        self._tag_schema()
        self._tag_node()

    #: nodes whose device paths carry nested columns (masks, gathers and
    #: concatenation, no key normalization; the JAX package's list, for
    #: the port's nodes)
    NESTED_SCHEMA_NODES = (P.Project, P.Filter, P.Generate,
                           P.InMemorySource, P.ParquetScan, P.TextScan,
                           P.ShuffleFileScan, P.Limit,
                           P.Union, P.Sort, P.CachedRelation, P.Aggregate)

    def _tag_schema(self) -> None:
        sig = Sigs.COMMON.nested() \
            if isinstance(self.plan, self.NESTED_SCHEMA_NODES) \
            else Sigs.COMMON
        for f in self.plan.schema.fields:
            r = sig.reason_not_supported(f.dtype)
            if r:
                self.reasons.append(f"output column {f.name}: {r}")

    def _tag_node(self) -> None:
        p = self.plan
        name = type(p).__name__
        conf, reasons = self.conf, self.reasons
        if isinstance(p, P.Project):
            for e in p.exprs:
                tag_expression(e, conf, reasons, name)
        elif isinstance(p, P.Filter):
            tag_expression(p.condition, conf, reasons, name)
        elif isinstance(p, P.Aggregate):
            for e in p.group_exprs:
                tag_expression(e, conf, reasons, name)
                if isinstance(e.data_type(), _NESTED_TYPES):
                    reasons.append(
                        f"{name}: grouping by nested type "
                        f"{e.data_type()!r} has no device key normalization")
            for a in p.aggs:
                tag_agg(a.fn, conf, reasons, name)
        elif isinstance(p, P.Sort):
            # string ORDER BY runs on the device by exact chunk keys
            for o in p.orders:
                tag_expression(o.expr, conf, reasons, name)
                odt = o.expr.data_type()
                if isinstance(odt, _NESTED_TYPES):
                    reasons.append(
                        f"{name}: ORDER BY on nested type {odt!r} has no "
                        f"device key normalization (runs on CPU)")
        elif isinstance(p, P.Join):
            for e in p.left_keys + p.right_keys:
                tag_expression(e, conf, reasons, name)
                if isinstance(e.data_type(), T.StringType) \
                        and not conf.get(C.INCOMPAT_ENABLED):
                    reasons.append(
                        f"{name}: string join keys compare by 64-bit "
                        f"double-hash on device (collision odds ~2^-64) — "
                        f"disabled by spark.rapids.sql.incompatibleOps."
                        f"enabled=false")
            if p.condition is not None:
                tag_expression(p.condition, conf, reasons, name)
        elif isinstance(p, P.Repartition):
            for e in p.keys:
                tag_expression(e, conf, reasons, name)
        elif isinstance(p, P.Expand):
            for proj in p.projections:
                for e in proj:
                    tag_expression(e, conf, reasons, name)
        elif isinstance(p, P.Generate):
            tag_expression(p.generator.children[0], conf, reasons, name)
            # the operator duplicates the required child columns; a
            # duplicating gather of a list-like column would overflow its
            # element planes (kernels._gather_list_like keeps their
            # capacity), so such a Generate runs on the CPU. Structs of
            # primitives duplicate fine (row planes only).
            for i in p.required:
                f = p.children[0].schema.fields[i]
                if _has_list_like(f.dtype):
                    reasons.append(
                        f"{name}: carrying array/map column {f.name} through "
                        f"explode needs a sized nested gather (runs on CPU)")
        elif isinstance(p, P.WindowNode):
            self._tag_window(p, name)

    def _tag_window(self, p, name) -> None:
        from spark_rapids_tpu_torch.expr import window as WE
        conf, reasons = self.conf, self.reasons
        for w in p.window_exprs:
            spec = w.spec
            for e in spec.partition_exprs:
                tag_expression(e, conf, reasons, name)
            for o in spec.order_specs:
                tag_expression(o.expr, conf, reasons, name)
                if isinstance(o.expr.data_type(), T.StringType):
                    reasons.append(
                        f"{name}: window ORDER BY on strings needs host sort")
            for c in w.fn.children:
                tag_expression(c, conf, reasons, name)
                if isinstance(c.data_type(), T.StringType):
                    reasons.append(
                        f"{name}: string-typed window operands run on CPU "
                        f"(device window kernels are fixed-width planes)")
            fn = w.fn
            frame = spec.resolved_frame()
            if isinstance(fn, (WE.NthValue, WE.FirstValue, WE.LastValue)) \
                    and (frame.lower is not None
                         or frame.upper not in (0, None)):
                reasons.append(
                    f"{name}: {type(fn).__name__} supports only "
                    f"unbounded-preceding frames ending at the current "
                    f"row or partition end")
            if isinstance(fn, (WE.RowNumber, WE.Rank, WE.DenseRank, WE.NTile,
                               WE.LeadLag, WE.PercentRank, WE.CumeDist,
                               WE.NthValue, WE.FirstValue, WE.LastValue)):
                continue  # an order is required at plan build
            if not isinstance(fn, WE.WindowAgg):
                reasons.append(f"{name}: window function "
                               f"{type(fn).__name__} not supported")
                continue
            if not isinstance(fn.fn, (A.Sum, A.Count, A.CountAll, A.Min,
                                      A.Max, A.Average)):
                reasons.append(f"{name}: {type(fn.fn).__name__} not "
                               f"supported in window frames on device")
            bounded_rows = frame.kind == "rows" and not (
                frame.lower is None and frame.upper in (0, None))
            if bounded_rows and isinstance(fn.fn, (A.Min, A.Max)):
                reasons.append(f"{name}: bounded-rows min/max window not "
                               f"yet on device (needs a sliding-extrema "
                               f"kernel)")

    @property
    def can_run_on_tpu(self) -> bool:
        return not self.reasons

    # -- conversion ----------------------------------------------------------
    def convert(self, device) -> X.TorchExec:
        children = [c.convert(device) for c in self.children]
        if self.reasons:
            return X.CpuFallbackExec(self.plan, children, self.conf, device)
        return _convert_node(self.plan, children, self.conf, device)

    # -- explain -------------------------------------------------------------
    def explain(self, indent: int = 0, all_ops: bool = False) -> str:
        """The placement report: ``* node`` on the device (``[GPU]`` when
        only fallbacks are listed), ``! node`` on the CPU with an ``@``
        line per reason."""
        pad = "  " * indent
        if all_ops or not self.can_run_on_tpu:
            mark = "*" if self.can_run_on_tpu else "!"
            lines = [f"{pad}{mark} {self.plan.describe()}"]
            lines += [f"{pad}    @ cannot run on GPU because: {r}"
                      for r in self.reasons]
        else:
            lines = [f"{pad}* {self.plan.describe()} [GPU]"]
        lines += [c.explain(indent + 1, all_ops) for c in self.children]
        return "\n".join(lines)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def wrap_and_tag(plan: P.PlanNode, conf) -> SparkPlanMeta:
    push_down_scan_filters(plan)
    meta = SparkPlanMeta(plan, conf)
    meta.tag_for_tpu()
    return meta


def convert_plan(plan: P.PlanNode, conf, device):
    """(root operator, tagged meta), as the JAX package converts: the
    session timezone's localization (``localize_plan``), then column
    pruning (``plan/prune.py``) before tagging, the static cost pass
    (``plan/cost.py``) after it. In test mode a fallback that
    spark.rapids.sql.test.allowedNonTpu does not name raises. The
    converted tree then gets its pipeline boundaries
    (``runtime/pipeline.insert_pipelines``), the plan verifier under
    spark.rapids.debug.planVerify.enabled and the LORE dumper under
    spark.rapids.sql.lore.dumpPath, in the JAX package's order: stage
    fusion (``exec/stage_fusion.fuse_stages``) runs first, then, under
    spark.rapids.sql.multichip.enabled, its sharding
    (``exec/sharded.shard_stages``)."""
    # prune imports this module's PROJECT_ONLY_EXPRS
    from spark_rapids_tpu_torch.plan.prune import prune_plan
    plan = localize_plan(plan, conf)
    plan = prune_plan(plan)
    meta = wrap_and_tag(plan, conf)
    apply_cost_optimizer(meta, conf)
    if conf.get(C.TEST_MODE):
        allowed = {s.strip() for s in str(conf.get(C.ALLOW_NON_TPU)
                                          or "").split(",") if s.strip()}
        _assert_on_tpu(meta, allowed)
    root = meta.convert(device)
    # whole-stage fusion: linear chains of narrow operators collapse into
    # one call a batch (spark.rapids.sql.stageFusion.enabled)
    from spark_rapids_tpu_torch.exec.stage_fusion import fuse_stages
    root = fuse_stages(root, conf)
    # multichip sharding: eligible fused stages run one call a device a
    # wave of partition batches (ineligible ones record their reason)
    if conf.get(C.MULTICHIP_ENABLED):
        from spark_rapids_tpu_torch.exec.sharded import shard_stages
        root = shard_stages(root, conf, device)
    # pipelined execution: bounded producer/consumer boundaries at
    # scan->compute edges (spark.rapids.sql.pipeline.enabled)
    from spark_rapids_tpu_torch.runtime.pipeline import insert_pipelines
    root = insert_pipelines(root, conf)
    if conf.get(C.PLAN_VERIFY_ENABLED):
        from spark_rapids_tpu_torch.analysis.plan_verify import verify_plan
        verify_plan(root)
    lore_dir = conf.get(C.LORE_DUMP_DIR)
    if lore_dir:
        from spark_rapids_tpu_torch.runtime.lore import LoreDumper
        LoreDumper(lore_dir).install(root)
    return root, meta


def _assert_on_tpu(meta: SparkPlanMeta, allowed: set) -> None:
    for m in meta.walk():
        name = type(m.plan).__name__
        if not m.can_run_on_tpu and name not in allowed:
            raise AssertionError(
                f"{name} fell back to CPU in test mode: {m.reasons}")


def explain_plan(plan: P.PlanNode, conf, all_ops: bool = False) -> str:
    """The placement report, with the cost pass's reversions; like the
    JAX package's, it neither localizes nor prunes (a zone of the IANA
    database tags as UTC does, so the report is the same)."""
    meta = wrap_and_tag(plan, conf)
    apply_cost_optimizer(meta, conf)
    return meta.explain(all_ops=all_ops)


def _convert_node(plan: P.PlanNode, children, conf, device) -> X.TorchExec:
    if isinstance(plan, P.InMemorySource):
        return X.InMemoryScanExec(plan, children, conf, device)
    if isinstance(plan, P.ParquetScan):
        if conf.get(C.DEVICE_DECODE_ENABLED):
            # the source coalesces row groups itself up to the reader
            # batch size, and encoded batches are not concatenable
            return X.DeviceDecodeScanExec(
                plan, [X.EncodedParquetSourceExec(plan, [], conf, device)],
                conf, device)
        return X.CoalesceBatchesExec(
            plan, [X.ParquetScanExec(plan, [], conf, device)], conf, device)
    if isinstance(plan, P.TextScan):
        return X.CoalesceBatchesExec(
            plan, [X.TextScanExec(plan, [], conf, device)], conf, device)
    if isinstance(plan, P.CachedRelation):
        return X.CachedScanExec(plan, children, conf, device)
    if isinstance(plan, P.ShuffleFileScan):
        return X.ShuffleFileScanExec(plan, [], conf, device)
    if isinstance(plan, P.Project):
        return X.ProjectExec(plan, children, conf, device)
    if isinstance(plan, P.Range):
        return X.RangeExec(plan, [], conf, device)
    if isinstance(plan, P.Filter):
        child = children[0]
        if E.needs_partition_context(plan.condition) \
                and child.num_partitions > 1:
            # the JAX package runs such a filter on the CPU, over its
            # input collected into one partition: partition 0, rows
            # counted from the first
            child = X.CollectExchangeExec(plan, [child], conf, device)
        return X.FilterExec(plan, [child], conf, device)
    if isinstance(plan, P.Union):
        return X.UnionExec(plan, children, conf, device)
    if isinstance(plan, P.Expand):
        return X.ExpandExec(plan, children, conf, device)
    if isinstance(plan, P.Generate):
        return X.GenerateExec(plan, children, conf, device)
    if isinstance(plan, P.Repartition):
        if not plan.keys:
            return X.RoundRobinExchangeExec(plan, children, conf, device,
                                            plan.n_out)
        return X.ShuffleExchangeExec(plan, children, conf, device, plan.keys,
                                     plan.n_out)
    if isinstance(plan, P.Aggregate):
        return _convert_aggregate(plan, children[0], conf, device)
    if isinstance(plan, P.Limit):
        return _convert_limit(plan, children[0], conf, device)
    if isinstance(plan, P.Sort):
        return _convert_sort(plan, children[0], conf, device)
    if isinstance(plan, P.Join):
        return _convert_join(plan, children, conf, device)
    if isinstance(plan, P.WindowNode):
        return _convert_window(plan, children[0], conf, device)
    raise NotImplementedError(type(plan).__name__)


def _convert_window(plan, child, conf, device):
    if child.num_partitions > 1:
        # equal partition keys must meet in one partition
        spec = plan.window_exprs[0].spec
        if spec.partition_exprs:
            child = X.ShuffleExchangeExec(plan, [child], conf, device,
                                          spec.partition_exprs,
                                          child.num_partitions)
        else:
            child = X.CollectExchangeExec(plan, [child], conf, device)
    return X.WindowExec(plan, [child], conf, device)


#: ORDER BY + LIMIT n takes TopN up to this n
_TOPN_LIMIT = 100_000


def _convert_limit(plan, child, conf, device):
    if isinstance(child, X.SortExec) and plan.n <= _TOPN_LIMIT:
        # a global limit makes the sort's global order moot: TopN per
        # partition, then once more over the collected candidates
        inner = child.children[0]
        if isinstance(inner, (X.RangeExchangeExec, X.CollectExchangeExec)):
            inner = inner.children[0]
        orders = child.plan.orders
        local = X.TopNExec(plan, [inner], conf, device, orders, plan.n)
        if inner.num_partitions > 1:
            return X.TopNExec(
                plan, [X.CollectExchangeExec(plan, [local], conf, device)],
                conf, device, orders, plan.n)
        return local
    local = X.LimitExec(plan, [child], conf, device)
    if child.num_partitions > 1:
        return X.LimitExec(
            plan, [X.CollectExchangeExec(plan, [local], conf, device)],
            conf, device)
    return local


def _convert_sort(plan, child, conf, device):
    if child.num_partitions > 1 and plan.global_sort:
        # a range exchange + per-partition sorts order the whole; string
        # keys normalize to a hash, which is not their order: they collect
        if any(isinstance(o.expr.data_type(), T.StringType)
               for o in plan.orders):
            child = X.CollectExchangeExec(plan, [child], conf, device)
        else:
            child = X.RangeExchangeExec(plan, [child], conf, device,
                                        plan.orders, child.num_partitions)
    return X.SortExec(plan, [child], conf, device)


def _common_keys(plan):
    """The join keys cast to their common type on each side: murmur3 is
    width-sensitive, so both sides must hash the same type."""
    lks, rks = [], []
    for lk, rk in zip(plan.left_keys, plan.right_keys):
        ct = T.common_type(lk.data_type(), rk.data_type())
        lks.append(lk if lk.data_type() == ct else E.Cast(lk, ct))
        rks.append(rk if rk.data_type() == ct else E.Cast(rk, ct))
    return lks, rks


def _convert_join(plan, children, conf, device):
    """The JAX package's join planning: cross joins take the cartesian
    product, joins without equi keys the nested loop; otherwise a build
    side (the right) estimated at most
    spark.rapids.sql.join.broadcastRowThreshold rows broadcasts. Under a
    multi-partition probe and adaptive execution (the default), a build
    side of unknown size becomes ``AdaptiveJoinExec`` (a row probe at run
    time) and a larger one ``AdaptiveShuffledHashJoinExec`` (the build
    side's exchange measured first); right and full joins never go
    adaptive. Without adaptive execution a larger build hash-exchanges
    both sides."""
    left, right = children
    if plan.how == "cross":
        return X.CartesianProductExec(plan, [left, right], conf, device)
    if not plan.left_keys:
        # a non-equi join: the nested loop over the whole build side;
        # right and full joins emit the unmatched build rows once, after
        # a single left partition
        if plan.how in ("right", "full") and left.num_partitions > 1:
            left = X.CollectExchangeExec(plan, [left], conf, device)
        return X.BroadcastNestedLoopJoinExec(plan, [left, right], conf,
                                             device)
    est = plan.children[1].estimated_rows()
    small = est is not None and est <= conf.get(
        C.BROADCAST_JOIN_ROW_THRESHOLD)
    multi = left.num_partitions > 1
    adaptive = bool(conf.get(C.ADAPTIVE_ENABLED))
    if multi and est is None and adaptive \
            and plan.how not in ("right", "full"):
        return X.AdaptiveJoinExec(plan, [left, right], conf, device,
                                  part_keys=_common_keys(plan))
    if multi and not small:
        lks, rks = _common_keys(plan)
        if adaptive and conf.get(C.ADAPTIVE_BROADCAST_BYTES) > 0:
            return AQ.AdaptiveShuffledHashJoinExec(
                plan, [left, right], conf, device, part_keys=(lks, rks))
        n_out = left.num_partitions
        left = X.ShuffleExchangeExec(plan, [left], conf, device, lks, n_out)
        right = X.ShuffleExchangeExec(plan, [right], conf, device, rks, n_out)
        return X.ShuffledHashJoinExec(plan, [left, right], conf, device,
                                      part_keys=(lks, rks))
    if plan.how in ("right", "full") and multi:
        left = X.CollectExchangeExec(plan, [left], conf, device)
    return X.BroadcastHashJoinExec(plan, [left, right], conf, device)


#: the JAX package's single-device threshold
#: (``spark_rapids_tpu/plan/overrides.py:1080-1092``): a multi-partition
#: input estimated at most this many rows is collected and aggregated once;
#: a larger or unknown one runs partial -> collect -> final
COLLECT_COMPLETE_MAX_ROWS = 64_000_000


def _measured_collapse() -> bool:
    """True when the measured cost pass (``plan/cost.measured_hints``)
    prescribed collapsing group-key aggregate exchanges to one partition
    for the plan converting on this thread: the history said its shuffle
    group was dispatch_overhead-bound."""
    from spark_rapids_tpu_torch.plan import cost as COST
    h = COST.current_hints()
    return h is not None and h.exchange_parts == 1


def _convert_aggregate(plan, child, conf, device):
    """The JAX package's aggregate plan, with its measured collapse of an
    exchange into a collect (``_measured_collapse``). On one mesh device
    (``parallel/mesh.mesh_devices``) with a shuffle mode other than ICI,
    a multi-partition input estimated at most COLLECT_COMPLETE_MAX_ROWS
    rows is collected and aggregated once; otherwise the plan is partial
    -> hash exchange by the group keys -> final (a collect without
    keys)."""
    pre_filter = None
    if isinstance(child, X.FilterExec) \
            and not E.needs_partition_context(child.plan.condition):
        # the filter folds into the aggregate's update as a live mask
        pre_filter = child.plan.condition
        child = child.children[0]
    if child.num_partitions == 1:
        return X.HashAggregateExec(plan, [child], conf, device,
                                   pre_filter=pre_filter)
    if any(getattr(a.fn, "no_partial", False) for a in plan.aggs):
        # segmented aggregates have no mergeable state: raw rows meet by
        # group key (a hash exchange, or a collect without keys or when
        # the measured pass collapsed the exchange), then each partition
        # aggregates completely
        if plan.group_exprs and not _measured_collapse():
            child = X.ShuffleExchangeExec(plan, [child], conf, device,
                                          plan.group_exprs,
                                          child.num_partitions)
        else:
            child = X.CollectExchangeExec(plan, [child], conf, device)
        return X.HashAggregateExec(plan, [child], conf, device,
                                   pre_filter=pre_filter)
    from spark_rapids_tpu_torch.parallel.mesh import mesh_devices
    single_device = len(mesh_devices(like=device)) == 1 \
        and X.shuffle_mode(conf) != "ICI"
    if single_device:
        est = plan.children[0].estimated_rows()
        if est is not None and est <= COLLECT_COMPLETE_MAX_ROWS:
            # every partition lives on the one device and the raw input
            # fits: collect it and aggregate once, completely
            child = X.CoalesceBatchesExec(
                plan, [X.CollectExchangeExec(plan, [child], conf, device)],
                conf, device)
            return X.HashAggregateExec(plan, [child], conf, device,
                                       pre_filter=pre_filter)
    partial = X.HashAggregateExec(plan, [child], conf, device,
                                  mode="partial", pre_filter=pre_filter)
    if plan.group_exprs and not single_device and not _measured_collapse():
        # several devices: the partial states meet by group key in a real
        # exchange (the lane exchange under ICI or multichip)
        keys = [E.BoundRef(i, e.data_type(), n) for i, (e, n) in
                enumerate(zip(plan.group_exprs, plan.group_names))]
        exch = X.ShuffleExchangeExec(plan, [partial], conf, device, keys,
                                     child.num_partitions)
    else:
        # one device: a hash exchange between partial and final states
        # would only re-slice planes that already live together
        exch = X.CollectExchangeExec(plan, [partial], conf, device)
    return X.HashAggregateExec(plan, [exch], conf, device, mode="final")


# ---------------------------------------------------------------------------
# Parquet filter pushdown
# ---------------------------------------------------------------------------

def _as_pushed(e: E.Expression) -> Optional[E.Expression]:
    """Copy a conjunct into the shape row-group pruning reads
    (comparisons, IsNull/IsNotNull, And/Or over column refs and
    literals); None when it is not pushable."""
    if isinstance(e, E.BoundRef):
        return E.BoundRef(e.index, e.data_type(), e.name)
    if isinstance(e, E.Literal):
        return e
    if isinstance(e, E.Not):
        # only null-test negations have a sound pruning rewrite (negating
        # an interval comparison is unsound under three-valued logic)
        c = e.children[0]
        if isinstance(c, E.IsNull):
            return _as_pushed(E.IsNotNull(c.children[0]))
        if isinstance(c, E.IsNotNull):
            return _as_pushed(E.IsNull(c.children[0]))
        return None
    if isinstance(e, (E.And, E.Or, E.EqualTo, E.LessThan, E.LessThanOrEqual,
                      E.GreaterThan, E.GreaterThanOrEqual, E.IsNull,
                      E.IsNotNull)):
        kids = [_as_pushed(c) for c in e.children]
        if any(k is None for k in kids):
            return None
        return e.with_children(kids)
    return None


def _rename_refs(e: E.Expression,
                 nmap: Dict[str, str]) -> Optional[E.Expression]:
    """Rewrite column refs through a projection's output -> input name
    map; None when a ref does not map (a computed column)."""
    if isinstance(e, E.BoundRef):
        t = nmap.get(e.name)
        if t is None:
            return None
        return E.BoundRef(e.index, e.data_type(), t)
    if not e.children:
        return e
    kids = [_rename_refs(c, nmap) for c in e.children]
    if any(k is None for k in kids):
        return None
    return e.with_children(kids)


def push_down_scan_filters(plan: P.PlanNode) -> None:
    """Fill ParquetScan.pushed_filters from the Filter nodes above each
    scan, renamed through the projections between them. A scan reached
    from several branches gets the OR of the branches' conjunctions, and
    a branch that reaches it with no predicate turns pruning off.
    Idempotent: the lists are reassigned, not extended."""
    arrivals: Dict[int, List[List[E.Expression]]] = {}
    scans: Dict[int, P.ParquetScan] = {}

    def walk(node: P.PlanNode, conjs: List[E.Expression]) -> None:
        if isinstance(node, P.Filter):
            add = [p for p in map(_as_pushed, split_conjuncts(node.condition))
                   if p is not None]
            walk(node.children[0], conjs + add)
            return
        if isinstance(node, P.Project):
            nmap: Dict[str, str] = {}
            for name, ex in zip(node.names, node.exprs):
                inner = ex.children[0] if isinstance(ex, E.Alias) else ex
                if isinstance(inner, E.BoundRef):
                    nmap[name] = inner.name
            renamed = [r for r in (_rename_refs(c, nmap) for c in conjs)
                       if r is not None]
            walk(node.children[0], renamed)
            return
        if isinstance(node, P.ParquetScan):
            arrivals.setdefault(id(node), []).append(conjs)
            scans[id(node)] = node
            return
        for c in node.children:
            walk(c, [])

    walk(plan, [])
    for sid, paths in arrivals.items():
        scan = scans[sid]
        if any(not p for p in paths):
            scan.pushed_filters = []
        elif len(paths) == 1:
            scan.pushed_filters = list(paths[0])
        else:
            scan.pushed_filters = [reduce(E.Or, [reduce(E.And, p)
                                                 for p in paths])]

