"""Functions of the DataFrame API (counterpart of
``spark_rapids_tpu/sql/functions.py``): the aggregates ``sum``, ``count``,
``avg`` (``mean``), ``min``, ``max``, ``first``, ``last``, ``stddev``
(``stddev_samp``), ``stddev_pop``, ``variance`` (``var_samp``),
``var_pop``, ``min_by``, ``max_by``, ``percentile`` and
``approx_percentile`` (``percentile_approx``), ``collect_list`` and
``collect_set`` (array results), and the grouping markers ``grouping``
and ``grouping_id``; the scalar functions ``when``/``otherwise``,
``coalesce``, ``nvl``, ``nullif``, ``isnull``, ``isnan``, ``abs``,
``greatest``, ``least``, ``bitwise_not``, ``shiftleft``, ``shiftright``,
``shiftrightunsigned``, ``rand``, ``spark_partition_id``,
``monotonically_increasing_id``, ``hash`` and ``xxhash64``; the math functions of ``expr/math.py``
(``sqrt``, ``exp``, ``log`` and its family, the trigonometric and
hyperbolic functions, ``ceil``, ``floor``, ``round``, ``bround``,
``rint``, ``signum``, ``pow``, ``atan2``, ``hypot``, ``pmod``,
``factorial``, ``width_bucket``, ``nanvl``, ``positive``, ``bit_count``,
``getbit``); the string functions ``length``,
``upper``, ``lower``, ``substring``, ``concat``, ``startswith``,
``endswith``, ``contains`` and ``like``, and the window functions
``row_number``, ``rank``, ``dense_rank``, ``ntile``, ``percent_rank``,
``cume_dist``, ``nth_value``, ``first_value``, ``last_value``, ``lead`` and
``lag`` (``expr/window.py``; an aggregate's ``over`` makes the others)."""
from __future__ import annotations

from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import math as MA
from spark_rapids_tpu_torch.expr import misc as MI
from spark_rapids_tpu_torch.expr import strings as S
from spark_rapids_tpu_torch.expr import window as W
from spark_rapids_tpu_torch.expr.core import Expression, col, lit


#: the JAX package's functions this module does not have yet (ROADMAP A9).
#: The SQL front door and the plan
#: ingestion raise naming A9 where a query calls one of them, rather than
#: calling it an unknown function.
NOT_PORTED = (
    "add_months", "aggregate", "array", "array_contains", "array_distinct",
    "array_except", "array_intersect", "array_join", "array_max", "array_min",
    "array_position", "array_remove", "array_repeat", "array_union",
    "arrays_overlap", "arrays_zip", "ascii", "base64", "bin", "bit_length",
    "char", "chr_", "concat_ws", "conv", "crc32", "date_add", "date_format",
    "date_from_unix_date", "date_sub", "date_trunc", "datediff", "dayofmonth",
    "dayofweek", "dayofyear", "element_at", "elt", "exists", "explode",
    "explode_outer", "filter", "find_in_set", "flatten", "forall",
    "format_number", "format_string", "from_json", "from_unixtime",
    "from_utc_timestamp", "get_json_object", "hex", "hive_hash",
    "hour", "initcap", "instr", "json_tuple", "last_day", "left",
    "levenshtein", "locate", "lpad", "ltrim", "luhn_check", "make_date",
    "map_concat", "map_entries", "map_filter", "map_from_arrays", "map_keys",
    "map_values", "md5", "minute", "month", "months_between", "next_day",
    "octet_length", "parse_url", "posexplode", "posexplode_outer", "quarter",
    "raise_error", "reduce", "regexp_extract", "regexp_extract_all",
    "regexp_replace", "repeat", "reverse", "right", "rlike", "rpad", "rtrim",
    "second", "sequence", "sha1", "sha2", "size", "slice", "sort_array",
    "soundex", "stack", "str_to_map", "substring_index", "timestamp_micros",
    "timestamp_millis", "timestamp_seconds", "to_date", "to_json",
    "to_utc_timestamp", "transform", "transform_keys", "transform_values",
    "translate", "trim", "trunc", "unbase64", "unhex", "unix_date",
    "unix_micros", "unix_millis", "unix_seconds", "unix_timestamp",
    "url_decode", "url_encode", "weekday", "weekofyear", "year",
    "zip_with",
)


def _e(c) -> Expression:
    return c if isinstance(c, Expression) else (col(c) if isinstance(c, str)
                                                else lit(c))


def sum(c):  # noqa: A001
    return A.Sum(_e(c))


def grouping(c):
    """1 when the key is aggregated away in a ROLLUP/CUBE output row."""
    return A.Grouping(_e(c))


def grouping_id():
    """The grouping-set bitmask over the group-by keys."""
    return A.GroupingID()


def count(c="*"):
    if isinstance(c, str) and c == "*":
        return A.CountAll()
    return A.Count(_e(c))


def avg(c):
    return A.Average(_e(c))


mean = avg


def min(c):  # noqa: A001
    return A.Min(_e(c))


def max(c):  # noqa: A001
    return A.Max(_e(c))


def first(c):
    return A.First(_e(c))


def last(c):
    return A.Last(_e(c))


def collect_list(c):
    return A.CollectList(_e(c))


def collect_set(c):
    return A.CollectSet(_e(c))


def min_by(c, ord_c):
    return A.MinBy(_e(c), _e(ord_c))


def max_by(c, ord_c):
    return A.MaxBy(_e(c), _e(ord_c))


def percentile(c, p: float):
    return A.Percentile(_e(c), p)


def approx_percentile(c, p: float, accuracy: int = 10000):
    return A.ApproxPercentile(_e(c), p, accuracy)


percentile_approx = approx_percentile


def stddev(c):
    return A.StddevSamp(_e(c))


stddev_samp = stddev


def stddev_pop(c):
    return A.StddevPop(_e(c))


def variance(c):
    return A.VarianceSamp(_e(c))


var_samp = variance


def var_pop(c):
    return A.VariancePop(_e(c))


# scalar ---------------------------------------------------------------------
def bitwise_not(c):
    return MA.BitwiseNot(_e(c))


def shiftleft(c, n):
    return MA.ShiftLeft(_e(c), _e(n))


def shiftright(c, n):
    return MA.ShiftRight(_e(c), _e(n))


def shiftrightunsigned(c, n):
    return MA.ShiftRightUnsigned(_e(c), _e(n))


def rand(seed: int = 0):
    return MI.Rand(seed)


def spark_partition_id():
    return E.SparkPartitionID()


def hash(*cs):  # noqa: A001
    """Spark's murmur3 hash (seed 42) of the columns, an int."""
    return MA.Murmur3Hash(*[_e(c) for c in cs])


def xxhash64(*cs):
    """Spark's xxhash64 (seed 42) of the columns, a long."""
    return MI.XxHash64([_e(c) for c in cs])


def monotonically_increasing_id():
    return E.MonotonicallyIncreasingID()


def coalesce(*cs):
    return E.Coalesce(*[_e(c) for c in cs])


def nvl(c, default):
    return coalesce(c, default)


def nullif(a, b):
    ea, eb = _e(a), _e(b)
    return E.If(E.EqualTo(ea, eb), E.NullOf(ea), ea)


def when(cond, value):
    return _WhenBuilder([(cond, _e(value))])


class _WhenBuilder(Expression):
    """``when(...).when(...)`` chains; ``otherwise`` closes the CASE, and a
    chain used as it is has no ELSE."""

    def __init__(self, branches):
        self._branches = branches
        self.children = []

    def when(self, cond, value):
        return _WhenBuilder(self._branches + [(cond, _e(value))])

    def otherwise(self, value):
        return E.CaseWhen(self._branches, _e(value))

    def _as_case(self):
        return E.CaseWhen(self._branches)

    def data_type(self):
        return self._as_case().data_type()

    def transform(self, fn):
        return self._as_case().transform(fn)

    def eval(self, ctx):
        return self._as_case().eval(ctx)

    def fingerprint(self):
        return self._as_case().fingerprint()


def isnull(c):
    return E.IsNull(_e(c))


def isnan(c):
    return E.IsNaN(_e(c))


def abs(c):  # noqa: A001
    return E.Abs(_e(c))


def greatest(*cs):
    return MA.Greatest(*[_e(c) for c in cs])


def least(*cs):
    return MA.Least(*[_e(c) for c in cs])


# math -----------------------------------------------------------------------
def sqrt(c):
    return MA.Sqrt(_e(c))


def exp(c):
    return MA.Exp(_e(c))


def log(arg1, arg2=None):
    """log(col) is the natural log; log(base, col) is Logarithm."""
    if arg2 is None:
        return MA.Log(_e(arg1))
    return MA.Logarithm(_e(arg1), _e(arg2))


def _math1(cls):
    def f(c):
        return cls(_e(c))
    f.__name__ = cls.__name__.lower()
    return f


log10 = _math1(MA.Log10)
log2 = _math1(MA.Log2)
sin = _math1(MA.Sin)
cos = _math1(MA.Cos)
tan = _math1(MA.Tan)
ceil = _math1(MA.Ceil)
floor = _math1(MA.Floor)
signum = _math1(MA.Signum)
acosh = _math1(MA.Acosh)
asinh = _math1(MA.Asinh)
atanh = _math1(MA.Atanh)
cbrt = _math1(MA.Cbrt)
cot = _math1(MA.Cot)
sec = _math1(MA.Sec)
csc = _math1(MA.Csc)
degrees = _math1(MA.ToDegrees)
radians = _math1(MA.ToRadians)
expm1 = _math1(MA.Expm1)
log1p = _math1(MA.Log1p)
rint = _math1(MA.Rint)
factorial = _math1(MA.Factorial)
bit_count = _math1(MA.BitwiseCount)
positive = _math1(MA.UnaryPositive)


def pow(a, b):  # noqa: A001
    return MA.Pow(_e(a), _e(b))


def atan2(a, b):
    return MA.Atan2(_e(a), _e(b))


def hypot(a, b):
    return MA.Hypot(_e(a), _e(b))


def nanvl(a, b):
    return MA.NaNvl(_e(a), _e(b))


def pmod(a, b):
    return MA.Pmod(_e(a), _e(b))


def getbit(c, pos):
    return MA.BitwiseGet(_e(c), _e(pos))


bit_get = getbit


def round(c, scale=0):  # noqa: A001
    return MA.Round(_e(c), scale)


def bround(c, scale=0):
    return MA.BRound(_e(c), scale)


def width_bucket(v, lo, hi, nb):
    return MA.WidthBucket(_e(v), _e(lo), _e(hi), _e(nb))


# strings --------------------------------------------------------------------
def length(c):
    return S.StringLength(_e(c))


def upper(c):
    return S.Upper(_e(c))


def lower(c):
    return S.Lower(_e(c))


def substring(c, pos, length_):
    return S.Substring(_e(c), pos, length_)


def concat(*cs):
    return S.ConcatStrings(*[_e(c) for c in cs])


def startswith(c, prefix):
    return S.StartsWith(_e(c), prefix)


def endswith(c, suffix):
    return S.EndsWith(_e(c), suffix)


def contains(c, s):
    return S.Contains(_e(c), s)


def like(c, pattern):
    return S.Like(_e(c), pattern)


# window ---------------------------------------------------------------------
def row_number():
    return W.RowNumber()


def rank():
    return W.Rank()


def dense_rank():
    return W.DenseRank()


def ntile(n: int):
    return W.NTile(n)


def percent_rank():
    return W.PercentRank()


def cume_dist():
    return W.CumeDist()


def nth_value(c, n: int):
    return W.NthValue(_e(c), n)


def first_value(c):
    return W.FirstValue(_e(c))


def last_value(c):
    return W.LastValue(_e(c))


def lead(c, offset: int = 1, default=None):
    return W.Lead(_e(c), offset, default)


def lag(c, offset: int = 1, default=None):
    return W.Lag(_e(c), offset, default)
