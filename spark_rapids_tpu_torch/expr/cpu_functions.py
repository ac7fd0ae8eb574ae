"""CPU-only expressions: functions without a device implementation.

Counterpart of ``spark_rapids_tpu/expr/cpu_functions.py`` (reference
parity: the per-operator fallback keeps a query running when an
expression has no GPU implementation). Each is a row function over python
values, evaluated by the CPU backend; planning tags the enclosing operator
off the device with the JAX package's reason, so it runs in
``CpuFallbackExec``. ``ALL_CPU_FUNCTIONS`` is the JAX package's list:
reverse, concat_ws, lpad/rpad, translate, substring_index, md5, sha2, the
datetime formats (``date_format``, ``to_date``, ``from_unixtime``) and
format_number; the second tier adds find_in_set, levenshtein,
base64/unbase64, format_string, elt, soundex, sha1, hex/unhex, bin, conv,
url_encode/url_decode, regexp_extract_all (an array of strings),
json_tuple (an array of strings), to_json and luhn_check.
"""
from __future__ import annotations

import datetime as _dt
import hashlib
import re as _re
from typing import List
from urllib.parse import quote_plus as _quote_plus, \
    unquote_plus as _unquote_plus

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import CpuCol, Expression, \
    SparkException


class CpuRowFunction(Expression):
    """An expression evaluated row by row on the host (CPU backend
    only)."""

    #: subclasses set these
    name = "cpu_fn"
    result = T.STRING

    def __init__(self, *children, params=()):
        self.children = list(children)
        self.params = tuple(params)

    def data_type(self):
        return self.result

    def _params(self):
        return repr(self.params)

    def with_children(self, children):
        return type(self)(*children, params=self.params)

    def supported_on_tpu(self):
        return False

    def eval(self, ctx):
        raise NotImplementedError(f"{self.name} has no device kernel yet")

    def row_fn(self, *vals):
        raise NotImplementedError

    def eval_cpu(self, cols, ansi=False):
        ins = [c.eval_cpu(cols, ansi) for c in self.children]
        n = len(ins[0].values)
        valid = np.ones(n, np.bool_)
        for c in ins:
            valid = valid & c.valid
        out: List = []
        out_valid = valid.copy()
        # row functions are pure: each distinct input row is computed once
        # (a date column holds a few thousand days over millions of rows)
        memo = {}
        for i in range(n):
            if not valid[i]:
                out.append(None)
                continue
            args = tuple(c.values[i] for c in ins)
            try:
                r = memo.get(args, memo)
            except TypeError:  # a nested value (list, dict) is not hashable
                r = self.row_fn(*args)
            else:
                if r is memo:
                    r = memo[args] = self.row_fn(*args)
            if r is None:
                out_valid[i] = False
            out.append(r)
        if isinstance(self.result, T.StringType):
            vals = np.empty(n, object)
            vals[:] = out
        else:
            vals = np.array([0 if v is None else v for v in out]
                            ).astype(self.result.np_dtype)
        return CpuCol(self.result, vals, out_valid)


class Reverse(CpuRowFunction):
    name = "reverse"
    result = T.STRING

    def row_fn(self, s):
        return s[::-1] if isinstance(s, str) else s


class ConcatWs(CpuRowFunction):
    """concat_ws(sep, ...): null inputs are SKIPPED (unlike concat)."""

    name = "concat_ws"
    result = T.STRING

    def eval_cpu(self, cols, ansi=False):
        from spark_rapids_tpu_torch.expr.strings import cast_string_cpu
        sep = self.params[0]
        ins = []
        for c in self.children:
            cc = c.eval_cpu(cols, ansi)
            if not isinstance(cc.dtype, T.StringType):
                # Spark-faithful rendering (true/false, float formatting)
                cc = cast_string_cpu(cc, T.STRING, ansi)
            ins.append(cc)
        n = len(ins[0].values)
        out = []
        for i in range(n):
            parts = [c.values[i] for c in ins
                     if c.valid[i] and c.values[i] is not None]
            out.append(sep.join(parts))
        return CpuCol(T.STRING, np.array(out, object), np.ones(n, np.bool_))


class LPad(CpuRowFunction):
    name = "lpad"
    result = T.STRING

    def row_fn(self, s):
        ln, pad = self.params
        if not isinstance(s, str):
            return s
        if ln <= 0:
            return ""  # Spark: non-positive length pads to empty
        if len(s) >= ln:
            return s[:ln]
        fill = (pad * ln)[: ln - len(s)]
        return fill + s


class RPad(LPad):
    name = "rpad"

    def row_fn(self, s):
        ln, pad = self.params
        if not isinstance(s, str):
            return s
        if ln <= 0:
            return ""
        if len(s) >= ln:
            return s[:ln]
        return s + (pad * ln)[: ln - len(s)]


class Translate(CpuRowFunction):
    name = "translate"
    result = T.STRING

    def row_fn(self, s):
        if not hasattr(self, "_table"):
            src, dst = self.params
            self._table = {ord(a): (dst[i] if i < len(dst) else None)
                           for i, a in enumerate(src)}
        return s.translate(self._table) if isinstance(s, str) else s


class SubstringIndex(CpuRowFunction):
    """substring_index(str, delim, count) (reference
    GpuSubstringIndexUtils JNI)."""

    name = "substring_index"
    result = T.STRING

    def row_fn(self, s):
        delim, count = self.params
        if not isinstance(s, str) or not delim:
            return ""
        parts = s.split(delim)
        if count > 0:
            return delim.join(parts[:count])
        if count < 0:
            return delim.join(parts[count:])
        return ""


class Md5(CpuRowFunction):
    name = "md5"
    result = T.STRING

    def row_fn(self, s):
        b = s.encode() if isinstance(s, str) else bytes(s)
        return hashlib.md5(b).hexdigest()


class Sha2(CpuRowFunction):
    name = "sha2"
    result = T.STRING

    _ALGOS = {0: hashlib.sha256, 224: hashlib.sha224, 256: hashlib.sha256,
              384: hashlib.sha384, 512: hashlib.sha512}

    def row_fn(self, s):
        algo = self._ALGOS.get(self.params[0])
        if algo is None:
            return None  # Spark: NULL for unsupported bit lengths
        b = s.encode() if isinstance(s, str) else bytes(s)
        return algo(b).hexdigest()


def _java_fmt_to_py(pattern: str) -> str:
    """Transpile the supported Java datetime-pattern subset to strftime,
    rejecting anything unhandled: a pattern like 'd/M/yyyy' or 'EEE' must
    raise, not silently emit literal 'd/M/2024'."""
    tokens = [("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"),
              ("HH", "%H"), ("mm", "%M"), ("ss", "%S")]
    out = []
    i = 0
    while i < len(pattern):
        for j, p in tokens:
            if pattern.startswith(j, i):
                out.append(p)
                i += len(j)
                break
        else:
            ch = pattern[i]
            if ch.isalpha() or ch in "%'":
                raise SparkException(
                    f"unsupported datetime pattern {pattern!r}: "
                    f"unhandled character {ch!r}")
            out.append(ch)
            i += 1
    return "".join(out)


class _Formatted(CpuRowFunction):
    """A row function with a Java datetime pattern as its parameter,
    checked when the expression is built."""

    default_fmt = "yyyy-MM-dd"

    def __init__(self, *children, params=()):
        super().__init__(*children, params=params)
        self._py = _java_fmt_to_py(params[0] if params
                                   else self.default_fmt)


class DateFormat(_Formatted):
    """date_format(date/ts, java-pattern-subset)."""

    name = "date_format"
    result = T.STRING

    def row_fn(self, v):
        src = self.children[0].data_type()
        if isinstance(src, T.TimestampType):
            d = _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=int(v))
        else:
            d = _dt.datetime(1970, 1, 1) + _dt.timedelta(days=int(v))
        return d.strftime(self._py)


class ToDateFmt(_Formatted):
    """to_date(str, fmt): a string that does not parse is null (non-ANSI
    Spark)."""

    name = "to_date"
    result = T.DATE

    def row_fn(self, s):
        try:
            d = _dt.datetime.strptime(s, self._py).date()
        except (ValueError, TypeError):
            return None
        return (d - _dt.date(1970, 1, 1)).days


class FromUnixtime(_Formatted):
    """from_unixtime(seconds, fmt) -> string."""

    name = "from_unixtime"
    result = T.STRING
    default_fmt = "yyyy-MM-dd HH:mm:ss"

    def row_fn(self, v):
        return (_dt.datetime(1970, 1, 1)
                + _dt.timedelta(seconds=int(v))).strftime(self._py)


class FormatNumber(CpuRowFunction):
    name = "format_number"
    result = T.STRING

    def row_fn(self, v):
        d = self.params[0]
        return f"{float(v):,.{d}f}"


ALL_CPU_FUNCTIONS = [Reverse, ConcatWs, LPad, RPad, Translate,
                     SubstringIndex, Md5, Sha2, DateFormat, ToDateFmt,
                     FromUnixtime, FormatNumber]


# ---------------------------------------------------------------------------
# String breadth second tier (CPU rows)
# ---------------------------------------------------------------------------

class FindInSet(CpuRowFunction):
    """find_in_set(s, csv): 1-based index of s within the comma list."""

    name = "find_in_set"
    result = T.INT32

    def row_fn(self, s, csv):
        if not isinstance(s, str) or not isinstance(csv, str):
            return None
        if "," in s:
            return 0
        parts = csv.split(",")
        try:
            return parts.index(s) + 1
        except ValueError:
            return 0


class Levenshtein(CpuRowFunction):
    name = "levenshtein"
    result = T.INT32

    def row_fn(self, a, b):
        if not isinstance(a, str) or not isinstance(b, str):
            return None
        if len(a) < len(b):
            a, b = b, a
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            cur = [i]
            for j, cb in enumerate(b, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (ca != cb)))
            prev = cur
        return prev[-1]


class Base64Encode(CpuRowFunction):
    name = "base64"
    result = T.STRING

    def row_fn(self, s):
        import base64
        if isinstance(s, bytes):
            return base64.b64encode(s).decode()
        if isinstance(s, str):
            return base64.b64encode(s.encode()).decode()
        return None


class UnBase64(CpuRowFunction):
    name = "unbase64"
    result = T.STRING

    def row_fn(self, s):
        import base64
        if not isinstance(s, str):
            return None
        try:
            return base64.b64decode(s).decode("utf-8", "replace")
        except Exception:  # noqa: BLE001 - Spark: invalid input -> error/null
            return None


class FormatString(CpuRowFunction):
    """format_string(fmt, args...): java.lang.String.format subset via
    Python %-interpolation of the common conversions."""

    name = "format_string"
    result = T.STRING

    def eval_cpu(self, cols, ansi=False):
        fmt = self.params[0]
        ins = [c.eval_cpu(cols, ansi) for c in self.children]
        n = len(ins[0].values) if ins else 0
        out, ok = [], []
        for i in range(n):
            # java.util.Formatter renders null arguments as "null"
            args = tuple(
                "null" if not c.valid[i] else
                (c.values[i].item() if isinstance(c.values[i], np.generic)
                 else c.values[i]) for c in ins)
            try:
                out.append(fmt % args)
                ok.append(True)
            except (TypeError, ValueError):
                out.append(None)
                ok.append(False)
        return CpuCol(T.STRING, np.array(out, object),
                      np.asarray(ok, np.bool_))


class Elt(CpuRowFunction):
    """elt(n, s1, s2, ...): the n-th argument string (1-based); null when
    out of range (ANSI: error)."""

    name = "elt"
    result = T.STRING

    def eval_cpu(self, cols, ansi=False):
        ins = [c.eval_cpu(cols, ansi) for c in self.children]
        idx = ins[0]
        n = len(idx.values)
        out, ok = [], []
        for i in range(n):
            if not idx.valid[i]:
                out.append(None)
                ok.append(False)
                continue
            k = int(idx.values[i])
            if 1 <= k < len(ins):
                c = ins[k]
                out.append(c.values[i] if c.valid[i] else None)
                ok.append(bool(c.valid[i]))
            else:
                if ansi:
                    raise SparkException(f"elt index {k} out of range")
                out.append(None)
                ok.append(False)
        return CpuCol(T.STRING, np.array(out, object),
                      np.asarray(ok, np.bool_))


class Soundex(CpuRowFunction):
    name = "soundex"
    result = T.STRING

    _CODE = {**{c: "1" for c in "BFPV"}, **{c: "2" for c in "CGJKQSXZ"},
             **{c: "3" for c in "DT"}, "L": "4",
             **{c: "5" for c in "MN"}, "R": "6"}

    def row_fn(self, s):
        if not isinstance(s, str):
            return None
        if not s or not s[0].isalpha():
            return s
        u = s.upper()
        out = [u[0]]
        prev = self._CODE.get(u[0], "")
        for ch in u[1:]:
            code = self._CODE.get(ch, "")
            if code and code != prev:
                out.append(code)
                if len(out) == 4:
                    break
            if ch not in "HW":
                prev = code
        return "".join(out).ljust(4, "0")


# ---------------------------------------------------------------------------
# Binary/codec breadth tier (reference stringFunctions.scala GpuSha1/
# GpuHex family semantics, NumberConverter for conv)
# ---------------------------------------------------------------------------

class JsonTuple(CpuRowFunction):
    """json_tuple is a generator in Spark; this expression form returns
    the ARRAY of extracted fields (the DataFrame layer explodes it into
    columns). Reference GpuJsonTuple.scala."""

    name = "json_tuple"

    @property
    def result(self):
        return T.ArrayType(T.STRING)

    def data_type(self):
        return T.ArrayType(T.STRING)

    def eval_cpu(self, cols, ansi=False):
        import json
        c = self.children[0].eval_cpu(cols, ansi)
        out, ok = [], []
        for s, v in zip(c.values, c.valid):
            if not v or not isinstance(s, str):
                out.append(None)
                ok.append(False)
                continue
            try:
                obj = json.loads(s)
            except ValueError:
                obj = None
            row = []
            for f in self.params:
                x = obj.get(f) if isinstance(obj, dict) else None
                if x is None:
                    row.append(None)
                elif isinstance(x, (dict, list)):
                    row.append(json.dumps(x, separators=(",", ":")))
                elif isinstance(x, bool):
                    row.append("true" if x else "false")
                else:
                    row.append(str(x))
            out.append(row)
            ok.append(True)
        vals = np.empty(len(out), object)
        vals[:] = out
        return CpuCol(self.result, vals, np.asarray(ok, np.bool_))


class Sha1(CpuRowFunction):
    name = "sha1"
    result = T.STRING

    def row_fn(self, s):
        b = s.encode() if isinstance(s, str) else bytes(s)
        return hashlib.sha1(b).hexdigest()


class HexStr(CpuRowFunction):
    """hex(): integers render as unsigned-64 uppercase hex, strings as
    the hex of their utf-8 bytes (Spark Hex)."""

    name = "hex"
    result = T.STRING

    def row_fn(self, v):
        if isinstance(v, str):
            return v.encode().hex().upper()
        if isinstance(v, (bytes, bytearray)):
            return bytes(v).hex().upper()
        return format(int(v) & 0xFFFFFFFFFFFFFFFF, "X")


class Unhex(CpuRowFunction):
    """unhex(): odd-length input gets a leading zero nibble; any
    non-hex character makes the row NULL (Spark Unhex). The decoded
    bytes surface as a latin-1 string (the engine's binary carrier)."""

    name = "unhex"
    result = T.STRING

    def row_fn(self, s):
        if not isinstance(s, str):
            return None
        if len(s) % 2:
            s = "0" + s
        try:
            return bytes.fromhex(s).decode("latin-1")
        except ValueError:
            return None


class Bin(CpuRowFunction):
    """bin(): Long.toBinaryString — the unsigned-64 binary rendering."""

    name = "bin"
    result = T.STRING

    def row_fn(self, v):
        return format(int(v) & 0xFFFFFFFFFFFFFFFF, "b")


_CONV_DIGITS = "0123456789abcdefghijklmnopqrstuvwxyz"


class Conv(CpuRowFunction):
    """conv(num, from_base, to_base): Java NumberConverter semantics —
    case-insensitive digits, the longest valid prefix parses (empty
    prefix is NULL), overflow CLAMPS to the unsigned-64 max (Hive's
    converter, which Spark inherits), and a negative to_base renders
    the SIGNED interpretation."""

    name = "conv"
    result = T.STRING

    def row_fn(self, s):
        fb, tb = self.params
        # only TO_base may be negative (NumberConverter: fromBase must
        # be a plain radix in [2, 36])
        if not isinstance(s, str) or not (2 <= fb <= 36) \
                or not (2 <= abs(tb) <= 36):
            return None
        s = s.strip().lower()
        neg = s.startswith("-")
        if neg:
            s = s[1:]
        v, seen, umax = 0, False, (1 << 64) - 1
        for ch in s:
            d = _CONV_DIGITS.find(ch)
            if d < 0 or d >= fb:
                break
            v = min(v * fb + d, umax)
            seen = True
        if not seen:
            return None
        if neg:
            v = (-v) & 0xFFFFFFFFFFFFFFFF
        out_neg = False
        if tb < 0 and v >= 1 << 63:  # signed rendering
            v = (1 << 64) - v
            out_neg = True
        base = abs(tb)
        digits = []
        while True:
            v, r = divmod(v, base)
            digits.append(_CONV_DIGITS[r])
            if v == 0:
                break
        return ("-" if out_neg else "") + "".join(reversed(digits)).upper()


_BAD_ESCAPE = _re.compile(r"%(?![0-9a-fA-F]{2})")


class UrlEncode(CpuRowFunction):
    """url_encode(): java.net.URLEncoder form encoding (space -> '+';
    '~' IS escaped, unlike python's quote which hardcodes it safe)."""

    name = "url_encode"
    result = T.STRING

    def row_fn(self, s):
        if not isinstance(s, str):
            return None
        return _quote_plus(s, safe="*-._").replace("~", "%7E")


class UrlDecode(CpuRowFunction):
    """url_decode(): inverse form decoding; malformed percent escapes
    are an error in Spark — raised here too."""

    name = "url_decode"
    result = T.STRING

    def row_fn(self, s):
        if not isinstance(s, str):
            return None
        if _BAD_ESCAPE.search(s):
            raise SparkException(f"invalid URL escape in {s!r}")
        return _unquote_plus(s)


class RegexpExtractAll(CpuRowFunction):
    """regexp_extract_all(s, pattern, group) -> array<string> (reference
    GpuRegExpExtractAll). Invalid group index raises like Spark."""

    name = "regexp_extract_all"

    @property
    def result(self):
        return T.ArrayType(T.STRING)

    def data_type(self):
        return self.result

    def row_fn(self, s):
        pattern, idx = self.params
        if not hasattr(self, "_prog"):
            self._prog = _re.compile(pattern)
            if idx < 0 or idx > self._prog.groups:
                raise SparkException(
                    f"regexp_extract_all: group {idx} out of range")
        if not isinstance(s, str):
            return None
        out = []
        for m in self._prog.finditer(s):
            g = m.group(idx)
            out.append(g if g is not None else "")
        return out

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        n = len(c.values)
        vals = np.empty(n, object)
        valid = c.valid.copy()
        for i in range(n):
            r = self.row_fn(c.values[i]) if valid[i] else None
            if r is None:
                valid[i] = False
            vals[i] = r
        return CpuCol(self.result, vals, valid)


class StructsToJson(CpuRowFunction):
    """to_json(struct|map|array) (reference GpuStructsToJson). NULL
    fields are omitted, Spark's default JacksonGenerator behavior. A map
    row is a list of (key, value) pairs; the declared column type, not
    the python shape, picks the object rendering, recursively."""

    name = "to_json"
    result = T.STRING

    def row_fn(self, v):
        if v is None:
            return None
        return self._enc_typed(v, self.children[0].data_type())

    def _enc_typed(self, v, dt):
        import json
        if v is None:
            return "null"
        if isinstance(dt, T.MapType):
            items = [(k, self._enc_typed(x, dt.value)) for k, x in v
                     if x is not None]
            return "{" + ",".join(f"{json.dumps(str(k))}:{x}"
                                  for k, x in items) + "}"
        if isinstance(dt, T.ArrayType):
            return "[" + ",".join(self._enc_typed(x, dt.element)
                                  for x in v) + "]"
        if isinstance(dt, T.StructType) and isinstance(v, dict):
            fields = {f.name: f.dtype for f in dt.fields}
            items = [(k, self._enc_typed(x, fields.get(k)))
                     for k, x in v.items() if x is not None]
            return "{" + ",".join(f"{json.dumps(str(k))}:{x}"
                                  for k, x in items) + "}"
        return self._enc(v)

    def _enc(self, v):
        import decimal
        import json
        if isinstance(v, dict):
            items = [(k, self._enc(x)) for k, x in v.items()
                     if x is not None]
            return "{" + ",".join(f"{json.dumps(str(k))}:{x}"
                                  for k, x in items) + "}"
        if isinstance(v, (list, tuple)):
            return "[" + ",".join(
                "null" if x is None else self._enc(x) for x in v) + "]"
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, (_dt.datetime, _dt.date)):
            return json.dumps(v.isoformat())
        if isinstance(v, decimal.Decimal):
            return str(v)  # a JSON number, as Spark writes it
        if isinstance(v, np.generic):
            v = v.item()
        return json.dumps(v)


class Luhncheck(CpuRowFunction):
    """luhn_check(str): credit-card checksum validity (Spark 3.5)."""

    name = "luhn_check"
    result = T.BOOLEAN

    def row_fn(self, s):
        if not isinstance(s, str) or not s \
                or not (s.isascii() and s.isdigit()):
            return False  # ASCII digits only (Spark rejects U+0660 etc)
        total = 0
        for i, ch in enumerate(reversed(s)):
            d = ord(ch) - 48
            if i % 2:
                d *= 2
                if d > 9:
                    d -= 9
            total += d
        return total % 10 == 0
