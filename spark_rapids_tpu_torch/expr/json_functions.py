"""JSON expressions: get_json_object and from_json.

Counterpart of ``spark_rapids_tpu/expr/json_functions.py`` (reference
GpuGetJsonObject.scala, GpuJsonToStructs.scala). Parsing is host work, in
the CPU tier (``expr/cpu_functions.CpuRowFunction``): planning tags the
enclosing operator off the card with the JAX package's reason, and the
CPU fallback runs it, with Spark's semantics:

- get_json_object: a JSONPath subset ($, .field, ['field'], [index], [*]);
  matched scalars render unquoted, objects and arrays re-serialize
  compactly; invalid JSON or a missing path gives null.
- from_json: a schema'd parse into a struct, an array or a map; missing
  fields are null, type mismatches null the field (PERMISSIVE mode),
  invalid JSON nulls the row.
"""
from __future__ import annotations

import json
import re
from typing import List, Optional

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import CpuCol, SparkException
from spark_rapids_tpu_torch.expr.cpu_functions import CpuRowFunction

_PATH_TOKEN = re.compile(
    r"\.(?P<field>[^.\[\]]+)|\[(?P<index>\d+)\]|\[\*\]|\['(?P<qfield>[^']+)'\]")


def parse_json_path(path: str) -> Optional[List]:
    """'$.a.b[0]' -> ['a', 'b', 0]; None when the path is unsupported.
    '[*]' parses to the wildcard marker '*'."""
    if not path or not path.startswith("$"):
        return None
    rest = path[1:]
    out: List = []
    pos = 0
    while pos < len(rest):
        m = _PATH_TOKEN.match(rest, pos)
        if m is None:
            return None
        if m.group("field") is not None:
            out.append(m.group("field"))
        elif m.group("qfield") is not None:
            out.append(m.group("qfield"))
        elif m.group("index") is not None:
            out.append(int(m.group("index")))
        else:
            out.append("*")
        pos = m.end()
    return out


def _walk(value, steps: List):
    if not steps:
        return value
    step, rest = steps[0], steps[1:]
    if step == "*":
        if not isinstance(value, list):
            return None
        hits = [h for h in (_walk(v, rest) for v in value) if h is not None]
        if not hits:
            return None
        # Spark unwraps a wildcard that matched exactly one element
        return hits[0] if len(hits) == 1 else hits
    if isinstance(step, int):
        if not isinstance(value, list) or step >= len(value):
            return None
        return _walk(value[step], rest)
    if not isinstance(value, dict) or step not in value:
        return None
    return _walk(value[step], rest)


def _render(v) -> Optional[str]:
    if v is None:
        return None
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return json.dumps(v)
    return json.dumps(v, separators=(",", ":"))


class GetJsonObject(CpuRowFunction):
    """get_json_object(json, path) (reference GpuGetJsonObject.scala)."""

    name = "get_json_object"
    result = T.STRING

    def __init__(self, *children, params=()):
        super().__init__(*children, params=params)
        self._steps = parse_json_path(self.params[0])

    def row_fn(self, s):
        if self._steps is None:
            return None
        try:
            v = json.loads(s)
        except (ValueError, TypeError):
            return None
        return _render(_walk(v, self._steps))


def _coerce(v, dt: T.DataType):
    """PERMISSIVE-mode coercion of one parsed JSON value to a type."""
    if v is None:
        return None
    try:
        if isinstance(dt, T.StringType):
            return v if isinstance(v, str) else _render(v)
        if isinstance(dt, T.BooleanType):
            return v if isinstance(v, bool) else None
        if dt.is_integral:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return None
            iv = int(v)
            return iv if float(iv) == float(v) else None
        if isinstance(dt, (T.Float32Type, T.Float64Type)):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return None
            return float(v)
        if isinstance(dt, T.ArrayType):
            if not isinstance(v, list):
                return None
            return [_coerce(x, dt.element) for x in v]
        if isinstance(dt, T.StructType):
            if not isinstance(v, dict):
                return None
            return {f.name: _coerce(v.get(f.name), f.dtype)
                    for f in dt.fields}
        if isinstance(dt, T.MapType):
            if not isinstance(v, dict):
                return None
            return [(k, _coerce(x, dt.value)) for k, x in v.items()]
    except (ValueError, TypeError):
        return None
    return None


class JsonToStructs(CpuRowFunction):
    """from_json(json, schema) -> struct, array or map (reference
    GpuJsonToStructs)."""

    name = "from_json"

    def __init__(self, *children, params=()):
        super().__init__(*children, params=params)
        self.result = self.params[0]
        if not isinstance(self.result, (T.StructType, T.ArrayType,
                                        T.MapType)):
            raise SparkException(f"from_json schema must be struct/array/"
                                 f"map, got {self.result!r}")

    def row_fn(self, s):
        try:
            v = json.loads(s)
        except (ValueError, TypeError):
            return None
        return _coerce(v, self.result)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        out = [self.row_fn(v) if ok else None
               for v, ok in zip(c.values, c.valid)]
        vals = np.empty(len(out), object)
        vals[:] = out
        return CpuCol(self.result, vals,
                      np.asarray([r is not None for r in out], np.bool_))


JSON_FUNCTIONS = [GetJsonObject, JsonToStructs]
