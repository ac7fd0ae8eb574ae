"""Hive table support: LazySimpleSerDe text tables + partition discovery
(counterpart of ``spark_rapids_tpu/sql/hive.py``).

Reference parity: org/apache/spark/sql/hive/rapids/ (GpuHiveTextFileFormat,
GpuHiveTableScanExec, the hive serde read/write family). The engine
analog reads and writes Hive's default delimited text layout:

- fields separated by ctrl-A (\\x01, configurable), rows by newline,
  ``\\N`` for NULL — LazySimpleSerDe's wire format;
- ``key=value`` partition directories discovered on read and written on
  insert (partition column values come from the directory, not the
  file);
- values parse by a declared schema with Hive's lax casting (bad cells
  become NULL, like LazySimpleSerDe).

Hive UDF bridges (GenericUDF over the JVM) are out of scope without a
JVM; the row-UDF tier plays that role (``sql/udf.py``: ``udf`` for an
opaque Python function, ``torch_udf`` for a columnar one).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional
from urllib.parse import quote, unquote

import pyarrow as pa


NULL_TOKEN = "\\N"
DEFAULT_DELIM = "\x01"


def _parse_cell(raw: str, dtype: pa.DataType):
    if raw == NULL_TOKEN:
        return None
    s = _unescape(raw)
    try:
        if pa.types.is_int64(dtype) or pa.types.is_int32(dtype):
            return int(s)
        if pa.types.is_floating(dtype):
            return float(s)
        if pa.types.is_boolean(dtype):
            low = s.lower()
            if low == "true":
                return True
            if low == "false":
                return False
            return None  # LazyBoolean: anything else is NULL
        return s
    except ValueError:
        return None  # LazySimpleSerDe: malformed cells read as NULL


def _escape(s: str, delim: str) -> str:
    """Backslash-escape the wire metacharacters (LazySimpleSerDe with an
    escape char): backslash itself, the field delimiter, and newlines."""
    return (s.replace("\\", "\\\\")
             .replace(delim, "\\" + delim)
             .replace("\n", "\\n"))


def _split_raw(line: str, delim: str) -> List[str]:
    """Split on UNESCAPED delimiters, keeping escape pairs verbatim —
    the \\N null token must be recognized on the RAW cell (a data string
    that unescapes to backslash-N is NOT null, exactly LazySimpleSerDe's
    distinction)."""
    out, cur, i = [], [], 0
    while i < len(line):
        ch = line[i]
        if ch == "\\" and i + 1 < len(line):
            cur.append(line[i: i + 2])
            i += 2
            continue
        if ch == delim:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    out.append("".join(cur))
    return out


def _unescape(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _render_cell(v, delim: str = DEFAULT_DELIM) -> str:
    if v is None:
        return NULL_TOKEN
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, str):
        return _escape(v, delim)
    return str(v)


class HiveTable:
    """Delimited-text Hive table over a directory tree."""

    def __init__(self, session, path: str, schema: pa.Schema,
                 partition_cols: Optional[List[str]] = None,
                 delimiter: str = DEFAULT_DELIM):
        self.session = session
        self.path = path
        self.schema = schema
        self.partition_cols = list(partition_cols or [])
        self.delimiter = delimiter
        self._data_fields = [f for f in schema
                             if f.name not in self.partition_cols]

    # -- read ---------------------------------------------------------------

    def _walk(self):
        """Yield (file_path, {partition_col: value_str}). Sibling codecs:
        session._discover_hive (parquet partition discovery) and
        io/writer._partition_dirs (partitioned writes) render/parse the
        same key=value layout; changes here likely apply there too."""
        for root, _dirs, files in os.walk(self.path):
            rel = os.path.relpath(root, self.path)
            parts: Dict[str, str] = {}
            ok = True
            if rel != ".":
                for seg in rel.split(os.sep):
                    if "=" not in seg:
                        ok = False
                        break
                    k, v = seg.split("=", 1)
                    parts[k] = unquote(v)
            if not ok:
                continue
            for name in sorted(files):
                if name.startswith(("_", ".")):
                    continue
                yield os.path.join(root, name), parts

    def to_df(self):
        cols: Dict[str, list] = {f.name: [] for f in self.schema}
        found = False
        for fp, parts in self._walk():
            with open(fp, encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    # a blank line IS a row (empty first cell, rest NULL)
                    found = True
                    cells = _split_raw(line, self.delimiter)
                    for i, fld in enumerate(self._data_fields):
                        raw = cells[i] if i < len(cells) else NULL_TOKEN
                        cols[fld.name].append(_parse_cell(raw, fld.type))
                    for pc in self.partition_cols:
                        pv = parts.get(pc)
                        pf = self.schema.field(pc)
                        cols[pc].append(
                            None if pv in (None,
                                           "__HIVE_DEFAULT_PARTITION__")
                            else _parse_cell(pv, pf.type))
        if not found:
            table = pa.table({f.name: pa.array([], f.type)
                              for f in self.schema})
        else:
            table = pa.table({f.name: pa.array(cols[f.name], f.type)
                              for f in self.schema})
        return self.session.create_dataframe(table)

    # -- write --------------------------------------------------------------

    def insert(self, df, overwrite: bool = False) -> int:
        """INSERT [OVERWRITE] with dynamic partitioning."""
        table = df.collect() if hasattr(df, "collect") else df
        if overwrite and os.path.isdir(self.path):
            import shutil
            shutil.rmtree(self.path)
        os.makedirs(self.path, exist_ok=True)
        import uuid
        rows = table.to_pylist()
        by_dir: Dict[str, list] = {}
        for r in rows:
            segs = []
            for pc in self.partition_cols:
                v = r.get(pc)
                segs.append(
                    f"{pc}=" + ("__HIVE_DEFAULT_PARTITION__" if v is None
                                else quote(_render_cell(v), safe="")))
            by_dir.setdefault("/".join(segs), []).append(r)
        for subdir, sub_rows in by_dir.items():
            d = os.path.join(self.path, subdir) if subdir else self.path
            os.makedirs(d, exist_ok=True)
            fp = os.path.join(d, f"part-{uuid.uuid4().hex[:12]}")
            with open(fp, "w", encoding="utf-8") as f:
                for r in sub_rows:
                    f.write(self.delimiter.join(
                        _render_cell(r.get(fld.name), self.delimiter)
                        for fld in self._data_fields))
                    f.write("\n")
        return len(rows)
