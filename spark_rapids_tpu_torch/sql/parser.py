"""SQL string frontend (counterpart of ``spark_rapids_tpu/sql/parser.py``,
adapted): a recursive-descent parser for the query subset the engine's
DataFrame algebra covers.

A Spark plugin receives SQL already parsed by Catalyst; a standalone engine
carries its own parser. It reads SELECT with expressions, aggregates and
aliases; FROM with derived tables and INNER/LEFT/RIGHT/FULL/SEMI/ANTI/CROSS
JOIN .. ON equi-conditions; WHERE; GROUP BY with ROLLUP/CUBE/GROUPING
SETS; HAVING; ORDER BY .. ASC/DESC [NULLS FIRST|LAST]; LIMIT; UNION
[ALL]/INTERSECT/EXCEPT/MINUS; WITH; window functions with OVER and ROWS
frames; [NOT] IN and [NOT] EXISTS subqueries (lowered to left semi and
anti joins); uncorrelated scalar subqueries (run eagerly, on the session's
device, while the query is parsed); and the scalar grammar (arithmetic,
comparisons, AND/OR/NOT, BETWEEN, IN, LIKE, IS NULL, CASE WHEN, CAST(x AS
type), function calls routed through ``sql/functions.py``). A query
outside the subset raises SparkException with the offending token, in the
JAX package's words: parse or reject, never misread. The untyped NULL
literal is a NULL-typed literal, as in the JAX package. Lambdas have no
SQL syntax here, as there: they come through the DataFrame API.
"""
from __future__ import annotations

import re
from typing import List

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr.core import SparkException

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
    | (?P<str>'(?:[^']|'')*')
    | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op><=|>=|<>|!=|\|\||[-+*/%(),.<>=])
    )""", re.VERBOSE)

_KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "between", "like", "is", "null",
    "case", "when", "then", "else", "end", "cast", "join", "inner",
    "left", "right", "full", "outer", "semi", "anti", "cross", "on",
    "asc", "desc", "union", "all", "distinct", "true", "false", "nulls",
    "first", "last", "with", "over", "partition", "rows",
    "range", "unbounded", "preceding", "following", "current",
    "row", "rollup", "cube", "grouping", "sets", "exists",
    "intersect", "except", "minus",
}

_TYPES = {
    "int": T.INT32, "integer": T.INT32, "bigint": T.INT64,
    "long": T.INT64, "smallint": T.INT16, "tinyint": T.INT8,
    "double": T.FLOAT64, "float": T.FLOAT32, "string": T.STRING,
    "boolean": T.BOOLEAN, "date": T.DATE, "timestamp": T.TIMESTAMP,
}


def _tokenize(text: str):
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            rest = text[pos:].strip()
            if not rest:
                break
            raise SparkException(f"SQL: cannot tokenize at {rest[:20]!r}")
        pos = m.end()
        if m.group("num") is not None:
            out.append(("num", m.group("num")))
        elif m.group("str") is not None:
            out.append(("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.group("id") is not None:
            word = m.group("id")
            kind = "kw" if word.lower() in _KEYWORDS else "id"
            out.append((kind, word))
        else:
            out.append(("op", m.group("op")))
    out.append(("eof", ""))
    return out


class _QCol(E.Col):
    """Qualified column reference (alias.name). The engine resolves by
    bare name, but the parser needs the qualifier to classify
    subquery-correlation predicates (t.k = d.k must NOT collapse to
    k = k)."""

    def __init__(self, name: str, qualifier: str):
        super().__init__(name)
        self.qualifier = qualifier


class _SubSpec:
    """A parsed-but-unbuilt subquery: WHERE conjuncts are kept unapplied
    so correlated predicates (references to OUTER columns) can be
    classified and turned into join keys at lowering time."""

    def __init__(self, items, star, df, conjs, group_keys, having, scope):
        self.items = items          # SELECT item expressions
        self.star = star            # SELECT * ?
        self.df = df                # FROM (joins applied)
        self.conjs = conjs          # WHERE conjuncts, unapplied
        self.group_keys = group_keys
        self.having = having
        self.scope = scope          # alias -> column-name set (FROM)


class _SubqueryMarker(E.Expression):
    """Parser-internal [NOT] EXISTS/IN-subquery placeholder. Lowered to
    a left semi/anti join by _apply_where (the engine's analog of
    Spark's RewritePredicateSubquery; the reference then sees the
    already-lowered joins, GpuBroadcastHashJoinExec etc). Never reaches
    binding."""

    def __init__(self, sub: _SubSpec, in_expr=None):
        self.children = []
        self.sub = sub
        self.in_expr = in_expr      # outer-side expr for IN, None=EXISTS

    def data_type(self):
        return T.BOOLEAN

    def fingerprint(self):
        return f"_SubqueryMarker@{id(self)}"


def _split_and(e):
    if isinstance(e, E.And):
        return _split_and(e.children[0]) + _split_and(e.children[1])
    return [e]


def _has_marker(e):
    if isinstance(e, _SubqueryMarker):
        return True
    fn = getattr(e, "fn", None)  # NamedAgg wraps without .children
    if fn is not None and _has_marker(fn):
        return True
    return any(_has_marker(c) for c in getattr(e, "children", []))


def _and_all(conjs):
    out = conjs[0]
    for c in conjs[1:]:
        out = E.And(out, c)
    return out


class _Parser:
    def __init__(self, text: str, session):
        self.toks = _tokenize(text)
        self.i = 0
        self.session = session
        self.ctes = {}  # WITH-clause name -> DataFrame, query-scoped

    # -- token plumbing -----------------------------------------------------

    def peek(self, k: int = 0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def kw(self, *words) -> bool:
        """Consume the keyword sequence if it is next (case-insensitive)."""
        for j, w in enumerate(words):
            k, v = self.peek(j)
            if k != "kw" or v.lower() != w:
                return False
        self.i += len(words)
        return True

    def op(self, sym: str) -> bool:
        k, v = self.peek()
        if k == "op" and v == sym:
            self.i += 1
            return True
        return False

    def expect_op(self, sym: str):
        if not self.op(sym):
            raise SparkException(
                f"SQL: expected {sym!r}, got {self.peek()[1]!r}")

    def ident(self) -> str:
        k, v = self.next()
        if k not in ("id", "kw"):
            raise SparkException(f"SQL: expected identifier, got {v!r}")
        return v

    # -- expressions --------------------------------------------------------

    def expr(self):
        return self._or()

    def _or(self):
        e = self._and()
        while self.kw("or"):
            e = E.Or(e, self._and())
        return e

    def _and(self):
        e = self._not()
        while self.kw("and"):
            e = E.And(e, self._not())
        return e

    def _not(self):
        if self.kw("not"):
            return E.Not(self._not())
        return self._cmp()

    def _cmp(self):
        e = self._add()
        neg = self.kw("not")
        if self.kw("between"):
            lo = self._add()
            if not self.kw("and"):
                raise SparkException("SQL: BETWEEN needs AND")
            hi = self._add()
            out = E.And(E.GreaterThanOrEqual(e, lo),
                        E.LessThanOrEqual(e, hi))
            return E.Not(out) if neg else out
        if self.kw("in"):
            self.expect_op("(")
            if self.peek()[1].lower() == "select":
                sub = self._sub_query_spec()
                self.expect_op(")")
                out = _SubqueryMarker(sub, in_expr=e)
                return E.Not(out) if neg else out
            vals = [self.expr()]
            while self.op(","):
                vals.append(self.expr())
            self.expect_op(")")
            out = E.In(e, vals)
            return E.Not(out) if neg else out
        if self.kw("like"):
            k, v = self.next()
            if k != "str":
                raise SparkException("SQL: LIKE needs a string pattern")
            from spark_rapids_tpu_torch.expr.strings import Like
            out = Like(e, v)
            return E.Not(out) if neg else out
        if neg:
            raise SparkException("SQL: dangling NOT")
        if self.kw("is", "not", "null"):
            return E.IsNotNull(e)
        if self.kw("is", "null"):
            return E.IsNull(e)
        for sym, cls in (("<=", E.LessThanOrEqual),
                         (">=", E.GreaterThanOrEqual),
                         ("<>", None), ("!=", None), ("=", E.EqualTo),
                         ("<", E.LessThan), (">", E.GreaterThan)):
            if self.op(sym):
                r = self._add()
                if cls is None:
                    return E.Not(E.EqualTo(e, r))
                return cls(e, r)
        return e

    def _add(self):
        e = self._mul()
        while True:
            if self.op("+"):
                e = E.Add(e, self._mul())
            elif self.op("-"):
                e = E.Subtract(e, self._mul())
            elif self.op("||"):
                from spark_rapids_tpu_torch.expr.strings import (
                    ConcatStrings)
                e = ConcatStrings(e, self._mul())
            else:
                return e

    def _mul(self):
        e = self._unary()
        while True:
            if self.op("*"):
                e = E.Multiply(e, self._unary())
            elif self.op("/"):
                e = E.Divide(e, self._unary())
            elif self.op("%"):
                e = E.Remainder(e, self._unary())
            else:
                return e

    def _unary(self):
        if self.op("-"):
            return E.UnaryMinus(self._unary())
        if self.op("+"):
            return self._unary()
        return self._primary()

    def _case(self):
        branches = []
        while self.kw("when"):
            cond = self.expr()
            if not self.kw("then"):
                raise SparkException("SQL: CASE WHEN needs THEN")
            branches.append((cond, self.expr()))
        default = self.expr() if self.kw("else") else None
        if not self.kw("end"):
            raise SparkException("SQL: CASE needs END")
        if not branches:
            raise SparkException("SQL: CASE needs at least one WHEN")
        return E.CaseWhen(branches, default)

    def _call(self, name: str):
        """Function call routed through sql.functions (lower-cased)."""
        from spark_rapids_tpu_torch.sql import functions as F
        args: List = []
        if name.lower() == "count" and self.op("*"):
            self.expect_op(")")
            return F.count()
        distinct = self.kw("distinct")
        if not self.op(")"):
            args.append(self.expr())
            while self.op(","):
                args.append(self._scalar_or_expr())
            self.expect_op(")")
        if distinct:
            raise SparkException(
                f"SQL: DISTINCT inside {name}() is not supported")
        fn = getattr(F, name.lower(), None)
        if fn is None or not callable(fn):
            raise SparkException(f"SQL: unknown function {name!r}")
        out = fn(*args)
        if self.kw("over"):
            out = self._over(out)
        return out

    def _frame_bound(self, default):
        if self.kw("unbounded", "preceding") \
                or self.kw("unbounded", "following"):
            return None
        if self.kw("current", "row"):
            return 0
        k, v = self.peek()
        sign = 1
        if k == "op" and v == "-":
            self.next()
            sign = -1
            k, v = self.peek()
        if k == "num":
            self.next()
            n = sign * int(v)
            if self.kw("preceding"):
                return -abs(n)
            if self.kw("following"):
                return abs(n)
            raise SparkException(
                "SQL: frame bound needs PRECEDING/FOLLOWING")
        return default

    def _over(self, fn):
        """fn(...) OVER (PARTITION BY .. ORDER BY .. [ROWS BETWEEN ..])
        -> WindowExpr; aggregates become windowed aggregates."""
        from spark_rapids_tpu_torch.expr import window as WE
        from spark_rapids_tpu_torch.expr.aggregates import AggFunction
        self.expect_op("(")
        spec = WE.WindowSpec()
        if self.kw("partition", "by"):
            parts = [self.expr()]
            while self.op(","):
                parts.append(self.expr())
            spec = spec.partition_by(*parts)
        if self.kw("order", "by"):
            orders = [self._sort_item()]
            while self.op(","):
                orders.append(self._sort_item())
            spec = spec.order_by(*orders)
        if self.kw("rows"):
            if not self.kw("between"):
                raise SparkException("SQL: ROWS needs BETWEEN")
            lo = self._frame_bound(None)
            if not self.kw("and"):
                raise SparkException("SQL: frame needs AND")
            hi = self._frame_bound(None)
            spec = spec.rows_between(lo, hi)
        self.expect_op(")")
        if isinstance(fn, AggFunction):
            return WE.over(fn, spec)
        return fn.over(spec)

    def _scalar_or_expr(self):
        """Trailing function args: plain (optionally negative) numeric
        and string literals stay python values, because many function
        signatures take ints/strs (substring pos, conv bases)."""
        k, v = self.peek()
        sign = 1
        if k == "op" and v == "-" and self.peek(1)[0] == "num" \
                and self.peek(2)[1] in (",", ")"):
            self.next()
            k, v = self.peek()
            sign = -1
        if k == "num" and self.peek(1)[1] in (",", ")"):
            self.next()
            return sign * (float(v) if ("." in v or "e" in v.lower())
                           else int(v))
        if k == "str" and self.peek(1)[1] in (",", ")"):
            self.next()
            return v
        return self.expr()

    def _primary(self):
        k, v = self.peek()
        if k == "num":
            self.next()
            return E.lit(float(v) if ("." in v or "e" in v.lower())
                         else int(v))
        if k == "str":
            self.next()
            return E.lit(v)
        if self.kw("true"):
            return E.lit(True)
        if self.kw("false"):
            return E.lit(False)
        if self.kw("null"):
            return E.Literal(None, T.NULL)
        if self.kw("case"):
            return self._case()
        if self.kw("exists"):
            self.expect_op("(")
            sub = self._sub_query_spec()
            self.expect_op(")")
            return _SubqueryMarker(sub)
        if self.kw("cast"):
            self.expect_op("(")
            e = self.expr()
            if not self.kw("as"):
                raise SparkException("SQL: CAST needs AS")
            tname = self.ident().lower()
            if tname not in _TYPES:
                raise SparkException(f"SQL: unknown type {tname!r}")
            self.expect_op(")")
            return E.Cast(e, _TYPES[tname])
        if self.op("("):
            if self.peek()[1].lower() == "select":
                return self._scalar_subquery()
            e = self.expr()
            self.expect_op(")")
            return e
        if k in ("id", "kw"):
            name = self.ident()
            if self.op("("):
                return self._call(name)
            if self.op("."):
                # qualified a.b: the engine resolves by column name, but
                # the qualifier is kept for subquery-correlation scoping
                return _QCol(self.ident(), name.lower())
            return E.col(name)
        raise SparkException(f"SQL: unexpected token {v!r}")

    # -- subqueries ---------------------------------------------------------

    def _sub_query_spec(self) -> _SubSpec:
        """Parse a predicate subquery WITHOUT applying its WHERE clause
        (correlated conjuncts reference outer columns and must become
        join keys, not filters)."""
        if not self.kw("select"):
            raise SparkException("SQL: subquery must start with SELECT")
        self.kw("distinct")  # semi/anti join semantics make it a no-op
        items, star = [], False
        while True:
            if self.op("*"):
                star = True
            else:
                e = self.expr()
                if self.kw("as") or self.peek()[0] == "id":
                    self.ident()  # aliases are irrelevant to the join
                items.append(e)
            if not self.op(","):
                break
        if not self.kw("from"):
            raise SparkException("SQL: subquery needs FROM")
        saved = getattr(self, "_scope", {})
        df = self._from()
        scope = self._scope
        conjs = []
        if self.kw("where"):
            conjs = _split_and(self.expr())
        group_keys = None
        if self.kw("group", "by"):
            group_keys = [self.expr()]
            while self.op(","):
                group_keys.append(self.expr())
        having = self.expr() if self.kw("having") else None
        # pop the subquery's scope: the ENCLOSING query's scope must not
        # end up holding the subquery's aliases after this parse returns
        self._scope = saved
        return _SubSpec(items, star, df, conjs, group_keys, having, scope)

    def _scalar_subquery(self):
        """(SELECT <single value>): evaluated EAGERLY to a literal (the
        engine analog of Spark's uncorrelated ScalarSubquery, which also
        executes before the main query; correlated scalar subqueries
        raise at build when the outer column fails to resolve)."""
        saved = getattr(self, "_scope", {})
        df = self.select()
        self._scope = saved
        self.expect_op(")")
        tbl = df.limit(2).collect()
        if tbl.num_columns != 1:
            raise SparkException(
                "SQL: scalar subquery must return one column")
        if tbl.num_rows > 1:
            raise SparkException(
                "SQL: scalar subquery returned more than one row")
        dt = T.from_arrow(tbl.schema.field(0).type)
        if tbl.num_rows == 0:
            return E.Literal(None, dt)
        v = tbl.column(0)[0].as_py()
        if v is None:
            return E.Literal(None, dt)
        return E.Cast(E.lit(v), dt)

    def _apply_where(self, df, cond, outer_scope):
        """WHERE lowering: plain conjuncts filter; [NOT] EXISTS/IN
        subquery conjuncts become left semi/anti joins (Spark's
        RewritePredicateSubquery)."""
        plain, subs = [], []
        for c in _split_and(cond):
            neg, inner = False, c
            while isinstance(inner, E.Not) and _has_marker(inner):
                neg = not neg
                inner = inner.children[0]
            if isinstance(inner, _SubqueryMarker):
                subs.append((inner, neg))
            elif _has_marker(c):
                raise SparkException(
                    "SQL: EXISTS/IN subqueries are only supported as "
                    "top-level AND conjuncts of WHERE")
            else:
                plain.append(c)
        if plain:
            df = df.filter(_and_all(plain))
        for m, neg in subs:
            df = self._apply_subquery(df, m, neg, outer_scope)
        return df

    @staticmethod
    def _ref_side(e, sub_cols, sub_scope, outer_cols, outer_scope):
        """'sub' / 'outer' / 'mixed' for one conjunct expression.
        Qualified references resolve innermost-first (the subquery's
        FROM aliases shadow the outer query's), so t.k = d.k keeps its
        two sides apart even though both columns are named k."""
        sides = set()

        def walk(x):
            if isinstance(x, _QCol):
                q = x.qualifier
                if q in sub_scope and x.name.lower() in sub_scope[q]:
                    sides.add("sub")
                elif q in outer_scope and \
                        x.name.lower() in outer_scope[q]:
                    sides.add("outer")
                else:
                    raise SparkException(
                        f"SQL: cannot resolve {q}.{x.name} in the "
                        "subquery or outer scope")
                return
            if isinstance(x, E.Col):
                nm = x.name.lower()
                if nm in sub_cols:
                    sides.add("sub")
                elif nm in outer_cols:
                    sides.add("outer")
                else:
                    raise SparkException(
                        f"SQL: cannot resolve column {x.name!r}")
                return
            for c in x.children:
                walk(c)

        walk(e)
        if sides <= {"sub"}:
            return "sub"
        if sides == {"outer"}:
            return "outer"
        return "mixed"

    def _apply_subquery(self, df, m: _SubqueryMarker, neg: bool,
                        outer_scope):
        spec = m.sub
        outer_cols = {n.lower() for n in df.columns}
        sub_df = spec.df
        sub_cols = {n.lower() for n in sub_df.columns}
        local, pairs = [], []
        for c in spec.conjs:
            side = self._ref_side(c, sub_cols, spec.scope, outer_cols,
                                  outer_scope)
            if side == "sub":
                local.append(c)
                continue
            if isinstance(c, E.EqualTo):
                l, r = c.children
                ls = self._ref_side(l, sub_cols, spec.scope, outer_cols,
                                    outer_scope)
                rs = self._ref_side(r, sub_cols, spec.scope, outer_cols,
                                    outer_scope)
                if ls == "sub" and rs == "outer":
                    pairs.append((r, l))
                    continue
                if rs == "sub" and ls == "outer":
                    pairs.append((l, r))
                    continue
            raise SparkException(
                "SQL: unsupported correlated subquery predicate "
                f"{c!r} (only equality correlation to outer columns)")
        if local:
            sub_df = sub_df.filter(_and_all(local))
        if spec.group_keys is not None:
            if pairs:
                raise SparkException(
                    "SQL: correlated grouped subqueries are not "
                    "supported")
            sub_df = self._grouped_sub(sub_df, spec)
        if m.in_expr is not None:
            if spec.star or len(spec.items) != 1:
                raise SparkException(
                    "SQL: IN subquery must select exactly one item")
            item = spec.items[0]
            if isinstance(item, E.Alias):
                item = item.children[0]
            if neg:
                # NOT IN is null-aware: any NULL in the subquery makes
                # every row UNKNOWN (dropped), and NULL probes only
                # qualify against an EMPTY subquery (no comparisons
                # happen) — the shape the reference handles as a
                # null-aware anti join. The emptiness/has-null shortcuts
                # below evaluate the subquery AS A WHOLE, which is only
                # sound when no correlation restricts it per outer row;
                # a correlated NOT IN would over-drop unrelated outer
                # rows, so reject it instead of guessing.
                if pairs:
                    raise SparkException(
                        "SQL: correlated NOT IN subqueries are not "
                        "supported (null-aware anti join with "
                        "correlation); rewrite as NOT EXISTS with an "
                        "explicit null check")
                if sub_df.limit(1).count() == 0:
                    return df
                has_null = sub_df.filter(
                    E.IsNull(item)).limit(1).count() > 0
                if has_null:
                    return df.filter(E.lit(False))
                df = df.filter(E.IsNotNull(m.in_expr))
            pairs = [(m.in_expr, item)] + pairs
        if not pairs:
            # uncorrelated EXISTS: emptiness decides for every row
            nonempty = sub_df.limit(1).count() > 0
            return df.filter(E.lit(nonempty != neg))
        how = "left_anti" if neg else "left_semi"
        return df.join(sub_df, on=pairs, how=how)

    def _grouped_sub(self, sub_df, spec: _SubSpec):
        """Uncorrelated grouped IN-subquery: GROUP BY + HAVING with the
        single select item preserved."""
        from spark_rapids_tpu_torch.expr.aggregates import (
            AggFunction, NamedAgg)
        from spark_rapids_tpu_torch.plan.nodes import expr_name
        aggs = []

        def fold(e):
            if isinstance(e, AggFunction):
                nm = f"__subagg{len(aggs)}"
                aggs.append(NamedAgg(e, nm))
                return E.col(nm)
            return e.with_children([fold(c) for c in e.children])

        having = fold(spec.having) if spec.having is not None else None
        item = spec.items[0] if len(spec.items) == 1 and not spec.star \
            else None
        item_is_agg = isinstance(item, AggFunction) or (
            isinstance(item, E.Alias)
            and isinstance(item.children[0], AggFunction))
        if item_is_agg:
            fn = item.children[0] if isinstance(item, E.Alias) else item
            nm = expr_name(item, 0)
            aggs.append(NamedAgg(fn, nm))
            spec.items = [E.col(nm)]
        out = sub_df.group_by(*spec.group_keys).agg(*aggs)
        if having is not None:
            out = out.filter(having)
        return out

    # -- query --------------------------------------------------------------

    def _table(self):
        alias = None
        if self.op("("):
            # derived table: FROM (SELECT ...) [AS] alias. The nested
            # select()'s own _from rebinds self._scope; save/restore so
            # aliases registered earlier in THIS FROM clause survive and
            # the derived table's inner aliases don't leak into the outer
            # correlation scope.
            saved = getattr(self, "_scope", {})
            df = self.select()
            self._scope = saved
            self.expect_op(")")
        else:
            name = self.ident()
            alias = name.lower()
            df = self.ctes.get(name.lower())
            if df is None:
                df = self.session.table(name)
        # optional alias (resolution stays name-based; recorded for
        # subquery-correlation scoping)
        k, v = self.peek()
        if k == "id" or (k == "kw" and self.kw("as")):
            if k == "id":
                self.next()
                alias = v.lower()
            else:
                alias = self.ident().lower()
        if alias is not None:
            self._scope[alias] = {n.lower() for n in df.columns}
        return df

    def _from(self):
        self._scope = {}
        df = self._table()
        while True:
            how = None
            if self.kw("inner", "join") or self.kw("join"):
                how = "inner"
            elif self.kw("left", "semi", "join"):
                how = "left_semi"
            elif self.kw("left", "anti", "join"):
                how = "left_anti"
            elif self.kw("left", "outer", "join") or self.kw("left", "join"):
                how = "left"
            elif self.kw("right", "outer", "join") \
                    or self.kw("right", "join"):
                how = "right"
            elif self.kw("full", "outer", "join") or self.kw("full", "join"):
                how = "full"
            elif self.kw("cross", "join"):
                how = "cross"
            else:
                return df
            right = self._table()
            if how == "cross":
                df = df.join(right, on=None, how="cross")
                continue
            if not self.kw("on"):
                raise SparkException("SQL: JOIN needs ON")
            cond = self.expr()
            pairs = self._equi_pairs(cond)
            df = df.join(right, on=pairs, how=how)

    def _equi_pairs(self, cond):
        """Flatten `a = b AND c = d ...` into join key pairs."""
        if isinstance(cond, E.And):
            return self._equi_pairs(cond.children[0]) + \
                self._equi_pairs(cond.children[1])
        if isinstance(cond, E.EqualTo):
            return [(cond.children[0], cond.children[1])]
        raise SparkException(
            "SQL: only equi-join ON conditions (a = b AND ...) are "
            f"supported, got {cond!r}")

    def _select_core(self):
        if not self.kw("select"):
            raise SparkException("SQL: expected SELECT")
        distinct = self.kw("distinct")
        items, stars = [], False
        while True:
            if self.op("*"):
                stars = True
            else:
                e = self.expr()
                if self.kw("as"):
                    e = e.alias(self.ident())
                elif self.peek()[0] == "id":
                    e = e.alias(self.ident())
                items.append(e)
            if not self.op(","):
                break
        if not self.kw("from"):
            raise SparkException("SQL: expected FROM")
        df = self._from()
        outer_scope = self._scope
        for it in items:
            if _has_marker(it):
                raise SparkException(
                    "SQL: EXISTS/IN subqueries are only supported in "
                    "WHERE")
        if self.kw("where"):
            df = self._apply_where(df, self.expr(), outer_scope)
        group_keys, group_mode = None, None
        if self.kw("group", "by"):
            if self.kw("rollup") or self.kw("cube"):
                group_mode = self.toks[self.i - 1][1].lower()
                self.expect_op("(")
                group_keys = [self.expr()]
                while self.op(","):
                    group_keys.append(self.expr())
                self.expect_op(")")
            elif self.kw("grouping", "sets"):
                self.expect_op("(")
                raw_sets = []
                while True:
                    self.expect_op("(")
                    s = []
                    if not self.op(")"):
                        s.append(self.expr())
                        while self.op(","):
                            s.append(self.expr())
                        self.expect_op(")")
                    raw_sets.append(s)
                    if not self.op(","):
                        break
                self.expect_op(")")
                # keys = union of set members, first-appearance order
                group_keys, fps = [], []
                for s in raw_sets:
                    for e in s:
                        fp = e.fingerprint()
                        if fp not in fps:
                            fps.append(fp)
                            group_keys.append(e)
                group_mode = [tuple(fps.index(e.fingerprint())
                                    for e in s) for s in raw_sets]
            else:
                group_keys = [self.expr()]
                while self.op(","):
                    group_keys.append(self.expr())
        having = self.expr() if self.kw("having") else None
        if having is not None and _has_marker(having):
            raise SparkException(
                "SQL: EXISTS/IN subqueries are only supported in WHERE")

        from spark_rapids_tpu_torch.expr.aggregates import (
            AggFunction, NamedAgg)
        from spark_rapids_tpu_torch.plan.nodes import expr_name  # noqa: F401

        def agg_of(e):
            if isinstance(e, NamedAgg):  # AggFunction.alias() result
                return e.fn, e.name
            if isinstance(e, AggFunction):
                return e, None
            if isinstance(e, E.Alias) and isinstance(e.children[0],
                                                     AggFunction):
                return e.children[0], e.name
            return None, None

        if group_keys is not None:
            aggs, out_names = [], []
            for j, it in enumerate(items):
                fn, nm = agg_of(it)
                if fn is not None:
                    nm = nm or expr_name(it, j)
                    aggs.append(NamedAgg(fn, nm))
                    out_names.append(E.col(nm))
                else:
                    out_names.append(it)

            def fold_agg(e):
                """HAVING aggregates read the agg output: reuse a
                SELECT agg with the same fingerprint or add a hidden
                one (dropped by the final projection)."""
                if isinstance(e, AggFunction):
                    fp = e.fingerprint()
                    for na in aggs:
                        if na.fn.fingerprint() == fp:
                            return E.col(na.name)
                    nm = f"__having{len(aggs)}"
                    aggs.append(NamedAgg(e, nm))
                    return E.col(nm)
                return e.with_children(
                    [fold_agg(c) for c in e.children])

            if having is not None:
                having = fold_agg(having)
            if group_mode == "rollup":
                gd = df.rollup(*group_keys)
            elif group_mode == "cube":
                gd = df.cube(*group_keys)
            elif isinstance(group_mode, list):
                gd = df.grouping_sets(group_mode, *group_keys)
            else:
                gd = df.group_by(*group_keys)
            df = gd.agg(*aggs)
            if having is not None:
                df = df.filter(having)
            final_items = out_names if not stars else None
            if not stars:
                def projector(d):
                    return d.select(*out_names)
            else:
                def projector(d):
                    keep = [E.col(n) for n in d.plan.schema.names
                            if not n.startswith("__having")]
                    return d.select(*keep)
        else:
            if any(agg_of(it)[0] is not None for it in items):
                aggs = []
                for j, it in enumerate(items):
                    fn, nm = agg_of(it)
                    if fn is None:
                        raise SparkException(
                            "SQL: mixing aggregates and plain columns "
                            "needs GROUP BY")
                    aggs.append(NamedAgg(fn, nm or expr_name(it, j)))

                def fold_global(e):
                    if isinstance(e, AggFunction):
                        fp = e.fingerprint()
                        for na in aggs:
                            if na.fn.fingerprint() == fp:
                                return E.col(na.name)
                        nm = f"__having{len(aggs)}"
                        aggs.append(NamedAgg(e, nm))
                        return E.col(nm)
                    return e.with_children(
                        [fold_global(c) for c in e.children])

                if having is not None:
                    having = fold_global(having)
                keep = [E.col(na.name) for na in aggs
                        if not na.name.startswith("__having")]
                df = df.agg(*aggs)
                if having is not None:
                    df = df.filter(having)

                final_items = keep

                def projector(d):
                    return d.select(*keep)
            elif having is not None:
                raise SparkException("SQL: HAVING needs aggregates")
            elif not stars:
                final_items = items

                def projector(d):
                    return d.select(*items)
            elif items:
                raise SparkException(
                    "SQL: SELECT *, expr mixing is not supported")
            else:
                final_items = None

                def projector(d):
                    return d
        if distinct:
            base = projector

            def projector(d):  # noqa: F811 - deliberate wrap
                return base(d).distinct()
        # the projection is DEFERRED so ORDER BY can reference
        # non-projected source columns (standard SQL scoping)
        return df, projector, distinct, final_items

    def select(self):
        """One [SELECT .. UNION ..]* chain with trailing ORDER BY /
        LIMIT applying to the COMBINED result (SQL scoping)."""
        pre, proj, distinct, final_items = self._select_core()
        df = proj(pre)
        unioned = False
        while True:
            # set ops parse left-associative at one precedence level (a
            # documented deviation from the standard's INTERSECT-binds-
            # tighter rule; NDS chains are homogeneous so it is moot)
            if self.kw("union", "all"):
                op = "ua"
            elif self.kw("union"):
                op = "u"
            elif self.kw("intersect"):
                op = "i"
            elif self.kw("except") or self.kw("minus"):
                op = "e"
            else:
                break
            p2, j2, _, _ = self._select_core()
            r = j2(p2)
            if op == "ua":
                df = df.union(r)
            elif op == "u":
                df = df.union(r).distinct()  # bare UNION dedups
            elif op == "i":
                df = df.intersect(r)
            else:
                df = df.subtract(r)
            unioned = True
        if self.kw("order", "by"):
            orders = [self._sort_item()]
            while self.op(","):
                orders.append(self._sort_item())
            try:
                df = df.order_by(*orders)
            except KeyError as ke:
                # ORDER BY a non-projected source column: sort a
                # WIDENED frame (source columns + projected aliases)
                # then project, so aliases and hidden columns mix
                # (unions and DISTINCT expose output columns only)
                if unioned or distinct or final_items is None:
                    raise SparkException(
                        f"SQL: ORDER BY column not in output: {ke}; "
                        "DISTINCT/UNION results sort by output columns "
                        "only") from None
                df = self._order_widened(pre, final_items, orders)
        if self.kw("limit"):
            k, v = self.next()
            if k != "num":
                raise SparkException("SQL: LIMIT needs a number")
            df = df.limit(int(v))
        return df

    def _order_widened(self, pre, final_items, orders):
        from spark_rapids_tpu_torch.plan.nodes import expr_name
        src = pre.plan.schema.names
        lower = {n.lower() for n in src}
        add, names = [], []
        for j, it in enumerate(final_items):
            nm = expr_name(it, j)
            names.append(nm)
            if nm.lower() in lower:
                plain = isinstance(it, E.Col) and it.name.lower() == \
                    nm.lower()
                if not plain:
                    raise SparkException(
                        f"SQL: ORDER BY with alias {nm!r} shadowing a "
                        "source column is not supported")
            else:
                add.append(it if isinstance(it, E.Alias)
                           else E.Alias(it, nm))
        wide = pre.select(*[E.col(n) for n in src], *add)
        try:
            wide = wide.order_by(*orders)
        except KeyError as ke:
            raise SparkException(
                f"SQL: ORDER BY column not found: {ke}") from None
        return wide.select(*[E.col(n) for n in names])

    def _sort_item(self):
        from spark_rapids_tpu_torch.plan.nodes import SortOrder
        e = self.expr()
        asc = True
        if self.kw("desc"):
            asc = False
        else:
            self.kw("asc")
        nulls_first = asc
        if self.kw("nulls", "first"):
            nulls_first = True
        elif self.kw("nulls", "last"):
            nulls_first = False
        return SortOrder(e, ascending=asc, nulls_first=nulls_first)

    def parse(self):
        if self.kw("with"):
            while True:
                name = self.ident()
                if not self.kw("as"):
                    raise SparkException("SQL: WITH needs AS")
                self.expect_op("(")
                self.ctes[name.lower()] = self.select()
                self.expect_op(")")
                if not self.op(","):
                    break
        df = self.select()
        if self.peek()[0] != "eof":
            raise SparkException(
                f"SQL: trailing input at {self.peek()[1]!r}")
        return df


def parse_sql(text: str, session):
    return _Parser(text, session).parse()
