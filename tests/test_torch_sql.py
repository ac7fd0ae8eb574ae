"""The SQL front door of the port (``session.sql`` over temp views,
``sql/parser.py``) against the JAX package's, on the CPU.

Every query string of ``tests/test_sql_parser.py`` runs through both
packages' ``session.sql`` over the same views, one case per query, and
the answers are compared; each of its error cases raises the same
exception with the same message in both. Then: replacing a temp view,
the list of the JAX package's functions the port lacks (``functions.
NOT_PORTED``, held equal to the difference of the two modules' public
functions), a call of one of them raising naming ROADMAP A9, and the
datetime functions reaching the port. C29-C31 (ROADMAP queue C):
``ntile(n)`` and ``GROUP BY <expr>`` through SQL answer as Spark does
where the JAX package raises (both answers asserted), and an infix RLIKE
raises the JAX package's trailing-input message.

Tolerances: keys, counts and strings exact; float results relative 1e-12
(the JAX package plans a multi-partition aggregate over the tests' eight
virtual devices as partial -> exchange -> final, the port collects and
aggregates once, so float sums may add in another order).
"""
import inspect

import numpy as np
import pyarrow as pa
import pytest

from asserts import assert_tables_equal
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.expr.core import SparkException as JaxSparkException
from spark_rapids_tpu.sql import functions as JF

from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.sql import functions as TF

F64_TOL = 1e-12


def _views():
    """view world -> {view name: pyarrow table}: the tables of
    test_sql_parser.py's fixture and of its tests' own sessions."""
    rng = np.random.default_rng(11)
    main = {
        "t": pa.table({"k": rng.integers(0, 5, 300).tolist(),
                       "v": np.round(rng.uniform(0, 10, 300), 3).tolist(),
                       "name": [f"n{i % 17}" for i in range(300)]}),
        "d": pa.table({"k": [0, 1, 2, 3, 4],
                       "label": ["a", "b", "c", "d", "e"]}),
        "withnull": pa.table({"x": [1, None, 2]}),
        "left5": pa.table({"x": [1, 2, 2, 3, 4]}),
        "right3": pa.table({"x": [2, 3, 3, 5]}),
    }
    return {
        "main": main,
        "nulls": {"n": pa.table({"x": pa.array([1.0, None, 3.0],
                                               pa.float64())})},
        "order": {"n": pa.table({"x": pa.array([2.0, None, 1.0],
                                               pa.float64())})},
        "corr": {"tt": pa.table({"k": [0, 0, 1], "v": [9.5, 1.0, 1.0]}),
                 "dd": pa.table({"k": [0, 1]})},
        "probe": {"dn": pa.table({"k": [1, None]}),
                  "src": pa.table({"x": [200, 300]})},
    }


@pytest.fixture(scope="module")
def sessions():
    """world -> (port session, JAX session), the views registered."""
    out = {}
    for world, views in _views().items():
        pair = []
        for api in (torch_api(), jax_api()):
            s = api.session()
            for name, table in views.items():
                s.create_or_replace_temp_view(name, s.create_dataframe(table))
            pair.append(s)
        out[world] = tuple(pair)
    return out


#: (world, query) -> does the answer's row order count (ORDER BY)
QUERIES = {
    ("main", "SELECT k, SUM(v) AS sv, COUNT(*) AS n FROM t WHERE v > 2.0 "
             "GROUP BY k HAVING COUNT(*) > 10 ORDER BY sv DESC LIMIT 3"): True,
    ("main", "SELECT t.k, label, v * 2 + 1 AS x FROM t JOIN d ON t.k = d.k "
             "WHERE name LIKE 'n1%' AND v BETWEEN 1.0 AND 9.0 "
             "ORDER BY x ASC, label ASC LIMIT 20"): True,
    ("main", "SELECT DISTINCT CASE WHEN v >= 5.0 THEN 'hi' ELSE 'lo' END "
             "AS b FROM t ORDER BY b ASC"): True,
    ("main", "SELECT CAST(v AS bigint) AS iv FROM t "
             "ORDER BY iv DESC LIMIT 1"): True,
    ("main", "SELECT k FROM d WHERE k < 1 "
             "UNION ALL SELECT k FROM d WHERE k > 3"): False,
    ("main", "SELECT upper(name) AS u, substring(name, 1, 2) AS p FROM t "
             "WHERE k IN (1, 3) LIMIT 5"): True,
    ("main", "SELECT avg(v) AS m, min(k) AS lo FROM t"): False,
    ("main", "SELECT * FROM d ORDER BY k ASC"): True,
    ("main", "SELECT k FROM d LEFT SEMI JOIN t ON d.k = t.k "
             "ORDER BY k ASC"): True,
    ("main", "SELECT k FROM d LEFT ANTI JOIN t ON d.k = t.k"): False,
    ("nulls", "SELECT x FROM n WHERE x IS NULL"): False,
    ("nulls", "SELECT x FROM n WHERE x IS NOT NULL"): False,
    ("nulls", "SELECT x FROM n WHERE NOT x = 1.0"): False,
    ("nulls", "SELECT x FROM n WHERE x NOT IN (1.0)"): False,
    ("order", "SELECT x FROM n ORDER BY x ASC NULLS LAST"): True,
    ("order", "SELECT x FROM n ORDER BY x DESC NULLS FIRST"): True,
    ("main", "SELECT k FROM d WHERE k < 1 UNION ALL "
             "SELECT k FROM d WHERE k > 3 ORDER BY k DESC LIMIT 1"): True,
    ("main", "SELECT k FROM d UNION SELECT k FROM d"): False,
    ("main", "SELECT count(*) AS n FROM t "
             "HAVING count(*) > 1000000"): False,
    ("main", "SELECT v * 1e3 AS x FROM t ORDER BY x ASC LIMIT 1"): True,
    ("main", "SELECT substring(name, -2, 2) AS tail FROM t LIMIT 3"): True,
    ("main", "WITH agg AS (SELECT k, SUM(v) AS sv FROM t GROUP BY k), "
             "top AS (SELECT k FROM agg ORDER BY sv DESC LIMIT 2) "
             "SELECT count(*) AS n FROM t JOIN top ON t.k = top.k"): False,
    ("main", "SELECT k FROM (SELECT k, MAX(v) AS mx FROM t GROUP BY k) s "
             "WHERE mx > 9.0 ORDER BY k ASC"): True,
    ("main", "SELECT v AS val FROM t ORDER BY val ASC, k ASC LIMIT 5"): True,
    ("main", "SELECT k, label FROM d WHERE EXISTS "
             "(SELECT * FROM t WHERE t.k = d.k AND v > 9.0)"): False,
    ("main", "SELECT k FROM d WHERE NOT EXISTS "
             "(SELECT * FROM t WHERE t.k = d.k AND v > 9.0)"): False,
    ("main", "SELECT label FROM d WHERE k IN "
             "(SELECT k FROM t WHERE v > 9.5)"): False,
    ("main", "SELECT label FROM d WHERE k NOT IN "
             "(SELECT k FROM t WHERE v > 9.5)"): False,
    ("main", "SELECT k FROM d WHERE k NOT IN "
             "(SELECT x FROM withnull)"): False,
    ("main", "SELECT k FROM d WHERE k IN (SELECT x FROM withnull)"): False,
    ("main", "SELECT k FROM d WHERE k > (SELECT AVG(k) FROM t)"): False,
    ("main", "SELECT label FROM d WHERE k IN "
             "(SELECT k FROM t GROUP BY k HAVING COUNT(*) >= 55)"): False,
    ("main", "SELECT x FROM left5 INTERSECT SELECT x FROM right3"): False,
    ("main", "SELECT x FROM left5 EXCEPT SELECT x FROM right3"): False,
    ("main", "SELECT x FROM left5 MINUS SELECT x FROM right3"): False,
    ("main", "SELECT k, name, SUM(v) AS sv, COUNT(*) AS n, "
             "GROUPING(name) AS gn, GROUPING_ID() AS gid "
             "FROM t GROUP BY ROLLUP(k, name)"): False,
    ("main", "SELECT k, name, COUNT(*) AS n FROM t "
             "GROUP BY CUBE(k, name)"): False,
    ("main", "SELECT k, name, COUNT(*) AS n FROM t "
             "GROUP BY GROUPING SETS((k), (name))"): False,
    ("corr", "SELECT k FROM dd WHERE EXISTS "
             "(SELECT * FROM tt WHERE tt.k = dd.k AND v > 9.0)"): False,
    ("corr", "SELECT k FROM dd WHERE NOT EXISTS "
             "(SELECT * FROM tt WHERE tt.k = dd.k AND v > 9.0)"): False,
    ("probe", "SELECT k FROM dn WHERE k NOT IN "
              "(SELECT x FROM src WHERE x > 500)"): False,
    # the window grammar (OVER, PARTITION BY, ORDER BY, ROWS frames)
    ("main", "SELECT k, v, SUM(v) OVER (PARTITION BY k ORDER BY v "
             "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS w, "
             "row_number() OVER (PARTITION BY k ORDER BY v) AS rn "
             "FROM t"): False,
    # the math functions the front door routes by name
    ("main", "SELECT k, round(v, 1) AS r, floor(v) AS f, sqrt(v) AS s, "
             "pmod(k - 2, 3) AS p, bround(v, -1) AS b FROM t"): False,
}

#: test_sql_parser.py's error cases: (world, query, collect it too)
ERRORS = [
    ("main", "SELECT FROM t", True),
    ("main", "SELECT k FROM t WHERE", True),
    ("main", "SELECT k FROM nosuch", True),
    ("main", "SELECT k, SUM(v) FROM t", True),
    ("main", "SELECT nosuchfn(k) FROM t", True),
    ("main", "SELECT k FROM t ORDER BY k ASC extra", True),
    ("main", "SELECT k FROM t HAVING k > 1", True),
    ("main", "SELECT k FROM agg", True),
    ("main", "SELECT DISTINCT k FROM t ORDER BY v", True),
    ("main", "SELECT EXISTS(SELECT * FROM t) AS e FROM t", False),
    ("main", "SELECT k, COUNT(*) FROM t GROUP BY k "
             "HAVING EXISTS(SELECT * FROM t)", False),
    # C31: an infix RLIKE is trailing input, raised before the filter's
    # own type check could name another cause
    ("main", "SELECT COUNT(*) AS n FROM t WHERE name RLIKE '^n1'", True),
]

#: ERRORS' messages that are pinned, not only held equal to the JAX
#: package's
ERROR_MESSAGES = {
    "SELECT COUNT(*) AS n FROM t WHERE name RLIKE '^n1'":
        "SQL: trailing input at 'RLIKE'",
}


@pytest.mark.parametrize("case", list(QUERIES),
                         ids=[f"q{i}" for i in range(len(QUERIES))])
def test_sql_answers_like_jax(case, sessions):
    world, query = case
    port, ref = sessions[world]
    got, want = port.sql(query).collect(), ref.sql(query).collect()
    assert got.num_rows == want.num_rows
    assert_tables_equal(got, want, ignore_order=not QUERIES[case],
                        approx_float=F64_TOL)


def _raised(session, query, collect):
    try:
        df = session.sql(query)
        if collect:
            df.collect()
    except (SparkException, JaxSparkException, KeyError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ERRORS,
                         ids=[f"e{i}" for i in range(len(ERRORS))])
def test_sql_errors_like_jax(case, sessions):
    world, query, collect = case
    port, ref = sessions[world]
    got, want = _raised(port, query, collect), _raised(ref, query, collect)
    assert got is not None and got == want
    if query in ERROR_MESSAGES:
        assert got == ("SparkException", ERROR_MESSAGES[query])


def test_ntile_through_sql_c29(sessions):
    """C29: ``ntile(n)`` through SQL takes the integer literal's value, as
    Spark does; the JAX package passes the parsed literal to
    ``functions.ntile(n: int)`` and raises a TypeError."""
    port, ref = sessions["main"]
    for n, want in ((3, [1, 1, 2, 2, 3]), (1, [1, 1, 1, 1, 1])):
        q = (f"SELECT k, ntile({n}) OVER (ORDER BY k) AS nt FROM d "
             "ORDER BY k")
        assert port.sql(q).collect()["nt"].to_pylist() == want
        with pytest.raises(TypeError, match="Literal"):
            ref.sql(q).collect()


@pytest.mark.parametrize("query,want", [
    ("SELECT k + 1, COUNT(*) AS n FROM t GROUP BY k + 1",
     {"col0": [1, 2, 3, 4, 5]}),
    ("SELECT k % 2 AS m, COUNT(*) AS n FROM t GROUP BY k % 2 "
     "HAVING k % 2 >= 0", {"m": [0, 1]}),
    ("SELECT year(dt) AS y, COUNT(*) AS n FROM t GROUP BY year(dt)",
     {"y": [2020, 2021]}),
], ids=["k_plus_1", "g_mod_2_having", "year_of_dt"])
def test_group_by_an_expression_c30(query, want):
    """C30: ``GROUP BY <expr>`` groups by the expression and a SELECT item
    equal to it, with or without an alias, reads the aggregate's key
    column (Spark's answer); the JAX package evaluates the item again
    above the aggregate and raises a KeyError."""
    import datetime
    rng = np.random.default_rng(30)
    k = rng.integers(0, 5, 200)
    t = pa.table({"k": k.tolist(),
                  "dt": [datetime.date(2020 + int(i) % 2, 3, 1)
                         for i in range(200)]})
    (name, keys), = want.items()
    port = torch_api().session()
    port.create_or_replace_temp_view("t", port.create_dataframe(t))
    got = port.sql(query).collect()
    assert sorted(got[name].to_pylist()) == keys
    counts = dict(zip(got[name].to_pylist(), got["n"].to_pylist()))
    if "year" in query:
        expect = {2020: 100, 2021: 100}
    elif "%" in query:
        expect = {m: int(((k % 2) == m).sum()) for m in (0, 1)}
    else:
        expect = {v + 1: int((k == v).sum()) for v in range(5)}
    assert counts == expect
    ref = jax_api().session()
    ref.create_or_replace_temp_view("t", ref.create_dataframe(t))
    with pytest.raises(KeyError, match="not found"):
        ref.sql(query).collect()


def test_temp_view_replacement():
    for api in (torch_api(), jax_api()):
        s = api.session()
        s.create_or_replace_temp_view("r", s.create_dataframe({"a": [1, 2]}))
        assert s.sql("SELECT SUM(a) AS n FROM r").to_pydict() == {"n": [3]}
        s.createOrReplaceTempView("R", s.create_dataframe({"a": [5, 6, 7]}))
        assert s.sql("SELECT SUM(a) AS n FROM r").to_pydict() == {"n": [18]}
        assert s.table("r").count() == 3


def _public_functions(module):
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and inspect.isfunction(v)}


def test_not_ported_is_the_difference_of_the_functions_modules():
    # since the lambdas and JSON (ROADMAP A9d) every function is ported
    assert TF.NOT_PORTED == ()
    assert TF.NOT_PORTED == tuple(sorted(
        _public_functions(JF) - _public_functions(TF)))
    assert not _public_functions(TF) - _public_functions(JF)


@pytest.mark.parametrize("query", [
    # the ids are those of the cases' first names, initcap and crc32,
    # which the string slice ported (test_ported_string_functions_equal_jax)
    pytest.param("SELECT json_tuple(name, 'a') AS y FROM t",
                 id="SELECT initcap(name) AS y FROM t"),
    pytest.param("SELECT k FROM t WHERE "
                 "get_json_object(name, '$.a') IS NULL",
                 id="SELECT k FROM t WHERE crc32(name) > 0")])
def test_jax_only_function_raises_naming_a9(query, sessions):
    # the JSON functions of ROADMAP A9d reach the port by name now, and
    # answer as the JAX package does
    port, ref = sessions["main"]
    want = ref.sql(query).collect()
    assert want.num_rows > 0
    assert_tables_equal(port.sql(query).collect(), want)
    # a name neither package has keeps the JAX package's message
    with pytest.raises(SparkException, match="unknown function 'nosuchfn'"):
        port.sql("SELECT nosuchfn(k) FROM t")


@pytest.mark.parametrize("query", [
    "SELECT initcap(name) AS y FROM t",
    "SELECT k FROM t WHERE crc32(name) > 0"])
def test_ported_string_functions_equal_jax(query, sessions):
    port, ref = sessions["main"]
    got, want = port.sql(query).collect(), ref.sql(query).collect()
    assert got.num_rows > 0
    assert_tables_equal(got, want)


@pytest.mark.parametrize("query", [
    "SELECT year(k) AS y FROM t",
    "SELECT k, quarter(k) AS q, date_add(k, 40) AS d, "
    "weekofyear(k) AS w FROM t WHERE dayofmonth(k) > 2",
    "SELECT year(CAST('1995-03-15' AS date)) AS y, "
    "month(CAST('1995-03-15' AS date)) AS m FROM d"])
def test_datetime_names_reach_the_port_like_jax(query, sessions):
    """The datetime functions left NOT_PORTED: session.sql resolves them
    through sql/functions.py, as in the JAX package."""
    port, ref = sessions["main"]
    assert_tables_equal(port.sql(query).collect(), ref.sql(query).collect())


# ---------------------------------------------------------------------------
# ROADMAP C23: column resolution under spark.sql.caseSensitive
# ---------------------------------------------------------------------------

def _case_frames(api, conf, table):
    s = api.session(conf)
    df = s.create_dataframe(table)
    s.create_or_replace_temp_view("ct", df)
    return s, df


@pytest.mark.parametrize("form", ["dataframe", "sql"])
def test_case_sensitive_resolution_c23(form):
    """With spark.sql.caseSensitive=true only the exact name resolves, in
    both packages; at the default (false) any case resolves."""
    t = pa.table({"Abc": [1, 2, 3]})
    for api in (torch_api(), jax_api()):
        for conf, ok in (({"spark.sql.caseSensitive": "true"}, False),
                         (None, True)):
            s, df = _case_frames(api, conf, t)

            def run(name):
                if form == "sql":
                    return s.sql(f"select {name} from ct").collect()
                return df.select(api.col(name)).collect()
            assert run("Abc")["Abc"].to_pylist() == [1, 2, 3]
            if ok:
                assert run("ABC").column(0).to_pylist() == [1, 2, 3]
            else:
                with pytest.raises(KeyError, match="not found"):
                    run("ABC")


@pytest.mark.parametrize("form", ["dataframe", "sql"])
def test_names_that_differ_in_case_are_ambiguous_c23(form):
    """Over columns ``Abc`` and ``abc`` at the default, Spark raises
    AMBIGUOUS_REFERENCE; so does the port. The JAX package answers the
    first match, ``Abc``'s values (a fault of the reference). Case-sensitive, each
    name resolves to its own column in both."""
    t = pa.table({"Abc": [1, 2], "abc": [10, 20]})

    def run(api, conf):
        s, df = _case_frames(api, conf, t)
        if form == "sql":
            return s.sql("select abc from ct").collect()
        return df.select(api.col("abc")).collect()
    with pytest.raises(SparkException, match="AMBIGUOUS_REFERENCE"):
        run(torch_api(), None)
    jax = run(jax_api(), None)
    assert jax.column(0).to_pylist() == [1, 2]
    cs = {"spark.sql.caseSensitive": "true"}
    for api in (torch_api(), jax_api()):
        assert run(api, cs)["abc"].to_pylist() == [10, 20]
