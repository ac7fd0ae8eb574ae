"""The port's plan tagging, CPU backend and per-operator CPU fallback
against the JAX package, on the CPU.

- Every tag the two packages share: the same program through the JAX
  package's collect and the port's CPU session gives equal tables; both
  tag the same plan node with the same reasons, and the ``!`` and ``@``
  lines of the two placement reports are equal once TPU reads GPU.
- LIKE patterns that need the NFA, and casts to and from strings, run on
  the device in both packages, with equal answers.
- ``collect_cpu`` over the smoke's query shapes at a few thousand rows.
- Test mode, ``explainOnly``, the fallback phase's two queries, and the
  device a fallback uploads to.

Tolerances: exact. Both CPU backends run the same numpy arithmetic over
the same rows, and every fallback here reads device results that the
existing tests hold exactly, but fb_moving_min, whose device f64 sums
feed the CPU window: relative 1e-12, the sum routes' tolerance in
``tests/test_torch_aggregates.py``.
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest

import torch_port_helpers as H
from asserts import assert_tables_equal
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.plan import overrides as JO

from spark_rapids_tpu_torch.columnar import batch as B
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.plan import overrides as PO

F64_TOL = 1e-12
WORDS = np.array(["apple", "Banana", "cherry", "date", "élan", "fig",
                  "grape"])


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(9)
    n = 400
    return pa.table({
        "k": pa.array(rng.integers(0, 5, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "s": pa.array(WORDS[rng.integers(0, 7, n)],
                      mask=rng.random(n) < 0.1),
        # no nulls: the JAX package's CPU cannot order a null string
        "t": WORDS[rng.integers(0, 7, n)],
        "u": WORDS[rng.integers(0, 7, n)],
        "o": rng.integers(0, 50, n).astype(np.int32),
        "x": pa.array(np.round(rng.normal(0, 10, n), 2),
                      mask=rng.random(n) < 0.05),
        "i": pa.array(rng.integers(-100, 100, n).astype(np.int64),
                      mask=rng.random(n) < 0.05),
    })


def _dim(api, session):
    return session.create_dataframe(pa.table({
        "t": WORDS, "label": [f"w{j}" for j in range(len(WORDS))]}))


def _window(fn):
    def build(api, df):
        w = api.Window.partition_by(api.col("k"))
        return df.select(api.col("k"), api.col("o"), api.col("x"),
                         fn(api, w).alias("v"))
    return build


def _agg(fn):
    def build(api, df):
        return df.group_by("k").agg(fn(api).alias("v"),
                                    api.F.count().alias("n"))
    return build


def _compare(op):
    def build(api, df):
        c = api.col
        return df.select(c("t"), c("u"), op(c("t"), c("u")).alias("v"))
    return build


#: case -> (program, plan node tagged to the CPU, a reason's words, conf,
#: partitions, compare in order)
SHARED = {
    "window_string_order": (_window(lambda a, w: a.F.rank().over(
        w.order_by(a.col("t")))), "WindowNode",
        "window ORDER BY on strings needs host sort", None, 1, False),
    "window_string_operand": (_window(lambda a, w: a.F.lag(a.col("s")).over(
        w.order_by(a.col("o"), a.col("t")))), "WindowNode",
        "string-typed window operands run on CPU", None, 1, False),
    "window_bounded_min": (_window(lambda a, w: a.F.min(a.col("x")).over(
        w.order_by(a.col("o")).rows_between(-1, 1))), "WindowNode",
        "bounded-rows min/max window not yet on device", None, 1, False),
    "window_other_aggregate": (_window(lambda a, w: a.F.variance(
        a.col("x")).over(w.order_by(a.col("o")))), "WindowNode",
        "VarianceSamp not supported in window frames on device", None, 1,
        False),
    "window_nth_value_frame": (_window(lambda a, w: a.F.nth_value(
        a.col("x"), 2).over(w.order_by(a.col("o")).rows_between(-1, 0))),
        "WindowNode", "NthValue supports only unbounded-preceding frames",
        None, 1, False),
    "min_string": (_agg(lambda a: a.F.min(a.col("s"))), "Aggregate",
                   "Min over strings not supported on device", None, 1,
                   False),
    "max_string": (_agg(lambda a: a.F.max(a.col("s"))), "Aggregate",
                   "Max over strings not supported on device", None, 1,
                   False),
    "first_string": (_agg(lambda a: a.F.first(a.col("s"))), "Aggregate",
                     "First over strings not supported on device", None, 1,
                     False),
    "last_string": (_agg(lambda a: a.F.last(a.col("s"))), "Aggregate",
                    "Last over strings not supported on device", None, 1,
                    False),
    "min_by_string": (_agg(lambda a: a.F.min_by(a.col("i"), a.col("t"))),
                      "Aggregate", "min_by ordered by a string column", None,
                      1, False),
    "max_by_string": (_agg(lambda a: a.F.max_by(a.col("x"), a.col("s"))),
                      "Aggregate", "max_by ordered by a string column", None,
                      1, False),
    "string_lt": (_compare(lambda l, r: l < r), "Project",
                  "string ordering comparison not supported on device",
                  None, 1, True),
    "string_le": (_compare(lambda l, r: l <= r), "Project",
                  "string ordering comparison not supported on device",
                  None, 1, True),
    "string_gt": (_compare(lambda l, r: l > r), "Project",
                  "string ordering comparison not supported on device",
                  None, 1, True),
    "string_ge": (_compare(lambda l, r: l >= r), "Project",
                  "string ordering comparison not supported on device",
                  None, 1, True),
    "partition_ids_in_aggregate": (lambda a, df: df.group_by("k").agg(
        a.F.sum(a.F.monotonically_increasing_id()).alias("mid"),
        a.F.max(a.F.spark_partition_id()).alias("pid")), "Aggregate",
        "only evaluates in projection context", None, 3, False),
    "float_sum_improved_off": (_agg(lambda a: a.F.sum(a.col("x"))),
                               "Aggregate", "float Sum accumulates in a "
                               "different order than CPU Spark",
                               {"spark.rapids.sql.improvedFloatOps.enabled":
                                "false"}, 1, False),
    "string_join_incompat_off": (lambda a, df: df.join(
        _dim(a, df.session), on="t").select(a.col("t"), a.col("o"),
                                            a.col("label")), "Join",
        "string join keys compare by 64-bit double-hash",
        {"spark.rapids.sql.incompatibleOps.enabled": "false"}, 1, False),
    "exec_sort_off": (lambda a, df: df.order_by(a.col("o"), a.col("t"),
                                                a.col("i")), "Sort",
                      "Sort disabled by spark.rapids.sql.exec.Sort",
                      {"spark.rapids.sql.exec.Sort": "false"}, 1, True),
    "expression_substring_off": (lambda a, df: df.select(a.F.substring(
        a.col("s"), 2, 3).alias("v")), "Project",
        "expression Substring disabled by "
        "spark.rapids.sql.expression.Substring",
        {"spark.rapids.sql.expression.Substring": "false"}, 1, True),
    "sql_disabled": (lambda a, df: df.filter(a.col("o") > a.lit(10))
                     .group_by("k").agg(a.F.sum(a.col("i")).alias("v")),
                     "Aggregate", "spark.rapids.sql.enabled is false",
                     {"spark.rapids.sql.enabled": "false"}, 1, False),
}


def _placement(report: str, tpu_reads_gpu: bool):
    """The report's ``!`` and ``@`` lines."""
    if tpu_reads_gpu:
        report = report.replace("TPU", "GPU")
    return [ln for ln in report.splitlines()
            if ln.lstrip().startswith(("!", "@"))]


def _cpu_nodes(meta):
    out, stack = [], [meta]
    while stack:
        m = stack.pop()
        if m.reasons:
            out.append((type(m.plan).__name__, list(m.reasons)))
        stack.extend(m.children)
    return out


def _run_both(build, table, conf=None, parts=1):
    """((port table, port meta), (JAX table, JAX meta)) of one program."""
    out = []
    for api, overrides in ((torch_api(), PO), (jax_api(), JO)):
        s = api.session(conf)
        df = build(api, s.create_dataframe(table, num_partitions=parts))
        meta = overrides.wrap_and_tag(df.plan, s.conf)
        out.append((df.collect(), meta))
    return out


@pytest.mark.parametrize("case", list(SHARED))
def test_shared_tags_fall_back_like_jax(case, table):
    build, node, words, conf, parts, ordered = SHARED[case]
    (got, meta), (want, jmeta) = _run_both(build, table, conf, parts)
    assert_tables_equal(got, want, ignore_order=not ordered)
    port_nodes = _cpu_nodes(meta)
    jax_nodes = [(n, [r.replace("TPU", "GPU") for r in rs])
                 for n, rs in _cpu_nodes(jmeta)]
    assert port_nodes == jax_nodes
    assert any(n == node and any(words in r for r in rs)
               for n, rs in port_nodes), port_nodes
    assert _placement(meta.explain(all_ops=True), False) \
        == _placement(jmeta.explain(all_ops=True), True)


#: LIKE patterns that need the NFA: the port's tags sent them to the CPU
#: until the device NFA was ported; now both packages run them on the
#: device
PORT_ONLY = {
    "like_underscore": lambda a: a.F.like(a.col("s"), "_a%"),
    "like_inner_wildcard": lambda a: a.F.like(a.col("s"), "%an_"),
}

#: casts to and from strings: on the device in both packages
DEVICE_CASTS = {
    "cast_int_to_string": lambda a: a.col("i").cast(a.T.STRING),
    "cast_string_to_int": lambda a: a.col("ns").cast(a.T.INT32),
    "cast_bool_to_string": lambda a: (a.col("o") > a.lit(20))
    .cast(a.T.STRING),
}


def _with_number_strings(table):
    return table.append_column("ns", pa.array(
        [None if j % 11 == 0 else (f" {j - 200} " if j % 3 else f"x{j}")
         for j in range(table.num_rows)]))


@pytest.mark.parametrize("case", list(PORT_ONLY))
def test_port_only_tags_equal_the_jax_device_answer(case, table):
    (got, meta), (want, jmeta) = _run_both(
        lambda a, df: df.select(a.col("k"), PORT_ONLY[case](a).alias("v")),
        _with_number_strings(table))
    assert_tables_equal(got, want)
    assert not _cpu_nodes(jmeta) and not _cpu_nodes(meta)


@pytest.mark.parametrize("case", list(DEVICE_CASTS))
def test_string_casts_run_on_the_device_like_jax(case, table):
    (got, meta), (want, jmeta) = _run_both(
        lambda a, df: df.select(a.col("k"),
                                DEVICE_CASTS[case](a).alias("v")),
        _with_number_strings(table))
    assert_tables_equal(got, want)
    assert not _cpu_nodes(jmeta) and not _cpu_nodes(meta)


# ---------------------------------------------------------------------------
# collect_cpu over the smoke's shapes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    lineitem, orders = H.make_tables(4000)
    return {"li": lineitem, "od": orders, "text": H.lineitem_text(lineitem),
            "bands": H.make_bands()}


def _frames(api, s, tables):
    return {"li": s.create_dataframe(tables["li"]),
            "li3": s.create_dataframe(tables["li"], num_partitions=3),
            "od": s.create_dataframe(tables["od"]),
            "text": s.create_dataframe(tables["text"]),
            "bands": s.create_dataframe(tables["bands"])}


SHAPES = {
    "q6": lambda a, f: H.q6(a, f["li"]),
    "q1": lambda a, f: H.q1(a, f["li"]),
    "q72shfl": lambda a, f: H.q72shfl(a, f["li"]),
    "repart_agg": lambda a, f: H.repart_agg(a, f["li"]),
    "str_case_agg": lambda a, f: H.str_case_agg(a, f["text"]),
    "q3join": lambda a, f: H.q3join(a, f["li"], f["od"]),
    "q4_semi_anti": lambda a, f: H.q4_semi_anti(a, f["li"], f["od"]),
    "band_join": lambda a, f: H.band_join(a, f["li"], f["bands"]),
    "q67win": lambda a, f: H.q67win(a, f["li"]),
    "win_running": lambda a, f: H.win_running(a, f["li"]),
    "q14_case": lambda a, f: H.q14_case(a, f["li"]),
    "q1_stats": lambda a, f: H.q1_stats(a, f["li"]),
    "q1_rollup": lambda a, f: H.q1_rollup(a, f["li"]),
    "union_repart": lambda a, f: H.union_repart(a, f["li3"], f["li"]),
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_collect_cpu_matches_jax_exactly(shape, tables):
    out = []
    for api in (torch_api(), jax_api()):
        out.append(SHAPES[shape](api, _frames(api, api.session(), tables))
                   .collect_cpu())
    assert out[0].num_rows > 0
    assert_tables_equal(out[0], out[1], ignore_order=True)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_smoke_shapes_stay_on_the_device_in_test_mode(shape, tables):
    # chip_smoke.py runs every earlier path in test mode: none of their
    # operators may be tagged to the CPU
    api = torch_api()
    s = api.session({"spark.rapids.sql.test.enabled": "true"})
    df = SHAPES[shape](api, _frames(api, s, tables))
    assert not _cpu_nodes(PO.wrap_and_tag(df.plan, s.conf))


# ---------------------------------------------------------------------------
# test mode, explainOnly, explain and the upload
# ---------------------------------------------------------------------------

def _min_s(api, df):
    return df.group_by("k").agg(api.F.min(api.col("s")).alias("m"))


def test_test_mode_raises_on_a_fallback_it_does_not_allow(table):
    api = torch_api()
    strict = api.session({"spark.rapids.sql.test.enabled": "true"})
    with pytest.raises(AssertionError,
                       match="Aggregate fell back to CPU in test mode"):
        _min_s(api, strict.create_dataframe(table)).collect()
    other = api.session({"spark.rapids.sql.test.enabled": "true",
                         "spark.rapids.sql.test.allowedNonTpu": "Sort"})
    with pytest.raises(AssertionError, match="Aggregate"):
        _min_s(api, other.create_dataframe(table)).collect()
    allowed = api.session({"spark.rapids.sql.test.enabled": "true",
                           "spark.rapids.sql.test.allowedNonTpu":
                           "Sort, Aggregate"})
    got = _min_s(api, allowed.create_dataframe(table)).collect()
    want = _min_s(api, api.session().create_dataframe(table)).collect()
    assert_tables_equal(got, want)


def test_explain_only_answers_like_collect(table):
    def build(api, df):
        c = api.col
        return df.filter(c("o") > api.lit(5)).group_by("k").agg(
            api.F.min(c("s")).alias("m"), api.F.sum(c("i")).alias("si"),
            api.F.avg(c("x")).alias("ax"))
    api = torch_api()
    s = api.session({"spark.rapids.sql.mode": "explainOnly"})
    got = build(api, s.create_dataframe(table)).collect()
    assert s.last_exec is None and not s.last_meta.can_run_on_tpu
    want = build(api, api.session().create_dataframe(table)).collect()
    assert_tables_equal(got, want, ignore_order=True)


def test_explain_names_the_operator_and_its_reason(table, capsys):
    api = torch_api()
    df = _min_s(api, api.session().create_dataframe(table))
    report = df.explain()
    assert capsys.readouterr().out.strip() == report
    assert report.splitlines() == [
        "! Aggregate[keys=[k], aggs=[m]]",
        "    @ cannot run on GPU because: Aggregate: Min over strings not "
        "supported on device",
        "    @ cannot run on GPU because: Aggregate: Min input string is not "
        "supported",
        "  * InMemorySource[400 rows, 1 parts]"]
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        df.explain("stages")


def test_fallback_uploads_to_the_session_device(table):
    api = torch_api()
    s = api.session()
    df = _min_s(api, s.create_dataframe(table))
    df.collect()
    [fb] = [e for e in s.last_exec.walk()
            if isinstance(e, X.CpuFallbackExec)]
    [batch] = list(fb.execute_partition(0))
    assert all(c.device == s.device for c in batch.columns)
    assert fb.transfers["output_device"] == str(s.device)
    assert fb.transfers["rows_in"] == 2 * table.num_rows  # two runs
    with pytest.raises(TypeError):
        B.from_arrow(table)  # no device: the upload would guess


def test_adjacent_fallbacks_stay_on_the_host(table):
    api = torch_api()
    s = api.session({"spark.rapids.sql.enabled": "false"})
    df = SHARED["sql_disabled"][0](api, s.create_dataframe(table))
    df.collect()
    ops = list(s.last_exec.walk())
    assert all(isinstance(e, X.CpuFallbackExec) for e in ops)
    assert all(e.transfers["download_ms"] == 0.0 for e in ops)


# ---------------------------------------------------------------------------
# the fallback phase's queries, small
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("query", list(H.FALLBACK_NODES))
def test_fallback_phase_query_matches_jax(query, tables):
    node = H.FALLBACK_NODES[query]
    out = []
    for api, overrides in ((torch_api(), PO), (jax_api(), JO)):
        s = api.session({"spark.rapids.sql.test.enabled": "true",
                         "spark.rapids.sql.test.allowedNonTpu": node})
        src = tables["text"] if query == "fb_strmax" else tables["li"]
        df = getattr(H, query)(api, s.create_dataframe(src).cache())
        out.append(df.collect())
        cpu = _cpu_nodes(overrides.wrap_and_tag(df.plan, s.conf))
        assert [n for n, _ in cpu] == [node]
        if overrides is PO and query == "fb_strmax":
            # the filter below the CPU aggregate stays a device filter
            [fb] = [e for e in s.last_exec.walk()
                    if isinstance(e, X.CpuFallbackExec)]
            assert "FilterExec" in {type(e).__name__ for e in fb.walk()}
    got, want = out
    if query == "fb_strmax":
        assert_tables_equal(got, want, ignore_order=True)
    else:
        assert_tables_equal(got.select(["l_shipdate"]),
                            want.select(["l_shipdate"]), ignore_order=True)
        assert_tables_equal(got, want, ignore_order=True,
                            approx_float=F64_TOL)
    assert got.num_rows == (6 if query == "fb_strmax" else len(
        set(tables["li"]["l_shipdate"].to_pylist())))
