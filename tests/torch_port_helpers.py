"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The table generators (bench.py's lineitem and orders, the customers, the
flag dimension, the price bands, lineitem_text) and the query shapes of
the port's slices (bench.py's shapes, the strings, joins and sorts,
windows, expressions and aggregates, sets and grouping sets, the
aggregate types: decimals and collected arrays, and the datetime shapes
over ``lineitem_dt``) are written once against a package namespace, so
the same program runs through ``spark_rapids_tpu`` (the reference) and
``spark_rapids_tpu_torch``; ``chip_smoke.py`` runs the same generators
and shapes on the card. At import this module needs numpy and pyarrow only.
``from_jax_batch`` rebuilds a JAX package batch as a torch batch, so single
operations can be compared on identical inputs.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pyarrow as pa

LO, HI = 8766, 9131  # [1994-01-01, 1995-01-01) in days since epoch


def _draw_lineitem(rng, rows: int) -> pa.Table:
    orders = max(rows // 10, 1000)
    flags = np.array(["A", "N", "R"])[rng.integers(0, 3, rows)]
    status = np.array(["F", "O"])[rng.integers(0, 2, rows)]
    return pa.table({
        "l_orderkey": rng.integers(0, orders, rows).astype(np.int64),
        "l_returnflag": flags,
        "l_linestatus": status,
        "l_quantity": rng.integers(1, 51, rows).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900.0, 105000.0, rows), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.10, rows), 2),
        "l_shipdate": rng.integers(8400, 10600, rows).astype(np.int32),
    })


def make_lineitem(rows: int, seed: int = 42) -> pa.Table:
    """bench.py's lineitem columns at `rows` rows, from a numpy seed."""
    return _draw_lineitem(np.random.default_rng(seed), rows)


def make_tables(rows: int, seed: int = 42):
    """bench.py's make_tables: ``make_lineitem(rows, seed)``, then orders
    (rows // 10 of them, at least 1000) from the same rng stream."""
    rng = np.random.default_rng(seed)
    lineitem = _draw_lineitem(rng, rows)
    n = max(rows // 10, 1000)
    orders = pa.table({
        "o_orderkey": np.arange(n, dtype=np.int64),
        "o_orderdate": rng.integers(8400, 10600, n).astype(np.int32),
        "o_custkey": rng.integers(0, max(n // 10, 10), n).astype(np.int64),
    })
    return lineitem, orders


def make_customers(orders: pa.Table) -> pa.Table:
    """One row per customer key the orders draw from (0 .. n/10 - 1)."""
    n = max(orders.num_rows // 10, 10)
    return pa.table({"c_custkey": np.arange(n, dtype=np.int64)})


#: the flag dimension: a label per (l_returnflag, l_linestatus) pair
FLAG_LABELS = {("A", "F"): "accepted/filled", ("A", "O"): "accepted/open",
               ("N", "F"): "none/filled", ("N", "O"): "none/open",
               ("R", "F"): "returned/filled", ("R", "O"): "returned/open"}


def make_flag_dim() -> pa.Table:
    keys = sorted(FLAG_LABELS)
    return pa.table({"d_returnflag": [k[0] for k in keys],
                     "d_linestatus": [k[1] for k in keys],
                     "d_label": [FLAG_LABELS[k] for k in keys]})


#: the TPC-H text grammar's word lists (specification clause 4.2.2.10):
#: nouns, verbs, adjectives, adverbs, prepositions and auxiliaries; the
#: entries of lowercase letters, phrases split into their words
TPCH_WORDS = (
    "foxes ideas theodolites pinto beans instructions dependencies excuses "
    "platelets asymptotes courts dolphins multipliers sauternes warthogs "
    "frets dinos attainments somas patterns forges braids hockey players "
    "frays warhorses dugouts notornis epitaphs pearls tithes waters orbits "
    "gifts sheaves depths sentiments decoys realms pains grouches escapades "
    "sleep wake are cajole haggle nag use boost affix detect integrate "
    "maintain nod was lose sublate solve thrash promise engage hinder print "
    "breach eat grow impress mold poach serve run dazzle snooze doze unwind "
    "kindle play hang believe doubt furious sly careful blithe quick fluffy "
    "slow quiet ruthless thin close dogged daring brave stealthy permanent "
    "enticing idle busy regular final ironic even bold silent furiously "
    "carefully blithely quickly fluffily slowly quietly ruthlessly thinly "
    "closely doggedly daringly bravely stealthily permanently enticingly "
    "idly busily regularly finally ironically evenly boldly silently about "
    "above according to across after against along alongside of among "
    "around at atop before behind beneath beside besides between beyond by "
    "despite during except for from in place of inside instead of into "
    "near of on outside over past since through throughout to toward under "
    "until up upon without with within do may might shall will would can "
    "could should ought to must will have to shall have to could have to "
    "should have to must have to need to try to").split()


def text_pool(nbytes: int, rng) -> np.ndarray:
    """A text pool of ``nbytes``: uint8 bytes of grammar words drawn
    uniformly at random, in random order, separated by single spaces (no
    sentence structure and no punctuation, unlike dbgen's pool)."""
    words = [w.encode() for w in TPCH_WORDS]
    lens = np.array([len(w) + 1 for w in words])
    nwords = int(nbytes // lens.mean()) + 64
    ids = rng.integers(0, len(words), nwords)
    blob = np.frombuffer(b"".join(w + b" " for w in words), np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    sel_lens = lens[ids]
    off = np.concatenate([[0], np.cumsum(sel_lens)[:-1]])
    src = np.repeat(starts[ids] - off, sel_lens) + np.arange(sel_lens.sum())
    return blob[src][:nbytes]


def make_comments(rows: int, rng, lo: int = 10, hi: int = 43,
                  pool_bytes: int = 1 << 24):
    """A comment column: per row a substring of a 16 MB pool of TPC-H
    grammar words (``text_pool``) of a length drawn from [lo, hi], at an
    offset drawn uniformly, built from numpy planes (no Python string per
    row) and wrapped as an Arrow large_string array."""
    pool = text_pool(pool_bytes, rng)
    lens = rng.integers(lo, hi + 1, rows)
    starts = rng.integers(0, len(pool) - hi, rows)
    win = np.lib.stride_tricks.sliding_window_view(pool, hi)[starts]
    data = win[np.arange(hi)[None, :] < lens[:, None]]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return pa.LargeStringArray.from_buffers(rows, pa.py_buffer(offsets),
                                            pa.py_buffer(data))


def lineitem_text(lineitem: pa.Table, seed: int = 43) -> pa.Table:
    """A lineitem's l_orderkey, l_returnflag, l_linestatus and l_quantity,
    plus l_comment: 10-43 characters of TPC-H grammar words per row,
    nearly all distinct, so it uploads as a flat column."""
    return lineitem.select(["l_orderkey", "l_returnflag", "l_linestatus",
                            "l_quantity"]).append_column(
        "l_comment", make_comments(lineitem.num_rows,
                                   np.random.default_rng(seed)))


def make_lineitem_text(rows: int, seed: int = 42) -> pa.Table:
    """``lineitem_text`` of ``make_lineitem(rows, seed)``."""
    return lineitem_text(make_lineitem(rows, seed), seed + 1)


#: the price bands: BAND_COUNT half-open [lo, hi) ranges over
#: l_extendedprice's [900, 105000)
BAND_COUNT, BAND_LO, BAND_HI = 20, 900.0, 105000.0


def make_bands() -> pa.Table:
    width = (BAND_HI - BAND_LO) / BAND_COUNT
    lo = BAND_LO + width * np.arange(BAND_COUNT)
    return pa.table({"band": np.arange(BAND_COUNT, dtype=np.int32),
                     "lo": lo, "hi": lo + width})


#: the host-int fields of an adaptive decision both packages must agree on
AQE_FIELDS = ("kind", "build_rows", "n_out", "partition", "rows", "median",
              "threshold_rows", "splits", "source")


def aqe_decisions(doc) -> list:
    """An ``last_aqe()`` doc's decisions, cut to their host-int fields."""
    return [{k: d[k] for k in AQE_FIELDS if k in d}
            for d in (doc or {}).get("decisions", [])]


def chosen_execs(root) -> list:
    """Every exec under root, either package's, following an adaptive
    node into the operator it chose and then into its children, each
    once (tests/test_adaptive.py's walk)."""
    out, seen = [], set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        out.append(n)
        chosen = getattr(n, "_chosen", None)
        if chosen is not None:
            walk(chosen)
        for c in getattr(n, "children", []):
            walk(c)

    walk(root)
    return out


def placement(overrides, df, conf) -> list:
    """(plan node, reasons) of every node a package's tagging keeps off
    the device, top down, with the JAX package's TPU named GPU."""
    def walk(meta):
        yield meta
        for c in meta.children:
            yield from walk(c)
    return [(type(m.plan).__name__,
             [r.replace("TPU", "GPU") for r in m.reasons])
            for m in walk(overrides.wrap_and_tag(df.plan, conf))
            if m.reasons]


def jax_api() -> SimpleNamespace:
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.expr import core as E
    from spark_rapids_tpu.expr.window import Window
    from spark_rapids_tpu.sql import functions as F
    from spark_rapids_tpu.sql import udf as U
    from spark_rapids_tpu.sql.session import TpuSession
    return SimpleNamespace(col=E.col, lit=E.lit, F=F, E=E, T=T,
                           Window=Window, udf=U.udf, col_udf=U.jax_udf,
                           session=lambda conf=None: TpuSession(conf))


def torch_api() -> SimpleNamespace:
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.expr.window import Window
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql import udf as U
    return SimpleNamespace(col=E.col, lit=E.lit, F=F, E=E, T=T,
                           Window=Window, udf=U.udf, col_udf=U.torch_udf,
                           session=lambda conf=None: TorchSession(
                               conf, device="cpu"))


def q6(api, df):
    col, lit, F = api.col, api.lit, api.F
    cond = ((col("l_shipdate") >= lit(LO)) & (col("l_shipdate") < lit(HI))
            & (col("l_discount") >= lit(0.05))
            & (col("l_discount") <= lit(0.07))
            & (col("l_quantity") < lit(24.0)))
    return df.filter(cond).agg(
        F.sum(col("l_extendedprice") * col("l_discount")).alias("revenue"))


def q1(api, df):
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(col("l_shipdate") <= lit(10471))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum(col("l_quantity")).alias("sq"),
                 F.sum(col("l_extendedprice")).alias("sp"),
                 F.avg(col("l_quantity")).alias("mq"),
                 F.avg(col("l_discount")).alias("md"),
                 F.count(col("l_quantity")).alias("cnt"),
                 F.min(col("l_discount")).alias("mind"),
                 F.max(col("l_shipdate")).alias("maxs")))


def q72shfl(api, df, value="l_quantity"):
    """The grouped half of bench.py's q72shfl (the final reduction is
    compared on the host)."""
    col, lit, F = api.col, api.lit, api.F
    return (df.select((col("l_orderkey") % lit(100_000)).alias("k"),
                      col(value))
            .group_by(col("k"))
            .agg(F.sum(value).alias("s"), F.count(value).alias("c")))


def repart_agg(api, df, value="l_quantity", n=8):
    col, F = api.col, api.F
    return (df.select(col("l_shipdate"), col(value))
            .repartition(n, col("l_shipdate"))
            .group_by(col("l_shipdate"))
            .agg(F.sum(value).alias("s"), F.count(value).alias("c")))


def q72shfl_repart(api, df, value="l_quantity", n=8):
    """q72shfl's grouping behind an explicit hash exchange of its key
    (bench.py's q72shfl runs one on several devices; on one device both
    packages would collect instead). The key is cast to int, so the
    exchange hashes an int32 plane (the murmur3 kernel)."""
    col, lit, F, T = api.col, api.lit, api.F, api.T
    k = (col("l_orderkey") % lit(100_000)).cast(T.INT32).alias("k")
    return (df.select(k, col(value))
            .repartition(n, col("k"))
            .group_by(col("k"))
            .agg(F.sum(value).alias("s"), F.count(value).alias("c")))


def orders_upserts(orders: pa.Table, rows: int, seed: int = 53) -> pa.Table:
    """``rows`` order upserts: half update existing orders (a new date and
    customer), half insert orders past the last key."""
    rng = np.random.default_rng(seed)
    n = orders.num_rows
    old = rng.choice(n, rows // 2, replace=False).astype(np.int64)
    new = np.arange(n, n + rows - rows // 2, dtype=np.int64)
    keys = np.concatenate([old, new])
    return pa.table({
        "o_orderkey": keys,
        "o_orderdate": rng.integers(8400, 10600, rows).astype(np.int32),
        "o_custkey": rng.integers(0, max(n // 10, 10), rows)
        .astype(np.int64)})


def upsert_reference(orders: pa.Table, ups: pa.Table):
    """numpy's upsert of orders_upserts into the orders (keys 0..n-1):
    (keys, dates, customers) in key order."""
    n = orders.num_rows
    k = ups["o_orderkey"].to_numpy()
    total = max(n, int(k.max()) + 1)
    date = np.zeros(total, np.int32)
    cust = np.zeros(total, np.int64)
    date[:n] = orders["o_orderdate"].to_numpy()
    cust[:n] = orders["o_custkey"].to_numpy()
    date[k] = ups["o_orderdate"].to_numpy()
    cust[k] = ups["o_custkey"].to_numpy()
    return np.arange(total, dtype=np.int64), date, cust


#: the fallback phase's queries, and the plan node each leaves on the CPU
FALLBACK_NODES = {"fb_strmax": "Aggregate", "fb_moving_min": "WindowNode"}


def fb_strmax(api, df):
    """Per flag pair, the least and greatest upper-cased comment of the
    lines of quantity 1 and their count: the filter runs on the device,
    the aggregate on the CPU (min/max over strings is tagged off the
    device), with upper() in it: column pruning folds the projection into
    the aggregate, in both packages."""
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(col("l_quantity") <= lit(1.0))
            .select(col("l_returnflag"), col("l_linestatus"),
                    F.upper(col("l_comment")).alias("c"))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.min(col("c")).alias("min_c"),
                 F.max(col("c")).alias("max_c"), F.count().alias("n")))


def fb_moving_min(api, df):
    """repart_agg's daily quantity sums on the device, their 7-row moving
    minimum by ship date on the CPU (a bounded-rows min is tagged off the
    device), then each day's ratio to it on the device again."""
    col, F = api.col, api.F
    w = api.Window.order_by(col("l_shipdate")).rows_between(-6, 0)
    return (repart_agg(api, df)
            .select(col("l_shipdate"), col("s"),
                    F.min(col("s")).over(w).alias("min7"))
            .select(col("l_shipdate"), col("s"), col("min7"),
                    (col("s") / col("min7")).alias("ratio")))


#: str_case_agg's pattern and str_prefix_rows' prefix
CASE_WORD, PREFIX_WORD = "FURIOUS", "a"


def str_case_agg(api, df, word=CASE_WORD):
    """Filter on a case-mapped comment, group by the two flags, and sum a
    lower-cased comment's length: the case map runs twice, the aggregate
    takes the tiny-bucket route."""
    col, F = api.col, api.F
    return (df.filter(F.contains(F.upper(col("l_comment")), word))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.count().alias("n"),
                 F.sum(F.length(F.lower(col("l_comment")))).alias("chars")))


def str_group_flat(api, df):
    """Group by a flat string key: the sort route."""
    col, F = api.col, api.F
    return (df.select(F.substring(F.upper(col("l_comment")), 1, 9)
                      .alias("head"), col("l_quantity"))
            .group_by("head")
            .agg(F.count().alias("n"), F.sum(col("l_quantity")).alias("q")))


def str_prefix_rows(api, df, word=PREFIX_WORD):
    """A row query: prefix filter, concat of the short flag columns, and a
    substring of the upper-cased comment."""
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(F.startswith(F.lower(col("l_comment")), word)
                      & (col("l_quantity") < lit(3.0)))
            .select(col("l_orderkey"),
                    F.concat(col("l_returnflag"), lit("|"),
                             col("l_linestatus")).alias("flags"),
                    F.substring(F.upper(col("l_comment")), 1, 12)
                    .alias("head")))


# ---------------------------------------------------------------------------
# the join and sort shapes
# ---------------------------------------------------------------------------

def _q3_joined(api, li, od):
    col, lit = api.col, api.lit
    j = li.filter(col("l_shipdate") > lit(9100)).join(
        od.filter(col("o_orderdate") < lit(9500)),
        on=[(col("l_orderkey"), col("o_orderkey"))], how="inner")
    return j, (col("l_extendedprice")
               * (lit(1.0) - col("l_discount"))).alias("rev")


def q3join(api, li, od):
    """bench.py's q3join: lineitem x orders, revenue per order, top 10."""
    col, F = api.col, api.F
    j, rev = _q3_joined(api, li, od)
    g = (j.select(col("l_orderkey"), rev)
         .group_by(col("l_orderkey")).agg(F.sum("rev").alias("rev")))
    return g.order_by(col("rev").desc(), col("l_orderkey").asc()).limit(10)


def q3_orderdate(api, li, od):
    """q3join grouped by (l_orderkey, o_orderdate), TPC-H Q3's keys less
    o_shippriority: 22 + 12 packed bits, the packed sort route."""
    col, F = api.col, api.F
    j, rev = _q3_joined(api, li, od)
    g = (j.select(col("l_orderkey"), col("o_orderdate"), rev)
         .group_by(col("l_orderkey"), col("o_orderdate"))
         .agg(F.sum("rev").alias("rev")))
    return g.order_by(col("rev").desc(), col("l_orderkey").asc()).limit(10)


def q3_revenue_by_date(api, li, od):
    """The q3join join, revenue and line count per order date: a 12-bit
    key, the (chunked) segsum route."""
    col, F = api.col, api.F
    j, rev = _q3_joined(api, li, od)
    return (j.select(col("o_orderdate"), rev).group_by(col("o_orderdate"))
            .agg(F.sum("rev").alias("rev"), F.count().alias("n")))


def q4_semi_anti(api, li, od, how="left_semi"):
    """TPC-H Q4's EXISTS shape: orders of a date window with (or without)
    a line shipped after day 9100; their count and custkey sum."""
    col, lit, F = api.col, api.lit, api.F
    o = od.filter((col("o_orderdate") >= lit(9000))
                  & (col("o_orderdate") < lit(9400)))
    return (o.join(li.filter(col("l_shipdate") > lit(9100)),
                   on=[(col("o_orderkey"), col("l_orderkey"))], how=how)
            .agg(F.count().alias("n"), F.sum(col("o_custkey")).alias("cs")))


def q13_left(api, cust, od):
    """TPC-H Q13's shape: customers left join their early orders, orders
    per customer, then customers per order count."""
    col, lit, F = api.col, api.lit, api.F
    per = (cust.join(od.filter(col("o_orderdate") < lit(8500)),
                     on=[(col("c_custkey"), col("o_custkey"))], how="left")
           .group_by(col("c_custkey"))
           .agg(F.count(col("o_orderkey")).alias("c_count")))
    return per.group_by(col("c_count")).agg(F.count().alias("custdist"))


def flag_dim(api, li, dim):
    """Lineitem joined to the flag dimension on its two string keys, then
    price sum and line count per label."""
    col, F = api.col, api.F
    return (li.join(dim, on=[(col("l_returnflag"), col("d_returnflag")),
                             (col("l_linestatus"), col("d_linestatus"))])
            .group_by(col("d_label"))
            .agg(F.sum(col("l_extendedprice")).alias("price"),
                 F.count().alias("n")))


def sort_rows(api, li):
    """Three lineitem columns by price descending, then order key and
    ship date ascending."""
    col = api.col
    return (li.select(col("l_extendedprice"), col("l_orderkey"),
                      col("l_shipdate"))
            .order_by(col("l_extendedprice").desc(), col("l_orderkey").asc(),
                      col("l_shipdate").asc()))


def limit_rows(api, li, n=1000):
    col, lit = api.col, api.lit
    return li.filter(col("l_quantity") < lit(2.0)).limit(n)


def band_join(api, li, bands):
    """Lineitem joined to the price bands on lo <= price < hi, with no
    equi key (the nested-loop join), then lines and quantity per band."""
    col, F = api.col, api.F
    on = (col("l_extendedprice") >= col("lo")) \
        & (col("l_extendedprice") < col("hi"))
    return (li.join(bands, on=on).group_by(col("band"))
            .agg(F.count().alias("n"), F.sum(col("l_quantity")).alias("q")))


def flag_cross(api, li, dim):
    """The flag dimension cross joined with a few lineitem rows, then
    pairs per label."""
    col, lit, F = api.col, api.lit, api.F
    few = li.filter((col("l_quantity") < lit(2.0))
                    & (col("l_shipdate") < lit(8500)))
    return (dim.join(few, how="cross").group_by(col("d_label"))
            .agg(F.count().alias("n")))


# ---------------------------------------------------------------------------
# the window shapes
# ---------------------------------------------------------------------------

FLAGS = ("l_returnflag", "l_linestatus")


def q67win(api, df):
    """bench.py's q67win: rank by ship date within each flag pair, then
    the largest rank per pair."""
    col, F = api.col, api.F
    w = api.Window.partition_by(col("l_returnflag"), col("l_linestatus")) \
        .order_by(col("l_shipdate"))
    return (df.select(col("l_returnflag"), col("l_linestatus"),
                      F.rank().over(w).alias("rk"))
            .group_by(col("l_returnflag"), col("l_linestatus"))
            .agg(F.max("rk").alias("mx")))


def win_rank_family(api, df):
    """The rank family over the flag pairs, ordered by ship date
    descending and order key, summarized per pair."""
    col, F = api.col, api.F
    w = api.Window.partition_by(*[col(c) for c in FLAGS]).order_by(
        col("l_shipdate").desc(), col("l_orderkey").asc())
    ranked = df.select(
        *[col(c) for c in FLAGS], F.row_number().over(w).alias("rn"),
        F.rank().over(w).alias("rk"), F.dense_rank().over(w).alias("drk"),
        F.ntile(100).over(w).alias("nt"),
        F.percent_rank().over(w).alias("pr"),
        F.cume_dist().over(w).alias("cd"))
    return ranked.group_by(*FLAGS).agg(
        F.max("rn").alias("max_rn"), F.max("rk").alias("max_rk"),
        F.max("drk").alias("max_drk"), F.max("nt").alias("max_nt"),
        F.sum("rk").alias("sum_rk"), F.sum("pr").alias("sum_pr"),
        F.max("cd").alias("max_cd"))


#: win_running's window columns, in order
RUNNING_COLS = ("rsum", "ravg", "rcnt", "rmin", "rmax", "bsum", "ld", "lg",
                "fv", "lv", "nv")


def win_running(api, df):
    """Running frames per order (partition by order key, ordered by
    price): sums, an average, counts, min/max, a bounded ROWS sum,
    lead/lag and first/last/nth values; then their sums and the non-null
    counts of the nullable ones."""
    col, F = api.col, api.F
    w = api.Window.partition_by(col("l_orderkey")) \
        .order_by(col("l_extendedprice"))
    out = df.select(
        F.sum(col("l_quantity")).over(w).alias("rsum"),
        F.avg(col("l_discount")).over(w).alias("ravg"),
        F.count().over(w).alias("rcnt"),
        F.min(col("l_extendedprice")).over(w).alias("rmin"),
        F.max(col("l_extendedprice")).over(w).alias("rmax"),
        F.sum(col("l_quantity")).over(w.rows_between(-2, 2)).alias("bsum"),
        F.lead(col("l_discount"), 1, 0.0).over(w).alias("ld"),
        F.lag(col("l_quantity")).over(w).alias("lg"),
        F.first_value(col("l_shipdate")).over(w).alias("fv"),
        F.last_value(col("l_shipdate")).over(w).alias("lv"),
        F.nth_value(col("l_shipdate"), 2).over(w).alias("nv"))
    return out.agg(*[F.sum(c).alias(c) for c in RUNNING_COLS],
                   F.count("lg").alias("n_lg"), F.count("nv").alias("n_nv"))


def win_shuffled(api, df):
    """A running quantity sum per ship date in order-key order over a
    multi-partition input (the hash exchange), then per ship date."""
    col, F = api.col, api.F
    w = api.Window.partition_by(col("l_shipdate")) \
        .order_by(col("l_orderkey"))
    return (df.select(col("l_shipdate"), F.row_number().over(w).alias("rn"),
                      F.sum(col("l_quantity")).over(w).alias("run"))
            .group_by(col("l_shipdate"))
            .agg(F.sum("run").alias("s"), F.count().alias("n")))


def win_global_top(api, df, n=100):
    """rank() over the whole input (no partition: the collect exchange)
    by price descending and order key, the first n ranks kept."""
    col, lit, F = api.col, api.lit, api.F
    w = api.Window.order_by(col("l_extendedprice").desc(),
                            col("l_orderkey").asc())
    return (df.filter(col("l_quantity") < lit(2.0))
            .select(col("l_orderkey"), col("l_extendedprice"),
                    col("l_shipdate"), F.rank().over(w).alias("rk"))
            .filter(col("rk") <= lit(n)))


def dedupe_orders(api, df):
    """One whole line per order key (``drop_duplicates``: a row_number
    over the key ordered by a constant, then a filter)."""
    return df.drop_duplicates(["l_orderkey"])


# ---------------------------------------------------------------------------
# the expression and aggregate shapes
# ---------------------------------------------------------------------------

def q14_case(api, df):
    """TPC-H Q14's CASE-in-SUM by ship date: the promotion revenue (flags
    A and R stand in for the PROMO part types), all revenue and the line
    count; a 12-bit key, the (chunked) segsum route."""
    col, lit, F = api.col, api.lit, api.F
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    promo = F.when(col("l_returnflag").isin("A", "R"), rev) \
        .otherwise(lit(0.0))
    return df.group_by(col("l_shipdate")).agg(
        F.sum(promo).alias("promo"), F.sum(rev).alias("rev"),
        F.count().alias("n"))


def q1_stats(api, df):
    """q1's filter and flag keys with the moments, first/last and an
    average of abs(-x): the tiny-bucket route."""
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(col("l_shipdate") <= lit(10471))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.stddev(col("l_quantity")).alias("sd_q"),
                 F.var_pop(col("l_extendedprice")).alias("vp_p"),
                 F.first(col("l_shipdate")).alias("first_ship"),
                 F.last(col("l_discount")).alias("last_disc"),
                 F.avg(F.abs(-col("l_discount"))).alias("avg_abs"),
                 F.count().alias("n")))


def stats_by_order(api, df):
    """Moments and first per order-key bucket: a 17-bit packed key, which
    the sums of squares keep off the segsum route."""
    col, lit, F = api.col, api.lit, api.F
    return (df.select((col("l_orderkey") % lit(100_000)).alias("k"),
                      col("l_extendedprice"), col("l_discount"),
                      col("l_quantity"))
            .group_by(col("k"))
            .agg(F.stddev(col("l_extendedprice")).alias("sd_p"),
                 F.variance(col("l_discount")).alias("var_d"),
                 F.first(col("l_quantity")).alias("first_q")))


def pctl_shuffled(api, df):
    """Percentiles and min_by/max_by per ship date: segmented aggregates,
    so a multi-partition input is hash-exchanged by key as raw rows."""
    col, F = api.col, api.F
    return df.group_by(col("l_shipdate")).agg(
        F.percentile(col("l_extendedprice"), 0.5).alias("p50"),
        F.approx_percentile(col("l_discount"), 0.9).alias("p90"),
        F.max_by(col("l_orderkey"), col("l_extendedprice")).alias("top"),
        F.min_by(col("l_orderkey"), col("l_discount")).alias("cheap"))


#: cleanse_rows' output columns, in order
CLEANSE_COLS = ("l_orderkey", "status", "ok7", "nq", "nvl_q", "hi", "lo",
                "ts", "ts_s", "sat", "ns", "pid", "mid")


def cleanse_rows(api, df, ship_before=8500):
    """A row query over early lines: a three-branch string CASE on the
    flags, integral division, nullif/nvl, greatest/least, the date and
    timestamp casts, a saturating float-to-long cast, <=> on a nullable
    column, and the partition id and monotonically increasing id."""
    col, lit, F, E, T = api.col, api.lit, api.F, api.E, api.T
    nq = F.nullif(col("l_quantity"), lit(1.0))
    status = (F.when(col("l_returnflag") == lit("R"), lit("returned"))
              .when(col("l_returnflag") == lit("A"), col("l_linestatus"))
              .otherwise(lit("none")))
    price_off = col("l_extendedprice") * col("l_discount")
    ts = col("l_shipdate").cast(T.DATE).cast(T.TIMESTAMP)
    return (df.filter(col("l_shipdate") < lit(ship_before))
            .select(col("l_orderkey"), status.alias("status"),
                    E.IntegralDivide(col("l_orderkey"), lit(7)).alias("ok7"),
                    nq.alias("nq"), F.nvl(nq, lit(0.0)).alias("nvl_q"),
                    F.greatest(price_off, col("l_quantity") * lit(100.0))
                    .alias("hi"),
                    F.least(price_off, col("l_quantity") * lit(100.0))
                    .alias("lo"),
                    ts.alias("ts"), ts.cast(T.INT64).alias("ts_s"),
                    (col("l_extendedprice") * lit(1e14)).cast(T.INT64)
                    .alias("sat"),
                    E.EqualNullSafe(nq, lit(50.0)).alias("ns"),
                    F.spark_partition_id().alias("pid"),
                    F.monotonically_increasing_id().alias("mid")))


def from_jax_batch(batch):
    """A JAX package ColumnarBatch rebuilt, plane by plane, as a torch
    ColumnarBatch on the CPU (numpy arrays in between)."""
    import torch

    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.columnar.batch import (
        ColumnVector, ColumnarBatch,
    )

    def t(a):
        return torch.from_numpy(np.array(a))

    cols = []
    for c in batch.columns:
        dtype = getattr(TT, type(c.dtype).__name__)()
        if isinstance(c.data, dict):
            data = {k: t(v) for k, v in c.data.items()}
        else:
            data = t(c.data)
        validity = None if c.validity is None else t(c.validity)
        cols.append(ColumnVector(dtype, data, validity,
                                 dict_unique=c.dict_unique, bounds=c.bounds))
    mask = None if batch.row_mask is None else t(batch.row_mask)
    return ColumnarBatch(cols, int(batch.num_rows), mask)


# ---------------------------------------------------------------------------
# the set and grouping-set shapes
# ---------------------------------------------------------------------------

def q1_rollup(api, df):
    """q1's filter and flag keys under ROLLUP: sums, an average, the line
    count and grouping_id(); string keys, so the Expand yields one batch
    per grouping set."""
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(col("l_shipdate") <= lit(10471))
            .rollup("l_returnflag", "l_linestatus")
            .agg(F.sum(col("l_quantity")).alias("sum_qty"),
                 F.sum(col("l_extendedprice")).alias("sum_price"),
                 F.avg(col("l_discount")).alias("avg_disc"),
                 F.count().alias("n"), F.grouping_id().alias("gid")))


def rollup_shipdate(api, df):
    """Revenue and line counts under ROLLUP(ship year, ship week) over the
    numeric columns: a fixed-width Expand below computed keys, which the
    JAX package fuses into one stacked batch of 3 x capacity. The packed
    key (year, week, grouping id) takes 18 bits over bench.py's dates, so
    twelve 2^23-row chunks of a 30M-row input pass the chunked segsum
    gate (12 x 2^18 <= 2^23); with the ship date itself (20 bits) they
    would not."""
    col, lit, F, E = api.col, api.lit, api.F, api.E
    return (df.select(col("l_shipdate"), col("l_extendedprice"),
                      col("l_discount"))
            .rollup(E.IntegralDivide(col("l_shipdate"), lit(365))
                    .alias("ship_year"),
                    E.IntegralDivide(col("l_shipdate"), lit(7))
                    .alias("ship_week"))
            .agg(F.sum(col("l_extendedprice") * (lit(1.0)
                                                 - col("l_discount")))
                 .alias("rev"), F.count().alias("n")))


def cube_flags(api, df):
    """CUBE(l_returnflag, l_linestatus): four grouping sets with the
    grouping() markers."""
    col, F = api.col, api.F
    return (df.select("l_returnflag", "l_linestatus", "l_quantity")
            .cube("l_returnflag", "l_linestatus")
            .agg(F.sum(col("l_quantity")).alias("sum_qty"),
                 F.count().alias("n"),
                 F.grouping(col("l_returnflag")).alias("g_rf"),
                 F.grouping(col("l_linestatus")).alias("g_ls")))


def union_repart(api, many, one, split=9500, n=8):
    """Early lines of a many-partition frame with l_quantity cast to int,
    UNION ALL the late lines of a one-partition frame (the union widens
    the int back to double), hash-repartitioned by ship date, then
    per ship date."""
    col, lit, F, T = api.col, api.lit, api.F, api.T
    early = (many.filter(col("l_shipdate") < lit(split))
             .select(col("l_shipdate"),
                     col("l_quantity").cast(T.INT32).alias("l_quantity")))
    late = (one.filter(col("l_shipdate") >= lit(split))
            .select(col("l_shipdate"), col("l_quantity")))
    return (early.union(late).repartition(n, col("l_shipdate"))
            .group_by(col("l_shipdate"))
            .agg(F.sum(col("l_quantity")).alias("sum_qty"),
                 F.count().alias("n")))


def orders_setops(api, od, split=9500):
    """(early orders) INTERSECT and EXCEPT (orders of every third
    customer) over (o_orderkey, o_custkey): one row per operation with
    its row count and key sums."""
    col, lit, F = api.col, api.lit, api.F
    keys = (col("o_orderkey"), col("o_custkey"))
    early = od.filter(col("o_orderdate") < lit(split)).select(*keys)
    third = od.filter((col("o_custkey") % lit(3)) == lit(0)).select(*keys)

    def summary(df, op):
        return df.agg(F.count().alias("n"),
                      F.sum(col("o_orderkey")).alias("sum_ok"),
                      F.sum(col("o_custkey")).alias("sum_ck")).select(
            lit(op).alias("op"), col("n"), col("sum_ok"), col("sum_ck"))
    return summary(early.intersect(third), "intersect").union(
        summary(early.subtract(third), "except"))


def range_agg(api, session, n=1 << 28, parts=8, m=100_003):
    """session.range(0, n) over parts partitions, grouped by id % m: the
    sum and count of the ids per key."""
    col, lit, F = api.col, api.lit, api.F
    return (session.range(0, n, 1, num_partitions=parts)
            .group_by((col("id") % lit(m)).alias("k"))
            .agg(F.sum(col("id")).alias("s"), F.count().alias("n")))


def range_agg_answer(n=1 << 28, m=100_003):
    """range_agg's closed form per key k < m: count = ceil((n - k) / m),
    sum = count * k + m * count * (count - 1) / 2."""
    k = np.arange(min(m, n), dtype=np.int64)
    cnt = (n - k + m - 1) // m
    return k, cnt * k + m * cnt * (cnt - 1) // 2, cnt


def pivot_flags(api, df):
    """Per line status, PIVOT on the return flag with the values inferred
    (an eager distinct): the price sum and the line count per flag."""
    col, F = api.col, api.F
    return (df.group_by("l_linestatus").pivot("l_returnflag")
            .agg(F.sum(col("l_extendedprice")).alias("price"),
                 F.count().alias("n")))


DESCRIBE_COLS = ("l_quantity", "l_extendedprice", "l_discount")


def describe_li(api, df):
    """describe() over three numeric columns and corr(quantity, price):
    (the summary table, the correlation)."""
    return (df.describe(*DESCRIBE_COLS).collect(),
            df.corr("l_quantity", "l_extendedprice"))


def sample_li(api, df, fraction=0.01, seed=11):
    """A 1% Bernoulli sample (rand(seed) < fraction): its row count and
    order-key sum."""
    col, F = api.col, api.F
    return df.sample(fraction, seed=seed).agg(
        F.count().alias("n"), F.sum(col("l_orderkey")).alias("s"))


def splitmix_rand(n: int, seed: int, partition: int = 0) -> np.ndarray:
    """numpy's rand(seed) stream over n rows of one partition: splitmix64
    of position + (partition << 40) + seed, top 53 bits over 2^53."""
    M = np.uint64
    x = np.arange(n, dtype=np.uint64) + M((partition << 40) + seed
                                          & (2 ** 64 - 1))
    with np.errstate(over="ignore"):
        x = x + M(0x9E3779B97F4A7C15)
        x = (x ^ (x >> M(30))) * M(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> M(27))) * M(0x94D049BB133111EB)
    x = x ^ (x >> M(31))
    return (x >> M(11)).astype(np.float64) / float(1 << 53)


# ---------------------------------------------------------------------------
# The aggregate types: partial -> collect -> final, decimals, arrays
# ---------------------------------------------------------------------------

#: the lineitem's money and quantity columns, as TPC-H declares them
DEC_COLS = ("l_quantity", "l_extendedprice", "l_discount")
DEC_TYPE = (15, 2)


def decimal_array(unscaled: np.ndarray, precision: int, scale: int,
                  mask=None) -> pa.Array:
    """int64 unscaled values as an Arrow decimal128 array, from buffers
    (each high word the low word's sign extension)."""
    vals = np.ascontiguousarray(unscaled, dtype=np.int64)
    words = np.empty(2 * len(vals), np.int64)
    words[0::2] = vals
    words[1::2] = vals >> 63
    bitmap = None if mask is None else pa.py_buffer(
        np.packbits(~np.asarray(mask, np.bool_), bitorder="little"))
    return pa.Array.from_buffers(pa.decimal128(precision, scale), len(vals),
                                 [bitmap, pa.py_buffer(words)])


def lineitem_dec(lineitem: pa.Table) -> pa.Table:
    """The lineitem with DEC_COLS as decimal(15, 2): the values already
    have two decimals (``_draw_lineitem``), so the conversion is exact."""
    cols = {}
    for name in lineitem.column_names:
        c = lineitem[name]
        if name in DEC_COLS:
            x = np.concatenate([ch.to_numpy() for ch in c.chunks])
            c = decimal_array(np.round(x * 100).astype(np.int64), *DEC_TYPE)
        cols[name] = c
    return pa.table(cols)


def _dec(v: str):
    import decimal
    return decimal.Decimal(v)


def q6_dec(api, df):
    """q6 over lineitem_dec, with decimal literals: the revenue product of
    two decimal(15, 2) passes 18 digits, so it is FLOAT64."""
    col, lit, F = api.col, api.lit, api.F
    cond = ((col("l_shipdate") >= lit(LO)) & (col("l_shipdate") < lit(HI))
            & (col("l_discount") >= lit(_dec("0.05")))
            & (col("l_discount") <= lit(_dec("0.07")))
            & (col("l_quantity") < lit(_dec("24"))))
    return df.filter(cond).agg(
        F.sum(col("l_extendedprice") * col("l_discount")).alias("revenue"))


def q1_dec(api, df):
    """q1 over lineitem_dec: decimal sums (exact), averages (FLOAT64), the
    discounted price as a FLOAT64 product, and the decimal minimum."""
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(col("l_shipdate") <= lit(10471))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum(col("l_quantity")).alias("sq"),
                 F.sum(col("l_extendedprice")).alias("sp"),
                 F.sum(col("l_extendedprice")
                       * (lit(1) - col("l_discount"))).alias("sdp"),
                 F.avg(col("l_quantity")).alias("mq"),
                 F.avg(col("l_discount")).alias("md"),
                 F.count(col("l_quantity")).alias("cnt"),
                 F.min(col("l_discount")).alias("mind"),
                 F.max(col("l_extendedprice")).alias("maxp")))


def disc_groups(api, df):
    """A group-by on the decimal key l_discount: the line count, the
    decimal quantity sum and the average price per discount."""
    col, F = api.col, api.F
    return df.group_by("l_discount").agg(
        F.count().alias("n"), F.sum(col("l_quantity")).alias("sq"),
        F.avg(col("l_extendedprice")).alias("mp"))


def order_lines(api, df):
    """Per order (the key as an int: order keys are below 2^31), the ship
    dates of its lines in input order and the distinct return flags:
    collect_* has no partial state, so several partitions exchange raw
    rows by the key first."""
    col, F = api.col, api.F
    return df.group_by(col("l_orderkey").cast(api.T.INT32).alias(
        "l_orderkey")).agg(F.collect_list(col("l_shipdate")).alias("ships"),
                           F.collect_set(col("l_returnflag")).alias("flags"))


def q72shfl_x3(api, df):
    """q72shfl's grouping over the lineitem three times (UNION ALL): the
    estimate, three times the lineitem's, passes the single-device limit
    of 64M rows at bench.py's 30M, so the aggregate runs partial per
    partition -> collect -> final."""
    return q72shfl(api, df.union(df).union(df))



# ---------------------------------------------------------------------------
# The datetime slice: the lineitem with DATE, TIMESTAMP and date-string
# columns, and the smoke's datetime query shapes
# ---------------------------------------------------------------------------

DAY_US = 86_400_000_000
#: the rng stream of l_commit_ts's time of day
DT_SEED = 47
#: the session zone of dt_tz_session, and the zones of its shifts
DT_SESSION_ZONE = "America/New_York"
DT_FROM_ZONE, DT_TO_ZONE = "Asia/Kolkata", "Australia/Sydney"


def lineitem_dt(lineitem: pa.Table, seed: int = DT_SEED) -> pa.Table:
    """The datetime phase's lineitem: l_shipdate as DATE (the same days),
    l_commit_ts as TIMESTAMP (the ship day plus a time of day from a
    seeded stream), l_shipdate_str (flat 'yyyy-MM-dd' strings, numpy's
    datetime_as_string of each distinct day, taken per row), and the
    order key, price, discount, quantity and flags."""
    import pyarrow.compute as pc
    days = np.concatenate([c.to_numpy() for c in
                           lineitem["l_shipdate"].chunks]).astype(np.int64)
    tod = np.random.default_rng(seed).integers(0, DAY_US, len(days))
    # the distinct days and each row's index among them, without a sort
    d0 = int(days.min())
    uniq = np.nonzero(np.bincount(days - d0))[0]
    slot = np.zeros(int(days.max()) - d0 + 1, np.int32)
    slot[uniq] = np.arange(len(uniq), dtype=np.int32)
    inv = slot[days - d0]
    text = pa.array(np.datetime_as_string(
        (uniq + d0).astype("datetime64[D]")))
    return pa.table({
        "l_orderkey": lineitem["l_orderkey"],
        "l_shipdate": pa.array(days.astype(np.int32), pa.date32()),
        "l_commit_ts": pa.array(days * DAY_US + tod, pa.timestamp("us")),
        "l_shipdate_str": pc.take(text, pa.array(inv)),
        "l_extendedprice": lineitem["l_extendedprice"],
        "l_discount": lineitem["l_discount"],
        "l_quantity": lineitem["l_quantity"],
        "l_returnflag": lineitem["l_returnflag"],
        "l_linestatus": lineitem["l_linestatus"],
    })


def _revenue(api):
    col, lit = api.col, api.lit
    return col("l_extendedprice") * (lit(1.0) - col("l_discount"))


def dt_year_month(api, df):
    """Revenue and lines per year and month of the ship date (the
    extract(year ...) grouping of TPC-H Q7/Q8/Q9)."""
    col, F = api.col, api.F
    return df.group_by(F.year(col("l_shipdate")).alias("y"),
                       F.month(col("l_shipdate")).alias("m")).agg(
        F.sum(_revenue(api)).alias("revenue"), F.count().alias("n"))


def dt_q6_add_months(api, df):
    """Q6 with its year as date '1994-01-01' <= l_shipdate <
    add_months(date '1994-01-01', 12), as Spark rewrites date + interval
    '1' year."""
    import datetime
    col, lit, F = api.col, api.lit, api.F
    start = lit(datetime.date(1994, 1, 1))
    cond = ((col("l_shipdate") >= start)
            & (col("l_shipdate") < F.add_months(start, 12))
            & (col("l_discount") >= lit(0.05))
            & (col("l_discount") <= lit(0.07))
            & (col("l_quantity") < lit(24.0)))
    return df.filter(cond).agg(
        F.sum(col("l_extendedprice") * col("l_discount")).alias("revenue"))


def dt_daily_repart(api, df, n=8):
    """repart_agg's shape over the commit day: hash-repartitioned by
    cast(l_commit_ts as date), revenue and lines per day, with its day of
    the week."""
    col, F = api.col, api.F
    return (df.select(col("l_commit_ts").cast(api.T.DATE).alias("d"),
                      _revenue(api).alias("rev"))
            .repartition(n, col("d"))
            .group_by(col("d"))
            .agg(F.sum("rev").alias("s"), F.count("rev").alias("c"))
            .select(col("d"), F.dayofweek(col("d")).alias("dow"),
                    col("s"), col("c")))


def dt_ts_groups(api, df):
    """Lines and quantity per hour, day of the week and quarter of the
    commit timestamp."""
    col, F = api.col, api.F
    ts = col("l_commit_ts")
    return df.group_by(F.hour(ts).alias("h"), F.dayofweek(ts).alias("dow"),
                       F.quarter(ts).alias("q")).agg(
        F.count().alias("n"), F.sum(col("l_quantity")).alias("sq"))


#: dt_ts_rows' filter keeps l_quantity < this (~4% of the lines)
DT_ROWS_QTY = 3.0


def dt_ts_rows(api, df):
    """A row query over the lines with l_quantity < 3: the remaining
    timestamp and date functions."""
    import datetime
    col, lit, F = api.col, api.lit, api.F
    ts, d = col("l_commit_ts"), col("l_shipdate")
    return df.filter(col("l_quantity") < lit(DT_ROWS_QTY)).select(
        col("l_orderkey"), F.date_trunc("hour", ts).alias("th"),
        F.unix_timestamp(ts).alias("ut"), F.weekofyear(ts).alias("w"),
        F.last_day(d).alias("ld"),
        F.datediff(d, lit(datetime.date(1995, 1, 1))).alias("dd"),
        F.months_between(ts, lit(datetime.date(1995, 1, 1))).alias("mb"),
        F.next_day(d, "MON").alias("nd"),
        F.make_date(F.year(d), F.month(d), lit(1)).alias("md"),
        F.date_add(d, 30).alias("da"), F.date_sub(d, 30).alias("ds"))


def dt_tz_hours(api, df):
    """In a session zone: lines per local year, month and hour."""
    col, F = api.col, api.F
    ts = col("l_commit_ts")
    return df.group_by(F.year(ts).alias("y"), F.month(ts).alias("m"),
                       F.hour(ts).alias("h")).agg(F.count().alias("n"))


def dt_tz_days(api, df):
    """In a session zone: lines per local day (cast(ts as date))."""
    col, F = api.col, api.F
    return df.group_by(col("l_commit_ts").cast(api.T.DATE).alias("d")).agg(
        F.count().alias("n"))


def dt_tz_shifts(api, df):
    """In a session zone, per local hour: the epoch seconds of the commit
    time read in DT_FROM_ZONE (from_utc_timestamp) and of it read as
    DT_TO_ZONE's wall clock (to_utc_timestamp), summed."""
    col, F = api.col, api.F
    ts = col("l_commit_ts")
    return df.group_by(F.hour(ts).alias("h")).agg(
        F.sum(F.unix_seconds(F.from_utc_timestamp(ts, DT_FROM_ZONE)))
        .alias("sf"),
        F.sum(F.unix_seconds(F.to_utc_timestamp(ts, DT_TO_ZONE)))
        .alias("st"))


def dt_cast_checks(api, df):
    """The string casts, counted: ship-date strings parsed (the dictionary
    arm) and rendered then parsed (the flat arm) against l_shipdate, the
    order key's decimal round trip, and the ship years parsed as
    doubles, summed."""
    col, lit, F, T = api.col, api.lit, api.F, api.T
    d = col("l_shipdate")
    one = lit(1)

    def hits(cond):
        return F.sum(F.when(cond, one).otherwise(lit(0)))
    return df.agg(
        hits(col("l_shipdate_str").cast(T.DATE) == d).alias("str_date"),
        hits(d.cast(T.STRING).cast(T.DATE) == d).alias("rendered_date"),
        hits(col("l_orderkey").cast(T.STRING).cast(T.INT64)
             == col("l_orderkey")).alias("orderkey"),
        F.sum(F.substring(col("l_shipdate_str"), 1, 4).cast(T.FLOAT64))
        .alias("years"))


def dt_ts_string_hours(api, df):
    """Lines per hour of the commit time rendered as a string (its first
    13 characters, 'yyyy-MM-dd HH')."""
    col, F = api.col, api.F
    return df.group_by(F.substring(col("l_commit_ts").cast(api.T.STRING),
                                   1, 13).alias("hour")).agg(
        F.count().alias("n"))


def dt_format_fb(api, df):
    """date_format(l_shipdate, 'yyyy-MM') over the l_quantity = 1 lines,
    counted per month: date_format has no device implementation in either
    package, so one operator runs on the CPU."""
    col, lit, F = api.col, api.lit, api.F
    return df.filter(col("l_quantity") == lit(1.0)).group_by(
        F.date_format(col("l_shipdate"), "yyyy-MM").alias("ym")).agg(
        F.count().alias("n"))


#: dt_format_fb's CPU node
DT_FALLBACK_NODE = "Aggregate"

#: sql_dt: dt_year_month's grouping as SQL, with the quarter and a
#: cast('1995-01-01' as date) filter (the SQL grammar of both packages
#: groups by columns, so the date parts come from a WITH)
SQL_DT = ("WITH parts AS (SELECT year(l_shipdate) AS y, "
          "month(l_shipdate) AS m, quarter(l_shipdate) AS q, "
          "l_extendedprice * (1.0 - l_discount) AS rev FROM lineitem_dt "
          "WHERE l_shipdate >= CAST('1995-01-01' AS date)) "
          "SELECT y, m, q, SUM(rev) AS revenue, COUNT(*) AS n FROM parts "
          "GROUP BY y, m, q")


# ---------------------------------------------------------------------------
# the regex and string-breadth shapes over lineitem_text: patterns every
# one of which the JAX package compiles to its device NFA, but RX_Q13's
# ---------------------------------------------------------------------------

RX_RLIKE = "b(l|r)[a-z]+ly"
#: LIKE patterns of the NFA arm, and one that transpiles to endswith
RX_LIKE_NFA, RX_LIKE_PLAIN = ("_u%", "%ar_"), "%ly"
RX_EXTRACT = ("([a-z]+)ly ", 1)
RX_REPLACE = ("[aeiou]+", "*")
#: TPC-H Q13's two-run LIKE: more than 31 NFA positions, so a CPU filter
RX_Q13 = "%quick%sleep%"
#: the row queries' lines: l_quantity below this
RX_ROWS_QTY = 3.0
#: rx_cpu_rows_fb's lines: l_quantity = 1 and l_orderkey % RX_CPU_MOD == 0
#: (~10,000 of bench.py's 30M lines: its eleven Python row functions cost
#: ~100 us a line on the CPU backend)
RX_CPU_MOD = 60
#: the plan node each fallback query of the regex shapes leaves on the CPU
RX_FALLBACK_NODES = {"rx_cpu_rows_fb": "Project", "rx_q13_fb": "Filter"}


def rx_rlike_flags(api, df):
    """Lines whose comment matches RX_RLIKE, per flag pair: their count
    and their comments' bytes."""
    col, F = api.col, api.F
    return (df.filter(F.rlike(col("l_comment"), RX_RLIKE))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.count().alias("n"),
                 F.sum(F.octet_length(col("l_comment"))).alias("bytes")))


def rx_like_nfa(api, df):
    """Lines per outcome of the two NFA LIKE patterns and the transpiled
    one."""
    col, F = api.col, api.F
    c = col("l_comment")
    return (df.select(F.like(c, RX_LIKE_NFA[0]).alias("u"),
                      F.like(c, RX_LIKE_NFA[1]).alias("ar"),
                      F.like(c, RX_LIKE_PLAIN).alias("ly"))
            .group_by("u", "ar", "ly").agg(F.count().alias("n")))


def rx_extract_groups(api, df):
    """Lines per word before the first 'ly ' (regexp_extract: "" where a
    comment has none): a flat string key, the sort route."""
    col, F = api.col, api.F
    return (df.select(F.regexp_extract(col("l_comment"), *RX_EXTRACT)
                      .alias("w"))
            .group_by("w").agg(F.count().alias("n")))


def rx_replace_sums(api, df):
    """Per flag pair, the characters of the comments with every vowel run
    replaced."""
    col, F = api.col, api.F
    return (df.select(col("l_returnflag"), col("l_linestatus"),
                      F.length(F.regexp_replace(col("l_comment"),
                                                *RX_REPLACE)).alias("len"))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum(col("len")).alias("chars"), F.count().alias("n")))


def rx_replace_rows(api, df):
    """The same replacement row by row over the lines of few items."""
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(col("l_quantity") < lit(RX_ROWS_QTY))
            .select(col("l_orderkey"),
                    F.regexp_replace(col("l_comment"), *RX_REPLACE)
                    .alias("r")))


#: rx_breadth_rows' output columns, after l_orderkey
RX_BREADTH_COLS = ("trim", "ltrim", "rtrim", "initcap", "ascii", "instr",
                   "locate", "rep", "octets", "bits", "left5", "right5",
                   "chr", "upper_trim", "crc", "hive")


def rx_breadth_rows(api, df):
    """trim ... chr, crc32 and hive_hash over the lines of few items; the
    case-map kernel runs in upper(trim(...))."""
    col, lit, F = api.col, api.lit, api.F
    c = col("l_comment")
    padded = F.concat(lit("  "), c, lit(" "))
    return (df.filter(col("l_quantity") < lit(RX_ROWS_QTY))
            .select(col("l_orderkey"), F.trim(padded).alias("trim"),
                    F.ltrim(padded).alias("ltrim"),
                    F.rtrim(padded).alias("rtrim"),
                    F.initcap(c).alias("initcap"), F.ascii(c).alias("ascii"),
                    F.instr(c, "ly").alias("instr"),
                    F.locate("ly", c).alias("locate"),
                    F.repeat(F.left(c, 4), 3).alias("rep"),
                    F.octet_length(c).alias("octets"),
                    F.bit_length(c).alias("bits"),
                    F.left(c, 5).alias("left5"), F.right(c, 5).alias("right5"),
                    F.chr_(col("l_quantity").cast(api.T.INT32) + lit(64))
                    .alias("chr"),
                    F.upper(F.trim(padded)).alias("upper_trim"),
                    F.crc32(c).alias("crc"),
                    F.hive_hash(c, col("l_quantity")).alias("hive")))


#: rx_cpu_rows_fb's output columns, after l_orderkey
RX_CPU_COLS = ("md5", "sha2", "lpad", "translate", "subidx", "concat_ws",
               "soundex", "lev", "b64", "hex", "ly_words")


def rx_cpu_rows_fb(api, df):
    """The CPU row functions over a few lines: the filter on the device,
    one Project on the CPU."""
    col, lit, F = api.col, api.lit, api.F
    c = col("l_comment")
    return (df.filter((col("l_quantity") == lit(1.0))
                      & (col("l_orderkey") % lit(RX_CPU_MOD) == lit(0)))
            .select(col("l_orderkey"), F.md5(c).alias("md5"),
                    F.sha2(c, 256).alias("sha2"),
                    F.lpad(c, 50, "*").alias("lpad"),
                    F.translate(c, "aeiou", "AEI").alias("translate"),
                    F.substring_index(c, " ", 2).alias("subidx"),
                    F.concat_ws("|", col("l_returnflag"), c)
                    .alias("concat_ws"),
                    F.soundex(c).alias("soundex"),
                    F.levenshtein(c, lit("quickly")).alias("lev"),
                    F.base64(c).alias("b64"), F.hex(c).alias("hex"),
                    F.regexp_extract_all(c, "([a-z]+)ly", 1)
                    .alias("ly_words")))


def rx_q13_fb(api, df):
    """Q13's NOT LIKE over the l_quantity = 1 lines, counted per flag
    pair: the l_quantity filter on the device, the LIKE filter on the
    CPU."""
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(col("l_quantity") == lit(1.0))
            .filter(~F.like(col("l_comment"), RX_Q13))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.count().alias("n")))


#: sql_regex: the LIKE and RLIKE filters and the extraction as SQL, with
#: trim and initcap on the extracted word (the SQL grammar groups by
#: columns, so the word comes from a WITH)
SQL_REGEX = ("WITH r AS (SELECT initcap(trim(regexp_extract(l_comment, "
             "'([a-z]+)ly ', 1))) AS w, l_quantity FROM lineitem_text "
             "WHERE l_comment LIKE '_u%' AND "
             "rlike(l_comment, 'b(l|r)[a-z]+ly')) "
             "SELECT w, COUNT(*) AS n, SUM(l_quantity) AS q FROM r "
             "GROUP BY w")


# ---------------------------------------------------------------------------
# The nested types: orders_nested, one row per order with its lines inside
# ---------------------------------------------------------------------------

#: the flag pairs in key order (returnflag then linestatus)
FLAG_PAIRS = ("AF", "AO", "NF", "NO", "RF", "RO")
#: l_price is null for the orders whose key is a multiple of this
NX_NULL_PRICE_MOD = 97
#: nx_array_rows, nx_struct_map's rows and nx_sibling_fb: o_orderkey % 100
#: == 7 (about 1% of the orders)
NX_ROWS_MOD, NX_ROWS_REM = 100, 7
#: nx_cpu_collections_fb: o_orderkey % 300 == 0, orders with lines
NX_CPU_MOD = 300
#: each query's plan node on the CPU (nx_cpu_collections_fb's projection
#: of the host-tier functions and map_entries; nx_sibling_fb's and
#: ingest_generate's Generate, which carries an array column)
NX_FALLBACK_NODES = {"nx_cpu_collections_fb": "Project",
                     "nx_sibling_fb": "Generate",
                     "ingest_generate": "Generate"}
#: the set operations' second operand in nx_array_rows
NX_SET = (1.0, 2.0, 3.0)


def make_orders_nested(lineitem: pa.Table, orders: pa.Table) -> pa.Table:
    """orders_nested: one row per order (o_orderkey, o_custkey), o_info a
    struct<orderdate: date, custkey: long>, its lines' quantities, prices
    and ship dates as three aligned arrays in lineitem order (l_price null
    where o_orderkey % NX_NULL_PRICE_MOD == 0; Arrow keeps those rows'
    slices, as a writer may), and o_flag_qty a map from each flag pair
    present in the order to its summed quantity, keys sorted. Built on the
    host with numpy; orders without lines hold empty arrays and maps."""
    import pyarrow.compute as pc
    key = lineitem["l_orderkey"].to_numpy()
    n = orders.num_rows
    order = np.argsort(key, kind="stable")
    off = np.zeros(n + 1, np.int32)
    off[1:] = np.cumsum(np.bincount(key, minlength=n))
    okey = orders["o_orderkey"].to_numpy()
    offsets = pa.array(off)
    qty = lineitem["l_quantity"].to_numpy()
    price = lineitem["l_extendedprice"].to_numpy()[order]
    ship = pa.array(lineitem["l_shipdate"].to_numpy()[order]).cast(
        pa.date32())
    code = (pc.equal(lineitem["l_returnflag"], "N").to_numpy().astype(
        np.int64) * 2 + pc.equal(lineitem["l_returnflag"], "R").to_numpy()
        .astype(np.int64) * 4 + pc.equal(lineitem["l_linestatus"], "O")
        .to_numpy().astype(np.int64))
    comb = key * 6 + code
    sums = np.bincount(comb, weights=qty, minlength=6 * n)
    present = np.bincount(comb, minlength=6 * n) > 0
    idx = np.flatnonzero(present)
    moff = np.zeros(n + 1, np.int32)
    moff[1:] = np.cumsum(present.reshape(n, 6).sum(axis=1))
    keys = pa.DictionaryArray.from_arrays(
        pa.array((idx % 6).astype(np.int32)),
        pa.array(list(FLAG_PAIRS))).cast(pa.string())
    info = pa.StructArray.from_arrays(
        [orders["o_orderdate"].combine_chunks().cast(pa.date32()),
         orders["o_custkey"].combine_chunks()],
        names=["orderdate", "custkey"])
    return pa.table({
        "o_orderkey": okey,
        "o_custkey": orders["o_custkey"],
        "o_info": info,
        "l_qty": pa.ListArray.from_arrays(offsets, pa.array(qty[order])),
        "l_price": pa.ListArray.from_arrays(
            offsets, pa.array(price),
            mask=pa.array(okey % NX_NULL_PRICE_MOD == 0)),
        "l_ship": pa.ListArray.from_arrays(offsets, ship),
        "o_flag_qty": pa.MapArray.from_arrays(pa.array(moff), keys,
                                              pa.array(sums[idx])),
    })


def orders_nested_flat(nested: pa.Table) -> pa.Table:
    """ingest_generate's Parquet input: the orders of nx_array_rows' filter
    with the order date and the prices (a plan document has no struct
    field access, and its Generate carries every child column)."""
    import pyarrow.compute as pc
    keep = pc.equal(pc.subtract(nested["o_orderkey"], pc.multiply(
        pc.divide(nested["o_orderkey"], NX_ROWS_MOD), NX_ROWS_MOD)),
        NX_ROWS_REM)
    sub = nested.filter(keep)
    return pa.table({"o_orderdate": pc.struct_field(sub["o_info"], [0]),
                     "l_price": sub["l_price"]})


def nx_explode_daily(api, df, n=8):
    """Each order's prices exploded beside its order date, hash-
    repartitioned by the date, summed and counted per day."""
    col, F = api.col, api.F
    return (df.select(col("o_info").getField("orderdate").alias("d"),
                      F.explode(col("l_price")).alias("p"))
            .repartition(n, col("d"))
            .group_by(col("d"))
            .agg(F.sum("p").alias("s"), F.count("p").alias("c")))


def nx_posexplode_outer(api, df):
    """posexplode_outer of the prices grouped by position: rows, non-null
    prices and their sum (a null or empty array gives one null row)."""
    col, F = api.col, api.F
    return (df.select(F.posexplode_outer(col("l_price")))
            .group_by(col("pos"))
            .agg(F.count().alias("rows"), F.count("col").alias("n"),
                 F.sum("col").alias("s")))


#: nx_array_rows' output columns, after o_orderkey
NX_ARRAY_COLS = ("n", "e1", "em1", "e40", "g0", "c25", "pmin", "pmax",
                 "smax", "sa", "sd", "sl", "ad", "ap", "ar", "ov", "au",
                 "ai", "ae")


def nx_array_rows(api, df):
    col, lit, F = api.col, api.lit, api.F
    q, p = col("l_qty"), col("l_price")
    small = F.array(*[lit(v) for v in NX_SET])
    return (df.filter(col("o_orderkey") % lit(NX_ROWS_MOD)
                      == lit(NX_ROWS_REM))
            .select(col("o_orderkey"), F.size(q).alias("n"),
                    F.element_at(q, 1).alias("e1"),
                    F.element_at(q, -1).alias("em1"),
                    F.element_at(q, 40).alias("e40"),
                    q.getItem(0).alias("g0"),
                    F.array_contains(q, 25.0).alias("c25"),
                    F.array_min(p).alias("pmin"),
                    F.array_max(p).alias("pmax"),
                    F.array_max(col("l_ship")).alias("smax"),
                    F.sort_array(q).alias("sa"),
                    F.sort_array(q, False).alias("sd"),
                    F.slice(q, 2, 3).alias("sl"),
                    F.array_distinct(q).alias("ad"),
                    F.array_position(q, lit(10.0)).alias("ap"),
                    F.array_remove(q, lit(1.0)).alias("ar"),
                    F.arrays_overlap(q, small).alias("ov"),
                    F.array_union(q, small).alias("au"),
                    F.array_intersect(q, small).alias("ai"),
                    F.array_except(q, small).alias("ae")))


def nx_struct_rows(api, df):
    """nx_struct_map's rows: the struct's fields and the map's keys,
    values, size and the value of 'NO', over nx_array_rows' filter."""
    col, lit, F = api.col, api.lit, api.F
    m = col("o_flag_qty")
    return (df.filter(col("o_orderkey") % lit(NX_ROWS_MOD)
                      == lit(NX_ROWS_REM))
            .select(col("o_orderkey"),
                    col("o_info").getField("orderdate").alias("od"),
                    col("o_info").get_field("custkey").alias("ck"),
                    F.map_keys(m).alias("mk"), F.map_values(m).alias("mv"),
                    F.element_at(m, "NO").alias("no"),
                    m.getItem("RF").alias("rf"),
                    F.size(m).alias("ms")))


def nx_map_groups(api, df):
    """nx_struct_map's aggregate: every order's map exploded, the
    quantities summed and the entries counted per flag pair."""
    col, F = api.col, api.F
    return (df.select(F.explode(col("o_flag_qty")))
            .group_by(col("key"))
            .agg(F.sum("value").alias("q"), F.count("value").alias("n")))


def nx_stack(api, li):
    """stack(2, ...) unpivots the quantity and the price of every line,
    then one sum and count per label."""
    col, lit, F = api.col, api.lit, api.F
    return (li.select(F.stack(2, lit("qty"), col("l_quantity"),
                              lit("price"), col("l_extendedprice")))
            .group_by(col("col0"))
            .agg(F.sum("col1").alias("s"), F.count("col1").alias("c")))


#: nx_cpu_collections_fb's output columns, after o_orderkey
NX_CPU_COLS = ("z", "j", "r", "sq", "mfa", "mc", "sm", "me")


def nx_cpu_collections_fb(api, df):
    """The host-tier collection functions and map_entries (an
    array<struct> result, which the signatures keep off the device) over
    about 10,000 orders: the filter on the device, one Project on the
    CPU."""
    col, lit, F = api.col, api.lit, api.F
    q, m = col("l_qty"), col("o_flag_qty")
    seq = F.sequence(lit(1), F.size(q))
    return (df.filter((col("o_orderkey") % lit(NX_CPU_MOD) == lit(0))
                      & (F.size(q) > lit(0)))
            .select(col("o_orderkey"),
                    F.arrays_zip(q, col("l_ship")).alias("z"),
                    F.array_join(F.map_keys(m), ",").alias("j"),
                    F.array_repeat(col("o_custkey"), lit(2)).alias("r"),
                    seq.alias("sq"),
                    F.map_from_arrays(seq, q).alias("mfa"),
                    F.map_concat(m, F.map_from_arrays(
                        F.array(lit("ZZ")), F.array(lit(0.5)))).alias("mc"),
                    F.str_to_map(F.array_join(F.map_keys(m), ","), ",",
                                 "=").alias("sm"),
                    F.map_entries(m).alias("me")))


def nx_sibling_fb(api, df):
    """An explode carrying another array column (the CPU Generate), over
    nx_array_rows' filter, grouped by the carried array's size."""
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(col("o_orderkey") % lit(NX_ROWS_MOD)
                      == lit(NX_ROWS_REM))
            .select(col("l_qty"), F.explode(col("l_price")).alias("p"))
            .select(F.size(col("l_qty")).alias("n"), col("p"))
            .group_by(col("n"))
            .agg(F.sum("p").alias("s"), F.count("p").alias("c")))


def nx_view(api, df):
    """sql_nested's temp view: the order date out of the struct (the SQL
    grammar has no struct field access) and the prices."""
    col = api.col
    return df.select(col("o_orderkey"),
                     col("o_info").getField("orderdate").alias("o_orderdate"),
                     col("l_price"))


SQL_NESTED = ("SELECT d, SUM(p) AS s, COUNT(p) AS c FROM (SELECT o_orderdate "
              "AS d, explode(l_price) AS p FROM orders_nested) GROUP BY d")


def nx_generate_doc(path: str) -> dict:
    """ingest_generate's plan document: a Parquet scan of
    orders_nested_flat, the explode of the prices, the daily sum and
    count."""
    def c(name):
        return {"expr": "col", "name": name}
    return {"version": 1, "plan": {
        "node": "aggregate", "keys": [c("o_orderdate")],
        "aggs": [{"fn": "sum", "child": c("col"), "alias": "s"},
                 {"fn": "count", "child": c("col"), "alias": "c"}],
        "child": {"node": "generate", "generator": "explode",
                  "input": c("l_price"),
                  "child": {"node": "parquet_scan", "paths": [path],
                            "columns": ["o_orderdate", "l_price"]}}}}


# ---------------------------------------------------------------------------
# Lambdas, JSON and the file readers (the formats phase)
# ---------------------------------------------------------------------------

#: lx_fold_fb's and js_to_json_fb's orders: o_orderkey % 300 == 0
LX_FOLD_MOD = 300
#: the plan nodes of each formats shape on the CPU, top down: the host
#: tier (the JSON parse, the fold)
FORMATS_CPU_NODES = {"lx_fold_fb": ["Project"],
                     "js_path_rows": ["Project"],
                     "js_from_json": ["Project"],
                     "js_to_json_fb": ["Project"]}


def lx_array_preds(api, df):
    """Per order year: the orders, and the sums of four lambdas over the
    line arrays (a filter's size, exists, forall against the order's own
    date: an outer reference, and a filter of an indexed transform)."""
    col, lit, F, T = api.col, api.lit, api.F, api.T
    od = col("o_info").getField("orderdate")
    return (df.select(
        F.year(od).alias("y"),
        F.size(F.filter(col("l_price"), lambda p: p > lit(50000.0)))
        .alias("hi"),
        F.exists(col("l_qty"), lambda q: q >= lit(50.0)).cast(T.INT64)
        .alias("big"),
        F.forall(col("l_ship"), lambda d: d > od).cast(T.INT64)
        .alias("late"),
        F.size(F.filter(F.transform(col("l_qty"), lambda q, i: q * i),
                        lambda v: v > lit(100.0))).alias("heavy"))
        .group_by(col("y"))
        .agg(F.count(col("y")).alias("n"), F.sum("hi").alias("hi"),
             F.sum("big").alias("big"), F.sum("late").alias("late"),
             F.sum("heavy").alias("heavy")))


def lx_zip_explode(api, df):
    """zip_with of the prices and quantities, exploded, summed and counted
    per order year (an order with null prices has a null product array,
    which explodes to no row)."""
    col, F = api.col, api.F
    return (df.select(
        F.year(col("o_info").getField("orderdate")).alias("y"),
        F.explode(F.zip_with(col("l_price"), col("l_qty"),
                             lambda p, q: p * q)).alias("pq"))
        .group_by(col("y"))
        .agg(F.sum("pq").alias("s"), F.count("pq").alias("n")))


def lx_map_lambdas(api, df):
    """transform_values, map_filter and transform_keys (lower(k)) over the
    flag-pair map, exploded and summed per key."""
    col, lit, F = api.col, api.lit, api.F
    m = F.transform_keys(
        F.map_filter(F.transform_values(col("o_flag_qty"),
                                        lambda k, v: v * lit(2.0)),
                     lambda k, v: v > lit(10.0)),
        lambda k, v: F.lower(k))
    return (df.select(F.explode(m))
            .group_by(col("key"))
            .agg(F.sum("value").alias("q"), F.count("value").alias("n")))


def lx_fold_fb(api, df):
    """aggregate() (a CPU fold) over about one order in 300: the filter on
    the device, the Project on the CPU."""
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(col("o_orderkey") % lit(LX_FOLD_MOD) == lit(0))
            .select(col("o_orderkey"),
                    F.aggregate(col("l_qty"), lit(0.0),
                                lambda acc, x: acc + x,
                                lambda acc: acc / lit(2.0)).alias("half")))


def orders_json_lines(lineitem: pa.Table, orders: pa.Table, n: int) -> list:
    """The first ``n`` orders as JSON documents, one a line, with their
    lines nested as orders_nested carries them, three aligned arrays in
    lineitem order: {"orderkey", "custkey", "orderdate" (ISO), "qty",
    "price", "flag"} (the flag the returnflag and linestatus pair). Built
    with numpy and string formatting."""
    import datetime
    key = lineitem["l_orderkey"].to_numpy()
    keep = np.flatnonzero(key < n)
    keep = keep[np.argsort(key[keep], kind="stable")]
    k = key[keep]
    qty = [repr(v) for v in lineitem["l_quantity"].to_numpy()[keep].tolist()]
    price = [repr(v) for v in
             lineitem["l_extendedprice"].to_numpy()[keep].tolist()]
    flag = ['"' + a + b + '"' for a, b in zip(
        lineitem["l_returnflag"].to_numpy(False)[keep].tolist(),
        lineitem["l_linestatus"].to_numpy(False)[keep].tolist())]
    bounds = np.searchsorted(k, np.arange(n + 1)).tolist()
    odate = orders["o_orderdate"].to_numpy()[:n]
    cust = orders["o_custkey"].to_numpy()[:n].tolist()
    epoch = datetime.date(1970, 1, 1)
    days = {int(d): (epoch + datetime.timedelta(days=int(d))).isoformat()
            for d in np.unique(odate)}
    out = []
    for o in range(n):
        a, b = bounds[o], bounds[o + 1]
        out.append(f'{{"orderkey":{o},"custkey":{cust[o]},"orderdate":'
                   f'"{days[int(odate[o])]}","qty":[{",".join(qty[a:b])}],'
                   f'"price":[{",".join(price[a:b])}],'
                   f'"flag":[{",".join(flag[a:b])}]}}')
    return out


#: fm_json_lines' and js_from_json's group keys: orderkey % these (12-bit
#: keys: the segsum route takes keys of 11 to 24 bits)
FM_JSON_MOD, JS_MOD = 4096, 4096


def fm_json_lines(api, df, n=8):
    """read_json's orders: the prices exploded beside an int32 key of the
    order, hash-repartitioned by it, summed and counted per key."""
    col, lit, F, T = api.col, api.lit, api.F, api.T
    lines = df.select(
        (col("orderkey") % lit(FM_JSON_MOD)).cast(T.INT32).alias("b"),
        F.explode(col("price")).alias("p"))
    return (lines.repartition(n, col("b"))
            .group_by(col("b"))
            .agg(F.sum("p").alias("s"), F.count("p").alias("n")))


def js_path_rows(api, df):
    """get_json_object and json_tuple over the documents (CPU Project)."""
    col, F = api.col, api.F
    return df.select(
        F.get_json_object(col("doc"), "$.price[0]").alias("p0"),
        F.json_tuple(col("doc"), "orderkey", "custkey").alias("jt"))


def js_from_json(api, df):
    """from_json of each document's prices into array<double> (CPU
    Project: the host parse), exploded beside a key of the order and
    summed per key on the device."""
    col, lit, F, T = api.col, api.lit, api.F, api.T
    parsed = df.select(
        (F.get_json_object(col("doc"), "$.orderkey").cast(T.INT64)
         % lit(JS_MOD)).alias("g"),
        F.from_json(F.get_json_object(col("doc"), "$.price"),
                    T.ArrayType(T.FLOAT64)).alias("pr"))
    return (parsed.select(col("g"), F.explode(col("pr")).alias("p"))
            .group_by(col("g"))
            .agg(F.sum("p").alias("s"), F.count("p").alias("n")))


def js_to_json_fb(api, df):
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(col("o_orderkey") % lit(LX_FOLD_MOD) == lit(0))
            .select(col("o_orderkey"), F.to_json(col("o_info")).alias("j")))


NULL_SQL = ("SELECT l_returnflag, NULL AS z, count(*) AS n FROM lineitem "
            "WHERE l_returnflag IN ('A', NULL) GROUP BY l_returnflag")


def write_hive_lineitem(lineitem: pa.Table, root: str, **write_kw) -> int:
    """lineitem in a l_returnflag=/l_linestatus= layout, one Parquet file
    a pair (the partition columns out of the files, row groups of 2^20
    rows unless ``write_kw`` says otherwise), the six files written on
    six threads; returns the files."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    rest = [c for c in lineitem.column_names
            if c not in ("l_returnflag", "l_linestatus")]

    def write(pair):
        f, st = pair
        sub = lineitem.filter(pc.and_(
            pc.equal(lineitem["l_returnflag"], f),
            pc.equal(lineitem["l_linestatus"], st))).select(rest)
        d = os.path.join(root, f"l_returnflag={f}", f"l_linestatus={st}")
        os.makedirs(d, exist_ok=True)
        pq.write_table(sub, os.path.join(d, "part-0.parquet"),
                       **{"row_group_size": 1 << 20, **write_kw})
    pairs = [(f, st) for f in "ANR" for st in "FO"]
    with ThreadPoolExecutor(len(pairs)) as pool:
        list(pool.map(write, pairs))
    return len(pairs)


def fm_hive_pruned(api, df):
    """q6 with l_returnflag = 'R': the partition filter prunes files."""
    col, lit = api.col, api.lit
    return q6(api, df.filter(col("l_returnflag") == lit("R")))


def orders_by_year(api, df):
    """The orders read back from ORC or Avro, counted and their customer
    keys summed per order year."""
    col, F = api.col, api.F
    return (df.select(F.year(col("o_orderdate")).alias("y"),
                      col("o_custkey"))
            .group_by(col("y"))
            .agg(F.count(col("o_custkey")).alias("n"),
                 F.sum("o_custkey").alias("c")))


def text_scan_doc(path: str) -> dict:
    """ingest_text_scan's plan document: a CSV scan, the lines counted and
    the quantity summed per return flag."""
    def c(name):
        return {"expr": "col", "name": name}
    return {"version": 1, "plan": {
        "node": "aggregate", "keys": [c("l_returnflag")],
        "aggs": [{"fn": "sum", "child": c("l_quantity"), "alias": "q"},
                 {"fn": "count", "child": c("l_quantity"), "alias": "n"}],
        "child": {"node": "text_scan", "format": "csv", "paths": [path]}}}


def reset_torch_runtime() -> None:
    """Reset the port's process-global runtime state, as tests/conftest.py's
    autouse fixture does for the JAX package: the semaphore, the spill
    framework, the OOM injector and the retry backoff, the fault schedule,
    the watchdog and breaker, the cancel tokens, the admission gate and
    the deadline sweeper, the per-query task totals, the thread's
    query binding, the live layer (the obs registry, endpoint and
    sampler thread, the live query registry, the flight recorder), the
    kernel cost auditor (disarmed, its records kept), the warmup manager
    and the kernel build directory."""
    from spark_rapids_tpu_torch import config as TC
    from spark_rapids_tpu_torch.runtime import faults, lifecycle, task
    from spark_rapids_tpu_torch.runtime import watchdog
    from spark_rapids_tpu_torch.runtime.memory import reset_spill_framework
    from spark_rapids_tpu_torch.runtime.retry import OomInjector, set_backoff
    from spark_rapids_tpu_torch.runtime.semaphore import reset_semaphore
    reset_semaphore()
    reset_spill_framework()
    OomInjector.configure(0)
    faults.configure("")
    set_backoff(10.0, 500.0)
    watchdog.uninstall_for_tests()
    lifecycle.reset_for_tests()
    lifecycle.bind(None)
    task.reset_for_tests()
    TC.set_session_conf(None)
    from spark_rapids_tpu_torch.runtime import obs
    from spark_rapids_tpu_torch.runtime.obs import flight
    obs.shutdown_for_tests()
    flight.uninstall_for_tests()
    from spark_rapids_tpu_torch.analysis import kernel_audit
    from spark_rapids_tpu_torch.runtime import compile_cache, warmup
    kernel_audit.reset_for_tests()
    warmup.reset_for_tests()
    compile_cache.reset_build_dir_for_tests()


# ---------------------------------------------------------------------------
# the UDF tier: the functions and query shapes of tests/test_torch_udf.py
# and chip_smoke.py's udf phase (the functions live here, at module level,
# so the worker pool can unpickle them by reference)
# ---------------------------------------------------------------------------

#: the plan node a row-UDF query runs on the CPU
UDF_FALLBACK_NODE = "Project"
#: udf_row_pool's lines: the first 1M
UDF_ROW_LINES = 1_000_000


def charge(p, d, t):
    """TPC-H's charge, a body the bytecode compiler translates."""
    return p * (1.0 - d) * (1.0 + t)


def qty_if_cheap(q, d):
    """A columnar UDF written with operators only, so it runs on jnp
    arrays and on torch tensors alike: (values, validity) pairs in,
    2q - 1 out, valid where both inputs are and the discount is below
    0.095 (its own validity). The values are integers, so their sums are
    exact in any order."""
    (qv, qok), (dv, dok) = q, d
    return qv * 2.0 - 1.0, qok & dok & (dv < 0.095)


def flag_tag(flag, status):
    """An opaque row UDF: a string method call is outside the compiler's
    subset, so it runs on the CPU row tier."""
    if flag is None or status is None:
        return None
    return None if flag == "N" else (flag + status).lower()


def worker_environment(_row):
    """What a pool worker process has loaded: (any JAX or JAX-package
    module, CUDA initialised)."""
    import sys
    jax_loaded = any(m.split(".")[0] in ("jax", "jaxlib", "spark_rapids_tpu")
                     for m in sys.modules)
    torch = sys.modules.get("torch")
    cuda = bool(torch is not None and torch.cuda.is_initialized())
    return jax_loaded, cuda


def _tax(api):
    """A TPC-H-like tax rate per line, 0.00-0.08, from the order key
    (bench.py's lineitem has no l_tax)."""
    col, lit, T = api.col, api.lit, api.T
    return (col("l_orderkey") % lit(9)).cast(T.FLOAT64) / lit(100.0)


def udf_q72_compiled(api, df):
    """q72shfl's grouping of the compiled charge per line."""
    col, lit, F, T = api.col, api.lit, api.F, api.T
    f = api.udf(charge, return_type=T.FLOAT64)
    return (df.select((col("l_orderkey") % lit(100_000)).alias("k"),
                      f(col("l_extendedprice"), col("l_discount"),
                        _tax(api)).alias("v"))
            .group_by(col("k"))
            .agg(F.sum("v").alias("s"), F.count("v").alias("c")))


def udf_repart_columnar(api, df, n=8):
    """A columnar UDF with its own validity, then a hash exchange of an
    int key (the murmur3 kernel) and a grouping of ~100,000 keys."""
    col, lit, F, T = api.col, api.lit, api.F, api.T
    f = api.col_udf(qty_if_cheap, return_type=T.FLOAT64)
    k = (col("l_orderkey") % lit(100_000)).cast(T.INT32).alias("k")
    return (df.select(k, f(col("l_quantity"), col("l_discount")).alias("v"))
            .repartition(n, col("k"))
            .group_by(col("k"))
            .agg(F.sum("v").alias("s"), F.count("v").alias("c")))


def udf_row_flags(api, df):
    """The opaque row UDF in a Project (on the CPU), then a grouping of
    its output on the device."""
    col, F, T = api.col, api.F, api.T
    f = api.udf(flag_tag, return_type=T.STRING)
    return (df.select(f(col("l_returnflag"), col("l_linestatus")).alias("t"),
                      col("l_quantity"))
            .group_by(col("t"))
            .agg(F.sum("l_quantity").alias("q"), F.count("l_quantity")
                 .alias("n")))


def late_qty(q, s):
    """One body for both tiers: the compiler translates it, and it runs
    as it is on the row tier (integer-valued results: sums are exact)."""
    return q * 2.0 if s > 9000 else q


def udf_late_qty(api, df):
    col, F, T = api.col, api.F, api.T
    f = api.udf(late_qty, return_type=T.FLOAT64)
    return (df.select(col("l_returnflag"),
                      f(col("l_quantity"), col("l_shipdate")).alias("v"))
            .group_by(col("l_returnflag"))
            .agg(F.sum("v").alias("s"), F.count("v").alias("n")))


def udf_row_flags_answer(t: pa.Table) -> dict:
    """udf_row_flags by a plain Python loop: {tag: (sum, count)}."""
    out: dict = {}
    for f, st, q in zip(t.column("l_returnflag").to_pylist(),
                        t.column("l_linestatus").to_pylist(),
                        t.column("l_quantity").to_pylist()):
        key = flag_tag(f, st)
        s, c = out.get(key, (0.0, 0))
        out[key] = (s + q, c + 1)
    return out


# ---------------------------------------------------------------------------
# Stage fusion: the smoke's fusion phase
# ---------------------------------------------------------------------------

#: the columns the fusion phase's Parquet queries read
FUSION_Q6_COLS = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
FUSION_LIMIT_COLS = ("l_orderkey", "l_quantity", "l_extendedprice",
                     "l_discount")
FUSION_LIMIT_N = 100
FUSION_LIMIT_QTY = 10.0


#: the fusion groups the JAX package plans for each fusion-phase query
#: (``plan_verify.dispatch_budget``'s ``fusion_groups``, child-most
#: first; held against the JAX package by tests/test_torch_stage_fusion.py)
FUSION_EXPECT = {
    "q6": [],
    "q1": [],
    "pq_q6": [{"kind": "absorbed",
               "members": ["DeviceDecodeScanExec", "HashAggregateExec"]}],
    "q72shfl": [],
    "q72shfl_repart": [],
    "rollup_shipdate": [{"kind": "fused",
                         "members": ["ProjectExec", "ProjectExec",
                                     "ExpandExec"]}],
    "limit_chain": [{"kind": "fused",
                     "members": ["DeviceDecodeScanExec", "FilterExec",
                                 "ProjectExec", "LimitExec"]}],
}


def limit_chain(api, df, n=FUSION_LIMIT_N, qty=FUSION_LIMIT_QTY):
    """Filter -> Project -> LIMIT n: the first n lines (in input order)
    with l_quantity above ``qty``, with their net price."""
    col, lit = api.col, api.lit
    return (df.filter(col("l_quantity") > lit(qty))
            .select(col("l_orderkey"),
                    (col("l_extendedprice") * (lit(1.0) - col("l_discount")))
                    .alias("net"))
            .limit(n))


def fusion_queries(api) -> dict:
    """name -> build(session, cached lineitem, Parquet path) -> DataFrame:
    the fusion phase's queries, each run with
    spark.rapids.sql.stageFusion.enabled off and on. The Parquet queries
    read through the session's default decode route (on the device)."""
    def pq(cols, fn):
        return lambda s, cached, path: fn(
            api, s.read_parquet(path, columns=list(cols)))

    return {
        "q6": lambda s, cached, path: q6(api, cached),
        "q1": lambda s, cached, path: q1(api, cached),
        "pq_q6": pq(FUSION_Q6_COLS, q6),
        "q72shfl": lambda s, cached, path: q72shfl(api, cached),
        "q72shfl_repart": lambda s, cached, path: q72shfl_repart(api,
                                                                 cached),
        "rollup_shipdate": lambda s, cached, path: rollup_shipdate(api,
                                                                   cached),
        "limit_chain": pq(FUSION_LIMIT_COLS, limit_chain),
    }


def limit_chain_answer(lineitem: pa.Table, n=FUSION_LIMIT_N,
                       qty=FUSION_LIMIT_QTY) -> dict:
    """limit_chain's rows with numpy: the first n qualifying lines in file
    order."""
    q = lineitem.column("l_quantity").to_numpy()
    idx = np.flatnonzero(q > qty)[:n]
    price = lineitem.column("l_extendedprice").to_numpy()[idx]
    disc = lineitem.column("l_discount").to_numpy()[idx]
    return {"l_orderkey": lineitem.column("l_orderkey").to_numpy()[idx]
            .tolist(), "net": (price * (1.0 - disc)).tolist()}
