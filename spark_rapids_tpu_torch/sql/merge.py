"""MERGE INTO: Delta-style upsert on the engine (counterpart of
``spark_rapids_tpu/sql/merge.py``).

Reference parity: delta-lake/delta-24x/.../GpuMergeIntoCommand.scala
(deletion-vector-free merge): the merged table is built from
 - matched target rows transformed by WHEN MATCHED UPDATE/DELETE clauses,
 - unmatched target rows carried through unchanged,
 - source rows with no target match inserted by WHEN NOT MATCHED,
with the Delta cardinality check: a target row matched by MULTIPLE source
rows while an UPDATE/DELETE clause exists is an error
(DELTA_MULTIPLE_SOURCE_ROW_MATCHING_TARGET_ROW_IN_MERGE).

Device-first shape: one left join (target x renamed source) evaluates
every matched clause as conditional projections; inserts are one anti
join; the result is their union: all existing device operators, no
row-wise command interpreter.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr.core import SparkException, col, lit


class MergeInto:
    """Builder mirroring the Delta merge API:

        MergeInto(target, source, on=["k"]) \\
            .when_matched_update({"v": col("__src_v")}) \\
            .when_not_matched_insert() \\
            .result()

    Inside clause expressions, source columns are visible as
    ``__src_<name>``; target columns keep their names."""

    SRC = "__src_"

    def __init__(self, target, source, on: List[str]):
        if not on:
            raise SparkException("MERGE requires at least one ON key")
        self.target = target
        self.source = source
        self.on = list(on)
        self._update: Optional[Dict[str, E.Expression]] = None
        self._update_cond: Optional[E.Expression] = None
        self._delete = False
        self._delete_cond: Optional[E.Expression] = None
        self._insert: Optional[Dict[str, E.Expression]] = None
        self._insert_cond: Optional[E.Expression] = None

    # -- clause builders ---------------------------------------------------
    def when_matched_update(self, set: Dict[str, object],  # noqa: A002
                            condition=None) -> "MergeInto":
        self._update = {k: _e(v) for k, v in set.items()}
        self._update_cond = _e(condition) if condition is not None else None
        return self

    def when_matched_delete(self, condition=None) -> "MergeInto":
        self._delete = True
        self._delete_cond = _e(condition) if condition is not None else None
        return self

    def when_not_matched_insert(self, values: Optional[Dict[str, object]] = None,
                                condition=None) -> "MergeInto":
        self._insert = ({k: _e(v) for k, v in values.items()}
                        if values is not None else {})
        self._insert_cond = _e(condition) if condition is not None else None
        return self

    # -- execution ---------------------------------------------------------
    def _renamed_source(self):
        s = self.source
        return s.select(*[col(n).alias(self.SRC + n)
                          for n in s.plan.schema.names])

    def _check_cardinality(self) -> None:
        """Delta: an UPDATE/DELETE clause + a target row matched by more
        than one source row is an error."""
        from spark_rapids_tpu_torch.sql import functions as F
        if self._update is None and not self._delete:
            return
        dup = (self.source.join(self.target.select(
                   *[col(k) for k in self.on]).distinct(),
                   on=self.on, how="left_semi")
               .group_by(*[col(k) for k in self.on])
               .agg(F.count().alias("__n"))
               .filter(col("__n") > lit(1)))
        if dup.count() > 0:
            raise SparkException(
                "MERGE INTO: a target row was matched by multiple source "
                "rows with an UPDATE/DELETE clause (Delta "
                "DELTA_MULTIPLE_SOURCE_ROW_MATCHING_TARGET_ROW_IN_MERGE)")

    def result(self):
        """The merged table as a DataFrame (collect/write it)."""
        self._check_cardinality()
        tnames = self.target.plan.schema.names
        src = self._renamed_source()
        pairs = [(col(k), col(self.SRC + k)) for k in self.on]
        j = self.target.join(src, on=pairs, how="left")
        matched = col(self.SRC + self.on[0]).is_not_null()

        # WHEN MATCHED DELETE: drop matching target rows (condition-gated)
        keep = lit(True)
        if self._delete:
            dcond = matched if self._delete_cond is None \
                else (matched & self._delete_cond)
            keep = ~dcond
        out = j.filter(keep) if self._delete else j

        # WHEN MATCHED UPDATE: conditional projections per target column
        projs = []
        for n in tnames:
            e = col(n)
            if self._update is not None and n in self._update:
                ucond = matched if self._update_cond is None \
                    else (matched & self._update_cond)
                schema = self.target.plan.schema
                e = E.If(ucond, self._update[n].cast(
                    schema.fields[schema.names.index(n)].dtype), col(n))
            projs.append(e.alias(n))
        merged_target = out.select(*projs)

        if self._insert is None:
            return merged_target

        # WHEN NOT MATCHED INSERT: source anti-join target on keys
        anti = self.source.join(
            self.target.select(*[col(k) for k in self.on]).distinct(),
            on=self.on, how="left_anti")
        if self._insert_cond is not None:
            anti = anti.filter(self._insert_cond)
        snames = set(self.source.plan.schema.names)
        ins = []
        for f in self.target.plan.schema.fields:
            if f.name in self._insert:
                ins.append(self._insert[f.name].cast(f.dtype).alias(f.name))
            elif f.name in snames:
                ins.append(col(f.name).cast(f.dtype).alias(f.name))
            else:
                ins.append(lit(None).cast(f.dtype).alias(f.name))
        inserts = anti.select(*ins)
        return merged_target.union(inserts)

    def execute_to(self, path: str, partition_by=None, mode: str = "overwrite"):
        """Run the merge and write the merged table back (hive-partitioned
        when partition_by is given) — the write-back half of
        GpuMergeIntoCommand."""
        w = self.result().write.mode(mode)
        if partition_by:
            w = w.partition_by(partition_by)
        w.parquet(path)


def _e(x):
    return x if isinstance(x, E.Expression) else lit(x)


def merge_into(target, source, on: List[str]) -> MergeInto:
    return MergeInto(target, source, on)
