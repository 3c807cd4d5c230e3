"""Aggregation specs for Dataset.groupby / Dataset.aggregate.

Reference capability: python/ray/data/aggregate.py (AggregateFn family:
Count/Sum/Min/Max/Mean/Std) executed by the hash-shuffle aggregate planner
(python/ray/data/_internal/planner/exchange/). Redesign: each aggregate is a
(map-side partial columns, reduce-side merge, finalize) triple evaluated with
pyarrow's native group_by kernels — the combine runs vectorized inside map
tasks, so only tiny partial tables cross the exchange.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

Block = pa.Table


class AggregateFn:
    """One aggregation over a column (or over all rows for Count).

    - ``partial_columns(block)``: named intermediate columns added map-side
    - ``partial_aggs``: pyarrow group_by specs that combine intermediates
      within one partition-map output
    - ``merge_aggs``: specs that merge partials across map outputs
    - ``finalize(table)``: turn merged partials into the final column
    """

    name = "agg"

    def partial_columns(self, block: Block) -> dict:
        return {}

    def partial_aggs(self) -> List[tuple]:
        raise NotImplementedError

    def merge_aggs(self) -> List[tuple]:
        raise NotImplementedError

    def finalize(self, table: pa.Table) -> pa.Array:
        raise NotImplementedError

    def drop_columns(self) -> List[str]:
        """Partial columns to drop from the final table."""
        return []


class Count(AggregateFn):
    def __init__(self):
        self.name = "count()"
        self._c = "__cnt"

    def partial_columns(self, block: Block) -> dict:
        return {self._c: pa.array(np.ones(block.num_rows, dtype=np.int64))}

    def partial_aggs(self) -> List[tuple]:
        return [(self._c, "sum")]

    def merge_aggs(self) -> List[tuple]:
        return [(f"{self._c}_sum", "sum")]

    def finalize(self, table: pa.Table) -> pa.Array:
        return table.column(f"{self._c}_sum_sum").combine_chunks()

    def drop_columns(self) -> List[str]:
        return [f"{self._c}_sum_sum"]


class _SimpleAgg(AggregateFn):
    """sum/min/max: the same kernel at every level."""

    kernel = ""

    def __init__(self, on: str):
        self.on = on
        self.name = f"{self.kernel}({on})"

    def partial_columns(self, block: Block) -> dict:
        return {self.on: block.column(self.on)}

    def partial_aggs(self) -> List[tuple]:
        return [(self.on, self.kernel)]

    def merge_aggs(self) -> List[tuple]:
        return [(f"{self.on}_{self.kernel}", self.kernel)]

    def finalize(self, table: pa.Table) -> pa.Array:
        return table.column(f"{self.on}_{self.kernel}_{self.kernel}").combine_chunks()

    def drop_columns(self) -> List[str]:
        return [f"{self.on}_{self.kernel}_{self.kernel}"]


class Sum(_SimpleAgg):
    kernel = "sum"


class Min(_SimpleAgg):
    kernel = "min"


class Max(_SimpleAgg):
    kernel = "max"


class Mean(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        self.name = f"mean({on})"
        self._s = f"__mean_s_{on}"
        self._c = f"__mean_c_{on}"

    def partial_columns(self, block: Block) -> dict:
        col = block.column(self.on)
        return {
            self._s: col,
            self._c: pc.cast(pc.is_valid(col), pa.int64()),
        }

    def partial_aggs(self) -> List[tuple]:
        return [(self._s, "sum"), (self._c, "sum")]

    def merge_aggs(self) -> List[tuple]:
        return [(f"{self._s}_sum", "sum"), (f"{self._c}_sum", "sum")]

    def finalize(self, table: pa.Table) -> pa.Array:
        s = table.column(f"{self._s}_sum_sum").to_numpy(zero_copy_only=False)
        c = table.column(f"{self._c}_sum_sum").to_numpy(zero_copy_only=False)
        with np.errstate(invalid="ignore", divide="ignore"):
            return pa.array(s / np.maximum(c, 1))

    def drop_columns(self) -> List[str]:
        return [f"{self._s}_sum_sum", f"{self._c}_sum_sum"]


class Std(AggregateFn):
    """Distributed std via (count, sum, sum-of-squares) partials."""

    def __init__(self, on: str, ddof: int = 1):
        self.on = on
        self.ddof = ddof
        self.name = f"std({on})"
        self._s = f"__std_s_{on}"
        self._q = f"__std_q_{on}"
        self._c = f"__std_c_{on}"

    def partial_columns(self, block: Block) -> dict:
        col = block.column(self.on)
        return {
            self._s: col,
            self._q: pc.multiply(col, col),
            self._c: pc.cast(pc.is_valid(col), pa.int64()),
        }

    def partial_aggs(self) -> List[tuple]:
        return [(self._s, "sum"), (self._q, "sum"), (self._c, "sum")]

    def merge_aggs(self) -> List[tuple]:
        return [(f"{self._s}_sum", "sum"), (f"{self._q}_sum", "sum"),
                (f"{self._c}_sum", "sum")]

    def finalize(self, table: pa.Table) -> pa.Array:
        s = table.column(f"{self._s}_sum_sum").to_numpy(zero_copy_only=False).astype(np.float64)
        q = table.column(f"{self._q}_sum_sum").to_numpy(zero_copy_only=False).astype(np.float64)
        c = table.column(f"{self._c}_sum_sum").to_numpy(zero_copy_only=False).astype(np.float64)
        denom = np.maximum(c - self.ddof, 1)
        var = np.maximum((q - s * s / np.maximum(c, 1)) / denom, 0.0)
        return pa.array(np.sqrt(var))

    def drop_columns(self) -> List[str]:
        return [f"{self._s}_sum_sum", f"{self._q}_sum_sum", f"{self._c}_sum_sum"]


def make_partial(block: Block, keys: List[str], aggs: List[AggregateFn]) -> pa.Table:
    """Map-side combine: per-group partials for one input block."""
    cols = {k: block.column(k) for k in keys}
    for agg in aggs:
        cols.update(agg.partial_columns(block))
    specs: List[tuple] = []
    for agg in aggs:
        specs.extend(agg.partial_aggs())
    tbl = pa.table(cols) if cols else block
    if keys:
        return tbl.group_by(keys).aggregate(specs)
    return _global_agg(tbl, specs)


def _global_agg(tbl: pa.Table, specs: List[tuple]) -> pa.Table:
    out = {}
    for col, kernel in specs:
        fn = getattr(pc, kernel)
        out[f"{col}_{kernel}"] = pa.array([fn(tbl.column(col)).as_py()])
    return pa.table(out)


def merge_partials(partials: List[pa.Table], keys: List[str],
                   aggs: List[AggregateFn]) -> pa.Table:
    """Reduce-side merge + finalize for one output partition."""
    non_empty = [p for p in partials if p.num_rows]
    combined = pa.concat_tables(non_empty) if non_empty else partials[0]
    specs: List[tuple] = []
    for agg in aggs:
        specs.extend(agg.merge_aggs())
    if keys:
        merged = combined.group_by(keys).aggregate(specs)
    else:
        merged = _global_agg(combined, specs)
    out_cols: dict = {k: merged.column(k) for k in keys}
    for agg in aggs:
        out_cols[agg.name] = agg.finalize(merged)
    return pa.table(out_cols)
