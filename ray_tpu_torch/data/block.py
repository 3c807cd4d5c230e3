"""Blocks: the unit of data movement (reference: python/ray/data/block.py —
Block = arrow table / pandas df; BlockAccessor for format-generic ops).

Canonical in-memory format is a pyarrow.Table; batches surface as
dict-of-numpy ("numpy", the default), arrow, or pandas.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import pyarrow as pa

Block = pa.Table
Batch = Union[Dict[str, np.ndarray], pa.Table, "pd.DataFrame"]  # noqa: F821


class _PyObjType(pa.ExtensionType):
    """Arbitrary-python-object column: per-row cloudpickle over binary
    storage (reference analogue: ArrowPythonObjectArray extension in
    python/ray/air/util/object_extensions). Carries ragged tensors, mixed
    types, and anything arrow has no native layout for."""

    def __init__(self) -> None:
        super().__init__(pa.binary(), "ray_tpu_torch.pyobj")

    def __arrow_ext_serialize__(self) -> bytes:
        return b""

    @classmethod
    def __arrow_ext_deserialize__(cls, storage_type, serialized):
        return cls()


_PYOBJ_TYPE = _PyObjType()
try:
    pa.register_extension_type(_PYOBJ_TYPE)
except pa.ArrowKeyError:  # re-import (e.g. tests reloading the module)
    pass


def _pyobj_column(values: Any) -> pa.Array:
    import cloudpickle

    storage = pa.array([cloudpickle.dumps(v) for v in values], pa.binary())
    return pa.ExtensionArray.from_storage(_PYOBJ_TYPE, storage)


def _normalize_column(values: Any) -> pa.Array:
    if isinstance(values, pa.Array):
        return values
    try:
        arr = np.asarray(values)
    except ValueError:  # ragged tensors: per-row shapes differ
        return _pyobj_column(values)
    if arr.ndim > 1:
        if arr.dtype == object:
            return _pyobj_column(values)
        # tensor column: shape-preserving canonical arrow extension
        return pa.FixedShapeTensorArray.from_numpy_ndarray(
            np.ascontiguousarray(arr))
    if arr.dtype == object:
        try:
            return pa.array(values)  # str/bytes/None/uniform dicts
        except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
            return _pyobj_column(values)
    return pa.array(arr)


def block_from_batch(batch: Batch) -> Block:
    if isinstance(batch, pa.Table):
        return batch
    if isinstance(batch, dict):
        return pa.table({k: _normalize_column(v) for k, v in batch.items()})
    try:
        import pandas as pd

        if isinstance(batch, pd.DataFrame):
            return pa.Table.from_pandas(batch, preserve_index=False)
    except ImportError:
        pass
    raise TypeError(f"cannot convert {type(batch).__name__} to a block")


def block_from_rows(rows: List[Any], object_columns: Optional[set] = None) -> Block:
    """``object_columns``: column names forced to the pyobj layout even when
    this block's values happen to be uniform — readers whose per-row shapes
    vary GLOBALLY (e.g. native-shape images) must not let a coincidentally-
    uniform block become a tensor column, or blocks get incompatible schemas
    and concat/iter_batches fails."""
    if rows and isinstance(rows[0], dict):
        cols: Dict[str, list] = {}
        for r in rows:
            for k, v in r.items():
                cols.setdefault(k, []).append(v)
        return pa.table({
            k: (_pyobj_column(v) if object_columns and k in object_columns
                else _normalize_column(v))
            for k, v in cols.items()
        })
    return pa.table({"item": _normalize_column(rows)})


class BlockAccessor:
    def __init__(self, block: Block):
        self.block = block

    @classmethod
    def for_block(cls, block: Block) -> "BlockAccessor":
        return cls(block)

    def num_rows(self) -> int:
        return self.block.num_rows

    def size_bytes(self) -> int:
        return self.block.nbytes

    def schema(self) -> pa.Schema:
        return self.block.schema

    def slice(self, start: int, end: int) -> Block:
        return self.block.slice(start, end - start)

    def to_arrow(self) -> pa.Table:
        return self.block

    def to_numpy(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for name in self.block.column_names:
            out[name] = _column_to_numpy(self.block.column(name))
        return out

    def to_pandas(self):
        return self.block.to_pandas()

    def to_batch(self, batch_format: str) -> Batch:
        if batch_format in ("numpy", "default"):
            return self.to_numpy()
        if batch_format in ("pyarrow", "arrow"):
            return self.block
        if batch_format == "pandas":
            return self.to_pandas()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        names = self.block.column_names
        # tensor columns: one bulk decode wins; pyobj columns: decode rows
        # LAZILY so take(1) doesn't unpickle a whole block
        tensors, pyobj = {}, {}
        for name in names:
            col = self.block.column(name)
            if isinstance(col.type, _PyObjType):
                storage = (col.combine_chunks()
                           if isinstance(col, pa.ChunkedArray) else col).storage
                pyobj[name] = storage
            elif _is_special_type(col.type):
                tensors[name] = _column_to_numpy(col)
        import cloudpickle

        def cell(name: str, i: int) -> Any:
            if name in tensors:
                return tensors[name][i]
            if name in pyobj:
                return cloudpickle.loads(pyobj[name][i].as_py())
            return self.block.column(name)[i].as_py()

        for i in range(self.block.num_rows):
            yield {name: cell(name, i) for name in names}


def _is_special_type(t: pa.DataType) -> bool:
    return isinstance(t, (pa.FixedShapeTensorType, _PyObjType)) or (
        pa.types.is_fixed_size_list(t)
    )


def _column_to_numpy(col) -> np.ndarray:
    """ChunkedArray/Array -> numpy, decoding tensor + pyobj extensions."""
    t = col.type
    if isinstance(t, pa.FixedShapeTensorType):
        combined = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
        if isinstance(combined, pa.ChunkedArray):  # empty table edge
            return np.zeros((0,) + tuple(t.shape))
        return combined.to_numpy_ndarray()
    if isinstance(t, _PyObjType):
        import cloudpickle

        storage = (col.combine_chunks() if isinstance(col, pa.ChunkedArray)
                   else col).storage
        out = np.empty(len(storage), dtype=object)
        for i, v in enumerate(storage):
            out[i] = cloudpickle.loads(v.as_py())
        return out
    if pa.types.is_fixed_size_list(t):  # legacy flat-tensor layout
        combined = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
        if isinstance(combined, pa.ChunkedArray):
            combined = combined.chunk(0)
        values = combined.values.to_numpy(zero_copy_only=False)
        return values.reshape(len(col), -1)
    return col.to_numpy(zero_copy_only=False)


def concat_blocks(blocks: List[Block],
                  schema: Optional[pa.Schema] = None) -> Block:
    """Concat, keeping a usable schema for the empty case: a schema-less
    ``pa.table({})`` breaks downstream schema checks (iter_batches column
    refs, zip alignment), so callers that know the exchange's schema thread
    it through here."""
    if not blocks:
        return schema.empty_table() if schema is not None else pa.table({})
    return pa.concat_tables(blocks)


# ------------------------------------------------------------- block formats
# Column-format classification for the columnar exchange: "fast" layouts
# (fixed-width primitives, FixedShapeTensor, fixed-size lists) reconstruct
# from IPC bytes as zero-copy views and have vectorized partition/sort
# kernels; everything else (pyobj extension, variable-width strings/binary,
# nested types) takes the row-object fallback and pays a copy/decode.
def is_fast_format(t: pa.DataType) -> bool:
    if isinstance(t, _PyObjType):
        return False
    if isinstance(t, pa.FixedShapeTensorType) or pa.types.is_fixed_size_list(t):
        return True
    return (pa.types.is_integer(t) or pa.types.is_floating(t)
            or pa.types.is_boolean(t) or pa.types.is_temporal(t)
            or pa.types.is_decimal(t))


def classify_table_bytes(table: Block) -> tuple:
    """(fast_bytes, fallback_bytes) over the table's columns — the split
    the exchange stats report as zero-copy vs copied bytes."""
    fast = fallback = 0
    for col in table.columns:
        if is_fast_format(col.type):
            fast += col.nbytes
        else:
            fallback += col.nbytes
    return fast, fallback


def sort_key_array(block: Block, key: str) -> Optional[np.ndarray]:
    """The key column as a numpy array the vectorized sort kernels can
    order with plain comparisons, or None when the column must take the
    pyarrow fallback: non-fast layout, nulls (to_numpy would widen to
    NaN), or float NaNs (comparison-based merge would misplace them
    relative to pc.sort_indices' nulls-last ordering)."""
    col = block.column(key)
    if not is_fast_format(col.type) or isinstance(
            col.type, pa.FixedShapeTensorType) or pa.types.is_fixed_size_list(
            col.type):
        return None
    if col.null_count:
        return None
    arr = col.to_numpy(zero_copy_only=False)
    if arr.dtype == object:
        return None
    if np.issubdtype(arr.dtype, np.floating) and np.isnan(arr).any():
        return None
    return arr
