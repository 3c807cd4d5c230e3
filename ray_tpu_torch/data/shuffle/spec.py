"""Shuffle exchange specs: the partition functions of one all-to-all.

One ``ShuffleSpec`` fully describes an exchange:

- ``map_fn(block, n_out, block_idx, plan)`` splits one input block into
  ``n_out`` per-reducer partition blocks (runs in a remote partitioner
  task);
- ``reduce_fn(j, *parts)`` combines partition ``j`` of every map output
  into one output block (runs in a remote reduce task);
- optional plan phase for exchanges that need global knowledge before
  partitioning: ``sample_fn(block, block_idx)`` extracts a tiny sample per
  block (sort boundary candidates, repartition row counts) and
  ``plan_fn(samples, n_out)`` turns the collected samples into the plan
  object every map task receives.

The SAME spec drives both the streaming operators (``shuffle.operators``)
and the legacy ``AllToAllOp`` barrier exchange (``data/executor.py``), so
flipping ``RTPU_STREAMING_SHUFFLE`` changes scheduling, never data.

Columnar kernels (``RTPU_COLUMNAR_EXCHANGE``, captured at DRIVER spec
construction so one exchange never mixes kernel variants across workers):
partitioning runs as ONE stable ``np.argsort(assign)`` + ``searchsorted``
boundary slices instead of n× ``take(nonzero(assign == j))`` scans; the
sort map pre-sorts its partition slices by key and the sort reduce k-way
merges the already-sorted runs with vectorized ``searchsorted`` position
arithmetic instead of ``concat + pc.sort_indices`` over the full
partition set. Blocks whose key column has no fast columnar layout
(pyobj / strings / nulls / NaNs) fall back to the row-object kernels per
block; the reduce detects unsorted runs and falls back to the full
re-sort, so mixed-format exchanges stay correct. The stable-sort /
merge-in-block-order discipline makes every kernel variant byte-identical
on ties, which is what keeps ``RTPU_COLUMNAR_EXCHANGE=0`` a pure A/B.

Determinism: every RNG here is seeded from the BLOCK INDEX (stable position
in the upstream stream), never from dispatch/completion order — a seeded
``random_shuffle`` produces identical rows no matter how maps interleave.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

_MASK64 = (1 << 64) - 1


def derive_rng(seed: Optional[int], *stream: int):
    """Deterministic per-(seed, stream...) generator. ``None`` seed stays
    nondeterministic. Components are masked to uint64 so negative seeds and
    large indices feed SeedSequence legally."""
    import numpy as np

    if seed is None:
        return np.random.default_rng(None)
    return np.random.default_rng(
        np.random.SeedSequence([seed & _MASK64, *[s & _MASK64 for s in stream]])
    )


def _schema_preserving_concat(parts: List[Any], schema: Any = None):
    """Concat partition blocks, keeping the schema when every part is empty
    (a column-less output block breaks downstream column refs). ``schema``
    is the spec-threaded fallback for the degenerate case where no part
    carries one."""
    from ray_tpu_torch.data.block import concat_blocks

    nonempty = [p for p in parts if p.num_rows]
    if not nonempty:
        for p in parts:
            if p.num_columns:
                return p.slice(0, 0)
        return concat_blocks([], schema=schema)
    return concat_blocks(nonempty)


# ------------------------------------------------------------ columnar kernels
def _legacy_scatter(block, assign, n: int):
    """n× selection scans — the row-object partition kernel."""
    import numpy as np

    return tuple(block.take(np.nonzero(assign == j)[0]) for j in range(n))


def _vectorized_scatter(block, assign, n: int):
    """Single-pass partition: one stable argsort of the assignment vector,
    one gather, then zero-copy boundary slices. The stable sort preserves
    each partition's original row order, so the output is byte-identical
    to ``_legacy_scatter`` — at 1 table scan instead of n."""
    import numpy as np

    order = np.argsort(assign, kind="stable")
    starts = np.searchsorted(assign[order], np.arange(n + 1))
    reordered = block.take(order)
    return tuple(reordered.slice(int(starts[j]), int(starts[j + 1] - starts[j]))
                 for j in range(n))


def _stable_order(keys, descending: bool):
    """Stable sort permutation: ties keep original order for ascending AND
    descending (a stable descending sort is the reverse of a stable
    ascending sort of the reversed array)."""
    import numpy as np

    if not descending:
        return np.argsort(keys, kind="stable")
    s = np.argsort(keys[::-1], kind="stable")
    return (len(keys) - 1 - s)[::-1]


def _asc_keys(k, descending: bool):
    """Map keys to an ascending-comparable domain for merge arithmetic.
    Descending uses bitwise NOT for ints/bools (monotone-decreasing with no
    int64-min negation overflow) and negation for floats; temporals reorder
    through their int64 representation."""
    import numpy as np

    if not descending:
        return k
    if k.dtype.kind in "mM":
        k = k.view(np.int64)
    if k.dtype.kind in "iub":
        return np.invert(k)
    return -k


def _merge_sorted_asc(key_arrays):
    """K-way merge of ascending runs via vectorized position arithmetic:
    element i of run A lands at ``i + searchsorted(B, A[i], left)``; ties
    resolve left-run-first, so merging in block-index order reproduces
    exactly what a stable sort of the concatenation would do. Balanced
    pairwise folding keeps total work O(rows · log runs). Returns gather
    indices into the concatenation of the runs."""
    import numpy as np

    items = []
    off = 0
    for ka in key_arrays:
        items.append((ka, np.arange(off, off + len(ka), dtype=np.int64)))
        off += len(ka)
    if not items:
        return np.empty(0, dtype=np.int64)
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            (ka, ia), (kb, ib) = items[i], items[i + 1]
            pos_a = np.arange(len(ka)) + np.searchsorted(kb, ka, side="left")
            pos_b = np.arange(len(kb)) + np.searchsorted(ka, kb, side="right")
            mk = np.empty(len(ka) + len(kb), dtype=np.result_type(ka, kb))
            mi = np.empty(len(ka) + len(kb), dtype=np.int64)
            mk[pos_a] = ka
            mk[pos_b] = kb
            mi[pos_a] = ia
            mi[pos_b] = ib
            nxt.append((mk, mi))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0][1]


class ShuffleSpec:
    """Partition functions + shape of one exchange. ``num_partitions`` is
    the stage-pinned reducer count (None = infer from the upstream block
    count, falling back to ``config.shuffle_default_partitions``).
    ``schema`` optionally pins the exchange's output schema so an all-empty
    reduce still emits a typed (never column-less) block."""

    def __init__(self, name: str,
                 map_fn: Callable,
                 reduce_fn: Callable,
                 num_partitions: Optional[int] = None,
                 sample_fn: Optional[Callable] = None,
                 plan_fn: Optional[Callable] = None,
                 infer_cap: Optional[int] = None,
                 schema: Any = None):
        self.name = name
        self.map_fn = map_fn
        self.reduce_fn = reduce_fn
        self.num_partitions = num_partitions
        self.sample_fn = sample_fn
        self.plan_fn = plan_fn
        self.infer_cap = infer_cap
        self.schema = schema

    @property
    def needs_plan(self) -> bool:
        return self.plan_fn is not None

    def resolve_partitions(self, upstream_hint: Optional[int]) -> int:
        from ray_tpu_torch.core.config import config

        if self.num_partitions is not None:
            return max(1, self.num_partitions)
        n = upstream_hint or config.shuffle_default_partitions
        if self.infer_cap is not None:
            n = min(n, self.infer_cap)
        return max(1, n)


# --------------------------------------------------------------- random_shuffle
def random_shuffle_spec(seed: Optional[int],
                        schema: Any = None) -> ShuffleSpec:
    """Rows scatter to uniform-random reducers in map tasks; each reduce
    permutes within its partition. Map RNG streams off the block index
    (stream tag 0), reduce RNG off the reducer index (stream tag 1)."""
    from ray_tpu_torch.core.config import columnar_exchange_enabled

    columnar = columnar_exchange_enabled()

    def map_fn(block, n, idx, _plan=None):
        rng = derive_rng(seed, 0, idx)
        assign = rng.integers(0, n, block.num_rows)
        outs = (_vectorized_scatter(block, assign, n) if columnar
                else _legacy_scatter(block, assign, n))
        return outs if n > 1 else outs[0]

    def reduce_fn(j, *parts):
        combined = _schema_preserving_concat(list(parts), schema)
        rng = derive_rng(seed, 1, j)
        if combined.num_rows:
            combined = combined.take(rng.permutation(combined.num_rows))
        return combined

    return ShuffleSpec("random_shuffle", map_fn, reduce_fn, schema=schema)


# ------------------------------------------------------------------ repartition
def repartition_spec(num_blocks: int, schema: Any = None) -> ShuffleSpec:
    """Order-preserving repartition: the plan phase counts rows per block,
    computes global output boundaries, and each map slices its block's
    overlap with every output range."""

    def sample_fn(block, _idx):
        return block.num_rows

    def plan_fn(counts: List[int], n: int):
        total = sum(counts)
        per, rem = divmod(total, n)
        out_sizes = [per + (1 if j < rem else 0) for j in range(n)]
        out_bounds = []
        acc = 0
        for s in out_sizes:
            out_bounds.append((acc, acc + s))
            acc += s
        plans = []
        g = 0
        for c in counts:
            g0, g1 = g, g + c
            plan = []
            for (o0, o1) in out_bounds:
                lo, hi = max(g0, o0), min(g1, o1)
                plan.append((lo - g0, max(lo, hi) - g0) if hi > lo else (0, 0))
            plans.append(plan)
            g += c
        return plans

    def map_fn(block, n, idx, plan):
        from ray_tpu_torch.data.block import BlockAccessor

        acc = BlockAccessor(block)
        outs = [acc.slice(s, e) for (s, e) in plan[idx]]
        return tuple(outs) if n > 1 else outs[0]

    def reduce_fn(_j, *parts):
        return _schema_preserving_concat(list(parts), schema)

    return ShuffleSpec(f"repartition({num_blocks})", map_fn, reduce_fn,
                       num_partitions=num_blocks,
                       sample_fn=sample_fn, plan_fn=plan_fn, schema=schema)


# ------------------------------------------------------------------------- sort
def _dedupe_boundaries(bounds, flat, n: int):
    """Boundary hygiene for skewed keys. A value may occupy several
    boundary ranks either because it is genuinely heavy (>= 1/n of the
    samples — the duplicates are KEPT: they encode how many reducer slots
    the tied rows spread across, see ``_range_assign``) or as a
    small-sample artifact, in which case the duplicate is advanced to the
    next distinct sample value so distinct keys keep distinct boundaries.
    Boundaries that run off the top are dropped (their reducers stay
    empty) rather than duplicated."""
    import numpy as np

    total = len(flat)
    out: list = []
    for b in bounds:
        keep = True
        while out and b <= out[-1]:
            cnt = (np.searchsorted(flat, b, side="right")
                   - np.searchsorted(flat, b, side="left"))
            if cnt * n >= total:
                break  # genuinely heavy: keep the duplicate rank
            nxt = np.searchsorted(flat, out[-1], side="right")
            if nxt >= total:
                keep = False
                break
            b = flat[nxt]
        if keep:
            out.append(b)
    return np.asarray(out) if out else np.array([])


def _range_assign(col, bounds, n: int, descending: bool, idx: int):
    """Reducer assignment for a range partition with deterministic tie
    spreading: a boundary value duplicated in ``bounds`` marks a heavy key
    whose rows round-robin across the value's whole reducer span instead
    of funneling into one reducer (every reducer in the span may legally
    hold the tied value — global sort order is preserved). Offsets derive
    from (block index, row occurrence), never completion order."""
    import numpy as np

    bounds = np.asarray(bounds)
    assign = np.searchsorted(bounds, col, side="right")
    if len(bounds):
        lo_b = np.searchsorted(bounds, bounds, side="left")
        hi_b = np.searchsorted(bounds, bounds, side="right")
        for v in np.unique(bounds[(hi_b - lo_b) >= 2]):
            lo = int(np.searchsorted(bounds, v, side="left"))
            hi = int(np.searchsorted(bounds, v, side="right"))
            rows = np.nonzero(col == v)[0]
            if len(rows):
                assign[rows] = lo + ((np.arange(len(rows)) + idx)
                                     % (hi - lo + 1))
    if descending:
        assign = (n - 1) - assign
    return assign


def sort_spec(key: str, descending: bool,
              num_blocks: Optional[int], schema: Any = None) -> ShuffleSpec:
    """Range-partition sort: the plan phase samples boundary candidates per
    block (overlapping with mapping-side upstream production), maps
    range-split on the sampled boundaries, reduces sorted-merge. Columnar:
    the map pre-sorts each partition slice by key (stable), and the reduce
    merges the pre-sorted runs in block-index order — equal keys land in
    (block, original row) order under every kernel combination."""
    from ray_tpu_torch.core.config import columnar_exchange_enabled

    columnar = columnar_exchange_enabled()

    def sample_fn(block, idx):
        import numpy as np

        col = block.column(key).to_numpy(zero_copy_only=False)
        if len(col) == 0:
            return np.array([])
        k = min(64, len(col))
        pick = derive_rng(0, 2, idx).choice(len(col), size=k, replace=False)
        return col[pick]

    def plan_fn(samples, n: int):
        import numpy as np

        flat = (np.concatenate([s for s in samples if len(s)])
                if any(len(s) for s in samples) else np.array([0.0]))
        flat.sort()
        if n <= 1:
            return np.array([])
        bounds = flat[np.linspace(0, len(flat) - 1, n + 1)[1:-1].astype(int)]
        return _dedupe_boundaries(bounds, flat, n)

    def map_fn(block, n, idx, bounds):
        import numpy as np

        col = block.column(key).to_numpy(zero_copy_only=False)
        assign = _range_assign(col, bounds, n, descending, idx)
        if not columnar:
            outs = _legacy_scatter(block, assign, n)
            return outs if n > 1 else outs[0]
        from ray_tpu_torch.data.block import sort_key_array

        keys_np = sort_key_array(block, key)
        if keys_np is None:
            # no fast key layout: partition vectorized, leave runs unsorted
            # (the reduce detects this and falls back to the full re-sort)
            outs = _vectorized_scatter(block, assign, n)
            return outs if n > 1 else outs[0]
        order = np.argsort(assign, kind="stable")
        starts = np.searchsorted(assign[order], np.arange(n + 1))
        segs = []
        for j in range(n):
            seg = order[starts[j]:starts[j + 1]]
            segs.append(seg[_stable_order(keys_np[seg], descending)])
        reordered = block.take(np.concatenate(segs))
        outs = tuple(
            reordered.slice(int(starts[j]), int(starts[j + 1] - starts[j]))
            for j in range(n))
        return outs if n > 1 else outs[0]

    def _merge_parts(parts):
        """Columnar reduce fast path: verify every run is pre-sorted with a
        fast key layout, then k-way merge. None = take the fallback."""
        import numpy as np

        from ray_tpu_torch.data.block import concat_blocks, sort_key_array

        keys = []
        for p in parts:
            k = sort_key_array(p, key)
            if k is None:
                return None
            ka = _asc_keys(k, descending)
            if len(ka) > 1 and not np.all(ka[1:] >= ka[:-1]):
                return None  # a fallback map left this run unsorted
            keys.append(ka)
        return concat_blocks(parts).take(_merge_sorted_asc(keys))

    def reduce_fn(_j, *parts):
        import pyarrow.compute as pc

        nonempty = [p for p in parts if p.num_rows]
        if not nonempty:
            return _schema_preserving_concat(list(parts), schema)
        if columnar:
            merged = _merge_parts(nonempty)
            if merged is not None:
                return merged
        combined = _schema_preserving_concat(nonempty, schema)
        order = "descending" if descending else "ascending"
        return combined.take(pc.sort_indices(combined, sort_keys=[(key, order)]))

    return ShuffleSpec(f"sort({key})", map_fn, reduce_fn,
                       num_partitions=num_blocks,
                       sample_fn=sample_fn, plan_fn=plan_fn, schema=schema)


# -------------------------------------------------------------- groupby + aggs
def aggregate_spec(keys: List[str], aggs: List[Any],
                   num_blocks: Optional[int],
                   schema: Any = None) -> Optional[ShuffleSpec]:
    """Hash-partition groupby: maps pre-combine per-group partials and hash-
    scatter them; reduces merge partials and finalize. Keyless (global)
    aggregation returns None — a single-output barrier is already optimal."""
    if not keys:
        return None
    names = ",".join(a.name for a in aggs)
    from ray_tpu_torch.core.config import columnar_exchange_enabled

    columnar = columnar_exchange_enabled()

    def map_fn(block, n, _idx, _plan=None):
        from ray_tpu_torch.data.aggregate import make_partial
        from ray_tpu_torch.data.executor import _stable_hash_partition

        partial = make_partial(block, keys, aggs)
        if n == 1:
            return partial
        assign = _stable_hash_partition(partial, keys, n)
        outs = (_vectorized_scatter(partial, assign, n) if columnar
                else _legacy_scatter(partial, assign, n))
        return outs

    def reduce_fn(_j, *parts):
        from ray_tpu_torch.data.aggregate import make_partial, merge_partials

        expected = {c for a in aggs for c, _ in a.merge_aggs()}
        norm = [p if expected.issubset(set(p.column_names))
                else make_partial(p, keys, aggs) for p in parts]
        return merge_partials(norm, keys, aggs)

    return ShuffleSpec(f"aggregate({','.join(keys)}:{names})",
                       map_fn, reduce_fn, num_partitions=num_blocks,
                       infer_cap=8, schema=schema)
