"""Row-sparse (SelectedRows) gradients of `embedding(is_sparse=True)`
(counterpart of paddle_tpu/ops/sparse_grad.py).

A sparse gradient is a `SelectedRows(rows [K, D], ids [K])` pair: K is the
number of looked-up ids, fixed by the program's shapes, so the gradient
costs O(batch) memory instead of O(vocab). The optimizer rules
(ops/optimizer_ops.py) update the touched rows only.

`merge_rows` deduplicates the ids with a static size, as the reference's
`jnp.unique(size=K)` + `segment_sum` does, without reading a size on the
host (so a CUDA graph can capture it): a stable sort of the ids,
first-of-run flags, their cumsum as each sorted entry's slot, and one
K-slot segment sum. The segment sum is `index_put_(accumulate=True)` over
slots in ascending order, which adds each slot's rows one after the other
in their original order (on CUDA the sort-based kernel, no atomics), so
the sum has one order on every run. Slots past the last id are padding:
their rows are zero, and their id repeats the last real id, because
PyTorch has no scatter that drops an index (the reference's padding id
`vocab` under `mode="drop"`) and an out-of-range index on CUDA is a
device-side assert. A zero row adds nothing; a rule that SETS rows writes
each padding slot with its real slot's value (`writer_slots`), so the
duplicate writes agree.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .registry import register


class SelectedRows(NamedTuple):
    rows: torch.Tensor      # [K, D] gradient rows
    ids: torch.Tensor       # [K] int64 row indices into the [V, D] table


def is_selected_rows(v) -> bool:
    return isinstance(v, SelectedRows)


def id_runs(ids: torch.Tensor):
    """The runs of equal values in flat `ids`, of static size and without
    a host read: (sorted ids, `perm` of the stable sort, first-of-run
    flags, each sorted entry's slot). Slot j holds the j-th distinct id in
    ascending order; `perm` at a run's first entry is that id's first
    occurrence."""
    k = ids.shape[0]
    sorted_ids, perm = torch.sort(ids, stable=True)
    first = torch.ones(k, dtype=torch.bool, device=ids.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    slot = torch.cumsum(first.long(), 0) - 1
    return sorted_ids, perm, first, slot


def sorted_runs(sr: SelectedRows):
    """The merge's one pass over the ids (`id_runs`), with the K slots'
    summed rows."""
    sorted_ids, perm, first, slot = id_runs(sr.ids.reshape(-1).long())
    sums = torch.zeros_like(sr.rows).index_put_(
        (slot,), sr.rows[perm], accumulate=True)
    return sorted_ids, perm, first, slot, sums


def merge_rows(sr: SelectedRows, vocab: int) -> SelectedRows:
    """Deduplicate ids, summing their rows (the reference's MergeAdd).
    Returns K slots: the distinct ids in ascending order with their summed
    rows, then padding slots (a zero row, the last id again). Reads nothing
    on the host. `vocab` is kept for the reference's signature."""
    sorted_ids, _, _, slot, sums = sorted_runs(sr)
    k = sorted_ids.shape[0]
    # slot j's first sorted entry; past the last slot, the last entry
    start = torch.searchsorted(slot, torch.arange(k, device=slot.device))
    return SelectedRows(rows=sums,
                        ids=sorted_ids[torch.clamp(start, max=k - 1)])


def writer_slots(ids: torch.Tensor) -> torch.Tensor:
    """For merged `ids` (distinct and ascending, then the padding
    repeating the last id): each slot's first slot of equal id, so a
    padding slot takes the value its real slot writes."""
    last = (ids[1:] != ids[:-1]).sum()          # the last real slot
    return torch.minimum(torch.arange(ids.shape[0], device=ids.device), last)


def densify(sr: SelectedRows, vocab: int) -> torch.Tensor:
    """Scatter-add the rows into a dense [V, D] gradient."""
    dense = torch.zeros((vocab,) + tuple(sr.rows.shape[1:]),
                        dtype=sr.rows.dtype, device=sr.rows.device)
    return dense.index_put_((sr.ids.reshape(-1).long(),), sr.rows,
                            accumulate=True)


@register("lookup_table_sparse_grad", nondiff_slots=("W", "Ids"),
          infer=lambda block, op: None)
def _lookup_table_sparse_grad(ctx, ins, attrs):
    """Backward of an is_sparse lookup: the rows that were looked up, one
    per id, in place of the dense scatter-add a `__vjp__` would give;
    `padding_idx` rows are zero."""
    w, ids, og = ins["W"][0], ins["Ids"][0], ins["OG:Out"][0]
    idx = ids
    if idx.dim() and idx.shape[-1] == 1:
        idx = idx.squeeze(-1)
    flat_ids = idx.reshape(-1).long()
    rows = og.reshape(-1, w.shape[-1]).to(w.dtype)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        rows = torch.where((flat_ids != padding_idx).unsqueeze(-1), rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
    return {"IG:W": [SelectedRows(rows=rows, ids=flat_ids)]}
