"""The SelectedRows helpers of the reference's
paddle_tpu/ops/dense_tail_ops.py (:332-361): `get_tensor_from_selected_rows`
and `merge_selected_rows`. The file's other op types are ROADMAP item 12,
row 3."""
from __future__ import annotations

import torch

from .registry import register
from .sparse_grad import SelectedRows, is_selected_rows, sorted_runs


@register("get_tensor_from_selected_rows", nondiff_slots=("X",))
def _get_tensor_from_selected_rows(ctx, ins, attrs):
    """The rows of a SelectedRows as a dense tensor; a dense input as it
    is."""
    x = ins["X"][0]
    return {"Out": [x.rows if is_selected_rows(x) else x]}


@register("merge_selected_rows", nondiff_slots=("X",))
def _merge_selected_rows(ctx, ins, attrs):
    """Sum duplicate ids into the slot of each id's first occurrence; the
    other slots keep their ids with zero rows (the reference's static
    shape). The sums are `merge_rows`' (`sorted_runs`), moved from the
    sorted order back to the input's."""
    x = ins["X"][0]
    if not is_selected_rows(x):
        return {"Out": [x]}
    _, perm, first, slot, sums = sorted_runs(x)
    rows = torch.where(first.unsqueeze(-1), sums[slot],
                       torch.zeros((), dtype=sums.dtype, device=sums.device))
    return {"Out": [SelectedRows(rows=rows[torch.argsort(perm)],
                                 ids=x.ids.reshape(-1))]}
