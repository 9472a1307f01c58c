"""Dataset bases (counterpart of paddle_tpu/dataloader/dataset.py)."""
from __future__ import annotations

import numpy as np


class Dataset:
    """Map-style dataset: implement __getitem__ and __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    """Stream-style dataset: implement __iter__."""

    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equally long arrays: sample i is the tuple of their rows i."""

    def __init__(self, tensors):
        arrays = [np.asarray(t) for t in tensors]
        n = arrays[0].shape[0]
        if any(a.shape[0] != n for a in arrays):
            raise ValueError("all tensors must share dim 0")
        self.arrays = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.arrays)

    def __len__(self):
        return self.arrays[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint Subsets of the given lengths from one permutation drawn by
    `np.random.RandomState(generator)` (an int seed; None draws fresh)."""
    if sum(lengths) != len(dataset):
        raise ValueError(f"lengths {list(lengths)} do not sum to the "
                         f"dataset's {len(dataset)}")
    rng = np.random.RandomState(generator if isinstance(generator, int)
                                else None)
    perm = rng.permutation(len(dataset))
    out, off = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[off:off + ln].tolist()))
        off += ln
    return out
