"""Samplers (counterpart of paddle_tpu/dataloader/sampler.py). Orders
come from numpy's `RandomState`, so both packages give the same order for
one seed."""
from __future__ import annotations

import os

import numpy as np


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    """A permutation (or, with `replacement`, draws) of the indices, the
    first `num_samples` of them. With an int `generator` epoch e draws
    from seed generator + e (each iteration is the next epoch); without
    one every epoch draws fresh."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num = num_samples or len(data_source)
        self._seed = generator if isinstance(generator, int) else None
        self._epoch = 0

    def __iter__(self):
        seed = None if self._seed is None else self._seed + self._epoch
        self._epoch += 1
        rng = np.random.RandomState(seed)
        n = len(self.data_source)
        if self.replacement:
            return iter(rng.randint(0, n, self._num).tolist())
        return iter(rng.permutation(n)[:self._num].tolist())

    def __len__(self):
        return self._num


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if (dataset is None) == (sampler is None):
            raise ValueError("give exactly one of dataset / sampler")
        if sampler is None:
            sampler = (RandomSampler(dataset) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _rank_world():
    """This process's data-parallel rank and world size from the launch
    environment (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM), which
    distributed/launch.py sets for every rank it starts."""
    return (int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0),
            int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1))


class DistributedBatchSampler(BatchSampler):
    """Shards sample indices across data-parallel ranks: every rank gets
    the same number of batches (the order is padded by repeating it to a
    multiple of the ranks). `set_epoch(e)` picks epoch e's shuffle
    (`RandomState(e)`), so a restarted job can resume an epoch."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        env_rank, env_world = _rank_world()
        self.nranks = num_replicas or env_world
        self.rank = rank if rank is not None else env_rank
        self.dataset = dataset
        self.shuffle = shuffle
        self._epoch = 0
        super().__init__(dataset=dataset, batch_size=batch_size,
                         drop_last=drop_last)

    def __iter__(self):
        n = len(self.dataset)
        order = (np.random.RandomState(self._epoch).permutation(n)
                 if self.shuffle else np.arange(n))
        self._epoch += 1
        total = -(-len(order) // self.nranks) * self.nranks
        reps = -(-total // max(len(order), 1))
        order = np.tile(order, reps)[:total]
        local = order[self.rank::self.nranks].tolist()
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        per_rank = -(-len(self.dataset) // self.nranks)
        if self.drop_last:
            return per_rank // self.batch_size
        return -(-per_rank // self.batch_size)

    def set_epoch(self, epoch):
        self._epoch = int(epoch)
