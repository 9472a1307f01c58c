"""paddle.io data loading: Dataset, samplers, DataLoader, DataFeeder
(counterpart of paddle_tpu/dataloader/).

The same surface and behaviour as the reference: map-style and iterable
datasets, seeded samplers (numpy `RandomState`, so both packages give the
same orders for one seed), batches collated to numpy, worker processes on
a forkserver context with bounded respawn, and a prefetch thread.

Where the port differs: workers never touch CUDA (they return numpy), and
the plain iterator's buffer thread keeps batches on the host. Host to
device copies happen only in the training process, through
`DataLoader.prefetch(executor)`, which stages each batch with
`Executor.stage` (pinned memory, a copy stream) so that the consuming
`run()` takes it by identity.
"""
from .dataset import Dataset, IterableDataset, TensorDataset, Subset, random_split
from .sampler import (Sampler, SequenceSampler, RandomSampler, BatchSampler,
                      DistributedBatchSampler)
from .dataloader import DataLoader
from .feeder import DataFeeder

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
    "DistributedBatchSampler", "DataLoader", "DataFeeder",
]
