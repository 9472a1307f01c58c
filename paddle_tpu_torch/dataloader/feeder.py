"""DataFeeder (counterpart of paddle_tpu/dataloader/feeder.py): rows of
Python data -> a feed dict of batched numpy arrays in the feed variables'
dtypes and shapes."""
from __future__ import annotations

import numpy as np


def _numpy_dtype(dtype):
    """A variable's dtype as a numpy dtype (bfloat16, which numpy lacks,
    as float32: the executor casts the feed to the variable's dtype)."""
    from ..framework.dtype import dtype_name
    name = dtype_name(dtype)
    return np.dtype(np.float32 if name == "bfloat16" else name)


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars = feed_list
        self.place = place

    def feed(self, iterable):
        rows = list(iterable)
        out = {}
        for i, var in enumerate(self.feed_vars):
            name = getattr(var, "name", str(var))
            arr = np.stack([np.asarray(row[i]) for row in rows])
            dtype = getattr(var, "dtype", None)
            if dtype is not None:
                arr = arr.astype(_numpy_dtype(dtype))
            shape = getattr(var, "shape", None)
            if shape and len(shape) == arr.ndim + 1 and shape[-1] == 1:
                arr = arr[..., None]   # fluid label convention [b, 1]
            out[name] = arr
        return out
