"""Scope: run-time name -> tensor store (counterpart of
paddle_tpu/framework/scope.py). Values are torch tensors on the Executor's
device; the optimizer updates them in place."""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, object] = {}
        self.parent = parent

    def set(self, name: str, value) -> None:
        self._vars[name] = value

    def find(self, name: str):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def local_names(self):
        return list(self._vars)

    def numpy(self, name: str) -> np.ndarray:
        v = self.find(name)
        if v is None:
            from . import errors
            raise errors.NotFound("variable %r not found in scope", name)
        return to_numpy(v)


def to_numpy(value) -> np.ndarray:
    """Host copy of a scope value; bf16 (which numpy lacks) comes back as
    float32. Always a copy: a CPU tensor's `.numpy()` shares its memory,
    and the optimizer updates the scope's tensors in place."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.cpu().numpy(), copy=True)
    return np.asarray(value)


def load_numpy(scope: Scope, arrays: Mapping[str, np.ndarray],
               device: DeviceLike = None) -> Scope:
    """Carry weights across: `{name: ndarray}` -> scope tensors on `device`
    (the training counterpart of models/gpt_decode.params_from_numpy).
    Arrays keep their dtype; int64 stays int64."""
    dev = resolve_device(device)
    for name, arr in arrays.items():
        scope.set(name, torch.from_numpy(np.array(arr, copy=True)).to(dev))
    return scope


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope
