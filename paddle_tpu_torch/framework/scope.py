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

    def has(self, name: str) -> bool:
        return self.find(name) is not None

    def erase(self, name: str) -> None:
        self._vars.pop(name, None)

    def find_local(self, name: str):
        """The value held by this scope itself (not a parent), or None."""
        return self._vars.get(name)

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
    and the optimizer updates the scope's tensors in place. A DTensor comes
    back whole."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if hasattr(t, "full_tensor"):
            # a DTensor on a tp/sp mesh: the whole value (a collective;
            # every rank of the mesh converts it, parallel/gspmd.py)
            t = t.full_tensor()
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


def _host_tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, copy=True)
    return torch.from_numpy(a)


def _fits(cur: torch.Tensor, src: torch.Tensor) -> bool:
    """Whether `src` (a host array as loaded) may be copied into `cur`:
    same shape, and the same dtype up to the port's own host forms (bf16
    and f16 come back from the device as f32, int32 ids as int64)."""
    if tuple(cur.shape) != tuple(src.shape):
        return False
    return (cur.dtype == src.dtype
            or (src.dtype == torch.float32
                and cur.dtype in (torch.bfloat16, torch.float16))
            or (src.dtype == torch.int64 and cur.dtype == torch.int32))


def load_arrays(scope: Scope, arrays: Mapping[str, np.ndarray],
                device: DeviceLike = None) -> int:
    """Write host arrays into the scope the way a training step writes its
    persistables (executor `_write_persistable`): into the scope's own
    tensor, in place, when it has the array's shape and dtype, so its
    address never changes and a captured step bound to it stays valid;
    otherwise a new tensor is bound (on the old tensor's device, else on
    `device`) and the next `run_steps` re-captures. A DTensor (a tp/sp
    mesh) takes its own block of the whole array, so a checkpoint of whole
    arrays loads at any tp. Returns the number of such rebinds of an
    existing tensor (also counted in `io.load_rebinds`)."""
    from ..observability import metrics
    rebinds = 0
    dev = None
    for name, arr in arrays.items():
        src = _host_tensor(arr)
        cur = scope.find_local(name)
        if isinstance(cur, torch.Tensor) and _fits(cur, src):
            with torch.no_grad():
                if hasattr(cur, "full_tensor"):
                    # a DTensor on a tp/sp mesh: this rank's block of the
                    # whole array (parallel/gspmd.py)
                    from torch.distributed.tensor import distribute_tensor
                    src = distribute_tensor(
                        src.to(cur.device, cur.dtype), cur.device_mesh,
                        cur.placements, src_data_rank=None).to_local()
                    cur = cur.to_local()
                cur.copy_(src)
            continue
        if isinstance(cur, torch.Tensor):
            rebinds += 1
            metrics.inc("io.load_rebinds")
            target = cur.device
        else:
            dev = dev or resolve_device(device)
            target = dev
        scope.set(name, src.to(target))
    return rebinds


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope
