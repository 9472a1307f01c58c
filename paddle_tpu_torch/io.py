"""Save and load: persistables, whole programs, inference models
(counterpart of paddle_tpu/io.py).

The file format is the reference's: an npz of host arrays under the
programs' variable names, programs as JSON descs. Checkpoints are always
the unsharded format (`_portable_arrays`: ZeRO flat buckets split back
into their per-parameter entries, parallel/zero.py), so a file written by
either package, at any ZeRO stage, loads into the other package and into
any stage. Every tensor payload is written to a sibling temp file, fsynced
and renamed into place (`_atomic_savez`; the `ckpt.write` fault site fires
just before the rename), and `save_persistables` writes a checksum
manifest that `load_persistables` verifies (a mismatch raises
PreconditionNotMetError). Versioned keep-N checkpoints with fallback are
resilience.CheckpointManager.

Loading writes into the scope's existing tensors in place when shape and
dtype match (framework/scope.py `load_arrays`, the rule of the executor's
`_write_persistable`), so a captured step bound to them stays valid and
the next `run_steps` replays it; any other value binds a new tensor, and
the next `run_steps` re-captures (counted in the executor's
`stats["captures"]` and in `io.load_rebinds`). A loader that knows the
program packs per-parameter entries into the program's ZeRO flat buckets
on the host first.

A rolled program's stacked parameters (parallel/transforms.py
`apply_layer_scan`) save and load as ordinary `<name>@LAYERS` [L, ...]
persistables, at ZeRO stage 3 too (the `[L, padded]` bucket is split
back into the stack). A checkpoint of the unrolled program loads into
the rolled one: its per-layer entries land in the scope, and the next
run restacks them (framework/executor.py `_ensure_stacked_params`).

At dp > 1 (fleet over several processes, parallel/zero.py) a rank holds
only its shard of each flat ZeRO array. `_portable_arrays` is then a
collective: it all-gathers the shards, so every rank holds the
unsharded payload; `save_persistables` and CheckpointManager.save write it
from rank 0 only and every rank waits at a barrier. The file is the
reference's unsharded format, whatever the dp it was written at. A load
packs the per-parameter entries and takes this rank's shard, so a
checkpoint written at dp 4 resumes at dp 2 (the elastic resize).

The RNG entry. The port's run seed is a host counter kept in the scope
under `__rng_state__` (framework/executor.py `_next_run_seeds`); the
reference keeps a jax PRNG key under the same scope name and splits it on
every run. So the two never share a file name:

* the port writes its counter as an int64 [] array named
  `__rng_counter__` (`RNG_FILE_KEY`) into every checkpoint and snapshot,
  and a port load sets the scope's counter from it, so a resumed run
  draws the dropout masks of the run it resumes;
* a port load ignores a file's `__rng_state__` (the reference's key
  data): the scope keeps the port's own counter;
* the reference, loading a port file, sets `__rng_counter__` in its scope,
  a name it never reads; its `__rng_state__` key chain is untouched.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .framework.program import Program, default_main_program
from .framework.scope import global_scope, load_arrays, to_numpy
from .resilience.faults import fault_point

__all__ = ["save_persistables", "load_persistables", "save_params",
           "load_params", "save_inference_model", "load_inference_model",
           "save", "load", "RNG_FILE_KEY"]

RNG_FILE_KEY = "__rng_counter__"   # the port's run-seed counter in files
RNG_SCOPE_KEY = "__rng_state__"    # ... in the scope (and the reference's
                                   # jax key, in its files and scopes)


def _persistable_names(program: Program, scope):
    return [v.name for v in program.list_vars()
            if v.persistable and scope.has(v.name)]


def _portable_arrays(program: Program, scope) -> dict:
    """The checkpoint payload of `program`: its persistable scope values
    as host arrays, the ZeRO flat buckets split into per-parameter
    entries. The same key set as the reference's `_portable_arrays`."""
    from .parallel.zero import gather_flat_shards, unbucket_state_for_save
    arrays = {n: to_numpy(scope.find(n))
              for n in _persistable_names(program, scope)}
    return unbucket_state_for_save(
        program, gather_flat_shards(program, scope, arrays))


def _writer() -> bool:
    """True on the rank that writes a checkpoint (rank 0; every rank of a
    one-process job)."""
    from .distributed.parallel import get_rank
    return get_rank() == 0


def _barrier() -> None:
    """Every rank waits for the writer (no-op in a one-process job)."""
    from .distributed.parallel import get_world_size
    if get_world_size() > 1:
        from .distributed.collective import barrier
        barrier()


def checkpoint_arrays(program: Program, scope) -> dict:
    """What every port checkpoint holds: `_portable_arrays` and, once the
    scope has run a program, the RNG entry."""
    arrays = _portable_arrays(program, scope)
    ctr = scope.find(RNG_SCOPE_KEY)
    if ctr is not None:
        arrays[RNG_FILE_KEY] = np.int64(ctr)
    return arrays


def restore_arrays(scope, arrays, program: Optional[Program] = None,
                   device=None) -> int:
    """The one load path: drop the reference's RNG key, take the port's
    counter, pack ZeRO buckets on the host when `program` is given, and
    write the rest into the scope (`load_arrays`). Returns the rebinds."""
    arrays = dict(arrays)
    arrays.pop(RNG_SCOPE_KEY, None)
    ctr = arrays.pop(RNG_FILE_KEY, None)
    if program is not None:
        from .parallel.zero import pack_unsharded_arrays, take_shards
        arrays = take_shards(program, pack_unsharded_arrays(program, arrays))
    rebinds = load_arrays(scope, arrays, device=device)
    if ctr is not None:
        scope.set(RNG_SCOPE_KEY, int(np.asarray(ctr)))
    return rebinds


def _device_of(executor, device):
    return device if executor is None else executor.device


def _atomic_savez(path: str, arrays: dict):
    """Write an npz to `path` via temp file + fsync + atomic rename. The
    'ckpt.write' fault fires before the rename: a crash there leaves only
    the .tmp file, so the previous file survives."""
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:     # a file object: np.savez adds no .npz
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    fault_point("ckpt.write")
    os.replace(tmp, path)


def _manifest_path(path: str) -> str:
    return path + ".manifest.json"


def save_persistables(executor=None, dirname=None, main_program=None,
                      filename=None, scope=None):
    program = main_program or default_main_program()
    scope = scope or global_scope()
    path = os.path.join(dirname, filename or "persistables.npz")
    arrays = checkpoint_arrays(program, scope)
    if _writer():
        os.makedirs(dirname, exist_ok=True)
        _atomic_savez(path, arrays)
        from .resilience.checkpoint import write_manifest
        write_manifest(dirname, -1, [os.path.basename(path)],
                       manifest_name=os.path.basename(_manifest_path(path)))
    _barrier()
    return path


def load_persistables(executor=None, dirname=None, main_program=None,
                      filename=None, scope=None, device=None):
    """Load a `save_persistables` file (of either package) into the scope,
    in place where it can (module docstring). New tensors go to the
    executor's device, else to `device` (None means cuda)."""
    path = os.path.join(dirname, filename or "persistables.npz")
    mpath = _manifest_path(path)
    if os.path.exists(mpath):     # files without a manifest are accepted
        from .framework import errors
        from .resilience.checkpoint import validate_manifest
        if validate_manifest(dirname,
                             manifest_name=os.path.basename(mpath)) is None:
            raise errors.PreconditionNotMet(
                "checkpoint %s fails its manifest checksum: corrupted or "
                "torn data or manifest, or a save crashed between "
                "publishing the data file and its manifest (two flat files "
                "cannot publish together; resilience.CheckpointManager "
                "publishes a directory in one rename and falls back)", path)
    with np.load(path) as data:
        arrays = {n: data[n] for n in data.files}
    restore_arrays(scope or global_scope(), arrays,
                   program=main_program or default_main_program(),
                   device=_device_of(executor, device))


save_params = save_persistables
load_params = load_persistables


def save(program: Optional[Program] = None, model_path: str = "model",
         scope=None):
    """Whole-model save: the program desc (JSON, `.pdmodel`) and its
    persistables (`.pdparams`), each published atomically."""
    program = program or default_main_program()
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    dtmp = model_path + f".pdmodel.tmp.{os.getpid()}"
    with open(dtmp, "w") as f:
        json.dump(program.to_desc(), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(dtmp, model_path + ".pdmodel")
    _atomic_savez(model_path + ".pdparams",
                  checkpoint_arrays(program, scope or global_scope()))


def load(program: Optional[Program] = None, model_path: str = "model",
         scope=None, device=None):
    path = (model_path + ".pdparams" if not model_path.endswith(".npz")
            else model_path)
    with np.load(path) as data:
        arrays = {n: data[n] for n in data.files}
    restore_arrays(scope or global_scope(), arrays, program=program,
                   device=device)


def save_inference_model(dirname, feeded_var_names, target_vars,
                         executor=None, main_program=None,
                         model_filename=None, params_filename=None,
                         scope=None):
    """Prune the program to the inference slice feeds -> targets (clone
    for test, then `_prune_to_targets`) and save its desc and the
    persistables it reads."""
    program = main_program or default_main_program()
    inference_program = program.clone(for_test=True)
    fetch = [v.name if hasattr(v, "name") else v for v in target_vars]
    _prune_to_targets(inference_program, fetch)
    os.makedirs(dirname, exist_ok=True)
    meta = {"feed": list(feeded_var_names), "fetch": fetch}
    with open(os.path.join(dirname, model_filename or "__model__"), "w") \
            as f:
        json.dump({"program": inference_program.to_desc(), "meta": meta}, f)
    scope = scope or global_scope()
    arrays = {n: to_numpy(scope.find(n))
              for n in _persistable_names(inference_program, scope)}
    np.savez(os.path.join(dirname, params_filename or "params.npz"),
             **arrays)
    return meta["fetch"]


def _prune_to_targets(program: Program, target_names):
    """Dead-op elimination backwards from the targets."""
    block = program.global_block()
    needed = set(target_names)
    kept = []
    for op in reversed(block.ops):
        if set(op.output_names()) & needed:
            kept.append(op)
            needed.update(op.input_names())
    block.ops = list(reversed(kept))
    program.bump_version()


def load_inference_model(dirname, executor=None, model_filename=None,
                         params_filename=None, scope=None, device=None):
    """(program, feed names, fetch vars) of a `save_inference_model`
    directory (of either package), its parameters loaded into the scope."""
    with open(os.path.join(dirname, model_filename or "__model__")) as f:
        payload = json.load(f)
    program = Program.from_desc(payload["program"])
    with np.load(os.path.join(dirname, params_filename or "params.npz")) \
            as d:
        arrays = {n: d[n] for n in d.files}
    restore_arrays(scope or global_scope(), arrays,
                   device=_device_of(executor, device))
    meta = payload["meta"]
    fetch_vars = [program.global_block().var(n) for n in meta["fetch"]]
    return program, meta["feed"], fetch_vars


# the data loading surface (paddle.io.* in 2.0; fluid.io.DataLoader in 1.x)
from .dataloader import (DataLoader, Dataset, IterableDataset,  # noqa: E402
                         TensorDataset, Subset, random_split, Sampler,
                         SequenceSampler, RandomSampler, BatchSampler,
                         DistributedBatchSampler, DataFeeder)
