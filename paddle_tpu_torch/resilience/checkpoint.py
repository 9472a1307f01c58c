"""Crash-safe checkpoints: temp directory + checksummed manifest + one
atomic rename (counterpart of paddle_tpu/resilience/checkpoint.py).

A checkpoint is a directory `ckpt_<step>/` that becomes visible only by an
`os.replace` of a fully written temp directory, and is trusted only if its
MANIFEST.json validates (every listed file present with its size and
sha256). A crash mid-save leaves a `.tmp.<pid>` directory that loaders
never read (and that a later save reaps once its owner is dead); a torn or
corrupted checkpoint fails validation and `restore_latest` falls back to
the newest older complete one (counted in `resilience.ckpt_fallbacks`).

Manifest format (the reference's):

    {"format": 1, "step": <int>,
     "files": {"params.npz": {"sha256": "<hex>", "bytes": <int>}, ...},
     "meta": {...}}

`params.npz` holds `io.checkpoint_arrays`: the portable unsharded
persistables and the port's RNG counter (io.py), so a checkpoint of either
package restores into the other, at any ZeRO stage. `restore_latest`
writes into the scope's tensors in place (io.py `restore_arrays`).
Trace spans (category "resilience"): a save is `ckpt.collect` (device to
host, buckets split; when the caller passes no arrays), `ckpt.save` (npz
write, fsync and, inside it, `ckpt.manifest`: the sha256 pass) and
`ckpt.publish` (the rename and the keep-N prune); a restore is
`ckpt.validate` (the manifests' sha256 passes), `ckpt.read` (the npz) and
`ckpt.apply` (buckets packed on the host, copies into the scope).

Not ported (ROADMAP item 19.2): the sparse parameter-server tables
(`sparse_client`, `sparse_tables`), which raise.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, Optional, Sequence

import numpy as np

from ..framework import errors
from ..monitor import stat_add
from ..observability import trace as _trace
from .faults import fault_point

MANIFEST = "MANIFEST.json"
PARAMS_FILE = "params.npz"


def _no_sparse(sparse_client, sparse_tables):
    if sparse_client is not None or tuple(sparse_tables):
        raise errors.Unimplemented(
            "CheckpointManager: sparse parameter-server tables "
            "(sparse_client / sparse_tables) are not ported (ROADMAP item "
            "19.2, the parameter server)")


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def write_manifest(dirname: str, step: int, filenames: Sequence[str],
                   manifest_name: str = MANIFEST,
                   meta: Optional[dict] = None):
    files = {}
    for name in filenames:
        p = os.path.join(dirname, name)
        files[name] = {"sha256": sha256_file(p),
                       "bytes": os.path.getsize(p)}
    payload = {"format": 1, "step": int(step), "files": files}
    if meta:
        # caller metadata rides inside the checksummed manifest, published
        # with the data it describes
        payload["meta"] = dict(meta)
    tmp = os.path.join(dirname, manifest_name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dirname, manifest_name))


def validate_manifest(dirname: str,
                      manifest_name: str = MANIFEST) -> Optional[dict]:
    """The parsed manifest when every listed file checks out, else None."""
    mpath = os.path.join(dirname, manifest_name)
    try:
        with open(mpath) as f:
            payload = json.load(f)
        for name, meta in payload.get("files", {}).items():
            p = os.path.join(dirname, name)
            if not os.path.exists(p):
                return None
            if os.path.getsize(p) != meta["bytes"]:
                return None
            if sha256_file(p) != meta["sha256"]:
                return None
        return payload
    except (OSError, ValueError, KeyError):
        return None


class CheckpointManager:
    """Keeps the newest `max_keep` complete checkpoints under `root`, each
    tagged with its step:

        mgr = CheckpointManager(workdir, max_keep=3)
        mgr.save(step, program=main, scope=scope)
        # after a restart, into a fresh executor and scope:
        step = mgr.restore_latest(program=main, scope=scope, executor=exe)
        start = 0 if step is None else step + 1
    """

    def __init__(self, root: str, max_keep: int = 3):
        self.root = root
        self.max_keep = int(max_keep)
        os.makedirs(root, exist_ok=True)

    def steps(self):
        """Published checkpoint steps, oldest first."""
        out = []
        for d in os.listdir(self.root):
            if d.startswith("ckpt_") and d[5:].isdigit():
                out.append(int(d[5:]))
        return sorted(out)

    def path(self, step: int) -> str:
        return os.path.join(self.root, f"ckpt_{step}")

    def save(self, step: int, arrays: Optional[Dict[str, np.ndarray]] = None,
             program=None, scope=None, sparse_client=None,
             sparse_tables: Sequence[int] = (),
             meta: Optional[dict] = None, collective: bool = True) -> str:
        """Write checkpoint `step`: data file -> fault_point('ckpt.write')
        -> manifest -> atomic publish. A crash anywhere before the final
        rename leaves only a .tmp directory, which restore ignores. At dp
        > 1 every rank calls it: the payload is gathered on every rank
        (io.py), rank 0 writes it, and every rank returns after a
        barrier. `collective=False` writes this process's own `arrays`
        on any rank and waits for no other (a rank's snapshot flush,
        resilience/snapshot.py, whose peers may be gone)."""
        _no_sparse(sparse_client, sparse_tables)
        if arrays is None:
            from ..framework.program import default_main_program
            from ..framework.scope import global_scope
            from ..io import checkpoint_arrays
            with _trace.RecordEvent("ckpt.collect", cat="resilience",
                                    args={"step": int(step)}):
                arrays = checkpoint_arrays(program or default_main_program(),
                                           scope or global_scope())
        final = self.path(step)
        from ..io import _barrier, _writer
        if collective and not _writer():
            _barrier()
            return final
        tmp = final + f".tmp.{os.getpid()}"
        with _trace.RecordEvent("ckpt.save", cat="resilience",
                                args={"step": int(step),
                                      "arrays": len(arrays)}):
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, PARAMS_FILE), "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            fault_point("ckpt.write")
            with _trace.RecordEvent("ckpt.manifest", cat="resilience"):
                write_manifest(tmp, step, [PARAMS_FILE], meta=meta)
        with _trace.RecordEvent("ckpt.publish", cat="resilience",
                                args={"step": int(step)}):
            old = None
            if os.path.exists(final):  # a re-save of the same step: move
                old = final + f".old.{os.getpid()}"   # the published one
                shutil.rmtree(old, ignore_errors=True)  # aside, so a crash
                os.replace(final, old)  # here never destroys the only
            os.replace(tmp, final)      # complete checkpoint
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
            self._prune()
        if collective:
            _barrier()
        return final

    def _prune(self):
        for s in self.steps()[:-self.max_keep]:
            shutil.rmtree(self.path(s), ignore_errors=True)
        # temp and displaced directories of crashed saves only: the
        # .tmp.<pid> / .old.<pid> suffix names the writer, and a live
        # owner may be mid-save
        for d in os.listdir(self.root):
            _, sep, pid = d.rpartition(".tmp.")
            if not sep:
                _, sep, pid = d.rpartition(".old.")
            if not sep:
                continue
            if pid.isdigit() and pid != str(os.getpid()):
                try:
                    os.kill(int(pid), 0)
                    continue          # owner alive: not ours to clean
                except ProcessLookupError:
                    pass              # owner gone: a crashed save
                except OSError:
                    continue          # cannot tell (EPERM): leave it
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    def latest_valid(self):
        """(step, manifest) of the newest valid checkpoint, skipping torn
        ones (counted in `resilience.ckpt_fallbacks`), or (None, None)."""
        for step in reversed(self.steps()):
            payload = validate_manifest(self.path(step))
            if payload is None:
                # a directory without any manifest was not published by a
                # manager: skipped without counting a torn save
                if os.path.exists(os.path.join(self.path(step), MANIFEST)):
                    stat_add("resilience.ckpt_fallbacks")
                continue
            return step, payload
        return None, None

    def load_arrays(self, step: int) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.path(step), PARAMS_FILE)) as data:
            return {n: data[n] for n in data.files}

    def restore_latest(self, program=None, scope=None, sparse_client=None,
                       sparse_tables: Sequence[int] = (), executor=None,
                       device=None) -> Optional[int]:
        """Restore the newest valid checkpoint into the scope (torn ones
        skipped, `resilience.ckpt_fallbacks`), in place where the scope
        holds the tensors (io.py). New tensors go to the executor's device,
        else to `device` (None means cuda). Returns the restored step, or
        None when there is no complete checkpoint."""
        _no_sparse(sparse_client, sparse_tables)
        from ..framework.program import default_main_program
        from ..framework.scope import global_scope
        from ..io import restore_arrays
        with _trace.RecordEvent("ckpt.validate", cat="resilience"):
            step, payload = self.latest_valid()
        if step is None:
            return None
        with _trace.RecordEvent("ckpt.read", cat="resilience",
                                args={"step": int(step)}):
            arrays = self.load_arrays(step)
        with _trace.RecordEvent("ckpt.apply", cat="resilience",
                                args={"step": int(step)}):
            restore_arrays(scope or global_scope(), arrays,
                           program=program or default_main_program(),
                           device=executor.device if executor is not None
                           else device)
        return int(payload.get("step", step))
