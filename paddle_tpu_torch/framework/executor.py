"""Executor: runs a Program's global block op by op on one device
(counterpart of paddle_tpu/framework/executor.py: `Executor.run` :1081,
`run_steps` :1445, `stage` :929, `_run_block` :358-399, AMP casts
:585-623, feed coercion :626, `_multi_step_feed_vals` :748,
`_package_fetches` :833).

The reference traces a whole block into one jitted XLA computation. The
port runs eagerly: each op's lowering is called in program order on the
Executor's device (`cuda` unless the caller asks for the CPU), reading
feeds, the scope's persistable tensors and earlier ops' outputs.

* Gradients. A `__vjp__` op pulls cotangents back through its forward
  op. Where the executor can pair a grad op with its forward op (same
  type, inputs and attrs, no stateful outputs), it runs that forward op
  under torch.func.vjp and keeps the pullback until the grad op runs, so
  the forward is computed once per step (flash attention's B1 launches
  once per layer). An unpaired grad op recomputes its forward
  (ops/registry.py `_lower_vjp`); both draw identical dropout masks from
  the op's key. A stateful op (batch_norm, whose MeanOut / VarianceOut
  name its running statistics) is never paired: its grad op recomputes
  the forward from the same X, so its batch statistics are the
  forward's, and returns gradients only, so the running statistics are
  written once a step, by the forward.
* State stays resident in the scope at fixed addresses: the optimizer
  updates parameters and moments in place (ops/optimizer_ops.py), the
  analog of the reference's buffer donation, and every other persistable
  output (Adam's shared beta pows) is `copy_`'d into the scope's own
  tensor. A persistable is bound only the first time it is written.
* AMP: with `program._amp` set (fleet's strategy.amp), white-list ops see
  their floating inputs cast to bfloat16 and black-list ops to float32;
  a grad op takes the policy of the op it differentiates.
* Randomness: each run takes the next run seed from a host counter in
  the scope (`__rng_state__`); the ops derive their keys from it on the
  device (ops/registry.py `LowerCtx`).
* Fetches (`_package_fetches`): a sync run returns numpy arrays (bfloat16
  as float32); `sync=False` (or FLAGS_async_dispatch) returns lazy
  FetchHandles (framework/fetch.py) that sync on access;
  `return_numpy=False` returns unsynced device tensors. A fetched
  persistable is a copy, since the next step updates it in place.

`run_steps(k, ...)` runs k training steps in one call: feeds carry a
leading [k] axis or are broadcast, fetches come back stacked [k, ...],
and step b takes run seed counter + b, so it equals k `run()` calls bit
for bit. On CUDA the whole step (forward, pullbacks, AMP casts, the
optimizer) is captured once per (program, scope, feed shapes, fetch list)
into a CUDA graph (`_CapturedStep`), after one warm-up step whose writes
are undone, and each of the k steps is one replay: its feed slices and
seed are copied into static buffers before it, its fetches out of the
graph's buffers after it, and nothing syncs the host until a fetch is
read. A failed capture raises; a CUDA run_steps never runs its steps
eagerly. On the CPU the same step body runs eagerly k times.

Capture rules a lowering on a captured path must keep: no host sync
(`.item()`, `float(t)`, a host branch on device values), no host-to-device
copy from pageable memory (a constant is a `torch.full`, not a
`torch.tensor`), no RNG but the device keys of `LowerCtx.op_seed`, and
persistable outputs either updated in place or returned for the executor
to `copy_` (a rebinding inside a capture raises).

Before each run / run_steps the executor attaches the scope to the
program's host LR schedulers (lr.py: each `step()` then writes the new LR
into that scope's tensor in place) and adopts per-parameter ZeRO state a
restore left in the scope into the flat buckets, in place
(`_prepare`; parallel/zero.py `adopt_unsharded_state`, the reference's
`_ensure_zero_state`). After it, with
`FLAGS_snapshot_steps` > 0, `_maybe_snapshot` hands the state to the
executor's SnapshotManager (resilience/snapshot.py): the copy from the
device is queued after the step or window, outside any captured graph,
and the host does not wait for it.

`stage(feed, ...)` copies the next call's feeds to the device ahead of
time (pinned host memory, a copy stream) as snapshots; the matching
`run` / `run_steps` (same program, k and feed objects) consumes them.

The step watchdog `_deadline_call` (FLAGS_step_deadline_ms) bounds the
serving engine's window replays (serving/engine.py); `Executor.run` does
not use it yet.

`train_from_dataset(program, dataset, ...)` drains one epoch of a
dataset (fluid.dataset's DatasetFactory datasets, a DataLoader yielding
feed dicts, any iterable of feed dicts) into the step: a producer thread
iterates it, stacks `steps_per_loop` batches of one shape into a window
and stages the window (`stage`, under the call's own tag) into a bounded
queue, while this thread runs each window as one `run_steps` (on CUDA,
replays of the captured step) and odd-shaped batches and the tail as
`run()` calls. A producer error is raised here; a failed step stops and
joins the producer and purges its staged windows.

Data parallelism across processes (the counterpart of the reference's
manual-dp path, `plan_manual_dp` / `build_manual_jit`,
paddle_tpu/parallel/zero.py:1232,1356, hooked from the reference's
executor.py:125-139). A program that fleet minimized at dp > 1 (one
process per rank, distributed/parallel.py) runs each step under
`zero._manual_ctx`, where the bucket ops average the gradients and shard
the ZeRO state over the ranks (parallel/zero.py). Each rank feeds its own
local batch; parameters and state stay replicated (or, for the flat ZeRO
state, sharded: `_prepare` slices the startup's values to this rank's
shard); every rank draws the same run seed. Fetches follow the
reference's plan: a floating scalar comes back as the replica mean (an
all-reduce, then `/ dp`, as `pmean`), a non-persistable fetch whose
leading dimension is the local batch as the ranks' rows concatenated in
rank order (an all-gather), anything else as this rank's value. A
program the reference's planner declines raises here, naming the cause,
and counts it under `executor.zero_manual_fallbacks.<cause>`: a
cross-batch op (the port's copy of the reference's list, zero.py
`CROSS_BATCH_OPS`), SelectedRows gradients (the reference takes those
to GSPMD, which the port has not for sparse tables: ROADMAP item 26,
and a tp/sp mesh raises for them too). Across
processes there is no GSPMD path to fall back on, and a local batch
statistic would be wrong. A program with optimizer ops but no gradient
buckets raises at dp > 1 too: it would train on local gradients.

`run_steps` / `train_from_dataset` at dp > 1 capture the collectives in
the step where the backend allows it (NCCL). Gloo's calls cannot be
captured, so under gloo every step runs the eager body, on the card as
on the CPU: counted in `stats["eager_steps"]` and in
`executor.uncaptured_collective_steps`.

Pipeline training (parallel/pipeline.py `_PipelineBlock`). A program
whose attached mesh (parallel/spmd.py) has pp > 1 runs its `device_guard`
stages as a 1F1B pipeline, one stage a device (as the reference
dispatches at :1223-1236). A program PipelineOptimizer marked with K > 1
microbatches and no pp mesh runs through the same runner over the
executor's device alone, as GPipe (the reference's
`_run_block_microbatched`, executor.py:457-585): the LR-schedule ops
once, the forward and backward ops over K slices of every feed (an
indivisible batch raises `InvalidArgument`) with the optimizer's
gradients summed, then the optimizer ops once on the sums / K; float
fetches are the microbatch mean.
`run_steps` refuses both, as the reference does; `train_from_dataset`
runs them a `run()` a batch. A recompute segment (`__segment__` with
`remat`, parallel/transforms.py) is not paired with its grad op, which
re-runs it. At dp > 1 (dp x pp) each rank pipelines its local batch and
the runner averages the gradients over the ranks before the optimizer
(parallel/pipeline.py); the fetches follow the dp plan above.

Tensor and sequence parallelism (the counterpart of the reference's
GSPMD path, :99-191; parallel/gspmd.py). A program whose attached
DistConfig has a mesh with tp or sp above 1 runs on DTensors over the
mesh's DeviceMesh, one process per rank: `_prepare` distributes the
scope's parameters and optimizer state by the rules (at startup and
after a load: whatever plain tensor it finds), every rank feeds the
global batch and keeps its block of it (`feed_sharding`), the lowerings
run on DTensors (DTensor inserts the collectives, counted by op and
bytes in `distributed.collective.counters`), each update rule takes its
gradient in its parameter's placements (the dp average at dp x tp),
written state keeps its placements (`copy_` into the local shard), and a
fetch comes back whole. Such a program never takes the manual-dp path
(the reference's `mixed_mesh` declines it too, parallel/zero.py:1253):
its ZeRO flat state is a DTensor sharded over the mesh's dp dim (stages
1-2, parallel/zero.py `_lower_zero_update`), and a pipelined program runs
through its pipeline runner, which places each microbatch's feeds
(parallel/pipeline.py). `run_steps` runs the eager step body each step,
on the card as on the CPU (equal to sequential `run()` calls), and
refuses pipelined programs as everywhere.

A rolled program (parallel/transforms.py `apply_layer_scan`) reads its
per-layer weights stacked under `@LAYERS` names; `_prepare` restacks the
per-layer entries a load of an unrolled checkpoint left in the scope
(`_ensure_stacked_params`, before the ZeRO adoption), copying into the
bound `@LAYERS` tensor (on a tp/sp mesh, this rank's block of the stack
in its placements). The `__layer_scan__` op pairs with its grad op
like any other: its own `forward_vjp` keeps the per-layer pullbacks (or,
with `remat`, the layer inputs) until the reverse loop runs.

LocalSGD (the counterpart of the reference's `_LocalSGDBlock`, :219-333,
for one process per dp rank; `_LocalSGDStep`). A program fleet marked
with `_localsgd_k` = k > 1 trains a copy of every written persistable on
each rank, under `<name>@LOCALSGD` in the scope, while the scope's
`<name>` keeps the last synced view. Every rank feeds the global batch,
as the reference's single controller does; a feed whose batch dp does
not divide raises, and rank r trains on the r-th block of rows. Its
dropout masks come from the run seed folded with its rank (the
reference's fold_in of the dp index). Local steps exchange no state
(only the fetches' dp plan below). On every k-th step (the cadence counter is the scope's
`__localsgd_step__`) every floating copy (parameters, moments, beta
pows) is averaged over the dp group, one all-reduce per dtype over the
copies laid end to end, and the synced view is written back into the
scope; integer state is left alone. Fetches follow the dp plan above. A
LocalSGD program over a pp > 1 mesh raises, as at the reference's
:1229; `run_steps` refuses LocalSGD programs and `train_from_dataset`
runs them a `run()` a batch.

Flight steps and collective markers. Every `run` / `run_steps` is one
flight-recorder step of the executor's own lane
(observability/flight.py `begin_step` / `end_step`; under the launcher,
`end_step` mirrors the step into the worker's heartbeat file). With
tracing on and FLAGS_collective_markers, each dispatch stamps one
"collective" instant per collective op of the program, in program order,
with the key `s{step}.b{bucket}.q{seq}` (the reference's
`_emit_collective_markers`, :1367); a training program that runs at
dp > 1 with no explicit collective op (LocalSGD, dp x pp) stamps one
`__step_sync__`. The gang's merged pod timeline links equal keys across
ranks (observability/podscope.py).

Sub-blocks (layers/control_flow.py). An op that runs a sub-block
(`__while__`, `__cond__`, `__switch__`, `__scan__`) finds it through
`_current_lowering_program()` (the program whose block is running on
this thread) and runs it with `run_sub_block` over an env made from its
`Free`, `Carried`, `X` and `Init` values. Every write inside a sub-block
stays in that env, persistables included: only the outer op's outputs
reach the scope, so a branch not taken (or one computed and then not
selected, under capture) writes nothing. A LoDTensorArray's value is a
`(buffer or None, length)` pair; it passes through the env and the AMP
casts as it is (no op of the AMP lists takes an array), and a fetched
array comes back as its buffer. A program holding an unbounded
`__while__` (trip_bound 0) reads its predicate on the host each
iteration and cannot be captured: `run_steps` runs it eagerly each step,
counted in `stats["eager_steps"]`. Under capture
(`LowerCtx.capturing`) `__cond__` and `__switch__` run every branch and
select their outputs on the device.

SelectedRows gradients (ops/sparse_grad.py, `embedding(is_sparse=True)`)
are `(rows, ids)` pairs: they pass through the env like an array (a
fetched one comes back as its rows), the AMP casts cast their rows, and
a captured step holds them as it holds any temporary. Their grad op,
`lookup_table_sparse_grad`, is no `__vjp__`: its forward lookup is never
paired and runs once.

Not ported (ROADMAP): the PS path (item 19.2).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import queue
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import errors
from .program import OpRole, Program, Variable, default_main_program
from .scope import Scope, global_scope, to_numpy
from ..device import capture_lock, collector_paused, resolve_device
from ..monitor import stat_add
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..observability import trace as _trace
from ..ops import registry

# the explicit collective ops of a program, in program order, stamped by
# the collective markers (the reference's analysis/collectives.py
# COLLECTIVE_OPS; the port keeps its own copy)
COLLECTIVE_OPS = frozenset({
    "__bucket_sync__", "__zero_update__", "__zero_gather__", "__zero_pack__",
})
LOCALSGD_SUFFIX = "@LOCALSGD"
_flight_owner_ids = itertools.count(1)
# the programs whose blocks are running on this thread, innermost last
_lowering = threading.local()


def _current_lowering_program():
    """The program whose block is running on this thread (the reference's
    :354): a sub-block op's lowering finds its blocks there."""
    return _lowering.programs[-1]


def _host_synced(program) -> bool:
    """Whether a step of `program` reads device values on the host: an
    unbounded `__while__` in any block (its predicate, each iteration),
    an op registered `host_read` (`print`, `py_func`, `chunk_eval`), or
    one whose `shape_slot` holds a tensor that is not a `fill_constant`
    known at build time."""
    for b in program.blocks:
        for op in b.ops:
            if op.type == "__while__" and not op.attrs.get("trip_bound"):
                return True
            if not registry.has(op.type):
                continue
            opdef = registry.get(op.type)
            if opdef.host_read:
                return True
            for n in op.inputs.get(opdef.shape_slot, ()):
                var = b.find_var_recursive(n)
                if getattr(var, "_const_value", None) is None:
                    return True
    return False


def _attrs_key(attrs) -> str:
    return repr(sorted(attrs.items()))


def _snapshot_source(name: str) -> str:
    """The var a `<name>@PRE` snapshot copies: append_backward reads an
    op's in-place inputs (a While's carried state) through snapshots taken
    just before the op, which hold the values the op read."""
    return name[:name.index("@PRE")] if "@PRE" in name else name


def _grad_plan(block) -> Dict[int, int]:
    """{forward op index: index of the __vjp__ op differentiating it}.
    A grad op pairs with the latest unpaired forward op of the same type,
    input names (a snapshot standing for the var it copies) and attrs. A
    recompute segment (`__segment__` with `remat`) is never paired: its
    grad op re-runs it. One holding a layer scan is: the scan's own
    `remat` keeps its layer inputs only (parallel/transforms.py)."""
    from ..parallel.transforms import _holds_scan
    pending, plan = {}, {}
    for idx, op in enumerate(block.ops):
        if op.type == "__segment__" and op.attrs.get("remat") \
                and not _holds_scan(op.attrs["sub_ops"]):
            continue
        if op.type == "__vjp__":
            a = op.attrs
            fwd_ins = {s: [_snapshot_source(n) for n in op.inputs.get(s, [])]
                       for s in a["fwd_input_slots"]}
            key = (a["fwd_type"], repr(sorted(fwd_ins.items())),
                   _attrs_key(a["fwd_attrs"]))
            cands = pending.get(key)
            if cands:
                plan[cands.pop()] = idx
        elif registry.has(op.type) \
                and not registry.get(op.type).stateful_outputs:
            key = (op.type, repr(sorted(op.inputs.items())),
                   _attrs_key(op.attrs))
            pending.setdefault(key, []).append(idx)
    return plan


def _amp_cast(op, ins, low_dtype):
    """White-list ops run in the low dtype, black-list ops in f32; grad
    ops re-derive the policy from their forward type."""
    op_type = op.attrs.get("fwd_type", op.type) if op.type == "__vjp__" \
        else op.type
    return _amp_cast_ins(op_type, ins, low_dtype)


def _amp_cast_ins(op_type, ins, low_dtype):
    """The AMP casts of an op of type `op_type` (also applied to the inner
    ops of a fused sub-graph op, parallel/transforms.py)."""
    from ..amp.auto_cast import black_list, keep_f32_slots, white_list
    if op_type in white_list:
        target = low_dtype
    elif op_type in black_list:
        target = torch.float32
    else:
        return ins
    skip = keep_f32_slots.get(op_type, ())
    out = {}
    for slot, vals in ins.items():
        # grad ops see forward slots plus OG:<slot> cotangents
        base_slot = slot[3:] if slot.startswith(("OG:", "IG:")) else slot
        if base_slot in skip:
            out[slot] = vals
            continue
        out[slot] = [_amp_to(v, target) for v in vals]
    return out


def _amp_to(v, target):
    """`v` in `target` if it is floating: a tensor, or a SelectedRows
    gradient's rows; anything else as it is."""
    from ..ops.sparse_grad import is_selected_rows
    if is_selected_rows(v):
        return v._replace(rows=_amp_to(v.rows, target))
    if isinstance(v, torch.Tensor) and v.is_floating_point() \
            and v.dtype != target:
        return v.to(target)
    return v


def _coerce_host(block, name, value):
    """Feed -> tensor in the var's declared dtype, on the host when the
    value is a host value. 64-bit ints live as int32 on the device; a host
    feed is range-checked here, once, before it is staged (a device
    tensor is cast without the check, which would sync)."""
    t = value if isinstance(value, torch.Tensor) \
        else torch.as_tensor(np.asarray(value))
    v = block.find_var_recursive(name)
    if v is not None:
        want = v.dtype
        if want == torch.int64:
            info = torch.iinfo(torch.int32)
            if t.device.type == "cpu" and t.numel() \
                    and (int(t.max()) > info.max or int(t.min()) < info.min):
                raise errors.InvalidArgument(
                    "feed %r holds int64 ids outside int32 range; device "
                    "tensors are 32-bit (framework/dtype.py)", name)
            want = torch.int32
        if t.dtype != want:
            t = t.to(want)
    return t


def _coerce_feed_value(block, name, value, device):
    """Feed -> tensor on `device` in the var's declared dtype."""
    return _coerce_host(block, name, value).to(device)


def _multi_step_feed_vals(block, feed, k):
    """run_steps feeds on the host, normalised to a leading [k] axis: a
    value of the var's rank is broadcast to every step (a view), one of
    rank + 1 with dim 0 == k is per-step slices; anything else raises."""
    out = {}
    for name, value in feed.items():
        t = _coerce_host(block, name, value)
        v = block.find_var_recursive(name)
        if v is not None and t.dim() == len(v.shape) + 1 \
                and t.shape[0] == k:
            pass
        elif v is None or t.dim() == len(v.shape):
            t = t.unsqueeze(0).expand((k,) + tuple(t.shape))
        else:
            raise errors.InvalidArgument(
                "run_steps feed %r: shape %s matches neither the per-step "
                "var shape %s nor [k=%d] + that shape", name,
                tuple(t.shape), tuple(v.shape), k)
        out[name] = t
    return out


def _to(t: torch.Tensor, device, pin: bool = False):
    """`t` on `device`; a broadcast run_steps feed (stride 0 on the steps
    axis) moves one step's worth and expands again there. `pin` copies
    from pinned host memory, asynchronously."""
    if t.dim() and t.shape[0] > 1 and t.stride(0) == 0:
        return _to(t[0], device, pin).unsqueeze(0).expand(t.shape)
    if pin and t.device.type == "cpu":
        return t.contiguous().pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _next_run_seeds(scope: Scope, seed: int, k: int = 1) -> List[int]:
    """The next `k` run seeds, from the program's seed and a host counter
    kept in the scope (the reference splits a jax key kept there). The
    counter never leaves the host: a captured step reads its seed from a
    device buffer the executor fills before each replay."""
    ctr = scope.find("__rng_state__") or 0
    scope.set("__rng_state__", ctr + k)
    return [(int(seed or 0) << 32) + ctr + b for b in range(k)]


def _next_run_seed(scope: Scope, seed: int) -> int:
    return _next_run_seeds(scope, seed, 1)[0]


def _written_persistables(block) -> List[str]:
    out, seen = [], set()
    for op in block.ops:
        for n in op.output_names():
            v = block.find_var_recursive(n)
            if n not in seen and v is not None and v.persistable:
                seen.add(n)
                out.append(n)
    return out


def _state_names(block, scope) -> List[str]:
    """Persistables the block reads or writes that hold a tensor in the
    scope: what a captured step binds by address."""
    names = set()
    for op in block.ops:
        names.update(op.input_names())
        names.update(op.output_names())
    return sorted(n for n in names
                  if (v := block.find_var_recursive(n)) is not None
                  and v.persistable
                  and isinstance(scope.find(n), torch.Tensor))


def _write_persistable(scope: Scope, name: str, value, strict: bool):
    """Write a persistable op output into the scope. A value that is the
    scope's tensor (an in-place update) needs nothing; a tensor of the
    same shape, dtype and device is `copy_`'d into the scope's own tensor,
    so its address never changes; a first write binds it. `strict`
    (inside a capture) raises instead of binding."""
    if scope.find(name) is value:
        return
    cur = scope.find_local(name)
    if isinstance(cur, torch.Tensor) and cur.shape == value.shape \
            and cur.dtype == value.dtype and cur.device == value.device:
        from ..parallel.gspmd import align_grad, is_dtensor
        with torch.no_grad():
            if is_dtensor(cur):
                # state on a tp/sp mesh keeps its placements
                cur.to_local().copy_(align_grad(value, cur).to_local())
            else:
                cur.copy_(value)
        return
    if strict:
        raise errors.Unavailable(
            "persistable %r would be rebound inside a captured step (the "
            "scope holds %s, the op wrote %s %s): run the startup program "
            "into this scope first", name,
            None if cur is None else f"{cur.dtype} {tuple(cur.shape)}",
            value.dtype, tuple(value.shape), var=name)
    scope.set(name, value)


class _Staged:
    """One pre-staged feed window (Executor.stage): the device copies of a
    run()/run_steps() call's feeds, matched by program, k and the
    IDENTITY of the original feed objects (strong references, never an
    id(), which CPython reuses), and the event its copies complete at."""

    __slots__ = ("prog_key", "k", "orig", "device_feeds", "ready", "tag")

    def __init__(self, prog_key, k, orig, device_feeds, ready, tag):
        self.prog_key, self.k, self.orig = prog_key, k, orig
        self.device_feeds, self.ready, self.tag = device_feeds, ready, tag

    def matches(self, program, feed, k) -> bool:
        if self.prog_key != (program._uid, program._version) or self.k != k:
            return False
        if set(feed) != set(self.orig):
            return False
        return all(feed[n] is self.orig[n] or feed[n] is self.device_feeds[n]
                   for n in feed)


def _package_fetches(fetches, names, return_numpy, sync, step=None):
    """The one fetch-return site of run()/run_steps(): the device tensors
    unsynced (return_numpy=False), numpy now (sync: counted in
    executor.fetch_sync_count / host_blocked_ms), or lazy FetchHandles
    that pay the sync on access, each carrying a trace flow from this
    dispatch to its materialisation."""
    if not return_numpy:
        return list(fetches)
    from .fetch import FetchHandle, _record_sync
    if sync:
        with _trace.RecordEvent("fetch.drain",
                                args={"step": step, "n": len(fetches)}):
            t0 = time.perf_counter()
            out = [to_numpy(f) for f in fetches]
        if out:
            _record_sync(time.perf_counter() - t0, n_values=len(out))
        return out
    out = []
    for f, n in zip(fetches, names):
        fid = None
        if _trace.enabled():
            fid = _trace.new_flow()
            _trace.flow_start("fetch", fid, args={"name": n, "step": step})
        out.append(FetchHandle(f, name=n, flow=fid))
    return out


class _CapturedStep:
    """One training step of a program captured into a CUDA graph, for one
    scope, feed signature and fetch list.

    Static buffers: one per feed at its per-step shape, and the run seed
    (int64 []). `capture` first runs the step once eagerly on a side
    stream on the first step's inputs (cuBLAS handles and workspaces,
    kernel libraries and first-time persistables come up there), then
    puts every persistable it wrote back as it was, then captures the
    step with `capture_error_mode="thread_local"` and the cyclic garbage
    collector paused (device.py `collector_paused`), all under the
    process's `capture_lock`. `replay` runs k steps:
    per step, feed slices and seed into the static buffers, one replay,
    the fetches copied out of the graph's own buffers into the caller's
    stacked [k, ...] tensors. The executor's captured steps share one
    memory pool; the static buffers are allocated outside it."""

    def __init__(self, device, program, feed_specs, fetch_names, scope):
        # no reference to the executor: a dropped executor frees its
        # graphs and their pool at once, not at the next collection
        self.program, self.scope = program, scope
        self.fetch_names = list(fetch_names)
        dev = device
        self.static = {n: torch.empty(shape, dtype=dt, device=dev)
                       for n, (shape, dt) in feed_specs.items()}
        self.seed = torch.zeros((), dtype=torch.int64, device=dev)
        self.graph = None
        self.outs: List[torch.Tensor] = []
        self.bound: Dict[str, torch.Tensor] = {}
        self.recorded = []          # the capture's kernel launches

    def valid(self) -> bool:
        """The state the graph reads and writes is still the scope's."""
        block = self.program.global_block()
        names = _state_names(block, self.scope)
        return set(names) == set(self.bound) and all(
            self.scope.find(n) is t for n, t in self.bound.items())

    def capture(self, exe, feeds0: Dict[str, torch.Tensor], seed0: int):
        """Warm up, then capture, under the process's capture lock: no
        other thread's capture (serving's or another executor's) and no
        collection can land inside this one."""
        with capture_lock:
            self._capture(exe, feeds0, seed0)

    def _capture(self, exe, feeds0: Dict[str, torch.Tensor], seed0: int):
        from ..ops.kernels import counts
        scope = self.scope
        block = self.program.global_block()
        for n, buf in self.static.items():
            buf.copy_(feeds0[n])
        self.seed.fill_(seed0)
        saved = {n: (t, t.clone()) for n in _written_persistables(block)
                 if isinstance(t := scope.find(n), torch.Tensor)}
        side = torch.cuda.Stream(exe.device)
        side.wait_stream(torch.cuda.current_stream(exe.device))
        with torch.cuda.stream(side):
            exe._step(self.program, dict(self.static), scope,
                      registry.LowerCtx(run_seed=self.seed,
                                        device=exe.device, capturing=True),
                      self.fetch_names, strict=False)
            for n, (t, copy) in saved.items():
                if scope.find(n) is not t:
                    raise errors.Unavailable(
                        "persistable %r was rebound by the warm-up step",
                        n, var=n)
                t.copy_(copy)
        torch.cuda.current_stream(exe.device).wait_stream(side)
        del saved
        if exe._pool is None:
            exe._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        failed = None
        try:
            with collector_paused(), counts.capture(side) as rec, \
                    torch.cuda.graph(graph, pool=exe._pool, stream=side,
                                     capture_error_mode="thread_local"):
                try:
                    self.outs = exe._step(
                        self.program, dict(self.static), scope,
                        registry.LowerCtx(run_seed=self.seed,
                                          device=exe.device,
                                          capturing=True),
                        self.fetch_names, strict=True)
                except BaseException as e:
                    failed = e
                    raise
        except BaseException as e:
            if failed is None or e is failed:
                raise
            # ending the failed capture raised too: the step's own error
            # is the cause, and it is the one raised last
            failed.add_note(f"ending the capture raised: {e!r}")
            raise failed from None
        self.graph, self.recorded = graph, rec
        self.bound = {n: scope.find(n)
                      for n in _state_names(block, scope)}

    def replay(self, feeds: Dict[str, torch.Tensor], seeds: List[int],
               out: List[torch.Tensor]):
        from ..ops.kernels import counts
        for b, seed in enumerate(seeds):
            for n, buf in self.static.items():
                buf.copy_(feeds[n][b])
            self.seed.fill_(seed)
            self.graph.replay()
            counts.count_replay(self.recorded)
            for o, f in zip(out, self.outs):
                o[b].copy_(f)


class Executor:
    """fluid.Executor on one device. `place` is a device spec ("cuda",
    "cpu", a torch.device); None means `cuda`.

    `stats` counts, per executor: `eager_steps` (step bodies run eagerly by
    run() or a CPU run_steps), `warmup_steps` (a capture's warm-up),
    `captures` and `graph_replays`."""

    def __init__(self, place=None):
        self.device = resolve_device(place)
        self._plans: Dict[tuple, Dict[int, int]] = {}
        self._captured: Dict[tuple, _CapturedStep] = {}
        self._staged: "collections.deque[_Staged]" = collections.deque()
        self._staged_lock = threading.Lock()
        self._copy_stream = None
        # one memory pool for this executor's captured steps: they replay
        # one at a time, and each copies its fetches out right after it
        self._pool = None
        self._step_counter = 0
        self.stats = {"eager_steps": 0, "warmup_steps": 0, "captures": 0,
                      "graph_replays": 0}
        # the SnapshotManager (FLAGS_snapshot_steps > 0), and each
        # program's step count, which tags its snapshots
        self._snapshot_mgr = None
        self._snapshot_prog_steps: Dict[int, int] = {}
        self._dp_plans: Dict[tuple, int] = {}
        # the pipeline runners of programs over a pp > 1 mesh
        self._pipelines: Dict[tuple, object] = {}
        # LocalSGD runners, and each program's collective-marker plan
        self._localsgd: Dict[tuple, "_LocalSGDStep"] = {}
        self._coll_plans: Dict[tuple, list] = {}
        # this executor's lane in the flight recorder
        self._flight_owner = next(_flight_owner_ids)

    def _prepare(self, program, scope):
        """Per call, before the step: the host LR schedulers write into
        this scope from now on, per-layer entries of a rolled program's
        stacked parameters are restacked, a restore's per-parameter ZeRO
        state is packed into the flat buckets, and at dp > 1 the flat
        state is cut to this rank's shard."""
        from ..parallel import gspmd
        from ..parallel.zero import adopt_unsharded_state, shard_flat_state
        for sched in getattr(program, "_lr_schedulers", ()):
            sched._attach_scope(scope)
        _ensure_stacked_params(program, scope, self.device)
        adopt_unsharded_state(program, scope, self.device)
        shard_flat_state(program, scope)
        dist = gspmd.mixed_config(program)
        if dist is not None:
            gspmd.distribute_scope(program, scope, dist, self.device)

    def _dp_width(self, program) -> int:
        """The dp a step of `program` runs at (1: a plain step); raises
        for the programs the reference's manual-dp planner declines
        (module docstring). Checked once per program version."""
        from ..distributed.parallel import get_world_size
        from ..parallel import gspmd, zero
        world = get_world_size()
        if world <= 1 or gspmd.mixed_config(program) is not None:
            return 1
        if _localsgd_k(program) > 1:
            return 1      # the LocalSGD step averages the copies itself
        key = (program._uid, program._version)
        dp = self._dp_plans.get(key)
        if dp is not None:
            return dp
        block = program.global_block()
        trains = any(op.attrs.get("op_role", 0) == OpRole.Optimize
                     for op in block.ops)
        pipelined = _pipelined(program)
        if not trains:
            self._dp_plans[key] = 1
            return 1
        if not pipelined and (
                not getattr(program, "_grad_buckets", None)
                or int(getattr(program, "_dp", 1) or 1) != world):
            raise errors.PreconditionNotMet(
                "a training program in a group of %d ranks that fleet did "
                "not minimize for them: call fleet.init() first and "
                "minimize through fleet.distributed_optimizer with "
                "fuse_grad_size_in_mb > 0, or every rank trains on its "
                "local gradients", world)
        if pipelined and int(getattr(program, "_dp", 1) or 1) != world:
            raise errors.PreconditionNotMet(
                "a pipeline program in a group of %d ranks that fleet did "
                "not minimize for them: call fleet.init() first and "
                "minimize through fleet.distributed_optimizer", world)
        for b in program.blocks:
            for op in b.ops:
                if op.type in zero.CROSS_BATCH_OPS:
                    cause = zero.cross_batch_cause(op.type)
                    zero.count_fallback(cause)
                    raise errors.Unimplemented(
                        "op %s couples examples across the batch (cause "
                        "%s): at dp %d each rank would compute it over its "
                        "local batch, and the port has no global-batch path "
                        "to fall back on", op.type, cause, world,
                        op=op.type)
        sparse = _selected_rows_grad(program)
        if sparse is not None:
            zero.count_fallback("selected_rows")
            raise errors.Unimplemented(
                "SelectedRows gradient %r at dp %d: the reference trains "
                "such a program through GSPMD, which the port has not for "
                "sparse tables yet (ROADMAP item 26)", sparse, world,
                var=sparse)
        if any(int(b["padded"]) % world
               for b in zero.zero_buckets(program)):
            zero.count_fallback("indivisible_padding")
        dp = world
        self._dp_plans[key] = dp
        return dp

    def _uncaptured(self, dp: int) -> bool:
        """A dp > 1 step whose collectives cannot be captured (gloo)."""
        if dp <= 1:
            return False
        from ..distributed.parallel import backend
        return backend() != "nccl"

    def _maybe_snapshot(self, program, scope, k: int = 1):
        """After a step or a run_steps(k) window: count the program's
        steps and, on the FLAGS_snapshot_steps cadence, start a snapshot
        (installing the SIGTERM flush on first use)."""
        from ..flags import flag
        interval = int(flag("FLAGS_snapshot_steps") or 0)
        if interval <= 0:
            return
        if self._snapshot_mgr is None:
            from ..resilience.snapshot import SnapshotManager
            self._snapshot_mgr = SnapshotManager(interval=interval)
            self._snapshot_mgr.install_sigterm_flush()
        self._snapshot_mgr.interval = interval
        prev = self._snapshot_prog_steps.get(program._uid, 0)
        self._snapshot_prog_steps[program._uid] = prev + k
        self._snapshot_mgr.maybe_capture(program, scope, prev + k,
                                         prev_step=prev)

    @property
    def snapshots(self):
        """The SnapshotManager (None until the first snapshotted step)."""
        return self._snapshot_mgr

    def close(self):
        """Stop the snapshot worker and uninstall its SIGTERM flush."""
        if self._snapshot_mgr is not None:
            self._snapshot_mgr.close()
            self._snapshot_mgr = None

    def _plan(self, program: Program, use_cache: bool = True
              ) -> Dict[int, int]:
        key = (program._uid, program._version)
        plan = self._plans.get(key) if use_cache else None
        if plan is None:
            plan = _grad_plan(program.global_block())
            if use_cache:
                self._plans[key] = plan
        return plan

    @staticmethod
    def _resolve_sync(sync: Optional[bool]) -> bool:
        """None -> the FLAGS_async_dispatch default; async falls back to
        sync while a fault plan is installed (executor.async_fallbacks)."""
        from ..flags import flag
        if sync is None:
            sync = not flag("FLAGS_async_dispatch")
        if not sync:
            from ..resilience.faults import current_plan
            if current_plan() is not None:
                stat_add("executor.async_fallbacks")
                return True
        return bool(sync)

    @staticmethod
    def _fetch_names(block, fetch_list) -> List[str]:
        names = [v.name if isinstance(v, Variable) else str(v)
                 for v in (fetch_list or [])]
        for n in names:
            if not block.has_var(n):
                raise errors.NotFound(
                    "fetch target %r is not a variable of this program", n,
                    var=n)
        return names

    def _step(self, program, env, scope, ctx, fetch_names, strict=False,
              use_cache=True):
        """One step body over `env` (the step's feeds): every op, then the
        fetches. A fetched persistable is a copy (the next step updates
        the scope's tensor in place)."""
        amp_dtype = (torch.bfloat16
                     if getattr(program, "_amp_dtype", "bfloat16")
                     == "bfloat16" else torch.float16) \
            if getattr(program, "_amp", False) else None
        block = program.global_block()
        plan = self._plan(program, use_cache)
        if _localsgd_k(program) > 1:
            return self._localsgd_runner(program).step(
                block, plan, env, scope, ctx, fetch_names, amp_dtype)
        from ..parallel import gspmd
        dist = gspmd.mixed_config(program)
        if dist is not None:
            return self._mesh_step(program, dist, block, plan, env, scope,
                                   ctx, fetch_names, amp_dtype, strict)
        from ..parallel.zero import current_manual_dp
        manual = current_manual_dp()
        local_batch = next((int(v.shape[0]) for v in env.values()
                            if v.dim() >= 1), None) if manual else None
        pipe = self._pipeline(program, scope, fetch_names, plan)
        if pipe is not None:
            fetches = pipe.step(env, scope, ctx, amp_dtype)
        else:
            _run_block(block, plan, env, scope, ctx, amp_dtype, strict)
            fetches = _fetch_values(env, scope, fetch_names)
        if manual:
            fetches = _dp_fetches(block, fetch_names, fetches, local_batch,
                                  manual[1])
        return fetches

    def _mesh_step(self, program, dist, block, plan, env, scope, ctx,
                   fetch_names, amp_dtype, strict):
        """One step on DTensors over a tp/sp mesh (module docstring); a
        pipelined program through its runner, which places each
        microbatch's feeds."""
        from ..parallel import gspmd
        sparse = _selected_rows_grad(program)
        if sparse is not None:
            raise errors.Unimplemented(
                "SelectedRows gradient %r on a tp/sp mesh: a sparse table "
                "on DTensors is not ported (ROADMAP item 26)", sparse,
                var=sparse)
        ctx.mesh = dist.resolve_mesh()
        pipe = self._pipeline(program, scope, fetch_names, plan)
        with gspmd.step_context():
            if pipe is not None:
                fetches = pipe.step(env, scope, ctx, amp_dtype,
                                    place=lambda n, t: gspmd.place_feed(
                                        dist, n, t))
            else:
                env = {n: gspmd.place_feed(dist, n, t)
                       for n, t in env.items()}
                _run_block(block, plan, env, scope, ctx, amp_dtype, strict)
                fetches = _fetch_values(env, scope, fetch_names)
            return [gspmd.whole(v) for v in fetches]

    def _localsgd_runner(self, program) -> "_LocalSGDStep":
        """The program's LocalSGD step, one per program version; a pp > 1
        mesh raises (the reference's :1229)."""
        key = (program._uid, program._version)
        runner = self._localsgd.get(key)
        if runner is None:
            if _pp(program) > 1:
                raise errors.Unimplemented(
                    "LocalSGD over a pp>1 mesh (pipeline stages and "
                    "per-replica parameter copies are incompatible)")
            runner = self._localsgd[key] = _LocalSGDStep(program)
        return runner

    # ---- flight steps and collective markers ------------------------------
    @contextlib.contextmanager
    def _step_window(self):
        """One executor step: advance the counter and bracket the
        flight-recorder window on this executor's lane (the reference's
        `_step_window`). Shared by run() and run_steps()."""
        self._step_counter += 1
        idx = self._step_counter
        _flight.begin_step(idx, owner=self._flight_owner)
        status = "ok"
        try:
            yield idx
        except BaseException:
            status = "error"
            raise
        finally:
            _flight.end_step(idx, status=status, owner=self._flight_owner)

    def _collective_marker_plan(self, program) -> list:
        """Ordered [(kind, bucket index)] of the program's collective ops
        (the reference's :1331): the explicit `__bucket_sync__` /
        `__zero_update__` / `__zero_gather__` / `__zero_pack__` ops in
        program order, equal on every rank of a gang, so (step, bucket,
        seq) keys match rank to rank; a training program that runs at
        dp > 1 without one (LocalSGD, dp x pp) gets one `__step_sync__` a
        dispatch."""
        key = (program._uid, program._version)
        plan = self._coll_plans.get(key)
        if plan is None:
            plan, per_kind = [], {}
            for block in program.blocks:
                for op in block.ops:
                    if op.type in COLLECTIVE_OPS:
                        b = per_kind.get(op.type, 0)
                        per_kind[op.type] = b + 1
                        plan.append((op.type, b))
            if not plan:
                from ..distributed.parallel import get_world_size
                from ..parallel.gspmd import mixed_config
                trains = any(op.attrs.get("op_role", 0) == OpRole.Optimize
                             for op in program.global_block().ops)
                if trains and get_world_size() > 1 \
                        and mixed_config(program) is None:
                    plan = [("__step_sync__", 0)]
            self._coll_plans[key] = plan
        return plan

    def _emit_collective_markers(self, program, step_idx, k=None):
        """One "collective" trace instant per collective op at dispatch,
        args {kind, step, bucket, seq, key} (the reference's :1367). Its
        ts is the host dispatch time: the rank's arrival at the step's
        collectives, which the pod merge compares across ranks."""
        from ..flags import flag
        if not (_trace.enabled() and flag("FLAGS_collective_markers")):
            return
        for seq, (kind, bucket) in enumerate(
                self._collective_marker_plan(program)):
            args = {"kind": kind, "step": int(step_idx), "bucket": bucket,
                    "seq": seq, "key": f"s{int(step_idx)}.b{bucket}.q{seq}"}
            if k:
                args["k"] = int(k)
            _trace.instant("collective", args=args, cat="collective")

    def _pipeline(self, program, scope, fetch_names, plan):
        """The program's pipeline runner (parallel/pipeline.py) over its
        mesh's pp devices, or over this executor's device for a
        microbatch program without a pp mesh; None for any other program.
        One per program version and fetch list."""
        if not _pipelined(program):
            return None
        key = (program._uid, program._version, tuple(fetch_names))
        pipe = self._pipelines.get(key)
        if pipe is None:
            from ..parallel.pipeline import _PipelineBlock
            if _pp(program) > 1:
                devices = program._dist_config.resolve_mesh().devices
            else:
                dev = self.device
                if dev.type == "cuda" and dev.index is None:
                    dev = torch.device("cuda", torch.cuda.current_device())
                devices = [dev]
            pipe = _PipelineBlock(program, fetch_names,
                                  _state_names(program.global_block(),
                                               scope), plan, devices)
            self._pipelines[key] = pipe
        return pipe

    # ---- staging: the host-side dispatch queue ----------------------------
    def stage(self, feed, program: Optional[Program] = None,
              scope: Optional[Scope] = None, k: Optional[int] = None,
              depth: Optional[int] = None, tag=None):
        """Pre-stage the NEXT run() (or run_steps(k)) call's feeds: coerce
        and range-check on the host now and start the copies to the device
        on a copy stream from pinned memory, while the current step runs.
        The staged values are snapshots: changing the host arrays after
        this call does not reach the staged window. Returns the device
        feed dict. At most `depth` (FLAGS_dispatch_queue_depth) windows are
        kept per `tag`, the oldest dropped. The consuming call is matched
        by program, k and the identity of the feed values: pass the same
        feed dict (or the returned device dict) to it."""
        from ..flags import flag
        program = program or default_main_program()
        block = program.global_block()
        with _trace.RecordEvent("stage", args={"k": 0 if k is None
                                               else int(k),
                                               "feeds": len(feed)}):
            t0 = time.perf_counter()
            if k is not None:
                k = int(k)
                host = _multi_step_feed_vals(block, feed, k)
            else:
                host = {n: _coerce_host(block, n, v)
                        for n, v in feed.items()}
            dev, ready = self._to_device(host)
            stat_add("executor.h2d_ms", (time.perf_counter() - t0) * 1e3)
        depth = max(1, int(flag("FLAGS_dispatch_queue_depth")
                           if depth is None else depth))
        with self._staged_lock:
            same = [e for e in self._staged if e.tag is tag]
            while len(same) >= depth:
                self._staged.remove(same.pop(0))
            self._staged.append(_Staged((program._uid, program._version), k,
                                        dict(feed), dev, ready, tag))
            _metrics.set_gauge("executor.dispatch_queue_depth",
                               len(self._staged))
        return dev

    def _to_device(self, host: Dict[str, torch.Tensor]):
        """Snapshot copies of host tensors on the device: on CUDA from
        pinned memory on the copy stream (returns the event they complete
        at), on the CPU as clones. A value already on the device is copied
        too, on the device."""
        if self.device.type != "cuda":
            return {n: t.clone() for n, t in host.items()}, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        cs = self._copy_stream
        cs.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(cs):
            dev = {n: _to(t, self.device, pin=True) if t.device.type == "cpu"
                   else t.to(self.device).clone() for n, t in host.items()}
        ready = torch.cuda.Event()
        ready.record(cs)
        return dev, ready

    def _purge_staged(self, tag):
        """Drop every staged window carrying `tag` (an abandoned prefetch
        iterator's or a finished train_from_dataset's pending device
        copies must not pin device memory)."""
        with self._staged_lock:
            kept = [e for e in self._staged if e.tag is not tag]
            if len(kept) != len(self._staged):
                self._staged = collections.deque(kept)
                _metrics.set_gauge("executor.dispatch_queue_depth",
                                   len(self._staged))

    def _take_staged(self, program, feed, k):
        """Pop the staged window matching this call and wait (on the
        device) for its copies; None when there is none."""
        with self._staged_lock:
            for e in self._staged:
                if e.matches(program, feed, k):
                    self._staged.remove(e)
                    _metrics.set_gauge("executor.dispatch_queue_depth",
                                       len(self._staged))
                    break
            else:
                return None
        if e.ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(e.ready)
            for t in e.device_feeds.values():
                t.record_stream(cur)
        return e.device_feeds

    # ---- run / run_steps ----------------------------------------------------
    def run(self, program: Optional[Program] = None,
            feed: Optional[dict] = None, fetch_list: Optional[list] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_program_cache: bool = True, sync: Optional[bool] = None):
        """Run the program's global block once; returns the fetches:
        numpy arrays (sync, the default), lazy FetchHandles
        (`sync=False` or FLAGS_async_dispatch) or, with
        `return_numpy=False`, the device tensors unsynced."""
        program = program or default_main_program()
        feed = feed or {}
        scope = scope or global_scope()
        sync = self._resolve_sync(sync)
        block = program.global_block()
        fetch_names = self._fetch_names(block, fetch_list)
        self._prepare(program, scope)
        env = self._take_staged(program, feed, None)
        env = dict(env) if env is not None else {
            name: _coerce_feed_value(block, name, value, self.device)
            for name, value in feed.items()}
        ctx = registry.LowerCtx(
            run_seed=_next_run_seed(scope, program.random_seed),
            device=self.device)
        with self._step_window() as step_idx:
            t0 = time.perf_counter()
            dp = self._dp_width(program)
            self._emit_collective_markers(program, step_idx)
            with _trace.RecordEvent("executor_run",
                                    args={"step": step_idx}), \
                    _dp_context(dp):
                fetches = self._step(program, env, scope, ctx, fetch_names,
                                     use_cache=use_program_cache)
            self.stats["eager_steps"] += 1
            _metrics.observe("executor.step_host_ms",
                             (time.perf_counter() - t0) * 1000.0)
            out = _package_fetches(fetches, fetch_names, return_numpy, sync,
                                   step=step_idx)
        self._maybe_snapshot(program, scope)
        return out

    def run_steps(self, k: int, program: Optional[Program] = None,
                  feed: Optional[dict] = None,
                  fetch_list: Optional[list] = None,
                  scope: Optional[Scope] = None, return_numpy: bool = True,
                  sync: Optional[bool] = None):
        """Run `k` training steps in one call. Each feed carries a leading
        [k] axis (per-step slices) or has the per-step shape (every step
        sees it). Fetches come back stacked [k, ...], with run()'s fetch
        semantics. Step b takes run seed counter + b and the counter
        advances by k, so the result equals k run() calls bit for bit,
        dropout on. On CUDA each step is one replay of the captured step
        (module docstring); on the CPU the step body runs k times."""
        program = program or default_main_program()
        if not isinstance(k, (int, np.integer)) or isinstance(k, bool) \
                or k < 1:
            raise errors.InvalidArgument(
                "run_steps needs an integer k >= 1, got %r", k)
        k = int(k)
        if getattr(program, "_ps_hooks", None) or \
                getattr(program, "_localsgd_k", 0) or _pipelined(program):
            raise errors.Unimplemented(
                "run_steps with parameter-server, LocalSGD or pipeline "
                "programs (the reference rejects them too; run them step "
                "by step)")
        feed = feed or {}
        scope = scope or global_scope()
        sync = self._resolve_sync(sync)
        block = program.global_block()
        fetch_names = self._fetch_names(block, fetch_list)
        self._prepare(program, scope)
        feeds = self._take_staged(program, feed, k)
        if feeds is None:
            feeds = {n: _to(t, self.device) for n, t in
                     _multi_step_feed_vals(block, feed, k).items()}
        seeds = _next_run_seeds(scope, program.random_seed, k)
        with self._step_window() as step_idx:
            return self._run_steps_window(
                program, feeds, seeds, scope, fetch_names, return_numpy,
                sync, step_idx, k)

    def _run_steps_window(self, program, feeds, seeds, scope, fetch_names,
                          return_numpy, sync, step_idx, k):
        t0 = time.perf_counter()
        dp = self._dp_width(program)
        self._emit_collective_markers(program, step_idx, k=k)
        with _trace.RecordEvent(f"executor_run_steps#{k}",
                                args={"step": step_idx, "k": k}), \
                _dp_context(dp):
            from ..parallel.gspmd import mixed_config
            mixed = mixed_config(program) is not None
            if self.device.type == "cuda" and not self._uncaptured(dp) \
                    and not mixed and not _host_synced(program):
                stacked = self._run_captured(program, feeds, seeds, scope,
                                             fetch_names)
            else:
                per_step = []
                for b, seed in enumerate(seeds):
                    env = {n: t[b] for n, t in feeds.items()}
                    ctx = registry.LowerCtx(run_seed=seed,
                                            device=self.device)
                    per_step.append(self._step(program, env, scope, ctx,
                                               fetch_names))
                    self.stats["eager_steps"] += 1
                    if dp > 1 or mixed:
                        _metrics.inc("executor.uncaptured_collective_steps")
                stacked = [torch.stack([s[i] for s in per_step])
                           for i in range(len(fetch_names))]
        _metrics.observe("executor.step_host_ms",
                         (time.perf_counter() - t0) * 1000.0)
        out = _package_fetches(stacked, fetch_names, return_numpy, sync,
                               step=step_idx)
        # after a sync fetch, so the fetch does not wait for the copy
        self._maybe_snapshot(program, scope, k)
        return out

    # ---- datasets -------------------------------------------------------
    def train_from_dataset(self, program: Optional[Program] = None,
                           dataset=None, scope: Optional[Scope] = None,
                           thread: int = 0, debug: bool = False,
                           fetch_list: Optional[list] = None,
                           fetch_info=None, print_period: int = 100,
                           steps_per_loop: int = 1):
        """Train on one epoch of `dataset` (an iterable of feed dicts: a
        fluid.dataset dataset, a DataLoader built with `feed_list=` and
        `return_list=False`, a generator). Returns the last step's fetches
        as numpy arrays (None for an empty epoch).

        A producer thread iterates the dataset (MultiSlot parsing, worker
        batches) into a bounded queue and stages each window's feeds on
        the device ahead of its step. `steps_per_loop` = k groups k
        batches of one shape into one `run_steps(k)` (on CUDA, k replays
        of the captured step: one capture per program and shape); a batch
        of another shape closes the group early, and such partial groups
        and the epoch's tail run as single `run()` steps; a pipeline
        program (microbatches, or a pp > 1 mesh) and a LocalSGD program
        run every batch as a `run()` step. The losses are those of the same batches through
        `run_steps` / `run`, bit for bit. `debug` prints the fetches every
        `print_period` steps."""
        if dataset is None:
            raise errors.InvalidArgument(
                "train_from_dataset needs a dataset")
        program = program or default_main_program()
        if getattr(program, "_ps_hooks", None):
            raise errors.Unimplemented(
                "train_from_dataset with parameter-server programs is not "
                "ported yet (ROADMAP item 19.2)")
        from ..dataloader.dataloader import _bounded_put, _drain_queue
        fetch_list = fetch_list or []
        group_k = max(1, int(steps_per_loop))
        if _pipelined(program) or _localsgd_k(program) > 1:
            group_k = 1       # a pipeline or LocalSGD step runs by run(),
                              # as run_steps refuses it (the reference's
                              # rule, :1672)
        maxsize = 4
        q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        end, err = object(), []
        stop = threading.Event()
        # this call's staged windows: up to the queue's, one in the
        # producer's hands and one taken by this thread and not yet run
        tag, depth = object(), maxsize + 2

        def put(item) -> bool:
            return _bounded_put(stop, q, item)

        def emit(buf) -> bool:
            if len(buf) == group_k > 1:
                host = {n: np.stack([np.asarray(f[n]) for f in buf])
                        for n in buf[0]}
                self.stage(host, program=program, k=group_k, depth=depth,
                           tag=tag)
                return put((group_k, host))
            for f in buf:
                self.stage(f, program=program, depth=depth, tag=tag)
                if not put((None, f)):
                    return False
            return True

        def produce():
            try:
                buf = []
                for feed in dataset:
                    if stop.is_set():
                        return
                    if buf and _feed_shapes(buf[0]) != _feed_shapes(feed):
                        if not emit(buf):
                            return
                        buf = []
                    buf.append(feed)
                    if len(buf) == group_k:
                        if not emit(buf):
                            return
                        buf = []
                emit(buf)
            except BaseException as e:     # raised on the calling thread
                err.append(e)
            finally:
                put(end)

        producer = threading.Thread(target=produce, daemon=True,
                                    name="dataplane-prefetch")
        producer.start()
        fetched, step = None, 0
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                k, feed = item
                if k is None:
                    fetched = self.run(program, feed=feed,
                                       fetch_list=fetch_list, scope=scope,
                                       return_numpy=False)
                    n = 1
                else:
                    stacked = self.run_steps(k, program, feed=feed,
                                             fetch_list=fetch_list,
                                             scope=scope, return_numpy=False)
                    fetched, n = [v[-1] for v in stacked], k
                if debug and fetch_list and (
                        step == 0 or step // print_period
                        != (step + n) // print_period):
                    names = fetch_info or [getattr(v, "name", str(v))
                                           for v in fetch_list]
                    print(f"step {step + n - 1}: " + ", ".join(
                        f"{nm}={to_numpy(v).ravel()[:4]}"
                        for nm, v in zip(names, fetched)))
                step += n
        finally:
            # a failed step must not leave the producer blocked on the
            # queue holding the dataset open
            _drain_queue(stop, q)
            producer.join(timeout=10)
            self._purge_staged(tag)
        if err:
            raise err[0]
        if fetched is None:
            return None
        return [to_numpy(f) for f in fetched]

    def infer_from_dataset(self, program: Optional[Program] = None,
                           dataset=None, scope: Optional[Scope] = None,
                           thread: int = 0, debug: bool = False,
                           fetch_list: Optional[list] = None,
                           fetch_info=None, print_period: int = 100):
        """train_from_dataset one step at a time (the program decides
        whether anything trains)."""
        return self.train_from_dataset(program, dataset, scope, thread,
                                       debug, fetch_list, fetch_info,
                                       print_period)

    def _run_captured(self, program, feeds, seeds, scope, fetch_names):
        k = len(seeds)
        specs = tuple(sorted((n, tuple(t.shape[1:]), t.dtype)
                             for n, t in feeds.items()))
        key = (program._uid, program._version, id(scope), specs,
               tuple(fetch_names))
        step = self._captured.get(key)
        if step is not None and not step.valid():
            step = None
        if step is None:
            step = _CapturedStep(self.device, program,
                                 {n: (shape, dt) for n, shape, dt in specs},
                                 fetch_names, scope)
            with _trace.RecordEvent("capture", args={"k": k}):
                step.capture(self, {n: t[0] for n, t in feeds.items()},
                             seeds[0])
            self._captured[key] = step
            self.stats["captures"] += 1
            self.stats["warmup_steps"] += 1
            _metrics.inc("executor.graph_captures")
        out = [torch.empty((k,) + tuple(o.shape), dtype=o.dtype,
                           device=o.device) for o in step.outs]
        step.replay(feeds, seeds, out)
        self.stats["graph_replays"] += k
        _metrics.inc("executor.graph_replays", k)
        return out


def _ensure_stacked_params(program, scope, device) -> None:
    """Scope round trip of a rolled program (reference
    framework/executor.py:658): when every per-layer entry of a stack is
    in the scope (an unrolled checkpoint was loaded, or a startup program
    that was not rolled ran), restack them under the `@LAYERS` name the
    program reads and erase them. The stack is `copy_`'d into the scope's
    `@LAYERS` tensor when it has one of that shape and dtype, so a
    captured step bound to it stays valid; otherwise it is bound (on the
    old tensor's device, else on `device`)."""
    stacks = getattr(program, "_layer_stacks", None)
    if not stacks:
        return
    from ..parallel.gspmd import is_dtensor, whole
    for sname, parts in stacks.items():
        if not parts or not all(scope.has(p) for p in parts):
            continue
        cur = scope.find_local(sname)
        dev = cur.device if isinstance(cur, torch.Tensor) else device
        with torch.no_grad():
            # whole per-layer values (a DTensor entry gathered: every rank
            # restacks, in the stacks' order)
            stacked = torch.stack([whole(torch.as_tensor(scope.find(p)))
                                   .to(dev) for p in parts])
            if isinstance(cur, torch.Tensor) and cur.shape == stacked.shape \
                    and cur.dtype == stacked.dtype:
                if is_dtensor(cur):
                    # a tp/sp mesh: this rank's block of the stack, in the
                    # stack's placements
                    from torch.distributed.tensor import distribute_tensor
                    stacked = distribute_tensor(
                        stacked, cur.device_mesh, cur.placements,
                        src_data_rank=None).to_local()
                    cur = cur.to_local()
                cur.copy_(stacked)
            else:
                scope.set(sname, stacked)
        for p in parts:
            scope.erase(p)


def _feed_shapes(feed) -> Dict[str, tuple]:
    return {n: tuple(np.shape(v)) for n, v in feed.items()}


def _dp_context(dp: int):
    """The data-parallel step context at dp > 1, else nothing."""
    if dp <= 1:
        return contextlib.nullcontext()
    from ..parallel.zero import _manual_ctx
    return _manual_ctx(dp)


def _dp_fetches(block, names, fetches, local_batch, dp):
    """The reference's fetch plan under manual dp (zero.py:1336-1353): a
    floating scalar is the replica mean, a non-persistable fetch whose
    leading dimension is the local batch the ranks' rows in rank order,
    anything else this rank's (replicated) value."""
    from ..distributed.collective import all_gather, all_reduce
    out = []
    for n, v in zip(names, fetches):
        var = block.find_var_recursive(n)
        persistable = var is not None and var.persistable
        if v.dim() == 0:
            if v.is_floating_point():
                v = all_reduce(v.clone()) / dp
        elif v.shape[0] == local_batch and not persistable:
            v = torch.cat(all_gather(None, v), dim=0)
        out.append(v)
    return out


def _localsgd_k(program) -> int:
    """The program's LocalSGD cadence k (0: not a LocalSGD program)."""
    return int(getattr(program, "_localsgd_k", 0) or 0)


def _fold_rank(seed: int, rank: int) -> int:
    """The run seed of dp rank `rank`: rank 0 keeps the run seed, the
    others fold their rank into its high half, so each replica draws its
    own dropout masks."""
    return seed if rank == 0 else (seed ^ (rank << 40)) % (1 << 63)


class _LocalSGDStep:
    """The LocalSGD step of one program on this rank (module docstring;
    the reference's `_LocalSGDBlock`, :219-333, which runs every replica
    of a dp mesh in one program: here each process runs its own)."""

    def __init__(self, program):
        from ..distributed.parallel import get_rank, get_world_size
        self.k = _localsgd_k(program)
        self.dp = max(1, get_world_size())
        self.rank = get_rank() if self.dp > 1 else 0
        self.written = _written_persistables(program.global_block())

    def _rows(self, env) -> Dict[str, torch.Tensor]:
        """This rank's block of every batched feed (the reference's
        `P("dp")` feed specs)."""
        out = {}
        for name, t in env.items():
            if t.dim() and t.shape[0] % self.dp:
                raise errors.InvalidArgument(
                    "localsgd: feed %r batch %d is not divisible by dp=%d",
                    name, int(t.shape[0]), self.dp, var=name)
            if t.dim() and self.dp > 1:
                b = int(t.shape[0]) // self.dp
                t = t.narrow(0, self.rank * b, b)
            out[name] = t
        return out

    def _copies(self, scope) -> Scope:
        """A child of `scope` holding this rank's copy of every written
        persistable (`<name>@LOCALSGD`, made from the synced view on the
        first step): the step reads and updates the copies, and every
        other name falls through to `scope`."""
        local = Scope(parent=scope)
        for n in self.written:
            copy = scope.find(n + LOCALSGD_SUFFIX)
            if copy is None:
                cur = scope.find(n)
                if not isinstance(cur, torch.Tensor):
                    continue          # the step binds it (first write)
                with torch.no_grad():
                    copy = cur.detach().clone()
                scope.set(n + LOCALSGD_SUFFIX, copy)
            local.set(n, copy)
        return local

    def average(self, tensors: List[torch.Tensor]) -> None:
        """Average the floating tensors over the dp group in place: one
        all-reduce per (dtype, device), over the tensors laid end to end,
        then / dp (the reference's pmean)."""
        if self.dp <= 1:
            return
        from ..distributed.collective import all_reduce
        groups: Dict[tuple, List[torch.Tensor]] = {}
        for t in tensors:
            if t.is_floating_point():
                groups.setdefault((t.dtype, t.device), []).append(t)
        with torch.no_grad():
            for ts in groups.values():
                flat = torch.cat([t.reshape(-1) for t in ts])
                all_reduce(flat)
                flat.div_(self.dp)
                off = 0
                for t in ts:
                    n = t.numel()
                    t.copy_(flat[off:off + n].view_as(t))
                    off += n

    def step(self, block, plan, env, scope, ctx, fetch_names, amp_dtype):
        env = self._rows(env)
        local = self._copies(scope)
        idx = int(scope.find("__localsgd_step__") or 0)
        sync = idx % self.k == self.k - 1
        ctx = registry.LowerCtx(run_seed=_fold_rank(ctx.run_seed, self.rank),
                                device=ctx.device)
        _run_block(block, plan, env, local, ctx, amp_dtype)
        fetches = _fetch_values(env, local, fetch_names)
        scope.set("__localsgd_step__", idx + 1)
        copies = {}
        for n in self.written:
            v = local.find_local(n)
            if isinstance(v, torch.Tensor):
                copies[n] = v
                if scope.find(n + LOCALSGD_SUFFIX) is not v:
                    scope.set(n + LOCALSGD_SUFFIX, v)   # bound by the step
        if sync:
            self.average(list(copies.values()))
            for n, v in copies.items():
                _write_persistable(scope, n, v.detach().clone()
                                   if scope.find(n) is None else v, False)
        if self.dp > 1:
            local_batch = next((int(t.shape[0]) for t in env.values()
                                if t.dim() >= 1), None)
            fetches = _dp_fetches(block, fetch_names, fetches, local_batch,
                                  self.dp)
        return fetches


def _selected_rows_grad(program) -> Optional[str]:
    """The name of a SelectedRows gradient var of `program`
    (`embedding(is_sparse=True)`), or None; looked up once a version."""
    cached = getattr(program, "_selected_rows_grad", None)
    if cached is None or cached[0] != program._version:
        name = next((v.name for b in program.blocks for v in b.vars.values()
                     if getattr(v, "_is_selected_rows", False)), None)
        cached = program._selected_rows_grad = (program._version, name)
    return cached[1]


def _pp(program) -> int:
    """The pp size of the program's attached mesh (1 without one)."""
    dist = getattr(program, "_dist_config", None)
    return 1 if dist is None else dist.pp


def _pipelined(program) -> bool:
    """A microbatch program, or one over a pp > 1 mesh."""
    return bool(getattr(program, "_microbatch_k", 0)) or _pp(program) > 1


def _fetch_values(env, scope, names):
    """The fetches of a step: a value of the step's env as it is (an
    array as its buffer), a persistable's as a copy (the next step
    updates it in place)."""
    out = []
    for n in names:
        val = env[n] if n in env else scope.find(n)
        if isinstance(val, tuple):
            val = val[0]
        if val is None:
            raise errors.NotFound("fetch target %r was not computed", n,
                                  var=n)
        out.append(val.clone() if n not in env else val)
    return out


def _split_feeds(feeds, k):
    """k microbatch slices of every feed along its batch dimension (a
    feed without one goes to every microbatch); a batch that k does not
    divide raises."""
    micro = [dict() for _ in range(k)]
    for name, t in feeds.items():
        if not t.dim():
            for m in micro:
                m[name] = t
            continue
        b = int(t.shape[0])
        if b % k:
            raise errors.InvalidArgument(
                "pipeline: feed %r batch %d is not divisible by "
                "num_microbatches=%d", name, b, k, var=name)
        for m, piece in zip(micro, t.split(b // k)):
            m[name] = piece
    return micro


def run_sub_block(block, env, out_names, ctx):
    """Run a sub-block over `env` (its outer op's Free / Carried / X /
    Init values by name, module docstring) and return the values of
    `out_names`. Every write stays in a copy of `env`: persistables too,
    and nothing is read from a scope, so a parameter read inside the
    block is the env's value (under torch.func.vjp, the outer op's
    primal, whose gradient the outer op's `__vjp__` returns)."""
    from .scope import Scope
    local = dict(env)
    _run_block(block, {}, local, Scope(), ctx, ctx.amp_dtype, local=True)
    missing = [n for n in out_names if n not in local]
    if missing:
        raise errors.NotFound(
            "sub-block %d did not compute %s", block.idx, missing,
            var=missing[0])
    return [local[n] for n in out_names]


def _run_block(block, plan, env, scope, ctx, amp_dtype, strict=False,
               ops=None, saved=None, local=False):
    """Apply each op's lowering in order over `env` (feeds and
    temporaries; persistable values live in the scope and are written
    there in place: `_write_persistable`; with `local`, a sub-block's,
    they stay in `env`). `ops` is a list of (index in the block, op), all
    of the block's by default; `saved` holds the pullbacks of forward ops
    whose grad op has not run yet (pass the same dict to the call that
    runs the grad ops)."""
    stack = getattr(_lowering, "programs", None)
    if stack is None:
        stack = _lowering.programs = []
    stack.append(block.program)
    try:
        _run_ops(block, plan, env, scope, ctx, amp_dtype, strict, ops,
                 saved, local)
    finally:
        stack.pop()


def _run_ops(block, plan, env, scope, ctx, amp_dtype, strict, ops, saved,
             local):
    if saved is None:
        saved = {}     # __vjp__ op index -> (pullback, forward outputs)
    ctx.amp_dtype = amp_dtype

    def lookup(n, op):
        if n == "@EMPTY@":
            return None
        v = env.get(n)
        if v is None:
            v = scope.find(n)
            if v is None:
                raise errors.NotFound(
                    "input %r of op %s has no value: feed it or run the "
                    "startup program first", n, op.type, op=op.type, var=n)
        return v

    for idx, op in (enumerate(block.ops) if ops is None else ops):
        opdef = registry.get(op.type)
        if idx in saved:
            # paired grad op: only its cotangents are needed
            ins = {s: [lookup(n, op) for n in names]
                   for s, names in op.inputs.items() if s.startswith("OG:")}
        else:
            ins = {s: [lookup(n, op) for n in names]
                   for s, names in op.inputs.items()}
        if amp_dtype is not None:
            ins = _amp_cast(op, ins, amp_dtype)
        if ctx.mesh is not None:
            # every input whole or sharded, never a pending partial sum: a
            # row-parallel product is reduced once, where it is next read
            # (Megatron's all-reduce), not again in each nonlinear op
            from ..parallel import gspmd
            gspmd.current_op[0] = op.attrs["fwd_type"] + "@grad" \
                if op.type == "__vjp__" else op.type
            ins = {s: [gspmd.settled(v) for v in vs]
                   for s, vs in ins.items()}
            if ins.get("Param") and ins.get("Grad"):
                # an update rule's gradient in its parameter's placements
                ins["Grad"] = [gspmd.align_grad(g, p)
                               for g, p in zip(ins["Grad"], ins["Param"])]
        for out_slot, in_slot in opdef.inplace.items():
            # an update rule whose output names another var (a gated
            # update) must leave its input as it was
            if out_slot in op.outputs and in_slot in ins \
                    and op.outputs[out_slot] != op.inputs[in_slot]:
                ins[in_slot] = [v.clone() for v in ins[in_slot]]
        if idx in plan:
            vop = block.ops[plan[idx]]
            diff = [tuple(e) for e in vop.attrs["diff_entries"]]
            outs, pullback = registry.forward_vjp(
                opdef, ctx, ins, op.attrs, diff,
                vop.attrs["fwd_output_slots"])
            saved[plan[idx]] = (pullback, outs)
        elif idx in saved:
            pullback, fwd_outs = saved.pop(idx)
            a = op.attrs
            cts = registry.cotangents(ins, a["fwd_output_slots"],
                                      a["fwd_output_counts"], fwd_outs)
            outs = registry.grads_by_slot(
                [tuple(e) for e in a["diff_entries"]], pullback(cts),
                a["fwd_input_slots"])
        else:
            outs = opdef.lower(ctx, ins, op.attrs)
        for slot, names in op.outputs.items():
            for n, v in zip(names, outs.get(slot, ())):
                if n == "@EMPTY@" or v is None:
                    continue
                var = block.find_var_recursive(n)
                if var is not None and var.persistable and not local:
                    _write_persistable(scope, n, v, strict)
                else:
                    env[n] = v


def _dump_thread_stacks() -> str:
    """Stacks of every live thread: the watchdog's post-mortem payload
    (which thread is wedged, and where)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(tid, '?')} ({tid}) ---\n"
                   + "".join(traceback.format_stack(frame)))
    return "".join(out)


class DeadlineWorker:
    """The worker thread of one `_deadline_call`. `done` is set when `fn`
    has returned or raised; on a CUDA device, `cuda_done` is an event
    recorded on the worker's stream after `fn` (its `.cpu()` included), so
    it completes when every kernel `fn` queued there has run. A tripped
    call leaves its worker running: its owner must not reuse what the
    worker touches until `quiet` says so."""

    def __init__(self, device: Optional[torch.device], stream):
        self.device = device
        self.stream = stream
        self.done = threading.Event()
        self.cuda_done = None
        self.value = None
        self.error: Optional[BaseException] = None

    def run(self, fn: Callable):
        try:
            with torch.no_grad(), _on_stream(self.device, self.stream):
                try:
                    self.value = fn()
                finally:
                    if self.stream is not None:
                        ev = torch.cuda.Event()
                        ev.record(self.stream)
                        self.cuda_done = ev
        except BaseException as e:     # re-raised on the caller's thread
            self.error = e
        finally:
            self.done.set()

    def quiet(self, timeout_s: float) -> bool:
        """Whether the worker has returned and its device work completed,
        waiting at most `timeout_s`."""
        deadline = time.monotonic() + timeout_s
        if not self.done.wait(timeout_s):
            return False
        while self.cuda_done is not None and not self.cuda_done.query():
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.001)
        return True


@contextlib.contextmanager
def _on_stream(device, stream):
    """`torch.cuda.device(device)` and `torch.cuda.stream(stream)` on a
    CUDA device; nothing otherwise."""
    if device is None or device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _deadline_call(fn: Callable, deadline_ms: float, what: str,
                   device: Optional[torch.device] = None, stream=None,
                   on_trip: Optional[Callable[[DeadlineWorker], None]]
                   = None):
    """Step watchdog (FLAGS_step_deadline_ms; counterpart of
    paddle_tpu/framework/executor.py `_deadline_call`): run `fn` on a
    worker thread, under torch.no_grad(), on `device` and on `stream` (the
    caller's own, so the work does not depend on the worker thread's
    current stream), and join it with the deadline.

    On a trip: count `executor.step_deadline_trips`, call `on_trip(worker)`
    (the owner records the abandoned worker and closes its flight step),
    flight-dump with the thread stacks, and raise the typed
    DeadlineExceededError (its `.worker` is the abandoned worker). The
    worker cannot be cancelled: it runs on (daemon), still inside `fn`,
    and whatever `fn` touches (static buffers, pools) stays in use until
    `worker.quiet()`."""
    worker = DeadlineWorker(device, stream)
    t = threading.Thread(target=worker.run, args=(fn,), daemon=True,
                         name="executor-step")
    t.start()
    if not worker.done.wait(deadline_ms / 1000.0):
        stat_add("executor.step_deadline_trips")
        stacks = _dump_thread_stacks()
        if on_trip is not None:
            on_trip(worker)
        dump_path = _flight.dump(
            "step_deadline",
            extra={"what": what, "deadline_ms": deadline_ms,
                   "thread_stacks": stacks})
        err = errors.DeadlineExceeded(
            "%s exceeded FLAGS_step_deadline_ms=%s; flight-recorder dump: "
            "%s; thread stacks:\n%s", what, deadline_ms,
            dump_path or "<disabled>", stacks)
        err.worker = worker
        raise err
    if worker.error is not None:
        raise worker.error
    return worker.value
