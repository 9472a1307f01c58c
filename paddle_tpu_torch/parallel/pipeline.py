"""Pipeline parallelism over the mesh's pp axis (counterpart of
paddle_tpu/parallel/pipeline.py:68-498, `_PipelineBlock` and
`stage_devices`).

The reference's pipeline is single-controller: one process places every
stage on its own devices, and so does the port's. Stage s runs on the
mesh's device s (parallel/mesh.py); two stages may share one device.

* The ops are partitioned by role: LR schedule, forward, backward,
  optimizer.
* Forward stages come from the ops' `pipeline_stage` attrs
  (`device_guard`), propagated forward to ops without one; an op whose
  stage is below one of its inputs' raises `InvalidArgument`.
* A parameter's home is the stage of its first reader: a tied `wte` read
  by stage 0 and by the head lives on stage 0, the last stage reads a
  copy, and the `sum` of its gradient contributions runs where the
  earliest contribution lives (stage 0), so both land in one gradient
  before the update, once.
* Backward ops follow their forward op's stage; optimizer ops their
  parameter's. The optimizer state (moments) lives with the op that
  first reads it.
* The number of stages must equal the mesh's pp size, else
  `InvalidArgument`.
* The stage's state lives on its device: the runner moves a parameter or
  moment that is elsewhere before the step. Values that cross stages
  cross with `.to(device)`. Every stage runs on its device's current
  stream, so two stages sharing a card share its stream, and the caching
  allocator needs no cross-stream bookkeeping.
* Schedule: the LR-schedule ops once a step; then, over K microbatch
  slices of the feeds, the forward segments of every stage for
  microbatch m, and the backward segments of microbatch m - delay + 1,
  in 1F1B issue order with delay = number of stages (1 when a backward
  segment writes a persistable, so each microbatch sees the one
  before's); the gradients the optimizer reads are summed over the
  microbatches and divided by K, and the optimizer segments run once, in
  program order. At most ~S + 1 microbatch environments (activations and
  kept pullbacks) are alive: `last_max_live_envs` records the step's
  peak. The reference's devices each run their queue asynchronously;
  here one host thread issues every segment, so on one device the
  schedule changes which activations are alive, not what overlaps.
* Randomness: every stage draws from the same run seed, and each random
  op keys off its `__rng_seed__` attr, so the masks equal those of the
  one-device GPipe run.

Float fetches the body computes come back as the microbatch mean.

Data parallelism (dp x pp, one process per dp rank, each with its own
stage devices: parallel/mesh.py). Each rank pipelines its local batch.
After the K microbatches' gradients are summed and divided by K, and
before the one optimizer pass, the runner averages them over the ranks
(`_dp_average`): every floating value the optimizer reads from the body
(the gradients, a tied `wte`'s already summed over its stages) is
concatenated in f32 per device, all-reduced (sum), scaled by 1/dp and
cast back, as `__bucket_sync__` does, so one all-reduce a step where the
stages share a card (`collectives_per_step`). Pipelined programs skip the
bucket pass (fleet), so this is their only dp collective; the executor
then reduces the fetches as it does at dp > 1 (a float scalar is the
replica mean).

Tensor and sequence parallelism (pp x tp x sp, one process per (dp, tp,
sp) coordinate, each with its own P stage devices: parallel/mesh.py).
The executor runs the step on DTensors (parallel/gspmd.py): the runner
cuts the GLOBAL feeds into microbatches and places each microbatch on the
mesh (dim 0 over dp), every stage's lowerings see the mesh, each stage's
state is a DTensor whose local shard lives on the stage's device, and a
value that crosses stages moves its local shard to the next stage's
device and keeps its placements (`_to_device`). DTensor reduces the
gradients over dp and tp where the optimizer reads them, so `_dp_average`
(the manual-dp path) does not run there. On one card every stage device
is `cuda:0`, so no crossing between two GPUs has run.

Over one device (a PipelineOptimizer program without a pp mesh) the same
runner is GPipe (the reference's `_run_block_microbatched`,
framework/executor.py:457-585): every op on stage 0, whatever its
`device_guard`, and delay 1, so each microbatch runs its forward, then its
backward.
"""
from __future__ import annotations

from typing import Dict, List, Set

import torch

from ..framework import errors
from ..framework.program import OpRole
from ..ops import registry


def _op_reads(op) -> List[str]:
    return [n for names in op.inputs.values() for n in names
            if n != "@EMPTY@"]


def _op_writes(op) -> List[str]:
    return [n for names in op.outputs.values() for n in names
            if n != "@EMPTY@"]


def _grad_base(name: str) -> str:
    return name.split("@GRAD")[0]


def _to_device(v, dev):
    """`v` on `dev`: a DTensor's local shard moved there and wrapped back
    with its placements (module docstring)."""
    from . import gspmd
    if not gspmd.is_dtensor(v):
        return v if v.device == dev else v.to(dev)
    loc = v.to_local()
    if loc.device == dev:
        return v
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(loc.to(dev), v.device_mesh, v.placements,
                              run_check=False, shape=v.shape,
                              stride=v.stride())


class _Segment:
    """A run of same-stage ops, (block index, op) pairs in program order.
    `in_names`: what its ops read before writing it; `out_names`: what it
    writes that is needed outside it (later segments, fetches)."""

    def __init__(self, ops, stage: int, name: str, out_keep: Set[str]):
        self.ops = list(ops)
        self.stage = stage
        self.name = name
        produced: Set[str] = set()
        reads: List[str] = []
        for _, op in self.ops:
            for n in _op_reads(op):
                if n not in produced and n not in reads:
                    reads.append(n)
            produced.update(_op_writes(op))
        self.in_names = reads
        self.out_names = [n for n in dict.fromkeys(
            n for _, op in self.ops for n in _op_writes(op)) if n in out_keep]

    def writes(self) -> List[str]:
        return list(dict.fromkeys(
            n for _, op in self.ops for n in _op_writes(op)))


class _PipelineBlock:
    """The pipeline step of one program over `devices`, one a stage: the
    attached mesh's pp axis, or the executor's device alone for GPipe
    (module docstring). `plan` is the executor's grad plan: a forward op
    and the grad op that reuses its pullback run on one stage."""

    def __init__(self, program, fetch_names, state_names, plan, devices):
        self.program = program
        self.block = program.global_block()
        self.fetch_names = list(fetch_names)
        self.state_names = list(state_names)
        self.micro_k = max(1, int(getattr(program, "_microbatch_k", 0) or 1))
        self.devices = [torch.device(d) for d in devices]
        pp = len(self.devices)

        sched_ops, fwd_ops, bwd_ops, opt_ops = [], [], [], []
        for idx, op in enumerate(self.block.ops):
            role = op.attrs.get("op_role", 0)
            if role == OpRole.LRSched:
                sched_ops.append((idx, op))
            elif role & OpRole.Optimize:
                opt_ops.append((idx, op))
            elif role & OpRole.Backward:
                bwd_ops.append((idx, op))
            else:
                fwd_ops.append((idx, op))

        if pp == 1:
            # GPipe on one device: every op on stage 0, device_guard
            # attrs ignored, as the reference's one-device runner does
            op_stage = {idx: 0 for idx in range(len(self.block.ops))}
            var_stage = {n: 0 for n in self.state_names}
            num_stages = 1
        else:
            op_stage, var_stage, num_stages = self._assign_stages(
                fwd_ops, bwd_ops, opt_ops, plan, pp)
        self.num_stages = num_stages
        self.var_stage = var_stage

        def ops_at(ops, s):
            return [(i, op) for i, op in ops if op_stage[i] == s]

        groups = [(sched_ops, 0, "sched")]
        groups += [(ops_at(fwd_ops, s), s, f"fwd{s}")
                   for s in range(num_stages)]
        groups += [(ops_at(bwd_ops, s), s, f"bwd{s}")
                   for s in reversed(range(num_stages))]
        opt_groups: List[list] = []
        for i, op in opt_ops:
            s = op_stage[i]
            if opt_groups and opt_groups[-1][1] == s:
                opt_groups[-1][0].append((i, op))
            else:
                opt_groups.append([[(i, op)], s,
                                   f"opt{len(opt_groups)}@{s}"])
        groups += [tuple(g) for g in opt_groups]

        reads_by_others: Set[str] = set()
        for ops, _, _ in groups:
            local: Set[str] = set()
            for _, op in ops:
                reads_by_others.update(n for n in _op_reads(op)
                                       if n not in local)
                local.update(_op_writes(op))
        self.written_pers = list(dict.fromkeys(
            n for ops, _, _ in groups for _, op in ops
            for n in _op_writes(op)
            if (v := self.block.find_var_recursive(n)) is not None
            and v.persistable))
        out_keep = reads_by_others | set(self.fetch_names)

        segs = [_Segment(ops, s, name, out_keep) for ops, s, name in groups]
        self.sched_seg = segs[0]
        self.fwd_segs = segs[1:1 + num_stages]
        self.bwd_segs = segs[1 + num_stages:1 + 2 * num_stages]
        self.opt_segs = segs[1 + 2 * num_stages:]

        body_writes: Set[str] = set()
        for seg in self.fwd_segs + self.bwd_segs:
            body_writes.update(seg.writes())
        opt_reads = {n for seg in self.opt_segs for n in seg.in_names}
        self.acc_names = sorted(body_writes & opt_reads)
        self.body_writes = body_writes
        self.plan = plan
        self.last_max_live_envs = 0
        self.collectives_per_step = 0

    def _assign_stages(self, fwd_ops, bwd_ops, opt_ops, plan, pp):
        """(op index -> stage, state/var name -> stage, number of stages)
        of a pp > 1 program (module docstring)."""
        state_set = set(self.state_names)
        var_stage: Dict[str, int] = {}
        op_stage: Dict[int, int] = {}

        def home(op, s):
            for n in _op_reads(op):       # state: home = first reader
                if n not in var_stage and n in state_set:
                    var_stage[n] = s

        # forward: device_guard attrs, propagated to ops without one
        for idx, op in fwd_ops:
            ins = [var_stage[n] for n in _op_reads(op) if n in var_stage]
            s = op.attrs.get("pipeline_stage")
            if s is None:
                s = max(ins) if ins else 0
            elif ins and s < max(ins):
                raise errors.InvalidArgument(
                    "pipeline: op %r at device_guard stage %d consumes a "
                    "var produced at stage %d: stages must not go down "
                    "along the program", op.type, s, max(ins), op=op.type)
            op_stage[idx] = s = int(s)
            home(op, s)
            for n in _op_writes(op):
                var_stage[n] = s
        num_stages = 1 + max(op_stage.values(), default=0)
        if num_stages != pp:
            raise errors.InvalidArgument(
                "pipeline: the program has %d device_guard stages but the "
                "mesh's pp axis is %d: they must match (annotate ops with "
                "device_guard('gpu:<stage>'))", num_stages, pp)

        # backward: with the forward op (a paired grad op runs the
        # pullback its forward op kept, on that op's device)
        fwd_of = {v: k for k, v in plan.items()}
        for idx, op in bwd_ops:
            s = op_stage.get(fwd_of.get(idx))
            if s is None and op.type == "__vjp__":
                s = op.attrs.get("fwd_attrs", {}).get("pipeline_stage")
            if s is None:
                known = [var_stage[n] for n in _op_reads(op)
                         if n in var_stage]
                if op.type == "sum" and known:
                    # gradient aggregation runs where the EARLIEST
                    # contribution lives; later stages' flow back to it
                    s = min(known)
                elif known:
                    s = max(known)
                else:
                    # the loss-grad seed (no inputs): its var's stage
                    s = num_stages - 1
                    for n in _op_writes(op):
                        if _grad_base(n) in var_stage:
                            s = var_stage[_grad_base(n)]
                            break
            op_stage[idx] = s = int(s)
            home(op, s)
            for n in _op_writes(op):
                var_stage[n] = s

        # optimizer: with the parameter it updates
        for idx, op in opt_ops:
            pnames = op.inputs.get("Param", [])
            if pnames and pnames[0] in var_stage:
                s = var_stage[pnames[0]]
            else:
                known = [var_stage[n] for n in _op_reads(op)
                         if n in var_stage]
                s = max(known) if known else 0
            op_stage[idx] = s = int(s)
            home(op, s)
            for n in _op_writes(op):
                var_stage.setdefault(n, s)
        # state no section reads lives on stage 0
        for n in self.state_names:
            var_stage.setdefault(n, 0)
        return op_stage, var_stage, num_stages

    # -- placement --------------------------------------------------------
    def _place_state(self, scope):
        """Every state tensor on its home stage's device (a parameter or
        moment a checkpoint load or the startup program put elsewhere is
        moved)."""
        for n in self.state_names:
            t = scope.find(n)
            if isinstance(t, torch.Tensor):
                moved = _to_device(t, self.devices[self.var_stage[n]])
                if moved is not t:
                    scope.set(n, moved)

    def _run_seg(self, seg, env, lookup, scope, ctxs, amp_dtype, saved):
        """Run `seg` on its stage's device over its inputs (moved there),
        then put what it writes for later segments into `env`."""
        if not seg.ops:
            return
        from ..framework.executor import _run_block
        dev = self.devices[seg.stage]
        seg_env = {}
        for n in seg.in_names:
            v = lookup(n)
            if v is None:
                raise errors.NotFound(
                    "pipeline: var %r is not in the scope and no pipeline "
                    "section produces it before use", n, var=n)
            seg_env[n] = _to_device(v, dev)
        with _on_device(dev):
            _run_block(self.block, self.plan, seg_env, scope,
                       ctxs[seg.stage], amp_dtype, ops=seg.ops, saved=saved)
        for n in seg.out_names:
            if n in seg_env:
                env[n] = seg_env[n]

    def _dp_average(self, env, dp):
        """The summed-and-scaled gradients averaged over the dp ranks, as
        `__bucket_sync__` averages a bucket: per device, the gradients
        concatenated in f32, one all-reduce (sum), `* 1/dp`, each piece
        cast back to its gradient's dtype."""
        from ..distributed.collective import all_reduce
        groups: Dict[str, List[str]] = {}
        for n in self.acc_names:
            v = env.get(n)
            if v is not None and v.is_floating_point():
                groups.setdefault(str(v.device), []).append(n)
        with torch.no_grad():
            for key in sorted(groups):
                names = groups[key]
                flat = torch.cat([env[n].reshape(-1).to(torch.float32)
                                  for n in names])
                flat = all_reduce(flat) * (1.0 / dp)
                off = 0
                for n in names:
                    v = env[n]
                    env[n] = flat[off:off + v.numel()].reshape(v.shape) \
                        .to(v.dtype)
                    off += v.numel()
        self.collectives_per_step = len(groups)

    # -- the step ---------------------------------------------------------
    def step(self, feeds, scope, ctx, amp_dtype, place=None):
        """One step over `feeds`; `place(name, tensor)` (a tp/sp mesh)
        places each microbatch's feeds on the mesh."""
        from ..framework.executor import _fetch_values, _split_feeds
        K = self.micro_k
        micro_feeds = _split_feeds(feeds, K) if K > 1 else [dict(feeds)]
        if place is not None:
            micro_feeds = [{n: place(n, t) for n, t in m.items()}
                           for m in micro_feeds]
        self._place_state(scope)
        # one run seed on every stage's device: the same keys everywhere
        # (a pipeline step is never captured, so the seed is an int)
        ctxs = [registry.LowerCtx(run_seed=ctx.run_seed, device=d,
                                  mesh=ctx.mesh)
                for d in self.devices]

        env_step: Dict[str, torch.Tensor] = {}

        def lookup_static(n):
            return env_step[n] if n in env_step else scope.find(n)

        self._run_seg(self.sched_seg, env_step, lookup_static, scope, ctxs,
                      amp_dtype, {})

        acc: Dict[str, torch.Tensor] = {}
        fetch_stack: Dict[str, List[torch.Tensor]] = {
            n: [] for n in self.fetch_names if n in self.body_writes}
        live: Dict[int, tuple] = {}
        bwd_writes_pers = any(n in self.written_pers
                              for seg in self.bwd_segs for n in seg.writes())
        delay = 1 if bwd_writes_pers else self.num_stages

        def run_phase(segs, env_m, saved):
            def lookup(n):
                return env_m[n] if n in env_m else lookup_static(n)
            for seg in segs:
                self._run_seg(seg, env_m, lookup, scope, ctxs, amp_dtype,
                              saved)

        def issue_bwd(m):
            env_m, saved = live.pop(m)
            run_phase(self.bwd_segs, env_m, saved)
            for n in self.acc_names:
                v = env_m.get(n)
                if v is None:
                    continue
                if n in acc and v.is_floating_point():
                    acc[n] = acc[n] + _to_device(v, acc[n].device)
                else:
                    acc[n] = v          # the first, or non-float: the last
            for n in fetch_stack:
                if n in env_m:
                    fetch_stack[n].append(env_m[n])

        next_bwd, max_live = 0, 0
        for m in range(K):
            live[m] = (dict(micro_feeds[m]), {})
            max_live = max(max_live, len(live))
            run_phase(self.fwd_segs, *live[m])
            if m - next_bwd >= delay - 1:
                issue_bwd(next_bwd)
                next_bwd += 1
        while next_bwd < K:
            issue_bwd(next_bwd)
            next_bwd += 1
        # the 1F1B window's peak of live microbatch environments: about
        # num_stages (+1), not num_microbatches
        self.last_max_live_envs = max_live
        for n, v in acc.items():
            env_step[n] = v / K if v.is_floating_point() else v
        from .zero import current_manual_dp
        manual = current_manual_dp()
        if manual is not None and manual[1] > 1:
            self._dp_average(env_step, manual[1])

        for seg in self.opt_segs:
            self._run_seg(seg, env_step, lookup_static, scope, ctxs,
                          amp_dtype, {})

        for n, vs in fetch_stack.items():
            if not vs:
                continue
            if vs[-1].is_floating_point():
                dev = vs[0].device
                env_step[n] = torch.stack([_to_device(v, dev)
                                           for v in vs]).mean(0)
            else:
                env_step[n] = vs[-1]
        return _fetch_values(env_step, scope, self.fetch_names)


def _on_device(dev):
    """`torch.cuda.device(dev)` for a CUDA device: ops without inputs and
    the current stream are that device's."""
    import contextlib
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def stage_devices(pipeline_block: _PipelineBlock, stage: int):
    """The devices of a stage (a list of one; for placement checks)."""
    return [pipeline_block.devices[stage]]
