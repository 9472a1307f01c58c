#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (paddle_tpu_torch).

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. the card's name and power limit (nvidia-smi);
2. the build: every CUDA source under paddle_tpu_torch/csrc, one nvcc each,
   all started together;
3. the paged-attention kernels B4/B5 at the serving main path's widths
   (batch 8, 12 heads, head_dim 64, block 16, max_len 1024, 12 pool
   layers; ragged positions and the edges of a chunk and of the table,
   a bounded walk and one slot alone bit-equal to the full batch; f32,
   bf16 and int8 pools, and a bf16 pool read with an f32 query, the
   int8-weight arm's <bf16 KV, f32 Q> instance), timed
   with the layer cycling over the 12 layers: alone in a CUDA graph,
   through the wrapper, the plain version and SDPA on a dense cache; and
   the flash-attention kernels B1-B3 at the training main
   path's shapes (batch 16, 12 heads, S 512, head_dim 64) in four arms
   (f32 + key-padding mask + dropout 0.1, the training path's; bf16 + mask
   + dropout 0.1; bf16 causal + dropout 0.1; f32 unmasked) and off it (f32,
   S 200, head_dim 128, per-(b, h) mask, causal, dropout 0.1; f32, batch
   4, S 512, head_dim 128, key-padding mask, dropout 0.1), each held
   element by element against its plain PyTorch version on the card and
   timed beside it and beside the PyTorch library call (SDPA) where one
   computes the same; B1's lse against logsumexp of the plain scores and
   B2's delta buffer against its plain version; the count of tensor-core
   (HMMA) instructions in each kernel's SASS (none in an instance of B1
   fails); and B1-B3 at the GPT training path's shape (batch 32, 12 heads,
   S 512, head_dim 64, causal, no mask, dropout 0.1, f32 as AMP hands it
   there), the dropout seed a tensor in device memory, beside SDPA's
   causal call and the bound of the causal half of the products;
4. GPT-2 small (GPTConfig(), weights from numpy seed 0) served through the
   port's DecodeEngine, every CUDA engine replaying its captured window
   (no eager call; B4 launches counted per replay):
   * f32 (TF32 off): greedy tokens == the port's dense generate;
   * bf16: 8 concurrent requests (prompts 17-200 tokens, 32 new, greedy and
     one seeded top-k) on the captured window and on the eager window
     body: equal tokens; tokens/s, TTFT p50/p99, TPOT p50 and, under
     torch.profiler, the device busy share and launches of both;
     continuous == sequential;
   * bf16 prefix cache: 8 requests sharing a 96-token system prompt with
     8-72-token tails, 32 new tokens each, after a warm-up that publishes
     the system prompt: cache-on == cache-off tokens, 8 hits, TTFT of both;
   * bf16 speculative decoding with the int8 draft of the same
     checkpoint, gamma 4, on the 8 requests: spec-on == spec-off tokens,
     acceptance, tokens/s, B4 launched in the draft and verify graphs;
   * int8 weights (from the f32 checkpoint; the matrices dequantized to
     bf16, the biases f32, so the activations are f32): 8 requests, every
     B4 call a bf16 pool with an f32 query (the <bf16 KV, f32 Q> row's
     launches);
   * bf16 with int8 KV pools: 2 requests complete;
   * the fault-tolerant tier: first, as a control, one bf16 replica
     behind its own ServingFrontend on the 8 requests; then two bf16
     replicas over one weight copy (shared data_ptr gated) behind a
     ServingFrontend, each replaying its own captured window: the 8
     requests undisturbed (both setups timed with their window replays
     and service threads' CPU seconds, then profiled once for the card's
     kernel time); again with
     `serving.window:error:at=3` killing a replica mid-stream (every
     request completes with the single-engine tokens through failover,
     and the dead replica comes back LIVE through the canary, bounded
     wait); a batch across both replicas, each counting B4 launches from
     replays and no eager call; the window watchdog at 2 ms, below one
     window's replay (every request fails typed with no hang, the flight
     dumps hold `sla_trip` steps, one trip or more with the window in
     flight, and after the flag is reset both
     replicas resurrect and serve the single-engine tokens); a drain of
     32 requests (the finished ones equal the single-engine tokens, the
     unstarted ones come back);
5. the fused flat-bucket optimizer kernels B6-B8 (sgd, momentum with
   nesterov + l2_decay and plain, adam, adamw) at the main path's bucket
   sizes (23,440,896 and 7,120,704 elements) and a tail (1,000,003), and
   B8 on a bucket one element past 16 bytes and on one whose arrays start
   at different offsets, held BIT FOR BIT against their plain version on
   the card, timed beside it, beside the bytes bound and beside PyTorch's
   fused optimizer calls; B8 also timed alone, without its wrapper, and
   B6/B7 alone at 23,440,896 and 1,000,003 elements beside
   torch._fused_sgd_ (the small size over copies used in turn, past the
   L2);
6. BERT pretraining through Program / Executor.run:
   * card vs CPU: BERT-base widths at 2 layers, S 512, batch 2, f32, TF32
     off, dropout 0, padding mask; one step from the same startup arrays;
     the loss and every parameter gradient agree;
   * BertConfig() at S 512, batch 16, fleet AMP bf16, Adam 1e-4, default
     32 MB gradient buckets, at ZeRO stage 0 and stage 1 in alternation on
     one host state: 2 warm-up and 10 timed steps each, finite losses,
     exactly one B8 launch per bucket and step at stage 1, then one step
     of each under torch.profiler;
   * under torch.use_deterministic_algorithms: stage 1 against stage 0
     (BERT-base widths at 2 layers, S 512, batch 2, f32, dropout 0, 3
     steps), then the off-path arms (2 layers, batch 4, AMP, 3 steps
     each): stages 2 and 3 against stage 1, SGD, Momentum (nesterov) and
     AdamW with global-norm clipping at stage 1, each through its kernel;
7. GPT-2 small LM training through build_lm_program and the Executor:
   * card vs CPU: GPT-2 small widths at 2 layers, S 512, batch 2, f32, TF32
     off, dropout 0, the fused head; one step from the same startup arrays;
   * captured == eager, bit for bit: GPTConfig() at S 512, batch 32, fleet
     AMP bf16, Adam 1e-4, dropout 0.1, at ZeRO stage 0 and at stage 1 (B8
     inside the graph): run_steps(3) (one capture, three replays) against
     3 Executor.run calls from one startup state, losses and every
     persistable; no eager step in the captured arm; B1-B3 12 launches a
     step, B8 one a bucket and step;
   * stage 0 timed: 10 eager Executor.run steps, then run_steps(10) windows
     replaying the captured step (the cache emptied between the arms):
     step ms p50, tokens/s, MFU, peak memory, replays and eager steps,
     launches per step, one window of each under torch.profiler (the top
     kernels and the GEMMs' device time); the fused LM head alone
     (forward and backward at the step's shapes, bf16 operands as AMP
     hands them) under the profiler: its kernels and its GEMMs' time;
     then the trained weights (params_from_scope) serve 2 greedy requests
     equal to the dense generate;
8. GPT-2 small training that survives a restart: GPTConfig() at S 512,
   batch 32, fleet AMP bf16, ZeRO stage 1, AdamW +
   GradientClipByGlobalNorm(1.0), dropout 0.1, the LR
   linear_lr_warmup(cosine_decay(...)) built in the program:
   * the schedule under capture: run_steps(3) == 3 Executor.run calls bit
     for bit (losses, the fetched LR, every persistable, the LR counter),
     the LR within 1 f32 ulp of the host formula and rising then falling,
     B8 one launch per bucket and step inside the graph; a host
     LinearWarmup scheduler stepped between three run_steps(3) calls with
     one capture in all; SGD and Momentum at stage 1 under the schedule (2
     layers, batch 4): captured == eager, B6 / B7 in the graph;
   * resume: 6 captured steps straight against 3, CheckpointManager.save,
     the executor, scope and graph pool dropped, restore_latest into a
     rebuilt program, fresh executor and scope, 3 more: bit for bit
     (losses, every persistable, the run-seed counter), dropout on; the
     checkpoint's bytes, save / validate / restore ms by span, each arm's
     peak memory;
   * rollback: snapshots every 2 steps, NaN written into a row of `wte`
     before step 5, TrainingGuard rolls back and skips the batch: the
     losses after it and the final fingerprint == a run that never saw it;
   * the snapshot's cost: run_steps(10) windows of the schedule with
     FLAGS_snapshot_steps 10 and 0 and of a constant LR, in ABBA order on
     one executor: step ms p50 of each, the copy to pinned memory (device
     ms), the worker's and the calling thread's ms, the skips;
9. GPT-2 small trained from data, phase 8's program on one executor and
   scope (one capture for every arm): a token file of 16,777,216 int32
   tokens and 4 MultiSlot text files of 1,280 of its 512-token windows,
   written from numpy seed 11; the one-batch arm (run_steps(10) windows of
   one batch) before and after arms L (a memory-mapped Dataset through
   DataLoader(batch 32, a seeded RandomSampler, 4 forkserver workers)
   into train_from_dataset(steps_per_loop=10)) and M (InMemoryDataset, 4
   threads, load_into_memory and local_shuffle on the native plane, into
   the same), 40 batches an epoch, in the order L, M, M, L: step ms of
   each window to the next, executor.h2d_ms a step, one window of L under
   torch.profiler; gates: the first L and the first M equal, bit for bit
   (losses and every persistable), run_steps(10) fed the same batches
   stacked on the host from the same state; one capture, no eager step
   and 12 B1-B3 launches a step over all windows; the loader rebuilt at
   the same seed, past the 20 batches of two windows, yields batch 20;
   a dataloader.worker kill is respawned once at
   FLAGS_dataloader_max_respawns 1 with the same batches and fails naming
   exit code 43 at 0; prefetch(exe) into 3 Executor.run steps takes
   every staged feed by identity, coerces none at the run and leaves
   nothing staged; tests/test_torch_capture_lock.py's two-thread check
   (a training capture and a serving capture at once, a dead executor
   cycle pending);
10. data parallelism across processes: the port's launcher (`python -m
   paddle_tpu_torch.distributed.launch --nproc_per_node 2 chip_smoke.py
   --dp-worker`) starts two ranks that share cuda:0 under gloo, as asked
   for explicitly (PADDLE_DIST_BACKEND=gloo, PADDLE_DIST_DEVICE=cuda:0).
   Each trains GPT-2 small at S 512 on its 16 rows of a global batch of
   32 (fleet AMP bf16, AdamW + global-norm clip, dropout 0), 3 eager steps
   at each of ZeRO stages 0-3 from the startup program's weights. Gates:
   stage k == stage 0 bit for bit (losses and every parameter); rank 0 ==
   rank 1 by the DivergenceSentinel (after startup and after each stage);
   B1-B3 12 launches a step and B8 one a bucket and step at the shard
   width on each rank; each step's collectives equal the plan; stage 1
   holds half of stage 0's optimizer state a rank, give or take the
   padding; the gang ends and leaves no process. Then: two ranks asking
   for NCCL on one card both raise the port's typed error (no hang); one
   process at batch 32 from the same weights (the loss of each step
   within 1e-4 relative of dp 2's); on an NCCL group of one, a
   reduce-scatter, an all-gather and an all-reduce through the port's
   collectives captured in a CUDA graph, three replays equal to the eager
   calls; B8 (adamw) bit for bit against its plain version at the shard
   width of GPT-2 small's largest bucket at dp 2, timed.
Each main-path run resets the kernel launch counts just before it and
fails if a kernel of its path was never launched.

Teardown: the script adopts its orphaned descendants (a subreaper) and,
before the result lines and again on a failure, stops every process it
started, the DataLoader's forkserver and multiprocessing's resource
tracker included, and waits for each to end.

Output: a `{"kernels": [...]}` line, a `{"serving": ...}` line, a
`{"resilience": ...}` line, a `{"training": ...}` line, a
`{"gpt_training": ...}` line, a `{"training_state": ...}` line, a
`{"data_path": ...}` line, a `{"data_parallel": ...}` line, and last
`{"ok": true, "device": {...}}`.
The flash rows' `launches` are the GPT path's (the captured arm's 30
timed steps); `launches_by_path` keeps the BERT path's beside them.
"""
import contextlib
import itertools
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
_PAGED = ("paddle_tpu_torch/csrc/paged_attention.cu",
          "paddle_tpu/ops/pallas/paged_attention.py")
_FLASH = ("paddle_tpu_torch/csrc/flash_attention.cu",
          "paddle_tpu/ops/pallas/flash_attention.py")
_ZERO = ("paddle_tpu_torch/csrc/zero_update.cu",
         "paddle_tpu/ops/pallas/zero_update.py")
# one entry per row of the kernels line: the CUDA source, and file:line of
# the Pallas kernel it replaces
ROWS = {
    "paged_decode_f32": (_PAGED[0], f"{_PAGED[1]}:98"),
    "paged_decode_bf16": (_PAGED[0], f"{_PAGED[1]}:98"),
    "paged_decode_bf16_f32q": (_PAGED[0], f"{_PAGED[1]}:98"),
    "paged_decode_int8": (_PAGED[0], f"{_PAGED[1]}:145"),
    "flash_fwd": (_FLASH[0], f"{_FLASH[1]}:145"),
    "flash_bwd_dq": (_FLASH[0], f"{_FLASH[1]}:282"),
    "flash_bwd_dkdv": (_FLASH[0], f"{_FLASH[1]}:346"),
    "zero_sgd": (_ZERO[0], f"{_ZERO[1]}:89"),
    "zero_momentum": (_ZERO[0], f"{_ZERO[1]}:94"),
    "zero_adam": (_ZERO[0], f"{_ZERO[1]}:108"),
}
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth, the
# f32 CUDA-core rate (kept beside the flash kernels' tensor-core bounds),
# the TF32 tensor-core rate and the bf16 tensor-core rate (the MFU
# denominator, as bench.py counts it). f32 operands on the tensor cores at
# f32 accuracy take three TF32 products (3xTF32): a third of the TF32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 494.7e12
BF16_FLOPS_PER_S = 989.4e12
# paged kernel vs plain version on the card: f32 sums in another order; bf16
# outputs round to bf16 (one ulp of an O(1) context is <= 2**-7), and the
# kernel weighs V by unrounded f32 probabilities where the plain version
# rounds them to bf16; int8 outputs are f32
TOLERANCE = {"f32": 1e-5, "bf16": 1.6e-2, "int8": 1e-4, "bf16_f32q": 1.6e-2}
# mangled-name prefixes of the paged kernels each pool kind runs: pass 1
# <KV, Q, HD> and the merge <Out, HD>
PAGED_MANGLED = {
    "f32": ("paged_decode_kernelIffLi", "paged_decode_kernel_mergeIfLi"),
    "bf16": ("paged_decode_kernelI13__nv_bfloat16S",
             "paged_decode_kernel_mergeI13__nv_bfloat16Li"),
    "int8": ("paged_decode_kernelIa", "paged_decode_kernel_mergeIfLi"),
    "bf16_f32q": ("paged_decode_kernelI13__nv_bfloat16fLi",
                  "paged_decode_kernel_mergeI13__nv_bfloat16Li")}
# flash kernels vs plain version, element by element over O and over dQ,
# dK and dV (inputs ~N(0, 1)): |kernel - plain| <= atol + rtol * |plain|.
# f32 sums in another order: absolute, the reference suite's own 2e-5 for
# O and 5e-4 for gradients. bf16 outputs round to bf16, one ulp being at
# most 2**-7 of the value (rtol). atol covers the other rounding points:
# the kernels round unnormalised probabilities and dS to bf16 where the
# plain version rounds normalised probabilities only, and they take delta
# from O as stored in bf16, so on the first causal rows dP - delta leaves
# a residue where the plain version's cancels exactly. On an H100 at these
# inputs the largest atol needed was 5.3e-3 (O) and 1.92e-2 (dK, causal),
# the same in every run; the limits keep a 1.5x margin.
FLASH_TOLERANCE = {"float32": {"o": (2e-5, 0.0), "grad": (5e-4, 0.0)},
                   "bfloat16": {"o": (8e-3, 2 ** -7),
                                "grad": (3e-2, 2 ** -7)}}
# the fused update kernels B6-B8 at the BERT-base stage-1 path's bucket sizes
# (the word embedding / MLM head bucket, a 32 MB bucket) and a ragged tail;
# bytes each element moves: sgd reads p, g and writes p; momentum also
# reads and writes v; adam reads and writes m1 and m2
ZERO_SIZES = (23_440_896, 7_120_704, 1_000_003)
ZERO_BYTES_PER_ELEMENT = {"zero_sgd": 12, "zero_momentum": 20,
                          "zero_adam": 28}
# the BERT-base stage-1 program at the default 32 MB buckets
ZERO_MAIN_PATH_BUCKETS = 14
# the sizes B6/B7 are also timed at on the launch alone
B6_B7_ALONE_SIZES = (23_440_896, 1_000_003)
# GPT-2 small training as bench.py's bench_gpt runs it: seq 512, batch 32;
# run_steps windows of 10 steps
GPT_BATCH, GPT_SEQ, GPT_WINDOW = 32, 512, 10


def log(msg):
    print(f"chip_smoke: {msg}", flush=True)


def kernel_row(name, **numbers):
    """A row of the kernels line: its name, route, source and the TPU
    kernel it replaces, then the measured numbers."""
    source, replaces = ROWS[name]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None, **numbers)


def ptxas_report(text):
    """{mangled entry name: {registers, spill_stores, spill_loads}} from
    the `nvcc -Xptxas -v` output of one build."""
    report, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = report.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None:
            entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            entry["registers"] = int(m.group(1))
    return report


def sass_mma_counts(lib):
    """{mangled function name: number of HMMA instructions} in the SASS of
    the built library `lib` (cuobjdump -sass), or None where the toolkit has
    no cuobjdump."""
    from paddle_tpu_torch.ops.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bHMMA\b", line):
            counts[fn] += 1
    return counts


def flash_ptxas(report, name, dtype, hd=64):
    """The ptxas numbers of flash kernel `name` at `dtype` and head_dim
    `hd` (mangled: <name>_kernelI<f | 13__nv_bfloat16>Li<hd>E)."""
    t = "f" if dtype == "float32" else "13__nv_bfloat16"
    key = f"{name}_kernelI{t}Li{hd}E"
    return next((v for k, v in report.items() if key in k), None)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


PR_SET_CHILD_SUBREAPER = 36


def adopt_orphans():
    """Make this process the reaper of its orphaned descendants (Linux
    prctl PR_SET_CHILD_SUBREAPER): a process whose parent ends first, a
    DataLoader worker outliving the forkserver say, becomes this process's
    child, where stop_children() finds it."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        log(f"prctl(PR_SET_CHILD_SUBREAPER) failed, errno "
            f"{ctypes.get_errno()}: an orphan would escape stop_children")


def child_pids():
    """{pid: command line} of this process's children, zombies included
    (read from /proc)."""
    me, out = os.getpid(), {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as fh:
                ppid = int(fh.read().rsplit(")", 1)[1].split()[1])
            if ppid == me:
                with open(f"/proc/{d}/cmdline", "rb") as fh:
                    out[int(d)] = fh.read().replace(b"\0", b" ").decode(
                        errors="replace").strip()[:120]
        except (OSError, IndexError, ValueError):
            continue                     # it ended while we looked
    return out


def reap(pid, timeout_s):
    """Wait up to `timeout_s` for child `pid` to end; True once it has
    been reaped (or is no child of ours)."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            if os.waitpid(pid, os.WNOHANG)[0]:
                return True
        except ChildProcessError:
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)


def stop_children():
    """Stop every process this run started and wait for each to end, so
    that none outlives the script. In order: multiprocessing's children
    (DataLoader workers) and its exit work, then the forkserver, which
    ends when its "alive" pipe closes, then the resource tracker, which
    ends when the last holder of its pipe (this process, the forkserver,
    the workers) has closed it. Left alone, both end only after this process has, a
    fraction of a second later. Then any other child (an orphan adopted
    through adopt_orphans included) gets SIGTERM and, if it is still
    there after 5 s, SIGKILL. Returns {what: pid or command line} of what
    had to be stopped; fails if a child is left."""
    import multiprocessing as mp
    import signal
    from multiprocessing import forkserver, resource_tracker, util
    stopped = {}
    for p in mp.active_children():
        stopped.setdefault("workers", []).append(p.pid)
        p.terminate()
        p.join(5)
    # multiprocessing's own exit work, done now (once; the interpreter's
    # exit then skips it): queue threads joined, semaphores unlinked while
    # the resource tracker still runs to take their names off its list
    util._exit_function()
    for name, obj, pid_attr, fd_attr in (
            ("forkserver", forkserver._forkserver, "_forkserver_pid",
             "_forkserver_alive_fd"),
            ("resource_tracker", resource_tracker._resource_tracker, "_pid",
             "_fd")):
        pid, fd = getattr(obj, pid_attr, None), getattr(obj, fd_attr, None)
        if pid is None or fd is None:
            continue
        os.close(fd)
        setattr(obj, fd_attr, None)
        setattr(obj, pid_attr, None)
        stopped[name] = pid
        if not reap(pid, 10):
            os.kill(pid, signal.SIGKILL)
            reap(pid, 5)
    for sig in (signal.SIGTERM, signal.SIGTERM, signal.SIGKILL,
                signal.SIGKILL):
        live = {pid: cmd for pid, cmd in child_pids().items()
                if not reap(pid, 0)}
        if not live:
            break
        stopped.setdefault("swept", []).extend(live.values())
        for pid in live:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        for pid in live:
            reap(pid, 5)
    left = child_pids()
    if left:
        fail(f"processes left running: {left}")
    return stopped


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gpt2_small_arrays(cfg, seed=0):
    """Random GPT-2 small weights as the reference's startup program makes
    them: truncated normal (std 0.02, cut at 2 std) for every matrix, layer
    norm scale 1, zero biases."""
    rng = np.random.default_rng(seed)

    def tnormal(shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        bad = np.abs(x) > 2.0
        while bad.any():
            x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
            bad = np.abs(x) > 2.0
        return x * np.float32(0.02)

    h, f = cfg.hidden_size, cfg.intermediate_size
    arrays = {"wte": tnormal((cfg.vocab_size, h)),
              "wpe": tnormal((cfg.max_position, h)),
              "final_ln_scale": np.ones(h, np.float32),
              "final_ln_bias": np.zeros(h, np.float32)}
    for i in range(cfg.num_layers):
        arrays.update({
            f"dec{i}_ln1_scale": np.ones(h, np.float32),
            f"dec{i}_ln1_bias": np.zeros(h, np.float32),
            f"dec{i}_attn_qkv_w": tnormal((h, 3 * h)),
            f"dec{i}_attn_qkv_b": np.zeros(3 * h, np.float32),
            f"dec{i}_attn_proj_w": tnormal((h, h)),
            f"dec{i}_attn_proj_b": np.zeros(h, np.float32),
            f"dec{i}_ln2_scale": np.ones(h, np.float32),
            f"dec{i}_ln2_bias": np.zeros(h, np.float32),
            f"dec{i}_ffn_in_w": tnormal((h, f)),
            f"dec{i}_ffn_in_b": np.zeros(f, np.float32),
            f"dec{i}_ffn_out_w": tnormal((f, h)),
            f"dec{i}_ffn_out_b": np.zeros(h, np.float32)})
    return arrays


def cuda_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paged_ptxas(report, kind):
    """ptxas numbers of the paged decode kernels a pool `kind` runs: pass 1
    at each query type and head dim, and the merge of its output type."""
    prefixes = PAGED_MANGLED[kind]
    out = {}
    for k, v in report.items():
        m = re.search(r"(paged_decode_kernel\w*?I\w+?)EEv", k)
        if m and m.group(1).startswith(prefixes):
            out[m.group(1)] = v
    return out


def check_kernels(torch, kernel_mod, paged_ops, ptxas):
    """B4/B5 against their plain version at the serving main path's widths
    (batch 8, 12 heads, head_dim 64, block 16, max_len 1024, 12 pool
    layers): at the ragged positions that are timed and at the edges of a
    chunk and of the table (0, P-1, P, P+1, 2P-1, 2P, max_len-1 and a
    frozen row at max_len), a bounded walk bit-equal to the full walk and
    one slot alone bit-equal to the same slot in the batch. Timed with the
    layer cycling over all 12 layers from one launch to the next, so K/V
    come from device memory: the launch alone (the C entry on prepared
    arguments, a CUDA graph of the 12-layer cycle), through the wrapper,
    the plain version, and SDPA on a pre-gathered dense cache with the same
    mask (a reference point: not the same function)."""
    from paddle_tpu_torch.ops.kernels import flash_variants as fv
    B, nh, hd, bs, max_len, L = 8, 12, 64, 16, 1024, 12
    mb = max_len // bs
    lib = kernel_mod._library()
    P = lib.paged_decode_chunk()
    edge = torch.tensor([0, P - 1, P, P + 1, 2 * P - 1, 2 * P, max_len - 1,
                         max_len], dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for kind in ("f32", "bf16", "int8", "bf16_f32q"):
        q, kp, vp, pt, pos, kw = fv.paged_case(
            "bf16" if kind == "bf16_f32q" else kind, g)
        if kind == "bf16_f32q":
            # the int8-weight serving arm: f32 activations, bf16 pool
            q = q.float()
        checks, err = [], 0.0
        queries = (q, q.float()) if kind == "int8" else (q,)
        for label, ps in (("ragged", pos), ("edge", edge)):
            for qq in queries:
                args = (qq, kp, vp, pt, ps)
                got = kernel_mod.fused_paged_attention(*args, layer=5, **kw)
                want = kernel_mod.paged_attention_plain(*args, layer=5, **kw)
                hint = int((ps.long() // bs + 1).clamp(max=mb).max())
                bounded = kernel_mod.fused_paged_attention(
                    *args, layer=5, max_blocks=hint, **kw)
                alone = kernel_mod.fused_paged_attention(
                    qq[3:4].contiguous(), kp, vp, pt[3:4].contiguous(),
                    ps[3:4].contiguous(), layer=5, **kw)
                torch.cuda.synchronize()
                what = f"{kind} {label} q {str(qq.dtype)[6:]}"
                if not torch.isfinite(got.float()).all():
                    fail(f"{what}: kernel output is not finite")
                if not torch.equal(got, bounded):
                    fail(f"{what}: max_blocks={hint} changed the result")
                if not torch.equal(got[3:4], alone):
                    fail(f"{what}: slot 3 alone differs from slot 3 in the "
                         f"batch")
                e = (got.float() - want.float()).abs().max().item()
                checks.append(dict(arm=what, pos=ps.tolist(),
                                   max_abs_err=e))
                log(f"kernel {what}: max |kernel - plain| = {e:.3e} "
                    f"(tolerance {TOLERANCE[kind]:.1e}); max_blocks={hint} "
                    f"and slot 3 alone bit-equal")
                if e > TOLERANCE[kind]:
                    fail(f"{what}: kernel disagrees with its plain version: "
                         f"max abs err {e} > {TOLERANCE[kind]}")
                err = max(err, e)
        # the layer cycle: launch i reads layer i % 12
        cycle, keep = fv.paged_cycle(lib, q, kp, vp, pt, pos, **kw)
        alone_ms = fv.graph_ms(cycle)
        del keep
        layers = itertools.count()
        ms = cuda_ms(torch, lambda: kernel_mod.fused_paged_attention(
            q, kp, vp, pt, pos, layer=next(layers) % L, **kw))
        plain_ms = cuda_ms(torch, lambda: kernel_mod.paged_attention_plain(
            q, kp, vp, pt, pos, layer=next(layers) % L, **kw))
        # SDPA on a pre-gathered dense cache, in the query's dtype (int8
        # pools dequantized), every slot to max_len, positions past pos
        # masked
        dt = q.dtype
        c = kernel_mod.kv_dequant_scale(kw["kv_scale"]) if kind == "int8" \
            else 1.0
        dense = [tuple((paged_ops.paged_gather(pool, pt, layer).to(dt) * c)
                       for pool in (kp, vp)) for layer in range(L)]
        mask = torch.zeros((B, 1, 1, max_len), dtype=dt, device="cuda")
        mask.masked_fill_(torch.arange(max_len, device="cuda")[None, None,
                                                               None, :]
                          > pos.long()[:, None, None, None], float("-inf"))
        with torch.no_grad():
            dense_ms = cuda_ms(torch, lambda: sdpa(
                q, *dense[next(layers) % L], attn_mask=mask))
        del dense
        # least work of one launch: K and V of every live position of its
        # layer read once (each of the 12 layers' in turn), q read and the
        # context written once, the walked page-table entries and pos
        n_valid = (pos.long() + 1).clamp(max=max_len)
        live = int(n_valid.sum())
        kv_bytes = 2 * live * nh * hd * kp.element_size()
        out_elem = 4 if kind == "int8" else kp.element_size()
        io_bytes = (q.numel() * q.element_size() + B * nh * hd * out_elem
                    + 4 * int((pos.long() // bs + 1).sum()) + 4 * B)
        flops = live * nh * (4 * hd + 5)    # two dots + softmax
        t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        name = "paged_decode_bf16_f32q" if kind == "bf16_f32q" \
            else kernel_mod.KERNEL_NAMES[kp.dtype]
        n_chunks = -(-mb * bs // P)
        rows[name] = row = kernel_row(
            name, max_abs_err=err, ms=alone_ms, plain_ms=plain_ms,
            bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, wrapper_ms=ms,
            share_of_bytes_bound=t_bytes / alone_ms,
            gb_per_s=(kv_bytes + io_bytes) / alone_ms / 1e6,
            dense_sdpa_ms=dense_ms,
            dense_sdpa_note="SDPA on a pre-gathered dense [8, 12, 1024, 64] "
                            "cache with the same mask: not the same function"
                            " (no page-table walk; reads every slot to "
                            "max_len)",
            timing="ms: launch alone, a CUDA graph of one launch per pool "
                   "layer (12), replayed 20 times; wrapper_ms, plain_ms and"
                   " dense_sdpa_ms: CUDA events over 50 calls, the layer "
                   "cycling",
            chunk_positions=P, grid=[B * nh, n_chunks],
            live_chunk_blocks=nh * int(((n_valid + P - 1) // P).sum()),
            ptxas=paged_ptxas(ptxas, kind), checks=checks)
        log(f"kernel {kind}: {alone_ms:.5f} ms alone ({row['gb_per_s']:.1f} "
            f"GB/s, {row['share_of_bytes_bound']:.3f} of the bytes bound "
            f"{t_bytes:.5f} ms), through the wrapper {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, dense SDPA {dense_ms:.4f} ms (not the same "
            f"function); grid {row['grid']}, {row['live_chunk_blocks']} live"
            f" blocks of {P} positions; ptxas {row['ptxas']}")
        del q, kp, vp, pt, pos
        torch.cuda.empty_cache()
    return rows


def serve_on(torch, eng, requests, sequential=False):
    """Run `requests` through a built engine: (completions, wall seconds).
    Fails on a request that did not complete."""
    run = eng.generate_sequential if sequential else eng.generate
    t0 = time.perf_counter()
    comps = run(requests, timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [c for c in comps if not c.ok]
    if bad:
        fail(f"requests failed: {[(c.uid, c.state, c.error) for c in bad]}")
    return comps, wall


def serve(torch, serving, engine_kw, requests, sequential=False):
    eng = serving.DecodeEngine(**engine_kw)
    try:
        comps, wall = serve_on(torch, eng, requests, sequential)
        stats = eng.stats()
    finally:
        eng.stop()
    return comps, wall, stats


def serving_arm(torch, eng, make_requests, metrics, kernel_mod,
                warm=None, profile=True, stats=None):
    """One engine: a warm-up run (`warm()`'s requests, default the measured
    ones; it captures the engine's graphs), a timed run of
    `make_requests()` with the metrics and launch counts set to 0 just
    before it, then, if `profile`, one more run under torch.profiler.
    `stats()` (default eng.stats) is read around the timed run; its
    integer counts' growth there is the row's "delta". Returns (tokens per
    request, the numbers)."""
    stats = stats or eng.stats
    serve_on(torch, eng, (warm or make_requests)())
    before = stats()
    metrics.reset()
    kernel_mod.reset_launches()
    comps, wall = serve_on(torch, eng, make_requests())
    launches = dict(kernel_mod.launches)
    snap = metrics.snapshot()
    st = stats()
    n_tok = sum(len(c.tokens) for c in comps)
    if any(not 0 <= t < eng.model_config.vocab_size
           for c in comps for t in c.tokens):
        fail("token ids outside the vocabulary")
    row = {"generated_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "ttft_ms_p50": snap["serving.ttft_ms"]["p50"],
           "ttft_ms_p99": snap["serving.ttft_ms"]["p99"],
           "tpot_ms_p50": snap.get("serving.tpot_ms", {}).get("p50"),
           "window_ms_p50": snap["serving.window_ms"]["p50"],
           "graphs": st["graphs"], "eager_calls": st["eager_calls"],
           "b4_launches": launches,
           "delta": {k: v - before[k] for k, v in st.items()
                     if type(v) is int}}
    if profile:
        row["profile"] = device_profile(
            torch, lambda: serve_on(torch, eng, make_requests())[1],
            kernels=("paged_decode_kernel", "paged_decode_kernel_merge"))
    log(f"serving arm: {n_tok} tokens in {wall:.3f} s = "
        f"{row['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{row['ttft_ms_p50']:.2f} ms, {row['delta']['graph_replays']} "
        f"replays of "
        f"{row['graphs']} graphs, {row['eager_calls']} eager calls, "
        f"B4 {launches}; profile {row.get('profile')}")
    return [c.tokens for c in comps], row


def captured_only(st, what):
    """Fail unless the engine whose stats are `st` served through graph
    replays alone."""
    if st["eager_calls"] or not st["graph_replays"]:
        fail(f"{what}: {st['eager_calls']} eager calls, "
             f"{st['graph_replays']} graph replays (a CUDA engine must "
             f"replay its captured window only)")


def device_profile(torch, run, top=8, ranges=(), kernels=()):
    """One more run of `run()` (which returns its wall seconds) under
    torch.profiler: the share of the wall time the card spent in kernels,
    the number of device launches, the `top` kernels that took most of the
    time, the device time of the kernels launched inside each profiler
    range of `ranges` (see `annotated`) and the span from the first to the
    last of them on the device timeline, and the device time of the
    kernels whose names contain each of `kernels`. The profiler's own cost lengthens the wall
    time, so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    return profile_summary(prof, wall, top, ranges, kernels)


def profile_summary(prof, wall, top=8, ranges=(), kernels=()):
    """`device_profile`'s numbers from a finished torch.profiler run
    `prof` that lasted `wall` seconds."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    # a profiler range also leaves a span on the device timeline: not a
    # kernel, kept apart
    spans = {e.key: e.self_device_time_total for e in events
             if e.device_type == DeviceType.CUDA and e.key in ranges}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.key not in ranges]
    busy_us = sum(e.self_device_time_total for e in device)
    if not busy_us:
        return {"device_time": "not measured (no device events)"}
    by_name = {}            # kernel names cut to 80 characters may collide
    full = {}
    for e in device:
        name = e.key[:80]
        by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total
        full[e.key] = full.get(e.key, 0.0) + e.self_device_time_total
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    out = {"wall_s": wall, "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / wall,
           "device_launches": int(sum(e.count for e in device)),
           "top_kernels_ms": {name: us / 1e3 for name, us in ranked[:top]}}
    for r in ranges:
        ev = next((e for e in events if e.key == r), None)
        us = getattr(ev, "device_time_total", 0.0) if ev else 0.0
        out[f"{r}_device_ms"] = us / 1e3 if us else \
            "not measured (no device time under the range)"
        out[f"{r}_device_span_ms"] = spans.get(r, 0.0) / 1e3
    for k in kernels:
        out[f"{k}_device_ms"] = sum(us for name, us in full.items()
                                    if k in name) / 1e3
    return out


def flash_agreement(torch, pairs, rtol):
    """(max |got - want|, the least atol for which |got - want| <= atol +
    rtol * |want| holds everywhere, the 99th percentile of |got - want|,
    median |want|) over (got, want) pairs."""
    diff = torch.cat([(g.float() - w.float()).abs().flatten()
                      for g, w in pairs])
    ref = torch.cat([w.float().abs().flatten() for _, w in pairs])
    if diff.numel() <= 1 << 24:
        p99 = diff.quantile(0.99).item()
    else:                   # past quantile()'s limit: the nearest rank
        p99 = diff.kthvalue(max(1, round(0.99 * diff.numel()))).values \
            .item()
    return (diff.max().item(), (diff - rtol * ref).max().item(), p99,
            ref.median().item())


def padding_mask(torch, batch, seq, seed):
    """The additive key-padding mask the BERT program builds from a feed
    whose lengths are uniform in [S/2, S] (bench.py:390-394): [B,1,1,S],
    0 on tokens and -1e9 on padding."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(seq // 2, seq + 1, size=(batch, 1))
    keep = (np.arange(seq)[None, :] < lens).astype(np.float32)
    return torch.from_numpy(keep * np.float32(1e9) - np.float32(1e9)) \
        .view(batch, 1, 1, seq).cuda()


def flash_bounds(B, nh, S, hd, elem, mask_bytes, rate):
    """Least time of each flash kernel on this card: every operand read
    once and every output written once, against the operations of its
    products (QK^T, PV; + dO V^T, dS K; + P^T dO, dS^T Q) at `rate`."""
    t = B * nh * S * hd * elem              # one [B, nh, S, hd] tensor
    lse = 4 * B * nh * S
    work = B * nh * S * S * hd
    out = {}
    for name, n_ops, n_bytes in (
            ("flash_fwd", 4 * work, 4 * t + lse + mask_bytes),
            ("flash_bwd_dq", 6 * work, 6 * t + lse + mask_bytes),
            ("flash_bwd_dkdv", 8 * work, 7 * t + lse + mask_bytes)):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / rate * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def flash_sass(sass, name):
    """{dtype_hd: HMMA count} of flash kernel `name` from
    `sass_mma_counts`, or "not measured" without cuobjdump."""
    if sass is None:
        return "not measured (no cuobjdump)"
    out = {}
    for d, t in (("float32", "f"), ("bfloat16", "13__nv_bfloat16")):
        for hd in (64, 128):
            key = f"{name}_kernelI{t}Li{hd}E"
            out[f"{d}_hd{hd}"] = next(
                (c for k, c in sass.items() if key in k), None)
    return out


def check_flash_kernels(torch, fa, ptxas, sass=None):
    """B1-B3 against their plain version at the training main path's shapes
    in four arms, and off it with head_dim 128 at a ragged S and at S 512;
    B1's lse against logsumexp of the plain scores and B2's delta buffer
    against its plain version; timed on the training path's arm (f32,
    key-padding mask, dropout 0.1) and at dropout 0, beside SDPA's forward
    and backward (f32 and bf16). Fails if an instance of B1 has no
    tensor-core instruction in its SASS."""
    fwd_hmma = flash_sass(sass, "flash_fwd")
    if sass is not None and not all(fwd_hmma.values()):
        fail(f"flash_fwd: an instance has no HMMA in its SASS: {fwd_hmma}")
    B, nh, S, hd = 16, 12, 512, 64
    scale, seed = 1.0 / np.sqrt(hd), 1234
    mask = padding_mask(torch, B, S, seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    base = [torch.randn((B, nh, S, hd), generator=g, device="cuda")
            for _ in range(4)]
    # S 200 leaves a tail tile of 8 rows; a per-(batch, head) mask with a
    # row per query, under causal and dropout
    ragged = [torch.randn((2, 3, 200, 128), generator=g, device="cuda")
              for _ in range(4)]
    ragged_mask = torch.where(
        torch.rand((2, 3, 200, 200), generator=g, device="cuda") < 0.2,
        -1e9, 0.0)
    # head_dim 128 with full tiles: the 8-warp backward at S 512
    wide = [torch.randn((4, nh, S, 128), generator=g, device="cuda")
            for _ in range(4)]
    arms = [(base, "float32", mask, False, 0.1),
            (base, "bfloat16", mask, False, 0.1),
            (base, "bfloat16", None, True, 0.1),
            (base, "float32", None, False, 0.0),
            (ragged, "float32", ragged_mask, True, 0.1),
            (wide, "float32", padding_mask(torch, 4, S, seed=1), False, 0.1)]
    errs = {n: 0.0 for n in fa.KERNEL_NAMES}
    checks = {n: [] for n in fa.KERNEL_NAMES}
    for tensors, dtype, m, causal, rate in arms:
        dt = getattr(torch, dtype)
        q, k, v, do = (t.to(dt) for t in tensors)
        kw = dict(scale=1.0 / np.sqrt(q.shape[-1]), causal=causal,
                  dropout=rate, seed=seed if rate else None, mask=m)

        def run(fn):
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            o = fn(qq, kk, vv, **kw)
            return (o.detach(),) + torch.autograd.grad(o, (qq, kk, vv), do)

        got, want = run(fa.flash_attention), run(fa.flash_attention_plain)
        torch.cuda.synchronize()
        what = (f"{dtype} {list(q.shape)} mask={m is not None} "
                f"causal={causal} dropout={rate}")
        if not all(torch.isfinite(t.float()).all() for t in got):
            fail(f"flash {what}: non-finite kernel output")
        pairs = {"flash_fwd": [(got[0], want[0])],
                 "flash_bwd_dq": [(got[1], want[1])],
                 "flash_bwd_dkdv": [(got[2], want[2]), (got[3], want[3])]}
        for name, ps in pairs.items():
            atol, rtol = FLASH_TOLERANCE[dtype][
                "o" if name == "flash_fwd" else "grad"]
            err, need, p99, typical = flash_agreement(torch, ps, rtol)
            checks[name].append(dict(
                arm=what, max_abs_err=err, p99_abs_err=p99, atol_needed=need,
                atol=atol, rtol=rtol, median_abs_plain=typical))
            log(f"flash {name} {what}: |kernel - plain| max {err:.3e}, p99 "
                f"{p99:.3e}; needs atol {need:.3e} beside rtol {rtol:.3g} "
                f"(atol {atol:.1e}); median |plain| {typical:.3e}")
            if need > atol:
                fail(f"{name} {what}: kernel disagrees with its plain "
                     f"version: |kernel - plain| exceeds {atol} + {rtol} * "
                     f"|plain| by up to {need - atol}")
            if tensors is base and dtype == "float32" and m is not None:
                errs[name] = err         # the training path's arm
        del got, want, q, k, v, do, pairs, ps
    del ragged, ragged_mask, wide, arms
    torch.cuda.empty_cache()

    rows, extra = {}, {}
    # logsumexp of the plain f32 scores, the lse B1 must hand to B2/B3
    with torch.no_grad():
        plain_lse = torch.logsumexp(
            torch.matmul(base[0], base[1].transpose(-1, -2)) * scale + mask,
            -1).reshape(B * nh, S)
    lse_err = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, k, v, do = (t.to(dt) for t in base)
        m3, mode = fa.normalize_mask(mask, B, nh, S)
        m3 = m3.contiguous()
        times = {}
        for rate in (0.1, 0.0):
            args = (q, k, v, m3, mode, seed, scale, False, rate)
            o, lse = fa.launch_fwd(*args)
            if dtype == "float32":
                lse_err[str(rate)] = (lse - plain_lse).abs().max().item()
                log(f"flash lse f32 dropout {rate}: max |B1 - logsumexp of "
                    f"the plain scores| {lse_err[str(rate)]:.3e} (tolerance "
                    f"1e-5)")
                if not lse_err[str(rate)] <= 1e-5:
                    fail(f"flash_fwd: lse disagrees with logsumexp of the "
                         f"plain scores by {lse_err[str(rate)]}")
            qargs = (q, k, v, o, lse, do, m3, mode, seed, scale, False, rate)
            _, delta = fa.launch_bwd_dq(*qargs)
            # B2's delta buffer: f32 sums of hd products in another order
            derr = (delta - fa.bwd_delta_plain(o, do)).abs().max().item()
            log(f"flash delta {dtype} dropout {rate}: max |B2 - plain| "
                f"{derr:.3e} (tolerance 1e-5)")
            if not derr <= 1e-5:
                fail(f"flash_bwd_dq {dtype}: delta disagrees with its plain "
                     f"version by {derr}")
            kargs = (q, k, v, delta, lse, do, m3, mode, seed, scale, False,
                     rate)
            times[rate] = {
                "flash_fwd": cuda_ms(torch, lambda: fa.launch_fwd(*args)),
                "flash_bwd_dq": cuda_ms(
                    torch, lambda: fa.launch_bwd_dq(*qargs)),
                "flash_bwd_dkdv": cuda_ms(
                    torch, lambda: fa.launch_bwd_dkdv(*kargs))}
            times[rate]["b2_plus_b3"] = (times[rate]["flash_bwd_dq"]
                                         + times[rate]["flash_bwd_dkdv"])
        extra[dtype] = times
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lm = mask.to(dt)
        with torch.no_grad():
            lib_fwd = cuda_ms(torch, lambda: sdpa(q, k, v, attn_mask=lm,
                                                  scale=scale))
        extra[dtype]["sdpa_fwd"] = lib_fwd
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        os_ = sdpa(qq, kk, vv, attn_mask=lm, scale=scale)
        lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
            os_, (qq, kk, vv), do, retain_graph=True))
        extra[dtype]["sdpa_bwd"] = lib_bwd
        del os_
        if dtype != "float32":
            continue
        kw = dict(scale=scale, dropout=0.1, seed=seed, mask=mask)
        with torch.no_grad():
            plain_fwd = cuda_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, **kw), iters=10, warmup=2)
        op = fa.flash_attention_plain(qq, kk, vv, **kw)
        plain_dq = cuda_ms(torch, lambda: torch.autograd.grad(
            op, qq, do, retain_graph=True), iters=10, warmup=2)
        plain_dkdv = cuda_ms(torch, lambda: torch.autograd.grad(
            op, (kk, vv), do, retain_graph=True), iters=10, warmup=2)
        del op
        bounds = flash_bounds(B, nh, S, hd, 4, 4 * B * S, F32_FLOPS_PER_S)
        tc_bounds = flash_bounds(B, nh, S, hd, 4, 4 * B * S,
                                 TF32_FLOPS_PER_S / 3)
        plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_dq,
                 "flash_bwd_dkdv": plain_dkdv}
        for name in fa.KERNEL_NAMES:
            # bound_ms at the rate of the unit the kernels multiply on: the
            # tensor cores in 3xTF32; the f32 CUDA-core bound beside it
            bound = tc_bounds[name]
            rows[name] = kernel_row(
                name, max_abs_err=errs[name], ms=times[0.1][name],
                plain_ms=plain[name], bound_ms=bound[0], bound_by=bound[1],
                library_ms=lib_fwd if name == "flash_fwd" else lib_bwd,
                bound_f32_cuda_core_ms=bounds[name][0],
                bound_3xtf32_ms=tc_bounds[name][0],
                dtype="float32", ms_dropout0=times[0.0][name],
                ptxas={f"{d}_hd{h}": flash_ptxas(ptxas, name, d, h)
                       for d in ("float32", "bfloat16") for h in (64, 128)},
                sass_hmma=flash_sass(sass, name),
                checks=checks[name])
        rows["flash_fwd"].update(
            lse_max_abs_err=lse_err,
            fwd_over_sdpa_fwd={str(r): times[r]["flash_fwd"] / lib_fwd
                               for r in (0.1, 0.0)})
        for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
            rows[name].update(
                library_covers="B2+B3 (SDPA backward)",
                b2_plus_b3_ms={str(r): times[r]["b2_plus_b3"]
                               for r in (0.1, 0.0)},
                b2_plus_b3_over_sdpa_bwd={
                    str(r): times[r]["b2_plus_b3"] / lib_bwd
                    for r in (0.1, 0.0)})
        del qq, kk, vv
        torch.cuda.empty_cache()
    bf_bounds = flash_bounds(B, nh, S, hd, 2, 4 * B * S, BF16_FLOPS_PER_S)
    for name in fa.KERNEL_NAMES:
        row = rows[name]
        row["bf16_ms"] = extra["bfloat16"][0.1][name]
        row["bf16_ms_dropout0"] = extra["bfloat16"][0.0][name]
        row["bf16_bound_ms"] = bf_bounds[name][0]
        if name == "flash_fwd":
            sd = extra["bfloat16"]["sdpa_fwd"]
            row["bf16_sdpa_fwd_ms"] = sd
            row["bf16_fwd_over_sdpa_fwd"] = {
                str(r): extra["bfloat16"][r][name] / sd for r in (0.1, 0.0)}
        else:
            row["bf16_b2_plus_b3_ms"] = extra["bfloat16"][0.1]["b2_plus_b3"]
            row["bf16_sdpa_bwd_ms"] = extra["bfloat16"]["sdpa_bwd"]
        log(f"kernel {name}: f32 {row['ms']:.4f} ms (dropout 0: "
            f"{row['ms_dropout0']:.4f}), bf16 {row['bf16_ms']:.4f} ms; plain "
            f"{row['plain_ms']:.4f} ms; bound at the f32 CUDA-core rate "
            f"{row['bound_f32_cuda_core_ms']:.4f} ms, at the 3xTF32 "
            f"tensor-core rate {row['bound_3xtf32_ms']:.4f} ms; SDPA "
            f"{row['library_ms']}; ptxas {row['ptxas']}; SASS HMMA "
            f"{row['sass_hmma']}")
    for r in ("0.1", "0.0"):
        log(f"flash B2+B3 f32 dropout {r}: "
            f"{rows['flash_bwd_dq']['b2_plus_b3_ms'][r]:.4f} ms, "
            f"{rows['flash_bwd_dq']['b2_plus_b3_over_sdpa_bwd'][r]:.3f}x "
            f"SDPA's backward ({rows['flash_bwd_dq']['library_ms']:.4f} ms)")
    fwd = rows["flash_fwd"]
    log(f"flash B1 f32: {fwd['ms']:.4f} ms at dropout 0.1, "
        f"{fwd['ms_dropout0']:.4f} at 0; SDPA forward {fwd['library_ms']:.4f}"
        f" ms: {fwd['fwd_over_sdpa_fwd']['0.1']:.3f}x / "
        f"{fwd['fwd_over_sdpa_fwd']['0.0']:.3f}x; bf16 {fwd['bf16_ms']:.4f} / "
        f"{fwd['bf16_ms_dropout0']:.4f} ms, SDPA bf16 forward "
        f"{fwd['bf16_sdpa_fwd_ms']:.4f} ms")
    log(f"flash B2+B3 bf16 dropout 0.1: "
        f"{rows['flash_bwd_dq']['bf16_b2_plus_b3_ms']:.4f} ms; SDPA bf16 "
        f"backward {rows['flash_bwd_dq']['bf16_sdpa_bwd_ms']:.4f} ms")
    return rows


def check_flash_gpt(torch, fa):
    """B1-B3 at the GPT training path's shape (GPT-2 small at S 512, batch
    32: [32, 12, 512, 64], causal, no mask, dropout 0.1), in float32, the
    dtype fleet AMP hands the attention lowering there (the bf16 `mul` of
    the qkv projection plus its f32 bias is f32), with the dropout seed a
    device tensor as the executor passes it: held against the plain
    version (FLASH_TOLERANCE), timed beside it, beside SDPA's causal
    forward and backward, and beside the bound of the causal half of the
    products at the 3xTF32 rate. Returns {kernel: numbers}."""
    B, nh, S, hd = GPT_BATCH, 12, GPT_SEQ, 64
    scale = 1.0 / np.sqrt(hd)
    seed = fa.seed_tensor(4321, torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn((B, nh, S, hd), generator=g, device="cuda")
                   for _ in range(4))
    kw = dict(scale=scale, causal=True, dropout=0.1, seed=seed)

    def run(fn):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fn(qq, kk, vv, **kw)
        return (o.detach(),) + torch.autograd.grad(o, (qq, kk, vv), do)

    got, want = run(fa.flash_attention), run(fa.flash_attention_plain)
    torch.cuda.synchronize()
    pairs = {"flash_fwd": [(got[0], want[0])],
             "flash_bwd_dq": [(got[1], want[1])],
             "flash_bwd_dkdv": [(got[2], want[2]), (got[3], want[3])]}
    out = {}
    for name, ps in pairs.items():
        atol, rtol = FLASH_TOLERANCE["float32"][
            "o" if name == "flash_fwd" else "grad"]
        err, need, p99, _ = flash_agreement(torch, ps, rtol)
        log(f"flash {name} GPT shape [{B}, {nh}, {S}, {hd}] f32 causal "
            f"dropout 0.1, seed from device memory: |kernel - plain| max "
            f"{err:.3e}, p99 {p99:.3e} (atol {atol:.1e})")
        if need > atol:
            fail(f"{name} at the GPT shape disagrees with its plain version "
                 f"by up to {need - atol} past {atol}")
        out[name] = {"shape": [B, nh, S, hd], "dtype": "float32",
                     "causal": True, "dropout": 0.1,
                     "seed": "int32 tensor in device memory",
                     "max_abs_err": err, "p99_abs_err": p99,
                     "atol": atol, "rtol": rtol}
    del got, want, pairs, ps
    o, lse = fa.launch_fwd(q, k, v, None, None, seed, scale, True, 0.1)
    qa = (q, k, v, o, lse, do, None, None, seed, scale, True, 0.1)
    delta = fa.launch_bwd_dq(*qa)[1]
    ka = (q, k, v, delta, lse, do, None, None, seed, scale, True, 0.1)
    ms = {"flash_fwd": cuda_ms(torch, lambda: fa.launch_fwd(
              q, k, v, None, None, seed, scale, True, 0.1)),
          "flash_bwd_dq": cuda_ms(torch, lambda: fa.launch_bwd_dq(*qa)),
          "flash_bwd_dkdv": cuda_ms(torch, lambda: fa.launch_bwd_dkdv(*ka))}
    with torch.no_grad():
        plain_fwd = cuda_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, **kw), iters=5, warmup=1)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    op = fa.flash_attention_plain(qq, kk, vv, **kw)
    plain = {"flash_fwd": plain_fwd,
             "flash_bwd_dq": cuda_ms(torch, lambda: torch.autograd.grad(
                 op, qq, do, retain_graph=True), iters=5, warmup=1),
             "flash_bwd_dkdv": cuda_ms(torch, lambda: torch.autograd.grad(
                 op, (kk, vv), do, retain_graph=True), iters=5, warmup=1)}
    del op
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = {}
    for rate in (0.1, 0.0):
        with torch.no_grad():
            lib[f"fwd_{rate}"] = cuda_ms(torch, lambda: sdpa(
                q, k, v, is_causal=True, dropout_p=rate, scale=scale))
        os_ = sdpa(qq, kk, vv, is_causal=True, dropout_p=rate, scale=scale)
        lib[f"bwd_{rate}"] = cuda_ms(torch, lambda: torch.autograd.grad(
            os_, (qq, kk, vv), do, retain_graph=True))
        del os_
    # flash_bounds' bytes and products, the products cut to the causal
    # half: (S + 1) / (2 S) of the dense work
    half = (S + 1) / (2 * S)
    t, lse, work = B * nh * S * hd * 4, 4 * B * nh * S, B * nh * S * S * hd
    for name, n_bytes, n_ops in (
            ("flash_fwd", 4 * t + lse, 4 * work),
            ("flash_bwd_dq", 6 * t + lse, 6 * work),
            ("flash_bwd_dkdv", 7 * t + lse, 8 * work)):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops * half / (TF32_FLOPS_PER_S / 3) * 1e3
        bound = max(t_bytes, t_ops)
        out[name].update(
            ms=ms[name], plain_ms=plain[name], bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bound_rate="3xTF32 (494.7 / 3 TFLOP/s), causal half counted",
            library_ms=lib["fwd_0.1"] if name == "flash_fwd"
            else lib["bwd_0.1"],
            library_call="SDPA is_causal=True dropout_p=0.1 "
                         + ("forward" if name == "flash_fwd"
                            else "backward (covers B2+B3)"),
            library_ms_dropout0=lib["fwd_0.0"] if name == "flash_fwd"
            else lib["bwd_0.0"])
        log(f"kernel {name} GPT shape: {ms[name]:.4f} ms, plain "
            f"{plain[name]:.4f} ms, bound {bound:.4f} ms "
            f"({out[name]['bound_by']}), SDPA causal "
            f"{out[name]['library_ms']:.4f} ms")
    out["flash_bwd_dq"]["b2_plus_b3_ms"] = ms["flash_bwd_dq"] \
        + ms["flash_bwd_dkdv"]
    del qq, kk, vv, q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return out


# the checked arms of B6-B8: (kernel, op type, label, attrs); the first arm
# of each kernel gives its row of the kernels line
ZERO_ARMS = (
    ("zero_sgd", "sgd", "sgd", {}),
    ("zero_momentum", "momentum", "momentum_nesterov_l2",
     {"mu": 0.9, "use_nesterov": True, "regularization_method": "l2_decay",
      "regularization_coeff": 1e-4}),
    ("zero_momentum", "momentum", "momentum", {"mu": 0.9,
                                               "use_nesterov": False}),
    ("zero_adam", "adam", "adam", {"beta1": 0.9, "beta2": 0.999,
                                   "epsilon": 1e-8}),
    ("zero_adam", "adamw", "adamw", {"beta1": 0.9, "beta2": 0.999,
                                     "epsilon": 1e-8, "coeff": 0.01,
                                     "with_decay": True}),
)


def max_ulp_distance(torch, a, b):
    """Largest distance between two f32 tensors in units in the last
    place (the bit patterns mapped to ordered integers)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def zero_library_call(torch, op_type, label, ins):
    """The nearest single PyTorch call on the same flat tensors (in place):
    torch's fused SGD / Adam / AdamW. Not the same function for adam: torch
    adds eps after the bias correction of m2; the bytes moved are the
    same. None where the installed torch has no such call."""
    p, g = ins["Param"], ins["Grad"]
    if op_type in ("adam", "adamw"):
        fn = getattr(torch, f"_fused_{op_type}_", None)
        if fn is None:
            return None
        step = [torch.tensor(3.0, device="cuda")]
        return lambda: fn(p, g, ins["Moment1"], ins["Moment2"], [], step,
                          lr=1e-3, beta1=0.9, beta2=0.999,
                          weight_decay=0.01 if op_type == "adamw" else 0.0,
                          eps=1e-8, amsgrad=False, maximize=False)
    fn = getattr(torch, "_fused_sgd_", None)
    if fn is None:
        return None
    nesterov = label == "momentum_nesterov_l2"
    return lambda: fn(p, g, ins.get("Velocity", []),
                      weight_decay=1e-4 if nesterov else 0.0,
                      momentum=0.9 if op_type == "momentum" else 0.0,
                      lr=1e-3, dampening=0.0, nesterov=nesterov,
                      maximize=False, is_first_step=False)


def launch_alone(torch, zk, ins, attrs, op_type):
    """A call of an update kernel's C entry point alone (B6 `zero_sgd`, B7
    `zero_momentum`, B8 `zero_adam`) on `ins`' tensors, its arguments
    prepared beforehand (what `zero_update.launch` passes), and not
    counted: the kernel's time without the wrapper's."""
    lib = zk._library()
    ptr = {s: v[0].data_ptr() for s, v in ins.items()}
    n = ins["Param"][0].numel()
    stream = torch.cuda.current_stream().cuda_stream
    if op_type == "sgd":
        args = (ptr["LearningRate"], ptr["Param"], ptr["Grad"], n, stream)
        return lambda: lib.zero_sgd(*args)
    if op_type == "momentum":
        rd = attrs.get("regularization_coeff", 0.0)
        use_l2 = attrs.get("regularization_method", "") == "l2_decay" \
            and bool(rd)
        args = (ptr["LearningRate"], ptr["Param"], ptr["Grad"],
                ptr["Velocity"], n, attrs.get("mu", 0.9),
                rd if use_l2 else 0.0, int(use_l2),
                int(bool(attrs.get("use_nesterov", False))), stream)
        return lambda: lib.zero_momentum(*args)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    decay = op_type == "adamw"
    args = (ptr["LearningRate"], ptr["Beta1Pow"], ptr["Beta2Pow"],
            ptr["Param"], ptr["Grad"], ptr["Moment1"], ptr["Moment2"],
            n, b1, 1 - b1, b2, 1 - b2, attrs.get("epsilon", 1e-8),
            attrs.get("coeff", 0.01) if decay else 0.0, int(decay), stream)
    return lambda: lib.zero_adam(*args)


# the L2 cache of an H100 (50 MB): a bucket whose bytes fit in it is timed
# over enough copies, used in turn, that the copies do not
L2_BYTES = 50e6


def b6_b7_alone(torch, zk, kernel, op_type, label, attrs, n, gen):
    """B6 / B7 on the launch alone (`launch_alone`) beside
    torch._fused_sgd_ on the same tensors, each over `copies` sets of
    buffers used in turn, as many as put twice the L2's bytes between two
    uses of one set (one set where a set alone exceeds it). Returns
    (alone_ms, library_ms, copies)."""
    per_set = n * ZERO_BYTES_PER_ELEMENT[kernel]
    copies = max(1, int(-(-2 * L2_BYTES // per_set)))
    sets = []
    for _ in range(copies):
        ins = {s: [torch.randn(n, generator=gen, device="cuda")]
               for s in ("Param", "Grad") + zk._STATE_SLOTS[op_type]}
        ins["LearningRate"] = [torch.tensor([1e-3], device="cuda")]
        sets.append(ins)

    def in_turn(calls):
        it = itertools.cycle(calls)
        return lambda: next(it)()

    alone = cuda_ms(torch, in_turn([launch_alone(torch, zk, ins, attrs,
                                                 op_type) for ins in sets]))
    lib_calls = [zero_library_call(torch, op_type, label, ins)
                 for ins in sets]
    library = None if lib_calls[0] is None \
        else cuda_ms(torch, in_turn(lib_calls))
    del sets, lib_calls
    torch.cuda.empty_cache()
    return alone, library, copies


# B8 on buckets that do not start on 16 bytes (slot offsets in elements of
# Param, Grad, Moment1, Moment2): one shared offset takes the scalar head and
# the vector body; offsets that differ take the scalar loop
ZERO_OFFSET_ARMS = (("adam_offset1", (1, 1, 1, 1)),
                    ("adam_mismatched_offsets", (1, 0, 2, 3)))


def check_zero_kernels(torch, zk, ptxas):
    """B6-B8 against their plain version on the card, bit for bit on every
    output, at the stage-1 path's bucket sizes and a tail, and B8 on two
    buckets that do not start on 16 bytes; inputs N(0, 1), m2 = |N(0, 1)|.
    Timed (CUDA events, 5 warm-up, 50 launches) beside the plain version,
    the bytes bound and torch's fused optimizer call; B8 also alone, without
    its wrapper."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    scalars = {"LearningRate": [1e-3], "Beta1Pow": [0.9 ** 3],
               "Beta2Pow": [0.999 ** 3]}
    arms = [(kernel, op_type, label, attrs, n, None)
            for kernel, op_type, label, attrs in ZERO_ARMS
            for n in ZERO_SIZES]
    arms += [("zero_adam", "adam", label, ZERO_ARMS[3][3], ZERO_SIZES[0],
              offs) for label, offs in ZERO_OFFSET_ARMS]
    for kernel, op_type, label, attrs, n, offs in arms:
        state = zk._STATE_SLOTS[op_type]
        base = {s: torch.randn(n, generator=gen, device="cuda")
                for s in ("Param", "Grad") + state}
        if "Moment2" in base:
            base["Moment2"].abs_()

        def copy():
            ins = {}
            for i, (s, t) in enumerate(base.items()):
                o = offs[i] if offs else 0
                ins[s] = [torch.empty(n + o, device="cuda")[o:]]
                ins[s][0].copy_(t)
            for s, v in scalars.items():
                ins[s] = [torch.tensor(v, device="cuda")]
            return ins

        kin, pin = copy(), copy()
        del base
        got = zk.fused_flat_update(op_type, kin, attrs)
        want = zk.fused_flat_update_plain(op_type, pin, attrs)
        torch.cuda.synchronize()
        check = {"arm": label, "n": n, "bitwise": True, "max_ulp": 0,
                 "max_abs_err": 0.0}
        for slot, (g,) in got.items():
            w = want[slot][0]
            if not torch.isfinite(g).all():
                fail(f"{label} n={n}: non-finite kernel {slot}")
            if not torch.equal(g, w):
                check["bitwise"] = False
                check["max_ulp"] = max(check["max_ulp"],
                                       max_ulp_distance(torch, g, w))
                check["max_abs_err"] = max(
                    check["max_abs_err"], (g - w).abs().max().item())
        log(f"kernel {kernel} {label} n={n}: kernel == plain bit for "
            f"bit: {check['bitwise']} (max {check['max_ulp']} ulp, "
            f"max abs {check['max_abs_err']:.3e})")
        if not check["bitwise"]:
            fail(f"{kernel} {label} n={n}: kernel differs from its plain "
                 f"version by up to {check['max_ulp']} ulp")
        del want, pin
        times = {
            "ms": cuda_ms(torch, lambda: zk.fused_flat_update(
                op_type, kin, attrs)),
            "plain_ms": cuda_ms(torch, lambda: zk.fused_flat_update_plain(
                op_type, kin, attrs)),
            "bound_ms": n * ZERO_BYTES_PER_ELEMENT[kernel]
            / HBM_BYTES_PER_S * 1e3}
        if kernel == "zero_adam":
            # the row's time is the launch alone; the wrapper's beside it
            times["wrapper_ms"] = times["ms"]
            times["ms"] = cuda_ms(torch, launch_alone(
                torch, zk, kin, attrs, op_type))
            times["gb_per_s"] = n * ZERO_BYTES_PER_ELEMENT[kernel] \
                / times["ms"] / 1e6
            times["share_of_bytes_bound"] = times["bound_ms"] / times["ms"]
        lib = None if offs else zero_library_call(
            torch, op_type, label, {s: v for s, v in kin.items()})
        times["library_ms"] = None if lib is None \
            else cuda_ms(torch, lib)
        if kernel != "zero_adam" and n in B6_B7_ALONE_SIZES \
                and label in ("sgd", "momentum_nesterov_l2"):
            (times["alone_ms"], times["alone_library_ms"],
             times["alone_copies"]) = b6_b7_alone(
                 torch, zk, kernel, op_type, label, attrs, n, gen)
            log(f"kernel {kernel} {label} n={n}: launch alone "
                f"{times['alone_ms']:.4f} ms, torch fused "
                f"{times['alone_library_ms']} ms (same tensors, "
                f"{times['alone_copies']} sets in turn)")
        log(f"kernel {kernel} {label} n={n}: {times['ms']:.4f} ms"
            + (f" alone ({times['gb_per_s']:.1f} GB/s, "
               f"{times['share_of_bytes_bound']:.3f} of the bytes bound;"
               f" through the wrapper {times['wrapper_ms']:.4f} ms)"
               if kernel == "zero_adam" else "")
            + f", plain {times['plain_ms']:.4f} ms, bytes bound "
            f"{times['bound_ms']:.4f} ms, torch fused "
            f"{times['library_ms']}")
        results.setdefault(kernel, {}).setdefault(label, {})[n] = \
            dict(check, **times)
        del kin, got
        torch.cuda.empty_cache()
    rows = {}
    main_n = ZERO_SIZES[0]
    for kernel, arms in results.items():
        label = next(iter(arms))          # the kernel's first arm
        at = arms[label][main_n]
        extra = {}
        if kernel == "zero_adam":
            per_sm = zk._library().zero_adam_blocks_per_sm()
            if per_sm <= 0:
                fail(f"zero_adam: occupancy query failed ({per_sm})")
            extra = dict(wrapper_ms=at["wrapper_ms"],
                         gb_per_s=at["gb_per_s"],
                         share_of_bytes_bound=at["share_of_bytes_bound"],
                         resident_blocks_per_sm=per_sm,
                         grid_blocks=per_sm * torch.cuda.get_device_properties(
                             0).multi_processor_count)
            log(f"kernel zero_adam: {per_sm} resident blocks of 256 threads "
                f"per SM, grid {extra['grid_blocks']} blocks")
        if kernel != "zero_adam":
            extra = {k: {str(n): c[k] for n, c in arms[label].items()
                         if k in c}
                     for k in ("alone_ms", "alone_library_ms",
                               "alone_copies")}
        rows[kernel] = kernel_row(
            kernel, max_abs_err=max(c["max_abs_err"] for a in arms.values()
                                    for c in a.values()),
            ms=at["ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
            bound_by="bytes", library_ms=at["library_ms"],
            library_call={"zero_sgd": "torch._fused_sgd_",
                          "zero_momentum": "torch._fused_sgd_ (momentum)",
                          "zero_adam": "torch._fused_adam_"}[kernel],
            n=main_n, dtype="float32",
            ptxas=next((v for k, v in ptxas.items()
                        if f"{kernel}_kernel" in k), None),
            arms={a: {str(n): c for n, c in by_n.items()}
                  for a, by_n in arms.items()}, **extra)
    return rows


@contextlib.contextmanager
def annotated(torch, registry, op_types, label):
    """Wrap the lowerings of `op_types` in a torch.profiler range `label`,
    so the profiler can sum the device time of the kernels they launch."""
    saved = {}
    for t in op_types:
        opdef = registry.get(t)
        saved[t] = opdef.lower

        def wrapped(ctx, ins, attrs, _lower=opdef.lower):
            with torch.profiler.record_function(label):
                return _lower(ctx, ins, attrs)
        opdef.lower = wrapped
    try:
        yield
    finally:
        for t, lower in saved.items():
            registry.get(t).lower = lower


def bert_feed(cfg, batch, seed):
    """bench.py:383-394's feeds: random ids and labels, per-example lengths
    uniform in [S/2, S]."""
    rng = np.random.RandomState(seed)
    S = cfg.seq_len
    feed = {"input_ids": rng.randint(0, cfg.vocab_size,
                                     (batch, S)).astype(np.int64),
            "mlm_labels": rng.randint(0, cfg.vocab_size,
                                      (batch, S, 1)).astype(np.int64)}
    lens = rng.randint(S // 2, S + 1, size=(batch, 1))
    feed["input_mask"] = (np.arange(S)[None, :] < lens).astype(np.float32)
    return feed


def card_vs_cpu(torch, fa):
    """One Executor.run step of BERT-base widths at 2 layers on the card and
    on the CPU from the same startup arrays: f32, TF32 off, dropout 0."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import (Executor, Program, Scope,
                                            load_numpy, program_guard,
                                            unique_name)
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig(num_layers=2, seq_len=512, hidden_dropout=0.0,
                          attention_dropout=0.0)
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard():
        _, _, loss = bert.build_pretrain_program(cfg, use_input_mask=True)
        _, pgs = optimizer.Adam(learning_rate=1e-4).minimize(loss)
    cpu_scope = Scope()
    Executor("cpu").run(start, scope=cpu_scope)
    arrays = {n: cpu_scope.numpy(n) for n in cpu_scope.local_names()
              if not n.startswith("__")}
    feed = bert_feed(cfg, 2, seed=0)
    fetch = [loss] + [g for _, g in pgs]
    out = {}
    for dev in ("cuda", "cpu"):
        fa.reset_launches()
        t0 = time.perf_counter()
        out[dev] = Executor(dev).run(main, feed=feed, fetch_list=fetch,
                                     scope=load_numpy(Scope(), arrays, dev))
        log(f"card vs cpu: {dev} step {time.perf_counter() - t0:.2f} s, "
            f"loss {float(out[dev][0]):.6f}, flash launches "
            f"{dict(fa.launches)}")
        if dev == "cuda" and not all(fa.launches.values()):
            fail(f"card vs cpu: a flash kernel was not launched on the card "
                 f"step: {fa.launches}")
    l_gpu, l_cpu = float(out["cuda"][0]), float(out["cpu"][0])
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = {}
    for (p, _), a, b in zip(pgs, out["cuda"][1:], out["cpu"][1:]):
        grad_rel[p.name] = float(np.linalg.norm(a - b)
                                 / max(np.linalg.norm(b), 1e-30))
    worst = max(grad_rel, key=grad_rel.get)
    log(f"card vs cpu: loss rel {loss_rel:.2e} (limit 1e-4); worst grad "
        f"{worst} norm-rel {grad_rel[worst]:.2e} (limit 1e-3) over "
        f"{len(grad_rel)} parameters")
    if not np.isfinite(l_gpu) or loss_rel > 1e-4:
        fail(f"card vs cpu: loss {l_gpu} vs {l_cpu}")
    bad = {n: r for n, r in grad_rel.items() if not r <= 1e-3}
    if bad:
        fail(f"card vs cpu: gradients disagree: {bad}")
    return {"config": "BertConfig(num_layers=2, seq_len=512), batch 2, f32, "
                      "TF32 off, dropout 0, padding mask",
            "loss_cuda": l_gpu, "loss_cpu": l_cpu, "loss_rel": loss_rel,
            "worst_grad": worst, "worst_grad_norm_rel": grad_rel[worst]}


def build_bert(cfg, stage, opt="adam", amp=True):
    """(main, startup, loss, n_params) of BERT pretraining minimised
    through fleet at ZeRO `stage` with the default 32 MB buckets."""
    from paddle_tpu_torch import clip, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import Program, program_guard, unique_name
    from paddle_tpu_torch.models import bert
    make = {
        "adam": lambda: optimizer.Adam(learning_rate=1e-4),
        "sgd": lambda: optimizer.SGD(learning_rate=1e-3),
        "momentum": lambda: optimizer.Momentum(
            learning_rate=1e-3, momentum=0.9, use_nesterov=True),
        "adamw_clip": lambda: optimizer.AdamW(
            learning_rate=1e-4, weight_decay=0.01,
            grad_clip=clip.GradientClipByGlobalNorm(1.0)),
    }
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard():
        _, _, loss = bert.build_pretrain_program(cfg, use_input_mask=True)
        n_params = sum(int(np.prod(v.shape))
                       for v in main.global_block().vars.values()
                       if v.persistable and v.shape
                       and all(d > 0 for d in v.shape))
        fleet.init(is_collective=True)
        strategy = fleet.DistributedStrategy()
        strategy.amp = amp
        strategy.sharding_stage = stage
        fleet.distributed_optimizer(make[opt](), strategy).minimize(loss)
    return main, start, loss, n_params


def op_count(main, op_type):
    return sum(op.type == op_type for op in main.global_block().ops)


def scope_bytes(torch, scope):
    return sum(v.numel() * v.element_size()
               for v in (scope.find(n) for n in scope.local_names())
               if isinstance(v, torch.Tensor))


def train_bert(torch, fa, zk, registry, card):
    """BertConfig() at S 512, batch 16, through build_pretrain_program,
    fleet AMP bf16 and Adam(1e-4), at ZeRO stage 0 and stage 1 (default 32
    MB buckets): 2 warm-up and 10 timed steps of each, alternating (ABBA)
    so that both see one host state; then one profiled step of each."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.models import bert
    batch, steps = 16, 10
    cfg = bert.BertConfig()
    cfg.seq_len = 512
    exe = Executor("cuda")
    runs = {}
    for stage in (0, 1):
        main, start, loss, n_params = build_bert(cfg, stage)
        scope = Scope()
        exe.run(start, scope=scope)
        runs[stage] = {"main": main, "loss": loss, "scope": scope,
                       "losses": [], "step_ms": [], "peak": 0,
                       "launches": {}, "ops": len(main.global_block().ops),
                       "zero_update_ops": op_count(main, "__zero_update__"),
                       "bucket_sync_ops": op_count(main, "__bucket_sync__")}
    resident = {st: scope_bytes(torch, r["scope"]) for st, r in runs.items()}
    feed = bert_feed(cfg, batch, seed=0)

    def step(stage, timed):
        r = runs[stage]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        zk.reset_launches()
        t0 = time.perf_counter()
        r["losses"].append(float(exe.run(r["main"], feed=feed,
                                         fetch_list=[r["loss"]],
                                         scope=r["scope"])[0]))
        if timed:
            r["step_ms"].append((time.perf_counter() - t0) * 1e3)
            r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated())
            for name, c in list(fa.launches.items()) + \
                    list(zk.launches.items()):
                r["launches"][name] = r["launches"].get(name, 0) + c

    for i in range(2 + steps):
        for stage in ((0, 1) if i % 2 == 0 else (1, 0)):
            step(stage, timed=i >= 2)

    records = {}
    for stage, r in runs.items():
        if not all(np.isfinite(r["losses"])):
            fail(f"training stage {stage}: non-finite loss in {r['losses']}")
        if not all(r["launches"].get(n) for n in fa.KERNEL_NAMES):
            fail(f"training stage {stage}: a flash kernel was never "
                 f"launched: {r['launches']}")

        def one_step(r=r):
            t0 = time.perf_counter()
            exe.run(r["main"], feed=feed, fetch_list=[r["loss"]],
                    scope=r["scope"])
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        with annotated(torch, registry, ("adam", "__zero_update__"),
                       "optimizer_update"):
            profile = device_profile(torch, one_step, top=16,
                                     ranges=("optimizer_update",),
                                     kernels=("zero_adam_kernel",))
        tokens_per_s = batch * cfg.seq_len * steps / (sum(r["step_ms"]) / 1e3)
        other = resident[1 - stage]
        records[stage] = {
            "zero_stage": stage, "ops": r["ops"],
            "zero_update_ops": r["zero_update_ops"],
            "bucket_sync_ops": r["bucket_sync_ops"],
            "steps": steps, "losses": r["losses"],
            "tokens_per_s": tokens_per_s,
            "step_ms_p50": float(np.median(r["step_ms"])),
            "step_ms": r["step_ms"],
            "mfu": 6.0 * n_params * tokens_per_s / BF16_FLOPS_PER_S,
            "peak_memory_gib": r["peak"] / 2 ** 30,
            "peak_memory_gib_without_other_stage": (r["peak"] - other)
            / 2 ** 30,
            "resident_state_gib": resident[stage] / 2 ** 30,
            "launches_per_step": {n: c / steps
                                  for n, c in r["launches"].items()},
            "launches": r["launches"], "profile": profile}
        log(f"training stage {stage}: {r['ops']} ops ({r['zero_update_ops']}"
            f" __zero_update__, {r['bucket_sync_ops']} __bucket_sync__), "
            f"{tokens_per_s:.1f} tokens/s, step p50 "
            f"{records[stage]['step_ms_p50']:.1f} ms, MFU "
            f"{records[stage]['mfu']:.4f}, peak "
            f"{records[stage]['peak_memory_gib']:.2f} GiB (other stage's "
            f"state {other / 2 ** 30:.2f} GiB resident), losses "
            f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, "
            f"launches/step {records[stage]['launches_per_step']}")
        log(f"training stage {stage} step under torch.profiler: {profile}")
    n_b8 = runs[1]["launches"].get("zero_adam", 0)
    want = ZERO_MAIN_PATH_BUCKETS * steps
    if runs[1]["zero_update_ops"] != ZERO_MAIN_PATH_BUCKETS or n_b8 != want:
        fail(f"training stage 1: {runs[1]['zero_update_ops']} buckets and "
             f"{n_b8} B8 launches in {steps} steps; want "
             f"{ZERO_MAIN_PATH_BUCKETS} and {want}")
    if runs[0]["launches"].get("zero_adam", 0):
        fail("training stage 0 launched B8")
    row = {"config": "BertConfig() (12 layers, hidden 768, 12 heads, vocab "
                     "30522), seq 512, batch 16, padding mask, dropout 0.1, "
                     "fleet AMP bf16, Adam 1e-4, random weights and labels",
           "n_params": n_params, "card": card,
           "alternation": "stage 0 and stage 1 steps in ABBA order, one "
                          "host state; both scopes resident"}
    row.update(records[0])
    row["stage1"] = records[1]
    return row, runs[0]["launches"], runs[1]["launches"]


def zero_card_gate(torch, zk):
    """BERT-base widths at 2 layers, S 512, batch 2, f32, dropout 0: 3
    steps at stage 1 against the same 3 steps at stage 0 from the same
    startup values. Losses rtol 1e-6, every parameter max abs 1e-6;
    bit-identical is expected (B8 equals the plain rule bit for bit)."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig(num_layers=2, seq_len=512, hidden_dropout=0.0,
                          attention_dropout=0.0)
    feeds = [bert_feed(cfg, 2, seed=s) for s in range(3)]
    out = {}
    for stage in (0, 1):
        main, start, loss, _ = build_bert(cfg, stage, amp=False)
        scope, exe = Scope(), Executor("cuda")
        exe.run(start, scope=scope)
        names = [p.name for p in main.all_parameters()]
        init = {n: scope.find(n).clone() for n in names}
        zk.reset_launches()
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0]) for f in feeds]
        out[stage] = (losses, init, {n: scope.find(n) for n in names},
                      zk.launches["zero_adam"], op_count(main,
                                                          "__zero_update__"))
    (l0, i0, p0, _, _), (l1, i1, p1, n_b8, n_ops) = out[0], out[1]
    if not all(torch.equal(i0[n], i1[n]) for n in i0):
        fail("zero card gate: stage 0 and stage 1 start from other values")
    if not n_ops or n_b8 != 3 * n_ops:
        fail(f"zero card gate: {n_b8} B8 launches for {n_ops} buckets")
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(l0, l1))
    diffs = {n: (p1[n] - p0[n]).abs().max().item() for n in p0}
    worst = max(diffs, key=diffs.get)
    bitwise = l0 == l1 and all(torch.equal(p0[n], p1[n]) for n in p0)
    log(f"zero card gate: stage 1 vs stage 0, losses {l1} vs {l0}: max rel "
        f"{loss_rel:.3e} (limit 1e-6); largest parameter difference "
        f"{diffs[worst]:.3e} in {worst} (limit 1e-6); bit-identical: "
        f"{bitwise}")
    if not loss_rel <= 1e-6 or not diffs[worst] <= 1e-6:
        fail("zero card gate: stage 1 does not train as stage 0")
    return {"config": "BertConfig(num_layers=2, seq_len=512), batch 2, f32, "
                      "TF32 off, dropout 0, padding mask, Adam 1e-4, 3 steps",
            "losses_stage0": l0, "losses_stage1": l1, "loss_max_rel": loss_rel,
            "param_max_abs_diff": diffs[worst], "worst_param": worst,
            "bit_identical": bitwise, "b8_launches": n_b8, "buckets": n_ops}


def zero_arms(torch, zk):
    """The off-path arms: BERT-base widths at 2 layers, S 512, batch 4,
    AMP, 3 steps each. Stages 2 and 3 with Adam against stage 1 (losses
    rtol 1e-6); SGD, Momentum (nesterov) and AdamW + global-norm clip at
    stage 1 (the clipped buckets are pre-synced and keep their
    __bucket_sync__). Each arm fails unless its kernel launched once per
    bucket and step."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig(num_layers=2, seq_len=512)
    feeds = [bert_feed(cfg, 4, seed=s) for s in range(3)]
    kernel_of = {"adam": "zero_adam", "adamw_clip": "zero_adam",
                 "sgd": "zero_sgd", "momentum": "zero_momentum"}
    records, launches = [], {}
    for opt, stage in (("adam", 1), ("adam", 2), ("adam", 3), ("sgd", 1),
                       ("momentum", 1), ("adamw_clip", 1)):
        main, start, loss, _ = build_bert(cfg, stage, opt=opt)
        scope, exe = Scope(), Executor("cuda")
        exe.run(start, scope=scope)
        zk.reset_launches()
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0]) for f in feeds]
        kernel = kernel_of[opt]
        n_ops = op_count(main, "__zero_update__")
        rec = {"optimizer": opt, "zero_stage": stage, "losses": losses,
               "zero_update_ops": n_ops,
               "bucket_sync_ops": op_count(main, "__bucket_sync__"),
               "kernel": kernel, "launches": zk.launches[kernel],
               "pre_synced": sorted({op.attrs["pre_synced"]
                                     for op in main.global_block().ops
                                     if op.type == "__zero_update__"})}
        log(f"zero arm {opt} stage {stage}: losses {losses}, {n_ops} "
            f"buckets, {rec['bucket_sync_ops']} __bucket_sync__, {kernel} "
            f"launches {rec['launches']}")
        if not all(np.isfinite(losses)):
            fail(f"zero arm {opt} stage {stage}: non-finite loss")
        if not n_ops or rec["launches"] != 3 * n_ops:
            fail(f"zero arm {opt} stage {stage}: {rec['launches']} {kernel} "
                 f"launches for {n_ops} buckets")
        if opt == "adamw_clip" and (rec["pre_synced"] != [True]
                                    or not rec["bucket_sync_ops"]):
            fail("zero arm adamw_clip: clipped buckets are not pre-synced")
        if opt == "adam" and stage > 1:
            ref = records[0]["losses"]
            rec["loss_max_rel_vs_stage1"] = max(
                abs(a - b) / abs(b) for a, b in zip(losses, ref))
            if not rec["loss_max_rel_vs_stage1"] <= 1e-6:
                fail(f"zero arm adam stage {stage}: losses {losses} differ "
                     f"from stage 1's {ref}")
        if opt in ("sgd", "momentum"):
            launches[kernel] = rec["launches"]
        records.append(rec)
        del main, start, scope, exe
        torch.cuda.empty_cache()
    return records, launches


def build_gpt(cfg, stage, amp=True):
    """(main, startup, loss, n_params) of GPT LM training as bench.py's
    bench_gpt builds it: build_lm_program (fused head auto-selected), fleet
    AMP bf16, Adam(1e-4), at ZeRO `stage` with the default buckets."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import Program, program_guard, unique_name
    from paddle_tpu_torch.models import gpt
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard():
        _, loss = gpt.build_lm_program(cfg)
        n_params = sum(int(np.prod(v.shape))
                       for v in main.global_block().vars.values()
                       if v.persistable and v.shape
                       and all(d > 0 for d in v.shape))
        fleet.init(is_collective=True)
        strategy = fleet.DistributedStrategy()
        strategy.amp = amp
        strategy.sharding_stage = stage
        fleet.distributed_optimizer(optimizer.Adam(learning_rate=1e-4),
                                    strategy).minimize(loss)
    return main, start, loss, n_params


def gpt_config():
    """GPTConfig() (GPT-2 small, dropout 0.1) at seq 512."""
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig()
    cfg.seq_len = GPT_SEQ
    return cfg


def gpt_tokens(cfg, batch, steps, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab_size,
                       (steps, batch, cfg.seq_len)).astype(np.int64)


def scope_copy(torch, scope):
    """A new Scope holding device copies of `scope`'s tensors (and its run
    counter): the same initial state for a second arm."""
    from paddle_tpu_torch.framework import Scope
    out = Scope()
    for n in scope.local_names():
        v = scope.find(n)
        out.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return out


def gpt_card_vs_cpu(torch, fa):
    """One Executor.run step of GPT-2 small widths at 2 layers, S 512,
    batch 2, f32 (no fleet, TF32 off), dropout 0, on the card and on the
    CPU from the same startup arrays: the loss within 1e-4 relative, every
    parameter gradient within 1e-3 norm-relative."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import (Executor, Program, Scope,
                                            load_numpy, program_guard,
                                            unique_name)
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(num_layers=2, seq_len=GPT_SEQ, hidden_dropout=0.0,
                        attention_dropout=0.0)
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard():
        _, loss = gpt.build_lm_program(cfg)
        _, pgs = optimizer.Adam(learning_rate=1e-4).minimize(loss)
    cpu_scope = Scope()
    Executor("cpu").run(start, scope=cpu_scope)
    arrays = {n: cpu_scope.numpy(n) for n in cpu_scope.local_names()
              if not n.startswith("__")}
    feed = {"tokens": gpt_tokens(cfg, 2, 1, seed=3)[0]}
    fetch = [loss] + [g for _, g in pgs]
    out = {}
    for dev in ("cuda", "cpu"):
        fa.reset_launches()
        t0 = time.perf_counter()
        out[dev] = Executor(dev).run(main, feed=feed, fetch_list=fetch,
                                     scope=load_numpy(Scope(), arrays, dev))
        log(f"gpt card vs cpu: {dev} step {time.perf_counter() - t0:.2f} s, "
            f"loss {float(out[dev][0]):.6f}, flash launches "
            f"{dict(fa.launches)}")
        if dev == "cuda" and not all(fa.launches.values()):
            fail(f"gpt card vs cpu: a flash kernel was not launched: "
                 f"{fa.launches}")
    l_gpu, l_cpu = float(out["cuda"][0]), float(out["cpu"][0])
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = {p.name: float(np.linalg.norm(a - b)
                              / max(np.linalg.norm(b), 1e-30))
                for (p, _), a, b in zip(pgs, out["cuda"][1:],
                                        out["cpu"][1:])}
    worst = max(grad_rel, key=grad_rel.get)
    log(f"gpt card vs cpu: loss rel {loss_rel:.2e} (limit 1e-4); worst grad "
        f"{worst} norm-rel {grad_rel[worst]:.2e} (limit 1e-3) over "
        f"{len(grad_rel)} parameters")
    if not np.isfinite(l_gpu) or loss_rel > 1e-4:
        fail(f"gpt card vs cpu: loss {l_gpu} vs {l_cpu}")
    bad = {n: r for n, r in grad_rel.items() if not r <= 1e-3}
    if bad:
        fail(f"gpt card vs cpu: gradients disagree: {bad}")
    return {"config": "GPTConfig(num_layers=2), seq 512, batch 2, f32, TF32 "
                      "off, dropout 0, fused head (vocab 50257)",
            "loss_cuda": l_gpu, "loss_cpu": l_cpu, "loss_rel": loss_rel,
            "worst_grad": worst, "worst_grad_norm_rel": grad_rel[worst]}


def gpt_capture_gate(torch, fa, zk, cfg, stage, steps=3):
    """Captured == eager, bit for bit: from one startup state, `steps`
    Executor.run calls on one scope and run_steps(steps) (one capture, then
    a replay per step) on a copy; the stacked losses and every persistable
    (parameters, Adam moments, beta pows, ZeRO flat state) must be equal,
    dropout on. The captured arm must make no eager step, and B1-B3 (and
    B8 at stage 1) must launch in the graph."""
    from paddle_tpu_torch.framework import Executor, Scope
    main, start, loss, _ = build_gpt(cfg, stage)
    sa = Scope()
    Executor("cuda").run(start, scope=sa)
    sb = scope_copy(torch, sa)
    toks = gpt_tokens(cfg, GPT_BATCH, steps, seed=11 + stage)
    eager = Executor("cuda")
    t0 = time.perf_counter()
    el = [float(eager.run(main, feed={"tokens": toks[b]}, fetch_list=[loss],
                          scope=sa)[0]) for b in range(steps)]
    eager_s = time.perf_counter() - t0
    cap = Executor("cuda")
    fa.reset_launches()
    zk.reset_launches()
    t0 = time.perf_counter()
    cl, = cap.run_steps(steps, main, feed={"tokens": toks},
                        fetch_list=[loss], scope=sb)
    cap_s = time.perf_counter() - t0
    launches = dict(fa.launches, **zk.launches)
    names = sorted(v.name for v in main.global_block().vars.values()
                   if v.persistable
                   and isinstance(sa.find(v.name), torch.Tensor))
    diffs = {}
    for n in names:
        a, b = sa.find(n), sb.find(n)
        if not torch.equal(a, b):
            diffs[n] = (a.float() - b.float()).abs().max().item()
    bitwise = not diffs and [float(x) for x in cl] == el
    n_buckets = op_count(main, "__zero_update__")
    steps_run = steps + cap.stats["warmup_steps"]
    log(f"gpt capture gate stage {stage}: eager {el} ({eager_s:.1f} s), "
        f"captured {cl.tolist()} ({cap_s:.1f} s incl. warm-up and "
        f"capture); {len(names)} persistables, {len(diffs)} differ "
        f"{dict(list(diffs.items())[:5])}; executor stats {cap.stats}; "
        f"launches {launches}")
    if not bitwise:
        fail(f"gpt capture gate stage {stage}: captured run_steps != eager "
             f"runs: losses {cl.tolist()} vs {el}, persistables differing "
             f"{diffs}")
    if cap.stats["eager_steps"] or cap.stats["graph_replays"] != steps:
        fail(f"gpt capture gate stage {stage}: executor stats {cap.stats}")
    for name in fa.KERNEL_NAMES:
        if launches[name] != steps_run * cfg.num_layers:
            fail(f"gpt capture gate stage {stage}: {name} launched "
                 f"{launches[name]} times in {steps_run} steps")
    if stage and (not n_buckets
                  or launches["zero_adam"] != steps_run * n_buckets):
        fail(f"gpt capture gate stage 1: {launches['zero_adam']} B8 "
             f"launches for {n_buckets} buckets in {steps_run} steps")
    if not stage and launches["zero_adam"]:
        fail("gpt capture gate stage 0 launched B8")
    row = {"zero_stage": stage, "steps": steps, "losses_eager": el,
           "losses_captured": [float(x) for x in cl], "bit_identical": True,
           "persistables_compared": len(names), "zero_update_ops": n_buckets,
           "executor_stats": dict(cap.stats),
           "launches_incl_warmup": launches}
    del main, start, sa, sb, eager, cap
    release(torch)
    return row


def train_gpt(torch, fa, zk, registry, gpt_decode, serving, card):
    """GPTConfig() at seq 512, batch 32, as bench_gpt trains it (one batch
    fed to every step), fleet AMP bf16, Adam(1e-4), ZeRO stage 0, on one
    scope: the eager arm (2 warm-up, then 10 timed Executor.run steps, one
    more window of 3 steps profiled), then the captured arm (run_steps(10):
    the capture, then 3 timed windows and one profiled). The cache is
    emptied between arms and the peak memory of each kept. Then the
    trained weights serve 2 greedy requests from params_from_scope."""
    from paddle_tpu_torch.framework import Executor, Scope
    cfg = gpt_config()
    main, start, loss, n_params = build_gpt(cfg, 0)
    scope = Scope()
    Executor("cuda").run(start, scope=scope)
    tokens = gpt_tokens(cfg, GPT_BATCH, 1, seed=0)[0]
    feed = {"tokens": tokens}
    step_tokens = GPT_BATCH * GPT_SEQ
    dtypes = set()
    attn = registry.get("fused_attention")
    lower = attn.lower

    def seen(ctx, ins, attrs):          # the dtype AMP hands the lowering
        dtypes.add(str(ins["Q"][0].dtype).replace("torch.", ""))
        return lower(ctx, ins, attrs)

    attn.lower = seen
    arms = {}
    try:
        # ---- eager arm
        exe = Executor("cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        fa.reset_launches()
        zk.reset_launches()
        exe.stats.update(dict.fromkeys(exe.stats, 0))
        ms, losses = [], []
        for _ in range(GPT_WINDOW):
            t0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope)[0]))
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(fa.launches, **zk.launches)
        stats = dict(exe.stats)
        peak = torch.cuda.max_memory_allocated()

        def eager_window():
            t0 = time.perf_counter()
            for _ in range(3):
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        arms["eager"] = dict(
            step_ms=ms, losses=losses, launches=launches, stats=stats,
            peak=peak, profile=device_profile(torch, eager_window, top=10))
        del exe
        # ---- captured arm
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        exe = Executor("cuda")
        t0 = time.perf_counter()
        exe.run_steps(GPT_WINDOW, main, feed=feed, fetch_list=[loss],
                      scope=scope)
        capture_s = time.perf_counter() - t0
        fa.reset_launches()
        zk.reset_launches()
        exe.stats.update(dict.fromkeys(exe.stats, 0))
        ms, losses = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            out, = exe.run_steps(GPT_WINDOW, main, feed=feed,
                                 fetch_list=[loss], scope=scope)
            ms.append((time.perf_counter() - t0) * 1e3 / GPT_WINDOW)
            losses += [float(x) for x in out]
        launches = dict(fa.launches, **zk.launches)
        stats = dict(exe.stats)
        # the graph's private pool: allocated during the capture, reserved
        # (not allocated) between replays
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.memory_reserved()

        def captured_window():
            t0 = time.perf_counter()
            exe.run_steps(GPT_WINDOW, main, feed=feed, fetch_list=[loss],
                          scope=scope)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        arms["captured"] = dict(
            step_ms=ms, losses=losses, launches=launches, stats=stats,
            peak=peak, capture_s=capture_s, reserved=reserved,
            profile=device_profile(torch, captured_window, top=12,
                                   kernels=("gemm", "nvjet")))
        del exe
    finally:
        attn.lower = lower
    torch.cuda.empty_cache()
    out = {"config": "GPTConfig() (GPT-2 small: 12 layers, hidden 768, 12 "
                     "heads, FFN 3072, vocab 50257, max_position 1024, "
                     "dropout 0.1), seq 512, batch 32, one random batch "
                     "for every step (bench_gpt), fused LM head "
                     "(auto-selected), fleet AMP bf16, Adam 1e-4, ZeRO "
                     "stage 0, random weights (startup program)",
           "card": card, "n_params": n_params,
           "attention_dtype_under_amp": sorted(dtypes)}
    for name, a in arms.items():
        n_steps = a["stats"]["graph_replays"] or a["stats"]["eager_steps"]
        p50 = float(np.median(a["step_ms"]))
        tps = step_tokens / (p50 / 1e3)
        per_step = {k: v / n_steps for k, v in a["launches"].items()}
        out[name] = {
            "step_ms_p50": p50, "step_ms": a["step_ms"],
            "tokens_per_s": tps,
            "mfu": 6.0 * n_params * tps / BF16_FLOPS_PER_S,
            "peak_memory_gib": a["peak"] / 2 ** 30,
            "graph_replays": a["stats"]["graph_replays"],
            "eager_step_calls": a["stats"]["eager_steps"],
            "launches_per_step": per_step, "losses": a["losses"],
            "profile": a["profile"]}
        if name == "captured":
            out[name].update(capture_s=a["capture_s"],
                             reserved_after_windows_gib=a["reserved"]
                             / 2 ** 30,
                             peak_memory_covers="warm-up, capture and 3 "
                                                "windows",
                             timing="3 windows of run_steps(10), each to "
                                    "its loss fetch; p50 of the per-step "
                                    "means")
        else:
            out[name].update(
                peak_memory_covers="2 warm-up and 10 timed steps",
                timing="10 Executor.run steps, each to its loss fetch; p50")
        log(f"gpt training {name}: step p50 {p50:.1f} ms, {tps:.0f} "
            f"tokens/s, MFU {out[name]['mfu']:.4f}, peak "
            f"{out[name]['peak_memory_gib']:.2f} GiB, replays "
            f"{out[name]['graph_replays']}, eager steps "
            f"{out[name]['eager_step_calls']}, launches/step {per_step}, "
            f"losses {a['losses'][0]:.4f} -> {a['losses'][-1]:.4f}")
        log(f"gpt training {name} window under torch.profiler: "
            f"{a['profile']}")
        if not all(np.isfinite(a["losses"])):
            fail(f"gpt training {name}: non-finite loss")
        for k in fa.KERNEL_NAMES:
            if per_step.get(k) != cfg.num_layers:
                fail(f"gpt training {name}: {k} launched {per_step.get(k)} "
                     f"times a step, want {cfg.num_layers}")
    if out["captured"]["eager_step_calls"] or \
            out["captured"]["graph_replays"] != 3 * GPT_WINDOW:
        fail(f"gpt training captured arm: {out['captured']['graph_replays']}"
             f" replays, {out['captured']['eager_step_calls']} eager steps")
    if out["eager"]["graph_replays"]:
        fail("gpt training eager arm replayed a graph")
    out["head"] = head_profile(torch, cfg)
    # ---- the trained weights serve
    params = gpt_decode.params_from_scope(cfg, scope, device="cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (12, 40)]
    eng = serving.DecodeEngine(params, cfg, device="cuda", max_slots=2,
                               block_size=16, num_blocks=32, max_len=128,
                               window=8)
    try:
        comps, _ = serve_on(torch, eng, [serving.Request(
            prompt=p, max_new_tokens=8) for p in prompts])
        captured_only(eng.stats(), "trained GPT engine")
    finally:
        eng.stop()
    for p, c in zip(prompts, comps):
        dense = gpt_decode.generate(params, cfg, p[None], 8, device="cuda")
        if dense[0, len(p):].tolist() != c.tokens:
            fail(f"trained GPT: served tokens {c.tokens} != dense generate "
                 f"{dense[0, len(p):].tolist()}")
    out["served"] = {"requests": len(prompts), "new_tokens": 8,
                     "tokens": [c.tokens for c in comps],
                     "equal_to_dense_generate": True}
    log(f"trained GPT-2 small (params_from_scope, f32) served "
        f"{[c.tokens for c in comps]} == dense generate")
    del params, scope, main, start
    torch.cuda.empty_cache()
    return out, arms["captured"]["launches"]


def head_profile(torch, cfg):
    """The fused LM head (ops/fused_ce.py `ChunkedLMCE`) alone at the GPT
    main path's shapes as fleet AMP hands them to it (x [32, 512, 768] and
    the tied wte [50257, 768] in bf16, the bias in f32): forward and
    backward under torch.profiler, its kernels by name and the device
    time of its GEMMs (cuBLAS names them *gemm* or nvjet*). The logits
    GEMM and its recompute take the bf16 operands with f32 output; dx and
    dw are f32 GEMMs."""
    from paddle_tpu_torch.ops.fused_ce import DEFAULT_CHUNK, ChunkedLMCE
    g = torch.Generator(device="cuda").manual_seed(0)
    h, v = cfg.hidden_size, cfg.vocab_size
    x = torch.randn((GPT_BATCH, GPT_SEQ, h), generator=g, device="cuda") \
        .bfloat16().requires_grad_()
    w = (torch.randn((v, h), generator=g, device="cuda") * 0.02) \
        .bfloat16().requires_grad_()
    b = torch.zeros((v,), device="cuda", requires_grad=True)
    labels = torch.randint(0, v, (GPT_BATCH, GPT_SEQ), generator=g,
                           device="cuda")

    def step():
        t0 = time.perf_counter()
        loss, _ = ChunkedLMCE.apply(x, w, b, labels, DEFAULT_CHUNK, -100)
        loss.sum().backward()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    step()
    ms = float(np.median([step() for _ in range(3)])) * 1e3
    prof = device_profile(torch, step, top=12, kernels=("gemm", "nvjet"))
    out = {"shapes": f"x [{GPT_BATCH}, {GPT_SEQ}, {h}] bf16, w [{v}, {h}] "
                     f"bf16, bias f32, chunk {DEFAULT_CHUNK}",
           "fwd_bwd_ms_p50": ms, "profile": prof,
           "logits_gemm_flop_per_step": 2 * 2 * GPT_BATCH * GPT_SEQ * h * v}
    log(f"fused LM head alone (fwd + bwd): {ms:.2f} ms; {prof}")
    del x, w, b
    return out


# ---------------------------------------------------------------------------
# GPT-2 small training that survives a restart
# ---------------------------------------------------------------------------

# the phase's LR: linear_lr_warmup(cosine_decay(PEAK, 1, EPOCHS), WARMUP,
# START, PEAK): a step at START, then the cosine from its top, so the first
# three steps see the LR rise and then fall
LR_START, LR_PEAK, LR_WARMUP, LR_EPOCHS = 1e-5, 1e-4, 1, 8
STATE_WINDOW = 10           # run_steps(k) of the snapshot-cost windows


def build_gpt_state(cfg, stage=1, lr="schedule", opt="adamw"):
    """(main, startup, loss, lr var) of GPT LM training as a long run
    trains it: build_lm_program, fleet AMP bf16 at ZeRO `stage`, AdamW
    (weight decay 0.01) with GradientClipByGlobalNorm(1.0), the LR a static
    schedule built in the program (`lr="schedule"`), a host LRScheduler or
    a float; `opt` "sgd" / "momentum" for the B6/B7 arm."""
    from paddle_tpu_torch import clip, layers, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import Program, program_guard, unique_name
    from paddle_tpu_torch.models import gpt
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard():
        _, loss = gpt.build_lm_program(cfg)
        if lr == "schedule":
            lr = layers.linear_lr_warmup(
                layers.cosine_decay(LR_PEAK, 1, LR_EPOCHS), LR_WARMUP,
                LR_START, LR_PEAK)
        if opt == "sgd":
            o = optimizer.SGD(learning_rate=lr)
        elif opt == "momentum":
            o = optimizer.Momentum(learning_rate=lr, momentum=0.9)
        else:
            o = optimizer.AdamW(
                learning_rate=lr, weight_decay=0.01,
                grad_clip=clip.GradientClipByGlobalNorm(1.0))
        fleet.init(is_collective=True)
        strategy = fleet.DistributedStrategy()
        strategy.amp = True
        strategy.sharding_stage = stage
        fleet.distributed_optimizer(o, strategy).minimize(loss)
    return main, start, loss, o.learning_rate_var


def host_lr_f32(step):
    """The schedule at counter `step` by the program's own f32 operations
    in numpy (the card's cosf may differ from numpy's by an ulp)."""
    f = np.float32
    s = f(step)
    if s < f(LR_WARMUP):
        return f(f(LR_START) + f(f(s * f(LR_PEAK - LR_START))
                                 / f(LR_WARMUP)))
    epoch = np.floor(f(s / f(1.0)))
    cosv = np.cos(f(epoch * f(np.pi / LR_EPOCHS)), dtype=np.float32)
    return f(f(cosv + f(1.0)) * f(0.5 * LR_PEAK))


def ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def persistable_diffs(torch, main, sa, sb):
    names = sorted(v.name for v in main.global_block().vars.values()
                   if v.persistable and isinstance(sa.find(v.name),
                                                   torch.Tensor))
    diffs = {}
    for n in names:
        a, b = sa.find(n), sb.find(n)
        if b is None or not torch.equal(a, b):
            diffs[n] = "missing" if b is None else \
                (a.float() - b.float()).abs().max().item()
    return names, diffs


def release(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def schedule_capture_gate(torch, fa, zk, cfg, steps=3):
    """run_steps(steps) under the static schedule == `steps` Executor.run
    calls, bit for bit (losses, the fetched LR, every persistable and the
    LR counter); the fetched LR within 1 f32 ulp of the host formula; B8
    one launch per bucket and step inside the graph, B1-B3 12 a step."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.parallel.zero import zero_buckets
    main, start, loss, lr_var = build_gpt_state(cfg)
    sa = Scope()
    Executor("cuda").run(start, scope=sa)
    sb = scope_copy(torch, sa)
    toks = gpt_tokens(cfg, GPT_BATCH, steps, seed=21)
    eager = Executor("cuda")
    e = [eager.run(main, feed={"tokens": toks[b]},
                   fetch_list=[loss, lr_var], scope=sa) for b in range(steps)]
    el = [float(x[0]) for x in e]
    elr = [float(np.asarray(x[1]).ravel()[0]) for x in e]
    cap = Executor("cuda")
    fa.reset_launches()
    zk.reset_launches()
    t0 = time.perf_counter()
    cl, clr = cap.run_steps(steps, main, feed={"tokens": toks},
                            fetch_list=[loss, lr_var], scope=sb)
    cap_s = time.perf_counter() - t0
    launches = dict(fa.launches, **zk.launches)
    cl = [float(x) for x in cl]
    clr = [float(np.asarray(x).ravel()[0]) for x in clr]
    names, diffs = persistable_diffs(torch, main, sa, sb)
    counter = [n for n in names if n.startswith("@LR_DECAY_COUNTER@")]
    host = [float(host_lr_f32(b)) for b in range(steps)]
    lr_ulps = [ulps(a, b) for a, b in zip(clr, host)]
    n_buckets = len(zero_buckets(main))
    steps_run = steps + cap.stats["warmup_steps"]
    log(f"schedule capture gate: eager {el}, captured {cl} ({cap_s:.1f} s "
        f"incl. warm-up and capture); LR eager {elr} captured {clr} host "
        f"{host} ({lr_ulps} ulps); {len(names)} persistables, {len(diffs)} "
        f"differ {dict(list(diffs.items())[:5])}; stats {cap.stats}; "
        f"launches {launches}")
    if diffs or cl != el or clr != elr:
        fail(f"schedule capture gate: captured != eager: losses {cl} vs "
             f"{el}, LR {clr} vs {elr}, persistables differing {diffs}")
    if not counter or sb.numpy(counter[0]).tolist() != [float(steps - 1)]:
        fail(f"schedule capture gate: LR counter {counter}")
    if max(lr_ulps) > 1:
        fail(f"schedule capture gate: LR {clr} vs host {host}")
    if not (clr[1] > clr[0] and clr[2] < clr[1]):
        fail(f"schedule capture gate: the LR does not rise then fall: {clr}")
    if cap.stats["eager_steps"] or cap.stats["captures"] != 1 \
            or cap.stats["graph_replays"] != steps:
        fail(f"schedule capture gate: executor stats {cap.stats}")
    for name in fa.KERNEL_NAMES:
        if launches[name] != steps_run * cfg.num_layers:
            fail(f"schedule capture gate: {name} launched {launches[name]} "
                 f"times in {steps_run} steps")
    if not n_buckets or launches["zero_adam"] != steps_run * n_buckets:
        fail(f"schedule capture gate: {launches['zero_adam']} B8 launches "
             f"for {n_buckets} buckets in {steps_run} steps")
    row = {"steps": steps, "losses_eager": el, "losses_captured": cl,
           "lr_eager": elr, "lr_captured": clr, "lr_host_f32": host,
           "lr_ulps": lr_ulps, "bit_identical": True,
           "persistables_compared": len(names), "zero_buckets": n_buckets,
           "b8_launches_per_step": launches["zero_adam"] / steps_run,
           "executor_stats": dict(cap.stats),
           "launches_incl_warmup": launches}
    del main, start, sa, sb, eager, cap
    release(torch)
    return row


def host_scheduler_gate(torch, cfg, calls=3, k=3):
    """A host LinearWarmup(CosineAnnealingDecay) bound to AdamW, stepped
    between `calls` run_steps(k) calls on one executor and scope: one
    capture in all, each call's k steps at the scheduler's LR (f32)."""
    from paddle_tpu_torch import lr as lr_mod
    from paddle_tpu_torch.framework import Executor, Scope
    sched = lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(LR_PEAK, T_max=LR_EPOCHS), LR_WARMUP,
        LR_START, LR_PEAK)
    main, start, loss, lr_var = build_gpt_state(cfg, lr=sched)
    scope = Scope()
    Executor("cuda").run(start, scope=scope)
    exe = Executor("cuda")
    toks = gpt_tokens(cfg, GPT_BATCH, k, seed=22)
    lrs, losses, want = [], [], []
    bound = None
    for call in range(calls):
        if call:
            sched.step()
        out, lr = exe.run_steps(k, main, feed={"tokens": toks},
                                fetch_list=[loss, lr_var], scope=scope)
        losses += [float(x) for x in out]
        lrs.append([float(np.asarray(x).ravel()[0]) for x in lr])
        want.append(float(np.float32(sched())))
        if bound is None:
            bound = scope.find(lr_var.name)
    log(f"host scheduler gate: LR per call {lrs} (scheduler {want}); "
        f"losses {losses}; stats {exe.stats}")
    if exe.stats["captures"] != 1 or exe.stats["eager_steps"] \
            or exe.stats["graph_replays"] != calls * k:
        fail(f"host scheduler gate: executor stats {exe.stats}")
    if lrs != [[w] * k for w in want] or len(set(want)) != calls:
        fail(f"host scheduler gate: LR {lrs} vs scheduler {want}")
    if scope.find(lr_var.name) is not bound:
        fail("host scheduler gate: the LR tensor was rebound")
    if not all(np.isfinite(losses)):
        fail(f"host scheduler gate: losses {losses}")
    row = {"calls": calls, "k": k, "lr_per_call": lrs,
           "scheduler_lr": want, "captures": exe.stats["captures"],
           "graph_replays": exe.stats["graph_replays"], "losses": losses}
    del main, start, scope, exe
    release(torch)
    return row


def schedule_sgd_momentum_gate(torch, zk, steps=3):
    """SGD and Momentum at stage 1 under the static schedule (GPT-2 small
    widths at 2 layers, S 512, batch 4, fleet AMP): captured == eager bit
    for bit, B6 / B7 one launch per bucket and step inside the graph."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.zero import zero_buckets
    cfg = gpt.GPTConfig(num_layers=2, seq_len=GPT_SEQ)
    rows, launches_by_kernel = {}, {}
    for opt, kernel in (("sgd", "zero_sgd"), ("momentum", "zero_momentum")):
        main, start, loss, lr_var = build_gpt_state(cfg, opt=opt)
        sa = Scope()
        Executor("cuda").run(start, scope=sa)
        sb = scope_copy(torch, sa)
        toks = gpt_tokens(cfg, 4, steps, seed=23)
        eager = Executor("cuda")
        el = [float(eager.run(main, feed={"tokens": toks[b]},
                              fetch_list=[loss], scope=sa)[0])
              for b in range(steps)]
        cap = Executor("cuda")
        zk.reset_launches()
        cl, = cap.run_steps(steps, main, feed={"tokens": toks},
                            fetch_list=[loss], scope=sb)
        cl = [float(x) for x in cl]
        n = zk.launches[kernel]
        names, diffs = persistable_diffs(torch, main, sa, sb)
        n_buckets = len(zero_buckets(main))
        steps_run = steps + cap.stats["warmup_steps"]
        log(f"schedule {opt} stage 1: eager {el}, captured {cl}; "
            f"{len(diffs)} of {len(names)} persistables differ; {kernel} "
            f"launches {n} for {n_buckets} buckets")
        if diffs or cl != el:
            fail(f"schedule {opt} stage 1: captured != eager: {cl} vs {el}, "
                 f"{diffs}")
        if not n_buckets or n != steps_run * n_buckets:
            fail(f"schedule {opt} stage 1: {kernel} launched {n} times for "
                 f"{n_buckets} buckets in {steps_run} steps")
        rows[opt] = {"losses": cl, "bit_identical": True,
                     "zero_buckets": n_buckets, "launches_incl_warmup": n}
        launches_by_kernel[kernel] = n
        del main, start, sa, sb, eager, cap
        release(torch)
    return rows, launches_by_kernel


def span_ms(trace, since_us):
    """{span name: ms} of the `ckpt.*` spans recorded since `since_us`."""
    out = {}
    for e in trace.events(since_us):
        if e.get("ph") == "X" and e["name"].startswith("ckpt."):
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e3
    return out


def resume_gate(torch, cfg, workdir, steps=3):
    """Arm A: 2 x run_steps(steps) straight through. Arm B: run_steps(steps),
    CheckpointManager.save, the executor, scope and graph pool dropped, a
    rebuilt program restored into a fresh executor and scope
    (restore_latest), run_steps(steps). Arm B's losses and final
    persistables (and run-seed counter) == arm A's, bit for bit, dropout
    on. Bytes, save / validate / restore times and each arm's peak memory
    are kept."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.observability import trace as _trace
    from paddle_tpu_torch.resilience import (CheckpointManager,
                                             validate_manifest)
    toks = gpt_tokens(cfg, GPT_BATCH, 2 * steps, seed=31)
    peak = {}
    # ---- arm A
    torch.cuda.reset_peak_memory_stats()
    main, start, loss, _ = build_gpt_state(cfg)
    sa = Scope()
    Executor("cuda").run(start, scope=sa)
    exe = Executor("cuda")
    la = []
    for w in range(2):
        out, = exe.run_steps(steps, main,
                             feed={"tokens": toks[w * steps:(w + 1) * steps]},
                             fetch_list=[loss], scope=sa)
        la += [float(x) for x in out]
    peak["straight"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del exe
    release(torch)
    # ---- arm B, first half
    torch.cuda.reset_peak_memory_stats()
    sb = Scope()
    Executor("cuda").run(start, scope=sb)
    exe = Executor("cuda")
    out, = exe.run_steps(steps, main, feed={"tokens": toks[:steps]},
                         fetch_list=[loss], scope=sb)
    lb = [float(x) for x in out]
    torch.cuda.synchronize()
    mgr = CheckpointManager(workdir, max_keep=1)
    t_save = _trace.now_us()
    t0 = time.perf_counter()
    path = mgr.save(steps, program=main, scope=sb)
    save_ms = (time.perf_counter() - t0) * 1e3
    save_spans = span_ms(_trace, t_save)
    n_bytes = os.path.getsize(os.path.join(path, "params.npz"))
    t0 = time.perf_counter()
    ok = validate_manifest(path) is not None
    validate_ms = (time.perf_counter() - t0) * 1e3
    del exe, sb, main, start, loss
    release(torch)
    peak["first_half"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # ---- arm B, resumed: a rebuilt program, a fresh executor and scope
    torch.cuda.reset_peak_memory_stats()
    main, start, loss, _ = build_gpt_state(cfg)
    exe, sc = Executor("cuda"), Scope()
    exe.run(start, scope=sc)
    torch.cuda.synchronize()
    t_restore = _trace.now_us()
    t0 = time.perf_counter()
    step = mgr.restore_latest(program=main, scope=sc, executor=exe)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    restore_spans = span_ms(_trace, t_restore)
    out, = exe.run_steps(steps, main, feed={"tokens": toks[steps:]},
                         fetch_list=[loss], scope=sc)
    lb += [float(x) for x in out]
    peak["resumed"] = torch.cuda.max_memory_allocated() / 2 ** 30
    names, diffs = persistable_diffs(torch, main, sa, sc)
    ctr = (sa.find("__rng_state__"), sc.find("__rng_state__"))
    log(f"resume gate: straight {la}, resumed {lb}; {len(diffs)} of "
        f"{len(names)} persistables differ {dict(list(diffs.items())[:5])}; "
        f"run-seed counters {ctr}; checkpoint {n_bytes} bytes, save "
        f"{save_ms:.0f} ms {save_spans}, validate {validate_ms:.0f} ms, "
        f"restore {restore_ms:.0f} ms {restore_spans}; peaks {peak} GiB; "
        f"resumed stats {exe.stats}")
    if not ok or step != steps:
        fail(f"resume gate: manifest valid {ok}, restored step {step}")
    if la != lb or diffs or ctr[0] != ctr[1]:
        fail(f"resume gate: resumed != straight: losses {lb} vs {la}, "
             f"persistables differing {diffs}, counters {ctr}")
    # the resumed executor ran the startup program (one eager step) and
    # then only replays
    if exe.stats["captures"] != 1 or exe.stats["eager_steps"] != 1 \
            or exe.stats["graph_replays"] != steps:
        fail(f"resume gate: resumed executor stats {exe.stats}")
    row = {"steps": 2 * steps, "losses_straight": la, "losses_resumed": lb,
           "bit_identical": True, "persistables_compared": len(names),
           "checkpoint_bytes": n_bytes, "save_ms": save_ms,
           "save_spans_ms": save_spans, "validate_ms": validate_ms,
           "restore_ms": restore_ms, "restore_spans_ms": restore_spans,
           "save_gb_per_s": n_bytes / 1e9 / (save_ms / 1e3),
           "restore_gb_per_s": n_bytes / 1e9 / (restore_ms / 1e3),
           "peak_memory_gib": peak,
           "save_covers": "CheckpointManager.save(program, scope): "
                          "ckpt.collect (device to host, ZeRO buckets "
                          "split), ckpt.save (npz write, fsync; "
                          "ckpt.manifest: sha256), ckpt.publish (rename, "
                          "prune)",
           "restore_covers": "CheckpointManager.restore_latest: "
                             "ckpt.validate (sha256), ckpt.read (npz), "
                             "ckpt.apply (buckets packed on the host, "
                             "copy_ into the scope's tensors)",
           "validate_covers": "validate_manifest once more, alone"}
    del main, start, sa, sc, exe
    release(torch)
    return row


def rollback_gate(torch, cfg, workdir, poison=5, total=9):
    """Snapshots every 2 steps (SnapshotManager: the copy on a side stream
    into pinned memory); NaN written into one row of `wte` before step
    `poison`; TrainingGuard rolls back and skips that batch. Steps are
    run_steps(1) replays. The losses after the skip and the final
    fingerprint == a run that never saw the batch, bit for bit; one capture
    per run (the restore writes in place)."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.resilience import (SnapshotManager, TrainingGuard,
                                             fingerprint)
    toks = gpt_tokens(cfg, GPT_BATCH, total, seed=41)
    main, start, loss, _ = build_gpt_state(cfg)
    runs = {}
    for label in ("rollback", "never_saw_it"):
        scope = Scope()
        Executor("cuda").run(start, scope=scope)
        exe = Executor("cuda")
        mgr = SnapshotManager(interval=2, root=os.path.join(workdir, label),
                              rank=0, world=1)
        guard = TrainingGuard(mgr, program=main, scope=scope, budget=1)
        metrics.reset("integrity.rollbacks")
        losses = {}
        sched = guard.steps(total, start=1) if label == "rollback" \
            else (s for s in range(1, total) if s != poison)
        t0 = time.perf_counter()
        for s in sched:
            if label == "rollback" and s == poison \
                    and poison not in guard.skip:
                with torch.no_grad():
                    scope.find("wte")[7].fill_(float("nan"))
            out, = exe.run_steps(1, main, feed={"tokens": toks[s][None]},
                                 fetch_list=[loss], scope=scope)
            lv = float(out[0])
            if not guard.observe(s, lv):
                losses[s] = lv
                mgr.maybe_capture(main, scope, s)
        mgr.wait()
        wall_s = time.perf_counter() - t0
        fp = fingerprint(main, scope)
        runs[label] = dict(losses=losses, fingerprint=fp,
                           rollbacks=guard.rollbacks, skip=sorted(guard.skip),
                           captures=exe.stats["captures"], wall_s=wall_s,
                           metric_rollbacks=metrics.get(
                               "integrity.rollbacks"))
        mgr.close()
        del scope, exe, mgr, guard
        release(torch)
    a, b = runs["rollback"], runs["never_saw_it"]
    after_a = {s: v for s, v in a["losses"].items() if s > poison}
    after_b = {s: v for s, v in b["losses"].items() if s > poison}
    log(f"rollback gate: rollback run {a}, oracle {b}")
    if a["rollbacks"] != 1 or a["skip"] != [poison] \
            or a["metric_rollbacks"] != 1:
        fail(f"rollback gate: rollbacks {a['rollbacks']}, skip {a['skip']}")
    if after_a != after_b or a["fingerprint"] != b["fingerprint"] \
            or not after_a:
        fail(f"rollback gate: rollback != skip: {after_a} vs {after_b}, "
             f"fingerprints {a['fingerprint']} vs {b['fingerprint']}")
    if a["captures"] != 1 or b["captures"] != 1:
        fail(f"rollback gate: captures {a['captures']}, {b['captures']}")
    del main, start
    release(torch)
    return {"poison_step": poison, "snapshot_every": 2,
            "losses_after_skip": after_a, "losses_oracle": after_b,
            "fingerprint": a["fingerprint"], "bit_identical": True,
            "rollbacks": a["rollbacks"], "captures_per_run": 1,
            "wall_s": {"rollback": a["wall_s"], "oracle": b["wall_s"]}}


def snapshot_cost(torch, cfg, reps=2):
    """One executor (one graph pool), two programs on two scopes: the
    static schedule and a constant LR (1e-4), both AdamW + clip at stage 1,
    one batch fed to every step. Windows of run_steps(STATE_WINDOW), each
    timed to the end of its device work (a synchronize, which also waits
    for its snapshot's copy), in the order const, sched, sched+snap,
    sched+snap, sched, const, `reps` times: FLAGS_snapshot_steps
    STATE_WINDOW on the "+snap" windows, 0 on the others. Step ms p50 per
    arm, the snapshot's copy (device to pinned host) and worker times and
    the skips."""
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.observability import metrics
    tokens = gpt_tokens(cfg, GPT_BATCH, 1, seed=0)[0]
    progs, scopes = {}, {}
    for name, lr in (("const", 1e-4), ("sched", "schedule")):
        main, start, loss, _ = build_gpt_state(cfg, lr=lr)
        scopes[name] = Scope()
        Executor("cuda").run(start, scope=scopes[name])
        progs[name] = (main, loss)
    exe = Executor("cuda")
    torch.cuda.reset_peak_memory_stats()

    def window(name, snap):
        main, loss = progs[name]
        set_flags({"FLAGS_snapshot_steps": STATE_WINDOW if snap else 0})
        t0 = time.perf_counter()
        out, = exe.run_steps(STATE_WINDOW, main, feed={"tokens": tokens},
                             fetch_list=[loss], scope=scopes[name])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / STATE_WINDOW
        if exe.snapshots is not None:
            exe.snapshots.wait()
        return ms, [float(x) for x in out]

    try:
        # captures, then both pinned buffer sets allocated
        window("const", False)
        window("sched", False)
        window("sched", True)
        window("sched", True)
        metrics.reset()
        arms = {"const": [], "sched": [], "sched_snapshot": []}
        losses = []
        order = (("const", False), ("sched", False), ("sched", True),
                 ("sched", True), ("sched", False), ("const", False))
        for _ in range(reps):
            for name, snap in order:
                ms, out = window(name, snap)
                arms[name + ("_snapshot" if snap else "")].append(ms)
                losses += out
        snap = metrics.snapshot()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        stats = dict(exe.stats)
    finally:
        set_flags({"FLAGS_snapshot_steps": 0})
        exe.close()
    p50 = {k: float(np.median(v)) for k, v in arms.items()}

    def hist(name):
        h = snap.get(name)
        return None if h is None else {k: h[k] for k in
                                       ("count", "p50", "max")}

    row = {"window": STATE_WINDOW, "windows_per_arm": 2 * reps,
           "step_ms": arms, "step_ms_p50": p50,
           "schedule_vs_constant": p50["sched"] / p50["const"],
           "snapshot_cost_ms_per_step": p50["sched_snapshot"]
           - p50["sched"],
           "snapshots": snap.get("resilience.snapshots", {}).get("value",
                                                                 0.0),
           "snapshot_skips": snap.get("resilience.snapshot_skips",
                                      {}).get("value", 0.0),
           "snapshot_copy_ms": hist("resilience.snapshot_copy_ms"),
           "snapshot_worker_ms": hist("resilience.snapshot_ms"),
           "snapshot_host_ms": hist("resilience.snapshot_host_ms"),
           "peak_memory_gib": peak, "executor_stats": stats,
           "timing": "windows of run_steps(10), each to a synchronize after "
                     "it (its snapshot's copy included); p50 of the "
                     "per-step means"}
    log(f"snapshot cost: {row}")
    if not all(np.isfinite(losses)):
        fail("snapshot cost: non-finite loss")
    if stats["captures"] != 2 or stats["eager_steps"]:
        fail(f"snapshot cost: executor stats {stats}")
    if row["snapshots"] != 2 * reps:
        fail(f"snapshot cost: {row['snapshots']} snapshots in "
             f"{2 * reps} snapshot windows")
    del progs, scopes, exe
    release(torch)
    return row


def train_gpt_resilient(torch, fa, zk, card):
    """Phase 8: GPTConfig() at S 512, batch 32, fleet AMP bf16,
    ZeRO stage 1, AdamW + GradientClipByGlobalNorm(1.0), dropout 0.1, the
    LR linear_lr_warmup(cosine_decay(...)) built in the program."""
    import shutil
    cfg = gpt_config()
    workdir = os.path.join(HERE, ".chip_scratch", f"state_{os.getpid()}")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        t0 = time.perf_counter()
        out = {"config": "GPTConfig() (GPT-2 small, dropout 0.1), seq 512, "
                         "batch 32, fleet AMP bf16, ZeRO stage 1, AdamW "
                         "(weight decay 0.01) + GradientClipByGlobalNorm(1.0),"
                         " LR linear_lr_warmup(cosine_decay(1e-4, 1, 8), 1, "
                         "1e-5, 1e-4) in the program, random weights",
               "card": card}
        out["schedule_capture"] = schedule_capture_gate(torch, fa, zk, cfg)
        out["host_scheduler"] = host_scheduler_gate(torch, cfg)
        small, small_launches = schedule_sgd_momentum_gate(torch, zk)
        out["schedule_sgd_momentum_small"] = small
        out["resume"] = resume_gate(torch, cfg,
                                    os.path.join(workdir, "ckpt"))
        out["rollback"] = rollback_gate(torch, cfg, workdir)
        out["snapshot_cost"] = snapshot_cost(torch, cfg)
        out["phase_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = dict(small_launches,
                    zero_adam=out["schedule_capture"]
                    ["launches_incl_warmup"]["zero_adam"])
    return out, launches


# ---------------------------------------------------------------------------
# GPT-2 small trained from data
# ---------------------------------------------------------------------------

DATA_TOKENS = 1 << 24      # the token file: 16,777,216 int32 tokens, 64 MiB
DATA_BATCHES = 40          # an arm's epoch: 4 windows of run_steps(10)
DATA_WORKERS = 4           # DataLoader workers; InMemoryDataset threads
DATA_SEED = 11


class TokenWindows:
    """A map-style dataset over a token file of int32 tokens: sample i is
    the window of `seq` tokens at offset i * seq, as an int64 row. It holds
    only the path: DataLoader workers (forkserver processes) unpickle it by
    reference, from this script's top level, and map the file
    themselves."""

    def __init__(self, path, seq):
        self.path, self.seq = path, seq
        self._tokens = None

    def __getstate__(self):
        return {"path": self.path, "seq": self.seq}

    def __setstate__(self, state):
        self.__init__(state["path"], state["seq"])

    def __len__(self):
        return os.path.getsize(self.path) // 4 // self.seq

    def __getitem__(self, i):
        if self._tokens is None:
            self._tokens = np.memmap(self.path, dtype=np.int32, mode="r")
        row = self._tokens[i * self.seq:(i + 1) * self.seq]
        return (row.astype(np.int64),)


def write_data(cfg, workdir):
    """The token file (numpy seed DATA_SEED) and DATA_WORKERS MultiSlot
    text files holding DATA_BATCHES batches of its windows (one `tokens`
    slot of GPT_SEQ ids a line), drawn without replacement."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(DATA_SEED)
    tokens = rng.randint(0, cfg.vocab_size, DATA_TOKENS, dtype=np.int32)
    path = os.path.join(workdir, "tokens.bin")
    tokens.tofile(path)
    windows = tokens.reshape(-1, GPT_SEQ)
    pick = rng.choice(len(windows), DATA_BATCHES * GPT_BATCH, replace=False)
    files = []
    for f, part in enumerate(np.array_split(pick, DATA_WORKERS)):
        p = os.path.join(workdir, f"part-{f:02d}")
        with open(p, "w") as fh:
            for w in part:
                fh.write(f"{GPT_SEQ} " + " ".join(map(str, windows[w]))
                         + "\n")
        files.append(p)
    return path, files, time.perf_counter() - t0


def data_loader(dataset, tokens_var, seed, n_batches, workers=DATA_WORKERS):
    """DataLoader(batch 32, a seeded RandomSampler of n_batches batches
    over the whole file, `workers` processes) yielding feed dicts."""
    from paddle_tpu_torch import io
    sampler = io.RandomSampler(dataset, num_samples=n_batches * GPT_BATCH,
                               generator=seed)
    return io.DataLoader(
        dataset, feed_list=[tokens_var], return_list=False,
        batch_sampler=io.BatchSampler(sampler=sampler,
                                      batch_size=GPT_BATCH),
        num_workers=workers)


class WindowRecorder:
    """Stands in for `exe.run_steps` during a train_from_dataset arm: each
    window is run, synchronised and its end time, host feed and device
    losses kept. With `profile_window` w, torch.profiler runs from the end
    of window w - 1 to the end of window w (the wait for the batch
    included)."""

    def __init__(self, torch, exe, profile_window=None):
        self.torch, self.exe, self.orig = torch, exe, exe.run_steps
        self.ends, self.feeds, self.losses, self.calls = [], [], [], []
        self.profile_window, self.profile, self._prof = \
            profile_window, None, None
        exe.run_steps = self

    def __call__(self, k, program=None, feed=None, **kw):
        t0 = time.perf_counter()
        out = self.orig(k, program, feed=feed, **kw)
        self.calls.append(time.perf_counter() - t0)
        self.torch.cuda.synchronize()
        self.ends.append(time.perf_counter())
        self.feeds.append(feed)
        self.losses.append(out[0])
        w = len(self.ends)
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self.profile = profile_summary(self._prof,
                                           self.ends[-1] - self.ends[-2],
                                           top=6)
            self._prof = None
        elif self.profile_window is not None and w == self.profile_window - 1:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return out

    def remove(self):
        del self.exe.run_steps

    def step_ms(self, k):
        """Per-step ms of each window after the first: the wall from the
        end of one window to the end of the next, over k."""
        return [(b - a) * 1e3 / k for a, b in zip(self.ends, self.ends[1:])]


def state_restore(torch, scope, saved):
    """Put a `scope_copy` back into `scope` in place (the captured step
    stays bound), the run-seed counter included."""
    for n in saved.local_names():
        v = saved.find(n)
        if isinstance(v, torch.Tensor):
            scope.find(n).copy_(v)
        else:
            scope.set(n, v)


def two_thread_captures():
    """tests/test_torch_capture_lock.py's card check, run here: with a dead
    executor cycle pending and the collector at every allocation, one
    thread captures a training step while another starts a serving engine
    that captures its window; both succeed, equal to their references,
    and nothing is collected inside a capture."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "capture_lock_check",
        os.path.join(HERE, "tests", "test_torch_capture_lock.py"))
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    try:
        out = check.run_two_thread_captures()
    except AssertionError as e:
        fail(f"two-thread capture check: {e!r}")
    log(f"two threads (training capture + serving capture): {out}")
    return out


def train_gpt_from_data(torch, fa, card):
    """Phase 9: GPT-2 small trained from data, the phase-8 program (stage
    1, AdamW + clip, the static schedule) on one executor and scope, one
    capture for every arm."""
    import shutil
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.dataset import DatasetFactory
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.framework import executor as executor_mod
    from paddle_tpu_torch.resilience.faults import clear_plan, install_plan
    cfg = gpt_config()
    workdir = os.path.join(HERE, ".chip_scratch", f"data_{os.getpid()}")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t_phase = time.perf_counter()
    try:
        token_path, files, write_s = write_data(cfg, workdir)
        log(f"data: {DATA_TOKENS} tokens ({os.path.getsize(token_path)} "
            f"bytes) and {len(files)} MultiSlot files "
            f"({sum(os.path.getsize(f) for f in files)} bytes) written in "
            f"{write_s:.1f} s")
        main, start, loss, _ = build_gpt_state(cfg)
        tokens_var = main.global_block().var("tokens")
        scope = Scope()
        Executor("cuda").run(start, scope=scope)
        exe = Executor("cuda")
        windows = TokenWindows(token_path, GPT_SEQ)
        one = {"tokens": gpt_tokens(cfg, GPT_BATCH, 1, seed=0)[0]}

        def one_batch(n):
            ms = []
            for _ in range(n):
                t0 = time.perf_counter()
                exe.run_steps(GPT_WINDOW, main, feed=one, fetch_list=[loss],
                              scope=scope, return_numpy=False)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3 / GPT_WINDOW)
            return ms

        t0 = time.perf_counter()
        one_batch(1)                                  # the capture
        capture_s = time.perf_counter() - t0
        ms_one = one_batch(3)
        # one window's staging with the card idle and no other thread:
        # coercion, the pinned copy and the copy to the card
        stacked = {"tokens": np.stack([one["tokens"]] * GPT_WINDOW)}
        idle = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.stage(stacked, program=main, k=GPT_WINDOW, tag=stacked)
            torch.cuda.synchronize()
            idle.append((time.perf_counter() - t0) * 1e3 / GPT_WINDOW)
            exe._purge_staged(stacked)
        fa.reset_launches()
        replays0 = exe.stats["graph_replays"]
        eager0 = exe.stats["eager_steps"]

        def arm(kind, epoch_source, profile_window=None, gate=False):
            """One train_from_dataset epoch of `epoch_source()`, recorded;
            with `gate`, the state is put back and the recorded windows
            run again through run_steps fed the same batches stacked on
            the host: the losses must be equal bit for bit."""
            saved = scope_copy(torch, scope) if gate else None
            h2d0 = monitor.stat_get("executor.h2d_ms")
            rec = WindowRecorder(torch, exe, profile_window)
            t0 = time.perf_counter()
            try:
                last = exe.train_from_dataset(
                    main, epoch_source(), scope=scope, fetch_list=[loss],
                    steps_per_loop=GPT_WINDOW)
            finally:
                rec.remove()
            wall = time.perf_counter() - t0
            n_steps = GPT_WINDOW * len(rec.ends)
            row = {"kind": kind, "windows": len(rec.ends),
                   "step_ms": rec.step_ms(GPT_WINDOW),
                   "first_window_s": rec.ends[0] - t0, "epoch_s": wall,
                   "run_steps_call_s": rec.calls,
                   "h2d_ms_per_step": (monitor.stat_get("executor.h2d_ms")
                                       - h2d0) / n_steps,
                   "last_loss": float(last[0])}
            losses = torch.cat(rec.losses)
            if not torch.isfinite(losses).all():
                fail(f"data arm {kind}: non-finite loss")
            if len(rec.ends) != DATA_BATCHES // GPT_WINDOW:
                fail(f"data arm {kind}: {len(rec.ends)} windows of "
                     f"{GPT_WINDOW}, want {DATA_BATCHES // GPT_WINDOW}")
            if rec.profile is not None:
                row["profile_one_window"] = rec.profile
            if gate:
                after = scope_copy(torch, scope)
                state_restore(torch, scope, saved)
                again = torch.cat([exe.run_steps(
                    GPT_WINDOW, main, feed={"tokens": f["tokens"].copy()},
                    fetch_list=[loss], scope=scope, return_numpy=False)[0]
                    for f in rec.feeds])
                if not torch.equal(again, losses):
                    fail(f"data arm {kind}: losses != run_steps fed the "
                         f"same batches stacked on the host (max diff "
                         f"{(again - losses).abs().max().item()})")
                names, diffs = persistable_diffs(torch, main, after, scope)
                if diffs:
                    fail(f"data arm {kind}: persistables differ from the "
                         f"host-stacked run's: {diffs}")
                del after, saved
                row["equal_to_host_stacked_run_steps"] = True
                row["persistables_compared"] = len(names)
            log(f"data arm {kind}: step ms {row['step_ms']}, first window "
                f"{row['first_window_s']:.2f} s, h2d "
                f"{row['h2d_ms_per_step']:.4f} ms/step, last loss "
                f"{row['last_loss']:.4f}")
            return row, rec

        loader = data_loader(windows, tokens_var, DATA_SEED, DATA_BATCHES)
        ds = DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_batch_size(GPT_BATCH)
        ds.set_thread(DATA_WORKERS)
        ds.set_use_var([tokens_var])
        ds.set_filelist(files)
        t0 = time.perf_counter()
        native = ds.plane.native         # g++ builds the plane here
        build_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ds.load_into_memory()
        load_ms = (time.perf_counter() - t0) * 1e3
        if not native:
            fail("arm M: the data plane is the Python one, not the native")
        if ds.get_memory_data_size() != DATA_BATCHES * GPT_BATCH:
            fail(f"arm M: {ds.get_memory_data_size()} samples in memory")

        def shuffled():
            t0 = time.perf_counter()
            ds.local_shuffle()
            shuffle_ms.append((time.perf_counter() - t0) * 1e3)
            return ds

        shuffle_ms = []
        # ABBA: L, M, M, L; the first of each gated
        l1, rec_l1 = arm("L", lambda: loader, gate=True)
        m1, _ = arm("M", shuffled, gate=True)
        m2, _ = arm("M", shuffled)
        l2, _ = arm("L", lambda: loader, profile_window=3)
        ms_one += one_batch(3)
        replays = exe.stats["graph_replays"] - replays0
        per_step = {n: fa.launches[n] / max(replays, 1)
                    for n in fa.KERNEL_NAMES}
        eager_in_windows = exe.stats["eager_steps"] - eager0
        if exe.stats["captures"] != 1 or eager_in_windows:
            fail(f"data arms: {exe.stats['captures']} captures, "
                 f"{eager_in_windows} eager steps (want 1 and 0)")
        if any(v != cfg.num_layers for v in per_step.values()):
            fail(f"data arms: B1-B3 launches a step {per_step}, want "
                 f"{cfg.num_layers}")

        # resume: the loader rebuilt at the same seed (epoch 0), advanced
        # past the 20 batches a checkpoint after two windows covers
        resumed = [b["tokens"] for b in data_loader(
            windows, tokens_var, DATA_SEED, DATA_BATCHES)]
        want = rec_l1.feeds[2]["tokens"][0]
        if not np.array_equal(resumed[2 * GPT_WINDOW], want):
            fail("resume: the rebuilt loader's batch 20 != arm L's")

        # a worker killed at its 3rd batch (one worker, 4 batches)
        def kill_run(budget):
            set_flags({"FLAGS_dataloader_max_respawns": budget})
            install_plan("dataloader.worker:delay=0.25:at=3;"
                         "dataloader.worker:kill:at=3")
            try:
                with warnings.catch_warnings(record=True):
                    warnings.simplefilter("always")
                    return [b["tokens"] for b in data_loader(
                        windows, tokens_var, DATA_SEED + 1, 4, workers=1)]
            finally:
                clear_plan()
                set_flags({"FLAGS_dataloader_max_respawns": 0})

        clean = [b["tokens"] for b in data_loader(
            windows, tokens_var, DATA_SEED + 1, 4, workers=0)]
        r0 = monitor.stat_get("resilience.worker_respawns")
        killed = kill_run(1)
        respawns = monitor.stat_get("resilience.worker_respawns") - r0
        same = sorted(b.tobytes() for b in killed) \
            == sorted(b.tobytes() for b in clean)
        if respawns != 1 or not same:
            fail(f"worker kill: {respawns} respawns, same batches {same}")
        try:
            kill_run(0)
            fail("worker kill at the default budget 0 did not fail")
        except RuntimeError as e:
            fail_fast = str(e)
        if "exitcode 43" not in fail_fast:
            fail(f"worker kill at budget 0: {fail_fast!r} does not name "
                 f"exit code 43")

        # arm P: prefetch into Executor.run (eager steps), 3 batches
        coerced, taken = [], []
        real_coerce = executor_mod._coerce_feed_value
        real_take = exe._take_staged

        def take(*a):
            out = real_take(*a)
            taken.append(out is not None)
            return out

        executor_mod._coerce_feed_value = \
            lambda *a: coerced.append(a[1]) or real_coerce(*a)
        exe._take_staged = take
        h2d0 = monitor.stat_get("executor.h2d_ms")
        try:
            it = data_loader(windows, tokens_var, DATA_SEED + 2, 3,
                             workers=2).prefetch(exe, depth=2, program=main)
            p_losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                      scope=scope)[0]) for feed in it]
            it.close()
        finally:
            executor_mod._coerce_feed_value = real_coerce
            del exe._take_staged
        prefetch = {"steps": len(p_losses), "staged_feeds_taken": sum(taken),
                    "feeds_coerced_at_the_run": len(coerced),
                    "left_staged": len(exe._staged),
                    "h2d_ms_per_step": (monitor.stat_get("executor.h2d_ms")
                                        - h2d0) / max(len(p_losses), 1),
                    "losses": p_losses}
        if (len(p_losses), sum(taken), len(coerced), len(exe._staged)) \
                != (3, 3, 0, 0) or not all(np.isfinite(p_losses)):
            fail(f"arm P: {prefetch}")
        log(f"arm P (prefetch into run): {prefetch}")
        stats = dict(exe.stats)
        del exe, scope, main, start
        release(torch)

        two_threads = two_thread_captures()
        release(torch)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    p50 = {"one_batch": float(np.median(ms_one)),
           "L": float(np.median(l1["step_ms"] + l2["step_ms"])),
           "M": float(np.median(m1["step_ms"] + m2["step_ms"]))}
    out = {
        "config": "the training_state phase's program (GPTConfig(), S 512, "
                  "batch 32, fleet AMP bf16, ZeRO stage 1, AdamW + clip "
                  "1.0, the static LR schedule, dropout 0.1) on one "
                  "executor and scope; arm L: a memory-mapped token file "
                  "through DataLoader(4 workers, seeded RandomSampler) into"
                  " train_from_dataset(steps_per_loop=10); arm M: an "
                  "InMemoryDataset (4 threads, native plane) over MultiSlot"
                  " files of the same file's windows; 40 batches an epoch",
        "card": card,
        "token_file": {"tokens": DATA_TOKENS,
                       "bytes": DATA_TOKENS * 4, "window": GPT_SEQ},
        "multislot": {"files": DATA_WORKERS,
                      "samples": DATA_BATCHES * GPT_BATCH,
                      "native_plane": True, "build_ms": build_ms,
                      "load_ms": load_ms,
                      "shuffle_ms": shuffle_ms},
        "abba": ["L", "M", "M", "L"],
        "step_ms_p50": p50,
        "vs_one_batch": {k: p50[k] / p50["one_batch"] for k in ("L", "M")},
        "one_batch_step_ms": ms_one, "one_batch_capture_s": capture_s,
        "arms": [l1, m1, m2, l2],
        "stage_idle_ms_per_step": idle,
        "h2d_ms_per_step": {"L": (l1["h2d_ms_per_step"]
                                  + l2["h2d_ms_per_step"]) / 2,
                            "M": (m1["h2d_ms_per_step"]
                                  + m2["h2d_ms_per_step"]) / 2},
        "device_busy_share_one_window_L": l2.get(
            "profile_one_window", {}).get("device_busy_share",
                                          "not measured"),
        "captures": stats["captures"],
        "eager_steps_in_windows": eager_in_windows,
        "flash_launches_per_step": per_step,
        "resume_next_batch_equal": True,
        "worker_respawns": respawns, "worker_kill_same_batches": same,
        "default_budget_error": fail_fast,
        "prefetch": prefetch, "two_thread_capture": two_threads,
        "phase_s": time.perf_counter() - t_phase,
        "timing": "each window of run_steps(10) synchronised at its end; "
                  "a step is the wall from one window's end to the next's "
                  "over 10 (the wait for the next window's batches "
                  "included); 3 windows an epoch after its first"}
    log(f"data path: step p50 {p50}, vs one batch {out['vs_one_batch']}, "
        f"h2d {out['h2d_ms_per_step']} ms/step, busy share "
        f"{out['device_busy_share_one_window_L']}, load {load_ms:.1f} ms, "
        f"shuffle {shuffle_ms} ms, respawns {respawns}")
    return out


def serve_gpt2(torch, serving, gpt_decode, kernel_mod, metrics, rows,
               card):
    """GPT-2 small (GPTConfig(), weights from numpy seed 0) through the
    port's DecodeEngine; every CUDA engine replays captured windows. Sets
    the B4/B5 rows' launches and returns the {"serving"} line."""
    from paddle_tpu_torch.models.gpt import GPTConfig
    cfg = GPTConfig()
    t0 = time.perf_counter()
    arrays = gpt2_small_arrays(cfg, seed=0)
    log(f"GPT-2 small weights (numpy seed 0) in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    R = serving.Request
    out = {"config": "GPT-2 small (GPTConfig()), random weights seed 0, "
                     "block 16, 8 slots unless said",
           "card": card}

    # (b) f32, TF32 off: greedy tokens == dense generate
    p32 = gpt_decode.params_from_numpy(cfg, arrays, device="cuda")
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 17, 33, 50)]
    f32_kw = dict(params=p32, model_config=cfg, device="cuda", max_slots=4,
                  block_size=16, num_blocks=64, max_len=128, window=8)
    eng = serving.DecodeEngine(**f32_kw)
    try:
        kernel_mod.reset_launches()
        comps, _ = serve_on(torch, eng,
                            [R(prompt=p, max_new_tokens=16) for p in prompts])
        rows["paged_decode_f32"]["launches"] = \
            kernel_mod.launches["paged_decode_f32"]
        captured_only(eng.stats(), "f32 engine")
    finally:
        eng.stop()
    for p, c in zip(prompts, comps):
        dense = gpt_decode.generate(p32, cfg, p[None], 16, device="cuda")
        if dense[0, len(p):].tolist() != c.tokens:
            fail(f"f32 paged tokens {c.tokens} != dense generate "
                 f"{dense[0, len(p):].tolist()} (prompt of {len(p)})")
    log(f"f32 engine (captured window): greedy tokens == dense generate for "
        f"{len(prompts)} prompts; paged_decode_f32 launches "
        f"{rows['paged_decode_f32']['launches']}")
    del p32

    # (a) bf16, 8 concurrent requests: the captured window, then the eager
    # body on the same requests
    p16 = gpt_decode.params_from_numpy(cfg, arrays, dtype="bfloat16",
                                       device="cuda")
    lens = np.linspace(17, 200, 8).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]

    def bf16_requests():
        reqs = [R(prompt=p, max_new_tokens=32) for p in prompts]
        reqs[3] = R(prompt=prompts[3], max_new_tokens=32, temperature=0.8,
                    top_k=40, seed=1234)
        return reqs

    bf16_kw = dict(params=p16, model_config=cfg, device="cuda",
                   dtype="bfloat16", max_slots=8, block_size=16,
                   num_blocks=160, max_len=256, window=8)
    arm = dict(metrics=metrics, kernel_mod=kernel_mod)
    eng = serving.DecodeEngine(**bf16_kw)
    try:
        tokens, out["captured"] = serving_arm(torch, eng, bf16_requests,
                                              **arm)
        rows["paged_decode_bf16"]["launches"] = \
            out["captured"]["b4_launches"]["paged_decode_bf16"]
        captured_only(eng.stats(), "bf16 engine")
        seq, _ = serve_on(torch, eng, bf16_requests(), sequential=True)
    finally:
        eng.stop()
    if [c.tokens for c in seq] != tokens:
        fail("bf16: continuous batching tokens != sequential tokens")
    eager = serving.DecodeEngine(**bf16_kw)
    eager._graph = lambda key, body, host: None   # the body, no graph
    try:
        eager_tokens, out["eager"] = serving_arm(torch, eager,
                                                 bf16_requests, **arm)
    finally:
        eager.stop()
    if eager_tokens != tokens:
        fail("bf16: captured window tokens != eager window tokens")
    out.update(requests=8, prompt_tokens=[int(n) for n in lens],
               new_tokens_each=32)
    log(f"bf16 engine: captured == eager tokens, continuous == sequential; "
        f"captured {out['captured']['tokens_per_s']:.1f} tok/s, eager "
        f"{out['eager']['tokens_per_s']:.1f} tok/s")

    # (c) prefix cache: a 96-token system prompt, distinct 8-72-token
    # tails, 32 new tokens each; the warm-up publishes the system prompt
    # under other tails
    sysp = rng.integers(0, cfg.vocab_size, 96)
    tail_lens = np.linspace(8, 72, 8).astype(int)
    tails = [rng.integers(0, cfg.vocab_size, n) for n in tail_lens]
    warm_tails = [rng.integers(0, cfg.vocab_size, n) for n in tail_lens]

    def prefix_requests(ts=tails):
        return [R(prompt=np.concatenate([sysp, t]), max_new_tokens=32)
                for t in ts]

    out["prefix_cache"] = {"system_prompt": 96,
                           "tails": [int(n) for n in tail_lens]}
    got = {}
    for on in (False, True):
        eng = serving.DecodeEngine(**dict(bf16_kw, prefix_cache=on))
        try:
            got[on], row = serving_arm(
                torch, eng, prefix_requests, profile=False,
                warm=lambda: prefix_requests(warm_tails), **arm)
            captured_only(eng.stats(), f"prefix cache {on}")
        finally:
            eng.stop()
        out["prefix_cache"]["on" if on else "off"] = row
    if got[True] != got[False]:
        fail("prefix cache: cache-on tokens != cache-off tokens")
    hits = out["prefix_cache"]["on"]["delta"]["prefix_cache_hits"]
    if hits != 8:
        fail(f"prefix cache: {hits} hits of 8 in the measured run")
    log(f"prefix cache: cache-on == cache-off tokens; hits {hits}, "
        f"prefill tokens saved "
        f"{out['prefix_cache']['on']['delta']['prefill_tokens_saved']}; "
        f"TTFT p50 "
        f"{out['prefix_cache']['on']['ttft_ms_p50']:.2f} on / "
        f"{out['prefix_cache']['off']['ttft_ms_p50']:.2f} ms off")

    # (d) speculative decoding, int8 draft of the same checkpoint, gamma 4,
    # on (a)'s requests: spec-off is (a)'s captured arm
    eng = serving.DecodeEngine(**dict(bf16_kw, spec=serving.SpecConfig(
        tokens=4, draft_dtype="int8")))
    try:
        spec_tokens, row = serving_arm(
            torch, eng, bf16_requests, stats=lambda: dict(
                eng.stats(), draft_kernel_launches_window=eng.spec.draft
                .stats()["kernel_launches_window"]), **arm)
        captured_only(eng.stats(), "spec target")
        captured_only(eng.spec.draft.stats(), "spec draft")
        armed = eng.spec.armed
    finally:
        eng.stop()
    if spec_tokens != tokens:
        fail("spec: spec-on tokens != spec-off tokens")
    d = row["delta"]
    if not armed or d["spec_degraded"] or not d["spec_rounds"]:
        fail(f"spec: the draft degraded or no round ran ({d})")
    row["spec_accept_rate"] = d["spec_accepted"] / max(d["spec_proposed"],
                                                       1)
    if not (d["kernel_launches_verify"]
            and d["draft_kernel_launches_window"]):
        fail(f"spec: B4 never launched in the verify "
             f"({d['kernel_launches_verify']}) or draft "
             f"({d['draft_kernel_launches_window']}) graphs")
    out["spec"] = row
    log(f"spec: spec-on == spec-off tokens; acceptance "
        f"{row['spec_accept_rate']:.3f} over {d['spec_rounds']} rounds; "
        f"{row['tokens_per_s']:.1f} tok/s (spec-off "
        f"{out['captured']['tokens_per_s']:.1f}); B4 launches verify "
        f"{d['kernel_launches_verify']}, draft "
        f"{d['draft_kernel_launches_window']}")

    # (e) int8 weights (quantized from the f32 checkpoint): the matrices
    # dequantized to bf16, the biases f32, so the activations are f32 and
    # B4 reads the bf16 pool with f32 queries (the <bf16 KV, f32 Q>
    # instance); the (pool, query) dtypes of every wrapper call recorded
    kernel_mod.reset_launches()
    pairs = set()
    wrapper = kernel_mod.fused_paged_attention

    def recording(q, k_pool, *a, **kw):
        pairs.add((str(k_pool.dtype)[6:], str(q.dtype)[6:]))
        return wrapper(q, k_pool, *a, **kw)

    kernel_mod.fused_paged_attention = recording
    try:
        comps, _, st = serve(torch, serving, dict(bf16_kw, params=arrays,
                                                  dtype="int8"),
                             bf16_requests())
    finally:
        kernel_mod.fused_paged_attention = wrapper
    captured_only(st, "int8-weight engine")
    if pairs != {("bfloat16", "float32")}:
        fail(f"int8-weight engine: B4 called with (pool, query) dtypes "
             f"{sorted(pairs)}, want only (bfloat16, float32)")
    rows["paged_decode_bf16_f32q"]["launches"] = \
        kernel_mod.launches["paged_decode_bf16"]
    if [len(c.tokens) for c in comps] != [32] * 8:
        fail(f"int8-weight engine: {[len(c.tokens) for c in comps]} "
             f"tokens")
    out["int8_weights"] = {
        "requests": 8, "b4_launches": dict(kernel_mod.launches),
        "b4_pool_query_dtypes": sorted(pairs),
        "tokens_equal_bf16": sum(a == b for a, b in zip(
            [c.tokens for c in comps], tokens))}
    if not kernel_mod.launches["paged_decode_bf16"]:
        fail("int8-weight engine: B4 never launched")
    log(f"int8-weight engine: 8 requests complete; {out['int8_weights']}")
    del arrays

    # bf16 with int8 KV pools: 2 requests
    kernel_mod.reset_launches()
    comps, _, _ = serve(torch, serving,
                        dict(bf16_kw, kv_dtype="int8", kv_scale=8.0,
                             max_slots=2),
                        [R(prompt=prompts[1], max_new_tokens=16),
                         R(prompt=prompts[6], max_new_tokens=16)])
    rows["paged_decode_int8"]["launches"] = \
        kernel_mod.launches["paged_decode_int8"]
    if [len(c.tokens) for c in comps] != [16, 16]:
        fail(f"int8-KV engine: {[len(c.tokens) for c in comps]} tokens")
    log(f"int8-KV engine: 2 requests complete; paged_decode_int8 launches "
        f"{rows['paged_decode_int8']['launches']}")
    resilience = serve_resilient(torch, serving, kernel_mod, metrics,
                                 dict(bf16_kw, params=p16), bf16_requests,
                                 tokens, out["captured"]["window_ms_p50"],
                                 card)
    del p16
    torch.cuda.empty_cache()
    return out, resilience


def _wait(pred, timeout_s):
    """Poll `pred` every 5 ms for at most `timeout_s`; its last value."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


def serve_resilient(torch, serving, kernel_mod, metrics, engine_kw,
                    make_requests, oracle, window_ms, card):
    """The fault-tolerant tier at GPT-2 small width (bf16): two replicas
    over one weight copy behind a ServingFrontend, each replaying its own
    captured window. Arms, each gated against the single-engine captured
    run's tokens (`oracle`):

    * control: one replica behind its own ServingFrontend, the 8
      requests, timed and profiled as the undisturbed arm is;
    * undisturbed: the 8 requests, timed; again with the window replays
      and the service threads' CPU seconds; once more under the profiler;
    * kill: the same requests under `serving.window:error:at=3`; every
      request completes with the oracle's tokens (failover replay), then
      the dead replica comes back LIVE through the canary (bounded wait);
      a second batch across both replicas, each serving by replays;
    * watchdog: FLAGS_step_deadline_ms at 2 ms, below one window's replay:
      every request fails typed (DeadlineExceeded) with no hang, the
      flight dumps hold `sla_trip` steps and at least one trip's worker
      stack is inside the replay or its `.cpu()`; after the flag is reset both
      replicas resurrect and a batch equals the oracle;
    * drain: 32 requests, then drain(): the in-flight ones equal the
      oracle, the unstarted ones come back.
    Returns the {"resilience"} line."""
    import dataclasses
    import shutil
    import tempfile
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.resilience import clear_plan, install_plan
    R = serving.Request

    def reqs(tag, n=8):
        base = make_requests()
        return [dataclasses.replace(base[i % 8], uid=f"{tag}-{i}")
                for i in range(n)]

    def want(uid):
        return oracle[int(uid.rsplit("-", 1)[1]) % 8]

    def batch(tag, front=None):
        rs = reqs(tag)
        t0 = time.perf_counter()
        comps = (front or fe).generate(rs, timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = [(c.uid, c.state, c.finish_reason) for c in comps
               if not c.ok or c.tokens != want(c.uid)]
        if bad:
            fail(f"resilience {tag}: requests failed or differ from the "
                 f"single-engine run: {bad}")
        return sum(len(c.tokens) for c in comps) / wall

    def where_time_goes(front, tag):
        """A timed batch on `front`: tokens/s, window replays, and each
        service thread's CPU seconds (a blocked `.cpu()` may spin, so CPU
        time bounds host work from above); then one more batch under
        torch.profiler: the card's kernel time summed over every stream."""
        engs = front.engines
        before = [e.stats()["graph_replays"] for e in engs]
        clocks = [time.pthread_getcpuclockid(e._thread.ident)
                  for e in engs]
        cpu0 = [time.clock_gettime(c) for c in clocks]
        t0 = time.perf_counter()
        row = {"tokens_per_s": batch(tag, front)}
        row["wall_s"] = time.perf_counter() - t0
        row["service_thread_cpu_s"] = [
            time.clock_gettime(c) - c0 for c, c0 in zip(clocks, cpu0)]
        row["window_replays"] = sum(e.stats()["graph_replays"] - b
                                    for e, b in zip(engs, before))
        t = {}

        def run():
            t0 = time.perf_counter()
            t["tokens_per_s"] = batch(tag + "-profiled", front)
            return time.perf_counter() - t0
        prof = device_profile(torch, run, top=0)
        row["profiled"] = {k: prof.get(k) for k in (
            "wall_s", "device_busy_s", "device_busy_share",
            "device_launches")}
        row["profiled"]["tokens_per_s"] = t["tokens_per_s"]
        return row

    out = {"config": "GPT-2 small, bf16, 2 replicas of the serving "
                     "phase's bf16 engine, 8 requests a batch",
           "card": card}
    # the control: one replica behind its own ServingFrontend, the same
    # requests, in the same run
    fe = serving.ServingFrontend(serving.replicated_engines(1, **engine_kw))
    try:
        batch("control-warm")
        out["one_replica"] = where_time_goes(fe, "control")
    finally:
        fe.stop()
    del fe
    log(f"resilience, one replica behind ServingFrontend: "
        f"{out['one_replica']}")
    engines = serving.replicated_engines(2, **engine_kw)
    a, b = engines
    unshared = [n for n, t in a.params.items()
                if b.params[n].data_ptr() != t.data_ptr()]
    if unshared or a.cache.k_pool.data_ptr() == b.cache.k_pool.data_ptr():
        fail(f"replicas: weights not shared {unshared}, or one pool")
    out["weights_shared"] = len(a.params)
    dump_dir = tempfile.mkdtemp(prefix="flight-")
    flags.set_flags({"FLAGS_flight_dump_dir": dump_dir})
    fe = serving.ServingFrontend(engines)
    try:
        batch("warm")                   # both replicas capture
        if not all(e.stats()["windows"] for e in engines):
            fail("resilience: a replica served no window in the warm-up")
        metrics.reset()
        out["tokens_per_s_undisturbed"] = batch("undisturbed")
        snap = metrics.snapshot()
        out["undisturbed"] = {k: snap[f"serving.{k}"]["p50"]
                              for k in ("window_ms", "ttft_ms", "tpot_ms")}
        out["two_replicas"] = where_time_goes(fe, "split")
        log(f"resilience, two replicas: {out['two_replicas']}")

        # ---- kill a replica mid-stream -----------------------------------
        metrics.reset()
        f0 = fe.failover_total
        plan = install_plan("serving.window:error:at=3", seed=0)
        out["tokens_per_s_with_kill"] = batch("kill")
        clear_plan()
        # the replica that ran the 3rd window died there; it alone has
        # left LIVE since it was built
        dead = [e for e in engines if len(e.health_history) > 1]
        if sum(r.fired for r in plan.rules) != 1 or len(dead) != 1:
            fail(f"kill arm: {sum(r.fired for r in plan.rules)} faults, "
                 f"{len(dead)} replicas left LIVE")
        victim = dead[0]
        out["failovers"] = fe.failover_total - f0
        if not out["failovers"]:
            fail("kill arm: no request failed over")
        if not _wait(lambda: victim.health == serving.Health.LIVE
                     and victim._dead is None, 60):
            fail(f"kill arm: the killed replica did not come back "
                 f"({victim.health_history}, {victim._dead})")
        snap = metrics.snapshot()
        out.update(
            victim=engines.index(victim),
            victim_health=victim.health_history[-5:],
            kill_to_live_ms=snap["serving.recover_ms"]["max"],
            resurrect_ms=snap["serving.resurrect_ms"]["max"],
            canary_ms=snap["serving.canary_ms"]["max"])
        log(f"resilience kill arm: {out['failovers']} failovers, tokens "
            f"== single engine; replica {out['victim']} "
            f"{out['victim_health']} in {out['kill_to_live_ms']:.1f} ms "
            f"(reset {out['resurrect_ms']:.2f} ms, canary "
            f"{out['canary_ms']:.1f} ms)")

        # ---- both replicas serve again, by replays -----------------------
        before = [e.stats() for e in engines]
        kernel_mod.reset_launches()
        out["tokens_per_s_after_recovery"] = batch("recovered")
        total = kernel_mod.launches["paged_decode_bf16"]
        per = []
        for e, st0 in zip(engines, before):
            st = e.stats()
            d = {k: st[k] - st0[k] for k in ("graph_replays", "eager_calls",
                                             "kernel_launches_window")}
            if d["eager_calls"] or not d["graph_replays"] \
                    or not d["kernel_launches_window"]:
                fail(f"after recovery replica {engines.index(e)}: {d}")
            per.append(d["kernel_launches_window"])
        if sum(per) != total:
            fail(f"B4 launches: replicas count {per}, the counter {total}")
        out["b4_launches_per_replica"] = per

        # ---- the watchdog: a real trip with the replay in flight ----------
        deadline_ms = 2.0
        metrics.reset()
        flags.set_flags({"FLAGS_serving_resurrect_budget": 1000,
                         "FLAGS_step_deadline_ms": deadline_ms})
        handles, typed = [], 0
        for r in reqs("sla"):
            try:
                handles.append(fe.submit(r, bounded=False))
            except serving.NoHealthyReplicaError:
                typed += 1
        comps = [h.result(timeout=60, raise_on_error=False)
                 for h in handles]
        typed += sum(1 for c in comps if c.state == "failed"
                     and "DeadlineExceeded" in (c.error or ""))
        flags.set_flags({"FLAGS_step_deadline_ms": 0.0})
        if typed != 8:
            fail(f"watchdog arm: {typed} of 8 requests failed typed: "
                 f"{[(c.uid, c.state, c.finish_reason) for c in comps]}")
        # each trip's dump: the sla_trip step, and the worker's stack at
        # the trip (inside the replay or its .cpu(): the window in flight)
        trip_steps = in_flight = 0
        for name in os.listdir(dump_dir):
            with open(os.path.join(dump_dir, name)) as f:
                d = json.load(f)
            trip_steps += sum(s["status"] == "sla_trip" for s in d["steps"])
            stacks = d.get("extra", {}).get("thread_stacks", "")
            worker = stacks.split("--- thread executor-step")[1:]
            in_flight += any(".replay(" in w.split("--- thread")[0]
                             or ".cpu()" in w.split("--- thread")[0]
                             for w in worker)
        out["watchdog"] = {"deadline_ms": deadline_ms,
                           "window_ms_p50": window_ms,
                           "requests_failed_typed": typed,
                           "sla_trips": metrics.get("serving.sla_trips"),
                           "flight_dumps": len(os.listdir(dump_dir)),
                           "sla_trip_steps_in_dumps": trip_steps,
                           "dumps_with_the_window_in_flight": in_flight}
        if not trip_steps or not in_flight:
            fail(f"watchdog arm: no sla_trip step in the flight dumps, or "
                 f"no trip caught the window in flight {out['watchdog']}")
        if not _wait(lambda: all(e.health == serving.Health.LIVE
                                 and e._dead is None for e in engines), 60):
            fail(f"watchdog arm: replicas did not come back "
                 f"{[e.health_history[-4:] for e in engines]}")
        flags.set_flags({"FLAGS_serving_resurrect_budget": 3})
        out["watchdog"]["tokens_per_s_after"] = batch("after-sla")
        log(f"resilience watchdog arm: {out['watchdog']}")

        # ---- drain ----------------------------------------------------------
        rs = reqs("drain", 32)
        handles = [fe.submit(r, bounded=False) for r in rs]
        # drain with the first admissions decoding and the rest queued
        _wait(lambda: sum(h.state == "decode" for h in handles) >= 8, 30)
        handed = fe.drain(timeout_s=120)
        comps = [h.result(timeout=120, raise_on_error=False)
                 for h in handles]
        done = [c for c in comps if c.ok]
        shed = [c for c in comps if c.finish_reason == "shed:draining"]
        if (not done or not handed or len(done) + len(shed) != 32
                or sorted(r.uid for r in handed)
                != sorted(c.uid for c in shed)
                or any(c.tokens != want(c.uid) for c in done)):
            fail(f"drain arm: {len(done)} done, {len(shed)} shed, "
                 f"{len(handed)} handed back of 32")
        out["drain"] = {"submitted": 32, "completed": len(done),
                        "handed_back": len(handed)}
        log(f"resilience drain arm: {out['drain']}")
    finally:
        clear_plan()
        flags.set_flags({"FLAGS_step_deadline_ms": 0.0,
                         "FLAGS_serving_resurrect_budget": 3,
                         "FLAGS_flight_dump_dir": ""})
        fe.stop()
        shutil.rmtree(dump_dir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# 10. data parallelism across processes: GPT-2 small at dp 2
# ---------------------------------------------------------------------------

DP_STAGES = (0, 1, 2, 3)
DP_STEPS = 3
DP_GLOBAL_BATCH = 32        # 16 a rank at dp 2
DP_WORLD = 2
DP_SEED = 21
DP_LR = 1e-4
# dp 2 against one process at batch 32, from the same weights: the loss of
# each step within the card-vs-CPU tolerance of phases 6-7
DP_LOSS_RTOL = 1e-4
# a ZeRO bucket pads to a multiple of 64 elements: at most 63 more f32
# elements of each of AdamW's two moments
PAD_SLACK_BYTES = 64 * 2 * 4


def dp_config():
    """GPT-2 small at S 512 with dropout 0 (the stage gates compare bits)."""
    cfg = gpt_config()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    return cfg


def dp_state_bytes(torch, main, scope):
    """Bytes of optimizer state a rank holds: the flat ZeRO state and every
    per-parameter accumulator."""
    from paddle_tpu_torch.parallel import zero
    names = set()
    for b in zero.zero_buckets(main):
        names |= set(b["flat"].values())
    for op in main.global_block().ops:
        for in_slot, _ in zero._UPDATE_STATE_SLOTS.get(op.type, {}).values():
            names |= set(op.inputs.get(in_slot, ()))
    return int(sum(scope.find(n).numel() * scope.find(n).element_size()
                   for n in names if isinstance(scope.find(n), torch.Tensor)))


def dp_expected_calls(main):
    """The collectives a rank makes per step by the program's plan: one
    all-reduce per sync bucket and one for the loss's replica mean; per
    ZeRO bucket one reduce-scatter unless it is pre-synced, and one
    all-gather (of the parameters at stages 1-2, before the bucket's first
    use at stage 3)."""
    meta = main._grad_buckets
    zb = meta["zero_buckets"]
    want = {"all_reduce.calls": len(meta["sync_buckets"]) + 1}
    rs = sum(1 for b in zb if not b["pre_synced"])
    if rs:
        want["reduce_scatter.calls"] = rs
    if zb:
        want["all_gather.calls"] = len(zb)
    return want


def dp_worker():
    """One rank of the dp-2 gang (`chip_smoke.py --dp-worker`, started by
    the port's launcher): GPT-2 small, global batch 32 (this rank's 16
    rows), fleet AMP, AdamW + global-norm clip, DP_STEPS eager steps at
    each ZeRO stage from the startup program's weights; writes its
    numbers to $CHIP_SMOKE_DP_OUT/rank<r>.json and fails on any gate it
    can hold alone."""
    import torch
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed import fleet, gloo, parallel
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.io import _portable_arrays
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import zero_update as zk
    from paddle_tpu_torch.parallel import zero
    from paddle_tpu_torch.resilience import DivergenceSentinel, fingerprint

    fleet.init(is_collective=True)
    rank, world = parallel.get_rank(), parallel.get_world_size()
    dev = parallel.rank_device()
    log(f"dp rank {rank}/{world}: {parallel.backend()} on {dev}")
    if world != DP_WORLD or parallel.backend() != "gloo" \
            or dev != torch.device("cuda", 0):
        fail(f"dp rank {rank}: expected gloo on cuda:0 at dp {DP_WORLD}")
    host = gloo.from_env()
    sentinel = DivergenceSentinel(host, interval=1, heal=False)
    cfg = dp_config()
    tokens = gpt_tokens(cfg, DP_GLOBAL_BATCH, DP_STEPS, DP_SEED)
    widths = []
    spied = zk.launch

    def spy(lib, op_type, ins, attrs, stream):
        widths.append(int(ins["Param"][0].numel()))
        return spied(lib, op_type, ins, attrs, stream)

    zk.launch = spy
    out = {"rank": rank, "stages": {}}
    base = None
    for stage in DP_STAGES:
        main, start, loss, _ = build_gpt_state(cfg, stage=stage, lr=DP_LR)
        scope, exe = Scope(), Executor("cuda")
        exe.run(start, scope=scope)
        if stage == 0:
            # the ranks start equal: same program, same seed, same card
            sentinel.check(main, scope, 0)
            out["startup_digest"] = fingerprint(main, scope)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zk.reset_launches()
        fa.reset_launches()
        widths.clear()
        metrics.reset()
        coll.reset_counters()
        losses, step_ms, calls, nbytes, host_ms = [], [], [], [], []
        for s in range(DP_STEPS):
            before = dict(coll.counters)
            hms = dict(coll.host_ms)
            t0 = time.perf_counter()
            got, = exe.run(main, feed={"tokens": coll.split_batch(tokens[s])},
                           fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(got))
            delta = {k: v - before.get(k, 0)
                     for k, v in coll.counters.items()
                     if v - before.get(k, 0)}
            calls.append({k: v for k, v in delta.items()
                          if k.endswith(".calls")})
            nbytes.append({k: v for k, v in delta.items()
                           if k.endswith(".bytes")})
            host_ms.append({k: v - hms.get(k, 0.0)
                            for k, v in coll.host_ms.items()})
        peak = torch.cuda.max_memory_allocated()
        b8 = zk.launches["zero_adam"]
        flash = dict(fa.launches)
        if any(flash[k] != cfg.num_layers * DP_STEPS
               for k in fa.KERNEL_NAMES):
            fail(f"dp rank {rank} stage {stage}: flash launches {flash}, "
                 f"expected {cfg.num_layers} a step")
        buckets = zero.zero_buckets(main)
        want_calls = dp_expected_calls(main)
        for s, c in enumerate(calls):
            if c != want_calls:
                fail(f"dp rank {rank} stage {stage} step {s}: collectives "
                     f"{c}, the plan says {want_calls}")
        shard = [b["padded"] // world for b in buckets]
        if b8 != len(buckets) * DP_STEPS or \
                sorted(widths) != sorted(shard * DP_STEPS):
            fail(f"dp rank {rank} stage {stage}: {b8} B8 launches at "
                 f"widths {sorted(set(widths))} for {len(buckets)} buckets "
                 f"of shards {sorted(set(shard))} x {DP_STEPS} steps")
        sentinel.check(main, scope, DP_STEPS)
        state = _portable_arrays(main, scope)
        params = {p.name: state[p.name] for p in main.all_parameters()}
        row = {"losses": losses, "step_ms": step_ms,
               "step_ms_p50": float(np.median(step_ms)),
               "calls_per_step": calls[-1],
               "collective_host_ms_per_step": {
                   k: float(np.mean([h.get(k, 0.0) for h in host_ms]))
                   for k in host_ms[-1]},
               "bytes_per_step": nbytes[-1],
               "emulated": {k: v for k, v in metrics.snapshot(
                   percentiles=False).items()
                   if k.startswith("executor.collective_emulated")},
               "b8_launches": b8, "b8_widths": sorted(set(widths)),
               "flash_launches": flash,
               "buckets": len(buckets),
               "pre_synced": sum(b["pre_synced"] for b in buckets),
               "state_bytes": dp_state_bytes(torch, main, scope),
               "state_bytes_plan": zero.optimizer_state_bytes(
                   main, world)["state_bytes_per_device"],
               "peak_memory_bytes": int(peak),
               "digest": sentinel.last_digests.get(rank)}
        if stage == 0:
            base = (losses, params)
        else:
            diff = sorted(n for n in params
                          if not np.array_equal(params[n], base[1][n]))
            row["params_equal_stage0"] = not diff
            row["losses_equal_stage0"] = losses == base[0]
            if diff or losses != base[0]:
                fail(f"dp rank {rank}: stage {stage} differs from stage 0 "
                     f"(losses {losses} vs {base[0]}; parameters {diff[:5]})")
        log(f"dp rank {rank} stage {stage}: losses {losses}, step ms "
            f"{[round(m, 1) for m in step_ms]}, calls {calls[-1]}, "
            f"B8 {b8} at {sorted(set(widths))}, state "
            f"{row['state_bytes']} B, peak {peak / 2**30:.2f} GiB")
        out["stages"][str(stage)] = row
        del main, start, loss, scope, exe, state, params
        release(torch)
    zk.launch = spied
    host.close()
    with open(os.path.join(os.environ["CHIP_SMOKE_DP_OUT"],
                           f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    parallel.destroy()
    return 0


def dp_nccl_refusal():
    """One rank of a gang asking for NCCL with both ranks on cuda:0
    (`chip_smoke.py --dp-nccl-refusal`): the port must raise its typed
    error before NCCL is touched."""
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.distributed import parallel
    from paddle_tpu_torch.framework import errors
    try:
        parallel.init_parallel_env(backend="nccl", device="cuda:0",
                                   timeout_s=60)
    except errors.PreconditionNotMetError as e:
        print(f"chip_smoke: dp rank {os.environ['PADDLE_TRAINER_ID']} "
              f"refused: {e}", flush=True)
        return 0
    return 4


def launch_gang(args, env, timeout_s, log_name):
    """The port's launcher as a child (`python -m
    paddle_tpu_torch.distributed.launch --nproc_per_node 2 ...`); returns
    (rc, output). The output is also kept under chiprun_out/. Fails if a
    process the gang started is left when the launcher has ended (this
    script is a subreaper: an orphaned rank would be its child)."""
    from paddle_tpu_torch.distributed.spawn import free_ports
    before = set(child_pids())
    port = free_ports(1)[0]
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(DP_WORLD), "--port", str(port),
           "--rendezvous_deadline_ms", "120000", "--grace_period_s", "10",
           os.path.join(HERE, "chip_smoke.py")] + args
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                           text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        fail(f"the launched gang {args} did not end within {timeout_s} s: "
             f"{(e.stdout or '')[-2000:]}")
    text = r.stdout + r.stderr
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", log_name), "w") as f:
        f.write(text)
    log(f"launched gang {args}: rc {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    left = {pid: cmd for pid, cmd in child_pids().items()
            if pid not in before}
    if left:
        fail(f"processes left after the gang {args}: {left}")
    return r.returncode, text


def nccl_capture_gate(torch):
    """On an NCCL group of one (cuda:0), through the port's collective
    functions: a reduce-scatter, an all-gather and an all-reduce captured
    in a CUDA graph; three replays on new inputs equal the eager calls,
    bit for bit, and each replay counts each collective once."""
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed import parallel
    from paddle_tpu_torch.ops.kernels import counts
    saved = {k: os.environ.get(k) for k in ("PADDLE_TRAINER_ID",
                                            "PADDLE_TRAINERS_NUM")}
    os.environ.update(PADDLE_TRAINER_ID="0", PADDLE_TRAINERS_NUM="1")
    try:
        parallel.init_parallel_env(backend="nccl", device="cuda:0")
        n = 1 << 20
        xs = torch.empty(n, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)

        def body():
            ar = coll.all_reduce(xs.clone())
            rs = coll.reduce_scatter_flat(xs)
            ag = coll.all_gather_flat(xs[: n // 2])
            return ar, rs, ag

        xs.normal_(generator=gen)
        body()                              # the communicator comes up
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with counts.capture(side) as rec, \
                torch.cuda.graph(graph, stream=side,
                                 capture_error_mode="thread_local"):
            outs = body()
        coll.reset_counters()
        replays = []
        for _ in range(3):
            xs.normal_(generator=gen)
            graph.replay()
            counts.count_replay(rec)
            torch.cuda.synchronize()
            got = [o.clone() for o in outs]
            want = body()
            torch.cuda.synchronize()
            replays.append(all(torch.equal(g, w) for g, w in zip(got, want)))
        per_replay = {k: v for k, v in coll.counters.items()
                      if k.endswith(".calls")}
        if not all(replays):
            fail(f"nccl capture gate: replays {replays} differ from eager")
        want = {"all_reduce.calls": 6, "reduce_scatter.calls": 6,
                "all_gather.calls": 6}
        if per_replay != want:
            fail(f"nccl capture gate: counts {per_replay} after 3 replays "
                 f"and 3 eager calls, expected {want}")
        log(f"nccl capture gate: RS / AG / AR captured on an NCCL group of "
            f"one, 3 replays == eager: {replays}")
        return {"backend": parallel.backend(), "replays_equal": replays,
                "calls": per_replay, "n": n}
    finally:
        parallel.destroy()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_b8_shard(torch, zk, width):
    """B8 (adamw, as the dp path runs it) against its plain version bit
    for bit at `width` elements (the shard of GPT-2 small's largest bucket
    at dp 2), timed beside the plain version, the bytes bound and
    torch's _fused_adamw_."""
    attrs = ZERO_ARMS[4][3]
    gen = torch.Generator(device="cuda").manual_seed(1)

    def fresh():
        ins = {s: [torch.randn(width, generator=gen, device="cuda")]
               for s in ("Param", "Grad", "Moment1", "Moment2")}
        ins["Moment2"][0].abs_()
        ins.update({"LearningRate": [torch.tensor([1e-3], device="cuda")],
                    "Beta1Pow": [torch.tensor([0.9 ** 3], device="cuda")],
                    "Beta2Pow": [torch.tensor([0.999 ** 3], device="cuda")]})
        return ins

    kin = fresh()
    pin = {s: [v[0].clone()] for s, v in kin.items()}
    got = zk.fused_flat_update("adamw", kin, attrs)
    want = zk.fused_flat_update_plain("adamw", pin, attrs)
    torch.cuda.synchronize()
    bad = [s for s in got if not torch.equal(got[s][0], want[s][0])]
    if bad:
        fail(f"zero_adam at the dp-2 shard width {width}: {bad} differ from "
             f"the plain version")
    lib = zero_library_call(torch, "adamw", "adamw", kin)
    row = {"n": width, "bitwise": True, "max_abs_err": 0.0,
           "ms": cuda_ms(torch, launch_alone(torch, zk, kin, attrs,
                                             "adamw")),
           "wrapper_ms": cuda_ms(torch, lambda: zk.fused_flat_update(
               "adamw", kin, attrs)),
           "plain_ms": cuda_ms(torch, lambda: zk.fused_flat_update_plain(
               "adamw", kin, attrs)),
           "bound_ms": width * ZERO_BYTES_PER_ELEMENT["zero_adam"]
           / HBM_BYTES_PER_S * 1e3,
           "library_ms": None if lib is None else cuda_ms(torch, lib)}
    log(f"kernel zero_adam adamw at the dp-2 shard width {width}: bit for "
        f"bit; {row['ms']:.4f} ms alone, {row['wrapper_ms']:.4f} through "
        f"the wrapper, plain {row['plain_ms']:.4f}, bytes bound "
        f"{row['bound_ms']:.4f}, torch fused {row['library_ms']}")
    return row


def train_gpt_dp(torch, zk, card):
    """Phase 10: the dp-2 gang through the port's launcher (both ranks on
    cuda:0 under gloo, as asked for explicitly), its gates, the typed NCCL
    refusal, the one-process arm at batch 32 from the same weights, the
    NCCL capture gate and B8 at the shard width."""
    import tempfile
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.parallel import zero
    cfg = dp_config()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    env = dict(os.environ, PADDLE_DIST_BACKEND="gloo",
               PADDLE_DIST_DEVICE="cuda:0", CHIP_SMOKE_DP_OUT=out_dir)
    rc, text = launch_gang(["--dp-worker"], env, 600, "dp_gang.log")
    if rc != 0:
        fail(f"the dp-2 gang failed (rc {rc}): {text[-3000:]}")
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if ranks[0]["startup_digest"] != ranks[1]["startup_digest"]:
        fail("dp ranks start from different weights")
    for s in map(str, DP_STAGES):
        a, b = ranks[0]["stages"][s], ranks[1]["stages"][s]
        if a["losses"] != b["losses"] or a["digest"] != b["digest"]:
            fail(f"dp stage {s}: rank 0 and rank 1 differ")
    st0, st1 = (ranks[0]["stages"][s]["state_bytes"] for s in ("0", "1"))
    nb = ranks[0]["stages"]["1"]["buckets"]
    if abs(2 * st1 - st0) > nb * PAD_SLACK_BYTES:
        fail(f"dp stage 1 holds {st1} B of optimizer state a rank, stage 0 "
             f"{st0}: not half, give or take the padding")

    # NCCL asked for with two ranks on one card: the typed error, no hang
    env_nccl = dict(os.environ, PADDLE_DIST_BACKEND="nccl",
                    PADDLE_DIST_DEVICE="cuda:0")
    rc, text = launch_gang(["--dp-nccl-refusal"], env_nccl, 180,
                           "dp_nccl_refusal.log")
    refused = text.count("refused: ")
    if rc != 0 or refused != DP_WORLD:
        fail(f"two NCCL ranks on one card: rc {rc}, {refused} typed "
             f"refusals: {text[-2000:]}")
    nccl_line = next(line for line in text.splitlines()
                     if "refused: " in line)

    # one process at batch 32 from the same weights (the startup program's)
    main, start, loss, _ = build_gpt_state(cfg, stage=0, lr=DP_LR)
    scope, exe = Scope(), Executor("cuda")
    exe.run(start, scope=scope)
    tokens = gpt_tokens(cfg, DP_GLOBAL_BATCH, DP_STEPS, DP_SEED)
    torch.cuda.reset_peak_memory_stats()
    one, one_ms = [], []
    for s in range(DP_STEPS):
        t0 = time.perf_counter()
        got, = exe.run(main, feed={"tokens": tokens[s]}, fetch_list=[loss],
                       scope=scope)
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
        one.append(float(got))
    one_peak = torch.cuda.max_memory_allocated()
    largest = max(b["padded"] for b in zero.zero_buckets(
        build_gpt_state(cfg, stage=1, lr=DP_LR)[0]))
    del main, start, loss, scope, exe
    release(torch)
    dp_losses = ranks[0]["stages"]["0"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(dp_losses, one))
    log(f"dp 2 vs one process at batch 32: losses {dp_losses} vs {one}, "
        f"max rel {rel:.3e} (limit {DP_LOSS_RTOL})")
    if not rel <= DP_LOSS_RTOL:
        fail(f"dp 2 trains otherwise than one process: max rel {rel:.3e}")
    capture = nccl_capture_gate(torch)
    shard = check_b8_shard(torch, zk, largest // DP_WORLD)
    launches = sum(ranks[0]["stages"][s]["b8_launches"]
                   for s in map(str, DP_STAGES))
    return {
        "card": card,
        "config": "GPTConfig() at S 512, dropout 0, global batch 32 (16 a "
                  "rank), fleet AMP bf16, AdamW(1e-4, weight decay 0.01) + "
                  "GradientClipByGlobalNorm(1.0), eager Executor.run, "
                  f"{DP_STEPS} steps a stage, weights from the startup "
                  "program (seed 0)",
        "launch": "python -m paddle_tpu_torch.distributed.launch "
                  "--nproc_per_node 2 chip_smoke.py --dp-worker, "
                  "PADDLE_DIST_BACKEND=gloo PADDLE_DIST_DEVICE=cuda:0",
        "ranks": ranks,
        "one_process": {"losses": one, "step_ms": one_ms,
                        "step_ms_p50": float(np.median(one_ms)),
                        "peak_memory_bytes": int(one_peak)},
        "loss_max_rel_vs_one_process": rel,
        "nccl_two_ranks_one_card": nccl_line,
        "nccl_capture_gate": capture,
        "b8_shard": shard,
        "b8_launches_rank0": launches,
    }


def main():
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, HERE)
    try:
        import paddle_tpu_torch
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")
    if not os.path.abspath(paddle_tpu_torch.__file__).startswith(HERE):
        fail(f"paddle_tpu_torch was imported from outside the checkout: "
             f"{paddle_tpu_torch.__file__}")
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import gpt_decode
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import paged_ops, registry
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import paged_attention as kernel_mod
    from paddle_tpu_torch.ops.kernels import zero_update as zk

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    ptxas = {}
    for lib, text in sorted(_build.build_log.items()):
        for entry, numbers in ptxas_report(text).items():
            log(f"ptxas {lib} {entry}: {numbers}")
            ptxas[entry] = numbers
    sass = {}
    for lib in libs.values():
        counts = sass_mma_counts(lib)
        if counts is None:
            sass = None
            break
        sass.update(counts)
    log(f"SASS HMMA counts: {sass}")

    # ---- kernels vs plain --------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"TF32 off: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    rows = check_kernels(torch, kernel_mod, paged_ops, ptxas)
    rows.update(check_flash_kernels(torch, fa, ptxas, sass))
    for name, numbers in check_flash_gpt(torch, fa).items():
        rows[name]["gpt_causal"] = numbers
    rows.update(check_zero_kernels(torch, zk, ptxas))
    for name, row in rows.items():
        if "sass_hmma" not in row:
            fn = "paged_decode_kernel" if name.startswith("paged") \
                else f"{name}_kernel"
            row["sass_hmma"] = "not measured (no cuobjdump)" if sass is None \
                else {k: c for k, c in sass.items() if fn in k}

    # ---- GPT-2 small served through the port --------------------------------
    serving_row, resilience_row = serve_gpt2(
        torch, serving, gpt_decode, kernel_mod, metrics, rows, card)

    # ---- BERT pretraining through Program / Executor ----------------------
    torch.cuda.empty_cache()
    parity = card_vs_cpu(torch, fa)
    training, launches0, launches1 = train_bert(torch, fa, zk, registry,
                                                card)
    training["card_vs_cpu"] = parity
    for name in fa.KERNEL_NAMES:
        rows[name]["launches"] = launches0[name]
    rows["zero_adam"]["launches"] = launches1["zero_adam"]

    # ---- ZeRO stages against each other, deterministic algorithms ----------
    # warn_only: an op without a deterministic implementation warns (the
    # warnings are printed) instead of stopping the run
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        training["zero_card_gate"] = zero_card_gate(torch, zk)
        training["zero_arms"], arm_launches = zero_arms(torch, zk)
    torch.use_deterministic_algorithms(False)
    for msg in sorted({str(w.message)[:200] for w in caught}):
        log(f"under deterministic algorithms: {msg}")
    for name, n in arm_launches.items():
        rows[name]["launches"] = n

    # ---- GPT-2 small LM training: run_steps on one captured step ---------
    release(torch)
    gpt_row = {"card_vs_cpu": gpt_card_vs_cpu(torch, fa)}
    gpt_row["capture_gates"] = [
        gpt_capture_gate(torch, fa, zk, gpt_config(), stage)
        for stage in (0, 1)]
    timing, gpt_launches = train_gpt(torch, fa, zk, registry, gpt_decode,
                                     serving, card)
    gpt_row.update(timing)
    for name in fa.KERNEL_NAMES:
        rows[name]["launches_by_path"] = {
            "bert_training_stage0": rows[name]["launches"],
            "gpt_training_captured_30_steps": gpt_launches[name]}
        rows[name]["launches"] = gpt_launches[name]
    rows["zero_adam"]["launches_by_path"] = {
        "bert_training_stage1": rows["zero_adam"]["launches"],
        "gpt_capture_gate_stage1_incl_warmup":
            gpt_row["capture_gates"][1]["launches_incl_warmup"]["zero_adam"]}

    # ---- GPT-2 small training that survives a restart ----------------------
    release(torch)
    state_row, state_launches = train_gpt_resilient(torch, fa, zk, card)
    rows["zero_adam"]["launches_by_path"][
        "gpt_schedule_stage1_captured_3_steps_incl_warmup"] = \
        state_launches["zero_adam"]
    for name in ("zero_sgd", "zero_momentum"):
        rows[name]["launches_by_path"] = {
            "zero_arms": rows[name]["launches"],
            "gpt_schedule_stage1_2_layers_incl_warmup":
                state_launches[name]}

    # ---- GPT-2 small trained from data ---------------------------------------
    release(torch)
    data_row = train_gpt_from_data(torch, fa, card)

    # ---- data parallelism across processes: GPT-2 small at dp 2 -----------
    release(torch)
    dp_row = train_gpt_dp(torch, zk, card)
    rows["zero_adam"]["shard_dp2"] = dp_row.pop("b8_shard")
    rows["zero_adam"]["launches_by_path"][
        "gpt_dp2_rank0_4_stages_3_steps"] = dp_row["b8_launches_rank0"]
    for name in fa.KERNEL_NAMES:
        rows[name]["launches_by_path"]["gpt_dp2_rank0_4_stages_3_steps"] = \
            sum(dp_row["ranks"][0]["stages"][s]["flash_launches"][name]
                for s in map(str, DP_STAGES))

    for row in rows.values():
        if not row["launches"]:
            fail(f"{row['name']} was never launched on its main path run")
    log(f"stopped the run's processes: {stop_children()}")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"serving": serving_row}), flush=True)
    print(json.dumps({"resilience": resilience_row}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"gpt_training": gpt_row}), flush=True)
    print(json.dumps({"training_state": state_row}), flush=True)
    print(json.dumps({"data_path": data_row}), flush=True)
    print(json.dumps({"data_parallel": dp_row}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--dp-worker" in sys.argv:
        sys.exit(dp_worker())
    if "--dp-nccl-refusal" in sys.argv:
        sys.exit(dp_nccl_refusal())
    adopt_orphans()
    try:
        rc = main()
    finally:
        # a failed phase's processes too; on success main has stopped them
        stop_children()
    sys.exit(rc)
