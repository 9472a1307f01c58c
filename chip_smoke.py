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
8. GPT-2 small training that survives a restart, its width cut to 4
   layers (GPTConfig(num_layers=CUT_LAYERS)) at S 512,
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
9. GPT-2 small trained from data, phase 8's program (4 layers) on one
   executor and scope (one capture for every arm): a token file of 16,777,216 int32
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
   and B1-B3 once a layer and step over all windows; the loader rebuilt at
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
   Each trains GPT-2 small's width cut to 4 layers (CUT_LAYERS) at S 512
   on its 16 rows of a global batch of 32 (fleet AMP bf16, AdamW +
   global-norm clip, dropout 0), 3 eager steps at each of ZeRO stages 0-3
   from the startup program's weights. Gates:
   stage k == stage 0 bit for bit (losses and every parameter); rank 0 ==
   rank 1 by the DivergenceSentinel (after startup and after each stage);
   B1-B3 one launch a layer and step, B8 one a bucket and step at the shard
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
11. pipeline training, GPT-2 small's width cut to 4 layers
   (GPTConfig(num_layers=CUT_LAYERS) at S 512, fleet AMP bf16,
   Adam(1e-4), weights from the startup program, tokens from numpy seed
   0; dropout 0 where a gate compares across arithmetic orders):
   * G: PipelineOptimizer(num_microbatches=4) at batch 32 (microbatches
     of 8), 3 eager steps, beside the same program unsplit: losses within
     1e-4 relative; step ms p50 and peak memory of both; B1-B3 4 a layer
     (microbatch) and step;
   * P: pipeline_stages 2 over build_mesh(pp=2, devices=["cuda:0",
     "cuda:0"]), the same 4 microbatches: losses and every parameter
     within 1e-5 relative of G (`wte`, two stages' contributions, 5e-4),
     bit-equality recorded; 2 <= last_max_live_envs <= 3; B1-B3 4 a layer
     and step; then placement on two distinct devices (`pipe_placement`:
     a 2-stage model sharing a weight across stages, stage 0 on cuda:0
     and stage 1 on the CPU, through fleet's `pipeline_parallel_degree`):
     every parameter and Adam moment on its stage's device, and the
     losses within 1e-4 relative of its GPipe run on cuda:0;
   * R: fleet recompute at the layer boundaries, batch 32, ZeRO stage
     1: run_steps(10) captured == 10 Executor.run calls bit for bit at
     dropout 0.1; at dropout 0, 3 steps beside the program without
     recompute: losses within 1e-4 relative, the parameters' change from
     the start within 5e-2 of the reference's change (the norm of the
     difference over the norm of the change), and two planted faults (the
     last update lost, half the batch) read above that limit; B1 twice a
     layer and step, B2/B3 once, B8 once a bucket and step; step ms and
     peak memory of both;
   * M: fleet gradient merge, k_steps 4 with avg, batch 8: run_steps(8)
     captured == 8 Executor.run calls bit for bit at dropout 0.1; at
     dropout 0, 2 merged steps over the rows of 2 batch-32 steps beside
     the plain ones, held as arm R is (planted faults: the second merged
     update lost, a quarter of the rows); the beta pows move on merge
     steps only; micro-step ms p50.
12. rolled layers, GPT-2 small's width cut to 4 layers
   (GPTConfig(num_layers=CUT_LAYERS) at S 512, batch 32, fleet AMP bf16,
   Adam(1e-4), weights from the startup program, tokens from numpy seed
   0), each arm through fleet's `layer_scan`:
   * B8 on the largest stacked bucket, 2-D and contiguous: the whole
     [4, 2,359,296] and a rank's [4, 1,179,648] shard at dp 2, bit for
     bit against its plain version, timed beside it, its bytes bound and
     torch's _fused_adam_;
   * S: rolled beside unrolled at dropout 0.1, stage 0, 3 eager steps from
     the same startup weights, each arm alone on the card: the losses and
     every parameter (a stacked parameter's rows against the per-layer
     ones) bit-equal; B1-B3 once a layer and step; then run_steps(10)
     captured == 10
     Executor.run calls bit for bit; step ms p50, peak memory and the
     profiled busy share of each, and the eager steps of S and S3 timed
     in turns in one window;
   * S3: the rolled program at ZeRO stage 3 beside S's rolled run, bit
     for bit; its stacked buckets, B8 launches a step and
     optimizer_state_bytes;
   * SR: fleet recompute with layer scan at ZeRO stage 1 beside phase
     11's arm R at dropout 0: losses within 1e-4 relative, the parameters'
     change within 5e-2 of arm R's and a planted fault (the last update
     lost) above it; B1 twice a layer and step; peak memory;
   * S3D and DP in one dp-2 gang through the port's launcher (`python -m
     paddle_tpu_torch.distributed.launch --nproc_per_node 2 chip_smoke.py
     --scan-worker`, both ranks on cuda:0 under gloo), each rank 16 rows
     of 32: S3D, rolled at stage 0 then stage 3 (f32: under AMP stage
     0's bucket sync rounds a bf16 gradient's dp average to bf16, the
     reduce-scatter of stages >= 1 does not), bit-equal, the collectives
     of every step equal to the plan (an all-gather and a reduce-scatter
     per stacked bucket and layer, one of each per flat bucket, the
     loss's mean), B8 once a bucket and step at the shard widths, state
     and parameter bytes a rank about half of stage 0's; DP,
     pipeline_stages 2 over cuda:0 twice, 4 microbatches of the rank's 16
     rows, dropout 0: one dp all-reduce a step, the ranks equal by the
     DivergenceSentinel, then beside one process's GPipe at batch 32 from
     the same weights (losses within 1e-4 relative, the parameters' change
     within 5e-2), and the dp average skipped in a second run of the gang
     (the planted fault) reading above that limit; the gang leaves no
     process.
13. tensor and sequence parallelism, GPT-2 small's width cut to 2 layers
   (GPTConfig(num_layers=MP_LAYERS): hidden 768, 12 heads, vocab 50257;
   fleet AMP bf16, Adam(1e-4), ZeRO stage 0,
   weights from the startup program, tokens from numpy seed 0):
   * B1-B3's global-head keying: a launch over heads 6-11 keyed (0, 12,
     6) bit-equal to those heads of the full 12-head launch at dropout
     0.1 (O, dQ, dK, dV; f32 with a key-padding mask, bf16 causal), the
     slice keyed on its own heads different; the identity
     keying bit-equal to the kernels built with the flat b*nh+h key (the
     `flat_keying` variant) on the phase-3 arms;
   * B1-B3 against their plain version (FLASH_TOLERANCE) at every shape
     and keying the paths of phases 13 and 14 launch them at
     (FLASH_PATH_CASES: a rank's 6 heads at [8, 6, 512, 64], [4, 6,
     1024, 64], [4, 6, 512, 64] and [2, 6, 512, 64], keyed at each dp
     and tp / sp coordinate, and the one-process references' 12 heads
     under the identity keying),
     f32, causal, dropout 0.1; each launch alone timed once a shape
     beside its causal bound, the plain version and SDPA; phases 13 and
     14 fail if B1 ran at a shape or keying not held here;
   * the one-process references (tp 1, sp 1) from the same weights: arm
     T's shape at dropout 0 and 0.1, and SR / SU's (B1-B3 over S 1024);
   * one gang through the port's launcher (`python -m
     paddle_tpu_torch.distributed.launch --nproc_per_node 2 chip_smoke.py
     --mp-worker`, both ranks on cuda:0 under gloo), every rank feeding
     the global batch, 3 eager steps an arm:
     T, tp 2 (batch 8, cut from 32 for gloo's host traffic; S 512):
     losses within 1e-4 relative of tp 1 and the parameters' change
     within 5e-2 of tp 1's, at dropout 0 and 0.1; planted faults (layer
     0's row-parallel all-reduce skipped; the dropout keyed on the
     launch's own heads) read above a limit; `gpt_param_elements` at tp 2
     a rank; B1-B3 once a layer and step at [8, 6, 512, 64]; each step's
     DTensor collectives equal to `mp_plan_tp`; run_steps(3) == 3 run()
     calls bit for bit;
     SR / SU, sp 2 ring / Ulysses (batch 4, S 1024 = max_position): the
     same gates against sp 1 at dropout 0 and 0.1, planted faults (the
     ring's rotation skipped; Ulysses' sequence blocks in reverse
     order); the ring's 4 permutes a layer and step (K and V, and their
     gradients), Ulysses' 8 all-to-alls and B1-B3 once a layer and step
     at [4, 6, 1024, 64];
     step ms, host ms in collectives and peak memory of every arm, and
     one more step of T, SR, SU (each rank) and of the dropout-0
     references profiled: the device's busy time beside the step's wall
     and its host ms in collectives; M: at sp 2 every rank holds its
     part of the sequence outside attention too, so SU's peak memory a
     rank must be below the one-process reference's (SR's printed
     beside it); the gang leaves no process.
14. composed meshes, GPT-2 small's width cut to 2 layers (MP_LAYERS,
   dropout 0.1, fleet AMP
   bf16, Adam(1e-4), weights from the startup program, tokens from numpy
   seed 0, 3 eager steps an arm, every rank feeding the global batch):
   * B8 (adam) against its plain version bit for bit at the width of a
     rank's dp-2 shard of the largest flat bucket, timed beside it, its
     bytes bound and torch's _fused_adam_;
   * the one-process GPipe reference of arm PT (4 microbatches);
   * gang "z" (`chip_smoke.py --cm-worker`, 4 ranks on cuda:0 under
     gloo): Z1 / Z2, dp 2 x tp 2 at ZeRO stage 1 / 2 beside stage 0
     (batch 8, S 512), and ZS, dp 2 x sp 2 (Ulysses) at stage 1 beside
     stage 0 (batch 8, S 1024): losses and parameters bit for bit, and
     a planted fault on each mesh (the update takes the dp sum of the
     gradients) reading otherwise; the flat state a rank the dp half of
     the bucket (at most 0.55 of the whole Adam state), B8 once a bucket
     and step on the `[padded/2]` shard;
   * gang "lp" (2 ranks): L, rolled against unrolled at tp 2 (batch 8, S
     512) and at sp 2 Ulysses (batch 4, S 1024), bit for bit, B1-B3 once
     a layer and step; rolled with remat at sp 2 within 1e-5 (losses)
     and 5e-2 (the parameters' change), B1 twice a layer; planted
     faults (layer i taped with layer i+1's dropout masks, at tp 2
     rolled and in remat's re-run) reading outside; PT, pp 2 x tp 2
     (both stages on cuda:0) bit-equal to tp 2 GPipe on one stage, and
     within 1e-4 / 5e-2 of the one-process GPipe, the last microbatch
     replaced by the one before (planted) reading outside both;
     step ms, host ms in collectives, collectives by op, parameter and
     state bytes and peak memory a rank for every arm; the gangs leave
     no process.
15. the supervised gang, two ranks on cuda:0 under gloo through the
   port's launcher (`chip_smoke.py --sg-worker` / `--sg-serve-worker`),
   GPT-2 small's width cut to 2 layers (MP_LAYERS) at S 512, dropout 0,
   fleet AMP bf16, a global batch of 8 (4 rows a rank):
   * LSGD: LocalSGD k 4 with Adam(1e-4), 8 steps, every rank feeding the
     global batch: losses and the final state bit-equal to a one-process
     simulation on the card (two scopes, each on its half batch, the
     floating state averaged as (a + b) / 2 every 4 steps); between syncs
     the scope holds the synced view while the copies move; one
     `__step_sync__` marker a step; planted fault: the simulation
     averaging only the parameters reads outside; step ms p50 of local
     and of sync steps, host ms in gloo on sync steps;
   * PEER: ZeRO stage 1, AdamW + clip, 6 steps, under `--elastic_restarts
     1 --elastic_full_world --collect-dumps`: snapshots every 3 steps,
     replicated to the ring buddy after the first, then rank 1 calls
     os._exit before any disk checkpoint exists; rank 0's next step
     fails, the supervisor's SIGTERM flushes its own and its buddy's
     payloads, and the full-world relaunch recovers rank 1 on the `peer`
     rung and rank 0 on `local`, both from step 3; the final state of
     both ranks bit-equal to an uninterrupted dp-2 stage-1 run of the
     same schedule; the failed life's gang dump names rank 1 as
     `suspected_straggler`; planted fault: the ladder's peer and local
     rungs swapped reads rank 1 on another rung; the replicate's ms and
     bytes, the ms from the kill to rank 1's first resumed step; B8
     (adamw) bit for bit at the drill's widest shard;
   * POD: the clean second life's pod dump has 2 rank lanes and a
     cross-rank flow pair for every `__zero_update__` marker; planted
     fault: rank 1's markers dropped leaves markers unpaired; the
     straggler report and the merge ms;
   * WORKERS: two `serving.frontend.worker_main` ranks (GPT-2 small at 12
     layers, bf16, phase 4's geometry) serve phase 4's 8 requests split
     by rank: tokens equal to an in-process DecodeEngine over the same
     `params_from_scope`, B4 launched in each worker, tokens/s per
     worker; a second gang serving them 6 times is sent SIGTERM
     mid-serve, finishes the started ones with the same tokens, writes
     the rest as `handed_back` and exits 0.
   B1-B3 run here at [4, 12, 512, 64], held in phase 13's cases.
Each main-path run resets the kernel launch counts just before it and
fails if a kernel of its path was never launched.

Teardown: the script adopts its orphaned descendants (a subreaper) and,
before the result lines and again on a failure, stops every process it
started, the DataLoader's forkserver and multiprocessing's resource
tracker included, and waits for each to end.

Output: a `{"kernels": [...]}` line, a `{"serving": ...}` line, a
`{"resilience": ...}` line, a `{"training": ...}` line, a
`{"gpt_training": ...}` line, a `{"training_state": ...}` line, a
`{"data_path": ...}` line, a `{"data_parallel": ...}` line, a
`{"pipeline": ...}` line, a `{"layer_scan": ...}` line, a
`{"model_parallel": ...}` line, a `{"composed_mesh": ...}` line, a
`{"supervised_gang": ...}` line, and last
`{"ok": true, "device": {...}}`. The B8 row's `shard_peer` is phase 15's
shard check, and the B1-B3, B8 and bf16 B4 rows' `launches_by_path` add
phase 15's LSGD, PEER (rank 0) and WORKERS launches. The B8 row's `shard_dp2_tp2` is phase
14's shard check; the kernel rows' `launches_by_path` add phase 14's
rank-0 launches.
The flash rows' `launches_by_path` add phase 13's rank-0 launches (T and
SU), their `keying` entry its keying checks and `keyed_paths` the
keyed launches against the plain version at those paths' shapes.
The flash rows' `launches` are the GPT path's (the captured arm's 30
timed steps); `launches_by_path` keeps the BERT path's beside them.
"""
import collections
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


CAUSAL_BOUND_RATE = "3xTF32 (494.7 / 3 TFLOP/s), causal half counted"


def causal_flash_bounds(B, nh, S, hd):
    """{kernel: (bound ms, bound_by)} of f32 causal launches without a
    mask: flash_bounds' bytes, its products cut to the causal half ((S +
    1) / (2 S) of the dense work), at the 3xTF32 rate."""
    half = (S + 1) / (2 * S)
    t, lse, work = B * nh * S * hd * 4, 4 * B * nh * S, B * nh * S * S * hd
    out = {}
    for name, n_bytes, n_ops in (
            ("flash_fwd", 4 * t + lse, 4 * work),
            ("flash_bwd_dq", 6 * t + lse, 6 * work),
            ("flash_bwd_dkdv", 7 * t + lse, 8 * work)):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops * half / (TF32_FLOPS_PER_S / 3) * 1e3
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
        kw = dict(scale=scale, dropout=0.1, seed=seed, mask=mask)
        if dtype != "float32":
            # the plain version's time on the bf16 arm (B1, and B2 + B3 as
            # one backward for the three gradients)
            with torch.no_grad():
                extra[dtype]["plain_fwd"] = cuda_ms(
                    torch, lambda: fa.flash_attention_plain(q, k, v, **kw),
                    iters=10, warmup=2)
            op = fa.flash_attention_plain(qq, kk, vv, **kw)
            extra[dtype]["plain_bwd"] = cuda_ms(
                torch, lambda: torch.autograd.grad(
                    op, (qq, kk, vv), do, retain_graph=True),
                iters=10, warmup=2)
            del op
            continue
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
            row["bf16_plain_ms"] = extra["bfloat16"]["plain_fwd"]
            row["bf16_fwd_over_sdpa_fwd"] = {
                str(r): extra["bfloat16"][r][name] / sd for r in (0.1, 0.0)}
        else:
            row["bf16_b2_plus_b3_ms"] = extra["bfloat16"][0.1]["b2_plus_b3"]
            row["bf16_plain_b2_plus_b3_ms"] = extra["bfloat16"]["plain_bwd"]
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
        f"{rows['flash_bwd_dq']['bf16_b2_plus_b3_ms']:.4f} ms; plain "
        f"{rows['flash_bwd_dq']['bf16_plain_b2_plus_b3_ms']:.4f} ms; SDPA "
        f"bf16 backward {rows['flash_bwd_dq']['bf16_sdpa_bwd_ms']:.4f} ms; "
        f"B1 bf16 plain {fwd['bf16_plain_ms']:.4f} ms")
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
    bounds = causal_flash_bounds(B, nh, S, hd)
    for name in fa.KERNEL_NAMES:
        bound, bound_by = bounds[name]
        out[name].update(
            ms=ms[name], plain_ms=plain[name], bound_ms=bound,
            bound_by=bound_by, bound_rate=CAUSAL_BOUND_RATE,
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


def cut_gpt_config():
    """gpt_config() cut to CUT_LAYERS layers (width, heads, vocab and S
    kept): phases 8 and 9, inside the card check's time."""
    cfg = gpt_config()
    cfg.num_layers = CUT_LAYERS
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
    """Phase 8: GPT-2 small's width at CUT_LAYERS layers, S 512, batch 32,
    fleet AMP bf16, ZeRO stage 1, AdamW + GradientClipByGlobalNorm(1.0),
    dropout 0.1, the LR linear_lr_warmup(cosine_decay(...)) built in the
    program."""
    import shutil
    cfg = cut_gpt_config()
    workdir = os.path.join(HERE, ".chip_scratch", f"state_{os.getpid()}")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        t0 = time.perf_counter()
        out = {"config": f"GPTConfig(num_layers={CUT_LAYERS}) (GPT-2 "
                         "small's width, dropout 0.1), seq 512, "
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
    cfg = cut_gpt_config()
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
        "config": "the training_state phase's program (GPTConfig("
                  f"num_layers={CUT_LAYERS}), S 512, "
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
# Phases 10-12 train GPT-2 small's width at this depth, and phases 13-14 at
# MP_LAYERS (cut from 12: the gangs' DTensor and gloo work on the host
# grows with the layers, and the whole script must end inside 20 minutes)
CUT_LAYERS = 4
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
    """GPT-2 small's width at S 512, CUT_LAYERS deep, with dropout 0 (the
    stage gates compare bits)."""
    cfg = gpt_config()
    cfg.num_layers = CUT_LAYERS
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


def launch_gang(args, env, timeout_s, log_name, nproc=DP_WORLD,
                launcher_args=(), during=None):
    """The port's launcher as a child (`python -m
    paddle_tpu_torch.distributed.launch --nproc_per_node <nproc> ...`,
    two ranks unless `nproc` says otherwise, `launcher_args` added to its
    own options); returns (rc, output). `during(proc)`, when given, runs
    while the launcher does. The output is also kept under chiprun_out/.
    Fails if a process the gang started is left when the launcher has
    ended (this script is a subreaper: an orphaned rank would be its
    child)."""
    from paddle_tpu_torch.distributed.spawn import free_ports
    before = set(child_pids())
    port = free_ports(1)[0]
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--port", str(port),
           "--rendezvous_deadline_ms", "120000", "--grace_period_s", "10",
           *launcher_args, os.path.join(HERE, "chip_smoke.py")] + args
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        if during is not None:
            during(proc)
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        fail(f"the launched gang {args} did not end within {timeout_s} s: "
             f"{(out or '')[-2000:]}")
    r = subprocess.CompletedProcess(cmd, proc.returncode, out, err)
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


def check_b8_shard(torch, zk, width, op="adamw"):
    """B8 (`op`: adamw, as the dp path runs it, or adam, as phase 14's
    meshes run it) against its plain version bit for bit at `width`
    elements (the shard of GPT-2 small's largest bucket at dp 2), timed
    beside the plain version, the bytes bound and torch's
    _fused_adam(w)_."""
    attrs = ZERO_ARMS[4 if op == "adamw" else 3][3]
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
    got = zk.fused_flat_update(op, kin, attrs)
    want = zk.fused_flat_update_plain(op, pin, attrs)
    torch.cuda.synchronize()
    bad = [s for s in got if not torch.equal(got[s][0], want[s][0])]
    if bad:
        fail(f"zero_adam {op} at the dp-2 shard width {width}: {bad} differ "
             f"from the plain version")
    lib = zero_library_call(torch, op, op, kin)
    row = {"n": width, "op": op, "bitwise": True, "max_abs_err": 0.0,
           "ms": cuda_ms(torch, launch_alone(torch, zk, kin, attrs, op)),
           "wrapper_ms": cuda_ms(torch, lambda: zk.fused_flat_update(
               op, kin, attrs)),
           "plain_ms": cuda_ms(torch, lambda: zk.fused_flat_update_plain(
               op, kin, attrs)),
           "bound_ms": width * ZERO_BYTES_PER_ELEMENT["zero_adam"]
           / HBM_BYTES_PER_S * 1e3,
           "library_ms": None if lib is None else cuda_ms(torch, lib)}
    log(f"kernel zero_adam {op} at the dp-2 shard width {width}: bit for "
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
        "config": f"GPTConfig(num_layers={CUT_LAYERS}) at S 512, dropout "
                  "0, global batch 32 (16 a rank), fleet AMP bf16, "
                  "AdamW(1e-4, weight decay 0.01) + "
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


# ---------------------------------------------------------------------------
# Phase 11: pipeline training
# ---------------------------------------------------------------------------

PIPE_BATCH = 32            # the global batch of arms G, P and R
PIPE_MICRO = 4             # GPipe / pp microbatches (8 rows each)
PIPE_STEPS = 3             # eager steps of the cross-order gates
PIPE_CAPTURED = 10         # run_steps(k) of arm R
PIPE_GM_K, PIPE_GM_BATCH = 4, 8
PIPE_TIMED = 4             # steps timed after an arm's gated steps
PIPE_LR = 1e-4
PIPE_RTOL = {"gpipe": 1e-4, "pp": 1e-5, "pp_wte": 5e-4, "recompute": 1e-4,
             "merge": 1e-4, "placement": 1e-4}
# Parameters across arithmetic orders under AMP (arms R and M), held as
# their change from the start: the norm of the difference of the two
# changes over the norm of the reference's change, within
# PIPE_CHANGE_RTOL. Adam's first steps move an element by about lr on the
# sign of its gradient, whatever the gradient's size, so an element whose
# gradient is near zero can move the other way when the sums run in
# another order. On an H100 that read 1.67e-2 (R) and 1.64e-2 (M), spread
# over the large weights, while planted faults read 0.29 (one update of
# three lost) to 1.07 (a quarter of the rows). Each run plants its own
# faults, and their readings must land above the limit.
PIPE_CHANGE_RTOL = 5e-2


def pipe_config(dropout, pp=0):
    """GPTConfig(num_layers=CUT_LAYERS) at S 512 with `dropout` and `pp`
    device_guard stages."""
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(num_layers=CUT_LAYERS, hidden_dropout=dropout,
                        attention_dropout=dropout, pipeline_stages=pp)
    cfg.seq_len = GPT_SEQ
    return cfg


def build_pipe(cfg, micro=0, recompute=False, merge=0, stage=0):
    """(main, startup, loss) of GPT LM training through fleet (AMP bf16,
    Adam(1e-4)), with PipelineOptimizer(`micro`), fleet recompute at the
    model's per-layer checkpoints, or fleet gradient merge (`merge` steps,
    avg), at ZeRO `stage`."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import Program, program_guard, unique_name
    from paddle_tpu_torch.models import gpt
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard():
        _, loss = gpt.build_lm_program(cfg)
        fleet.init(is_collective=True)
        s = fleet.DistributedStrategy()
        s.amp = True
        s.sharding_stage = stage
        if recompute:
            s.recompute = True
            s.recompute_configs = {"checkpoints": loss._layer_checkpoints}
        if merge:
            s.gradient_merge = True
            s.gradient_merge_configs = {"k_steps": merge, "avg": True}
        opt = optimizer.Adam(learning_rate=PIPE_LR)
        if micro:
            opt = optimizer.PipelineOptimizer(opt, num_microbatches=micro)
        fleet.distributed_optimizer(opt, s).minimize(loss)
    return main, start, loss


def pipe_start(torch, start):
    from paddle_tpu_torch.framework import Executor, Scope
    scope = Scope()
    Executor("cuda").run(start, scope=scope)
    return scope


def pipe_eager(torch, fa, zk, main, scope, loss, batches, on_step=None,
               timed=0):
    """Executor.run over `batches` (a [steps, B, S] array), `on_step()`
    after each, then `timed` more steps over the batches again and, with
    `timed`, one under torch.profiler: the losses of `batches`, each
    step's ms (synchronised; step_ms_p50 over the timed steps when there
    are any), the peak device memory, the kernel launches of the `batches`
    steps and the profiled step's device busy share."""
    from paddle_tpu_torch.framework import Executor
    exe = Executor("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    zk.reset_launches()
    losses, ms = [], []
    for toks in batches:
        t0 = time.perf_counter()
        got, = exe.run(main, feed={"tokens": toks}, fetch_list=[loss],
                       scope=scope)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(got))
        if on_step is not None:
            on_step()
    launches = dict(fa.launches, **zk.launches)
    peak = int(torch.cuda.max_memory_allocated())
    timed_ms = time_steps(torch, exe, main, scope, loss, batches, timed)
    row = {"losses": losses, "step_ms": ms, "timed_step_ms": timed_ms,
           "step_ms_p50": float(np.median(timed_ms or ms)),
           "peak_memory_bytes": peak, "launches": launches}
    if timed:
        row["profile"] = device_profile(
            torch, lambda: time_steps(torch, exe, main, scope, loss,
                                      batches, 1)[0] / 1e3, top=5)
    return row, exe


def busy(arm):
    """An arm's profiled device busy share, for the log."""
    share = arm.get("profile", {}).get("device_busy_share")
    return "not measured" if share is None else f"{share:.1%}"


def time_steps(torch, exe, main, scope, loss, batches, n):
    """The ms of `n` more Executor.run steps over `batches` in turn."""
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        exe.run(main, feed={"tokens": batches[i % len(batches)]},
                fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def rel_diff(torch, a, b):
    """max |a - b| / max |b| over a tensor."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def param_diffs(torch, main, sa, sb):
    """{parameter: max |a - b| / max |b|}, and the norm of all the
    parameters' differences over the norm of all of b's."""
    names = [p.name for p in main.all_parameters()]
    per = {n: rel_diff(torch, sa.find(n), sb.find(n)) for n in names}
    num = sum(float((sa.find(n).float() - sb.find(n).float()).square().sum())
              for n in names)
    den = sum(float(sb.find(n).float().square().sum()) for n in names)
    return per, (num / den) ** 0.5


def param_snapshot(torch, main, scope):
    """{parameter: a host copy of its value in `scope`} (on the host, so
    that it adds nothing to an arm's peak device memory)."""
    return {p.name: scope.find(p.name).detach().to("cpu", copy=True)
            for p in main.all_parameters()}


def param_gate_readings(torch, main, a, b, start):
    """Parameters `a` against the reference's `b`, both trained from
    `start` (each a scope or a `param_snapshot`): `params_norm_rel`, the
    norm of a - b over the norm of b; `change_rel`, the norm of
    (a - start) - (b - start) over the norm of b - start (the gate,
    PIPE_CHANGE_RTOL); `change_rel_top`, the three parameters with the
    largest parts of it; `moved_the_other_way`, the elements whose change
    has the other sign than the reference's, of `elements`."""
    def get(src, n):
        return (src[n].cuda() if isinstance(src, dict) else src.find(n)) \
            .reshape(-1).double()
    diff = ref = change = 0.0
    parts, other, count = {}, 0, 0
    for p in main.all_parameters():
        n = p.name
        va, vb, v0 = (get(x, n) for x in (a, b, start))
        parts[n] = float((va - vb).square().sum())
        diff += parts[n]
        ref += float(vb.square().sum())
        change += float((vb - v0).square().sum())
        other += int(((va - v0) * (vb - v0) < 0).sum())
        count += va.numel()
    top = sorted(parts, key=parts.get, reverse=True)[:3]
    return {"params_norm_rel": (diff / ref) ** 0.5,
            "change_rel": (diff / change) ** 0.5,
            "change_rel_top": {n: (parts[n] / change) ** 0.5 for n in top},
            "moved_the_other_way": other, "elements": count}


def expect_launches(got, want, what):
    bad = {k: (got.get(k), n) for k, n in want.items() if got.get(k) != n}
    if bad:
        fail(f"{what}: launches (got, expected) {bad}")


def pipe_gpipe_pp(torch, fa, zk):
    """Arms G (GPipe, 4 microbatches, one device) and P (pp 2, both stages
    on cuda:0) beside the unsplit batch, dropout 0, 3 eager steps each
    from the startup program's weights."""
    from paddle_tpu_torch.parallel import mesh, spmd
    cfg = pipe_config(0.0)
    toks = gpt_tokens(cfg, PIPE_BATCH, PIPE_STEPS, seed=0)
    per_step = cfg.num_layers * PIPE_MICRO
    out = {}
    main, start, loss = build_pipe(cfg)
    scope = pipe_start(torch, start)
    out["unsplit"], _ = pipe_eager(torch, fa, zk, main, scope, loss, toks,
                                   timed=PIPE_TIMED)
    del main, start, scope
    release(torch)

    main, start, loss = build_pipe(cfg, micro=PIPE_MICRO)
    g_scope = pipe_start(torch, start)
    out["gpipe"], _ = pipe_eager(torch, fa, zk, main, g_scope, loss, toks,
                                 timed=PIPE_TIMED)
    expect_launches(out["gpipe"]["launches"],
                    {n: PIPE_STEPS * per_step for n in fa.KERNEL_NAMES},
                    "arm G")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(out["gpipe"]["losses"], out["unsplit"]["losses"]))
    out["gpipe"]["loss_max_rel_vs_unsplit"] = rel
    log(f"pipeline G: losses {out['gpipe']['losses']} vs unsplit "
        f"{out['unsplit']['losses']}, max rel {rel:.3e} (limit "
        f"{PIPE_RTOL['gpipe']}); peak {out['gpipe']['peak_memory_bytes']} "
        f"vs {out['unsplit']['peak_memory_bytes']} B; step ms p50 "
        f"{out['gpipe']['step_ms_p50']:.1f} vs "
        f"{out['unsplit']['step_ms_p50']:.1f}; busy "
        f"{busy(out['gpipe'])} vs {busy(out['unsplit'])}")
    if not rel <= PIPE_RTOL["gpipe"]:
        fail(f"arm G: the microbatched losses differ from the unsplit "
             f"batch's by {rel:.3e}")
    g_main = main
    del start
    release(torch)

    pcfg = pipe_config(0.0, pp=2)
    main, start, loss = build_pipe(pcfg, micro=PIPE_MICRO)
    spmd.attach(main, spmd.DistConfig(
        mesh=mesh.build_mesh(pp=2, devices=["cuda:0", "cuda:0"])))
    p_scope = pipe_start(torch, start)
    out["pp2"], exe = pipe_eager(torch, fa, zk, main, p_scope, loss, toks,
                                 timed=PIPE_TIMED)
    pb, = exe._pipelines.values()
    expect_launches(out["pp2"]["launches"],
                    {n: PIPE_STEPS * per_step for n in fa.KERNEL_NAMES},
                    "arm P")
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(out["pp2"]["losses"], out["gpipe"]["losses"]))
    diffs, _ = param_diffs(torch, g_main, p_scope, g_scope)
    wte = diffs.pop("wte")
    worst = max(diffs, key=diffs.get)
    bitwise = (out["pp2"]["losses"] == out["gpipe"]["losses"]
               and all(torch.equal(p_scope.find(p.name),
                                   g_scope.find(p.name))
                       for p in g_main.all_parameters()))
    moments = [n for n in pb.state_names if "_moment" in n]
    out["pp2"].update({
        "loss_max_rel_vs_gpipe": loss_rel, "wte_rel_vs_gpipe": wte,
        "worst_param": worst, "worst_param_rel_vs_gpipe": diffs[worst],
        "bit_identical_to_gpipe": bitwise,
        "last_max_live_envs": pb.last_max_live_envs,
        "num_stages": pb.num_stages,
        "stage_of": {n: pb.var_stage[n] for n in
                     ("wte", "wpe", "dec0_attn_qkv_w",
                      f"dec{pcfg.num_layers - 1}_attn_qkv_w",
                      "final_ln_scale")},
        "state_checked": len(pb.state_names), "moments_checked": len(moments),
        "devices": [str(d) for d in pb.devices]})
    log(f"pipeline P: losses {out['pp2']['losses']}, loss rel {loss_rel:.3e}"
        f", wte rel {wte:.3e}, worst {worst} {diffs[worst]:.3e}, bitwise "
        f"{bitwise}, live envs {pb.last_max_live_envs}, stages "
        f"{out['pp2']['stage_of']}, step ms p50 "
        f"{out['pp2']['step_ms_p50']:.1f}, peak "
        f"{out['pp2']['peak_memory_bytes']} B, busy {busy(out['pp2'])}")
    if not (loss_rel <= PIPE_RTOL["pp"] and diffs[worst] <= PIPE_RTOL["pp"]
            and wte <= PIPE_RTOL["pp_wte"]):
        fail(f"arm P: pp 2 differs from arm G: losses {loss_rel:.3e}, "
             f"{worst} {diffs[worst]:.3e}, wte {wte:.3e}")
    if not 2 <= pb.last_max_live_envs <= 3:
        fail(f"arm P: {pb.last_max_live_envs} live microbatch envs")
    if not moments:
        fail("arm P: no Adam moment among the pipeline's state")
    del main, start, g_main, g_scope, p_scope, exe, pb
    release(torch)
    # both stages share cuda:0 above, so a tensor on the wrong stage's
    # device cannot show there: placement is held on two distinct devices
    out["pp2"]["placement"] = pipe_placement(torch)
    return out


def pipe_placement(torch):
    """Arm P's placement check on two distinct devices, where a misplaced
    tensor shows: a 2-stage model whose weight `w` is read by both stages
    (stage 0 on cuda:0, stage 1 on the CPU), f32, Adam(1e-2), through
    fleet: `fleet.init()`, then `distributed_optimizer` with
    `pipeline_parallel_degree` 2, `pipeline_configs["stage_devices"]` and
    2 microbatches of 8, 3 steps. Every parameter and Adam moment on its
    stage's device, both devices holding some, and the losses within
    PIPE_RTOL["placement"] of the same model's GPipe run on cuda:0."""
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import (Executor, Program, device_guard,
                                            program_guard, unique_name)
    from paddle_tpu_torch.initializer import TruncatedNormal
    from paddle_tpu_torch.layer_helper import ParamAttr
    from paddle_tpu_torch.parallel import mesh, pipeline

    def normal(name):
        return ParamAttr(name=name, initializer=TruncatedNormal(0.0, 0.1))
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(16, 64).astype(np.float32),
              "y": rng.randn(16, 64).astype(np.float32)}
             for _ in range(PIPE_STEPS)]
    runs = {}
    for devices in (None, ["cuda:0", "cpu"]):
        main, start = Program(), Program()
        with program_guard(main, start), unique_name.guard():
            x = layers.data(name="x", shape=[64], dtype="float32")
            y = layers.data(name="y", shape=[64], dtype="float32")
            w = layers.create_parameter([64, 64], "float32",
                                        attr=normal("w"))
            with device_guard("gpu:0"):
                h = layers.fc(layers.matmul(x, w), size=64, act="tanh",
                              param_attr=normal("w0"))
            with device_guard("gpu:1"):
                pred = layers.fc(layers.matmul(h, w, transpose_y=True),
                                 size=64, param_attr=normal("w1"))
            loss = layers.mean(layers.square_error_cost(pred, y))
            fleet.init(is_collective=True)
            s = fleet.DistributedStrategy()
            s.pipeline = True
            s.pipeline_configs = {"accumulate_steps": 2}
            if devices:
                s.pipeline_parallel_degree = 2
                s.pipeline_configs["stage_devices"] = devices
            fleet.distributed_optimizer(optimizer.Adam(learning_rate=1e-2),
                                        s).minimize(loss)
        mesh.set_mesh(None)
        scope = pipe_start(torch, start)
        exe = Executor("cuda")
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0]) for f in feeds]
        runs[bool(devices)] = (losses, exe, scope)
    (one, _, _), (losses, exe, scope) = runs[False], runs[True]
    pb, = exe._pipelines.values()
    homes = {n: str(scope.find(n).device) for n in pb.state_names}
    misplaced = sorted(n for n in pb.state_names
                       if [scope.find(n).device]
                       != pipeline.stage_devices(pb, pb.var_stage[n]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one))
    row = {"devices": [str(d) for d in pb.devices], "losses": losses,
           "losses_gpipe_cuda0": one, "loss_max_rel": rel,
           "state_homes": homes, "misplaced": misplaced,
           "moments_checked": sum("_moment" in n for n in pb.state_names)}
    log(f"pipeline P placement: stages on {row['devices']}, state homes "
        f"{homes}, losses {losses} vs GPipe {one}, rel {rel:.3e}")
    if misplaced or set(homes.values()) != {"cuda:0", "cpu"} \
            or not row["moments_checked"]:
        fail(f"arm P placement: state off its stage's device: {misplaced}, "
             f"homes {homes}")
    if not rel <= PIPE_RTOL["placement"]:
        fail(f"arm P placement: losses {losses} vs GPipe {one}")
    return row


def pipe_captured_gate(torch, fa, zk, main, start, loss, toks, per_step,
                       what):
    """run_steps(len(toks)) captured == len(toks) Executor.run calls from
    one startup state, bit for bit (losses and every persistable), with
    `per_step` launches of each kernel a step (the warm-up step
    included); then two more windows of replays, timed."""
    from paddle_tpu_torch.framework import Executor
    sa = pipe_start(torch, start)
    sb = scope_copy(torch, sa)
    eager = Executor("cuda")
    el = [float(eager.run(main, feed={"tokens": t}, fetch_list=[loss],
                          scope=sa)[0]) for t in toks]
    cap = Executor("cuda")
    fa.reset_launches()
    zk.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cl, = cap.run_steps(len(toks), main, feed={"tokens": toks},
                        fetch_list=[loss], scope=sb)
    cap_s = time.perf_counter() - t0
    launches = dict(fa.launches, **zk.launches)
    peak = int(torch.cuda.max_memory_allocated())
    steps_run = len(toks) + cap.stats["warmup_steps"]
    expect_launches(launches, {n: steps_run * c for n, c in
                               per_step.items()}, what)
    names, diffs = persistable_diffs(torch, main, sa, sb)
    cl = [float(x) for x in cl]
    log(f"pipeline {what} capture gate: eager {el}, captured {cl} "
        f"({cap_s:.1f} s incl. warm-up and capture); {len(names)} "
        f"persistables, {len(diffs)} differ; stats {cap.stats}; launches "
        f"{launches}")
    if diffs or cl != el:
        fail(f"{what}: captured run_steps != eager runs: {cl} vs {el}, "
             f"{dict(list(diffs.items())[:5])}")
    if cap.stats["eager_steps"] or cap.stats["graph_replays"] != len(toks):
        fail(f"{what}: executor stats {cap.stats}")
    # a window of replays, timed alone
    torch.cuda.synchronize()
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        cap.run_steps(len(toks), main, feed={"tokens": toks},
                      fetch_list=[loss], scope=sb)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / len(toks))
    row = {"steps": len(toks), "losses_eager": el, "losses_captured": cl,
           "bit_identical": True, "persistables_compared": len(names),
           "executor_stats": dict(cap.stats),
           "launches_incl_warmup": launches,
           "captured_step_ms": ms, "captured_peak_memory_bytes": peak}
    del sa, sb, eager, cap
    release(torch)
    return row


def pipe_recompute(torch, fa, zk):
    """Arm R: fleet recompute at the 12 layer boundaries, batch 32, ZeRO
    stage 1: the captured gate at dropout 0.1 (run_steps(10)), then 3
    eager steps at dropout 0 beside the same program without recompute."""
    cfg = pipe_config(0.1)
    L = cfg.num_layers
    main, start, loss = build_pipe(cfg, recompute=True, stage=1)
    n_buckets = op_count(main, "__zero_update__")
    per_step = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkdv": L,
                "zero_adam": n_buckets}
    toks = gpt_tokens(cfg, PIPE_BATCH, PIPE_CAPTURED, seed=0)
    row = {"segments": op_count(main, "__segment__"),
           "zero_update_ops": n_buckets,
           "capture_gate": pipe_captured_gate(torch, fa, zk, main, start,
                                              loss, toks, per_step,
                                              "arm R")}
    del main, start
    cfg0 = pipe_config(0.0)
    toks = gpt_tokens(cfg0, PIPE_BATCH, PIPE_STEPS, seed=0)
    arms, snaps = {}, {}
    for rc in (False, True):
        main, start, loss = build_pipe(cfg0, recompute=rc, stage=1)
        scope = pipe_start(torch, start)
        if not rc:
            p0 = param_snapshot(torch, main, scope)

        seen = []

        def snap(main=main, scope=scope):
            seen.append(1)
            if len(seen) == PIPE_STEPS - 1:
                # planted fault: the last update lost
                snaps["lost_update"] = param_snapshot(torch, main, scope)
        arms[rc], exe = pipe_eager(torch, fa, zk, main, scope, loss, toks,
                                   on_step=snap if rc else None)
        arms[rc]["run"] = (exe, main, scope, loss)
    # planted fault: each step on half of the batch's rows, twice
    half = np.concatenate([toks[:, :PIPE_BATCH // 2]] * 2, axis=1)
    fault_scope = pipe_start(torch, start)
    pipe_eager(torch, fa, zk, main, fault_scope, loss, half)
    snaps["half_batch"] = param_snapshot(torch, main, fault_scope)
    del start, fault_scope
    a, b = arms[True], arms[False]
    loss_rel = max(abs(x - y) / abs(y) for x, y in
                   zip(a["losses"], b["losses"]))
    main_b, sa, sb = b["run"][1], a["run"][2], b["run"][2]
    diffs, _ = param_diffs(torch, main_b, sa, sb)
    where = max(diffs, key=diffs.get)
    gate = param_gate_readings(torch, main_b, sa, sb, p0)
    faults = {k: param_gate_readings(torch, main_b, v, sb, p0)["change_rel"]
              for k, v in snaps.items()}
    expect_launches(a["launches"], {n: c * PIPE_STEPS
                                    for n, c in per_step.items()}, "arm R")
    # timed steps, after the comparison (the two scopes train on)
    for arm in (a, b):
        run = arm.pop("run")
        arm["timed_step_ms"] = time_steps(torch, *run, toks, PIPE_TIMED)
        arm["step_ms_p50"] = float(np.median(arm["timed_step_ms"]))
        arm["profile"] = device_profile(
            torch, lambda: time_steps(torch, *run, toks, 1)[0] / 1e3, top=5)
    del run
    del main_b, sa, sb, snaps, p0
    row.update({"recompute": a, "no_recompute": b,
                "loss_max_rel": loss_rel,
                "worst_param": where, "worst_param_max_rel": diffs[where],
                **gate, "planted_faults_change_rel": faults})
    log(f"pipeline R: losses {a['losses']} vs {b['losses']}, rel "
        f"{loss_rel:.3e}; {param_line(gate, where, diffs, faults)}; step "
        f"ms p50 "
        f"{a['step_ms_p50']:.1f} vs {b['step_ms_p50']:.1f}; peak "
        f"{a['peak_memory_bytes']} vs {b['peak_memory_bytes']} B; busy "
        f"{busy(a)} vs {busy(b)}; launches {a['launches']}")
    param_gates("arm R", loss_rel, gate, faults)
    del arms, a, b
    release(torch)
    return row


def param_line(gate, where, diffs, faults):
    """The log's words for `param_gate_readings` and the planted faults."""
    return (f"parameters norm-rel {gate['params_norm_rel']:.3e} (worst "
            f"{where} max-rel {diffs[where]:.3e}), change-rel "
            f"{gate['change_rel']:.3e} (limit {PIPE_CHANGE_RTOL}; top "
            f"{gate['change_rel_top']}; {gate['moved_the_other_way']} of "
            f"{gate['elements']} elements moved the other way), planted "
            f"faults {faults}")


def param_gates(what, loss_rel, gate, faults):
    """Arms R and M: the losses within PIPE_RTOL of the reference's, the
    parameters' change within PIPE_CHANGE_RTOL of the reference's, and
    every planted fault's change reading above PIPE_CHANGE_RTOL."""
    tol = PIPE_RTOL["recompute" if what == "arm R" else "merge"]
    if not (loss_rel <= tol and gate["change_rel"] <= PIPE_CHANGE_RTOL):
        fail(f"{what}: differs from its reference: losses {loss_rel:.3e} "
             f"(limit {tol}), the parameters' change {gate['change_rel']:.3e}"
             f" (limit {PIPE_CHANGE_RTOL})")
    blind = {k: v for k, v in faults.items() if not v > PIPE_CHANGE_RTOL}
    if blind:
        fail(f"{what}: the change gate cannot see planted faults {blind}")


def pipe_merge(torch, fa, zk):
    """Arm M: fleet gradient merge, k_steps 4 with avg, batch 8: the
    captured gate at dropout 0.1 (run_steps(8)), then at dropout 0 two
    merged steps (8 micro-steps over the rows of 2 batch-32 steps) beside
    2 plain steps at batch 32, the beta pows read after each micro-step."""
    cfg = pipe_config(0.1)
    L = cfg.num_layers
    main, start, loss = build_pipe(cfg, merge=PIPE_GM_K)
    toks = gpt_tokens(cfg, PIPE_GM_BATCH, 2 * PIPE_GM_K, seed=0)
    per_step = {n: L for n in fa.KERNEL_NAMES}
    per_step["zero_adam"] = 0
    row = {"capture_gate": pipe_captured_gate(torch, fa, zk, main, start,
                                              loss, toks, per_step,
                                              "arm M")}
    del main, start
    cfg0 = pipe_config(0.0)
    big = gpt_tokens(cfg0, PIPE_BATCH, 2, seed=0)
    main, start, loss = build_pipe(cfg0)
    plain = pipe_start(torch, start)
    p0 = param_snapshot(torch, main, plain)
    row["plain_batch32"], _ = pipe_eager(torch, fa, zk, main, plain, loss,
                                         big)
    del start
    gm_main, start, gm_loss = build_pipe(cfg0, merge=PIPE_GM_K)
    merged = pipe_start(torch, start)
    pows = sorted(v.name for v in gm_main.global_block().vars.values()
                  if v.persistable and "beta" in v.name and "pow" in v.name)
    history, moved, snaps = [], [], {}
    before = [merged.find(n).clone() for n in pows]

    def read_pows():
        nonlocal before
        now = [merged.find(n).clone() for n in pows]
        moved.append(any(not torch.equal(a, b) for a, b in zip(now, before)))
        history.append([float(x) for x in now])
        before = now
        if len(moved) == PIPE_GM_K:
            # planted fault: the second merged update lost
            snaps["lost_update"] = param_snapshot(torch, gm_main, merged)
    small = big.reshape(2 * PIPE_GM_K, PIPE_GM_BATCH, cfg0.seq_len)
    per, _ = pipe_eager(torch, fa, zk, gm_main, merged, gm_loss, small,
                        on_step=read_pows)
    # planted fault: each merged step on its first micro-batch, 4 times
    quarter = np.repeat(small[::PIPE_GM_K], PIPE_GM_K, axis=0)
    fault_scope = pipe_start(torch, start)
    pipe_eager(torch, fa, zk, gm_main, fault_scope, gm_loss, quarter)
    snaps["quarter_batch"] = param_snapshot(torch, gm_main, fault_scope)
    del fault_scope
    want = [s % PIPE_GM_K == 0 for s in range(1, 2 * PIPE_GM_K + 1)]
    diffs, _ = param_diffs(torch, main, merged, plain)
    where = max(diffs, key=diffs.get)
    gate = param_gate_readings(torch, main, merged, plain, p0)
    faults = {k: param_gate_readings(torch, main, v, plain, p0)["change_rel"]
              for k, v in snaps.items()}
    # the merged losses are per micro-step; the plain step's loss is the
    # mean over its 4 micro-batches' rows
    merged_means = [float(np.mean(per["losses"][i:i + PIPE_GM_K]))
                    for i in range(0, 2 * PIPE_GM_K, PIPE_GM_K)]
    loss_rel = max(abs(x - y) / abs(y) for x, y in
                   zip(merged_means, row["plain_batch32"]["losses"]))
    row.update({"merged_batch8": per, "beta_pows": history,
                "pows_moved": moved, "loss_max_rel_vs_plain": loss_rel,
                "worst_param": where, "worst_param_max_rel": diffs[where],
                **gate, "planted_faults_change_rel": faults})
    log(f"pipeline M: pows moved {moved}; losses (micro-step means) "
        f"{merged_means} vs {row['plain_batch32']['losses']}, rel "
        f"{loss_rel:.3e}; {param_line(gate, where, diffs, faults)} vs 2 "
        f"plain batch-32 steps; micro-step ms p50 "
        f"{per['step_ms_p50']:.1f}")
    if moved != want:
        fail(f"arm M: the beta pows moved at {moved}, expected {want}")
    param_gates("arm M", loss_rel, gate, faults)
    del main, gm_main, start, plain, merged, snaps, p0
    release(torch)
    return row


def train_gpt_pipeline(torch, fa, zk, card):
    """Phase 11: arms G, P, R and M."""
    t0 = time.perf_counter()
    row = {"card": card,
           "config": f"GPTConfig(num_layers={CUT_LAYERS}) at S 512, fleet "
                     "AMP bf16, Adam(1e-4), weights from the startup "
                     "program, tokens from numpy seed 0; dropout 0 in the "
                     "cross-order gates, 0.1 in the capture gates"}
    row.update(pipe_gpipe_pp(torch, fa, zk))
    row["recompute"] = pipe_recompute(torch, fa, zk)
    row["gradient_merge"] = pipe_merge(torch, fa, zk)
    row["phase_s"] = time.perf_counter() - t0
    return row


# ---------------------------------------------------------------------------
# Phase 12: rolled layers (layer scan), its stage-3 buckets, dp x pp
# ---------------------------------------------------------------------------

SCAN_STEPS = 3             # eager steps of the gates
SCAN_CAPTURED = 10         # run_steps(k) of arm S
SCAN_TIMED = 4             # steps timed after an arm's gated steps
SCAN_MICRO = 4             # arm DP: microbatches of a rank's 16 rows
SCAN_DROPOUT = 0.1         # arms S, S3, S3D (bitwise gates)
# B8 on GPT-2 small's largest stacked bucket, the FFN-in weight (768 x 3072
# a layer, a multiple of 64): the whole [CUT_LAYERS, 2,359,296] and a
# rank's [CUT_LAYERS, 1,179,648] shard at dp 2
SCAN_B8_SHAPES = ((CUT_LAYERS, 2_359_296), (CUT_LAYERS, 1_179_648))
# arm DP: each rank's two pp stages share the card
SCAN_PP_DEVICES = ("cuda:0", "cuda:0")


def build_scan(cfg, stage=0, rolled=True, recompute=False, micro=0,
               pp_devices=None, amp=True):
    """(main, startup, loss) of GPT LM training through fleet (AMP bf16
    unless `amp` is False, Adam(1e-4)) rolled by `layer_scan` (`rolled`),
    with fleet recompute at the model's per-layer checkpoints, at ZeRO
    `stage`; `micro` > 0 makes it a pipeline program of `micro`
    microbatches, over pp stages on `pp_devices` when given (fleet's
    `pipeline_parallel_degree`)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import Program, program_guard, unique_name
    from paddle_tpu_torch.models import gpt
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard():
        _, loss = gpt.build_lm_program(cfg)
        fleet.init(is_collective=True)
        s = fleet.DistributedStrategy()
        s.amp = amp
        s.layer_scan = rolled
        s.sharding_stage = stage
        if recompute:
            s.recompute = True
            s.recompute_configs = {"checkpoints": loss._layer_checkpoints}
        if micro:
            s.pipeline = True
            s.pipeline_configs = {"accumulate_steps": micro}
            if pp_devices:
                s.pipeline_parallel_degree = len(pp_devices)
                s.pipeline_configs["stage_devices"] = list(pp_devices)
        fleet.distributed_optimizer(optimizer.Adam(learning_rate=PIPE_LR),
                                    s).minimize(loss)
    return main, start, loss


def params_by_name(torch, main, scope, full=None, host=False):
    """{parameter of the unrolled program: its value in `scope`}: a
    rolled program's stacked rows under their per-layer names, a stage-3
    program's buckets unpacked (`full`: gathered shards by bucket name).
    Views on the card, or host copies."""
    from paddle_tpu_torch.parallel import zero
    full = full or {}
    vals = {}
    for b in zero.zero_buckets(main):
        if not b.get("flat_param"):
            continue
        flat = full.get(b["flat_param"], scope.find(b["flat_param"]))
        if b["layout"] == "stacked":
            vals[b["stack_var"]] = flat[:, :b["sizes"][0]].reshape(
                (b["num_layers"],) + tuple(b["shapes"][0]))
            continue
        off = 0
        for n, size, shape in zip(b["params"], b["sizes"], b["shapes"]):
            vals[n] = flat[off:off + size].reshape(tuple(shape))
            off += size
    for p in main.all_parameters():
        vals.setdefault(p.name, scope.find(p.name))
    stacks = getattr(main, "_layer_stacks", None) or {}
    out = {}
    for n, v in vals.items():
        if n in stacks:
            out.update(zip(stacks[n], v.unbind(0)))
        else:
            out[n] = v
    if host:
        out = {n: v.detach().to("cpu", copy=True) for n, v in out.items()}
    return out


def params_differ(torch, a, b):
    """Names whose tensors in the dicts `a` and `b` differ in any bit."""
    if sorted(a) != sorted(b):
        return sorted(set(a) ^ set(b))
    return sorted(n for n in a if not torch.equal(a[n], b[n]))


def scan_bucket_plan(main, dp):
    """Arm S3D's collectives a step by the program's plan: per stacked
    bucket one all-gather a layer (twice with a remat scan) and one
    reduce-scatter a layer; per flat stage-3 bucket one all-gather and one
    reduce-scatter unless pre-synced; one all-reduce per sync bucket and
    one for the loss's replica mean."""
    from paddle_tpu_torch.parallel import zero
    zb = zero.zero_buckets(main)
    stacked = [b for b in zb if b["layout"] == "stacked"]
    flat = [b for b in zb if b["layout"] == "flat"]
    scans = [op for op in main.global_block().ops
             if op.type == "__layer_scan__"]
    L = int(scans[0].attrs["num_layers"]) if scans else 0
    remat = 2 if scans and scans[0].attrs.get("remat") else 1
    want = {"all_reduce.calls": len(main._grad_buckets["sync_buckets"]) + 1}
    gathers = len(stacked) * L * remat + len(flat)
    scatters = len(stacked) * L + sum(not b["pre_synced"] for b in flat)
    if gathers:
        want["all_gather.calls"] = gathers
    if scatters:
        want["reduce_scatter.calls"] = scatters
    return want


def scan_worker():
    """One rank of phase 12's dp-2 gang (`chip_smoke.py --scan-worker`,
    started by the port's launcher, both ranks on cuda:0 under gloo): arm
    S3D (GPT-2 small rolled at ZeRO stage 0, then 3, SCAN_STEPS steps each
    on this rank's 16 rows of 32, dropout 0.1, f32), then arm DP (unrolled,
    pipeline_stages 2 over cuda:0 twice, SCAN_MICRO microbatches of its 16
    rows, dropout 0: SCAN_STEPS steps, then again from the startup with
    the dp average skipped, the planted fault); writes
    $CHIP_SMOKE_DP_OUT/scan_rank<r>.json, and rank 0 its parameters after
    each DP run, and fails on any gate it can hold alone."""
    import torch
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed import fleet, gloo, parallel
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import zero_update as zk
    from paddle_tpu_torch.parallel import pipeline, zero
    from paddle_tpu_torch.resilience import DivergenceSentinel
    from paddle_tpu_torch.resilience.integrity import ReplicaDivergenceError

    fleet.init(is_collective=True)
    rank, world = parallel.get_rank(), parallel.get_world_size()
    dev = parallel.rank_device()
    if world != DP_WORLD or parallel.backend() != "gloo" \
            or dev != torch.device("cuda", 0):
        fail(f"scan rank {rank}: expected gloo on cuda:0 at dp {DP_WORLD}")
    host = gloo.from_env()
    sentinel = DivergenceSentinel(host, interval=1, heal=False)
    out_dir = os.environ["CHIP_SMOKE_DP_OUT"]
    widths = []
    spied = zk.launch

    def spy(lib, op_type, ins, attrs, stream):
        widths.append(int(ins["Param"][0].numel()))
        return spied(lib, op_type, ins, attrs, stream)

    zk.launch = spy

    def steps(main, scope, loss, tokens, n_steps):
        exe = Executor("cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zk.reset_launches()
        fa.reset_launches()
        widths.clear()
        coll.reset_counters()
        losses, step_ms, calls, host_ms = [], [], [], []
        for s in range(n_steps):
            before, hms = dict(coll.counters), dict(coll.host_ms)
            t0 = time.perf_counter()
            got, = exe.run(main, feed={"tokens": coll.split_batch(
                tokens[s])}, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(got))
            calls.append({k: v - before.get(k, 0)
                          for k, v in coll.counters.items()
                          if k.endswith(".calls") and v - before.get(k, 0)})
            host_ms.append({k: v - hms.get(k, 0.0)
                            for k, v in coll.host_ms.items()})
        return exe, {
            "losses": losses, "step_ms": step_ms,
            "step_ms_p50": float(np.median(step_ms)),
            "calls_per_step": calls[-1],
            "collective_host_ms_per_step": {
                k: float(np.mean([h.get(k, 0.0) for h in host_ms]))
                for k in host_ms[-1]},
            "b8_launches": zk.launches["zero_adam"],
            "b8_widths": sorted(set(widths)),
            "flash_launches": dict(fa.launches),
            "peak_memory_bytes": int(torch.cuda.max_memory_allocated())}, \
            calls

    # ---- S3D: rolled stage 3 == rolled stage 0 at dp 2 ---------------------
    cfg = pipe_config(SCAN_DROPOUT)
    L = cfg.num_layers
    tokens = gpt_tokens(cfg, PIPE_BATCH, SCAN_STEPS, seed=0)
    out = {"rank": rank, "s3d": {}}
    kept = {}
    for stage in (0, 3):
        # f32: under AMP a bf16 weight gradient's dp average is rounded back
        # to bf16 by stage 0's bucket sync and kept in f32 by the
        # reduce-scatter of stages >= 1, so only f32 holds stage 3 to stage
        # 0 bit for bit at dp > 1
        main, start, loss = build_scan(cfg, stage=stage, amp=False)
        scope = Scope()
        Executor("cuda").run(start, scope=scope)
        _, row, calls = steps(main, scope, loss, tokens, SCAN_STEPS)
        want = scan_bucket_plan(main, world)
        for s, c in enumerate(calls):
            if c != want:
                fail(f"scan rank {rank} S3D stage {stage} step {s}: "
                     f"collectives {c}, the plan says {want}")
        if any(row["flash_launches"][k] != L * SCAN_STEPS
               for k in fa.KERNEL_NAMES):
            fail(f"scan rank {rank} S3D stage {stage}: flash launches "
                 f"{row['flash_launches']}, expected {L} a step")
        buckets = zero.zero_buckets(main)
        stacked = [b for b in buckets if b["layout"] == "stacked"]
        if stage == 3:
            shard = [L * b["padded"] // world if b["layout"] == "stacked"
                     else b["padded"] // world for b in buckets]
            if row["b8_launches"] != len(buckets) * SCAN_STEPS \
                    or row["b8_widths"] != sorted(set(shard)):
                fail(f"scan rank {rank} S3D stage 3: {row['b8_launches']} "
                     f"B8 launches at widths {row['b8_widths']}, expected "
                     f"{len(buckets)} a step at {sorted(set(shard))}")
            if not stacked:
                fail("S3D: no stacked bucket at stage 3")
        sentinel.check(main, scope, SCAN_STEPS)
        row.update({
            "plan": want, "stacked_buckets": len(stacked),
            "buckets": len(buckets),
            "state_bytes": dp_state_bytes(torch, main, scope),
            "state_bytes_plan": zero.optimizer_state_bytes(
                main, world)["state_bytes_per_device"],
            "param_bytes": int(sum(
                t.numel() * t.element_size()
                for n in {b["flat_param"] for b in buckets
                          if b.get("flat_param")}
                | {p.name for p in main.all_parameters() if p.persistable}
                if isinstance(t := scope.find(n), torch.Tensor))),
            "digest": sentinel.last_digests.get(rank)})
        kept[stage] = params_by_name(torch, main, scope, host=True,
                                     full=zero.gathered_shards(main, scope))
        out["s3d"][str(stage)] = row
        log(f"scan rank {rank} S3D stage {stage}: losses {row['losses']}, "
            f"step ms {[round(m, 1) for m in row['step_ms']]}, calls "
            f"{row['calls_per_step']}, B8 {row['b8_launches']}, state "
            f"{row['state_bytes']} B, params {row['param_bytes']} B")
        del main, start, loss, scope
    a, b = out["s3d"]["0"], out["s3d"]["3"]
    diff = params_differ(torch, kept[3], kept[0])
    if a["losses"] != b["losses"] or diff:
        fail(f"scan rank {rank} S3D: stage 3 differs from stage 0 (losses "
             f"{b['losses']} vs {a['losses']}; parameters {diff[:5]})")
    out["s3d"]["bit_identical"] = True
    out["s3d"]["parameters_compared"] = len(kept[0])
    del kept
    release(torch)

    # ---- DP: dp 2 x pp 2, then the planted fault --------------------------
    cfg0 = pipe_config(0.0, pp=2)
    tokens = gpt_tokens(cfg0, PIPE_BATCH, SCAN_STEPS, seed=0)
    out["dp"] = {}
    real_average = pipeline._PipelineBlock._dp_average
    for arm in ("sound", "fault"):
        if arm == "fault":
            pipeline._PipelineBlock._dp_average = \
                lambda self, env, dp: None
        main, start, loss = build_scan(cfg0, rolled=False, micro=SCAN_MICRO,
                                       pp_devices=SCAN_PP_DEVICES)
        scope = Scope()
        Executor("cuda").run(start, scope=scope)
        exe, row, calls = steps(main, scope, loss, tokens, SCAN_STEPS)
        pb, = exe._pipelines.values()
        row.update({"num_stages": pb.num_stages,
                    "dp_collectives_per_step": pb.collectives_per_step,
                    "last_max_live_envs": pb.last_max_live_envs})
        try:
            sentinel.check(main, scope, SCAN_STEPS)
            row["ranks_agree"] = True
        except ReplicaDivergenceError as e:
            row["ranks_agree"] = False
            row["divergence"] = str(e)[:300]
        if rank == 0:
            torch.save(params_by_name(torch, main, scope, host=True),
                       os.path.join(out_dir, f"dp_{arm}_params.pt"))
        out["dp"][arm] = row
        log(f"scan rank {rank} DP {arm}: losses {row['losses']}, step ms "
            f"{[round(m, 1) for m in row['step_ms']]}, calls "
            f"{row['calls_per_step']}, ranks agree {row['ranks_agree']}")
        del exe, pb, main, start, loss, scope
        release(torch)
    pipeline._PipelineBlock._dp_average = real_average
    sound = out["dp"]["sound"]
    if not sound["ranks_agree"] or sound["num_stages"] != 2 \
            or sound["dp_collectives_per_step"] != 1 \
            or sound["calls_per_step"] != {"all_reduce.calls": 2}:
        fail(f"scan rank {rank} DP: {sound}")
    if any(sound["flash_launches"][k] != L * SCAN_MICRO * SCAN_STEPS
           for k in fa.KERNEL_NAMES):
        fail(f"scan rank {rank} DP: flash launches "
             f"{sound['flash_launches']}")
    zk.launch = spied
    host.close()
    with open(os.path.join(out_dir, f"scan_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    parallel.destroy()
    return 0


def check_b8_stacked(torch, zk, shape):
    """B8 (adam, as the rolled arms run it) on a 2-D contiguous `shape`
    bucket against its plain version bit for bit, timed beside the plain
    version, the bytes bound and torch's _fused_adam_ on the same
    tensors."""
    attrs = ZERO_ARMS[3][3]
    gen = torch.Generator(device="cuda").manual_seed(2)

    def fresh():
        ins = {s: [torch.randn(shape, generator=gen, device="cuda")]
               for s in ("Param", "Grad", "Moment1", "Moment2")}
        ins["Moment2"][0].abs_()
        ins.update({"LearningRate": [torch.tensor([1e-3], device="cuda")],
                    "Beta1Pow": [torch.tensor([0.9 ** 3], device="cuda")],
                    "Beta2Pow": [torch.tensor([0.999 ** 3], device="cuda")]})
        return ins

    kin = fresh()
    pin = {s: [v[0].clone()] for s, v in kin.items()}
    n0 = zk.launches["zero_adam"]
    got = zk.fused_flat_update("adam", kin, attrs)
    want = zk.fused_flat_update_plain("adam", pin, attrs)
    torch.cuda.synchronize()
    if zk.launches["zero_adam"] != n0 + 1:
        fail(f"zero_adam on {shape}: the wrapper did not launch B8")
    bad = [s for s in got if not torch.equal(got[s][0], want[s][0])]
    if bad:
        fail(f"zero_adam on the stacked bucket {shape}: {bad} differ from "
             f"the plain version")
    n = shape[0] * shape[1]
    lib = zero_library_call(torch, "adam", "adam", kin)
    row = {"shape": list(shape), "n": n, "bitwise": True,
           "max_abs_err": 0.0,
           "ms": cuda_ms(torch, launch_alone(torch, zk, kin, attrs, "adam")),
           "wrapper_ms": cuda_ms(torch, lambda: zk.fused_flat_update(
               "adam", kin, attrs)),
           "plain_ms": cuda_ms(torch, lambda: zk.fused_flat_update_plain(
               "adam", kin, attrs)),
           "bound_ms": n * ZERO_BYTES_PER_ELEMENT["zero_adam"]
           / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes",
           "library_ms": None if lib is None else cuda_ms(torch, lib)}
    log(f"kernel zero_adam adam on the stacked {list(shape)}: bit for bit; "
        f"{row['ms']:.4f} ms alone, {row['wrapper_ms']:.4f} through the "
        f"wrapper, plain {row['plain_ms']:.4f}, bytes bound "
        f"{row['bound_ms']:.4f}, torch fused {row['library_ms']}")
    del kin, pin, got, want
    torch.cuda.empty_cache()
    return row


def scan_arm_alone(torch, fa, zk, build, toks, on_step=None):
    """One arm of phase 12 alone on the card: build() -> (main, startup,
    loss), the startup program, SCAN_STEPS gated eager steps over `toks`
    (`on_step(main, scope)` after each), host copies of the start and end
    parameters (`params_by_name`), then SCAN_TIMED timed steps and one
    profiled; the arm's scope is freed before it returns, so each arm's
    peak memory is its own. Returns (row, start params, end params, (main,
    startup, loss))."""
    from paddle_tpu_torch.parallel import zero
    main, start, loss = build()
    scope = pipe_start(torch, start)
    p0 = params_by_name(torch, main, scope, host=True)
    row, exe = pipe_eager(torch, fa, zk, main, scope, loss, toks,
                          on_step=None if on_step is None
                          else lambda: on_step(main, scope))
    p1 = params_by_name(torch, main, scope, host=True)
    buckets = zero.zero_buckets(main)
    row.update({
        "ops": len(main.global_block().ops),
        "stacked_buckets": sum(b["layout"] == "stacked" for b in buckets),
        "zero_buckets": len(buckets),
        "optimizer_state_bytes": zero.optimizer_state_bytes(main)})
    row["timed_step_ms"] = time_steps(torch, exe, main, scope, loss, toks,
                                      SCAN_TIMED)
    row["step_ms_p50"] = float(np.median(row["timed_step_ms"]))
    row["profile"] = device_profile(
        torch, lambda: time_steps(torch, exe, main, scope, loss, toks,
                                  1)[0] / 1e3, top=5)
    del exe, scope
    release(torch)
    return row, p0, p1, (main, start, loss)


def scan_arm_s(torch, fa, zk):
    """Arms S and S3: GPT-2 small rolled (`layer_scan`) beside unrolled at
    dropout 0.1, stage 0, 3 eager steps each from the startup program's
    weights, bit for bit; the rolled program at stage 3 beside it, bit for
    bit; each arm alone on the card, timed; then run_steps(10) captured ==
    10 Executor.run calls."""
    cfg = pipe_config(SCAN_DROPOUT)
    L = cfg.num_layers
    toks = gpt_tokens(cfg, PIPE_BATCH, SCAN_STEPS, seed=0)
    per_step = {n: L for n in fa.KERNEL_NAMES}
    arms, starts, ends, progs = {}, {}, {}, {}
    for name, rolled, stage in (("unrolled", False, 0), ("rolled", True, 0),
                                ("rolled_stage3", True, 3)):
        arms[name], starts[name], ends[name], progs[name] = scan_arm_alone(
            torch, fa, zk, lambda: build_scan(cfg, stage=stage,
                                              rolled=rolled), toks)
        want = dict(per_step, zero_adam=arms[name]["zero_buckets"])
        expect_launches(arms[name]["launches"],
                        {n: c * SCAN_STEPS for n, c in want.items()},
                        f"arm S {name}")
    base, rolled, s3 = arms["unrolled"], arms["rolled"], arms["rolled_stage3"]
    diff0 = params_differ(torch, starts["rolled"], starts["unrolled"])
    diff = params_differ(torch, ends["rolled"], ends["unrolled"])
    log(f"layer scan S: losses rolled {rolled['losses']} vs unrolled "
        f"{base['losses']}; {len(ends['rolled'])} parameters, {len(diff)} "
        f"differ ({len(diff0)} at the start); ops {rolled['ops']} vs "
        f"{base['ops']}")
    if rolled["losses"] != base["losses"] or diff or diff0:
        fail(f"arm S: rolled != unrolled (losses {rolled['losses']} vs "
             f"{base['losses']}; parameters {diff[:5]}, at the start "
             f"{diff0[:5]})")
    diff3 = params_differ(torch, ends["rolled_stage3"], ends["rolled"])
    log(f"layer scan S3: losses {s3['losses']}; {len(diff3)} parameters "
        f"differ from rolled stage 0; {s3['stacked_buckets']} stacked of "
        f"{s3['zero_buckets']} buckets; B8 {s3['launches']['zero_adam']} "
        f"in {SCAN_STEPS} steps; state {s3['optimizer_state_bytes']}")
    if s3["losses"] != rolled["losses"] or diff3:
        fail(f"arm S3: rolled stage 3 != rolled stage 0 (losses "
             f"{s3['losses']} vs {rolled['losses']}; parameters "
             f"{diff3[:5]})")
    del starts, ends
    interleaved = scan_interleaved(torch, progs, toks)
    main, start, loss = progs["rolled"]
    del progs
    ctoks = gpt_tokens(cfg, PIPE_BATCH, SCAN_CAPTURED, seed=1)
    capture = pipe_captured_gate(torch, fa, zk, main, start, loss, ctoks,
                                 dict(per_step, zero_adam=0), "arm S")
    log(f"layer scan S: step ms p50 rolled {rolled['step_ms_p50']:.1f} vs "
        f"unrolled {base['step_ms_p50']:.1f}, stage 3 "
        f"{s3['step_ms_p50']:.1f}; in turns {interleaved['step_ms_p50']}; "
        f"captured "
        f"{capture['captured_step_ms']}; peak {rolled['peak_memory_bytes']}"
        f" vs {base['peak_memory_bytes']} B (stage 3 "
        f"{s3['peak_memory_bytes']}); busy {busy(rolled)} vs {busy(base)}")
    del main, start, loss
    release(torch)
    return {"unrolled": base, "rolled": rolled, "bit_identical": True,
            "capture_gate": capture, "stage3": s3,
            "stage3_bit_identical": True, "in_turns": interleaved}


def scan_interleaved(torch, progs, toks, rounds=2, per_turn=2):
    """The eager step of arm S's three programs timed in turns within one
    window (unrolled, rolled, stage 3, stage 3, rolled, unrolled, `rounds`
    times, `per_turn` steps a turn), each from its own startup state, so
    that host noise falls on all three alike. Returns each program's step
    ms and their p50."""
    from paddle_tpu_torch.framework import Executor
    runs = {}
    for name, (main, start, loss) in progs.items():
        runs[name] = (Executor("cuda"), main, pipe_start(torch, start), loss)
    order = list(runs) + list(reversed(list(runs)))
    ms = {name: [] for name in runs}
    for _ in range(rounds):
        for name in order:
            exe, main, scope, loss = runs[name]
            ms[name] += time_steps(torch, exe, main, scope, loss, toks,
                                   per_turn)
    del runs
    release(torch)
    return {"order": order, "rounds": rounds, "steps_a_turn": per_turn,
            "step_ms": ms,
            "step_ms_p50": {n: float(np.median(v)) for n, v in ms.items()}}


def scan_arm_sr(torch, fa, zk):
    """Arm SR: fleet recompute with layer scan at ZeRO stage 1, beside PR
    13's arm R (recompute at the 12 boundaries, unrolled) at dropout 0, 3
    eager steps each from the startup program's weights, each alone on
    the card: losses within 1e-4, the parameters' change within
    PIPE_CHANGE_RTOL of arm R's, a planted fault (the last update lost)
    above it; B1 twice a layer and step."""
    cfg = pipe_config(0.0)
    L = cfg.num_layers
    toks = gpt_tokens(cfg, PIPE_BATCH, SCAN_STEPS, seed=0)
    arm_r, p0, ref, (main_r, _, _) = scan_arm_alone(
        torch, fa, zk, lambda: build_pipe(cfg, recompute=True, stage=1),
        toks)
    snaps, seen = {}, []

    def snap(main, scope):
        seen.append(1)
        if len(seen) == SCAN_STEPS - 1:
            snaps["lost_update"] = params_by_name(torch, main, scope,
                                                  host=True)
    arm_s, _, got, _ = scan_arm_alone(
        torch, fa, zk, lambda: build_scan(cfg, stage=1, recompute=True),
        toks, on_step=snap)
    n_buckets = arm_s["zero_buckets"]
    expect_launches(arm_s["launches"], {
        "flash_fwd": 2 * L * SCAN_STEPS, "flash_bwd_dq": L * SCAN_STEPS,
        "flash_bwd_dkdv": L * SCAN_STEPS,
        "zero_adam": n_buckets * SCAN_STEPS}, "arm SR")
    loss_rel = max(abs(x - y) / abs(y) for x, y in
                   zip(arm_s["losses"], arm_r["losses"]))
    gate = param_gate_readings(torch, main_r, got, ref, p0)
    faults = {k: param_gate_readings(torch, main_r, v, ref, p0)["change_rel"]
              for k, v in snaps.items()}
    log(f"layer scan SR: losses {arm_s['losses']} vs arm R "
        f"{arm_r['losses']}, rel {loss_rel:.3e}; change-rel "
        f"{gate['change_rel']:.3e} (limit {PIPE_CHANGE_RTOL}), planted "
        f"{faults}; step ms p50 {arm_s['step_ms_p50']:.1f} vs R "
        f"{arm_r['step_ms_p50']:.1f}; peak {arm_s['peak_memory_bytes']} vs "
        f"R {arm_r['peak_memory_bytes']} B; launches {arm_s['launches']}")
    if not (loss_rel <= PIPE_RTOL["recompute"]
            and gate["change_rel"] <= PIPE_CHANGE_RTOL):
        fail(f"arm SR differs from arm R: losses {loss_rel:.3e}, the "
             f"parameters' change {gate['change_rel']:.3e}")
    blind = {k: v for k, v in faults.items() if not v > PIPE_CHANGE_RTOL}
    if blind:
        fail(f"arm SR: the change gate cannot see planted faults {blind}")
    del got, ref, p0, snaps
    release(torch)
    return {"rolled_recompute": arm_s, "arm_r": arm_r,
            "loss_max_rel": loss_rel, **gate,
            "planted_faults_change_rel": faults, "zero_buckets": n_buckets}


def scan_arms_dp(torch, fa, zk, card):
    """Arms S3D and DP: the dp-2 gang through the port's launcher (both
    ranks on cuda:0 under gloo), then one process's GPipe at batch 32 from
    the same weights beside arm DP, and B8 at the stacked shard width."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_scan_")
    env = dict(os.environ, PADDLE_DIST_BACKEND="gloo",
               PADDLE_DIST_DEVICE="cuda:0", CHIP_SMOKE_DP_OUT=out_dir)
    t0 = time.perf_counter()
    rc, text = launch_gang(["--scan-worker"], env, 400, "scan_gang.log")
    gang_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"the phase-12 gang failed (rc {rc}): {text[-3000:]}")
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f"scan_rank{r}.json")) as f:
            ranks.append(json.load(f))
    for key in ("0", "3"):
        a, b = ranks[0]["s3d"][key], ranks[1]["s3d"][key]
        if a["losses"] != b["losses"] or a["digest"] != b["digest"]:
            fail(f"S3D stage {key}: rank 0 and rank 1 differ")
    s0, s3 = ranks[0]["s3d"]["0"], ranks[0]["s3d"]["3"]
    halves = {"state": s3["state_bytes"] / s0["state_bytes"],
              "params": s3["param_bytes"] / s0["param_bytes"]}
    if not all(0.45 < v < 0.55 for v in halves.values()):
        fail(f"S3D: a rank's stage-3 bytes over stage 0's {halves}, not "
             f"about a half")
    sound, fault = ranks[0]["dp"]["sound"], ranks[0]["dp"]["fault"]
    if sound["losses"] != ranks[1]["dp"]["sound"]["losses"]:
        fail("DP: rank 0 and rank 1 fetch different losses")

    # one process's GPipe at batch 32 from the same weights
    cfg0 = pipe_config(0.0, pp=2)
    toks = gpt_tokens(cfg0, PIPE_BATCH, SCAN_STEPS, seed=0)
    main, start, loss = build_scan(cfg0, rolled=False, micro=SCAN_MICRO)
    scope = pipe_start(torch, start)
    p0 = params_by_name(torch, main, scope, host=True)
    one, _ = pipe_eager(torch, fa, zk, main, scope, loss, toks)
    ref = params_by_name(torch, main, scope)
    loss_rel = max(abs(x - y) / abs(y) for x, y in
                   zip(sound["losses"], one["losses"]))
    got = {arm: torch.load(os.path.join(out_dir, f"dp_{arm}_params.pt"))
           for arm in ("sound", "fault")}
    gate = param_gate_readings(torch, main, got["sound"], ref, p0)
    fault_reading = param_gate_readings(torch, main, got["fault"], ref,
                                        p0)["change_rel"]
    log(f"layer scan DP: dp 2 x pp 2 losses {sound['losses']} vs one "
        f"process's GPipe {one['losses']}, rel {loss_rel:.3e}; change-rel "
        f"{gate['change_rel']:.3e} (limit {PIPE_CHANGE_RTOL}); the planted "
        f"fault (no dp average) {fault_reading:.3e}, ranks agree "
        f"{fault['ranks_agree']}; gang {gang_s:.1f} s")
    if not (loss_rel <= PIPE_RTOL["gpipe"]
            and gate["change_rel"] <= PIPE_CHANGE_RTOL):
        fail(f"arm DP differs from one process: losses {loss_rel:.3e}, the "
             f"parameters' change {gate['change_rel']:.3e}")
    if not fault_reading > PIPE_CHANGE_RTOL:
        fail(f"arm DP: the change gate cannot see the skipped dp average "
             f"({fault_reading:.3e})")
    del main, start, loss, scope, p0, ref, got
    release(torch)
    shutil_rm(out_dir)
    shard = check_b8_stacked(torch, zk, SCAN_B8_SHAPES[1])
    return {"ranks": ranks, "gang_s": gang_s,
            "launch": "python -m paddle_tpu_torch.distributed.launch "
                      "--nproc_per_node 2 chip_smoke.py --scan-worker, "
                      "PADDLE_DIST_BACKEND=gloo PADDLE_DIST_DEVICE=cuda:0",
            "s3d_bytes_stage3_over_stage0": halves,
            "dp_one_process_gpipe": one, "dp_loss_max_rel": loss_rel,
            "dp_change_rel": gate["change_rel"],
            "dp_change_rel_top": gate["change_rel_top"],
            "dp_planted_fault_change_rel": fault_reading,
            "b8_stacked_shard": shard}


def shutil_rm(path):
    import shutil
    shutil.rmtree(path, ignore_errors=True)


def train_gpt_rolled(torch, fa, zk, card):
    """Phase 12: arms S, S3, SR, S3D and DP, and B8 on the stacked
    buckets."""
    t0 = time.perf_counter()
    row = {"card": card,
           "config": f"GPTConfig(num_layers={CUT_LAYERS}) at S 512, batch "
                     "32, fleet AMP bf16, Adam(1e-4), weights from the "
                     "startup program, tokens from numpy seed 0; dropout "
                     "0.1 in arms S, S3 and "
                     "S3D, 0 in SR and DP; arm S3D in f32 (AMP off)"}
    row["b8_stacked_whole"] = check_b8_stacked(torch, zk, SCAN_B8_SHAPES[0])
    row.update(scan_arm_s(torch, fa, zk))
    row["remat"] = scan_arm_sr(torch, fa, zk)
    row["dp"] = scan_arms_dp(torch, fa, zk, card)
    row["phase_s"] = time.perf_counter() - t0
    return row


# ---------------------------------------------------------------------------
# Phase 13: tensor and sequence parallelism (arms T, SR, SU)
# ---------------------------------------------------------------------------

MP_WORLD = 2
MP_LAYERS = 2              # GPT-2 small's width at this depth (CUT_LAYERS)
MP_STEPS = 3
MP_LR = 1e-4
MP_T = (8, 512)            # arm T: batch (cut from 32 for gloo's host
#                            traffic) and sequence
MP_S = (4, 1024)           # arms SR / SU: batch and sequence (max_position)
MP_LOSS_RTOL = 1e-4
MP_CHANGE_RTOL = 5e-2
MP_DROPOUT = 0.1
MP_KEYING_SHAPE = (8, 12, 512, 64)


def mp_local_heads(cfg, batch):
    """[B, nh / 2, S, hd]: a rank's B1-B3 shape at tp 2 or in Ulysses at
    sp 2."""
    nh = cfg.num_heads
    return [batch, nh // 2, cfg.seq_len, cfg.hidden_size // nh]


def mp_config(seq, dropout, sp_mode=None):
    """GPTConfig(num_layers=MP_LAYERS) at `seq` with `dropout`; `sp_mode`
    asks the attention for ring or Ulysses sequence parallelism."""
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(num_layers=MP_LAYERS, hidden_dropout=dropout,
                        attention_dropout=dropout)
    cfg.seq_len = seq
    if sp_mode:
        cfg.sequence_parallel, cfg.sp_mode = True, sp_mode
    return cfg


def gpt_param_elements(cfg, tp=1):
    """The parameter elements a rank holds of GPT at `cfg` under GPT's
    Megatron rules at tp: each layer's QKV / proj / FFN weights and QKV /
    FFN-in biases split tp ways, its layer norms and other biases and the
    embeddings whole (wte's 50257 rows do not divide by 2). GPT-2 small:
    124,439,808 at tp 1, 81,940,224 at tp 2."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    split = 3 * h * h + 3 * h + h * h + h * f + f + f * h
    layer = 6 * h + split // tp
    return (cfg.vocab_size + cfg.max_position + 2) * h \
        + cfg.num_layers * layer


def build_mp(cfg, tp=1, sp=1):
    """(main, startup, loss) of GPT LM training through fleet (AMP bf16,
    Adam(1e-4), ZeRO stage 0) with `tensor_parallel_degree` tp (GPT's
    Megatron rules) and `sequence_parallel_degree` sp."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import Program, program_guard, unique_name
    from paddle_tpu_torch.models import gpt
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard(), \
            warnings.catch_warnings():
        # the auto-selected fused head over a `wte` the rules would
        # vocab-shard warns (fleet `_warn_tp_fused_head`); at 50257 rows
        # the table stays whole
        warnings.simplefilter("ignore")
        _, loss = gpt.build_lm_program(cfg)
        fleet.init(is_collective=True)
        s = fleet.DistributedStrategy()
        s.amp = True
        s.tensor_parallel_degree = tp
        s.sequence_parallel_degree = sp
        if tp > 1:
            s.tensor_parallel_rules = gpt.tp_sharding_rules()
        fleet.distributed_optimizer(optimizer.Adam(learning_rate=MP_LR),
                                    s).minimize(loss)
    return main, start, loss


def mp_whole_params(torch, main, scope):
    """{parameter: its whole value on the host}, a rolled program's per
    layer (a collective at tp > 1: every rank calls it)."""
    from paddle_tpu_torch.parallel import gspmd
    return {n: gspmd.whole(v).detach().to("cpu", copy=True)
            for n, v in params_by_name(torch, main, scope).items()}


def mp_run(torch, fa, main, start, loss, toks, steps=None, profile=False,
           zk=None):
    """Startup into a fresh scope, then Executor.run over `toks` (every
    rank feeds the global batch): losses, each step's ms (synchronised),
    the collectives of the last step by (op, collective, bytes), their
    host ms per step, the peak memory, the flash launches and the shapes
    B1 ran at, the parameter elements this rank holds; with the update
    kernels' module `zk`, B8's launches and the optimizer-state bytes this
    rank holds too; and the start and final parameters, whole. `profile`
    runs one more step after those readings under torch.profiler
    (`device_profile`): the device's busy time beside the step's wall and
    its host ms in collectives."""
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.parallel import gspmd, zero
    scope = Scope()
    exe = Executor("cuda")
    exe.run(start, scope=scope)
    p0 = mp_whole_params(torch, main, scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = int(torch.cuda.memory_allocated())
    fa.reset_launches()
    if zk is not None:
        zk.reset_launches()
    losses, ms, host, plans, calls = [], [], [], [], {}
    with flash_spy(fa) as shapes:
        for b in toks[:steps]:
            coll.reset_counters()
            gspmd.by_op.clear()
            t0 = time.perf_counter()
            got, = exe.run(main, feed={"tokens": b}, fetch_list=[loss],
                           scope=scope)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(got))
            host.append(sum(coll.host_ms.values()))
            plans.append(dict(gspmd.by_op))
            calls = dict(coll.counters)
    n = len(losses)
    row = {"losses": losses, "step_ms": ms,
           "step_ms_p50": float(np.median(ms)),
           "collective_host_ms_per_step": float(np.mean(host)),
           "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
           "memory_at_start_bytes": at_start,
           "flash_launches": dict(fa.launches),
           "flash_launches_per_step": {k: v / n
                                       for k, v in fa.launches.items()},
           "flash_fwd_shapes": sorted({str(list(s)) for s, _ in shapes}),
           "flash_fwd_keyed": launch_keys(shapes),
           "param_elements": gspmd.local_param_elements(main, scope),
           "calls_last_step": {k: v for k, v in calls.items()
                               if k.endswith(".calls")},
           "collectives_last_step": {
               f"{op} {c} {nb}": k for (op, c, nb), k in
               sorted(plans[-1].items(), key=str)} if plans else {}}
    if zk is not None:
        row["b8_launches"] = zk.launches["zero_adam"]
        row["param_bytes"] = 4 * row["param_elements"]
        row["state_bytes"] = zero.held_state_bytes(main, scope)
    p1 = mp_whole_params(torch, main, scope)
    if profile:
        def one_step():
            coll.reset_counters()
            return time_steps(torch, exe, main, scope, loss, toks, 1)[0] \
                / 1e3
        row["profile"] = device_profile(torch, one_step, top=5)
        row["profile"]["collective_host_ms"] = sum(coll.host_ms.values())
        log(f"phase 13 profiled step: {row['profile']}")
    return row, p0, p1, plans


def mp_plan_tp(cfg, batch, amp_bytes=2):
    """The collectives of one step of GPT LM training at tp 2 (dp 1, AMP
    bf16, wte whole) that the program and GPT's Megatron rules imply, by
    (op, collective, bytes): calls. Per layer, forward: the split of the
    column-parallel QKV output needs it whole (an all-gather of [B, S, 3H]
    f32: the f32 bias add promotes), and each row-parallel product (the
    attention projection and FFN-out, bf16) is reduced where its bias add
    reads it (two all-reduces of [B, S, H]); backward: Q, K and V's
    gradients, head-sharded by the attention, are gathered whole for the
    split's gradient (three all-gathers of [B, S, H] f32), and the
    gradients of the two column-parallel inputs are reduced where the
    layer norms' gradients read them (two all-reduces of [B, S, H] f32).
    Nothing else: the vocab table, the layer norms and the biases of the
    row-parallel layers are whole, and their gradients too."""
    b, s, h, L = batch, cfg.seq_len, cfg.hidden_size, cfg.num_layers
    act = b * s * h
    return {("split", "all_gather", 3 * act * 4): L,
            ("elementwise_add", "all_reduce", act * amp_bytes): 2 * L,
            ("fused_attention@grad", "all_gather", act * 4): 3 * L,
            ("layer_norm@grad", "all_reduce", act * 4): 2 * L}


def mp_check_plan(plans, want, what):
    for s, got in enumerate(plans):
        if got != want:
            diff = {str(k): (got.get(k), want.get(k))
                    for k in set(got) | set(want)
                    if got.get(k) != want.get(k)}
            fail(f"{what} step {s}: collectives (got, planned) {diff}")


def mp_readings(torch, got, ref, start):
    """The change gate of `got` against the reference (each a {name:
    host tensor}), as `param_gate_readings` reads it."""
    names = sorted(ref)
    diff = refn = change = 0.0
    for n in names:
        a, b, z = (x[n].double() for x in (got, ref, start))
        diff += float((a - b).square().sum())
        refn += float(b.square().sum())
        change += float((b - z).square().sum())
    return {"params_norm_rel": (diff / refn) ** 0.5,
            "change_rel": (diff / change) ** 0.5}


def mp_loss_rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def mp_references(torch, fa, out_dir):
    """The one-process references (tp 1, sp 1) from the same startup
    weights: arm T's at dropout 0 and 0.1 (batch 8, S 512) and SR / SU's
    (batch 4, S 1024, B1-B3 over the whole sequence), their losses in
    refs.json, the start parameters in start.pt and each arm's final ones
    in <name>.pt."""
    refs = {}
    arms = {"t0": (MP_T, 0.0), "t1": (MP_T, MP_DROPOUT),
            "s0": (MP_S, 0.0), "s1": (MP_S, MP_DROPOUT)}
    for name, ((batch, seq), rate) in arms.items():
        cfg = mp_config(seq, rate)
        toks = gpt_tokens(cfg, batch, MP_STEPS, seed=0)
        main, start, loss = build_mp(cfg)
        row, p0, p1, _ = mp_run(torch, fa, main, start, loss, toks,
                                profile=not rate)
        # one startup program: every arm starts from the same weights
        if name == "t0":
            torch.save(p0, os.path.join(out_dir, "start.pt"))
        torch.save(p1, os.path.join(out_dir, f"{name}.pt"))
        refs[name] = row
        log(f"phase 13 reference {name}: losses {row['losses']}, step ms "
            f"p50 {row['step_ms_p50']:.1f}, B1 shapes "
            f"{row['flash_fwd_shapes']}")
        del main, start, loss, p0, p1
        release(torch)
    with open(os.path.join(out_dir, "refs.json"), "w") as f:
        json.dump(refs, f)
    return refs


def mp_arm(torch, fa, out_dir, rank, ref_name, cfg, batch, tp, sp,
           fault=None, steps=None, keep=False, profile=False):
    """One gang arm: `cfg` at tp x sp from the startup weights, MP_STEPS
    eager steps; rank 0 reads the change gate against the reference's
    parameters. `fault` (a context manager factory) plants a fault.
    `keep` returns the final parameters too (whole, on the host);
    `profile` profiles one more step (`mp_run`)."""
    main, start, loss = build_mp(cfg, tp=tp, sp=sp)
    toks = gpt_tokens(cfg, batch, MP_STEPS, seed=0)
    with (fault() if fault else contextlib.nullcontext()):
        row, p0, p1, plans = mp_run(torch, fa, main, start, loss, toks,
                                    steps, profile)
    if rank == 0:
        start0 = torch.load(os.path.join(out_dir, "start.pt"))
        for n, v in p0.items():
            if not torch.equal(v, start0[n]):
                fail(f"phase 13 {ref_name} tp {tp} sp {sp}: the startup "
                     f"weights differ from the reference's at {n}")
        ref = torch.load(os.path.join(out_dir, f"{ref_name}.pt"))
        row.update(mp_readings(torch, p1, ref, start0))
        del ref, start0
    del main, start, loss, p0
    release(torch)
    return (row, plans, p1) if keep else (row, plans)


@contextlib.contextmanager
def mp_patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def mp_fault_skip_reduce(cfg):
    """Planted fault: layer 0's attention projection keeps its partial
    sum (its row-parallel all-reduce skipped): each rank takes its own
    part of the product as if it were the whole."""
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.parallel import gspmd
    opdef = registry.get("mul")
    lower = opdef.lower
    h, layers_ = cfg.hidden_size, cfg.num_layers
    seen = [0]

    def faulty(ctx, ins, attrs):
        out = lower(ctx, ins, attrs)
        w = ins["Y"][0]
        if ctx.mesh is None or not gspmd.is_dtensor(w) \
                or tuple(w.shape) != (h, h):
            return out
        seen[0] += 1
        o = out["Out"][0]
        if (seen[0] - 1) % layers_ == 0 \
                and any(p.is_partial() for p in o.placements):
            from torch.distributed.tensor import DTensor, Replicate
            out["Out"][0] = DTensor.from_local(
                o.to_local(), o.device_mesh,
                [Replicate()] * o.device_mesh.ndim, run_check=False)
        return out

    return lambda: mp_patch(opdef, "lower", faulty)


def ring_attention_module():
    """parallel/ring_attention.py (the package exports its function under
    the module's name)."""
    import importlib
    return importlib.import_module("paddle_tpu_torch.parallel.ring_attention")


def mp_fault_local_keying():
    """Planted fault: the attention's dropout keyed on the launch's own
    heads (h_off 0), not the global ones."""
    ra = ring_attention_module()
    keying = ra._keying
    return mp_patch(ra, "_keying",
                    lambda mesh, b, nh: keying(mesh, b, nh)[:2] + (0,))


def mp_fault_skip_rotation():
    """Planted fault: the ring's one rotation at sp 2 skipped (each rank
    attends to its own K/V block twice)."""
    ra = ring_attention_module()

    class Still:
        @staticmethod
        def apply(x, group, shift):
            return x
    return mp_patch(ra, "_Permute", Still)


def mp_fault_ulysses_order():
    """Planted fault: Ulysses' all-to-all lays the sequence blocks out in
    reverse rank order."""
    ra = ring_attention_module()
    seq2head = ra._seq2head

    def reversed_blocks(x, group, p):
        import torch
        y = seq2head(x, group, p)
        return torch.cat(list(reversed(y.chunk(p, dim=2))), dim=2)
    return mp_patch(ra, "_seq2head", reversed_blocks)


def mp_worker():
    """One rank of phase 13's gang (`chip_smoke.py --mp-worker`, started
    by the port's launcher, both ranks on cuda:0 under gloo): arm T (tp 2:
    dropout 0 with its collectives against the plan, run_steps(3) == 3
    run() calls bit for bit, the planted unreduced projection; dropout 0.1
    and its planted local keying), then arms SR and SU (sp 2, ring and
    Ulysses, at dropout 0 and 0.1 and each's planted fault). Reads the
    references' parameters from $CHIP_SMOKE_MP_OUT and writes
    mp_rank<r>.json there."""
    import faulthandler
    import torch
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.distributed import fleet, parallel
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    faulthandler.enable(all_threads=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fleet.init(is_collective=True)
    rank, world = parallel.get_rank(), parallel.get_world_size()
    dev = parallel.rank_device()
    if world != MP_WORLD or parallel.backend() != "gloo" \
            or dev != torch.device("cuda", 0):
        fail(f"mp rank {rank}: expected gloo on cuda:0 at {MP_WORLD} ranks")
    out_dir = os.environ["CHIP_SMOKE_MP_OUT"]
    out = {"rank": rank}

    # ---- T: tp 2 ----------------------------------------------------------
    batch, seq = MP_T
    cfg = mp_config(seq, 0.0)
    sound, plans, p_sound = mp_arm(torch, fa, out_dir, rank, "t0", cfg,
                                   batch, 2, 1, keep=True, profile=True)
    log(f"mp rank {rank} T: losses {sound['losses']}, step ms "
        f"{sound['step_ms']}, collectives {sound['calls_last_step']}")
    mp_check_plan(plans, mp_plan_tp(cfg, batch), f"T rank {rank}")
    if sound["param_elements"] != gpt_param_elements(cfg, tp=2):
        fail(f"T rank {rank}: {sound['param_elements']} parameter elements, "
             f"want {gpt_param_elements(cfg, tp=2)}")
    L = cfg.num_layers
    if sound["flash_launches_per_step"] != {n: L for n in fa.KERNEL_NAMES} \
            or sound["flash_fwd_shapes"] != [str(mp_local_heads(cfg, batch))]:
        fail(f"T rank {rank}: B1-B3 launches a step "
             f"{sound['flash_launches_per_step']} at "
             f"{sound['flash_fwd_shapes']}")
    out["T"] = {"sound": sound}
    out["T"]["fault_unreduced_proj"], _ = mp_arm(
        torch, fa, out_dir, rank, "t0", cfg, batch, 2, 1,
        fault=mp_fault_skip_reduce(cfg))
    out["T"]["run_steps_vs_run"] = mp_run_steps_gate(
        torch, cfg, batch, sound["losses"], p_sound)
    del p_sound
    cfg1 = mp_config(seq, MP_DROPOUT)
    out["T"]["dropout"], _ = mp_arm(torch, fa, out_dir, rank, "t1", cfg1,
                                    batch, 2, 1)
    out["T"]["fault_local_keying"], _ = mp_arm(
        torch, fa, out_dir, rank, "t1", cfg1, batch, 2, 1,
        fault=mp_fault_local_keying)
    # ---- SR / SU: sp 2 ----------------------------------------------------
    batch, seq = MP_S
    faults = {"ring": mp_fault_skip_rotation,
              "ulysses": mp_fault_ulysses_order}
    for mode in ("ring", "ulysses"):
        arm = {}
        for key, rate, fault in (("sound", 0.0, None),
                                 ("dropout", MP_DROPOUT, None),
                                 ("fault", 0.0, faults[mode])):
            cfg = mp_config(seq, rate, sp_mode=mode)
            arm[key], plans = mp_arm(
                torch, fa, out_dir, rank, "s1" if rate else "s0", cfg,
                batch, 1, 2, fault=fault, profile=key == "sound")
            log(f"mp rank {rank} {mode} {key}: losses {arm[key]['losses']}, "
                f"step ms {arm[key]['step_ms']}")
        out["SR" if mode == "ring" else "SU"] = arm
    with open(os.path.join(out_dir, f"mp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    log(f"mp rank {rank}: done")
    return 0


def mp_run_steps_gate(torch, cfg, batch, run_losses, run_params):
    """run_steps(3) at tp 2 from the startup weights against arm T's 3
    Executor.run calls (`run_losses`, `run_params`), bit for bit: the
    losses and every parameter, whole."""
    from paddle_tpu_torch.framework import Executor, Scope
    main, start, loss = build_mp(cfg, tp=2)
    toks = gpt_tokens(cfg, batch, MP_STEPS, seed=0)
    scope, exe = Scope(), Executor("cuda")
    exe.run(start, scope=scope)
    got, = exe.run_steps(MP_STEPS, main, feed={"tokens": toks},
                         fetch_list=[loss], scope=scope)
    losses = [float(x) for x in np.asarray(got).ravel()]
    params = mp_whole_params(torch, main, scope)
    differ = [n for n in params if not torch.equal(params[n], run_params[n])]
    if losses != run_losses or differ:
        fail(f"T: run_steps({MP_STEPS}) != {MP_STEPS} run() calls: losses "
             f"{losses} vs {run_losses}, parameters differing {differ[:5]}")
    del main, start, loss, scope, exe, params
    release(torch)
    return {"losses": losses, "parameters": len(run_params),
            "bitwise": True}


def check_flash_keying(torch, fa):
    """B1-B3's global-head keying on the card: a launch over heads 6-11
    with keying (0, 12, 6) against those heads of the full 12-head launch
    at dropout 0.1 (O, dQ, dK, dV bit for bit; f32 and bf16, causal and a
    key-padding mask); and the identity
    keying against the kernels built with the flat b*nh+h key (the
    `flat_keying` variant, the hash's key before the keying existed) on
    the phase-3 arms, bit for bit."""
    from paddle_tpu_torch.ops.kernels import flash_variants as fv
    B, nh, S, hd = MP_KEYING_SHAPE
    g = torch.Generator(device="cuda").manual_seed(7)
    base = [torch.randn((B, nh, S, hd), generator=g, device="cuda")
            for _ in range(4)]
    mask = padding_mask(torch, B, S, seed=2)
    out = {"shape": list(MP_KEYING_SHAPE), "slice": [6, 12], "arms": []}

    def grads(q, k, v, do, **kw):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fa.flash_attention(qq, kk, vv, **kw)
        return (o.detach(),) + torch.autograd.grad(o, (qq, kk, vv), do)

    for dtype, m, causal in (("float32", mask, False),
                             ("bfloat16", None, True)):
        dt = getattr(torch, dtype)
        q, k, v, do = (t.to(dt) for t in base)
        kw = dict(scale=1.0 / np.sqrt(hd), causal=causal,
                  dropout=MP_DROPOUT, seed=4321, mask=m)
        full = grads(q, k, v, do, **kw)
        sl = [t[:, 6:].contiguous() for t in (q, k, v, do)]
        part = grads(*sl, keying=(0, nh, 6), **kw)
        equal = all(torch.equal(a[:, 6:], b) for a, b in zip(full, part))
        wrong = grads(*sl, **kw)       # the launch's own heads: planted
        differs = not torch.equal(full[0][:, 6:], wrong[0])
        torch.cuda.synchronize()
        what = f"{dtype} causal={causal} mask={m is not None}"
        log(f"flash keying {what}: heads 6-11 keyed (0, 12, 6) bit-equal "
            f"to the full launch {equal}; unkeyed slice differs {differs}")
        if not equal:
            fail(f"flash keying {what}: the keyed head slice differs from "
                 f"the full launch")
        if not differs:
            fail(f"flash keying {what}: the slice keyed on its own heads "
                 f"draws the full launch's mask (the gate cannot see a "
                 f"wrong key)")
        out["arms"].append({"arm": what, "bitwise": equal,
                            "own_heads_differ": differs})
    # the identity keying against the flat key, on the phase-3 arms
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import paged_attention as pk
    from paddle_tpu_torch.ops.kernels import zero_update as zk
    load = _build.load
    libs = fv.build(["base", "flat_keying"])
    mask16 = padding_mask(torch, 16, 512, seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    t16 = [torch.randn((16, 12, 512, 64), generator=g, device="cuda")
           for _ in range(4)]
    same = []
    try:
        for dtype, m, causal, rate in (("float32", mask16, False, 0.1),
                                       ("bfloat16", mask16, False, 0.1),
                                       ("bfloat16", None, True, 0.1),
                                       ("float32", None, False, 0.0)):
            dt = getattr(torch, dtype)
            q, k, v, do = (t.to(dt) for t in t16)
            kw = dict(scale=0.125, causal=causal, dropout=rate,
                      seed=1234 if rate else None, mask=m)
            got = {}
            for name in ("base", "flat_keying"):
                fv._use(libs[name][0])
                got[name] = grads(q, k, v, do, **kw)
            eq = all(torch.equal(a, b) for a, b in zip(got["base"],
                                                       got["flat_keying"]))
            same.append({"arm": f"{dtype} mask={m is not None} "
                                f"causal={causal} dropout={rate}",
                         "bitwise": eq})
            if not eq:
                fail(f"flash keying: the identity keying differs from the "
                     f"flat key on {same[-1]['arm']}")
    finally:
        _build.load = load
        fa._lib = zk._lib = pk._lib = None
    out["identity_vs_flat_key"] = same
    release(torch)
    return out


# B1-B3's launches on the paths of phases 13-15, by shape: a rank's 6
# of 12 heads keyed (b_off, 12, h_off) at its dp and tp / sp coordinates,
# and the one-process references' 12 heads under the identity keying (0,
# 12, 0), which the wrapper hands the launch for keying=None
FLASH_PATH_CASES = (
    # T (phase 13) and L at tp 2: batch 8, dp 1
    ((8, 6, 512, 64), ((0, 12, 0), (0, 12, 6))),
    # SU (phase 13) and L at sp 2: batch 4, dp 1; ZS: batch 8 over dp 2
    ((4, 6, 1024, 64), ((0, 12, 0), (0, 12, 6), (4, 12, 0), (4, 12, 6))),
    # Z0-Z2: batch 8 over dp 2 at tp 2
    ((4, 6, 512, 64), ((0, 12, 0), (0, 12, 6), (4, 12, 0), (4, 12, 6))),
    # PT: microbatches of 2 at tp 2
    ((2, 6, 512, 64), ((0, 12, 0), (0, 12, 6))),
    # the one-process references: phase 13's T, SR / SU, and PT's GPipe
    ((8, 12, 512, 64), ((0, 12, 0),)),
    # phase 15: a dp-2 rank's 4 rows of 8 (LSGD, PEER) and the LocalSGD
    # simulation's half batches
    ((4, 12, 512, 64), ((0, 12, 0),)),
    ((4, 12, 1024, 64), ((0, 12, 0),)),
    ((2, 12, 512, 64), ((0, 12, 0),)),
)


@contextlib.contextmanager
def flash_spy(fa):
    """[(shape, keying)] of every B1 launch inside the block."""
    seen = []
    spied = fa.launch_fwd

    def spy(q, *a, **k):
        seen.append((tuple(q.shape), a[8] if len(a) > 8
                     else k.get("keying")))
        return spied(q, *a, **k)

    fa.launch_fwd = spy
    try:
        yield seen
    finally:
        fa.launch_fwd = spied


def launch_keys(seen):
    """The sorted `launch_key`s of `flash_spy`'s launches."""
    return sorted({launch_key(s, kg) for s, kg in seen})


def launch_key(shape, keying):
    """A B1 launch as "[B, nh, S, hd] keying" (`mp_run`'s spy, and the
    cases `check_flash_keyed_paths` held)."""
    return f"{list(shape)} " \
        f"{None if keying is None else [int(x) for x in keying]}"


def unchecked_launches(row, checked, where=""):
    """The B1 launches (`launch_key`) in `row`'s runs, at any depth, that
    no case of `checked` held against the plain version."""
    if isinstance(row, list):
        return [u for i, r in enumerate(row)
                for u in unchecked_launches(r, checked, f"{where}[{i}]")]
    if not isinstance(row, dict):
        return []
    out = [f"{where}: {k}" for k in row.get("flash_fwd_keyed", ())
           if k not in checked]
    for k, v in row.items():
        out += unchecked_launches(v, checked, f"{where}.{k}")
    return out


def check_flash_keyed_paths(torch, fa):
    """B1-B3 against their plain version at every shape and keying the
    paths of phases 13 and 14 launch them at (FLASH_PATH_CASES), f32 as
    fleet AMP hands them over, causal, dropout 0.1 with the seed in device
    memory: O, dQ, dK and dV held with FLASH_TOLERANCE. Then, at each
    shape's last keying, each launch alone (launch_fwd, launch_bwd_dq,
    launch_bwd_dkdv on prepared operands) timed beside its bound
    (`causal_flash_bounds`), the plain version and SDPA. Returns
    ({kernel: [numbers at each shape]}, the `launch_key`s held)."""
    out = {n: [] for n in fa.KERNEL_NAMES}
    checked = []
    g = torch.Generator(device="cuda").manual_seed(11)
    seed = fa.seed_tensor(4321, torch.device("cuda"))
    for shape, keyings in FLASH_PATH_CASES:
        B, nh, S, hd = shape
        scale = 1.0 / np.sqrt(hd)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                       for _ in range(4))
        errs = {n: [] for n in fa.KERNEL_NAMES}
        for keying in keyings:
            kw = dict(scale=scale, causal=True, dropout=MP_DROPOUT,
                      seed=seed, keying=keying)

            def run(fn):
                qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
                o = fn(qq, kk, vv, **kw)
                return (o.detach(),) + torch.autograd.grad(o, (qq, kk, vv),
                                                           do)

            got, want = run(fa.flash_attention), run(fa.flash_attention_plain)
            torch.cuda.synchronize()
            what = f"{list(shape)} f32 causal dropout {MP_DROPOUT} " \
                   f"keying {keying}"
            if not all(torch.isfinite(t).all() for t in got):
                fail(f"flash {what}: non-finite kernel output")
            pairs = {"flash_fwd": [(got[0], want[0])],
                     "flash_bwd_dq": [(got[1], want[1])],
                     "flash_bwd_dkdv": [(got[2], want[2]),
                                        (got[3], want[3])]}
            for name, ps in pairs.items():
                atol, rtol = FLASH_TOLERANCE["float32"][
                    "o" if name == "flash_fwd" else "grad"]
                err, need, p99, typical = flash_agreement(torch, ps, rtol)
                log(f"flash {name} {what}: |kernel - plain| max {err:.3e}, "
                    f"p99 {p99:.3e}; needs atol {need:.3e} beside rtol "
                    f"{rtol:.3g} (atol {atol:.1e})")
                if need > atol:
                    fail(f"{name} {what}: kernel disagrees with its plain "
                         f"version: |kernel - plain| exceeds {atol} + {rtol} "
                         f"* |plain| by up to {need - atol}")
                errs[name].append((err, need, p99, typical, atol, rtol))
            checked.append(launch_key(shape, keying))
            del got, want, pairs
        a = (q, k, v, None, None, seed, scale, True, MP_DROPOUT, keying)
        o, lse = fa.launch_fwd(*a)
        qa = (q, k, v, o, lse, do) + a[3:]
        delta = fa.launch_bwd_dq(*qa)[1]
        ka = (q, k, v, delta, lse, do) + a[3:]
        ms = {"flash_fwd": cuda_ms(torch, lambda: fa.launch_fwd(*a)),
              "flash_bwd_dq": cuda_ms(torch, lambda: fa.launch_bwd_dq(*qa)),
              "flash_bwd_dkdv": cuda_ms(
                  torch, lambda: fa.launch_bwd_dkdv(*ka))}
        with torch.no_grad():
            plain = {"flash_fwd": cuda_ms(
                torch, lambda: fa.flash_attention_plain(q, k, v, **kw),
                iters=5, warmup=1)}
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        op = fa.flash_attention_plain(qq, kk, vv, **kw)
        plain["flash_bwd_dq"] = cuda_ms(torch, lambda: torch.autograd.grad(
            op, qq, do, retain_graph=True), iters=5, warmup=1)
        plain["flash_bwd_dkdv"] = cuda_ms(
            torch, lambda: torch.autograd.grad(op, (kk, vv), do,
                                               retain_graph=True),
            iters=5, warmup=1)
        # the library call on the same inputs: SDPA causal f32 (dropout
        # 0.1), forward, and backward for the three gradients (B2 + B3)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with torch.no_grad():
            lib_fwd = cuda_ms(torch, lambda: sdpa(
                q, k, v, is_causal=True, dropout_p=MP_DROPOUT, scale=scale))
        os_ = sdpa(qq, kk, vv, is_causal=True, dropout_p=MP_DROPOUT,
                   scale=scale)
        lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
            os_, (qq, kk, vv), do, retain_graph=True))
        del os_
        bounds = causal_flash_bounds(B, nh, S, hd)
        for name, es in errs.items():
            bound, bound_by = bounds[name]
            worst = max(es, key=lambda e: e[1])
            err, need, p99, typical, atol, rtol = worst
            out[name].append(dict(
                shape=list(shape), dtype="float32", causal=True,
                dropout=MP_DROPOUT,
                keyings=[None if kg is None else list(kg) for kg in keyings],
                timed_keying=None if keying is None else list(keying),
                max_abs_err=max(e[0] for e in es), p99_abs_err=p99,
                atol_needed=need, atol=atol, rtol=rtol,
                median_abs_plain=typical, ms=ms[name], plain_ms=plain[name],
                bound_ms=bound, bound_by=bound_by,
                bound_rate=CAUSAL_BOUND_RATE,
                library_ms=lib_fwd if name == "flash_fwd" else lib_bwd,
                library_call="SDPA is_causal=True dropout_p=0.1 f32 "
                             + ("forward" if name == "flash_fwd"
                                else "backward (covers B2+B3)")))
            log(f"flash {name} {list(shape)} keying {keying}: alone "
                f"{ms[name]:.4f} ms, plain {plain[name]:.4f} ms, bound "
                f"{bound:.4f} ms ({bound_by}), SDPA "
                f"{out[name][-1]['library_ms']:.4f} ms")
        del op, qq, kk, vv, q, k, v, do, o, lse, delta
        release(torch)
    return out, checked


def train_gpt_model_parallel(torch, fa, card):
    """Phase 13: the B1-B3 keying checks, the one-process references, then
    arms T, SR and SU in one gang of two ranks on cuda:0 under gloo."""
    import tempfile
    t0 = time.perf_counter()
    row = {"card": card,
           "config": "GPTConfig() (hidden 768, 12 heads, vocab 50257) "
                     f"cut to {MP_LAYERS} layers, fleet AMP bf16, "
                     "Adam(1e-4), ZeRO stage 0, weights from the startup "
                     "program, tokens from numpy seed 0; arm T "
                     "tp 2 at batch 8 (cut from 32: gloo's host traffic), S "
                     "512; arms SR / SU sp 2 at batch 4, S 1024"}
    row["flash_keying"] = check_flash_keying(torch, fa)
    row["flash_keyed_paths"], row["flash_checked_launches"] = \
        check_flash_keyed_paths(torch, fa)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    refs = mp_references(torch, fa, out_dir)
    env = dict(os.environ, PADDLE_DIST_BACKEND="gloo",
               PADDLE_DIST_DEVICE="cuda:0", CHIP_SMOKE_MP_OUT=out_dir)
    t1 = time.perf_counter()
    rc, text = launch_gang(["--mp-worker"], env, 900, "mp_gang.log")
    gang_s = time.perf_counter() - t1
    if rc != 0:
        fail(f"the phase-13 gang failed (rc {rc}): {text[-3000:]}")
    ranks = []
    for r in range(MP_WORLD):
        with open(os.path.join(out_dir, f"mp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil_rm(out_dir)
    row.update(mp_judge(fa, refs, ranks, row["flash_checked_launches"]))
    row.update({"references": refs, "ranks": ranks, "gang_s": gang_s,
                "launch": "python -m paddle_tpu_torch.distributed.launch "
                          "--nproc_per_node 2 chip_smoke.py --mp-worker, "
                          "PADDLE_DIST_BACKEND=gloo "
                          "PADDLE_DIST_DEVICE=cuda:0",
                "phase_s": time.perf_counter() - t0})
    return row


def mp_judge(fa, refs, ranks, checked):
    """Phase 13's gates over the references and the gang's ranks: each
    arm within MP_LOSS_RTOL (losses) and MP_CHANGE_RTOL (the parameters'
    change) of its one-process reference, each planted fault outside one
    of them, the ranks' losses equal, B1-B3 launched on the Ulysses path
    at the rank's heads and only at shapes and keyings `checked` held
    against the plain version, the ring's permutes and Ulysses'
    all-to-alls."""
    r0 = ranks[0]
    gates = {}
    unheld = unchecked_launches({"references": refs, "ranks": ranks},
                                set(checked))
    if unheld:
        fail(f"phase 13: B1 launched at shapes or keyings no check held "
             f"against the plain version: {unheld[:8]}")

    def gate(name, arm, ref, fault=None, fault_limit_loss=None):
        loss_rel = mp_loss_rel(arm["losses"], ref["losses"])
        g = {"loss_max_rel": loss_rel, "change_rel": arm["change_rel"],
             "params_norm_rel": arm["params_norm_rel"]}
        ok = loss_rel <= MP_LOSS_RTOL and arm["change_rel"] <= MP_CHANGE_RTOL
        if fault is not None:
            g["fault_loss_max_rel"] = mp_loss_rel(fault["losses"],
                                                  ref["losses"])
            g["fault_change_rel"] = fault["change_rel"]
            seen = (g["fault_change_rel"] > MP_CHANGE_RTOL
                    or g["fault_loss_max_rel"] > MP_LOSS_RTOL)
            g["fault_seen"] = seen
            if not seen:
                fail(f"phase 13 {name}: the planted fault reads inside the "
                     f"limits {g}")
        log(f"phase 13 {name}: {g}")
        if not ok:
            fail(f"phase 13 {name}: outside the limits (losses "
                 f"{MP_LOSS_RTOL}, change {MP_CHANGE_RTOL}): {g}")
        gates[name] = g

    for r in ranks[1:]:
        for arm in ("T", "SR", "SU"):
            if r[arm]["sound"]["losses"] != r0[arm]["sound"]["losses"]:
                fail(f"phase 13 {arm}: the ranks fetch different losses")
    gate("T", r0["T"]["sound"], refs["t0"], r0["T"]["fault_unreduced_proj"])
    gate("T dropout", r0["T"]["dropout"], refs["t1"],
         r0["T"]["fault_local_keying"])
    for arm in ("SR", "SU"):
        gate(arm, r0[arm]["sound"], refs["s0"], r0[arm]["fault"])
        gate(f"{arm} dropout", r0[arm]["dropout"], refs["s1"])
    for arm in ("SR", "SU"):
        calls = r0[arm]["sound"]["collectives_last_step"]
        log(f"phase 13 {arm} DTensor collectives of a step: {calls}")
    # M: sp holds a rank's part of the sequence outside attention too, so
    # Ulysses peaks below one process at S 1024, batch 4 (the ring's f32
    # score blocks may keep it above)
    # (also read above what each held when its steps began: the weights
    # and Adam state, and in this process what earlier phases left)
    def peak(row):
        return {"peak": row["peak_memory_bytes"],
                "above_start": row["peak_memory_bytes"]
                - row["memory_at_start_bytes"]}

    memory = {"one_process": peak(refs["s0"])}
    for arm in ("SR", "SU"):
        memory[arm] = [peak(r[arm]["sound"]) for r in ranks]
    log(f"phase 13 M peak memory a rank (bytes): {memory}")
    for key in ("peak", "above_start"):
        if max(m[key] for m in memory["SU"]) >= memory["one_process"][key]:
            fail(f"phase 13 M: SU's {key} memory a rank "
                 f"{[m[key] for m in memory['SU']]} is not below one "
                 f"process's {memory['one_process'][key]}")
    gates["M_peak_memory_bytes"] = memory
    cfg = mp_config(MP_S[1], 0.0)
    L = cfg.num_layers
    su = r0["SU"]["sound"]
    if su["flash_launches_per_step"] != {n: L for n in fa.KERNEL_NAMES} \
            or su["flash_fwd_shapes"] != [str(mp_local_heads(cfg, MP_S[0]))]:
        fail(f"SU: B1-B3 launches a step {su['flash_launches_per_step']} at "
             f"{su['flash_fwd_shapes']}")
    # a ring step at sp 2: one permute of K and one of V a layer forward,
    # their inverses backward; Ulysses: q, k, v and back a layer forward,
    # the inverses backward
    for arm, op, want in (("SR", "ppermute", 4 * L),
                          ("SU", "all_to_all", 8 * L)):
        got = r0[arm]["sound"]["calls_last_step"].get(f"{op}.calls")
        if got != want:
            fail(f"{arm}: {got} {op} calls in a step, want {want}")
    return {"gates": gates,
            "tp_plan": {f"{k[0]} {k[1]} {k[2]}": v for k, v in
                        mp_plan_tp(mp_config(MP_T[1], 0.0),
                                   MP_T[0]).items()}}


# ---------------------------------------------------------------------------
# Phase 14: composed meshes
# ---------------------------------------------------------------------------

CM_STEPS = 3
CM_Z = (8, 512)            # Z1, Z2: global batch and sequence
CM_ZS = (8, 1024)          # ZS: dp 2 x sp 2 (Ulysses)
CM_L_TP = (8, 512)         # L at tp 2
CM_L_SP = (4, 1024)        # L at sp 2 (Ulysses)
CM_PT = (8, 512)           # PT: pp 2 x tp 2, GPipe on one stage at tp 2
CM_MICRO = 4
CM_DROPOUT = 0.1
CM_RTOL = 1e-4             # PT's losses against one process's GPipe
CM_REMAT_LOSS_RTOL = 1e-5  # L's remat arm: losses against unrolled
# stage 1's optimizer state a rank against the whole state (every moment of
# every parameter on each rank, as the reference's stage 0 holds it)
CM_STATE_SHARE = 0.55
CM_PP_DEVICES = ("cuda:0", "cuda:0")


def cm_config(seq, sp_mode=None, pp=0):
    """mp_config at `seq` with dropout 0.1, `sp_mode` sequence
    parallelism and `pp` device_guard stages."""
    cfg = mp_config(seq, CM_DROPOUT, sp_mode)
    cfg.pipeline_stages = pp
    return cfg


def build_cm(cfg, tp=1, sp=1, stage=0, layer_scan=False, remat=False,
             micro=0, pp_devices=None):
    """(main, startup, loss) of GPT LM training through fleet (AMP bf16,
    Adam(1e-4)) at `tensor_parallel_degree` tp (GPT's Megatron rules),
    `sequence_parallel_degree` sp and ZeRO `stage`; `layer_scan` rolls the
    layers, with `remat` (fleet's recompute) re-running each in the
    backward; `micro` microbatches through PipelineOptimizer, over
    `pp_devices` stages when given."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import Program, program_guard, unique_name
    from paddle_tpu_torch.models import gpt
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard(), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, loss = gpt.build_lm_program(cfg)
        fleet.init(is_collective=True)
        s = fleet.DistributedStrategy()
        s.amp = True
        s.tensor_parallel_degree = tp
        s.sequence_parallel_degree = sp
        if tp > 1:
            s.tensor_parallel_rules = gpt.tp_sharding_rules()
        s.sharding_stage = stage
        if layer_scan:
            s.layer_scan = True
        if remat:
            s.recompute = True
            s.recompute_configs = {"checkpoints": loss._layer_checkpoints}
        if micro:
            s.pipeline = True
            s.pipeline_configs = {"accumulate_steps": micro}
            if pp_devices:
                s.pipeline_parallel_degree = len(pp_devices)
                s.pipeline_configs["stage_devices"] = list(pp_devices)
        fleet.distributed_optimizer(optimizer.Adam(learning_rate=MP_LR),
                                    s).minimize(loss)
    return main, start, loss


def cm_bucket_shards(cfg, dp=2):
    """The shard widths of a stage-1 program's flat buckets at dp: what
    B8 takes a launch on a dp x tp / dp x sp mesh (the buckets do not
    depend on the mesh)."""
    from paddle_tpu_torch.parallel import zero
    main, _, _ = build_cm(cfg, stage=1)
    return [int(b["padded"]) // dp for b in zero.zero_buckets(main)]


def cm_compare(torch, got, want, start):
    """Two {name: host tensor} dicts of final parameters from the same
    `start`: bitwise equal or not, max over the parameters of max |a - b|
    / max |b|, and `mp_readings` (the norm of the difference over the
    norm of `want`'s change from the start)."""
    if sorted(got) != sorted(want):
        fail(f"phase 14: parameter sets differ: "
             f"{sorted(set(got) ^ set(want))[:5]}")
    return dict(mp_readings(torch, got, want, start),
                bitwise=not params_differ(torch, got, want),
                param_max_rel=max(rel_diff(torch, got[n], want[n])
                                  for n in want))


def cm_gate(name, got, want, cmp, loss_rtol=None, change_rtol=None,
            fault=None, fault_cmp=None):
    """Losses and parameters of arm `got` against `want`: equal bit for
    bit (`loss_rtol` None), else losses within `loss_rtol` relative and
    the parameters' change within `change_rtol` (`mp_readings`). The
    planted `fault` arm (`fault_cmp`: its parameters against `want`'s)
    must read outside the same gate."""
    def reading(row, c):
        loss_rel = mp_loss_rel(row["losses"], want["losses"])
        g = dict(c, loss_max_rel=loss_rel,
                 losses_equal=row["losses"] == want["losses"])
        g["inside"] = (g["bitwise"] and g["losses_equal"]) \
            if loss_rtol is None else (loss_rel <= loss_rtol
                                       and c["change_rel"] <= change_rtol)
        return g

    limit = "bit for bit" if loss_rtol is None else \
        f"losses {loss_rtol}, change {change_rtol}"
    g = reading(got, cmp)
    if fault is not None:
        g["fault"] = reading(fault, fault_cmp)
    log(f"phase 14 {name} ({limit}): {g}")
    if not g["inside"]:
        fail(f"phase 14 {name}: outside its gate ({limit}): {g}")
    if fault is not None and g["fault"]["inside"]:
        fail(f"phase 14 {name}: the planted fault reads inside the gate "
             f"({limit}): {g['fault']}")
    return g


def cm_fault_dp_sum():
    """Planted fault: the ZeRO update takes the dp SUM of the gradients
    (twice the mean at dp 2), which Adam's scale-free step turns into a
    change far below any loose tolerance."""
    from paddle_tpu_torch.parallel import zero
    rule = zero._apply_update_rule

    def summed(ctx, op_type, ins, attrs):
        return rule(ctx, op_type, dict(ins, Grad=[2 * ins["Grad"][0]]),
                    attrs)
    return mp_patch(zero, "_apply_update_rule", summed)


def cm_fault_layer_masks():
    """Planted fault: the layer scan tapes layer i with layer i+1's
    dropout masks: the rolled forward, and with remat only the re-run
    before each layer's pullbacks."""
    from paddle_tpu_torch.parallel import transforms

    def taped_layer(self, i, carry, reach):
        env = self.env(i, carry)
        tape = self.body.taped(self.ctx, env, reach,
                               layer=(i + 1) % self.n_layers)
        return env[self.carry_out], tape
    return mp_patch(transforms._Scan, "taped_layer", taped_layer)


def cm_fault_last_microbatch():
    """Planted fault: the pipeline's last microbatch replaced by the one
    before it (a quarter of the rows trained twice, one never)."""
    from paddle_tpu_torch.framework import executor
    split = executor._split_feeds

    def repeated(feeds, k):
        parts = split(feeds, k)
        return parts[:-1] + [parts[-2]]
    return mp_patch(executor, "_split_feeds", repeated)


def cm_worker():
    """One rank of a phase-14 gang (`chip_smoke.py --cm-worker`, started by
    the port's launcher, every rank on cuda:0 under gloo). $CHIP_SMOKE_CM
    _GANG names the gang: "z", 4 ranks, dp 2 x tp 2 at ZeRO stages 0, 1,
    2 (Z1, Z2) and dp 2 x sp 2 (Ulysses) at stages 0 and 1 (ZS); "lp", 2
    ranks, layer scan at tp 2 and at sp 2 (L) and pp 2 x tp 2 (PT). Each
    rank gates its own arms and writes cm_<gang>_rank<r>.json under
    $CHIP_SMOKE_CM_OUT."""
    import faulthandler
    import torch
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.distributed import fleet, parallel
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import zero_update as zk

    faulthandler.enable(all_threads=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gang = os.environ["CHIP_SMOKE_CM_GANG"]
    fleet.init(is_collective=True)
    rank, world = parallel.get_rank(), parallel.get_world_size()
    want_world = 4 if gang == "z" else 2
    if world != want_world or parallel.backend() != "gloo" \
            or parallel.rank_device() != torch.device("cuda", 0):
        fail(f"cm rank {rank}: expected gloo on cuda:0 at {want_world} "
             f"ranks")
    out_dir = os.environ["CHIP_SMOKE_CM_OUT"]
    out = {"rank": rank, "gang": gang}

    def arm(name, cfg, batch, fault=None, **kw):
        main, start, loss = build_cm(cfg, **kw)
        toks = gpt_tokens(cfg, batch, CM_STEPS, seed=0)
        with (fault() if fault else contextlib.nullcontext()):
            row, p0, p1, _ = mp_run(torch, fa, main, start, loss, toks,
                                    zk=zk)
        log(f"cm rank {rank} {name}: losses {row['losses']}, step ms "
            f"{row['step_ms']}, peak {row['peak_memory_bytes']}, state "
            f"{row['state_bytes']['state_bytes_per_device']}")
        del main, start, loss
        return row, p0, p1

    if gang == "z":
        # stage k against stage 0 on the same mesh, bit for bit (as at dp
        # alone); the planted fault (the dp sum) once a mesh
        for mesh, (batch, seq), sp_mode, kw, stages in (
                ("Z", CM_Z, None, {"tp": 2}, (1, 2)),
                ("ZS", CM_ZS, "ulysses", {"sp": 2}, (1,))):
            cfg = cm_config(seq, sp_mode)
            z0, s0, p0 = arm(f"{mesh}0", cfg, batch, stage=0, **kw)
            out[f"{mesh}0"] = z0
            fault, pf = arm(f"{mesh}1 fault dp sum", cfg, batch, stage=1,
                            fault=cm_fault_dp_sum, **kw)[::2]
            fault_cmp = cm_compare(torch, pf, p0, s0)
            del pf
            for stage in stages:
                row, s, p = arm(f"{mesh}{stage}", cfg, batch, stage=stage,
                                **kw)
                if params_differ(torch, s, s0):
                    fail(f"phase 14 {mesh}{stage}: the startup weights "
                         f"differ from stage 0's")
                row["gate"] = cm_gate(
                    f"{mesh}{stage} rank {rank}", row, z0,
                    cm_compare(torch, p, p0, s0),
                    fault=fault if stage == 1 else None,
                    fault_cmp=fault_cmp)
                out[f"{mesh}{stage}"] = row
                del s, p
            del s0, p0
    else:
        for name, (batch, seq), kw in (
                ("L_tp", CM_L_TP, {"tp": 2}),
                ("L_sp", CM_L_SP, {"sp": 2})):
            cfg = cm_config(seq, "ulysses" if "sp" in kw else None)
            un, su, pu = arm(f"{name} unrolled", cfg, batch, **kw)
            ro, _, pr = arm(f"{name} rolled", cfg, batch, layer_scan=True,
                            **kw)
            # the planted fault once a gate: the masks at tp 2 (rolled,
            # bit for bit), and in the re-run of remat at sp 2
            fault = fault_cmp = None
            if "tp" in kw:
                fault, _, pf = arm(f"{name} rolled fault masks", cfg, batch,
                                   layer_scan=True,
                                   fault=cm_fault_layer_masks, **kw)
                fault_cmp = cm_compare(torch, pf, pu, su)
                del pf
            ro["gate"] = cm_gate(f"{name} rank {rank}", ro, un,
                                 cm_compare(torch, pr, pu, su), fault=fault,
                                 fault_cmp=fault_cmp)
            out[f"{name}_unrolled"], out[f"{name}_rolled"] = un, ro
            del pr
            if "sp" in kw:
                # remat re-runs each layer's forward in the backward: on
                # the card not bit-equal to the taped step, even in one
                # process (the bias and LN-bias gradients' last bits), so
                # its losses are held within 1e-5 and the parameters'
                # change as phase 12's arm SR holds it
                rm, _, pm = arm(f"{name} rolled remat", cfg, batch,
                                layer_scan=True, remat=True, **kw)
                fault, _, pf = arm(f"{name} rolled remat fault masks", cfg,
                                   batch, layer_scan=True, remat=True,
                                   fault=cm_fault_layer_masks, **kw)
                rm["gate"] = cm_gate(
                    f"{name} remat rank {rank}", rm, un,
                    cm_compare(torch, pm, pu, su), CM_REMAT_LOSS_RTOL,
                    MP_CHANGE_RTOL, fault, cm_compare(torch, pf, pu, su))
                out[f"{name}_remat"] = rm
                del pm, pf
            del pu
        batch, seq = CM_PT
        gp, g0, pg = arm("PT gpipe", cm_config(seq), batch, tp=2,
                         micro=CM_MICRO)
        pp, s0, pp1 = arm("PT pp2", cm_config(seq, pp=2), batch, tp=2,
                          micro=CM_MICRO, pp_devices=CM_PP_DEVICES)
        fault, _, pf = arm("PT pp2 fault microbatch", cm_config(seq, pp=2),
                           batch, tp=2, micro=CM_MICRO,
                           pp_devices=CM_PP_DEVICES,
                           fault=cm_fault_last_microbatch)
        pp["gate"] = cm_gate(f"PT rank {rank}", pp, gp,
                             cm_compare(torch, pp1, pg, g0), fault=fault,
                             fault_cmp=cm_compare(torch, pf, pg, g0))
        out["PT_gpipe"], out["PT_pp2"] = gp, pp
        if rank == 0:
            ref = torch.load(os.path.join(out_dir, "pt_one.pt"))
            start = torch.load(os.path.join(out_dir, "pt_one_start.pt"))
            if params_differ(torch, s0, start):
                fail("phase 14 PT: the startup weights differ from the "
                     "one-process reference's")
            with open(os.path.join(out_dir, "pt_one.json")) as f:
                one = json.load(f)
            pp["vs_one_process"] = cm_gate(
                "PT vs one process", pp, one,
                cm_compare(torch, pp1, ref, start), CM_RTOL, MP_CHANGE_RTOL,
                fault, cm_compare(torch, pf, ref, start))
    with open(os.path.join(out_dir, f"cm_{gang}_rank{rank}.json"),
              "w") as f:
        json.dump(out, f)
    log(f"cm rank {rank} gang {gang}: done")
    return 0


def cm_judge(fa, zk, ranks_z, ranks_lp, widths, one, checked):
    """Phase 14's gates over the gangs' ranks and the one-process GPipe
    run `one`: the ranks' losses equal, the state bytes a rank at stage 1
    (the dp half of the whole), B8's launches at stages 1 and 2 (one a
    bucket and step), B1 once a layer and step rolled, twice with remat,
    B2 and B3 once, and B1 launched only at shapes and keyings `checked`
    held against the plain version."""
    cfg = cm_config(CM_Z[1])
    L = cfg.num_layers
    unheld = unchecked_launches({"ranks_z": ranks_z, "ranks_lp": ranks_lp,
                                 "pt_one_process": one}, set(checked))
    if unheld:
        fail(f"phase 14: B1 launched at shapes or keyings no check held "
             f"against the plain version: {unheld[:8]}")
    for ranks in (ranks_z, ranks_lp):
        r0 = ranks[0]
        for r in ranks[1:]:
            for k, v in r0.items():
                if isinstance(v, dict) and "losses" in v \
                        and r[k]["losses"] != v["losses"]:
                    fail(f"phase 14 {k}: the ranks fetch different losses")
    z0 = ranks_z[0]
    whole = 2 * 4 * gpt_param_elements(cfg)  # two Adam moments, f32, whole
    state = {}
    for arm, base in (("Z1", "Z0"), ("Z2", "Z0"), ("ZS1", "ZS0")):
        got = z0[arm]["state_bytes"]
        flat = got["flat_state_bytes_per_device"]
        want_flat = 2 * 4 * sum(widths)
        state[arm] = {"state_bytes": got["state_bytes_per_device"],
                      "stage0_state_bytes": z0[base]["state_bytes"][
                          "state_bytes_per_device"],
                      "whole_state_bytes": whole,
                      "share_of_whole": got["state_bytes_per_device"]
                      / whole}
        state[arm]["share_of_stage0"] = state[arm]["state_bytes"] \
            / state[arm]["stage0_state_bytes"]
        if flat != want_flat or state[arm]["share_of_whole"] \
                > CM_STATE_SHARE:
            fail(f"phase 14 {arm}: flat state {flat} bytes a rank (want the "
                 f"dp half {want_flat}), {state[arm]}")
        if z0[arm]["b8_launches"] != len(widths) * CM_STEPS:
            fail(f"phase 14 {arm}: B8 launched {z0[arm]['b8_launches']} "
                 f"times, want {len(widths)} buckets x {CM_STEPS} steps")
    r0 = ranks_lp[0]
    for arm, fwd in (("L_tp_rolled", 1), ("L_sp_rolled", 1),
                     ("L_sp_remat", 2)):
        want = {"flash_fwd": fwd * L * CM_STEPS,
                "flash_bwd_dq": L * CM_STEPS,
                "flash_bwd_dkdv": L * CM_STEPS}
        if r0[arm]["flash_launches"] != want:
            fail(f"phase 14 {arm}: B1-B3 launches "
                 f"{r0[arm]['flash_launches']}, want {want}")
    for arm in ("Z1", "ZS1"):
        if any(not n for n in z0[arm]["flash_launches"].values()):
            fail(f"phase 14 {arm}: a flash kernel was never launched")
    return {"state": state}


def train_gpt_composed(torch, fa, zk, card, checked):
    """Phase 14: B8 at the shard width, the one-process GPipe reference,
    then the "z" gang (4 ranks) and the "lp" gang (2 ranks), all on
    cuda:0 under gloo; `checked` are the B1 launches phase 13's
    `check_flash_keyed_paths` held."""
    import tempfile
    t0 = time.perf_counter()
    row = {"card": card,
           "config": "GPTConfig() (hidden 768, 12 heads, vocab 50257) "
                     f"cut to {MP_LAYERS} layers, dropout 0.1, fleet AMP "
                     "bf16, Adam(1e-4), weights from the startup program, "
                     "tokens from numpy seed 0, 3 eager steps an arm; "
                     "Z1/Z2 dp 2 x tp 2 batch 8 S 512; ZS dp 2 x sp 2 "
                     "(Ulysses) batch 8 S 1024; L tp 2 batch 8 S 512 and "
                     "sp 2 (Ulysses) batch 4 S 1024, "
                     "rolled against unrolled, and at sp 2 rolled with "
                     "remat; PT pp 2 x tp 2 batch 8 S 512, 4 "
                     "microbatches, both stages on cuda:0"}
    widths = cm_bucket_shards(cm_config(CM_Z[1]))
    row["b8_shard_widths"] = widths
    row["b8_shard"] = check_b8_shard(torch, zk, max(widths), op="adam")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cm_")
    # the one-process GPipe reference of arm PT
    batch, seq = CM_PT
    cfg = cm_config(seq)
    main, start, loss = build_cm(cfg, micro=CM_MICRO)
    one, s0, p1, _ = mp_run(torch, fa, main, start, loss,
                            gpt_tokens(cfg, batch, CM_STEPS, seed=0), zk=zk)
    torch.save(s0, os.path.join(out_dir, "pt_one_start.pt"))
    torch.save(p1, os.path.join(out_dir, "pt_one.pt"))
    with open(os.path.join(out_dir, "pt_one.json"), "w") as f:
        json.dump(one, f)
    row["pt_one_process"] = one
    del main, start, loss, s0, p1
    release(torch)
    gangs = {}
    for gang, nproc in (("z", 4), ("lp", 2)):
        env = dict(os.environ, PADDLE_DIST_BACKEND="gloo",
                   PADDLE_DIST_DEVICE="cuda:0", CHIP_SMOKE_CM_OUT=out_dir,
                   CHIP_SMOKE_CM_GANG=gang)
        t1 = time.perf_counter()
        rc, text = launch_gang(["--cm-worker"], env, 900,
                               f"cm_{gang}_gang.log", nproc=nproc)
        row[f"gang_{gang}_s"] = time.perf_counter() - t1
        if rc != 0:
            fail(f"the phase-14 gang {gang} failed (rc {rc}): "
                 f"{text[-3000:]}")
        gangs[gang] = []
        for r in range(nproc):
            with open(os.path.join(out_dir, f"cm_{gang}_rank{r}.json")) as f:
                gangs[gang].append(json.load(f))
    shutil_rm(out_dir)
    row.update(cm_judge(fa, zk, gangs["z"], gangs["lp"], widths, one,
                        checked))
    row.update({"ranks_z": gangs["z"], "ranks_lp": gangs["lp"],
                "launch": "python -m paddle_tpu_torch.distributed.launch "
                          "--nproc_per_node 4 (gang z) / 2 (gang lp) "
                          "chip_smoke.py --cm-worker, PADDLE_DIST_BACKEND="
                          "gloo PADDLE_DIST_DEVICE=cuda:0",
                "phase_s": time.perf_counter() - t0})
    return row


# ---------------------------------------------------------------------------
# Phase 15: the supervised gang (LocalSGD, peer snapshots, pod dumps,
# serving workers under the launcher)
# ---------------------------------------------------------------------------

SG_WORLD = 2
SG_BATCH = 8               # the global batch: a dp-2 rank trains on 4 rows
SG_SEQ = 512
SG_LSGD_STEPS = 8
SG_LSGD_K = 4
SG_PEER_STEPS = 6
SG_SNAPSHOT_STEPS = 3      # PEER's cadence: the snapshot of tag 3 (3 steps)
SG_LR = 1e-4
# phase 4's bf16 engine geometry, the workers' and the in-process engine's
SG_SERVE = dict(dtype="bfloat16", max_slots=8, max_len=256, window=8,
                block_size=16, num_blocks=160)
SG_DRAIN_COPIES = 6        # the SIGTERM gang serves phase 4's 8 prompts 6x
SG_GRACE_S = 40            # PEER's SIGTERM-to-SIGKILL grace (its flush)


def sg_config():
    """GPT-2 small's width at MP_LAYERS layers, S 512, dropout 0."""
    return mp_config(SG_SEQ, 0.0)


def build_lsgd(cfg, k):
    """(main, startup, loss): fleet AMP bf16, Adam(SG_LR), LocalSGD every
    `k` steps; k 0 builds the same ops without LocalSGD and without the
    bucket pass (a LocalSGD program takes none): the simulation's."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import Program, program_guard, unique_name
    from paddle_tpu_torch.models import gpt
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard():
        _, loss = gpt.build_lm_program(cfg)
        fleet.init(is_collective=True)
        s = fleet.DistributedStrategy()
        s.amp = True
        if k:
            s.localsgd, s.localsgd_configs = True, {"k_steps": k}
        else:
            s.fuse_grad_size_in_mb = 0
        fleet.distributed_optimizer(optimizer.Adam(learning_rate=SG_LR),
                                    s).minimize(loss)
    return main, start, loss


def sg_lsgd_arm(torch, fa):
    """LSGD on this rank: SG_LSGD_STEPS steps of the global batch, LocalSGD
    every SG_LSGD_K; gates that the scope holds the synced view between
    syncs (and the copies move), and that a sync writes the copies'
    average back."""
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.resilience import fingerprint
    cfg = sg_config()
    main, start, loss = build_lsgd(cfg, SG_LSGD_K)
    toks = gpt_tokens(cfg, SG_BATCH, SG_LSGD_STEPS, seed=0)
    scope, exe = Scope(), Executor("cuda")
    exe.run(start, scope=scope)
    names = [p.name for p in main.all_parameters()]
    view = {n: scope.find(n).detach().clone() for n in names}
    fa.reset_launches()
    steps = []
    with flash_spy(fa) as keyed:
        for s, b in enumerate(toks):
            coll.reset_counters()
            t0 = time.perf_counter()
            got, = exe.run(main, feed={"tokens": b}, fetch_list=[loss],
                           scope=scope)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            sync = (s + 1) % SG_LSGD_K == 0
            held = all(torch.equal(scope.find(n), view[n]) for n in names)
            copies = {n: scope.find(n + "@LOCALSGD") for n in names}
            if sync:
                if held or not all(torch.equal(scope.find(n), copies[n])
                                   for n in names):
                    fail(f"LSGD step {s}: the sync did not write the "
                         f"copies' average into the scope's view")
                view = {n: scope.find(n).detach().clone() for n in names}
            elif not held or all(torch.equal(copies[n], view[n])
                                 for n in names):
                fail(f"LSGD step {s} (local): the scope lost the synced "
                     f"view ({not held}) or the copies did not move")
            steps.append({"sync": sync, "loss": float(got), "ms": ms,
                          "gloo_host_ms": sum(coll.host_ms.values()),
                          "calls": {k: v for k, v in coll.counters.items()
                                    if k.endswith(".calls")}})
    local = [r["ms"] for r in steps if not r["sync"]]
    synced = [r for r in steps if r["sync"]]
    return {"losses": [r["loss"] for r in steps], "steps": steps,
            "step_ms_p50_local": float(np.median(local)),
            "step_ms_p50_sync": float(np.median([r["ms"] for r in synced])),
            "gloo_host_ms_sync": [r["gloo_host_ms"] for r in synced],
            "gloo_host_ms_local": [r["gloo_host_ms"] for r in steps
                                   if not r["sync"]],
            "fingerprint": fingerprint(main, scope),
            "flash_launches": dict(fa.launches),
            "flash_fwd_keyed": launch_keys(keyed),
            "marker_plan": exe._collective_marker_plan(main)}


def sg_simulation(torch, fa, params_only=False):
    """The one-process simulation of LSGD on the card: two scopes from one
    startup state, each on its half of every global batch, the floating
    written state of both averaged ((a + b) / 2) every SG_LSGD_K steps;
    `params_only` (the planted fault) averages only the parameters.
    Returns the losses (the halves' mean), the first scope's fingerprint
    and the B1 launch keys."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.framework.executor import _written_persistables
    from paddle_tpu_torch.resilience import fingerprint
    cfg = sg_config()
    main, start, loss = build_lsgd(cfg, 0)
    toks = gpt_tokens(cfg, SG_BATCH, SG_LSGD_STEPS, seed=0)
    exe, a = Executor("cuda"), Scope()
    exe.run(start, scope=a)
    b = scope_copy(torch, a)
    written = _written_persistables(main.global_block())
    params = {p.name for p in main.all_parameters()}
    half = SG_BATCH // SG_WORLD
    losses = []
    with flash_spy(fa) as keyed:
        for s, t in enumerate(toks):
            la, = exe.run(main, feed={"tokens": t[:half]}, fetch_list=[loss],
                          scope=a, return_numpy=False)
            lb, = exe.run(main, feed={"tokens": t[half:]}, fetch_list=[loss],
                          scope=b, return_numpy=False)
            losses.append(float((la + lb) / SG_WORLD))
            if (s + 1) % SG_LSGD_K:
                continue
            with torch.no_grad():
                for n in written:
                    ta, tb = a.find(n), b.find(n)
                    if not ta.is_floating_point() or (params_only
                                                      and n not in params):
                        continue
                    avg = (ta + tb).div_(SG_WORLD)
                    ta.copy_(avg)
                    tb.copy_(avg)
    digest = fingerprint(main, a)
    del exe, a, b
    release(torch)
    return losses, digest, launch_keys(keyed)


def sg_peer_arm(torch, fa, zk, drill):
    """PEER's schedule on this rank: GPT at sg_config(), ZeRO stage 1,
    AdamW + clip (build_gpt_state at SG_LR), this rank's 4 rows of every
    global batch of 8, SG_PEER_STEPS steps. `drill` (under the launcher's
    --elastic_full_world): in the first life, snapshots every
    SG_SNAPSHOT_STEPS steps, replicated to the ring buddy after the first;
    then rank 1 is lost (os._exit) and rank 0, its next step failing,
    waits for the supervisor's SIGTERM, whose flush writes its own and its
    buddy's payloads; in the second life both recover on the ladder and
    resume. Without `drill`, the uninterrupted run."""
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed import gloo, parallel
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.resilience import fingerprint, recover
    rank = parallel.get_rank()
    life = int(os.environ.get("PADDLE_ELASTIC_RESTART", "0"))
    out_dir = os.environ["CHIP_SMOKE_SG_OUT"]
    set_flags({"FLAGS_snapshot_steps":
               SG_SNAPSHOT_STEPS if drill and life == 0 else 0})
    cfg = sg_config()
    main, start, loss, _ = build_gpt_state(cfg, stage=1, lr=SG_LR)
    toks = gpt_tokens(cfg, SG_BATCH, SG_PEER_STEPS, seed=1)
    scope, exe = Scope(), Executor("cuda")
    exe.run(start, scope=scope)
    out = {"rank": rank, "life": life}
    first = 0
    if drill and life > 0:
        t0 = time.perf_counter()
        out["rung"], first = recover(scope, program=main, device="cuda",
                                     peer=True)
        out["recover_ms"] = (time.perf_counter() - t0) * 1e3
        out["resumed_from"] = first
        if first is None:
            fail(f"PEER rank {rank}: nothing to recover")
    host = gloo.from_env() if drill and life == 0 else None
    widths = []
    spied = zk.launch

    def spy(lib, op_type, ins, attrs, stream):
        widths.append(int(ins["Param"][0].numel()))
        return spied(lib, op_type, ins, attrs, stream)

    zk.launch = spy
    fa.reset_launches()
    zk.reset_launches()
    losses, step_ms = [], []
    try:
        with flash_spy(fa) as keyed:
            for s in range(first, SG_PEER_STEPS):
                t0 = time.perf_counter()
                try:
                    got, = exe.run(main, feed={
                        "tokens": coll.split_batch(toks[s])},
                        fetch_list=[loss], scope=scope)
                except Exception as e:  # noqa: BLE001 - the lost peer
                    if not (drill and life == 0):
                        raise
                    # the survivor of a lost peer: the supervisor's SIGTERM
                    # flushes its own snapshot and its buddy's
                    log(f"PEER rank {rank}: step {s} failed ({e!r:.200}); "
                        "waiting for the supervisor's SIGTERM")
                    time.sleep(3 * SG_GRACE_S)
                    raise
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(got))
                if drill and life > 0 and s == first:
                    out["first_step_wall"] = time.time()
                if drill and life == 0 and s == SG_SNAPSHOT_STEPS - 1:
                    t0 = time.perf_counter()
                    before = metrics.get("resilience.replicate_bytes")
                    got_step = exe.snapshots.replicate(host)
                    out.update(
                        replicate_ms=(time.perf_counter() - t0) * 1e3,
                        replicate_gloo_ms=metrics.snapshot()[
                            "resilience.replicate_ms"]["p50"],
                        replicate_bytes=metrics.get(
                            "resilience.replicate_bytes") - before,
                        peer_payload_step=got_step, losses=losses)
                    if rank == 1:
                        out["kill_wall"] = time.time()
                    with open(os.path.join(
                            out_dir, f"sg_peer_life0_rank{rank}.json"),
                            "w") as f:
                        json.dump(out, f)
                    if rank == 1:
                        sys.stdout.flush()
                        os._exit(1)          # the lost host
    finally:
        zk.launch = spied
    out.update(losses=losses, step_ms=step_ms,
               fingerprint=fingerprint(main, scope),
               flash_launches=dict(fa.launches),
               flash_fwd_keyed=launch_keys(keyed),
               b8_launches=zk.launches["zero_adam"],
               b8_widths=sorted(set(widths)),
               marker_plan=exe._collective_marker_plan(main))
    return out


def sg_worker():
    """One rank of a phase-15 training gang (`chip_smoke.py --sg-worker`,
    started by the port's launcher, both ranks on cuda:0 under gloo).
    $CHIP_SMOKE_SG_MODE "a": LSGD, then PEER's uninterrupted run; "peer":
    the PEER drill (under --elastic_full_world). Writes sg_<mode>_...json
    under $CHIP_SMOKE_SG_OUT."""
    import faulthandler
    import torch
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.distributed import fleet, parallel
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import zero_update as zk

    faulthandler.enable(all_threads=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fleet.init(is_collective=True)
    rank, world = parallel.get_rank(), parallel.get_world_size()
    if world != SG_WORLD or parallel.backend() != "gloo" \
            or parallel.rank_device() != torch.device("cuda", 0):
        fail(f"sg rank {rank}: expected gloo on cuda:0 at {SG_WORLD} ranks")
    mode, out_dir = os.environ["CHIP_SMOKE_SG_MODE"], \
        os.environ["CHIP_SMOKE_SG_OUT"]
    if mode == "a":
        out = {"rank": rank, "lsgd": sg_lsgd_arm(torch, fa)}
        log(f"LSGD rank {rank}: losses {out['lsgd']['losses']}")
        release(torch)
        out["peer_ref"] = sg_peer_arm(torch, fa, zk, drill=False)
        name = f"sg_a_rank{rank}.json"
    else:
        out = sg_peer_arm(torch, fa, zk, drill=True)
        name = f"sg_peer_life{out['life']}_rank{rank}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(out, f)
    parallel.destroy()
    return 0


def sg_serve_worker():
    """One serving worker of phase 15 (`chip_smoke.py --sg-serve-worker`
    under the launcher): `serving.frontend.worker_main` on GPT-2 small
    (bf16, phase 4's geometry) over $CHIP_SMOKE_SG_REQ into
    $CHIP_SMOKE_SG_OUT; its B4 launches and the serve's wall time go to
    serve_rank<r>.json there. With $CHIP_SMOKE_SG_MARKER, the worker writes
    its pid to <marker>.<rank> as it starts serving."""
    import torch  # noqa: F401 - CUDA before the worker builds
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.ops.kernels import paged_attention as kernel_mod
    from paddle_tpu_torch.serving import frontend
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    out_dir, marker = os.environ["CHIP_SMOKE_SG_OUT"], \
        os.environ.get("CHIP_SMOKE_SG_MARKER", "")
    timing = {}
    generate = frontend.ServingFrontend.generate

    def timed(self, requests, timeout=300.0):
        if marker:
            with open(f"{marker}.{rank}", "w") as f:
                f.write(str(os.getpid()))
        t0 = time.perf_counter()
        try:
            return generate(self, requests, timeout)
        finally:
            timing["generate_s"] = time.perf_counter() - t0

    frontend.ServingFrontend.generate = timed
    kernel_mod.reset_launches()
    rc = frontend.worker_main(os.environ["CHIP_SMOKE_SG_REQ"], out_dir,
                              model="small", device="cuda", **SG_SERVE)
    with open(os.path.join(out_dir, f"serve_rank{rank}.json"), "w") as f:
        json.dump({"rc": rc, "launches": dict(kernel_mod.launches),
                   **timing}, f)
    return rc


def phase4_bf16_rows(cfg):
    """Phase 4's 8 bf16 requests as worker_main's JSONL rows: the same
    draws from numpy seed 1 as `serve_gpt2` makes (its 4 f32 prompts
    first), 32 new tokens each, the fourth seeded top-k."""
    rng = np.random.default_rng(1)
    for n in (9, 17, 33, 50):
        rng.integers(0, cfg.vocab_size, n)
    rows = []
    for i, n in enumerate(np.linspace(17, 200, 8).astype(int)):
        row = {"uid": f"p{i}",
               "prompt": rng.integers(0, cfg.vocab_size, n).tolist(),
               "max_new": 32}
        if i == 3:
            row.update(temperature=0.8, top_k=40, seed=1234)
        rows.append(row)
    return rows


def sg_engine_tokens(torch, serving, rows):
    """{uid: tokens} of an in-process DecodeEngine over the parameters
    worker_main serves (GPT-2 small from the startup program seeded 0,
    params_from_scope), phase 4's bf16 geometry."""
    from paddle_tpu_torch.framework import Executor, default_startup_program
    from paddle_tpu_torch.models.gpt import GPTConfig, build_lm_program
    from paddle_tpu_torch.models.gpt_decode import params_from_scope
    from paddle_tpu_torch.testing import reset_programs
    reset_programs(seed=0)
    cfg = GPTConfig.small()
    build_lm_program(cfg)
    Executor("cuda").run(default_startup_program())
    params = params_from_scope(cfg, device="cuda")
    reset_programs(seed=0)
    eng = serving.DecodeEngine(params, cfg, device="cuda", **SG_SERVE)
    try:
        comps = eng.generate([serving.Request(
            prompt=np.asarray(r["prompt"]), max_new_tokens=r["max_new"],
            temperature=r.get("temperature", 0.0), top_k=r.get("top_k", 0),
            seed=r.get("seed", 0), uid=r["uid"]) for r in rows],
            timeout=300)
    finally:
        eng.stop()
    del params, eng
    release(torch)
    if not all(c.ok for c in comps):
        fail(f"in-process engine: {[c.finish_reason for c in comps]}")
    return {c.uid: list(c.tokens) for c in comps}


def read_rows(path):
    with open(path) as f:
        return {r["uid"]: r for r in (json.loads(ln) for ln in f if ln)}


def sg_workers(torch, serving, out_dir):
    """WORKERS: two worker_main ranks serve phase 4's 8 requests split by
    rank, against the in-process engine; then a second gang serving them
    SG_DRAIN_COPIES times is sent SIGTERM mid-serve."""
    import signal
    from paddle_tpu_torch.models.gpt import GPTConfig
    rows = phase4_bf16_rows(GPTConfig.small())
    drain_rows = [dict(r, uid=f"d{c}_{r['uid']}")
                  for c in range(SG_DRAIN_COPIES) for r in rows]
    want = sg_engine_tokens(torch, serving, rows)
    out = {}
    for gang, reqs in (("serve", rows), ("drain", drain_rows)):
        gdir = os.path.join(out_dir, gang)
        os.makedirs(gdir)
        req = os.path.join(gdir, "requests.jsonl")
        with open(req, "w") as f:
            for r in reqs:
                f.write(json.dumps(r) + "\n")
        marker = os.path.join(gdir, "serving") if gang == "drain" else ""
        env = dict(os.environ, CHIP_SMOKE_SG_OUT=gdir, CHIP_SMOKE_SG_REQ=req,
                   CHIP_SMOKE_SG_MARKER=marker)
        sent = {}

        def sigterm_mid_serve(proc):
            deadline = time.monotonic() + 240
            while time.monotonic() < deadline and proc.poll() is None:
                pids = {}
                for r in range(SG_WORLD):
                    try:
                        with open(f"{marker}.{r}") as f:
                            pids[r] = int(f.read())
                    except (OSError, ValueError):
                        break
                if len(pids) == SG_WORLD:
                    time.sleep(0.2)     # every request submitted
                    for r, pid in pids.items():
                        os.kill(pid, signal.SIGTERM)
                        sent[r] = time.time()
                    return
                time.sleep(0.01)

        t0 = time.perf_counter()
        rc, text = launch_gang(["--sg-serve-worker"], env, 600,
                               f"sg_{gang}_gang.log",
                               during=sigterm_mid_serve if marker else None)
        if rc != 0:
            fail(f"WORKERS gang {gang} failed (rc {rc}): {text[-3000:]}")
        if marker and len(sent) != SG_WORLD:
            fail("WORKERS: the drain gang never reported serving")
        ranks = []
        for r in range(SG_WORLD):
            got = read_rows(os.path.join(gdir, f"rank{r}.jsonl"))
            with open(os.path.join(gdir, f"serve_rank{r}.json")) as f:
                info = json.load(f)
            mine = [q["uid"] for i, q in enumerate(reqs)
                    if i % SG_WORLD == r]
            if sorted(got) != sorted(mine):
                fail(f"WORKERS {gang} rank {r}: served {sorted(got)}, its "
                     f"shard is {sorted(mine)}")
            states = dict(collections.Counter(q["state"]
                                              for q in got.values()))
            for uid, q in got.items():
                if q["state"] == "done" and \
                        q["tokens"] != want[uid.split("_")[-1]]:
                    fail(f"WORKERS {gang} rank {r} {uid}: tokens differ "
                         f"from the in-process engine's")
            b4 = info["launches"].get("paged_decode_bf16", 0)
            if not b4:
                fail(f"WORKERS {gang} rank {r}: B4 (bf16) never launched")
            tokens = sum(len(q["tokens"]) for q in got.values())
            ranks.append({"states": states, "b4_launches": b4,
                          "generate_s": info.get("generate_s"),
                          "tokens": tokens,
                          "tokens_per_s": tokens / info["generate_s"]})
            if gang == "serve" and states != {"done": len(mine)}:
                fail(f"WORKERS rank {r}: {states}")
            if gang == "drain" and not states.get("handed_back"):
                fail(f"WORKERS drain rank {r}: SIGTERM mid-serve handed "
                     f"nothing back ({states})")
        out[gang] = {"ranks": ranks, "requests": len(reqs),
                     "gang_s": time.perf_counter() - t0}
        log(f"WORKERS {gang}: {ranks}")
    return out


def sg_fault_swap_rungs():
    """The planted PEER fault: the ladder's peer and local rungs read each
    other's directory."""
    from paddle_tpu_torch.resilience import snapshot
    real = snapshot._snapshot_rungs

    def swapped(root, rank, peer=True):
        rungs = real(root, rank, peer)
        names = [n for n, _ in rungs]
        return list(zip(names, [d for _, d in rungs][::-1]))

    return mp_patch(snapshot, "_snapshot_rungs", swapped)


def sg_pod_gate(podscope, dumps):
    """POD's gate on a pod dump's rank dumps: 2 rank lanes, and a
    cross-rank flow pair for every `__bucket_sync__` / `__zero_update__`
    marker of a step. Returns (lanes, markers, keys without a pair)."""
    events, meta = podscope.merge_timeline(dumps)
    lanes = sorted({e["pid"] for e in events
                    if e.get("name") == "process_name"})
    paired = {e["args"]["key"] for e in events
              if e.get("cat") == "pod_collective" and e["ph"] == "s"}
    keys = {(e.get("args") or {}).get("key")
            for d in dumps.values() for e in d.get("trace_events", ())
            if e.get("cat") == "collective"
            and (e.get("args") or {}).get("kind") in ("__bucket_sync__",
                                                       "__zero_update__")}
    return lanes, sorted(keys), sorted(keys - paired), meta


def train_gpt_supervised(torch, fa, zk, serving, card, checked):
    """Phase 15: LSGD and PEER's uninterrupted run in one gang, the PEER
    drill under --elastic_full_world --collect-dumps, its pod dump (POD),
    the serving workers (WORKERS), and a planted fault per gate; `checked`
    are the B1 launches phase 13's `check_flash_keyed_paths` held."""
    import tempfile
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.observability import podscope
    from paddle_tpu_torch.resilience import recover
    t0 = time.perf_counter()
    row = {"card": card,
           "config": f"GPTConfig(num_layers={MP_LAYERS}) (hidden 768, 12 "
                     "heads, vocab 50257), S 512, dropout 0, fleet AMP "
                     f"bf16, global batch {SG_BATCH} (4 rows a rank at dp "
                     f"2), two gloo ranks on cuda:0; LSGD Adam({SG_LR}) "
                     f"LocalSGD k {SG_LSGD_K}, {SG_LSGD_STEPS} steps; PEER "
                     f"ZeRO stage 1 AdamW + clip, {SG_PEER_STEPS} steps, "
                     f"snapshots every {SG_SNAPSHOT_STEPS}; WORKERS GPT-2 "
                     "small (12 layers) bf16, phase 4's geometry"}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sg_",
                               dir=os.path.join(HERE, ".chip_scratch"))
    base = dict(os.environ, PADDLE_DIST_BACKEND="gloo",
                PADDLE_DIST_DEVICE="cuda:0", CHIP_SMOKE_SG_OUT=out_dir)

    # ---- LSGD and PEER's uninterrupted run ---------------------------------
    t1 = time.perf_counter()
    rc, text = launch_gang(["--sg-worker"], dict(base,
                                                 CHIP_SMOKE_SG_MODE="a"),
                           600, "sg_a_gang.log")
    row["gang_a_s"] = time.perf_counter() - t1
    if rc != 0:
        fail(f"the phase-15 gang a failed (rc {rc}): {text[-3000:]}")
    ranks_a = []
    for r in range(SG_WORLD):
        with open(os.path.join(out_dir, f"sg_a_rank{r}.json")) as f:
            ranks_a.append(json.load(f))
    lsgd = [a["lsgd"] for a in ranks_a]
    t1 = time.perf_counter()
    sim_losses, sim_digest, sim_keyed = sg_simulation(torch, fa)
    fault_losses, fault_digest, _ = sg_simulation(torch, fa,
                                                  params_only=True)
    sim_s = time.perf_counter() - t1
    for r, got in enumerate(lsgd):
        if got["losses"] != sim_losses or got["fingerprint"] != sim_digest:
            fail(f"LSGD rank {r}: not bit-equal to the one-process "
                 f"simulation: losses {got['losses']} vs {sim_losses}, "
                 f"state {got['fingerprint'] == sim_digest}")
        if [tuple(p) for p in got["marker_plan"]] != [("__step_sync__", 0)]:
            fail(f"LSGD rank {r}: marker plan {got['marker_plan']}")
    fault_lsgd = {"losses_equal": fault_losses == sim_losses,
                  "state_equal": fault_digest == lsgd[0]["fingerprint"],
                  "loss_max_rel": max(abs(a - b) / abs(b) for a, b in
                                      zip(fault_losses, sim_losses))}
    if fault_lsgd["state_equal"]:
        fail("LSGD's planted fault (only the parameters averaged) read "
             "inside the gate")
    row["lsgd"] = {"ranks": lsgd, "simulation_losses": sim_losses,
                   "simulation_s": sim_s, "bitwise": True,
                   "fault_params_only": fault_lsgd}
    log(f"LSGD: bit-equal to the simulation; local step p50 "
        f"{lsgd[0]['step_ms_p50_local']:.1f} ms, sync step p50 "
        f"{lsgd[0]['step_ms_p50_sync']:.1f} ms, gloo host ms on syncs "
        f"{lsgd[0]['gloo_host_ms_sync']}; fault {fault_lsgd}")

    # ---- PEER: the drill under --elastic_full_world --collect-dumps ------
    flight_dir = os.path.join(out_dir, "flight")
    snap_dir = os.path.join(out_dir, "snap")
    env = dict(base, CHIP_SMOKE_SG_MODE="peer",
               FLAGS_flight_dump_dir=flight_dir, PADDLE_SNAPSHOT_DIR=snap_dir,
               FLAGS_gloo_timeout_ms="20000")
    t1 = time.perf_counter()
    rc, text = launch_gang(
        ["--sg-worker"], env, 900, "sg_peer_gang.log",
        launcher_args=("--grace_period_s", str(SG_GRACE_S),
                       "--elastic_restarts", "1", "--elastic_full_world",
                       "--collect-dumps"))
    row["gang_peer_s"] = time.perf_counter() - t1
    if rc != 0:
        fail(f"the PEER drill failed (rc {rc}): {text[-3000:]}")
    lives = {}
    for life in (0, 1):
        for r in range(SG_WORLD):
            with open(os.path.join(
                    out_dir, f"sg_peer_life{life}_rank{r}.json")) as f:
                lives[(life, r)] = json.load(f)
    second = [lives[(1, r)] for r in range(SG_WORLD)]
    refs = [a["peer_ref"] for a in ranks_a]
    if [s["rung"] for s in second] != ["local", "peer"]:
        fail(f"PEER: rungs {[s['rung'] for s in second]} (rank 1 must "
             "recover on the peer rung)")
    if f"recovery: rank 1 rung=peer step={SG_SNAPSHOT_STEPS}" not in text:
        fail("PEER: the launcher did not stamp rank 1's peer rung")
    if len({s["resumed_from"] for s in second}) != 1:
        fail(f"PEER: the ranks resumed from {[s['resumed_from'] for s in second]}")
    for r in range(SG_WORLD):
        if second[r]["fingerprint"] != refs[r]["fingerprint"]:
            fail(f"PEER rank {r}: the final state is not bit-equal to the "
                 "uninterrupted run's")
        if second[r]["losses"] != refs[r]["losses"][SG_SNAPSHOT_STEPS:]:
            fail(f"PEER rank {r}: resumed losses {second[r]['losses']} vs "
                 f"{refs[r]['losses']}")
    failures = []
    for name in sorted(os.listdir(flight_dir)):
        if "gang_failure" in name:
            with open(os.path.join(flight_dir, name)) as f:
                failures.append(json.load(f)["extra"])
    suspects = [f.get("suspected_straggler") for f in failures]
    if suspects != [1]:
        fail(f"PEER: the failed life's gang dumps name {suspects}, not "
             "rank 1")
    # the planted fault: the peer and local rungs swapped
    control = recover(Scope(), root=snap_dir, rank=1, stamp=False,
                      device="cpu")
    with sg_fault_swap_rungs():
        swapped = recover(Scope(), root=snap_dir, rank=1, stamp=False,
                          device="cpu")
    if control != ("peer", SG_SNAPSHOT_STEPS) or swapped[0] == "peer":
        fail(f"PEER's planted fault (rungs swapped) read inside the gate "
             f"({swapped}; control {control})")
    kill_to_step = (second[1]["first_step_wall"]
                    - lives[(0, 1)]["kill_wall"]) * 1e3
    row["peer"] = {
        "rungs": [s["rung"] for s in second],
        "resumed_from": second[0]["resumed_from"],
        "bitwise_vs_uninterrupted": True,
        "replicate_ms": [lives[(0, r)]["replicate_ms"]
                         for r in range(SG_WORLD)],
        "replicate_gloo_ms": [lives[(0, r)]["replicate_gloo_ms"]
                              for r in range(SG_WORLD)],
        "replicate_bytes": [lives[(0, r)]["replicate_bytes"]
                            for r in range(SG_WORLD)],
        "recover_ms": [s["recover_ms"] for s in second],
        "kill_to_first_resumed_step_ms": kill_to_step,
        "suspected_straggler": suspects[0],
        "gang_failure_heartbeats": failures[0].get("heartbeats"),
        "ranks": second, "uninterrupted": refs,
        "fault_swap_rungs": {"rung": swapped[0], "control": control[0]}}
    log(f"PEER: rungs {row['peer']['rungs']}, resumed from "
        f"{row['peer']['resumed_from']}, bit-equal to the uninterrupted run; "
        f"replicate {row['peer']['replicate_ms']} ms, "
        f"{row['peer']['replicate_bytes']} bytes; kill -> first resumed "
        f"step {kill_to_step:.0f} ms")

    # ---- POD: the clean second life's pod dump ---------------------------
    pod_dir = os.path.join(flight_dir, "pod_1_ok")
    dumps = podscope.find_rank_dumps(pod_dir)
    lanes, keys, unpaired, meta = sg_pod_gate(podscope, dumps)
    if lanes != [0, 1] or not keys or unpaired:
        fail(f"POD: lanes {lanes}, {len(keys)} markers, unpaired {unpaired}")
    t1 = time.perf_counter()
    res = podscope.write_pod_dump(dumps, os.path.join(out_dir, "pod_again"))
    merge_ms = (time.perf_counter() - t1) * 1e3
    with open(res["report"]) as f:
        report = json.load(f)
    stripped = {r: dict(d, trace_events=[
        e for e in d["trace_events"]
        if not (r == 1 and e.get("cat") == "collective")])
        for r, d in dumps.items()}
    _, _, fault_unpaired, _ = sg_pod_gate(podscope, stripped)
    if not fault_unpaired:
        fail("POD's planted fault (rank 1's markers dropped) read inside "
             "the gate")
    row["pod"] = {"lanes": lanes, "markers": len(keys),
                  "flow_pairs": meta["flow_pairs"], "merge_ms": merge_ms,
                  "straggler_report": {"suspect": report["suspect"],
                                       "summary": report["summary"],
                                       "ranks": report["ranks"]},
                  "fault_drop_rank1_markers": {
                      "unpaired": len(fault_unpaired)}}
    log(f"POD: lanes {lanes}, {len(keys)} markers each paired "
        f"({meta['flow_pairs']} flow pairs), merge {merge_ms:.1f} ms; "
        f"straggler report {row['pod']['straggler_report']}")

    # ---- the kernels' shapes on these paths ---------------------------------
    unchecked = unchecked_launches({"lsgd": lsgd, "peer": second,
                                    "uninterrupted": refs}, checked) + [
        f"simulation: {k}" for k in sim_keyed if k not in checked]
    if unchecked:
        fail(f"phase 15: B1 ran at shapes / keyings no check held: "
             f"{unchecked}")
    widths = second[0]["b8_widths"]
    if not widths:
        fail("PEER: B8 was never launched on rank 0's resumed steps")
    row["b8_shard_widths"] = widths
    row["b8_shard"] = check_b8_shard(torch, zk, max(widths, default=0),
                                     op="adamw")

    # ---- WORKERS ------------------------------------------------------------
    release(torch)
    row["workers"] = sg_workers(torch, serving, out_dir)
    shutil_rm(out_dir)
    row.update({"launch": "python -m paddle_tpu_torch.distributed.launch "
                          "--nproc_per_node 2 chip_smoke.py --sg-worker "
                          "(PEER: --elastic_restarts 1 --elastic_full_world "
                          "--collect-dumps) / --sg-serve-worker, "
                          "PADDLE_DIST_BACKEND=gloo PADDLE_DIST_DEVICE="
                          "cuda:0",
                "phase_s": time.perf_counter() - t0})
    return row



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

    # ---- pipeline training: GPipe, pp 2, recompute, gradient merge -------
    release(torch)
    pipe_row = train_gpt_pipeline(torch, fa, zk, card)
    arms = {"pipeline_G_gpipe_3_steps": pipe_row["gpipe"]["launches"],
            "pipeline_P_pp2_3_steps": pipe_row["pp2"]["launches"],
            "pipeline_R_recompute_stage1_3_steps":
                pipe_row["recompute"]["recompute"]["launches"],
            "pipeline_M_merge_8_micro_steps":
                pipe_row["gradient_merge"]["merged_batch8"]["launches"]}
    for path, counts in arms.items():
        for name in fa.KERNEL_NAMES + ("zero_adam",):
            rows[name]["launches_by_path"][path] = counts[name]

    # ---- rolled layers: layer scan, its stage-3 buckets, dp x pp ---------
    release(torch)
    scan_row = train_gpt_rolled(torch, fa, zk, card)
    dp0 = scan_row["dp"]["ranks"][0]
    arms = {"layer_scan_S_rolled_3_steps": scan_row["rolled"]["launches"],
            "layer_scan_SR_remat_stage1_3_steps":
                scan_row["remat"]["rolled_recompute"]["launches"],
            "layer_scan_S3_stage3_3_steps": scan_row["stage3"]["launches"],
            "layer_scan_S3D_dp2_stage3_rank0_3_steps": dict(
                dp0["s3d"]["3"]["flash_launches"],
                zero_adam=dp0["s3d"]["3"]["b8_launches"]),
            "layer_scan_DP_dp2_pp2_rank0_3_steps": dict(
                dp0["dp"]["sound"]["flash_launches"],
                zero_adam=dp0["dp"]["sound"]["b8_launches"])}
    for path, counts in arms.items():
        for name in fa.KERNEL_NAMES + ("zero_adam",):
            rows[name]["launches_by_path"][path] = counts[name]
    rows["zero_adam"]["stacked"] = [scan_row.pop("b8_stacked_whole"),
                                    scan_row["dp"].pop("b8_stacked_shard")]

    # ---- tensor and sequence parallelism: tp 2, ring and Ulysses sp 2 ------
    release(torch)
    mp_row = train_gpt_model_parallel(torch, fa, card)
    mp0 = mp_row["ranks"][0]
    arms = {"model_parallel_T_tp2_rank0_3_steps":
                mp0["T"]["sound"]["flash_launches"],
            "model_parallel_SU_ulysses_sp2_rank0_3_steps":
                mp0["SU"]["sound"]["flash_launches"]}
    for path, counts in arms.items():
        for name in fa.KERNEL_NAMES:
            if not counts[name]:
                fail(f"{name} was never launched on the {path} run")
            rows[name]["launches_by_path"][path] = counts[name]
    for name in fa.KERNEL_NAMES:
        rows[name]["keying"] = mp_row["flash_keying"]
        rows[name]["keyed_paths"] = mp_row["flash_keyed_paths"][name]

    # ---- composed meshes: ZeRO, layer scan and pp with tp and sp ----------
    release(torch)
    cm_row = train_gpt_composed(torch, fa, zk, card,
                                mp_row["flash_checked_launches"])
    rows["zero_adam"]["shard_dp2_tp2"] = cm_row.pop("b8_shard")
    z0, lp0 = cm_row["ranks_z"][0], cm_row["ranks_lp"][0]
    arms = {"composed_Z1_dp2_tp2_stage1_rank0_3_steps": z0["Z1"],
            "composed_ZS_dp2_sp2_stage1_rank0_3_steps": z0["ZS1"],
            "composed_L_tp2_rolled_rank0_3_steps": lp0["L_tp_rolled"],
            "composed_L_sp2_rolled_remat_rank0_3_steps": lp0["L_sp_remat"],
            "composed_PT_pp2_tp2_rank0_3_steps": lp0["PT_pp2"]}
    for path, arm in arms.items():
        counts = dict(arm["flash_launches"], zero_adam=arm["b8_launches"])
        for name in fa.KERNEL_NAMES + ("zero_adam",):
            if name == "zero_adam" and "_Z" not in path:
                continue
            if not counts[name]:
                fail(f"{name} was never launched on the {path} run")
            rows[name]["launches_by_path"][path] = counts[name]

    # ---- the supervised gang: LocalSGD, peer snapshots, pod dumps, workers
    release(torch)
    sg_row = train_gpt_supervised(torch, fa, zk, serving, card,
                                  mp_row["flash_checked_launches"])
    lsgd0, peer0 = sg_row["lsgd"]["ranks"][0], sg_row["peer"]["ranks"][0]
    arms = {"supervised_LSGD_dp2_rank0_8_steps": lsgd0["flash_launches"],
            "supervised_PEER_dp2_stage1_rank0_resumed_3_steps": dict(
                peer0["flash_launches"], zero_adam=peer0["b8_launches"])}
    for path, counts in arms.items():
        for name in fa.KERNEL_NAMES + ("zero_adam",):
            if name not in counts:
                continue
            if not counts[name]:
                fail(f"{name} was never launched on the {path} run")
            rows[name]["launches_by_path"][path] = counts[name]
    rows["zero_adam"]["shard_peer"] = sg_row.pop("b8_shard")
    b4_paths = rows["paged_decode_bf16"].setdefault("launches_by_path", {})
    for r, w in enumerate(sg_row["workers"]["serve"]["ranks"]):
        b4_paths[f"supervised_WORKERS_rank{r}"] = w["b4_launches"]

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
    print(json.dumps({"pipeline": pipe_row}), flush=True)
    print(json.dumps({"layer_scan": scan_row}), flush=True)
    print(json.dumps({"model_parallel": mp_row}), flush=True)
    print(json.dumps({"composed_mesh": cm_row}), flush=True)
    print(json.dumps({"supervised_gang": sg_row}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--dp-worker" in sys.argv:
        sys.exit(dp_worker())
    if "--dp-nccl-refusal" in sys.argv:
        sys.exit(dp_nccl_refusal())
    if "--scan-worker" in sys.argv:
        sys.exit(scan_worker())
    if "--mp-worker" in sys.argv:
        sys.exit(mp_worker())
    if "--cm-worker" in sys.argv:
        sys.exit(cm_worker())
    if "--sg-worker" in sys.argv:
        sys.exit(sg_worker())
    if "--sg-serve-worker" in sys.argv:
        sys.exit(sg_serve_worker())
    adopt_orphans()
    try:
        rc = main()
    finally:
        # a failed phase's processes too; on success main has stopped them
        stop_children()
    sys.exit(rc)
