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
   a bounded walk and one slot alone bit-equal to the full batch), timed
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
   fails);
4. GPT-2 small (GPTConfig(), weights from numpy seed 0) served through the
   port's DecodeEngine:
   * f32 (TF32 off): greedy tokens == the port's dense generate;
   * bf16: 8 concurrent requests (prompts 17-200 tokens, 32 new, greedy and
     one seeded top-k), tokens/s and TTFT; continuous == sequential;
   * bf16 with int8 KV pools: 2 requests complete;
5. the fused flat-bucket optimizer kernels B6-B8 (sgd, momentum with
   nesterov + l2_decay and plain, adam, adamw) at the main path's bucket
   sizes (23,440,896 and 7,120,704 elements) and a tail (1,000,003), and
   B8 on a bucket one element past 16 bytes and on one whose arrays start
   at different offsets, held BIT FOR BIT against their plain version on
   the card, timed beside it, beside the bytes bound and beside PyTorch's
   fused optimizer calls; B8 also timed alone, without its wrapper;
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
     AdamW with global-norm clipping at stage 1, each through its kernel.
Each main-path run resets the kernel launch counts just before it and
fails if a kernel of its path was never launched.

Output: a `{"kernels": [...]}` line, a `{"serving": ...}` line, a
`{"training": ...}` line, and last `{"ok": true, "device": {...}}`.
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
TOLERANCE = {"f32": 1e-5, "bf16": 1.6e-2, "int8": 1e-4}
# mangled-name prefixes of the paged kernels each pool kind runs: pass 1
# <KV, Q, HD> and the merge <Out, HD>
PAGED_MANGLED = {
    "f32": ("paged_decode_kernelIffLi", "paged_decode_kernel_mergeIfLi"),
    "bf16": ("paged_decode_kernelI13__nv_bfloat16S",
             "paged_decode_kernel_mergeI13__nv_bfloat16Li"),
    "int8": ("paged_decode_kernelIa", "paged_decode_kernel_mergeIfLi")}
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
    for kind in ("f32", "bf16", "int8"):
        q, kp, vp, pt, pos, kw = fv.paged_case(kind, g)
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
        out_elem = 4 if kind == "int8" else q.element_size()
        io_bytes = (q.numel() * q.element_size() + B * nh * hd * out_elem
                    + 4 * int((pos.long() // bs + 1).sum()) + 4 * B)
        flops = live * nh * (4 * hd + 5)    # two dots + softmax
        t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        name = kernel_mod.KERNEL_NAMES[kp.dtype]
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


def serve(torch, serving, engine_kw, requests, sequential=False):
    eng = serving.DecodeEngine(**engine_kw)
    try:
        run = eng.generate_sequential if sequential else eng.generate
        t0 = time.perf_counter()
        comps = run(requests, timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = eng.stats()
    finally:
        eng.stop()
    bad = [c for c in comps if not c.ok]
    if bad:
        fail(f"requests failed: {[(c.uid, c.state, c.error) for c in bad]}")
    return comps, wall, stats


def device_profile(torch, run, top=8, ranges=(), kernels=()):
    """One more run of `run()` (which returns its wall seconds) under
    torch.profiler: the share of the wall time the card spent in kernels,
    the number of device launches, the `top` kernels that took most of the
    time, the device time of the kernels launched inside each profiler
    range of `ranges` (see `annotated`) and the span from the first to the
    last of them on the device timeline, and the device time of the
    kernels whose names contain each of `kernels`. The profiler's own cost lengthens the wall
    time, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
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
    return (diff.max().item(), (diff - rtol * ref).max().item(),
            diff.quantile(0.99).item(), ref.median().item())


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


def b8_launch_alone(torch, zk, ins, attrs, op_type):
    """A call of B8's C entry point alone on `ins`' tensors, its arguments
    prepared beforehand (what `zero_update.launch` passes), and not
    counted: the kernel's time without the wrapper's."""
    lib = zk._library()
    ptr = {s: v[0].data_ptr() for s, v in ins.items()}
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    decay = op_type == "adamw"
    args = (ptr["LearningRate"], ptr["Beta1Pow"], ptr["Beta2Pow"],
            ptr["Param"], ptr["Grad"], ptr["Moment1"], ptr["Moment2"],
            ins["Param"][0].numel(), b1, 1 - b1, b2, 1 - b2,
            attrs.get("epsilon", 1e-8),
            attrs.get("coeff", 0.01) if decay else 0.0, int(decay),
            torch.cuda.current_stream().cuda_stream)
    return lambda: lib.zero_adam(*args)


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
            times["ms"] = cuda_ms(torch, b8_launch_alone(
                torch, zk, kin, attrs, op_type))
            times["gb_per_s"] = n * ZERO_BYTES_PER_ELEMENT[kernel] \
                / times["ms"] / 1e6
            times["share_of_bytes_bound"] = times["bound_ms"] / times["ms"]
        lib = None if offs else zero_library_call(
            torch, op_type, label, {s: v for s, v in kin.items()})
        times["library_ms"] = None if lib is None \
            else cuda_ms(torch, lib)
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
    from paddle_tpu_torch.models.gpt import GPTConfig
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
    rows.update(check_zero_kernels(torch, zk, ptxas))
    for name, row in rows.items():
        if "sass_hmma" not in row:
            fn = "paged_decode_kernel" if name.startswith("paged") \
                else f"{name}_kernel"
            row["sass_hmma"] = "not measured (no cuobjdump)" if sass is None \
                else {k: c for k, c in sass.items() if fn in k}

    # ---- GPT-2 small served through the port --------------------------------
    cfg = GPTConfig()
    t0 = time.perf_counter()
    arrays = gpt2_small_arrays(cfg, seed=0)
    log(f"GPT-2 small weights (numpy seed 0) in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    R = serving.Request

    def record_launches(name):
        rows[name]["launches"] = kernel_mod.launches[name]
        return rows[name]["launches"]

    # f32, TF32 off: greedy tokens == dense generate
    p32 = gpt_decode.params_from_numpy(cfg, arrays, device="cuda")
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 17, 33, 50)]
    f32_kw = dict(params=p32, model_config=cfg, device="cuda", max_slots=4,
                  block_size=16, num_blocks=64, max_len=128, window=8)
    kernel_mod.reset_launches()
    comps, _, _ = serve(torch, serving, f32_kw,
                        [R(prompt=p, max_new_tokens=16) for p in prompts])
    n_f32 = record_launches("paged_decode_f32")
    for p, c in zip(prompts, comps):
        dense = gpt_decode.generate(p32, cfg, p[None], 16, device="cuda")
        if dense[0, len(p):].tolist() != c.tokens:
            fail(f"f32 paged tokens {c.tokens} != dense generate "
                 f"{dense[0, len(p):].tolist()} (prompt of {len(p)})")
    log(f"f32 engine: greedy tokens == dense generate for {len(prompts)} "
        f"prompts; paged_decode_f32 launches {n_f32}")
    del p32

    # bf16: 8 concurrent requests
    p16 = gpt_decode.params_from_numpy(cfg, arrays, dtype="bfloat16",
                                       device="cuda")
    del arrays
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
    serve(torch, serving, bf16_kw, bf16_requests())     # warm-up
    metrics.reset()
    kernel_mod.reset_launches()
    comps, wall, stats = serve(torch, serving, bf16_kw, bf16_requests())
    n_bf16 = record_launches("paged_decode_bf16")
    snap = metrics.snapshot()
    n_tok = sum(len(c.tokens) for c in comps)
    if n_tok != 8 * 32 or any(not 0 <= t < cfg.vocab_size
                              for c in comps for t in c.tokens):
        fail(f"bf16 engine emitted {n_tok} tokens (want 256) or ids "
             f"outside the vocabulary")
    seq, _, _ = serve(torch, serving, bf16_kw, bf16_requests(),
                      sequential=True)
    if [c.tokens for c in seq] != [c.tokens for c in comps]:
        fail("bf16: continuous batching tokens != sequential tokens")
    kernel_mod.reset_launches()
    profile = device_profile(
        torch, lambda: serve(torch, serving, bf16_kw, bf16_requests())[1],
        kernels=("paged_decode_kernel", "paged_decode_kernel_merge"))
    profile["paged_decode_bf16_launches"] = \
        kernel_mod.launches["paged_decode_bf16"]
    log(f"bf16 engine under torch.profiler: {profile}")
    log(f"bf16 engine: B4 (both passes) "
        f"{profile.get('paged_decode_kernel_device_ms')} ms of device time "
        f"(merge {profile.get('paged_decode_kernel_merge_device_ms')} ms) "
        f"over {profile['paged_decode_bf16_launches']} wrapper calls; "
        f"device busy {profile.get('device_busy_s')} s")
    serving_row = {
        "config": "GPT-2 small (GPTConfig()), bf16 weights and KV, "
                  "block 16, window 8, 8 slots, random weights seed 0",
        "requests": 8, "prompt_tokens": [int(n) for n in lens],
        "new_tokens_each": 32, "generated_tokens": n_tok,
        "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ttft_ms_p50": snap["serving.ttft_ms"]["p50"],
        "ttft_ms_p99": snap["serving.ttft_ms"]["p99"],
        "tpot_ms_p50": snap["serving.tpot_ms"]["p50"],
        "window_ms_p50": snap["serving.window_ms"]["p50"],
        "windows": stats["windows"],
        "paged_decode_bf16_launches": n_bf16,
        "profile": profile, "card": card}
    log(f"bf16 engine: {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tok/s, TTFT p50 "
        f"{serving_row['ttft_ms_p50']:.2f} ms; continuous == sequential; "
        f"paged_decode_bf16 launches {n_bf16}")

    # bf16 with int8 KV pools: 2 requests
    int8_kw = dict(bf16_kw, kv_dtype="int8", kv_scale=8.0, max_slots=2)
    kernel_mod.reset_launches()
    comps, _, _ = serve(torch, serving, int8_kw,
                        [R(prompt=prompts[1], max_new_tokens=16),
                         R(prompt=prompts[6], max_new_tokens=16)])
    n_int8 = record_launches("paged_decode_int8")
    if [len(c.tokens) for c in comps] != [16, 16]:
        fail(f"int8-KV engine: {[len(c.tokens) for c in comps]} tokens")
    log(f"int8-KV engine: 2 requests complete; paged_decode_int8 launches "
        f"{n_int8}")

    # ---- BERT pretraining through Program / Executor ----------------------
    del p16, bf16_kw, int8_kw
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

    for row in rows.values():
        if not row["launches"]:
            fail(f"{row['name']} was never launched on its main path run")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"serving": serving_row}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
