#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (paddle_tpu_torch).

    python3 chip_smoke.py          # from the root of a checkout, one CUDA card

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. the card's name and power limit (nvidia-smi);
2. the build: every CUDA source under paddle_tpu_torch/csrc, one nvcc each,
   all started together;
3. each kernel at the serving main path's shapes (batch 8, 12 heads,
   head_dim 64, block 16, max_len 1024, ragged positions), held against its
   plain PyTorch version on the card, and timed beside it;
4. GPT-2 small (GPTConfig(), weights from numpy seed 0) served through the
   port's DecodeEngine:
   * f32 (TF32 off): greedy tokens == the port's dense generate;
   * bf16: 8 concurrent requests (prompts 17-200 tokens, 32 new, greedy and
     one seeded top-k), tokens/s and TTFT; continuous == sequential;
   * bf16 with int8 KV pools: 2 requests complete.
   Each run resets the kernel launch counts just before it and fails if its
   kernel was never launched.

Output: a `{"kernels": [...]}` line, a `{"serving": ...}` line, and last
`{"ok": true, "device": {...}}`.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
REPLACES = {"f32": "paddle_tpu/ops/pallas/paged_attention.py:98",
            "bf16": "paddle_tpu/ops/pallas/paged_attention.py:98",
            "int8": "paddle_tpu/ops/pallas/paged_attention.py:145"}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# CUDA-core rate (the kernel computes in f32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# kernel vs plain version on the card: f32 sums in another order; bf16
# outputs round to bf16 (one ulp of an O(1) context is <= 2**-7), and the
# bf16 probabilities may round to neighbouring values; int8 outputs are f32
TOLERANCE = {"f32": 1e-5, "bf16": 1.6e-2, "int8": 1e-4}


def log(msg):
    print(f"chip_smoke: {msg}", flush=True)


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


def check_kernels(torch, kernel_mod, paged_ops):
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    B, nh, hd, bs, max_len, L = 8, 12, 64, 16, 1024, 12
    mb = max_len // bs
    nb = 1 + B * mb
    layer = 5
    pos = torch.tensor([0, 15, 16, 200, 511, 777, 1000, 1023],
                       dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    pt = (torch.randperm(nb - 1, generator=g, device=dev)[:B * mb] + 1) \
        .to(torch.int32).reshape(B, mb).contiguous()
    n_valid = (pos.long() + 1).clamp(max=mb * bs)
    n_walk = pos.long() // bs + 1
    rows = {}
    for kind in ("f32", "bf16", "int8"):
        shape = (L, nb, nh, bs, hd)
        kf = torch.randn(shape, generator=g, device=dev)
        vf = torch.randn(shape, generator=g, device=dev)
        q = torch.randn((B, nh, 1, hd), generator=g, device=dev)
        kw = dict(block_size=bs, layer=layer)
        if kind == "int8":
            kp, vp = (paged_ops.quantize_kv(t * 2.0, 8.0) for t in (kf, vf))
            q = q.to(torch.bfloat16)
            kw["kv_scale"] = 8.0
        else:
            dt = torch.float32 if kind == "f32" else torch.bfloat16
            kp, vp, q = kf.to(dt), vf.to(dt), q.to(dt)
        del kf, vf
        args = (q, kp, vp, pt, pos)
        got = kernel_mod.fused_paged_attention(*args, **kw)
        want = kernel_mod.paged_attention_plain(*args, **kw)
        # a walk bounded at the furthest frontier reads the same
        hint = int(n_walk.max())
        bounded = kernel_mod.fused_paged_attention(*args, max_blocks=hint,
                                                   **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, bounded):
            fail(f"{kind}: max_blocks={hint} changed the kernel's result")
        if not torch.isfinite(got.float()).all():
            fail(f"{kind}: kernel output is not finite")
        err = (got.float() - want.float()).abs().max().item()
        if kind == "int8":    # the int8 arm also takes an f32 query
            q32 = (q.float(),) + args[1:]
            err = max(err, (kernel_mod.fused_paged_attention(*q32, **kw)
                            - kernel_mod.paged_attention_plain(*q32, **kw))
                      .abs().max().item())
        log(f"kernel {kind}: max |kernel - plain| = {err:.3e} "
            f"(tolerance {TOLERANCE[kind]:.1e})")
        if err > TOLERANCE[kind]:
            fail(f"{kind}: kernel disagrees with its plain version: "
                 f"max abs err {err} > {TOLERANCE[kind]}")
        ms = cuda_ms(torch, lambda: kernel_mod.fused_paged_attention(
            *args, **kw))
        plain_ms = cuda_ms(torch, lambda: kernel_mod.paged_attention_plain(
            *args, **kw))
        # least work: K and V of every live position read once, q read and
        # the context written once, the walked page-table entries and pos
        live = int(n_valid.sum())
        kv_bytes = 2 * live * nh * hd * kp.element_size()
        io_bytes = (q.numel() * q.element_size()
                    + got.numel() * got.element_size()
                    + 4 * int(n_walk.sum()) + 4 * B)
        flops = live * nh * (4 * hd + 5)    # two dots + softmax
        t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        rows[kind] = {
            "name": kernel_mod.KERNEL_NAMES[kp.dtype], "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[kind],
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}
        log(f"kernel {kind}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {rows[kind]['bound_ms']:.4f} ms "
            f"({rows[kind]['bound_by']})")
        del kp, vp, args, got, want, bounded
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


def device_profile(torch, serve_fn, serving, engine_kw, requests):
    """One more run of the same requests under torch.profiler: the share of
    the wall time the card spent in kernels, and the kernels that took
    most of it. The profiler's own cost lengthens the wall time, so the
    busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall, _ = serve_fn(torch, serving, engine_kw, requests)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        return {"device_time": "not measured (no device events)"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                               for e in top}}


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
    from paddle_tpu_torch.ops import paged_ops
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import paged_attention as kernel_mod

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"ptxas {name}: {line.strip()}")

    # ---- kernels vs plain --------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"TF32 off: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    rows = check_kernels(torch, kernel_mod, paged_ops)

    # ---- GPT-2 small served through the port --------------------------------
    cfg = GPTConfig()
    t0 = time.perf_counter()
    arrays = gpt2_small_arrays(cfg, seed=0)
    log(f"GPT-2 small weights (numpy seed 0) in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    R = serving.Request

    # f32, TF32 off: greedy tokens == dense generate
    p32 = gpt_decode.params_from_numpy(cfg, arrays, device="cuda")
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 17, 33, 50)]
    f32_kw = dict(params=p32, model_config=cfg, device="cuda", max_slots=4,
                  block_size=16, num_blocks=64, max_len=128, window=8)
    kernel_mod.reset_launches()
    comps, _, _ = serve(torch, serving, f32_kw,
                        [R(prompt=p, max_new_tokens=16) for p in prompts])
    rows["f32"]["launches"] = kernel_mod.launches["paged_decode_f32"]
    for p, c in zip(prompts, comps):
        dense = gpt_decode.generate(p32, cfg, p[None], 16, device="cuda")
        if dense[0, len(p):].tolist() != c.tokens:
            fail(f"f32 paged tokens {c.tokens} != dense generate "
                 f"{dense[0, len(p):].tolist()} (prompt of {len(p)})")
    log(f"f32 engine: greedy tokens == dense generate for {len(prompts)} "
        f"prompts; paged_decode_f32 launches {rows['f32']['launches']}")
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
    rows["bf16"]["launches"] = kernel_mod.launches["paged_decode_bf16"]
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
    profile = device_profile(torch, serve, serving, bf16_kw,
                             bf16_requests())
    log(f"bf16 engine under torch.profiler: {profile}")
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
        "paged_decode_bf16_launches": rows["bf16"]["launches"],
        "profile": profile, "card": card}
    log(f"bf16 engine: {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tok/s, TTFT p50 "
        f"{serving_row['ttft_ms_p50']:.2f} ms; continuous == sequential; "
        f"paged_decode_bf16 launches {rows['bf16']['launches']}")

    # bf16 with int8 KV pools: 2 requests
    int8_kw = dict(bf16_kw, kv_dtype="int8", kv_scale=8.0, max_slots=2)
    kernel_mod.reset_launches()
    comps, _, _ = serve(torch, serving, int8_kw,
                        [R(prompt=prompts[1], max_new_tokens=16),
                         R(prompt=prompts[6], max_new_tokens=16)])
    rows["int8"]["launches"] = kernel_mod.launches["paged_decode_int8"]
    if [len(c.tokens) for c in comps] != [16, 16]:
        fail(f"int8-KV engine: {[len(c.tokens) for c in comps]} tokens")
    log(f"int8-KV engine: 2 requests complete; paged_decode_int8 launches "
        f"{rows['int8']['launches']}")

    for row in rows.values():
        if not row["launches"]:
            fail(f"{row['name']} was never launched on its main path run")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"serving": serving_row}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
