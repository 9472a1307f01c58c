"""Variants of the flash backward kernels B2/B3, timed against each other on
one card: the measurements behind PERF.md's account of where their time
goes.

    python3 -m paddle_tpu_torch.ops.kernels.flash_variants [name ...]

Each variant is the sources under csrc/ with text substitutions applied
(each must match exactly once). All variants build at once, one nvcc each,
with `_build`'s flags, into build/variants/. Then each is swapped in under
`flash_attention`'s launchers and B2 and B3 are timed with CUDA events at
the training main path's shapes (batch 16, 12 heads, S 512, head_dim 64,
key-padding mask), f32 and bf16, dropout 0.1 and 0, the variants in order
and then in reverse, and averaged. Each prints its ptxas registers and its
max |variant - plain| on the f32 and bf16 arms at dropout 0.1.

Some variants are wrong on purpose (no_exp, no_hash, tf32_1x): they show
what one part of the kernel costs, not a kernel to ship.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from . import _build
from . import flash_attention as fa

CU, H = "flash_attention.cu", "mma_tile.cuh"
# name -> [(file, old text, new text)]
VARIANTS = {
    "base": [],
    # small = x - big rounded to nearest TF32 (ties away) before the product
    "small_rna": [(H, "    small = __float_as_uint(x - __uint_as_float(big));",
                   "    small = rna_tf32(x - __uint_as_float(big));")],
    # big rounded by the cvt instruction instead of two integer ops
    "cvt": [(H, "    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
             "    uint32_t b;\n"
             "    asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(b) : \"f\"(x));\n"
             "    return b;")],
    # big truncated: one integer op, small twice as wide
    "trunc_big": [(H, "    big = rna_tf32(x);",
                   "    big = __float_as_uint(x) & 0xFFFFE000u;")],
    # the dropout upscale as a division per element
    "div": [(CU, "dpv * inv_keep : 0.f;\n                s[j][i] = pr",
             "dpv / p.keep_prob : 0.f;\n                s[j][i] = pr"),
            (CU, "? s[j][i] * inv_keep : 0.f;", "? s[j][i] / p.keep_prob : 0.f;"),
            (CU, "& 1u ? dpv * inv_keep : 0.f;", "& 1u ? dpv / p.keep_prob : 0.f;")],
    # 64-row streamed tiles: the ring takes twice the shared memory
    "bn64": [(CU, "constexpr int BN = 32;", "constexpr int BN = 64;")],
    # wrong on purpose: one TF32 product instead of three
    "tf32_1x": [(H, "    mma_tf32(c, as, bb[0], bb[1]);\n"
                    "    mma_tf32(c, ab, bs[0], bs[1]);\n", "")],
    # wrong on purpose: no exponential
    "no_exp": [(CU, "exp2f((sc - lse[h]) * kLog2e)", "((sc - lse[h]) * kLog2e)"),
               (CU, "exp2f((sc - (isfinite(l) ? l : 0.f)) * kLog2e)",
                "((sc - (isfinite(l) ? l : 0.f)) * kLog2e)")],
    # wrong on purpose: every element kept, no hash
    "no_hash": [(CU, "    return x >= p.thresh;", "    return qpos != 0xFFFFFFFFu;")],
}
SHAPE = (16, 12, 512, 64)
SEED = 1234


def variant_sources(name):
    """{file name: text} of the csrc/ sources with variant `name`
    applied; raises if a substitution does not match exactly once."""
    texts = {p.name: p.read_text() for p in
             _build.CSRC_DIR.iterdir() if p.name in (CU, H)}
    for fname, old, new in VARIANTS[name]:
        n = texts[fname].count(old)
        if n != 1:
            raise ValueError(f"variant {name}: {fname} holds {n} copies of "
                             f"{old[:60]!r}, want 1")
        texts[fname] = texts[fname].replace(old, new)
    return texts


def build(names):
    """{name: (ctypes library, {kernel: registers})}, built at once."""
    root = _build.BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name in names:
        d = root / name
        d.mkdir(parents=True)
        for fname, text in variant_sources(name).items():
            (d / fname).write_text(text)
        lib = d / "lib.so"
        cmd = [_build.nvcc()] + _build.NVCC_FLAGS + [
            "-Xptxas", "-v", "-o", str(lib), str(d / CU)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        regs, entry = {}, None
        for line in log.splitlines():
            m = re.search(r"entry function '\S*?(flash_bwd_\w+?)_kernelI"
                          r"(f|13__nv_bfloat16)Li(\d+)E", line)
            if m:
                entry = f"{m.group(1)}_{'f32' if m.group(2) == 'f' else 'bf16'}" \
                        f"_hd{m.group(3)}"
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                regs[entry], entry = int(m.group(1)), None
        out[name] = (ctypes.CDLL(str(lib)), regs)
    return out


def _use(lib):
    _build.load = lambda _name: lib
    fa._lib = None


def _ms(fn, iters=30, warmup=3):
    for _ in range(warmup):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main(names):
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = build(names)
    load = _build.load
    b, nh, s, hd = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    base = [torch.randn(SHAPE, generator=g, device="cuda") for _ in range(4)]
    lens = np.random.RandomState(0).randint(s // 2, s + 1, size=(b, 1))
    keep = (np.arange(s)[None, :] < lens).astype(np.float32)
    mask = torch.from_numpy(keep * 1e9 - 1e9).view(b, 1, 1, s).cuda()
    m3, mode = fa.normalize_mask(mask, b, nh, s)
    m3, scale = m3.contiguous(), 1.0 / np.sqrt(hd)

    def args(dt, rate):
        q, k, v, do = (t.to(dt) for t in base)
        o, lse = fa.launch_fwd(q, k, v, m3, mode, SEED, scale, False, rate)
        qa = (q, k, v, o, lse, do, m3, mode, SEED, scale, False, rate)
        delta = fa.launch_bwd_dq(*qa)[1]
        return qa, (q, k, v, delta, lse, do, m3, mode, SEED, scale, False,
                    rate)

    plain = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.to(dt).requires_grad_() for t in base)
        o = fa.flash_attention_plain(q, k, v, scale=scale, dropout=0.1,
                                     seed=SEED, mask=mask)
        plain[dt] = torch.autograd.grad(o, (q, k, v), do.detach())
    times = {n: [] for n in names}
    errs = {}
    try:
        for name in names + names[::-1]:
            _use(libs[name][0])
            row = {}
            for dt in (torch.float32, torch.bfloat16):
                for rate in (0.1, 0.0):
                    qa, ka = args(dt, rate)
                    if rate:
                        got = (fa.launch_bwd_dq(*qa)[0],) + \
                            fa.launch_bwd_dkdv(*ka)
                        errs[name, dt] = max(
                            (x.float() - y.float()).abs().max().item()
                            for x, y in zip(got, plain[dt]))
                    key = f"{'f32' if dt == torch.float32 else 'bf16'} {rate}"
                    row[f"B2 {key}"] = _ms(lambda: fa.launch_bwd_dq(*qa))
                    row[f"B3 {key}"] = _ms(lambda: fa.launch_bwd_dkdv(*ka))
            times[name].append(row)
    finally:
        _build.load = load
        fa._lib = None
    for name in names:
        avg = {k: float(np.mean([r[k] for r in times[name]]))
               for k in times[name][0]}
        sums = {k: avg[f"B2 {k}"] + avg[f"B3 {k}"]
                for k in ("f32 0.1", "f32 0.0", "bf16 0.1", "bf16 0.0")}
        print(f"variant {name}: B2+B3 ms " + ", ".join(
            f"{k} {v:.4f}" for k, v in sums.items()) + "; " + ", ".join(
            f"{k} {v:.4f}" for k, v in avg.items()), flush=True)
        print(f"  max |variant - plain| f32 {errs[name, torch.float32]:.3e}, "
              f"bf16 {errs[name, torch.bfloat16]:.3e}; registers "
              f"{libs[name][1]}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
